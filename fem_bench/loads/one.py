"""f = 1."""

import torch


def at(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x[..., :1])
