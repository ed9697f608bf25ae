"""f(x, y, z) = (1/2 - y, x - 1/2, -1): a torque about the cube's axis
through (1/2, 1/2) along z, plus a unit weight along -z, so that the
rotations and the translations of an elastic solid's near-nullspace are
both loaded. A vector load: returns (..., 3)."""

import torch


def at(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([0.5 - x[..., 1], x[..., 0] - 0.5, -torch.ones_like(x[..., 0])], dim=-1)
