"""The load of the upstream two-fracture example (``dfn_rhs`` of its
examples), valid on both fracture planes z = 0 and x = 0: with kappa = 1
its solution is -y (1 - y) |x| (x^2 - 1) + y (1 - y) |z| (z^2 - 1)."""

import torch


def at(x: torch.Tensor) -> torch.Tensor:
    ax, y, az = x[..., 0:1].abs(), x[..., 1:2], x[..., 2:3].abs()
    yy = 6.0 * (y - y * y)
    return yy * ax - 2.0 * (ax**3 - ax) - yy * az + 2.0 * (az**3 - az)
