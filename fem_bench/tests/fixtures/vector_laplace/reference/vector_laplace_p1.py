"""The vector Laplacian -div(kappa grad u_c) = f_c, u = 0 on the Dirichlet
nodes: its components do not couple, so it is one scalar P1 reference
solve (``p1.Reference``) a component, each with its own load."""

from __future__ import annotations

import torch


def solve(ref, kappa, loads, control=None):
    """The solution at every node (N, components), float64, and the most CG
    iterations of a component."""
    columns, most = [], 0
    for load in loads:
        u, iters = ref.solve(kappa, load, control=control)
        columns.append(u)
        most = max(most, iters)
    return torch.stack(columns, dim=1), most
