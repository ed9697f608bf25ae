"""The RVPINN training workload on the port, and the two-fracture RVPINN loss.

``make_rvpinn`` is the counterpart of the repo-root ``bench_vpinn.py``
(``tpu_epoch_time``): the reference's ``examples/example_weak.py`` epoch
on ``MeshTri(unit_square(n))`` with ``ElementTri(1, 4)``: the network's
input gradient at every quadrature point, the weighted scatter into the
residual vector, the Gram-preconditioned loss ``r^T G^{-1} r``, the
relative-loss and H1 metrics, the double backward and an Adam step at 1e-3.
Its defaults are that benchmark's (N=64: 8,192 cells, 49,152 quadrature
points; width 15, depth 4, 50 epochs).

The Gram G is the reduced P1 stiffness of the test space. Where the JAX
benchmark integrates ``grad . grad`` with XLA, this one assembles it from
the rows of the 2D P1 element kernel K5 (``ops.kernels.p1_local_stiffness_load``,
the port of the Pallas ``_p1_kernel``), which computes exactly that matrix on
this mesh; ``G^{-1}`` is dense, as in the benchmark.

``make_dfn_rvpinn`` is the counterpart of the repo's flagship DFN VPINN,
``examples/example_seven_fractures_vpinn.py`` with the settings of
``tools/exp_dfn_vpinn_epoch.py``: the seven-fracture benchmark DFN, P1
``ElementTri(1, 2)``, a FEM oracle by ``solve_iterative`` (BSR operator, so
every PCG iteration runs the SpMV kernel K2), a 3 -> 24x4 -> 1 MLP trained
against the glued P1 test space through the matrix-free PCG Gram solver
(``gram_solver(method="pcg")``), a weak boundary penalty, the H1 distance
to the FEM solution through the fracture maps, Adam at 1e-3, and the
previous epoch's Gram iterate warm-starting the next through
``Model(training_state0=...)``. Its full size is h=0.1 (19,680 cells,
9,795 DOFs).

``make_posteriori_rvpinn`` is the counterpart of
``examples/example_weak_plus_posterri.py`` at ``make_rvpinn``'s size: the
same RVPINN loss plus the a-posteriori estimator of the network,
``r^T G^{-1} r + sum_T h_T^2 (f + Δu_θ)^2 + sum_E h_E [grad u_θ . n]^2``,
the jump taken from the two-sided traces of the network's nodal
interpolant onto ``InteriorEdgesBasis(ElementLine(1, 2))``
(``examples/common.py:make_edge_jump``). The Gram is K5's, as in
``make_rvpinn``; ``weak=False`` drops the weak term, which is the loss of
``examples/example_jump.py``.

``make_patches_rvpinn`` is the counterpart of ``examples/example_patches.py``:
the RVPINN whose test spaces are B criss-cross patches of a quadtree
hierarchy over the unit square (``generate_patches_info``; 64 patches at
the example's ``levels=3``), P1 ``PatchesBasis`` with ``ElementTri(1, 2)``
for training and ``ElementTri(1, 4)`` for validation, the batched (B, k, k)
Gram inverses, an H1 error basis on ``unit_square(max_area=0.5**8)``, a
2 -> 15x4 -> 1 MLP with Xavier initialisation and the boundary modifier,
and Adam at 1e-3. Both Grams are the reduced P1 stiffness of the patch
cells, assembled per patch from K5's rows.

``make_two_fracture`` is the counterpart of ``__graft_entry__.py``'s
``_build_problem``: two isometric fracture charts of ``rectangle(2n, n)``
glued along their trace, ``ElementTri(1, 2)``, a 3 -> 16 MLP with 3 hidden
layers and the RVPINN loss ``sum(r^2)``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import config
from .basis import (
    Basis,
    FractureBasis,
    FractureNetworkBasis,
    InteriorEdgesBasis,
    PatchesBasis,
)
from .element import ElementLine, ElementTri
from .mesh import (
    FractureNetworkMesh,
    FracturesTri,
    MeshTri,
    Patches,
    rectangle,
    unit_square,
)
from .models import FeedForwardNeuralNetwork, Model
from .ops.kernels import p1_local_stiffness_load
from .ops.solvers import PCGInfo
from .utils import build_benchmark_network

N = 64
WIDTH = 15
DEPTH = 4
EPOCHS = 50
LEARNING_RATE = 1e-3


def _unit_square_bc(inputs):
    x, y = inputs[..., 0:1], inputs[..., 1:2]
    return x * (x - 1) * y * (y - 1)


def _exact(x, y):
    return torch.sin(math.pi * x) * torch.sin(math.pi * y)


def _exact_dx(x, y):
    return math.pi * torch.cos(math.pi * x) * torch.sin(math.pi * y)


def _exact_dy(x, y):
    return math.pi * torch.sin(math.pi * x) * torch.cos(math.pi * y)


def _h1_exact(basis):
    x, y = basis.integration_points[..., 0:1], basis.integration_points[..., 1:2]
    return _exact(x, y) ** 2 + _exact_dx(x, y) ** 2 + _exact_dy(x, y) ** 2


def _residual(basis, gradient):
    pts = basis.integration_points
    x, y = pts[..., 0:1], pts[..., 1:2]
    rhs = 2.0 * math.pi**2 * torch.sin(math.pi * x) * torch.sin(math.pi * y)
    return rhs * basis.v - (basis.v_grad @ gradient(pts).mT)


def _h1_norm(basis, net, gradient):
    pts = basis.integration_points
    x, y = pts[..., 0:1], pts[..., 1:2]
    g = gradient(pts)
    return (
        (_exact(x, y) - net(pts)) ** 2
        + (_exact_dx(x, y) - g[..., 0:1]) ** 2
        + (_exact_dy(x, y) - g[..., 1:2]) ** 2
    )


def rvpinn_gram_inverse(basis) -> torch.Tensor:
    """Dense ``inv(reduce(K))``, K the P1 stiffness assembled from K5's
    rows of the basis's mesh cells."""
    stiff, _, _ = p1_local_stiffness_load(basis.mesh["cells", "coordinates"])
    return torch.linalg.inv(basis.reduce(basis._assemble_bilinear_from_local(stiff)))


class RVPINN(NamedTuple):
    mesh: MeshTri
    basis: Basis
    network: FeedForwardNeuralNetwork
    gram_inv: torch.Tensor
    exact_norm: torch.Tensor
    training_step: Callable
    model: Model


def make_rvpinn(
    n: int = N,
    width: int = WIDTH,
    depth: int = DEPTH,
    *,
    epochs: int = EPOCHS,
    seed: int = 0,
    device=None,
    dtype: torch.dtype | None = None,
) -> RVPINN:
    """The RVPINN benchmark: mesh, basis, seeded network, K5-built Gram
    inverse, training step and an Adam ``Model`` at 1e-3.

    ``training_step(net)`` returns ``(loss, relative, h1_error)``; the two
    metrics are computed under ``torch.no_grad()`` and feed no backward.
    ``device`` defaults to the card, ``dtype`` to ``config.default_dtype()``.
    """
    device = config.resolve_device(device)
    dtype = dtype or config.default_dtype()
    mesh = MeshTri(unit_square(n=n), device=device, dtype=dtype)
    V = Basis(mesh, ElementTri(1, 4))
    net = FeedForwardNeuralNetwork(
        2, 1, depth, width, boundary_condition_modifier=_unit_square_bc, seed=seed,
        device=device, dtype=dtype,
    )
    gram_inv = rvpinn_gram_inverse(V)
    exact_norm = torch.sqrt(V.integrate_functional(_h1_exact).sum())

    def training_step(net):
        r = V.reduce(V.integrate_linear_form(_residual, net.gradient))
        loss = (r.T @ (gram_inv @ r))[0, 0]
        with torch.no_grad():
            relative = torch.sqrt(loss) / exact_norm**2
            h1_err = torch.sqrt(V.integrate_functional(_h1_norm, net, net.gradient).sum())
        return loss, relative, h1_err / exact_norm

    model = Model(
        net, training_step, epochs=epochs, optimizer_kwargs={"lr": LEARNING_RATE},
        progress_bar=False,
    )
    return RVPINN(mesh, V, net, gram_inv, exact_norm, training_step, model)


# -- the RVPINN with the a-posteriori estimator --------------------------------


def _rhs(x, y):
    return 2.0 * math.pi**2 * torch.sin(math.pi * x) * torch.sin(math.pi * y)


class PosterioriRVPINN(NamedTuple):
    mesh: MeshTri
    basis: Basis
    edges: InteriorEdgesBasis
    network: FeedForwardNeuralNetwork
    gram_inv: torch.Tensor
    exact_norm: torch.Tensor
    loss_terms: Callable  # net -> (weak, bulk, jump), each a scalar tensor
    training_step: Callable
    model: Model


def make_posteriori_rvpinn(
    n: int = N,
    width: int = WIDTH,
    depth: int = DEPTH,
    weak: bool = True,
    *,
    epochs: int = EPOCHS,
    seed: int = 0,
    device=None,
    dtype: torch.dtype | None = None,
) -> PosterioriRVPINN:
    """The estimator RVPINN: ``make_rvpinn``'s mesh, basis, seeded network
    and K5-built Gram inverse, the interior-edge basis, and an Adam
    ``Model`` at 1e-3 on the loss ``weak + bulk + jump`` (``bulk + jump``
    with ``weak=False``).

    ``loss_terms(net)`` returns the three terms; ``training_step(net)``
    returns ``(loss, relative, h1_error)`` with the two metrics (``sqrt(loss)
    / ||u||^2`` and the relative H1 error, as the examples report them)
    computed under ``torch.no_grad()``. ``device`` defaults to the card,
    ``dtype`` to ``config.default_dtype()``.
    """
    device = config.resolve_device(device)
    dtype = dtype or config.default_dtype()
    mesh = MeshTri(unit_square(n=n), device=device, dtype=dtype)
    V = Basis(mesh, ElementTri(1, 4))
    V_edges = InteriorEdgesBasis(mesh, ElementLine(1, 2))
    net = FeedForwardNeuralNetwork(
        2, 1, depth, width, boundary_condition_modifier=_unit_square_bc, seed=seed,
        device=device, dtype=dtype,
    )
    gram_inv = rvpinn_gram_inverse(V) if weak else None
    exact_norm = torch.sqrt(V.integrate_functional(_h1_exact).sum())

    _, interp_to_edges_grad = V.interpolate(V_edges)
    h_T = mesh["cells", "length"]
    h_E = mesh["interior_edges", "length"][..., None, :, :]
    n_E = mesh["interior_edges", "normals"][..., None, :, :]

    def jump(_, normals, edge_size, net):
        grad = interp_to_edges_grad(net)
        return edge_size * (
            (grad[:, 0] * normals).sum(-1, keepdim=True)
            + (grad[:, 1] * -normals).sum(-1, keepdim=True)
        ) ** 2

    def bulk(basis, triangle_size, net):
        pts = basis.integration_points
        x, y = pts[..., 0:1], pts[..., 1:2]
        return triangle_size**2 * (_rhs(x, y) + net.laplacian(pts)) ** 2

    def loss_terms(net):
        if weak:
            r = V.reduce(V.integrate_linear_form(_residual, net.gradient))
            weak_term = (r.T @ (gram_inv @ r))[0, 0]
        else:
            weak_term = torch.zeros((), dtype=dtype, device=device)
        jump_term = V_edges.integrate_functional(jump, n_E, h_E, net).sum()
        bulk_term = V.integrate_functional(bulk, h_T, net).sum()
        return weak_term, bulk_term, jump_term

    def training_step(net):
        weak_term, bulk_term, jump_term = loss_terms(net)
        loss = weak_term + (jump_term + bulk_term) if weak else jump_term + bulk_term
        with torch.no_grad():
            relative = torch.sqrt(loss) / exact_norm**2
            h1_err = torch.sqrt(V.integrate_functional(_h1_norm, net, net.gradient).sum())
        return loss, relative, h1_err / exact_norm

    model = Model(
        net, training_step, epochs=epochs, optimizer_kwargs={"lr": LEARNING_RATE},
        progress_bar=False,
    )
    return PosterioriRVPINN(
        mesh, V, V_edges, net, gram_inv, exact_norm, loss_terms, training_step, model
    )


# -- the seven-fracture DFN RVPINN -------------------------------------------

DFN_H = 0.1
DFN_EPOCHS = 20
DFN_WIDTH = 24
DFN_DEPTH = 4
DFN_FINAL_LAYER_SCALE = 0.05
DFN_ORACLE_TOL = 1e-6
BC_WEIGHT = 50.0


def _stiffness(basis):
    return basis.v_grad @ basis.v_grad.mT


def _unit_load(basis):
    return basis.v


def _dfn_residual(basis, net):
    pts = basis.integration_points
    return basis.v - (basis.v_grad @ net.gradient(pts).mT)


class DFNRVPINN(NamedTuple):
    mesh: FractureNetworkMesh
    basis: FractureNetworkBasis
    network: FeedForwardNeuralNetwork
    u_fem: torch.Tensor  # (n_dofs, 1) the oracle's FEM solution
    oracle_info: PCGInfo
    fem_norm: torch.Tensor  # H1 norm of the FEM solution
    gram_solve: Callable  # the Gram solver (a ``GramPCG`` for gram="pcg")
    boundary_nodes: torch.Tensor  # (n_b, 3) boundary-marked vertices
    training_step: Callable
    model: Model


def make_dfn_rvpinn(
    h: float = DFN_H,
    gram: str = "pcg",
    warm: bool = True,
    *,
    epochs: int = DFN_EPOCHS,
    seed: int = 0,
    mesh: FractureNetworkMesh | None = None,
    device=None,
    dtype: torch.dtype | None = None,
) -> DFNRVPINN:
    """The seven-fracture DFN RVPINN: oracle solve, seeded network, Gram
    solver, training step and an Adam ``Model`` at 1e-3.

    ``-Δu = 1`` with homogeneous Dirichlet data imposed weakly (penalty
    ``BC_WEIGHT`` on the network at the boundary-marked vertices). The loss
    is ``r^T G^{-1} r + BC_WEIGHT * mean(net(boundary)^2)``, ``r`` the
    reduced residual vector; ``training_step`` also returns the relative
    weak norm ``sqrt(r^T G^{-1} r) / ||u_fem||`` and the relative H1
    distance to the FEM solution, both computed without a graph. With
    ``warm`` (``gram="pcg"`` only) the step is stateful: ``training_step(net,
    x_prev) -> ((loss, relative, h1), x)`` and the Model threads the Gram
    iterate from a zero ``training_state0``. ``mesh`` may pass the
    benchmark mesh at ``h`` built already, on ``device`` in ``dtype``.
    ``device`` defaults to the card, ``dtype`` to ``config.default_dtype()``.
    """
    if warm and gram != "pcg":
        raise ValueError("the warm start seeds the PCG Gram solve: use gram='pcg'")
    device = config.resolve_device(device)
    dtype = dtype or config.default_dtype()
    if mesh is None:
        mesh = build_benchmark_network(h, device=device, dtype=dtype)
    V = FractureNetworkBasis(mesh, ElementTri(1, 2))

    u_fem, oracle_info = V.solve_iterative(
        V.integrate_bilinear_form_local(_stiffness),
        V.integrate_linear_form(_unit_load),
        tol=DFN_ORACLE_TOL,
        precondition="two_level",
        return_info=True,
    )
    I_fem, I_fem_grad = V.interpolate(V, u_fem)
    fem_norm = torch.sqrt(
        V.integrate_functional(
            lambda b, u, g: u**2 + (g**2).sum(-1, keepdim=True), I_fem, I_fem_grad
        ).sum()
    )

    net = FeedForwardNeuralNetwork(
        input_dimension=3,
        output_dimension=1,
        nb_hidden_layers=DFN_DEPTH,
        neurons_per_layers=DFN_WIDTH,
        final_layer_scale=DFN_FINAL_LAYER_SCALE,
        seed=seed,
        device=device,
        dtype=dtype,
    )
    markers = mesh["global", "markers"][:, 0]
    boundary_nodes = mesh["global", "vertices_3d"][markers == 1]
    gram_solve = V.gram_solver(_stiffness, method=gram)

    cell_frac = mesh["cells", "fracture"][:, 0]
    tangent_map = (
        mesh["fracture_map", "jacobian"] @ mesh["fracture_map", "inv_jacobian"]
    )[cell_frac][:, None]

    def h1_error_vs_fem(basis, net):
        pts = basis.integration_points
        tangent = net.gradient(pts) @ tangent_map
        return (net(pts) - I_fem) ** 2 + ((tangent - I_fem_grad) ** 2).sum(
            -1, keepdim=True
        )

    def loss_and_metrics(net, r, x):
        weak = (r.T @ x)[0, 0]
        loss = weak + BC_WEIGHT * torch.mean(net(boundary_nodes) ** 2)
        with torch.no_grad():
            relative = torch.sqrt(weak) / fem_norm
            h1 = torch.sqrt(V.integrate_functional(h1_error_vs_fem, net).sum())
        return loss, relative, h1 / fem_norm

    if warm:

        def training_step(net, x_prev):
            r = V.reduce(V.integrate_linear_form(_dfn_residual, net))
            x = gram_solve(r, x_prev)
            return loss_and_metrics(net, r, x), x.detach()

        n_inner = int(V._basis_parameters["inner_dofs"].shape[0])
        state0 = torch.zeros((n_inner, 1), dtype=dtype, device=device)
    else:

        def training_step(net):
            r = V.reduce(V.integrate_linear_form(_dfn_residual, net))
            return loss_and_metrics(net, r, gram_solve(r))

        state0 = None

    model = Model(
        net, training_step, epochs=epochs, optimizer_kwargs={"lr": LEARNING_RATE},
        progress_bar=False, training_state0=state0,
    )
    return DFNRVPINN(
        mesh, V, net, u_fem, oracle_info, fem_norm, gram_solve, boundary_nodes,
        training_step, model,
    )


# -- the patch RVPINN --------------------------------------------------------

PATCH_LEVELS = 3
PATCH_ERROR_MAX_AREA = 0.5**8


def generate_patches_info(n: int):
    """Centers (4^n, 2) and radii (4^n, 1) of the quadtree patch hierarchy
    over the unit square after ``n`` splits of the single patch of radius
    1/2 (``examples/example_patches.py``)."""
    centers = [(0.5, 0.5)]
    radius = [0.5]
    for _ in range(n):
        new_centers, new_radius = [], []
        for (cx, cy), r in zip(centers, radius):
            nr = r / 2
            new_centers.extend(
                [(cx - nr, cy - nr), (cx - nr, cy + nr), (cx + nr, cy - nr), (cx + nr, cy + nr)]
            )
            new_radius.extend([nr] * 4)
        centers, radius = new_centers, new_radius
    return np.asarray(centers), np.asarray(radius)[:, None]


def patch_gram(basis: PatchesBasis) -> torch.Tensor:
    """Batched ``reduce(K)`` (B, k, k), K the P1 stiffness of each patch,
    assembled per patch from K5's rows of the patch cells."""
    coords = basis.mesh["cells", "coordinates"]  # (B, T, 3, 2)
    stiff, _, _ = p1_local_stiffness_load(coords.reshape(-1, 3, 2))
    local = stiff.reshape(coords.shape[:2] + (3, 3))
    return basis.reduce(basis._assemble_bilinear_from_local(local))


class PatchRVPINN(NamedTuple):
    patches: Patches
    basis: PatchesBasis  # training test spaces, ElementTri(1, 2)
    validation_basis: PatchesBasis  # ElementTri(1, 4)
    error_basis: Basis
    network: FeedForwardNeuralNetwork
    gram_inv: torch.Tensor  # (B, k, k)
    validation_gram_inv: torch.Tensor  # (B, k, k)
    exact_norm: torch.Tensor
    training_step: Callable
    model: Model


def make_patches_rvpinn(
    levels: int = PATCH_LEVELS,
    width: int = WIDTH,
    depth: int = DEPTH,
    *,
    epochs: int = EPOCHS,
    seed: int = 0,
    device=None,
    dtype: torch.dtype | None = None,
) -> PatchRVPINN:
    """The patch RVPINN of ``examples/example_patches.py`` with 4^levels
    patches: the patch meshes and bases, the error basis, the seeded
    network, the two K5-built batched Gram inverses, the training step and
    an Adam ``Model`` at 1e-3.

    ``training_step(net)`` returns the example's ``(loss, val_loss,
    h1_error)``: ``sum_B r_B^T G_B^{-1} r_B`` on the training spaces, the
    same on the validation spaces as ``sqrt(.) / ||u||^2``, and the
    relative H1 error on the error basis; the two metrics are computed
    under ``torch.no_grad()``. ``device`` defaults to the card, ``dtype``
    to ``config.default_dtype()``.
    """
    device = config.resolve_device(device)
    dtype = dtype or config.default_dtype()
    net = FeedForwardNeuralNetwork(
        2, 1, depth, width, use_xavier_initialization=True,
        boundary_condition_modifier=_unit_square_bc, seed=seed, device=device, dtype=dtype,
    )
    centers, radius = generate_patches_info(levels)
    patches = Patches(centers, radius, device=device, dtype=dtype)
    mesh = MeshTri(unit_square(max_area=PATCH_ERROR_MAX_AREA), device=device, dtype=dtype)
    V = PatchesBasis(patches, ElementTri(1, 2))
    V_val = PatchesBasis(patches, ElementTri(1, 4))
    V_err = Basis(mesh, ElementTri(1, 2))
    gram_inv = torch.linalg.inv(patch_gram(V))
    val_gram_inv = torch.linalg.inv(patch_gram(V_val))
    exact_norm = torch.sqrt(V_err.integrate_functional(_h1_exact).sum())

    def weak(basis, inv, net):
        r = basis.reduce(basis.integrate_linear_form(_residual, net.gradient))  # (B, k, 1)
        return (r.mT @ (inv @ r)).sum()

    def training_step(net):
        loss = weak(V, gram_inv, net)
        with torch.no_grad():
            val_loss = torch.sqrt(weak(V_val, val_gram_inv, net)) / exact_norm**2
            h1_err = torch.sqrt(V_err.integrate_functional(_h1_norm, net, net.gradient).sum())
        return loss, val_loss, h1_err / exact_norm

    model = Model(
        net, training_step, epochs=epochs, optimizer_kwargs={"lr": LEARNING_RATE},
        progress_bar=False,
    )
    return PatchRVPINN(
        patches, V, V_val, V_err, net, gram_inv, val_gram_inv, exact_norm,
        training_step, model,
    )


# -- the two-fracture RVPINN loss -------------------------------------------

#: the 3D images of the two charts' anchors (x = -1..1, y = 0..1)
FRACTURES_3D = np.array(
    [
        [[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 1.0, 0.0]],
        [[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 1.0, -1.0]],
    ]
)
ANCHORS_2D = np.array([[[-1.0, 0.0], [1.0, 0.0], [-1.0, 1.0]]] * 2)


def _fracture_bc(inputs):
    x, y, z = inputs[..., 0:1], inputs[..., 1:2], inputs[..., 2:3]
    return y * (1 - y) * (x**2 - 1) * (z**2 - 1)


def _fracture_rhs(c):
    x, y, z = c[..., 0:1], c[..., 1:2], c[..., 2:3]
    r1 = 6.0 * (y - y**2) * torch.abs(x) - 2.0 * (torch.abs(x) ** 3 - torch.abs(x))
    r2 = -6.0 * (y - y**2) * torch.abs(z) + 2.0 * (torch.abs(z) ** 3 - torch.abs(z))
    return torch.cat([r1[0:1], r2[1:2]], dim=0)


def _fracture_residual(basis, gradient):
    pts = basis.integration_points
    return _fracture_rhs(pts) * basis.v - (basis.v_grad @ gradient(pts).mT)


def two_fracture_loss(net, basis) -> torch.Tensor:
    """The RVPINN loss ``sum(r^2)`` of the reduced residual vector."""
    r = basis.reduce(basis.integrate_linear_form(_fracture_residual, net.gradient))
    return (r**2).sum()


class TwoFractureProblem(NamedTuple):
    mesh: FracturesTri
    basis: FractureBasis
    network: FeedForwardNeuralNetwork


def make_two_fracture(
    n: int = 8, *, seed: int = 0, device=None, dtype: torch.dtype | None = None
) -> TwoFractureProblem:
    """Two perpendicular unit-height fractures meeting along x = z = 0,
    each a ``rectangle(2n, n)`` chart, with the entry's network (3 -> 16,
    3 hidden layers, seeded). The loss is ``two_fracture_loss(net, basis)``."""
    device = config.resolve_device(device)
    tri = rectangle(2 * n, n, x0=-1.0, x1=1.0, y0=0.0, y1=1.0)
    mesh = FracturesTri(
        [tri, tri], FRACTURES_3D, anchor_vertices_2d=ANCHORS_2D, device=device, dtype=dtype
    )
    V = FractureBasis(mesh, ElementTri(1, 2))
    net = FeedForwardNeuralNetwork(
        input_dimension=3, output_dimension=1, nb_hidden_layers=3,
        neurons_per_layers=16, boundary_condition_modifier=_fracture_bc, seed=seed,
        device=device, dtype=mesh.dtype,
    )
    return TwoFractureProblem(mesh, V, net)
