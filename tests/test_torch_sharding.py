"""PyTorch port, the sharded PCG of ``parallel/sharding.py`` and the
solvers' ``dot`` against the JAX package in float64.

The port's ranks are gloo processes on the CPU, 2 and 4 of them, spawned
once per module in the background (``torch_dist_worker.start``); they run
every case and each test reads its own entry. The JAX side runs here, on
the conftest's 8 virtual devices, through ``make_device_mesh(n)`` with the
same n. Held, for the matrix-free and ELL cases of the JAX package's
``tests/test_sharding.py`` (the square, the two fractures, the h=0.3
seven-fracture network and a tet mesh): every rank's result equal to rank
0's, iteration counts equal to JAX's sharded counts, solutions within
1e-10 relative of JAX's. The default ``pcg``, ``minres`` and ``bicgstab``
are bitwise unchanged by the ``dot`` argument. The cell-sharded basis is in
``test_torch_sharded_basis.py``, the other BSR cases in
``test_torch_sharded_bsr.py`` and ``test_torch_sharded_bsr_pcg.py``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.ops import solvers as jax_solvers
from pytorch_fem_solver_tpu.parallel import (
    make_device_mesh,
    solve_pcg_sharded,
    solve_pcg_sharded_ell,
)
from pytorch_fem_solver_tpu.utils import build_benchmark_network
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.ops import solvers
from pytorch_fem_solver_tpu_torch.parallel import make_device_mesh as make_port_mesh

sys.path.insert(0, str(Path(__file__).parent))
import torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

WORLDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    if len(jax.devices()) < max(WORLDS):
        pytest.skip("needs XLA_FLAGS=--xla_force_host_platform_device_count=8")
    pool, futures = worker.start("sharding", str(tmp_path_factory.mktemp("sharding")), WORLDS)
    yield futures
    pool.shutdown(wait=True)


def stiffness(b):
    return b.v_grad @ jnp.matrix_transpose(b.v_grad)


def load(b):
    x, y = b.integration_points[..., 0:1], b.integration_points[..., 1:2]
    return (1.0 + x + y) * b.v


def cube_load(b):
    p = b.integration_points
    return (1.0 + p[..., 0:1] + p[..., 1:2] + p[..., 2:3]) * b.v


def fractures(nx, ny):
    tri = fem.rectangle(nx, ny, x0=-1.0, x1=1.0, y0=0.0, y1=1.0)
    dfn = fem.FracturesTri([tri, tri], worker.FRACTURES_3D, anchor_vertices_2d=worker.ANCHORS)
    return fem.FractureBasis(dfn, fem.ElementTri(1, 2))


def check_solve(runs, world, name, jax_solver, V, form, **kw):
    """The JAX sharded solve at ``world`` devices, then the ranks' case:
    equal count, both converged, solutions within 1e-10 relative."""
    local = V.integrate_bilinear_form_local(stiffness)
    b = V.integrate_linear_form(form)
    u_ref, info_ref = jax_solver(V, local, b, make_device_mesh(world), return_info=True, **kw)
    res = worker.case(runs, world, name)
    assert res["it"] == int(info_ref.iterations)
    assert res["conv"] is bool(info_ref.converged) is True
    assert res["u"].shape == u_ref.shape
    assert worker.rel(res["u"], u_ref) <= 1e-10
    return res


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pcg_matches_jax(runs, world):
    V = fem.Basis(fem.MeshTri(fem.unit_square(n=12)), fem.ElementTri(1, 2))
    check_solve(runs, world, "pcg_square", solve_pcg_sharded, V, load, tol=1e-13)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pcg_on_fractures(runs, world):
    check_solve(runs, world, "pcg_fractures", solve_pcg_sharded, fractures(8, 4), load,
                tol=1e-13)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ell_pcg_matches_jax(runs, world):
    """Row-sharded hybrid ELL with its spill tail (max_k=6)."""
    check_solve(runs, world, "ell_fractures", solve_pcg_sharded_ell, fractures(8, 4), load,
                tol=1e-13, max_k=6)


@pytest.mark.parametrize("world", WORLDS)
def test_benchmark_network_iteration_parity(runs, world):
    """The h=0.3 seven-fracture network: the sharded ELL solve takes JAX's
    sharded count, within 2 of the single-process ELL solve (the JAX
    test's bound: row padding must not degrade the solve)."""
    V = fem.FractureNetworkBasis(build_benchmark_network(h=0.3), fem.ElementTri(1, 2))
    res = check_solve(runs, world, "benchmark_ell", solve_pcg_sharded_ell, V, lambda b: b.v,
                      tol=1e-9)
    pV = worker.benchmark_network(0.3)
    local = pV.integrate_bilinear_form_local(worker.stiffness)
    b = pV.integrate_linear_form(worker.unit_load)
    _, info = pV.solve_iterative(local, b, tol=1e-9, method="ell", return_info=True)
    assert abs(res["it"] - info.iterations) <= 2


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ell_on_tet_mesh(runs, world):
    V = fem.Basis(fem.MeshTet(fem.unit_cube(4)), fem.ElementTet(1, 2))
    check_solve(runs, world, "tet_ell", solve_pcg_sharded_ell, V, cube_load, tol=1e-13,
                max_k=16)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return torch.from_numpy(a @ a.T + n * np.eye(n)), torch.from_numpy(rng.standard_normal(n))


@pytest.mark.parametrize("solver", ["pcg", "minres", "bicgstab"])
def test_default_dot_is_bitwise_unchanged(solver):
    """``dot=None``, ``dot=torch.dot`` and a wrapped ``torch.dot`` give
    bitwise the same solve, with the JAX package's iteration count and its
    solution to 1e-10 relative."""
    A, b = _spd(40, 3)
    fn = getattr(solvers, solver)
    diag = {} if solver == "minres" else {"precond_diag": torch.diagonal(A)}
    x0, i0 = fn(lambda v: A @ v, b, tol=1e-12, **diag)
    for dot in (torch.dot, lambda u, v: torch.dot(u, v)):
        x1, i1 = fn(lambda v: A @ v, b, tol=1e-12, dot=dot, **diag)
        assert torch.equal(x0, x1) and i0.iterations == i1.iterations
        assert torch.equal(i0.residual_norm, i1.residual_norm)
    jA, jb = jnp.asarray(A.numpy()), jnp.asarray(b.numpy())
    jdiag = {k: jnp.asarray(v.numpy()) for k, v in diag.items()}
    x_ref, info_ref = getattr(jax_solvers, solver)(lambda v: jA @ v, jb, tol=1e-12, **jdiag)
    assert i0.iterations == int(info_ref.iterations)
    assert worker.rel(x0.numpy(), x_ref) <= 1e-10


def test_dot_reads_the_rhs_norm():
    """``||b||`` is read through ``dot``: a dot that doubles every product
    (what a group of two ranks each holding the whole vector would sum)
    scales both sides of the relative stopping test alike, so the count
    and the iterate stay those of ``torch.dot``."""
    A, b = _spd(30, 5)
    x0, i0 = solvers.pcg(lambda v: A @ v, b, tol=1e-10)
    x2, i2 = solvers.pcg(lambda v: A @ v, b, tol=1e-10, dot=lambda u, v: 2 * torch.dot(u, v))
    assert i0.iterations == i2.iterations
    assert worker.rel(x2.numpy(), x0.numpy()) <= 1e-12


def test_make_device_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised default process group"):
        make_port_mesh()
