"""PyTorch port, ``parallel/sharded_bsr.py`` against the JAX package in
float64.

Host side, in this process with no process group: the shard plan's tables
byte-identical to JAX's (dtype, shape and bytes of ``cells_sh``,
``slots_sh``, ``bcols_sh``, ``bcols2_sh``, ``hrows_sh``, ``agg_sh``,
``vec_slots_sh``, ``owned_cells_sh`` and every integer field) for n_shards
1, 2 and 4 on the h=0.25 seven-fracture network and ``unit_square(n=16)``;
the plan's memory proportional to n / n_shards (the JAX test's bounds);
the plan cached beside the basis, not on it; each shard's row-slice SpMV
(the call K2 takes on the card) equal to the rows of the whole product.

Ranks: gloo processes on the CPU, 2 and 4 of them, spawned once per module
in the background (``torch_dist_worker.start``). For ``sharded_bsr_solver``
(the cases of the JAX package's ``tests/test_sharded_bsr.py``: the h=0.3
seven-fracture network, a P1 ``rectangle(24, 24)`` with the sine load, a
replacement right-hand side) and ``solve_pcg_sharded_bsr`` on the h=0.3
network (the JAX ``test_benchmark_network_iteration_parity``, within 2 of
the single-process two-level solve): every rank's result equal to rank 0's,
iteration counts equal to JAX's sharded counts at the same n_shards
(``make_device_mesh(n)`` of the conftest's 8 virtual devices), solutions
within 1e-10 relative of JAX's, and the JAX tests' own bounds against the
single-process compiled solve. The 1e5-DOF case runs with
``FEM_TEST_SCALE=1``, as in the JAX package. The other
``solve_pcg_sharded_bsr`` cases are in ``test_torch_sharded_bsr_pcg.py``.
"""

import math
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.parallel import (
    make_device_mesh,
    sharded_bsr_solver,
    solve_pcg_sharded_bsr,
)
from pytorch_fem_solver_tpu.parallel.sharded_bsr import build_bsr_shard_plan as jax_plan
from pytorch_fem_solver_tpu.utils import build_benchmark_network
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.ops import bsr as pb
from pytorch_fem_solver_tpu_torch.ops import cuda_build
from pytorch_fem_solver_tpu_torch.parallel import sharded_bsr as psb

sys.path.insert(0, str(Path(__file__).parent))
import torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

WORLDS = (2, 4)
SCALE = bool(os.environ.get("FEM_TEST_SCALE"))
PLAN_ARRAYS = ("cells_sh", "slots_sh", "bcols_sh", "bcols2_sh", "hrows_sh", "agg_sh",
               "vec_slots_sh", "owned_cells_sh")
PLAN_INTS = ("n_shards", "nb_pad", "rps", "g", "gs", "nc", "nc_local", "ns_local", "nh_max",
             "T_max", "n_values_local")


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    if len(jax.devices()) < max(WORLDS):
        pytest.skip("needs XLA_FLAGS=--xla_force_host_platform_device_count=8")
    pool, futures = worker.start("sharded_bsr", str(tmp_path_factory.mktemp("bsr")), WORLDS)
    yield futures
    pool.shutdown(wait=True)


def stiffness(b):
    return b.v_grad @ jnp.matrix_transpose(b.v_grad)


def sine_load(b):
    x, y = b.integration_points[..., 0:1], b.integration_points[..., 1:2]
    return 2 * math.pi**2 * jnp.sin(math.pi * x) * jnp.sin(math.pi * y) * b.v


def unit_load(b):
    return b.v


# -- host: the plan ------------------------------------------------------------


PLAN_MESHES = {
    "dfn": (lambda: fem.FractureNetworkBasis(build_benchmark_network(h=0.25), fem.ElementTri(1, 2)),
            lambda: worker.benchmark_network(0.25)),
    "square": (lambda: fem.Basis(fem.MeshTri(fem.unit_square(n=16)), fem.ElementTri(1, 2)),
               lambda: worker.square(n=16)),
}


@pytest.fixture(scope="module")
def plan_bases():
    return {name: (mk_j(), mk_p()) for name, (mk_j, mk_p) in PLAN_MESHES.items()}


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("mesh", sorted(PLAN_MESHES))
def test_plan_is_byte_identical(plan_bases, mesh, n_shards):
    jV, pV = plan_bases[mesh]
    ref = jax_plan(jV, n_shards)
    plan = psb.build_bsr_shard_plan(pV, n_shards)
    for name in PLAN_INTS:
        assert getattr(plan, name) == getattr(ref, name), name
    for name in PLAN_ARRAYS:
        ours, theirs = getattr(plan, name), np.asarray(getattr(ref, name))
        assert isinstance(ours, np.ndarray), name
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, name
        assert ours.tobytes() == theirs.tobytes(), name
    if mesh == "dfn" and n_shards > 1:
        assert plan.nh_max > 0  # trace rows spill to tier 2 on every shard count


@pytest.mark.parametrize("n_shards", [2, 4])
def test_row_slice_spmv_equals_rows_of_the_product(plan_bases, n_shards):
    """Each shard's SpMV over its ``rps`` block rows against the whole
    padded iterate (K2's row-slice call; the plain version here) equals
    those rows of the single-structure product, tier 2 included."""
    _, pV = plan_bases["dfn"]
    plan = psb.build_bsr_shard_plan(pV, n_shards)
    st = plan.st
    local = pV.integrate_bilinear_form_local(worker.stiffness)
    values = pb.bsr_values_from_local(st, local)
    n_pad = plan.nb_pad * st.block
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(n_pad))
    y_ref = torch.nn.functional.pad(pb.bsr_matvec(st, values, x[: st.n_pad]), (0, n_pad - st.n_pad))
    rows = plan.rps * st.block
    for rank in range(n_shards):
        t = psb._shard_tables(plan, rank, "cpu")
        v1, v2, _ = psb._scatter_local_values(plan, local.reshape(-1, 3, 3)[t.cells], t)
        y = pb.bsr_spmv(t.bcols, v1, x, t.bcols2, v2[: t.nh], t.hrows, t.row_blocks, t.heavy_rank)
        assert y.shape == (rows,)
        assert worker.rel(y.numpy(), y_ref[rank * rows:(rank + 1) * rows].numpy()) <= 1e-14


def test_plan_memory_is_proportional():
    """Every O(n) per-shard table scales with n / n_shards (the JAX test's
    bounds, at 8 shards of a P1 ``rectangle(96, 96)``)."""
    V = worker.square(n=96)
    plan = psb.get_bsr_shard_plan(V, 8)
    st = plan.st
    assert plan.n_values_local <= 1.35 * st.n_values / 8 + 64 * 64
    assert plan.ns_local == (plan.nb_pad * st.block // plan.gs) // 8
    assert plan.nc_local == plan.nc // 8
    assert plan.T_max * 8 <= 1.5 * int(V.v_grad.shape[0])
    assert plan.rps * 8 == plan.nb_pad


def test_plan_cache_stays_off_the_basis():
    """``get_bsr_shard_plan`` caches per basis beside it: the same plan on a
    second call, and no attribute on the basis names a plan."""
    V = worker.square(n=8)
    plan = psb.get_bsr_shard_plan(V, 8)
    assert plan is psb.get_bsr_shard_plan(V, 8)
    assert plan is not psb.get_bsr_shard_plan(V, 4)
    assert not any("shard" in k for k in vars(V))


def test_unknown_precondition_raises_the_reference_error():
    with pytest.raises(ValueError, match="unknown precondition: 'ilu'"):
        psb.sharded_bsr_solver(worker.square(n=4), worker.stiffness, precondition="ilu")


# -- ranks -----------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_benchmark_network_iteration_parity(runs, world):
    """h=0.3 seven fractures: JAX's sharded count, and within 2 of the
    single-process two-level solve (row padding must not degrade the
    preconditioner)."""
    V = fem.FractureNetworkBasis(build_benchmark_network(h=0.3), fem.ElementTri(1, 2))
    local = V.integrate_bilinear_form_local(stiffness)
    b = V.integrate_linear_form(unit_load)
    u_ref, info_ref = solve_pcg_sharded_bsr(V, local, b, make_device_mesh(world), tol=1e-9,
                                            return_info=True)
    res = worker.case(runs, world, "benchmark_bsr")
    assert res["it"] == int(info_ref.iterations) and res["conv"] is bool(info_ref.converged)
    assert worker.rel(res["u"], u_ref) <= 1e-10
    pV = worker.benchmark_network(0.3)
    _, info = pV.solve_iterative(pV.integrate_bilinear_form_local(worker.stiffness),
                                 pV.integrate_linear_form(worker.unit_load), tol=1e-9,
                                 precondition="two_level", return_info=True)
    assert abs(res["it"] - info.iterations) <= 2


def check_solver(runs, world, name, V, lf, tol):
    """``sharded_bsr_solver``: JAX's sharded count and solution (1e-10
    relative), and the single-process compiled solve's count within 2
    (the JAX test's bound) and its solution within the JAX test's bound."""
    u_ref, (it_ref, _, conv_ref) = sharded_bsr_solver(
        V, stiffness, lf, device_mesh=make_device_mesh(world), tol=tol
    )()
    res = worker.case(runs, world, name)
    assert res["type"] == ("int", 0, 0)  # (int, 0-dim tensor, 0-dim bool tensor)
    assert res["it"] == int(it_ref) and res["conv"] is bool(conv_ref) is True
    assert worker.rel(res["u"], u_ref) <= 1e-10
    assert abs(res["it"] - res["it_compiled"]) <= 2
    scale = max(np.abs(res["u_compiled"]).max(), 1e-30)
    assert np.abs(res["u"] - res["u_compiled"]).max() <= 1e-8 * scale
    return res


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solver_on_dfn(runs, world):
    V = fem.FractureNetworkBasis(build_benchmark_network(h=0.3), fem.ElementTri(1, 2))
    check_solver(runs, world, "solver_dfn", V, unit_load, 1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solver_matches_compiled(runs, world):
    V = fem.Basis(fem.MeshTri(fem.rectangle(24, 24)), fem.ElementTri(1, 3))
    res = check_solver(runs, world, "solver_square", V, sine_load, 1e-8)
    assert res["it"] == res["it_compiled"]  # the same aggregate policy


@pytest.mark.parametrize("world", WORLDS)
def test_replacement_rhs_and_repeat(runs, world):
    """``solve(b)`` with the assembled load equals the solve built with the
    linear form (bitwise), and a second call repeats the first bitwise."""
    res = worker.case(runs, world, "rhs_replaced")
    assert res["diff"] == 0.0 and res["it"][0] == res["it"][1] and res["repeat_bitwise"]


@pytest.mark.skipif(not SCALE, reason="1e5-DOF CPU solve; set FEM_TEST_SCALE=1")
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solver_at_1e5_dofs(runs, world):
    V = fem.Basis(fem.MeshTri(fem.rectangle(320, 320)), fem.ElementTri(1, 3))
    assert V.n_dofs >= 100_000
    res = check_solver(runs, world, "solver_1e5", V, sine_load, 1e-8)
    assert res["it"] == res["it_compiled"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k2_row_slice_matches_plain_on_card(plan_bases, dtype, tol):
    """K2 on a shard's block rows against the whole iterate, held against
    its plain version; the launch is counted under ``bsr_spmv``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 is a CUDA kernel with no CPU mode")
    _, pV = plan_bases["dfn"]
    plan = psb.build_bsr_shard_plan(pV, 2)
    local = pV.integrate_bilinear_form_local(worker.stiffness).reshape(-1, 3, 3)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(plan.nb_pad * 8))
    for rank in range(2):
        t = psb._shard_tables(plan, rank, "cuda")
        v1, v2, _ = psb._scatter_local_values(plan, local.cuda()[t.cells], t)
        v1, v2 = v1.to(dtype), v2[: t.nh].to(dtype).contiguous()
        xd = x.to("cuda", dtype)
        before = cuda_build.launch_counts["bsr_spmv"]
        y = pb.bsr_spmv(t.bcols, v1, xd, t.bcols2, v2, t.hrows, t.row_blocks, t.heavy_rank)
        assert cuda_build.launch_counts["bsr_spmv"] == before + 1
        ref = pb._bsr_spmv_plain(t.bcols, v1, xd, t.bcols2, v2, t.hrows)
        assert float((y - ref).norm() / ref.norm()) <= tol
