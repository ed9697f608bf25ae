"""PyTorch port, the fused aggregate-block PCG tail (kernels K3 and K4).

The port's counterpart of ``tools/exp_pallas_fused_pcg.py`` is held against
the JAX package in float64 on the CPU, where the K3/K4 wrappers run their
plain versions, on the seven-fracture DFN at h=0.25 and h=0.1:

* K3 then K4 give ``z = M^{-1} rn`` of the JAX ``AggBlockTwoLevel`` to
  1e-12 (the port's preconditioner is made from the JAX one's arrays), ``rc``
  the aggregate sums and ``rz = rn . M^{-1} rn``;
* the same at ``g = gs = 128``, where the coarse size (10 and 69) is no
  multiple of 4, the shape that takes K4's one-word loads on the card;
* ``bench.make_fused_pcg``'s ``run_stock(30)`` and ``run_fused(30)`` match
  the tool's ``stock_body``, written here with JAX functions, to 1e-10;
* ``solve_fused`` takes the iteration count of the JAX ``pcg`` with the
  JAX preconditioner, and its solution is within 1e-9;
* the tool itself, its Pallas kernels run in interpret mode, keeps the
  fused loop within 5e-5 of the JAX stock loop (its own float32 check), so
  port = JAX stock = JAX Pallas.

Tests that launch K3/K4 carry the ``cuda`` marker; ``chip_smoke.py`` holds
them against their plain versions at the benchmark size.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.ops import bsr as jb
from pytorch_fem_solver_tpu.ops import precondition as jp
from pytorch_fem_solver_tpu.ops.solvers import pcg as jax_pcg
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import bench, config, interop
from pytorch_fem_solver_tpu_torch.ops import cuda_build
from pytorch_fem_solver_tpu_torch.ops import fused_pcg as fp
from pytorch_fem_solver_tpu_torch.ops.precondition import agg_block_two_level_from_values

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = 0
ITERS = 30
TOL = 1e-10


def _rel(ours, ref):
    """max |ours - ref| / max |ref|, the tool's own measure."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _port_basis(jm, device):
    pm = interop.mesh_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm._t), device=device
    )
    return bench.benchmark_basis(pm)


@pytest.fixture(scope="module", params=[0.25, 0.1], ids=["h0.25", "h0.1"])
def setup(request):
    """The tool's JAX system (assembled values, b = the reduced load, the
    aggblock preconditioner) and the port's ``make_fused_pcg`` on the same
    mesh."""
    jm = jax_network(h=request.param)
    jV = fem.FractureNetworkBasis(jm, fem.ElementTri(1, 2))
    st = jb.get_bsr_structure(jV, max_b=8, want_entry_slot=False)
    local = jV.integrate_bilinear_form_local(
        lambda b: b.v_grad @ jnp.matrix_transpose(b.v_grad)
    )
    values = jb.bsr_values_from_local_symmetric(st, local)
    b = jb.bsr_reduce(st, jV.integrate_linear_form(lambda B: B.v)[:, 0])
    g = jp.default_aggregate_size(st)
    gs = min(g, 128)
    precond = jp.agg_block_two_level_from_values(
        st, values, jb.bsr_diagonal(st, values), g=g, gs=gs,
        table=jnp.asarray(jp.build_agg_block_table(st, gs)),
    )
    assert g == gs == 32 and precond.coarse_inv.shape[0] == st.n_pad // gs
    return {
        "jm": jm,
        "st": st,
        "values": values,
        "b": b,
        "precond": precond,
        "fused": bench.make_fused_pcg(_port_basis(jm, "cpu")),
    }


def _jax_stock_steps(st, values, precond, b, iters):
    """The tool's ``stock_body`` / ``run_stock``: r0 = b, a fixed trip
    count."""

    def body(_, state):
        x, r, p, rz = state
        ap = jb.bsr_matvec(st, values, p)
        alpha = rz / jnp.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz2 = jnp.dot(r, z)
        return x, r, z + (rz2 / rz) * p, rz2

    z0 = precond(b)
    state = (jnp.zeros_like(b), b, z0, jnp.dot(b, z0))
    x, r, _, _ = jax.lax.fori_loop(0, iters, body, state)
    return np.asarray(x), np.asarray(r)


def _port_precond(jprec, device="cpu", dtype=None):
    return interop.agg_block_two_level_from_numpy(
        np.asarray(jprec.inv_agg), np.asarray(jprec.coarse_inv),
        jprec.g, jprec.gs, device=device, dtype=dtype,
    )


def _tail_inputs(n, device="cpu", dtype=torch.float64):
    rng = np.random.default_rng(SEED)
    vecs = [torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=device)
            for _ in range(4)]
    alpha = torch.tensor(rng.uniform(0.5, 1.5), dtype=dtype, device=device)
    return alpha, vecs


def _jax_precond(setup, g):
    """The JAX aggblock preconditioner with aggregates of ``g`` (the
    fixture's own at its g=32)."""
    if g == setup["precond"].g:
        return setup["precond"]
    st, values = setup["st"], setup["values"]
    return jp.agg_block_two_level_from_values(
        st, values, jb.bsr_diagonal(st, values), g=g, gs=g,
        table=jnp.asarray(jp.build_agg_block_table(st, g)),
    )


@pytest.mark.parametrize("g", [32, 128])
def test_plain_tail_matches_jax_preconditioner(setup, g):
    jprec = _jax_precond(setup, g)
    pre = _port_precond(jprec)
    # g=128 gives a coarse size that is no multiple of 4 (10 and 69)
    assert (pre.coarse_inv.shape[0] % 4 != 0) == (g == 128)
    ns, gs = fp.fused_shape(pre, setup["st"].n_pad)
    alpha, (x, r, p, ap) = _tail_inputs(ns * gs)
    xn, rn, s, rc = fp._agg_smooth_restrict_plain(
        alpha, *(v.view(ns, gs) for v in (x, r, p, ap)), pre.inv_agg
    )
    z, rz = fp._coarse_prolong_dot_plain(pre.coarse_inv, rc, s, rn)

    a = float(alpha)
    rn_ref = r.numpy() - a * ap.numpy()
    z_ref = np.asarray(jprec(jnp.asarray(rn_ref)))
    assert _rel(xn.reshape(-1), x.numpy() + a * p.numpy()) <= 1e-15
    assert _rel(rn.reshape(-1), rn_ref) <= 1e-15
    assert _rel(rc, rn_ref.reshape(ns, gs).sum(axis=1)) <= 1e-14
    assert _rel(z.reshape(-1), z_ref) <= 1e-12
    assert abs(float(rz) - rn_ref @ z_ref) <= 1e-12 * abs(rn_ref @ z_ref)


def test_wrappers_on_cpu_are_the_plain_versions(setup):
    pre = setup["fused"].precond
    # the layout the kernels take, which the card's wrappers insist on
    assert pre.inv_agg.is_contiguous() and pre.coarse_inv.is_contiguous()
    ns, gs = fp.fused_shape(pre, setup["st"].n_pad)
    alpha, vecs = _tail_inputs(ns * gs)
    args = [v.view(ns, gs) for v in vecs]
    before = dict(cuda_build.launch_counts)
    k3 = fp.agg_smooth_restrict(alpha, *args, pre.inv_agg)
    k4 = fp.coarse_prolong_dot(pre.coarse_inv, k3[3], k3[2], k3[1])
    assert cuda_build.launch_counts == before  # no kernel launched
    for ours, ref in zip(k3, fp._agg_smooth_restrict_plain(alpha, *args, pre.inv_agg)):
        assert torch.equal(ours, ref)
    for ours, ref in zip(k4, fp._coarse_prolong_dot_plain(pre.coarse_inv, k3[3], k3[2], k3[1])):
        assert torch.equal(ours, ref)


def test_fixed_length_loops_match_jax_stock_loop(setup):
    x_ref, r_ref = _jax_stock_steps(
        setup["st"], setup["values"], setup["precond"], setup["b"], ITERS
    )
    fused = setup["fused"]
    b_scale = float(np.abs(np.asarray(setup["b"])).max())
    for run in (fused.run_stock, fused.run_fused):
        x, r = run(ITERS)
        assert _rel(x.numpy(), x_ref) <= 1e-10
        # r has shrunk by orders of magnitude after 30 iterations; its
        # roundoff is that of b
        assert np.abs(r.numpy() - r_ref).max() <= 1e-12 * b_scale


def test_solve_fused_matches_jax_pcg(setup):
    st, values, jprec = setup["st"], setup["values"], setup["precond"]
    x, iters, rel = setup["fused"].solve_fused(TOL)
    x_ref, info = jax_pcg(
        lambda v: jb.bsr_matvec(st, values, v), setup["b"], precond=jprec, tol=TOL
    )
    assert iters == int(info.iterations)
    assert float(rel) <= TOL
    x_ref = np.asarray(x_ref)
    assert np.linalg.norm(x.numpy() - x_ref) <= 1e-9 * np.linalg.norm(x_ref)


def test_fused_tail_needs_coarse_aggregates_equal_to_smoother_blocks(setup):
    fused = setup["fused"]
    st = fused.structure
    diag = torch.diagonal(fused.values[0][:, 0], dim1=-2, dim2=-1).reshape(-1)
    coarse64 = agg_block_two_level_from_values(st, fused.values, diag, g=64, gs=32)
    matvec = lambda v: v  # noqa: E731  (never reached)
    with pytest.raises(ValueError, match="g=64 gs=32"):
        fp.fused_pcg_steps(matvec, coarse64, fused.b_pad, 1)
    with pytest.raises(ValueError, match="g=64 gs=32"):
        fp.fused_pcg(matvec, fused.b_pad, coarse64)
    with pytest.raises(ValueError, match="n=32"):
        fp.fused_shape(fused.precond, 32)


def test_pallas_fused_tool_in_interpret_mode():
    """The tool's own CPU check: its Pallas k1/k2, interpreted, against its
    stock loop after 30 iterations in float32 at h=0.25."""
    env = dict(os.environ, FUSED_INTERPRET="1", BENCH_H="0.25", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "exp_pallas_fused_pcg.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["metric"] == "pallas_fused_pcg_interpret_ok"
    assert result["rel_diff_30it"] < 5e-5


# -- on the card -------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K3/K4 are CUDA kernels with no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k3_k4_kernels_match_plain_on_card(setup, dtype, tol, g):
    _need_card()
    pre = _port_precond(_jax_precond(setup, g), device="cuda", dtype=dtype)
    ns, gs = fp.fused_shape(pre, setup["st"].n_pad)
    alpha, vecs = _tail_inputs(ns * gs, device="cuda", dtype=dtype)
    args = [v.view(ns, gs) for v in vecs]
    before = dict(cuda_build.launch_counts)
    k3 = fp.agg_smooth_restrict(alpha, *args, pre.inv_agg)
    ref3 = fp._agg_smooth_restrict_plain(alpha, *args, pre.inv_agg)
    k4 = fp.coarse_prolong_dot(pre.coarse_inv, ref3[3], ref3[2], ref3[1])
    ref4 = fp._coarse_prolong_dot_plain(pre.coarse_inv, ref3[3], ref3[2], ref3[1])
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["agg_smooth_restrict"] == before["agg_smooth_restrict"] + 1
    assert cuda_build.launch_counts["coarse_prolong_dot"] == before["coarse_prolong_dot"] + 1
    for ours, ref in zip(k3 + k4, ref3 + ref4):
        assert _rel(ours.cpu(), ref.cpu()) <= tol
    # bitwise repeatable: rz is summed in a fixed order, with no atomics
    again = fp.coarse_prolong_dot(pre.coarse_inv, ref3[3], ref3[2], ref3[1])
    assert all(torch.equal(a, b) for a, b in zip(again, k4))


@pytest.mark.cuda
def test_graphed_fused_loop_matches_stock_on_card(setup):
    _need_card()
    fused = bench.make_fused_pcg(_port_basis(setup["jm"], "cuda"))
    xs, _ = fused.run_stock(ITERS)
    xf, _ = fused.run_fused(ITERS)
    x_ref, _ = setup["fused"].run_stock(ITERS)
    assert _rel(xf.cpu(), xs.cpu()) <= 1e-10
    assert _rel(xs.cpu(), x_ref) <= 1e-10
