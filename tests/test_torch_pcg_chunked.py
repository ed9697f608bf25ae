"""PyTorch port, ``ops/solvers.py:pcg_chunked``: PCG with the stop test and
the iteration count on the device, issued in chunks of k iterations with
one host read a chunk.

On the CPU the chunked loop runs eagerly and is held against the host loop
``pcg``: the same iteration count (a Python int), x within 1e-12 relative
and the same ``converged``, with point Jacobi, the aggregate-block M and the
rigid-body-mode M, at k = 1, 5 and a k above the count, with ``maxiter``
inside a chunk, with b = 0 and with a NaN in the operator; and it reads the
count once a chunk. Float64 on ``unit_square(n=16)`` P1 and on a
three-component P1 basis on ``unit_cube(3)``. The fused loop
(``ops.fused_pcg.fused_pcg``, the K3/K4 tail as the driver's other step) is
a case of the same tests on the aggregate-block system of the square, where
n_pad = 256 and g = gs = 32: the host loop's count and x, bitwise the same
x at every k, ``maxiter`` inside and at the end of a chunk, one read a
chunk.

On the card (marked ``cuda``): the captured loop of ``bsr_pcg`` gives the
eager chunked loop's counts and x within float32 rounding on a cube and a
fracture network; requests in a row leave the allocator's count where it
was; a traced request records ``fem.pcg.capture`` once inside ``fem.pcg``,
``pcg_graphed_iterations`` equal to its iterations and one count read a
chunk beside the two of ``spd_inverse``.
"""

import math

import pytest
import torch

import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu_torch.ops import compiled
from pytorch_fem_solver_tpu_torch.ops.bsr import (
    bsr_diagonal,
    bsr_matvec,
    bsr_reduce,
    default_max_b,
    get_bsr_structure,
)
from pytorch_fem_solver_tpu_torch.ops.fused_pcg import fused_pcg, fused_shape
from pytorch_fem_solver_tpu_torch.ops.solvers import PCGGraphs, pcg, pcg_chunked
from pytorch_fem_solver_tpu_torch.utils.profiling import read, recorded, reset

torch.set_num_threads(1)

CPU = [torch.profiler.ProfilerActivity.CPU]


def a_form(b):
    return b.v_grad @ b.v_grad.mT


def l_form(b):
    return b.v


def lame_form(b):
    """2 mu eps(u):eps(v) + lambda div u div v with mu = 1, lambda = 2."""
    g = b.v_grad
    eps = 0.5 * (g + g.transpose(-1, -2))
    div = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
    return 2.0 * torch.einsum("...icd,...jcd->...ij", eps, eps) + 2.0 * div[..., :, None] * div[..., None, :]


def body_load(b):
    return (torch.tensor([0.5, -1.0, 1.0], dtype=b.v.dtype, device=b.v.device) * b.v).sum(
        -1, keepdim=True)


class System:
    """The padded reduced system of a basis and a preconditioner of it:
    ``matvec``, ``b``, the diagonal and M (None for point Jacobi)."""

    def __init__(self, basis, form, load, precondition):
        st = get_bsr_structure(basis, max_b=default_max_b(basis), want_entry_slot=False)
        values, _ = compiled._assemble_symmetric(basis, st, form, None)
        self.matvec = lambda v: bsr_matvec(st, values, v)  # noqa: E731
        self.b = bsr_reduce(st, basis.integrate_linear_form(load))
        self.diag = bsr_diagonal(st, values)
        setup = compiled.preconditioner_setup(st, precondition, basis)
        self.precond = None if setup is None else setup(values, self.diag)


@pytest.fixture(scope="module")
def systems():
    mesh = pt.MeshTri(pt.unit_square(n=16), device="cpu", dtype=torch.float64)
    scalar = pt.Basis(mesh, pt.ElementTri(1, 2))
    cube = pt.MeshTet(pt.unit_cube(3), device="cpu", dtype=torch.float64)
    vector = pt.VectorBasis(cube, pt.ElementTet(1, 2))
    aggblock = System(scalar, a_form, l_form, "auto")
    return {
        "jacobi": System(scalar, a_form, l_form, "jacobi"),
        "aggblock": aggblock,
        "rbm": System(vector, lame_form, body_load, "auto"),
        "fused": aggblock,
    }


def _chunked(system, precondition, chunk, tol=1e-10, maxiter=None, matvec=None, b=None):
    """``pcg_chunked``'s ``(x, info)``, or ``fused_pcg``'s for the
    ``"fused"`` case."""
    matvec = system.matvec if matvec is None else matvec
    b = system.b if b is None else b
    if precondition == "fused":
        return fused_pcg(matvec, b, system.precond, tol=tol, maxiter=maxiter, chunk=chunk)
    return pcg_chunked(matvec, b, precond_diag=system.diag, precond=system.precond, tol=tol,
                       maxiter=maxiter, chunk=chunk)


def _both(system, chunk, tol=1e-10, maxiter=None, matvec=None, b=None,
          precondition="stock"):
    """(pcg's, the chunked loop's) ``(x, info)`` on one system; ``matvec``
    a factory called once per loop (a fresh one for each)."""
    ref = pcg(system.matvec if matvec is None else matvec(), system.b if b is None else b,
              precond_diag=system.diag, precond=system.precond, tol=tol, maxiter=maxiter)
    got = _chunked(system, precondition, chunk, tol=tol, maxiter=maxiter,
                   matvec=None if matvec is None else matvec(), b=b)
    return ref, got


def _agree(ref, got):
    (x0, i0), (x1, i1) = ref, got
    assert type(i1.iterations) is int and i1.iterations == i0.iterations
    assert bool(i1.converged) == bool(i0.converged)
    assert torch.equal(torch.isnan(x1), torch.isnan(x0))
    fin = ~torch.isnan(x0)
    scale = float(x0[fin].norm()) if bool(fin.any()) else 0.0
    assert float((x1[fin] - x0[fin]).norm()) <= 1e-12 * scale


def test_the_fused_case_takes_the_fused_tail(systems):
    system = systems["fused"]
    assert system.b.shape[0] == 256
    assert fused_shape(system.precond, 256) == (8, 32) and system.precond.g == 32


@pytest.mark.parametrize("precondition", ["jacobi", "aggblock", "rbm", "fused"])
@pytest.mark.parametrize("chunk", [1, 5, "above"])
def test_chunked_matches_pcg(systems, precondition, chunk):
    system = systems[precondition]
    ref = pcg(system.matvec, system.b, precond_diag=system.diag, precond=system.precond,
              tol=1e-10)
    assert ref[1].iterations > 3 and bool(ref[1].converged)
    k = ref[1].iterations + 3 if chunk == "above" else chunk
    got = _chunked(system, precondition, k)
    _agree(ref, got)
    # the held iterations leave x as it was: every k gives the same bits
    assert torch.equal(got[0], _chunked(system, precondition, 1)[0])


@pytest.mark.parametrize("precondition", ["jacobi", "rbm", "fused"])
@pytest.mark.parametrize("maxiter", [7, 10])
def test_maxiter_inside_and_at_the_end_of_a_chunk(systems, precondition, maxiter):
    ref, got = _both(systems[precondition], 5, tol=1e-14, maxiter=maxiter,
                     precondition=precondition)
    assert ref[1].iterations == maxiter and not bool(ref[1].converged)
    _agree(ref, got)


@pytest.mark.parametrize("precondition", ["jacobi", "aggblock"])
def test_zero_load_takes_no_iteration(systems, precondition):
    system = systems[precondition]
    ref, got = _both(system, 5, b=torch.zeros_like(system.b))
    assert ref[1].iterations == 0 and bool(ref[1].converged)
    _agree(ref, got)
    assert not bool(got[0].any())


@pytest.mark.parametrize("turns_nan_at", [1, 5])
def test_nan_in_the_operator_stops_both_alike(systems, turns_nan_at):
    """From the first product (a NaN entry) or the fifth on, the operator
    gives NaN: both loops stop there, unconverged, at one count."""
    system = systems["aggblock"]

    def matvec():
        calls = [0]

        def apply(v):
            calls[0] += 1
            y = system.matvec(v)
            if calls[0] >= turns_nan_at:
                y = y.clone()
                y[3] = math.nan
            return y

        return apply

    ref, got = _both(system, 5, matvec=matvec)
    assert ref[1].iterations == turns_nan_at - 1 and not bool(ref[1].converged)
    _agree(ref, got)


@pytest.mark.parametrize("precondition", ["jacobi", "fused"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_one_read_a_chunk(systems, precondition, chunk):
    system = systems[precondition]
    reset()
    with torch.profiler.profile(activities=CPU):
        _, info = _chunked(system, precondition, chunk)
    rec = recorded()
    # the count is read after each chunk until it falls short of the issued
    assert rec.counters == {"host_reads": info.iterations // chunk + 1}
    assert [s.name for s in rec.spans if s.name != "fem.host_read"] == ["fem.pcg"]


def test_chunk_below_one_raises(systems):
    system = systems["jacobi"]
    with pytest.raises(ValueError, match="chunk"):
        pcg_chunked(system.matvec, system.b, chunk=0)


def test_read_waits_for_its_event_first():
    order = []

    class Event:
        def synchronize(self):
            order.append("wait")

    class Word:
        def item(self):
            order.append("item")
            return 7

    assert read(Word(), after=Event()) == 7 and order == ["wait", "item"]
    order.clear()
    with torch.profiler.profile(activities=CPU):
        assert read(Word(), after=Event()) == 7
    assert order == ["wait", "item"]


def test_bsr_pcg_keeps_the_host_loop_on_the_cpu(systems, monkeypatch):
    """Off the card ``bsr_pcg`` runs ``pcg`` and makes no graphs."""
    def refuse(*args, **kwargs):
        raise AssertionError("pcg_chunked on the CPU")

    monkeypatch.setattr(compiled, "pcg_chunked", refuse)
    mesh = pt.MeshTri(pt.unit_square(n=8), device="cpu", dtype=torch.float64)
    _, info = pt.Basis(mesh, pt.ElementTri(1, 2)).compiled_solver(a_form, l_form)()
    assert bool(info.converged)


# -- on the card ----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured CUDA graph and K2")


def _card_basis(kind):
    if kind == "cube":
        mesh = pt.MeshTet(pt.unit_cube(16), device="cuda", dtype=torch.float32)
        return pt.Basis(mesh, pt.ElementTet(1, 2))
    from pytorch_fem_solver_tpu_torch.bench import benchmark_basis

    return benchmark_basis(pt.build_benchmark_network(0.1, device="cuda", dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cube", "network"])
@pytest.mark.parametrize("chunk", [1, 8])
def test_captured_loop_matches_the_eager_one(kind, chunk):
    _card()
    system = System(_card_basis(kind), a_form, l_form, "auto")
    graphs = PCGGraphs(system.b.device)
    runs = [pcg_chunked(system.matvec, system.b, precond_diag=system.diag,
                        precond=system.precond, tol=1e-6, chunk=chunk, graphs=g)
            for g in (None, graphs, graphs)]  # eager, captured twice (one warm-up)
    (x0, i0) = runs[0]
    for x1, i1 in runs[1:]:
        assert type(i1.iterations) is int and i1.iterations == i0.iterations > 0
        assert bool(i1.converged) and bool(i0.converged)
        assert float((x1 - x0).norm() / x0.norm()) <= 1e-5


@pytest.mark.cuda
def test_requests_in_a_row_leave_the_allocation_as_it_was():
    _card()
    solve = _card_basis("cube").compiled_solver(a_form, l_form, tol=1e-6)
    solve()  # the first request warms the solver's side stream up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(5):
        u, info = solve()
        assert bool(info.converged)
        del u, info
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
def test_a_traced_request_records_the_capture():
    _card()
    solve = _card_basis("cube").compiled_solver(a_form, l_form, tol=1e-6)
    solve()
    torch.cuda.synchronize()
    reset()
    with torch.profiler.profile(activities=CPU):
        _, info = solve()
        torch.cuda.synchronize()
    rec = recorded()
    at = {s.name: k for k, s in enumerate(rec.spans) if s.name != "fem.host_read"}
    captures = [s for s in rec.spans if s.name == "fem.pcg.capture"]
    assert len(captures) == 1 and captures[0].parent == at["fem.pcg"]
    assert rec.counters["pcg_graphed_iterations"] == info.iterations > 0
    reads = [s for s in rec.spans if s.name == "fem.host_read"]
    chunks = sum(s.parent == at["fem.pcg"] for s in reads)
    assert chunks == info.iterations // compiled.PCG_CHUNK + 1
    assert rec.counters["host_reads"] == chunks + 2  # and spd_inverse's two
