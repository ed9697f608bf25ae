"""PyTorch port, the recorder of ``utils/profiling.py`` on the solve path.

Without a profiler session a solve records nothing and costs its sites one
flag read each. Under ``torch.profiler.profile`` a ``compiled_solver`` solve
records ``fem.solve`` with ``fem.assemble``, ``fem.precond_setup`` and
``fem.pcg`` inside it, all under one request id; inside ``fem.assemble``
one ``fem.assemble.local`` and ``fem.assemble.scatter`` pair per run of
cells, inside ``fem.precond_setup`` the M's ``.galerkin``,
``.coarse_inverse`` and ``.smoother``; one ``fem.host_read`` per blocking
read: the stop test's ``iterations + 1`` inside ``fem.pcg`` and the two of
``spd_inverse`` inside the coarse inverse; the counter ``coarse_rows``
of the M's coarse size, and ``scatter_values`` of the canonical pairs and
element loads the assembly scatters. The answers are bitwise those of an unrecorded
solve. The spans are stamped on the clock of the profiler's own events.
A ``compiled_eigsh`` solve records ``fem.solve`` with a ``fem.assemble``
(one ``.local`` / ``.scatter`` pair per form) and ``fem.precond_setup``
as a linear solve does, and ``fem.eigsh`` with the eigensolver's block
products, preconditioner applications and Rayleigh-Ritz steps inside, its
stop tests as reads, and the counters of its rounds, products and columns.
Float64 on ``unit_square(n=16)``, P1, and for the rigid-body-mode M a
three-component P1 basis on ``unit_cube(3)``, on the CPU; the spans' CUDA
event pairs on the card.
"""

import collections
import time

import pytest
import torch
import torch.autograd.profiler as autograd_profiler

import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu_torch.ops.solvers import pcg
from pytorch_fem_solver_tpu_torch.utils import profiling
from pytorch_fem_solver_tpu_torch.utils.profiling import Span, read, recorded, reset, span

torch.set_num_threads(1)

CPU = [torch.profiler.ProfilerActivity.CPU]
REQUEST_SPANS = ("fem.solve", "fem.assemble", "fem.precond_setup", "fem.pcg")
#: the spans inside ``fem.assemble`` and ``fem.precond_setup``, by parent
INNER = {
    "fem.assemble": ("fem.assemble.local", "fem.assemble.scatter"),
    "fem.precond_setup": ("fem.precond_setup.galerkin", "fem.precond_setup.coarse_inverse",
                          "fem.precond_setup.smoother"),
}
#: a request's spans but its reads, in the order they open
ORDER = ("fem.solve", "fem.assemble", *INNER["fem.assemble"], "fem.precond_setup",
         *INNER["fem.precond_setup"], "fem.pcg")


def a_form(b):
    return b.v_grad @ b.v_grad.mT


def l_form(b):
    return b.v


def lame_form(b):
    """2 mu eps(u):eps(v) + lambda div u div v with mu = 1, lambda = 2."""
    g = b.v_grad  # (T, 1|q, n, c, d)
    eps = 0.5 * (g + g.transpose(-1, -2))
    div = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
    return 2.0 * torch.einsum("...icd,...jcd->...ij", eps, eps) + 2.0 * div[..., :, None] * div[..., None, :]


def body_load(b):
    return (torch.tensor([0.5, -1.0, 1.0], dtype=b.v.dtype, device=b.v.device) * b.v).sum(
        -1, keepdim=True)


@pytest.fixture(scope="module")
def basis():
    mesh = pt.MeshTri(pt.unit_square(n=16), device="cpu", dtype=torch.float64)
    return pt.Basis(mesh, pt.ElementTri(1, 2))


@pytest.fixture(scope="module")
def vector_basis():
    mesh = pt.MeshTet(pt.unit_cube(3), device="cpu", dtype=torch.float64)
    return pt.VectorBasis(mesh, pt.ElementTet(1, 2))


def _solver(basis, **kwargs):
    if getattr(basis, "n_components", 1) > 1:
        return basis.compiled_solver(lame_form, body_load, tol=1e-10, **kwargs)
    return basis.compiled_solver(a_form, l_form, tol=1e-10, **kwargs)


def _coarse_size(basis):
    """The coarse size the M of ``"auto"`` sets up: n_pad / g of the
    aggregate-block M, na m of the rigid-body-mode one."""
    st = pt.ops.bsr.get_bsr_structure(basis, max_b=pt.ops.bsr.default_max_b(basis),
                                      want_entry_slot=False)
    if getattr(basis, "n_components", 1) > 1:
        ast = pt.ops.precondition.get_affine_two_level_structure(basis, st, rbm=True)
        return ast.na * ast.m
    return st.n_pad // pt.ops.precondition.default_aggregate_size(st)


def _scattered(basis):
    """The values a solve scatters: one a canonical pair of every cell, and
    the element loads of the flat load layout (n_loc a cell). On the CPU
    they all take ``index_add_``, so no ``scatter_kernel_values``."""
    st = pt.ops.bsr.get_bsr_structure(basis, max_b=pt.ops.bsr.default_max_b(basis),
                                      want_entry_slot=False)
    return st.entry_slot_sym.shape[0] + basis._global_dofs4elements.numel()


def _by_name(spans, name):
    return [(k, s) for k, s in enumerate(spans) if s.name == name]


def test_profiler_flag_follows_the_session():
    assert not autograd_profiler._is_profiler_enabled
    prof = torch.profiler.profile(activities=CPU)
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled
    finally:
        prof.stop()
    assert not autograd_profiler._is_profiler_enabled


def test_no_session_records_no_request(basis):
    reset()
    solve = _solver(basis)
    built = recorded()
    # construction is recorded always, and only construction
    assert {s.name for s in built.spans} == {
        "fem.tables.solver", "fem.tables.bsr", "fem.tables.precond"}
    assert all(s.request is None for s in built.spans) and built.counters == {}
    for _ in range(3):
        solve()
    after = recorded()
    assert after.spans == built.spans and after.counters == {}
    assert span("fem.solve") is span("fem.pcg")  # the shared no-op
    assert read(torch.tensor(3)) == 3 and read(torch.tensor(True)) is True
    assert recorded().counters == {}


def test_tables_spans_nest(basis):
    reset()
    basis._bsr_structures = {}  # the layout is built anew, inside the solver's span
    _solver(basis)
    spans = recorded().spans
    (top, solver), = _by_name(spans, "fem.tables.solver")
    assert solver.parent is None and solver.end_ns >= solver.start_ns
    for name in ("fem.tables.bsr", "fem.tables.precond"):
        (_, child), = _by_name(spans, name)
        assert child.parent == top
        assert solver.start_ns <= child.start_ns <= child.end_ns <= solver.end_ns


@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_spans_nest_under_one_request_per_solve(request, kind):
    basis = request.getfixturevalue("basis" if kind == "scalar" else "vector_basis")
    solve = _solver(basis)
    reset()
    with torch.profiler.profile(activities=CPU):
        infos = [solve()[1] for _ in range(2)]
    rec = recorded()
    solves = _by_name(rec.spans, "fem.solve")
    assert len(solves) == 2 and all(s.parent is None for _, s in solves)
    assert solves[1][1].request == solves[0][1].request + 1
    for (top, outer), info in zip(solves, infos):
        mine = [(k, s) for k, s in enumerate(rec.spans) if s.request == outer.request]
        assert [s.name for _, s in mine if s.name != "fem.host_read"] == list(ORDER)
        at = {s.name: k for k, s in mine if s.name != "fem.host_read"}
        for k, s in mine[1:]:
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
            if s.name in REQUEST_SPANS:
                assert s.parent == top, s.name
        for parent, names in INNER.items():
            for name in names:
                child, host = rec.spans[at[name]], rec.spans[at[parent]]
                assert child.parent == at[parent], name
                assert host.start_ns <= child.start_ns <= child.end_ns <= host.end_ns, name
        reads = [s for _, s in mine if s.name == "fem.host_read"]
        # the stop test's reads in the loop, spd_inverse's two in the coarse inverse
        assert sum(s.parent == at["fem.pcg"] for s in reads) == info.iterations + 1
        assert sum(s.parent == at["fem.precond_setup.coarse_inverse"] for s in reads) == 2
        assert len(reads) == info.iterations + 3
    assert rec.counters == {"host_reads": sum(i.iterations + 3 for i in infos),
                            "coarse_rows": 2 * _coarse_size(basis),
                            "scatter_values": 2 * _scattered(basis)}
    assert all(s.device_ms is None for s in rec.spans)  # no CUDA events on the CPU


@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_coarse_rows_counts_the_coarse_size(request, kind):
    basis = request.getfixturevalue("basis" if kind == "scalar" else "vector_basis")
    solve = _solver(basis)
    reset()
    with torch.profiler.profile(activities=CPU):
        solve()
    n = _coarse_size(basis)
    if kind == "vector":  # the rigid-body modes: 1 + 2 translations + 3 rotations
        st = pt.ops.bsr.get_bsr_structure(basis, max_b=pt.ops.bsr.default_max_b(basis),
                                          want_entry_slot=False)
        ast = pt.ops.precondition.get_affine_two_level_structure(basis, st, rbm=True)
        assert ast.m == 6 and n == ast.na * 6
    assert recorded().counters["coarse_rows"] == n > 0


def test_chunked_assembly_records_a_pair_per_chunk(basis):
    solve = _solver(basis, chunk_cells=100)
    n_chunks = -(-int(basis.v_grad.shape[0]) // 100)
    assert n_chunks > 2
    reset()
    with torch.profiler.profile(activities=CPU):
        solve()
    spans = recorded().spans
    (top, _), = _by_name(spans, "fem.assemble")
    pairs = [s.name for s in spans if s.name.startswith("fem.assemble.")]
    assert pairs == ["fem.assemble.local", "fem.assemble.scatter"] * n_chunks
    assert all(s.parent == top for s in spans if s.name.startswith("fem.assemble."))


@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_no_session_records_no_inner_span(request, kind):
    basis = request.getfixturevalue("basis" if kind == "scalar" else "vector_basis")
    solve = _solver(basis)
    reset()
    for _ in range(2):
        solve()
    assert recorded() == ([], {})


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_inner_spans_time_the_card(kind):
    """On the card each span has its CUDA event pair's time, and the inner
    spans' times sum to no more than their parent's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans' CUDA event pairs")
    if kind == "scalar":
        mesh = pt.MeshTri(pt.unit_square(n=64), device="cuda", dtype=torch.float32)
        b = pt.Basis(mesh, pt.ElementTri(1, 2))
    else:
        mesh = pt.MeshTet(pt.unit_cube(8), device="cuda", dtype=torch.float32)
        b = pt.VectorBasis(mesh, pt.ElementTet(1, 2))
    solve = _solver(b)
    solve()
    torch.cuda.synchronize()
    reset()
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            solve()
        torch.cuda.synchronize()
    spans = recorded().spans
    for parent, names in INNER.items():
        for k, host in _by_name(spans, parent):
            inner = [s for s in spans if s.parent == k and s.name in names]
            assert sorted(s.name for s in inner) == sorted(names)
            assert all(s.device_ms is not None and s.device_ms >= 0 for s in inner)
            assert sum(s.device_ms for s in inner) <= host.device_ms


def test_plain_pcg_reads_once_per_iteration_and_once_more():
    n = 40
    a = torch.diag(torch.linspace(1.0, 4.0, n, dtype=torch.float64))
    b = torch.ones(n, dtype=torch.float64)
    reset()
    with torch.profiler.profile(activities=CPU):
        x, info = pcg(lambda v: a @ v, b, tol=1e-12)
    rec = recorded()
    assert info.iterations > 1 and rec.counters == {"host_reads": info.iterations + 1}
    (loop, pcg_span), = _by_name(rec.spans, "fem.pcg")
    assert pcg_span.request is None and pcg_span.parent is None  # no solve around it
    assert all(s.parent == loop for _, s in _by_name(rec.spans, "fem.host_read"))


def test_answers_are_bitwise_unchanged(basis):
    solve = _solver(basis)
    u_off, info_off = solve()
    with torch.profiler.profile(activities=CPU):
        u_on, info_on = solve()
    assert torch.equal(u_on, u_off)
    assert info_on.iterations == info_off.iterations
    assert torch.equal(info_on.residual_norm, info_off.residual_norm)
    assert torch.equal(info_on.converged, info_off.converged)


def test_refined_solve_spans(basis):
    solve = basis.compiled_refined(a_form, l_form, refine=2, tol32=1e-6)
    reset()
    with torch.profiler.profile(activities=CPU):
        _, info = solve()
    rec = recorded()
    names = [s.name for s in rec.spans if s.name != "fem.host_read"]
    assert names == ["fem.solve", "fem.precond_setup", *INNER["fem.precond_setup"],
                     "fem.pcg", "fem.pcg", "fem.pcg"]
    assert rec.counters == {"host_reads": sum(k + 1 for k in info.inner_iterations) + 2,
                            "coarse_rows": _coarse_size(basis)}


def test_span_start_is_on_the_profilers_clock(basis):
    solve = _solver(basis)
    reset()
    prof = torch.profiler.profile(activities=CPU)
    prof.start()
    try:
        solve()
    finally:
        prof.stop()
    kineto = {e.name(): int(e.start_ns()) for e in prof.profiler.kineto_results.events()
              if e.name() in REQUEST_SPANS}
    spans = {s.name: s for s in recorded().spans if s.name in REQUEST_SPANS}
    assert set(kineto) == set(REQUEST_SPANS) == set(spans)
    for name, s in spans.items():
        assert abs(kineto[name] - s.start_ns) <= 1_000_000, name
    # and the stamps are wall-clock ns, not a monotonic clock's
    assert abs(spans["fem.solve"].start_ns - time.time_ns()) < 60e9


def test_spans_open_across_a_reset_are_dropped():
    reset()
    with torch.profiler.profile(activities=CPU):
        with span("fem.solve"):
            reset()
            with span("fem.pcg"):
                pass
    spans = recorded().spans
    assert [s.name for s in spans] == ["fem.pcg"]
    assert spans[0] == Span("fem.pcg", spans[0].request, None, spans[0].start_ns,
                            spans[0].end_ns)


def test_count_records_only_under_a_session():
    reset()
    profiling.count("x", 3)
    assert recorded().counters == {}
    with torch.profiler.profile(activities=CPU):
        profiling.count("x", 3)
        profiling.count("x")
    assert recorded().counters == {"x": 4}


def vector_mass(b):
    return torch.einsum("...ic,...jc->...ij", b.v, b.v)


@pytest.mark.parametrize("method", ["lobpcg", "subspace"])
def test_eigsh_spans_and_counters(vector_basis, method):
    """One ``fem.solve`` per eigensolve, the eigensolver inside it. LOBPCG:
    the seed step's 2 block products (2 m columns) and 5 a round (A X, M X,
    M W, M P, A [W, P]: 6 m columns), one preconditioner application a
    round, the seed step's Rayleigh-Ritz and 3 a round (2 ``whiten``, 1
    ``rr_ortho``); subspace iteration: 3 block products a round (M X, and A
    Y and M Y of its Rayleigh-Ritz). One stop test a round, and one more
    that ends the loop; ``spd_inverse``'s two reads in the M's set-up."""
    k, m = 6, 9
    solve = vector_basis.compiled_eigsh(lame_form, vector_mass, k=k, tol=1e-8, method=method,
                                        solve_tol=1e-8)
    reset()
    with torch.profiler.profile(activities=CPU):
        outs = [solve() for _ in range(2)]
    rec = recorded()
    solves = _by_name(rec.spans, "fem.solve")
    assert len(solves) == 2 and all(s.parent is None for _, s in solves)
    rounds = [info[0] for _, _, info in outs]
    assert all(bool(info[2]) for _, _, info in outs)
    for (top, outer), r in zip(solves, rounds):
        mine = [(j, s) for j, s in enumerate(rec.spans) if s.request == outer.request]
        at = {s.name: j for j, s in mine}
        assert [s.name for _, s in mine if s.parent == top] == [
            "fem.assemble", "fem.precond_setup", "fem.eigsh"]
        assert [s.name for _, s in mine if s.parent == at["fem.assemble"]] == [
            "fem.assemble.local", "fem.assemble.scatter"] * 2
        inner = collections.Counter(s.name for _, s in mine if s.parent == at["fem.eigsh"])
        products, columns = (2 + 5 * r, 2 * m + 6 * m * r) if method == "lobpcg" else (
            3 * r, 3 * m * r)
        assert inner["fem.eigsh.product"] == products
        assert inner["fem.host_read"] == r + 1
        if method == "lobpcg":
            assert inner["fem.eigsh.precond"] == r and inner["fem.eigsh.rr"] == 1 + 3 * r
            assert set(inner) == {"fem.eigsh.product", "fem.eigsh.precond", "fem.eigsh.rr",
                                  "fem.host_read"}
        else:  # the inner solves' PCG loops, their reads inside them
            assert inner["fem.pcg"] == m * r
    per = [(2 + 5 * r, 2 * m + 6 * m * r) if method == "lobpcg" else (3 * r, 3 * m * r)
           for r in rounds]
    c = rec.counters
    assert c["eigsh_rounds"] == sum(rounds)
    assert c["eigsh_products"] == sum(p for p, _ in per)
    assert c["eigsh_product_columns"] == sum(q for _, q in per)
    assert c["coarse_rows"] == 2 * _coarse_size(vector_basis)
    if method == "lobpcg":
        assert c["host_reads"] == sum(r + 1 + 2 for r in rounds)
    assert all(s.device_ms is None for s in rec.spans)


def test_eigsh_records_nothing_without_a_session(vector_basis):
    solve = vector_basis.compiled_eigsh(lame_form, vector_mass, k=6, tol=1e-8)
    reset()
    vals, vecs, _ = solve()
    assert recorded() == ([], {})
    with torch.profiler.profile(activities=CPU):
        vals_on, vecs_on, _ = solve()
    assert torch.equal(vals_on, vals) and torch.equal(vecs_on, vecs)
