"""PyTorch port, the scatter-add K8 (``csrc/pair_scatter.cu``) behind
``ops/bsr.py``: ``bsr_add_pairs_symmetric``, the canonical-pair scatter of
the symmetric assembly, and ``_scatter_drop``, the flat scatter of the load
and of every other drop-mode scatter.

On the CPU both wrappers keep the stock path, and the pair scatter equals
bitwise what it computed before K8 (``_stock``: the pairs copied out, the
diagonal halved, added with ``index_add_``), at n_loc = 3, 4, 10, 12, 20 and
33, into a new buffer and into one passed in; they count ``scatter_values``
and no ``scatter_kernel_values``, and launch nothing. The pair scatter
refuses element matrices that are not square and slots or a buffer of the
wrong length, before any launch. The pair kernel's index arithmetic (its
(i, j) table, and each thread's walk with the cell and local pair carried
by the stride's own step) is replayed in NumPy: every pair once, at the
cell and pair it belongs to. ``PAIR_SCATTER_MAX_LOC`` is the largest n_loc
whose table of int64 offsets fits the 227 KiB a CTA may hold.

On a card (``cuda`` marker) K8 is held against the same stock path run in
float64 on the CPU: seeded element matrices and slot tables in which half
the pairs fall on 8 hot slots (hundreds of adds a slot), with a sink share
of 10 % and of 100 %, at the n_loc above, float32 and float64, int32 and
int64 slots; element matrices read through their strides (a transposed
view); an empty run; two chunk views of one slot table with an offset,
summed in one buffer; the flat scatter of a strided load; and
``bsr_values_from_local_symmetric`` of a vector P1 Lame form on
``kuhn_cube(8)``. Float64 within 1e-12 of each slot's sum of absolute
terms: the same sum in another order. Float32 within m eps32 of it, m the
largest number of adds into one slot: the bound of a float sum of m terms
in any order, which the atomics' order may take (after the mirror
completion, m + 1 adds). The sink slot stays exactly 0, each call is one
launch, and under a profiler session ``scatter_kernel_values`` equals
``scatter_values``. Tables above the default 48 KiB of shared memory
(n_loc 120 and the limit, 240) take the same checks. The card launches K8
or raises, before any launch: above the limit, for tensors that need a
gradient, for other dtypes, for slots or a buffer on another device, for
a buffer that is not contiguous and for flat values that are not 1-D;
slots that are not contiguous are copied.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu_torch as pt
from fem_bench.meshes.kuhn_cube import kuhn_cube
from pytorch_fem_solver_tpu_torch.ops import bsr as pb
from pytorch_fem_solver_tpu_torch.ops import cuda_build
from pytorch_fem_solver_tpu_torch.utils.profiling import recorded, reset

torch.set_num_threads(1)

N_LOC = [3, 4, 10, 12, 20]
ABOVE = pb.PAIR_SCATTER_MAX_LOC + 1
LARGE = [60, 120, pb.PAIR_SCATTER_MAX_LOC]  # vector P3 on tets, and tables above 48 KiB
CELLS = 300
N_VALUES = 640
HOT = 8  # the hot slots that half the pairs land on
EPS32 = float(np.finfo(np.float32).eps)
SKIP = "needs an NVIDIA GPU: K8 is a CUDA kernel with no CPU mode"


def _pairs(n_loc):
    return n_loc * (n_loc + 1) // 2


def _case(n_loc, sink_share=0.1, cells=CELLS, seed=0):
    """Seeded (cells, n_loc, n_loc) float64 element matrices (not
    symmetric, so a transposed view reads other words) and an int64 slot
    table: half the pairs on ``HOT`` slots, a ``sink_share`` of them on the
    sink ``N_VALUES``."""
    rng = np.random.default_rng(1000 * n_loc + seed)
    local = torch.from_numpy(rng.standard_normal((cells, n_loc, n_loc)))
    n = cells * _pairs(n_loc)
    slots = np.where(rng.random(n) < 0.5, rng.integers(0, HOT, n), rng.integers(0, N_VALUES, n))
    slots[rng.random(n) < sink_share] = N_VALUES
    return local, torch.from_numpy(slots)


def _stock(values, slots, local):
    """The pair scatter as it was before K8, on any device."""
    n_loc = local.shape[-1]
    iu, ju = torch.triu_indices(n_loc, n_loc, device=local.device)
    w = torch.where(iu == ju, 0.5, 1.0).to(local.dtype)
    pairs = (local[..., iu, ju] * w).reshape(-1)
    if values is None:
        values = pairs.new_zeros(N_VALUES + 1)
    return values.index_add_(0, slots, pairs)


ST = SimpleNamespace(n_values=N_VALUES)  # all the wrapper reads of a structure


def _counted(fn):
    reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, dict(recorded().counters)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_loc", N_LOC + [33])
def test_cpu_keeps_the_stock_path_bitwise(n_loc, dtype):
    local, slots = _case(n_loc)
    local = local.to(dtype)
    before = dict(cuda_build.launch_counts)
    for index in (torch.int32, torch.int64):
        s = slots.to(index)
        out, counters = _counted(lambda: pb.bsr_add_pairs_symmetric(ST, None, s, local))
        assert torch.equal(out, _stock(None, s, local))
        assert counters == {"scatter_values": slots.shape[0]}
        # into a buffer passed in, which it returns
        buf = _stock(None, s, local)
        again = pb.bsr_add_pairs_symmetric(ST, buf, s, local)
        assert again is buf and torch.equal(again, _stock(_stock(None, s, local), s, local))
    assert cuda_build.launch_counts == before  # no kernel launched


def test_cpu_flat_scatter_keeps_index_add():
    data = torch.from_numpy(np.random.default_rng(5).standard_normal((500, 2)))[:, 0]
    slots = torch.from_numpy(np.random.default_rng(6).integers(0, 41, 500))
    out, counters = _counted(lambda: pb._scatter_drop(slots, data, 40))
    assert torch.equal(out, torch.zeros(41, dtype=data.dtype).index_add_(0, slots, data)[:40])
    assert counters == {"scatter_values": 500}


def test_max_loc_is_the_largest_table_a_cta_holds():
    def table_bytes(n):
        return n * (n + 1) // 2 * 8

    assert table_bytes(pb.PAIR_SCATTER_MAX_LOC) <= 227 * 1024 < table_bytes(ABOVE)


@pytest.mark.parametrize("bad", ["not_square", "short_slots", "2d_slots", "short_values"])
def test_refuses_bad_shapes_before_any_launch(bad):
    local, slots = _case(4, cells=10)
    values = None
    if bad == "not_square":
        local = local[..., :3]
    elif bad == "short_slots":
        slots = slots[:-1]
    elif bad == "2d_slots":
        slots = slots.reshape(10, -1)
    else:
        values = torch.zeros(N_VALUES, dtype=local.dtype)
    before = dict(cuda_build.launch_counts)
    with pytest.raises(ValueError):
        pb.bsr_add_pairs_symmetric(ST, values, slots, local)
    assert cuda_build.launch_counts == before


def _k8_walk(n_loc, n_pairs, grid, threads=256, unroll=4):
    """K8's pair kernel replayed in NumPy: each CTA's (i, j) table, then each
    thread's walk over p with (c, q) carried by the stride's own step.
    Returns the (p, c, i, j) it visits, one row a visit."""
    P = _pairs(n_loc)
    table = []
    for q in range(P):
        i, r = 0, q
        while r >= n_loc - i:
            r -= n_loc - i
            i += 1
        table.append((i, i + r))
    table = np.array(table)
    stride = grid * threads
    dc, dq = divmod(stride, P)
    p = np.arange(stride)
    c, q = p // P, p % P
    seen = []
    while (p < n_pairs).any():
        for _ in range(unroll):
            live = p < n_pairs
            seen.append(np.stack([p[live], c[live], *table[q[live]].T], axis=1))
            p, c, q = p + stride, c + dc, q + dq
            c, q = c + (q >= P), np.where(q >= P, q - P, q)
    return np.concatenate(seen)


@pytest.mark.parametrize("grid", [1, 2, 7])
@pytest.mark.parametrize("n_loc", [1, 3, 12, 32, pb.PAIR_SCATTER_MAX_LOC])
def test_k8_walk_visits_every_pair_once(n_loc, grid):
    """The kernel's index arithmetic, replayed: every pair once, at cell
    p // P and local pair p % P, in ``np.triu_indices`` order."""
    cells = 41
    seen = _k8_walk(n_loc, cells * _pairs(n_loc), grid)
    order = np.argsort(seen[:, 0])
    p, c, i, j = seen[order].T
    assert np.array_equal(p, np.arange(cells * _pairs(n_loc)))
    iu, ju = np.triu_indices(n_loc)
    assert np.array_equal(c, p // _pairs(n_loc))
    assert np.array_equal(i, iu[p % _pairs(n_loc)]) and np.array_equal(j, ju[p % _pairs(n_loc)])


# -- on the card -----------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip(SKIP)
    return torch.device("cuda")


def _bound(slots, local, n_values=N_VALUES):
    """Each slot's sum of absolute terms (float64, CPU) and the largest
    number of kept adds into one slot."""
    abs_sum = _stock(torch.zeros(n_values + 1, dtype=torch.float64), slots.cpu(),
                     local.double().cpu().abs())
    kept = slots.cpu().long()
    kept = kept[kept < n_values]
    most = int(torch.bincount(kept, minlength=1).max()) if kept.numel() else 0
    return abs_sum, most


def _held(out, ref, abs_sum, most, dtype):
    out, ref = out.double().cpu(), ref.double().cpu()
    rel = 1e-12 if dtype == torch.float64 else most * EPS32
    assert bool(((out - ref).abs() <= rel * abs_sum).all())


def _launched(fn, key="pair_scatter"):
    before = cuda_build.launch_counts[key]
    out = fn()
    torch.cuda.synchronize()
    return out, cuda_build.launch_counts[key] - before


@pytest.mark.cuda
@pytest.mark.parametrize("index", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sink_share", [0.1, 1.0])
@pytest.mark.parametrize("n_loc", N_LOC)
def test_k8_matches_stock_on_card(n_loc, sink_share, dtype, index):
    dev = _card()
    local64, slots = _case(n_loc, sink_share)
    local, s = local64.to(dev, dtype), slots.to(dev, index)
    (out, counters), launches = _launched(
        lambda: _counted(lambda: pb.bsr_add_pairs_symmetric(ST, None, s, local)))
    assert launches == 1 and out.dtype == dtype and out.shape == (N_VALUES + 1,)
    assert counters == {"scatter_values": slots.shape[0], "scatter_kernel_values": slots.shape[0]}
    assert float(out[N_VALUES]) == 0.0  # the sink is skipped
    ref = _stock(None, slots, local.double().cpu())
    ref[N_VALUES] = 0.0
    _held(out, ref, *_bound(slots, local), dtype)
    if sink_share == 1.0:
        assert not bool(out.any())
    # the element matrices read through their strides: a transposed view
    view = local.mT
    assert not view.is_contiguous()
    out, launches = _launched(lambda: pb.bsr_add_pairs_symmetric(ST, None, s, view))
    ref = _stock(None, slots, view.double().cpu())
    ref[N_VALUES] = 0.0
    assert launches == 1
    _held(out, ref, *_bound(slots, view), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_loc", LARGE)
def test_large_tables_on_card(n_loc, dtype):
    """Tables of 14 KiB, 57 KiB and 226 KiB: the two larger launch with
    more than the default 48 KiB of shared memory a CTA."""
    dev = _card()
    local64, slots = _case(n_loc, cells=6)
    local, s = local64.to(dev, dtype), slots.to(dev, torch.int32)
    out, launches = _launched(lambda: pb.bsr_add_pairs_symmetric(ST, None, s, local))
    assert launches == 1 and float(out[N_VALUES]) == 0.0
    ref = _stock(None, slots, local.double().cpu())
    ref[N_VALUES] = 0.0
    _held(out, ref, *_bound(slots, local), dtype)


def _refused(error, fn):
    before = dict(cuda_build.launch_counts)
    with pytest.raises(error):
        fn()
    assert cuda_build.launch_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_above_the_limit_raises_on_card(dtype):
    dev = _card()
    local64, slots = _case(ABOVE, cells=2)
    local, s = local64.to(dev, dtype), slots.to(dev, torch.int32)
    _refused(ValueError, lambda: pb.bsr_add_pairs_symmetric(ST, None, s, local))


@pytest.mark.cuda
def test_a_gradient_raises_on_card():
    """K8 adds outside autograd: element matrices or loads that need a
    gradient raise, and take K8 under ``torch.no_grad()``."""
    dev = _card()
    local64, slots = _case(4, cells=20)
    local = local64.to(dev).requires_grad_()
    s = slots.to(dev)
    _refused(RuntimeError, lambda: pb.bsr_add_pairs_symmetric(ST, None, s, local))
    data = local64[:, 0, 0].to(dev).requires_grad_()
    _refused(RuntimeError, lambda: pb._scatter_drop(s[:20], data, N_VALUES))
    with torch.no_grad():
        _, launches = _launched(lambda: pb.bsr_add_pairs_symmetric(ST, None, s, local))
        assert launches == 1
        _, launches = _launched(lambda: pb._scatter_drop(s[:20], data, N_VALUES), "flat_scatter")
        assert launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float16", "int16_slots", "cpu_slots", "cpu_values",
                                 "strided_values", "2d_flat", "flat_cpu_slots"])
def test_refuses_what_k8_cannot_take_on_card(bad):
    dev = _card()
    local64, slots = _case(4, cells=10)
    local, s, values = local64.to(dev), slots.to(dev), None
    fn, error = None, ValueError
    if bad == "float16":
        local, error = local.half(), TypeError
    elif bad == "int16_slots":
        s, error = s.to(torch.int16), TypeError
    elif bad == "cpu_slots":
        s = slots
    elif bad == "cpu_values":
        values = torch.zeros(N_VALUES + 1, dtype=local.dtype)
    elif bad == "strided_values":
        values = torch.zeros(2 * (N_VALUES + 1), dtype=local.dtype, device=dev)[::2]
    elif bad == "2d_flat":
        fn = lambda: pb._scatter_drop(s[:20], local[:10, 0, :2], N_VALUES)  # noqa: E731
    else:
        fn = lambda: pb._scatter_drop(slots[:10], local[:, 0, 0], N_VALUES)  # noqa: E731
    _refused(error, fn or (lambda: pb.bsr_add_pairs_symmetric(ST, values, s, local)))


@pytest.mark.cuda
def test_strided_slots_are_copied_on_card():
    dev = _card()
    local64, slots = _case(12, cells=40)
    local = local64.to(dev, torch.float64)
    s = torch.stack([slots, slots], 1).to(dev, torch.int32)[:, 0]
    assert not s.is_contiguous()
    out, launches = _launched(lambda: pb.bsr_add_pairs_symmetric(ST, None, s, local))
    ref = _stock(None, slots, local.cpu())
    ref[N_VALUES] = 0.0
    assert launches == 1
    _held(out, ref, *_bound(slots, local), torch.float64)


@pytest.mark.cuda
def test_empty_run_and_chunk_views_on_card():
    dev = _card()
    n_loc, cells = 12, 200
    local64, slots = _case(n_loc, cells=cells)
    local, s = local64.to(dev, torch.float32), slots.to(dev, torch.int32)
    # an empty run: no launch, the buffer as it came
    (out, counters), launches = _launched(
        lambda: _counted(lambda: pb.bsr_add_pairs_symmetric(ST, None, s[:0], local[:0])))
    assert launches == 0 and not bool(out.any())
    assert counters == {"scatter_values": 0, "scatter_kernel_values": 0}
    # two chunk views of one slot table, the second at an offset, in one buffer
    cut, P = 77, _pairs(n_loc)
    views = [(local[:cut], s[: cut * P]), (local[cut:], s[cut * P:])]
    assert views[1][1].storage_offset() == cut * P
    buf = None
    for chunk, view in views:
        buf, launches = _launched(
            lambda chunk=chunk, view=view, buf=buf: pb.bsr_add_pairs_symmetric(ST, buf, view, chunk))
        assert launches == 1
    ref = _stock(None, slots, local.double().cpu())
    ref[N_VALUES] = 0.0
    assert float(buf[N_VALUES]) == 0.0
    _held(buf, ref, *_bound(slots, local), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flat_scatter_on_card(dtype):
    dev = _card()
    rng = np.random.default_rng(9)
    n, size = 5_000, 300
    data = torch.from_numpy(rng.standard_normal((n, 3))).to(dev, dtype)[:, 1]  # strided
    slots = torch.from_numpy(np.where(rng.random(n) < 0.5, rng.integers(0, 4, n),
                                      rng.integers(0, size + 1, n)))
    (out, counters), launches = _launched(
        lambda: _counted(lambda: pb._scatter_drop(slots.to(dev), data, size)), "flat_scatter")
    assert launches == 1 and out.shape == (size,)
    assert counters == {"scatter_values": n, "scatter_kernel_values": n}
    ref = torch.zeros(size + 1, dtype=torch.float64).index_add_(0, slots, data.double().cpu())
    abs_sum = torch.zeros(size + 1, dtype=torch.float64).index_add_(
        0, slots, data.double().cpu().abs())
    most = int(torch.bincount(slots[slots < size]).max())
    _held(out, ref[:size], abs_sum[:size], most, dtype)


def lame_form(b):
    """2 mu eps(u):eps(v) + lambda div u div v with mu = 1, lambda = 2."""
    g = b.v_grad
    eps = 0.5 * (g + g.transpose(-1, -2))
    div = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
    return (2.0 * torch.einsum("...icd,...jcd->...ij", eps, eps)
            + 2.0 * div[..., :, None] * div[..., None, :])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vector_p1_values_on_card(dtype):
    """``bsr_values_from_local_symmetric`` of vector P1 on ``kuhn_cube(8)``
    (n_loc 12) through K8, against the stock path in float64 on the CPU."""
    dev = _card()
    vertices, tets = kuhn_cube(8)
    bases = {d: pt.VectorBasis(pt.MeshTet({"vertices": vertices, "tetrahedra": tets}, device=d,
                                          dtype=torch.float64), pt.ElementTet(1, 2))
             for d in ("cpu", dev)}
    sts = {d: pb.get_bsr_structure(V, max_b=24, want_entry_slot=False)
           for d, V in bases.items()}
    local = bases[dev].integrate_bilinear_form_local(lame_form).to(dtype)
    assert local.shape[-1] == 12
    ref = pb.bsr_values_from_local_symmetric(sts["cpu"], local.double().cpu())
    st = sts["cpu"]
    abs_buf = pb.bsr_add_pairs_symmetric(st, None, st.entry_slot_sym, local.double().cpu().abs())
    abs_full = pb.bsr_complete_symmetric(st, abs_buf[: st.n_values])
    kept = st.entry_slot_sym.long()
    most = int(torch.bincount(kept[kept < st.n_values]).max())
    out, launches = _launched(lambda: pb.bsr_values_from_local_symmetric(sts[dev], local))
    assert launches == 1
    for o, r, a in zip(out, ref, abs_full):
        o, r = o.double().cpu(), r.double()
        rel = 1e-12 if dtype == torch.float64 else (most + 1) * EPS32
        assert bool(((o - r).abs() <= rel * a).all())
