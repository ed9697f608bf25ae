"""PyTorch port, ``utils/profiling.py`` and ``utils/vtk.py`` against the JAX
package.

``StepTimer`` keeps the JAX class's keys and counts (``step``, ``time_fn``
with warmup and reps, the empty summary); its sync walks nested results.
``trace()`` yields its directory and writes a Chrome trace there that names
the profiled ops. ``write_vtk`` writes files byte-identical to the JAX
package's for the same float64 arrays, from NumPy arrays and from tensors
alike, in the cases of the JAX package's ``tests/test_export.py``
(triangles with scalar and 2-component vector point data, tetrahedra) and
raises the same ``ValueError``s.
"""

import json

import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.utils import StepTimer as JaxStepTimer
from pytorch_fem_solver_tpu.utils import write_vtk as jax_write_vtk
from pytorch_fem_solver_tpu_torch.utils import StepTimer, trace, write_vtk
from pytorch_fem_solver_tpu_torch.utils.profiling import _tensors

torch.set_num_threads(1)

KEYS = {"count", "median_s", "mean_s", "min_s", "max_s"}


def test_step_timer_keys_and_counts():
    timer = StepTimer()
    assert timer.summary() == {"count": 0} == JaxStepTimer().summary()
    calls = []

    def fn(a, b):
        calls.append(1)
        return {"sum": a + b, "parts": (a, [b])}

    out = timer.time_fn(fn, torch.ones(4), torch.ones(4), warmup=2, reps=3)
    assert len(calls) == 5 and out["count"] == 3 and set(out) == KEYS
    with timer.step((torch.zeros(2), None)):
        pass
    summary = timer.summary()
    assert summary["count"] == 4 and len(timer.times) == 4
    assert summary["min_s"] <= summary["median_s"] <= summary["max_s"]
    ref = JaxStepTimer()
    ref.time_fn(lambda: 1.0, warmup=0, reps=2)
    assert set(ref.summary()) == KEYS


def test_sync_walks_nested_results():
    a, b, c = torch.zeros(1), torch.ones(2), torch.full((3,), 2.0)
    found = list(_tensors({"x": (a, [b, None]), "y": c, "z": 1.0}))
    assert [t.shape for t in found] == [a.shape, b.shape, c.shape]
    StepTimer._sync(None)
    StepTimer._sync((a, {"b": b}))  # CPU tensors need no sync


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as where:
        assert where == str(log_dir)
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    files = list(log_dir.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def _unit_square(n):
    tri = fem.unit_square(n=n)
    return np.asarray(tri["vertices"], dtype=np.float64), np.asarray(tri["triangles"])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_write_vtk_triangles_byte_identical(tmp_path, as_tensor):
    v, t = _unit_square(2)
    u = np.arange(v.shape[0], dtype=float)
    disp = np.stack([u, -u], axis=1)  # 2-component vector, padded to 3
    ref = jax_write_vtk(tmp_path / "ref.vtk", v, t, point_data={"u": u, "disp": disp})
    conv = torch.from_numpy if as_tensor else np.asarray
    ours = write_vtk(tmp_path / "m.vtk", conv(v), conv(t),
                     point_data={"u": conv(u), "disp": conv(disp)})
    assert ours == tmp_path / "m.vtk"
    text = open(ours, "rb").read()
    assert text == open(ref, "rb").read()
    assert b"SCALARS u double 1" in text and b"VECTORS disp double" in text


def test_write_vtk_tets_and_validation(tmp_path):
    cube = fem.unit_cube(1)
    v, t = np.asarray(cube["vertices"], dtype=np.float64), np.asarray(cube["tetrahedra"])
    ref = jax_write_vtk(tmp_path / "ref.vtk", v, t, title="cube\nsecond line")
    ours = write_vtk(tmp_path / "c.vtk", torch.from_numpy(v), torch.from_numpy(t),
                     title="cube\nsecond line")
    text = open(ours, "rb").read()
    assert text == open(ref, "rb").read()
    assert b"CELL_TYPES 6" in text and b"\n10\n" in text
    bad = [
        (v[:, :1], t, None),
        (v, np.array([[0, 1, 2, 99999]]), None),
        (v, t, {"bad": np.zeros((3, 1))}),
        (v, t, {"wide": np.zeros((v.shape[0], 4))}),
        (v, t[:, :2], None),
    ]
    for verts, cells, data in bad:
        with pytest.raises(ValueError) as ours_err:
            write_vtk(tmp_path / "x.vtk", verts, cells, point_data=data)
        with pytest.raises(ValueError) as ref_err:
            jax_write_vtk(tmp_path / "y.vtk", verts, cells, point_data=data)
        assert str(ours_err.value) == str(ref_err.value)
