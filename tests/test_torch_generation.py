"""PyTorch port, 2D mesh generators (``mesh/generation.py``).

Host NumPy: every generator's output must be byte-identical to the JAX
package's, dtypes included.
"""

import numpy as np
import pytest
import torch

from pytorch_fem_solver_tpu.mesh import generation as jgen
from pytorch_fem_solver_tpu_torch.mesh import generation as pgen

torch.set_num_threads(1)


def _assert_same(ours: dict, ref: dict):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("pattern", ["right", "alternating", "crisscross"])
@pytest.mark.parametrize("shape", [(1, 1), (4, 3), (7, 2)])
def test_rectangle_byte_identical(pattern, shape):
    nx, ny = shape
    kw = dict(x0=-1.0, x1=2.5, y0=0.25, y1=1.0, pattern=pattern)
    _assert_same(pgen.rectangle(nx, ny, **kw), jgen.rectangle(nx, ny, **kw))


@pytest.mark.parametrize("kw", [{"n": 5}, {"max_area": 0.5**7}, {"max_area": 0.3}])
def test_unit_square_byte_identical(kw):
    _assert_same(pgen.unit_square(**kw), jgen.unit_square(**kw))


@pytest.mark.parametrize("times", [1, 2])
@pytest.mark.parametrize("pattern", ["alternating", "crisscross"])
def test_refine_uniform_byte_identical(times, pattern):
    base = jgen.rectangle(3, 2, pattern=pattern)
    _assert_same(pgen.refine_uniform(base, times), jgen.refine_uniform(base, times))
    # without markers, they are derived from the boundary edges
    bare = {k: base[k] for k in ("vertices", "triangles")}
    _assert_same(pgen.refine_uniform(bare, times), jgen.refine_uniform(bare, times))


def test_max_area_and_boundary_markers_match():
    tri = jgen.refine_uniform(jgen.rectangle(3, 4, x1=2.0, pattern="right"))
    assert pgen.triangulation_max_area(tri) == jgen.triangulation_max_area(tri)
    v, t = np.asarray(tri["vertices"]), np.asarray(tri["triangles"])
    np.testing.assert_array_equal(
        pgen._mark_boundary_vertices(v, t), jgen._mark_boundary_vertices(v, t)
    )


def test_invalid_arguments_raise():
    with pytest.raises(ValueError, match="nx and ny"):
        pgen.rectangle(0, 3)
    with pytest.raises(ValueError, match="max_area or n"):
        pgen.unit_square()
