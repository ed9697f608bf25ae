"""The traffic's fields: the same (seed, request) gives the same draw,
and anything else another."""

import numpy as np
import pytest
import torch

from fem_bench import fields
from fem_bench.forms import DeviceField
from fem_bench.reference.p1 import field_function

SPEC = fields.field_spec({"transform": "exp", "sigma": 1.0, "corr_length_rel": 0.3}, 4.0)


def test_same_seed_and_index_same_draw():
    a = fields.draw(SPEC, "coefficient", 2**31 + 17, 5)
    assert a.shape == (32, 4)
    np.testing.assert_array_equal(a, fields.draw(SPEC, "coefficient", 2**31 + 17, 5))


@pytest.mark.parametrize("other", [
    dict(seed=2**31 + 18), dict(index=6), dict(role="load"), dict(warmup=True)])
def test_other_key_other_draw(other):
    key = dict(role="coefficient", seed=2**31 + 17, index=5, warmup=False)
    base = fields.draw(SPEC, key["role"], key["seed"], key["index"], warmup=key["warmup"])
    key.update(other)
    moved = fields.draw(SPEC, key["role"], key["seed"], key["index"], warmup=key["warmup"])
    assert not np.allclose(base, moved)


def test_once_per_run_field_ignores_the_index():
    once = SPEC._replace(per_request=False)
    a = fields.draw(once, "coefficient", 9, 0)
    np.testing.assert_array_equal(a, fields.draw(once, "coefficient", 9, 1234))
    np.testing.assert_array_equal(a, fields.draw(once, "coefficient", 9, 3, warmup=True))


def test_field_statistics_and_constant():
    """Unit variance of log kappa over many draws at one point, on both
    sides (the program's forms and the reference); a constant spec draws
    nothing and is its mean."""
    x = torch.tensor([[[0.3, 1.1, -0.4]]], dtype=torch.float64)
    draws = [fields.draw(SPEC, "coefficient", 1, i) for i in range(2000)]
    logk = [float(torch.log(field_function(SPEC, d, "cpu")(x))) for d in draws]
    assert abs(np.var(logk) - 1.0) < 0.1 and abs(np.mean(logk)) < 0.1
    side = DeviceField(SPEC, "cpu", torch.float64)
    for d, ref in zip(draws[:5], logk):
        side.set(d)
        assert float(torch.log(side.at(x))) == pytest.approx(ref, abs=1e-12)
    const = fields.field_spec({"transform": "affine", "mean": 1.0}, 1.0)
    assert fields.draw(const, "load", 1, 0).shape == (0, 4)
    assert float(field_function(const, np.zeros((0, 4)), "cpu")(x)) == 1.0
    assert float(DeviceField(const, "cpu", torch.float64).at(x)) == 1.0


def test_negative_and_huge_seeds():
    for seed in (-1, 0, 2**40 + 3):
        assert np.isfinite(fields.draw(SPEC, "coefficient", seed, 0)).all()
