"""PyTorch port, the modal analysis of the benchmark's ``cube48_modes_p1``
cell at a tiny size: ``compiled_eigsh`` of the clamped elastic cube with a
log-normal Young's modulus (the Lame form scaled by E, the vector mass)
against ``fem_bench/reference/elasticity_modes_p1.py``, the benchmark's
plain float64 reference, on ``kuhn_cube(6)`` (375 DOFs) with two seeded
samples of the cell's field; the reference against dense
``scipy.linalg.eigh`` of its own matrices; and the canonical-pair assembly
that the compiled eigensolve now takes, against the entry-by-entry scatter
it replaced.

Held, with the reason for each tolerance:

* float64 at tol 1e-11: the eigenvalues within 1e-8 relative of the
  reference's (LOBPCG stops on a relative change of 1e-11 between rounds;
  the Rayleigh quotient's error is of the order of its residual squared),
  and the largest relative residual of the port's pairs in the reference's
  K and M at most 1e-5 (soft locking freezes a column at a relative
  residual of sqrt(tol) ~ 3.2e-6);
* float32 at tol 1e-5, the traffic's own: the eigenvalues within 1e-4
  relative (float32 LOBPCG stalls near 1.5e-5 from float64 on these
  operators; a relative change of 1e-5 bounds the rest);
* the reference within 1e-10 relative of ``scipy.linalg.eigh`` (it stops at
  a relative residual of 1e-8: the eigenvalues' error is of its square);
* the symmetric assembly of both forms within 1e-12 of
  ``bsr_values_from_local`` (the sums of the same float64 terms in another
  order).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg
import torch

import pytorch_fem_solver_tpu_torch as pt
from fem_bench import fields
from fem_bench.meshes.kuhn_cube import kuhn_cube
from fem_bench.problems.elasticity_modes_p1 import ModalForms
from fem_bench.reference import elasticity_modes_p1 as modal
from fem_bench.reference import p1
from fem_bench.reference.kuhn_cube import glue
from pytorch_fem_solver_tpu_torch.ops import bsr, compiled

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TRAFFIC = json.loads((REPO / "fem_bench/traffic/mc_lognormal_k6.json").read_text())
SPEC = fields.field_spec(TRAFFIC["coefficient"], 1.0)
N, K, NU = 6, 6, 0.3
SEEDS = (2**31 + 11, 17)
INPUTS = dict(zip(("vertices", "tetrahedra"), kuhn_cube(N)))
GLUED = glue(INPUTS)


def _params(seed):
    return fields.params({"coefficient": SPEC}, seed, 0)["coefficient"]


def _port(dtype, seed):
    mesh = pt.MeshTet(INPUTS, device="cpu", dtype=dtype)
    V = pt.VectorBasis(mesh, pt.ElementTet(1, 2))
    forms = ModalForms(SPEC, fields.field_spec(TRAFFIC["load"], 1.0), NU, 1.0, "cpu", dtype)
    forms.set(_params(seed), None)
    return V, forms


@pytest.fixture(scope="module")
def reference():
    return modal.Reference(GLUED, "cpu", 2, NU, 1.0)


def _exact(reference, seed):
    kv = reference.stiffness_values(p1.field_function(SPEC, _params(seed), "cpu"))
    return kv, reference.modes(kv, K)


def _port_pairs(dtype, seed, tol):
    V, forms = _port(dtype, seed)
    vals, vecs, (rounds, _, converged) = V.compiled_eigsh(
        forms.a, forms.m, k=K, tol=tol, max_rounds=400, precondition="two_level")()
    assert bool(converged) and rounds < 400
    modes = vecs.double().numpy().reshape(-1, 3, K)
    return vals.double(), modes


@pytest.mark.parametrize("seed", SEEDS)
def test_float64_modes_match_the_reference(reference, seed):
    kv, exact = _exact(reference, seed)
    assert exact.converged
    vals, modes = _port_pairs(torch.float64, seed, 1e-11)
    assert torch.all(vals[1:] >= vals[:-1])
    assert float(((vals - exact.values).abs() / exact.values).max()) <= 1e-8
    x = reference.interior(modes, GLUED.vertex_node)
    assert float(reference.residuals(kv, reference.mass, vals, x).max()) <= 1e-5


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_modes_at_the_traffics_tolerance(reference, seed):
    _, exact = _exact(reference, seed)
    vals, _ = _port_pairs(torch.float32, seed, 1e-5)
    assert float(((vals - exact.values).abs() / exact.values).max()) <= 1e-4


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_matches_dense_eigh(reference, seed):
    kv, exact = _exact(reference, seed)
    dense_k = reference.matrix(kv).to_dense().numpy()
    dense_m = reference.matrix(reference.mass).to_dense().numpy()
    want = scipy.linalg.eigh(dense_k, dense_m, eigvals_only=True, subset_by_index=(0, K - 1))
    np.testing.assert_allclose(exact.values.numpy(), want, rtol=1e-10)
    x = exact.vectors.numpy()
    assert np.abs(x.T @ dense_m @ x - np.eye(K)).max() <= 1e-10


def test_the_mass_is_the_consistent_p1_mass(reference):
    """The port's full mass sums to 3, the cube's volume once for each
    component; the reference's, which holds the interior rows only, equals
    the port's interior block."""
    V, forms = _port(torch.float64, SEEDS[0])
    full = V.integrate_bilinear_form(forms.m).to_dense()
    assert abs(float(full.sum()) - 3.0) <= 1e-12
    reduced = V.reduce(V.integrate_bilinear_form(forms.m)).to_dense().numpy()
    dense_m = reference.matrix(reference.mass).to_dense().numpy()
    np.testing.assert_allclose(reduced, dense_m, rtol=0, atol=1e-14)


@pytest.mark.parametrize("form", ["a", "m"])
def test_symmetric_assembly_matches_the_entry_scatter(form):
    V, forms = _port(torch.float64, SEEDS[0])
    st = bsr.get_bsr_structure(V, max_b=bsr.default_max_b(V), want_entry_slot=True)
    f = getattr(forms, form)
    sym, _ = compiled._assemble_symmetric(V, st, f, None)
    full = bsr.bsr_values_from_local(st, V.integrate_bilinear_form_local(f))
    sym, full = (torch.cat([v.reshape(-1) for v in t]) for t in (sym, full))
    assert float((sym - full).abs().max()) <= 1e-12 * float(full.abs().max())
