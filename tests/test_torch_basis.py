"""PyTorch port, basis layer: float64 parity with the JAX package.

The same DFN (h=0.25, 3,216 cells) goes through both packages: the port's
mesh is built from the JAX mesh's arrays (``interop.mesh_from_numpy``).
DOF maps must be byte-identical; quadrature tensors and local element
matrices agree to 1e-12 relative (only the order of float operations in the
small matmuls can differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import config, interop

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

RTOL = 1e-12


@pytest.fixture(scope="module")
def bases():
    jm = jax_network(h=0.25)
    pm = interop.mesh_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm._t), device="cpu"
    )
    jV = fem.FractureNetworkBasis(jm, fem.ElementTri(1, 2))
    pV = pt.FractureNetworkBasis(pm, pt.ElementTri(1, 2))
    return jV, pV


def _close(ours, ref, rtol=RTOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(ours - ref).max() <= rtol * scale


def test_dof_maps_byte_identical(bases):
    jV, pV = bases
    assert pV.n_dofs == jV.n_dofs == 1587
    for name in ("_global_dofs4elements", "_nodes4boundary_dofs"):
        ours, ref = getattr(pV, name), np.asarray(getattr(jV, name))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), ref, err_msg=name)
    np.testing.assert_array_equal(
        pV._basis_parameters["inner_dofs"].numpy(),
        np.asarray(jV._basis_parameters["inner_dofs"]),
    )
    for ours, ref in zip(
        pV._basis_parameters["bilinear_form_idx"],
        jV._basis_parameters["bilinear_form_idx"],
    ):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        pV._basis_parameters["linear_form_idx"][0].numpy(),
        np.asarray(jV._basis_parameters["linear_form_idx"][0]),
    )
    np.testing.assert_array_equal(
        pV._coords4global_dofs.numpy(), np.asarray(jV._coords4global_dofs)
    )


@pytest.mark.parametrize(
    "name", ["v", "v_grad", "_dx", "integration_points", "_inv_map_jacobian", "_coords4elements"]
)
def test_quadrature_tensors_match(bases, name):
    jV, pV = bases
    _close(getattr(pV, name), getattr(jV, name))


def test_local_forms_match(bases):
    jV, pV = bases
    _close(
        pV.integrate_bilinear_form_local(lambda b: b.v_grad @ b.v_grad.mT),
        jV.integrate_bilinear_form_local(
            lambda b: b.v_grad @ jnp.matrix_transpose(b.v_grad)
        ),
    )
    _close(
        pV.integrate_linear_form_local(lambda b: b.v),
        jV.integrate_linear_form_local(lambda b: b.v),
    )


def test_reduce_and_solution_tensor(bases):
    jV, pV = bases
    rng = np.random.default_rng(3)
    vec = rng.standard_normal((pV.n_dofs, 1))
    np.testing.assert_array_equal(
        pV.reduce(torch.from_numpy(vec)).numpy(), np.asarray(jV.reduce(jnp.asarray(vec)))
    )
    u0 = pV.solution_tensor()
    assert u0.shape == (pV.n_dofs, 1) and u0.dtype == torch.float64
    assert not u0.any()


def test_own_mesh_build_gives_the_same_basis(bases):
    """The port's own DFN build (not the interop copy) gives the same basis."""
    _, pV = bases
    own = pt.FractureNetworkBasis(
        pt.build_benchmark_network(0.25, device="cpu"), pt.ElementTri(1, 2)
    )
    assert torch.equal(own._global_dofs4elements, pV._global_dofs4elements)
    assert torch.equal(own.v_grad, pV.v_grad) and torch.equal(own._dx, pV._dx)


def test_symmetric_probe_rejects_nonsymmetric_form(bases):
    _, pV = bases
    skew = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                        dtype=torch.float64)
    with pytest.raises(ValueError, match="not symmetric"):
        pV.compiled_solver(lambda b: b.v_grad @ b.v_grad.mT + skew, lambda b: b.v)
