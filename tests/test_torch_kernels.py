"""PyTorch port, kernel K1 (P1 element kernel for embedded triangles).

On the CPU the wrapper runs the plain version, which must equal the JAX
package's XLA oracle ``_p1_xla_3d`` and its Pallas kernel run in interpret
mode to 1e-14 on the same SoA input, padding lanes included. The kernel
itself runs only on a card (``cuda`` marker); ``chip_smoke.py`` holds it
against the plain version at the benchmark size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.ops import pallas_kernels as jk
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.ops import cuda_build
from pytorch_fem_solver_tpu_torch.ops import kernels as pk

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)


@pytest.fixture(scope="module")
def network():
    jm = jax_network(h=0.25)
    pm = interop.mesh_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm._t), device="cpu"
    )
    return jm, pm


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    return np.abs(ours - ref).max() / np.abs(ref).max()


def test_soa_layout_matches_jax(network):
    jm, pm = network
    soa = pk.coords_to_soa_3d(pm["cells", "coordinates_3d"])
    ref = jk.coords_to_soa_3d(jm["cells", "coordinates_3d"])
    np.testing.assert_array_equal(soa.numpy(), np.asarray(ref))


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
def test_plain_k1_matches_jax_kernel(network, oracle):
    jm, pm = network
    jsoa = jk.coords_to_soa_3d(jm["cells", "coordinates_3d"])
    if oracle == "xla":
        ref = jk._p1_xla_3d(jsoa)
    else:
        ref = jk._p1_pallas_3d(jsoa, interpret=True)
    ref = np.asarray(ref)
    ours = pk._p1_plain_3d(pk.coords_to_soa_3d(pm["cells", "coordinates_3d"]))
    assert ours.shape == (pk.P1_OUT_ROWS, ref.shape[1])
    assert _rel(ours.numpy(), ref[: pk.P1_OUT_ROWS]) <= 1e-14
    assert not ref[pk.P1_OUT_ROWS :].any()  # the TPU's zero pad rows


def test_wrapper_on_cpu_is_the_plain_version(network):
    _, pm = network
    coords = pm["cells", "coordinates_3d"]
    before = dict(cuda_build.launch_counts)
    out = pk.p1_element_3d(coords)
    assert cuda_build.launch_counts == before  # no kernel launched
    T = pm.n_cells
    assert torch.equal(out, pk._p1_plain_3d(coords.reshape(T, 9).T))


def test_public_api_matches_jax(network):
    jm, pm = network
    ours = pk.p1_local_stiffness_load_3d(pm["cells", "coordinates_3d"])
    ref = jk.p1_local_stiffness_load_3d(
        jm["cells", "coordinates_3d"], use_pallas=False
    )
    for a, b in zip(ours, ref):
        assert _rel(a.numpy(), b) <= 1e-14


def test_k1_equals_tangential_assembly(network):
    """The identity the JAX package asserts, held by the port: K1 rows ==
    the basis's tangential-gradient stiffness and f=1 load."""
    _, pm = network
    V = pt.FractureNetworkBasis(pm, pt.ElementTri(1, 2))
    stiff, load, areas = pk.p1_local_stiffness_load_3d(pm["cells", "coordinates_3d"])
    ref = V.integrate_bilinear_form_local(lambda b: b.v_grad @ b.v_grad.mT)
    assert _rel(stiff.numpy(), ref.numpy()) <= 1e-12
    ref_load = V.integrate_linear_form_local(lambda b: b.v)[..., 0]
    assert _rel(load.numpy(), ref_load.numpy()) <= 1e-12
    assert abs(float(areas.sum()) - float(V._dx.sum())) <= 1e-12 * float(areas.sum())


def test_2d_coordinates_are_lifted_with_zero_z():
    tri = fem.unit_square(n=4)
    mesh = pt.MeshTri(tri, device="cpu")
    stiff, load, areas = pk.p1_local_stiffness_load_3d(mesh["cells", "coordinates"])
    ref_stiff, ref_load, _ = jk.p1_local_stiffness_load(
        jnp.asarray(np.asarray(mesh["cells", "coordinates"])), use_pallas=False
    )
    assert _rel(stiff.numpy(), ref_stiff) <= 1e-13
    assert _rel(load.numpy(), ref_load) <= 1e-14
    assert abs(float(areas.sum()) - 1.0) < 1e-12


def test_non_cpu_non_cuda_tensor_raises_instead_of_falling_back():
    coords = torch.empty((4, 3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        pk.p1_element_3d(coords)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k1_kernel_matches_plain_on_card(network, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 is a CUDA kernel with no CPU mode")
    _, pm = network
    coords = pm["cells", "coordinates_3d"].to("cuda", dtype).contiguous()
    before = cuda_build.launch_counts["p1_element_3d"]
    out = pk.p1_element_3d(coords)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["p1_element_3d"] == before + 1
    ref = pk._p1_plain_3d(coords.reshape(-1, 9).T)
    err = ((out - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)).max()
    assert float(err) <= tol
