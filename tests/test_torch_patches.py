"""PyTorch port, the patches (``Patches``, ``PatchesBasis``,
``MeshesTri.apply_mask``, ``bench_vpinn.make_patches_rvpinn``).

In float64 on the CPU, against the JAX package on the same inputs: every
case of ``tests/test_patches.py`` run through both packages (the single
patch against the standard ``Basis``, the batched solve, the ``reduce``
shapes, ``refine_patches``, the compounding ``uniform_refine``, P2 and P3
patches against standalone bases), every mesh table and DOF table
byte-identical, values to 1e-12; ``apply_mask`` with a boolean mask and
with integer indices; and the patch RVPINN's first 5 epochs within 1e-8 of
``examples/example_patches.py``'s training step run through the JAX
``Model`` on the same weights.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.mesh.patches import (
    MARKERS_4_VERTICES,
    SIGNS_4_VERTICES,
    VERTICES_4_CELLS_4_PATCH,
)
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.bench_vpinn import (
    generate_patches_info,
    make_patches_rvpinn,
    patch_gram,
)
from pytorch_fem_solver_tpu_torch.mesh import patches as port_patches

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)


def _mT(x):
    return x.mT if isinstance(x, torch.Tensor) else jnp.matrix_transpose(x)


def stiffness(basis):
    return basis.v_grad @ _mT(basis.v_grad)


def load(basis):
    x = basis.integration_points[..., 0:1]
    y = basis.integration_points[..., 1:2]
    return (x + 2.0 * y) * basis.v


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = np.abs(ref).max()
    return np.abs(ours - ref).max() / (scale if scale else 1.0)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def _both(centers, radius):
    return fem.Patches(centers, radius), pt.Patches(centers, radius, device="cpu")


def _seeded(seed, B):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.3, 0.7, size=(B, 2)), rng.uniform(0.05, 0.2, size=(B, 1))


def test_template_constants_and_tables_byte_identical():
    np.testing.assert_array_equal(port_patches.SIGNS_4_VERTICES, SIGNS_4_VERTICES)
    np.testing.assert_array_equal(port_patches.VERTICES_4_CELLS_4_PATCH, VERTICES_4_CELLS_4_PATCH)
    np.testing.assert_array_equal(port_patches.MARKERS_4_VERTICES, MARKERS_4_VERTICES)
    jp, pp = _both(*_seeded(0, 7))
    ours = dict(_flatten(pp._t))
    keys = [k for k, _ in _flatten(dict(jp._t))]
    assert sorted(ours) == sorted(keys)
    for key, value in _flatten(dict(jp._t)):
        ref = np.asarray(value)
        assert ours[key].dtype == (torch.int32 if ref.dtype == np.int32 else torch.float64), key
        np.testing.assert_array_equal(ours[key].numpy(), ref, err_msg=str(key))
    assert pp.batch_size() == jp.batch_size() == (7,)
    for name in ("centers", "radius", "signs_4_vertices", "vertices_4_cells_4_patch",
                 "markers_4_vertices"):
        np.testing.assert_array_equal(getattr(pp, name).numpy(), np.asarray(getattr(jp, name)))
    with pytest.raises(ValueError, match="same batch size"):
        pt.Patches([[0.5, 0.5]], [[0.1], [0.2]], device="cpu")


def test_single_patch_matches_standard_basis():
    jp, pp = _both([[0.5, 0.5]], [[0.5]])
    VP = pt.PatchesBasis(pp, pt.ElementTri(1, 2))
    jVP = fem.PatchesBasis(jp, fem.ElementTri(1, 2))
    tri = {
        "vertices": SIGNS_4_VERTICES * 0.5 + 0.5,
        "triangles": VERTICES_4_CELLS_4_PATCH,
        "vertex_markers": MARKERS_4_VERTICES,
    }
    V = pt.Basis(pt.MeshTri(tri, device="cpu"), pt.ElementTri(1, 2))
    A_b = VP.integrate_bilinear_form(stiffness).numpy()
    assert A_b.shape == (1, 5, 5)
    np.testing.assert_allclose(A_b[0], V.integrate_bilinear_form(stiffness).numpy(), atol=1e-14)
    assert _rel(A_b, jVP.integrate_bilinear_form(stiffness)) <= 1e-14
    b_b = VP.integrate_linear_form(load).numpy()
    np.testing.assert_allclose(b_b[0], V.integrate_linear_form(load).numpy(), atol=1e-14)
    assert _rel(b_b, jVP.integrate_linear_form(load)) <= 1e-14


@pytest.mark.parametrize("order", [1, 2, 3])
def test_patches_basis_tables_match_jax(order):
    jp, pp = _both(*_seeded(order, 6))
    jV = fem.PatchesBasis(jp, fem.ElementTri(order, 4))
    pV = pt.PatchesBasis(pp, pt.ElementTri(order, 4))
    assert pV.nb_patches == jV.nb_patches == 6
    np.testing.assert_array_equal(pV.patches_idx.numpy(), np.asarray(jV.patches_idx))
    for name in ("_global_dofs4elements", "_nodes4boundary_dofs"):
        ours = getattr(pV, name)
        assert ours.dtype == torch.int32, name
        np.testing.assert_array_equal(ours.numpy(), np.asarray(getattr(jV, name)), err_msg=name)
    ours, ref = pV._basis_parameters, jV._basis_parameters
    assert sorted(ours) == sorted(ref)
    for key in ("bilinear_form_shape", "linear_form_shape", "nb_dofs"):
        assert tuple(np.atleast_1d(ours[key])) == tuple(np.atleast_1d(ref[key])), key
    for key in ("bilinear_form_idx", "linear_form_idx"):
        for a, b in zip(ours[key], ref[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    np.testing.assert_array_equal(ours["inner_dofs"].numpy(), np.asarray(ref["inner_dofs"]))
    for name in ("v", "v_grad", "integration_points", "_dx", "_coords4global_dofs",
                 "_coords4elements"):
        assert _rel(getattr(pV, name).numpy(), getattr(jV, name)) <= 1e-12, name
    A, b = pV.integrate_bilinear_form(stiffness), pV.integrate_linear_form(load)
    assert _rel(A.numpy(), jV.integrate_bilinear_form(stiffness)) <= 1e-12
    assert _rel(b.numpy(), jV.integrate_linear_form(load)) <= 1e-12
    local = pV.integrate_bilinear_form_local(stiffness)
    assert _rel(local.numpy(), jV.integrate_bilinear_form_local(stiffness)) <= 1e-12
    with pytest.raises(NotImplementedError, match="Unknown form type"):
        pV.reshape_for_assembly(local, "mixed")


def test_batched_patch_solve():
    """B independent local Poisson problems in one batched solve, each equal
    to its standalone solve and to the JAX package's batched solve."""
    centers, radius = _seeded(0, 7)
    jp, pp = _both(centers, radius)
    VP = pt.PatchesBasis(pp, pt.ElementTri(1, 2))
    u = VP.solve(VP.integrate_bilinear_form(stiffness), VP.solution_tensor(),
                 VP.integrate_linear_form(load))
    assert u.shape == (7, 5, 1)
    jVP = fem.PatchesBasis(jp, fem.ElementTri(1, 2))
    ref = jVP.solve(jVP.integrate_bilinear_form(stiffness), jVP.solution_tensor(),
                    jVP.integrate_linear_form(load))
    assert _rel(u.numpy(), ref) <= 1e-12
    for i in range(7):
        mesh_i = pt.MeshTri(
            {
                "vertices": pp["vertices", "coordinates"][i].numpy(),
                "triangles": VERTICES_4_CELLS_4_PATCH,
                "vertex_markers": MARKERS_4_VERTICES,
            },
            device="cpu",
        )
        V_i = pt.Basis(mesh_i, pt.ElementTri(1, 2))
        u_i = V_i.solve(V_i.integrate_bilinear_form(stiffness), V_i.solution_tensor(),
                        V_i.integrate_linear_form(load))
        np.testing.assert_allclose(u[i].numpy(), u_i.numpy(), atol=1e-12)


def test_reduce_shapes():
    jp, pp = _both([[0.5, 0.5], [0.2, 0.3]], [[0.1], [0.05]])
    VP = pt.PatchesBasis(pp, pt.ElementTri(1, 2))
    jVP = fem.PatchesBasis(jp, fem.ElementTri(1, 2))
    A, b = VP.integrate_bilinear_form(stiffness), VP.integrate_linear_form(load)
    assert VP.reduce(A).shape == (2, 1, 1)  # only the center DOF is interior
    assert VP.reduce(b).shape == (2, 1, 1)
    assert _rel(VP.reduce(A).numpy(), jVP.reduce(jVP.integrate_bilinear_form(stiffness))) <= 1e-14
    assert _rel(VP.reduce(b).numpy(), jVP.reduce(jVP.integrate_linear_form(load))) <= 1e-14


@pytest.mark.parametrize("maintain", [False, True])
def test_refine_patches(maintain):
    jp, pp = _both([[0.5, 0.5], [0.25, 0.25]], [[0.25], [0.125]])
    mask = np.array([True, False])
    centers, radius, coords = pp.refine_patches(mask, maintain_old_patches=maintain)
    kept = 2 if maintain else 1
    assert centers.shape == (kept + 5, 2) and radius.shape == (kept + 5, 1)
    assert coords.shape == (kept + 5, 5, 2)
    assert centers.dtype == torch.float64 and centers.device.type == "cpu"
    for ours, ref in zip((centers, radius, coords), jp.refine_patches(mask, maintain)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # children have half the radius; the rotated patch sqrt(2)/2 of the parent
    np.testing.assert_allclose(radius[kept:kept + 4, 0].numpy(), 0.125)
    np.testing.assert_allclose(float(radius[-1, 0]), 0.25 / np.sqrt(2.0))
    refined = pt.Patches(centers, radius, device="cpu")
    assert refined.batch_size() == (kept + 5,)
    # the tensor mask gives the same set
    again = pp.refine_patches(torch.tensor(mask), maintain_old_patches=maintain)
    for a, b in zip(again, (centers, radius, coords)):
        assert torch.equal(a, b)


def test_uniform_refine_compounds():
    jp, pp = _both([[0.5, 0.5]], [[0.5]])
    centers, radius, coords = pp.uniform_refine(2)
    assert centers.shape[0] == 25  # each pass: B -> 5B
    assert float(radius.max()) <= 0.5 / np.sqrt(2.0) + 1e-12
    for ours, ref in zip((centers, radius, coords), jp.uniform_refine(2)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("order,seed,B,n_dofs", [(2, 1, 5, 13), (3, 4, 4, 25)])
def test_batched_patch_higher_order_matches_standalone(order, seed, B, n_dofs):
    """P2/P3 batched local solves equal their standalone ``Basis`` solves,
    matched through the DOF coordinates (the patch template's edge
    numbering differs from ``MeshTri``'s edge table), and the JAX
    package's batched solve."""
    centers, radius = _seeded(seed, B)
    jp, pp = _both(centers, radius)
    q = 4 if order == 2 else 5
    VP = pt.PatchesBasis(pp, pt.ElementTri(order, q))
    assert np.abs(VP.v.numpy().sum(-2) - 1.0).max() < 1e-12  # partition of unity
    u = VP.solve(VP.integrate_bilinear_form(stiffness), VP.solution_tensor(),
                 VP.integrate_linear_form(load))
    assert u.shape == (B, n_dofs, 1)
    jVP = fem.PatchesBasis(jp, fem.ElementTri(order, q))
    ref = jVP.solve(jVP.integrate_bilinear_form(stiffness), jVP.solution_tensor(),
                    jVP.integrate_linear_form(load))
    assert _rel(u.numpy(), ref) <= 1e-11
    coords_b = VP._coords4global_dofs.numpy()
    for i in range(B):
        mesh_i = pt.MeshTri(
            {
                "vertices": pp["vertices", "coordinates"][i].numpy(),
                "triangles": VERTICES_4_CELLS_4_PATCH,
                "vertex_markers": MARKERS_4_VERTICES,
            },
            device="cpu",
        )
        V_i = pt.Basis(mesh_i, pt.ElementTri(order, q))
        u_i = V_i.solve(V_i.integrate_bilinear_form(stiffness), V_i.solution_tensor(),
                        V_i.integrate_linear_form(load)).numpy()
        coords_i = V_i._coords4global_dofs.numpy()
        dist = np.linalg.norm(coords_b[i][:, None, :] - coords_i[None, :, :], axis=-1)
        perm = dist.argmin(axis=1)
        assert dist.min(axis=1).max() < 1e-12 and len(set(perm.tolist())) == n_dofs
        np.testing.assert_allclose(u[i, :, 0].numpy(), u_i[perm, 0], atol=1e-11)


def test_apply_mask_both_branches():
    jp, pp = _both(*_seeded(3, 6))
    rng = np.random.default_rng(5)
    for group in (("vertices", "coordinates"), ("cells", "coordinates"), ("vertices", "markers")):
        tensor, ref_tensor = pp[group], jp[group]
        n = tensor.shape[1]
        mask = np.zeros((6, n), dtype=bool)
        for row in mask:  # the same count in every entry, different places
            row[rng.choice(n, size=2, replace=False)] = True
        ours = pt.MeshesTri.apply_mask(tensor, mask)
        ref = fem.MeshesTri.apply_mask(ref_tensor, mask)
        assert ours.dtype == tensor.dtype
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref), err_msg=str(group))
        # a boolean tensor and a one-element list take the same branch
        assert torch.equal(pt.MeshesTri.apply_mask(tensor, torch.tensor(mask)), ours)
        assert torch.equal(pt.MeshesTri.apply_mask(tensor, [mask]), ours)
        idx = rng.integers(0, n, size=(6, 3))
        ours = pt.MeshesTri.apply_mask(tensor, idx)
        np.testing.assert_array_equal(
            ours.numpy(), np.asarray(fem.MeshesTri.apply_mask(ref_tensor, idx)), err_msg=str(group)
        )
        assert torch.equal(pt.MeshesTri.apply_mask(tensor, torch.tensor(idx, dtype=torch.int32)), ours)


# -- the patch RVPINN -----------------------------------------------------------


def _jax_example(levels, width, depth):
    """``examples/example_patches.py``'s bases, Grams and training step,
    built with the JAX package."""

    def bc(inputs):
        x, y = inputs[..., 0:1], inputs[..., 1:2]
        return x * (x - 1) * y * (y - 1)

    def rhs(x, y):
        return 2.0 * math.pi**2 * jnp.sin(math.pi * x) * jnp.sin(math.pi * y)

    def exact(x, y):
        return jnp.sin(math.pi * x) * jnp.sin(math.pi * y)

    def exact_dx(x, y):
        return math.pi * jnp.cos(math.pi * x) * jnp.sin(math.pi * y)

    def exact_dy(x, y):
        return math.pi * jnp.sin(math.pi * x) * jnp.cos(math.pi * y)

    def residual_form(basis, gradient):
        pts = basis.integration_points
        x, y = pts[..., 0:1], pts[..., 1:2]
        return rhs(x, y) * basis.v - (basis.v_grad @ jnp.matrix_transpose(gradient(pts)))

    def h1_exact(basis):
        x, y = basis.integration_points[..., 0:1], basis.integration_points[..., 1:2]
        return exact(x, y) ** 2 + exact_dx(x, y) ** 2 + exact_dy(x, y) ** 2

    def h1_norm(basis, net, gradient):
        pts = basis.integration_points
        x, y = pts[..., 0:1], pts[..., 1:2]
        dx, dy = jnp.split(gradient(pts), 2, axis=-1)
        return ((exact(x, y) - net(pts)) ** 2 + (exact_dx(x, y) - dx) ** 2
                + (exact_dy(x, y) - dy) ** 2)

    nn = fem.FeedForwardNeuralNetwork(
        2, 1, nb_hidden_layers=depth, neurons_per_layers=width,
        use_xavier_initialization=True, boundary_condition_modifier=bc,
    )
    centers, radius = generate_patches_info(levels)
    patches = fem.Patches(centers, radius)
    mesh = fem.MeshTri(fem.unit_square(max_area=0.5**8))
    discrete = fem.PatchesBasis(patches, fem.ElementTri(1, 2))
    validation = fem.PatchesBasis(patches, fem.ElementTri(1, 4))
    error = fem.Basis(mesh, fem.ElementTri(1, 2))
    gram_inverse = jnp.linalg.inv(discrete.reduce(discrete.integrate_bilinear_form(stiffness)))
    validation_gram_inverse = jnp.linalg.inv(
        validation.reduce(validation.integrate_bilinear_form(stiffness))
    )
    exact_norm = jnp.sqrt(error.integrate_functional(h1_exact).sum())

    def training_step(net):
        r = discrete.reduce(discrete.integrate_linear_form(residual_form, net.gradient))
        loss = (jnp.matrix_transpose(r) @ (gram_inverse @ r)).sum()
        r_val = validation.reduce(validation.integrate_linear_form(residual_form, net.gradient))
        val_loss = (jnp.matrix_transpose(r_val) @ (validation_gram_inverse @ r_val)).sum()
        val_loss = jnp.sqrt(val_loss) / exact_norm**2
        h1_error = jnp.sqrt(error.integrate_functional(h1_norm, net, net.gradient).sum())
        return loss, val_loss, h1_error / exact_norm

    return nn, gram_inverse, validation_gram_inverse, training_step


def test_patch_rvpinn_matches_jax_example():
    """64 patches (the example's size): the K5-built batched Gram inverses
    against JAX's ``inv(reduce(integrate_bilinear_form))`` (1e-12), and 5
    Adam epochs of ``(loss, val_loss, h1_error)`` within 1e-8 of the JAX
    ``Model`` on the same weights."""
    rv = make_patches_rvpinn(3, epochs=5, device="cpu")
    jnet, jgram_inv, jval_inv, step = _jax_example(3, 15, 4)
    assert rv.patches.batch_size() == (64,) and rv.gram_inv.shape == (64, 1, 1)
    assert _rel(rv.gram_inv.numpy(), jgram_inv) <= 1e-12
    assert _rel(rv.validation_gram_inv.numpy(), jval_inv) <= 1e-12
    for basis in (rv.basis, rv.validation_basis):
        gram = basis.reduce(basis.integrate_bilinear_form(stiffness))
        assert _rel(patch_gram(basis).numpy(), gram.numpy()) <= 1e-12
    # the seeded Xavier draw is the JAX draw; carry the weights all the same
    ref_net = interop.network_from_numpy(
        [np.asarray(w) for w in jnet.weights], [np.asarray(b) for b in jnet.biases],
        input_dimension=2, output_dimension=1, nb_hidden_layers=4, neurons_per_layers=15,
        device="cpu", dtype=torch.float64,
    )
    for name, p in ref_net.named_parameters():
        assert torch.equal(dict(rv.network.named_parameters())[name], p), name
    rv.network.load_state_dict(ref_net.state_dict())
    jm = fem.Model(jnet, step, epochs=5, optimizer_kwargs={"lr": 0.001}, progress_bar=False)
    jm.train()
    rv.model.train()
    for ours, ref in zip(rv.model.get_training_history(), jm.get_training_history()):
        assert len(ours) == len(ref) == 5
        np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=0)
    assert rv.model.get_training_history()[0][-1] < rv.model.get_training_history()[0][0]


def test_generate_patches_info_and_deeper_hierarchy():
    for n in (0, 1, 2):
        centers, radius = generate_patches_info(n)
        assert centers.shape == (4**n, 2) and radius.shape == (4**n, 1)
        np.testing.assert_allclose(radius, 0.5 / 2**n)
    rv = make_patches_rvpinn(2, 6, 2, epochs=3, device="cpu")
    assert rv.basis.nb_patches == 16 and rv.basis.integration_points.shape[:2] == (16, 4)
    loss, val_loss, h1 = rv.training_step(rv.network)
    assert loss.requires_grad and not val_loss.requires_grad and not h1.requires_grad
    rv.model.train_compiled(3)
    blocked = rv.model.get_training_history()
    again = make_patches_rvpinn(2, 6, 2, epochs=3, device="cpu")
    again.model.train()
    for a, b in zip(again.model.get_training_history(), blocked):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
