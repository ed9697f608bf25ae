"""One rank of the multi-process parity tests of the port's ``parallel``
package (``tests/test_torch_sharding.py``, ``test_torch_sharded_basis.py``,
``test_torch_sharded_bsr.py``, ``test_torch_sharded_bsr_pcg.py``,
``test_torch_sharded_newton.py``, ``test_torch_sharded_eigen.py``,
``test_torch_sharded_stokes.py``, ``test_torch_sharded_tets.py``).

    python tests/torch_dist_worker.py SUITE RANK WORLD STORE OUT

joins a gloo process group of WORLD ranks through a ``FileStore`` at STORE
(no network), runs every case of SUITE on the CPU in float64 and pickles
``{case: result}`` to ``OUT.<RANK>.pkl``; a case that raises stores its
traceback text, so each test fails on its own. ``spawn`` starts the ranks
and reads the results back; ``start`` runs the spawns of a suite in the
background, so a test module computes its JAX references meanwhile, and
``case`` reads one case's result. The cases build their meshes with the port's
generators (byte-identical to the JAX package's), so the tests hold each
result against the JAX package's sharded solve on the same inputs. This
module imports the port only: no JAX in the rank processes.
"""

from __future__ import annotations

import math
import os
import pickle
import subprocess
import sys
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

F1 = [[-1, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 1, 0]]
F2 = [[0, 0, -1], [0, 0, 1], [0, 1, 1], [0, 1, -1]]
ANCHORS = np.array([[[-1.0, 0.0], [1.0, 0.0], [-1.0, 1.0]]] * 2)
FRACTURES_3D = np.array(
    [
        [[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 1.0, 0.0]],
        [[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 1.0, -1.0]],
    ]
)


def spawn(suite: str, world: int, tmp_dir: str, timeout: float | None = None) -> list[dict]:
    """Run SUITE on ``world`` gloo ranks (one process each, one thread
    each) and return the ranks' result dicts, rank 0 first. The ranks get
    ``timeout`` seconds (240, or 1800 with the ``FEM_TEST_SCALE`` cases)."""
    if timeout is None:
        timeout = 1800.0 if os.environ.get("FEM_TEST_SCALE") else 240.0
    store = os.path.join(tmp_dir, f"store_{suite}_{world}")
    out = os.path.join(tmp_dir, f"out_{suite}_{world}")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=path)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks talk over loopback only
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, suite, str(rank), str(world), store, out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {world} exited {p.returncode}:\n{logs[rank]}")
    results = []
    for rank in range(world):
        with open(f"{out}.{rank}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
    return results


def start(suite: str, tmp_dir: str, worlds=(2, 4)):
    """``(pool, {world: future of spawn(suite, world)})``, all started."""
    pool = ThreadPoolExecutor(len(worlds))
    return pool, {w: pool.submit(spawn, suite, w, tmp_dir) for w in worlds}


def in_threads(calls: dict, workers: int = 4) -> dict:
    """``{key: call()}`` with the calls run in a thread pool: a test
    module's JAX references, whose XLA compiles overlap outside the
    interpreter lock (about half the wall of running them in turn)."""
    with ThreadPoolExecutor(workers) as pool:
        futures = {key: pool.submit(call) for key, call in calls.items()}
        return {key: f.result() for key, f in futures.items()}


def case(runs, world: int, name: str) -> dict:
    """Rank 0's result of a case (waiting for the spawn), after checking
    that no rank raised and that every rank's solution and count equal rank
    0's (the replicated result)."""
    results = [r[name] for r in runs[world].result()]
    for res in results:
        assert "error" not in res, res["error"]
    for other in results[1:]:
        assert other.keys() == results[0].keys()
        if "u" in other:
            for key in ("u", "p", "vals"):
                if key in other:
                    np.testing.assert_array_equal(other[key], results[0][key])
            assert other["it"] == results[0]["it"]
    return results[0]


def rel(ours, ref) -> float:
    """max |ours - ref| / max |ref|."""
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(ours) - ref).max() / max(np.abs(ref).max(), 1e-300))


# -- forms and meshes (the port's side) --------------------------------------


def stiffness(b):
    return b.v_grad @ b.v_grad.mT


def load(b):
    x, y = b.integration_points[..., 0:1], b.integration_points[..., 1:2]
    return (1.0 + x + y) * b.v


def sine_load(b):
    x, y = b.integration_points[..., 0:1], b.integration_points[..., 1:2]
    return 2 * math.pi**2 * (math.pi * x).sin() * (math.pi * y).sin() * b.v


def generic_load(b):
    x, y = b.integration_points[..., 0:1], b.integration_points[..., 1:2]
    return (x * x + y.exp()) * b.v


def unit_load(b):
    return b.v


def bc(inputs):
    x, y = inputs[..., 0:1], inputs[..., 1:2]
    return x * (x - 1) * y * (y - 1)


def vpinn_residual(basis, gradient):
    return basis.v - basis.v_grad @ gradient(basis.integration_points).mT


def vpinn_loss(net, basis):
    r = basis.reduce(basis.integrate_linear_form(vpinn_residual, net.gradient))
    return (r**2).sum()


def square(**kw):
    import pytorch_fem_solver_tpu_torch as pt

    return pt.Basis(pt.MeshTri(pt.unit_square(**kw), device="cpu"), pt.ElementTri(1, 2))


def odd_square_mesh(unit_square):
    """``unit_square(n=5)`` less its last triangle: 49 cells, which divide
    neither 2 nor 4 ranks."""
    tri = dict(unit_square(n=5))
    tri["triangles"] = tri["triangles"][:-1]
    return tri


def odd_square():
    import pytorch_fem_solver_tpu_torch as pt

    return pt.Basis(pt.MeshTri(odd_square_mesh(pt.unit_square), device="cpu"),
                    pt.ElementTri(1, 2))


def fractures(nx, ny):
    import pytorch_fem_solver_tpu_torch as pt

    tri = pt.rectangle(nx, ny, x0=-1.0, x1=1.0, y0=0.0, y1=1.0)
    dfn = pt.FracturesTri([tri, tri], FRACTURES_3D, anchor_vertices_2d=ANCHORS, device="cpu")
    return pt.FractureBasis(dfn, pt.ElementTri(1, 2))


def two_fracture_network(h):
    import pytorch_fem_solver_tpu_torch as pt

    return pt.FractureNetworkBasis(
        pt.build_fracture_network([F1, F2], h=h, device="cpu"), pt.ElementTri(1, 2)
    )


def benchmark_network(h):
    import pytorch_fem_solver_tpu_torch as pt

    return pt.FractureNetworkBasis(pt.build_benchmark_network(h, device="cpu"),
                                   pt.ElementTri(1, 2))


def cube(n):
    import pytorch_fem_solver_tpu_torch as pt

    return pt.Basis(pt.MeshTet(pt.unit_cube(n), device="cpu"), pt.ElementTet(1, 2))


def cube_load(b):
    p = b.integration_points
    return (1.0 + p[..., 0:1] + p[..., 1:2] + p[..., 2:3]) * b.v


def _np(t):
    return t.detach().cpu().numpy()


def _solved(u, info):
    return {"u": _np(u), "it": int(info.iterations), "conv": bool(info.converged)}


# -- cases --------------------------------------------------------------------


def _pcg(V, form, mesh, method, **kw):
    from pytorch_fem_solver_tpu_torch import parallel

    local = V.integrate_bilinear_form_local(stiffness)
    b = V.integrate_linear_form(form)
    solver = {
        "pcg": parallel.solve_pcg_sharded,
        "ell": parallel.solve_pcg_sharded_ell,
        "bsr": parallel.solve_pcg_sharded_bsr,
    }[method]
    return _solved(*solver(V, local, b, mesh, return_info=True, **kw))


def _vpinn(V, mesh, arch, bc_):
    """Loss and group-averaged parameter gradients of the VPINN loss on the
    shard copy of V."""
    import torch
    import torch.distributed as dist

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.parallel import shard_basis_cells

    Vs = shard_basis_cells(V, mesh)
    net = pt.FeedForwardNeuralNetwork(*arch, boundary_condition_modifier=bc_, device="cpu")
    loss = vpinn_loss(net, Vs)
    loss.backward()
    world = mesh.size()
    grads = {}
    for name, p in net.named_parameters():
        # a parameter the loss does not reach (the output bias of a loss
        # on the input gradient) has no grad: JAX reports zeros
        g = torch.zeros_like(p) if p.grad is None else p.grad.clone()
        dist.all_reduce(g, group=mesh.get_group())
        grads[name] = _np(g / world)
    area = float(Vs.integrate_functional(lambda b: b.v).sum())
    return {
        "loss": float(loss), "grads": grads, "area": area,
        "shape": tuple(Vs.integration_points.shape),
        "per_cell": tuple(Vs.integrate_functional(lambda b: b.v).shape),
    }


def _benchmark_ell(mesh):
    """The h=0.3 network's sharded ELL solve beside the single-process ELL
    solve's count (``it_single``)."""
    V = benchmark_network(0.3)
    out = _pcg(V, unit_load, mesh, "ell", tol=1e-9)
    _, info = V.solve_iterative(V.integrate_bilinear_form_local(stiffness),
                                V.integrate_linear_form(unit_load), tol=1e-9, method="ell",
                                return_info=True)
    return {**out, "it_single": int(info.iterations)}


def sharding_cases(mesh):
    return {
        "pcg_square": lambda: _pcg(square(n=12), load, mesh, "pcg", tol=1e-13),
        "pcg_fractures": lambda: _pcg(fractures(8, 4), load, mesh, "pcg", tol=1e-13),
        "ell_fractures": lambda: _pcg(fractures(8, 4), load, mesh, "ell", tol=1e-13, max_k=6),
        "benchmark_ell": lambda: _benchmark_ell(mesh),
        "tet_ell": lambda: _pcg(cube(4), cube_load, mesh, "ell", tol=1e-13, max_k=16),
    }


def sharded_basis_cases(mesh):
    from pytorch_fem_solver_tpu_torch.ops.sparse import get_ell_structure
    from pytorch_fem_solver_tpu_torch.parallel import shard_basis_cells
    from pytorch_fem_solver_tpu_torch.parallel.sharding import _LAYOUT_CACHES, mesh_device

    def batched():
        V = fractures(5, 3)
        get_ell_structure(V)  # a layout cache on V, which the copy must drop
        Vs = shard_basis_cells(V, mesh)
        return {
            "device": str(mesh_device(mesh)),
            "caches": sorted(k for k in vars(Vs) if k in _LAYOUT_CACHES),
            "shapes": [tuple(a.shape) for a in (Vs.v_grad, Vs.integration_points, Vs._dx)],
            "area": float(Vs.integrate_functional(lambda b: b.v).sum()),
            "b": _np(Vs.integrate_linear_form(load)),
        }

    return {
        "training_step": lambda: _vpinn(square(n=8), mesh, (2, 1, 2, 8), bc),
        "pads_non_divisible": lambda: _vpinn(odd_square(), mesh, (2, 1, 1, 6), None),
        "batched_pads": batched,
    }


def sharded_bsr_pcg_cases(mesh):
    def legacy():
        V = square(max_area=0.5**9)
        return {
            "two_level": _pcg(V, generic_load, mesh, "bsr", tol=1e-12),
            "jacobi": _pcg(V, generic_load, mesh, "bsr", tol=1e-10, precondition="jacobi"),
        }

    return {
        "bsr_square": lambda: _pcg(square(max_area=0.5**9), load, mesh, "bsr", tol=1e-13),
        "bsr_square_jacobi": lambda: _pcg(
            square(max_area=0.5**9), load, mesh, "bsr", tol=1e-13, precondition="jacobi"
        ),
        "bsr_network": lambda: _pcg(two_fracture_network(0.2), unit_load, mesh, "bsr", tol=1e-13),
        "tet_bsr": lambda: _pcg(cube(4), cube_load, mesh, "bsr", tol=1e-13),
        "legacy": legacy,
    }


def sharded_bsr_cases(mesh):
    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.parallel import sharded_bsr_solver

    def solver(V, lf, tol):
        u, (it, res, conv) = sharded_bsr_solver(V, stiffness, lf, device_mesh=mesh, tol=tol)()
        u1, info1 = V.compiled_solver(stiffness, lf, tol=tol)()
        return {"u": _np(u), "it": it, "conv": bool(conv), "res": float(res),
                "u_compiled": _np(u1), "it_compiled": int(info1.iterations),
                "type": (type(it).__name__, res.dim(), conv.dim())}

    def square3(n):
        return pt.Basis(pt.MeshTri(pt.rectangle(n, n), device="cpu"), pt.ElementTri(1, 3))

    cases = {
        "benchmark_bsr": lambda: _pcg(benchmark_network(0.3), unit_load, mesh, "bsr", tol=1e-9),
        "solver_dfn": lambda: solver(benchmark_network(0.3), unit_load, 1e-10),
        "solver_square": lambda: solver(square3(24), sine_load, 1e-8),
        "rhs_replaced": lambda: _rhs_replaced(mesh),
    }
    if os.environ.get("FEM_TEST_SCALE"):
        cases["solver_1e5"] = lambda: solver(square3(320), sine_load, 1e-8)
    return cases


def _rhs_replaced(mesh):
    """``solve(b)`` with an assembled rhs equals the solve built with the
    linear form; a second call is bitwise the first."""
    from pytorch_fem_solver_tpu_torch.parallel import sharded_bsr_solver

    V = benchmark_network(0.3)
    u_lf, info = sharded_bsr_solver(V, stiffness, unit_load, device_mesh=mesh, tol=1e-10)()
    solve = sharded_bsr_solver(V, stiffness, device_mesh=mesh, tol=1e-10)
    b = V.integrate_linear_form(unit_load)
    u_b, info_b = solve(b)
    u_b2, _ = solve(b)
    return {"diff": float((u_lf - u_b).abs().max()), "it": (info[0], info_b[0]),
            "repeat_bitwise": bool((u_b == u_b2).all())}


def nonlinear_residual(b, u, ug):
    """-div((1 + u^2) grad u) = f with the manufactured sin sin solution."""
    pi = math.pi
    x, y = b.integration_points[..., 0:1], b.integration_points[..., 1:2]
    us = (pi * x).sin() * (pi * y).sin()
    ux = pi * (pi * x).cos() * (pi * y).sin()
    uy = pi * (pi * x).sin() * (pi * y).cos()
    f = -(2 * us * (ux**2 + uy**2) + (1 + us**2) * (-2 * pi**2 * us))
    return (1 + u**2) * (b.v_grad * ug).sum(-1, keepdim=True) - f * b.v


def nonlinear_residual_3d(b, u, ug):
    """The same with the sin sin sin solution on the unit cube."""
    pi = math.pi
    p = b.integration_points
    s = [(pi * p[..., i:i + 1]).sin() for i in range(3)]
    c = [(pi * p[..., i:i + 1]).cos() for i in range(3)]
    us = s[0] * s[1] * s[2]
    grad2 = ((pi * c[0] * s[1] * s[2]) ** 2 + (pi * s[0] * c[1] * s[2]) ** 2
             + (pi * s[0] * s[1] * c[2]) ** 2)
    f = -(2 * us * grad2 + (1 + us**2) * (-3 * pi**2 * us))
    return (1 + u**2) * (b.v_grad * ug).sum(-1, keepdim=True) - f * b.v


def mass(b):
    return b.v @ b.v.mT


def stokes_viscous(b):
    import torch

    return torch.einsum("...icd,...jcd->...ij", b.v_grad, b.v_grad)


def stokes_div(test_p, trial_u):
    import torch

    div = torch.einsum("...cc->...", trial_u.v_grad)
    return -(test_p.v[..., 0][..., :, None] * div[..., None, :])


def stokes_load(b):
    import torch

    pts = b.integration_points[..., 0, :]
    f = torch.stack([(math.pi * pts[..., 0]).sin(), pts[..., 1] ** 2], dim=-1)
    return (b.v * f[..., None, :]).sum(-1, keepdim=True)


def stokes_load_3d(b):
    f = b.v.new_tensor([1.0, 0.0, -0.5])
    return (f * b.v).sum(-1, keepdim=True)


def stokes_rectangle():
    """Taylor-Hood P2 x 2 / P1 on ``rectangle(9, 7)`` and its load."""
    import pytorch_fem_solver_tpu_torch as pt

    mesh = pt.MeshTri(pt.rectangle(9, 7), device="cpu")
    Vu = pt.VectorBasis(mesh, pt.ElementTri(2, 4))
    return Vu, pt.Basis(mesh, pt.ElementTri(1, 4)), Vu.integrate_linear_form(stokes_load)


def stokes_cube():
    """Taylor-Hood P2 x 3 / P1 on ``unit_cube(3)`` and its load."""
    import pytorch_fem_solver_tpu_torch as pt

    mesh = pt.MeshTet(pt.unit_cube(3), device="cpu")
    Vu = pt.VectorBasis(mesh, pt.ElementTet(2, 3))
    return Vu, pt.Basis(mesh, pt.ElementTet(1, 3)), Vu.integrate_linear_form(stokes_load_3d)


def _newton(V, residual, mesh, **kw):
    from pytorch_fem_solver_tpu_torch.parallel import sharded_newton_solver

    u, (it, res, conv) = sharded_newton_solver(V, residual, device_mesh=mesh, **kw)()
    return {"u": _np(u), "it": it, "conv": bool(conv), "res": float(res),
            "type": (type(it).__name__, res.dim(), conv.dim())}


def sharded_newton_cases(mesh):
    import pytorch_fem_solver_tpu_torch as pt

    def rectangle(n):
        return pt.Basis(pt.MeshTri(pt.rectangle(n, n), device="cpu"), pt.ElementTri(1, 3))

    kw = {"tol": 1e-12, "solve_tol": 1e-10}
    cases = {
        f"newton_{pc}": (lambda pc=pc: _newton(rectangle(40), nonlinear_residual, mesh,
                                               precondition=pc, **kw))
        for pc in ("jacobi", "two_level")
    }
    if os.environ.get("FEM_TEST_SCALE"):
        cases["newton_50k"] = lambda: _newton(rectangle(224), nonlinear_residual, mesh,
                                              tol=1e-10, solve_tol=1e-9,
                                              precondition="two_level")
    return cases


def _eigsh(V, mesh, k, **kw):
    from pytorch_fem_solver_tpu_torch.parallel import sharded_eigsh_solver

    vals, vecs, (rounds, change, conv) = sharded_eigsh_solver(
        V, stiffness, mass, k, device_mesh=mesh, tol=1e-9, **kw)()
    return {"u": _np(vecs), "vals": _np(vals), "it": rounds, "conv": bool(conv),
            "type": (type(rounds).__name__, change.dim(), conv.dim())}


def sharded_eigen_cases(mesh):
    import pytorch_fem_solver_tpu_torch as pt

    def square():
        return pt.Basis(pt.MeshTri(pt.unit_square(max_area=0.5**8), device="cpu"),
                        pt.ElementTri(1, 3))

    return {
        "eigsh_two_level": lambda: _eigsh(square(), mesh, 4),
        "eigsh_jacobi": lambda: _eigsh(square(), mesh, 4, precondition="jacobi"),
    }


def _stokes(make, mesh, again=False, **kw):
    from pytorch_fem_solver_tpu_torch.parallel import sharded_stokes_solver

    Vu, Vp, f = make()
    solve = sharded_stokes_solver(Vu, Vp, stokes_viscous, stokes_div, device_mesh=mesh, **kw)
    u, p, info = solve(f)
    out = {"u": _np(u), "p": _np(p), "it": info.outer_iterations,
           "conv": bool(info.converged), "inner_total": info.inner_total,
           "type": (type(info.outer_iterations).__name__, type(info.inner_total).__name__)}
    if again:  # a second right-hand side on the built solver
        u2, p2, _ = solve(2.0 * f)
        out.update({"u2": _np(u2), "p2": _np(p2)})
    return out


STOKES_KW = {"tol": 1e-10, "inner_tol": 1e-12}


def sharded_stokes_cases(mesh):
    """The two-level case, with the second right-hand side at 2 ranks. An
    inner PCG iteration is 4-5 collectives, each ~0.25 ms of CPU on 2 gloo
    ranks and ~0.5 ms on 4 (a rectangle solve is ~7,000 of them), so the
    Jacobi case has a spawn of its own (``sharded_stokes_jacobi``)."""
    return {"stokes_two_level": lambda: _stokes(stokes_rectangle, mesh, again=mesh.size() == 2,
                                                precondition="two_level", **STOKES_KW)}


def sharded_stokes_jacobi_cases(mesh):
    return {"stokes_jacobi": lambda: _stokes(stokes_rectangle, mesh, precondition="jacobi",
                                             **STOKES_KW)}


def sharded_tets_cases(mesh):
    """The tet cases of the three solvers (one spawn, one world size)."""
    kw = {"tol": 1e-12, "solve_tol": 1e-10}
    return {
        "newton_tet": lambda: _newton(cube(5), nonlinear_residual_3d, mesh,
                                      precondition="two_level", **kw),
        "eigsh_tet": lambda: _eigsh(cube(5), mesh, 3),
        "stokes_tet": lambda: _stokes(stokes_cube, mesh, tol=1e-9, inner_tol=1e-11,
                                      precondition="jacobi"),
    }


SUITES = {
    "sharding": sharding_cases,
    "sharded_basis": sharded_basis_cases,
    "sharded_bsr": sharded_bsr_cases,
    "sharded_bsr_pcg": sharded_bsr_pcg_cases,
    "sharded_newton": sharded_newton_cases,
    "sharded_eigen": sharded_eigen_cases,
    "sharded_stokes": sharded_stokes_cases,
    "sharded_stokes_jacobi": sharded_stokes_jacobi_cases,
    "sharded_tets": sharded_tets_cases,
}


def main(suite, rank, world, store, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from pytorch_fem_solver_tpu_torch import config
    from pytorch_fem_solver_tpu_torch.parallel import make_device_mesh

    config.set_default_dtype(torch.float64)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank, world_size=world
    )
    try:
        mesh = make_device_mesh(world)
        results = {}
        for name, case in SUITES[suite](mesh).items():
            try:
                results[name] = case()
            except Exception:  # every rank of a collective raises alike
                results[name] = {"error": traceback.format_exc()}
        with open(f"{out}.{rank}.pkl", "wb") as fh:
            pickle.dump(results, fh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
