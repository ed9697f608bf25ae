#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build the hand-written kernels from ``pytorch_fem_solver_tpu_torch/csrc``
   with nvcc for ``sm_90a`` (one nvcc per source, in parallel) and print the
   card's name and power limit;
2. K1 (P1 element kernel) against its plain PyTorch version on the h=0.03
   seven-fracture DFN's 214,988 cells, in float64 (1e-12 relative) and
   float32 (1e-5 relative to each output row's max magnitude: FMA
   contraction and operation order differ, so it cannot be bit-exact), two
   launches bitwise equal; the same on seeded triangles at T = 1, 255, 257
   and 1,001 (a tail block whose words do not fill whole 16-byte pieces)
   with the coordinates on and off a 16-byte boundary (one-word loads);
3. K2 (BSR SpMV) against its plain version on the h=0.03 assembled values
   and a seeded x, in float64 (1e-12 relative to ||y||) and float32 (1e-5),
   two launches bitwise equal; the stored and slot counts of both tiers,
   and the bytes the kernel streams beside the bound's (within 5%); the
   same comparison on the h=0.1 DFN for a narrow tier 1 (``max_b=4``), the
   default (8) and no tier 2 (``max_b=None``);
4. the main path, ``pytorch_fem_solver_tpu_torch/bench.py``, at h=0.03 in
   float32 on the card: 107,355 DOFs, PCG to a relative residual <= 1e-6 in
   <= 80 iterations, K1 and K2 launched on that run and K7 once (the
   aggregate-block M set-up's inverse), the solution within
   1e-4 of the same path in float64, the median of 5 timed repeats;
5. ``compiled_bsr_solver`` at h=0.03 in float32 agrees with phase 4 to 1e-4;
6. where the main path's time goes: ``PROFILED_SOLVES`` solves of phase 4's
   path under ``torch.profiler``, printing the wall and device time per
   solve, kernel launches per solve, device time by kernel and the device's
   idle share (1 - device / wall; one stream, so kernels do not overlap),
   against phase 4's unprofiled median as well, since the profiler slows
   the host; then the host-to-device copies (``Memcpy HtoD`` events) per
   solve after the first, on that path and through ``compiled_bsr_solver``:
   none, since the structure holds its gather tables on the device;
7. the fused PCG tail (``make_fused_pcg`` in the port's ``bench.py``, on
   phase 4's assembled values and aggblock preconditioner, f32 and f64):
   K3 (``agg_smooth_restrict``) and K4 (``coarse_prolong_dot``) against
   their plain versions on seeded vectors (f64 1e-12, f32 1e-5, relative to
   each output's max magnitude; ``rz`` relative to |rz|), and at gs=64 on
   a seeded table (the one-block-per-row K3), and at nc = ns = 67 (no
   multiple of 4: K4's one-word loads) with gs=32 and gs=5; two launches
   of K3 (all four outputs) and of K4 (z and rz) bitwise equal; K3 on
   seeded NON-symmetric blocks at ns = 1, 5 and 67 with ``inv_agg`` on and
   off a 16-byte boundary; the machine code of K3's warp kernels read back
   with cuobjdump (every global load before the fence and the products); their
   times beside plain, library and bound;
   the stock loop (``pcg_chunked``) against the fused one (``fused_pcg``)
   at ``tol=0.0, maxiter=30``, each captured in chunks of ``PCG_CHUNK``
   through a ``PCGGraphs`` of its own (5e-5 in f32, the tool's measure;
   1e-10 in f64); the kernels counted once a replay in a call of 100
   iterations; the device time per iteration issued of both loops from the
   profiler's trace of such a call (a call captures its own graph, so its
   wall is not the loop's), in turns, and of the fused one by kernel: K2,
   K3, K4, the dots, the p update and the scalar operations; and
   ``fused_pcg`` to 1e-6: residual <= 1e-6 in <= 80 iterations, within 1
   of phase 4's count (equal in f64), within 1e-4 of phase 4's solution,
   K2-K4 launched at least once per iteration;
8. K5 (the 2D P1 element kernel) against its plain version on the RVPINN
   mesh (unit square, n=64: 8,192 cells) and on the h=0.03 DFN's 214,988
   chart cells, with and without a seeded scale, in float64 (1e-12) and
   float32 (1e-5 relative to each row's max); the same on seeded triangles
   at T = 1, 255, 257 and 1,001 on and off a 16-byte boundary, two launches
   bitwise equal; a digest of its float32 output at the DFN size with and
   without the scale; its time there;
9. RVPINN training on the card at the benchmark's full size
   (``make_rvpinn()`` of the port's ``bench_vpinn.py``: N=64, width 15,
   depth 4, 50 epochs, float32): counts reset before the setup, K5 launched
   there (it builds the Gram), finite losses whose last is below the first
   through ``train()`` and through ``train_compiled(10)`` (within 1e-4
   relative of ``train()``: the card's scatter sums with atomics), the
   first 10 epochs within 1e-2 relative of a float64 run on the card, the
   s/epoch of both loops (``rvpinn_s_per_epoch`` line), and one profiled
   block of 10 epochs printing device time and launches per epoch and the
   idle share;
10. the two-fracture RVPINN loss of ``make_two_fracture(8)`` and one Adam
    step on the card in float32, within 1e-4 relative of the same port in
    float64 on the CPU;
11. K6 (row gather) on the gather probe's own inputs, equal to the tool's
    NumPy answer exactly (counts reset before it: the probe is K6's path),
    then at the h=0.03 SpMV shapes (x as (n_pad/8, 8), cols the BSR column
    table) in f32 and f64, and at k = 1, 3, 8 and 16 with x on and off a
    16-byte boundary, equal to ``x[cols]``; timed beside it;
12. every kernel K1-K6, ``torch.mv``, a ``copy_`` of as many bytes as K1
    moves and an empty window once more, each with the L2 flushed by a
    write (dirty lines) and by a read (clean lines); the stream figure of
    K1, K5, K6 and the copy (``stream_us``: the profiler's device duration
    per launch over back-to-back launches on rotating copies of the inputs
    that together exceed twice the L2, beside the events' figure over the
    same run); then the seconds each phase took;
13. the seven-fracture DFN RVPINN (``make_dfn_rvpinn(0.1)`` of the port's
    ``bench_vpinn.py``: 19,680 cells, 9,795 DOFs, float32): counts reset
    before its setup, whose FEM oracle (``solve_iterative`` on the BSR
    operator, aggregate two-level M) must reach a relative residual <= 1e-6
    with K2 launched at least once per PCG iteration and agree within 1e-4
    with a float64 oracle on the card; 20 epochs each through ``train()``
    and ``train_compiled(10)``, warm-started (the previous epoch's Gram
    iterate through ``training_state0``) and cold: finite losses, the last
    below the first, warm within 1e-3 relative of cold, ``train_compiled``
    within 1e-4 of ``train()``, the first 10 within 1e-2 of float64 on the
    card; the Gram PCG's forward and backward iteration counts (the backward
    from its ``a x`` seed below a solve from zero); the s/epoch of the four
    loops (``dfn_rvpinn_s_per_epoch`` line); one profiled warm block of 10
    epochs: device ms per epoch in the ELL matvec and the two-level apply
    (profiler ranges), the network's gemms, the scatters and Adam, launches
    and host reads (``Memcpy DtoH``) per epoch, and the idle share;
14. the estimator RVPINN (``make_posteriori_rvpinn()`` of the port's
    ``bench_vpinn.py``: N=64, the RVPINN loss plus the bulk residual and the
    interior-edge gradient jumps of the network, float32): counts reset
    before its setup, K5 launched once there (it builds the Gram); 50
    epochs through ``train()`` and 50 through ``train_compiled(10)``:
    finite losses, the last below the first, the loops within 1e-4
    relative; the first 10 within 1e-2 of float64 on the card; the weak
    and estimator shares of the first loss; the s/epoch of both loops
    (``posteriori_s_per_epoch`` line); one profiled block of 5 epochs:
    device ms per epoch in the network's gemms, the edge gather/scatter and
    the rest, launches and host reads per epoch, and the idle share;
15. the adaptive DFN loop (``adaptive_dfn`` of the port's ``bench.py``)
    on the seven-fracture network at h=0.03 (phase 1's mesh, which keeps
    its host triangulations): 3 levels, Dörfler marking at theta 0.5 and
    ``FractureNetworkMesh.refined`` between them, float32, PCG to 1e-6. Per
    level: cells, DOFs, iterations, the PCG residual (<= 1e-6), the true
    residual ``||b - A u|| / ||b||`` in float64, A assembled as a sparse
    COO matrix apart from the BSR layout and K2 (<= 1e-6 plus twice the
    float32 rounding scale ``eps32 || |A| |u| || / ||b||``), K2 launches (counts reset before each level;
    >= the iterations), the energy, ||eta|| and the marked cells, the host
    seconds of the refinement, the tables and the estimator, and the
    solve's wall ms (a second solve on the built tables); the cells grow at
    every level, the trace edges of every pair of fractures are the same in
    both on every refined level; at level 0 the energy is within 1e-4 and
    eta within 1e-4 (max relative) of a float64 level on the card at tol
    1e-10, and both etas give the same Dörfler marks, while a level solved
    only to 1e-2 (the control) fails both the residual and the eta bound;
16. the higher-order compiled solves (``p3_poisson`` and ``dfn_p2_solve``
    of the port's ``bench.py``): P3 on ``rectangle(105, 105)`` (22,050
    cells, 99,856 DOFs; ``tools/exp_solver_tier.py``'s "p3" phase, the sine
    problem) and P2 on phase 13's h=0.1 network (the DFN stiffness and unit
    load), each in float32 with a float64 twin on the card, PCG to 1e-6:
    counts reset before the solve, K2 launched once per iteration issued
    (``_issued``: held ones too), once for the start and once in the
    solver's warm-up; the PCG residual; the true residual in float64 against a
    COO operator (phase 15's bound); f32 within 1e-4 of f64 beyond twice
    the float32 floor (the float32 element matrices solved in float64 to
    1e-12: 8.7e-4 at P3, so no float32 solve gets within 1e-4 there), a
    float32 solve to 1e-2 rejected by that bound where the floor is below
    1e-4 (at P3 it lies at the floor too: reported, with the float32 solves
    at 1e-3, 1e-4 and 1e-5 beside it), the f32 iterations at
    most 3 above the f64 count and within 1 of the same solve with the
    plain SpMV; K2 against its plain version on each structure (most
    block-rows of the P3 structure spill into tier 2), two launches bitwise
    equal; the median wall of 5 solves, one profiled solve (device ms by
    kernel, K2's us per launch beside its byte bound for the structure, the
    idle share) and the host seconds of the basis and the tables; on the
    network every trace edge keeps a single midpoint DOF;
17. the patch RVPINN (``make_patches_rvpinn`` of the port's
    ``bench_vpinn.py``, ``examples/example_patches.py``) at the example's
    64 patches and at 4,096 (``levels=6``), float32, 50 epochs through
    ``train()`` and ``train_compiled(10)``: K5 launched in the setup (the
    two batched Grams) and never per epoch, finite decreasing losses, the
    loops within 1e-4, the first 10 epochs within 1e-2 of float64 (64
    patches), the K5 Grams against ``integrate_bilinear_form`` +
    ``reduce`` in float64 (1e-12), K5 against its plain version on the
    patch cells; s/epoch, launches per epoch and the idle share at both
    sizes (``patch_rvpinn_s_per_epoch`` line);
18. the tetrahedral tier (``tet_poisson``, ``tet_solve`` and
    ``adaptive_tet`` of the port's ``bench.py``), float32 with float64
    twins on the card, PCG to 1e-6: P1 on ``unit_cube(64)`` (1,572,864
    tets, 274,625 DOFs; ``tools/exp_tet_scale.py``'s largest rung below the
    2M-cell guard, about 150 MB of float32 BSR values against the 50 MB L2)
    and P2 on ``unit_cube(24)`` (82,944 tets, 117,649 DOFs;
    ``examples/example_poisson_3d.py`` at ``FEM_ORDER=2``), each with
    phase 16's checks (the P1 structure's counts checked as well, and at
    both the bytes K2 streams within 5% of the bound's), the float32 solve
    to 1e-2 as the only control; then 4 levels of the adaptive loop of
    ``examples/example_adaptive_3d.py`` from ``fichera_corner(24)``
    (580,608 tets, 89,999 inner DOFs; theta 0.4): per level cells, DOFs,
    iterations, the PCG and the true residual (phase 15's bound), K2
    launches (>= the iterations), the host seconds of the mesh, the
    refinement, the tables and the estimator and the solve's wall ms; the
    cells grow; at level 0 the energy and eta within 1e-4 of a float64
    level at tol 1e-10, the Dörfler marks of both equal outside the tie
    band of the threshold (cells whose estimate the domain's symmetry
    makes equal are ordered by rounding; the count that differ is
    printed), and a level solved to 1e-2 failing both bounds;
19. the 3D RVPINN (``make_vpinn_3d`` of the port's ``bench_vpinn.py``,
    ``examples/example_vpinn_3d.py``): at the example's N=8, 10 epochs of
    ``train()`` in float32 and float64 on the card for both Gram methods
    (finite losses, the last below the first, within 1e-2); at N=32
    (196,608 tets, 29,791 inner DOFs), float32, for ``"cholesky"`` and
    ``"pcg"``: 20 epochs through ``train()`` and through
    ``train_compiled(10)`` (finite, decreasing, within 1e-4 of each other),
    s/epoch, the Gram PCG's iterations per epoch, one profiled block of 10
    epochs (device ms, launches and host reads per epoch, idle share), and
    no hand kernel launched (the Gram applies are the library's triangular
    solves or the plain ELL matvec); then the Cholesky run under
    ``reduce_on_plateau`` (factor 0.5, patience 2, rtol 1e-2): its scale
    drops in both loops, the loops within 1e-4, and the scheduler adds no
    host read per epoch (a ``vpinn_3d_s_per_epoch`` line);
20. the chunked tet solve: ``tet_poisson(80)`` in float32 (3,072,000 tets,
    493,039 inner DOFs; ``tools/exp_tet_scale.py``'s n=80 rung) through
    the chunked default of ``compiled_bsr_solver`` (12 chunks of 2^18
    cells), with phase 16's checks and a median of 3 solves; the structure
    against the host's count, 68 +- 3 iterations (the JAX package's) and
    within 3 of float64; the same solve with ``chunk_cells=0`` on the same
    basis and tables: equal iterations, values within the float32 rounding
    of the summation order (2 x 49 eps32 of each slot's sum of |terms|),
    solutions closer than the float32 solve is to float64, its true
    residual within phase 15's bound; the peak device memory of both
    solves and of both assemblies alone, and the host seconds of the
    mesh, the basis, the tables and the chunk tables (a
    ``tet_chunked_solve`` line);
21. linear elasticity through ``VectorBasis.compiled_solver`` (the
    rigid-body-mode two-level M; ``elasticity_2d`` and ``elasticity_3d``
    of the port's ``bench.py``), float32 with float64 twins on the card,
    PCG to 1e-6: ``examples/example_elasticity.py``'s plate on
    ``unit_square(n=256)`` (130,050 inner DOFs) and
    ``examples/example_elasticity_3d.py``'s bubble on ``unit_cube(48)``
    (663,552 tets, 311,469 inner DOFs), each with phase 16's checks (a
    float32 solve to 1e-2 as the only control, which must fail both the
    true-residual bound and the f32-vs-f64 bound, the plate's 1e-5 instead
    of 1e-4), the inner DOFs and the
    coarse space (g, na, m) as counted on the host (96, 1,356, 3 and 512,
    609, 6), the host seconds of the RBM structure, the tier-2 share of the
    stored blocks and the peak device memory of a solve; on the plate
    ``solve_iterative(precondition="rbm")`` within 1 iteration and 1e-4 of
    the compiled solve, the RBM count below 0.55 x the Jacobi count and
    the L2 error against the
    exact displacement falling as h^2 (the n=128 plate's over the n=256
    one's in (3.3, 4.8)); a JSON ``elasticity_solves`` line;
22. compiled Newton (``newton_dfn`` and ``newton_elasticity`` of the
    port's ``bench.py``, ``precondition="auto"``), float32: k(u) = 0.5 +
    u^2 on phase 1's h=0.03 network (107,355 DOFs) to 2e-4 and the
    strain-stiffening plate on ``unit_square(n=128)`` (32,258 inner DOFs;
    the rigid-body-mode M rebuilt from each step's Jacobian) to 2e-6 (the
    stopping test is absolute below an initial norm of 1; each tolerance
    lies above float32's floor of its residual): counts reset
    before each, converged, K2 launched twice per BiCGStab iteration and
    once per step (its start), the Newton steps within 1 of a float64 twin
    on the card at 1e-10 and the solution within 1e-4 of it, K2 against
    its plain version on the Newton structure (full entry slots) with the
    float64 twin's Jacobian values at its first step and at its solution
    (not symmetric), the eager
    ``solve_newton`` in as many steps and within 1e-4; on the network the
    nonlinear maximum below the linear solve's; Newton steps, BiCGStab
    iterations per step, the wall per step and one profiled solve (device
    ms by kernel, launches, the idle share; a JSON ``newton_solves``
    line);
23. the mixed-precision refined solve (``refined_dfn`` and
    ``refined_elasticity`` of the port's ``bench.py``, ``compiled_refined``
    on a float64 basis): ``tools/exp_refine_tpu.py`` on phase 1's h=0.03
    network (stiffness and unit load, float32 PCG stages to 1e-6 with the
    aggregate-block M) and the explicit-rhs vector case of the JAX
    package's ``tests/test_refine.py`` on ``rectangle(256, 256)`` (the
    vector Laplacian, stages to 1e-5, the rigid-body-mode M), each with 2
    passes and with none (the control): counts reset before each solve, K2
    launched sum(inner iterations + 1) times in float32 and 1 + passes
    times in float64 (counted by dtype as well); with 2 passes the last
    true float64 residual below 1e-11, ``converged``, and the solution
    within 1e-9 (max norm, relative) of the card's float64
    ``compiled_bsr_solver`` at 1e-12, which the control must fail, by more
    than 10 x the refined error; a float32 right-hand side refused; K2
    against its plain version on the refined values in float64 and
    float32; per case and pass count the inner iterations per stage, the
    true residuals, the median wall of 5 solves (in turns) and one
    profiled solve (device ms, launches, host reads, the idle share; a
    JSON ``refined_solves`` line);
24. the generalized eigensolvers (``eigsh_square``, ``eigsh_dfn`` and
    ``eigsh_elasticity`` of the port's ``bench.py``, ``compiled_eigsh``),
    float32 with float64 LOBPCG twins at 1e-9 on the card:
    ``tools/exp_solver_tier.py``'s "eigsh" phase (``rectangle(316, 316)``,
    P1, 100,489 DOFs, the 6 smallest Laplace modes to a relative change of
    1e-5, inner solves to 1e-6) by LOBPCG and by subspace iteration, and
    LOBPCG on phase 1's network and on the elastic modes of the JAX
    package's ``tests/test_eigen.py`` (mu 1, lam 1.5) on phase 22's
    ``unit_square(n=128)`` (to 1e-4, held within 1e-3 of float64: the
    float32 floor of the method there, ~2e-4; at n=256 it stalls near
    1e-3): counts reset before each, converged, finite,
    ascending, max |X^T M X - I| <= 1e-4, K2 launched 2 m + 6 m x rounds
    times by LOBPCG (m = 9, the block width) and 3 m per round plus every
    inner PCG's iterations + 1 by subspace iteration, the eigenvalues
    within 1e-4 (relative; the elastic modes 1e-3) of the float64 twin's,
    on the square the two
    methods within 1e-4 of each other and a LOBPCG stopped after 3 rounds
    (the control) failing the f32-vs-f64 bound; K2 against its plain
    version on the eigen structure (full entry slots) with the stiffness
    and the mass; rounds, K2 launches per round, the median wall, and one
    profiled solve (device ms, launches and host reads per round, the idle
    share; a JSON ``eigsh_solves`` line);
25. Stokes (``compiled_stokes_solver`` through ``stokes_problem`` and
    ``stokes_solver_of`` of the port's ``bench.py``):
    ``tools/exp_stokes_breakdown.py``'s Taylor-Hood P2-P1 problem on
    ``rectangle(115, 115)`` (106,722 velocity and 13,456 pressure DOFs),
    its float64 truth on the card (tol 1e-9, inner 1e-11, f-solve and
    recovery 1e-10) and its configurations in float32 at ``inner_maxiter``
    400: ``base``, ``aggcomp_floor3max1`` (the TPU campaign's
    recommendation), ``scalar`` (``a_scalar_form``: ``pcg_cols`` on the
    scalar operator, K2 once per component column), ``aggcomp_k8`` (eight
    fixed inner iterations, the control) and ``minres``: counts reset
    before each first solve, K2 launched as the code implies (the sum over
    the inner PCG calls of iterations + 1, twice that on the scalar path;
    MINRES iterations + 1 + refreshes + 1 + the recovery's iterations + 1);
    converged (the control and MINRES, whose float32 flag is false as the
    JAX package's is on IEEE float32, reported); the velocity's relative
    L2 error from the truth: base within 2e-4, the other schedules and
    MINRES within 1.5 x base's, which the control must fail; max |B u| /
    max |u| within 1e-5 (float64 1e-9); the pressure's lumped-mass mean
    zero to roundoff; K2 against its plain version through
    ``bsr_matvec_cols`` in float64 on the vector and the scalar A values;
    per configuration the median wall of 3 solves and one profiled solve of
    another right-hand side (no host-to-device copy; device ms, idle
    share, launches and host reads per outer iteration, K2's us per
    launch; a JSON ``stokes_solves`` line).
26. the remaining scalar preconditioners and the reduced-precision knobs:
    ``make_bsr_solve(precond=...)`` of the port's ``bench.py`` (the
    repo-root ``bench.py``'s ``BENCH_PRECOND`` names) on phase 1's network
    for jacobi, two_level, aggblock, affine, smoothed, mult, mult3,
    three_level and auto, and aggblock, two_level, three_level and mult
    with bf16 operands, float32 against each configuration's float64 twin:
    converged to 1e-6, at most the float64 count + 3 iterations, within
    1e-4 + 2 x the float32 floor of the float64 solution (the float32
    affine M, whose coarse inverse loses its near-null directions in
    float32, within 5e-3 and its 1e-4 distance reported), K2 launched
    exactly (iterations issued + 1 + 1 warm-up) x (1 + 2 for the cycles
    and the smoothed M) + 12 for ``omega="auto"`` (``_k2_rule``: the
    card's ``bsr_pcg`` issues whole chunks of CUDA-graph iterations); per
    configuration the median wall of 3, one profiled solve (device ms, idle share, K2's us per launch) and the
    distance from the float64 aggblock solution; aggblock (float32 and
    bf16 operands), mult and three_level at h=0.02 (the host seconds of
    its mesh; bf16 operands and mult reported if they do not converge in
    600); K2's bf16-values instantiation against its plain version on the
    network's and ``unit_cube(64)``'s values (float32 x within 1e-6 of
    max |y|, float64 x 1e-12, bitwise repeatable, counted under
    ``bsr_spmv_bf16``, float16 values refused) and its time behind the
    write flush against its byte bound; ``compiled_bsr_solver(values_dtype=
    torch.bfloat16)`` at ``unit_cube(64)`` and on the network beside
    float32 (every PCG product through the bf16 kernel, the solution more
    than 1e-5 from float32's); ``solve_iterative(precondition=
    "mult_two_level")`` on the h=0.1 network (fewer iterations than
    two_level, K2 as the cycle implies) and the scipy smoothed M of
    ``build_smoothed_two_level`` on its ELL operator (fewer iterations than
    Jacobi); ``probe`` of 100,000 seeded points after a P1 solve on
    ``unit_square(256)``, within 1e-5 of max |ref| of the float64 CPU
    probe (a JSON ``preconditioners_and_reduced_precision`` line).
27. the row-sharded solve and the ``utils`` on a world-size-1 NCCL group
    (a FileStore in a temporary directory, no network; destroyed at the
    end): ``sharded_bsr_solver`` on phase 1's network in float32 against
    ``compiled_bsr_solver``: converged, within 2 iterations of it (the JAX
    package's bound), within 1e-4 of its solution and within 1e-4 + 2 x
    its float32 floor of the float64 solution (phase 26's rule), K2
    launched (iterations + 1) times on the rank's block rows against the
    gathered iterate; both solves timed with ``StepTimer`` (median of 5)
    and one sharded solve profiled (device ms, idle share); one solve's
    Chrome trace written by ``trace()`` and found to name ``bsr_spmv``;
    ``probe_device`` under an armed ``Watchdog``; the solution written by
    ``write_vtk`` and its point count read back; K2 on the real block-row
    slices of a 2-shard plan of the network against its plain version
    (float64 1e-12, float32 1e-5, bitwise repeatable), shard 0's time
    beside plain, a CSR ``torch.mv`` of its rows and its bound (a JSON
    ``sharded_bsr`` line; the kernels line's K2 carries the ``row_slice``
    figures and the sharded solve's launches).
28. the sharded Newton, eigen and Stokes solvers on another world-size-1
    NCCL group, float32, each under an armed ``Watchdog`` beside its
    compiled twin of this run: ``sharded_newton_solver`` on phase 1's
    network with ``bench.dfn_residual`` to 2e-4 (``"two_level"``) in
    phase 22's Newton steps within 1 and within 1e-4 of phase 22's float64
    solution; ``sharded_eigsh_solver`` on the network (k=6, phase 24's
    tolerance) within 1e-4 of phase 24's float64 eigenvalues,
    max |X^T M X - I| <= 1e-4 (rounds reported: float32 round counts vary);
    ``sharded_stokes_solver`` (``"two_level"``, base's tolerances) on phase
    25's float32 problem within 1.5 x base's velocity error from phase
    25's float64 truth, max |B u| / max |u| <= 1e-5. Each: counts reset
    before its first solve, K2 launched on the rank's rows as its loop
    implies (2 x inner + 1 per Newton step, 2 m + 6 m x rounds, inner_total
    + outer + 3), no call of the plain SpMV; the median wall of 3 (the
    counted solve and two more) and one profiled solve (device ms, idle
    share, launches, host reads) beside the twin's (a JSON
    ``sharded_solvers`` line).
29. K7 (``batched_small_inv``, the batched Gauss-Jordan inverse) on seeded
    SPD batches at the benchmark cells' aggregate blocks, (4,072, 64, 64)
    and (3,908, 64, 64), at (231,459, 8, 8), and through its shared-memory
    kernel at (1,024, 160, 160) and (1,024, 192, 192) (the sharded
    smoother's gs above 128; float64 only at 160, the larger block does not
    fit), each with one all-zero block pinned to the identity: one launch a
    call, two launches bitwise equal, the pinned block exactly the
    identity, float64 within 1e-12
    (relative Frobenius, each matrix) of the plain loop and float32 within
    twice the plain loop's error against the float64 inverse plus n
    float32 ulps (``tests/test_torch_small_inv.py``'s bounds); its time
    behind both flushes beside the plain loop's, ``torch.linalg.inv``'s
    and its bound.
30. K8 (``bsr_add_pairs_symmetric``'s scatter-add, ``csrc/pair_scatter.cu``)
    at the benchmark cells' shapes on ``kuhn_cube(64)`` (1,572,864 tets):
    vector P1 (n_loc 12, the elasticity cell) and scalar P1 (n_loc 4, the
    cube cell), element matrices of a Lame or Laplace form scaled by a
    seeded log-normal factor a cell; the structure's ``n_values``, the share
    of pairs on the sink and the byte bound (the 32-byte sectors of the
    element matrices that hold an upper-triangle word, the slots, and a
    read and a write of each 32-byte sector of the values that a kept pair
    adds into); one launch a call, the sink left 0, float32 within m eps32
    of each slot's sum of absolute terms against the stock path in float64
    (m the most adds into one slot); its time behind the write flush beside
    the stock path's (the pairs copied out and ``index_add_``) and
    ``index_add_``'s alone, and the times of the rest of the assembly's
    scatter span: the zeroed buffer, the mirror completion and the load's
    scatter. The load's scatter (``_scatter_drop``, K8's flat entry) of
    seeded log-normal element loads into the padded vector is held the same
    way against ``index_add_`` in float64, one launch, its sink 0, and
    timed beside ``index_add_`` of the same loads.

To compare two builds of a kernel, run this script from each checkout in
turns within one boot of one machine and card (copy this file into the older
checkout): phases 2 and 8 print digests of K1's and K5's float32 output at
the benchmark shape, so equal digests mean bitwise equal results.

The last three lines are the card line, the kernels JSON line and the
``{"ok": true, ...}`` line. Kernel times use CUDA events around single
launches with the 50 MB L2 flushed before each (the PCG loop streams more
than L2 between SpMVs) and the card held busy while the host enqueues the
launch, median of the repeats. The flush is a write of 128 MB, which leaves
the L2 full of dirty lines that the timed kernel's loads have to evict; the
``flush="read"`` times of phase 7 leave clean lines instead, as the PCG loop
does, and the empty window says what the two events cost by themselves.
That window (about 3 us) is more than a small kernel's bound, so the
kernels line also carries the stream figure (``stream_us``) of the element
and gather kernels, which holds no event pair.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

H = 0.03
EXPECTED_DOFS = 107_355
MAX_ITERATIONS = 80
TOL = 1e-6
SEED = 0
TIMED_REPEATS = 5
PROFILED_SOLVES = 3
KERNEL_REPS = 30
FIXED_ITERS = 30  # the tool's fused-vs-stock check
LOOP_ITERS = 100  # the tool's PROF_REPS: graphed iterations per timed run
FUSED_VS_STOCK = 5e-5
# device cycles (about 0.25 ms at the H100's 1.98 GHz boost) the card spins
# before each timed launch, so the host's enqueue of the launch falls inside
# the spin and not inside the timed window
SPIN_CYCLES = 500_000
DEVICE = "cuda"  # where phases 7-11 make their inputs

# H100 SXM data sheet: HBM3 rate and the non-tensor-core float32 peak (the
# table in the on-chip measurement notes); both assume the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# K1 arithmetic per cell, counted from csrc/p1_element.cu: 9+3 edge
# differences, 9 for the cross product, 5+1 for the norm and sqrt, 1+1 for
# area and 1/(4A), 6 dot products of 6 operations, 1 for the load
K1_FLOPS_PER_CELL = 66
# K5 arithmetic per cell, counted from csrc/p1_element.cu: 4 edge
# differences, 3 for det, 1 for 1/det, 2 for the area, 10 for the six
# gradient components, 6 entries of 4 operations, 1 for the load
K5_FLOPS_PER_CELL = 45
RVPINN_N = 64
RVPINN_BLOCK = 10
TWO_FRACTURE_N = 8
DFN_H = 0.1  # the DFN RVPINN's full size: 19,680 cells, 9,795 DOFs
DFN_SIZE = (19_680, 9_795)
DFN_BLOCK = 10
# ranges put around the Gram PCG's operator and preconditioner for phase
# 13's profiled block, and buckets of the rest of an epoch's device time by
# kernel name (first match wins)
DFN_RANGES = ("gram PCG: ELL matvec", "gram PCG: two-level apply")
DFN_BUCKETS = (
    ("network gemms", ("gemm", "gemv", "xmma", "cutlass", "cublas")),
    ("scatters (index_add)", ("indexFunc", "index_add", "scatter")),
    ("Adam", ("multi_tensor", "foreach", "adam", "Adam")),
)

POSTERIORI_PROFILED = 5  # epochs of phase 14's profiled block
# buckets of phase 14's device time by kernel name (first match wins); the
# gather/scatter bucket holds the edge traces' gather of the network's nodal
# values (advanced indexing) and its backward (an accumulating index_put)
POSTERIORI_BUCKETS = (
    ("network gemms", ("gemm", "gemv", "xmma", "cutlass", "cublas")),
    ("edge gather/scatter", ("index_elementwise", "indexing_backward", "index_put",
                             "scatter_gather", "gather_kernel")),
)
ADAPTIVE_LEVELS = 3  # 2 refinements of the h=0.03 benchmark network
ADAPTIVE_THETA = 0.5
# ||b - A u|| / ||b|| of a float32 level is held to TOL plus this many
# times its float32 rounding scale, eps32 || |A| |u| || / ||b||: the float64
# solution rounded to float32 already leaves a fifth of that scale, and the
# float32 PCG stops near 0.9 of it (PERF.md, phase 15)
ADAPTIVE_ROUNDING = 2.0
ADAPTIVE_ETA_TOL = 1e-4  # max |eta32 - eta64| / max eta64 at level 0
ADAPTIVE_CONTROL_TOL = 1e-2  # a level-0 solve that both bounds must reject

EDGE_K1_CELLS = (1, 255, 257, 1001)  # K1's and K5's edge sizes
EDGE_K3_ROWS = (1, 5, 67)
EDGE_K6_K = (1, 3, 8, 16)
L2_BYTES = 50 * 2**20
# device cycles spun per launch queued behind the spin of a stream figure
# (about 0.5 ms each: several times what the host takes to enqueue one)
STREAM_SPIN_CYCLES = 1_000_000
STREAM_ATTEMPTS = 4
P3_N = 105  # tools/exp_solver_tier.py's "p3" phase: rectangle(105, 105), ElementTri(3, 5)
P3_SIZE = (22_050, 99_856)  # its cells and DOFs
P2_DFN_SIZE = (19_680, 39_267)  # cells and P2 DOFs of the h=0.1 benchmark network
HIGHER_ORDER_REPEATS = 5
ITER_GAP = 3  # the f32 iteration count at most this many above the f64 count
F32_VS_F64 = 1e-4  # f32 vs f64 solution, beyond twice the float32 operator floor
LADDER_TOLS = (1e-2, 1e-3, 1e-4, 1e-5)  # looser f32 solves; the first is the control
PATCH_LEVELS_DEEP = 6  # 4,096 patches, 16,384 cells
PATCH_BLOCK = 10
# phase 18: tools/exp_tet_scale.py's largest rung below 2M cells, where
# compiled_bsr_solver turns to chunked assembly, its cells and DOFs, and the P1 structure there (inner
# DOFs, block-rows, tier-1 width, spilled block-rows, tier-2 width, stored
# blocks): about 150 MB of float32 values, three times the L2
TET_N = 64
TET_SIZE = (1_572_864, 274_625)
TET_STRUCTURE = (250_047, 31_264, 24, 4_216, 16, 584_266)
TET_P2_N = 24  # examples/example_poisson_3d.py at FEM_ORDER=2
TET_P2_SIZE = (82_944, 117_649)
FICHERA_N = 24  # examples/example_adaptive_3d.py's loop on fichera_corner(24)
FICHERA_SIZE = (580_608, 103_825, 89_999)  # level 0: cells, vertices, inner DOFs
FICHERA_LEVELS = 4
FICHERA_THETA = 0.4  # the example's
# phase 19: examples/example_vpinn_3d.py at its default FEM_N (3,072 tets,
# 343 inner DOFs) and at the card's full-width rung, N=32: its cells and
# inner DOFs (983,040 quadrature points; the dense float32 Gram 3.5 GB)
VPINN3D_SMALL = 8
VPINN3D_FULL = 32
VPINN3D_SIZE = (196_608, 29_791)
VPINN3D_EPOCHS = 20
VPINN3D_BLOCK = 10
# the plateau run: the epochs improve by about 1e-3 of the loss each, so the
# optax default rtol (1e-4) would never cut the scale in 20 epochs
VPINN3D_PLATEAU = {"factor": 0.5, "patience": 2, "rtol": 1e-2}
# phase 20: tools/exp_tet_scale.py's unit_cube(80) rung through the chunked
# default of compiled_bsr_solver (2^18 cells per chunk): cells and DOFs, the
# structure counted on the host beforehand (inner DOFs, n_pad, block-rows,
# B, spilled block-rows, B2, value slots with padding) and the JAX
# package's iterations there (docs/performance.md, 3D scale table)
CHUNK_N = 80
CHUNK_SIZE = (3_072_000, 531_441)
CHUNK_STRUCTURE = (493_039, 493_056, 61_632, 24, 12_936, 20, 111_224_832)
CHUNK_CELLS = 1 << 18
CHUNK_JAX_ITERATIONS = 68
CHUNK_REPEATS = 3
# terms a BSR slot of the P1 tet operator sums at most: a vertex lies in 24
# tets of unit_cube(n), and the mirror completion adds the partner's
SLOT_TERMS = 48
# phase 21: linear elasticity, mu=1, lam=2, through VectorBasis.compiled_solver
# (the rigid-body-mode M): examples/example_elasticity.py's plate at
# unit_square(n=256) (ElementTri(1, 4)) and examples/example_elasticity_3d.py's
# bubble at unit_cube(48) (ElementTet(1, 2)). Cells, DOFs, inner DOFs and the
# coarse space (g, na, m) that default_affine_aggregate_size gives at their
# n_pad (130,176 and 311,808), counted on the host beforehand
ELAST_2D_N = 256
ELAST_2D_SIZE = (131_072, 132_098)
ELAST_2D_INNER = 130_050
ELAST_2D_COARSE = (96, 1_356, 3)
ELAST_2D_HALF = 128  # the plate whose L2 error over the n=256 one's is in L2_RATE
L2_RATE = (3.3, 4.8)  # second order, the JAX package's tests/test_elasticity.py bounds
RBM_VS_JACOBI = 0.55  # RBM iterations below this share of Jacobi's (the same test)
ELAST_3D_N = 48
ELAST_3D_SIZE = (663_552, 352_947)
ELAST_3D_INNER = 311_469
ELAST_3D_COARSE = (512, 609, 6)
ELAST_REPEATS = 3
# the control solve, held against both the true-residual bound and the
# f32-vs-f64 bound. On the plate the rigid-body-mode PCG's error falls far
# faster than its residual, so a solve to 1e-2 lands 6.9e-5 from float64,
# inside the generic 1e-4: the plate's bound is 1e-5, ten times its sound
# float32 solve's 1.1e-6 and seven times below that control (H100 runs of
# this script)
ELAST_CONTROL_TOL = 1e-2
ELAST_2D_F32_VS_F64 = 1e-5
# phase 22: compiled Newton in float32 (the examples' 1e-10 is out of
# float32's reach), float64 twins on the card at NEWTON_TOL_64:
# examples/example_nonlinear_dfn.py on phase 1's h=0.03 network and the
# strain-stiffening residual of the JAX package's tests/test_newton.py on
# unit_square(n=128), ElementTri(1, 3), both with precondition="auto". The
# stopping test is res <= tol * max(1, res0), absolute for res0 < 1, and
# each float32 tolerance sits between float32's floor and the residual of
# the step before the last (the CPU's float32 and float64 runs): on the
# network (res0 0.312) the norms run 0.19, 0.10, 4.0e-3, then 5.5e-5 at the
# floor (3.8e-5 to 5.5e-5: at 1e-5 the compiled rule stalls after 9 steps);
# on the plate (res0 0.0082) 6.0e-6 after the first step (the solution
# 1.2e-4 from float64 there), then the floor, 6.4e-7
NEWTON_TOL_DFN = 2e-4
NEWTON_TOL_PLATE = 2e-6
NEWTON_TOL_64 = 1e-10
NEWTON_ELAST_N = 128
NEWTON_ELAST_INNER = 32_258
NEWTON_REPEATS = 3
# phase 23: the refined solve of tools/exp_refine_tpu.py on phase 1's h=0.03
# network (a float64 basis; float32 PCG stages to 1e-6, 2 passes) and the
# explicit-rhs vector case of the JAX package's tests/test_refine.py (the
# vector Laplacian, stages to 1e-5) on rectangle(256, 256), the plate's
# size. The bounds are that test's: the last true residual below 1e-11, the
# solution within 1e-9 (max norm) of the float64 solve (compiled_bsr_solver
# at 1e-12 on the card), which the refine=0 control must fail by 10x
REFINE_PASSES = 2
REFINE_TOL32 = 1e-6
REFINE_ELAST_N = 256
REFINE_ELAST_TOL32 = 1e-5
REFINE_RESIDUAL = 1e-11
REFINE_VS_F64 = 1e-9
REFINE_F64_TOL = 1e-12
REFINE_REPEATS = 5
# phase 24: tools/exp_solver_tier.py's "eigsh" phase: rectangle(316, 316),
# P1 ElementTri(1, 3) (100,489 DOFs), the smallest 6 Laplace modes to a
# relative eigenvalue change of 1e-5, inner solves to 1e-6, both methods;
# LOBPCG on phase 1's network and on the elastic modes of the JAX
# package's tests/test_eigen.py (mu 1, lam 1.5, vector mass). Float64
# twins by LOBPCG at 1e-9 on the card; a LOBPCG stopped after 3 rounds is
# the control of the f32-vs-f64 bound. The elastic modes run on phase 22's
# unit_square(n=128) (32,258 inner DOFs) to 1e-4 and are held within 1e-3
# of float64: float32 LOBPCG (the JAX package's as well) stops improving at
# 1.9-2.0e-4 from float64 there, whatever the tolerance (the CPU's float32
# runs of both packages, 73 rounds at 1e-5, 19 at 1e-4), and at the
# plate's n=256 it stalls near 1e-3 (change 4.7e-4 after 200 rounds on an
# H100, 7.9e-4 from float64), while at n=128 the float32 Rayleigh quotients
# of the float64 modes lie within 2e-6 of theirs (CPU)
EIGSH_N = 316
EIGSH_DOFS = 100_489
EIGSH_K = 6
EIGSH_TOL = 1e-5
EIGSH_SOLVE_TOL = 1e-6
EIGSH_F64_TOL = 1e-9
EIGSH_VS_F64 = 1e-4  # max relative eigenvalue difference, f32 vs f64 and method vs method
EIGSH_ORTHO = 1e-4  # max |X^T M X - I| of the float32 eigenvectors
EIGSH_CONTROL_ROUNDS = 3
EIGSH_REPEATS = 3
EIGSH_SUBSPACE_REPEATS = 2
EIGSH_ELAST_N = 128
EIGSH_ELAST_TOL = 1e-4
EIGSH_ELAST_VS_F64 = 1e-3
# phase 25: tools/exp_stokes_breakdown.py's problem, Taylor-Hood P2-P1 on
# rectangle(115, 115) (106,722 velocity and 13,456 pressure DOFs), its
# named configurations at inner_maxiter 400 in float32 and its float64
# truth on the card (tol 1e-9, inner 1e-11, f-solve and recovery 1e-10).
# The quality bar of the JAX package's campaign (docs/performance.md):
# base within STOKES_BASE_BAR of the truth (relative L2 of the velocity),
# the other schedules within STOKES_QUALITY x base's, which the
# fixed-iteration control (aggcomp_k8) must fail
STOKES_N = 115
STOKES_SIZE = (106_722, 13_456)
STOKES_CONTROL = "aggcomp_k8"
# float32 MINRES (restart 50) ends with its recomputed true residual a
# little above the tolerance after the last refresh, so it reports
# converged=False on IEEE float32, as the JAX package does (its float32
# MINRES on the CPU at n=64: 112 iterations, 2.06e-6 against a tolerance
# of 1.65e-6; the port's 112 and 2.07e-6; converged on the TPU at n=115);
# its flag is reported and its solution is held to the quality bar
STOKES_UNCONVERGED = ("minres",)
STOKES_BASE_BAR = 2e-4
STOKES_QUALITY = 1.5
STOKES_DIV32 = 1e-5  # max |B u| / max |u|, float32
STOKES_DIV64 = 1e-9  # the same, float64
STOKES_MEAN = 32  # |sum(mp p)| <= this x eps x sum(mp |p|): zero to roundoff
STOKES_REPEATS = 3

# phase 26: the scalar preconditioners of the repo-root bench.py
# (BENCH_PRECOND x BENCH_PRECOND_DTYPE) through the port's
# bench.make_bsr_solve on the h=0.03 network, float32 against each
# configuration's float64 twin on the card (maxiter raised so that Jacobi
# converges); four of them at h=0.02 (maxiter 600: bf16 operands and mult
# failing to converge there is reported, not held); bf16 SpMV values
# (compiled_bsr_solver(values_dtype=torch.bfloat16)) at unit_cube(64) and on
# the network; solve_iterative("mult_two_level") and the scipy smoothed M
# on the h=0.1 network; probe after a P1 solve on unit_square(256)
PRECOND_CONFIGS = (
    ("jacobi", False), ("two_level", False), ("aggblock", False), ("affine", False),
    ("smoothed", False), ("mult", False), ("mult3", False), ("three_level", False),
    ("auto", False), ("aggblock", True), ("two_level", True), ("three_level", True),
    ("mult", True),
)
PRECOND_MAXITER = 5000
PRECOND_H2 = 0.02
PRECOND_H2_CONFIGS = (("aggblock", False), ("aggblock", True), ("mult", False),
                      ("three_level", False))
PRECOND_H2_HELD = (("aggblock", False), ("three_level", False))  # must converge
PRECOND_H2_MAXITER = 600
PRECOND_REPEATS = 3
# the float32 affine M's own bar beside F32_VS_F64: its coarse inverse (a
# Cholesky inverse of a coarse matrix whose 1e-7-shifted near-null
# directions, the rank-deficient [1, x, y, z] of planar fractures, reach
# 3-5e6) applies about 20 % from the float64 one in both packages (the JAX
# package's float32 M 22 % at h=0.03 on the CPU, the port's 21 %), and
# the card's atomic sums move that inverse from solve to solve, so its
# float32 PCG stops 1.0e-4 (CPU), 3.9e-4 and 7.6e-4 (two card runs) from
# the float64 solution where the other Ms stop 1e-5 away (ROADMAP.md,
# queue C); the distance is reported beside the 1e-4 bar and held within
# this one, which a broken coarse apply or smoother would still fail
PRECOND_F32_BAR = {"affine": 5e-3}
SPMV_PER_APPLY = {"mult": 2, "mult3": 2, "smoothed": 2}  # K2 launches per M apply
POWER_STEPS = {"mult": 12, "mult3": 12}  # K2 launches of omega="auto" at setup
VALUES_BF16_TET_N = 64
VALUES_BF16_MIN = 1e-5  # bf16 values must move the solution more than this
K2_BF16_TOL = 1e-6  # max |kernel - plain| / max |plain|, float32 x
SMOOTHED_H = 0.1
PROBE_N = 256
PROBE_POINTS = 100_000
PROBE_TOL = 1e-5  # float32 card probe vs float64 CPU probe, relative to max |ref|
SHARDED_REPEATS = 5  # phase 27's StepTimer medians
SHARDED_ITER_GAP = 2  # the JAX package's own bound (tests/test_sharding.py)
SHARDED_WATCHDOG_S = 300.0
SHARDED_SOLVER_REPEATS = 3  # phase 28's medians
# phase 29: K7 at the cells' aggregate blocks (network, cube: ns at gs = 64),
# at a batch of 8 x 8 blocks and at two of the sharded smoother's gs above
# 128 (its shared-memory kernel; float64 where the block fits, n <= 168)
K7_SHAPES = ((4_072, 64), (3_908, 64), (231_459, 8), (1_024, 160), (1_024, 192))
K7_ZERO_BLOCK = 3
K8_CUBE_N = 64  # phase 30: the cube and elasticity cells' kuhn_cube(64)

failures: list[str] = []
# name -> one launch at the benchmark shapes, registered by the phases for
# phase 12's table of timing windows
windows: dict = {}
# name -> (make_args(i), fn(*args), bytes of one set, kernel name key), for
# phase 12's stream figures
streams: dict = {}


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    log(("PASS " if ok else "FAIL ") + what)
    if not ok:
        failures.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = KERNEL_REPS, flush: str = "write") -> float:
    """Median device time of one call of ``fn`` with a cold L2: flushed by
    writing 128 MB (dirty lines, the figure every kernel is quoted at) or,
    with ``flush="read"``, by summing them after the write (clean lines)."""
    import torch

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")  # 128 MB
    fn()
    times = []
    for _ in range(reps):
        buf.zero_()
        if flush == "read":
            buf.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def stream_us(make_args, fn, copies: int, keys: tuple):
    """The stream figure of one kernel: ``copies`` launches of ``fn`` back to
    back, each on its own set of inputs ``make_args(i)`` (and its own
    output, held until the end), so that the sets together exceed the L2
    and every launch finds its data cold, as a caller would. The launches
    queue behind a device spin, so no host gap falls between them. Returns
    the median device duration per launch that the profiler (CUPTI)
    records for the events whose name holds one of ``keys`` (no event pair
    in it), the median gap between one launch's end and the next one's
    start on the device (about 1.2 us on an H100 when the launches run back
    to back), and the us between two CUDA events around all launches over
    ``copies``."""
    import torch

    sets = [make_args(i) for i in range(copies)]
    outs = [fn(*a) for a in sets]  # the allocator keeps these blocks for the run
    del outs
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # the profiler has been seen to return none of a kernel's device events,
    # in one run twice in a row: up to STREAM_ATTEMPTS sessions
    for _ in range(STREAM_ATTEMPTS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(STREAM_SPIN_CYCLES * copies)
            start.record()
            outs = [fn(*a) for a in sets]
            end.record()
            torch.cuda.synchronize()
        del outs
        device_events = [e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
        ranges = sorted((e.time_range.start, e.time_range.end) for e in device_events
                        if any(k in e.name for k in keys))
        if len(ranges) == copies:
            break
        log(f"stream figure of {keys[0]}: the profiler recorded {len(ranges)} of {copies} "
            f"launches ({len(device_events)} device events in all); measuring again")
    del sets
    check(len(ranges) == copies,
          f"stream figure of {keys[0]}: {len(ranges)} device events for {copies} launches")
    gaps = [b[0] - a[1] for a, b in zip(ranges, ranges[1:])]
    return (float(np.median([b - a for a, b in ranges])), float(np.median(gaps)),
            1e3 * start.elapsed_time(end) / copies)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _digest(t) -> str:
    """A short hash of a tensor's bytes: equal digests from two builds of a
    kernel mean bitwise equal results."""
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def _check_k1(tag, c, tol):
    """K1 against its plain version on the (T, 3, 3) cells ``c``, two
    launches bitwise equal; the largest absolute error."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops.kernels import _p1_plain_3d, p1_element_3d

    out = p1_element_3d(c)
    again = p1_element_3d(c)
    ref = _p1_plain_3d(c.reshape(c.shape[0], 9).T)
    torch.cuda.synchronize()
    err = float(((out - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)).max())
    ok = bool(torch.isfinite(out).all()) and err <= tol and torch.equal(out, again)
    check(ok, f"K1 {tag} vs plain: rel err {err:.3e} <= {tol:g}, two launches bitwise equal")
    return float((out - ref).abs().max())


def phase_k1(mesh64):
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.kernels import _p1_plain_3d, p1_element_3d

    coords64 = mesh64["cells", "coordinates_3d"].contiguous()
    T = coords64.shape[0]
    max_abs = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        max_abs = _check_k1(f"{dtype} h={H}", coords64.to(dtype), tol)
        # a tail block, words left over after the 16-byte pieces, a misaligned base
        for cells in EDGE_K1_CELLS:
            rng = np.random.default_rng(cells)
            tri = rng.uniform(-1.0, 1.0, size=(cells, 3, 3))
            tri[:, 1] += 2.0  # keep the three vertices apart
            tri[:, 2, 1] -= 3.0
            c = torch.as_tensor(tri, device=DEVICE).to(dtype)
            _check_k1(f"{dtype} T={cells}", c, tol)
            _check_k1(f"{dtype} T={cells} off a 16-byte boundary", cuda_build.misaligned_copy(c), tol)
    c32 = coords64.to(torch.float32)
    windows["K1"] = lambda: p1_element_3d(c32)
    streams["K1"] = (lambda i: (c32.clone(),), p1_element_3d, T * (9 + 13) * 4,
                     ("p1_element_3d",))
    ms = time_ms(lambda: p1_element_3d(c32))
    plain_ms = time_ms(lambda: _p1_plain_3d(c32.reshape(T, 9).T))
    b_ms, by = bound_ms(T * (9 + 13) * 4, T * K1_FLOPS_PER_CELL)
    log(f"K1 p1_element_3d T={T}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {by}); "
        f"float32 digest {_digest(p1_element_3d(c32))}")
    # a device copy that moves as many bytes as K1 (22 words per cell)
    src = torch.empty(T * 11, dtype=torch.float32, device=DEVICE).normal_()
    dst = torch.empty_like(src)
    windows["copy of K1's bytes"] = lambda: dst.copy_(src)
    streams["copy of K1's bytes"] = (
        lambda i: (torch.empty_like(dst), src.clone()), lambda d, s: d.copy_(s),
        2 * src.numel() * 4, ("Memcpy DtoD", "copy_kernel"),
    )
    return {
        "name": "p1_element_3d",
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/p1_element.cu",
        "replaces": "pytorch_fem_solver_tpu/ops/pallas_kernels.py:192",
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": None,
    }


def _csr_of(st, values):
    """The permuted padded operator as one torch CSR matrix (for the
    library yardstick only): every stored block, 64 entries each."""
    import torch

    v1, v2 = values
    k = st.block
    nb, B = st.bcols.shape
    nh, B2 = st.bcols2.shape
    dev = v1.device
    ii, jj = torch.meshgrid(torch.arange(k, device=dev), torch.arange(k, device=dev), indexing="ij")
    br = torch.cat([
        torch.arange(nb, device=dev).repeat_interleave(B),
        st.heavy_rows.long().repeat_interleave(B2),
    ])
    bc = torch.cat([st.bcols.long().reshape(-1), st.bcols2.long().reshape(-1)])
    vals = torch.cat([v1.reshape(-1, k, k), v2.reshape(-1, k, k)])
    stored = torch.as_tensor(np.sort(st.blk_id_host), device=dev)
    rows = (br[stored, None, None] * k + ii).reshape(-1)
    cols = (bc[stored, None, None] * k + jj).reshape(-1)
    a = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), vals[stored].reshape(-1), (st.n_pad, st.n_pad),
        check_invariants=False,
    )
    return a.coalesce().to_sparse_csr()


def _k2_bytes_flops(st):
    """Bytes and operations of one float32 SpMV on ``st``: every stored
    block and its column, the two per-row tables (row_blocks, heavy_rank),
    x read and y written; 2 x 64 operations per stored block."""
    n_stored = int(st.blk_id_host.size)
    return n_stored * (64 * 4 + 4) + 2 * st.nb * 4 + 2 * st.n_pad * 4, 2 * 64 * n_stored


def _check_k2_bytes(tag, st):
    """The bytes K2's loads ask of memory beside the bound's: the same,
    but the column tables come in 32-byte sectors, so a row's last sector
    brings padded slots. Within 5%: the kernel reads no padded block."""
    n_bytes, _ = _k2_bytes_flops(st)
    (nb, B), (nh, B2) = st.bcols.shape, st.bcols2.shape
    counts = st.row_blocks.cpu().numpy().astype(np.int64)
    sectors = -(-np.minimum(counts, B) * 4 // 32) + -(-np.maximum(counts - B, 0) * 4 // 32)
    streamed = int(st.blk_id_host.size) * 64 * 4 + int(sectors.sum()) * 32 + 2 * nb * 4 + 2 * st.n_pad * 4
    log(f"K2 bytes {tag}: the bound counts {n_bytes}, the kernel streams {streamed} "
        f"({streamed / n_bytes:.4f} of it); a walk of every slot would stream "
        f"{(nb * B + nh * B2) * (64 * 4 + 4) + 2 * st.n_pad * 4}")
    check(abs(streamed / n_bytes - 1) <= 0.05,
          f"K2 {tag} streams {streamed / n_bytes:.4f} of the bound's bytes (within 5%)")


def _check_k2(tag, st, values64, x64):
    """K2 against its plain version in f64 and f32, two launches bitwise
    equal, one launch counted per product; the f32 max absolute error."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.bsr import _bsr_spmv_plain, bsr_matvec

    max_abs = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        vals = tuple(v.to(dtype).contiguous() for v in values64)
        x = x64.to(dtype)
        before = cuda_build.launch_counts["bsr_spmv"]
        y = bsr_matvec(st, vals, x)
        counted = cuda_build.launch_counts["bsr_spmv"] - before
        ref = _bsr_spmv_plain(st.bcols, vals[0], x, st.bcols2, vals[1], st.heavy_rows)
        again = bsr_matvec(st, vals, x)
        torch.cuda.synchronize()
        err = float((y - ref).norm() / ref.norm())
        check(bool(torch.isfinite(y).all()) and err <= tol,
              f"K2 {tag} {dtype} vs plain: rel err {err:.3e} <= {tol:g}")
        check(torch.equal(y, again) and counted == 1,
              f"K2 {tag} {dtype}: two launches bitwise equal, {counted} launch per product")
        max_abs = float((y - ref).abs().max())
    return max_abs


def phase_k2_structures():
    """K2 on the h=0.1 DFN with a narrow tier 1 and a wide tier 2
    (``max_b=4``), the default (8) and no tier 2 at all (``max_b=None``)."""
    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import benchmark_basis
    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        bsr_values_from_local_symmetric,
        get_bsr_structure,
    )

    V = benchmark_basis(pt.build_benchmark_network(0.1, device=DEVICE, dtype=torch.float64))
    local = V.integrate_bilinear_form_local(lambda b: b.v_grad @ b.v_grad.mT)
    for max_b in (4, 8, None):
        st = get_bsr_structure(V, max_b=max_b, want_entry_slot=False)
        (nb, B), (nh, B2) = st.bcols.shape, st.bcols2.shape
        log(f"K2 structure h=0.1 max_b={max_b}: nb={nb} B={B} nh={nh} B2={B2} "
            f"stored={st.blk_id_host.size} of {nb * B + nh * B2} slots")
        check((nh == 0) == (max_b is None) and (max_b != 4 or B2 > B),
              f"K2 structure max_b={max_b}: tier 2 as expected (nh={nh}, B2={B2})")
        x64 = torch.as_tensor(
            np.random.default_rng(SEED + 2).standard_normal(st.n_pad), device=DEVICE
        )
        _check_k2(f"h=0.1 max_b={max_b}", st, bsr_values_from_local_symmetric(st, local), x64)


def phase_k2(st, values64):
    import torch

    from pytorch_fem_solver_tpu_torch.ops.bsr import _bsr_spmv_plain, bsr_matvec

    rng = np.random.default_rng(SEED)
    x64 = torch.as_tensor(rng.standard_normal(st.n_pad), device=values64[0].device)
    max_abs = _check_k2(f"h={H}", st, values64, x64)
    vals32 = tuple(v.to(torch.float32).contiguous() for v in values64)
    x32 = x64.to(torch.float32)
    ms = time_ms(lambda: bsr_matvec(st, vals32, x32))
    plain_ms = time_ms(
        lambda: _bsr_spmv_plain(st.bcols, vals32[0], x32, st.bcols2, vals32[1], st.heavy_rows)
    )
    csr = _csr_of(st, vals32)
    y_lib = torch.mv(csr, x32)
    y_ker = bsr_matvec(st, vals32, x32)
    torch.cuda.synchronize()
    lib_err = float((y_lib - y_ker).norm() / y_ker.norm())
    check(lib_err <= 1e-5, f"K2 vs torch CSR matvec: rel diff {lib_err:.3e} <= 1e-05")
    library_ms = time_ms(lambda: torch.mv(csr, x32))
    n_stored = int(st.blk_id_host.size)
    (nb, B), (nh, B2) = st.bcols.shape, st.bcols2.shape
    stored1 = int((st.blk_id_host < nb * B).sum())
    log(f"K2 tiers: tier 1 (nb={nb}, B={B}) {stored1} of {nb * B} slots stored; "
        f"tier 2 (nh={nh}, B2={B2}) {n_stored - stored1} of {nh * B2} slots stored")
    n_bytes, n_flops = _k2_bytes_flops(st)
    b_ms, by = bound_ms(n_bytes, n_flops)
    _check_k2_bytes(f"h={H}", st)
    log(
        f"K2 bsr_spmv nb={st.nb} B={B} spill_rows={nh} "
        f"stored_blocks={n_stored}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
        f"torch CSR {library_ms:.4f} ms, bound {b_ms:.4f} ms by {by})"
    )
    return {
        "name": "bsr_spmv",
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/bsr_spmv.cu",
        "replaces": "tools/exp_pallas_spmv.py:63",
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": library_ms,
    }


def phase_main(st, V32, V64):
    import torch

    from pytorch_fem_solver_tpu_torch.bench import make_bsr_solve
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    solve32 = make_bsr_solve(V32, tol=TOL)
    solve64 = make_bsr_solve(V64, tol=TOL)
    solve32()  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    cuda_build.reset_launch_counts()
    x32, iters, rel = solve32()
    torch.cuda.synchronize()
    launches = dict(cuda_build.launch_counts)

    log(f"main path: dofs={V32.n_dofs} iterations={iters} rel_res={float(rel):.4e} launches={launches}")
    check(V32.n_dofs == EXPECTED_DOFS, f"DOFs {V32.n_dofs} == {EXPECTED_DOFS}")
    check(float(rel) <= TOL, f"relative residual {float(rel):.3e} <= {TOL:g}")
    check(iters <= MAX_ITERATIONS, f"iterations {iters} <= {MAX_ITERATIONS}")
    check(bool(torch.isfinite(x32).all()), "solution finite")
    check(launches["p1_element_3d"] >= 1, f"K1 launched on the main path ({launches['p1_element_3d']})")
    check(launches["bsr_spmv"] >= iters, f"K2 launches {launches['bsr_spmv']} >= iterations {iters}")
    check(launches["small_inv"] == 1,
          f"K7 launched once on the main path, in the aggregate-block M set-up ({launches['small_inv']})")

    x64, iters64, rel64 = solve64()
    torch.cuda.synchronize()
    n = st.n_inner
    diff = float((x32[:n].double() - x64[:n]).norm() / x64[:n].norm())
    log(f"f64 on the card: iterations={iters64} rel_res={float(rel64):.4e}; f32-vs-f64 rel L2 {diff:.4e}")
    check(diff <= 1e-4, f"f32 solution vs f64 solution {diff:.3e} <= 1e-4")

    times = []
    for _ in range(TIMED_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve32()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    median = float(np.median(times))
    log(f"main path f32 h={H}: median {median:.6f} s over {TIMED_REPEATS} repeats {times}")
    return solve32, x32, iters, iters64, launches, median


def phase_compiled(st, V32, x32):
    import torch

    from pytorch_fem_solver_tpu_torch.ops.bsr import bsr_expand
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    solve = V32.compiled_solver(lambda b: b.v_grad @ b.v_grad.mT, lambda b: b.v, tol=TOL)
    cuda_build.reset_launch_counts()
    u, info = solve()
    torch.cuda.synchronize()
    launches = dict(cuda_build.launch_counts)
    ref = bsr_expand(st, x32, V32.n_dofs)
    diff = float((u - ref).norm() / ref.norm())
    log(f"compiled_bsr_solver: iterations={info.iterations} residual={float(info.residual_norm):.4e} launches={launches}")
    check(bool(info.converged), "compiled_bsr_solver converged")
    check(diff <= 1e-4, f"compiled_bsr_solver vs main path {diff:.3e} <= 1e-4")
    check(launches["bsr_spmv"] >= info.iterations, "compiled_bsr_solver ran K2")
    # the assembly's two scatters, each one launch of K8 a request
    check(launches["pair_scatter"] == 1 and launches["flat_scatter"] == 1,
          f"compiled_bsr_solver: one pair_scatter and one flat_scatter launch "
          f"({launches['pair_scatter']}, {launches['flat_scatter']})")
    return solve


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def _device_kernels(prof, per: int):
    """(device us, launches, name) per run of each kernel, largest first,
    and the device ms per run. User annotations (the optimizer's step range
    on the device timeline) span kernels counted already and are left out."""
    import torch

    kernels = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels.append((us / per, evt.count / per, evt.key))
    kernels.sort(reverse=True)
    return kernels, sum(k[0] for k in kernels) / 1e3


def _htod_per_solve(prof, per: int) -> float:
    """Host-to-device copies per solve: the profiler's ``Memcpy HtoD``
    events."""
    import torch

    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "Memcpy HtoD" in e.name) / per


def phase_profile(solve32, compiled_solve, median_s: float):
    import torch

    # device activity only: every figure here is read from device events,
    # and recording the host's operators as well slowed a solve 1.3-2x
    activities = [torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(PROFILED_SOLVES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve32()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    kernels, device_ms = _device_kernels(prof, PROFILED_SOLVES)
    wall_ms = 1e3 * float(np.median(walls))
    log(f"profile, {PROFILED_SOLVES} solves: wall {wall_ms:.3f} ms per solve under the profiler, "
        f"device {device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.3f} "
        f"({1 - device_ms / (1e3 * median_s):.3f} of the unprofiled median), "
        f"{sum(k[1] for k in kernels):.0f} kernel launches per solve")
    log("device ms/solve  launches/solve  kernel")
    for us, count, name in kernels[:25]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    # host-to-device copies in a solve after the first, on both solve paths
    with torch.profiler.profile(activities=activities) as cprof:
        compiled_solve()
        torch.cuda.synchronize()
    copies = {"bench.py's path": _htod_per_solve(prof, PROFILED_SOLVES),
              "compiled_bsr_solver": _htod_per_solve(cprof, 1)}
    log("host-to-device copies per solve (Memcpy HtoD events): "
        + "; ".join(f"{name} {n:.2f}" for name, n in copies.items()))
    for name, n in copies.items():
        check(n == 0, f"{name}: no host-to-device copy in a solve after the first ({n:.2f})")


def _rel_err(ours, ref) -> float:
    """max |ours - ref| / max |ref| (for a 0-d tensor |ours - ref| / |ref|)."""
    return float((ours - ref).abs().max() / ref.abs().max())


def _tail_inputs(ns, gs, dtype):
    """Seeded (alpha, [x, r, p, ap]) for K3, on the card."""
    import torch

    rng = np.random.default_rng(SEED)
    vecs = [torch.as_tensor(rng.standard_normal((ns, gs)), device=DEVICE).to(dtype)
            for _ in range(4)]
    alpha = torch.tensor(rng.uniform(0.5, 1.5), dtype=dtype, device=DEVICE)
    return alpha, vecs


def _check_tail(tag, pre_inv, coarse_inv, alpha, vecs, tol):
    """K3 and K4 against their plain versions on the same inputs (K4 fed the
    plain K3's outputs); returns the largest absolute error of each."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import fused_pcg as fp

    k3 = fp.agg_smooth_restrict(alpha, *vecs, pre_inv)
    ref3 = fp._agg_smooth_restrict_plain(alpha, *vecs, pre_inv)
    k4 = fp.coarse_prolong_dot(coarse_inv, ref3[3], ref3[2], ref3[1])
    ref4 = fp._coarse_prolong_dot_plain(coarse_inv, ref3[3], ref3[2], ref3[1])
    again = fp.coarse_prolong_dot(coarse_inv, ref3[3], ref3[2], ref3[1])
    again3 = fp.agg_smooth_restrict(alpha, *vecs, pre_inv)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(again, k4)),
          f"K4 {tag}: two launches bitwise equal (z and rz)")
    check(all(torch.equal(a, b) for a, b in zip(again3, k3)),
          f"K3 {tag}: two launches bitwise equal (xn, rn, s, rc)")
    out = {}
    for kernel, names, ours, refs in (
        ("K3", ("xn", "rn", "s", "rc"), k3, ref3),
        ("K4", ("z", "rz"), k4, ref4),
    ):
        errs = {n: _rel_err(a, b) for n, a, b in zip(names, ours, refs)}
        finite = all(bool(torch.isfinite(a).all()) for a in ours)
        worst = max(errs.values())
        check(finite and worst <= tol,
              f"{kernel} {tag} vs plain: rel err {worst:.3e} <= {tol:g} "
              + " ".join(f"{n}={e:.2e}" for n, e in errs.items()))
        out[kernel] = max(float((a - b).abs().max()) for a, b in zip(ours, refs))
    return out


def _check_k3_edges(dtype, tol):
    """K3's warp kernel on seeded NON-symmetric blocks at row counts that
    are no multiple of its rows per thread block, with ``inv_agg`` on and
    off a 16-byte boundary (the one-word loads)."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops import fused_pcg as fp

    for ns in EDGE_K3_ROWS:
        rng = np.random.default_rng(SEED + ns)
        inv = torch.as_tensor(rng.standard_normal((ns, 32, 32)), device=DEVICE).to(dtype)
        alpha, vecs = _tail_inputs(ns, 32, dtype)
        for tag, table in (("aligned", inv), ("off a 16-byte boundary", cuda_build.misaligned_copy(inv))):
            ours = fp.agg_smooth_restrict(alpha, *vecs, table)
            ref = fp._agg_smooth_restrict_plain(alpha, *vecs, table)
            again = fp.agg_smooth_restrict(alpha, *vecs, table)
            torch.cuda.synchronize()
            worst = max(_rel_err(a, b) for a, b in zip(ours, ref))
            ok = (all(bool(torch.isfinite(a).all()) for a in ours) and worst <= tol
                  and all(torch.equal(a, b) for a, b in zip(ours, again)))
            check(ok, f"K3 {dtype} ns={ns} non-symmetric blocks, inv_agg {tag}: rel err "
                  f"{worst:.3e} <= {tol:g}, two launches bitwise equal")


def _check_k3_loads_first():
    """K3's design rests on every global load being started before the warp
    computes on the block. Read that back from the machine code of the
    built library: in the 16-byte float32 and float64 warp kernels every
    LDG comes before the fence, and the fence before the first product."""
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        log("K3 machine code not read: no cuobjdump beside nvcc")
        return
    sass = subprocess.run(
        [cuobjdump, "-sass", str(cuda_build._lib_path("fused_pcg"))],
        check=True, capture_output=True, text=True, timeout=120,
    ).stdout
    for key, tag in (("agg_smooth_restrict_32IfLi4E", "float32"),
                     ("agg_smooth_restrict_32IdLi2E", "float64")):
        body = next((f for f in sass.split("Function : ")[1:] if key in f.splitlines()[0]), "")
        lines = [ln for ln in body.splitlines() if "/*" in ln]

        def where(*ops):
            return [k for k, ln in enumerate(lines) if any(op in ln for op in ops)]

        loads, fence, products = where("LDG"), where("MEMBAR"), where(" FMUL", " DMUL")
        ok = bool(loads and fence and products) and loads[-1] < fence[0] < products[0]
        check(ok, f"K3 {tag} machine code: {len(loads)} global loads, all before the fence "
              f"and the first of {len(products)} products")


# buckets of one fused iteration, by kernel name (first match wins)
FUSED_BUCKETS = (
    ("K2 bsr_spmv", ("bsr_spmv",)),
    ("K3 agg_smooth_restrict", ("agg_smooth_restrict",)),
    ("K4 coarse_prolong_dot", ("coarse_prolong",)),
    ("dots", ("dot_kernel", "reduce_1Block")),
    ("scalar ops (alpha, beta)", ("DivFunctor",)),
    ("p update", ("MulFunctor", "CUDAFunctor_add", "AddFunctor")),
)


def _loop(fused, fused_tail, graphs, tol=0.0, maxiter=LOOP_ITERS):
    """The stock (``pcg_chunked``) or the fused (``fused_pcg``) loop on
    ``make_fused_pcg``'s system, captured in chunks of the main path's
    ``PCG_CHUNK``; ``tol=0.0`` runs ``maxiter`` iterations."""
    from pytorch_fem_solver_tpu_torch.ops.compiled import PCG_CHUNK
    from pytorch_fem_solver_tpu_torch.ops.fused_pcg import fused_pcg
    from pytorch_fem_solver_tpu_torch.ops.solvers import pcg_chunked

    if fused_tail:
        return fused_pcg(fused.matvec, fused.b_pad, fused.precond, tol=tol, maxiter=maxiter,
                         chunk=PCG_CHUNK, graphs=graphs)
    return pcg_chunked(fused.matvec, fused.b_pad, precond=fused.precond, tol=tol,
                       maxiter=maxiter, chunk=PCG_CHUNK, graphs=graphs)


def _replay_split(run):
    """One call of ``run()`` (``LOOP_ITERS`` iterations, its graph captured
    in the call) under the profiler: the device s per iteration issued and
    the kernels. Capture launches nothing, so the device trace holds the
    replays and the call's start and end (one SpMV, one M apply, three
    dots), which add under one iteration's work to the sum."""
    import torch

    run()  # the side stream's warm-up, if still to come
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    issued = _issued(LOOP_ITERS, LOOP_ITERS)
    kernels, device_ms = _device_kernels(prof, issued)
    return device_ms / 1e3, kernels


def _fused_iteration_split(kernels, s_per_iter: float):
    """The fused loop's device us and launches per iteration, by bucket."""
    split = {name: [0.0, 0.0] for name, _ in FUSED_BUCKETS}
    other = []
    for us, count, name in kernels:
        bucket = next((b for b, keys in FUSED_BUCKETS if any(k in name for k in keys)), None)
        if bucket is None:
            other.append((us, count, name))
        else:
            split[bucket][0] += us
            split[bucket][1] += count
    log(f"fused loop, {LOOP_ITERS} iterations under the profiler: device "
        f"{1e6 * s_per_iter:.2f} us per iteration issued; us / launches per iteration: "
        + "; ".join(f"{name} {us:.2f} / {count:.2f}" for name, (us, count) in split.items())
        + f"; other {sum(o[0] for o in other):.2f} / {sum(o[1] for o in other):.2f}")
    for us, count, name in other[:8]:
        log(f"  other: {us:.3f} us / {count:.2f} per iteration  {name[:100]}")
    check(all(split[b][1] >= 1 for b in ("K2 bsr_spmv", "K3 agg_smooth_restrict",
                                         "K4 coarse_prolong_dot")),
          "the profiled replays show K2, K3 and K4 once per iteration")


def _figure(tag, name, replaces, kernel, plain, library, lib_name, n_bytes, n_flops,
            max_abs):
    """Time one kernel, its plain version and its library yardstick; the
    kernels-line entry without ``launches``."""
    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library)
    b_ms, by = bound_ms(n_bytes, n_flops)
    log(f"{tag} {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, {lib_name} "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms by {by})")
    return {
        "name": name,
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/fused_pcg.cu",
        "replaces": replaces,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": library_ms,
    }


def phase_fused(st, V32, V64, x32, iters, iters64, card):
    """Phase 7: the fused PCG tail, K3 and K4."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import make_fused_pcg
    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops import fused_pcg as fp
    from pytorch_fem_solver_tpu_torch.ops.bsr import bsr_matvec
    from pytorch_fem_solver_tpu_torch.ops.compiled import PCG_CHUNK
    from pytorch_fem_solver_tpu_torch.ops.solvers import PCGGraphs

    fused = {torch.float32: make_fused_pcg(V32), torch.float64: make_fused_pcg(V64)}
    ns, gs = fp.fused_shape(fused[torch.float32].precond, st.n_pad)
    nc = ns
    log(f"fused tail: ns={ns} gs={gs} nc={nc} g={fused[torch.float32].precond.g}")

    # 1. the kernels against their plain versions
    max_abs = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        pre = fused[dtype].precond
        alpha, vecs = _tail_inputs(ns, gs, dtype)
        max_abs[dtype] = _check_tail(f"{dtype} h={H}", pre.inv_agg, pre.coarse_inv, alpha, vecs, tol)
        # gs=64: K3's one-block-per-row kernel, on seeded SPD tables (so rz
        # is a sum of mostly positive terms, as with the real M^{-1})
        rng = np.random.default_rng(SEED + 1)
        a = rng.standard_normal((65, 64, 64))
        spd = a @ a.transpose(0, 2, 1) / 64 + np.eye(64)
        inv64 = torch.as_tensor(spd[:64], device=DEVICE).to(dtype)
        cinv64 = torch.as_tensor(spd[64], device=DEVICE).to(dtype)
        alpha64, vecs64 = _tail_inputs(64, 64, dtype)
        _check_tail(f"{dtype} gs=64", inv64, cinv64, alpha64, vecs64, tol)
        # nc = ns = 67: rows of coarse_inv are not 16-byte aligned, so K4
        # takes its one-word loads; gs=32 (K3's warp kernel) and gs=5
        b = rng.standard_normal((67, 67))
        cinv67 = torch.as_tensor(b @ b.T / 67 + np.eye(67), device=DEVICE).to(dtype)
        for gs_odd in (32, 5):
            c = rng.standard_normal((67, gs_odd, gs_odd))
            inv67 = torch.as_tensor(
                c @ c.transpose(0, 2, 1) / gs_odd + np.eye(gs_odd), device=DEVICE
            ).to(dtype)
            alpha67, vecs67 = _tail_inputs(67, gs_odd, dtype)
            _check_tail(f"{dtype} nc=67 gs={gs_odd}", inv67, cinv67, alpha67, vecs67, tol)
        _check_k3_edges(dtype, tol)
    _check_k3_loads_first()

    # 2. per-kernel figures, f32 at the benchmark shapes; bounds count f32
    # words: each input read once, each output written once
    pre = fused[torch.float32].precond
    alpha, vecs = _tail_inputs(ns, gs, torch.float32)
    xn, rn, s, rc = fp._agg_smooth_restrict_plain(alpha, *vecs, pre.inv_agg)
    n = ns * gs
    k3 = _figure(
        "K3", "agg_smooth_restrict", "tools/exp_pallas_fused_pcg.py:125",
        lambda: fp.agg_smooth_restrict(alpha, *vecs, pre.inv_agg),
        lambda: fp._agg_smooth_restrict_plain(alpha, *vecs, pre.inv_agg),
        lambda: torch.bmm(pre.inv_agg, rn.view(ns, gs, 1)), "torch.bmm",
        # inv_agg, alpha, x r p ap in; xn rn s, rc out
        4 * (ns * gs * gs + 1 + 7 * n + ns), 2 * ns * gs * gs + 5 * n,
        max_abs[torch.float32]["K3"],
    )
    k4 = _figure(
        "K4", "coarse_prolong_dot", "tools/exp_pallas_fused_pcg.py:173",
        lambda: fp.coarse_prolong_dot(pre.coarse_inv, rc, s, rn),
        lambda: fp._coarse_prolong_dot_plain(pre.coarse_inv, rc, s, rn),
        lambda: torch.mv(pre.coarse_inv, rc), "torch.mv",
        # coarse_inv, rc, s rn in; z, rz out
        4 * (nc * nc + nc + 3 * n + 1), 2 * nc * nc + 3 * n,
        max_abs[torch.float32]["K4"],
    )
    values32 = fused[torch.float32].values
    x_seed = torch.as_tensor(
        np.random.default_rng(SEED).standard_normal(st.n_pad), device=DEVICE
    ).to(torch.float32)
    windows["K2"] = lambda: bsr_matvec(st, values32, x_seed)
    windows["K3"] = lambda: fp.agg_smooth_restrict(alpha, *vecs, pre.inv_agg)
    windows["K4"] = lambda: fp.coarse_prolong_dot(pre.coarse_inv, rc, s, rn)
    windows["torch.mv"] = lambda: torch.mv(pre.coarse_inv, rc)

    # 3. fixed-length runs as CUDA graphs: tol=0, maxiter=iters; a
    # PCGGraphs per loop and dtype, as one per solver
    graphs = {(dtype, tail): PCGGraphs(fused[dtype].b_pad.device)
              for dtype in fused for tail in (False, True)}
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, FUSED_VS_STOCK)):
        xs, info_s = _loop(fused[dtype], False, graphs[dtype, False], maxiter=FIXED_ITERS)
        xf, info_f = _loop(fused[dtype], True, graphs[dtype, True], maxiter=FIXED_ITERS)
        torch.cuda.synchronize()
        dx = _rel_err(xf, xs)
        check(info_s.iterations == info_f.iterations == FIXED_ITERS,
              f"graphed fixed-length loops {dtype}: {info_s.iterations} and "
              f"{info_f.iterations} iterations == {FIXED_ITERS}")
        check(bool(torch.isfinite(xf).all()) and dx <= tol,
              f"graphed fused({FIXED_ITERS}) vs stock({FIXED_ITERS}) {dtype}: "
              f"{dx:.3e} <= {tol:g}")
    f32 = fused[torch.float32]
    issued = _issued(LOOP_ITERS, LOOP_ITERS)
    launched = {}
    for tail in (False, True):
        cuda_build.reset_launch_counts()
        _loop(f32, tail, graphs[torch.float32, tail])
        launched[tail] = {k: v for k, v in cuda_build.launch_counts.items() if v}
        for name in ("bsr_spmv",) + (("agg_smooth_restrict", "coarse_prolong_dot") if tail else ()):
            want = issued + (name == "bsr_spmv")
            check(launched[tail].get(name, 0) == want,
                  f"{'fused' if tail else 'stock'} loop of {LOOP_ITERS}: {name} counted "
                  f"{launched[tail].get(name, 0)} == {want} (once a replay, {issued} issued"
                  + (", + 1 for r0)" if name == "bsr_spmv" else ")"))
    log(f"launches counted in a call of {LOOP_ITERS} iterations ({issued} issued): "
        f"stock {launched[False]}, fused {launched[True]}")
    per_iter = []
    for tail in (False, True, False, True):
        per_iter.append(_replay_split(lambda t=tail: _loop(f32, t, graphs[torch.float32, t])))
    (s_stock, _), (s_fused, _), (s_stock2, _), (s_fused2, kernels_fused) = per_iter
    log(f"device s/iteration of the replays, in turns stock, fused, stock, fused: "
        f"{s_stock:.4e} {s_fused:.4e} {s_stock2:.4e} {s_fused2:.4e}")
    log(json.dumps({
        "metric": "fused_pcg_s_per_iter",
        "h": H,
        "n_pad": st.n_pad,
        "g": f32.precond.g,
        "reps": LOOP_ITERS,
        "chunk": PCG_CHUNK,
        "stock_s_per_iter": s_stock2,
        "fused_s_per_iter": s_fused2,
        "speedup": s_stock2 / s_fused2,
        "card": card,
    }))
    _fused_iteration_split(kernels_fused, s_fused2)

    # 4. the fused solve to tolerance
    def solve_fused(dtype):
        x, info = _loop(fused[dtype], True, graphs[dtype, True], tol=TOL, maxiter=600)
        return x, info.iterations, info.residual_norm / fused[dtype].b_pad.norm()

    cuda_build.reset_launch_counts()
    xf, it, rel = solve_fused(torch.float32)
    torch.cuda.synchronize()
    launches = dict(cuda_build.launch_counts)
    n_in = st.n_inner
    diff = float((xf[:n_in] - x32[:n_in]).norm() / x32[:n_in].norm())
    log(f"fused_pcg f32: iterations={it} rel_res={float(rel):.4e} launches={launches}; "
        f"vs main path rel L2 {diff:.4e}")
    check(float(rel) <= TOL, f"fused_pcg relative residual {float(rel):.3e} <= {TOL:g}")
    check(it <= MAX_ITERATIONS, f"fused_pcg iterations {it} <= {MAX_ITERATIONS}")
    check(abs(it - iters) <= 1, f"fused_pcg iterations {it} within 1 of the main path's {iters}")
    check(bool(torch.isfinite(xf).all()) and diff <= 1e-4,
          f"fused_pcg vs main-path solution {diff:.3e} <= 1e-4")
    for name in ("bsr_spmv", "agg_smooth_restrict", "coarse_prolong_dot"):
        check(launches[name] >= it, f"{name} launches {launches[name]} >= iterations {it}")
    _, it64, rel64 = solve_fused(torch.float64)
    log(f"fused_pcg f64: iterations={it64} rel_res={float(rel64):.4e}")
    check(it64 == iters64, f"fused_pcg f64 iterations {it64} == main path f64 {iters64}")
    times = []
    for _ in range(TIMED_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_fused(torch.float32)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"fused_pcg f32 (the chunked graphed loop, its capture included; assembly and setup "
        f"excluded): median {float(np.median(times)):.6f} s over {TIMED_REPEATS} repeats {times}")
    for fig in (k3, k4):
        fig["launches"] = launches[fig["name"]]
    return k3, k4


def _k5_inputs(coords, scale, dtype):
    c = coords.to(dtype).contiguous()
    return c, (None if scale is None else scale.to(dtype).contiguous())


def _k5_plain(c, s):
    """K5's plain version on the SoA rows of (T, 3, 2) cells and a scale."""
    from pytorch_fem_solver_tpu_torch.ops.kernels import _p1_plain, _soa_rows

    return _p1_plain(_soa_rows(c, s))


def _seeded_cells_2d(T, dtype):
    """(T, 3, 2) seeded planar triangles on the card, none degenerate, every
    third one clockwise, and a seeded (T,) scale (as the CPU tests make)."""
    import torch

    rng = np.random.default_rng(T)
    coords = rng.uniform(-0.4, 0.4, size=(T, 3, 2))
    coords[:, 1, 0] += 2.0
    coords[:, 2, 1] += 2.0
    coords[::3] = coords[::3, [0, 2, 1]]
    scale = rng.uniform(0.5, 1.5, size=T)
    return (torch.as_tensor(coords, device=DEVICE).to(dtype),
            torch.as_tensor(scale, device=DEVICE).to(dtype))


def _check_k5_edges(dtype, tol):
    """K5 at sizes that leave a tail block whose words do not fill whole
    16-byte pieces, with the coordinates on and off a 16-byte boundary (the
    one-word loads), with and without a scale; two launches bitwise equal."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.kernels import p1_element_2d

    for cells in EDGE_K1_CELLS:
        coords, scale = _seeded_cells_2d(cells, dtype)
        for tag, c in (("aligned", coords), ("off a 16-byte boundary", cuda_build.misaligned_copy(coords))):
            for s in (None, scale):
                out = p1_element_2d(c, s)
                again = p1_element_2d(c, s)
                ref = _k5_plain(c, s)
                torch.cuda.synchronize()
                err = float(((out - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)).max())
                ok = bool(torch.isfinite(out).all()) and err <= tol and torch.equal(out, again)
                check(ok, f"K5 {dtype} T={cells} {tag} {'scaled' if s is not None else 'scale 1'}: "
                      f"rel err {err:.3e} <= {tol:g}, two launches bitwise equal")


def phase_k5(mesh64):
    """Phase 8: K5 against its plain version on the RVPINN mesh and the
    DFN's chart cells, with and without a scale, and at the edge sizes; the
    digests of its float32 output at the DFN size; its time there."""
    import torch

    from pytorch_fem_solver_tpu_torch.mesh import MeshTri, unit_square
    from pytorch_fem_solver_tpu_torch.ops.kernels import P1_OUT_ROWS_2D, p1_element_2d

    rng = np.random.default_rng(SEED)
    meshes = {
        f"RVPINN n={RVPINN_N}": MeshTri(
            unit_square(n=RVPINN_N), device=DEVICE, dtype=torch.float64
        )["cells", "coordinates"],
        f"DFN h={H}": mesh64["cells", "coordinates"],
    }
    max_abs = 0.0
    for tag, coords in meshes.items():
        scale = torch.as_tensor(rng.uniform(0.5, 1.5, coords.shape[0]), device=DEVICE)
        for s64 in (None, scale):
            for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
                c, s = _k5_inputs(coords, s64, dtype)
                out = p1_element_2d(c, s)
                ref = _k5_plain(c, s)
                torch.cuda.synchronize()
                err = float(((out - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)).max())
                check(bool(torch.isfinite(out).all()) and err <= tol,
                      f"K5 {tag} {'scaled' if s is not None else 'scale 1'} {dtype} vs plain: "
                      f"rel err {err:.3e} <= {tol:g}")
                if dtype == torch.float32:
                    max_abs = max(max_abs, float((out - ref).abs().max()))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        _check_k5_edges(dtype, tol)
    c, s = _k5_inputs(meshes[f"DFN h={H}"], scale, torch.float32)
    T = c.shape[0]
    log(f"K5 float32 digests at the DFN's {T} chart cells: scale 1 "
        f"{_digest(p1_element_2d(c, None))}, scaled {_digest(p1_element_2d(c, s))}")
    windows["K5"] = lambda: p1_element_2d(c, s)
    streams["K5"] = (lambda i: (c.clone(), s.clone()), p1_element_2d,
                     T * (7 + P1_OUT_ROWS_2D) * 4, ("p1_element_2d",))
    ms = time_ms(windows["K5"])
    plain_ms = time_ms(lambda: _k5_plain(c, s))
    # 6 coordinates and the scale in, 14 rows out
    b_ms, by = bound_ms(T * (7 + P1_OUT_ROWS_2D) * 4, T * K5_FLOPS_PER_CELL)
    log(f"K5 p1_element_2d T={T}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {by})")
    return {
        "name": "p1_element_2d",
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/p1_element.cu",
        "replaces": "pytorch_fem_solver_tpu/ops/pallas_kernels.py:44",
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": None,
    }


def _rel_curve(ours, ref) -> float:
    """max over epochs of |ours - ref| / |ref|."""
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(ours - ref) / np.abs(ref)))


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_rvpinn(card):
    """Phase 9: RVPINN training at the benchmark's full size on the card."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench_vpinn import EPOCHS, make_rvpinn
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    f32 = torch.float32
    warm = make_rvpinn(epochs=2, device=DEVICE, dtype=f32)  # cuBLAS/cuSOLVER handles, allocator
    warm.model.train()
    warm.model.train_compiled(2)

    # the path: setup (K5 builds the Gram) and 50 eager epochs
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    eager = make_rvpinn(device=DEVICE, dtype=f32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eager_s = _timed(eager.model.train) / EPOCHS
    launches = dict(cuda_build.launch_counts)
    losses, _, accs = eager.model.get_training_history()
    log(f"RVPINN n={RVPINN_N} cells={eager.mesh.n_cells} quadrature points="
        f"{eager.basis.integration_points.shape[0] * eager.basis.integration_points.shape[1]} "
        f"inner dofs={eager.gram_inv.shape[0]}: setup {setup_s:.3f} s; launches {launches}")
    check(launches["p1_element_2d"] >= 1,
          f"K5 launched in the RVPINN setup ({launches['p1_element_2d']})")
    check(len(losses) == EPOCHS and bool(np.isfinite(losses).all()),
          f"train(): {len(losses)} finite losses")
    check(losses[-1] < losses[0], f"train(): loss {losses[0]:.6e} -> {losses[-1]:.6e} decreases")

    blocked = make_rvpinn(device=DEVICE, dtype=f32)
    blocked_s = _timed(lambda: blocked.model.train_compiled(RVPINN_BLOCK)) / EPOCHS
    blosses = blocked.model.get_training_history()[0]
    diff = _rel_curve(blosses, losses)
    check(len(blosses) == EPOCHS and bool(np.isfinite(blosses).all()),
          f"train_compiled({RVPINN_BLOCK}): {len(blosses)} finite losses")
    check(diff <= 1e-4, f"train_compiled({RVPINN_BLOCK}) vs train() f32 loss history: "
          f"rel {diff:.3e} <= 1e-4")

    r64 = make_rvpinn(epochs=10, device=DEVICE, dtype=torch.float64)
    r64.model.train()
    d64 = _rel_curve(losses[:10], r64.model.get_training_history()[0])
    check(d64 <= 1e-2, f"f32 vs f64 10-epoch loss history on the card: rel {d64:.3e} <= 1e-2")

    log(f"RVPINN f32 s/epoch: train() {eager_s:.6e}, "
        f"train_compiled({RVPINN_BLOCK}) {blocked_s:.6e}; "
        f"loss {losses[0]:.6e} -> {losses[-1]:.6e}, relative H1 {accs[0]:.4f} -> {accs[-1]:.4f}")
    log(json.dumps({
        "metric": "rvpinn_s_per_epoch",
        "n": RVPINN_N,
        "epochs": EPOCHS,
        "train_s_per_epoch": eager_s,
        "train_compiled_s_per_epoch": blocked_s,
        "block_size": RVPINN_BLOCK,
        "card": card,
    }))

    # one profiled block: where an epoch's time goes
    prof_model = make_rvpinn(epochs=RVPINN_BLOCK, device=DEVICE, dtype=f32)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall = _timed(lambda: prof_model.model.train_compiled(RVPINN_BLOCK))
    kernels, device_ms = _device_kernels(prof, RVPINN_BLOCK)
    wall_ms = 1e3 * wall / RVPINN_BLOCK
    log(f"profile, one block of {RVPINN_BLOCK} epochs: wall {wall_ms:.3f} ms per epoch under the "
        f"profiler, device {device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.3f} "
        f"({1 - device_ms / (1e3 * blocked_s):.3f} of the unprofiled train_compiled epoch), "
        f"{sum(k[1] for k in kernels):.0f} kernel launches per epoch")
    log("device ms/epoch  launches/epoch  kernel")
    for us, count, name in kernels[:20]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    return launches


def _labelled(fn, name):
    """``fn`` inside a profiler range named ``name``."""
    import torch

    def run(*args):
        with torch.profiler.record_function(name):
            return fn(*args)

    return run


def _range_device_ms(prof, name: str, per: int) -> float:
    """Device ms per run of the kernels launched inside the ranges ``name``
    (the host-side range, whose device time sums its children's kernels)."""
    import torch

    for evt in prof.key_averages():
        if evt.key == name and evt.device_type == torch.autograd.DeviceType.CPU:
            for attr in ("device_time_total", "cuda_time_total"):
                value = getattr(evt, attr, None)
                if value:
                    return float(value) / 1e3 / per
    return 0.0


def phase_dfn_rvpinn(card):
    """Phase 13: the seven-fracture DFN RVPINN at h=0.1 on the card."""
    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench_vpinn import DFN_EPOCHS, make_dfn_rvpinn
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    f32, f64 = torch.float32, torch.float64
    marks = [("start", time.perf_counter())]
    mesh64 = pt.build_benchmark_network(DFN_H, device=DEVICE, dtype=f64)
    mesh32 = mesh64.to(dtype=f32)

    def make(warm, epochs=DFN_EPOCHS, dtype=f32):
        return make_dfn_rvpinn(
            DFN_H, warm=warm, epochs=epochs, mesh=mesh32 if dtype == f32 else mesh64,
            device=DEVICE, dtype=dtype,
        )

    warmup = make(True, epochs=2)  # library handles, allocator
    warmup.model.train()
    warmup.model.train_compiled(2)
    del warmup
    marks.append(("mesh + warm-up", time.perf_counter()))

    # the path: setup, whose oracle runs K2 once per PCG iteration, then
    # 20 warm-started epochs of train()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    runs = {"warm train()": make(True)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches = dict(cuda_build.launch_counts)
    warm = runs["warm train()"]
    V, info = warm.basis, warm.oracle_info
    b_norm = V.reduce(V.integrate_linear_form(lambda b: b.v)).norm()
    rel = float(info.residual_norm / b_norm)
    log(f"DFN RVPINN h={DFN_H}: cells={warm.mesh.n_cells} dofs={V.n_dofs}; setup {setup_s:.3f} s; "
        f"oracle {info.iterations} PCG iterations to rel residual {rel:.4e}; launches {launches}")
    check((warm.mesh.n_cells, V.n_dofs) == DFN_SIZE, f"DFN RVPINN size {DFN_SIZE}")
    check(bool(info.converged) and rel <= 1e-6, f"oracle rel residual {rel:.3e} <= 1e-6")
    check(launches["bsr_spmv"] >= info.iterations,
          f"K2 launches {launches['bsr_spmv']} >= oracle iterations {info.iterations}")

    seconds = {}
    seconds["warm train()"] = _timed(warm.model.train) / DFN_EPOCHS
    for name, is_warm, loop in (("cold train()", False, "train"),
                                (f"warm train_compiled({DFN_BLOCK})", True, "compiled"),
                                (f"cold train_compiled({DFN_BLOCK})", False, "compiled")):
        run = runs[name] = make(is_warm)
        train = run.model.train if loop == "train" else (
            lambda m=run.model: m.train_compiled(DFN_BLOCK))
        seconds[name] = _timed(train) / DFN_EPOCHS
    marks.append(("four f32 models, 80 epochs", time.perf_counter()))
    losses = {name: run.model.get_training_history()[0] for name, run in runs.items()}
    for name, hist in losses.items():
        check(len(hist) == DFN_EPOCHS and bool(np.isfinite(hist).all()) and hist[-1] < hist[0],
              f"DFN RVPINN {name}: {len(hist)} finite losses, {hist[0]:.6e} -> {hist[-1]:.6e}")
    d_warm = _rel_curve(losses["warm train()"], losses["cold train()"])
    check(d_warm <= 1e-3, f"DFN RVPINN warm vs cold train() losses: rel {d_warm:.3e} <= 1e-3")
    for start in ("warm", "cold"):
        d = _rel_curve(losses[f"{start} train_compiled({DFN_BLOCK})"], losses[f"{start} train()"])
        check(d <= 1e-4, f"DFN RVPINN {start} train_compiled({DFN_BLOCK}) vs train(): "
              f"rel {d:.3e} <= 1e-4")

    r64 = make(True, epochs=10, dtype=f64)
    r64.model.train()
    u_diff = float((warm.u_fem.double() - r64.u_fem).norm() / r64.u_fem.norm())
    check(u_diff <= 1e-4, f"oracle f32 vs f64 on the card: rel L2 {u_diff:.3e} <= 1e-4 "
          f"(f64: {r64.oracle_info.iterations} iterations)")
    d64 = _rel_curve(losses["warm train()"][:10], r64.model.get_training_history()[0])
    check(d64 <= 1e-2, f"DFN RVPINN f32 vs f64 10-epoch losses on the card: rel {d64:.3e} <= 1e-2")
    marks.append(("f64 model, 10 epochs", time.perf_counter()))

    iterations = {}
    for name in ("warm train()", "cold train()"):
        it = runs[name].gram_solve.iterations
        iterations[name] = (float(np.mean(it["forward"])), float(np.mean(it["backward"])))
        log(f"Gram PCG iterations, {name}: forward {it['forward']}, backward {it['backward']}")
    check(iterations["warm train()"][1] < iterations["cold train()"][0],
          "the backward solve from its a x seed takes fewer iterations than a solve from zero "
          f"({iterations['warm train()'][1]:.1f} < {iterations['cold train()'][0]:.1f})")
    accs = warm.model.get_training_history()[2]
    log("DFN RVPINN f32 s/epoch: " + "; ".join(f"{k} {v:.6e}" for k, v in seconds.items())
        + f"; relative H1 to FEM {accs[0]:.4f} -> {accs[-1]:.4f}")
    log(json.dumps({
        "metric": "dfn_rvpinn_s_per_epoch",
        "h": DFN_H,
        "cells": warm.mesh.n_cells,
        "dofs": V.n_dofs,
        "epochs": DFN_EPOCHS,
        "s_per_epoch": seconds,
        "gram_iterations_forward_backward": iterations,
        "oracle_iterations": info.iterations,
        "oracle_k2_launches": launches["bsr_spmv"],
        "card": card,
    }))

    # one profiled block: where a warm epoch's time goes
    prof_run = make(True, epochs=DFN_BLOCK)
    gram = prof_run.gram_solve
    gram.matvec = _labelled(gram.matvec, DFN_RANGES[0])
    gram.precond = _labelled(gram.precond, DFN_RANGES[1])
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall = _timed(lambda: prof_run.model.train_compiled(DFN_BLOCK))
    kernels, device_ms = _device_kernels(prof, DFN_BLOCK)
    wall_ms = 1e3 * wall / DFN_BLOCK
    reads = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and "Memcpy DtoH" in e.name) / DFN_BLOCK
    compiled_s = seconds[f"warm train_compiled({DFN_BLOCK})"]
    log(f"profile, one warm block of {DFN_BLOCK} epochs: wall {wall_ms:.3f} ms per epoch under the "
        f"profiler, device {device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.3f} "
        f"({1 - device_ms / (1e3 * compiled_s):.3f} of the unprofiled train_compiled epoch), "
        f"{sum(k[1] for k in kernels):.0f} kernel launches and {reads:.1f} host reads "
        f"(Memcpy DtoH) per epoch; Gram PCG iterations per epoch forward "
        f"{np.mean(gram.iterations['forward']):.1f}, backward {np.mean(gram.iterations['backward']):.1f}")
    split = {name: _range_device_ms(prof, name, DFN_BLOCK) for name in DFN_RANGES}
    for bucket, keys in DFN_BUCKETS:
        split[bucket] = sum(us for us, _, kname in kernels if any(k in kname for k in keys)) / 1e3
    log("device ms per epoch by part: " + "; ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"; all kernels {device_ms:.4f}")
    log("device ms/epoch  launches/epoch  kernel")
    for us, count, name in kernels[:20]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    marks.append(("profiled block", time.perf_counter()))
    log("phase 13 seconds: " + "; ".join(
        f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1) in zip(marks, marks[1:])))
    return launches


def phase_posteriori(card):
    """Phase 14: the estimator RVPINN at the RVPINN bench size on the card."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench_vpinn import EPOCHS, make_posteriori_rvpinn
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    f32 = torch.float32
    marks = [("start", time.perf_counter())]
    warm = make_posteriori_rvpinn(epochs=2, device=DEVICE, dtype=f32)  # handles, allocator
    warm.model.train()
    warm.model.train_compiled(2)
    del warm
    marks.append(("warm-up", time.perf_counter()))

    # the path: setup (K5 builds the Gram) and 50 eager epochs
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    eager = make_posteriori_rvpinn(device=DEVICE, dtype=f32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = dict(cuda_build.launch_counts)
    terms = [float(t.detach()) for t in eager.loss_terms(eager.network)]
    total = sum(terms)
    eager_s = _timed(eager.model.train) / EPOCHS
    launches = dict(cuda_build.launch_counts)
    losses, _, accs = eager.model.get_training_history()
    V, E = eager.basis, eager.edges
    log(f"estimator RVPINN n={RVPINN_N} cells={eager.mesh.n_cells} interior edges="
        f"{E.mesh.n_interior_edges} quadrature points {V.integration_points.shape[0] * V.integration_points.shape[1]} "
        f"(cells) + {E.integration_points.shape[0] * E.integration_points.shape[1]} (edges); "
        f"setup {setup_s:.3f} s; launches in the setup {setup_launches}, in the run {launches}")
    check(setup_launches["p1_element_2d"] == 1,
          f"K5 launched once in the estimator RVPINN setup ({setup_launches['p1_element_2d']})")
    check(abs(total - losses[0]) <= 1e-5 * abs(losses[0]),
          f"the three terms sum to the first loss ({total:.6e} vs {losses[0]:.6e})")
    log(f"first loss {losses[0]:.6e}: weak share {terms[0] / total:.4f}, estimator share "
        f"{(terms[1] + terms[2]) / total:.4f} (bulk {terms[1] / total:.4f}, jump {terms[2] / total:.4f})")
    check(len(losses) == EPOCHS and bool(np.isfinite(losses).all()),
          f"estimator RVPINN train(): {len(losses)} finite losses")
    check(losses[-1] < losses[0],
          f"estimator RVPINN train(): loss {losses[0]:.6e} -> {losses[-1]:.6e} decreases")

    blocked = make_posteriori_rvpinn(device=DEVICE, dtype=f32)
    blocked_s = _timed(lambda: blocked.model.train_compiled(RVPINN_BLOCK)) / EPOCHS
    blosses = blocked.model.get_training_history()[0]
    diff = _rel_curve(blosses, losses)
    check(len(blosses) == EPOCHS and bool(np.isfinite(blosses).all()),
          f"estimator RVPINN train_compiled({RVPINN_BLOCK}): {len(blosses)} finite losses")
    check(diff <= 1e-4, f"estimator RVPINN train_compiled({RVPINN_BLOCK}) vs train() f32 losses: "
          f"rel {diff:.3e} <= 1e-4")
    marks.append(("two f32 models, 100 epochs", time.perf_counter()))

    r64 = make_posteriori_rvpinn(epochs=10, device=DEVICE, dtype=torch.float64)
    r64.model.train()
    d64 = _rel_curve(losses[:10], r64.model.get_training_history()[0])
    check(d64 <= 1e-2, f"estimator RVPINN f32 vs f64 10-epoch losses on the card: rel {d64:.3e} <= 1e-2")
    marks.append(("f64 model, 10 epochs", time.perf_counter()))

    log(f"estimator RVPINN f32 s/epoch: train() {eager_s:.6e}, "
        f"train_compiled({RVPINN_BLOCK}) {blocked_s:.6e}; "
        f"loss {losses[0]:.6e} -> {losses[-1]:.6e}, relative H1 {accs[0]:.4f} -> {accs[-1]:.4f}")
    log(json.dumps({
        "metric": "posteriori_s_per_epoch",
        "n": RVPINN_N,
        "epochs": EPOCHS,
        "train_s_per_epoch": eager_s,
        "train_compiled_s_per_epoch": blocked_s,
        "block_size": RVPINN_BLOCK,
        "card": card,
    }))

    # one profiled block: where an epoch's time goes
    prof_run = make_posteriori_rvpinn(epochs=POSTERIORI_PROFILED, device=DEVICE, dtype=f32)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall = _timed(lambda: prof_run.model.train_compiled(POSTERIORI_PROFILED))
    kernels, device_ms = _device_kernels(prof, POSTERIORI_PROFILED)
    wall_ms = 1e3 * wall / POSTERIORI_PROFILED
    reads = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and "Memcpy DtoH" in e.name) / POSTERIORI_PROFILED
    log(f"profile, one block of {POSTERIORI_PROFILED} epochs: wall {wall_ms:.3f} ms per epoch under "
        f"the profiler, device {device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.3f} "
        f"({1 - device_ms / (1e3 * blocked_s):.3f} of the unprofiled train_compiled epoch), "
        f"{sum(k[1] for k in kernels):.0f} kernel launches and {reads:.1f} host reads "
        f"(Memcpy DtoH) per epoch")
    split, taken = {}, set()
    for bucket, keys in POSTERIORI_BUCKETS:
        hits = [k for k in kernels if k[2] not in taken and any(key in k[2] for key in keys)]
        taken.update(k[2] for k in hits)
        split[bucket] = sum(k[0] for k in hits) / 1e3
        log(f"  {bucket}: " + ", ".join(f"{k[2][:60]} ({k[1]:.0f}/epoch)" for k in hits))
    split["the rest"] = device_ms - sum(split.values())
    log("device ms per epoch by part: " + "; ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"; all kernels {device_ms:.4f}")
    log("device ms/epoch  launches/epoch  kernel")
    for us, count, name in kernels[:20]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    marks.append(("profiled block", time.perf_counter()))
    log("phase 14 seconds: " + "; ".join(
        f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1) in zip(marks, marks[1:])))
    return launches


def _trace_edge_sets(mesh):
    """For every pair of fractures (f, g) that meet, the edges of f and the
    edges of g that lie on their intersection, as sets of sorted global
    vertex pairs (``tests/test_dfn.py``'s invariant, for any network): the
    two sets are equal where the traces conform. Host float64, from the
    mesh's source triangulations."""
    from pytorch_fem_solver_tpu_torch.mesh import fit_affine_maps

    src = mesh._sources
    jac, trans, _, inv_jac = fit_affine_maps(src["anchors_2d"], src["corners_3d"])
    normals = np.cross(jac[..., 0], jac[..., 1])
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    gids = mesh["global", "ids"].cpu().numpy().reshape(-1)
    parts, offset = [], 0
    for f, t in enumerate(src["triangulations"]):
        v2 = np.asarray(t["vertices"], dtype=np.float64)
        tri = np.asarray(t["triangles"])
        p3 = v2 @ jac[f].T + trans[f, :, 0]
        edges = np.unique(np.sort(tri[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2), axis=1), axis=0)
        parts.append((p3, edges, gids[offset:offset + v2.shape[0]], v2.min(0), v2.max(0)))
        offset += v2.shape[0]
    scale = max(1.0, max(float(np.abs(p[0]).max()) for p in parts))
    tol = 1e-9 * scale
    sets = {}
    for f, (p3, edges, g_ids, _, _) in enumerate(parts):
        for g, (_, _, _, lo, hi) in enumerate(parts):
            if g == f:
                continue
            d = (p3 - trans[g, :, 0]) @ normals[g]
            x2 = (p3 - trans[g, :, 0]) @ inv_jac[g].T
            on = (np.abs(d) < tol) & (x2 >= lo - tol).all(1) & (x2 <= hi + tol).all(1)
            sel = on[edges].all(1)
            if sel.any():
                sets[(f, g)] = set(map(tuple, np.sort(g_ids[edges[sel]], axis=1)))
    return sets


def _true_residual(V, u, b, form=None):
    """||b - A u|| / ||b|| over the inner DOFs in float64, and its float32
    rounding scale eps32 || |A| |u| || / ||b||. A is the level's operator
    (``form``, by default the stiffness) from its float32 element matrices,
    assembled as a sparse COO matrix through the basis's own DOF map:
    neither the BSR layout nor K2."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import _stiffness

    local = V.integrate_bilinear_form_local(form or _stiffness)
    vals = V.reshape_for_assembly(local, "bilinear").double()
    rows, cols = (i.long() for i in V._basis_parameters["bilinear_form_idx"])
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (V.n_dofs, V.n_dofs)).coalesce()
    a_abs = torch.sparse_coo_tensor(a.indices(), a.values().abs(), a.shape)
    u64 = u.double().reshape(-1, 1)
    r = V.reduce(b.double() - torch.sparse.mm(a, u64))
    au = V.reduce(torch.sparse.mm(a_abs, u64.abs()))
    b_in = V.reduce(b.double())
    eps = torch.finfo(torch.float32).eps
    return float(r.norm() / b_in.norm()), float(eps * au.norm() / b_in.norm())


def phase_adaptive(card, mesh32, mesh64):
    """Phase 15: the adaptive DFN loop on the h=0.03 benchmark network,
    driven through ``bench.adaptive_dfn``."""
    from pytorch_fem_solver_tpu_torch.bench import (
        _stiffness,
        _unit_load,
        adaptive_dfn,
        adaptive_dfn_level,
    )
    from pytorch_fem_solver_tpu_torch.mesh import dorfler_mark
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    check(getattr(mesh32, "_sources", None) is not None,
          "phase 1's mesh carries its host triangulations (_sources)")
    k2_total, rows, cells_before = 0, [], None
    cuda_build.reset_launch_counts()
    levels = adaptive_dfn(mesh32, ADAPTIVE_LEVELS, ADAPTIVE_THETA, tol=TOL)
    for level, lv in enumerate(levels):
        # the count of this level's solve and estimate, read before any
        # launch of the checks below
        k2 = cuda_build.launch_counts["bsr_spmv"]
        k2_total += k2
        mesh, V, info = lv.mesh, lv.basis, lv.info
        b = V.integrate_linear_form(_unit_load)
        rel = float(info.residual_norm / V.reduce(b).norm())
        true_rel, rounding = _true_residual(V, lv.u, b)
        local = V.integrate_bilinear_form_local(_stiffness)
        solve_ms = 1e3 * _timed(lambda: V.solve_iterative(
            local, b, tol=TOL, precondition="two_level", symmetric_form=True))
        eta_norm = float(np.linalg.norm(lv.eta))
        marked = int(dorfler_mark(lv.eta, ADAPTIVE_THETA).sum())
        row = {"level": level, "cells": mesh.n_cells, "dofs": lv.n_dofs,
               "iterations": info.iterations, "rel_residual": rel, "true_residual": true_rel,
               "rounding_scale": rounding, "k2_launches": k2, "energy": lv.energy,
               "eta_norm": eta_norm, "marked": marked, "refine_s": lv.seconds["refine"],
               "tables_s": lv.seconds["tables"], "first_solve_s": lv.seconds["solve"],
               "estimator_s": lv.seconds["estimator"], "solve_wall_ms": solve_ms}
        rows.append(row)
        log(f"adaptive level {level}: cells={mesh.n_cells} dofs={lv.n_dofs} iterations={info.iterations} "
            f"rel residual {rel:.4e} (true {true_rel:.4e}, f32 rounding scale {rounding:.4e}) "
            f"K2 launches {k2} energy {lv.energy:.8e} ||eta|| {eta_norm:.6e} marked {marked}; "
            f"host s: refinement {lv.seconds['refine']:.3f}, tables {lv.seconds['tables']:.3f}, "
            f"estimator {lv.seconds['estimator']:.3f}; first solve {lv.seconds['solve']:.3f} s (with "
            f"the preconditioner's tables), solve wall {solve_ms:.2f} ms")
        check(bool(info.converged) and rel <= TOL, f"adaptive level {level}: rel residual {rel:.3e} <= {TOL}")
        bound = TOL + ADAPTIVE_ROUNDING * rounding
        check(true_rel <= bound, f"adaptive level {level}: true residual ||b - A u|| / ||b|| (COO "
              f"operator) {true_rel:.3e} <= {TOL:g} + {ADAPTIVE_ROUNDING:g} x rounding scale "
              f"{rounding:.3e}")
        check(k2 >= info.iterations, f"adaptive level {level}: K2 launches {k2} >= iterations {info.iterations}")
        check(bool(np.isfinite(lv.eta).all()) and lv.eta.shape == (mesh.n_cells,),
              f"adaptive level {level}: eta finite, one per cell")
        if level == 0:
            lv64 = adaptive_dfn_level(mesh64, tol=1e-10)
            d = abs(lv.energy - lv64.energy) / abs(lv64.energy)
            check(d <= 1e-4, f"adaptive level 0 energy f32 vs f64 (tol 1e-10, {lv64.info.iterations} "
                  f"iterations) on the card: rel {d:.3e} <= 1e-4")
            gap = float(np.abs(lv.eta - lv64.eta).max() / np.abs(lv64.eta).max())
            check(gap <= ADAPTIVE_ETA_TOL, f"adaptive level 0 eta f32 vs f64 on the card: "
                  f"max rel {gap:.3e} <= {ADAPTIVE_ETA_TOL:g}")
            m32, m64 = dorfler_mark(lv.eta, ADAPTIVE_THETA), dorfler_mark(lv64.eta, ADAPTIVE_THETA)
            differ = np.flatnonzero(m32 != m64)
            check(differ.size == 0, f"adaptive level 0 Dörfler marks of the f32 and the f64 eta: "
                  f"{int(m64.sum())} marked, {differ.size} differ (cells {differ[:20].tolist()})")
            floor, _ = _true_residual(V, lv64.u.float(), b)
            log(f"adaptive level 0: true residual of the f64 solution rounded to f32 {floor:.4e}")
            row["true_residual_f64_rounded"] = floor
            # the control: a level solved only to ADAPTIVE_CONTROL_TOL must
            # fail both bounds above
            ctl = adaptive_dfn_level(mesh, tol=ADAPTIVE_CONTROL_TOL)
            ctl_rel, _ = _true_residual(V, ctl.u, b)
            ctl_gap = float(np.abs(ctl.eta - lv64.eta).max() / np.abs(lv64.eta).max())
            row["control"] = {"tol": ADAPTIVE_CONTROL_TOL, "iterations": ctl.info.iterations,
                              "true_residual": ctl_rel, "eta_gap": ctl_gap}
            check(ctl_rel > bound and ctl_gap > ADAPTIVE_ETA_TOL, f"adaptive level 0 control "
                  f"(tol {ADAPTIVE_CONTROL_TOL:g}, {ctl.info.iterations} iterations) fails both: true "
                  f"residual {ctl_rel:.3e} > {bound:.3e}, eta gap {ctl_gap:.3e} > {ADAPTIVE_ETA_TOL:g}")
            del lv64, ctl
        else:
            check(mesh.n_cells > cells_before, f"adaptive level {level}: cells grow "
                  f"{cells_before} -> {mesh.n_cells} ({rows[-2]['marked']} cells marked, "
                  f"theta {ADAPTIVE_THETA})")
            sets = _trace_edge_sets(mesh)
            bad = [pair for pair in sets if sets[pair] != sets.get(pair[::-1])]
            check(bool(sets) and not bad, f"adaptive level {level}: the trace edges of "
                  f"{len(sets) // 2} fracture pairs ({sum(map(len, sets.values())) // 2} edges) are "
                  f"the same in both fractures (mismatched: {bad})")
        cells_before = mesh.n_cells
        # the next level's count starts here: the loop refines, then solves
        cuda_build.reset_launch_counts()
    log(json.dumps({"metric": "adaptive_dfn_levels", "h": H, "theta": ADAPTIVE_THETA, "tol": TOL,
                    "levels": rows, "card": card}))
    return k2_total


# -- phase 16: the higher-order compiled solves ----------------------------------


def _single_trace_dofs(V):
    """(trace edges, trace edges with a single P2 midpoint DOF): the global
    edges of the glued network that cells of two or more fractures hold,
    and how many of them carry one midpoint DOF id in all those cells.
    Host NumPy."""
    gids = V.mesh["global", "ids"].cpu().numpy()[:, 0]
    cells = gids[V.mesh["cells", "vertices"].cpu().numpy()]
    pairs = np.sort(cells[:, [[0, 1], [1, 2], [0, 2]]], axis=-1).reshape(-1, 2)
    frac = np.repeat(V.mesh["cells", "fracture"].cpu().numpy()[:, 0], 3)
    mids = V._global_dofs4elements.cpu().numpy()[:, 3:6].reshape(-1)
    _, edge = np.unique(pairs, axis=0, return_inverse=True)
    edge = edge.reshape(-1)

    def distinct_per_edge(values):
        return np.bincount(np.unique(np.stack([edge, values], 1), axis=0)[:, 0])

    trace = distinct_per_edge(frac) >= 2
    return int(trace.sum()), int((trace & (distinct_per_edge(mids) == 1)).sum())


def _higher_order_case(tag, make, load, size, card, ladder=LADDER_TOLS, structure=None,
                       repeats=HIGHER_ORDER_REPEATS, form=None, f32_vs_f64=F32_VS_F64,
                       control_residual=False):
    """One compiled solve of phases 16, 18, 20 and 21: ``make(dtype, tol)``
    builds the basis and its tables and solves once
    (``bench.HigherOrderSolve``) on the card; float32 solves at the
    ``ladder`` tolerances follow, the first the control. ``structure`` is
    the expected (inner DOFs, block-rows, B, spilled block-rows, B2, stored
    blocks); the timed wall is the median of ``repeats`` solves; ``form``
    is the bilinear form (the stiffness by default; the preconditioner is
    ``compiled_solver``'s ``"auto"`` for the basis); ``f32_vs_f64`` the
    bound on the float32 solve's distance from float64 beyond twice the
    float32 floor; with ``control_residual`` the control must also fail
    the true-residual bound. Returns the case's figures and the float32
    solve."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import _stiffness

    form = form or _stiffness
    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        _bsr_spmv_plain,
        bsr_diagonal,
        bsr_expand,
        bsr_matvec,
        bsr_reduce,
        bsr_values_from_local_symmetric,
        default_max_b,
        get_bsr_structure,
    )
    from pytorch_fem_solver_tpu_torch.ops.compiled import bsr_pcg, preconditioner_setup
    from pytorch_fem_solver_tpu_torch.ops.solvers import pcg

    cuda_build.reset_launch_counts()
    r = make(torch.float32, TOL)
    torch.cuda.synchronize()
    k2 = cuda_build.launch_counts["bsr_spmv"]
    V, info = r.basis, r.info
    st = get_bsr_structure(V, max_b=default_max_b(V), want_entry_slot=False)  # the solve's
    (nb, B), (nh, B2) = st.bcols.shape, st.bcols2.shape
    n_stored = int(st.blk_id_host.size)
    cells = int(V._global_dofs4elements.shape[0])
    log(f"{tag}: cells={cells} dofs={V.n_dofs} n_pad={st.n_pad} tier 1 (nb={nb}, B={B}), "
        f"tier 2 (nh={nh}, B2={B2}): {nh} of {nb} block-rows spill; {n_stored} stored blocks")
    check((cells, V.n_dofs) == size, f"{tag}: cells and DOFs {(cells, V.n_dofs)} == {size}")
    if structure is not None:
        got = (st.n_inner, nb, B, nh, B2, n_stored)
        check(got == structure, f"{tag}: structure (inner DOFs, block-rows, B, spilled "
              f"block-rows, B2, stored blocks) {got} == {structure}")
    _check_k2_bytes(tag, st)
    b = V.integrate_linear_form(load)
    rel = float(info.residual_norm / V.reduce(b).norm())
    check(bool(info.converged) and rel <= TOL, f"{tag}: PCG residual {rel:.3e} <= {TOL:g} "
          f"in {info.iterations} iterations")
    issued = _issued(info.iterations)
    check(k2 == issued + 2, f"{tag}: K2 launches {k2} == iterations issued {issued} + 1 + 1 "
          f"(one per iteration issued, {info.iterations} taken; one for the start; one in the "
          "solver's warm-up)")
    check(bool(torch.isfinite(r.u).all()) and r.u.shape == (V.n_dofs, 1),
          f"{tag}: solution finite, shape {tuple(r.u.shape)}")
    true_rel, rounding = _true_residual(V, r.u, b, form)
    bound = TOL + ADAPTIVE_ROUNDING * rounding
    check(true_rel <= bound, f"{tag}: true residual ||b - A u|| / ||b|| (COO operator, float64) "
          f"{true_rel:.3e} <= {TOL:g} + {ADAPTIVE_ROUNDING:g} x rounding scale {rounding:.3e}")

    r64 = make(torch.float64, TOL)
    iters64 = r64.info.iterations

    def rel64(u):
        return float((u.double() - r64.u).norm() / r64.u.norm())

    # the float32 floor: this basis's float32 element matrices and load,
    # solved in float64 to 1e-12 on the same structure. No float32 solve
    # comes closer to the float64 solution than this operator's own.
    values_op = bsr_values_from_local_symmetric(st, V.integrate_bilinear_form_local(form).double())
    x_op, info_op = bsr_pcg(st, "auto", tol=1e-12, basis=V)(values_op, bsr_reduce(st, b.double()))
    floor = rel64(bsr_expand(st, x_op, V.n_dofs))
    del values_op, x_op
    diff = rel64(r.u)
    bound = f32_vs_f64 + 2 * floor
    check(diff <= bound, f"{tag}: f32 vs f64 solution on the card, rel L2 {diff:.3e} <= "
          f"{f32_vs_f64:g} + 2 x the float32 operator floor {floor:.3e} (its float32 element "
          f"matrices solved in float64 to 1e-12, {info_op.iterations} iterations)")
    # the same f32 solve with the plain SpMV in place of K2: the kernel
    # neither costs nor saves iterations
    values32 = bsr_values_from_local_symmetric(st, V.integrate_bilinear_form_local(form))
    diag32 = bsr_diagonal(st, values32)
    _, info_plain = pcg(
        lambda v: _bsr_spmv_plain(st.bcols, values32[0], v, st.bcols2, values32[1], st.heavy_rows),
        bsr_reduce(st, b), precond_diag=diag32,
        precond=preconditioner_setup(st, "auto", V)(values32, diag32), tol=TOL,
    )
    del values32
    check(abs(info.iterations - info_plain.iterations) <= 1, f"{tag}: f32 iterations with K2 "
          f"{info.iterations}, with the plain SpMV {info_plain.iterations} (within 1)")
    check(info.iterations <= iters64 + ITER_GAP, f"{tag}: f32 iterations {info.iterations} at "
          f"most {ITER_GAP} above f64's {iters64} (gap {info.iterations - iters64:+d})")
    # the float32 solve at looser tolerances: where it reaches the floor;
    # the loosest is the control
    tols, ladder = ladder, []
    for tol in tols:
        rt = make(torch.float32, tol)
        rel_t, rounding_t = _true_residual(V, rt.u, b, form)
        ladder.append({"tol": tol, "iterations": rt.info.iterations, "f32_vs_f64": rel64(rt.u),
                       "true_residual": rel_t,
                       "true_residual_bound": TOL + ADAPTIVE_ROUNDING * rounding_t})
        del rt
    log(f"{tag}: f32 tolerance ladder (tol, iterations, f32 vs f64, true residual): "
        + "; ".join(f"{e['tol']:g} {e['iterations']} {e['f32_vs_f64']:.3e} {e['true_residual']:.3e}"
                    for e in ladder))
    ctl_diff = ladder[0]["f32_vs_f64"]
    what = (f"{tag}: control solved to {ladder[0]['tol']:g} ({ladder[0]['iterations']} "
            f"iterations) against the f32-vs-f64 bound: {ctl_diff:.3e} vs {bound:.3e}")
    if floor <= f32_vs_f64:
        check(ctl_diff > bound, what + " (must fail it)")
    else:
        # every float32 solve from the control's tolerance on already lies
        # at the float32 floor, in every solution norm: nothing separates
        # them, so the control is reported, not held
        log(what + f"; the float32 floor {floor:.3e} exceeds {f32_vs_f64:g}, so no solution "
            "norm separates the control from the solve: reported, not held")
    if control_residual:
        ctl = ladder[0]
        check(ctl["true_residual"] > ctl["true_residual_bound"], f"{tag}: control solved to "
              f"{ctl['tol']:g} against the true-residual bound: {ctl['true_residual']:.3e} vs "
              f"{TOL:g} + {ADAPTIVE_ROUNDING:g} x its rounding scale = "
              f"{ctl['true_residual_bound']:.3e} (must fail it)")

    # K2 against its plain version on this structure
    local64 = r64.basis.integrate_bilinear_form_local(form)
    values64 = bsr_values_from_local_symmetric(st, local64)
    x64 = torch.as_tensor(np.random.default_rng(SEED + 16).standard_normal(st.n_pad), device=DEVICE)
    max_abs = _check_k2(tag, st, values64, x64)
    vals32 = tuple(v.to(torch.float32).contiguous() for v in values64)
    x32 = x64.to(torch.float32)
    del r64, local64, values64
    ms = time_ms(lambda: bsr_matvec(st, vals32, x32))
    plain_ms = time_ms(
        lambda: _bsr_spmv_plain(st.bcols, vals32[0], x32, st.bcols2, vals32[1], st.heavy_rows)
    )
    n_bytes, n_flops = _k2_bytes_flops(st)
    b_ms, by = bound_ms(n_bytes, n_flops)

    walls = [_timed(r.solve) for _ in range(repeats)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = _timed(r.solve)
    kernels, device_ms = _device_kernels(prof, 1)
    k2_rows = [(us, count) for us, count, name in kernels if "bsr_spmv" in name]
    k2_us = k2_rows[0][0] / k2_rows[0][1] if k2_rows else float("nan")
    check(bool(k2_rows), f"{tag}: the profiled solve shows K2 on the device")
    figures = {
        "case": tag, "cells": cells, "dofs": V.n_dofs, "n_pad": st.n_pad, "nb": nb, "B": B,
        "nh": nh, "B2": B2, "stored_blocks": n_stored, "iterations": info.iterations,
        "iterations_f64": iters64, "iterations_plain_spmv": info_plain.iterations,
        "rel_residual": rel, "true_residual": true_rel, "rounding_scale": rounding,
        "f32_vs_f64": diff, "f32_operator_floor": floor, "tolerance_ladder": ladder,
        "k2_launches": k2, "median_wall_ms": 1e3 * float(np.median(walls)),
        "walls_ms": [1e3 * w for w in walls], "profiled_wall_ms": 1e3 * wall,
        "device_ms": device_ms, "idle_share": 1 - device_ms / (1e3 * wall),
        "k2_us_per_launch_in_solve": k2_us, "k2_ms": ms, "k2_plain_ms": plain_ms,
        "k2_bound_ms": b_ms, "k2_bound_by": by, "k2_max_abs_err": max_abs,
        "host_s": r.seconds, "card": card,
    }
    log(f"{tag}: median wall {figures['median_wall_ms']:.3f} ms over {repeats} solves "
        f"{['%.3f' % w for w in figures['walls_ms']]}, {info.iterations} iterations, K2 launches {k2}; "
        f"profiled solve: wall {1e3 * wall:.3f} ms, device {device_ms:.3f} ms, idle share "
        f"{figures['idle_share']:.3f}, {sum(k[1] for k in kernels):.0f} launches; K2 in the solve "
        f"{k2_us:.3f} us per launch, alone {1e3 * ms:.3f} us (plain {1e3 * plain_ms:.3f} us), bound "
        f"{1e3 * b_ms:.3f} us by {by}; host s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in r.seconds.items()))
    log("device ms/solve  launches/solve  kernel")
    for us, count, name in kernels[:12]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    return figures, r


def phase_higher_order(card):
    """Phase 16: the P3 compiled solve at full size and the P2 DFN solve."""
    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import _sine_load, _unit_load, dfn_p2_solve, p3_poisson

    p3, _ = _higher_order_case(
        f"P3 rectangle({P3_N}, {P3_N})",
        lambda dtype, tol: p3_poisson(P3_N, tol=tol, device=DEVICE, dtype=dtype),
        _sine_load, P3_SIZE, card,
    )
    meshes = {torch.float64: pt.build_benchmark_network(DFN_H, device=DEVICE, dtype=torch.float64)}
    meshes[torch.float32] = meshes[torch.float64].to(dtype=torch.float32)
    dfn, r = _higher_order_case(
        f"P2 DFN h={DFN_H}", lambda dtype, tol: dfn_p2_solve(meshes[dtype], tol=tol),
        _unit_load, P2_DFN_SIZE, card,
    )
    n_trace, n_single = _single_trace_dofs(r.basis)
    check(n_trace > 0 and n_single == n_trace, f"P2 DFN: {n_single} of {n_trace} trace edges have "
          "a single midpoint DOF")
    dofs = r.basis._global_dofs4elements
    check(int(dofs.max()) + 1 == r.basis.n_dofs, f"P2 DFN: every DOF id is used "
          f"({int(dofs.max()) + 1} == {r.basis.n_dofs})")
    log(json.dumps({"metric": "higher_order_solves", "tol": TOL, "cases": [p3, dfn]}))
    return p3["k2_launches"], dfn["k2_launches"]


# -- phase 17: the patch RVPINN --------------------------------------------------


def _check_k5_patches(tag, coords64):
    """K5 against its plain version on the (T, 3, 2) patch cells, float64
    (1e-12) and float32 (1e-5), relative to each output row's max; a row
    that is zero in every cell (a patch's right angles sit at the same
    local vertices, so some stiffness entries vanish everywhere) relative
    to the largest row's. Returns the float32 max absolute error."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops.kernels import p1_element_2d

    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        c = coords64.to(dtype).contiguous()
        out = p1_element_2d(c, None)
        ref = _k5_plain(c, None)
        torch.cuda.synchronize()
        row_max = ref.abs().amax(dim=1)
        scale = torch.where(row_max > 0, row_max, row_max.max())
        err = float(((out - ref).abs().amax(dim=1) / scale).max())
        check(bool(torch.isfinite(out).all()) and err <= tol,
              f"K5 {tag} {dtype} vs plain: rel err {err:.3e} <= {tol:g}")
    return float((out - ref).abs().max())


def phase_patches(card):
    """Phase 17: the patch RVPINN at the example's size and deeper."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench_vpinn import (
        EPOCHS,
        PATCH_LEVELS,
        make_patches_rvpinn,
        patch_gram,
    )
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    f32 = torch.float32
    warm = make_patches_rvpinn(epochs=2, device=DEVICE, dtype=f32)
    warm.model.train()
    warm.model.train_compiled(2)

    setup_launches, rows = None, []
    for levels in (PATCH_LEVELS, PATCH_LEVELS_DEEP):
        tag = f"patch RVPINN levels={levels}"
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        eager = make_patches_rvpinn(levels, device=DEVICE, dtype=f32)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        setup = dict(cuda_build.launch_counts)
        setup_launches = setup_launches or setup
        cuda_build.reset_launch_counts()
        eager_s = _timed(eager.model.train) / EPOCHS
        k5_eager = cuda_build.launch_counts["p1_element_2d"]
        losses = eager.model.get_training_history()[0]
        blocked = make_patches_rvpinn(levels, device=DEVICE, dtype=f32)
        cuda_build.reset_launch_counts()
        blocked_s = _timed(lambda: blocked.model.train_compiled(PATCH_BLOCK)) / EPOCHS
        k5_blocked = cuda_build.launch_counts["p1_element_2d"]
        blosses = blocked.model.get_training_history()[0]
        B, T = eager.patches.batch_size()[0], eager.patches.n_cells
        log(f"{tag}: {B} patches, {B * T} cells, error mesh {eager.error_basis.mesh.n_cells} "
            f"cells; setup {setup_s:.3f} s, launches {setup}")
        check(setup["p1_element_2d"] >= 1, f"{tag}: K5 launched in the setup "
              f"({setup['p1_element_2d']}, one per Gram)")
        check(k5_eager == 0 and k5_blocked == 0, f"{tag}: K5 never launched per epoch "
              f"(train() {k5_eager}, train_compiled {k5_blocked})")
        for name, hist in (("train()", losses), (f"train_compiled({PATCH_BLOCK})", blosses)):
            check(len(hist) == EPOCHS and bool(np.isfinite(hist).all()) and hist[-1] < hist[0],
                  f"{tag} {name}: {len(hist)} finite losses, {hist[0]:.6e} -> {hist[-1]:.6e}")
        diff = _rel_curve(blosses, losses)
        check(diff <= 1e-4, f"{tag}: train_compiled({PATCH_BLOCK}) vs train() f32 loss history: "
              f"rel {diff:.3e} <= 1e-4")

        r64 = make_patches_rvpinn(levels, epochs=10, device=DEVICE, dtype=torch.float64)
        for basis in (r64.basis, r64.validation_basis):
            gram = patch_gram(basis)
            ref = basis.reduce(basis.integrate_bilinear_form(lambda b: b.v_grad @ b.v_grad.mT))
            err = float((gram - ref).abs().max() / ref.abs().max())
            check(gram.shape == (B, 1, 1) and err <= 1e-12, f"{tag}: K5 Gram vs "
                  f"integrate_bilinear_form + reduce, float64, {basis.element.integration_order}-"
                  f"point rule: rel {err:.3e} <= 1e-12")
        _check_k5_patches(f"{tag} patch cells", r64.patches["cells", "coordinates"].reshape(-1, 3, 2))
        if levels == PATCH_LEVELS:
            r64.model.train()
            d64 = _rel_curve(losses[:10], r64.model.get_training_history()[0])
            check(d64 <= 1e-2, f"{tag}: f32 vs f64 10-epoch loss history on the card: "
                  f"rel {d64:.3e} <= 1e-2")
        del r64

        prof_model = make_patches_rvpinn(levels, epochs=PATCH_BLOCK, device=DEVICE, dtype=f32)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            wall = _timed(lambda: prof_model.model.train_compiled(PATCH_BLOCK))
        kernels, device_ms = _device_kernels(prof, PATCH_BLOCK)
        wall_ms = 1e3 * wall / PATCH_BLOCK
        launches = sum(k[1] for k in kernels)
        row = {"levels": levels, "patches": B, "cells": B * T, "setup_s": setup_s,
               "train_s_per_epoch": eager_s, "train_compiled_s_per_epoch": blocked_s,
               "block_size": PATCH_BLOCK, "launches_per_epoch": launches,
               "device_ms_per_epoch": device_ms, "profiled_wall_ms_per_epoch": wall_ms,
               "idle_share": 1 - device_ms / wall_ms,
               "idle_share_unprofiled": 1 - device_ms / (1e3 * blocked_s),
               "loss_first": losses[0], "loss_last": losses[-1]}
        rows.append(row)
        log(f"{tag} f32 s/epoch: train() {eager_s:.6e}, train_compiled({PATCH_BLOCK}) "
            f"{blocked_s:.6e}; profiled block: wall {wall_ms:.3f} ms per epoch, device "
            f"{device_ms:.3f} ms, idle share {row['idle_share']:.3f} "
            f"({row['idle_share_unprofiled']:.3f} of the unprofiled epoch), {launches:.0f} "
            "launches per epoch")
        log("device ms/epoch  launches/epoch  kernel")
        for us, count, name in kernels[:10]:
            log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    log(json.dumps({"metric": "patch_rvpinn_s_per_epoch", "epochs": EPOCHS, "sizes": rows,
                    "card": card}))
    return setup_launches


# -- phase 18: the tetrahedral tier ----------------------------------------------


def _tet_make(n, order):
    """``make(dtype, tol)`` of ``_higher_order_case`` for the sine problem
    on ``unit_cube(n)``: the first float32 solve through
    ``bench.tet_poisson`` (the host's mesh timed with it), the rest
    through ``bench.tet_solve`` on that mesh, the float64 twin on its own
    ``MeshTet`` built from the host triangulation."""
    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import tet_poisson, tet_solve

    meshes = {}

    def make(dtype, tol):
        if dtype not in meshes:
            if dtype == torch.float32:
                r = tet_poisson(n, order, tol=tol, device=DEVICE, dtype=dtype)
                meshes[dtype] = r.basis.mesh
                return r
            meshes[dtype] = pt.MeshTet(pt.unit_cube(n), device=DEVICE, dtype=dtype)
        return tet_solve(meshes[dtype], order, tol=tol)

    return make


def _dorfler_ties(eta, eta64, theta):
    """The Dörfler marks of ``eta`` and ``eta64`` and where they differ.
    The tie band is the cells whose ``eta64`` lies within twice the
    largest |eta - eta64| of the threshold (the ``eta64`` of the last cell
    ``eta64`` marks): the structured Fichera mesh holds cells that the
    domain's symmetry gives one estimate, and rounding orders them, so a
    cut through such a group may mark either member. Returns (marks of
    eta, marks of eta64, differing cells, cells in the band, whether every
    differing cell lies in it)."""
    from pytorch_fem_solver_tpu_torch.mesh import dorfler_mark

    m, m64 = dorfler_mark(eta, theta), dorfler_mark(eta64, theta)
    differ = np.flatnonzero(m != m64)
    threshold = float(eta64[m64].min())
    near = np.abs(eta64 - threshold) <= 2 * float(np.abs(eta - eta64).max())
    return m, m64, differ, int(near.sum()), bool(near[differ].all())


def _fichera(card):
    """Phase 18's adaptive Fichera loop: ``bench.adaptive_tet`` on
    ``fichera_corner(FICHERA_N)``, float32, PCG to ``TOL``."""
    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import (
        _stiffness,
        _unit_load,
        adaptive_tet,
        adaptive_tet_level,
    )
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    tri = pt.fichera_corner(FICHERA_N)
    k2_total, rows, cells_before = 0, [], None
    cuda_build.reset_launch_counts()
    levels = adaptive_tet(tri, FICHERA_LEVELS, FICHERA_THETA, tol=TOL, device=DEVICE,
                          dtype=torch.float32)
    for level, lv in enumerate(levels):
        # this level's solve and estimate, read before the checks launch more
        k2 = cuda_build.launch_counts["bsr_spmv"]
        k2_total += k2
        mesh, V, info = lv.mesh, lv.basis, lv.info
        b = V.integrate_linear_form(_unit_load)
        rel = float(info.residual_norm / V.reduce(b).norm())
        true_rel, rounding = _true_residual(V, lv.u, b)
        local = V.integrate_bilinear_form_local(_stiffness)
        solve_ms = 1e3 * _timed(lambda: V.solve_iterative(
            local, b, tol=TOL, precondition="two_level", symmetric_form=True))
        eta_norm = float(np.linalg.norm(lv.eta))
        row = {"level": level, "cells": mesh.n_cells, "vertices": mesh.n_vertices,
               "dofs": lv.n_dofs, "inner_dofs": int(V._basis_parameters["inner_dofs"].numel()),
               "iterations": info.iterations, "rel_residual": rel, "true_residual": true_rel,
               "rounding_scale": rounding, "k2_launches": k2, "energy": lv.energy,
               "eta_norm": eta_norm, "marked": int(lv.marked.sum()),
               "host_s": dict(lv.seconds), "solve_wall_ms": solve_ms}
        rows.append(row)
        log(f"Fichera level {level}: cells={mesh.n_cells} dofs={lv.n_dofs} (inner "
            f"{row['inner_dofs']}) iterations={info.iterations} rel residual {rel:.4e} (true "
            f"{true_rel:.4e}, f32 rounding scale {rounding:.4e}) K2 launches {k2} energy "
            f"{lv.energy:.8e} ||eta|| {eta_norm:.6e} marked {row['marked']}; host s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in lv.seconds.items())
            + f"; solve wall {solve_ms:.2f} ms")
        check(bool(info.converged) and rel <= TOL, f"Fichera level {level}: rel residual {rel:.3e} <= {TOL}")
        bound = TOL + ADAPTIVE_ROUNDING * rounding
        check(true_rel <= bound, f"Fichera level {level}: true residual ||b - A u|| / ||b|| (COO "
              f"operator) {true_rel:.3e} <= {TOL:g} + {ADAPTIVE_ROUNDING:g} x rounding scale "
              f"{rounding:.3e}")
        check(k2 >= info.iterations, f"Fichera level {level}: K2 launches {k2} >= iterations "
              f"{info.iterations}")
        check(bool(np.isfinite(lv.eta).all()) and lv.eta.shape == (mesh.n_cells,),
              f"Fichera level {level}: eta finite, one per cell")
        if level == 0:
            got = (mesh.n_cells, mesh.n_vertices, row["inner_dofs"])
            check(got == FICHERA_SIZE, f"Fichera level 0: cells, vertices, inner DOFs {got} == "
                  f"{FICHERA_SIZE}")
            lv64 = adaptive_tet_level(pt.MeshTet(tri, device=DEVICE, dtype=torch.float64), tol=1e-10)
            d = abs(lv.energy - lv64.energy) / abs(lv64.energy)
            check(d <= 1e-4, f"Fichera level 0 energy f32 vs f64 (tol 1e-10, "
                  f"{lv64.info.iterations} iterations) on the card: rel {d:.3e} <= 1e-4")
            gap = float(np.abs(lv.eta - lv64.eta).max() / np.abs(lv64.eta).max())
            check(gap <= ADAPTIVE_ETA_TOL, f"Fichera level 0 eta f32 vs f64 on the card: max rel "
                  f"{gap:.3e} <= {ADAPTIVE_ETA_TOL:g}")
            m32, m64, differ, band, in_band = _dorfler_ties(lv.eta, lv64.eta, FICHERA_THETA)
            check(np.array_equal(m32, lv.marked) and in_band, f"Fichera level 0 Dörfler marks "
                  f"of the f32 and the f64 eta: {int(m64.sum())} and {int(m32.sum())} marked, "
                  f"{differ.size} differ, every one in the tie band of the threshold ({band} "
                  f"cells; differing: {differ[:12].tolist()})")
            row.update(energy_f64=lv64.energy, eta_gap=gap, marks_differ=int(differ.size),
                       tie_band_cells=band)
            ctl = adaptive_tet_level(mesh, tol=ADAPTIVE_CONTROL_TOL)
            ctl_rel, _ = _true_residual(V, ctl.u, b)
            ctl_gap = float(np.abs(ctl.eta - lv64.eta).max() / np.abs(lv64.eta).max())
            row["control"] = {"tol": ADAPTIVE_CONTROL_TOL, "iterations": ctl.info.iterations,
                              "true_residual": ctl_rel, "eta_gap": ctl_gap}
            check(ctl_rel > bound and ctl_gap > ADAPTIVE_ETA_TOL, f"Fichera level 0 control (tol "
                  f"{ADAPTIVE_CONTROL_TOL:g}, {ctl.info.iterations} iterations) fails both: true "
                  f"residual {ctl_rel:.3e} > {bound:.3e}, eta gap {ctl_gap:.3e} > "
                  f"{ADAPTIVE_ETA_TOL:g}")
            del lv64, ctl
        else:
            check(mesh.n_cells > cells_before, f"Fichera level {level}: cells grow {cells_before} "
                  f"-> {mesh.n_cells} ({rows[-2]['marked']} cells marked, theta {FICHERA_THETA})")
        cells_before = mesh.n_cells
        del mesh, V, info, local, lv
        # the next level's count starts here: the loop refines, then solves
        cuda_build.reset_launch_counts()
    log(json.dumps({"metric": "adaptive_fichera_levels", "n": FICHERA_N, "theta": FICHERA_THETA,
                    "tol": TOL, "levels": rows, "card": card}))
    return k2_total


def phase_tets(card):
    """Phase 18: the 3D Poisson solves at P1 and P2 and the adaptive
    Fichera loop, float32 with float64 twins on the card."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import _sine_load_3d

    p1, r = _higher_order_case(f"P1 unit_cube({TET_N})", _tet_make(TET_N, 1), _sine_load_3d,
                               TET_SIZE, card, ladder=(ADAPTIVE_CONTROL_TOL,),
                               structure=TET_STRUCTURE)
    del r
    torch.cuda.empty_cache()
    p2, r = _higher_order_case(f"P2 unit_cube({TET_P2_N})", _tet_make(TET_P2_N, 2), _sine_load_3d,
                               TET_P2_SIZE, card, ladder=(ADAPTIVE_CONTROL_TOL,))
    del r
    torch.cuda.empty_cache()
    log(json.dumps({"metric": "tet_solves", "tol": TOL, "cases": [p1, p2]}))
    return p1["k2_launches"], p2["k2_launches"], _fichera(card)


# -- phase 19: the 3D RVPINN -------------------------------------------------------


def _vpinn_3d_block(tag, run, net0, card, scheduler=None):
    """Phase 19 at one width and Gram method: ``run`` (a built
    ``make_vpinn_3d``) trains ``VPINN3D_EPOCHS`` epochs through ``train()``,
    a model on a copy of its initial network ``net0`` the same through
    ``train_compiled(VPINN3D_BLOCK)``; finite decreasing losses, the loops
    within 1e-4 (the card's scatters sum with atomics); s/epoch of both;
    one profiled block (device ms, launches, host reads per epoch, idle
    share); for the PCG Gram its iterations. With ``scheduler`` (plateau
    kwargs) every loop runs under it and its scale must drop."""
    import copy

    import torch

    from pytorch_fem_solver_tpu_torch import Model
    from pytorch_fem_solver_tpu_torch.bench_vpinn import LEARNING_RATE

    kw = {} if scheduler is None else {"learning_rate_scheduler": "reduce_on_plateau",
                                       "scheduler_kwargs": scheduler}

    def model(epochs):
        return Model(copy.deepcopy(net0), run.training_step, epochs=epochs,
                     optimizer_kwargs={"lr": LEARNING_RATE}, progress_bar=False, **kw)

    eager = run.model if scheduler is None else model(VPINN3D_EPOCHS)
    gram_iters = getattr(run.gram_solve, "iterations", None)
    if gram_iters is not None:
        for v in gram_iters.values():
            v.clear()
    eager_s = _timed(eager.train) / VPINN3D_EPOCHS
    losses, _, accs = eager.get_training_history()
    forward = list(gram_iters["forward"]) if gram_iters is not None else []
    backward = list(gram_iters["backward"]) if gram_iters is not None else []
    blocked = model(VPINN3D_EPOCHS)
    blocked_s = _timed(lambda: blocked.train_compiled(VPINN3D_BLOCK)) / VPINN3D_EPOCHS
    blosses = blocked.get_training_history()[0]
    for name, hist in (("train()", losses), (f"train_compiled({VPINN3D_BLOCK})", blosses)):
        check(len(hist) == VPINN3D_EPOCHS and bool(np.isfinite(hist).all()) and hist[-1] < hist[0],
              f"{tag} {name}: {len(hist)} finite losses, {hist[0]:.6e} -> {hist[-1]:.6e}")
    diff = _rel_curve(blosses, losses)
    check(diff <= 1e-4, f"{tag} train_compiled({VPINN3D_BLOCK}) vs train(): rel {diff:.3e} <= 1e-4")
    fig = {"case": tag, "train_s_per_epoch": eager_s, "train_compiled_s_per_epoch": blocked_s,
           "block_size": VPINN3D_BLOCK, "loss_first_last": [losses[0], losses[-1]],
           "h1_first_last": [accs[0], accs[-1]], "loops_rel": diff, "card": card}
    if scheduler is not None:
        scales = [float(m._scheduler.state["scale"]) for m in (eager, blocked)]
        check(max(scales) < 1.0, f"{tag}: the plateau scale dropped in both loops {scales}")
        fig["final_scale"] = scales
    if gram_iters is not None:
        fig["gram_pcg_iterations_per_epoch"] = {
            "forward": float(np.mean(forward)), "backward": float(np.mean(backward))}
        log(f"{tag}: Gram PCG iterations per epoch, forward {forward}, backward {backward}")
    prof_model = model(VPINN3D_BLOCK)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall = _timed(lambda: prof_model.train_compiled(VPINN3D_BLOCK))
    kernels, device_ms = _device_kernels(prof, VPINN3D_BLOCK)
    wall_ms = 1e3 * wall / VPINN3D_BLOCK
    reads = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and "Memcpy DtoH" in e.name) / VPINN3D_BLOCK
    fig.update({"profiled_wall_ms_per_epoch": wall_ms, "device_ms_per_epoch": device_ms,
                "launches_per_epoch": sum(k[1] for k in kernels),
                "host_reads_per_epoch": reads, "idle_share": 1 - device_ms / wall_ms,
                "idle_share_unprofiled": 1 - device_ms / (1e3 * blocked_s)})
    log(f"{tag}: profile, one block of {VPINN3D_BLOCK} epochs: wall {wall_ms:.3f} ms per epoch "
        f"under the profiler, device {device_ms:.3f} ms, idle share {fig['idle_share']:.3f} "
        f"({fig['idle_share_unprofiled']:.3f} of the unprofiled train_compiled epoch), "
        f"{fig['launches_per_epoch']:.0f} kernel launches and {reads:.1f} host reads "
        "(Memcpy DtoH) per epoch")
    log("device ms/epoch  launches/epoch  kernel")
    for us, count, name in kernels[:12]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    log(f"{tag}: s/epoch train() {eager_s:.6e}, train_compiled({VPINN3D_BLOCK}) {blocked_s:.6e}; "
        f"loss {losses[0]:.6e} -> {losses[-1]:.6e}, relative H1 {accs[0]:.4f} -> {accs[-1]:.4f}")
    return fig


def phase_vpinn_3d(card):
    """Phase 19: the 3D RVPINN of ``examples/example_vpinn_3d.py`` on the
    card, both Gram methods."""
    import copy

    import torch

    from pytorch_fem_solver_tpu_torch.bench_vpinn import make_vpinn_3d
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    f32, f64 = torch.float32, torch.float64
    marks = [("start", time.perf_counter())]
    for gram in ("cholesky", "pcg"):  # library handles, allocator
        warm = make_vpinn_3d(VPINN3D_SMALL, gram, epochs=2, device=DEVICE, dtype=f32)
        warm.model.train()
        warm.model.train_compiled(2)
    del warm

    # the example's size: float32 against float64 on the card
    for gram in ("cholesky", "pcg"):
        hist = {}
        for dtype in (f32, f64):
            run = make_vpinn_3d(VPINN3D_SMALL, gram, epochs=10, device=DEVICE, dtype=dtype)
            run.model.train()
            hist[dtype] = run.model.get_training_history()[0]
        l32 = hist[f32]
        check(bool(np.isfinite(l32).all()) and l32[-1] < l32[0],
              f"3D RVPINN N={VPINN3D_SMALL} {gram} f32: finite losses {l32[0]:.6e} -> {l32[-1]:.6e}")
        d64 = _rel_curve(l32, hist[f64])
        check(d64 <= 1e-2, f"3D RVPINN N={VPINN3D_SMALL} {gram} f32 vs f64 10-epoch losses on the "
              f"card: rel {d64:.3e} <= 1e-2")
    marks.append((f"N={VPINN3D_SMALL} f32 and f64", time.perf_counter()))

    # the full-width rung, both Gram methods
    figures = []
    kept = None
    for gram in ("cholesky", "pcg"):
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        run = make_vpinn_3d(VPINN3D_FULL, gram, epochs=VPINN3D_EPOCHS, device=DEVICE, dtype=f32)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        net0 = copy.deepcopy(run.network)
        inner = int(run.basis._basis_parameters["inner_dofs"].shape[0])
        points = run.basis.integration_points.shape[0] * run.basis.integration_points.shape[1]
        check((run.mesh.n_cells, inner) == VPINN3D_SIZE,
              f"3D RVPINN N={VPINN3D_FULL}: cells and inner DOFs {(run.mesh.n_cells, inner)} == "
              f"{VPINN3D_SIZE}")
        tag = f"3D RVPINN N={VPINN3D_FULL} {gram}"
        fig = _vpinn_3d_block(tag, run, net0, card)
        launches = dict(cuda_build.launch_counts)
        # no hand kernel on this path: the Gram applies are the library's
        # triangular solves or the plain ELL matvec, as XLA runs them for JAX
        check(sum(launches.values()) == 0, f"{tag}: no hand kernel launched ({launches})")
        fig.update({"setup_s": setup_s, "cells": run.mesh.n_cells, "inner_dofs": inner,
                    "quadrature_points": points})
        log(f"{tag}: setup {setup_s:.3f} s, {points} quadrature points")
        figures.append(fig)
        marks.append((f"N={VPINN3D_FULL} {gram}", time.perf_counter()))
        if gram == "cholesky":
            kept = (run, net0)
        del run
    run, net0 = kept
    tag = f"3D RVPINN N={VPINN3D_FULL} cholesky plateau {VPINN3D_PLATEAU}"
    figures.append(_vpinn_3d_block(tag, run, net0, card, scheduler=VPINN3D_PLATEAU))
    # the plateau state lives on the card: no host read added per epoch
    reads = (figures[-1]["host_reads_per_epoch"], figures[0]["host_reads_per_epoch"])
    check(reads[0] <= reads[1], f"{tag}: host reads per train_compiled epoch {reads[0]:.1f}, "
          f"without the scheduler {reads[1]:.1f}")
    del run, kept
    torch.cuda.empty_cache()
    marks.append(("plateau", time.perf_counter()))
    log(json.dumps({"metric": "vpinn_3d_s_per_epoch", "cases": figures}))
    log("phase 19 seconds: " + "; ".join(
        f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1) in zip(marks, marks[1:])))


# -- phase 20: the chunked tet solve -----------------------------------------------


def _peak_of(fn):
    """``fn()`` with the device memory around it: ``(result, allocated
    before, peak during)`` in bytes."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, base, torch.cuda.max_memory_allocated()


def phase_chunked(card):
    """Phase 20: ``tet_poisson(80)`` in float32 through the chunked
    default, against ``chunk_cells=0`` on the same basis and tables."""
    import gc

    import torch

    from pytorch_fem_solver_tpu_torch.bench import _sine_load_3d, _stiffness
    from pytorch_fem_solver_tpu_torch.ops import compiled
    from pytorch_fem_solver_tpu_torch.ops.bsr import default_max_b, get_bsr_structure

    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 20 starts with {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    tag = f"P1 unit_cube({CHUNK_N}) chunked"
    p, r = _higher_order_case(tag, _tet_make(CHUNK_N, 1), _sine_load_3d, CHUNK_SIZE, card,
                              ladder=(ADAPTIVE_CONTROL_TOL,), repeats=CHUNK_REPEATS)
    V = r.basis
    max_b = default_max_b(V)
    st = get_bsr_structure(V, max_b=max_b, want_entry_slot=False)
    (nb, B), (nh, B2) = st.bcols.shape, st.bcols2.shape
    got = (st.n_inner, st.n_pad, nb, B, nh, B2, st.n_values)
    check(got == CHUNK_STRUCTURE, f"{tag}: structure (inner DOFs, n_pad, block-rows, B, spilled "
          f"block-rows, B2, value slots) {got} == {CHUNK_STRUCTURE}, the host's count")
    n_cells = int(V.v_grad.shape[0])
    chunks = getattr(V, "_chunk_tables", {}).get((CHUNK_CELLS, max_b))
    check(chunks is not None and len(chunks) == -(-n_cells // CHUNK_CELLS),
          f"{tag}: the default took {len(chunks or ())} chunks of {CHUNK_CELLS} cells")
    del V._chunk_tables[(CHUNK_CELLS, max_b)]
    t0 = time.perf_counter()
    chunks = compiled._chunk_table(V, st, CHUNK_CELLS, max_b)
    r.seconds["chunk_tables"] = time.perf_counter() - t0
    iters = p["iterations"]
    check(abs(iters - CHUNK_JAX_ITERATIONS) <= ITER_GAP, f"{tag}: {iters} iterations within "
          f"{ITER_GAP} of the JAX package's {CHUNK_JAX_ITERATIONS}")
    check(abs(iters - p["iterations_f64"]) <= ITER_GAP, f"{tag}: f32 iterations {iters} within "
          f"{ITER_GAP} of f64's {p['iterations_f64']}")

    # the same solve unchunked, on the same basis and tables
    solve0 = V.compiled_solver(_stiffness, _sine_load_3d, tol=TOL, chunk_cells=0)
    (u_c, info_c), base_c, peak_c = _peak_of(r.solve)
    del u_c
    (u_0, info_0), base_0, peak_0 = _peak_of(solve0)
    u_c, info_c = r.solve()
    check(info_c.iterations == info_0.iterations == iters, f"{tag}: chunked and unchunked "
          f"iterations {info_c.iterations} == {info_0.iterations} == {iters}")
    # the assembled values differ only by the order of the float32 sums:
    # within 2 x (SLOT_TERMS + 1) x eps32 of each slot's sum of |terms|
    # the assembly alone (the solver's own), each with the other's output
    # not yet resident
    def assemble(form, table):
        return compiled._assemble_symmetric(V, st, form, table)[0]

    vals_0, base_a0, peak_a0 = _peak_of(lambda: assemble(_stiffness, None))
    vals_0 = tuple(v.cpu() for v in vals_0)
    vals_c, base_ac, peak_ac = _peak_of(lambda: assemble(_stiffness, chunks))
    vals_0 = tuple(v.to(vals_c[0].device) for v in vals_0)
    abs_sum = assemble(lambda b: _stiffness(b).abs(), chunks)
    eps = torch.finfo(torch.float32).eps
    diff = torch.cat([(c - z).abs().reshape(-1) for c, z in zip(vals_c, vals_0)])
    scale = torch.cat([s.reshape(-1) for s in abs_sum])
    worst = float((diff / (2 * (SLOT_TERMS + 1) * eps * scale).clamp_min(1e-30)).max())
    max_rel = float(diff.max() / torch.cat([z.reshape(-1) for z in vals_0]).abs().max())
    check(worst <= 1.0, f"{tag}: chunked vs unchunked values within the float32 rounding of the "
          f"summation order (worst slot at {worst:.3e} of 2 x {SLOT_TERMS + 1} eps32 sum|terms|; "
          f"max |diff| / max |value| {max_rel:.3e})")
    del vals_c, vals_0, abs_sum, diff, scale
    # what the chunks cost in time: the two assemblies and the two solves,
    # timed in turns on the same tables
    walls = {"assembly_chunked": [], "assembly_unchunked": [], "solve_chunked": [],
             "solve_unchunked": []}
    for _ in range(CHUNK_REPEATS):
        walls["assembly_chunked"].append(_timed(lambda: assemble(_stiffness, chunks)))
        walls["assembly_unchunked"].append(_timed(lambda: assemble(_stiffness, None)))
        walls["solve_chunked"].append(_timed(r.solve))
        walls["solve_unchunked"].append(_timed(solve0))
    median_ms = {k: 1e3 * float(np.median(w)) for k, w in walls.items()}
    log(f"{tag}: median wall ms over {CHUNK_REPEATS} in turns: "
        + ", ".join(f"{k} {v:.3f} {['%.3f' % (1e3 * w) for w in walls[k]]}"
                    for k, v in median_ms.items()))
    du = float((u_c - u_0).norm() / u_0.norm())
    check(du <= p["f32_vs_f64"], f"{tag}: chunked vs unchunked solution rel L2 {du:.3e} <= the "
          f"float32 solve's own distance from float64 {p['f32_vs_f64']:.3e}")
    b = V.integrate_linear_form(_sine_load_3d)
    true0, rounding = _true_residual(V, u_0, b)
    bound = TOL + ADAPTIVE_ROUNDING * rounding
    check(true0 <= bound, f"{tag}: unchunked true residual {true0:.3e} <= {bound:.3e}")
    gib = 2**30
    p.update({"chunk_cells": CHUNK_CELLS, "chunks": len(chunks), "structure": got,
              "unchunked_iterations": info_0.iterations, "chunked_vs_unchunked_u": du,
              "values_rounding_share": worst, "values_max_rel": max_rel,
              "unchunked_true_residual": true0,
              "median_ms_in_turns": median_ms,
              "peak_gib_chunked": peak_c / gib, "peak_gib_unchunked": peak_0 / gib,
              "solve_peak_over_resident_gib_chunked": (peak_c - base_c) / gib,
              "solve_peak_over_resident_gib_unchunked": (peak_0 - base_0) / gib,
              "assembly_peak_over_resident_gib_chunked": (peak_ac - base_ac) / gib,
              "assembly_peak_over_resident_gib_unchunked": (peak_a0 - base_a0) / gib,
              "host_s": r.seconds})
    log(f"{tag}: max_memory_allocated chunked {peak_c / gib:.3f} GiB ({(peak_c - base_c) / gib:.3f} "
        f"over the {base_c / gib:.3f} GiB resident), unchunked {peak_0 / gib:.3f} GiB "
        f"({(peak_0 - base_0) / gib:.3f} over {base_0 / gib:.3f}); the assembly alone "
        f"{(peak_ac - base_ac) / gib:.3f} GiB over the resident chunked, "
        f"{(peak_a0 - base_a0) / gib:.3f} unchunked; {len(chunks)} chunks of "
        f"{CHUNK_CELLS} cells; host s: " + ", ".join(f"{k} {v:.3f}" for k, v in r.seconds.items()))
    log(json.dumps({"metric": "tet_chunked_solve", "tol": TOL, "jax_iterations": CHUNK_JAX_ITERATIONS,
                    "case": p}, default=str))
    del r, V, solve0, u_0, u_c
    gc.collect()
    torch.cuda.empty_cache()
    return p["k2_launches"]


def _vector_make(first, make_basis, load):
    """``make(dtype, tol)`` of ``_higher_order_case`` for a vector solve:
    the first call through ``first(tol)`` (a ``bench`` entry point, float32,
    its host seconds with it), every later float32 solve on that basis; the
    float64 twin on its own basis ``make_basis(torch.float64)`` (its own
    mesh from the host triangulation), which shares the float32 basis's BSR
    structure (integer tables only). Each basis keeps its own
    rigid-body-mode W, in its dtype."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import _compiled, elasticity_form

    bases = {}

    def make(dtype, tol):
        if not bases:
            r = first(tol)
            bases[torch.float32] = r.basis
            return r
        if dtype not in bases:
            V = make_basis(dtype)
            V._bsr_structures = bases[torch.float32]._bsr_structures
            bases[dtype] = V
        V = bases[dtype]
        return _compiled(lambda: V, elasticity_form, load, V.device, tol)

    return make


def _elasticity_case(tag, make, load, size, inner, coarse, card, f32_vs_f64=F32_VS_F64):
    """Phase 16's checks on one elasticity solve (``form`` the Lamé form)
    and the rigid-body-mode figures: (g, na, m) as the host counted them,
    the host seconds of the RBM structure alone, the tier-2 share of the
    stored blocks, the peak device memory of a solve."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import _coarse_of, elasticity_form
    from pytorch_fem_solver_tpu_torch.ops.bsr import default_max_b, get_bsr_structure
    from pytorch_fem_solver_tpu_torch.ops.precondition import get_affine_two_level_structure

    p, r = _higher_order_case(tag, make, load, size, card, ladder=(ELAST_CONTROL_TOL,),
                              repeats=ELAST_REPEATS, form=elasticity_form,
                              f32_vs_f64=f32_vs_f64, control_residual=True)
    V = r.basis
    n_inner = int(V._basis_parameters["inner_dofs"].numel())
    check(n_inner == inner, f"{tag}: {n_inner} inner DOFs == {inner}")
    got = _coarse_of(V)
    check(got == coarse, f"{tag}: rigid-body-mode coarse space (g, na, m) {got} == {coarse}, "
          f"{got[1] * got[2]} coarse unknowns")
    st = get_bsr_structure(V, max_b=default_max_b(V), want_entry_slot=False)
    del V._affine_two_level_structures
    t0 = time.perf_counter()
    get_affine_two_level_structure(V, st, rbm=True)
    r.seconds["rbm_structure"] = time.perf_counter() - t0  # inside "tables" too
    counts = st.row_blocks.cpu().numpy().astype(np.int64)
    tier2 = int(np.maximum(counts - st.bcols.shape[1], 0).sum())
    (u, info), base, peak = _peak_of(r.solve)
    check(info.iterations == p["iterations"], f"{tag}: a solve on the built tables takes "
          f"{info.iterations} iterations, as the first ({p['iterations']})")
    gib = 2**30
    p.update({"inner_dofs": n_inner, "g": got[0], "na": got[1], "m": got[2],
              "coarse": got[1] * got[2], "tier2_blocks": tier2,
              "tier2_share": tier2 / p["stored_blocks"], "peak_gib": peak / gib,
              "solve_peak_over_resident_gib": (peak - base) / gib, "host_s": r.seconds})
    log(f"{tag}: {tier2} of {p['stored_blocks']} stored blocks in tier 2 "
        f"({p['tier2_share']:.3f}); peak {peak / gib:.3f} GiB ({(peak - base) / gib:.3f} over the "
        f"resident {base / gib:.3f}); host s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in r.seconds.items()))
    return p, r, u


def phase_elasticity(card):
    """Phase 21: the 2D plate and the 3D bubble through the rigid-body-mode
    M, float32 with float64 twins on the card."""
    import gc

    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import (
        _bubble_load,
        _plate_load,
        bubble_exact,
        elasticity_2d,
        elasticity_3d,
        elasticity_form,
        l2_error,
        plate_exact,
    )

    def plate(p):
        return plate_exact(p[..., 0], p[..., 1])

    tag = f"elasticity plate unit_square(n={ELAST_2D_N})"
    p2, r, u = _elasticity_case(
        tag, _vector_make(lambda tol: elasticity_2d(ELAST_2D_N, tol=tol, device=DEVICE,
                                                    dtype=torch.float32),
                          lambda dtype: pt.VectorBasis(
                              pt.MeshTri(pt.unit_square(n=ELAST_2D_N), device=DEVICE, dtype=dtype),
                              pt.ElementTri(1, 4)),
                          _plate_load),
        _plate_load, ELAST_2D_SIZE, ELAST_2D_INNER, ELAST_2D_COARSE, card, ELAST_2D_F32_VS_F64)
    V = r.basis
    u_rbm, info_rbm = V.solve_iterative(
        V.integrate_bilinear_form_local(elasticity_form), V.integrate_linear_form(_plate_load),
        tol=TOL, precondition="rbm", symmetric_form=True, return_info=True)
    diff_rbm = float((u_rbm - u).norm() / u.norm())
    check(bool(info_rbm.converged) and abs(info_rbm.iterations - p2["iterations"]) <= 1
          and diff_rbm <= F32_VS_F64, f"{tag}: solve_iterative(precondition='rbm') "
          f"{info_rbm.iterations} iterations (compiled {p2['iterations']}), rel L2 {diff_rbm:.3e} "
          f"from the compiled solve")
    del u_rbm
    _, info_j = V.compiled_solver(elasticity_form, _plate_load, tol=TOL, precondition="jacobi")()
    check(bool(info_j.converged) and p2["iterations"] < RBM_VS_JACOBI * info_j.iterations,
          f"{tag}: RBM {p2['iterations']} iterations < {RBM_VS_JACOBI} x Jacobi's "
          f"{info_j.iterations}")
    e_fine = l2_error(V, u, plate)
    half = elasticity_2d(ELAST_2D_HALF, tol=TOL, device=DEVICE, dtype=torch.float32)
    e_half = l2_error(half.basis, half.u, plate)
    ratio = e_half / e_fine
    check(L2_RATE[0] < ratio < L2_RATE[1], f"{tag}: L2 error against u_exact {e_fine:.4e} "
          f"(n={ELAST_2D_HALF}: {e_half:.4e}), ratio {ratio:.3f} in {L2_RATE} (second order)")
    p2.update({"jacobi_iterations": info_j.iterations, "solve_iterative_rbm_iterations":
               info_rbm.iterations, "solve_iterative_rbm_vs_compiled": diff_rbm, "l2_error": e_fine,
               "l2_error_half": e_half, "l2_ratio": ratio})
    del r, V, u, half
    gc.collect()
    torch.cuda.empty_cache()

    tag = f"elasticity bubble unit_cube({ELAST_3D_N})"
    p3, r, u = _elasticity_case(
        tag, _vector_make(lambda tol: elasticity_3d(ELAST_3D_N, tol=tol, device=DEVICE,
                                                    dtype=torch.float32),
                          lambda dtype: pt.VectorBasis(
                              pt.MeshTet(pt.unit_cube(ELAST_3D_N), device=DEVICE, dtype=dtype),
                              pt.ElementTet(1, 2)),
                          _bubble_load),
        _bubble_load, ELAST_3D_SIZE, ELAST_3D_INNER, ELAST_3D_COARSE, card)
    p3["l2_error"] = l2_error(r.basis, u, bubble_exact)
    log(f"{tag}: L2 error against u_exact {p3['l2_error']:.4e}")
    log(json.dumps({"metric": "elasticity_solves", "tol": TOL, "cases": [p2, p3]}, default=str))
    del r, u
    gc.collect()
    torch.cuda.empty_cache()
    return p2["k2_launches"], p3["k2_launches"]


def _newton_case(tag, make, card, tol):
    """One compiled Newton solve of phase 22: ``make(dtype, tol)`` builds
    the basis and its tables and solves once (``bench.NewtonRun``), in
    float32 to ``tol``. Counts reset before it; BiCGStab's inner
    iterations are recorded per Newton step. Checks: converged; K2 launched twice per inner iteration and once
    per step for the start; within 1 Newton iteration and 1e-4 of a float64
    twin at ``NEWTON_TOL_64``; K2 against its plain version on the Newton
    structure with the float64 twin's Jacobian values at its first step and
    at its solution; the eager ``solve_newton`` (its
    ``"two_level"`` M, the same as ``"auto"``) in as many steps and within
    1e-4. Returns the figures and the float32 run."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import compiled, cuda_build
    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        bsr_values_from_local,
        default_max_b,
        get_bsr_structure,
    )

    inner = []
    plain = compiled.bicgstab

    def counted(*args, **kwargs):
        x, info = plain(*args, **kwargs)
        inner.append(info.iterations)
        return x, info

    compiled.bicgstab = counted
    try:
        cuda_build.reset_launch_counts()
        r = make(torch.float32, tol)
        torch.cuda.synchronize()
        k2 = cuda_build.launch_counts["bsr_spmv"]
        steps_inner = list(inner)
        inner.clear()
        walls = [_timed(r.solve) for _ in range(NEWTON_REPEATS)]
        inner.clear()
    finally:
        compiled.bicgstab = plain
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        profiled = _timed(r.solve)
    kernels, device_ms = _device_kernels(prof, 1)
    dtoh = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "Memcpy DtoH" in e.name)
    V, (k, res, conv) = r.basis, r.info
    n_inner = int(V._basis_parameters["inner_dofs"].numel())
    log(f"{tag}: cells={int(V._global_dofs4elements.shape[0])} dofs={V.n_dofs} inner={n_inner}")
    check(bool(conv) and bool(torch.isfinite(r.u).all()),
          f"{tag}: converged in {k} Newton steps to residual {float(res):.3e} (tol {tol:g} "
          f"x max(1, res0)), solution finite")
    expected = sum(2 * i + 1 for i in steps_inner)
    check(len(steps_inner) == k and k2 == expected and k2 >= sum(steps_inner),
          f"{tag}: K2 launches {k2} == 2 x inner iterations + 1 per step ({expected}), inner "
          f"iterations per step {steps_inner}")
    r64 = make(torch.float64, NEWTON_TOL_64)
    k64 = r64.info[0]
    check(bool(r64.info[2]) and abs(k - k64) <= 1, f"{tag}: f32 {k} Newton steps within 1 of "
          f"f64's {k64} at tol {NEWTON_TOL_64:g} (converged {bool(r64.info[2])})")
    diff = float((r.u.double() - r64.u).norm() / r64.u.norm())
    check(diff <= F32_VS_F64, f"{tag}: f32 vs f64 solution rel L2 {diff:.3e} <= {F32_VS_F64:g}")
    # K2 against its plain version on this Newton structure (full entry
    # slots), on the float64 Jacobians the solve scatters: the first
    # step's, and the one at the float64 solution, not symmetric there
    V64 = r64.basis
    st = get_bsr_structure(V64, max_b=default_max_b(V64), want_entry_slot=True)
    dofs = V64._global_dofs4elements.long()
    x64 = torch.as_tensor(np.random.default_rng(SEED + 22).standard_normal(st.n_pad),
                          device=DEVICE)
    k2_err = {}
    for where, u_at in (("first step", V64.solution_tensor()), ("f64 solution", r64.u)):
        _, j_local = V64._newton_terms(
            lambda uc: V64._residual_local(r64.residual, uc, ()), u_at[..., 0][..., dofs])
        asym = float((j_local - j_local.mT).norm() / j_local.norm())
        log(f"{tag}: Jacobian at the {where}: ||J_e - J_e^T|| / ||J_e|| {asym:.3e}")
        k2_err[where] = _check_k2(f"{tag} Jacobian at the {where}", st,
                                  bsr_values_from_local(st, j_local), x64)
        del j_local
    t0 = time.perf_counter()
    u_e, info_e = V.solve_newton(r.residual, tol=tol, precondition="two_level",
                                 return_info=True)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    diff_e = float((u_e - r.u).norm() / r.u.norm())
    check(info_e["converged"] and info_e["iterations"] == k and diff_e <= F32_VS_F64,
          f"{tag}: eager solve_newton {info_e['iterations']} steps (compiled {k}), "
          f"converged {info_e['converged']}, rel L2 {diff_e:.3e} <= {F32_VS_F64:g}")
    wall = float(np.median(walls))
    figures = {"case": tag, "tol": tol, "dofs": V.n_dofs, "inner_dofs": n_inner, "newton_steps": k,
               "residual": float(res), "inner_per_step": steps_inner, "k2_launches": k2,
               "newton_steps_f64": k64, "f32_vs_f64": diff, "eager_steps": info_e["iterations"],
               "k2_max_abs_err_jacobian": k2_err,
               "eager_vs_compiled": diff_e, "eager_s": eager_s,
               "median_wall_ms": 1e3 * wall, "walls_ms": [1e3 * w for w in walls],
               "wall_ms_per_step": 1e3 * wall / max(k, 1), "profiled_wall_ms": 1e3 * profiled,
               "device_ms": device_ms, "idle_share": 1 - device_ms / (1e3 * profiled),
               "launches": sum(kk[1] for kk in kernels), "host_reads": dtoh,
               "host_s": r.seconds, "card": card}
    log(f"{tag}: {k} Newton steps (f64 {k64}), inner BiCGStab iterations per step {steps_inner}, "
        f"K2 launches {k2}; median wall {1e3 * wall:.3f} ms over {NEWTON_REPEATS} solves, "
        f"{1e3 * wall / max(k, 1):.3f} ms per step; profiled solve: wall {1e3 * profiled:.3f} ms, "
        f"device {device_ms:.3f} ms, idle share {figures['idle_share']:.3f}, "
        f"{figures['launches']:.0f} launches, {dtoh} host reads; eager {eager_s:.3f} s; host s: "
        + ", ".join(f"{key} {v:.3f}" for key, v in r.seconds.items()))
    log("device ms/solve  launches/solve  kernel")
    for us, count, name in kernels[:8]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    return figures, r, r64.u


def phase_newton(card, mesh32, mesh64):
    """Phase 22: compiled Newton on the h=0.03 network and on the
    strain-stiffening plate, float32 with float64 twins on the card."""
    import gc

    import torch

    from pytorch_fem_solver_tpu_torch.bench import (
        K0,
        _stiffness,
        _unit_load,
        newton_dfn,
        newton_elasticity,
    )

    meshes = {torch.float32: mesh32, torch.float64: mesh64}
    tag = f"Newton DFN h={H}"
    pd, r, u64 = _newton_case(tag, lambda dtype, tol: newton_dfn(meshes[dtype], tol=tol), card,
                              NEWTON_TOL_DFN)
    check(pd["dofs"] == EXPECTED_DOFS, f"{tag}: {pd['dofs']} DOFs == {EXPECTED_DOFS}")
    u_lin, info_lin = r.basis.compiled_solver(lambda b: K0 * _stiffness(b), _unit_load, tol=TOL)()
    nl_max, lin_max = float(r.u.max()), float(u_lin.max())
    check(bool(info_lin.converged) and nl_max < lin_max, f"{tag}: max u nonlinear {nl_max:.6f} < "
          f"linear {lin_max:.6f} (k(u) = {K0} + u^2 flattens the peak)")
    pd.update({"max_u": nl_max, "max_u_linear": lin_max})
    newton_ref = {"figures": pd, "u32": r.u, "u64": u64}  # phase 28's twin
    del r, u_lin
    tag = f"Newton stiffening plate unit_square(n={NEWTON_ELAST_N})"
    pv, r, _ = _newton_case(
        tag, lambda dtype, tol: newton_elasticity(NEWTON_ELAST_N, tol=tol, device=DEVICE,
                                                  dtype=dtype),
        card, NEWTON_TOL_PLATE)
    check(pv["inner_dofs"] == NEWTON_ELAST_INNER,
          f"{tag}: {pv['inner_dofs']} inner DOFs == {NEWTON_ELAST_INNER}")
    log(json.dumps({"metric": "newton_solves", "tol_f64": NEWTON_TOL_64,
                    "cases": [pd, pv]}, default=str))
    del r
    gc.collect()
    torch.cuda.empty_cache()
    return pd["k2_launches"], pv["k2_launches"], newton_ref


def _profiled(solve):
    """One profiled call of ``solve``: (wall ms, device ms, launches,
    device-to-host copies, host-to-device copies, kernels by device time,
    K2's us per launch and launches by dtype: ``{"float32": (us, n),
    "float64": (us, n)}``, ``"bf16_float32"`` for the bf16-values
    instantiation; the call's result). Read from the profiler's raw Kineto
    events, without its event tree: a sharded Stokes solve's ~100,000
    launches take the tree tens of seconds of host to build."""
    import collections

    import torch

    out = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = _timed(lambda: out.append(solve()))
    by_name = collections.defaultdict(lambda: [0.0, 0])
    dtoh = htod = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue
        name = e.name()
        dtoh += "Memcpy DtoH" in name
        htod += "Memcpy HtoD" in name
        by_name[name][0] += e.duration_ns() / 1e3
        by_name[name][1] += 1
    kernels = sorted(((us, n, name) for name, (us, n) in by_name.items()), reverse=True)
    k2 = {("bf16_" if "bfloat16" in name else "") + ("float64" if "double" in name else "float32"):
          (us / n, n) for us, n, name in kernels if "bsr_spmv" in name}
    return (1e3 * wall, sum(k[0] for k in kernels) / 1e3, sum(k[1] for k in kernels), dtoh, htod,
            kernels, k2, out[0])


def _refined_case(tag, first, again, reference, card):
    """Phase 23 on one problem. ``first()`` builds the float64 basis and the
    refined solve with ``REFINE_PASSES`` passes and solves once
    (``bench.RefinedSolve``); ``again(basis, passes)`` is ``solve`` of
    another refined solver on that basis; ``reference(basis)`` the float64
    ``compiled_bsr_solver`` solution at ``REFINE_F64_TOL``. Counts reset
    before each first solve: K2 = sum(inner iterations + 1) launches in
    float32 plus 1 + passes in float64. Returns the figures and the run."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build, refine

    by_dtype = {torch.float32: 0, torch.float64: 0}
    plain = refine.bsr_matvec

    def counted(st, values, x):
        by_dtype[x.dtype] += 1
        return plain(st, values, x)

    runs = {}
    for passes in (REFINE_PASSES, 0):
        by_dtype.update({torch.float32: 0, torch.float64: 0})
        cuda_build.reset_launch_counts()
        refine.bsr_matvec = counted
        try:
            if passes == REFINE_PASSES:
                r = first()
                solve, (u, info) = r.solve, (r.u, r.info)
            else:
                solve = again(r.basis, passes)
                u, info = solve()
            torch.cuda.synchronize()
        finally:
            refine.bsr_matvec = plain
        k2 = cuda_build.launch_counts["bsr_spmv"]
        its = list(info.inner_iterations)
        f32_expected = sum(i + 1 for i in its)
        check(k2 == f32_expected + 1 + passes
              and by_dtype == {torch.float32: f32_expected, torch.float64: 1 + passes},
              f"{tag} refine={passes}: K2 launches {k2} == sum(inner iterations + 1) "
              f"{f32_expected} in float32 + {1 + passes} in float64 (counted by dtype: "
              f"{by_dtype[torch.float32]} / {by_dtype[torch.float64]})")
        runs[passes] = (solve, u, info, k2)
    V = r.basis
    u_ref, info_ref = reference(V)
    torch.cuda.synchronize()
    check(bool(info_ref.converged), f"{tag}: float64 compiled_bsr_solver at {REFINE_F64_TOL:g} "
          f"converged in {info_ref.iterations} iterations")
    err = {p: _rel_err(runs[p][1], u_ref) for p in runs}
    res = {p: runs[p][2].residuals.tolist() for p in runs}
    _, u2, info2, _ = runs[REFINE_PASSES]
    check(bool(torch.isfinite(u2).all()) and u2.dtype == torch.float64
          and res[REFINE_PASSES][-1] < REFINE_RESIDUAL and bool(info2.converged),
          f"{tag} refine={REFINE_PASSES}: true float64 residuals {res[REFINE_PASSES]}, the last "
          f"< {REFINE_RESIDUAL:g}, converged {bool(info2.converged)}")
    check(err[REFINE_PASSES] <= REFINE_VS_F64, f"{tag} refine={REFINE_PASSES}: max |u - u64| / "
          f"max |u64| {err[REFINE_PASSES]:.3e} <= {REFINE_VS_F64:g}")
    check(err[0] > REFINE_VS_F64 and err[0] > 10 * err[REFINE_PASSES],
          f"{tag} refine=0 (the control): {err[0]:.3e} fails the {REFINE_VS_F64:g} bound and "
          f"exceeds 10 x the refined {err[REFINE_PASSES]:.3e}")
    walls = {p: [] for p in runs}
    for _ in range(REFINE_REPEATS):  # in turns
        for p in runs:
            walls[p].append(_timed(runs[p][0]))
    figures = {"case": tag, "dofs": V.n_dofs, "f64_reference_iterations": info_ref.iterations,
               "host_s": r.seconds, "card": card}
    for p in runs:
        wall_ms, device_ms, launches, dtoh, _, kernels, k2_us, _ = _profiled(runs[p][0])
        check(set(k2_us) == {"float32", "float64"}, f"{tag} refine={p}: the profiled solve shows "
              f"K2 in float32 and float64 on the device ({sorted(k2_us)})")
        median = 1e3 * float(np.median(walls[p]))
        figures[f"refine{p}"] = {
            "inner_iterations": list(runs[p][2].inner_iterations), "true_residuals": res[p],
            "converged": bool(runs[p][2].converged), "rel_err_vs_f64": err[p],
            "k2_launches": runs[p][3], "median_wall_ms": median,
            "walls_ms": [1e3 * w for w in walls[p]], "profiled_wall_ms": wall_ms,
            "device_ms": device_ms, "idle_share": 1 - device_ms / wall_ms,
            "launches": launches, "host_reads": dtoh, "k2_us_per_launch_in_solve": k2_us,
        }
        log(f"{tag} refine={p}: inner iterations {figures[f'refine{p}']['inner_iterations']}, "
            f"true residuals {res[p]}, rel err vs f64 {err[p]:.3e}, K2 {runs[p][3]}; median wall "
            f"{median:.3f} ms over {REFINE_REPEATS}; profiled: wall {wall_ms:.3f} ms, device "
            f"{device_ms:.3f} ms, idle {1 - device_ms / wall_ms:.3f}, {launches:.0f} launches, "
            f"{dtoh:.0f} host reads; K2 us per launch in the solve (launches): {k2_us}")
        log("device ms/solve  launches/solve  kernel")
        for us, count, name in kernels[:6]:
            log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    return figures, r


def phase_refined(card, mesh64):
    """Phase 23: the mixed-precision refined solve, float32 inner PCG on K2
    in float32 and the true residual on K2 in float64."""
    import gc

    import torch

    from pytorch_fem_solver_tpu_torch.bench import (
        _component_sum_load,
        _stiffness,
        _unit_load,
        refined_dfn,
        refined_elasticity,
        vector_laplacian,
    )
    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        bsr_matvec,
        bsr_values_from_local_symmetric,
        default_max_b,
        get_bsr_structure,
    )

    tag = f"refined DFN h={H}"
    pd, r = _refined_case(
        tag, lambda: refined_dfn(mesh64, refine=REFINE_PASSES, tol32=REFINE_TOL32),
        lambda V, p: V.compiled_refined(_stiffness, _unit_load, refine=p, tol32=REFINE_TOL32),
        lambda V: V.compiled_solver(_stiffness, _unit_load, tol=REFINE_F64_TOL)(), card)
    check(pd["dofs"] == EXPECTED_DOFS, f"{tag}: {pd['dofs']} DOFs == {EXPECTED_DOFS}")
    # K2 against its plain version on the values the refined solve
    # assembles (float64, and their float32 copy)
    V = r.basis
    st = get_bsr_structure(V, max_b=default_max_b(V), want_entry_slot=False)
    values64 = bsr_values_from_local_symmetric(st, V.integrate_bilinear_form_local(_stiffness))
    x64 = torch.as_tensor(np.random.default_rng(SEED + 23).standard_normal(st.n_pad),
                          device=DEVICE)
    pd["k2_max_abs_err"] = _check_k2(tag, st, values64, x64)
    # the float64 launch alone, behind the write flush, beside its byte
    # bound: every stored block (64 doubles) and its column, the two row
    # tables, x read and y written
    n_stored = int(st.blk_id_host.size)
    f64_bytes = n_stored * (64 * 8 + 4) + 2 * st.nb * 4 + 2 * st.n_pad * 8
    pd["k2_f64_ms"] = time_ms(lambda: bsr_matvec(st, values64, x64))
    pd["k2_f64_bound_ms"] = 1e3 * f64_bytes / HBM_BYTES_PER_S
    log(f"{tag}: K2 float64 alone {1e3 * pd['k2_f64_ms']:.3f} us, bound "
        f"{1e3 * pd['k2_f64_bound_ms']:.3f} us ({f64_bytes / 1e6:.2f} MB over 3.35 TB/s)")
    del r, V, values64

    def plate_b(V):
        return V.integrate_linear_form(_component_sum_load)

    tag = f"refined vector Laplacian rectangle({REFINE_ELAST_N}) explicit rhs"
    pv, r = _refined_case(
        tag, lambda: refined_elasticity(REFINE_ELAST_N, refine=REFINE_PASSES,
                                        tol32=REFINE_ELAST_TOL32, device=DEVICE),
        lambda V, p: (lambda s, b: lambda: s(b))(
            V.compiled_refined(vector_laplacian, refine=p, tol32=REFINE_ELAST_TOL32), plate_b(V)),
        lambda V: V.compiled_solver(vector_laplacian, tol=REFINE_F64_TOL)(plate_b(V)), card)
    try:
        r.basis.compiled_refined(vector_laplacian, tol32=REFINE_ELAST_TOL32)(
            plate_b(r.basis).to(torch.float32))
        rejected = False
    except ValueError as e:
        rejected = "f64 right-hand side" in str(e)
    check(rejected, f"{tag}: a float32 right-hand side is refused")
    log(json.dumps({"metric": "refined_solves", "refine": REFINE_PASSES, "cases": [pd, pv]},
                   default=str))
    del r
    gc.collect()
    torch.cuda.empty_cache()
    return pd[f"refine{REFINE_PASSES}"]["k2_launches"], pv[f"refine{REFINE_PASSES}"]["k2_launches"]


def _m_orthonormality(V, vecs, m_form):
    """max |X^T M X - I| of the eigenvectors ``vecs`` (n_dofs, k), M the
    basis's mass form assembled in float64 from its element matrices and
    applied by K2 in float64."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        bsr_matvec,
        bsr_reduce,
        bsr_values_from_local,
        default_max_b,
        get_bsr_structure,
    )

    st = get_bsr_structure(V, max_b=default_max_b(V), want_entry_slot=True)
    vm = bsr_values_from_local(st, V.integrate_bilinear_form_local(m_form).double())
    x = torch.stack([bsr_reduce(st, vecs[:, j].double()) for j in range(vecs.shape[1])], dim=1)
    mx = torch.stack([bsr_matvec(st, vm, c.contiguous()) for c in x.T], dim=1)
    g = x.T @ mx
    return float((g - torch.eye(g.shape[0], dtype=g.dtype, device=g.device)).abs().max())


def _eigsh_case(tag, run, card, method, twin=None, repeats=EIGSH_REPEATS, tol=EIGSH_TOL,
                vs_f64=EIGSH_VS_F64):
    """Phase 24 on one eigensolve. ``run()`` builds the float32 solve and
    solves once (``bench.EigshRun``), counts reset before it; ``twin(V)``
    is the float64 LOBPCG solve at ``EIGSH_F64_TOL`` on a float64 basis of
    the same mesh. Checks: converged (to ``tol``), finite, ascending,
    M-orthonormal within ``EIGSH_ORTHO``; K2 = 2 m + 6 m x rounds for
    LOBPCG, 3 m per round plus every inner PCG's iterations + 1 for
    subspace iteration; the eigenvalues within ``vs_f64`` of the twin's.
    Returns the figures and the run."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build, eigen

    inner = []
    plain_pcg = eigen.pcg

    def pcg(*args, **kwargs):
        x, info = plain_pcg(*args, **kwargs)
        inner.append(info.iterations)
        return x, info

    eigen.pcg = pcg
    try:
        cuda_build.reset_launch_counts()
        r = run()
        torch.cuda.synchronize()
        k2 = cuda_build.launch_counts["bsr_spmv"]
        inner_first = list(inner)
    finally:
        eigen.pcg = plain_pcg
    V, (rounds, change, conv) = r.basis, r.info
    k = r.vals.shape[0]
    n_inner = int(V._basis_parameters["inner_dofs"].numel())
    m = min(k + max(2, k // 2), n_inner)
    vals = r.vals.double().cpu().numpy()
    check(bool(conv) and bool(torch.isfinite(r.vecs).all()) and bool(np.all(np.diff(vals) >= 0)),
          f"{tag} {method}: converged in {rounds} rounds (change {float(change):.3e} <= "
          f"{tol:g}), finite, ascending: {vals.tolist()}")
    if method == "lobpcg":
        expected = 2 * m + 6 * m * rounds
        rule = f"2 m + 6 m x rounds (m={m})"
    else:
        expected = 3 * m * rounds + sum(i + 1 for i in inner_first)
        rule = (f"3 m x rounds + sum(inner iterations + 1) (m={m}, {len(inner_first)} inner "
                f"solves, {sum(inner_first)} iterations)")
    check(k2 == expected, f"{tag} {method}: K2 launches {k2} == {rule} = {expected}")
    ortho = _m_orthonormality(V, r.vecs, r.forms[1])
    check(ortho <= EIGSH_ORTHO, f"{tag} {method}: max |X^T M X - I| {ortho:.3e} <= {EIGSH_ORTHO:g}")
    # a solve's rounds vary from solve to solve near the float32 floor
    # (the assembly's atomics vary the values' last bits), so each timed
    # and the profiled solve keep their own count
    walls, walls_rounds = [], []
    for _ in range(repeats):
        out = []
        walls.append(_timed(lambda: out.append(r.solve())))
        walls_rounds.append(out[0][2][0])
    wall_ms, device_ms, launches, dtoh, _, kernels, k2_us, out = _profiled(r.solve)
    p_rounds = out[2][0]
    median = 1e3 * float(np.median(walls))
    figures = {"case": tag, "method": method, "tol": tol, "dofs": V.n_dofs, "inner_dofs": n_inner,
               "k": k,
               "m": m, "rounds": rounds, "eig_change": float(change), "vals": vals.tolist(),
               "m_orthonormality": ortho, "k2_launches": k2, "k2_per_round": k2 / rounds,
               "median_wall_ms": median, "walls_ms": [1e3 * w for w in walls],
               "walls_rounds": walls_rounds, "ms_per_round": [1e3 * w / n for w, n in
                                                              zip(walls, walls_rounds)],
               "profiled_rounds": p_rounds, "profiled_wall_ms": wall_ms, "device_ms": device_ms,
               "idle_share": 1 - device_ms / wall_ms, "launches": launches,
               "launches_per_round": launches / p_rounds, "host_reads": dtoh,
               "host_reads_per_round": dtoh / p_rounds,
               "device_ms_per_round": device_ms / p_rounds, "k2_us_per_launch_in_solve": k2_us,
               "host_s": r.seconds, "card": card}
    if method == "subspace":
        figures["inner_iterations_per_round"] = sum(inner_first) / rounds
    if twin is not None:
        vals64, _, (rounds64, _, conv64) = twin(V)
        diff = float(np.max(np.abs(vals - vals64.cpu().numpy()) / np.abs(vals64.cpu().numpy())))
        check(bool(conv64) and diff <= vs_f64, f"{tag} {method}: f32 eigenvalues within "
              f"{diff:.3e} <= {vs_f64:g} of the card's float64 LOBPCG ({rounds64} rounds at "
              f"{EIGSH_F64_TOL:g}, converged {bool(conv64)})")
        figures.update({"f64_rounds": rounds64, "f32_vs_f64": diff,
                        "vals_f64": vals64.cpu().tolist()})
    log(f"{tag} {method}: {rounds} rounds, K2 {k2} ({k2 / rounds:.1f} per round); median wall "
        f"{median:.3f} ms over {repeats} (rounds {walls_rounds}); profiled ({p_rounds} rounds): "
        f"wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, idle {1 - device_ms / wall_ms:.3f}, "
        f"{launches:.0f} launches ({launches / p_rounds:.1f} per round), {dtoh:.0f} host reads "
        f"({dtoh / p_rounds:.2f} per round); K2 us per launch in the solve (launches): {k2_us}; "
        f"host s: "
        + ", ".join(f"{key} {v:.3f}" for key, v in r.seconds.items()))
    log("device ms/solve  launches/solve  kernel")
    for us, count, name in kernels[:8]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    return figures, r


def _f64_twin(make_basis, forms, k):
    """``twin(V32)`` of ``_eigsh_case``: LOBPCG at ``EIGSH_F64_TOL`` on the
    float64 basis ``make_basis()`` (kept as ``twin.basis``), which shares
    V32's BSR structure (integer tables only)."""
    import torch

    def twin(V32):
        V = make_basis()
        V._bsr_structures = V32._bsr_structures
        twin.basis = V
        out = V.compiled_eigsh(*forms, k=EIGSH_K, tol=EIGSH_F64_TOL)()
        torch.cuda.synchronize()
        return out

    return twin


def phase_eigsh(card, mesh32, mesh64):
    """Phase 24: the generalized eigensolvers, LOBPCG and subspace
    iteration, on the square, the network and the plate, float32 with
    float64 twins on the card."""
    import gc

    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import (
        _mass,
        _stiffness,
        eigsh_dfn,
        eigsh_elasticity,
        eigsh_square,
        modal_elasticity_form,
        vector_mass,
    )
    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        bsr_diagonal,
        bsr_matvec,
        bsr_reduce,
        bsr_values_from_local,
        default_max_b,
        get_bsr_structure,
    )
    from pytorch_fem_solver_tpu_torch.ops.eigen import lobpcg_eigsh
    from pytorch_fem_solver_tpu_torch.ops.precondition import auto_preconditioner

    tag = f"eigsh rectangle({EIGSH_N}, {EIGSH_N})"
    twin = _f64_twin(lambda: pt.Basis(pt.MeshTri(pt.rectangle(EIGSH_N, EIGSH_N), device=DEVICE,
                                                 dtype=torch.float64), pt.ElementTri(1, 3)),
                     (_stiffness, _mass), EIGSH_K)
    vals64 = {}

    def twin_once(V):
        if not vals64:
            vals64["out"] = twin(V)
        return vals64["out"]

    pl, r = _eigsh_case(tag, lambda: eigsh_square(EIGSH_N, EIGSH_K, tol=EIGSH_TOL, device=DEVICE,
                                                   dtype=torch.float32),
                        card, "lobpcg", twin_once)
    check(pl["dofs"] == EIGSH_DOFS, f"{tag}: {pl['dofs']} DOFs == {EIGSH_DOFS}")
    V = r.basis
    ps, _ = _eigsh_case(tag, lambda: _eigsh_again(r, "subspace"), card, "subspace", twin_once,
                        repeats=EIGSH_SUBSPACE_REPEATS)
    diff = float(np.max(np.abs(np.array(pl["vals"]) - np.array(ps["vals"]))
                        / np.abs(np.array(ps["vals"]))))
    check(diff <= EIGSH_VS_F64, f"{tag}: LOBPCG and subspace eigenvalues within {diff:.3e} <= "
          f"{EIGSH_VS_F64:g} of each other")
    # the control: LOBPCG stopped after EIGSH_CONTROL_ROUNDS rounds on the
    # same operators, preconditioner and start block
    st = get_bsr_structure(V, max_b=default_max_b(V), want_entry_slot=True)
    va = bsr_values_from_local(st, V.integrate_bilinear_form_local(_stiffness))
    vm = bsr_values_from_local(st, V.integrate_bilinear_form_local(_mass))
    m = pl["m"]
    rand = torch.as_tensor(np.random.default_rng(0).standard_normal((V.n_dofs, m)),
                           dtype=V.dtype, device=V.device)
    x0 = torch.stack([bsr_reduce(st, rand[:, j]) for j in range(m)], dim=1)
    vals_c, _, (rounds_c, _, conv_c) = lobpcg_eigsh(
        lambda v: bsr_matvec(st, va, v), lambda v: bsr_matvec(st, vm, v), x0, EIGSH_K,
        tol=EIGSH_TOL, max_rounds=EIGSH_CONTROL_ROUNDS,
        precond=auto_preconditioner(V, st, va, bsr_diagonal(st, va)))
    ref = np.array(pl["vals_f64"])
    diff_c = float(np.max(np.abs(vals_c.double().cpu().numpy() - ref) / np.abs(ref)))
    check(not bool(conv_c) and diff_c > EIGSH_VS_F64,
          f"{tag}: lobpcg_eigsh(max_rounds={EIGSH_CONTROL_ROUNDS}) (the control, {rounds_c} "
          f"rounds) fails the f32-vs-f64 bound: {diff_c:.3e} > {EIGSH_VS_F64:g}")
    pl["control_vs_f64"] = diff_c
    # K2 against its plain version on the eigen structure (full entry
    # slots) with the stiffness and the mass in float64
    V64 = twin.basis
    x64 = torch.as_tensor(np.random.default_rng(SEED + 24).standard_normal(st.n_pad),
                          device=DEVICE)
    pl["k2_max_abs_err"] = {
        name: _check_k2(f"{tag} {name}", st,
                        bsr_values_from_local(st, V64.integrate_bilinear_form_local(form)), x64)
        for name, form in (("stiffness", _stiffness), ("mass", _mass))}
    del r, V, V64, va, vm, x0, twin.basis
    gc.collect()
    torch.cuda.empty_cache()

    tag = f"eigsh DFN h={H}"
    pd, r = _eigsh_case(
        tag, lambda: eigsh_dfn(mesh32, EIGSH_K, tol=EIGSH_TOL), card, "lobpcg",
        _f64_twin(lambda: pt.FractureNetworkBasis(mesh64, pt.ElementTri(1, 2)),
                  (_stiffness, _mass), EIGSH_K))
    check(pd["dofs"] == EXPECTED_DOFS, f"{tag}: {pd['dofs']} DOFs == {EXPECTED_DOFS}")
    del r
    tag = f"eigsh elastic modes unit_square(n={EIGSH_ELAST_N})"
    pe, r = _eigsh_case(
        tag, lambda: eigsh_elasticity(EIGSH_ELAST_N, EIGSH_K, tol=EIGSH_ELAST_TOL, device=DEVICE,
                                      dtype=torch.float32), card, "lobpcg",
        _f64_twin(lambda: pt.VectorBasis(pt.MeshTri(pt.unit_square(n=EIGSH_ELAST_N), device=DEVICE,
                                                    dtype=torch.float64), pt.ElementTri(1, 2)),
                  (modal_elasticity_form, vector_mass), EIGSH_K),
        tol=EIGSH_ELAST_TOL, vs_f64=EIGSH_ELAST_VS_F64)
    check(pe["inner_dofs"] == NEWTON_ELAST_INNER, f"{tag}: {pe['inner_dofs']} inner DOFs == "
          f"{NEWTON_ELAST_INNER}")
    log(json.dumps({"metric": "eigsh_solves", "tol": EIGSH_TOL, "cases": [pl, ps, pd, pe]},
                   default=str))
    del r
    gc.collect()
    torch.cuda.empty_cache()
    # the network's figures are phase 28's twin
    return pl["k2_launches"], ps["k2_launches"], pd["k2_launches"], pe["k2_launches"], pd


def _eigsh_again(r, method):
    """``bench.EigshRun`` of another method on the basis of ``r``."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import EigshRun

    V = r.basis
    t0 = time.perf_counter()
    solve = V.compiled_eigsh(*r.forms, k=r.vals.shape[0], method=method, tol=EIGSH_TOL,
                             solve_tol=EIGSH_SOLVE_TOL)
    t1 = time.perf_counter()
    vals, vecs, info = solve()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return EigshRun(vals, vecs, info, {"tables": t1 - t0, "solve": t2 - t1}, V, r.forms, solve)


def _stokes_k2_rule(name, info):
    """The K2 launches a Stokes solve implies, and the rule in words."""
    if name == "minres":
        its, rec = info.outer_iterations, info.inner_info.iterations
        return (its + 1 + its // 50 + 1 + rec + 1,
                f"MINRES iterations + 1 + refreshes + 1 + recovery iterations + 1 = {its} + 1 + "
                f"{its // 50} + 1 + {rec} + 1")
    # one product per PCG iteration and one for each inner PCG's start: the
    # f-solve, the initial Schur apply, one apply per outer iteration, the
    # recovery; the scalar path launches one per component column
    columns = 2 if name == "scalar" else 1
    calls = info.outer_iterations + 3
    return (columns * (info.inner_total + calls),
            f"{columns} x (inner_total + outer + 3) = {columns} x ({info.inner_total} + "
            f"{info.outer_iterations} + 3)")


def _stokes_checks(tag, Vu, Vp, u, p, div_bound, control=False):
    """The discrete divergence max |B u| / max |u| (checked against
    ``div_bound`` unless ``control``) and the pressure's lumped-mass mean
    (zero to roundoff); returns both figures."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import stokes_div
    from pytorch_fem_solver_tpu_torch.ops.saddle import lumped_mass

    local_b = Vp.integrate_mixed_bilinear_form_local(Vu, stokes_div)
    bu = Vp._assemble_linear_from_local(local_b @ u[:, 0][Vu._global_dofs4elements.long()][..., None])
    div = float(bu.abs().max() / u.abs().max())
    if not control:
        check(div <= div_bound, f"{tag}: max |B u| / max |u| {div:.3e} <= {div_bound:g}")
    mp, p64 = lumped_mass(Vp).double(), p.double()
    mean, scale = float((mp * p64).sum()), float((mp * p64.abs()).sum())
    bound = STOKES_MEAN * torch.finfo(p.dtype).eps * scale
    check(abs(mean) <= bound, f"{tag}: lumped-mass mean of p {mean:.3e}, |.| <= {STOKES_MEAN} eps "
          f"sum(mp |p|) = {bound:.3e}")
    return div, mean / scale


def _second_stokes_load(basis):
    """Another right-hand side: a rotation field plus a constant."""
    import torch

    pts = basis.integration_points[..., 0, :]
    f = torch.stack([0.5 - pts[..., 1], pts[..., 0] + 0.25], dim=-1)
    return (basis.v * f[..., None, :]).sum(-1, keepdim=True)


def phase_stokes(card):
    """Phase 25: Stokes, the nested Schur loop and MINRES on K2, against the
    card's float64 truth."""
    import gc

    import torch

    from pytorch_fem_solver_tpu_torch.basis import Basis
    from pytorch_fem_solver_tpu_torch.bench import (
        STOKES_CONFIGS,
        _stiffness,
        stokes_problem,
        stokes_solver_of,
        stokes_viscous,
    )
    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        _bsr_spmv_cols_plain,
        bsr_matvec_cols,
        bsr_values_from_local_symmetric,
        default_max_b,
        get_bsr_structure,
    )

    t0 = time.perf_counter()
    Vu64, Vp64, f64 = stokes_problem(STOKES_N, device=DEVICE, dtype=torch.float64)
    Vu, Vp, f = stokes_problem(STOKES_N, device=DEVICE, dtype=torch.float32)
    f2 = Vu.integrate_linear_form(_second_stokes_load)
    # the structure is integer tables only, the same for both dtypes
    get_bsr_structure(Vu, max_b=default_max_b(Vu), want_entry_slot=False)
    Vu64._bsr_structures = Vu._bsr_structures
    torch.cuda.synchronize()
    host_s = {"problems": time.perf_counter() - t0}
    check((Vu.n_dofs, Vp.n_dofs) == STOKES_SIZE,
          f"Stokes rectangle({STOKES_N}): {Vu.n_dofs} velocity, {Vp.n_dofs} pressure DOFs == "
          f"{STOKES_SIZE}")

    # the float64 truth
    t0 = time.perf_counter()
    truth = stokes_solver_of(Vu64, Vp64, "truth")
    host_s["truth_tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cuda_build.reset_launch_counts()
    out = []
    truth_s = _timed(lambda: out.append(truth(f64)))
    u_t, p_t, info_t = out[0]
    k2 = cuda_build.launch_counts["bsr_spmv"]
    expected, rule = _stokes_k2_rule("truth", info_t)
    tag = "Stokes float64 truth"
    check(bool(info_t.converged) and bool(torch.isfinite(u_t).all()),
          f"{tag}: converged in {info_t.outer_iterations} outer, {info_t.inner_total} inner "
          f"iterations (recovery {info_t.inner_info.iterations})")
    check(k2 == expected, f"{tag}: K2 launches {k2} == {rule} = {expected}")
    div64, mean64 = _stokes_checks(tag, Vu64, Vp64, u_t, p_t, STOKES_DIV64)
    host_s["truth_solve_and_checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    figures = {"truth": {"outer": info_t.outer_iterations, "inner_total": info_t.inner_total,
                         "recovery": info_t.inner_info.iterations, "k2_launches": k2,
                         "wall_ms": 1e3 * truth_s, "div_rel": div64, "mean_rel": mean64}}

    # K2 against its plain version through bsr_matvec_cols, float64: one
    # column on the vector A values, the two component columns on the
    # scalar ones
    rng = np.random.default_rng(SEED + 25)
    k2_err = 0.0
    Vs64 = Basis(Vu64.mesh, Vu64._element)
    for what, V, form, m in (("vector A", Vu64, stokes_viscous, 1),
                             ("scalar A", Vs64, _stiffness, 2)):
        st = get_bsr_structure(V, max_b=default_max_b(V), want_entry_slot=False)
        values = bsr_values_from_local_symmetric(st, V.integrate_bilinear_form_local(form))
        X = torch.as_tensor(rng.standard_normal((st.n_pad, m)), device=DEVICE)
        before = cuda_build.launch_counts["bsr_spmv"]
        Y = bsr_matvec_cols(st, values, X)
        launched = cuda_build.launch_counts["bsr_spmv"] - before
        ref = _bsr_spmv_cols_plain(st.bcols, values[0], X, st.bcols2, values[1], st.heavy_rows)
        torch.cuda.synchronize()
        err = float((Y - ref).norm() / ref.norm())
        check(err <= 1e-12 and launched == m,
              f"K2 Stokes {what} float64 through bsr_matvec_cols ({m} column(s), {launched} "
              f"launches) vs plain: rel err {err:.3e} <= 1e-12")
        k2_err = max(k2_err, float((Y - ref).abs().max()))
    del Vs64
    figures["k2_max_abs_err_f64"] = k2_err
    host_s["k2_check"] = time.perf_counter() - t0

    launches_by_path = {}
    for name in STOKES_CONFIGS:
        tag = f"Stokes {name}"
        control = name == STOKES_CONTROL
        t_config = t0 = time.perf_counter()
        solve = stokes_solver_of(Vu, Vp, name)
        torch.cuda.synchronize()
        tables_s = time.perf_counter() - t0
        cuda_build.reset_launch_counts()
        out = []
        first_s = _timed(lambda: out.append(solve(f)))
        u, p, info = out[0]
        k2 = cuda_build.launch_counts["bsr_spmv"]
        launches_by_path[name] = k2
        expected, rule = _stokes_k2_rule(name, info)
        check(k2 == expected, f"{tag}: K2 launches {k2} == {rule} = {expected}")
        held = not control and name not in STOKES_UNCONVERGED
        check(bool(torch.isfinite(u).all()) and bool(torch.isfinite(p).all())
              and (not held or bool(info.converged)),
              f"{tag}: finite{', converged' if held else ''} ({info.outer_iterations} outer, "
              f"{info.inner_total} inner, recovery {info.inner_info.iterations}; converged "
              f"{bool(info.converged)}, true residual {float(info.schur_residual):.3e})")
        du = float((u.double() - u_t).norm() / u_t.norm())
        dp = float((p.double() - p_t).norm() / p_t.norm())
        div, mean = _stokes_checks(tag, Vu, Vp, u, p, STOKES_DIV32, control)
        walls = [_timed(lambda: solve(f)) for _ in range(STOKES_REPEATS)]
        # the profiled solve takes another right-hand side on the built tables
        wall_ms, device_ms, launches, dtoh, htod, kernels, k2_us, (u2, _, info2) = _profiled(
            lambda: solve(f2))
        check(htod == 0 and bool(torch.isfinite(u2).all()),
              f"{tag}: a solve of another right-hand side copies no table to the card "
              f"({htod:.0f} host-to-device copies), finite")
        median = 1e3 * float(np.median(walls))
        outer2 = max(info2.outer_iterations, 1)
        figures[name] = {
            "outer": info.outer_iterations, "inner_total": info.inner_total,
            "recovery": info.inner_info.iterations, "converged": bool(info.converged),
            "residual": float(info.schur_residual), "du_rel_l2": du, "dp_rel_l2": dp, "div_rel": div, "mean_rel": mean,
            "k2_launches": k2, "first_wall_ms": 1e3 * first_s, "median_wall_ms": median,
            "walls_ms": [1e3 * w for w in walls], "tables_s": tables_s,
            "profiled_outer": info2.outer_iterations, "profiled_inner_total": info2.inner_total,
            "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms, "launches": launches,
            "launches_per_outer": launches / outer2, "host_reads": dtoh,
            "host_reads_per_outer": dtoh / outer2, "host_to_device": htod,
            "k2_us_per_launch_in_solve": k2_us, "seconds": time.perf_counter() - t_config,
        }
        log(f"{tag}: {info.outer_iterations} outer, {info.inner_total} inner, recovery "
            f"{info.inner_info.iterations}, K2 {k2}; du {du:.3e}, dp {dp:.3e} (relative L2 vs the "
            f"float64 truth), div {div:.3e}; median wall {median:.3f} ms over {STOKES_REPEATS} "
            f"(first {1e3 * first_s:.3f}); profiled (another rhs, {info2.outer_iterations} outer): "
            f"wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, idle {1 - device_ms / wall_ms:.3f}, "
            f"{launches:.0f} launches ({launches / outer2:.1f} per outer), {dtoh:.0f} host reads "
            f"({dtoh / outer2:.1f} per outer); K2 us per launch in the solve (launches): {k2_us}")
        log("device ms/solve  launches/solve  kernel")
        for us, count, kname in kernels[:8]:
            log(f"{us / 1e3:14.4f}  {count:14.1f}  {kname[:110]}")
        del solve, u, p, u2
    base = figures["base"]["du_rel_l2"]
    check(base <= STOKES_BASE_BAR,
          f"Stokes base: du {base:.3e} <= {STOKES_BASE_BAR:g} from the float64 truth")
    for name in ("aggcomp_floor3max1", "scalar", "minres"):
        du = figures[name]["du_rel_l2"]
        check(du <= STOKES_QUALITY * base, f"Stokes {name}: du {du:.3e} <= {STOKES_QUALITY} x "
              f"base's {base:.3e} (the campaign's quality bar)")
    du = figures[STOKES_CONTROL]["du_rel_l2"]
    check(du > STOKES_QUALITY * base, f"Stokes {STOKES_CONTROL} (the control): du {du:.3e} fails "
          f"the bar {STOKES_QUALITY} x base's {base:.3e}")
    log(json.dumps({"metric": "stokes_solves", "n": STOKES_N, "velocity_dofs": Vu.n_dofs,
                    "pressure_dofs": Vp.n_dofs, "host_s": host_s, "card": card, **figures},
                   default=str))
    # phase 28 solves the same float32 problem against the same truth and
    # beside base's figures
    stokes_ref = {"bases": (Vu, Vp, f), "truth": (u_t, p_t), "base": figures["base"]}
    del Vu64, Vp64
    gc.collect()
    torch.cuda.empty_cache()
    return launches_by_path, stokes_ref


def _issued(iterations, maxiter=None):
    """The PCG iterations that ``bsr_pcg``'s loop issues on the card
    (``ops.solvers.pcg_chunked``) in a solve of ``iterations``: chunks of
    ``PCG_CHUNK`` until a count read falls short of the iterations issued
    or reaches ``maxiter``, with the chunk queued behind that read (none
    once ``maxiter`` is issued). Every one launches K2, held or not."""
    from pytorch_fem_solver_tpu_torch.ops.compiled import PCG_CHUNK as k

    if maxiter is None or iterations < maxiter:
        reads = iterations // k + 1
        return k * (reads + 1 if maxiter is None or reads * k < maxiter else reads)
    return k * -(-maxiter // k)


def _k2_rule(name, iterations, maxiter=None, chunked=True):
    """K2 launches of a solver's first make_bsr_solve / compiled solve on
    the card: one A product an iteration issued (``_issued``), one for
    r0 and one in the warm-up iteration of the solver's side stream, each
    with 2 more per M apply for the cycles and the smoothed M, and 12 at
    setup for omega="auto". Without ``chunked`` (``pcg``'s host loop, as
    in ``solve_iterative``): iterations + 1 products and no warm-up."""
    per_apply = SPMV_PER_APPLY.get(name, 0)
    if chunked:
        issued = _issued(iterations, maxiter)
        products, what = issued + 2, f"(iterations issued {issued} + 1 + 1 warm-up)"
    else:
        products, what = iterations + 1, "(iterations + 1)"
    expected = products * (1 + per_apply) + POWER_STEPS.get(name, 0)
    rule = f"{what} x {1 + per_apply}" + (
        f" + {POWER_STEPS[name]}" if name in POWER_STEPS else "")
    return expected, rule


def _precond_case(tag, name, bf16, V32, V64, ref64, card, maxiter, held=True):
    """One configuration of phase 26 at one size: ``make_bsr_solve(precond=
    name)`` in float32 and float64 (bf16 operands in both with ``bf16``),
    the K2 count of the first float32 solve by key, the median wall of
    ``PRECOND_REPEATS``, one profiled solve, the distance from the
    configuration's float64 solution and from ``ref64`` (the float64
    aggblock solution). ``held``: hold convergence, the count and the
    distance (else report them)."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import make_bsr_solve
    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    od = torch.bfloat16 if bf16 else None
    label = f"{tag} {name}{' bf16 operands' if bf16 else ''}"
    t0 = time.perf_counter()
    solve = make_bsr_solve(V32, tol=TOL, maxiter=maxiter, precond=name, operand_dtype=od)
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    cuda_build.reset_launch_counts()
    out = []
    first_s = _timed(lambda: out.append(solve()))
    x, iterations, rel = out[0]
    k2 = {k: cuda_build.launch_counts[k] for k in ("bsr_spmv", "bsr_spmv_bf16")}
    x64, it64, rel64 = make_bsr_solve(V64, tol=TOL, maxiter=maxiter, precond=name,
                                      operand_dtype=od)()
    converged = bool(torch.isfinite(x).all()) and float(rel) <= TOL
    expected, rule = _k2_rule(name, iterations, maxiter)
    check(k2 == {"bsr_spmv": expected, "bsr_spmv_bf16": 0},
          f"{label}: K2 launches {k2} == {{float32: {rule} = {expected}, bf16 values: 0}}")
    d64 = float((x.double() - x64).norm() / x64.norm())
    d_ref = float((x.double() - ref64).norm() / ref64.norm())
    walls = [_timed(solve) for _ in range(PRECOND_REPEATS)]
    wall_ms, device_ms, launches, dtoh, htod, kernels, k2_us, _ = _profiled(solve)
    fig = {"iterations": iterations, "iterations_f64": it64, "rel_residual": float(rel),
           "converged": converged, "k2_launches": k2, "k2_rule": rule,
           "vs_own_f64": d64, "vs_f64_aggblock": d_ref, "first_wall_ms": 1e3 * first_s,
           "median_wall_ms": 1e3 * float(np.median(walls)),
           "walls_ms": [1e3 * w for w in walls], "tables_s": tables_s,
           "profiled_wall_ms": wall_ms, "device_ms": device_ms,
           "idle_share": 1 - device_ms / wall_ms, "launches": launches, "host_reads": dtoh,
           "host_to_device": htod, "k2_us_per_launch_in_solve": k2_us,
           "top_kernels": [(round(us / 1e3, 4), c, n[:80]) for us, c, n in kernels[:4]]}
    log(f"{label}: {iterations} iterations (float64 {it64}), residual {float(rel):.3e}, "
        f"K2 {k2}; vs own float64 {d64:.3e}, vs float64 aggblock {d_ref:.3e}; median wall "
        f"{fig['median_wall_ms']:.3f} ms (first {1e3 * first_s:.3f}); profiled: wall "
        f"{wall_ms:.3f} ms, device {device_ms:.3f} ms, idle {1 - device_ms / wall_ms:.3f}, "
        f"{launches:.0f} launches, {dtoh:.0f} host reads; K2 us per launch {k2_us}")
    if held:
        check(converged, f"{label}: converged to {TOL:g} in {iterations} <= {maxiter}")
        check(iterations <= it64 + ITER_GAP,
              f"{label}: {iterations} float32 iterations <= float64's {it64} + {ITER_GAP}")
    return fig, x


def _precond_sweep(tag, configs, held_configs, V32, V64, card, maxiter):
    """Phase 26's configurations at one size, after the float32 floor:
    the float64 solve of the float32-rounded operator and load beside the
    float64 solve, both aggblock to 1e-12."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import _assembly, make_bsr_solve
    from pytorch_fem_solver_tpu_torch.ops.bsr import get_bsr_structure
    from pytorch_fem_solver_tpu_torch.ops.compiled import bsr_pcg

    st = get_bsr_structure(V32, max_b=8, want_entry_slot=False)
    values32, b32 = _assembly(V32, st)()
    values64, b64 = _assembly(V64, st)()
    exact = bsr_pcg(st, "aggblock", tol=1e-12)
    x_true = exact(values64, b64)[0]
    x_floor = exact(tuple(v.double() for v in values32), b32.double())[0]
    floor = float((x_floor - x_true).norm() / x_true.norm())
    del values32, values64
    ref64 = make_bsr_solve(V64, tol=TOL, maxiter=maxiter)()[0]
    figures = {"float32_floor": floor}
    for name, bf16 in configs:
        held = (name, bf16) in held_configs
        fig, x = _precond_case(tag, name, bf16, V32, V64, ref64, card, maxiter, held)
        key = f"{name}{'_bf16' if bf16 else ''}"
        figures[key] = fig
        if held and fig["converged"]:
            bar = F32_VS_F64 + 2 * floor
            text = (f"{tag} {key}: {fig['vs_own_f64']:.3e} from its float64 solution <= "
                    f"{F32_VS_F64:g} + 2 x the float32 floor {floor:.3e}")
            if key in PRECOND_F32_BAR:
                log(f"{text}: {fig['vs_own_f64'] <= bar} (reported: the float32 {key} M's bar "
                    f"is {PRECOND_F32_BAR[key]:g})")
                bar, text = PRECOND_F32_BAR[key], (
                    f"{tag} {key}: {fig['vs_own_f64']:.3e} from its float64 solution <= "
                    f"{PRECOND_F32_BAR[key]:g}, the float32 {key} M's bar")
            check(fig["vs_own_f64"] <= bar, text)
        elif not held:
            log(f"{tag} {key} (reported, not held): converged {fig['converged']} in "
                f"{fig['iterations']} of {maxiter} iterations")
        del x
    torch.cuda.empty_cache()
    return figures


def _check_k2_bf16(tag, st, values, x32, time_it):
    """K2's bf16-values instantiation against its plain version on the
    bf16 copy of ``values``: float32 x (<= K2_BF16_TOL of max |y|) and
    float64 x (1e-12), two launches bitwise equal, one launch counted
    under its own key per product; with ``time_it`` its time behind the
    write flush beside the plain version's and its byte bound. Returns the
    figure (float32 x)."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.bsr import _bsr_spmv_plain, bsr_matvec

    vb = tuple(v.to(torch.bfloat16).contiguous() for v in values)
    fig = {}
    for x, tol in ((x32, K2_BF16_TOL), (x32.double(), 1e-12)):
        before = dict(cuda_build.launch_counts)
        y = bsr_matvec(st, vb, x)
        counted = {k: cuda_build.launch_counts[k] - before[k] for k in before}
        again = bsr_matvec(st, vb, x)
        ref = _bsr_spmv_plain(st.bcols, vb[0], x, st.bcols2, vb[1], st.heavy_rows)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max() / ref.abs().max())
        check(y.dtype == x.dtype and bool(torch.isfinite(y).all()) and err <= tol,
              f"K2 bf16 values {tag}, {x.dtype} x vs plain: {err:.3e} of max |y| <= {tol:g}")
        check(torch.equal(y, again) and counted["bsr_spmv_bf16"] == 1
              and counted["bsr_spmv"] == 0,
              f"K2 bf16 values {tag}, {x.dtype} x: two launches bitwise equal, one launch "
              f"counted under bsr_spmv_bf16 per product ({counted['bsr_spmv_bf16']})")
        if x.dtype == torch.float32:
            fig["max_abs_err"] = float((y - ref).abs().max())
    # the same product through float32 values: what the cast saves
    try:
        bsr_matvec(st, (vb[0].half(), vb[1].half()), x32)
        check(False, f"K2 {tag}: float16 values with float32 x raise TypeError")
    except TypeError as err:
        check("float16" in str(err), f"K2 {tag}: float16 values with float32 x raise ({err})")
    if time_it:
        n_stored = int(st.blk_id_host.size)
        n_bytes = n_stored * (64 * 2 + 4) + 2 * st.nb * 4 + 2 * st.n_pad * 4
        b_ms, by = bound_ms(n_bytes, 2 * 64 * n_stored)
        v32 = tuple(v.to(torch.float32).contiguous() for v in values)
        fig.update({
            "ms": time_ms(lambda: bsr_matvec(st, vb, x32)),
            "float32_values_ms": time_ms(lambda: bsr_matvec(st, v32, x32)),
            "plain_ms": time_ms(lambda: _bsr_spmv_plain(st.bcols, vb[0], x32, st.bcols2, vb[1],
                                                        st.heavy_rows)),
            "bound_ms": b_ms, "bound_by": by, "bytes": n_bytes, "stored_blocks": n_stored,
            "library_ms": None,
        })
        log(f"K2 bf16 values {tag}: {fig['ms']:.4f} ms behind the write flush (float32 values "
            f"{fig['float32_values_ms']:.4f} ms, plain {fig['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms by {by}: {n_bytes} bytes, {n_stored} stored blocks); no single "
            "PyTorch call takes bf16 values with a float32 x")
    return fig


def _values_bf16_case(tag, solve32, solve_bf16, u32, info32, card):
    """``compiled_bsr_solver(values_dtype=torch.bfloat16)`` beside the
    float32 solve on the same tables: iterations, walls, K2 by key (every
    PCG product through the bf16 instantiation), K2's us per launch in a
    profiled solve, and the solution's distance from float32 (held above
    VALUES_BF16_MIN: the cast happened)."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build

    cuda_build.reset_launch_counts()
    out = []
    first_s = _timed(lambda: out.append(solve_bf16()))
    u, info = out[0]
    k2 = {k: cuda_build.launch_counts[k] for k in ("bsr_spmv", "bsr_spmv_bf16")}
    check(bool(info.converged) and bool(torch.isfinite(u).all()),
          f"{tag} bf16 values: converged in {info.iterations} iterations "
          f"(float32 {info32.iterations})")
    issued = _issued(info.iterations)
    check(k2 == {"bsr_spmv": 0, "bsr_spmv_bf16": issued + 2},
          f"{tag} bf16 values: K2 launches {k2} == {{float32: 0, bf16 values: iterations issued "
          f"+ 1 + 1 warm-up = {issued + 2}}}")
    du = float((u - u32).norm() / u32.norm())
    check(du > VALUES_BF16_MIN,
          f"{tag} bf16 values: the solution lies {du:.3e} from float32's (> {VALUES_BF16_MIN:g}: "
          "the values were cast)")
    walls = {"float32": [_timed(solve32) for _ in range(PRECOND_REPEATS)],
             "bf16_values": [_timed(solve_bf16) for _ in range(PRECOND_REPEATS)]}
    prof = {}
    for key, solve in (("float32", solve32), ("bf16_values", solve_bf16)):
        wall_ms, device_ms, launches, _, _, _, k2_us, _ = _profiled(solve)
        prof[key] = {"profiled_wall_ms": wall_ms, "device_ms": device_ms,
                     "idle_share": 1 - device_ms / wall_ms, "launches": launches,
                     "k2_us_per_launch_in_solve": k2_us}
    fig = {"iterations": info.iterations, "iterations_f32": info32.iterations,
           "k2_launches": k2, "vs_float32": du, "first_wall_ms": 1e3 * first_s,
           "median_wall_ms": {k: 1e3 * float(np.median(w)) for k, w in walls.items()},
           "profiled": prof}
    log(f"{tag} bf16 values: {info.iterations} iterations (float32 {info32.iterations}), "
        f"{du:.3e} from float32; median wall {fig['median_wall_ms']}; profiled {prof}")
    return fig


def _smoothed_and_mult(card):
    """solve_iterative(precondition="mult_two_level") on the h=0.1 network
    and the scipy smoothed M on its ELL operator (phase 13's layout,
    max_k=8), beside the ELL two-level M and Jacobi."""
    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import _stiffness, _unit_load, benchmark_basis
    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.precondition import build_smoothed_two_level
    from pytorch_fem_solver_tpu_torch.ops.solvers import pcg
    from pytorch_fem_solver_tpu_torch.ops.sparse import (
        ell_diagonal,
        ell_matvec,
        ell_values_from_local,
        get_ell_structure,
    )

    V = benchmark_basis(pt.build_benchmark_network(SMOOTHED_H, device=DEVICE,
                                                    dtype=torch.float32))
    local = V.integrate_bilinear_form_local(_stiffness)
    b = V.integrate_linear_form(_unit_load)
    fig = {"dofs": V.n_dofs}
    for precondition in ("mult_two_level", "two_level", "jacobi"):
        cuda_build.reset_launch_counts()
        out = []
        wall = _timed(lambda: out.append(V.solve_iterative(
            local, b, tol=TOL, precondition=precondition, return_info=True)))
        u, info = out[0]
        k2 = cuda_build.launch_counts["bsr_spmv"]
        fig[f"bsr_{precondition}"] = {"iterations": info.iterations, "k2_launches": k2,
                                      "wall_ms": 1e3 * wall}
        check(bool(info.converged), f"solve_iterative h={SMOOTHED_H} {precondition}: converged "
              f"in {info.iterations} iterations")
        if precondition == "mult_two_level":
            expected, rule = _k2_rule("mult", info.iterations, chunked=False)
            check(k2 == expected, f"solve_iterative mult_two_level: K2 launches {k2} == {rule} "
                  f"= {expected}")
    check(fig["bsr_mult_two_level"]["iterations"] < fig["bsr_two_level"]["iterations"],
          f"solve_iterative mult_two_level: {fig['bsr_mult_two_level']['iterations']} < "
          f"two_level's {fig['bsr_two_level']['iterations']} iterations")

    st = get_ell_structure(V, max_k=8)
    values = ell_values_from_local(st, local)
    diag = ell_diagonal(st, values)
    inner = V._as_host_index(V._basis_parameters["inner_dofs"])
    coords = V._coords4global_dofs.cpu().numpy()[inner]
    t0 = time.perf_counter()
    M = build_smoothed_two_level(st, values, coords)
    torch.cuda.synchronize()
    fig["smoothed_setup_host_s"] = time.perf_counter() - t0
    rhs = V.reduce(b).reshape(-1)
    for name, kw in (("smoothed", {"precond": M}), ("jacobi", {"precond_diag": diag})):
        _, info = pcg(lambda v: ell_matvec(st, values, v), rhs, tol=TOL, **kw)
        fig[f"ell_{name}"] = info.iterations
    _, info = V.solve_iterative(local, b, tol=TOL, method="ell", precondition="two_level",
                                return_info=True)
    fig["ell_two_level"] = info.iterations
    check(fig["ell_smoothed"] < fig["ell_jacobi"],
          f"ELL h={SMOOTHED_H}: the smoothed M takes {fig['ell_smoothed']} < Jacobi's "
          f"{fig['ell_jacobi']} iterations (two_level {fig['ell_two_level']}; scipy setup "
          f"{fig['smoothed_setup_host_s']:.2f} s on the host)")
    log(json.dumps({"metric": "mult_and_smoothed", "h": SMOOTHED_H, **fig}, default=str))
    return fig


def _probe(card):
    """probe after a P1 solve on unit_square(PROBE_N), float32 on the card,
    against the float64 CPU probe of the same u (the vertices k/n are
    exact in float32, so both locate every point in the same cell)."""
    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import _sine_load, _stiffness

    V = pt.Basis(pt.MeshTri(pt.unit_square(n=PROBE_N), device=DEVICE, dtype=torch.float32),
                 pt.ElementTri(1, 2))
    u, info = V.compiled_solver(_stiffness, _sine_load, tol=TOL)()
    check(bool(info.converged), f"probe: the P1 solve on unit_square({PROBE_N}) converged")
    pts = np.random.default_rng(SEED + 26).uniform(0.0, 1.0, size=(PROBE_POINTS, 2))
    t0 = time.perf_counter()
    V._locate_cells(pts, 1e-10)
    locate_s = time.perf_counter() - t0
    out = []
    wall_ms, device_ms, launches, _, _, _, _, _ = _profiled(lambda: out.append(V.probe(pts, u)))
    values, grads = out[0]
    V64 = pt.Basis(pt.MeshTri(pt.unit_square(n=PROBE_N), device="cpu", dtype=torch.float64),
                   pt.ElementTri(1, 2))
    ref_v, ref_g = V64.probe(pts, u.double().cpu())
    dv = float((values.double().cpu() - ref_v).abs().max() / ref_v.abs().max())
    dg = float((grads.double().cpu() - ref_g).abs().max() / ref_g.abs().max())
    check(values.shape == (PROBE_POINTS,) and grads.shape == (PROBE_POINTS, 2)
          and dv <= PROBE_TOL and dg <= PROBE_TOL,
          f"probe {PROBE_POINTS} points: values {dv:.3e}, gradients {dg:.3e} of max |ref| from "
          f"the float64 CPU probe (<= {PROBE_TOL:g})")
    fig = {"points": PROBE_POINTS, "cells": int(V.v_grad.shape[0]), "locate_host_s": locate_s,
           "probe_wall_ms": wall_ms, "evaluation_device_ms": device_ms,
           "launches": launches, "values_vs_f64": dv, "gradients_vs_f64": dg}
    log(json.dumps({"metric": "probe", **fig}))
    return fig


def phase_precond(card, st, V32, V64):
    """Phase 26: the remaining scalar preconditioners and the
    reduced-precision knobs on the card, then probe."""
    import gc

    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import (
        _sine_load_3d,
        _stiffness,
        _unit_load,
        benchmark_basis,
        tet_poisson,
    )
    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        bsr_values_from_local_symmetric,
        get_bsr_structure,
    )
    from pytorch_fem_solver_tpu_torch.ops.compiled import compiled_bsr_solver

    figures, launches_by_path, seconds = {"card": card}, {}, {}
    t0 = time.perf_counter()
    figures[f"h{H}"] = _precond_sweep(f"h={H}", PRECOND_CONFIGS, PRECOND_CONFIGS, V32, V64,
                                      card, PRECOND_MAXITER)
    for key, fig in figures[f"h{H}"].items():
        if isinstance(fig, dict):
            launches_by_path[f"precond_{key}"] = fig["k2_launches"]["bsr_spmv"]
    seconds["h0.03"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mesh64 = pt.build_benchmark_network(PRECOND_H2, device=DEVICE, dtype=torch.float64)
    mesh_s = time.perf_counter() - t0
    W32, W64 = benchmark_basis(mesh64.to(dtype=torch.float32)), benchmark_basis(mesh64)
    get_bsr_structure(W32, max_b=8, want_entry_slot=False)
    W64._bsr_structures = W32._bsr_structures
    log(f"h={PRECOND_H2}: {W32.n_dofs} DOFs, mesh {mesh_s:.2f} s on the host")
    figures[f"h{PRECOND_H2}"] = {"dofs": W32.n_dofs, "mesh_host_s": mesh_s, **_precond_sweep(
        f"h={PRECOND_H2}", PRECOND_H2_CONFIGS, PRECOND_H2_HELD, W32, W64, card,
        PRECOND_H2_MAXITER)}
    del mesh64, W32, W64
    gc.collect()
    torch.cuda.empty_cache()
    seconds["h0.02"] = time.perf_counter() - t0

    # K2's bf16-values instantiation and compiled_bsr_solver(values_dtype=bf16)
    t0 = time.perf_counter()
    values32 = bsr_values_from_local_symmetric(st, V32.integrate_bilinear_form_local(_stiffness))
    x32 = torch.as_tensor(np.random.default_rng(SEED + 27).standard_normal(st.n_pad),
                          dtype=torch.float32, device=DEVICE)
    k2_dfn = _check_k2_bf16(f"h={H}", st, values32, x32, time_it=True)
    del values32
    solve32 = compiled_bsr_solver(V32, _stiffness, _unit_load, tol=TOL)
    solve_bf = compiled_bsr_solver(V32, _stiffness, _unit_load, tol=TOL,
                                   values_dtype=torch.bfloat16)
    u32, info32 = solve32()
    figures["values_bf16_dfn"] = _values_bf16_case(f"h={H}", solve32, solve_bf, u32, info32, card)

    r = tet_poisson(VALUES_BF16_TET_N, device=DEVICE, dtype=torch.float32)
    tst = get_bsr_structure(r.basis, max_b=24, want_entry_slot=False)
    check(int(tst.n_inner) == TET_STRUCTURE[0],
          f"unit_cube({VALUES_BF16_TET_N}): {tst.n_inner} inner DOFs == {TET_STRUCTURE[0]}")
    tvalues = bsr_values_from_local_symmetric(
        tst, r.basis.integrate_bilinear_form_local(_stiffness))
    tx = torch.as_tensor(np.random.default_rng(SEED + 28).standard_normal(tst.n_pad),
                         dtype=torch.float32, device=DEVICE)
    k2_tet = _check_k2_bf16(f"unit_cube({VALUES_BF16_TET_N})", tst, tvalues, tx, time_it=True)
    del tvalues
    solve_bf = r.basis.compiled_solver(_stiffness, _sine_load_3d, tol=TOL,
                                       values_dtype=torch.bfloat16)
    figures["values_bf16_tet"] = _values_bf16_case(
        f"unit_cube({VALUES_BF16_TET_N})", r.solve, solve_bf, r.u, r.info, card)
    del r, solve_bf
    gc.collect()
    torch.cuda.empty_cache()
    seconds["values_bf16"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    figures["mult_and_smoothed"] = _smoothed_and_mult(card)
    launches_by_path["solve_iterative_mult"] = (
        figures["mult_and_smoothed"]["bsr_mult_two_level"]["k2_launches"])
    seconds["mult_and_smoothed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    figures["probe"] = _probe(card)
    seconds["probe"] = time.perf_counter() - t0
    figures["seconds"] = seconds
    log(json.dumps({"metric": "preconditioners_and_reduced_precision", **figures}, default=str))
    bf16_record = {
        "shape": f"unit_cube({VALUES_BF16_TET_N}), {k2_tet['stored_blocks']} stored blocks",
        "us": 1e3 * k2_tet["ms"], "bound_us": 1e3 * k2_tet["bound_ms"],
        "plain_us": 1e3 * k2_tet["plain_ms"], "float32_values_us": 1e3 * k2_tet["float32_values_ms"],
        "dfn_us": 1e3 * k2_dfn["ms"], "dfn_bound_us": 1e3 * k2_dfn["bound_ms"],
        "max_abs_err": max(k2_tet["max_abs_err"], k2_dfn["max_abs_err"]),
        "library_us": None,
        "launches_by_path": {
            "values_bf16_dfn": figures["values_bf16_dfn"]["k2_launches"]["bsr_spmv_bf16"],
            "values_bf16_tet": figures["values_bf16_tet"]["k2_launches"]["bsr_spmv_bf16"]},
    }
    return bf16_record, launches_by_path


def _row_slice_k2(V32, local32):
    """K2 on real block-row slices: the two shards of a 2-shard plan of the
    network (built on the host, no process group), each shard's rows
    against the whole padded iterate, against the plain version in float64
    (1e-12 of ||y||) and float32 (1e-5), two launches bitwise equal; the
    time of shard 0's float32 slice beside plain, a CSR ``torch.mv`` of the
    same rows and the bound of the bytes it needs (its stored blocks and
    columns, its two row tables, the x blocks its columns name, y)."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.bsr import _bsr_spmv_plain, bsr_spmv
    from pytorch_fem_solver_tpu_torch.parallel import sharded_bsr as psb

    plan = psb.build_bsr_shard_plan(V32, 2)
    st, k = plan.st, plan.st.block
    x64 = torch.as_tensor(np.random.default_rng(SEED + 29).standard_normal(plan.nb_pad * k),
                          device=DEVICE)
    max_abs, rec = 0.0, {}
    for rank in range(2):
        t = psb._shard_tables(plan, rank, DEVICE)
        v1, v2, _ = psb._scatter_local_values(plan, local32.double()[t.cells], t)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            a1, a2, x = v1.to(dtype), v2[: t.nh].to(dtype).contiguous(), x64.to(dtype)
            args = (t.bcols, a1, x, t.bcols2, a2, t.hrows, t.row_blocks, t.heavy_rank)
            before = cuda_build.launch_counts["bsr_spmv"]
            y = bsr_spmv(*args)
            counted = cuda_build.launch_counts["bsr_spmv"] - before
            again = bsr_spmv(*args)
            ref = _bsr_spmv_plain(*args[:6])
            torch.cuda.synchronize()
            err = float((y - ref).norm() / ref.norm())
            check(bool(torch.isfinite(y).all()) and err <= tol and y.shape == (plan.rps * k,),
                  f"K2 row slice {rank} of 2 ({plan.rps} of {plan.nb_pad} block rows, x of "
                  f"{x.numel()}) {dtype} vs plain: rel err {err:.3e} <= {tol:g}")
            check(torch.equal(y, again) and counted == 1,
                  f"K2 row slice {rank} {dtype}: two launches bitwise equal, {counted} launch")
            if dtype == torch.float32:
                max_abs = max(max_abs, float((y - ref).abs().max()))
        if rank == 0:
            args32 = (t.bcols, v1.float(), x64.float(), t.bcols2, v2[: t.nh].float().contiguous(),
                      t.hrows, t.row_blocks, t.heavy_rank)
            rows = plan.rps
            counts = t.row_blocks.cpu().numpy().astype(np.int64)
            n_stored = int(counts.sum())
            cols = np.concatenate([
                np.concatenate([plan.bcols_sh[r, :min(c, t.bcols.shape[1])] for r, c in
                                enumerate(counts)]),
                t.bcols2.cpu().numpy().reshape(-1)])
            n_bytes = (n_stored * (64 * 4 + 4) + 2 * rows * 4 + np.unique(cols).size * k * 4
                       + rows * k * 4)
            b_ms, by = bound_ms(n_bytes, 2 * 64 * n_stored)
            csr = _row_csr(args32, rows, k, x64.numel())
            y_lib = torch.mv(csr, args32[2])
            lib_err = float((y_lib - bsr_spmv(*args32)).norm() / y_lib.norm())
            check(lib_err <= 1e-5, f"K2 row slice vs torch CSR matvec of its rows: {lib_err:.3e}")
            rec = {"rows": rows, "of_rows": plan.nb_pad, "stored_blocks": n_stored,
                   "ms": time_ms(lambda: bsr_spmv(*args32)),
                   "plain_ms": time_ms(lambda: _bsr_spmv_plain(*args32[:6])),
                   "library_ms": time_ms(lambda: torch.mv(csr, args32[2])),
                   "bound_ms": b_ms, "bound_by": by}
    rec["max_abs_err"] = max_abs
    log(f"K2 row slice (shard 0 of 2: {rec['rows']} of {rec['of_rows']} block rows, "
        f"{rec['stored_blocks']} stored blocks): {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} "
        f"ms, torch CSR {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
        f"{rec['bound_by']})")
    return rec


def _row_csr(args, rows, k, n_cols):
    """The stored blocks of a row slice as one torch CSR matrix (rows * k,
    n_cols): the library yardstick of the row-slice product."""
    import torch

    bcols, v1, _, bcols2, v2, hrows, row_blocks, _ = args
    B, B2 = bcols.shape[1], bcols2.shape[1]
    dev = v1.device
    counts = row_blocks.long()
    slot = torch.arange(B, device=dev)
    on1 = slot[None, :] < counts[:, None]
    br = [torch.arange(rows, device=dev)[:, None].expand(rows, B)[on1]]
    bc, vals = [bcols.long()[on1]], [v1[on1]]
    if hrows.numel():
        on2 = torch.arange(B2, device=dev)[None, :] < (counts[hrows] - B)[:, None]
        br.append(hrows[:, None].expand(-1, B2)[on2])
        bc.append(bcols2.long()[on2])
        vals.append(v2[on2])
    br, bc, vals = torch.cat(br), torch.cat(bc), torch.cat(vals)
    ii, jj = torch.meshgrid(torch.arange(k, device=dev), torch.arange(k, device=dev),
                            indexing="ij")
    a = torch.sparse_coo_tensor(
        torch.stack([(br[:, None, None] * k + ii).reshape(-1),
                     (bc[:, None, None] * k + jj).reshape(-1)]),
        vals.reshape(-1), (rows * k, n_cols), check_invariants=False,
    )
    return a.coalesce().to_sparse_csr()


@contextlib.contextmanager
def _nccl_group(prefix):
    """A world-size-1 NCCL group through a FileStore in a temporary
    directory (no network), destroyed on the way out: yields the mesh, the
    seconds it took to open and the directory."""
    import tempfile

    import torch
    import torch.distributed as dist

    from pytorch_fem_solver_tpu_torch.parallel import make_device_mesh

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{prefix}_")
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_device_mesh(1)
        yield mesh, time.perf_counter() - t0, tmp
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_sharded(card, V32, V64):
    """Phase 27: the row-sharded BSR solve and the ``utils`` on the card. A
    world-size-1 NCCL group through a FileStore in a temporary directory
    (no network), destroyed at the end."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench import _stiffness, _unit_load
    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.compiled import compiled_bsr_solver
    from pytorch_fem_solver_tpu_torch.parallel import sharded_bsr_solver
    from pytorch_fem_solver_tpu_torch.parallel.sharding import mesh_device
    from pytorch_fem_solver_tpu_torch.utils import StepTimer, trace, write_vtk
    from pytorch_fem_solver_tpu_torch.utils.watchdog import Watchdog, probe_device

    with _nccl_group("phase27") as (mesh, group_s, tmp):
        check(mesh_device(mesh) == torch.device("cuda", 0),
              f"NCCL group of 1 in {group_s:.2f} s, the rank on {mesh_device(mesh)}")
        wd = Watchdog(metric="chip_smoke", extra={"phase": 27})
        probe_s = probe_device(wd, seconds=60.0)  # armed for the probe, then disarmed
        log(f"probe_device on the card: {1e3 * probe_s:.3f} ms round trip")

        solve_c = compiled_bsr_solver(V32, _stiffness, _unit_load, tol=TOL)
        u_c, info_c = solve_c()
        u64, _ = compiled_bsr_solver(V64, _stiffness, _unit_load, tol=TOL)()
        t0 = time.perf_counter()
        solve_s = sharded_bsr_solver(V32, _stiffness, _unit_load, device_mesh=mesh, tol=TOL)
        torch.cuda.synchronize()
        tables_s = time.perf_counter() - t0
        wd.arm(SHARDED_WATCHDOG_S, "phase 27: sharded solve")
        cuda_build.reset_launch_counts()
        u_s, (it, res, conv) = solve_s()
        torch.cuda.synchronize()
        launches = dict(cuda_build.launch_counts)
        wd.disarm()
        floor = float((u_c.double() - u64).norm() / u64.norm())
        d_c = float((u_s - u_c).norm() / u_c.norm())
        d64 = float((u_s.double() - u64).norm() / u64.norm())
        log(f"sharded_bsr_solver (1 rank): {it} iterations (compiled_bsr_solver "
            f"{info_c.iterations}), residual {float(res):.4e}, K2 {launches['bsr_spmv']}, "
            f"vs compiled {d_c:.3e}, vs float64 {d64:.3e} (compiled's float32 floor {floor:.3e}), "
            f"plan and tables {tables_s:.2f} s")
        check(bool(conv) and bool(torch.isfinite(u_s).all()) and u_s.shape == u_c.shape,
              f"sharded_bsr_solver converged to {TOL:g}, finite, shape {tuple(u_s.shape)}")
        check(abs(it - info_c.iterations) <= SHARDED_ITER_GAP,
              f"sharded {it} iterations within {SHARDED_ITER_GAP} of compiled's "
              f"{info_c.iterations}")
        check(d_c <= 1e-4, f"sharded vs compiled float32 solution {d_c:.3e} <= 1e-4")
        check(d64 <= 1e-4 + 2 * floor,
              f"sharded vs float64 {d64:.3e} <= 1e-4 + 2 x the float32 floor {floor:.3e}")
        check(launches["bsr_spmv"] == it + 1 and launches["bsr_spmv_bf16"] == 0,
              f"K2 launched on the row slice (iterations + 1) = {it + 1} times "
              f"({launches['bsr_spmv']}), bf16 {launches['bsr_spmv_bf16']}")

        timer_s, timer_c = StepTimer(), StepTimer()
        med_s = timer_s.time_fn(solve_s, warmup=1, reps=SHARDED_REPEATS)
        med_c = timer_c.time_fn(solve_c, warmup=1, reps=SHARDED_REPEATS)
        check(med_s["count"] == med_c["count"] == SHARDED_REPEATS,
              f"StepTimer: {SHARDED_REPEATS} timed solves each")
        wall_ms, device_ms, n_launch, dtoh, htod, kernels, k2_us, _ = _profiled(solve_s)
        log(f"sharded median {1e3 * med_s['median_s']:.3f} ms, compiled median "
            f"{1e3 * med_c['median_s']:.3f} ms (StepTimer, median of {SHARDED_REPEATS}); "
            f"profiled sharded: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, idle "
            f"{1 - device_ms / wall_ms:.3f}, {n_launch:.0f} launches, {dtoh:.0f} host reads; "
            f"K2 us per launch {k2_us}")

        with trace(os.path.join(tmp, "trace")) as log_dir:
            solve_s()
            torch.cuda.synchronize()
        files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
        text = open(files[0]).read() if len(files) == 1 else ""
        check(len(files) == 1 and "bsr_spmv" in text,
              f"trace() wrote {len(files)} Chrome trace of {len(text)} bytes naming bsr_spmv")

        path = write_vtk(os.path.join(tmp, "u.vtk"), V32._coords4global_dofs,
                         V32._global_dofs4elements, point_data={"u": u_s})
        with open(path) as fh:
            points = next(int(line.split()[1]) for line in fh if line.startswith("POINTS"))
        check(points == V32.n_dofs, f"write_vtk: {points} points read back == {V32.n_dofs}")
        row_slice = _row_slice_k2(V32, V32.integrate_bilinear_form_local(_stiffness))
        fig = {"card": card, "iterations": it, "iterations_compiled": info_c.iterations,
               "k2_launches": launches["bsr_spmv"], "vs_compiled": d_c, "vs_f64": d64,
               "f32_floor": floor, "median_ms": 1e3 * med_s["median_s"],
               "compiled_median_ms": 1e3 * med_c["median_s"], "tables_s": tables_s,
               "profiled_wall_ms": wall_ms, "device_ms": device_ms,
               "idle_share": 1 - device_ms / wall_ms, "launches": n_launch, "host_reads": dtoh,
               "k2_us_per_launch_in_solve": k2_us, "group_s": group_s,
               "probe_ms": 1e3 * probe_s, "trace_bytes": len(text), "vtk_points": points,
               "row_slice": row_slice}
        log(json.dumps({"metric": "sharded_bsr", **fig}, default=str))
        return launches["bsr_spmv"], row_slice


def _sharded_figures(tag, solve, first_s, twin):
    """The timing of one phase-28 solve beside its compiled twin's figures
    from an earlier phase of this run: the median wall of
    ``SHARDED_SOLVER_REPEATS`` solves (the first, counted solve's wall
    ``first_s`` and the rest) and one profiled solve (device ms, idle
    share, launches, host reads, K2's us per launch); the host seconds of
    the repeats and of the profiled solve with the profiler's own work."""
    t0 = time.perf_counter()
    walls = [first_s] + [_timed(solve) for _ in range(SHARDED_SOLVER_REPEATS - 1)]
    t1 = time.perf_counter()
    wall_ms, device_ms, launches, dtoh, _, kernels, k2_us, _ = _profiled(solve)
    fig = {"median_wall_ms": 1e3 * float(np.median(walls)), "walls_ms": [1e3 * w for w in walls],
           "profiled_wall_ms": wall_ms, "device_ms": device_ms,
           "idle_share": 1 - device_ms / wall_ms, "launches": launches, "host_reads": dtoh,
           "k2_us_per_launch_in_solve": k2_us,
           "seconds": {"repeats": t1 - t0, "profiled": time.perf_counter() - t1}}
    keys = ("median_wall_ms", "device_ms", "idle_share", "launches", "host_reads")
    fig["compiled"] = {key: twin.get(key) for key in keys}
    log(f"{tag}: median wall {fig['median_wall_ms']:.3f} ms over {SHARDED_SOLVER_REPEATS} "
        f"(the first, counted one and {SHARDED_SOLVER_REPEATS - 1} more; compiled "
        f"{twin['median_wall_ms']:.3f}); profiled: wall {wall_ms:.3f} ms, device "
        f"{device_ms:.3f} ms (compiled {twin['device_ms']:.3f}), idle {fig['idle_share']:.3f} "
        f"(compiled {twin['idle_share']:.3f}), {launches:.0f} launches (compiled "
        f"{twin['launches']:.0f}), {dtoh:.0f} host reads (compiled {twin.get('host_reads')}); "
        f"K2 us per launch in the solve (launches): {k2_us}; host s: repeats "
        f"{fig['seconds']['repeats']:.1f}, profiled solve and its processing "
        f"{fig['seconds']['profiled']:.1f}")
    log("device ms/solve  launches/solve  kernel")
    for us, count, name in kernels[:6]:
        log(f"{us / 1e3:14.4f}  {count:14.1f}  {name[:110]}")
    return fig


@contextlib.contextmanager
def _counted_first_solve(wd, what):
    """Counts reset, the plain SpMV counted and the watchdog armed around a
    first solve: yields ``{"k2": launches, "plain": plain SpMV calls,
    "wall_s": its wall}``, filled on the way out."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import bsr, cuda_build

    plain = bsr._bsr_spmv_plain
    seen = {"plain": 0}

    def counted(*args):
        seen["plain"] += 1
        return plain(*args)

    bsr._bsr_spmv_plain = counted
    wd.arm(SHARDED_WATCHDOG_S, f"phase 28: {what}")
    cuda_build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield seen
        torch.cuda.synchronize()
        seen["wall_s"] = time.perf_counter() - t0
        seen["k2"] = cuda_build.launch_counts["bsr_spmv"]
        seen["k2_bf16"] = cuda_build.launch_counts["bsr_spmv_bf16"]
    finally:
        wd.disarm()
        bsr._bsr_spmv_plain = plain


def _check_k2_counted(tag, seen, expected, rule):
    check(seen["k2"] == expected and seen["k2"] > 0 and seen["k2_bf16"] == 0
          and seen["plain"] == 0,
          f"{tag}: K2 launched on the rank's rows {seen['k2']} times == {rule} = {expected}, "
          f"bf16 {seen['k2_bf16']}, plain SpMV calls {seen['plain']}")


def phase_sharded_solvers(card, V32, newton_ref, eigsh_ref, stokes_ref):
    """Phase 28: the sharded Newton, eigen and Stokes solvers on a
    world-size-1 NCCL group, each beside its compiled twin of phases 22, 24
    and 25 (their figures and reference solutions from this run)."""
    import gc

    import torch

    from pytorch_fem_solver_tpu_torch.bench import (
        STOKES_CONFIGS,
        STOKES_INNER_MAXITER,
        _mass,
        _stiffness,
        dfn_residual,
        stokes_div,
        stokes_viscous,
    )
    from pytorch_fem_solver_tpu_torch.parallel import (
        sharded_eigsh_solver,
        sharded_newton,
        sharded_newton_solver,
        sharded_stokes_solver,
    )
    from pytorch_fem_solver_tpu_torch.utils.watchdog import Watchdog

    figures, k2 = {"card": card}, {}
    with _nccl_group("phase28") as (mesh, group_s, _):
        wd = Watchdog(metric="chip_smoke", extra={"phase": 28})
        log(f"phase 28: NCCL group of 1 in {group_s:.2f} s")

        # Newton on the network: the BiCGStab iterations of each step
        tag = f"sharded Newton DFN h={H}"
        twin = newton_ref["figures"]
        t0 = time.perf_counter()
        solve = sharded_newton_solver(V32, dfn_residual, device_mesh=mesh, tol=NEWTON_TOL_DFN,
                                      precondition="two_level")
        torch.cuda.synchronize()
        tables_s = time.perf_counter() - t0
        inner, plain_bicgstab = [], sharded_newton.bicgstab

        def bicgstab(*args, **kwargs):
            x, info = plain_bicgstab(*args, **kwargs)
            inner.append(info.iterations)
            return x, info

        sharded_newton.bicgstab = bicgstab
        try:
            with _counted_first_solve(wd, "sharded Newton") as seen:
                u, (k, res, conv) = solve()
        finally:
            sharded_newton.bicgstab = plain_bicgstab
        u64 = newton_ref["u64"]
        d64 = float((u.double() - u64).norm() / u64.norm())
        d_c = float((u - newton_ref["u32"]).norm() / newton_ref["u32"].norm())
        check(bool(conv) and bool(torch.isfinite(u).all()),
              f"{tag}: converged in {k} Newton steps to {float(res):.3e}, finite")
        check(abs(k - twin["newton_steps"]) <= 1,
              f"{tag}: {k} steps within 1 of compiled_newton's {twin['newton_steps']}")
        check(d64 <= F32_VS_F64, f"{tag}: vs phase 22's float64 solution rel L2 {d64:.3e} <= "
              f"{F32_VS_F64:g} (vs compiled float32 {d_c:.3e})")
        _check_k2_counted(tag, seen, sum(2 * i + 1 for i in inner),
                          f"2 x inner iterations + 1 per step (inner {inner})")
        k2["sharded_newton"] = seen["k2"]
        figures["newton"] = {"steps": k, "steps_compiled": twin["newton_steps"],
                             "inner_per_step": list(inner), "k2_launches": seen["k2"],
                             "vs_f64": d64, "vs_compiled": d_c, "tables_s": tables_s,
                             **_sharded_figures(tag, solve, seen["wall_s"], twin)}
        del solve, u

        # LOBPCG on the network, against phase 24's float64 twin
        tag = f"sharded eigsh DFN h={H}"
        twin = eigsh_ref
        t0 = time.perf_counter()
        solve = sharded_eigsh_solver(V32, _stiffness, _mass, k=EIGSH_K, device_mesh=mesh,
                                     tol=EIGSH_TOL)
        torch.cuda.synchronize()
        tables_s = time.perf_counter() - t0
        with _counted_first_solve(wd, "sharded eigsh") as seen:
            vals, vecs, (rounds, change, conv) = solve()
        vals_h = vals.double().cpu().numpy()
        ref = np.array(twin["vals_f64"])
        diff = float(np.max(np.abs(vals_h - ref) / np.abs(ref)))
        ortho = _m_orthonormality(V32, vecs, _mass)
        m = twin["m"]
        check(bool(conv) and bool(torch.isfinite(vecs).all())
              and bool(np.all(np.diff(vals_h) >= 0)),
              f"{tag}: converged in {rounds} rounds (compiled {twin['rounds']}; float32 round "
              f"counts vary, reported), finite, ascending: {vals_h.tolist()}")
        check(diff <= EIGSH_VS_F64, f"{tag}: eigenvalues within {diff:.3e} <= {EIGSH_VS_F64:g} "
              f"of phase 24's float64 twin")
        check(ortho <= EIGSH_ORTHO, f"{tag}: max |X^T M X - I| {ortho:.3e} <= {EIGSH_ORTHO:g}")
        _check_k2_counted(tag, seen, 2 * m + 6 * m * rounds, f"2 m + 6 m x rounds (m={m})")
        k2["sharded_eigsh"] = seen["k2"]
        figures["eigsh"] = {"rounds": rounds, "rounds_compiled": twin["rounds"],
                            "vals": vals_h.tolist(), "vs_f64": diff, "m_orthonormality": ortho,
                            "k2_launches": seen["k2"], "tables_s": tables_s,
                            **_sharded_figures(tag, solve, seen["wall_s"], twin)}
        del solve, vecs

        # Stokes on phase 25's problem, against its float64 truth
        Vu, Vp, f = stokes_ref["bases"]
        u_t, p_t = stokes_ref["truth"]
        twin = stokes_ref["base"]
        tag = f"sharded Stokes rectangle({STOKES_N}) two_level"
        t0 = time.perf_counter()
        solve = sharded_stokes_solver(Vu, Vp, stokes_viscous, stokes_div, device_mesh=mesh,
                                      precondition="two_level",
                                      inner_maxiter=STOKES_INNER_MAXITER,
                                      **STOKES_CONFIGS["base"])
        torch.cuda.synchronize()
        tables_s = time.perf_counter() - t0
        with _counted_first_solve(wd, "sharded Stokes") as seen:
            u, p, info = solve(f)
        du = float((u.double() - u_t).norm() / u_t.norm())
        dp = float((p.double() - p_t).norm() / p_t.norm())
        check(bool(info.converged) and bool(torch.isfinite(u).all())
              and bool(torch.isfinite(p).all()),
              f"{tag}: converged ({info.outer_iterations} outer, {info.inner_total} inner, "
              f"recovery {info.inner_info.iterations}; compiled base {twin['outer']} / "
              f"{twin['inner_total']}), finite")
        check(du <= STOKES_QUALITY * twin["du_rel_l2"],
              f"{tag}: du {du:.3e} <= {STOKES_QUALITY} x base's {twin['du_rel_l2']:.3e} from the "
              f"float64 truth (dp {dp:.3e})")
        div, mean = _stokes_checks(tag, Vu, Vp, u, p, STOKES_DIV32)
        expected, rule = _stokes_k2_rule("base", info)
        _check_k2_counted(tag, seen, expected, rule)
        k2["sharded_stokes"] = seen["k2"]
        figures["stokes"] = {"outer": info.outer_iterations, "inner_total": info.inner_total,
                             "recovery": info.inner_info.iterations,
                             "outer_compiled": twin["outer"],
                             "inner_total_compiled": twin["inner_total"], "du_rel_l2": du,
                             "dp_rel_l2": dp, "du_compiled": twin["du_rel_l2"], "div_rel": div,
                             "mean_rel": mean, "k2_launches": seen["k2"], "tables_s": tables_s,
                             **_sharded_figures(tag, lambda: solve(f), seen["wall_s"], twin)}
        del solve, u, p
    log(json.dumps({"metric": "sharded_solvers", **figures}, default=str))
    gc.collect()
    torch.cuda.empty_cache()
    return k2


def phase_two_fracture():
    """Phase 10: the two-fracture RVPINN loss and one Adam step on the card,
    against the same port in float64 on the CPU."""
    import torch

    from pytorch_fem_solver_tpu_torch.bench_vpinn import make_two_fracture, two_fracture_loss
    from pytorch_fem_solver_tpu_torch.models import Model

    histories = {}
    for device, dtype in (("cpu", torch.float64), (DEVICE, torch.float32)):
        problem = make_two_fracture(TWO_FRACTURE_N, device=device, dtype=dtype)

        def step(net, basis=problem.basis):
            loss = two_fracture_loss(net, basis)
            return loss, loss, loss

        model = Model(problem.network, step, epochs=2, progress_bar=False)
        model.train()  # the loss before and after one step
        histories[dtype] = model.get_training_history()[0]
    card, ref = histories[torch.float32], histories[torch.float64]
    diff = _rel_curve(card, ref)
    log(f"two-fracture n={TWO_FRACTURE_N}: card f32 losses {card}, CPU f64 {ref}")
    check(bool(np.isfinite(card).all()) and diff <= 1e-4,
          f"two-fracture loss and one step, card f32 vs CPU f64: rel {diff:.3e} <= 1e-4")


def phase_k6(st):
    """Phase 11: K6 on the gather probe's inputs (its path) and at the
    h=0.03 SpMV shapes."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.gather import _gather_rows_plain, gather_rows

    rng = np.random.default_rng(0)  # the tool's inputs, in its order
    nb, k, B = 256, 8, 8
    x = rng.normal(size=(nb, k)).astype(np.float32)
    cols = rng.integers(0, nb, size=(nb, B)).astype(np.int32)
    want = torch.as_tensor(x[cols].reshape(nb, B * k), device=DEVICE)
    xd = torch.as_tensor(x, device=DEVICE)
    cd = torch.as_tensor(cols, device=DEVICE)
    cuda_build.reset_launch_counts()
    out = gather_rows(xd, cd)
    torch.cuda.synchronize()
    launches = cuda_build.launch_counts["gather_rows"]
    check(torch.equal(out, want), "K6 on the probe's inputs equals the tool's want exactly")
    check(launches >= 1, f"K6 launched by the probe ({launches})")
    for dtype in (torch.float32, torch.float64):
        xs = torch.as_tensor(rng.standard_normal(st.n_pad), device=DEVICE).to(dtype).reshape(-1, 8)
        bcols = st.bcols.contiguous()
        ours = gather_rows(xs, bcols)
        ref = _gather_rows_plain(xs, bcols)
        torch.cuda.synchronize()
        check(torch.equal(ours, ref), f"K6 {dtype} at the SpMV shapes equals x[cols] exactly")
    for k in EDGE_K6_K:
        edge = np.random.default_rng(k)
        x64 = edge.standard_normal((41, k))
        cols_k = torch.as_tensor(edge.integers(0, 41, size=(37, 5)).astype(np.int32), device=DEVICE)
        for dtype in (torch.float32, torch.float64):
            xk = torch.as_tensor(x64, device=DEVICE).to(dtype)
            for tag, xt in (("aligned", xk), ("off a 16-byte boundary", cuda_build.misaligned_copy(xk))):
                ours = gather_rows(xt, cols_k)
                torch.cuda.synchronize()
                check(torch.equal(ours, xt[cols_k.long()].reshape(37, -1)),
                      f"K6 {dtype} k={k} x {tag} (nb=37, B=5) equals x[cols] exactly")
    nbs, Bs = bcols.shape
    xs32 = xs.to(torch.float32)
    windows["K6"] = lambda: gather_rows(xs32, bcols)
    streams["K6"] = (lambda i: (xs32.clone(), bcols.clone()), gather_rows,
                     4 * (nbs * Bs + st.n_pad + nbs * Bs * 8), ("gather_rows",))
    ms = time_ms(windows["K6"])
    plain_ms = time_ms(lambda: _gather_rows_plain(xs32, bcols))
    library_ms = time_ms(lambda: xs32[bcols])
    # cols and x read once, the (nb, B*8) blocks written once
    b_ms, by = bound_ms(4 * (nbs * Bs + st.n_pad + nbs * Bs * 8), 0)
    log(f"K6 gather_rows nb={nbs} B={Bs} k=8: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
        f"x[cols] {library_ms:.4f} ms, bound {b_ms:.4f} ms by {by})")
    return {
        "name": "gather_rows",
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/gather.cu",
        "replaces": "tools/exp_pallas_gather_probe.py:44",
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": library_ms,
        "launches": launches,
    }


def _k7_batch(batch, n, dtype):
    """``batch`` seeded SPD (n, n) blocks on the card, block K7_ZERO_BLOCK
    all-zero and pinned to the identity."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops.precondition import _pin_zero_diagonal

    gen = torch.Generator(device=DEVICE).manual_seed(batch + n)
    m = torch.randn((batch, n, n), generator=gen, device=DEVICE, dtype=torch.float64)
    spd = m @ m.mT + n * torch.eye(n, device=DEVICE, dtype=torch.float64)
    spd[K7_ZERO_BLOCK] = 0.0
    return _pin_zero_diagonal(spd).to(dtype)


def _k7_rel(ours, ref) -> float:
    """The largest relative Frobenius distance over the batch."""
    import torch

    ours, ref = ours.double(), ref.double()
    return float((torch.linalg.matrix_norm(ours - ref) / torch.linalg.matrix_norm(ref)).max())


def phase_k7():
    """Phase 29: K7 against the plain Gauss-Jordan at the cells' shapes, and
    its time."""
    import torch

    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.precondition import (
        _batched_small_inv_plain,
        batched_small_inv,
        small_inv_max_n,
    )

    eps32 = float(np.finfo(np.float32).eps)
    shapes = []
    for batch, n in K7_SHAPES:
        a64 = _k7_batch(batch, n, torch.float64)
        truth = _batched_small_inv_plain(a64)
        eye = torch.eye(n, device=DEVICE)
        errors = {}
        for dtype in (torch.float64, torch.float32):
            if n > small_inv_max_n(dtype):
                continue
            a = a64.to(dtype)
            cuda_build.reset_launch_counts()
            out = batched_small_inv(a)
            torch.cuda.synchronize()
            launches = cuda_build.launch_counts["small_inv"]
            check(launches == 1, f"K7 {dtype} ({batch}, {n}, {n}): one launch ({launches})")
            check(out.is_contiguous() and out.shape == a.shape, f"K7 {dtype} ({batch}, {n}, {n}): "
                  "contiguous, the input's shape")
            check(torch.equal(batched_small_inv(a), out),
                  f"K7 {dtype} ({batch}, {n}, {n}): two launches bitwise equal")
            check(torch.equal(out[K7_ZERO_BLOCK], eye.to(dtype)),
                  f"K7 {dtype} ({batch}, {n}, {n}): the pinned block is exactly I")
            plain = _batched_small_inv_plain(a) if dtype == torch.float32 else truth
            err, plain_err = _k7_rel(out, truth), _k7_rel(plain, truth)
            if dtype == torch.float64:
                check(err <= 1e-12, f"K7 float64 ({batch}, {n}, {n}) vs plain: {err:.3e} <= 1e-12")
            else:
                bound = 2 * plain_err + n * eps32
                check(err <= bound, f"K7 float32 ({batch}, {n}, {n}) vs the float64 inverse: "
                      f"{err:.3e} <= 2 x plain's {plain_err:.3e} + n eps32 = {bound:.3e}")
            errors[str(dtype).removeprefix("torch.")] = err
            del out, plain
        del truth, a64
        a = _k7_batch(batch, n, torch.float32)
        ms = time_ms(lambda: batched_small_inv(a))
        ms_read = time_ms(lambda: batched_small_inv(a), flush="read")
        plain_ms = time_ms(lambda: _batched_small_inv_plain(a), reps=5)
        library_ms = time_ms(lambda: torch.linalg.inv(a), reps=10)
        # each block read once and its inverse written once; 2 n^3 operations a block
        b_ms, by = bound_ms(2 * 4 * batch * n * n, 2 * batch * n**3)
        log(f"K7 small_inv ({batch}, {n}, {n}) float32: {ms:.4f} ms ({ms_read:.4f} behind the "
            f"read flush; plain {plain_ms:.4f} ms, torch.linalg.inv {library_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms by {by}); error vs float64 {errors}")
        shapes.append({"shape": [batch, n, n], "ms": ms, "ms_read_flush": ms_read,
                       "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
                       "bound_by": by, "rel_err": errors})
        del a
    first = shapes[0]
    return {
        "name": "small_inv",
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/small_inv.cu",
        "replaces": "none (ops/precondition.py:207 batched_small_inv is plain jnp)",
        "max_abs_err": None,
        "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"],
        "library_ms": first["library_ms"],
        "shapes": shapes,
    }


def _k8_triangle_sectors(n_loc: int, itemsize: int = 4) -> int:
    """The 32-byte sectors of one contiguous (n_loc, n_loc) matrix that hold
    a word of its upper triangle: what K8 reads of each cell, where a cell's
    matrix starts on a sector (its n_loc^2 words a whole number of them)."""
    assert n_loc * n_loc * itemsize % 32 == 0
    iu, ju = np.triu_indices(n_loc)
    return int(np.unique((iu * n_loc + ju) * itemsize // 32).size)


def _k8_stock(values, slots, local):
    """The pair scatter as the port ran it before K8: the pairs copied out,
    the diagonal halved, added with ``index_add_``."""
    import torch

    n_loc = local.shape[-1]
    iu, ju = torch.triu_indices(n_loc, n_loc, device=local.device)
    w = torch.where(iu == ju, 0.5, 1.0).to(local.dtype)
    return values.index_add_(0, slots, (local[..., iu, ju] * w).reshape(-1))


def _k8_lame(b):
    """2 mu eps(u):eps(v) + lambda div u div v with mu = 1, lambda = 2."""
    import torch

    g = b.v_grad
    eps = 0.5 * (g + g.transpose(-1, -2))
    div = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
    return (2.0 * torch.einsum("...icd,...jcd->...ij", eps, eps)
            + 2.0 * div[..., :, None] * div[..., None, :])


def phase_k8():
    """Phase 30: K8 at the cube and elasticity cells' shapes against the
    stock path, its bound and its time."""
    import torch

    import pytorch_fem_solver_tpu_torch as pt
    from fem_bench.meshes.kuhn_cube import kuhn_cube
    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        _scatter_drop,
        bsr_add_pairs_symmetric,
        bsr_complete_symmetric,
        default_max_b,
        get_bsr_structure,
        inverse_inner_perm,
    )

    eps32 = float(np.finfo(np.float32).eps)
    vertices, tets = kuhn_cube(K8_CUBE_N)
    mesh = pt.MeshTet({"vertices": vertices, "tetrahedra": tets}, device=DEVICE,
                      dtype=torch.float32)
    scale = torch.exp(torch.randn(tets.shape[0], generator=torch.Generator().manual_seed(8),
                                  dtype=torch.float64)).to(DEVICE, torch.float32)
    shapes = []
    for cell, V, form in (
        ("cube64_elast_p1", pt.VectorBasis(mesh, pt.ElementTet(1, 2)), _k8_lame),
        ("cube64_p1", pt.Basis(mesh, pt.ElementTet(1, 2)), lambda b: b.v_grad @ b.v_grad.mT),
    ):
        t0 = time.perf_counter()
        st = get_bsr_structure(V, max_b=default_max_b(V), want_entry_slot=False)
        tables_s = time.perf_counter() - t0
        local = V.integrate_bilinear_form_local(form) * scale[:, None, None]
        slots = st.entry_slot_sym
        T, n_loc = local.shape[0], local.shape[-1]
        kept = slots[slots < st.n_values].long()
        sink_share = 1.0 - kept.numel() / slots.numel()
        sectors = int(torch.unique(kept // 8).numel())  # 32-byte sectors of float32 values
        most = int(torch.bincount(kept).max())
        del kept
        local_sectors = T * _k8_triangle_sectors(n_loc)
        n_bytes = 32 * local_sectors + slots.numel() * slots.element_size() + 2 * 32 * sectors
        b_ms, by = bound_ms(n_bytes, 0)
        tag = f"K8 {cell} ({T}, {n_loc}, {n_loc})"
        log(f"{tag}: n_values {st.n_values}, {slots.numel()} pairs, sink share {sink_share:.6f}, "
            f"{_k8_triangle_sectors(n_loc)} of a matrix's {n_loc * n_loc // 8} sectors read, "
            f"{sectors} value sectors added into, at most {most} adds a slot, tables "
            f"{tables_s:.1f} s")
        ref = _k8_stock(local.new_zeros(st.n_values + 1, dtype=torch.float64), slots,
                        local.double())
        abs_sum = _k8_stock(torch.zeros_like(ref), slots, local.double().abs())
        cuda_build.reset_launch_counts()
        out = bsr_add_pairs_symmetric(st, None, slots, local)
        torch.cuda.synchronize()
        launches = cuda_build.launch_counts["pair_scatter"]
        check(launches == 1, f"{tag}: one launch ({launches})")
        check(float(out[st.n_values]) == 0.0, f"{tag}: the sink slot is 0")
        gap = (out[: st.n_values].double() - ref[: st.n_values]).abs()
        bound = most * eps32 * abs_sum[: st.n_values]
        worst = float((gap / bound.clamp_min(1e-300)).max())
        check(bool((gap <= bound).all()), f"{tag} float32 vs the stock path in float64: every "
              f"slot within m eps32 of its sum of absolute terms (worst {worst:.3e} of it)")
        del ref, abs_sum, gap, bound, out
        buf = local.new_zeros(st.n_values + 1)
        iu, ju = torch.triu_indices(n_loc, n_loc, device=DEVICE)
        pairs = (local[..., iu, ju] * torch.where(iu == ju, 0.5, 1.0)).reshape(-1)
        ms = time_ms(lambda: bsr_add_pairs_symmetric(st, buf, slots, local))
        stock_ms = time_ms(lambda: _k8_stock(buf, slots, local), reps=10)
        index_add_ms = time_ms(lambda: buf.index_add_(0, slots, pairs), reps=10)
        log(f"{tag} float32: {ms:.4f} ms (stock path {stock_ms:.4f} ms, index_add_ alone "
            f"{index_add_ms:.4f} ms, bound {b_ms:.4f} ms by {by}: {n_bytes / 1e6:.1f} MB)")
        # the rest of the scatter span: the zeroed buffer, the mirror completion and
        # the load's flat scatter into the padded vector (one value a local DOF)
        inv = inverse_inner_perm(st, int(V.n_dofs))
        lf = V._basis_parameters["linear_form_idx"][0]
        load_slots = torch.as_tensor(inv[V._as_host_index(lf)], device=DEVICE)
        load32 = torch.exp(torch.randn(load_slots.shape[0], generator=torch.Generator()
                                       .manual_seed(9))).to(DEVICE)
        load_ref = torch.zeros(st.n_pad + 1, dtype=torch.float64, device=DEVICE).index_add_(
            0, load_slots, load32.double())
        load_kept = load_slots[load_slots < st.n_pad]
        load_most = int(torch.bincount(load_kept).max())
        cuda_build.reset_launch_counts()
        load_out = _scatter_drop(load_slots, load32, st.n_pad)
        torch.cuda.synchronize()
        launches = cuda_build.launch_counts["flat_scatter"]
        check(launches == 1, f"{tag} load: one flat_scatter launch ({launches})")
        sink = torch.as_strided(load_out, (st.n_pad + 1,), (1,), load_out.storage_offset())
        check(float(sink[st.n_pad]) == 0.0, f"{tag} load: the sink slot is 0")
        gap = (load_out.double() - load_ref[: st.n_pad]).abs()
        bound = load_most * eps32 * load_ref[: st.n_pad]  # the loads are positive
        worst = float((gap / bound.clamp_min(1e-300)).max())
        check(bool((gap <= bound).all()), f"{tag} load float32 vs index_add_ in float64: every "
              f"slot within m eps32 of its sum (m {load_most}, worst {worst:.3e} of it)")
        del load_ref, load_kept, load_out, sink, gap, bound
        rest = {
            "zeros_ms": time_ms(lambda: local.new_zeros(st.n_values + 1), reps=10),
            "completion_ms": time_ms(lambda: bsr_complete_symmetric(st, buf[: st.n_values]),
                                     reps=10),
            "load_ms": time_ms(lambda: _scatter_drop(load_slots, load32, st.n_pad), reps=10),
            "load_index_add_ms": time_ms(
                lambda: load32.new_zeros(st.n_pad + 1).index_add_(0, load_slots, load32),
                reps=10),
        }
        log(f"{tag}: the rest of the scatter span, ms: " + ", ".join(
            f"{k.removesuffix('_ms')} {v:.4f}" for k, v in rest.items()))
        shapes.append({"cell": cell, "shape": [T, n_loc, n_loc], "n_values": st.n_values,
                       "pairs": slots.numel(), "sink_share": sink_share, "sectors": sectors,
                       "local_sectors": local_sectors, "load_values": load_slots.numel(),
                       "load_most_adds": load_most,
                       "most_adds": most, "ms": ms, "stock_ms": stock_ms,
                       "index_add_ms": index_add_ms, "bound_ms": b_ms, "bound_by": by,
                       "bytes": n_bytes, **rest})
        del buf, pairs, local, st, V, load_slots, load32
        torch.cuda.empty_cache()
    first = shapes[0]
    return {
        "name": "pair_scatter",
        "route": "cuda",
        "source": "pytorch_fem_solver_tpu_torch/csrc/pair_scatter.cu",
        "replaces": "none (ops/bsr.py:362 bsr_values_from_local_symmetric is .at[].add)",
        "max_abs_err": None,
        "ms": first["ms"],
        "plain_ms": first["index_add_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"],
        "library_ms": None,
        "shapes": shapes,
    }


def phase_windows():
    """Phase 12: what the timing window itself holds, per kernel; then the
    stream figures, which hold no event pair. Returns ``name -> stream us``."""
    windows["empty window"] = lambda: None
    order = ["K1", "K2", "K3", "K4", "K5", "K6", "torch.mv", "copy of K1's bytes",
             "empty window"]
    log("ms with the L2 flushed by a write (dirty lines) / by a read (clean lines): "
        + "; ".join(f"{name} {time_ms(windows[name]):.5f} / "
                    f"{time_ms(windows[name], flush='read'):.5f}" for name in order))
    figures = {}
    for name, (make_args, fn, n_bytes, keys) in streams.items():
        copies = -(-2 * L2_BYTES // n_bytes)
        figures[name], gap_us, events_us = stream_us(make_args, fn, copies, keys)
        log(f"stream figure {name}: {figures[name]:.3f} us per launch on the device (CUPTI, "
            f"median of {copies} back-to-back launches on {copies} sets of {n_bytes / 1e6:.2f} MB, "
            f"median gap {gap_us:.3f} us); {events_us:.3f} us between events over the run / {copies}")
    return figures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pytorch_fem_solver_tpu_torch as pt
    from pytorch_fem_solver_tpu_torch.bench import benchmark_basis
    from pytorch_fem_solver_tpu_torch.ops import cuda_build
    from pytorch_fem_solver_tpu_torch.ops.bsr import (
        bsr_values_from_local_symmetric,
        get_bsr_structure,
    )

    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    card = card_line()
    log(f"card: {card}")

    # phase 1: kernel build
    t0 = time.perf_counter()
    logs = cuda_build.build_all(force=True)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line):
                log(f"  {name}: {line.strip()}")

    # host tables, built once for every phase
    t0 = time.perf_counter()
    mesh64 = pt.build_benchmark_network(H, device="cuda", dtype=torch.float64)
    mesh32 = mesh64.to(dtype=torch.float32)
    V32 = benchmark_basis(mesh32)
    V64 = benchmark_basis(mesh64)
    st = get_bsr_structure(V32, max_b=8, want_entry_slot=False)
    # the structure is integer tables only, the same for both dtypes
    V64._bsr_structures = V32._bsr_structures
    log(
        f"mesh h={H}: cells={mesh64.n_cells} dofs={V32.n_dofs} n_pad={st.n_pad} "
        f"nb={st.nb} B={st.bcols.shape[1]} spill_rows={st.heavy_rows.shape[0]} "
        f"({time.perf_counter() - t0:.1f} s host)"
    )

    marks = [("build + tables", time.perf_counter())]

    def done(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    k1 = phase_k1(mesh64)
    done("2 K1")
    values64 = bsr_values_from_local_symmetric(
        st, V64.integrate_bilinear_form_local(lambda b: b.v_grad @ b.v_grad.mT)
    )
    k2 = phase_k2(st, values64)
    del values64
    phase_k2_structures()
    done("3 K2")
    solve32, x32, iters, iters64, launches, median = phase_main(st, V32, V64)
    done("4 main path")
    compiled_solve = phase_compiled(st, V32, x32)
    done("5 compiled")
    phase_profile(solve32, compiled_solve, median)
    done("6 profile")
    k3, k4 = phase_fused(st, V32, V64, x32, iters, iters64, card)
    done("7 fused tail")
    k5 = phase_k5(mesh64)
    done("8 K5")
    rvpinn_launches = phase_rvpinn(card)
    done("9 RVPINN")
    phase_two_fracture()
    done("10 two-fracture")
    k6 = phase_k6(st)
    done("11 K6")
    stream = phase_windows()
    done("12 windows")
    dfn_launches = phase_dfn_rvpinn(card)
    done("13 DFN RVPINN")
    posteriori_launches = phase_posteriori(card)
    done("14 estimator RVPINN")
    adaptive_k2 = phase_adaptive(card, mesh32, mesh64)
    done("15 adaptive DFN")
    p3_k2, dfn_p2_k2 = phase_higher_order(card)
    done("16 higher order")
    patch_launches = phase_patches(card)
    done("17 patch RVPINN")
    tet_p1_k2, tet_p2_k2, fichera_k2 = phase_tets(card)
    done("18 tets")
    phase_vpinn_3d(card)
    done("19 3D RVPINN")
    chunked_k2 = phase_chunked(card)
    done("20 chunked tets")
    elast2_k2, elast3_k2 = phase_elasticity(card)
    done("21 elasticity")
    newton_dfn_k2, newton_elast_k2, newton_ref = phase_newton(card, mesh32, mesh64)
    done("22 Newton")
    refined_dfn_k2, refined_elast_k2 = phase_refined(card, mesh64)
    done("23 refined")
    eig_lobpcg_k2, eig_subspace_k2, eig_dfn_k2, eig_elast_k2, eigsh_ref = phase_eigsh(
        card, mesh32, mesh64)
    done("24 eigen")
    stokes_k2, stokes_ref = phase_stokes(card)
    done("25 Stokes")
    bf16_record, precond_k2 = phase_precond(card, st, V32, V64)
    done("26 preconditioners")
    sharded_k2, row_slice = phase_sharded(card, V32, V64)
    done("27 sharded")
    sharded_solvers_k2 = phase_sharded_solvers(card, V32, newton_ref, eigsh_ref, stokes_ref)
    del newton_ref, eigsh_ref, stokes_ref
    done("28 sharded solvers")
    k7 = phase_k7()
    done("29 K7")
    k8 = phase_k8()
    done("30 K8")
    log("seconds by phase: " + "; ".join(
        f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1) in zip(marks, marks[1:])
    ) + f"; start to tables {marks[0][1] - t_start:.1f}; total {time.perf_counter() - t_start:.1f}")

    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    # each kernel's count on its own path, read just after it ran: K2 and
    # K7 on the main path's solve, K5 in the RVPINN setup; the counts of every
    # path that launches them beside it
    k1["launches"] = launches["p1_element_3d"]
    k2["launches"] = launches["bsr_spmv"]
    k7["launches"] = launches["small_inv"]
    k2["launches_by_path"] = {"main": launches["bsr_spmv"], "dfn_rvpinn": dfn_launches["bsr_spmv"],
                              "adaptive_dfn": adaptive_k2, "p3": p3_k2, "dfn_p2": dfn_p2_k2,
                              "tet_p1": tet_p1_k2, "tet_p2": tet_p2_k2, "fichera": fichera_k2,
                              "tet_chunked": chunked_k2, "elasticity_2d": elast2_k2,
                              "elasticity_3d": elast3_k2, "newton_dfn": newton_dfn_k2,
                              "newton_elasticity": newton_elast_k2,
                              "refined_dfn": refined_dfn_k2,
                              "refined_elasticity": refined_elast_k2,
                              "eigsh_square_lobpcg": eig_lobpcg_k2,
                              "eigsh_square_subspace": eig_subspace_k2,
                              "eigsh_dfn": eig_dfn_k2, "eigsh_elasticity": eig_elast_k2,
                              "stokes_base": stokes_k2["base"],
                              "stokes_aggcomp": stokes_k2["aggcomp_floor3max1"],
                              "stokes_scalar": stokes_k2["scalar"],
                              "stokes_minres": stokes_k2["minres"], **precond_k2,
                              "sharded_bsr": sharded_k2, **sharded_solvers_k2}
    k2["bf16_values"] = bf16_record
    k2["row_slice"] = row_slice
    k5["launches"] = rvpinn_launches["p1_element_2d"]
    k5["launches_by_path"] = {"rvpinn": rvpinn_launches["p1_element_2d"],
                              "posteriori_rvpinn": posteriori_launches["p1_element_2d"],
                              "patches": patch_launches["p1_element_2d"]}
    log(f"K2 launches by path: {k2['launches_by_path']}; K5: {k5['launches_by_path']}")
    for fig, name in zip((k1, k2, k3, k4, k5, k6), ("K1", "K2", "K3", "K4", "K5", "K6")):
        fig["stream_us"] = stream.get(name)  # None where no stream figure is taken
    log(f"main path median {median:.6f} s, {iters} iterations, on {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, k7, k8]}), flush=True)
    # the run uses one card, whatever the machine holds
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
