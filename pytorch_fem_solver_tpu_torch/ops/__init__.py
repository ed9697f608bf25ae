"""Device operators: element kernels, BSR and ELL assembly and SpMV, the
aggregate-block and ELL two-level preconditioners, the Krylov solvers and
the assemble+solve pipeline."""
