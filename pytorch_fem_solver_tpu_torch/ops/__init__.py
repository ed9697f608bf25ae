"""Device operators: element kernel, BSR assembly and SpMV, the aggregate
two-level preconditioner, PCG and the assemble+solve pipeline."""
