"""Mesh inputs, one module per ``mesh.kind`` of a configuration file:
``inputs(spec, root)`` makes or loads the host arrays (NumPy) that both
sides receive; for the scalar P1 problem (``problems/poisson_p1.py``),
``port_basis(inputs, element, device, dtype)`` hands them to the program,
and ``port_vertex_dofs(basis)`` reads the program's degree of freedom at
each input vertex, to judge its answer there."""
