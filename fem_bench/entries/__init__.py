"""Entry points that a request drives, one module per ``entry`` of a
traffic file: ``build(basis, forms, kwargs)`` builds the program's solver
at set-up and returns ``request() -> (u, iterations, converged)``."""
