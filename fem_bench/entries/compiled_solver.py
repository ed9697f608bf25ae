"""``Basis.compiled_solver(a, l, **kwargs)`` once; a request is ``solve()``:
the assembly with the request's fields, the preconditioner's set-up and
PCG."""


def build(basis, forms, kwargs: dict):
    solve = basis.compiled_solver(forms.a, forms.l, **kwargs)

    def request():
        u, info = solve()
        return u, info.iterations, info.converged

    return request
