"""``Basis.compiled_refined(a, **kwargs)`` once, which assembles the
operator with the fields as they are at set-up; a request integrates its
load (``integrate_linear_form``) and runs ``solve(b)``: the float32 copy,
the preconditioner's set-up, the float32 PCG stages and the float64
residuals. Its iterations are the stages' sum."""


def build(basis, forms, kwargs: dict):
    solve = basis.compiled_refined(forms.a, **kwargs)

    def request():
        b = basis.integrate_linear_form(forms.l)
        u, info = solve(b)
        return u, sum(info.inner_iterations), info.converged

    return request
