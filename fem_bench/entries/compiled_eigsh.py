"""``Basis.compiled_eigsh(a, m, **kwargs)`` once; a request is ``solve()``:
both forms' assembly with the request's fields, the preconditioner's
set-up and the eigensolver's rounds. It returns the pairs ``(values,
vectors)`` as the answer and the rounds as its iterations."""


def build(basis, forms, kwargs: dict):
    solve = basis.compiled_eigsh(forms.a, forms.m, **kwargs)

    def request():
        vals, vecs, (rounds, _, converged) = solve()
        return (vals, vecs), rounds, converged

    return request
