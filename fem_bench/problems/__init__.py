"""Problems, one module per ``problem_kind`` of a configuration file: all
the harness knows of what a cell solves and how its answer is judged.

A module has

* ``COMPARED``: the names of the numbers ``compare`` returns; a cell's
  ``checks/<cell>.json`` gives each a limit;
* ``program(cell, inputs, specs, device, dtype) -> (basis, forms)``: the
  program's basis, built from the mesh input, and the forms the entry point
  takes (``a``, ``l``, and ``set(coefficient, load)``, which writes a
  request's field parameters, or None, in place);
* ``answer(cell, basis, u) -> np.ndarray``: a request's answer as it is
  compared, of any trailing shape;
* ``control_for(cell) -> str``: the control of the cell's precision, for
  ``compare``;
* ``compare(cell, inputs, specs, answers, seed, device, control=None) ->
  (numbers, work)``: the numbers of ``COMPARED`` for the answers
  ``[(index, answer)]``, judged by the problem's plain reference, and a
  function returning the work that the rooflines read (``nnz`` and ``rows``
  of the operator that the SpMV applies); with ``control``, the answers are
  the reference's own in that lower precision, computed in the program's
  place.

A configuration without ``problem_kind`` is ``DEFAULT``.
"""

from __future__ import annotations

import importlib

DEFAULT = "poisson_p1"


def of(config: dict):
    """The problem module of a configuration."""
    return importlib.import_module(f"fem_bench.problems.{config.get('problem_kind', DEFAULT)}")
