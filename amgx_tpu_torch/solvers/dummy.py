"""NOSOLVER (reference dummy_solver.cu; the JAX package's
``solvers/dummy.py``).

Outer solvers special-case the name: a Krylov solver with NOSOLVER as
preconditioner runs unpreconditioned (``solvers/krylov.py``) and an AMG
hierarchy with NOSOLVER as coarse solver smooths its coarsest level
(``amg/hierarchy.py``).  The class serves the places that build a
solver by name anyway, such as a NOSOLVER smoother.
"""

from __future__ import annotations

import torch

from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import register_solver


@register_solver("NOSOLVER")
class DummySolver(Solver):
    """Does nothing: a step leaves x as it is and the apply is the zero
    map (the reference zeroes x on a zero initial guess)."""

    def _setup_impl(self, A):
        self._params = A

    def make_step(self):
        return lambda params, b, x: x

    def make_apply(self):
        return lambda params, r: torch.zeros_like(r)

    def make_solve(self):
        def solve(params, b, x0):
            return self._fixed_result(x0, b, 0)

        return solve
