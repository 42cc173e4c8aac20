"""Batched solve execution for the serve layer (the JAX package's
``serve/batched.py``): a group's rebuilt params run through the masked
batched loop (``solvers/batched_loop.py``), each instance stopping at
its own convergence.

The params of a group come from the solver's batch rebuild
(``make_batch_params``): the template (structure, transfers, plans) is
an argument, so every entry of an equal template signature runs the
same built callable (``serve/cache.py``).
"""

from __future__ import annotations

from amgx_tpu_torch.solvers.batched_loop import make_masked_loop


def make_batched_solve(solver):
    """``fn(template, values_B, b_B, x0_B) -> BatchedSolveResult`` for
    groups of the solver's structure (values (B, nnz), b and x0 (B, n)
    tensors on the solver's device), or None when the solver has no
    batch rebuild or no iteration protocol."""
    bp = solver.make_batch_params()
    if bp is None:
        return None
    _, params_of = bp
    loop = make_masked_loop(solver)
    if loop is None:
        return None

    def solve(template, values_B, b_B, x0_B):
        return loop(params_of(template, values_B), b_B, x0_B)

    return solve
