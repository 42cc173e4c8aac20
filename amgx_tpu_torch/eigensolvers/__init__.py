"""Eigensolvers (reference src/eigensolvers/; the JAX package's
``eigensolvers/``).

Registered when ``amgx_tpu_torch`` is imported: POWER_ITERATION,
SINGLE_ITERATION, INVERSE_ITERATION, PAGERANK, SUBSPACE_ITERATION,
LANCZOS, ARNOLDI, LOBPCG, JACOBI_DAVIDSON.
"""

from amgx_tpu_torch.eigensolvers.base import (
    EigenResult,
    EigenSolver,
    EigenSolverRegistry,
    create_eigensolver,
)
from amgx_tpu_torch.eigensolvers import algorithms  # noqa: F401
from amgx_tpu_torch.eigensolvers import jacobi_davidson  # noqa: F401

__all__ = [
    "EigenResult",
    "EigenSolver",
    "EigenSolverRegistry",
    "create_eigensolver",
]
