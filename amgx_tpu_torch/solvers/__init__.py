"""Solver algorithms and the name -> class registry.

Importing this package registers the ported solvers: PCG, CG,
BLOCK_JACOBI, DENSE_LU_SOLVER (and its alias DENSE_LU), and AMG.
"""

from amgx_tpu_torch.solvers.base import Solver, SolveResult
from amgx_tpu_torch.solvers.registry import (
    SolverRegistry,
    create_solver,
    register_solver,
)

# registration side effects
from amgx_tpu_torch.solvers import dense_lu, jacobi, krylov  # noqa: F401,E402
from amgx_tpu_torch.amg import hierarchy  # noqa: F401,E402

__all__ = [
    "SolverRegistry",
    "register_solver",
    "create_solver",
    "Solver",
    "SolveResult",
]
