"""Solver algorithms and the name -> class registry.

Importing this package registers the ported solvers: PCG, CG, PCGF,
PBICGSTAB, BICGSTAB, FGMRES, GMRES, BLOCK_JACOBI, JACOBI_L1,
MULTICOLOR_DILU, MULTICOLOR_GS, GS, FIXCOLOR_GS, DENSE_LU_SOLVER (and
its alias DENSE_LU), and AMG.
"""

from amgx_tpu_torch.solvers.base import Solver, SolveResult
from amgx_tpu_torch.solvers.registry import (
    SolverRegistry,
    create_solver,
    register_solver,
)

# registration side effects
from amgx_tpu_torch.solvers import (  # noqa: F401,E402
    dense_lu,
    dilu,
    gmres,
    gs,
    jacobi,
    krylov,
)
from amgx_tpu_torch.amg import hierarchy  # noqa: F401,E402

__all__ = [
    "SolverRegistry",
    "register_solver",
    "create_solver",
    "Solver",
    "SolveResult",
]
