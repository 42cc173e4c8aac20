"""Solver algorithms and the name -> class registry.

Importing this package registers the ported solvers: PCG, CG, PCGF,
PBICGSTAB, BICGSTAB, FGMRES, GMRES, IDR, IDRMSYNC, SSTEP_PCG,
BLOCK_JACOBI, JACOBI_L1, CF_JACOBI, MULTICOLOR_DILU, MULTICOLOR_ILU,
MULTICOLOR_GS, GS, FIXCOLOR_GS, KACZMARZ, CHEBYSHEV, CHEBYSHEV_POLY,
POLYNOMIAL, KPZ_POLYNOMIAL, OPT_POLYNOMIAL, DENSE_LU_SOLVER (and its
alias DENSE_LU), INEXACT, NOSOLVER, ITERATIVE_REFINEMENT and AMG: every
name the JAX package registers.
"""

from amgx_tpu_torch.solvers.base import Solver, SolveResult
from amgx_tpu_torch.solvers.registry import (
    SolverRegistry,
    create_solver,
    register_solver,
)

# registration side effects
from amgx_tpu_torch.solvers import (  # noqa: F401,E402
    cf_jacobi,
    chebyshev,
    dense_lu,
    dilu,
    dummy,
    gmres,
    gs,
    idr,
    inexact,
    jacobi,
    kaczmarz,
    krylov,
    polynomial,
    refinement,
    sstep,
)
from amgx_tpu_torch.amg import hierarchy  # noqa: F401,E402

__all__ = [
    "SolverRegistry",
    "register_solver",
    "create_solver",
    "Solver",
    "SolveResult",
]
