"""amgx_tpu_torch — the PyTorch/CUDA port of amgx_tpu.

A second package beside the JAX one, for NVIDIA Hopper cards.  The same
AMGConfig JSON drives both, the same solver names resolve, and the
same statuses and iteration counts come out.  Plain tensor code is
PyTorch; the SpMV kernels the JAX package wrote in Pallas for the TPU
are hand-written CUDA kernels here (``csrc/``, built with ``nvcc`` at
first use).  This package imports nothing of JAX or of ``amgx_tpu``.

Entry points run on the card by default (``device="cuda"``) and raise
without one unless the caller passes ``device="cpu"``; on CPU tensors
every kernel wrapper takes its plain PyTorch version.
"""

from amgx_tpu_torch.config.amg_config import AMGConfig
from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.solvers import create_solver
from amgx_tpu_torch.eigensolvers import create_eigensolver


def initialize():
    """Register all solver and eigensolver factories (reference
    amgx::initialize).  Importing the package already registers them;
    kept so that code written for the JAX package runs unchanged."""
    import amgx_tpu_torch.eigensolvers  # noqa: F401
    import amgx_tpu_torch.solvers  # noqa: F401


__all__ = [
    "AMGConfig",
    "SparseMatrix",
    "create_eigensolver",
    "create_solver",
    "initialize",
]
