"""AMG hierarchy engine; importing registers the "AMG" solver."""

from amgx_tpu_torch.amg.hierarchy import (  # noqa: F401
    AMGLevel,
    AMGSolver,
    hierarchy_from_numpy,
)

__all__ = ["AMGSolver", "AMGLevel", "hierarchy_from_numpy"]
