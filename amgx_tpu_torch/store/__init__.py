"""Setup-artifact store (the JAX package's ``store/``): a set-up
solver made durable, so that another process, of either package,
restores it without running setup.

  * :mod:`amgx_tpu_torch.store.serialize`: the versioned payload (one
    ``.npz`` with a JSON manifest, the JAX package's schema); the entry
    points are ``Solver.save_setup(path)`` and
    ``Solver.load_setup(path, device=...)``.
  * :mod:`amgx_tpu_torch.store.store`: :class:`ArtifactStore`, atomic,
    digest-checked and LRU under ``AMGX_TPU_STORE_MB``; a corrupt or
    stale entry is a miss.

  * :mod:`amgx_tpu_torch.store.warmboot`: the serve layer's hierarchy
    entries exported to a store and restored into a fresh service
    (``BatchedSolveService(store=...)``, ``warm_boot()``).
"""

from amgx_tpu_torch.store.serialize import (
    SCHEMA_VERSION,
    load_setup,
    save_setup,
)
from amgx_tpu_torch.store.store import ArtifactStore

__all__ = [
    "SCHEMA_VERSION",
    "ArtifactStore",
    "save_setup",
    "load_setup",
]
