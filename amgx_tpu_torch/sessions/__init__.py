"""Streaming solve sessions (the JAX package's ``amgx_tpu.sessions``):
a session registers a sparsity pattern once and then streams ``(values,
b)`` steps through the serve layer's values-only path, each warm-started
from the previous step's converged x; sessions of one pattern step in
lockstep as one batched group.

Entry points::

    from amgx_tpu_torch.serve import BatchedSolveService
    from amgx_tpu_torch.sessions import SessionManager

    svc = BatchedSolveService(config=cfg, device="cuda")
    mgr = SessionManager(svc)
    sessions = [mgr.open(A, session_id=f"s{i}") for i in range(B)]
    for k in range(steps):
        tickets = mgr.step_all([(s, values[k][i], b) for i, s in ...])
    x = tickets[0].result().x
"""

from amgx_tpu_torch.sessions.session import (
    SessionManager,
    SolveSession,
    StepTicket,
)

__all__ = [
    "SessionManager",
    "SolveSession",
    "StepTicket",
]
