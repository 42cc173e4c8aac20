"""Factory registry (reference SolverFactory, solver.h:281-310).

Maps the solver names of config files to solver classes.  Every name
the JAX package registers is ported.
"""

from __future__ import annotations

from typing import Callable, Dict

from amgx_tpu_torch.core.printing import emit

_SOLVERS: Dict[str, Callable] = {}

# names the JAX package registers that the port lacks: none
UNPORTED = frozenset()


class SolverRegistry:
    @staticmethod
    def register(name: str, cls):
        _SOLVERS[name] = cls

    @staticmethod
    def get(name: str):
        cls = _SOLVERS.get(name)
        if cls is not None:
            return cls
        raise KeyError(
            f"unregistered solver {name!r}; known: {sorted(_SOLVERS)}"
        )


def register_solver(name: str):
    """Class decorator: @register_solver("PCG")."""

    def deco(cls):
        SolverRegistry.register(name, cls)
        cls.registry_name = name
        return cls

    return deco


def create_solver(cfg, scope: str = "default", param: str = "solver",
                  device="cuda"):
    """Allocate the solver named by ``param`` in ``scope`` on
    ``device`` (default the card)."""
    if param == "solver" and scope == "default" \
            and bool(cfg.get("print_config", scope)):
        lines = ["         AMG Configuration:"]
        for (sc, name_), v in sorted(cfg.items().items()):
            lines.append(f"           {sc}:{name_} = {v!r}")
        emit("\n".join(lines))
    name, new_scope = cfg.get_scoped(param, scope)
    cls = SolverRegistry.get(name)
    return cls(cfg, new_scope, device=device)


def make_nested(solver):
    """Mark a solver as nested (preconditioner / smoother / coarse
    solver): nested solvers never scale or reorder; only the outer
    solve() boundary may."""
    solver.scaling = "NONE"
    solver.reordering = "NONE"
    return solver
