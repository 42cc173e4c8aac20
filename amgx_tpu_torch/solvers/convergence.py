"""Convergence criteria (reference src/convergence/).

``check(nrm, nrm_ini, nrm_max) -> bool`` on host numpy arrays of the
residual's real dtype (the monitored loop reads each norm once to the
host).  Types: ABSOLUTE, RELATIVE_INI[_CORE], RELATIVE_MAX[_CORE],
COMBINED_REL_INI_ABS.  Block norms must converge in every component.
"""

from __future__ import annotations

import numpy as np


def make_convergence_check(conv: str, tolerance: float, alt_rel_tol: float):
    conv = conv.upper()

    if conv == "ABSOLUTE":
        def raw(nrm, nrm_ini, nrm_max):
            return np.all(nrm < tolerance)
    elif conv in ("RELATIVE_INI", "RELATIVE_INI_CORE"):
        def raw(nrm, nrm_ini, nrm_max):
            return np.all(nrm < tolerance * nrm_ini)
    elif conv in ("RELATIVE_MAX", "RELATIVE_MAX_CORE"):
        def raw(nrm, nrm_ini, nrm_max):
            return np.all(nrm < tolerance * nrm_max)
    elif conv == "COMBINED_REL_INI_ABS":
        def raw(nrm, nrm_ini, nrm_max):
            return np.all((nrm < tolerance) | (nrm < alt_rel_tol * nrm_ini))
    else:
        raise ValueError(f"unknown convergence criterion {conv!r}")

    # an exactly-zero residual is always converged
    def check(nrm, nrm_ini, nrm_max):
        return bool(raw(nrm, nrm_ini, nrm_max) or np.all(nrm == 0))

    return check
