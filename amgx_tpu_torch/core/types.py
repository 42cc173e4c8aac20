"""Enums the solve path reads (reference include/types.h:16)."""

from __future__ import annotations

import enum


class NormType(enum.Enum):
    """Vector norm types (reference include/types.h:16)."""

    L1 = "L1"
    L1_SCALED = "L1_SCALED"
    L2 = "L2"
    LMAX = "LMAX"
