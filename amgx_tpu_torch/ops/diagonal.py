"""Diagonal helpers for smoothers (scalar matrices).

Zero-pivot policy, as in the JAX package: a zero diagonal entry gets
reciprocal 1.0 (the reference's zero_in_diagonal_handling behaviour).
"""

from __future__ import annotations

import numpy as np
import torch

from amgx_tpu_torch.core.types import host_array


def scalarized(A, solver_name: str):
    """The scalar operator of ``A``.  Scalar matrices pass through;
    block matrices are not ported yet."""
    if A.block_size == 1:
        return A
    raise NotImplementedError(
        f"{solver_name}: block matrices are not ported yet "
        "(ROADMAP.md, queue A4b: block matrices)"
    )


def reciprocal_np(d):
    """1 / d on the host, 1.0 where d == 0, in d's dtype."""
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0, 1.0 / d, 1.0)
    return inv.astype(d.dtype, copy=False)


def invert_diag(A):
    """1 / diag(A) on A's device, computed on the host at setup, in
    A's dtype: a bf16 diagonal is inverted in f32 and rounded once to
    bf16, the correctly rounded bf16 reciprocal, as the JAX package's
    numpy computes it."""
    d = host_array(A.diag)
    return torch.from_numpy(reciprocal_np(d)).to(device=A.device,
                                                 dtype=A.dtype)


def apply_dinv(dinv, r):
    """z = D^{-1} r."""
    return dinv * r
