"""(Block-)diagonal helpers for smoothers.

Zero-pivot policy, as in the JAX package: a zero diagonal entry gets
reciprocal 1.0 (the reference's zero_in_diagonal_handling behaviour);
an all-zero diagonal block, an exactly singular one and one whose
inverse is not finite get the identity.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from amgx_tpu_torch.core.types import host_array


def scalarized(A, solver_name: str):
    """The scalar operator of ``A``: scalar matrices pass through; a
    block matrix is expanded (block rows and columns unrolled) on the
    host through scipy, its explicit zeros dropped so that the
    operator and its colourings keep the true graph, and uploaded anew
    on ``A``'s device in ``A``'s dtype with the default formats (the
    JAX package's ``scalarized``).  Vectors are flat (n * b,) either
    way, so a caller sees no change."""
    if A.block_size == 1:
        return A
    from amgx_tpu_torch.core.matrix import SparseMatrix

    warnings.warn(
        f"{solver_name}: block_size {A.block_size} handled by scalar "
        "expansion (native block kernels TBD)"
    )
    sp = A.to_scipy()
    sp.eliminate_zeros()
    S = SparseMatrix.from_scipy(sp, device=A.device)
    return S if S.dtype == A.dtype else S.astype(A.dtype)


def reciprocal_np(d):
    """1 / d on the host, 1.0 where d == 0, in d's dtype."""
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0, 1.0 / d, 1.0)
    return inv.astype(d.dtype, copy=False)


def invert_block_np(d):
    """Inverses of the (n, b, b) blocks ``d`` on the host (float32 for
    dtypes under 32 bits, which LAPACK does not take), the identity for
    an all-zero block, an exactly singular one and a non-finite
    inverse (the JAX package's ``invert_diag`` for blocks)."""
    if d.dtype.itemsize < 4:
        d = d.astype(np.float32)
    b = d.shape[1]
    eye = np.eye(b, dtype=d.dtype)
    zero = ~d.reshape(d.shape[0], -1).any(axis=1)
    safe = d.copy()
    safe[zero] = eye
    try:
        inv = np.linalg.inv(safe)
    except np.linalg.LinAlgError:
        # some non-zero block is exactly singular: invert block by block
        inv = np.empty_like(safe)
        for i in range(safe.shape[0]):
            try:
                inv[i] = np.linalg.inv(safe[i])
            except np.linalg.LinAlgError:
                inv[i] = eye
    bad = ~np.all(np.isfinite(inv.reshape(inv.shape[0], -1)), axis=1)
    if bad.any():
        inv[bad] = eye
    return inv


def invert_diag(A):
    """The inverse of A's (block) diagonal on A's device, computed on
    the host at setup, in A's dtype: a bf16 diagonal is inverted in f32
    and rounded once to bf16, as the JAX package's numpy does; (n, b,
    b) inverted blocks for a block matrix (:func:`invert_block_np`)."""
    d = host_array(A.diag)
    inv = reciprocal_np(d) if A.block_size == 1 else invert_block_np(d)
    return torch.from_numpy(inv).to(device=A.device, dtype=A.dtype)


def invert_diag_batched(d):
    """1 / d on the device, 1 where d == 0, for the (B, n) diagonals of
    a batched view: :func:`reciprocal_np` of each instance, bit for
    bit (the batch rebuilds of the Jacobi-type smoothers)."""
    nz = d != 0
    one = torch.ones_like(d)
    return torch.where(nz, 1.0 / torch.where(nz, d, one), one)


def apply_dinv(dinv, r, block_size=1):
    """z = D^{-1} r for flat r (each block row times its inverted
    block for ``block_size`` > 1)."""
    if block_size == 1:
        return dinv * r
    z = torch.bmm(dinv, r.reshape(-1, block_size, 1))
    return z.reshape(-1)
