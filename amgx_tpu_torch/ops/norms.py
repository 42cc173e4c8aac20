"""Vector norms (reference src/norm.cu, types.h:16): L1, L1_SCALED,
L2, LMAX.  Return tensors on the vector's device: 0-dim from
:func:`norm` ((B, 1) for a batch of vectors (B, n)), (b,) per-component
norms from :func:`block_norm`."""

from __future__ import annotations

import torch

from amgx_tpu_torch.core.types import NormType
from amgx_tpu_torch.ops.blas import record_reduction


def norm(x, norm_type: NormType = NormType.L2):
    """The norm of x (0-dim), or of each row of a batch x (B, n): (B,
    1), reduced over the row."""
    record_reduction()
    if x.dim() == 2:
        return _batched_norm(x, norm_type)
    a = torch.abs(x)
    if norm_type == NormType.L1:
        return torch.sum(a)
    if norm_type == NormType.L1_SCALED:
        return torch.sum(a) / x.shape[0]
    if norm_type == NormType.L2:
        return torch.sqrt(torch.sum(a * a))
    if norm_type == NormType.LMAX:
        return torch.max(a)
    raise ValueError(f"unknown norm {norm_type}")


def _batched_norm(x, norm_type):
    a = torch.abs(x)
    if norm_type == NormType.L1:
        return torch.sum(a, dim=-1, keepdim=True)
    if norm_type == NormType.L1_SCALED:
        return torch.sum(a, dim=-1, keepdim=True) / x.shape[-1]
    if norm_type == NormType.L2:
        return torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
    if norm_type == NormType.LMAX:
        return torch.amax(a, dim=-1, keepdim=True)
    raise ValueError(f"unknown norm {norm_type}")


def block_norm(x, block_size: int, norm_type: NormType = NormType.L2):
    """Per-block-component norms; x flat (n * b,) -> (b,)."""
    record_reduction()
    xb = torch.abs(x.reshape(-1, block_size))
    if norm_type == NormType.L1:
        return torch.sum(xb, dim=0)
    if norm_type == NormType.L1_SCALED:
        return torch.sum(xb, dim=0) / xb.shape[0]
    if norm_type == NormType.L2:
        return torch.sqrt(torch.sum(xb * xb, dim=0))
    if norm_type == NormType.LMAX:
        return torch.amax(xb, dim=0)
    raise ValueError(f"unknown norm {norm_type}")


def get_norm(A, r, norm_type: NormType = NormType.L2,
             use_scalar_norm=False):
    """Reference get_norm (norm.h): per-component norms of a block
    system unless ``use_scalar_norm`` (the registered default 0 gives
    them), the scalar norm otherwise."""
    if use_scalar_norm or A is None or A.block_size == 1:
        return norm(r, norm_type)
    return block_norm(r, A.block_size, norm_type)
