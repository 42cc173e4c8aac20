"""Vector norms (reference src/norm.cu, types.h:16): L1, L1_SCALED,
L2, LMAX.  Return 0-dim tensors on the vector's device."""

from __future__ import annotations

import torch

from amgx_tpu_torch.core.types import NormType


def norm(x, norm_type: NormType = NormType.L2):
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
