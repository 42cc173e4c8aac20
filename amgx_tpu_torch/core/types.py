"""Enums the solve path reads (reference include/types.h:16)."""

from __future__ import annotations

import enum

import numpy as np
import torch


class NormType(enum.Enum):
    """Vector norm types (reference include/types.h:16)."""

    L1 = "L1"
    L1_SCALED = "L1_SCALED"
    L2 = "L2"
    LMAX = "LMAX"


# dtype spellings the port takes (numpy dtypes, their names, torch
# dtypes); numpy has no bfloat16, so "bfloat16" names torch's
_NAMED = {
    "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float64": torch.float64, "complex64": torch.complex64,
    "complex128": torch.complex128,
}


def torch_dtype(spec) -> torch.dtype:
    """The torch dtype of ``spec``: a torch dtype, a numpy dtype or
    type, or a name such as ``"bfloat16"``."""
    if isinstance(spec, torch.dtype):
        return spec
    name = spec if isinstance(spec, str) else np.dtype(spec).name
    name = name.replace("torch.", "")
    if name not in _NAMED:
        raise NotImplementedError(f"dtype {spec!r} is not supported by "
                                  "the PyTorch port")
    return _NAMED[name]


def host_dtype(dt: torch.dtype) -> np.dtype:
    """The numpy dtype a tensor of ``dt`` reads back to the host as:
    its own, float32 for bfloat16 (numpy has none; every bf16 value is
    an f32 value)."""
    if dt == torch.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(str(dt).replace("torch.", ""))


def host_array(t: torch.Tensor) -> np.ndarray:
    """``t`` read back to the host as numpy (bf16 as float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
