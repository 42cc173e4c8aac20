"""The mode table and the enums the solve path reads (reference
include/types.h:16, amgx_config.h:103-121).

A mode (dDDI, dDFI, ...) names the vector and matrix dtypes of the C
API's handles, as in the JAX package's ``core/types.py``.  Its
memory-space letter chooses the device, as in AmgX: ``d`` the card
(``"cuda"``), ``h`` the CPU.  The JAX package ignores the letter; here
an ``h`` mode is the caller's explicit request for the CPU, and a ``d``
mode without a card raises (``api/capi.py``) rather than running on
the CPU.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class Mode:
    """Precision triple of a mode (reference TemplateConfig,
    basic_types.h:92-117) and the device its letter names."""

    name: str
    vec_dtype: torch.dtype
    mat_dtype: torch.dtype

    @property
    def is_complex(self) -> bool:
        return self.mat_dtype.is_complex

    @property
    def device(self) -> str:
        """``"cuda"`` for a ``d`` mode, ``"cpu"`` for an ``h`` one."""
        return "cuda" if self.name[0] == "d" else "cpu"

    @property
    def vec_np(self) -> np.dtype:
        """The numpy dtype of the mode's host vectors (never bf16)."""
        return host_dtype(self.vec_dtype)


_MODES = {
    name: Mode(name, vec, mat)
    for (name, vec, mat) in [
        ("dDDI", torch.float64, torch.float64),
        ("dDFI", torch.float64, torch.float32),
        ("dFFI", torch.float32, torch.float32),
        ("dIDI", torch.float64, torch.float64),
        ("dIFI", torch.float64, torch.float32),
        ("dZZI", torch.complex128, torch.complex128),
        ("dZCI", torch.complex128, torch.complex64),
        ("dCCI", torch.complex64, torch.complex64),
        # no reference analogue: bf16 matrix storage (the JAX package's)
        ("dFBI", torch.float32, torch.bfloat16),
    ]
}
for _name in list(_MODES):
    _MODES["h" + _name[1:]] = dataclasses.replace(
        _MODES[_name], name="h" + _name[1:])


def mode_from_name(name: str) -> Mode:
    try:
        return _MODES[name]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown mode {name!r}; known: {sorted(_MODES)}"
        ) from None


DEFAULT_MODE = _MODES["dFFI"]


def mode_itemsizes(name: str):
    """(matrix itemsize, vector itemsize) of a mode: bf16 is 2."""
    m = mode_from_name(name)
    return (torch.empty((), dtype=m.mat_dtype).element_size(),
            torch.empty((), dtype=m.vec_dtype).element_size())
