"""ELL SpMV: the CUDA kernel ``csrc/ell_spmv.cu`` and its plain version.

Counterpart of the JAX package's ``ops/pallas_well.py`` (windowed-ELL
Pallas kernel) and the XLA gather path in ``ops/spmv.py``.  The port
stores ELL slot-major, ``(w, n_rows)``; the TPU's 1024-row tiles, lane
interleave and column windows are not carried over.  A CPU tensor
takes the plain version; a CUDA tensor takes the kernel or raises.

``launches`` counts kernel launches (never plain-version calls); reset
it by assigning 0.
"""

from __future__ import annotations

import torch

from amgx_tpu_torch.ops import kernels

launches = 0

_FN = {torch.float32: "ell_spmv_f32", torch.float64: "ell_spmv_f64"}


def ell_spmv_plain(ell_cols, ell_vals, x):
    """y_i = sum_s ell_vals[s, i] * x[ell_cols[s, i]] in slot order from
    +0.0; square or rectangular."""
    w, n = ell_vals.shape
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    for s in range(w):
        y = y + ell_vals[s] * x[ell_cols[s]]
    return y


def ell_spmv(ell_cols, ell_vals, x):
    """y = A @ x for a slot-major ELL matrix: ``ell_cols`` int32 and
    ``ell_vals`` of shape (w, n_rows), ``x`` (n_cols,)."""
    global launches
    if x.device.type == "cpu":
        return ell_spmv_plain(ell_cols, ell_vals, x)
    if ell_vals.dim() != 2 or ell_cols.shape != ell_vals.shape \
            or x.dim() != 1:
        raise ValueError(
            f"ell_spmv: cols {tuple(ell_cols.shape)}, vals "
            f"{tuple(ell_vals.shape)}, x {tuple(x.shape)}"
        )
    w, n = ell_vals.shape
    if w > 0 and x.shape[0] == 0:
        raise ValueError("ell_spmv: stored entries but an empty x")
    if x.device.type != "cuda" or any(
        t.device != x.device for t in (ell_cols, ell_vals)
    ):
        raise ValueError("ell_spmv: all tensors must be on one CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"ell_spmv: tensors on {x.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    if ell_vals.dtype != x.dtype or x.dtype not in _FN:
        raise NotImplementedError(
            f"ell_spmv: dtypes {ell_vals.dtype}/{x.dtype}; the kernel "
            "takes float32 or float64"
        )
    if ell_cols.dtype != torch.int32:
        raise ValueError(f"ell_spmv: cols must be int32, got {ell_cols.dtype}")
    if not (ell_cols.is_contiguous() and ell_vals.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("ell_spmv: inputs must be contiguous")
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    fn = getattr(kernels.library("ell_spmv"), _FN[x.dtype])
    rc = fn(ell_cols.data_ptr(), ell_vals.data_ptr(), w, x.data_ptr(),
            y.data_ptr(), n, kernels.stream_handle(x.device))
    kernels.check_launch("ell_spmv", rc)
    launches += 1
    return y
