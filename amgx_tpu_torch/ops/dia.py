"""DIA SpMV: the CUDA kernel ``csrc/dia_spmv.cu`` and its plain version.

Counterpart of the JAX package's ``ops/pallas_dia.py`` (Pallas kernel)
and ``ops/spmv.py:_spmv_dia`` (its XLA version).  A CPU tensor takes
the plain version; a CUDA tensor takes the kernel or raises — there is
no fallback between the two.  The TPU gates (``_MIN_ROWS``,
``_HALO_MAX``) are not carried over: every f32, f64 and bf16 DIA
matrix on the card goes through the kernel.

Dtypes: y has JAX's promoted dtype of the planes and x
(``torch.promote_types``, which agrees with ``jnp.result_type`` on
these); the plain version computes in it with torch's own promotion,
one rounding per product and per sum, and bf16 in bf16 as the JAX
package's XLA path and its Pallas kernel do.  The kernel is built for
(f32, f32), (f64, f64) and (bf16, bf16), the pairs a hierarchy's DIA
operators meet (``csrc/dtypes.cuh``); another pair on the card raises.

``launches`` counts kernel launches (never plain-version calls) and
``variant_launches`` the same per entry point; reset them by assigning
0 and an empty dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from amgx_tpu_torch.ops import kernels

launches = 0
variant_launches: dict = {}


def dia_spmv_plain(dia_vals, offsets, x):
    """y_i = sum_k dia_vals[k, i] * x[i + offsets[k]], shift+FMA over a
    zero-padded x in offset order from +0.0 (the JAX package's
    ``_spmv_dia``).  ``offsets`` is a sequence of ints."""
    offs = tuple(int(o) for o in offsets)
    n = dia_vals.shape[1]
    pneg = max(0, -min(offs))
    ppos = max(0, max(offs))
    xpad = F.pad(x, (pneg, ppos))
    y = torch.zeros(n, dtype=torch.promote_types(dia_vals.dtype, x.dtype),
                    device=x.device)
    for k, off in enumerate(offs):
        y = y + dia_vals[k] * xpad[off + pneg:off + pneg + n]
    return y


def dia_spmv(dia_vals, offsets, x):
    """y = A @ x for a square DIA matrix.

    ``dia_vals`` (nd, n), ``offsets`` an int32 tensor of nd sorted
    offsets on the same device, ``x`` (n,)."""
    global launches
    if x.device.type == "cpu":
        return dia_spmv_plain(dia_vals, offsets.tolist(), x)
    nd, n = dia_vals.shape if dia_vals.dim() == 2 else (None, None)
    if nd is None or x.shape != (n,):
        raise ValueError(
            f"dia_spmv: dia_vals {tuple(dia_vals.shape)} and x "
            f"{tuple(x.shape)} do not form a square DIA product"
        )
    if x.device.type != "cuda" or any(
        t.device != x.device for t in (dia_vals, offsets)
    ):
        raise ValueError("dia_spmv: all tensors must be on one CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"dia_spmv: tensors on {x.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    entry = kernels.entry_point("dia_spmv", dia_vals.dtype, x.dtype)
    if entry is None:
        raise NotImplementedError(
            f"dia_spmv: dtypes {dia_vals.dtype}/{x.dtype}; the kernel "
            "takes float32, float64 or bfloat16 planes with x of their "
            "dtype"
        )
    if offsets.dtype != torch.int32 or offsets.shape != (nd,):
        raise ValueError(
            f"dia_spmv: offsets must be int32 of shape ({nd},), got "
            f"{offsets.dtype} {tuple(offsets.shape)}"
        )
    if not (dia_vals.is_contiguous() and x.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("dia_spmv: inputs must be contiguous")
    y = torch.empty(n, dtype=torch.promote_types(dia_vals.dtype, x.dtype),
                    device=x.device)
    if n == 0:
        return y
    fn = getattr(kernels.library("dia_spmv"), entry)
    rc = fn(dia_vals.data_ptr(), offsets.data_ptr(), nd, x.data_ptr(),
            y.data_ptr(), n, kernels.stream_handle(x.device))
    kernels.check_launch("dia_spmv", rc)
    launches += 1
    variant_launches[entry] = variant_launches.get(entry, 0) + 1
    return y
