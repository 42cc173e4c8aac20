"""DIA SpMV: the CUDA kernel ``csrc/dia_spmv.cu``, its launch plan and
its plain version.

Counterpart of the JAX package's ``ops/pallas_dia.py`` (Pallas kernel)
and ``ops/spmv.py:_spmv_dia`` (its XLA version).  A CPU tensor takes
the plain version; a CUDA tensor takes the kernel or raises — there is
no fallback between the two.  The TPU gates (``_MIN_ROWS``,
``_HALO_MAX``) are not carried over: every f32, f64 and bf16 DIA
matrix on the card goes through the kernel.

The wrapper takes the offsets as host ints (``A.dia_offsets``) and
hands them to the kernel by value, in the packed
:func:`dia_launch_plan` (cached per shape), so that a launch reads
nothing back from the card and the kernel loads no offset.

Dtypes: y has JAX's promoted dtype of the planes and x
(``torch.promote_types``, which agrees with ``jnp.result_type`` on
these); the plain version computes in it with torch's own promotion,
one rounding per product and per sum, and bf16 in bf16 as the JAX
package's XLA path and its Pallas kernel do.  The kernel is built for
(f32, f32), (f64, f64) and (bf16, bf16), the pairs a hierarchy's DIA
operators meet, for (f32, f64) and (bf16, f32), the operators of the
C API's mixed modes (dDFI / dIFI, dFBI) under their wider vectors, and
for the complex modes' (c64, c64), (c128, c128) and (c64, c128) (dCCI,
dZZI, dZCI; ``csrc/dtypes.cuh``: one row a thread, each term's real
operations rounded one by one); another pair on the card raises.  The
complex plain versions use torch's complex product, which may contract
to an FMA: the kernel agrees with them within a tolerance.

``dia_spmv_batched`` is the serve layer's entry (B instances of one
structure, the batch a grid axis of the same kernel).

``launches`` counts kernel launches of ``dia_spmv`` (never
plain-version calls), ``batched_launches`` those of
``dia_spmv_batched``, and ``variant_launches`` both per entry point;
reset them by assigning 0 and an empty dict.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from amgx_tpu_torch.ops import kernels

launches = 0
batched_launches = 0
variant_launches: dict = {}
# the kernel takes at most this many offsets by value (the format's own
# limit, core/matrix.py _DIA_MAX_DIAGS)
MAX_DIAGS = 48
# threads per block (the kernel's __launch_bounds__) and the SMs of an
# H100 SXM (the wrapper reads the card's)
PLAN_THREADS = 256
H100_SMS = 132
# bytes of each plane a thread loads as one vector.  The kernel takes
# up to 16; 8 measured faster on the H100 (ci/torch_dia_compare.py
# --sweep, PERF.md): at 16 the bf16 kernel holds 96 registers a thread
# and two blocks an SM, at 8 it holds 63 and four, and hides more of
# the loads' latency
VEC_BYTES = 8


class DiaPlan(NamedTuple):
    """Launch geometry of the DIA kernel.

    Thread t of block b computes rows i0 .. i0 + vec - 1 with i0 =
    (b * threads + t) * vec (none where i0 >= n): ``vec`` rows, one
    vector of every plane.  ``nd_inst`` names the kernel: 7 has the
    diagonal count compiled in, 0 reads it at run time (up to
    MAX_DIAGS).  ``offsets`` go to the kernel by value."""

    n: int
    offsets: Tuple[int, ...]
    vec: int
    nd_inst: int
    threads: int
    blocks: int


def dia_launch_plan(n, offsets, dtype, sms=H100_SMS, align=16,
                    x_dtype=None):
    """The kernel's :class:`DiaPlan` for ``n`` rows, the sorted host
    ``offsets``, planes of ``dtype`` and x and y of ``x_dtype`` (default
    ``dtype``), on a card of ``sms`` SMs, for pointers aligned to
    ``align`` bytes.

    ``vec`` starts at one VEC_BYTES vector of every plane (4 rows in
    bf16, 2 in f32, 1 in f64), at most 16 bytes of the wider of the
    plane and x types (a mixed pair reads x one value a row and writes
    y as one vector of vec values): plane k starts k * n values in, so
    every plane is aligned where n is a multiple; else it is the largest
    power of two that divides n (and the pointers' alignment, which
    the wider type's vectors need).  Then it
    halves while the grid would give some SM no block, so that a small
    level keeps every SM loading.  The 7-diagonal operators take the
    kernel with that count compiled in; any other count up to MAX_DIAGS
    the runtime one."""
    n = int(n)
    offsets = tuple(int(o) for o in offsets)
    nd = len(offsets)
    if n < 1 or not 1 <= nd <= MAX_DIAGS:
        raise ValueError(f"dia_launch_plan: {n} rows, {nd} diagonals; the "
                         f"kernel takes 1 to {MAX_DIAGS}")
    if any(not -n < o < n for o in offsets):
        raise ValueError(f"dia_launch_plan: offsets {offsets} reach past "
                         f"{n} rows")
    size = torch.empty((), dtype=dtype).element_size()
    wide = max(size, torch.empty(
        (), dtype=dtype if x_dtype is None else x_dtype).element_size())
    vec = max(1, min(VEC_BYTES // size, 16 // wide))
    while vec > 1 and (n % vec or align % (vec * wide)):
        vec //= 2
    while vec > 1 and -(-n // (vec * PLAN_THREADS)) < sms:
        vec //= 2
    return DiaPlan(n=n, offsets=offsets, vec=vec,
                   nd_inst=7 if nd == 7 else 0, threads=PLAN_THREADS,
                   blocks=-(-n // (vec * PLAN_THREADS)))


def pack_plan(plan: DiaPlan):
    """The launcher's host int array for ``plan``: nd, nd_inst, vec,
    threads, blocks, then the offsets (``csrc/dia_spmv.cu``)."""
    vals = (len(plan.offsets), plan.nd_inst, plan.vec, plan.threads,
            plan.blocks, *plan.offsets)
    return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=None)
def _launch_args(n, offsets, dtype, x_dtype, align, device_index):
    """:func:`pack_plan` of :func:`dia_launch_plan` for the card's SMs,
    and the array's address; the cache keeps the array alive."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    arr = pack_plan(dia_launch_plan(n, offsets, dtype, sms, align, x_dtype))
    return arr, ctypes.addressof(arr)


def _host_offsets(offsets):
    """The offsets as a tuple of ints; a tensor off the CPU raises
    rather than being read back from the card."""
    if isinstance(offsets, torch.Tensor) and offsets.device.type != "cpu":
        raise ValueError(
            f"dia_spmv: offsets on {offsets.device}; pass the host ints "
            "(A.dia_offsets)"
        )
    return tuple(int(o) for o in offsets)


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

    ``dia_vals`` (nd, n), ``offsets`` its nd sorted offsets as host ints
    (``A.dia_offsets``; a CPU tensor is read, one on the card raises),
    ``x`` (n,)."""
    global launches
    nd, n = dia_vals.shape if dia_vals.dim() == 2 else (None, None)
    if nd is None or x.shape != (n,):
        raise ValueError(
            f"dia_spmv: dia_vals {tuple(dia_vals.shape)} and x "
            f"{tuple(x.shape)} do not form a square DIA product"
        )
    if len(offsets) != nd:
        raise ValueError(
            f"dia_spmv: {len(offsets)} offsets for {nd} diagonal planes"
        )
    if x.device.type == "cpu":
        return dia_spmv_plain(dia_vals, _host_offsets(offsets), x)
    if x.device.type != "cuda" or dia_vals.device != x.device:
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
            "takes float32, float64, bfloat16, complex64 or complex128 "
            "planes with x of their dtype, bfloat16 planes with float32 "
            "x, float32 planes with float64 x, or complex64 planes with "
            "complex128 x"
        )
    if not (dia_vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmv: inputs must be contiguous")
    offs = _host_offsets(offsets)
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    ptrs = dia_vals.data_ptr() | x.data_ptr() | y.data_ptr()
    _, args = _launch_args(n, offs, dia_vals.dtype, x.dtype,
                           min(16, ptrs & -ptrs), x.device.index)
    fn = getattr(kernels.library("dia_spmv"), entry)
    rc = fn(dia_vals.data_ptr(), x.data_ptr(), y.data_ptr(), n, args,
            kernels.stream_handle(x.device))
    kernels.check_launch("dia_spmv", rc)
    launches += 1
    variant_launches[entry] = variant_launches.get(entry, 0) + 1
    return y


def dia_spmv_batched_plain(dia_vals, offsets, x):
    """:func:`dia_spmv_plain` over a leading batch dimension: ``x`` (B,
    n), ``dia_vals`` (B, nd, n) or (nd, n) shared by every instance;
    each instance's row sums run in offset order from +0.0, as the
    unbatched version's."""
    offs = tuple(int(o) for o in offsets)
    n = dia_vals.shape[-1]
    pneg = max(0, -min(offs))
    ppos = max(0, max(offs))
    xpad = F.pad(x, (pneg, ppos))
    y = torch.zeros(x.shape[:-1] + (n,),
                    dtype=torch.promote_types(dia_vals.dtype, x.dtype),
                    device=x.device)
    for k, off in enumerate(offs):
        y = y + dia_vals[..., k, :] * xpad[..., off + pneg:off + pneg + n]
    return y


def dia_spmv_batched(dia_vals, offsets, x):
    """y = A_b @ x_b for B instances of one square DIA structure (the
    serve layer's groups): ``dia_vals`` (B, nd, n), or (nd, n) shared by
    every instance, ``offsets`` the nd sorted host ints, ``x`` (B, n).
    On the card the ``dia_spmv_batched`` kernel (f32, f64, c64, c128)
    with the unbatched launch plan, the batch a grid axis: each
    instance's y is :func:`dia_spmv`'s bit for bit.  Counted in
    ``batched_launches`` and ``variant_launches``."""
    global batched_launches
    if x.dim() != 2 or dia_vals.dim() not in (2, 3):
        raise ValueError(
            f"dia_spmv_batched: dia_vals {tuple(dia_vals.shape)}, x "
            f"{tuple(x.shape)}")
    B, n = x.shape
    shared = dia_vals.dim() == 2
    nd = dia_vals.shape[-2]
    if dia_vals.shape[-1] != n or (not shared and dia_vals.shape[0] != B):
        raise ValueError(
            f"dia_spmv_batched: dia_vals {tuple(dia_vals.shape)} and x "
            f"{tuple(x.shape)} do not form a batched square DIA product")
    if len(offsets) != nd:
        raise ValueError(
            f"dia_spmv_batched: {len(offsets)} offsets for {nd} planes")
    if x.device.type == "cpu":
        return dia_spmv_batched_plain(dia_vals, _host_offsets(offsets), x)
    if x.device.type != "cuda" or dia_vals.device != x.device:
        raise ValueError(
            "dia_spmv_batched: all tensors must be on one CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"dia_spmv_batched: tensors on {x.device} but the current "
            f"device is cuda:{torch.cuda.current_device()}")
    entry = (kernels.entry_point("dia_spmv_batched", dia_vals.dtype,
                                 x.dtype) if dia_vals.dtype == x.dtype
             else None)
    if entry is None:
        raise NotImplementedError(
            f"dia_spmv_batched: dtypes {dia_vals.dtype}/{x.dtype}; the "
            "kernel takes float32, float64, complex64 or complex128 "
            "planes with x of their dtype")
    if not (dia_vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmv_batched: inputs must be contiguous")
    if not 1 <= B <= 65535:
        raise ValueError(f"dia_spmv_batched: batch {B} outside 1..65535")
    offs = _host_offsets(offsets)
    y = torch.empty((B, n), dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    ptrs = dia_vals.data_ptr() | x.data_ptr() | y.data_ptr()
    _, args = _launch_args(n, offs, dia_vals.dtype, x.dtype,
                           min(16, ptrs & -ptrs), x.device.index)
    fn = getattr(kernels.library("dia_spmv"), entry)
    rc = fn(dia_vals.data_ptr(), x.data_ptr(), y.data_ptr(), n, B,
            int(shared), args, kernels.stream_handle(x.device))
    kernels.check_launch("dia_spmv_batched", rc)
    batched_launches += 1
    variant_launches[entry] = variant_launches.get(entry, 0) + 1
    return y
