"""MATRIX_FREE stencil operators: detection, the apply (the CUDA kernel
``csrc/stencil_spmv.cu`` and its plain version) and the fused cycle leg.

Counterpart of the JAX package's ``ops/stencil.py`` and
``ops/pallas_stencil.py``, as ``ops/dia.py`` is for DIA.  Detection is
a copy of the JAX package's host code: a DIA matrix that is a constant
(one coefficient per diagonal) or axis-separable (coefficients varying
along one grid axis) stencil on the grid ``infer_grid`` finds keeps
``nd`` (or ``nd x L``) coefficients instead of its ``(nd, n)`` planes.

Bitwise contract (the JAX package's, kept here): detection verifies
the coefficients against the DIA planes byte for byte, and every apply
sums per diagonal in ``offsets`` order from +0.0 with the same
coefficient bits the planes held.  A masked neighbour contributes
``c * 0`` where DIA contributes ``0 * x``; both are +-0.0 and leave the
sum unchanged, so a MATRIX_FREE SpMV equals the DIA SpMV of the same
matrix bit for bit: the plain versions on the CPU (two roundings per
term in both), and the two CUDA kernels on the card (one FMA per term
in both).

Dispatch of :func:`stencil_spmv`, chosen by the static ``meta.kind``:

  * a CPU tensor takes the plain version;
  * ``kind == "const"`` on a CUDA tensor launches the kernel or raises
    (f32 and f64; the TPU gates ``_MIN_ROWS`` and ``_HALO_MAX`` are not
    carried over);
  * ``kind == "axis"`` takes the plain version's stock torch ops on
    any device, as the JAX package sends it to XLA (its Pallas kernel
    computes only the constant case).

``launches`` counts kernel launches (never plain-version calls); reset
it by assigning 0.

:func:`fused_cycle_leg` runs a descent leg (smooth, residual,
restrict) as one counted operator pass.  In eager PyTorch it issues
exactly the launches of the unfused leg: what it changes is the pass
count ``cycle_passes_per_iteration`` reports, 2(L-1)+1 per V-cycle in
place of 3(L-1)+1.  A kernel that fuses the leg is not written yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from amgx_tpu_torch.ops import kernels

launches = 0

_FN = {torch.float32: "stencil_spmv_f32", torch.float64: "stencil_spmv_f64"}
# the kernel stages the coefficients and steps of at most this many
# diagonals in shared memory; detection yields at most 27 (a 3x3x3 box)
MAX_DIAGS = 27


class StencilMeta(NamedTuple):
    """Static description of a detected stencil.

    kind:    "const" (one coefficient per diagonal) or "axis"
             (coefficients vary along ONE grid axis only)
    grid:    (nx, ny, nz) with nx*ny*nz == n_rows; flat index
             i = ix + nx*iy + nx*ny*iz (x fastest)
    steps:   per-diagonal (dx, dy, dz) grid steps
    offsets: per-diagonal flat offsets (the DIA offsets the format
             replaced, sorted)
    axis:    varying axis for kind == "axis" (0=x, 1=y, 2=z), else None
    """

    kind: str
    grid: Tuple[int, int, int]
    steps: Tuple[Tuple[int, int, int], ...]
    offsets: Tuple[int, ...]
    axis: Optional[int] = None


# ---------------------------------------------------------------------------
# host-side detection (copies of the JAX package's numpy code)


def _values_match(recon, ref, tol: float) -> bool:
    """tol == 0.0 compares bytes (rejects even a signed-zero or ulp
    difference); tol > 0 accepts |recon - ref| <= tol elementwise."""
    if tol == 0.0:
        return recon.tobytes() == ref.tobytes()
    d = np.abs(recon.astype(np.float64) - ref.astype(np.float64))
    return bool(np.all(d <= tol))


def decompose_offsets(offsets, grid):
    """Per-diagonal (dx, dy, dz) grid steps for flat ``offsets`` on
    ``grid``, or None when any offset does not decompose into in-range
    steps."""
    nx, ny, nz = grid
    steps = []
    for off in offsets:
        off = int(off)
        dz = int(np.rint(off / max(nx * ny, 1)))
        rem = off - dz * nx * ny
        dy = int(np.rint(rem / max(nx, 1)))
        dx = rem - dy * nx
        if (
            off != dx + nx * dy + nx * ny * dz
            or abs(dx) >= nx
            or abs(dy) >= ny
            or abs(dz) >= nz
        ):
            return None
        steps.append((dx, dy, dz))
    return tuple(steps)


def _step_masks(steps, grid, n):
    """(nd, n) bool: entry (k, i) true when row i's neighbour at
    steps[k] lies inside the grid; and the (ix, iy, iz) of each row."""
    nx, ny, nz = grid
    i = np.arange(n)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    masks = np.empty((len(steps), n), dtype=bool)
    for k, (dx, dy, dz) in enumerate(steps):
        masks[k] = (
            (ix + dx >= 0) & (ix + dx < nx)
            & (iy + dy >= 0) & (iy + dy < ny)
            & (iz + dz >= 0) & (iz + dz < nz)
        )
    return masks, (ix, iy, iz)


def detect_stencil_np(dia_offsets, dia_vals, dia_src, n, tol: float = 0.0):
    """Compress host DIA arrays into stencil state.

    Returns ``(StencilMeta, coefs, src)`` host arrays, or None when the
    matrix is not a verified constant or axis-separable stencil.
    ``src`` maps each coefficient to the CSR index of the entry it was
    read from (-1: zero, no entry)."""
    from amgx_tpu_torch.amg.aggregation import infer_grid

    grid = infer_grid(dia_offsets, n)
    if grid is None:
        return None
    steps = decompose_offsets(dia_offsets, grid)
    if steps is None:
        return None
    dia_vals = np.asarray(dia_vals)
    dia_src = np.asarray(dia_src)
    nd = len(steps)
    zero = dia_vals.dtype.type(0)
    masks, coords = _step_masks(steps, grid, n)

    # ---- constant stencil: one coefficient per diagonal -------------
    coefs = np.zeros(nd, dtype=dia_vals.dtype)
    src = np.full(nd, -1, dtype=np.int32)
    ok = True
    for k in range(nd):
        witness = masks[k] & (dia_src[k] >= 0)
        if witness.any():
            i0 = int(np.argmax(witness))
            coefs[k] = dia_vals[k][i0]
            src[k] = dia_src[k][i0]
        if not _values_match(
            np.where(masks[k], coefs[k], zero), dia_vals[k], tol
        ):
            ok = False
            break
    if ok:
        meta = StencilMeta(
            kind="const",
            grid=grid,
            steps=steps,
            offsets=tuple(int(o) for o in dia_offsets),
        )
        return meta, coefs, src

    # ---- axis-separable: coefficients vary along ONE axis -----------
    for axis in (0, 1, 2):
        L = grid[axis]
        if L <= 1:
            continue
        coord = coords[axis]
        coefs = np.zeros((nd, L), dtype=dia_vals.dtype)
        src = np.full((nd, L), -1, dtype=np.int32)
        ok = True
        for k in range(nd):
            witness = masks[k] & (dia_src[k] >= 0)
            widx = np.nonzero(witness)[0]
            first = np.full(L, n, dtype=np.int64)
            np.minimum.at(first, coord[widx], widx)
            have = first < n
            coefs[k][have] = dia_vals[k][first[have]]
            src[k][have] = dia_src[k][first[have]]
            if not _values_match(
                np.where(masks[k], coefs[k][coord], zero),
                dia_vals[k],
                tol,
            ):
                ok = False
                break
        if ok:
            meta = StencilMeta(
                kind="axis",
                grid=grid,
                steps=steps,
                offsets=tuple(int(o) for o in dia_offsets),
                axis=axis,
            )
            return meta, coefs, src
    return None


# ---------------------------------------------------------------------------
# apply


def _pad_widths(steps):
    """Per-axis (lo, hi) halo widths covering every stencil step."""
    out = []
    for a in range(3):
        out.append((
            max([0] + [-s[a] for s in steps]),
            max([0] + [s[a] for s in steps]),
        ))
    return out


def stencil_spmv_plain(meta: StencilMeta, coefs, x):
    """y = A @ x from stencil state: one shifted slice of a zero-padded
    3D view of x per diagonal, in ``offsets`` order from +0.0 (the JAX
    package's ``stencil_spmv_xla``).  Each term is a multiply then an
    add, as in ``dia_spmv_plain``, so the two agree bit for bit."""
    nx, ny, nz = meta.grid
    (pxl, pxh), (pyl, pyh), (pzl, pzh) = _pad_widths(meta.steps)
    x3 = x.reshape(nz, ny, nx)
    xp = F.pad(x3, (pxl, pxh, pyl, pyh, pzl, pzh))
    y = torch.zeros_like(x3)
    for k, (dx, dy, dz) in enumerate(meta.steps):
        s = xp[pzl + dz:pzl + dz + nz, pyl + dy:pyl + dy + ny,
               pxl + dx:pxl + dx + nx]
        c = coefs[k]
        if meta.kind == "axis":
            # broadcast the per-coordinate coefficient along the row's
            # position on the varying axis (x is the last dim of x3)
            shape = [1, 1, 1]
            shape[2 - meta.axis] = c.shape[-1]
            c = c.reshape(shape)
        y = y + c * s
    return y.reshape(x.shape)


def stencil_spmv(A, x):
    """y = A @ x for a MATRIX_FREE matrix ``A`` (``mf_meta``,
    ``mf_coefs``, ``mf_steps_dev``) and ``x`` (n,)."""
    global launches
    meta, coefs, steps = A.mf_meta, A.mf_coefs, A.mf_steps_dev
    if x.device.type == "cpu" or meta.kind == "axis":
        return stencil_spmv_plain(meta, coefs, x)
    nx, ny, nz = meta.grid
    n = nx * ny * nz
    nd = len(meta.steps)
    if x.shape != (n,) or coefs.shape != (nd,):
        raise ValueError(
            f"stencil_spmv: coefs {tuple(coefs.shape)} and x "
            f"{tuple(x.shape)} do not fit a {nd}-point stencil on grid "
            f"{meta.grid}"
        )
    if x.device.type != "cuda" or any(
        t.device != x.device for t in (coefs, steps)
    ):
        raise ValueError(
            "stencil_spmv: all tensors must be on one CUDA device"
        )
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"stencil_spmv: tensors on {x.device} but the current device "
            f"is cuda:{torch.cuda.current_device()}"
        )
    if coefs.dtype != x.dtype or x.dtype not in _FN:
        raise NotImplementedError(
            f"stencil_spmv: dtypes {coefs.dtype}/{x.dtype}; the kernel "
            "takes float32 or float64 (bf16: ROADMAP.md, queue A: block "
            "matrices and reduced precision)"
        )
    if steps.dtype != torch.int32 or steps.shape != (nd, 3):
        raise ValueError(
            f"stencil_spmv: steps must be int32 of shape ({nd}, 3), got "
            f"{steps.dtype} {tuple(steps.shape)}"
        )
    if nd > MAX_DIAGS:
        raise ValueError(
            f"stencil_spmv: {nd} diagonals; the kernel takes at most "
            f"{MAX_DIAGS}"
        )
    if not (coefs.is_contiguous() and x.is_contiguous()
            and steps.is_contiguous()):
        raise ValueError("stencil_spmv: inputs must be contiguous")
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    fn = getattr(kernels.library("stencil_spmv"), _FN[x.dtype])
    rc = fn(coefs.data_ptr(), steps.data_ptr(), nd, x.data_ptr(),
            y.data_ptr(), nx, ny, nz, kernels.stream_handle(x.device))
    kernels.check_launch("stencil_spmv", rc)
    launches += 1
    return y


# ---------------------------------------------------------------------------
# fused cycle leg


def fused_cycle_leg(A, R, smooth_fn, smp, b, x, pre):
    """Smoother -> residual -> restrict on a MATRIX_FREE level, counted
    as one operator pass.  Returns ``(x, r, bc)``, the same arithmetic
    as the unfused sequence, so the two agree bit for bit.  The nested
    counter swallows the passes of the leg's own SpMVs; one pass is
    then recorded on the enclosing counter."""
    from amgx_tpu_torch.ops.spmv import op_pass_counter, record_op_pass, spmv

    with op_pass_counter():
        if smooth_fn is not None and pre > 0:
            x = smooth_fn(smp, b, x, pre)
        r = b - spmv(A, x)
        bc = spmv(R, r)
    record_op_pass()
    return x, r, bc
