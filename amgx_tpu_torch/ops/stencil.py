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
    (f32, f64, bf16, c64 and c128 coefficients with x of their dtype,
    and the mixed modes' f32 with f64 x, bf16 with f32 x and c64 with
    c128 x; the TPU gates ``_MIN_ROWS`` and ``_HALO_MAX`` are not
    carried over), with the geometry :func:`stencil_launch_plan`
    gives;
  * ``kind == "axis"`` takes the plain version's stock torch ops on
    any device, as the JAX package sends it to XLA (its Pallas kernel
    computes only the constant case).

y has the promoted dtype of the coefficients and x; in bf16 every
product and sum rounds to bf16, in the plain version and the kernel
alike, as in ``ops/dia.py``, so the bitwise contract holds in bf16 too,
and in the mixed pairs, whose kernels round each product and each sum
in the wider type as torch's promotion does.  The complex kernels sum
with the DIA kernel's complex rule (``csrc/dtypes.cuh``), so the two
kernels agree bit for bit; torch's complex product may contract to an
FMA, so the plain versions agree with them within a tolerance.

``launches`` counts kernel launches (never plain-version calls) and
``variant_launches`` the same per entry point; reset them by assigning
0 and an empty dict.

:func:`fused_cycle_leg` runs a descent leg (smooth, residual,
restrict) as one counted operator pass.  In eager PyTorch it issues
exactly the launches of the unfused leg: what it changes is the pass
count ``cycle_passes_per_iteration`` reports, 2(L-1)+1 per V-cycle in
place of 3(L-1)+1.  A kernel that fuses the leg is not written yet.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from amgx_tpu_torch.ops import kernels

launches = 0
variant_launches: dict = {}
# the kernel takes the steps of at most this many diagonals by value;
# detection yields at most 27 (a 3x3x3 box)
MAX_DIAGS = 27
# threads per block (the kernels' __launch_bounds__), the tile kernel's
# largest tile (x by y) and the largest y and z grid dimensions CUDA
# launches
PLAN_THREADS = 256
TILE = (32, 8)
_MAX_GRID_YZ = 65535
# the stencils the tile kernel takes, steps in offsets order ((dz, dy,
# dx) lexicographic): the 7-point star (nd_inst 7) and any other subset
# of the 3x3x3 box in the box's order with a z step (nd_inst 27); any
# other stencil takes the runtime-count kernel (nd_inst 0)
_STAR = ((0, 0, -1), (0, -1, 0), (-1, 0, 0), (0, 0, 0), (1, 0, 0),
         (0, 1, 0), (0, 0, 1))
# blocks of PLAN_THREADS the plan aims at per SM, by kernel: the tile
# kernels run best with two long blocks per SM, which re-read fewer z
# halo planes than more, shorter ones; the runtime-count kernel, one
# __ldg chain per point, with the most its 64 registers a thread leave
# room for (ci/torch_stencil_geometry.py times the alternatives); and
# the SMs of an H100 SXM (the wrapper reads the card's)
BLOCKS_PER_SM = {7: 2, 27: 2, 0: 4}
H100_SMS = 132


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
    read from (-1: zero, no entry); the matrix keeps it beside the
    coefficients (``mf_src``) so that ``replace_values`` re-reads them
    from new values by a gather."""
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
    dt = torch.promote_types(coefs.dtype, x.dtype)
    x3 = x.reshape(nz, ny, nx).to(dt)
    xp = F.pad(x3, (pxl, pxh, pyl, pyh, pzl, pzh))
    y = torch.zeros_like(x3)
    for k, (dx, dy, dz) in enumerate(meta.steps):
        s = xp[pzl + dz:pzl + dz + nz, pyl + dy:pyl + dy + ny,
               pxl + dx:pxl + dx + nx]
        c = coefs[k].to(dt)
        if meta.kind == "axis":
            # broadcast the per-coordinate coefficient along the row's
            # position on the varying axis (x is the last dim of x3)
            shape = [1, 1, 1]
            shape[2 - meta.axis] = c.shape[-1]
            c = c.reshape(shape)
        y = y + c * s
    return y.reshape(x.shape)


class StencilPlan(NamedTuple):
    """Launch geometry of the stencil kernel.

    The kernel runs on ``grid`` (nx, ny, nz) with ``steps``: the
    stencil's own, or for a grid of one plane (nz == 1) the same rows
    with y walked as z, i.e. grid (nx, 1, ny) and (dx, 0, dy) steps,
    which keep every flat offset, so that each thread walks rows.
    ``blocks`` (gx, gy, gz) of ``threads`` (bx, by): thread (tx, ty) of
    block (kx, ky, kz) computes the rows at ix = (kx*bx + tx)*vec + j
    for j < vec and iy = ky*by + ty (none when ix >= nx or iy >= ny),
    for iz in [kz*zchunk, min((kz+1)*zchunk, nz)).  ``nd_inst`` names
    the kernel: 7 (the star, its steps compiled in) or 27 (any subset
    of the 3x3x3 box with a z step, which diagonals are present read at
    run time) on the tile kernel; 0 the kernel for any stencil, its
    count read at run time."""

    grid: Tuple[int, int, int]
    steps: Tuple[Tuple[int, int, int], ...]
    blocks: Tuple[int, int, int]
    threads: Tuple[int, int]
    zchunk: int
    nd_inst: int
    vec: int


def stencil_launch_plan(grid, steps, vec=1, sms=H100_SMS):
    """The kernels' :class:`StencilPlan` for the stencil of ``steps``
    ((dx, dy, dz) per diagonal, in offsets order) on ``grid``
    (nx, ny, nz).

    The star, and every other stencil with a z step whose steps are
    diagonals of the 3x3x3 box in the box's order, take the tile
    kernel; any other stencil the runtime-count kernel, a 2D one walking
    its grid along y (:class:`StencilPlan`).  For the star each thread
    computes ``vec`` consecutive x points (one 16-byte vector: 4 in f32,
    2 in f64, for x and y on 16-byte boundaries) when nx is a multiple
    of ``vec``, else one; every other stencil one (``vec`` is 16 bytes
    over the dtype's size: 4 in f32, 2 in f64, 8 in bf16).  A block spans up to 32 threads along
    x (one coalesced warp row; PLAN_THREADS on the runtime-count kernel
    where the grid is one row wide) and as many y rows as the kernel
    takes (8 on the tile kernel, PLAN_THREADS in all on the other); each
    thread walks ``zchunk`` planes, the fewest that keep the threads
    within the kernel's BLOCKS_PER_SM blocks of PLAN_THREADS on each of
    the card's ``sms`` SMs."""
    nx, ny, nz = (int(g) for g in grid)
    steps = tuple(tuple(int(d) for d in st) for st in steps)
    nd = len(steps)
    if min(nx, ny, nz) < 1 or not 1 <= nd <= MAX_DIAGS:
        raise ValueError(f"stencil_launch_plan: grid {grid}, {nd} diagonals")
    box = [9 * (dz + 1) + 3 * (dy + 1) + dx + 1 for dx, dy, dz in steps]
    in_box = (max(abs(d) for st in steps for d in st) <= 1
              and all(a < b for a, b in zip(box, box[1:]))
              and any(st[2] for st in steps))
    nd_inst = 7 if steps == _STAR else 27 if in_box else 0
    vec = vec if steps == _STAR and nx % vec == 0 else 1
    if nz == 1:  # every dz is 0: walk y as z
        ny, nz = 1, ny
        steps = tuple((dx, 0, dy) for dx, dy, _ in steps)
    bx = min(PLAN_THREADS if ny == 1 and not nd_inst else TILE[0],
             -(-nx // vec))
    by = min(ny, TILE[1] if nd_inst else PLAN_THREADS // bx)
    gx, gy = -(-nx // (bx * vec)), -(-ny // by)
    if gy > _MAX_GRID_YZ:
        raise ValueError(f"stencil_launch_plan: grid {grid} needs {gy} > "
                         f"{_MAX_GRID_YZ} blocks along y")
    resident = BLOCKS_PER_SM[nd_inst] * PLAN_THREADS * sms
    gz = min(nz, _MAX_GRID_YZ, max(1, resident // (gx * gy * bx * by)))
    zchunk = -(-nz // gz)
    return StencilPlan(
        grid=(nx, ny, nz), steps=steps, blocks=(gx, gy, -(-nz // zchunk)),
        threads=(bx, by), zchunk=zchunk, nd_inst=nd_inst, vec=vec,
    )


def pack_plan(plan: StencilPlan):
    """The launcher's host int array for ``plan``: nd, the grid, the
    geometry and the (dx, dy, dz) steps (``csrc/stencil_spmv.cu``)."""
    vals = (len(plan.steps), *plan.grid, *plan.blocks, *plan.threads,
            plan.zchunk, plan.nd_inst, plan.vec,
            *(s for st in plan.steps for s in st))
    return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=None)
def _launch_args(grid, steps, vec, device_index):
    """:func:`pack_plan` of :func:`stencil_launch_plan` for the card's
    SMs, and the array's address; the cache keeps the array alive."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    arr = pack_plan(stencil_launch_plan(grid, steps, vec, sms))
    return arr, ctypes.addressof(arr)


def stencil_spmv(A, x):
    """y = A @ x for a MATRIX_FREE matrix ``A`` (``mf_meta``,
    ``mf_coefs``) and ``x`` (n,)."""
    global launches
    meta, coefs = A.mf_meta, A.mf_coefs
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
    if x.device.type != "cuda" or coefs.device != x.device:
        raise ValueError(
            "stencil_spmv: all tensors must be on one CUDA device"
        )
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"stencil_spmv: tensors on {x.device} but the current device "
            f"is cuda:{torch.cuda.current_device()}"
        )
    entry = kernels.entry_point("stencil_spmv", coefs.dtype, x.dtype)
    if entry is None:
        raise NotImplementedError(
            f"stencil_spmv: dtypes {coefs.dtype}/{x.dtype}; the kernel "
            "takes float32, float64, bfloat16, complex64 or complex128 "
            "coefficients with x of their dtype, bfloat16 with float32 x, "
            "float32 with float64 x, or complex64 with complex128 x"
        )
    if nd > MAX_DIAGS:
        raise ValueError(
            f"stencil_spmv: {nd} diagonals; the kernel takes at most "
            f"{MAX_DIAGS}"
        )
    if not (coefs.is_contiguous() and x.is_contiguous()):
        raise ValueError("stencil_spmv: inputs must be contiguous")
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    # 16-byte vectors where x starts on a 16-byte boundary (y, just
    # allocated, does): 4 points in f32, 2 in f64 and c64, 1 in c128
    vec = 16 // x.element_size() if x.data_ptr() % 16 == 0 else 1
    _, args = _launch_args(meta.grid, meta.steps, vec, x.device.index)
    fn = getattr(kernels.library("stencil_spmv"), entry)
    rc = fn(coefs.data_ptr(), x.data_ptr(), y.data_ptr(), args,
            kernels.stream_handle(x.device))
    kernels.check_launch("stencil_spmv", rc)
    launches += 1
    variant_launches[entry] = variant_launches.get(entry, 0) + 1
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
