"""Smoke test of the PyTorch/CUDA port (``amgx_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):

1. Card and build: prints the card's ``nvidia-smi`` name and power
   limit, builds the hand-written kernels from ``amgx_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time and
   the ``ptxas`` register report.
2. Kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it (the 128^3 Poisson level 0 and
   the coarser levels of the bench hierarchy, the level-0 prolongation
   P and restriction R) and on edge cases.  One JSON line per case: max
   errors, kernel / plain / library (``torch.sparse`` CSR product, a
   yardstick the port never calls) times in ms from CUDA events (median
   of 25 launches, L2 flushed before each by a read of 128 MiB), the
   kernel's time with L2 left warm, its device time without the launch
   (profiler), and the roofline bound from this run's bytes and
   operations (counted from the operator's nonzeros, not from padded
   slots).  First, the floor of one event-bracketed launch (an
   empty kernel).  Each stencil case prints its launch plan, checks
   that the plan takes the kernel meant for the stencil (the star's,
   the box-subset one or the runtime-count one) and is held bit for bit
   against the DIA kernel on the same matrix, whose times are printed
   beside it with those of a copy of x (the bytes of the bound moved by
   the copy engine).  A line before the summary lists every device
   time the profiler did not record.
3. DIA slice: the bench solve (PCG + aggregation-AMG V-cycle, SIZE_8,
   BLOCK_JACOBI, DENSE_LU) on ``poisson_3d_7pt(128)`` in f32 through
   the port's entry points.  Kernel launch counts are zeroed just
   before setup and read just after the solve.  Checks status 0, the
   true residual (float64, scipy) and the launch counts; then repeats
   the solve through the port on the CPU (plain versions) and compares
   iterations and x.  Then 64^3 in f64 (iterations equal, x to rtol
   1e-9) and the 16^3 SIZE_2 ``entry()`` config.
4. MATRIX_FREE slice: the same bench solve with ``"matrix_free": 1``
   on a matrix uploaded with the MATRIX_FREE format, counts zeroed
   just before setup and read just after the solve.  Checks every level
   MATRIX_FREE, the launch counts (stencil kernel on every A-SpMV, no
   DIA launch), the fused pass count, and x bit for bit equal to the
   DIA slice's x on the card; then the CPU run, 64^3 f64 on both, and a
   trace of the warm solve.
5. FGMRES_AGGREGATION slice: AmgX's FGMRES + SIZE_2 aggregation AMG +
   MULTICOLOR_DILU config (``FGMRES_CFG``) on ``poisson_3d_7pt(128)``
   in f32, counts zeroed just before setup and read just after the
   solve.  Checks status 0, the true residual, every level DIA, and
   the ``dia_spmv`` and ``ell_spmv`` counts against the count derived
   from the hierarchy and the iterations; traces one warm solve (device
   ops per iteration, busy share, time in the SpMV kernels and in the
   colour stages' gathers, reductions and index copies); repeats it on
   the CPU (same colours per level, iterations within one, x to rtol
   1e-4); 64^3 f64 on both (iterations equal, x to rtol 1e-9); and a
   32^3 f32 matrix of every solver and smoother the slice ported, card
   against CPU (iterations within one).
6. PCG_CLASSICAL_V_JACOBI slice: AmgX's default-algorithm config
   (``PCG_CLASSICAL``: PCG + classical AMG, AHAT / PMIS / D1, BLOCK_JACOBI,
   DENSE_LU) on ``poisson_3d_7pt(128)`` in f32 with the classical setup
   on the card (``setup_location`` AUTO), counts zeroed just before
   setup and read just after the solve.  Per level rows, nnz, format
   and ELL widths; upload, setup (host / device split, scalar reads,
   peak device memory) and solve times; the true residual; no level
   handed to the host builder; the ``dia_spmv`` / ``ell_spmv`` launches
   and CSR products equal to the count derived from the hierarchy; the
   ELL kernel at the level-1 A and level-0 P and R shapes; a trace of a
   warm solve.  Then a second setup and solve (hierarchy and x bit for
   bit equal), the CPU port (host setup, iterations within one), the
   48^3 f64 hierarchy against the host builder (C/F splits, rows and
   nonzeros equal, P and R to 1e-12, the coarse operators to 1e-11),
   64^3 f64 against the CPU (iterations equal, x to rtol 1e-9), and,
   card against CPU, the D2 + aggressive + interp_max_elements 4 and
   MULTIPASS variants at 128^3, ENERGYMIN and RCM reordering (of a
   shuffled Poisson matrix) at 32^3.
7. Prints the per-kernel summary line, then the device line last.

Exits non-zero without a result when CUDA is unavailable.  Imports
nothing of JAX or of the JAX package ``amgx_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types
import warnings

import numpy as np

BENCH_CFG = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "PCG", "max_iters": 100, "tolerance": 1e-6,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 512, "max_levels": 20,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
    ' "monitor_residual": 0}}}'
)

ENTRY_CFG = (
    '{"config_version": 2,'
    ' "solver": {"scope": "main", "solver": "PCG", "max_iters": 20,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "tolerance": 1e-05, "norm": "L2",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_2",'
    ' "smoother": {"scope": "jac", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 32, "max_levels": 20,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
    ' "monitor_residual": 0}}}'
)

# the bench config with the MATRIX_FREE format and (by default) fused
# descent legs
MF_CFG = BENCH_CFG.replace('"cycle": "V",', '"cycle": "V", "matrix_free": 1,')
MF_FORMATS = ("matrix_free", "dia", "dense", "ell")

# AmgX's FGMRES_AGGREGATION config (tests/test_config.py's FGMRES_AGG)
# with "monitor_residual": 1, as AmgX ships it: FGMRES around an
# aggregation-AMG V-cycle, SIZE_2, MULTICOLOR_DILU post-smoothing
FGMRES_CFG = (
    '{"config_version": 2, "solver": {"preconditioner": {'
    ' "algorithm": "AGGREGATION", "solver": "AMG",'
    ' "smoother": "MULTICOLOR_DILU", "presweeps": 0, "selector": "SIZE_2",'
    ' "coarse_solver": "DENSE_LU_SOLVER", "max_iters": 1, "postsweeps": 3,'
    ' "min_coarse_rows": 32, "relaxation_factor": 0.75, "scope": "amg",'
    ' "max_levels": 50, "cycle": "V"}, "use_scalar_norm": 1,'
    ' "monitor_residual": 1, "solver": "FGMRES", "max_iters": 100,'
    ' "gmres_n_restart": 10, "convergence": "RELATIVE_INI", "scope": "main",'
    ' "tolerance": 1e-06, "norm": "L2"}}'
)

# AmgX's PCG_CLASSICAL_V_JACOBI.json.  It has no algorithm, selector,
# interpolator or coarse_solver key: classical AMG (AHAT strength, PMIS,
# D1), DENSE_LU below 128 rows and setup_location AUTO (the device
# pipeline on the card, the host builder on the CPU) apply
PCG_CLASSICAL = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
    ' "monitor_residual": 1, "norm": "L2",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG", "cycle": "V",'
    ' "max_iters": 1, "presweeps": 1, "postsweeps": 1, "max_levels": 100,'
    ' "monitor_residual": 0,'
    ' "smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}}}}'
)


def classical_cfg(amg_extra="", main_extra=""):
    """PCG_CLASSICAL with ``amg_extra`` keys in its AMG scope and
    ``main_extra`` in the outer one."""
    return PCG_CLASSICAL.replace(
        '"monitor_residual": 0,', f'"monitor_residual": 0{amg_extra},', 1
    ).replace('"norm": "L2",', f'"norm": "L2"{main_extra},', 1)


SLICE_N = 128

# Data-sheet peaks (NVIDIA, dense, without sparsity): memory bytes/s,
# float32 and float64 FLOP/s outside the tensor cores.  Matched on the
# card's name.
PEAKS = (
    ("H100 PCIe", {"bw": 2.0e12, "f32": 51.2e12, "f64": 25.6e12}),
    ("H100 NVL", {"bw": 3.9e12, "f32": 60.0e12, "f64": 30.0e12}),
    ("H100", {"bw": 3.35e12, "f32": 67.0e12, "f64": 34.0e12}),
)

# what the profiler names each kernel's launches
ACTIVITY = {"dia_spmv": "dia_spmv_kernel", "ell_spmv": "ell_spmv_kernel",
            "stencil_spmv": "stencil_"}

# kernel-vs-plain tolerance on max|y_kernel - y_plain| / max|y_plain|:
# both sum in the same order from +0.0; the kernel contracts each
# multiply-add into one FMA, the plain version rounds twice
TOL = {"float32": 1e-5, "float64": 1e-13}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def peaks_for(name):
    for key, p in PEAKS:
        if key in name:
            return p
    raise RuntimeError(f"no data-sheet peaks for card {name!r}")


class Timer:
    """Device time of one call from CUDA events: the device is kept busy
    by a sleep kernel while the host enqueues, so host overhead between
    launches does not show.  Before each launch a read of a 128 MiB
    buffer (a sum of it) evicts the 50 MB L2, as the main path finds
    these operands cold; being a read, it leaves only clean lines, so no
    write-back of an earlier launch's output falls inside the timed
    window (``flush=False`` leaves the operands of the previous launch
    in L2)."""

    def __init__(self, torch, reps=25):
        self.torch = torch
        self.reps = reps
        self.flush = torch.zeros(32 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, flush=True):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(self.reps)]
        torch.cuda._sleep(200_000_000)
        for s, e in ev:
            if flush:
                self.flush.sum()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in ev]))

    def device(self, fn, activity, attempts=3):
        """Device time of one call without its launch: the median over
        ``reps`` calls, each after the L2 flush, of the duration the
        profiler (CUPTI) records for the one kernel or copy ``fn`` runs,
        whose name holds ``activity``.  A profile that does not hold one
        such activity per call is taken again, up to ``attempts`` in
        all; then None: CUPTI at times records no activity at all for
        a whole process (PERF.md, section 7); a line before the kernel
        summary lists every device time that was not measured."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        for _ in range(attempts):
            with warnings.catch_warnings():
                # the profiler's notice that it keeps one cycle of events
                warnings.simplefilter("ignore", UserWarning)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(self.reps):
                        self.flush.sum()
                        fn()
                    torch.cuda.synchronize()
            durs = [e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and activity in e.name]
            if len(durs) == self.reps:
                return float(np.median(durs)) / 1e3
        return None


def kernel_case(torch, timer, peaks, name, label, run, plain, csr, nbytes,
                nops, dtype, extra=None):
    """Compare one kernel with its plain version on the card, time the
    kernel, the plain version and the library CSR product, and return
    the case's record (``extra`` adds fields to it)."""
    y = run()
    yp = plain()
    torch.cuda.synchronize()
    check(y.shape == yp.shape, f"{label}: shape {y.shape} vs {yp.shape}")
    check(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
    err = float((y - yp).abs().max()) if y.numel() else 0.0
    scale = float(yp.abs().max()) if y.numel() else 0.0
    rel = err / scale if scale > 0 else err
    tol = TOL[str(dtype).replace("torch.", "")]
    check(rel <= tol, f"{label}: kernel vs plain rel err {rel:.3e} > {tol}")
    ro, ci, vals, shape, x = csr
    with warnings.catch_warnings():
        # torch.sparse's beta and invariant-check notices
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_csr_tensor(ro, ci, vals, size=shape,
                                    check_invariants=True)
    yl = torch.mv(A, x)
    torch.cuda.synchronize()
    lib_err = float((yl - yp).abs().max()) if y.numel() else 0.0
    kind = "f64" if dtype == torch.float64 else "f32"
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = nops / peaks[kind] * 1e3
    rec = {
        "case": label, "kernel": name, "dtype": kind,
        "max_abs_err": err, "max_rel_err": rel, "tol": tol,
        "library_max_abs_err": lib_err,
        "kernel_ms": timer(run), "kernel_ms_warm_l2": timer(run, flush=False),
        "kernel_device_ms": timer.device(run, ACTIVITY[name]),
        "plain_ms": timer(plain),
        "library_ms": timer(lambda: torch.mv(A, x)),
        "bytes": int(nbytes), "ops": int(nops),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        **(extra or {}),
    }
    print(json.dumps(rec), flush=True)
    return rec


def csr_of(torch, sp, dtype):
    sp = sp.tocsr()
    return (
        torch.from_numpy(sp.indptr.astype(np.int32)).cuda(),
        torch.from_numpy(sp.indices.astype(np.int32)).cuda(),
        torch.from_numpy(sp.data.astype(dtype)).cuda(),
        sp.shape,
    )


def stencil_scipy(grid, steps, coefs):
    """CSR matrix of a constant stencil on ``grid`` (nx, ny, nz), x
    fastest: row i holds ``coefs[k]`` at column i + dx + nx dy + nx ny
    dz for each ``steps[k]`` = (dx, dy, dz) whose neighbour lies inside
    the grid."""
    import scipy.sparse as sps

    nx, ny, nz = grid
    n = nx * ny * nz
    i = np.arange(n, dtype=np.int64)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    rows, cols, vals = [], [], []
    for (dx, dy, dz), c in zip(steps, coefs):
        r = i[(ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
              & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz)]
        rows.append(r)
        cols.append(r + dx + nx * dy + nx * ny * dz)
        vals.append(np.full(r.shape[0], c))
    return sps.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n))


def ell_kernel_case(torch, timer, peaks, rng, label, sp, dtype,
                    extra=None):
    """The ELL kernel on the scipy matrix ``sp`` against its plain
    version, with a random x from ``rng``; returns the case record.
    The bound counts the operator's nonzeros (a column index and a
    value each, x and y once), not the padded slots the kernel reads:
    ``padded_bytes`` gives those."""
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.ops import ell

    A = SparseMatrix.from_scipy(sp.astype(dtype), device="cuda",
                                accel_formats=("ell",))
    check(A.has_ell, f"{label}: not ELL")
    x = torch.from_numpy(rng.standard_normal(A.n_cols).astype(dtype))
    x = x.cuda()
    w, n = A.ell_vals.shape
    isz = A.ell_vals.element_size()
    nz = int(sp.count_nonzero())
    ro, ci, vals, shape = csr_of(torch, sp, dtype)
    return kernel_case(
        torch, timer, peaks, "ell_spmv", label,
        lambda: ell.ell_spmv(A.ell_cols, A.ell_vals, x),
        lambda: ell.ell_spmv_plain(A.ell_cols, A.ell_vals, x),
        (ro, ci, vals, shape, x),
        nbytes=(4 + isz) * nz + isz * (n + A.n_cols),
        nops=2 * nz, dtype=A.ell_vals.dtype,
        extra={"nonzeros": nz, "width": w,
               "padded_bytes": (4 + isz) * w * n + isz * (n + A.n_cols),
               **(extra or {})},
    )


def kernel_phase(torch, peaks):
    import scipy.sparse as sps

    from amgx_tpu_torch.amg.aggregation import geo_aggregate
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_scipy
    from amgx_tpu_torch.ops import dia, stencil

    timer = Timer(torch)
    rng = np.random.default_rng(0)
    recs = []

    def dia_case(label, sp, dtype):
        A = SparseMatrix.from_scipy(sp.astype(dtype), device="cuda",
                                    accel_formats=("dia",))
        check(A.has_dia, f"{label}: not DIA")
        x = torch.from_numpy(rng.standard_normal(A.n_rows).astype(dtype))
        x = x.cuda()
        nd, n = A.dia_vals.shape
        isz = A.dia_vals.element_size()
        nz = int(sp.count_nonzero())
        ro, ci, vals, shape = csr_of(torch, sp, dtype)
        recs.append(kernel_case(
            torch, timer, peaks, "dia_spmv", label,
            lambda: dia.dia_spmv(A.dia_vals, A.dia_offsets_dev, x),
            lambda: dia.dia_spmv_plain(A.dia_vals, A.dia_offsets, x),
            (ro, ci, vals, shape, x),
            nbytes=isz * (nz + 2 * n) + 4 * nd, nops=2 * nz,
            dtype=A.dia_vals.dtype, extra={"nonzeros": nz},
        ))

    def ell_case(label, sp, dtype):
        recs.append(ell_kernel_case(torch, timer, peaks, rng, label, sp,
                                    dtype))

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def stencil_case(label, sp, dtype, nd_inst=7, meta=None):
        """The stencil kernel against its plain version and, bit for
        bit, against the DIA kernel on the same matrix; the default
        plan must take kernel ``nd_inst``.  ``meta`` (a ``StencilMeta``
        with its coefficients) gives the MATRIX_FREE state of a stencil
        detection does not yield; else it is detected from ``sp``."""
        sp = sp.astype(dtype)
        if meta is None:
            A = SparseMatrix.from_scipy(sp, device="cuda",
                                        accel_formats=("matrix_free",))
            check(A.has_matrix_free and A.mf_meta.kind == "const",
                  f"{label}: not a constant stencil")
        else:
            A = types.SimpleNamespace(
                mf_meta=meta[0], n_rows=sp.shape[0],
                mf_coefs=torch.tensor(meta[1], dtype=getattr(
                    torch, np.dtype(dtype).name), device="cuda"))
        D = SparseMatrix.from_scipy(sp, device="cuda",
                                    accel_formats=("dia",))
        check(D.has_dia, f"{label}: not DIA")
        check(D.dia_offsets == A.mf_meta.offsets,
              f"{label}: DIA offsets {D.dia_offsets} vs stencil "
              f"{A.mf_meta.offsets}")
        x = torch.from_numpy(rng.standard_normal(A.n_rows).astype(dtype))
        x = x.cuda()
        nd, n = len(A.mf_meta.steps), A.n_rows
        isz = A.mf_coefs.element_size()

        def run_dia():
            return dia.dia_spmv(D.dia_vals, D.dia_offsets_dev, x)

        y_dia = run_dia()
        y_st = stencil.stencil_spmv(A, x)
        torch.cuda.synchronize()
        d = float((y_st - y_dia).abs().max())
        check(d == 0.0 and torch.equal(y_st, y_dia),
              f"{label}: stencil vs DIA kernel max diff {d:.3e}")
        # the plan the wrapper launched with (x is 16-byte aligned)
        plan = stencil.stencil_launch_plan(A.mf_meta.grid, A.mf_meta.steps,
                                           16 // isz, sms)
        check(plan.nd_inst == nd_inst,
              f"{label}: plan takes kernel {plan.nd_inst}, not {nd_inst}")
        # a copy of x: the bytes of the bound, moved by a stock kernel
        xc = torch.empty_like(x)

        def copy():
            return xc.copy_(x)

        ro, ci, vals, shape = csr_of(torch, sp, dtype)
        recs.append(kernel_case(
            torch, timer, peaks, "stencil_spmv", label,
            lambda: stencil.stencil_spmv(A, x),
            lambda: stencil.stencil_spmv_plain(A.mf_meta, A.mf_coefs, x),
            (ro, ci, vals, shape, x),
            nbytes=isz * 2 * n + 16 * nd,
            nops=2 * int(sp.count_nonzero()),
            dtype=A.mf_coefs.dtype,
            extra={"grid": list(A.mf_meta.grid), "diagonals": nd,
                   "plan": plan._asdict(),
                   "max_abs_diff_vs_dia_kernel": d,
                   "dia_kernel_ms": timer(run_dia),
                   "dia_kernel_ms_warm_l2": timer(run_dia, flush=False),
                   "dia_kernel_device_ms": timer.device(
                       run_dia, ACTIVITY["dia_spmv"]),
                   "copy_ms": timer(copy),
                   "copy_ms_warm_l2": timer(copy, flush=False),
                   "copy_device_ms": timer.device(copy, "Memcpy DtoD")},
        ))

    # the floor of one event-bracketed launch: a kernel that does nothing
    print(json.dumps({"timer_floor": {
        "ms": timer(lambda: torch.cuda._sleep(0)),
        "ms_warm_l2": timer(lambda: torch.cuda._sleep(0), flush=False),
        "device_ms": timer.device(lambda: torch.cuda._sleep(0),
                                  "spin_kernel")}}),
        flush=True)

    N = SLICE_N
    A0 = poisson_scipy((N, N, N))
    dia_case(f"level0 A {N}^3 f32", A0, np.float32)
    dia_case(f"level0 A {N}^3 f64", A0, np.float64)
    stencil_case(f"level0 A {N}^3 f32", A0, np.float32)
    stencil_case(f"level0 A {N}^3 f64", A0, np.float64)
    del A0
    # poisson_scipy's last axis is the grid's fastest (x); levels 1-4 of
    # the bench hierarchy are the 64^3 ... 8^3 grids
    for lv, m in ((1, 64), (2, 32), (3, 16), (4, 8)):
        stencil_case(f"level{lv} A {m}^3 ({m ** 3} rows) f32",
                     poisson_scipy((m, m, m)), np.float32)
    stencil_case("thin grid 5x3x40 f32", poisson_scipy((40, 3, 5)),
                 np.float32)
    stencil_case("one plane 40x30x1 (5-point, runtime count) f32",
                 poisson_scipy((30, 40)), np.float32, nd_inst=0)
    stencil_case("unaligned grid 17x23x31 f32",
                 poisson_scipy((31, 23, 17)), np.float32)
    stencil_case("multi-block grid 64x32x16 f32",
                 poisson_scipy((16, 32, 64)), np.float32)
    ones3 = sps.diags_array([np.ones(63), np.ones(64), np.ones(63)],
                            offsets=[-1, 0, 1], format="csr")
    stencil_case("27-point grid 64^3 f32",
                 sps.kron(sps.kron(ones3, ones3), ones3, format="csr"),
                 np.float32, nd_inst=27)
    # realistic stencils other than the star: the 19-point Laplacian at
    # 128^3 on the box-subset tile kernel; the 2D 5-point one on
    # 2,097,152 rows and a 7-point stencil two points wide along x at
    # 128^3 (no detected grid has it) on the runtime-count kernel
    stencil_case("2D 5-point 2048x1024 (runtime count) f32",
                 poisson_scipy((1024, 2048)), np.float32, nd_inst=0)
    box = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]
    nineteen = [st for st in box if sum(map(abs, st)) <= 2]
    stencil_case(f"19-point {N}^3 f32",
                 stencil_scipy((N, N, N), nineteen,
                               [-1.0] * 9 + [18.0] + [-1.0] * 9),
                 np.float32, nd_inst=27)
    wide = [(0, 0, -1), (-2, 0, 0), (-1, 0, 0), (0, 0, 0), (1, 0, 0),
            (2, 0, 0), (0, 0, 1)]
    coefs = [-1.0, 0.0625, -1.25, 4.375, -1.25, 0.0625, -1.0]
    offsets = tuple(dx + N * dy + N * N * dz for dx, dy, dz in wide)
    stencil_case(f"wide-x 7-point {N}^3 (runtime count) f32",
                 stencil_scipy((N, N, N), wide, coefs), np.float32,
                 nd_inst=0,
                 meta=(stencil.StencilMeta("const", (N, N, N),
                                           tuple(wide), offsets),
                       np.asarray(coefs, dtype=np.float32)))

    n = 5000
    offs = (-301, -7, 0, 7, 301)
    rows, cols, vals = [], [], []
    for o in offs:
        r = np.arange(max(0, -o), n - max(0, o))
        rows.append(r)
        cols.append(r + o)
        vals.append(rng.standard_normal(r.shape[0]))
    unaligned = sps.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    ).tocsr()
    dia_case("unaligned offsets n=5000 f32", unaligned, np.float32)
    dia_case("level4 A 8^3 (512 rows) f32", poisson_scipy((8, 8, 8)),
             np.float32)

    # level-0 transfers of the bench hierarchy: geometric 2x2x2
    # aggregates numbered lexicographically (amg/aggregation.py)
    agg = geo_aggregate(N, N, N, 3)
    nf, nc = agg.shape[0], int(agg.max()) + 1
    P = sps.csr_matrix((np.ones(nf), (np.arange(nf), agg)), shape=(nf, nc))
    ell_case(f"level0 P {nf}x{nc} w=1 f32", P, np.float32)
    ell_case(f"level0 R {nc}x{nf} w=8 f32", P.T.tocsr(), np.float32)
    # and of the FGMRES_AGGREGATION hierarchy: SIZE_2, 2x1x1 aggregates
    agg = geo_aggregate(N, N, N, 1)
    nc = int(agg.max()) + 1
    P = sps.csr_matrix((np.ones(nf), (np.arange(nf), agg)), shape=(nf, nc))
    ell_case(f"level0 SIZE_2 P {nf}x{nc} w=1 f32", P, np.float32)
    ell_case(f"level0 SIZE_2 R {nc}x{nf} w=2 f32", P.T.tocsr(), np.float32)
    del P, agg

    m, k = 30000, 7000
    lens = rng.integers(0, 6, m)
    lens[rng.random(m) < 0.2] = 0  # empty rows
    r = np.repeat(np.arange(m), lens)
    c = rng.integers(0, k, r.shape[0])
    rect = sps.csr_matrix((rng.standard_normal(r.shape[0]), (r, c)),
                          shape=(m, k))
    rect.sum_duplicates()
    ell_case(f"random rect {m}x{k} empty rows f32", rect, np.float32)
    return recs


def solve_on(device, cfg_str, n, dtype, accel_formats=None, info=None):
    """Upload + setup + solve through the port's entry points; returns
    (solver, result, setup_s, b, upload_s).  ``accel_formats``
    (default: the matrix's default formats) is the uploaded matrix's;
    the upload time includes its DIA build or stencil detection.  On
    the card, ``info`` (a dict) receives ``setup_peak_bytes``, the
    peak device memory allocated during setup."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.io.poisson import poisson_3d_7pt, poisson_rhs

    kw = {} if accel_formats is None else {"accel_formats": accel_formats}
    t0 = time.perf_counter()
    A = poisson_3d_7pt(n, dtype=dtype, device=device, **kw)
    upload_s = time.perf_counter() - t0
    b = poisson_rhs(A.n_rows, dtype=dtype)
    if info is not None and device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = T.create_solver(T.AMGConfig.from_string(cfg_str), "default",
                        device=device)
    s.setup(A)
    setup_s = time.perf_counter() - t0
    if info is not None and device == "cuda":
        info["setup_peak_bytes"] = torch.cuda.max_memory_allocated()
    res = s.solve(b)
    return s, res, setup_s, b, upload_s


def true_rel_residual(n, b, x):
    from amgx_tpu_torch.io.poisson import poisson_scipy

    A = poisson_scipy((n, n, n))
    b64 = b.astype(np.float64)
    r = b64 - A @ x.astype(np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b64))


def trace_solve(torch, s, b, iters, groups=None):
    """Where a warm solve's time goes: one solve under torch.profiler;
    device busy time is the sum of the kernel and copy intervals on the
    card, its share is taken of the profiled solve's wall time.
    ``groups`` maps a label to name fragments: each device op counts
    under the first label one of whose fragments its name holds, the
    others under "rest".  Prints "not measured" when the profiler
    records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # the profiler's notice that it keeps one cycle of events
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.solve(b)
            wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print(json.dumps({"trace": "not measured"}), flush=True)
        return
    by_name = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_us = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    rec = {
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "device_ops": len(dev),
        "device_ops_per_iteration": len(dev) / max(iters, 1),
        "top": [{"name": n[:80], "ms": t / 1e3, "count": c,
                 "share_of_busy": t / busy_us} for n, (t, c) in top],
    }
    if groups:
        split = {label: [0.0, 0] for label in [*groups, "rest"]}
        for name, (t, c) in by_name.items():
            label = next((k for k, frags in groups.items()
                          if any(f in name for f in frags)), "rest")
            split[label][0] += t / 1e3
            split[label][1] += c
        rec["groups"] = {k: {"ms": t, "count": c}
                         for k, (t, c) in split.items()}
    print(json.dumps({"trace": rec}), flush=True)


def slice_phase(torch):
    from amgx_tpu_torch.ops import dia, ell

    N = SLICE_N
    # ---- the main path: counts zeroed just before, read just after
    dia.launches = 0
    ell.launches = 0
    s, res, setup_s, b, upload_s = solve_on("cuda", BENCH_CFG, N,
                                            np.float32)
    launches = {"dia_spmv": dia.launches, "ell_spmv": ell.launches}
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    levels = s.precond.level_summary()
    solve_s = s.solve_time
    # a second solve on the same setup: the first pays one-off costs
    # (cuBLAS/cuSOLVER handles, allocator growth)
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat solve changed the iterations")
    warm_s = s.solve_time
    repeat_bitwise = bool(torch.equal(res.x, res2.x))
    trace_solve(torch, s, b, iters)
    rel = true_rel_residual(N, b, x)
    rec = {
        "slice": f"poisson7 {N}^3 f32 PCG+AMG(SIZE_8,V,BLOCK_JACOBI,"
                 "DENSE_LU) on the card",
        "levels": levels, "iterations": iters, "status": status,
        "upload_s": upload_s, "setup_s": setup_s, "solve_s": solve_s,
        "per_iteration_s": solve_s / max(iters, 1), "solve_warm_s": warm_s,
        "per_iteration_warm_s": warm_s / max(iters, 1),
        "true_rel_residual_f64": rel, "launches": launches,
        "cycle_passes_per_iteration": s.precond.cycle_passes_per_iteration(),
        "repeat_solve_x_bitwise": repeat_bitwise,
    }
    print(json.dumps(rec), flush=True)
    check(status == 0, f"status {status}")
    check(rel <= 1e-5, f"true relative residual {rel:.3e} > 1e-5")
    check(launches["dia_spmv"] >= 14 * iters,
          f"dia_spmv launches {launches['dia_spmv']} < 14 x {iters}")
    check(launches["ell_spmv"] >= 6 * iters,
          f"ell_spmv launches {launches['ell_spmv']} < 6 x {iters}")

    # ---- the same solve through the port on the CPU (plain versions)
    sc, rc, setup_c, _, _ = solve_on("cpu", BENCH_CFG, N, np.float32)
    xc = rc.x.numpy()
    xinf = float(np.abs(xc).max())
    diff = float(np.abs(x - xc).max())
    cpu = {
        "cpu_iterations": int(rc.iters), "cpu_status": int(rc.status),
        "cpu_setup_s": setup_c, "cpu_solve_s": sc.solve_time,
        "max_abs_diff_vs_cpu": diff, "x_inf": xinf,
    }
    print(json.dumps(cpu), flush=True)
    check(abs(int(rc.iters) - iters) <= 1,
          f"f32 iterations card {iters} vs cpu {rc.iters}")
    check(np.allclose(x, xc, rtol=1e-3, atol=1e-5 * xinf),
          f"f32 x card vs cpu: max abs diff {diff:.3e}, |x|inf {xinf:.3e}")

    # ---- 64^3 in f64: iterations equal, x to rtol 1e-9
    _, r64, _, _, _ = solve_on("cuda", BENCH_CFG, 64, np.float64)
    _, c64, _, _, _ = solve_on("cpu", BENCH_CFG, 64, np.float64)
    x64, xc64 = r64.x.cpu().numpy(), c64.x.numpy()
    d64 = float(np.abs(x64 - xc64).max())
    print(json.dumps({
        "f64_64^3": {"iterations": int(r64.iters),
                     "cpu_iterations": int(c64.iters),
                     "status": int(r64.status),
                     "max_abs_diff_vs_cpu": d64}}), flush=True)
    check(int(r64.status) == 0, f"64^3 f64 status {r64.status}")
    check(int(r64.iters) == int(c64.iters),
          f"f64 iterations card {r64.iters} vs cpu {c64.iters}")
    check(np.allclose(x64, xc64, rtol=1e-9,
                      atol=1e-9 * float(np.abs(xc64).max())),
          f"f64 x card vs cpu: max abs diff {d64:.3e}")

    # ---- the entry() config: 16^3, SIZE_2, max_iters 20, f32
    se, re_, _, be, _ = solve_on("cuda", ENTRY_CFG, 16, np.float32)
    _, ce, _, _, _ = solve_on("cpu", ENTRY_CFG, 16, np.float32)
    xe = re_.x.cpu().numpy()
    entry = {"entry_16^3": {
        "iterations": int(re_.iters), "cpu_iterations": int(ce.iters),
        "status": int(re_.status), "levels": se.precond.level_summary(),
        "true_rel_residual_f64": true_rel_residual(16, be, xe)}}
    print(json.dumps(entry), flush=True)
    check(np.all(np.isfinite(xe)), "entry config: non-finite x")
    check(int(re_.status) == 0, f"entry config status {re_.status}")
    check(abs(int(re_.iters) - int(ce.iters)) <= 1,
          f"entry config iterations card {re_.iters} vs cpu {ce.iters}")
    return launches, {"x": x, "iters": iters, "x_cpu": xc,
                      "x64": x64, "x64_cpu": xc64}


def mf_slice_phase(torch, ref):
    """The bench solve with ``matrix_free=1`` on the card, held to the
    DIA slice's results ``ref`` (from :func:`slice_phase`)."""
    from amgx_tpu_torch.ops import dia, ell, stencil

    N = SLICE_N
    # ---- the main path: counts zeroed just before, read just after
    dia.launches = ell.launches = stencil.launches = 0
    s, res, setup_s, b, upload_s = solve_on("cuda", MF_CFG, N, np.float32,
                                            accel_formats=MF_FORMATS)
    launches = {"stencil_spmv": stencil.launches, "dia_spmv": dia.launches,
                "ell_spmv": ell.launches}
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    levels = s.precond.level_summary()
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat MF solve changed the iterations")
    warm_s = s.solve_time
    trace_solve(torch, s, b, iters)
    rel = true_rel_residual(N, b, x)
    passes = s.precond.cycle_passes_per_iteration()
    n_lv = len(levels)
    diff_dia = float(np.abs(x - ref["x"]).max())
    rec = {
        "slice": f"poisson7 {N}^3 f32 PCG+AMG(SIZE_8,V,BLOCK_JACOBI,"
                 "DENSE_LU) matrix_free=1 fused_cycle=1 on the card",
        "levels": levels, "iterations": iters, "status": status,
        "upload_s": upload_s, "setup_s": setup_s, "solve_s": solve_s,
        "per_iteration_s": solve_s / max(iters, 1), "solve_warm_s": warm_s,
        "per_iteration_warm_s": warm_s / max(iters, 1),
        "true_rel_residual_f64": rel, "launches": launches,
        "cycle_passes_per_iteration": passes,
        "dia_slice_iterations": ref["iters"],
        "max_abs_diff_vs_dia_slice": diff_dia,
        "x_bitwise_equal_dia_slice": x.tobytes() == ref["x"].tobytes(),
    }
    print(json.dumps(rec), flush=True)
    check(status == 0, f"MF status {status}")
    check(rel <= 1e-5, f"MF true relative residual {rel:.3e} > 1e-5")
    check(all(lv["format"] == "MATRIX_FREE" for lv in levels),
          f"MF levels {[lv['format'] for lv in levels]}")
    check(launches["stencil_spmv"] >= 14 * iters,
          f"stencil_spmv launches {launches['stencil_spmv']} < 14 x {iters}")
    check(launches["dia_spmv"] == 0,
          f"dia_spmv launched {launches['dia_spmv']} times on the MF path")
    check(launches["ell_spmv"] >= 6 * iters,
          f"ell_spmv launches {launches['ell_spmv']} < 6 x {iters}")
    check(passes == 2 * (n_lv - 1) + 1,
          f"fused cycle passes {passes} != 2({n_lv}-1)+1")
    check(iters == ref["iters"],
          f"MF iterations {iters} vs DIA slice {ref['iters']}")
    check(x.tobytes() == ref["x"].tobytes(),
          f"MF x differs from the DIA slice's x: max {diff_dia:.3e}")

    # ---- the same MF solve through the port on the CPU
    sc, rc, setup_c, _, _ = solve_on("cpu", MF_CFG, N, np.float32,
                                     accel_formats=MF_FORMATS)
    xc = rc.x.numpy()
    xinf = float(np.abs(xc).max())
    diff = float(np.abs(x - xc).max())
    print(json.dumps({
        "mf_cpu_iterations": int(rc.iters), "mf_cpu_status": int(rc.status),
        "mf_cpu_setup_s": setup_c, "mf_cpu_solve_s": sc.solve_time,
        "max_abs_diff_vs_cpu": diff, "x_inf": xinf,
        "cpu_x_bitwise_equal_dia_cpu": xc.tobytes() == ref["x_cpu"].tobytes(),
    }), flush=True)
    check(abs(int(rc.iters) - iters) <= 1,
          f"MF f32 iterations card {iters} vs cpu {rc.iters}")
    check(np.allclose(x, xc, rtol=1e-3, atol=1e-5 * xinf),
          f"MF f32 x card vs cpu: max abs diff {diff:.3e}")
    check(xc.tobytes() == ref["x_cpu"].tobytes(),
          "MF x on the CPU differs from the DIA x on the CPU")

    # ---- 64^3 in f64 on the card and the CPU (the f64 kernel)
    s64, r64, _, _, _ = solve_on("cuda", MF_CFG, 64, np.float64,
                                 accel_formats=MF_FORMATS)
    _, c64, _, _, _ = solve_on("cpu", MF_CFG, 64, np.float64,
                               accel_formats=MF_FORMATS)
    x64, xc64 = r64.x.cpu().numpy(), c64.x.numpy()
    d64 = float(np.abs(x64 - xc64).max())
    print(json.dumps({
        "mf_f64_64^3": {"iterations": int(r64.iters),
                        "cpu_iterations": int(c64.iters),
                        "status": int(r64.status),
                        "max_abs_diff_vs_cpu": d64,
                        "x_bitwise_equal_dia_slice":
                            x64.tobytes() == ref["x64"].tobytes()}}),
          flush=True)
    check(int(r64.status) == 0, f"MF 64^3 f64 status {r64.status}")
    check(all(lv.A.has_matrix_free for lv in s64.precond.levels),
          "MF 64^3 f64: a level is not MATRIX_FREE")
    check(int(r64.iters) == int(c64.iters),
          f"MF f64 iterations card {r64.iters} vs cpu {c64.iters}")
    check(np.allclose(x64, xc64, rtol=1e-9,
                      atol=1e-9 * float(np.abs(xc64).max())),
          f"MF f64 x card vs cpu: max abs diff {d64:.3e}")
    return launches


def solver_matrix():
    """(label, config) of the 32^3 card-against-CPU cases: each outer
    solver ported with FGMRES around the bench config's SIZE_8 /
    BLOCK_JACOBI AMG (BICGSTAB takes no preconditioner), each smoother
    ported with it in a PCG + SIZE_2 AMG solve, and FGMRES_AGGREGATION
    colored by PARALLEL_GREEDY."""
    cases = [(f"{name}+AMG(SIZE_8)",
              BENCH_CFG.replace('"solver": "PCG", "max_iters": 100',
                                f'"solver": "{name}", "max_iters": 200'))
             for name in ("GMRES", "PCGF", "PBICGSTAB", "BICGSTAB")]
    pcg_size2 = ENTRY_CFG.replace('"max_iters": 20', '"max_iters": 100')
    for name, extra in (("MULTICOLOR_DILU", ""), ("MULTICOLOR_GS", ""),
                        ("MULTICOLOR_GS", ', "symmetric_GS": 1'),
                        ("GS", ""), ("FIXCOLOR_GS", ""), ("JACOBI_L1", "")):
        label = f"PCG+AMG(SIZE_2,{name}{' symmetric' if extra else ''})"
        cases.append((label, pcg_size2.replace(
            '"solver": "BLOCK_JACOBI",', f'"solver": "{name}"{extra},')))
    cases.append(("FGMRES_AGGREGATION PARALLEL_GREEDY", FGMRES_CFG.replace(
        '"max_levels": 50,',
        '"max_levels": 50, "matrix_coloring_scheme": "PARALLEL_GREEDY",')))
    return cases


# the counter each operator format's SpMV adds to (dense: a matmul)
FORMAT_COUNTER = {"DIA": "dia_spmv", "ELL": "ell_spmv",
                  "MATRIX_FREE": "stencil_spmv", "CSR": "csr"}


def derived_launches(amg, cycles, top):
    """``dia_spmv``, ``ell_spmv``, ``stencil_spmv`` launches and CSR
    products of a solve from its AMG hierarchy (unfused cycles): ``top``
    level-0 A-SpMVs outside the preconditioner, and per V-cycle on each
    level above the coarsest its presweeps, its residual and its
    postsweeps (one A-SpMV each), then P and R; on the coarsest level
    one residual before the dense-LU solve (or its smoothing
    sweeps)."""
    counts = dict.fromkeys(FORMAT_COUNTER.values(), 0)

    def add(fmt, k):
        if fmt in FORMAT_COUNTER:
            counts[FORMAT_COUNTER[fmt]] += k

    lv = amg.levels
    add(lv[0].A.format, top)
    for i, lvl in enumerate(lv[:-1]):
        pre, post = amg._level_sweeps(i)
        add(lvl.A.format, cycles * (pre + 1 + post))
        add(lvl.P.format, cycles)
        add(lvl.R.format, cycles)
    coarsest = 1 if amg.coarse_solver is not None else amg.coarsest_sweeps
    add(lv[-1].A.format, cycles * coarsest)
    return counts


def fgmres_derived_launches(s, iters):
    """Launches of an FGMRES solve of ``iters`` iterations: r0 = b - A
    x0 once and one more residual per restart, one A z and one V-cycle
    per iteration."""
    restarts = -(-iters // s.restart)
    return derived_launches(s.precond, iters, restarts + iters)


def pcg_derived_launches(s, iters):
    """Launches of a PCG solve of ``iters`` iterations: r0 = b - A x0
    and one V-cycle before the loop, one A p and one V-cycle per
    iteration."""
    return derived_launches(s.precond, iters + 1, iters + 1)


def fgmres_phase(torch):
    """FGMRES_AGGREGATION (FGMRES + aggregation AMG + MULTICOLOR_DILU)
    at 128^3 f32 on the card, its CPU run, 64^3 f64 on both, a trace
    of one warm solve, and the 32^3 solver matrix."""
    from amgx_tpu_torch.ops import dia, ell, stencil

    N = SLICE_N
    # ---- A. the main path: counts zeroed just before, read just after
    dia.launches = ell.launches = stencil.launches = 0
    s, res, setup_s, b, upload_s = solve_on("cuda", FGMRES_CFG, N,
                                            np.float32)
    launches = {"dia_spmv": dia.launches, "ell_spmv": ell.launches,
                "stencil_spmv": stencil.launches}
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    levels = s.precond.level_summary()
    colors = [lv.smoother.num_colors if lv.smoother else None
              for lv in s.precond.levels]
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat FGMRES solve changed iterations")
    warm_s = s.solve_time
    derived = fgmres_derived_launches(s, iters)
    rel = true_rel_residual(N, b, x)
    rec = {
        "slice": f"poisson7 {N}^3 f32 FGMRES(10)+AMG(SIZE_2,V,"
                 "MULTICOLOR_DILU x3,DENSE_LU) on the card",
        "levels": [{**lv, "colors": c} for lv, c in zip(levels, colors)],
        "n_levels": len(levels), "iterations": iters, "status": status,
        "upload_s": upload_s, "setup_s": setup_s, "solve_s": solve_s,
        "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": warm_s,
        "ms_per_iteration_warm": warm_s / max(iters, 1) * 1e3,
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
    }
    print(json.dumps(rec), flush=True)
    check(status == 0, f"FGMRES status {status}")
    check(rel <= 1e-5, f"FGMRES true relative residual {rel:.3e} > 1e-5")
    check(all(lv["format"] == "DIA" for lv in levels),
          f"FGMRES levels {[lv['format'] for lv in levels]}")
    for k in ("dia_spmv", "ell_spmv"):
        check(launches[k] == derived[k],
              f"FGMRES {k} launches {launches[k]} != derived {derived[k]}")

    # ---- D. a trace of one warm solve
    # index_copy_ runs as an index_elementwise_kernel too: its own
    # fragment is tried before the gathers'
    trace_solve(torch, s, b, iters, groups={
        "dia_spmv": ["dia_spmv"], "ell_spmv": ["ell_spmv"],
        "index_copy": ["index_copy"],
        "gather": ["index_elementwise", "gather", "index_select"],
        "reduction": ["reduce_kernel"],
    })
    del s, res, res2

    # ---- B. the same solve through the port on the CPU
    sc, rc, setup_c, _, _ = solve_on("cpu", FGMRES_CFG, N, np.float32)
    xc = rc.x.numpy()
    xinf = float(np.abs(xc).max())
    diff = float(np.abs(x - xc).max())
    colors_c = [lv.smoother.num_colors if lv.smoother else None
                for lv in sc.precond.levels]
    print(json.dumps({
        "fgmres_cpu_iterations": int(rc.iters),
        "fgmres_cpu_status": int(rc.status),
        "fgmres_cpu_setup_s": setup_c, "fgmres_cpu_solve_s": sc.solve_time,
        "max_abs_diff_vs_cpu": diff, "x_inf": xinf,
        "colors_equal_cpu": colors_c == colors}), flush=True)
    check(colors_c == colors, f"colours card {colors} vs cpu {colors_c}")
    check(abs(int(rc.iters) - iters) <= 1,
          f"FGMRES f32 iterations card {iters} vs cpu {rc.iters}")
    check(np.allclose(x, xc, rtol=1e-4, atol=1e-4 * xinf),
          f"FGMRES f32 x card vs cpu: max abs diff {diff:.3e}")
    del sc, rc

    # ---- C. 64^3 in f64 on the card and the CPU
    _, r64, _, _, _ = solve_on("cuda", FGMRES_CFG, 64, np.float64)
    _, c64, _, _, _ = solve_on("cpu", FGMRES_CFG, 64, np.float64)
    x64, xc64 = r64.x.cpu().numpy(), c64.x.numpy()
    d64 = float(np.abs(x64 - xc64).max())
    print(json.dumps({
        "fgmres_f64_64^3": {"iterations": int(r64.iters),
                            "cpu_iterations": int(c64.iters),
                            "status": int(r64.status),
                            "max_abs_diff_vs_cpu": d64}}), flush=True)
    check(int(r64.status) == 0, f"FGMRES 64^3 f64 status {r64.status}")
    check(int(r64.iters) == int(c64.iters),
          f"FGMRES f64 iterations card {r64.iters} vs cpu {c64.iters}")
    check(np.allclose(x64, xc64, rtol=1e-9,
                      atol=1e-9 * float(np.abs(xc64).max())),
          f"FGMRES f64 x card vs cpu: max abs diff {d64:.3e}")

    # ---- E. the 32^3 solver matrix, card against CPU
    for label, cfg in solver_matrix():
        t0 = time.perf_counter()
        _, rg, _, bg, _ = solve_on("cuda", cfg, 32, np.float32)
        card_s = time.perf_counter() - t0
        _, rcpu, _, _, _ = solve_on("cpu", cfg, 32, np.float32)
        xg = rg.x.cpu().numpy()
        print(json.dumps({"solver_32^3": {
            "case": label, "iterations": int(rg.iters),
            "cpu_iterations": int(rcpu.iters), "status": int(rg.status),
            "cpu_status": int(rcpu.status), "card_s": card_s,
            "true_rel_residual_f64": true_rel_residual(32, bg, xg)}}),
            flush=True)
        check(int(rg.status) == 0 and int(rcpu.status) == 0,
              f"{label}: status card {rg.status} cpu {rcpu.status}")
        check(abs(int(rg.iters) - int(rcpu.iters)) <= 1,
              f"{label}: iterations card {rg.iters} vs cpu {rcpu.iters}")
    return launches


def _width(m):
    return None if m is None or not m.has_ell else int(m.ell_cols.shape[0])


def classical_levels(amg):
    """Per level: rows, nnz, format and ELL width of A; format, nnz,
    ELL width and longest row of P and R."""
    out = []
    for lvl in amg.levels:
        rec = {"rows": lvl.n_rows, "nnz": lvl.nnz, "format": lvl.A.format,
               "ell_width": _width(lvl.A),
               "max_row": int(np.diff(lvl.A._host[0]).max())}
        for f in ("P", "R"):
            m = getattr(lvl, f)
            if m is not None:
                rec[f] = {"format": m.format, "nnz": m.nnz,
                          "ell_width": _width(m),
                          "max_row": int(np.diff(m._host[0]).max())}
        out.append(rec)
    return out


def levels_bitwise(a, b):
    """None when the hierarchies ``a`` and ``b`` (AMG solvers) hold the
    same A, P and R on every level bit for bit, else where they
    differ."""
    if len(a.levels) != len(b.levels):
        return f"level count {len(a.levels)} vs {len(b.levels)}"
    for la, lb in zip(a.levels, b.levels):
        for f in ("A", "P", "R"):
            ma, mb = getattr(la, f), getattr(lb, f)
            if (ma is None) != (mb is None):
                return f"level {la.level_id} {f} presence"
            if ma is not None and any(
                    x.tobytes() != y.tobytes()
                    for x, y in zip(ma._host, mb._host)):
                return f"level {la.level_id} {f}"
    return None


def card_cf_split(torch, Asp, device):
    """The C/F split of the device pipeline (AHAT strength with the
    config's defaults theta 0.25 and max_row_sum 1.1, PMIS) of the host
    CSR ``Asp``, run on ``device``."""
    from amgx_tpu_torch.amg import device_setup as ds

    A = Asp.tocsr()
    n = A.shape[0]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rows = put(np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr)))
    cols, vals = put(A.indices.astype(np.int64)), put(A.data)
    offsets = put(A.indptr.astype(np.int64))
    strong = ds._strength_ahat_dev(rows, cols, vals, offsets, n, 0.25, 1.1)
    w = ds._pmis_weights(strong, cols, n, vals.dtype, 0, [0.0])
    return ds._pmis_dev(rows, cols, strong, n, w).cpu().numpy()


def shuffled_poisson(m, seed=0):
    """Poisson on an m^3 grid with its unknowns shuffled (no DIA, so
    RCM has a bandwidth to win back)."""
    from amgx_tpu_torch.io.poisson import poisson_scipy

    A = poisson_scipy((m, m, m))
    p = np.random.default_rng(seed).permutation(A.shape[0])
    A = A[p][:, p].tocsr()
    A.sort_indices()
    return A


def classical_phase(torch, peaks=None, device="cuda", n=SLICE_N,
                    n_cmp=48, n_f64=64, n_small=32):
    """PCG_CLASSICAL at ``n``^3 f32 with its setup on ``device`` (the
    main path of this slice), the ELL kernel at its shapes, a trace,
    determinism, the CPU port, the hierarchy against the host builder
    at ``n_cmp``^3 f64, ``n_f64``^3 f64 against the CPU, and the other
    selector / interpolator / reordering paths.  ``peaks`` None (a
    rehearsal on the CPU) skips the kernel cases and the trace."""
    from amgx_tpu_torch.amg import classical, device_setup
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_rhs
    from amgx_tpu_torch.ops import dia, ell, spmv, stencil

    def counts():
        return {"dia_spmv": dia.launches, "ell_spmv": ell.launches,
                "stencil_spmv": stencil.launches, "csr": spmv.csr_products}

    def device_built(amg, label):
        stats = amg.setup_stats
        check(stats["host_fallback_levels"] == 0,
              f"{label}: {stats['host_fallback_levels']} host fallbacks")
        if device == "cuda":
            check(stats["device_levels"] == len(amg.levels) - 1,
                  f"{label}: {stats['device_levels']} device-built levels "
                  f"of {len(amg.levels) - 1}")

    # ---- 1. the main path: counts zeroed just before, read just after
    info = {}
    dia.launches = ell.launches = stencil.launches = 0
    spmv.csr_products = 0
    s, res, setup_s, b, upload_s = solve_on(device, PCG_CLASSICAL, n,
                                            np.float32, info=info)
    launches = counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    amg = s.precond
    levels = classical_levels(amg)
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat classical solve changed iters")
    warm_s = s.solve_time
    derived = pcg_derived_launches(s, iters)
    rel = true_rel_residual(n, b, x)
    print(json.dumps({
        "slice": f"poisson7 {n}^3 f32 PCG_CLASSICAL_V_JACOBI (PCG + "
                 "classical AMG AHAT/PMIS/D1, V, BLOCK_JACOBI, DENSE_LU) "
                 f"setup and solve on {device}",
        "levels": levels, "n_levels": len(levels), "iterations": iters,
        "status": status, "upload_s": upload_s, "setup_s": setup_s,
        "setup_profile": amg.setup_profile, "setup_stats": amg.setup_stats,
        "setup_peak_bytes": info.get("setup_peak_bytes"),
        "solve_s": solve_s, "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": warm_s,
        "ms_per_iteration_warm": warm_s / max(iters, 1) * 1e3,
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
        "repeat_solve_x_bitwise": bool(torch.equal(res.x, res2.x)),
    }), flush=True)
    check(status == 0, f"classical status {status}")
    check(rel <= 1e-5, f"classical true relative residual {rel:.3e} > 1e-5")
    device_built(amg, "PCG_CLASSICAL")
    for k in launches:
        # (the wrappers count only launches on the card)
        check(launches[k] == derived[k] or device != "cuda",
              f"classical {k} launches {launches[k]} != derived {derived[k]}")
    check(torch.equal(res.x, res2.x), "repeat classical solve changed x")

    recs = []
    if peaks is not None:
        # ---- the ELL kernel at this hierarchy's shapes, with the
        # launches one solve gives each operator
        timer = Timer(torch)
        rng = np.random.default_rng(1)
        cycles = iters + 1
        pre, post = amg._level_sweeps(1)
        l0, l1 = amg.levels[0], amg.levels[1]
        for label, m, per_solve in (
                ("level1 A", l1.A, cycles * (pre + 1 + post)),
                ("level0 P", l0.P, cycles), ("level0 R", l0.R, cycles)):
            if m.format != "ELL":
                print(json.dumps({"classical_kernel_case_skipped": {
                    "operator": label, "format": m.format}}), flush=True)
                continue
            recs.append(ell_kernel_case(
                torch, timer, peaks, rng,
                f"classical {label} {m.n_rows}x{m.n_cols} "
                f"w={_width(m)} f32", m.host_csr(), np.float32,
                extra={"launches_per_solve": per_solve}))
        # the CSR products (P on the levels whose rows are too uneven
        # for the ELL gate): the port's segment sum (torch.segment_reduce
        # on one column) against segment_reduce on 1-D data (CUB),
        # index_add_ (atomics: the sum order changes from run to run)
        # and torch.mv on CSR
        P1 = amg.levels[1].P
        if P1.format == "CSR":
            xr = torch.from_numpy(
                rng.standard_normal(P1.n_cols).astype(np.float32)).cuda()

            def seg():
                return spmv._spmv_scalar(P1, xr)

            def seg_1d():
                c = P1.values * xr[P1.col_indices]
                return torch.segment_reduce(c, "sum", offsets=P1.row_offsets,
                                            unsafe=True)

            def atomics():
                c = P1.values * xr[P1.col_indices]
                y = torch.zeros(P1.n_rows, dtype=c.dtype, device=c.device)
                return y.index_add_(0, P1.row_ids, c)

            ys = [seg() for _ in range(10)]
            ya = [atomics() for _ in range(10)]
            with warnings.catch_warnings():
                # torch.sparse's beta notice
                warnings.simplefilter("ignore", UserWarning)
                lib = torch.sparse_csr_tensor(
                    P1.row_offsets, P1.col_indices, P1.values,
                    size=P1.shape)
            nbytes = 8 * P1.nnz + 4 * (2 * P1.n_rows + 1 + P1.n_cols)
            print(json.dumps({"classical_csr_case": {
                "operator": f"level1 P {P1.n_rows}x{P1.n_cols} "
                            f"nnz={P1.nnz} f32",
                "segment_sum_ms": timer(seg),
                "segment_reduce_1d_ms": timer(seg_1d),
                "index_add_ms": timer(atomics),
                "library_ms": timer(lambda: torch.mv(lib, xr)),
                "bound_ms": nbytes / peaks["bw"] * 1e3,
                "segment_sum_repeats_bitwise": all(
                    torch.equal(ys[0], y) for y in ys),
                "segment_sum_equals_1d": bool(torch.equal(ys[0], seg_1d())),
                "index_add_distinct_results_of_10": len(
                    {y.cpu().numpy().tobytes() for y in ya}),
                "max_abs_diff_vs_index_add": float(
                    (ys[0] - ya[0]).abs().max())}}), flush=True)
            check(all(torch.equal(ys[0], y) for y in ys),
                  "CSR product not bit for bit repeatable")
            del P1, xr, ys, ya, lib
        del timer
        # ---- 7. a traced warm solve
        trace_solve(torch, s, b, iters, groups={
            "dia_spmv": ["dia_spmv"], "ell_spmv": ["ell_spmv"],
            "csr": ["egment"], "dense": ["gemv", "gemm", "dot_kernel"],
            "reduction": ["reduce_kernel"],
        })

    # ---- 3. determinism: a second setup and solve on the same device
    s2, r3, _, _, _ = solve_on(device, PCG_CLASSICAL, n, np.float32)
    where = levels_bitwise(amg, s2.precond)
    print(json.dumps({"classical_repeat_setup": {
        "hierarchy_bitwise": where is None, "first_difference": where,
        "x_bitwise": bool(torch.equal(res.x, r3.x))}}), flush=True)
    check(where is None, f"two classical setups differ at {where}")
    check(torch.equal(res.x, r3.x), "two classical setups gave another x")
    del s, s2, res, res2, r3, amg

    # ---- 2. the CPU port (AUTO: the host builder there)
    sc, rc, setup_c, _, _ = solve_on("cpu", PCG_CLASSICAL, n, np.float32)
    xc = rc.x.numpy()
    print(json.dumps({"classical_cpu": {
        "iterations": int(rc.iters), "status": int(rc.status),
        "setup_s": setup_c, "solve_s": sc.solve_time,
        "levels": [(lv.n_rows, lv.nnz) for lv in sc.precond.levels],
        "true_rel_residual_f64": true_rel_residual(n, b, xc),
        "max_abs_diff_vs_card": float(np.abs(x - xc).max()),
        "x_inf": float(np.abs(xc).max())}}), flush=True)
    check(int(rc.status) == 0, f"classical cpu status {rc.status}")
    check(abs(int(rc.iters) - iters) <= 1,
          f"classical f32 iterations card {iters} vs cpu {rc.iters}")
    del sc, rc

    # ---- 4. the device pipeline against the host builder, f64: each
    # coarse level of the card's hierarchy built again from the same
    # operator by both.  (The two hierarchies as wholes part from level
    # 2 on: Ac agrees to roundoff, and entries that sit exactly at
    # theta times the row's largest, as -1/3 against 4/3, fall on
    # either side of the strength test; tests/test_torch_device_setup.py
    # shows the JAX package's two builders part the same way at 20^3.)
    import amgx_tpu_torch as T

    sd, _, _, _, _ = solve_on(device, PCG_CLASSICAL, n_cmp, np.float64)
    sh, _, _, _, _ = solve_on("cpu", PCG_CLASSICAL, n_cmp, np.float64)
    device_built(sd.precond, f"{n_cmp}^3 f64")
    cfg = T.AMGConfig.from_string(PCG_CLASSICAL)
    cmp = []
    for lvl in sd.precond.levels[:-1]:
        Asp = lvl.A.host_csr()
        built = device_setup.build_classical_level_device(
            Asp, cfg, "amg", lvl.level_id, device=device)
        ref = classical.build_classical_level(Asp, cfg, "amg", lvl.level_id)
        rec = {"level": lvl.level_id, "rows": lvl.n_rows,
               "cf_equal": bool(np.array_equal(
                   card_cf_split(torch, Asp, device),
                   classical.pmis_select(
                       classical.strength_ahat(Asp, 0.25, 1.1))))}
        for name, md, mh in zip(("P", "R", "Ac"), built, ref):
            md, mh = md.copy(), mh.copy()
            rec[f"{name}_nnz"], rec[f"{name}_host_nnz"] = md.nnz, mh.nnz
            md.eliminate_zeros()
            mh.eliminate_zeros()
            rec[f"{name}_nonzeros_equal"] = md.shape == mh.shape and (
                (md != 0) != (mh != 0)).nnz == 0
            rec[f"{name}_max_abs_diff"] = (
                float(abs(md - mh).max()) if md.shape == mh.shape
                else None)
        cmp.append(rec)
    print(json.dumps({f"classical_levels_{n_cmp}^3_f64_vs_host": cmp,
                      "card_hierarchy": [(lv.n_rows, lv.nnz)
                                         for lv in sd.precond.levels],
                      "host_hierarchy": [(lv.n_rows, lv.nnz)
                                         for lv in sh.precond.levels]}),
          flush=True)
    for rec in cmp:
        lv = rec["level"]
        check(rec["cf_equal"], f"{n_cmp}^3 level {lv}: C/F split differs")
        for name, tol in (("P", 1e-12), ("R", 1e-12), ("Ac", 1e-11)):
            check(rec[f"{name}_nonzeros_equal"]
                  and rec[f"{name}_max_abs_diff"] <= tol,
                  f"{n_cmp}^3 level {lv}: {name} differs from the host's "
                  f"({rec[f'{name}_max_abs_diff']})")
    del sd, sh

    # ---- n_f64^3 f64 on the device against the CPU port: the port on
    # the CPU solving with the card's hierarchy (carried across with
    # hierarchy_from_numpy) takes the same iterations to x within rtol
    # 1e-9; with its own host-built hierarchy, which parts from the
    # card's at threshold ties (section 4), within one iteration
    from amgx_tpu_torch.amg.hierarchy import hierarchy_from_numpy

    s64, r64, _, b64, _ = solve_on(device, PCG_CLASSICAL, n_f64, np.float64)
    device_built(s64.precond, f"{n_f64}^3 f64")
    given = [{k: (*getattr(lv, k)._host, getattr(lv, k).shape)
              for k in ("A", "P", "R") if getattr(lv, k) is not None}
             for lv in s64.precond.levels]
    sg64 = hierarchy_from_numpy(given, T.AMGConfig.from_string(PCG_CLASSICAL),
                                device="cpu")
    g64 = sg64.solve(b64)
    _, c64, _, _, _ = solve_on("cpu", PCG_CLASSICAL, n_f64, np.float64)
    x64, xg64 = r64.x.cpu().numpy(), g64.x.numpy()
    d64 = float(np.abs(x64 - xg64).max())
    print(json.dumps({f"classical_f64_{n_f64}^3": {
        "iterations": int(r64.iters), "status": int(r64.status),
        "cpu_on_card_hierarchy_iterations": int(g64.iters),
        "max_abs_diff_vs_cpu_on_card_hierarchy": d64,
        "cpu_own_setup_iterations": int(c64.iters),
        "max_abs_diff_vs_cpu_own_setup":
            float(np.abs(x64 - c64.x.numpy()).max()),
        "x_inf": float(np.abs(x64).max())}}), flush=True)
    check(int(r64.status) == 0, f"classical f64 status {r64.status}")
    check(int(r64.iters) == int(g64.iters),
          f"classical f64 iterations card {r64.iters} vs cpu {g64.iters}")
    check(np.allclose(x64, xg64, rtol=1e-9,
                      atol=1e-9 * float(np.abs(xg64).max())),
          f"classical f64 x card vs cpu: max abs diff {d64:.3e}")
    check(abs(int(r64.iters) - int(c64.iters)) <= 1,
          f"classical f64 iterations card {r64.iters} vs cpu's own "
          f"setup {c64.iters}")
    del s64, sg64

    # ---- 5. the other selector / interpolator / reordering paths
    def card_and_cpu(label, run):
        t0 = time.perf_counter()
        sg, rg, xres = run(device)
        card_s = time.perf_counter() - t0
        _, rcpu, _ = run("cpu")
        print(json.dumps({"classical_path": {
            "case": label, "iterations": int(rg.iters),
            "cpu_iterations": int(rcpu.iters), "status": int(rg.status),
            "cpu_status": int(rcpu.status), "card_s": card_s,
            "levels": [(lv.n_rows, lv.nnz, lv.A.format)
                       for lv in sg.precond.levels],
            "setup_profile": sg.precond.setup_profile,
            "true_rel_residual_f64": xres}}), flush=True)
        check(int(rg.status) == 0 and int(rcpu.status) == 0,
              f"{label}: status card {rg.status} cpu {rcpu.status}")
        check(abs(int(rg.iters) - int(rcpu.iters)) <= 1,
              f"{label}: iterations card {rg.iters} vs cpu {rcpu.iters}")
        return sg

    def poisson_run(cfg, m):
        def run(dev):
            sg, rg, _, bg, _ = solve_on(dev, cfg, m, np.float32)
            return sg, rg, true_rel_residual(m, bg, rg.x.cpu().numpy())
        return run

    for label, extra in (
            ("D2 aggressive_levels 1 interp_max_elements 4",
             ', "interpolator": "D2", "aggressive_levels": 1,'
             ' "interp_max_elements": 4'),
            ("MULTIPASS", ', "interpolator": "MULTIPASS"')):
        sg = card_and_cpu(f"{n}^3 f32 PCG_CLASSICAL {label}",
                          poisson_run(classical_cfg(extra), n))
        device_built(sg.precond, label)
        del sg
    card_and_cpu(f"{n_small}^3 f32 ENERGYMIN",
                 poisson_run(classical_cfg(', "algorithm": "ENERGYMIN"'),
                             n_small))
    shuffled = shuffled_poisson(n_small).astype(np.float32)
    rcm_cfg = classical_cfg(main_extra=', "matrix_reordering": "RCM"')

    def rcm_run(dev):
        import amgx_tpu_torch as T

        A = SparseMatrix.from_scipy(shuffled, device=dev)
        sg = T.create_solver(T.AMGConfig.from_string(rcm_cfg), "default",
                             device=dev)
        sg.setup(A)
        check(sg._reorder is not None, "RCM: the system was not reordered")
        bg = poisson_rhs(A.n_rows, dtype=np.float32)
        rg = sg.solve(bg)
        xg = rg.x.cpu().numpy().astype(np.float64)
        b64 = bg.astype(np.float64)
        xres = float(np.linalg.norm(b64 - shuffled.astype(np.float64) @ xg)
                     / np.linalg.norm(b64))
        return sg, rg, xres

    sg = card_and_cpu(f"{n_small}^3 shuffled f32 PCG_CLASSICAL RCM", rcm_run)
    device_built(sg.precond, "RCM")
    return launches, recs


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import amgx_tpu_torch  # noqa: F401
    from amgx_tpu_torch.ops import kernels

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    peaks = peaks_for(kind)

    t0 = time.perf_counter()
    paths = kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(paths))})", flush=True)
    for name in sorted(paths):
        report = (kernels.BUILD_DIR / f"{name}.ptxas.txt").read_text()
        for line in report.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    recs = kernel_phase(torch, peaks)
    launches, ref = slice_phase(torch)
    # each path's counts come from its own run: DIA and ELL from the
    # matrix_free=0 slice, the stencil kernel's from the MF slice
    launches["stencil_spmv"] = mf_slice_phase(torch, ref)["stencil_spmv"]
    fg = fgmres_phase(torch)
    cl, cl_recs = classical_phase(torch, peaks)
    recs += cl_recs

    main_case = {
        "dia_spmv": (f"level0 A {SLICE_N}^3 f32",
                     "amgx_tpu_torch/csrc/dia_spmv.cu",
                     "amgx_tpu/ops/pallas_dia.py:76"),
        "ell_spmv": (f"level0 R {(SLICE_N // 2) ** 3}x{SLICE_N ** 3} "
                     "w=8 f32",
                     "amgx_tpu_torch/csrc/ell_spmv.cu",
                     "amgx_tpu/ops/pallas_well.py:160"),
        "stencil_spmv": (f"level0 A {SLICE_N}^3 f32",
                         "amgx_tpu_torch/csrc/stencil_spmv.cu",
                         "amgx_tpu/ops/pallas_stencil.py:64"),
    }
    # the device times the profiler did not record (null in the cases)
    print(json.dumps({"device_time_not_measured": [
        f"{r['case']} ({r['kernel']}): {k}" for r in recs
        for k, v in r.items() if k.endswith("device_ms") and v is None]}),
        flush=True)
    summary = []
    for name, (case, source, replaces) in main_case.items():
        rec = next(r for r in recs
                   if r["kernel"] == name and r["case"] == case)
        check(launches[name] > 0, f"{name} never launched on the main path")
        if name != "stencil_spmv":
            check(cl[name] > 0,
                  f"{name} never launched on the PCG_CLASSICAL path")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "launches_fgmres_aggregation": fg[name],
            "launches_pcg_classical": cl[name],
        })
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
