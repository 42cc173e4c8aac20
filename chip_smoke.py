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
   the copy engine).  Each ELL case runs the slot-major ``ell_spmv`` and,
   where the upload builds the sliced layout, ``sell_spmv``, each held
   to the plain versions of both layouts; the sliced kernel is also
   held, untimed, to both on edge layouts at every window and lane
   count (one lane a row bit for bit equal to ``ell_spmv``).  Speed
   targets print on ``targets`` lines and fail nothing.  A line before
   the summary lists every device time the profiler did not record.
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
   against CPU (iterations within one), with the solvers, smoothers,
   coarse solver and scalers of the seventh slice.
6. PCG_CLASSICAL_V_JACOBI slice: AmgX's default-algorithm config
   (``PCG_CLASSICAL``: PCG + classical AMG, AHAT / PMIS / D1, BLOCK_JACOBI,
   DENSE_LU) on ``poisson_3d_7pt(128)`` in f32 with the classical setup
   on the card (``setup_location`` AUTO), counts zeroed just before
   setup and read just after the solve.  Per level rows, nnz, format
   and ELL widths; upload, setup (host / device split, scalar reads,
   peak device memory) and solve times; the true residual; no level
   handed to the host builder; the ``dia_spmv`` / ``ell_spmv`` /
   ``sell_spmv`` launches and CSR products equal to the count derived
   from the hierarchy; each ELL operator's sliced layout (window, lanes
   a row, stored slots per CSR entry, device bytes); both ELL kernels at
   every ELL operator (the sliced one also at every lane count and
   window), the level-1 A in f64 and renumbered by RCM (a measurement
   only); a trace of a warm solve.  Then a second setup and solve
   (hierarchy and x bit for bit equal), the CPU port at 96^3 beside the
   card's run at 96^3 (host setup, iterations within one), the 48^3 f64
   hierarchy against the host builder (C/F splits, rows and nonzeros equal, P and R to 1e-12, the
   coarse operators to 1e-11), 64^3 f64 against the CPU (iterations
   equal, x to rtol 1e-9), and,
   card against CPU, the MULTIPASS variant at 96^3, ENERGYMIN and RCM
   reordering (of a shuffled Poisson matrix) at 32^3 (the D2 +
   aggressive + interp_max_elements 4 hierarchy is phase 7's).
7. pcg_classical_cheby: ``PCG_CLASSICAL_CHEB`` (PCG_CLASSICAL with D2
   interpolation, aggressive coarsening of level 0, 4 interpolation
   elements, and CHEBYSHEV of order 2 over JACOBI_L1 as smoother) on
   ``poisson_3d_7pt(128)`` in f32, setup on the card; lmax per level,
   the launch counts (each Chebyshev sweep of order k is k A-SpMVs, each
   smoothed level's power iteration 20 at setup) and a trace; the CPU
   port at 128^3 (iterations within one); 64^3 f64 with the card's
   hierarchy carried to the CPU (iterations equal, x to rtol 1e-9,
   lmax to rtol 1e-9, the true residual at the tolerance).
8. idr_dilu: ``IDR_DILU_CFG`` (IDR(8) + one MULTICOLOR_DILU sweep) on
   ``poisson_3d_7pt(128)`` in f32: colours, the ``dia_spmv`` count (s + 1
   an iteration and the initial residual), a trace; the CPU port at
   96^3 f32 (status and monitored residual: in f32 IDR(8)'s recurred
   residual parts from the true one and its iterations move by several
   with the summation order); 128^3 f64 on the card (the true residual
   at the tolerance); 64^3 f64 against the CPU (iterations equal, x to
   rtol 1e-9, the true residual at the tolerance).
9. gmres_ilu0: ``GMRES_ILU0_CFG`` (BASELINE.md acceptance config 4:
   GMRES(30) + ILU(0)) on the 108^3 upwind convection-diffusion operator
   (``convection_diffusion_3d``, the size and stencil of atmosmodd) in
   f64: colours, the ILU factorization's host time, the ``dia_spmv``
   count (one an iteration and one a restart cycle), a trace; the CPU
   port at 108^3; 64^3 against the CPU; ILU(0) and ILU(1) at 64^3
   (colours of each fill pattern, factorization time, iterations).
10. pbicgstab_agg_w: ``PBICGSTAB_AGG_W_CFG`` (PBICGSTAB + aggregation
   AMG W-cycle, ``error_scaling`` 2, BLOCK_JACOBI 2+2, DENSE_LU) on
   ``poisson_3d_7pt(128)`` in f32: levels, visits a cycle, launches
   against :func:`cycle_walk` (a dry walk of the cycle, itself held to
   the cycle's counted A-SpMVs), a trace; the CPU port at 128^3
   (iterations within one); 64^3 f64 against the CPU.  The 32^3 solver
   matrix (phase 5) runs ``error_scaling`` 3-5, an F-cycle and CGF.
11. amg_classical_kcycle: ``AMG_CLASSICAL_CG_CFG`` (AMG as the outer
   solver, classical, a CG K-cycle of 2 iterations) at 128^3 f32, setup
   on the card: levels, visits, launches as walked, a trace; the CPU
   port at 128^3; 64^3 f64 with the device setup on both.
12. pcg_agg_resetup: the bench config with ``structure_reuse_levels``
   -1 set up once, then ``replace_values`` (timed by CUDA events),
   ``resetup`` and ``solve`` three times, on variable-coefficient
   diffusion (DIA, beside a fresh setup without plans on each A_k) and
   on MATRIX_FREE heat steps (x bit for bit the DIA hierarchy's): plans
   and their
   device bytes, ``rap_plan`` / ``rap_execute`` seconds, the coarse
   operators against scipy's R A P, launches as derived, two resetups
   bit for bit, the CPU port's sequence; 64^3 f64 against the CPU;
   classical reuse at 64^3 f64 (plans per level, iterations).
13. Prints the per-kernel summary line (each kernel's launches on every
   path; ``launches`` is those on its own path: the bench PCG slice for
   ``dia_spmv`` and ``ell_spmv``, the MATRIX_FREE slice for
   ``stencil_spmv``, the classical slice for ``sell_spmv``), then the
   device line last.  Each phase's seconds print on a ``phase_s``
   line.

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

# PCG_CLASSICAL with the BLOCK_JACOBI smoother replaced by CHEBYSHEV
# (order 2, lambda by power iteration) over JACOBI_L1, and the D2 +
# aggressive coarsening truncated to 4 interpolation elements: the
# shape of AmgX's AMG_CLASSICAL_AGGRESSIVE_CHEB_L1_TRUNC
PCG_CLASSICAL_CHEB = PCG_CLASSICAL.replace(
    '"monitor_residual": 0,',
    '"monitor_residual": 0, "interpolator": "D2", "aggressive_levels": 1,'
    ' "interp_max_elements": 4,', 1,
).replace(
    '"smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}',
    '"smoother": {"scope": "cheb", "solver": "CHEBYSHEV",'
    ' "chebyshev_polynomial_order": 2, "chebyshev_lambda_estimate_mode": 2,'
    ' "max_iters": 1, "monitor_residual": 0,'
    ' "preconditioner": {"scope": "l1", "solver": "JACOBI_L1",'
    ' "max_iters": 1, "monitor_residual": 0}}',
)

# IDR(8) preconditioned by one MULTICOLOR_DILU sweep: the shape of
# AmgX's IDR_DILU
IDR_DILU_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "IDR",'
    ' "subspace_dim_s": 8, "max_iters": 200, "tolerance": 1e-6,'
    ' "convergence": "RELATIVE_INI", "norm": "L2", "monitor_residual": 1,'
    ' "preconditioner": {"scope": "dilu", "solver": "MULTICOLOR_DILU",'
    ' "max_iters": 1, "monitor_residual": 0}}}'
)

# BASELINE.md acceptance config 4 (ci/acceptance.py, tests/
# test_nonsymmetric.py): GMRES(30) preconditioned by one ILU(0) sweep
GMRES_ILU0_CFG = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "GMRES", "gmres_n_restart": 30,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "tolerance": 1e-08, "max_iters": 200,'
    ' "preconditioner": {"scope": "ilu",'
    ' "solver": "MULTICOLOR_ILU", "ilu_sparsity_level": 0,'
    ' "max_iters": 1, "monitor_residual": 0}}}'
)


# PBICGSTAB around an aggregation-AMG W-cycle with scaled coarse
# correction (error_scaling 2), SIZE_8, BLOCK_JACOBI 2+2, DENSE_LU: the
# shape of AmgX's PBICGSTAB_AGGREGATION_W_JACOBI
PBICGSTAB_AGG_W_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PBICGSTAB",'
    ' "max_iters": 100, "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
    ' "monitor_residual": 1, "norm": "L2", "use_scalar_norm": 1,'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8", "cycle": "W",'
    ' "error_scaling": 2, "max_iters": 1, "presweeps": 2, "postsweeps": 2,'
    ' "min_coarse_rows": 32, "max_levels": 50,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "monitor_residual": 0,'
    ' "smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}}}}'
)

# AMG as the outer solver, classical (AHAT / PMIS / D1), a CG K-cycle of
# 2 iterations, BLOCK_JACOBI 1+1: the shape of AmgX's AMG_CLASSICAL_CG
AMG_CLASSICAL_CG_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "AMG",'
    ' "algorithm": "CLASSICAL", "cycle": "CG", "cycle_iters": 2,'
    ' "max_iters": 100, "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
    ' "monitor_residual": 1, "norm": "L2", "max_levels": 100,'
    ' "presweeps": 1, "postsweeps": 1,'
    ' "smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}}}'
)

# the bench config and its MATRIX_FREE form with every Galerkin product
# planned for a values-only resetup
REUSE = '"cycle": "V", "structure_reuse_levels": -1,'
REUSE_CFG = BENCH_CFG.replace('"cycle": "V",', REUSE)
MF_REUSE_CFG = MF_CFG.replace('"cycle": "V",', REUSE)


def convection_diffusion_3d(n, peclet=20.0, velocity=(1.0, 0.5, 0.25)):
    """-Lap(u) + c . grad(u) on an n^3 grid, first-order upwind, 7
    points (the 3D form of tests/test_nonsymmetric.py's operator), with
    c = velocity x peclet: nonsymmetric, x fastest.  At n = 108 it has
    the size and stencil of SuiteSparse's atmosmodd (1,270,432 rows)."""
    import scipy.sparse as sps

    h = 1.0 / (n + 1)
    c = [peclet * v for v in velocity]
    main = 6.0 + h * sum(abs(v) for v in c)
    one = np.ones(n)
    eye = sps.eye_array(n, format="csr")

    def axis(v, diag):
        lo = -1.0 - h * max(v, 0.0)
        hi = -1.0 + h * min(v, 0.0)
        return sps.diags_array([lo * one[1:], diag * one, hi * one[1:]],
                               offsets=[-1, 0, 1], format="csr")

    A = (sps.kron(eye, sps.kron(eye, axis(c[0], main)))
         + sps.kron(eye, sps.kron(axis(c[1], 0.0), eye))
         + sps.kron(axis(c[2], 0.0), sps.kron(eye, eye))).tocsr()
    A.eliminate_zeros()
    A.sort_indices()
    return A


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
            "sell_spmv": "sell_spmv_kernel", "stencil_spmv": "stencil_"}

# kernel-vs-plain tolerance on max|y_kernel - y_plain| / max|y_plain|:
# both sum in the same order from +0.0; the kernel contracts each
# multiply-add into one FMA, the plain version rounds twice
TOL = {"float32": 1e-5, "float64": 1e-13}


def timed(name, fn, *args):
    """``fn(*args)``, printing its seconds on a ``phase_s`` line."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(json.dumps({"phase_s": {name: time.perf_counter() - t0}}),
          flush=True)
    return out


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


def rel_err(y, yp):
    """(max |y - yp|, that over max |yp|)."""
    err = float((y - yp).abs().max()) if y.numel() else 0.0
    scale = float(yp.abs().max()) if y.numel() else 0.0
    return err, (err / scale if scale > 0 else err)


def kernel_case(torch, timer, peaks, name, label, run, plain, csr, nbytes,
                nops, dtype, extra=None, others=()):
    """Compare one kernel with its plain version on the card (and with
    each ``(name, fn)`` of ``others``, the plain versions of other
    layouts of the same matrix), time the kernel, the plain version and
    the library CSR product, and return the case's record (``extra``
    adds fields to it)."""
    y = run()
    yp = plain()
    torch.cuda.synchronize()
    check(y.shape == yp.shape, f"{label}: shape {y.shape} vs {yp.shape}")
    check(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
    err, rel = rel_err(y, yp)
    tol = TOL[str(dtype).replace("torch.", "")]
    check(rel <= tol, f"{label}: kernel vs plain rel err {rel:.3e} > {tol}")
    vs_others = {}
    for oname, fn in others:
        _, orel = rel_err(y, fn())
        vs_others[f"max_rel_err_vs_{oname}"] = orel
        check(orel <= tol,
              f"{label}: kernel vs {oname} rel err {orel:.3e} > {tol}")
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
        **vs_others, **(extra or {}),
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


def sell_info(S, entries):
    """The sliced layout's plan and size: window, lanes, slices, stored
    slots (slice padding included) and their ratio to the matrix's
    stored CSR entries, device bytes (beside the slot-major arrays)."""
    return {"sigma": S.sigma, "lanes": S.lanes, "slices": S.n_slices,
            "stored": S.stored,
            "stored_per_entry": S.stored / max(entries, 1),
            "bytes": S.nbytes()}


def ell_kernel_case(torch, timer, peaks, rng, label, sp, dtype,
                    extra=None, sweep=False):
    """The ELL kernels on the scipy matrix ``sp`` with a random x from
    ``rng``: the slot-major ``ell_spmv``, and where the upload builds
    the sliced layout ``sell_spmv`` too, each against the plain
    versions of both layouts.  Returns the case records.  The bound
    counts the operator's nonzeros (a column index and a value each, x
    and y once), not the slots a kernel reads: ``padded_bytes`` gives
    those.  ``sweep`` adds the sliced kernel's time at every lane count
    and at every window the layout may take."""
    import dataclasses

    from amgx_tpu_torch.core import matrix as cm
    from amgx_tpu_torch.ops import ell

    A = cm.SparseMatrix.from_scipy(sp.astype(dtype), device="cuda",
                                   accel_formats=("ell",))
    check(A.has_ell, f"{label}: not ELL")
    x = torch.from_numpy(rng.standard_normal(A.n_cols).astype(dtype))
    x = x.cuda()
    w, n = A.ell_vals.shape
    isz = A.ell_vals.element_size()
    nz = int(sp.count_nonzero())
    csr = (*csr_of(torch, sp, dtype), x)
    nbytes = (4 + isz) * nz + isz * (n + A.n_cols)
    S = A.sell

    def slot_plain():
        return ell.ell_spmv_plain(A.ell_cols, A.ell_vals, x)

    def sell_plain():
        return ell.sell_spmv_plain(S, x)

    recs = [kernel_case(
        torch, timer, peaks, "ell_spmv", label,
        lambda: ell.ell_spmv(A.ell_cols, A.ell_vals, x), slot_plain, csr,
        nbytes=nbytes, nops=2 * nz, dtype=A.ell_vals.dtype,
        extra={"nonzeros": nz, "width": w,
               "padded_bytes": (4 + isz) * w * n + isz * (n + A.n_cols),
               **(extra or {})},
        others=() if S is None else (("sell_spmv_plain", sell_plain),),
    )]
    if S is None:
        return recs
    info = sell_info(S, A.nnz)
    more = {}
    if sweep:
        lanes = {f"lanes={k}": timer(lambda k=k: ell.sell_spmv(
            dataclasses.replace(S, lanes=k), x)) for k in (1, 2, 4, 8)}
        windows = {}
        ro, ci, vals = A._host
        for sigma in cm.SELL_SIGMAS:
            Ss = cm.sliced_ell(cm._build_sell_np(
                ro, ci, vals, n, w, sigmas=(sigma,), always=True), "cuda")
            Ss.lanes = S.lanes
            windows[f"sigma={sigma}"] = {
                "stored_per_entry": Ss.stored / max(A.nnz, 1),
                "ms": timer(lambda Ss=Ss: ell.sell_spmv(Ss, x))}
            del Ss
        more["sweep"] = {"lanes_at_own_sigma": lanes,
                         "sigma_at_own_lanes": windows}
    slot_ms = recs[0]["kernel_ms"]
    rec = kernel_case(
        torch, timer, peaks, "sell_spmv", label,
        lambda: ell.sell_spmv(S, x), sell_plain, csr,
        nbytes=nbytes, nops=2 * nz, dtype=A.ell_vals.dtype,
        extra={"nonzeros": nz, "width": w,
               "padded_bytes": cm.sell_stream_bytes(
                   S.widths.cpu().numpy(), n, isz, S.sigma)
               + isz * (n + A.n_cols),
               "sell": info, "slot_major_ms": slot_ms, **more,
               **(extra or {})},
        others=(("ell_spmv_plain", slot_plain),),
    )
    # speed targets, printed and not checked
    print(json.dumps({"targets": {
        "case": label, "sell_ms": rec["kernel_ms"],
        "ahead_of_slot_major": rec["kernel_ms"] <= slot_ms,
        "ahead_of_library": rec["kernel_ms"] < rec["library_ms"],
        "half_bound": rec["kernel_ms"] <= 2 * rec["bound_ms"]}}),
        flush=True)
    recs.append(rec)
    return recs


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

    def ell_case(label, sp, dtype, ref_ms=None):
        out = ell_kernel_case(torch, timer, peaks, rng, label, sp, dtype)
        if ref_ms is not None:
            # an aggregation shape: no slower than the slot-major time
            # PERF.md records by more than 3 % (printed, not checked)
            ms = out[0]["kernel_ms"]
            print(json.dumps({"targets": {
                "case": label, "ms": ms, "perf_md_ms": ref_ms,
                "within_3_percent": ms <= 1.03 * ref_ms}}), flush=True)
        recs.extend(out)

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
    # the gmres_ilu0 path's operator: nonsymmetric, 7 diagonals, f64
    dia_case("convection-diffusion 108^3 f64", convection_diffusion_3d(108),
             np.float64)
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
    ell_case(f"level0 P {nf}x{nc} w=1 f32", P, np.float32, 0.014752)
    ell_case(f"level0 R {nc}x{nf} w=8 f32", P.T.tocsr(), np.float32,
             0.013600)
    # and of the FGMRES_AGGREGATION hierarchy: SIZE_2, 2x1x1 aggregates
    agg = geo_aggregate(N, N, N, 1)
    nc = int(agg.max()) + 1
    P = sps.csr_matrix((np.ones(nf), (np.arange(nf), agg)), shape=(nf, nc))
    ell_case(f"level0 SIZE_2 P {nf}x{nc} w=1 f32", P, np.float32, 0.015552)
    ell_case(f"level0 SIZE_2 R {nc}x{nf} w=2 f32", P.T.tocsr(), np.float32,
             0.014560)
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
    sell_edge_cases(torch, rng)
    return recs


def sell_edge_cases(torch, rng):
    """The sliced kernel on layouts built whether or not the upload
    would take them, at every window and lane count, against the plain
    versions of both layouts (untimed): n not a multiple of 32 with
    empty rows and rows up to 128 entries, a single row of width 128,
    uniform widths 1, 2 and 8, rectangular, f32 and f64."""
    import scipy.sparse as sps

    from amgx_tpu_torch.amg.aggregation import geo_aggregate
    from amgx_tpu_torch.core import matrix as cm
    from amgx_tpu_torch.ops import ell

    def rand(m, k, top):
        lens = rng.integers(0, top + 1, m)
        lens[rng.random(m) < 0.2] = 0
        r = np.repeat(np.arange(m), lens)
        c = rng.integers(0, k, r.shape[0])
        sp = sps.csr_matrix((rng.standard_normal(r.shape[0]), (r, c)),
                            shape=(m, k))
        sp.sum_duplicates()
        return sp

    def transfer(mode):
        agg = geo_aggregate(16, 16, 16, mode)
        return sps.csr_matrix((np.ones(agg.shape[0]),
                               (np.arange(agg.shape[0]), agg)))

    P = transfer(3)
    cases = [("1007 rows, widths 0-128, empty rows", rand(1007, 1007, 128)),
             ("rect 3001x700, widths 0-40", rand(3001, 700, 40)),
             ("one row of width 128", sps.csr_matrix(
                 (rng.standard_normal(128), (np.zeros(128, int),
                                             np.arange(128))),
                 shape=(1, 500))),
             ("uniform w=1 (P 16^3)", P), ("uniform w=8 (R 16^3)",
                                           P.T.tocsr()),
             ("uniform w=2 (SIZE_2 R 16^3)", transfer(1).T.tocsr())]
    out = []
    for label, sp in cases:
        for dtype in (np.float32, np.float64):
            sp = sp.astype(dtype)
            sp.sort_indices()
            A = cm.SparseMatrix.from_scipy(sp, device="cuda",
                                           accel_formats=("ell",))
            check(A.has_ell, f"{label}: not ELL")
            w, n = A.ell_vals.shape
            x = torch.from_numpy(rng.standard_normal(A.n_cols).astype(dtype))
            x = x.cuda()
            yp = ell.ell_spmv_plain(A.ell_cols, A.ell_vals, x)
            tol = TOL[np.dtype(dtype).name]
            for sigma in cm.SELL_SIGMAS:
                S = cm.sliced_ell(cm._build_sell_np(
                    *A._host, n, w, sigmas=(sigma,), always=True), "cuda")
                ys = ell.sell_spmv_plain(S, x)
                check(torch.equal(ys, yp),
                      f"{label} sigma {sigma}: sliced plain != slot-major")
                for lanes in (1, 2, 4, 8):
                    S.lanes = lanes
                    y = ell.sell_spmv(S, x)
                    torch.cuda.synchronize()
                    _, rel = rel_err(y, yp)
                    out.append(rel)
                    check(rel <= tol, f"{label} {np.dtype(dtype).name} "
                          f"sigma {sigma} lanes {lanes}: rel err {rel:.3e}")
                    if lanes == 1:
                        # one lane a row sums as the slot-major kernel
                        yk = ell.ell_spmv(A.ell_cols, A.ell_vals, x)
                        check(torch.equal(y, yk), f"{label} sigma {sigma}: "
                              "one lane a row differs from ell_spmv")
    print(json.dumps({"sell_edge_cases": {
        "checked": len(out), "max_rel_err": max(out)}}), flush=True)


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
    under the first label one of whose fragments its name holds (so
    "sell_spmv" goes before "ell_spmv", which it contains), the others
    under "rest".  Prints "not measured" when the profiler
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
    N = SLICE_N
    # ---- the main path: counts zeroed just before, read just after
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on("cuda", BENCH_CFG, N,
                                            np.float32)
    launches = kernel_counts()
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
    # the aggregation transfers keep the slot-major layout
    check(launches["sell_spmv"] == 0,
          f"sell_spmv launched {launches['sell_spmv']} times")

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
    N = SLICE_N
    # ---- the main path: counts zeroed just before, read just after
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on("cuda", MF_CFG, N, np.float32,
                                            accel_formats=MF_FORMATS)
    launches = kernel_counts()
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
    # the solvers the seventh slice ported: IDRMSYNC as the outer
    # solver around the SIZE_8 AMG (as a smoother, a one-cycle Krylov
    # method inside FGMRES, its iteration count moves with the summation
    # order even in f64: 14-17 on the CPU with 1-8 threads), the other
    # smoothers in the PCG + SIZE_2 AMG, SSTEP_PCG around the SIZE_8
    # AMG, the INEXACT coarse solver and the three scalers
    cases.append(("IDRMSYNC+AMG(SIZE_8)", BENCH_CFG.replace(
        '"solver": "PCG", "max_iters": 100',
        '"solver": "IDRMSYNC", "max_iters": 200')))
    for name, extra in (
            ("CHEBYSHEV_POLY", ""), ("POLYNOMIAL", ""),
            ("KPZ_POLYNOMIAL", ""), ("OPT_POLYNOMIAL", ""),
            ("CF_JACOBI", ""), ("KACZMARZ", "")):
        cases.append((f"PCG+AMG(SIZE_2,{name})", pcg_size2.replace(
            '"solver": "BLOCK_JACOBI",', f'"solver": "{name}"{extra},')))
    cases.append(("SSTEP_PCG(s=4)+AMG(SIZE_8)", BENCH_CFG.replace(
        '"solver": "PCG", "max_iters": 100',
        '"solver": "SSTEP_PCG", "s_step": 4, "max_iters": 200')))
    cases.append(("PCG+AMG(SIZE_8,INEXACT coarse)", BENCH_CFG.replace(
        '"coarse_solver": "DENSE_LU_SOLVER"', '"coarse_solver": "INEXACT"')))
    for scaling in ("DIAGONAL_SYMMETRIC", "BINORMALIZATION",
                    "NBINORMALIZATION"):
        cases.append((f"PCG+AMG(SIZE_8) scaling {scaling}", BENCH_CFG.replace(
            '"monitor_residual": 1,',
            f'"monitor_residual": 1, "scaling": "{scaling}",', 1)))
    # the eighth slice: error_scaling 3-5 on the W-cycle path, 2 on an
    # F-cycle, and the flexible K-cycle on the classical path
    for scaling in (3, 4, 5):
        cases.append((f"PBICGSTAB+AMG(SIZE_8,W,error_scaling {scaling})",
                      PBICGSTAB_AGG_W_CFG.replace(
                          '"error_scaling": 2', f'"error_scaling": {scaling}')))
    cases.append(("PBICGSTAB+AMG(SIZE_8,F,error_scaling 2)",
                  PBICGSTAB_AGG_W_CFG.replace('"cycle": "W"', '"cycle": "F"')))
    cases.append(("AMG(CLASSICAL,CGF)", AMG_CLASSICAL_CG_CFG.replace(
        '"cycle": "CG"', '"cycle": "CGF"')))
    return cases


# the counter each operator format's SpMV adds to (dense: a matmul; an
# ELL operator with its sliced layout: sell_spmv)
FORMAT_COUNTER = {"DIA": "dia_spmv", "ELL": "ell_spmv",
                  "MATRIX_FREE": "stencil_spmv", "CSR": "csr"}
COUNTERS = ("dia_spmv", "ell_spmv", "sell_spmv", "stencil_spmv", "csr")


def kernel_counts():
    """Every kernel wrapper's launch count, and the CSR products."""
    from amgx_tpu_torch.ops import dia, ell, spmv, stencil

    return {"dia_spmv": dia.launches, "ell_spmv": ell.launches,
            "sell_spmv": ell.sell_launches,
            "stencil_spmv": stencil.launches, "csr": spmv.csr_products}


def zero_counts():
    from amgx_tpu_torch.ops import dia, ell, spmv, stencil

    dia.launches = ell.launches = ell.sell_launches = 0
    stencil.launches = spmv.csr_products = 0


def counter_of(m):
    """The counter an operator's SpMV adds to, or None (dense)."""
    if m.format == "ELL" and m.sell is not None:
        return "sell_spmv"
    return FORMAT_COUNTER.get(m.format)


def cycle_walk(amg, sweep_spmvs=1):
    """SpMVs of one cycle of the AMG solver ``amg`` per operator, as
    ``{(level, "A" | "P" | "R"): count}``, from a dry walk of the
    cycle's structure in Python (``amg/hierarchy.py:make_cycle``; no
    wrapper's counter is read).  A visit of a level above the coarsest
    makes its presweeps and postsweeps (``sweep_spmvs`` A-SpMVs each),
    its residual, R and P; with ``error_scaling`` 2-3 also
    ``scaling_smoother_steps`` sweeps and one A e, with 4-5 twice
    ``max(postsweeps, 1)`` sweeps, a residual and one A e.  On the
    branch levels (above ``W_MAX_BRANCH_LEVELS`` and the last two) W
    visits the next level twice, F an F then a V visit, and a K-cycle
    runs ``cycle_iters`` (F)CG steps there: one visit and one A-SpMV a
    step (one visit at least).  The coarsest level makes one residual
    before its coarse solve, or its smoothing sweeps."""
    from amgx_tpu_torch.amg.hierarchy import W_MAX_BRANCH_LEVELS

    counts = {}
    lv = amg.levels
    last = len(lv) - 1
    es = amg.error_scaling

    def add(i, f, k):
        counts[(i, f)] = counts.get((i, f), 0) + k

    def visit(i, kind):
        if i == last:
            add(i, "A", 1 if amg.coarse_solver is not None
                else amg.coarsest_sweeps * sweep_spmvs)
            return
        pre, post = amg._level_sweeps(i)
        add(i, "A", (pre + post) * sweep_spmvs + 1)
        add(i, "R", 1)
        branch = i < min(last - 1, W_MAX_BRANCH_LEVELS)
        if kind == "W" and branch:
            visit(i + 1, "W")
            visit(i + 1, "W")
        elif kind == "F" and branch:
            visit(i + 1, "F")
            visit(i + 1, "V")
        elif kind in ("CG", "CGF") and branch:
            for _ in range(max(amg.cycle_iters, 1)):
                visit(i + 1, kind)
            add(i + 1, "A", amg.cycle_iters)
        else:
            visit(i + 1, kind)
        add(i, "P", 1)
        if es > 3:
            add(i, "A", 2 * max(amg.postsweeps, 1) * sweep_spmvs + 2)
        elif es >= 2:
            add(i, "A", max(amg.scaling_smoother_steps, 0) * sweep_spmvs
                + 1)

    visit(0, amg.cycle_type)
    return counts


def derived_launches(amg, cycles, top, sweep_spmvs=1, setup_spmvs=0):
    """``dia_spmv``, ``ell_spmv``, ``sell_spmv``, ``stencil_spmv``
    launches and CSR products of a setup and solve from its AMG
    hierarchy: ``top`` level-0 A-SpMVs outside the preconditioner and
    ``cycles`` cycles (:func:`cycle_walk`).  Each level with a smoother
    adds ``setup_spmvs`` A-SpMVs made by the smoother's setup (a power
    iteration)."""
    counts = dict.fromkeys(COUNTERS, 0)

    def add(m, k):
        c = counter_of(m)
        if c is not None:
            counts[c] += k

    lv = amg.levels
    add(lv[0].A, top)
    for (i, f), k in cycle_walk(amg, sweep_spmvs).items():
        add(getattr(lv[i], f), cycles * k)
    for lvl in lv:
        if lvl.smoother is not None:
            add(lvl.A, setup_spmvs)
    return counts


def fgmres_derived_launches(s, iters):
    """Launches of an FGMRES solve of ``iters`` iterations: r0 = b - A
    x0 once and one more residual per restart, one A z and one V-cycle
    per iteration."""
    restarts = -(-iters // s.restart)
    return derived_launches(s.precond, iters, restarts + iters)


def pcg_derived_launches(s, iters, **kw):
    """Launches of a PCG solve of ``iters`` iterations: r0 = b - A x0
    and one V-cycle before the loop, one A p and one V-cycle per
    iteration (``kw``: :func:`derived_launches`'s smoother costs)."""
    return derived_launches(s.precond, iters + 1, iters + 1, **kw)


def fgmres_phase(torch):
    """FGMRES_AGGREGATION (FGMRES + aggregation AMG + MULTICOLOR_DILU)
    at 128^3 f32 on the card, its CPU run, 64^3 f64 on both, a trace
    of one warm solve, and the 32^3 solver matrix."""
    N = SLICE_N
    # ---- A. the main path: counts zeroed just before, read just after
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on("cuda", FGMRES_CFG, N,
                                            np.float32)
    launches = kernel_counts()
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
    for k in ("dia_spmv", "ell_spmv", "sell_spmv"):
        check(launches[k] == derived[k],
              f"FGMRES {k} launches {launches[k]} != derived {derived[k]}")

    # ---- D. a trace of one warm solve
    # index_copy_ runs as an index_elementwise_kernel too: its own
    # fragment is tried before the gathers'
    trace_solve(torch, s, b, iters, groups={
        "dia_spmv": ["dia_spmv"], "sell_spmv": ["sell_spmv"],
        "ell_spmv": ["ell_spmv"], "index_copy": ["index_copy"],
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


def _sell(m):
    """The sliced layout's plan and size (its device bytes are the
    extra memory it takes beside the slot-major arrays)."""
    if m is None or m.sell is None:
        return None
    return sell_info(m.sell, m.nnz)


def classical_levels(amg):
    """Per level: rows, nnz, format, ELL width and sliced layout of A;
    format, nnz, ELL width, sliced layout and longest row of P and
    R."""
    out = []
    for lvl in amg.levels:
        rec = {"rows": lvl.n_rows, "nnz": lvl.nnz, "format": lvl.A.format,
               "ell_width": _width(lvl.A), "sell": _sell(lvl.A),
               "max_row": int(np.diff(lvl.A._host[0]).max())}
        for f in ("P", "R"):
            m = getattr(lvl, f)
            if m is not None:
                rec[f] = {"format": m.format, "nnz": m.nnz,
                          "ell_width": _width(m), "sell": _sell(m),
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


def ell_operators(amg, iters, sweep_spmvs=1, setup_spmvs=0):
    """(label, matrix, launches per PCG setup and solve of ``iters``
    iterations) of every ELL operator of the AMG hierarchy ``amg``, as
    :func:`pcg_derived_launches` counts them."""
    cycles = iters + 1
    walk = cycle_walk(amg, sweep_spmvs)
    out = []
    for lvl in amg.levels:
        i = lvl.level_id
        for f in ("A", "P", "R"):
            m = getattr(lvl, f)
            if m is None or m.format != "ELL":
                continue
            per = cycles * walk.get((i, f), 0)
            if f == "A":
                per += (cycles if i == 0 else 0) + (
                    setup_spmvs if lvl.smoother is not None else 0)
            out.append((f"level{i} {f}", m, per))
    return out


def classical_kernel_cases(torch, timer, peaks, rng, amg, iters):
    """The ELL kernel cases of the classical hierarchy ``amg``: every
    ELL operator in f32 (both kernels, the sliced one also at every
    lane count and window), the level-1 A in f64, and the level-1 A
    renumbered by RCM (``ops/reorder.py``), a measurement only: no
    path renumbers coarse levels."""
    import scipy.sparse as sps

    from amgx_tpu_torch.ops.reorder import rcm_permutation

    recs = []
    ops = ell_operators(amg, iters)
    for label, m, per_solve in ops:
        recs += ell_kernel_case(
            torch, timer, peaks, rng,
            f"classical {label} {m.n_rows}x{m.n_cols} w={_width(m)} f32",
            m.host_csr(), np.float32, sweep=True,
            extra={"launches_per_solve": per_solve})
    for label, m, per_solve in ops:
        if label != "level1 A":
            continue
        sp = m.host_csr()
        recs += ell_kernel_case(
            torch, timer, peaks, rng,
            f"classical {label} {m.n_rows}x{m.n_cols} w={_width(m)} f64",
            sp.astype(np.float64), np.float64,
            extra={"launches_per_solve": "f64 cells"})
        perm = rcm_permutation(sp)
        rcm = sps.csr_matrix(sp[perm][:, perm])
        rcm.sort_indices()
        lens = np.diff(sp.indptr)
        recs += ell_kernel_case(
            torch, timer, peaks, rng,
            f"classical {label} RCM {m.n_rows}x{m.n_cols} f32", rcm,
            np.float32,
            extra={"launches_per_solve": "measurement only",
                   "bandwidth": int(np.abs(
                       rcm.indices - np.repeat(np.arange(rcm.shape[0]),
                                               np.diff(rcm.indptr))).max()),
                   "bandwidth_before": int(np.abs(
                       sp.indices - np.repeat(np.arange(sp.shape[0]),
                                              lens)).max())})
    return recs


def classical_phase(torch, peaks=None, device="cuda", n=SLICE_N,
                    n_cmp=48, n_f64=64, n_small=32, n_cpu=96):
    """PCG_CLASSICAL at ``n``^3 f32 with its setup on ``device`` (the
    main path of this slice), the ELL kernel at its shapes, a trace,
    determinism, the CPU port at ``n_cpu``^3 (against the device's run
    at that size), the hierarchy against the host builder at
    ``n_cmp``^3 f64, ``n_f64``^3 f64 against the CPU, and the other
    selector / interpolator / reordering paths (MULTIPASS at
    ``n_cpu``^3).  ``peaks`` None (a rehearsal on the CPU) skips the
    kernel cases and the trace."""
    from amgx_tpu_torch.amg import classical, device_setup
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_rhs
    from amgx_tpu_torch.ops import spmv

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
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on(device, PCG_CLASSICAL, n,
                                            np.float32, info=info)
    launches = kernel_counts()
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
        # ---- the ELL kernels at every ELL operator of this hierarchy,
        # with the launches one solve gives each
        timer = Timer(torch)
        rng = np.random.default_rng(1)
        recs += classical_kernel_cases(torch, timer, peaks, rng, amg, iters)
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
            "dia_spmv": ["dia_spmv"], "sell_spmv": ["sell_spmv"],
            "ell_spmv": ["ell_spmv"], "csr": ["egment"], "dense": ["gemv", "gemm", "dot_kernel"],
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

    # ---- 2. the CPU port (AUTO: the host builder there) at n_cpu^3,
    # beside the device's run at that size
    if n_cpu != n:
        _, res, _, b, _ = solve_on(device, PCG_CLASSICAL, n_cpu, np.float32)
        iters, x = int(res.iters), res.x.cpu().numpy()
    sc, rc, setup_c, _, _ = solve_on("cpu", PCG_CLASSICAL, n_cpu, np.float32)
    xc = rc.x.numpy()
    print(json.dumps({"classical_cpu": {
        "n": n_cpu, "iterations": int(rc.iters), "card_iterations": iters,
        "status": int(rc.status), "setup_s": setup_c,
        "solve_s": sc.solve_time,
        "levels": [(lv.n_rows, lv.nnz) for lv in sc.precond.levels],
        "true_rel_residual_f64": true_rel_residual(n_cpu, b, xc),
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

    # (D2 + aggressive coarsening + 4 interpolation elements at n^3, on
    # the card and the CPU: the pcg_classical_cheby path, cheby_phase)
    sg = card_and_cpu(f"{n_cpu}^3 f32 PCG_CLASSICAL MULTIPASS", poisson_run(
        classical_cfg(', "interpolator": "MULTIPASS"'), n_cpu))
    device_built(sg.precond, "MULTIPASS")
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


def monitored_ratio(res):
    """The monitored residual at the end over the one at the start:
    what the config's tolerance (RELATIVE_INI) bounds."""
    return float(np.max(res.final_norm) / np.max(res.initial_norm))


def check_launches(label, launches, derived, device):
    """Each counter equal to its derived count (the wrappers count only
    launches on the card)."""
    for k in launches:
        check(launches[k] == derived[k] or device != "cuda",
              f"{label} {k} launches {launches[k]} != derived {derived[k]}")


def f64_vs_cpu(label, run, device):
    """``run(dev) -> (solver, result, true residual)`` on ``device`` and
    on the CPU in f64: iterations equal, x to rtol 1e-9, status 0 and
    the true residual at the config's tolerance on both."""
    sg, rg, resg = run(device)
    sc, rc, resc = run("cpu")
    xg, xc = rg.x.cpu().numpy(), rc.x.numpy()
    d = float(np.abs(xg - xc).max())
    tol = sg.tolerance
    print(json.dumps({f"{label}_f64": {
        "iterations": int(rg.iters), "cpu_iterations": int(rc.iters),
        "status": int(rg.status), "cpu_status": int(rc.status),
        "true_rel_residual_f64": resg, "cpu_true_rel_residual_f64": resc,
        "max_abs_diff_vs_cpu": d, "x_inf": float(np.abs(xc).max())}}),
        flush=True)
    check(int(rg.status) == 0 and int(rc.status) == 0,
          f"{label} f64: status card {rg.status} cpu {rc.status}")
    check(int(rg.iters) == int(rc.iters),
          f"{label} f64: iterations card {rg.iters} vs cpu {rc.iters}")
    check(np.allclose(xg, xc, rtol=1e-9,
                      atol=1e-9 * float(np.abs(xc).max())),
          f"{label} f64: x card vs cpu, max abs diff {d:.3e}")
    check(resg <= tol and resc <= tol,
          f"{label} f64: true residual {resg:.3e} / {resc:.3e} > {tol}")
    return sg, sc


def cheby_phase(torch, peaks=None, device="cuda", n=SLICE_N, n_cmp=SLICE_N,
                n_f64=64):
    """pcg_classical_cheby: PCG + classical AMG (D2, aggressive level 0,
    4 interpolation elements) smoothed by CHEBYSHEV of order 2 over
    JACOBI_L1 (``PCG_CLASSICAL_CHEB``) at ``n``^3 f32 with its setup on
    ``device``: levels, lmax per level, launches (each Chebyshev sweep
    of order k is k A-SpMVs, each level's power iteration at setup 20),
    a trace of a warm solve and (given ``peaks``) the ELL kernels at each
    ELL operator; the CPU port at ``n_cmp``^3 (iterations within one);
    ``n_f64``^3 f64 with the card's hierarchy carried to the CPU
    (iterations equal, x to rtol 1e-9, lmax to rtol 1e-9).  Returns the
    launches and the kernel case records."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.amg.hierarchy import hierarchy_from_numpy
    from amgx_tpu_torch.solvers.chebyshev import POWER_STEPS

    cfg = PCG_CLASSICAL_CHEB
    # ---- the main path: counts zeroed just before, read just after
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on(device, cfg, n, np.float32)
    launches = kernel_counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    amg = s.precond
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat Chebyshev solve changed iters")
    warm_s = s.solve_time
    order = amg.levels[0].smoother.order
    derived = pcg_derived_launches(s, iters, sweep_spmvs=order,
                                   setup_spmvs=POWER_STEPS)
    rel = true_rel_residual(n, b, x)
    lam = [(lv.smoother.lmax, lv.smoother.lmin) if lv.smoother else None
           for lv in amg.levels]
    print(json.dumps({
        "slice": f"poisson7 {n}^3 f32 pcg_classical_cheby (PCG + classical "
                 "AMG D2 aggressive 1 interp_max_elements 4, CHEBYSHEV "
                 f"order {order} / JACOBI_L1, DENSE_LU) setup and solve on "
                 f"{device}",
        "levels": classical_levels(amg), "n_levels": len(amg.levels),
        "lmax_lmin": lam, "iterations": iters, "status": status,
        "upload_s": upload_s, "setup_s": setup_s,
        "setup_profile": amg.setup_profile, "setup_stats": amg.setup_stats,
        "solve_s": solve_s, "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": warm_s,
        "ms_per_iteration_warm": warm_s / max(iters, 1) * 1e3,
        "monitored_rel_residual": monitored_ratio(res),
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
        "repeat_solve_x_bitwise": bool(torch.equal(res.x, res2.x)),
    }), flush=True)
    check(status == 0, f"Chebyshev status {status}")
    check(monitored_ratio(res) <= s.tolerance,
          f"Chebyshev monitored residual {monitored_ratio(res):.3e}")
    check(rel <= 1e-5, f"Chebyshev true relative residual {rel:.3e} > 1e-5")
    stats = amg.setup_stats
    check(stats["host_fallback_levels"] == 0,
          "Chebyshev: a level fell back to the host builder")
    check(stats["device_levels"] == len(amg.levels) - 1 or device != "cuda",
          f"Chebyshev: {stats['device_levels']} device-built levels of "
          f"{len(amg.levels) - 1}")
    check_launches("Chebyshev", launches, derived, device)
    recs = []
    if peaks is not None:
        timer = Timer(torch)
        rng = np.random.default_rng(2)
        for label, m, per in ell_operators(amg, iters, sweep_spmvs=order,
                                           setup_spmvs=POWER_STEPS):
            recs += ell_kernel_case(
                torch, timer, peaks, rng,
                f"cheby {label} {m.n_rows}x{m.n_cols} w={_width(m)} f32",
                m.host_csr(), np.float32,
                extra={"launches_per_solve": per})
        del timer
        trace_solve(torch, s, b, iters, groups={
            "dia_spmv": ["dia_spmv"], "sell_spmv": ["sell_spmv"],
            "ell_spmv": ["ell_spmv"], "csr": ["egment"],
            "dense": ["gemv", "gemm", "dot_kernel"],
            "reduction": ["reduce_kernel"]})
    del s, res, res2, amg

    # ---- the CPU port (AUTO: the host builder there)
    sc, rc, setup_c, bc, _ = solve_on("cpu", cfg, n_cmp, np.float32)
    print(json.dumps({"cheby_cpu": {
        "n": n_cmp, "iterations": int(rc.iters), "status": int(rc.status),
        "setup_s": setup_c, "solve_s": sc.solve_time,
        "levels": [(lv.n_rows, lv.nnz) for lv in sc.precond.levels],
        "lmax_lmin": [(lv.smoother.lmax, lv.smoother.lmin) if lv.smoother
                      else None for lv in sc.precond.levels],
        "true_rel_residual_f64": true_rel_residual(
            n_cmp, bc, rc.x.numpy())}}), flush=True)
    check(int(rc.status) == 0, f"Chebyshev cpu status {rc.status}")
    check(abs(int(rc.iters) - iters) <= 1,
          f"Chebyshev f32 iterations card {iters} vs cpu {rc.iters}")
    del sc, rc

    # ---- n_f64^3 f64: the card's hierarchy carried to the CPU (the
    # host builder parts from the device pipeline at threshold ties)
    carried = {}

    def run(dev):
        # the first call sets up on ``device``, the second on the CPU
        if carried:
            sg = hierarchy_from_numpy(carried["levels"],
                                      T.AMGConfig.from_string(cfg),
                                      device="cpu")
            bg = carried["b"]
            rg = sg.solve(bg)
        else:
            sg, rg, _, bg, _ = solve_on(dev, cfg, n_f64, np.float64)
            carried["b"] = bg
            carried["levels"] = [
                {k: (*getattr(lv, k)._host, getattr(lv, k).shape)
                 for k in ("A", "P", "R") if getattr(lv, k) is not None}
                for lv in sg.precond.levels]
        return sg, rg, true_rel_residual(n_f64, bg, rg.x.cpu().numpy())

    sg, sc = f64_vs_cpu(f"cheby_{n_f64}^3", run, device)
    lg = [lv.smoother.lmax for lv in sg.precond.levels if lv.smoother]
    lc = [lv.smoother.lmax for lv in sc.precond.levels if lv.smoother]
    print(json.dumps({f"cheby_{n_f64}^3_f64_lmax": {"card": lg, "cpu": lc}}),
          flush=True)
    check(np.allclose(lg, lc, rtol=1e-9), f"lmax card {lg} vs cpu {lc}")
    return launches, recs


def idr_phase(torch, device="cuda", n=SLICE_N, n_cmp=96, n_f64=64):
    """idr_dilu: IDR(8) preconditioned by one MULTICOLOR_DILU sweep
    (``IDR_DILU_CFG``) on ``n``^3 f32: colours, launches (s + 1 A-SpMVs
    an iteration and the initial residual), a trace of a warm solve;
    the CPU port at ``n_cmp``^3 f32; ``n``^3 f64 on the device (the
    true residual); ``n_f64``^3 f64 against the CPU.  In f32 the
    recurred residual of IDR(8) parts from the true one (the solve stops
    on the recurred residual, which meets the tolerance, with a true
    residual orders above it, in the JAX package too) and last-bit
    differences move the iteration count by several: the f32 runs are
    held to their status and monitored residual, the f64 runs to the
    true residual and, at ``n_f64``^3, to the CPU's iterations and x."""
    cfg = IDR_DILU_CFG
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on(device, cfg, n, np.float32)
    launches = kernel_counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat IDR solve changed iters")
    warm_s = s.solve_time
    shadow = int(s._shadow.shape[0])
    derived = dict.fromkeys(COUNTERS, 0)
    derived[counter_of(s.A)] = 1 + (shadow + 1) * iters
    rel = true_rel_residual(n, b, x)
    print(json.dumps({
        "slice": f"poisson7 {n}^3 f32 idr_dilu (IDR({shadow}) + "
                 f"MULTICOLOR_DILU) on {device}",
        "format": s.A.format, "colors": s.precond.num_colors,
        "iterations": iters, "status": status, "upload_s": upload_s,
        "setup_s": setup_s, "dilu_setup_s": s.precond.setup_time,
        "solve_s": solve_s, "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": warm_s,
        "ms_per_iteration_warm": warm_s / max(iters, 1) * 1e3,
        "monitored_rel_residual": monitored_ratio(res),
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
        "repeat_solve_x_bitwise": bool(torch.equal(res.x, res2.x)),
    }), flush=True)
    check(status == 0, f"IDR status {status}")
    check(monitored_ratio(res) <= s.tolerance,
          f"IDR monitored residual {monitored_ratio(res):.3e}")
    check(bool(np.isfinite(x).all()), "IDR: non-finite x")
    check_launches("IDR", launches, derived, device)
    if device == "cuda":
        trace_solve(torch, s, b, iters, groups={
            "dia_spmv": ["dia_spmv"], "index_copy": ["index_copy"],
            "gather": ["index_elementwise", "gather", "index_select"],
            "reduction": ["reduce_kernel"],
            "small_dense": ["trsm", "trsv", "gemv", "gemm", "dot_kernel"]})
    del s, res, res2

    sc, rc, setup_c, bc, _ = solve_on("cpu", cfg, n_cmp, np.float32)
    print(json.dumps({"idr_cpu_f32": {
        "n": n_cmp, "iterations": int(rc.iters), "status": int(rc.status),
        "card_iterations": iters if n_cmp == n else None,
        "setup_s": setup_c, "solve_s": sc.solve_time,
        "colors": sc.precond.num_colors,
        "monitored_rel_residual": monitored_ratio(rc),
        "true_rel_residual_f64": true_rel_residual(
            n_cmp, bc, rc.x.numpy())}}), flush=True)
    check(int(rc.status) == 0, f"IDR cpu status {rc.status}")
    check(monitored_ratio(rc) <= sc.tolerance,
          f"IDR cpu monitored residual {monitored_ratio(rc):.3e}")
    del sc, rc

    # n^3 in f64 on the device: the true residual at the tolerance.  (At
    # this size even f64 IDR(8) amplifies the order of its sums: on the
    # CPU at 96^3 the torch thread count moves the residual history in
    # its fourth digit, so the count is printed, not held to the CPU's.)
    sg, rg, _, bg, _ = solve_on(device, cfg, n, np.float64)
    relg = true_rel_residual(n, bg, rg.x.cpu().numpy())
    print(json.dumps({f"idr_{n}^3_f64": {
        "iterations": int(rg.iters), "status": int(rg.status),
        "monitored_rel_residual": monitored_ratio(rg),
        "true_rel_residual_f64": relg, "solve_s": sg.solve_time}}),
        flush=True)
    check(int(rg.status) == 0, f"IDR {n}^3 f64 status {rg.status}")
    check(relg <= sg.tolerance,
          f"IDR {n}^3 f64 true residual {relg:.3e} > {sg.tolerance}")
    del sg, rg

    def run(dev):
        sg, rg, _, bg, _ = solve_on(dev, cfg, n_f64, np.float64)
        return sg, rg, true_rel_residual(n_f64, bg, rg.x.cpu().numpy())

    f64_vs_cpu(f"idr_{n_f64}^3", run, device)
    return launches


def gmres_ilu_phase(torch, device="cuda", n=108, n_cmp=108, n_f64=64,
                    n_ilu1=64):
    """gmres_ilu0: GMRES(30) + ILU(0) (``GMRES_ILU0_CFG``, BASELINE.md
    acceptance config 4) on the ``n``^3 upwind convection-diffusion
    operator in f64: colours, the ILU factorization's host time,
    launches (one A-SpMV an iteration and one residual a restart
    cycle), a trace of a warm solve; the CPU port at ``n_cmp``^3;
    ``n_f64``^3 against the CPU; ILU(1) at ``n_ilu1``^3."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.core.matrix import SparseMatrix

    def system(m):
        A = convection_diffusion_3d(m)
        return A, A @ np.random.default_rng(7).standard_normal(A.shape[0])

    def setup_solve(dev, m, text=GMRES_ILU0_CFG):
        Asp, bb = system(m)
        t0 = time.perf_counter()
        A = SparseMatrix.from_scipy(Asp, device=dev)
        up = time.perf_counter() - t0
        sg = T.create_solver(T.AMGConfig.from_string(text), "default",
                             device=dev)
        t0 = time.perf_counter()
        sg.setup(A)
        st = time.perf_counter() - t0
        return sg, sg.solve(bb), Asp, bb, up, st

    def rel_of(Asp, bb, xx):
        return float(np.linalg.norm(bb - Asp @ xx) / np.linalg.norm(bb))

    zero_counts()
    s, res, Asp, b, upload_s, setup_s = setup_solve(device, n)
    launches = kernel_counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat GMRES solve changed iters")
    warm_s = s.solve_time
    derived = dict.fromkeys(COUNTERS, 0)
    derived[counter_of(s.A)] = -(-iters // s.restart) + iters
    rel = rel_of(Asp, b, x)
    print(json.dumps({
        "slice": f"convection-diffusion {n}^3 ({Asp.shape[0]} rows, "
                 f"{Asp.nnz} nonzeros) f64 gmres_ilu0 (GMRES(30) + "
                 f"MULTICOLOR_ILU level 0) on {device}",
        "format": s.A.format, "colors": s.precond.num_colors,
        "pattern_nnz": s.precond.pattern_nnz,
        "ilu_setup_s": s.precond.setup_time,
        "iterations": iters, "status": status, "upload_s": upload_s,
        "setup_s": setup_s, "solve_s": solve_s,
        "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": warm_s,
        "ms_per_iteration_warm": warm_s / max(iters, 1) * 1e3,
        "monitored_rel_residual": monitored_ratio(res),
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
        "repeat_solve_x_bitwise": bool(torch.equal(res.x, res2.x)),
    }), flush=True)
    check(status == 0, f"GMRES status {status}")
    check(s.A.format == "DIA", f"GMRES operator format {s.A.format}")
    check(rel <= s.tolerance, f"GMRES true residual {rel:.3e}")
    check_launches("GMRES", launches, derived, device)
    if device == "cuda":
        trace_solve(torch, s, b, iters, groups={
            "dia_spmv": ["dia_spmv"], "index_copy": ["index_copy"],
            "gather": ["index_elementwise", "gather", "index_select"],
            "reduction": ["reduce_kernel"]})
    del s, res, res2

    sc, rc, _, _, _, setup_c = setup_solve("cpu", n_cmp)
    print(json.dumps({"gmres_cpu": {
        "n": n_cmp, "iterations": int(rc.iters), "status": int(rc.status),
        "setup_s": setup_c, "ilu_setup_s": sc.precond.setup_time,
        "solve_s": sc.solve_time, "colors": sc.precond.num_colors,
        "max_abs_diff_vs_card": (float(np.abs(x - rc.x.numpy()).max())
                                 if n_cmp == n else None)}}), flush=True)
    check(int(rc.status) == 0, f"GMRES cpu status {rc.status}")
    check(abs(int(rc.iters) - iters) <= 1,
          f"GMRES iterations card {iters} vs cpu {rc.iters}")
    del sc, rc

    def run(dev):
        sg, rg, Ag, bg, _, _ = setup_solve(dev, n_f64)
        return sg, rg, rel_of(Ag, bg, rg.x.cpu().numpy())

    f64_vs_cpu(f"gmres_ilu0_{n_f64}^3", run, device)

    ilu = []
    for level in (0, 1):
        text = GMRES_ILU0_CFG.replace('"ilu_sparsity_level": 0',
                                      f'"ilu_sparsity_level": {level}')
        sg, rg, Ag, bg, _, _ = setup_solve(device, n_ilu1, text)
        ilu.append({"ilu_sparsity_level": level,
                    "colors": sg.precond.num_colors,
                    "pattern_nnz": sg.precond.pattern_nnz,
                    "ilu_setup_s": sg.precond.setup_time,
                    "iterations": int(rg.iters), "status": int(rg.status),
                    "solve_s": sg.solve_time,
                    "true_rel_residual_f64": rel_of(
                        Ag, bg, rg.x.cpu().numpy())})
        check(int(rg.status) == 0, f"ILU({level}) {n_ilu1}^3 status")
    print(json.dumps({f"gmres_ilu_levels_{n_ilu1}^3": ilu}), flush=True)
    check(ilu[1]["iterations"] < ilu[0]["iterations"],
          "ILU(1) took no fewer iterations than ILU(0)")
    return launches


def scaled_cycle_derived(s, iters, outer):
    """Launches of a solve of ``iters`` iterations by solver ``s``:
    PBICGSTAB (one residual, then two A-SpMVs and two cycles an
    iteration), PCG (one residual and cycle, then one of each an
    iteration) or a monitored AMG (one residual, then a cycle and a
    residual an iteration); the cycles by :func:`cycle_walk`."""
    amg = s.precond if outer != "AMG" else s
    top, cycles = {"PBICGSTAB": (1 + 2 * iters, 2 * iters),
                   "PCG": (iters + 1, iters + 1),
                   "AMG": (iters + 1, iters)}[outer]
    return derived_launches(amg, cycles, top)


def visits_per_cycle(amg):
    """Visits of each level in one cycle (the dry walk's R and coarse
    counts)."""
    walk = cycle_walk(amg)
    last = len(amg.levels) - 1
    return [walk.get((i, "R"), 0) for i in range(last)] + [
        walk[(last, "A")] if amg.coarse_solver is not None else None]


def path_record(label, s, res, b, n, launches, derived, setup_s, upload_s,
                amg):
    """The JSON record and the common checks of one card path: status
    0, the true residual at 1e-5 and every counter at its derived
    count."""
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, f"repeat {label} solve changed iters")
    rel = true_rel_residual(n, b, x)
    rec = {
        "levels": amg.level_summary(), "n_levels": len(amg.levels),
        "visits_per_cycle": visits_per_cycle(amg),
        "cycle_passes_per_iteration": amg.cycle_passes_per_iteration(),
        "iterations": iters, "status": status, "upload_s": upload_s,
        "setup_s": setup_s, "setup_profile": amg.setup_profile,
        "setup_stats": amg.setup_stats, "solve_s": solve_s,
        "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": s.solve_time,
        "ms_per_iteration_warm": s.solve_time / max(iters, 1) * 1e3,
        "monitored_rel_residual": monitored_ratio(res),
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
        "repeat_solve_x_bitwise": bool(res.x.equal(res2.x)),
    }
    check(status == 0, f"{label} status {status}")
    check(rel <= 1e-5, f"{label} true relative residual {rel:.3e} > 1e-5")
    # the walk's square-operator SpMVs against those the cycle made
    walk_a = sum(k for (_, f), k in cycle_walk(amg).items() if f == "A")
    check(walk_a == rec["cycle_passes_per_iteration"],
          f"{label}: the dry walk counts {walk_a} A-SpMVs a cycle, the "
          f"cycle made {rec['cycle_passes_per_iteration']}")
    return rec, x


TRACE_GROUPS = {"dia_spmv": ["dia_spmv"], "sell_spmv": ["sell_spmv"],
                "ell_spmv": ["ell_spmv"], "stencil_spmv": ["stencil_"],
                "csr": ["egment"], "dense": ["gemv", "gemm", "dot_kernel",
                                             "trsm", "trsv"],
                "reduction": ["reduce_kernel"]}


def pbicgstab_w_phase(torch, device="cuda", n=SLICE_N, n_cmp=SLICE_N,
                      n_f64=64):
    """pbicgstab_agg_w: PBICGSTAB + aggregation-AMG W-cycle with
    error_scaling 2 (``PBICGSTAB_AGG_W_CFG``) at ``n``^3 f32 on
    ``device``: levels, W visits per cycle, launches against the dry
    walk (the extra A e and the scaling sweeps of each prolongation
    among them), a trace of a warm solve; the CPU port at ``n_cmp``^3
    (iterations within one); ``n_f64``^3 f64 against the CPU.  Returns
    the launches."""
    cfg = PBICGSTAB_AGG_W_CFG
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on(device, cfg, n, np.float32)
    launches = kernel_counts()
    iters = int(res.iters)
    derived = scaled_cycle_derived(s, iters, "PBICGSTAB")
    rec, x = path_record("PBICGSTAB W", s, res, b, n, launches, derived,
                         setup_s, upload_s, s.precond)
    print(json.dumps({
        "slice": f"poisson7 {n}^3 f32 pbicgstab_agg_w (PBICGSTAB + AMG "
                 "SIZE_8 W-cycle error_scaling 2, BLOCK_JACOBI 2+2, "
                 f"DENSE_LU) on {device}", **rec}), flush=True)
    check_launches("PBICGSTAB W", launches, derived, device)
    if device == "cuda":
        trace_solve(torch, s, b, iters, groups=TRACE_GROUPS)
    del s, res

    sc, rc, setup_c, bc, _ = solve_on("cpu", cfg, n_cmp, np.float32)
    print(json.dumps({"pbicgstab_w_cpu": {
        "n": n_cmp, "iterations": int(rc.iters), "status": int(rc.status),
        "setup_s": setup_c, "solve_s": sc.solve_time,
        "true_rel_residual_f64": true_rel_residual(
            n_cmp, bc, rc.x.numpy())}}), flush=True)
    check(int(rc.status) == 0, f"PBICGSTAB W cpu status {rc.status}")
    check(abs(int(rc.iters) - iters) <= 1 or n_cmp != n,
          f"PBICGSTAB W f32 iterations card {iters} vs cpu {rc.iters}")
    del sc, rc

    def run(dev):
        sg, rg, _, bg, _ = solve_on(dev, cfg, n_f64, np.float64)
        return sg, rg, true_rel_residual(n_f64, bg, rg.x.cpu().numpy())

    f64_vs_cpu(f"pbicgstab_w_{n_f64}^3", run, device)
    return launches


def kcycle_phase(torch, device="cuda", n=SLICE_N, n_cmp=SLICE_N, n_f64=64):
    """amg_classical_kcycle: AMG as the outer solver with classical
    levels and a CG K-cycle (``AMG_CLASSICAL_CG_CFG``) at ``n``^3 f32,
    the setup on ``device`` (AUTO: the device pipeline on the card):
    levels, visits per cycle, launches against the dry walk, a trace;
    the CPU port at ``n_cmp``^3 (host setup, iterations within one);
    ``n_f64``^3 f64 with ``setup_location`` DEVICE on both (iterations
    equal, x to rtol 1e-9).  Returns the launches."""
    cfg = AMG_CLASSICAL_CG_CFG
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on(device, cfg, n, np.float32)
    launches = kernel_counts()
    iters = int(res.iters)
    derived = scaled_cycle_derived(s, iters, "AMG")
    rec, x = path_record("K-cycle", s, res, b, n, launches, derived,
                         setup_s, upload_s, s)
    print(json.dumps({
        "slice": f"poisson7 {n}^3 f32 amg_classical_kcycle (AMG classical "
                 f"AHAT/PMIS/D1, cycle CG x{s.cycle_iters}, BLOCK_JACOBI "
                 f"1+1, DENSE_LU) setup and solve on {device}",
        "classical_levels": classical_levels(s), **rec}), flush=True)
    check(s.setup_stats["host_fallback_levels"] == 0,
          "K-cycle: a level fell back to the host builder")
    check(s.setup_stats["device_levels"] == len(s.levels) - 1
          or device != "cuda",
          f"K-cycle: {s.setup_stats['device_levels']} device-built levels")
    check_launches("K-cycle", launches, derived, device)
    if device == "cuda":
        trace_solve(torch, s, b, iters, groups=TRACE_GROUPS)
    del s, res

    sc, rc, setup_c, bc, _ = solve_on("cpu", cfg, n_cmp, np.float32)
    print(json.dumps({"kcycle_cpu": {
        "n": n_cmp, "iterations": int(rc.iters), "status": int(rc.status),
        "setup_s": setup_c, "solve_s": sc.solve_time,
        "levels": [(lv.n_rows, lv.nnz) for lv in sc.levels],
        "true_rel_residual_f64": true_rel_residual(
            n_cmp, bc, rc.x.numpy())}}), flush=True)
    check(int(rc.status) == 0, f"K-cycle cpu status {rc.status}")
    check(abs(int(rc.iters) - iters) <= 1 or n_cmp != n,
          f"K-cycle f32 iterations card {iters} vs cpu {rc.iters}")
    del sc, rc

    dev_cfg = cfg.replace('"algorithm": "CLASSICAL",',
                          '"algorithm": "CLASSICAL", '
                          '"setup_location": "DEVICE",')

    def run(dev):
        sg, rg, _, bg, _ = solve_on(dev, dev_cfg, n_f64, np.float64)
        return sg, rg, true_rel_residual(n_f64, bg, rg.x.cpu().numpy())

    f64_vs_cpu(f"kcycle_{n_f64}^3", run, device)
    return launches


def variable_diffusion_3d(n, seed):
    """-div(kappa grad u) on an n^3 grid, 7 points, x fastest: kappa =
    exp(0.5 xi) with xi i.i.d. N(0, 1) per cell from
    ``default_rng(seed)``, each face coefficient the harmonic mean of
    its two cells', a wall face the cell's own (Dirichlet walls as
    ``poisson_3d_7pt``, which is kappa = 1).  Scipy CSR, float64."""
    import scipy.sparse as sps

    kappa = np.exp(0.5 * np.random.default_rng(seed).standard_normal(
        (n, n, n)))
    N = n ** 3
    diag = np.zeros((n, n, n))
    diags, offsets = [], []
    for axis, stride in ((2, 1), (1, n), (0, n * n)):
        k = np.moveaxis(kappa, axis, -1)
        face = 2.0 * k[..., :-1] * k[..., 1:] / (k[..., :-1] + k[..., 1:])
        d = np.zeros_like(k)
        d[..., :-1] += face
        d[..., 1:] += face
        d[..., 0] += k[..., 0]
        d[..., -1] += k[..., -1]
        diag += np.moveaxis(d, -1, axis)
        # coupling of each cell to its upper neighbour (0 on the last
        # plane of the axis: no neighbour)
        up = np.zeros_like(k)
        up[..., :-1] = face
        up = np.moveaxis(up, -1, axis).reshape(-1)[:N - stride]
        diags += [-up, -up]
        offsets += [stride, -stride]
    A = sps.diags_array([diag.reshape(-1)] + diags, offsets=[0] + offsets,
                        format="csr")
    A.eliminate_zeros()
    A.sort_indices()
    return A


def heat_step_3d(n, dt):
    """A backward-Euler step of the heat equation, L + I / dt with L the
    7-point Laplacian of ``poisson_3d_7pt`` (scipy CSR, float64)."""
    import scipy.sparse as sps
    from amgx_tpu_torch.io.poisson import poisson_scipy

    A = (poisson_scipy((n, n, n)) + sps.eye_array(n ** 3) / dt).tocsr()
    A.sort_indices()
    return A


def rap_error(amg):
    """Largest |A_{i+1} - R_i A_i P_i| / max|R_i A_i P_i| over the
    levels, the product formed by scipy in float64 from the stored
    transfers and the level's operator, all read from the device."""
    worst = 0.0
    for i in range(len(amg.levels) - 1):
        lv, nxt = amg.levels[i], amg.levels[i + 1]
        f = lambda m: m.to_scipy().astype(np.float64)  # noqa: E731
        ref = (f(lv.R) @ f(lv.A) @ f(lv.P)).tocsr()
        d = abs(f(nxt.A) - ref)
        scale = float(abs(ref).max()) or 1.0
        worst = max(worst, float(d.max()) / scale if d.nnz else 0.0)
    return worst


def reuse_sequence(torch, device, cfg, n, dtype, systems, formats=None,
                   fresh=None, rap=True):
    """Set up ``cfg`` once on ``systems[0]`` (scipy CSR), then for each
    later system: ``A_k = A_0.replace_values(v_k)`` (the values uploaded
    as one tensor), ``resetup(A_k)``, ``solve(b)``.  Returns (solver,
    per-step records, the x of each step, the launches of the setup and
    every solve).  Each step checks the level count and formats, the
    coarse operators against scipy's R A P (1e-5 x max in f32, 1e-12
    in f64; unless ``rap`` is False), status 0 and the true residual.
    ``fresh`` (a config) also sets up a new solver of that config on
    each A_k (after the counts are read) for its upload, setup and
    iterations."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_rhs

    kw = {} if formats is None else {"accel_formats": formats}
    cuda = device == "cuda"
    b = poisson_rhs(n ** 3, dtype=dtype)
    zero_counts()
    A0 = SparseMatrix.from_scipy(systems[0].astype(dtype), device=device,
                                 **kw)
    s = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                        device=device)
    t0 = time.perf_counter()
    s.setup(A0)
    setup_s = time.perf_counter() - t0
    amg = s.precond
    shape = [(lv["rows"], lv["format"]) for lv in amg.level_summary()]
    plan = {"setup_s": setup_s,
            "plan_bytes": sum(lv.rap_plan.nbytes() for lv in amg.levels
                              if lv.rap_plan is not None),
            "planned": [lv.rap_plan is not None for lv in amg.levels],
            "rap_plan_s": amg.setup_profile.get("rap_plan"),
            "levels": shape}
    steps, xs, Ak = [], [], None
    for k, sp in enumerate(systems[1:], 1):
        v = torch.from_numpy(sp.data.astype(dtype)).to(device)
        if cuda:
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        Ak = A0.replace_values(v)
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
        rv_ms = ev[0].elapsed_time(ev[1]) if cuda else None
        t0 = time.perf_counter()
        s.resetup(Ak)
        resetup_s = time.perf_counter() - t0
        res = s.solve(b)
        x = res.x.cpu().numpy()
        xs.append(x)
        rel = float(np.linalg.norm(b - sp @ x.astype(np.float64))
                    / np.linalg.norm(b.astype(np.float64)))
        steps.append({
            "k": k, "replace_values_ms": rv_ms, "resetup_s": resetup_s,
            "rap_execute_s": amg.setup_profile.get("rap_execute"),
            "setup_profile": amg.setup_profile,
            "coarsen_calls": amg.setup_stats["coarsen_calls"],
            "iterations": int(res.iters), "status": int(res.status),
            "solve_s": s.solve_time, "true_rel_residual_f64": rel,
            "rap_rel_err": rap_error(amg) if rap else None})
    launches = kernel_counts()
    iters = [st["iterations"] for st in steps]
    derived = dict.fromkeys(COUNTERS, 0)
    for it in iters:
        for c, v in pcg_derived_launches(s, it).items():
            derived[c] += v
    label = f"resetup {n}^3 {np.dtype(dtype).name}"
    tol_rap = 1e-5 if dtype == np.float32 else 1e-12
    for st in steps:
        check(st["status"] == 0, f"{label} k={st['k']} status")
        check(st["coarsen_calls"] == 0,
              f"{label} k={st['k']}: the hierarchy was re-coarsened")
        if rap:
            check(st["rap_rel_err"] <= tol_rap,
                  f"{label} k={st['k']}: coarse A vs R A P "
                  f"{st['rap_rel_err']:.3e}")
        check(st["true_rel_residual_f64"] <= (
            1e-5 if dtype == np.float32 else s.tolerance),
            f"{label} k={st['k']}: true residual "
            f"{st['true_rel_residual_f64']:.3e}")
    check([(lv["rows"], lv["format"]) for lv in amg.level_summary()]
          == shape, f"{label}: levels or formats changed")
    if fresh is not None:
        for st, sp in zip(steps, systems[1:]):
            t0 = time.perf_counter()
            Af = SparseMatrix.from_scipy(sp.astype(dtype), device=device,
                                         **kw)
            st["fresh_upload_s"] = time.perf_counter() - t0
            sf = T.create_solver(T.AMGConfig.from_string(fresh), "default",
                                 device=device)
            t0 = time.perf_counter()
            sf.setup(Af)
            st["fresh_setup_s"] = time.perf_counter() - t0
            st["fresh_iterations"] = int(sf.solve(b).iters)
            del sf, Af
    return s, {"setup": plan, "steps": steps, "launches": launches,
               "derived_launches": derived}, xs, Ak


def levels_values(amg):
    """Clones of every level's A, P and R values on the device."""
    return [[getattr(lv, f).values.clone() for f in ("A", "P", "R")
             if getattr(lv, f) is not None] for lv in amg.levels]


def resetup_phase(torch, device="cuda", n=SLICE_N, n_cmp=SLICE_N, n_f64=64,
                  n_cl=64):
    """pcg_agg_resetup: the bench config with ``structure_reuse_levels``
    -1 set up once, then for k = 1, 2, 3 ``replace_values``,
    ``resetup`` and ``solve``.  DIA half: -div(kappa_k grad u) with
    kappa_k from ``default_rng(k)`` (the pattern of
    ``poisson_3d_7pt``), beside a fresh upload and setup of the bench
    config (no plans) on each A_k: what a step costs without reuse.
    MATRIX_FREE half: backward-Euler heat steps L + I/dt, dt = 1, 0.5,
    0.25, 0.125, on a MATRIX_FREE upload (every level stays
    MATRIX_FREE, x bit for bit the DIA hierarchy's on the same values).
    Both: launches as derived, two resetups with the same values equal
    bit for bit, the CPU port's sequence at ``n_cmp``^3 (iterations
    within one); the DIA half at ``n_f64``^3 f64 against the CPU
    (iterations equal, x to rtol 1e-9, coarse A to 1e-12), and
    classical reuse at ``n_cl``^3 f64 with the device setup on both
    (each level planned or not alike, resetup iterations equal).
    Returns the launches of the two halves, summed."""
    from amgx_tpu_torch.io.poisson import poisson_scipy

    def diffusion(m):
        systems = [poisson_scipy((m, m, m)).tocsr()] + [
            variable_diffusion_3d(m, k) for k in (1, 2, 3)]
        for sp in systems[1:]:
            check(np.array_equal(sp.indptr, systems[0].indptr)
                  and np.array_equal(sp.indices, systems[0].indices),
                  "variable diffusion: pattern differs from poisson_3d_7pt")
        return systems

    def heat(m):
        return [heat_step_3d(m, dt) for dt in (1.0, 0.5, 0.25, 0.125)]

    total = dict.fromkeys(COUNTERS, 0)
    for half, cfg, make, formats in (
            ("DIA", REUSE_CFG, diffusion, None),
            ("MATRIX_FREE", MF_REUSE_CFG, heat, MF_FORMATS)):
        systems = make(n)
        s, rec, xs, Ak = reuse_sequence(
            torch, device, cfg, n, np.float32, systems, formats,
            fresh=BENCH_CFG if half == "DIA" else None)
        amg = s.precond
        # two resetups with the same values: the same hierarchy bits
        first = levels_values(amg)
        s.resetup(Ak.replace_values(Ak.values.clone()))
        again = levels_values(amg)
        bitwise = all(a.equal(b) for la, lb in zip(first, again)
                      for a, b in zip(la, lb))
        check(len(first) == len(again) and bitwise,
              f"{half}: two resetups with the same values differ")
        for c, v in rec["launches"].items():
            total[c] += v
        formats_now = [lv["format"] for lv in amg.level_summary()]
        if half == "MATRIX_FREE":
            check(all(f == "MATRIX_FREE" for f in formats_now),
                  f"MF resetup levels {formats_now}")
            _, _, xd, _ = reuse_sequence(torch, device, REUSE_CFG, n,
                                         np.float32, systems, rap=False)
            rec["x_bitwise_equal_dia"] = [
                a.tobytes() == b.tobytes() for a, b in zip(xs, xd)]
            check(all(rec["x_bitwise_equal_dia"]),
                  "MF resetup x differs from the DIA hierarchy's x")
        del s, amg
        _, crec, _, _ = reuse_sequence(torch, "cpu", cfg, n_cmp, np.float32,
                                       make(n_cmp), formats, rap=False)
        rec["cpu_iterations"] = [st["iterations"] for st in crec["steps"]]
        rec["cpu_resetup_s"] = [st["resetup_s"] for st in crec["steps"]]
        rec["repeat_resetup_bitwise"] = bitwise
        print(json.dumps({"slice": f"poisson-pattern {n}^3 f32 "
                          f"pcg_agg_resetup {half} half (PCG + AMG SIZE_8 "
                          "V, structure_reuse_levels -1) on "
                          f"{device}", **rec}), flush=True)
        check_launches(f"resetup {half}", rec["launches"],
                       rec["derived_launches"], device)
        for st, ci in zip(rec["steps"], rec["cpu_iterations"]):
            check(abs(st["iterations"] - ci) <= 1 or n_cmp != n,
                  f"{half} k={st['k']}: iterations card {st['iterations']} "
                  f"vs cpu {ci}")

    # ---- n_f64^3 f64, DIA half: card against CPU
    out = {}
    for dev in (device, "cpu"):
        s, rec, xs, _ = reuse_sequence(torch, dev, REUSE_CFG, n_f64,
                                       np.float64, diffusion(n_f64))
        out[dev] = (rec, xs, [lv.A.to_scipy() for lv in s.precond.levels])
        del s
    (rg, xg, ag), (rc, xc, ac) = out[device], out["cpu"]
    dx = max(float(np.abs(a - b).max()) for a, b in zip(xg, xc))
    dA = max(float(abs(a - b).max()) / float(abs(b).max())
             for a, b in zip(ag, ac))
    print(json.dumps({f"resetup_{n_f64}^3_f64": {
        "iterations": [st["iterations"] for st in rg["steps"]],
        "cpu_iterations": [st["iterations"] for st in rc["steps"]],
        "max_abs_diff_vs_cpu": dx, "coarse_A_rel_diff_vs_cpu": dA}}),
        flush=True)
    for sg_, sc_ in zip(rg["steps"], rc["steps"]):
        check(sg_["iterations"] == sc_["iterations"],
              f"resetup f64 iterations card {sg_['iterations']} vs cpu "
              f"{sc_['iterations']}")
    for a, b in zip(xg, xc):
        check(np.allclose(a, b, rtol=1e-9, atol=1e-9 * np.abs(b).max()),
              "resetup f64 x card vs cpu")
    check(dA <= 1e-12, f"resetup f64 coarse A card vs cpu {dA:.3e}")

    # ---- classical reuse at n_cl^3 f64, the device setup on both
    cl_cfg = classical_cfg(', "structure_reuse_levels": -1, '
                           '"setup_location": "DEVICE"')
    cl = {}
    for dev in (device, "cpu"):
        s, rec, _, _ = reuse_sequence(torch, dev, cl_cfg, n_cl, np.float64,
                                      diffusion(n_cl))
        cl[dev] = rec
        del s
    planned = {d: r["setup"]["planned"] for d, r in cl.items()}
    its = {d: [st["iterations"] for st in r["steps"]] for d, r in cl.items()}
    print(json.dumps({f"classical_resetup_{n_cl}^3_f64": {
        "planned": planned[device], "cpu_planned": planned["cpu"],
        "iterations": its[device], "cpu_iterations": its["cpu"],
        "plan_bytes": cl[device]["setup"]["plan_bytes"]}}), flush=True)
    check(planned[device] == planned["cpu"],
          f"classical plans card {planned[device]} vs cpu {planned['cpu']}")
    check(its[device] == its["cpu"],
          f"classical resetup iterations card {its[device]} vs cpu "
          f"{its['cpu']}")
    return total


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

    recs = timed("kernels", kernel_phase, torch, peaks)
    bench, ref = timed("bench_pcg", slice_phase, torch)
    by_path = {"bench_pcg": bench}
    by_path["bench_pcg_matrix_free"] = timed(
        "bench_pcg_matrix_free", mf_slice_phase, torch, ref)
    by_path["fgmres_aggregation"] = timed("fgmres_aggregation",
                                          fgmres_phase, torch)
    by_path["pcg_classical"], cl_recs = timed(
        "pcg_classical", classical_phase, torch, peaks)
    recs += cl_recs
    by_path["pcg_classical_cheby"], ch_recs = timed(
        "pcg_classical_cheby", cheby_phase, torch, peaks)
    recs += ch_recs
    for name, phase in (("idr_dilu", idr_phase),
                        ("gmres_ilu0", gmres_ilu_phase),
                        ("pbicgstab_agg_w", pbicgstab_w_phase),
                        ("amg_classical_kcycle", kcycle_phase),
                        ("pcg_agg_resetup", resetup_phase)):
        by_path[name] = timed(name, phase, torch)

    # each kernel: the path whose count is its ``launches``, the case
    # whose times the summary gives, its source and the TPU kernel
    well = "amgx_tpu/ops/pallas_well.py:160"
    main_case = {
        "dia_spmv": ("bench_pcg", f"level0 A {SLICE_N}^3 f32",
                     "amgx_tpu_torch/csrc/dia_spmv.cu",
                     "amgx_tpu/ops/pallas_dia.py:76"),
        "ell_spmv": ("bench_pcg", f"level0 R {(SLICE_N // 2) ** 3}x"
                     f"{SLICE_N ** 3} w=8 f32",
                     "amgx_tpu_torch/csrc/ell_spmv.cu", well),
        "sell_spmv": ("pcg_classical", "classical level1 A ",
                      "amgx_tpu_torch/csrc/ell_spmv.cu", well),
        "stencil_spmv": ("bench_pcg_matrix_free",
                         f"level0 A {SLICE_N}^3 f32",
                         "amgx_tpu_torch/csrc/stencil_spmv.cu",
                         "amgx_tpu/ops/pallas_stencil.py:64"),
    }
    # the device times the profiler did not record (null in the cases)
    print(json.dumps({"device_time_not_measured": [
        f"{r['case']} ({r['kernel']}): {k}" for r in recs
        for k, v in r.items() if k.endswith("device_ms") and v is None]}),
        flush=True)
    for path, kernels_of in (("bench_pcg", ("dia_spmv", "ell_spmv")),
                             ("pcg_classical", ("dia_spmv", "sell_spmv")),
                             ("pcg_classical_cheby",
                              ("dia_spmv", "sell_spmv")),
                             ("idr_dilu", ("dia_spmv",)),
                             ("gmres_ilu0", ("dia_spmv",)),
                             ("pbicgstab_agg_w", ("dia_spmv", "ell_spmv")),
                             ("amg_classical_kcycle",
                              ("dia_spmv", "sell_spmv", "ell_spmv")),
                             ("pcg_agg_resetup",
                              ("dia_spmv", "ell_spmv", "stencil_spmv"))):
        for name in kernels_of:
            check(by_path[path][name] > 0,
                  f"{name} never launched on the {path} path")
    summary = []
    for name, (path, case, source, replaces) in main_case.items():
        rec = next(r for r in recs if r["kernel"] == name and (
            r["case"] == case or (case.endswith(" ") and r["case"]
                                  .startswith(case) and r["dtype"] == "f32"
                                  and "RCM" not in r["case"])))
        check(by_path[path][name] > 0,
              f"{name} never launched on its main path ({path})")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": by_path[path][name],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "case": rec["case"],
            "launches_path": path,
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
        })
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
