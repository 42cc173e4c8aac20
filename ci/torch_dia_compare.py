"""Measure the DIA SpMV kernel of one tree of the PyTorch port on one
CUDA card: the kernel at the shapes where its launches fall, and its
device time in warm solves of three paths.

    python3 ci/torch_dia_compare.py [--root DIR] [--tag NAME]
                                    [--paths bench_pcg,pbicgstab_agg_w,
                                     refine_bf16_256] [--sweep]

Imports ``amgx_tpu_torch`` from ``--root`` (default: the checkout that
holds this script) and builds its kernels there, so two trees, for
example a commit and its parent unpacked with ``git archive`` into an
ignored directory, are measured by one script on one card; run them as
A, B, B, A, one after another on the same card.  Every product goes
through ``ops.spmv.spmv``, which both trees' DIA wrappers sit under;
configs, the timer and the launch walk come from this checkout's
``chip_smoke.py``.  Prints one JSON line:

* ``cases``: DIA operators outside the paths below (f64 level 0 and
  the 108^3 convection-diffusion operator, SIZE_2 levels of
  FGMRES_AGGREGATION, rows not a multiple of 8, runtime diagonal
  counts 27 and 48), each held to ``dia_spmv_plain`` (bit for bit in
  bf16, within ``chip_smoke.TOL`` in f32 and f64), with its event time
  cold (L2 flushed, median of 25) and warm, its profiler device time,
  its bound (the operator's nonzeros, x and y once over 3.35 TB/s) and
  the tree's launch plan (null where the tree has none);
* ``paths``: for each of ``--paths``, the setup and first solve, then
  per DIA level of the hierarchy its rows, dtype, the launches of one
  solve derived from the cycle walk (their sum held to
  ``chip_smoke``'s derived count and to the wrapper's count), the
  kernel's cold time, bound, and launches x (time - bound); and the
  ``dia_spmv`` device time and launches of one warm solve under
  ``torch.profiler``, by dtype;
* ``sweep_ms`` (``--sweep``, trees with ``ops.dia.dia_launch_plan``
  only): each case and path level timed cold at every rows-a-thread
  ``vec`` its rows and alignment allow, through the C entry point with
  the plan's ``vec`` and ``blocks`` replaced, and at the plan's own vec
  with each way of reading x: ``x_scalar`` (the kernel built with
  ``-DDIA_X_WAY=1``: one scalar load a row through L1) and
  ``x_realign`` (``-DDIA_X_WAY=2``: two aligned vectors shifted into
  place); the kernel as built takes the second in bf16, the first in
  f32 and f64.  Each is held bit for bit to the plan's launch.

Needs a CUDA card; imports nothing of JAX or of ``amgx_tpu``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
PATHS = ("bench_pcg", "pbicgstab_agg_w", "refine_bf16_256")
_X_WAYS = {}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_of_this_checkout", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banded(n, offsets, rng):
    """A square matrix with random values on every in-range entry of
    the given diagonals."""
    import scipy.sparse as sps

    return sps.diags_array(
        [rng.uniform(0.5, 1.5, n - abs(o)) for o in offsets],
        offsets=list(offsets), shape=(n, n), format="csr")


def case_matrices(smoke, rng):
    """(label, scipy matrix, dtype) of the cases beside the paths."""
    import scipy.sparse as sps

    from amgx_tpu_torch.io.poisson import poisson_scipy

    ones3 = sps.diags_array([np.ones(63), np.ones(64), np.ones(63)],
                            offsets=[-1, 0, 1], format="csr")
    n48 = 64 ** 3
    pool = np.setdiff1d(np.arange(-3000, 3001), [0])
    offs48 = np.sort(np.append(rng.choice(pool, 47, replace=False), 0))
    # poisson_scipy's last axis is the grid's fastest (x)
    return (
        ("level0 A 128^3 f64", lambda: poisson_scipy((128,) * 3),
         np.float64),
        ("convection-diffusion 108^3 f64",
         lambda: smoke.convection_diffusion_3d(108), np.float64),
        ("SIZE_2 level1 A 64x128x128 f32",
         lambda: poisson_scipy((128, 128, 64)), np.float32),
        ("SIZE_2 level4 A 32x64x64 f32",
         lambda: poisson_scipy((64, 64, 32)), np.float32),
        ("SIZE_2 level7 A 16x32x32 f32",
         lambda: poisson_scipy((32, 32, 16)), np.float32),
        ("odd rows 127^3 f32", lambda: poisson_scipy((127,) * 3),
         np.float32),
        ("rows 2 mod 4 130x127x127 bf16",
         lambda: poisson_scipy((127, 127, 130)), "bfloat16"),
        ("27 diagonals 64^3 f32 (runtime count)",
         lambda: sps.kron(sps.kron(ones3, ones3), ones3, format="csr"),
         np.float32),
        (f"48 diagonals {n48} rows f32 (runtime count)",
         lambda: banded(n48, offs48, rng), np.float32),
        (f"48 diagonals {n48} rows bf16 (runtime count)",
         lambda: banded(n48, offs48, rng), "bfloat16"),
    )


def upload(torch, sp, dtype):
    from amgx_tpu_torch.core.matrix import SparseMatrix

    host = np.float32 if dtype == "bfloat16" else dtype
    A = SparseMatrix.from_scipy(sp.astype(host), device="cuda",
                                accel_formats=("dia",))
    return A.astype(torch.bfloat16) if dtype == "bfloat16" else A


def plan_of(torch, A, x):
    """The tree's launch plan for A and x (their buffers are 16-byte
    aligned), or None where the tree has none."""
    from amgx_tpu_torch.ops import dia

    if not hasattr(dia, "dia_launch_plan"):
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = dia.dia_launch_plan(A.n_rows, A.dia_offsets, A.dtype, sms)
    return {k: v for k, v in p._asdict().items() if k != "offsets"}


def measure(torch, smoke, timer, peaks, label, A, x, sweep):
    """One DIA operator: checked against the plain version, timed."""
    from amgx_tpu_torch.ops import dia
    from amgx_tpu_torch.ops.spmv import spmv

    smoke.check(A.has_dia and not A.has_matrix_free, f"{label}: not DIA")
    y = spmv(A, x)
    yp = dia.dia_spmv_plain(A.dia_vals, A.dia_offsets, x)
    torch.cuda.synchronize()
    if A.dtype == torch.bfloat16:
        smoke.check(torch.equal(y, yp), f"{label}: not bit for bit")
        err = 0.0
    else:
        _, err = smoke.rel_err(y, yp)
        tol = smoke.TOL[str(A.dtype)[6:]]
        smoke.check(err <= tol, f"{label}: rel err {err:.3e} > {tol}")
    size = A.dia_vals.element_size()
    nd, n = A.dia_vals.shape
    bound = (size * (A.nnz + 2 * n) + 4 * nd) / peaks["bw"] * 1e3
    run = (lambda: spmv(A, x))
    rec = {"case": label, "rows": n, "diagonals": nd,
           "dtype": str(A.dtype)[6:], "max_rel_err": err,
           "plan": plan_of(torch, A, x),
           "ms": timer(run), "ms_warm_l2": timer(run, flush=False),
           "device_ms": timer.device(run, "dia_spmv_kernel"),
           "bound_ms": bound}
    rec["share_of_bound"] = bound / rec["ms"]
    if sweep and rec["plan"] is not None:
        rec["sweep_ms"] = sweep_vec(torch, timer, A, x)
    return rec


def x_way_library(way):
    """``csrc/dia_spmv.cu`` built with ``-DDIA_X_WAY=way`` into the
    tree's build directory, loaded with the kernel's signatures."""
    from amgx_tpu_torch.ops import kernels

    out = kernels.BUILD_DIR / f"libdia_spmv_x_way{way}.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                    f"-DDIA_X_WAY={way}", "-o", str(out),
                    str(kernels.CSRC / "dia_spmv.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in kernels._SIGNATURES["dia_spmv"].items():
        getattr(lib, name).argtypes = list(argtypes)
        getattr(lib, name).restype = ctypes.c_int
    return lib


def sweep_vec(torch, timer, A, x):
    """Cold time of the kernel at each rows-a-thread vec n allows, and
    of each way of reading x at the plan's vec."""
    from amgx_tpu_torch.ops import dia, kernels

    if not _X_WAYS:
        _X_WAYS.update(x_scalar=x_way_library(1), x_realign=x_way_library(2))
    n = A.n_rows
    size = A.dia_vals.element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    base = dia.dia_launch_plan(n, A.dia_offsets, A.dtype, sms)
    entry = kernels.entry_point("dia_spmv", A.dtype, x.dtype)
    y = torch.empty_like(x)
    yp = dia.dia_spmv(A.dia_vals, A.dia_offsets, x)
    out = {}
    plans = []
    vec = 1
    while vec * size <= 16 and n % vec == 0:
        plans.append((str(vec), kernels.library("dia_spmv"), base._replace(
            vec=vec, blocks=-(-n // (vec * base.threads)))))
        vec *= 2
    plans += [(key, lib, base) for key, lib in _X_WAYS.items()]
    for key, lib, plan in plans:
        arr = dia.pack_plan(plan)
        fn = getattr(lib, entry)

        def run(fn=fn, arr=arr):
            rc = fn(A.dia_vals.data_ptr(), x.data_ptr(), y.data_ptr(), n,
                    ctypes.addressof(arr), kernels.stream_handle(x.device))
            kernels.check_launch("dia_spmv", rc)

        run()
        torch.cuda.synchronize()
        if not torch.equal(y, yp):
            raise RuntimeError(f"sweep {key}: differs from the plan's")
        out[key] = timer(run)
    return out


def level_launches(smoke, amg, cycles, top, sweep=1, coarse=1,
                   setup_spmvs=0, coarse_setup_spmvs=0):
    """A-SpMVs of each level in a solve: ``cycles`` cycles walked by
    ``chip_smoke.cycle_walk``, ``top`` on level 0, each smoothed
    level's setup ``setup_spmvs``, the coarsest ``coarse_setup_spmvs``
    (the terms of ``chip_smoke.derived_variant_launches``)."""
    lv = amg.levels
    walk = smoke.cycle_walk(amg, sweep, coarse)
    out = [cycles * walk.get((i, "A"), 0) for i in range(len(lv))]
    out[0] += top
    for i, lvl in enumerate(lv):
        if lvl.smoother is not None:
            out[i] += setup_spmvs
    out[-1] += coarse_setup_spmvs
    return out


def trace_dia(torch, s, b):
    """``dia_spmv`` device time and launches of one warm solve, by
    dtype (the kernel's template arguments name it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.solve(b)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    groups, busy = {}, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        if "dia_spmv" not in e.name:
            continue
        dt = ("bf16" if "bfloat16" in e.name
              else "f64" if "double" in e.name else "f32")
        g = groups.setdefault(dt, [0.0, 0])
        g[0] += ms
        g[1] += 1
    if busy == 0:
        return "not measured"
    return {"wall_ms": wall_ms, "busy_ms": busy,
            **{f"dia_{k}_ms": t for k, (t, _) in groups.items()},
            **{f"dia_{k}_launches": c for k, (_, c) in groups.items()}}


def path_setup(torch, smoke, name):
    """(solver, amg, result, b, record, per-level launches, derived
    count per entry point) of one path's setup and first solve."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_rhs, poisson_scipy
    from amgx_tpu_torch.ops import dia

    dia.launches = 0
    dia.variant_launches.clear()
    if name == "refine_bf16_256":
        n = smoke.REFINE_N
        A = SparseMatrix.from_scipy(
            poisson_scipy((n, n, n)).astype(np.float32), device="cuda")
        b = poisson_rhs(A.n_rows, dtype=np.float32)
        t0 = time.perf_counter()
        s = T.create_solver(T.AMGConfig.from_string(smoke.REFINE_BF16_CFG),
                            "default", device="cuda")
        s.setup(A)
        setup_s = time.perf_counter() - t0
        res = s.solve(b)
        amg = s.inner.precond
        cycles = 9 * int(res.iters)  # PCG(8): r0 and 8 A p a correction
        derived = smoke.derived_variant_launches(
            amg, cycles, top=((A, A.dtype, cycles),), setup_spmvs=20,
            coarse_setup_spmvs=20)
        per = level_launches(
            smoke, amg, cycles, 0,
            smoke.sweep_spmvs(amg.levels[0].smoother),
            smoke.coarse_solve_spmvs(amg), 20, 20)
        outer = {"rows": A.n_rows, "dtype": "float32", "launches": cycles}
    else:
        cfg = {"bench_pcg": smoke.BENCH_CFG,
               "pbicgstab_agg_w": smoke.PBICGSTAB_AGG_W_CFG}[name]
        s, res, setup_s, b, _ = smoke.solve_on("cuda", cfg, smoke.SLICE_N,
                                               np.float32)
        amg = s.precond
        it = int(res.iters)
        top, cycles = ((it + 1, it + 1) if name == "bench_pcg"
                       else (1 + 2 * it, 2 * it))
        derived = smoke.derived_variant_launches(
            amg, cycles, top=((amg.levels[0].A, torch.float32, top),))
        per = level_launches(smoke, amg, cycles, top)
        outer = None
    rec = {"iterations": int(res.iters), "status": int(res.status),
           "setup_s": setup_s, "solve_s": s.solve_time,
           "launches": dict(dia.variant_launches),
           "derived_launches": {k: v for k, v in derived.items()
                                if k.startswith("dia_spmv")}}
    smoke.check(rec["launches"] == rec["derived_launches"],
                f"{name}: launches {rec['launches']} != derived "
                f"{rec['derived_launches']}")
    return s, amg, b, rec, per, outer


def path_phase(torch, smoke, timer, peaks, name, rng, sweep):
    s, amg, b, rec, per, outer = path_setup(torch, smoke, name)
    warm = []
    for _ in range(3):
        s.solve(b)
        warm.append(s.solve_time * 1e3)
    rec["warm_ms"] = warm
    rec["trace"] = trace_dia(torch, s, b)
    levels, over = [], 0.0
    for i, lvl in enumerate(amg.levels):
        A = lvl.A
        if not A.has_dia:
            continue
        x = torch.from_numpy(rng.standard_normal(A.n_rows)).cuda().to(
            A.dtype)
        m = measure(torch, smoke, timer, peaks, f"{name} level{i} A", A, x,
                    sweep)
        m.update(level=i, launches=per[i],
                 launches_x_over_bound_ms=per[i] * (m["ms"] - m["bound_ms"]))
        over += m["launches_x_over_bound_ms"]
        levels.append(m)
    sums = {}
    for m, lvl in zip(levels, [lv for lv in amg.levels if lv.A.has_dia]):
        v = smoke.variant_of(lvl.A, lvl.A.dtype)
        sums[v] = sums.get(v, 0) + m["launches"]
    if outer is not None:
        sums["dia_spmv_f32"] = sums.get("dia_spmv_f32", 0) + \
            outer["launches"]
        rec["outer_f32_A"] = outer
    smoke.check(sums == rec["derived_launches"],
                f"{name}: per-level launches {sums} != derived "
                f"{rec['derived_launches']}")
    rec["levels"] = levels
    rec["launches_x_over_bound_ms"] = over
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_dia_compare: CUDA is not available", file=sys.stderr)
        return 2
    smoke = _smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import amgx_tpu_torch
    from amgx_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    peaks = smoke.peaks_for(torch.cuda.get_device_name(0))
    timer = smoke.Timer(torch)
    rng = np.random.default_rng(10)
    cases = []
    for label, make, dtype in case_matrices(smoke, rng):
        A = upload(torch, make(), dtype)
        x = torch.from_numpy(rng.standard_normal(A.n_rows)).cuda().to(
            A.dtype)
        cases.append(measure(torch, smoke, timer, peaks, label, A, x,
                             args.sweep))
        del A, x
    paths = {}
    for name in filter(None, args.paths.split(",")):
        smoke.check(name in PATHS, f"unknown path {name}")
        paths[name] = path_phase(torch, smoke, timer, peaks, name, rng,
                                 args.sweep)
        torch.cuda.empty_cache()
    print(json.dumps({
        "tag": args.tag, "root": str(Path(args.root).resolve()),
        "package": str(Path(amgx_tpu_torch.__file__).parent),
        "card": smoke.card_line(), "build_s": build_s,
        "cases": cases, "paths": paths}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
