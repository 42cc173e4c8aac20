"""Measure one tree of the PyTorch port on one CUDA card: the host cost
of its SpMV wrappers, its warm bench solves with ``matrix_free`` 0 and
1, and its stencil kernel against its DIA kernel on stencils other than
the bench operator.

    python3 ci/torch_port_compare.py [--root DIR] [--n 128] [--solves 6]
                                     [--calls 200] [--tag NAME]

Imports ``amgx_tpu_torch`` from ``--root`` (default: the checkout that
holds this script), so two trees, for example a commit and its parent
unpacked with ``git archive`` into an ignored directory, are measured
by one script on one card; run them as A, B, B, A on the same card.  The
timer and the stencil matrices come from this checkout's
``chip_smoke.py``.  Prints one JSON line:

* ``host_us_per_call``: host time of one call of each wrapper
  (``stencil_spmv``, ``dia_spmv``, and ``ops.spmv.spmv`` on the
  MATRIX_FREE and the DIA level-0 matrix), the mean over ``--calls``
  calls enqueued behind a sleep kernel, so the card never holds the
  host back; ``torch.empty_like`` of x alone as a yardstick;
* ``warm_ms_per_iteration``: wall time per PCG iteration of
  ``--solves`` warm solves each of the bench config on
  ``poisson_3d_7pt(n)`` in f32 (the matrix uploaded with the
  MATRIX_FREE format for ``matrix_free`` 1), DIA and MATRIX_FREE
  alternating, with their medians;
* ``host_profile``: the functions with the most own time in one warm
  solve of each variant under cProfile;
* ``stencil_cases``: f32 event times (L2 flushed; and warm) and device
  times of ``stencil_spmv`` and ``dia_spmv`` on the same matrix, held
  bit for bit to each other: the 7-point star at n^3, the 19-point
  stencil at n^3, the 2D 5-point one on 2048 x 1024 and a 7-point one
  two points wide along x at n^3.

Needs a CUDA card; imports nothing of JAX or of ``amgx_tpu``.
"""

from __future__ import annotations

import argparse
import cProfile
import importlib.util
import json
import pstats
import sys
import time
import types
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def _smoke():
    """chip_smoke.py of this checkout: configs, timer, stencil matrices."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_of_this_checkout", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dia_offsets(A):
    """The offsets the tree's ``dia_spmv`` takes: host ints since the
    kernel takes them by value in its launch plan, a device tensor in
    earlier trees."""
    from amgx_tpu_torch.ops import dia

    return (A.dia_offsets if hasattr(dia, "dia_launch_plan")
            else A.dia_offsets_dev)


def host_us(torch, fn, calls):
    """Mean host time of one ``fn()`` in µs over ``calls`` calls,
    enqueued while a sleep kernel keeps the card busy."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def profile_solve(s, b, top=12):
    prof = cProfile.Profile()
    prof.enable()
    s.solve(b)
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {
        "total_ms": st.total_tt * 1e3,
        "top": [{"fn": f"{Path(f).name}:{line}:{name}", "calls": nc,
                 "own_ms": tt * 1e3, "cum_ms": ct * 1e3}
                for (f, line, name), (_, nc, tt, ct, _) in rows],
    }


def stencil_cases(torch, smoke, n):
    """The stencil kernel and the DIA kernel on the same f32 matrices."""
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_scipy
    from amgx_tpu_torch.ops import dia, stencil

    timer = smoke.Timer(torch)
    rng = np.random.default_rng(0)
    box = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]
    nineteen = [st for st in box if sum(map(abs, st)) <= 2]
    wide = [(0, 0, -1), (-2, 0, 0), (-1, 0, 0), (0, 0, 0), (1, 0, 0),
            (2, 0, 0), (0, 0, 1)]
    wide_c = [-1.0, 0.0625, -1.25, 4.375, -1.25, 0.0625, -1.0]
    cases = (
        (f"star {n}^3", poisson_scipy((n, n, n)), None),
        (f"19-point {n}^3", smoke.stencil_scipy(
            (n, n, n), nineteen, [-1.0] * 9 + [18.0] + [-1.0] * 9), None),
        ("2D 5-point 2048x1024", poisson_scipy((1024, 2048)), None),
        (f"wide-x 7-point {n}^3",
         smoke.stencil_scipy((n, n, n), wide, wide_c), (wide, wide_c)),
    )
    out = []
    for label, sp, hand in cases:
        sp = sp.astype(np.float32)
        D = SparseMatrix.from_scipy(sp, device="cuda", accel_formats=("dia",))
        if hand is None:
            A = SparseMatrix.from_scipy(sp, device="cuda",
                                        accel_formats=("matrix_free",))
            if not A.has_matrix_free:
                raise RuntimeError(f"{label}: not detected as a stencil")
        else:  # a stencil detection does not yield, as chip_smoke.py builds
            steps, coefs = hand
            A = types.SimpleNamespace(
                mf_meta=stencil.StencilMeta("const", (n, n, n), tuple(steps),
                                            D.dia_offsets),
                mf_coefs=torch.tensor(coefs, dtype=torch.float32,
                                      device="cuda"),
                # the steps on the card, as earlier trees read them
                mf_steps_dev=torch.tensor(steps, dtype=torch.int32,
                                          device="cuda"))
        x = torch.from_numpy(
            rng.standard_normal(sp.shape[0]).astype(np.float32)).cuda()

        def run_st():
            return stencil.stencil_spmv(A, x)

        def run_dia():
            return dia.dia_spmv(D.dia_vals, dia_offsets(D), x)

        equal = bool(torch.equal(run_st(), run_dia()))
        if not equal:
            raise RuntimeError(f"{label}: stencil and DIA kernels differ")
        out.append({
            "case": label, "bitwise_equal_dia": equal,
            "stencil_ms": timer(run_st),
            "stencil_ms_warm_l2": timer(run_st, flush=False),
            "stencil_device_ms": timer.device(run_st, "stencil_"),
            "dia_ms": timer(run_dia),
            "dia_ms_warm_l2": timer(run_dia, flush=False),
            "dia_device_ms": timer.device(run_dia, "dia_spmv_kernel"),
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--solves", type=int, default=6)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_port_compare: CUDA is not available", file=sys.stderr)
        return 2
    smoke = _smoke()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import amgx_tpu_torch as T
    from amgx_tpu_torch.io.poisson import poisson_3d_7pt, poisson_rhs
    from amgx_tpu_torch.ops import dia, spmv, stencil

    if not Path(T.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"amgx_tpu_torch from {T.__file__}, not {root}")

    n = args.n
    A_mf = poisson_3d_7pt(n, dtype=np.float32, device="cuda",
                          accel_formats=smoke.MF_FORMATS)
    A_dia = poisson_3d_7pt(n, dtype=np.float32, device="cuda")
    if not (A_mf.has_matrix_free and A_dia.has_dia):
        raise RuntimeError("level-0 matrices are not MATRIX_FREE / DIA")
    x = torch.randn(A_mf.n_rows, device="cuda")
    host = {
        "torch_empty": host_us(torch, lambda: torch.empty_like(x),
                               args.calls),
        "stencil_spmv": host_us(
            torch, lambda: stencil.stencil_spmv(A_mf, x), args.calls),
        "dia_spmv": host_us(
            torch, lambda: dia.dia_spmv(A_dia.dia_vals,
                                        dia_offsets(A_dia), x),
            args.calls),
        "spmv_matrix_free": host_us(
            torch, lambda: spmv.spmv(A_mf, x), args.calls),
        "spmv_dia": host_us(torch, lambda: spmv.spmv(A_dia, x), args.calls),
    }

    b = poisson_rhs(A_mf.n_rows, dtype=np.float32)
    solvers = {}
    for name, cfg, A in (("dia", smoke.BENCH_CFG, A_dia),
                         ("matrix_free", smoke.MF_CFG, A_mf)):
        s = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                            device="cuda")
        s.setup(A)
        s.solve(b)  # the first solve pays one-off costs
        solvers[name] = s
    warm = {name: [] for name in solvers}
    iters = {}
    for _ in range(args.solves):
        for name, s in solvers.items():
            res = s.solve(b)
            iters[name] = int(res.iters)
            warm[name].append(s.solve_time / max(int(res.iters), 1) * 1e3)
    prof = {name: profile_solve(s, b) for name, s in solvers.items()}
    del solvers, A_mf, A_dia
    print(json.dumps({
        "tag": args.tag, "root": str(root), "n": n,
        "device": torch.cuda.get_device_name(0),
        "host_us_per_call": host,
        "iterations": iters,
        "warm_ms_per_iteration": {
            name: {"samples": v, "median": float(np.median(v))}
            for name, v in warm.items()},
        "host_profile": prof,
        "stencil_cases": stencil_cases(torch, smoke, n),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
