"""Measure one tree of the PyTorch port on one CUDA card: the classical
AMG solve (AmgX's PCG_CLASSICAL_V_JACOBI config, setup on the card) and
where its device time goes.

    python3 ci/torch_classical_compare.py [--root DIR] [--n 128]
                                          [--solves 6] [--tag NAME]

Imports ``amgx_tpu_torch`` from ``--root`` (default: the checkout that
holds this script) and builds its kernels there, so two trees, for
example a commit and its parent unpacked with ``git archive`` into an
ignored directory, are measured by one script on one card; run them as
A, B, B, A, one after another on the same card.  The config comes from
this checkout's ``chip_smoke.py``.  Prints one JSON line:

* ``iterations``, ``true_rel_residual_f64`` of the first solve of
  ``poisson_3d_7pt(n)`` in f32;
* ``warm_ms``: wall time of each of ``--solves`` warm solves (host
  clock around a solve that ends in a synchronize) and their median;
* ``trace``: one warm solve under ``torch.profiler``: its wall time,
  the device busy time (the sum of the kernel and copy intervals) and
  share, and the device time and launches of the ELL kernels (every
  kernel whose name holds ``ell_spmv``, so the sliced ``sell_spmv``
  too), of ``dia_spmv`` and of the rest;
* ``transfers_ms``: event time (L2 flushed, the median of 25) of
  ``ops.spmv.spmv`` on the level-0 P and R of the aggregation
  hierarchies at n^3 (SIZE_8: 2x2x2 aggregates, SIZE_2: 2x1x1), f32,
  through whichever ELL kernel the tree's upload picks.

Needs a CUDA card; imports nothing of JAX or of ``amgx_tpu``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_of_this_checkout", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trace(torch, s, b):
    """Device time by kernel group of one warm solve."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.solve(b)
            wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"ell": [0.0, 0], "dia_spmv": [0.0, 0], "rest": [0.0, 0]}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        g = ("ell" if "ell_spmv" in e.name
             else "dia_spmv" if "dia_spmv" in e.name else "rest")
        groups[g][0] += e.time_range.elapsed_us() / 1e3
        groups[g][1] += 1
    busy = sum(t for t, _ in groups.values())
    if busy == 0:
        return "not measured"
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms,
            **{f"{g}_ms": t for g, (t, _) in groups.items()},
            **{f"{g}_launches": c for g, (_, c) in groups.items()}}


def transfers(torch, smoke, n):
    import scipy.sparse as sps

    from amgx_tpu_torch.amg.aggregation import geo_aggregate
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.ops.spmv import spmv

    timer = smoke.Timer(torch)
    rng = np.random.default_rng(0)
    out = {}
    for name, mode in (("SIZE_8", 3), ("SIZE_2", 1)):
        agg = geo_aggregate(n, n, n, mode)
        P = sps.csr_matrix((np.ones(agg.shape[0], np.float32),
                            (np.arange(agg.shape[0]), agg)))
        for op, sp in (("P", P), ("R", P.T.tocsr())):
            A = SparseMatrix.from_scipy(sp, device="cuda")
            x = torch.from_numpy(
                rng.standard_normal(A.n_cols).astype(np.float32)).cuda()
            out[f"{name} {op} {A.n_rows}x{A.n_cols}"] = timer(
                lambda A=A, x=x: spmv(A, x))
    del timer
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--solves", type=int, default=6)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_classical_compare: CUDA is not available",
              file=sys.stderr)
        return 2
    smoke = _smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import amgx_tpu_torch
    from amgx_tpu_torch.ops import kernels

    kernels.build()
    s, res, setup_s, b, _ = smoke.solve_on(
        "cuda", smoke.PCG_CLASSICAL, args.n, np.float32)
    iters = int(res.iters)
    rel = smoke.true_rel_residual(args.n, b, res.x.cpu().numpy())
    warm = []
    for _ in range(args.solves):
        s.solve(b)
        warm.append(s.solve_time * 1e3)
    print(json.dumps({
        "tag": args.tag, "root": str(Path(args.root).resolve()),
        "package": str(Path(amgx_tpu_torch.__file__).parent),
        "card": smoke.card_line(), "n": args.n, "iterations": iters,
        "true_rel_residual_f64": rel, "setup_s": setup_s,
        "warm_ms": warm, "warm_ms_median": statistics.median(warm),
        "trace": trace(torch, s, b),
        "transfers_ms": transfers(torch, smoke, args.n)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
