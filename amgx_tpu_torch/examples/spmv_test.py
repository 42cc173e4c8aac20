"""One SpMV of the port against the host product (the reference
``examples/amgx_spmv_test``; the JAX package's ``examples/spmv_test.py``):

    python -m amgx_tpu_torch.examples.spmv_test [file.mtx | N] [--device cpu]

Loads a MatrixMarket or ``%%NVAMGBinary`` file, or makes the N^3
7-point Poisson system (default 64), in f32; runs y = A x through
``amgx_tpu_torch.ops.spmv`` on the card (the hand-written kernel of the
matrix's format), or on the CPU with ``--device cpu`` (its plain
version); holds y to scipy's product in f64 and prints the format, the
error and the time of one SpMV (CUDA events on the card, the median of
20).  Exits 0 when the error is under 1e-5 of max |A x|.
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", nargs="?", default="64",
                    help="a matrix file, or N for the N^3 Poisson system")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from amgx_tpu_torch.io.matrix_market import read_mtx
    from amgx_tpu_torch.io.poisson import poisson_3d_7pt
    from amgx_tpu_torch.ops.spmv import spmv

    if args.source.isdigit():
        A = poisson_3d_7pt(int(args.source), dtype=np.float32,
                           device=args.device)
        label = f"poisson7 {args.source}^3"
    else:
        A = read_mtx(args.source, dtype=np.float32, device=args.device)
        label = args.source
    rng = np.random.default_rng(0)
    xh = rng.standard_normal(A.n_cols * A.block_size).astype(np.float32)
    x = torch.from_numpy(xh).to(A.device)
    y = spmv(A, x).cpu().numpy()
    ref = A.to_scipy().astype(np.float64) @ xh.astype(np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(y - ref).max()) / scale
    times = []
    for _ in range(20):
        if A.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            spmv(A, x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            spmv(A, x)
            times.append(time.perf_counter() - t0)
    per = float(np.median(times))
    gf = 2.0 * A.nnz * A.block_size ** 2 / max(per, 1e-12) / 1e9
    print(
        f"{label}: n={A.n_rows} nnz={A.nnz} format={A.format} "
        f"device={A.device}\n"
        f"max rel err vs host: {err:.2e}\n"
        f"SpMV: {per * 1e6:.1f} us  ({gf:.1f} GFLOPS)"
    )
    return 0 if err < 1e-5 else 1


if __name__ == "__main__":
    raise SystemExit(main())
