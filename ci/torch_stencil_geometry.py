"""Time the PyTorch port's stencil kernel under its launch plan and
under other geometries, on one CUDA card, to check the plan's choices.

    python3 ci/torch_stencil_geometry.py

For each case (the 7-point star at 128^3 in f32 and f64, the 27-point
box at 64^3, the 19-point stencil and a 7-point one two points wide
along x at 128^3, the 2D 5-point stencil on 2048 x 1024), the plan
``ops/stencil.py:stencil_launch_plan`` gives and variants of it (other z
chunks; for the 2D grid its rows walked by the tile kernel, or one
plane of 32 x 8 blocks) launch the kernel through its C entry point.
Each launch is held bit for bit to the DIA kernel on the same matrix.
One JSON line per launch: the plan, CUDA-event times with L2 flushed
and left warm, and the profiler's device time (``chip_smoke.py``'s
timer).  Needs a CUDA card; imports nothing of JAX or ``amgx_tpu``.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_stencil_geometry: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_of_this_checkout", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import scipy.sparse as sps

    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_scipy
    from amgx_tpu_torch.ops import dia, kernels, stencil

    timer = smoke.Timer(torch)
    rng = np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = kernels.library("stencil_spmv")
    box = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]
    nineteen = [st for st in box if sum(map(abs, st)) <= 2]
    wide = [(0, 0, -1), (-2, 0, 0), (-1, 0, 0), (0, 0, 0), (1, 0, 0),
            (2, 0, 0), (0, 0, 1)]
    wide_c = [-1.0, 0.0625, -1.25, 4.375, -1.25, 0.0625, -1.0]
    ones3 = sps.diags_array([np.ones(63), np.ones(64), np.ones(63)],
                            offsets=[-1, 0, 1], format="csr")

    def rechunk(p, zc):
        return p._replace(blocks=p.blocks[:2] + (-(-p.grid[2] // zc),),
                          zchunk=zc)

    def walk_with_tile(p):  # the 2D grid's rows on the tile kernel
        nx, _, nz = p.grid
        return p._replace(blocks=(-(-nx // 32), 1, -(-nz // 16)),
                          threads=(32, 1), zchunk=16, nd_inst=27)

    def one_plane(p):  # no walk: one plane of 32 x 8 blocks
        nx, _, ny = p.grid
        return p._replace(grid=(nx, ny, 1),
                          steps=tuple((dx, dz, 0) for dx, _, dz in p.steps),
                          blocks=(-(-nx // 32), -(-ny // 8), 1),
                          threads=(32, 8), zchunk=1)

    cases = (
        ("star 128^3", poisson_scipy((128, 128, 128)), np.float32, None,
         lambda p: [rechunk(p, 4), rechunk(p, 16)]),
        ("star 128^3", poisson_scipy((128, 128, 128)), np.float64, None,
         lambda p: [rechunk(p, 8), rechunk(p, 32)]),
        ("27-point box 64^3",
         sps.kron(sps.kron(ones3, ones3), ones3, format="csr"), np.float32,
         None, lambda p: [rechunk(p, 2), rechunk(p, 8)]),
        ("19-point 128^3", smoke.stencil_scipy(
            (128, 128, 128), nineteen, [-1.0] * 9 + [18.0] + [-1.0] * 9),
         np.float32, None, lambda p: [rechunk(p, 8), rechunk(p, 16)]),
        ("wide-x 7-point 128^3",
         smoke.stencil_scipy((128, 128, 128), wide, wide_c), np.float32,
         (wide, wide_c), lambda p: [rechunk(p, 4), rechunk(p, 32)]),
        ("2D 5-point 2048x1024", poisson_scipy((1024, 2048)), np.float32,
         None, lambda p: [rechunk(p, 4), rechunk(p, 64), walk_with_tile(p),
                          one_plane(p)]),
    )
    for label, sp, dtype, hand, variants in cases:
        sp = sp.astype(dtype)
        D = SparseMatrix.from_scipy(sp, device="cuda", accel_formats=("dia",))
        if hand is None:
            A = SparseMatrix.from_scipy(sp, device="cuda",
                                        accel_formats=("matrix_free",))
            meta, coefs = A.mf_meta, A.mf_coefs
        else:  # a stencil detection does not yield
            meta = stencil.StencilMeta("const", (128, 128, 128),
                                       tuple(hand[0]), D.dia_offsets)
            A = None
            coefs = torch.tensor(hand[1], device="cuda",
                                 dtype=getattr(torch, np.dtype(dtype).name))
        x = torch.from_numpy(
            rng.standard_normal(sp.shape[0]).astype(dtype)).cuda()
        y = torch.empty_like(x)
        y_dia = dia.dia_spmv(D.dia_vals, D.dia_offsets_dev, x)
        fn = getattr(lib, stencil._FN[x.dtype])
        plan = stencil.stencil_launch_plan(meta.grid, meta.steps,
                                           16 // x.element_size(), sms)
        for p in [plan] + variants(plan):
            arr = stencil.pack_plan(p)

            def run():
                rc = fn(coefs.data_ptr(), x.data_ptr(), y.data_ptr(),
                        ctypes.addressof(arr),
                        kernels.stream_handle(x.device))
                kernels.check_launch("stencil_spmv", rc)
                return y

            run()
            torch.cuda.synchronize()
            if not torch.equal(y, y_dia):
                raise RuntimeError(f"{label} {p}: differs from DIA")
            print(json.dumps({
                "case": label, "dtype": np.dtype(dtype).name,
                "plan": p._asdict(), "is_plan": p == plan,
                "ms": timer(run), "ms_warm_l2": timer(run, flush=False),
                "device_ms": timer.device(run, "stencil_"),
            }), flush=True)
        del A, D, x, y, y_dia
    return 0


if __name__ == "__main__":
    sys.exit(main())
