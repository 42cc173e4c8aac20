"""Measure the batched sliced ELL SpMV (``sell_spmv_batched``) of the
PyTorch port on one CUDA card beside the slot-major batched entry
(``ell_spmv_batched``) and a block-diagonal CSR ``torch.mv`` of the
same work.

    python3 ci/torch_sell_batched_compare.py [--batches 16,8] [--n 64]

The operator is the serve layer's padded template of
``chip_smoke.irregular_poisson(n)`` (an ELL template with the sliced
layout), B instances of jittered values, as ``chip_smoke.py``'s
kernels phase builds it.  For each batch of ``--batches``, in f64 and
f32, batched and shared values, the output is held bit for bit,
instance by instance, to the unbatched ``sell_spmv`` and within
``chip_smoke.TOL`` to ``sell_spmv_batched_plain``; then it is timed
with L2 flushed (CUDA events, median of 25; ``chip_smoke.Timer``)
beside ``ell_spmv_batched`` on the same values and ``torch.mv``.
Beside the times: the kernel's two launches apart (profiler device
time: the copy of x, the product), its time with every column id 0 (no
gather leaves L1: what the values' stream alone costs; that output is
not checked), and the ptxas lines of the batched sliced kernels
(registers, spills).  Bounds: the pattern's nonzeros (the structure
once, values, x and y B times) and the layout's stream (every stored
slot).  Prints one JSON line.

Needs a CUDA card; imports nothing of JAX or of ``amgx_tpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_of_this_checkout", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_lines(text):
    """The ptxas register and spill lines of the batched sliced kernels
    (the function line, then its usage line)."""
    lines = text.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "sell_spmv_batched_kernel" in line and "Compiling" in line:
            out += [x.strip() for x in lines[i + 1:i + 4]
                    if "spill" in x or "registers" in x]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="16,8")
    ap.add_argument("--n", type=int, default=64)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("torch_sell_batched_compare: no CUDA card", file=sys.stderr)
        return 2
    smoke = _smoke()
    from amgx_tpu_torch.ops import ell, kernels
    from amgx_tpu_torch.serve.bucketing import pad_pattern

    kernels.build()
    report = kernels.BUILD_DIR / "ell_spmv.ptxas.txt"
    ptxas = ptxas_lines(report.read_text()) if report.exists() else None
    name = torch.cuda.get_device_name(0)
    peaks = smoke.peaks_for(name)
    timer = smoke.Timer(torch)
    rng = np.random.default_rng(0)
    irr = smoke.irregular_poisson(args.n)
    pat = pad_pattern(irr.indptr, irr.indices, irr.shape[0])
    cases = []
    for B in (int(b) for b in args.batches.split(",")):
        for dt, shared in ((torch.float64, False), (torch.float32, False),
                           (torch.float64, True), (torch.float32, True)):
            isz = 8 if dt == torch.float64 else 4
            npdt = np.float64 if isz == 8 else np.float32
            A = pat.template_matrix(irr.data, npdt, accel_formats=("ell",),
                                    device="cuda")
            smoke.check(A.sell is not None,
                        "the template has no sliced layout")
            vals = np.stack([pat.embed_values(
                irr.data * (1.0 + 0.05 * rng.standard_normal(irr.nnz)), npdt)
                for _ in range(B)])
            Ab = A.replace_values_batched(torch.from_numpy(vals).cuda())
            M = A if shared else Ab
            S = M.sell
            # the slot-major values (a sliced batched view keeps none)
            slot = A.ell_vals if shared else torch.stack(
                [A.replace_values(Ab.values[i]).ell_vals for i in range(B)])
            x = torch.from_numpy(
                rng.standard_normal((B, pat.nb))).cuda().to(dt)
            run = lambda: ell.sell_spmv_batched(S, x)  # noqa: E731
            y = run()
            torch.cuda.synchronize()
            bitwise = all(torch.equal(y[i], ell.sell_spmv(
                S if shared else dataclasses.replace(S, vals=S.vals[i]),
                x[i])) for i in range(B))
            _, rel = smoke.rel_err(y, ell.sell_spmv_batched_plain(S, x))
            smoke.check(bitwise and rel <= smoke.TOL[str(dt)[6:]],
                        f"{dt} shared={shared} B={B}: bit for bit "
                        f"{bitwise}, rel err {rel}")
            S0 = dataclasses.replace(S, cols=torch.zeros_like(S.cols))
            lib_m = smoke.blockdiag_csr(
                torch, pat.row_offsets, pat.col_indices,
                A.values.expand(B, -1).contiguous() if shared else Ab.values,
                pat.nb)
            nnz_bytes = ((4 + isz if shared else 4) * irr.nnz
                         + isz * B * ((0 if shared else irr.nnz)
                                      + 2 * pat.nb))
            stream = ((4 + isz if shared else 4) * S.stored
                      + isz * B * ((0 if shared else S.stored) + 2 * pat.nb)
                      + 4 * pat.nb + 12 * S.n_slices)
            cases.append({
                "dtype": str(dt)[6:], "shared_values": shared, "batch": B,
                "rows": pat.nb, "nonzeros": irr.nnz,
                "stored_slots": S.stored, "slices": S.n_slices,
                "sigma": S.sigma, "lanes": S.lanes,
                "bitwise_unbatched": bitwise, "max_rel_err": rel,
                "ms": timer(run),
                "device_ms": {k: timer.device(run, k) for k in (
                    "batch_tiles_kernel", "sell_spmv_batched_kernel")},
                "no_gather_ms": timer(lambda: ell.sell_spmv_batched(S0, x)),
                "ell_spmv_batched_ms": timer(lambda: ell.ell_spmv_batched(
                    A.ell_cols, slot, x)),
                "library_ms": timer(lambda: torch.mv(lib_m, x.reshape(-1))),
                "nonzero_bound_ms": nnz_bytes / peaks["bw"] * 1e3,
                "stream_bound_ms": stream / peaks["bw"] * 1e3})
            del A, Ab, M, S, S0, x, y, lib_m, slot
            torch.cuda.empty_cache()
    print(json.dumps({"card": smoke.card_line(), "device": name,
                      "ptxas": ptxas, "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
