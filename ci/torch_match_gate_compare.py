"""Measure what the torch matcher's width gate and its ranks sorted on
the card do to aggregation setup, on one CUDA card.

    python3 ci/torch_match_gate_compare.py [--n 128] [--block-n 64]
                                           [--device cuda]

``amg/aggregation.py`` runs the handshake rounds of the pairwise
matcher on the card for graphs of rows up to
``_DEVICE_ROUNDS_MAX_WIDTH`` (128) neighbours, the edges' preference
ranks sorted there by ``torch.sort``.  The JAX package's gate is
``_DEVICE_MATCH_MAX_WIDTH`` (32), with the ranks sorted on the host by
``np.lexsort``; "narrow" puts that back for the run (the module's
``_match_ell_arrays`` wrapped), "wide" is the module as it stands.
Both set up, on the card in f32, the two aggregation paths that match:

* ``device_match``: ``chip_smoke.SIZE2_MATCH_CFG`` (PCG + SIZE_2
  aggregation by matching) on the 7-point Poisson ``--n``^3;
* ``block4_amg_pcg``: ``chip_smoke.BLOCK4_AMG_CFG`` on the b = 4 system
  at ``--block-n``^3 block rows (AMG on its scalar expansion).

The runs go narrow, wide, wide, narrow in one process.  Each prints one
JSON line: the path, the mode, ``setup_s`` (host clock around
``setup``, ending in a synchronize), the setup profile, the matcher's
passes (rows and width of each graph, and whether its rounds ran on
the card) and the levels.  A last line holds each path's setup seconds
by mode; the script fails if a path's levels differ between modes.

Needs a CUDA card (``--device cpu``, with ``AMGX_TPU_TORCH_DEVICE_MATCH=1``
so that the rounds run on CPU tensors, checks the script at small
sizes); imports nothing of JAX or of ``amgx_tpu``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
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


def narrow_arrays(real, ag, torch):
    """``_match_ell_arrays`` as the JAX package's gate and host ranks
    give it: None above ``_DEVICE_MATCH_MAX_WIDTH``, else the host
    arrays copied to ``device``."""

    def arrays(W, max_width=None, device=None):
        ell = real(W, ag._DEVICE_MATCH_MAX_WIDTH)
        if ell is None or device is None:
            return ell
        return tuple(torch.from_numpy(a).to(device) for a in ell)

    return arrays


def setup_once(torch, smoke, path, n, block_n, device):
    """Upload and set up ``path`` on ``device``; (setup_s, solver)."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_3d_7pt

    if path == "device_match":
        A = poisson_3d_7pt(n, dtype=np.float32, device=device)
        cfg = smoke.SIZE2_MATCH_CFG
    else:
        bsr = smoke.block4_scipy(block_n, np.float32)
        A = SparseMatrix.from_csr(bsr.indptr, bsr.indices, bsr.data,
                                  block_size=smoke.BLOCK_B, device=device)
        cfg = smoke.BLOCK4_AMG_CFG
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    s = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                        device=device)
    with warnings.catch_warnings():
        # the notice that AMG expands the block matrix to scalars
        warnings.simplefilter("ignore", UserWarning)
        s.setup(A)
    sync()
    return time.perf_counter() - t0, s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--block-n", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("torch_match_gate_compare: CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(HERE))
    smoke = _smoke()
    from amgx_tpu_torch.amg import aggregation as ag
    from amgx_tpu_torch.ops import kernels

    if cuda:
        print(smoke.card_line(), flush=True)
        kernels.build()
    real_arrays, real_rounds = ag._match_ell_arrays, ag._device_match_rounds
    passes = []

    def rounds(cols, ranks, max_rounds):
        passes.append({"rows": int(cols.shape[0]),
                       "width": int(cols.shape[1]), "card": True})
        return real_rounds(cols, ranks, max_rounds)

    real_device = ag.pairwise_match_device

    def device(W, *a, **kw):
        lens = np.diff(W.indptr)
        passes.append({"rows": int(W.shape[0]),
                       "width": int(lens.max()) if lens.size else 0,
                       "card": False})
        return real_device(W, *a, **kw)

    got = {}
    ag._device_match_rounds, ag.pairwise_match_device = rounds, device
    try:
        for mode in ("narrow", "wide", "wide", "narrow"):
            ag._match_ell_arrays = (narrow_arrays(real_arrays, ag, torch)
                                    if mode == "narrow" else real_arrays)
            for path in ("device_match", "block4_amg_pcg"):
                passes.clear()
                setup_s, s = setup_once(torch, smoke, path, args.n,
                                        args.block_n, args.device)
                amg = s.precond
                # a pass whose rounds ran is entered twice: keep the
                # entry of the rounds
                merged = []
                for p in passes:
                    if p["card"] and merged and not merged[-1]["card"] \
                            and merged[-1]["rows"] == p["rows"]:
                        merged[-1] = p
                    else:
                        merged.append(p)
                rec = {"path": path, "mode": mode, "setup_s": setup_s,
                       "setup_profile": amg.setup_profile,
                       "matcher_passes": merged,
                       "levels": amg.level_summary()}
                print(json.dumps(rec), flush=True)
                got.setdefault(path, []).append(rec)
                del s, amg
                if cuda:
                    torch.cuda.empty_cache()
    finally:
        ag._match_ell_arrays = real_arrays
        ag._device_match_rounds = real_rounds
        ag.pairwise_match_device = real_device
    for path, recs in got.items():
        smoke.check(all(r["levels"] == recs[0]["levels"] for r in recs),
                    f"{path}: the levels differ between the gates")
    print(json.dumps({"setup_s": {
        path: {mode: [r["setup_s"] for r in recs if r["mode"] == mode]
               for mode in ("narrow", "wide")}
        for path, recs in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
