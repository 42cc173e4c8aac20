#!/usr/bin/env python3
"""Seconds the port's kernel build takes (``amgx_tpu_torch.ops.kernels
.build``: one ``nvcc`` per ``csrc`` source, all started together) for
the tree at ``--root``, into a fresh build directory, with the card's
name and power limit.  Each ``--reps`` build starts from an empty
directory.  Prints one JSON line.

    python3 ci/torch_build_time.py --root DIR [--reps 2]

Put two trees in one call and alternate them (A, B, B, A) to compare
their builds on one machine.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from amgx_tpu_torch.ops import kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    secs = []
    for _ in range(args.reps):
        with tempfile.TemporaryDirectory(dir=root) as d:
            kernels.BUILD_DIR = Path(d)
            t0 = time.perf_counter()
            kernels.build()
            secs.append(time.perf_counter() - t0)
    print(json.dumps({"root": str(root), "card": card,
                      "sources": list(kernels.SOURCES),
                      "build_s": secs}))


if __name__ == "__main__":
    main()
