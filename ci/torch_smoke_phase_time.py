"""Time one phase of ``chip_smoke.py`` of one tree on one CUDA card: its
seconds and its kernel cases' event times, to hold a change of the
phase against its parent.

    python3 ci/torch_smoke_phase_time.py --phase kernels [--root DIR]
                                         [--tag NAME]

(``--phase``: ``kernels``, ``pcg_classical``, ``refine_bf16_256``,
``block4_amg_pcg``, ``capi`` or ``serve``.)

Imports ``chip_smoke`` (and with it ``amgx_tpu_torch``) from ``--root``
(default: the checkout that holds this script), builds that tree's
kernels, and runs the phase as ``chip_smoke.py`` runs it (its CPU port
runs started in the child process, ``CpuSide``), with every check.  Run
two trees, such as a commit and its parent unpacked with ``git archive``
into an ignored directory, in turns (parent, change, change, parent) in
one session on one card.  Prints one JSON line: the tag, the card's
``nvidia-smi`` name and power limit, the phase's seconds, those of them
it waited for the CPU port, and each kernel case's ``kernel_ms``,
``kernel_ms_warm_l2``, ``plain_ms`` and ``library_ms``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

TIMES = ("kernel_ms", "kernel_ms_warm_l2", "plain_ms", "library_ms")


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", required=True,
                    choices=("kernels", "pcg_classical", "refine_bf16_256",
                             "block4_amg_pcg", "capi", "serve"))
    ap.add_argument("--root", default=here)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("torch_smoke_phase_time: CUDA is not available",
              file=sys.stderr)
        return 2
    from amgx_tpu_torch.ops import kernels

    kernels.build()
    peaks = chip_smoke.peaks_for(torch.cuda.get_device_name(0))
    phase = {"kernels": chip_smoke.kernel_phase,
             "pcg_classical": chip_smoke.classical_phase,
             "refine_bf16_256": chip_smoke.refine_phase,
             "block4_amg_pcg": chip_smoke.block4_amg_phase,
             "capi": chip_smoke.capi_phase,
             "serve": lambda t, _peaks: chip_smoke.serve_phase(t)}[
                 args.phase]
    calls = chip_smoke.cpu_side_calls((args.phase,))
    # the parent's child_threads may not exist: the threads the phase's
    # runs get in chip_smoke.py's run
    threads = (chip_smoke.child_threads(torch, calls)
               if hasattr(chip_smoke, "child_threads")
               else [torch.get_num_threads()] * len(calls))
    chip_smoke.CPU.start(calls, threads)
    try:
        t0 = time.perf_counter()
        out = phase(torch, peaks)
        secs = time.perf_counter() - t0
        wait_s = chip_smoke.CPU.wait_s
    finally:
        chip_smoke.CPU.end()
    # a phase's kernel cases: its second result, its result, or none
    # (serve returns its launches only)
    recs = (out[1] if isinstance(out, tuple)
            else out if isinstance(out, list) else [])
    print(json.dumps({
        "tag": args.tag, "card": chip_smoke.card_line(),
        "phase": args.phase, "phase_s": secs, "cpu_side_wait_s": wait_s,
        "times": TIMES,
        "cases": {f"{r.get('kernel')} | {r.get('case')}":
                  [r.get(k) for k in TIMES] for r in recs}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
