#!/usr/bin/env python3
"""The JAX package's iteration counts on the host CPU under each of
XLA's CPU instruction sets, beside the port's, for the two parity cases
whose reference count moves with XLA's vectorisation:

  * ``bicgstab_f32``: ``tests/test_torch_krylov_extra.py``'s BICGSTAB
    case in f32 on the 10^3 Poisson system;
  * ``sstep_every0`` / ``sstep_every1``:
    ``tests/test_torch_solvers_extra.py``'s SSTEP_PCG (s = 8) on the
    ill-conditioned 24^2 operator, without and with residual
    replacement.

Each instruction set runs in a fresh process (``XLA_FLAGS`` is read
when XLA starts) with the tests' own helpers, configs and torch
threads, and no persistent compilation cache.  Prints one JSON line:
``{isa: {case: {"jax": iters, "port": iters, ...}}}``.

    JAX_PLATFORMS=cpu python ci/torch_jax_isa_band.py
"""

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ISAS = ("SSE4_2", "AVX2", None)


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import torch

    from amgx_tpu.io.poisson import poisson_scipy

    torch.set_num_threads(2)  # the test modules' fixture
    out = {}
    tk = _module("test_torch_krylov_extra")
    jr, tr, _ = tk._solve_both(tk.KRYLOV["bicgstab"],
                               poisson_scipy((10, 10, 10)), np.float32)
    out["bicgstab_f32"] = {"jax": int(jr.iters), "port": int(tr.iters),
                           "jax_status": int(jr.status),
                           "port_status": int(tr.status)}
    ts = _module("test_torch_solvers_extra")
    import scipy.sparse as sps

    sp, b = ts._poisson()
    sp = (sp + sps.diags_array(
        np.linspace(0.0, 50.0, sp.shape[0]) ** 2 * 1e-4)).tocsr()
    sp.sort_indices()
    for every in (0, 1):
        text = ts._krylov_cfg("SSTEP_PCG",
                              f'"s_step": 8, "sstep_replace_every": {every},')
        js, tsol = ts._setup_both(text, sp, nested=True)
        jr, tr = js.solve(b), tsol.solve(b)
        out[f"sstep_every{every}"] = {
            "jax": int(jr.iters), "port": int(tr.iters),
            "jax_status": int(jr.status), "port_status": int(tr.status),
            "jax_rel_res": ts._rel_res(sp, np.asarray(jr.x), b),
            "port_rel_res": ts._rel_res(sp, tr.x.numpy(), b)}
    print(json.dumps(out), flush=True)


def main():
    res = {}
    for isa in ISAS:
        flags = "--xla_force_host_platform_device_count=8"
        if isa:
            flags += f" --xla_cpu_max_isa={isa}"
        env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
                   PYTHONPATH=ROOT)
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        p = subprocess.run([sys.executable, __file__, "--child"], env=env,
                           capture_output=True, text=True, cwd=ROOT)
        if p.returncode != 0:
            raise SystemExit(f"{isa}: exit {p.returncode}\n{p.stderr[-3000:]}")
        res[isa or "default"] = json.loads(p.stdout.strip().splitlines()[-1])
    print(json.dumps(res))


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        main()
