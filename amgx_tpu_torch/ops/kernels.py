"""Build and load the hand-written CUDA kernels (``amgx_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, never at import (the CPU tests import every module
on machines without ``nvcc``), into ``amgx_tpu_torch/_build/``, which
git ignores.  Libraries are keyed by a hash of their source and flags,
so an edited source rebuilds.  :func:`build` starts one ``nvcc`` per
source, all at once, and waits for all of them.

``NVCC`` overrides the compiler path; otherwise ``nvcc`` on ``PATH``,
then ``/usr/local/cuda/bin/nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("dia_spmv", "ell_spmv", "stencil_spmv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# every pointer and the stream as c_void_p so ctypes passes 64 bits.
# DIA and ELL: (pointer, pointer, int, x, y, rows, stream); stencil:
# (coefs, x, y, host int array of the grid, the launch plan and the
# steps, stream)
_SIGNATURES = {
    "dia_spmv": {
        "dia_spmv_f32": (_P, _P, _I, _P, _P, _LL, _P),
        "dia_spmv_f64": (_P, _P, _I, _P, _P, _LL, _P),
    },
    "ell_spmv": {
        "ell_spmv_f32": (_P, _P, _I, _P, _P, _LL, _P),
        "ell_spmv_f64": (_P, _P, _I, _P, _P, _LL, _P),
    },
    "stencil_spmv": {
        "stencil_spmv_f32": (_P, _P, _P, _P, _P),
        "stencil_spmv_f64": (_P, _P, _P, _P, _P),
    },
}

_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    path = (
        os.environ.get("NVCC")
        or shutil.which("nvcc")
        or "/usr/local/cuda/bin/nvcc"
    )
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (looked at {path!r}); the CUDA kernels are "
            "built on a machine with the CUDA toolkit"
        )
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source that is not built yet, one ``nvcc``
    process per source, all started together.  Returns
    ``{name: library path}``; raises with the compiler output when a
    build fails.  The ``-Xptxas -v`` report (registers, spills) of
    each build is kept beside the library as ``<name>.ptxas.txt``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if todo:
        nvcc = nvcc_path()
        procs = {}
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            (BUILD_DIR / f"{n}.ptxas.txt").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{n}: nvcc exit {proc.returncode}\n{out}")
                continue
            os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {rc} "
            f"({torch.cuda.get_device_name()})"
        )
