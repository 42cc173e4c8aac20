"""Build and load the hand-written CUDA kernels (``amgx_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, never at import (the CPU tests import every module
on machines without ``nvcc``), into ``amgx_tpu_torch/_build/``, which
git ignores.  Libraries are keyed by a hash of their source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds.  :func:`build` starts one ``nvcc`` per
source, all at once, and waits for all of them.

``NVCC`` overrides the compiler path; otherwise ``nvcc`` on ``PATH``,
then ``/usr/local/cuda/bin/nvcc``.

:func:`build_native` builds the C API's native shim
(``native/amgx_tpu_torch_c.c``, which embeds Python and dispatches into
``amgx_tpu_torch.api.capi``) and its C host program
(``native/capi_poisson.c``) with ``cc`` the same way: at first use,
keyed by a hash of the sources and flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import shlex
import subprocess
import sys
import sysconfig
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
# DIA: (vals, x, y, rows, host int array of the launch plan and the
# offsets, stream); ELL: (cols, vals, width, x, y, rows, stream); sliced
# ELL: (cols, vals, offsets, widths, row permutation or None, slices,
# lanes, x, y, rows, stream); stencil: (coefs, x, y, host int array of
# the grid, the launch plan and the steps, stream).  An entry point is
# named for its value dtype, then for x's where that differs
# (``ell_spmv_bf16_f32``: bf16 values, f32 x, f32 y).  The batched
# entry points of the serve layer add the batch and whether its values
# are shared: DIA (vals, x, y, rows, batch, shared, plan, stream), ELL
# (cols, vals, width, x, y, rows, columns, batch, shared, stream),
# sliced ELL (cols, vals, offsets, widths, row permutation or None,
# slices, lanes, x, y, rows, columns, stored slots, batch, shared,
# scratch, stream)
_DIA = (_P, _P, _P, _LL, _P, _P)
_DIA_BATCHED = (_P, _P, _P, _LL, _LL, _I, _P, _P)
_ELL = (_P, _P, _I, _P, _P, _LL, _P)
_ELL_BATCHED = (_P, _P, _I, _P, _P, _LL, _LL, _LL, _I, _P)
_SELL = (_P, _P, _P, _P, _P, _LL, _I, _P, _P, _LL, _P)
_SELL_BATCHED = (_P, _P, _P, _P, _P, _LL, _I, _P, _P, _LL, _LL, _LL, _LL,
                 _I, _P, _P)
_STENCIL = (_P, _P, _P, _P, _P)
# the (values, x) pairs every unbatched kernel is built for: one dtype
# (f32, f64, bf16, c64, c128), or the narrower values under wider x of
# the mixed modes (dFBI, dDFI / dIFI, dZCI); the batched kernels take
# values and x of one dtype
PAIRS = ("f32", "f64", "bf16", "bf16_f32", "f32_f64", "c64", "c128",
         "c64_c128")
BATCHED = ("f32", "f64", "c64", "c128")
_SIGNATURES = {
    "dia_spmv": {
        **{f"dia_spmv_{t}": _DIA for t in PAIRS},
        **{f"dia_spmv_batched_{t}": _DIA_BATCHED for t in BATCHED},
    },
    "ell_spmv": {
        **{f"ell_spmv_{t}": _ELL for t in PAIRS},
        **{f"ell_spmv_batched_{t}": _ELL_BATCHED for t in BATCHED},
        **{f"sell_spmv_{t}": _SELL for t in PAIRS},
        **{f"sell_spmv_batched_{t}": _SELL_BATCHED for t in BATCHED},
    },
    "stencil_spmv": {f"stencil_spmv_{t}": _STENCIL for t in PAIRS},
}

_SHORT = {torch.float32: "f32", torch.float64: "f64",
          torch.bfloat16: "bf16", torch.complex64: "c64",
          torch.complex128: "c128"}


def entry_point(kernel: str, vals_dtype, x_dtype):
    """The entry point of ``kernel`` for values of ``vals_dtype`` and x
    of ``x_dtype`` (``_SIGNATURES``), or None where none is built."""
    v, x = _SHORT.get(vals_dtype), _SHORT.get(x_dtype)
    if v is None or x is None:
        return None
    name = f"{kernel}_{v}" if v == x else f"{kernel}_{v}_{x}"
    return name if name in _SIGNATURES[library_of(kernel)] else None


def library_of(kernel: str) -> str:
    """The source (``csrc/<name>.cu``) that holds ``kernel``'s entry
    points: ``sell_spmv`` and the batched entries live beside their
    unbatched kernels."""
    kernel = kernel.removesuffix("_batched")
    return "ell_spmv" if kernel == "sell_spmv" else kernel

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
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
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


NATIVE = _PKG / "native"
NATIVE_SOURCES = ("amgx_tpu_torch_c.c", "amgx_tpu_torch_c.h",
                  "capi_poisson.c")


def python_config(*args) -> list:
    """The output of ``python3-config <args> --embed`` for this
    interpreter (the one in its installation's BINDIR first: a venv's
    interpreter has none of its own), split into arguments."""
    ver = sysconfig.get_config_var("VERSION")
    bindir = sysconfig.get_config_var("BINDIR") or ""
    for tool in (os.path.join(bindir, f"python{ver}-config"),
                 f"{sys.executable}-config",
                 shutil.which(f"python{ver}-config") or "",
                 shutil.which("python3-config") or ""):
        if tool and os.path.exists(tool):
            out = subprocess.run([tool, *args, "--embed"], check=True,
                                 capture_output=True, text=True).stdout
            return shlex.split(out)
    raise RuntimeError("python3-config not found: the native C API is "
                       "built against the embedding flags of this "
                       "interpreter")


def build_native(out_dir=None) -> dict:
    """Build the native shim ``libamgx_tpu_torch_c_<hash>.so`` and the C
    host program ``capi_poisson_<hash>`` into ``out_dir`` (default
    ``_build/``, whence the shim finds the repository root two
    directories up), with ``cc`` (``CC`` overrides) and the embedding
    flags of ``python3-config``; each is built only where it is missing.
    Returns ``{"lib": path, "program": path}``; raises with the compiler
    output when a build fails."""
    out = Path(out_dir) if out_dir is not None else BUILD_DIR
    out.mkdir(parents=True, exist_ok=True)
    cc = os.environ.get("CC") or shutil.which("cc") or "gcc"
    cflags = python_config("--cflags")
    ldflags = python_config("--ldflags")
    # the libpython directory, for the loader at run time
    rpath = [f"-Wl,-rpath,{f[2:]}" for f in ldflags if f.startswith("-L")]
    h = hashlib.sha256()
    for name in NATIVE_SOURCES:
        h.update((NATIVE / name).read_bytes())
    h.update(" ".join([cc, *cflags, *ldflags]).encode())
    tag = h.hexdigest()[:16]
    lib = out / f"libamgx_tpu_torch_c_{tag}.so"
    prog = out / f"capi_poisson_{tag}"
    steps = (
        (lib, [cc, "-O2", "-fPIC", "-shared", *cflags, "-I", str(NATIVE),
               str(NATIVE / "amgx_tpu_torch_c.c"), *ldflags, *rpath]),
        (prog, [cc, "-O2", *cflags, "-I", str(NATIVE),
                str(NATIVE / "capi_poisson.c"), str(lib),
                f"-Wl,-rpath,{out}", *ldflags, *rpath, "-lm"]),
    )
    for target, cmd in steps:
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        r = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native build of {target.name} failed "
                               f"(exit {r.returncode}):\n{r.stdout}"
                               f"{r.stderr}")
        os.replace(tmp, target)
    return {"lib": lib, "program": prog}
