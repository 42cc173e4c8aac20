"""The port's native C shim (``amgx_tpu_torch/native/amgx_tpu_torch_c.c``)
on the CPU: built with ``cc`` (``kernels.build_native``) into a
temporary directory, loaded into this interpreter with
``ctypes.PyDLL`` (``AMGX_initialize`` then takes its
``Py_IsInitialized()`` branch and the GIL stays the caller's), and
driven in ``h`` modes: an hDDI PCG + aggregation AMG solve returns 0
from every entry point, with the iterations and x of the Python handle
layer bit for bit; bad handles, modes and the entry points not ported
give their RCs; the print callback reaches C.  Then the C host program
(``native/capi_poisson.c``) in a subprocess: its own CSR, its own
residual, x written to a file bit for bit equal to the in-process
solve of the same system.
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from amgx_tpu_torch.api import capi as T
from amgx_tpu_torch.io.poisson import poisson_scipy
from amgx_tpu_torch.ops import kernels
from tests.test_torch_capi import BENCH, CFG, handle_flow

H = ctypes.c_uint64
P = ctypes.c_void_p
PRINT_CB = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_int)


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    return kernels.build_native(tmp_path_factory.mktemp("native"))


@pytest.fixture(scope="module")
def lib(native):
    lib = ctypes.PyDLL(str(native["lib"]))
    assert lib.AMGX_initialize() == 0
    yield lib
    assert lib.AMGX_finalize() == 0


def handle(lib, fn, *args):
    h = H()
    rc = getattr(lib, fn)(ctypes.byref(h), *args)
    return rc, h


def mode_arg(m):
    return ctypes.c_char_p(m.encode())


def shim_solve(lib, cfg, mode, sp, b):
    """A host code's solve through the shim: (rcs, iterations, x)."""
    n = sp.shape[0]
    rcs = []
    rc, c = handle(lib, "AMGX_config_create", ctypes.c_char_p(cfg.encode()))
    rcs.append(rc)
    rc, r = handle(lib, "AMGX_resources_create_simple", c)
    rcs.append(rc)
    rc, A = handle(lib, "AMGX_matrix_create", r, mode_arg(mode))
    rcs.append(rc)
    rp = sp.indptr.astype(np.int32)
    ci = sp.indices.astype(np.int32)
    v = sp.data.astype(np.float64)
    rcs.append(lib.AMGX_matrix_upload_all(A, n, sp.nnz, 1, 1,
                                          rp.ctypes.data_as(P),
                                          ci.ctypes.data_as(P),
                                          v.ctypes.data_as(P), None))
    rc, vb = handle(lib, "AMGX_vector_create", r, mode_arg(mode))
    rcs.append(rc)
    rc, vx = handle(lib, "AMGX_vector_create", r, mode_arg(mode))
    rcs.append(rc)
    rcs.append(lib.AMGX_vector_upload(vb, n, 1, b.ctypes.data_as(P)))
    rcs.append(lib.AMGX_vector_set_zero(vx, n, 1))
    rc, s = handle(lib, "AMGX_solver_create", r, mode_arg(mode), c)
    rcs.append(rc)
    rcs.append(lib.AMGX_solver_setup(s, A))
    rcs.append(lib.AMGX_solver_solve(s, vb, vx))
    st, it = ctypes.c_int(-1), ctypes.c_int(-1)
    rcs.append(lib.AMGX_solver_get_status(s, ctypes.byref(st)))
    rcs.append(lib.AMGX_solver_get_iterations_number(s, ctypes.byref(it)))
    x = np.empty(n)
    rcs.append(lib.AMGX_vector_download(vx, x.ctypes.data_as(P)))
    nn, bx, by = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rcs.append(lib.AMGX_matrix_get_size(A, ctypes.byref(nn),
                                        ctypes.byref(bx), ctypes.byref(by)))
    assert (nn.value, bx.value, by.value) == (n, 1, 1)
    res0 = ctypes.c_double()
    rcs.append(lib.AMGX_solver_get_iteration_residual(s, 0, 0,
                                                      ctypes.byref(res0)))
    for fn, h in (("AMGX_solver_destroy", s), ("AMGX_vector_destroy", vx),
                  ("AMGX_vector_destroy", vb), ("AMGX_matrix_destroy", A),
                  ("AMGX_resources_destroy", r),
                  ("AMGX_config_destroy", c)):
        rcs.append(getattr(lib, fn)(h))
    return rcs, st.value, it.value, x, res0.value


def python_solve(cfg, mode, sp, b):
    return handle_flow(T, mode, cfg, sp=sp, rhs=b)[:3]


def test_initialize_and_version(lib):
    mj, mn = ctypes.c_int(), ctypes.c_int()
    assert lib.AMGX_initialize() == 0  # again: the running interpreter's
    assert lib.AMGX_get_api_version(ctypes.byref(mj), ctypes.byref(mn)) == 0
    assert (mj.value, mn.value) == (2, 5)
    lib.AMGX_get_error_string.restype = ctypes.c_char_p
    assert lib.AMGX_get_error_string(9) == b"bad mode"


@pytest.mark.parametrize("cfg", [BENCH, CFG], ids=["bench", "jacobi"])
def test_shim_solve_is_the_handle_layers_bit_for_bit(lib, cfg):
    sp = poisson_scipy((12, 12, 12)).tocsr()
    b = np.random.default_rng(4).standard_normal(sp.shape[0])
    rcs, st, it, x, res0 = shim_solve(lib, cfg, "hDDI", sp, b)
    assert rcs == [0] * len(rcs)
    ref = python_solve(cfg, "hDDI", sp, b)
    assert (st, it) == ref[:2] and st == 0 and it > 0
    assert np.array_equal(x, ref[2])
    assert res0 == pytest.approx(np.linalg.norm(b), rel=1e-12)


def test_shim_return_codes(lib):
    rc, c = handle(lib, "AMGX_config_create", ctypes.c_char_p(CFG.encode()))
    assert rc == 0
    rc, r = handle(lib, "AMGX_resources_create_simple", c)
    assert rc == 0
    assert handle(lib, "AMGX_matrix_create", r, mode_arg("xQQQ"))[0] == 9
    assert handle(lib, "AMGX_matrix_create", H(987654321),
                  mode_arg("hDDI"))[0] == 1
    # without a card a d mode names a target that is not there
    assert handle(lib, "AMGX_matrix_create", r, mode_arg("dDDI"))[0] == 3
    assert lib.AMGX_solver_setup(H(987654321), H(987654322)) == 1
    assert handle(lib, "AMGX_config_create",
                  ctypes.c_char_p(b"not json and not k=v"))[0] == 12
    rc, A = handle(lib, "AMGX_matrix_create", r, mode_arg("hDDI"))
    arr = (H * 1)(A.value)
    # the batched solve is ported: handle 1 names no solver
    assert lib.AMGX_solver_solve_batch(H(1), 1, arr, arr, arr) == 1
    assert lib.AMGX_distribution_create(ctypes.byref(H()), c) == 13


def test_print_callback_reaches_c(lib):
    got = []
    cb = PRINT_CB(lambda msg, n: got.append(msg[:n].decode()))
    assert lib.AMGX_register_print_callback(cb) == 0
    try:
        cfg = CFG.replace('"monitor_residual": 1,',
                          '"monitor_residual": 1, "print_solve_stats": 1,', 1)
        sp = poisson_scipy((6, 6, 6)).tocsr()
        rcs, st, it, *_ = shim_solve(lib, cfg, "hDDI", sp,
                                     np.ones(sp.shape[0]))
        assert rcs == [0] * len(rcs)
    finally:
        assert lib.AMGX_register_print_callback(None) == 0
    text = "".join(got)
    assert f"Total Iterations: {it}" in text
    assert text.count("\n") > it


def test_c_host_program(native, tmp_path):
    """capi_poisson in a subprocess (hDDI, 10^3, BENCH): status 0, its
    own residual below the tolerance, the iterations of the in-process
    solve of the same system and x bit for bit, lines through its print
    callback, RC_BAD_PARAMETERS for a bad handle."""
    g = 10
    cfg = BENCH.replace('"monitor_residual": 1,',
                        '"monitor_residual": 1, "print_solve_stats": 1,', 1)
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(cfg)
    xfile = tmp_path / "x.bin"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent.parent)] + sys.path))
    out = subprocess.run(
        [str(native["program"]), str(g), "hDDI", str(cfg_file), str(xfile)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    sp = poisson_scipy((g, g, g)).tocsr()
    sp.sort_indices()
    ref = python_solve(cfg, "hDDI", sp, np.ones(sp.shape[0]))
    assert rec["status"] == 0 and rec["rc_bad_handle"] == 1
    assert rec["rows"] == sp.shape[0] and rec["nnz"] == sp.nnz
    assert rec["api_version"] == [2, 5]
    assert rec["iterations"] == ref[1]
    assert rec["rel_residual"] < 1e-6
    assert rec["print_lines"] > rec["iterations"]
    x = np.fromfile(xfile, dtype=np.float64)
    assert np.array_equal(x, ref[2])

