"""C-API-compatible handle layer (reference include/amgx_c.h, 611 lines;
src/amgx_c.cu): the port's counterpart of the JAX package's
``api/capi.py``, single-device surface.

Functions mirror the AMGX_* surface with opaque integer handles and the
JAX package's names, arguments, return values and RC codes; errors
raise :class:`AMGXError` carrying an AMGX_RC code (the native C shim in
``native/`` turns it back into a return code, reference
AMGX_TRIES/AMGX_CATCHES).  Array arguments accept numpy arrays, any
buffer, or bytes (the C shim passes raw buffers sized by the mode's
dtypes).

Modes (dDDI, dDFI, ...) choose the vector and matrix dtypes
(``core/types.py``), and their memory-space letter the device: a ``d``
mode's matrices and solvers live on the card and raise
(``RC_NOT_SUPPORTED_TARGET``) without one, an ``h`` mode's on the CPU.
Matrices are built on that device in the mode's matrix dtype; bf16
values (dFBI) arrive as 2-byte words, read as ``uint16`` and viewed as
``torch.bfloat16``.  Vectors stay host numpy arrays of the mode's
vector dtype, as in the JAX package.

The batched solve (``solver_solve_batch`` and its accessors) runs on
the port's serve layer (``amgx_tpu_torch.serve``), the streaming
session calls (``solver_session_*``) on its sessions
(``amgx_tpu_torch.sessions``), the telemetry calls
(``solver_get_telemetry``, ``solver_telemetry_json``) on
``amgx_tpu_torch.telemetry``; ``solver_session_save`` writes a
session into an artifact store (``amgx_tpu_torch.store``).  The fault
site ``capi_internal`` (``core/faults.py``) raises inside the solve path
and comes back as an RC through the catch-all.  ``AMGX_TPU_CAPI_ADMISSION``
fronts the batched solve and the sessions with the admission gateway
(``amgx_tpu_torch.serve.gateway``): a shed system's status is FAILED.
``AMGX_TPU_FLEET`` sends the batched solve to a multi-process fleet
(``amgx_tpu_torch.fleet``) instead: a registry directory or a
``host:port`` list; a malformed spec or an empty registry fails with
RC_BAD_CONFIGURATION, an unreachable worker with RC_IO_ERROR, and a
session under it with RC_NOT_SUPPORTED_TARGET.  Not ported, each raising
``RC_NOT_IMPLEMENTED`` with the ``ROADMAP.md`` queue that brings it: the
distribution handles, partition data, one-ring maps, distributed reads
and writes and setup on more than one device (A.9).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Optional

import numpy as np
import torch

from amgx_tpu_torch.config.amg_config import AMGConfig, ConfigError
from amgx_tpu_torch.core.errors import (  # noqa: F401 — public re-exports
    RC_BAD_CONFIGURATION,
    RC_BAD_MODE,
    RC_BAD_PARAMETERS,
    RC_CORE,
    RC_CUDA_FAILURE,
    RC_INTERNAL,
    RC_IO_ERROR,
    RC_LICENSE_NOT_FOUND,
    RC_NO_MEMORY,
    RC_NOT_IMPLEMENTED,
    RC_NOT_SUPPORTED_BLOCKSIZE,
    RC_NOT_SUPPORTED_TARGET,
    RC_OK,
    RC_PLUGIN,
    RC_THRUST_FAILURE,
    RC_UNKNOWN,
    rc_for_exception,
)
from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.core.types import host_array, host_dtype, mode_from_name
from amgx_tpu_torch.core.types import mode_itemsizes as _itemsizes

# solve status (reference AMGX_SOLVE_*, amgx_c.h:75-80)
SOLVE_SUCCESS = 0
SOLVE_FAILED = 1
SOLVE_DIVERGED = 2
SOLVE_NOT_CONVERGED = 3


class AMGXError(Exception):
    def __init__(self, rc, msg=""):
        super().__init__(msg or f"AMGX_RC {rc}")
        self.rc = rc


def _rc_guard(fn):
    """Catch-all exception -> RC conversion (reference AMGX_TRIES /
    AMGX_CATCHES).  Every public entry point is wrapped
    (:func:`_install_rc_guards`), so the only exception that reaches
    the native shim is :class:`AMGXError` with a valid ``rc``: typed
    errors keep their codes, anything unexpected is RC_UNKNOWN."""

    @functools.wraps(fn)
    def wrap(*a, **k):
        try:
            return fn(*a, **k)
        except AMGXError:
            raise
        except Exception as e:
            raise AMGXError(
                rc_for_exception(e), f"{type(e).__name__}: {e}"
            ) from e

    wrap._rc_guarded = True
    return wrap


_lock = threading.Lock()
_next_handle = [1]
_objects: Dict[int, object] = {}


def _new(obj) -> int:
    with _lock:
        h = _next_handle[0]
        _next_handle[0] += 1
        _objects[h] = obj
    return h


def _get(h, cls=None):
    try:
        obj = _objects[h]
    except (KeyError, TypeError):
        raise AMGXError(RC_BAD_PARAMETERS, f"invalid handle {h}") from None
    if cls is not None and not isinstance(obj, cls):
        raise AMGXError(
            RC_BAD_PARAMETERS, f"handle {h} is not a {cls.__name__}"
        )
    return obj


def _mode(name):
    """The Mode of ``name``; RC_BAD_MODE for an unknown name."""
    try:
        return mode_from_name(name)
    except ValueError as e:
        raise AMGXError(RC_BAD_MODE, str(e)) from None


def _with_mode(res_h, mode, make):
    """A new handle of ``make(resources, Mode)``, checked as the JAX
    package checks (the mode, then the handle), then the device: a
    ``d`` mode without a card is RC_NOT_SUPPORTED_TARGET (an ``h`` mode
    asks for the CPU; nothing drops to it silently)."""
    m = _mode(mode)
    res = _get(res_h, _Resources)
    if m.device == "cuda" and not torch.cuda.is_available():
        raise AMGXError(
            RC_NOT_SUPPORTED_TARGET,
            f"mode {mode} runs on the card and CUDA is not available; "
            f"the h mode h{mode[1:]} runs on the CPU",
        )
    return _new(make(res, m))


def _not_ported(what, queue):
    raise AMGXError(
        RC_NOT_IMPLEMENTED,
        f"{what} is not ported to amgx_tpu_torch yet (ROADMAP.md, queue "
        f"{queue})",
    )


_A9 = "A.9: multi-GPU"


class _Config:
    def __init__(self, cfg: AMGConfig):
        self.cfg = cfg


class _Resources:
    def __init__(self, cfg: _Config, n_devices: int = 1):
        self.cfg = cfg
        self.n_devices = n_devices


class _Matrix:
    def __init__(self, res: _Resources, mode):
        self.res = res
        self.mode = mode
        self.A: Optional[SparseMatrix] = None
        # the whole system of upload_all_global and its row owners
        self.global_sp = None
        self.owner = None

    @property
    def cfg(self) -> Optional[AMGConfig]:
        """The resources' AMGConfig (reference getResourcesConfig)."""
        try:
            return self.res.cfg.cfg
        except AttributeError:
            return None


class _Vector:
    def __init__(self, res: _Resources, mode):
        self.res = res
        self.mode = mode
        self.data: Optional[np.ndarray] = None
        self.block_dim = 1
        self.bound_matrix: Optional[_Matrix] = None


class _SolverHandle:
    def __init__(self, res: _Resources, mode, cfg: _Config):
        self.res = res
        self.mode = mode
        self.cfg = cfg
        self.solver = None
        self.result = None
        # the batched solve's service, its in-flight tickets and its
        # per-system results (solver_solve_batch)
        self.batch_service = None
        # the admission gateway in front of it (AMGX_TPU_CAPI_ADMISSION)
        self.batch_gateway = None
        # the fleet frontend that replaces both (AMGX_TPU_FLEET)
        self.batch_fleet = None
        self.batch_pending = None
        self.batch_results = None
        # the sessions of solver_session_create, on batch_service
        self.session_manager = None


class _EigSolverHandle:
    def __init__(self, res, mode, cfg):
        self.res = res
        self.mode = mode
        self.cfg = cfg
        self.solver = None
        self.result = None
        self.personalization = None


# ---------------------------------------------------------------------------
# lifecycle (amgx_c.h:165-191)


def initialize():
    import amgx_tpu_torch

    amgx_tpu_torch.initialize()
    return RC_OK


def finalize():
    _objects.clear()
    return RC_OK


def get_api_version():
    from amgx_tpu_torch.version import get_api_version as _v

    return _v()


def register_print_callback(fn):
    from amgx_tpu_torch.core.printing import set_print_callback

    set_print_callback(fn)
    return RC_OK


def install_signal_handler():
    import faulthandler

    faulthandler.enable()
    return RC_OK


def reset_signal_handler():
    import faulthandler

    faulthandler.disable()
    return RC_OK


def mode_itemsizes(mode: str):
    """(matrix itemsize, vector itemsize) of a mode name; the native C
    shim sizes its buffers from this (bf16 is 2)."""
    try:
        return _itemsizes(mode)
    except ValueError as e:
        raise AMGXError(RC_BAD_MODE, str(e)) from None


def get_error_string(rc):
    names = {
        RC_OK: "success",
        RC_BAD_PARAMETERS: "bad parameters",
        RC_UNKNOWN: "unknown error",
        RC_NO_MEMORY: "out of memory / overloaded (admission shed)",
        RC_IO_ERROR: "I/O error",
        RC_BAD_MODE: "bad mode",
        RC_BAD_CONFIGURATION: "bad configuration",
        RC_NOT_IMPLEMENTED: "not implemented",
        RC_INTERNAL: "internal error",
    }
    return names.get(rc, f"error code {rc}")


# ---------------------------------------------------------------------------
# config (amgx_c.h:193-215)


def config_create(options: str) -> int:
    try:
        cfg = AMGConfig.from_string(options) if options.strip() else (
            AMGConfig()
        )
    except ConfigError as e:
        raise AMGXError(RC_BAD_CONFIGURATION, str(e)) from None
    return _new(_Config(cfg))


def config_create_from_file(path: str) -> int:
    try:
        cfg = AMGConfig.from_file(path)
    except FileNotFoundError as e:
        raise AMGXError(RC_IO_ERROR, str(e)) from None
    except ConfigError as e:
        raise AMGXError(RC_BAD_CONFIGURATION, str(e)) from None
    return _new(_Config(cfg))


def config_create_from_file_and_string(path: str, options: str) -> int:
    h = config_create_from_file(path)
    config_add_parameters(h, options)
    return h


def config_add_parameters(cfg_h: int, options: str):
    cfg = _get(cfg_h, _Config).cfg
    try:
        cfg.parse(options)
    except ConfigError as e:
        raise AMGXError(RC_BAD_CONFIGURATION, str(e)) from None
    return RC_OK


def config_get_default_number_of_rings(cfg_h: int) -> int:
    """Classical AMG needs 2 halo rings, aggregation 1 (reference
    AMGX_config_get_default_number_of_rings): any scope configured
    CLASSICAL (or the registry default, when nothing overrides it)
    means 2."""
    cfg = _get(cfg_h, _Config).cfg
    algos = [
        str(v).upper()
        for (scope, name), v in cfg.items().items()
        if name == "algorithm"
    ]
    if not algos:
        algos = [str(cfg.get("algorithm", "default")).upper()]
    return 2 if "CLASSICAL" in algos else 1


def config_destroy(cfg_h: int):
    _objects.pop(cfg_h, None)
    return RC_OK


# ---------------------------------------------------------------------------
# resources (amgx_c.h:218-230)


def resources_create_simple(cfg_h: int) -> int:
    return _new(_Resources(_get(cfg_h, _Config)))


def resources_create(
    cfg_h: int, comm=None, device_num: int = 1, devices=None
) -> int:
    """Reference AMGX_resources_create.  ``device_num`` is recorded; a
    setup over more than one device is not ported (queue A.9)."""
    n = int(device_num) if devices is None else len(list(devices))
    return _new(_Resources(_get(cfg_h, _Config), n_devices=max(n, 1)))


def resources_destroy(res_h: int):
    _objects.pop(res_h, None)
    return RC_OK


# ---------------------------------------------------------------------------
# matrix (amgx_c.h:262-333)


def matrix_create(res_h: int, mode: str = "dDDI") -> int:
    return _with_mode(res_h, mode, _Matrix)


def _as_array(buf, dtype, count):
    if buf is None:
        return None
    a = np.frombuffer(buf, dtype=dtype, count=count) if isinstance(
        buf, (bytes, bytearray, memoryview)
    ) else np.asarray(buf, dtype=dtype)
    return a.reshape(-1)[:count] if count >= 0 else a.reshape(-1)


def _mat_values(buf, mode, count):
    """Host values of a matrix upload in the mode's matrix dtype; bf16
    values come as float32 (every bf16 value is one): 2-byte words
    from a buffer, rounded from a float array otherwise."""
    if mode.mat_dtype != torch.bfloat16:
        return _as_array(buf, host_dtype(mode.mat_dtype), count)
    if isinstance(buf, (bytes, bytearray, memoryview)):
        words = np.frombuffer(buf, dtype=np.uint16, count=count)
        t = torch.from_numpy(words.view(np.int16).copy())
        return t.view(torch.bfloat16).float().numpy()
    a = np.asarray(buf, dtype=np.float32).reshape(-1)
    a = a[:count] if count >= 0 else a
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


def _built(A: SparseMatrix, mode) -> SparseMatrix:
    """``A`` (built from host values) in the mode's matrix dtype: bf16
    is cast on the device (``SparseMatrix.astype``)."""
    return A.astype(torch.bfloat16) if mode.mat_dtype == torch.bfloat16 \
        else A


def matrix_upload_all(
    mtx_h: int,
    n: int,
    nnz: int,
    block_dimx: int,
    block_dimy: int,
    row_ptrs,
    col_indices,
    data,
    diag_data=None,
):
    m = _get(mtx_h, _Matrix)
    if block_dimx != block_dimy:
        raise AMGXError(
            RC_NOT_SUPPORTED_BLOCKSIZE, "rectangular blocks unsupported"
        )
    b = block_dimx
    rp = _as_array(row_ptrs, np.int32, n + 1)
    ci = _as_array(col_indices, np.int32, nnz)
    vals = _mat_values(data, m.mode, nnz * b * b)
    # locally-indexed uploads may carry halo columns past n
    n_cols = max(n, int(ci.max()) + 1 if ci.size else n)
    dev = m.mode.device
    if diag_data is not None:
        # external diagonal: appended as explicit diagonal entries
        dg = _mat_values(diag_data, m.mode, n * b * b)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
        rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
        cols = np.concatenate([ci.astype(np.int64),
                               np.arange(n, dtype=np.int64)])
        allv = np.concatenate([vals.reshape(nnz, -1), dg.reshape(n, -1)])
        A = SparseMatrix.from_coo(
            rows, cols, allv if b > 1 else allv.reshape(-1), n_rows=n,
            n_cols=n_cols, block_size=b, device=dev,
        )
    else:
        A = SparseMatrix.from_csr(rp, ci, vals, n_cols=n_cols,
                                  block_size=b, device=dev)
    m.A = _built(A, m.mode)
    return RC_OK


def _upload_global(m, n_global, n, nnz, b, row_ptrs, col_indices_global,
                   data, diag_data, partition_vector, col_dtype):
    """upload_all_global[_32] when the whole system arrives in one call
    (n == n_global): the global CSR, its owners, and the single-device
    matrix.  A per-rank partial upload is queue A.9."""
    import scipy.sparse as sps

    if b != 1:
        raise AMGXError(
            RC_NOT_SUPPORTED_BLOCKSIZE,
            "distributed upload: scalar matrices only for now",
        )
    if n != n_global:
        _not_ported("a per-rank partial upload (n != n_global)", _A9)
    rp = _as_array(row_ptrs, np.int32, n + 1)
    ci = _as_array(col_indices_global, col_dtype, nnz)
    vals = _mat_values(data, m.mode, nnz)
    if diag_data is not None:
        dg = _mat_values(diag_data, m.mode, n)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
        rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
        cols = np.concatenate(
            [ci.astype(np.int64), np.arange(n, dtype=np.int64)]
        )
        sp = sps.csr_matrix((np.concatenate([vals, dg]), (rows, cols)),
                            shape=(n, n))
    else:
        sp = sps.csr_matrix((vals, ci.astype(np.int64), rp), shape=(n, n))
    sp.sum_duplicates()
    sp.sort_indices()
    m.global_sp = sp
    m.owner = (None if partition_vector is None
               else _as_array(partition_vector, np.int32, n))
    m.A = _built(SparseMatrix.from_scipy(sp, device=m.mode.device), m.mode)
    return RC_OK


def matrix_upload_all_global(
    mtx_h: int,
    n_global: int,
    n: int,
    nnz: int,
    block_dimx: int,
    block_dimy: int,
    row_ptrs,
    col_indices_global,
    data,
    diag_data=None,
    allocated_halo_depth: int = 1,
    num_import_rings: int = 1,
    partition_vector=None,
):
    """Reference AMGX_matrix_upload_all_global (64-bit global cols)."""
    m = _get(mtx_h, _Matrix)
    if block_dimx != block_dimy:
        raise AMGXError(
            RC_NOT_SUPPORTED_BLOCKSIZE, "rectangular blocks unsupported"
        )
    return _upload_global(
        m, n_global, n, nnz, block_dimx, row_ptrs, col_indices_global,
        data, diag_data, partition_vector, np.int64,
    )


def matrix_upload_all_global_32(
    mtx_h: int,
    n_global: int,
    n: int,
    nnz: int,
    block_dimx: int,
    block_dimy: int,
    row_ptrs,
    col_indices_global,
    data,
    diag_data=None,
    allocated_halo_depth: int = 1,
    num_import_rings: int = 1,
    partition_vector=None,
):
    m = _get(mtx_h, _Matrix)
    if block_dimx != block_dimy:
        raise AMGXError(
            RC_NOT_SUPPORTED_BLOCKSIZE, "rectangular blocks unsupported"
        )
    return _upload_global(
        m, n_global, n, nnz, block_dimx, row_ptrs, col_indices_global,
        data, diag_data, partition_vector, np.int32,
    )


def matrix_replace_coefficients(mtx_h, n, nnz, data, diag_data=None):
    m = _get(mtx_h, _Matrix)
    if m.A is None:
        raise AMGXError(RC_BAD_PARAMETERS, "matrix not uploaded")
    if diag_data is not None:
        raise AMGXError(RC_NOT_IMPLEMENTED, "external diag replace TBD")
    b = m.A.block_size
    m.A = m.A.replace_values(_mat_values(data, m.mode, nnz * b * b))
    return RC_OK


def matrix_get_size(mtx_h):
    m = _get(mtx_h, _Matrix)
    if m.A is None:
        return 0, 0, 0
    return m.A.n_rows, m.A.block_size, m.A.block_size


def matrix_check_symmetry(mtx_h):
    from amgx_tpu_torch.ops.analysis import check_symmetry

    m = _get(mtx_h, _Matrix)
    if m.A is None:
        raise AMGXError(RC_BAD_PARAMETERS, "matrix not uploaded")
    s, n = check_symmetry(m.A)
    return int(s), int(n)


def matrix_destroy(mtx_h):
    _objects.pop(mtx_h, None)
    return RC_OK


# ---------------------------------------------------------------------------
# vector (amgx_c.h:336-372)


def vector_create(res_h: int, mode: str = "dDDI") -> int:
    return _with_mode(res_h, mode, _Vector)


def vector_upload(vec_h: int, n: int, block_dim: int, data):
    from amgx_tpu_torch.core import errors as _errors

    v = _get(vec_h, _Vector)
    arr = np.array(_as_array(data, v.mode.vec_np, n * block_dim), copy=True)
    if _errors.validation_enabled():
        # NaN/Inf right-hand sides fail here with a typed error, not as
        # a FAILED status after a whole solve
        _errors.validate_vector(arr, n * block_dim)
    v.data = arr
    v.block_dim = block_dim
    return RC_OK


def vector_set_zero(vec_h: int, n: int, block_dim: int):
    v = _get(vec_h, _Vector)
    v.data = np.zeros(n * block_dim, dtype=v.mode.vec_np)
    v.block_dim = block_dim
    return RC_OK


def vector_set_random(vec_h: int, n: int):
    v = _get(vec_h, _Vector)
    v.data = np.random.default_rng(0).standard_normal(n).astype(
        v.mode.vec_np
    )
    return RC_OK


def vector_download(vec_h: int) -> np.ndarray:
    v = _get(vec_h, _Vector)
    owner = getattr(v, "_batch_owner", None)
    if owner is not None:
        # the solution vector of an in-flight batched solve: read it
        # (and its groupmates) now
        _drain_batch(owner)
    if v.data is None:
        raise AMGXError(RC_BAD_PARAMETERS, "vector empty")
    # always the mode's dtype: the C caller sizes its buffer by the mode
    return np.ascontiguousarray(np.asarray(v.data), dtype=v.mode.vec_np)


def vector_bind(vec_h: int, mtx_h: int):
    v = _get(vec_h, _Vector)
    v.bound_matrix = _get(mtx_h, _Matrix)
    return RC_OK


def vector_get_size(vec_h: int):
    v = _get(vec_h, _Vector)
    if v.data is None:
        return 0, 1
    return v.data.shape[0] // v.block_dim, v.block_dim


def vector_destroy(vec_h):
    _objects.pop(vec_h, None)
    return RC_OK


# ---------------------------------------------------------------------------
# solver (amgx_c.h:375-421)


def solver_create(res_h: int, mode: str, cfg_h: int) -> int:
    return _with_mode(
        res_h, mode, lambda res, m: _SolverHandle(res, m, _get(cfg_h, _Config)))


def _create_and_setup(handle, mtx_h, factory):
    """Shared setup body of solver_setup / eig_solver_setup: guard the
    matrix, allocate on the mode's device through ``factory`` (KeyError
    -> RC_BAD_CONFIGURATION), convert to the mode's matrix dtype."""
    m = _get(mtx_h, _Matrix)
    if m.A is None:
        raise AMGXError(RC_BAD_PARAMETERS, "matrix not uploaded")
    try:
        solver = factory(handle.cfg.cfg, handle.mode.device)
    except KeyError as e:
        raise AMGXError(RC_BAD_CONFIGURATION, str(e)) from None
    return solver, m.A.astype(handle.mode.mat_dtype), m


def solver_setup(slv_h: int, mtx_h: int):
    from amgx_tpu_torch.solvers.registry import create_solver

    s = _get(slv_h, _SolverHandle)
    m = _get(mtx_h, _Matrix)
    if m.global_sp is not None and s.res.n_devices > 1:
        _not_ported(f"setup over {s.res.n_devices} devices", _A9)
    s.solver, A, m = _create_and_setup(
        s, mtx_h, lambda cfg, dev: create_solver(cfg, "default", device=dev)
    )
    s.solver.setup(A)
    s.matrix = m
    return RC_OK


def _solve_impl(s, rhs_h, sol_h, zero_guess):
    from amgx_tpu_torch.core import faults

    rhs = _get(rhs_h, _Vector)
    sol = _get(sol_h, _Vector)
    if s.solver is None:
        raise AMGXError(RC_BAD_PARAMETERS, "solver not set up")
    if rhs.data is None:
        raise AMGXError(RC_BAD_PARAMETERS, "rhs not uploaded")
    if faults.should_fire("capi_internal"):
        # an injected internal error: it must come back as a clean RC
        # through the catch-all (_rc_guard), never a traceback across
        # the native shim
        raise RuntimeError("injected internal error (fault site "
                           "capi_internal)")
    x0 = None if (zero_guess or sol.data is None) else sol.data
    res = s.solver.solve(
        rhs.data.astype(s.mode.vec_np),
        x0=x0,
        zero_initial_guess=zero_guess,
    )
    s.result = res
    sol.data = host_array(res.x)
    return RC_OK


def solver_solve(slv_h: int, rhs_h: int, sol_h: int):
    return _solve_impl(_get(slv_h, _SolverHandle), rhs_h, sol_h, False)


def solver_solve_with_0_initial_guess(slv_h: int, rhs_h: int, sol_h: int):
    return _solve_impl(_get(slv_h, _SolverHandle), rhs_h, sol_h, True)


def _result(slv_h):
    s = _get(slv_h, _SolverHandle)
    if s.result is None:
        raise AMGXError(RC_BAD_PARAMETERS, "no solve yet")
    return s.result


def solver_get_status(slv_h: int) -> int:
    return int(_result(slv_h).status)


def solver_get_iterations_number(slv_h: int) -> int:
    return int(_result(slv_h).iters)


def solver_get_iteration_residual(slv_h: int, it: int, idx: int = 0):
    hist = np.asarray(_result(slv_h).history)
    if not (0 <= it < hist.shape[0]):
        raise AMGXError(RC_BAD_PARAMETERS, f"iteration {it} out of range")
    return float(hist[it, idx])


def solver_resetup(slv_h: int, mtx_h: int):
    """Refresh the solver for a matrix whose values changed and whose
    structure did not (reference AMGX_solver_resetup,
    amgx_c.h:604-607): ``Solver.resetup``, values-only where the solver
    has such a path, a full setup elsewhere."""
    s = _get(slv_h, _SolverHandle)
    m = _get(mtx_h, _Matrix)
    if s.solver is None:
        return solver_setup(slv_h, mtx_h)
    if m.A is None:
        raise AMGXError(RC_BAD_PARAMETERS, "matrix not uploaded")
    s.solver.resetup(m.A.astype(s.mode.mat_dtype))
    s.matrix = m
    return RC_OK


def solver_save(slv_h: int, path: str):
    """Persist a set-up solver's setup to ``path`` in the JAX package's
    payload format (``Solver.save_setup``)."""
    s = _get(slv_h, _SolverHandle)
    if s.solver is None:
        raise AMGXError(RC_BAD_PARAMETERS, "solver not set up")
    s.solver.save_setup(path)
    return RC_OK


def solver_load(slv_h: int, path: str):
    """Restore a solver saved by :func:`solver_save` (by either package)
    into this handle without running setup, on the mode's device.  The
    handle's config must match the payload's and its mode's matrix
    dtype the restored operator's (else RC_BAD_MODE)."""
    from amgx_tpu_torch.solvers.base import Solver

    s = _get(slv_h, _SolverHandle)
    s.solver = Solver.load_setup(
        path, cfg=s.cfg.cfg,
        expect_dtype=str(s.mode.mat_dtype).replace("torch.", ""),
        device=s.mode.device,
    )
    s.result = None
    return RC_OK


def solver_destroy(slv_h):
    s = _objects.pop(slv_h, None)
    if getattr(s, "batch_fleet", None) is not None:
        try:
            s.batch_fleet.close()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
    return RC_OK


# ---------------------------------------------------------------------------
# batched solves (the serve layer) and the telemetry calls


def _build_fleet_front(spec: str):
    """``AMGX_TPU_FLEET`` -> a connected
    :class:`~amgx_tpu_torch.fleet.frontend.FleetFrontend`.  The spec is a
    worker-registry directory (every live announced worker attaches) or
    a comma-separated ``host:port`` list.  A malformed spec, or a
    registry with no live worker, raises RC_BAD_CONFIGURATION; a worker
    that cannot be reached, RC_IO_ERROR."""
    import os

    from amgx_tpu_torch.fleet.frontend import FleetFrontend
    from amgx_tpu_torch.fleet.registry import WorkerRecord, WorkerRegistry

    spec = spec.strip()
    if os.path.isdir(spec):
        records = WorkerRegistry(spec).workers()
        if not records:
            raise AMGXError(RC_BAD_CONFIGURATION,
                            f"AMGX_TPU_FLEET registry {spec!r} has no live "
                            "workers")
    else:
        records = []
        for i, item in enumerate(spec.split(",")):
            host, sep, port = item.strip().rpartition(":")
            try:
                port_i = int(port)
            except ValueError:
                port_i = -1
            if not sep or not host or not 0 < port_i < 65536:
                raise AMGXError(
                    RC_BAD_CONFIGURATION,
                    "AMGX_TPU_FLEET must be a registry directory or a "
                    f"host:port list, got {item.strip()!r}")
            records.append(WorkerRecord(f"addr{i}", host, port_i, pid=0,
                                        slot=i))
    # a registry's slots need not be 0..n-1 (a worker lost, a fleet
    # grown): the router covers the highest
    front = FleetFrontend(capacity=max([len(records)]
                                       + [r.slot + 1 for r in records]))
    try:
        for rec in records:
            front.attach(rec)
    except OSError as e:
        front.close()
        raise AMGXError(RC_IO_ERROR,
                        f"AMGX_TPU_FLEET: cannot reach fleet worker: {e}"
                        ) from None
    return front


def _ensure_batch_front(s):
    """The solver handle's submit front, built at its first batched
    solve or session (the JAX package's ``_ensure_batch_front``).

    ``AMGX_TPU_FLEET=<registry directory | host:port[,host:port...]>``
    sends the batched solves to a multi-process fleet
    (:mod:`amgx_tpu_torch.fleet`) and builds no local service; its
    workers solve with their own configuration.  A set but malformed or
    unreachable fleet fails every call (:func:`_build_fleet_front`): it
    never solves locally in silence.  Otherwise the front is built from
    the handle's config on the mode's device: the gateway where
    admission control is on, else the service.

    ``AMGX_TPU_CAPI_ADMISSION=<budget>`` fronts the service with a
    :class:`~amgx_tpu_torch.serve.gateway.SolveGateway` of that
    concurrency budget: a submit past it sheds typed (a per-system
    FAILED status) instead of queueing without bound.  A malformed or
    non-positive value, and a malformed ``AMGX_TPU_PLACEMENT``, fail
    every call with RC_BAD_CONFIGURATION: they are read before any
    handle state is set."""
    if s.batch_fleet is None:
        import os

        fleet_env = os.environ.get("AMGX_TPU_FLEET", "")
        if fleet_env:
            s.batch_fleet = _build_fleet_front(fleet_env)
    if s.batch_fleet is not None:
        return s.batch_fleet
    if s.batch_service is None:
        import os

        from amgx_tpu_torch.serve import BatchedSolveService

        budget_env = os.environ.get("AMGX_TPU_CAPI_ADMISSION", "")
        budget = None
        if budget_env:
            try:
                budget = int(budget_env)
            except ValueError:
                raise AMGXError(
                    RC_BAD_CONFIGURATION,
                    "AMGX_TPU_CAPI_ADMISSION must be an integer "
                    f"concurrency budget, got {budget_env!r}") from None
            if budget <= 0:
                raise AMGXError(
                    RC_BAD_CONFIGURATION,
                    "AMGX_TPU_CAPI_ADMISSION must be a positive "
                    f"concurrency budget, got {budget_env!r}")
        placement_env = os.environ.get("AMGX_TPU_PLACEMENT", "")
        if placement_env:
            from amgx_tpu_torch.serve.placement import parse_placement

            try:
                parse_placement(placement_env)
            except ValueError as e:
                raise AMGXError(RC_BAD_CONFIGURATION, str(e)) from None
        s.batch_service = BatchedSolveService(config=s.cfg.cfg,
                                              device=s.mode.device)
        if budget:
            from amgx_tpu_torch.serve import SolveGateway

            s.batch_gateway = SolveGateway(s.batch_service,
                                           max_inflight=budget)
    return s.batch_gateway or s.batch_service


def solver_solve_batch(slv_h: int, mtx_handles, rhs_handles, sol_handles):
    """Solve N independent systems through the serve layer
    (``amgx_tpu_torch.serve``): systems that share a sparsity pattern
    run as batched groups with one setup per pattern.  The first call
    builds the handle's service from its config; later calls reuse its
    caches.  An uploaded solution vector warm-starts its system.

    The results are read at the first accessor
    (``solver_get_batch_status`` / ``_iterations_number`` /
    ``_metrics``, or ``vector_download`` of one of the solution
    vectors), which writes every solution into its vector.  A system
    refused or failed with a typed error (non-finite values, a failed
    setup) fails alone: its status is FAILED and its vector keeps what
    it held; so does a system the admission gateway sheds
    (``AMGX_TPU_CAPI_ADMISSION``).  The call returns RC_OK once the
    batch ran."""
    from amgx_tpu_torch.core.errors import AMGXTPUError

    s = _get(slv_h, _SolverHandle)
    mtx_handles = list(mtx_handles)
    rhs_handles = list(rhs_handles)
    sol_handles = list(sol_handles)
    if not (len(mtx_handles) == len(rhs_handles) == len(sol_handles)):
        raise AMGXError(RC_BAD_PARAMETERS,
                        "solver_solve_batch: handle lists must have equal "
                        "length")
    _drain_batch(s)
    if not mtx_handles:
        s.batch_results = []
        return RC_OK
    front = _ensure_batch_front(s)
    systems = []
    for mh, rh, sh in zip(mtx_handles, rhs_handles, sol_handles):
        m = _get(mh, _Matrix)
        r = _get(rh, _Vector)
        if m.A is None:
            raise AMGXError(RC_BAD_PARAMETERS, "matrix not uploaded")
        if r.data is None:
            raise AMGXError(RC_BAD_PARAMETERS, "rhs not uploaded")
        sol = _get(sh, _Vector)
        x0 = None if sol.data is None else sol.data.astype(s.mode.vec_np)
        systems.append((m.A.astype(s.mode.mat_dtype),
                        r.data.astype(s.mode.vec_np), x0))
    pending = []
    for sys_, sh in zip(systems, sol_handles):
        n = sys_[0].n_rows * sys_[0].block_size
        try:
            t = front.submit(*sys_)
        except AMGXTPUError:
            # a typed refusal (validation, an admission shed) fails only
            # this system
            t = None
        else:
            _get(sh, _Vector)._batch_owner = s
        pending.append((t, n, sh))
    front.flush()
    s.batch_pending = pending
    s.batch_results = None
    return RC_OK


def _batch_failed_result(n, s):
    """A system's failed result: status FAILED, NaN norms."""
    from amgx_tpu_torch.solvers.base import FAILED, SolveResult

    rdt = np.dtype(s.mode.vec_np)
    if rdt.kind == "c":
        rdt = np.dtype(np.float64 if rdt.itemsize == 16 else np.float32)
    return SolveResult(x=torch.zeros(n, dtype=s.mode.vec_dtype), iters=0,
                       status=FAILED, final_norm=np.full((1,), np.nan, rdt),
                       initial_norm=np.full((1,), np.nan, rdt),
                       history=np.full((1, 1), np.nan, rdt))


def _drain_batch(s):
    """Read an in-flight batched solve's results: each solution into its
    vector, each system's result kept.  A no-op when none is pending."""
    from amgx_tpu_torch.core.errors import AMGXTPUError

    pending = getattr(s, "batch_pending", None)
    if pending is None:
        return
    s.batch_pending = None
    results = []
    for t, n, sh in pending:
        try:
            v = _get(sh, _Vector)
        except AMGXError:
            v = None  # the vector was destroyed while the batch ran
        if v is not None and getattr(v, "_batch_owner", None) is s:
            v._batch_owner = None
        if t is None:
            results.append(_batch_failed_result(n, s))
            continue
        try:
            res = t.result()
        except AMGXTPUError:
            res = _batch_failed_result(n, s)
        else:
            if v is not None:
                v.data = np.asarray(host_array(res.x), dtype=v.mode.vec_np)
        results.append(res)
    s.batch_results = results
    if results:
        s.result = results[-1]


def _batch_result(slv_h, idx):
    s = _get(slv_h, _SolverHandle)
    _drain_batch(s)
    results = getattr(s, "batch_results", None)
    if results is None:
        raise AMGXError(RC_BAD_PARAMETERS, "no batch solve yet")
    if not 0 <= idx < len(results):
        raise AMGXError(RC_BAD_PARAMETERS, f"batch index {idx} invalid")
    return results[idx]


def solver_get_batch_status(slv_h: int, idx: int) -> int:
    return int(_batch_result(slv_h, idx).status)


def solver_get_batch_iterations_number(slv_h: int, idx: int) -> int:
    return int(_batch_result(slv_h, idx).iters)


def solver_get_batch_metrics(slv_h: int) -> dict:
    """The handle's serve counters (``ServeMetrics.snapshot``) after any
    in-flight batch is read; {} before the first batched solve."""
    s = _get(slv_h, _SolverHandle)
    if getattr(s, "batch_service", None) is None:
        return {}
    _drain_batch(s)
    return s.batch_service.metrics.snapshot()


def solver_get_telemetry(slv_h: int) -> dict:
    """Telemetry of one solver handle (AMGX_solver_get_telemetry): the
    direct solve's timings, the handle's serve metrics and flight
    recorder (records and incident log) once batched solves ran, and
    the process registry's snapshot (every component: serve, sessions,
    store, solvers, tracing).  Collection degrades: a telemetry failure
    is counted, never raised into the C ABI."""
    from amgx_tpu_torch import telemetry

    s = _get(slv_h, _SolverHandle)
    out: dict = {"enabled": telemetry.telemetry_enabled()}
    if getattr(s, "batch_service", None) is not None:
        _drain_batch(s)
        out["serve"] = s.batch_service.metrics.snapshot()
        out["flight"] = s.batch_service.recorder.to_dict()
    if s.solver is not None:
        out["solver"] = {
            "setup_s": getattr(s.solver, "setup_time", 0.0),
            "restore_s": getattr(s.solver, "restore_time", 0.0),
            "compile_s": getattr(s.solver, "compile_time", 0.0),
            "solve_s": getattr(s.solver, "solve_time", 0.0),
        }
    out["registry"] = telemetry.get_registry().snapshot()
    return out


def solver_telemetry_json(slv_h: int) -> str:
    """:func:`solver_get_telemetry` as a JSON string (the form a C host
    reads as a ``char*``)."""
    import json

    return json.dumps(solver_get_telemetry(slv_h), default=str)


# ---------------------------------------------------------------------------
# streaming solve sessions (amgx_tpu_torch.sessions): register a
# sparsity pattern once, then stream replace_coefficients-style steps
# with warm starts through the handle's batch service.  No reference
# analogue: AmgX hosts loop replace_coefficients + resetup + solve by
# hand; this is that loop as a serve-level object.


class _SessionHandle:
    def __init__(self, owner: _SolverHandle, session):
        self.owner = owner
        self.session = session
        self.pending = None  # (StepTicket, solution handle) not yet read
        self.last = None  # the last resolved SolveResult


def _session_settle(h: "_SessionHandle"):
    """Read the pending step's result and deliver its solution to the
    step's solution vector.  A typed failure of the step becomes a
    FAILED result, as in the batched solve: the stream goes on."""
    from amgx_tpu_torch.core.errors import AMGXTPUError

    if h.pending is None:
        return
    (ticket, sol_h), h.pending = h.pending, None
    try:
        res = ticket.result()
    except AMGXTPUError:
        h.last = _batch_failed_result(h.session.n, h.owner)
        return
    h.last = res
    try:
        v = _get(sol_h, _Vector)
    except AMGXError:
        return  # the vector was destroyed in the meantime
    v.data = np.asarray(host_array(res.x), dtype=v.mode.vec_np)


def solver_session_create(slv_h: int, mtx_h: int) -> int:
    """Open a streaming session on the uploaded matrix's sparsity
    pattern (AMGX_solver_session_create); the matrix gives structure
    only, each step's coefficients come with
    :func:`solver_session_step`.  Steps run through the handle's batch
    service (the one ``solver_solve_batch`` uses), through its admission
    gateway where ``AMGX_TPU_CAPI_ADMISSION`` is set: each step is then
    admitted as one ticket."""
    s = _get(slv_h, _SolverHandle)
    m = _get(mtx_h, _Matrix)
    if m.A is None:
        raise AMGXError(RC_BAD_PARAMETERS, "matrix not uploaded")
    front = _ensure_batch_front(s)
    if s.batch_fleet is not None:
        # sessions ride the fleet's wire verbs, not the handle's
        # embedded session manager, which needs a local serve stack
        raise AMGXError(
            RC_NOT_SUPPORTED_TARGET,
            "solver_session_create is not available with AMGX_TPU_FLEET "
            "(sessions ride the fleet wire protocol, not the embedded "
            "session manager)")
    if s.session_manager is None:
        from amgx_tpu_torch.sessions import SessionManager

        s.session_manager = SessionManager(front)
    sess = s.session_manager.open(m.A, dtype=host_dtype(s.mode.mat_dtype))
    return _new(_SessionHandle(s, sess))


def solver_session_step(sess_h: int, mtx_h: int, rhs_h: int, sol_h: int):
    """Stream one step (AMGX_solver_session_step): the current
    coefficients of ``mtx_h`` (refreshed by
    ``matrix_replace_coefficients``) and the rhs, submitted with the
    session's masked warm start.  The previous step's solution reaches
    its solution vector here, or at :func:`solver_session_sync`."""
    h = _get(sess_h, _SessionHandle)
    m = _get(mtx_h, _Matrix)
    r = _get(rhs_h, _Vector)
    _get(sol_h, _Vector)  # checked before anything is submitted
    if m.A is None:
        raise AMGXError(RC_BAD_PARAMETERS, "matrix not uploaded")
    if r.data is None:
        raise AMGXError(RC_BAD_PARAMETERS, "rhs not uploaded")
    vals = host_array(m.A.values).reshape(-1)
    sess = h.session
    # settle the previous step first (its solution delivered, a typed
    # failure a FAILED result), then stage and submit this one
    _session_settle(h)
    sess.prestage(vals, np.asarray(r.data, dtype=h.owner.mode.vec_np))
    ticket = sess.commit()
    h.owner.batch_service.flush()
    h.pending = (ticket, sol_h)
    return RC_OK


def solver_session_sync(sess_h: int):
    """Read the pending step and write its solution vector
    (AMGX_solver_session_sync)."""
    _session_settle(_get(sess_h, _SessionHandle))
    return RC_OK


def solver_session_get_status(sess_h: int) -> int:
    """Status of the last resolved step (the pending one read first)."""
    h = _get(sess_h, _SessionHandle)
    _session_settle(h)
    if h.last is None:
        raise AMGXError(RC_BAD_PARAMETERS, "no session step yet")
    return int(h.last.status)


def solver_session_get_iterations_number(sess_h: int) -> int:
    h = _get(sess_h, _SessionHandle)
    _session_settle(h)
    if h.last is None:
        raise AMGXError(RC_BAD_PARAMETERS, "no session step yet")
    return int(h.last.iters)


def solver_session_save(sess_h: int, path: str):
    """Save the session's streaming state (step counter, warm start,
    registered pattern) into the artifact store at ``path``
    (AMGX_solver_session_save), the step in flight settled first; with
    the serve layer's hierarchy export it makes a drain and warm-boot
    restart.  RC_IO_ERROR when the save fails."""
    h = _get(sess_h, _SessionHandle)
    _session_settle(h)
    if not h.session.save(store=path):
        raise AMGXError(RC_IO_ERROR, "session save failed")
    return RC_OK


def solver_session_destroy(sess_h: int):
    h = _objects.pop(sess_h, None)
    if isinstance(h, _SessionHandle):
        try:
            _session_settle(h)
            h.session.close()
        except Exception:  # noqa: BLE001 — destroy is best-effort
            pass
    return RC_OK


# ---------------------------------------------------------------------------
# eigensolver API (reference amgx_eig_c.h / src/amgx_eig_c.cu)


def eig_solver_create(res_h: int, mode: str, cfg_h: int) -> int:
    return _with_mode(
        res_h, mode, lambda res, m: _EigSolverHandle(res, m, _get(cfg_h, _Config)))


def eig_solver_setup(slv_h: int, mtx_h: int):
    from amgx_tpu_torch.eigensolvers import create_eigensolver

    s = _get(slv_h, _EigSolverHandle)
    s.solver, A, _ = _create_and_setup(
        s, mtx_h,
        lambda cfg, dev: create_eigensolver(cfg, "default", device=dev),
    )
    if s.personalization is not None:
        s.solver.personalization = s.personalization
    s.solver.setup(A)
    return RC_OK


def eig_solver_pagerank_setup(slv_h: int, vec_h: int):
    """Reference AMG_EigenSolver::pagerank_setup: the vector supplies
    the teleport distribution.  Called before eig_solver_setup."""
    s = _get(slv_h, _EigSolverHandle)
    if vec_h:
        v = _get(vec_h, _Vector)
        if v.data is None:
            raise AMGXError(RC_BAD_PARAMETERS, "vector empty")
        s.personalization = np.asarray(v.data, dtype=np.float64)
    return RC_OK


def eig_solver_solve(slv_h: int, x0_h: int = 0):
    s = _get(slv_h, _EigSolverHandle)
    if s.solver is None:
        raise AMGXError(RC_BAD_PARAMETERS, "eigensolver not set up")
    x0 = _get(x0_h, _Vector).data if x0_h else None
    s.result = s.solver.solve(x0=x0)
    return RC_OK


def eig_solver_get_eigenvalues(slv_h: int) -> np.ndarray:
    s = _get(slv_h, _EigSolverHandle)
    if s.result is None:
        raise AMGXError(RC_BAD_PARAMETERS, "no eig solve yet")
    lam = np.asarray(s.result.eigenvalues)
    # the mode's vector dtype (the C shim sizes buffers by it): real
    # modes get the real part (Arnoldi may return complex pairs)
    vdt = s.mode.vec_np
    if np.issubdtype(vdt, np.complexfloating):
        return lam.astype(vdt)
    return np.ascontiguousarray(np.real(lam), dtype=vdt)


def eig_solver_get_eigenvector(slv_h: int, idx: int, vec_h: int):
    s = _get(slv_h, _EigSolverHandle)
    if s.result is None or s.result.eigenvectors is None:
        raise AMGXError(RC_BAD_PARAMETERS, "no eigenvectors available")
    ev = s.result.eigenvectors
    if not (0 <= idx < ev.shape[1]):
        raise AMGXError(RC_BAD_PARAMETERS, f"eigenvector {idx} not found")
    v = _get(vec_h, _Vector)
    v.data = np.ascontiguousarray(np.real(host_array(ev[:, idx])),
                                  dtype=v.mode.vec_np)
    return RC_OK


def eig_solver_destroy(slv_h: int):
    _objects.pop(slv_h, None)
    return RC_OK


# ---------------------------------------------------------------------------
# IO (amgx_c.h:424-529)


def read_system(mtx_h: int, rhs_h: int, sol_h: int, filename: str):
    from amgx_tpu_torch.io.matrix_market import MatrixIOError
    from amgx_tpu_torch.io.matrix_market import read_system as _read

    m = _get(mtx_h, _Matrix) if mtx_h else None
    try:
        Ad, rhs, sol = _read(filename)
    except (FileNotFoundError, MatrixIOError) as e:
        raise AMGXError(RC_IO_ERROR, str(e)) from None
    # reference readers.cu:656-664 complex_conversion: a complex file
    # read into a real mode becomes its 2n x 2n real formulation
    conv = int(m.cfg.get("complex_conversion")) if (
        m is not None and m.cfg is not None) else 0
    if (conv != 0 and np.iscomplexobj(Ad["vals"])
            and not m.mode.is_complex):
        from amgx_tpu_torch.io.matrix_market import complex_to_real_system

        Ad, rhs, sol = complex_to_real_system(Ad, rhs, sol, conv)
    if m is not None:
        bx, by = Ad["block_dims"]
        b = bx if bx == by else 1
        count = np.asarray(Ad["vals"]).size
        m.A = _built(SparseMatrix.from_coo(
            Ad["rows"],
            Ad["cols"],
            _mat_values(np.asarray(Ad["vals"]), m.mode, count).reshape(
                np.asarray(Ad["vals"]).shape),
            n_rows=Ad["n_rows"],
            n_cols=Ad["n_cols"],
            block_size=b,
            device=m.mode.device,
        ), m.mode)
    n = Ad["n_rows"] * Ad["block_dims"][0]
    if rhs_h:
        v = _get(rhs_h, _Vector)
        if rhs is not None:
            v.data = np.asarray(rhs, v.mode.vec_np)
        elif (m is not None and m.A is not None and m.cfg is not None
                and bool(m.cfg.get("rhs_from_a"))):
            # reference amgx_c.cu:5010 GEN_RHS: b = A @ 1 when the file
            # carries no rhs and rhs_from_a = 1
            v.data = np.asarray(
                m.A.to_scipy() @ np.ones(n, v.mode.vec_np), v.mode.vec_np,
            )
        else:
            v.data = np.ones(n, v.mode.vec_np)
    if sol_h:
        v = _get(sol_h, _Vector)
        if sol is not None:
            v.data = np.asarray(sol, v.mode.vec_np)
    return RC_OK


def write_system(mtx_h: int, rhs_h: int, sol_h: int, filename: str):
    """MatrixMarket + %%AMGX text, or the reference's %%NVAMGBinary
    format when the filename ends in '.bin' or ``matrix_writer`` is
    "binary" (matrix_io.cu:286-334); read_system reads either."""
    from amgx_tpu_torch.io.matrix_market import (
        write_system as _write,
        write_system_binary as _write_bin,
    )

    m = _get(mtx_h, _Matrix)
    if m.A is None:
        raise AMGXError(RC_BAD_PARAMETERS, "matrix not uploaded")
    rhs = _objects.get(rhs_h).data if rhs_h in _objects else None
    sol = _objects.get(sol_h).data if sol_h in _objects else None
    writer = str(m.cfg.get("matrix_writer")).lower() if m.cfg else ""
    if filename.endswith(".bin") or writer == "binary":
        _write_bin(filename, m.A, rhs=rhs, sol=sol)
    else:
        _write(filename, m.A, rhs=rhs, sol=sol)
    return RC_OK


def write_parameters_description(filename: str):
    from amgx_tpu_torch.config.params import write_parameters_description \
        as _w

    _w(filename)
    return RC_OK


def generate_distributed_poisson_7pt(
    mtx_h: int, rhs_h: int, sol_h: int, nx, ny, nz,
    px: int = 1, py: int = 1, pz: int = 1, *args
):
    """Reference AMGX_generate_distributed_poisson_7pt
    (amgx_c.h:510-522) on a 1 x 1 x 1 process grid: the 7-point Poisson
    system of an nx x ny x nz grid, b = 1, x = 0.  A larger process grid
    partitions the system (queue A.9)."""
    from amgx_tpu_torch.io.poisson import poisson_scipy

    m = _get(mtx_h, _Matrix)
    if px * py * pz != 1:
        _not_ported(f"a {px} x {py} x {pz} process grid", _A9)
    sp = poisson_scipy((nx, ny, nz))
    if m.mode.mat_dtype != torch.bfloat16:
        sp = sp.astype(host_dtype(m.mode.mat_dtype))
    m.A = _built(SparseMatrix.from_scipy(sp, device=m.mode.device), m.mode)
    n = sp.shape[0]
    if rhs_h:
        v = _get(rhs_h, _Vector)
        v.data = np.ones(n, v.mode.vec_np)
    if sol_h:
        v = _get(sol_h, _Vector)
        v.data = np.zeros(n, v.mode.vec_np)
    return RC_OK


# ---------------------------------------------------------------------------
# distribution handles, partitioned uploads, one-ring maps and
# distributed IO: the multi-device surface (queue A.9)


def distribution_create(cfg_h: int) -> int:
    _not_ported("distribution_create", _A9)


def distribution_set_partition_data(dist_h: int, info: int, data):
    _not_ported("distribution_set_partition_data", _A9)


def distribution_set_32bit_colindices(dist_h: int, use32: int):
    _not_ported("distribution_set_32bit_colindices", _A9)


def distribution_uses_32bit(dist_h: int) -> bool:
    _not_ported("distribution_uses_32bit", _A9)


def distribution_set_partition_blob(dist_h: int, info: int, blob):
    _not_ported("distribution_set_partition_blob", _A9)


def distribution_destroy(dist_h: int):
    _not_ported("distribution_destroy", _A9)


def matrix_upload_distributed(mtx_h, n_global, n, nnz, block_dimx,
                              block_dimy, row_ptrs, col_indices_global,
                              data, diag_data, dist_h):
    _not_ported("matrix_upload_distributed", _A9)


def matrix_comm_from_maps_one_ring(mtx_h, allocated_halo_depth,
                                   num_neighbors, neighbors, send_sizes,
                                   send_maps, recv_sizes, recv_maps):
    _not_ported("matrix_comm_from_maps_one_ring", _A9)


def read_system_maps_one_ring(rsc_h, mode, filename, *args, **kw):
    _not_ported("read_system_maps_one_ring", _A9)


def read_system_maps_one_ring_flat(rsc_h, mode, filename, *args, **kw):
    _not_ported("read_system_maps_one_ring", _A9)


def read_system_distributed(mtx_h, rhs_h, sol_h, filename, *args, **kw):
    _not_ported("read_system_distributed", _A9)


def write_system_distributed(mtx_h, rhs_h, sol_h, filename, *args):
    _not_ported("write_system_distributed", _A9)


# ---------------------------------------------------------------------------
# catch-all installation: every public entry point gets the
# exception -> RC conversion, in one sweep, so that no Python traceback
# crosses the native shim (amgx_tpu_torch/native/amgx_tpu_torch_c.c);
# the tests assert that none is left unguarded


# the entry points that get a profiler range each (``AMGX_<name>``,
# reference amgx_c.cu:2747 nvtxRange), as in the JAX package
_TRACED = frozenset((
    "matrix_upload_all", "matrix_replace_coefficients", "vector_upload",
    "vector_download", "solver_setup", "solver_solve",
    "solver_solve_with_0_initial_guess", "solver_solve_batch",
    "solver_resetup", "solver_save", "solver_load",
    "solver_session_create", "solver_session_step",
    "solver_session_sync", "solver_session_save", "eig_solver_setup",
    "eig_solver_solve", "read_system", "write_system",
))


def _traced(fn):
    """A ``trace_range`` around one entry point."""
    from amgx_tpu_torch.core.profiling import trace_range

    name = "AMGX_" + fn.__name__

    @functools.wraps(fn)
    def wrap(*a, **k):
        with trace_range(name):
            return fn(*a, **k)

    return wrap


def _install_rc_guards():
    import types

    for _name, _obj in list(globals().items()):
        if (
            isinstance(_obj, types.FunctionType)
            and not _name.startswith("_")
            and _obj.__module__ == __name__
            and not getattr(_obj, "_rc_guarded", False)
        ):
            if _name in _TRACED:
                _obj = _traced(_obj)
            globals()[_name] = _rc_guard(_obj)


_install_rc_guards()
