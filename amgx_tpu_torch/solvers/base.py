"""Solver framework (reference Solver<TConfig>, solver.h:21-278).

Counterpart of the JAX package's ``solvers/base.py``, in eager PyTorch:

  * ``setup(A)`` builds preconditioner state on the host and ships it
    to the solver's device; ``resetup(A)`` refreshes it for new values
    of the same structure (``A.replace_values``), by a values-only path
    where the solver has one (Krylov solvers, CHEBYSHEV, INEXACT, AMG
    with ``structure_reuse_levels``) and by a full setup elsewhere.
  * ``solve(b, x0)`` runs the monitored loop (reference
    solver.cu:586-860) as a Python loop in place of ``lax.while_loop``.
    Each iteration reads the residual norm to the host once — the one
    host sync per iteration — and the convergence, divergence and
    stagnation checks run on the host on that norm, in the residual's
    real dtype as the JAX package's do.
  * Solvers used as preconditioners / smoothers expose functions over
    their ``params`` tuple, as in the JAX package:
      ``make_apply()``  -> fn(params, r) -> z        (zero initial guess)
      ``make_smooth()`` -> fn(params, b, x, sweeps) -> x

``scaling`` (``solvers/scalers.py``) scales the system once at setup,
re-uploading the scaled matrix so that it gets its own formats, and the
vectors at the ``solve`` boundary (b -> Dr b, x0 -> x0 / Dc, x -> Dc
x).  ``matrix_reordering=RCM`` permutes the system once at setup and
the vectors at the same boundary (``ops/reorder.py``); AUTO, like the
JAX package on any non-TPU backend, never reorders.
``save_setup`` / ``load_setup`` persist a set-up solver in the JAX
package's payload format (``amgx_tpu_torch/store``).

Guardrails, as in the JAX package: the fault site ``smoother_nan``
(``core/faults.py``) sits in both monitored loops and at the end of
``make_smooth``; ``solve_retries`` re-solves a FAILED or DIVERGED solve
from a zero guess with a fresh build (``_retry_if_failed``).  The solve
function is built once per setup (``make_solve`` under
``faults.built``): its build time is ``last_compile_s`` /
``compile_time``, what the JAX package's compile time is.  Under
``obtain_timings`` a solve also feeds the telemetry registry's solver
aggregate and the default flight recorder (``_telemetry_observe``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from amgx_tpu_torch.core import faults
from amgx_tpu_torch.core.device import resolve_device
from amgx_tpu_torch.core.printing import emit
from amgx_tpu_torch.core.types import NormType, host_array, host_dtype
from amgx_tpu_torch.ops.norms import get_norm as _get_norm
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.solvers.convergence import make_convergence_check

# AMGX_SOLVE_* status codes (reference amgx_c.h:75-80)
SUCCESS = 0
FAILED = 1  # NaN/Inf residual
DIVERGED = 2  # rel_div_tolerance exceeded / stagnation
NOT_CONVERGED = 3


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    iters: int
    status: int  # SUCCESS/FAILED/DIVERGED/NOT_CONVERGED
    final_norm: np.ndarray  # (ncomp,) real
    initial_norm: np.ndarray  # (ncomp,) real
    history: np.ndarray  # (max_iters+1, ncomp) real, NaN-padded


class _Settled:
    """A :class:`SolveResult` field of a pending solve: the first read
    waits for the solve and then the instance's own value (set by the
    settle) shadows this descriptor."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, cls=None):
        if obj is None:
            return self
        obj._settle()
        return obj.__dict__[self.name]


class PendingSolveResult(SolveResult):
    """The result of ``solve(block=False)``: the solve runs on the
    dispatch worker (``core/dispatch.py``) and every field comes from
    its future when first read, so reading ``x``, ``iters``, ``status``,
    ``final_norm``, ``initial_norm`` or ``history`` waits for it (and
    raises the solve's error, if it failed).  ``then(fn)`` is the
    result ``fn(result)`` of the same solve, still pending.
    ``dataclasses.replace`` of a pending result waits and gives a
    settled one."""

    x = _Settled()
    iters = _Settled()
    status = _Settled()
    final_norm = _Settled()
    initial_norm = _Settled()
    history = _Settled()

    def __init__(self, future=None, then=None, **fields):
        if future is None:
            # dataclasses.replace: the fields are given
            SolveResult.__init__(self, **fields)
            self._future = None
            return
        self._future = future
        self._then = then

    def _settle(self):
        if self._future is None or "x" in self.__dict__:
            return
        res = self._future.result()
        if self._then is not None:
            res = self._then(res)
        for f in dataclasses.fields(SolveResult):
            self.__dict__[f.name] = getattr(res, f.name)

    def then(self, fn) -> "PendingSolveResult":
        if self._future is None:
            return fn(self)
        first = self._then
        return PendingSolveResult(
            self._future,
            then=fn if first is None else (lambda r: fn(first(r))))


def host_norm(t) -> np.ndarray:
    """A norm tensor read to the host as a (ncomp,) numpy array (a
    bf16 norm as float32)."""
    return np.atleast_1d(host_array(t))


class Solver:
    """Base solver. Subclasses register via @register_solver(NAME)."""

    registry_name = "?"
    # inner steps per reported iteration (SSTEP_PCG: one outer
    # iteration is s CG steps)
    iterations_scale = 1

    def __init__(self, cfg, scope: str = "default", device="cuda"):
        self.cfg = cfg
        self.scope = scope
        self.device = resolve_device(device)
        g = lambda k: cfg.get(k, scope)
        self.max_iters = int(g("max_iters"))
        self.tolerance = float(g("tolerance"))
        self.conv_type = str(g("convergence"))
        self.norm_type = NormType(str(g("norm")))
        self.monitor_residual = bool(g("monitor_residual"))
        self.use_scalar_norm = bool(g("use_scalar_norm"))
        self.relaxation_factor = float(g("relaxation_factor"))
        self.print_solve_stats = bool(g("print_solve_stats"))
        self.obtain_timings = bool(g("obtain_timings"))
        self.verbosity = int(g("verbosity_level"))
        # solver_verbose=1 dumps the solver settings at setup
        # (reference solver.cu:349)
        self.solver_verbose = bool(g("solver_verbose"))
        self.convergence_analysis = int(g("convergence_analysis"))
        self.rel_div_tolerance = float(g("rel_div_tolerance"))
        self.alt_rel_tolerance = float(g("alt_rel_tolerance"))
        self.stagnation_window = int(g("stagnation_window"))
        self.solve_retries = int(g("solve_retries"))
        self.scaling = str(g("scaling"))
        # overwritten to NONE by make_nested
        self.reordering = str(g("matrix_reordering"))
        self._conv_check = make_convergence_check(
            self.conv_type, self.tolerance, self.alt_rel_tolerance
        )
        self.A = None
        # (row, column) scaling tensors when the system was scaled at
        # setup, and (perm, iperm) tensors when it was reordered
        self._scale_vecs = None
        self._reorder = None
        self._params: Any = None
        self._cache: dict = {}
        self.setup_time = 0.0
        self.solve_time = 0.0
        # seconds building the solve function (the JAX package's compile
        # time): the last solve's, and their sum
        self.last_compile_s = 0.0
        self.compile_time = 0.0
        # retries the last solve took (``solve_retries``)
        self.solve_retries_used = 0
        # seconds of the last load_setup import (0 for a set-up solver)
        self.restore_time = 0.0

    # ------------------------------------------------------------------
    # overridables

    def _setup_impl(self, A):
        """Host-side setup; must set self._params."""
        self._params = A

    def make_step(self) -> Callable:
        """fn(params, b, x) -> x : one relaxation sweep."""
        rstep = self.make_residual_step()
        if rstep is None:
            raise NotImplementedError(
                f"{type(self).__name__} provides no stationary step"
            )

        def step(params, b, x):
            A = self.operator_of(params)
            return rstep(params, b, x, b - spmv(A, x))

        return step

    def make_residual_step(self) -> Optional[Callable]:
        """fn(params, b, x, r) -> x consuming r = b - A x, or None."""
        return None

    def make_solve(self) -> Callable:
        """fn(params, b, x0) -> SolveResult.  Default: monitored
        stationary iteration of make_step (reference
        solver.cu:795-855)."""
        norm_of = self.make_norm()

        if not self.monitor_residual:
            smooth = self.make_smooth()
            iters = self.max_iters

            def solve_plain(params, b, x0):
                x = smooth(params, b, x0, iters)
                return self._fixed_result(x, b, iters)

            return solve_plain

        rstep = self.make_residual_step()
        if rstep is not None:
            # one SpMV per iteration shared by the step and the norm
            def solve_r(params, b, x0):
                A = self.operator_of(params)
                r0 = b - spmv(A, x0)

                def body(x, extra):
                    (r,) = extra
                    x = faults.corrupt_nan("smoother_nan",
                                           rstep(params, b, x, r))
                    r = b - spmv(A, x)
                    return x, (r,), norm_of(r)

                return self._monitored_loop(
                    norm_of(r0), body, b, x0, (r0,)
                )

            return solve_r

        step = self.make_step()

        def solve(params, b, x0):
            A = self.operator_of(params)

            def body(x, extra):
                x = faults.corrupt_nan("smoother_nan", step(params, b, x))
                return x, extra, norm_of(b - spmv(A, x))

            return self._monitored_loop(
                norm_of(b - spmv(A, x0)), body, b, x0, ()
            )

        return solve

    def make_apply(self) -> Callable:
        """fn(params, r) -> z with zero initial guess; default =
        max_iters unmonitored sweeps."""
        smooth = self.make_smooth()
        iters = max(self.max_iters, 1)

        def apply(params, r):
            return smooth(params, r, torch.zeros_like(r), iters)

        return apply

    def make_smooth(self) -> Callable:
        """fn(params, b, x, sweeps) -> x; one ``smoother_nan`` place a
        call, after the sweeps."""
        step = self.make_step()

        def smooth(params, b, x, sweeps):
            for _ in range(sweeps):
                x = step(params, b, x)
            return faults.corrupt_nan("smoother_nan", x)

        return smooth

    # ------------------------------------------------------------------
    # shared machinery

    def operator_of(self, params):
        """By convention params is the matrix or a tuple starting with it."""
        return params[0] if isinstance(params, tuple) else params

    @property
    def norm_components(self) -> int:
        """Components of the monitored norm: the block size of a block
        system unless ``use_scalar_norm``, else 1."""
        if (
            self.A is not None
            and self.A.block_size > 1
            and not self.use_scalar_norm
        ):
            return self.A.block_size
        return 1

    def make_norm(self):
        """fn(r) -> (norm_components,) tensor."""
        A, nt, scalar = self.A, self.norm_type, self.use_scalar_norm
        return lambda r: _get_norm(A, r, nt, scalar).reshape(-1)

    def _monitor_update(self, it, nrm, nrm_ini, nrm_max, hist):
        """Record the norm, update the max norm and derive the status
        (host numpy, residual's real dtype)."""
        nrm_max = np.maximum(nrm_max, nrm)
        hist[it] = nrm
        status = (
            SUCCESS if self._conv_check(nrm, nrm_ini, nrm_max)
            else NOT_CONVERGED
        )
        if self.rel_div_tolerance > 0 and np.any(
            nrm > self.rel_div_tolerance * nrm_ini
        ):
            status = DIVERGED
        if self.stagnation_window > 0:
            # no better than the best of the previous w iterations
            w = min(self.stagnation_window, self.max_iters + 1)
            lo = max(it - w, 0)
            best = np.min(hist[lo:lo + w], axis=0)
            if it >= w and np.all(nrm >= best) and status == NOT_CONVERGED:
                status = DIVERGED
        if not np.all(np.isfinite(nrm)):
            status = FAILED
        return nrm_max, status

    def _fixed_result(self, x, b, iters) -> SolveResult:
        """Result of an unmonitored fixed-iteration solve: never NaN
        reported as SUCCESS."""
        rdt = _real_np_dtype(b)
        ncomp = self.norm_components
        zero = np.zeros((ncomp,), rdt)
        status = SUCCESS if bool(torch.isfinite(x).all()) else FAILED
        return SolveResult(
            x=x, iters=int(iters), status=status, final_norm=zero,
            initial_norm=zero,
            history=np.full((self.max_iters + 1, ncomp), np.nan, rdt),
        )

    def _monitored_loop(self, nrm0, body, b, x0, extra0):
        """The monitored loop (reference solver.cu:586-860).
        ``body(x, extra) -> (x, extra, nrm)`` runs one iteration and
        returns the new residual norm as a tensor; it is read to the
        host once per iteration.  The body is one fault region (the
        JAX package's ``while_loop``)."""
        rdt = _real_np_dtype(b)
        nrm0 = host_norm(nrm0).astype(rdt, copy=False)
        hist = np.full((self.max_iters + 1, nrm0.shape[0]), np.nan, rdt)
        hist[0] = nrm0
        status = (
            SUCCESS if self._conv_check(nrm0, nrm0, nrm0)
            else NOT_CONVERGED
        )
        it, x, extra, nrm, mx = 0, x0, extra0, nrm0, nrm0
        region = faults.loop()
        while status == NOT_CONVERGED and it < self.max_iters:
            with region:
                x, extra, nrm_t = body(x, extra)
            nrm = host_norm(nrm_t).astype(rdt, copy=False)
            it += 1
            mx, status = self._monitor_update(it, nrm, nrm0, mx, hist)
        return SolveResult(
            x=x, iters=it, status=status, final_norm=nrm,
            initial_norm=nrm0, history=hist,
        )

    # ------------------------------------------------------------------
    # public API (reference Solver::setup / solve, solver.cu:333,586)

    def _check_device(self, A):
        if A.device != self.device:
            raise ValueError(
                f"{self.registry_name}: matrix on {A.device}, solver on "
                f"{self.device}"
            )

    def setup(self, A):
        self._check_device(A)
        t0 = time.perf_counter()
        from amgx_tpu_torch.core import errors as _errors

        if _errors.validation_enabled():
            _errors.validate_operator(
                A, where=f"{self.registry_name} setup"
            )
        if self.solver_verbose:
            emit(
                f"{self.registry_name} solver settings (scope "
                f"{self.scope!r}): max_iters={self.max_iters} "
                f"tolerance={self.tolerance} norm={self.norm_type.value} "
                f"convergence={self.conv_type} "
                f"relaxation_factor={self.relaxation_factor}"
            )
        self._scale_vecs = None
        self._reorder = None
        if self.scaling.upper() not in ("", "NONE"):
            # scale the system at setup (reference Scaler::setup hook,
            # solver.cu:667-676): work on As = Dr A Dc, uploaded anew
            import scipy.sparse as sps

            from amgx_tpu_torch.core.matrix import SparseMatrix
            from amgx_tpu_torch.solvers.scalers import create_scaler

            sp = A.host_csr()
            r, c = create_scaler(self.scaling).compute(sp)
            dt = sp.dtype
            sp = sps.diags_array(r) @ sp @ sps.diags_array(c)
            A = SparseMatrix.from_scipy(sp.tocsr().astype(dt),
                                        block_size=A.block_size,
                                        device=self.device)
            # in the matrix's dtype: the vectors of an f32 solve stay f32
            self._scale_vecs = (
                torch.from_numpy(r.astype(dt)).to(self.device),
                torch.from_numpy(c.astype(dt)).to(self.device),
            )
        if self.reordering.upper() != "NONE":
            # RCM renumbering at the solve boundary (reference Scaler
            # hook, solver.cu:667-676): the operator is built once,
            # permuted
            from amgx_tpu_torch.ops.reorder import maybe_reorder

            A2, perm = maybe_reorder(A, self.reordering)
            if perm is not None:
                perm_t = torch.from_numpy(perm).to(self.device)
                self._reorder = (perm_t, torch.argsort(perm_t))
                A = A2
        self.A = A
        self._setup_impl(A)
        self._cache.clear()
        self.setup_time = time.perf_counter() - t0
        return self

    def resetup(self, A):
        """Refresh for a matrix whose values changed and whose structure
        did not (reference ``AMGX_solver_resetup``; the JAX package's
        ``resetup``).  Solvers with a values-only path take it in
        ``_resetup_impl``; anything else, and any solver that has not
        been set up, was set up on a scaled or renumbered system, or is
        given a matrix of other rows, nonzeros or block size, runs a
        full ``setup``."""
        self._check_device(A)
        if (
            self.A is None
            or self._scale_vecs is not None
            or self._reorder is not None
            or A.n_rows != self.A.n_rows
            or A.nnz != self.A.nnz
            or A.block_size != self.A.block_size
        ):
            return self.setup(A)
        t0 = time.perf_counter()
        if not self._resetup_impl(A):
            return self.setup(A)
        self.A = A
        self._cache.clear()
        self.setup_time = time.perf_counter() - t0
        return self

    def _resetup_impl(self, A) -> bool:
        """Values-only refresh; False makes ``resetup`` run ``setup``."""
        return False

    # ------------------------------------------------------------------
    # setup persistence (``amgx_tpu_torch.store``)

    def _export_setup(self) -> dict:
        """The setup-state tree the store writes (the JAX package's
        layout): the set-up operator, the solve boundary's scale and
        reorder vectors, and a solver-specific ``impl``
        (:meth:`_export_impl`)."""
        from amgx_tpu_torch.core.errors import StoreError

        if self.A is None:
            raise StoreError(
                f"{self.registry_name}: save_setup before setup()"
            )
        return {
            "A": self.A,
            "scale": self._scale_vecs,
            "reorder": self._reorder,
            "impl": self._export_impl(),
        }

    def _import_setup(self, state: dict):
        """Restore from :meth:`_export_setup` without the setup: the
        default (:meth:`_import_impl`) re-derives the parameters from
        the restored operator, which is cheap for every solver that
        holds no hierarchy, factors or spectral bounds."""
        self.A = state["A"]
        self._scale_vecs = _as_tensors(state.get("scale"), self.device)
        self._reorder = _as_tensors(state.get("reorder"), self.device)
        self._import_impl(state.get("impl"))
        self._cache.clear()

    def _export_impl(self):
        """Solver state beyond the operator; None where the parameters
        re-derive from A."""
        return None

    def _import_impl(self, impl):
        self._setup_impl(self.A)

    def save_setup(self, path) -> dict:
        """Write this solver's completed setup to ``path`` (one ``.npz``
        with its JSON manifest, the JAX package's format) so that a
        later process, of either package, restores it without running
        setup.  Returns the manifest."""
        from amgx_tpu_torch.store import serialize

        return serialize.save_setup(self, path)

    @classmethod
    def load_setup(cls, path, cfg=None, expect_dtype=None, device="cuda"):
        """A solver restored on ``device`` from a payload of
        :meth:`save_setup` (written by either package), without running
        setup: ``setup_time`` stays 0 and ``restore_time`` holds the
        import's seconds.  ``cfg`` asserts the payload's configuration
        (its content hash); ``expect_dtype`` refuses a payload of
        another operator dtype before anything reaches the device
        (``StoreError`` with ``RC_BAD_MODE``)."""
        from amgx_tpu_torch.store import serialize

        return serialize.load_setup(path, cfg=cfg, expect_dtype=expect_dtype,
                                    device=device)

    def make_batch_params(self):
        """Values-only rebuild of this solver's ``apply_params()`` for a
        batch of coefficient sets on the setup matrix's structure (the
        serve layer's batched solves; the JAX package's
        ``make_batch_params``).  Returns ``(template, fn)`` with
        ``fn(template, values)`` -> the params of B instances for
        ``values`` (B, nnz): batched views of the operators
        (``SparseMatrix.replace_values_batched``) and of whatever derives
        from their values, and the structure (index arrays, transfers,
        Galerkin plans) shared from ``template``.  None where the solver
        has no such rebuild (the serve layer then solves each system in
        turn).  The default covers solvers whose params are the
        matrix."""
        if self._params is None or self._params is not self.A:
            return None
        return self.A, lambda t, v: t.replace_values_batched(v)

    def apply_params(self):
        return self._params

    def _as_vector(self, v):
        if isinstance(v, torch.Tensor):
            if v.device != self.device:
                raise ValueError(
                    f"{self.registry_name}: vector on {v.device}, solver "
                    f"on {self.device}"
                )
            return v
        return torch.from_numpy(np.ascontiguousarray(v)).to(self.device)

    def solve(self, b, x0=None, zero_initial_guess=False,
              block=True) -> SolveResult:
        """Monitored solve; ``b`` and ``x0`` may be numpy arrays or
        tensors on the solver's device.  ``block=True`` returns when the
        result is computed (the device is synchronised).  ``block=False``
        is the asynchronous mode (the JAX package's): the solve function
        is built and the vectors prepared on the caller's thread, the
        loop (which reads each iteration's norm to the host) runs on
        the dispatch worker, and the call returns a
        :class:`PendingSolveResult` at once; the caller's thread makes
        no synchronisation of its own.  Options that need the numbers
        (``print_solve_stats``, ``obtain_timings``,
        ``convergence_analysis`` > 0, ``solve_retries`` > 0, whose
        trigger reads the status) still run and synchronise before the
        return, as in the JAX package."""
        if self.A is None:
            raise RuntimeError("solve() before setup()")
        b = self._as_vector(b)
        if x0 is None or zero_initial_guess:
            x0 = torch.zeros_like(b)
        else:
            x0 = self._as_vector(x0)
        fn = self._cache.get("solve")
        if fn is None:
            fn = self._build_main_solve()
        else:
            self.last_compile_s = 0.0
        if self._scale_vecs is not None:
            r_s, c_s = self._scale_vecs
            b = r_s * b
            x0 = x0 / torch.where(c_s != 0, c_s, torch.ones_like(c_s))
        if self._reorder is not None:
            perm, _ = self._reorder
            b, x0 = b[perm], x0[perm]
        t0 = time.perf_counter()
        self.solve_retries_used = 0
        if not block and not self._solve_needs_sync():
            from amgx_tpu_torch.core.dispatch import (
                dispatch_pool,
                on_dispatch_worker,
            )

            if not on_dispatch_worker():
                stream = (torch.cuda.current_stream(self.device)
                          if self.device.type == "cuda" else None)
                fut = dispatch_pool().submit(
                    self._solve_on_worker, stream, fn, self.apply_params(),
                    b, x0)
                self.solve_time = time.perf_counter() - t0
                return PendingSolveResult(fut)
        res = self._run_solve(fn, self.apply_params(), b, x0,
                              self.solve_retries > 0)
        self.solve_time = time.perf_counter() - t0
        if self.print_solve_stats and self.verbosity > 2:
            self._print_stats(res)
        elif self.print_solve_stats and self.verbosity in (1, 2):
            emit(
                f"         Total Iterations: {res.iters}  "
                f"status: {res.status}"
            )
        if self.convergence_analysis > 0:
            self._print_convergence_analysis(res)
        if self.obtain_timings:
            emit(
                f"Total Time: {self.setup_time + self.solve_time:10.6f}\n"
                f"    setup: {self.setup_time:10.6f} s\n"
                f"    solve: {self.solve_time:10.6f} s\n"
                f"    solve(per iteration): "
                f"{self.solve_time / max(1, res.iters):10.6f} s"
            )
            # the same lines into the telemetry registry, and a flight
            # record of the direct solve; this branch has synchronised
            self._telemetry_observe(res, self.collect_setup_profile())
        return res

    def _solve_needs_sync(self) -> bool:
        """Does a solve of this solver read its result before it
        returns (a report, or the retry trigger)?"""
        return (self.print_solve_stats or self.obtain_timings
                or self.convergence_analysis > 0 or self.solve_retries > 0)

    def _run_solve(self, fn, params, b, x0, retries: bool) -> SolveResult:
        """The solve function's run, the retry hook, the solve
        boundary's renumbering and scaling of x, and the device's
        synchronisation."""
        res = fn(params, b, x0)
        if retries:
            res = self._retry_if_failed(res, b)
        if self._reorder is not None:
            res = dataclasses.replace(res, x=res.x[self._reorder[1]])
        if self._scale_vecs is not None:
            res = dataclasses.replace(res, x=self._scale_vecs[1] * res.x)
        if res.x.device.type == "cuda":
            torch.cuda.synchronize(res.x.device)
        return res

    def _solve_on_worker(self, stream, fn, params, b, x0) -> SolveResult:
        """``solve(block=False)``'s job on the dispatch worker: the
        blocking solve's run on the caller's stream (``stream``, None on
        the CPU), so its kernels queue behind the caller's uploads as a
        blocking solve's do."""
        if stream is None:
            return self._run_solve(fn, params, b, x0, False)
        torch.cuda.set_device(self.device)
        with torch.cuda.stream(stream):
            return self._run_solve(fn, params, b, x0, False)

    def _build_main_solve(self):
        """Build the solve function (one fault plan: the JAX package's
        trace and compile), timing the build as ``last_compile_s``."""
        t0 = time.perf_counter()
        fn = self._cache["solve"] = faults.built(self.make_solve())
        self.last_compile_s = time.perf_counter() - t0
        self.compile_time += self.last_compile_s
        return fn

    # result-status preference of the retry hook: a retry's outcome
    # replaces the original only when strictly better
    _STATUS_RANK = {FAILED: 0, DIVERGED: 1, NOT_CONVERGED: 2, SUCCESS: 3}

    def _retry_if_failed(self, res: SolveResult, b) -> SolveResult:
        """Retry with a safer configuration (``solve_retries``, the JAX
        package's hook).  A FAILED or DIVERGED solve retries up to
        ``solve_retries`` times; each attempt evicts the main solve
        function (its next solve builds afresh, escaping spent fault
        injections) and restarts from a zero initial guess.  The first
        retry keeps the configuration (transient corruption); later
        ones halve the relaxation factor each time (real divergence).
        Each retry build is cached under its own ``("retry", attempt)``
        slot, so a later failing solve reuses it.  The best result by
        status wins."""
        attempt = 0
        while (attempt < self.solve_retries
               and int(res.status) in (FAILED, DIVERGED)):
            attempt += 1
            self.solve_retries_used = attempt
            self._cache.pop("solve", None)
            rkey = ("retry", attempt)
            fn = self._cache.get(rkey)
            if fn is None:
                old_omega = self.relaxation_factor
                self.relaxation_factor = old_omega * 0.5 ** (attempt - 1)
                try:
                    fn = faults.built(self.make_solve())
                finally:
                    self.relaxation_factor = old_omega
                self._cache[rkey] = fn
            retry = fn(self.apply_params(), b, torch.zeros_like(b))
            if self._STATUS_RANK.get(int(retry.status), 0) > \
                    self._STATUS_RANK.get(int(res.status), 0):
                res = retry
        return res

    def collect_setup_profile(self) -> dict:
        """The setup-phase profile of this solver and its nested
        preconditioner, summed (the ``setup:<phase>`` seconds)."""
        prof = dict(getattr(self, "setup_profile", None) or {})
        inner = getattr(self, "precond", None)
        if inner is not None and inner is not self:
            for k, v in inner.collect_setup_profile().items():
                prof[k] = prof.get(k, 0) + v
        return prof

    def _telemetry_observe(self, res: SolveResult, setup_prof: dict):
        """Fold one timed solve into the telemetry registry's solver
        aggregate and record it in the default flight recorder
        (``path="direct"``).  Best effort: any failure, the
        ``telemetry_export`` fault included, is swallowed; the result
        is already computed."""
        try:
            from amgx_tpu_torch import telemetry
            from amgx_tpu_torch.telemetry.registry import default_recorder

            if not telemetry.telemetry_enabled():
                return
            # iterations in inner-step equivalents (an s-step outer
            # iteration is s CG steps); reductions and cycle passes are
            # the per-iteration counts times the loop's iterations
            red = self.reductions_per_iteration()
            cp = self.cycle_passes_per_iteration()
            telemetry.get_registry().record_solver(
                self.registry_name,
                setup_s=self.setup_time,
                compile_s=self.last_compile_s,
                solve_s=self.solve_time,
                iterations=int(res.iters) * int(self.iterations_scale),
                reductions=(red or 0) * int(res.iters),
                cycle_passes=(cp or 0) * int(res.iters),
                setup_phases={k: v for k, v in (setup_prof or {}).items()
                              if isinstance(v, float)},
            )
            default_recorder().record(
                fingerprint=(self.A.fingerprint() if self.A is not None
                             else ""),
                config=self.cfg.content_hash(),
                lane="direct",
                tenant="-",
                iterations=int(res.iters),
                final_residual=float(np.max(np.asarray(res.final_norm))),
                status=int(res.status),
                stages={"setup": self.setup_time,
                        "compile": self.last_compile_s,
                        "solve": self.solve_time},
                path="direct",
            )
        except Exception:  # noqa: BLE001 — observability may fail, the
            # solve may not
            pass

    def reductions_per_iteration(self):
        """Global reductions (dots and norms: the cross-device sync
        points of a sharded solve) one monitored iteration makes,
        counted under :func:`amgx_tpu_torch.ops.blas.reduction_counter`
        by running one loop body on zero vectors: on the card that pass
        launches kernels (the JAX package only traces).  None where the
        solver has no step or iteration protocol (GMRES, IDR).  Cached
        per setup; the count behind ``amgx_solver_reductions_total``."""
        key = "reductions_per_iteration"
        if key not in self._cache:
            try:
                val = faults.built(self._count_iteration_reductions)()
            except Exception:  # noqa: BLE001 — accounting never fails
                val = None
            self._cache[key] = val
        return self._cache[key]

    def cycle_passes_per_iteration(self):
        """Fine-grid operator passes an iteration makes: None for
        solvers without a cycle (the AMG hierarchy overrides it)."""
        return None

    def _count_iteration_reductions(self):
        """Run one monitored-loop body (iterate and the residual norm)
        on zeros and count its reduction sites, as the JAX package
        counts them on the traced body."""
        from amgx_tpu_torch.ops import blas

        if self.A is None:
            return None
        params = self.apply_params()
        z = torch.zeros(self.A.n_rows * self.A.block_size,
                        dtype=self.A.dtype, device=self.device)
        norm_of = self.make_norm() if self.monitor_residual else None
        if hasattr(self, "_make_init"):
            try:
                init_fn, iter_fn = self._make_init(), self._make_iter()
            except NotImplementedError:
                init_fn = None
            if init_fn is not None:
                extra = init_fn(params, z, z)
                with blas.reduction_counter() as c:
                    x, e = iter_fn(params, z, z, extra)
                    if norm_of is not None:
                        norm_of(e[0])
                return c.count
        rstep = self.make_residual_step()
        if rstep is not None:
            with blas.reduction_counter() as c:
                x = rstep(params, z, z, z)
                if norm_of is not None:
                    norm_of(z - spmv(self.operator_of(params), x))
            return c.count
        step = self.make_step()
        with blas.reduction_counter() as c:
            x = step(params, z, z)
            if norm_of is not None:
                norm_of(z - spmv(self.operator_of(params), x))
        return c.count

    def _print_stats(self, res: SolveResult):
        """Residual table in the reference output format."""
        hist, iters = res.history, res.iters
        lines = ["           iter      residual           rate",
                 "         --------------------------------------"]
        for i in range(min(iters, self.max_iters) + 1):
            row = hist[i]
            if np.all(np.isnan(row)):
                continue
            r = float(np.max(row))
            if i == 0:
                lines.append(f"            Ini {r:18.6e}")
            else:
                prev = float(np.max(hist[i - 1]))
                rate = r / prev if prev > 0 else 0.0
                lines.append(f"            {i:3d} {r:18.6e} {rate:14.4f}")
        label = {
            SUCCESS: "success",
            FAILED: "failed (nan/inf)",
            DIVERGED: "diverged",
            NOT_CONVERGED: "not converged",
        }.get(res.status, f"unknown ({res.status})")
        lines.append("         --------------------------------------")
        emit("\n".join(lines))
        r0 = float(np.max(hist[0]))
        rn = float(np.max(hist[iters]))
        rate = (rn / r0) ** (1.0 / iters) if iters >= 1 and r0 > 0 else 0.0
        emit(
            f"         Total Iterations: {iters}\n"
            f"         Avg Convergence Rate: {rate:18.4f}\n"
            f"         Final Residual: {rn:18.6e}\n"
            f"         Residual reduction: {rn / max(r0, 1e-300):18.6e}\n"
            f"         Solve status: {label}"
        )

    def _print_convergence_analysis(self, res: SolveResult):
        """Geometric-mean and per-iteration rates over the last
        ``convergence_analysis`` iterations."""
        hist, iters = res.history, res.iters
        k = min(self.convergence_analysis, iters)
        if k < 1:
            return
        rows = []
        for i in range(iters - k + 1, iters + 1):
            prev = float(np.max(hist[i - 1]))
            cur = float(np.max(hist[i]))
            rows.append(
                f"           iter {i:3d}: rate "
                f"{(cur / prev if prev > 0 else 0.0):10.4f}"
            )
        r0 = float(np.max(hist[iters - k]))
        rn = float(np.max(hist[iters]))
        geo = (rn / r0) ** (1.0 / k) if r0 > 0 else 0.0
        emit(
            "         Convergence analysis (last %d iterations):\n" % k
            + "\n".join(rows)
            + f"\n           geometric-mean rate: {geo:10.4f}"
        )


def _as_tensors(vecs, device):
    """A tuple of vectors as tensors on ``device`` (None stays None)."""
    if vecs is None:
        return None
    return tuple(
        v if isinstance(v, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for v in vecs
    )


def _real_np_dtype(b):
    """The host dtype of b's norms (float32 for a bf16 b)."""
    return host_dtype(b.real.dtype)
