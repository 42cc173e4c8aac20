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
JAX package on any non-TPU backend, never reorders.  Not ported
(ROADMAP.md, queue A) and raising ``NotImplementedError`` when a config
asks for them: solve retries and fault injection (``AMGX_TPU_FAULTS``).
The setup store and telemetry have no entry point in this package yet.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from amgx_tpu_torch.core.device import resolve_device
from amgx_tpu_torch.core.types import NormType
from amgx_tpu_torch.ops.norms import norm as _norm
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


def host_norm(t) -> np.ndarray:
    """A norm tensor read to the host as a (ncomp,) numpy array."""
    return np.atleast_1d(t.detach().cpu().numpy())


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
        self.relaxation_factor = float(g("relaxation_factor"))
        self.print_solve_stats = bool(g("print_solve_stats"))
        self.obtain_timings = bool(g("obtain_timings"))
        self.verbosity = int(g("verbosity_level"))
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
                    x = rstep(params, b, x, r)
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
                x = step(params, b, x)
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
        """fn(params, b, x, sweeps) -> x."""
        step = self.make_step()

        def smooth(params, b, x, sweeps):
            for _ in range(sweeps):
                x = step(params, b, x)
            return x

        return smooth

    # ------------------------------------------------------------------
    # shared machinery

    def operator_of(self, params):
        """By convention params is the matrix or a tuple starting with it."""
        return params[0] if isinstance(params, tuple) else params

    def make_norm(self):
        nt = self.norm_type
        return lambda r: _norm(r, nt).reshape(1)

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
        zero = np.zeros((1,), rdt)
        status = SUCCESS if bool(torch.isfinite(x).all()) else FAILED
        return SolveResult(
            x=x, iters=int(iters), status=status, final_norm=zero,
            initial_norm=zero,
            history=np.full((self.max_iters + 1, 1), np.nan, rdt),
        )

    def _monitored_loop(self, nrm0, body, b, x0, extra0):
        """The monitored loop (reference solver.cu:586-860).
        ``body(x, extra) -> (x, extra, nrm)`` runs one iteration and
        returns the new residual norm as a tensor; it is read to the
        host once per iteration."""
        rdt = _real_np_dtype(b)
        nrm0 = host_norm(nrm0).astype(rdt, copy=False)
        hist = np.full((self.max_iters + 1, nrm0.shape[0]), np.nan, rdt)
        hist[0] = nrm0
        status = (
            SUCCESS if self._conv_check(nrm0, nrm0, nrm0)
            else NOT_CONVERGED
        )
        it, x, extra, nrm, mx = 0, x0, extra0, nrm0, nrm0
        while status == NOT_CONVERGED and it < self.max_iters:
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

    def _check_unported(self):
        if self.solve_retries > 0:
            raise NotImplementedError(
                "solve_retries is not ported yet (ROADMAP.md, queue A: "
                "serving tier and fault injection)"
            )
        if os.environ.get("AMGX_TPU_FAULTS"):
            raise NotImplementedError(
                "fault injection (AMGX_TPU_FAULTS) is not ported yet "
                "(ROADMAP.md, queue A: serving tier and fault injection)"
            )

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

        self._check_unported()
        if _errors.validation_enabled():
            _errors.validate_operator(
                A, where=f"{self.registry_name} setup"
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

    def solve(self, b, x0=None, zero_initial_guess=False) -> SolveResult:
        """Monitored solve; ``b`` and ``x0`` may be numpy arrays or
        tensors on the solver's device.  Returns when the result is
        computed (the device is synchronised)."""
        if self.A is None:
            raise RuntimeError("solve() before setup()")
        b = self._as_vector(b)
        if x0 is None or zero_initial_guess:
            x0 = torch.zeros_like(b)
        else:
            x0 = self._as_vector(x0)
        fn = self._cache.get("solve")
        if fn is None:
            fn = self._cache["solve"] = self.make_solve()
        if self._scale_vecs is not None:
            r_s, c_s = self._scale_vecs
            b = r_s * b
            x0 = x0 / torch.where(c_s != 0, c_s, torch.ones_like(c_s))
        if self._reorder is not None:
            perm, _ = self._reorder
            b, x0 = b[perm], x0[perm]
        t0 = time.perf_counter()
        res = fn(self.apply_params(), b, x0)
        if self._reorder is not None:
            res = dataclasses.replace(res, x=res.x[self._reorder[1]])
        if self._scale_vecs is not None:
            res = dataclasses.replace(res, x=self._scale_vecs[1] * res.x)
        if res.x.device.type == "cuda":
            torch.cuda.synchronize(res.x.device)
        self.solve_time = time.perf_counter() - t0
        if self.print_solve_stats and self.verbosity > 2:
            self._print_stats(res)
        elif self.print_solve_stats and self.verbosity in (1, 2):
            print(
                f"         Total Iterations: {res.iters}  "
                f"status: {res.status}"
            )
        if self.convergence_analysis > 0:
            self._print_convergence_analysis(res)
        if self.obtain_timings:
            print(
                f"Total Time: {self.setup_time + self.solve_time:10.6f}\n"
                f"    setup: {self.setup_time:10.6f} s\n"
                f"    solve: {self.solve_time:10.6f} s\n"
                f"    solve(per iteration): "
                f"{self.solve_time / max(1, res.iters):10.6f} s"
            )
        return res

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
        print("\n".join(lines))
        r0 = float(np.max(hist[0]))
        rn = float(np.max(hist[iters]))
        rate = (rn / r0) ** (1.0 / iters) if iters >= 1 and r0 > 0 else 0.0
        print(
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
        print(
            "         Convergence analysis (last %d iterations):\n" % k
            + "\n".join(rows)
            + f"\n           geometric-mean rate: {geo:10.4f}"
        )


def _real_np_dtype(b):
    return np.dtype(str(b.real.dtype).replace("torch.", ""))
