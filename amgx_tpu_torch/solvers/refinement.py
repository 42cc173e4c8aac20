"""ITERATIVE_REFINEMENT: mixed-precision iterative refinement with a
float-float solution (the JAX package's ``solvers/refinement.py``;
the reference's dDFI mixed mode, f64 vectors over an f32 matrix,
basic_types.h:92-117).

    loop: r = b - A x          (ff accumulation, ops/ff.py)
          solve A d = r        (the inner solver under 'preconditioner',
                                in working precision, loose)
          x = x (+ff) d

Plain f32 Krylov stagnates near rtol 1e-5 at >= 16M unknowns, where
neither x nor the residual resolves in one f32 word; carrying x as a
pair and accumulating the residual in ff restores convergence to 1e-8
at f32 bandwidth.  ``tolerance`` / ``convergence`` are the outer
criteria, ``max_iters`` the cap on outer corrections.

The outer loop runs on the host, as the port's monitored loops do: one
read of the residual norm per correction.  Each correction forms the
ff residual once, after its update: the norm is read from it, and its
high word feeds the next inner solve.  (The JAX package forms it again
at the top of the next correction to keep XLA from simplifying the
error-free transformations across its loop boundary; eager torch runs
each operation as written, and the second pass would return the same
bits.)  :meth:`solve` returns x
as ``hi + lo`` summed in f64 on the host, a CPU tensor: rounded back to
one f32 word, the refined digits would be lost.

Precision guardrail (``precision_fallback``): where the inner solver
holds a hierarchy in another dtype than the operator
(``hierarchy_dtype``), a solve that ends non-SUCCESS, or takes more
corrections than ``refine_iteration_guard`` (> 0), is re-solved once on
a twin set up with ``hierarchy_dtype`` SAME; ``precision_fallbacks``
counts the trips.  ``last_inner_iters`` is the inner iterations of the
last solve, ``first_attempt`` its own refinement's (status,
corrections) before any fallback.  ``save_setup`` stores the inner
solver's setup.

Batched serve protocol (``_make_init`` / ``_make_iter`` and
``make_batch_params``, the JAX package's): one iteration is one outer
correction on (B, n) vectors, extra = (residual estimate, low word of
x, high word of the residual).  A monitored inner solver runs each
correction's solves to their own convergence
(``solvers/batched_loop.make_masked_loop``).  The batched loop returns x's
high word and applies no guardrail, as the JAX package's does: an
instance that ends non-SUCCESS keeps its status.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from amgx_tpu_torch.core import faults
from amgx_tpu_torch.core.types import host_array
from amgx_tpu_torch.ops import ff as ffm
from amgx_tpu_torch.ops.norms import norm as _norm
from amgx_tpu_torch.solvers.base import (
    NOT_CONVERGED,
    SUCCESS,
    Solver,
    SolveResult,
    _real_np_dtype,
    host_norm,
)
from amgx_tpu_torch.solvers.batched_loop import make_masked_loop
from amgx_tpu_torch.solvers.registry import register_solver


@register_solver("ITERATIVE_REFINEMENT")
class IterativeRefinementSolver(Solver):
    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        from amgx_tpu_torch.solvers.krylov import resolve_preconditioner

        self.inner = (
            resolve_preconditioner(cfg, scope, self.device)
            if cfg.has("preconditioner", scope)
            else None
        )
        if self.inner is None:
            raise ValueError(
                "ITERATIVE_REFINEMENT needs an inner solver under "
                "'preconditioner' (NOSOLVER is not one)"
            )
        self.precision_fallback = bool(cfg.get("precision_fallback", scope))
        self.iteration_guard = int(cfg.get("refine_iteration_guard", scope))
        self.precision_fallbacks = 0
        self._fallback_solver = None
        # inner iterations of the last solve (a sum of the inner solver's
        # reported iterations, times its iterations_scale)
        self.last_inner_iters = 0
        self.first_attempt = None

    def _setup_impl(self, A):
        self.inner.setup(A)
        self._params = (A, self.inner.apply_params())

    def _resetup_impl(self, A) -> bool:
        """Values-only refresh through the inner solver (its own full
        setup where it has no values-only path)."""
        self.inner.resetup(A)
        self._params = (A, self.inner.apply_params())
        return True

    def _export_impl(self):
        return {"inner": self.inner._export_setup()}

    def _import_impl(self, impl):
        if not impl or impl.get("inner") is None:
            return self._setup_impl(self.A)
        self.inner._import_setup(impl["inner"])
        self._params = (self.A, self.inner.apply_params())

    def _make_solve_pair(self):
        """fn(params, b, x0) -> (SolveResult with x = hi, lo, inner
        iterations)."""
        inner_solve = self.inner.make_solve()
        max_outer = max(self.max_iters, 1)
        nt = self.norm_type

        def residual(A, b_ff, xh, xl):
            """(norm of the ff residual on the host, its high word)."""
            r = ffm.ff_residual(A, b_ff, (xh, xl))
            return host_norm(_norm(r[0] + r[1], nt).reshape(1)), r[0]

        def solve(params, b, x0):
            A, inner_params = params
            rdt = _real_np_dtype(b)
            b_ff = ffm.ff(b)
            xh = x0.to(b.dtype)
            xl = torch.zeros_like(xh)
            nrm0, rh = residual(A, b_ff, xh, xl)
            nrm0 = nrm0.astype(rdt, copy=False)
            hist = np.full((max_outer + 1, 1), np.nan, rdt)
            hist[0] = nrm0
            done = bool(self._conv_check(nrm0, nrm0, nrm0)
                        or np.all(nrm0 == 0))
            it, nrm, mx, inner_tot = 0, nrm0, nrm0, 0
            region = faults.loop()
            while it < max_outer and not done:
                with region:
                    res = inner_solve(inner_params, rh,
                                      torch.zeros_like(rh))
                    xh, xl = ffm.ff_add((xh, xl), ffm.ff(res.x))
                    nrm, rh = residual(A, b_ff, xh, xl)
                nrm = nrm.astype(rdt, copy=False)
                mx = np.maximum(mx, nrm)
                it += 1
                hist[it] = nrm
                done = bool(self._conv_check(nrm, nrm0, mx)
                            or np.all(nrm == 0))
                inner_tot += int(res.iters)
            return (
                SolveResult(
                    x=xh, iters=it,
                    status=SUCCESS if done else NOT_CONVERGED,
                    final_norm=nrm, initial_norm=nrm0, history=hist,
                ),
                xl,
                inner_tot,
            )

        return solve

    # -- iteration protocol (serve batching) --------------------------

    def _make_init(self):
        def init(params, b, x0):
            A, _ip = params
            xl = torch.zeros_like(x0)
            rh, rl = ffm.ff_residual(A, ffm.ff(b), (x0, xl))
            return (rh + rl, xl, rh)

        return init

    def _make_iter(self):
        inner_solve = self.inner.make_solve()
        batched = None
        if self.inner.monitor_residual:
            batched = make_masked_loop(self.inner)
            if batched is None:
                raise NotImplementedError(
                    f"{type(self.inner).__name__} has no iteration "
                    "protocol to run a batch of corrections"
                )

        def iterate(params, b, x, extra):
            A, ip = params
            _r, xl, rh = extra
            if batched is not None and rh.dim() == 2:
                d = batched(ip, rh, torch.zeros_like(rh)).x
            else:
                d = inner_solve(ip, rh, torch.zeros_like(rh)).x
            xh, xl = ffm.ff_add((x, xl), ffm.ff(d))
            r2h, r2l = ffm.ff_residual(A, ffm.ff(b), (xh, xl))
            return xh, (r2h + r2l, xl, r2h)

        return iterate

    def make_batch_params(self):
        """The operator's batched view and the inner solver's batch
        rebuild; None where the inner solver has none.  A monitored
        inner solver without an iteration protocol (GMRES, IDR) leaves
        the rebuild but no iteration (``_make_iter`` raises), so the
        serve layer runs such a refinement in turn."""
        if self.A is None or self.A.block_size != 1:
            return None
        sub = self.inner.make_batch_params()
        if sub is None:
            return None
        itmpl, ifn = sub
        A0 = self._params[0]

        def fn(t, v):
            At, it = t
            return At.replace_values_batched(v), ifn(it, v)

        return (A0, itmpl), fn

    def make_solve(self):
        """fn(params, b, x0) -> SolveResult with x = hi + lo in working
        precision (nested use; :meth:`solve` keeps the pair)."""
        pair = self._make_solve_pair()

        def solve(params, b, x0):
            res, xl, _ = pair(params, b, x0)
            return dataclasses.replace(res, x=res.x + xl)

        return solve

    def make_apply(self):
        solve = self.make_solve()

        def apply(params, r):
            return solve(params, r, torch.zeros_like(r)).x

        return apply

    def solve(self, b, x0=None, zero_initial_guess=False,
              block=True) -> SolveResult:
        """The refined solve: x returns as the pair summed in f64 on the
        host (a CPU tensor), after the solve-boundary scaling and
        renumbering the base solve applies.  A tripped guardrail
        re-solves once on the full-precision twin.  The host sum and the
        guardrail read the result, so ``block=False`` synchronises
        before the return too (a sync-requiring option)."""
        if self.A is None:
            raise RuntimeError("solve() before setup()")
        raw_b, raw_x0 = b, x0
        b = self._as_vector(b)
        if x0 is None or zero_initial_guess:
            x0 = torch.zeros_like(b)
        else:
            x0 = self._as_vector(x0)
        if self._scale_vecs is not None:
            r_s, c_s = self._scale_vecs
            b = r_s * b
            x0 = x0 / torch.where(c_s != 0, c_s, torch.ones_like(c_s))
        if self._reorder is not None:
            perm, _ = self._reorder
            b, x0 = b[perm], x0[perm]
        fn = self._cache.get("pair")
        if fn is None:
            fn = self._cache["pair"] = faults.built(self._make_solve_pair())
        t0 = time.perf_counter()
        res, xl, inner_tot = fn(self.apply_params(), b, x0)
        scale = getattr(self.inner, "iterations_scale", 1)
        self.last_inner_iters = int(inner_tot) * int(scale)
        self.first_attempt = (int(res.status), int(res.iters))
        if self._guardrail_tripped(res):
            return self._solve_f64_fallback(raw_b, raw_x0,
                                            zero_initial_guess, t0)
        x64 = (host_array(res.x).astype(np.float64)
               + host_array(xl).astype(np.float64))
        if self._reorder is not None:
            x64 = x64[host_array(self._reorder[1])]
        if self._scale_vecs is not None:
            x64 = x64 * host_array(self._scale_vecs[1]).astype(np.float64)
        res = dataclasses.replace(res, x=torch.from_numpy(x64))
        self.solve_time = time.perf_counter() - t0
        if self.print_solve_stats:
            self._print_stats(res)
        return res

    # ------------------------------------------------------------------
    # precision-fallback guardrail

    def _reduced_precision_config(self) -> bool:
        """Does the set-up inner solver hold any level operator or
        transfer in another dtype than the operator's?  Read from the
        built levels, not the config's spelling: FLOAT64 on an f64
        operator casts nothing, and the guardrail stays inert."""
        if self.A is None:
            return False
        base = self.A.dtype
        stack, seen = [self.inner], set()
        while stack:
            s = stack.pop()
            if s is None or id(s) in seen:
                continue
            seen.add(id(s))
            stack.append(getattr(s, "precond", None))
            stack.append(getattr(s, "inner", None))
            for lvl in getattr(s, "levels", ()):
                for m in (lvl.A, lvl.P, lvl.R):
                    if m is not None and m.dtype != base:
                        return True
        return False

    def _guardrail_tripped(self, res) -> bool:
        if not self.precision_fallback:
            return False
        if not self._reduced_precision_config():
            return False
        if int(res.status) != SUCCESS:
            return True
        return self.iteration_guard > 0 and int(res.iters) > \
            self.iteration_guard

    def _make_fallback_solver(self):
        """The same config with ``hierarchy_dtype`` SAME in every scope
        that sets it and the guardrail off, set up once on this
        solver's (scaled, renumbered) operator; it shares this solver's
        solve-boundary vectors."""
        from amgx_tpu_torch.config.amg_config import AMGConfig

        cfg2 = AMGConfig.from_state(self.cfg.to_state())
        for (scope, name) in list(cfg2.items()):
            if name == "hierarchy_dtype":
                cfg2.set("hierarchy_dtype", "SAME", scope)
            if name == "precision_fallback":
                cfg2.set("precision_fallback", 0, scope)
        cfg2.set("precision_fallback", 0)
        fb = type(self)(cfg2, self.scope, device=self.device)
        fb.scaling = "NONE"
        fb.reordering = "NONE"
        fb.setup(self.A)
        fb._scale_vecs = self._scale_vecs
        fb._reorder = self._reorder
        return fb

    def _solve_f64_fallback(self, raw_b, raw_x0, zero_guess, t0):
        self.precision_fallbacks += 1
        if self._fallback_solver is None:
            self._fallback_solver = self._make_fallback_solver()
        res = self._fallback_solver.solve(
            raw_b, x0=raw_x0, zero_initial_guess=zero_guess)
        self.last_inner_iters = self._fallback_solver.last_inner_iters
        self.solve_time = time.perf_counter() - t0
        if self.print_solve_stats:
            self._print_stats(res)
        return res
