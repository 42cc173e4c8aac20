"""IDR(s), induced dimension reduction (reference idr_solver.cu,
idrmsync_solver.cu; the JAX package's ``solvers/idr.py``, the van
Gijzen-Sonneveld biorthogonal variant).

One iteration is one outer cycle: s dimension-reduction steps (each an
s x s lower-triangular solve, a preconditioner apply, one SpMV and a
modified Gram-Schmidt pass against the earlier steps), then the omega
step (one apply, one SpMV): s + 1 SpMVs an iteration.  The shadow space
P (s rows) is the JAX package's: the Q of a QR of an (n, s) standard
normal matrix from ``default_rng(42)``, built once per setup.  The
small solves, dots and updates stay on the device; the monitored loop
reads the residual norm once per outer cycle.  IDRMSYNC differs from
IDR only in how the reference synchronises on the GPU, so it aliases.
"""

from __future__ import annotations

import numpy as np
import torch

from amgx_tpu_torch.core import faults
from amgx_tpu_torch.core.matrix import to_tensor
from amgx_tpu_torch.ops.blas import dot
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.solvers.krylov import KrylovSolver
from amgx_tpu_torch.solvers.registry import register_solver


def shadow_space(n, s, dtype, device):
    """The (s, n) orthonormal shadow space of the JAX package's IDR."""
    rng = np.random.default_rng(42)
    q, _ = np.linalg.qr(rng.standard_normal((n, s)))
    np_dt = np.dtype(str(dtype).replace("torch.", ""))
    return to_tensor(q.T.astype(np_dt), device)


def _nonzero_or_one(t):
    return torch.where(t != 0, t, torch.ones_like(t))


@register_solver("IDR")
class IDRSolver(KrylovSolver):
    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.s = int(cfg.get("subspace_dim_s", scope))

    def _setup_impl(self, A):
        super()._setup_impl(A)
        # the shadow space cannot exceed the system size
        n = A.n_rows * A.block_size
        s = min(self.s, n)
        self._shadow = shadow_space(n, s, A.dtype, A.device)

    def _import_impl(self, impl):
        super()._import_impl(impl)
        A = self.A
        n = A.n_rows * A.block_size
        self._shadow = shadow_space(n, min(self.s, n), A.dtype, A.device)

    def _make_cycle(self):
        """fn(params, x, state) -> (x, state): one outer cycle, with
        state = (r, G, U, Mm, om)."""
        M = self._make_M()
        P = self._shadow
        s = P.shape[0]
        Pc = P.conj() if P.is_complex() else P

        def cycle(params, x, state):
            A, Mp = params
            r, G, U, Mm, om = state
            f = Pc @ r
            for k in range(s):
                Mkk = Mm[k:, k:]
                # guard exact-zero pivots (the residual hit zero mid
                # cycle: f is zero there, so the unit pivot is inert)
                dsafe = (torch.diagonal(Mkk) == 0).to(Mm.dtype)
                ck = torch.linalg.solve_triangular(
                    Mkk + torch.diag(dsafe), f[k:].unsqueeze(1),
                    upper=False,
                ).squeeze(1)
                v = M(Mp, r - ck @ G[k:])
                u = om * v + ck @ U[k:]
                g = spmv(A, u)
                for i in range(k):
                    alpha = dot(P[i], g) / _nonzero_or_one(Mm[i, i])
                    g = g - alpha * G[i]
                    u = u - alpha * U[i]
                Mm[k:, k] = Pc[k:] @ g
                beta = f[k] / _nonzero_or_one(Mm[k, k])
                r = r - beta * g
                x = x + beta * u
                f[k:] -= beta * Mm[k:, k]
                G[k] = g
                U[k] = u
            # dimension reduction step
            v = M(Mp, r)
            t = spmv(A, v)
            tt = dot(t, t)
            om = torch.where(tt.real > 0, dot(t, r) / _nonzero_or_one(tt),
                             om)
            return x + om * v, (r - om * t, G, U, Mm, om)

        return cycle

    def _init_state(self, params, b, x0):
        A, _ = params
        s, n = self._shadow.shape
        r = b - spmv(A, x0)
        G = torch.zeros((s, n), dtype=b.dtype, device=b.device)
        Mm = torch.eye(s, dtype=b.dtype, device=b.device)
        om = torch.ones((), dtype=b.dtype, device=b.device)
        return (r, G, torch.zeros_like(G), Mm, om)

    def make_solve(self):
        cycle = self._make_cycle()
        norm_of = self.make_norm()
        if not self.monitor_residual:
            run = self._make_run()

            def solve_plain(params, b, x0):
                return self._fixed_result(run(params, b, x0, self.max_iters),
                                          b, self.max_iters)

            return solve_plain

        def solve(params, b, x0):
            state0 = self._init_state(params, b, x0)

            def body(x, state):
                x, state = cycle(params, x, state)
                return x, state, norm_of(state[0])

            return self._monitored_loop(norm_of(state0[0]), body, b, x0,
                                        state0)

        return solve

    def _make_run(self):
        """fn(params, b, x, cycles) -> x: unmonitored outer cycles."""
        cycle = self._make_cycle()

        def run(params, b, x, cycles):
            state = self._init_state(params, b, x)
            region = faults.loop()
            for _ in range(cycles):
                with region:
                    x, state = cycle(params, x, state)
            return x

        return run

    def make_apply(self):
        run = self._make_run()
        iters = max(self.max_iters, 1)
        return lambda params, r: run(params, r, torch.zeros_like(r), iters)

    def make_smooth(self):
        return self._make_run()


@register_solver("IDRMSYNC")
class IDRMSyncSolver(IDRSolver):
    """Reduced-synchronisation IDR(s) (reference idrmsync_solver.cu):
    the same arithmetic."""
