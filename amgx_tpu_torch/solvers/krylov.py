"""Krylov solvers: PCG, CG, PCGF, PBICGSTAB and BICGSTAB (reference
pcg_solver.cu, cg_solver.cu, pcgf_solver.cu, pbicgstab_solver.cu,
bicgstab_solver.cu).

Each iteration is a function over (params, b, x, extra) with
``extra[0]`` the current residual; scalars (rho, alpha, beta) stay
0-dim tensors on the device, so an iteration syncs with the host only
where the monitored loop reads the residual norm.  The same functions
take a batch of vectors (B, n) with (B, 1) scalars (``ops/blas.py``),
which is how the serve layer's batched solves run them
(``make_batch_params``).  The preconditioner
is the nested solver's ``make_apply`` over ``params[1]``.  NOSOLVER as
preconditioner disables preconditioning (reference
pcg_solver.cu:21-29).
"""

from __future__ import annotations

import torch

from amgx_tpu_torch.core import faults
from amgx_tpu_torch.ops.blas import dot, fused_dots
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import (
    SolverRegistry,
    make_nested,
    register_solver,
)


def resolve_preconditioner(cfg, scope, device):
    """The preconditioner named in config, or None for NOSOLVER."""
    name, pscope = cfg.get_scoped("preconditioner", scope)
    if name == "NOSOLVER":
        return None
    return make_nested(SolverRegistry.get(name)(cfg, pscope, device=device))


class KrylovSolver(Solver):
    uses_preconditioner = True

    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.precond = (
            resolve_preconditioner(cfg, scope, self.device)
            if self.uses_preconditioner
            else None
        )

    def _setup_impl(self, A):
        if self.precond is not None:
            self.precond.setup(A)
            self._params = (A, self.precond.apply_params())
        else:
            self._params = (A, None)

    def _resetup_impl(self, A):
        """Values-only refresh: the preconditioner resetups (falling
        back to its own full setup where it has no values-only path)."""
        if self.precond is not None:
            self.precond.resetup(A)
            self._params = (A, self.precond.apply_params())
        else:
            self._params = (A, None)
        return True

    def _export_impl(self):
        # the preconditioner's setup (an AMG hierarchy) is the costly
        # part: a restored PCG + AMG coarsens nothing
        if self.precond is None:
            return None
        return {"precond": self.precond._export_setup()}

    def _import_impl(self, impl):
        if self.precond is None or not impl \
                or impl.get("precond") is None:
            return self._setup_impl(self.A)
        self.precond._import_setup(impl["precond"])
        self._params = (self.A, self.precond.apply_params())

    def make_batch_params(self):
        """The operator's batched view and the preconditioner's batch
        rebuild (None where the preconditioner has none)."""
        A0 = self._params[0]
        if self.precond is None:
            return A0, lambda t, v: (t.replace_values_batched(v), None)
        sub = self.precond.make_batch_params()
        if sub is None:
            return None
        ptmpl, pfn = sub

        def fn(t, v):
            At, pt = t
            return At.replace_values_batched(v), pfn(pt, v)

        return (A0, ptmpl), fn

    def _make_M(self):
        """fn(Mp, r) -> z; identity when unpreconditioned."""
        if self.precond is None:
            return lambda Mp, r: r
        return self.precond.make_apply()

    def _make_init(self):
        raise NotImplementedError

    def _make_iter(self):
        raise NotImplementedError

    def make_solve(self):
        init = self._make_init()
        iterate = self._make_iter()
        norm_of = self.make_norm()
        monitored = self.monitor_residual

        def solve(params, b, x0):
            extra0 = init(params, b, x0)
            if not monitored:
                x, extra = x0, extra0
                region = faults.loop()
                for _ in range(self.max_iters):
                    with region:
                        x, extra = iterate(params, b, x, extra)
                return self._fixed_result(x, b, self.max_iters)

            def body(x, extra):
                x, extra = iterate(params, b, x, extra)
                return x, extra, norm_of(extra[0])

            return self._monitored_loop(
                norm_of(extra0[0]), body, b, x0, extra0
            )

        return solve

    def make_apply(self):
        """Fixed-iteration zero-guess run (nested-solver usage)."""
        init = self._make_init()
        iterate = self._make_iter()
        iters = max(self.max_iters, 1)

        def apply(params, r):
            x = torch.zeros_like(r)
            extra = init(params, r, x)
            region = faults.loop()
            for _ in range(iters):
                with region:
                    x, extra = iterate(params, r, x, extra)
            return x

        return apply

    def make_smooth(self):
        init = self._make_init()
        iterate = self._make_iter()

        def smooth(params, b, x, sweeps):
            extra = init(params, b, x)
            region = faults.loop()
            for _ in range(sweeps):
                with region:
                    x, extra = iterate(params, b, x, extra)
            return x

        return smooth


@register_solver("PCG")
class PCGSolver(KrylovSolver):
    """Preconditioned conjugate gradient (reference pcg_solver.cu)."""

    def _make_init(self):
        M = self._make_M()

        def init(params, b, x):
            A, Mp = params
            r = b - spmv(A, x)
            z = M(Mp, r)
            return (r, z, dot(r, z))

        return init

    def _make_iter(self):
        M = self._make_M()

        def iterate(params, b, x, extra):
            A, Mp = params
            r, p, rho = extra
            q = spmv(A, p)
            pq = dot(p, q)
            zero = torch.zeros((), dtype=pq.dtype, device=pq.device)
            # exact breakdown (converged mid fixed-iteration run) must
            # be a no-op, not 0/0 = NaN
            alpha = torch.where(pq != 0, rho / pq, zero)
            x = x + alpha * p
            r = r - alpha * q
            z = M(Mp, r)
            rho_new = dot(r, z)
            beta = torch.where(rho != 0, rho_new / rho, zero)
            p = z + beta * p
            return x, (r, p, rho_new)

        return iterate


@register_solver("CG")
class CGSolver(PCGSolver):
    """Unpreconditioned CG (reference cg_solver.cu)."""

    uses_preconditioner = False


def _safe_ratio(num, den):
    """num / den, 0 where den == 0 (a breakdown step is a no-op, not
    0/0 = NaN)."""
    zero = torch.zeros((), dtype=num.dtype, device=num.device)
    return torch.where(
        den != 0, num / torch.where(den != 0, den, torch.ones_like(den)),
        zero,
    )


@register_solver("PCGF")
class PCGFSolver(KrylovSolver):
    """Flexible PCG (reference pcgf_solver.cu): Polak-Ribiere beta
    <z_new, r_new - r_old> / rho tolerates a changing preconditioner."""

    def _make_init(self):
        M = self._make_M()

        def init(params, b, x):
            A, Mp = params
            r = b - spmv(A, x)
            z = M(Mp, r)
            return (r, z, dot(r, z))

        return init

    def _make_iter(self):
        M = self._make_M()

        def iterate(params, b, x, extra):
            A, Mp = params
            r, p, rho = extra
            q = spmv(A, p)
            alpha = _safe_ratio(rho, dot(p, q))
            x = x + alpha * p
            r_new = r - alpha * q
            z = M(Mp, r_new)
            # <r_new, z> and <z, r_new - r> in one stacked reduction
            rho_new, zdr = fused_dots(((r_new, z), (z, r_new - r)))
            beta = _safe_ratio(zdr, rho)
            p = z + beta * p
            return x, (r_new, p, rho_new)

        return iterate


@register_solver("PBICGSTAB")
class PBiCGStabSolver(KrylovSolver):
    """Preconditioned BiCGStab (reference pbicgstab_solver.cu)."""

    def _make_init(self):
        def init(params, b, x):
            A, _ = params
            r = b - spmv(A, x)
            one = torch.ones((), dtype=r.dtype, device=r.device)
            zeros = torch.zeros_like(r)
            # (r, r0hat, p, v, rho, alpha, omega)
            return (r, r, zeros, zeros, one, one, one)

        return init

    def _make_iter(self):
        M = self._make_M()

        def iterate(params, b, x, extra):
            A, Mp = params
            r, r0, p, v, rho, alpha, omega = extra
            rho1 = dot(r0, r)
            # guard each factor separately: the product rho*omega can
            # underflow while both ratios remain well-defined
            ok = (rho != 0) & (omega != 0)
            zero = torch.zeros((), dtype=r.dtype, device=r.device)
            beta = torch.where(
                ok, _safe_ratio(rho1, rho) * _safe_ratio(alpha, omega), zero
            )
            p = r + beta * (p - omega * v)
            phat = M(Mp, p)
            v = spmv(A, phat)
            alpha = _safe_ratio(rho1, dot(r0, v))
            s = r - alpha * v
            shat = M(Mp, s)
            t = spmv(A, shat)
            # <t, t> and <t, s> share t: one stacked reduction
            tt, ts = fused_dots(((t, t), (t, s)))
            omega = _safe_ratio(ts, tt)
            x = x + alpha * phat + omega * shat
            r = s - omega * t
            return x, (r, r0, p, v, rho1, alpha, omega)

        return iterate


@register_solver("BICGSTAB")
class BiCGStabSolver(PBiCGStabSolver):
    """Unpreconditioned BiCGStab (reference bicgstab_solver.cu)."""

    uses_preconditioner = False
