"""s-step (communication-avoiding) PCG (the JAX package's
``solvers/sstep.py``: the preconditioned s-step CG of Chronopoulos and
Gear).

``SSTEP_PCG`` advances s conjugate-gradient steps per outer iteration:

1. Z basis: z_0 = M^-1 r, z_{i+1} = M^-1 (A z_i), s SpMVs and s
   preconditioner applies, keeping A z_i.
2. One Gram block G = [Z; P; r] [AZ; AP; r]^H (:func:`gram_block`):
   every inner product the s steps need.
3. Scalar recurrences off G: the new block is A-orthogonalised against
   the previous one (C = -(P^T A P)^-1 P^T A Z), P_new = Z + C P, and
   one block step x += P_new^T a with (P_new^T A P_new) a = P_new^T r.

``sstep_basis`` SCALED (the default) rescales the basis by its A-norms
read off the Gram diagonal; MONOMIAL keeps raw powers.
``sstep_replace_every`` N replaces the recurred residual by b - A x
every N outer iterations.  ``s_step`` 1 is PCG exactly (the init and
iteration are PCG's).

``max_iters`` counts CG steps, as for PCG: the loop runs ceil(max_iters
/ s) outer iterations, ``SolveResult.iters`` counts outer iterations,
and ``iterations_scale`` (= s) converts them to CG steps.  All the small
(s x s) algebra stays on the device; the monitored loop reads one norm
an outer iteration.

A batch of systems (the serve layer's groups) runs the same iteration on
(B, n) vectors: the Krylov block is (B, s, n), the Gram block one
batched product (B, 2s+1, 2s+1), and the guarded s x s solves batched,
each instance's ridge its own; the rebuild is PCG's
(``make_batch_params``).
"""

from __future__ import annotations

import torch

from amgx_tpu_torch.ops.blas import gram_block
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.solvers.krylov import PCGSolver
from amgx_tpu_torch.solvers.registry import register_solver


def _guarded_solve(W, rhs):
    """Solve W x = rhs for a tiny Gram system with a relative ridge:
    near breakdown (W -> 0 as r -> 0) x -> 0, and any non-finite
    result becomes the no-op update.  A batch of systems W (B, s, s)
    takes each instance's own ridge."""
    s = W.shape[-1]
    rdt = W.real.dtype
    diag = torch.abs(torch.diagonal(W, dim1=-2, dim2=-1).real)
    delta = torch.amax(diag, dim=-1, keepdim=True)[..., None] \
        * torch.finfo(rdt).eps * 4.0 + torch.finfo(rdt).tiny
    # solve_ex without its check: a singular W gives the non-finite
    # result the guard turns into zeros (jnp.linalg.solve does not
    # raise either), and nothing reads the info flag back from the card
    sol, _ = torch.linalg.solve_ex(
        W + delta * torch.eye(s, dtype=W.dtype, device=W.device), rhs,
        check_errors=False,
    )
    return torch.where(torch.isfinite(sol), sol, torch.zeros_like(sol))


@register_solver("SSTEP_PCG")
class SStepPCGSolver(PCGSolver):
    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.s = max(int(cfg.get("s_step", scope)), 1)
        self.basis = str(cfg.get("sstep_basis", scope)).upper()
        self.replace_every = max(
            int(cfg.get("sstep_replace_every", scope)), 0
        )
        # max_iters counts CG steps; the monitored loop counts outers
        if self.s > 1:
            self.max_iters = -(-self.max_iters // self.s)

    @property
    def iterations_scale(self) -> int:
        """CG steps per reported iteration (= s)."""
        return self.s

    # extra = (r, P, AP, k): the residual, the previous direction block
    # and its A-image (s, n), zero on entry so that the first
    # A-orthogonalisation is a no-op, and the outer-iteration count

    def _make_init(self):
        if self.s == 1:
            return super()._make_init()
        s = self.s

        def init(params, b, x):
            A, _ = params
            r = b - spmv(A, x)
            # (s, n), or (B, s, n) for a batch
            P = torch.zeros(r.shape[:-1] + (s,) + r.shape[-1:],
                            dtype=r.dtype, device=r.device)
            return (r, P, torch.zeros_like(P), 0)

        return init

    def _make_iter(self):
        if self.s == 1:
            return super()._make_iter()
        M = self._make_M()
        s = self.s
        scaled = self.basis == "SCALED"
        replace_every = self.replace_every

        def iterate(params, b, x, extra):
            # over leading dims: x, r (n) or (B, n), P and AP (s, n) or
            # (B, s, n), one Gram block per instance
            A, Mp = params
            r, Pr, APr, k = extra

            # 1. the s-step Krylov block: s SpMVs, s applies
            z_rows, az_rows = [M(Mp, r)], []
            for _ in range(s - 1):
                az_rows.append(spmv(A, z_rows[-1]))
                z_rows.append(M(Mp, az_rows[-1]))
            az_rows.append(spmv(A, z_rows[-1]))
            Z = torch.stack(z_rows, dim=-2)
            AZ = torch.stack(az_rows, dim=-2)

            # 2. one Gram block: every inner product
            G = gram_block(torch.cat([Z, Pr, r[..., None, :]], dim=-2),
                           torch.cat([AZ, APr, r[..., None, :]], dim=-2))
            if scaled:
                # column-normalise the basis by its A-norms off the
                # Gram diagonal: a rescaling of the small systems
                rdt = G.real.dtype
                d = torch.sqrt(torch.clamp(
                    torch.abs(torch.diagonal(G, dim1=-2,
                                             dim2=-1)[..., :s].real),
                    min=torch.finfo(rdt).tiny,
                ))
                inv = (1.0 / d).to(G.dtype)
                sl = torch.cat([inv, torch.ones(
                    inv.shape[:-1] + (s + 1,), dtype=G.dtype,
                    device=G.device)], dim=-1)
                G = G * sl[..., :, None] * sl[..., None, :]
                Z = Z * inv[..., :, None]
                AZ = AZ * inv[..., :, None]

            G_ZAZ = G[..., :s, :s]            # <z_i, A z_j>
            G_ZAP = G[..., :s, s:2 * s]       # <z_i, A p_j>
            G_Zr = G[..., :s, -1]             # <z_i, r>
            G_PAZ = G[..., s:2 * s, :s]       # <p_i, A z_j>
            W_prev = G[..., s:2 * s, s:2 * s]  # <p_i, A p_j>
            G_Pr = G[..., s:2 * s, -1]        # <p_i, r>

            # 3. scalar recurrences off the Gram block
            C = -_guarded_solve(W_prev, G_PAZ).mT
            P_new = Z + C @ Pr
            AP_new = AZ + C @ APr
            Cc = C.conj()
            # <P_new, A P_new> from the Gram blocks (the G_PAZ + W_prev
            # C^T term is ~0 by construction; keeping it keeps the
            # float cancellation of the JAX package's form)
            W_new = G_ZAZ + G_ZAP @ C.mT + Cc @ (G_PAZ + W_prev @ C.mT)
            g = G_Zr + (Cc @ G_Pr[..., None])[..., 0]  # <P_new_i, r>
            a = _guarded_solve(W_new, g)

            x = x + (a[..., None, :] @ P_new)[..., 0, :]
            r_new = r - (a[..., None, :] @ AP_new)[..., 0, :]
            k += 1
            if replace_every > 0 and k % replace_every == 0:
                # residual replacement: the true residual, one SpMV
                r_new = b - spmv(A, x)
            return x, (r_new, P_new, AP_new, k)

        return iterate
