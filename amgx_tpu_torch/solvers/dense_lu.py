"""Dense LU coarse solver (reference dense_lu_solver.cu: getrf/getrs on
the densified coarse matrix).

Densify at setup on the host, factorize once with
``torch.linalg.lu_factor`` on the solver's device; the apply is
``torch.linalg.lu_solve``, which also takes the serve layer's batches
(factors (B, m, m), r (B, m): ``make_batch_params``).  A bf16 level (``hierarchy_dtype``) is
factored in f32, as the JAX package does (LAPACK has no sub-f32
factorization; its host triple reads back as f32): the apply takes r
to f32 and returns an f32 correction, which the cycle casts back to
the level's dtype.  Zero-pivot guard as in the JAX package: the
host reads the U diagonal of the factorization, and a singular matrix
either raises :class:`SingularDiagonalError` (``dense_lu_zero_pivot=
RAISE``) or switches the apply to the pseudoinverse (REGULARIZE, the
default).  ``save_setup`` stores the factors and pivots (0-based in the
payload, as the JAX package's).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from amgx_tpu_torch.core import faults
from amgx_tpu_torch.core.errors import SingularDiagonalError
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import register_solver


def _bad_pivots(lu) -> bool:
    """Host check of the factorization's U diagonal: exact zeros, NaNs,
    or pivots tiny enough that back-substitution overflows."""
    lu = lu.cpu().numpy()
    d = np.abs(np.diag(lu))
    if d.size == 0:
        return False
    if not np.all(np.isfinite(lu)):
        return True
    dmax = float(d.max())
    if dmax == 0.0:
        return True
    tiny = np.finfo(d.dtype).eps * d.shape[0] * dmax
    return bool(np.any(d <= tiny))


def _per_instance(batch, fn):
    """``fn`` on each instance of a batch (a tensor, or a tuple of
    tensors with a leading batch dimension), its outputs stacked.  The
    serve layer's CPU batches take LAPACK one matrix at a time: the
    batched CPU factorization of the card machine's torch (its oneMKL
    build) fails in DLASWP ("Parameter 6 was incorrect") and hangs in a
    spawned process, where a single matrix does not."""
    n = (batch[0] if isinstance(batch, tuple) else batch).shape[0]
    outs = [fn(tuple(t[i] for t in batch) if isinstance(batch, tuple)
               else batch[i]) for i in range(n)]
    return tuple(torch.stack(o) for o in zip(*outs))


@register_solver("DENSE_LU_SOLVER")
class DenseLUSolver(Solver):
    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.zero_pivot_policy = str(
            cfg.get("dense_lu_zero_pivot", scope)
        ).upper()
        self._pinv_mode = False

    def _setup_impl(self, A):
        dense = np.asarray(A.to_dense())
        if faults.should_fire("coarse_lu_zero_pivot"):
            # injected singularity: the last row and column zeroed, so
            # the factorization meets an exact zero pivot
            dense = dense.copy()
            dense[-1, :] = 0.0
            dense[:, -1] = 0.0
        self._pinv_mode = False
        # the _ex form: lu_factor itself raises on an exact zero pivot,
        # before the policy below can choose between RAISE and REGULARIZE
        lu, piv, _ = torch.linalg.lu_factor_ex(
            torch.from_numpy(dense).to(self.device)
        )
        if _bad_pivots(lu):
            if self.zero_pivot_policy == "RAISE":
                raise SingularDiagonalError(
                    f"DENSE_LU: singular coarse matrix "
                    f"({A.n_rows} rows): zero/tiny pivot in LU"
                )
            warnings.warn(
                f"DENSE_LU: singular coarse matrix ({A.n_rows} rows); "
                "switching to pseudoinverse coarse solve "
                "(dense_lu_zero_pivot=REGULARIZE)"
            )
            self._pinv_mode = True
            pinv = np.linalg.pinv(dense)
            if not np.all(np.isfinite(pinv)):
                raise SingularDiagonalError(
                    f"DENSE_LU: pseudoinverse of the coarse matrix "
                    f"({A.n_rows} rows) is non-finite"
                )
            self._params = (A, torch.from_numpy(pinv).to(self.device), piv)
            return
        self._params = (A, lu, piv)

    # the factors are this solver's setup: a restore skips the O(n^3)
    # factorization.  The payload holds LAPACK's pivots 0-based, as the
    # JAX package's ``lu_factor`` gives them; torch's are 1-based

    def _export_impl(self):
        _, fac, piv = self._params
        return {"fac": fac, "piv": piv - 1, "pinv": bool(self._pinv_mode)}

    def _import_impl(self, impl):
        if not impl or impl.get("fac") is None:
            return self._setup_impl(self.A)
        self._pinv_mode = bool(impl.get("pinv"))
        piv = torch.as_tensor(impl["piv"]).to(self.device)
        self._params = (self.A, torch.as_tensor(impl["fac"]).to(self.device),
                        (piv + 1).to(torch.int32))

    def make_batch_params(self):
        """Batched views of the coarse operator and a batched
        ``torch.linalg.lu_factor`` of each instance's dense matrix (B, m,
        m), in f32 for a bf16 level as at setup; None in pseudoinverse
        mode (the plain LU just failed there) and for block matrices, as
        in the JAX package."""
        if self._pinv_mode:
            return None
        A0 = self._params[0]
        if A0.block_size != 1:
            return None

        def fn(t, v):
            A = t.replace_values_batched(v)
            if A.has_dense:
                dense = A.dense
            else:
                B, n = A.batch, A.n_rows
                flat = A.row_ids.long() * A.n_cols + A.col_indices.long()
                dense = torch.zeros(
                    (B, n * A.n_cols), dtype=A.dtype, device=A.device
                ).index_add_(1, flat, A.values).reshape(B, n, A.n_cols)
            if dense.element_size() < 4:
                dense = dense.to(torch.float32)
            if dense.device.type == "cpu":
                lu, piv = _per_instance(dense, lambda d: (
                    torch.linalg.lu_factor_ex(d)[:2]))
            else:
                lu, piv, _ = torch.linalg.lu_factor_ex(dense)
            return A, lu, piv

        return A0, fn

    def make_apply(self):
        if self._pinv_mode:
            def apply_pinv(params, r):
                _, pinv, _ = params
                return torch.matmul(pinv, r.to(pinv.dtype))

            return apply_pinv

        def apply(params, r):
            _, lu, piv = params
            rhs = r.to(lu.dtype).unsqueeze(-1)
            if lu.dim() == 3 and lu.device.type == "cpu":
                return _per_instance(
                    (lu, piv, rhs),
                    lambda f: (torch.linalg.lu_solve(*f),))[0].squeeze(-1)
            return torch.linalg.lu_solve(lu, piv, rhs).squeeze(-1)

        return apply

    def make_smooth(self):
        apply = self.make_apply()

        def smooth(params, b, x, sweeps):
            # direct solve: the result does not depend on x or sweeps
            return apply(params, b)

        return smooth

    def make_solve(self):
        apply = self.make_apply()

        def solve(params, b, x0):
            return self._fixed_result(apply(params, b), b, 1)

        return solve


@register_solver("DENSE_LU")
class DenseLUAlias(DenseLUSolver):
    pass
