"""Gauss-Seidel smoothers via multicolor sweeps, scalar (reference
gauss_seidel_solver.cu, multicolor_gauss_seidel_solver.cu; the JAX
package's ``solvers/gs.py``).

The reference's GPU GS is colour-parallel too: one kernel per colour
after matrix coloring.  Rows are sliced per colour at setup into
compact ELL slices (``dilu.color_ell_slices``), so for colour c

    x_i <- (1-w) x_i + w * (b_i - sum_{j != i} a_ij x_j) / a_ii,  i in c

is a gather + row sum over the colour's rows only and an
``index_copy_`` of its updates: one sweep touches each stored entry
once.  ``symmetric_GS`` sweeps the colours forward then backward.
"""

from __future__ import annotations

from amgx_tpu_torch.ops.diagonal import reciprocal_np, scalarized
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.core.matrix import to_tensor
from amgx_tpu_torch.solvers.dilu import (
    color_ell_slices,
    colored_rows,
    index_tensor,
)
from amgx_tpu_torch.solvers.registry import register_solver


@register_solver("MULTICOLOR_GS")
class MulticolorGSSolver(Solver):
    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        self.symmetric = bool(cfg.get("symmetric_GS", scope))

    def _setup_impl(self, A):
        A = scalarized(A, "MULTICOLOR_GS")
        _, rows_by_color = colored_rows(A, self.cfg, self.scope)
        self.num_colors = len(rows_by_color)
        slices = color_ell_slices(A.host_csr(), rows_by_color)
        dinv = reciprocal_np(A.diag.cpu().numpy())
        dev = self.device
        # params = (A, per-colour (rows, cols, vals, dinv[rows])): A
        # first so the base monitored loop's residual path keeps working
        self._params = (
            A,
            tuple(
                (
                    index_tensor(rows_c, dev), index_tensor(cols, dev),
                    to_tensor(vals, dev), to_tensor(dinv[rows_c], dev),
                )
                for rows_c, (cols, vals) in zip(rows_by_color, slices)
            ),
        )

    def make_step(self):
        omega = self.relaxation_factor
        order = list(range(self.num_colors))
        if self.symmetric:
            order = order + order[::-1]

        def step(params, b, x):
            x = x.clone()
            for c in order:
                rows_c, cols, vals, dinv_c = params[1][c]
                # row sums include the diagonal term; dinv*(b-ax)+x
                # cancels it: dinv*(b - off - d*x) + x = dinv*(b - off)
                ax_c = (vals * x[cols]).sum(dim=-1)
                x_c = x[rows_c]
                gs = dinv_c * (b[rows_c] - ax_c) + x_c
                x.index_copy_(0, rows_c, (1 - omega) * x_c + omega * gs)
            return x

        return step


@register_solver("GS")
class GSSolver(MulticolorGSSolver):
    """Plain GS maps onto the multicolor implementation (the reference GPU
    path does the same, gauss_seidel_solver.cu)."""


@register_solver("FIXCOLOR_GS")
class FixcolorGSSolver(MulticolorGSSolver):
    """Fixed 2-coloring variant (reference fixcolor_gauss_seidel_solver.cu);
    uses the generic coloring here."""
