"""AMG solver: hierarchy setup, cycles and the registered "AMG" solver
(reference src/amg.cu setup loop :201-418, src/cycles/).

Counterpart of the JAX package's ``amg/hierarchy.py``.  Setup is the
same loop: coarsen level by level until a stop condition hits
(``_coarsen_from``), then ship the levels to the device, set up a
smoother per level and the coarse solver on the last.  A coarse level
is built as the JAX package builds it (``_build_coarse``): AGGREGATION
and ENERGYMIN with numpy/scipy on the host, CLASSICAL on the host or
with torch ops on the solver's device (``amg/device_setup.py``) by
``setup_location``.  The cycle is a Python recursion over the levels,
run eagerly; its SpMVs go through ``ops/spmv.py`` (stencil, DIA and ELL
kernels on the card).

Cycles V, W, F and the K-cycles CG and CGF are ported, and
``matrix_free`` with ``fused_cycle``: under ``matrix_free=1`` every
square operator (the finest one rebuilt from its host CSR, each coarse
one as it is formed) takes the MATRIX_FREE format where stencil
detection verifies it, and ``fused_cycle=1`` runs the descent leg of
each such level through ``ops/stencil.py:fused_cycle_leg``: the same
launches, counted as one operator pass.  On aggregation levels
``error_scaling`` 2-5 scales each coarse correction by a lambda kept on
the device (no host read per level).

``structure_reuse_levels`` != 0 plans each Galerkin product at setup
(``amg/spgemm.py``, under the ``rap_plan`` setup phase); ``resetup``
then refills the finest operator with ``replace_values`` and re-forms
the coarse operators on the device from the plans (``rap_execute``)
down to that depth (-1: every level), re-coarsens any tail below it
from the host CSR, resetups the surviving smoothers (CHEBYSHEV keeps its
cached bounds) and rebuilds the coarse solver.  Not ported yet, and
raising ``NotImplementedError`` when a config asks for it (ROADMAP.md,
queue A): ``hierarchy_dtype``; the setup store has no entry point.

:func:`hierarchy_from_numpy` builds a solver on a given hierarchy
(per-level CSR arrays of A, P and R) without coarsening — the way the
tests carry a hierarchy set up by the JAX package across.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.core.profiling import setup_phase, setup_profile_scope
from amgx_tpu_torch.ops.blas import dot
from amgx_tpu_torch.ops.spmv import op_pass_counter, spmv
from amgx_tpu_torch.ops.stencil import fused_cycle_leg
from amgx_tpu_torch.solvers.base import Solver
from amgx_tpu_torch.solvers.registry import (
    SolverRegistry,
    create_solver,
    make_nested,
    register_solver,
)

# gamma-cycle branch-depth cap (the JAX package's W_MAX_BRANCH_LEVELS):
# W, F and the K-cycles branch only on the levels above it
W_MAX_BRANCH_LEVELS = 6


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md, queue A: {item})"
    )


class AMGLevel:
    """One hierarchy level (reference AMG_Level, amg_level.h:50)."""

    def __init__(self, A: SparseMatrix, level_id: int):
        self.A = A
        self.level_id = level_id
        self.P: SparseMatrix | None = None
        self.R: SparseMatrix | None = None
        self.smoother: Solver | None = None
        # numeric Galerkin plan R A P -> the next level's A
        # (structure_reuse_levels), or None
        self.rap_plan = None

    @property
    def n_rows(self):
        return self.A.n_rows

    @property
    def nnz(self):
        return self.A.nnz


@register_solver("AMG")
class AMGSolver(Solver):
    """Algebraic multigrid as a Solver (reference
    algebraic_multigrid_solver.cu + AMG<> in amg.cu)."""

    def __init__(self, cfg, scope="default", device="cuda"):
        super().__init__(cfg, scope, device=device)
        g = lambda k: cfg.get(k, scope)
        self.algorithm = str(g("algorithm")).upper()
        self.cycle_type = str(g("cycle")).upper()
        self.max_levels = int(g("max_levels"))
        self.min_coarse_rows = int(g("min_coarse_rows"))
        self.min_fine_rows = int(g("min_fine_rows"))
        self.presweeps = int(g("presweeps"))
        self.postsweeps = int(g("postsweeps"))
        self.finest_sweeps = int(g("finest_sweeps"))
        self.coarsest_sweeps = int(g("coarsest_sweeps"))
        self.cycle_iters = int(g("cycle_iters"))
        self.dense_lu_num_rows = int(g("dense_lu_num_rows"))
        self.dense_lu_max_rows = int(g("dense_lu_max_rows"))
        self.print_grid_stats = bool(g("print_grid_stats"))
        self.intensive_smoothing = bool(g("intensive_smoothing"))
        self.coarsen_threshold = float(g("coarsen_threshold"))
        # scaled coarse correction (reference
        # aggregation_amg_level.cu:696-805): 2/4 lambda = (r, Ae)/(Ae, Ae),
        # 3/5 lambda = (r, e)/(e, Ae); 4/5 also smooth e (Vanek).
        # Aggregation levels only, as in the reference
        self.error_scaling = (
            int(g("error_scaling"))
            if self.algorithm == "AGGREGATION" else 0
        )
        self.scaling_smoother_steps = int(g("scaling_smoother_steps"))
        # 0: resetup rebuilds everything; k > 0: the top k Galerkin
        # products re-form on the device from plans; < 0: every level
        self.structure_reuse = int(g("structure_reuse_levels"))
        self.matrix_free = bool(g("matrix_free"))
        self.fused_cycle = bool(g("fused_cycle"))
        self.hierarchy_dtype = str(g("hierarchy_dtype")).upper()
        if self.intensive_smoothing:
            self.presweeps = max(self.presweeps, 4)
            self.postsweeps = max(self.postsweeps, 4)
            self.coarsest_sweeps = max(self.coarsest_sweeps, 8)
        self.levels: list[AMGLevel] = []
        self.coarse_solver: Solver | None = None
        # per-level (A, P, R) given by hierarchy_from_numpy; consumed
        # by the next setup in place of coarsening
        self._given_levels = None
        # setup-phase seconds (core/profiling.py) and, where the
        # classical device pipeline ran, its host_s / device_s / syncs
        # (and jax_syncs, the JAX package's tally of those reads)
        self.setup_profile: dict = {}
        # coarsen_calls and levels_built as in the JAX package;
        # device_levels counts the classical levels the device pipeline
        # built, host_fallback_levels those it handed to the host
        # builder on DeviceSetupOverflow
        self.setup_stats: dict = {}

    def _check_unported(self):
        super()._check_unported()
        if self.hierarchy_dtype != "SAME":
            raise _unported(f"hierarchy_dtype={self.hierarchy_dtype}",
                            "block matrices and reduced precision")

    # ------------------------------------------------------------------
    # setup (reference AMG_Setup::setup, amg.cu:147-418)

    def _build_coarse(self, Asp, level_id: int):
        if self.algorithm == "AGGREGATION":
            from amgx_tpu_torch.amg.aggregation import (
                build_aggregation_level,
            )

            return build_aggregation_level(Asp, self.cfg, self.scope)
        if self.algorithm == "ENERGYMIN":
            from amgx_tpu_torch.amg.energymin import build_energymin_level

            return build_energymin_level(Asp, self.cfg, self.scope)
        from amgx_tpu_torch.amg import device_setup
        from amgx_tpu_torch.amg.classical import build_classical_level

        # AUTO: the device pipeline on the card, the host builder on
        # the CPU (the JAX package's rule, keyed on the solver's device)
        loc = str(self.cfg.get("setup_location", self.scope)).upper()
        explicit_device = loc == "DEVICE"
        if loc == "AUTO":
            loc = "DEVICE" if self.device.type == "cuda" else "HOST"
        if loc != "HOST":
            if device_setup.device_setup_eligible(self.cfg, self.scope,
                                                  level_id):
                try:
                    out = device_setup.build_classical_level_device(
                        Asp, self.cfg, self.scope, level_id,
                        profile=self.setup_profile, device=self.device,
                    )
                except device_setup.DeviceSetupOverflow as e:
                    # only the int32 addressing limit falls back: any
                    # other error (a launch failure, an illegal access)
                    # is a fault of the device pipeline and raises
                    warnings.warn(
                        f"device setup level {level_id}: "
                        f"{type(e).__name__}: {e}; falling back to "
                        "the host builder"
                    )
                    self.setup_stats["host_fallback_levels"] += 1
                else:
                    self.setup_stats["device_levels"] += 1
                    return out
            elif explicit_device:
                warnings.warn(
                    "setup_location=DEVICE but the config is not "
                    "covered by the device pipeline; using HOST"
                )
        return build_classical_level(Asp, self.cfg, self.scope, level_id)

    def _make_smoother(self, A: SparseMatrix) -> Solver:
        name, sscope = self.cfg.get_scoped("smoother", self.scope)
        sm = make_nested(
            SolverRegistry.get(name)(self.cfg, sscope, device=self.device)
        )
        sm.setup(A)
        return sm

    def _make_coarse_solver(self, A: SparseMatrix):
        """Coarse solver for the coarsest operator, or None (NOSOLVER /
        dense size gate: the coarsest level then smooths)."""
        name, cscope = self.cfg.get_scoped("coarse_solver", self.scope)
        if name == "NOSOLVER":
            return None
        if name in ("DENSE_LU_SOLVER", "DENSE_LU"):
            # reference amg.cu:211: the max-rows cap applies only when
            # dense_lu_max_rows != 0
            if 0 < self.dense_lu_max_rows < A.n_rows:
                return None
        cs = make_nested(
            SolverRegistry.get(name)(self.cfg, cscope, device=self.device)
        )
        from amgx_tpu_torch.solvers.inexact import InexactCoarseSolver

        if isinstance(cs, InexactCoarseSolver):
            # the inexact sweep budget is linked to the cycle depth
            cs.cycle_depth = len(self.levels)
        cs.setup(A)
        return cs

    def _accel_formats(self):
        """Formats hierarchy operators build with: ``matrix_free``
        puts the MATRIX_FREE format first (each format still behind its
        own gate, so non-stencil operators build as before)."""
        if self.matrix_free:
            return ("matrix_free", "dia", "dense", "ell")
        return ("dia", "dense", "ell")

    def _maybe_matrix_free(self, A: SparseMatrix) -> SparseMatrix:
        """The finest operator rebuilt from its host CSR triple with
        the MATRIX_FREE format, on the same device, when the knob is on
        and detection succeeds; ``A`` itself otherwise."""
        if not self.matrix_free or not A.is_square or A.has_matrix_free:
            return A
        ro, ci, v = A._host
        new = SparseMatrix.from_csr(
            ro, ci, v, n_cols=A.n_cols,
            accel_formats=self._accel_formats(), validate=False,
            device=A.device,
        )
        return new if new.has_matrix_free else A

    def _setup_impl(self, A: SparseMatrix):
        from amgx_tpu_torch.ops.diagonal import scalarized

        A = self._maybe_matrix_free(scalarized(A, "AMG"))
        given, self._given_levels = self._given_levels, None
        self.setup_profile = {}
        self.setup_stats = {"coarsen_calls": 0, "levels_built": 0,
                            "device_levels": 0, "host_fallback_levels": 0}
        with setup_profile_scope(self.setup_profile):
            if given is not None:
                self._adopt_levels(A, given)
            else:
                self.levels = [AMGLevel(A, 0)]
                self._coarsen_from(A.host_csr())
            self._finalize_setup()

    def _coarsen_from(self, Asp):
        """Extend ``self.levels`` by coarsening from the last level
        (whose host CSR is ``Asp``) until a stop condition hits.  The
        JAX package's coarse RCM renumbering runs only on TPU backends
        and has no counterpart here."""
        self.setup_stats["coarsen_calls"] += 1
        coarse_name, _ = self.cfg.get_scoped("coarse_solver", self.scope)
        stop_rows = self.min_coarse_rows
        if coarse_name in ("DENSE_LU_SOLVER", "DENSE_LU"):
            # reference amg.cu:207-230: with a dense-LU coarse solver,
            # coarsening stops once the level fits the dense trigger
            stop_rows = max(stop_rows, self.dense_lu_num_rows)
        while True:
            lvl = self.levels[-1]
            n = lvl.n_rows
            if (
                len(self.levels) >= self.max_levels
                or n <= stop_rows
                or n <= self.min_fine_rows
            ):
                break
            P, R, Ac = self._build_coarse(Asp, lvl.level_id)
            nc = Ac.shape[0]
            # stall: empty, non-shrinking, or shrinking slower than
            # coarsen_threshold allows (reference amg.cu:365-370)
            if nc >= n or nc == 0 or nc > self.coarsen_threshold * n:
                break
            dtype = Asp.dtype
            lvl.P = SparseMatrix.from_scipy(
                P.astype(dtype, copy=False), device=self.device
            )
            lvl.R = SparseMatrix.from_scipy(
                R.astype(dtype, copy=False), device=self.device
            )
            Ac = Ac.astype(dtype, copy=False)
            self.levels.append(
                AMGLevel(
                    # Galerkin products of constant stencils on
                    # divisible grids stay constant stencils; each level
                    # is verified on its own
                    SparseMatrix.from_scipy(
                        Ac, device=self.device,
                        accel_formats=self._accel_formats(),
                    ),
                    len(self.levels),
                )
            )
            if self.structure_reuse != 0:
                with setup_phase("rap_plan"):
                    lvl.rap_plan = self._try_plan_rap(
                        lvl.R.host_csr(), Asp, lvl.P.host_csr(),
                        self.levels[-1].A.host_csr(), self.device)
            self.setup_stats["levels_built"] += 1
            Asp = Ac

    @staticmethod
    def _try_plan_rap(R, Asp, P, Ac, device):
        """The numeric Galerkin plan of ``R Asp P`` into ``Ac``'s
        pattern, or None where that pattern does not cover the product
        (the JAX package's ``_try_plan_rap``).  The host CSR of the
        uploaded R, P and Ac give the plan the value order their device
        tensors hold."""
        from amgx_tpu_torch.amg.spgemm import plan_rap

        try:
            return plan_rap(R, Asp, P, Ac, device=device)
        except ValueError:
            return None

    def _adopt_levels(self, A, given):
        """Levels from :func:`hierarchy_from_numpy`: the finest operator
        is ``A``; P, R and the coarse operators are the given ones."""
        if given[0]["A"].shape != A.shape:
            raise ValueError(
                f"hierarchy finest operator {given[0]['A'].shape} does "
                f"not match the setup matrix {A.shape}"
            )
        self.levels = [AMGLevel(A, 0)]
        for i, lv in enumerate(given[:-1]):
            self.levels[-1].P = lv["P"]
            self.levels[-1].R = lv["R"]
            self.levels.append(AMGLevel(given[i + 1]["A"], i + 1))

    def _refresh_smoother(self, lvl: AMGLevel):
        """A level's smoother: a new one on a new level, a resetup of
        the one a values-only resetup kept (so CHEBYSHEV keeps its
        cached spectral bounds)."""
        if lvl.smoother is None:
            lvl.smoother = self._make_smoother(lvl.A)
        else:
            lvl.smoother.resetup(lvl.A)

    def _finalize_setup(self):
        for lvl in self.levels[:-1]:
            self._refresh_smoother(lvl)
        coarsest = self.levels[-1]
        # the coarse solver is rebuilt (DENSE_LU factors anew)
        self.coarse_solver = self._make_coarse_solver(coarsest.A)
        if self.coarse_solver is None:
            # coarsest-level smoothing fallback (coarse_solver=NOSOLVER)
            self._refresh_smoother(coarsest)
        else:
            coarsest.smoother = None
        self._params = self._collect_params()
        if self.print_grid_stats and self.verbosity > 2:
            print(self.grid_stats())

    def _resetup_impl(self, A: SparseMatrix) -> bool:
        """Values-only refresh (the JAX package's ``_resetup_impl``,
        reference ``structure_reuse_levels``): the finest operator takes
        the new values, the coarse operators re-form on the device from
        the stored plans down to the reuse depth, a tail no plan reaches
        is re-coarsened from the host CSR, then smoothers and the coarse
        solver refresh.  The transfers P and R of the planned levels stay
        as set up.  False (a full setup) without reuse or for another
        matrix size."""
        from amgx_tpu_torch.ops.diagonal import scalarized

        if self.structure_reuse == 0 or not self.levels:
            return False
        A = scalarized(A, "AMG")
        lvl0 = self.levels[0]
        if A.n_rows != lvl0.A.n_rows or A.nnz != lvl0.A.nnz:
            return False
        self.setup_profile = {}
        self.setup_stats = {"coarsen_calls": 0, "levels_built": 0,
                            "device_levels": 0, "host_fallback_levels": 0}
        with setup_profile_scope(self.setup_profile):
            lvl0.A = lvl0.A.replace_values(A.values)
            depth = len(self.levels) - 1
            if self.structure_reuse > 0:
                depth = min(self.structure_reuse, depth)
            i = 0
            with setup_phase("rap_execute"):
                while i < depth and self.levels[i].rap_plan is not None:
                    lvl = self.levels[i]
                    nxt = self.levels[i + 1]
                    nxt.A = nxt.A.replace_values(lvl.rap_plan.apply(
                        lvl.R.values, lvl.A.values, lvl.P.values))
                    i += 1
            if i < len(self.levels) - 1:
                # the tail no plan refreshes: re-coarsen from level i
                del self.levels[i + 1:]
                self.levels[i].P = self.levels[i].R = None
                self.levels[i].rap_plan = None
                self._coarsen_from(self.levels[i].A.host_csr())
            self._finalize_setup()
        return True

    def _collect_params(self):
        per_level = tuple(
            (
                lvl.A,
                lvl.P,
                lvl.R,
                lvl.smoother.apply_params() if lvl.smoother else None,
            )
            for lvl in self.levels
        )
        coarse = (
            self.coarse_solver.apply_params() if self.coarse_solver else None
        )
        return (per_level, coarse)

    # ------------------------------------------------------------------
    # cycles (reference fixed_cycle.cu FixedCycle::cycle)

    def _level_sweeps(self, lvl_id):
        pre, post = self.presweeps, self.postsweeps
        if lvl_id == 0 and self.finest_sweeps >= 0:
            # reference fixed_cycle.cu:197-201: finest_sweeps overrides
            # both sweep counts on the finest level
            pre = 0 if pre == 0 else self.finest_sweeps
            post = 0 if post == 0 else self.finest_sweeps
        return pre, post

    def make_cycle(self):
        """fn(params, b, x) -> x : one multigrid cycle (V, W, F, CG or
        CGF).  W, F and the K-cycles branch only on the top
        ``W_MAX_BRANCH_LEVELS`` levels, as in the JAX package; below
        them every cycle is a V-cycle."""
        n_levels = len(self.levels)
        # fused descent legs: static per level, MATRIX_FREE operators
        # only (as in the JAX package)
        fused_lvls = [
            self.fused_cycle and lvl.A.has_matrix_free
            for lvl in self.levels
        ]
        smooth_fns = [
            lvl.smoother.make_smooth() if lvl.smoother else None
            for lvl in self.levels
        ]
        coarse_apply = (
            self.coarse_solver.make_apply() if self.coarse_solver else None
        )
        cycle_type = self.cycle_type
        error_scaling = self.error_scaling
        scaling_steps = max(self.scaling_smoother_steps, 0)
        vanek_steps = max(self.postsweeps, 1)
        cycle_iters = self.cycle_iters

        def scaled_correction(A, smooth_fn, smp, b, x, r, e):
            """x + lambda e with the ``error_scaling`` lambda (the JAX
            package's ``_scaled_correction``); lambda stays a 0-dim
            tensor on the device, 1 where its denominator is 0."""
            if error_scaling > 3 and smooth_fn is not None:
                # Vanek: smooth e against rhs 0 and x against b, then
                # refresh the residual
                e = smooth_fn(smp, torch.zeros_like(e), e, vanek_steps)
                x = smooth_fn(smp, b, x, vanek_steps)
                r = b - spmv(A, x)
            elif scaling_steps > 0 and smooth_fn is not None:
                e = smooth_fn(smp, r, e, scaling_steps)
            Ae = spmv(A, e)
            if error_scaling in (2, 4):
                num, den = dot(r, Ae), dot(Ae, Ae)
            else:  # 3, 5
                num, den = dot(r, e), dot(e, Ae)
            nz = den != 0
            lam = torch.where(nz, num / torch.where(nz, den, 1.0), 1.0)
            return x + lam * e

        def kcycle_solve(params, b, lvl_id):
            """K-cycle (reference cycles/cg_[flex_]cycle.cu, Notay):
            ``cycle_iters`` (F)CG iterations on level ``lvl_id``,
            preconditioned by the cycle from that level; the scalars stay
            on the device."""
            A = params[0][lvl_id][0]
            flexible = cycle_type == "CGF"
            x = torch.zeros_like(b)
            r = b
            z = visit(params, r, torch.zeros_like(r), lvl_id, cycle_type)
            p = z
            rho = dot(r, z)
            for j in range(cycle_iters):
                q = spmv(A, p)
                pq = dot(p, q)
                alpha = torch.where(pq != 0, rho / pq, 0.0)
                x = x + alpha * p
                r_new = r - alpha * q
                if j + 1 == cycle_iters:
                    break
                z = visit(params, r_new, torch.zeros_like(r_new), lvl_id,
                          cycle_type)
                rho_new = dot(r_new, z)
                safe = torch.where(rho != 0, rho, 1.0)
                if flexible:
                    beta = dot(z, r_new - r) / safe
                else:
                    beta = rho_new / safe
                p = z + beta * p
                r, rho = r_new, rho_new
            return x

        def visit(params, b, x, lvl_id, kind):
            level_params, coarse_params = params
            A, P, R, smp = level_params[lvl_id]
            if lvl_id == n_levels - 1:
                if coarse_apply is not None:
                    # error-correction form (reference launchCoarseSolver)
                    return x + coarse_apply(coarse_params, b - spmv(A, x))
                return smooth_fns[lvl_id](smp, b, x, self.coarsest_sweeps)
            pre, post = self._level_sweeps(lvl_id)
            if fused_lvls[lvl_id]:
                # the unfused sequence below, counted as one pass
                x, r, bc = fused_cycle_leg(
                    A, R, smooth_fns[lvl_id], smp, b, x, pre
                )
            else:
                if pre > 0:
                    x = smooth_fns[lvl_id](smp, b, x, pre)
                r = b - spmv(A, x)
                bc = spmv(R, r)
            xc = torch.zeros(R.n_rows, dtype=bc.dtype, device=bc.device)
            branch = lvl_id < min(n_levels - 2, W_MAX_BRANCH_LEVELS)
            if kind == "W" and branch:
                xc = visit(params, bc, xc, lvl_id + 1, "W")
                xc = visit(params, bc, xc, lvl_id + 1, "W")
            elif kind == "F" and branch:
                xc = visit(params, bc, xc, lvl_id + 1, "F")
                xc = visit(params, bc, xc, lvl_id + 1, "V")
            elif kind in ("CG", "CGF") and branch:
                xc = kcycle_solve(params, bc, lvl_id + 1)
            else:
                xc = visit(params, bc, xc, lvl_id + 1, kind)
            if error_scaling >= 2:
                x = scaled_correction(A, smooth_fns[lvl_id], smp, b, x, r,
                                      spmv(P, xc))
            else:
                x = x + spmv(P, xc)
            if post > 0:
                x = smooth_fns[lvl_id](smp, b, x, post)
            return x

        def cycle(params, b, x):
            return visit(params, b, x, 0, cycle_type)

        return cycle

    # ------------------------------------------------------------------
    # Solver interface: one cycle per iteration (reference
    # AlgebraicMultigrid_Solver::solve_iteration, amg.cu:1102-1117)

    def operator_of(self, params):
        level_params, _ = params
        return level_params[0][0]

    def make_step(self):
        cycle = self.make_cycle()

        def step(params, b, x):
            return cycle(params, b, x)

        return step

    def cycle_passes_per_iteration(self):
        """Square-operator SpMVs one cycle makes, counted by running one
        cycle on zero vectors under ``op_pass_counter`` (the JAX
        package counts the same sites at trace time).  Cached per
        setup."""
        key = "cycle_passes"
        if key not in self._cache:
            A0 = self.levels[0].A
            z = torch.zeros(A0.n_rows, dtype=A0.dtype, device=A0.device)
            with op_pass_counter() as c:
                self.make_cycle()(self.apply_params(), z, z)
            self._cache[key] = c.count
        return self._cache[key]

    def level_summary(self):
        """[(rows, nnz, format), ...] of each level's operator, and the
        formats of its P and R."""
        return [
            {
                "rows": lvl.n_rows,
                "nnz": lvl.nnz,
                "format": lvl.A.format,
                "P": None if lvl.P is None else lvl.P.format,
                "R": None if lvl.R is None else lvl.R.format,
            }
            for lvl in self.levels
        ]

    def grid_stats(self) -> str:
        """Grid statistics table (reference AMG::printGridStatistics)."""
        rows = []
        total_rows = total_nnz = 0
        for lvl in self.levels:
            n, nnz = lvl.n_rows, lvl.nnz
            total_rows += n
            total_nnz += nnz
            sp = nnz / (n * n) if n else 0.0
            rows.append(
                f"         {lvl.level_id:>5}(D)"
                f" {n:>10} {nnz:>12} {sp:>10.3g}  {lvl.A.format}"
            )
        fine = self.levels[0]
        head = (
            "         Number of Levels: %d\n" % len(self.levels)
            + "            LVL         ROWS          NNZ    SPRSTY  FORMAT\n"
            + "         " + "-" * 56
        )
        tail = (
            "         " + "-" * 56 + "\n"
            f"         Grid Complexity: {total_rows / fine.n_rows:.5g}\n"
            f"         Operator Complexity: {total_nnz / fine.nnz:.5g}"
        )
        return "\n".join([head] + rows + [tail])


def hierarchy_from_numpy(levels, cfg, device="cuda", scope="default"):
    """Set up the solver ``cfg`` names on a given AMG hierarchy, without
    coarsening.

    ``levels`` is a list, finest first, of dicts with ``"A"`` and (all
    but the last) ``"P"`` and ``"R"``, each a CSR tuple
    ``(row_offsets, col_indices, values, shape)`` of numpy arrays.  The
    AMG solver is the config's top-level solver or its preconditioner.
    Smoothers and the coarse solver are set up on the given operators
    as a normal setup would.  Every operator builds with the formats a
    normal setup would give it (``AMGSolver._accel_formats``), so under
    ``matrix_free=1`` the stencil levels are MATRIX_FREE.  Returns the
    set-up solver."""
    solver = create_solver(cfg, scope, device=device)
    amg = solver if isinstance(solver, AMGSolver) \
        else getattr(solver, "precond", None)
    if not isinstance(amg, AMGSolver):
        raise ValueError("the config names no AMG solver or preconditioner")

    def mat(t):
        ro, ci, v, shape = t
        return SparseMatrix.from_csr(
            np.asarray(ro), np.asarray(ci), np.asarray(v),
            n_cols=int(shape[1]), device=device,
            accel_formats=amg._accel_formats(),
        )

    given = []
    for i, lv in enumerate(levels):
        given.append({
            "A": mat(lv["A"]),
            "P": mat(lv["P"]) if i + 1 < len(levels) else None,
            "R": mat(lv["R"]) if i + 1 < len(levels) else None,
        })
    amg._given_levels = given
    solver.setup(given[0]["A"])
    return solver
