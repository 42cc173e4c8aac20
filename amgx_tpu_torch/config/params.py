"""Typed parameter registry.

A copy of the JAX package's registry (same names, types, defaults and
allowed values), kept here so the port imports nothing of that package.

Reference parity: the ~138 ``registerParameter<T>`` calls at init
(core.cu:307-520) and the ParameterDescription struct (amg_config.h:107).
Defaults and names are kept identical — the shipped solver JSON configs are
the public contract.  GPU-runtime-only knobs (memory pools, CUDA streams)
are registered for config-file compatibility but ignored by the TPU
runtime; XLA owns memory and scheduling.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ParameterDescription:
    name: str
    type: type
    default: Any
    doc: str = ""
    allowed: Optional[Tuple] = None


_REGISTRY: dict[str, ParameterDescription] = {}


def register(name, type_, default, doc="", allowed=None):
    _REGISTRY[name] = ParameterDescription(name, type_, default, doc, allowed)


S, I, F = str, int, float

# --- global / runtime (core.cu:307-345) -----------------------------------
register("determinism_flag", I, 0, "force deterministic coarsening/coloring")
register("exception_handling", I, 0, "internal exception processing")
register("fine_level_consolidation", I, 0, "consolidate fine level")
register("use_cuda_ipc_consolidation", I, 0, "ignored on TPU")
register("amg_consolidation_flag", I, 0, "AMG level consolidation")
register("matrix_consolidation_lower_threshold", I, 0,
         "avg rows below which partitions merge")
register("matrix_consolidation_upper_threshold", I, 1000,
         "avg rows merged partitions should have")
register("device_mem_pool_size", I, 256 * 1024 * 1024, "ignored on TPU")
register("device_consolidation_pool_size", I, 256 * 1024 * 1024, "ignored")
register("device_mem_pool_max_alloc_size", I, 20 * 1024 * 1024, "ignored")
register("device_alloc_scaling_factor", I, 10, "ignored on TPU")
register("device_alloc_scaling_threshold", I, 16 * 1024, "ignored on TPU")
register("device_mem_pool_size_limit", I, 0, "ignored on TPU")
register("num_streams", I, 0, "ignored on TPU (XLA schedules)")
register("serialize_threads", I, 0, "ignored on TPU")
register("high_priority_stream", I, 0, "ignored on TPU")
register("communicator", S, "MPI", "comm backend; TPU uses ICI collectives",
         ("MPI", "MPI_DIRECT", "ICI"))
register("separation_interior", S, "INTERIOR", "latency-hiding split view")
register("separation_exterior", S, "OWNED", "calc limit view")
register("min_rows_latency_hiding", I, -1, "disable overlap below this")
register("exact_coarse_solve", I, 0, "gather global coarse problem")
register("matrix_halo_exchange", I, 0, "halo exchange depth on lower levels")
register("boundary_coloring", S, "SYNC_COLORS", "ILU boundary coloring")
register("halo_coloring", S, "LAST", "ILU halo coloring")
register("use_sum_stopping_criteria", I, 0, "sum rows across ranks for stop")
register("dist_coarse_sparsify", F, 0.0,
         "communication-reduced coarse grids (TPU distributed path): "
         "drop cross-shard coarse-level Galerkin entries with "
         "|a_ij| < theta*sqrt(|a_ii a_jj|) diagonal-lumped, capping "
         "halo width on coarse levels (stencil sparsification, "
         "arxiv 1512.04629); 0 disables")
register("dist_sparsify_from_level", I, 1,
         "first hierarchy level dist_coarse_sparsify applies to: "
         "spare the strongest-coupled first coarse levels, trim the "
         "deep ones where per-exchange latency dominates")
register("rhs_from_a", I, 0, "reader: synthesize rhs from A")
register("complex_conversion", I, 0, "reader: convert complex system")
register("matrix_writer", S, "matrixmarket", "", ("matrixmarket", "binary"))
register("block_format", S, "ROW_MAJOR", "", ("ROW_MAJOR", "COL_MAJOR"))
register("block_convert", I, 0, "reader: scalar->block conversion")

# --- solver selection (core.cu:596-688 registry names) --------------------
register("solver", S, "AMG", "the solving algorithm")
register("preconditioner", S, "AMG", "the preconditioner algorithm")
register("coarse_solver", S, "DENSE_LU_SOLVER", "coarsest-level solver")
register("smoother", S, "BLOCK_JACOBI", "the smoothing algorithm")
register("smoother_amg_list", S, "BLOCK_JACOBI", "per-level smoother list")
register("fine_smoother", S, "BLOCK_JACOBI", "")
register("coarse_smoother", S, "BLOCK_JACOBI", "")

# --- krylov -----------------------------------------------------------------
register("gmres_n_restart", I, 20, "Krylov vectors in (F)GMRES")
register("gmres_krylov_dim", I, 0, "max Krylov dim (0: match restart)")
register("subspace_dim_s", I, 8, "IDR(s) shadow-space dimension")

# --- s-step / communication-avoiding Krylov (solvers/sstep.py) -------------
register("s_step", I, 4,
         "SSTEP_PCG block size: s SpMVs and one fused Gram reduction "
         "per outer iteration (= s PCG steps); 1 degenerates to "
         "classic PCG")
register("sstep_basis", S, "SCALED",
         "s-step Krylov basis conditioning: MONOMIAL keeps the raw "
         "M^-1 A powers, SCALED renormalizes basis columns by their "
         "A-norm (from the Gram diagonal — no extra reduction) for "
         "numerical stability at larger s",
         ("MONOMIAL", "SCALED"))
register("sstep_replace_every", I, 0,
         "residual-replacement guard for s-step drift: every N outer "
         "iterations the recurred residual is recomputed as b - A x "
         "(one extra SpMV, no extra reduction); 0: off")

# --- coarse / dense ---------------------------------------------------------
register("dense_lu_num_rows", I, 128, "densify when rows <= this")
register("dense_lu_max_rows", I, 0, "never densify above this (0: unused)")
register("inexact_coarse_solver", S, "OPT_POLYNOMIAL",
         "inner method of coarse_solver=INEXACT: fixed-sweep "
         "optimal-weight polynomial smoothing or a few unmonitored "
         "s-step PCG steps replace the DenseLU factorization "
         "(solvers/inexact.py)",
         ("OPT_POLYNOMIAL", "SSTEP_PCG", "CHEBYSHEV", "KPZ_POLYNOMIAL",
          "BLOCK_JACOBI", "JACOBI_L1"))
register("dense_lu_zero_pivot", S, "REGULARIZE",
         "zero/tiny-pivot handling in DENSE_LU factorization: "
         "REGULARIZE refactorizes with a scaled ridge (degraded but "
         "convergent coarse solve), RAISE raises SetupError",
         ("REGULARIZE", "RAISE"))

# --- guardrails (core/errors.py taxonomy, solvers/base.py hooks) -----------
register("solve_retries", I, 0,
         "retry a FAILED/DIVERGED solve up to N times with a fresh "
         "trace, halved relaxation_factor, and zero initial guess "
         "(recovery hook; 0: off)")
register("stagnation_window", I, 0,
         "report DIVERGED when the residual has not decreased over "
         "this many iterations (stagnation detection; 0: off)")
register("precision_fallback", I, 1,
         "ITERATIVE_REFINEMENT accuracy guardrail: when the inner "
         "solver runs a reduced-precision hierarchy "
         "(hierarchy_dtype != SAME) and the refined solve trips the "
         "guardrail (non-SUCCESS status, or more outer corrections "
         "than refine_iteration_guard), re-solve once with an "
         "hierarchy_dtype=SAME fallback solver (0: off)")
register("refine_iteration_guard", I, 0,
         "outer-iteration guardrail for the precision fallback: more "
         "than N outer refinement corrections trips the f64 re-solve "
         "(0: only a non-SUCCESS status trips)")

# --- smoother knobs ---------------------------------------------------------
register("relaxation_factor", F, 0.9, "solver relaxation factor")
register("ilu_sparsity_level", I, 0, "0:ILU0 1:ILU1")
register("symmetric_GS", I, 0, "symmetric GS sweeps")
register("jacobi_iters", I, 5, "inner iterations for GSINNER")
register("GS_L1_variant", I, 0, "L1 Gauss-Seidel variant")
register("kpz_mu", I, 4, "KPZ polynomial mu")
register("kpz_order", I, 3, "KPZ polynomial order")
register("chebyshev_polynomial_order", I, 5, "Chebyshev order")
register("chebyshev_lambda_estimate_mode", I, 0,
         "0-2: power-iteration estimate, 3: user cheby_min/max_lambda")
register("cheby_max_lambda", F, 1.0, "user max eigenvalue guess")
register("cheby_min_lambda", F, 0.125, "user min eigenvalue guess")
register("reestimate_eigs", I, 0,
         "Chebyshev/OPT_POLYNOMIAL spectral-bound refresh cadence on "
         "values-only resetup: 0 reuses the cached bounds (pattern "
         "unchanged, bump bound_staleness), N>0 re-runs the power "
         "iteration every Nth resetup")
register("kaczmarz_coloring_needed", I, 1, "")
register("cf_smoothing_mode", I, 0, "CF smoothing flavour")

# --- AMG hierarchy ----------------------------------------------------------
register("algorithm", S, "CLASSICAL", "",
         ("CLASSICAL", "AGGREGATION", "ENERGYMIN"))
register("hierarchy_dtype", S, "SAME",
         "reduced-precision hierarchy values (the cheap-preconditioner "
         "policy, amg/hierarchy.py): cast level operators, P/R, and "
         "smoother state to this dtype at _finalize_setup.  SAME keeps "
         "the input dtype; wrap reduced hierarchies in "
         "ITERATIVE_REFINEMENT (f64 outer correction) to keep the "
         "final tolerance unchanged (doc/PERFORMANCE.md)",
         ("SAME", "FLOAT64", "F64", "DOUBLE", "FLOAT32", "F32", "FLOAT",
          "BFLOAT16", "BF16"))
register("level_dtype_policy", S, "COARSE",
         "which levels hierarchy_dtype applies to: COARSE casts levels "
         ">= 1 plus every P/R (finest operator keeps the input dtype), "
         "ALL additionally casts the finest level so the whole cycle "
         "runs reduced",
         ("COARSE", "ALL"))
register("amg_host_levels_rows", I, -1, "host levels below this (ignored)")
register("cycle", S, "V", "", ("V", "W", "F", "CG", "CGF"))
register("max_levels", I, 100, "maximum number of levels")
register("min_fine_rows", I, 1, "min rows in a fine level")
register("min_coarse_rows", I, 2, "min block rows in a level")
register("max_coarse_iters", I, 100, "max coarsest-level solve iterations")
register("coarsen_threshold", F, 1.0, "coarsening-ratio threshold")
register("presweeps", I, 1, "presmooth iterations")
register("postsweeps", I, 1, "postsmooth iterations")
register("finest_sweeps", I, -1, "finest-level sweeps (-1: presweeps)")
register("coarsest_sweeps", I, 2, "coarsest-level smoothing iterations")
register("cycle_iters", I, 2, "CG-cycle inner iterations")
register("structure_reuse_levels", I, 0, "hierarchy structure reuse depth")
register("matrix_free", I, 0,
         "MATRIX_FREE accel format (ops/stencil.py): detect verified "
         "constant / axis-separable stencil operators at setup and "
         "replace their O(nnz) DIA value planes with O(1)/O(axis) "
         "coefficient state regenerated on the fly — the SpMV streams "
         "only x and y.  Detection is bitwise-verified against the CSR "
         "values; non-stencil operators keep their formats (0: off)")
register("fused_cycle", I, 1,
         "fuse the smoother->residual->restrict descent leg on "
         "MATRIX_FREE levels into ONE fine-grid pass (identical "
         "arithmetic; the trace-time pass counter and "
         "amgx_solver_cycle_passes_total prove the count).  No-op for "
         "levels without the MATRIX_FREE format; 0 = reference "
         "three-pass legs (parity gates)")
register("error_scaling", I, 0, "coarse-correction scaling mode")
register("reuse_scale", I, 0, "reuse correction scale for N iters")
register("scaling_smoother_steps", I, 2, "")
register("intensive_smoothing", I, 0, "drastically increase sweeps")
register("coarseAgenerator", S, "LOW_DEG", "Galerkin product method")
register("coarseAgenerator_coarse", S, "LOW_DEG", "")
register("interpolator", S, "D1", "", ("D1", "D2", "MULTIPASS", "EM"))
register("energymin_interpolator", S, "EM", "")
register("energymin_selector", S, "CR", "")
register("selector", S, "PMIS", "coarse-grid selector")
register("setup_location", S, "AUTO",
         "classical setup placement: AUTO = device pipeline when the "
         "config is covered (AHAT+PMIS+D1), HOST = scipy pipeline, "
         "DEVICE = require the device pipeline",
         ("AUTO", "HOST", "DEVICE"))
register("aggressive_levels", I, 0, "aggressive-coarsening levels")
register("aggressive_interpolator", S, "MULTIPASS", "")

# --- aggregation ------------------------------------------------------------
register("handshaking_phases", I, 1, "")
register("aggregation_edge_weight_component", I, 0, "")
register("max_matching_iterations", I, 15, "pairwise matching iterations")
register("max_unassigned_percentage", F, 0.05, "")
register("weight_formula", I, 0, "aggregation edge-weight formula")
register("aggregation_passes", I, 3, "MULTI_PAIRWISE passes")
register("structured_aggregation", I, 1,
         "aggregate stencil-structured matrices in geometric blocks so "
         "coarse operators stay banded (TPU DIA fast path); 0 forces "
         "matching-based aggregation")
register("filter_weights", I, 0, "")
register("filter_weights_alpha", F, 0.5, "")
register("full_ghost_level", I, 0, "")
register("notay_weights", I, 0, "")
register("ghost_offdiag_limit", I, 0, "")
register("merge_singletons", I, 1, "merge singletons into neighbors")
register("serial_matching", I, 0, "")
register("modified_handshake", I, 0, "")
register("aggregate_size", I, 2, "DUMMY selector aggregate size")

# --- classical strength/interp ---------------------------------------------
register("strength", S, "AHAT", "", ("AHAT", "ALL", "AFFINITY"))
register("strength_threshold", F, 0.25, "strength threshold")
register("max_row_sum", F, 1.1, "weaken deps when row sum exceeds")
register("interp_truncation_factor", F, 1.1, "interp truncation factor")
register("interp_max_elements", I, -1, "max interp elements per row")
register("affinity_iterations", I, 4, "")
register("affinity_vectors", I, 4, "")

# --- coloring ---------------------------------------------------------------
register("coloring_level", I, 1, "0:none 1:dist-1 2:dist-2 ...")
register("reorder_cols_by_color", I, 0, "")
register("insert_diag_while_reordering", I, 0, "")
register("matrix_coloring_scheme", S, "MIN_MAX", "coloring algorithm")
register("max_num_hash", I, 7, "")
register("num_colors", I, 10, "round-robin colors")
register("max_uncolored_percentage", F, 0.15, "")
register("initial_color", I, 0, "")
register("use_bsrxmv", I, 0, "ignored on TPU")
register("fine_levels", I, -1, "")
register("coloring_try_remove_last_colors", I, 0, "")
register("coloring_custom_arg", S, "", "")
register("print_coloring_info", I, 0, "")
register("weakness_bound", I, 2**31 - 1, "")
register("late_rejection", I, 0, "")
register("geometric_dim", I, 2, "")

# --- convergence / monitoring ----------------------------------------------
register("max_iters", I, 100, "maximum solve iterations")
register("monitor_residual", I, 0, "compute residual each iteration")
register("convergence", S, "ABSOLUTE", "",
         ("ABSOLUTE", "RELATIVE_MAX", "RELATIVE_INI", "RELATIVE_INI_CORE",
          "RELATIVE_MAX_CORE", "COMBINED_REL_INI_ABS"))
register("norm", S, "L2", "", ("L1", "L1_SCALED", "L2", "LMAX"))
register("use_scalar_norm", I, 0, "force scalar norm for block matrices")
register("tolerance", F, 1e-12, "convergence tolerance")
register("alt_rel_tolerance", F, 1e-12, "combined-criterion rel tol")
register("rel_div_tolerance", F, -1.0, "divergence check (-1: off)")
register("verbosity_level", I, 3, "")
register("solver_verbose", I, 0, "")
register("print_config", I, 0, "")
register("print_solve_stats", I, 0, "")
register("print_grid_stats", I, 0, "")
register("print_vis_data", I, 0, "")
register("print_aggregation_info", I, 0, "")
register("obtain_timings", I, 0, "")
register("store_res_history", I, 0, "")
register("convergence_analysis", I, 0, "")
register("scaling", S, "NONE", "",
         ("NONE", "BINORMALIZATION", "NBINORMALIZATION",
          "DIAGONAL_SYMMETRIC"))
register("matrix_reordering", S, "AUTO",
         "bandwidth-reducing unknown renumbering at solver setup "
         "(TPU: unlocks the windowed gather SpMV kernel). AUTO adopts "
         "the RCM ordering only when it yields a faster matrix format",
         ("NONE", "RCM", "AUTO"))

# --- eigensolvers (src/eigensolvers registrations) -------------------------
register("eig_solver", S, "POWER_ITERATION", "eigensolver algorithm")
register("eig_max_iters", I, 100, "")
register("eig_tolerance", F, 1e-6, "")
register("eig_shift", F, 0.0, "spectral shift sigma")
register("eig_damping_factor", F, 0.85, "pagerank damping")
register("eig_which", S, "largest", "which eigenpair",
         ("smallest", "largest", "pagerank", "shift"))
register("eig_wanted_count", I, 1, "number of eigenpairs")
register("eig_subspace_size", I, 8, "subspace/Lanczos dimension")
register("eig_convergence_check_freq", I, 1, "convergence check frequency")
register("eig_eigenvector", I, 0, "compute eigenvectors flag")
register("eig_eigenvector_solver", S, "", "inverse-iteration solver cfg")

# ---------------------------------------------------------------------------
# Consumption classification (round-5 contract: every registered param
# is honored by code, explicitly TPU-N/A, or dead in the reference too;
# tests/test_config.py asserts registry == consumed ∪ TPU_NA ∪
# REF_UNREAD and fails when a new param lands unwired).

# GPU-runtime machinery with no TPU analogue: XLA owns memory pools,
# streams, and kernel scheduling; ICI collectives replace MPI
# transports; coloring of halo updates guards CUDA scatter races that
# cannot occur under XLA's deterministic execution.  Setting one of
# these in a config warns once (the value is accepted and ignored).
TPU_NA = frozenset({
    "device_mem_pool_size", "device_mem_pool_max_alloc_size",
    "device_mem_pool_size_limit", "device_consolidation_pool_size",
    "device_alloc_scaling_factor", "device_alloc_scaling_threshold",
    "high_priority_stream", "num_streams", "serialize_threads",
    "use_cuda_ipc_consolidation", "use_bsrxmv", "exception_handling",
    "communicator", "matrix_halo_exchange", "handshaking_phases",
    "modified_handshake", "halo_coloring", "boundary_coloring",
    "full_ghost_level", "ghost_offdiag_limit",
    "separation_interior", "separation_exterior",
    "fine_level_consolidation", "amg_consolidation_flag",
    "reorder_cols_by_color", "insert_diag_while_reordering",
    "block_format", "block_convert", "amg_host_levels_rows",
    # reuse_scale caches the error-scaling lambda to skip GPU kernel
    # launches; under XLA the dots fuse into the cycle and recompute
    # is free, so the scale is always fresh (amg/hierarchy.py)
    "reuse_scale",
})

# Registered by the reference's core.cu but never read by any reference
# code path either (checked over the reference's src and include trees):
# kept for config-file compatibility, silently accepted exactly like
# the reference.  fine_levels is read but its value discarded
# (agg_selector.cu:283).  max_coarse_iters left this set when
# coarse_solver=INEXACT made it the inexact coarse-sweep cap
# (solvers/inexact.py).
REF_UNREAD = frozenset({
    "GS_L1_variant", "coarseAgenerator_coarse", "coarse_smoother",
    "fine_smoother", "geometric_dim", "initial_color", "jacobi_iters",
    "smoother_amg_list", "fine_levels",
})

_warned_na: set = set()


def warn_if_na(name: str):
    """One-time warning when a config sets a TPU-N/A parameter."""
    if name in TPU_NA and name not in _warned_na:
        import warnings

        _warned_na.add(name)
        warnings.warn(
            f"config parameter {name!r} is accepted for AmgX config "
            "compatibility but has no TPU analogue (XLA owns "
            "memory/streams; ICI collectives replace MPI transports)"
        )


PARAMS = _REGISTRY


def get_description(name: str) -> ParameterDescription:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unregistered parameter {name!r}") from None


def write_parameters_description(path=None) -> str:
    """Dump the registry (reference AMGX_write_parameters_description,
    amgx_c.h:529-531)."""
    lines = []
    for p in sorted(_REGISTRY.values(), key=lambda p: p.name):
        allowed = f" allowed={list(p.allowed)}" if p.allowed else ""
        lines.append(
            f"{p.name} <{p.type.__name__}> default={p.default!r}{allowed}"
            + (f" — {p.doc}" if p.doc else "")
        )
    text = "\n".join(lines) + "\n"
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text
