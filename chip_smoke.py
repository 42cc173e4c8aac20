"""Smoke test of the PyTorch/CUDA port (``amgx_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py [--phases kernels,block4_amg_pcg,...]

Phases (any failure raises and exits non-zero; without ``--phases``
nothing is skipped; with it, only the named phases run, with those they
need (``NEEDS``), and the skipped phases and the checks left out are
printed before the result).  The CPU port's runs that the phases hold
the card to, and the host matcher of phase 16, start once the kernels
are built, in one child process at the lowest priority (``CpuSide``),
beside the card's work; each phase's ``phase_s`` line gives the seconds
it waited for them:

1. Card and build: prints the card's ``nvidia-smi`` name and power
   limit, builds the hand-written kernels from ``amgx_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time and
   the ``ptxas`` register report.
2. Kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it (the 128^3 Poisson level 0 and
   the coarser levels of the bench hierarchy, the level-0 prolongation
   P and restriction R) and on edge cases.  One JSON line per case: max
   errors, kernel / plain / library (``torch.sparse`` CSR product, a
   yardstick the port never calls) times in ms from CUDA events (median
   of 25 launches, L2 flushed before each by a read of 128 MiB), the
   kernel's time with L2 left warm, its device time without the launch
   (profiler), and the roofline bound from this run's bytes and
   operations (counted from the operator's nonzeros, not from padded
   slots).  First, the floor of one event-bracketed launch (an
   empty kernel).  Each DIA case prints the kernel's launch plan
   (``ops/dia.py:dia_launch_plan``) and checks the instantiation it
   names; the DIA cases sit where the launches fall: the bench
   hierarchy's levels 0-2 and 8^3, a SIZE_2 level of
   FGMRES_AGGREGATION, the f64 operators, rows not a multiple of 8 (odd,
   and 2 mod 4 in bf16), the runtime-count kernel at 27 and 48
   diagonals, and bf16 edge inputs (subnormals, -0.0, inf in x) held
   bit for bit.  Each stencil case prints its launch plan, checks
   that the plan takes the kernel meant for the stencil (the star's,
   the box-subset one or the runtime-count one) and is held bit for bit
   against the DIA kernel on the same matrix, whose times are printed
   beside it with those of a copy of x (the bytes of the bound moved by
   the copy engine).  Each ELL case runs the slot-major ``ell_spmv`` and,
   where the upload builds the sliced layout, ``sell_spmv``, each held
   to the plain versions of both layouts; the sliced kernel is also
   held, untimed, to both on edge layouts at every window and lane
   count (one lane a row bit for bit equal to ``ell_spmv``).  Speed
   targets print on ``targets`` lines and fail nothing.  A line before
   the summary lists every device time the profiler did not record.
3. DIA slice: the bench solve (PCG + aggregation-AMG V-cycle, SIZE_8,
   BLOCK_JACOBI, DENSE_LU) on ``poisson_3d_7pt(128)`` in f32 through
   the port's entry points.  Kernel launch counts are zeroed just
   before setup and read just after the solve.  Checks status 0, the
   true residual (float64, scipy) and the launch counts; then repeats
   the solve through the port on the CPU (plain versions) and compares
   iterations and x.  Then 64^3 in f64 (iterations equal, x to rtol
   1e-9) and the 16^3 SIZE_2 ``entry()`` config.
4. MATRIX_FREE slice: the same bench solve with ``"matrix_free": 1``
   on a matrix uploaded with the MATRIX_FREE format, counts zeroed
   just before setup and read just after the solve.  Checks every level
   MATRIX_FREE, the launch counts (stencil kernel on every A-SpMV, no
   DIA launch), the fused pass count, and x bit for bit equal to the
   DIA slice's x on the card; then the CPU run, 64^3 f64 on both, and a
   trace of the warm solve.
5. FGMRES_AGGREGATION slice: AmgX's FGMRES + SIZE_2 aggregation AMG +
   MULTICOLOR_DILU config (``FGMRES_CFG``) on ``poisson_3d_7pt(128)``
   in f32, counts zeroed just before setup and read just after the
   solve.  Checks status 0, the true residual, every level DIA, and
   the ``dia_spmv`` and ``ell_spmv`` counts against the count derived
   from the hierarchy and the iterations; traces the first 3 iterations
   of a warm solve (device ops per iteration, busy share, time in the
   SpMV kernels and in the
   colour stages' gathers, reductions and index copies); repeats it on
   the CPU (same colours per level, iterations within one, x to rtol
   1e-4); 64^3 f64 on both (iterations equal, x to rtol 1e-9); and a
   32^3 f32 matrix of every solver and smoother the slice ported, card
   against CPU (iterations within one), with the solvers, smoothers,
   coarse solver and scalers of the seventh slice.
6. PCG_CLASSICAL_V_JACOBI slice: AmgX's default-algorithm config
   (``PCG_CLASSICAL``: PCG + classical AMG, AHAT / PMIS / D1, BLOCK_JACOBI,
   DENSE_LU) on ``poisson_3d_7pt(128)`` in f32 with the classical setup
   on the card (``setup_location`` AUTO), counts zeroed just before
   setup and read just after the solve.  Per level rows, nnz, format
   and ELL widths; upload, setup (host / device split, scalar reads,
   peak device memory) and solve times; the true residual; no level
   handed to the host builder; the ``dia_spmv`` / ``ell_spmv`` /
   ``sell_spmv`` launches and CSR products equal to the count derived
   from the hierarchy; each ELL operator's sliced layout (window, lanes
   a row, stored slots per CSR entry, device bytes); both ELL kernels at
   every ELL operator (the sliced one also at every lane count and
   window), the level-1 A in f64 and renumbered by RCM (a measurement
   only); a trace of a warm solve.  Then the CPU port at 64^3 beside
   the card's run at 64^3 (host setup, iterations within one) and a
   second card setup and solve at 64^3 (hierarchy and x bit for bit
   equal), the 48^3 f64
   hierarchy against the host builder (C/F splits, rows and nonzeros equal, P and R to 1e-12, the
   coarse operators to 1e-11), 64^3 f64 against the CPU (iterations
   equal, x to rtol 1e-9), and,
   card against CPU, the MULTIPASS variant at 64^3, ENERGYMIN and RCM
   reordering (of a shuffled Poisson matrix) at 32^3 (the D2 +
   aggressive + interp_max_elements 4 hierarchy is phase 7's).
7. pcg_classical_cheby: ``PCG_CLASSICAL_CHEB`` (PCG_CLASSICAL with D2
   interpolation, aggressive coarsening of level 0, 4 interpolation
   elements, and CHEBYSHEV of order 2 over JACOBI_L1 as smoother) on
   ``poisson_3d_7pt(128)`` in f32, setup on the card; lmax per level,
   the launch counts (each Chebyshev sweep of order k is k A-SpMVs, each
   smoothed level's power iteration 20 at setup) and a trace; the CPU
   port at 128^3 (iterations within one); 64^3 f64 with the card's
   hierarchy carried to the CPU (iterations equal, x to rtol 1e-9,
   lmax to rtol 1e-9, the true residual at the tolerance).
8. idr_dilu: ``IDR_DILU_CFG`` (IDR(8) + one MULTICOLOR_DILU sweep) on
   ``poisson_3d_7pt(128)`` in f32: colours, the ``dia_spmv`` count (s + 1
   an iteration and the initial residual), a trace of 3 warm
   iterations; the CPU port at
   96^3 f32 (status and monitored residual: in f32 IDR(8)'s recurred
   residual parts from the true one and its iterations move by several
   with the summation order); 128^3 f64 on the card (the true residual
   at the tolerance); 64^3 f64 against the CPU (iterations equal, x to
   rtol 1e-9, the true residual at the tolerance).
9. gmres_ilu0: ``GMRES_ILU0_CFG`` (BASELINE.md acceptance config 4:
   GMRES(30) + ILU(0)) on the 108^3 upwind convection-diffusion operator
   (``convection_diffusion_3d``, the size and stencil of atmosmodd) in
   f64: colours, the ILU factorization's host time, the ``dia_spmv``
   count (one an iteration and one a restart cycle), a trace; the CPU
   port at 108^3; 64^3 against the CPU; ILU(0) and ILU(1) at 64^3
   (colours of each fill pattern, factorization time, iterations).
10. pbicgstab_agg_w: ``PBICGSTAB_AGG_W_CFG`` (PBICGSTAB + aggregation
   AMG W-cycle, ``error_scaling`` 2, BLOCK_JACOBI 2+2, DENSE_LU) on
   ``poisson_3d_7pt(128)`` in f32: levels, visits a cycle, launches
   against :func:`cycle_walk` (a dry walk of the cycle, itself held to
   the cycle's counted A-SpMVs), a trace; the CPU port at 128^3
   (iterations within one); 64^3 f64 against the CPU.  The 32^3 solver
   matrix (phase 5) runs ``error_scaling`` 3-5, an F-cycle and CGF.
11. amg_classical_kcycle: ``AMG_CLASSICAL_CG_CFG`` (AMG as the outer
   solver, classical, a CG K-cycle of 2 iterations) at 64^3 f32 (not
   128^3 or 96^3, to keep the whole run in its time limit: its CPU solve
   took 85 s at 128^3 and 78 s at 96^3), setup on the card: levels,
   visits, launches as walked, a trace; the CPU port at 64^3 (iterations
   within one); 64^3 f64 with the device setup on both.
12. pcg_agg_resetup: the bench config with ``structure_reuse_levels``
   -1 set up once, then ``replace_values`` (timed by CUDA events),
   ``resetup`` and ``solve`` three times, on variable-coefficient
   diffusion (DIA, beside a fresh setup without plans on each A_k) and
   on MATRIX_FREE heat steps (x bit for bit the DIA hierarchy's): plans
   and their
   device bytes, ``rap_plan`` / ``rap_execute`` seconds, the coarse
   operators against scipy's R A P, launches as derived, two resetups
   bit for bit, the CPU port's sequence; 64^3 f64 against the CPU;
   classical reuse at 64^3 f64 (plans per level, iterations).
13. refine_bf16_256, the reduced-precision large-grid path:
   ``REFINE_BF16_CFG`` (the JAX package's CHEAP_PRECONDITIONER_CONFIG:
   ITERATIVE_REFINEMENT + PCG(8) + SIZE_8 AMG, OPT_POLYNOMIAL, INEXACT,
   with a bf16 hierarchy and no Galerkin plans) on ``poisson_3d_7pt
   (256)`` in f32, 16,777,216 rows: levels with dtypes, level 0's
   Galerkin product through ``geo_galerkin_dia`` on the card (against
   scipy's R A P), setup phases, bytes by dtype, corrections, inner
   iterations and fallbacks (none allowed), the true residual at 1e-8, launches per
   kernel entry point against the walk, first and warm solve, a trace,
   the bf16 DIA kernel at the level-1 and level-0 A (with their plans)
   and the transfer kernels at their shapes; the same solve
   on an f32 hierarchy and plain f32 PCG on it (where its true residual
   stalls); card against the CPU port at 64^3: the path's config in
   f32, CHEAP_PRECONDITIONER_CONFIG verbatim in f64, and under COARSE
   in f64 (the f32 restriction of an f64 residual).
14. mf_bf16: the bench config with a bf16 hierarchy (ALL) at 128^3,
   ``matrix_free`` 0 then 1: the DIA and stencil kernels in bf16,
   launches as derived, x bit for bit between the two.
15. classical_bf16: PCG_CLASSICAL with a bf16 hierarchy (COARSE) at
   96^3: the sliced kernel in bf16 (every sliced operator bit for bit
   its plain version), the level-0 R in (bf16, f32), the CSR products
   of the bf16 P; the CPU port at 96^3.
16. device_match: the device matcher bit for bit with the host one on
   the 128^3 Poisson graph and a shuffled one (both timed, the host one
   in a child process beside the card's work); PCG +
   SIZE_2 aggregation by matching at 128^3 (every pass over 16,384
   rows on the card); 64^3 f64 against the CPU port's host matcher.
17. block4_amg_pcg: ``kron(poisson_3d_7pt(48), I_4 + 0.2 * ones)`` in
   f32 as block CSR with b = 4 (442,368 unknowns): PCG + aggregation
   AMG (SIZE_2, MULTICOLOR_DILU, DENSE_LU) on the scalar expansion,
   whose level 0 is DIA with 43 diagonals, with per-component norms:
   levels and colours, launches against the walk (``dia_spmv`` among
   them), a trace of 3 warm iterations, the ``dia_spmv`` case on the
   level-0 A and the ELL kernel's case on every ELL operator of the
   hierarchy (their launches adding up to the path's);
   ``block4_pcg_bdilu`` (PCG + block-native MULTICOLOR_DILU, no
   kernel); both card against the CPU port at 32^3 x 4 f32 and, with
   BLOCK_JACOBI and MULTICOLOR_ILU, at 12^3 x 4 f64.
18. eigensolvers (f64): INVERSE_ITERATION on ``poisson_3d_7pt(128)``
   (2,097,152 rows) with PCG to 1e-10 around the bench AMG inside,
   plain and with ``eig_shift`` 1.7e-3 (shift-invert on A - sigma I):
   converged, lambda within 1e-6 of 6 - 6 cos(pi / 129), outer and inner
   iterations, ||A v - lambda v|| / lambda, ``dia_spmv`` / ``ell_spmv``
   launches equal to the walk (the inner solves' walks and one A w an
   outer iteration); LANCZOS (60 steps, the two largest: each Ritz value
   at most 6 + 6 cos(pi / 129), ``dia_spmv`` = 60 + the residual's);
   PAGERANK on a seeded link graph of 1,048,576 nodes, 8 out-links, 5 %
   dangling (converged at 1e-10, every entry > 0, sum 1 to 1e-12; the
   Google matrix's format and kernel); then all nine names at 64^3
   (PAGERANK on 65,536 nodes), each case's launches against its walk
   (``eig_walk``: a column loop is one launch a column), held to the CPU
   port: iterations and
   ``converged`` equal, eigenvalues to rtol 1e-10, vectors up to sign
   to 1e-8 where their eigenvalue is simple, and INVERSE_ITERATION's
   eigenvector post-pass (``eig_eigenvector_solver``) the same.
19. setup_store (f32): the bench config, ``PCG_CLASSICAL``,
   ``PCG_CLASSICAL_CHEB`` and the bench config with ``matrix_free`` 1 at
   128^3, each set up on the card, saved (``save_setup``), restored
   (``load_setup``) on the card and solved: payload MB, save / restore
   / setup seconds; the restore launches no kernel and coarsens nothing
   (Chebyshev bounds restored), the levels agree in rows, nnz, formats
   and dtypes, the solve in iterations, x bit for bit and launches per
   kernel.  Then a 64^3 f64 payload saved on the card restored on the
   CPU (iterations equal, x to rtol 1e-9), and ``ArtifactStore`` at
   64^3: a hit restores the solver, a corrupted, a truncated and a
   stale-schema entry are each a counted miss.  Payloads go under
   ``ci/artifacts`` and are deleted.
20. capi: the C API (``amgx_tpu_torch/api/capi.py`` and the native
   shim ``amgx_tpu_torch/native``) in the mode table's real modes.
   a. Builds the shim and the C host program (``kernels.build_native``)
   and prints the seconds.  b. Loads the shim into this interpreter
   (``ctypes.PyDLL``) and runs the bench config in dFFI at 128^3 from
   raw CSR buffers: status 0, the true residual, launches (zeroed just
   before ``AMGX_solver_setup``, read just after the solve) equal to the
   walk, and iterations and x bit for bit those of a direct
   ``create_solver`` solve of the same CSR arrays.  c. The same solve in
   dDFI (f32 matrix, f64 vectors): launches per entry point equal to
   the walk (PCG's A p on ``dia_spmv_f32_f64``; the cycle runs in the
   hierarchy's f32, so no ELL transfer meets an f64 vector).  d. PCG +
   BLOCK_JACOBI (``JACOBI_CFG``) in dFBI at 128^3 (``dia_spmv_bf16_f32``)
   and in dDFI and dFBI on ``irregular_poisson(64)``, an unstructured
   upload that takes the sliced layout (``sell_spmv_f32_f64``,
   ``sell_spmv_bf16_f32``), launches as derived; the card against the
   CPU port at 64^3: bench
   dDFI and Jacobi dFBI and the two sliced solves, iterations equal with
   f64 vectors and x to rtol 1e-9, within one with f32 ones.  Each of
   the four mixed entry points is held to its plain version at its
   path's shape (bit for bit; a 4-lane sliced case within TOL) and
   timed.  e. The C host program (``native/capi_poisson.c``) in a
   subprocess in dDDI at 64^3: status 0, its own residual, iterations
   and x (from its file) bit for bit those of the in-process dDDI
   solve of the same system, lines through its print callback.  f.
   Through the shim, a bad handle returns RC_BAD_PARAMETERS, an unknown
   mode RC_BAD_MODE and ``AMGX_solver_solve_batch`` on a handle that
   names no solver RC_BAD_PARAMETERS.
20.1 capi_complex: the mode table's complex modes on the card through
   the C API's handles, on the complex-shifted Laplacian L + i 0.3 I of
   ``poisson_3d_7pt`` (``shifted``), counts zeroed just before setup and
   read just after the solve.  a.-c. GMRES(20) + SIZE_2 aggregation AMG
   (``CX_AMG_CFG``) at 128^3 in dZZI, dCCI (tolerance 1e-5) and dZCI (a
   c64 hierarchy under c128 vectors): status 0, the true residual in
   complex128 within 10 x the tolerance (GMRES stops on the
   preconditioned one; 1e-5 in dZCI, whose c64 hierarchy rounds M^-1 r
   to c64), launches per entry point equal to the walk
   (``cx_amg_walk``: GMRES's A v on ``dia_spmv_c128`` / ``_c64`` /
   ``_c64_c128``, the cycle in the hierarchy's dtype); at 64^3 the card
   against the CPU port (hZZI: iterations equal, x to rtol 1e-9; hCCI,
   hZCI: iterations within one, x to rtol 1e-4).  d. MATRIX_FREE in
   dZZI and dZCI through the solver entry on a MATRIX_FREE upload (the
   C API's upload builds DIA, its ``matrix_free`` rebuilds the
   hierarchy's level 0 only): the top and level-0 A-SpMVs on
   ``stencil_spmv_c128`` / ``_c64_c128`` / ``_c64``, as walked, x bit
   for bit a.'s and c.'s.  e. The bench config with ``matrix_free`` 1
   in the dDFI and dFBI dtypes (f32 / bf16 matrix, f64 / f32 vectors;
   in dFBI its hierarchy in bf16, ``MF_BF16_CFG``):
   PCG's A p on ``stencil_spmv_f32_f64`` / ``_bf16_f32``, x bit for bit
   the DIA upload's.  f. GMRES + BLOCK_JACOBI on
   ``irregular_poisson(64)`` shifted in dZZI, dCCI and dZCI (the sliced
   layout: ``sell_spmv_c128`` / ``_c64`` / ``_c64_c128``) and on a
   shuffled periodic 64^3 grid (``torus_poisson``) in dZCI (slot-major:
   ``ell_spmv_c64_c128``),
   launches as walked.  g. ``solver_solve_batch`` in dZZI and dCCI on 16
   jittered 32^3 systems (PBICGSTAB + the AMG with Galerkin plans) and 4
   irregular ones (PBICGSTAB + BLOCK_JACOBI): the batched complex entry
   points launched, each x to rtol 1e-10 (1e-4 in dCCI) of its
   sequential solve.  Each of the 20 entry points the slice adds is held
   to its plain version at its path's shape (within TOL of the row's
   |A||x| for the complex ones, bit for bit for the stencil's mixed
   pairs; every stencil case bit for bit with the DIA kernel on the same
   matrix) and timed, beside torch's CSR product.  h. The port's
   ``amgx_capi`` CLI in two subprocesses: ``-p 64 64 64 -mode dDDI`` with
   the bench config and a complex 24^3 ``.mtx`` in ``-mode dZZI``: exit
   0, status success and the residual table.
21. serve: the batched solve service (``amgx_tpu_torch.serve``) on the
   card.  a. The main path: 16 systems of ``jittered_poisson_family
   ((64, 64, 64), 16)`` in f64 under ``SERVE_PCG_AMG`` (tests/test_serve.
   py's PCG_AMG) through ``BatchedSolveService(device="cuda").
   solve_many``, counts zeroed just before it and read just after: one
   batch, one setup, no fallback, every status 0 with a true residual
   at 1e-8, iterations equal to the card's sequential reference (one
   solver set up on system 0, then resetup and solve for each) and x
   to rtol 1e-10, ``dia_spmv_batched_f64`` / ``ell_spmv_batched_f64``
   launches equal to the batched cycle's walk (:func:`batched_walk`)
   over the group's largest iteration count, and no unbatched launch.
   b. New coefficients on the same pattern: no new setup, no new
   build.  c. DEFAULT_CONFIG in f32 on 16 x 64^3 and on 8 systems of
   the ``irregular_poisson(64)`` pattern (an ELL template with the
   sliced layout: ``sell_spmv_batched_f32``), and ``SERVE_PCG_AMG_F32``
   on 8 x 64^3 (the f32 SIZE_8 transfers: ``ell_spmv_batched_f32``):
   iterations within one of the sequential ones, true residual at
   1e-5, launches as walked.  d. A mixed queue of 8 x 64^3, 8 x 60^3
   (padded rows) and 8 irregular systems in f64: three batches (DIA,
   DIA, ELL), launches as walked (``sell_spmv_batched_f64`` on the
   irregular group, no slot-major ELL launch), each system equal to
   its sequential solve.  e. Masked early exit: a
   diagonally dominant system among 15 hard ones freezes (fewer
   iterations than the group's largest, history NaN past its freeze)
   with x bit for bit its solve in a group of 16 copies of itself
   (torch orders a batched reduction's sums by the batch's shape).
   f. Guards at 32^3: a NaN request (``validate=False``) quarantined
   with its three groupmates converged, ``validate=True`` rejecting
   non-finite uploads, an expired deadline failing only its ticket.
   g. ``AMGX_solver_solve_batch`` through the shim in dDDI on 4 x
   64^3: every RC 0, statuses and iterations those of the in-process
   service.  h. Host seconds per system, batched (first and warm
   flush) against sequential, for a and c.  i. The same service calls
   on the card and in the CPU port at 4 x 24^3 f64: iterations equal,
   x to rtol 1e-9.  The kernels phase holds the six batched entry
   points at these shapes (B = 16; the slot-major ELL entry on the
   irregular template too, as the sliced one's "before"): each
   instance bit for bit the unbatched entry point's, the batch within
   TOL of the plain batched version, timed beside a block-diagonal CSR
   ``torch.mv`` of the same work.  j. ``COMM_AVOIDING_CONFIG`` (s-step
   PCG over an OPT_POLYNOMIAL-smoothed AMG) on the 16 systems of a:
   one batch, one setup, no fallback, iterations within one of the
   card's sequential solves and x within 1.1e-9 of its largest entry,
   true residual at 1e-8, launches as walked (:func:`comm_walk`).
   k. ``CHEAP_PRECONDITIONER_CONFIG`` (ITERATIVE_REFINEMENT over PCG
   and an f32 AMG with an INEXACT coarse solve) on the same systems:
   one batch, corrections and inner iterations equal to the sequential
   solves', x to rtol 1e-10, true residual at 1e-8, launches per entry
   point as walked (:func:`cheap_walk`: the cycle on
   ``dia_spmv_batched_f32`` / ``ell_spmv_batched_f32``, PCG's operator
   on ``dia_spmv_batched_f64``).
22. sessions: streaming solve sessions (``amgx_tpu_torch.sessions``).
   c. ``session_heat``: 16 sessions of implicit-Euler heat steps on
   64^3 (:class:`HeatStream`: the coefficients drawn anew for every
   session and step), 8 steps through ``SessionManager.step_all`` under
   ``SESSION_CFG``, counts zeroed just before and read just after: a
   batch a step, one setup and one build over all steps, no pattern
   hash after ``open``, each step's iterations and x (rtol 1e-10) those
   of the sequential solve from the same x0, fewer iterations in all
   than the same stream from zero guesses, launches as walked, host
   seconds a system and step beside the sequential solve's.  d.
   ``session_capi``: a dDDI session through ``api/capi.py`` (create,
   3 steps, sync): every RC 0, statuses and iterations those of the
   Python session, x bit for bit.  e. The card against the CPU port
   at 4 x 24^3, 3 steps: iterations equal, x to rtol 1e-9.
23. faults_telemetry: fault injection, solve retries and telemetry
   (``core/faults.py``, ``telemetry/``) on the card; runs after
   bench_pcg.  a. The main path: the bench config with
   ``solve_retries`` 1 at 128^3 f32, ``smoother_nan`` armed once,
   counts zeroed just before setup and read just after the solve: the
   retry SUCCESS with the clean solve's iterations and x bit for bit
   (that solve's x bit for bit the bench_pcg phase's), one retry, one
   fire, launches as walked (two solves: the FAILED first attempt's
   one iteration and the retry's); the first attempt alone FAILED at
   iteration 1.  b. ``dot_breakdown`` unlimited with a stagnation
   window of 5: DIVERGED within it, x finite.  c.
   ``coarse_lu_zero_pivot`` at setup: REGULARIZE converges at 128^3
   f32 on the pseudoinverse and at 64^3 f64 in the CPU port's
   iterations (x to rtol 1e-9); RAISE raises SingularDiagonalError.
   d. ``serve_compile`` once on 16 x 64^3 f64 under SERVE_PCG_AMG: one
   quarantine, each request alone with its sequential solve's
   iterations and x to rtol 1e-10, the incident in the recorder.  e.
   ``capi_internal`` through the native shim in dDDI at 64^3: the JAX
   package's RC (RC_UNKNOWN), then RC 0 and x bit for bit a direct
   solve's.  f. A warm 16 x 64^3 flush at trace sample rate 1: 16
   connected span chains, one ``flush_group`` naming the 16, a Chrome
   export that parses, a Prometheus page that passes the exposition
   grammar, 16 flight records with the tickets' iterations,
   ``solver_telemetry_json`` that parses; the warm flush's host ms a
   system with telemetry off, on and traced (two rounds, a
   measurement).  g. ``profile_cycle`` of the bench hierarchy at
   128^3 f32: each level's phases in ms (CUDA events) with the card's
   name and power limit, beside one warm V-cycle's time.
24. gateway: the serve layer's front door and failure domains
   (``serve/gateway.py``, ``serve/admission.py``, the service's lanes,
   failover and fetch watchdog) on 16 x 64^3 f64 under
   ``SERVE_PCG_AMG``, its hierarchy warm-booted from serve a's export
   where the serve phase ran (nothing set up).  a. A started
   ``SolveGateway`` of 24 in flight (batch ceiling 18) with two tenants'
   quotas: 32 batch-lane systems from tenant A and 16 interactive from
   B, in rounds of two A and one B (:func:`gateway_rounds`), counts
   zeroed before the flush and read after the fetches: every shed typed
   with ``retry_after_s`` > 0, the batch lane shedding first (A over the
   budget, B over its quota), the flush order interactive then batch,
   launches as walked over the two groups, each admitted system's
   status and iterations those of the bare service and x to rtol 1e-10.
   b. One group under each of ``device_lost_dispatch``,
   ``device_lost_fetch`` and ``fetch_hang`` (watchdog 0.5 s, hang 2 s):
   x bit for bit the clean group's, one failover, no quarantine and no
   breaker trip, launches one walk (the dispatch loss) or two; with
   failover off a fetch loss settles every ticket ``DeviceLostError``; a
   double hang settles typed within 2 x the watchdog + 0.5 s; the
   submit-and-flush seconds and the retained bytes with failover on and
   off.  c. A real ``torch.cuda.OutOfMemoryError`` (an allocation past
   the card's memory) is not classified as a device loss (no real device
   loss is provoked).  d. ``drain()`` with two groups handed to the
   dispatch worker: every ticket settled, none lost or timed out, the
   entries exported; a fresh service warm-boots them and its first
   group is a cache hit.  e. 16 heat-stream sessions take 2 steps on
   the phase's service and then through a gateway on it, x bit for bit;
   ``solver_solve_batch`` on 16 systems in dDDI under
   ``AMGX_TPU_CAPI_ADMISSION=8``: RC 0, 8 SUCCESS with the bare
   service's iterations, 8 FAILED; a malformed value RC 12 on every call.
   f. Check a's traffic at 4 x 24^3 on the card and in the CPU port:
   the same sheds, iterations equal, x to rtol 1e-9.
25. fleet: the multi-process fleet (``amgx_tpu_torch.fleet``): two
   worker processes (``chip_smoke.py --fleet-worker``, the port's
   ``fleet.worker.main`` under ``SERVE_PCG_AMG``, each with its own CUDA
   context on the one card) spawned by ``FleetSupervisor`` at the start
   of the phase on serve a's exported store (an empty store when serve
   does not run; they boot while this process solves the references),
   and a ``FleetFrontend`` in this process, on 16 x 64^3 f64.
   Each worker writes its kernel launches to a file beside the registry
   every 0.5 s and at exit (``fleet_worker``); the summary line's
   ``fleet`` path sums them over every worker process.  a. Two
   fingerprints (serve a's systems and a 32 x 64 x 128 grid) spread
   over the two workers, then a repeat round of 32 affinity hits; each
   x as the in-process sequential solve's (status, iterations, rtol
   1e-10); the groups each worker ran (frames arrive one by one, and a
   waiting result flushes its group: groups of 1-2 systems) and
   launches of one walk a group (each fingerprint's systems take one
   iteration count, checked); ``nvidia-smi --query-compute-apps``.
   b. A ``NonFiniteValuesError`` crosses the wire typed; no breaker
   trips.  c. The rolling restart of one worker with its fingerprint's
   16 systems in flight: each settles with the sequential x, the
   drained process exits 0, the replacement warm-boots (its boot and
   restore seconds) and serves the fingerprint (two systems) with no
   setup and no coarsening.  d. kill -9 of the worker of a cold fingerprint's group
   (a 128 x 64 x 32 grid): every ticket settles, answered before the
   kill or requeued once to the survivor (x as the sequential solves')
   or ``DeviceLostError``, one connection loss, and the survivor serves
   on.  e. ``solver_solve_batch`` in dDDI
   on 4 systems under ``AMGX_TPU_FLEET`` (the registry): RC 0, SUCCESS,
   the sequential iterations and x, no local service.  At the end each
   worker's launches are walks of the groups its metrics count: the
   survivor's exactly, the drained worker's for 1 to 16 groups in
   flight, the killed worker's (its last file) at most that bound.
   Prints the spawn-to-announce seconds, the wire seconds a system and
   the groups of each worker.
26. Prints the per-kernel summary line (each kernel's launches on every
   path; ``launches`` is those on its own path: the bench PCG slice for
   ``dia_spmv`` and ``ell_spmv``, the MATRIX_FREE slice for
   ``stencil_spmv``, the classical slice for ``sell_spmv``; one entry
   for each bf16, mixed-dtype, complex and batched entry point, its
   launches from its path in ``VARIANTS``), then the device line
   last.  Each phase's seconds print on a ``phase_s`` line.

Exits non-zero without a result when CUDA is unavailable.  Imports
nothing of JAX or of the JAX package ``amgx_tpu``.
"""

from __future__ import annotations

import itertools
import json
import multiprocessing
import subprocess
import sys
import threading
import time
import types
import warnings

import numpy as np

BENCH_CFG = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "PCG", "max_iters": 100, "tolerance": 1e-6,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 512, "max_levels": 20,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
    ' "monitor_residual": 0}}}'
)

ENTRY_CFG = (
    '{"config_version": 2,'
    ' "solver": {"scope": "main", "solver": "PCG", "max_iters": 20,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "tolerance": 1e-05, "norm": "L2",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_2",'
    ' "smoother": {"scope": "jac", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 32, "max_levels": 20,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
    ' "monitor_residual": 0}}}'
)

# the bench config with the MATRIX_FREE format and (by default) fused
# descent legs
MF_CFG = BENCH_CFG.replace('"cycle": "V",', '"cycle": "V", "matrix_free": 1,')
MF_FORMATS = ("matrix_free", "dia", "dense", "ell")

# AmgX's FGMRES_AGGREGATION config (tests/test_config.py's FGMRES_AGG)
# with "monitor_residual": 1, as AmgX ships it: FGMRES around an
# aggregation-AMG V-cycle, SIZE_2, MULTICOLOR_DILU post-smoothing
FGMRES_CFG = (
    '{"config_version": 2, "solver": {"preconditioner": {'
    ' "algorithm": "AGGREGATION", "solver": "AMG",'
    ' "smoother": "MULTICOLOR_DILU", "presweeps": 0, "selector": "SIZE_2",'
    ' "coarse_solver": "DENSE_LU_SOLVER", "max_iters": 1, "postsweeps": 3,'
    ' "min_coarse_rows": 32, "relaxation_factor": 0.75, "scope": "amg",'
    ' "max_levels": 50, "cycle": "V"}, "use_scalar_norm": 1,'
    ' "monitor_residual": 1, "solver": "FGMRES", "max_iters": 100,'
    ' "gmres_n_restart": 10, "convergence": "RELATIVE_INI", "scope": "main",'
    ' "tolerance": 1e-06, "norm": "L2"}}'
)

# AmgX's PCG_CLASSICAL_V_JACOBI.json.  It has no algorithm, selector,
# interpolator or coarse_solver key: classical AMG (AHAT strength, PMIS,
# D1), DENSE_LU below 128 rows and setup_location AUTO (the device
# pipeline on the card, the host builder on the CPU) apply
PCG_CLASSICAL = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
    ' "monitor_residual": 1, "norm": "L2",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG", "cycle": "V",'
    ' "max_iters": 1, "presweeps": 1, "postsweeps": 1, "max_levels": 100,'
    ' "monitor_residual": 0,'
    ' "smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}}}}'
)

# PCG_CLASSICAL with the BLOCK_JACOBI smoother replaced by CHEBYSHEV
# (order 2, lambda by power iteration) over JACOBI_L1, and the D2 +
# aggressive coarsening truncated to 4 interpolation elements: the
# shape of AmgX's AMG_CLASSICAL_AGGRESSIVE_CHEB_L1_TRUNC
PCG_CLASSICAL_CHEB = PCG_CLASSICAL.replace(
    '"monitor_residual": 0,',
    '"monitor_residual": 0, "interpolator": "D2", "aggressive_levels": 1,'
    ' "interp_max_elements": 4,', 1,
).replace(
    '"smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}',
    '"smoother": {"scope": "cheb", "solver": "CHEBYSHEV",'
    ' "chebyshev_polynomial_order": 2, "chebyshev_lambda_estimate_mode": 2,'
    ' "max_iters": 1, "monitor_residual": 0,'
    ' "preconditioner": {"scope": "l1", "solver": "JACOBI_L1",'
    ' "max_iters": 1, "monitor_residual": 0}}',
)

# IDR(8) preconditioned by one MULTICOLOR_DILU sweep: the shape of
# AmgX's IDR_DILU
IDR_DILU_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "IDR",'
    ' "subspace_dim_s": 8, "max_iters": 200, "tolerance": 1e-6,'
    ' "convergence": "RELATIVE_INI", "norm": "L2", "monitor_residual": 1,'
    ' "preconditioner": {"scope": "dilu", "solver": "MULTICOLOR_DILU",'
    ' "max_iters": 1, "monitor_residual": 0}}}'
)

# BASELINE.md acceptance config 4 (ci/acceptance.py, tests/
# test_nonsymmetric.py): GMRES(30) preconditioned by one ILU(0) sweep
GMRES_ILU0_CFG = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "GMRES", "gmres_n_restart": 30,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "tolerance": 1e-08, "max_iters": 200,'
    ' "preconditioner": {"scope": "ilu",'
    ' "solver": "MULTICOLOR_ILU", "ilu_sparsity_level": 0,'
    ' "max_iters": 1, "monitor_residual": 0}}}'
)


# PBICGSTAB around an aggregation-AMG W-cycle with scaled coarse
# correction (error_scaling 2), SIZE_8, BLOCK_JACOBI 2+2, DENSE_LU: the
# shape of AmgX's PBICGSTAB_AGGREGATION_W_JACOBI
PBICGSTAB_AGG_W_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PBICGSTAB",'
    ' "max_iters": 100, "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
    ' "monitor_residual": 1, "norm": "L2", "use_scalar_norm": 1,'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8", "cycle": "W",'
    ' "error_scaling": 2, "max_iters": 1, "presweeps": 2, "postsweeps": 2,'
    ' "min_coarse_rows": 32, "max_levels": 50,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "monitor_residual": 0,'
    ' "smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}}}}'
)

# AMG as the outer solver, classical (AHAT / PMIS / D1), a CG K-cycle of
# 2 iterations, BLOCK_JACOBI 1+1: the shape of AmgX's AMG_CLASSICAL_CG
AMG_CLASSICAL_CG_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "AMG",'
    ' "algorithm": "CLASSICAL", "cycle": "CG", "cycle_iters": 2,'
    ' "max_iters": 100, "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
    ' "monitor_residual": 1, "norm": "L2", "max_levels": 100,'
    ' "presweeps": 1, "postsweeps": 1,'
    ' "smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}}}'
)

# the bench config and its MATRIX_FREE form with every Galerkin product
# planned for a values-only resetup
REUSE = '"cycle": "V", "structure_reuse_levels": -1,'
REUSE_CFG = BENCH_CFG.replace('"cycle": "V",', REUSE)
MF_REUSE_CFG = MF_CFG.replace('"cycle": "V",', REUSE)


def convection_diffusion_3d(n, peclet=20.0, velocity=(1.0, 0.5, 0.25)):
    """-Lap(u) + c . grad(u) on an n^3 grid, first-order upwind, 7
    points (the 3D form of tests/test_nonsymmetric.py's operator), with
    c = velocity x peclet: nonsymmetric, x fastest.  At n = 108 it has
    the size and stencil of SuiteSparse's atmosmodd (1,270,432 rows)."""
    import scipy.sparse as sps

    h = 1.0 / (n + 1)
    c = [peclet * v for v in velocity]
    main = 6.0 + h * sum(abs(v) for v in c)
    one = np.ones(n)
    eye = sps.eye_array(n, format="csr")

    def axis(v, diag):
        lo = -1.0 - h * max(v, 0.0)
        hi = -1.0 + h * min(v, 0.0)
        return sps.diags_array([lo * one[1:], diag * one, hi * one[1:]],
                               offsets=[-1, 0, 1], format="csr")

    A = (sps.kron(eye, sps.kron(eye, axis(c[0], main)))
         + sps.kron(eye, sps.kron(axis(c[1], 0.0), eye))
         + sps.kron(axis(c[2], 0.0), sps.kron(eye, eye))).tocsr()
    A.eliminate_zeros()
    A.sort_indices()
    return A


def classical_cfg(amg_extra="", main_extra=""):
    """PCG_CLASSICAL with ``amg_extra`` keys in its AMG scope and
    ``main_extra`` in the outer one."""
    return PCG_CLASSICAL.replace(
        '"monitor_residual": 0,', f'"monitor_residual": 0{amg_extra},', 1
    ).replace('"norm": "L2",', f'"norm": "L2"{main_extra},', 1)


SLICE_N = 128
# the grid of the kernel phase's 19-point and wide-x stencil cases
WIDE_N = 64

# Data-sheet peaks (NVIDIA, dense, without sparsity): memory bytes/s,
# float32 and float64 FLOP/s outside the tensor cores.  Matched on the
# card's name.
PEAKS = (
    ("H100 PCIe", {"bw": 2.0e12, "f32": 51.2e12, "f64": 25.6e12}),
    ("H100 NVL", {"bw": 3.9e12, "f32": 60.0e12, "f64": 30.0e12}),
    ("H100", {"bw": 3.35e12, "f32": 67.0e12, "f64": 34.0e12}),
)

# what the profiler names each kernel's launches
ACTIVITY = {"dia_spmv": "dia_spmv_kernel", "ell_spmv": "ell_spmv_kernel",
            "sell_spmv": "sell_spmv_kernel", "stencil_spmv": "stencil_",
            # the batched sliced entry's two kernels: the copy of x, then
            # the product
            "sell_spmv_batched": ("batch_tiles_kernel",
                                  "sell_spmv_batched_kernel")}

# kernel-vs-plain tolerance on max|y_kernel - y_plain| / max|y_plain|:
# both sum in the same order from +0.0; the kernel contracts each
# multiply-add into one FMA, the plain version rounds twice.  Complex:
# the kernel rounds each real operation of a term on its own, torch's
# complex product may contract to an FMA
TOL = {"float32": 1e-5, "float64": 1e-13, "complex64": 1e-5,
       "complex128": 1e-13}


def timed(name, fn, *args):
    """``fn(*args)``, printing its seconds on a ``phase_s`` line with
    the seconds of them it waited for runs of :data:`CPU`."""
    t0, w0 = time.perf_counter(), CPU.wait_s
    out = fn(*args)
    print(json.dumps({"phase_s": {name: time.perf_counter() - t0},
                      "cpu_side_wait_s": CPU.wait_s - w0}), flush=True)
    return out


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def peaks_for(name):
    for key, p in PEAKS:
        if key in name:
            return p
    raise RuntimeError(f"no data-sheet peaks for card {name!r}")


# the sleep before a timed burst: 2.5 times the host's enqueue of the
# burst (the warm-up call's host seconds, a launch each), within
# 10-120 ms; cycles at the H100's 1.98 GHz boost clock, so that a lower
# clock only lengthens it
TIMER_SPIN_HZ = 1.98e9


class Timer:
    """Device time of one call from CUDA events: the device is kept busy
    by a sleep kernel while the host enqueues (sized from the warm-up
    call's host seconds), so host overhead between launches does not
    show.  Before each launch a read of a 128 MiB
    buffer (a sum of it) evicts the 50 MB L2, as the main path finds
    these operands cold; being a read, it leaves only clean lines, so no
    write-back of an earlier launch's output falls inside the timed
    window (``flush=False`` leaves the operands of the previous launch
    in L2)."""

    def __init__(self, torch, reps=25):
        self.torch = torch
        self.reps = reps
        self.flush = torch.zeros(32 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, flush=True):
        torch = self.torch
        t0 = time.perf_counter()
        fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(self.reps)]
        spin_s = min(max(2.5 * self.reps * enqueue_s, 0.01), 0.12)
        torch.cuda._sleep(int(spin_s * TIMER_SPIN_HZ))
        for s, e in ev:
            if flush:
                self.flush.sum()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in ev]))

    def device(self, fn, activity, attempts=3):
        """Device time of one call without its launch: the median over
        ``reps`` calls, each after the L2 flush, of the duration the
        profiler (CUPTI) records for the one kernel or copy ``fn`` runs,
        whose name holds ``activity`` (a tuple: the sum of one kernel of
        each name a call).  A profile that does not hold one such
        activity per call is taken again, up to ``attempts`` in all;
        then None: CUPTI at times records no activity at all for a whole
        process (PERF.md, section 7); a line before the kernel summary
        lists every device time that was not measured."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        for _ in range(attempts):
            with warnings.catch_warnings():
                # the profiler's notice that it keeps one cycle of events
                warnings.simplefilter("ignore", UserWarning)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(self.reps):
                        self.flush.sum()
                        fn()
                    torch.cuda.synchronize()
            names = activity if isinstance(activity, tuple) else (activity,)
            durs = [[e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA and a in e.name]
                    for a in names]
            if all(len(d) == self.reps for d in durs):
                return float(np.median(np.sum(durs, axis=0))) / 1e3
        return None


def rel_err(y, yp):
    """(max |y - yp|, that over max |yp|)."""
    err = float((y - yp).abs().max()) if y.numel() else 0.0
    scale = float(yp.abs().max()) if y.numel() else 0.0
    return err, (err / scale if scale > 0 else err)


def kernel_case(torch, timer, peaks, name, label, run, plain, csr, nbytes,
                nops, dtype, extra=None, others=()):
    """Compare one kernel with its plain version on the card (and with
    each ``(name, fn)`` of ``others``, the plain versions of other
    layouts of the same matrix), time the kernel, the plain version and
    the library CSR product, and return the case's record (``extra``
    adds fields to it)."""
    y = run()
    yp = plain()
    torch.cuda.synchronize()
    check(y.shape == yp.shape, f"{label}: shape {y.shape} vs {yp.shape}")
    check(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
    err, rel = rel_err(y, yp)
    tol = TOL[str(dtype).replace("torch.", "")]
    check(rel <= tol, f"{label}: kernel vs plain rel err {rel:.3e} > {tol}")
    vs_others = {}
    for oname, fn in others:
        _, orel = rel_err(y, fn())
        vs_others[f"max_rel_err_vs_{oname}"] = orel
        check(orel <= tol,
              f"{label}: kernel vs {oname} rel err {orel:.3e} > {tol}")
    ro, ci, vals, shape, x = csr
    with warnings.catch_warnings():
        # torch.sparse's beta and invariant-check notices
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_csr_tensor(ro, ci, vals, size=shape,
                                    check_invariants=True)
    yl = torch.mv(A, x)
    torch.cuda.synchronize()
    lib_err = float((yl - yp).abs().max()) if y.numel() else 0.0
    kind = "f64" if dtype == torch.float64 else "f32"
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = nops / peaks[kind] * 1e3
    rec = {
        "case": label, "kernel": name, "dtype": kind,
        "max_abs_err": err, "max_rel_err": rel, "tol": tol,
        "library_max_abs_err": lib_err,
        "kernel_ms": timer(run), "kernel_ms_warm_l2": timer(run, flush=False),
        "kernel_device_ms": timer.device(run, ACTIVITY[name]),
        "plain_ms": timer(plain),
        "library_ms": timer(lambda: torch.mv(A, x)),
        "bytes": int(nbytes), "ops": int(nops),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        **vs_others, **(extra or {}),
    }
    print(json.dumps(rec), flush=True)
    return rec


def csr_of(torch, sp, dtype):
    sp = sp.tocsr()
    return (
        torch.from_numpy(sp.indptr.astype(np.int32)).cuda(),
        torch.from_numpy(sp.indices.astype(np.int32)).cuda(),
        torch.from_numpy(sp.data.astype(dtype)).cuda(),
        sp.shape,
    )


def stencil_scipy(grid, steps, coefs):
    """CSR matrix of a constant stencil on ``grid`` (nx, ny, nz), x
    fastest: row i holds ``coefs[k]`` at column i + dx + nx dy + nx ny
    dz for each ``steps[k]`` = (dx, dy, dz) whose neighbour lies inside
    the grid."""
    import scipy.sparse as sps

    nx, ny, nz = grid
    n = nx * ny * nz
    i = np.arange(n, dtype=np.int64)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    offs = np.array([dx + nx * dy + nx * ny * dz for dx, dy, dz in steps])
    order = np.argsort(offs, kind="stable")
    # (n, k) in ascending column order within each row: CSR directly
    inside = np.empty((n, len(steps)), dtype=bool)
    for j, k in enumerate(order):
        dx, dy, dz = steps[k]
        inside[:, j] = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                        & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(inside.sum(axis=1), out=indptr[1:])
    cols = (i[:, None] + offs[order][None, :])[inside]
    vals = np.broadcast_to(np.asarray(coefs, dtype=np.float64)[order],
                           inside.shape)[inside]
    return sps.csr_matrix((vals, cols, indptr), shape=(n, n))


def sell_info(S, entries):
    """The sliced layout's plan and size: window, lanes, slices, stored
    slots (slice padding included) and their ratio to the matrix's
    stored CSR entries, device bytes (beside the slot-major arrays)."""
    return {"sigma": S.sigma, "lanes": S.lanes, "slices": S.n_slices,
            "stored": S.stored,
            "stored_per_entry": S.stored / max(entries, 1),
            "bytes": S.nbytes()}


def ell_kernel_case(torch, timer, peaks, rng, label, sp, dtype,
                    extra=None, sweep=False, A=None, slot_major=True):
    """The ELL kernels on the scipy matrix ``sp`` with a random x from
    ``rng``: the slot-major ``ell_spmv``, and where the upload builds
    the sliced layout ``sell_spmv`` too, each against the plain
    versions of both layouts.  ``A`` (an ELL matrix on the card holding
    ``sp``, such as a hierarchy's operator) takes the place of the
    upload.  Returns the case records.  The bound counts the operator's
    nonzeros (a column index and a value each, x and y once), not the
    slots a kernel reads: ``padded_bytes`` gives those.  ``sweep`` adds
    the sliced kernel's time at every lane count and at every window
    the layout may take.  ``slot_major`` False leaves out the
    ``ell_spmv`` case where the sliced layout exists (the sliced kernel
    is still held to both plain versions)."""
    import dataclasses

    from amgx_tpu_torch.core import matrix as cm
    from amgx_tpu_torch.ops import ell

    if A is None:
        A = cm.SparseMatrix.from_scipy(sp.astype(dtype), device="cuda",
                                       accel_formats=("ell",))
    check(A.has_ell, f"{label}: not ELL")
    x = torch.from_numpy(rng.standard_normal(A.n_cols).astype(dtype))
    x = x.cuda()
    w, n = A.ell_vals.shape
    isz = A.ell_vals.element_size()
    nz = int(sp.count_nonzero())
    csr = (*csr_of(torch, sp, dtype), x)
    nbytes = (4 + isz) * nz + isz * (n + A.n_cols)
    S = A.sell

    def slot_plain():
        return ell.ell_spmv_plain(A.ell_cols, A.ell_vals, x)

    def sell_plain():
        return ell.sell_spmv_plain(S, x)

    recs = [] if S is not None and not slot_major else [kernel_case(
        torch, timer, peaks, "ell_spmv", label,
        lambda: ell.ell_spmv(A.ell_cols, A.ell_vals, x), slot_plain, csr,
        nbytes=nbytes, nops=2 * nz, dtype=A.ell_vals.dtype,
        extra={"nonzeros": nz, "width": w,
               "padded_bytes": (4 + isz) * w * n + isz * (n + A.n_cols),
               **(extra or {})},
        others=() if S is None else (("sell_spmv_plain", sell_plain),),
    )]
    if S is None:
        return recs
    info = sell_info(S, A.nnz)
    more = {}
    if sweep:
        lanes = {f"lanes={k}": timer(lambda k=k: ell.sell_spmv(
            dataclasses.replace(S, lanes=k), x)) for k in (1, 2, 4, 8)}
        windows = {}
        ro, ci, vals = A._host
        for sigma in cm.SELL_SIGMAS:
            Ss = cm.sliced_ell(cm._build_sell_np(
                ro, ci, vals, n, w, sigmas=(sigma,), always=True), "cuda")
            Ss.lanes = S.lanes
            windows[f"sigma={sigma}"] = {
                "stored_per_entry": Ss.stored / max(A.nnz, 1),
                "ms": timer(lambda Ss=Ss: ell.sell_spmv(Ss, x))}
            del Ss
        more["sweep"] = {"lanes_at_own_sigma": lanes,
                         "sigma_at_own_lanes": windows}
    slot_ms = recs[0]["kernel_ms"] if recs else None
    rec = kernel_case(
        torch, timer, peaks, "sell_spmv", label,
        lambda: ell.sell_spmv(S, x), sell_plain, csr,
        nbytes=nbytes, nops=2 * nz, dtype=A.ell_vals.dtype,
        extra={"nonzeros": nz, "width": w,
               "padded_bytes": cm.sell_stream_bytes(
                   S.widths.cpu().numpy(), n, isz, S.sigma)
               + isz * (n + A.n_cols),
               "sell": info, "slot_major_ms": slot_ms, **more,
               **(extra or {})},
        others=(("ell_spmv_plain", slot_plain),),
    )
    # speed targets, printed and not checked
    print(json.dumps({"targets": {
        "case": label, "sell_ms": rec["kernel_ms"],
        "ahead_of_slot_major": (None if slot_ms is None
                                else rec["kernel_ms"] <= slot_ms),
        "ahead_of_library": rec["kernel_ms"] < rec["library_ms"],
        "half_bound": rec["kernel_ms"] <= 2 * rec["bound_ms"]}}),
        flush=True)
    recs.append(rec)
    return recs


def kernel_phase(torch, peaks):
    import scipy.sparse as sps

    from amgx_tpu_torch.amg.aggregation import geo_aggregate
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_scipy
    from amgx_tpu_torch.ops import dia, stencil

    timer = Timer(torch)
    rng = np.random.default_rng(0)
    recs = []

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def dia_plan(A, nd_inst=None):
        """The launch plan the wrapper takes for A (x and y 16-byte
        aligned), printed with the case; ``nd_inst`` the kernel it must
        name."""
        plan = dia.dia_launch_plan(A.n_rows, A.dia_offsets, A.dtype, sms)
        want = 7 if len(A.dia_offsets) == 7 else 0
        check(plan.nd_inst == want and (nd_inst is None
                                        or plan.nd_inst == nd_inst),
              f"DIA plan takes kernel {plan.nd_inst}, not {want}")
        return {k: v for k, v in plan._asdict().items() if k != "offsets"}

    def dia_case(label, sp, dtype, nd_inst=None):
        if dtype == "bfloat16":
            A = SparseMatrix.from_scipy(
                sp.astype(np.float32), device="cuda",
                accel_formats=("dia",)).astype(torch.bfloat16)
            check(A.has_dia, f"{label}: not DIA")
            x = torch.from_numpy(rng.standard_normal(A.n_rows)).cuda().to(
                torch.bfloat16)
            recs.append(variant_case(
                torch, timer, peaks, "dia_spmv_bf16", label, A, x,
                lambda: dia.dia_spmv(A.dia_vals, A.dia_offsets, x),
                lambda: dia.dia_spmv_plain(A.dia_vals, A.dia_offsets, x),
                nbytes=2 * (A.nnz + 2 * A.n_rows) + 4 * len(A.dia_offsets),
                extra={"plan": dia_plan(A, nd_inst)}))
            return
        A = SparseMatrix.from_scipy(sp.astype(dtype), device="cuda",
                                    accel_formats=("dia",))
        check(A.has_dia, f"{label}: not DIA")
        x = torch.from_numpy(rng.standard_normal(A.n_rows).astype(dtype))
        x = x.cuda()
        nd, n = A.dia_vals.shape
        isz = A.dia_vals.element_size()
        nz = int(sp.count_nonzero())
        ro, ci, vals, shape = csr_of(torch, sp, dtype)
        recs.append(kernel_case(
            torch, timer, peaks, "dia_spmv", label,
            lambda: dia.dia_spmv(A.dia_vals, A.dia_offsets, x),
            lambda: dia.dia_spmv_plain(A.dia_vals, A.dia_offsets, x),
            (ro, ci, vals, shape, x),
            nbytes=isz * (nz + 2 * n) + 4 * nd, nops=2 * nz,
            dtype=A.dia_vals.dtype,
            extra={"nonzeros": nz, "diagonals": nd,
                   "plan": dia_plan(A, nd_inst)},
        ))

    def ell_case(label, sp, dtype, ref_ms=None):
        out = ell_kernel_case(torch, timer, peaks, rng, label, sp, dtype)
        if ref_ms is not None:
            # an aggregation shape: no slower than the slot-major time
            # PERF.md records by more than 3 % (printed, not checked)
            ms = out[0]["kernel_ms"]
            print(json.dumps({"targets": {
                "case": label, "ms": ms, "perf_md_ms": ref_ms,
                "within_3_percent": ms <= 1.03 * ref_ms}}), flush=True)
        recs.extend(out)

    def stencil_case(label, sp, dtype, nd_inst=7, meta=None):
        """The stencil kernel against its plain version and, bit for
        bit, against the DIA kernel on the same matrix; the default
        plan must take kernel ``nd_inst``.  ``meta`` (a ``StencilMeta``
        with its coefficients) gives the MATRIX_FREE state of a stencil
        detection does not yield; else it is detected from ``sp``."""
        sp = sp.astype(dtype)
        if meta is None:
            A = SparseMatrix.from_scipy(sp, device="cuda",
                                        accel_formats=("matrix_free",))
            check(A.has_matrix_free and A.mf_meta.kind == "const",
                  f"{label}: not a constant stencil")
        else:
            A = types.SimpleNamespace(
                mf_meta=meta[0], n_rows=sp.shape[0],
                mf_coefs=torch.tensor(meta[1], dtype=getattr(
                    torch, np.dtype(dtype).name), device="cuda"))
        D = SparseMatrix.from_scipy(sp, device="cuda",
                                    accel_formats=("dia",))
        check(D.has_dia, f"{label}: not DIA")
        check(D.dia_offsets == A.mf_meta.offsets,
              f"{label}: DIA offsets {D.dia_offsets} vs stencil "
              f"{A.mf_meta.offsets}")
        x = torch.from_numpy(rng.standard_normal(A.n_rows).astype(dtype))
        x = x.cuda()
        nd, n = len(A.mf_meta.steps), A.n_rows
        isz = A.mf_coefs.element_size()

        def run_dia():
            return dia.dia_spmv(D.dia_vals, D.dia_offsets, x)

        y_dia = run_dia()
        y_st = stencil.stencil_spmv(A, x)
        torch.cuda.synchronize()
        d = float((y_st - y_dia).abs().max())
        check(d == 0.0 and torch.equal(y_st, y_dia),
              f"{label}: stencil vs DIA kernel max diff {d:.3e}")
        # the plan the wrapper launched with (x is 16-byte aligned)
        plan = stencil.stencil_launch_plan(A.mf_meta.grid, A.mf_meta.steps,
                                           16 // isz, sms)
        check(plan.nd_inst == nd_inst,
              f"{label}: plan takes kernel {plan.nd_inst}, not {nd_inst}")
        # a copy of x: the bytes of the bound, moved by a stock kernel
        xc = torch.empty_like(x)

        def copy():
            return xc.copy_(x)

        ro, ci, vals, shape = csr_of(torch, sp, dtype)
        recs.append(kernel_case(
            torch, timer, peaks, "stencil_spmv", label,
            lambda: stencil.stencil_spmv(A, x),
            lambda: stencil.stencil_spmv_plain(A.mf_meta, A.mf_coefs, x),
            (ro, ci, vals, shape, x),
            nbytes=isz * 2 * n + 16 * nd,
            nops=2 * int(sp.count_nonzero()),
            dtype=A.mf_coefs.dtype,
            extra={"grid": list(A.mf_meta.grid), "diagonals": nd,
                   "plan": plan._asdict(),
                   "max_abs_diff_vs_dia_kernel": d,
                   "dia_kernel_ms": timer(run_dia),
                   "dia_kernel_ms_warm_l2": timer(run_dia, flush=False),
                   "dia_kernel_device_ms": timer.device(
                       run_dia, ACTIVITY["dia_spmv"]),
                   "copy_ms": timer(copy),
                   "copy_ms_warm_l2": timer(copy, flush=False),
                   "copy_device_ms": timer.device(copy, "Memcpy DtoD")},
        ))

    # the floor of one event-bracketed launch: a kernel that does nothing
    print(json.dumps({"timer_floor": {
        "ms": timer(lambda: torch.cuda._sleep(0)),
        "ms_warm_l2": timer(lambda: torch.cuda._sleep(0), flush=False),
        "device_ms": timer.device(lambda: torch.cuda._sleep(0),
                                  "spin_kernel")}}),
        flush=True)

    N = SLICE_N
    A0 = poisson_scipy((N, N, N))
    dia_case(f"level0 A {N}^3 f32", A0, np.float32)
    dia_case(f"level0 A {N}^3 f64", A0, np.float64)
    # the gmres_ilu0 path's operator: nonsymmetric, 7 diagonals, f64
    dia_case("convection-diffusion 108^3 f64", convection_diffusion_3d(108),
             np.float64)
    stencil_case(f"level0 A {N}^3 f32", A0, np.float32)
    stencil_case(f"level0 A {N}^3 f64", A0, np.float64)
    # the bf16 stencil kernel here too, early in the process: after a
    # large trace the profiler at times records no kernel (PERF.md)
    S = SparseMatrix.from_scipy(
        A0.astype(np.float32), device="cuda",
        accel_formats=("matrix_free",)).astype(torch.bfloat16)
    check(S.has_matrix_free, "bf16 level 0 not MATRIX_FREE")
    xs = torch.from_numpy(rng.standard_normal(S.n_rows)).cuda().to(
        torch.bfloat16)
    recs.append(variant_case(
        torch, timer, peaks, "stencil_spmv_bf16",
        f"level0 A {N}^3 bf16 (MATRIX_FREE)", S, xs,
        lambda: stencil.stencil_spmv(S, xs),
        lambda: stencil.stencil_spmv_plain(S.mf_meta, S.mf_coefs, xs),
        nbytes=2 * 2 * S.n_rows + 2 * len(S.mf_meta.steps)))
    del A0, S, xs
    # poisson_scipy's last axis is the grid's fastest (x); levels 1-4 of
    # the bench hierarchy are the 64^3 ... 8^3 grids
    for lv, m in ((1, 64), (2, 32), (3, 16), (4, 8)):
        stencil_case(f"level{lv} A {m}^3 ({m ** 3} rows) f32",
                     poisson_scipy((m, m, m)), np.float32)
    stencil_case("thin grid 5x3x40 f32", poisson_scipy((40, 3, 5)),
                 np.float32)
    stencil_case("one plane 40x30x1 (5-point, runtime count) f32",
                 poisson_scipy((30, 40)), np.float32, nd_inst=0)
    stencil_case("unaligned grid 17x23x31 f32",
                 poisson_scipy((31, 23, 17)), np.float32)
    stencil_case("multi-block grid 64x32x16 f32",
                 poisson_scipy((16, 32, 64)), np.float32)
    ones3 = sps.diags_array([np.ones(63), np.ones(64), np.ones(63)],
                            offsets=[-1, 0, 1], format="csr")
    stencil_case("27-point grid 64^3 f32",
                 sps.kron(sps.kron(ones3, ones3), ones3, format="csr"),
                 np.float32, nd_inst=27)
    # realistic stencils other than the star: the 19-point Laplacian on
    # the box-subset tile kernel; the 2D 5-point one on 2,097,152 rows
    # and a 7-point stencil two points wide along x (no detected grid
    # has it) on the runtime-count kernel.  The two 3D ones at
    # WIDE_N^3 (128^3 until the faults_telemetry phase joined: building
    # their matrices on the host took 20 s; the kernel each takes does
    # not depend on the grid)
    stencil_case("2D 5-point 2048x1024 (runtime count) f32",
                 poisson_scipy((1024, 2048)), np.float32, nd_inst=0)
    M = WIDE_N
    box = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]
    nineteen = [st for st in box if sum(map(abs, st)) <= 2]
    stencil_case(f"19-point {M}^3 f32",
                 stencil_scipy((M, M, M), nineteen,
                               [-1.0] * 9 + [18.0] + [-1.0] * 9),
                 np.float32, nd_inst=27)
    wide = [(0, 0, -1), (-2, 0, 0), (-1, 0, 0), (0, 0, 0), (1, 0, 0),
            (2, 0, 0), (0, 0, 1)]
    coefs = [-1.0, 0.0625, -1.25, 4.375, -1.25, 0.0625, -1.0]
    offsets = tuple(dx + M * dy + M * M * dz for dx, dy, dz in wide)
    stencil_case(f"wide-x 7-point {M}^3 (runtime count) f32",
                 stencil_scipy((M, M, M), wide, coefs), np.float32,
                 nd_inst=0,
                 meta=(stencil.StencilMeta("const", (M, M, M),
                                           tuple(wide), offsets),
                       np.asarray(coefs, dtype=np.float32)))

    n = 5000
    offs = (-301, -7, 0, 7, 301)
    rows, cols, vals = [], [], []
    for o in offs:
        r = np.arange(max(0, -o), n - max(0, o))
        rows.append(r)
        cols.append(r + o)
        vals.append(rng.standard_normal(r.shape[0]))
    unaligned = sps.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    ).tocsr()
    dia_case("unaligned offsets n=5000 f32", unaligned, np.float32)
    dia_case("level4 A 8^3 (512 rows) f32", poisson_scipy((8, 8, 8)),
             np.float32)
    # where the launches fall: the bench hierarchy's levels 1-2, a
    # SIZE_2 level of FGMRES_AGGREGATION (2x1x1 aggregates halve x
    # first), rows not a multiple of 8 (odd: one row a thread; 2 mod 4:
    # two), the runtime-count kernel at 27 and 48 diagonals
    for lv, m in ((1, 64), (2, 32)):
        dia_case(f"level{lv} A {m}^3 ({m ** 3} rows) f32",
                 poisson_scipy((m, m, m)), np.float32, nd_inst=7)
    dia_case("SIZE_2 level1 A 64x128x128 (1048576 rows) f32",
             poisson_scipy((128, 128, 64)), np.float32, nd_inst=7)
    dia_case("odd rows 127^3 (2048383) f32", poisson_scipy((127,) * 3),
             np.float32)
    dia_case("rows 2 mod 4 130x127x127 (2096770) bf16",
             poisson_scipy((127, 127, 130)), "bfloat16")
    dia_case("27 diagonals 64^3 (runtime count) f32",
             sps.kron(sps.kron(ones3, ones3), ones3, format="csr"),
             np.float32, nd_inst=0)
    pool = np.setdiff1d(np.arange(-3000, 3001), [0])
    offs48 = np.sort(np.append(rng.choice(pool, 47, replace=False), 0))
    dia_case("48 diagonals 262144 rows (runtime count) f32",
             sps.diags_array([rng.uniform(0.5, 1.5, 262144 - abs(o))
                              for o in offs48], offsets=list(offs48),
                             shape=(262144, 262144), format="csr"),
             np.float32, nd_inst=0)
    for n, offs in ((1 << 21, (-16384, -128, -1, 0, 1, 128, 16384)),
                    (2096770, (-16385, -131, -9, -1, 0, 1, 5, 130, 16384)),
                    (4097, (-129, -7, -1, 0, 1, 3, 130))):
        recs.append(dia_bf16_edge_case(torch, rng, n, offs, sms))

    # level-0 transfers of the bench hierarchy: geometric 2x2x2
    # aggregates numbered lexicographically (amg/aggregation.py)
    agg = geo_aggregate(N, N, N, 3)
    nf, nc = agg.shape[0], int(agg.max()) + 1
    P = sps.csr_matrix((np.ones(nf), (np.arange(nf), agg)), shape=(nf, nc))
    ell_case(f"level0 P {nf}x{nc} w=1 f32", P, np.float32, 0.014752)
    ell_case(f"level0 R {nc}x{nf} w=8 f32", P.T.tocsr(), np.float32,
             0.013600)
    # and of the FGMRES_AGGREGATION hierarchy: SIZE_2, 2x1x1 aggregates
    agg = geo_aggregate(N, N, N, 1)
    nc = int(agg.max()) + 1
    P = sps.csr_matrix((np.ones(nf), (np.arange(nf), agg)), shape=(nf, nc))
    ell_case(f"level0 SIZE_2 P {nf}x{nc} w=1 f32", P, np.float32, 0.015552)
    ell_case(f"level0 SIZE_2 R {nc}x{nf} w=2 f32", P.T.tocsr(), np.float32,
             0.014560)
    del P, agg

    m, k = 30000, 7000
    lens = rng.integers(0, 6, m)
    lens[rng.random(m) < 0.2] = 0  # empty rows
    r = np.repeat(np.arange(m), lens)
    c = rng.integers(0, k, r.shape[0])
    rect = sps.csr_matrix((rng.standard_normal(r.shape[0]), (r, c)),
                          shape=(m, k))
    rect.sum_duplicates()
    ell_case(f"random rect {m}x{k} empty rows f32", rect, np.float32)
    sell_edge_cases(torch, rng)
    recs += serve_kernel_cases(torch, timer, peaks, rng)
    return recs


def sell_edge_cases(torch, rng):
    """The sliced kernel on layouts built whether or not the upload
    would take them, at every window and lane count, against the plain
    versions of both layouts (untimed): n not a multiple of 32 with
    empty rows and rows up to 128 entries, a single row of width 128,
    uniform widths 1, 2 and 8, rectangular, f32 and f64."""
    import scipy.sparse as sps

    from amgx_tpu_torch.amg.aggregation import geo_aggregate
    from amgx_tpu_torch.core import matrix as cm
    from amgx_tpu_torch.ops import ell

    def rand(m, k, top):
        lens = rng.integers(0, top + 1, m)
        lens[rng.random(m) < 0.2] = 0
        r = np.repeat(np.arange(m), lens)
        c = rng.integers(0, k, r.shape[0])
        sp = sps.csr_matrix((rng.standard_normal(r.shape[0]), (r, c)),
                            shape=(m, k))
        sp.sum_duplicates()
        return sp

    def transfer(mode):
        agg = geo_aggregate(16, 16, 16, mode)
        return sps.csr_matrix((np.ones(agg.shape[0]),
                               (np.arange(agg.shape[0]), agg)))

    P = transfer(3)
    cases = [("1007 rows, widths 0-128, empty rows", rand(1007, 1007, 128)),
             ("rect 3001x700, widths 0-40", rand(3001, 700, 40)),
             ("one row of width 128", sps.csr_matrix(
                 (rng.standard_normal(128), (np.zeros(128, int),
                                             np.arange(128))),
                 shape=(1, 500))),
             ("uniform w=1 (P 16^3)", P), ("uniform w=8 (R 16^3)",
                                           P.T.tocsr()),
             ("uniform w=2 (SIZE_2 R 16^3)", transfer(1).T.tocsr())]
    out = []
    for label, sp in cases:
        for dtype in (np.float32, np.float64):
            sp = sp.astype(dtype)
            sp.sort_indices()
            A = cm.SparseMatrix.from_scipy(sp, device="cuda",
                                           accel_formats=("ell",))
            check(A.has_ell, f"{label}: not ELL")
            w, n = A.ell_vals.shape
            x = torch.from_numpy(rng.standard_normal(A.n_cols).astype(dtype))
            x = x.cuda()
            yp = ell.ell_spmv_plain(A.ell_cols, A.ell_vals, x)
            tol = TOL[np.dtype(dtype).name]
            for sigma in cm.SELL_SIGMAS:
                S = cm.sliced_ell(cm._build_sell_np(
                    *A._host, n, w, sigmas=(sigma,), always=True), "cuda")
                ys = ell.sell_spmv_plain(S, x)
                check(torch.equal(ys, yp),
                      f"{label} sigma {sigma}: sliced plain != slot-major")
                for lanes in (1, 2, 4, 8):
                    S.lanes = lanes
                    y = ell.sell_spmv(S, x)
                    torch.cuda.synchronize()
                    _, rel = rel_err(y, yp)
                    out.append(rel)
                    check(rel <= tol, f"{label} {np.dtype(dtype).name} "
                          f"sigma {sigma} lanes {lanes}: rel err {rel:.3e}")
                    if lanes == 1:
                        # one lane a row sums as the slot-major kernel
                        yk = ell.ell_spmv(A.ell_cols, A.ell_vals, x)
                        check(torch.equal(y, yk), f"{label} sigma {sigma}: "
                              "one lane a row differs from ell_spmv")
    print(json.dumps({"sell_edge_cases": {
        "checked": len(out), "max_rel_err": max(out)}}), flush=True)


def solve_on(device, cfg_str, n, dtype, accel_formats=None, info=None):
    """Upload + setup + solve through the port's entry points; returns
    (solver, result, setup_s, b, upload_s).  ``accel_formats``
    (default: the matrix's default formats) is the uploaded matrix's;
    the upload time includes its DIA build or stencil detection.  On
    the card, ``info`` (a dict) receives ``setup_peak_bytes``, the
    peak device memory allocated during setup."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.io.poisson import poisson_3d_7pt, poisson_rhs

    kw = {} if accel_formats is None else {"accel_formats": accel_formats}
    t0 = time.perf_counter()
    A = poisson_3d_7pt(n, dtype=dtype, device=device, **kw)
    upload_s = time.perf_counter() - t0
    b = poisson_rhs(A.n_rows, dtype=dtype)
    if info is not None and device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = T.create_solver(T.AMGConfig.from_string(cfg_str), "default",
                        device=device)
    s.setup(A)
    setup_s = time.perf_counter() - t0
    if info is not None and device == "cuda":
        info["setup_peak_bytes"] = torch.cuda.max_memory_allocated()
    res = s.solve(b)
    return s, res, setup_s, b, upload_s


def true_rel_residual(n, b, x):
    from amgx_tpu_torch.io.poisson import poisson_scipy

    A = poisson_scipy((n, n, n))
    b64 = b.astype(np.float64)
    r = b64 - A @ x.astype(np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b64))


def cpu_solve(cfg_str, n, dtype, accel_formats=None, p_structure=False):
    """The CPU port's :func:`solve_on` as plain data (what a phase holds
    the card's run to, from :data:`CPU`): status, iterations, x, the
    monitored and true residuals, seconds; of an AMG hierarchy (the
    solver's or its preconditioner's) each level's rows and nonzeros,
    smoother colours and Chebyshev bounds, and with ``p_structure`` each
    P's CSR structure; a colouring preconditioner's colours."""
    s, r, setup_s, b, _ = solve_on("cpu", cfg_str, n, dtype, accel_formats)
    x = r.x.numpy()
    amg = s if hasattr(s, "levels") else getattr(s, "precond", None)
    with np.errstate(all="ignore"):
        # (0 / 0 where the solver monitors no residual)
        monitored = monitored_ratio(r)
    out = {"iterations": int(r.iters), "status": int(r.status),
           "setup_s": setup_s, "solve_s": s.solve_time, "x": x,
           "tolerance": s.tolerance, "monitored_rel_residual": monitored,
           "true_rel_residual_f64": true_rel_residual(n, b, x),
           "colors": getattr(amg, "num_colors", None)}
    if hasattr(amg, "levels"):
        smoothers = [lv.smoother for lv in amg.levels]
        out["levels"] = [(lv.n_rows, lv.nnz) for lv in amg.levels]
        out["level_colors"] = [getattr(sm, "num_colors", None)
                               for sm in smoothers]
        out["lmax_lmin"] = [(sm.lmax, sm.lmin) if hasattr(sm, "lmax")
                            else None for sm in smoothers]
        if p_structure:
            out["P"] = [None if lv.P is None else
                        (lv.P.host_csr().indptr, lv.P.host_csr().indices)
                        for lv in amg.levels]
    return out


def trace_solve(torch, s, b, iters, groups=None):
    """Where a warm solve's time goes: one solve under torch.profiler,
    recording the device's activity only (the host's doubles the events
    to read back and slows the solve it watches); device busy time is
    the sum of the kernel and copy intervals on the card, its share is
    taken of the profiled solve's wall time.
    ``groups`` maps a label to name fragments: each device op counts
    under the first label one of whose fragments its name holds (so
    "sell_spmv" goes before "ell_spmv", which it contains), the others
    under "rest".  Prints "not measured" when the profiler
    records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # the profiler's notice that it keeps one cycle of events
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.solve(b)
            wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print(json.dumps({"trace": "not measured"}), flush=True)
        return
    by_name = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_us = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    rec = {
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "device_ops": len(dev),
        "device_ops_per_iteration": len(dev) / max(iters, 1),
        "top": [{"name": n[:80], "ms": t / 1e3, "count": c,
                 "share_of_busy": t / busy_us} for n, (t, c) in top],
    }
    if groups:
        split = {label: [0.0, 0] for label in [*groups, "rest"]}
        for name, (t, c) in by_name.items():
            label = next((k for k, frags in groups.items()
                          if any(f in name for f in frags)), "rest")
            split[label][0] += t / 1e3
            split[label][1] += c
        rec["groups"] = {k: {"ms": t, "count": c}
                         for k, (t, c) in split.items()}
    print(json.dumps({"trace": rec}), flush=True)


def trace_first(torch, s, b, k, groups):
    """:func:`trace_solve` of the first ``k`` iterations of a warm solve
    by ``s`` (its ``max_iters`` set to ``k`` for the trace)."""
    keep = s.max_iters
    s.max_iters = k
    s._cache.clear()
    print(json.dumps({"trace_of": f"the first {k} iterations"}), flush=True)
    try:
        trace_solve(torch, s, b, k, groups=groups)
    finally:
        s.max_iters = keep
        s._cache.clear()


def slice_phase(torch):
    N = SLICE_N
    # ---- the main path: counts zeroed just before, read just after
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on("cuda", BENCH_CFG, N,
                                            np.float32)
    launches = kernel_counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    levels = s.precond.level_summary()
    solve_s = s.solve_time
    # a second solve on the same setup: the first pays one-off costs
    # (cuBLAS/cuSOLVER handles, allocator growth)
    zero_counts()
    t0 = time.perf_counter()
    res2 = s.solve(b)
    block_s = time.perf_counter() - t0
    block_launches = kernel_counts()
    check(int(res2.iters) == iters, "repeat solve changed the iterations")
    warm_s = s.solve_time
    repeat_bitwise = bool(torch.equal(res.x, res2.x))
    async_rec = async_solve_check(torch, s, b, res2, block_s,
                                  block_launches)
    trace_solve(torch, s, b, iters)
    rel = true_rel_residual(N, b, x)
    rec = {
        "slice": f"poisson7 {N}^3 f32 PCG+AMG(SIZE_8,V,BLOCK_JACOBI,"
                 "DENSE_LU) on the card",
        "levels": levels, "iterations": iters, "status": status,
        "upload_s": upload_s, "setup_s": setup_s, "solve_s": solve_s,
        "per_iteration_s": solve_s / max(iters, 1), "solve_warm_s": warm_s,
        "per_iteration_warm_s": warm_s / max(iters, 1),
        "true_rel_residual_f64": rel, "launches": launches,
        "cycle_passes_per_iteration": s.precond.cycle_passes_per_iteration(),
        "repeat_solve_x_bitwise": repeat_bitwise,
        "async_solve": async_rec,
    }
    print(json.dumps(rec), flush=True)
    check(status == 0, f"status {status}")
    check(rel <= 1e-5, f"true relative residual {rel:.3e} > 1e-5")
    check(launches["dia_spmv"] >= 14 * iters,
          f"dia_spmv launches {launches['dia_spmv']} < 14 x {iters}")
    check(launches["ell_spmv"] >= 6 * iters,
          f"ell_spmv launches {launches['ell_spmv']} < 6 x {iters}")
    # the aggregation transfers keep the slot-major layout
    check(launches["sell_spmv"] == 0,
          f"sell_spmv launched {launches['sell_spmv']} times")

    # ---- the same solve through the port on the CPU (plain versions)
    rc = CPU.get(cpu_solve, BENCH_CFG, N, np.float32)
    xc = rc["x"]
    xinf = float(np.abs(xc).max())
    diff = float(np.abs(x - xc).max())
    cpu = {
        "cpu_iterations": rc["iterations"], "cpu_status": rc["status"],
        "cpu_setup_s": rc["setup_s"], "cpu_solve_s": rc["solve_s"],
        "max_abs_diff_vs_cpu": diff, "x_inf": xinf,
    }
    print(json.dumps(cpu), flush=True)
    check(abs(rc["iterations"] - iters) <= 1,
          f"f32 iterations card {iters} vs cpu {rc['iterations']}")
    check(np.allclose(x, xc, rtol=1e-3, atol=1e-5 * xinf),
          f"f32 x card vs cpu: max abs diff {diff:.3e}, |x|inf {xinf:.3e}")

    # ---- 64^3 in f64: iterations equal, x to rtol 1e-9
    _, r64, _, _, _ = solve_on("cuda", BENCH_CFG, 64, np.float64)
    c64 = CPU.get(cpu_solve, BENCH_CFG, 64, np.float64)
    x64, xc64 = r64.x.cpu().numpy(), c64["x"]
    d64 = float(np.abs(x64 - xc64).max())
    print(json.dumps({
        "f64_64^3": {"iterations": int(r64.iters),
                     "cpu_iterations": c64["iterations"],
                     "status": int(r64.status),
                     "max_abs_diff_vs_cpu": d64}}), flush=True)
    check(int(r64.status) == 0, f"64^3 f64 status {r64.status}")
    check(int(r64.iters) == c64["iterations"],
          f"f64 iterations card {r64.iters} vs cpu {c64['iterations']}")
    check(np.allclose(x64, xc64, rtol=1e-9,
                      atol=1e-9 * float(np.abs(xc64).max())),
          f"f64 x card vs cpu: max abs diff {d64:.3e}")

    # ---- the entry() config: 16^3, SIZE_2, max_iters 20, f32
    se, re_, _, be, _ = solve_on("cuda", ENTRY_CFG, 16, np.float32)
    ce = CPU.get(cpu_solve, ENTRY_CFG, 16, np.float32)
    xe = re_.x.cpu().numpy()
    entry = {"entry_16^3": {
        "iterations": int(re_.iters), "cpu_iterations": ce["iterations"],
        "status": int(re_.status), "levels": se.precond.level_summary(),
        "true_rel_residual_f64": true_rel_residual(16, be, xe)}}
    print(json.dumps(entry), flush=True)
    check(np.all(np.isfinite(xe)), "entry config: non-finite x")
    check(int(re_.status) == 0, f"entry config status {re_.status}")
    check(abs(int(re_.iters) - ce["iterations"]) <= 1,
          f"entry config iterations card {re_.iters} vs cpu "
          f"{ce['iterations']}")
    return launches, {"x": x, "iters": iters, "x_cpu": xc,
                      "x64": x64, "x64_cpu": xc64}


def async_solve_check(torch, s, b, ref, block_s, block_launches):
    """Check a of the async solve: ``s.solve(b, block=False)``, twice
    (the process's first one starts the dispatch worker, whose first
    solve makes its thread's library handles), returns before the loop
    on the dispatch worker ends, and its x is bit for bit the blocking
    solve ``ref``'s, with its iterations and its launches per kernel
    (``block_launches``); the host seconds to return and to ready beside
    the blocking solve's ``block_s``."""
    runs = []
    for _ in range(2):
        zero_counts()
        t0 = time.perf_counter()
        pending = s.solve(b, block=False)
        return_s = time.perf_counter() - t0
        in_flight = not pending._future.done()
        pending._future.result(timeout=600)
        ready_s = time.perf_counter() - t0
        launches = kernel_counts()
        runs.append({
            "return_s": return_s, "ready_s": ready_s,
            "in_flight_at_return": in_flight,
            "iterations": int(pending.iters),
            "x_bitwise_blocking": bool(torch.equal(pending.x, ref.x)),
            "launches": launches})
        check(in_flight, "async solve: the solve had ended at the return")
        check(runs[-1]["iterations"] == int(ref.iters)
              and runs[-1]["x_bitwise_blocking"],
              f"async solve: {runs[-1]['iterations']} iterations, x bit "
              f"for bit {runs[-1]['x_bitwise_blocking']}")
        check(launches == block_launches,
              f"async solve: launches {launches} vs blocking "
              f"{block_launches}")
    return {"first": runs[0], "second": runs[1], "blocking_s": block_s,
            "blocking_launches": block_launches}


def mf_slice_phase(torch, ref):
    """The bench solve with ``matrix_free=1`` on the card, held to the
    DIA slice's results ``ref`` (from :func:`slice_phase`)."""
    N = SLICE_N
    # ---- the main path: counts zeroed just before, read just after
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on("cuda", MF_CFG, N, np.float32,
                                            accel_formats=MF_FORMATS)
    launches = kernel_counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    levels = s.precond.level_summary()
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat MF solve changed the iterations")
    warm_s = s.solve_time
    trace_solve(torch, s, b, iters)
    rel = true_rel_residual(N, b, x)
    passes = s.precond.cycle_passes_per_iteration()
    n_lv = len(levels)
    diff_dia = float(np.abs(x - ref["x"]).max())
    rec = {
        "slice": f"poisson7 {N}^3 f32 PCG+AMG(SIZE_8,V,BLOCK_JACOBI,"
                 "DENSE_LU) matrix_free=1 fused_cycle=1 on the card",
        "levels": levels, "iterations": iters, "status": status,
        "upload_s": upload_s, "setup_s": setup_s, "solve_s": solve_s,
        "per_iteration_s": solve_s / max(iters, 1), "solve_warm_s": warm_s,
        "per_iteration_warm_s": warm_s / max(iters, 1),
        "true_rel_residual_f64": rel, "launches": launches,
        "cycle_passes_per_iteration": passes,
        "dia_slice_iterations": ref["iters"],
        "max_abs_diff_vs_dia_slice": diff_dia,
        "x_bitwise_equal_dia_slice": x.tobytes() == ref["x"].tobytes(),
    }
    print(json.dumps(rec), flush=True)
    check(status == 0, f"MF status {status}")
    check(rel <= 1e-5, f"MF true relative residual {rel:.3e} > 1e-5")
    check(all(lv["format"] == "MATRIX_FREE" for lv in levels),
          f"MF levels {[lv['format'] for lv in levels]}")
    check(launches["stencil_spmv"] >= 14 * iters,
          f"stencil_spmv launches {launches['stencil_spmv']} < 14 x {iters}")
    check(launches["dia_spmv"] == 0,
          f"dia_spmv launched {launches['dia_spmv']} times on the MF path")
    check(launches["ell_spmv"] >= 6 * iters,
          f"ell_spmv launches {launches['ell_spmv']} < 6 x {iters}")
    check(passes == 2 * (n_lv - 1) + 1,
          f"fused cycle passes {passes} != 2({n_lv}-1)+1")
    check(iters == ref["iters"],
          f"MF iterations {iters} vs DIA slice {ref['iters']}")
    check(x.tobytes() == ref["x"].tobytes(),
          f"MF x differs from the DIA slice's x: max {diff_dia:.3e}")

    # ---- the same MF solve through the port on the CPU
    rc = CPU.get(cpu_solve, MF_CFG, N, np.float32, MF_FORMATS)
    xc = rc["x"]
    xinf = float(np.abs(xc).max())
    diff = float(np.abs(x - xc).max())
    print(json.dumps({
        "mf_cpu_iterations": rc["iterations"],
        "mf_cpu_status": rc["status"],
        "mf_cpu_setup_s": rc["setup_s"], "mf_cpu_solve_s": rc["solve_s"],
        "max_abs_diff_vs_cpu": diff, "x_inf": xinf,
        "cpu_x_bitwise_equal_dia_cpu": xc.tobytes() == ref["x_cpu"].tobytes(),
    }), flush=True)
    check(abs(rc["iterations"] - iters) <= 1,
          f"MF f32 iterations card {iters} vs cpu {rc['iterations']}")
    check(np.allclose(x, xc, rtol=1e-3, atol=1e-5 * xinf),
          f"MF f32 x card vs cpu: max abs diff {diff:.3e}")
    check(xc.tobytes() == ref["x_cpu"].tobytes(),
          "MF x on the CPU differs from the DIA x on the CPU")

    # ---- 64^3 in f64 on the card and the CPU (the f64 kernel)
    s64, r64, _, _, _ = solve_on("cuda", MF_CFG, 64, np.float64,
                                 accel_formats=MF_FORMATS)
    c64 = CPU.get(cpu_solve, MF_CFG, 64, np.float64, MF_FORMATS)
    x64, xc64 = r64.x.cpu().numpy(), c64["x"]
    d64 = float(np.abs(x64 - xc64).max())
    print(json.dumps({
        "mf_f64_64^3": {"iterations": int(r64.iters),
                        "cpu_iterations": c64["iterations"],
                        "status": int(r64.status),
                        "max_abs_diff_vs_cpu": d64,
                        "x_bitwise_equal_dia_slice":
                            x64.tobytes() == ref["x64"].tobytes()}}),
          flush=True)
    check(int(r64.status) == 0, f"MF 64^3 f64 status {r64.status}")
    check(all(lv.A.has_matrix_free for lv in s64.precond.levels),
          "MF 64^3 f64: a level is not MATRIX_FREE")
    check(int(r64.iters) == c64["iterations"],
          f"MF f64 iterations card {r64.iters} vs cpu {c64['iterations']}")
    check(np.allclose(x64, xc64, rtol=1e-9,
                      atol=1e-9 * float(np.abs(xc64).max())),
          f"MF f64 x card vs cpu: max abs diff {d64:.3e}")
    return launches


def solver_matrix():
    """(label, config) of the 32^3 card-against-CPU cases: each outer
    solver ported with FGMRES around the bench config's SIZE_8 /
    BLOCK_JACOBI AMG (BICGSTAB takes no preconditioner), each smoother
    ported with it in a PCG + SIZE_2 AMG solve, and FGMRES_AGGREGATION
    colored by PARALLEL_GREEDY."""
    cases = [(f"{name}+AMG(SIZE_8)",
              BENCH_CFG.replace('"solver": "PCG", "max_iters": 100',
                                f'"solver": "{name}", "max_iters": 200'))
             for name in ("GMRES", "PCGF", "PBICGSTAB", "BICGSTAB")]
    pcg_size2 = ENTRY_CFG.replace('"max_iters": 20', '"max_iters": 100')
    for name, extra in (("MULTICOLOR_DILU", ""), ("MULTICOLOR_GS", ""),
                        ("MULTICOLOR_GS", ', "symmetric_GS": 1'),
                        ("GS", ""), ("FIXCOLOR_GS", ""), ("JACOBI_L1", "")):
        label = f"PCG+AMG(SIZE_2,{name}{' symmetric' if extra else ''})"
        cases.append((label, pcg_size2.replace(
            '"solver": "BLOCK_JACOBI",', f'"solver": "{name}"{extra},')))
    cases.append(("FGMRES_AGGREGATION PARALLEL_GREEDY", FGMRES_CFG.replace(
        '"max_levels": 50,',
        '"max_levels": 50, "matrix_coloring_scheme": "PARALLEL_GREEDY",')))
    # the solvers the seventh slice ported: IDRMSYNC as the outer
    # solver around the SIZE_8 AMG (as a smoother, a one-cycle Krylov
    # method inside FGMRES, its iteration count moves with the summation
    # order even in f64: 14-17 on the CPU with 1-8 threads), the other
    # smoothers in the PCG + SIZE_2 AMG, SSTEP_PCG around the SIZE_8
    # AMG, the INEXACT coarse solver and the three scalers
    cases.append(("IDRMSYNC+AMG(SIZE_8)", BENCH_CFG.replace(
        '"solver": "PCG", "max_iters": 100',
        '"solver": "IDRMSYNC", "max_iters": 200')))
    for name, extra in (
            ("CHEBYSHEV_POLY", ""), ("POLYNOMIAL", ""),
            ("KPZ_POLYNOMIAL", ""), ("OPT_POLYNOMIAL", ""),
            ("CF_JACOBI", ""), ("KACZMARZ", "")):
        cases.append((f"PCG+AMG(SIZE_2,{name})", pcg_size2.replace(
            '"solver": "BLOCK_JACOBI",', f'"solver": "{name}"{extra},')))
    cases.append(("SSTEP_PCG(s=4)+AMG(SIZE_8)", BENCH_CFG.replace(
        '"solver": "PCG", "max_iters": 100',
        '"solver": "SSTEP_PCG", "s_step": 4, "max_iters": 200')))
    cases.append(("PCG+AMG(SIZE_8,INEXACT coarse)", BENCH_CFG.replace(
        '"coarse_solver": "DENSE_LU_SOLVER"', '"coarse_solver": "INEXACT"')))
    for scaling in ("DIAGONAL_SYMMETRIC", "BINORMALIZATION",
                    "NBINORMALIZATION"):
        cases.append((f"PCG+AMG(SIZE_8) scaling {scaling}", BENCH_CFG.replace(
            '"monitor_residual": 1,',
            f'"monitor_residual": 1, "scaling": "{scaling}",', 1)))
    # the eighth slice: error_scaling 3-5 on the W-cycle path, 2 on an
    # F-cycle, and the flexible K-cycle on the classical path
    for scaling in (3, 4, 5):
        cases.append((f"PBICGSTAB+AMG(SIZE_8,W,error_scaling {scaling})",
                      PBICGSTAB_AGG_W_CFG.replace(
                          '"error_scaling": 2', f'"error_scaling": {scaling}')))
    cases.append(("PBICGSTAB+AMG(SIZE_8,F,error_scaling 2)",
                  PBICGSTAB_AGG_W_CFG.replace('"cycle": "W"', '"cycle": "F"')))
    cases.append(("AMG(CLASSICAL,CGF)", AMG_CLASSICAL_CG_CFG.replace(
        '"cycle": "CG"', '"cycle": "CGF"')))
    return cases


# the counter each operator format's SpMV adds to (dense: a matmul; an
# ELL operator with its sliced layout: sell_spmv)
FORMAT_COUNTER = {"DIA": "dia_spmv", "ELL": "ell_spmv",
                  "MATRIX_FREE": "stencil_spmv", "CSR": "csr"}
COUNTERS = ("dia_spmv", "ell_spmv", "sell_spmv", "stencil_spmv", "csr")


def kernel_counts():
    """Every kernel wrapper's launch count, and the CSR products."""
    from amgx_tpu_torch.ops import dia, ell, spmv, stencil

    return {"dia_spmv": dia.launches, "ell_spmv": ell.launches,
            "sell_spmv": ell.sell_launches,
            "stencil_spmv": stencil.launches, "csr": spmv.csr_products}


def zero_counts():
    from amgx_tpu_torch.ops import dia, ell, spmv, stencil

    dia.launches = ell.launches = ell.sell_launches = 0
    dia.batched_launches = ell.batched_launches = 0
    ell.sell_batched_launches = 0
    stencil.launches = spmv.csr_products = 0
    for m in (dia, ell, stencil):
        m.variant_launches.clear()


def variant_counts():
    """Launches of every kernel entry point (``dia_spmv_bf16``,
    ``ell_spmv_bf16_f32``, ...) and the CSR products."""
    from amgx_tpu_torch.ops import dia, ell, spmv, stencil

    return {**dia.variant_launches, **ell.variant_launches,
            **stencil.variant_launches, "csr": spmv.csr_products}


def counter_of(m):
    """The counter an operator's SpMV adds to, or None (dense)."""
    if m.format == "ELL" and m.sell is not None:
        return "sell_spmv"
    return FORMAT_COUNTER.get(m.format)


def cycle_walk(amg, sweep_spmvs=1, coarse_spmvs=1):
    """SpMVs of one cycle of the AMG solver ``amg`` per operator, as
    ``{(level, "A" | "P" | "R"): count}``, from a dry walk of the
    cycle's structure in Python (``amg/hierarchy.py:make_cycle``; no
    wrapper's counter is read).  A visit of a level above the coarsest
    makes its presweeps and postsweeps (``sweep_spmvs`` A-SpMVs each),
    its residual, R and P; with ``error_scaling`` 2-3 also
    ``scaling_smoother_steps`` sweeps and one A e, with 4-5 twice
    ``max(postsweeps, 1)`` sweeps, a residual and one A e.  On the
    branch levels (above ``W_MAX_BRANCH_LEVELS`` and the last two) W
    visits the next level twice, F an F then a V visit, and a K-cycle
    runs ``cycle_iters`` (F)CG steps there: one visit and one A-SpMV a
    step (one visit at least).  The coarsest level makes one residual
    before its coarse solve (and ``coarse_spmvs`` - 1 more inside an
    iterative one: :func:`coarse_solve_spmvs`), or its smoothing
    sweeps."""
    from amgx_tpu_torch.amg.hierarchy import W_MAX_BRANCH_LEVELS

    counts = {}
    lv = amg.levels
    last = len(lv) - 1
    es = amg.error_scaling

    def add(i, f, k):
        counts[(i, f)] = counts.get((i, f), 0) + k

    def visit(i, kind):
        if i == last:
            add(i, "A", coarse_spmvs if amg.coarse_solver is not None
                else amg.coarsest_sweeps * sweep_spmvs)
            return
        pre, post = amg._level_sweeps(i)
        add(i, "A", (pre + post) * sweep_spmvs + 1)
        add(i, "R", 1)
        branch = i < min(last - 1, W_MAX_BRANCH_LEVELS)
        if kind == "W" and branch:
            visit(i + 1, "W")
            visit(i + 1, "W")
        elif kind == "F" and branch:
            visit(i + 1, "F")
            visit(i + 1, "V")
        elif kind in ("CG", "CGF") and branch:
            for _ in range(max(amg.cycle_iters, 1)):
                visit(i + 1, kind)
            add(i + 1, "A", amg.cycle_iters)
        else:
            visit(i + 1, kind)
        add(i, "P", 1)
        if es > 3:
            add(i, "A", 2 * max(amg.postsweeps, 1) * sweep_spmvs + 2)
        elif es >= 2:
            add(i, "A", max(amg.scaling_smoother_steps, 0) * sweep_spmvs
                + 1)

    visit(0, amg.cycle_type)
    return counts


def derived_launches(amg, cycles, top, sweep_spmvs=1, setup_spmvs=0):
    """``dia_spmv``, ``ell_spmv``, ``sell_spmv``, ``stencil_spmv``
    launches and CSR products of a setup and solve from its AMG
    hierarchy: ``top`` level-0 A-SpMVs outside the preconditioner and
    ``cycles`` cycles (:func:`cycle_walk`).  Each level with a smoother
    adds ``setup_spmvs`` A-SpMVs made by the smoother's setup (a power
    iteration)."""
    counts = dict.fromkeys(COUNTERS, 0)

    def add(m, k):
        c = counter_of(m)
        if c is not None:
            counts[c] += k

    lv = amg.levels
    add(lv[0].A, top)
    for (i, f), k in cycle_walk(amg, sweep_spmvs).items():
        add(getattr(lv[i], f), cycles * k)
    for lvl in lv:
        if lvl.smoother is not None:
            add(lvl.A, setup_spmvs)
    return counts


def fgmres_derived_launches(s, iters):
    """Launches of an FGMRES solve of ``iters`` iterations: r0 = b - A
    x0 once and one more residual per restart, one A z and one V-cycle
    per iteration."""
    restarts = -(-iters // s.restart)
    return derived_launches(s.precond, iters, restarts + iters)


def pcg_derived_launches(s, iters, **kw):
    """Launches of a PCG solve of ``iters`` iterations: r0 = b - A x0
    and one V-cycle before the loop, one A p and one V-cycle per
    iteration (``kw``: :func:`derived_launches`'s smoother costs)."""
    return derived_launches(s.precond, iters + 1, iters + 1, **kw)


def fgmres_cpu_side(n):
    """The CPU port's FGMRES_AGGREGATION solve at ``n``^3 f32: what the
    phase holds the card's run to."""
    sc, rc, setup_c, _, _ = solve_on("cpu", FGMRES_CFG, n, np.float32)
    return {"iterations": int(rc.iters), "status": int(rc.status),
            "setup_s": setup_c, "solve_s": sc.solve_time, "x": rc.x.numpy(),
            "colors": [lv.smoother.num_colors if lv.smoother else None
                       for lv in sc.precond.levels]}


def fgmres_phase(torch):
    """FGMRES_AGGREGATION (FGMRES + aggregation AMG + MULTICOLOR_DILU)
    at 128^3 f32 on the card, its CPU run, 64^3 f64 on both, a trace of
    the first ``TRACE_ITERS`` iterations of a warm solve, and the 32^3
    solver matrix (the CPU's side from :data:`CPU`)."""
    N = SLICE_N
    # ---- A. the main path: counts zeroed just before, read just after
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on("cuda", FGMRES_CFG, N,
                                            np.float32)
    launches = kernel_counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    levels = s.precond.level_summary()
    colors = [lv.smoother.num_colors if lv.smoother else None
              for lv in s.precond.levels]
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat FGMRES solve changed iterations")
    warm_s = s.solve_time
    derived = fgmres_derived_launches(s, iters)
    rel = true_rel_residual(N, b, x)
    rec = {
        "slice": f"poisson7 {N}^3 f32 FGMRES(10)+AMG(SIZE_2,V,"
                 "MULTICOLOR_DILU x3,DENSE_LU) on the card",
        "levels": [{**lv, "colors": c} for lv, c in zip(levels, colors)],
        "n_levels": len(levels), "iterations": iters, "status": status,
        "upload_s": upload_s, "setup_s": setup_s, "solve_s": solve_s,
        "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": warm_s,
        "ms_per_iteration_warm": warm_s / max(iters, 1) * 1e3,
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
    }
    print(json.dumps(rec), flush=True)
    check(status == 0, f"FGMRES status {status}")
    check(rel <= 1e-5, f"FGMRES true relative residual {rel:.3e} > 1e-5")
    check(all(lv["format"] == "DIA" for lv in levels),
          f"FGMRES levels {[lv['format'] for lv in levels]}")
    for k in ("dia_spmv", "ell_spmv", "sell_spmv"):
        check(launches[k] == derived[k],
              f"FGMRES {k} launches {launches[k]} != derived {derived[k]}")

    # ---- D. a trace of a warm solve's first iterations
    # index_copy_ runs as an index_elementwise_kernel too: its own
    # fragment is tried before the gathers'
    trace_first(torch, s, b, TRACE_ITERS, groups={
        "dia_spmv": ["dia_spmv"], "sell_spmv": ["sell_spmv"],
        "ell_spmv": ["ell_spmv"], "index_copy": ["index_copy"],
        "gather": ["index_elementwise", "gather", "index_select"],
        "reduction": ["reduce_kernel"],
    })
    del s, res, res2

    # ---- B. the same solve through the port on the CPU
    t0 = time.perf_counter()
    rc = CPU.get(fgmres_cpu_side, N)
    wait_s = time.perf_counter() - t0
    xc = rc["x"]
    xinf = float(np.abs(xc).max())
    diff = float(np.abs(x - xc).max())
    colors_c = rc["colors"]
    print(json.dumps({
        "fgmres_cpu_iterations": rc["iterations"],
        "fgmres_cpu_status": rc["status"],
        "fgmres_cpu_setup_s": rc["setup_s"],
        "fgmres_cpu_solve_s": rc["solve_s"], "cpu_side_wait_s": wait_s,
        "max_abs_diff_vs_cpu": diff, "x_inf": xinf,
        "colors_equal_cpu": colors_c == colors}), flush=True)
    check(colors_c == colors, f"colours card {colors} vs cpu {colors_c}")
    check(abs(rc["iterations"] - iters) <= 1,
          f"FGMRES f32 iterations card {iters} vs cpu {rc['iterations']}")
    check(np.allclose(x, xc, rtol=1e-4, atol=1e-4 * xinf),
          f"FGMRES f32 x card vs cpu: max abs diff {diff:.3e}")
    del rc

    # ---- C. 64^3 in f64 on the card and the CPU
    _, r64, _, _, _ = solve_on("cuda", FGMRES_CFG, 64, np.float64)
    c64 = CPU.get(cpu_solve, FGMRES_CFG, 64, np.float64)
    x64, xc64 = r64.x.cpu().numpy(), c64["x"]
    d64 = float(np.abs(x64 - xc64).max())
    print(json.dumps({
        "fgmres_f64_64^3": {"iterations": int(r64.iters),
                            "cpu_iterations": c64["iterations"],
                            "status": int(r64.status),
                            "max_abs_diff_vs_cpu": d64}}), flush=True)
    check(int(r64.status) == 0, f"FGMRES 64^3 f64 status {r64.status}")
    check(int(r64.iters) == c64["iterations"],
          f"FGMRES f64 iterations card {r64.iters} vs cpu "
          f"{c64['iterations']}")
    check(np.allclose(x64, xc64, rtol=1e-9,
                      atol=1e-9 * float(np.abs(xc64).max())),
          f"FGMRES f64 x card vs cpu: max abs diff {d64:.3e}")

    # ---- E. the 32^3 solver matrix, card against CPU
    for label, cfg in solver_matrix():
        t0 = time.perf_counter()
        _, rg, _, bg, _ = solve_on("cuda", cfg, 32, np.float32)
        card_s = time.perf_counter() - t0
        rcpu = CPU.get(cpu_solve, cfg, 32, np.float32)
        ic, stc = rcpu["iterations"], rcpu["status"]
        xg = rg.x.cpu().numpy()
        print(json.dumps({"solver_32^3": {
            "case": label, "iterations": int(rg.iters),
            "cpu_iterations": ic, "status": int(rg.status),
            "cpu_status": stc, "card_s": card_s,
            "true_rel_residual_f64": true_rel_residual(32, bg, xg)}}),
            flush=True)
        check(int(rg.status) == 0 and stc == 0,
              f"{label}: status card {rg.status} cpu {stc}")
        check(abs(int(rg.iters) - ic) <= 1,
              f"{label}: iterations card {rg.iters} vs cpu {ic}")
    return launches


def _width(m):
    return None if m is None or not m.has_ell else int(m.ell_cols.shape[0])


def _sell(m):
    """The sliced layout's plan and size (its device bytes are the
    extra memory it takes beside the slot-major arrays)."""
    if m is None or m.sell is None:
        return None
    return sell_info(m.sell, m.nnz)


def classical_levels(amg):
    """Per level: rows, nnz, format, ELL width and sliced layout of A;
    format, nnz, ELL width, sliced layout and longest row of P and
    R."""
    out = []
    for lvl in amg.levels:
        rec = {"rows": lvl.n_rows, "nnz": lvl.nnz, "format": lvl.A.format,
               "ell_width": _width(lvl.A), "sell": _sell(lvl.A),
               "max_row": int(np.diff(lvl.A._host[0]).max())}
        for f in ("P", "R"):
            m = getattr(lvl, f)
            if m is not None:
                rec[f] = {"format": m.format, "nnz": m.nnz,
                          "ell_width": _width(m), "sell": _sell(m),
                          "max_row": int(np.diff(m._host[0]).max())}
        out.append(rec)
    return out


def levels_bitwise(a, b):
    """None when the hierarchies ``a`` and ``b`` (AMG solvers) hold the
    same A, P and R on every level bit for bit, else where they
    differ."""
    if len(a.levels) != len(b.levels):
        return f"level count {len(a.levels)} vs {len(b.levels)}"
    for la, lb in zip(a.levels, b.levels):
        for f in ("A", "P", "R"):
            ma, mb = getattr(la, f), getattr(lb, f)
            if (ma is None) != (mb is None):
                return f"level {la.level_id} {f} presence"
            if ma is not None and any(
                    x.tobytes() != y.tobytes()
                    for x, y in zip(ma._host, mb._host)):
                return f"level {la.level_id} {f}"
    return None


def card_cf_split(torch, Asp, device):
    """The C/F split of the device pipeline (AHAT strength with the
    config's defaults theta 0.25 and max_row_sum 1.1, PMIS) of the host
    CSR ``Asp``, run on ``device``."""
    from amgx_tpu_torch.amg import device_setup as ds

    A = Asp.tocsr()
    n = A.shape[0]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rows = put(np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr)))
    cols, vals = put(A.indices.astype(np.int64)), put(A.data)
    offsets = put(A.indptr.astype(np.int64))
    strong = ds._strength_ahat_dev(rows, cols, vals, offsets, n, 0.25, 1.1)
    w = ds._pmis_weights(strong, cols, n, vals.dtype, 0, [0.0])
    return ds._pmis_dev(rows, cols, strong, n, w).cpu().numpy()


def shuffled_poisson(m, seed=0):
    """Poisson on an m^3 grid with its unknowns shuffled (no DIA, so
    RCM has a bandwidth to win back)."""
    from amgx_tpu_torch.io.poisson import poisson_scipy

    A = poisson_scipy((m, m, m))
    p = np.random.default_rng(seed).permutation(A.shape[0])
    A = A[p][:, p].tocsr()
    A.sort_indices()
    return A


def torus_poisson(m, seed=0):
    """The 7-point Laplacian of a periodic m^3 grid with its unknowns
    shuffled: every row holds 7 entries, so its upload takes the
    slot-major ELL layout (no DIA, no sliced layout: its slices would all
    be as wide).  Singular (constants are its null space) until
    shifted."""
    import scipy.sparse as sps

    n = m ** 3
    i = np.arange(n)
    ix, iy, iz = i % m, (i // m) % m, i // (m * m)
    rows, cols = [i], [i]
    for d in (1, m, m * m):
        for s in (-1, 1):
            jx = (ix + s) % m if d == 1 else ix
            jy = (iy + s) % m if d == m else iy
            jz = (iz + s) % m if d == m * m else iz
            rows.append(i)
            cols.append(jx + m * (jy + m * jz))
    vals = np.concatenate([np.full(n, 6.0)] + [np.full(n, -1.0)] * 6)
    A = sps.csr_matrix((vals, (np.concatenate(rows), np.concatenate(cols))),
                       shape=(n, n))
    p = np.random.default_rng(seed).permutation(n)
    A = A[p][:, p].tocsr()
    A.sort_indices()
    return A


def irregular_poisson(m, seed=0, frac=0.1, extra=8):
    """:func:`shuffled_poisson` plus the graph Laplacian of random
    long-range couplings (weight 0.25) from a tenth of the unknowns,
    ``extra`` each: symmetric positive definite, unstructured, with rows
    of 4 to some 20 entries, so its upload takes the sliced ELL layout
    (shuffled Poisson alone does not: its rows are too alike)."""
    import scipy.sparse as sps

    A = shuffled_poisson(m, seed)
    n = A.shape[0]
    rng = np.random.default_rng(seed + 1)
    i = np.repeat(rng.choice(n, int(frac * n), replace=False), extra)
    j = rng.integers(0, n, i.size)
    keep = i != j
    W = sps.coo_matrix((np.full(int(keep.sum()), 0.25),
                        (i[keep], j[keep])), shape=(n, n)).tocsr()
    W = W + W.T
    L = sps.diags_array(np.asarray(W.sum(axis=1)).ravel()) - W
    A = (A + L).tocsr()
    A.sort_indices()
    return A


def ell_operators(amg, iters, sweep_spmvs=1, setup_spmvs=0):
    """(label, matrix, launches per PCG setup and solve of ``iters``
    iterations) of every ELL operator of the AMG hierarchy ``amg``, as
    :func:`pcg_derived_launches` counts them."""
    cycles = iters + 1
    walk = cycle_walk(amg, sweep_spmvs)
    out = []
    for lvl in amg.levels:
        i = lvl.level_id
        for f in ("A", "P", "R"):
            m = getattr(lvl, f)
            if m is None or m.format != "ELL":
                continue
            per = cycles * walk.get((i, f), 0)
            if f == "A":
                per += (cycles if i == 0 else 0) + (
                    setup_spmvs if lvl.smoother is not None else 0)
            out.append((f"level{i} {f}", m, per))
    return out


def classical_kernel_cases(torch, timer, peaks, rng, amg, iters):
    """The ELL kernel cases of the classical hierarchy ``amg``: every
    ELL operator in f32 (both kernels, the sliced one also at every
    lane count and window), the level-1 A in f64, and the level-1 A
    renumbered by RCM (``ops/reorder.py``), a measurement only: no
    path renumbers coarse levels."""
    import scipy.sparse as sps

    from amgx_tpu_torch.ops.reorder import rcm_permutation

    recs = []
    ops = ell_operators(amg, iters)
    for label, m, per_solve in ops:
        recs += ell_kernel_case(
            torch, timer, peaks, rng,
            f"classical {label} {m.n_rows}x{m.n_cols} w={_width(m)} f32",
            m.host_csr(), np.float32, sweep=True,
            extra={"launches_per_solve": per_solve})
    for label, m, per_solve in ops:
        if label != "level1 A":
            continue
        sp = m.host_csr()
        recs += ell_kernel_case(
            torch, timer, peaks, rng,
            f"classical {label} {m.n_rows}x{m.n_cols} w={_width(m)} f64",
            sp.astype(np.float64), np.float64,
            extra={"launches_per_solve": "f64 cells"})
        perm = rcm_permutation(sp)
        rcm = sps.csr_matrix(sp[perm][:, perm])
        rcm.sort_indices()
        lens = np.diff(sp.indptr)
        recs += ell_kernel_case(
            torch, timer, peaks, rng,
            f"classical {label} RCM {m.n_rows}x{m.n_cols} f32", rcm,
            np.float32,
            extra={"launches_per_solve": "measurement only",
                   "bandwidth": int(np.abs(
                       rcm.indices - np.repeat(np.arange(rcm.shape[0]),
                                               np.diff(rcm.indptr))).max()),
                   "bandwidth_before": int(np.abs(
                       sp.indices - np.repeat(np.arange(sp.shape[0]),
                                              lens)).max())})
    return recs


def classical_phase(torch, peaks=None, device="cuda", n=SLICE_N,
                    n_cmp=48, n_f64=64, n_small=32, n_cpu=64):
    """PCG_CLASSICAL at ``n``^3 f32 with its setup on ``device`` (the
    main path of this slice), the ELL kernel at its shapes, a trace,
    determinism, the CPU port at ``n_cpu``^3 (against the device's run
    at that size), the hierarchy against the host builder at
    ``n_cmp``^3 f64, ``n_f64``^3 f64 against the CPU, and the other
    selector / interpolator / reordering paths (MULTIPASS at
    ``n_cpu``^3).  ``peaks`` None (a rehearsal on the CPU) skips the
    kernel cases and the trace."""
    from amgx_tpu_torch.amg import classical, device_setup
    from amgx_tpu_torch.ops import spmv

    def device_built(amg, label):
        stats = amg.setup_stats
        check(stats["host_fallback_levels"] == 0,
              f"{label}: {stats['host_fallback_levels']} host fallbacks")
        if device == "cuda":
            check(stats["device_levels"] == len(amg.levels) - 1,
                  f"{label}: {stats['device_levels']} device-built levels "
                  f"of {len(amg.levels) - 1}")

    # ---- 1. the main path: counts zeroed just before, read just after
    info = {}
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on(device, PCG_CLASSICAL, n,
                                            np.float32, info=info)
    launches = kernel_counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    amg = s.precond
    levels = classical_levels(amg)
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat classical solve changed iters")
    warm_s = s.solve_time
    derived = pcg_derived_launches(s, iters)
    rel = true_rel_residual(n, b, x)
    print(json.dumps({
        "slice": f"poisson7 {n}^3 f32 PCG_CLASSICAL_V_JACOBI (PCG + "
                 "classical AMG AHAT/PMIS/D1, V, BLOCK_JACOBI, DENSE_LU) "
                 f"setup and solve on {device}",
        "levels": levels, "n_levels": len(levels), "iterations": iters,
        "status": status, "upload_s": upload_s, "setup_s": setup_s,
        "setup_profile": amg.setup_profile, "setup_stats": amg.setup_stats,
        "setup_peak_bytes": info.get("setup_peak_bytes"),
        "solve_s": solve_s, "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": warm_s,
        "ms_per_iteration_warm": warm_s / max(iters, 1) * 1e3,
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
        "repeat_solve_x_bitwise": bool(torch.equal(res.x, res2.x)),
    }), flush=True)
    check(status == 0, f"classical status {status}")
    check(rel <= 1e-5, f"classical true relative residual {rel:.3e} > 1e-5")
    device_built(amg, "PCG_CLASSICAL")
    for k in launches:
        # (the wrappers count only launches on the card)
        check(launches[k] == derived[k] or device != "cuda",
              f"classical {k} launches {launches[k]} != derived {derived[k]}")
    check(torch.equal(res.x, res2.x), "repeat classical solve changed x")

    recs = []
    if peaks is not None:
        # ---- the ELL kernels at every ELL operator of this hierarchy,
        # with the launches one solve gives each
        timer = Timer(torch)
        rng = np.random.default_rng(1)
        recs += classical_kernel_cases(torch, timer, peaks, rng, amg, iters)
        # the CSR products (P on the levels whose rows are too uneven
        # for the ELL gate): the port's segment sum (torch.segment_reduce
        # on one column) against segment_reduce on 1-D data (CUB),
        # index_add_ (atomics: the sum order changes from run to run)
        # and torch.mv on CSR
        P1 = amg.levels[1].P
        if P1.format == "CSR":
            xr = torch.from_numpy(
                rng.standard_normal(P1.n_cols).astype(np.float32)).cuda()

            def seg():
                return spmv._spmv_scalar(P1, xr)

            def seg_1d():
                c = P1.values * xr[P1.col_indices]
                return torch.segment_reduce(c, "sum", offsets=P1.row_offsets,
                                            unsafe=True)

            def atomics():
                c = P1.values * xr[P1.col_indices]
                y = torch.zeros(P1.n_rows, dtype=c.dtype, device=c.device)
                return y.index_add_(0, P1.row_ids, c)

            ys = [seg() for _ in range(10)]
            ya = [atomics() for _ in range(10)]
            with warnings.catch_warnings():
                # torch.sparse's beta notice
                warnings.simplefilter("ignore", UserWarning)
                lib = torch.sparse_csr_tensor(
                    P1.row_offsets, P1.col_indices, P1.values,
                    size=P1.shape)
            nbytes = 8 * P1.nnz + 4 * (2 * P1.n_rows + 1 + P1.n_cols)
            print(json.dumps({"classical_csr_case": {
                "operator": f"level1 P {P1.n_rows}x{P1.n_cols} "
                            f"nnz={P1.nnz} f32",
                "segment_sum_ms": timer(seg),
                "segment_reduce_1d_ms": timer(seg_1d),
                "index_add_ms": timer(atomics),
                "library_ms": timer(lambda: torch.mv(lib, xr)),
                "bound_ms": nbytes / peaks["bw"] * 1e3,
                "segment_sum_repeats_bitwise": all(
                    torch.equal(ys[0], y) for y in ys),
                "segment_sum_equals_1d": bool(torch.equal(ys[0], seg_1d())),
                "index_add_distinct_results_of_10": len(
                    {y.cpu().numpy().tobytes() for y in ya}),
                "max_abs_diff_vs_index_add": float(
                    (ys[0] - ya[0]).abs().max())}}), flush=True)
            check(all(torch.equal(ys[0], y) for y in ys),
                  "CSR product not bit for bit repeatable")
            del P1, xr, ys, ya, lib
        del timer
        # ---- 7. a traced warm solve
        trace_solve(torch, s, b, iters, groups={
            "dia_spmv": ["dia_spmv"], "sell_spmv": ["sell_spmv"],
            "ell_spmv": ["ell_spmv"], "csr": ["egment"], "dense": ["gemv", "gemm", "dot_kernel"],
            "reduction": ["reduce_kernel"],
        })

    # ---- 2. the CPU port (AUTO: the host builder there) at n_cpu^3,
    # beside the device's run at that size; 3. determinism: a second
    # setup and solve of that size on the same device (at n_cpu^3
    # since the faults_telemetry phase joined: the 128^3 repeat cost
    # 13 s)
    if n_cpu != n:
        del s, res, res2, amg
        s, res, _, b, _ = solve_on(device, PCG_CLASSICAL, n_cpu,
                                   np.float32)
        iters, x = int(res.iters), res.x.cpu().numpy()
        amg = s.precond
    s2, r3, _, _, _ = solve_on(device, PCG_CLASSICAL, n_cpu, np.float32)
    where = levels_bitwise(amg, s2.precond)
    print(json.dumps({"classical_repeat_setup": {
        "n": n_cpu, "hierarchy_bitwise": where is None,
        "first_difference": where,
        "x_bitwise": bool(torch.equal(res.x, r3.x))}}), flush=True)
    check(where is None, f"two classical setups differ at {where}")
    check(torch.equal(res.x, r3.x), "two classical setups gave another x")
    del s, s2, res, r3, amg
    rc = CPU.get(cpu_solve, PCG_CLASSICAL, n_cpu, np.float32)
    xc = rc["x"]
    print(json.dumps({"classical_cpu": {
        "n": n_cpu, "iterations": rc["iterations"], "card_iterations": iters,
        "status": rc["status"], "setup_s": rc["setup_s"],
        "solve_s": rc["solve_s"], "levels": rc["levels"],
        "true_rel_residual_f64": rc["true_rel_residual_f64"],
        "max_abs_diff_vs_card": float(np.abs(x - xc).max()),
        "x_inf": float(np.abs(xc).max())}}), flush=True)
    check(rc["status"] == 0, f"classical cpu status {rc['status']}")
    check(abs(rc["iterations"] - iters) <= 1,
          f"classical f32 iterations card {iters} vs cpu {rc['iterations']}")
    del rc

    # ---- 4. the device pipeline against the host builder, f64: each
    # coarse level of the card's hierarchy built again from the same
    # operator by both.  (The two hierarchies as wholes part from level
    # 2 on: Ac agrees to roundoff, and entries that sit exactly at
    # theta times the row's largest, as -1/3 against 4/3, fall on
    # either side of the strength test; tests/test_torch_device_setup.py
    # shows the JAX package's two builders part the same way at 20^3.)
    import amgx_tpu_torch as T

    sd, _, _, _, _ = solve_on(device, PCG_CLASSICAL, n_cmp, np.float64)
    sh = CPU.get(cpu_solve, PCG_CLASSICAL, n_cmp, np.float64)
    device_built(sd.precond, f"{n_cmp}^3 f64")
    cfg = T.AMGConfig.from_string(PCG_CLASSICAL)
    cmp = []
    for lvl in sd.precond.levels[:-1]:
        Asp = lvl.A.host_csr()
        built = device_setup.build_classical_level_device(
            Asp, cfg, "amg", lvl.level_id, device=device)
        ref = classical.build_classical_level(Asp, cfg, "amg", lvl.level_id)
        rec = {"level": lvl.level_id, "rows": lvl.n_rows,
               "cf_equal": bool(np.array_equal(
                   card_cf_split(torch, Asp, device),
                   classical.pmis_select(
                       classical.strength_ahat(Asp, 0.25, 1.1))))}
        for name, md, mh in zip(("P", "R", "Ac"), built, ref):
            md, mh = md.copy(), mh.copy()
            rec[f"{name}_nnz"], rec[f"{name}_host_nnz"] = md.nnz, mh.nnz
            md.eliminate_zeros()
            mh.eliminate_zeros()
            rec[f"{name}_nonzeros_equal"] = md.shape == mh.shape and (
                (md != 0) != (mh != 0)).nnz == 0
            rec[f"{name}_max_abs_diff"] = (
                float(abs(md - mh).max()) if md.shape == mh.shape
                else None)
        cmp.append(rec)
    print(json.dumps({f"classical_levels_{n_cmp}^3_f64_vs_host": cmp,
                      "card_hierarchy": [(lv.n_rows, lv.nnz)
                                         for lv in sd.precond.levels],
                      "host_hierarchy": sh["levels"]}),
          flush=True)
    for rec in cmp:
        lv = rec["level"]
        check(rec["cf_equal"], f"{n_cmp}^3 level {lv}: C/F split differs")
        for name, tol in (("P", 1e-12), ("R", 1e-12), ("Ac", 1e-11)):
            check(rec[f"{name}_nonzeros_equal"]
                  and rec[f"{name}_max_abs_diff"] <= tol,
                  f"{n_cmp}^3 level {lv}: {name} differs from the host's "
                  f"({rec[f'{name}_max_abs_diff']})")
    del sd, sh

    # ---- n_f64^3 f64 on the device against the CPU port: the port on
    # the CPU solving with the card's hierarchy (carried across with
    # hierarchy_from_numpy) takes the same iterations to x within rtol
    # 1e-9; with its own host-built hierarchy, which parts from the
    # card's at threshold ties (section 4), within one iteration
    from amgx_tpu_torch.amg.hierarchy import hierarchy_from_numpy

    s64, r64, _, b64, _ = solve_on(device, PCG_CLASSICAL, n_f64, np.float64)
    device_built(s64.precond, f"{n_f64}^3 f64")
    given = [{k: (*getattr(lv, k)._host, getattr(lv, k).shape)
              for k in ("A", "P", "R") if getattr(lv, k) is not None}
             for lv in s64.precond.levels]
    sg64 = hierarchy_from_numpy(given, T.AMGConfig.from_string(PCG_CLASSICAL),
                                device="cpu")
    g64 = sg64.solve(b64)
    c64 = CPU.get(cpu_solve, PCG_CLASSICAL, n_f64, np.float64)
    x64, xg64 = r64.x.cpu().numpy(), g64.x.numpy()
    d64 = float(np.abs(x64 - xg64).max())
    print(json.dumps({f"classical_f64_{n_f64}^3": {
        "iterations": int(r64.iters), "status": int(r64.status),
        "cpu_on_card_hierarchy_iterations": int(g64.iters),
        "max_abs_diff_vs_cpu_on_card_hierarchy": d64,
        "cpu_own_setup_iterations": c64["iterations"],
        "max_abs_diff_vs_cpu_own_setup":
            float(np.abs(x64 - c64["x"]).max()),
        "x_inf": float(np.abs(x64).max())}}), flush=True)
    check(int(r64.status) == 0, f"classical f64 status {r64.status}")
    check(int(r64.iters) == int(g64.iters),
          f"classical f64 iterations card {r64.iters} vs cpu {g64.iters}")
    check(np.allclose(x64, xg64, rtol=1e-9,
                      atol=1e-9 * float(np.abs(xg64).max())),
          f"classical f64 x card vs cpu: max abs diff {d64:.3e}")
    check(abs(int(r64.iters) - c64["iterations"]) <= 1,
          f"classical f64 iterations card {r64.iters} vs cpu's own "
          f"setup {c64['iterations']}")
    del s64, sg64

    # ---- 5. the other selector / interpolator / reordering paths
    def card_and_cpu(label, run, rcpu):
        t0 = time.perf_counter()
        sg, rg, xres = run(device)
        card_s = time.perf_counter() - t0
        ic, stc = rcpu["iterations"], rcpu["status"]
        print(json.dumps({"classical_path": {
            "case": label, "iterations": int(rg.iters),
            "cpu_iterations": ic, "status": int(rg.status),
            "cpu_status": stc, "card_s": card_s,
            "levels": [(lv.n_rows, lv.nnz, lv.A.format)
                       for lv in sg.precond.levels],
            "setup_profile": sg.precond.setup_profile,
            "true_rel_residual_f64": xres}}), flush=True)
        check(int(rg.status) == 0 and stc == 0,
              f"{label}: status card {rg.status} cpu {stc}")
        check(abs(int(rg.iters) - ic) <= 1,
              f"{label}: iterations card {rg.iters} vs cpu {ic}")
        return sg

    def poisson_run(cfg, m):
        def run(dev):
            sg, rg, _, bg, _ = solve_on(dev, cfg, m, np.float32)
            return sg, rg, true_rel_residual(m, bg, rg.x.cpu().numpy())
        return run

    # (D2 + aggressive coarsening + 4 interpolation elements at n^3, on
    # the card and the CPU: the pcg_classical_cheby path, cheby_phase)
    for label, extra, m in classical_paths(n_cpu, n_small):
        cfg = classical_cfg(extra)
        sg = card_and_cpu(label, poisson_run(cfg, m),
                          CPU.get(cpu_solve, cfg, m, np.float32))
        if "MULTIPASS" in label:
            device_built(sg.precond, "MULTIPASS")
        del sg
    sg = card_and_cpu(f"{n_small}^3 shuffled f32 PCG_CLASSICAL RCM",
                      lambda dev: classical_rcm_solve(dev, n_small),
                      CPU.get(classical_rcm_cpu, n_small))
    device_built(sg.precond, "RCM")
    return launches, recs


def classical_paths(n_cpu, n_small):
    """(label, ``classical_cfg`` extra, size) of the classical phase's
    other selector / interpolator paths."""
    return ((f"{n_cpu}^3 f32 PCG_CLASSICAL MULTIPASS",
             ', "interpolator": "MULTIPASS"', n_cpu),
            (f"{n_small}^3 f32 ENERGYMIN", ', "algorithm": "ENERGYMIN"',
             n_small))


def classical_rcm_solve(device, m):
    """PCG_CLASSICAL with RCM reordering on ``shuffled_poisson(m)`` f32
    on ``device``: (solver, result, true residual)."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_rhs

    shuffled = shuffled_poisson(m).astype(np.float32)
    rcm_cfg = classical_cfg(main_extra=', "matrix_reordering": "RCM"')
    A = SparseMatrix.from_scipy(shuffled, device=device)
    sg = T.create_solver(T.AMGConfig.from_string(rcm_cfg), "default",
                         device=device)
    sg.setup(A)
    check(sg._reorder is not None, "RCM: the system was not reordered")
    bg = poisson_rhs(A.n_rows, dtype=np.float32)
    rg = sg.solve(bg)
    xg = rg.x.cpu().numpy().astype(np.float64)
    b64 = bg.astype(np.float64)
    xres = float(np.linalg.norm(b64 - shuffled.astype(np.float64) @ xg)
                 / np.linalg.norm(b64))
    return sg, rg, xres


def classical_rcm_cpu(m):
    """:func:`classical_rcm_solve` on the CPU as plain data."""
    _, rg, _ = classical_rcm_solve("cpu", m)
    return {"iterations": int(rg.iters), "status": int(rg.status)}


def monitored_ratio(res):
    """The monitored residual at the end over the one at the start:
    what the config's tolerance (RELATIVE_INI) bounds."""
    return float(np.max(res.final_norm) / np.max(res.initial_norm))


def check_launches(label, launches, derived, device):
    """Each counter equal to its derived count (the wrappers count only
    launches on the card)."""
    for k in launches:
        check(launches[k] == derived[k] or device != "cuda",
              f"{label} {k} launches {launches[k]} != derived {derived[k]}")


def f64_vs_cpu(label, run, device, cpu=None):
    """``run(dev) -> (solver, result, true residual)`` on ``device`` and
    on the CPU in f64 (``cpu``, a :func:`cpu_solve` record, gives the
    CPU's side instead of ``run("cpu")``): iterations equal, x to rtol
    1e-9, status 0 and the true residual at the config's tolerance on
    both.  Returns the two solvers (the CPU's None where ``cpu`` was
    given)."""
    sg, rg, resg = run(device)
    sc = None
    if cpu is None:
        sc, rc, resc = run("cpu")
        cpu = {"iterations": int(rc.iters), "status": int(rc.status),
               "x": rc.x.numpy(), "true_rel_residual_f64": resc}
    xg, xc = rg.x.cpu().numpy(), cpu["x"]
    ic, stc, resc = (cpu["iterations"], cpu["status"],
                     cpu["true_rel_residual_f64"])
    d = float(np.abs(xg - xc).max())
    tol = sg.tolerance
    print(json.dumps({f"{label}_f64": {
        "iterations": int(rg.iters), "cpu_iterations": ic,
        "status": int(rg.status), "cpu_status": stc,
        "true_rel_residual_f64": resg, "cpu_true_rel_residual_f64": resc,
        "max_abs_diff_vs_cpu": d, "x_inf": float(np.abs(xc).max())}}),
        flush=True)
    check(int(rg.status) == 0 and stc == 0,
          f"{label} f64: status card {rg.status} cpu {stc}")
    check(int(rg.iters) == ic,
          f"{label} f64: iterations card {rg.iters} vs cpu {ic}")
    check(np.allclose(xg, xc, rtol=1e-9,
                      atol=1e-9 * float(np.abs(xc).max())),
          f"{label} f64: x card vs cpu, max abs diff {d:.3e}")
    check(resg <= tol and resc <= tol,
          f"{label} f64: true residual {resg:.3e} / {resc:.3e} > {tol}")
    return sg, sc


def cheby_phase(torch, peaks=None, device="cuda", n=SLICE_N, n_cmp=SLICE_N,
                n_f64=64):
    """pcg_classical_cheby: PCG + classical AMG (D2, aggressive level 0,
    4 interpolation elements) smoothed by CHEBYSHEV of order 2 over
    JACOBI_L1 (``PCG_CLASSICAL_CHEB``) at ``n``^3 f32 with its setup on
    ``device``: levels, lmax per level, launches (each Chebyshev sweep
    of order k is k A-SpMVs, each level's power iteration at setup 20),
    a trace of a warm solve and (given ``peaks``) the ELL kernels at each
    ELL operator; the CPU port at ``n_cmp``^3 (iterations within one);
    ``n_f64``^3 f64 with the card's hierarchy carried to the CPU
    (iterations equal, x to rtol 1e-9, lmax to rtol 1e-9).  Returns the
    launches and the kernel case records."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.amg.hierarchy import hierarchy_from_numpy
    from amgx_tpu_torch.solvers.chebyshev import POWER_STEPS

    cfg = PCG_CLASSICAL_CHEB
    # ---- the main path: counts zeroed just before, read just after
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on(device, cfg, n, np.float32)
    launches = kernel_counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    amg = s.precond
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat Chebyshev solve changed iters")
    warm_s = s.solve_time
    order = amg.levels[0].smoother.order
    derived = pcg_derived_launches(s, iters, sweep_spmvs=order,
                                   setup_spmvs=POWER_STEPS)
    rel = true_rel_residual(n, b, x)
    lam = [(lv.smoother.lmax, lv.smoother.lmin) if lv.smoother else None
           for lv in amg.levels]
    print(json.dumps({
        "slice": f"poisson7 {n}^3 f32 pcg_classical_cheby (PCG + classical "
                 "AMG D2 aggressive 1 interp_max_elements 4, CHEBYSHEV "
                 f"order {order} / JACOBI_L1, DENSE_LU) setup and solve on "
                 f"{device}",
        "levels": classical_levels(amg), "n_levels": len(amg.levels),
        "lmax_lmin": lam, "iterations": iters, "status": status,
        "upload_s": upload_s, "setup_s": setup_s,
        "setup_profile": amg.setup_profile, "setup_stats": amg.setup_stats,
        "solve_s": solve_s, "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": warm_s,
        "ms_per_iteration_warm": warm_s / max(iters, 1) * 1e3,
        "monitored_rel_residual": monitored_ratio(res),
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
        "repeat_solve_x_bitwise": bool(torch.equal(res.x, res2.x)),
    }), flush=True)
    check(status == 0, f"Chebyshev status {status}")
    check(monitored_ratio(res) <= s.tolerance,
          f"Chebyshev monitored residual {monitored_ratio(res):.3e}")
    check(rel <= 1e-5, f"Chebyshev true relative residual {rel:.3e} > 1e-5")
    stats = amg.setup_stats
    check(stats["host_fallback_levels"] == 0,
          "Chebyshev: a level fell back to the host builder")
    check(stats["device_levels"] == len(amg.levels) - 1 or device != "cuda",
          f"Chebyshev: {stats['device_levels']} device-built levels of "
          f"{len(amg.levels) - 1}")
    check_launches("Chebyshev", launches, derived, device)
    recs = []
    if peaks is not None:
        timer = Timer(torch)
        rng = np.random.default_rng(2)
        for label, m, per in ell_operators(amg, iters, sweep_spmvs=order,
                                           setup_spmvs=POWER_STEPS):
            recs += ell_kernel_case(
                torch, timer, peaks, rng,
                f"cheby {label} {m.n_rows}x{m.n_cols} w={_width(m)} f32",
                m.host_csr(), np.float32,
                extra={"launches_per_solve": per})
        del timer
        trace_solve(torch, s, b, iters, groups={
            "dia_spmv": ["dia_spmv"], "sell_spmv": ["sell_spmv"],
            "ell_spmv": ["ell_spmv"], "csr": ["egment"],
            "dense": ["gemv", "gemm", "dot_kernel"],
            "reduction": ["reduce_kernel"]})
    del s, res, res2, amg

    # ---- the CPU port (AUTO: the host builder there)
    rc = CPU.get(cpu_solve, cfg, n_cmp, np.float32)
    print(json.dumps({"cheby_cpu": {
        "n": n_cmp, **{k: rc[k] for k in (
            "iterations", "status", "setup_s", "solve_s", "levels",
            "lmax_lmin", "true_rel_residual_f64")}}}), flush=True)
    check(rc["status"] == 0, f"Chebyshev cpu status {rc['status']}")
    check(abs(rc["iterations"] - iters) <= 1,
          f"Chebyshev f32 iterations card {iters} vs cpu {rc['iterations']}")
    del rc

    # ---- n_f64^3 f64: the card's hierarchy carried to the CPU (the
    # host builder parts from the device pipeline at threshold ties)
    carried = {}

    def run(dev):
        # the first call sets up on ``device``, the second on the CPU
        if carried:
            sg = hierarchy_from_numpy(carried["levels"],
                                      T.AMGConfig.from_string(cfg),
                                      device="cpu")
            bg = carried["b"]
            rg = sg.solve(bg)
        else:
            sg, rg, _, bg, _ = solve_on(dev, cfg, n_f64, np.float64)
            carried["b"] = bg
            carried["levels"] = [
                {k: (*getattr(lv, k)._host, getattr(lv, k).shape)
                 for k in ("A", "P", "R") if getattr(lv, k) is not None}
                for lv in sg.precond.levels]
        return sg, rg, true_rel_residual(n_f64, bg, rg.x.cpu().numpy())

    sg, sc = f64_vs_cpu(f"cheby_{n_f64}^3", run, device)
    lg = [lv.smoother.lmax for lv in sg.precond.levels if lv.smoother]
    lc = [lv.smoother.lmax for lv in sc.precond.levels if lv.smoother]
    print(json.dumps({f"cheby_{n_f64}^3_f64_lmax": {"card": lg, "cpu": lc}}),
          flush=True)
    check(np.allclose(lg, lc, rtol=1e-9), f"lmax card {lg} vs cpu {lc}")
    return launches, recs


def idr_phase(torch, device="cuda", n=SLICE_N, n_cmp=96, n_f64=64):
    """idr_dilu: IDR(8) preconditioned by one MULTICOLOR_DILU sweep
    (``IDR_DILU_CFG``) on ``n``^3 f32: colours, launches (s + 1 A-SpMVs
    an iteration and the initial residual), a trace of a warm solve;
    the CPU port at ``n_cmp``^3 f32; ``n``^3 f64 on the device (the
    true residual); ``n_f64``^3 f64 against the CPU.  In f32 the
    recurred residual of IDR(8) parts from the true one (the solve stops
    on the recurred residual, which meets the tolerance, with a true
    residual orders above it, in the JAX package too) and last-bit
    differences move the iteration count by several: the f32 runs are
    held to their status and monitored residual, the f64 runs to the
    true residual and, at ``n_f64``^3, to the CPU's iterations and x."""
    cfg = IDR_DILU_CFG
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on(device, cfg, n, np.float32)
    launches = kernel_counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat IDR solve changed iters")
    warm_s = s.solve_time
    shadow = int(s._shadow.shape[0])
    derived = dict.fromkeys(COUNTERS, 0)
    derived[counter_of(s.A)] = 1 + (shadow + 1) * iters
    rel = true_rel_residual(n, b, x)
    print(json.dumps({
        "slice": f"poisson7 {n}^3 f32 idr_dilu (IDR({shadow}) + "
                 f"MULTICOLOR_DILU) on {device}",
        "format": s.A.format, "colors": s.precond.num_colors,
        "iterations": iters, "status": status, "upload_s": upload_s,
        "setup_s": setup_s, "dilu_setup_s": s.precond.setup_time,
        "solve_s": solve_s, "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": warm_s,
        "ms_per_iteration_warm": warm_s / max(iters, 1) * 1e3,
        "monitored_rel_residual": monitored_ratio(res),
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
        "repeat_solve_x_bitwise": bool(torch.equal(res.x, res2.x)),
    }), flush=True)
    check(status == 0, f"IDR status {status}")
    check(monitored_ratio(res) <= s.tolerance,
          f"IDR monitored residual {monitored_ratio(res):.3e}")
    check(bool(np.isfinite(x).all()), "IDR: non-finite x")
    check_launches("IDR", launches, derived, device)
    if device == "cuda":
        trace_first(torch, s, b, TRACE_ITERS, groups={
            "dia_spmv": ["dia_spmv"], "index_copy": ["index_copy"],
            "gather": ["index_elementwise", "gather", "index_select"],
            "reduction": ["reduce_kernel"],
            "small_dense": ["trsm", "trsv", "gemv", "gemm", "dot_kernel"]})
    del s, res, res2

    rc = CPU.get(cpu_solve, cfg, n_cmp, np.float32)
    print(json.dumps({"idr_cpu_f32": {
        "n": n_cmp, "iterations": rc["iterations"], "status": rc["status"],
        "card_iterations": iters if n_cmp == n else None,
        **{k: rc[k] for k in ("setup_s", "solve_s", "colors",
                              "monitored_rel_residual",
                              "true_rel_residual_f64")}}}), flush=True)
    check(rc["status"] == 0, f"IDR cpu status {rc['status']}")
    check(rc["monitored_rel_residual"] <= rc["tolerance"],
          f"IDR cpu monitored residual {rc['monitored_rel_residual']:.3e}")
    del rc

    # n^3 in f64 on the device: the true residual at the tolerance.  (At
    # this size even f64 IDR(8) amplifies the order of its sums: on the
    # CPU at 96^3 the torch thread count moves the residual history in
    # its fourth digit, so the count is printed, not held to the CPU's.)
    sg, rg, _, bg, _ = solve_on(device, cfg, n, np.float64)
    relg = true_rel_residual(n, bg, rg.x.cpu().numpy())
    print(json.dumps({f"idr_{n}^3_f64": {
        "iterations": int(rg.iters), "status": int(rg.status),
        "monitored_rel_residual": monitored_ratio(rg),
        "true_rel_residual_f64": relg, "solve_s": sg.solve_time}}),
        flush=True)
    check(int(rg.status) == 0, f"IDR {n}^3 f64 status {rg.status}")
    check(relg <= sg.tolerance,
          f"IDR {n}^3 f64 true residual {relg:.3e} > {sg.tolerance}")
    del sg, rg

    def run(dev):
        sg, rg, _, bg, _ = solve_on(dev, cfg, n_f64, np.float64)
        return sg, rg, true_rel_residual(n_f64, bg, rg.x.cpu().numpy())

    f64_vs_cpu(f"idr_{n_f64}^3", run, device,
               CPU.get(cpu_solve, cfg, n_f64, np.float64))
    return launches


def gmres_cpu_side(n):
    """The CPU port's gmres_ilu0 solve on ``convection_diffusion_3d(n)``
    (what the phase holds the card's run to): seconds, colours,
    status, iterations, x and the true residual."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.core.matrix import SparseMatrix

    Asp = convection_diffusion_3d(n)
    b = Asp @ np.random.default_rng(7).standard_normal(Asp.shape[0])
    s = T.create_solver(T.AMGConfig.from_string(GMRES_ILU0_CFG), "default",
                        device="cpu")
    t0 = time.perf_counter()
    s.setup(SparseMatrix.from_scipy(Asp, device="cpu"))
    setup_s = time.perf_counter() - t0
    r = s.solve(b)
    x = r.x.numpy()
    return {"iterations": int(r.iters), "status": int(r.status),
            "setup_s": setup_s, "ilu_setup_s": s.precond.setup_time,
            "solve_s": s.solve_time, "colors": s.precond.num_colors,
            "x": x, "true_rel_residual_f64": float(
                np.linalg.norm(b - Asp @ x) / np.linalg.norm(b))}


def gmres_ilu_phase(torch, device="cuda", n=108, n_cmp=108, n_f64=64,
                    n_ilu1=64):
    """gmres_ilu0: GMRES(30) + ILU(0) (``GMRES_ILU0_CFG``, BASELINE.md
    acceptance config 4) on the ``n``^3 upwind convection-diffusion
    operator in f64: colours, the ILU factorization's host time,
    launches (one A-SpMV an iteration and one residual a restart
    cycle), a trace of a warm solve; the CPU port at ``n_cmp``^3 and
    ``n_f64``^3 against the CPU (from :data:`CPU`); ILU(1) at
    ``n_ilu1``^3."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.core.matrix import SparseMatrix

    def system(m):
        A = convection_diffusion_3d(m)
        return A, A @ np.random.default_rng(7).standard_normal(A.shape[0])

    def setup_solve(dev, m, text=GMRES_ILU0_CFG):
        Asp, bb = system(m)
        t0 = time.perf_counter()
        A = SparseMatrix.from_scipy(Asp, device=dev)
        up = time.perf_counter() - t0
        sg = T.create_solver(T.AMGConfig.from_string(text), "default",
                             device=dev)
        t0 = time.perf_counter()
        sg.setup(A)
        st = time.perf_counter() - t0
        return sg, sg.solve(bb), Asp, bb, up, st

    def rel_of(Asp, bb, xx):
        return float(np.linalg.norm(bb - Asp @ xx) / np.linalg.norm(bb))

    zero_counts()
    s, res, Asp, b, upload_s, setup_s = setup_solve(device, n)
    launches = kernel_counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, "repeat GMRES solve changed iters")
    warm_s = s.solve_time
    derived = dict.fromkeys(COUNTERS, 0)
    derived[counter_of(s.A)] = -(-iters // s.restart) + iters
    rel = rel_of(Asp, b, x)
    print(json.dumps({
        "slice": f"convection-diffusion {n}^3 ({Asp.shape[0]} rows, "
                 f"{Asp.nnz} nonzeros) f64 gmres_ilu0 (GMRES(30) + "
                 f"MULTICOLOR_ILU level 0) on {device}",
        "format": s.A.format, "colors": s.precond.num_colors,
        "pattern_nnz": s.precond.pattern_nnz,
        "ilu_setup_s": s.precond.setup_time,
        "iterations": iters, "status": status, "upload_s": upload_s,
        "setup_s": setup_s, "solve_s": solve_s,
        "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": warm_s,
        "ms_per_iteration_warm": warm_s / max(iters, 1) * 1e3,
        "monitored_rel_residual": monitored_ratio(res),
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
        "repeat_solve_x_bitwise": bool(torch.equal(res.x, res2.x)),
    }), flush=True)
    check(status == 0, f"GMRES status {status}")
    check(s.A.format == "DIA", f"GMRES operator format {s.A.format}")
    check(rel <= s.tolerance, f"GMRES true residual {rel:.3e}")
    check_launches("GMRES", launches, derived, device)
    if device == "cuda":
        trace_solve(torch, s, b, iters, groups={
            "dia_spmv": ["dia_spmv"], "index_copy": ["index_copy"],
            "gather": ["index_elementwise", "gather", "index_select"],
            "reduction": ["reduce_kernel"]})
    del s, res, res2

    t0 = time.perf_counter()
    rc = CPU.get(gmres_cpu_side, n_cmp)
    print(json.dumps({"gmres_cpu": {
        "n": n_cmp, **{k: v for k, v in rc.items() if k != "x"},
        "cpu_side_wait_s": time.perf_counter() - t0,
        "max_abs_diff_vs_card": (float(np.abs(x - rc["x"]).max())
                                 if n_cmp == n else None)}}), flush=True)
    check(rc["status"] == 0, f"GMRES cpu status {rc['status']}")
    check(abs(rc["iterations"] - iters) <= 1,
          f"GMRES iterations card {iters} vs cpu {rc['iterations']}")
    del rc

    def run(dev):
        sg, rg, Ag, bg, _, _ = setup_solve(dev, n_f64)
        return sg, rg, rel_of(Ag, bg, rg.x.cpu().numpy())

    f64_vs_cpu(f"gmres_ilu0_{n_f64}^3", run, device,
               CPU.get(gmres_cpu_side, n_f64))

    ilu = []
    for level in (0, 1):
        text = GMRES_ILU0_CFG.replace('"ilu_sparsity_level": 0',
                                      f'"ilu_sparsity_level": {level}')
        sg, rg, Ag, bg, _, _ = setup_solve(device, n_ilu1, text)
        ilu.append({"ilu_sparsity_level": level,
                    "colors": sg.precond.num_colors,
                    "pattern_nnz": sg.precond.pattern_nnz,
                    "ilu_setup_s": sg.precond.setup_time,
                    "iterations": int(rg.iters), "status": int(rg.status),
                    "solve_s": sg.solve_time,
                    "true_rel_residual_f64": rel_of(
                        Ag, bg, rg.x.cpu().numpy())})
        check(int(rg.status) == 0, f"ILU({level}) {n_ilu1}^3 status")
    print(json.dumps({f"gmres_ilu_levels_{n_ilu1}^3": ilu}), flush=True)
    check(ilu[1]["iterations"] < ilu[0]["iterations"],
          "ILU(1) took no fewer iterations than ILU(0)")
    return launches


def scaled_cycle_derived(s, iters, outer):
    """Launches of a solve of ``iters`` iterations by solver ``s``:
    PBICGSTAB (one residual, then two A-SpMVs and two cycles an
    iteration), PCG (one residual and cycle, then one of each an
    iteration) or a monitored AMG (one residual, then a cycle and a
    residual an iteration); the cycles by :func:`cycle_walk`."""
    amg = s.precond if outer != "AMG" else s
    top, cycles = {"PBICGSTAB": (1 + 2 * iters, 2 * iters),
                   "PCG": (iters + 1, iters + 1),
                   "AMG": (iters + 1, iters)}[outer]
    return derived_launches(amg, cycles, top)


def visits_per_cycle(amg):
    """Visits of each level in one cycle (the dry walk's R and coarse
    counts)."""
    walk = cycle_walk(amg)
    last = len(amg.levels) - 1
    return [walk.get((i, "R"), 0) for i in range(last)] + [
        walk[(last, "A")] if amg.coarse_solver is not None else None]


def path_record(label, s, res, b, n, launches, derived, setup_s, upload_s,
                amg, walk_check=True):
    """The JSON record and the common checks of one card path: status
    0, the true residual at 1e-5 and the dry walk's A-SpMVs at the
    cycle's passes (``walk_check``: False where fused legs count a
    leg's SpMVs as one pass)."""
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    solve_s = s.solve_time
    res2 = s.solve(b)
    check(int(res2.iters) == iters, f"repeat {label} solve changed iters")
    rel = true_rel_residual(n, b, x)
    rec = {
        "levels": amg.level_summary(), "n_levels": len(amg.levels),
        "visits_per_cycle": visits_per_cycle(amg),
        "cycle_passes_per_iteration": amg.cycle_passes_per_iteration(),
        "iterations": iters, "status": status, "upload_s": upload_s,
        "setup_s": setup_s, "setup_profile": amg.setup_profile,
        "setup_stats": amg.setup_stats, "solve_s": solve_s,
        "ms_per_iteration": solve_s / max(iters, 1) * 1e3,
        "solve_warm_s": s.solve_time,
        "ms_per_iteration_warm": s.solve_time / max(iters, 1) * 1e3,
        "monitored_rel_residual": monitored_ratio(res),
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived,
        "repeat_solve_x_bitwise": bool(res.x.equal(res2.x)),
    }
    check(status == 0, f"{label} status {status}")
    check(rel <= 1e-5, f"{label} true relative residual {rel:.3e} > 1e-5")
    # the walk's square-operator SpMVs against those the cycle made
    walk_a = sum(k for (_, f), k in cycle_walk(amg).items() if f == "A")
    check(not walk_check or walk_a == rec["cycle_passes_per_iteration"],
          f"{label}: the dry walk counts {walk_a} A-SpMVs a cycle, the "
          f"cycle made {rec['cycle_passes_per_iteration']}")
    return rec, x


TRACE_GROUPS = {"dia_spmv": ["dia_spmv"], "sell_spmv": ["sell_spmv"],
                "ell_spmv": ["ell_spmv"], "stencil_spmv": ["stencil_"],
                "csr": ["egment"], "dense": ["gemv", "gemm", "dot_kernel",
                                             "trsm", "trsv"],
                "reduction": ["reduce_kernel"]}


def pbicgstab_w_phase(torch, device="cuda", n=SLICE_N, n_cmp=SLICE_N,
                      n_f64=64):
    """pbicgstab_agg_w: PBICGSTAB + aggregation-AMG W-cycle with
    error_scaling 2 (``PBICGSTAB_AGG_W_CFG``) at ``n``^3 f32 on
    ``device``: levels, W visits per cycle, launches against the dry
    walk (the extra A e and the scaling sweeps of each prolongation
    among them), a trace of a warm solve; the CPU port at ``n_cmp``^3
    (iterations within one); ``n_f64``^3 f64 against the CPU.  Returns
    the launches."""
    cfg = PBICGSTAB_AGG_W_CFG
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on(device, cfg, n, np.float32)
    launches = kernel_counts()
    iters = int(res.iters)
    derived = scaled_cycle_derived(s, iters, "PBICGSTAB")
    rec, x = path_record("PBICGSTAB W", s, res, b, n, launches, derived,
                         setup_s, upload_s, s.precond)
    print(json.dumps({
        "slice": f"poisson7 {n}^3 f32 pbicgstab_agg_w (PBICGSTAB + AMG "
                 "SIZE_8 W-cycle error_scaling 2, BLOCK_JACOBI 2+2, "
                 f"DENSE_LU) on {device}", **rec}), flush=True)
    check_launches("PBICGSTAB W", launches, derived, device)
    if device == "cuda":
        trace_solve(torch, s, b, iters, groups=TRACE_GROUPS)
    del s, res

    rc = CPU.get(cpu_solve, cfg, n_cmp, np.float32)
    print(json.dumps({"pbicgstab_w_cpu": {
        "n": n_cmp, **{k: rc[k] for k in (
            "iterations", "status", "setup_s", "solve_s",
            "true_rel_residual_f64")}}}), flush=True)
    check(rc["status"] == 0, f"PBICGSTAB W cpu status {rc['status']}")
    check(abs(rc["iterations"] - iters) <= 1 or n_cmp != n,
          f"PBICGSTAB W f32 iterations card {iters} vs cpu "
          f"{rc['iterations']}")
    del rc

    def run(dev):
        sg, rg, _, bg, _ = solve_on(dev, cfg, n_f64, np.float64)
        return sg, rg, true_rel_residual(n_f64, bg, rg.x.cpu().numpy())

    f64_vs_cpu(f"pbicgstab_w_{n_f64}^3", run, device,
               CPU.get(cpu_solve, cfg, n_f64, np.float64))
    return launches


def kcycle_phase(torch, device="cuda", n=64, n_cmp=64, n_f64=64):
    """amg_classical_kcycle: AMG as the outer solver with classical
    levels and a CG K-cycle (``AMG_CLASSICAL_CG_CFG``) at ``n``^3 f32,
    the setup on ``device`` (AUTO: the device pipeline on the card):
    levels, visits per cycle, launches against the dry walk, a trace;
    the CPU port at ``n_cmp``^3 (host setup, iterations within one);
    ``n_f64``^3 f64 with ``setup_location`` DEVICE on both (iterations
    equal, x to rtol 1e-9).  Returns the launches."""
    cfg = AMG_CLASSICAL_CG_CFG
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on(device, cfg, n, np.float32)
    launches = kernel_counts()
    iters = int(res.iters)
    derived = scaled_cycle_derived(s, iters, "AMG")
    rec, x = path_record("K-cycle", s, res, b, n, launches, derived,
                         setup_s, upload_s, s)
    print(json.dumps({
        "slice": f"poisson7 {n}^3 f32 amg_classical_kcycle (AMG classical "
                 f"AHAT/PMIS/D1, cycle CG x{s.cycle_iters}, BLOCK_JACOBI "
                 f"1+1, DENSE_LU) setup and solve on {device}",
        "classical_levels": classical_levels(s), **rec}), flush=True)
    check(s.setup_stats["host_fallback_levels"] == 0,
          "K-cycle: a level fell back to the host builder")
    check(s.setup_stats["device_levels"] == len(s.levels) - 1
          or device != "cuda",
          f"K-cycle: {s.setup_stats['device_levels']} device-built levels")
    check_launches("K-cycle", launches, derived, device)
    if device == "cuda":
        trace_solve(torch, s, b, iters, groups=TRACE_GROUPS)
    del s, res

    rc = CPU.get(cpu_solve, cfg, n_cmp, np.float32)
    print(json.dumps({"kcycle_cpu": {
        "n": n_cmp, **{k: rc[k] for k in (
            "iterations", "status", "setup_s", "solve_s", "levels",
            "true_rel_residual_f64")}}}), flush=True)
    check(rc["status"] == 0, f"K-cycle cpu status {rc['status']}")
    check(abs(rc["iterations"] - iters) <= 1 or n_cmp != n,
          f"K-cycle f32 iterations card {iters} vs cpu {rc['iterations']}")
    del rc

    def run(dev):
        sg, rg, _, bg, _ = solve_on(dev, KCYCLE_DEVICE_CFG, n_f64,
                                    np.float64)
        return sg, rg, true_rel_residual(n_f64, bg, rg.x.cpu().numpy())

    f64_vs_cpu(f"kcycle_{n_f64}^3", run, device,
               CPU.get(cpu_solve, KCYCLE_DEVICE_CFG, n_f64, np.float64))
    return launches


# the K-cycle config with setup_location DEVICE (its f64 comparison)
KCYCLE_DEVICE_CFG = AMG_CLASSICAL_CG_CFG.replace(
    '"algorithm": "CLASSICAL",',
    '"algorithm": "CLASSICAL", "setup_location": "DEVICE",')


def variable_diffusion_3d(n, seed):
    """-div(kappa grad u) on an n^3 grid, 7 points, x fastest: kappa =
    exp(0.5 xi) with xi i.i.d. N(0, 1) per cell from
    ``default_rng(seed)``, each face coefficient the harmonic mean of
    its two cells', a wall face the cell's own (Dirichlet walls as
    ``poisson_3d_7pt``, which is kappa = 1).  Scipy CSR, float64."""
    return diffusion_3d(np.exp(0.5 * np.random.default_rng(
        seed).standard_normal((n, n, n))))


def diffusion_3d(kappa):
    """-div(kappa grad u) for the (n, n, n) cell coefficients ``kappa``
    (x fastest), as :func:`variable_diffusion_3d` builds it: scipy CSR,
    float64, the pattern of ``poisson_3d_7pt(n)``."""
    import scipy.sparse as sps

    n = kappa.shape[0]
    N = n ** 3
    diag = np.zeros((n, n, n))
    diags, offsets = [], []
    for axis, stride in ((2, 1), (1, n), (0, n * n)):
        k = np.moveaxis(kappa, axis, -1)
        face = 2.0 * k[..., :-1] * k[..., 1:] / (k[..., :-1] + k[..., 1:])
        d = np.zeros_like(k)
        d[..., :-1] += face
        d[..., 1:] += face
        d[..., 0] += k[..., 0]
        d[..., -1] += k[..., -1]
        diag += np.moveaxis(d, -1, axis)
        # coupling of each cell to its upper neighbour (0 on the last
        # plane of the axis: no neighbour)
        up = np.zeros_like(k)
        up[..., :-1] = face
        up = np.moveaxis(up, -1, axis).reshape(-1)[:N - stride]
        diags += [-up, -up]
        offsets += [stride, -stride]
    A = sps.diags_array([diag.reshape(-1)] + diags, offsets=[0] + offsets,
                        format="csr")
    A.eliminate_zeros()
    A.sort_indices()
    return A


def heat_step_3d(n, dt):
    """A backward-Euler step of the heat equation, L + I / dt with L the
    7-point Laplacian of ``poisson_3d_7pt`` (scipy CSR, float64)."""
    import scipy.sparse as sps
    from amgx_tpu_torch.io.poisson import poisson_scipy

    A = (poisson_scipy((n, n, n)) + sps.eye_array(n ** 3) / dt).tocsr()
    A.sort_indices()
    return A


def rap_error(amg):
    """Largest |A_{i+1} - R_i A_i P_i| / max|R_i A_i P_i| over the
    levels, the product formed by scipy in float64 from the stored
    transfers and the level's operator, all read from the device."""
    worst = 0.0
    for i in range(len(amg.levels) - 1):
        lv, nxt = amg.levels[i], amg.levels[i + 1]
        f = lambda m: m.to_scipy().astype(np.float64)  # noqa: E731
        ref = (f(lv.R) @ f(lv.A) @ f(lv.P)).tocsr()
        d = abs(f(nxt.A) - ref)
        scale = float(abs(ref).max()) or 1.0
        worst = max(worst, float(d.max()) / scale if d.nnz else 0.0)
    return worst


def reuse_sequence(torch, device, cfg, n, dtype, systems, formats=None,
                   fresh=None, rap=True):
    """Set up ``cfg`` once on ``systems[0]`` (scipy CSR), then for each
    later system: ``A_k = A_0.replace_values(v_k)`` (the values uploaded
    as one tensor), ``resetup(A_k)``, ``solve(b)``.  Returns (solver,
    per-step records, the x of each step, the launches of the setup and
    every solve).  Each step checks the level count and formats, the
    coarse operators against scipy's R A P (1e-5 x max in f32, 1e-12
    in f64; unless ``rap`` is False), status 0 and the true residual.
    ``fresh`` (a config) also sets up a new solver of that config on
    each A_k (after the counts are read) for its upload, setup and
    iterations."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_rhs

    kw = {} if formats is None else {"accel_formats": formats}
    cuda = device == "cuda"
    b = poisson_rhs(n ** 3, dtype=dtype)
    zero_counts()
    A0 = SparseMatrix.from_scipy(systems[0].astype(dtype), device=device,
                                 **kw)
    s = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                        device=device)
    t0 = time.perf_counter()
    s.setup(A0)
    setup_s = time.perf_counter() - t0
    amg = s.precond
    shape = [(lv["rows"], lv["format"]) for lv in amg.level_summary()]
    plan = {"setup_s": setup_s,
            "plan_bytes": sum(lv.rap_plan.nbytes() for lv in amg.levels
                              if lv.rap_plan is not None),
            "planned": [lv.rap_plan is not None for lv in amg.levels],
            "rap_plan_s": amg.setup_profile.get("rap_plan"),
            "levels": shape}
    steps, xs, Ak = [], [], None
    for k, sp in enumerate(systems[1:], 1):
        v = torch.from_numpy(sp.data.astype(dtype)).to(device)
        if cuda:
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        Ak = A0.replace_values(v)
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
        rv_ms = ev[0].elapsed_time(ev[1]) if cuda else None
        t0 = time.perf_counter()
        s.resetup(Ak)
        resetup_s = time.perf_counter() - t0
        res = s.solve(b)
        x = res.x.cpu().numpy()
        xs.append(x)
        rel = float(np.linalg.norm(b - sp @ x.astype(np.float64))
                    / np.linalg.norm(b.astype(np.float64)))
        steps.append({
            "k": k, "replace_values_ms": rv_ms, "resetup_s": resetup_s,
            "rap_execute_s": amg.setup_profile.get("rap_execute"),
            "setup_profile": amg.setup_profile,
            "coarsen_calls": amg.setup_stats["coarsen_calls"],
            "iterations": int(res.iters), "status": int(res.status),
            "solve_s": s.solve_time, "true_rel_residual_f64": rel,
            "rap_rel_err": rap_error(amg) if rap else None})
    launches = kernel_counts()
    iters = [st["iterations"] for st in steps]
    derived = dict.fromkeys(COUNTERS, 0)
    for it in iters:
        for c, v in pcg_derived_launches(s, it).items():
            derived[c] += v
    label = f"resetup {n}^3 {np.dtype(dtype).name}"
    tol_rap = 1e-5 if dtype == np.float32 else 1e-12
    for st in steps:
        check(st["status"] == 0, f"{label} k={st['k']} status")
        check(st["coarsen_calls"] == 0,
              f"{label} k={st['k']}: the hierarchy was re-coarsened")
        if rap:
            check(st["rap_rel_err"] <= tol_rap,
                  f"{label} k={st['k']}: coarse A vs R A P "
                  f"{st['rap_rel_err']:.3e}")
        check(st["true_rel_residual_f64"] <= (
            1e-5 if dtype == np.float32 else s.tolerance),
            f"{label} k={st['k']}: true residual "
            f"{st['true_rel_residual_f64']:.3e}")
    check([(lv["rows"], lv["format"]) for lv in amg.level_summary()]
          == shape, f"{label}: levels or formats changed")
    if fresh is not None:
        for st, sp in zip(steps, systems[1:]):
            t0 = time.perf_counter()
            Af = SparseMatrix.from_scipy(sp.astype(dtype), device=device,
                                         **kw)
            st["fresh_upload_s"] = time.perf_counter() - t0
            sf = T.create_solver(T.AMGConfig.from_string(fresh), "default",
                                 device=device)
            t0 = time.perf_counter()
            sf.setup(Af)
            st["fresh_setup_s"] = time.perf_counter() - t0
            st["fresh_iterations"] = int(sf.solve(b).iters)
            del sf, Af
    return s, {"setup": plan, "steps": steps, "launches": launches,
               "derived_launches": derived}, xs, Ak


def diffusion(m):
    """The DIA half's systems: ``poisson_3d_7pt(m)``, then
    -div(kappa_k grad u) on its pattern for k = 1, 2, 3."""
    from amgx_tpu_torch.io.poisson import poisson_scipy

    systems = [poisson_scipy((m, m, m)).tocsr()] + [
        variable_diffusion_3d(m, k) for k in (1, 2, 3)]
    for sp in systems[1:]:
        check(np.array_equal(sp.indptr, systems[0].indptr)
              and np.array_equal(sp.indices, systems[0].indices),
              "variable diffusion: pattern differs from poisson_3d_7pt")
    return systems


def heat(m):
    """The MATRIX_FREE half's systems: heat steps of dt 1 ... 0.125."""
    return [heat_step_3d(m, dt) for dt in (1.0, 0.5, 0.25, 0.125)]


REUSE_SYSTEMS = {"diffusion": diffusion, "heat": heat}
# (half, config, systems, formats) of the resetup phase
RESETUP_HALVES = (("DIA", REUSE_CFG, "diffusion", None),
                  ("MATRIX_FREE", MF_REUSE_CFG, "heat", MF_FORMATS))
CLASSICAL_REUSE_CFG = classical_cfg(', "structure_reuse_levels": -1, '
                                    '"setup_location": "DEVICE"')


def cpu_reuse(cfg, n, dtype, kind, formats, rap):
    """:func:`reuse_sequence` on the CPU over ``REUSE_SYSTEMS[kind](n)``
    as plain data: (records, the x of each step, each level's A as
    scipy CSR)."""
    import torch

    s, rec, xs, _ = reuse_sequence(torch, "cpu", cfg, n, dtype,
                                   REUSE_SYSTEMS[kind](n), formats, rap=rap)
    return rec, xs, [lv.A.to_scipy() for lv in s.precond.levels]


def levels_values(amg):
    """Clones of every level's A, P and R values on the device."""
    return [[getattr(lv, f).values.clone() for f in ("A", "P", "R")
             if getattr(lv, f) is not None] for lv in amg.levels]


def resetup_phase(torch, device="cuda", n=SLICE_N, n_cmp=SLICE_N, n_f64=64,
                  n_cl=64):
    """pcg_agg_resetup: the bench config with ``structure_reuse_levels``
    -1 set up once, then for k = 1, 2, 3 ``replace_values``,
    ``resetup`` and ``solve``.  DIA half: -div(kappa_k grad u) with
    kappa_k from ``default_rng(k)`` (the pattern of
    ``poisson_3d_7pt``), beside a fresh upload and setup of the bench
    config (no plans) on each A_k: what a step costs without reuse.
    MATRIX_FREE half: backward-Euler heat steps L + I/dt, dt = 1, 0.5,
    0.25, 0.125, on a MATRIX_FREE upload (every level stays
    MATRIX_FREE, x bit for bit the DIA hierarchy's on the same values).
    Both: launches as derived, two resetups with the same values equal
    bit for bit, the CPU port's sequence at ``n_cmp``^3 (iterations
    within one); the DIA half at ``n_f64``^3 f64 against the CPU
    (iterations equal, x to rtol 1e-9, coarse A to 1e-12), and
    classical reuse at ``n_cl``^3 f64 with the device setup on both
    (each level planned or not alike, resetup iterations equal).
    The CPU's sides come from :data:`CPU`.  Returns the launches of the
    two halves, summed."""
    total = dict.fromkeys(COUNTERS, 0)
    for half, cfg, kind, formats in RESETUP_HALVES:
        systems = REUSE_SYSTEMS[kind](n)
        s, rec, xs, Ak = reuse_sequence(
            torch, device, cfg, n, np.float32, systems, formats,
            fresh=BENCH_CFG if half == "DIA" else None)
        amg = s.precond
        # two resetups with the same values: the same hierarchy bits
        first = levels_values(amg)
        s.resetup(Ak.replace_values(Ak.values.clone()))
        again = levels_values(amg)
        bitwise = all(a.equal(b) for la, lb in zip(first, again)
                      for a, b in zip(la, lb))
        check(len(first) == len(again) and bitwise,
              f"{half}: two resetups with the same values differ")
        for c, v in rec["launches"].items():
            total[c] += v
        formats_now = [lv["format"] for lv in amg.level_summary()]
        if half == "MATRIX_FREE":
            check(all(f == "MATRIX_FREE" for f in formats_now),
                  f"MF resetup levels {formats_now}")
            _, _, xd, _ = reuse_sequence(torch, device, REUSE_CFG, n,
                                         np.float32, systems, rap=False)
            rec["x_bitwise_equal_dia"] = [
                a.tobytes() == b.tobytes() for a, b in zip(xs, xd)]
            check(all(rec["x_bitwise_equal_dia"]),
                  "MF resetup x differs from the DIA hierarchy's x")
        del s, amg
        crec, _, _ = CPU.get(cpu_reuse, cfg, n_cmp, np.float32, kind,
                             formats, False)
        rec["cpu_iterations"] = [st["iterations"] for st in crec["steps"]]
        rec["cpu_resetup_s"] = [st["resetup_s"] for st in crec["steps"]]
        rec["repeat_resetup_bitwise"] = bitwise
        print(json.dumps({"slice": f"poisson-pattern {n}^3 f32 "
                          f"pcg_agg_resetup {half} half (PCG + AMG SIZE_8 "
                          "V, structure_reuse_levels -1) on "
                          f"{device}", **rec}), flush=True)
        check_launches(f"resetup {half}", rec["launches"],
                       rec["derived_launches"], device)
        for st, ci in zip(rec["steps"], rec["cpu_iterations"]):
            check(abs(st["iterations"] - ci) <= 1 or n_cmp != n,
                  f"{half} k={st['k']}: iterations card {st['iterations']} "
                  f"vs cpu {ci}")

    # ---- n_f64^3 f64, DIA half: card against CPU
    s, rg, xg, _ = reuse_sequence(torch, device, REUSE_CFG, n_f64,
                                  np.float64, diffusion(n_f64))
    ag = [lv.A.to_scipy() for lv in s.precond.levels]
    del s
    rc, xc, ac = CPU.get(cpu_reuse, REUSE_CFG, n_f64, np.float64,
                         "diffusion", None, True)
    dx = max(float(np.abs(a - b).max()) for a, b in zip(xg, xc))
    dA = max(float(abs(a - b).max()) / float(abs(b).max())
             for a, b in zip(ag, ac))
    print(json.dumps({f"resetup_{n_f64}^3_f64": {
        "iterations": [st["iterations"] for st in rg["steps"]],
        "cpu_iterations": [st["iterations"] for st in rc["steps"]],
        "max_abs_diff_vs_cpu": dx, "coarse_A_rel_diff_vs_cpu": dA}}),
        flush=True)
    for sg_, sc_ in zip(rg["steps"], rc["steps"]):
        check(sg_["iterations"] == sc_["iterations"],
              f"resetup f64 iterations card {sg_['iterations']} vs cpu "
              f"{sc_['iterations']}")
    for a, b in zip(xg, xc):
        check(np.allclose(a, b, rtol=1e-9, atol=1e-9 * np.abs(b).max()),
              "resetup f64 x card vs cpu")
    check(dA <= 1e-12, f"resetup f64 coarse A card vs cpu {dA:.3e}")

    # ---- classical reuse at n_cl^3 f64, the device setup on both
    cl_cfg = CLASSICAL_REUSE_CFG
    s, rec, _, _ = reuse_sequence(torch, device, cl_cfg, n_cl, np.float64,
                                  diffusion(n_cl))
    del s
    cl = {device: rec, "cpu": CPU.get(cpu_reuse, cl_cfg, n_cl, np.float64,
                                      "diffusion", None, True)[0]}
    planned = {d: r["setup"]["planned"] for d, r in cl.items()}
    its = {d: [st["iterations"] for st in r["steps"]] for d, r in cl.items()}
    print(json.dumps({f"classical_resetup_{n_cl}^3_f64": {
        "planned": planned[device], "cpu_planned": planned["cpu"],
        "iterations": its[device], "cpu_iterations": its["cpu"],
        "plan_bytes": cl[device]["setup"]["plan_bytes"]}}), flush=True)
    check(planned[device] == planned["cpu"],
          f"classical plans card {planned[device]} vs cpu {planned['cpu']}")
    check(its[device] == its["cpu"],
          f"classical resetup iterations card {its[device]} vs cpu "
          f"{its['cpu']}")
    return total


# ---------------------------------------------------------------------------
# reduced-precision hierarchies, float-float refinement and the
# large-grid setup (phases 13-16)

# the JAX package's serve.CHEAP_PRECONDITIONER_CONFIG, key for key:
# ITERATIVE_REFINEMENT around PCG(8) around SIZE_8 aggregation AMG, an
# f32 hierarchy (ALL), OPT_POLYNOMIAL smoothing, an INEXACT coarse solve
CHEAP_CFG = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "ITERATIVE_REFINEMENT", "max_iters": 40,'
    ' "tolerance": 1e-8, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI", "precision_fallback": 1,'
    ' "preconditioner": {"scope": "inner", "solver": "PCG",'
    ' "max_iters": 8, "monitor_residual": 0,'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "hierarchy_dtype": "FLOAT32", "level_dtype_policy": "ALL",'
    ' "smoother": {"scope": "sm", "solver": "OPT_POLYNOMIAL",'
    ' "chebyshev_polynomial_order": 2, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 32, "max_levels": 10,'
    ' "structure_reuse_levels": -1,'
    ' "coarse_solver": "INEXACT",'
    ' "inexact_coarse_solver": "OPT_POLYNOMIAL", "cycle": "V",'
    ' "monitor_residual": 0}}}}'
)
# the refine path: a bf16 hierarchy (FLOAT32 casts nothing on an f32
# operator) and no Galerkin plans (nothing is reset up)
REFINE_BF16_CFG = CHEAP_CFG.replace(
    '"hierarchy_dtype": "FLOAT32"', '"hierarchy_dtype": "BFLOAT16"'
).replace('"structure_reuse_levels": -1', '"structure_reuse_levels": 0')
REFINE_SAME_CFG = REFINE_BF16_CFG.replace('"BFLOAT16"', '"SAME"')
# FLOAT32 under COARSE on an f64 operator: the level-0 R in f32 meets
# the f64 residual
CHEAP_COARSE_CFG = CHEAP_CFG.replace('"level_dtype_policy": "ALL"',
                                     '"level_dtype_policy": "COARSE"')
# plain f32 PCG to 1e-8 (monitored), preconditioned by the AMG of
# REFINE_SAME_CFG's hierarchy
PLAIN_PCG_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-8, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI", "preconditioner": "NOSOLVER"}}'
)
REFINE_N = 256
# the bench config with a bf16 hierarchy, the finest level included
MF_BF16_CFG = BENCH_CFG.replace(
    '"cycle": "V",', '"cycle": "V", "hierarchy_dtype": "BFLOAT16",'
    ' "level_dtype_policy": "ALL",')
# PCG_CLASSICAL with a bf16 hierarchy under COARSE
CLASSICAL_BF16_CFG = classical_cfg(', "hierarchy_dtype": "BFLOAT16"')
# PCG + SIZE_2 aggregation by matching (no geometric blocks)
SIZE2_MATCH_CFG = BENCH_CFG.replace(
    '"selector": "SIZE_8",',
    '"selector": "SIZE_2", "structured_aggregation": 0,').replace(
    '"min_coarse_rows": 512,', '"min_coarse_rows": 32,')

# the kernel entry points of the reduced-precision hierarchies: their
# source, the TPU kernel, the path whose launches are counted and the
# start of the name of the kernel case (at that path's shapes) whose
# times the summary gives
_DIA_SRC, _ELL_SRC = ("amgx_tpu_torch/csrc/dia_spmv.cu",
                      "amgx_tpu_torch/csrc/ell_spmv.cu")
_WELL = "amgx_tpu/ops/pallas_well.py:160"
VARIANTS = {
    "dia_spmv_bf16": (_DIA_SRC, "amgx_tpu/ops/pallas_dia.py:76",
                      "refine_bf16_256", "refine level1 A"),
    "ell_spmv_bf16": (_ELL_SRC, _WELL, "refine_bf16_256",
                      "refine level0 R"),
    "ell_spmv_bf16_f32": (_ELL_SRC, _WELL, "classical_bf16",
                          "classical_bf16 level0 R"),
    "ell_spmv_f32_f64": (_ELL_SRC, _WELL, "refine_f32_coarse_f64",
                         "cheap_coarse"),
    "sell_spmv_bf16": (_ELL_SRC, _WELL, "classical_bf16",
                       "classical_bf16 level1 A"),
    "stencil_spmv_bf16": ("amgx_tpu_torch/csrc/stencil_spmv.cu",
                          "amgx_tpu/ops/pallas_stencil.py:64", "mf_bf16_1",
                          "mf_bf16 level0 A"),
    # the serve layer's batched entry points (the serve phase)
    "dia_spmv_batched_f64": (_DIA_SRC, "amgx_tpu/ops/pallas_dia.py:76",
                             "serve_pcg_amg",
                             "serve dia_spmv_batched_f64 level0 A"),
    "ell_spmv_batched_f64": (_ELL_SRC, _WELL, "serve_pcg_amg",
                             "serve ell_spmv_batched_f64 level0 R"),
    "dia_spmv_batched_f32": (_DIA_SRC, "amgx_tpu/ops/pallas_dia.py:76",
                             "serve_default_f32",
                             "serve dia_spmv_batched_f32 level0 A"),
    "ell_spmv_batched_f32": (_ELL_SRC, _WELL, "serve_default_f32",
                             "serve ell_spmv_batched_f32 level0 R"),
    "sell_spmv_batched_f64": (_ELL_SRC, _WELL, "serve_mixed",
                              "serve sell_spmv_batched_f64 irregular A"),
    "sell_spmv_batched_f32": (_ELL_SRC, _WELL, "serve_default_f32",
                              "serve sell_spmv_batched_f32 irregular A"),
    # the C API's mixed modes (the capi phase)
    "dia_spmv_f32_f64": (_DIA_SRC, "amgx_tpu/ops/pallas_dia.py:76",
                         "capi_dDFI", "capi dDFI level0 A"),
    "dia_spmv_bf16_f32": (_DIA_SRC, "amgx_tpu/ops/pallas_dia.py:76",
                          "capi_dFBI", "capi dFBI A"),
    "sell_spmv_f32_f64": (_ELL_SRC, _WELL, "capi_dDFI_sell",
                          "capi dDFI irregular"),
    "sell_spmv_bf16_f32": (_ELL_SRC, _WELL, "capi_dFBI_sell",
                           "capi dFBI irregular"),
    # the complex modes and MATRIX_FREE in the mixed modes (the
    # capi_complex phase)
    **{f"dia_spmv_{t}": (_DIA_SRC, "amgx_tpu/ops/pallas_dia.py:76",
                         f"complex_d{m}", f"capi_complex d{m} A ")
       for t, m in (("c128", "ZZI"), ("c64", "CCI"), ("c64_c128", "ZCI"))},
    **{f"ell_spmv_{t}": (_ELL_SRC, _WELL, p, c) for t, p, c in (
        ("c128", "complex_dZZI", "capi_complex dZZI level0 R"),
        ("c64", "complex_dCCI", "capi_complex dCCI level0 R"),
        ("c64_c128", "complex_ell_dZCI", "capi_complex ell dZCI"))},
    **{f"sell_spmv_{t}": (_ELL_SRC, _WELL, f"complex_sell_d{m}",
                          f"capi_complex sell d{m}")
       for t, m in (("c128", "ZZI"), ("c64", "CCI"), ("c64_c128", "ZCI"))},
    **{f"stencil_spmv_{t}": ("amgx_tpu_torch/csrc/stencil_spmv.cu",
                             "amgx_tpu/ops/pallas_stencil.py:64",
                             f"complex_mf_d{m}",
                             f"capi_complex MF d{m} A {SLICE_N}^3 {c}")
       for t, m, c in (("c128", "ZZI", "complex128/complex128"),
                       ("c64", "ZCI", "complex64/complex64"),
                       ("c64_c128", "ZCI", "complex64/complex128"),
                       ("f32_f64", "DFI", "float32/float64"),
                       ("bf16_f32", "FBI", "bfloat16/float32"))},
    **{f"{k}_spmv_batched_{t}": (
        _DIA_SRC if k == "dia" else _ELL_SRC,
        "amgx_tpu/ops/pallas_dia.py:76" if k == "dia" else _WELL,
        f"complex_batch_d{m}_{'irregular' if k == 'sell' else 'grid'}",
        f"capi_complex {k}_spmv_batched_{t}")
       for k in ("dia", "ell", "sell")
       for t, m in (("c128", "ZZI"), ("c64", "CCI"))},
}


def sweep_spmvs(sm):
    """A-SpMVs of one sweep of smoother ``sm``: the order of CHEBYSHEV
    and OPT_POLYNOMIAL (a residual and order - 1 products), one for
    the Jacobi smoothers."""
    from amgx_tpu_torch.solvers.chebyshev import ChebyshevSolver

    return max(sm.order, 1) if isinstance(sm, ChebyshevSolver) else 1


def coarse_solve_spmvs(amg):
    """A-SpMVs of one coarse solve: the residual, and for INEXACT its
    sweeps (``sweep_budget``) of its smoother."""
    from amgx_tpu_torch.solvers.inexact import InexactCoarseSolver

    cs = amg.coarse_solver
    if isinstance(cs, InexactCoarseSolver):
        return 1 + cs.inner.max_iters * sweep_spmvs(cs.inner)
    return 1


def variant_of(m, x_dtype):
    """The entry point an SpMV of ``m`` on an x of ``x_dtype`` launches,
    "csr" for a CSR product, None for a dense one."""
    from amgx_tpu_torch.ops import kernels

    c = counter_of(m)
    if c in (None, "csr"):
        return c
    return kernels.entry_point(c, m.dtype, x_dtype)


def derived_variant_launches(amg, cycles, top=(), setup_spmvs=0,
                             coarse_setup_spmvs=0):
    """Launches per entry point (and CSR products) of ``cycles`` cycles
    of ``amg`` by :func:`cycle_walk`, each operand in the dtype the
    cycle gives it (A and R meet their level's vectors, P the coarser
    level's correction), and the ``top`` SpMVs ``(matrix, x dtype,
    count)`` outside the cycle; each smoothed level's setup makes
    ``setup_spmvs`` A-SpMVs (a power iteration), the coarsest level's
    coarse solver ``coarse_setup_spmvs``."""
    counts = {}

    def add(m, xdt, k):
        v = variant_of(m, xdt)
        if v is not None and k:
            counts[v] = counts.get(v, 0) + k

    for m, xdt, k in top:
        add(m, xdt, k)
    lv = amg.levels
    sm = next((lvl.smoother for lvl in lv if lvl.smoother is not None),
              None)
    walk = cycle_walk(amg, sweep_spmvs(sm) if sm is not None else 1,
                      coarse_solve_spmvs(amg))
    for (i, f), k in walk.items():
        xdt = lv[i + 1].A.dtype if f == "P" else lv[i].A.dtype
        add(getattr(lv[i], f), xdt, cycles * k)
    for lvl in lv:
        if lvl.smoother is not None:
            add(lvl.A, lvl.A.dtype, setup_spmvs)
    add(lv[-1].A, lv[-1].A.dtype, coarse_setup_spmvs)
    return counts


def check_variants(label, launches, derived, device):
    """Every entry point's launches (and the CSR products) equal to
    the derived count (the wrappers count only launches on the
    card)."""
    if device != "cuda":
        return
    keys = sorted(set(launches) | set(derived))
    got = {k: launches.get(k, 0) for k in keys}
    want = {k: derived.get(k, 0) for k in keys}
    check(got == want, f"{label}: launches {got} != derived {want}")


def bytes_by_dtype(mats):
    """Device bytes of the tensors of the SparseMatrix objects
    ``mats`` (every format and the sliced layout), by dtype."""
    import dataclasses

    import torch

    out, seen = {}, set()

    def add(t):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            k = str(t.dtype).replace("torch.", "")
            out[k] = out.get(k, 0) + t.numel() * t.element_size()

    for m in mats:
        if m is None:
            continue
        for f in dataclasses.fields(m):
            add(getattr(m, f.name))
        if m.sell is not None:
            for f in dataclasses.fields(m.sell):
                add(getattr(m.sell, f.name))
    return out


def hierarchy_bytes(amg):
    return bytes_by_dtype(
        [m for lvl in amg.levels for m in (lvl.A, lvl.P, lvl.R)])


def rel_residual_sp(Asp, b, x):
    b64 = np.asarray(b, np.float64)
    r = b64 - Asp @ np.asarray(x, np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b64))


def dia_bf16_edge_case(torch, rng, n, offsets, sms):
    """The bf16 DIA kernel bit for bit with its plain version on edge
    inputs: x holds bf16 subnormals of both signs, -0.0 and one +inf
    and one -inf (further apart than any two diagonals reach, so no row
    meets both and no NaN arises), the planes random normals with
    subnormal entries and no zero.  Prints and returns the record."""
    from amgx_tpu_torch.ops import dia

    nd = len(offsets)
    vals = rng.standard_normal((nd, n))
    sub = rng.random((nd, n)) < 0.05
    vals[sub] = rng.choice([-1.0, 1.0], int(sub.sum())) * rng.uniform(
        1e-40, 1e-38, int(sub.sum()))
    x = rng.standard_normal(n)
    pick = rng.random(n)
    x[pick < 0.1] = rng.choice([-1.0, 1.0], int((pick < 0.1).sum())) * \
        rng.uniform(1e-40, 1e-38, int((pick < 0.1).sum()))
    x[(pick >= 0.1) & (pick < 0.2)] = -0.0
    reach = max(abs(o) for o in offsets)
    x[n // 4] = np.inf
    if n // 4 + 2 * reach + 1 < n:
        x[n // 4 + 2 * reach + 1] = -np.inf
    V = torch.from_numpy(vals).cuda().to(torch.bfloat16)
    X = torch.from_numpy(x).cuda().to(torch.bfloat16)
    y = dia.dia_spmv(V, offsets, X)
    yp = dia.dia_spmv_plain(V, offsets, X)
    torch.cuda.synchronize()
    nan = int(torch.isnan(y).sum()) + int(torch.isnan(yp).sum())
    same = bool(torch.equal(y.view(torch.int16), yp.view(torch.int16)))
    plan = dia.dia_launch_plan(n, offsets, torch.bfloat16, sms)
    rec = {"case": f"bf16 edge inputs n={n} {nd} diagonals",
           "kernel": "dia_spmv_bf16", "offsets": list(offsets),
           "plan": {k: v for k, v in plan._asdict().items()
                    if k != "offsets"},
           "bitwise": same, "nan_outputs": nan,
           "inf_outputs": int(torch.isinf(y).sum()),
           "subnormal_x": int((X != 0).logical_and(
               X.abs() < torch.finfo(torch.bfloat16).tiny).sum()),
           "subnormal_outputs": int((y != 0).logical_and(
               y.abs() < torch.finfo(torch.bfloat16).tiny).sum()),
           "negative_zero_x": int((X == 0).logical_and(
               torch.signbit(X)).sum())}
    print(json.dumps(rec), flush=True)
    check(nan == 0, f"{rec['case']}: {nan} NaN outputs")
    check(same, f"{rec['case']}: kernel vs plain not bit for bit")
    check(rec["inf_outputs"] > 0 and rec["subnormal_x"] > 0
          and rec["negative_zero_x"] > 0,
          f"{rec['case']}: the edge inputs did not reach the kernel")
    return rec


def variant_case(torch, timer, peaks, name, label, m, x, run, plain,
                 nbytes, extra=None, exact=True):
    """One bf16 or mixed-dtype entry point ``name`` on operator ``m``
    (a SparseMatrix on the card) and ``x``: held to its plain version
    on the same inputs bit for bit (each sums in the plain version's
    order, rounding as it does), or with ``exact`` False (a sliced
    kernel adding a row's parts in its lanes' tree) within TOL of the
    row's |A||x|; CUDA-event times cold and warm,
    profiler device time, the bound (``nbytes``, bf16 at 2 bytes; the
    f32 or f64 rate the arithmetic runs at) and torch's CSR product on
    the same values, or None where torch has none for the dtypes."""
    import scipy.sparse as sps

    from amgx_tpu_torch.core.types import host_array

    y, yp = run(), plain()
    torch.cuda.synchronize()
    check(y.shape == yp.shape and y.dtype == yp.dtype,
          f"{label}: {y.dtype} {tuple(y.shape)} vs plain {yp.dtype} "
          f"{tuple(yp.shape)}")
    check(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
    ro, ci, _ = m._host
    vals = np.abs(host_array(m.values)).astype(np.float64)
    sp = sps.csr_matrix((vals, ci, ro), shape=m.shape)
    scale = sp @ np.abs(host_array(x)).astype(np.float64)
    wide = np.complex128 if y.is_complex() else np.float64
    d = np.abs(host_array(y).astype(wide) - host_array(yp).astype(wide))
    same = bool(torch.equal(y, yp))
    rel_row = float(np.max(d / np.maximum(scale, 1e-300))) if d.size else 0.0
    if exact:
        check(same, f"{label}: kernel vs plain max abs diff "
              f"{float(d.max()):.3e}, not bit for bit")
    else:
        # a kernel summing in another order than the plain version's
        tol = TOL[str(y.dtype).replace("torch.", "")]
        check(rel_row <= tol, f"{label}: kernel vs plain {rel_row:.3e} of "
              f"the row's |A||x| > {tol}")
    lib = None
    try:
        dt = y.dtype
        A = torch.sparse_csr_tensor(
            torch.from_numpy(ro.astype(np.int32)).cuda(),
            torch.from_numpy(ci.astype(np.int32)).cuda(),
            m.values.to(dt), size=m.shape)
        xl = x.to(dt)
        torch.mv(A, xl)
        torch.cuda.synchronize()
        lib = timer(lambda: torch.mv(A, xl))
    except (RuntimeError, NotImplementedError) as e:
        print(json.dumps({"library_none": {"case": label,
                                           "error": str(e)[:200]}}),
              flush=True)
    # a complex term is 4 products and 4 sums in the real type
    ops = (8 if y.is_complex() else 2) * m.nnz
    kind = "f64" if y.dtype in (torch.float64, torch.complex128) else "f32"
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = ops / peaks[kind] * 1e3
    rec = {
        "case": label, "kernel": name,
        "dtypes": [str(m.dtype)[6:], str(x.dtype)[6:], str(y.dtype)[6:]],
        "bitwise": same, "max_abs_err": float(d.max()) if d.size else 0.0,
        "max_rel_err_of_row_abs": rel_row,
        "kernel_ms": timer(run), "kernel_ms_warm_l2": timer(run,
                                                          flush=False),
        "kernel_device_ms": timer.device(run, ACTIVITY[name.split("_")[0]
                                                       + "_spmv"]),
        "plain_ms": timer(plain), "library_ms": lib,
        "bytes": int(nbytes), "ops": ops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        **(extra or {}),
    }
    print(json.dumps(rec), flush=True)
    return rec


def transfer_cases(torch, timer, peaks, rng, amg, label, ops):
    """The slot-major ELL kernel at the level-0 transfers of ``amg``
    against its plain version: ``ops`` is ``(("R" | "P", x dtype),
    ...)``."""
    from amgx_tpu_torch.ops import ell

    recs = []
    for f, xdt in ops:
        m = getattr(amg.levels[0], f)
        check(m.format == "ELL" and m.sell is None,
              f"{label} level-0 {f}: {m.format}, sliced "
              f"{m.sell is not None}")
        x = torch.from_numpy(rng.standard_normal(m.n_cols)).cuda().to(xdt)
        ydt = torch.promote_types(m.dtype, xdt)
        isz = {torch.bfloat16: 2, torch.float32: 4, torch.float64: 8}
        w = int(m.ell_cols.shape[0])
        recs.append(variant_case(
            torch, timer, peaks, variant_of(m, xdt),
            f"{label} level0 {f} {m.n_rows}x{m.n_cols} w={w} "
            f"{str(m.dtype)[6:]}/{str(xdt)[6:]}", m, x,
            lambda m=m, x=x: ell.ell_spmv(m.ell_cols, m.ell_vals, x),
            lambda m=m, x=x: ell.ell_spmv_plain(m.ell_cols, m.ell_vals, x),
            nbytes=m.nnz * (4 + isz[m.dtype]) + m.n_cols * isz[xdt]
            + m.n_rows * isz[ydt]))
    return recs


def refine_phase(torch, peaks=None, device="cuda", n=REFINE_N, n_cmp=64,
                 same=True, n_same=None):
    """refine_bf16_256, the reduced-precision path: ``REFINE_BF16_CFG``
    (ITERATIVE_REFINEMENT + PCG(8) + SIZE_8 AMG in bf16, OPT_POLYNOMIAL,
    INEXACT) on ``poisson_3d_7pt(n)`` in f32, counts zeroed just before
    setup and read just after the solve: levels with rows, nnz, format
    and dtype, level 0's Galerkin product through ``geo_galerkin_dia``
    (against scipy's R A P), setup phases, bytes by dtype, corrections,
    inner iterations and fallbacks (the first attempt's status before
    any), the true residual in f64 (<= 1e-8), launches per entry point
    as derived, first and warm solve time, a trace, the kernel cases of
    its bf16 operators.  Beside it on the same grid: the solve with
    ``hierarchy_dtype`` SAME (``same``), and plain f32 PCG on that
    hierarchy to 1e-8, both on an ``n_same``^3 grid (default: ``n`` up
    to 128; the depth cut that made room for the async slice's checks,
    it ran at ``n``^3).  Then,
    card against the CPU port: the path's
    config at ``n_cmp``^3 f32, CHEAP_CFG verbatim on an ``n_cmp``^3 f64
    operator, and (counted as the path ``refine_f32_coarse_f64``)
    CHEAP_CFG under COARSE at ``n_cmp``^3 f64.  ``peaks`` None (a
    rehearsal on the CPU) skips the kernel cases and the trace.  Returns
    ({path: launches}, kernel records)."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.amg import aggregation as agg_mod
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_rhs, poisson_scipy
    from amgx_tpu_torch.ops import dia

    rng = np.random.default_rng(9)
    t0 = time.perf_counter()
    Asp = poisson_scipy((n, n, n))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = SparseMatrix.from_scipy(Asp.astype(np.float32), device=device)
    upload_s = time.perf_counter() - t0
    b = poisson_rhs(A.n_rows, dtype=np.float32)
    geo_calls = []
    real_geo = agg_mod.geo_galerkin_dia

    def geo_spy(Asp_, grid, block, device="cpu", dia=None):
        out = real_geo(Asp_, grid, block, device=device, dia=dia)
        geo_calls.append((Asp_.shape[0], grid, block, out))
        return out

    agg_mod.geo_galerkin_dia = geo_spy
    try:
        # ---- the main path: counts zeroed just before, read just after
        zero_counts()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = T.create_solver(T.AMGConfig.from_string(REFINE_BF16_CFG),
                            "default", device=device)
        s.setup(A)
        setup_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if device == "cuda" \
            else None
        res = s.solve(b)
        launches = variant_counts()
    finally:
        agg_mod.geo_galerkin_dia = real_geo
    amg = s.inner.precond
    corr, inner = int(res.iters), s.last_inner_iters
    first = s.first_attempt
    solve_s = s.solve_time
    x = res.x.numpy()
    rel = rel_residual_sp(Asp, b, x)
    res2 = s.solve(b)
    warm_s = s.solve_time
    # inner PCG(8), unmonitored: r0 and 8 A p a solve, a cycle each
    per = 9
    derived = derived_variant_launches(
        amg, per * corr, top=((A, A.dtype, per * corr),),
        setup_spmvs=20, coarse_setup_spmvs=20)
    # level 0's Galerkin product: geometric, on the device, against
    # scipy's R A P in f64
    g0 = next((c for c in geo_calls if c[0] == A.n_rows), None)
    lvl0 = amg.levels[0]
    geo = {"geo_calls": [(c[0], list(c[1]), list(c[2]), c[3] is not None)
                         for c in geo_calls]}
    if g0 is not None and g0[3] is not None:
        Pm = lvl0.P.host_csr().astype(np.float64)
        t0 = time.perf_counter()
        ref = (Pm.T.tocsr() @ Asp @ Pm).tocsr()
        geo["scipy_rap_s"] = time.perf_counter() - t0
        Ac = g0[3]
        err = float(abs(Ac.astype(np.float64) - ref).max())
        geo["coarse_vs_scipy_rap_over_max"] = err / float(
            abs(ref).max())
        from amgx_tpu_torch.core.types import host_array

        Ab = torch.from_numpy(Ac.data).to(torch.bfloat16)
        geo["level1_bf16_equals_cast"] = bool(np.array_equal(
            host_array(Ab), host_array(amg.levels[1].A.values)))
        del ref, Pm
    rec = {
        "slice": f"refine_bf16_256: poisson7 {n}^3 f32 "
                 "ITERATIVE_REFINEMENT + PCG(8) + AMG SIZE_8 bf16 (ALL), "
                 f"OPT_POLYNOMIAL, INEXACT on {device}",
        "rows": A.n_rows, "nnz": A.nnz, "levels": amg.level_summary(),
        "transfer_dtypes": [(None if lv.P is None else str(lv.P.dtype)[6:],
                             None if lv.R is None else str(lv.R.dtype)[6:])
                            for lv in amg.levels],
        "poisson_scipy_s": gen_s, "upload_s": upload_s,
        "setup_s": setup_s, "setup_profile": amg.setup_profile,
        "setup_peak_bytes": peak,
        "operator_bytes": bytes_by_dtype([A]),
        "hierarchy_bytes": hierarchy_bytes(amg),
        "first_attempt": {"status": first[0], "corrections": first[1]},
        "corrections": corr, "status": int(res.status),
        "last_inner_iters": inner,
        "precision_fallbacks": s.precision_fallbacks,
        "true_rel_residual_f64": rel, "solve_s": solve_s,
        "solve_warm_s": warm_s,
        "cycle_passes_per_iteration": amg.cycle_passes_per_iteration(),
        "launches": launches, "derived_launches": derived,
        "repeat_solve_x_bitwise": bool(np.array_equal(x,
                                                      res2.x.numpy())),
        **geo,
    }
    print(json.dumps(rec), flush=True)
    # the bf16 hierarchy itself must reach 1e-8: a guardrail trip (a
    # re-solve at SAME) fails the path
    check(s.precision_fallbacks == 0 and first[0] == 0,
          f"refine: the bf16 solve fell back (first attempt status "
          f"{first[0]}, {s.precision_fallbacks} fallbacks)")
    check(int(res.status) == 0, f"refine status {res.status}")
    check(rel <= 1e-8, f"refine true relative residual {rel:.3e} > 1e-8")
    check(inner == 8 * corr,
          f"refine inner iterations {inner} for {corr} corrections")
    check(all(lv.A.dtype == torch.bfloat16 for lv in amg.levels),
          "refine: a level is not bf16")
    check(g0 is not None and g0[3] is not None,
          f"refine: level 0's Galerkin product did not take "
          f"geo_galerkin_dia ({geo['geo_calls']})")
    check(geo["coarse_vs_scipy_rap_over_max"] <= 1e-6,
          f"refine: coarse A vs scipy RAP "
          f"{geo['coarse_vs_scipy_rap_over_max']:.3e} x max")
    check(geo["level1_bf16_equals_cast"],
          "refine: level 1 is not the bf16 cast of the Galerkin product")
    walk_a = sum(k for (_, f), k in cycle_walk(
        amg, sweep_spmvs(amg.levels[0].smoother),
        coarse_solve_spmvs(amg)).items() if f == "A")
    check(walk_a == rec["cycle_passes_per_iteration"],
          f"refine: the walk counts {walk_a} A-SpMVs a cycle, the cycle "
          f"made {rec['cycle_passes_per_iteration']}")
    check_variants("refine", launches, derived, device)
    by_path = {"refine_bf16_256": launches}
    recs = []
    if peaks is not None:
        trace_solve(torch, s, b, corr * per, groups=TRACE_GROUPS)
        timer = Timer(torch)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for lv in (1, 0):
            m = amg.levels[lv].A
            xm = torch.from_numpy(rng.standard_normal(m.n_rows)).cuda().to(
                torch.bfloat16)
            plan = dia.dia_launch_plan(m.n_rows, m.dia_offsets, m.dtype,
                                       sms)
            recs.append(variant_case(
                torch, timer, peaks, "dia_spmv_bf16",
                f"refine level{lv} A {m.n_rows} rows bf16", m, xm,
                lambda m=m, xm=xm: dia.dia_spmv(m.dia_vals, m.dia_offsets,
                                                xm),
                lambda m=m, xm=xm: dia.dia_spmv_plain(m.dia_vals,
                                                      m.dia_offsets, xm),
                nbytes=2 * (m.nnz + 2 * m.n_rows) + 4 * len(m.dia_offsets),
                extra={"plan": {k: v for k, v in plan._asdict().items()
                                if k != "offsets"}}))
            del xm
        recs += transfer_cases(torch, timer, peaks, rng, amg, "refine",
                               (("R", torch.bfloat16), ("R", torch.float32),
                                ("P", torch.bfloat16)))
    del s, res, res2, amg, A, Asp

    if same:
        # ---- the same solve on an f32 hierarchy; plain f32 PCG on it
        n_same = min(n, SLICE_N) if n_same is None else n_same
        Asp = poisson_scipy((n_same,) * 3)
        A = SparseMatrix.from_scipy(Asp.astype(np.float32), device=device)
        b = poisson_rhs(A.n_rows, dtype=np.float32)
        t0 = time.perf_counter()
        s2 = T.create_solver(T.AMGConfig.from_string(REFINE_SAME_CFG),
                             "default", device=device)
        s2.setup(A)
        setup2_s = time.perf_counter() - t0
        r2 = s2.solve(b)
        s2.solve(b)
        amg2 = s2.inner.precond
        pcg = T.create_solver(T.AMGConfig.from_string(PLAIN_PCG_CFG),
                              "default", device=device)
        pcg.precond = amg2  # the same hierarchy, set up once
        pcg.A, pcg._params = A, (A, amg2.apply_params())
        rp = pcg.solve(b)
        print(json.dumps({f"refine_same_{n_same}": {
            "setup_s": setup2_s, "solve_warm_s": s2.solve_time,
            "corrections": int(r2.iters), "status": int(r2.status),
            "last_inner_iters": s2.last_inner_iters,
            "hierarchy_bytes": hierarchy_bytes(amg2),
            "true_rel_residual_f64": rel_residual_sp(Asp, b,
                                                     r2.x.numpy()),
            "plain_f32_pcg": {
                "iterations": int(rp.iters), "status": int(rp.status),
                "monitored_rel_residual": monitored_ratio(rp),
                "true_rel_residual_f64": rel_residual_sp(
                    Asp, b, rp.x.cpu().numpy()),
                "solve_s": pcg.solve_time}}}), flush=True)
        check(int(r2.status) == 0, f"refine SAME status {r2.status}")
        del s2, r2, amg2, pcg, rp, A, Asp

    # ---- card against the CPU port
    def card_cpu(label, cfg, dtype, x_tol=None, count=False):
        if count:
            zero_counts()
        sg, rg, bg = refine_run(cfg, device, n_cmp, dtype)
        got = variant_counts()
        rc = CPU.get(refine_cpu, cfg, n_cmp, dtype)
        Am = poisson_scipy((n_cmp,) * 3)
        xg, xc = rg.x.numpy(), rc["x"]
        d = float(np.abs(xg - xc).max())
        out = {"n": n_cmp, "corrections": int(rg.iters),
               "cpu_corrections": rc["iterations"], "status": int(rg.status),
               "cpu_status": rc["status"],
               "true_rel_residual_f64": rel_residual_sp(Am, bg, xg),
               "cpu_true_rel_residual_f64": rel_residual_sp(Am, bg, xc),
               "max_abs_diff_vs_cpu": d, "x_inf": float(np.abs(xc).max()),
               "levels": [(lv.n_rows, str(lv.A.dtype)[6:],
                           None if lv.R is None else str(lv.R.dtype)[6:])
                          for lv in sg.inner.precond.levels],
               "precision_fallbacks": sg.precision_fallbacks}
        print(json.dumps({label: out}), flush=True)
        check(out["status"] == 0 and out["cpu_status"] == 0,
              f"{label}: status card {rg.status} cpu {rc['status']}")
        check(sg.precision_fallbacks == 0 and rc["precision_fallbacks"] == 0,
              f"{label}: fallbacks card {sg.precision_fallbacks} cpu "
              f"{rc['precision_fallbacks']}")
        check(abs(out["corrections"] - out["cpu_corrections"]) <= 1,
              f"{label}: corrections card {rg.iters} cpu {rc['iterations']}")
        check(max(out["true_rel_residual_f64"],
                  out["cpu_true_rel_residual_f64"]) <= 1e-8,
              f"{label}: true residual above 1e-8 ({out})")
        if x_tol is not None:
            check(d <= x_tol * out["x_inf"],
                  f"{label}: x card vs cpu max abs diff {d:.3e}")
        if count:
            corr_g = int(rg.iters)
            der = derived_variant_launches(
                sg.inner.precond, 9 * corr_g,
                top=((sg.A, sg.A.dtype, 9 * corr_g),), setup_spmvs=20,
                coarse_setup_spmvs=20)
            check_variants(label, got, der, device)
        return got, sg

    card_cpu(f"refine_bf16_{n_cmp}^3_f32_vs_cpu", REFINE_BF16_CFG,
             np.float32)
    card_cpu(f"cheap_{n_cmp}^3_f64_vs_cpu", CHEAP_CFG, np.float64,
             x_tol=1e-7)
    got, sg = card_cpu(f"cheap_coarse_{n_cmp}^3_f64_vs_cpu",
                       CHEAP_COARSE_CFG, np.float64, x_tol=1e-7,
                       count=True)
    by_path["refine_f32_coarse_f64"] = got
    if peaks is not None:
        recs += transfer_cases(torch, Timer(torch), peaks, rng,
                               sg.inner.precond, f"cheap_coarse {n_cmp}^3",
                               (("R", torch.float64),))
    return by_path, recs


def refine_run(cfg, device, m, dtype):
    """``cfg`` on the ``m``^3 Poisson system in ``dtype`` on ``device``:
    (solver, result, b)."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_rhs, poisson_scipy

    Am = SparseMatrix.from_scipy(poisson_scipy((m, m, m)).astype(dtype),
                                 device=device)
    bm = poisson_rhs(Am.n_rows, dtype=dtype)
    sm = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                         device=device)
    sm.setup(Am)
    return sm, sm.solve(bm), bm


def refine_cpu(cfg, m, dtype):
    """:func:`refine_run` on the CPU as plain data."""
    sc, rc, _ = refine_run(cfg, "cpu", m, dtype)
    return {"iterations": int(rc.iters), "status": int(rc.status),
            "x": rc.x.numpy(), "precision_fallbacks": sc.precision_fallbacks}


def mf_bf16_phase(torch, peaks=None, device="cuda", n=SLICE_N):
    """mf_bf16: the bench config with a bf16 hierarchy (ALL) at ``n``^3
    f32, ``matrix_free`` 0 then 1 (the operator uploaded with the
    MATRIX_FREE format): every coarse A-SpMV on the DIA kernel's bf16
    instantiation, then the stencil kernel's; launches per entry point
    as derived; x bit for bit between the two; the level-0 stencil in
    bf16 against its plain version and the DIA kernel.  Returns
    ({path: launches}, kernel records)."""
    from amgx_tpu_torch.ops import dia, stencil

    out, xs, recs = {}, [], []
    for mf in (0, 1):
        cfg = MF_BF16_CFG.replace('"cycle": "V",',
                                  f'"cycle": "V", "matrix_free": {mf},')
        zero_counts()
        s, res, setup_s, b, upload_s = solve_on(
            device, cfg, n, np.float32,
            accel_formats=MF_FORMATS if mf else None)
        launches = variant_counts()
        amg = s.precond
        iters = int(res.iters)
        derived = derived_variant_launches(
            amg, iters + 1, top=((s.A, s.A.dtype, iters + 1),))
        rec, x = path_record(f"mf_bf16 matrix_free={mf}", s, res, b, n,
                             launches, derived, setup_s, upload_s, amg,
                             walk_check=not mf)
        rec["hierarchy_bytes"] = hierarchy_bytes(amg)
        print(json.dumps({"slice": f"mf_bf16: poisson7 {n}^3 f32 bench "
                          f"PCG + AMG bf16 (ALL) matrix_free={mf} on "
                          f"{device}", **rec}), flush=True)
        check(all(lv.A.dtype == torch.bfloat16 for lv in amg.levels),
              "mf_bf16: a level is not bf16")
        check_variants(f"mf_bf16 matrix_free={mf}", launches, derived,
                       device)
        out[f"mf_bf16_{mf}"] = launches
        xs.append(x)
        if mf and peaks is not None:
            A0 = amg.levels[0].A
            check(A0.has_matrix_free, "mf_bf16: level 0 not MATRIX_FREE")
            D0 = A0.__class__.from_scipy(
                A0.host_csr(), device="cuda",
                accel_formats=("dia",)).astype(torch.bfloat16)
            rng = np.random.default_rng(12)
            x0 = torch.from_numpy(rng.standard_normal(A0.n_rows)).cuda(
            ).to(torch.bfloat16)
            y_st = stencil.stencil_spmv(A0, x0)
            y_dia = dia.dia_spmv(D0.dia_vals, D0.dia_offsets, x0)
            torch.cuda.synchronize()
            check(torch.equal(y_st, y_dia),
                  "mf_bf16: stencil vs DIA kernel in bf16 not bit for bit")
            recs.append(variant_case(
                torch, Timer(torch), peaks, "stencil_spmv_bf16",
                f"mf_bf16 level0 A {n}^3 bf16", A0, x0,
                lambda: stencil.stencil_spmv(A0, x0),
                lambda: stencil.stencil_spmv_plain(A0.mf_meta, A0.mf_coefs,
                                                   x0),
                nbytes=2 * 2 * A0.n_rows + 2 * len(A0.mf_meta.steps)))
        del s, res
    check(np.array_equal(xs[0], xs[1]),
          "mf_bf16: matrix_free=1 x is not the matrix_free=0 x bit for "
          f"bit (max abs diff {float(np.abs(xs[0] - xs[1]).max()):.3e})")
    return out, recs


def classical_bf16_phase(torch, peaks=None, device="cuda", n=96,
                         n_cpu=96):
    """classical_bf16: PCG_CLASSICAL with a bf16 hierarchy (COARSE) at
    ``n``^3 f32, setup on ``device``: the sliced ELL kernel's bf16
    instantiation on the coarse A, the level-0 R's (bf16, f32) one, the
    CSR products of the bf16 P; launches per entry point as derived;
    the CPU port at ``n_cpu``^3 (iterations within one); every sliced
    bf16 operator of the hierarchy (one lane a row) and the level-0 R
    against their plain versions, bit for bit.  Returns
    ({path: launches}, kernel records)."""
    from amgx_tpu_torch.ops import ell

    cfg = CLASSICAL_BF16_CFG
    zero_counts()
    s, res, setup_s, b, upload_s = solve_on(device, cfg, n, np.float32)
    launches = variant_counts()
    amg = s.precond
    iters = int(res.iters)
    derived = derived_variant_launches(
        amg, iters + 1, top=((s.A, s.A.dtype, iters + 1),))
    rec, _ = path_record("classical_bf16", s, res, b, n, launches, derived,
                         setup_s, upload_s, amg)
    rec["hierarchy_bytes"] = hierarchy_bytes(amg)
    rec["transfer_formats"] = [
        (None if lv.P is None else (lv.P.format, str(lv.P.dtype)[6:],
                                    lv.P.sell is not None),
         None if lv.R is None else (lv.R.format, str(lv.R.dtype)[6:],
                                    lv.R.sell is not None))
        for lv in amg.levels]
    print(json.dumps({"slice": f"classical_bf16: poisson7 {n}^3 f32 "
                      "PCG_CLASSICAL + bf16 hierarchy (COARSE) on "
                      f"{device}", **rec}), flush=True)
    check_variants("classical_bf16", launches, derived, device)
    recs = []
    if peaks is not None:
        check(launches.get("sell_spmv_bf16", 0) > 0
              and launches.get("ell_spmv_bf16_f32", 0) > 0,
              f"classical_bf16: launches {launches}")
        timer = Timer(torch)
        rng = np.random.default_rng(13)
        # every sliced bf16 operator of the hierarchy, at its own plan
        # (one lane a row), bit for bit its plain version
        sliced = []
        for i, lv in enumerate(amg.levels):
            for f in ("A", "P", "R"):
                m = getattr(lv, f)
                if m is None or m.sell is None \
                        or m.dtype != torch.bfloat16:
                    continue
                xm = torch.from_numpy(rng.standard_normal(
                    m.n_cols)).cuda().to(torch.bfloat16)
                y = ell.sell_spmv(m.sell, xm)
                yp = ell.sell_spmv_plain(m.sell, xm)
                torch.cuda.synchronize()
                sliced.append((i, f, m.n_rows, m.sell.lanes,
                               bool(torch.equal(y, yp))))
        print(json.dumps({"classical_bf16_sliced_vs_plain": sliced}),
              flush=True)
        check(len(sliced) >= 1 and all(c[4] for c in sliced),
              f"classical_bf16: sliced bf16 kernel vs plain {sliced}")
        l1 = amg.levels[1].A
        check(l1.sell is not None and l1.dtype == torch.bfloat16,
              "classical_bf16: level-1 A not sliced bf16")
        x1 = torch.from_numpy(rng.standard_normal(l1.n_rows)).cuda().to(
            torch.bfloat16)
        recs.append(variant_case(
            torch, timer, peaks, "sell_spmv_bf16",
            f"classical_bf16 level1 A {l1.n_rows} rows bf16 "
            f"(lanes {l1.sell.lanes})", l1, x1,
            lambda: ell.sell_spmv(l1.sell, x1),
            lambda: ell.sell_spmv_plain(l1.sell, x1),
            nbytes=6 * l1.nnz + 2 * 2 * l1.n_rows))
        recs += transfer_cases(torch, timer, peaks, rng, amg,
                               "classical_bf16", (("R", torch.float32),))
    del s, res
    rc = CPU.get(cpu_solve, cfg, n_cpu, np.float32)
    print(json.dumps({"classical_bf16_cpu": {
        "n": n_cpu, **{k: rc[k] for k in (
            "iterations", "status", "setup_s", "solve_s",
            "true_rel_residual_f64")}}}), flush=True)
    check(rc["status"] == 0, f"classical_bf16 cpu status {rc['status']}")
    check(abs(rc["iterations"] - iters) <= 1 or n_cpu != n,
          f"classical_bf16 iterations card {iters} vs cpu "
          f"{rc['iterations']}")
    return {"classical_bf16": launches}, recs


def match_graph(label, n):
    """The edge weights of the ``n``^3 Poisson ("poisson") or shuffled
    Poisson ("shuffled") matrix, as the matchers take them."""
    from amgx_tpu_torch.amg import aggregation as ag
    from amgx_tpu_torch.io.poisson import poisson_scipy

    Asp = (poisson_scipy((n, n, n)) if label == "poisson"
           else shuffled_poisson(n))
    return ag.edge_weights(Asp.tocsr())


def host_match(label, n):
    """The host matcher on :func:`match_graph`: (aggregates, seconds)."""
    from amgx_tpu_torch.amg import aggregation as ag

    W = match_graph(label, n)
    t0 = time.perf_counter()
    h = ag.pairwise_match(W)
    return h, time.perf_counter() - t0


def device_match_phase(torch, device="cuda", n=SLICE_N, n_f64=64):
    """device_match: the device matcher against the host one on the
    ``n``^3 Poisson weight graph and a shuffled Poisson (aggregates
    bit for bit, both timed, the host one in a child of :data:`CPU`
    beside the card's work); PCG + SIZE_2 aggregation by matching at
    ``n``^3 f32 on ``device`` (every pass over 16,384 rows or more on
    the device, launches as derived); ``n_f64``^3 f64 against the CPU
    port and its host matcher (the same aggregates per level,
    iterations equal, x to rtol 1e-9).  Returns {path: launches}."""
    from amgx_tpu_torch.amg import aggregation as ag

    for label in ("poisson", "shuffled"):
        W = match_graph(label, n)
        h, host_s = CPU.get(host_match, label, n)
        t0 = time.perf_counter()
        d = ag.pairwise_match_device(W, device=device)
        device_s = time.perf_counter() - t0
        print(json.dumps({"device_match": {
            "graph": f"{label} {n}^3", "rows": W.shape[0], "edges": W.nnz,
            "aggregates": int(h.max()) + 1, "host_s": host_s,
            "device_s": device_s, "bitwise": bool(np.array_equal(h, d))}}),
            flush=True)
        check(np.array_equal(h, d),
              f"device_match {label}: aggregates differ from the host's")
        del W, h, d

    calls = []
    real = ag.pairwise_match_device
    real_host = ag.pairwise_match

    def spy(W, *a, **kw):
        calls.append(("device", W.shape[0]))
        return real(W, *a, **kw)

    def spy_host(W, *a, **kw):
        calls.append(("host", W.shape[0]))
        return real_host(W, *a, **kw)

    ag.pairwise_match_device, ag.pairwise_match = spy, spy_host
    try:
        zero_counts()
        s, res, setup_s, b, upload_s = solve_on(device, SIZE2_MATCH_CFG, n,
                                                np.float32)
        launches = variant_counts()
    finally:
        ag.pairwise_match_device, ag.pairwise_match = real, real_host
    # the device matcher's own fallback calls the host one: count the
    # outermost call of each pass only
    outer = [c for i, c in enumerate(calls)
             if not (c[0] == "host" and i and calls[i - 1] == ("device",
                                                               c[1]))]
    amg = s.precond
    iters = int(res.iters)
    derived = derived_variant_launches(
        amg, iters + 1, top=((s.A, s.A.dtype, iters + 1),))
    rec, _ = path_record("device_match SIZE_2", s, res, b, n, launches,
                         derived, setup_s, upload_s, amg)
    rec["matching_calls"] = outer
    print(json.dumps({"slice": f"device_match: poisson7 {n}^3 f32 PCG + "
                      "AMG SIZE_2 by matching, BLOCK_JACOBI, DENSE_LU on "
                      f"{device}", **rec}), flush=True)
    big = [c for c in outer if c[1] >= ag._DEVICE_MATCH_MIN_ROWS]
    check(big and all(c[0] == ("device" if device == "cuda" else "host")
                      for c in big),
          f"device_match: passes over 16,384 rows not all on the device: "
          f"{outer}")
    check_variants("device_match", launches, derived, device)
    del s, res

    def run(dev):
        sg, rg, _, bg, _ = solve_on(dev, SIZE2_MATCH_CFG, n_f64,
                                    np.float64)
        return sg, rg, true_rel_residual(n_f64, bg, rg.x.cpu().numpy())

    cpu = CPU.get(cpu_solve, SIZE2_MATCH_CFG, n_f64, np.float64, None, True)
    sg, _ = f64_vs_cpu(f"device_match_{n_f64}^3", run, device, cpu)
    lg, lc = sg.precond.levels, cpu["P"]
    check(len(lg) == len(lc), f"device_match f64: {len(lg)} levels vs "
          f"{len(lc)}")
    for a, (indptr, indices) in zip(lg[:-1], lc[:-1]):
        pa = a.P.host_csr()
        check(np.array_equal(pa.indices, indices)
              and np.array_equal(pa.indptr, indptr),
              f"device_match f64: level {a.level_id} aggregates differ")
    return {"device_match": launches}


# ---------------------------------------------------------------------------
# block4_amg_pcg: a b = 4 block system (the block solve of
# __graft_entry__.dryrun_multichip on one card)

BLOCK_B = 4
BLOCK_N = 48
# iterations of the traced block4_amg_pcg solve
TRACE_ITERS = 3

# the JAX package's block AMG config of dryrun_multichip (aggregation
# SIZE_2, V, MULTICOLOR_DILU 1+1, DENSE_LU) inside PCG, monitored with
# one norm a block component
BLOCK_AMG = (
    '{"scope": "amg", "solver": "AMG", "algorithm": "AGGREGATION",'
    ' "selector": "SIZE_2", "smoother": {"scope": "d",'
    ' "solver": "MULTICOLOR_DILU", "relaxation_factor": 1.0,'
    ' "monitor_residual": 0}, "presweeps": 1, "postsweeps": 1,'
    ' "max_iters": 1, "cycle": "V", "coarse_solver": "DENSE_LU_SOLVER",'
    ' "monitor_residual": 0}'
)


def block_pcg_cfg(precond):
    """PCG to 1e-6 (RELATIVE_INI, per-component norms) around
    ``precond`` (a scope's JSON)."""
    return (
        '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
        ' "max_iters": 200, "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
        ' "monitor_residual": 1, "norm": "L2", "use_scalar_norm": 0,'
        f' "preconditioner": {precond}}}}}'
    )


BLOCK4_AMG_CFG = block_pcg_cfg(BLOCK_AMG)
BLOCK4_DILU_CFG = block_pcg_cfg(
    '{"scope": "p", "solver": "MULTICOLOR_DILU", "max_iters": 1,'
    ' "monitor_residual": 0}')
BLOCK4_BJ_CFG = block_pcg_cfg(
    '{"scope": "p", "solver": "BLOCK_JACOBI", "max_iters": 2,'
    ' "monitor_residual": 0}')
BLOCK4_ILU_CFG = block_pcg_cfg(
    '{"scope": "p", "solver": "MULTICOLOR_ILU", "max_iters": 1,'
    ' "monitor_residual": 0}')


# the block phase's comparisons of the card with the CPU port: at 32^3
# x 4 f32 (hierarchy, colours, iterations within one) and at 12^3 x 4
# f64 (iterations, x, history)
BLOCK4_CMP = (("block4_amg_pcg", BLOCK4_AMG_CFG),
              ("block4_pcg_bdilu", BLOCK4_DILU_CFG))
BLOCK4_F64 = BLOCK4_CMP + (("block4_pcg_block_jacobi", BLOCK4_BJ_CFG),
                           ("block4_pcg_milu", BLOCK4_ILU_CFG))


def block4_scipy(n, dtype):
    """kron(poisson_3d_7pt(n), I_4 + 0.2 * 1_4) as scipy BSR with 4 x 4
    blocks."""
    import scipy.sparse as sps

    from amgx_tpu_torch.io.poisson import poisson_scipy

    B = np.eye(BLOCK_B) + 0.2 * np.ones((BLOCK_B, BLOCK_B))
    return sps.kron(poisson_scipy((n, n, n)), B, format="bsr").astype(dtype)


def block4_solve(device, cfg, n, dtype, bsr=None):
    """Upload the b = 4 system at ``n``^3 block rows on ``device`` as
    block CSR (``bsr``, that system already built, saves building it
    again), set up and solve; returns (solver, result, setup_s, b,
    upload_s, scipy BSR).  The right-hand side is drawn from seed 0."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.core.matrix import SparseMatrix

    if bsr is None:
        bsr = block4_scipy(n, dtype)
    t0 = time.perf_counter()
    A = SparseMatrix.from_csr(bsr.indptr, bsr.indices, bsr.data,
                              block_size=BLOCK_B, device=device)
    upload_s = time.perf_counter() - t0
    b = np.random.default_rng(0).standard_normal(bsr.shape[0]).astype(dtype)
    t0 = time.perf_counter()
    s = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                        device=device)
    with warnings.catch_warnings():
        # the notice that AMG expands the block matrix to scalars
        warnings.simplefilter("ignore", UserWarning)
        s.setup(A)
    setup_s = time.perf_counter() - t0
    res = s.solve(b)
    return s, res, setup_s, b, upload_s, bsr


def block_true_residual(bsr, b, x):
    """||b - A x|| / ||b|| in float64 on the host."""
    A = bsr.astype(np.float64)
    b64 = b.astype(np.float64)
    r = b64 - A @ x.astype(np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b64))


def block_levels(amg):
    """Rows, nonzeros, format and colours of each level."""
    return [{**lv, "colors": (lvl.smoother.num_colors
                              if lvl.smoother is not None else None)}
            for lv, lvl in zip(amg.level_summary(), amg.levels)]


def block4_amg_phase(torch, peaks=None, device="cuda", n=BLOCK_N, n_cmp=32,
                     n_f64=12):
    """block4_amg_pcg and block4_pcg_bdilu on the b = 4 system at
    ``n``^3 block rows in f32 on ``device``: status, iterations, the
    true residual, setup and solve seconds, per-component final norms;
    the AMG path's levels (level 0 the 43-diagonal DIA expansion) and
    its launches against the dry walk, a trace of a warm solve, the
    ``dia_spmv`` case on its level-0 A and the ELL kernels' cases on
    every ELL operator of its hierarchy; the block DILU path with no
    kernel launched.  Then each path at ``n_cmp``^3 f32 on ``device``
    and on the CPU (status, hierarchy and colours, iterations within
    one), and at ``n_f64``^3 f64 on both (iterations equal, x to rtol
    1e-9, the per-component history), with PCG + BLOCK_JACOBI and PCG +
    MULTICOLOR_ILU on the block matrix; the CPU's side of these from
    :data:`CPU`.  Returns (the AMG path's launches, the kernel
    records)."""
    recs = []
    # ---- A. block4_amg_pcg, counts zeroed just before, read just after
    zero_counts()
    s, res, setup_s, b, upload_s, bsr = block4_solve(
        device, BLOCK4_AMG_CFG, n, np.float32)
    launches = kernel_counts()
    variants = variant_counts()
    iters, status = int(res.iters), int(res.status)
    x = res.x.cpu().numpy()
    amg = s.precond
    # PCG: one cycle before the loop and one an iteration; its own A p
    # is the block matrix's (stock torch ops, no kernel)
    derived = derived_launches(amg, iters + 1, 0)
    derived_v = derived_variant_launches(amg, iters + 1)
    rel = block_true_residual(bsr, b, x)
    lv0 = amg.levels[0].A
    rec = {
        "slice": f"block4_amg_pcg: kron(poisson7 {n}^3, I4 + 0.2 ones) b=4 "
                 "f32 PCG + AMG(AGGREGATION SIZE_2 V, MULTICOLOR_DILU 1+1, "
                 f"DENSE_LU) on {device}",
        "block_rows": int(bsr.shape[0] // BLOCK_B),
        "blocks": int(bsr.nnz // BLOCK_B ** 2),
        "unknowns": int(bsr.shape[0]),
        "levels": block_levels(amg), "n_levels": len(amg.levels),
        "level0_diagonals": len(lv0.dia_offsets) if lv0.has_dia else None,
        "iterations": iters, "status": status, "upload_s": upload_s,
        "setup_s": setup_s, "setup_profile": amg.setup_profile,
        "solve_s": s.solve_time,
        "ms_per_iteration": s.solve_time / max(iters, 1) * 1e3,
        "final_norms": [float(v) for v in res.final_norm],
        "initial_norms": [float(v) for v in res.initial_norm],
        "true_rel_residual_f64": rel, "launches": launches,
        "derived_launches": derived, "variant_launches": variants,
        "derived_variant_launches": derived_v,
        "cycle_passes_per_iteration": amg.cycle_passes_per_iteration(),
    }
    print(json.dumps(rec), flush=True)
    check(status == 0, f"block4_amg_pcg status {status}")
    check(rel <= 1e-5, f"block4_amg_pcg true residual {rel:.3e} > 1e-5")
    check(len(res.final_norm) == BLOCK_B,
          f"block4_amg_pcg: {len(res.final_norm)} norm components")
    check(lv0.has_dia and len(lv0.dia_offsets) == 43,
          f"block4_amg_pcg level 0: {lv0.format}, "
          f"{len(lv0.dia_offsets or ())} diagonals, not DIA with 43")
    walk_a = sum(k for (_, f), k in cycle_walk(amg).items() if f == "A")
    check(walk_a == rec["cycle_passes_per_iteration"],
          f"block4_amg_pcg: the dry walk counts {walk_a} A-SpMVs a cycle, "
          f"the cycle made {rec['cycle_passes_per_iteration']}")
    check_launches("block4_amg_pcg", launches, derived, device)
    check_variants("block4_amg_pcg", variants, derived_v, device)
    check(launches["dia_spmv"] > 0 or device != "cuda",
          "block4_amg_pcg launched no dia_spmv")
    if device == "cuda":
        # a warm solve of TRACE_ITERS iterations (about 25,000 launches
        # an iteration): its ops per iteration count the first cycle
        # with them
        trace_first(torch, s, b, TRACE_ITERS, groups={
            "dia_spmv": ["dia_spmv"], "sell_spmv": ["sell_spmv"],
            "ell_spmv": ["ell_spmv"], "index_copy": ["index_copy"],
            "gather": ["index_elementwise", "gather", "index_select"],
            "bmm": ["gemm", "gemv", "bmm"], "dense": ["trsm", "trsv",
                                                      "getrs", "dot_kernel"],
            "reduction": ["reduce_kernel"],
        })
        timer = Timer(torch)
        recs.append(block_dia_case(torch, timer, peaks, lv0,
                                   launches["dia_spmv"]))
        recs += block_ell_cases(torch, timer, peaks, amg, iters, launches)
    levels = rec["levels"]
    colors = [lv["colors"] for lv in levels]
    del s, res, amg, lv0

    # ---- B. block4_pcg_bdilu: block-native DILU, no kernel
    zero_counts()
    sd, rd, setup_d, bd, upload_d, _ = block4_solve(
        device, BLOCK4_DILU_CFG, n, np.float32, bsr)
    dl = kernel_counts()
    xd = rd.x.cpu().numpy()
    reld = block_true_residual(bsr, bd, xd)
    print(json.dumps({
        "slice": f"block4_pcg_bdilu: the same system, PCG + MULTICOLOR_DILU "
                 f"on the 4 x 4 blocks (native E factors) on {device}",
        "colors": sd.precond.num_colors, "iterations": int(rd.iters),
        "status": int(rd.status), "upload_s": upload_d, "setup_s": setup_d,
        "solve_s": sd.solve_time,
        "ms_per_iteration": sd.solve_time / max(int(rd.iters), 1) * 1e3,
        "final_norms": [float(v) for v in rd.final_norm],
        "true_rel_residual_f64": reld, "launches": dl}), flush=True)
    check(int(rd.status) == 0, f"block4_pcg_bdilu status {rd.status}")
    check(reld <= 1e-5, f"block4_pcg_bdilu true residual {reld:.3e} > 1e-5")
    check(len(rd.final_norm) == BLOCK_B,
          f"block4_pcg_bdilu: {len(rd.final_norm)} norm components")
    check(not any(dl.values()), f"block4_pcg_bdilu launched {dl}")
    bdilu_iters = int(rd.iters)
    del sd, rd, bsr

    dev_f32 = block4_cmp_f32(device, n_cmp)
    dev_f64 = block4_cmp_f64(device, n_f64)
    t0 = time.perf_counter()
    cpu_f32 = CPU.get(block4_cmp_f32, "cpu", n_cmp)
    cpu_f64 = CPU.get(block4_cmp_f64, "cpu", n_f64)
    print(json.dumps({"block4_cpu_side_wait_s": time.perf_counter() - t0}),
          flush=True)

    # ---- C. n_cmp^3 f32: the device against the CPU port
    for label, _ in BLOCK4_CMP:
        g, c = dev_f32[label], cpu_f32[label]
        print(json.dumps({f"{label}_{n_cmp}^3_f32_vs_cpu": {
            device: g, "cpu": c}}), flush=True)
        check(g["status"] == 0 and c["status"] == 0,
              f"{label} {n_cmp}^3: status {g['status']} / {c['status']}")
        check(g["levels"] == c["levels"] and g["colors"] == c["colors"],
              f"{label} {n_cmp}^3: hierarchy or colours differ from the CPU")
        check(abs(g["iterations"] - c["iterations"]) <= 1,
              f"{label} {n_cmp}^3: iterations {g['iterations']} vs cpu "
              f"{c['iterations']}")

    # ---- D. n_f64^3 f64: iterations equal, x to rtol 1e-9, history
    for label, _ in BLOCK4_F64:
        g, c = dev_f64[label], cpu_f64[label]
        k = c["iterations"] + 1
        d = float(np.abs(g["x"] - c["x"]).max())
        hist_ok = bool(np.allclose(g["history"][:k], c["history"][:k],
                                   rtol=1e-9, atol=0))
        print(json.dumps({f"{label}_{n_f64}^3_f64": {
            "iterations": g["iterations"], "cpu_iterations": c["iterations"],
            "status": g["status"], "cpu_status": c["status"],
            "true_rel_residual_f64": g["residual"],
            "cpu_true_rel_residual_f64": c["residual"],
            "max_abs_diff_vs_cpu": d, "x_inf": float(np.abs(c["x"]).max()),
            "history_components": int(c["history"].shape[1]),
            "history_equal_rtol_1e-9": hist_ok}}), flush=True)
        check(g["status"] == 0 and c["status"] == 0,
              f"{label} f64: status {g['status']} / {c['status']}")
        check(g["iterations"] == c["iterations"],
              f"{label} f64: iterations {g['iterations']} vs cpu "
              f"{c['iterations']}")
        check(np.allclose(g["x"], c["x"], rtol=1e-9,
                          atol=1e-9 * float(np.abs(c["x"]).max())),
              f"{label} f64: x vs cpu, max abs diff {d:.3e}")
        check(c["history"].shape[1] == BLOCK_B and hist_ok,
              f"{label} f64: per-component history differs from the CPU")
        check(g["residual"] <= 1e-6 and c["residual"] <= 1e-6,
              f"{label} f64: true residual {g['residual']:.3e} / "
              f"{c['residual']:.3e}")
    print(json.dumps({"block4_summary": {
        "levels": levels, "colors": colors, "amg_iterations": iters,
        "bdilu_iterations": bdilu_iters}}), flush=True)
    return launches, recs


def block4_cmp_f32(device, n):
    """One device's side of the block phase's f32 comparison: the paths
    of ``BLOCK4_CMP`` at ``n``^3 (status, iterations, setup and solve
    seconds, levels and colours)."""
    out = {}
    bsr = block4_scipy(n, np.float32)
    for label, cfg in BLOCK4_CMP:
        s, r, setup_s, _, _, _ = block4_solve(device, cfg, n, np.float32,
                                              bsr)
        amg = s.precond if label == "block4_amg_pcg" else None
        out[label] = {
            "iterations": int(r.iters), "status": int(r.status),
            "setup_s": setup_s, "solve_s": s.solve_time,
            "levels": block_levels(amg) if amg else None,
            "colors": None if amg else s.precond.num_colors}
    return out


def block4_cmp_f64(device, n):
    """One device's side of the block phase's f64 comparison: the paths
    of ``BLOCK4_F64`` at ``n``^3 (status, iterations, x, the
    per-component history, the true residual)."""
    out = {}
    bsr = block4_scipy(n, np.float64)
    for label, cfg in BLOCK4_F64:
        _, r, _, b, _, sp = block4_solve(device, cfg, n, np.float64, bsr)
        x = r.x.cpu().numpy()
        out[label] = {"iterations": int(r.iters), "status": int(r.status),
                      "x": x, "history": np.asarray(r.history),
                      "residual": block_true_residual(sp, b, x)}
    return out


# the CPU port's runs that the phases hold the card to.  On the card,
# once the kernels are built, :func:`main` starts every one that does
# not wait for a result of the card (:func:`cpu_side_calls`) in one
# spawned child process at the lowest priority, in the order the phases
# read them, so that they run beside the card's work.  Each runs with
# the torch threads it had where it ran before (those of this process;
# ``CHILD_THREADS`` for the runs that had a child of their own): the
# summation order, and so the iterations of f32 BICGSTAB, move with
# them.  A phase that reads one not started (a CPU rehearsal, other
# sizes) runs it where it stands.
CHILD_THREADS = 3


class CpuSide:
    """The started CPU runs, keyed by (function, *arguments)."""

    def __init__(self):
        self.pool, self.jobs, self.wait_s = None, {}, 0.0

    def start(self, calls, threads):
        """Start ``calls`` ((function, *arguments) with the torch threads
        of each) in a child process."""
        self.pool = multiprocessing.get_context("spawn").Pool(
            1, initializer=_cpu_child)
        for call, n in zip(calls, threads):
            self.jobs[call] = self.pool.apply_async(_run_call, (n, *call))

    def get(self, fn, *args):
        """``fn(*args)``: the child's result where it was started (the
        seconds waited for it add to ``wait_s``), else run here."""
        job = self.jobs.pop((fn, *args), None)
        if job is None:
            return fn(*args)
        t0 = time.perf_counter()
        try:
            return job.get(timeout=600)
        finally:
            self.wait_s += time.perf_counter() - t0

    def end(self):
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
        self.pool, self.jobs = None, {}


CPU = CpuSide()


def _cpu_child():
    """The child process of :class:`CpuSide`, at the lowest priority, so
    that the card's work beside it keeps the host."""
    import os

    os.nice(19)


def _run_call(threads, fn, *args):
    """``fn(*args)`` with ``threads`` torch threads."""
    import torch

    torch.set_num_threads(threads)
    return fn(*args)


def block_dia_case(torch, timer, peaks, A, launches):
    """``dia_spmv`` f32 on the block path's level-0 A (the scalar
    expansion, 43 diagonals): held to its plain version within ``TOL``,
    timed as the kernel phase's cases are, with its launch plan (the
    runtime-count kernel)."""
    from amgx_tpu_torch.ops import dia

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = dia.dia_launch_plan(A.n_rows, A.dia_offsets, A.dtype, sms)
    check(plan.nd_inst == 0,
          f"block level-0 DIA plan takes kernel {plan.nd_inst}, not 0")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        A.n_rows).astype(np.float32)).cuda()
    nd, n = A.dia_vals.shape
    return kernel_case(
        torch, timer, peaks, "dia_spmv",
        f"block4 level0 A {n} rows f32 ({nd} diagonals)",
        lambda: dia.dia_spmv(A.dia_vals, A.dia_offsets, x),
        lambda: dia.dia_spmv_plain(A.dia_vals, A.dia_offsets, x),
        (A.row_offsets, A.col_indices, A.values, (n, n), x),
        nbytes=4 * (A.nnz + 2 * n) + 4 * nd, nops=2 * A.nnz,
        dtype=A.dia_vals.dtype,
        extra={"nonzeros": A.nnz, "diagonals": nd,
               "launches_block4_amg_pcg": launches,
               "plan": {k: v for k, v in plan._asdict().items()
                        if k != "offsets"}},
    )


def block_ell_cases(torch, timer, peaks, amg, iters, launches):
    """The ELL kernel's case (:func:`ell_kernel_case`, f32) on every
    ELL operator of the block path's hierarchy ``amg`` (the Galerkin
    levels of the scalar expansion, 30-70 entries a row, and their
    transfers), on the operator's own arrays: ``sell_spmv`` where the
    operator has the sliced layout (the kernel the path launches
    there), else ``ell_spmv``, each with its launches per solve of
    ``iters`` iterations; the launches of ``sell_spmv`` and
    ``ell_spmv`` in ``launches`` must all fall on these operators."""
    rng = np.random.default_rng(2)
    ops = ell_operators(amg, iters)
    on_ops = sum(per for _, _, per in ops)
    check(on_ops == launches["sell_spmv"] + launches["ell_spmv"],
          f"block4_amg_pcg: {on_ops} ELL launches on the held operators, "
          f"{launches['sell_spmv'] + launches['ell_spmv']} counted")
    recs = []
    for label, m, per in ops:
        recs += ell_kernel_case(
            torch, timer, peaks, rng,
            f"block4 {label} {m.n_rows}x{m.n_cols} w={_width(m)} f32",
            m.host_csr(), np.float32, A=m, slot_major=False,
            extra={"launches_per_solve": per})
    return recs


# ---------------------------------------------------------------------------
# eigensolvers and the setup store (twelfth slice)

EIG_N = SLICE_N
EIG_CMP_N = 64
PAGERANK_NODES = 1 << 20
PAGERANK_CMP_NODES = 1 << 16


def bench_amg(scope):
    """The bench preconditioner (``bench.py:_solve_record``: aggregation
    AMG, SIZE_8 V, BLOCK_JACOBI 0.8, DENSE_LU) as a config dict."""
    return {"scope": scope, "solver": "AMG", "algorithm": "AGGREGATION",
            "selector": "SIZE_8",
            "smoother": {"scope": f"{scope}_j", "solver": "BLOCK_JACOBI",
                         "relaxation_factor": 0.8, "monitor_residual": 0},
            "presweeps": 1, "postsweeps": 1, "max_iters": 1,
            "min_coarse_rows": 512, "max_levels": 20,
            "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",
            "monitor_residual": 0}


# the inner solver of inverse iteration: PCG to 1e-10 around the bench AMG
INNER_PCG = {"scope": "main", "solver": "PCG", "max_iters": 200,
             "tolerance": 1e-10, "monitor_residual": 1,
             "convergence": "RELATIVE_INI", "preconditioner": bench_amg("amg")}

# the eigenvector post-pass: inverse iteration by PCG + the bench AMG on
# each shifted matrix (the default scope's solver parameters)
POST_PASS = {"eig_eigenvector": 1, "eig_eigenvector_solver": "PCG",
             "max_iters": 200, "tolerance": 1e-10, "monitor_residual": 1,
             "convergence": "RELATIVE_INI", "preconditioner": bench_amg("pp")}


def eig_cfg(inner=False, extra=None, **eig):
    """An eigensolver config: ``eig_<key>`` for each keyword, the inner
    PCG when ``inner``, ``extra`` top-level keys."""
    d = {"config_version": 2, **{f"eig_{k}": v for k, v in eig.items()},
         **(extra or {})}
    if inner:
        d["solver"] = INNER_PCG
    return json.dumps(d)


def eig_cases():
    """The nine names at the card-against-CPU size: (label, config,
    matrix kind)."""
    return (
        ("POWER_ITERATION", eig_cfg(solver="POWER_ITERATION",
                                    max_iters=300, tolerance=1e-8,
                                    which="largest"), "poisson"),
        ("SINGLE_ITERATION", eig_cfg(solver="SINGLE_ITERATION",
                                     max_iters=300, tolerance=1e-8,
                                     which="largest",
                                     convergence_check_freq=5), "poisson"),
        ("INVERSE_ITERATION", eig_cfg(
            inner=True, extra=POST_PASS, solver="INVERSE_ITERATION",
            max_iters=100, tolerance=1e-10), "poisson"),
        ("PAGERANK", eig_cfg(solver="PAGERANK", max_iters=300,
                             tolerance=1e-10, damping_factor=0.85),
         "links"),
        ("SUBSPACE_ITERATION", eig_cfg(solver="SUBSPACE_ITERATION",
                                       max_iters=40, tolerance=1e-10,
                                       which="largest", wanted_count=2,
                                       subspace_size=8), "poisson"),
        ("LANCZOS", eig_cfg(solver="LANCZOS", max_iters=200,
                            tolerance=1e-8, which="largest",
                            wanted_count=2, subspace_size=60), "poisson"),
        ("ARNOLDI", eig_cfg(solver="ARNOLDI", max_iters=100,
                            tolerance=1e-8, which="largest",
                            wanted_count=1, subspace_size=40), "poisson"),
        ("LOBPCG", eig_cfg(solver="LOBPCG", max_iters=40, tolerance=1e-8,
                           which="smallest", wanted_count=2), "poisson"),
        ("JACOBI_DAVIDSON", eig_cfg(solver="JACOBI_DAVIDSON", max_iters=40,
                                    tolerance=1e-8, which="largest",
                                    subspace_size=12), "poisson"),
    )


def link_graph(n, seed=5, out_links=8, dangling=0.05):
    """A seeded synthetic link graph of ``n`` nodes as the scipy matrix
    PAGERANK reads (entry (i, j): j links to i): ``out_links`` distinct
    random targets a node (no self-link), none for a ``dangling`` share
    of the nodes."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n, dtype=np.int64), out_links)
    dst = (src + rng.integers(1, n, src.shape[0])) % n
    keep = ~np.isin(src, rng.choice(n, int(dangling * n), replace=False))
    A = sps.coo_matrix((np.ones(int(keep.sum())), (dst[keep], src[keep])),
                       shape=(n, n)).tocsr()
    A.data[:] = 1.0
    A.sort_indices()
    return A


def eig_matrix(kind, device, n=EIG_CMP_N, nodes=PAGERANK_CMP_NODES):
    import amgx_tpu_torch as T
    from amgx_tpu_torch.io.poisson import poisson_3d_7pt

    if kind == "links":
        return T.SparseMatrix.from_scipy(link_graph(nodes), device=device)
    return poisson_3d_7pt(n, dtype=np.float64, device=device)


def inverse_walk(es, inner_iters):
    """``dia_spmv`` / ``ell_spmv`` launches of an inverse iteration:
    each inner PCG solve of k iterations (:func:`pcg_derived_launches`)
    and one ``A w`` an outer iteration."""
    counts = dict.fromkeys(COUNTERS, 0)
    for k in inner_iters:
        for name, c in pcg_derived_launches(es._inner, k).items():
            counts[name] += c
    counts[counter_of(es.A)] += len(inner_iters)
    return counts


def eig_walk(label, es, res, inner_iters=None):
    """The SpMVs (kernel launches on the card) a run of the eigensolver
    ``es`` makes on its operator, from its iterations: one a column of
    each block product (SUBSPACE_ITERATION, LOBPCG, JACOBI_DAVIDSON),
    one a step of a Krylov method, one for each residual."""
    it = res.iterations
    if label == "INVERSE_ITERATION":
        return inverse_walk(es, inner_iters)
    if label in ("POWER_ITERATION", "SINGLE_ITERATION", "PAGERANK"):
        n = it
    elif label == "SUBSPACE_ITERATION":
        m = max(es.subspace_size, max(es.wanted_count, 1) + 2)
        n = it * (2 * m + 1)
    elif label in ("LANCZOS", "ARNOLDI"):
        n = it + 1
    elif label == "LOBPCG":
        k = max(es.wanted_count, 1)
        done = res.converged
        n = it * k + sum((2 if i == 1 else 3) * k
                         for i in range(1, it + (0 if done else 1)))
    else:  # JACOBI_DAVIDSON: the Ritz problem on the space, r, 8 CG steps
        m_max = max(es.subspace_size, 8)
        size, n = 1, 0
        for i in range(1, it + 1):
            n += size + 1
            if i == it and res.converged:
                break
            if size >= m_max:
                size = 1
            n += 8
            size += 1
        n += size
    op = es._google if label == "PAGERANK" else es.A
    counts = dict.fromkeys(COUNTERS, 0)
    if counter_of(op) is not None:
        counts[counter_of(op)] += n
    return counts


def eig_record(res):
    """A run's result as plain data (the vectors on the host)."""
    vec = res.eigenvectors
    return {
        "iterations": int(res.iterations), "converged": bool(res.converged),
        "eigenvalues": np.asarray(res.eigenvalues),
        "residual": float(res.residual),
        "vectors": None if vec is None else vec.cpu().numpy(),
        "vector_converged": (None if res.vector_converged is None
                             else res.vector_converged.tolist()),
    }


def eig_run(device, label, cfg, kind, n=EIG_CMP_N,
            nodes=PAGERANK_CMP_NODES):
    """One case of :func:`eig_cases` on ``device``: (record, launches
    made, launches walked, inner iterations).  INVERSE_ITERATION also
    runs the eigenvector post-pass on its eigenvalue (it produces its
    own vector, so ``solve`` skips the post-pass: it is driven on the
    result with the vector dropped)."""
    import dataclasses

    import amgx_tpu_torch as T

    A = eig_matrix(kind, device, n, nodes)
    es = T.create_eigensolver(T.AMGConfig.from_string(cfg), device=device)
    es.setup(A)
    inner_iters = []
    if es.requested_name == "INVERSE_ITERATION":
        solve = es._inner.solve

        def counted(v):
            r = solve(v)
            inner_iters.append(int(r.iters))
            return r

        es._inner.solve = counted
    zero_counts()
    res = es.solve()
    launches = kernel_counts()
    walk = eig_walk(label, es, res, inner_iters)
    rec = eig_record(res)
    if label == "INVERSE_ITERATION":
        post = es._maybe_extract_vectors(
            dataclasses.replace(res, eigenvectors=None))
        rec["post_pass"] = eig_record(post)
    return rec, launches, walk, inner_iters


def eig_cmp_cpu(n=EIG_CMP_N, nodes=PAGERANK_CMP_NODES, labels=None):
    """The CPU's side of the card-against-CPU comparison: the cases of
    :func:`eig_cases` named in ``labels`` (default: all) through the
    port on the CPU."""
    return {label: eig_run("cpu", label, cfg, kind, n, nodes)[0]
            for label, cfg, kind in eig_cases()
            if labels is None or label in labels}


# the CPU side's two shares (one job each): inverse iteration with its
# post-pass, about as long as the other eight together
EIG_CPU_SPLIT = (("INVERSE_ITERATION",),
                 ("POWER_ITERATION", "SINGLE_ITERATION", "PAGERANK",
                  "SUBSPACE_ITERATION", "LANCZOS", "ARNOLDI", "LOBPCG",
                  "JACOBI_DAVIDSON"))


def poisson_multiplicity(n):
    """Counter of the eigenvalues of the n^3 7-point Poisson matrix near
    a value: 6 - 2 sum cos(k_i pi / (n + 1)), k_i in 1..n."""
    c = 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    lam = (6.0 - c[:, None, None] - c[None, :, None]
           - c[None, None, :]).ravel()

    def count(x):
        return int((np.abs(lam - x) <= 1e-8 * max(abs(x), 1.0)).sum())

    return count


def hold_vectors(label, g, c, multiplicity):
    """Card against CPU: each vector up to sign within 1e-8 of the
    largest entry where its eigenvalue is simple (the Poisson matrix's
    second eigenvalue is triple: any vector of its space), else both
    vectors' residual ratios agree within 10 x.  Returns the largest
    difference held."""
    if g is None:
        check(c is None, f"{label}: vectors on the CPU only")
        return 0.0
    worst = 0.0
    for k in range(c.shape[1]):
        x, xc = g[:, k], c[:, k]
        i = int(np.argmax(np.abs(xc)))
        s = x[i] / xc[i]
        d = float(np.abs(x - s * xc).max() / np.abs(xc).max())
        if multiplicity is None or multiplicity[k] <= 1:
            check(d <= 1e-8 and abs(abs(s) - 1.0) <= 1e-8,
                  f"{label}: vector {k} differs from the CPU's by {d:.3e}")
            worst = max(worst, d)
    return worst


def eig_kernel_cases(torch, peaks, amg, inner_iters, G):
    """The kernels at the eigensolvers path's f64 shapes, each held to
    its plain version and timed as the kernel phase's cases: ``dia_spmv``
    on the inner hierarchy's level-1 A (level 0's case is the kernel
    phase's ``level0 A 128^3 f64``), ``ell_spmv`` on its level-0 P and R,
    and the kernel the PAGERANK Google matrix takes (``G``: the matrix
    and its iterations).  Each record carries its launches on the path
    (inverse iteration's inner cycles: one a PCG iteration and one
    before the loop)."""
    from amgx_tpu_torch.ops import dia

    timer = Timer(torch)
    rng = np.random.default_rng(12)
    walk = cycle_walk(amg)
    cycles = sum(k + 1 for k in inner_iters)
    recs = []
    A1 = amg.levels[1].A
    x = torch.from_numpy(rng.standard_normal(A1.n_rows)).cuda()
    nd, n1 = A1.dia_vals.shape
    recs.append(kernel_case(
        torch, timer, peaks, "dia_spmv", f"eigen level1 A {n1} rows f64",
        lambda: dia.dia_spmv(A1.dia_vals, A1.dia_offsets, x),
        lambda: dia.dia_spmv_plain(A1.dia_vals, A1.dia_offsets, x),
        (A1.row_offsets, A1.col_indices, A1.values, (n1, n1), x),
        nbytes=8 * (A1.nnz + 2 * n1) + 4 * nd, nops=2 * A1.nnz,
        dtype=A1.dia_vals.dtype,
        extra={"launches_inverse_iteration": cycles * walk[(1, "A")]}))
    for f in ("P", "R"):
        m = getattr(amg.levels[0], f)
        recs += ell_kernel_case(
            torch, timer, peaks, rng,
            f"eigen level0 {f} {m.n_rows}x{m.n_cols} w={_width(m)} f64",
            m.host_csr(), np.float64, A=m, slot_major=False,
            extra={"launches_inverse_iteration": cycles * walk[(0, f)]})
    Gm, iters = G
    recs += ell_kernel_case(
        torch, timer, peaks, rng,
        f"pagerank google {Gm.n_rows} rows w={_width(Gm)} f64",
        Gm.host_csr(), np.float64, A=Gm, slot_major=False,
        extra={"launches_pagerank": iters})
    return recs


def eigen_phase(torch, peaks=None, device="cuda", n=EIG_N, n_cmp=EIG_CMP_N,
                nodes=PAGERANK_NODES, cmp_nodes=PAGERANK_CMP_NODES):
    """The eigensolvers in f64 on ``device``: (a) INVERSE_ITERATION at
    ``n``^3 (PCG to 1e-10 around the bench AMG inside), plain and
    shift-inverted, held to 6 - 6 cos(pi / (n + 1)) within 1e-6 and its
    ``dia_spmv`` / ``ell_spmv`` launches to the walk; (b) LANCZOS for
    the two largest (60 steps), each at most 6 + 6 cos(pi / (n + 1));
    (c) PAGERANK on a link graph of ``nodes`` nodes with dangling
    nodes; (d) all nine names at ``n_cmp``^3 (PAGERANK on ``cmp_nodes``
    nodes) against the CPU port (from :data:`CPU`).  On the card the
    kernels are also held at the path's f64 shapes
    (:func:`eig_kernel_cases`).  Returns (the launches of (a), the kernel
    records)."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.io.poisson import poisson_3d_7pt
    from amgx_tpu_torch.ops.spmv import spmv

    lam_min = 6.0 - 6.0 * np.cos(np.pi / (n + 1))
    lam_max = 6.0 + 6.0 * np.cos(np.pi / (n + 1))
    t0 = time.perf_counter()
    A = poisson_3d_7pt(n, dtype=np.float64, device=device)
    upload_s = time.perf_counter() - t0
    main_launches = None
    # ---- (a) inverse iteration, then shift-invert
    for shift in (0.0, 1.7e-3):
        cfg = eig_cfg(inner=True, solver="INVERSE_ITERATION", max_iters=100,
                      tolerance=1e-10, shift=shift)
        zero_counts()
        t0 = time.perf_counter()
        es = T.create_eigensolver(T.AMGConfig.from_string(cfg),
                                  device=device).setup(A)
        setup_s = time.perf_counter() - t0
        inner_iters = []
        solve = es._inner.solve

        def counted(v, solve=solve):
            r = solve(v)
            inner_iters.append(int(r.iters))
            return r

        es._inner.solve = counted
        t0 = time.perf_counter()
        res = es.solve()
        solve_s = time.perf_counter() - t0
        launches = kernel_counts()
        walk = inverse_walk(es, inner_iters)
        lam = float(res.eigenvalues[0])
        v = res.eigenvectors[:, 0]
        resid = float(torch.linalg.vector_norm(spmv(A, v) - lam * v)) / lam
        label = "inverse_iteration" + ("_shift_invert" if shift else "")
        rec = {
            "eigen": f"{label} poisson7 {n}^3 f64, PCG 1e-10 + AMG(SIZE_8) "
                     f"inner, eig_shift {shift} on {device}",
            "rows": A.n_rows, "eigenvalue": lam, "analytic": lam_min,
            "rel_err": abs(lam - lam_min) / lam_min,
            "outer_iterations": int(res.iterations),
            "converged": bool(res.converged),
            "inner_iterations": inner_iters,
            "inner_levels": es._inner.precond.level_summary(),
            "residual_ratio": resid, "upload_s": upload_s,
            "setup_s": setup_s, "solve_s": solve_s,
            "launches": launches, "walked": walk,
        }
        print(json.dumps(rec), flush=True)
        check(res.converged, f"{label}: not converged")
        check(rec["rel_err"] <= 1e-6,
              f"{label}: eigenvalue {lam!r} vs {lam_min!r}")
        check_launches(label, launches, walk, device)
        if shift == 0.0:
            main_launches = launches
            inner = (es._inner.precond, inner_iters)
        del es, res, v

    # ---- (b) Lanczos, the two largest
    cfg = eig_cfg(solver="LANCZOS", max_iters=200, tolerance=1e-8,
                  which="largest", wanted_count=2, subspace_size=60)
    es = T.create_eigensolver(T.AMGConfig.from_string(cfg),
                              device=device).setup(A)
    zero_counts()
    t0 = time.perf_counter()
    res = es.solve()
    solve_s = time.perf_counter() - t0
    launches = kernel_counts()
    walk = eig_walk("LANCZOS", es, res)
    ritz = [float(v) for v in res.eigenvalues]
    print(json.dumps({
        "eigen": f"lanczos poisson7 {n}^3 f64, 60 steps, 2 largest on "
                 f"{device}", "ritz": ritz, "analytic_max": lam_max,
        "gap": lam_max - ritz[0], "steps": int(res.iterations),
        "residual": float(res.residual), "solve_s": solve_s,
        "launches": launches, "walked": walk}), flush=True)
    check(all(r <= lam_max * (1 + 1e-12) for r in ritz),
          f"lanczos: Ritz values {ritz} above {lam_max}")
    check(int(res.iterations) == 60, f"lanczos: {res.iterations} steps")
    check_launches("lanczos", launches, walk, device)
    del es, res, A

    # ---- (c) PageRank on a link graph with dangling nodes
    t0 = time.perf_counter()
    L = link_graph(nodes)
    graph_s = time.perf_counter() - t0
    G0 = T.SparseMatrix.from_scipy(L, device=device)
    cfg = eig_cfg(solver="PAGERANK", max_iters=300, tolerance=1e-10,
                  damping_factor=0.85)
    t0 = time.perf_counter()
    es = T.create_eigensolver(T.AMGConfig.from_string(cfg),
                              device=device).setup(G0)
    setup_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    res = es.solve()
    solve_s = time.perf_counter() - t0
    launches = kernel_counts()
    walk = eig_walk("PAGERANK", es, res)
    pr = res.eigenvectors[:, 0]
    G = es._google
    total = float(pr.sum())
    print(json.dumps({
        "eigen": f"pagerank {nodes} nodes, 8 out-links, "
                 f"{int((np.diff(L.tocsc().indptr) == 0).sum())} dangling, "
                 f"damping 0.85 on {device}",
        "google_format": G.format, "google_kernel": counter_of(G),
        "google_nnz": G.nnz, "google_width": _width(G),
        "sliced_layout": _sell(G), "iterations": int(res.iterations),
        "converged": bool(res.converged), "residual": float(res.residual),
        "sum": total, "min": float(pr.min()), "max": float(pr.max()),
        "graph_s": graph_s, "setup_s": setup_s, "solve_s": solve_s,
        "launches": launches, "walked": walk}), flush=True)
    check(res.converged, "pagerank: not converged")
    check(bool((pr > 0).all()), "pagerank: an entry <= 0")
    check(abs(total - 1.0) <= 1e-12, f"pagerank: sum {total!r}")
    check_launches("pagerank", launches, walk, device)
    recs = (eig_kernel_cases(torch, peaks, *inner, (G, int(res.iterations)))
            if device == "cuda" else [])
    del es, res, G0, G, pr, L, inner

    # ---- (d) the nine names, card against the CPU port
    dev = {}
    for label, cfg, kind in eig_cases():
        rec, launches, walk, inner = eig_run(device, label, cfg, kind,
                                             n_cmp, cmp_nodes)
        check_launches(f"{label} {n_cmp}^3", launches, walk, device)
        rec["launches"], rec["walked"] = launches, walk
        dev[label] = rec
    t0 = time.perf_counter()
    cpu = {}
    for share in EIG_CPU_SPLIT:
        cpu.update(CPU.get(eig_cmp_cpu, n_cmp, cmp_nodes, share))
    print(json.dumps({"eigen_cpu_side_wait_s": time.perf_counter() - t0}),
          flush=True)
    mult = poisson_multiplicity(n_cmp)
    for label, _, kind in eig_cases():
        g, c = dev[label], cpu[label]
        for part, (gg, cc) in (("", (g, c)),) + (
                (("post_pass", (g["post_pass"], c["post_pass"])),)
                if "post_pass" in g else ()):
            name = f"{label}{' ' + part if part else ''}"
            check(gg["iterations"] == cc["iterations"],
                  f"{name}: iterations {gg['iterations']} vs cpu "
                  f"{cc['iterations']}")
            check(gg["converged"] == cc["converged"],
                  f"{name}: converged {gg['converged']} vs cpu")
            check(np.allclose(gg["eigenvalues"], cc["eigenvalues"],
                              rtol=1e-10, atol=0),
                  f"{name}: eigenvalues {gg['eigenvalues']} vs cpu "
                  f"{cc['eigenvalues']}")
            check(gg["vector_converged"] == cc["vector_converged"],
                  f"{name}: vector_converged differs")
            m = (None if kind == "links" else
                 [mult(float(np.real(v))) for v in cc["eigenvalues"]])
            d = hold_vectors(name, gg["vectors"], cc["vectors"], m)
            print(json.dumps({f"eigen_{n_cmp}^3_vs_cpu": {
                "case": name, "iterations": gg["iterations"],
                "converged": gg["converged"],
                "eigenvalues": [float(np.real(v)) for v in gg["eigenvalues"]],
                "max_rel_diff_eigenvalues": float(np.max(np.abs(
                    gg["eigenvalues"] - cc["eigenvalues"]) / np.abs(
                    cc["eigenvalues"]))),
                "max_vector_diff": d, "multiplicity": m,
                "vector_converged": gg["vector_converged"],
                "launches": g.get("launches") if not part else None,
                "walked": g.get("walked") if not part else None,
            }}, default=float), flush=True)
        if "post_pass" in g:
            check(all(g["post_pass"]["vector_converged"]),
                  f"{label}: the post-pass did not converge")
    return main_launches, recs


STORE_CONFIGS = (("bench", BENCH_CFG, None),
                 ("pcg_classical", PCG_CLASSICAL, None),
                 ("pcg_classical_cheby", PCG_CLASSICAL_CHEB, None),
                 ("bench_matrix_free", MF_CFG, MF_FORMATS))


def store_dir():
    """A new directory for payloads under the checkout's ignored
    ``ci/artifacts`` (the caller removes it)."""
    import os
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ci",
                        "artifacts")
    os.makedirs(root, exist_ok=True)
    return tempfile.mkdtemp(prefix="store_smoke_", dir=root)


def store_roundtrip(torch, label, cfg, formats, n, dtype, device, folder):
    """Set up ``cfg`` on ``poisson_3d_7pt(n)`` on ``device``, save it,
    restore it there and solve with both: the restore launches no
    kernel and coarsens nothing, the levels agree in rows, nnz, formats
    and dtypes, the solves in iterations, x (bit for bit) and launches
    per kernel.  Returns the restored solve's launches."""
    import os

    from amgx_tpu_torch.solvers.base import Solver

    s, res, setup_s, b, upload_s = solve_on(device, cfg, n, dtype,
                                            accel_formats=formats)
    zero_counts()
    s.solve(b)
    cold = kernel_counts()
    path = os.path.join(folder, f"{label}.npz")
    t0 = time.perf_counter()
    s.save_setup(path)
    save_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 2**20
    zero_counts()
    t0 = time.perf_counter()
    s2 = Solver.load_setup(path, device=device)
    load_s = time.perf_counter() - t0
    at_restore = kernel_counts()
    zero_counts()
    r2 = s2.solve(b)
    restored = kernel_counts()
    amg, amg2 = s.precond, s2.precond
    rec = {
        "store": f"{label} poisson7 {n}^3 {np.dtype(dtype).name} on "
                 f"{device}",
        "payload_mb": mb, "save_s": save_s, "restore_s": load_s,
        "restore_time_s": s2.restore_time, "setup_s": setup_s,
        "upload_s": upload_s, "levels": len(amg2.levels),
        "setup_stats": amg2.setup_stats, "iterations": int(r2.iters),
        "cold_iterations": int(res.iters),
        "x_bitwise": bool(torch.equal(r2.x, res.x)),
        "launches_at_restore": at_restore, "launches": restored,
        "cold_launches": cold,
        "lmax": [lv.smoother.lmax for lv in amg2.levels
                 if lv.smoother is not None and hasattr(lv.smoother, "lmax")],
    }
    print(json.dumps(rec), flush=True)
    os.remove(path)
    check(amg2.setup_stats.get("restored") is True
          and amg2.setup_stats["coarsen_calls"] == 0,
          f"{label}: the restore coarsened ({amg2.setup_stats})")
    check(amg2.level_summary() == amg.level_summary(),
          f"{label}: restored levels differ from the set-up ones")
    check(not any(at_restore.values()),
          f"{label}: the restore launched {at_restore}")
    check(int(r2.iters) == int(res.iters) and int(r2.status) == 0,
          f"{label}: restored iterations {r2.iters} vs {res.iters}")
    check(rec["x_bitwise"], f"{label}: restored x differs from the cold x")
    check(restored == cold, f"{label}: launches {restored} vs cold {cold}")
    if "CHEBYSHEV" in cfg:
        check(rec["lmax"] == [lv.smoother.lmax for lv in amg.levels
                              if lv.smoother is not None],
              f"{label}: restored lmax differs")
    return restored


def store_phase(torch, device="cuda", n=SLICE_N, n_f64=64, n_store=64):
    """The setup store on ``device``: (a) the four configs of
    ``STORE_CONFIGS`` at ``n``^3 f32 set up, saved and restored
    (:func:`store_roundtrip`); (b) a ``n_f64``^3 f64 payload saved on
    the card restored on the CPU (iterations equal, x to rtol 1e-9);
    (c) ``ArtifactStore`` at ``n_store``^3: a hit restores the solver, a
    corrupted, a truncated and a stale-schema entry are each a counted
    miss.  Payloads go to a directory under ``ci/artifacts`` removed at
    the end.  Returns the restored solves' launches, summed."""
    import os
    import shutil

    from amgx_tpu_torch.solvers.base import Solver
    from amgx_tpu_torch.store import ArtifactStore
    from amgx_tpu_torch.store import serialize

    folder = store_dir()
    try:
        total = dict.fromkeys(COUNTERS, 0)
        for label, cfg, formats in STORE_CONFIGS:
            got = store_roundtrip(torch, label, cfg, formats, n, np.float32,
                                  device, folder)
            for k in total:
                total[k] += got[k]
        # ---- (b) card to CPU, f64
        s, res, _, b, _ = solve_on(device, BENCH_CFG, n_f64, np.float64)
        path = os.path.join(folder, "f64.npz")
        s.save_setup(path)
        sc = Solver.load_setup(path, device="cpu")
        rc = sc.solve(b)
        x, xc = res.x.cpu().numpy(), rc.x.numpy()
        d = float(np.abs(x - xc).max())
        print(json.dumps({"store_card_to_cpu": {
            "n": n_f64, "iterations": int(res.iters),
            "cpu_iterations": int(rc.iters), "max_abs_diff": d,
            "restore_s": sc.restore_time,
            "coarsen_calls": sc.precond.setup_stats["coarsen_calls"]}}),
            flush=True)
        check(int(rc.iters) == int(res.iters),
              f"card to cpu: iterations {rc.iters} vs {res.iters}")
        check(np.allclose(xc, x, rtol=1e-9, atol=1e-9 * np.abs(x).max()),
              f"card to cpu: x differs by {d:.3e}")
        os.remove(path)
        del s, sc
        # ---- (c) ArtifactStore: a hit, then three defects, each a miss
        s, res, _, b, _ = solve_on(device, BENCH_CFG, n_store, np.float32)
        st = ArtifactStore(os.path.join(folder, "store"))
        outcomes = {}
        for defect in ("none", "corrupt", "truncated", "stale_schema"):
            key = st.put_setup(s)
            check(key is not None, "store: put_setup failed")
            npz = os.path.join(st.root, key + ".npz")
            side = os.path.join(st.root, key + ".json")
            if defect == "corrupt":
                blob = bytearray(open(npz, "rb").read())
                blob[len(blob) // 2] ^= 0xFF
                open(npz, "wb").write(bytes(blob))
            elif defect == "truncated":
                blob = open(npz, "rb").read()
                open(npz, "wb").write(blob[:len(blob) // 3])
            elif defect == "stale_schema":
                meta = json.loads(open(side).read())
                meta["schema_version"] = serialize.SCHEMA_VERSION + 1
                open(side, "w").write(json.dumps(meta))
            before = st.stats()
            got = st.get_setup(key, device=device)
            after = st.stats()
            delta = {k: after.get(k, 0) - before.get(k, 0)
                     for k in set(after) | set(before)}
            outcomes[defect] = {k: v for k, v in delta.items() if v}
            if defect == "none":
                check(got is not None and delta.get("hits") == 1,
                      f"store: no hit ({delta})")
                r2 = got.solve(b)
                check(int(r2.iters) == int(res.iters)
                      and bool(torch.equal(r2.x, res.x)),
                      "store: the hit solves differently")
            else:
                check(got is None and delta.get("misses") == 1
                      and not delta.get("hits"),
                      f"store: {defect} entry not a counted miss ({delta})")
            st.delete(key)
        print(json.dumps({"artifact_store": {
            "n": n_store, "outcomes": outcomes, "stats": st.stats()}}),
            flush=True)
        return total
    finally:
        shutil.rmtree(folder, ignore_errors=True)


# ---------------------------------------------------------------------------
# the C API (api/capi.py and the native shim), in the modes of the mode
# table: PHASES "capi"

CAPI_N = SLICE_N
CAPI_CMP_N = 64
CAPI_SELL_N = 64
CAPI_C_N = 64
# the tests/test_capi.py config (PCG + two BLOCK_JACOBI sweeps) with
# max_iters 1000 for its 300: PCG takes about two iterations a grid
# line, some 250 at 128^3
JACOBI_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "tolerance": 1e-08, "max_iters": 1000,'
    ' "preconditioner": {"scope": "p", "solver": "BLOCK_JACOBI",'
    ' "max_iters": 2, "monitor_residual": 0}}}'
)


def capi_mode(letters, device):
    """The mode of vector and matrix ``letters`` ("DFI") on ``device``:
    ``d`` for the card, ``h`` for the CPU."""
    return ("d" if device == "cuda" else "h") + letters


def capi_flow(mode, cfg, sp, b):
    """The AMGX_* sequence of a host code through the port's handle
    layer (``amgx_tpu_torch.api.capi``): upload the CSR of ``sp``, b,
    x = 0, setup, solve, download; kernel counts zeroed just before
    setup and read just after the solve.  Returns a record with the
    set-up solver (for the walks) and x."""
    from amgx_tpu_torch.api import capi as C

    n = sp.shape[0]
    c = C.config_create(cfg)
    r = C.resources_create_simple(c)
    A = C.matrix_create(r, mode)
    vb, vx = C.vector_create(r, mode), C.vector_create(r, mode)
    s = C.solver_create(r, mode, c)
    t0 = time.perf_counter()
    C.matrix_upload_all(A, n, sp.nnz, 1, 1, sp.indptr, sp.indices, sp.data)
    upload_s = time.perf_counter() - t0
    C.vector_upload(vb, n, 1, b)
    C.vector_set_zero(vx, n, 1)
    zero_counts()
    t0 = time.perf_counter()
    C.solver_setup(s, A)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    C.solver_solve(s, vb, vx)
    solve_s = time.perf_counter() - t0
    out = {"mode": mode, "status": C.solver_get_status(s),
           "iterations": C.solver_get_iterations_number(s),
           "x": C.vector_download(vx), "launches": variant_counts(),
           "upload_s": upload_s, "setup_s": setup_s, "solve_s": solve_s,
           "solver": C._get(s).solver}
    for fn, h in (("solver_destroy", s), ("vector_destroy", vx),
                  ("vector_destroy", vb), ("matrix_destroy", A),
                  ("resources_destroy", r), ("config_destroy", c)):
        getattr(C, fn)(h)
    return out


def capi_cpu_side(n_cmp, n_sell):
    """The CPU port's side of the capi phase (``h`` modes): the bench
    config in hDFI at ``n_cmp``^3, JACOBI_CFG in hFBI at ``n_cmp``^3
    and in hDFI and hFBI on ``irregular_poisson(n_sell)``:
    {label: (status, iterations, x)}."""
    import amgx_tpu_torch
    from amgx_tpu_torch.io.poisson import poisson_rhs, poisson_scipy

    amgx_tpu_torch.initialize()
    sp = poisson_scipy((n_cmp,) * 3).tocsr()
    irr = irregular_poisson(n_sell)
    out = {}
    for label, mode, cfg, m in (("bench_DFI", "hDFI", BENCH_CFG, sp),
                                ("jacobi_FBI", "hFBI", JACOBI_CFG, sp),
                                ("sell_DFI", "hDFI", JACOBI_CFG, irr),
                                ("sell_FBI", "hFBI", JACOBI_CFG, irr)):
        b = poisson_rhs(m.shape[0], dtype=np.float64)
        f = capi_flow(mode, cfg, m, b)
        out[label] = (f["status"], f["iterations"], f["x"])
    return out


def jacobi_pcg_launches(s, iters):
    """SpMVs of a PCG + BLOCK_JACOBI solve of ``iters`` iterations on
    the level-0 operator: r0 = b - A x0 and one A p an iteration, and in
    each of the iters + 1 preconditioner applications every Jacobi
    sweep after the first (the first starts from x = 0 and needs no
    residual)."""
    return (iters + 1) * (1 + max(s.precond.max_iters - 1, 0))


def shim_flow(lib, mode, cfg, sp, b):
    """The same host sequence through the native shim loaded in this
    process (ctypes; raw CSR buffers in the mode's dtypes, handles as
    uintptr_t): every RC, status, iterations, x and the launches
    (zeroed just before AMGX_solver_setup, read just after the
    solve)."""
    import ctypes

    H, P = ctypes.c_uint64, ctypes.c_void_p
    n = sp.shape[0]
    mat_dt = np.float32 if mode[2] == "F" else np.float64
    vec_dt = np.float32 if mode[1] == "F" else np.float64
    rp = np.ascontiguousarray(sp.indptr, np.int32)
    ci = np.ascontiguousarray(sp.indices, np.int32)
    vals = np.ascontiguousarray(sp.data, mat_dt)
    bb = np.ascontiguousarray(b, vec_dt)
    x = np.zeros(n, vec_dt)
    md = ctypes.c_char_p(mode.encode())
    c, r, A, vb, vx, s = (H() for _ in range(6))
    rcs = [lib.AMGX_config_create(ctypes.byref(c),
                                  ctypes.c_char_p(cfg.encode())),
           lib.AMGX_resources_create_simple(ctypes.byref(r), c),
           lib.AMGX_matrix_create(ctypes.byref(A), r, md),
           lib.AMGX_vector_create(ctypes.byref(vb), r, md),
           lib.AMGX_vector_create(ctypes.byref(vx), r, md),
           lib.AMGX_solver_create(ctypes.byref(s), r, md, c)]
    t0 = time.perf_counter()
    rcs.append(lib.AMGX_matrix_upload_all(
        A, n, sp.nnz, 1, 1, rp.ctypes.data_as(P), ci.ctypes.data_as(P),
        vals.ctypes.data_as(P), None))
    upload_s = time.perf_counter() - t0
    rcs.append(lib.AMGX_vector_upload(vb, n, 1, bb.ctypes.data_as(P)))
    rcs.append(lib.AMGX_vector_upload(vx, n, 1, x.ctypes.data_as(P)))
    zero_counts()
    t0 = time.perf_counter()
    rcs.append(lib.AMGX_solver_setup(s, A))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rcs.append(lib.AMGX_solver_solve(s, vb, vx))
    solve_s = time.perf_counter() - t0
    launches, per_entry = kernel_counts(), variant_counts()
    st, it = ctypes.c_int(-1), ctypes.c_int(-1)
    rcs.append(lib.AMGX_solver_get_status(s, ctypes.byref(st)))
    rcs.append(lib.AMGX_solver_get_iterations_number(s, ctypes.byref(it)))
    rcs.append(lib.AMGX_vector_download(vx, x.ctypes.data_as(P)))
    from amgx_tpu_torch.api import capi as C

    solver = C._get(s.value).solver
    for fn, h in (("AMGX_solver_destroy", s), ("AMGX_vector_destroy", vx),
                  ("AMGX_vector_destroy", vb), ("AMGX_matrix_destroy", A),
                  ("AMGX_resources_destroy", r), ("AMGX_config_destroy", c)):
        rcs.append(getattr(lib, fn)(h))
    return {"rcs": rcs, "status": st.value, "iterations": it.value, "x": x,
            "launches": launches, "variants": per_entry, "solver": solver,
            "upload_s": upload_s,
            "setup_s": setup_s, "solve_s": solve_s}


def shim_rcs(lib):
    """Return codes of misuse through the shim: a handle that names no
    object, an unknown mode, and the batched solve on a handle that
    names no solver."""
    import ctypes

    H = ctypes.c_uint64
    c, r, A = H(), H(), H()
    got = {
        "config": lib.AMGX_config_create(
            ctypes.byref(c), ctypes.c_char_p(BENCH_CFG.encode())),
        "resources": lib.AMGX_resources_create_simple(ctypes.byref(r), c),
        "bad_handle": lib.AMGX_solver_setup(H(987654321), H(987654322)),
        "bad_mode": lib.AMGX_matrix_create(ctypes.byref(A), r,
                                           ctypes.c_char_p(b"xQQQ")),
    }
    arr = (H * 1)(0)
    got["solve_batch"] = lib.AMGX_solver_solve_batch(H(1), 1, arr, arr, arr)
    lib.AMGX_resources_destroy(r)
    lib.AMGX_config_destroy(c)
    return got


def same_x(label, x, xc, wide):
    """Card against CPU: equal iterations and x to rtol 1e-9 with f64
    vectors (checked by the caller), x to 1e-3 with f32 ones."""
    xinf = float(np.abs(xc).max())
    d = float(np.abs(x.astype(np.float64) - xc.astype(np.float64)).max())
    tol = 1e-9 if wide else 1e-3
    check(np.allclose(x, xc, rtol=tol, atol=tol * xinf),
          f"{label}: x card vs CPU max abs diff {d:.3e}, |x|inf {xinf:.3e}")
    return d


def capi_phase(torch, peaks=None, device="cuda", n=CAPI_N, n_cmp=CAPI_CMP_N,
               n_sell=CAPI_SELL_N, n_c=CAPI_C_N):
    """The C API on the card, in the mode table's real modes (module
    docstring, phase 20).  Returns ({path: launches per entry point},
    kernel case records, the dFFI path's launches per kernel)."""
    import ctypes
    import os
    import shutil

    from amgx_tpu_torch.api import capi as C
    from amgx_tpu_torch.io.poisson import poisson_rhs, poisson_scipy
    from amgx_tpu_torch.ops import kernels

    on_card = device == "cuda"
    variants, recs, summary = {}, [], {}
    # ---- a. build the shim and the C host program
    t0 = time.perf_counter()
    native = kernels.build_native()
    summary["native_build_s"] = time.perf_counter() - t0
    print(json.dumps({"capi_build": {
        "seconds": summary["native_build_s"],
        "lib": os.path.basename(str(native["lib"])),
        "program": os.path.basename(str(native["program"]))}}), flush=True)
    # ---- b. the bench config in dFFI through the shim, in this process
    lib = ctypes.PyDLL(str(native["lib"]))
    check(lib.AMGX_initialize() == 0, "AMGX_initialize through the shim")
    sp = poisson_scipy((n,) * 3).tocsr()
    sp.sort_indices()
    b32 = poisson_rhs(sp.shape[0], dtype=np.float32)
    mode = capi_mode("FFI", device)
    f = shim_flow(lib, mode, BENCH_CFG, sp, b32)
    iters = f["iterations"]
    derived = pcg_derived_launches(f["solver"], iters)
    rel = rel_residual_sp(sp, b32, f["x"])
    # the same CSR arrays through the port's own entry points
    import amgx_tpu_torch as T

    A32 = T.SparseMatrix.from_csr(sp.indptr, sp.indices,
                                  sp.data.astype(np.float32), device=device)
    direct = T.create_solver(T.AMGConfig.from_string(BENCH_CFG), "default",
                             device=device).setup(A32)
    rd = direct.solve(b32)
    same = (int(rd.iters) == iters
            and np.array_equal(rd.x.cpu().numpy(), f["x"]))
    rec = {"capi_dFFI_bench": {
        "n": n, "mode": mode, "rcs_all_zero": not any(f["rcs"]),
        "status": f["status"], "iterations": iters,
        "true_rel_residual_f64": rel, "launches": f["launches"],
        "derived": derived, "direct_iterations": int(rd.iters),
        "x_bitwise_direct": same, "upload_s": f["upload_s"],
        "setup_s": f["setup_s"], "solve_s": f["solve_s"],
        "direct_setup_s": direct.setup_time,
        "direct_solve_s": direct.solve_time}}
    print(json.dumps(rec), flush=True)
    check(not any(f["rcs"]), f"dFFI shim RCs {f['rcs']}")
    check(f["status"] == 0, f"dFFI status {f['status']}")
    check(rel <= 1e-5, f"dFFI true relative residual {rel:.3e}")
    check(same, "dFFI through the shim differs from the direct solve")
    if on_card:
        check(f["launches"] == derived,
              f"dFFI launches {f['launches']} != derived {derived}")
    variants["capi_dFFI"] = f["variants"]
    counts = f["launches"]
    rcs = shim_rcs(lib)
    print(json.dumps({"capi_shim_rcs": rcs}), flush=True)
    # ---- f. misuse through the shim: a code, never a crash
    # the batched solve is ported: handle 1 names no solver, so it is
    # RC_BAD_PARAMETERS, as the JAX package answers any unknown handle
    check(rcs == {"config": 0, "resources": 0, "bad_handle": 1,
                  "bad_mode": 9, "solve_batch": 1},
          f"shim RCs {rcs}")
    del A32, direct, rd, f

    # ---- c. the bench config in dDFI (f32 matrix, f64 vectors)
    b64 = poisson_rhs(sp.shape[0], dtype=np.float64)
    f = capi_flow(capi_mode("DFI", device), BENCH_CFG, sp, b64)
    s, iters = f["solver"], f["iterations"]
    A0 = s.precond.levels[0].A
    want = derived_variant_launches(s.precond, iters + 1,
                                    top=((A0, torch.float64, iters + 1),))
    rel = rel_residual_sp(sp, b64, f["x"])
    print(json.dumps({"capi_dDFI_bench": {
        "n": n, "status": f["status"], "iterations": iters,
        "x_dtype": str(f["x"].dtype), "true_rel_residual_f64": rel,
        "launches": f["launches"], "derived": want,
        "upload_s": f["upload_s"], "setup_s": f["setup_s"],
        "solve_s": f["solve_s"]}}), flush=True)
    check(f["status"] == 0 and f["x"].dtype == np.float64,
          f"dDFI status {f['status']}, x {f['x'].dtype}")
    check(rel <= 1e-5, f"dDFI true relative residual {rel:.3e}")
    check_variants("capi dDFI", f["launches"], want, device)
    variants["capi_dDFI"] = f["launches"]
    if on_card:
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            A0.n_rows)).cuda()
        recs.append(mixed_dia_case(torch, peaks, "dia_spmv_f32_f64",
                                   f"capi dDFI level0 A {n}^3 f32/f64", A0,
                                   x))
    del f, s, A0

    # ---- d. PCG + BLOCK_JACOBI in dFBI on the 7-point matrix
    b32 = poisson_rhs(sp.shape[0], dtype=np.float32)
    f = capi_flow(capi_mode("FBI", device), JACOBI_CFG, sp, b32)
    s, iters = f["solver"], f["iterations"]
    entry = kernels.entry_point("dia_spmv", s.A.dtype, torch.float32)
    want = {entry: jacobi_pcg_launches(s, iters)}
    rel = rel_residual_sp(sp, b32, f["x"])
    print(json.dumps({"capi_dFBI_jacobi": {
        "n": n, "status": f["status"], "iterations": iters,
        "matrix_dtype": str(s.A.dtype), "x_dtype": str(f["x"].dtype),
        "true_rel_residual_f64": rel, "launches": f["launches"],
        "derived": want, "setup_s": f["setup_s"],
        "solve_s": f["solve_s"]}}), flush=True)
    check(f["status"] == 0 and s.A.dtype == torch.bfloat16,
          f"dFBI status {f['status']}, A {s.A.dtype}")
    check_variants("capi dFBI", f["launches"], want, device)
    variants["capi_dFBI"] = f["launches"]
    if on_card:
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            s.A.n_rows)).cuda().float()
        recs.append(mixed_dia_case(torch, peaks, "dia_spmv_bf16_f32",
                                   f"capi dFBI A {n}^3 bf16/f32", s.A, x))
    del f, s, sp

    # ---- d. the same two modes on an unstructured upload (sliced ELL)
    irr = irregular_poisson(n_sell)
    card = {}
    for letters, vdt in (("DFI", np.float64), ("FBI", np.float32)):
        b = poisson_rhs(irr.shape[0], dtype=vdt)
        f = capi_flow(capi_mode(letters, device), JACOBI_CFG, irr, b)
        s, iters = f["solver"], f["iterations"]
        S = s.A.sell
        check(S is not None and s.A.format == "ELL",
              f"{letters} irregular upload: {s.A.format}, no sliced layout")
        entry = kernels.entry_point("sell_spmv", s.A.dtype,
                                    torch.from_numpy(b).dtype)
        want = {entry: jacobi_pcg_launches(s, iters)}
        print(json.dumps({f"capi_d{letters}_sell": {
            "n": n_sell, "rows": irr.shape[0], "nonzeros": irr.nnz,
            "status": f["status"], "iterations": iters,
            "sell": sell_info(S, s.A.nnz), "launches": f["launches"],
            "derived": want, "setup_s": f["setup_s"],
            "solve_s": f["solve_s"]}}), flush=True)
        check(f["status"] == 0, f"{letters} sliced status {f['status']}")
        check_variants(f"capi d{letters} sliced", f["launches"], want,
                       device)
        variants[f"capi_d{letters}_sell"] = f["launches"]
        card[f"sell_{letters}"] = (f["status"], iters, f["x"])
        if on_card:
            x = torch.from_numpy(np.random.default_rng(3).standard_normal(
                irr.shape[0]).astype(vdt)).cuda()
            recs.append(mixed_sell_case(
                torch, peaks, entry, f"capi d{letters} irregular {n_sell}^3 "
                f"{str(s.A.dtype)[6:]}/{str(x.dtype)[6:]} lanes {S.lanes}",
                s.A, x))
        del f, s, S
    if on_card:
        # a slice count small enough for 4 lanes a row: the tree adds
        # the parts in its own order, held within TOL
        small = irregular_poisson(32)
        As = T.SparseMatrix.from_scipy(small.astype(np.float32),
                                       device="cuda")
        check(As.sell is not None and As.sell.lanes > 1,
              "irregular 32^3: no multi-lane sliced layout")
        x = torch.from_numpy(np.random.default_rng(4).standard_normal(
            As.n_rows)).cuda()
        recs.append(mixed_sell_case(
            torch, peaks, "sell_spmv_f32_f64",
            f"irregular 32^3 f32/f64 lanes {As.sell.lanes}", As, x,
            exact=False))
        del As

    # e.'s C host program starts now, in a subprocess beside the
    # comparison with the CPU port (no kernel is timed from here on): its
    # interpreter and card start-up overlap that work
    folder = store_dir()
    cfg_file = os.path.join(folder, "bench.json")
    with open(cfg_file, "w") as fh:
        fh.write(BENCH_CFG.replace(
            '"monitor_residual": 1,',
            '"monitor_residual": 1, "print_solve_stats": 1,', 1))
    xfile = os.path.join(folder, "x.bin")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path
                                                      if p))
    t_prog = time.perf_counter()
    prog_proc = subprocess.Popen(
        [str(native["program"]), str(n_c), capi_mode("DDI", device),
         cfg_file, xfile], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)

    # ---- c., d. the card against the CPU port at n_cmp^3
    sp = poisson_scipy((n_cmp,) * 3).tocsr()
    for label, letters, cfg, vdt in (
            ("bench_DFI", "DFI", BENCH_CFG, np.float64),
            ("jacobi_FBI", "FBI", JACOBI_CFG, np.float32)):
        f = capi_flow(capi_mode(letters, device), cfg, sp,
                      poisson_rhs(sp.shape[0], dtype=np.float64))
        card[label] = (f["status"], f["iterations"], f["x"])
    cpu = CPU.get(capi_cpu_side, n_cmp, n_sell)
    cmp = {}
    for label, (st, it, x) in card.items():
        cst, cit, cx = cpu[label]
        wide = x.dtype == np.float64
        d = same_x(label, x, cx, wide)
        cmp[label] = {"iterations": it, "cpu_iterations": cit,
                      "status": st, "cpu_status": cst,
                      "max_abs_diff_vs_cpu": d}
        check(st == cst == 0, f"{label}: status card {st}, cpu {cst}")
        check(it == cit if wide else abs(it - cit) <= 1,
              f"{label}: iterations card {it} vs cpu {cit}")
    print(json.dumps({"capi_card_vs_cpu": cmp}), flush=True)

    # ---- e. the C host program (started before c., d.'s comparison),
    # dDDI at n_c^3
    try:
        stdout, stderr = prog_proc.communicate(timeout=600)
        prog_s = time.perf_counter() - t_prog
        mode = capi_mode("DDI", device)
        check(prog_proc.returncode == 0,
              f"capi_poisson exit {prog_proc.returncode}: {stdout[-2000:]}"
              f"{stderr[-2000:]}")
        prog = json.loads(stdout.strip().splitlines()[-1])
        xc = np.fromfile(xfile, dtype=np.float64)
        spc = poisson_scipy((n_c,) * 3).tocsr()
        spc.sort_indices()
        f = capi_flow(mode, BENCH_CFG, spc, np.ones(spc.shape[0]))
        same = bool(np.array_equal(xc, f["x"]))
        print(json.dumps({"capi_c_program": {
            **prog, "process_s": prog_s,
            "in_process_iterations": f["iterations"],
            "x_bitwise_in_process": same}}), flush=True)
        check(prog["status"] == 0, f"C program status {prog['status']}")
        check(prog["iterations"] == f["iterations"],
              f"C program iterations {prog['iterations']} vs in-process "
              f"{f['iterations']}")
        check(same, "C program x differs from the in-process solve")
        check(prog["print_lines"] > 0, "the print callback received nothing")
        check(prog["rc_bad_handle"] == 1,
              f"C program bad handle RC {prog['rc_bad_handle']}")
        check(prog["rel_residual"] <= 1e-5,
              f"C program residual {prog['rel_residual']:.3e}")
    finally:
        if prog_proc.poll() is None:
            prog_proc.kill()
            prog_proc.wait()
        shutil.rmtree(folder, ignore_errors=True)
    check(lib.AMGX_finalize() == 0, "AMGX_finalize through the shim")
    C.finalize()
    return variants, recs, counts


def mixed_dia_case(torch, peaks, name, label, A, x, exact=True):
    """``dia_spmv`` on a mixed pair at its path's shape: bit for bit
    with the plain version (a complex pair, ``exact`` False: within TOL
    of the row's |A||x|), timed as every variant case (bytes: the
    nonzeros in the planes' dtype, x read and y written in x's, the
    offsets)."""
    from amgx_tpu_torch.ops import dia

    check(dia.kernels.entry_point("dia_spmv", A.dtype, x.dtype) == name,
          f"{label}: entry point is not {name}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = dia.dia_launch_plan(A.n_rows, A.dia_offsets, A.dtype, sms,
                               x_dtype=x.dtype)
    vs, xs = A.dia_vals.element_size(), x.element_size()
    return variant_case(
        torch, Timer(torch), peaks, name, label, A, x,
        lambda: dia.dia_spmv(A.dia_vals, A.dia_offsets, x),
        lambda: dia.dia_spmv_plain(A.dia_vals, A.dia_offsets, x),
        nbytes=vs * A.nnz + 2 * xs * A.n_rows + 4 * len(A.dia_offsets),
        extra={"plan": {k: v for k, v in plan._asdict().items()
                        if k != "offsets"}}, exact=exact)


def mixed_sell_case(torch, peaks, name, label, A, x, exact=True):
    """``sell_spmv`` on a mixed pair: bit for bit with the plain version
    with one lane a row, within TOL with more (``exact`` False)."""
    from amgx_tpu_torch.ops import ell

    S = A.sell
    vs, xs = S.vals.element_size(), x.element_size()
    return variant_case(
        torch, Timer(torch), peaks, name, label, A, x,
        lambda: ell.sell_spmv(S, x), lambda: ell.sell_spmv_plain(S, x),
        nbytes=(4 + vs) * A.nnz + xs * (A.n_cols + A.n_rows),
        extra={"sell": sell_info(S, A.nnz)}, exact=exact)


# ---------------------------------------------------------------------------
# the complex modes of the mode table (dZZI, dCCI, dZCI) through the C
# API, MATRIX_FREE in the complex and mixed modes, and the port's
# amgx_capi CLI: PHASES "capi_complex"

CX_N = SLICE_N
CX_CMP_N = 64
CX_SELL_N = 64
CX_BATCH_N = 32
CX_BATCH_B = 16
CX_CLI_N = 64
CX_MTX_N = 24
# the imaginary shift of the complex-shifted Laplacian L + i sigma I (the
# shifted-Laplacian preconditioner of Helmholtz problems): complex
# symmetric, not Hermitian, so the solves take GMRES and BiCGStab
CX_SIGMA = 0.3
# tests/test_complex.py:127-150 (GMRES(20) + SIZE_2 aggregation AMG,
# BLOCK_JACOBI 0.7, DENSE_LU) with min_coarse_rows 2048 for its 32
CX_AMG_CFG = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "GMRES", "max_iters": 100, "gmres_n_restart": 20,'
    ' "tolerance": 1e-08, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_2",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.7, "monitor_residual": 0},'
    ' "max_iters": 1, "min_coarse_rows": 2048,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "monitor_residual": 0}}}'
)
CX_AMG_CFG_C = CX_AMG_CFG.replace('"tolerance": 1e-08', '"tolerance": 1e-05')
CX_MF_CFG = CX_AMG_CFG.replace('"selector": "SIZE_2",',
                               '"selector": "SIZE_2", "matrix_free": 1,')
CX_MF_CFG_C = CX_AMG_CFG_C.replace('"selector": "SIZE_2",',
                                   '"selector": "SIZE_2", "matrix_free": 1,')
# GMRES(20) + two BLOCK_JACOBI sweeps, for the unstructured uploads
CX_JACOBI_CFG = JACOBI_CFG.replace(
    '"solver": "PCG",', '"solver": "GMRES", "gmres_n_restart": 20,')
CX_JACOBI_CFG_C = CX_JACOBI_CFG.replace('"tolerance": 1e-08',
                                        '"tolerance": 1e-05')
# the batched solve: PBICGSTAB (GMRES has no batched form) over CX_AMG's
# hierarchy with Galerkin plans on every level (the serve layer's
# batched AMG needs them)
CX_SERVE_CFG = CX_AMG_CFG.replace(
    '"solver": "GMRES", "max_iters": 100, "gmres_n_restart": 20,',
    '"solver": "PBICGSTAB", "max_iters": 100,').replace(
    '"min_coarse_rows": 2048,',
    '"min_coarse_rows": 512, "structure_reuse_levels": -1,')
CX_SERVE_CFG_C = CX_SERVE_CFG.replace('"tolerance": 1e-08',
                                      '"tolerance": 1e-05')
CX_SERVE_JACOBI_CFG = JACOBI_CFG.replace('"solver": "PCG",',
                                         '"solver": "PBICGSTAB",')
CX_DT = {"Z": np.complex128, "C": np.complex64}


def shifted(sp, dtype=np.complex128):
    """``sp + i CX_SIGMA I`` in ``dtype``, its indices sorted."""
    import scipy.sparse as sps

    out = (sp + 1j * CX_SIGMA * sps.eye_array(sp.shape[0])).tocsr()
    out.sort_indices()
    return out.astype(dtype)


def complex_rhs(n, seed, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        dtype)


def complex_rel_residual(sp, b, x):
    """||b - A x|| / ||b|| in complex128 (scipy)."""
    sp = sp.astype(np.complex128)
    b, x = b.astype(np.complex128), x.astype(np.complex128)
    return float(np.linalg.norm(b - sp @ x) / np.linalg.norm(b))


def gmres_cycles(s, iters):
    """Preconditioner applications (and A-SpMVs) of a left-preconditioned
    GMRES solve of ``iters`` iterations: one residual a restart cycle
    (r0 included), one A v and one M apply an iteration."""
    return -(-iters // s.restart) + iters


def cx_amg_walk(s, iters, x_dtype):
    """Launches per entry point of a GMRES + AMG solve (``s``): the
    top A-SpMVs on ``s.A`` with x of ``x_dtype``, the cycles in the
    hierarchy's dtype (:func:`derived_variant_launches`)."""
    cyc = gmres_cycles(s, iters)
    return derived_variant_launches(s.precond, cyc, top=((s.A, x_dtype,
                                                          cyc),))


def cx_jacobi_walk(s, iters, x_dtype):
    """Launches of a GMRES + BLOCK_JACOBI solve: each of the cycles'
    A-SpMVs and M applies, and every Jacobi sweep after the first of
    each apply, on ``s.A`` with x of ``x_dtype``."""
    from amgx_tpu_torch.ops import kernels

    cyc = gmres_cycles(s, iters)
    return {kernels.entry_point(counter_of(s.A), s.A.dtype, x_dtype):
            cyc * (1 + max(s.precond.max_iters - 1, 0))}


def capi_complex_cpu_side(n_cmp):
    """The CPU port's side of the capi_complex phase: CX_AMG_CFG in
    hZZI, hCCI and hZCI at ``n_cmp``^3: {mode letters: (status,
    iterations, x)}."""
    import amgx_tpu_torch
    from amgx_tpu_torch.io.poisson import poisson_scipy

    amgx_tpu_torch.initialize()
    base = poisson_scipy((n_cmp,) * 3).tocsr()
    out = {}
    for letters, cfg in (("ZZI", CX_AMG_CFG), ("CCI", CX_AMG_CFG_C),
                         ("ZCI", CX_AMG_CFG)):
        f = capi_flow("h" + letters, cfg, shifted(base, CX_DT[letters[1]]),
                      complex_rhs(base.shape[0], 7, CX_DT[letters[0]]))
        out[letters] = (f["status"], f["iterations"], f["x"])
    return out


def cx_stencil_case(torch, peaks, name, label, A, x, twin, exact=False):
    """``stencil_spmv`` on the MATRIX_FREE ``A`` against its plain
    version (:func:`variant_case`: within TOL of the row's |A||x| in
    complex, bit for bit for the mixed pairs), and bit for bit against
    the DIA kernel on the same matrix (``twin``, its DIA upload in the
    same dtype)."""
    from amgx_tpu_torch.ops import dia, stencil

    run = lambda: stencil.stencil_spmv(A, x)  # noqa: E731
    rec = variant_case(
        torch, Timer(torch), peaks, name, label, A, x, run,
        lambda: stencil.stencil_spmv_plain(A.mf_meta, A.mf_coefs, x),
        nbytes=2 * x.element_size() * A.n_rows
        + A.mf_coefs.element_size() * A.mf_coefs.numel(), exact=exact)
    same = bool(torch.equal(run(), dia.dia_spmv(twin.dia_vals,
                                                twin.dia_offsets, x)))
    check(same, f"{label}: stencil kernel vs DIA kernel not bit for bit")
    rec["bitwise_dia_kernel"] = same
    return rec


def cx_ell_case(torch, peaks, name, label, A, x):
    """The slot-major ELL kernel on ``A``'s ELL arrays, within TOL of the
    row's |A||x| of its plain version."""
    from amgx_tpu_torch.ops import ell

    return variant_case(
        torch, Timer(torch), peaks, name, label, A, x,
        lambda: ell.ell_spmv(A.ell_cols, A.ell_vals, x),
        lambda: ell.ell_spmv_plain(A.ell_cols, A.ell_vals, x),
        nbytes=(4 + A.ell_vals.element_size()) * A.nnz + x.element_size()
        * (A.n_cols + A.n_rows), exact=False)


def cx_batched_cases(torch, peaks, rng, amg, n, B):
    """The six complex batched entry points at the batched paths'
    shapes: the template's level-0 A (DIA, batched planes) and R
    (slot-major ELL, shared values) of ``amg``'s hierarchy, and the
    irregular pattern's padded template (sliced ELL, batched values),
    B instances each, in c128 and c64."""
    import dataclasses

    from amgx_tpu_torch.ops import dia, ell
    from amgx_tpu_torch.serve.bucketing import pad_pattern

    timer, recs = Timer(torch), []
    lv0 = amg.levels[0]

    def mv_of(lib, x, label):
        """``torch.mv`` of the block-diagonal CSR, or None (printed)
        where torch has no product for it."""
        try:
            torch.mv(lib, x.reshape(-1))
            return lambda: torch.mv(lib, x.reshape(-1))
        except (RuntimeError, NotImplementedError) as e:
            print(json.dumps({"library_none": {"case": label,
                                               "error": str(e)[:200]}}),
                  flush=True)
            return None

    irr = shifted(irregular_poisson(n))
    pat = pad_pattern(irr.indptr, irr.indices, irr.shape[0])
    for dt, short in ((torch.complex128, "c128"), (torch.complex64, "c64")):
        npdt = np.complex128 if short == "c128" else np.complex64
        isz = torch.empty((), dtype=dt).element_size()

        def cx(shape):
            return torch.from_numpy(rng.standard_normal(shape) + 1j
                                    * rng.standard_normal(shape)).cuda().to(dt)

        A = lv0.A.astype(dt)
        ro, ci, _ = A._host
        nf = A.n_rows
        Ab = A.replace_values_batched(A.values * (1.0 + 0.05 * cx((B, A.nnz))))
        x = cx((B, nf))
        name = f"dia_spmv_batched_{short}"
        lib = blockdiag_csr(torch, ro, ci, Ab.values, nf)
        recs.append(batched_case(
            torch, timer, peaks, name, f"capi_complex {name} level0 A B{B} "
            f"{n}^3",
            lambda: dia.dia_spmv_batched(Ab.dia_vals, Ab.dia_offsets, x),
            lambda: dia.dia_spmv_batched_plain(Ab.dia_vals, Ab.dia_offsets,
                                               x),
            lambda i: dia.dia_spmv(Ab.dia_vals[i].contiguous(),
                                   Ab.dia_offsets, x[i]),
            mv_of(lib, x, name),
            nbytes=isz * B * (A.nnz + 2 * nf) + 4 * len(A.dia_offsets),
            nops=8 * B * A.nnz, dtype=dt))
        R = lv0.R.astype(dt)
        check(R.format == "ELL" and R.sell is None,
              f"level-0 R: {R.format}, sliced {R.sell is not None}")
        rro, rci, _ = R._host
        xr = cx((B, R.n_cols))
        w = int(R.ell_cols.shape[0])
        name = f"ell_spmv_batched_{short}"
        lib = blockdiag_csr(torch, rro, rci,
                            R.values.expand(B, -1).contiguous(), R.n_cols)
        recs.append(batched_case(
            torch, timer, peaks, name, f"capi_complex {name} level0 R "
            f"{R.n_rows}x{R.n_cols} w={w} shared B{B}",
            lambda: ell.ell_spmv_batched(R.ell_cols, R.ell_vals, xr),
            lambda: ell.ell_spmv_batched_plain(R.ell_cols, R.ell_vals, xr),
            lambda i: ell.ell_spmv(R.ell_cols, R.ell_vals, xr[i]),
            mv_of(lib, xr, name),
            nbytes=(4 + isz) * R.nnz + isz * B * (R.n_rows + R.n_cols),
            nops=8 * B * R.nnz, dtype=dt))
        T_ = pat.template_matrix(irr.data.astype(npdt), npdt,
                                 accel_formats=("ell",), device="cuda")
        check(T_.format == "ELL" and T_.sell is not None,
              f"irregular template {T_.format}, sliced "
              f"{T_.sell is not None}")
        vals = np.stack([pat.embed_values(
            irr.data * (1.0 + 0.05 * rng.standard_normal(irr.nnz)), npdt)
            for _ in range(B)])
        Tb = T_.replace_values_batched(torch.from_numpy(vals).cuda())
        xs = cx((B, pat.nb))
        S = Tb.sell
        name = f"sell_spmv_batched_{short}"
        lib = blockdiag_csr(torch, pat.row_offsets, pat.col_indices,
                            Tb.values, pat.nb)
        recs.append(batched_case(
            torch, timer, peaks, name, f"capi_complex {name} irregular A "
            f"{pat.nb} B{B}",
            lambda: ell.sell_spmv_batched(S, xs),
            lambda: ell.sell_spmv_batched_plain(S, xs),
            lambda i: ell.sell_spmv(dataclasses.replace(S, vals=S.vals[i]),
                                    xs[i]),
            mv_of(lib, xs, name),
            nbytes=4 * irr.nnz + isz * B * (irr.nnz + 2 * pat.nb),
            nops=8 * B * irr.nnz, dtype=dt,
            extra={"lanes": S.lanes, "stored_slots": S.stored}))
        del A, Ab, R, T_, Tb, lib
    return recs


def cx_served(device, cfg, systems):
    """``AMGX_solver_solve_batch`` in the handle layer over ``systems``
    (the mode from their dtypes, on ``device``): [(status, iterations,
    x)] and the batched launches per entry point, counted from just
    before the batched solve to the last download."""
    from amgx_tpu_torch.api import capi as C

    letters = "ZZI" if systems[0][1].dtype == np.complex128 else "CCI"
    mode = capi_mode(letters, device)
    c = C.config_create(cfg)
    r = C.resources_create_simple(c)
    s = C.solver_create(r, mode, c)
    mats, rhs, sols = [], [], []
    for sp, b in systems:
        A, vb, vx = (C.matrix_create(r, mode), C.vector_create(r, mode),
                     C.vector_create(r, mode))
        C.matrix_upload_all(A, sp.shape[0], sp.nnz, 1, 1, sp.indptr,
                            sp.indices, sp.data)
        C.vector_upload(vb, sp.shape[0], 1, b)
        C.vector_set_zero(vx, sp.shape[0], 1)
        mats.append(A)
        rhs.append(vb)
        sols.append(vx)
    zero_counts()
    t0 = time.perf_counter()
    C.solver_solve_batch(s, mats, rhs, sols)
    xs = [C.vector_download(v) for v in sols]
    secs = time.perf_counter() - t0
    launches = batched_counts()
    out = [(C.solver_get_batch_status(s, i),
            C.solver_get_batch_iterations_number(s, i), xs[i])
           for i in range(len(systems))]
    for h in sols + rhs:
        C.vector_destroy(h)
    for h in mats:
        C.matrix_destroy(h)
    C.solver_destroy(s)
    C.resources_destroy(r)
    C.config_destroy(c)
    return out, launches, secs


def cx_family(base, count, seed, dtype):
    """``count`` systems on the pattern of ``base`` (complex): every
    entry jittered by 5 % in magnitude, a complex right-hand side
    each."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        sp = base.copy()
        sp.data = sp.data * (1.0 + 0.05 * rng.standard_normal(sp.nnz))
        out.append((sp.astype(dtype), complex_rhs(sp.shape[0], seed + k,
                                                  dtype)))
    return out


def table_of(text):
    """The residual table of a ``print_solve_stats`` output, its timing
    lines left out: [(label, residual, rate or None)] and the status."""
    rows, status = [], None
    for line in text.splitlines():
        parts = line.split()
        if len(parts) in (2, 3) and (parts[0] == "Ini" or parts[0].isdigit()):
            try:
                vals = [float(p) for p in parts[1:]]
            except ValueError:
                continue
            rows.append((parts[0], vals[0], vals[1] if len(vals) > 1
                         else None))
        elif line.strip().startswith("Solve status:"):
            status = line.split(":", 1)[1].strip()
    return rows, status


def cli_run(args, env):
    """``python -m amgx_tpu_torch.examples.amgx_capi`` with ``args`` in
    a subprocess started now (the caller waits on it)."""
    return subprocess.Popen(
        [sys.executable, "-m", "amgx_tpu_torch.examples.amgx_capi", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def capi_complex_phase(torch, peaks=None, device="cuda", n=CX_N,
                       n_cmp=CX_CMP_N, n_sell=CX_SELL_N, n_batch=CX_BATCH_N,
                       B=CX_BATCH_B, n_cli=CX_CLI_N, n_mtx=CX_MTX_N):
    """The mode table's complex modes on the card through the C API, and
    MATRIX_FREE in the complex and mixed modes (module docstring, phase
    capi_complex).  Returns ({path: launches per entry point}, kernel
    case records)."""
    import os
    import shutil

    import amgx_tpu_torch as T
    from amgx_tpu_torch.io.matrix_market import write_system
    from amgx_tpu_torch.io.poisson import poisson_rhs, poisson_scipy
    from amgx_tpu_torch.ops import kernels

    on_card = device == "cuda"
    variants, recs = {}, []
    rng = np.random.default_rng(22)
    base = poisson_scipy((n,) * 3).tocsr()
    base.sort_indices()
    N = base.shape[0]
    bz = complex_rhs(N, 7)
    sols = {}

    def cx_x(m, dt):
        return torch.from_numpy(complex_rhs(m, 3)).to(device).to(dt)

    # ---- a., b., c. GMRES + SIZE_2 AMG in dZZI, dCCI, dZCI at n^3
    # the true residual's bound: 10 x the tolerance, as GMRES stops on
    # the left-preconditioned residual; in dZCI the c64 hierarchy's
    # rounding (M^-1 r to c64 precision) bounds it at 1e-5
    for letters, cfg, rel_max in (("ZZI", CX_AMG_CFG, 1e-7),
                                  ("CCI", CX_AMG_CFG_C, 1e-4),
                                  ("ZCI", CX_AMG_CFG, 1e-5)):
        vdt, mdt = CX_DT[letters[0]], CX_DT[letters[1]]
        sp = shifted(base, mdt)
        f = capi_flow(capi_mode(letters, device), cfg, sp, bz.astype(vdt))
        s, iters = f["solver"], f["iterations"]
        xt = torch.complex128 if letters[0] == "Z" else torch.complex64
        want = cx_amg_walk(s, iters, xt)
        rel = complex_rel_residual(sp, bz, f["x"])
        lv = s.precond.levels
        rec = {"n": n, "sigma": CX_SIGMA, "status": f["status"],
               "iterations": iters, "x_dtype": str(f["x"].dtype),
               "matrix_dtype": str(s.A.dtype)[6:],
               "hierarchy_dtype": str(lv[0].A.dtype)[6:],
               "levels": [(m.A.n_rows, m.A.format) for m in lv],
               "true_rel_residual_c128": rel, "launches": f["launches"],
               "derived": want, "upload_s": f["upload_s"],
               "setup_s": f["setup_s"], "solve_s": f["solve_s"]}
        print(json.dumps({f"capi_complex_d{letters}": rec}), flush=True)
        check(f["status"] == 0 and f["x"].dtype == vdt,
              f"d{letters} status {f['status']}, x {f['x'].dtype}")
        check(rel <= rel_max, f"d{letters} true relative residual "
              f"{rel:.3e} > {rel_max}")
        check(str(lv[0].A.dtype) == f"torch.{np.dtype(mdt).name}",
              f"d{letters} hierarchy in {lv[0].A.dtype}")
        check_variants(f"capi_complex d{letters}", f["launches"], want,
                       device)
        variants[f"complex_d{letters}"] = f["launches"]
        sols[letters] = f["x"]
        if on_card:
            A0 = lv[0].A
            top = s.A
            recs.append(mixed_dia_case(
                torch, peaks, kernels.entry_point("dia_spmv", top.dtype,
                                                  xt),
                f"capi_complex d{letters} A {n}^3 {str(top.dtype)[6:]}/"
                f"{str(xt)[6:]}", top, cx_x(top.n_rows, xt), exact=False))
            if letters != "ZCI":
                R = lv[0].R
                check(R.format == "ELL" and R.sell is None,
                      f"d{letters} level-0 R {R.format}")
                recs.append(cx_ell_case(
                    torch, peaks,
                    kernels.entry_point("ell_spmv", R.dtype, A0.dtype),
                    f"capi_complex d{letters} level0 R {R.n_rows}x"
                    f"{R.n_cols} {str(R.dtype)[6:]}", R,
                    cx_x(R.n_cols, A0.dtype)))
        del f, s, lv, sp

    # ---- d. MATRIX_FREE in dZZI and dZCI: a MATRIX_FREE upload in the
    # modes' dtypes through the solver entry (the C API's upload builds
    # DIA: its matrix_free rebuilds only the hierarchy's level 0)
    for letters, cfg in (("ZZI", CX_MF_CFG), ("ZCI", CX_MF_CFG)):
        vdt, mdt = CX_DT[letters[0]], CX_DT[letters[1]]
        sp = shifted(base, mdt)
        A = T.SparseMatrix.from_csr(sp.indptr, sp.indices, sp.data,
                                    accel_formats=MF_FORMATS, device=device)
        check(A.has_matrix_free, f"d{letters} upload not MATRIX_FREE")
        zero_counts()
        t0 = time.perf_counter()
        s = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                            device=device).setup(A)
        r = s.solve(bz.astype(vdt))
        secs = time.perf_counter() - t0
        got = variant_counts()
        xt = torch.complex128 if letters[0] == "Z" else torch.complex64
        iters = int(r.iters)
        want = cx_amg_walk(s, iters, xt)
        x = r.x.cpu().numpy()
        lv = s.precond.levels
        same = bool(np.array_equal(x, sols[letters]))
        print(json.dumps({f"capi_complex_mf_d{letters}": {
            "n": n, "status": int(r.status), "iterations": iters,
            "levels": [(m.A.n_rows, m.A.format) for m in lv],
            "launches": got, "derived": want, "x_bitwise_dia": same,
            "setup_solve_s": secs}}), flush=True)
        # the walk puts every top and level-0 SpMV on the stencil kernel
        check(int(r.status) == 0 and s.A.has_matrix_free
              and lv[0].A.has_matrix_free,
              f"MF d{letters}: status {int(r.status)}, top {s.A.format}, "
              f"level 0 {lv[0].A.format}")
        check_variants(f"capi_complex MF d{letters}", got, want, device)
        check(same, f"MF d{letters}: x differs from the DIA solve's")
        variants[f"complex_mf_d{letters}"] = got
        if on_card:
            D = T.SparseMatrix.from_csr(sp.indptr, sp.indices, sp.data,
                                        device=device)
            for xdt in sorted({xt, lv[0].A.dtype}, key=str):
                recs.append(cx_stencil_case(
                    torch, peaks,
                    kernels.entry_point("stencil_spmv", A.dtype, xdt),
                    f"capi_complex MF d{letters} A {n}^3 "
                    f"{str(A.dtype)[6:]}/{str(xdt)[6:]}", A,
                    cx_x(A.n_rows, xdt), D))
            del D
        del A, s, r, lv

    # ---- e. MATRIX_FREE in the dDFI and dFBI dtypes, the bench config
    # (in dFBI with its hierarchy in the matrix's bf16, MF_BF16_CFG: the
    # SIZE_8 transfers are built in f32 and a bf16 level's residual has
    # no (f32, bf16) kernel): the stencil kernel's mixed pairs, x bit for
    # bit the DIA upload's
    for letters, mdt, vdt, cfg in (
            ("DFI", torch.float32, np.float64, BENCH_CFG),
            ("FBI", torch.bfloat16, np.float32, MF_BF16_CFG)):
        b = poisson_rhs(N, dtype=vdt)
        xs, counts, fmts = {}, {}, {}
        mf_cfg = cfg.replace('"cycle": "V",',
                             '"cycle": "V", "matrix_free": 1,')
        for formats, text in ((MF_FORMATS, mf_cfg),
                              (("dia", "dense", "ell"), cfg)):
            A = T.SparseMatrix.from_csr(
                base.indptr, base.indices, base.data.astype(np.float32),
                accel_formats=formats, device=device).astype(mdt)
            zero_counts()
            s = T.create_solver(T.AMGConfig.from_string(text), "default",
                                device=device).setup(A)
            r = s.solve(b)
            got = variant_counts()
            it = int(r.iters)
            want = derived_variant_launches(
                s.precond, it + 1,
                top=((s.A, torch.from_numpy(b).dtype, it + 1),))
            check(int(r.status) == 0, f"d{letters} {A.format}: status "
                  f"{int(r.status)}")
            check_variants(f"capi_complex d{letters} {A.format}", got,
                           want, device)
            key = "mf" if "matrix_free" in formats else "dia"
            xs[key], counts[key], fmts[key] = (r.x.cpu().numpy(), got,
                                               A.format)
            if key == "mf" and on_card:
                D = T.SparseMatrix.from_csr(
                    base.indptr, base.indices, base.data.astype(np.float32),
                    device=device).astype(mdt)
                xdt = torch.from_numpy(b).dtype
                recs.append(cx_stencil_case(
                    torch, peaks,
                    kernels.entry_point("stencil_spmv", mdt, xdt),
                    f"capi_complex MF d{letters} A {n}^3 {str(mdt)[6:]}/"
                    f"{str(xdt)[6:]}", A, torch.from_numpy(
                        rng.standard_normal(N)).to(device).to(xdt), D,
                    exact=True))
                del D
            del A, s, r
        same = bool(np.array_equal(xs["mf"], xs["dia"]))
        print(json.dumps({f"capi_complex_mf_d{letters}": {
            "n": n, "formats": fmts, "launches": counts,
            "x_bitwise_dia": same}}), flush=True)
        check(same, f"MF d{letters}: x differs from the DIA upload's")
        variants[f"complex_mf_d{letters}"] = counts["mf"]

    # ---- f. unstructured uploads: the sliced layout in dZZI, dCCI and
    # dZCI, the slot-major one (a shuffled periodic grid) in dZCI
    irr = shifted(irregular_poisson(n_sell))
    shuf = shifted(torus_poisson(n_sell))
    for label, sp0, letters in (("sell", irr, "ZZI"), ("sell", irr, "CCI"),
                                ("sell", irr, "ZCI"), ("ell", shuf, "ZCI")):
        vdt, mdt = CX_DT[letters[0]], CX_DT[letters[1]]
        sp = sp0.astype(mdt)
        cfg = CX_JACOBI_CFG_C if letters == "CCI" else CX_JACOBI_CFG
        b = complex_rhs(sp.shape[0], 9, vdt)
        f = capi_flow(capi_mode(letters, device), cfg, sp, b)
        s, iters = f["solver"], f["iterations"]
        xt = torch.complex128 if letters[0] == "Z" else torch.complex64
        want = cx_jacobi_walk(s, iters, xt)
        sliced = s.A.sell is not None
        print(json.dumps({f"capi_complex_{label}_d{letters}": {
            "n": n_sell, "rows": sp.shape[0], "nonzeros": sp.nnz,
            "format": s.A.format, "sliced": sliced,
            "status": f["status"], "iterations": iters,
            "true_rel_residual_c128": complex_rel_residual(sp, b, f["x"]),
            "launches": f["launches"], "derived": want,
            "setup_s": f["setup_s"], "solve_s": f["solve_s"]}}),
            flush=True)
        check(f["status"] == 0, f"{label} d{letters} status {f['status']}")
        check(s.A.format == "ELL" and sliced == (label == "sell"),
              f"{label} d{letters}: {s.A.format}, sliced {sliced}")
        check_variants(f"capi_complex {label} d{letters}", f["launches"],
                       want, device)
        variants[f"complex_{label}_d{letters}"] = f["launches"]
        if on_card:
            name = next(iter(want))
            case_label = (f"capi_complex {label} d{letters} {n_sell}^3 "
                          f"{str(s.A.dtype)[6:]}/{str(xt)[6:]}")
            x = cx_x(s.A.n_cols, xt)
            recs.append(
                mixed_sell_case(torch, peaks, name, case_label, s.A, x,
                                exact=False) if sliced else
                cx_ell_case(torch, peaks, name, case_label, s.A, x))
        del f, s

    # ---- g. the C API's batched solve in dZZI and dCCI on B n_batch^3
    # systems, each against its sequential solve (one setup on system
    # 0, then resetup), and on the irregular pattern
    fam = shifted(poisson_scipy((n_batch,) * 3).tocsr())
    irr_b = shifted(irregular_poisson(n_batch))
    for letters, cfg, rtol in (("ZZI", CX_SERVE_CFG, 1e-10),
                               ("CCI", CX_SERVE_CFG_C, 1e-4)):
        dt = CX_DT[letters[0]]
        jac = CX_SERVE_JACOBI_CFG if letters == "ZZI" else \
            CX_SERVE_JACOBI_CFG.replace('"tolerance": 1e-08',
                                        '"tolerance": 1e-05')
        for label, sp0, cnt, c in (("grid", fam, B, cfg),
                                   ("irregular", irr_b, 4, jac)):
            systems = cx_family(sp0, cnt, 31, dt)
            got, launches, secs = cx_served(device, c, systems)
            ref, _, _ = serve_seq(device, c, systems, True)
            rec = same_as_seq(f"batched d{letters} {label}",
                              [(st, it, x, None) for st, it, x in got], ref,
                              rtol=rtol,
                              iters_within=0 if letters == "ZZI" else 1)
            print(json.dumps({f"capi_complex_batch_d{letters}_{label}": {
                "n": n_batch, "batch": cnt, **rec, "launches": launches,
                "solve_batch_s": secs}}), flush=True)
            short = "c128" if letters == "ZZI" else "c64"
            names = ([f"dia_spmv_batched_{short}",
                      f"ell_spmv_batched_{short}"] if label == "grid"
                     else [f"sell_spmv_batched_{short}"])
            if on_card:
                for nm in names:
                    check(launches.get(nm, 0) > 0,
                          f"batched d{letters} {label}: {nm} not launched")
            variants[f"complex_batch_d{letters}_{label}"] = launches
    if on_card:
        tmpl = T.create_solver(T.AMGConfig.from_string(CX_SERVE_CFG),
                               "default", device=device).setup(
            T.SparseMatrix.from_scipy(fam, device=device))
        recs += cx_batched_cases(torch, peaks, rng, tmpl.precond, n_batch, B)
        del tmpl

    # ---- h. (started now, beside the comparison with the CPU port: no
    # kernel is timed from here on) the port's amgx_capi CLI
    folder = store_dir()
    cfg_file = os.path.join(folder, "bench.json")
    with open(cfg_file, "w") as fh:
        fh.write(BENCH_CFG)
    cx_file = os.path.join(folder, "cx.json")
    with open(cx_file, "w") as fh:
        fh.write(CX_AMG_CFG)
    mtx = os.path.join(folder, "shifted.mtx")
    msp = shifted(poisson_scipy((n_mtx,) * 3).tocsr())
    write_system(mtx, T.SparseMatrix.from_scipy(msp, accel_formats=(),
                                                device="cpu"),
                 rhs=complex_rhs(msp.shape[0], 5))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path
                                                      if p))
    t_cli = time.perf_counter()
    clis = {
        "dDDI": cli_run(["-p", str(n_cli), str(n_cli), str(n_cli), "-c",
                         cfg_file, "-mode", capi_mode("DDI", device)], env),
        "dZZI": cli_run(["-m", mtx, "-c", cx_file, "-mode",
                         capi_mode("ZZI", device)], env),
    }
    try:
        # ---- a.-c. the card against the CPU port at n_cmp^3
        cmp_base = poisson_scipy((n_cmp,) * 3).tocsr()
        cpu = CPU.get(capi_complex_cpu_side, n_cmp)
        cmp = {}
        for letters, cfg in (("ZZI", CX_AMG_CFG), ("CCI", CX_AMG_CFG_C),
                             ("ZCI", CX_AMG_CFG)):
            f = capi_flow(capi_mode(letters, device), cfg,
                          shifted(cmp_base, CX_DT[letters[1]]),
                          complex_rhs(cmp_base.shape[0], 7,
                                      CX_DT[letters[0]]))
            st, it, x = f["status"], f["iterations"], f["x"]
            cst, cit, cx_ = cpu[letters]
            wide = letters == "ZZI"
            xinf = float(np.abs(cx_).max())
            d = float(np.abs(x.astype(np.complex128)
                             - cx_.astype(np.complex128)).max())
            tol = 1e-9 if wide else 1e-4
            cmp[letters] = {"iterations": it, "cpu_iterations": cit,
                            "status": st, "cpu_status": cst,
                            "max_abs_diff_vs_cpu": d, "x_inf": xinf}
            check(st == cst == 0, f"d{letters} {n_cmp}^3: status card {st}, "
                  f"cpu {cst}")
            check(it == cit if wide else abs(it - cit) <= 1,
                  f"d{letters} {n_cmp}^3: iterations card {it} vs cpu {cit}")
            check(d <= tol * xinf, f"d{letters} {n_cmp}^3: x card vs CPU "
                  f"{d:.3e} > {tol} x {xinf:.3e}")
        print(json.dumps({"capi_complex_card_vs_cpu": cmp}), flush=True)

        # ---- h. the CLI's two runs: exit 0 and the residual table
        cli = {}
        for label, proc in clis.items():
            stdout, stderr = proc.communicate(timeout=600)
            rows, status = table_of(stdout)
            cli[label] = {"exit": proc.returncode, "table_rows": len(rows),
                          "status": status,
                          "final_residual": rows[-1][1] if rows else None}
            check(proc.returncode == 0 and status == "success" and rows,
                  f"amgx_capi {label}: exit {proc.returncode}, status "
                  f"{status}: {stdout[-1500:]}{stderr[-1500:]}")
        cli["process_s"] = time.perf_counter() - t_cli
        print(json.dumps({"capi_complex_cli": cli}), flush=True)
    finally:
        for proc in clis.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(folder, ignore_errors=True)
    return variants, recs


# every phase in the order a run takes them; a phase named on the
# command line brings the phases it needs
# ---------------------------------------------------------------------
# 21. serve: the batched solve service (amgx_tpu_torch.serve)

SERVE_N = 64
SERVE_B = 16
SERVE_CPU_N = 24
SERVE_GUARD_N = 32
# tests/test_serve.py's PCG_AMG: PCG + SIZE_8 aggregation AMG with
# Galerkin plans on every level (the batch rebuild needs them)
SERVE_PCG_AMG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-8, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 32, "max_levels": 10,'
    ' "structure_reuse_levels": -1,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
    ' "monitor_residual": 0}}}'
)
# SERVE_PCG_AMG in f32, to the tolerance of the f32 groups
SERVE_PCG_AMG_F32 = SERVE_PCG_AMG.replace('"tolerance": 1e-8',
                                          '"tolerance": 1e-6')
# the batched entry point each unbatched counter's SpMV takes with a
# batch of vectors
BATCHED = {"dia_spmv": "dia_spmv_batched", "ell_spmv": "ell_spmv_batched",
           "sell_spmv": "sell_spmv_batched", "csr": "csr"}


def serve_family(shape, count, seed=0, dtype=np.float64):
    """``count`` jittered Poisson systems on ``shape`` (the JAX
    package's ``jittered_poisson_family``) in ``dtype``."""
    from amgx_tpu_torch.io.poisson import jittered_poisson_family

    return [(sp.astype(dtype, copy=False), b.astype(dtype, copy=False))
            for sp, b in jittered_poisson_family(shape, count, seed=seed)]


def irregular_family(m, count, seed=0, dtype=np.float64):
    """``count`` systems on the pattern of :func:`irregular_poisson`
    ``(m)``, each entry jittered by 5 %, symmetrized, plus 0.5 I."""
    import scipy.sparse as sps

    base = irregular_poisson(m)
    n = base.shape[0]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        sp = base.copy()
        sp.data = sp.data * (1.0 + 0.05 * rng.standard_normal(sp.nnz))
        sp = ((sp + sp.T) * 0.5 + sps.eye_array(n) * 0.5).tocsr()
        sp.sort_indices()
        out.append((sp.astype(dtype), rng.standard_normal(n).astype(dtype)))
    return out


def batched_walk(amg, cycles, top, x_dtype):
    """Launches per batched entry point (and CSR products) of ``cycles``
    cycles of a batched AMG hierarchy (:func:`cycle_walk` over the
    template's levels) and ``top`` level-0 A-SpMVs outside them."""
    from amgx_tpu_torch.ops import kernels

    counts = {}

    def add(m, k):
        c = BATCHED.get(counter_of(m))
        if c is None or not k:
            return
        name = c if c == "csr" else kernels.entry_point(c, m.dtype, x_dtype)
        counts[name] = counts.get(name, 0) + k

    lv = amg.levels
    add(lv[0].A, top)
    sm = next((lvl.smoother for lvl in lv if lvl.smoother is not None),
              None)
    walk = cycle_walk(amg, sweep_spmvs(sm) if sm is not None else 1,
                      coarse_solve_spmvs(amg))
    for (i, f), k in walk.items():
        add(getattr(lv[i], f), cycles * k)
    return counts


def comm_walk(s, iters):
    """Launches per batched entry point of a COMM_AVOIDING_CONFIG group
    whose longest instance ran ``iters`` outer iterations: r0 = b - A
    x0, then per outer iteration s A-SpMVs and s cycles (s-step PCG's
    Krylov block), in f64."""
    import torch

    return batched_walk(s.precond, s.s * iters, 1 + s.s * iters,
                        torch.float64)


def cheap_walk(s, corrections):
    """Launches per batched entry point of a
    CHEAP_PRECONDITIONER_CONFIG group whose longest instance made
    ``corrections`` corrections: each runs the inner PCG's init and its
    ``max_iters`` iterations (an A-SpMV of the f64 operator and a
    cycle each, the cycle in the hierarchy's dtype); the float-float
    residual of a DIA operator launches no kernel (plane sums), of
    another two SpMVs a residual (one more residual before the
    loop)."""
    import torch

    from amgx_tpu_torch.ops import kernels

    inner = s.inner
    amg = inner.precond
    k = (inner.max_iters + 1) * corrections
    walk = batched_walk(amg, k, 0, amg.levels[0].A.dtype)
    A = s.A
    top = k + (0 if A.has_dia else 2 * (corrections + 1))
    c = BATCHED[counter_of(A)]
    name = c if c == "csr" else kernels.entry_point(c, A.dtype,
                                                    torch.float64)
    return add_counts(walk, {name: top})


def jacobi_walk(A, iters, x_dtype):
    """Launches of a batched PCG + BLOCK_JACOBI (2 sweeps) group of
    ``iters`` iterations on ``A`` (:func:`jacobi_pcg_launches`)."""
    from amgx_tpu_torch.ops import kernels

    c = BATCHED[counter_of(A)]
    return {kernels.entry_point(c, A.dtype, x_dtype): 2 * (iters + 1)}


def batched_counts():
    """Launches of the batched entry points, per entry point."""
    return {k: v for k, v in variant_counts().items() if "batched" in k}


def add_counts(*counts):
    """The sum of launch counts per entry point."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def serve_seq(device, cfg, systems, reuse):
    """The sequential reference on ``device``: with ``reuse`` one solver
    set up on system 0, then ``replace_values``, ``resetup`` and
    ``solve`` for each system (``tests/test_serve.py``'s contract for a
    cached hierarchy), else a setup and a solve each.  Returns
    ([(status, iterations, x)], first seconds (the setup and the first
    solve), the rest's seconds)."""
    import amgx_tpu_torch as T

    out, first_s = [], 0.0
    t0 = time.perf_counter()
    s = A0 = None
    for i, (sp, b) in enumerate(systems):
        if reuse and A0 is not None:
            s.resetup(A0.replace_values(sp.data))
        else:
            A = T.SparseMatrix.from_scipy(sp, device=device)
            A0 = A
            s = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                                device=device).setup(A)
        r = s.solve(b)
        out.append((int(r.status), int(r.iters), r.x.cpu().numpy()))
        if i == 0:
            first_s = time.perf_counter() - t0
    return out, first_s, time.perf_counter() - t0 - first_s


def served(svc, systems):
    """``svc.solve_many(systems)`` as [(status, iterations, x, history)]
    and its seconds, and those seconds split by the service's phases
    (``pad``: submit's host work, the pattern's hash included;
    ``setup``; ``dispatch``: the upload and the batched solve)."""
    before = svc.metrics.profile.snapshot()["times"]
    t0 = time.perf_counter()
    res = svc.solve_many(systems)
    secs = time.perf_counter() - t0
    after = svc.metrics.profile.snapshot()["times"]
    split = {k: after[k] - before.get(k, 0.0) for k in after
             if ":" not in k}
    return [(int(r.status), int(r.iters), r.x.cpu().numpy(), r.history)
            for r in res], {"s": secs, **split}


def same_as_seq(label, got, ref, rtol=1e-10, iters_within=0):
    """Statuses, iterations (within ``iters_within``) and x (to
    ``rtol`` of its largest entry, None: unchecked) of a served group
    against its sequential reference."""
    worst, it_diff = 0.0, 0
    for (st, it, x, _), (rst, rit, rx) in zip(got, ref):
        check(st == rst == 0, f"{label}: status {st} vs sequential {rst}")
        it_diff = max(it_diff, abs(it - rit))
        worst = max(worst, float(np.abs(x - rx).max() / np.abs(rx).max()))
    check(it_diff <= iters_within,
          f"{label}: iterations differ by {it_diff} from the sequential")
    if rtol is not None:
        check(worst <= rtol, f"{label}: x differs by {worst:.3e} > {rtol}")
    return {"max_iterations_diff": it_diff, "x_max_rel_diff": worst}


def serve_cpu_side(n, count=4):
    """The CPU port's side of the serve phase: PCG_AMG and
    DEFAULT_CONFIG served at ``n``^3 f64: {config: [(status, iterations,
    x)]}."""
    import amgx_tpu_torch  # noqa: F401
    from amgx_tpu_torch.serve import DEFAULT_CONFIG, BatchedSolveService

    systems = serve_family((n,) * 3, count, seed=3)
    out = {}
    for label, cfg in (("pcg_amg", SERVE_PCG_AMG),
                       ("default", DEFAULT_CONFIG)):
        svc = BatchedSolveService(config=cfg, max_batch=count,
                                  device="cpu")
        out[label] = [(int(r.status), int(r.iters), r.x.numpy())
                      for r in svc.solve_many(systems)]
    return out


def true_residual(sp, b, x):
    sp64 = sp.astype(np.float64)
    b64 = b.astype(np.float64)
    return float(np.linalg.norm(b64 - sp64 @ x.astype(np.float64))
                 / np.linalg.norm(b64))


def serve_guards(torch, device, n):
    """Check f: a quarantined NaN request, validation rejects and an
    expired deadline at ``n``^3, counters as in
    ``tests/test_robustness.py``."""
    from amgx_tpu_torch.core.errors import (
        AMGXTPUError,
        DeadlineExceededError,
        NonFiniteValuesError,
    )
    from amgx_tpu_torch.serve import BatchedSolveService

    systems = serve_family((n,) * 3, 4, seed=7)
    sp = systems[0][0]
    bad = sp.copy()
    bad.data = bad.data.copy()
    bad.data[5] = np.nan
    svc = BatchedSolveService(max_batch=4, validate=False, device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tickets = [svc.submit(bad, systems[0][1])] + [
            svc.submit(s, b) for s, b in systems[1:]]
        svc.flush()
    try:
        tickets[0].result()
        typed = False
    except AMGXTPUError:
        typed = True
    mates = [t.result() for t in tickets[1:]]
    res = [true_residual(s, b, r.x.cpu().numpy())
           for (s, b), r in zip(systems[1:], mates)]
    snap = svc.metrics.snapshot()
    quarantine = {k: snap.get(k, 0) for k in (
        "quarantines", "poisoned_requests", "quarantined_solves",
        "failed_groups")}
    check(typed, "the NaN request's ticket did not raise a typed error")
    check(all(int(r.status) == 0 for r in mates) and max(res) <= 1e-7,
          f"groupmates of the NaN request: {res}")
    check(quarantine == {"quarantines": 1, "poisoned_requests": 1,
                         "quarantined_solves": 3, "failed_groups": 1},
          f"quarantine counters {quarantine}")
    svc = BatchedSolveService(device=device)
    rejects = 0
    for A, b in ((bad, systems[0][1]),
                 (sp, np.full(sp.shape[0], np.nan))):
        try:
            svc.submit(A, b)
        except NonFiniteValuesError:
            rejects += 1
    check(rejects == 2 and svc.metrics.get("validation_rejects") == 2,
          f"validation rejects {rejects}")
    svc = BatchedSolveService(max_batch=8, device=device)
    try:
        svc.submit(sp, systems[0][1], deadline_s=-1.0)
        doa = False
    except DeadlineExceededError:
        doa = True
    t_late = svc.submit(sp, systems[0][1], deadline_s=0.01)
    t_ok = svc.submit(systems[1][0], systems[1][1])
    time.sleep(0.05)
    svc.flush()
    try:
        t_late.result()
        late = False
    except DeadlineExceededError:
        late = True
    ok = int(t_ok.result().status) == 0
    check(doa and late and ok
          and svc.metrics.get("deadline_expired") == 2,
          f"deadlines: on arrival {doa}, late {late}, groupmate {ok}")
    return {"quarantine": quarantine, "groupmate_true_residuals": res,
            "validation_rejects": rejects,
            "deadline_expired": svc.metrics.get("deadline_expired")}


def serve_capi(torch, device, n, count=4):
    """Check g: ``AMGX_solver_solve_batch`` through the native shim
    (``ctypes.PyDLL``) in dDDI on ``count`` systems of ``n``^3 with
    DEFAULT_CONFIG: every RC, and statuses and iterations against the
    in-process service's."""
    import ctypes

    from amgx_tpu_torch.api import capi as C
    from amgx_tpu_torch.ops import kernels
    from amgx_tpu_torch.serve import DEFAULT_CONFIG, BatchedSolveService

    lib = ctypes.PyDLL(str(kernels.build_native()["lib"]))
    H, P = ctypes.c_uint64, ctypes.c_void_p
    systems = serve_family((n,) * 3, count, seed=11)
    mode = ctypes.c_char_p(capi_mode("DDI", device).encode())
    c, r, s = H(), H(), H()
    rcs = [lib.AMGX_initialize(),
           lib.AMGX_config_create(ctypes.byref(c),
                                  ctypes.c_char_p(DEFAULT_CONFIG.encode())),
           lib.AMGX_resources_create_simple(ctypes.byref(r), c),
           lib.AMGX_solver_create(ctypes.byref(s), r, mode, c)]
    mats, rhs, sols, keep = [], [], [], []
    for sp, b in systems:
        A, vb, vx = H(), H(), H()
        rp = np.ascontiguousarray(sp.indptr, np.int32)
        ci = np.ascontiguousarray(sp.indices, np.int32)
        vals = np.ascontiguousarray(sp.data, np.float64)
        bb = np.ascontiguousarray(b, np.float64)
        keep += [rp, ci, vals, bb]
        m = sp.shape[0]
        rcs += [lib.AMGX_matrix_create(ctypes.byref(A), r, mode),
                lib.AMGX_vector_create(ctypes.byref(vb), r, mode),
                lib.AMGX_vector_create(ctypes.byref(vx), r, mode),
                lib.AMGX_matrix_upload_all(
                    A, m, sp.nnz, 1, 1, rp.ctypes.data_as(P),
                    ci.ctypes.data_as(P), vals.ctypes.data_as(P), None),
                lib.AMGX_vector_upload(vb, m, 1, bb.ctypes.data_as(P)),
                lib.AMGX_vector_set_zero(vx, m, 1)]
        mats.append(A.value)
        rhs.append(vb.value)
        sols.append(vx.value)
    arr = lambda hs: (H * len(hs))(*hs)  # noqa: E731
    t0 = time.perf_counter()
    rcs.append(lib.AMGX_solver_solve_batch(s, count, arr(mats), arr(rhs),
                                           arr(sols)))
    xs = []
    for h, (sp, _) in zip(sols, systems):
        x = np.zeros(sp.shape[0], np.float64)
        rcs.append(lib.AMGX_vector_download(H(h), x.ctypes.data_as(P)))
        xs.append(x)
    shim_s = time.perf_counter() - t0
    statuses = [C.solver_get_batch_status(s.value, i) for i in range(count)]
    iters = [C.solver_get_batch_iterations_number(s.value, i)
             for i in range(count)]
    for h in sols + rhs:
        rcs.append(lib.AMGX_vector_destroy(H(h)))
    for h in mats:
        rcs.append(lib.AMGX_matrix_destroy(H(h)))
    rcs += [lib.AMGX_solver_destroy(s), lib.AMGX_resources_destroy(r),
            lib.AMGX_config_destroy(c)]
    direct = BatchedSolveService(config=DEFAULT_CONFIG, device=device
                                 ).solve_many(systems)
    want_st = [int(d.status) for d in direct]
    want_it = [int(d.iters) for d in direct]
    x_diff = max(float(np.abs(x - d.x.cpu().numpy()).max()
                       / np.abs(d.x.cpu().numpy()).max())
                 for x, d in zip(xs, direct))
    rec = {"rcs_all_zero": not any(rcs), "statuses": statuses,
           "iterations": iters, "service_statuses": want_st,
           "service_iterations": want_it, "x_max_rel_diff": x_diff,
           "shim_solve_download_s": shim_s}
    check(not any(rcs), f"serve C API RCs {rcs}")
    check(statuses == want_st and iters == want_it,
          f"solve_batch statuses {statuses} / iterations {iters} vs the "
          f"service's {want_st} / {want_it}")
    return rec


def serve_phase(torch, device="cuda", n=SERVE_N, B=SERVE_B,
                n_cpu=SERVE_CPU_N, n_guard=SERVE_GUARD_N, handoff=None,
                keep=None):
    """The batched solve service (module docstring, phase 21), its
    main service's store in a directory under ``ci/artifacts`` removed
    at the end; with ``handoff`` (a directory), serve a's exported entry
    is copied there first, for the gateway and fleet phases to
    warm-boot; with ``keep`` (a dict), serve a's systems, their
    sequential reference and its walk go there under (n, B), for the
    fleet phase.  Returns {path: launches per batched entry point}."""
    import shutil

    folder = store_dir()
    try:
        return _serve_phase(torch, device, n, B, n_cpu, n_guard, folder,
                            handoff, keep)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def _serve_phase(torch, device, n, B, n_cpu, n_guard, folder,
                 handoff=None, keep=None):
    from amgx_tpu_torch.serve import (
        CHEAP_PRECONDITIONER_CONFIG,
        COMM_AVOIDING_CONFIG,
        DEFAULT_CONFIG,
        BatchedSolveService,
    )

    on_card = device == "cuda"
    paths = {}
    # ---- a. the main path: B systems of n^3, f64, PCG_AMG
    systems = serve_family((n,) * 3, B, seed=1)
    svc = BatchedSolveService(config=SERVE_PCG_AMG, max_batch=B,
                              device=device, store=folder)
    zero_counts()
    got, first_s = served(svc, systems)
    # the entry's export (check m) ran on the background worker
    svc.flush_store(timeout=600)
    if handoff is not None:
        import shutil

        shutil.copytree(folder, handoff, dirs_exist_ok=True)
    launches, unbatched = batched_counts(), kernel_counts()
    m1 = svc.metrics.snapshot()
    entry = next(iter(svc.cache._entries.values()))
    amg = entry.solver.precond
    it_max = max(g[1] for g in got)
    want = batched_walk(amg, it_max + 1, it_max + 1, torch.float64)
    ref, seq_first_s, seq_rest_s = serve_seq(device, SERVE_PCG_AMG,
                                             systems, reuse=True)
    cmp_a = same_as_seq("serve a", got, ref)
    if keep is not None:
        keep[(n, B)] = (systems, ref, want)
    res_a = [true_residual(sp, b, g[2]) for (sp, b), g in zip(systems, got)]
    # ---- b. new coefficients on the cached pattern
    systems_b = [(sp * 1.01, b) for sp, b in systems]
    got_b, warm_s = served(svc, systems_b)
    m2 = svc.metrics.snapshot()
    rec = {"serve_pcg_amg": {
        "n": n, "batch": B, "levels": [(lv.A.n_rows, lv.A.format)
                                        for lv in amg.levels],
        "iterations": [g[1] for g in got], "statuses": [g[0] for g in got],
        "true_rel_residual_max": max(res_a), **cmp_a,
        "launches": launches, "walk": want, "unbatched_launches": unbatched,
        "batches": m1.get("batches"), "setups": m1.get("setups"),
        "fallback_solves": m1.get("fallback_solves", 0),
        "host_syncs": m1.get("host_syncs"),
        "resubmit_new_setups": m2["setups"] - m1["setups"],
        "resubmit_new_compiles": m2["compiles"] - m1["compiles"],
        "resubmit_statuses": sorted({g[0] for g in got_b}),
        "per_system_s": {"batched_first_flush": first_s["s"] / B,
                         "batched_warm_flush": warm_s["s"] / B,
                         "sequential_first": seq_first_s,
                         "sequential_warm": seq_rest_s / (B - 1)},
        "first_flush_s": first_s, "warm_flush_s": warm_s}}
    print(json.dumps(rec), flush=True)
    check(m1.get("batches") == 1 and m1.get("setups") == 1
          and m1.get("fallback_solves", 0) == 0,
          f"serve a: batches {m1.get('batches')}, setups "
          f"{m1.get('setups')}, fallback {m1.get('fallback_solves')}")
    check(max(res_a) <= 1e-8, f"serve a: true residual {max(res_a):.3e}")
    check(all(v == 0 for v in unbatched.values()),
          f"serve a: unbatched launches {unbatched}")
    if on_card:
        check(launches == want, f"serve a: launches {launches} != walk "
              f"{want}")
    check(m2["setups"] == m1["setups"] and m2["compiles"] == m1["compiles"]
          and all(g[0] == 0 for g in got_b),
          "serve b: the resubmit set up or built again")
    paths["serve_pcg_amg"] = launches

    # ---- l. four groups pipelined through a started poller; m. the
    # service's store warm-boots a fresh service
    paths["serve_pipelined"], sync = serve_pipelined(torch, device, svc,
                                                     systems, got)
    print(json.dumps({"serve_warm_boot": serve_warmboot(
        svc, systems, sync[0], device)}), flush=True)
    # the fetch watchdog after a, b and l's groups: its floor, 25 x the
    # p99 of the warm groups' loop seconds (the loop's timing events),
    # beside 25 x the p99 of the device window (every group's, to its
    # fetch, as before the repair)
    m = svc.metrics
    loops = m.watchdog_latency.summary()
    window = m.latency["device"].summary()
    wd = {"fetch_watchdog_s": svc.fetch_watchdog_s,
          "watchdog_s": svc.watchdog_s(), "warm_groups": loops["count"],
          "loop_s_p50": loops["p50_s"], "loop_s_p99": loops["p99_s"],
          "floor_s": svc._WATCHDOG_P99_FACTOR * loops["p99_s"],
          "window_floor_s": svc._WATCHDOG_P99_FACTOR * window["p99_s"],
          "device_s_p50": window["p50_s"], "device_s_max": window["max_s"]}
    print(json.dumps({"serve_watchdog": wd}), flush=True)
    # each warm loop lies inside its group's window; the watchdog is the
    # larger of its setting and the floor
    check(loops["count"] > 0 and 0 < wd["loop_s_p99"] <= wd["device_s_max"]
          and wd["watchdog_s"] == max(wd["fetch_watchdog_s"], wd["floor_s"]),
          f"serve watchdog: {wd}")
    del svc, entry, amg, systems, systems_b, got, got_b, ref, sync

    # ---- c. DEFAULT_CONFIG in f32 (and an f32 group on the irregular
    # pattern: the f32 ELL entry point's path)
    systems = serve_family((n,) * 3, B, seed=2, dtype=np.float32)
    irr = irregular_family(n, B // 2, seed=4, dtype=np.float32)
    svc = BatchedSolveService(config=DEFAULT_CONFIG, max_batch=B,
                              device=device)
    zero_counts()
    got, first_s = served(svc, systems)
    launches = batched_counts()
    A_t = next(iter(svc.cache._entries.values())).solver.A
    want = jacobi_walk(A_t, max(g[1] for g in got), torch.float32)
    got_w, warm_s = served(svc, [(sp * 1.01, b) for sp, b in systems])
    zero_counts()
    got_i, _ = served(svc, irr)
    launches_i = batched_counts()
    A_i = svc.cache.peek(
        svc._patterns[irr[0][0]._amgx_tpu_fp].fingerprint, svc.cfg_key,
        np.dtype(np.float32)).solver.A
    want_i = jacobi_walk(A_i, max(g[1] for g in got_i), torch.float32)
    # the f32 SIZE_8 transfers, slot-major (no sliced layout)
    amg_sys = serve_family((n,) * 3, B // 2, seed=11, dtype=np.float32)
    svc_a = BatchedSolveService(config=SERVE_PCG_AMG_F32, max_batch=B,
                                device=device)
    zero_counts()
    got_a, _ = served(svc_a, amg_sys)
    launches_a = batched_counts()
    amg = next(iter(svc_a.cache._entries.values())).solver.precond
    it_a = max(g[1] for g in got_a)
    want_a = batched_walk(amg, it_a + 1, it_a + 1, torch.float32)
    ref, seq_first_s, seq_rest_s = serve_seq(device, DEFAULT_CONFIG,
                                             systems, reuse=True)
    ref_i, _, _ = serve_seq(device, DEFAULT_CONFIG, irr, reuse=True)
    ref_a, _, _ = serve_seq(device, SERVE_PCG_AMG_F32, amg_sys, reuse=True)
    cmp_c = same_as_seq("serve c", got, ref, rtol=None, iters_within=1)
    cmp_ci = same_as_seq("serve c irregular", got_i, ref_i, rtol=None,
                         iters_within=1)
    cmp_ca = same_as_seq("serve c amg", got_a, ref_a, rtol=None,
                         iters_within=1)
    res_c = [true_residual(sp, b, g[2]) for (sp, b), g in zip(
        systems + irr + amg_sys, got + got_i + got_a)]
    print(json.dumps({"serve_default_f32": {
        "n": n, "batch": B, "iterations": [g[1] for g in got],
        "irregular_iterations": [g[1] for g in got_i],
        "irregular_format": A_i.format,
        "irregular_sliced": A_i.sell is not None, **cmp_c,
        "irregular": cmp_ci, "true_rel_residual_max": max(res_c),
        "launches": launches, "walk": want, "irregular_launches": launches_i,
        "irregular_walk": want_i, "amg_iterations": [g[1] for g in got_a],
        "amg": cmp_ca, "amg_launches": launches_a, "amg_walk": want_a,
        "warm_statuses": sorted({g[0] for g in got_w}),
        "per_system_s": {"batched_first_flush": first_s["s"] / B,
                         "batched_warm_flush": warm_s["s"] / B,
                         "sequential_first": seq_first_s,
                         "sequential_warm": seq_rest_s / (B - 1)},
        "first_flush_s": first_s, "warm_flush_s": warm_s}}),
        flush=True)
    check(max(res_c) <= 1e-5, f"serve c: true residual {max(res_c):.3e}")
    check(A_i.format == "ELL" and A_i.sell is not None,
          f"serve c: irregular template {A_i.format}, sliced "
          f"{A_i.sell is not None}")
    check("sell_spmv_batched_f32" in want_i
          and "ell_spmv_batched_f32" not in want_i
          and "ell_spmv_batched_f32" in want_a,
          f"serve c: walks {want_i} (irregular), {want_a} (AMG)")
    if on_card:
        check(launches == want, f"serve c: launches {launches} != {want}")
        check(launches_i == want_i,
              f"serve c irregular: launches {launches_i} != {want_i}")
        check(launches_a == want_a,
              f"serve c amg: launches {launches_a} != {want_a}")
    paths["serve_default_f32"] = add_counts(launches, launches_i, launches_a)
    del svc, svc_a, systems, irr, amg_sys, amg, got, got_i, got_a, got_w
    del ref, ref_i, ref_a

    # ---- d. a mixed queue: n^3, a padded (n - 4)^3 and the irregular
    # pattern, 8 each, DEFAULT_CONFIG in f64
    half = B // 2
    groups = (serve_family((n,) * 3, half, seed=5)
              + serve_family((n - 4,) * 3, half, seed=6)
              + irregular_family(n, half, seed=8))
    svc = BatchedSolveService(config=DEFAULT_CONFIG, max_batch=B,
                              device=device)
    zero_counts()
    got, _ = served(svc, groups)
    launches = batched_counts()
    ref, walks = [], []
    for k in range(3):
        ref += serve_seq(device, DEFAULT_CONFIG,
                         groups[k * half:(k + 1) * half], reuse=True)[0]
        A_k = svc.cache.peek(
            svc._patterns[groups[k * half][0]._amgx_tpu_fp].fingerprint,
            svc.cfg_key, np.dtype(np.float64)).solver.A
        walks.append(jacobi_walk(A_k, max(g[1] for g in got[
            k * half:(k + 1) * half]), torch.float64))
    want = add_counts(*walks)
    cmp_d = same_as_seq("serve d", got, ref)
    fmts = sorted(e.solver.A.format for e in svc.cache._entries.values())
    print(json.dumps({"serve_mixed": {
        "batches": svc.metrics.get("batches"), "formats": fmts,
        "padded_rows": [(n - 4) ** 3, svc._patterns[
            groups[half][0]._amgx_tpu_fp].nb],
        "iterations": [g[1] for g in got], **cmp_d,
        "launches": launches, "walk": want}}), flush=True)
    check(svc.metrics.get("batches") == 3, "serve d: not 3 batches")
    check(fmts == ["DIA", "DIA", "ELL"], f"serve d: formats {fmts}")
    check("sell_spmv_batched_f64" in walks[2]
          and not any(k.startswith("ell_spmv_batched") for k in want),
          f"serve d: walks {walks}")
    if on_card:
        check(launches == want, f"serve d: launches {launches} != {want}")
    paths["serve_mixed"] = launches
    del svc, groups, got, ref

    # ---- e. masked early exit: one easy system among B - 1 hard ones
    import scipy.sparse as sps

    hard = serve_family((n,) * 3, B - 1, seed=9)
    easy = hard[0][0].copy()
    easy.data = easy.data * 1e-3
    easy = (easy + sps.eye_array(easy.shape[0]) * 4.0).tocsr()
    easy.sort_indices()
    b_easy = np.random.default_rng(10).standard_normal(easy.shape[0])
    got, _ = served(BatchedSolveService(config=DEFAULT_CONFIG, max_batch=B,
                                        device=device),
                    [(easy, b_easy)] + hard)
    # frozen bit for bit: the easy system in a group of B copies of
    # itself (torch's reductions order their sums by the batch's shape)
    solo, _ = served(BatchedSolveService(config=DEFAULT_CONFIG,
                                         max_batch=B, device=device),
                     [(easy, b_easy)] * B)
    it_e, h = got[0][1], got[0][3]
    rec = {"serve_masked": {
        "easy_iterations": it_e, "group_max_iterations": max(
            g[1] for g in got), "solo_iterations": solo[0][1],
        "x_bitwise_solo": bool(np.array_equal(got[0][2], solo[0][2])),
        "history_nan_past_freeze": bool(np.all(np.isnan(h[it_e + 1:])))}}
    print(json.dumps(rec), flush=True)
    r = rec["serve_masked"]
    check(it_e < r["group_max_iterations"] and it_e == solo[0][1],
          f"serve e: easy {it_e}, group {r['group_max_iterations']}, solo "
          f"{solo[0][1]}")
    check(r["x_bitwise_solo"], "serve e: frozen x differs from its solo")
    check(r["history_nan_past_freeze"], "serve e: history past freeze")
    del hard, got, solo

    # ---- f. guards; g. the C API through the shim
    print(json.dumps({"serve_guards": serve_guards(torch, device,
                                                   n_guard)}), flush=True)
    print(json.dumps({"serve_capi_dDDI": serve_capi(torch, device, n)}),
          flush=True)

    # ---- i. card against the CPU port at n_cpu^3 f64
    cpu = CPU.get(serve_cpu_side, n_cpu)
    card = {}
    systems = serve_family((n_cpu,) * 3, 4, seed=3)
    for label, cfg in (("pcg_amg", SERVE_PCG_AMG),
                       ("default", DEFAULT_CONFIG)):
        svc = BatchedSolveService(config=cfg, max_batch=4, device=device)
        card[label] = [(int(r.status), int(r.iters), r.x.cpu().numpy())
                       for r in svc.solve_many(systems)]
    worst = 0.0
    for label in card:
        for (st, it, x), (cst, cit, cx) in zip(card[label], cpu[label]):
            check(st == cst == 0 and it == cit,
                  f"serve i {label}: card {st}/{it} vs CPU {cst}/{cit}")
            worst = max(worst, float(np.abs(x - cx).max()
                                     / np.abs(cx).max()))
    print(json.dumps({"serve_vs_cpu": {
        "n": n_cpu, "iterations": {k: [c[1] for c in v]
                                   for k, v in card.items()},
        "x_max_rel_diff": worst}}), flush=True)
    check(worst <= 1e-9, f"serve i: x differs from the CPU's by {worst:.3e}")

    # ---- j. COMM_AVOIDING_CONFIG, k. CHEAP_PRECONDITIONER_CONFIG: the
    # batch rebuilds of s-step PCG, OPT_POLYNOMIAL, INEXACT and
    # ITERATIVE_REFINEMENT on the systems of a
    systems = serve_family((n,) * 3, B, seed=1)
    paths["serve_comm_avoiding"] = serve_rebuild_group(
        torch, device, "serve_comm_avoiding", COMM_AVOIDING_CONFIG,
        systems)
    paths["serve_cheap"] = serve_rebuild_group(
        torch, device, "serve_cheap", CHEAP_PRECONDITIONER_CONFIG, systems)
    return paths


def fresh(group):
    """New scipy objects of a group's matrices: each submit hashes its
    pattern, as new matrices from a client do."""
    return [(sp.copy(), b) for sp, b in group]


def serve_pipelined(torch, device, svc, base, got_a):
    """Check l: four groups of serve a's systems (``base``, SERVE_PCG_AMG
    on n^3, f64), with new coefficients from the second on (scaled by
    1.01, 1.02, 1.03), on serve a's service ``svc``: flushed in turn
    (synchronous), then submitted to a started poller (pipelined: the
    poller hands each group to the dispatch worker, and the next group
    pads meanwhile).  A group's max wait is cut short once its last
    request is in (its deadline set to now), so that the poller takes
    whole groups without a wait.  Every ticket reads done() before any
    ``_block_ready``; each group makes one ``_block_ready`` and one
    ``_fetch_host``; no setup or build; x bit for bit the synchronous
    flush's, the first group's serve a's (``got_a``, held to the
    sequential solves there), the last group's iterations and x those
    of its sequential solves; launches of the pipelined groups as
    walked.  Returns (launches, the synchronous results)."""
    from amgx_tpu_torch.serve import service as service_mod

    B = len(base)
    groups = [base] + [[(sp * (1.0 + 0.01 * k), b) for sp, b in base]
                       for k in (1, 2, 3)]
    setups0, compiles0 = svc.metrics.get("setups"), svc.metrics.get(
        "compiles")
    # below max_batch: no submit flushes a group
    svc.max_batch = B + 1
    svc.max_wait_s = 600.0
    sync = []
    t0 = time.perf_counter()
    for g in groups:
        ts = [svc.submit(sp, b) for sp, b in fresh(g)]
        svc.flush()
        sync.append([t.result() for t in ts])
    sync_s = time.perf_counter() - t0
    waits, gets = [], []
    real_block, real_get = service_mod._block_ready, service_mod._fetch_host
    service_mod._block_ready = lambda x: (waits.append(1), real_block(x))[1]
    service_mod._fetch_host = lambda r: (gets.append(1), real_get(r))[1]
    batches0 = svc.metrics.get("batches")
    svc.start(interval_s=0.0005)
    try:
        zero_counts()
        t0 = time.perf_counter()
        tickets = []
        for g in groups:
            if tickets:
                # the group before is taken before this one opens (one
                # pattern: it would join it)
                key = tickets[-1][0]._group_key
                t_w = time.perf_counter()
                while key in svc._groups:
                    check(time.perf_counter() - t_w < 600,
                          "serve l: a group was never taken")
                    time.sleep(0.0001)
            ts = [svc.submit(sp, b) for sp, b in fresh(g)]
            with svc._lock:
                grp = svc._groups.get(ts[0]._group_key)
                if grp is not None:
                    grp.deadline = 0.0
            tickets.append(ts)
        t_w = time.perf_counter()
        while not all(t.done() for ts in tickets for t in ts):
            check(time.perf_counter() - t_w < 600,
                  "serve l: a ticket never read done()")
            time.sleep(0.0001)
        waits_at_done = len(waits)
        # read in reverse order
        got = [[t.result() for t in reversed(ts)][::-1]
               for ts in reversed(tickets)][::-1]
        pipe_s = time.perf_counter() - t0
        launches = batched_counts()
    finally:
        svc.stop()
        svc.max_batch = B
        service_mod._block_ready, service_mod._fetch_host = (real_block,
                                                             real_get)
    entry = svc.cache.peek(tickets[0][0]._group_key[0], svc.cfg_key,
                           np.dtype(np.float64))
    want = add_counts(*[batched_walk(
        entry.solver.precond, it + 1, it + 1, torch.float64)
        for it in (max(int(r.iters) for r in res) for res in got)])
    bitwise = all(torch.equal(a.x, b.x) and int(a.iters) == int(b.iters)
                  for ga, gb in zip(got, sync) for a, b in zip(ga, gb))
    as_a = all(int(r.iters) == g[1] and np.array_equal(r.x.cpu().numpy(),
                                                       g[2])
               for r, g in zip(sync[0], got_a))
    ref, _, _ = serve_seq(device, SERVE_PCG_AMG, groups[3], reuse=True)
    seq = same_as_seq("serve l", [
        (int(r.status), int(r.iters), r.x.cpu().numpy(), None)
        for r in sync[3]], ref)
    rec = {"rows": base[0][0].shape[0], "batch": B, "groups": len(groups),
           "iterations": [[int(r.iters) for r in res] for res in got],
           "synchronous_s": sync_s, "pipelined_s": pipe_s,
           "block_ready_calls": len(waits), "fetch_host_calls": len(gets),
           "block_ready_before_all_done": waits_at_done,
           "batches": svc.metrics.get("batches") - batches0,
           "new_setups": svc.metrics.get("setups") - setups0,
           "new_compiles": svc.metrics.get("compiles") - compiles0,
           "x_bitwise_synchronous": bitwise,
           "first_group_bitwise_serve_a": as_a,
           "last_group_sequential": seq,
           "launches": launches, "walk": want}
    print(json.dumps({"serve_pipelined": rec}), flush=True)
    check(waits_at_done == 0,
          f"serve l: {waits_at_done} waits before every ticket was done")
    check(len(waits) == len(gets) == len(groups) == rec["batches"],
          f"serve l: {len(waits)} _block_ready, {len(gets)} _fetch_host "
          f"for {rec['batches']} batches of {len(groups)} groups")
    check(rec["new_setups"] == 0 and rec["new_compiles"] == 0,
          f"serve l: {rec['new_setups']} setups, {rec['new_compiles']} "
          "builds")
    check(bitwise and as_a, "serve l: x or iterations differ from the "
          "synchronous flush's or serve a's")
    if device == "cuda":
        check(launches == want, f"serve l: launches {launches} != walk "
              f"{want}")
    return launches, sync


def serve_warmboot(svc, base, sync, device):
    """Check m: a fresh service on ``svc``'s store (which exported serve
    a's entry) warm-boots it (``warmboot_restores``), and its first
    group (``base``) is a cache hit with no setup, x bit for bit
    ``svc``'s (``sync``); with the payload corrupted, the entry counts a
    ``warmboot_failures`` and the pattern sets up afresh (iterations
    ``svc``'s, x to rtol 1e-10, serve a's rule)."""
    import os

    from amgx_tpu_torch.serve import BatchedSolveService

    store = svc.store
    prof = svc.metrics.profile.snapshot()["times"]
    mb = sum(os.path.getsize(os.path.join(store.root, f))
             for f in os.listdir(store.root) if f.endswith(".npz")) / 2**20

    def booted():
        new = BatchedSolveService(config=SERVE_PCG_AMG,
                                  max_batch=svc.max_batch, device=device,
                                  store=store.root)
        t0 = time.perf_counter()
        restored = new.warm_boot()
        return new, restored, time.perf_counter() - t0

    def served_as(new, rtol=0.0):
        t0 = time.perf_counter()
        res = new.solve_many(fresh(base))
        secs = time.perf_counter() - t0
        same = all(int(a.iters) == int(b.iters) and float(
            (a.x - b.x).abs().max() / b.x.abs().max()) <= rtol
            for a, b in zip(res, sync))
        return same, secs

    svc2, restored, restore_s = booted()
    same2, first_s = served_as(svc2)
    m2 = svc2.metrics.snapshot()
    del svc2
    for name in os.listdir(store.root):
        if name.endswith(".npz"):
            with open(os.path.join(store.root, name), "r+b") as fh:
                fh.seek(64)
                fh.write(b"rotten")
    svc3, restored3, _ = booted()
    same3, _ = served_as(svc3, rtol=1e-10)
    m3 = svc3.metrics.snapshot()
    rec = {"store_exports": svc.metrics.get("store_exports"),
           "payload_mb": mb, "warmboot_restores": restored,
           "restore_s": restore_s, "setup_s_exporter": prof.get("setup"),
           "first_group_s": first_s,
           "first_group_setups": m2.get("setups", 0),
           "first_group_cache_hits": m2.get("cache_hits", 0),
           "x_bitwise_exporter": same2,
           "corrupt": {"restores": restored3,
                       "warmboot_failures": m3.get("warmboot_failures", 0),
                       "setups": m3.get("setups", 0),
                       "x_as_exporter_1e-10": same3}}
    check(rec["store_exports"] == 1 and restored == 1
          and m2.get("warmboot_restores") == 1,
          f"serve m: exports {rec['store_exports']}, restores {restored}")
    check(rec["first_group_setups"] == 0
          and rec["first_group_cache_hits"] >= 1 and same2,
          f"serve m: the warm-booted group: {rec}")
    check(restored3 == 0 and rec["corrupt"]["warmboot_failures"] == 1
          and rec["corrupt"]["setups"] == 1 and same3,
          f"serve m: the corrupted entry: {rec['corrupt']}")
    return rec


def serve_rebuild_group(torch, device, label, cfg, systems):
    """One group of ``systems`` under ``cfg`` (COMM_AVOIDING_CONFIG or
    CHEAP_PRECONDITIONER_CONFIG) through the service, counts zeroed just
    before it and read just after: one batch, one setup, no fallback,
    launches per batched entry point as walked (:func:`comm_walk`,
    :func:`cheap_walk`), against the card's sequential solves (one
    solver, resetup and solve for each): s-step PCG's iterations within
    one and x within 1.1e-9 of its largest entry; refinement's
    corrections and inner iterations equal, x to rtol 1e-10; every true
    residual at 1e-8.  Returns the launches."""
    import amgx_tpu_torch as T
    from amgx_tpu_torch.serve import COMM_AVOIDING_CONFIG, BatchedSolveService

    comm = cfg == COMM_AVOIDING_CONFIG
    B = len(systems)
    svc = BatchedSolveService(config=cfg, max_batch=B, device=device)
    zero_counts()
    got, first_s = served(svc, systems)
    launches = batched_counts()
    m = svc.metrics.snapshot()
    solver = next(iter(svc.cache._entries.values())).solver
    it_max = max(g[1] for g in got)
    want = comm_walk(solver, it_max) if comm else cheap_walk(solver,
                                                             it_max)
    got_w, warm_s = served(svc, [(sp * 1.01, b) for sp, b in systems])
    # the sequential reference: one solver, resetup and solve each
    ref, inner, fallbacks = [], [], 0
    t0 = time.perf_counter()
    s = A0 = None
    for sp, b in systems:
        if A0 is None:
            A0 = T.SparseMatrix.from_scipy(sp, device=device)
            s = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                                device=device).setup(A0)
        else:
            s.resetup(A0.replace_values(sp.data))
        r = s.solve(b)
        ref.append((int(r.status), int(r.iters), r.x.cpu().numpy()))
        inner.append(getattr(s, "last_inner_iters", None))
        fallbacks = getattr(s, "precision_fallbacks", 0)
    seq_s = time.perf_counter() - t0
    cmp = same_as_seq(label, got, ref, rtol=1.1e-9 if comm else 1e-10,
                      iters_within=1 if comm else 0)
    res = [true_residual(sp, b, g[2]) for (sp, b), g in zip(systems, got)]
    rec = {"n": systems[0][0].shape[0], "batch": B,
           "levels": [(lv.A.n_rows, lv.A.format, str(lv.A.dtype)[6:])
                      for lv in (solver.precond if comm
                                 else solver.inner.precond).levels],
           "iterations": [g[1] for g in got],
           "sequential_iterations": [r[1] for r in ref], **cmp,
           "true_rel_residual_max": max(res),
           "batches": m.get("batches"), "setups": m.get("setups"),
           "compiles": m.get("compiles"),
           "fallback_solves": m.get("fallback_solves", 0),
           "host_syncs": m.get("host_syncs"), "launches": launches,
           "walk": want,
           "warm_statuses": sorted({g[0] for g in got_w}),
           "per_system_s": {"batched_first_flush": first_s["s"] / B,
                            "batched_warm_flush": warm_s["s"] / B,
                            "sequential": seq_s / B},
           "first_flush_s": first_s, "warm_flush_s": warm_s}
    if not comm:
        # corrections x (the unmonitored inner PCG's iterations)
        per = solver.inner.max_iters * solver.inner.iterations_scale
        rec.update({"inner_iterations": [g[1] * per for g in got],
                    "sequential_inner_iterations": inner,
                    "sequential_precision_fallbacks": fallbacks})
    print(json.dumps({label: rec}), flush=True)
    check(m.get("batches") == 1 and m.get("setups") == 1
          and m.get("fallback_solves", 0) == 0,
          f"{label}: batches {m.get('batches')}, setups {m.get('setups')}, "
          f"fallback {m.get('fallback_solves')}")
    check(max(res) <= 1e-8, f"{label}: true residual {max(res):.3e}")
    check(got_w and all(g[0] == 0 for g in got_w),
          f"{label}: the warm flush's statuses")
    if not comm:
        check(rec["inner_iterations"] == inner,
              f"{label}: inner iterations {rec['inner_iterations']} vs "
              f"sequential {inner}")
    if device == "cuda":
        check(launches == want, f"{label}: launches {launches} != walk "
              f"{want}")
    return launches


SESSION_N = 64
SESSION_B = 16
SESSION_STEPS = 8
SESSION_DT = 0.05
SESSION_CPU_N = 24
# SERVE_PCG_AMG to an absolute 1e-6: under RELATIVE_INI each step is
# held to its own initial residual, and a warm start cannot save an
# iteration (tests/test_sessions.py's time-stepping config is ABSOLUTE
# for the same reason)
SESSION_CFG = SERVE_PCG_AMG.replace('"RELATIVE_INI"', '"ABSOLUTE"').replace(
    '"tolerance": 1e-8', '"tolerance": 1e-6')


class HeatStream:
    """Implicit-Euler steps of du/dt = div(kappa grad u) + 1 on an n^3
    grid for ``count`` sessions: step k of session s solves (I / dt +
    L(kappa_sk)) u_k = u_{k-1} / dt + 1, with kappa_sk = exp(0.5 xi_s +
    0.05 eta_sk), xi_s a field of session s and eta_sk drawn anew each
    step (i.i.d. N(0, 1) per cell, from ``default_rng``), u_{-1} a
    normal draw.  Every operator has the pattern of
    ``poisson_3d_7pt(n)``."""

    def __init__(self, n, count, dt=SESSION_DT, seed=0):
        self.n, self.dt, self.seed = n, dt, seed
        self.base = diffusion_3d(np.ones((n, n, n)))
        N = self.base.shape[0]
        rows = np.repeat(np.arange(N), np.diff(self.base.indptr))
        self.dpos = np.flatnonzero(rows == self.base.indices)
        self.xi = [np.random.default_rng(seed * 7919 + s).standard_normal(
            (n, n, n)) for s in range(count)]
        self.u0 = np.random.default_rng(seed + 1).standard_normal(N)
        # each (session, step)'s values, made once: the phase streams
        # the same steps several times (read-only arrays)
        self._values: dict = {}

    def values(self, s, k):
        v = self._values.get((s, k))
        if v is None:
            eta = np.random.default_rng(
                (self.seed, s, k)).standard_normal((self.n,) * 3)
            v = diffusion_3d(np.exp(0.5 * self.xi[s] + 0.05 * eta)).data
            v[self.dpos] += 1.0 / self.dt
            v.flags.writeable = False
            self._values[(s, k)] = v
        return v

    def rhs(self, x_prev):
        return (self.u0 if x_prev is None else x_prev) / self.dt + 1.0

    def session_rhs(self, sess):
        return self.rhs(sess.last_x)


def heat_sessions(device, stream, steps, cfg=SESSION_CFG, warm=True,
                  svc=None, after_step=None, deadline_s=None):
    """``steps`` lockstep steps of one session per field of ``stream``
    through a SessionManager (on ``svc``, else a new service); with
    ``warm`` False every step starts from zeros.  Returns (per step
    {"results": [(status, iterations)], "host_s": seconds of step_all
    and the reads}, the service, the manager, its pattern hashes after
    the opens).  ``after_step(k, values, x_prev, x0, results)`` sees
    each step's inputs and SolveResults, outside the timed window."""
    from amgx_tpu_torch.serve import BatchedSolveService
    from amgx_tpu_torch.sessions import SessionManager

    B = len(stream.xi)
    if svc is None:
        svc = BatchedSolveService(config=cfg, max_batch=B, device=device)
    mgr = SessionManager(svc)
    sessions = [mgr.open(stream.base, session_id=f"heat{i}",
                         deadline_s=deadline_s) for i in range(B)]
    hashes = svc.metrics.get("pattern_hashes")
    out = []
    for k in range(steps):
        vals = [stream.values(i, k) for i in range(B)]
        x_prev = [s.last_x for s in sessions]
        if not warm:
            for s in sessions:
                s._last_status = None
        x0 = [s.last_x if s.last_status == 0 else None for s in sessions]
        t0 = time.perf_counter()
        tickets = mgr.step_all([(s, v, stream.session_rhs)
                                for s, v in zip(sessions, vals)])
        res = [t.result() for t in tickets]
        secs = time.perf_counter() - t0
        out.append({"results": [(int(r.status), int(r.iters)) for r in res],
                    "host_s": secs})
        if after_step is not None:
            after_step(k, vals, x_prev, x0, res)
        del vals, x_prev, x0, res, tickets
    return out, svc, mgr, hashes


def heat_stream_results(device, n, count=4, steps=3):
    """The warm heat stream of ``count`` sessions at ``n``^3 on
    ``device``: [step][session] (status, iterations, x)."""
    xs = []
    heat_sessions(device, HeatStream(n, count), steps, after_step=lambda k,
                  v, xp, x0, res: xs.append([(int(r.status), int(r.iters),
                                              r.x.cpu().numpy())
                                             for r in res]))
    return xs


def session_cpu_side(n):
    """The CPU port's side of the sessions phase (check e)."""
    import amgx_tpu_torch  # noqa: F401

    return heat_stream_results("cpu", n)


def session_phase(torch, device="cuda", n=SESSION_N, B=SESSION_B,
                  steps=SESSION_STEPS, n_cpu=SESSION_CPU_N):
    """Streaming solve sessions (module docstring, phase 22).  Returns
    {path: launches per batched entry point}."""
    import amgx_tpu_torch as T

    # ---- c. session_heat: B sessions of n^3 in lockstep, counts zeroed
    # just before the stream and read just after; each step against the
    # sequential solve from the same x0 (one solver set up on the first
    # step's values, resetup and solve: unbatched launches), outside the
    # stream's clock
    stream = HeatStream(n, B)
    ref = {"seq": None, "A0": None, "it_diff": 0, "worst": 0.0, "s": 0.0,
           "digests": []}

    def sequential(k, vals, x_prev, x0, res):
        ref["digests"].append(x_digests(res))
        if ref["seq"] is None:
            ref["A0"] = T.SparseMatrix.from_csr(
                stream.base.indptr, stream.base.indices, vals[0],
                device=device)
            ref["seq"] = T.create_solver(
                T.AMGConfig.from_string(SESSION_CFG), "default",
                device=device).setup(ref["A0"])
        seq = ref["seq"]
        for i, r in enumerate(res):
            t0 = time.perf_counter()
            seq.resetup(ref["A0"].replace_values(vals[i]))
            rr = seq.solve(stream.rhs(x_prev[i]), x0=x0[i])
            ref["s"] += time.perf_counter() - t0
            x, rx = r.x.cpu().numpy(), rr.x.cpu().numpy()
            check(int(r.status) == int(rr.status) == 0,
                  f"session_heat: status {r.status} vs sequential "
                  f"{rr.status}")
            ref["it_diff"] = max(ref["it_diff"],
                                 abs(int(r.iters) - int(rr.iters)))
            ref["worst"] = max(ref["worst"], float(
                np.abs(x - rx).max() / np.abs(rx).max()))

    import shutil

    from amgx_tpu_torch.serve import BatchedSolveService

    # the service keeps a store (checks c and e of the async slice)
    folder = store_dir()
    svc = BatchedSolveService(config=SESSION_CFG, max_batch=B,
                              device=device, store=folder)
    zero_counts()
    warm, svc, mgr, h_open = heat_sessions(device, stream, steps, svc=svc,
                                           after_step=sequential)
    launches = batched_counts()
    m = svc.metrics.snapshot()
    entry = next(iter(svc.cache._entries.values()))
    amg = entry.solver.precond
    want = add_counts(*[batched_walk(
        amg, it + 1, it + 1, torch.float64) for it in (
            max(r[1] for r in o["results"]) for o in warm)])
    # the same stream from zero guesses
    cold, _, _, _ = heat_sessions(device, stream, steps, warm=False,
                                  svc=svc)
    total_warm = sum(r[1] for o in warm for r in o["results"])
    total_cold = sum(r[1] for o in cold for r in o["results"])
    host_s = sum(o["host_s"] for o in warm)
    rec = {"n": n, "sessions": B, "steps": steps, "dt": SESSION_DT,
           "levels": [(lv.A.n_rows, lv.A.format) for lv in amg.levels],
           "iterations": [[r[1] for r in o["results"]] for o in warm],
           "zero_guess_iterations": [[r[1] for r in o["results"]]
                                     for o in cold],
           "total_iterations": total_warm,
           "zero_guess_total_iterations": total_cold,
           "max_iterations_diff_sequential": ref["it_diff"],
           "x_max_rel_diff_sequential": ref["worst"],
           "batches": m.get("batches"), "setups": m.get("setups"),
           "compiles": m.get("compiles"),
           "pattern_hashes_after_open": m.get("pattern_hashes") - h_open,
           "host_syncs": m.get("host_syncs"),
           "warm_starts": mgr.counters().get("warm_starts_total", 0),
           "launches": launches, "walk": want,
           "per_system_step_s": {
               "session": host_s / (B * steps),
               "sequential": ref["s"] / (B * steps),
               "steps": [o["host_s"] / B for o in warm]},
           "resetup_overlap_s": mgr.resetup_overlap_s}
    print(json.dumps({"session_heat": rec}), flush=True)
    check(m.get("batches") == steps and m.get("setups") == 1
          and m.get("compiles") == 1,
          f"session_heat: batches {m.get('batches')}, setups "
          f"{m.get('setups')}, compiles {m.get('compiles')}")
    check(rec["pattern_hashes_after_open"] == 0,
          f"session_heat: {rec['pattern_hashes_after_open']} pattern "
          "hashes after open")
    check(ref["it_diff"] == 0 and ref["worst"] <= 1e-10,
          f"session_heat: iterations differ by {ref['it_diff']}, x by "
          f"{ref['worst']:.3e} from the sequential solves")
    check(total_warm < total_cold,
          f"session_heat: {total_warm} iterations warm, {total_cold} from "
          "zero guesses")
    if device == "cuda":
        check(launches == want, f"session_heat: launches {launches} != "
              f"walk {want}")
    paths = {"session_heat": launches}
    del warm, cold, mgr, entry, amg

    # ---- c (async). the same stream over the service with its poller
    # started; e. drained, then restored on a fresh service and manager
    try:
        print(json.dumps({"session_async": session_async(
            device, stream, steps, ref["digests"], svc)}), flush=True)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    del ref, svc

    # ---- d. session_capi: a dDDI session through the C API, 3 steps,
    # against the Python session of the same stream
    print(json.dumps({"session_capi": session_capi(device, stream)}),
          flush=True)

    # ---- e. the card against the CPU port at n_cpu^3
    cpu = CPU.get(session_cpu_side, n_cpu)
    xs = heat_stream_results(device, n_cpu)
    worst, it_eq = 0.0, True
    for o, c in zip(xs, cpu):
        for (st, it, x), (cst, cit, cx) in zip(o, c):
            it_eq = it_eq and st == cst == 0 and it == cit
            worst = max(worst, float(np.abs(x - cx).max()
                                     / np.abs(cx).max()))
    print(json.dumps({"session_vs_cpu": {
        "n": n_cpu, "iterations": [[r[1] for r in o] for o in xs],
        "x_max_rel_diff": worst}}), flush=True)
    check(len(xs) == len(cpu) == 3 and it_eq and worst <= 1e-9,
          f"session e: card against CPU: iterations equal {it_eq}, x "
          f"{worst:.3e}")
    return paths


def x_digests(results):
    """A digest of each result's x bytes (bit-for-bit comparisons of
    whole streams without holding their solutions)."""
    import hashlib

    return [hashlib.blake2b(np.ascontiguousarray(
        r.x.cpu().numpy()).tobytes(), digest_size=16).hexdigest()
        for r in results]


SESSION_DEADLINE_S = 600.0


def session_async(device, stream, steps, digests, svc):
    """Checks c and e of the async slice: ``stream`` again over ``svc``
    (which has a store) with its poller started, so each step group's
    loop runs on the dispatch worker: prestage overlaps the previous
    step's running loop (``resetup_overlap_s`` > 0), every step's x
    bit for bit the run without the poller (``digests``); then
    ``drain()``, and on a fresh service (``warm_boot()``) and manager
    ``restore()`` of every session: step index, deadline and last x bit
    for bit, and the next step a cache hit with no setup, x bit for bit
    the drained stream's own next step."""
    from amgx_tpu_torch.serve import BatchedSolveService
    from amgx_tpu_torch.sessions import SessionManager

    B = len(stream.xi)
    # over the started service step_all hands each step group to the
    # dispatch worker and returns at its hand-over; the poller must not
    # take a group that is still filling
    svc.max_wait_s = 60.0
    svc.start(interval_s=0.001)
    try:
        # each step's results read only by the next step's commits, so
        # that its prestage runs while the step before is still running
        t0 = time.perf_counter()
        mgr = SessionManager(svc)
        sessions = [mgr.open(stream.base, session_id=f"heat{i}",
                             deadline_s=SESSION_DEADLINE_S)
                    for i in range(B)]
        stepped = [mgr.step_all([(s, stream.values(i, k),
                                  stream.session_rhs)
                                 for i, s in enumerate(sessions)])
                   for k in range(steps)]
        for s in sessions:
            s.finish()
        stream_s = time.perf_counter() - t0
        got = [x_digests([t.result() for t in ts]) for ts in stepped]
        del stepped
        t0 = time.perf_counter()
        report = mgr.drain()
        drain_s = time.perf_counter() - t0
    finally:
        svc.stop()
    sessions = mgr.sessions()
    saved = {s.session_id: (s.step_idx, s.last_x.copy()) for s in sessions}
    svc2 = BatchedSolveService(config=SESSION_CFG, max_batch=B,
                               device=device, store=svc.store)
    t0 = time.perf_counter()
    restored = svc2.warm_boot()
    mgr2 = SessionManager(svc2)
    back = [mgr2.restore(s.session_id) for s in sessions]
    restore_s = time.perf_counter() - t0
    survived = all(
        b.step_idx == saved[b.session_id][0] == steps
        and b.deadline_s == SESSION_DEADLINE_S
        and np.array_equal(b.last_x, saved[b.session_id][1]) for b in back)
    # the next step, restored and drained
    vals = [stream.values(i, steps) for i in range(B)]
    nxt2 = [t.result() for t in mgr2.step_all(
        [(s, v, stream.session_rhs) for s, v in zip(back, vals)])]
    nxt = [t.result() for t in mgr.step_all(
        [(s, v, stream.session_rhs) for s, v in zip(sessions, vals)])]
    m2 = svc2.metrics.snapshot()
    rec = {"sessions": B, "steps": steps, "stream_s": stream_s,
           "resetup_overlap_s": mgr.resetup_overlap_s,
           "resetup_s": mgr.resetup_s,
           "x_bitwise_plain_service": got == digests,
           "drain": report, "drain_s": drain_s,
           "warmboot_restores": restored, "restore_s": restore_s,
           "restored_state_bitwise": survived,
           "next_step_setups": m2.get("setups", 0),
           "next_step_cache_hits": m2.get("cache_hits", 0),
           "next_step_x_bitwise": x_digests(nxt2) == x_digests(nxt),
           "next_step_iterations": [int(r.iters) for r in nxt2]}
    check(rec["resetup_overlap_s"] > 0.0,
          "session c: no prestage overlapped a step in flight")
    check(rec["x_bitwise_plain_service"],
          "session c: a step's x differs from the plain service's")
    check(report["sessions_saved"] == B and report["entries_exported"] >= 1
          and restored >= 1,
          f"session e: drain {report}, warm boot {restored}")
    check(survived, "session e: a restored session's step, deadline or x "
          "differs from the drained one's")
    check(rec["next_step_setups"] == 0 and rec["next_step_cache_hits"] >= 1
          and rec["next_step_x_bitwise"]
          and all(int(r.status) == 0 for r in nxt2),
          f"session e: the restored step: {rec}")
    return rec


def session_capi(device, stream, steps=3):
    """Check d: create, ``steps`` steps (``matrix_replace_coefficients``,
    the rhs, ``solver_session_step``, ``_sync``) and destroy a session
    of ``stream``'s first field through ``amgx_tpu_torch.api.capi`` in
    dDDI (hDDI on the CPU): every RC 0, statuses and iterations those
    of a Python session of the same steps, x bit for bit."""
    from amgx_tpu_torch.api import capi as C
    from amgx_tpu_torch.serve import BatchedSolveService
    from amgx_tpu_torch.sessions import SessionManager

    sp = stream.base
    N = sp.shape[0]
    mode = capi_mode("DDI", device)
    rcs = [C.initialize()]
    c = C.config_create(SESSION_CFG)
    r = C.resources_create_simple(c)
    mtx, rhs, sol = (C.matrix_create(r, mode), C.vector_create(r, mode),
                     C.vector_create(r, mode))
    rcs.append(C.matrix_upload_all(mtx, N, sp.nnz, 1, 1, sp.indptr,
                                   sp.indices, stream.values(0, 0), None))
    slv = C.solver_create(r, mode, c)
    sh = C.solver_session_create(slv, mtx)
    got, x = [], None
    t0 = time.perf_counter()
    for k in range(steps):
        rcs += [C.matrix_replace_coefficients(mtx, N, sp.nnz,
                                              stream.values(0, k)),
                C.vector_upload(rhs, N, 1, stream.rhs(x)),
                C.solver_session_step(sh, mtx, rhs, sol),
                C.solver_session_sync(sh)]
        x = C.vector_download(sol)
        got.append((C.solver_session_get_status(sh),
                    C.solver_session_get_iterations_number(sh), x))
    capi_s = time.perf_counter() - t0
    # the session saved into a store: RC 0 and one entry written
    import os
    import shutil

    folder = store_dir()
    try:
        rcs.append(C.solver_session_save(sh, folder))
        saved_files = sorted(os.listdir(folder))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    rcs += [C.solver_session_destroy(sh), C.solver_destroy(slv),
            C.matrix_destroy(mtx), C.vector_destroy(rhs),
            C.vector_destroy(sol)]
    mgr = SessionManager(BatchedSolveService(config=SESSION_CFG,
                                             device=device))
    sess = mgr.open(sp)
    py = []
    for k in range(steps):
        t = sess.step(stream.values(0, k), stream.session_rhs)
        mgr.flush()
        res = t.result()
        py.append((int(res.status), int(res.iters), res.x.cpu().numpy()))
    bitwise = all(np.array_equal(a[2], b[2]) for a, b in zip(got, py))
    rec = {"mode": mode, "rcs_all_zero": not any(rcs),
           "session_save_files": saved_files,
           "statuses": [g[0] for g in got],
           "iterations": [g[1] for g in got],
           "python_statuses": [p[0] for p in py],
           "python_iterations": [p[1] for p in py],
           "x_bitwise_python": bitwise, "capi_s": capi_s}
    check(not any(rcs), f"session_capi: RCs {rcs}")
    check(len(saved_files) == 2,
          f"session_capi: the save wrote {saved_files}")
    check([g[:2] for g in got] == [p[:2] for p in py]
          and all(g[0] == 0 for g in got),
          f"session_capi: {[g[:2] for g in got]} vs the Python session's "
          f"{[p[:2] for p in py]}")
    check(bitwise, "session_capi: x differs from the Python session's")
    return rec


def blockdiag_csr(torch, ro, ci, vals, m):
    """The block-diagonal CSR (B n x B m) of B instances of one CSR
    structure (``ro``, ``ci`` host arrays, ``vals`` (B, nnz) or (nnz,)
    shared, on the card): the library's batched product of the same
    work, one ``torch.mv``."""
    n, nnz = ro.shape[0] - 1, ci.shape[0]
    B = vals.shape[0]
    ro_b = (np.asarray(ro, np.int64)[None, :-1] + nnz * np.arange(B)[:, None])
    ro_b = np.append(ro_b.reshape(-1), B * nnz)
    ci_b = (np.asarray(ci, np.int64)[None, :] + m * np.arange(B)[:, None])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(ro_b).cuda(), torch.from_numpy(ci_b.reshape(-1)
                                                            ).cuda(),
            vals.reshape(-1), size=(B * n, B * m))


def batched_case(torch, timer, peaks, name, label, run, plain, instance,
                 lib, nbytes, nops, dtype, launches=None, extra=None):
    """One batched entry point: y held bit for bit, instance by
    instance, to the unbatched entry point (``instance(i)``) and within
    TOL to its plain batched version; timed as :func:`kernel_case`
    times (cold, warm, device), with the plain version and ``lib`` (a
    block-diagonal CSR ``torch.mv`` of the same work; None where torch
    has none for the dtype)."""
    y, yp = run(), plain()
    torch.cuda.synchronize()
    check(y.shape == yp.shape, f"{label}: shape {y.shape} vs {yp.shape}")
    check(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
    bitwise = all(torch.equal(y[i], instance(i)) for i in range(y.shape[0]))
    check(bitwise, f"{label}: an instance differs from the unbatched entry")
    err, rel = rel_err(y, yp)
    tol = TOL[str(dtype).replace("torch.", "")]
    check(rel <= tol, f"{label}: kernel vs plain rel err {rel:.3e} > {tol}")
    yl = lib() if lib is not None else None
    torch.cuda.synchronize()
    kind = "f64" if dtype in (torch.float64, torch.complex128) else "f32"
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = nops / peaks[kind] * 1e3
    rec = {
        "case": label, "kernel": name, "dtype": kind, "batch": y.shape[0],
        "bitwise_unbatched": bitwise, "max_abs_err": err,
        "max_rel_err": rel, "tol": tol,
        "library_max_abs_err": (None if yl is None else float(
            (yl.reshape(y.shape) - yp).abs().max())),
        "kernel_ms": timer(run), "kernel_ms_warm_l2": timer(run, flush=False),
        "kernel_device_ms": timer.device(run, ACTIVITY.get(
            name.rsplit("_", 1)[0], ACTIVITY[name.split("_batched")[0]])),
        "plain_ms": timer(plain),
        "library_ms": None if lib is None else timer(lib),
        "bytes": int(nbytes), "ops": int(nops),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        **(extra or {}),
    }
    rec["share"] = rec["bound_ms"] / rec["kernel_ms"]
    if "stream_bound_ms" in rec:
        rec["stream_share"] = rec["stream_bound_ms"] / rec["kernel_ms"]
    print(json.dumps(rec), flush=True)
    return rec


def serve_kernel_cases(torch, timer, peaks, rng, n=SERVE_N, B=SERVE_B):
    """The six batched entry points at the serve paths' shapes: the n^3
    level-0 A in DIA (f64 and f32, batched planes), the SIZE_8 level-0
    R and P (slot-major ELL, f64 and f32, shared values) and the
    irregular template's A in sliced ELL (f64 and f32, batched values;
    f64 shared values too) and in slot-major ELL (the sliced entry's
    "before", on the same values), B instances each.  The bound counts the shared structure
    once and the batched values, x and y B times, the stored entries of
    the pattern only; ``stream_bound_ms`` of a sliced case counts every
    slot of the layout, the bucket's filler included."""
    import dataclasses

    import scipy.sparse as sps

    from amgx_tpu_torch.amg.aggregation import geo_aggregate
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.poisson import poisson_scipy
    from amgx_tpu_torch.ops import dia, ell
    from amgx_tpu_torch.serve.bucketing import pad_pattern

    recs = []
    base = poisson_scipy((n,) * 3).tocsr()
    nf = base.shape[0]
    for dt in (torch.float64, torch.float32):
        isz = 8 if dt == torch.float64 else 4
        A = SparseMatrix.from_scipy(base, device="cuda",
                                    accel_formats=("dia",))
        A = A.astype(dt)
        jit = torch.from_numpy(1.0 + 0.08 * rng.standard_normal(
            (B, A.nnz))).cuda().to(dt)
        Ab = A.replace_values_batched(A.values * jit)
        x = torch.from_numpy(rng.standard_normal((B, nf))).cuda().to(dt)
        nd = len(A.dia_offsets)
        name = f"dia_spmv_batched_{'f64' if isz == 8 else 'f32'}"
        lib = blockdiag_csr(torch, base.indptr, base.indices, Ab.values, nf)
        recs.append(batched_case(
            torch, timer, peaks, name,
            f"serve {name} level0 A B{B} {n}^3",
            lambda: dia.dia_spmv_batched(Ab.dia_vals, Ab.dia_offsets, x),
            lambda: dia.dia_spmv_batched_plain(Ab.dia_vals, Ab.dia_offsets,
                                               x),
            lambda i: dia.dia_spmv(Ab.dia_vals[i].contiguous(),
                                   Ab.dia_offsets, x[i]),
            lambda: torch.mv(lib, x.reshape(-1)),
            nbytes=isz * B * (base.nnz + 2 * nf) + 4 * nd,
            nops=2 * B * base.nnz, dtype=dt,
            extra={"diagonals": nd, "nonzeros": base.nnz}))
        del A, Ab, x, lib, jit
    # SIZE_8 transfers of the n^3 hierarchy (geometric 2x2x2 aggregates),
    # values shared by every instance
    agg = geo_aggregate(n, n, n, 3)
    nc = int(agg.max()) + 1
    P = sps.csr_matrix((np.ones(nf), (np.arange(nf), agg)), shape=(nf, nc))
    for dt, (label, T_) in itertools.product(
            (torch.float64, torch.float32), (("R", P.T.tocsr()), ("P", P))):
        isz = 8 if dt == torch.float64 else 4
        name = f"ell_spmv_batched_{'f64' if isz == 8 else 'f32'}"
        M = SparseMatrix.from_scipy(T_, device="cuda").astype(dt)
        check(M.format == "ELL" and M.sell is None,
              f"SIZE_8 {label}: {M.format}, sliced {M.sell is not None}")
        rows, cols = T_.shape
        x = torch.from_numpy(rng.standard_normal((B, cols))).cuda().to(dt)
        w = int(M.ell_cols.shape[0])
        lib = blockdiag_csr(torch, T_.indptr, T_.indices,
                            M.values.expand(B, -1).contiguous(), cols)
        recs.append(batched_case(
            torch, timer, peaks, name,
            f"serve {name} level0 {label} {rows}x{cols} w={w} shared B{B}",
            lambda: ell.ell_spmv_batched(M.ell_cols, M.ell_vals, x),
            lambda: ell.ell_spmv_batched_plain(M.ell_cols, M.ell_vals, x),
            lambda i: ell.ell_spmv(M.ell_cols, M.ell_vals, x[i]),
            lambda: torch.mv(lib, x.reshape(-1)),
            nbytes=(4 + isz) * T_.nnz + isz * B * (rows + cols),
            nops=2 * B * T_.nnz, dtype=dt,
            extra={"width": w, "shared_values": True}))
        del M, x, lib
    # the irregular pattern's padded template, batched values: the
    # sliced entry the serve paths take, the slot-major one beside it
    irr = irregular_poisson(n)
    pat = pad_pattern(irr.indptr, irr.indices, irr.shape[0])
    for dt in (torch.float64, torch.float32):
        isz = 8 if dt == torch.float64 else 4
        kind = "f64" if isz == 8 else "f32"
        npdt = np.float64 if isz == 8 else np.float32
        A = pat.template_matrix(irr.data, npdt, accel_formats=("ell",),
                                device="cuda")
        check(A.format == "ELL" and A.sell is not None,
              f"irregular template {A.format}, sliced "
              f"{A.sell is not None}")
        vals = np.stack([pat.embed_values(
            irr.data * (1.0 + 0.05 * rng.standard_normal(irr.nnz)), npdt)
            for _ in range(B)])
        Ab = A.replace_values_batched(torch.from_numpy(vals).cuda())
        x = torch.from_numpy(rng.standard_normal((B, pat.nb))).cuda().to(dt)
        w = int(A.ell_cols.shape[0])
        S = Ab.sell
        lib = blockdiag_csr(torch, pat.row_offsets, pat.col_indices,
                            Ab.values, pat.nb)
        # the layout's own stream: every stored slot's value B times, its
        # column, the row permutation and the slice headers once
        stream = (isz * B * (S.stored + 2 * pat.nb) + 4 * S.stored
                  + 4 * pat.nb + 12 * S.n_slices)
        layout = {"nonzeros": irr.nnz, "stored_slots": S.stored,
                  "slices": S.n_slices, "sigma": S.sigma, "lanes": S.lanes,
                  "stream_bytes": stream,
                  "stream_bound_ms": stream / peaks["bw"] * 1e3}
        name = f"sell_spmv_batched_{kind}"
        recs.append(batched_case(
            torch, timer, peaks, name,
            f"serve {name} irregular A {pat.nb} B{B}",
            lambda: ell.sell_spmv_batched(S, x),
            lambda: ell.sell_spmv_batched_plain(S, x),
            lambda i: ell.sell_spmv(dataclasses.replace(S, vals=S.vals[i]),
                                    x[i]),
            lambda: torch.mv(lib, x.reshape(-1)),
            nbytes=4 * irr.nnz + isz * B * (irr.nnz + 2 * pat.nb),
            nops=2 * B * irr.nnz, dtype=dt, extra=layout))
        if dt == torch.float64:
            # one set of values shared by every instance
            lib_s = blockdiag_csr(torch, pat.row_offsets, pat.col_indices,
                                  A.values.expand(B, -1).contiguous(),
                                  pat.nb)
            stream_s = ((isz + 4) * S.stored + isz * B * 2 * pat.nb
                        + 4 * pat.nb + 12 * S.n_slices)
            recs.append(batched_case(
                torch, timer, peaks, name,
                f"serve {name} shared irregular A {pat.nb} B{B}",
                lambda: ell.sell_spmv_batched(A.sell, x),
                lambda: ell.sell_spmv_batched_plain(A.sell, x),
                lambda i: ell.sell_spmv(A.sell, x[i]),
                lambda: torch.mv(lib_s, x.reshape(-1)),
                nbytes=(4 + isz) * irr.nnz + isz * B * 2 * pat.nb,
                nops=2 * B * irr.nnz, dtype=dt,
                extra={**layout, "shared_values": True,
                       "stream_bytes": stream_s,
                       "stream_bound_ms": stream_s / peaks["bw"] * 1e3}))
            # the slot-major entry on the same shared values, beside it
            slot = f"ell_spmv_batched_{kind}"
            recs.append(batched_case(
                torch, timer, peaks, slot,
                f"serve {slot} shared irregular A {pat.nb} w={w} B{B}",
                lambda: ell.ell_spmv_batched(A.ell_cols, A.ell_vals, x),
                lambda: ell.ell_spmv_batched_plain(A.ell_cols, A.ell_vals,
                                                   x),
                lambda i: ell.ell_spmv(A.ell_cols, A.ell_vals, x[i]),
                lambda: torch.mv(lib_s, x.reshape(-1)),
                nbytes=(4 + isz) * irr.nnz + isz * B * 2 * pat.nb,
                nops=2 * B * irr.nnz, dtype=dt,
                extra={"width": w, "nonzeros": irr.nnz,
                       "padded_slots": w * pat.nb, "shared_values": True}))
            del lib_s
        # the slot-major values of the batch (a sliced batched view
        # keeps none): each instance's replace_values
        slot_vals = torch.stack([A.replace_values(Ab.values[i]).ell_vals
                                 for i in range(B)])
        name = f"ell_spmv_batched_{kind}"
        recs.append(batched_case(
            torch, timer, peaks, name,
            f"serve {name} irregular A {pat.nb} w={w} B{B}",
            lambda: ell.ell_spmv_batched(A.ell_cols, slot_vals, x),
            lambda: ell.ell_spmv_batched_plain(A.ell_cols, slot_vals, x),
            lambda i: ell.ell_spmv(A.ell_cols, slot_vals[i].contiguous(),
                                   x[i]),
            lambda: torch.mv(lib, x.reshape(-1)),
            nbytes=4 * irr.nnz + isz * B * (irr.nnz + 2 * pat.nb),
            nops=2 * B * irr.nnz, dtype=dt,
            extra={"width": w, "nonzeros": irr.nnz,
                   "padded_slots": w * pat.nb}))
        del A, Ab, S, x, lib, vals, slot_vals
    return recs


# ---------------------------------------------------------------------
# faults_telemetry: fault injection, solve retries and telemetry on the
# card

# the bench config with one retry: a FAILED or DIVERGED solve re-solves
# from a zero guess with a fresh build
RETRY_CFG = BENCH_CFG.replace('"monitor_residual": 1,',
                              '"monitor_residual": 1, "solve_retries": 1,',
                              1)
RAISE_CFG = BENCH_CFG.replace('"coarse_solver": "DENSE_LU_SOLVER",',
                              '"coarse_solver": "DENSE_LU_SOLVER",'
                              ' "dense_lu_zero_pivot": "RAISE",')
FT_N = 64
FT_B = 16


def zero_pivot_cpu(n):
    """The CPU port's bench solve at ``n``^3 f64 with
    ``coarse_lu_zero_pivot`` fired at setup (REGULARIZE): status,
    iterations, x."""
    from amgx_tpu_torch.core import faults

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with faults.inject("coarse_lu_zero_pivot"):
            _, r, _, _, _ = solve_on("cpu", BENCH_CFG, n, np.float64)
    return {"status": int(r.status), "iterations": int(r.iters),
            "x": r.x.numpy()}


def span_chains(spans):
    """({trace id: [span]}, the flush_group spans) of a span ring."""
    chains = {}
    for s in spans:
        if s["trace_id"] is not None:
            chains.setdefault(s["trace_id"], []).append(s)
    return chains, [s for s in spans if s["name"] == "flush_group"]


PROM_SAMPLE = (r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
               r"(\{[a-zA-Z0-9_]+=\"(?:[^\"\\]|\\.)*\""
               r"(,[a-zA-Z0-9_]+=\"(?:[^\"\\]|\\.)*\")*\})?"
               r" (-?[0-9.e+-]+|NaN)$")


def prom_grammar(text):
    """Family names of a Prometheus page whose every line parses and
    whose every sample's family has HELP and TYPE (the grammar check of
    the JAX package's telemetry tests); raises on the first defect."""
    import re

    sample = re.compile(PROM_SAMPLE)
    names, helped, typed = set(), set(), set()
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            helped.add(line.split()[2])
        elif line.startswith("# TYPE "):
            parts = line.split()
            check(parts[3] in ("counter", "gauge", "summary"),
                  f"prometheus type {parts[3]}")
            typed.add(parts[2])
        else:
            m = sample.match(line)
            check(m is not None, f"unparseable exposition line {line!r}")
            names.add(m.group(1))
    for n in names:
        fam = next((f for f in (n, n[:-6], n[:-4]) if f in typed), None)
        check(fam is not None and fam in helped,
              f"sample {n} without HELP / TYPE")
    return names


def cycle_ms(torch, amg, b, reps=5):
    """One warm cycle of ``amg`` on ``b``, ms (CUDA events)."""
    cyc = amg.make_cycle()
    params = amg.apply_params()
    x = torch.zeros_like(b)
    cyc(params, b, x)
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        cyc(params, b, x)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def faults_phase(torch, ref=None, device="cuda", n=SLICE_N, n_small=FT_N,
                 B=FT_B):
    """Fault injection, solve retries and telemetry on the card (module
    docstring, phase 23); ``ref``: the bench_pcg phase's results, whose
    x phase a's clean solve equals bit for bit.  Returns the launches of
    the main path (a)."""
    import ctypes

    import amgx_tpu_torch as T
    from amgx_tpu_torch import telemetry
    from amgx_tpu_torch.api import capi as C
    from amgx_tpu_torch.core import faults
    from amgx_tpu_torch.core.errors import SingularDiagonalError
    from amgx_tpu_torch.core.profiling import profile_cycle
    from amgx_tpu_torch.io.poisson import (
        poisson_3d_7pt,
        poisson_rhs,
        poisson_scipy,
    )
    from amgx_tpu_torch.ops import kernels
    from amgx_tpu_torch.serve import BatchedSolveService
    from amgx_tpu_torch.telemetry import tracing

    on_card = device == "cuda"
    faults.disarm()
    faults.reset_counters()
    # ---- a. the main path: the bench config with a retry, smoother_nan
    # fired once; counts zeroed just before setup, read after the solve
    A = poisson_3d_7pt(n, dtype=np.float32, device=device)
    b = poisson_rhs(A.n_rows, dtype=np.float32)
    zero_counts()
    s = T.create_solver(T.AMGConfig.from_string(RETRY_CFG), "default",
                        device=device).setup(A)
    with faults.inject("smoother_nan"):
        r = s.solve(b)
    launches = kernel_counts()
    retried = (int(r.status), int(r.iters), s.solve_retries_used,
               faults.fired("smoother_nan"))
    derived = add_counts(pcg_derived_launches(s, 1),
                         pcg_derived_launches(s, int(r.iters)))
    x_retry = r.x.cpu().numpy()
    retry_s = s.solve_time
    # the retry evicted the corrupted build: the next solve is clean
    rc = s.solve(b)
    clean = (int(rc.status), int(rc.iters), s.solve_retries_used)
    clean_s = s.solve_time
    x_clean = rc.x.cpu().numpy()
    # the first attempt alone (no retry): FAILED at its first iteration
    s.solve_retries = 0
    s._cache.pop("solve", None)
    with faults.inject("smoother_nan"):
        rf = s.solve(b)
    first = (int(rf.status), int(rf.iters))
    s.solve_retries = 1
    s._cache.pop("solve", None)
    rec = {"faults_retry": {
        "n": n, "status_iters_retries_fired": retried,
        "first_attempt_status_iters": first, "clean": clean,
        "x_bitwise_clean": bool(np.array_equal(x_retry, x_clean)),
        "x_bitwise_bench_pcg": (None if ref is None else
                                bool(np.array_equal(x_clean, ref["x"]))),
        "launches": launches, "derived": derived,
        "retry_solve_s": retry_s, "clean_solve_s": clean_s}}
    print(json.dumps(rec), flush=True)
    check(retried == (0, clean[1], 1, 1),
          f"a: retried solve (status, iters, retries, fired) {retried}, "
          f"clean {clean}")
    check(first == (1, 1), f"a: first attempt {first}, not FAILED at 1")
    check(clean[0] == 0 and clean[2] == 0, f"a: clean solve {clean}")
    check(np.array_equal(x_retry, x_clean),
          "a: the retried x differs from the clean solve's")
    check(ref is None or np.array_equal(x_clean, ref["x"]),
          "a: the clean solve differs from the bench_pcg phase's x")
    check(ref is None or clean[1] == ref["iters"],
          f"a: clean iterations {clean[1]} vs bench_pcg's")
    if on_card:
        check(launches == derived,
              f"a: launches {launches} != walked {derived}")

    # ---- b. dot_breakdown unlimited, a stagnation window of 5, no
    # retry (a's cached retry build would take its clean decisions)
    s.stagnation_window, s.solve_retries = 5, 0
    faults.reset_counters()
    with faults.inject("dot_breakdown", times=-1):
        rd = s.solve(b)
    s.stagnation_window, s.solve_retries = 0, 1
    s._cache.pop("solve", None)
    xd = rd.x.cpu().numpy()
    stag = {"status": int(rd.status), "iterations": int(rd.iters),
            "retries": s.solve_retries_used,
            "fired": faults.fired("dot_breakdown"),
            "x_finite": bool(np.all(np.isfinite(xd)))}
    print(json.dumps({"faults_dot_breakdown": stag}), flush=True)
    check(stag["status"] == 2 and stag["iterations"] <= 10
          and stag["x_finite"], f"b: dot_breakdown {stag}")
    del s, r, rc, rf, rd

    # ---- c. coarse_lu_zero_pivot at setup
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with faults.inject("coarse_lu_zero_pivot"):
            sz = T.create_solver(T.AMGConfig.from_string(BENCH_CFG),
                                 "default", device=device).setup(A)
        rz = sz.solve(b)
        with faults.inject("coarse_lu_zero_pivot"):
            _, rz64, _, _, _ = solve_on(device, BENCH_CFG, n_small,
                                        np.float64)
        raised = False
        try:
            with faults.inject("coarse_lu_zero_pivot"):
                solve_on(device, RAISE_CFG, n_small, np.float64)
        except SingularDiagonalError:
            raised = True
    cz = CPU.get(zero_pivot_cpu, n_small)
    x64 = rz64.x.cpu().numpy()
    d64 = float(np.abs(x64 - cz["x"]).max() / np.abs(cz["x"]).max())
    zp = {"regularize_128": {"status": int(rz.status),
                             "iterations": int(rz.iters),
                             "pinv": sz.precond.coarse_solver._pinv_mode},
          "regularize_64_f64": {"status": int(rz64.status),
                                "iterations": int(rz64.iters),
                                "cpu_iterations": cz["iterations"],
                                "x_max_rel_diff": d64},
          "raise_64_f64": raised}
    print(json.dumps({"faults_zero_pivot": zp}), flush=True)
    check(zp["regularize_128"]["status"] == 0 and zp["regularize_128"][
        "pinv"], f"c: REGULARIZE at {n}^3 {zp['regularize_128']}")
    check(int(rz64.status) == 0 and int(rz64.iters) == cz["iterations"]
          and d64 <= 1e-9, f"c: REGULARIZE 64^3 f64 {zp}")
    check(raised, "c: RAISE did not raise SingularDiagonalError")
    del sz, rz, rz64, A

    # ---- d. serve_compile once: the group quarantines
    systems = serve_family((n_small,) * 3, B, seed=1)
    svc = BatchedSolveService(config=SERVE_PCG_AMG, max_batch=B,
                              device=device)
    with faults.inject("serve_compile"):
        got, _ = served(svc, systems)
    seq, _, _ = serve_seq(device, SERVE_PCG_AMG, systems, reuse=True)
    cmp_d = same_as_seq("faults d", got, seq)
    kinds = [i["kind"] for i in svc.recorder.incidents()]
    q = {"quarantines": svc.metrics.get("quarantines"),
         "quarantined_solves": svc.metrics.get("quarantined_solves"),
         "incidents": kinds,
         "record_paths": sorted({rc_.path for rc_ in
                                 svc.recorder.records()}),
         "iterations": [g[1] for g in got], **cmp_d}
    print(json.dumps({"faults_serve_compile": q}), flush=True)
    check(q["quarantines"] == 1 and q["quarantined_solves"] == B,
          f"d: {q}")
    check("quarantine" in kinds, f"d: no quarantine incident ({kinds})")
    del svc

    # ---- e. capi_internal through the native shim, dDDI at n_small^3
    lib = ctypes.PyDLL(str(kernels.build_native()["lib"]))
    check(lib.AMGX_initialize() == 0, "e: AMGX_initialize")
    sp = poisson_scipy((n_small,) * 3).tocsr()
    sp.sort_indices()
    b64 = poisson_rhs(sp.shape[0], dtype=np.float64)
    H, P = ctypes.c_uint64, ctypes.c_void_p
    mode = ctypes.c_char_p(capi_mode("DDI", device).encode())
    c_h, r_h, A_h, vb, vx, s_h = (H() for _ in range(6))
    rp = np.ascontiguousarray(sp.indptr, np.int32)
    ci = np.ascontiguousarray(sp.indices, np.int32)
    vals = np.ascontiguousarray(sp.data, np.float64)
    x = np.zeros(sp.shape[0])
    rcs = [lib.AMGX_config_create(ctypes.byref(c_h),
                                  ctypes.c_char_p(BENCH_CFG.encode())),
           lib.AMGX_resources_create_simple(ctypes.byref(r_h), c_h),
           lib.AMGX_matrix_create(ctypes.byref(A_h), r_h, mode),
           lib.AMGX_vector_create(ctypes.byref(vb), r_h, mode),
           lib.AMGX_vector_create(ctypes.byref(vx), r_h, mode),
           lib.AMGX_solver_create(ctypes.byref(s_h), r_h, mode, c_h),
           lib.AMGX_matrix_upload_all(A_h, sp.shape[0], sp.nnz, 1, 1,
                                      rp.ctypes.data_as(P),
                                      ci.ctypes.data_as(P),
                                      vals.ctypes.data_as(P), None),
           lib.AMGX_vector_upload(vb, sp.shape[0], 1,
                                  b64.ctypes.data_as(P)),
           lib.AMGX_vector_upload(vx, sp.shape[0], 1, x.ctypes.data_as(P)),
           lib.AMGX_solver_setup(s_h, A_h)]
    faults.reset_counters()
    with faults.inject("capi_internal"):
        rc_fault = lib.AMGX_solver_solve(s_h, vb, vx)
    rc_next = lib.AMGX_solver_solve(s_h, vb, vx)
    rcs.append(lib.AMGX_vector_download(vx, x.ctypes.data_as(P)))
    telemetry_json = C.solver_telemetry_json(s_h.value)
    for fn, h in (("AMGX_solver_destroy", s_h), ("AMGX_vector_destroy", vx),
                  ("AMGX_vector_destroy", vb), ("AMGX_matrix_destroy", A_h),
                  ("AMGX_resources_destroy", r_h),
                  ("AMGX_config_destroy", c_h)):
        rcs.append(getattr(lib, fn)(h))
    _, rdir, _, _, _ = solve_on(device, BENCH_CFG, n_small, np.float64)
    e = {"rc_injected": rc_fault, "rc_next": rc_next,
         "fired": faults.fired("capi_internal"),
         "other_rcs_zero": not any(rcs),
         "x_bitwise_direct": bool(np.array_equal(x, rdir.x.cpu().numpy()))}
    print(json.dumps({"faults_capi_internal": e}), flush=True)
    # the JAX package maps the injected RuntimeError to RC_UNKNOWN
    # (tests/test_capi.py), and so does the port
    check(rc_fault == C.RC_UNKNOWN and e["fired"] == 1,
          f"e: injected RC {rc_fault}")
    check(rc_next == 0 and e["other_rcs_zero"] and e["x_bitwise_direct"],
          f"e: after the fault {e}")

    # ---- f. telemetry of a warm group at trace sample rate 1
    systems = serve_family((n_small,) * 3, B, seed=2)
    svc = BatchedSolveService(config=SERVE_PCG_AMG, max_batch=B,
                              device=device)
    served(svc, systems)  # the cold flush: setup and build
    times = {"off": [], "on": [], "traced": []}
    for _ in range(2):
        for mode_ in ("off", "on", "traced"):
            telemetry.set_telemetry_enabled(mode_ != "off")
            tracing.set_sample_rate(1.0 if mode_ == "traced" else 0.0)
            tracing.clear()
            n_rec = svc.recorder.records_total
            got, t_ = served(svc, systems)
            times[mode_].append(t_["s"] * 1e3 / B)
    telemetry.set_telemetry_enabled(None)
    tracing.set_sample_rate(None)
    spans = tracing.span_buffer().spans()
    chains, groups = span_chains(spans)
    ids = {s_["sid"] for s_ in spans}
    connected = all(
        all(sp_.get("parent") in ids for sp_ in ch if "parent" in sp_)
        and {x_["name"] for x_ in ch} >= {"submit", "pad", "queue",
                                           "dispatch", "device", "fetch"}
        for ch in chains.values())
    chrome = json.loads(json.dumps(tracing.export_chrome()))
    recs = svc.recorder.records()[n_rec:]
    families = prom_grammar(telemetry.get_registry().render_prometheus())
    parsed = json.loads(telemetry_json)
    f = {"chains": len(chains), "connected": connected,
         "flush_groups": len(groups),
         "members": len(groups[0]["args"]["members"]) if groups else 0,
         "chrome_events": len(chrome["traceEvents"]),
         "prometheus_families": len(families),
         "records": len(recs),
         "record_iterations_match": [r_.iterations for r_ in recs]
         == [g[1] for g in got],
         "telemetry_json_keys": sorted(parsed),
         "warm_flush_ms_per_system": times}
    print(json.dumps({"faults_telemetry": f}), flush=True)
    check(len(chains) == B and connected, f"f: span chains {f}")
    check(len(groups) == 1 and f["members"] == B, f"f: flush_group {f}")
    check(f["chrome_events"] >= 6 * B, "f: chrome export")
    check(len(families) >= 25, f"f: {len(families)} families")
    check(f["records"] == B and f["record_iterations_match"],
          f"f: flight records {f['records']}")
    check({"solver", "registry", "enabled"} <= set(parsed),
          f"f: telemetry json keys {sorted(parsed)}")
    del svc

    # ---- g. profile_cycle on the bench hierarchy at n^3 f32
    sb, rb, _, bb, _ = solve_on(device, BENCH_CFG, n, np.float32)
    amg = sb.precond
    bt = torch.from_numpy(bb).to(device)
    prof = profile_cycle(amg, bt, reps=5)
    per_level = {k: v * 1e3 for k, v in sorted(prof.times.items())}
    g = {"card": card_line() if on_card else None, "n": n,
         "levels": len(amg.levels),
         "phase_ms": per_level,
         "phases_sum_ms": sum(per_level.values()),
         "cycle_ms": cycle_ms(torch, amg, bt) if on_card else None}
    print(json.dumps({"profile_cycle": g}), flush=True)
    check(all(v > 0 for v in per_level.values())
          and "coarse/solve" in per_level, f"g: {g}")
    faults.disarm()
    return launches


GATEWAY_N = 64
GATEWAY_B = 16
GATEWAY_CPU_N = 24
# the watchdog and the injected hang of check b
GATEWAY_WATCHDOG_S = 0.5
GATEWAY_HANG_S = 2.0


def gateway_phase(torch, device="cuda", n=GATEWAY_N, B=GATEWAY_B,
                  store=None):
    """The serve layer's front door and failure domains (module
    docstring, phase 24) on ``B`` x ``n``^3 f64 under SERVE_PCG_AMG.
    ``store``: a directory holding the serve phase's exported entry (its
    hierarchy then warm-boots and this phase sets nothing up), else None
    (a store of its own); removed at the end.  Returns {path: launches
    per batched entry point}."""
    import shutil

    folder = store if store is not None else store_dir()
    try:
        return _gateway_phase(torch, device, n, B, folder)
    finally:
        if store is None:
            shutil.rmtree(folder, ignore_errors=True)


def gateway_rounds(gw, base):
    """The admission traffic of check a on gateway ``gw`` over the B
    systems ``base``: tenant A sends 2 B batch-lane systems (base's
    rhs scaled by 1 and 2), B sends B interactive ones (rhs x 3), in
    rounds of two A and one B; with :func:`gateway_for`'s budget and
    quotas.  Returns ([(GatewayTicket, system, lane)], [shed dict])."""
    from amgx_tpu_torch.core.errors import AdmissionRejected

    B = len(base)
    a_sys = [(base[k % B][0], base[k % B][1] * (1 + k // B))
             for k in range(2 * B)]
    b_sys = [(sp, b * 3.0) for sp, b in base]
    admitted, sheds = [], []
    for r in range(B):
        for tenant, lane, sys_ in (("A", "batch", a_sys[2 * r]),
                                   ("A", "batch", a_sys[2 * r + 1]),
                                   ("B", "interactive", b_sys[r])):
            try:
                admitted.append((gw.submit(*sys_, tenant=tenant, lane=lane),
                                 sys_, lane))
            except AdmissionRejected as e:
                sheds.append({"tenant": tenant, "lane": lane,
                              "type": type(e).__name__, "reason": e.reason,
                              "retry_after_s": e.retry_after_s})
    return admitted, sheds


def gateway_for(svc, B):
    """Check a's gateway on ``svc``: 1.5 B in flight (the batch lane's
    ceiling 0.75 of it), tenant A's quota a burst of B, B's of 0.75 B,
    both refilling at 1e-3 a second (their bursts decide)."""
    from amgx_tpu_torch.serve import SolveGateway, TenantQuota

    return SolveGateway(svc, max_inflight=3 * B // 2, quotas={
        "A": TenantQuota(rate=1e-3, burst=float(B)),
        "B": TenantQuota(rate=1e-3, burst=float(3 * B // 4))})


def gateway_traffic(device, n, count=4):
    """Check a's traffic on ``count`` systems of ``n``^3 f64 through a
    gateway on a service that is not started: (sheds as (tenant, lane,
    reason), [(status, iterations, x)] of the admitted)."""
    from amgx_tpu_torch.serve import BatchedSolveService

    svc = BatchedSolveService(config=SERVE_PCG_AMG, max_batch=count,
                              device=device)
    gw = gateway_for(svc, count)
    admitted, sheds = gateway_rounds(gw, serve_family((n,) * 3, count,
                                                      seed=27))
    gw.flush()
    return ([(s["tenant"], s["lane"], s["reason"]) for s in sheds],
            [(int(r.status), int(r.iters), r.x.cpu().numpy())
             for r in (t.result() for t, _s, _l in admitted)])


def gateway_cpu_side(n):
    """The CPU port's side of the gateway phase (check f)."""
    import amgx_tpu_torch  # noqa: F401

    return gateway_traffic("cpu", n)


def _admitted_same(label, got, ref):
    """Each admitted system (status, iterations, x) against the same
    system through the bare service: status and iterations equal, x to
    rtol 1e-10 of its largest entry."""
    worst = 0.0
    for (st, it, x), (rst, rit, rx) in zip(got, ref):
        check(st == rst == 0 and it == rit,
              f"{label}: {st}/{it} against the bare service's {rst}/{rit}")
        worst = max(worst, float(np.abs(x - rx).max() / np.abs(rx).max()))
    check(worst <= 1e-10, f"{label}: x differs by {worst:.3e}")
    return worst


def _group_walk(torch, amg, groups):
    """The batched launches of ``groups`` (lists of iteration counts):
    one cycle walk each over its largest count."""
    return add_counts(*[batched_walk(amg, max(g) + 1, max(g) + 1,
                                     torch.float64) for g in groups])


def _gateway_phase(torch, device, n, B, folder):
    import os

    from amgx_tpu_torch.core import faults
    from amgx_tpu_torch.core.errors import DeviceLostError
    from amgx_tpu_torch.serve import BatchedSolveService, SolveGateway

    on_card = device == "cuda"
    paths = {}
    base = serve_family((n,) * 3, B, seed=21)
    svc = BatchedSolveService(config=SERVE_PCG_AMG, max_batch=B,
                              max_wait_s=30.0, device=device, store=folder)
    t0 = time.perf_counter()
    restored = svc.warm_boot(wait=True)
    boot_s = time.perf_counter() - t0

    # ---- a. admission and lanes (gateway_rounds) through a started
    # gateway; each group's max wait far off, so that the flush below
    # forms them
    gw = gateway_for(svc, B)
    order = []
    execute = svc._execute_group

    def spy(grp, wait_dispatch=True):
        order.append(grp.lane)
        return execute(grp, wait_dispatch)

    svc._execute_group = spy
    gw.start()
    admitted, sheds = gateway_rounds(gw, base)
    zero_counts()
    t0 = time.perf_counter()
    gw.flush()
    got = [(int(r.status), int(r.iters), r.x.cpu().numpy())
           for r in (t.result() for t, _s, _l in admitted)]
    flush_s = time.perf_counter() - t0
    launches = batched_counts()
    gw.stop()
    svc._execute_group = execute
    entry = next(iter(svc.cache._entries.values()))
    amg = entry.solver.precond
    want = _group_walk(torch, amg, [
        [g[1] for g, (_t, _s, lane) in zip(got, admitted) if lane == ln]
        for ln in ("interactive", "batch")])
    ref = [(int(r.status), int(r.iters), r.x.cpu().numpy())
           for r in svc.solve_many([s for _t, s, _l in admitted])]
    worst = _admitted_same("gateway a", got, ref)
    by = {}
    for s in sheds:
        key = f"{s['reason']}/{s['tenant']}/{s['lane']}"
        by[key] = by.get(key, 0) + 1
    first_shed = sheds[0]["lane"] if sheds else None
    m = gw.metrics
    rec = {"n": n, "batch": B, "restored_entries": restored,
           "warm_boot_s": boot_s, "submitted": 3 * B,
           "admitted": len(admitted),
           "admitted_by_lane": {ln: sum(1 for a in admitted if a[2] == ln)
                                for ln in ("interactive", "batch")},
           "sheds_by_reason_tenant_lane": by, "first_shed_lane": first_shed,
           "retry_after_s": sorted({s["retry_after_s"] for s in sheds}),
           "flush_order": order, "flush_and_fetch_s": flush_s,
           "iterations": [g[1] for g in got],
           "x_max_rel_diff_bare": worst,
           "inflight_after": gw.admission.inflight,
           "setups": m.get("setups"),
           "counters": {k: m.get(k) for k in (
               "gateway_admitted", "gateway_completed", "gateway_sheds",
               "shed_overloaded", "shed_quota", "batch_deferrals",
               "batch_promotions")},
           "launches": launches, "walk": want}
    print(json.dumps({"gateway_admission": rec}), flush=True)
    check(sheds and all(s["type"] in ("AdmissionRejected", "Overloaded")
                        and s["retry_after_s"] > 0 for s in sheds),
          f"gateway a: sheds {sheds[:3]}")
    check(first_shed == "batch" and by.get("overloaded/A/batch", 0) > 0
          and not any(k.startswith("overloaded/B") for k in by),
          f"gateway a: the batch lane did not shed first: {by}")
    check(order == ["interactive", "batch"],
          f"gateway a: flush order {order}")
    check(rec["inflight_after"] == 0
          and m.get("gateway_completed") == len(admitted),
          f"gateway a: {rec['inflight_after']} in flight after settle")
    if restored:
        check(m.get("setups") == 0, "gateway a: a warm boot set up")
    if on_card:
        check(launches == want, f"gateway a: launches {launches} != {want}")
    paths["gateway_admission"] = launches
    del gw, admitted, got, ref

    # ---- b. failover and the watchdog on one group of base, the
    # service stopped (flushes run inline); the device-time reservoir
    # cleared before each faulted group, so that the watchdog is the
    # 0.5 s set here and not 25 x an observed p99
    svc.fetch_watchdog_s = GATEWAY_WATCHDOG_S
    hang_env = os.environ.get("AMGX_TPU_FAULT_HANG_S")
    os.environ["AMGX_TPU_FAULT_HANG_S"] = str(GATEWAY_HANG_S)

    def run_group(site=None, times=1, failover=True):
        svc.failover = failover
        svc.metrics.reset_latency()
        before = {k: svc.metrics.get(k) for k in (
            "resilience_failovers", "resilience_requeue_failures",
            "resilience_watchdog_fires", "quarantines", "breaker_trips",
            "failed_groups")}
        zero_counts()
        faults.reset_counters()
        if site is not None:
            faults.arm(site, times)
        try:
            # the group flushes at its B-th submit (max_batch): the
            # seconds of the submits and the flush
            t0 = time.perf_counter()
            ts = [svc.submit(sp, b) for sp, b in base]
            svc.flush()
            flush_s = time.perf_counter() - t0
            retry = ts[0]._batch.retry
            kept = 0 if retry is None else sum(
                a.nbytes for a in retry.values() if a is not None)
            out, t1 = [], time.perf_counter()
            for t in ts:
                try:
                    r = t.result()
                    out.append((int(r.status), int(r.iters),
                                r.x.cpu().numpy()))
                except DeviceLostError:
                    out.append("DeviceLostError")
            settle_s = time.perf_counter() - t1
            fired = faults.fired(site) if site else 0
        finally:
            faults.disarm()
            svc.failover = True
        delta = {k: svc.metrics.get(k) - v for k, v in before.items()}
        return out, batched_counts(), delta, flush_s, kept, settle_s, fired

    clean, clean_l, _, on_s, kept_on, _, _ = run_group()
    its = [g[1] for g in clean]
    walk1 = _group_walk(torch, amg, [its])
    walk2 = _group_walk(torch, amg, [its, its])
    _, _, _, off_s, kept_off, _, _ = run_group(failover=False)
    _, _, _, off_s2, _, _, _ = run_group(failover=False)
    _, _, _, on_s2, _, _, _ = run_group()
    sites = {}
    for site, walk in (("device_lost_dispatch", walk1),
                       ("device_lost_fetch", walk2),
                       ("fetch_hang", walk2)):
        out, lc, delta, f_s, _, settle_s, fired = run_group(site)
        bitwise = all(isinstance(o, tuple) and o[:2] == c[:2]
                      and np.array_equal(o[2], c[2])
                      for o, c in zip(out, clean))
        sites[site] = {"fired": fired, "x_bitwise_clean": bitwise,
                       "flush_s": f_s, "settle_s": settle_s,
                       "launches": lc, "walk": walk, **delta}
        check(fired == 1 and bitwise,
              f"gateway b {site}: fired {fired}, x bit for bit {bitwise}")
        check(delta["resilience_failovers"] == 1
              and delta["quarantines"] == 0 and delta["breaker_trips"] == 0,
              f"gateway b {site}: {delta}")
        if on_card:
            check(lc == walk, f"gateway b {site}: launches {lc} != {walk}")
        paths[f"gateway_{site}"] = lc
    out_off, _, d_off, _, _, _, _ = run_group("device_lost_fetch",
                                              failover=False)
    out_dh, _, d_dh, _, _, dh_s, _ = run_group("fetch_hang", times=2)
    bound = 2 * GATEWAY_WATCHDOG_S + 0.5
    rec = {"watchdog_s": GATEWAY_WATCHDOG_S, "hang_s": GATEWAY_HANG_S,
           "clean_iterations": its, "clean_launches": clean_l,
           "submit_and_flush_s": {"failover_on": [on_s, on_s2],
                                  "failover_off": [off_s, off_s2]},
           "retained_bytes": {"failover_on": kept_on,
                              "failover_off": kept_off},
           "sites": sites,
           "failover_off_fetch_loss": {
               "outcomes": sorted({str(o) for o in out_off}), **d_off},
           "double_hang": {"outcomes": sorted({str(o) for o in out_dh}),
                           "settle_s": dh_s, "bound_s": bound, **d_dh}}
    print(json.dumps({"gateway_failover": rec}), flush=True)
    check(out_off == ["DeviceLostError"] * len(base)
          and d_off["resilience_failovers"] == 0,
          f"gateway b: failover off: {rec['failover_off_fetch_loss']}")
    check(out_dh == ["DeviceLostError"] * len(base) and dh_s <= bound
          and d_dh["resilience_watchdog_fires"] == 2
          and d_dh["resilience_requeue_failures"] == 1,
          f"gateway b: double hang: {rec['double_hang']}")
    check(kept_on > 0 and kept_off == 0,
          f"gateway b: retained {kept_on} / {kept_off} bytes")
    svc.fetch_watchdog_s = 120.0
    if hang_env is None:
        os.environ.pop("AMGX_TPU_FAULT_HANG_S", None)
    else:
        os.environ["AMGX_TPU_FAULT_HANG_S"] = hang_env

    # ---- c. the classifier on a real error of the card: an allocation
    # past the card's memory raises torch.cuda.OutOfMemoryError, which is
    # not a device loss (no real device loss is provoked)
    if on_card:
        free, total = torch.cuda.mem_get_info()
        oom = None
        try:
            torch.empty(total + (1 << 30), dtype=torch.uint8,
                        device=device)
        except torch.cuda.OutOfMemoryError as e:
            oom = e
        cuda_like = RuntimeError("CUDA error: an illegal memory access was "
                                 "encountered")
        rec = {"free_bytes": free, "total_bytes": total,
               "oom_raised": oom is not None,
               "oom_classified_as_loss": oom is not None and (
                   BatchedSolveService._classify_device_loss(oom)
                   is not None),
               "cuda_error_message_classified_as_loss":
                   BatchedSolveService._classify_device_loss(cuda_like)
                   is not None,
               "real_device_loss_provoked": False}
        print(json.dumps({"gateway_classifier": rec}), flush=True)
        check(rec["oom_raised"] and not rec["oom_classified_as_loss"]
              and rec["cuda_error_message_classified_as_loss"],
              f"gateway c: {rec}")
        del oom

    # ---- d. drain under load: two groups handed to the dispatch worker
    # (each fills max_batch at its submit), then drain() at once
    gw = SolveGateway(svc, max_inflight=4 * B)
    gw.start()
    d_sys = base + [(sp, b * 2.0) for sp, b in base]
    ts = [gw.submit(sp, b) for sp, b in d_sys]
    running = sum(1 for t in ts if t._ticket._batch is not None
                  and t._ticket._batch.running())
    t0 = time.perf_counter()
    report = gw.drain(timeout_s=120.0)
    drain_s = time.perf_counter() - t0
    from amgx_tpu_torch.core.errors import AMGXTPUError

    outcomes = {"done": 0, "typed": 0, "untyped": 0}
    for t in ts:
        try:
            t.result()
            outcomes["done"] += 1
        except AMGXTPUError:
            outcomes["typed"] += 1
        except Exception:  # noqa: BLE001 — counted: must stay 0
            outcomes["untyped"] += 1
    svc2 = BatchedSolveService(config=SERVE_PCG_AMG, max_batch=B,
                               device=device, store=folder)
    gw2 = SolveGateway(svc2)
    t0 = time.perf_counter()
    booted = svc2.warm_boot(wait=True)
    boot2_s = time.perf_counter() - t0
    ts2 = [gw2.submit(sp, b) for sp, b in base]
    gw2.flush()
    st2 = [int(t.result().status) for t in ts2]
    rec = {"tickets": len(ts), "running_at_drain": running,
           "report": report, "outcomes": outcomes, "drain_s": drain_s,
           "replacement_restores": booted, "replacement_boot_s": boot2_s,
           "replacement_setups": svc2.metrics.get("setups"),
           "replacement_cache_hits": svc2.metrics.get("cache_hits"),
           "replacement_statuses": sorted(set(st2))}
    print(json.dumps({"gateway_drain": rec}), flush=True)
    check(report["settled"] + report["failed"] == len(ts)
          and report["timed_out"] == 0 and report["failed"] == 0
          and outcomes["done"] == len(ts) and report["exported"] >= 1,
          f"gateway d: drain report {report}")
    check(booted >= 1 and rec["replacement_setups"] == 0
          and rec["replacement_cache_hits"] >= 1 and st2 == [0] * B,
          f"gateway d: the replacement {rec}")
    del gw, gw2, svc2, ts, ts2, d_sys, entry, amg

    # ---- e. sessions through a gateway: the heat stream's B sessions, 2
    # steps, over the phase's service (its hierarchy: the stream has the
    # pattern of base) and then through a gateway on it (x bit for bit);
    # the C API's admission front
    stream = HeatStream(n, B)
    bare = svc
    digests = {"bare": [], "gateway": []}

    def keep(label):
        return lambda k, v, xp, x0, res: digests[label].append(
            x_digests(res))

    zero_counts()
    heat_sessions(device, stream, 2, svc=bare, after_step=keep("bare"))
    gw = SolveGateway(bare, max_inflight=4 * B)
    admitted0 = gw.metrics.get("gateway_admitted")
    zero_counts()
    out, _, mgr, _ = heat_sessions(device, stream, 2, svc=gw,
                                   after_step=keep("gateway"))
    paths["gateway_sessions"] = batched_counts()
    rec = {"sessions": B, "steps": 2,
           "iterations": [[r[1] for r in o["results"]] for o in out],
           "x_bitwise_bare": digests["gateway"] == digests["bare"],
           "gateway_admitted": gw.metrics.get("gateway_admitted")
           - admitted0,
           "launches": paths["gateway_sessions"]}
    print(json.dumps({"gateway_sessions": rec}), flush=True)
    check(rec["x_bitwise_bare"] and rec["gateway_admitted"] == 2 * B
          and mgr.gateway is gw,
          f"gateway e: sessions {rec}")
    del gw, mgr, bare, stream, svc
    print(json.dumps({"gateway_capi": gateway_capi(device, n, B)}),
          flush=True)

    # ---- f. check a's traffic on the card and in the CPU port at 4 x
    # GATEWAY_CPU_N^3 f64: the same sheds, iterations equal, x to 1e-9
    n_cpu = GATEWAY_CPU_N if on_card else n
    cpu = CPU.get(gateway_cpu_side, n_cpu)
    card = gateway_traffic(device, n_cpu)
    worst = max(float(np.abs(x - cx).max() / np.abs(cx).max())
                for (_s, _i, x), (_cs, _ci, cx) in zip(card[1], cpu[1]))
    rec = {"n": n_cpu, "sheds": card[0],
           "iterations": [r[1] for r in card[1]],
           "cpu_iterations": [r[1] for r in cpu[1]],
           "x_max_rel_diff": worst}
    print(json.dumps({"gateway_vs_cpu": rec}), flush=True)
    check(card[0] == cpu[0] and [r[:2] for r in card[1]]
          == [r[:2] for r in cpu[1]] and worst <= 1e-9,
          f"gateway f: card against CPU: {rec}")
    return paths


def gateway_capi(device, n, count):
    """Check e, the C API: ``solver_solve_batch`` on ``count`` systems of
    ``n``^3 under ``AMGX_TPU_CAPI_ADMISSION`` = count / 2 (dDDI; hDDI on
    the CPU): RC 0 (the JAX package's), the admitted half SUCCESS with
    the bare service's iterations, the shed half FAILED; a malformed
    value RC_BAD_CONFIGURATION on every call."""
    import os

    from amgx_tpu_torch.api import capi as C

    mode = capi_mode("DDI", device)
    systems = serve_family((n,) * 3, count, seed=23)
    C.initialize()

    def handles(systems):
        c = C.config_create(SERVE_PCG_AMG)
        r = C.resources_create_simple(c)
        slv = C.solver_create(r, mode, c)
        mh, rh, sh = [], [], []
        for sp, b in systems:
            m = C.matrix_create(r, mode)
            C.matrix_upload_all(m, sp.shape[0], sp.nnz, 1, 1, sp.indptr,
                                sp.indices, sp.data, None)
            v = C.vector_create(r, mode)
            C.vector_upload(v, sp.shape[0], 1, b)
            x = C.vector_create(r, mode)
            C.vector_set_zero(x, sp.shape[0], 1)
            mh.append(m)
            rh.append(v)
            sh.append(x)
        return slv, mh, rh, sh

    prev = os.environ.get("AMGX_TPU_CAPI_ADMISSION")
    try:
        os.environ["AMGX_TPU_CAPI_ADMISSION"] = str(count // 2)
        slv, mh, rh, sh = handles(systems)
        rc = C.solver_solve_batch(slv, mh, rh, sh)
        statuses = [C.solver_get_batch_status(slv, i) for i in range(count)]
        iters = [C.solver_get_batch_iterations_number(slv, i)
                 for i in range(count)]
        os.environ["AMGX_TPU_CAPI_ADMISSION"] = "eight"
        # the budget is read before any system: one is enough
        slv2, mh2, rh2, sh2 = handles(systems[:1])
        bad = []
        for _ in range(2):
            try:
                bad.append(C.solver_solve_batch(slv2, mh2, rh2, sh2))
            except C.AMGXError as e:
                bad.append(e.rc)
    finally:
        if prev is None:
            os.environ.pop("AMGX_TPU_CAPI_ADMISSION", None)
        else:
            os.environ["AMGX_TPU_CAPI_ADMISSION"] = prev
    from amgx_tpu_torch.serve import BatchedSolveService

    ref = BatchedSolveService(config=SERVE_PCG_AMG, max_batch=count,
                              device=device).solve_many(
        systems[:count // 2])
    rec = {"mode": mode, "budget": count // 2, "rc": rc,
           "statuses": statuses, "iterations": iters,
           "bare_iterations": [int(r.iters) for r in ref],
           "malformed_rcs": bad}
    check(rc == C.RC_OK and statuses == [C.SOLVE_SUCCESS] * (count // 2)
          + [C.SOLVE_FAILED] * (count - count // 2)
          and iters[:count // 2] == rec["bare_iterations"],
          f"gateway e capi: {rec}")
    check(bad == [C.RC_BAD_CONFIGURATION] * 2,
          f"gateway e capi: a malformed budget gave {bad}")
    return rec


FLEET_N = 64
FLEET_B = 16
# torch threads of a worker process (two workers and this process share
# the host's cores)
FLEET_WORKER_ENV = {"OMP_NUM_THREADS": "2"}
FLEET_COUNTS_EVERY_S = 0.5


def _write_json(path, obj):
    import os

    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def fleet_worker(argv):
    """A worker process of the fleet phase (``chip_smoke.py --fleet-worker
    <worker flags>``): the port's ``fleet.worker.main`` with
    SERVE_PCG_AMG.  Beside the registry it writes
    ``counts_<id>.json``, its kernel launches (:func:`variant_counts`,
    counted from 0 at its start) every FLEET_COUNTS_EVERY_S and at exit
    (a worker killed with SIGKILL keeps its last)."""
    import os

    from amgx_tpu_torch.fleet import worker

    wid = argv[argv.index("--worker-id") + 1]
    out = os.path.dirname(os.path.abspath(argv[argv.index("--registry") + 1]))
    zero_counts()
    stop = threading.Event()

    def dump():
        _write_json(os.path.join(out, f"counts_{wid}.json"),
                    {"pid": os.getpid(), "counts": variant_counts()})

    def loop():
        while not stop.wait(FLEET_COUNTS_EVERY_S):
            dump()

    writer = threading.Thread(target=loop, daemon=True)
    writer.start()
    try:
        return worker.main(argv, config=SERVE_PCG_AMG)
    finally:
        stop.set()
        writer.join()
        dump()


def fleet_supervisor(root, store, device, B):
    """A FleetSupervisor whose workers are :func:`fleet_worker` processes
    on ``device`` (max_batch ``B``), with the seconds from each spawn to
    its announce in ``spawn_s``."""
    import os

    from amgx_tpu_torch.fleet.lifecycle import FleetSupervisor

    class Supervisor(FleetSupervisor):
        worker_cmd = (sys.executable, os.path.abspath(__file__),
                      "--fleet-worker")

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.spawn_s, self._t0 = {}, {}

        def _start(self, slot, *args, **kwargs):
            wid, proc = super()._start(slot, *args, **kwargs)
            self._t0[wid] = time.perf_counter()
            return wid, proc

        def _announced(self, wid, proc):
            rec = super()._announced(wid, proc)
            self.spawn_s[wid] = time.perf_counter() - self._t0[wid]
            return rec

    return Supervisor(os.path.join(root, "registry"), store,
                      env=FLEET_WORKER_ENV, spawn_timeout_s=600.0,
                      worker_args=["--device", device, "--max-batch",
                                   str(B)])


def _in_thread(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on a thread of its own: a future."""
    import concurrent.futures

    fut = concurrent.futures.Future()

    def run():
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 — to the reader
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True).start()
    return fut


def _fleet_seq_walk(torch, device, systems):
    """:func:`fleet_seq` and the batched walk of one group of its
    largest iteration count."""
    ref, amg = fleet_seq(device, systems)
    it = max(r[1] for r in ref)
    return ref, batched_walk(amg, it + 1, it + 1, torch.float64)


def fleet_seq(device, systems):
    """:func:`serve_seq`'s reuse reference (one setup on system 0, then
    values-only resetups), with its AMG preconditioner for the walks."""
    import amgx_tpu_torch as T

    s = A0 = None
    out = []
    for sp, b in systems:
        if A0 is None:
            A0 = T.SparseMatrix.from_scipy(sp, device=device)
            s = T.create_solver(T.AMGConfig.from_string(SERVE_PCG_AMG),
                                "default", device=device).setup(A0)
        else:
            s.resetup(A0.replace_values(sp.data))
        r = s.solve(b)
        out.append((int(r.status), int(r.iters), r.x.cpu().numpy()))
    return out, s.precond


def worker_groups(text):
    """The groups a worker ran, from its ``metrics`` text: {bucket "(n,
    nnz, batch)": [groups, real systems]}."""
    import re

    out = {}
    for kind in ("calls", "instances"):
        pat = (rf'^amgx_serve_bucket_{kind}_total\{{[^}}]*bucket="([^"]*)"'
               r'[^}]*\} (\S+)$')
        for bucket, v in re.findall(pat, text, re.M):
            out.setdefault(bucket, [0, 0])[kind == "instances"] += int(
                float(v))
    return out


def read_counts(root):
    """Each worker's last launch counts (``counts_<id>.json``)."""
    import glob
    import os

    out = {}
    for path in sorted(glob.glob(os.path.join(root, "counts_*.json"))):
        with open(path) as f:
            out[os.path.basename(path)[7:-5]] = json.load(f)["counts"]
    return out


def fleet_phase(torch, device="cuda", n=FLEET_N, B=FLEET_B, store=None,
                serve_a=None):
    """The multi-process fleet (module docstring, phase 25): two worker
    processes over the port's ``SolveGateway`` on one card, B x n^3 f64
    under SERVE_PCG_AMG.  ``store``: the directory of serve a's exported
    entry (the workers warm-boot it), else None (a store of the phase's
    own); ``serve_a``: the serve phase's ``keep`` dict (serve a's
    systems, reference and walk under (n, B)), else None (made here).
    The workers start first (``FleetSupervisor.launch`` on a thread of
    its own, after freeing this process's cached card memory for their
    contexts) and boot while this process solves the references.
    Returns {"fleet": launches per batched entry point, summed over
    every worker process}."""
    import os
    import shutil

    if device == "cuda":
        torch.cuda.empty_cache()
    folder = store_dir()
    sup = fleet_supervisor(folder, store or os.path.join(folder, "store"),
                           device, B)
    records = _in_thread(sup.launch, 2)
    try:
        return _fleet_phase(torch, device, n, B, store, folder, sup,
                            records, (serve_a or {}).get((n, B)))
    finally:
        sup.terminate_all(timeout_s=120)
        shutil.rmtree(folder, ignore_errors=True)


def fleet_walk_mix(counts, walks, calls):
    """The groups of each fingerprint, {label: groups}, whose walks
    (``walks``: {label: launches per batched entry point of one group})
    sum to ``counts`` (launches per batched entry point), ``calls``
    groups in all (an int, or a range of them); None where no mix
    does.  Fingerprints whose walks are equal count together, their
    labels joined by "+"."""
    merged = {}
    for lab in sorted(walks):
        same = next((m for m in merged if merged[m] == walks[lab]), None)
        if same is None:
            merged[lab] = walks[lab]
        else:
            merged[f"{same}+{lab}"] = merged.pop(same)
    walks = merged
    labels = sorted(walks)
    entries = sorted({e for c in (counts, *walks.values()) for e in c})
    for total in ([calls] if isinstance(calls, int) else calls):
        for head in itertools.product(range(total + 1),
                                      repeat=len(labels) - 1):
            g = (*head, total - sum(head))
            if g[-1] >= 0 and all(
                    sum(k * walks[lab].get(e, 0) for k, lab in
                        zip(g, labels)) == counts.get(e, 0)
                    for e in entries):
                return dict(zip(labels, g))
    return None


def group_calls(groups):
    """The groups a worker ran in all, from :func:`worker_groups`."""
    return sum(calls for calls, _real in groups.values())


def boot_to_announce_s(front, record):
    """The seconds from a worker's construction (its gateway built) to
    its announce, its warm boot: its uptime (``health``) against its
    registry record's announce time, both on this host's clock, within
    the health reply's latency."""
    up = front.health(record.slot)["worker"]["uptime_s"]
    return record.started_at - (time.time() - up)


def batched_only(counts):
    """The batched entry points' launches of ``counts``."""
    return {e: c for e, c in counts.items() if "batched" in e}


def _fleet_round(front, families):
    """Submit every system of ``families`` ({label: systems}), in order,
    and read the results: ({label: [(status, iterations, x, history)]},
    {label: [slot]}, seconds)."""
    t0 = time.perf_counter()
    tickets = {k: [front.submit(sp, b) for sp, b in systems]
               for k, systems in families.items()}
    got = {k: [(int(r.status), int(r.iters), r.x.numpy(), r.history)
               for r in (t.result(timeout=900) for t in ts)]
           for k, ts in tickets.items()}
    slots = {k: [t._pending.slot for t in ts] for k, ts in tickets.items()}
    return got, slots, time.perf_counter() - t0


def _fleet_phase(torch, device, n, B, handoff, folder, sup, records,
                 serve_a):
    from amgx_tpu_torch.core.errors import (
        AMGXTPUError,
        DeviceLostError,
        NonFiniteValuesError,
    )
    from amgx_tpu_torch.fleet.frontend import FleetFrontend

    on_card = device == "cuda"
    front = None
    rec = {"n": n, "batch": B,
           "store": "serve a's export" if handoff else "empty"}
    paths = {}
    fam, ref, walk = {}, {}, {}

    def seq(k, known=None):
        ref[k], walk[k] = known or _fleet_seq_walk(torch, device, fam[k])
        walk[k] = batched_only(walk[k])
        # a group's launches are one walk of its largest iteration
        # count: with one count a fingerprint, every group's are known
        # whatever the groups' sizes
        its = sorted({r[1] for r in ref[k]})
        check(len(its) == 1, f"fleet: fingerprint {k}'s systems take "
              f"{its} iterations, not one count")

    try:
        # the workers boot while this process makes the systems and
        # solves the references (serve a's, where the serve phase ran)
        if serve_a is not None:
            fam["a"] = serve_a[0]
            seq("a", serve_a[1:])
        else:
            fam["a"] = serve_family((n,) * 3, B, seed=1)
            seq("a")
        fam["b"] = serve_family((n // 2, n, 2 * n), B, seed=43)
        seq("b")
        t0 = time.perf_counter()
        records = records.result()
        rec["wait_for_announce_s"] = time.perf_counter() - t0
        rec["spawn_to_announce_s"] = dict(sup.spawn_s)
        rec["warm_booted"] = {r.worker_id: r.extra.get("warm_booted")
                              for r in records}
        front = FleetFrontend(register_telemetry=False)
        for r in records:
            front.attach(r)
        rec["boot_to_announce_s"] = {r.worker_id: boot_to_announce_s(
            front, r) for r in records}

        # ---- a. two fingerprints spread over the two workers; a repeat
        # round, every submit an affinity hit; x as the sequential solves'
        got, slots, secs = _fleet_round(front, fam)
        cmp = {k: same_as_seq(f"fleet a {k}", got[k], ref[k]) for k in fam}
        fp = {k: fam[k][0][0]._amgx_tpu_fp for k in fam}
        worker_slot = {k: front.router.peek(fp[k]) for k in fam}
        check(sorted(worker_slot.values()) == [0, 1]
              and all(set(s) == {worker_slot[k]} for k, s in slots.items()),
              f"fleet a: the fingerprints did not spread: {slots}")
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv"], capture_output=True, text=True,
            timeout=60).stdout if on_card else ""
        print(apps, flush=True)
        h0 = front.router.snapshot()
        got2, _, secs2 = _fleet_round(front, fam)
        h1 = front.router.snapshot()
        cmp2 = {k: same_as_seq(f"fleet a repeat {k}", got2[k], ref[k])
                for k in fam}
        hits = h1["hits"] - h0["hits"]
        check(hits == 2 * B and h1["misses"] == h0["misses"],
              f"fleet a: the repeat round's hits {hits} of {2 * B}")
        time.sleep(2 * FLEET_COUNTS_EVERY_S)
        counts = read_counts(folder)
        groups = {r.worker_id: worker_groups(front.metrics_text(r.slot))
                  for r in records}
        n_groups = {k: group_calls(groups[records[worker_slot[k]].worker_id])
                    for k in fam}
        launches = batched_only(add_counts(*counts.values()))
        want = add_counts(*[{e: c * n_groups[k] for e, c in walk[k].items()}
                            for k in fam])
        lat = front.wire_latency.summary()
        rec["rounds"] = {
            "slots": worker_slot, "iterations": {
                k: sorted({g[1] for g in got[k]}) for k in fam},
            "x_vs_sequential": cmp, "repeat_x_vs_sequential": cmp2,
            "round_s": [secs, secs2], "repeat_hits": hits,
            "wire_s_per_system": [secs / (2 * B), secs2 / (2 * B)],
            "wire_latency": lat, "groups": groups,
            "groups_by_fingerprint": n_groups,
            "launches_by_worker": counts, "launches": launches,
            "walk": want, "compute_apps": apps.strip().splitlines()}
        if on_card:
            for wid, c in counts.items():
                check(c.get("dia_spmv_batched_f64", 0) > 0
                      and c.get("ell_spmv_batched_f64", 0) > 0,
                      f"fleet a: worker {wid} launched {c}")
            check(launches == want,
                  f"fleet a: launches {launches} != walk {want}")

        # ---- b. a typed error crosses the wire; the worker is fine
        bad = front.submit(fam["a"][0][0], np.full(n ** 3, np.nan))
        try:
            bad.result(timeout=300)
            typed = None
        except AMGXTPUError as e:
            typed = type(e).__name__
        rec["typed_error"] = {
            "raised": typed,
            "tripped": front.router.board.tripped_indices()}
        check(typed == NonFiniteValuesError.__name__
              and not rec["typed_error"]["tripped"],
              f"fleet b: {rec['typed_error']}")

        # ---- c. rolling restart of the worker of the fingerprint k: its
        # admitted group in flight as the drain begins settles; the
        # drained process exits 0; the replacement warm-boots; a system
        # of the other fingerprint in flight first (its worker busy)
        # sends k's next two to the replacement, cache hits with no setup
        k = "a" if worker_slot["a"] != worker_slot["b"] and \
            h1["busy_s"][worker_slot["a"]] <= h1["busy_s"][
                worker_slot["b"]] else "b"
        other = "b" if k == "a" else "a"
        victim = records[worker_slot[k]]
        inflight = [front.submit(sp, b) for sp, b in fam[k]]
        t0 = time.perf_counter()
        out = _in_thread(sup.rolling_restart, victim.worker_id, front,
                         timeout_s=600)
        fam["c"] = serve_family((2 * n, n, n // 2), B, seed=44)
        seq("c")
        out = out.result()
        restart_s = time.perf_counter() - t0
        settled = [(int(r.status), int(r.iters), r.x.numpy(), r.history)
                   for r in (t.result(timeout=900) for t in inflight)]
        cmp_c = same_as_seq("fleet c in flight", settled, ref[k])
        new = out["replacement"]
        h_new0 = front.health(new.slot)
        new_boot_s = boot_to_announce_s(front, new)
        got3, slots3, secs3 = _fleet_round(front, {other: fam[other][:1],
                                                   k: fam[k][:2]})
        same_as_seq("fleet c after", got3[k], ref[k])
        h_new = front.health(new.slot)
        rec["rolling_restart"] = {
            "worker": victim.worker_id, "fingerprint": k,
            "drain": out["drain"], "exit_code": out["exit_code"],
            "restart_s": restart_s, "replacement": new.worker_id,
            "replacement_spawn_to_announce_s": sup.spawn_s.get(new.worker_id),
            "replacement_boot_to_announce_s": new_boot_s,
            "in_flight_x_vs_sequential": cmp_c,
            "replacement_slots": sorted(set(slots3[k])),
            "replacement_serve": h_new["serve"],
            "replacement_setup_evidence": h_new["setup_evidence"],
            "replacement_warm_booted": h_new0["worker"]["warm_booted"],
            "round_s": secs3}
        print(json.dumps({"fleet_restart": rec["rolling_restart"]}),
              flush=True)
        rep = out["drain"]
        check(rep["failed"] == 0 and rep["timed_out"] == 0
              and rep["exported"] >= 1 and out["exit_code"] == 0,
              f"fleet c: drain {rep}, exit code {out['exit_code']}")
        check(h_new0["worker"]["warm_booted"] >= 1
              and set(slots3[k]) == {new.slot}
              and h_new["serve"]["setups"] == 0
              and h_new["serve"]["cache_hits"] >= 1
              and h_new["setup_evidence"]["coarsen_calls"] == 0
              and h_new["setup_evidence"]["restored"] >= 1,
              f"fleet c: the replacement {rec['rolling_restart']}")

        # ---- d. kill -9 of the worker of a cold fingerprint's group:
        # every ticket settles (x as the sequential solves') or raises
        # DeviceLostError; the survivor serves on
        live = {r.slot: r.worker_id for r in (*records, new)}
        calls_d = {wid: group_calls(worker_groups(front.metrics_text(slot)))
                   for slot, wid in live.items()}
        snap0 = front.telemetry_snapshot()
        tickets = [front.submit(sp, b) for sp, b in fam["c"]]
        slot_c = tickets[0]._pending.slot
        killed = live[slot_c]
        t0 = time.perf_counter()
        check(sup.kill(killed), f"fleet d: {killed} was not running")
        outcomes, done = [], []
        for t in tickets:
            try:
                r = t.result(timeout=900)
                outcomes.append("ok")
                done.append((int(r.status), int(r.iters), r.x.numpy(),
                             r.history))
            except DeviceLostError:
                outcomes.append("DeviceLostError")
        settle_s = time.perf_counter() - t0
        # the supervisor reaps the killed process (and withdraws its
        # registry record, which names a process that is gone)
        killed_rc = sup.reap(killed, timeout_s=60)
        cmp_d = (same_as_seq("fleet d requeued", done, [
            ref["c"][i] for i, o in enumerate(outcomes) if o == "ok"])
            if done else None)
        snap = front.telemetry_snapshot()
        survivor = 1 - slot_c
        delta = {key: snap["counters"][key] - snap0["counters"][key]
                 for key in ("conn_losses", "requeued", "requeue_failures")}
        rec["kill9"] = {
            "killed": killed, "exit_code": killed_rc,
            "outcomes": sorted(set(outcomes)),
            "ok": outcomes.count("ok"), "settle_s": settle_s,
            "x_vs_sequential": cmp_d, "trips":
                snap["routing"]["health"]["trips"],
            "survivor": survivor, "survivor_ping": front.ping(survivor),
            **delta}
        print(json.dumps({"fleet_kill9": rec["kill9"]}), flush=True)
        # the tickets the killed worker answered before the kill are
        # settled; the rest (at least one: the kill came during the
        # group) requeue once
        check(len(outcomes) == B and delta["conn_losses"] == 1
              and 1 <= delta["requeued"] + delta["requeue_failures"] <= B
              and rec["kill9"]["survivor_ping"],
              f"fleet d: {rec['kill9']}")

        # ---- e. the C API over the fleet: AMGX_TPU_FLEET names the
        # registry (the survivor alone now), solver_solve_batch on 4
        # systems (dDDI; hDDI on the CPU); no local service
        rec["capi"] = fleet_capi(device, sup.registry.root, fam["a"][:4],
                                 ref["a"][:4])
        print(json.dumps({"fleet_capi": rec["capi"]}), flush=True)
        calls_end = group_calls(worker_groups(front.metrics_text(survivor)))
    finally:
        if front is not None:
            front.close()
        sup.terminate_all(timeout_s=120)
    final = {wid: batched_only(c) for wid, c in read_counts(folder).items()}
    paths["fleet"] = add_counts(*final.values())
    # each worker's launches as walks of the groups it ran: the
    # survivor's groups from its metrics at the end; the drained
    # worker's since check a, 1 to B groups in flight at its drain; the
    # killed worker's last file at most its groups before d and B more
    mix = {live[survivor]: fleet_walk_mix(final.get(live[survivor], {}),
                                          walk, calls_end),
           victim.worker_id: fleet_walk_mix(add_counts(
               final.get(victim.worker_id, {}), {
                   e: -c for e, c in batched_only(
                       counts[victim.worker_id]).items()}),
               walk, range(1, B + 1))}
    most = {e: (calls_d[killed] + B) * max(w.get(e, 0) for w in walk.values())
            for e in set().union(*walk.values())}
    rec["launches_by_worker"] = final
    rec["launches"] = paths["fleet"]
    rec["groups_of_walks"] = mix
    rec["killed_at_most"] = most
    print(json.dumps({"fleet": rec}), flush=True)
    if on_card:
        check(len(final) >= 3 and all(
            c.get("dia_spmv_batched_f64", 0) > 0 for c in final.values()),
            f"fleet: a worker launched nothing: {final}")
        check(all(g is not None for g in mix.values()),
              f"fleet: launches not walks of the groups run: {mix}, "
              f"{final}, walks {walk}")
        check(all(v <= most.get(e, 0) for e, v in final[killed].items()),
              f"fleet: the killed worker launched {final[killed]}, more "
              f"than {most}")
    return paths


def fleet_capi(device, registry, systems, ref):
    """Check e: the C API's batched solve routed by ``AMGX_TPU_FLEET``."""
    import os

    from amgx_tpu_torch.api import capi as C

    mode = "dDDI" if device == "cuda" else "hDDI"
    prev = os.environ.get("AMGX_TPU_FLEET")
    os.environ["AMGX_TPU_FLEET"] = registry
    try:
        C.initialize()
        cfg = C.config_create(SERVE_PCG_AMG)
        res_h = C.resources_create_simple(cfg)
        mh, rh, sh = [], [], []
        for sp, b in systems:
            n = sp.shape[0]
            m = C.matrix_create(res_h, mode)
            C.matrix_upload_all(m, n, sp.nnz, 1, 1,
                                sp.indptr.astype(np.int32),
                                sp.indices.astype(np.int32), sp.data)
            r = C.vector_create(res_h, mode)
            C.vector_upload(r, n, 1, b)
            x = C.vector_create(res_h, mode)
            C.vector_set_zero(x, n, 1)
            mh.append(m)
            rh.append(r)
            sh.append(x)
        slv = C.solver_create(res_h, mode, cfg)
        t0 = time.perf_counter()
        rc = C.solver_solve_batch(slv, mh, rh, sh)
        st = [C.solver_get_batch_status(slv, i) for i in range(len(sh))]
        its = [C.solver_get_batch_iterations_number(slv, i)
               for i in range(len(sh))]
        secs = time.perf_counter() - t0
        xs = [C.vector_download(h) for h in sh]
        s = C._get(slv, C._SolverHandle)
        local = s.batch_service is not None or s.batch_gateway is not None
        fleet = s.batch_fleet is not None
        C.solver_destroy(slv)
    finally:
        if prev is None:
            os.environ.pop("AMGX_TPU_FLEET", None)
        else:
            os.environ["AMGX_TPU_FLEET"] = prev
    worst = max(float(np.abs(x - rx).max() / np.abs(rx).max())
                for x, (_s, _i, rx) in zip(xs, ref))
    out = {"mode": mode, "rc": rc, "statuses": st, "iterations": its,
           "sequential_iterations": [r[1] for r in ref],
           "x_max_rel_diff": worst, "local_service": local,
           "fleet_front": fleet, "solve_and_read_s": secs}
    check(rc == C.RC_OK and st == [0] * len(sh) and fleet and not local
          and its == [r[1] for r in ref] and worst <= 1e-10,
          f"fleet e capi: {out}")
    return out


PHASES = ("kernels", "bench_pcg", "bench_pcg_matrix_free",
          "fgmres_aggregation", "pcg_classical", "pcg_classical_cheby",
          "idr_dilu", "gmres_ilu0", "pbicgstab_agg_w", "amg_classical_kcycle",
          "pcg_agg_resetup", "refine_bf16_256", "mf_bf16", "classical_bf16",
          "device_match", "block4_amg_pcg", "eigensolvers", "setup_store",
          "capi", "capi_complex", "serve", "sessions", "faults_telemetry",
          "gateway", "fleet")
NEEDS = {"bench_pcg_matrix_free": ("bench_pcg",),
         "faults_telemetry": ("bench_pcg",)}


def cpu_side_calls(phases):
    """The CPU runs of ``phases`` that wait for nothing of the card, as
    the phases read them from :data:`CPU` (each phase's own sizes), in
    run order."""
    f32, f64 = np.float32, np.float64
    n = SLICE_N
    calls = {
        "bench_pcg": [(cpu_solve, BENCH_CFG, n, f32),
                      (cpu_solve, BENCH_CFG, 64, f64),
                      (cpu_solve, ENTRY_CFG, 16, f32)],
        "bench_pcg_matrix_free": [(cpu_solve, MF_CFG, n, f32, MF_FORMATS),
                                  (cpu_solve, MF_CFG, 64, f64, MF_FORMATS)],
        "fgmres_aggregation": [(fgmres_cpu_side, n),
                               (cpu_solve, FGMRES_CFG, 64, f64)] + [
            (cpu_solve, cfg, 32, f32) for _, cfg in solver_matrix()],
        "pcg_classical": [(cpu_solve, PCG_CLASSICAL, 64, f32),
                          (cpu_solve, PCG_CLASSICAL, 48, f64),
                          (cpu_solve, PCG_CLASSICAL, 64, f64)] + [
            (cpu_solve, classical_cfg(extra), m, f32)
            for _, extra, m in classical_paths(64, 32)] + [
            (classical_rcm_cpu, 32)],
        "pcg_classical_cheby": [(cpu_solve, PCG_CLASSICAL_CHEB, n, f32)],
        "idr_dilu": [(cpu_solve, IDR_DILU_CFG, 96, f32),
                     (cpu_solve, IDR_DILU_CFG, 64, f64)],
        "gmres_ilu0": [(gmres_cpu_side, 108), (gmres_cpu_side, 64)],
        "pbicgstab_agg_w": [(cpu_solve, PBICGSTAB_AGG_W_CFG, n, f32),
                            (cpu_solve, PBICGSTAB_AGG_W_CFG, 64, f64)],
        "amg_classical_kcycle": [(cpu_solve, AMG_CLASSICAL_CG_CFG, 64, f32),
                                 (cpu_solve, KCYCLE_DEVICE_CFG, 64, f64)],
        "pcg_agg_resetup": [
            (cpu_reuse, cfg, n, f32, kind, formats, False)
            for _, cfg, kind, formats in RESETUP_HALVES] + [
            (cpu_reuse, REUSE_CFG, 64, f64, "diffusion", None, True),
            (cpu_reuse, CLASSICAL_REUSE_CFG, 64, f64, "diffusion", None,
             True)],
        "refine_bf16_256": [(refine_cpu, REFINE_BF16_CFG, 64, f32),
                            (refine_cpu, CHEAP_CFG, 64, f64),
                            (refine_cpu, CHEAP_COARSE_CFG, 64, f64)],
        "classical_bf16": [(cpu_solve, CLASSICAL_BF16_CFG, 96, f32)],
        "device_match": [(host_match, "poisson", n),
                         (host_match, "shuffled", n),
                         (cpu_solve, SIZE2_MATCH_CFG, 64, f64, None, True)],
        "block4_amg_pcg": [(block4_cmp_f32, "cpu", 32),
                           (block4_cmp_f64, "cpu", 12)],
        "eigensolvers": [(eig_cmp_cpu, EIG_CMP_N, PAGERANK_CMP_NODES, share)
                         for share in EIG_CPU_SPLIT],
        "capi": [(capi_cpu_side, CAPI_CMP_N, CAPI_SELL_N)],
        "capi_complex": [(capi_complex_cpu_side, CX_CMP_N)],
        "serve": [(serve_cpu_side, SERVE_CPU_N)],
        "sessions": [(session_cpu_side, SESSION_CPU_N)],
        "faults_telemetry": [(zero_pivot_cpu, FT_N)],
        "gateway": [(gateway_cpu_side, GATEWAY_CPU_N)],
    }
    return [c for p in phases for c in calls.get(p, ())]


def child_threads(torch, calls):
    """The torch threads of each CPU run of ``calls`` in the child: a
    few for the runs that sit beside long card work, else as many as
    the card's own process has."""
    few = (block4_cmp_f32, block4_cmp_f64, eig_cmp_cpu, capi_cpu_side,
           capi_complex_cpu_side, serve_cpu_side, session_cpu_side,
           gateway_cpu_side)
    return [CHILD_THREADS if c[0] in few else torch.get_num_threads()
            for c in calls]


def selected_phases(argv):
    """The phases of ``--phases a,b,...`` (with those they need), in
    run order; every phase without the option."""
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch "
                                 "port on one card.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (default: all): "
                    + ", ".join(PHASES))
    args = ap.parse_args(argv)
    if args.phases is None:
        return PHASES
    want = set()
    for name in args.phases.split(","):
        name = name.strip()
        if name not in PHASES:
            ap.error(f"unknown phase {name!r}")
        want |= {name, *NEEDS.get(name, ())}
    return tuple(p for p in PHASES if p in want)


def main(argv=None):
    try:
        return _main(argv)
    finally:
        CPU.end()


def _main(argv=None):
    phases = selected_phases(sys.argv[1:] if argv is None else argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import amgx_tpu_torch  # noqa: F401
    from amgx_tpu_torch.ops import kernels

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    peaks = peaks_for(kind)
    skipped = [p for p in PHASES if p not in phases]
    if skipped:
        print(json.dumps({"phases": list(phases), "skipped_phases": skipped}),
              flush=True)

    t0 = time.perf_counter()
    paths = kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(paths))})", flush=True)
    for name in sorted(paths):
        report = (kernels.BUILD_DIR / f"{name}.ptxas.txt").read_text()
        for line in report.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    recs = []
    by_path = {}
    variants_by_path = {}
    calls = cpu_side_calls(phases)
    CPU.start(calls, child_threads(torch, calls))
    if "kernels" in phases:
        recs += timed("kernels", kernel_phase, torch, peaks)
    ref = None
    if "bench_pcg" in phases:
        by_path["bench_pcg"], ref = timed("bench_pcg", slice_phase, torch)
    if "bench_pcg_matrix_free" in phases:
        by_path["bench_pcg_matrix_free"] = timed(
            "bench_pcg_matrix_free", mf_slice_phase, torch, ref)
    if "fgmres_aggregation" in phases:
        by_path["fgmres_aggregation"] = timed("fgmres_aggregation",
                                              fgmres_phase, torch)
    for name, phase in (("pcg_classical", classical_phase),
                        ("pcg_classical_cheby", cheby_phase)):
        if name in phases:
            by_path[name], more = timed(name, phase, torch, peaks)
            recs += more
    for name, phase in (("idr_dilu", idr_phase),
                        ("gmres_ilu0", gmres_ilu_phase),
                        ("pbicgstab_agg_w", pbicgstab_w_phase),
                        ("amg_classical_kcycle", kcycle_phase),
                        ("pcg_agg_resetup", resetup_phase)):
        if name in phases:
            by_path[name] = timed(name, phase, torch)
    # the reduced-precision paths: launches per entry point
    for name, phase in (("refine_bf16_256", refine_phase),
                        ("mf_bf16", mf_bf16_phase),
                        ("classical_bf16", classical_bf16_phase)):
        if name in phases:
            got, v_recs = timed(name, phase, torch, peaks)
            variants_by_path.update(got)
            recs += v_recs
    if "device_match" in phases:
        variants_by_path.update(timed("device_match", device_match_phase,
                                      torch))
    if "block4_amg_pcg" in phases:
        by_path["block4_amg_pcg"], b_recs = timed(
            "block4_amg_pcg", block4_amg_phase, torch, peaks)
        recs += b_recs
    if "eigensolvers" in phases:
        by_path["eigensolvers"], e_recs = timed("eigensolvers", eigen_phase,
                                                torch, peaks)
        recs += e_recs
    if "setup_store" in phases:
        by_path["setup_store"] = timed("setup_store", store_phase, torch)
    if "capi" in phases:
        got, c_recs, by_path["capi"] = timed("capi", capi_phase, torch,
                                             peaks)
        variants_by_path.update(got)
        recs += c_recs
    if "capi_complex" in phases:
        got, x_recs = timed("capi_complex", capi_complex_phase, torch, peaks)
        variants_by_path.update(got)
        recs += x_recs
    # the gateway and fleet phases warm-boot serve a's entry where they
    # run after it
    handoff = (store_dir() if "serve" in phases and (
        "gateway" in phases or "fleet" in phases) else None)
    # serve a's systems, reference and walk, for the fleet phase
    serve_a = {} if "fleet" in phases else None
    if "serve" in phases:
        variants_by_path.update(timed(
            "serve", lambda t: serve_phase(t, handoff=handoff, keep=serve_a),
            torch))
    if "sessions" in phases:
        variants_by_path.update(timed("sessions", session_phase, torch))
    if "faults_telemetry" in phases:
        by_path["faults_telemetry"] = timed("faults_telemetry",
                                            faults_phase, torch, ref)
    if "gateway" in phases:
        variants_by_path.update(timed(
            "gateway", lambda t: gateway_phase(t, store=handoff), torch))
    if "fleet" in phases:
        variants_by_path.update(timed(
            "fleet", lambda t: fleet_phase(t, store=handoff,
                                           serve_a=serve_a), torch))
    if handoff is not None:
        import shutil

        shutil.rmtree(handoff, ignore_errors=True)

    # each kernel: the path whose count is its ``launches``, the case
    # whose times the summary gives, its source and the TPU kernel
    well = "amgx_tpu/ops/pallas_well.py:160"
    main_case = {
        "dia_spmv": ("bench_pcg", f"level0 A {SLICE_N}^3 f32",
                     "amgx_tpu_torch/csrc/dia_spmv.cu",
                     "amgx_tpu/ops/pallas_dia.py:76"),
        "ell_spmv": ("bench_pcg", f"level0 R {(SLICE_N // 2) ** 3}x"
                     f"{SLICE_N ** 3} w=8 f32",
                     "amgx_tpu_torch/csrc/ell_spmv.cu", well),
        "sell_spmv": ("pcg_classical", "classical level1 A ",
                      "amgx_tpu_torch/csrc/ell_spmv.cu", well),
        "stencil_spmv": ("bench_pcg_matrix_free",
                         f"level0 A {SLICE_N}^3 f32",
                         "amgx_tpu_torch/csrc/stencil_spmv.cu",
                         "amgx_tpu/ops/pallas_stencil.py:64"),
    }
    # the device times the profiler did not record (null in the cases)
    print(json.dumps({"device_time_not_measured": [
        f"{r['case']} ({r['kernel']}): {k}" for r in recs
        for k, v in r.items() if k.endswith("device_ms") and v is None]}),
        flush=True)
    launch_checks = (("bench_pcg", ("dia_spmv", "ell_spmv")),
                     ("pcg_classical", ("dia_spmv", "sell_spmv")),
                     ("pcg_classical_cheby", ("dia_spmv", "sell_spmv")),
                     ("idr_dilu", ("dia_spmv",)),
                     ("gmres_ilu0", ("dia_spmv",)),
                     ("pbicgstab_agg_w", ("dia_spmv", "ell_spmv")),
                     ("amg_classical_kcycle",
                      ("dia_spmv", "sell_spmv", "ell_spmv")),
                     ("pcg_agg_resetup",
                      ("dia_spmv", "ell_spmv", "stencil_spmv")),
                     ("block4_amg_pcg", ("dia_spmv", "sell_spmv",
                                         "ell_spmv")),
                     ("eigensolvers", ("dia_spmv", "ell_spmv")),
                     ("setup_store", ("dia_spmv", "ell_spmv", "sell_spmv",
                                      "stencil_spmv")),
                     ("capi", ("dia_spmv", "ell_spmv")),
                     ("faults_telemetry", ("dia_spmv", "ell_spmv")))
    not_checked = []
    for path, kernels_of in launch_checks:
        if path not in by_path:
            not_checked += [f"{name} on {path}" for name in kernels_of]
            continue
        for name in kernels_of:
            check(by_path[path][name] > 0,
                  f"{name} never launched on the {path} path")
    summary = []
    for name, (path, case, source, replaces) in main_case.items():
        rec = next((r for r in recs if r["kernel"] == name and (
            r["case"] == case or (case.endswith(" ") and r["case"]
                                  .startswith(case) and r["dtype"] == "f32"
                                  and "RCM" not in r["case"]))), None)
        if path not in by_path or rec is None:
            not_checked.append(f"kernel summary of {name} ({path})")
            continue
        check(by_path[path][name] > 0,
              f"{name} never launched on its main path ({path})")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": by_path[path][name],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "case": rec["case"],
            "launches_path": path,
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
        })
    for name, (source, replaces, path, case) in VARIANTS.items():
        rec = next((r for r in recs if r["kernel"] == name
                    and r["case"].startswith(case)), None)
        if path not in variants_by_path or rec is None:
            not_checked.append(f"kernel summary of {name} ({path})")
            continue
        got = variants_by_path[path].get(name, 0)
        check(got > 0, f"{name} never launched on its main path ({path})")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": got,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "case": rec["case"],
            "launches_path": path,
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in variants_by_path.items()},
        })
    # the started CPU runs no phase read (a phase asked with other
    # arguments and ran its own)
    print(json.dumps({"cpu_side_unread": [
        f"{c[0].__name__}{c[1:]!r}"[:160] for c in CPU.jobs]}), flush=True)
    # a run of every phase checks everything; a selection names what it
    # left unchecked before it prints its result
    check(not not_checked or skipped,
          f"unchecked with every phase run: {not_checked}")
    if not_checked:
        print(json.dumps({"not_checked_phases_skipped": not_checked}),
              flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-worker"]:
        sys.exit(fleet_worker(sys.argv[2:]))
    sys.exit(main())
