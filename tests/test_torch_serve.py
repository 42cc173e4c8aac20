"""The port's batched solve service (``amgx_tpu_torch.serve``) against
the JAX package's (``amgx_tpu.serve``) on the CPU: bucketing, the
batched plain SpMVs, the batched dots and norms, the batch rebuilds
(``make_batch_params``), the flows of ``tests/test_serve.py`` through
both packages, the sequential fallback, the C API's batched solve and
the refusals.

Tolerances (the port's parity rules, ROADMAP.md): a single SpMV to rtol
1e-12 in f64 and 2e-5 in f32; rebuilt level values and dense LU factors
to rtol 1e-12; a whole solve's x to rtol 1e-10 in f64, with statuses,
iterations and the service counters equal.  Batched forms against the
port's own unbatched forms (the plain SpMVs, ``replace_values``, the
Galerkin plans) are held bit for bit.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
from amgx_tpu.serve import BatchedSolveService as JService
from amgx_tpu.serve import COMM_AVOIDING_CONFIG as J_COMM
from amgx_tpu.serve import bucketing as jbuck
from amgx_tpu_torch.config.amg_config import AMGConfig
from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.io.poisson import jittered_poisson_family, poisson_scipy
from amgx_tpu_torch.ops import dia as tdia
from amgx_tpu_torch.ops import ell as tell
from amgx_tpu_torch.ops.blas import dot, fused_dots
from amgx_tpu_torch.ops.norms import norm
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.serve import (
    COMM_AVOIDING_CONFIG,
    DEFAULT_CONFIG,
    BatchedSolveService,
    SolveService,
)
from amgx_tpu_torch.serve import bucketing as tbuck
from amgx_tpu_torch.solvers.registry import create_solver, make_nested

amgx_tpu.initialize()

PCG_AMG = (
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
GMRES_CFG = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "GMRES", "max_iters": 150, "gmres_n_restart": 30,'
    ' "tolerance": 1e-8, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI",'
    ' "preconditioner": "NOSOLVER"}}'
)
# the counters both packages keep with the same meaning
COUNTERS = ("batches", "setups", "compiles", "fallback_solves",
            "quarantines", "poisoned_requests", "quarantined_solves",
            "breaker_trips", "breaker_bypasses", "failed_groups",
            "deadline_expired", "validation_rejects", "bucket_hits",
            "cache_hits", "submitted", "solved")


def counters(svc):
    snap = svc.metrics.snapshot()
    return {k: snap.get(k, 0) for k in COUNTERS}


def tsvc(cfg=DEFAULT_CONFIG, **kw):
    return BatchedSolveService(config=cfg, device="cpu", **kw)


def jsvc(cfg=DEFAULT_CONFIG, **kw):
    return JService(config=cfg, **kw)


def host_x(r):
    x = r.x
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same_results(tr, jr, rtol=1e-10):
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        assert int(a.status) == int(b.status)
        assert int(a.iters) == int(b.iters)
        xb = host_x(b)
        np.testing.assert_allclose(host_x(a), xb, rtol=0,
                                   atol=rtol * max(np.abs(xb).max(), 1e-300))


def both(systems, cfg=DEFAULT_CONFIG, **kw):
    """Solve ``systems`` through both services: (port results, JAX
    results, port service, JAX service)."""
    ts, js = tsvc(cfg, **kw), jsvc(cfg, **kw)
    tr, jr = ts.solve_many(systems), js.solve_many(systems)
    return tr, jr, ts, js


def irregular_sp(n, seed):
    """SPD matrix with rows of varying length (an ELL, not DIA,
    template)."""
    rng = np.random.default_rng(seed)
    A = sps.random(n, n, density=4.0 / n, random_state=rng, format="csr")
    A = abs(A + A.T) * 0.1
    A = A + sps.diags_array(np.asarray(abs(A).sum(axis=1)).ravel() + 1.0)
    A = A.tocsr()
    A.sort_indices()
    return A


# ---------------------------------------------------------------------
# bucketing


@pytest.mark.parametrize("case", ["poisson_9x7", "poisson_16x16",
                                  "irregular_100"])
def test_pad_pattern_matches_jax(case):
    sp = {"poisson_9x7": lambda: poisson_scipy((9, 7)),
          "poisson_16x16": lambda: poisson_scipy((16, 16)),
          "irregular_100": lambda: irregular_sp(100, 3)}[case]().tocsr()
    n = sp.shape[0]
    tp = tbuck.pad_pattern(sp.indptr, sp.indices, n)
    jp = jbuck.pad_pattern(sp.indptr, sp.indices, n)
    for f in ("row_offsets", "col_indices", "scatter", "ones_pos"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    for f in ("n", "nnz", "nb", "nnzb", "max_row_len", "num_diagonals",
              "fingerprint"):
        assert getattr(tp, f) == getattr(jp, f), f
    vals = np.random.default_rng(0).standard_normal(sp.nnz)
    np.testing.assert_array_equal(tp.embed_values(vals),
                                  jp.embed_values(vals))
    np.testing.assert_array_equal(tp.extract_values(tp.embed_values(vals)),
                                  vals)
    b = np.arange(n, dtype=np.float64)
    np.testing.assert_array_equal(tp.embed_vector(b, np.float64),
                                  jp.embed_vector(b, np.float64))
    # the padded system acts as the original on its rows
    Ap = sps.csr_matrix((tp.embed_values(vals), tp.col_indices,
                         tp.row_offsets), shape=(tp.nb, tp.nb))
    x = np.random.default_rng(1).standard_normal(tp.nb)
    x[n:] = 0.0
    spv = sps.csr_matrix((vals, sp.indices, sp.indptr), shape=sp.shape)
    np.testing.assert_allclose((Ap @ x)[:n], spv @ x[:n], rtol=1e-13)


def test_bucket_batch_matches_jax():
    for b in (1, 2, 3, 5, 16, 17, 100, 128, 129, 200, 1000):
        assert tbuck.bucket_batch(b) == jbuck.bucket_batch(b)
    assert [tbuck.bucket_size(x, 64) for x in (1, 64, 65, 1000)] == [
        jbuck.bucket_size(x, 64) for x in (1, 64, 65, 1000)]


def test_staging_slot_matches_jax():
    sp = poisson_scipy((9, 7)).tocsr()
    n = sp.shape[0]
    tp = tbuck.pad_pattern(sp.indptr, sp.indices, n)
    jp = jbuck.pad_pattern(sp.indptr, sp.indices, n)
    ts, js = tbuck.StagingSlot(tp, np.float64, 4), jbuck.StagingSlot(
        jp, np.float64, 4)
    rng = np.random.default_rng(2)
    for i in range(2):
        v, b = rng.standard_normal(sp.nnz), rng.standard_normal(n)
        x0 = rng.standard_normal(n) if i else None
        ts.write_row(i, v, b, x0)
        js.write_row(i, v, b, x0)
    ts.fill_batch_padding(2, 4)
    js.fill_batch_padding(2, 4)
    for f in ("vals", "bs", "x0s"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    assert (ts.x0_used, ts.x0_dirty) == (js.x0_used, js.x0_dirty)


@pytest.mark.parametrize("case,fmt", [("poisson_16x16", "DIA"),
                                      ("irregular_100", "ELL"),
                                      ("dense_100", "dense")])
def test_template_formats_match_jax(case, fmt):
    if case == "dense_100":
        # rows of about 90 entries: wider than the ELL gate
        rng = np.random.default_rng(4)
        d = rng.standard_normal((100, 100)) * (rng.random((100, 100)) < 0.8)
        sp = sps.csr_matrix(d + d.T + 200 * np.eye(100))
    else:
        sp = {"poisson_16x16": lambda: poisson_scipy((16, 16)),
              "irregular_100": lambda: irregular_sp(100, 3)}[case]()
    sp = sp.tocsr()
    sp.sort_indices()
    tp = tbuck.pad_pattern(sp.indptr, sp.indices, sp.shape[0])
    jp = jbuck.pad_pattern(sp.indptr, sp.indices, sp.shape[0])
    ta, ja = tsvc()._accel_for(tp), jsvc()._accel_for(jp)
    assert ta == ja
    A = tp.template_matrix(sp.data, np.float64, accel_formats=ta,
                           device="cpu")
    # an ELL template keeps the sliced layout its batched SpMVs take
    assert A.format == fmt and (A.sell is not None) == (fmt == "ELL")
    JA = jp.template_matrix(sp.data, np.float64, accel_formats=ja)
    np.testing.assert_allclose(A.to_dense(), np.asarray(JA.to_dense()),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------
# batched kernels' plain versions, dots and norms


def _jax_vmap_dia(planes, offsets, xs, shared):
    import jax
    import jax.numpy as jnp

    from amgx_tpu.ops.spmv import _spmv_dia

    def one(p, x):
        A = type("A", (), {"n_rows": x.shape[0], "dia_offsets": offsets,
                           "dia_vals": p})()
        return _spmv_dia(A, x)

    return np.asarray(jax.vmap(one, in_axes=(None if shared else 0, 0))(
        jnp.asarray(planes), jnp.asarray(xs)))


def _jax_vmap_ell(cols_rm, vals_rm, xs, shared):
    """The JAX package's ELL XLA path (row-major (n, w) arrays) under
    vmap: sum over the slots of vals * x[cols]."""
    import jax
    import jax.numpy as jnp

    def one(v, x):
        return jnp.sum(v * x[jnp.asarray(cols_rm)], axis=1)

    return np.asarray(jax.vmap(one, in_axes=(None if shared else 0, 0))(
        jnp.asarray(vals_rm), jnp.asarray(xs)))


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 2e-5)])
@pytest.mark.parametrize("shared", [False, True])
def test_dia_batched_plain_matches_jax_vmap(dtype, rtol, shared):
    rng = np.random.default_rng(5)
    B, n, offsets = 4, 120, (-12, -1, 0, 1, 12)
    planes = rng.standard_normal(
        ((len(offsets), n) if shared else (B, len(offsets), n))
    ).astype(dtype)
    xs = rng.standard_normal((B, n)).astype(dtype)
    y = tdia.dia_spmv_batched(torch.from_numpy(planes), offsets,
                              torch.from_numpy(xs)).numpy()
    yj = _jax_vmap_dia(planes, offsets, xs, shared)
    np.testing.assert_allclose(y, yj, rtol=rtol, atol=rtol * np.abs(yj).max())
    for i in range(B):
        one = tdia.dia_spmv(torch.from_numpy(planes if shared else planes[i]),
                            offsets, torch.from_numpy(xs[i])).numpy()
        np.testing.assert_array_equal(y[i], one)
    assert tdia.batched_launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 2e-5)])
@pytest.mark.parametrize("shared,m", [(False, 90), (True, 90),
                                      (True, 37)])
def test_ell_batched_plain_matches_jax_vmap(dtype, rtol, shared, m):
    rng = np.random.default_rng(6)
    B, n, w = 3, 90, 5
    cols_rm = rng.integers(0, m, size=(n, w)).astype(np.int32)
    vals_rm = rng.standard_normal(((n, w) if shared else (B, n, w))).astype(
        dtype)
    xs = rng.standard_normal((B, m)).astype(dtype)
    cols = torch.from_numpy(np.ascontiguousarray(cols_rm.T))
    vals = torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(vals_rm, -1, -2)))
    y = tell.ell_spmv_batched(cols, vals, torch.from_numpy(xs)).numpy()
    yj = _jax_vmap_ell(cols_rm, vals_rm, xs, shared)
    np.testing.assert_allclose(y, yj, rtol=rtol, atol=rtol * np.abs(yj).max())
    for i in range(B):
        one = tell.ell_spmv(cols, vals if shared else vals[i],
                            torch.from_numpy(xs[i])).numpy()
        np.testing.assert_array_equal(y[i], one)
    assert tell.batched_launches == 0


def test_batched_dots_and_norms_match_per_instance():
    from amgx_tpu_torch.core.types import NormType

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((5, 200)))
    y = torch.from_numpy(rng.standard_normal((5, 200)))
    d = dot(x, y)
    assert d.shape == (5, 1)
    for i in range(5):
        np.testing.assert_allclose(float(d[i, 0]), float(dot(x[i], y[i])),
                                   rtol=1e-13)
    fd = fused_dots(((x, y), (y, y)))
    assert fd.shape == (2, 5, 1)
    np.testing.assert_allclose(fd[1].numpy(), dot(y, y).numpy(), rtol=1e-13)
    assert fused_dots(((x[0], y[0]), (y[0], y[0]))).shape == (2,)
    for nt in NormType:
        nb = norm(x, nt)
        assert nb.shape == (5, 1)
        for i in range(5):
            np.testing.assert_allclose(float(nb[i, 0]), float(norm(x[i], nt)),
                                       rtol=1e-13)


# ---------------------------------------------------------------------
# batched views, batched SpMV dispatch and Galerkin plans


@pytest.mark.parametrize("formats,fmt", [(("dia",), "DIA"),
                                         (("ell",), "ELL"),
                                         (("dense",), "dense"),
                                         ((), "CSR")])
def test_replace_values_batched_and_spmv_match_per_instance(formats, fmt):
    sp = poisson_scipy((7, 6)).tocsr()
    if fmt == "ELL":
        sp = irregular_sp(42, 8)
    A = SparseMatrix.from_scipy(sp, accel_formats=formats, device="cpu")
    assert A.format == fmt
    rng = np.random.default_rng(9)
    V = torch.from_numpy(rng.standard_normal((3, A.nnz)))
    X = torch.from_numpy(rng.standard_normal((3, A.n_cols)))
    Ab = A.replace_values_batched(V)
    # the view keeps A's sliced layout where A has one
    assert Ab.batch == 3 and (Ab.sell is None) == (A.sell is None)
    Y = spmv(Ab, X)
    for i in range(3):
        Ai = A.replace_values(V[i])
        np.testing.assert_array_equal(Ab.diag[i].numpy(), Ai.diag.numpy())
        for name in ("dia_vals", "ell_vals", "dense"):
            # a sliced view keeps no slot-major values (its SpMVs take
            # ``sell``)
            if getattr(Ai, name) is not None and not (
                    name == "ell_vals" and Ab.sell is not None):
                np.testing.assert_array_equal(
                    getattr(Ab, name)[i].numpy(), getattr(Ai, name).numpy())
        np.testing.assert_allclose(Y[i].numpy(), spmv(Ai, X[i]).numpy(),
                                   rtol=1e-14, atol=1e-14)
    # a matrix shared by every instance (AMG's transfers) with a batch x
    Ys = spmv(A, X)
    for i in range(3):
        np.testing.assert_allclose(Ys[i].numpy(), spmv(A, X[i]).numpy(),
                                   rtol=1e-14, atol=1e-14)


def test_batched_view_refusals():
    A = SparseMatrix.from_scipy(poisson_scipy((4, 4)), device="cpu")
    with pytest.raises(ValueError):
        A.replace_values_batched(torch.zeros(A.nnz))
    Ab = A.replace_values_batched(torch.zeros((2, A.nnz),
                                              dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        Ab.replace_values_batched(torch.zeros((2, A.nnz)))
    with pytest.raises(ValueError):
        spmv(Ab, torch.zeros((3, 16), dtype=torch.float64))


def test_spgemm_plan_apply_batched_is_per_instance_bitwise():
    from amgx_tpu_torch.amg.spgemm import plan_rap

    A = poisson_scipy((6, 6)).tocsr()
    P = sps.csr_matrix((np.ones(36), np.arange(36) // 4,
                        np.arange(37)), shape=(36, 9))
    R = P.T.tocsr()
    Ac = (R @ A @ P).tocsr()
    Ac.sort_indices()
    plan = plan_rap(R, A, P, Ac, device="cpu")
    rng = np.random.default_rng(10)
    av = torch.from_numpy(rng.standard_normal((4, A.nnz)))
    rv, pv = torch.from_numpy(R.data), torch.from_numpy(P.data)
    out = plan.apply(rv, av, pv)
    assert out.shape == (4, Ac.nnz)
    for i in range(4):
        np.testing.assert_array_equal(out[i].numpy(),
                                      plan.apply(rv, av[i], pv).numpy())


def test_aggregation_sums_duplicate_entries_as_jax():
    """Repair: a padded template stores zero-valued duplicates of each
    row's last entry.  The JAX package sums the finest operator's
    duplicates before aggregation (its host arrays are read-only), the
    port aggregated the raw entries, whose zeros lowered the axis
    strengths and changed the geometric blocks (P differed at this
    seed); now both sum them, and the hierarchies agree."""
    from amgx_tpu.config.amg_config import AMGConfig as JConfig
    from amgx_tpu.core.matrix import SparseMatrix as JMatrix
    from amgx_tpu.solvers.registry import create_solver as jcreate

    sp0 = jittered_poisson_family((16, 16), 1, seed=17, jitter=0.05)[0][0]
    pat = tbuck.pad_pattern(sp0.indptr, sp0.indices, 256)
    v = pat.embed_values(sp0.data, np.float64)
    A = SparseMatrix.from_csr(pat.row_offsets, pat.col_indices, v,
                              device="cpu")
    JA = JMatrix.from_csr(pat.row_offsets, pat.col_indices, v)
    ts = create_solver(AMGConfig.from_string(PCG_AMG), "default",
                       device="cpu")
    js = jcreate(JConfig.from_string(PCG_AMG), "default")
    ts.setup(A)
    js.setup(JA)
    tl, jl = ts.precond.levels, js.precond.levels
    assert len(tl) == len(jl)
    np.testing.assert_array_equal(tl[0].P.to_dense(),
                                  np.asarray(jl[0].P.to_dense()))
    np.testing.assert_allclose(tl[1].A.to_dense(),
                               np.asarray(jl[1].A.to_dense()), rtol=1e-14)
    # the host triple the setup read is left as it was
    assert A._host[1].shape[0] == pat.nnzb


# ---------------------------------------------------------------------
# batch rebuilds against the JAX package's under jax.vmap


def _padded_setup(cfg, shape, B):
    """Both packages' solvers set up on one padded template, and B
    padded coefficient sets."""
    from amgx_tpu.core.matrix import SparseMatrix as JMatrix
    from amgx_tpu.solvers.registry import create_solver as jcreate
    from amgx_tpu.solvers.registry import make_nested as jnested

    systems = jittered_poisson_family(shape, B, seed=11)
    sp0 = systems[0][0]
    pat = tbuck.pad_pattern(sp0.indptr, sp0.indices, sp0.shape[0])
    tacc = tsvc(cfg)._accel_for(pat)
    A = pat.template_matrix(sp0.data, np.float64, accel_formats=tacc,
                            device="cpu")
    ts = make_nested(create_solver(AMGConfig.from_string(cfg), "default",
                                   device="cpu"))
    ts.setup(A)
    from amgx_tpu.config.amg_config import AMGConfig as JConfig

    jpat = jbuck.pad_pattern(sp0.indptr, sp0.indices, sp0.shape[0])
    JA = jpat.template_matrix(sp0.data, np.float64,
                              accel_formats=jsvc(cfg)._accel_for(jpat))
    js = jnested(jcreate(JConfig.from_string(cfg), "default"))
    js.setup(JA)
    vals = np.stack([pat.embed_values(sp.data, np.float64)
                     for sp, _ in systems])
    del JMatrix
    return ts, js, vals


def test_make_batch_params_amg_matches_jax():
    import jax
    import jax.numpy as jnp

    ts, js, vals = _padded_setup(PCG_AMG, (16, 16, 16), 4)
    tt, tfn = ts.precond.make_batch_params()
    jt, jfn = js.precond.make_batch_params()
    t_levels, t_coarse = tfn(tt, torch.from_numpy(vals))
    j_levels, j_coarse = jax.vmap(lambda v: jfn(jt, v))(jnp.asarray(vals))
    assert len(t_levels) == len(j_levels) >= 3
    for (tA, _, _, tsm), (jA, _, _, jsm) in zip(t_levels, j_levels):
        assert tA.batch == 4
        np.testing.assert_allclose(tA.values.numpy(), np.asarray(jA.values),
                                   rtol=1e-12, atol=1e-14)
        if tsm is not None:
            # BLOCK_JACOBI: the inverted diagonals
            np.testing.assert_allclose(tsm[1].numpy(), np.asarray(jsm[1]),
                                       rtol=1e-12)
    _, tlu, tpiv = t_coarse
    _, jlu, jpiv = j_coarse
    np.testing.assert_allclose(tlu.numpy(), np.asarray(jlu), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_array_equal(tpiv.numpy() - 1, np.asarray(jpiv))


def test_make_batch_params_dense_lu_matches_jax():
    import jax
    import jax.numpy as jnp

    cfg = ('{"config_version": 2, "solver": {"scope": "main",'
           ' "solver": "DENSE_LU_SOLVER"}}')
    ts, js, vals = _padded_setup(cfg, (5, 5), 4)
    tt, tfn = ts.make_batch_params()
    jt, jfn = js.make_batch_params()
    _, tlu, tpiv = tfn(tt, torch.from_numpy(vals))
    _, jlu, jpiv = jax.vmap(lambda v: jfn(jt, v))(jnp.asarray(vals))
    assert tlu.shape == (4, 64, 64)
    np.testing.assert_allclose(tlu.numpy(), np.asarray(jlu), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_array_equal(tpiv.numpy() - 1, np.asarray(jpiv))


def test_unported_rebuilds_return_none():
    """Solvers without an iteration protocol run in turn: GMRES (and
    IDR, ``tests/test_torch_serve_rebuilds.py``).  COMM_AVOIDING_CONFIG
    batches since its rebuilds landed."""
    sp = poisson_scipy((8, 8)).tocsr()
    A = SparseMatrix.from_scipy(sp, device="cpu")
    for cfg in (GMRES_CFG,):
        s = create_solver(AMGConfig.from_string(cfg), "default",
                          device="cpu")
        s.setup(A)
        from amgx_tpu_torch.serve import make_batched_solve

        assert make_batched_solve(s) is None


# ---------------------------------------------------------------------
# the service through both packages (tests/test_serve.py's flows)


def test_batched_pcg_jacobi_matches_jax_and_sequential():
    systems = jittered_poisson_family((10, 10), 16, seed=0)
    tr, jr, ts, js = both(systems, max_batch=32)
    same_results(tr, jr)
    assert counters(ts) == counters(js)
    assert ts.metrics.get("batches") == 1
    assert ts.metrics.get("fallback_solves") == 0
    cfg = AMGConfig.from_string(DEFAULT_CONFIG)
    for (sp, b), r in zip(systems, tr):
        s = make_nested(create_solver(cfg, "default", device="cpu"))
        s.setup(SparseMatrix.from_scipy(sp, device="cpu"))
        ref = s.solve(b)
        assert int(r.status) == 0 and int(r.iters) == int(ref.iters)
        np.testing.assert_allclose(host_x(r), ref.x.numpy(), rtol=0,
                                   atol=1e-12)


def test_batched_amg_matches_jax_and_resetup_reference():
    systems = jittered_poisson_family((16, 16), 8, seed=1, jitter=0.05)
    tr, jr, ts, js = both(systems, cfg=PCG_AMG, max_batch=16)
    same_results(tr, jr)
    assert counters(ts) == counters(js)
    assert ts.metrics.get("fallback_solves") == 0
    s = make_nested(create_solver(AMGConfig.from_string(PCG_AMG), "default",
                                  device="cpu"))
    s.setup(SparseMatrix.from_scipy(systems[0][0], device="cpu"))
    for (sp, b), r in zip(systems, tr):
        s.resetup(SparseMatrix.from_scipy(sp, device="cpu"))
        ref = s.solve(b)
        assert int(r.iters) == int(ref.iters)
        err = np.linalg.norm(host_x(r) - ref.x.numpy()) / np.linalg.norm(
            ref.x.numpy())
        assert err < 1e-12


def test_heterogeneous_sizes_group_and_solve_as_jax():
    systems = (jittered_poisson_family((10, 10), 6, seed=2)
               + jittered_poisson_family((13, 11), 6, seed=3)
               + jittered_poisson_family((6, 5), 6, seed=4))
    tr, jr, ts, js = both(systems, max_batch=32)
    same_results(tr, jr)
    assert counters(ts) == counters(js)
    assert ts.metrics.get("batches") == 3


def test_irregular_ell_template_matches_jax():
    rng = np.random.default_rng(12)
    base = irregular_sp(100, 3)
    systems = []
    for _ in range(4):
        sp = base.copy()
        sp.data = sp.data * (1.0 + 0.05 * rng.standard_normal(sp.nnz))
        systems.append((((sp + sp.T) * 0.5).tocsr(),
                        rng.standard_normal(100)))
    for sp, _ in systems:
        sp.sort_indices()
    tr, jr, ts, js = both(systems, max_batch=4)
    same_results(tr, jr)
    assert counters(ts) == counters(js)
    entry = next(iter(ts.cache._entries.values()))
    assert entry.solver.A.format == "ELL"


def _masked_systems():
    rng = np.random.default_rng(5)
    n = 64
    hard_base = poisson_scipy((8, 8)).tocsr()
    sp0 = hard_base.copy()
    sp0.data = sp0.data * 1e-3
    sp0 = (sp0 + sps.eye_array(n) * 4.0).tocsr()
    sp0.sort_indices()
    systems = [(sp0, rng.standard_normal(n))]
    for _ in range(7):
        sp = hard_base.copy()
        sp.data = sp.data * (1.0 + 0.05 * rng.standard_normal(sp.nnz))
        sp = ((sp + sp.T) * 0.5 + sps.eye_array(n) * 0.1).tocsr()
        sp.sort_indices()
        systems.append((sp, rng.standard_normal(n)))
    return systems


def test_masked_early_exit_freezes_converged_as_jax():
    systems = _masked_systems()
    tr, jr, ts, js = both(systems, max_batch=16)
    same_results(tr, jr)
    iters = [int(r.iters) for r in tr]
    assert iters[0] < max(iters)
    h = np.asarray(tr[0].history)
    assert np.all(np.isnan(h[iters[0] + 1:]))
    assert not np.any(np.isnan(h[:iters[0] + 1]))
    # frozen bit for bit: the easy system in a group of copies of itself
    # (the batched reductions then run at the same shape)
    solo = tsvc(max_batch=16).solve_many([systems[0]] * 8)
    np.testing.assert_array_equal(host_x(tr[0]), host_x(solo[0]))
    assert int(solo[0].iters) == iters[0]


def test_cache_hit_on_repeated_fingerprints_as_jax():
    systems = jittered_poisson_family((10, 10), 8, seed=6)
    ts, js = tsvc(max_batch=16), jsvc(max_batch=16)
    for svc in (ts, js):
        svc.solve_many(systems)
    m1 = counters(ts)
    assert m1 == counters(js)
    assert m1["setups"] == 1 and m1["compiles"] == 1
    systems2 = [(sps.csr_matrix((sp.data * 1.01, sp.indices, sp.indptr),
                                shape=sp.shape), b) for sp, b in systems]
    tr2, jr2 = ts.solve_many(systems2), js.solve_many(systems2)
    same_results(tr2, jr2)
    m2 = counters(ts)
    assert m2 == counters(js)
    assert m2["setups"] == 1 and m2["compiles"] == 1
    assert m2["cache_hits"] == m1["cache_hits"] + 1
    assert m2["bucket_hits"] == m1["bucket_hits"] + 1


def test_bucket_shared_across_patterns_as_jax():
    n = 80
    base = poisson_scipy((8, 10)).tocsr()

    def perm_family(seed):
        prng = np.random.default_rng(seed)
        p = prng.permutation(n)
        pbase = base[p][:, p].tocsr()
        pbase.sort_indices()
        out = []
        for _ in range(4):
            sp = pbase.copy()
            sp.data = sp.data * (1.0 + 0.05 * prng.standard_normal(sp.nnz))
            sp = ((sp + sp.T) * 0.5 + sps.eye_array(n) * 0.5).tocsr()
            sp.sort_indices()
            out.append((sp, prng.standard_normal(n)))
        return out

    sys_a, sys_b = perm_family(13), perm_family(14)
    ts, js = tsvc(max_batch=4), jsvc(max_batch=4)
    res = {}
    for name, svc in (("t", ts), ("j", js)):
        ra = svc.solve_many(sys_a)
        m1 = counters(svc)
        rb = svc.solve_many(sys_b)
        m2 = counters(svc)
        assert m2["setups"] == m1["setups"] + 1
        assert m2["compiles"] == m1["compiles"]
        assert m2["bucket_hits"] == m1["bucket_hits"] + 1
        res[name] = ra + rb
    same_results(res["t"], res["j"])
    assert counters(ts) == counters(js)


def test_fallback_gmres_as_jax():
    systems = jittered_poisson_family((7, 7), 3, seed=9)
    tr, jr, ts, js = both(systems, cfg=GMRES_CFG)
    same_results(tr, jr)
    assert ts.metrics.get("fallback_solves") == 3
    assert counters(ts) == counters(js)


def test_comm_avoiding_runs_in_turn_with_jax_results():
    """COMM_AVOIDING_CONFIG (s-step PCG over an OPT_POLYNOMIAL-smoothed
    AMG) runs as one batch, as in the JAX package, with its statuses
    and iterations, and x to 1.1e-9 of its largest entry: s-step PCG's
    Gram systems amplify the last bits, and the JAX package's own
    batched and sequential solves of these systems differ by up to
    1.08e-9 (ROADMAP.md, queue C: s-step PCG).  (The name is the one
    the test had while the config ran in turn.)"""
    systems = jittered_poisson_family((16, 16), 4, seed=14, jitter=0.05)
    ts, js = tsvc(COMM_AVOIDING_CONFIG, max_batch=8), jsvc(J_COMM,
                                                           max_batch=8)
    tr, jr = ts.solve_many(systems), js.solve_many(systems)
    same_results(tr, jr, rtol=1.1e-9)
    for (sp, b), r in zip(systems, tr):
        assert np.linalg.norm(b - sp @ host_x(r)) < 1e-8 * np.linalg.norm(b)
    assert counters(ts) == counters(js)
    assert ts.metrics.get("fallback_solves") == 0
    assert ts.metrics.get("batches") == 1


def test_max_batch_triggers_flush_as_jax():
    systems = jittered_poisson_family((10, 10), 5, seed=10)
    for svc in (tsvc(max_batch=4), jsvc(max_batch=4)):
        tickets = [svc.submit(sp, b) for sp, b in systems]
        assert tickets[3].done() and not tickets[4].done()
        assert svc.metrics.get("queue_depth") == 1
        svc.flush()
        assert tickets[4].done()
        assert svc.metrics.get("queue_depth") == 0


def test_ticket_result_flushes_lazily():
    (sp, b), = jittered_poisson_family((10, 10), 1, seed=11)
    svc = tsvc()
    t = svc.submit(sp, b)
    assert not t.done()
    res = t.result()
    assert t.done() and int(res.status) == 0
    assert isinstance(res.x, torch.Tensor) and res.x.shape == (100,)


def test_warm_start_and_deadline_free_flow_match_jax():
    systems = jittered_poisson_family((10, 10), 3, seed=15)
    rng = np.random.default_rng(3)
    with_x0 = [(sp, b, rng.standard_normal(b.shape[0])) for sp, b in systems]
    tr, jr, ts, js = both(with_x0, max_batch=4)
    same_results(tr, jr)
    for r, rj in zip(tr, jr):
        np.testing.assert_allclose(r.initial_norm, np.asarray(rj.initial_norm),
                                   rtol=1e-12)


def test_prewarm_eliminates_cold_start():
    systems = jittered_poisson_family((10, 10), 4, seed=28)
    svc = tsvc(max_batch=4)
    svc.prewarm(systems[0][0], batch=4).result(timeout=60)
    assert svc.metrics.get("prewarms") == 1
    assert svc.metrics.get("prewarm_failures") == 0
    setups, compiles = svc.metrics.get("setups"), svc.metrics.get("compiles")
    res = svc.solve_many(systems)
    assert all(int(r.status) == 0 for r in res)
    assert svc.metrics.get("setups") == setups
    assert svc.metrics.get("compiles") == compiles
    assert svc.metrics.get("bucket_hits") >= 1
    svc.stop()


def test_poller_flushes_by_max_wait():
    systems = jittered_poisson_family((10, 10), 2, seed=16)
    with tsvc(max_batch=8, max_wait_s=0.01) as svc:
        tickets = [svc.submit(sp, b) for sp, b in systems]
        for t in tickets:
            for _ in range(2000):
                if t.done():
                    break
                import time

                time.sleep(0.005)
            assert t.done()
        assert all(int(t.result().status) == 0 for t in tickets)
    assert svc._poller is None


def test_resetup_entry_solves_through_the_cached_hierarchy():
    systems = jittered_poisson_family((16, 16), 3, seed=17, jitter=0.05)
    ts, js = tsvc(PCG_AMG), jsvc(PCG_AMG)
    for svc in (ts, js):
        svc.solve_many(systems[:2])
    sp, b = systems[2]
    from amgx_tpu_torch.core.matrix import sparsity_fingerprint

    fp = sparsity_fingerprint(sp.indptr, sp.indices, *sp.shape)
    rt = ts.resetup_entry(fp, sp.data, b=b)
    rj = js.resetup_entry(fp, sp.data, b=b)
    assert int(rt.iters) == int(rj.iters) and int(rt.status) == 0
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(rj.x)).max())
    assert ts.metrics.get("entry_resetups") == 1
    with pytest.raises(KeyError):
        ts.resetup_entry("0" * 32, sp.data)


# ---------------------------------------------------------------------
# the C API's batched solve through both packages


def _capi_batch(capi, mode, systems, cfg):
    capi.initialize()
    cfg_h = capi.config_create(cfg)
    res_h = capi.resources_create_simple(cfg_h)
    slv_h = capi.solver_create(res_h, mode, cfg_h)
    mhs, rhs, shs = [], [], []
    for sp, b in systems:
        mh = capi.matrix_create(res_h, mode)
        capi.matrix_upload_all(mh, sp.shape[0], sp.nnz, 1, 1, sp.indptr,
                               sp.indices, sp.data)
        rh = capi.vector_create(res_h, mode)
        capi.vector_upload(rh, b.shape[0], 1, b)
        sh = capi.vector_create(res_h, mode)
        capi.vector_set_zero(sh, b.shape[0], 1)
        mhs.append(mh)
        rhs.append(rh)
        shs.append(sh)
    assert capi.solver_solve_batch(slv_h, mhs, rhs, shs) == capi.RC_OK
    s = capi._get(slv_h, capi._SolverHandle)
    assert s.batch_pending is not None
    out = []
    for i in range(len(systems)):
        out.append((capi.solver_get_batch_status(slv_h, i),
                    capi.solver_get_batch_iterations_number(slv_h, i),
                    capi.vector_download(shs[i])))
    assert s.batch_pending is None
    metrics = capi.solver_get_batch_metrics(slv_h)
    return out, metrics, slv_h


def test_capi_solver_solve_batch_as_jax():
    from amgx_tpu.api import capi as J
    from amgx_tpu_torch.api import capi as T

    systems = jittered_poisson_family((10, 10), 4, seed=12)
    tout, tm, _ = _capi_batch(T, "hDDI", systems, DEFAULT_CONFIG)
    jout, jm, _ = _capi_batch(J, "hDDI", systems, DEFAULT_CONFIG)
    for (ts, ti, tx), (js_, ji, jx), (sp, b) in zip(tout, jout, systems):
        assert ts == js_ == 0 and ti == ji > 0
        np.testing.assert_allclose(tx, jx, rtol=0,
                                   atol=1e-10 * np.abs(jx).max())
        assert np.linalg.norm(b - sp @ tx) < 1e-6 * np.linalg.norm(b)
    assert tm["batches"] == jm["batches"] == 1
    assert tm["solved"] == jm["solved"] == 4
    assert {k: tm.get(k, 0) for k in COUNTERS} == {
        k: jm.get(k, 0) for k in COUNTERS}


def test_capi_batch_failed_system_and_download_drain(monkeypatch):
    """A non-finite system fails alone (status FAILED, its vector left
    as uploaded); downloading a solution vector drains the batch."""
    from amgx_tpu_torch.api import capi as T

    # let the NaN right-hand side through the upload: the service's own
    # validation refuses it at submit
    monkeypatch.setenv("AMGX_TPU_VALIDATE", "0")

    systems = jittered_poisson_family((10, 10), 3, seed=18)
    T.initialize()
    cfg_h = T.config_create(DEFAULT_CONFIG)
    res_h = T.resources_create_simple(cfg_h)
    slv_h = T.solver_create(res_h, "hDDI", cfg_h)
    mhs, rhs, shs = [], [], []
    for i, (sp, b) in enumerate(systems):
        mh = T.matrix_create(res_h, "hDDI")
        T.matrix_upload_all(mh, sp.shape[0], sp.nnz, 1, 1, sp.indptr,
                            sp.indices, sp.data)
        rh = T.vector_create(res_h, "hDDI")
        bb = b.copy()
        if i == 1:
            bb[3] = np.nan
        T.vector_upload(rh, b.shape[0], 1, bb)
        sh = T.vector_create(res_h, "hDDI")
        T.vector_set_zero(sh, b.shape[0], 1)
        mhs.append(mh)
        rhs.append(rh)
        shs.append(sh)
    assert T.solver_solve_batch(slv_h, mhs, rhs, shs) == T.RC_OK
    x0 = T.vector_download(shs[0])  # drains
    s = T._get(slv_h, T._SolverHandle)
    assert s.batch_pending is None
    assert np.linalg.norm(systems[0][1] - systems[0][0] @ x0) < 1e-6 * \
        np.linalg.norm(systems[0][1])
    assert T.solver_get_batch_status(slv_h, 1) == 1  # FAILED
    np.testing.assert_array_equal(T.vector_download(shs[1]), 0.0)
    assert T.solver_get_batch_status(slv_h, 2) == 0
    with pytest.raises(T.AMGXError):
        T.solver_get_batch_status(slv_h, 3)


# ---------------------------------------------------------------------
# refusals


def test_service_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedSolveService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SolveService(config=PCG_AMG)
    assert tsvc().device.type == "cpu"


@pytest.mark.parametrize("param", ["donate", "placement",
                                   "fetch_watchdog_s", "failover"])
def test_left_out_parameters_raise(param, monkeypatch):
    """Only ``donate`` is left out; ``placement``, ``fetch_watchdog_s``
    and ``failover`` resolve as the JAX package's do, their variables
    included, and only the multi-device placements raise (queue A.9)."""
    for var in ("AMGX_TPU_PLACEMENT", "AMGX_TPU_FETCH_WATCHDOG_S",
                "AMGX_TPU_FAILOVER"):
        monkeypatch.delenv(var, raising=False)
    if param == "donate":
        with pytest.raises(NotImplementedError, match="not ported"):
            BatchedSolveService(device="cpu", donate=True)
        return
    t, j = BatchedSolveService(device="cpu"), JService()
    if param == "placement":
        assert (t.placement.name, j.placement.name) == ("single", "single")
        assert BatchedSolveService(device="cpu", placement="single"
                                   ).placement.describe() == (
            JService(placement="single").placement.describe())
        with pytest.raises(NotImplementedError, match=r"A\.9"):
            BatchedSolveService(device="cpu", placement="mesh:2")
        monkeypatch.setenv("AMGX_TPU_PLACEMENT", "nope")
        with pytest.raises(ValueError) as te:
            BatchedSolveService(device="cpu")
        with pytest.raises(ValueError) as je:
            JService()
        assert str(te.value) == str(je.value)
    elif param == "fetch_watchdog_s":
        assert t.fetch_watchdog_s == j.fetch_watchdog_s == 120.0
        monkeypatch.setenv("AMGX_TPU_FETCH_WATCHDOG_S", "7.5")
        assert (BatchedSolveService(device="cpu").fetch_watchdog_s
                == JService().fetch_watchdog_s == 7.5)
        assert BatchedSolveService(device="cpu",
                                   fetch_watchdog_s=0).fetch_watchdog_s == 0
    else:
        assert t.failover is j.failover is True
        monkeypatch.setenv("AMGX_TPU_FAILOVER", "0")
        assert BatchedSolveService(device="cpu").failover is (
            JService().failover) is False
        assert BatchedSolveService(device="cpu", failover=True).failover


# ---------------------------------------------------------------------
# chip_smoke.py's walks of the batched paths (the wrappers count
# nothing on the CPU: record each batched SpMV's entry point instead)


@pytest.mark.parametrize("cfg,shape", [("amg", (32, 32, 32)),
                                       ("default", (12, 12, 12)),
                                       ("default_irregular", 12)])
def test_chip_smoke_batched_walks_count_every_batched_spmv(monkeypatch, cfg,
                                                           shape):
    import chip_smoke
    from amgx_tpu_torch.ops import kernels
    from amgx_tpu_torch.ops import spmv as spmv_mod

    seen = {}
    real = spmv_mod._spmv_batched

    def record(A, x):
        c = chip_smoke.BATCHED.get(chip_smoke.counter_of(A))
        if c is not None:
            name = c if c == "csr" else kernels.entry_point(c, A.dtype,
                                                            x.dtype)
            seen[name] = seen.get(name, 0) + 1
        return real(A, x)

    monkeypatch.setattr(spmv_mod, "_spmv_batched", record)
    if cfg == "default_irregular":
        systems = chip_smoke.irregular_family(shape, 3, seed=4)
    else:
        systems = chip_smoke.serve_family(shape, 3, seed=1)
    svc = tsvc(PCG_AMG if cfg == "amg" else DEFAULT_CONFIG, max_batch=4)
    res = svc.solve_many(systems)
    it = max(int(r.iters) for r in res)
    entry = next(iter(svc.cache._entries.values()))
    if cfg == "amg":
        amg = entry.solver.precond
        want = chip_smoke.batched_walk(amg, it + 1, it + 1, torch.float64)
        assert any(getattr(lv.P, "format", None) == "ELL"
                   for lv in amg.levels[:-1])
        assert "ell_spmv_batched_f64" in want
    else:
        want = chip_smoke.jacobi_walk(entry.solver.A, it, torch.float64)
        assert entry.solver.A.format == ("ELL" if "irregular" in cfg
                                         else "DIA")
        if "irregular" in cfg:
            # the template keeps its sliced layout: the sliced entry
            assert list(want) == ["sell_spmv_batched_f64"]
    assert seen == want
