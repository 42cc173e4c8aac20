"""The setup store of the PyTorch port against the JAX package (CPU,
f64): a payload written by either package restores in the other
without running setup and solves as the writer's solver does.

Each setup (the PCG + classical AMG of ``tests/test_store.py``, the
bench aggregation config, Chebyshev-smoothed AMG, a bf16 INEXACT
hierarchy, block b = 4, MATRIX_FREE, a scaled and reordered solver) is
set up in one package, saved, loaded in the other, and solved: equal
iterations and status, x to rtol 1e-10 of the writer's x (of the
reader's own cold solve for bf16, ``READER_X``).  A port
payload loaded by the port solves with the cold solve's x bit for bit.
Restores coarsen nothing, estimate no Chebyshev bound and factor no
dense LU (the factors and their pivots come with the payload).  Also:
fingerprints and config hashes equal across the packages, the stale
dtype / format guardrails, and the port's ArtifactStore (the cases of
``tests/test_store.py:324-421``, and whole solvers through it).
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.amg.hierarchy import AMGSolver as JAMG
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.errors import StoreError as JStoreError
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.solvers import create_solver as j_create
from amgx_tpu.solvers.base import Solver as JSolver
from amgx_tpu.store import serialize as jser
from amgx_tpu_torch.amg.hierarchy import AMGSolver as TAMG
from amgx_tpu_torch.core.errors import RC_BAD_MODE, StoreError
from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.io.poisson import poisson_scipy
from amgx_tpu_torch.solvers.base import Solver as TSolver
from amgx_tpu_torch.store import ArtifactStore
from amgx_tpu_torch.store import serialize as ser
from tests.test_torch_eigensolvers import counted_spmvs  # noqa: F401

amgx_tpu.initialize()

PCG_AMG = """
{"config_version": 2,
 "solver": {"scope": "main", "solver": "PCG", "max_iters": 100,
    "tolerance": 1e-8, "monitor_residual": 1,
    "convergence": "RELATIVE_INI",
    "preconditioner": {"scope": "amg", "solver": "AMG",
       "algorithm": "CLASSICAL", "selector": "PMIS",
       "smoother": {"scope": "jac", "solver": "BLOCK_JACOBI",
           "relaxation_factor": 0.8, "monitor_residual": 0},
       "presweeps": 1, "postsweeps": 1, "max_levels": 20,
       "min_coarse_rows": 16, "coarse_solver": "DENSE_LU_SOLVER",
       "cycle": "V", "max_iters": 1, "monitor_residual": 0}}}
"""

AMG_CHEB = """
{"config_version": 2,
 "solver": {"scope": "main", "solver": "AMG", "algorithm": "CLASSICAL",
    "selector": "PMIS", "smoother": {"scope": "jac",
        "solver": "CHEBYSHEV", "relaxation_factor": 0.8,
        "monitor_residual": 0},
    "presweeps": 2, "postsweeps": 2, "max_levels": 20,
    "min_coarse_rows": 16, "coarse_solver": "DENSE_LU_SOLVER",
    "cycle": "V", "max_iters": 40, "monitor_residual": 1,
    "convergence": "RELATIVE_INI", "tolerance": 1e-08, "norm": "L2"}}
"""

JAC_PCG = """
{"config_version": 2,
 "solver": {"scope": "main", "solver": "PCG", "max_iters": 200,
    "tolerance": 1e-8, "monitor_residual": 1,
    "convergence": "RELATIVE_INI",
    "preconditioner": {"scope": "jac", "solver": "BLOCK_JACOBI",
        "relaxation_factor": 0.9, "max_iters": 2,
        "monitor_residual": 0}}}
"""

SCALED_RCM = """
{"config_version": 2,
 "solver": {"scope": "main", "solver": "PCG", "max_iters": 200,
    "tolerance": 1e-8, "monitor_residual": 1,
    "convergence": "RELATIVE_INI", "scaling": "DIAGONAL_SYMMETRIC",
    "matrix_reordering": "RCM",
    "preconditioner": {"scope": "jac", "solver": "BLOCK_JACOBI",
        "relaxation_factor": 0.9, "max_iters": 2,
        "monitor_residual": 0}}}
"""


def _agg(extra="", selector="SIZE_8", smoother="BLOCK_JACOBI",
         coarse="DENSE_LU_SOLVER", min_rows=64):
    """The bench config (``bench.py:_solve_record``) at 1e-8, with
    ``extra`` keys in its AMG scope."""
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        ' "solver": "PCG", "max_iters": 100, "tolerance": 1e-8,'
        ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
        ' "preconditioner": {"scope": "amg", "solver": "AMG",'
        f' "algorithm": "AGGREGATION", "selector": "{selector}",'
        f' "smoother": {{"scope": "j", "solver": "{smoother}",'
        ' "relaxation_factor": 0.8, "monitor_residual": 0},'
        ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
        f' "min_coarse_rows": {min_rows}, "max_levels": 20,'
        f' "coarse_solver": "{coarse}", "cycle": "V",{extra}'
        ' "monitor_residual": 0}}}'
    )


def _block4(n=6):
    """kron(poisson 3D n^3, I_4 + 0.2 ones): block b = 4, SPD."""
    blk = np.eye(4) + 0.2 * np.ones((4, 4))
    return sps.kron(poisson_scipy((n, n, n)), blk).tocsr()


# name -> (config, scipy matrix, block size)
SETUPS = {
    "pcg_classical": (PCG_AMG, lambda: poisson_scipy((24, 24)), 1),
    "bench_aggregation": (_agg(), lambda: poisson_scipy((16, 16, 16)), 1),
    "cheby_amg": (AMG_CHEB, lambda: poisson_scipy((24, 24)), 1),
    "bf16_inexact": (_agg(' "hierarchy_dtype": "BFLOAT16",'
                          ' "level_dtype_policy": "COARSE",',
                          smoother="OPT_POLYNOMIAL", coarse="INEXACT",
                          min_rows=32),
                     lambda: poisson_scipy((24, 24)), 1),
    "block4_jacobi": (JAC_PCG, _block4, 4),
    "block4_amg": (_agg(selector="SIZE_2", min_rows=32), _block4, 4),
    "matrix_free": (_agg(' "matrix_free": 1,'),
                    lambda: poisson_scipy((16, 16, 16)), 1),
    "scaled_reordered": (SCALED_RCM, lambda: poisson_scipy((20, 20)), 1),
}


# bf16 cycles round each product and sum in bf16 in both packages, but
# not in the same order, so the two packages' solves on one bf16
# hierarchy part at the solve's tolerance (tests/test_torch_precision.py
# holds them to the iterations): a restored bf16 hierarchy is held to
# the writer's iterations and to the x of the reader's own cold setup,
# whose hierarchy is the writer's bit for bit
READER_X = ("bf16_inexact",)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rhs(n):
    return np.random.default_rng(42).standard_normal(n)


def _system(name):
    cfg, make, bs = SETUPS[name]
    sp = make().tocsr().astype(np.float64)
    sp.sort_indices()
    return cfg, sp, bs, _rhs(sp.shape[0])


def _jax_solver(cfg, sp, bs):
    s = j_create(JConfig.from_string(cfg), "default")
    return s.setup(JMatrix.from_scipy(sp, block_size=bs))


def _port_solver(cfg, sp, bs):
    s = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                        device="cpu")
    return s.setup(SparseMatrix.from_scipy(sp, block_size=bs, device="cpu"))


def _amg(s):
    for cand in (s, getattr(s, "precond", None)):
        if isinstance(cand, (JAMG, TAMG)):
            return cand
    return None


def _hold(res, ref_iters, ref_status, ref_x):
    assert int(res.iters) == int(ref_iters)
    assert int(res.status) == int(ref_status) == 0
    x = res.x.numpy() if isinstance(res.x, torch.Tensor) \
        else np.asarray(res.x)
    np.testing.assert_allclose(x, ref_x, rtol=1e-10,
                               atol=1e-10 * np.abs(ref_x).max())


def _no_setup_at_restore(monkeypatch):
    """Restores must not coarsen, estimate a Chebyshev bound or factor a
    dense LU, in either package."""
    from amgx_tpu.solvers.chebyshev import ChebyshevSolver as JCheb
    from amgx_tpu.solvers.dense_lu import DenseLUSolver as JLU
    from amgx_tpu_torch.solvers.chebyshev import ChebyshevSolver as TCheb
    from amgx_tpu_torch.solvers.dense_lu import DenseLUSolver as TLU

    def boom(*a, **k):
        raise AssertionError("restore ran a setup step")

    for cls, name in ((JCheb, "_estimate_lambda_max"),
                      (TCheb, "_estimate_lambda_max"),
                      (JAMG, "_coarsen_from"), (TAMG, "_coarsen_from"),
                      (JLU, "_setup_impl"), (TLU, "_setup_impl")):
        monkeypatch.setattr(cls, name, boom)


def _levels_of(s):
    amg = _amg(s)
    if amg is None:
        return None
    return [(lvl.A.n_rows, lvl.A.nnz, str(lvl.A.values.dtype)
             .replace("torch.", "")) for lvl in amg.levels]


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_jax_payload_restores_in_the_port(tmp_path, monkeypatch, name):
    cfg, sp, bs, b = _system(name)
    js = _jax_solver(cfg, sp, bs)
    jr = js.solve(b)
    path = tmp_path / "jax.npz"
    js.save_setup(path)
    _no_setup_at_restore(monkeypatch)
    ts = TSolver.load_setup(path, device="cpu")
    assert ts.setup_time == 0.0 and ts.restore_time > 0.0
    amg = _amg(ts)
    if amg is not None:
        assert amg.setup_stats["restored"] is True
        assert amg.setup_stats["coarsen_calls"] == 0
        assert _levels_of(ts) == _levels_of(js)
    ref_x = np.asarray(jr.x)
    if name in READER_X:
        monkeypatch.undo()
        ref_x = _port_solver(cfg, sp, bs).solve(b).x.numpy()
    _hold(ts.solve(b), jr.iters, jr.status, ref_x)


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_port_payload_restores_in_jax(tmp_path, monkeypatch, name):
    cfg, sp, bs, b = _system(name)
    ts = _port_solver(cfg, sp, bs)
    tr = ts.solve(b)
    path = tmp_path / "port.npz"
    manifest = ts.save_setup(path)
    assert manifest["fingerprint"] == JMatrix.from_scipy(
        sp, block_size=bs).fingerprint()
    _no_setup_at_restore(monkeypatch)
    js = JSolver.load_setup(path)
    if _amg(js) is not None:
        assert _amg(js).setup_stats["coarsen_calls"] == 0
        assert _levels_of(js) == _levels_of(ts)
    ref_x = tr.x.numpy()
    if name in READER_X:
        monkeypatch.undo()
        ref_x = np.asarray(_jax_solver(cfg, sp, bs).solve(b).x)
    _hold(js.solve(b), tr.iters, tr.status, ref_x)


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_port_payload_restores_bit_for_bit(tmp_path, monkeypatch, name):
    """Port to port: the restored solver's x is the cold solve's, bit
    for bit, its operators have the cold ones' formats (sliced layout
    included) and values."""
    cfg, sp, bs, b = _system(name)
    ts = _port_solver(cfg, sp, bs)
    tr = ts.solve(b)
    path = tmp_path / "port.npz"
    ts.save_setup(path)
    _no_setup_at_restore(monkeypatch)
    t2 = TSolver.load_setup(path, device="cpu")
    r2 = t2.solve(b)
    assert int(r2.iters) == int(tr.iters)
    assert torch.equal(r2.x, tr.x)
    amg1, amg2 = _amg(ts), _amg(t2)
    if amg1 is None:
        return
    assert amg2.level_summary() == amg1.level_summary()
    for l1, l2 in zip(amg1.levels, amg2.levels):
        for m1, m2 in ((l1.A, l2.A), (l1.P, l2.P), (l1.R, l2.R)):
            if m1 is None:
                assert m2 is None
                continue
            assert m2.format == m1.format
            for f in ("values", "diag", "dia_vals", "dense", "ell_cols",
                      "ell_vals", "mf_coefs"):
                v1, v2 = getattr(m1, f), getattr(m2, f)
                assert (v1 is None) == (v2 is None), f
                if v1 is not None:
                    assert torch.equal(v1, v2), f
            assert (m1.sell is None) == (m2.sell is None)
            if m1.sell is not None:
                for f in ("cols", "vals", "offsets", "widths", "rows"):
                    v1, v2 = getattr(m1.sell, f), getattr(m2.sell, f)
                    assert (v1 is None) == (v2 is None)
                    if v1 is not None:
                        assert torch.equal(v1, v2), f
                assert (m1.sell.sigma, m1.sell.lanes) == (
                    m2.sell.sigma, m2.sell.lanes)


def test_restored_state_matches_the_writer(tmp_path):
    """Chebyshev bounds, the DENSE_LU factors and 0-based / 1-based
    pivots, and the Galerkin plans carried across."""
    cfg = AMG_CHEB.replace('"cycle": "V",',
                           '"cycle": "V", "structure_reuse_levels": -1,')
    sp = poisson_scipy((24, 24)).tocsr()
    js = _jax_solver(cfg, sp, 1)
    path = tmp_path / "j.npz"
    js.save_setup(path)
    ts = TSolver.load_setup(path, device="cpu")
    jb = [(lv.smoother.lmax, lv.smoother.lmin) for lv in js.levels
          if lv.smoother is not None]
    tb = [(lv.smoother.lmax, lv.smoother.lmin) for lv in ts.levels
          if lv.smoother is not None]
    assert tb == jb and tb
    _, jfac, jpiv = js.coarse_solver._params
    _, tfac, tpiv = ts.coarse_solver._params
    np.testing.assert_array_equal(tfac.numpy(), np.asarray(jfac))
    np.testing.assert_array_equal(tpiv.numpy(), np.asarray(jpiv) + 1)
    for jl, tl in zip(js.levels, ts.levels):
        if jl.rap_plan is None:
            assert tl.rap_plan is None
            continue
        for jp, tp in ((jl.rap_plan.ap, tl.rap_plan.ap),
                       (jl.rap_plan.rap, tl.rap_plan.rap)):
            np.testing.assert_array_equal(tp.left_idx.numpy(),
                                          np.asarray(jp.left_idx))
            np.testing.assert_array_equal(tp.out_idx().numpy(),
                                          np.asarray(jp.out_idx))
        # the restored plans re-form the coarse operator bit for bit
        nxt = ts.levels[tl.level_id + 1].A
        got = tl.rap_plan.apply(tl.R.values, tl.A.values, tl.P.values)
        np.testing.assert_allclose(got.numpy(), nxt.values.numpy(),
                                   rtol=1e-12, atol=1e-14)
    # and back: the port's payload holds the JAX package's forms
    path2 = tmp_path / "t.npz"
    ts.save_setup(path2)
    j2 = JSolver.load_setup(path2)
    _, jfac2, jpiv2 = j2.coarse_solver._params
    np.testing.assert_array_equal(np.asarray(jpiv2), np.asarray(jpiv))
    np.testing.assert_array_equal(np.asarray(jfac2), np.asarray(jfac))


def test_fingerprints_and_config_hashes_match_jax():
    rect = sps.random(30, 17, density=0.2, random_state=3, format="csr")
    for sp, bs in ((poisson_scipy((24, 24)), 1),
                   (poisson_scipy((8, 8, 8)), 1), (_block4(4), 4),
                   (rect, 1)):
        sp = sp.tocsr()
        sp.sort_indices()
        t = SparseMatrix.from_scipy(sp, block_size=bs, device="cpu")
        j = JMatrix.from_scipy(sp, block_size=bs)
        assert t.fingerprint() == j.fingerprint()
        assert t.setup_key() == j.setup_key()
        assert t.astype(np.float32).setup_key() == (t.fingerprint(),
                                                    "float32")
        t2 = t.replace_values(t.values * 2.0)
        assert t2._fingerprint_cache == t.fingerprint()
    for cfg, _, _ in SETUPS.values():
        assert T.AMGConfig.from_string(cfg).content_hash() == \
            JConfig.from_string(cfg).content_hash()


def _rewrite_config(path, key, value, scope):
    """Rewrite one value of a payload's configuration (and its hash),
    as a stale writer would have left it."""
    arrays, manifest = ser.read_payload(str(path))
    cfg = T.AMGConfig.from_state(manifest["config"])
    cfg.set(key, value, scope)
    manifest["config"] = cfg.to_state()
    manifest["config_hash"] = cfg.content_hash()
    ser.write_payload(path, arrays, manifest)


def test_stale_dtype_payload_is_refused(tmp_path):
    """An all-f64 hierarchy whose manifest names a bf16 policy: refused
    by both packages before the cast could repair it."""
    cfg, sp, bs, _ = _system("bench_aggregation")
    for writer in ("jax", "port"):
        s = (_jax_solver if writer == "jax" else _port_solver)(cfg, sp, bs)
        path = tmp_path / f"{writer}.npz"
        s.save_setup(path)
        _rewrite_config(path, "hierarchy_dtype", "BFLOAT16", "amg")
        with pytest.raises(StoreError):
            TSolver.load_setup(path, device="cpu")
        with pytest.raises(JStoreError):
            JSolver.load_setup(path)


def test_stale_format_payloads_are_refused(tmp_path, monkeypatch):
    cfg, sp, bs, _ = _system("matrix_free")
    # MATRIX_FREE state under a config whose knob is off
    s = _port_solver(cfg, sp, bs)
    assert any(lvl.A.has_matrix_free for lvl in s.precond.levels)
    path = tmp_path / "mf.npz"
    s.save_setup(path)
    _rewrite_config(path, "matrix_free", 0, "amg")
    with pytest.raises(StoreError):
        TSolver.load_setup(path, device="cpu")
    with pytest.raises(JStoreError):
        JSolver.load_setup(path)
    # DIA planes of a verified stencil under matrix_free 1: a writer
    # that never ran detection
    monkeypatch.setattr(TAMG, "_maybe_matrix_free", lambda self, A: A)
    monkeypatch.setattr(TAMG, "_accel_formats",
                        lambda self: ("dia", "dense", "ell"))
    s = _port_solver(cfg, sp, bs)
    assert not any(lvl.A.has_matrix_free for lvl in s.precond.levels)
    path = tmp_path / "stale.npz"
    s.save_setup(path)
    monkeypatch.undo()
    with pytest.raises(StoreError):
        TSolver.load_setup(path, device="cpu")
    with pytest.raises(JStoreError):
        JSolver.load_setup(path)


def test_payload_defects_raise_store_error(tmp_path):
    cfg, sp, bs, _ = _system("pcg_classical")
    s = _port_solver(JAC_PCG, sp, bs)
    path = tmp_path / "p.npz"
    s.save_setup(path)
    with pytest.raises(StoreError):
        TSolver.load_setup(tmp_path / "nope.npz", device="cpu")
    bad = tmp_path / "garbage.npz"
    bad.write_bytes(b"definitely not an npz payload")
    with pytest.raises(StoreError):
        TSolver.load_setup(bad, device="cpu")
    # another configuration, another dtype, another schema
    with pytest.raises(StoreError):
        TSolver.load_setup(path, cfg=T.AMGConfig.from_string(PCG_AMG),
                           device="cpu")
    assert TSolver.load_setup(path, cfg=T.AMGConfig.from_string(JAC_PCG),
                              device="cpu").A is not None
    with pytest.raises(StoreError) as e:
        TSolver.load_setup(path, expect_dtype=np.float32, device="cpu")
    assert e.value.rc == RC_BAD_MODE
    assert TSolver.load_setup(path, expect_dtype="float64",
                              device="cpu").A is not None
    arrays, manifest = ser.read_payload(str(path))
    manifest["schema_version"] = ser.SCHEMA_VERSION + 1
    ser.write_payload(path, arrays, manifest)
    with pytest.raises(StoreError):
        TSolver.load_setup(path, device="cpu")
    assert ser.SCHEMA_VERSION == jser.SCHEMA_VERSION == 1


def test_load_setup_defaults_to_the_card(tmp_path):
    s = _port_solver(JAC_PCG, poisson_scipy((8, 8)).tocsr(), 1)
    path = tmp_path / "p.npz"
    s.save_setup(path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TSolver.load_setup(path)


# ---------------------------------------------------------------------------
# ArtifactStore (the cases of tests/test_store.py:324-421)


def _toy_entry(i=0, kb=64):
    return {"x": np.full(kb * 128, float(i))}, {"kind": "toy", "i": i}


def test_store_put_get_roundtrip(tmp_path):
    st = ArtifactStore(tmp_path)
    key = st.entry_key("fp", "cfg", "float64")
    assert st.get(key) is None
    assert st.stats()["misses"] == 1
    arrays, manifest = _toy_entry(7)
    assert st.put(key, arrays, manifest)
    m, a = st.get(key)
    assert m["i"] == 7
    assert np.array_equal(a["x"], arrays["x"])
    assert st.stats()["hits"] == 1


def test_store_corrupt_payload_is_miss(tmp_path):
    st = ArtifactStore(tmp_path)
    key = st.entry_key("fp", "cfg", "float64")
    st.put(key, *_toy_entry())
    npz = os.path.join(st.root, key + ".npz")
    blob = bytearray(open(npz, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(blob))
    assert st.get(key) is None
    assert st.stats()["corrupt_entries"] == 1
    assert st.stats()["misses"] >= 1
    assert not os.path.exists(npz)


def test_store_truncated_payload_is_miss(tmp_path):
    st = ArtifactStore(tmp_path)
    key = st.entry_key("fp2", "cfg", "float64")
    st.put(key, *_toy_entry())
    npz = os.path.join(st.root, key + ".npz")
    blob = open(npz, "rb").read()
    open(npz, "wb").write(blob[: len(blob) // 3])
    assert st.get(key) is None
    assert st.stats()["corrupt_entries"] == 1


def test_store_stale_schema_is_miss(tmp_path):
    st = ArtifactStore(tmp_path)
    key = st.entry_key("fp3", "cfg", "float64")
    st.put(key, *_toy_entry())
    side_path = os.path.join(st.root, key + ".json")
    side = json.loads(open(side_path).read())
    side["schema_version"] = ser.SCHEMA_VERSION + 1
    open(side_path, "w").write(json.dumps(side))
    assert st.get(key) is None
    assert st.stats()["stale_schema"] == 1
    assert list(st.entries()) == []


def test_store_budget_never_wipes_newest(tmp_path):
    st = ArtifactStore(tmp_path, max_bytes=10 * 1024)
    k1 = st.entry_key("a", "c", "f8")
    st.put(k1, *_toy_entry(1))
    assert st.get(k1) is not None
    k2 = st.entry_key("b", "c", "f8")
    os.utime(os.path.join(st.root, k1 + ".npz"), (1000.0, 1000.0))
    os.utime(os.path.join(st.root, k1 + ".json"), (1000.0, 1000.0))
    st.put(k2, *_toy_entry(2))
    assert st.get(k2) is not None
    assert st.get(k1) is None
    assert st.stats().get("budget_overflows", 0) >= 1


def test_store_lru_eviction_under_budget(tmp_path):
    st = ArtifactStore(tmp_path, max_bytes=150 * 1024)
    keys = [st.entry_key(f"fp{i}", "cfg", "f8") for i in range(3)]
    for i, k in enumerate(keys):
        st.put(k, *_toy_entry(i))
        for ext in (".npz", ".json"):
            os.utime(os.path.join(st.root, k + ext),
                     (1000.0 + i, 1000.0 + i))
    st._enforce_budget()
    assert st.stats()["evictions"] >= 1
    assert st.get(keys[2]) is not None
    assert st.get(keys[0]) is None


def test_store_keys_match_jax():
    from amgx_tpu.store import ArtifactStore as JStore

    assert ArtifactStore.entry_key("fp", "cfg", "float64") == \
        JStore.entry_key("fp", "cfg", "float64")


@pytest.mark.parametrize("defect", ["none", "corrupt", "truncated",
                                    "stale_schema", "stale_dtype"])
def test_store_solver_entries(tmp_path, defect):
    """A whole solver through the store: a hit restores it (no setup,
    the cold solve's x); each defect is a counted miss, never an
    exception or a solver."""
    cfg, sp, bs, b = _system("bench_aggregation")
    s = _port_solver(cfg, sp, bs)
    r = s.solve(b)
    st = ArtifactStore(tmp_path)
    key = st.put_setup(s)
    assert key == st.setup_key(s)
    npz = os.path.join(st.root, key + ".npz")
    side_path = os.path.join(st.root, key + ".json")
    if defect == "corrupt":
        blob = bytearray(open(npz, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(npz, "wb").write(bytes(blob))
    elif defect == "truncated":
        blob = open(npz, "rb").read()
        open(npz, "wb").write(blob[: len(blob) // 3])
    elif defect == "stale_schema":
        side = json.loads(open(side_path).read())
        side["schema_version"] = ser.SCHEMA_VERSION + 1
        open(side_path, "w").write(json.dumps(side))
    elif defect == "stale_dtype":
        # a payload the restore refuses (the digest still verifies)
        arrays, manifest = ser.read_payload(npz)
        cfg2 = T.AMGConfig.from_state(manifest["config"])
        cfg2.set("hierarchy_dtype", "BFLOAT16", "amg")
        manifest["config"] = cfg2.to_state()
        manifest["config_hash"] = cfg2.content_hash()
        st.put(key, arrays, manifest)
    got = st.get_setup(key, device="cpu")
    stats = st.stats()
    if defect == "none":
        assert got is not None and stats["hits"] == 1
        assert got.precond.setup_stats["coarsen_calls"] == 0
        r2 = got.solve(b)
        assert int(r2.iters) == int(r.iters) and torch.equal(r2.x, r.x)
        return
    assert got is None
    assert stats["misses"] == 1 and stats.get("hits", 0) == 0
    counter = {"corrupt": "corrupt_entries", "truncated": "corrupt_entries",
               "stale_schema": "stale_schema",
               "stale_dtype": "restore_failures"}[defect]
    assert stats[counter] == 1


# ---------------------------------------------------------------------------
# chip_smoke.py's setup_store phase on the CPU


@pytest.mark.parametrize("label", ["bench", "pcg_classical",
                                   "pcg_classical_cheby",
                                   "bench_matrix_free"])
def test_chip_smoke_store_roundtrip(tmp_path, counted_spmvs, label):
    """The phase's round trip at 12^3 f32 on the CPU, its launch
    counters replaced by a count of the SpMVs each operator's format
    sends to a kernel: the restore makes none, the restored solve the
    cold one's, with the cold x bit for bit."""
    C = counted_spmvs
    (cfg, formats), = [(c, f) for lab, c, f in C.STORE_CONFIGS
                       if lab == label]
    got = C.store_roundtrip(torch, label, cfg, formats, 12, np.float32,
                            "cpu", str(tmp_path))
    assert sum(got.values()) > 0
    if label == "bench_matrix_free":
        assert got["stencil_spmv"] > 0 and got["dia_spmv"] == 0
    assert not list(tmp_path.iterdir())
