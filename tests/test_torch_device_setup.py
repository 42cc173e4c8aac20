"""The port's classical device setup (torch ops) against the JAX
package's device pipeline (XLA), both on the CPU.

The three matrices of the JAX package's device-setup tests (3D Poisson
8^3, a 300-row random M-matrix, a nonsymmetric perturbation of the
Poisson matrix), made from a seed.  Contract: strength flags and C/F
splits identical in f64 and f32; P and R patterns identical with values
within 1e-12, Ac within 1e-11 (f64); the JAX package's per-level sync
tally (``jax_syncs``), beside ``syncs``, which counts every read the
port makes.  An ESC expansion past the int32 limit falls back to the
host builder for that level and is counted; any other error of the
pipeline raises.  At 20^3 the device and host hierarchies part at the
same level in both packages, at strength-threshold ties.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import amgx_tpu
from amgx_tpu.amg import classical as j_host
from amgx_tpu.amg import device_setup as j_dev
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.io.poisson import poisson_3d_7pt as j_poisson
from amgx_tpu.io.poisson import poisson_rhs
from amgx_tpu.solvers import create_solver as j_create

import amgx_tpu_torch as T
from amgx_tpu_torch.amg import classical as t_host
from amgx_tpu_torch.amg import device_setup as t_dev
from amgx_tpu_torch.io.poisson import poisson_3d_7pt as t_poisson

amgx_tpu.initialize()

DTYPES = [np.float64, np.float32]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _problems():
    rng = np.random.default_rng(1234)
    A1 = j_poisson(8, dtype=np.float64).to_scipy().tocsr()
    n = 300
    B = sps.random(n, n, density=0.02,
                   random_state=np.random.RandomState(7))
    B = B + B.T
    A2 = (sps.eye(n) * (np.abs(B).sum(axis=1).max() + 1) - B).tocsr()
    A3 = A1 + sps.diags_array(
        rng.standard_normal(A1.shape[0] - 1) * 0.05, offsets=1,
        shape=A1.shape,
    ).tocsr()
    out = []
    for A in (A1, A2, A3.tocsr()):
        A = A.tocsr()
        A.sort_indices()
        out.append(A)
    return out


PROBLEMS = _problems()


def _j_coo(A):
    n = A.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(A.indptr))
    r, c, v = j_dev._pad_coo(rows, A.indices.astype(np.int32), A.data,
                             j_dev._bucket(A.nnz), n)
    return jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), n


def _t_coo(A):
    n = A.shape[0]
    rows = torch.from_numpy(
        np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr)))
    return (rows, torch.from_numpy(A.indices.astype(np.int64)),
            torch.from_numpy(A.data),
            torch.from_numpy(A.indptr.astype(np.int64)), n)


def _j_strong(A, theta, mrs):
    rows, cols, vals, n = _j_coo(A)
    return np.asarray(
        j_dev._strength_ahat_dev(rows, cols, vals, n, theta, mrs)
    )[:A.nnz]


@pytest.mark.parametrize("mrs", [1.1, 0.9])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pi", [0, 1, 2])
def test_strength_flags_match_jax(pi, dtype, mrs):
    A = PROBLEMS[pi].astype(dtype)
    rows, cols, vals, offsets, n = _t_coo(A)
    got = t_dev._strength_ahat_dev(rows, cols, vals, offsets, n, 0.25,
                                   mrs).numpy()
    np.testing.assert_array_equal(got, _j_strong(A, 0.25, mrs))


def _j_pmis(A):
    rows, cols, vals, n = _j_coo(A)
    strong = j_dev._strength_ahat_dev(rows, cols, vals, n, 0.25, 1.1)
    fdt = jnp.float64 if A.dtype == np.float64 else jnp.float32
    lam = jax.ops.segment_sum(strong.astype(fdt), jnp.minimum(cols, n - 1),
                              num_segments=n)
    w = lam + jnp.asarray(j_host._hash_weights(n, seed=0), fdt)
    return np.asarray(j_dev._pmis_dev(rows, cols, strong, n, w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pi", [0, 1, 2])
def test_pmis_split_matches_jax(pi, dtype):
    A = PROBLEMS[pi].astype(dtype)
    rows, cols, vals, offsets, n = _t_coo(A)
    strong = t_dev._strength_ahat_dev(rows, cols, vals, offsets, n, 0.25,
                                      1.1)
    w = t_dev._pmis_weights(strong, cols, n, vals.dtype, 0, [0.0])
    cf = t_dev._pmis_dev(rows, cols, strong, n, w).numpy()
    np.testing.assert_array_equal(cf, _j_pmis(A))
    if dtype == np.float64:
        # the f64 weights are the host selector's
        S = t_host.strength_ahat(A, 0.25, 1.1)
        np.testing.assert_array_equal(cf, t_host.pmis_select(S))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pi", [0, 1, 2])
def test_aggressive_split_matches_jax(pi, dtype):
    A = PROBLEMS[pi].astype(dtype)
    rows, cols, vals, offsets, n = _t_coo(A)
    strong = t_dev._strength_ahat_dev(rows, cols, vals, offsets, n, 0.25,
                                      1.1)
    cf, nc = t_dev.aggressive_pmis_device(rows, cols, vals, strong, n,
                                          [0.0])
    jr, jc, jv, _ = _j_coo(A)
    js = j_dev._strength_ahat_dev(jr, jc, jv, n, 0.25, 1.1)
    jcf, jnc = j_dev.aggressive_pmis_device(jr, jc, jv, js, n, A.dtype)
    np.testing.assert_array_equal(cf.numpy(), np.asarray(jcf))
    assert nc == jnc


def _level_cfg(interp="D1", extra=""):
    return (
        '{"config_version": 2, "solver": {"scope": "main", '
        '"solver": "AMG", "algorithm": "CLASSICAL", '
        f'"selector": "PMIS", "interpolator": "{interp}"{extra}}}}}'
    )


LEVEL_CASES = {
    "D1": _level_cfg(),
    "D2": _level_cfg("D2"),
    "MULTIPASS": _level_cfg("MULTIPASS"),
    "aggressive+MULTIPASS": _level_cfg(extra=', "aggressive_levels": 1'),
    "D1 truncated": _level_cfg(
        extra=', "interp_truncation_factor": 0.3'),
    "D2 max 2 per row": _level_cfg(
        "D2", ', "interp_max_elements": 2'),
}


def _pattern(M):
    M = M.tocsr()
    M.sort_indices()
    return M.indptr.tolist(), M.indices.tolist()


def _t_level(A, cfg_text, profile=None):
    cfg = T.AMGConfig.from_string(cfg_text)
    assert t_dev.device_setup_eligible(cfg, "main", 0)
    return t_dev.build_classical_level_device(
        A, cfg, "main", 0, profile=profile, device="cpu")


@pytest.mark.parametrize("case", list(LEVEL_CASES))
@pytest.mark.parametrize("pi", [0, 1, 2])
def test_level_matches_jax_f64(pi, case):
    A = PROBLEMS[pi]
    prof_t, prof_j = {}, {}
    P, R, Ac = _t_level(A, LEVEL_CASES[case], prof_t)
    jcfg = JConfig.from_string(LEVEL_CASES[case])
    assert j_dev.device_setup_eligible(jcfg, "main", 0, dtype=A.dtype)
    jP, jR, jAc = j_dev.build_classical_level_device(
        A, jcfg, "main", 0, profile=prof_j)
    for name, got, ref, tol in (("P", P, jP, 1e-12), ("R", R, jR, 1e-12),
                                ("Ac", Ac, jAc, 1e-11)):
        assert got.shape == ref.shape, name
        assert _pattern(got) == _pattern(ref), name
        assert abs(got - ref).max() <= tol, name
    assert prof_t["jax_syncs"] == prof_j["syncs"]


_READS = ("__int__", "__bool__", "__index__", "__float__", "item",
          "tolist", "numpy")


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_syncs_count_every_host_read(monkeypatch, case):
    """``syncs`` is the number of tensor-to-host reads the level made
    (every conversion of a tensor to a host value is counted here):
    the JAX package's tally plus the PMIS rounds and downloads."""
    seen = [0]

    def counted(name):
        f = getattr(torch.Tensor, name)

        def g(self, *a, **k):
            seen[0] += 1
            return f(self, *a, **k)
        return g

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, counted(name))
    prof = {}
    _t_level(PROBLEMS[0], LEVEL_CASES[case], prof)
    monkeypatch.undo()
    assert prof["syncs"] == seen[0]
    # at least one PMIS round and nine downloads beyond the tally
    assert prof["syncs"] >= prof["jax_syncs"] + 10


@pytest.mark.parametrize("case", ["D1", "D2", "aggressive+MULTIPASS"])
@pytest.mark.parametrize("pi", [0, 1, 2])
def test_level_matches_jax_f32(pi, case):
    """f32: the same C/F split, hence P's column count and pattern;
    values to f32 roundoff."""
    A = PROBLEMS[pi].astype(np.float32)
    P, R, Ac = _t_level(A, LEVEL_CASES[case])
    jP, jR, jAc = j_dev.build_classical_level_device(
        A, JConfig.from_string(LEVEL_CASES[case]), "main", 0)
    assert P.dtype == np.float32 and P.shape == jP.shape
    assert _pattern(P) == _pattern(jP)
    assert _pattern(R) == _pattern(jR)
    scale = abs(jAc).max()
    assert abs(P - jP).max() <= 1e-5
    assert abs(Ac - jAc).max() <= 1e-5 * scale


def test_two_setups_repeat_bit_for_bit():
    A = PROBLEMS[2]
    a = _t_level(A, LEVEL_CASES["D2"])
    b = _t_level(A, LEVEL_CASES["D2"])
    for x, y in zip(a, b):
        assert _pattern(x) == _pattern(y)
        assert x.data.tobytes() == y.data.tobytes()


def _pcg_cfg(loc, interp="D1"):
    return (
        '{"config_version": 2, "solver": {"scope": "main", '
        '"solver": "PCG", "max_iters": 100, "tolerance": 1e-8, '
        '"convergence": "RELATIVE_INI_CORE", "monitor_residual": 1, '
        '"preconditioner": {"scope": "amg", "solver": "AMG", '
        '"algorithm": "CLASSICAL", "selector": "PMIS", '
        f'"interpolator": "{interp}", "setup_location": "{loc}", '
        '"smoother": {"scope": "j", '
        '"solver": "BLOCK_JACOBI", "relaxation_factor": 0.8, '
        '"monitor_residual": 0}, "max_iters": 1, "max_levels": 10, '
        '"min_coarse_rows": 16, "coarse_solver": "DENSE_LU_SOLVER", '
        '"monitor_residual": 0}}}'
    )


def _t_solve(cfg_text, n=12, dtype=np.float64):
    s = T.create_solver(T.AMGConfig.from_string(cfg_text), "default",
                        device="cpu")
    s.setup(t_poisson(n, dtype=dtype, device="cpu"))
    return s, s.solve(poisson_rhs(n ** 3, dtype=dtype))


def test_headline_iteration_parity():
    """PCG + classical AMG (PMIS/D1) at 12^3: the device-setup
    hierarchy takes the host-setup hierarchy's iterations, in the port
    as in the JAX package."""
    iters = {}
    for loc in ("HOST", "DEVICE"):
        s, r = _t_solve(_pcg_cfg(loc))
        assert r.status == 0
        iters[loc] = int(r.iters)
        stats = s.precond.setup_stats
        n_coarse = len(s.precond.levels) - 1
        assert stats["levels_built"] == n_coarse
        assert stats["device_levels"] == (n_coarse if loc == "DEVICE"
                                          else 0)
        assert stats["host_fallback_levels"] == 0
        if loc == "DEVICE":
            prof = s.precond.setup_profile
            assert prof["jax_syncs"] == 6 * n_coarse
            assert prof["syncs"] >= prof["jax_syncs"] + 10 * n_coarse
            assert prof["device_s"] > 0
    assert iters["DEVICE"] == iters["HOST"]
    js = j_create(JConfig.from_string(_pcg_cfg("DEVICE")), "default")
    js.setup(j_poisson(12, dtype=np.float64))
    assert int(js.solve(poisson_rhs(12 ** 3)).iters) == iters["DEVICE"]


def test_expansion_overflow_falls_back_to_host(monkeypatch):
    """Past the ESC limit every level goes to the host builder, is
    counted, and the hierarchy equals a host-setup one bit for bit."""
    monkeypatch.setattr(t_dev, "_SPGEMM_MAX_EXPANSION", 10)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s, r = _t_solve(_pcg_cfg("DEVICE"))
    assert any("falling back to the host builder" in str(x.message)
               for x in w)
    h, rh = _t_solve(_pcg_cfg("HOST"))
    stats = s.precond.setup_stats
    assert stats["host_fallback_levels"] == len(s.precond.levels) - 1 > 0
    assert stats["device_levels"] == 0
    assert len(s.precond.levels) == len(h.precond.levels)
    for a, b in zip(s.precond.levels, h.precond.levels):
        for f in ("A", "P", "R"):
            ma, mb = getattr(a, f), getattr(b, f)
            assert (ma is None) == (mb is None)
            if ma is not None:
                for x, y in zip(ma._host, mb._host):
                    assert x.tobytes() == y.tobytes()
    assert r.iters == rh.iters
    assert torch.equal(r.x, rh.x)


def test_pipeline_runtime_error_propagates(monkeypatch):
    """A fault of the device pipeline other than the ESC limit (on the
    card: a launch failure, an illegal access) is not hidden by a
    host fallback."""
    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(t_dev, "_pmis_dev", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        _t_solve(_pcg_cfg("DEVICE"))


def test_auto_takes_the_host_builder_on_the_cpu():
    cfg = _pcg_cfg("DEVICE").replace('"DEVICE"', '"AUTO"')
    s, r = _t_solve(cfg)
    assert r.status == 0
    assert s.precond.setup_stats["device_levels"] == 0
    assert "device_s" not in s.precond.setup_profile


@pytest.mark.parametrize("interp", ["D2", "MULTIPASS"])
def test_device_setup_solves_like_host(interp):
    _, rd = _t_solve(_pcg_cfg("DEVICE", interp))
    _, rh = _t_solve(_pcg_cfg("HOST", interp))
    assert rd.status == rh.status == 0
    assert rd.iters == rh.iters


def test_spgemm_matches_scipy():
    rng = np.random.default_rng(5)
    A = sps.random(40, 30, density=0.1, random_state=rng, format="csr")
    B = sps.random(30, 25, density=0.15, random_state=rng, format="csr")
    ar, ac, av, _, _ = _t_coo(A)
    br, bc, bv, _, _ = _t_coo(B)
    r, c, v = t_dev.spgemm_device(ar, ac, av, br, bc, bv, 30, 25)
    C = sps.csr_matrix((v.numpy(), (r.numpy(), c.numpy())), shape=(40, 25))
    assert abs(C - A @ B).max() <= 1e-14


def _chain(build, A, cfg):
    """(rows, coarse rows, C/F split) of each level of a classical
    hierarchy coarsened by ``build`` down to 128 rows."""
    out = []
    while A.shape[0] > 128:
        P, _, Ac = build(A, cfg, "amg", len(out))
        out.append((A.shape[0], P.shape[1], A.tocsr()))
        A = Ac.tocsr()
        A.sort_indices()
    return out


def test_hierarchies_part_at_threshold_ties_in_both_packages():
    """PCG_CLASSICAL at 20^3 f64: the device pipeline and the host
    builder part at level 2 (577 against 576 coarse rows), in the JAX
    package as in the port.  Their level-1 operators agree to 1e-14,
    and every strength flag they disagree on sits within a few ulp of
    theta times its row's largest negative off-diagonal entry, so
    roundoff puts it on either side of the test."""
    from chip_smoke import PCG_CLASSICAL

    A = j_poisson(20, dtype=np.float64).to_scipy().tocsr()
    A.sort_indices()
    jc, tc = JConfig.from_string(PCG_CLASSICAL), T.AMGConfig.from_string(
        PCG_CLASSICAL)
    chains = {
        "jax host": _chain(j_host.build_classical_level, A, jc),
        "jax device": _chain(j_dev.build_classical_level_device, A, jc),
        "port host": _chain(t_host.build_classical_level, A, tc),
        "port device": _chain(
            lambda *a: t_dev.build_classical_level_device(
                *a, device="cpu"), A, tc),
    }
    sizes = {k: [lv[:2] for lv in v] for k, v in chains.items()}
    assert sizes["port host"] == sizes["jax host"]
    assert sizes["port device"] == sizes["jax device"]

    def parts(a, b):
        return next(i for i, (x, y) in enumerate(zip(sizes[a], sizes[b]))
                    if x != y)

    assert parts("jax host", "jax device") == 1
    assert parts("port host", "port device") == 1
    assert sizes["port host"][1] == (2657, 577)
    assert sizes["port device"][1] == (2657, 576)

    for pkg in ("jax", "port"):
        Ah = chains[f"{pkg} host"][1][2]
        Ad = chains[f"{pkg} device"][1][2].copy()
        Ad.eliminate_zeros()
        assert ((Ah != 0) != (Ad != 0)).nnz == 0
        assert abs(Ah - Ad).max() <= 1e-14
        Sh = t_host.strength_ahat(Ah, 0.25, 1.1).tocsr()
        Sd = t_host.strength_ahat(Ad, 0.25, 1.1).tocsr()
        D = ((Sh != 0) != (Sd != 0)).tocoo()
        assert D.nnz > 0
        for i, j in zip(D.row, D.col):
            for M in (Ah, Ad):
                row = M.getrow(i).toarray().ravel()
                off = np.delete(-row, i)
                thresh = 0.25 * off.max()
                assert abs(-row[j] - thresh) <= 4 * np.spacing(thresh)
