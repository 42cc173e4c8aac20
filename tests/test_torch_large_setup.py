"""Large-grid aggregation setup of the PyTorch port against the JAX
package (CPU): the dense-reduction Galerkin ``geo_galerkin_dia`` and
the device matcher ``pairwise_match_device``.

* ``geo_galerkin_dia``: the reductions as torch operations on CPU
  tensors, from the CSR arrays and from the uploaded matrix's DIA
  planes, equal the JAX package's coarse operator and
  scipy's R A P to 1e-12 in f64 (exact in practice: both sum the same
  entries in the same order), in 3D, 2D and with semicoarsening; None
  wherever the JAX package returns None (a wrap diagonal, an ambiguous
  offset); ``build_aggregation_level`` takes it above a lowered
  ``_GEO_RAP_MIN_ROWS``, with the solve unchanged.
* The matcher: the torch rounds give the host matcher's aggregates and
  the JAX package's device matcher's, bit for bit, on the 16^3 Poisson
  weight graph and a random graph; the size and width gates and the
  ``AMGX_TPU_TORCH_DEVICE_MATCH`` override decide where a pass runs,
  and a SIZE_2 hierarchy built with the device rounds equals the host
  one.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.amg import aggregation as jagg
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.io.poisson import poisson_2d_5pt as j_poisson_2d
from amgx_tpu.io.poisson import poisson_3d_7pt as j_poisson
from amgx_tpu.io.poisson import poisson_rhs
from amgx_tpu_torch.amg import aggregation as tagg
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix

amgx_tpu.initialize()

SIZE8 = ('{"config_version": 2, "solver": {"scope": "m",'
         ' "solver": "AMG", "selector": "SIZE_8"}}')


def _anisotropic_2d():
    n2 = 16 * 16
    main = np.full(n2, 2.0 + 2.0e-3)
    ex = np.full(n2 - 1, -1.0)
    ex[15::16] = 0.0
    ey = np.full(n2 - 16, -1e-3)
    return sps.diags_array(
        [main, ex, ex, ey, ey], offsets=[0, 1, -1, 16, -16]).tocsr()


CASES = {
    "3d_12": lambda: j_poisson(12).to_scipy(),
    "2d_16": lambda: j_poisson_2d(16).to_scipy(),
    "semicoarsened": _anisotropic_2d,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_geo_galerkin_matches_jax_and_scipy(case):
    Asp = CASES[case]().tocsr()
    Asp.sort_indices()
    tcfg = T.AMGConfig.from_string(SIZE8)
    agg, geo = tagg.select_aggregates(Asp, tcfg, "m")
    jagg_, jgeo = jagg.select_aggregates(Asp, JConfig.from_string(SIZE8),
                                         "m")
    assert geo == jgeo and np.array_equal(agg, jagg_)
    ref_j = jagg.geo_galerkin_dia(Asp, *jgeo)
    assert ref_j is not None
    n, nc = Asp.shape[0], int(agg.max()) + 1
    P = sps.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, nc))
    ref = (P.T @ Asp @ P).tocsr()
    M = TMatrix.from_scipy(Asp, device="cpu")
    outs = {
        "torch": tagg.geo_galerkin_dia(Asp, *geo, device="cpu"),
        "planes": tagg.geo_galerkin_dia(
            Asp, *geo, device="cpu", dia=(M.dia_offsets, M.dia_vals)),
    }
    for name, Ac in outs.items():
        assert Ac is not None, name
        assert abs(Ac - ref).max() < 1e-12, name
        assert abs(Ac - ref_j).max() < 1e-12, name
        # the same pattern and the same bits as the JAX package's
        assert np.array_equal(Ac.indptr, ref_j.indptr), name
        assert np.array_equal(Ac.indices, ref_j.indices), name
        assert np.array_equal(Ac.data, ref_j.data), name


def test_geo_galerkin_f32_device_twin_equals_host_twin():
    """In f32 the torch reductions sum each coarse entry in the order
    of the JAX package's host twin: the same bits."""
    Asp = j_poisson(12).to_scipy().astype(np.float32).tocsr()
    _, geo = tagg.select_aggregates(Asp, T.AMGConfig.from_string(SIZE8),
                                    "m")
    h = jagg.geo_galerkin_dia(Asp, *geo)
    d = tagg.geo_galerkin_dia(Asp, *geo, device="cpu")
    assert h.dtype == d.dtype == np.float32
    assert np.array_equal(h.data, d.data)
    assert np.array_equal(h.indices, d.indices)


def _periodic_2d(nx=8):
    n = nx * nx
    main = np.full(n, 4.0)
    ex = np.full(n - 1, -1.0)
    ex[nx - 1::nx] = 0.0
    ey = np.full(n - nx, -1.0)
    wrap = np.zeros(n - (nx - 1))
    wrap[::nx] = -1.0  # couples (0, y) <-> (nx - 1, y)
    return sps.diags_array(
        [main, ex, ex, ey, ey, wrap, wrap],
        offsets=[0, 1, -1, nx, -nx, nx - 1, -(nx - 1)]).tocsr()


@pytest.mark.parametrize("device", [None, "cpu"])
def test_geo_galerkin_rejects_wrap_and_ambiguity(device):
    # None: the default device
    kw = {} if device is None else {"device": device}
    A = _periodic_2d()
    assert jagg.geo_galerkin_dia(A, (8, 8, 1), (2, 2, 1)) is None
    assert tagg.geo_galerkin_dia(A, (8, 8, 1), (2, 2, 1), **kw) is None
    # offset +1 on a (2, 2, N) grid is ambiguous within reach 2
    assert jagg._decompose_offset(1, 2, 2, 100, 2) is None
    assert tagg._decompose_offset(1, 2, 2, 100, 2) is None
    # and on ragged blocks both fall back
    Asp = j_poisson(6).to_scipy()
    assert tagg.geo_galerkin_dia(Asp, (6, 6, 6), (4, 2, 2), **kw) is None
    assert jagg.geo_galerkin_dia(Asp, (6, 6, 6), (4, 2, 2)) is None


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_geo_rap_keys_and_decomposition_agree(pkg):
    mod = tagg if pkg == "torch" else jagg
    decs = ((0, 0, -1), (0, -1, 0), (-1, 0, 0), (0, 0, 0), (1, 0, 0),
            (0, 1, 0), (0, 0, 1))
    assert tagg._geo_rap_keys((2, 2, 2), decs) == \
        jagg._geo_rap_keys((2, 2, 2), decs)
    for off in (-144, -12, -1, 0, 1, 12, 144):
        assert mod._decompose_offset(off, 12, 12, 12, 2) == \
            jagg._decompose_offset(off, 12, 12, 12, 2)


BENCH = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-8, "monitor_residual": 1,'
    ' "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 64, "max_levels": 20,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
    ' "monitor_residual": 0}}}'
)


def test_geo_rap_dispatch_above_threshold(monkeypatch):
    """Above a lowered ``_GEO_RAP_MIN_ROWS`` the setup takes the
    geometric Galerkin product, fed the level's DIA planes on the
    solver's device; the hierarchy and the solve equal those of the
    sparse product."""
    A = T.SparseMatrix.from_scipy(j_poisson(16).to_scipy(), device="cpu")
    b = poisson_rhs(A.n_rows)
    cfg = T.AMGConfig.from_string(BENCH)
    base = T.create_solver(cfg, "default", device="cpu").setup(A)
    r0 = base.solve(b)

    monkeypatch.setattr(tagg, "_GEO_RAP_MIN_ROWS", 1000)
    calls = []
    real = tagg.geo_galerkin_dia

    def spy(Asp, grid, block, device="cpu", dia=None):
        out = real(Asp, grid, block, device=device, dia=dia)
        calls.append((Asp.shape[0], out is not None, device, dia is not None))
        return out

    monkeypatch.setattr(tagg, "geo_galerkin_dia", spy)
    s = T.create_solver(cfg, "default", device="cpu").setup(A)
    r1 = s.solve(b)
    assert (4096, True, torch.device("cpu"), True) in calls, calls
    assert "rap_execute" in s.precond.setup_profile
    for la, lb in zip(s.precond.levels, base.precond.levels):
        assert np.array_equal(la.A.to_dense(), lb.A.to_dense())
    assert (r1.status, r1.iters) == (r0.status, r0.iters)
    assert torch.equal(r1.x, r0.x)


def _random_graph():
    G = sps.random(3000, 3000, density=0.002,
                   random_state=np.random.default_rng(5))
    return ((G + G.T) != 0).astype(float).tocsr()


GRAPHS = {"poisson_16": lambda: j_poisson(16).to_scipy().tocsr(),
          "random_3000": _random_graph}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_device_matcher_bit_identical(graph):
    """The torch rounds (on CPU tensors) against the host matcher and
    the JAX package's device matcher."""
    A = GRAPHS[graph]()
    W = tagg.edge_weights(A, 0)
    Wj = jagg.edge_weights(A, 0)
    assert (W != Wj).nnz == 0
    h = tagg.pairwise_match(W)
    d = tagg.pairwise_match_device(W, device="cpu")
    j = jagg.pairwise_match_device(Wj)
    assert np.array_equal(h, d)
    assert np.array_equal(d, j)
    for merge in (False,):
        assert np.array_equal(
            tagg.pairwise_match(W, merge, 3),
            tagg.pairwise_match_device(W, merge, 3, device="cpu"))


def test_device_match_arrays_equal_jax():
    W = tagg.edge_weights(j_poisson(8).to_scipy().tocsr(), 0)
    for a, b in zip(tagg._match_ell_arrays(W), jagg._match_ell_arrays(W)):
        assert np.array_equal(a, b)
    # wider than the JAX package's gate (32): None there and here; the
    # torch rounds' gate (_DEVICE_ROUNDS_MAX_WIDTH) still takes 39
    # neighbours a row on the device, the host matcher's aggregates
    wide = sps.csr_matrix(np.ones((40, 40)) - np.eye(40))
    assert tagg._match_ell_arrays(wide) is None
    assert jagg._match_ell_arrays(wide) is None
    assert tagg._match_ell_arrays(
        wide, tagg._DEVICE_ROUNDS_MAX_WIDTH, device="cpu") is not None
    assert np.array_equal(tagg.pairwise_match_device(wide, device="cpu"),
                          tagg.pairwise_match(wide))


def test_device_matcher_wider_than_its_gate_takes_host(monkeypatch):
    """A graph of rows wider than the torch rounds' gate: no device
    arrays, and :func:`pairwise_match_device` returns the host
    matcher's aggregates without running the device rounds."""
    n = tagg._DEVICE_ROUNDS_MAX_WIDTH + 12
    wider = sps.csr_matrix(np.ones((n, n)) - np.eye(n))
    assert tagg._match_ell_arrays(
        wider, tagg._DEVICE_ROUNDS_MAX_WIDTH, device="cpu") is None

    def no_rounds(*a, **kw):
        raise AssertionError("device rounds on a graph wider than the gate")

    monkeypatch.setattr(tagg, "_device_match_rounds", no_rounds)
    assert np.array_equal(tagg.pairwise_match_device(wider, device="cpu"),
                          tagg.pairwise_match(wider))


def test_match_gate_compare_script_on_cpu(monkeypatch, capsys):
    """``ci/torch_match_gate_compare.py`` at small sizes on CPU tensors
    (the device rounds forced on): both gates give the same levels, and
    the narrow gate sends the block expansion's wide graph to the host
    rounds where the wide gate keeps it on the device rounds."""
    import importlib.util
    import json
    from pathlib import Path

    monkeypatch.setenv("AMGX_TPU_TORCH_DEVICE_MATCH", "1")
    # small graphs match through the device rounds too
    monkeypatch.setattr(tagg, "_DEVICE_MATCH_MIN_ROWS", 1000)
    path = Path(__file__).resolve().parent.parent / "ci" / \
        "torch_match_gate_compare.py"
    spec = importlib.util.spec_from_file_location("_gate_compare", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--n", "16",
                     "--block-n", "12"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    block = {r["mode"]: r for r in recs
             if r.get("path") == "block4_amg_pcg"}
    wide = [p for p in block["wide"]["matcher_passes"]
            if p["width"] > tagg._DEVICE_MATCH_MAX_WIDTH]
    assert wide and all(p["card"] for p in wide)
    assert not any(p["card"] for p in block["narrow"]["matcher_passes"]
                   if p["width"] > tagg._DEVICE_MATCH_MAX_WIDTH)
    assert set(recs[-1]["setup_s"]) == {"device_match", "block4_amg_pcg"}


def test_device_matching_gate(monkeypatch):
    monkeypatch.delenv("AMGX_TPU_TORCH_DEVICE_MATCH", raising=False)
    assert not tagg._device_matching_wanted("cpu")
    assert not tagg._device_matching_wanted(None)
    assert tagg._device_matching_wanted(torch.device("cuda", 0))
    monkeypatch.setenv("AMGX_TPU_TORCH_DEVICE_MATCH", "1")
    assert tagg._device_matching_wanted("cpu")
    monkeypatch.setenv("AMGX_TPU_TORCH_DEVICE_MATCH", "0")
    assert not tagg._device_matching_wanted(torch.device("cuda", 0))


SIZE2_MATCH = BENCH.replace('"selector": "SIZE_8",',
                            '"selector": "SIZE_2", '
                            '"structured_aggregation": 0,')


def test_size2_hierarchy_with_device_rounds_equals_host(monkeypatch):
    """PCG + SIZE_2 matching aggregation on 32^3: with the override the
    passes of 16,384 rows and more match with the torch rounds (counted
    as setup syncs); aggregates, levels and the solve equal the host
    matcher's."""
    sp = j_poisson(32).to_scipy()
    A = T.SparseMatrix.from_scipy(sp, device="cpu")
    b = poisson_rhs(A.n_rows)
    cfg = T.AMGConfig.from_string(SIZE2_MATCH)
    monkeypatch.setenv("AMGX_TPU_TORCH_DEVICE_MATCH", "0")
    host = T.create_solver(cfg, "default", device="cpu").setup(A)
    rh = host.solve(b)
    monkeypatch.setenv("AMGX_TPU_TORCH_DEVICE_MATCH", "1")
    calls = []
    real = tagg.pairwise_match_device

    def spy(W, *a, **kw):
        calls.append(W.shape[0])
        return real(W, *a, **kw)

    monkeypatch.setattr(tagg, "pairwise_match_device", spy)
    dev = T.create_solver(cfg, "default", device="cpu").setup(A)
    rd = dev.solve(b)
    assert calls and min(calls) >= tagg._DEVICE_MATCH_MIN_ROWS
    assert dev.precond.setup_profile.get("syncs", 0) > 0
    assert len(dev.precond.levels) == len(host.precond.levels)
    for la, lb in zip(dev.precond.levels[:-1], host.precond.levels[:-1]):
        assert np.array_equal(la.P.to_dense(), lb.P.to_dense())
    assert (rd.iters, rd.status) == (rh.iters, rh.status)
    assert torch.equal(rd.x, rh.x)
