"""The sliced, row-sorted ELL layout (SELL-C-sigma) of the PyTorch port.

``SparseMatrix.from_csr`` builds it beside the slot-major ELL arrays
where it streams fewer bytes (``core/matrix.py``); SpMV then takes it,
on the CPU through ``ops/ell.sell_spmv_plain``, on the card through the
``sell_spmv`` kernel (held to the plain versions by ``chip_smoke.py``).
These tests, on the CPU:

  * check the layout: every stored entry once, each row's slot order
    kept, ``rows`` a permutation inside the sigma-windows, every slice
    exactly as wide as its longest row;
  * hold ``sell_spmv_plain`` to ``ell_spmv_plain`` bit for bit on
    finite x (the slots it skips only add +0.0 or -0.0 there), on
    matrices of n not a multiple of 32, empty rows, one row of width
    128, uniform widths 1, 2 and 8, P- and R-shaped rectangles, f32 and
    f64, at every window;
  * hold the port's SpMV of the ELL operators of a classical hierarchy
    (the JAX package's host builder, 20^3 f64) and of aggregation
    hierarchies to the JAX package's ``ops.spmv`` at rtol 1e-12, and a
    whole classical solve to the JAX package's.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_3d_7pt as j_poisson
from amgx_tpu.io.poisson import poisson_rhs
from amgx_tpu.solvers import create_solver as j_create

import amgx_tpu_torch as T
from amgx_tpu_torch.amg.aggregation import geo_aggregate
from amgx_tpu_torch.core import matrix as cm
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.io.poisson import poisson_3d_7pt as t_poisson
from amgx_tpu_torch.ops import ell
from amgx_tpu_torch.ops import spmv as tspmv

jspmv = importlib.import_module("amgx_tpu.ops.spmv")

amgx_tpu.initialize()

PCG_CLASSICAL = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-6, "convergence": "RELATIVE_INI",'
    ' "monitor_residual": 1, "norm": "L2",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG", "cycle": "V",'
    ' "max_iters": 1, "presweeps": 1, "postsweeps": 1, "max_levels": 100,'
    ' "monitor_residual": 0, "setup_location": "HOST",'
    ' "smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}}}}'
)

BENCH = (
    '{"config_version": 2, "solver": {"scope": "main",'
    ' "solver": "PCG", "max_iters": 100, "tolerance": 1e-6,'
    ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG",'
    ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
    ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
    ' "relaxation_factor": 0.8, "monitor_residual": 0},'
    ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
    ' "min_coarse_rows": 32, "max_levels": 20,'
    ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
    ' "monitor_residual": 0}}}'
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _random_rows(m, k, top, seed, empty=0.2):
    """m x k CSR with row lengths 0..top (a share ``empty`` of rows
    empty), sorted columns, no duplicates."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, top + 1, m)
    lens[rng.random(m) < empty] = 0
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, k, rows.shape[0])
    sp = sps.csr_matrix((rng.standard_normal(rows.shape[0]), (rows, cols)),
                        shape=(m, k))
    sp.sum_duplicates()
    return sp


def _transfer(n, mode):
    """P of the geometric aggregation of an n^3 grid (``mode`` 3:
    2x2x2 aggregates, 1: 2x1x1), one entry a row."""
    agg = geo_aggregate(n, n, n, mode)
    return sps.csr_matrix((np.ones(agg.shape[0]),
                           (np.arange(agg.shape[0]), agg)))


def _p_shaped(seed=3):
    """Classical-P shape: 700 C rows of one entry among 1300 F rows of
    2-6, 2000 x 700."""
    rng = np.random.default_rng(seed)
    n, nc = 2000, 700
    c_rows = np.sort(rng.choice(n, nc, replace=False))
    lens = rng.integers(2, 7, n)
    lens[c_rows] = 1
    rows = np.repeat(np.arange(n), lens)
    cols = rng.integers(0, nc, rows.shape[0])
    cols[np.searchsorted(rows, c_rows)] = np.arange(nc)
    sp = sps.csr_matrix((rng.standard_normal(rows.shape[0]), (rows, cols)),
                        shape=(n, nc))
    sp.sum_duplicates()
    return sp


CASES = {
    "n=1007 widths 0-40, empty rows": lambda: _random_rows(1007, 1007, 40, 1),
    "n=77 widths 0-128": lambda: _random_rows(77, 300, 128, 2, empty=0.1),
    "one row of width 128": lambda: sps.csr_matrix(
        (np.linspace(-1.0, 1.0, 128), (np.zeros(128, int), np.arange(128))),
        shape=(1, 500)),
    "uniform w=1 (P)": lambda: _transfer(8, 3),
    "uniform w=2 (SIZE_2 R)": lambda: _transfer(8, 1).T.tocsr(),
    "uniform w=8 (SIZE_8 R)": lambda: _transfer(8, 3).T.tocsr(),
    "P-shaped 2000x700": _p_shaped,
    "R-shaped 700x2000": lambda: _p_shaped().T.tocsr(),
}


def _host(sp, dtype):
    sp = sp.astype(dtype).tocsr()
    sp.sort_indices()
    return (sp.indptr.astype(np.int32), sp.indices.astype(np.int32),
            sp.data, sp.shape)


def _sliced(sp, dtype, sigma):
    """(SlicedEll on the CPU built at window ``sigma`` whether or not
    the upload would take it, the host CSR)."""
    ro, ci, v, (n, _) = _host(sp, dtype)
    w = int(np.diff(ro).max()) if ci.size else 0
    h = cm._build_sell_np(ro, ci, v, n, w, sigmas=(sigma,), always=True)
    return cm.sliced_ell(h, "cpu"), (ro, ci, v)


@pytest.mark.parametrize("sigma", cm.SELL_SIGMAS)
@pytest.mark.parametrize("case", list(CASES))
def test_layout_invariants(case, sigma):
    S, (ro, ci, v) = _sliced(CASES[case](), np.float64, sigma)
    n = ro.shape[0] - 1
    lens = np.diff(ro)
    cols, vals = S.cols.numpy(), S.vals.numpy()
    offs, widths = S.offsets.numpy(), S.widths.numpy()
    assert S.offsets.dtype == torch.int64 and S.widths.dtype == torch.int32
    assert S.cols.dtype == torch.int32 and S.n_slices == -(-n // 32)
    assert offs[0] == 0 and np.array_equal(np.diff(offs), 32 * widths)
    assert S.stored == offs[-1] == 32 * widths.sum()
    assert (S.sigma, S.lanes in (1, 2, 4, 8)) == (sigma, True)
    # rows: a permutation that moves rows only inside their window
    if sigma == 1:
        assert S.rows is None
        order = np.arange(n)
    else:
        order = S.rows.numpy()
        assert S.rows.dtype == torch.int32
        assert np.array_equal(np.sort(order), np.arange(n))
        assert np.array_equal(order // sigma, np.arange(n) // sigma)
        # longest first inside each window
        key = order // sigma * (lens.max() + 1) + lens.max() - lens[order]
        assert np.all(np.diff(key) >= 0)
    plens = np.zeros(S.n_slices * 32, dtype=np.int64)
    plens[:n] = lens[order]
    # every slice exactly as wide as its longest row
    assert np.array_equal(widths, plens.reshape(-1, 32).max(axis=1))
    # every stored entry once, in its row's slot order; padding 0 / 0
    seen = np.zeros(cols.shape[0], dtype=bool)
    for p in range(n):
        r, k, lane = order[p], p // 32, p % 32
        at = offs[k] + 32 * np.arange(lens[r]) + lane
        assert np.array_equal(cols[at], ci[ro[r]:ro[r + 1]])
        assert np.array_equal(vals[at], v[ro[r]:ro[r + 1]])
        seen[at] = True
    assert not cols[~seen].any() and not vals[~seen].any()
    assert seen.sum() == ci.shape[0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sigma", cm.SELL_SIGMAS)
@pytest.mark.parametrize("case", list(CASES))
def test_sliced_plain_equals_slot_major_plain(case, sigma, dtype):
    sp = CASES[case]()
    S, (ro, ci, v) = _sliced(sp, dtype, sigma)
    A = TMatrix.from_csr(ro, ci, v, n_cols=sp.shape[1], device="cpu",
                         accel_formats=("ell",))
    assert A.has_ell
    x = torch.from_numpy(
        np.random.default_rng(7).standard_normal(sp.shape[1]).astype(dtype))
    y = ell.sell_spmv_plain(S, x)
    assert y.dtype == x.dtype and y.shape == (sp.shape[0],)
    assert torch.equal(y, ell.ell_spmv_plain(A.ell_cols, A.ell_vals, x))
    np.testing.assert_allclose(y.numpy(), sp.astype(dtype) @ x.numpy(),
                               rtol=1e-5 if dtype == np.float32 else 1e-12,
                               atol=1e-5 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("case,built", [
    ("n=1007 widths 0-40, empty rows", True), ("n=77 widths 0-128", True),
    ("one row of width 128", False), ("uniform w=1 (P)", False),
    ("uniform w=2 (SIZE_2 R)", False), ("uniform w=8 (SIZE_8 R)", False),
    ("P-shaped 2000x700", True), ("R-shaped 700x2000", True),
])
def test_upload_builds_the_sliced_layout_where_it_streams_fewer_bytes(
        case, built):
    """Uniform widths (the aggregation transfers) and a lone row (a
    whole slice of padding rows) keep the slot-major kernel; the
    slot-major arrays are built as before either way."""
    sp = CASES[case]()
    ro, ci, v, shape = _host(sp, np.float32)
    A = TMatrix.from_csr(ro, ci, v, n_cols=shape[1], device="cpu",
                         accel_formats=("ell",))
    assert A.format == "ELL" and (A.sell is not None) == built
    w = int(np.diff(ro).max())
    assert tuple(A.ell_vals.shape) == (w, shape[0])
    if built:
        lens = np.diff(ro).astype(np.int64)
        limit = shape[0] * w * 8
        nbytes, sigma, _, widths = cm.sell_plan_np(lens, 4, limit)
        assert A.sell.sigma == sigma and nbytes < limit
        assert A.sell.lanes == cm.sell_lanes(widths)
        # the chosen window: within SELL_WINDOW_GAIN of the fewest bytes,
        # and no narrower window is
        cost = {s: cm.sell_stream_bytes(
            cm.sell_widths_np(lens, cm.sell_order_np(lens, s)),
            shape[0], 4, s) for s in cm.SELL_SIGMAS}
        assert cost[sigma] == nbytes
        assert nbytes <= cm.SELL_WINDOW_GAIN * min(cost.values())
        assert all(cost[s] > cm.SELL_WINDOW_GAIN * min(cost.values())
                   for s in cm.SELL_SIGMAS if s < sigma)


def test_window_choice_weighs_bytes_against_locality():
    """A few long rows among one-entry rows (5 % of rows 40 long): the
    widest window streams about 3x fewer bytes than 128 and is taken;
    lengths that vary little keep a narrower window; uniform lengths
    stream no fewer bytes sliced than slot-major."""
    rng = np.random.default_rng(0)
    lens = np.where(rng.random(20000) < 0.05, 40, 1)
    assert cm.sell_plan_np(lens, 4)[1] == 1024
    lens = 18 + rng.integers(-3, 4, 5000)
    assert cm.sell_plan_np(lens, 4)[1] in (1, 128)
    assert cm.sell_plan_np(np.full(100, 7), 4)[1] == 1
    assert cm.sell_plan_np(np.full(4096, 7), 4, limit=4096 * 7 * 8) is None


@pytest.mark.parametrize("slices,mean,lanes", [
    (65536, 2.2, 1), (20299, 18.7, 1), (4203, 46.4, 1), (1000, 1.5, 1),
    (739, 12.2, 8), (739, 57.5, 8), (122, 11.5, 8), (122, 6.0, 4),
    (2000, 3.0, 2), (10, 116.0, 8), (0, 0.0, 1),
])
def test_lanes_per_row_fill_the_card_on_small_matrices(slices, mean, lanes):
    """One lane a row where the slices alone fill the card; on fewer
    slices more lanes, up to 8, while each keeps a slot."""
    assert cm.sell_lanes(np.full(slices, mean)) == lanes


def test_spmv_takes_the_sliced_plain_version_on_cpu(monkeypatch):
    sp = _p_shaped()
    A = TMatrix.from_scipy(sp, device="cpu", accel_formats=("ell",))
    assert A.sell is not None
    calls = []
    real = ell.sell_spmv_plain
    monkeypatch.setattr(ell, "sell_spmv_plain",
                        lambda S, x: calls.append(1) or real(S, x))
    e0, s0 = ell.launches, ell.sell_launches
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(700))
    y = tspmv.spmv(A, x)
    assert calls == [1] and (ell.launches, ell.sell_launches) == (e0, s0)
    np.testing.assert_allclose(y.numpy(), sp @ x.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_non_cpu_tensors_never_take_the_sliced_plain_version():
    S, _ = _sliced(_p_shaped(), np.float32, 128)
    meta = ell.SlicedEll(
        **{k: None if getattr(S, k) is None else torch.empty_like(
            getattr(S, k), device="meta")
           for k in ("cols", "vals", "offsets", "widths", "rows")},
        n_rows=S.n_rows, sigma=S.sigma, lanes=S.lanes)
    x = torch.empty((700,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ell.sell_spmv(meta, x)


def test_non_finite_x_no_longer_reaches_skipped_padding():
    """A row shorter than the matrix-wide width reads 0 * x[0] from the
    slot-major padding; the sliced layout stores no such slot when its
    slice is narrower, so an inf in x[0] leaves that row finite.  Rows
    0-31 hold one entry (column 1, then 2), row 32 three (0, 1, 2):
    slice 0 is one slot wide, slice 1 three."""
    ro = np.concatenate([np.arange(33), [35]]).astype(np.int32)
    ci = np.array([1] + [2] * 31 + [0, 1, 2], dtype=np.int32)
    v = np.arange(1.0, 36.0)
    x = torch.tensor([np.inf, 1.0, 2.0], dtype=torch.float64)
    A = TMatrix.from_csr(ro, ci, v, n_cols=3, device="cpu",
                         accel_formats=("ell",))
    S = cm.sliced_ell(cm._build_sell_np(ro, ci, v, 33, 3, sigmas=(1,),
                                        always=True), "cpu")
    assert S.widths.tolist() == [1, 3]
    y_slot = ell.ell_spmv_plain(A.ell_cols, A.ell_vals, x)
    y_sell = ell.sell_spmv_plain(S, x)
    assert bool(torch.isnan(y_slot[:32]).all())
    assert torch.equal(y_sell[:32], torch.tensor([1.0] + list(
        2.0 * np.arange(2.0, 33.0)), dtype=torch.float64))
    assert torch.isinf(y_sell[32]) and torch.isinf(y_slot[32])


# ------------------------------------------------- against the JAX package


def _jax_hierarchy(cfg_text, n):
    A = j_poisson(n, dtype=np.float64)
    s = j_create(JConfig.from_string(cfg_text), "default")
    s.setup(A)
    return s


_HIER = {}


def _ell_operators(key):
    """(label, JAX matrix) of every ELL operator (slot-major gather
    path) of the JAX package's hierarchy ``key``."""
    if key not in _HIER:
        cfg_text, n = {"classical_20": (PCG_CLASSICAL, 20),
                       "aggregation_25": (BENCH, 25),
                       "aggregation_24": (BENCH, 24)}[key]
        s = _jax_hierarchy(cfg_text, n)
        ops = []
        for i, lv in enumerate(s.precond.levels):
            for f in ("A", "P", "R"):
                M = getattr(lv, f, None)
                if M is not None and M.has_ell and not M.has_dia \
                        and not M.has_dense:
                    ops.append((f"level{i} {f}", M))
        _HIER[key] = ops
    return _HIER[key]


@pytest.mark.parametrize("key,sliced", [
    ("classical_20", {"level0 P", "level0 R"}),
    ("aggregation_25", {"level0 R"}),
    ("aggregation_24", set()),
])
def test_hierarchy_ell_operators_match_jax(key, sliced):
    """The port's SpMV of each ELL operator (sliced plain version where
    the upload built the layout: the operators ``sliced`` names) against the JAX package's at rtol 1e-12, and bit for
    bit against the slot-major plain version.  The uniform aggregation
    transfers keep the slot-major layout; at 25^3 the boundary
    aggregates make R's rows uneven."""
    ops = _ell_operators(key)
    assert ops
    rng = np.random.default_rng(9)
    for label, J in ops:
        T_ = TMatrix.from_csr(np.asarray(J.row_offsets),
                              np.asarray(J.col_indices),
                              np.asarray(J.values), n_cols=J.n_cols,
                              device="cpu")
        assert T_.format == "ELL", label
        assert (T_.sell is not None) == (label in sliced), label
        x = rng.standard_normal(J.n_cols)
        y = tspmv.spmv(T_, torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), np.asarray(jspmv.spmv(J, x)),
                                   rtol=1e-12, atol=1e-12)
        assert torch.equal(y, ell.ell_spmv_plain(
            T_.ell_cols, T_.ell_vals, torch.from_numpy(x)))


def test_classical_solve_through_sliced_operators_matches_jax():
    """PCG_CLASSICAL at 20^3 f64, host setup in both packages: the
    port's ELL operators take the sliced layout, and the solve gives
    the JAX package's iterations and x at rtol 1e-10."""
    A = j_poisson(20, dtype=np.float64)
    b = poisson_rhs(A.n_rows, dtype=np.float64)
    js = j_create(JConfig.from_string(PCG_CLASSICAL), "default")
    js.setup(A)
    jr = js.solve(b)
    ts = T.create_solver(T.AMGConfig.from_string(PCG_CLASSICAL), "default",
                         device="cpu")
    ts.setup(t_poisson(20, dtype=np.float64, device="cpu"))
    sliced = [m for lv in ts.precond.levels for m in (lv.A, lv.P, lv.R)
              if m is not None and m.sell is not None]
    assert len(sliced) >= 2
    tr = ts.solve(b)
    assert tr.status == int(jr.status) == 0
    assert tr.iters == int(jr.iters)
    xj = np.asarray(jr.x)
    np.testing.assert_allclose(tr.x.numpy(), xj, rtol=1e-10,
                               atol=1e-10 * np.abs(xj).max())
