"""The batched sliced ELL SpMV (``ops/ell.sell_spmv_batched``) and the
sliced layout that batched views and serve templates keep, held to the
JAX package's ELL path under ``jax.vmap`` on the CPU (the wrappers take
their plain versions on CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from amgx_tpu.ops.spmv import spmv as jspmv
from amgx_tpu.serve import bucketing as jbuck
from amgx_tpu_torch.core.matrix import SparseMatrix
from amgx_tpu_torch.ops import ell as tell
from amgx_tpu_torch.ops import kernels
from amgx_tpu_torch.ops import spmv as tspmv
from amgx_tpu_torch.serve import bucketing as tbuck
from tests.test_torch_serve import (
    DEFAULT_CONFIG,
    both,
    counters,
    irregular_sp,
    same_results,
)

DTYPES = [(np.float64, 1e-12), (np.float32, 2e-5)]


def irregular_family_sp(m, seed):
    """``chip_smoke.irregular_family``'s pattern at ``m``^3 (shuffled
    Poisson plus random long-range couplings), its values jittered."""
    import chip_smoke

    return chip_smoke.irregular_family(m, 1, seed=seed)[0][0]


PATTERNS = {"irregular_100": lambda: irregular_sp(100, 3),
            "irregular_poisson_12": lambda: irregular_family_sp(12, 4)}


def template(case, dtype):
    """The padded template of pattern ``case`` in both packages (ELL)."""
    sp = PATTERNS[case]().tocsr()
    sp.sort_indices()
    n = sp.shape[0]
    tp = tbuck.pad_pattern(sp.indptr, sp.indices, n)
    jp = jbuck.pad_pattern(sp.indptr, sp.indices, n)
    A = tp.template_matrix(sp.data, dtype, accel_formats=("ell",),
                           device="cpu")
    JA = jp.template_matrix(sp.data, dtype, accel_formats=("ell",))
    assert A.format == "ELL" and A.sell is not None
    return sp, tp, A, JA


def batch_values(sp, tp, B, dtype, seed):
    rng = np.random.default_rng(seed)
    return np.stack([tp.embed_values(
        sp.data * (1.0 + 0.05 * rng.standard_normal(sp.nnz)), dtype)
        for _ in range(B)])


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("case", sorted(PATTERNS))
def test_sell_batched_plain_matches_jax_vmap(case, dtype, rtol, shared):
    sp, tp, A, JA = template(case, dtype)
    B = 3
    V = batch_values(sp, tp, B, dtype, seed=1)
    X = np.random.default_rng(2).standard_normal((B, tp.nb)).astype(dtype)
    if shared:
        S = A.sell
        yj = jax.vmap(lambda x: jspmv(JA, x))(jnp.asarray(X))
    else:
        S = A.replace_values_batched(torch.from_numpy(V)).sell
        yj = jax.vmap(lambda v, x: jspmv(JA.replace_values(v), x))(
            jnp.asarray(V), jnp.asarray(X))
    yj = np.asarray(yj)
    y = tell.sell_spmv_batched(S, torch.from_numpy(X))
    assert y.dtype == torch.from_numpy(X).dtype and y.shape == (B, tp.nb)
    np.testing.assert_allclose(y.numpy(), yj, rtol=rtol,
                               atol=rtol * np.abs(yj).max())
    np.testing.assert_array_equal(
        y.numpy(), tell.sell_spmv_batched_plain(S, torch.from_numpy(X)))
    assert tell.sell_batched_launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shared", [False, True])
def test_sell_batched_instances_bitwise_unbatched(dtype, shared):
    """Each instance of the batch is the unbatched sliced product of
    ``replace_values(V[i])`` bit for bit, and the slot-major product
    too (finite x)."""
    sp, tp, A, _ = template("irregular_poisson_12", dtype)
    B = 4
    V = torch.from_numpy(batch_values(sp, tp, B, dtype, seed=3))
    X = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, tp.nb)).astype(dtype))
    S = A.sell if shared else A.replace_values_batched(V).sell
    y = tell.sell_spmv_batched(S, X)
    for i in range(B):
        Ai = A if shared else A.replace_values(V[i])
        assert torch.equal(y[i], tell.sell_spmv_plain(Ai.sell, X[i]))
        assert torch.equal(y[i], tell.sell_spmv(Ai.sell, X[i]))
        assert torch.equal(y[i], tell.ell_spmv_plain(Ai.ell_cols,
                                                     Ai.ell_vals, X[i]))


@pytest.mark.parametrize("case", sorted(PATTERNS))
def test_batched_view_sell_values_and_shared_structure(case):
    sp, tp, A, _ = template(case, np.float64)
    B = 3
    V = torch.from_numpy(batch_values(sp, tp, B, np.float64, seed=5))
    Ab = A.replace_values_batched(V)
    S, S0 = Ab.sell, A.sell
    assert S.vals.shape == (B, S0.stored) and S.stored == S0.stored
    for name in ("cols", "offsets", "widths", "rows"):
        assert getattr(S, name) is getattr(S0, name)
    assert (S.n_rows, S.sigma, S.lanes) == (S0.n_rows, S0.sigma, S0.lanes)
    pad = A._src_maps()["sell"] < 0
    assert bool(pad.any())
    for i in range(B):
        Si = A.replace_values(V[i]).sell
        assert torch.equal(S.vals[i], Si.vals)
        assert not bool(S.vals[i][pad].any())
    # the view keeps the sliced layout alone: no batched SpMV reads a
    # slot-major copy once ``sell`` is there
    assert Ab.ell_vals is None and Ab.ell_cols is None
    assert Ab.has_ell and Ab.format == "ELL"


def _route(monkeypatch):
    seen = []
    for name in ("sell_spmv_batched", "ell_spmv_batched"):
        real = getattr(tspmv, name)

        def record(*a, _name=name, _real=real):
            seen.append(_name)
            return _real(*a)

        monkeypatch.setattr(tspmv, name, record)
    return seen


def uniform_transfer():
    """A SIZE_8-like aggregation transfer: every row one entry, so the
    sliced layout would stream no fewer bytes and is not built."""
    n, nc = 64, 8
    P = sps.csr_matrix((np.ones(n), (np.arange(n), np.arange(n) // 8)),
                       shape=(n, nc))
    return SparseMatrix.from_scipy(P, accel_formats=("ell",), device="cpu")


@pytest.mark.parametrize("matrix,batched,want", [
    ("sliced", True, "sell_spmv_batched"),
    ("sliced", False, "sell_spmv_batched"),
    ("slot_major", False, "ell_spmv_batched"),
    ("slot_major", True, "ell_spmv_batched"),
])
def test_spmv_batched_routing(monkeypatch, matrix, batched, want):
    if matrix == "sliced":
        sp, tp, A, _ = template("irregular_100", np.float64)
    else:
        A = uniform_transfer()
        assert A.format == "ELL" and A.sell is None
    rng = np.random.default_rng(6)
    B = 2
    M = (A.replace_values_batched(torch.from_numpy(
        rng.standard_normal((B, A.nnz)))) if batched else A)
    X = torch.from_numpy(rng.standard_normal((B, A.n_cols)))
    seen = _route(monkeypatch)
    counts = (tell.sell_batched_launches, tell.batched_launches,
              dict(tell.variant_launches))
    Y = tspmv.spmv(M, X)
    assert seen == [want]
    for i in range(B):
        Mi = (A.replace_values(M.values[i]) if batched else A)
        np.testing.assert_array_equal(Y[i].numpy(),
                                      tspmv.spmv(Mi, X[i]).numpy())
    # the card's counters stay as they were on the CPU
    assert counts == (tell.sell_batched_launches, tell.batched_launches,
                      dict(tell.variant_launches))


def test_sell_batched_refuses_mismatched_shapes():
    _, tp, A, _ = template("irregular_100", np.float64)
    V = torch.zeros((3, A.sell.stored), dtype=torch.float64)
    S = dataclasses.replace(A.sell, vals=V)
    with pytest.raises(ValueError, match="sell_spmv_batched"):
        tell.sell_spmv_batched(S, torch.zeros((2, tp.nb),
                                              dtype=torch.float64))
    with pytest.raises(ValueError, match="sell_spmv_batched"):
        tell.sell_spmv_batched(A.sell, torch.zeros(tp.nb,
                                                   dtype=torch.float64))
    with pytest.raises(ValueError, match="sell_spmv_batched"):
        tell.sell_spmv_batched(
            dataclasses.replace(A.sell, vals=V[:, :-1]),
            torch.zeros((3, tp.nb), dtype=torch.float64))


@pytest.mark.parametrize("dtype,short", [(torch.float32, "f32"),
                                         (torch.float64, "f64")])
def test_sell_batched_entry_points_registered(dtype, short):
    name = kernels.entry_point("sell_spmv_batched", dtype, dtype)
    assert name == f"sell_spmv_batched_{short}"
    assert kernels.library_of("sell_spmv_batched") == "ell_spmv"
    assert kernels._SIGNATURES["ell_spmv"][name] == kernels._SELL_BATCHED
    # no bf16 or mixed entry: the wrapper raises for them on the card
    assert kernels.entry_point("sell_spmv_batched", torch.bfloat16,
                               torch.bfloat16) is None
    assert kernels.entry_point("sell_spmv_batched", torch.float32,
                               torch.float64) is None
    src = (kernels.CSRC / "ell_spmv.cu").read_text()
    assert f'extern "C" int {name}(' in src


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_irregular_service_takes_sliced_batched_spmv_as_jax(monkeypatch,
                                                            dtype):
    """The service on the irregular pattern: its template keeps the
    sliced layout, every batched SpMV of the group takes the sliced
    entry, and results and counters are the JAX service's."""
    import chip_smoke

    systems = chip_smoke.irregular_family(12, 3, seed=7, dtype=dtype)
    seen = _route(monkeypatch)
    tr, jr, ts, js = both(systems, DEFAULT_CONFIG, max_batch=4)
    same_results(tr, jr, rtol=1e-10 if dtype == np.float64 else 1e-5)
    assert counters(ts) == counters(js)
    A = next(iter(ts.cache._entries.values())).solver.A
    assert A.format == "ELL" and A.sell is not None
    assert seen and set(seen) == {"sell_spmv_batched"}
