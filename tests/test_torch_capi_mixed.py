"""The mixed dtype pairs of the C API's mixed modes (dDFI / dIFI: f32
matrix, f64 vectors; dFBI: bf16 matrix, f32 vectors) on the CPU.

The four entry points they add (``dia_spmv_f32_f64``,
``dia_spmv_bf16_f32``, ``sell_spmv_f32_f64``, ``sell_spmv_bf16_f32``)
run only on the card; here: each is registered and named by
``kernels.entry_point`` for its pair, the DIA launch plan sizes its
plane vectors by the planes and keeps the wider type's vectors within
16 bytes, and the plain versions the kernels are held to on the card
match the JAX package's XLA paths (``_spmv_dia`` and the ELL gather):
the promoted dtype, values to rtol 1e-12 (f64 result) and 2e-5 (f32)
of the row's |A||x|.  Then the mixed modes' solves on an unstructured
upload that takes the sliced layout (``chip_smoke.irregular_poisson``)
through both C API handle layers, the entry points such a solve would
launch on the card (by the same walk ``chip_smoke.py`` holds the
card's counts to), and the capi phase of ``chip_smoke.py`` rehearsed
on the CPU.
"""

import collections
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amgx_tpu
import chip_smoke
from amgx_tpu.api import capi as J
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_scipy
from amgx_tpu_torch.api import capi as T
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.core.types import host_array
from amgx_tpu_torch.ops import dia, ell, kernels
from amgx_tpu_torch.ops import spmv as tspmv
from tests.test_torch_capi import CFG, handle_flow

amgx_tpu.initialize()
jspmv = importlib.import_module("amgx_tpu.ops.spmv")

PAIRS = [("float32", "float64"), ("bfloat16", "float32")]
STAR = (-4096, -64, -1, 0, 1, 64, 4096)


@pytest.fixture(autouse=True)
def _init():
    J.initialize()
    T.initialize()
    yield
    J.finalize()
    T.finalize()


@pytest.mark.parametrize("kernel", ["dia_spmv", "sell_spmv"])
@pytest.mark.parametrize("vals,xdt", PAIRS)
def test_entry_points_registered(kernel, vals, xdt):
    name = kernels.entry_point(kernel, getattr(torch, vals),
                               getattr(torch, xdt))
    short = {"float32": "f32", "float64": "f64", "bfloat16": "bf16"}
    assert name == f"{kernel}_{short[vals]}_{short[xdt]}"
    lib = "ell_spmv" if kernel == "sell_spmv" else kernel
    sig = kernels._SIGNATURES[lib][name]
    assert sig == (kernels._DIA if kernel == "dia_spmv" else kernels._SELL)
    # the pairs no mode feeds stay unbuilt: the wider type is x's
    assert kernels.entry_point(kernel, getattr(torch, xdt),
                               getattr(torch, vals)) is None


@pytest.mark.parametrize("vals,xdt,vec", [
    ("float32", "float64", 2), ("bfloat16", "float32", 4)])
def test_mixed_plan_sizes_planes_and_keeps_y_within_16_bytes(vals, xdt,
                                                             vec):
    """vec is one VEC_BYTES vector of the planes; y, in the wider x
    type, takes a vector of vec values, at most 16 bytes; alignment is
    that of the wider type's vector."""
    v, x = getattr(torch, vals), getattr(torch, xdt)
    plan = dia.dia_launch_plan(1 << 21, STAR, v, x_dtype=x)
    assert plan.vec == vec
    assert plan.vec * v.itemsize <= dia.VEC_BYTES
    assert plan.vec * x.itemsize <= 16
    # an 8-byte alignment holds one f64 or two f32 values of y
    half = dia.dia_launch_plan(1 << 21, STAR, v, align=8, x_dtype=x)
    assert half.vec == 8 // x.itemsize
    # the same-type plans are unchanged by x_dtype
    for t in (torch.float32, torch.float64, torch.bfloat16):
        assert dia.dia_launch_plan(1 << 21, STAR, t, x_dtype=t) == \
            dia.dia_launch_plan(1 << 21, STAR, t)


def _row_scale(At, xt):
    import scipy.sparse as sps

    ro, ci, _ = At._host
    absA = sps.csr_matrix((np.abs(host_array(At.values).astype(np.float64)),
                           ci, ro), shape=At.shape)
    return absA @ np.abs(host_array(xt).astype(np.float64))


def _check(yt, yj, scale):
    assert str(yt.dtype)[6:] == str(jnp.asarray(yj).dtype)
    d = np.abs(host_array(yt).astype(np.float64)
               - np.asarray(yj, np.float64))
    rtol = 1e-12 if yt.dtype == torch.float64 else 2e-5
    assert np.all(d <= rtol * scale + 1e-300), float(np.max(d / scale))


@pytest.mark.parametrize("vals,xdt", PAIRS)
def test_dia_plain_matches_the_jax_xla_path(vals, xdt):
    sp = poisson_scipy((20, 19, 18)).tocsr()
    rng = np.random.default_rng(5)
    sp.data = sp.data * rng.uniform(0.5, 1.5, sp.nnz)
    At = TMatrix.from_scipy(sp, device="cpu").astype(vals)
    Aj = JMatrix.from_scipy(sp).astype(jnp.dtype(vals))
    assert At.has_dia and Aj.has_dia
    x = rng.standard_normal(sp.shape[0])
    xt = torch.from_numpy(x).to(getattr(torch, xdt))
    xj = jnp.asarray(x).astype(jnp.dtype(xdt))
    yj = jspmv._spmv_dia(Aj, xj)
    yt = dia.dia_spmv_plain(At.dia_vals, At.dia_offsets, xt)
    assert yt.dtype == getattr(torch, xdt)
    _check(yt, yj, _row_scale(At, xt))
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(dia.dia_spmv(At.dia_vals, At.dia_offsets, xt), yt)


@pytest.mark.parametrize("vals,xdt", PAIRS)
def test_sell_plain_matches_the_jax_ell_gather(vals, xdt):
    sp = chip_smoke.irregular_poisson(24, seed=2)
    At = TMatrix.from_scipy(sp, device="cpu")
    assert At.format == "ELL" and At.sell is not None
    At = At.astype(vals)
    Aj = JMatrix.from_scipy(sp).astype(jnp.dtype(vals))
    assert Aj.has_ell and not Aj.has_dia and not Aj.has_dense
    rng = np.random.default_rng(6)
    x = rng.standard_normal(sp.shape[0])
    xt = torch.from_numpy(x).to(getattr(torch, xdt))
    xj = jnp.asarray(x).astype(jnp.dtype(xdt))
    yj = jspmv._spmv_scalar(Aj, xj)
    yt = ell.sell_spmv_plain(At.sell, xt)
    assert yt.dtype == getattr(torch, xdt)
    _check(yt, yj, _row_scale(At, xt))
    # bf16 values keep one lane a row; the slot-major plain version
    # gives the same bits for finite x
    assert At.sell.lanes == 1 or vals != "bfloat16"
    assert torch.equal(ell.ell_spmv_plain(At.ell_cols, At.ell_vals, xt), yt)


def _flow(C, mode, sp, b):
    st, it, x, _, h = handle_flow(C, mode, CFG, sp=sp, rhs=b)
    return st, it, x, C._get(h["s"]).solver


@pytest.mark.parametrize("mode", ["hDFI", "hIFI", "hFBI"])
def test_mixed_modes_on_the_sliced_layout_match_the_jax_package(mode):
    """PCG + BLOCK_JACOBI on an unstructured upload (the sliced ELL
    layout) in the mixed modes: the port's handle layer against the JAX
    package's, and every SpMV on the entry point the card would launch
    (counted by wrapping the dispatch), as ``jacobi_pcg_launches``
    derives it."""
    sp = chip_smoke.irregular_poisson(20, seed=1)
    b = np.random.default_rng(9).standard_normal(sp.shape[0])
    sj, ij, xj, _ = _flow(J, mode, sp, b)
    seen = collections.Counter()
    orig = tspmv._spmv_scalar

    def counted(A, x):
        seen[chip_smoke.variant_of(A, x.dtype)] += 1
        return orig(A, x)

    tspmv._spmv_scalar = counted
    try:
        st, it, xt, s = _flow(T, mode, sp, b)
    finally:
        tspmv._spmv_scalar = orig
    assert s.A.sell is not None
    assert st == sj == 0
    scale = float(np.max(np.abs(xj)))
    if mode == "hFBI":
        assert s.A.dtype == torch.bfloat16 and xt.dtype == np.float32
        assert abs(it - ij) <= 1
        np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-4 * scale)
        want = "sell_spmv_bf16_f32"
    else:
        assert s.A.dtype == torch.float32 and xt.dtype == np.float64
        assert it == ij
        np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-10 * scale)
        want = "sell_spmv_f32_f64"
    assert dict(seen) == {want: chip_smoke.jacobi_pcg_launches(s, it)}


def test_bench_in_dDFI_walks_the_mixed_dia_entry_point():
    """The bench AMG config in hDFI: PCG's A p meets the f32 planes with
    f64 vectors (``dia_spmv_f32_f64``); the cycle runs in the hierarchy's
    f32 (both packages cast at the preconditioner's boundary), so every
    cycle SpMV takes an f32 entry point and no ELL transfer meets an f64
    vector.  The counted entry points equal ``chip_smoke``'s walk."""
    sp = poisson_scipy((24, 24, 24)).tocsr()
    b = np.random.default_rng(2).standard_normal(sp.shape[0])
    seen = collections.Counter()
    orig = tspmv._spmv_scalar

    def counted(A, x):
        seen[chip_smoke.variant_of(A, x.dtype)] += 1
        return orig(A, x)

    c = T.config_create(chip_smoke.BENCH_CFG)
    r = T.resources_create_simple(c)
    A = T.matrix_create(r, "hDFI")
    T.matrix_upload_all(A, sp.shape[0], sp.nnz, 1, 1, sp.indptr, sp.indices,
                        sp.data)
    vb, vx = T.vector_create(r, "hDFI"), T.vector_create(r, "hDFI")
    T.vector_upload(vb, sp.shape[0], 1, b)
    T.vector_set_zero(vx, sp.shape[0], 1)
    s = T.solver_create(r, "hDFI", c)
    tspmv._spmv_scalar = counted
    try:
        T.solver_setup(s, A)
        T.solver_solve(s, vb, vx)
    finally:
        tspmv._spmv_scalar = orig
    it = T.solver_get_iterations_number(s)
    amg = T._get(s).solver.precond
    A0 = amg.levels[0].A
    want = chip_smoke.derived_variant_launches(
        amg, it + 1, top=((A0, torch.float64, it + 1),))
    seen.pop(None, None)  # the dense coarse level: no kernel
    assert dict(seen) == want
    assert want["dia_spmv_f32_f64"] == it + 1
    assert "ell_spmv_f32_f64" not in want and want["ell_spmv_f32"] > 0


def test_capi_phase_rehearsed_on_the_cpu():
    """chip_smoke.capi_phase at a tiny size on the CPU (h modes): every
    check but the card's launch counts and kernel cases runs, the
    native shim and the C host program included."""
    variants, recs, counts = chip_smoke.capi_phase(
        torch, None, "cpu", n=12, n_cmp=10, n_sell=32, n_c=8)
    assert recs == [] and set(counts) == set(chip_smoke.COUNTERS)
    assert set(variants) == {"capi_dFFI", "capi_dDFI", "capi_dFBI",
                             "capi_dDFI_sell", "capi_dFBI_sell"}
    paths = {path for _, _, path, _ in chip_smoke.VARIANTS.values()}
    assert {p for p in paths if p.startswith("capi")} == set(variants) - {
        "capi_dFFI"}
