"""The mode table's complex modes (dZZI, dCCI, dZCI) and MATRIX_FREE in
the mixed modes, on the CPU.

The kernels they add (``dia_spmv``, ``ell_spmv``, ``sell_spmv`` and
``stencil_spmv`` in c64, c128 and (c64, c128); the batched DIA, ELL and
sliced ELL ones in c64 and c128; ``stencil_spmv`` in (f32, f64) and
(bf16, f32)) run only on the card.  Here:

  * each plain version they are held to on the card agrees with the
    JAX package's ``ops.spmv.spmv`` on the same DIA, sliced ELL,
    slot-major ELL and MATRIX_FREE matrices, within 1e-12 (complex128
    result) or 2e-5 (complex64) of the row's |A||x|; the stencil's
    mixed plain versions also bit for bit with the port's DIA plain
    version of the same matrix (the kernels' contract);
  * every (values, x) dtype pair a ``d`` mode of the mode table puts in
    front of a kernel has an entry point in ``kernels._SIGNATURES``,
    built in its ``csrc`` source;
  * C API solves in hZZI, hCCI and hZCI, ``matrix_free`` 0 and 1,
    against the JAX package's C API: status equal; iterations equal and
    x to rtol 1e-10 in hZZI, within one and 1e-4 where the hierarchy is
    c64 (hCCI, hZCI);
  * ``solvers/sstep._guarded_solve`` on singular Gram systems against
    the JAX package's;
  * the port's ``amgx_capi`` CLI against ``examples/amgx_capi.py`` in
    hDDI and hZZI at 8^3 (exit code and residual table, times left
    out), and the ``convert`` and ``spmv_test`` programs;
  * the ``capi_complex`` phase of ``chip_smoke.py`` rehearsed at small
    sizes, every SpMV counted as the entry point it would launch on the
    card against the phase's walks.
"""

import collections
import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
import chip_smoke
from amgx_tpu.api import capi as J
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_scipy
from amgx_tpu_torch.api import capi as T
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.core.types import _MODES, host_array
from amgx_tpu_torch.ops import dia, ell, kernels, stencil
from amgx_tpu_torch.ops import spmv as tspmv

amgx_tpu.initialize()
jspmv = importlib.import_module("amgx_tpu.ops.spmv")

MF = ("matrix_free", "dia", "dense", "ell")
# (values, x) of the complex entry points
CPAIRS = [("complex128", "complex128"), ("complex64", "complex64"),
          ("complex64", "complex128")]


@pytest.fixture(autouse=True)
def _init():
    J.initialize()
    T.initialize()
    yield
    J.finalize()
    T.finalize()


def _cx(n, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        dtype)


def _row_scale(At, x):
    ro, ci, _ = At._host
    absA = sps.csr_matrix((np.abs(host_array(At.values)).astype(np.float64),
                           ci, ro), shape=At.shape)
    return absA @ np.abs(np.asarray(x)).astype(np.float64)


def _check(yt, yj, scale):
    assert str(yt.dtype)[6:] == str(jnp.asarray(yj).dtype)
    wide = np.complex128 if yt.is_complex() else np.float64
    d = np.abs(host_array(yt).astype(wide) - np.asarray(yj).astype(wide))
    rtol = 1e-12 if yt.dtype in (torch.float64, torch.complex128) else 2e-5
    assert np.all(d <= rtol * scale + 1e-300), float(np.max(d / scale))


def _matrix(fmt):
    """A complex matrix of each format: the complex-shifted Laplacian of
    a 12 x 11 x 10 grid (DIA, MATRIX_FREE), the shifted
    ``irregular_poisson`` (sliced ELL) and a shifted shuffled periodic
    grid (``torus_poisson``: slot-major ELL), its values jittered in
    phase where no stencil must be kept (16^3: above the rows a dense
    operator takes)."""
    if fmt in ("dia", "matrix_free"):
        return chip_smoke.shifted(poisson_scipy((12, 11, 10)).tocsr())
    base = (chip_smoke.irregular_poisson(16, seed=3) if fmt == "sell"
            else chip_smoke.torus_poisson(16, seed=3))
    sp = chip_smoke.shifted(base)
    rng = np.random.default_rng(4)
    sp.data = sp.data * np.exp(0.3j * rng.standard_normal(sp.nnz))
    return sp


def _plain(fmt, At, xt):
    if fmt == "dia":
        assert At.format == "DIA"
        return dia.dia_spmv_plain(At.dia_vals, At.dia_offsets, xt)
    if fmt == "matrix_free":
        assert At.format == "MATRIX_FREE"
        return stencil.stencil_spmv_plain(At.mf_meta, At.mf_coefs, xt)
    if fmt == "sell":
        assert At.format == "ELL" and At.sell is not None
        return ell.sell_spmv_plain(At.sell, xt)
    assert At.format == "ELL" and At.sell is None
    return ell.ell_spmv_plain(At.ell_cols, At.ell_vals, xt)


@pytest.mark.parametrize("vals,xdt", CPAIRS)
@pytest.mark.parametrize("fmt", ["dia", "sell", "ell", "matrix_free"])
def test_complex_plain_versions_match_jax_spmv(fmt, vals, xdt):
    sp = _matrix(fmt)
    formats = MF if fmt == "matrix_free" else ("dia", "dense", "ell")
    At = TMatrix.from_scipy(sp, accel_formats=formats,
                            device="cpu").astype(vals)
    Aj = JMatrix.from_scipy(sp, accel_formats=formats).astype(
        jnp.dtype(vals))
    assert Aj.has_matrix_free == At.has_matrix_free
    x = _cx(sp.shape[1], np.dtype(xdt), 5)
    xt = torch.from_numpy(x)
    yt = _plain(fmt, At, xt)
    assert yt.dtype == getattr(torch, xdt)
    _check(yt, jspmv.spmv(Aj, jnp.asarray(x)), _row_scale(At, x))
    # the wrapper on a CPU tensor is its plain version
    assert torch.equal(tspmv.spmv(At, xt), yt)
    # the entry point the card would launch
    counter = chip_smoke.counter_of(At)
    assert kernels.entry_point(counter, At.dtype, xt.dtype) == (
        f"{counter}_{kernels._SHORT[At.dtype]}"
        + ("" if vals == xdt else f"_{kernels._SHORT[xt.dtype]}"))


@pytest.mark.parametrize("vals,xdt", [("float32", "float64"),
                                      ("bfloat16", "float32")])
def test_stencil_mixed_plain_versions(vals, xdt):
    """The stencil's mixed pairs: the JAX package's product within the
    tolerance, and bit for bit the port's DIA plain version of the same
    matrix (each product, then each sum, rounded in x's dtype, in
    offsets order: the contract the two kernels keep on the card)."""
    sp = poisson_scipy((12, 11, 10)).tocsr()
    M = TMatrix.from_scipy(sp, accel_formats=MF, device="cpu").astype(vals)
    D = TMatrix.from_scipy(sp, accel_formats=("dia",),
                           device="cpu").astype(vals)
    assert M.has_matrix_free and D.has_dia
    x = np.random.default_rng(6).standard_normal(sp.shape[0])
    xt = torch.from_numpy(x).to(getattr(torch, xdt))
    y = stencil.stencil_spmv_plain(M.mf_meta, M.mf_coefs, xt)
    assert y.dtype == xt.dtype
    assert torch.equal(y, dia.dia_spmv_plain(D.dia_vals, D.dia_offsets, xt))
    Aj = JMatrix.from_scipy(sp, accel_formats=MF).astype(jnp.dtype(vals))
    _check(y, jspmv.spmv(Aj, jnp.asarray(x).astype(jnp.dtype(xdt))),
           _row_scale(M, xt.double().numpy()))
    assert kernels.entry_point("stencil_spmv", M.dtype, xt.dtype) == (
        f"stencil_spmv_{kernels._SHORT[M.dtype]}_{kernels._SHORT[xt.dtype]}")


def _mode_pairs():
    """(kernel, values dtype, x dtype) of every SpMV a ``d`` mode can
    launch: the outer solver's A-SpMV (the matrix under the mode's
    vectors), a hierarchy's or a preconditioner's (the matrix under its
    own dtype), for each kernel; the batched kernels with vectors of the
    matrix's dtype, in the modes whose matrix and vectors share one."""
    out = set()
    for name, m in _MODES.items():
        if name[0] != "d":
            continue
        for k in ("dia_spmv", "ell_spmv", "sell_spmv", "stencil_spmv"):
            out.add((k, m.mat_dtype, m.vec_dtype))
            out.add((k, m.mat_dtype, m.mat_dtype))
        if m.mat_dtype == m.vec_dtype:
            for k in ("dia_spmv_batched", "ell_spmv_batched",
                      "sell_spmv_batched"):
                out.add((k, m.mat_dtype, m.vec_dtype))
    return sorted(out, key=str)


def test_every_mode_pair_has_an_entry_point():
    built = {}
    for lib in kernels.SOURCES:
        built[lib] = (kernels.CSRC / f"{lib}.cu").read_text()
    pairs = _mode_pairs()
    assert ("stencil_spmv", torch.complex64, torch.complex128) in pairs
    for kernel, v, x in pairs:
        name = kernels.entry_point(kernel, v, x)
        assert name is not None, (kernel, v, x)
        lib = kernels.library_of(kernel)
        assert name in kernels._SIGNATURES[lib]
        assert f'extern "C" int {name}(' in built[lib], name
    # the twenty entry points of the complex modes and the stencil's
    # mixed pairs
    new = {n for lib in kernels._SIGNATURES.values() for n in lib
           if n.split("_")[-1] in ("c64", "c128")
           or n in ("stencil_spmv_f32_f64", "stencil_spmv_bf16_f32")}
    assert len(new) == 20
    # a pair no mode feeds stays unbuilt: the wider type is x's
    assert kernels.entry_point("dia_spmv", torch.complex128,
                               torch.complex64) is None
    assert kernels.entry_point("dia_spmv_batched", torch.complex64,
                               torch.complex128) is None


def _cfg(tol, mf):
    return chip_smoke.CX_AMG_CFG.replace(
        '"tolerance": 1e-08', f'"tolerance": {tol}').replace(
        '"min_coarse_rows": 2048,',
        f'"min_coarse_rows": 256, "matrix_free": {mf},')


def _flow(C, mode, cfg, sp, b):
    c = C.config_create(cfg)
    r = C.resources_create_simple(c)
    A, vb, vx = (C.matrix_create(r, mode), C.vector_create(r, mode),
                 C.vector_create(r, mode))
    n = sp.shape[0]
    C.matrix_upload_all(A, n, sp.nnz, 1, 1, sp.indptr.astype(np.int32),
                        sp.indices.astype(np.int32), sp.data)
    C.vector_upload(vb, n, 1, b)
    C.vector_set_zero(vx, n, 1)
    s = C.solver_create(r, mode, c)
    C.solver_setup(s, A)
    C.solver_solve(s, vb, vx)
    return (C.solver_get_status(s), C.solver_get_iterations_number(s),
            C.vector_download(vx))


@pytest.mark.parametrize("mf", [0, 1])
@pytest.mark.parametrize("mode", ["hZZI", "hCCI", "hZCI"])
def test_complex_capi_solves_match_jax(mode, mf):
    """GMRES(20) + SIZE_2 aggregation AMG (``chip_smoke.CX_AMG_CFG``,
    min_coarse_rows 256) on the complex-shifted 16^3 Laplacian through
    both packages' C API."""
    mdt = chip_smoke.CX_DT[mode[2]]
    vdt = chip_smoke.CX_DT[mode[1]]
    sp = chip_smoke.shifted(poisson_scipy((16,) * 3).tocsr(), mdt)
    b = _cx(sp.shape[0], vdt, 7)
    cfg = _cfg("1e-05" if mode == "hCCI" else "1e-08", mf)
    sj, ij, xj = _flow(J, mode, cfg, sp, b)
    st, it, xt = _flow(T, mode, cfg, sp, b)
    assert st == sj == T.SOLVE_SUCCESS
    assert xt.dtype == xj.dtype == vdt
    scale = float(np.abs(xj).max())
    if mode == "hZZI":
        assert it == ij
        np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-10 * scale)
    else:
        assert abs(it - ij) <= 1
        np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-4 * scale)


# the Gram system that met an exactly zero pivot in LAPACK's LU, its
# ridge included (tests/test_torch_solvers_extra.py::
# test_inexact_scoped_preconditioner_honored: W -> a rank-one matrix as
# r -> 0), bit for bit
_EXACT_W = ("9b5b387cfeffef3fb6b0167cfeffef3f"
            "0cb2187cfeffef3f1707f77bfeffef3f")
_EXACT_RHS = "34ef9349828c723cc6b38149828c723c"


def _singular_cases():
    W0 = np.frombuffer(bytes.fromhex(_EXACT_W), np.float64).reshape(
        2, 2).copy()
    r0 = np.frombuffer(bytes.fromhex(_EXACT_RHS), np.float64).copy()
    rng = np.random.default_rng(8)
    V = rng.standard_normal((2, 1)) + 1j * rng.standard_normal((2, 1))
    near = V @ V.conj().T + 1e-18 * np.eye(2)  # rank one, and a whisper
    good = W0 + np.diag([1.0, 2.0])
    r1 = rng.standard_normal(2) + 1j * rng.standard_normal(2)
    return {"exact": (W0, r0), "near": (near, r1),
            "batch": (np.stack([W0, good, near]).astype(np.complex128),
                      np.stack([r0, r1, r1]))}


def _ridge(W):
    """The guard's ridge system W + delta I (``_guarded_solve``)."""
    s = W.shape[-1]
    delta = (np.abs(np.diagonal(W).real).max() * np.finfo(np.float64).eps
             * 4.0 + np.finfo(np.float64).tiny)
    return W + delta * np.eye(s)


@pytest.mark.parametrize("case", ["exact", "near", "batch"])
def test_guarded_solve_on_singular_gram_matches_jax(case):
    """``_guarded_solve`` no longer raises on a singular W
    (``torch.linalg.solve`` did, on an exactly zero pivot): each
    instance's update is finite and either the no-op (the non-finite
    solve turned into zeros) or a backward-stable solution of the
    guard's ridge system, as the JAX package's ``jnp.linalg.solve``
    result is, whose LU may round past the zero pivot; where the ridge
    system is well conditioned the two agree to rtol 1e-10.  A batch
    (B, s, s) takes each instance as alone."""
    from amgx_tpu.solvers.sstep import _guarded_solve as j_guarded
    from amgx_tpu_torch.solvers.sstep import _guarded_solve

    W, rhs = _singular_cases()[case]
    got = _guarded_solve(torch.from_numpy(W), torch.from_numpy(rhs)).numpy()
    Ws, rs = (W, rhs) if W.ndim == 3 else (W[None], rhs[None])
    got = got.reshape(rs.shape)
    eps = np.finfo(np.float64).eps
    for g, Wi, r in zip(got, Ws, rs):
        w = np.asarray(j_guarded(jnp.asarray(Wi), jnp.asarray(r)))
        for x in (g, w):
            assert np.all(np.isfinite(x))
            M = _ridge(Wi)
            res = np.linalg.norm(M @ x - r)
            assert np.all(x == 0) or res <= 1e3 * eps * (
                np.linalg.norm(M, 2) * np.linalg.norm(x)
                + np.linalg.norm(r))
        if np.linalg.cond(_ridge(Wi)) < 1e6:
            np.testing.assert_allclose(g, w, rtol=1e-10)
    if case == "exact":
        # torch.linalg.solve raises on it; solve_ex's result is the guard's
        with pytest.raises(RuntimeError, match="singular"):
            torch.linalg.solve(torch.from_numpy(_ridge(W)),
                               torch.from_numpy(rhs))


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_amgx_capi", os.path.join(os.path.dirname(chip_smoke.__file__),
                                      "examples", "amgx_capi.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode,cfg", [("hDDI", "jacobi"),
                                      ("hZZI", "gmres_jacobi")])
def test_cli_matches_the_jax_example(mode, cfg, tmp_path, capsys,
                                     monkeypatch):
    """``python -m amgx_tpu_torch.examples.amgx_capi -p 8 8 8`` against
    ``examples/amgx_capi.py`` with the same flags: the same exit code,
    the same rows of the residual table (residuals to the 7 digits
    printed) and status, the timing lines left out."""
    from amgx_tpu_torch.examples import amgx_capi as cli

    text = (chip_smoke.JACOBI_CFG if cfg == "jacobi"
            else chip_smoke.CX_JACOBI_CFG)
    path = tmp_path / "cfg.json"
    path.write_text(text)
    args = ["-p", "8", "8", "8", "-c", str(path), "-mode", mode]
    monkeypatch.setattr(sys, "argv", ["amgx_capi.py", *args])
    rc_j = _jax_example().main()
    out_j = capsys.readouterr().out
    rc_t = cli.main(args)
    out_t = capsys.readouterr().out
    assert rc_t == rc_j == 0
    rows_j, st_j = chip_smoke.table_of(out_j)
    rows_t, st_t = chip_smoke.table_of(out_t)
    assert st_t == st_j == "success"
    assert len(rows_t) == len(rows_j) > 2
    for (lt, rt, qt), (lj, rj, qj) in zip(rows_t, rows_j):
        assert lt == lj
        assert rt == pytest.approx(rj, rel=2e-6)
        assert (qt is None) == (qj is None)


def test_cli_d_mode_without_a_card_exits_not_supported_target(tmp_path,
                                                              capsys):
    from amgx_tpu_torch.examples import amgx_capi as cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the d mode runs")
    path = tmp_path / "cfg.json"
    path.write_text(chip_smoke.JACOBI_CFG)
    rc = cli.main(["-p", "4", "4", "4", "-c", str(path), "-mode", "dZZI"])
    assert rc == T.RC_NOT_SUPPORTED_TARGET == 3
    assert "(AMGX_RC 3)" in capsys.readouterr().err


def test_convert_roundtrip_and_spmv_test(tmp_path, capsys):
    """``convert`` of a system with a right-hand side to
    ``%%NVAMGBinary`` and back: the same matrix and rhs; ``spmv_test``
    on the result on the CPU exits 0."""
    from amgx_tpu_torch.examples import convert, spmv_test
    from amgx_tpu_torch.io.matrix_market import read_system, write_system

    sp = poisson_scipy((6, 5, 4)).tocsr()
    sp.data = sp.data * np.random.default_rng(2).uniform(0.5, 1.5, sp.nnz)
    rhs = np.random.default_rng(3).standard_normal(sp.shape[0])
    src, mid, dst = (tmp_path / "a.mtx", tmp_path / "a.bin",
                     tmp_path / "b.mtx")
    write_system(str(src), TMatrix.from_scipy(sp, accel_formats=(),
                                              device="cpu"), rhs=rhs)
    assert convert.main(["convert", str(src), str(mid)]) == 0
    assert convert.main(["convert", str(mid), str(dst)]) == 0
    assert "rhs=yes" in capsys.readouterr().out
    Ad, b2, _ = read_system(str(dst))
    back = sps.csr_matrix((Ad["vals"], (Ad["rows"], Ad["cols"])),
                          shape=(Ad["n_rows"], Ad["n_cols"]))
    assert (back != sp).nnz == 0
    np.testing.assert_array_equal(np.asarray(b2), rhs)
    assert spmv_test.main([str(dst), "--device", "cpu"]) == 0
    assert "format=" in capsys.readouterr().out


def test_capi_complex_phase_rehearsed_on_cpu(monkeypatch):
    """``chip_smoke.capi_complex_phase`` at small sizes on the CPU, every
    SpMV counted as the entry point it would launch on the card (the
    wrappers count nothing on the CPU), held to the phase's walks:
    its checks all pass, and every one of the twenty entry points is
    met on its path in ``chip_smoke.VARIANTS``."""
    seen = collections.Counter()
    orig, orig_b = tspmv._spmv_scalar, tspmv._spmv_batched

    def bump(name):
        if name == "csr":
            tspmv.csr_products += 1
        elif name is not None:
            mod = (dia if name.startswith("dia") else stencil
                   if name.startswith("stencil") else ell)
            mod.variant_launches[name] = mod.variant_launches.get(name,
                                                                  0) + 1
            seen[name] += 1

    def counted(A, x):
        bump(chip_smoke.variant_of(A, x.dtype))
        return orig(A, x)

    def counted_b(A, x):
        c = chip_smoke.BATCHED.get(chip_smoke.counter_of(A))
        if c is not None:
            bump(c if c == "csr" else kernels.entry_point(c, A.dtype,
                                                          x.dtype))
        return orig_b(A, x)

    real = chip_smoke.check_variants
    monkeypatch.setattr(tspmv, "_spmv_scalar", counted)
    monkeypatch.setattr(tspmv, "_spmv_batched", counted_b)
    monkeypatch.setattr(chip_smoke, "check_variants",
                        lambda label, got, want, device:
                        real(label, got, want, "cuda"))
    variants, recs = chip_smoke.capi_complex_phase(
        torch, None, "cpu", n=24, n_cmp=12, n_sell=16, n_batch=32, B=4,
        n_cli=8, n_mtx=8)
    assert recs == []
    for name, (_, _, path, _) in chip_smoke.VARIANTS.items():
        if not path.startswith("complex_"):
            continue
        assert variants[path].get(name, 0) > 0, (name, path)
