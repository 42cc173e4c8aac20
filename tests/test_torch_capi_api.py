"""Every other entry point of the port's C API handle layer against the
JAX package's, on the CPU (``h`` modes): uploads with ``diag_data`` and
from raw bytes (bf16 as 2-byte words), ``replace_coefficients`` then
``resetup``, ``get_size``, ``check_symmetry``, ``read_system`` /
``write_system`` across the packages (text and binary),
``write_parameters_description``, ``generate_distributed_poisson_7pt``,
the eigensolver flow of ``tests/test_capi.py``, ``solver_save`` in one
package and ``solver_load`` in the other, the config and vector
functions; then the RC mapping (error strings, bad handles, modes and
configs, non-finite uploads, ``rc_for_exception``, the guard on every
public function, an injected internal error, a ``d`` mode without a
card, the entry points not ported yet) and the print callback.
"""

import types

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from amgx_tpu.api import capi as J
from amgx_tpu_torch.api import capi as T
from amgx_tpu_torch.io.poisson import poisson_scipy
from tests.test_torch_capi import BENCH, CFG, CLASSICAL, handle_flow

PACKAGES = {"jax": J, "torch": T}


@pytest.fixture(autouse=True)
def _init():
    J.initialize()
    T.initialize()
    yield
    J.finalize()
    T.finalize()
    J.register_print_callback(None)
    T.register_print_callback(None)


def setup_objects(C, cfg=CFG, mode="hDDI"):
    c = C.config_create(cfg)
    return c, C.resources_create_simple(c)


def upload(C, res, sp, mode="hDDI", **kw):
    A = C.matrix_create(res, mode)
    C.matrix_upload_all(A, sp.shape[0], sp.nnz, 1, 1,
                        sp.indptr.astype(np.int32),
                        sp.indices.astype(np.int32), sp.data, **kw)
    return A


def solve(C, res, cfg_h, A, b, mode="hDDI"):
    n = b.shape[0]
    vb, vx = C.vector_create(res, mode), C.vector_create(res, mode)
    C.vector_upload(vb, n, 1, b)
    C.vector_set_zero(vx, n, 1)
    s = C.solver_create(res, mode, cfg_h)
    C.solver_setup(s, A)
    C.solver_solve(s, vb, vx)
    return (C.solver_get_status(s), C.solver_get_iterations_number(s),
            C.vector_download(vx), s, vb, vx)


def same_solve(a, b, rtol=1e-10):
    assert a[:2] == b[:2]
    np.testing.assert_allclose(b[2], a[2], rtol=rtol,
                               atol=rtol * float(np.max(np.abs(a[2]))))


def poisson(n_side=10):
    sp = poisson_scipy((n_side,) * 3).tocsr()
    sp.sort_indices()
    return sp


def rhs(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


# ---------------------------------------------------------------------------
# uploads


def test_upload_with_diag_data():
    """The diagonal passed apart (``diag_data``) becomes explicit
    diagonal entries: the same operator and solve in both packages, and
    the same as uploading it inside the CSR."""
    sp = poisson()
    off = (sp - sps.diags_array(sp.diagonal())).tocsr()
    off.eliminate_zeros()
    off.sort_indices()
    out = {}
    for C in (J, T):
        c, r = setup_objects(C)
        A = upload(C, r, off, diag_data=sp.diagonal().copy())
        assert C.matrix_get_size(A) == (sp.shape[0], 1, 1)
        out[C] = solve(C, r, c, A, rhs(sp.shape[0]))
        full = solve(C, r, c, upload(C, r, sp), rhs(sp.shape[0]))
        same_solve(full, out[C])
    same_solve(out[J], out[T])


@pytest.mark.parametrize("mode", ["hDDI", "hFFI", "hFBI", "hZZI"])
def test_upload_from_bytes(mode):
    """The C shim's byte path: index and value buffers as bytes in the
    mode's dtypes (bf16 values as 2-byte words)."""
    sp = poisson()
    n = sp.shape[0]
    if mode == "hFBI":
        words = torch.from_numpy(sp.data).to(torch.bfloat16).view(
            torch.int16).numpy()
        data = words.tobytes()
    else:
        dt = {"D": np.float64, "F": np.float32, "Z": np.complex128}[mode[2]]
        data = sp.data.astype(dt).tobytes()
    vdt = {"D": np.float64, "F": np.float32, "Z": np.complex128}[mode[1]]
    out = {}
    for C in (J, T):
        c, r = setup_objects(C)
        A = C.matrix_create(r, mode)
        C.matrix_upload_all(A, n, sp.nnz, 1, 1,
                            sp.indptr.astype(np.int32).tobytes(),
                            sp.indices.astype(np.int32).tobytes(), data)
        assert C.matrix_get_size(A) == (n, 1, 1)
        vb, vx = C.vector_create(r, mode), C.vector_create(r, mode)
        C.vector_upload(vb, n, 1, rhs(n).astype(vdt).tobytes())
        C.vector_upload(vx, n, 1, np.zeros(n, vdt).tobytes())
        s = C.solver_create(r, mode, c)
        C.solver_setup(s, A)
        C.solver_solve(s, vb, vx)
        out[C] = (C.solver_get_status(s), C.solver_get_iterations_number(s),
                  C.vector_download(vx))
        assert out[C][0] == C.SOLVE_SUCCESS and out[C][2].dtype == vdt
    if mode[1] in "DZ":
        same_solve(out[J], out[T])
    else:
        assert abs(out[J][1] - out[T][1]) <= 1
        np.testing.assert_allclose(
            out[T][2], out[J][2], rtol=1e-4,
            atol=1e-4 * float(np.max(np.abs(out[J][2]))))


def test_bf16_upload_holds_bf16_values_on_the_port():
    """hFBI builds the matrix in bf16 (the words viewed as bf16), every
    format included; ``vector_download`` gives the mode's f32."""
    sp = poisson(6)
    vals = sp.data * (1 + 1e-3 * np.arange(sp.nnz) / sp.nnz)
    c, r = setup_objects(T)
    A = T.matrix_create(r, "hFBI")
    T.matrix_upload_all(A, sp.shape[0], sp.nnz, 1, 1, sp.indptr,
                        sp.indices, vals)
    m = T._get(A).A
    assert m.dtype == torch.bfloat16 and m.dia_vals.dtype == torch.bfloat16
    assert m.device.type == "cpu"
    want = torch.from_numpy(vals.astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(m.values, want)


def test_upload_all_global_whole_system():
    """upload_all_global(_32) with the whole system in one call solves
    as upload_all does; a per-rank partial upload and a setup over more
    than one device are not ported (queue A.9)."""
    sp = poisson(8)
    n = sp.shape[0]
    b = rhs(n)
    for fn, cdt in (("matrix_upload_all_global", np.int64),
                    ("matrix_upload_all_global_32", np.int32)):
        out = {}
        for C in (J, T):
            c, r = setup_objects(C)
            A = C.matrix_create(r, "hDDI")
            getattr(C, fn)(A, n, n, sp.nnz, 1, 1, sp.indptr,
                           sp.indices.astype(cdt), sp.data)
            out[C] = solve(C, r, c, A, b)
        same_solve(out[J], out[T])
    c, r = setup_objects(T)
    A = T.matrix_create(r, "hDDI")
    with pytest.raises(T.AMGXError) as e:
        T.matrix_upload_all_global(A, n, n // 2, 10, 1, 1, sp.indptr,
                                   sp.indices.astype(np.int64), sp.data)
    assert e.value.rc == T.RC_NOT_IMPLEMENTED and "A.9" in str(e.value)
    r2 = T.resources_create(c, None, 2)
    A2 = T.matrix_create(r2, "hDDI")
    T.matrix_upload_all_global(A2, n, n, sp.nnz, 1, 1, sp.indptr,
                               sp.indices.astype(np.int64), sp.data)
    s = T.solver_create(r2, "hDDI", c)
    with pytest.raises(T.AMGXError) as e:
        T.solver_setup(s, A2)
    assert e.value.rc == T.RC_NOT_IMPLEMENTED and "A.9" in str(e.value)


# ---------------------------------------------------------------------------
# matrix functions


def test_replace_coefficients_then_resetup():
    """New values of the same structure, then resetup: the bench AMG
    config solves the new system as the JAX package does, and as a
    fresh setup on the new values."""
    sp = poisson()
    n = sp.shape[0]
    d = np.random.default_rng(7).uniform(0.5, 1.5, n)
    new = (sps.diags_array(d) @ sp @ sps.diags_array(d)).tocsr()
    new.sort_indices()
    assert np.array_equal(new.indices, sp.indices)
    b = rhs(n)
    out = {}
    for C in (J, T):
        c, r = setup_objects(C, BENCH)
        A = upload(C, r, sp)
        first = solve(C, r, c, A, b)
        s = first[3]
        C.matrix_replace_coefficients(A, n, sp.nnz, new.data)
        assert C.solver_resetup(s, A) == C.RC_OK
        C.solver_solve_with_0_initial_guess(s, first[4], first[5])
        out[C] = (C.solver_get_status(s), C.solver_get_iterations_number(s),
                  C.vector_download(first[5]))
        fresh = solve(C, r, c, upload(C, r, new), b)
        same_solve(fresh, out[C])
    same_solve(out[J], out[T])


def test_get_size_and_check_symmetry():
    sp = poisson(6)
    nonsym = sp.copy()
    nonsym.data[1] = -2.0  # one off-diagonal value: numerically not
    struct = sp.tolil()
    struct[0, 5] = -0.5  # an entry without its mirror
    struct = struct.tocsr()
    for C in (J, T):
        c, r = setup_objects(C)
        A = C.matrix_create(r, "hDDI")
        assert C.matrix_get_size(A) == (0, 0, 0)
        with pytest.raises(C.AMGXError) as e:
            C.matrix_check_symmetry(A)
        assert e.value.rc == C.RC_BAD_PARAMETERS
        got = [C.matrix_check_symmetry(upload(C, r, m))
               for m in (sp, nonsym, struct)]
        assert got == [(1, 1), (1, 0), (0, 0)], C.__name__
        assert C.matrix_get_size(upload(C, r, sp)) == (216, 1, 1)


# ---------------------------------------------------------------------------
# files


@pytest.mark.parametrize("suffix", [".mtx", ".bin"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_write_in_one_package_read_in_the_other(tmp_path, suffix, writer):
    sp = poisson(5)
    n = sp.shape[0]
    b, x = rhs(n, 1), rhs(n, 2)
    W = PACKAGES[writer]
    R = T if writer == "jax" else J
    path = str(tmp_path / f"system{suffix}")
    c, r = setup_objects(W)
    A = upload(W, r, sp)
    vb, vx = W.vector_create(r, "hDDI"), W.vector_create(r, "hDDI")
    W.vector_upload(vb, n, 1, b)
    W.vector_upload(vx, n, 1, x)
    assert W.write_system(A, vb, vx, path) == W.RC_OK
    got = {}
    for C in (W, R):
        c2, r2 = setup_objects(C)
        A2 = C.matrix_create(r2, "hDDI")
        vb2, vx2 = C.vector_create(r2, "hDDI"), C.vector_create(r2, "hDDI")
        assert C.read_system(A2, vb2, vx2, path) == C.RC_OK
        m = C._get(A2).A
        got[C] = (m.to_scipy().toarray(), C.vector_download(vb2),
                  C.vector_download(vx2))
    for a, b_ in zip(got[W], got[R]):
        np.testing.assert_array_equal(a, b_)
    np.testing.assert_array_equal(got[R][0], sp.toarray())
    np.testing.assert_array_equal(got[R][1], b)
    np.testing.assert_array_equal(got[R][2], x)


def test_matrix_writer_binary_and_rhs_from_a(tmp_path):
    """``matrix_writer`` "binary" writes %%NVAMGBinary whatever the
    name; a file without a rhs reads b = A 1 under ``rhs_from_a``."""
    sp = poisson(4)
    n = sp.shape[0]
    cfg = CFG[:-2] + '}, "matrix_writer": "binary", "rhs_from_a": 1}'
    for C in (J, T):
        path = str(tmp_path / f"{C.__name__}.mtx")
        c, r = setup_objects(C, cfg)
        C.write_system(upload(C, r, sp), 0, 0, path)
        with open(path, "rb") as f:
            assert f.read(13) == b"%%NVAMGBinary"
        A2 = C.matrix_create(r, "hDDI")
        vb = C.vector_create(r, "hDDI")
        C.read_system(A2, vb, 0, path)
        np.testing.assert_array_equal(C.vector_download(vb),
                                      sp @ np.ones(n))


def test_read_system_missing_file_is_an_io_error(tmp_path):
    for C in (J, T):
        c, r = setup_objects(C)
        A = C.matrix_create(r, "hDDI")
        with pytest.raises(C.AMGXError) as e:
            C.read_system(A, 0, 0, str(tmp_path / "none.mtx"))
        assert e.value.rc == C.RC_IO_ERROR


def test_write_parameters_description(tmp_path):
    texts = []
    for C in (J, T):
        path = tmp_path / f"{C.__name__}.txt"
        assert C.write_parameters_description(str(path)) == C.RC_OK
        texts.append(path.read_text())
    assert texts[0] == texts[1] and texts[0].count("\n") > 100


def test_generate_distributed_poisson_7pt():
    out = {}
    for C in (J, T):
        c, r = setup_objects(C)
        A = C.matrix_create(r, "hDDI")
        vb, vx = C.vector_create(r, "hDDI"), C.vector_create(r, "hDDI")
        C.generate_distributed_poisson_7pt(A, vb, vx, 6, 5, 4)
        assert C.matrix_get_size(A) == (120, 1, 1)
        np.testing.assert_array_equal(C.vector_download(vb), np.ones(120))
        np.testing.assert_array_equal(C.vector_download(vx), np.zeros(120))
        s = C.solver_create(r, "hDDI", c)
        C.solver_setup(s, A)
        C.solver_solve(s, vb, vx)
        out[C] = (C.solver_get_status(s), C.solver_get_iterations_number(s),
                  C.vector_download(vx))
        np.testing.assert_array_equal(
            C._get(A).A.to_scipy().toarray(),
            poisson_scipy((6, 5, 4)).toarray())
    same_solve(out[J], out[T])
    c, r = setup_objects(T)
    with pytest.raises(T.AMGXError) as e:
        T.generate_distributed_poisson_7pt(T.matrix_create(r, "hDDI"), 0, 0,
                                           4, 4, 4, 2, 1, 1)
    assert e.value.rc == T.RC_NOT_IMPLEMENTED and "A.9" in str(e.value)


# ---------------------------------------------------------------------------
# eigensolver and setup persistence


def test_eig_solver_flow():
    """The ``tests/test_capi.py`` eigensolver flow (LANCZOS, the two
    largest) through both packages: eigenvalues to rtol 1e-10, the
    leading eigenvector up to sign to 1e-8."""
    cfg = ("eig_solver=LANCZOS, eig_max_iters=200, eig_tolerance=1e-8,"
           " eig_which=largest, eig_wanted_count=2, eig_subspace_size=60")
    sp = poisson_scipy((12, 12)).tocsr()
    out = {}
    for C in (J, T):
        c, r = setup_objects(C, cfg)
        A = upload(C, r, sp)
        es = C.eig_solver_create(r, "hDDI", c)
        C.eig_solver_setup(es, A)
        C.eig_solver_solve(es)
        lam = C.eig_solver_get_eigenvalues(es)
        v = C.vector_create(r, "hDDI")
        C.eig_solver_get_eigenvector(es, 0, v)
        x = C.vector_download(v)
        with pytest.raises(C.AMGXError) as e:
            C.eig_solver_get_eigenvector(es, 99, v)
        assert e.value.rc == C.RC_BAD_PARAMETERS
        C.eig_solver_destroy(es)
        out[C] = (lam, x / np.linalg.norm(x))
    np.testing.assert_allclose(out[T][0], out[J][0], rtol=1e-10)
    xj, xt = out[J][1], out[T][1]
    np.testing.assert_allclose(xt * np.sign(xt @ xj), xj, atol=1e-8)


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_solver_save_in_one_package_load_in_the_other(tmp_path, saver):
    """``solver_save`` in one package, ``solver_load`` in the other: the
    restored solver solves with the saver's iterations and x (bench
    config, f64); a handle of another matrix dtype refuses the payload
    with RC_BAD_MODE."""
    sp = poisson()
    n = sp.shape[0]
    b = rhs(n)
    W = PACKAGES[saver]
    R = T if saver == "jax" else J
    path = str(tmp_path / "setup.npz")
    c, r = setup_objects(W, BENCH)
    ref = solve(W, r, c, upload(W, r, sp), b)
    assert W.solver_save(ref[3], path) == W.RC_OK
    c2, r2 = setup_objects(R, BENCH)
    s = R.solver_create(r2, "hDDI", c2)
    assert R.solver_load(s, path) == R.RC_OK
    with pytest.raises(R.AMGXError) as e:
        R.solver_get_status(s)
    assert e.value.rc == R.RC_BAD_PARAMETERS  # no solve yet
    vb, vx = R.vector_create(r2, "hDDI"), R.vector_create(r2, "hDDI")
    R.vector_upload(vb, n, 1, b)
    R.vector_set_zero(vx, n, 1)
    R.solver_solve(s, vb, vx)
    same_solve(ref, (R.solver_get_status(s),
                     R.solver_get_iterations_number(s),
                     R.vector_download(vx)))
    wrong = R.solver_create(r2, "hFFI", c2)
    with pytest.raises(R.AMGXError) as e:
        R.solver_load(wrong, path)
    assert e.value.rc == R.RC_BAD_MODE


def test_solver_save_before_setup_is_bad_parameters(tmp_path):
    for C in (J, T):
        c, r = setup_objects(C)
        with pytest.raises(C.AMGXError) as e:
            C.solver_save(C.solver_create(r, "hDDI", c),
                          str(tmp_path / "x.npz"))
        assert e.value.rc == C.RC_BAD_PARAMETERS


# ---------------------------------------------------------------------------
# config, resources and vectors


def test_config_functions(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(CFG)
    for C in (J, T):
        h = C.config_create_from_file(str(path))
        # no "algorithm" anywhere: the registry default, CLASSICAL
        assert C.config_get_default_number_of_rings(h) == 2
        h2 = C.config_create_from_file_and_string(str(path),
                                                  "max_iters=7")
        assert C._get(h2).cfg.get("max_iters", "default") == 7
        assert C.config_add_parameters(h, "tolerance=1e-3") == C.RC_OK
        assert C.config_get_default_number_of_rings(
            C.config_create(CLASSICAL)) == 2
        assert C.config_get_default_number_of_rings(
            C.config_create(BENCH)) == 1
        assert C.config_get_default_number_of_rings(
            C.config_create("")) == 2  # the default algorithm
        with pytest.raises(C.AMGXError) as e:
            C.config_create_from_file(str(tmp_path / "none.json"))
        assert e.value.rc == C.RC_IO_ERROR
        with pytest.raises(C.AMGXError) as e:
            C.config_add_parameters(h, "not json and not k=v")
        assert e.value.rc == C.RC_BAD_CONFIGURATION
        r = C.resources_create(h, None, 1)
        assert C.resources_destroy(r) == C.RC_OK
        assert C.config_destroy(h) == C.RC_OK
        assert C.install_signal_handler() == C.RC_OK
        assert C.reset_signal_handler() == C.RC_OK


def test_vector_functions():
    for C in (J, T):
        c, r = setup_objects(C)
        for mode, dt in (("hDDI", np.float64), ("hFFI", np.float32),
                         ("hCCI", np.complex64)):
            v = C.vector_create(r, mode)
            assert C.vector_get_size(v) == (0, 1)
            with pytest.raises(C.AMGXError) as e:
                C.vector_download(v)
            assert e.value.rc == C.RC_BAD_PARAMETERS
            C.vector_set_random(v, 12)
            got = C.vector_download(v)
            assert got.dtype == dt and got.shape == (12,)
            np.testing.assert_array_equal(
                got, np.random.default_rng(0).standard_normal(12).astype(dt))
            C.vector_set_zero(v, 4, 3)
            assert C.vector_get_size(v) == (4, 3)
            C.vector_upload(v, 2, 3, np.arange(6.0))
            assert C.vector_get_size(v) == (2, 3)
            assert C.vector_bind(v, C.matrix_create(r, mode)) == C.RC_OK
            assert C.vector_destroy(v) == C.RC_OK
            with pytest.raises(C.AMGXError):
                C.vector_get_size(v)
    assert T.get_api_version() == J.get_api_version() == (2, 5)


# ---------------------------------------------------------------------------
# RC mapping


def test_error_strings_and_itemsizes():
    for rc in range(-1, 17):
        assert T.get_error_string(rc) == J.get_error_string(rc)
    for name in ("dDDI", "hFBI", "dZCI", "hCCI"):
        assert T.mode_itemsizes(name) == J.mode_itemsizes(name)
    assert T.mode_itemsizes("hFBI") == (2, 4)
    for C in (J, T):
        with pytest.raises(C.AMGXError) as e:
            C.mode_itemsizes("xQQQ")
        assert e.value.rc == C.RC_BAD_MODE
    rcs = [n for n in dir(J) if n.startswith("RC_")]
    assert rcs == [n for n in dir(T) if n.startswith("RC_")]
    assert all(getattr(J, n) == getattr(T, n) for n in rcs)


def test_bad_handle_mode_and_config():
    for C in (J, T):
        with pytest.raises(C.AMGXError) as e:
            C.config_create("not json and not k=v")
        assert e.value.rc == C.RC_BAD_CONFIGURATION
        with pytest.raises(C.AMGXError) as e:
            C.matrix_create(999999)
        assert e.value.rc == C.RC_BAD_PARAMETERS
        c, r = setup_objects(C)
        with pytest.raises(C.AMGXError) as e:
            C.matrix_create(r, "xQQQ")
        assert e.value.rc == C.RC_BAD_MODE
        with pytest.raises(C.AMGXError) as e:
            C.vector_create(c, "hDDI")  # a config is not a resources
        assert e.value.rc == C.RC_BAD_PARAMETERS
        s = C.solver_create(r, "hDDI", c)
        b = C.vector_create(r, "hDDI")
        with pytest.raises(C.AMGXError) as e:
            C.solver_solve(s, b, b)  # not set up
        assert e.value.rc == C.RC_BAD_PARAMETERS
        with pytest.raises(C.AMGXError) as e:
            C.vector_download(999999)
        assert e.value.rc == C.RC_BAD_PARAMETERS
        bad = C.config_create('{"config_version": 2, "solver": '
                              '{"scope": "main", "solver": "NO_SUCH"}}')
        A = upload(C, r, poisson(4))
        with pytest.raises(C.AMGXError) as e:
            C.solver_setup(C.solver_create(r, "hDDI", bad), A)
        assert e.value.rc == C.RC_BAD_CONFIGURATION, C.__name__


def test_non_finite_upload_is_rc_core():
    for C in (J, T):
        c, r = setup_objects(C)
        A = C.matrix_create(r, "hDDI")
        with pytest.raises(C.AMGXError) as e:
            C.matrix_upload_all(A, 2, 3, 1, 1, np.array([0, 2, 3], np.int32),
                                np.array([0, 1, 1], np.int32),
                                np.array([np.nan, 1.0, 1.0]))
        assert e.value.rc == C.RC_CORE
        v = C.vector_create(r, "hDDI")
        with pytest.raises(C.AMGXError) as e:
            C.vector_upload(v, 2, 1, np.array([1.0, np.inf]))
        assert e.value.rc == C.RC_CORE


def test_rc_for_exception_matches_the_jax_package():
    from amgx_tpu.core.errors import rc_for_exception as j_rc
    from amgx_tpu.core.errors import NonFiniteValuesError as JNF
    from amgx_tpu_torch.core.errors import (NonFiniteValuesError,
                                            PatternDegeneracyError,
                                            StoreError, rc_for_exception)

    cases = [MemoryError(), OSError(), EOFError(), FileNotFoundError(),
             NotImplementedError(), KeyError("x"), ValueError(), TypeError(),
             IndexError(), AssertionError(), RuntimeError(), ZeroDivisionError(),
             Exception()]
    for e in cases:
        assert rc_for_exception(e) == j_rc(e), type(e).__name__
    assert rc_for_exception(NonFiniteValuesError()) == j_rc(JNF()) == 10
    assert rc_for_exception(PatternDegeneracyError()) == 1
    assert rc_for_exception(StoreError()) == 8
    err = RuntimeError()
    err.rc = 99  # out of range: ignored
    assert rc_for_exception(err) == j_rc(err) == 2


def test_every_public_function_is_guarded():
    unguarded = [
        name for name, obj in vars(T).items()
        if isinstance(obj, types.FunctionType) and not name.startswith("_")
        and obj.__module__ == T.__name__
        and not getattr(obj, "_rc_guarded", False)
    ]
    assert not unguarded


def test_the_port_has_every_public_name_of_the_jax_package():
    def public(C):
        return {name for name, obj in vars(C).items()
                if isinstance(obj, types.FunctionType)
                and not name.startswith("_")
                and obj.__module__ == C.__name__}

    assert public(J) <= public(T)


def test_internal_error_is_rc_unknown_and_the_handle_survives(monkeypatch):
    c, r = setup_objects(T)
    sp = poisson(6)
    n = sp.shape[0]
    st, it, x, s, vb, vx = solve(T, r, c, upload(T, r, sp), rhs(n))
    slv = T._get(s).solver

    def boom(*a, **k):
        raise RuntimeError("injected internal error")

    monkeypatch.setattr(slv, "solve", boom)
    with pytest.raises(T.AMGXError) as e:
        T.solver_solve(s, vb, vx)
    assert e.value.rc == T.RC_UNKNOWN
    assert "injected" in str(e.value)
    monkeypatch.undo()
    assert T.solver_solve_with_0_initial_guess(s, vb, vx) == T.RC_OK
    assert T.solver_get_status(s) == T.SOLVE_SUCCESS
    assert T.solver_get_iterations_number(s) == it
    np.testing.assert_array_equal(T.vector_download(vx), x)


def test_d_mode_without_a_card_raises(monkeypatch):
    """A ``d`` mode names the card: without one each create raises
    RC_NOT_SUPPORTED_TARGET, and nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c, r = setup_objects(T)
    for fn, args in (("matrix_create", (r, "dDDI")),
                     ("vector_create", (r, "dFFI")),
                     ("solver_create", (r, "dDFI", c)),
                     ("eig_solver_create", (r, "dDDI", c))):
        with pytest.raises(T.AMGXError) as e:
            getattr(T, fn)(*args)
        assert e.value.rc == T.RC_NOT_SUPPORTED_TARGET, fn
        assert "hD" in str(e.value) or "hF" in str(e.value)
    assert T.mode_itemsizes("dDDI") == (8, 8)  # sizes need no card


NOT_PORTED = [
    ("distribution_create", 1, "A.9"),
    ("distribution_set_partition_data", 3, "A.9"),
    ("distribution_set_32bit_colindices", 2, "A.9"),
    ("distribution_uses_32bit", 1, "A.9"),
    ("distribution_set_partition_blob", 3, "A.9"),
    ("distribution_destroy", 1, "A.9"),
    ("matrix_upload_distributed", 11, "A.9"),
    ("matrix_comm_from_maps_one_ring", 8, "A.9"),
    ("read_system_maps_one_ring", 3, "A.9"),
    ("read_system_maps_one_ring_flat", 3, "A.9"),
    ("read_system_distributed", 4, "A.9"),
    ("write_system_distributed", 4, "A.9"),
]


@pytest.mark.parametrize("name,nargs,queue", NOT_PORTED,
                         ids=[n for n, _, _ in NOT_PORTED])
def test_entry_points_not_ported_are_rc_not_implemented(name, nargs, queue):
    with pytest.raises(T.AMGXError) as e:
        getattr(T, name)(*([1] * nargs))
    assert e.value.rc == T.RC_NOT_IMPLEMENTED
    assert queue in str(e.value) and "ROADMAP.md" in str(e.value)


# the streaming session calls, ported with the sessions
SESSION = [("solver_session_create", 2), ("solver_session_step", 4),
           ("solver_session_sync", 1), ("solver_session_get_status", 1),
           ("solver_session_get_iterations_number", 1)]


@pytest.mark.parametrize("name,nargs", SESSION, ids=[n for n, _ in SESSION])
def test_session_entry_points_refuse_an_unknown_handle_as_jax(name, nargs):
    import amgx_tpu.api.capi as J

    for mod in (T, J):
        with pytest.raises(mod.AMGXError) as e:
            getattr(mod, name)(*([987654] * nargs))
        assert e.value.rc == mod.RC_BAD_PARAMETERS
    # destroying an unknown session is a no-op in both packages
    assert T.solver_session_destroy(987654) == J.solver_session_destroy(
        987654) == T.RC_OK


# the batched solve and its accessors, ported with the serve layer
BATCH = [("solver_solve_batch", 4), ("solver_get_batch_status", 2),
         ("solver_get_batch_iterations_number", 2),
         ("solver_get_batch_metrics", 1)]


@pytest.mark.parametrize("name,nargs", BATCH, ids=[n for n, _ in BATCH])
def test_batch_entry_points_refuse_an_unknown_handle_as_jax(name, nargs):
    """On a handle that names no solver both packages answer
    RC_BAD_PARAMETERS."""
    got = []
    for C in (T, J):
        with pytest.raises(C.AMGXError) as e:
            getattr(C, name)(*([1] * nargs))
        got.append(e.value.rc)
    assert got == [T.RC_BAD_PARAMETERS] * 2


# ---------------------------------------------------------------------------
# the print callback


def captured_flow(C, cfg, mode="hDDI"):
    lines = []
    C.register_print_callback(lines.append)
    try:
        handle_flow(C, mode, cfg, n_side=8)
    finally:
        C.register_print_callback(None)
    return "".join(lines)


def test_print_callback_receives_the_jax_package_text():
    """print_solve_stats (the residual table and summary) and
    solver_verbose (the settings of each solver at setup) reach the
    callback as the JAX package's text, line for line; with verbosity
    2 the one-line summary."""
    for extra in ('"print_solve_stats": 1, "solver_verbose": 1',
                  '"print_solve_stats": 1, "verbosity_level": 2'):
        cfg = CFG.replace('"monitor_residual": 1,',
                          f'"monitor_residual": 1, {extra},', 1)
        tj, tt = captured_flow(J, cfg), captured_flow(T, cfg)
        assert tj.splitlines() == tt.splitlines()
        assert "Total Iterations" in tt
    assert "solver settings" in tt or "status:" in tt


def test_print_callback_vis_data_and_stdout(capsys):
    cfg = BENCH.replace('"cycle": "V",', '"cycle": "V", "print_vis_data": 1,')
    tj, tt = captured_flow(J, cfg), captured_flow(T, cfg)
    assert "AMG visualization data" in tt
    assert tj.splitlines() == tt.splitlines()
    # without a callback the text goes to stdout
    capsys.readouterr()
    handle_flow(T, "hDDI", cfg, n_side=8)
    assert "AMG visualization data" in capsys.readouterr().out

