"""RCM reordering and Matrix Market I/O in the port against the JAX
package (CPU).

``ops/reorder.py``: the same RCM permutation and the same DIA / reorder
gates; AUTO never reorders (the JAX package's answer off the TPU), RCM
permutes and a ``matrix_reordering: RCM`` PCG solve takes the JAX
package's iterations.  ``io/matrix_market.py``: files written by the
test from seeded values (general and symmetric headers, rhs and
solution sections, an external diagonal, a binary system, a complex
system through ``complex_to_real_system``) read the same in both
packages, the port's writers write the JAX package's bytes, and a file
round-trips through the port.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io import matrix_market as j_mm
from amgx_tpu.io.poisson import poisson_rhs, poisson_scipy
from amgx_tpu.ops import reorder as j_reorder
from amgx_tpu.solvers import create_solver as j_create

import amgx_tpu_torch as T
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.io import matrix_market as t_mm
from amgx_tpu_torch.ops import reorder as t_reorder

amgx_tpu.initialize()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _shuffled_poisson(m, seed=3):
    """Poisson on an m^3 grid with its unknowns shuffled: no DIA, so RCM
    has bandwidth to win back."""
    A = poisson_scipy((m, m, m))
    p = np.random.default_rng(seed).permutation(A.shape[0])
    A = A[p][:, p].tocsr()
    A.sort_indices()
    return A


def _matrices():
    rng = np.random.default_rng(11)
    R = sps.random(5000, 5000, density=0.001, random_state=rng,
                   format="csr")
    R = (R + R.T + sps.eye(5000) * 10).tocsr()
    return {"poisson 8^3": poisson_scipy((8, 8, 8)),
            "shuffled poisson 17^3": _shuffled_poisson(17),
            "random 5000": R}


MATS = _matrices()


@pytest.mark.parametrize("name", list(MATS))
def test_rcm_and_gates_match_jax(name):
    sp = MATS[name]
    np.testing.assert_array_equal(t_reorder.rcm_permutation(sp),
                                  j_reorder.rcm_permutation(sp))
    assert t_reorder.would_build_dia(sp) == j_reorder.would_build_dia(sp)
    assert (t_reorder.wants_reorder_scipy(sp)
            == j_reorder.wants_reorder_scipy(sp))


@pytest.mark.parametrize("name", list(MATS))
def test_maybe_reorder_matches_jax(name):
    sp = MATS[name]
    A = TMatrix.from_scipy(sp, device="cpu")
    JA = JMatrix.from_scipy(sp)
    for mode in ("AUTO", "NONE"):
        assert t_reorder.maybe_reorder(A, mode)[1] is None
        assert j_reorder.maybe_reorder(JA, mode)[1] is None
    A2, perm = t_reorder.maybe_reorder(A, "RCM")
    JA2, jperm = j_reorder.maybe_reorder(JA, "RCM")
    assert (perm is None) == (jperm is None)
    if perm is None:
        assert name == "poisson 8^3" and A2 is A
        return
    np.testing.assert_array_equal(perm, jperm)
    assert A2.format == "ELL" and A2.device == A.device
    want = sp[perm][:, perm].toarray()
    np.testing.assert_array_equal(A2.to_dense(), want)
    np.testing.assert_array_equal(
        A2.to_dense(), np.asarray(JA2.to_scipy().todense()))


RCM_CFG = (
    '{"config_version": 2, "solver": {"scope": "main", "solver": "PCG",'
    ' "max_iters": 100, "tolerance": 1e-8, "convergence": "RELATIVE_INI",'
    ' "monitor_residual": 1, "norm": "L2", "matrix_reordering": "RCM",'
    ' "preconditioner": {"scope": "amg", "solver": "AMG", "cycle": "V",'
    ' "max_iters": 1, "presweeps": 1, "postsweeps": 1, "max_levels": 100,'
    ' "monitor_residual": 0,'
    ' "smoother": {"scope": "jacobi", "solver": "BLOCK_JACOBI",'
    ' "monitor_residual": 0}}}}'
)


@pytest.mark.parametrize("reorder", ["RCM", "NONE"])
def test_rcm_pcg_solve_matches_jax(reorder):
    """The permutation is applied at the solve boundary: b in, x out in
    the caller's ordering, the same iterations as the JAX package."""
    sp = MATS["shuffled poisson 17^3"]
    cfg = RCM_CFG.replace('"RCM"', f'"{reorder}"')
    b = poisson_rhs(sp.shape[0])
    js = j_create(JConfig.from_string(cfg), "default")
    js.setup(JMatrix.from_scipy(sp))
    jr = js.solve(b)
    ts = T.create_solver(T.AMGConfig.from_string(cfg), "default",
                         device="cpu")
    ts.setup(TMatrix.from_scipy(sp, device="cpu"))
    tr = ts.solve(b)
    assert (ts._reorder is not None) == (reorder == "RCM")
    assert tr.status == int(jr.status) == 0
    assert tr.iters == int(jr.iters)
    x = tr.x.numpy()
    np.testing.assert_allclose(x, np.asarray(jr.x), rtol=1e-10,
                               atol=1e-10 * np.abs(x).max())
    assert np.linalg.norm(b - sp @ x) <= 1e-7 * np.linalg.norm(b)


# ----------------------------------------------------------------------
# Matrix Market


def _entries(rng, n, m, density):
    M = sps.random(n, m, density=density, random_state=rng, format="coo")
    return M.row, M.col, rng.standard_normal(M.nnz)


def _write_text(path, header, n, m, rows, cols, vals, extra_lines=()):
    with open(path, "w") as f:
        f.write(header + "\n")
        f.write("% a comment line\n")
        f.write(f"{n} {m} {len(rows)}\n")
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")
        for line in extra_lines:
            f.write(line + "\n")


def _mtx_files(tmp_path):
    rng = np.random.default_rng(21)
    files = {}
    r, c, v = _entries(rng, 30, 40, 0.1)
    # a duplicate entry, summed on read
    r, c, v = np.r_[r, r[:1]], np.r_[c, c[:1]], np.r_[v, 0.5]
    p = tmp_path / "general.mtx"
    _write_text(p, "%%MatrixMarket matrix coordinate real general",
                30, 40, r, c, v)
    files["general"] = p
    r, c, v = _entries(rng, 25, 25, 0.1)
    keep = r >= c
    p = tmp_path / "symmetric.mtx"
    _write_text(p, "%%MatrixMarket matrix coordinate real symmetric",
                25, 25, r[keep], c[keep], v[keep])
    files["symmetric"] = p
    r, c, v = _entries(rng, 20, 20, 0.15)
    extra = [f"{x:.17g}" for x in rng.standard_normal(20)]
    extra += [f"{x:.17g}" for x in rng.standard_normal(20)]
    extra += [f"{x:.17g}" for x in rng.standard_normal(20)]
    p = tmp_path / "nvamg.mtx"
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write("%%NVAMG diagonal rhs solution\n")
        f.write(f"20 20 {len(r)}\n")
        for a, b_, x in zip(r, c, v):
            f.write(f"{a + 1} {b_ + 1} {x:.17g}\n")
        f.write("\n".join(extra) + "\n")
    files["nvamg diagonal rhs solution"] = p
    return files


def _same_system(got, ref):
    (A, b, x), (JA, jb, jx) = got, ref
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(A[k], JA[k])
    for k in ("n_rows", "n_cols", "block_dims"):
        assert A[k] == JA[k]
    for u, v in ((b, jb), (x, jx)):
        assert (u is None) == (v is None)
        if u is not None:
            np.testing.assert_array_equal(u, v)


def _same_matrix(A, JA):
    ro, ci, v = A._host
    np.testing.assert_array_equal(ro, np.asarray(JA.row_offsets))
    np.testing.assert_array_equal(ci, np.asarray(JA.col_indices))
    np.testing.assert_array_equal(v, np.asarray(JA.values))
    assert A.shape == JA.shape


@pytest.mark.parametrize("kind", ["general", "symmetric",
                                  "nvamg diagonal rhs solution"])
def test_mtx_reads_like_jax_and_round_trips(tmp_path, kind):
    path = _mtx_files(tmp_path)[kind]
    _same_system(t_mm.read_system(path), j_mm.read_system(path))
    A = t_mm.read_mtx(path, device="cpu")
    JA = j_mm.read_mtx(path)
    _same_matrix(A, JA)
    assert A.device == torch.device("cpu")
    _, b, x = t_mm.read_system(path)
    out_t, out_j = tmp_path / "t.mtx", tmp_path / "j.mtx"
    t_mm.write_system(out_t, A, b, x)
    j_mm.write_system(out_j, JA, b, x)
    assert out_t.read_bytes() == out_j.read_bytes()
    back = t_mm.read_mtx(out_t, device="cpu")
    for u, v in zip(back._host, A._host):
        assert u.tobytes() == v.tobytes()
    _same_system(t_mm.read_system(out_t), j_mm.read_system(out_t))
    A32 = t_mm.read_mtx(path, dtype=np.float32, device="cpu")
    assert A32.dtype == torch.float32


def test_binary_system_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    sp = (sps.random(50, 50, density=0.08, random_state=rng, format="csr")
          + sps.eye(50)).tocsr()
    sp.sort_indices()
    b, x = rng.standard_normal(50), rng.standard_normal(50)
    out_t, out_j = tmp_path / "t.bin", tmp_path / "j.bin"
    t_mm.write_system_binary(out_t, TMatrix.from_scipy(sp, device="cpu"),
                             torch.from_numpy(b), x)
    j_mm.write_system_binary(out_j, JMatrix.from_scipy(sp), b, x)
    assert out_t.read_bytes() == out_j.read_bytes()
    _same_system(t_mm.read_system(out_t), j_mm.read_system(out_j))
    A = t_mm.read_mtx(out_t, device="cpu")
    _same_matrix(A, j_mm.read_mtx(out_j))
    np.testing.assert_array_equal(A.to_dense(), sp.toarray())


@pytest.mark.parametrize("kind", [1, 2, 3, 4])
def test_complex_to_real_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(kind)
    r, c, v = _entries(rng, 15, 15, 0.2)
    im = rng.standard_normal(len(r))
    p = tmp_path / "complex.mtx"
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate complex general\n")
        f.write("%%NVAMG rhs\n")
        f.write(f"15 15 {len(r)}\n")
        for a, b_, x, y in zip(r, c, v, im):
            f.write(f"{a + 1} {b_ + 1} {x:.17g} {y:.17g}\n")
        for x, y in rng.standard_normal((15, 2)):
            f.write(f"{x:.17g} {y:.17g}\n")
    with pytest.raises(t_mm.MatrixIOError, match="complex_to_real"):
        t_mm.read_mtx(p, device="cpu")
    got = t_mm.complex_to_real_system(*t_mm.read_system(p), kind)
    ref = j_mm.complex_to_real_system(*j_mm.read_system(p), kind)
    _same_system(got, ref)
