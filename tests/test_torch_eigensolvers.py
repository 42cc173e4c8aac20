"""Eigensolvers and operators of the PyTorch port against the JAX package
(CPU, f64).

Every case of ``tests/test_eigensolvers.py`` and ``tests/
test_operators_io.py`` runs through both packages on the same matrix,
with ARNOLDI (the reference's ARNOLDI config spelled out), shift-invert
inverse iteration, SINGLE_ITERATION, PAGERANK with dangling nodes and a
personalization vector, and the eigenvector post-pass added.  Each case
is held to equal iterations and ``converged``, eigenvalues to rtol
1e-10, and eigenvectors up to sign per column to 1e-8 where their
eigenvalue is simple (the 2D Poisson matrix has double eigenvalues,
whose vectors are any in their plane: those are held to their
residual).  Operators are held at rtol 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.eigensolvers import create_eigensolver as j_create
from amgx_tpu.io.poisson import poisson_2d_5pt, poisson_rhs
from amgx_tpu_torch.core.matrix import SparseMatrix

amgx_tpu.initialize()

INNER_PCG = (", solver(s)=PCG, s:max_iters=500, s:tolerance=1e-12,"
             " s:monitor_residual=1, s:preconditioner(p)=NOSOLVER")

CASES = {
    "power": "eig_solver=POWER_ITERATION, eig_max_iters=2000,"
             " eig_tolerance=1e-8, eig_which=largest",
    "single_iteration": "eig_solver=SINGLE_ITERATION, eig_max_iters=2000,"
                        " eig_tolerance=1e-8, eig_which=largest,"
                        " eig_convergence_check_freq=5",
    "power_shifted": "eig_solver=POWER_ITERATION, eig_max_iters=3000,"
                     " eig_tolerance=1e-8, eig_which=largest,"
                     " eig_shift=1.5",
    "lanczos": "eig_solver=LANCZOS, eig_max_iters=200, eig_tolerance=1e-8,"
               " eig_which=largest, eig_wanted_count=2,"
               " eig_subspace_size=60",
    "lanczos_smallest": "eig_solver=LANCZOS, eig_max_iters=300,"
                        " eig_tolerance=1e-8, eig_which=smallest,"
                        " eig_wanted_count=2, eig_subspace_size=80",
    "subspace": "eig_solver=SUBSPACE_ITERATION, eig_max_iters=500,"
                " eig_tolerance=1e-10, eig_which=largest,"
                " eig_wanted_count=2, eig_subspace_size=8",
    "lobpcg_smallest": "eig_solver=LOBPCG, eig_max_iters=300,"
                       " eig_tolerance=1e-8, eig_which=smallest,"
                       " eig_wanted_count=2",
    "inverse": "eig_solver=INVERSE_ITERATION, eig_max_iters=100,"
               " eig_tolerance=1e-10" + INNER_PCG,
    # shift-invert: (A - sigma I)^{-1} near the smallest eigenvalue
    "inverse_shift_invert": "eig_solver=INVERSE_ITERATION,"
                            " eig_max_iters=100, eig_tolerance=1e-10,"
                            " eig_shift=0.05, solver(s)=GMRES,"
                            " s:max_iters=500, s:tolerance=1e-12,"
                            " s:gmres_n_restart=60, s:monitor_residual=1,"
                            " s:preconditioner(p)=NOSOLVER",
    # the reference's eigen_configs/ARNOLDI, spelled out
    "arnoldi": "eig_solver=ARNOLDI, eig_max_iters=100,"
               " eig_tolerance=1e-8, eig_which=largest,"
               " eig_wanted_count=1, eig_subspace_size=40",
    "jacobi_davidson": "eig_solver=JACOBI_DAVIDSON, eig_max_iters=60,"
                       " eig_tolerance=1e-8, eig_which=largest,"
                       " eig_subspace_size=12",
    "jacobi_davidson_smallest": "eig_solver=JACOBI_DAVIDSON,"
                                " eig_max_iters=80, eig_tolerance=1e-8,"
                                " eig_which=smallest, eig_subspace_size=10",
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def system():
    A = poisson_2d_5pt(16)
    sp = A.to_scipy().tocsr()
    At = SparseMatrix.from_scipy(sp, device="cpu")
    return A, At, sp, np.sort(np.linalg.eigvalsh(sp.toarray()))


def _run_both(cfg_text, A, At, personalization=None):
    jes = j_create(JConfig.from_string(cfg_text))
    tes = T.create_eigensolver(T.AMGConfig.from_string(cfg_text),
                               device="cpu")
    if personalization is not None:
        jes.personalization = personalization
        tes.personalization = personalization
    jes.setup(A)
    tes.setup(At)
    return jes, tes, jes.solve(), tes.solve()


def _simple(lam, spectrum, tol=1e-8):
    """True where ``lam`` has no other eigenvalue of ``spectrum`` within
    ``tol`` (relative)."""
    near = np.abs(spectrum - lam) <= tol * max(abs(lam), 1.0)
    return int(near.sum()) <= 1


def _hold(jr, tr, sp=None, spectrum=None):
    assert tr.iterations == jr.iterations
    assert tr.converged == jr.converged
    np.testing.assert_allclose(tr.eigenvalues, jr.eigenvalues, rtol=1e-10)
    assert (tr.eigenvectors is None) == (jr.eigenvectors is None)
    if jr.eigenvectors is None:
        return
    X = tr.eigenvectors.numpy()
    Xj = np.asarray(jr.eigenvectors)
    assert X.shape == Xj.shape
    for c in range(Xj.shape[1]):
        x, xj = X[:, c], Xj[:, c]
        lam = np.real(jr.eigenvalues[c])
        if spectrum is None or _simple(lam, spectrum):
            # up to sign (and, for a complex Ritz vector, phase)
            k = int(np.argmax(np.abs(xj)))
            s = x[k] / xj[k]
            np.testing.assert_allclose(x, s * xj, rtol=0,
                                       atol=1e-8 * np.abs(xj).max())
            assert abs(abs(s) - 1.0) <= 1e-8
        else:
            def resid(v):
                v = np.real(v) / np.linalg.norm(np.real(v))
                return np.linalg.norm(sp @ v - lam * v)

            assert resid(x) <= max(10 * resid(xj), 1e-8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eigensolver_matches_jax(system, case):
    A, At, sp, spectrum = system
    jes, tes, jr, tr = _run_both(CASES[case], A, At)
    assert tes.requested_name == jes.requested_name
    _hold(jr, tr, sp, spectrum)
    if case.startswith("inverse"):
        # the smallest eigenvalue, from the left or by shift-invert
        np.testing.assert_allclose(tr.eigenvalues[0], spectrum[0],
                                   rtol=1e-8)


def _links(n, seed, dangling=5):
    rng = np.random.default_rng(seed)
    links = sps.random(n, n, density=0.1, random_state=rng, format="csr")
    links.setdiag(0)
    links.data[:] = 1.0
    links = links.tolil()
    # nodes without out-links: empty columns of the link matrix
    for c in rng.choice(n, dangling, replace=False):
        links[:, c] = 0
    links = links.tocsr()
    links.eliminate_zeros()
    return links.astype(np.float64)


@pytest.mark.parametrize("personalized", [False, True])
def test_pagerank_matches_jax(personalized):
    links = _links(50, 5)
    pers = (np.random.default_rng(3).random(50) if personalized else None)
    jes, tes, jr, tr = _run_both(
        "eig_solver=PAGERANK, eig_max_iters=500, eig_tolerance=1e-12,"
        " eig_damping_factor=0.85", JMatrix.from_scipy(links),
        SparseMatrix.from_scipy(links, device="cpu"), personalization=pers)
    assert tr.converged
    _hold(jr, tr)
    pr = tr.eigenvectors[:, 0].numpy()
    assert np.all(pr > 0)
    np.testing.assert_allclose(pr.sum(), 1.0, rtol=1e-12)


def test_unknown_eigensolver():
    cfg = "eig_solver=QUANTUM_ANNEALER"
    with pytest.raises(KeyError):
        j_create(JConfig.from_string(cfg))
    with pytest.raises(KeyError):
        T.create_eigensolver(T.AMGConfig.from_string(cfg), device="cpu")


def test_all_nine_names_resolve():
    from amgx_tpu.eigensolvers.base import _EIGENSOLVERS as J
    from amgx_tpu_torch.eigensolvers.base import _EIGENSOLVERS as P

    assert sorted(P) == sorted(J)
    assert len(P) == 9


@pytest.mark.parametrize("case", ["inverse", "lobpcg_smallest"])
def test_eigenvector_post_pass_matches_jax(system, case):
    """The inverse-iteration post-pass (``eig_eigenvector_solver``).  It
    runs only where an algorithm gives no vectors, which none of the
    nine does in either package: it is driven here on each package's
    result with the vectors dropped."""
    A, At, sp, spectrum = system
    cfg = (CASES[case] + ", eig_eigenvector=1,"
           " eig_eigenvector_solver=GMRES, max_iters=300,"
           " tolerance=1e-12, gmres_n_restart=60, monitor_residual=1,"
           " preconditioner=NOSOLVER")
    jes, tes, jr, tr = _run_both(cfg, A, At)
    jv = jes._maybe_extract_vectors(
        dataclasses.replace(jr, eigenvectors=None))
    tv = tes._maybe_extract_vectors(
        dataclasses.replace(tr, eigenvectors=None))
    assert tv.vector_converged is not None
    np.testing.assert_array_equal(tv.vector_converged, jv.vector_converged)
    assert tv.vector_converged.all()
    _hold(jv, tv, sp, spectrum)


@pytest.fixture(scope="module")
def small():
    A = poisson_2d_5pt(12)
    sp = A.to_scipy()
    return A, SparseMatrix.from_scipy(sp, device="cpu"), sp


def test_matrix_operator(small):
    from amgx_tpu.core.operator import MatrixOperator as JOp
    from amgx_tpu_torch.core.operator import MatrixOperator

    A, At, sp = small
    x = np.random.default_rng(0).standard_normal(A.n_rows)
    y = MatrixOperator(At).apply(x).numpy()
    np.testing.assert_allclose(y, sp @ x, rtol=1e-12)
    np.testing.assert_allclose(y, np.asarray(JOp(A).apply(x)), rtol=1e-12)
    params, fn = MatrixOperator(At).as_fn()
    np.testing.assert_array_equal(fn(params, torch.from_numpy(x)).numpy(),
                                  y)


def test_shifted_operator(small):
    from amgx_tpu.core.operator import ShiftedOperator as JOp
    from amgx_tpu_torch.core.operator import ShiftedOperator

    A, At, sp = small
    x = np.random.default_rng(1).standard_normal(A.n_rows)
    op = ShiftedOperator(At, 2.5)
    y = op.apply(x).numpy()
    np.testing.assert_allclose(y, sp @ x - 2.5 * x, rtol=1e-12)
    np.testing.assert_allclose(y, np.asarray(JOp(A, 2.5).apply(x)),
                               rtol=1e-12)
    params, fn = op.as_fn()
    np.testing.assert_array_equal(fn(params, torch.from_numpy(x)).numpy(),
                                  y)


def test_solve_operator(small):
    from amgx_tpu.core.operator import SolveOperator as JOp
    from amgx_tpu.solvers import create_solver as j_solver
    from amgx_tpu_torch.core.operator import SolveOperator

    A, At, sp = small
    text = ('{"config_version": 2, "solver": {"scope": "m", "solver": "CG",'
            ' "monitor_residual": 0, "max_iters": 400}}')
    s = T.create_solver(T.AMGConfig.from_string(text), "default",
                        device="cpu").setup(At)
    js = j_solver(JConfig.from_string(text), "default").setup(A)
    b = poisson_rhs(A.n_rows)
    x = SolveOperator(s).apply(b).numpy()
    rel = np.linalg.norm(b - sp @ x) / np.linalg.norm(b)
    assert rel < 1e-6
    np.testing.assert_allclose(x, np.asarray(JOp(js).apply(b)), rtol=1e-12)
    assert SolveOperator(s).shape == A.shape


def test_eigensolver_refuses_a_matrix_on_another_device(system):
    _, At, _, _ = system
    es = T.create_eigensolver(T.AMGConfig.from_string(CASES["power"]),
                              device="cpu")
    bad = dataclasses.replace(At, values=At.values.to("meta"))
    with pytest.raises(ValueError):
        es.setup(bad)


def test_lanczos_reads_beta_once_a_step(system, monkeypatch):
    """Host reads: one beta a Lanczos step, alpha kept on the device
    until the Ritz problem (one read of all of them)."""
    _, At, _, _ = system
    es = T.create_eigensolver(T.AMGConfig.from_string(CASES["lanczos"]),
                              device="cpu").setup(At)
    reads = {"float": 0}
    orig = torch.Tensor.__float__

    def counting(self):
        reads["float"] += 1
        return orig(self)

    monkeypatch.setattr(torch.Tensor, "__float__", counting)
    r = es.solve()
    # one beta a step and the residual's norm
    assert reads["float"] == r.iterations + 1
    assert r.eigenvalues[0] > 7.9


# ---------------------------------------------------------------------------
# chip_smoke.py's eigensolvers phase: its walk of each case's SpMVs


@pytest.fixture
def counted_spmvs(monkeypatch):
    """``chip_smoke``'s launch counters replaced by a count of the SpMVs
    each operator's format sends to a kernel (the CPU runs the plain
    versions, which the wrappers do not count)."""
    import chip_smoke
    from amgx_tpu_torch.ops import spmv as spmv_mod

    counts = dict.fromkeys(chip_smoke.COUNTERS, 0)
    scalar = spmv_mod._spmv_scalar

    def counting(A, x):
        c = chip_smoke.counter_of(A)
        if c is not None:
            counts[c] += 1
        return scalar(A, x)

    def zero():
        for k in counts:
            counts[k] = 0

    monkeypatch.setattr(spmv_mod, "_spmv_scalar", counting)
    monkeypatch.setattr(chip_smoke, "zero_counts", zero)
    monkeypatch.setattr(chip_smoke, "kernel_counts", lambda: dict(counts))
    return chip_smoke


@pytest.mark.parametrize("label", ["POWER_ITERATION", "SINGLE_ITERATION",
                                   "INVERSE_ITERATION", "PAGERANK",
                                   "SUBSPACE_ITERATION", "LANCZOS",
                                   "ARNOLDI", "LOBPCG", "JACOBI_DAVIDSON"])
def test_chip_smoke_eigen_walk_counts_every_spmv(counted_spmvs, label):
    C = counted_spmvs
    (cfg, kind), = [(c, k) for lab, c, k in C.eig_cases() if lab == label]
    # PAGERANK's Google matrix past the dense gate (4096 rows): ELL
    rec, launches, walk, inner = C.eig_run("cpu", label, cfg, kind, n=8,
                                           nodes=5000)
    assert launches == walk
    assert sum(walk.values()) > 0
    if label == "INVERSE_ITERATION":
        assert len(inner) == rec["iterations"]
        assert rec["post_pass"]["vector_converged"] == [True]
