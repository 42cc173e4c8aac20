"""MATRIX_FREE stencil parity of the PyTorch port with the JAX package (CPU).

  * detection: both packages' ``detect_stencil_np`` (and the DIA source
    map it reads) give the same meta, coefficients and source map;
  * the SpMV: the port's ``stencil_spmv`` (its plain version on the
    CPU) against the Pallas kernel in interpret mode, as
    tests/test_pallas_stencil.py runs it (f32, rtol 2e-5), and against
    ``stencil_spmv_xla`` (rtol 1e-12 f64, 2e-5 f32);
  * the bitwise contract inside the port: a MATRIX_FREE SpMV equals the
    DIA SpMV of the same matrix bit for bit, and so do whole solves
    with ``matrix_free`` 1 and 0, fused or not;
  * the slice: the bench config plus ``matrix_free`` at 24^3 builds the
    JAX package's hierarchy (every level MATRIX_FREE, same rows and
    nnz), counts the same cycle passes (3(L-1)+1 unfused, 2(L-1)+1
    fused) and solves within the ROADMAP tolerances;
  * the CUDA kernel's launch plan: its block/thread/plane map covers
    every row exactly once (enumerated in numpy as the kernel maps
    them), and it picks the kernel and the vector width per stencil.

The CUDA kernel runs only on the card (``chip_smoke.py``).
"""

import types

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import amgx_tpu
import amgx_tpu_torch as T
from amgx_tpu.config.amg_config import AMGConfig as JConfig
from amgx_tpu.core import matrix as jmatrix
from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_3d_7pt as j_poisson
from amgx_tpu.io.poisson import poisson_rhs
from amgx_tpu.ops import pallas_stencil as ps
from amgx_tpu.ops import stencil as jst
from amgx_tpu.solvers import create_solver as j_create
from amgx_tpu_torch.amg.hierarchy import hierarchy_from_numpy
from amgx_tpu_torch.core import matrix as tmatrix
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.io.poisson import poisson_3d_7pt as t_poisson
from amgx_tpu_torch.io.poisson import poisson_scipy
from amgx_tpu_torch.ops import dia
from amgx_tpu_torch.ops import spmv as tspmv
from amgx_tpu_torch.ops import stencil as tst

amgx_tpu.initialize()

MF_FORMATS = ("matrix_free", "dia", "dense", "ell")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _grid(nx, ny, nz):
    """7-point Poisson on an nx x ny x nz grid, x fastest."""
    return poisson_scipy((nz, ny, nx))


def _axis_scaled(n=8):
    """Coefficients varying along z only (tests/test_matrix_free.py)."""
    coo = poisson_scipy((n, n, n)).tocoo()
    coo.data = coo.data * (1.0 + coo.row // (n * n))
    return coo.tocsr()


def _jittered(n=12):
    sp = poisson_scipy((n, n, n)).copy()
    noise = np.random.default_rng(0).standard_normal(sp.nnz)
    sp.data = sp.data + noise * 1e-3
    return sp


def _random_symmetric():
    m = sps.random(400, 400, density=0.02, random_state=2, format="csr")
    m = (m + m.T + 10 * sps.identity(400)).tocsr()
    m.sort_indices()
    return m


def _ones27(n):
    """Constant 27-point stencil: kron of three all-ones tridiagonals."""
    t = sps.diags_array([np.ones(n - 1), np.ones(n), np.ones(n - 1)],
                        offsets=[-1, 0, 1], format="csr")
    return sps.kron(sps.kron(t, t), t, format="csr")


_CASES = {
    "const_16": lambda: poisson_scipy((16, 16, 16)),
    "axis_8": _axis_scaled,
    "jittered_12": _jittered,
    "grid_17x23x31": lambda: _grid(17, 23, 31),
    "ones27_6": lambda: _ones27(6),
}


def _x(n, dtype, seed=3):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _host_dia(mod, sp):
    sp = sp.tocsr()
    ro = sp.indptr.astype(np.int32)
    ci = sp.indices.astype(np.int32)
    n = sp.shape[0]
    row_ids = np.repeat(np.arange(n, dtype=np.int32), np.diff(ro))
    return mod._try_build_dia_np(ro, ci, sp.data, row_ids, n)


# ---------------------------------------------------------------- detection


@pytest.mark.parametrize("case", sorted(_CASES))
def test_detection_matches_jax(case):
    sp = _CASES[case]()
    jt, tt = _host_dia(jmatrix, sp), _host_dia(tmatrix, sp)
    assert jt[0] == tt[0]
    np.testing.assert_array_equal(tt[1], jt[1])
    np.testing.assert_array_equal(tt[2], jt[2])  # the DIA source map
    jd = jst.detect_stencil_np(*jt, sp.shape[0])
    td = tst.detect_stencil_np(*tt, sp.shape[0])
    if jd is None:
        assert td is None and case == "jittered_12"
        return
    (jm, jc, js), (tm, tc, ts) = jd, td
    assert tuple(tm) == tuple(jm)
    assert tc.dtype == jc.dtype and tc.tobytes() == jc.tobytes()
    np.testing.assert_array_equal(ts, js)
    want = {"axis_8": "axis"}.get(case, "const")
    assert tm.kind == want


@pytest.mark.parametrize("case", ["jittered_12", "random_400", "const_16"])
def test_format_choice_matches_jax(case):
    sp = _random_symmetric() if case == "random_400" else _CASES[case]()
    J = JMatrix.from_scipy(sp, accel_formats=MF_FORMATS)
    Tm = TMatrix.from_scipy(sp, accel_formats=MF_FORMATS, device="cpu")
    assert Tm.has_matrix_free == J.has_matrix_free == (case == "const_16")
    assert Tm.has_dia == J.has_dia
    if Tm.has_matrix_free:
        # the compact state replaces the planes; nothing else is built
        assert Tm.format == "MATRIX_FREE" and Tm.dia_vals is None
        assert not (Tm.has_dense or Tm.has_ell)
        assert len(Tm.mf_meta.steps) == 7
        assert Tm.mf_meta.steps == J.mf_meta.steps


# ---------------------------------------------------------------- SpMV


@pytest.mark.parametrize("grid", [(12, 12, 12), (24, 24, 24), (64, 32, 16),
                                  (17, 23, 31)])
def test_stencil_spmv_matches_pallas_interpret(grid):
    sp = _grid(*grid).astype(np.float32)
    J = JMatrix.from_scipy(sp, accel_formats=MF_FORMATS)
    Tm = TMatrix.from_scipy(sp, accel_formats=MF_FORMATS, device="cpu")
    assert J.mf_meta.kind == Tm.mf_meta.kind == "const"
    assert Tm.mf_meta.grid == grid
    x = _x(sp.shape[0], np.float32, seed=5)
    y_pallas = np.asarray(ps.pallas_stencil_spmv(J, x, interpret=True))
    y = tst.stencil_spmv(Tm, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["const_16", "axis_8", "grid_17x23x31",
                                  "ones27_6"])
def test_stencil_spmv_matches_xla(case, dtype):
    sp = _CASES[case]().astype(dtype)
    J = JMatrix.from_scipy(sp, accel_formats=MF_FORMATS)
    Tm = TMatrix.from_scipy(sp, accel_formats=MF_FORMATS, device="cpu")
    assert Tm.has_matrix_free and J.has_matrix_free
    x = _x(sp.shape[0], dtype)
    y_xla = np.asarray(jst.stencil_spmv_xla(J.mf_meta, J.mf_coefs, x))
    y = tspmv.spmv(Tm, torch.from_numpy(x)).numpy()
    rtol = 1e-12 if dtype == np.float64 else 2e-5
    np.testing.assert_allclose(y, y_xla, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(y, sp @ x, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["const_16", "axis_8", "grid_17x23x31",
                                  "ones27_6"])
def test_matrix_free_spmv_bitwise_equals_dia(case, dtype):
    sp = _CASES[case]().astype(dtype)
    M = TMatrix.from_scipy(sp, accel_formats=MF_FORMATS, device="cpu")
    D = TMatrix.from_scipy(sp, accel_formats=("dia",), device="cpu")
    assert M.format == "MATRIX_FREE" and D.format == "DIA"
    x = torch.from_numpy(_x(sp.shape[0], dtype, seed=4))
    y_mf, y_dia = tspmv.spmv(M, x), tspmv.spmv(D, x)
    assert y_mf.numpy().tobytes() == y_dia.numpy().tobytes()


def test_cpu_tensors_take_plain_version_without_launch_count():
    M = TMatrix.from_scipy(poisson_scipy((8, 8, 8)),
                           accel_formats=("matrix_free",), device="cpu")
    x = torch.from_numpy(_x(512, np.float64))
    s0, d0 = tst.launches, dia.launches
    y = tst.stencil_spmv(M, x)
    np.testing.assert_array_equal(
        y.numpy(),
        tst.stencil_spmv_plain(M.mf_meta, M.mf_coefs, x).numpy(),
    )
    tspmv.spmv(M, x)
    assert (tst.launches, dia.launches) == (s0, d0)


def test_non_cpu_tensors_never_take_plain_version():
    """A constant stencil off the CPU goes to the kernel or raises; the
    kernel needs a CUDA tensor, so a meta tensor raises."""
    M = TMatrix.from_scipy(poisson_scipy((8, 8, 8)).astype(np.float32),
                           accel_formats=("matrix_free",), device="cpu")
    assert M.mf_meta.kind == "const"
    A = types.SimpleNamespace(
        mf_meta=M.mf_meta,
        mf_coefs=torch.empty((7,), dtype=torch.float32, device="meta"),
    )
    x = torch.empty((512,), dtype=torch.float32, device="meta")
    s0 = tst.launches
    with pytest.raises(ValueError, match="CUDA"):
        tst.stencil_spmv(A, x)
    assert tst.launches == s0


# ---------------------------------------------------------- launch plan


def _plan_rows(plan, grid):
    """Every flat row the kernel computes under ``plan``, once per
    (block, thread, plane) that computes it, mapped as
    csrc/stencil_spmv.cu maps them."""
    nx, ny, nz = plan.grid
    (gx, gy, gz), (bx, by) = plan.blocks, plan.threads
    ix = ((np.arange(gx)[:, None] * bx + np.arange(bx)).ravel()[:, None]
          * plan.vec + np.arange(plan.vec)).ravel()
    iy = (np.arange(gy)[:, None] * by + np.arange(by)).ravel()
    ix, iy = ix[ix < nx], iy[iy < ny]  # threads past the edge exit
    iz = np.concatenate([
        np.arange(kz * plan.zchunk, min((kz + 1) * plan.zchunk, nz))
        for kz in range(gz)
    ])
    return (ix[None, None, :] + nx * iy[None, :, None]
            + nx * ny * iz[:, None, None]).ravel()


_FIVE = ((0, -1, 0), (-1, 0, 0), (0, 0, 0), (1, 0, 0), (0, 1, 0))
# the 3x3x3 box and the 19-point stencil (no corners), in offsets order
_BOX = tuple((dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
             for dx in (-1, 0, 1))
_NINETEEN = tuple(st for st in _BOX if sum(map(abs, st)) <= 2)
# a 7-diagonal stencil that is not the star: two points along x
_WIDE7 = ((0, 0, -1), (-2, 0, 0), (-1, 0, 0), (0, 0, 0), (1, 0, 0),
          (2, 0, 0), (0, 0, 1))
_PLAN_GRIDS = {
    "bench_128": ((128, 128, 128), tst._STAR),
    "bench_64": ((64, 64, 64), tst._STAR),
    "bench_32": ((32, 32, 32), tst._STAR),
    "bench_16": ((16, 16, 16), tst._STAR),
    "bench_8": ((8, 8, 8), tst._STAR),
    "unaligned_17x23x31": ((17, 23, 31), tst._STAR),
    "thin_5x3x40": ((5, 3, 40), tst._STAR),
    "one_plane_40x30x1": ((40, 30, 1), _FIVE),
    "ones27_64": ((64, 64, 64), _BOX),
    "nineteen_20x9x33": ((20, 9, 33), _NINETEEN),
    "five_point_2048x1024x1": ((2048, 1024, 1), _FIVE),
    "nine_point_33x70000x1": ((33, 70000, 1), _BOX[9:18]),
    "wide7_20x9x33": ((20, 9, 33), _WIDE7),
    "tall_2x2x200000": ((2, 2, 200000), tst._STAR),
}


# 16-byte vectors: 2 points in f64, 4 in f32, 8 in bf16
@pytest.mark.parametrize("vec", [1, 2, 4, 8])
@pytest.mark.parametrize("sms", [tst.H100_SMS, 16])
@pytest.mark.parametrize("case", sorted(_PLAN_GRIDS))
def test_stencil_launch_plan_covers_every_row_once(case, sms, vec):
    grid, steps = _PLAN_GRIDS[case]
    plan = tst.stencil_launch_plan(grid, steps, vec, sms)
    (gx, gy, gz), (bx, by) = plan.blocks, plan.threads
    assert bx * by <= tst.PLAN_THREADS
    assert bx <= (tst.PLAN_THREADS if plan.grid[1] == 1 and not plan.nd_inst
                  else 32)
    if plan.nd_inst:  # the tile kernel's shared-memory tile
        assert by <= tst.TILE[1]
    # vectors for the star wherever nx allows them
    assert plan.vec == (vec if steps == tst._STAR and grid[0] % vec == 0
                        else 1)
    assert max(gy, gz) <= 65535 and min(gx, gy, gz, plan.zchunk) >= 1
    # a grid of one plane walked along y, every flat offset kept
    nx, ny, nz = grid
    if nz == 1:
        assert plan.grid == (nx, 1, ny)
        assert plan.steps == tuple((dx, 0, dy) for dx, dy, _ in steps)
    else:
        assert plan.grid == grid and plan.steps == steps
    assert [dx + nx * dy + nx * ny * dz for dx, dy, dz in steps] == [
        dx + plan.grid[0] * (dy + plan.grid[1] * dz)
        for dx, dy, dz in plan.steps]
    # BLOCKS_PER_SM blocks of PLAN_THREADS on each SM where the z axis
    # has room for them
    resident = tst.BLOCKS_PER_SM[plan.nd_inst] * tst.PLAN_THREADS * sms
    if gx * gy * bx * by <= resident and gz < plan.grid[2]:
        assert gx * gy * gz * bx * by <= resident
    n = grid[0] * grid[1] * grid[2]
    counts = np.bincount(_plan_rows(plan, grid), minlength=n)
    assert counts.shape == (n,) and (counts == 1).all()


@pytest.mark.parametrize("nz,steps,want", [
    (16, tst._STAR, 7), (16, _BOX, 27), (16, _NINETEEN, 27),
    (16, _BOX[:19], 27), (16, _BOX[4:23], 27),
    (16, ((0, 0, 0), (0, 0, 1)), 27), (16, _FIVE, 0), (16, ((0, 0, 0),), 0),
    (16, _BOX[9:18], 0), (16, _WIDE7, 0), (16, tst._STAR[::-1], 0),
    (16, _BOX[::-1], 0),
    # one plane: no z step, so no tile kernel (the grid is walked along
    # y by the runtime-count kernel)
    (1, _FIVE, 0), (1, _BOX[9:18], 0), (1, ((0, 0, 0),), 0),
    (1, ((-2, 0, 0), (0, 0, 0), (0, 1, 0)), 0),
])
def test_stencil_launch_plan_instantiation(nz, steps, want):
    assert tst.stencil_launch_plan((16, 16, nz), steps).nd_inst == want


@pytest.mark.parametrize("case,want", [("const_16", 7), ("ones27_6", 27),
                                       ("grid_17x23x31", 7),
                                       ("poisson2d_30x40", 0)])
def test_stencil_launch_plan_instantiation_of_detected_stencils(case, want):
    sp = (poisson_scipy((30, 40)) if case == "poisson2d_30x40"
          else _CASES[case]())
    M = TMatrix.from_scipy(sp, accel_formats=("matrix_free",), device="cpu")
    assert M.mf_meta.kind == "const"
    plan = tst.stencil_launch_plan(M.mf_meta.grid, M.mf_meta.steps)
    assert plan.nd_inst == want


def test_stencil_launch_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        tst.stencil_launch_plan((8, 8, 8), _BOX + ((2, 0, 0),))
    with pytest.raises(ValueError):
        tst.stencil_launch_plan((8, 0, 8), tst._STAR)
    with pytest.raises(ValueError, match="along y"):
        tst.stencil_launch_plan((1, 70000 * 256, 2), _FIVE[1:4])


# ---------------------------------------------------------------- solves


AMG_CFG = """
{"config_version": 2,
 "solver": {"scope": "main", "solver": "AMG", "algorithm": "AGGREGATION",
    "selector": "SIZE_8", "smoother": {"scope": "jac",
        "solver": "BLOCK_JACOBI", "relaxation_factor": 0.8,
        "monitor_residual": 0},
    "presweeps": 1, "postsweeps": 1, "max_levels": 20,
    "min_coarse_rows": 16, "coarse_solver": "DENSE_LU_SOLVER",
    "cycle": "V", "max_iters": 120, "monitor_residual": 1,
    "convergence": "RELATIVE_INI", "tolerance": 1e-08, "norm": "L2",
    "matrix_free": %d, "fused_cycle": %d}}
"""


def _amg(matrix_free, fused, A):
    s = T.create_solver(T.AMGConfig.from_string(AMG_CFG % (matrix_free,
                                                           fused)),
                        "default", device="cpu")
    return s.setup(A)


@pytest.mark.parametrize("fused", [0, 1])
def test_matrix_free_solve_bitwise_equals_dia(fused):
    """matrix_free=1 reproduces the DIA solve bit for bit, fused or not
    (tests/test_matrix_free.py, for the port)."""
    A = t_poisson(16, device="cpu")
    b = poisson_rhs(A.n_rows)
    s_ref = _amg(0, 0, A)
    s_mf = _amg(1, fused, A)
    assert all(lv.A.format == "DIA" for lv in s_ref.levels)
    assert all(lv.A.format == "MATRIX_FREE" for lv in s_mf.levels)
    # the finest operator was rebuilt from the host CSR on the same
    # device; the caller's matrix keeps its format
    assert s_mf.levels[0].A is not A and A.format == "DIA"
    r_ref, r_mf = s_ref.solve(b), s_mf.solve(b)
    assert r_mf.status == 0 and r_mf.iters == r_ref.iters
    assert r_mf.x.numpy().tobytes() == r_ref.x.numpy().tobytes()
    L = len(s_mf.levels)
    assert s_ref.cycle_passes_per_iteration() == 3 * (L - 1) + 1
    assert s_mf.cycle_passes_per_iteration() == \
        (2 if fused else 3) * (L - 1) + 1


def test_fused_cycle_is_a_no_op_without_matrix_free():
    A = t_poisson(16, device="cpu")
    s_ref, s_f = _amg(0, 0, A), _amg(0, 1, A)
    L = len(s_f.levels)
    assert s_f.cycle_passes_per_iteration() == 3 * (L - 1) + 1
    b = poisson_rhs(A.n_rows)
    assert s_f.solve(b).x.numpy().tobytes() == \
        s_ref.solve(b).x.numpy().tobytes()


def test_fused_leg_records_one_pass_on_the_enclosing_counter():
    s = _amg(1, 1, t_poisson(8, device="cpu"))
    lvl = s.levels[0]
    smooth = lvl.smoother.make_smooth()
    smp = lvl.smoother.apply_params()
    b = torch.from_numpy(_x(lvl.A.n_rows, np.float64))
    x = torch.zeros_like(b)
    with tspmv.op_pass_counter() as outer:
        xf, rf, bcf = tst.fused_cycle_leg(lvl.A, lvl.R, smooth, smp, b, x, 1)
        assert outer.count == 1
        with tspmv.op_pass_counter() as inner:
            xu = smooth(smp, b, x, 1)
            ru = b - tspmv.spmv(lvl.A, xu)
            bcu = tspmv.spmv(lvl.R, ru)
        assert inner.count == 2
    assert outer.count == 1
    for f, u in ((xf, xu), (rf, ru), (bcf, bcu)):
        assert f.numpy().tobytes() == u.numpy().tobytes()


def _bench_cfg(fused):
    return (
        '{"config_version": 2, "solver": {"scope": "main",'
        ' "solver": "PCG", "max_iters": 100, "tolerance": 1e-6,'
        ' "monitor_residual": 1, "convergence": "RELATIVE_INI",'
        ' "preconditioner": {"scope": "amg", "solver": "AMG",'
        ' "algorithm": "AGGREGATION", "selector": "SIZE_8",'
        ' "smoother": {"scope": "j", "solver": "BLOCK_JACOBI",'
        ' "relaxation_factor": 0.8, "monitor_residual": 0},'
        ' "presweeps": 1, "postsweeps": 1, "max_iters": 1,'
        ' "min_coarse_rows": 512, "max_levels": 20,'
        ' "coarse_solver": "DENSE_LU_SOLVER", "cycle": "V",'
        f' "matrix_free": 1, "fused_cycle": {fused},'
        ' "monitor_residual": 0}}}'
    )


def _jformat(A):
    if A.has_matrix_free:
        return "MATRIX_FREE"
    if A.has_dia:
        return "DIA"
    if A.has_dense:
        return "dense"
    return "ELL" if A.has_ell else "CSR"


_JAX_RUNS = {}


def _jax_bench(fused, dtype):
    key = (fused, dtype)
    if key not in _JAX_RUNS:
        A = j_poisson(24, dtype=dtype)
        b = poisson_rhs(A.n_rows, dtype=dtype)
        s = j_create(JConfig.from_string(_bench_cfg(fused)), "default")
        s.setup(A)
        _JAX_RUNS[key] = (s, s.solve(b), b)
    return _JAX_RUNS[key]


def _assert_solves_match(jr, tr, dtype):
    assert tr.status == int(jr.status) == 0
    xj, xt = np.asarray(jr.x), tr.x.numpy()
    if dtype == np.float64:
        assert tr.iters == int(jr.iters)
        rtol = 1e-10
    else:
        assert abs(tr.iters - int(jr.iters)) <= 1
        rtol = 1e-4
    np.testing.assert_allclose(xt, xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fused", [0, 1])
def test_bench_slice_matrix_free_matches_jax(fused, dtype):
    js, jr, b = _jax_bench(fused, dtype)
    A = t_poisson(24, dtype=dtype, device="cpu")
    ts = T.create_solver(T.AMGConfig.from_string(_bench_cfg(fused)),
                         "default", device="cpu").setup(A)
    tr = ts.solve(b)
    t_lv = [(lv["rows"], lv["nnz"], lv["format"])
            for lv in ts.precond.level_summary()]
    j_lv = [(lv.A.n_rows, lv.A.nnz, _jformat(lv.A))
            for lv in js.precond.levels]
    assert t_lv == j_lv
    assert [f for _, _, f in t_lv] == ["MATRIX_FREE"] * 3
    L = len(t_lv)
    passes = ts.precond.cycle_passes_per_iteration()
    assert passes == js.precond.cycle_passes_per_iteration()
    assert passes == (2 if fused else 3) * (L - 1) + 1
    _assert_solves_match(jr, tr, dtype)
    assert "MATRIX_FREE" in ts.precond.grid_stats()


def test_hierarchy_from_numpy_builds_matrix_free_levels():
    """A hierarchy carried across from the JAX package builds its
    operators with the config's formats: MATRIX_FREE under
    matrix_free=1, as after setup."""
    js, jr, b = _jax_bench(1, np.float64)

    def csr(M):
        sp = M.to_scipy().tocsr()
        return (sp.indptr, sp.indices, sp.data, sp.shape)

    levels = []
    for i, lv in enumerate(js.precond.levels):
        d = {"A": csr(lv.A)}
        if i + 1 < len(js.precond.levels):
            d["P"], d["R"] = csr(lv.P), csr(lv.R)
        levels.append(d)
    ts = hierarchy_from_numpy(levels, T.AMGConfig.from_string(_bench_cfg(1)),
                              device="cpu")
    assert [lv["format"] for lv in ts.precond.level_summary()] == \
        ["MATRIX_FREE"] * len(levels)
    assert ts.precond.cycle_passes_per_iteration() == \
        2 * (len(levels) - 1) + 1
    _assert_solves_match(jr, ts.solve(b), np.float64)
