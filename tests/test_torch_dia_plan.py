"""The DIA kernel's host launch plan and wrapper (``ops/dia.py``).

The kernel (``csrc/dia_spmv.cu``) runs only on the card; here the CPU
holds what surrounds it: the plan's partition of the rows, its rows a
thread, its instantiation and its packed offsets, a numpy model of the
kernel's realigned x window, the wrapper's checks, and the wrapper's
plain version against the JAX package on the shapes the plan treats
differently (rows not a multiple of 8, runtime diagonal counts).
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from amgx_tpu.core.matrix import SparseMatrix as JMatrix
from amgx_tpu.io.poisson import poisson_scipy
from amgx_tpu.ops import pallas_dia as pd
from amgx_tpu_torch.core.matrix import SparseMatrix as TMatrix
from amgx_tpu_torch.ops import dia
from amgx_tpu_torch.ops import spmv as tspmv

jspmv = importlib.import_module("amgx_tpu.ops.spmv")

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
          "f64": torch.float64}
STAR = (-4096, -64, -1, 0, 1, 64, 4096)


def _rows_of(plan):
    """Every row each thread of ``plan`` computes, in launch order."""
    t = np.arange(plan.blocks * plan.threads, dtype=np.int64)
    i0 = t * plan.vec
    rows = (i0[:, None] + np.arange(plan.vec)).ravel()
    # a thread whose first row is past the end computes nothing
    return rows[np.repeat(i0 < plan.n, plan.vec)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 7, 512, 4097, 32768, 262144, 2096770,
                               2097152])
def test_plan_covers_every_row_once(n, dtype):
    plan = dia.dia_launch_plan(n, (0,) if n == 1 else (-1, 0, 1),
                               DTYPES[dtype])
    rows = _rows_of(plan)
    assert rows.size == n
    np.testing.assert_array_equal(np.sort(rows), np.arange(n))
    assert plan.threads == dia.PLAN_THREADS
    # the grid is exact: the last block holds a row
    assert (plan.blocks - 1) * plan.threads * plan.vec < n


@pytest.mark.parametrize("dtype,n,vec", [
    ("bf16", 8 << 18, 4), ("bf16", 4 * 262145, 4), ("bf16", 2 * 1048577, 2),
    ("bf16", 1048577, 1), ("f32", 8 << 18, 2), ("f32", 4 * 262145, 2),
    ("f32", 2 * 1048577, 2), ("f32", 1048577, 1), ("f64", 8 << 18, 1),
    ("f64", 1048577, 1),
])
def test_vec_is_the_largest_vector_n_allows(dtype, n, vec):
    """One VEC_BYTES plane vector a thread where n is a multiple of it,
    else the largest power of two dividing n (n large enough that every
    SM has a block at that vec)."""
    plan = dia.dia_launch_plan(n, STAR, DTYPES[dtype])
    assert plan.vec == vec
    assert plan.vec * DTYPES[dtype].itemsize <= dia.VEC_BYTES
    assert n % plan.vec == 0


@pytest.mark.parametrize("align,vec", [(16, 4), (8, 4), (4, 2), (2, 1)])
def test_vec_follows_the_pointers_alignment(align, vec):
    plan = dia.dia_launch_plan(1 << 21, STAR, torch.bfloat16, align=align)
    assert plan.vec == vec


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_small_levels_drop_vec_until_every_sm_has_a_block(dtype):
    sms = dia.H100_SMS
    for n in (512, 4096, 32768, 131072, 262144, 1 << 20):
        plan = dia.dia_launch_plan(n, (-1, 0, 1), DTYPES[dtype], sms)
        full = max(1, dia.VEC_BYTES // DTYPES[dtype].itemsize)
        assert plan.vec == 1 or plan.blocks >= sms
        if plan.vec < full:
            # one vec more would have left an SM without a block
            assert -(-n // (2 * plan.vec * plan.threads)) < sms
    # the bench hierarchy's 32,768-row level takes one row a thread,
    # its 262,144-row level one vector
    assert dia.dia_launch_plan(32768, STAR, torch.float32).vec == 1
    assert dia.dia_launch_plan(262144, STAR, torch.float32).vec == 2
    assert dia.dia_launch_plan(2097152, STAR, torch.bfloat16).vec == 4
    assert dia.dia_launch_plan(32768, STAR, torch.float32, sms=16).vec == 2


@pytest.mark.parametrize("nd,inst", [(7, 7), (5, 0), (27, 0), (48, 0),
                                     (1, 0)])
def test_nd_inst_is_7_for_seven_diagonals_else_the_runtime_count(nd, inst):
    offs = tuple(range(-(nd // 2), nd - nd // 2))
    plan = dia.dia_launch_plan(4096, offs, torch.float32)
    assert plan.nd_inst == inst
    assert plan.offsets == offs


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="49 diagonals"):
        dia.dia_launch_plan(4096, tuple(range(-24, 25)), torch.float32)
    with pytest.raises(ValueError, match="0 diagonals"):
        dia.dia_launch_plan(4096, (), torch.float32)
    with pytest.raises(ValueError, match="0 rows"):
        dia.dia_launch_plan(0, (0,), torch.float32)
    with pytest.raises(ValueError, match="reach past"):
        dia.dia_launch_plan(64, (-64, 0), torch.float32)


def test_packed_plan_carries_the_matrix_offsets_by_value():
    A = TMatrix.from_scipy(poisson_scipy((12, 10, 9)), device="cpu")
    assert A.has_dia
    plan = dia.dia_launch_plan(A.n_rows, A.dia_offsets, A.dtype)
    arr = list(dia.pack_plan(plan))
    nd = len(A.dia_offsets)
    assert arr[:5] == [nd, plan.nd_inst, plan.vec, plan.threads,
                       plan.blocks]
    assert tuple(arr[5:]) == A.dia_offsets
    assert len(arr) == 5 + nd


def _window_model(xw, n, i0, off, vec, size):
    """The kernel's realigned x window (``load_x_window`` and
    ``shift_window`` in ``csrc/dia_spmv.cu``, the bf16 way and, built
    with ``-DDIA_X_WAY=2``, every type's) on the uint32 words ``xw`` of
    x: two aligned vectors, zero outside [0, n), shifted down by whole
    words in steps of 2 and 1 words, then by half a word
    (``__byte_perm`` 0x5432)."""
    W = vec * size // 4
    r = off & (vec - 1)
    a = i0 + off - r
    w = [0] * (2 * W)
    for h, start in enumerate((a, a + vec)):
        if (h == 0 or r) and 0 <= start < n:
            k = start * size // 4
            w[h * W:(h + 1) * W] = xw[k:k + W]
    b = r * size
    q = b >> 2
    if W >= 4 and q & 2:
        w = w[2:] + w[-2:]
    if W >= 2 and q & 1:
        w = w[1:] + w[-1:]
    if size == 2 and b & 2:
        w = [(w[j] >> 16) | ((w[j + 1] << 16) & 0xFFFFFFFF)
             for j in range(W)] + w[W:]
    return np.asarray(w[:W], dtype=np.uint32)


@pytest.mark.parametrize("size,vec", [(2, 8), (2, 4), (2, 2), (4, 4),
                                      (4, 2), (8, 2)])
def test_realigned_x_window_model(size, vec):
    """Every offset residue, rows at both ends: the window holds
    x[i0 + off + e], and zeros where that column is outside [0, n)."""
    n = 64 * vec
    rng = np.random.default_rng(size * 16 + vec)
    x = rng.integers(1, 2 ** 16, n * size // 2).astype(np.uint16)
    xw = x.view(np.uint32).tolist()
    elem = {2: np.uint16, 4: np.uint32, 8: np.uint64}[size]
    xe = x.view(elem)
    for off in range(-3 * vec - 1, 3 * vec + 2):
        for i0 in (0, vec, n // 2, n - 2 * vec, n - vec):
            got = _window_model(xw, n, i0, off, vec, size).view(elem)
            j = i0 + off + np.arange(vec)
            want = np.where((j >= 0) & (j < n), xe[np.clip(j, 0, n - 1)], 0)
            np.testing.assert_array_equal(got, want.astype(elem))


def test_wrapper_raises_on_offsets_that_disagree_with_the_planes():
    A = TMatrix.from_scipy(poisson_scipy((8, 8, 8)), device="cpu")
    x = torch.ones(512, dtype=torch.float64)
    with pytest.raises(ValueError, match="6 offsets for 7 diagonal"):
        dia.dia_spmv(A.dia_vals, A.dia_offsets[:6], x)
    with pytest.raises(ValueError, match="8 offsets for 7 diagonal"):
        dia.dia_spmv(A.dia_vals, A.dia_offsets + (100,), x)


def test_wrapper_never_reads_offsets_from_a_device():
    """Offsets as a tensor off the CPU raise (the wrapper takes host
    ints and would otherwise read them back); a meta tensor stands in
    for the card here."""
    with pytest.raises(ValueError, match="host ints"):
        dia._host_offsets(torch.zeros(7, dtype=torch.int32, device="meta"))
    assert dia._host_offsets(torch.tensor([-1, 0, 1])) == (-1, 0, 1)
    assert dia._host_offsets((np.int64(-1), 0, 1)) == (-1, 0, 1)


def test_cpu_tensors_take_the_plain_version_without_counting():
    A = TMatrix.from_scipy(poisson_scipy((9, 8, 7)), device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        A.n_rows))
    d0, v0 = dia.launches, dict(dia.variant_launches)
    y = dia.dia_spmv(A.dia_vals, A.dia_offsets, x)
    assert torch.equal(y, dia.dia_spmv_plain(A.dia_vals, A.dia_offsets, x))
    assert torch.equal(tspmv.spmv(A, x), y)
    assert (dia.launches, dia.variant_launches) == (d0, v0)


def _banded(n, offsets, seed):
    rng = np.random.default_rng(seed)
    return sps.diags_array(
        [rng.standard_normal(n - abs(o)) for o in offsets],
        offsets=list(offsets), shape=(n, n), format="csr")


_PLAN_CASES = {
    "odd rows 7x9x11": lambda: poisson_scipy((11, 9, 7)),
    "rows 2 mod 4 (5x5x6)": lambda: poisson_scipy((6, 5, 5)),
    "27 diagonals 10^3": lambda: sps.kron(sps.kron(
        _ones3(10), _ones3(10)), _ones3(10), format="csr"),
    "48 diagonals 3000 rows": lambda: _banded(
        3000, sorted(set(range(-45, 48, 2)) | {0}), 4),
}


def _ones3(m):
    return sps.diags_array([np.ones(m - 1), np.ones(m), np.ones(m - 1)],
                           offsets=[-1, 0, 1], format="csr")


@pytest.mark.parametrize("case", list(_PLAN_CASES))
def test_wrapper_matches_jax_on_the_plans_shapes(case):
    """The wrapper's CPU path against the JAX package's XLA DIA product
    in f64 (rtol 1e-12: the same products summed in the same order up to
    rounding) and its Pallas kernel in interpret mode in f32 (rtol 2e-5,
    as tests/test_pallas_dia.py)."""
    m = _PLAN_CASES[case]()
    T = TMatrix.from_scipy(m, device="cpu")
    J = JMatrix.from_scipy(m)
    assert T.format == "DIA" and T.dia_offsets == tuple(J.dia_offsets)
    nd = len(T.dia_offsets)
    assert nd == {"27 diagonals 10^3": 27,
                  "48 diagonals 3000 rows": 48}.get(case, 7)
    plan = dia.dia_launch_plan(T.n_rows, T.dia_offsets, T.dtype)
    assert plan.nd_inst == (7 if nd == 7 else 0)
    x = np.random.default_rng(5).standard_normal(T.n_rows)
    y = dia.dia_spmv(T.dia_vals, T.dia_offsets, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jspmv._spmv_dia(J, x)),
                               rtol=1e-12, atol=1e-12)
    T32 = TMatrix.from_scipy(m.astype(np.float32), device="cpu")
    J32 = JMatrix.from_scipy(m.astype(np.float32))
    x32 = x.astype(np.float32)
    y32 = dia.dia_spmv(T32.dia_vals, T32.dia_offsets, torch.from_numpy(x32))
    np.testing.assert_allclose(
        y32.numpy(), np.asarray(pd.pallas_dia_spmv(J32, x32, interpret=True)),
        rtol=2e-5, atol=2e-5)
