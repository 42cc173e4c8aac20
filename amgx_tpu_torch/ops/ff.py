"""Float-float (double-single) arithmetic for 1e-8 solves in f32
(the JAX package's ``ops/ff.py``).

A value is an unevaluated pair ``hi + lo`` of f32 tensors with |lo| <=
ulp(hi)/2, about 49 effective mantissa bits.  Knuth's two-sum and
Dekker's two-product (Veltkamp split) are error-free transformations
built from plain adds and multiplies, no FMA.  Used by
``solvers/refinement.py``: x is carried as a pair, the residual is
accumulated in ff, and an f32 inner solver supplies the corrections.

Each function here is a sequence of eager torch operations: every
operation runs as its own kernel and rounds its result, so the
identities the error-free transformations rest on hold as written.  The
JAX package pins its intermediates with ``optimization_barrier``
because XLA's simplifier would rewrite ``(a + b) - a`` to ``b`` inside
one fused program; nothing here fuses or reorders operations, so no
barrier is needed.  (Were this arithmetic moved into CUDA C++, nvcc's
default contraction of ``a * b + c`` into an FMA would break it: such
code needs ``__fadd_rn`` / ``__fmul_rn`` or ``-fmad=false``.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SPLITTER = 4097.0  # 2^12 + 1 for f32 (Veltkamp)


def two_sum(a, b):
    """s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """hi + lo == a with hi holding the top 12 bits (Veltkamp); inputs
    beyond 1e34 are scaled by 2^-16 first so 4097 a cannot overflow."""
    big = torch.abs(a) > 1e34
    a2 = torch.where(big, a * 2.0 ** -16, a)
    c = _SPLITTER * a2
    hi = c - (c - a2)
    lo = a2 - hi
    return (torch.where(big, hi * 2.0 ** 16, hi),
            torch.where(big, lo * 2.0 ** 16, lo))


def two_prod(a, b):
    """p + e == a * b exactly (Dekker, no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ff(hi, lo=None):
    """Pair constructor (lo defaults to 0)."""
    return (hi, torch.zeros_like(hi) if lo is None else lo)


def renorm(hi, lo):
    return two_sum(hi, lo)


def ff_add(x, y):
    """(hi, lo) + (hi, lo)."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return renorm(s, e)


def ff_add_f(x, a):
    """(hi, lo) + a single-precision tensor."""
    s, e = two_sum(x[0], a)
    return renorm(s, e + x[1])


def ff_neg(x):
    return (-x[0], -x[1])


def ff_to_f(x):
    return x[0] + x[1]


def ff_residual_dia(A, b_ff, x_ff):
    """r = b - A x with ff accumulation for a DIA matrix (f32 planes;
    b_ff and x_ff pairs).  Error per element O(eps^2 w |A||x|): it
    resolves residuals near rtol 1e-12, below the 1e-8 target.  A batch
    (B, n) of pairs takes a batched view's planes (B, nd, n), or A's
    planes shared: each instance's operations are the unbatched ones,
    element by element, so its bits are too."""
    n = A.n_rows
    offs = A.dia_offsets
    pneg = max(0, -min(offs))
    ppos = max(0, max(offs))
    xh = F.pad(x_ff[0], (pneg, ppos))
    xl = F.pad(x_ff[1], (pneg, ppos))
    hi, lo = b_ff
    for k, off in enumerate(offs):
        sh = xh[..., off + pneg:off + pneg + n]
        sl = xl[..., off + pneg:off + pneg + n]
        d = A.dia_vals[..., k, :]
        p, pe = two_prod(d, sh)
        # subtract the exact product and the low-order terms
        hi, e = two_sum(hi, -p)
        lo = lo + e - pe - d * sl
    return renorm(hi, lo)


def ff_residual(A, b_ff, x_ff):
    """r = b - A x as an ff pair: full ff accumulation for DIA
    matrices; other formats accumulate the dominant terms only (the
    x_lo contribution exact, the per-product errors dropped).  Pairs of
    (B, n) batches take a batched view of A or A shared."""
    from amgx_tpu_torch.ops.spmv import spmv

    if A.has_dia:
        return ff_residual_dia(A, b_ff, x_ff)
    hi, e = two_sum(b_ff[0], -spmv(A, x_ff[0]))
    lo = b_ff[1] + e - spmv(A, x_ff[1])
    return renorm(hi, lo)
