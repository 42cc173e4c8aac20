"""Fixed-pattern sparse-sparse products on the device (numeric SpGEMM).

Counterpart of the JAX package's ``amg/spgemm.py`` (reference
CSR_Multiply, csr_multiply_detail.cu, and the Galerkin products of the
setup).  The symbolic phase (the output pattern and, for each output
nonzero, the list of (left nnz, right nnz) pairs whose products sum
into it) runs once on the host with numpy, copied from the JAX
package, so both packages build the same index arrays bit for bit.  The
numeric phase is a *plan* on the device: for new values it is two
gathers, a multiply and a sum of each output's run of the sorted
pairs, so a values-only resetup re-forms every Galerkin product
``R A P`` without the host.

The pairs are stored sorted by output nonzero, and each output's run of
them is summed by ``torch.segment_reduce`` over the runs' offsets (the
row sum of the CSR SpMV, ``ops/spmv.segment_sum``): each sums in pair
order from +0.0 on both devices, so two applies to the same values give
the same bits (``index_add_`` would sum with atomics on the card, in an
order that changes from run to run).  No hand-written kernel is used.
The offsets stand in for the JAX package's ``out_idx`` (the output
position of each pair, which it hands to ``segment_sum``): ``out_idx``
is ``repeat(arange(nnz_out), diff(offsets))``.

RAP is planned in two stages (AP, then R(AP)), as in the JAX package:
the three-factor pair list would be |paths(R)| x |paths(AP)| long.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps
import torch

from amgx_tpu_torch.core.matrix import to_tensor
from amgx_tpu_torch.ops.spmv import segment_sum


def _csr_expand(indptr, take):
    """For each element e of ``take`` (row ids into a CSR), the flat
    index ranges [indptr[r], indptr[r+1]) concatenated; plus the segment
    of each and the repeat counts."""
    counts = (indptr[take + 1] - indptr[take]).astype(np.int64)
    total = int(counts.sum())
    out_starts = np.zeros(len(take) + 1, dtype=np.int64)
    np.cumsum(counts, out=out_starts[1:])
    seg = np.repeat(np.arange(len(take), dtype=np.int64), counts)
    offset_in_seg = np.arange(total, dtype=np.int64) - out_starts[seg]
    return indptr[take[seg]].astype(np.int64) + offset_in_seg, seg, counts


@dataclasses.dataclass(eq=False)
class SpMMPlan:
    """Numeric plan for ``Out = B @ C`` with fixed CSR patterns.

    left_idx / right_idx: (T,) int32 flat nnz indices into B's / C's
    values, the pairs sorted by output nonzero; offsets: (nnz_out + 1,)
    int64 start of each output's run of pairs.
    """

    left_idx: torch.Tensor
    right_idx: torch.Tensor
    offsets: torch.Tensor
    nnz_out: int = 0

    def apply(self, b_vals, c_vals):
        """The output's values for B's values ``b_vals`` and C's
        ``c_vals`` (tensors on the plan's device)."""
        contrib = b_vals[self.left_idx] * c_vals[self.right_idx]
        return segment_sum(contrib, self.offsets)

    @property
    def n_paths(self) -> int:
        return int(self.left_idx.shape[0])

    def nbytes(self) -> int:
        """Device bytes of the plan's index arrays."""
        return sum(t.numel() * t.element_size() for t in (
            self.left_idx, self.right_idx, self.offsets))


def plan_spmm(Bsp, Csp, Outsp, device="cuda") -> SpMMPlan:
    """The numeric plan for ``Outsp = Bsp @ Csp`` (host numpy), its
    arrays on ``device``.  ``Outsp`` must be the product's CSR structure
    or cover it (canonical, sorted indices); its values are ignored.
    Raises ``ValueError`` when it does not cover the product."""
    B = Bsp.tocsr()
    C = Csp.tocsr()
    Out = Outsp.tocsr()
    assert B.shape[1] == C.shape[0] and Out.shape == (
        B.shape[0],
        C.shape[1],
    )
    # paths: for each B nnz e = (i, k), all C row-k entries (k, j)
    c_flat, seg, _ = _csr_expand(
        C.indptr.astype(np.int64), B.indices.astype(np.int64)
    )
    b_idx = seg  # seg is the B nnz id (expansion is B-nnz major)
    # output row of each path = B row of e
    b_rows = np.repeat(
        np.arange(B.shape[0], dtype=np.int64), np.diff(B.indptr)
    )
    rows = b_rows[b_idx]
    cols = C.indices[c_flat].astype(np.int64)
    # locate (rows, cols) in Out's CSR: key = row*(ncols+1) + col is
    # strictly increasing in canonical CSR order, so one global
    # searchsorted finds every path's output slot
    ncols = Out.shape[1]
    out_keys = (
        np.repeat(
            np.arange(Out.shape[0], dtype=np.int64), np.diff(Out.indptr)
        )
        * (ncols + 1)
        + Out.indices.astype(np.int64)
    )
    path_keys = rows * (ncols + 1) + cols
    pos = np.searchsorted(out_keys, path_keys)
    if not (
        (pos < out_keys.shape[0]).all() and (out_keys[pos] == path_keys).all()
    ):
        raise ValueError("Outsp pattern does not cover the product")
    order = np.argsort(pos, kind="stable")
    nnz_out = int(Out.indices.shape[0])
    offsets = np.zeros(nnz_out + 1, dtype=np.int64)
    np.cumsum(np.bincount(pos, minlength=nnz_out), out=offsets[1:])
    return SpMMPlan(
        left_idx=to_tensor(b_idx[order].astype(np.int32), device),
        right_idx=to_tensor(c_flat[order].astype(np.int32), device),
        offsets=to_tensor(offsets, device),
        nnz_out=nnz_out,
    )


@dataclasses.dataclass(eq=False)
class RAPPlan:
    """Two-stage numeric Galerkin plan: ``Ac = R @ (A @ P)`` with all
    four patterns fixed (reference computeAOperator; structure
    reuse)."""

    ap: SpMMPlan  # A @ P  -> AP pattern
    rap: SpMMPlan  # R @ AP -> Ac pattern

    def apply(self, r_vals, a_vals, p_vals):
        return self.rap.apply(r_vals, self.ap.apply(a_vals, p_vals))

    def nbytes(self) -> int:
        return self.ap.nbytes() + self.rap.nbytes()


def plan_rap(Rsp, Asp, Psp, Acsp, device="cuda") -> RAPPlan:
    """Host symbolic phase of the Galerkin product (scipy structures),
    the plans' arrays on ``device``.  ``Acsp`` must be (or cover) the
    structure of ``R @ A @ P``.  The intermediate AP pattern is the
    structural (binary) product: scipy's value product prunes entries
    that cancel, and a pruned AP would drop their contributions for
    other values."""
    A = Asp.tocsr()
    P = Psp.tocsr()
    Ab = sps.csr_matrix(
        (np.ones(A.nnz), A.indices, A.indptr), shape=A.shape
    )
    Pb = sps.csr_matrix(
        (np.ones(P.nnz), P.indices, P.indptr), shape=P.shape
    )
    APsp = (Ab @ Pb).tocsr()
    APsp.sort_indices()
    return RAPPlan(
        ap=plan_spmm(Asp, Psp, APsp, device=device),
        rap=plan_spmm(Rsp, APsp, Acsp, device=device),
    )
