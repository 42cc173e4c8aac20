"""Shape bucketing for the batched solve service (the JAX package's
``serve/bucketing.py``, host numpy copied).

Every request is padded to a small set of (n, nnz, batch) buckets of
power-of-two growth, so that requests of nearby sizes share one batched
group and one built batched solve (``serve/cache.py``).  The padding
keeps the padded system equivalent to the original:

  * rows n..nb-1 get a single unit diagonal entry and rhs 0, so the
    padded block solves to exactly 0 and cannot couple back (the
    identity tail is its own invariant subspace);
  * leftover nnz slots are zero-valued duplicates of each row's LAST
    stored entry, spread evenly across all rows: duplicates sum in
    every SpMV path (the DIA build adds them, ``core/matrix.py``),
    adding nothing, and spreading keeps the max row length (the ELL
    width) near the original.

``template_matrix`` builds the padded matrix in the formats the
service picks (DIA, ELL, dense or CSR); an ELL template keeps the
sliced layout ``SparseMatrix.from_csr`` builds beside the slot-major
arrays where it streams fewer bytes, and its batched SpMVs take it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from amgx_tpu_torch.core.matrix import SparseMatrix, sparsity_fingerprint

# Smallest bucket edges: tiny systems all collapse into one bucket
MIN_ROWS_BUCKET = 64
MIN_NNZ_BUCKET = 256
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def bucket_size(x: int, floor: int) -> int:
    """Next power of two >= max(x, floor)."""
    n = max(int(x), floor)
    return 1 << (n - 1).bit_length()


def bucket_batch(b: int) -> int:
    """Smallest batch bucket >= b (power-of-two growth continues past
    the table for services configured with a larger max_batch)."""
    for cand in BATCH_BUCKETS:
        if cand >= b:
            return cand
    return bucket_size(b, BATCH_BUCKETS[-1])


@dataclasses.dataclass(frozen=True)
class PaddedPattern:
    """One request pattern padded to its (nb, nnzb) bucket.

    row_offsets/col_indices are the padded host CSR index arrays;
    ``scatter`` maps the ORIGINAL nnz positions into the padded values
    array and ``ones_pos`` holds the identity-tail diagonal slots, so
    per-request coefficient arrays embed with two fancy assignments.
    """

    row_offsets: np.ndarray
    col_indices: np.ndarray
    scatter: np.ndarray  # (nnz,) original entry -> padded position
    ones_pos: np.ndarray  # (nb - n,) identity-tail diagonal positions
    n: int  # original rows
    nnz: int  # original nnz
    nb: int  # bucketed rows
    nnzb: int  # bucketed nnz
    max_row_len: int  # padded max row length (ELL width gate)
    num_diagonals: int  # distinct (col - row) offsets (DIA gate)
    fingerprint: str  # fingerprint of the PADDED pattern

    def embed_values(self, values: np.ndarray, dtype=None) -> np.ndarray:
        """Original (nnz,) coefficients -> padded (nnzb,) array with
        unit identity tail and zero filler."""
        values = np.asarray(values).reshape(-1)
        if values.shape[0] != self.nnz:
            raise ValueError(
                f"expected {self.nnz} coefficients, got {values.shape[0]}"
            )
        dt = np.dtype(dtype) if dtype is not None else values.dtype
        out = np.zeros(self.nnzb, dtype=dt)
        out[self.scatter] = values
        out[self.ones_pos] = 1.0
        return out

    def embed_values_into(self, out: np.ndarray, values: np.ndarray):
        """In-place :meth:`embed_values` into a staging row primed for
        THIS pattern (filler slots zero, identity-tail slots one), so
        only the real coefficients are written."""
        values = np.asarray(values).reshape(-1)
        if values.shape[0] != self.nnz:
            raise ValueError(
                f"expected {self.nnz} coefficients, got {values.shape[0]}"
            )
        out[self.scatter] = values

    def embed_vector_into(self, out: np.ndarray, vec):
        """In-place :meth:`embed_vector` into a staging row whose tail
        [n:] is already zero (slot invariant)."""
        if vec is None:
            out[: self.n] = 0
            return
        v = np.asarray(vec).reshape(-1)
        if v.shape[0] != self.n:
            raise ValueError(
                f"expected length-{self.n} vector, got {v.shape[0]}"
            )
        out[: self.n] = v

    def extract_values(self, padded: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`embed_values` for the original slots."""
        return np.asarray(padded).reshape(-1)[self.scatter]

    def embed_vector(self, vec, dtype) -> np.ndarray:
        """Original (n,) vector -> zero-extended (nb,) array."""
        out = np.zeros(self.nb, dtype=dtype)
        if vec is not None:
            v = np.asarray(vec).reshape(-1)
            if v.shape[0] != self.n:
                raise ValueError(
                    f"expected length-{self.n} vector, got {v.shape[0]}"
                )
            out[: self.n] = v
        return out

    def template_matrix(self, values, dtype, accel_formats=(),
                        device="cuda") -> SparseMatrix:
        """The padded matrix on ``device``, in the formats of
        ``accel_formats`` (a subset of DIA, dense and ELL; none: CSR),
        an ELL one with the sliced layout where ``from_csr`` builds it
        (the batched template's SpMVs then take it)."""
        if not set(accel_formats) <= {"dia", "dense", "ell"}:
            raise ValueError(f"template formats {accel_formats}")
        return SparseMatrix.from_csr(
            self.row_offsets,
            self.col_indices,
            self.embed_values(values, dtype=dtype),
            n_cols=self.nb,
            accel_formats=tuple(accel_formats),
            device=device,
        )


class StagingSlot:
    """Persistent, reused host staging for one (pattern, dtype) group:
    ``vals (rows, nnzb)`` / ``bs (rows, nb)`` / ``x0s (rows, nb)``,
    written row by row at submit() and shipped to the device as one
    contiguous slice at flush.  Slot invariants after ``__init__``:
    every vals row has zeros at filler slots and ones at the identity
    tail (only the scatter positions are ever rewritten), and vector
    rows are zero past ``pattern.n``.  The service keeps two slots per
    group key, so one group can be staged while the other is
    solved."""

    __slots__ = (
        "pattern", "vals", "bs", "x0s", "rows", "in_use",
        "x0_used", "x0_dirty",
    )

    def __init__(self, pattern: PaddedPattern, dtype, rows: int):
        self.pattern = pattern
        self.rows = int(rows)
        dt = np.dtype(dtype)
        self.vals = np.zeros((rows, pattern.nnzb), dtype=dt)
        self.vals[:, pattern.ones_pos] = 1.0
        self.bs = np.zeros((rows, pattern.nb), dtype=dt)
        self.x0s = np.zeros((rows, pattern.nb), dtype=dt)
        self.in_use = False
        # x0_used: a request of the CURRENT group supplied a warm start;
        # x0_dirty: some PAST group wrote warm starts, so zero-x0 rows
        # must be re-zeroed before reuse
        self.x0_used = False
        self.x0_dirty = False

    def write_row(self, i: int, values, b, x0):
        """Embed one request into row ``i`` (exclusively owned by the
        writing thread until the group flushes)."""
        pat = self.pattern
        pat.embed_values_into(self.vals[i], values)
        pat.embed_vector_into(self.bs[i], b)
        if x0 is not None:
            self.x0_used = True
            self.x0_dirty = True
            pat.embed_vector_into(self.x0s[i], x0)
        elif self.x0_dirty:
            pat.embed_vector_into(self.x0s[i], None)

    def fill_batch_padding(self, n_real: int, batch: int):
        """Rows [n_real:batch] become batch-padding clones of row 0
        with b = x0 = 0: they converge at iteration 0 and freeze."""
        if batch > n_real:
            self.vals[n_real:batch] = self.vals[0]
            n = self.pattern.n
            self.bs[n_real:batch, :n] = 0
            self.x0s[n_real:batch, :n] = 0


def pad_pattern(row_offsets, col_indices, n: int) -> PaddedPattern:
    """Pad a scalar CSR pattern to its (nb, nnzb) bucket.

    Filler entries (zero-valued duplicates of each row's last stored
    column) are spread evenly over all rows, the remainder to the
    shortest rows, so the padded max row length stays close to the
    original (the ELL width)."""
    row_offsets = np.asarray(row_offsets, dtype=np.int64)
    col_indices = np.asarray(col_indices, dtype=np.int32)
    nnz = int(col_indices.shape[0])
    pad_rows_pre = bucket_size(n, MIN_ROWS_BUCKET) - n
    nb = n + pad_rows_pre
    nnzb = bucket_size(nnz + pad_rows_pre, MIN_NNZ_BUCKET)
    filler = nnzb - nnz - pad_rows_pre
    # per-row entry counts: original rows keep theirs, padding rows get
    # their unit diagonal; filler spreads evenly across all nb rows
    lens = np.empty(nb, dtype=np.int64)
    lens[:n] = np.diff(row_offsets)
    lens[n:] = 1
    base_lens = lens.copy()
    q, rem = divmod(filler, nb)
    lens += q
    # remainder extras go to the SHORTEST rows: keeps the padded max row
    # length stable across patterns that share a row-length multiset
    if rem:
        lens[np.argsort(base_lens, kind="stable")[:rem]] += 1
    ro = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(lens, out=ro[1:])
    if ro[nb] != nnzb:
        raise AssertionError("pad_pattern: padded rows do not fill nnzb")
    # original entries keep their in-row order at each row's start
    row_ids = np.repeat(np.arange(n, dtype=np.int64),
                        np.diff(row_offsets))
    scatter = (
        ro[row_ids] + np.arange(nnz, dtype=np.int64) - row_offsets[row_ids]
    )
    ones_pos = ro[n:nb]  # padding rows' diagonal slot
    # filler columns: duplicate each row's LAST stored column (its own
    # diagonal for padding rows), appended after the real entries, so
    # in-row column order stays non-decreasing
    ci = np.zeros(nnzb, dtype=np.int32)
    ci[scatter] = col_indices
    ci[ones_pos] = n + np.arange(pad_rows_pre, dtype=np.int64)
    last_col = np.zeros(nb, dtype=np.int32)
    has = np.diff(row_offsets) > 0
    last_col[:n][has] = col_indices[row_offsets[1:][has] - 1]
    last_col[n:] = n + np.arange(pad_rows_pre, dtype=np.int64)
    fill_rows = np.repeat(
        np.arange(nb, dtype=np.int64), (lens - base_lens)
    )
    # the slots left free, ascending (np.setdiff1d of the taken ones
    # from every slot, without its sorts)
    free = np.ones(nnzb, dtype=bool)
    free[scatter] = False
    free[ones_pos] = False
    fill_pos = np.flatnonzero(free)
    ci[fill_pos] = last_col[fill_rows]
    ro32 = ro.astype(np.int32)
    fp = sparsity_fingerprint(ro32, ci, nb, nb, 1)
    pad_row_ids = np.repeat(np.arange(nb, dtype=np.int64), lens)
    num_diags = int(np.unique(ci.astype(np.int64) - pad_row_ids).size)
    return PaddedPattern(
        row_offsets=ro32,
        col_indices=ci,
        scatter=scatter,
        ones_pos=ones_pos.astype(np.int64),
        n=int(n),
        nnz=nnz,
        nb=nb,
        nnzb=nnzb,
        max_row_len=int(lens.max()) if nb else 0,
        num_diagonals=num_diags,
        fingerprint=fp,
    )
