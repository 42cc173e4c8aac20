"""MatrixMarket IO with the reference's %%NVAMG extensions.

Reference parity: src/matrix_io.cu (readers/writers), AMGX_read_system /
AMGX_write_system (amgx_c.h:424-460).  Supported:

  * standard ``%%MatrixMarket matrix coordinate real|complex|integer|pattern
    general|symmetric|hermitian|skew-symmetric`` files;
  * the AmgX header extension line ``%%AMGX``/``%%NVAMG <flags>`` carrying
    tokens like ``sorted``, ``diagonal``, ``rhs``, ``solution``,
    ``block_dimx N``/``block_dimy N`` (matrix_io.cu:93-160): when ``rhs`` /
    ``solution`` appear, the vectors follow the matrix entries in the same
    file; ``diagonal`` means external diagonal blocks follow the entries.

Parsing is vectorized (numpy over the whole body) — the ingest path must
handle SuiteSparse-scale files (tens of millions of nnz).
``read_system`` returns host numpy; ``read_mtx`` builds a SparseMatrix
on the card unless the caller passes ``device="cpu"``.

A copy of the JAX package's ``io/matrix_market.py``.  The port has no
complex dtype or block matrices yet: ``read_system`` and
``complex_to_real_system`` read complex files as there, ``read_mtx``
builds real scalar matrices only (convert a complex system with
``complex_to_real_system`` first).
"""

from __future__ import annotations

import numpy as np

from amgx_tpu_torch.core.matrix import SparseMatrix


class MatrixIOError(ValueError):
    pass


def _parse_header(lines):
    header = lines[0].strip().split() if lines else []
    if not header or header[0] != "%%MatrixMarket":
        raise MatrixIOError(
            f"bad MatrixMarket header: {lines[0]!r}"
            if lines
            else "empty MatrixMarket file"
        )
    if len(header) < 5:
        raise MatrixIOError(
            f"short MatrixMarket header ({len(header)} tokens): "
            f"{lines[0]!r}"
        )
    field, sym = header[3].lower(), header[4].lower()
    flags = []
    i = 1
    while i < len(lines) and lines[i].lstrip().startswith("%"):
        if lines[i].startswith(("%%AMGX", "%%NVAMG")):
            tok = lines[i].strip("%").strip().split()
            flags = tok[1:] if tok and tok[0] in ("AMGX", "NVAMG") else tok
        i += 1
    return field, sym, flags, i


def _tokens_to_floats(body_lines):
    """One pass over whitespace-separated numeric tokens (C-level parse)."""
    blob = " ".join(body_lines)
    try:
        return np.array(blob.split(), dtype=np.float64)
    except ValueError as e:
        raise MatrixIOError(
            f"non-numeric token in MatrixMarket body: {e}"
        ) from None


_NVAMG_BIN_HEADER = b"%%NVAMGBinary\n"


def _read_system_binary(path):
    """%%NVAMGBinary reader (reference matrix_io.cu:286-334 writer
    layout): header + 9 uint32 system flags, then CSR int32 offsets and
    columns and f64 values (external diagonal appended), then optional
    f64 rhs/solution."""
    import os

    file_bytes = os.path.getsize(path)
    remaining = [file_bytes - len(_NVAMG_BIN_HEADER)]

    def _take(f, dtype, count, what):
        # size gate BEFORE np.fromfile: a garbled header can claim
        # billions of entries, and attempting the read would be a
        # multi-GB allocation instead of a clean typed error
        need = int(count) * np.dtype(dtype).itemsize
        if count < 0 or need > remaining[0]:
            raise MatrixIOError(
                f"truncated %%NVAMGBinary file: {what} "
                f"({need} bytes claimed, {remaining[0]} left)"
            )
        a = np.fromfile(f, dtype, count)
        if a.shape[0] != count:
            raise MatrixIOError(
                f"truncated %%NVAMGBinary file: {what} "
                f"({a.shape[0]}/{count} read)"
            )
        remaining[0] -= need
        return a

    with open(path, "rb") as f:
        hdr = f.read(len(_NVAMG_BIN_HEADER))
        if hdr != _NVAMG_BIN_HEADER:
            raise MatrixIOError("not a %%NVAMGBinary file")
        flags = _take(f, np.uint32, 9, "system flags")
        (is_mtx, is_rhs, is_soln, mfmt, has_diag, bdx, bdy, n, nnz) = (
            int(v) for v in flags
        )
        if not is_mtx:
            raise MatrixIOError("binary file carries no matrix")
        if mfmt != 0:
            raise MatrixIOError(
                f"unsupported binary matrix format {mfmt} "
                "(CSR real only, matching the reference writer)"
            )
        bsz = bdx * bdy
        row_offsets = _take(f, np.int32, n + 1, "row offsets")
        cols = _take(f, np.int32, nnz, "column indices")
        nval = bsz * (nnz + (n if has_diag else 0))
        vals = _take(f, np.float64, nval, "values")
        # vector lengths follow the reference writer's checks
        # (matrix_io.cu:363,381: rhs n*block_dimy, solution n*block_dimx)
        rhs = (
            _take(f, np.float64, n * bdy, "rhs") if is_rhs else None
        )
        sol = (
            _take(f, np.float64, n * bdx, "solution")
            if is_soln
            else None
        )
    row_lens = np.diff(row_offsets)
    # endpoint checks run even for n == 0 (a garbled header claiming
    # n=0 with nnz>0 must not slip through as an inconsistent system)
    if (
        int(row_offsets[0]) != 0
        or int(row_offsets[-1]) != nnz
        or (row_lens < 0).any()
    ):
        # garbled index section: decodes but is not a CSR (negative
        # row lengths / offsets not summing to nnz) — typed error, not
        # a downstream numpy crash
        raise MatrixIOError(
            "garbled %%NVAMGBinary file: row offsets are not a valid "
            "CSR pointer array"
        )
    rows = np.repeat(np.arange(n, dtype=np.int64), row_lens)
    cols = cols.astype(np.int64)
    vals = vals.reshape(-1, bsz) if bsz > 1 else vals
    if has_diag:
        # trailing n diagonal blocks follow the nnz entry values
        drows = np.arange(n, dtype=np.int64)
        rows = np.concatenate([rows, drows])
        cols = np.concatenate([cols, drows])
    A = dict(
        rows=rows,
        cols=cols,
        vals=vals,
        n_rows=n,
        n_cols=n,
        block_dims=(bdx, bdy),
    )
    return A, rhs, sol


def write_system_binary(path, A: SparseMatrix, rhs=None, sol=None):
    """%%NVAMGBinary writer (reference matrix_io.cu:286-334).  Real
    CSR only — the format encodes f64 values."""
    indptr, indices, data = A._host
    if np.iscomplexobj(data) or any(
        v is not None and np.iscomplexobj(np.asarray(v))
        for v in (rhs, sol)
    ):
        raise MatrixIOError(
            "%%NVAMGBinary encodes real values only; write complex "
            "systems as MatrixMarket text"
        )
    flags = np.array(
        [
            1,
            int(rhs is not None),
            int(sol is not None),
            0,  # CSR
            0,  # no external diagonal (entries carry it)
            A.block_size,
            A.block_size,
            A.n_rows,
            A.nnz,
        ],
        dtype=np.uint32,
    )
    with open(path, "wb") as f:
        f.write(_NVAMG_BIN_HEADER)
        flags.tofile(f)
        np.asarray(indptr, np.int32).tofile(f)
        np.asarray(indices, np.int32).tofile(f)
        np.asarray(data, np.float64).reshape(-1).tofile(f)
        if rhs is not None:
            _host_vector(rhs, np.float64).tofile(f)
        if sol is not None:
            _host_vector(sol, np.float64).tofile(f)


def _host_vector(v, dtype=None):
    """A vector (numpy array or tensor) as a flat host numpy array."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype).reshape(-1)


def read_system(path):
    """Read matrix (+ optional external diagonal / rhs / solution).

    Returns (A_dict, rhs, sol) where A_dict has keys rows, cols, vals,
    n_rows, n_cols, block_dims.  Complex fields keep full complex values
    everywhere (entries, diagonal, rhs, solution).  %%NVAMGBinary files
    are auto-detected.
    """
    with open(path, "rb") as fb:
        if fb.read(len(_NVAMG_BIN_HEADER)) == _NVAMG_BIN_HEADER:
            return _read_system_binary(path)
    with open(path) as f:
        lines = f.read().splitlines()
    field, sym, flags, i = _parse_header(lines)

    block_dimx = block_dimy = 1
    for j, tok in enumerate(flags):
        if tok == "block_dimx":
            block_dimx = int(flags[j + 1])
        if tok == "block_dimy":
            block_dimy = int(flags[j + 1])
    has_rhs = "rhs" in flags
    has_sol = "solution" in flags
    has_ext_diag = "diagonal" in flags

    try:
        sizes = lines[i].split()
        n_rows, n_cols, nnz = int(sizes[0]), int(sizes[1]), int(sizes[2])
    except (IndexError, ValueError):
        raise MatrixIOError(
            "missing or malformed MatrixMarket size line"
        ) from None
    i += 1

    body = [
        s
        for s in (ln.strip() for ln in lines[i:])
        if s and not s.startswith("%")
    ]
    bsz = block_dimx * block_dimy
    is_complex = field == "complex"
    vdt = np.complex128 if is_complex else np.float64
    # values per entry line after the two indices
    vtok = 0 if field == "pattern" else (2 * bsz if is_complex else bsz)

    # ---- matrix entries: one vectorized parse --------------------------
    toks = _tokens_to_floats(body[:nnz])
    per_line = 2 + vtok
    if toks.shape[0] != nnz * per_line:
        raise MatrixIOError(
            f"expected {nnz} entries x {per_line} tokens, got "
            f"{toks.shape[0]} tokens"
        )
    toks = toks.reshape(nnz, per_line)
    rows = toks[:, 0].astype(np.int64) - 1
    cols = toks[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.ones((nnz, bsz) if bsz > 1 else nnz, vdt)
    elif is_complex:
        c = toks[:, 2::2] + 1j * toks[:, 3::2]
        vals = c if bsz > 1 else c[:, 0]
    else:
        vals = toks[:, 2:] if bsz > 1 else toks[:, 2]
    pos = nnz

    def _read_block_lines(count, width):
        t = _tokens_to_floats(body[pos : pos + count])
        w = 2 * width if is_complex else width
        if t.shape[0] != count * w:
            raise MatrixIOError("truncated auxiliary section")
        t = t.reshape(count, w)
        if is_complex:
            t = t[:, 0::2] + 1j * t[:, 1::2]
        return t if width > 1 else t[:, 0]

    if has_ext_diag:
        dvals = _read_block_lines(n_rows, bsz)
        pos += n_rows
        drows = np.arange(n_rows, dtype=np.int64)
        rows = np.concatenate([rows, drows])
        cols = np.concatenate([cols, drows])
        vals = np.concatenate([vals, dvals])

    if sym in ("symmetric", "hermitian", "skew-symmetric"):
        off = rows != cols
        mvals = vals[off]
        if bsz > 1:
            # mirrored block is the (conjugate-)transposed block
            mvals = (
                mvals.reshape(-1, block_dimx, block_dimy)
                .transpose(0, 2, 1)
                .reshape(-1, bsz)
            )
        if sym == "hermitian":
            mvals = np.conj(mvals)
        elif sym == "skew-symmetric":
            mvals = -mvals
        rows, cols = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
        )
        vals = np.concatenate([vals, mvals])

    rhs = sol = None
    nb = n_rows * block_dimx
    if has_rhs:
        rhs = _read_block_lines(nb, 1)
        pos += nb
    if has_sol:
        sol = _read_block_lines(nb, 1)
        pos += nb

    A = dict(
        rows=rows,
        cols=cols,
        vals=vals,
        n_rows=n_rows,
        n_cols=n_cols,
        block_dims=(block_dimx, block_dimy),
    )
    return A, rhs, sol


def read_mtx(path, dtype=None, device="cuda", **kw) -> SparseMatrix:
    """Read a MatrixMarket or %%NVAMGBinary file into a SparseMatrix on
    ``device``; ``kw`` goes to ``SparseMatrix.from_csr``
    (``accel_formats``, ``validate``)."""
    A, _, _ = read_system(path)
    bx, by = A["block_dims"]
    if bx != 1 or by != 1:
        raise MatrixIOError(
            f"{bx}x{by} blocks: block matrices are not ported yet "
            "(ROADMAP.md, queue A: block matrices and reduced precision)"
        )
    vals = A["vals"]
    if np.iscomplexobj(vals):
        raise MatrixIOError(
            "complex system: convert it with complex_to_real_system "
            "(the port has no complex dtype yet)"
        )
    if dtype is not None:
        vals = vals.astype(dtype)
    return SparseMatrix.from_coo(
        A["rows"],
        A["cols"],
        vals,
        n_rows=A["n_rows"],
        n_cols=A["n_cols"],
        device=device,
        **kw,
    )


def write_system(path, A: SparseMatrix, rhs=None, sol=None):
    """Write matrix (+rhs/solution) with the %%AMGX extension header."""
    flags = ["sorted"]
    if rhs is not None:
        flags.append("rhs")
    if sol is not None:
        flags.append("solution")
    indptr, indices, data = A._host
    field = "complex" if np.iscomplexobj(data) else "real"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write("%%AMGX " + " ".join(flags) + "\n")
        f.write(f"{A.n_rows} {A.n_cols} {A.nnz}\n")
        for i in range(A.n_rows):
            for p in range(indptr[i], indptr[i + 1]):
                c = data[p]
                if field == "complex":
                    vtxt = f"{c.real:.17g} {c.imag:.17g}"
                else:
                    vtxt = f"{c:.17g}"
                f.write(f"{i + 1} {indices[p] + 1} {vtxt}\n")
        for vec in (rhs, sol):
            if vec is not None:
                for v in _host_vector(vec):
                    if np.iscomplexobj(v):
                        f.write(f"{v.real:.17g} {v.imag:.17g}\n")
                    else:
                        f.write(f"{v:.17g}\n")


def complex_to_real_system(A_dict, rhs, sol, conversion_type: int):
    """Equivalent-real-formulation (ERF) conversion of a complex system
    (reference readers.cu:221-345 ReadAndConvert, ``complex_conversion``
    config param): K1..K4 produce the 2n x 2n real system

      K1: [[ Re, -Im], [Im,  Re]]   b = [Re b; Im b]  x = [Re x;  Im x]
      K2: [[ Re,  Im], [Im, -Re]]   b = [Re b; Im b]  x = [Re x; -Im x]
      K3: [[ Im,  Re], [Re, -Im]]   b = [Im b; Re b]  x = [Re x;  Im x]
      K4: [[ Im, -Re], [Re,  Im]]   b = [Im b; Re b]  x = [Re x; -Im x]
    """
    if conversion_type not in (1, 2, 3, 4):
        raise MatrixIOError(
            f"complex_conversion={conversion_type}: expected 1..4"
        )
    import scipy.sparse as sps

    n = A_dict["n_rows"]
    C = sps.csr_matrix(
        (np.asarray(A_dict["vals"]),
         (np.asarray(A_dict["rows"]), np.asarray(A_dict["cols"]))),
        shape=(n, A_dict["n_cols"]),
    )
    Re, Im = C.real.tocsr(), C.imag.tocsr()
    blocks = {
        1: [[Re, -Im], [Im, Re]],
        2: [[Re, Im], [Im, -Re]],
        3: [[Im, Re], [Re, -Im]],
        4: [[Im, -Re], [Re, Im]],
    }[conversion_type]
    K = sps.bmat(blocks, format="coo")
    out = dict(
        rows=K.row.astype(np.int64),
        cols=K.col.astype(np.int64),
        vals=K.data,
        n_rows=2 * n,
        n_cols=2 * A_dict["n_cols"],
        block_dims=(1, 1),
    )
    b2 = x2 = None
    if rhs is not None:
        rhs = np.asarray(rhs)
        b2 = (
            np.concatenate([rhs.real, rhs.imag])
            if conversion_type in (1, 2)
            else np.concatenate([rhs.imag, rhs.real])
        )
    if sol is not None:
        sol = np.asarray(sol)
        x2 = (
            np.concatenate([sol.real, sol.imag])
            if conversion_type in (1, 3)
            else np.concatenate([sol.real, -sol.imag])
        )
    return out, b2, x2
