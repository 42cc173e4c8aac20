"""Versioned setup-artifact schema: a set-up solver as one ``.npz``
payload with a JSON manifest, in the JAX package's format
(``amgx_tpu/store/serialize.py``, schema version 1), so that a payload
written by either package restores in the other without running setup.

What is written is the setup: every :class:`SparseMatrix` of the
solver tree (the CSR triple, the first-occurrence source maps and the
formats' static description: DIA offsets, the MATRIX_FREE stencil,
ELL's column array), the AMG level chain with P, R and the Galerkin
plans, the smoothers' and the coarse solver's exportable state
(Chebyshev bounds, DENSE_LU factors) and the solve boundary's scale and
reorder vectors.  The value layouts (``diag``, the DIA planes, the ELL
values, the stencil coefficients, the dense block) are not written:
they are gathered from the CSR values through their source maps at
restore, as the JAX package does, here on the device.

Differences of form, converted at the payload boundary:

  * ELL: the payload holds the JAX package's row-major ``(n_rows, w)``
    ``ell_cols`` and ``ell_src``; this package's arrays are slot-major,
    and its sliced layout (``sell``) is rebuilt from the CSR structure
    at restore.  The port writes the window and lanes it chose as an
    optional ``"sell"`` key of the matrix's static record (the JAX
    package ignores it); a payload without it gets the layout an upload
    of the same matrix would (lanes 1 in bf16, as ``astype`` gives).
    The TPU-only windowed-ELL fields (``ell_wcols``, ``ell_wvals``,
    ``ell_wbase``) are written as None and ignored when read.
  * Galerkin plans: written with the JAX package's per-pair ``out_idx``
    (``SpMMPlan.out_idx``), read back into run offsets.
  * DENSE_LU pivots are 0-based in the payload (``solvers/dense_lu.py``).
  * bf16: numpy has no bf16 without ``ml_dtypes``; its bits are written
    as uint16 with ``"dt": "bfloat16"`` on the array's node, as the JAX
    package writes them, and read back through ``view(torch.bfloat16)``.

Every array a restore rebuilds is on the solver's device; DIA and
stencil launch plans derive from the restored shapes, so a restored
operator takes the kernels a set-up one does.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from amgx_tpu_torch.core.errors import RC_BAD_MODE, StoreError

SCHEMA_VERSION = 1

# SparseMatrix array fields of the payload (the JAX package's names)
_SMAT_ARRAY_FIELDS = (
    "row_offsets", "col_indices", "values", "row_ids", "diag",
    "ell_cols", "ell_vals", "ell_wcols", "ell_wvals", "ell_wbase",
    "dia_vals", "dense", "diag_src", "dia_src", "ell_src",
    "mf_coefs", "mf_src",
)
_REBUILT = ("row_ids_rebuild", "gather_rebuild", "dense_from_csr")


# ---------------------------------------------------------------------------
# tagged-tree flatten / unflatten


def flatten(tree):
    """``(spec, arrays)`` of a setup-state tree: ``spec`` a JSON-able
    tag tree, ``arrays`` generated keys -> tensors or numpy arrays (not
    copied; :func:`materialize` reads them to the host).  Takes None,
    Python scalars and strings, tuples, lists, str-keyed dicts,
    tensors, numpy arrays, SparseMatrix, SpMMPlan and RAPPlan; anything
    else raises :class:`StoreError`.  Objects met twice (a PCG's
    operator is its AMG's finest one; matrices of one structure share
    index tensors) are written once and referenced."""
    from amgx_tpu_torch.amg.spgemm import RAPPlan, SpMMPlan
    from amgx_tpu_torch.core.matrix import SparseMatrix

    arrays: dict = {}
    seen: dict = {}
    keepalive: list = []

    def defined(obj, make):
        ref = seen.get(id(obj))
        if ref is not None:
            return {"t": "ref", "i": ref}
        idx = len(seen)
        seen[id(obj)] = idx
        keepalive.append(obj)
        return {"t": "def", "i": idx, "n": make()}

    def arr(obj):
        def make():
            key = f"a{len(arrays)}"
            arrays[key] = obj
            node = {"t": "arr", "k": key,
                    "host": isinstance(obj, np.ndarray)}
            if isinstance(obj, torch.Tensor) and obj.dtype == torch.bfloat16:
                node["dt"] = "bfloat16"
            return node

        return defined(obj, make)

    def rec(obj):
        if obj is None:
            return {"t": "none"}
        if isinstance(obj, (bool, str)):
            return {"t": "py", "v": obj}
        if isinstance(obj, (int, np.integer)):
            return {"t": "py", "v": int(obj)}
        if isinstance(obj, (float, np.floating)):
            return {"t": "py", "v": float(obj)}
        if isinstance(obj, (torch.Tensor, np.ndarray)):
            return arr(obj)
        if isinstance(obj, SparseMatrix):
            return defined(obj, lambda: _smat_spec(obj, rec))
        if isinstance(obj, RAPPlan):
            return defined(obj, lambda: {
                "t": "rap", "ap": rec(obj.ap), "rap": rec(obj.rap)})
        if isinstance(obj, SpMMPlan):
            return defined(obj, lambda: {
                "t": "spmm", "left": rec(obj.left_idx),
                "right": rec(obj.right_idx), "out": rec(obj.out_idx()),
                "nnz_out": int(obj.nnz_out)})
        if isinstance(obj, (tuple, list)):
            return {
                "t": "tuple" if isinstance(obj, tuple) else "list",
                "items": [rec(v) for v in obj],
            }
        if isinstance(obj, dict):
            if not all(isinstance(k, str) for k in obj):
                raise StoreError(
                    "setup state dict has non-string keys; not persistable"
                )
            return {"t": "dict",
                    "items": {k: rec(v) for k, v in obj.items()}}
        raise StoreError(f"non-serializable setup leaf: {type(obj).__name__}")

    return rec(tree), arrays


def _smat_spec(A, rec):
    """A matrix's spec node: the CSR triple and source maps written, the
    value layouts rebuilt from them at restore (the JAX package's
    ``_smat_spec``)."""
    gather = lambda src: {"t": "gather_rebuild", "src": src}  # noqa: E731
    fields = dict.fromkeys(_SMAT_ARRAY_FIELDS)
    fields.update(
        row_offsets=rec(A.row_offsets), col_indices=rec(A.col_indices),
        values=rec(A.values), row_ids={"t": "row_ids_rebuild"},
        diag_src=rec(A.diag_src), diag=gather("diag_src"),
    )
    if A.has_dia:
        fields.update(dia_src=rec(A.dia_src), dia_vals=gather("dia_src"))
    if A.has_ell:
        # the JAX package's row-major (n_rows, w) layout
        fields.update(ell_cols=rec(A.ell_cols.T.contiguous()),
                      ell_src=rec(A.ell_src.T.contiguous()),
                      ell_vals=gather("ell_src"))
    if A.has_dense:
        fields["dense"] = {"t": "dense_from_csr"}
    if A.has_matrix_free:
        fields.update(mf_src=rec(A.mf_src), mf_coefs=gather("mf_src"))
    static = {
        "n_rows": int(A.n_rows), "n_cols": int(A.n_cols),
        "block_size": int(A.block_size),
        "dia_offsets": (None if A.dia_offsets is None
                        else [int(o) for o in A.dia_offsets]),
        "ell_wwidth": None, "views": None,
    }
    if A.mf_meta is not None:
        m = A.mf_meta
        static["mf_meta"] = {
            "kind": m.kind, "grid": [int(v) for v in m.grid],
            "steps": [[int(d) for d in s] for s in m.steps],
            "offsets": [int(o) for o in m.offsets],
            "axis": None if m.axis is None else int(m.axis),
        }
    if A.has_ell and A.block_size == 1:
        # the sliced layout's plan (this package's key)
        static["sell"] = (None if A.sell is None else
                          {"sigma": int(A.sell.sigma),
                           "lanes": int(A.sell.lanes)})
    return {"t": "smat", "fields": fields, "static": static,
            "fp": getattr(A, "_fingerprint_cache", None)}


class _Restore:
    """One restore: the spec's def nodes indexed, each array uploaded
    once to ``device`` (by key), objects rebuilt in spec order."""

    def __init__(self, spec, arrays, device):
        self.arrays = arrays
        self.device = device
        self.def_nodes: dict = {}
        self.defs: dict = {}
        self.uploaded: dict = {}
        self._index(spec)

    def _index(self, sp):
        if isinstance(sp, dict):
            if sp.get("t") == "def":
                self.def_nodes[int(sp["i"])] = sp.get("n")
                self._index(sp.get("n"))
            else:
                for v in sp.values():
                    self._index(v)
        elif isinstance(sp, (list, tuple)):
            for v in sp:
                self._index(v)

    # -- arrays ----------------------------------------------------------

    def host(self, node):
        """The numpy array of an "arr" node (bf16: its uint16 bits)."""
        try:
            a = np.asarray(self.arrays[node.get("k")])
        except KeyError:
            raise StoreError(
                f"payload is missing array {node.get('k')!r}") from None
        dt = node.get("dt")
        if dt not in (None, "bfloat16"):
            raise StoreError(f"payload array dtype tag {dt!r} is unknown")
        if dt and a.dtype.itemsize != 2:
            raise StoreError(
                f"payload array {node.get('k')!r} does not reinterpret as "
                f"{dt!r}")
        return a

    def upload(self, node):
        key = node.get("k")
        t = self.uploaded.get(key)
        if t is None:
            a = self.host(node)
            try:
                if node.get("dt") == "bfloat16":
                    t = torch.from_numpy(
                        np.ascontiguousarray(a).view(np.int16).copy()
                    ).to(self.device).view(torch.bfloat16)
                else:
                    from amgx_tpu_torch.core.matrix import to_tensor

                    t = to_tensor(a, self.device)
            except (TypeError, ValueError, NotImplementedError) as e:
                raise StoreError(
                    f"payload array {key!r} cannot be restored: {e}"
                ) from e
            self.uploaded[key] = t
        return t

    def arr_node(self, sp, what):
        """The "arr" node behind a field spec (through def / ref)."""
        for _ in range(2):
            if isinstance(sp, dict) and sp.get("t") == "def":
                sp = sp.get("n")
            elif isinstance(sp, dict) and sp.get("t") == "ref":
                sp = self.def_nodes.get(int(sp["i"]))
        if not isinstance(sp, dict) or sp.get("t") != "arr":
            raise StoreError(f"payload lacks the array {what!r}")
        return sp

    # -- the tree --------------------------------------------------------

    def rec(self, sp):
        try:
            t = sp["t"]
        except (TypeError, KeyError):
            raise StoreError(
                f"malformed payload spec node: {sp!r}") from None
        if t == "none":
            return None
        if t == "py":
            return sp["v"]
        if t == "def":
            val = self.rec(sp["n"])
            self.defs[int(sp["i"])] = val
            return val
        if t == "ref":
            i = int(sp["i"])
            if i in self.defs:
                return self.defs[i]
            node = self.def_nodes.get(i)
            if isinstance(node, dict) and node.get("t") == "arr":
                return self.rec(node)
            raise StoreError(
                f"payload spec ref {i} precedes its definition")
        if t == "arr":
            if sp.get("host"):
                a = self.host(sp)
                if sp.get("dt"):
                    return self.upload(sp).cpu()
                return np.array(a)
            return self.upload(sp)
        if t == "tuple":
            return tuple(self.rec(v) for v in sp["items"])
        if t == "list":
            return [self.rec(v) for v in sp["items"]]
        if t == "dict":
            return {k: self.rec(v) for k, v in sp["items"].items()}
        if t == "spmm":
            from amgx_tpu_torch.amg.spgemm import SpMMPlan

            return SpMMPlan.from_out_idx(
                self._on_device(self.rec(sp["left"])),
                self._on_device(self.rec(sp["right"])),
                self._on_device(self.rec(sp["out"])), int(sp["nnz_out"]))
        if t == "rap":
            from amgx_tpu_torch.amg.spgemm import RAPPlan

            return RAPPlan(ap=self.rec(sp["ap"]), rap=self.rec(sp["rap"]))
        if t == "smat":
            return self.smat(sp)
        raise StoreError(f"unknown payload spec tag {t!r}")

    def _on_device(self, a):
        if isinstance(a, np.ndarray):
            from amgx_tpu_torch.core.matrix import to_tensor

            return to_tensor(a, self.device)
        return a

    def smat(self, sp):
        from amgx_tpu_torch.core.matrix import (
            SparseMatrix,
            _gather_src,
            sliced_ell,
        )

        st = sp["static"]
        fields = sp["fields"]
        n, n_cols, b = int(st["n_rows"]), int(st["n_cols"]), \
            int(st["block_size"])

        def verbatim(name):
            fsp = fields.get(name)
            if fsp is None:
                return None
            if fsp.get("t") in _REBUILT:
                raise StoreError(f"payload rebuilds {name!r} from itself")
            return self._on_device(self.rec(fsp))

        ro_t, ci_t, vals = (verbatim(k) for k in
                            ("row_offsets", "col_indices", "values"))
        if ro_t is None or ci_t is None or vals is None:
            raise StoreError("payload matrix lacks its CSR triple")
        ro = np.array(self.host(self.arr_node(fields["row_offsets"],
                                              "row_offsets")))
        ci = np.array(self.host(self.arr_node(fields["col_indices"],
                                              "col_indices")))
        vnode = self.arr_node(fields["values"], "values")
        vals_np = None if vnode.get("dt") else np.array(self.host(vnode))
        row_ids = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=self.device),
            ro_t[1:].long() - ro_t[:-1].long())
        srcs = {}

        def layout(name):
            """A value layout: gathered through its source map, or
            written verbatim (a payload without the map)."""
            fsp = fields.get(name)
            if fsp is None:
                return None
            kind = fsp.get("t")
            if kind == "gather_rebuild":
                src = verbatim(fsp.get("src"))
                if src is None:
                    raise StoreError(f"payload lacks {fsp.get('src')!r}")
                if name == "ell_vals":
                    src = src.T.contiguous()
                srcs[name] = src
                return _gather_src(src, vals)
            if kind == "dense_from_csr":
                return torch.zeros((n, n_cols), dtype=vals.dtype,
                                   device=self.device).index_put_(
                    (row_ids.long(), ci_t.long()), vals, accumulate=True)
            if kind == "row_ids_rebuild":
                return row_ids
            out = verbatim(name)
            if name == "ell_vals":
                out = out.transpose(0, 1).contiguous()
            return out

        diag = layout("diag")
        dia_vals = layout("dia_vals")
        dense = layout("dense")
        ell_vals = layout("ell_vals")
        mf_coefs = layout("mf_coefs")
        ell_cols = None
        if fields.get("ell_cols") is not None:
            node = self.arr_node(fields["ell_cols"], "ell_cols")
            ell_cols = self._on_device(
                np.ascontiguousarray(self.host(node).T))
        dia_offsets = st.get("dia_offsets")
        if dia_offsets is not None:
            dia_offsets = tuple(int(o) for o in dia_offsets)
        mf_meta = _stencil_meta(st.get("mf_meta"))
        sell = sell_src = None
        if ell_cols is not None and b == 1:
            built = _sell_layout(ro, ci, n, int(ell_cols.shape[0]),
                                 vals.dtype, st.get("sell", "absent"))
            if built is not None:
                host, lanes = built
                sell_src = self._on_device(host["vals"] - 1).to(torch.int32)
                host["vals"] = np.zeros(0, np.float32)
                sell = dataclasses.replace(
                    sliced_ell(host, self.device),
                    vals=_gather_src(sell_src, vals), lanes=lanes)
        A = SparseMatrix(
            row_offsets=ro_t, col_indices=ci_t, values=vals,
            row_ids=row_ids, diag=diag, n_rows=n, n_cols=n_cols,
            dia_offsets=dia_offsets,
            dia_offsets_dev=(None if dia_offsets is None else torch.tensor(
                dia_offsets, dtype=torch.int32, device=self.device)),
            dia_vals=dia_vals, mf_meta=mf_meta, mf_coefs=mf_coefs,
            dense=dense, ell_cols=ell_cols, ell_vals=ell_vals, sell=sell,
            mf_src=verbatim("mf_src"), block_size=b,
            _host_csr=(ro, ci, vals_np),
        )
        # the source maps come with the payload: replace_values and a
        # later save need not derive them
        if "diag" in srcs and (dia_vals is None or "dia_vals" in srcs) \
                and (ell_vals is None or "ell_vals" in srcs):
            maps = {"diag": srcs["diag"]}
            if dia_vals is not None:
                maps["dia"] = srcs["dia_vals"]
            if ell_vals is not None:
                maps["ell"] = srcs["ell_vals"]
                if sell is not None:
                    maps["sell"] = sell_src
            A._src = maps
        if sp.get("fp"):
            A._fingerprint_cache = str(sp["fp"])
        return A


def _stencil_meta(mm):
    if mm is None:
        return None
    from amgx_tpu_torch.ops.stencil import StencilMeta

    try:
        return StencilMeta(
            kind=str(mm["kind"]),
            grid=tuple(int(v) for v in mm["grid"]),
            steps=tuple(tuple(int(d) for d in s) for s in mm["steps"]),
            offsets=tuple(int(o) for o in mm["offsets"]),
            axis=None if mm.get("axis") is None else int(mm["axis"]),
        )
    except (TypeError, ValueError, KeyError) as e:
        raise StoreError(f"malformed mf_meta in payload spec: {e}") from e


def _sell_layout(ro, ci, n, w, dtype, hint):
    """``(host arrays, lanes)`` of the sliced ELL layout of a restored
    ELL matrix, its ``vals`` holding each slot's CSR index + 1 (0 for
    padding), or None for no sliced layout.  ``hint`` is the payload's
    ``{"sigma", "lanes"}`` (None: the set-up matrix had none); a
    payload without one ("absent") gets the layout an upload would
    choose, planned for the values' bytes (4 for bf16, whose layouts
    come from an f32 upload), with one lane a row in bf16."""
    from amgx_tpu_torch.core.matrix import (
        _build_sell_np,
        sell_lanes,
        sell_plan_np,
    )

    if hint is None:
        return None
    bf16 = dtype == torch.bfloat16
    if isinstance(hint, dict):
        sigma, lanes = int(hint["sigma"]), int(hint["lanes"])
    else:
        itemsize = 4 if bf16 else torch.empty((), dtype=dtype).element_size()
        plan = sell_plan_np(np.diff(ro).astype(np.int64), itemsize,
                            n * w * (4 + itemsize))
        if plan is None:
            return None
        sigma, lanes = plan[1], (1 if bf16 else sell_lanes(plan[3]))
    host = _build_sell_np(ro, ci, np.arange(1, ci.shape[0] + 1,
                                            dtype=np.int64),
                          n, w, sigmas=(sigma,), always=True)
    return host, lanes


def unflatten(spec, arrays, device):
    """Inverse of :func:`flatten` (for a payload of either package):
    the object tree with every device array on ``device``.  A malformed
    spec raises :class:`StoreError`."""
    try:
        r = _Restore(spec, arrays, device)
        return r.rec(spec)
    except StoreError:
        raise
    except Exception as e:  # noqa: BLE001 — a payload defect, typed
        raise StoreError(f"malformed payload spec: {e}") from e


def materialize(arrays: dict) -> dict:
    """Every array read to the host as numpy (the one sync of a save);
    bf16 as its uint16 bits (its node carries ``"dt"``)."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.dtype == torch.bfloat16:
                a = v.view(torch.int16).cpu().numpy().view(np.uint16)
            else:
                a = v.cpu().numpy()
        else:
            a = np.asarray(v)
        out[k] = np.ascontiguousarray(a)
    return out


# ---------------------------------------------------------------------------
# payload files (copies of the JAX package's)


def write_payload(path, arrays: dict, manifest: dict):
    """One ``.npz`` with the manifest as ``__manifest__``, written
    through a file object so that numpy appends no suffix."""
    blob = payload_bytes(arrays, manifest)
    with open(path, "wb") as f:
        f.write(blob)


def payload_bytes(arrays: dict, manifest: dict) -> bytes:
    import io

    buf = io.BytesIO()
    np.savez(buf, __manifest__=np.array(json.dumps(manifest)),
             **materialize(arrays))
    return buf.getvalue()


def _fast_npz_arrays(blob: bytes) -> dict:
    """Zero-copy npz decode: the members are stored uncompressed, so
    each array's bytes lie contiguously in the blob; they are located
    through the zip directory and read with ``np.frombuffer``.  Any
    anomaly raises and the caller falls back to ``np.load`` (the
    store's digest already vouches for the bytes)."""
    import io
    import struct
    import zipfile

    out = {}
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError("compressed npz member")
            ho = info.header_offset
            if blob[ho:ho + 4] != b"PK\x03\x04":
                raise ValueError("bad local header")
            nlen, elen = struct.unpack_from("<HH", blob, ho + 26)
            start = ho + 30 + nlen + elen
            f = io.BytesIO(blob[start:start + min(4096, info.file_size)])
            version = np.lib.format.read_magic(f)
            np.lib.format._check_version(version)
            shape, fortran, dtype = np.lib.format._read_array_header(
                f, version)
            if dtype.hasobject:
                raise ValueError("object array in payload")
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            a = np.frombuffer(blob, dtype=dtype, count=count,
                              offset=start + f.tell())
            a = a.reshape(shape, order="F" if fortran else "C")
            name = info.filename
            if name.endswith(".npy"):
                name = name[:-len(".npy")]
            out[name] = a
    return out


def read_payload(path_or_bytes):
    """``(arrays, manifest)`` from a payload file or its bytes; anything
    unreadable raises :class:`StoreError` (a miss to the store)."""
    import io

    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        try:
            with open(path_or_bytes, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise StoreError(f"unreadable setup payload: {e}") from e
    try:
        arrays = _fast_npz_arrays(blob)
    except Exception:  # noqa: BLE001 — the slow reader decides
        try:
            with np.load(io.BytesIO(blob), allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as e:
            raise StoreError(f"unreadable setup payload: {e}") from e
    m = arrays.pop("__manifest__", None)
    if m is None:
        raise StoreError("setup payload lacks a manifest")
    try:
        manifest = json.loads(str(m[()]))
    except Exception as e:
        raise StoreError(f"corrupt payload manifest: {e}") from e
    if not isinstance(manifest, dict):
        raise StoreError("corrupt payload manifest: not an object")
    return arrays, manifest


def check_schema(manifest: dict):
    v = manifest.get("schema_version")
    if v != SCHEMA_VERSION:
        raise StoreError(
            f"setup payload schema_version {v!r} != {SCHEMA_VERSION} "
            "(stale or future schema)")


# ---------------------------------------------------------------------------
# solver-level save / load


def solver_meta(solver) -> dict:
    """The manifest's identity half: the solver's class, scope and
    configuration, and the store key (fingerprint, config hash,
    dtype, schema version)."""
    if solver.A is None:
        raise StoreError("save_setup before setup()")
    fp, dtype_s = solver.A.setup_key()
    return {
        "schema_version": SCHEMA_VERSION,
        "kind": "solver_setup",
        "solver": solver.registry_name,
        "scope": solver.scope,
        # the solve boundary's flags (make_nested clears them on nested
        # solvers; a restore keeps that)
        "scaling": solver.scaling,
        "reordering": solver.reordering,
        "config": solver.cfg.to_state(),
        "config_hash": solver.cfg.content_hash(),
        "fingerprint": fp,
        "dtype": dtype_s,
        "n_rows": int(solver.A.n_rows),
        "nnz": int(solver.A.nnz),
        "block_size": int(solver.A.block_size),
        "created_unix": time.time(),
    }


def build_solver(manifest: dict, tree, cfg=None, device="cuda"):
    """The solver of ``manifest`` on ``device``, restored from the
    unflattened ``tree`` without setup.  ``cfg`` None takes the
    manifest's configuration; a given one must hash as the manifest's
    (a hierarchy of another configuration would solve differently)."""
    import amgx_tpu_torch.solvers  # noqa: F401  (registration)
    from amgx_tpu_torch.config.amg_config import AMGConfig
    from amgx_tpu_torch.solvers.registry import SolverRegistry

    if cfg is None:
        try:
            cfg = AMGConfig.from_state(manifest["config"])
        except Exception as e:  # noqa: BLE001 — a payload defect, typed
            raise StoreError(
                f"corrupt payload manifest: bad config state ({e})") from e
    elif cfg.content_hash() != manifest.get("config_hash"):
        raise StoreError(
            "setup payload was built under a different solver "
            "configuration (config_hash mismatch)")
    try:
        cls = SolverRegistry.get(str(manifest["solver"]))
    except KeyError as e:
        raise StoreError(str(e)) from None
    solver = cls(cfg, str(manifest.get("scope", "default")), device=device)
    solver.scaling = str(manifest.get("scaling", solver.scaling))
    solver.reordering = str(manifest.get("reordering", solver.reordering))
    t0 = time.perf_counter()
    solver._import_setup(tree)
    A = solver.A
    if A is not None and getattr(A, "_fingerprint_cache", None) is None \
            and manifest.get("fingerprint"):
        A._fingerprint_cache = str(manifest["fingerprint"])
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
    solver.restore_time = time.perf_counter() - t0
    return solver


def save_setup(solver, path) -> dict:
    """Write a set-up solver to ``path``; returns the manifest.  The
    manifest is made first, so that the finest operator's fingerprint
    is memoized and written with it."""
    manifest = solver_meta(solver)
    spec, arrays = flatten(solver._export_setup())
    manifest["spec"] = spec
    write_payload(path, arrays, manifest)
    return manifest


def load_setup(path, cfg=None, expect_dtype=None, device="cuda"):
    """A solver restored on ``device`` from a payload of either package,
    without setup.  A corrupt payload or a schema, configuration or
    kind mismatch raises :class:`StoreError`; ``expect_dtype`` (a numpy
    dtype or name) refuses a payload of another operator dtype before
    anything reaches the device, with ``RC_BAD_MODE``."""
    from amgx_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    arrays, manifest = read_payload(path)
    check_schema(manifest)
    if manifest.get("kind") != "solver_setup":
        raise StoreError(
            f"payload kind {manifest.get('kind')!r} is not a solver setup")
    if expect_dtype is not None:
        want = str(expect_dtype) if str(expect_dtype) == "bfloat16" \
            else str(np.dtype(expect_dtype))
        got = str(manifest.get("dtype"))
        if got != want:
            raise StoreError(
                f"persisted setup is {got}, caller expects {want}",
                rc=RC_BAD_MODE)
    tree = unflatten(manifest.get("spec"), arrays, device)
    return build_solver(manifest, tree, cfg=cfg, device=device)
