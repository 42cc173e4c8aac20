"""Matrix format converter (the reference ``examples/convert.c``; the
JAX package's ``examples/convert.py``): MatrixMarket (.mtx) to
``%%NVAMGBinary`` or back, keyed on the output file's extension
(``.bin`` or ``.amgx``: binary; anything else: MatrixMarket text):

    python -m amgx_tpu_torch.examples.convert in.mtx out.bin
    python -m amgx_tpu_torch.examples.convert in.bin out.mtx

A right-hand side and a solution in the input file are written too.
The conversion runs on the host (CPU tensors).
"""

import sys


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) != 3:
        print(__doc__)
        return 2
    src, dst = argv[1], argv[2]
    from amgx_tpu_torch.core.matrix import SparseMatrix
    from amgx_tpu_torch.io.matrix_market import (
        read_system,
        write_system,
        write_system_binary,
    )

    Ad, rhs, sol = read_system(src)
    bx, by = Ad["block_dims"]
    if bx != by:
        raise SystemExit(f"rectangular blocks {bx}x{by} unsupported")
    A = SparseMatrix.from_coo(
        Ad["rows"], Ad["cols"], Ad["vals"],
        n_rows=Ad["n_rows"], n_cols=Ad["n_cols"], block_size=bx,
        accel_formats=(), device="cpu",
    )
    if dst.endswith((".bin", ".amgx")):
        write_system_binary(dst, A, rhs, sol)
    else:
        write_system(dst, A, rhs, sol)
    print(
        f"{src} -> {dst}: {A.n_rows}x{A.n_cols}, nnz={A.nnz},"
        f" block_size={A.block_size},"
        f" rhs={'yes' if rhs is not None else 'no'},"
        f" sol={'yes' if sol is not None else 'no'}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
