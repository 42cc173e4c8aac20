"""Solve one system through the port's C API (the reference benchmark
CLI ``examples/amgx_capi.c``; the JAX package's ``examples/amgx_capi.py``):

    python -m amgx_tpu_torch.examples.amgx_capi -m matrix.mtx \
        -c config.json [-mode dDDI]
    python -m amgx_tpu_torch.examples.amgx_capi -p NX NY NZ -c config.json

A ``d`` mode (the default ``dDDI``; ``dZZI``, ``dCCI``, ``dZCI`` and the
mixed modes too) solves on the card; an ``h`` mode on the CPU.  Prints
the setup and solve timings and the per-iteration residual table
(``print_solve_stats``).  Exits 0 when the solve succeeds, 1 when it
does not, and with the C API's return code where a call fails (3,
``RC_NOT_SUPPORTED_TARGET``, for a ``d`` mode without a card).
"""

import argparse
import sys

from amgx_tpu_torch.api import capi


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Solve a MatrixMarket or 7-point Poisson system "
        "through the C API of amgx_tpu_torch.")
    ap.add_argument("-m", "--matrix", help="MatrixMarket file")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-p", "--poisson", nargs=3, type=int, metavar="N",
                    help="generate NX NY NZ 7-pt Poisson instead of -m")
    ap.add_argument("-mode", default="dDDI")
    args = ap.parse_args(argv)
    if not args.matrix and not args.poisson:
        ap.error("need -m or -p")

    capi.initialize()
    try:
        cfg = capi.config_create_from_file(args.config)
        capi.config_add_parameters(
            cfg, "print_solve_stats=1, obtain_timings=1, monitor_residual=1"
        )
        res = capi.resources_create_simple(cfg)
        A = capi.matrix_create(res, args.mode)
        b = capi.vector_create(res, args.mode)
        x = capi.vector_create(res, args.mode)
        slv = capi.solver_create(res, args.mode, cfg)

        if args.poisson:
            nx, ny, nz = args.poisson
            capi.generate_distributed_poisson_7pt(A, b, x, nx, ny, nz)
        else:
            capi.read_system(A, b, x, args.matrix)
        n, bx, _ = capi.matrix_get_size(A)
        capi.vector_set_zero(x, n, bx)

        capi.solver_setup(slv, A)
        capi.solver_solve(slv, b, x)
        status = capi.solver_get_status(slv)
    except capi.AMGXError as e:
        print(f"amgx_capi: {e} (AMGX_RC {e.rc})", file=sys.stderr)
        return e.rc
    finally:
        capi.finalize()
    return 0 if status == capi.SOLVE_SUCCESS else 1


if __name__ == "__main__":
    raise SystemExit(main())
