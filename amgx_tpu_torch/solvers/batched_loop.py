"""The masked batched loop: a solver's iteration over a batch of B
systems of one structure, with per-instance convergence (the JAX
package's ``serve/batched.py`` loop, which ``vmap`` gives its nested
solvers as well).

One loop runs over the whole group.  Each step runs the solver's own
iteration on the batch (the iteration functions take (B, n) vectors and
(B, 1) scalars, ``solvers/krylov.py``), then commits its updates only
where an instance is still active, with ``torch.where`` on the (B, 1)
mask, so a converged instance freezes bit for bit at its own iterate
(and never takes 0 * NaN from a groupmate that broke down).  Its status,
iteration count and residual history come out per instance, the history
NaN past its freeze, as the sequential solves give them.

The loop reads the (B, ncomp) residual norms to the host once an
iteration, as the port's monitored loop does (``solvers/base.py``
``_monitored_loop``), and decides convergence there in the residual's
real dtype; the JAX package's device ``while_loop`` reads nothing until
the group's fetch (ROADMAP.md, queue C).  ``host_reads`` on the result
counts them.

The serve layer (``serve/batched.make_batched_solve``) runs a group's
rebuilt params through it; a batched solver that nests a monitored one
(ITERATIVE_REFINEMENT) runs its inner solves through it too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from amgx_tpu_torch.core import faults
from amgx_tpu_torch.core.types import host_dtype
from amgx_tpu_torch.ops.norms import get_norm
from amgx_tpu_torch.ops.spmv import spmv
from amgx_tpu_torch.solvers.base import (
    DIVERGED,
    FAILED,
    NOT_CONVERGED,
    SUCCESS,
)


@dataclasses.dataclass
class BatchedSolveResult:
    """A group's results: ``x`` (B, n) on the device, the rest host
    numpy per instance: ``iters`` and ``status`` (B,), ``final_norm``
    and ``initial_norm`` (B, ncomp), ``history`` (B, max_iters + 1,
    ncomp) NaN past each instance's freeze; ``host_reads`` the
    device-to-host reads the loop made."""

    x: torch.Tensor
    iters: np.ndarray
    status: np.ndarray
    final_norm: np.ndarray
    initial_norm: np.ndarray
    history: np.ndarray
    host_reads: int = 0


def _instance_protocol(solver):
    """The solver's iteration as (init, iterate, norm) over a batch:

      init(params, b, x0)          -> extra
      iterate(params, b, x, extra) -> (x, extra)
      norm(params, b, x, extra)    -> (B, ncomp) residual norms

    or None where the solver has no step protocol (GMRES and IDR run
    their own ``make_solve``)."""
    A, nt, scalar = solver.A, solver.norm_type, solver.use_scalar_norm

    def norm_of(r):
        return get_norm(A, r, nt, scalar).reshape(r.shape[0], -1)

    if hasattr(solver, "_make_init"):
        try:
            init_fn, iter_fn = solver._make_init(), solver._make_iter()
        except NotImplementedError:
            init_fn = None
        if init_fn is not None:
            return (init_fn, iter_fn,
                    lambda params, b, x, extra: norm_of(extra[0]))

    rstep = solver.make_residual_step()
    if rstep is not None:
        op = solver.operator_of

        def init_r(params, b, x0):
            return (b - spmv(op(params), x0),)

        def iter_r(params, b, x, extra):
            x = rstep(params, b, x, extra[0])
            return x, (b - spmv(op(params), x),)

        return (init_r, iter_r,
                lambda params, b, x, extra: norm_of(extra[0]))

    try:
        step = solver.make_step()
    except NotImplementedError:
        return None
    op = solver.operator_of

    def init_s(params, b, x0):
        return ()

    def iter_s(params, b, x, extra):
        return step(params, b, x), ()

    def norm_s(params, b, x, extra):
        return norm_of(b - spmv(op(params), x))

    return init_s, iter_s, norm_s


def _host(t) -> np.ndarray:
    """A (B, ncomp) norm tensor on the host (bf16 as float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def make_masked_loop(solver):
    """``fn(params, b_B, x0_B) -> BatchedSolveResult``: the solver's
    iteration over a batch whose params are already batched (a
    rebuild's output), each instance stopping at its own convergence;
    None where the solver has no iteration protocol.  A monitored
    solver nested in a batched one (ITERATIVE_REFINEMENT's inner
    solver) runs its solves through it."""
    proto = _instance_protocol(solver)
    if proto is None:
        return None
    init_one, iter_one, norm_one = proto
    conv = solver._conv_check
    max_iters = solver.max_iters
    rel_div = solver.rel_div_tolerance
    ncomp = solver.norm_components
    monitored = solver.monitor_residual

    def result_dtype(b):
        return host_dtype(b.real.dtype)

    def solve_plain(params, b_B, x0_B):
        """Unmonitored: max_iters sweeps for every instance."""
        x, extra = x0_B, init_one(params, b_B, x0_B)
        region = faults.loop()
        for _ in range(max_iters):
            with region:
                x, extra = iter_one(params, b_B, x, extra)
        B, rdt = b_B.shape[0], result_dtype(b_B)
        zero = np.zeros((B, ncomp), rdt)
        return BatchedSolveResult(
            x=x, iters=np.full((B,), max_iters, np.int32),
            status=np.full((B,), SUCCESS, np.int32),
            final_norm=zero, initial_norm=zero.copy(),
            history=np.full((B, max_iters + 1, ncomp), np.nan, rdt))

    if not monitored:
        return solve_plain

    def status_of(nrm, ini, mx):
        """Per-instance status after an iteration (host numpy)."""
        st = np.array([SUCCESS if conv(nrm[i], ini[i], mx[i])
                       else NOT_CONVERGED for i in range(nrm.shape[0])],
                      np.int32)
        if rel_div > 0:
            st[np.any(nrm > rel_div * ini, axis=-1)] = DIVERGED
        st[~np.all(np.isfinite(nrm), axis=-1)] = FAILED
        return st

    def commit(mask, new, old):
        """``new`` where the instance is active, else ``old``: the (B,
        1) mask spread over the trailing dimensions (an s-step block is
        (B, s, n))."""
        if not isinstance(new, torch.Tensor):
            return new
        return torch.where(
            mask.reshape(mask.shape[:1] + (1,) * (new.dim() - 1)), new, old)

    def solve(params, b_B, x0_B):
        B, rdt = b_B.shape[0], result_dtype(b_B)
        extra = init_one(params, b_B, x0_B)
        ini = _host(norm_one(params, b_B, x0_B, extra)).astype(rdt)
        reads = 1
        hist = np.full((B, max_iters + 1, ncomp), np.nan, rdt)
        hist[:, 0] = ini
        status = np.array([SUCCESS if conv(ini[i], ini[i], ini[i])
                           else NOT_CONVERGED for i in range(B)], np.int32)
        iters = np.zeros((B,), np.int32)
        nrm, mx, x = ini.copy(), ini.copy(), x0_B
        it = 0
        region = faults.loop()
        while it < max_iters and np.any(status == NOT_CONVERGED):
            active = status == NOT_CONVERGED
            mask = torch.from_numpy(active).to(x.device).reshape(B, 1)
            with region:
                x_n, extra_n = iter_one(params, b_B, x, extra)
                nrm_n = _host(norm_one(params, b_B, x_n,
                                       extra_n)).astype(rdt)
            reads += 1
            it += 1
            # commit only where active: torch.where, so a frozen
            # instance keeps its bits whatever its groupmates hold
            x = commit(mask, x_n, x)
            extra = tuple(commit(mask, e_n, e)
                          for e_n, e in zip(extra_n, extra))
            mx_n = np.maximum(mx, nrm_n)
            hist[active, it] = nrm_n[active]
            st_n = status_of(nrm_n, ini, mx_n)
            nrm[active] = nrm_n[active]
            mx[active] = mx_n[active]
            iters[active] = it
            status[active] = st_n[active]
        return BatchedSolveResult(
            x=x, iters=iters, status=status, final_norm=nrm,
            initial_norm=ini, history=hist, host_reads=reads)

    return solve
