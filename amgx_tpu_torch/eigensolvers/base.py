"""EigenSolver contract (reference eigensolver.h:25-150; the JAX
package's ``eigensolvers/base.py``): configured by the ``eig_*``
parameters, ``setup(A)`` then ``solve()`` returning eigenpairs.

``eigenvalues`` are numpy, as in the JAX package; ``eigenvectors`` is
an (n, k) tensor on the solver's device, like ``SolveResult.x``.  The
solver runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from amgx_tpu_torch.core.device import resolve_device
from amgx_tpu_torch.core.matrix import to_tensor
from amgx_tpu_torch.core.types import host_dtype


@dataclasses.dataclass
class EigenResult:
    eigenvalues: np.ndarray  # (k,)
    eigenvectors: Optional[torch.Tensor]  # (n, k) on the device, or None
    iterations: int
    converged: bool
    residual: float
    # per-vector convergence of the eigenvector post-pass: (k,) bool, or
    # None when the algorithm produced the vectors itself
    vector_converged: Optional[np.ndarray] = None


_EIGENSOLVERS: Dict[str, type] = {}


class EigenSolverRegistry:
    @staticmethod
    def register(name, cls):
        _EIGENSOLVERS[name] = cls

    @staticmethod
    def get(name):
        try:
            return _EIGENSOLVERS[name]
        except KeyError:
            raise KeyError(
                f"unregistered eigensolver {name!r}; known: "
                f"{sorted(_EIGENSOLVERS)}"
            ) from None


def register_eigensolver(*names):
    def deco(cls):
        for n in names:
            EigenSolverRegistry.register(n, cls)
        cls.registry_name = names[0]
        return cls

    return deco


def host_vector(n, dtype, seed):
    """The JAX package's start vector: ``default_rng(seed)`` normal
    draws in ``dtype`` (numpy), normalized."""
    v = np.random.default_rng(seed).standard_normal(n).astype(dtype)
    return v / np.linalg.norm(v)


class EigenSolver:
    """Base: reads the ``eig_*`` parameter family."""

    registry_name = "?"

    def __init__(self, cfg, scope: str = "default", device="cuda"):
        self.cfg = cfg
        self.scope = scope
        self.device = resolve_device(device)
        g = lambda k: cfg.get(k, scope)
        self.max_iters = int(g("eig_max_iters"))
        self.tolerance = float(g("eig_tolerance"))
        self.shift = float(g("eig_shift"))
        self.which = str(g("eig_which")).lower()
        self.wanted_count = int(g("eig_wanted_count"))
        self.subspace_size = int(g("eig_subspace_size"))
        self.damping = float(g("eig_damping_factor"))
        self.want_vectors = bool(g("eig_eigenvector"))
        self.A = None
        self.requested_name = type(self).registry_name

    def setup(self, A):
        if A.device != self.device:
            raise ValueError(
                f"{self.registry_name}: matrix on {A.device}, eigensolver "
                f"on {self.device}"
            )
        self.A = A
        self._setup_impl(A)
        return self

    def _setup_impl(self, A):
        pass

    def _np_dtype(self):
        """The operator's host dtype (numpy draws are made in it)."""
        return host_dtype(self.A.dtype)

    def _to_dev(self, a):
        return to_tensor(np.asarray(a), self.device)

    def _krylov_dim(self) -> int:
        """Krylov dimension of single-shot Lanczos / Arnoldi: the
        explicit ``eig_subspace_size`` when configured, else the
        iteration budget."""
        if self.cfg.has("eig_subspace_size", self.scope):
            return max(self.subspace_size, 2 * self.wanted_count + 2)
        return max(self.max_iters, 2 * self.wanted_count + 2)

    def solve(self, x0=None) -> EigenResult:
        """Run the algorithm, then the optional eigenvector post-pass
        (reference eigensolver.cu solve + eigenvector_solver)."""
        return self._maybe_extract_vectors(self._solve_impl(x0))

    def _solve_impl(self, x0=None) -> EigenResult:
        raise NotImplementedError

    # inverse-iteration post-pass bounds: iterate to the residual
    # tolerance, at most this many steps per vector
    _VECTOR_MAX_STEPS = 32

    def _maybe_extract_vectors(self, res: EigenResult) -> EigenResult:
        """Post-pass eigenvector extraction (reference
        eigensolver.cu:271-276 + eigenvector_solver.cu; the JAX
        package's ``_maybe_extract_vectors``): when
        ``eig_eigenvector_solver`` names a solver and the algorithm did
        not produce vectors, shift-inverted inverse iteration per
        eigenvalue, to ``||A v - rho v|| <= eig_tolerance * ||A||`` (rho
        the vector's Rayleigh quotient, ``||A||`` the largest absolute
        row sum) or ``_VECTOR_MAX_STEPS`` steps, with a complex shift
        for a complex operator.  The shifted matrices are formed on the
        host with scipy; the inner solves, the products and the
        residuals run on the solver's device (one read a step)."""
        name = str(self.cfg.get("eig_eigenvector_solver", self.scope))
        if (not self.want_vectors or res.eigenvectors is not None
                or not name or not res.eigenvalues.size):
            return res
        import scipy.sparse as sps

        from amgx_tpu_torch.core.matrix import SparseMatrix
        from amgx_tpu_torch.ops.spmv import spmv
        from amgx_tpu_torch.solvers.registry import (
            SolverRegistry,
            make_nested,
        )

        sp = self.A.to_scipy().tocsr()
        n = sp.shape[0]
        is_complex = np.issubdtype(sp.dtype, np.complexfloating)
        a_scale = max(float(abs(sp).sum(axis=1).max()), 1e-300)
        tol = max(self.tolerance, 1e-14)
        lams = np.atleast_1d(res.eigenvalues)
        cols = []
        vec_ok = np.zeros(len(lams), dtype=bool)
        rng = np.random.default_rng(7)
        for k, lam in enumerate(lams):
            lam_c = complex(lam) if is_complex else float(np.real(lam))
            # relative offset with an absolute floor scaled by ||A||, so
            # lam == 0 gives no near-singular shifted matrix
            off = 1e-6 * max(abs(lam_c), 1e-4 * a_scale)
            shift = lam_c + off
            shifted = (sp - shift * sps.eye_array(n)).tocsr()
            inner = make_nested(SolverRegistry.get(name)(
                self.cfg, self.scope, device=self.device))
            inner.setup(SparseMatrix.from_scipy(shifted,
                                                device=self.device))
            v = rng.standard_normal(n)
            if is_complex:
                v = v + 1j * rng.standard_normal(n)
            v = v.astype(sp.dtype)
            v = self._to_dev(v / max(np.linalg.norm(v), 1e-300))
            for _ in range(self._VECTOR_MAX_STEPS):
                v = inner.solve(v).x
                v = v / torch.clamp(torch.linalg.vector_norm(v),
                                    min=1e-300)
                # against the vector's own Rayleigh quotient: the
                # algorithm's eigenvalue is only tol-accurate
                Av = spmv(self.A, v)
                rho = torch.vdot(v, Av)
                resid = float(torch.linalg.vector_norm(Av - rho * v))
                if resid <= tol * a_scale:
                    vec_ok[k] = True
                    break
            cols.append(v)
        return dataclasses.replace(
            res, eigenvectors=torch.stack(cols, dim=1),
            vector_converged=vec_ok,
        )


def create_eigensolver(cfg, scope: str = "default",
                       device="cuda") -> EigenSolver:
    """The eigensolver ``eig_solver`` names, on ``device`` (default the
    card)."""
    name = str(cfg.get("eig_solver", scope)).upper()
    inst = EigenSolverRegistry.get(name)(cfg, scope, device=device)
    # several names share a class (the SINGLE_ITERATION family); record
    # the one asked for so that setup can specialize
    inst.requested_name = name
    return inst
