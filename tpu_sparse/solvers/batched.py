"""Batched multi-RHS solves.

The reference's batched path is a sequential Python loop
(`batch_cudss_spsolve`, cudss_solver.py:297-324). Here: vmap the whole
solver over the RHS batch — one compiled program, all solves run as one
fused batch on device (SpMV batches into SpMM).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from tpu_sparse.solvers.krylov import bicgstab_full, cg_full, gmres_full
from tpu_sparse.solvers.minres import minres_full


def _batch(solver_full, A, B, X0=None, **kw):
    """Solve A X = B column-wise; B is (n, k) or a batch of pytrees.

    Sparse A is wrapped in `batch_safe_matvec` so the vmapped matvec
    lowers to one SpMM, which reads the matrix once for all columns."""
    from tpu_sparse.kernels import batch_safe_matvec
    from tpu_sparse.sparse.containers import is_sparse

    if is_sparse(A):
        A = batch_safe_matvec(A)
    if X0 is None:
        def one(b):
            return solver_full(A, b, None, **kw)

        return jax.vmap(one, in_axes=-1, out_axes=(-1, 0, 0, 0))(B)

    def one_w(b, x0):
        return solver_full(A, b, x0, **kw)

    return jax.vmap(one_w, in_axes=(-1, -1), out_axes=(-1, 0, 0, 0))(B, X0)


def batch_cg(A, B: jax.Array, X0=None, *, tol: float = 1e-5,
             atol: float = 0.0, maxiter: Optional[int] = None, M=None):
    """CG over each column of B. Returns (X, infos, iters, res_norms)."""
    return _batch(cg_full, A, B, X0, tol=tol, atol=atol, maxiter=maxiter,
                  M=M)


def batch_bicgstab(A, B: jax.Array, X0=None, *, tol: float = 1e-5,
                   atol: float = 0.0, maxiter: Optional[int] = None, M=None):
    return _batch(bicgstab_full, A, B, X0, tol=tol, atol=atol,
                  maxiter=maxiter, M=M)


def batch_gmres(A, B: jax.Array, X0=None, *, tol: float = 1e-5,
                atol: float = 0.0, restart: int = 20,
                maxiter: Optional[int] = None, M=None,
                solve_method: str = "batched"):
    return _batch(gmres_full, A, B, X0, tol=tol, atol=atol, restart=restart,
                  maxiter=maxiter, M=M, solve_method=solve_method)


def batch_fcg(A, B: jax.Array, X0=None, *, tol: float = 1e-5,
              atol: float = 0.0, maxiter: Optional[int] = None, M=None):
    from tpu_sparse.solvers.fcg import fcg_full

    return _batch(fcg_full, A, B, X0, tol=tol, atol=atol, maxiter=maxiter,
                  M=M)


def batch_fgmres(A, B: jax.Array, X0=None, *, tol: float = 1e-5,
                 atol: float = 0.0, restart: int = 20,
                 maxiter: Optional[int] = None, M=None):
    from tpu_sparse.solvers.fgmres import fgmres_full

    return _batch(fgmres_full, A, B, X0, tol=tol, atol=atol,
                  restart=restart, maxiter=maxiter, M=M)


def batch_minres(A, B: jax.Array, X0=None, *, tol: float = 1e-5,
                 atol: float = 0.0, maxiter: Optional[int] = None, M=None):
    return _batch(minres_full, A, B, X0, tol=tol, atol=atol,
                  maxiter=maxiter, M=M)


def batch_refined(method: str, A, B: jax.Array, X0=None, *,
                  tol: float = 1e-8, atol: float = 0.0,
                  maxiter: Optional[int] = None, M=None, **kw):
    """Mixed-precision (defect-correction) solve per column of B.

    vmaps `refined_solve` over the RHS columns: one compiled program runs
    all k refinements, each with its own sweep acceptance/stall logic
    (everything inside refined_solve is jnp-level, so it batches
    cleanly). Returns (X, infos, inner_iters, res_norms)."""
    from tpu_sparse.solvers.mixed import (bicgstab_refined, cg_refined,
                                          cg_sr_refined, fcg_refined,
                                          fgmres_refined, gmres_refined,
                                          minres_refined)

    fn = {"cg": cg_refined, "bicgstab": bicgstab_refined,
          "gmres": gmres_refined, "cg_sr": cg_sr_refined,
          "minres": minres_refined, "fcg": fcg_refined,
          "fgmres": fgmres_refined}[method]
    return _batch(fn, A, B, X0, tol=tol, atol=atol, maxiter=maxiter,
                  M=M, **kw)


def batch_direct(A, B: jax.Array):
    """Direct solve per column (vmapped banded/dense solver)."""
    from tpu_sparse.direct import direct_solve

    return jax.vmap(lambda b: direct_solve(A, b), in_axes=-1,
                    out_axes=-1)(B)
