"""Flexible GMRES (FGMRES): right-preconditioned GMRES with a stored
preconditioned basis, tolerating nonsymmetric/iteration-varying M.

Left-preconditioned GMRES (the reference's and `gmres`'s formulation)
requires a fixed M and converges on the M-residual; FGMRES applies M on the
right (w = A·M·v), stores the preconditioned vectors Z_k = M(V_k), and
updates x from Z — so M may change every iteration (inner iterative
solves, nonsymmetric AMG cycles) and the Givens recurrence tracks the TRUE
residual. Saad (1993). One extra stored basis of vectors is the cost.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from tpu_sparse.kernels import as_matvec
from tpu_sparse.solvers.krylov import (
    _apply_givens_rotations,
    _check_tree_compat,
    _final_check_relax,
    _float_dtype,
    _identity,
    _iterative_classical_gram_schmidt,
    _real_dtype,
    _safe_normalize,
    _upper_triangular_solve,
)
from tpu_sparse.utils.tree import (
    tree_add,
    tree_map,
    tree_norm,
    tree_sub,
    tree_zeros_like,
)


class _FGmresCarry(NamedTuple):
    V: Any                # Krylov basis, LEADING axis restart+1
    Z: Any                # preconditioned basis M(V_k), LEADING axis restart
    R: jax.Array
    beta_vec: jax.Array
    givens: jax.Array
    err: jax.Array
    breakdown: jax.Array
    k: jax.Array


def _fgmres_cycle(A, M, b, x0, unit_residual, residual_norm, ptol, restart):
    dtype = _float_dtype(b)
    eps = jnp.finfo(_real_dtype(dtype)).eps
    V0 = tree_map(
        lambda u: jnp.pad(u[None], [(0, restart)] + [(0, 0)] * u.ndim),
        unit_residual,
    )
    Z0 = tree_map(
        lambda u: jnp.zeros((restart,) + u.shape, u.dtype), unit_residual)
    R0 = jnp.zeros((restart, restart), dtype)
    beta0 = jnp.zeros((restart + 1,), dtype).at[0].set(
        residual_norm.astype(dtype))
    givens0 = jnp.zeros((restart, 2), dtype)

    def cond(c: _FGmresCarry):
        return (c.k < restart) & (c.err > ptol) & jnp.logical_not(c.breakdown)

    def body(c: _FGmresCarry):
        v_k = tree_map(lambda Vl: Vl[c.k], c.V)
        z = M(v_k)
        w = A(z)
        w_pre = tree_norm(w)
        tol_k = eps * w_pre
        w, h = _iterative_classical_gram_schmidt(c.V, w, x_norm=w_pre)
        unit_w, w_norm = _safe_normalize(w, thresh=tol_k)
        V = tree_map(
            lambda Vl, ul: Vl.at[c.k + 1].set(ul.astype(Vl.dtype)),
            c.V, unit_w)
        Z = tree_map(
            lambda Zl, zl: Zl.at[c.k].set(zl.astype(Zl.dtype)), c.Z, z)
        h = h.at[c.k + 1].set(w_norm.astype(dtype))
        brk = w_norm == 0.0
        col, cs_k, sn_k = _apply_givens_rotations(h, c.givens, c.k, restart)
        R = c.R.at[:, c.k].set(col[:restart])
        givens = c.givens.at[c.k, 0].set(cs_k).at[c.k, 1].set(sn_k)
        bk = cs_k.conj() * c.beta_vec[c.k] - sn_k.conj() * c.beta_vec[c.k + 1]
        bk1 = sn_k * c.beta_vec[c.k] + cs_k * c.beta_vec[c.k + 1]
        beta_vec = c.beta_vec.at[c.k].set(bk).at[c.k + 1].set(bk1)
        return _FGmresCarry(V, Z, R, beta_vec, givens, jnp.abs(bk1), brk,
                            c.k + 1)

    carry = lax.while_loop(
        cond, body,
        _FGmresCarry(V0, Z0, R0, beta0, givens0, jnp.abs(beta0[0]),
                     jnp.array(False), jnp.array(0, jnp.int32)))

    k = carry.k
    idx = jnp.arange(restart)
    R = carry.R + jnp.diag(jnp.where(idx >= k, 1.0, 0.0).astype(dtype))
    rhs = jnp.where(idx < k, carry.beta_vec[:restart], 0.0).astype(dtype)
    y = _upper_triangular_solve(R, rhs)
    dx = tree_map(
        lambda Zl: jnp.einsum(
            "k...,k->...", Zl, y.astype(Zl.dtype),
            precision=lax.Precision.HIGHEST),
        carry.Z)
    x = tree_add(x0, dx)
    residual = tree_sub(b, A(x))  # right preconditioning: TRUE residual
    unit_residual, residual_norm = _safe_normalize(residual)
    return x, unit_residual, residual_norm


class _OuterCarry(NamedTuple):
    x: Any
    unit_residual: Any
    residual_norm: jax.Array
    k: jax.Array


def fgmres_full(A, b, x0: Optional[Any] = None, *, tol: float = 1e-5,
                atol: float = 0.0, restart: int = 20,
                maxiter: Optional[int] = None, M=None):
    """FGMRES returning (x, info, restart_cycles, residual_norm)."""
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    from tpu_sparse.solvers.krylov import _default_maxiter
    from tpu_sparse.utils.tree import tree_size

    size = tree_size(b)
    restart = min(restart, size)
    maxiter = _default_maxiter(b, maxiter)
    A_fn = as_matvec(A)
    M_fn = _identity if M is None else as_matvec(M)

    b_norm = tree_norm(b)
    atol_ = jnp.maximum(tol * b_norm, atol)

    residual = tree_sub(b, A_fn(x0))
    unit_residual, residual_norm = _safe_normalize(residual)

    def cond(c: _OuterCarry):
        return (c.k < maxiter) & (c.residual_norm > atol_)

    def body(c: _OuterCarry):
        x, ur, rn = _fgmres_cycle(A_fn, M_fn, b, c.x, c.unit_residual,
                                  c.residual_norm, atol_, restart)
        return _OuterCarry(x, ur, rn, c.k + 1)

    final = lax.while_loop(
        cond, body,
        _OuterCarry(x0, unit_residual, residual_norm,
                    jnp.array(0, jnp.int32)))

    res_norm = tree_norm(tree_sub(b, A_fn(final.x)))
    relaxed = atol_ * _final_check_relax(_real_dtype(_float_dtype(b)))
    failed = (~jnp.isfinite(tree_norm(final.x))) \
        | (~jnp.isfinite(res_norm)) | (res_norm > relaxed)
    info = jnp.where(failed, -1, 0).astype(jnp.int32)
    return final.x, info, final.k, res_norm


def fgmres(A, b, x0: Optional[Any] = None, *, tol: float = 1e-5,
           atol: float = 0.0, restart: int = 20,
           maxiter: Optional[int] = None, M=None) -> Tuple[Any, jax.Array]:
    """Flexible GMRES; returns (x, info)."""
    x, info, _, _ = fgmres_full(A, b, x0, tol=tol, atol=atol,
                                restart=restart, maxiter=maxiter, M=M)
    return x, info
