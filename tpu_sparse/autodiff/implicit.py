"""Implicit differentiation for linear solves (adjoint method).

Behavioral contract (reference README.md:420-429 and
torch_sparse_linalg.py:1161-1258): gradients of a solve x = A⁻¹ b come from
**one extra adjoint solve** — never from differentiating through solver
iterations:

    forward :  solve  A x = b          (no graph through iterations)
    backward:  solve  Aᴴ v = x̄         (same solver, adjoint operator)
               b̄ = v
               Ā  = -v xᴴ restricted to A's sparsity pattern

The reference's Module A computes only b̄ (ImplicitAdjointFunction,
torch_sparse_linalg.py:1227-1248); its Modules B/C also compute Ā on the
pattern (torch_amgx.py:432-465 CSR/COO/dense cases, cudss_solver.py:115-173).
This module computes **both**, for every solver and every sparse format.

Design:

* Matrix operands (sparse containers / dense arrays) go through
  `jax.custom_vjp` with the whole container as a differentiable pytree
  argument. Ā on the sparsity pattern falls out *generically* for every
  format by applying `jax.vjp` to the values-linear SpMV — no per-format
  gradient kernels.
* Matrix-free callables go through `jax.lax.custom_linear_solve`, which
  transposes the matvec jaxpr symbolically (gradients w.r.t. closed-over
  arrays included) — the idiomatic JAX replacement for the reference's
  "re-supply Aᵀ yourself" contract.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional

import numpy as onp

import jax
import jax.numpy as jnp
from jax import lax
from jax.tree_util import Partial

from tpu_sparse.kernels import as_matvec, spmv
from tpu_sparse.solvers.fcg import fcg_full
from tpu_sparse.solvers.fgmres import fgmres_full
from tpu_sparse.solvers.krylov import bicgstab_full, cg_full, gmres_full
from tpu_sparse.solvers.minres import minres_full
from tpu_sparse.solvers.pipelined import cg_sr_full
from tpu_sparse.sparse.containers import BSR, CSR, DIA, is_sparse
from tpu_sparse.utils.tree import tree_map

_SOLVERS = {
    "cg": cg_full,
    "cg_sr": cg_sr_full,
    "fcg": fcg_full,
    "bicgstab": bicgstab_full,
    "gmres": gmres_full,
    "fgmres": fgmres_full,
    "minres": minres_full,
}

# 'symmetric' = the adjoint solve may reuse A (hermitian operators); FCG
# additionally tolerates nonsymmetric M, so the forward M is reused too.
_SYMMETRIC = {"cg": True, "cg_sr": True, "fcg": True, "bicgstab": False,
              "gmres": False, "fgmres": False, "minres": True}


def _zero_cotangent(tree):
    """Zero cotangent matching ``tree``: float0 for integer leaves."""

    def z(p):
        if p is None:
            return None
        if jnp.issubdtype(jnp.result_type(p), jnp.inexact):
            return jnp.zeros_like(p)
        return onp.zeros(onp.shape(p), dtype=jax.dtypes.float0)

    return tree_map(z, tree)


def _adjoint_matrix(A, symmetric: bool):
    """Aᴴ for a container or dense matrix, built with jit-safe ops only."""
    if symmetric:
        return A
    if isinstance(A, DIA):
        At = A.T  # static-shift construction, jit-safe
    elif isinstance(A, (CSR, BSR)):
        At = A.tocoo().T  # COO transpose is free and jit-safe
    elif is_sparse(A):
        At = A.T
    else:
        At = jnp.swapaxes(A, -1, -2)
    if jnp.issubdtype(At.dtype, jnp.complexfloating):
        At = At.conj()
    return At


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _implicit_matrix_solve(method: str, opts: tuple, A, b, x0, M):
    """Solve with A given as a matrix pytree. Differentiable in A and b
    (through x, the first output); x0 and M carry zero gradient, as implied
    by the implicit function theorem."""
    solver = _SOLVERS[method]
    kw = dict(opts)
    return solver(A, b, x0, M=M, **kw)


def _ims_fwd(method, opts, A, b, x0, M):
    out = _implicit_matrix_solve(method, opts, A, b, x0, M)
    return out, (A, b, x0, M, out[0])


def _ims_bwd(method, opts, residuals, cotangents):
    A, b, x0, M, x = residuals
    x_bar = cotangents[0]
    solver = _SOLVERS[method]
    kw = dict(opts)
    At = _adjoint_matrix(A, _SYMMETRIC[method])
    # One adjoint solve (reference :1238-1248). The forward preconditioner
    # is reused only for symmetric methods (CG assumes hermitian M anyway);
    # for nonsymmetric methods M would need to be Mᴴ, which we cannot form
    # for an arbitrary operator — solving unpreconditioned is slower but
    # correct.
    M_adj = M if _SYMMETRIC[method] else None
    v = solver(At, x_bar, None, M=M_adj, **kw)[0]
    grad_b = v
    # Ā on the pattern: vjp of the values-linear matvec A ↦ A x at -v.
    _, mv_vjp = jax.vjp(lambda a: spmv(a, x), A)
    (grad_A,) = mv_vjp(tree_map(lambda u: -u, v))
    return (grad_A, grad_b, _zero_cotangent(x0), _zero_cotangent(M))


_implicit_matrix_solve.defvjp(_ims_fwd, _ims_bwd)


def _final_stats(A_fn, b, x, kw):
    """(info, iters=-1, res) for the matrix-free paths: recompute the true
    residual and apply the cg_full-style final check. stop_gradient keeps
    the extra A_fn application (possibly an op with no JVP rule, such as
    a host callback) off the autodiff path — stats are reports, not
    differentiable outputs."""
    from tpu_sparse.utils.tree import tree_map, tree_norm, tree_sub

    xs = tree_map(lax.stop_gradient, x)
    bs = tree_map(lax.stop_gradient, b)
    res = tree_norm(tree_sub(bs, A_fn(xs)))
    b_norm = tree_norm(bs)
    tol = kw.get("tol", 1e-5)
    atol = kw.get("atol", 0.0)
    from tpu_sparse.solvers.krylov import _final_check_relax, _float_dtype

    relax = _final_check_relax(jnp.finfo(_float_dtype(bs)).dtype)
    thresh = jnp.maximum(tol * b_norm, atol) * relax
    failed = (~jnp.isfinite(tree_norm(xs))) | (~jnp.isfinite(res)) \
        | (res > thresh)
    info = jnp.where(failed, -1, 0).astype(jnp.int32)
    return info, jnp.array(-1, jnp.int32), res


def _callable_solve(method: str, opts: tuple, A_fn: Callable, b, x0, M):
    """Matrix-free path via lax.custom_linear_solve: implicit diff with
    gradients w.r.t. b and anything A_fn closes over."""
    solver = _SOLVERS[method]
    kw = dict(opts)
    symmetric = _SYMMETRIC[method]

    def solve(mv, rhs):
        return solver(mv, rhs, x0, M=M, **kw)[0]

    def tr_solve(mv_t, rhs):
        return solver(mv_t, rhs, None, M=M, **kw)[0]

    x = lax.custom_linear_solve(A_fn, b, solve, transpose_solve=tr_solve,
                                symmetric=symmetric)
    # Stats recomputed outside the implicit wrapper (one extra matvec).
    info, iters, res = _final_stats(A_fn, b, x, kw)
    return x, info, iters, res


def _callable_solve_explicit_T(method: str, opts: tuple, A_fn: Callable,
                               At_fn: Callable, b, x0, M):
    """Matrix-free path with a user-supplied adjoint matvec.

    ``lax.custom_linear_solve`` derives the adjoint matvec by transposing
    the forward matvec's jaxpr — which fails when A_fn contains an
    untransposable op (a host callback, a foreign-function call). Supplying
    ``A_transpose`` sidesteps transposition entirely: backward runs ONE
    adjoint solve ``Aᴴ v = x̄`` with the given matvec (the reference's own
    contract: re-supply Aᵀ, torch_sparse_linalg.py:1238-1248). Gradients
    flow w.r.t. b only — arrays A_fn closes over are treated as constants
    (use a sparse container, or omit A_transpose, for ∂L/∂A).
    """
    solver = _SOLVERS[method]
    kw = dict(opts)

    @jax.custom_vjp
    def run(bb):
        return solver(A_fn, bb, x0, M=M, **kw)[0]

    def fwd(bb):
        return run(bb), None

    def bwd(_, xbar):
        v = solver(At_fn, xbar, None, M=None, **kw)[0]
        return (v,)

    run.defvjp(fwd, bwd)
    x = run(b)
    info, iters, res = _final_stats(A_fn, b, x, kw)
    return x, info, iters, res


def _dispatch(method: str, A, b, x0, M, opts: tuple, A_transpose=None):
    if callable(M) and not is_sparse(M) and not isinstance(M, Partial):
        # Plain callables are not pytrees; wrap so M can ride through
        # custom_vjp as an argument. Closures over traced arrays should use
        # jax.tree_util.Partial(f, arrays) so the arrays are leaves.
        M = Partial(M)
    if callable(A) and not is_sparse(A) and not hasattr(A, "ndim"):
        if A_transpose is not None:
            return _callable_solve_explicit_T(method, opts, A, A_transpose,
                                              b, x0, M)
        return _callable_solve(method, opts, A, b, x0, M)
    return _implicit_matrix_solve(method, opts, A, b, x0, M)


def cg_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
            maxiter: Optional[int] = None, M=None):
    """CG with implicit-diff adjoint (A hermitian ⇒ adjoint solve reuses A).

    Returns (x, info, iterations, residual_norm). Gradients flow w.r.t. b
    and A's values through x. Reference: cg + ImplicitAdjointFunction
    (torch_sparse_linalg.py:1019-1088, :1227-1248).
    """
    opts = (("tol", tol), ("atol", atol), ("maxiter", maxiter))
    return _dispatch("cg", A, b, x0, M, opts)


def cg_sr_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
               maxiter: Optional[int] = None, M=None):
    """Single-reduction (Chronopoulos-Gear) CG with implicit-diff adjoint
    (A hermitian => adjoint solve reuses A). Same contract as cg_diff."""
    opts = (("tol", tol), ("atol", atol), ("maxiter", maxiter))
    return _dispatch("cg_sr", A, b, x0, M, opts)


def fcg_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
             maxiter: Optional[int] = None, M=None):
    """Flexible CG with implicit-diff adjoint (A hermitian; M arbitrary)."""
    opts = (("tol", tol), ("atol", atol), ("maxiter", maxiter))
    return _dispatch("fcg", A, b, x0, M, opts)


def minres_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
                maxiter: Optional[int] = None, M=None):
    """MINRES with implicit-diff adjoint (A symmetric indefinite ⇒ the
    adjoint solve reuses A and M)."""
    opts = (("tol", tol), ("atol", atol), ("maxiter", maxiter))
    return _dispatch("minres", A, b, x0, M, opts)


def fgmres_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
                restart: int = 20, maxiter: Optional[int] = None, M=None,
                A_transpose=None):
    """Flexible GMRES with implicit-diff adjoint (adjoint on Aᴴ, no M).

    A_transpose: explicit adjoint matvec for matrix-free A whose forward
    matvec cannot be jaxpr-transposed (host callbacks, foreign calls).
    """
    opts = (("tol", tol), ("atol", atol), ("restart", restart),
            ("maxiter", maxiter))
    return _dispatch("fgmres", A, b, x0, M, opts, A_transpose=A_transpose)


def bicgstab_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
                  maxiter: Optional[int] = None, M=None, A_transpose=None):
    """BiCGStab with implicit-diff adjoint (adjoint solve on Aᴴ).

    A_transpose: explicit adjoint matvec for matrix-free A whose forward
    matvec cannot be jaxpr-transposed (host callbacks, foreign calls);
    see _callable_solve_explicit_T.
    """
    opts = (("tol", tol), ("atol", atol), ("maxiter", maxiter))
    return _dispatch("bicgstab", A, b, x0, M, opts, A_transpose=A_transpose)


def gmres_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
               restart: int = 20, maxiter: Optional[int] = None, M=None,
               solve_method: str = "batched", A_transpose=None):
    """GMRES with implicit-diff adjoint (adjoint solve on Aᴴ).

    A_transpose: explicit adjoint matvec for matrix-free A whose forward
    matvec cannot be jaxpr-transposed (host callbacks, foreign calls).
    """
    opts = (("tol", tol), ("atol", atol), ("restart", restart),
            ("maxiter", maxiter), ("solve_method", solve_method))
    return _dispatch("gmres", A, b, x0, M, opts, A_transpose=A_transpose)
