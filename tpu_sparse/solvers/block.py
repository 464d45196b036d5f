"""Block Krylov solvers — multi-RHS solves that SHARE the Krylov space.

`batch_cg` (solvers/batched.py) vmaps k independent solves; block CG
(O'Leary 1980) instead iterates one block: each iteration applies A to an
(n, k) direction block — one matrix pass feeds every RHS — and the k
per-column dot products become k×k Gram matmuls (one matrix product
instead of k reductions). Columns also converge in the union of the k Krylov
spaces, typically in fewer iterations than any single-vector solve.

The reference has no block solver at all (its batched path is a
sequential Python loop, cudss_solver.py:297-324); this is a capability
extension.

Stabilization (this is the part plain O'Leary block CG gets wrong in low
precision): the direction block is re-orthonormalized by modified
Gram-Schmidt every iteration, the Galerkin step is computed directly as
alpha = (PᵀAP)⁻¹ PᵀR (no ZᵀR recursion — exact-arithmetic-equivalent,
far more robust once P drifts), and new directions are explicitly
A-orthogonalized against the previous block. Converged columns are frozen
by masking them out of the Gram systems (zero row/col + unit pivot) and
degenerate directions deflate to zero columns in the MGS pass — both keep
shapes static under jit and avoid the classic rank-deficiency breakdown
when one RHS converges early.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from tpu_sparse.sparse.containers import is_sparse


def _as_matmat(A):
    """(n, k) block application of an operator."""
    if A is None:
        return lambda V: V
    if is_sparse(A):
        from tpu_sparse.kernels import spmm

        return lambda V: spmm(A, V)
    if callable(A) and not hasattr(A, "ndim"):
        return jax.vmap(A, in_axes=-1, out_axes=-1)
    Ad = jnp.asarray(A)
    return lambda V: jnp.dot(Ad, V, precision=lax.Precision.HIGHEST)


def _mgs_block(P: jax.Array) -> jax.Array:
    """Orthonormalize the k columns of P by modified Gram-Schmidt.

    Degenerate (near-zero after projection) columns deflate to exact zero
    so they drop out of the Gram systems via the unit-pivot fix-up. k is
    small and static, so the k² column loop unrolls at trace time.
    """
    k = P.shape[1]
    eps = jnp.finfo(P.dtype).eps
    scale = jnp.sqrt(jnp.sum((P.conj() * P).real))  # block norm
    qs = []
    for j in range(k):
        v = P[:, j]
        for q in qs:
            v = v - q * jnp.vdot(q, v)
        nrm = jnp.sqrt(jnp.sum((v.conj() * v).real))
        keep = nrm > 32 * eps * scale
        safe = jnp.where(keep, nrm, jnp.ones((), nrm.dtype))
        qs.append(jnp.where(keep, v / safe.astype(P.dtype), 0))
    return jnp.stack(qs, axis=1)


class _BlockCGState(NamedTuple):
    X: jax.Array
    R: jax.Array
    P: jax.Array
    rs: jax.Array      # (k,) unpreconditioned squared residual norms
    k: jax.Array


def block_cg(A, B: jax.Array, X0: Optional[jax.Array] = None, *,
             tol: float = 1e-5, atol: float = 0.0,
             maxiter: Optional[int] = None, M=None
             ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Stabilized block CG for SPD A with B of shape (n, k).

    Returns ``(X, infos, iterations, res_norms)`` — infos/res_norms are
    per-column (k,), matching `batch_cg`; iterations is the shared block
    iteration count.
    """
    if B.ndim != 2:
        raise ValueError("block_cg expects B of shape (n, k)")
    n, nrhs = B.shape
    if X0 is None:
        X0 = jnp.zeros_like(B)
    if maxiter is None:
        maxiter = 10 * n
    A_mm = _as_matmat(A)
    M_mm = _as_matmat(M)
    dtype = B.dtype
    eye = jnp.eye(nrhs, dtype=dtype)

    bs = jnp.sum((B.conj() * B).real, axis=0)            # (k,) ||b_j||²
    atol2 = jnp.maximum(jnp.square(tol) * bs, jnp.square(atol))

    def gram(U, V):
        return jnp.dot(U.conj().T, V, precision=lax.Precision.HIGHEST)

    def dead_fix(S):
        """Unit pivots for zero (inactive or deflated) direction columns."""
        d = jnp.diagonal(S).real
        return S + eye * jnp.where(d == 0, 1.0, 0.0).astype(dtype)

    R0 = B - A_mm(X0)
    rs0 = jnp.sum((R0.conj() * R0).real, axis=0)
    act0 = (rs0 > atol2).astype(dtype)
    P0 = _mgs_block(M_mm(R0) * act0[None, :])

    def cond(s: _BlockCGState):
        return (s.k < maxiter) & jnp.any(s.rs > atol2)

    def body(s: _BlockCGState):
        X, R, P, rs, k = s
        act = (rs > atol2).astype(dtype)
        Pm = P * act[None, :]
        Q = A_mm(Pm)
        S = dead_fix(gram(Pm, Q))
        # Galerkin step: alpha = (PᵀAP)⁻¹ Pᵀ(R·act); masked columns get
        # zero alpha columns, so converged x_j / r_j freeze.
        alpha = jnp.linalg.solve(S, gram(Pm, R * act[None, :]))
        X = X + jnp.dot(Pm, alpha, precision=lax.Precision.HIGHEST)
        R = R - jnp.dot(Q, alpha, precision=lax.Precision.HIGHEST)
        # periodic residual replacement: the block recurrence residual
        # drifts from the true one in low precision (k updates per step
        # compound the rounding); one extra A application every 32 steps
        # pins them back together.
        R = lax.cond(jnp.equal(jnp.mod(k + 1, 32), 0),
                     lambda: B - A_mm(X), lambda: R)
        rs = jnp.sum((R.conj() * R).real, axis=0)
        act_new = (rs > atol2).astype(dtype)
        Z = M_mm(R) * act_new[None, :]
        # A-orthogonalize the new directions against the previous block,
        # then re-orthonormalize (the stabilization step).
        beta = jnp.linalg.solve(S, gram(Q, Z))
        P = _mgs_block(Z - jnp.dot(Pm, beta,
                                   precision=lax.Precision.HIGHEST))
        return _BlockCGState(X, R, P, rs, k + 1)

    init = _BlockCGState(X0, R0, P0, rs0, jnp.array(0, jnp.int32))
    fin = lax.while_loop(cond, body, init)

    # truthful per-column final check on recomputed residuals (same
    # dtype-aware relaxation as cg_full: the recurrence residual the loop
    # stops on drifts from the true residual by rounding)
    from tpu_sparse.solvers.krylov import _final_check_relax, _real_dtype

    Rf = B - A_mm(fin.X)
    res = jnp.sqrt(jnp.sum((Rf.conj() * Rf).real, axis=0))
    thresh = jnp.maximum(tol * jnp.sqrt(bs), atol) * _final_check_relax(
        _real_dtype(dtype))
    finite = jnp.isfinite(res) & jnp.all(jnp.isfinite(fin.X.real), axis=0)
    infos = jnp.where(finite & (res <= thresh), 0, -1).astype(jnp.int32)
    return fin.X, infos, fin.k, res


__all__ = ["block_cg"]
