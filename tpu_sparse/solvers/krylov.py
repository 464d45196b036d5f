"""Krylov solvers: CG, BiCGStab, GMRES(restart).

Capability parity with the reference's Module A
(module_a/torch_sparse_linalg.py):

* `cg`        — :1019-1088 (`_cg_solve` :806-856)
* `bicgstab`  — :1091-1158 (`_bicgstab_solve` :859-964, breakdown codes
                −10/−11 at :902,:913,:934)
* `gmres`     — :641-784 (`_gmres_incremental` :557-638, `_gmres_batched`
                :431-493, Arnoldi :331-388, ICGS :284-328, Givens :508-518)

Re-designed for XLA: every solver is a single `lax.while_loop` body with
static shapes, so the whole iteration fuses into one compiled program
(one SpMV + a few axpys + psum-able dots per iteration). Operands are
arbitrary pytrees; `A` and `M` may be sparse containers, dense matrices, or
matrix-free callables.

Tolerance contract (same as reference / non-legacy scipy):
``converged iff norm(residual) <= max(tol * norm(b), atol)``.

`info` codes: 0 converged, -1 not converged / NaN, -10 rho-breakdown,
-11 alpha/omega-breakdown (BiCGStab only).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

from tpu_sparse.kernels import as_matvec
from tpu_sparse.utils.tree import (
    tree_add,
    tree_axpy,
    tree_leaves,
    tree_map,
    tree_norm,
    tree_scalar_mul,
    tree_size,
    tree_sub,
    tree_vdot,
    tree_vdot_real,
    tree_where,
    tree_zeros_like,
)

Operator = Union[Any, Callable]


def _identity(x):
    return x


def _float_dtype(tree) -> jnp.dtype:
    leaf = tree_leaves(tree)[0]
    return leaf.dtype


def _real_dtype(dtype) -> jnp.dtype:
    return jnp.finfo(dtype).dtype  # real counterpart (float64 for complex128)


def _default_maxiter(b, maxiter: Optional[int]) -> int:
    if maxiter is not None:
        return int(maxiter)
    return 10 * tree_size(b)  # same default as reference/scipy (:982-984)


def _check_tree_compat(x0, b):
    lx, lb = tree_leaves(x0), tree_leaves(b)
    if len(lx) != len(lb):
        raise ValueError("x0 and b must have matching tree structure")
    for a, c in zip(lx, lb):
        if a.shape != c.shape:
            raise ValueError(
                f"arrays in x0 and b must have matching shapes: {a.shape} vs {c.shape}"
            )



def _final_check_relax(dtype) -> float:
    """Residual-recheck relaxation: the convergence loop stops on the
    recurrence residual; in 32-bit arithmetic the recomputed true residual
    drifts slightly above it. The reference relaxes its final check 10x for
    exactly this reason (torch_sparse_linalg.py:765-771, GPU instability
    note); we apply that only to 32-bit dtypes and keep f64 strict."""
    return 10.0 if jnp.finfo(dtype).bits <= 32 else 1.0


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------


class _CGState(NamedTuple):
    x: Any
    r: Any
    gamma: jax.Array
    p: Any
    k: jax.Array


def _cg_loop(A: Callable, M: Callable, b, x0, atol2, maxiter: int,
             precond_is_identity: bool):
    r0 = tree_sub(b, A(x0))
    p0 = z0 = M(r0)
    dtype = _float_dtype(p0)
    gamma0 = tree_vdot_real(r0, z0).astype(_real_dtype(dtype))

    def rs_of(state: _CGState) -> jax.Array:
        if precond_is_identity:
            return state.gamma
        return tree_vdot_real(state.r, state.r)

    def cond(state: _CGState):
        return (state.k < maxiter) & (rs_of(state) > atol2)

    def body(state: _CGState):
        x, r, gamma, p, k = state
        Ap = A(p)
        alpha = (gamma / tree_vdot_real(p, Ap)).astype(dtype)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        z = M(r)
        gamma_new = tree_vdot_real(r, z).astype(_real_dtype(dtype))
        beta = (gamma_new / gamma).astype(dtype)
        p = tree_axpy(beta, p, z)
        return _CGState(x, r, gamma_new, p, k + 1)

    init = _CGState(x0, r0, gamma0, p0, jnp.array(0, jnp.int32))
    final = lax.while_loop(cond, body, init)
    return final.x, final.k


def cg(A: Operator, b: Any, x0: Optional[Any] = None, *, tol: float = 1e-5,
       atol: float = 0.0, maxiter: Optional[int] = None,
       M: Optional[Operator] = None) -> Tuple[Any, jax.Array]:
    """Conjugate-Gradient solve of Ax = b (A hermitian positive definite).

    Returns ``(x, info)`` with info 0 on convergence, -1 otherwise.
    Matches reference `cg` (torch_sparse_linalg.py:1019-1088).
    """
    x, info, _, _ = cg_full(A, b, x0, tol=tol, atol=atol, maxiter=maxiter, M=M)
    return x, info


def cg_full(A: Operator, b: Any, x0: Optional[Any] = None, *, tol: float = 1e-5,
            atol: float = 0.0, maxiter: Optional[int] = None,
            M: Optional[Operator] = None):
    """CG returning (x, info, iterations, final_residual_norm)."""
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    maxiter = _default_maxiter(b, maxiter)
    A_fn = as_matvec(A)
    precond_identity = M is None
    M_fn = _identity if M is None else as_matvec(M)

    bs = tree_vdot_real(b, b)
    atol2 = jnp.maximum(jnp.square(tol) * bs, jnp.square(atol))

    x, k = _cg_loop(A_fn, M_fn, b, x0, atol2, maxiter, precond_identity)

    # Unpreconditioned residual: the loop's stopping rule uses <r, r>
    # without M, and a strong M (e.g. AMG, ~A^-1) can inflate ||M r|| by
    # 1/lambda_min and spuriously flag converged solves.
    res_norm = tree_norm(tree_sub(b, A_fn(x)))
    b_norm = jnp.sqrt(bs)
    thresh = jnp.maximum(tol * b_norm, atol) * _final_check_relax(
        _real_dtype(_float_dtype(b)))
    failed = (~jnp.isfinite(tree_norm(x))) | (~jnp.isfinite(res_norm)) \
        | (res_norm > thresh)
    info = jnp.where(failed, -1, 0).astype(jnp.int32)
    return x, info, k, res_norm


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------


class _BiCGState(NamedTuple):
    x: Any
    r: Any
    alpha: jax.Array
    omega: jax.Array
    rho: jax.Array
    p: Any
    q: Any
    k: jax.Array


def _bicgstab_loop(A: Callable, M: Callable, b, x0, atol2, maxiter: int):
    r0 = tree_sub(b, A(x0))
    rhat = r0
    dtype = _float_dtype(r0)
    one = jnp.ones((), dtype)
    eps = jnp.finfo(_real_dtype(dtype)).eps

    def cond(state: _BiCGState):
        rs = tree_vdot_real(state.r, state.r)
        return (rs > atol2) & (state.k < maxiter) & (state.k >= 0)

    def body(state: _BiCGState):
        x, r, alpha, omega, rho, p, q, k = state
        rho_new = tree_vdot(rhat, r)
        beta = rho_new / rho * alpha / omega
        p_new = tree_axpy(beta, tree_axpy(-omega, q, p), r)
        phat = M(p_new)
        q_new = A(phat)
        alpha_new = rho_new / tree_vdot(rhat, q_new)
        s = tree_axpy(-alpha_new, q_new, r)
        exit_early = tree_vdot_real(s, s) < atol2
        shat = M(s)
        t = A(shat)
        tt = tree_vdot(t, t)
        omega_new = jnp.where(jnp.abs(tt) > 0, tree_vdot(t, s) / tt,
                              jnp.zeros((), dtype))
        x_new = tree_where(
            exit_early,
            tree_axpy(alpha_new, phat, x),
            tree_axpy(omega_new, shat, tree_axpy(alpha_new, phat, x)),
        )
        r_new = tree_where(exit_early, s, tree_axpy(-omega_new, t, s))
        # Breakdown codes match the reference (:902 rho, :913/:934 alpha/omega).
        k_next = jnp.where(
            (jnp.abs(rho_new) < eps * jnp.abs(rho)),
            jnp.array(-10, jnp.int32),
            jnp.where(
                (jnp.abs(alpha_new) < eps)
                | ((jnp.abs(omega_new) < eps) & ~exit_early),
                jnp.array(-11, jnp.int32),
                k + 1,
            ),
        )
        return _BiCGState(x_new, r_new, alpha_new, omega_new, rho_new,
                          p_new, q_new, k_next)

    init = _BiCGState(x0, r0, one, one, one, r0, r0, jnp.array(0, jnp.int32))
    final = lax.while_loop(cond, body, init)
    return final.x, final.k


def bicgstab(A: Operator, b: Any, x0: Optional[Any] = None, *, tol: float = 1e-5,
             atol: float = 0.0, maxiter: Optional[int] = None,
             M: Optional[Operator] = None) -> Tuple[Any, jax.Array]:
    """BiCGStab solve of Ax = b (A need not be symmetric).

    Matches reference `bicgstab` (torch_sparse_linalg.py:1091-1158).
    info: 0 converged, -1 no convergence, -10/-11 breakdown.
    """
    x, info, _, _ = bicgstab_full(A, b, x0, tol=tol, atol=atol,
                                  maxiter=maxiter, M=M)
    return x, info


def bicgstab_full(A: Operator, b: Any, x0: Optional[Any] = None, *,
                  tol: float = 1e-5, atol: float = 0.0,
                  maxiter: Optional[int] = None, M: Optional[Operator] = None):
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    maxiter = _default_maxiter(b, maxiter)
    A_fn = as_matvec(A)
    M_fn = _identity if M is None else as_matvec(M)

    bs = tree_vdot_real(b, b)
    atol2 = jnp.maximum(jnp.square(tol) * bs, jnp.square(atol))

    x, k = _bicgstab_loop(A_fn, M_fn, b, x0, atol2, maxiter)

    # Unpreconditioned residual: the loop's stopping rule uses <r, r>
    # without M, and a strong M (e.g. AMG, ~A^-1) can inflate ||M r|| by
    # 1/lambda_min and spuriously flag converged solves.
    res_norm = tree_norm(tree_sub(b, A_fn(x)))
    b_norm = jnp.sqrt(bs)
    thresh = jnp.maximum(tol * b_norm, atol) * _final_check_relax(
        _real_dtype(_float_dtype(b)))
    failed = (~jnp.isfinite(tree_norm(x))) | (~jnp.isfinite(res_norm)) \
        | (res_norm > thresh)
    info = jnp.where(k < 0, k, jnp.where(failed, -1, 0)).astype(jnp.int32)
    return x, info, k, res_norm


# ---------------------------------------------------------------------------
# GMRES
# ---------------------------------------------------------------------------


def _safe_normalize(x, thresh=None):
    """Normalize a pytree vector; returns zeros when the norm underflows.

    Mirrors reference `_safe_normalize` (torch_sparse_linalg.py:217-273).
    """
    norm = tree_norm(x)
    dtype = _float_dtype(x)
    if thresh is None:
        thresh = jnp.finfo(_real_dtype(dtype)).eps
    thresh = jnp.asarray(thresh, norm.dtype)
    use = norm > thresh
    denom = jnp.where(use, norm, 1.0)
    normalized = tree_map(
        lambda leaf: jnp.where(use, leaf / denom.astype(leaf.dtype), 0.0), x
    )
    norm = jnp.where(use, norm, 0.0)
    return normalized, norm


def _project_on_columns(V, x):
    """h[j] = <V_j, x> for every stacked basis column j.

    V leaves have a LEADING basis axis of size (restart+1): basis columns
    are contiguous in device memory, so prefix-blocked sweeps and
    per-column reads/writes touch exactly the bytes they use. (With the
    trailing layout every BK-column block read pays the full padded basis
    width per cache line.) (Reference `_project_on_columns`,
    torch_sparse_linalg.py:276-281.)
    """
    def leaf_proj(Vl, xl):
        return jnp.einsum(
            "k...,...->k", Vl.conj(), xl,
            precision=lax.Precision.HIGHEST,
        )

    leaves = [leaf_proj(Vl, xl) for Vl, xl in zip(tree_leaves(V), tree_leaves(x))]
    return sum(leaves)


def _sub_from_columns(V, h, x):
    """x - V @ h, leafwise over the leading basis axis."""
    def leaf_sub(xl, Vl):
        return xl - jnp.einsum(
            "k...,k->...", Vl, h.astype(Vl.dtype),
            precision=lax.Precision.HIGHEST,
        )

    return tree_map(leaf_sub, x, V)


_PROJ_BLOCK = 8  # basis columns per blocked-projection step


def _project_on_prefix(V, x, kplus):
    """h[j] = <V_j, x> for the filled prefix j < kplus (later columns are
    structurally zero). Blocked dynamic-prefix sweep: memory traffic
    scales with the FILLED basis, not the restart width — the full einsum
    makes every Arnoldi step read the whole basis twice (CGS2) regardless
    of k. Requires the leading basis axis padded to a multiple of
    _PROJ_BLOCK (the cycle drivers do); leading-axis blocks are
    contiguous in memory."""
    leaves_V = tree_leaves(V)
    leaves_x = tree_leaves(x)
    m1p = leaves_V[0].shape[0]
    BK = min(_PROJ_BLOCK, m1p)
    res_dtype = jnp.result_type(*[Vl.dtype for Vl in leaves_V])
    nb = jnp.minimum((kplus + BK - 1) // BK, m1p // BK)

    def body(bidx, h):
        off = bidx * BK
        acc = jnp.zeros((BK,), res_dtype)
        for Vl, xl in zip(leaves_V, leaves_x):
            Vb = lax.dynamic_slice_in_dim(Vl, off, BK, axis=0)
            acc = acc + jnp.einsum(
                "k...,...->k", Vb.conj(), xl,
                precision=lax.Precision.HIGHEST).astype(res_dtype)
        return lax.dynamic_update_slice(h, acc, (off,))

    return lax.fori_loop(0, nb, body, jnp.zeros((m1p,), res_dtype))


def _sub_from_prefix(V, h, x, kplus):
    """x - V[:kplus]ᵀ @ h[:kplus], blocked like _project_on_prefix."""
    leaves_V = tree_leaves(V)
    m1p = leaves_V[0].shape[0]
    BK = min(_PROJ_BLOCK, m1p)
    nb = jnp.minimum((kplus + BK - 1) // BK, m1p // BK)

    def body(bidx, xs):
        off = bidx * BK
        hb = lax.dynamic_slice(h, (off,), (BK,))
        return tree_map(
            lambda xl, Vl: xl - jnp.einsum(
                "k...,k->...",
                lax.dynamic_slice_in_dim(Vl, off, BK, axis=0),
                hb.astype(Vl.dtype),
                precision=lax.Precision.HIGHEST), xs, V)

    return lax.fori_loop(0, nb, body, x)


def _iterative_classical_gram_schmidt(V, x, kplus=None, max_passes: int = 2,
                                      x_norm=None):
    """Iterative classical Gram-Schmidt, up to ``max_passes`` passes.

    Matches the reference's conditional re-orthogonalization (:284-328):
    when ``x_norm`` (the pre-orthogonalization ‖x‖, usually already
    computed by the caller for the breakdown threshold) is given, the
    second pass runs only if pass one cancelled more than half the norm
    (‖q‖ < ‖x‖/√2) — a `lax.cond`, so well-conditioned Arnoldi steps pay
    a single pass of basis traffic (the dominant HBM cost at scale).
    Without ``x_norm`` both passes run unconditionally (CGS2). ``kplus``
    (number of filled basis columns) switches to the blocked prefix
    sweeps so traffic scales with the filled basis, not the restart
    width."""
    if kplus is None:
        proj = lambda y: _project_on_columns(V, y)
        sub = lambda hh, y: _sub_from_columns(V, hh, y)
    else:
        proj = lambda y: _project_on_prefix(V, y, kplus)
        sub = lambda hh, y: _sub_from_prefix(V, hh, y, kplus)
    h = proj(x)
    q = sub(h, x)
    if x_norm is None:
        for _ in range(max_passes - 1):
            dh = proj(q)
            q = sub(dh, q)
            h = h + dh
        return q, h

    def reorth(args):
        q, h = args
        for _ in range(max_passes - 1):
            dh = proj(q)
            q = sub(dh, q)
            h = h + dh
        return q, h

    need = tree_norm(q) * 1.4142135623730951 < x_norm
    return lax.cond(need, reorth, lambda args: args, (q, h))


def _kth_arnoldi_iteration(k, A, M, V, H):
    """One Arnoldi step (reference :331-388). V: pytree with LEADING axis
    restart+1; H: (restart, restart+1) row k holds projections."""
    dtype = H.dtype
    eps = jnp.finfo(_real_dtype(dtype)).eps

    v_k = tree_map(lambda Vl: Vl[k], V)
    w = M(A(v_k))
    w_pre = tree_norm(w)
    tol_k = eps * w_pre  # breakdown threshold from pre-orthog norm
    w, h = _iterative_classical_gram_schmidt(V, w, kplus=k + 1,
                                             x_norm=w_pre)
    unit_w, w_norm = _safe_normalize(w, thresh=tol_k)
    V = tree_map(
        lambda Vl, ul: Vl.at[k + 1].set(ul.astype(Vl.dtype)), V, unit_w
    )
    h = h[:H.shape[1]].astype(dtype)  # trailing axis may be block-padded
    h = h.at[k + 1].set(w_norm.astype(dtype))
    H = H.at[k, :].set(h)
    breakdown = w_norm == 0.0
    return V, H, breakdown


def _gauss_jordan_solve(G, c):
    """Solve G y = c by Gauss-Jordan elimination without pivoting.

    Used for the small (restart × restart) SPD normal-equation system,
    built from elementary ops inside the jitted cycle."""
    m = G.shape[0]
    aug = jnp.concatenate([G, c[:, None]], axis=1)

    def elim(i, aug):
        pivot = aug[i, i]
        safe = jnp.where(pivot != 0, pivot, jnp.ones((), aug.dtype))
        row = aug[i] / safe
        factors = aug[:, i].at[i].set(0.0)
        aug = aug - factors[:, None] * row[None, :]
        return aug.at[i].set(row)

    aug = lax.fori_loop(0, m, elim, aug)
    return aug[:, m]


def _upper_triangular_solve(R, c):
    """Back-substitution for upper-triangular R (zero pivots give 0)."""
    m = R.shape[0]

    def body(k, y):
        i = m - 1 - k
        # y[j<=i] is still zero and R[i, j<i] == 0, so the dot spans j > i.
        num = c[i] - jnp.dot(R[i], y, precision=lax.Precision.HIGHEST)
        piv = R[i, i]
        safe = jnp.where(piv != 0, piv, jnp.ones((), R.dtype))
        return y.at[i].set(num / safe)

    return lax.fori_loop(0, m, body, jnp.zeros_like(c))


def _matmul(a, b):
    """Full-precision product: no TF32 on the GPU (an f32 Gram matrix in
    TF32 squares an already-truncated condition number)."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def _lstsq_normal(H_kxk1, beta, restart):
    """Solve min_y || beta*e1 - H^T y || via normal equations
    (reference `_lstsq`, :391-428). H_kxk1 is (restart, restart+1) holding
    H^T; the system matrix is Hm = H_kxk1^T (restart+1, restart)."""
    Hm = H_kxk1.T  # (restart+1, restart)
    rhs = jnp.zeros((restart + 1,), Hm.dtype).at[0].set(beta)
    G = _matmul(Hm.conj().T, Hm)  # (restart, restart)
    # Tiny jitter guards exact-breakdown (all-zero) columns.
    eps = jnp.finfo(_real_dtype(Hm.dtype)).eps
    G = G + jnp.eye(restart, dtype=G.dtype) * (eps * jnp.trace(G).real)
    c = _matmul(Hm.conj().T, rhs)
    return _gauss_jordan_solve(G, c)


def _lstsq_qr(H_kxk1, beta, restart):
    """Backward-stable lstsq via Householder QR.

    Used for the 32-bit (and narrower) batched cycles: the normal
    equations square cond(H), so for cond(A) past ~1/sqrt(eps_f32) ≈ 4e3
    the f32 Gram matrix carries no information and the cycle's true
    residual stalls far above the ε·cond(A) floor a backward-stable
    solve attains (f32 defect-correction sweeps on the cond≈1e5 1-D
    Laplacian collapsed to 0.9× reduction per sweep; with QR they
    recover ~6e-3). 16-bit inputs are computed in f32. f64 keeps the
    Gauss-Jordan normal equations (eps_f64·cond² is fine through
    cond ~ 1e7)."""
    Hm = H_kxk1.T  # (restart+1, restart)
    compute_dtype = Hm.dtype
    if not jnp.issubdtype(compute_dtype, jnp.complexfloating) \
            and jnp.finfo(compute_dtype).bits < 32:
        compute_dtype = jnp.float32
    Hc = Hm.astype(compute_dtype)
    rhs = jnp.zeros((restart + 1,), compute_dtype).at[0].set(
        beta.astype(compute_dtype))
    Q, R = jnp.linalg.qr(Hc, mode="reduced")
    c = _matmul(Q.conj().T, rhs)
    # _upper_triangular_solve guards zero pivots (exact-breakdown columns
    # give R[i, i] == 0 and harmlessly yield y[i] == 0)
    return _upper_triangular_solve(R, c).astype(H_kxk1.dtype)


class _GmresBatchedCarry(NamedTuple):
    V: Any
    H: jax.Array
    breakdown: jax.Array
    k: jax.Array


def _gmres_batched(A, b, x0, unit_residual, residual_norm, ptol, restart, M):
    """One restart cycle, batched solve method (reference :431-493):
    run the full Arnoldi sweep, then solve one least-squares problem."""
    dtype = _float_dtype(b)
    pad_cols = -(-(restart + 1) // _PROJ_BLOCK) * _PROJ_BLOCK - 1
    V0 = tree_map(
        lambda u: jnp.pad(u[None], [(0, pad_cols)] + [(0, 0)] * u.ndim),
        unit_residual,
    )
    H0 = jnp.zeros((restart, restart + 1), dtype)

    def cond(c: _GmresBatchedCarry):
        return (c.k < restart) & jnp.logical_not(c.breakdown)

    def body(c: _GmresBatchedCarry):
        V, H, brk = c.V, c.H, c.breakdown
        V, H, brk = _kth_arnoldi_iteration(c.k, A, M, V, H)
        return _GmresBatchedCarry(V, H, brk, c.k + 1)

    carry = lax.while_loop(
        cond, body,
        _GmresBatchedCarry(V0, H0, jnp.array(False), jnp.array(0, jnp.int32)),
    )
    if jnp.issubdtype(dtype, jnp.complexfloating) \
            or jnp.finfo(dtype).bits > 32:
        y = _lstsq_normal(carry.H, residual_norm.astype(dtype), restart)
    else:
        y = _lstsq_qr(carry.H, residual_norm.astype(dtype), restart)
    dx = tree_map(
        lambda Vl: jnp.einsum(
            "k...,k->...", Vl[:restart], y.astype(Vl.dtype),
            precision=lax.Precision.HIGHEST,
        ),
        carry.V,
    )
    x = tree_add(x0, dx)
    residual = M(tree_sub(b, A(x)))
    unit_residual, residual_norm = _safe_normalize(residual)
    return x, unit_residual, residual_norm


class _GmresIncCarry(NamedTuple):
    V: Any
    R: jax.Array          # (restart, restart) upper-triangular factor
    beta_vec: jax.Array   # (restart + 1,)
    givens: jax.Array     # (restart, 2) [cs, sn]
    err: jax.Array
    breakdown: jax.Array
    k: jax.Array


def _givens_rotation(a, b):
    """cs, sn zeroing b (reference `_givens_rotation`, :508-518)."""
    denom = jnp.sqrt(jnp.abs(a) ** 2 + jnp.abs(b) ** 2)
    safe = denom > 0
    denom_ = jnp.where(safe, denom, 1.0)
    cs = jnp.where(safe, a / denom_, jnp.ones_like(a))
    sn = jnp.where(safe, -b / denom_, jnp.zeros_like(b))
    return cs, sn


def _apply_givens_rotations(H_col, givens, k, restart):
    """Apply rotations 0..k-1 to the new column, then compute and apply the
    k-th rotation (reference :521-554/:599-623)."""

    def body(i, col):
        cs, sn = givens[i, 0], givens[i, 1]
        hi = cs.conj() * col[i] - sn.conj() * col[i + 1]
        hip1 = sn * col[i] + cs * col[i + 1]
        new_col = col.at[i].set(hi).at[i + 1].set(hip1)
        return jnp.where(i < k, new_col, col)

    # static unrolled-bounds fori_loop; masked beyond k
    col = lax.fori_loop(0, restart, body, H_col)
    cs_k, sn_k = _givens_rotation(col[k], col[k + 1])
    rk = cs_k.conj() * col[k] - sn_k.conj() * col[k + 1]
    col = col.at[k].set(rk).at[k + 1].set(0.0)
    return col, cs_k, sn_k


def _gmres_incremental(A, b, x0, unit_residual, residual_norm, ptol, restart, M):
    """One restart cycle, incremental (Givens QR) method (reference :557-638).
    Gives a free running residual estimate and in-cycle early exit."""
    dtype = _float_dtype(b)
    pad_cols = -(-(restart + 1) // _PROJ_BLOCK) * _PROJ_BLOCK - 1
    V0 = tree_map(
        lambda u: jnp.pad(u[None], [(0, pad_cols)] + [(0, 0)] * u.ndim),
        unit_residual,
    )
    R0 = jnp.zeros((restart, restart), dtype)
    beta0 = jnp.zeros((restart + 1,), dtype).at[0].set(
        residual_norm.astype(dtype))
    givens0 = jnp.zeros((restart, 2), dtype)
    err0 = jnp.abs(beta0[0])

    def cond(c: _GmresIncCarry):
        return (c.k < restart) & (c.err > ptol) & jnp.logical_not(c.breakdown)

    def body(c: _GmresIncCarry):
        H_tmp = jnp.zeros((restart, restart + 1), dtype)
        V, H_tmp, brk = _kth_arnoldi_iteration(c.k, A, M, c.V, H_tmp)
        H_col = H_tmp[c.k, :]  # (restart+1,)
        col, cs_k, sn_k = _apply_givens_rotations(H_col, c.givens, c.k, restart)
        R = c.R.at[:, c.k].set(col[:restart])
        givens = c.givens.at[c.k, 0].set(cs_k).at[c.k, 1].set(sn_k)
        bk = cs_k.conj() * c.beta_vec[c.k] - sn_k.conj() * c.beta_vec[c.k + 1]
        bk1 = sn_k * c.beta_vec[c.k] + cs_k * c.beta_vec[c.k + 1]
        beta_vec = c.beta_vec.at[c.k].set(bk).at[c.k + 1].set(bk1)
        err = jnp.abs(bk1)
        return _GmresIncCarry(V, R, beta_vec, givens, err, brk, c.k + 1)

    carry = lax.while_loop(
        cond, body,
        _GmresIncCarry(V0, R0, beta0, givens0, err0, jnp.array(False),
                       jnp.array(0, jnp.int32)),
    )
    k = carry.k
    # Pad R's unused tail with identity so one static-shape triangular solve
    # yields y with zeros past k (avoids a dynamic-size solve under jit).
    idx = jnp.arange(restart)
    diag_mask = idx >= k
    R = carry.R + jnp.diag(jnp.where(diag_mask, 1.0, 0.0).astype(dtype))
    rhs = jnp.where(idx < k, carry.beta_vec[:restart], 0.0).astype(dtype)
    y = _upper_triangular_solve(R, rhs)
    dx = tree_map(
        lambda Vl: jnp.einsum(
            "k...,k->...", Vl[:restart], y.astype(Vl.dtype),
            precision=lax.Precision.HIGHEST,
        ),
        carry.V,
    )
    x = tree_add(x0, dx)
    residual = M(tree_sub(b, A(x)))
    unit_residual, residual_norm = _safe_normalize(residual)
    return x, unit_residual, residual_norm


class _GmresCarry(NamedTuple):
    x: Any
    unit_residual: Any
    residual_norm: jax.Array
    k: jax.Array


def _gmres_solve(A, b, x0, atol_, ptol, restart, maxiter, M, cycle_fn):
    """Restart loop (reference `_gmres_solve_with_method`, :787-803)."""
    residual = M(tree_sub(b, A(x0)))
    unit_residual, residual_norm = _safe_normalize(residual)

    def cond(c: _GmresCarry):
        return (c.k < maxiter) & (c.residual_norm > atol_)

    def body(c: _GmresCarry):
        x, ur, rn = cycle_fn(A, b, c.x, c.unit_residual, c.residual_norm,
                             ptol, restart, M)
        return _GmresCarry(x, ur, rn, c.k + 1)

    init = _GmresCarry(x0, unit_residual, residual_norm,
                       jnp.array(0, jnp.int32))
    final = lax.while_loop(cond, body, init)
    return final.x, final.k


def gmres(A: Operator, b: Any, x0: Optional[Any] = None, *, tol: float = 1e-5,
          atol: float = 0.0, restart: int = 20, maxiter: Optional[int] = None,
          M: Optional[Operator] = None,
          solve_method: str = "batched") -> Tuple[Any, jax.Array]:
    """GMRES with restarts (reference `gmres`, torch_sparse_linalg.py:641-784).

    solve_method: 'batched' (one least-squares per cycle, the
    default) or 'incremental' (Givens QR with in-cycle early exit).
    """
    x, info, _, _ = gmres_full(A, b, x0, tol=tol, atol=atol, restart=restart,
                               maxiter=maxiter, M=M, solve_method=solve_method)
    return x, info


def gmres_full(A: Operator, b: Any, x0: Optional[Any] = None, *,
               tol: float = 1e-5, atol: float = 0.0, restart: int = 20,
               maxiter: Optional[int] = None, M: Optional[Operator] = None,
               solve_method: str = "batched"):
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    size = tree_size(b)
    restart = min(restart, size)
    if maxiter is None:
        maxiter = 10 * size  # same default as reference (:719-721)
    A_fn = as_matvec(A)
    M_fn = _identity if M is None else as_matvec(M)

    if solve_method == "batched":
        cycle_fn = _gmres_batched
    elif solve_method == "incremental":
        cycle_fn = _gmres_incremental
    else:
        raise ValueError(f"unsupported solve_method: {solve_method}")

    b_norm = tree_norm(b)
    atol_ = jnp.maximum(tol * b_norm, atol)
    Mb = M_fn(b)
    Mb_norm = tree_norm(Mb)
    ptol = Mb_norm * jnp.minimum(1.0, atol_ / jnp.where(b_norm > 0, b_norm, 1.0))

    x, k = _gmres_solve(A_fn, b, x0, atol_, ptol, restart, maxiter, M_fn,
                        cycle_fn)

    res_norm = tree_norm(M_fn(tree_sub(b, A_fn(x))))
    relaxed_atol = atol_ * _final_check_relax(_real_dtype(_float_dtype(b)))
    failed = (~jnp.isfinite(tree_norm(x))) | (~jnp.isfinite(res_norm)) \
        | (res_norm > relaxed_atol)
    info = jnp.where(failed, -1, 0).astype(jnp.int32)
    return x, info, k, res_norm
