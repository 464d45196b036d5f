"""Banded direct solvers (replacement for the cuDSS backend).

The reference's Module C is `torch.sparse.spsolve` → cuDSS sparse LU
(cudss_solver.py:176-252); its actual test/bench coverage is tridiagonal and
small-Poisson systems (test_module_c.py:96-179). Here (SURVEY.md §7
stage 8):

* `thomas_solve` — tridiagonal LU (Thomas algorithm) as a `lax.scan`;
  O(n) work, numerically stable for the diagonally-dominant/SPD systems it
  is dispatched to.
* `banded_lu_solve` — general banded LU (no pivoting) as a `lax.scan` over
  rows with a (w+1, 2w+1) sliding elimination window; correct for
  diagonally-dominant / SPD bands (documented limitation — pivoting would
  break the static band structure).
* `pcr_solve` / `block_pcr_solve` — log-depth cyclic reduction for large
  tridiagonal / banded systems, where the scans' per-row steps dominate.
* `dense_solve` — XLA dense LU for small or unstructured systems.

All run fully on device with static shapes.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from tpu_sparse.sparse.containers import DIA


def _dia_band(A: DIA, w: int) -> jax.Array:
    """Re-pack DIA data into band layout band[i, w + o] = A[i, i + o]."""
    n = A.shape[0]
    band = jnp.zeros((n, 2 * w + 1), dtype=A.dtype)
    for d, o in enumerate(A.offsets):
        band = band.at[:, w + o].set(A.data[d])
    return band


def thomas_solve(A: DIA, b: jax.Array) -> jax.Array:
    """Tridiagonal solve via the Thomas algorithm (two lax.scans)."""
    n = A.shape[0]
    w = A.bandwidth
    assert w <= 1, "thomas_solve requires a tridiagonal matrix"
    band = _dia_band(A, 1)  # columns: sub, diag, super
    sub, diag, sup = band[:, 0], band[:, 1], band[:, 2]

    # Forward sweep: c'[i] = sup[i]/(diag[i]-sub[i]c'[i-1]), likewise d'.
    def fwd(carry, inp):
        c_prev, d_prev = carry
        s, dg, sp, bb = inp
        denom = dg - s * c_prev
        c = sp / denom
        d = (bb - s * d_prev) / denom
        return (c, d), (c, d)

    zero = jnp.zeros((), b.dtype)
    (_, _), (cs, ds) = lax.scan(fwd, (zero, zero), (sub, diag, sup, b))

    # Back substitution: x[i] = d'[i] - c'[i] x[i+1]
    def bwd(x_next, inp):
        c, d = inp
        x = d - c * x_next
        return x, x

    _, xs_rev = lax.scan(bwd, zero, (cs, ds), reverse=True)
    return xs_rev


def pcr_solve(A: DIA, b: jax.Array) -> jax.Array:
    """Tridiagonal solve by parallel cyclic reduction.

    log2(n) fully-vectorized elimination passes (each combines every row
    with its ±2^k neighbors) instead of the Thomas algorithm's n sequential
    scan steps — the direct solve for large tridiagonal systems.
    Stable for diagonally-dominant/SPD systems (same class as
    thomas_solve).
    """
    n = A.shape[0]
    assert A.bandwidth <= 1, "pcr_solve requires a tridiagonal matrix"
    band = _dia_band(A, 1)
    a, d, c = band[:, 0], band[:, 1], band[:, 2]  # sub, diag, sup
    rhs = b

    def shift(v, k):
        """w[i] = v[i+k] with zeros outside."""
        if k > 0:
            return jnp.concatenate([v[k:], jnp.zeros((k,), v.dtype)])
        return jnp.concatenate([jnp.zeros((-k,), v.dtype), v[:k]])

    steps = max(1, int(math.ceil(math.log2(max(n, 2)))))
    for s in range(steps):
        k = 1 << s
        d_m = shift(d, -k)
        d_p = shift(d, k)
        safe_m = jnp.where(d_m != 0, d_m, jnp.ones((), d.dtype))
        safe_p = jnp.where(d_p != 0, d_p, jnp.ones((), d.dtype))
        alpha = -a / safe_m          # couples row i with row i-k
        beta = -c / safe_p           # couples row i with row i+k
        d = d + alpha * shift(c, -k) + beta * shift(a, k)
        rhs = rhs + alpha * shift(rhs, -k) + beta * shift(rhs, k)
        a = alpha * shift(a, -k)
        c = beta * shift(c, k)
    safe_d = jnp.where(d != 0, d, jnp.ones((), d.dtype))
    return rhs / safe_d


def _band_blocks(A: DIA, s: int):
    """View a banded matrix as block tridiagonal with s >= bandwidth.

    Returns (D, L, U, m, N): blocks of shape (m, s, s) with
    D[k] = A[ks:(k+1)s, ks:(k+1)s], L[k] the coupling to block k-1, U[k]
    to block k+1; rows n..N-1 are identity padding.
    """
    n = A.shape[0]
    m = (n + s - 1) // s
    N = m * s
    dt = A.dtype
    D = jnp.zeros((m, s, s), dt)
    L = jnp.zeros((m, s, s), dt)
    U = jnp.zeros((m, s, s), dt)
    rows = jnp.arange(n)
    for d, o in enumerate(A.offsets):
        v = jnp.where((rows + o >= 0) & (rows + o < n), A.data[d][:n], 0)
        vp = jnp.pad(v, (0, N - n))
        if o == 0:
            vp = vp.at[n:].set(jnp.ones((), dt))  # identity padding rows
        vb = vp.reshape(m, s)
        for p in range(s):
            q = p + o
            if 0 <= q < s:
                D = D.at[:, p, q].set(vb[:, p])
            elif q >= s:
                U = U.at[:, p, q - s].set(vb[:, p])
            else:
                L = L.at[:, p, q + s].set(vb[:, p])
    return D, L, U, m, N


def _mm(X, Y):
    """Batched block product at full f32/f64 precision (no TF32)."""
    return jnp.matmul(X, Y, precision=lax.Precision.HIGHEST)


def block_pcr_solve(A: DIA, b: jax.Array,
                    block_size: int | None = None) -> jax.Array:
    """Banded solve by block parallel cyclic reduction.

    The banded matrix (bandwidth w >= 2) is viewed as block tridiagonal
    with block size s >= w; ceil(log2(m)) fully-batched elimination passes
    (each couples every block row with its +-2^k neighbors through
    D^{-1}-scaled products) replace the banded LU's n sequential scan
    steps. All the work is (m, s, s) batched solves and matmuls at
    O(n s^2 log m) FLOPs vs the scan's O(n w^2) sequential ones: a
    latency-for-FLOPs trade. Stable for block
    diagonally-dominant / SPD systems (the same class banded_lu_solve is
    documented for; cyclic reduction preserves block diagonal dominance).

    Replaces the cuDSS capability (reference cudss_solver.py:176-252) for
    large banded systems where the sequential scan is latency-bound.
    """
    n = A.shape[0]
    w = A.bandwidth
    assert w >= 1, "block_pcr_solve requires a banded matrix"
    s = int(block_size) if block_size is not None else max(w, 8)
    assert s >= w, "block size must cover the bandwidth"
    D, L, U, m, N = _band_blocks(A, s)
    r = jnp.pad(b, (0, N - n)).reshape(m, s, 1)

    def shift(X, k):
        """Y[i] = X[i + k], zero blocks outside [0, m)."""
        if k >= X.shape[0]:
            return jnp.zeros_like(X)
        z = jnp.zeros((abs(k),) + X.shape[1:], X.dtype)
        if k > 0:
            return jnp.concatenate([X[k:], z], axis=0)
        return jnp.concatenate([z, X[:k]], axis=0)

    steps = max(1, int(math.ceil(math.log2(max(m, 2)))))
    for sidx in range(steps):
        k = 1 << sidx
        # D^{-1}-scaled couplings of every block row, batched.
        sol = jnp.linalg.solve(D, jnp.concatenate([L, U, r], axis=-1))
        DL, DU, Dr = sol[..., :s], sol[..., s:2 * s], sol[..., 2 * s:]
        DL_m, DU_m, Dr_m = shift(DL, -k), shift(DU, -k), shift(Dr, -k)
        DL_p, DU_p, Dr_p = shift(DL, k), shift(DU, k), shift(Dr, k)
        D = D - _mm(L, DU_m) - _mm(U, DL_p)
        r = r - _mm(L, Dr_m) - _mm(U, Dr_p)
        L = -_mm(L, DL_m)
        U = -_mm(U, DU_p)
    x = jnp.linalg.solve(D, r)
    return x.reshape(-1)[:n]


def banded_lu_factor(A: DIA) -> Tuple[jax.Array, jax.Array, int]:
    """LU-factorize a banded matrix without pivoting.

    Returns (L_band, U_band, w): L_band[i, k-1] is the multiplier of row i
    w.r.t. pivot row i-k (k = 1..w); U_band[i, j] is U[i, i+j] (j = 0..w).
    """
    n = A.shape[0]
    w = A.bandwidth
    band = _dia_band(A, w)  # (n, 2w+1)

    # Sliding window of the next (w+1) partially-eliminated rows, aligned so
    # window[k, w + j] = current coefficient of row (i+k) at column (i+k+j-w)
    # ... we keep rows in their own band coordinates and shift on entry.
    pad = jnp.zeros((w, 2 * w + 1), band.dtype)
    rows = jnp.concatenate([band, pad], axis=0)  # rows i..n-1 plus padding

    def step(window, incoming_row):
        # window: (w+1, 2w+1); window[0] is the fully-eliminated pivot row.
        pivot_row = window[0]
        pivot = pivot_row[w]
        safe_pivot = jnp.where(pivot != 0, pivot, jnp.ones((), band.dtype))
        # Multiplier for row k (k=1..w): its coefficient at the pivot column
        # sits at band position w - k.
        ks = jnp.arange(1, w + 1)
        mults = window[ks, w - ks] / safe_pivot  # (w,)

        # Subtract m_k * pivot_row, shifted left by k in row-k coordinates:
        # row k column (i + j) is at position w + j - k.
        def shift_left(k):
            return lax.dynamic_slice(
                jnp.pad(pivot_row, (0, w)), (k,), (2 * w + 1,))

        shifted = jax.vmap(shift_left)(ks)  # (w, 2w+1)
        updated = window[1:] - mults[:, None] * shifted

        out_L = mults  # multipliers of rows i+1..i+w w.r.t. pivot i
        out_U = pivot_row[w:]  # U[i, i..i+w]

        new_window = jnp.concatenate(
            [updated, incoming_row[None, :]], axis=0)
        return new_window, (out_L, out_U)

    init_window = rows[: w + 1]
    incoming = jnp.concatenate(
        [rows[w + 1 :], jnp.zeros((1, 2 * w + 1), band.dtype)], axis=0)
    _, (Ls, Us) = lax.scan(step, init_window, incoming)
    # Ls[i, k-1] = multiplier eliminating row i+k against pivot i.
    # Convert to row-oriented: L_row[i, k-1] = multiplier of row i w.r.t.
    # pivot i-k  →  L_row[i, k-1] = Ls[i-k, k-1].
    def gather_L(k):
        col = Ls[:, k - 1]
        return jnp.concatenate([jnp.zeros((k,), col.dtype), col[: n - k]])

    L_rows = jnp.stack([gather_L(k) for k in range(1, w + 1)], axis=1)
    return L_rows, Us, w


def banded_lu_solve(A: DIA, b: jax.Array) -> jax.Array:
    """Solve banded A x = b via LU + two substitution scans."""
    L_rows, U_rows, w = banded_lu_factor(A)
    n = A.shape[0]

    # Forward substitution: y[i] = b[i] - sum_k L_row[i,k-1] * y[i-k]
    def fwd(carry, inp):
        # carry: last w values of y (carry[-1] is y[i-1])
        Lr, bb = inp
        yi = bb - jnp.sum(Lr * carry[::-1])
        new_carry = jnp.concatenate([carry[1:], yi[None]])
        return new_carry, yi

    y0 = jnp.zeros((w,), b.dtype)
    _, y = lax.scan(fwd, y0, (L_rows, b))

    # Back substitution: x[i] = (y[i] - sum_{j=1..w} U[i,j] x[i+j]) / U[i,0]
    def bwd(carry, inp):
        # carry: next w values of x (carry[0] is x[i+1])
        Ur, yi = inp
        xi = (yi - jnp.sum(Ur[1:] * carry)) / Ur[0]
        new_carry = jnp.concatenate([xi[None], carry[:-1]])
        return new_carry, xi

    x0 = jnp.zeros((w,), b.dtype)
    _, x_rev = lax.scan(bwd, x0, (U_rows, y), reverse=True)
    return x_rev


def dense_solve(A, b: jax.Array) -> jax.Array:
    """Dense LU solve (XLA / cuSOLVER) for small or unstructured systems."""
    Ad = A.todense() if hasattr(A, "todense") else jnp.asarray(A)
    return jnp.linalg.solve(Ad, b)
