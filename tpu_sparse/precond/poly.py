"""Polynomial and incomplete-factorization preconditioners.

Completes the preconditioner family from SURVEY.md §7 stage 6
("jacobi, IC/ILU(0)-style, AMG"):

* `chebyshev_preconditioner` — degree-k Chebyshev polynomial approximation
  of A⁻¹ on the L1-scaled spectrum. Reduction-free (pure SpMV+axpy), the
  most parallel general preconditioner.
* `neumann_preconditioner` — truncated Neumann series (I - D⁻¹A)ᵏ; cheaper
  setup, weaker smoothing.
* `ilu0_preconditioner` — ILU(0) for DIA stencil matrices: incomplete LU
  restricted to the stored diagonals, factorized with one `lax.scan` and
  applied with two substitution scans. The substitutions are sequential
  (O(n) scan steps) — prefer Chebyshev/AMG for large n; ILU(0) is
  provided for capability parity and small/medium systems.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.tree_util import Partial

from tpu_sparse.kernels import spmv
from tpu_sparse.precond.jacobi import l1_jacobi_diag
from tpu_sparse.sparse.containers import DIA

# The factories below are lru_cached so repeated preconditioner
# construction returns the SAME function object — jit caches key on the
# Partial's function identity, and a fresh closure per call would force a
# recompile for every solve (same fix as amg._make_vcycle_apply).


@functools.lru_cache(maxsize=64)
def _make_cheb_apply(degree: int, lam_ratio: float):
    from tpu_sparse.precond.amg import _chebyshev_smooth

    def apply(A_, dinv_, v):
        # shared three-term recurrence from the AMG Chebyshev smoother,
        # started from x0 = 0
        return _chebyshev_smooth(A_, dinv_, jnp.zeros_like(v), v,
                                 degree=degree, lam_max=1.0,
                                 lam_ratio=lam_ratio)

    return apply


def chebyshev_preconditioner(A, degree: int = 4,
                             lam_ratio: float = 30.0) -> Partial:
    """M ≈ A⁻¹ as a degree-``degree`` Chebyshev polynomial in A (SPD)."""
    dinv = 1.0 / l1_jacobi_diag(A)
    return Partial(_make_cheb_apply(degree, float(lam_ratio)), A, dinv)


@functools.lru_cache(maxsize=64)
def _make_neumann_apply(terms: int):
    def apply(A_, dinv_, v):
        x = dinv_ * v
        acc = x
        for _ in range(terms - 1):
            x = x - dinv_ * spmv(A_, x)
            acc = acc + x
        return acc

    return apply


def neumann_preconditioner(A, terms: int = 3) -> Partial:
    """M = Σ_{k<terms} (I - D⁻¹A)ᵏ D⁻¹ (truncated Neumann series)."""
    from tpu_sparse.precond.jacobi import diagonal

    d = diagonal(A)
    dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0), 1.0)
    return Partial(_make_neumann_apply(terms), A, dinv)


def ilu0_factor(A: DIA) -> Tuple[DIA, DIA]:
    """ILU(0) of a DIA matrix: L (unit lower) and U on A's own pattern.

    Row-by-row IKJ elimination restricted to stored diagonals, as one
    lax.scan over rows (each row depends on the previous ``w`` rows).
    """
    offsets = A.offsets
    n = A.shape[0]
    w = A.bandwidth
    neg = sorted([o for o in offsets if o < 0])
    pos = sorted([o for o in offsets if o > 0])
    if 0 not in offsets:
        raise ValueError("ILU(0) needs a stored main diagonal")
    # band[i, w+o] = A[i, i+o]
    from tpu_sparse.direct.banded import _dia_band

    band = _dia_band(A, w)

    def step(carry, row_i):
        # carry: last w factored rows in band coords (w, 2w+1)
        prev = carry
        row = row_i
        # IKJ order: eliminate against rows i-k for k = w..1 (prev[w-k])
        for k in range(w, 0, -1):
            if -k not in offsets:
                continue
            pivot_row = prev[w - k]  # factored row i-k
            piv = pivot_row[w]
            safe = jnp.where(piv != 0, piv, jnp.ones((), band.dtype))
            m = row[w - k] / safe
            # ILU(0): update only positions already in A's pattern.
            # Target offset o' in row i draws from the pivot row's U entry
            # at offset o' + k (must be a stored positive offset).
            for o_t in offsets:
                src = o_t + k
                if src <= 0 or src not in offsets or o_t == -k:
                    continue
                row = row.at[w + o_t].add(-m * pivot_row[w + src])
            row = row.at[w - k].set(m)  # store the L multiplier
        new_carry = jnp.concatenate([prev[1:], row[None, :]], axis=0)
        return new_carry, row

    init = jnp.zeros((w, 2 * w + 1), band.dtype)
    _, rows = lax.scan(step, init, band)
    # split factored band into L (strict lower + unit diag) and U
    L_data = []
    U_data = []
    L_offsets = [o for o in neg] + [0]
    U_offsets = [0] + [o for o in pos]
    for o in L_offsets:
        if o == 0:
            L_data.append(jnp.ones(n, band.dtype))
        else:
            L_data.append(rows[:, w + o])
    for o in U_offsets:
        U_data.append(rows[:, w + o])
    L = DIA(jnp.stack(L_data), tuple(L_offsets), A.shape)
    U = DIA(jnp.stack(U_data), tuple(U_offsets), A.shape)
    return L, U


def _banded_forward_sub(L: DIA, b):
    """Solve L y = b (unit lower, DIA) via lax.scan."""
    n = L.shape[0]
    neg = sorted([o for o in L.offsets if o < 0])
    w = -min(neg) if neg else 1
    coef = {o: L.data[L.offsets.index(o)] for o in neg}

    def step(carry, inp):
        i_vals, bb = inp  # i_vals: (w,) multipliers L[i, i-w..i-1]
        y = bb - jnp.sum(i_vals * carry)
        return jnp.concatenate([carry[1:], y[None]]), y

    # pack multipliers row-wise: m[i, k-1] = L[i, i-k] for k=w..1
    mults = jnp.zeros((n, w), L.dtype)
    for o in neg:
        mults = mults.at[:, w + o].set(coef[o])  # column w+o ↔ k=-o
    init = jnp.zeros((w,), L.dtype)
    _, y = lax.scan(step, init, (mults, b))
    return y


def _banded_backward_sub(U: DIA, y):
    """Solve U x = y (upper, DIA) via reverse lax.scan."""
    n = U.shape[0]
    pos = sorted([o for o in U.offsets if o > 0])
    w = max(pos) if pos else 1
    diag = U.data[U.offsets.index(0)]
    coefs = jnp.zeros((n, w), U.dtype)
    for o in pos:
        coefs = coefs.at[:, o - 1].set(U.data[U.offsets.index(o)])

    def step(carry, inp):
        c_row, yy, dg = inp  # carry: x[i+1..i+w]
        safe = jnp.where(dg != 0, dg, jnp.ones((), U.dtype))
        x = (yy - jnp.sum(c_row * carry)) / safe
        return jnp.concatenate([x[None], carry[:-1]]), x

    init = jnp.zeros((w,), U.dtype)
    _, x = lax.scan(step, init, (coefs, y, diag), reverse=True)
    return x


def _ilu0_apply(L_, U_, v):
    return _banded_backward_sub(U_, _banded_forward_sub(L_, v))


def ilu0_preconditioner(A: DIA) -> Partial:
    """M ≈ A⁻¹ from ILU(0) factors (stencil matrices)."""
    if not isinstance(A, DIA):
        raise ValueError(
            "ilu0 preconditioner requires a DIA (stencil) matrix; for "
            "general SPD patterns use 'fsai' (parallel apply) instead")
    L, U = ilu0_factor(A)
    return Partial(_ilu0_apply, L, U)
