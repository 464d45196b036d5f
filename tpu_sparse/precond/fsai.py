"""FSAI — factorized sparse approximate inverse preconditioner.

The parallel member of the IC(0)/ILU(0) family from SURVEY.md §7
stage 6 for *general* SPD matrices: an incomplete Cholesky needs two
sparse triangular solves per application — O(n) dependent steps, hostile
to a wide vector machine (the DIA-only `ilu0_preconditioner` in precond/poly.py pays
exactly that scan cost). FSAI instead builds an explicit sparse
G ≈ L⁻¹ (A ≈ LLᵀ) on the lower-triangular pattern of A (optionally of
A², "FSAI(2)"), so M = GᵀG ≈ A⁻¹ and every application is two SpMVs
through the same SpMV kernels the solvers already use — fully
parallel, no data-dependent recursion, and it rides jit/vmap like any
container. M is SPD by construction, so plain CG (not FCG) is safe.

Setup runs host-side with vectorized numpy (like the AMG hierarchy
setup): row i solves the k×k dense system A[P_i, P_i] ĝ = e_k over its
pattern P_i = {j ≤ i : (i,j) ∈ pattern}, then scales ĝ by 1/√ĝ_k so
diag(G A Gᵀ) = 1. Rows are grouped by pattern size and solved as one
batched ``np.linalg.solve`` per group; A-value lookups vectorize through
one ``searchsorted`` over the composite (row, col) key table.

Reference capability analogue: the preconditioner families AMGX exposes
around its Krylov solvers (``/root/reference/src/pytorch_sparse_solver/
module_b/torch_amgx.py:50-73``); cuSPARSE's csrilu0/csric0 in spirit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from jax.tree_util import Partial

__all__ = ["fsai_setup", "fsai_preconditioner"]


def _pattern_lower(S, pattern_power: int):
    """Lower-triangular (incl. diagonal) boolean pattern of S^p."""
    import scipy.sparse as sp

    # int32 counts: rows sharing >=128 neighbours would wrap int8 and an
    # exact multiple of 256 would silently drop the pattern entry.
    base = (S != 0).astype(np.int32).tocsr()
    patt = base
    for _ in range(pattern_power - 1):
        patt = ((patt @ base) != 0).astype(np.int32).tocsr()
    n = S.shape[0]
    P = (sp.tril(patt, 0) + sp.eye(n, dtype=np.int8, format="csr"))
    P = (P != 0).astype(np.int8).tocsr()
    P.sort_indices()
    return P


def fsai_setup(A, *, pattern_power: int = 1,
               lookup_budget: int = 1 << 24) -> Tuple:
    """Compute the FSAI factor G ≈ L⁻¹ (lower triangular, host-side).

    Returns ``(G, Gt)`` as CSR containers (Gt = Gᵀ, prebuilt so the apply
    never transposes on the fly). ``pattern_power=2`` uses the lower
    pattern of A² — denser, stronger (FSAI(2)).
    """
    from tpu_sparse.sparse.convert import csr_from_arrays, to_scipy_csr

    S = to_scipy_csr(A).astype(np.float64).tocsr()
    S.sort_indices()
    n = S.shape[0]
    P = _pattern_lower(S, pattern_power)
    indptr, indices = P.indptr, P.indices

    # composite-key table for vectorized A[p, q] lookups (missing → 0)
    arows = np.repeat(np.arange(n, dtype=np.int64), np.diff(S.indptr))
    keys = arows * n + S.indices
    avals = S.data

    k_row = np.diff(indptr)
    Gdata = np.zeros(P.nnz)
    for k in np.unique(k_row):
        rows_k = np.flatnonzero(k_row == k).astype(np.int64)
        kk = int(k)
        nc_max = max(1, lookup_budget // max(kk * kk, 1))
        e = np.zeros((kk, 1))
        e[-1, 0] = 1.0
        for c0 in range(0, rows_k.size, nc_max):
            rk = rows_k[c0:c0 + nc_max]
            Pk = indices[indptr[rk][:, None] + np.arange(kk)]  # (nc, k)
            q = (Pk[:, :, None].astype(np.int64) * n
                 + Pk[:, None, :]).ravel()
            pos = np.searchsorted(keys, q)
            posc = np.minimum(pos, keys.size - 1)
            Bv = np.where(keys[posc] == q, avals[posc], 0.0)
            Bv = Bv.reshape(rk.size, kk, kk)
            try:
                g = np.linalg.solve(Bv, np.broadcast_to(
                    e, (rk.size, kk, 1)))[..., 0]
            except np.linalg.LinAlgError:
                # ridge-regularize (numerically singular local systems)
                tr = np.einsum("bii->b", Bv) / kk
                Bv = Bv + ((1e-10 * np.maximum(tr, 1.0))[:, None, None]
                           * np.eye(kk))
                g = np.linalg.solve(Bv, np.broadcast_to(
                    e, (rk.size, kk, 1)))[..., 0]
            d = g[:, -1]
            # ĝ_k = (A[P,P]⁻¹)_kk > 0 for SPD input; guard the indefinite
            # case by falling back to diagonal scaling for that row
            bad = ~(d > 0)
            if bad.any():
                g[bad] = 0.0
                diag_a = Bv[bad, kk - 1, kk - 1]
                g[bad, -1] = 1.0 / np.sqrt(np.where(diag_a > 0, diag_a, 1.0))
                d = np.where(bad, 1.0, d)
            g = g / np.sqrt(d)[:, None]
            sl = (indptr[rk][:, None] + np.arange(kk)).ravel()
            Gdata[sl] = g.ravel()

    import scipy.sparse as sp

    dtype = np.asarray(S.data).dtype if not hasattr(A, "dtype") \
        else np.dtype(A.dtype)
    Gs = sp.csr_matrix((Gdata.astype(dtype), indices.copy(),
                        indptr.copy()), shape=(n, n))
    Gs.eliminate_zeros()
    Gts = Gs.T.tocsr()
    Gts.sort_indices()
    G = csr_from_arrays(Gs.data, Gs.indices, Gs.indptr, (n, n))
    Gt = csr_from_arrays(Gts.data, Gts.indices, Gts.indptr, (n, n))
    return G, Gt


def _fsai_apply(G, Gt, v):
    from tpu_sparse.kernels import spmm, spmv

    if getattr(v, "ndim", 1) == 2:
        return spmm(Gt, spmm(G, v))
    return spmv(Gt, spmv(G, v))


def fsai_preconditioner(A, *, pattern_power: int = 1,
                        optimize: bool = True) -> Partial:
    """M = GᵀG ≈ A⁻¹ (SPD) as a jit-safe ``Partial``.

    ``optimize=True`` promotes G/Gᵀ through ``to_tpu_operator`` (format
    choice: DIA/CWELL/BELL/CSR) for the two SpMVs per application.
    """
    G, Gt = fsai_setup(A, pattern_power=pattern_power)
    if optimize:
        from tpu_sparse.sparse.optimize import to_tpu_operator

        G = to_tpu_operator(G)
        Gt = to_tpu_operator(Gt)
    return Partial(_fsai_apply, G, Gt)
