"""Jit-composable general sparse direct solve (cuDSS capability class).

The reference reaches general sparse LU through `torch.sparse.spsolve`
(cuDSS inside libtorch, cudss_solver.py:107,176-252), which composes with
compiled graphs. Here the factor is computed once on the host and the
solves run on the device:

* **setup (host, eager, cached per matrix)** — scipy SuperLU factorizes
  A once: ``Pr A Pc = L U``. The factors are re-packed into a BLOCK form:
  dense (B, s, s) diagonal blocks plus the strictly-block-triangular
  remainder as a device sparse operator (CWELL, CWELLSeg or CSR).
* **solve (device, jit-composable)** — blocked substitution as a
  fixed-point iteration at block granularity:
  ``y ← D⁻¹(b − N y)`` where D = block diagonal (batched triangular
  solves) and N = block off-diagonal (one library SpMV per step). The
  iteration is EXACT after ``block_depth`` steps (blocks at dependency
  level ≤ k are exact after k steps and are fully recomputed, not
  accumulated, each step). block_depth ≤ B = n/s, typically ~10× fewer
  steps than the row-level depth, and every step is batched triangular
  solve + SpMV work instead of a row-by-row scatter.

Memory: the dense diagonal blocks cost 2·n·s floats (s=256 ⇒ 2 KB/row
f32); practical for the direct-solve regime (n up to ~10⁶). Larger
systems belong to the iterative methods.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

_BLOCK = 256  # B = n_pad / _BLOCK


def _block_levels(bi, bj, B: int) -> int:
    """Longest chain in the block dependency DAG (edges bj -> bi, bj != bi),
    visiting blocks in substitution order. bi/bj are the block coordinates
    of every off-diagonal entry (lower: bj < bi; upper: bj > bi after the
    caller flips the order)."""
    import numpy as np

    level = np.zeros(B, dtype=np.int64)
    # group parent levels per child block
    order = np.argsort(bi, kind="stable")
    bi, bj = bi[order], bj[order]
    starts = np.searchsorted(bi, np.arange(B))
    ends = np.searchsorted(bi, np.arange(B) + 1)
    for i in range(B):
        js = bj[starts[i]:ends[i]]
        if len(js):
            level[i] = 1 + level[js].max()
    return int(level.max()) + 1 if B else 1


def _pack_factor(T_scipy, n_pad: int, s: int, lower: bool, dtype):
    """Split a scipy triangular factor into dense (B, s, s) diagonal
    blocks (identity-padded) + the strictly-block-off part as scipy CSR
    (n_pad x n_pad), and compute the block depth."""
    import numpy as np
    import scipy.sparse as sp

    B = n_pad // s
    T = sp.coo_matrix(T_scipy)
    r, c, v = T.row, T.col, T.data
    same = (r // s) == (c // s)
    # dense diagonal blocks
    diag = np.zeros((B, s, s), dtype=np.float64)
    rd, cd, vd = r[same], c[same], v[same]
    diag[rd // s, rd % s, cd % s] = vd
    n = T.shape[0]
    pad_ids = np.arange(n, n_pad)
    diag[pad_ids // s, pad_ids % s, pad_ids % s] = 1.0
    # strictly block-off remainder
    ro, co, vo = r[~same], c[~same], v[~same]
    if lower:
        order = ro // s, co // s
    else:
        # visit upper-factor blocks last-to-first: reverse block index
        order = (B - 1) - ro // s, (B - 1) - co // s
    depth = _block_levels(order[0], order[1], B)
    off = sp.csr_matrix((vo, (ro, co)), shape=(n_pad, n_pad))
    return jnp.asarray(diag.astype(dtype)), off, depth


def _to_device_operator(off_scipy, dtype):
    """Pack the off-diagonal factor part for the library SpMV dispatch:
    monolithic CWELL when it fits the pack-size limits of
    `sparse/cwell.py`, column-segmented CWELLSeg when segmentation brings
    every segment within them, CSR otherwise."""
    import numpy as np

    from tpu_sparse.sparse.containers import CSR
    from tpu_sparse.sparse.cwell import AUTO_GROUP, csr_to_cwell

    off = off_scipy.tocsr()
    off.sort_indices()
    csr = CSR(jnp.asarray(off.data.astype(dtype)),
              jnp.asarray(off.indices.astype(np.int32)),
              jnp.asarray(off.indptr.astype(np.int32)), off.shape)
    if off.nnz == 0:
        return csr
    from tpu_sparse.sparse.cwell import LW, PACK_BYTES_BUDGET, X_COLS_LIMIT

    def _fits(W):
        return (4 * 8 * W.planes * LW * 4 <= PACK_BYTES_BUDGET
                and W.planes // 8 <= 384)

    n_pad = off.shape[0]
    if n_pad % LW == 0 and n_pad <= X_COLS_LIMIT:
        try:
            W = csr_to_cwell(csr, group=AUTO_GROUP)
            if _fits(W):
                return W
        except Exception:
            pass
    if n_pad % LW == 0:
        # Plane-rich or wide factors: COLUMN segmentation splits the pack
        # so each segment holds a bounded column range — planes per block
        # drop with the split. Narrow segments keep the near-diagonal mass
        # of a triangular factor within the limits.
        from tpu_sparse.sparse.cwell import csr_to_cwell_segments

        for seg_cols in (1 << 16, 1 << 14):
            try:
                seg = csr_to_cwell_segments(csr, seg_cols=seg_cols,
                                            group=AUTO_GROUP)
                if all(_fits(Wc) for Wc in seg.segments):
                    return seg
            except Exception:
                pass
    return csr


@jax.tree_util.register_pytree_node_class
class SparseLU:
    """Device-resident SuperLU factors (block form) with jit-composable
    solves. Build OUTSIDE jit (host factorization); the instance is a
    registered pytree, so `solve`/`solve_transpose` compose with jit,
    vmap, and the adjoint autograd wrapper with the factors as arguments.

    Differentiability is **b-only**: `sparse_lu_solve_diff` backpropagates
    through the RHS with one adjoint solve (grad_b = A⁻ᵀ x̄, the reference
    contract cudss_solver.py:115-148), but the factor leaves carry ZERO
    cotangents — the factorization is host-side setup, outside the traced
    graph. For ∂L/∂A on the sparsity pattern (the reference's
    grad_A[i,j] = −v[i]·x[j], cudss_solver.py:159-163), solve through the
    router/`direct_solve_diff` paths, which differentiate A via the
    implicit-function theorem instead of through these factors.
    """

    def __init__(self, Ldiag, Udiag, Nl, Nu, NlT, NuT, perm_r, perm_c,
                 depth_l: int, depth_u: int, shape: Tuple[int, int],
                 block: int = _BLOCK):
        self.Ldiag = Ldiag      # (B, s, s) unit-lower diagonal blocks
        self.Udiag = Udiag      # (B, s, s) upper diagonal blocks
        self.Nl = Nl            # strictly-block-lower part of L (sparse)
        self.Nu = Nu            # strictly-block-upper part of U (sparse)
        self.NlT = NlT          # transposes, packed forward for the
        self.NuT = NuT          # adjoint solves
        self.perm_r = perm_r
        self.perm_c = perm_c
        self.depth_l = int(depth_l)   # block depths
        self.depth_u = int(depth_u)
        self.shape = tuple(int(x) for x in shape)
        self.block = int(block)

    def tree_flatten(self):
        return ((self.Ldiag, self.Udiag, self.Nl, self.Nu, self.NlT,
                 self.NuT, self.perm_r, self.perm_c),
                (self.depth_l, self.depth_u, self.shape, self.block))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def n_pad(self) -> int:
        return self.Ldiag.shape[0] * self.Ldiag.shape[1]

    # -- setup (host) --------------------------------------------------------

    @staticmethod
    def factor(A, block: int = _BLOCK) -> "SparseLU":
        """Factorize a concrete square sparse matrix on host.

        scipy splu computes ``Pr A Pc = L U`` (permutation matrices:
        (Pr b)[perm_r] = b and (Pc z)[i] = z[perm_c[i]]); the solve
        applies ``x = Pc U⁻¹ L⁻¹ Pr b``.
        """
        import numpy as np
        import scipy.sparse as sp
        import scipy.sparse.linalg as spl

        from tpu_sparse.sparse.convert import to_csr

        Ac = to_csr(A)
        n, m = Ac.shape
        if n != m:
            raise ValueError("SparseLU requires a square system")
        M = sp.csc_matrix(
            sp.csr_matrix((np.asarray(Ac.data, dtype=np.float64),
                           np.asarray(Ac.indices), np.asarray(Ac.indptr)),
                          shape=(n, m)))
        lu = spl.splu(M)
        dtype = Ac.data.dtype
        if not jnp.issubdtype(dtype, jnp.floating):
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        if (jnp.dtype(dtype) == jnp.float64
                and not jax.config.jax_enable_x64):
            dtype = jnp.float32
        s = block
        n_pad = ((n + s - 1) // s) * s
        Ldiag, Nl_sp, depth_l = _pack_factor(lu.L, n_pad, s, True, dtype)
        Udiag, Nu_sp, depth_u = _pack_factor(lu.U, n_pad, s, False, dtype)
        return SparseLU(
            Ldiag, Udiag,
            _to_device_operator(Nl_sp, dtype),
            _to_device_operator(Nu_sp, dtype),
            _to_device_operator(Nl_sp.T.tocsr(), dtype),
            _to_device_operator(Nu_sp.T.tocsr(), dtype),
            jnp.asarray(lu.perm_r.astype(np.int32)),
            jnp.asarray(lu.perm_c.astype(np.int32)),
            depth_l, depth_u, (n, n), block=s)

    # -- solves (device, jit-safe) -------------------------------------------

    def _block_sweep(self, diag, N, c, depth: int, *, lower: bool,
                     transpose: bool):
        """y ← D⁻¹(c − N y), exact after ``depth`` sweeps: each sweep
        fully recomputes every block from its (already-exact) ancestors.
        D⁻¹ is a batched triangular solve; N y is one SpMV."""
        from tpu_sparse.kernels import spmv

        B, s, _ = diag.shape

        def trisolve(rhs):
            # `lower` describes the STORAGE of diag; transpose_a applies
            # the op — solving Dᵀ w = r keeps lower=lower
            return jax.lax.linalg.triangular_solve(
                diag, rhs.reshape(B, s, 1), left_side=True,
                lower=lower, transpose_a=transpose,
                unit_diagonal=lower).reshape(B * s)

        def apply_n(y):
            return spmv(N, y)

        y = trisolve(c)
        if depth <= 1:
            return y
        return jax.lax.fori_loop(
            0, depth - 1, lambda _, y: trisolve(c - apply_n(y)), y)

    def solve(self, b: jax.Array) -> jax.Array:
        """x = A⁻¹ b, jit-composable. Supports (n,) and (n, k)."""
        if b.ndim == 2:
            return jax.vmap(self.solve, in_axes=-1, out_axes=-1)(b)
        n, n_pad = self.shape[0], self.n_pad
        wt = self.Ldiag.dtype
        bw = b.astype(wt)
        # Pr b, zero-padded
        bp = jnp.zeros(n_pad, wt).at[self.perm_r].set(bw)
        y = self._block_sweep(self.Ldiag, self.Nl, bp, self.depth_l,
                              lower=True, transpose=False)
        z = self._block_sweep(self.Udiag, self.Nu, y, self.depth_u,
                              lower=False, transpose=False)
        return z[self.perm_c].astype(b.dtype)

    def solve_transpose(self, b: jax.Array) -> jax.Array:
        """x = A⁻ᵀ b with the same factors (one adjoint pass):
        Aᵀ = Pc U ᵀ Lᵀ Pr ⇒ x = (Lᵀ)⁻¹(Uᵀ)⁻¹ applied to Pc⁻¹ b, then
        un-permuted by Pr."""
        if b.ndim == 2:
            return jax.vmap(self.solve_transpose, in_axes=-1,
                            out_axes=-1)(b)
        n_pad = self.n_pad
        wt = self.Ldiag.dtype
        bw = b.astype(wt)
        bp = jnp.zeros(n_pad, wt).at[self.perm_c].set(bw)
        w = self._block_sweep(self.Udiag, self.NuT, bp, self.depth_u,
                              lower=False, transpose=True)
        y = self._block_sweep(self.Ldiag, self.NlT, w, self.depth_l,
                              lower=True, transpose=True)
        return y[self.perm_r].astype(b.dtype)


def sparse_lu_solve(lu: SparseLU, b: jax.Array) -> jax.Array:
    """Functional alias (pytree-friendly): x = A⁻¹ b."""
    return lu.solve(b)


@functools.partial(jax.custom_vjp, nondiff_argnums=())
def _lu_solve_core(lu: SparseLU, b: jax.Array) -> jax.Array:
    return lu.solve(b)


def _lu_solve_fwd(lu, b):
    x = lu.solve(b)
    return x, (lu, x)


def _lu_solve_bwd(res, xbar):
    import numpy as np

    lu, _ = res
    v = lu.solve_transpose(xbar)

    # factors are non-differentiable setup products: zero cotangents
    # (float0 for the integer index/permutation leaves, as custom_vjp
    # requires for non-inexact primals)
    def zero_cot(x):
        if jnp.issubdtype(x.dtype, jnp.inexact):
            return jnp.zeros_like(x)
        return np.zeros(x.shape, dtype=jax.dtypes.float0)

    zeros = jax.tree_util.tree_map(zero_cot, lu)
    return zeros, v.astype(xbar.dtype)


_lu_solve_core.defvjp(_lu_solve_fwd, _lu_solve_bwd)


def sparse_lu_solve_diff(lu: SparseLU, b: jax.Array) -> jax.Array:
    """Differentiable w.r.t. b: backward runs ONE adjoint solve with the
    same cached factors (reference contract: cudss_solver.py:115-148 —
    grad_b = A⁻ᵀ x̄), no re-factorization and no graph through the
    block sweeps."""
    return _lu_solve_core(lu, b)
