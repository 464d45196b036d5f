"""Supernodal level-scheduled sparse LU — general direct solves ON device.

The cuDSS capability class (reference cudss_solver.py:176-252: arbitrary
CSR, n in the millions, solves in tens of ms) as a device solve:

* **setup (host, once per matrix)** — nested-dissection ordering
  (direct/ordering.py), SuperLU factorization in NATURAL column order
  (the ND order IS the fill-reducing order), then a block-aligned
  re-packing: ND parts pad to 128-row blocks so independent subtrees
  never share a block, the block dependency DAG of each triangular
  factor collapses to ~tree height levels (43 levels vs 1021
  chained blocks unaligned at n=262144), blocks sort by level, and each
  level's off-diagonal rows pack as one CWELL operator.
* **solve (device, jit-composable)** — a LEVEL-SCHEDULED substitution:
  for each level, one library SpMV over just that level's rows (columns
  touch only already-solved levels) and one batched product with the
  level's pre-inverted 128x128 diagonal blocks. Total SpMV work is
  nnz(factor) — each entry is touched ONCE per solve, not once per
  sweep — plus ~#levels small-kernel latencies: levels are exactly the
  etree height of the block-coarsened factor.

Differentiation matches the reference contract (cudss_solver.py:115-148):
``supernodal_solve_diff`` backpropagates b through one adjoint solve on
the same factors; ∂/∂A goes through the router's implicit-diff path.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_BLOCK = 128  # = CWELL lane width; one diag block per 128 rows


def _compute_levels(bi, bj, B: int, ascending: bool):
    """Longest-path level of every block in the dependency DAG (edges
    bj -> bi). Blocks are processed in substitution order: ascending
    block index for lower-triangular factors, descending for upper."""
    level = np.zeros(B, dtype=np.int64)
    order = np.argsort(bi, kind="stable")
    bi_s, bj_s = bi[order], bj[order]
    starts = np.searchsorted(bi_s, np.arange(B))
    ends = np.searchsorted(bi_s, np.arange(B) + 1)
    rng = range(B) if ascending else range(B - 1, -1, -1)
    for i in rng:
        js = bj_s[starts[i]:ends[i]]
        if len(js):
            level[i] = 1 + level[js].max()
    return level


def _window_maxes(off):
    """Per-(row-block, column-window) plane counts of a CSR (the CWELL
    packer's S contribution), without packing: O(nnz log nnz)."""
    from tpu_sparse.sparse.cwell import LW, WIN

    rows, cols = off.shape
    nwin = (cols + WIN - 1) // WIN
    r = np.repeat(np.arange(rows, dtype=np.int64), np.diff(off.indptr))
    w = off.indices.astype(np.int64) // WIN
    blk = r // LW
    key = (blk * nwin + w) * LW + (r % LW)
    uk, cnt = np.unique(key, return_counts=True)
    bw = uk // LW                       # (block, window) id per unique row
    grp = np.flatnonzero(np.r_[True, bw[1:] != bw[:-1]])
    maxc = np.maximum.reduceat(cnt, grp)
    return bw[grp] // nwin, bw[grp] % nwin, maxc   # block, window, planes


def _pack_operator(off_scipy, dtype):
    """Pack one level's off-diagonal rows (rows_l x n_pad rectangular
    CSR) for the library SpMV: CWELL when it fits the pack-size limits of
    `sparse/cwell.py`, column-segmented CWELLSeg for plane-rich rows, CSR
    otherwise.

    Format choice is decided from a cheap plane-count ESTIMATE before any
    packing runs, so no pack is built twice."""
    from tpu_sparse.sparse.containers import CSR
    from tpu_sparse.sparse.cwell import (LW, PACK_BYTES_BUDGET, WIN,
                                         X_COLS_LIMIT, csr_to_cwell,
                                         csr_to_cwell_segments)

    off = off_scipy.tocsr()
    off.sort_indices()
    csr = CSR(jnp.asarray(off.data.astype(dtype)),
              jnp.asarray(off.indices.astype(np.int32)),
              jnp.asarray(off.indptr.astype(np.int32)), off.shape)
    if off.nnz == 0:
        return None

    def _s_ok(S):
        S = -(-int(S) // 8) * 8
        return 4 * 8 * S * LW * 4 <= PACK_BYTES_BUDGET

    rows, cols = off.shape
    if rows % LW == 0 and cols % LW == 0 and cols <= X_COLS_LIMIT:
        blk, win, planes = _window_maxes(off)
        # full pack: S = max over blocks of (sum of window planes)
        S_full = np.bincount(blk, weights=planes).max()
        try:
            if _s_ok(S_full):
                return csr_to_cwell(csr, group=1)
            # segmented: S per (block, segment) = sum of its window planes
            for seg_cols in (1 << 16, 1 << 14, 1 << 12):
                nseg_w = seg_cols // WIN
                key = blk * ((cols // WIN) // nseg_w + 1) + win // nseg_w
                S_seg = np.bincount(key, weights=planes).max()
                if _s_ok(S_seg):
                    return csr_to_cwell_segments(csr, seg_cols=seg_cols,
                                                 group=1)
        except Exception:
            pass
    return csr


def _block_plane_est(ro, co, s):
    """Estimated CWELL planes per row-block for entry lists (slot
    coordinates): per (block, 256-col window) max row count, summed per
    block. Mirrors the packer's S accounting."""
    from tpu_sparse.sparse.cwell import WIN

    blk = ro // s
    if len(blk) == 0:
        return np.zeros(0, np.int64)
    nwin_max = int(co.max()) // WIN + 1
    key = (blk * nwin_max + co // WIN) * s + ro % s
    uk, cnt = np.unique(key, return_counts=True)
    bw = uk // s
    grp = np.flatnonzero(np.r_[True, bw[1:] != bw[:-1]])
    maxc = np.maximum.reduceat(cnt, grp)
    ub = bw[grp] // nwin_max
    S_b = np.zeros(int(blk.max()) + 1, np.int64)
    np.add.at(S_b, ub, maxc)
    return S_b


def _row_groups(S_b, ratio: float = 4.0, max_groups: int = 6):
    """Split a level's blocks (slot order) into runs of similar plane
    counts. A new group starts when the within-group max/min plane ratio
    would exceed ``ratio``; the split is KEPT only when the estimated
    slot saving is >1.7x (each group pads to its own max instead of the
    level max) — bounding both padding waste and kernel count."""
    nb = len(S_b)
    Sb = np.maximum(S_b, 1)
    bounds = [0]
    mx = mn = Sb[0]
    for i in range(1, nb):
        v = Sb[i]
        if max(mx, v) > ratio * min(mn, v) and len(bounds) < max_groups:
            bounds.append(i)
            mx = mn = v
        else:
            mx = max(mx, v)
            mn = min(mn, v)
    bounds.append(nb)
    groups = [(bounds[i], bounds[i + 1] - bounds[i])
              for i in range(len(bounds) - 1)]
    if len(groups) == 1:
        return groups
    whole = nb * int(Sb.max())
    split = sum(g_nb * int(Sb[g0:g0 + g_nb].max()) for g0, g_nb in groups)
    return groups if whole > 1.7 * split else [(0, nb)]


def _grouped_packs(ro, co, vo, row_lev, ranges, n_levels, n_pad, dtype,
                   skip_level: int):
    """Build per-level device operators from level-mapped entries.

    Each level yields None (no dependencies) or a tuple of
    ``(row_offset, rows, operator)`` groups partitioning the level's
    rows: factor levels mix plane-rich separator blocks with sparse leaf
    blocks, and a single pack pads every block to the level max (the
    transpose-U pack set alone can reach gigabytes at <2% fill). ``skip_level`` is the level with no incoming dependencies
    (0 forward, n_levels-1 reverse)."""
    import scipy.sparse as sp

    order_e = np.argsort(row_lev, kind="stable")
    ro, co, vo, row_lev = (ro[order_e], co[order_e], vo[order_e],
                           row_lev[order_e])
    lv_starts = np.searchsorted(row_lev, np.arange(n_levels))
    lv_ends = np.searchsorted(row_lev, np.arange(n_levels) + 1)
    s = _BLOCK
    packs = []
    metas = []
    for lv in range(n_levels):
        a, b = ranges[lv]
        e0, e1 = int(lv_starts[lv]), int(lv_ends[lv])
        if lv == skip_level or e1 <= e0:
            packs.append(None)
            metas.append(None)
            continue
        ro_l = ro[e0:e1] - a
        co_l, vo_l = co[e0:e1], vo[e0:e1]
        S_b = _block_plane_est(ro_l, co_l, s)
        nb_lv = (b - a) // s
        if len(S_b) < nb_lv:  # trailing blocks with no entries
            S_b = np.r_[S_b, np.zeros(nb_lv - len(S_b), np.int64)]
        groups = _row_groups(S_b)
        ops = []
        shapes = []
        for g0, g_nb in groups:
            r0, r1 = g0 * s, (g0 + g_nb) * s
            m = (ro_l >= r0) & (ro_l < r1)
            shapes.append((r0, r1 - r0))
            if not m.any():
                ops.append(None)
                continue
            sub = sp.csr_matrix(
                (vo_l[m], (ro_l[m] - r0, co_l[m])),
                shape=(r1 - r0, n_pad))
            ops.append(_pack_operator(sub, dtype))
        packs.append(tuple(ops))
        metas.append(tuple(shapes))
    return tuple(packs), tuple(metas)


def _layout_and_packs(T_coo, row_map, n_pad: int, s: int,
                      ascending: bool, dtype, unit_lower: bool,
                      with_transpose: bool = False):
    """Level-sort a mapped triangular factor and build its device plan.

    Returns (diag, packs, packs_t, ranges, slot_of_padded_row):
      diag    — (B, s, s) dense diagonal blocks in level order
                (identity on padding slots)
      packs   — tuple, one per level: None (no off-diag entries) or a
                device operator whose rows are that level's rows (in
                level order) and whose columns index the level-ordered
                padded vector
      packs_t — transpose-solve operators in the SAME layout (or ()):
                processing the levels in REVERSE order with these packs
                and transpose_a trisolves on the same diag solves T^T
                (stage for level l holds T's entries whose COLUMN block
                is at level l, transposed — its references are all at
                higher levels, already solved in reverse order)
      ranges  — tuple of (start_row, end_row) per level, static
      slot    — (n_pad,) int64: padded-row -> level-ordered slot
    """
    B = n_pad // s
    r = row_map[T_coo.row]
    c = row_map[T_coo.col]
    v = T_coo.data
    same = (r // s) == (c // s)

    # levels on the block DAG of the off-diagonal part
    bi, bj = r[~same] // s, c[~same] // s
    level = _compute_levels(bi, bj, B, ascending)
    n_levels = int(level.max()) + 1 if B else 1

    # blocks sorted by (level, index): per-level contiguous ranges
    block_order = np.lexsort((np.arange(B), level))   # new_pos -> old_blk
    block_slot = np.empty(B, np.int64)                # old_blk -> new_pos
    block_slot[block_order] = np.arange(B)
    slot = block_slot[np.arange(n_pad) // s] * s + np.arange(n_pad) % s
    lev_sorted = level[block_order]
    counts = np.bincount(lev_sorted, minlength=n_levels)
    ends = np.cumsum(counts) * s
    starts = ends - counts * s
    ranges = tuple((int(a), int(b)) for a, b in zip(starts, ends))

    # dense diagonal blocks in level order, PRE-INVERTED in f64: a
    # batched triangular_solve runs 128 dependent tiny steps per block,
    # while the explicit-inverse apply is one batched matmul. Blocks
    # come from a threshold-pivoted LU, so the
    # triangular inverses are well-conditioned; the router's iterative-
    # refinement step absorbs the f32 rounding.
    diag = np.zeros((B, s, s), dtype=np.float64)
    rs, cs, vs = slot[r[same]], slot[c[same]], v[same]
    diag[rs // s, rs % s, cs % s] = vs
    all_slots = np.ones(n_pad, bool)
    all_slots[slot[row_map]] = False
    pad_ids = np.nonzero(all_slots)[0]  # identity on padding slots
    diag[pad_ids // s, pad_ids % s, pad_ids % s] = 1.0
    if unit_lower:
        # real rows whose diagonal entry is implicit-unit in the factor
        real = np.zeros(n_pad, bool)
        real[slot[row_map]] = True
        have = np.zeros(n_pad, bool)
        have[rs[rs == cs]] = True
        fix = np.nonzero(real & ~have)[0]
        diag[fix // s, fix % s, fix % s] = 1.0
    diag_j = jnp.asarray(np.linalg.inv(diag).astype(np.dtype(dtype)))

    # per-level off-diagonal packs (rows AND columns in level order)
    ro, co, vo = slot[r[~same]], slot[c[~same]], v[~same]
    packs, meta = _grouped_packs(ro, co, vo, lev_sorted[ro // s], ranges,
                                 n_levels, n_pad, dtype, skip_level=0)
    packs_t, meta_t = (), ()
    if with_transpose:
        packs_t, meta_t = _grouped_packs(
            co, ro, vo, lev_sorted[co // s], ranges, n_levels, n_pad,
            dtype, skip_level=n_levels - 1)
    return diag_j, (packs, meta), (packs_t, meta_t), ranges, slot


def _level_solve(diag_inv, packs, meta, ranges, bp, *, transpose: bool,
                 reverse: bool = False):
    """Level-scheduled triangular solve: y[level l] =
    D_l^{-1} (bp - N_l y)[level l], one SpMV + one batched matmul
    against the pre-inverted diagonal blocks per level (static unrolled
    loop; every factor entry touched once). ``reverse=True`` runs the
    levels last-to-first — with the transpose pack set and
    ``transpose=True`` this solves T^T in the same layout."""
    from jax import lax

    from tpu_sparse.kernels import spmv

    B, s, _ = diag_inv.shape
    eq = "bji,bj->bi" if transpose else "bij,bj->bi"
    y = jnp.zeros_like(bp)
    sched = zip(reversed(ranges), reversed(packs), reversed(meta)) \
        if reverse else zip(ranges, packs, meta)
    for (a, b), groups, shapes in sched:
        if b <= a:
            continue
        seg = bp[a:b]
        if groups is not None:
            # groups partition the level's rows (similar plane counts
            # per group); empty groups contribute no correction
            corr = [jnp.zeros((rows_g,), bp.dtype) if N is None
                    else spmv(N, y)
                    for N, (_, rows_g) in zip(groups, shapes)]
            seg = seg - (corr[0] if len(corr) == 1
                         else jnp.concatenate(corr))
        blk = jnp.einsum(eq, diag_inv[a // s:b // s],
                         seg.reshape(-1, s),
                         precision=lax.Precision.HIGHEST)
        y = y.at[a:b].set(blk.reshape(-1))
    return y


@jax.tree_util.register_pytree_node_class
class SupernodalLU:
    """Device-resident level-scheduled LU factors (see module docstring).

    Build OUTSIDE jit via :meth:`factor` (host ND + SuperLU + packing);
    the instance is a registered pytree so ``solve``/``solve_transpose``
    compose with jit/vmap and ride through as arguments. Transpose
    solves reuse the forward layouts: the level schedule runs in reverse
    with transposed packs and transpose_a trisolves on the SAME diagonal
    blocks (no duplicated factor storage)."""

    _CHILDREN = ("diagL", "diagU", "packsL", "packsU", "packsLT",
                 "packsUT", "in_idx", "mid_idx", "out_idx",
                 "in_idx_t", "mid_idx_t", "out_idx_t")

    def __init__(self, diagL, diagU, packsL, packsU, packsLT, packsUT,
                 in_idx, mid_idx, out_idx, in_idx_t, mid_idx_t,
                 out_idx_t, rangesL, rangesU, metaL, metaU, metaLT,
                 metaUT, shape: Tuple[int, int], block: int = _BLOCK):
        self.diagL, self.diagU = diagL, diagU
        self.packsL, self.packsU = packsL, packsU
        self.packsLT, self.packsUT = packsLT, packsUT
        self.in_idx, self.mid_idx, self.out_idx = in_idx, mid_idx, out_idx
        self.in_idx_t, self.mid_idx_t = in_idx_t, mid_idx_t
        self.out_idx_t = out_idx_t
        self.rangesL, self.rangesU = rangesL, rangesU
        self.metaL, self.metaU = metaL, metaU
        self.metaLT, self.metaUT = metaLT, metaUT
        self.shape = tuple(int(x) for x in shape)
        self.block = int(block)

    def tree_flatten(self):
        return (tuple(getattr(self, k) for k in self._CHILDREN),
                (self.rangesL, self.rangesU, self.metaL, self.metaU,
                 self.metaLT, self.metaUT, self.shape, self.block))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def n_pad(self) -> int:
        return self.diagL.shape[0] * self.diagL.shape[1]

    @property
    def n_levels(self) -> int:
        return max(len(self.rangesL), len(self.rangesU))

    # -- setup (host) -----------------------------------------------------

    @staticmethod
    def factor(A, block: int = _BLOCK, leaf: int = 896,
               with_transpose: bool = True) -> "SupernodalLU":
        """Factorize a concrete square sparse matrix on host.

        ``with_transpose=False`` skips the adjoint-solve pack set
        (halves off-diagonal pack memory; ``solve_transpose``/autodiff
        unavailable).

        All device arrays are staged on the CPU backend during setup and
        moved in one batched ``jax.device_put`` of the whole pytree at
        the end, instead of ~400 individual leaf transfers. Whether the
        staging still pays on the GPU is not measured (ROADMAP.md)."""
        dev = jax.devices()[0]
        cpu = jax.devices("cpu")[0]
        if dev.platform == "cpu":
            return SupernodalLU._factor_host(A, block, leaf,
                                             with_transpose)
        with jax.default_device(cpu):
            lu = SupernodalLU._factor_host(A, block, leaf, with_transpose)
        from tpu_sparse.utils.transfer import batched_device_put

        return batched_device_put(lu, dev)

    @staticmethod
    def _factor_host(A, block: int, leaf: int,
                     with_transpose: bool) -> "SupernodalLU":
        import scipy.sparse as sp
        import scipy.sparse.linalg as spl

        from tpu_sparse.direct.ordering import (aligned_row_map,
                                                nested_dissection)
        from tpu_sparse.sparse.convert import to_csr

        Ac = to_csr(A)
        n, m = Ac.shape
        if n != m:
            raise ValueError("SupernodalLU requires a square system")
        A_sp = sp.csr_matrix(
            (np.asarray(Ac.data, dtype=np.float64),
             np.asarray(Ac.indices), np.asarray(Ac.indptr)), shape=(n, m))
        sigma, part_sizes = nested_dissection(A_sp, leaf=leaf)
        Ap = A_sp[sigma][:, sigma].tocsc()
        lu = spl.splu(Ap, permc_spec="NATURAL", diag_pivot_thresh=0.1,
                      options=dict(SymmetricMode=True))
        dtype = Ac.data.dtype
        if not jnp.issubdtype(dtype, jnp.floating):
            dtype = (jnp.float64 if jax.config.jax_enable_x64
                     else jnp.float32)
        if (jnp.dtype(dtype) == jnp.float64
                and not jax.config.jax_enable_x64):
            dtype = jnp.float32

        s = block
        row_map, n_pad = aligned_row_map(part_sizes, s)
        Lc = sp.coo_matrix(lu.L)
        Uc = sp.coo_matrix(lu.U)
        perm_r = np.asarray(lu.perm_r, dtype=np.int64)
        perm_c = np.asarray(lu.perm_c, dtype=np.int64)

        # L and U plans build concurrently: the heavy parts (numpy
        # mapping passes, the C++ pack kernels, LAPACK batched inverse)
        # release the GIL
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=2) as ex:
            fL = ex.submit(_layout_and_packs, Lc, row_map, n_pad, s,
                           True, dtype, unit_lower=True,
                           with_transpose=with_transpose)
            fU = ex.submit(_layout_and_packs, Uc, row_map, n_pad, s,
                           False, dtype, unit_lower=False,
                           with_transpose=with_transpose)
            diagL, (packsL, metaL), (packsLT, metaLT), rangesL, slotL = \
                fL.result()
            diagU, (packsU, metaU), (packsUT, metaUT), rangesU, slotU = \
                fU.result()

        # index plumbing. The permuted system is Ap x' = b' with
        # b'_i = b[sigma_i], x[sigma_i] = x'_i; splu then wants
        # bp[perm_r[i]] = b'_i and returns x'_i = z[perm_c[i]]. Folding
        # sigma in: bp_L[in_idx[k]] = b[k] and x[k] = z_U[out_idx[k]].
        in_scatter = np.empty(n, np.int64)
        in_scatter[sigma] = slotL[row_map[perm_r]]
        mid = np.zeros(n_pad, np.int64)
        mid[slotU[row_map]] = slotL[row_map]
        out_scatter = np.empty(n, np.int64)
        out_scatter[sigma] = slotU[row_map[perm_c]]
        # transpose solve: U^T first (U layout), then L^T (L layout)
        in_scatter_t = np.empty(n, np.int64)
        in_scatter_t[sigma] = slotU[row_map[perm_c]]
        mid_t = np.zeros(n_pad, np.int64)
        mid_t[slotL[row_map]] = slotU[row_map]
        out_scatter_t = np.empty(n, np.int64)
        out_scatter_t[sigma] = slotL[row_map[perm_r]]

        def i32(a):
            return jnp.asarray(np.asarray(a).astype(np.int32))

        return SupernodalLU(
            diagL, diagU, packsL, packsU, packsLT, packsUT,
            i32(in_scatter), i32(mid), i32(out_scatter),
            i32(in_scatter_t), i32(mid_t), i32(out_scatter_t),
            rangesL, rangesU, metaL, metaU, metaLT, metaUT, (n, n),
            block=s)

    # -- solves (device, jit-safe) ----------------------------------------

    def solve(self, b: jax.Array) -> jax.Array:
        """x = A^-1 b, jit-composable. Supports (n,) and (n, k)."""
        if b.ndim == 2:
            return jax.vmap(self.solve, in_axes=-1, out_axes=-1)(b)
        wt = self.diagL.dtype
        bp = jnp.zeros(self.n_pad, wt).at[self.in_idx].set(b.astype(wt))
        y = _level_solve(self.diagL, self.packsL, self.metaL,
                         self.rangesL, bp, transpose=False)
        z = _level_solve(self.diagU, self.packsU, self.metaU,
                         self.rangesU, y[self.mid_idx], transpose=False)
        return z[self.out_idx].astype(b.dtype)

    def solve_transpose(self, b: jax.Array) -> jax.Array:
        """x = A^-T b with the same factors (adjoint pass)."""
        if b.ndim == 2:
            return jax.vmap(self.solve_transpose, in_axes=-1,
                            out_axes=-1)(b)
        if len(self.packsUT) == 0:
            raise ValueError(
                "factored with with_transpose=False: adjoint solves "
                "unavailable")
        wt = self.diagL.dtype
        bp = jnp.zeros(self.n_pad, wt).at[self.in_idx_t].set(b.astype(wt))
        w = _level_solve(self.diagU, self.packsUT, self.metaUT,
                         self.rangesU, bp, transpose=True, reverse=True)
        y = _level_solve(self.diagL, self.packsLT, self.metaLT,
                         self.rangesL, w[self.mid_idx_t], transpose=True,
                         reverse=True)
        return y[self.out_idx_t].astype(b.dtype)


def supernodal_solve(lu: SupernodalLU, b: jax.Array) -> jax.Array:
    """Functional alias: x = A^-1 b."""
    return lu.solve(b)


@functools.partial(jax.custom_vjp, nondiff_argnums=())
def _sn_solve_core(lu: SupernodalLU, b: jax.Array) -> jax.Array:
    return lu.solve(b)


def _sn_solve_fwd(lu, b):
    x = lu.solve(b)
    return x, (lu, x)


def _sn_solve_bwd(res, xbar):
    lu, _ = res
    v = lu.solve_transpose(xbar)

    def zero_cot(x):
        if jnp.issubdtype(x.dtype, jnp.inexact):
            return jnp.zeros_like(x)
        return np.zeros(x.shape, dtype=jax.dtypes.float0)

    zeros = jax.tree_util.tree_map(zero_cot, lu)
    return zeros, v.astype(xbar.dtype)


_sn_solve_core.defvjp(_sn_solve_fwd, _sn_solve_bwd)


def supernodal_solve_diff(lu: SupernodalLU, b: jax.Array) -> jax.Array:
    """Differentiable w.r.t. b: backward runs ONE adjoint solve with the
    cached factors (reference contract cudss_solver.py:115-148)."""
    return _sn_solve_core(lu, b)
