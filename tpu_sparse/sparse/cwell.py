"""CWELL — column-window ELL: a lane-regular form of general CSR.

A general-structure (unstructured CSR/COO) SpMV format (SURVEY.md §2.2:
the cuSPARSE capability row; the reference reaches it through
torch.sparse — solver.py:365, utils/matrix_utils.py:279). It was built
for a vector unit without a general gather, so the format itself makes
every memory access regular:

* Rows are grouped into **blocks of 128** (the lane dimension) — output
  row ``i`` of a block lives in lane ``i % 128``, so the result of a block
  is one dense 128-vector: no scatter anywhere.
* Each nonzero is assigned to a **column window** of 256 consecutive
  columns aligned to 128 (two rows of the x operand reshaped to
  ``(m/128, 128)``). Within a (block, window) pair, a row's nonzeros get
  consecutive **planes**; plane ``s`` of a block is a dense ``(128,)``
  value vector + ``(128,)`` local-index vector into a 256-wide x window.
* Planes are padded to a common count ``S`` per matrix; ``fill`` =
  nnz / total slots measures the padding overhead. Matrices with column
  locality (any PDE/graph matrix, ideally RCM-ordered) pack at 50-95%
  fill; fully random sparsity packs poorly and should stay on the CSR
  segment-sum path (the format choice checks ``fill``).

SpMV/SpMM run as the XLA gather in ``kernels/reference.py``. Whether the
format still pays against CSR on the GPU is an open measurement
(ROADMAP.md); the pack-size limits below are kept as they were so the
format choices of `sparse/optimize.py` and the direct solvers' packs
stay unchanged.

Arrays:
  vals:  (n_blocks, S, 128) dtype — slot values (0 in padding slots)
  idx2:  (n_blocks, S, 128) int32 — column offset within the plane's
         256-wide window: global col = srow*128 + idx2, idx2 ∈ [0, 256)
  srow:  (n_blocks, S) int32 — window start row of x2d = x.reshape(-1,128),
         clamped to [0, m_pad/128 - 2] so rows srow and srow+1 both exist
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sparse.sparse.containers import CSR, SPARSE_TYPES

LW = 128        # lanes per row block
WIN = 256       # window width in columns (two x2d rows)

# Pack-size limits. They were tuned for an on-chip-memory SpMV kernel that
# this package no longer has, and are kept unchanged so that the format
# choices (sparse/optimize.py, direct/sparse_lu.py, direct/supernodal.py)
# stay as they were; they are to be re-chosen by measurement on the GPU.
X_COLS_LIMIT = 1536 * 1024          # widest x (columns) a monolithic pack takes
PACK_BYTES_BUDGET = 96 * 1024 * 1024  # bound on 4 * 8 * planes * LW * 4 bytes


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
class CWELL:
    """Column-window ELL matrix (see module docstring)."""

    def __init__(self, vals, idx2, srow, shape, nnz=None, fill=None,
                 group=1):
        self.vals = vals
        self.idx2 = idx2
        self.srow = srow
        self.shape = tuple(int(s) for s in shape)
        self._nnz = None if nnz is None else int(nnz)
        self.fill = None if fill is None else float(fill)
        # group quantum Q: every aligned run of Q planes shares one window
        # row (csr_to_cwell(group=Q))
        self.group = int(group) if group else 1

    @property
    def grouped(self) -> bool:
        return self.group > 1

    def tree_flatten(self):
        return (self.vals, self.idx2, self.srow), (
            self.shape, self._nnz, self.fill, self.group)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], aux[0],
                   nnz=aux[1], fill=aux[2], group=aux[3])

    @property
    def n_blocks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def planes(self) -> int:
        return int(self.vals.shape[1])

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        if self._nnz is not None:
            return self._nnz
        return int(np.count_nonzero(np.asarray(self.vals)))

    def with_data(self, vals) -> "CWELL":
        return CWELL(vals, self.idx2, self.srow, self.shape,
                     nnz=self._nnz, fill=self.fill, group=self.group)

    # -- conversions --------------------------------------------------------

    def gcols(self) -> jax.Array:
        """Global column index per slot: (n_blocks, S, 128) int32."""
        return self.srow[:, :, None] * LW + self.idx2

    def tocsr(self) -> CSR:
        """Host-side conversion back to CSR (drops padding slots)."""
        import scipy.sparse as sp

        vals = np.asarray(self.vals)
        gc = np.asarray(self.gcols())
        n, m = self.shape
        nb, S, _ = vals.shape
        rows = np.broadcast_to(
            (np.arange(nb)[:, None, None] * LW
             + np.arange(LW)[None, None, :]), vals.shape)
        mask = vals != 0
        A = sp.coo_matrix(
            (vals[mask], (rows[mask], gc[mask])), shape=(nb * LW, m)
        ).tocsr()[:n]
        A.sum_duplicates()
        A = A.tocsr()
        from tpu_sparse.sparse.convert import csr_from_arrays

        return csr_from_arrays(A.data, A.indices, A.indptr, (n, m))

    def todense(self) -> jax.Array:
        return jnp.asarray(self.tocsr().todense())

    @property
    def T(self) -> "CWELL":
        """Transpose (host-side repack; not jit-safe)."""
        return csr_to_cwell(self.tocsr().T)

    def __matmul__(self, x):
        from tpu_sparse.kernels import spmv, spmm

        if x.ndim == 1:
            return spmv(self, x)
        return spmm(self, x)

    def __repr__(self):
        return (f"CWELL(shape={self.shape}, blocks={self.n_blocks}, "
                f"S={self.planes}, fill={self.fill})")


def _cols_sorted(indptr: np.ndarray, cols: np.ndarray) -> bool:
    """True when every row's column indices ascend (the C++ pack's
    run-detection requires it; scipy canonical CSR guarantees it)."""
    if cols.size < 2:
        return True
    bad = cols[1:] < cols[:-1]
    row_starts = indptr[1:-1]
    row_starts = row_starts[(row_starts > 0) & (row_starts < cols.size)]
    bad[row_starts - 1] = False
    return not bad.any()


# Sentinel: pick the group quantum per matrix at pack time. High-fill
# (column-local) packs keep Q=2; low-fill packs (poor locality, e.g.
# random sparsity) take Q=4 unless its plane inflation is too large. The
# rule was tuned for a kernel this package no longer has and has not been
# re-timed on the GPU (ROADMAP.md).
AUTO_GROUP = "auto"
_AUTO_FILL_Q2 = 0.5
_AUTO_TRIAL_NNZ_CAP = 1 << 25   # ~33M nnz: bound on the double-pack trial


def csr_to_cwell(A: CSR, *, plane_pad: int = 8,
                 group=1) -> CWELL:
    """Pack a CSR matrix into CWELL (host-side, vectorized numpy).

    Window assignment is fixed 256-column buckets (window w covers columns
    [256w, 256w+256)); within each (row-block, window) a row's k nonzeros
    occupy planes base..base+k-1 where base is the window's plane offset in
    the block. Runs in O(nnz log nnz).

    group=Q (Q in {2, 4, 8}) pads every (row-block, window) plane run to
    a multiple of Q so each aligned run of Q planes shares one window row,
    at the cost of padding planes.
    """
    if group == AUTO_GROUP:
        W2 = csr_to_cwell(A, plane_pad=plane_pad, group=2)
        if W2.fill is None or W2.fill >= _AUTO_FILL_Q2:
            return W2
        # the Q=4 trial is a SECOND full pack — packing is
        # memory-bandwidth bound on fresh allocations, so cap the trial
        # to packs where the extra host pass stays cheap (huge low-fill
        # packs keep the Q=2 result rather than doubling their setup cost)
        if A.indices.shape[0] > _AUTO_TRIAL_NNZ_CAP:
            return W2
        W4 = csr_to_cwell(A, plane_pad=plane_pad, group=4)
        # keep Q=4 unless its plane inflation exceeds ~1.35x
        return W4 if W4.planes <= W2.planes * 1.35 else W2
    if group not in (1, 2, 4, 8):
        raise ValueError("group quantum must be 1, 2, 4, or 8")
    if group > 1 and plane_pad % 8 != 0:
        # S % 8 == 0 (and hence S % group == 0) keeps every aligned run
        # of Q planes inside the pack
        raise ValueError("grouped packing requires plane_pad % 8 == 0")
    group8 = group > 1  # any quantum pads runs; naming kept for brevity
    indptr = np.asarray(A.indptr, dtype=np.int64)
    cols = np.asarray(A.indices, dtype=np.int64)
    data = np.asarray(A.data)
    n, m = A.shape
    nnz = cols.shape[0]
    nb = max(_round_up(n, LW) // LW, 1)
    m_pad = max(_round_up(m, LW), 2 * LW)
    rmax = m_pad // LW - 2  # max srow so srow+1 is a valid x2d row

    if nnz == 0:
        vals = np.zeros((nb, plane_pad, LW), dtype=data.dtype)
        idx2 = np.zeros((nb, plane_pad, LW), dtype=np.int32)
        srow = np.zeros((nb, plane_pad), dtype=np.int32)
        return CWELL(jnp.asarray(vals), jnp.asarray(idx2),
                     jnp.asarray(srow), (n, m), nnz=0, fill=0.0,
                     group=group)

    # C++ fast path for large packs: two streaming passes writing each
    # output once vs the numpy pipeline's ~20 nnz-sized intermediates
    # (fresh-page population costs ~6 s/GB on this host).
    # (group8 packs take the numpy path.)
    if not group8 and nnz >= (1 << 14) \
            and data.dtype in (np.float32, np.float64) \
            and _cols_sorted(indptr, cols):
        from tpu_sparse import native

        packed = native.cwell_pack(indptr, cols, data, (n, m),
                                   plane_pad=plane_pad)
        if packed is not None:
            vals, idx2, srow, S = packed
            fill = nnz / float(nb * S * LW)
            return CWELL(jnp.asarray(vals), jnp.asarray(idx2),
                         jnp.asarray(srow), (n, m), nnz=nnz, fill=fill)

    rows = np.repeat(np.arange(n, dtype=np.int32),
                     np.diff(indptr).astype(np.int32))
    block = rows // LW
    lrow = (rows % LW).astype(np.int32)
    win = (cols // WIN).astype(np.int32)
    nwin = m // WIN + 2

    # sort by the composite (block, window, row) key — ONE stable sort
    # (CSR indices are column-sorted within each row, and stability
    # preserves that order inside each group, so ranks stay col-ordered;
    # the former 3-key lexsort cost 3 merge passes over 100M+ elements)
    key_bw = block.astype(np.int64) * nwin + win
    key_bwr_all = key_bw * LW + lrow
    order = np.argsort(key_bwr_all, kind="stable")
    b_s, w_s, r_s = block[order], win[order], lrow[order]
    c_s, v_s = cols[order], data[order]

    # rank of each nnz within its (block, window, row) group
    key_bwr = key_bwr_all[order]
    grp_start = np.r_[True, key_bwr[1:] != key_bwr[:-1]]
    idx_all = np.arange(nnz, dtype=np.int64)
    first_of_grp = np.maximum.accumulate(np.where(grp_start, idx_all, 0))
    rank = idx_all - first_of_grp

    # planes needed per (block, window) = max rank + 1 within the window
    key_bw_s = key_bw[order]
    win_start = np.r_[True, key_bw_s[1:] != key_bw_s[:-1]]
    win_ids = np.cumsum(win_start) - 1                   # dense window ids
    nwins_total = int(win_ids[-1]) + 1
    planes_per_win = np.zeros(nwins_total, dtype=np.int64)
    np.maximum.at(planes_per_win, win_ids, rank + 1)

    # plane base per window = cumulative planes within each block
    if group8:
        # pad every (block, window) run to a multiple of Q planes so each
        # aligned Q-plane run is window-homogeneous
        planes_per_win = ((planes_per_win + group - 1) // group) * group
    win_first = np.flatnonzero(win_start)                # first slot per win
    win_block = b_s[win_first]
    csum = np.concatenate([[0], np.cumsum(planes_per_win)])
    blk_first_win = np.r_[True, win_block[1:] != win_block[:-1]]
    blk_base_per_win = np.maximum.accumulate(
        np.where(blk_first_win, csum[:-1], 0))
    win_base = csum[:-1] - blk_base_per_win              # base within block

    plane = win_base[win_ids] + rank                     # (nnz,) per slot
    S_per_block = np.zeros(nb, dtype=np.int64)
    np.maximum.at(S_per_block, b_s, plane + 1)
    S = int(_round_up(max(int(S_per_block.max()), 1), plane_pad))

    sr = np.minimum(w_s * 2, rmax).astype(np.int32)      # window start row
    i2 = (c_s - sr.astype(np.int64) * LW).astype(np.int32)

    vals = np.zeros((nb, S, LW), dtype=data.dtype)
    idx2 = np.zeros((nb, S, LW), dtype=np.int32)
    srow = np.zeros((nb, S), dtype=np.int32)
    vals[b_s, plane, r_s] = v_s
    idx2[b_s, plane, r_s] = i2
    srow[b_s, plane] = sr

    if group8:
        # every plane of a padded run (padding slots included) carries
        # the run's window row, whichever plane of the run is populated
        sr_win = np.minimum(w_s[win_first] * 2, rmax).astype(np.int32)
        lens = planes_per_win
        run_start = win_block * S + win_base
        offs = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
        srow.reshape(-1)[np.repeat(run_start, lens) + offs] = np.repeat(
            sr_win, lens)

    fill = nnz / float(nb * S * LW)
    return CWELL(jnp.asarray(vals), jnp.asarray(idx2), jnp.asarray(srow),
                 (n, m), nnz=nnz, fill=fill, group=group)


@jax.tree_util.register_pytree_node_class
class CWELLSeg:
    """Column-segmented CWELL: general structure wider than
    ``X_COLS_LIMIT`` columns.

    The columns are split into 256-aligned segments, each packed as its
    own CWELL against its own x slice, and
    ``y = Σ_seg W_seg @ x[start : start+width]``; segments with no
    nonzeros are dropped.
    """

    def __init__(self, segments, starts, widths, shape, nnz=None,
                 rstarts=None):
        self.segments = tuple(segments)
        self.starts = tuple(int(s) for s in starts)
        self.widths = tuple(int(w) for w in widths)
        self.shape = tuple(int(s) for s in shape)
        self._nnz = None if nnz is None else int(nnz)
        # first row (128-aligned) each segment's CWELL covers: segments
        # only pack the row-block range that actually touches their
        # columns (for banded-ish structure that's ~1/n_seg of the rows)
        self.rstarts = (tuple(int(r) for r in rstarts)
                        if rstarts is not None
                        else (0,) * len(self.segments))

    def tree_flatten(self):
        return (self.segments,), (self.starts, self.widths, self.shape,
                                  self._nnz, self.rstarts)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1], aux[2], nnz=aux[3],
                   rstarts=aux[4])

    @property
    def dtype(self):
        return self.segments[0].dtype

    @property
    def nnz(self) -> int:
        if self._nnz is not None:
            return self._nnz
        return sum(w.nnz for w in self.segments)

    @property
    def fill(self) -> float:
        slots = sum(w.n_blocks * w.planes * LW for w in self.segments)
        return self.nnz / max(slots, 1)

    def tocsr(self) -> CSR:
        import scipy.sparse as sp

        n, m = self.shape
        parts = []
        for W, j0, r0 in zip(self.segments, self.starts, self.rstarts):
            C = W.tocsr()
            S = sp.csr_matrix((np.asarray(C.data), np.asarray(C.indices),
                               np.asarray(C.indptr)), shape=C.shape).tocoo()
            parts.append(sp.coo_matrix(
                (S.data, (S.row + r0, S.col + j0)), shape=(n, m)))
        total = parts[0] if parts else sp.coo_matrix((n, m))
        for p in parts[1:]:
            total = total + p
        A = total.tocsr()
        from tpu_sparse.sparse.convert import csr_from_arrays

        return csr_from_arrays(A.data, A.indices, A.indptr, (n, m))

    def todense(self) -> jax.Array:
        return jnp.asarray(self.tocsr().todense())

    @property
    def T(self) -> "CWELLSeg":
        """Transpose (host-side repack; not jit-safe)."""
        At = self.tocsr().T
        return csr_to_cwell_segments(
            At, seg_cols=_round_up(max(self.widths), WIN))

    def __matmul__(self, x):
        from tpu_sparse.kernels import spmm, spmv

        if x.ndim == 1:
            return spmv(self, x)
        return spmm(self, x)

    def __repr__(self):
        return (f"CWELLSeg(shape={self.shape}, "
                f"segments={len(self.segments)}, nnz={self.nnz})")


def csr_to_cwell_segments(A: CSR, *, seg_cols: int = 1 << 20,
                          plane_pad: int = 8,
                          group: int = 1) -> CWELLSeg:
    """Split A into 256-aligned column segments and pack each as CWELL."""
    import scipy.sparse as sp

    assert seg_cols % WIN == 0, "segment width must be 256-aligned"
    n, m = A.shape
    S = sp.csr_matrix(
        (np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr)),
        shape=(n, m)).tocsc()
    from tpu_sparse.sparse.convert import csr_from_arrays

    def pack_one(j0: int):
        j1 = min(j0 + seg_cols, m)
        sub = S[:, j0:j1].tocsr()
        if sub.nnz == 0:
            return None
        # pack only the 128-aligned row-block range with nonzeros in this
        # column segment — otherwise every segment pads ALL row blocks to
        # its plane count and fill collapses by ~n_segments
        rnz = np.flatnonzero(np.diff(sub.indptr))
        r0 = int(rnz[0]) // LW * LW
        r1 = min(_round_up(int(rnz[-1]) + 1, LW), n)
        sub = sub[r0:r1]
        Wc = csr_to_cwell(csr_from_arrays(sub.data, sub.indices,
                                          sub.indptr, (r1 - r0, j1 - j0)),
                          plane_pad=plane_pad, group=group)
        return Wc, j0, j1 - j0, r0

    # sequential: packing is memory-bandwidth bound on fresh allocations
    # (threaded packing measured 20% SLOWER from page-fault contention)
    packed = [pack_one(j) for j in range(0, m, seg_cols)]
    segments, starts, widths, rstarts = [], [], [], []
    for entry in packed:
        if entry is None:
            continue
        Wc, j0, w, r0 = entry
        segments.append(Wc)
        starts.append(j0)
        widths.append(w)
        rstarts.append(r0)
    if not segments:  # all-zero matrix: keep one empty segment
        segments = [csr_to_cwell(A, plane_pad=plane_pad, group=group)]
        starts, widths, rstarts = [0], [m], [0]
    return CWELLSeg(segments, starts, widths, (n, m),
                    nnz=int(np.asarray(A.indptr)[-1]), rstarts=rstarts)


def rcm_permutation(A: CSR) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering (host, scipy) — bandwidth/locality
    reduction so arbitrary matrices pack into CWELL at high fill."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = sp.csr_matrix(
        (np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr)),
        shape=A.shape)
    return np.asarray(reverse_cuthill_mckee(S, symmetric_mode=False))


SPARSE_TYPES.append(CWELL)
SPARSE_TYPES.append(CWELLSeg)
