"""Operator format choice for the device SpMV.

`to_tpu_operator` inspects a general sparse matrix (host-side, once, at
operator construction) and promotes it to a structured format:

1. stencil-structured (few distinct diagonals) → DIA (shifted products,
                                                 no gather);
2. anything with column locality (fill ≥ threshold after packing,
   optionally RCM-reordered)                   → CWELL (windowed gather);
3. block-structured (dense blocks fill well)   → BELL (dense block
                                                 products);
4. otherwise                                   → CSR (XLA segment-sum).

This is the user-facing answer to "what replaces cuSPARSE for arbitrary
matrices": pick the structure the kernels can exploit, fall back to the
general scatter-add path when there is none. The CWELL and BELL rules
were tuned for kernels this package no longer has; they are kept until
the GPU measurement of each format decides them (ROADMAP.md).
"""

from __future__ import annotations

from typing import Union

import numpy as np

from tpu_sparse.sparse.bell import BELL, bsr_to_bell
from tpu_sparse.sparse.containers import BSR, COO, CSR, DIA
from tpu_sparse.sparse.convert import csr_to_bsr, csr_to_dia, to_csr
from tpu_sparse.sparse.cwell import CWELL, CWELLSeg, csr_to_cwell


def _block_fill_ratio(A: CSR, bs: int) -> float:
    """nnz / (occupied blocks × bs²) — how dense the occupied blocks are."""
    indptr = np.asarray(A.indptr)
    indices = np.asarray(A.indices)
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(indptr))
    keys = (rows // bs).astype(np.int64) * ((A.shape[1] + bs - 1) // bs) \
        + indices // bs
    nblocks = np.unique(keys).size
    return A.nnz / (nblocks * bs * bs)


def to_tpu_operator(A, *, max_diags: int = 64, block_size: int = 8,
                    min_block_fill: float = 0.35,
                    min_cwell_fill: float = 0.25,
                    verbose: bool = False) -> Union[DIA, BELL, CWELL, CWELLSeg, CSR]:
    """Promote ``A`` to the best structured format (host-side analysis)."""
    if isinstance(A, (DIA, BELL, CWELL, CWELLSeg)):
        return A
    Ac = to_csr(A)
    n, m = Ac.shape

    dia = csr_to_dia(Ac, max_diags=max_diags)
    if dia is not None:
        if verbose:
            print(f"[to_tpu_operator] DIA with {dia.ndiag} diagonals")
        return dia

    # Past the pack-size limit on x (sparse/cwell.py), pack column
    # segments instead (y sums across segments). Per-segment plane padding
    # costs some fill, so the bar is half the usual one. f64 halves the
    # cap and the segment width.
    from tpu_sparse.sparse.cwell import X_COLS_LIMIT, csr_to_cwell_segments

    _X_CAP = X_COLS_LIMIT
    if np.asarray(Ac.data).dtype == np.float64:
        _X_CAP //= 2
        _SEG_COLS = 1 << 19
    else:
        _SEG_COLS = 1 << 20
    if m > _X_CAP:
        from tpu_sparse.sparse.cwell import AUTO_GROUP

        seg = csr_to_cwell_segments(Ac, seg_cols=_SEG_COLS,
                                    group=AUTO_GROUP)
        if seg.fill >= min_cwell_fill * 0.5:
            if verbose:
                print(f"[to_tpu_operator] CWELLSeg fill={seg.fill:.2f} "
                      f"segments={len(seg.segments)}")
            return seg
    else:
        from tpu_sparse.sparse.cwell import AUTO_GROUP

        cw = csr_to_cwell(Ac, group=AUTO_GROUP)
        if cw.fill >= min_cwell_fill:
            if verbose:
                print(f"[to_tpu_operator] CWELL fill={cw.fill:.2f} "
                      f"S={cw.planes}")
            return cw

    if n % block_size == 0 and m % block_size == 0:
        fill = _block_fill_ratio(Ac, block_size)
        if fill >= min_block_fill:
            if verbose:
                print(f"[to_tpu_operator] BELL bs={block_size} "
                      f"fill={fill:.2f}")
            return bsr_to_bell(csr_to_bsr(Ac, block_size))

    if verbose:
        print(f"[to_tpu_operator] CSR general path "
              f"(CWELL fill below {min_cwell_fill})")
    return Ac
