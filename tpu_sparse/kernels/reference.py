"""XLA (pure jnp) sparse kernels — the correctness oracle and general path.

These replace torch.sparse's SpMV/SpMM (reference solver.py:365,
matrix_utils.py:279). The general CSR/COO path lowers to an XLA scatter-add
(segment-sum); the DIA path is pure shifted vector arithmetic with no
gather, which XLA fuses into one loop; the BSR/BELL paths contract dense
blocks via batched dot at full precision (no TF32: these are the oracle).

All functions are jit-safe with static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_sparse.sparse.containers import BSR, COO, CSR, DIA


def coo_spmv(A: COO, x: jax.Array) -> jax.Array:
    prod = A.data * x[A.col]
    return jnp.zeros(A.shape[0], dtype=prod.dtype).at[A.row].add(prod)


def csr_spmv(A: CSR, x: jax.Array) -> jax.Array:
    rows = A.row_ids()
    prod = A.data * x[A.indices]
    return jax.ops.segment_sum(prod, rows, num_segments=A.shape[0])


def csr_spmv_transpose(A: CSR, x: jax.Array) -> jax.Array:
    """y = Aᵀ @ x without materializing the transpose: scatter-add of
    row-weighted values onto column indices."""
    rows = A.row_ids()
    prod = A.data * x[rows]
    return jnp.zeros(A.shape[1], dtype=prod.dtype).at[A.indices].add(prod)


def dia_spmv(A: DIA, x: jax.Array) -> jax.Array:
    """y[i] = sum_d data[d, i] * x[i + off_d] with static shifts (no gather):
    pad x by the bandwidth once and accumulate full-length shifted
    products (out-of-range entries of ``data`` multiply padding zeros).
    Of the two XLA formulations measured on the GPU (this one and a
    per-diagonal slice + dynamic_update_slice), this is the faster."""
    n, m = A.shape
    if not A.offsets:
        return jnp.zeros(n, dtype=x.dtype)
    lo = max(0, -min(A.offsets))
    hi = max(0, n - 1 + max(A.offsets) - (m - 1))
    xp = jnp.pad(x, (lo, hi))
    y = jnp.zeros(n, dtype=jnp.result_type(A.data.dtype, x.dtype))
    for d, o in enumerate(A.offsets):
        y = y + A.data[d] * jax.lax.dynamic_slice(xp, (lo + o,), (n,))
    return y


def bsr_spmv(A: BSR, x: jax.Array) -> jax.Array:
    bs = A.blocksize
    xb = x.reshape(-1, bs)  # (n_block_cols, bs)
    gathered = xb[A.indices]  # (nblocks, bs)
    prods = jnp.einsum(
        "nij,nj->ni", A.data, gathered,
        preferred_element_type=jnp.result_type(A.data.dtype, x.dtype),
        precision=jax.lax.Precision.HIGHEST,
    )  # (nblocks, bs)
    brow = A.block_row_ids()
    out = jax.ops.segment_sum(prods, brow, num_segments=A.n_block_rows)
    return out.reshape(-1)


def coo_spmm(A: COO, B: jax.Array) -> jax.Array:
    prod = A.data[:, None] * B[A.col]
    return jnp.zeros((A.shape[0], B.shape[1]), dtype=prod.dtype).at[A.row].add(prod)


def csr_spmm(A: CSR, B: jax.Array) -> jax.Array:
    rows = A.row_ids()
    prod = A.data[:, None] * B[A.indices]
    return jax.ops.segment_sum(prod, rows, num_segments=A.shape[0])


def dia_spmm(A: DIA, B: jax.Array) -> jax.Array:
    n, m = A.shape
    k = B.shape[1]
    y = jnp.zeros((n, k), dtype=jnp.result_type(A.data.dtype, B.dtype))
    for d, o in enumerate(A.offsets):
        i0 = max(0, -o)
        i1 = min(n, m - o)
        if i1 <= i0:
            continue
        seg = A.data[d, i0:i1, None] * jax.lax.slice(B, (i0 + o, 0), (i1 + o, k))
        y = jax.lax.dynamic_update_slice(y, jax.lax.dynamic_slice(y, (i0, 0), (i1 - i0, k)) + seg, (i0, 0))
    return y


def bell_spmv(A, x: jax.Array) -> jax.Array:
    """Block-ELL SpMV: fully regular — per block row, L dense (bs,bs)
    blocks times gathered x chunks."""
    bs = A.blocksize
    xb = x.reshape(-1, bs)  # (n_block_cols, bs)
    gathered = xb[A.indices]  # (nbr, L, bs)
    prods = jnp.einsum(
        "rlij,rlj->ri", A.blocks, gathered,
        preferred_element_type=jnp.result_type(A.blocks.dtype, x.dtype),
        precision=jax.lax.Precision.HIGHEST,
    )
    return prods.reshape(-1)


def bell_spmm(A, B: jax.Array) -> jax.Array:
    bs = A.blocksize
    Bb = B.reshape(-1, bs, B.shape[1])
    gathered = Bb[A.indices]  # (nbr, L, bs, k)
    prods = jnp.einsum(
        "rlij,rljk->rik", A.blocks, gathered,
        preferred_element_type=jnp.result_type(A.blocks.dtype, B.dtype),
        precision=jax.lax.Precision.HIGHEST,
    )
    return prods.reshape(A.shape[0], B.shape[1])


def cwell_spmv(A, x: jax.Array) -> jax.Array:
    """CWELL SpMV via XLA gather."""
    from tpu_sparse.sparse.cwell import LW

    n, m = A.shape
    gc = A.srow[:, :, None].astype(jnp.int32) * LW + A.idx2  # (nb, S, 128)
    xg = jnp.take(x, gc.reshape(-1), mode="fill",
                  fill_value=0).reshape(gc.shape)
    y = jnp.sum(A.vals * xg.astype(A.vals.dtype), axis=1)  # (nb, 128)
    return y.reshape(-1)[:n]


def cwell_spmm(A, B: jax.Array) -> jax.Array:
    from tpu_sparse.sparse.cwell import LW

    n, m = A.shape
    k = B.shape[1]
    gc = A.srow[:, :, None].astype(jnp.int32) * LW + A.idx2
    Bg = jnp.take(B, gc.reshape(-1), axis=0, mode="fill",
                  fill_value=0).reshape(gc.shape + (k,))
    y = jnp.sum(A.vals[..., None] * Bg.astype(A.vals.dtype), axis=1)
    return y.reshape(-1, k)[:n]


def bsr_spmm(A: BSR, B: jax.Array) -> jax.Array:
    bs = A.blocksize
    k = B.shape[1]
    Bb = B.reshape(-1, bs, k)  # (n_block_cols, bs, k)
    gathered = Bb[A.indices]  # (nblocks, bs, k)
    prods = jnp.einsum(
        "nij,njk->nik", A.data, gathered,
        preferred_element_type=jnp.result_type(A.data.dtype, B.dtype),
        precision=jax.lax.Precision.HIGHEST,
    )
    brow = A.block_row_ids()
    out = jax.ops.segment_sum(prods, brow, num_segments=A.n_block_rows)
    return out.reshape(A.shape[0], k)
