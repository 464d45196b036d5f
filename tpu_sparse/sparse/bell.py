"""BELL — block-ELL format: the regular form of BSR.

Each block row stores a fixed number L of (bs, bs) dense blocks (padded
with zero blocks at block-column 0), which makes the SpMV/SpMM loop fully
regular: no per-row variable lengths, one batched dense block product
(`kernels/reference.py` bell_spmv/bell_spmm).

This is the "first-class BSR kernel" capability of the north star
(SURVEY.md §2.2): general sparse matrices with block structure convert
BSR → BELL once at operator construction and then run regular kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sparse.sparse.containers import BSR, SPARSE_TYPES


@jax.tree_util.register_pytree_node_class
class BELL:
    """Block-ELL matrix.

    Attributes:
      blocks: (n_block_rows, L, bs, bs) dense blocks (zero-padded).
      indices: (n_block_rows, L) int32 block-column ids (0 for padding).
      shape: static (n_rows, n_cols).
    """

    def __init__(self, blocks, indices, shape):
        self.blocks = blocks
        self.indices = indices
        self.shape = tuple(int(s) for s in shape)

    def tree_flatten(self):
        return (self.blocks, self.indices), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])

    @property
    def blocksize(self) -> int:
        return int(self.blocks.shape[2])

    @property
    def n_block_rows(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def ell_width(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def nnz(self) -> int:
        return int(self.blocks.shape[0] * self.blocks.shape[1]
                   * self.blocksize ** 2)

    def with_data(self, blocks) -> "BELL":
        return BELL(blocks, self.indices, self.shape)

    def todense(self) -> jax.Array:
        bs = self.blocksize
        n, m = self.shape
        out = jnp.zeros((n, m), self.dtype)
        for l in range(self.ell_width):
            rows = jnp.arange(self.n_block_rows)
            # scatter each block stripe
            out = out.at[
                (rows[:, None, None] * bs
                 + jnp.arange(bs)[None, :, None]),
                (self.indices[:, l][:, None, None] * bs
                 + jnp.arange(bs)[None, None, :]),
            ].add(self.blocks[:, l])
        return out

    def __matmul__(self, x):
        from tpu_sparse.kernels import spmv, spmm

        if x.ndim == 1:
            return spmv(self, x)
        return spmm(self, x)

    def __repr__(self):
        return (f"BELL(shape={self.shape}, block_rows={self.n_block_rows}, "
                f"L={self.ell_width}, bs={self.blocksize})")


def bsr_to_bell(A: BSR, ell_width: int | None = None) -> BELL:
    """Convert BSR → BELL on host (pads each block row to the max — or
    given — number of blocks per row)."""
    nbr = A.n_block_rows
    bs = A.blocksize
    indptr = np.asarray(A.indptr)
    indices = np.asarray(A.indices)
    data = np.asarray(A.data)
    counts = np.diff(indptr)
    L = int(counts.max()) if ell_width is None else int(ell_width)
    if (counts > L).any():
        raise ValueError(f"ell_width {L} < max blocks per row "
                         f"{int(counts.max())}")
    blocks = np.zeros((nbr, L, bs, bs), dtype=data.dtype)
    idx = np.zeros((nbr, L), dtype=np.int32)
    for r in range(nbr):
        c = counts[r]
        blocks[r, :c] = data[indptr[r]:indptr[r + 1]]
        idx[r, :c] = indices[indptr[r]:indptr[r + 1]]
    return BELL(jnp.asarray(blocks), jnp.asarray(idx), A.shape)


SPARSE_TYPES.append(BELL)
