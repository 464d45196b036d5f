"""Row partitioning of sparse operands onto a device mesh.

DIA (banded/stencil) matrices row-partition perfectly: the (ndiag, n) data
array shards along its row dimension, and SpMV needs only a halo of width
``bandwidth`` from each neighbor — the structural analogue of context
parallelism (SURVEY.md §5 'long-context' note).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tpu_sparse.dist.mesh import ROW_AXIS, row_sharding
from tpu_sparse.sparse.containers import DIA


def _pad_rows_to(n: int, n_dev: int) -> int:
    return ((n + n_dev - 1) // n_dev) * n_dev


def pad_dia(A: DIA, n_dev: int) -> DIA:
    """Pad a square DIA matrix with identity rows so n divides the mesh.

    The padding block is the identity, so solving the padded system leaves
    the added coordinates at b's padded value (zero) without affecting the
    original solution."""
    n, m = A.shape
    n_pad = _pad_rows_to(n, n_dev)
    if n_pad == n:
        return A
    offsets = A.offsets if 0 in A.offsets else A.offsets + (0,)
    data = jnp.zeros((len(offsets), n_pad), dtype=A.dtype)
    for d, o in enumerate(offsets):
        if o in A.offsets:
            src = A.data[A.offsets.index(o)]
            data = data.at[d, :n].set(src)
        if o == 0:
            data = data.at[d, n:].set(1.0)
    # zero out entries whose column index falls into [n, n_pad) from
    # original rows (there are none: original offsets never reach past m
    # within rows < n ... only sub/super diagonals of padded rows, zeroed).
    return DIA(data, offsets, (n_pad, n_pad))


def pad_vector(b: jax.Array, n_dev: int, unit: int = 1) -> jax.Array:
    """Pad b with zeros to a multiple of n_dev*unit (unit=128 for CWELL
    row blocks)."""
    n = b.shape[0]
    n_pad = _pad_rows_to(n, n_dev * unit)
    if n_pad == n:
        return b
    return jnp.pad(b, (0, n_pad - n))


def pad_csr_identity(A, n_pad: int):
    """Host-side: extend a square CSR system to n_pad rows/cols with unit
    diagonal padding (solution stays zero on the padded coordinates)."""
    import numpy as np
    import scipy.sparse as sp

    from tpu_sparse.sparse.convert import csr_from_arrays, to_csr

    Ac = to_csr(A)
    n, m = Ac.shape
    if n_pad == n:
        return Ac
    A_sp = sp.csr_matrix(
        (np.asarray(Ac.data), np.asarray(Ac.indices),
         np.asarray(Ac.indptr)), shape=Ac.shape)
    pad = sp.identity(n_pad - n, dtype=A_sp.dtype, format="csr")
    A_big = sp.block_diag([A_sp, pad], format="csr")
    return csr_from_arrays(A_big.data, A_big.indices, A_big.indptr,
                           (n_pad, n_pad))


def shard_general(A, mesh: Mesh):
    """Row-shard a general-structure square matrix (CSR/COO/BSR/CWELL/...)
    as CWELL blocks over the mesh.

    Host-side (concrete operands only): pads the system with identity rows
    to a multiple of mesh_size*128 (CWELL's row-block height), packs to
    CWELL, and places the block arrays row-sharded. The distributed SpMV
    for general structure is all_gather-based (dist.spmv.
    make_cwell_allgather_spmv) — no bandwidth assumption."""
    from tpu_sparse.sparse.cwell import LW, CWELL, csr_to_cwell

    n_dev = mesh.devices.size
    if isinstance(A, CWELL):
        n, m = A.shape
        if n == m and n % (n_dev * LW) == 0 and A.n_blocks % n_dev == 0:
            W = A
        else:
            W = None
    else:
        W = None
    if W is None:
        from tpu_sparse.sparse.cwell import CWELL as _CW

        Ac = A.tocsr() if isinstance(A, _CW) else A
        n = Ac.shape[0]
        if Ac.shape[0] != Ac.shape[1]:
            raise ValueError("distributed solves need a square system")
        n_pad = _pad_rows_to(n, n_dev * LW)
        from tpu_sparse.sparse.cwell import AUTO_GROUP as _AG

        W = csr_to_cwell(pad_csr_identity(Ac, n_pad), group=_AG)
    sh3 = row_sharding(mesh, ndim=3, row_axis_pos=0)
    sh2 = row_sharding(mesh, ndim=2, row_axis_pos=0)
    return CWELL(jax.device_put(W.vals, sh3),
                 jax.device_put(W.idx2, sh3),
                 jax.device_put(W.srow, sh2),
                 W.shape, nnz=W.nnz, fill=W.fill)


def shard_general_planned(A, mesh: Mesh):
    """Row-shard a general matrix AND build its halo-exchange plan from
    the pre-shard host pack.

    Unlike ``dist.spmv.plan_cwell_halo`` (which fetches pack metadata
    from an already-sharded matrix and therefore only works when every
    shard is addressable), the plan here is computed on the host copy
    BEFORE placement — every controller of a multi-process mesh derives
    the identical (wl, wr, srow_local) deterministically, so real pods
    get cut-volume halo exchange instead of all_gather. Returns
    ``(W_sharded, halo_or_None)``; halo shares vals/idx2 device buffers
    with W_sharded (only the shifted srow is an extra placement)."""
    import numpy as np

    from tpu_sparse.dist.spmv import HaloCWELL, plan_halo_host
    from tpu_sparse.sparse.cwell import LW, CWELL as _CW, csr_to_cwell

    n_dev = mesh.devices.size
    W = None
    if isinstance(A, _CW):
        n, m = A.shape
        if n == m and n % (n_dev * LW) == 0 and A.n_blocks % n_dev == 0 \
                and getattr(A.vals, "is_fully_addressable", True):
            W = A
    if W is None and not isinstance(A, _CW):
        Ac = A
        if Ac.shape[0] != Ac.shape[1]:
            raise ValueError("distributed solves need a square system")
        n_pad = _pad_rows_to(Ac.shape[0], n_dev * LW)
        from tpu_sparse.sparse.cwell import AUTO_GROUP as _AG

        W = csr_to_cwell(pad_csr_identity(Ac, n_pad), group=_AG)
    if W is None:  # pre-sharded multi-process CWELL: cannot fetch metadata
        return shard_general(A, mesh), None
    sh3 = row_sharding(mesh, ndim=3, row_axis_pos=0)
    sh2 = row_sharding(mesh, ndim=2, row_axis_pos=0)
    srow_np = np.asarray(W.srow)
    used_np = np.asarray(W.vals != 0).any(axis=2)
    vals_sh = jax.device_put(W.vals, sh3)
    idx2_sh = jax.device_put(W.idx2, sh3)
    W_sh = _CW(vals_sh, idx2_sh, jax.device_put(W.srow, sh2),
                 W.shape, nnz=W.nnz, fill=W.fill, group=W.group)
    plan = plan_halo_host(srow_np, used_np, W.shape, n_dev)
    if plan is None:
        return W_sh, None
    wl, wr, srow_l = plan
    W_l = _CW(vals_sh, idx2_sh,
                jax.device_put(jnp.asarray(srow_l), sh2),
                W.shape, nnz=W.nnz, fill=W.fill, group=W.group)
    return W_sh, HaloCWELL(W_l, wl, wr)


def shard_dia(A: DIA, mesh: Mesh) -> DIA:
    """Place a DIA matrix row-sharded on the mesh (pads to divisibility).

    No bandwidth constraint: when bandwidth exceeds the shard size the
    halo-exchange SpMV falls back to an all_gather of x
    (dist.spmv.make_allgather_spmv); gspmd mode never needed one."""
    n_dev = mesh.devices.size
    A = pad_dia(A, n_dev)
    data = jax.device_put(A.data, row_sharding(mesh, ndim=2, row_axis_pos=1))
    return DIA(data, A.offsets, A.shape)


def shard_vector(b: jax.Array, mesh: Mesh, unit: int = 1) -> jax.Array:
    n_dev = mesh.devices.size
    b = pad_vector(b, n_dev, unit)
    return jax.device_put(b, row_sharding(mesh, ndim=1))


def local_rows(n: int, mesh: Mesh) -> int:
    n_dev = mesh.devices.size
    return _pad_rows_to(n, n_dev) // n_dev
