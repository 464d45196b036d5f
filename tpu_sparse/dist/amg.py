"""Distributed AMG: row-sharded hierarchy over a device mesh.

Replicating the whole hierarchy on every device would keep level storage
from scaling past one device's memory. Here every level is row-sharded:

* level matrices convert host-side to **CWELL** (sparse/cwell.py), whose
  row-block-regular arrays shard evenly along the block axis — the sparse
  analogue of sharding a dense (n, k) weight;
* prolongators P (n×nc) shard like the fine vectors; restrictions R
  (nc×n) shard along their own (coarse) rows;
* smoother diagonals and all level vectors shard with their rows;
* only the small dense coarse inverse is replicated.

The V-cycle itself is the unmodified single-device `precond.amg.v_cycle`:
under jit, the GSPMD partitioner propagates the row shardings through the
CWELL gathers/reductions and inserts the all-gathers for the window reads
— the scaling-book recipe (mesh + annotations, XLA inserts collectives).

Capability analogue: AMGX keeps its whole hierarchy on one GPU
(/root/reference/src/pytorch_sparse_solver/module_b/torch_amgx.py:140-141);
distribution has no reference counterpart and comes from the north star.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.tree_util import Partial

from tpu_sparse.dist.mesh import ROW_AXIS, make_row_mesh
from tpu_sparse.precond.amg import (
    AMGHierarchy,
    AMGLevel,
    _make_vcycle_apply,
    amg_setup,
)
from tpu_sparse.sparse.containers import CSR, DIA
from tpu_sparse.sparse.cwell import CWELL, csr_to_cwell


def _shard_cwell(W: CWELL, mesh: Mesh) -> CWELL:
    """Shard a CWELL matrix along its row-block axis (pads blocks to the
    mesh size; padded blocks are all-zero rows)."""
    nd = mesh.devices.size
    nb = W.n_blocks
    nb_pad = ((nb + nd - 1) // nd) * nd
    vals, idx2, srow = W.vals, W.idx2, W.srow
    if nb_pad != nb:
        vals = jnp.pad(vals, ((0, nb_pad - nb), (0, 0), (0, 0)))
        idx2 = jnp.pad(idx2, ((0, nb_pad - nb), (0, 0), (0, 0)))
        srow = jnp.pad(srow, ((0, nb_pad - nb), (0, 0)))
    blk = NamedSharding(mesh, P(ROW_AXIS, None, None))
    blk2 = NamedSharding(mesh, P(ROW_AXIS, None))
    return CWELL(jax.device_put(vals, blk), jax.device_put(idx2, blk),
                 jax.device_put(srow, blk2), W.shape, nnz=W._nnz,
                 fill=W.fill)


def _to_sharded_operator(A, mesh: Mesh):
    """Row-shard a level operator: DIA shards its data columns (rows of
    the matrix); CSR converts host-side to CWELL and shards block rows;
    TentativeP gathers shard with their (fine) rows. Operators too
    small/uneven to split stay replicated."""
    from tpu_sparse.precond.amg import TentativeP

    nd = mesh.devices.size
    if isinstance(A, TentativeP):
        if A.vals.shape[0] % nd != 0:
            return jax.device_put(A, NamedSharding(mesh, P()))
        row = NamedSharding(mesh, P(ROW_AXIS))
        return TentativeP(jax.device_put(A.vals, row),
                          jax.device_put(A.agg, row), A.shape)
    if isinstance(A, DIA):
        if A.data.shape[1] % nd != 0:
            return jax.device_put(A, NamedSharding(mesh, P()))
        sh = NamedSharding(mesh, P(None, ROW_AXIS))
        return DIA(jax.device_put(A.data, sh), A.offsets, A.shape)
    if isinstance(A, CWELL):
        return _shard_cwell(A, mesh)
    if isinstance(A, CSR):
        from tpu_sparse.sparse.cwell import AUTO_GROUP as _AG

        return _shard_cwell(csr_to_cwell(A, group=_AG), mesh)
    return jax.device_put(A, NamedSharding(mesh, P()))


def _shard_vector(v, mesh: Mesh):
    nd = mesh.devices.size
    if v.shape[0] % nd != 0:  # tiny coarse levels: replicate
        return jax.device_put(v, NamedSharding(mesh, P()))
    return jax.device_put(v, NamedSharding(mesh, P(ROW_AXIS)))


def shard_amg_hierarchy(hier: AMGHierarchy, mesh: Mesh) -> AMGHierarchy:
    """Re-place an AMG hierarchy with every level row-sharded (see module
    docstring). Setup stays host-side (amg_setup); this only moves data."""
    rep = NamedSharding(mesh, P())
    levels = []
    for lvl in hier.levels:
        levels.append(AMGLevel(
            A=_to_sharded_operator(lvl.A, mesh),
            P=None if lvl.P is None else _to_sharded_operator(lvl.P, mesh),
            R=None if lvl.R is None else _to_sharded_operator(lvl.R, mesh),
            dinv_l1=None if lvl.dinv_l1 is None
            else _shard_vector(lvl.dinv_l1, mesh),
        ))
    return AMGHierarchy(
        levels=tuple(levels),
        coarse_inv=jax.device_put(hier.coarse_inv, rep),
    )


def distributed_amg_preconditioner(A, mesh: Optional[Mesh] = None, *,
                                   pre_sweeps: int = 1, post_sweeps: int = 1,
                                   omega: float = 0.9,
                                   smoother: str = "l1_jacobi",
                                   **setup_kwargs) -> Partial:
    """Host AMG setup + row-sharded hierarchy placement; returns a V-cycle
    Partial usable as ``M=`` in the distributed solvers."""
    if mesh is None:
        mesh = make_row_mesh()
    hier = amg_setup(A, **setup_kwargs)
    hier = shard_amg_hierarchy(hier, mesh)
    return Partial(
        _make_vcycle_apply(pre_sweeps, post_sweeps, omega, smoother), hier)
