"""Distributed SpMV with explicit halo exchange (shard_map + ppermute).

Each device owns a contiguous block of rows of a DIA matrix plus the
matching slice of x. One SpMV:

  1. neighbor halo strips of width = bandwidth move between devices via
     `lax.ppermute` (left and right concurrently — both directions of the
     ring are used),
  2. the local stencil SpMV runs over [halo_l | x_local | halo_r],
  3. no reduction is needed (row partitioning ⇒ each output row is local).

XLA's latency-hiding scheduler overlaps the two ppermutes with the start of
the local compute on the interior rows. XLA lowers the ppermutes to NCCL
on the GPU; this replaces a hand-written NCCL halo exchange
(SURVEY.md §2.3).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from tpu_sparse.dist.mesh import ROW_AXIS
from tpu_sparse.sparse.containers import DIA


def _local_dia_spmv_ext(data: jax.Array, x_ext: jax.Array,
                        offsets: tuple, w: int) -> jax.Array:
    """y[i] = Σ_d data[d, i] * x_ext[w + i + o_d]; x_ext has w-wide halos."""
    s = data.shape[1]
    y = jnp.zeros((s,), dtype=jnp.result_type(data.dtype, x_ext.dtype))
    for d, o in enumerate(offsets):
        y = y + data[d] * lax.dynamic_slice(x_ext, (w + o,), (s,))
    return y


def _halo_exchange(x_local: jax.Array, w: int, n_dev: int):
    """Fetch right edge of left neighbor and left edge of right neighbor."""
    # halo from left neighbor: device i receives x_local[-w:] of device i-1
    send_right = [(i, i + 1) for i in range(n_dev - 1)]
    left_halo = lax.ppermute(x_local[-w:], ROW_AXIS, perm=send_right)
    # halo from right neighbor: device i receives x_local[:w] of device i+1
    send_left = [(i + 1, i) for i in range(n_dev - 1)]
    right_halo = lax.ppermute(x_local[:w], ROW_AXIS, perm=send_left)
    return left_halo, right_halo


def make_halo_spmv(A: DIA, mesh: Mesh) -> Callable[[jax.Array], jax.Array]:
    """Return x ↦ A@x with explicit halo exchange over ``mesh``.

    ``A`` must already be row-sharded (dist.partition.shard_dia)."""
    w = max(A.bandwidth, 1)
    n_dev = mesh.devices.size
    offsets = A.offsets

    def local_fn(data_local, x_local):
        left, right = _halo_exchange(x_local, w, n_dev)
        x_ext = jnp.concatenate([left, x_local, right])
        return _local_dia_spmv_ext(data_local, x_ext, offsets, w)

    shmapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(None, ROW_AXIS), P(ROW_AXIS)),
        out_specs=P(ROW_AXIS),
    )

    def spmv_fn(x):
        return shmapped(A.data, x)

    return spmv_fn


def make_allgather_spmv(A: DIA, mesh: Mesh) -> Callable[[jax.Array], jax.Array]:
    """Return x ↦ A@x where each device all-gathers x before the local
    stencil pass.

    Fallback for bandwidth > shard size, where single-hop neighbor halos
    cannot supply all remote columns. The all_gather rides ICI as a ring
    collective; local compute covers only the owned rows, so the result
    stays row-sharded like the halo path. ``A`` must already be row-sharded
    (dist.partition.shard_dia)."""
    w = max(A.bandwidth, 1)
    n = A.shape[0]
    n_dev = mesh.devices.size
    s = n // n_dev
    offsets = A.offsets

    def local_fn(data_local, x_local):
        x_full = lax.all_gather(x_local, ROW_AXIS, tiled=True)  # (n,)
        xp = jnp.pad(x_full, (w, w))
        i0 = lax.axis_index(ROW_AXIS) * s
        y = jnp.zeros((s,), dtype=jnp.result_type(data_local.dtype,
                                                  x_local.dtype))
        for d, o in enumerate(offsets):
            y = y + data_local[d] * lax.dynamic_slice(xp, (w + i0 + o,), (s,))
        return y

    shmapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(None, ROW_AXIS), P(ROW_AXIS)),
        out_specs=P(ROW_AXIS),
    )

    def spmv_fn(x):
        return shmapped(A.data, x)

    return spmv_fn


def halo_dia_spmv(A: DIA, x: jax.Array, mesh: Mesh) -> jax.Array:
    """One-shot distributed SpMV (see make_halo_spmv)."""
    return make_halo_spmv(A, mesh)(x)


@jax.tree_util.register_pytree_node_class
class HaloCWELL:
    """A row-sharded CWELL plus its halo-exchange plan.

    ``W``'s srow metadata is pre-shifted into each device's LOCAL frame
    ``[own_start - wl, own_end + wr)`` so the local kernel indexes the
    concatenated [left_halo | x_local | right_halo] directly. ``wl``/``wr``
    are the max left/right column overhangs of any device's packed
    windows, rounded to 128 — per-device receive volume is the partition
    CUT (wl + wr elements), not n, restoring the halo-SpMV scaling the
    DIA path has for general matrices whose partition has column
    locality (e.g. RCM-ordered); locality-poor partitions plan to None
    and keep the all_gather path."""

    def __init__(self, W, wl: int, wr: int):
        self.W = W
        self.wl = int(wl)
        self.wr = int(wr)

    @property
    def shape(self):
        return self.W.shape

    def tree_flatten(self):
        return (self.W,), (self.wl, self.wr)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])


def plan_halo_host(srow_np, used_np, shape, n_dev: int):
    """Pure host-side halo planner on CWELL pack metadata.

    ``srow_np``/``used_np`` are the (n_blocks, S) window-start and
    plane-has-nnz arrays of the UNSHARDED pack; every controller of a
    multi-process mesh computes the identical plan from its own host
    copy (deterministic numpy). Returns ``(wl, wr, srow_local)`` or
    ``None`` when the exchange would not beat all_gather (hops spanning
    the whole ring, or cut volume ~n)."""
    import numpy as np

    from tpu_sparse.sparse.cwell import LW

    n, m = shape
    n_blocks = srow_np.shape[0]
    if n != m or n_blocks % n_dev != 0 or not used_np.any():
        return None
    s = n // n_dev
    nb_loc = n_blocks // n_dev
    wl = wr = 0
    for d in range(n_dev):
        blk = slice(d * nb_loc, (d + 1) * nb_loc)
        u = used_np[blk]
        if not u.any():
            continue
        sr = srow_np[blk][u]
        lo = int(sr.min()) * LW
        hi = (int(sr.max()) + 2) * LW
        wl = max(wl, d * s - lo)
        wr = max(wr, hi - (d + 1) * s)
    wl = max(0, -(-wl // LW) * LW)
    wr = max(0, -(-wr // LW) * LW)
    # halo hops stay within the ring, and the exchange must actually be
    # cheaper than gathering the rest of x — otherwise keep all_gather
    hops_l, hops_r = -(-wl // s), -(-wr // s)
    if max(hops_l, hops_r) >= n_dev or wl + wr >= (n - s):
        return None
    # shift srow into each device's local frame [d*s - wl, (d+1)*s + wr)
    dev_of_block = np.repeat(np.arange(n_dev), nb_loc)
    shift = (dev_of_block * s - wl) // LW   # (n_blocks,)
    srow_l = srow_np - shift[:, None]
    hi_clamp = (wl + s + wr) // LW - 2
    srow_l = np.clip(srow_l, 0, max(hi_clamp, 0)).astype(srow_np.dtype)
    return wl, wr, srow_l


def plan_cwell_halo(W, mesh: Mesh):
    """Halo plan for an ALREADY-SHARDED CWELL (fetches pack metadata to
    host — single-controller only; multi-process solves get their plan
    from the pre-shard host copy in ``partition.shard_general_planned``
    instead, which this function merely mirrors).

    Returns a HaloCWELL with srow shifted to the local frame — or None
    when any device's windows overhang beyond what the ring exchange can
    supply (caller keeps the all_gather SpMV)."""
    import numpy as np

    from tpu_sparse.sparse.cwell import CWELL

    n_dev = mesh.devices.size
    if W.shape[0] != W.shape[1] or W.n_blocks % n_dev != 0:
        return None
    if not (getattr(W.srow, "is_fully_addressable", True)
            and getattr(W.vals, "is_fully_addressable", True)):
        return None  # direct call on a multi-process pack: cannot fetch
    srow = np.asarray(W.srow)            # (n_blocks, S)
    used = np.asarray(
        jnp.any(W.vals != 0, axis=2))    # (n_blocks, S) plane has nnz
    plan = plan_halo_host(srow, used, W.shape, n_dev)
    if plan is None:
        return None
    wl, wr, srow_l = plan
    W_l = CWELL(W.vals, W.idx2,
                jax.device_put(jnp.asarray(srow_l), W.srow.sharding),
                W.shape, nnz=W._nnz, fill=W.fill, group=W.group)
    return HaloCWELL(W_l, wl, wr)


def make_cwell_halo_spmv(H: "HaloCWELL",
                         mesh: Mesh) -> Callable[[jax.Array], jax.Array]:
    """x ↦ A@x for a halo-planned general CWELL: bidirectional ppermute
    of the boundary strips — multi-hop when a window overhang spans more
    than one neighbor shard, with total receive volume exactly wl + wr
    (the partition cut) — then the local column-window kernel on
    [left halos | x_local | right halos]."""
    from tpu_sparse.sparse.cwell import LW, CWELL

    W = H.W
    wl, wr = H.wl, H.wr
    n, m = W.shape
    n_dev = mesh.devices.size
    nb_loc = W.n_blocks // n_dev
    s = n // n_dev
    m_loc = wl + s + wr
    hops_l, hops_r = -(-wl // s), -(-wr // s)

    def local_fn(vals, idx2, srow, x_local):
        from tpu_sparse.kernels import spmv as _spmv

        parts = []
        # left frame [d·s − wl, d·s): neighbor d−k supplies, for the
        # furthest hop, only the needed tail of its shard — volume = wl
        for k in range(hops_l, 0, -1):
            amt = min(s, wl - (k - 1) * s)
            perm = [(i, i + k) for i in range(n_dev - k)]
            parts.append(lax.ppermute(x_local[-amt:], ROW_AXIS, perm=perm))
        parts.append(x_local)
        for k in range(1, hops_r + 1):
            amt = min(s, wr - (k - 1) * s)
            perm = [(i + k, i) for i in range(n_dev - k)]
            parts.append(lax.ppermute(x_local[:amt], ROW_AXIS, perm=perm))
        x_ext = jnp.concatenate(parts) if len(parts) > 1 else x_local
        W_loc = CWELL(vals, idx2, srow, (nb_loc * LW, m_loc),
                      group=W.group)
        return _spmv(W_loc, x_ext)

    shmapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(ROW_AXIS, None, None), P(ROW_AXIS, None, None),
                  P(ROW_AXIS, None), P(ROW_AXIS)),
        out_specs=P(ROW_AXIS),
    )

    def spmv_fn(x):
        return shmapped(W.vals, W.idx2, W.srow, x)

    return spmv_fn


def make_cwell_allgather_spmv(W, mesh: Mesh) -> Callable[[jax.Array],
                                                         jax.Array]:
    """Distributed SpMV for GENERAL-structure matrices: each device owns a
    contiguous run of CWELL row blocks, all-gathers x, and runs the local
    column-window SpMV. No bandwidth/stencil assumption — this is the distributed
    counterpart of the cuSPARSE general-format capability (SURVEY.md §2.2).

    ``W`` must already be row-sharded (dist.partition.shard_general):
    square, n divisible by mesh_size*128."""
    from tpu_sparse.sparse.cwell import LW, CWELL

    n, m = W.shape
    n_dev = mesh.devices.size
    nb_loc = W.n_blocks // n_dev

    def local_fn(vals, idx2, srow, x_local):
        from tpu_sparse.kernels import spmv as _spmv

        x_full = lax.all_gather(x_local, ROW_AXIS, tiled=True)  # (m,)
        W_loc = CWELL(vals, idx2, srow, (nb_loc * LW, m))
        return _spmv(W_loc, x_full)

    shmapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(ROW_AXIS, None, None), P(ROW_AXIS, None, None),
                  P(ROW_AXIS, None), P(ROW_AXIS)),
        out_specs=P(ROW_AXIS),
    )

    def spmv_fn(x):
        return shmapped(W.vals, W.idx2, W.srow, x)

    return spmv_fn
