"""Batched host→device pytree transfer.

``jax.device_put`` of a large pytree issues one transfer per leaf (the
AMG hierarchy and the supernodal factor plans hold hundreds of leaves).
``batched_device_put`` concatenates all leaves
of each dtype into ONE host buffer, ships the few big buffers, and
slices them back into the original leaves ON DEVICE in one jitted
program (donated input, so peak HBM is ~one buffer extra).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def batched_device_put(tree, device=None):
    """Equivalent of ``jax.device_put(tree, device)`` with O(#dtypes)
    transfers instead of O(#leaves). Non-array leaves pass through."""
    if device is None:
        device = jax.devices()[0]
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = [None] * len(leaves)
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        if not hasattr(leaf, "dtype") or not hasattr(leaf, "shape"):
            out[i] = leaf
            continue
        a = np.asarray(leaf)
        groups.setdefault(a.dtype.str, []).append((i, a))
    for _, items in groups.items():
        flats = [a.ravel() for _, a in items]
        sizes = [int(f.size) for f in flats]
        offs = np.cumsum([0] + sizes)
        buf = np.concatenate(flats) if len(flats) > 1 else flats[0]
        dbuf = jax.device_put(buf, device)
        del buf

        shapes = tuple(a.shape for _, a in items)
        bounds = tuple(int(o) for o in offs[:-1])
        szs = tuple(sizes)

        @functools.partial(jax.jit, donate_argnums=0,
                           static_argnums=(1, 2, 3))
        def _slice(b, bounds_, szs_, shapes_):
            return [jax.lax.dynamic_slice(b, (o,), (s,)).reshape(sh)
                    for o, s, sh in zip(bounds_, szs_, shapes_)]

        pieces = _slice(dbuf, bounds, szs, shapes)
        for (i, _), p in zip(items, pieces):
            out[i] = p
    return jax.tree_util.tree_unflatten(treedef, out)
