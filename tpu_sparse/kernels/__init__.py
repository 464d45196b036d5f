"""Kernel dispatch: route SpMV/SpMM to the kernel for the container.

On the GPU, f32 DIA SpMV runs the Pallas Triton kernel
(`kernels/dia_triton.py`), which beats the XLA formulation end to end in
CG (PERF.md). Every other case — and every CPU run — maps to one jit-safe
XLA kernel in `kernels/reference.py`.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from tpu_sparse.kernels import dia_triton
from tpu_sparse.kernels import reference as ref
from tpu_sparse.sparse.containers import BSR, COO, CSR, DIA, is_sparse


def _on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def _cwellseg_apply(A, operand, seg_fn, out_cols=None):
    """Sum per-segment applications into (n,) or (n, k) output, writing
    each segment's contribution into its touched row range."""
    n = A.shape[0]
    out = None
    for W, j0, w, r0 in zip(A.segments, A.starts, A.widths, A.rstarts):
        t = seg_fn(W, jax.lax.slice_in_dim(operand, j0, j0 + w, axis=0))
        if W.shape[0] == n and r0 == 0:
            out = t if out is None else out + t
        else:
            if out is None:
                shape = (n,) if out_cols is None else (n, t.shape[1])
                out = jnp.zeros(shape, t.dtype)
            out = out.at[r0:r0 + W.shape[0]].add(t)
    return out


def spmv(A, x: jax.Array) -> jax.Array:
    """y = A @ x for any container / dense matrix."""
    from tpu_sparse.sparse.bell import BELL
    from tpu_sparse.sparse.cwell import CWELL, CWELLSeg

    if isinstance(A, CWELLSeg):
        # column segments: each covers only its touched row-block range
        return _cwellseg_apply(A, x, spmv)
    if isinstance(A, CWELL):
        return ref.cwell_spmv(A, x)
    if isinstance(A, BELL):
        return ref.bell_spmv(A, x)
    if isinstance(A, DIA):
        if _on_gpu() and dia_triton.supports(A, x):
            return dia_triton.dia_spmv(A, x)
        return ref.dia_spmv(A, x)
    if isinstance(A, CSR):
        return ref.csr_spmv(A, x)
    if isinstance(A, COO):
        return ref.coo_spmv(A, x)
    if isinstance(A, BSR):
        return ref.bsr_spmv(A, x)
    # dense
    return jnp.dot(A, x, precision=jax.lax.Precision.HIGHEST)


def spmm(A, B: jax.Array) -> jax.Array:
    """Y = A @ B with dense B (multi-RHS)."""
    from tpu_sparse.sparse.bell import BELL
    from tpu_sparse.sparse.cwell import CWELL, CWELLSeg

    if isinstance(A, CWELLSeg):
        return _cwellseg_apply(A, B, spmm, out_cols=True)
    if isinstance(A, CWELL):
        return ref.cwell_spmm(A, B)
    if isinstance(A, BELL):
        return ref.bell_spmm(A, B)
    if isinstance(A, DIA):
        return ref.dia_spmm(A, B)
    if isinstance(A, CSR):
        return ref.csr_spmm(A, B)
    if isinstance(A, COO):
        return ref.coo_spmm(A, B)
    if isinstance(A, BSR):
        return ref.bsr_spmm(A, B)
    return jnp.dot(A, B, precision=jax.lax.Precision.HIGHEST)


def batch_safe_matvec(A) -> Callable:
    """Matvec closure over A whose vmap rule is one SpMM.

    A batched matvec IS an SpMM: route it to the SpMM dispatch, which
    reads the matrix once for all k columns, instead of vmapping `spmv`
    (whose gathers and slices would batch column by column). Used by the
    batched multi-RHS solvers (solvers/batched.py).

    A's array leaves are passed to the custom_vmap primitive as explicit
    operands, not captured in the closure: closed-over leaves become
    constants of the stored vmap jaxpr, which fails with "No constant
    handler for DynamicJaxprTracer" whenever the whole solve is jitted
    with the matrix as an argument (the round-2 `block_cg_error`)."""
    from jax.custom_batching import custom_vmap

    leaves, treedef = jax.tree_util.tree_flatten(A)

    @custom_vmap
    def mv(x, *A_leaves):
        return spmv(jax.tree_util.tree_unflatten(treedef, A_leaves), x)

    @mv.def_vmap
    def _mv_vmap(axis_size, in_batched, x, *A_leaves):
        x_batched = in_batched[0]
        if any(in_batched[1:]):
            raise NotImplementedError(
                "batch_safe_matvec: matrix operands must not be batched")
        A_ = jax.tree_util.tree_unflatten(treedef, A_leaves)
        if not x_batched:
            return spmv(A_, x), False
        # custom_vmap delivers the batch at axis 0: x is (k, n)
        return spmm(A_, x.T).T, True

    return lambda x: mv(x, *leaves)


def as_matvec(A) -> Callable:
    """Normalize an operator (sparse container, dense matrix, or callable)
    into a matvec closure — the analogue of the reference's
    `_normalize_matvec` (torch_sparse_linalg.py:176-208)."""
    if callable(A) and not is_sparse(A):
        return A
    if is_sparse(A) or isinstance(A, (jax.Array,)) or hasattr(A, "ndim"):
        return lambda x: spmv(A, x)
    raise TypeError(f"unsupported operator type: {type(A)}")
