"""DIA SpMV as a Pallas kernel through Triton: the GPU path of
`kernels.spmv` for DIA operands.

One program per tile of ``TILE`` consecutive rows: a static loop over the
stored diagonals, each a masked load of ``data[d, rows]`` and of
``x[rows + offset]``, accumulated in registers, one masked store of ``y``.
Every byte of the matrix is read once and x mostly from L2. In f32 it
beats the XLA formulation end to end in CG on the H100 (14 %, every round
of PERF.md's comparison); in f64 the two tie, so f64 keeps the XLA path.

Differentiation: the kernel has no autodiff rule of its own, so it is
wrapped in a `custom_jvp` whose tangent is the XLA formulation
(`reference.dia_spmv`) — linear in both operands, hence transposable for
reverse mode (the implicit-diff adjoint's Ā on the pattern).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpu_sparse.kernels import reference as ref
from tpu_sparse.sparse.containers import DIA

TILE = 1024       # rows per program (tile 2048 / 8 warps measured slower)
NUM_WARPS = 4


def supports(A: DIA, x) -> bool:
    """f32 DIA with a 1-D f32 x, whose flattened data index fits int32 —
    the case where the kernel wins end to end (module docstring). The
    kernel itself is dtype-generic."""
    return (getattr(x, "ndim", 0) == 1 and x.dtype == jnp.float32
            and A.data.dtype == jnp.float32 and bool(A.offsets)
            and A.data.size < 2**31 and A.shape[1] < 2**31)


def _kernel(data_ref, x_ref, y_ref, *, offsets, n, m, tile):
    rows = pl.program_id(0) * tile + jnp.arange(tile)
    valid = rows < n
    safe_rows = jnp.minimum(rows, n - 1)
    acc = jnp.zeros((tile,), y_ref.dtype)
    for d, o in enumerate(offsets):
        cols = rows + o
        in_band = valid & (cols >= 0) & (cols < m)
        a = plgpu.load(data_ref.at[d * n + safe_rows], mask=valid, other=0.0)
        xv = plgpu.load(x_ref.at[jnp.clip(cols, 0, m - 1)], mask=in_band,
                        other=0.0)
        acc = acc + a * xv
    plgpu.store(y_ref.at[rows], acc, mask=valid)


@functools.partial(jax.custom_jvp, nondiff_argnums=(2, 3, 4))
def _spmv(data, x, offsets, shape, interpret):
    n, m = shape
    kernel = functools.partial(_kernel, offsets=offsets, n=n, m=m, tile=TILE)
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((n,), x.dtype),
        grid=(pl.cdiv(n, TILE),), backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret, name="dia_spmv_triton")(data.reshape(-1), x)


@_spmv.defjvp
def _spmv_jvp(offsets, shape, interpret, primals, tangents):
    data, x = primals
    data_dot, x_dot = tangents
    y = _spmv(data, x, offsets, shape, interpret)
    y_dot = (ref.dia_spmv(DIA(data_dot, offsets, shape), x)
             + ref.dia_spmv(DIA(data, offsets, shape), x_dot))
    return y, y_dot


def dia_spmv(A: DIA, x: jax.Array, *, interpret: bool = False) -> jax.Array:
    """y = A @ x through the Triton kernel (A.data and x of one real
    dtype). ``interpret=True`` runs it in the Pallas interpreter (CPU
    tests)."""
    return _spmv(A.data, x, tuple(A.offsets), tuple(A.shape), interpret)
