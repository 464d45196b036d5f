"""Direct sparse solvers with adjoint autograd (cuDSS replacement).

Dispatch (static on container type/structure, hence jit-safe):
  * DIA bandwidth ≤ 1  → Thomas algorithm
  * DIA banded         → banded LU (lax.scan)
  * anything else      → dense XLA LU

The unified router converts structured CSR inputs to DIA on host first
(api/solver.py), mirroring the reference's input auto-conversion
(cudss_solver.py:176-252). Differentiation uses the same one-adjoint-solve
contract as the iterative solvers (cudss_solver.py:78-173):
backward solves Aᵀ v = x̄, b̄ = v, Ā = -v xᵀ on the pattern.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from tpu_sparse.direct.banded import (
    banded_lu_factor,
    banded_lu_solve,
    block_pcr_solve,
    dense_solve,
    pcr_solve,
    thomas_solve,
)
from tpu_sparse.sparse.containers import DIA, is_sparse
from tpu_sparse.utils.tree import tree_norm, tree_sub


# From this size on, the log-depth cyclic-reduction solves replace the
# sequential scans: a scan runs one dependent step per row, each a device
# loop iteration (about 20-28 µs on the GPU), while cyclic reduction runs
# ceil(log2 n) vectorized passes. On the GPU the reductions are faster at
# every size measured from 16 rows on; at 8 rows the banded case ties
# (PERF.md).
CR_MIN_N = 16


def banded_solve(A: DIA, b: jax.Array) -> jax.Array:
    """Banded direct solve: below ``CR_MIN_N`` rows the Thomas scan
    (tridiagonal) or banded LU scan (wider bands); from there on parallel
    cyclic reduction or block cyclic reduction, plus one refinement step.
    """
    if A.shape[0] < CR_MIN_N:
        if A.bandwidth <= 1:
            return thomas_solve(A, b)
        return banded_lu_solve(A, b)
    reduce = pcr_solve if A.bandwidth <= 1 else block_pcr_solve
    # Cyclic reduction's residual grows with the pass count on
    # ill-conditioned bands (1-D Laplacian at n = 2^20: 9e-9 relative);
    # one refinement step brings it back to round-off (1e-16).
    x = reduce(A, b)
    return x + reduce(A, b - _matvec(A, x))


# Above this size, densifying a general sparse matrix is wasteful; the
# solve is delegated to a host supernodal LU instead (SURVEY.md §7 stage 8:
# "document general sparse LU as host-assisted").
_DENSE_DIRECT_LIMIT = 4096


def _splu_host(data, indices, indptr, shape, bb):
    """Host-side SuperLU body of the callback. Solves in f64 (or c128 for
    complex rhs) and casts back."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    bb = np.asarray(bb)
    work = (np.complex128 if np.iscomplexobj(bb)
            or np.iscomplexobj(np.asarray(data)) else np.float64)
    M = sp.csr_matrix((np.asarray(data, dtype=work), np.asarray(indices),
                       np.asarray(indptr)), shape=shape)
    out = spl.splu(M.tocsc()).solve(bb.astype(work))
    return out.astype(bb.dtype)


def needs_host_splu(A) -> bool:
    """True when ``direct_solve`` would route A to the host SuperLU path
    (general sparse beyond the densify limit)."""
    if not is_sparse(A):
        return False
    if isinstance(A, DIA) and A.bandwidth <= max(1, A.shape[0] // 4):
        return False
    return A.shape[0] > _DENSE_DIRECT_LIMIT


def direct_residual_info(A, b, x):
    """Dtype-aware (info, res, rel) for a direct solve's result."""
    res = tree_norm(tree_sub(b, _matvec(A, x)))
    b_norm = tree_norm(b)
    dt = jax.tree_util.tree_leaves(b)[0].dtype
    rel_tol = 1e-8 if jnp.finfo(dt).bits >= 64 else 1e-4
    ok = jnp.isfinite(res) & (res <= jnp.maximum(rel_tol * b_norm,
                                                 jnp.finfo(dt).tiny))
    info = jnp.where(ok, 0, -1).astype(jnp.int32)
    rel = res / jnp.where(b_norm > 0, b_norm, 1.0)
    return info, res, rel


def host_splu_solve(A, b: jax.Array) -> jax.Array:
    """General sparse LU on host (scipy SuperLU) via jax.pure_callback.

    The factorization is a data-dependent graph algorithm; running it
    host-side keeps the jit program intact (the callback is a node in the
    compiled graph) at the cost of one device↔host round trip per solve.
    Differentiable through the standard adjoint wrapper (the backward pass
    issues a second host solve on Aᵀ).
    """
    from tpu_sparse.sparse.containers import COO, CSR

    if isinstance(A, COO):
        A = A.tocsr()
    if not isinstance(A, CSR):
        raise TypeError("host_splu_solve expects a CSR/COO matrix")
    shape = A.shape

    def cb(data, indices, indptr, bb):
        return _splu_host(data, indices, indptr, shape, bb)

    return jax.pure_callback(
        cb, jax.ShapeDtypeStruct(b.shape, b.dtype),
        A.data, A.indices, A.indptr, b, vmap_method="sequential")


def direct_solve(A, b: jax.Array) -> jax.Array:
    """Direct solve without autograd wiring."""
    if isinstance(A, DIA) and A.bandwidth <= max(1, A.shape[0] // 4):
        return banded_solve(A, b)
    if needs_host_splu(A):
        from tpu_sparse.sparse.containers import COO, CSR

        if not isinstance(A, (CSR, COO)):
            A = A.tocoo()
        return host_splu_solve(A, b)
    if is_sparse(A) or hasattr(A, "ndim"):
        return dense_solve(A, b)
    raise TypeError(
        "direct solver requires a matrix operand (sparse container or "
        "dense array), not a matrix-free callable")


def _direct_full(A, b, x0=None, M=None, *, tol: float = 0.0,
                 atol: float = 0.0, **_ignored):
    """Solver-registry adapter: (x, info, iters, res) signature shared with
    the Krylov solvers so the implicit-diff wrapper can reuse it."""
    del x0, M
    x = direct_solve(A, b)
    # Dtype-aware accuracy bar: ~1e-8 relative in f64 (reference
    # test_module_c.py:141 asserts <1e-10 absolute on small systems), and
    # a correspondingly achievable bar in f32.
    info, res, _ = direct_residual_info(A, b, x)
    return x, info, jnp.array(0, jnp.int32), res


def _matvec(A, x):
    from tpu_sparse.kernels import spmv

    return spmv(A, x)


# Register with the implicit-diff machinery so direct solves get the same
# adjoint autograd as the Krylov methods.
from tpu_sparse.autodiff import implicit as _implicit  # noqa: E402

_implicit._SOLVERS["direct"] = _direct_full
_implicit._SYMMETRIC["direct"] = False


def direct_solve_diff(A, b, **kwargs):
    """Differentiable direct solve; returns x only (info via router)."""
    out = _implicit._dispatch("direct", A, b, None, None, opts=())
    return out[0]


def direct_solve_full_diff(A, b):
    """Differentiable direct solve returning (x, info, iters, res)."""
    return _implicit._dispatch("direct", A, b, None, None, opts=())


from tpu_sparse.direct.sparse_lu import (  # noqa: E402
    SparseLU,
    sparse_lu_solve,
    sparse_lu_solve_diff,
)

__all__ = [
    "banded_solve", "direct_solve", "direct_solve_diff",
    "direct_solve_full_diff", "thomas_solve", "banded_lu_solve",
    "banded_lu_factor", "dense_solve", "host_splu_solve",
    "needs_host_splu", "direct_residual_info",
    "pcr_solve", "block_pcr_solve",
    "SparseLU", "sparse_lu_solve", "sparse_lu_solve_diff",
]
