"""Distributed Krylov solves over a row-partitioned mesh.

Two modes (BASELINE.json north star; SURVEY.md §7 stage 7):

* ``gspmd``: shard the operands with NamedSharding and run the ordinary
  Krylov solvers under jit — XLA's SPMD partitioner inserts the
  collective-permutes for the stencil shifts and all-reduces for the dot
  products automatically (the scaling-book recipe: pick a mesh, annotate
  shardings, let XLA insert collectives).
* ``halo``: the SpMV is an explicit shard_map halo-exchange kernel
  (dist/spmv.py); dot products still auto-psum at the jit level. Gives
  deterministic, inspectable communication — the bit-comparable-convergence
  path.

Both reuse the exact single-device solver code: the solver is generic over
the operator, so distribution is purely an operand/operator concern.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tpu_sparse.dist.mesh import make_row_mesh, replicated, row_sharding
from tpu_sparse.dist.partition import pad_vector, shard_dia, shard_vector
from tpu_sparse.dist.spmv import make_halo_spmv
from tpu_sparse.solvers.krylov import bicgstab_full, cg_full
from tpu_sparse.sparse.containers import DIA


def _vector_unit(A) -> int:
    """Vector pad granularity: CWELL row blocks are 128 rows tall, so
    general-structure systems pad to mesh_size*128; DIA pads to mesh_size."""
    if isinstance(A, DIA):
        return 1
    from tpu_sparse.sparse.cwell import LW

    return LW


def _check_precond_divisible(n: int, mesh: Mesh, M, unit: int = 1) -> None:
    if M is not None and n % (mesh.devices.size * unit) != 0:
        raise ValueError(
            f"preconditioned distributed solves need n ({n}) divisible by "
            f"mesh size x pad unit ({mesh.devices.size}x{unit}): the "
            f"identity padding would not match the preconditioner's "
            f"dimension")


from tpu_sparse.utils.opcache import OperandCache

_resolve_cache = OperandCache(max_entries=4)


def _shard_and_resolve(A, mesh: Mesh, mode: str):
    """Shard A over the mesh and resolve the effective SpMV mode.

    DIA (stencil/banded) operators support all three modes; mode='halo'
    automatically degrades to 'allgather' when the stencil bandwidth
    exceeds the shard size (single-hop neighbor halos cannot supply all
    remote columns there). General-structure operators (CSR/COO/BSR/
    CWELL/...) row-shard as CWELL blocks with a halo plan computed from
    the PRE-SHARD host pack (multi-process capable — every controller
    derives it identically; see partition.shard_general_planned),
    falling back to the all_gather SpMV when the partition has no column
    locality. The shard+pack+plan is cached per (matrix content, mesh,
    mode) — repeated solves on the same operand pay zero host repacking."""
    if not isinstance(A, DIA):
        from tpu_sparse.dist.partition import shard_general_planned

        def _build():
            W_sh, plan = shard_general_planned(A, mesh)
            if mode != "allgather" and plan is not None:
                return plan, "cwell_halo"
            return W_sh, "cwell_allgather"

        return _resolve_cache.get_or_build(A, _build, extra=(mesh, mode))
    A_sh = shard_dia(A, mesh)
    if mode == "halo" and A_sh.bandwidth > A_sh.shape[0] // mesh.devices.size:
        mode = "allgather"
    if mode not in ("halo", "allgather", "gspmd"):
        raise ValueError(f"unknown mode: {mode}")
    return A_sh, mode


def _matvec_builder(A_sh, mesh: Mesh, mode: str) -> Callable:
    """x ↦ A_sh @ x for an already-sharded operator and resolved mode.

    Multi-host rule: call this INSIDE jit with A_sh passed as a jit
    argument — a jitted function may not close over arrays whose shards
    live on other processes' devices (they become lowering-time
    constants). Eager/single-process callers may also use it directly."""
    if mode == "cwell_halo":
        from tpu_sparse.dist.spmv import make_cwell_halo_spmv

        return make_cwell_halo_spmv(A_sh, mesh)
    if mode == "cwell_allgather":
        from tpu_sparse.dist.spmv import make_cwell_allgather_spmv

        return make_cwell_allgather_spmv(A_sh, mesh)
    if mode == "halo":
        return make_halo_spmv(A_sh, mesh)
    if mode == "allgather":
        from tpu_sparse.dist.spmv import make_allgather_spmv

        return make_allgather_spmv(A_sh, mesh)
    from tpu_sparse.kernels import reference as kref

    return lambda x: kref.dia_spmv(A_sh, x)


def _as_pytree_m(M):
    """Make M jit-argument-passable: Partial is a registered pytree, so a
    sharded-hierarchy preconditioner (dist/amg.py) rides through jit as an
    ARGUMENT — required on multi-host, where its leaves span processes.
    Plain callables wrap losslessly (their closures stay constants)."""
    from jax.tree_util import Partial

    if M is None or isinstance(M, Partial):
        return M
    return Partial(M)


def distributed_matvec_op(A, mesh: Mesh, mode: str = "gspmd"):
    """Shard A and return (A_sharded, matvec) for the chosen mode (see
    _shard_and_resolve for mode semantics). The returned matvec closes
    over the sharded operator — fine single-process; multi-host jit
    callers should pass A_sharded as an argument and rebuild via
    _matvec_builder instead (as the distributed_* solvers here do)."""
    A_sh, mode = _shard_and_resolve(A, mesh, mode)
    return A_sh, _matvec_builder(A_sh, mesh, mode)


def distributed_cg(A, b: jax.Array, x0: Optional[jax.Array] = None, *,
                   mesh: Optional[Mesh] = None, mode: str = "gspmd",
                   tol: float = 1e-6, atol: float = 0.0,
                   maxiter: Optional[int] = None,
                   M: Optional[Callable] = None,
                   pipeline: bool = False):
    """CG on a row-partitioned banded system.

    Returns (x, info, iters, res) with x sharded over the mesh. The result
    is unpadded to b's original length on return.

    pipeline=True runs the single-reduction Chronopoulos-Gear recurrence
    (solvers/pipelined.py): one fused all-reduce round per iteration
    instead of two dependent ones — the right trade when reduction
    latency (multi-host DCN) bounds scaling, at 1-2 extra axpys per
    iteration.
    """
    if mesh is None:
        mesh = make_row_mesh()
    n_orig = b.shape[0]
    unit = _vector_unit(A)
    _check_precond_divisible(n_orig, mesh, M, unit)
    A_sh, rmode = _shard_and_resolve(A, mesh, mode)
    b_sh = shard_vector(b, mesh, unit)
    x0_sh = shard_vector(x0, mesh, unit) if x0 is not None else None
    solver = cg_full
    if pipeline:
        from tpu_sparse.solvers.pipelined import cg_sr_full

        solver = cg_sr_full

    # A_sh rides as a jit ARGUMENT: multi-host shards are not closable
    @partial(jax.jit, static_argnums=())
    def _run(aa, bb, xx0, mm):
        return solver(_matvec_builder(aa, mesh, rmode), bb, xx0, tol=tol,
                      atol=atol, maxiter=maxiter, M=mm)

    x, info, iters, res = _run(A_sh, b_sh, x0_sh, _as_pytree_m(M))
    return x[:n_orig], info, iters, res


def distributed_bicgstab(A, b: jax.Array,
                         x0: Optional[jax.Array] = None, *,
                         mesh: Optional[Mesh] = None, mode: str = "gspmd",
                         tol: float = 1e-6, atol: float = 0.0,
                         maxiter: Optional[int] = None,
                         M: Optional[Callable] = None):
    if mesh is None:
        mesh = make_row_mesh()
    n_orig = b.shape[0]
    unit = _vector_unit(A)
    _check_precond_divisible(n_orig, mesh, M, unit)
    A_sh, rmode = _shard_and_resolve(A, mesh, mode)
    b_sh = shard_vector(b, mesh, unit)
    x0_sh = shard_vector(x0, mesh, unit) if x0 is not None else None

    @jax.jit
    def _run(aa, bb, xx0, mm):
        return bicgstab_full(_matvec_builder(aa, mesh, rmode), bb, xx0,
                             tol=tol, atol=atol, maxiter=maxiter, M=mm)

    x, info, iters, res = _run(A_sh, b_sh, x0_sh, _as_pytree_m(M))
    return x[:n_orig], info, iters, res


def distributed_gmres(A, b: jax.Array, x0: Optional[jax.Array] = None,
                      *, mesh: Optional[Mesh] = None, mode: str = "gspmd",
                      tol: float = 1e-6, atol: float = 0.0,
                      restart: int = 20, maxiter: Optional[int] = None,
                      M: Optional[Callable] = None,
                      solve_method: str = "batched"):
    """Distributed GMRES: the Krylov basis V is row-sharded like x (its
    trailing basis axis stays replicated); Arnoldi projections all-reduce
    at the jit level."""
    from tpu_sparse.solvers.krylov import gmres_full

    if mesh is None:
        mesh = make_row_mesh()
    n_orig = b.shape[0]
    unit = _vector_unit(A)
    _check_precond_divisible(n_orig, mesh, M, unit)
    A_sh, rmode = _shard_and_resolve(A, mesh, mode)
    b_sh = shard_vector(b, mesh, unit)
    x0_sh = shard_vector(x0, mesh, unit) if x0 is not None else None

    @jax.jit
    def _run(aa, bb, xx0, mm):
        return gmres_full(_matvec_builder(aa, mesh, rmode), bb, xx0,
                          tol=tol, atol=atol, restart=restart,
                          maxiter=maxiter, M=mm, solve_method=solve_method)

    x, info, iters, res = _run(A_sh, b_sh, x0_sh, _as_pytree_m(M))
    return x[:n_orig], info, iters, res


def distributed_block_cg(A, B: jax.Array, X0: Optional[jax.Array] = None,
                         *, mesh: Optional[Mesh] = None,
                         mode: str = "gspmd", tol: float = 1e-6,
                         atol: float = 0.0, maxiter: Optional[int] = None,
                         M: Optional[Callable] = None):
    """Block CG with the (n, k) RHS block row-sharded over the mesh.

    The k columns stay replicated; every iteration's single block matvec
    feeds all k RHS (vmapped halo/gspmd SpMV) and the kxk Gram matmuls
    all-reduce at the jit level. Identity-padded rows carry zero RHS, so
    per-column norms and convergence are unchanged by the padding.
    """
    from tpu_sparse.solvers.block import block_cg

    if mesh is None:
        mesh = make_row_mesh()
    n_orig = B.shape[0]
    unit = _vector_unit(A)
    _check_precond_divisible(n_orig, mesh, M, unit)
    A_sh, rmode = _shard_and_resolve(A, mesh, mode)
    n_dev = mesh.devices.size

    def shard_rows(V):
        n_pad = ((V.shape[0] + n_dev * unit - 1)
                 // (n_dev * unit)) * (n_dev * unit)
        V = jnp.pad(V, ((0, n_pad - V.shape[0]), (0, 0)))
        return jax.device_put(V, row_sharding(mesh, ndim=2))

    B_sh = shard_rows(B)
    X0_sh = shard_rows(X0) if X0 is not None else None

    @jax.jit
    def _run(aa, BB, XX0, mm):
        return block_cg(_matvec_builder(aa, mesh, rmode), BB, XX0,
                        tol=tol, atol=atol, maxiter=maxiter, M=mm)

    X, infos, iters, res = _run(A_sh, B_sh, X0_sh, _as_pytree_m(M))
    return X[:n_orig], infos, iters, res


def distributed_minres(A, b: jax.Array, x0: Optional[jax.Array] = None,
                       *, mesh: Optional[Mesh] = None, mode: str = "gspmd",
                       tol: float = 1e-6, atol: float = 0.0,
                       maxiter: Optional[int] = None,
                       M: Optional[Callable] = None):
    """MINRES on a row-partitioned symmetric (possibly indefinite)
    system; Lanczos vectors row-shard like x, dots all-reduce at the jit
    level."""
    from tpu_sparse.solvers.minres import minres_full

    if mesh is None:
        mesh = make_row_mesh()
    n_orig = b.shape[0]
    unit = _vector_unit(A)
    _check_precond_divisible(n_orig, mesh, M, unit)
    A_sh, rmode = _shard_and_resolve(A, mesh, mode)
    b_sh = shard_vector(b, mesh, unit)
    x0_sh = shard_vector(x0, mesh, unit) if x0 is not None else None

    @jax.jit
    def _run(aa, bb, xx0, mm):
        return minres_full(_matvec_builder(aa, mesh, rmode), bb, xx0,
                           tol=tol, atol=atol, maxiter=maxiter, M=mm)

    x, info, iters, res = _run(A_sh, b_sh, x0_sh, _as_pytree_m(M))
    return x[:n_orig], info, iters, res
