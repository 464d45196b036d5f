"""Aggregation algebraic multigrid (replacement for AMGX).

Capability parity target: the reference's Module B AMG configuration
(torch_amgx.py:47-99) — AGGREGATION coarsening with SIZE_4 selector,
JACOBI_L1 smoother with 0 pre- / 3 post-sweeps, ≤50 levels, deterministic
setup — not AMGX's full feature matrix (SURVEY.md §7 stage 6).

Split:

* **Setup phase on host** (numpy/scipy): strength-of-connection graph,
  greedy size-4 aggregation, tentative piecewise-constant prolongator,
  Galerkin RAP products. Graph algorithms have data-dependent shapes, which
  XLA cannot trace; the reference's own AMGX setup is likewise a host-driven
  native phase (torch_amgx.py:140). Deterministic by construction (fixed
  iteration order).
* **Solve phase fully on device**: the hierarchy is a pytree of sparse
  containers; one V-cycle is a pure jit-safe function (static level count),
  with L1-Jacobi smoothing and a dense coarse solve. Usable standalone
  (`amg_solve` = AMG-preconditioned CG, matching AMGX's accelerated "CG
  cycle" behavior) or as an `M=` preconditioner for any Krylov solver.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax.tree_util import Partial

from tpu_sparse.kernels import spmv
from tpu_sparse.sparse.containers import CSR, DIA, is_sparse
from tpu_sparse.sparse.convert import csr_from_arrays, to_scipy_csr


# --------------------------------------------------------------------------
# Host-side setup
# --------------------------------------------------------------------------


def _to_scipy_csr(A) -> sp.csr_matrix:
    # host-only conversion: no device round-trip (setup is a host phase)
    return to_scipy_csr(A)


def _l1_row_sums(A_sp: sp.csr_matrix) -> np.ndarray:
    """Row sums of |A| without materializing abs(A) (scipy's abs copies
    the whole matrix; at 56M nnz that was ~40% of AMG setup time)."""
    from tpu_sparse import native as _native

    if (A_sp.data.dtype == np.float64
            and A_sp.indptr.dtype == np.int32 and _native.available()):
        return _native.l1_row_norms(A_sp.indptr, A_sp.data)
    absdata = np.abs(A_sp.data)
    counts = np.diff(A_sp.indptr)
    if absdata.size == 0:
        return np.zeros(A_sp.shape[0], dtype=np.float64)
    starts = np.minimum(A_sp.indptr[:-1], absdata.size - 1)
    dl1 = np.add.reduceat(absdata, starts)
    dl1[counts == 0] = 0.0
    return dl1


def _strength_graph(A: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Symmetric strength of connection: keep a_ij with
    |a_ij| >= theta * sqrt(|a_ii a_jj|)."""
    d = np.abs(A.diagonal())
    d_safe = np.where(d > 0, d, 1.0)
    coo = A.tocoo()
    scale = np.sqrt(d_safe[coo.row] * d_safe[coo.col])
    keep = (np.abs(coo.data) >= theta * scale) & (coo.row != coo.col)
    S = sp.csr_matrix(
        (np.ones(keep.sum()), (coo.row[keep], coo.col[keep])), shape=A.shape)
    S = S.maximum(S.T)  # symmetrize
    return S


def _aggregate(S: sp.csr_matrix, target_size: int = 4) -> np.ndarray:
    """Greedy aggregation with target aggregate size (SIZE_4-like selector).

    Deterministic: nodes visited in index order. Returns agg id per node
    (-1 only transiently; every node ends up assigned)."""
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    indptr, indices = S.indptr, S.indices
    next_agg = 0
    # Phase 1: seed aggregates from fully-unaggregated neighborhoods.
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        free = nbrs[agg[nbrs] == -1]
        agg[i] = next_agg
        take = free[: target_size - 1]
        agg[take] = next_agg
        next_agg += 1
    # Phase 2: merge singleton aggregates into a neighbor aggregate where
    # possible (reduces coarse-grid size, mirrors aggregation cleanup).
    sizes = np.bincount(agg, minlength=next_agg)
    for i in range(n):
        if sizes[agg[i]] == 1:
            nbrs = indices[indptr[i]:indptr[i + 1]]
            if len(nbrs) > 0:
                tgt = agg[nbrs[0]]
                if sizes[tgt] < 2 * target_size and tgt != agg[i]:
                    sizes[agg[i]] -= 1
                    agg[i] = tgt
                    sizes[tgt] += 1
    # Compact ids
    uniq, agg = np.unique(agg, return_inverse=True)
    return agg


@jax.tree_util.register_pytree_node_class
class TentativeP:
    """Tentative (unsmoothed) aggregation prolongator — exactly one entry
    per row, so ``P x = vals · x[agg]`` is a pure gather with no
    segment-sum; the restriction side (R = Pᵀ) stays a CSR operator."""

    def __init__(self, vals: jax.Array, agg: jax.Array, shape):
        self.vals = vals          # (n,) entry values (1.0 for tentative)
        self.agg = agg            # (n,) int32 column (aggregate) per row
        self.shape = tuple(int(s) for s in shape)

    def apply(self, xc: jax.Array) -> jax.Array:
        return self.vals * xc[self.agg]

    def tree_flatten(self):
        return (self.vals, self.agg), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])


def _apply_P(P, v: jax.Array) -> jax.Array:
    if isinstance(P, TentativeP):
        return P.apply(v)
    return spmv(P, v)


class AMGLevel(NamedTuple):
    """One multigrid level (a pytree: all fields are containers/arrays)."""

    A: Any            # system matrix: the caller's container (finest) or CSR
    P: Any            # prolongator (TentativeP or a sparse container;
    #                   None on the coarsest level)
    R: Optional[CSR]  # restriction = Pᵀ (sparse container)
    dinv_l1: Optional[jax.Array]  # 1 / L1-Jacobi diagonal


class AMGHierarchy(NamedTuple):
    levels: Tuple[AMGLevel, ...]
    # Dense pseudo-inverse of the coarsest operator, precomputed on host.
    # The coarse solve is then one matmul per cycle, and pinv also handles
    # the singular coarse matrices arising from pure-Neumann problems.
    coarse_inv: jax.Array

    @property
    def num_levels(self) -> int:
        return len(self.levels) + 1


def _rho_dinv_a(A_sp: sp.csr_matrix, iters: int = 10) -> float:
    """Spectral-radius estimate of D⁻¹A by power iteration (host)."""
    d = A_sp.diagonal()
    dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 1.0)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(A_sp.shape[0])
    v /= np.linalg.norm(v)
    rho = 1.0
    for _ in range(iters):
        v = dinv * (A_sp @ v)
        nv = np.linalg.norm(v)
        if nv == 0:
            break
        rho, v = nv, v / nv
    return float(max(rho, 1e-12))


def _smooth_prolongator(A_sp: sp.csr_matrix,
                        P_tent: sp.csr_matrix) -> sp.csr_matrix:
    """Jacobi-smoothed aggregation: P = (I − ω D⁻¹A) P_tent with
    ω = 4/(3ρ(D⁻¹A)). Improves interpolation for tougher elliptic
    problems at the cost of a denser hierarchy (classic SA; the
    reference's AMGX config uses plain aggregation, torch_amgx.py:50-73 —
    this is an extension)."""
    d = A_sp.diagonal()
    dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 1.0)
    omega = 4.0 / (3.0 * _rho_dinv_a(A_sp))
    AP = (A_sp @ P_tent).tocsr()
    P = (P_tent - sp.diags(omega * dinv) @ AP).tocsr()
    P.sum_duplicates()
    return P


def _pack_level_op(S_sp: sp.csr_matrix, np_dt):
    """Host scipy CSR → device CSR for the solve phase."""
    return csr_from_arrays(S_sp.data.astype(np_dt, copy=False),
                           S_sp.indices, S_sp.indptr, S_sp.shape)


def _pack_tentative_p(P_sp: sp.csr_matrix, np_dt):
    """Tentative P (1 nnz/row) for the device: the x[agg] gather form."""
    return TentativeP(
        jnp.asarray(P_sp.data.astype(np_dt, copy=False)),
        jnp.asarray(P_sp.indices.astype(np.int32, copy=False)),
        P_sp.shape)


def amg_setup(A, *, theta: float = 0.08, target_size: int = 4,
              max_levels: int = 50, coarse_size: int = 16,
              use_native: Optional[bool] = None,
              smoothed: bool = False,
              aggressive: int = 0,
              _staged: bool = False) -> AMGHierarchy:
    """Build the AMG hierarchy on host. ``A`` must be concrete (not traced).

    The graph phase (strength + aggregation + Galerkin RAP) runs in the
    in-repo C++ kernels (tpu_sparse/native/amg_setup.cc) when the toolchain
    is available — the native-setup counterpart of AMGX's C++ setup phase —
    with a scipy fallback. Set use_native=False to force the fallback.
    ``smoothed=True`` selects Jacobi-smoothed aggregation (SA) prolongators
    (the Galerkin products then run through scipy: the native RAP kernel
    exploits piecewise-constant tentative P).
    """
    from tpu_sparse import native as _native

    if use_native is None:
        use_native = _native.available()
    # staging: build every device array on the CPU backend and move the
    # finished hierarchy in one batched transfer instead of one transfer
    # per leaf. Whether this still pays on the GPU is not measured
    # (ROADMAP.md). jax.devices() ignores the default_device context, so
    # the inner call must be told it is already staged rather than
    # re-checking the platform.
    dev = jax.devices()[0]
    if dev.platform != "cpu" and not _staged:
        from tpu_sparse.utils.transfer import batched_device_put

        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            hier = amg_setup(A, theta=theta, target_size=target_size,
                             max_levels=max_levels, coarse_size=coarse_size,
                             use_native=use_native, smoothed=smoothed,
                             aggressive=aggressive, _staged=True)
        # the finest-level operator is the caller's (already-placed)
        # container: device_put is a no-op for it and batches the rest
        return batched_device_put(hier, dev)
    A_sp = _to_scipy_csr(A)
    if A_sp.dtype != np.float64:
        A_sp = A_sp.astype(np.float64)
    levels: List[AMGLevel] = []
    A_dev_top = A  # keep the caller's container for the finest level

    current = A_sp
    current_dev = A_dev_top
    while (current.shape[0] > coarse_size
           and len(levels) < max_levels - 1):
        if use_native:
            agg, nc = _native.aggregate(current.indptr, current.indices,
                                        current.data, theta, target_size)
        else:
            S = _strength_graph(current, theta)
            agg = _aggregate(S, target_size)
            nc = int(agg.max()) + 1
        if nc >= current.shape[0]:  # no coarsening progress — stop
            break
        # aggressive (pairwise^2-style) coarsening: re-aggregate the
        # tentative coarse graph and compose, multiplying the coarsening
        # ratio per level (~4 -> ~16). Cuts the hierarchy depth roughly
        # in half, and with it the V-cycle's tail of small-level ops.
        for _ in range(aggressive):
            if nc <= coarse_size * 4:
                break
            ic1, jc1, vc1 = _native.rap_pc(
                current.indptr, current.indices, current.data, agg, nc)                 if use_native else (None, None, None)
            if ic1 is not None:
                A_c1 = sp.csr_matrix((vc1, jc1, ic1), shape=(nc, nc))
            else:
                P1 = sp.csr_matrix(
                    (np.ones(current.shape[0]), agg.astype(np.int32),
                     np.arange(current.shape[0] + 1, dtype=np.int64)),
                    shape=(current.shape[0], nc))
                A_c1 = (P1.T @ current @ P1).tocsr()
            if use_native:
                agg2, nc2 = _native.aggregate(
                    A_c1.indptr, A_c1.indices, A_c1.data, theta,
                    target_size)
            else:
                S2 = _strength_graph(A_c1, theta)
                agg2 = _aggregate(S2, target_size)
                nc2 = int(agg2.max()) + 1
            if nc2 >= nc:
                break
            agg = agg2[agg]
            nc = nc2
        n = current.shape[0]
        # tentative P has exactly one entry per row — build CSR directly
        P_sp = sp.csr_matrix(
            (np.ones(n), agg.astype(np.int32),
             np.arange(n + 1, dtype=np.int64)), shape=(n, nc))
        if smoothed:
            P_sp = _smooth_prolongator(current, P_sp)
        R_sp = P_sp.T.tocsr()
        if use_native and not smoothed:
            ic, jc, vc = _native.rap_pc(current.indptr, current.indices,
                                        current.data, agg, nc)
            A_next = sp.csr_matrix((vc, jc, ic), shape=(nc, nc))
        else:
            A_next = (R_sp @ current @ P_sp).tocsr()
            A_next.sum_duplicates()

        dtype = (A.dtype if hasattr(A, "dtype") else jnp.float64)
        np_dt = np.dtype(dtype)
        dl1 = _l1_row_sums(current)
        dinv = jnp.asarray(
            np.where(dl1 > 0, 1.0 / np.where(dl1 > 0, dl1, 1.0), 1.0),
            dtype=dtype)
        if smoothed:
            P_dev = _pack_level_op(P_sp, np_dt)
        else:
            P_dev = _pack_tentative_p(P_sp, np_dt)
        R_dev = _pack_level_op(R_sp, np_dt)
        levels.append(AMGLevel(A=current_dev, P=P_dev, R=R_dev,
                               dinv_l1=dinv))
        current = A_next
        current_dev = _pack_level_op(A_next, np_dt)

    dtype = (A.dtype if hasattr(A, "dtype") else jnp.float64)
    coarse_inv = jnp.asarray(
        np.linalg.pinv(current.toarray(), rcond=1e-12), dtype=dtype)
    return AMGHierarchy(levels=tuple(levels), coarse_inv=coarse_inv)


# --------------------------------------------------------------------------
# Device-side solve phase
# --------------------------------------------------------------------------


def _smooth(A, dinv, x, b, sweeps: int, omega: float):
    for _ in range(sweeps):
        r = b - spmv(A, x)
        x = x + omega * dinv * r
    return x


def _chebyshev_smooth(A, dinv, x, b, degree: int, lam_max: float,
                      lam_ratio: float = 8.0):
    """Chebyshev polynomial smoother on the D⁻¹A spectrum interval
    [lam_max/lam_ratio, lam_max].

    An alternative to stationary Jacobi: the optimal-polynomial
    recurrence needs **no inner products** (pure SpMV + axpy), smooths the
    upper spectrum much faster per SpMV, and its coefficients are static.
    AMGX offers the same trade (CHEBYSHEV smoother) beyond the reference's
    configured JACOBI_L1.
    """
    lo = lam_max / lam_ratio
    theta = 0.5 * (lam_max + lo)
    delta = 0.5 * (lam_max - lo)
    # standard three-term Chebyshev iteration on the preconditioned residual
    r = b - spmv(A, x)
    z = dinv * r
    alpha = 1.0 / theta
    d = alpha * z
    x = x + d
    rho_old = delta / theta  # sigma
    rho = rho_old
    for _ in range(degree - 1):
        r = b - spmv(A, x)
        z = dinv * r
        rho_new = 1.0 / (2.0 * theta / delta - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = x + d
        rho = rho_new
    return x


def v_cycle(hier: AMGHierarchy, b: jax.Array, *, pre_sweeps: int = 0,
            post_sweeps: int = 3, omega: float = 1.0,
            smoother: str = "l1_jacobi") -> jax.Array:
    """One V-cycle applied to rhs b (x0 = 0). Jit-safe; static level count.

    Default sweep counts mirror the reference's AMGX config
    (0 pre / 3 post L1-Jacobi sweeps, torch_amgx.py:50-73).
    smoother: 'l1_jacobi' (reference parity) or 'chebyshev' (reduction-free
    polynomial smoother; 'sweeps' becomes the polynomial degree).
    """

    def smooth(lvl, x, rhs, sweeps):
        if sweeps <= 0:
            return x
        if smoother == "chebyshev":
            # l1-scaled SPD operators have spec(D_l1^-1 A) ⊆ (0, 1]
            return _chebyshev_smooth(lvl.A, lvl.dinv_l1, x, rhs,
                                     degree=sweeps, lam_max=1.0)
        return _smooth(lvl.A, lvl.dinv_l1, x, rhs, sweeps, omega)

    def descend(level_idx: int, rhs: jax.Array) -> jax.Array:
        if level_idx == len(hier.levels):
            return jnp.dot(
                hier.coarse_inv, rhs.astype(hier.coarse_inv.dtype),
                precision=jax.lax.Precision.HIGHEST,
            ).astype(rhs.dtype)
        lvl = hier.levels[level_idx]
        x = jnp.zeros_like(rhs)
        x = smooth(lvl, x, rhs, pre_sweeps)
        r = rhs - spmv(lvl.A, x) if pre_sweeps > 0 else rhs
        rc = spmv(lvl.R, r)
        xc = descend(level_idx + 1, rc)
        x = x + _apply_P(lvl.P, xc)
        x = smooth(lvl, x, rhs, post_sweeps)
        return x

    return descend(0, b)


import functools


@functools.lru_cache(maxsize=64)
def _make_vcycle_apply(pre: int, post: int, omega: float,
                       smoother: str = "l1_jacobi"):
    # Sweep counts are Python loop bounds and must stay static; bind them in
    # a plain closure and keep only the hierarchy as a pytree Partial arg.
    # lru_cache keeps the function object stable across calls so jitted
    # consumers get cache hits instead of recompiling per solve.
    def apply(hier: AMGHierarchy, v):
        return v_cycle(hier, v, pre_sweeps=pre, post_sweeps=post,
                       omega=omega, smoother=smoother)

    return apply


def amg_preconditioner(A, *, theta: float = 0.08, target_size: int = 4,
                       max_levels: int = 50, coarse_size: int = 16,
                       pre_sweeps: int = 1, post_sweeps: int = 1,
                       omega: float = 0.9,
                       smoother: str = "l1_jacobi",
                       smoothed: bool = False,
                       aggressive: int = 0) -> Partial:
    """Build M ≈ A⁻¹ as one AMG V-cycle (usable as ``M=`` in any solver).

    Setup runs on host; the returned Partial is a pytree whose leaves are
    the device-resident hierarchy, so it rides through jit and custom_vjp.

    Default V(1,1) with weighted Jacobi is a *symmetric* operator, which
    PCG requires; the reference's AMGX 0-pre/3-post configuration
    (torch_amgx.py:50-73) is nonsymmetric (fine for AMGX's own accelerated
    cycles) and remains available via pre_sweeps=0, post_sweeps=3.
    """
    hier = amg_setup(A, theta=theta, target_size=target_size,
                     max_levels=max_levels, coarse_size=coarse_size,
                     smoothed=smoothed,
                     aggressive=aggressive)
    return Partial(
        _make_vcycle_apply(pre_sweeps, post_sweeps, omega, smoother), hier)


def amg_stationary_solve(A, b, x0=None, *, tol: float = 1e-6,
                         atol: float = 0.0, maxiter: int = 100,
                         theta: float = 0.08, target_size: int = 4,
                         max_levels: int = 50, coarse_size: int = 16,
                         pre_sweeps: int = 0, post_sweeps: int = 3,
                         omega: float = 1.0,
                         precond: Optional[Partial] = None,
                         smoothed: bool = False):
    """Stationary AMG iteration: x ← x + V(b − Ax) with its own
    convergence loop (AMGX's ``amgx_amg`` analogue — the reference runs
    AMG as a solver with AMGX's own tol/maxiter control,
    torch_amgx.py:50-99,481-483 — not only as a CG preconditioner).

    Default sweeps mirror the reference AMGX config (0 pre / 3 post
    L1-Jacobi); unlike PCG acceleration, the cycle need not be symmetric.
    Convergence contract matches the Krylov solvers:
    ``‖r‖ ≤ max(tol·‖b‖, atol)``; returns (x, info, iterations, ‖r‖)
    with info 0 = converged, -1 = maxiter hit.
    """
    M = precond if precond is not None else amg_preconditioner(
        A, theta=theta, target_size=target_size, max_levels=max_levels,
        coarse_size=coarse_size, pre_sweeps=pre_sweeps,
        post_sweeps=post_sweeps, omega=omega, smoothed=smoothed)
    matvec = A if callable(A) else (lambda v: spmv(A, v))
    b_norm = jnp.linalg.norm(b)
    thresh = jnp.maximum(tol * b_norm, atol).astype(b.dtype)
    x0 = jnp.zeros_like(b) if x0 is None else x0

    def cond(state):
        _, r_norm, k = state
        return (r_norm > thresh) & (k < maxiter) & jnp.isfinite(r_norm)

    def body(state):
        x, _, k = state
        x = x + M(b - matvec(x))
        return x, jnp.linalg.norm(b - matvec(x)), k + 1

    r0 = b - matvec(x0)
    x, r_norm, iters = jax.lax.while_loop(
        cond, body, (x0, jnp.linalg.norm(r0), jnp.array(0, jnp.int32)))
    ok = jnp.isfinite(r_norm) & (r_norm <= thresh)
    info = jnp.where(ok, 0, -1).astype(jnp.int32)
    return x, info, iters, r_norm


def amg_solve(A, b, x0=None, *, tol: float = 1e-6, atol: float = 0.0,
              maxiter: int = 100, theta: float = 0.08,
              target_size: int = 4, max_levels: int = 50,
              coarse_size: int = 16, pre_sweeps: int = 1,
              post_sweeps: int = 1, omega: float = 0.9,
              precond: Optional[Partial] = None,
              smoothed: bool = False):
    """AMG-preconditioned CG solve (AMGX 'AMG with CG acceleration'
    analogue). Returns (x, info, iterations, residual_norm)."""
    from tpu_sparse.autodiff import cg_diff

    M = precond if precond is not None else amg_preconditioner(
        A, theta=theta, target_size=target_size, max_levels=max_levels,
        coarse_size=coarse_size, pre_sweeps=pre_sweeps,
        post_sweeps=post_sweeps, omega=omega, smoothed=smoothed)
    return cg_diff(A, b, x0, tol=tol, atol=atol, maxiter=maxiter, M=M)
