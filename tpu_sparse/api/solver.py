"""Unified solver router: `SparseSolver`, `solve`, `SolverResult`.

Parity target: the reference's unified interface (solver.py:56-576):
`SparseSolver` with auto backend selection, per-method dispatch, residual
recomputation, and `SolverResult{x, converged, iterations, residual,
backend, method}`, plus module-level convenience functions
`solve/cg/bicgstab/gmres/amg/direct_solve` (:524-576).

Differences: backends are mathematical roles, not external
libraries — 'krylov' (Module A analogue), 'amg' (Module B analogue),
'direct' (Module C analogue) — and the router also accepts the reference's
backend names ('module_a'/'module_b'/'module_c') as aliases.
"""

from __future__ import annotations

import functools
import warnings
from contextlib import contextmanager
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sparse.api import availability
from tpu_sparse.kernels import as_matvec
from tpu_sparse.sparse.containers import is_sparse
from tpu_sparse.utils.tree import tree_norm, tree_sub


class SolverMethod(Enum):
    CG = "cg"
    CG_SR = "cg_sr"
    FCG = "fcg"
    MINRES = "minres"
    BICGSTAB = "bicgstab"
    GMRES = "gmres"
    FGMRES = "fgmres"
    AMG = "amg"
    DIRECT = "direct"


class SolverBackend(Enum):
    KRYLOV = "krylov"
    AMG = "amg"
    DIRECT = "direct"
    AUTO = "auto"


_BACKEND_ALIASES = {
    # reference names (solver.py:64-70) map onto their analogues here
    "module_a": "krylov",
    "module_b": "amg",
    "module_c": "direct",
    "auto": "auto",
    "krylov": "krylov",
    "amg": "amg",
    "direct": "direct",
}


class SolverResult:
    """Mirror of reference SolverResult (solver.py:73-82).

    The scalar fields (``converged``/``iterations``/``residual``) accept
    device scalars and materialize LAZILY in one batched transfer on
    first access: constructing a result costs no device→host round trip,
    so a solve is one dispatch and the host does not wait for the device
    until a field is read. Access from Python (``result.converged`` etc.)
    behaves exactly as eager fields would."""

    __slots__ = ("x", "backend", "method", "_converged", "_iterations",
                 "_residual", "_fetched")

    def __init__(self, x, converged, iterations, residual, backend,
                 method):
        self.x = x
        self.backend = backend
        self.method = method
        self._converged = converged
        self._iterations = iterations
        self._residual = residual
        self._fetched = not any(
            isinstance(v, jax.Array)
            for v in (converged, iterations, residual))

    def _materialize(self):
        if not self._fetched:
            c, i, r = jax.device_get(
                (self._converged,
                 0 if self._iterations is None else self._iterations,
                 jnp.nan if self._residual is None else self._residual))
            self._converged = bool(np.asarray(c))
            if self._iterations is not None:
                self._iterations = int(i)
            if self._residual is not None:
                self._residual = float(r)
            self._fetched = True

    @property
    def converged(self) -> bool:
        self._materialize()
        return self._converged

    @property
    def iterations(self) -> Optional[int]:
        self._materialize()
        return self._iterations

    @property
    def residual(self) -> Optional[float]:
        self._materialize()
        return self._residual

    def replace_x(self, x) -> "SolverResult":
        out = SolverResult(x, self._converged, self._iterations,
                           self._residual, self.backend, self.method)
        out._fetched = self._fetched
        return out

    def __repr__(self):
        self._materialize()
        return (f"SolverResult(converged={self._converged}, "
                f"iterations={self._iterations}, "
                f"residual={self._residual}, backend={self.backend!r}, "
                f"method={self.method!r})")


class SparseSolver:
    """Unified sparse linear-system solver (reference solver.py:84-508).

    Example:
        >>> solver = SparseSolver()
        >>> x, result = solver.solve(A, b, method='cg')
    """

    def __init__(self, default_backend: str = "auto",
                 default_method: str = "cg", verbose: bool = False):
        self.verbose = verbose
        self.default_backend = default_backend
        self.default_method = default_method
        self._available: Optional[List[str]] = None

    @property
    def available_backends(self) -> List[str]:
        if self._available is None:
            self._available = availability.get_available_backends()
        return self._available

    # -- selection ----------------------------------------------------------

    def _select_backend(self, backend: str, method: str) -> Tuple[str, str]:
        """Auto-selection rules mirroring reference solver.py:194-254:
        direct→direct backend, amg→amg backend, otherwise krylov."""
        backend = _BACKEND_ALIASES.get(backend, backend)
        available = self.available_backends
        if not available:
            raise RuntimeError("No sparse solver backends are available!")

        if backend != "auto":
            if backend not in available:
                raise ValueError(
                    f"Backend '{backend}' is not available. "
                    f"Available backends: {available}"
                )
            return backend, method

        if method == "direct":
            if "direct" in available:
                return "direct", "direct"
            raise ValueError(
                "Direct solver backend is not available; use an iterative "
                "method (cg, bicgstab, gmres) instead."
            )
        if method == "amg":
            if "amg" in available:
                return "amg", "amg"
            raise ValueError("AMG backend is not available.")
        if "krylov" in available:
            return "krylov", method
        return available[0], method

    # -- solving ------------------------------------------------------------

    def solve(self, A: Union[Any, Callable], b: jax.Array,
              x0: Optional[jax.Array] = None, *, method: Optional[str] = None,
              backend: Optional[str] = None, tol: float = 1e-6,
              atol: float = 0.0, maxiter: Optional[int] = None,
              M: Optional[Any] = None, restart: int = 20,
              solve_method: str = "batched", precision: str = "auto",
              reorder: Optional[str] = None,
              **kwargs) -> Tuple[jax.Array, SolverResult]:
        """Solve Ax = b. Returns (x, SolverResult).

        precision: 'full' solves in b's dtype; 'mixed' runs f32 inner Krylov
        sweeps with defect-correction refinement to the requested tolerance
        (solvers/mixed.py: the inner sweeps stream half the matrix bytes).
        The default 'auto' picks 'mixed' for real f64 Krylov solves with
        tol ≥ 1e-12 and 'full' otherwise; the refined path meets the same
        f64-checked residual contract (reference fp64 default:
        torch_sparse_linalg.py:57-58). Whether 'mixed' should stay the f64
        default on the GPU is decided by measurement (ROADMAP.md).

        M: a preconditioner callable, or one of the built-in names
        'jacobi' | 'fsai' | 'fsai2' | 'chebyshev' | 'neumann' | 'ilu0' |
        'amg' — built once per matrix content and cached.

        reorder: 'rcm' symmetrically permutes the system with a
        reverse-Cuthill-McKee ordering (host-side, cached per matrix
        content) before solving and un-permutes the solution — bandwidth/
        column-locality reduction that improves the locality of the x
        gathers of unstructured matrices (and their CWELL fill, see
        sparse/cwell.py). Requires a concrete matrix operand.
        """
        if precision not in ("auto", "full", "mixed"):
            raise ValueError(f"unknown precision '{precision}'; use "
                             "'auto', 'full' or 'mixed'")
        if hasattr(A, "shape") and hasattr(b, "shape") and b.ndim >= 1 \
                and b.shape[0] != A.shape[0]:
            # must precede the reorder dispatch: JAX's clamping gather
            # would let b[perm] silently accept a wrong-length b
            raise ValueError(
                f"dimension mismatch: A is {A.shape}, b has length "
                f"{b.shape[0]}")
        b, x0 = _promote_to_complex(A, b, x0)
        if reorder is not None:
            return self._solve_reordered(
                A, b, x0, reorder, method=method, backend=backend, tol=tol,
                atol=atol, maxiter=maxiter, M=M, restart=restart,
                solve_method=solve_method, precision=precision, **kwargs)
        method = method or self.default_method
        backend = backend or self.default_backend
        sel_backend, sel_method = self._select_backend(backend, method)
        if precision == "auto":
            # an explicit multi_rhs='block' request keeps full precision:
            # the mixed multi-RHS path is the vmapped refinement (there is
            # no block-refined variant to honor the block structure with)
            precision = ("mixed" if _auto_mixed_ok(A, b, tol, sel_backend)
                         and kwargs.get("multi_rhs") != "block"
                         else "full")
        if self.verbose:
            print(f"[SparseSolver] backend={sel_backend} method={sel_method}")

        # Resolve/validate M only for backends that use it.  AMG builds its
        # own hierarchy preconditioning and the direct path factorizes A, so
        # a user-supplied M there would be silently dropped — say so instead
        # (and skip the potentially expensive string-M setup entirely).
        if M is not None and sel_backend in ("amg", "direct"):
            warnings.warn(
                f"M is ignored for backend='{sel_backend}' "
                f"(method='{sel_method}'); use a krylov method to apply a "
                "preconditioner.", stacklevel=2)
            M = None
        elif isinstance(M, str):
            M = self._precond_M(A, M)

        # Multi-RHS: a 2-D array b = (n, k) routes to the block/batched
        # solvers (the reference loops sequentially per RHS,
        # cudss_solver.py:297-324; here one compiled program covers all k).
        if getattr(b, "ndim", 1) == 2 and hasattr(b, "dtype"):
            return self._solve_multirhs(
                A, b, x0, sel_backend, sel_method, tol, atol, maxiter, M,
                restart, solve_method, precision=precision, **kwargs)

        if sel_backend == "krylov" and precision == "mixed":
            x, info, iters, res, rel = self._solve_krylov_mixed(
                A, b, x0, sel_method, tol, atol, maxiter, M, restart,
                solve_method)
        elif sel_backend == "krylov":
            x, info, iters, res, rel = self._solve_krylov(
                A, b, x0, sel_method, tol, atol, maxiter, M, restart,
                solve_method)
        elif sel_backend == "amg":
            x, info, iters, res, rel = self._solve_amg(
                A, b, x0, sel_method, tol, atol, maxiter, **kwargs)
        elif sel_backend == "direct":
            x, info, iters, res, rel = self._solve_direct(A, b, **kwargs)
        else:
            raise ValueError(f"unknown backend {sel_backend}")

        # No device→host transfer here: the result's scalar fields are
        # device arrays that materialize lazily in ONE batched fetch on
        # first access.
        result = SolverResult(
            x=x, converged=(info == 0) if hasattr(info, "dtype")
            else bool(info == 0),
            iterations=iters, residual=rel, backend=sel_backend,
            method=sel_method,
        )
        return x, result

    def _reorder_cached(self, A):
        """(A_rcm_csr, perm, invperm) for a concrete matrix operand,
        cached per matrix content."""
        from tpu_sparse.utils.opcache import OperandCache

        cached = getattr(self, "_reorder_cache", None)
        if cached is None:
            cached = self._reorder_cache = OperandCache(max_entries=8)

        def build():
            import numpy as np
            import scipy.sparse as sp
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            from tpu_sparse.sparse.convert import csr_from_arrays, to_csr

            Ac = to_csr(A)
            # one scipy materialization serves both the RCM ordering and
            # the permutation (rcm_permutation would rebuild it)
            S = sp.csr_matrix(
                (np.asarray(Ac.data), np.asarray(Ac.indices),
                 np.asarray(Ac.indptr)), shape=Ac.shape)
            perm = np.asarray(reverse_cuthill_mckee(S,
                                                    symmetric_mode=False))
            Sp = S[perm][:, perm].tocsr()
            Sp.sort_indices()
            Ap = csr_from_arrays(Sp.data, Sp.indices, Sp.indptr, Ac.shape)
            inv = np.argsort(perm)
            return Ap, jnp.asarray(perm), jnp.asarray(inv)

        return cached.get_or_build(A, build, extra=("rcm",))

    def _solve_reordered(self, A, b, x0, reorder: str, *, M=None, **kw):
        """Symmetric RCM permutation wrapper: solve P A Pᵀ (P x) = P b and
        un-permute (see solve() docstring)."""
        if reorder != "rcm":
            raise ValueError(f"unknown reorder '{reorder}'; use 'rcm'")
        if callable(A) and not is_sparse(A) and not hasattr(A, "ndim"):
            raise ValueError("reorder requires a matrix operand, not a "
                             "matrix-free callable")
        if isinstance(M, str) is False and M is not None:
            raise ValueError(
                "reorder supports M=None or a built-in string name (the "
                "preconditioner is then built from the permuted matrix); a "
                "user callable M would act in the wrong ordering")
        Ap, perm, inv = self._reorder_cached(A)
        take = lambda v, p: v[p] if v.ndim == 1 else v[p, :]  # noqa: E731
        bp = take(b, perm)
        x0p = None if x0 is None else take(x0, perm)
        x, result = self.solve(Ap, bp, x0p, M=M, reorder=None, **kw)
        xu = take(x, inv)
        return xu, result.replace_x(xu)

    def _relative_residual(self, A, b, x) -> float:
        try:
            r = tree_norm(tree_sub(b, as_matvec(A)(x)))
            bn = tree_norm(b)
            return float(r / jnp.where(bn > 0, bn, 1.0))
        except Exception:
            return float("nan")

    def _solve_krylov(self, A, b, x0, method, tol, atol, maxiter, M,
                      restart, solve_method):
        return _jitted_krylov(method, tol, atol, maxiter, restart,
                              solve_method, False)(_wrap_m(A), b, x0,
                                                   _wrap_m(M))

    def _solve_krylov_mixed(self, A, b, x0, method, tol, atol, maxiter, M,
                            restart, solve_method):
        return _jitted_krylov(method, tol, atol, maxiter, restart,
                              solve_method, True)(_wrap_m(A), b, x0,
                                                  _wrap_m(M))

    _PRECOND_NAMES = ("jacobi", "fsai", "fsai2", "chebyshev", "neumann",
                      "ilu0", "amg")

    def _precond_M(self, A, spec: str):
        """Resolve a string preconditioner name to a cached callable."""
        name = spec.lower()
        if name not in self._PRECOND_NAMES:
            raise ValueError(
                f"unknown preconditioner '{spec}'; available: "
                f"{', '.join(self._PRECOND_NAMES)}")
        if callable(A) and not is_sparse(A) and not hasattr(A, "ndim"):
            raise ValueError(
                f"M='{spec}' needs a matrix operand to build from; "
                "matrix-free callables must pass M as a callable")
        if name == "amg":
            return self._amg_M(A)

        from tpu_sparse.utils.opcache import OperandCache

        cached = getattr(self, "_m_cache", None)
        if cached is None:
            cached = self._m_cache = OperandCache(max_entries=16)

        def build():
            import tpu_sparse.precond as _p

            if name == "jacobi":
                return _p.jacobi_preconditioner(A)
            if name == "fsai":
                return _p.fsai_preconditioner(A)
            if name == "fsai2":
                return _p.fsai_preconditioner(A, pattern_power=2)
            if name == "chebyshev":
                return _p.chebyshev_preconditioner(A)
            if name == "neumann":
                return _p.neumann_preconditioner(A)
            return _p.ilu0_preconditioner(A)  # DIA only; raises otherwise

        return cached.get_or_build(A, build, extra=(name,))

    def _amg_M(self, A, **kwargs):
        """AMG preconditioner for A, cached per matrix content (hierarchy
        setup is a host-side graph phase that cannot be jitted)."""
        from tpu_sparse.precond.amg import amg_preconditioner

        from tpu_sparse.utils.opcache import OperandCache

        cached = getattr(self, "_amg_cache", None)
        if cached is None:
            cached = self._amg_cache = OperandCache(max_entries=8)
        return cached.get_or_build(
            A, lambda: amg_preconditioner(A, **kwargs),
            extra=tuple(sorted(kwargs.items())))

    def _solve_amg(self, A, b, x0, method, tol, atol, maxiter, **kwargs):
        accelerant = kwargs.pop("accelerant", "cg")
        maxiter = maxiter if maxiter is not None else 100
        if accelerant in (None, "none"):
            # stationary V-cycle iteration with its own convergence loop
            # (AMGX amg-as-solver parity, torch_amgx.py:481-483); default
            # AMGX sweeps (0 pre / 3 post) unless the caller overrides
            kwargs.setdefault("pre_sweeps", 0)
            kwargs.setdefault("post_sweeps", 3)
            kwargs.setdefault("omega", 1.0)
            M = self._amg_M(A, **kwargs)
            return _jitted_amg_stationary(tol, atol, maxiter)(A, b, x0, M)
        M = self._amg_M(A, **kwargs)
        return _jitted_krylov("cg", tol, atol, maxiter, 20, "batched",
                              False)(A, b, x0, M)

    def _solve_direct(self, A, b, **kwargs):
        x, info, _, res, rel = _jitted_direct()(A, b)
        return x, info, None, res, rel

    def _solve_multirhs(self, A, B, X0, sel_backend, method, tol, atol,
                        maxiter, M, restart, solve_method,
                        precision="full", **kwargs):
        """(n, k) RHS block: block CG for SPD methods (shared Krylov
        space, kxk Gram dots), vmapped solvers otherwise;
        precision='mixed' vmaps the defect-correction refinement."""
        from tpu_sparse.solvers import (batch_bicgstab, batch_gmres,
                                        block_cg)

        report_backend, report_method = sel_backend, method
        multi_rhs = kwargs.pop("multi_rhs", "auto")
        if multi_rhs not in ("auto", "block", "batch"):
            raise ValueError(f"unknown multi_rhs '{multi_rhs}'; use "
                             "'auto', 'block', or 'batch'")
        if sel_backend == "amg":
            M = self._amg_M(A, **kwargs)
            maxiter = maxiter if maxiter is not None else 100
            method = "cg"
            sel_backend = "krylov"
        if precision == "mixed" and sel_backend == "krylov":
            if multi_rhs == "block":
                warnings.warn(
                    "multi_rhs='block' is unavailable with "
                    "precision='mixed'; using the vmapped batch "
                    "refinement instead.", stacklevel=3)
            from tpu_sparse.solvers import batch_refined

            kw = dict(tol=tol, atol=atol, maxiter=maxiter, M=M)
            if method == "gmres":
                kw.update(restart=restart, solve_method=solve_method)
            elif method == "fgmres":
                kw.update(restart=restart)
            X, infos, iters_v, res = batch_refined(
                method, _wrap_m(A), B, X0, **kw)
            info = jnp.where(jnp.all(infos == 0), 0, -1).astype(jnp.int32)
            iters = jnp.max(iters_v)
            bn = jnp.linalg.norm(B, axis=0)
            rel = jnp.max(res / jnp.where(bn > 0, bn, 1.0))
            info_v, iters_vv, rel_v = jax.device_get((info, iters, rel))
            return X, SolverResult(
                x=X, converged=bool(info_v == 0),
                iterations=int(iters_vv), residual=float(rel_v),
                backend=report_backend, method=report_method)
        if sel_backend == "direct":
            # solve + per-column residual report in ONE device program
            # (a per-column Python loop would dispatch k extra programs)
            X, info, rel = _jitted_batch_direct()(A, B)
            iters = None
        elif method in ("cg", "cg_sr"):
            # For INDEPENDENT RHS the vmapped batch CG is preferred: the
            # shared Krylov space buys nothing there while the kxk Gram
            # solves cost every iteration. Preconditioned solves keep
            # block CG (spectrally clustered => shared space pays). The
            # split has not been re-timed on the GPU (ROADMAP.md).
            use_block = (multi_rhs == "block"
                         or (multi_rhs == "auto" and M is not None))
            if use_block:
                # block CG already fuses reductions across the RHS block,
                # so the single-reduction variant adds nothing here
                X, infos, iters, res = block_cg(A, B, X0, tol=tol,
                                                atol=atol, maxiter=maxiter,
                                                M=M)
            else:
                from tpu_sparse.solvers import batch_cg

                X, infos, iters_v, res = batch_cg(A, B, X0, tol=tol,
                                                  atol=atol,
                                                  maxiter=maxiter, M=M)
                iters = jnp.max(iters_v)
            info = jnp.where(jnp.all(infos == 0), 0, -1).astype(jnp.int32)
            bn = jnp.linalg.norm(B, axis=0)
            rel = jnp.max(res / jnp.where(bn > 0, bn, 1.0))
        elif method in ("bicgstab", "gmres", "minres", "fcg", "fgmres"):
            from tpu_sparse.solvers import (batch_fcg, batch_fgmres,
                                            batch_minres)

            fn = {"bicgstab": batch_bicgstab, "gmres": batch_gmres,
                  "minres": batch_minres, "fcg": batch_fcg,
                  "fgmres": batch_fgmres}[method]
            kw = dict(tol=tol, atol=atol, maxiter=maxiter, M=M)
            if method == "gmres":
                kw.update(restart=restart, solve_method=solve_method)
            elif method == "fgmres":
                kw.update(restart=restart)
            X, infos, iters_v, res = fn(A, B, X0, **kw)
            info = jnp.where(jnp.all(infos == 0), 0, -1).astype(jnp.int32)
            iters = jnp.max(iters_v)
            bn = jnp.linalg.norm(B, axis=0)
            rel = jnp.max(res / jnp.where(bn > 0, bn, 1.0))
        else:
            raise ValueError(
                f"multi-RHS solve does not support method '{method}'")
        result = SolverResult(
            x=X, converged=(info == 0),
            iterations=iters, residual=rel, backend=report_backend,
            method=report_method,
        )
        return X, result

    # -- shortcuts (reference solver.py:455-508) ----------------------------

    @contextmanager
    def session(self):
        """Batch-solving context (reference solver.py:102-106):
        ``with solver.session() as s: s.solve(...)``. Backend probing is
        done once up front; the context yields this solver."""
        _ = self.available_backends
        yield self

    def cg(self, A, b, **kw):
        return self.solve(A, b, method="cg", **kw)

    def bicgstab(self, A, b, **kw):
        return self.solve(A, b, method="bicgstab", **kw)

    def gmres(self, A, b, **kw):
        return self.solve(A, b, method="gmres", **kw)

    def amg(self, A, b, **kw):
        return self.solve(A, b, method="amg", **kw)

    def direct(self, A, b, **kw):
        return self.solve(A, b, method="direct", **kw)


# -- jitted solver cache ------------------------------------------------------
#
# Without jit, solver calls execute op-by-op (hundreds of dispatches per
# solve). Each (method, options) combination is compiled once and cached;
# A/b/x0/M are traced pytree arguments.


def _wrap_m(op):
    """Wrap a plain-callable operator (A or M) in Partial so it can ride
    through jit as a (zero-leaf) pytree argument."""
    from jax.tree_util import Partial

    if op is not None and callable(op) and not is_sparse(op) \
            and not isinstance(op, Partial) and not hasattr(op, "ndim"):
        return Partial(op)
    return op


@functools.lru_cache(maxsize=256)
def _jitted_krylov(method: str, tol: float, atol: float, maxiter, restart,
                   solve_method: str, mixed: bool):
    from tpu_sparse.autodiff import bicgstab_diff, cg_diff, gmres_diff
    from tpu_sparse.solvers import (
        bicgstab_refined,
        cg_refined,
        cg_sr_refined,
        fcg_refined,
        fgmres_refined,
        gmres_refined,
        minres_refined,
    )

    def run(A, b, x0, M):
        out = _run_inner(A, b, x0, M)
        # relative residual for SolverResult, inside the same program
        rel = tree_norm(tree_sub(b, as_matvec(A)(out[0])))
        bn = tree_norm(b)
        return out + (rel / jnp.where(bn > 0, bn, 1.0),)

    def _run_inner(A, b, x0, M):
        if mixed:
            if method == "cg":
                return cg_refined(A, b, x0, tol=tol, atol=atol,
                                  maxiter=maxiter, M=M)
            if method == "cg_sr":
                return cg_sr_refined(A, b, x0, tol=tol, atol=atol,
                                     maxiter=maxiter, M=M)
            if method == "minres":
                return minres_refined(A, b, x0, tol=tol, atol=atol,
                                      maxiter=maxiter, M=M)
            if method == "fcg":
                return fcg_refined(A, b, x0, tol=tol, atol=atol,
                                   maxiter=maxiter, M=M)
            if method == "fgmres":
                return fgmres_refined(A, b, x0, tol=tol, atol=atol,
                                      restart=restart, maxiter=maxiter,
                                      M=M)
            if method == "bicgstab":
                return bicgstab_refined(A, b, x0, tol=tol, atol=atol,
                                        maxiter=maxiter, M=M)
            if method == "gmres":
                return gmres_refined(A, b, x0, tol=tol, atol=atol,
                                     restart=restart, maxiter=maxiter,
                                     M=M, solve_method=solve_method)
        else:
            if method == "cg":
                return cg_diff(A, b, x0, tol=tol, atol=atol,
                               maxiter=maxiter, M=M)
            if method == "cg_sr":
                from tpu_sparse.autodiff import cg_sr_diff

                return cg_sr_diff(A, b, x0, tol=tol, atol=atol,
                                  maxiter=maxiter, M=M)
            if method == "fcg":
                from tpu_sparse.autodiff import fcg_diff

                return fcg_diff(A, b, x0, tol=tol, atol=atol,
                                maxiter=maxiter, M=M)
            if method == "minres":
                from tpu_sparse.autodiff import minres_diff

                return minres_diff(A, b, x0, tol=tol, atol=atol,
                                   maxiter=maxiter, M=M)
            if method == "fgmres":
                from tpu_sparse.autodiff import fgmres_diff

                return fgmres_diff(A, b, x0, tol=tol, atol=atol,
                                   restart=restart, maxiter=maxiter, M=M)
            if method == "bicgstab":
                return bicgstab_diff(A, b, x0, tol=tol, atol=atol,
                                     maxiter=maxiter, M=M)
            if method == "gmres":
                return gmres_diff(A, b, x0, tol=tol, atol=atol,
                                  restart=restart, maxiter=maxiter, M=M,
                                  solve_method=solve_method)
        raise ValueError(f"unknown krylov method: {method}")

    return jax.jit(run)


def _operand_dtype(A):
    """Element dtype of a matrix operand: container value arrays first (a
    plain ndarray's ``.data`` is a memoryview and is skipped), then the
    operand's own dtype; None for matrix-free callables."""
    for attr in ("data", "vals"):
        d = getattr(A, attr, None)
        if d is not None and hasattr(d, "dtype"):
            return d.dtype
    return getattr(A, "dtype", None)


def _promote_to_complex(A, b, x0):
    """A complex matrix with a real b (or x0) has a complex solution: the
    Krylov carries take b's dtype, so b and x0 are promoted up front."""
    a_dt = _operand_dtype(A)
    if (a_dt is None or not jnp.issubdtype(a_dt, jnp.complexfloating)
            or not hasattr(b, "dtype")
            or jnp.issubdtype(b.dtype, jnp.complexfloating)):
        return b, x0
    dt = jnp.result_type(a_dt, b.dtype)
    return b.astype(dt), None if x0 is None else x0.astype(dt)


def _auto_mixed_ok(A, b, tol: float, sel_backend: str) -> bool:
    """precision='auto' resolution: real-f64 Krylov solves with a matrix
    operand and a reachable tolerance run the defect-correction mixed
    path (f32 inner sweeps + f64 outer residuals); everything else keeps
    'full' semantics."""
    if sel_backend != "krylov" or tol < 1e-12:
        return False
    if callable(A) and not is_sparse(A) and not hasattr(A, "ndim"):
        return False  # matrix-free callables cannot be precision-cast
    return getattr(b, "dtype", None) == jnp.float64


@functools.lru_cache(maxsize=32)
def _jitted_amg_stationary(tol: float, atol: float, maxiter: int):
    """Stationary AMG iteration (accelerant=None) as one jitted program;
    the hierarchy rides through as a pytree Partial argument."""
    from tpu_sparse.precond.amg import amg_stationary_solve

    def run(A, b, x0, M):
        x, info, iters, res = amg_stationary_solve(
            A, b, x0, tol=tol, atol=atol, maxiter=maxiter, precond=M)
        bn = tree_norm(b)
        return x, info, iters, res, res / jnp.where(bn > 0, bn, 1.0)

    return jax.jit(run)


@functools.lru_cache(maxsize=1)
def _jitted_batch_direct():
    """Multi-RHS direct solve + per-column residual info as one program.

    The residual block B − AX goes through the SpMM dispatch, which reads
    the matrix once for all k columns."""
    from tpu_sparse.kernels import spmm
    from tpu_sparse.solvers import batch_direct

    def run(A, B):
        X = batch_direct(A, B)
        R = B - spmm(A, X)
        res = jnp.linalg.norm(R, axis=0)
        bn = jnp.linalg.norm(B, axis=0)
        # per-column convergence contract of direct_residual_info
        rel_tol = 1e-8 if jnp.finfo(B.dtype).bits >= 64 else 1e-4
        ok = jnp.isfinite(res) & (
            res <= jnp.maximum(rel_tol * bn, jnp.finfo(B.dtype).tiny))
        info = jnp.where(jnp.all(ok), 0, -1).astype(jnp.int32)
        rels = res / jnp.where(bn > 0, bn, 1.0)
        return X, info, jnp.max(rels)

    return jax.jit(run)


@functools.lru_cache(maxsize=1)
def _jitted_direct():
    from tpu_sparse.direct import direct_solve_full_diff

    def run(A, b):
        out = direct_solve_full_diff(A, b)
        rel = tree_norm(tree_sub(b, as_matvec(A)(out[0])))
        bn = tree_norm(b)
        return out + (rel / jnp.where(bn > 0, bn, 1.0),)

    return jax.jit(run)


# -- module-level convenience API (reference solver.py:508-576) --------------

_default_solver: Optional[SparseSolver] = None


def _get_default_solver() -> SparseSolver:
    global _default_solver
    if _default_solver is None:
        _default_solver = SparseSolver()
    return _default_solver


def solve(A, b, method: str = "cg", backend: str = "auto", **kwargs):
    """Solve Ax=b via the shared default SparseSolver."""
    return _get_default_solver().solve(A, b, method=method, backend=backend,
                                       **kwargs)


def cg(A, b, **kwargs):
    return solve(A, b, method="cg", **kwargs)


def bicgstab(A, b, **kwargs):
    return solve(A, b, method="bicgstab", **kwargs)


def gmres(A, b, **kwargs):
    return solve(A, b, method="gmres", **kwargs)


def amg(A, b, **kwargs):
    return solve(A, b, method="amg", backend="amg", **kwargs)


def direct_solve(A, b, **kwargs):
    return solve(A, b, method="direct", backend="direct", **kwargs)
