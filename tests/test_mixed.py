"""Mixed-precision defect-correction solver tests."""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_sparse.solvers import bicgstab_refined, cg_refined, gmres_refined
from tpu_sparse.sparse import generators


def _setup(gen, n=64, seed=0):
    A = gen(n)
    x_true = jnp.asarray(np.random.default_rng(seed).standard_normal(n))
    return A, A @ x_true, x_true


def test_cg_refined_reaches_f64_tol():
    A, b, x_true = _setup(generators.tridiagonal)
    x, info, inner_iters, res = cg_refined(A, b, tol=1e-10)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-10  # beyond f32 reach: proves refinement works
    assert int(inner_iters) > 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-8, atol=1e-9)


def test_bicgstab_refined_nonsymmetric():
    A, b, x_true = _setup(generators.convection_diffusion)
    x, info, _, res = bicgstab_refined(A, b, tol=1e-10)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-10


def test_gmres_refined():
    A, b, x_true = _setup(generators.convection_diffusion)
    x, info, _, res = gmres_refined(A, b, tol=1e-10, restart=30)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-10


def test_refined_jit():
    A, b, _ = _setup(generators.tridiagonal)
    f = jax.jit(lambda a, rhs: cg_refined(a, rhs, tol=1e-10)[0])
    x = f(A, b)
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-10


def test_refined_matrix_free():
    A, b, _ = _setup(generators.tridiagonal)

    def op(v):
        return A @ v

    x, info, _, _ = cg_refined(op, b, tol=1e-10)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-10


def test_bicgstab_refined_illcond_tridiag():
    # Round-1 benchmark cells that stalled: mixed-precision BiCGStab on the
    # n=500 tridiagonal (condition ~1e5) at tol=1e-8. The full-precision
    # rescue sweep in refined_solve must close them.
    A, b, x_true = _setup(generators.tridiagonal, n=500, seed=3)
    x, info, _, res = bicgstab_refined(A, b, tol=1e-8, maxiter=5000)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-8


def test_gmres_refined_illcond_tridiag():
    A, b, x_true = _setup(generators.tridiagonal, n=500, seed=4)
    x, info, _, res = gmres_refined(A, b, tol=1e-8, restart=30, maxiter=5000)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-8


def test_cg_sr_refined_reaches_f64_tol():
    """Mixed precision for the single-reduction CG (router
    method='cg_sr', precision='mixed')."""
    from tpu_sparse.solvers import cg_sr_refined

    A, b, x_true = _setup(generators.tridiagonal)
    x, info, inner_iters, res = cg_sr_refined(A, b, tol=1e-10)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-10
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-8, atol=1e-9)


def test_minres_refined_indefinite():
    """Defect correction around MINRES: symmetric INDEFINITE at f32 inner
    speed, f64 accuracy."""
    from tests.test_solvers import _indefinite_system
    from tpu_sparse.solvers import minres_refined

    A = _indefinite_system(n=144, shift=1.2, seed=7)
    rng = np.random.default_rng(7)
    x_true = jnp.asarray(rng.standard_normal(A.shape[0]))
    b = A @ x_true
    x, info, _, res = minres_refined(A, b, tol=1e-10, maxiter=5000)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-10
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-6, atol=1e-7)


def test_fcg_fgmres_refined():
    from tpu_sparse.precond import jacobi_preconditioner
    from tpu_sparse.solvers import fcg_refined, fgmres_refined

    A, b, x_true = _setup(lambda n: generators.poisson2d(8), n=64)
    M = jacobi_preconditioner(A)
    for fn in (fcg_refined, fgmres_refined):
        x, info, _, res = fn(A, b, tol=1e-10, M=M)
        assert int(info) == 0, fn.__name__
        rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
        assert rel < 1e-10, fn.__name__


def test_router_mixed_all_methods():
    """Every Krylov method is reachable with precision='mixed' through the
    router (the reference's fp64 protocol at f32 inner speed)."""
    from tpu_sparse.api.solver import SparseSolver

    A, b, x_true = _setup(lambda n: generators.poisson2d(8), n=64, seed=9)
    s = SparseSolver()
    for method in ("cg", "bicgstab", "gmres", "cg_sr", "minres", "fcg",
                   "fgmres"):
        x, r = s.solve(A, b, method=method, precision="mixed", tol=1e-9)
        assert r.converged, method
        rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
        assert rel < 1e-9, (method, rel)


def test_gmres_refined_adaptive_restart_ill_conditioned():
    """Round-2 headline regression: gmres_refined on the n=500 1-D
    Laplacian (cond ~ 1e5) at tol=1e-8 with the default restart=20.

    The adaptive-restart policy raises the effective restart to n (full
    GMRES, exact termination), and the f32 sweeps use the backward-stable
    QR lstsq — without both, this solve took thousands of f64 restart
    cycles (BENCH_r02: 6.18 s; with them it is two f32 cycles)."""
    A = generators.tridiagonal(500)
    rng = np.random.default_rng(0)
    b = A @ jnp.asarray(rng.standard_normal(500))
    solve = jax.jit(lambda a, rhs: gmres_refined(a, rhs, tol=1e-8,
                                                 restart=20, maxiter=5000))
    x, info, cycles, res = solve(A, b)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-8
    # two productive f32 sweeps + free zero-rhs sweeps; the f64 rescue
    # must NOT have run a meaningful number of cycles
    assert int(cycles) <= 6, f"adaptive restart regressed: {int(cycles)} cycles"


def test_gmres_refined_adaptive_restart_off():
    """adaptive_restart=False keeps the user's restart verbatim (strict
    reference semantics) — exercised on a well-conditioned system where
    GMRES(20) genuinely converges."""
    from tpu_sparse.solvers import gmres_refined as gr

    A, b, x_true = _setup(lambda n: generators.tridiagonal(n, main=4.0), n=64)
    x, info, _, _ = gr(A, b, tol=1e-10, restart=20, adaptive_restart=False)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-10


def test_router_precision_auto_routes_f64_to_mixed(monkeypatch):
    """precision defaults to 'auto': real-f64 Krylov
    solves with a reachable tol run the defect-correction mixed path, and
    the result still honors the f64 residual contract."""
    from tpu_sparse.api.solver import SparseSolver

    A = generators.poisson2d(24)  # f64
    rng = np.random.default_rng(3)
    x_true = jnp.asarray(rng.standard_normal(A.shape[0]))
    b = A @ x_true

    s = SparseSolver()
    calls = {"mixed": 0, "full": 0}
    orig_mixed = SparseSolver._solve_krylov_mixed
    orig_full = SparseSolver._solve_krylov

    def spy_mixed(self, *a, **k):
        calls["mixed"] += 1
        return orig_mixed(self, *a, **k)

    def spy_full(self, *a, **k):
        calls["full"] += 1
        return orig_full(self, *a, **k)

    monkeypatch.setattr(SparseSolver, "_solve_krylov_mixed", spy_mixed)
    monkeypatch.setattr(SparseSolver, "_solve_krylov", spy_full)

    x, r = s.solve(A, b, method="cg", tol=1e-9, maxiter=5000)
    assert calls == {"mixed": 1, "full": 0}
    assert r.converged
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel <= 1e-9, rel

    # explicit 'full' and sub-reach tolerances keep the f64-vector loop
    s.solve(A, b, method="cg", tol=1e-9, precision="full", maxiter=5000)
    assert calls == {"mixed": 1, "full": 1}
    s.solve(A, b, method="cg", tol=1e-13, maxiter=20000)
    assert calls == {"mixed": 1, "full": 2}

    # f32 operands never auto-route to mixed
    A32 = generators.poisson2d(24, dtype=np.float32)
    b32 = (A32 @ x_true.astype(jnp.float32)).astype(jnp.float32)
    s.solve(A32, b32, method="cg", tol=1e-5, maxiter=5000)
    assert calls == {"mixed": 1, "full": 3}


def test_gmres_f32_qr_lstsq_floor():
    """The f32 batched cycle must attain a backward-stable residual floor
    on an ill-conditioned system (normal equations in f32 stall ~1e-1;
    QR reaches ~eps32*cond)."""
    from tpu_sparse.solvers.krylov import gmres_full

    A = generators.tridiagonal(300, dtype=np.float32)
    rng = np.random.default_rng(1)
    b = A @ jnp.asarray(rng.standard_normal(300).astype(np.float32))
    x, info, k, res = gmres_full(A, b, tol=1e-5, restart=300, maxiter=1)
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-4, f"f32 full-GMRES floor regressed: {rel}"


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)
