"""The router's Krylov path (`solve` → jitted `cg_diff`/`bicgstab_diff`
→ while-loop solver → `kernels.spmv`) on f32 stencil systems: iteration
parity with the bare solvers, the true-residual contract, Jacobi
preconditioning, the implicit-diff gradient, and failure reporting."""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.tree_util import Partial

from tpu_sparse import solve
from tpu_sparse.solvers import bicgstab_full, cg_full
from tpu_sparse.sparse import generators


def _problem(rng, nx=40):
    A = generators.poisson2d(nx, dtype=np.float32)
    x_true = jnp.asarray(rng.standard_normal(A.shape[0]).astype(np.float32))
    return A, A @ x_true


def _nonsym_problem(rng, nx=24):
    A = generators.poisson2d(nx, dtype=np.float32)
    data = np.asarray(A.data).copy()
    offs = list(A.offsets)
    data[offs.index(-1)] *= 1.3   # upwind skew: nonsymmetric
    data[offs.index(1)] *= 0.7
    A = A.with_data(jnp.asarray(data))
    x_true = jnp.asarray(rng.standard_normal(A.shape[0]).astype(np.float32))
    return A, A @ x_true, x_true


def _true_rel(A, b, x):
    return float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))


def test_router_cg_matches_cg_full(rng):
    A, b = _problem(rng)
    tol = 1e-5
    x, r = solve(A, b, method="cg", tol=tol, maxiter=600)
    x_r, info_r, it_r, _ = cg_full(A, b, tol=tol, maxiter=600)
    assert r.converged and int(info_r) == 0
    assert r.iterations == int(it_r)
    assert _true_rel(A, b, x) <= 2 * tol
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_r),
                               rtol=1e-5, atol=1e-6)


def test_router_cg_converged_early_stays_finite(rng):
    """A small system converges far inside a large maxiter; the result
    stays finite and meets the contract."""
    A, b = _problem(rng, nx=16)
    x, r = solve(A, b, method="cg", tol=1e-5, maxiter=4000)
    assert r.converged
    assert np.all(np.isfinite(np.asarray(x)))
    assert r.iterations < 4000
    assert _true_rel(A, b, x) <= 2e-5


def test_router_cg_reported_residual(rng):
    """The reported relative residual honors the tolerance."""
    A, b = _problem(rng)
    tol = 1e-4
    _, r = solve(A, b, method="cg", tol=tol, maxiter=600)
    assert r.converged
    assert r.residual <= 2 * tol


def test_router_jacobi_pcg_matches_cg_full(rng):
    """Jacobi-PCG through the router (M='jacobi'): iteration parity with
    the preconditioned cg_full, and the preconditioner engages."""
    A, b = _problem(rng)
    d = np.asarray(A.data[A.offsets.index(0)]).copy()
    d *= (1.0 + 0.5 * np.abs(np.sin(np.arange(d.shape[0]))))
    A = A.with_data(jnp.asarray(np.asarray(A.data)).at[
        A.offsets.index(0)].set(jnp.asarray(d.astype(np.float32))))
    dinv = jnp.asarray((1.0 / d).astype(np.float32))
    tol = 1e-5
    x, r = solve(A, b, method="cg", tol=tol, maxiter=800, M="jacobi")
    M = Partial(lambda dd, v: dd * v, dinv)
    x_r, info_r, it_r, _ = cg_full(A, b, tol=tol, maxiter=800, M=M)
    assert r.converged and int(info_r) == 0
    assert abs(r.iterations - int(it_r)) <= 1, (r.iterations, int(it_r))
    assert _true_rel(A, b, x) <= 2 * tol
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_r),
                               rtol=5e-3, atol=5e-4)
    _, r_plain = solve(A, b, method="cg", tol=tol, maxiter=800)
    assert r_plain.iterations != r.iterations


def test_router_jacobi_cg_tight_tol(rng):
    A, b = _problem(rng, nx=24)
    x, r = solve(A, b, method="cg", tol=1e-6, maxiter=800, M="jacobi")
    assert r.converged
    assert _true_rel(A, b, x) <= 2e-6


def test_router_cg_differentiable(rng):
    """The router's f32 CG stays differentiable: grad wrt b matches a
    finite difference on one coordinate."""
    A, b = _problem(rng, nx=24)

    def loss(bb):
        return jnp.sum(solve(A, bb, method="cg", tol=1e-6,
                             maxiter=800)[0] ** 2)

    g = jax.grad(loss)(b)
    assert np.all(np.isfinite(np.asarray(g)))
    e = jnp.zeros_like(b).at[7].set(1e-2)
    fd = (loss(b + e) - loss(b - e)) / 2e-2
    np.testing.assert_allclose(float(g[7]), float(fd), rtol=2e-2)


def test_router_f64_cg_full_and_auto_agree(rng):
    """f64 systems solve in full precision or by f32 defect correction
    ('auto'); both meet the f64 contract."""
    A = generators.poisson2d(24)
    b = A @ jnp.asarray(rng.standard_normal(A.shape[0]))
    for precision in ("full", "auto"):
        x, r = solve(A, b, method="cg", tol=1e-10, maxiter=2000,
                     precision=precision)
        assert r.converged, precision
        assert x.dtype == jnp.float64
        assert _true_rel(A, b, x) <= 1.05e-10, precision


def test_router_bicgstab_matches_bicgstab_full(rng):
    A, b, x_true = _nonsym_problem(rng)
    tol = 1e-5
    x, r = solve(A, b, method="bicgstab", tol=tol, maxiter=600)
    x_r, info_r, it_r, _ = bicgstab_full(A, b, tol=tol, maxiter=600)
    assert r.converged and int(info_r) == 0
    assert r.iterations == int(it_r)
    assert _true_rel(A, b, x) <= 2 * tol
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=2e-3, atol=2e-3)


def test_router_bicgstab_converged_early_stays_finite(rng):
    A, b, _ = _nonsym_problem(rng, nx=12)
    x, r = solve(A, b, method="bicgstab", tol=1e-5, maxiter=3000)
    assert r.converged
    assert np.all(np.isfinite(np.asarray(x)))
    assert _true_rel(A, b, x) <= 2e-5


def test_router_bicgstab_singular_reports_failure(rng):
    """A singular system must not report success."""
    A = generators.poisson2d(12, dtype=np.float32)
    data = np.asarray(A.data).copy()
    offs = list(A.offsets)
    # zero row sums -> singular (pure Neumann-like)
    data[offs.index(0)] = -(data.sum(axis=0) - data[offs.index(0)])
    A = A.with_data(jnp.asarray(data))
    b = jnp.asarray(rng.standard_normal(A.shape[0]).astype(np.float32))
    _, r = solve(A, b, method="bicgstab", tol=1e-10, maxiter=400)
    assert not r.converged


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)
