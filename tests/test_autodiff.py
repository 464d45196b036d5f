"""Implicit-differentiation tests.

Exceeds the reference's gradient checks (existence/finiteness only,
test_gpu_validation.py:59-69) with finite-difference verification, per
SURVEY.md §4's test-plan note."""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_sparse.autodiff import bicgstab_diff, cg_diff, gmres_diff
from tpu_sparse.sparse import generators
from tpu_sparse.sparse.convert import to_csr


def fd_grad(f, x, eps=1e-6):
    x = np.asarray(x, dtype=np.float64)
    g = np.zeros_like(x)
    for i in range(x.size):
        xp = x.copy(); xp.flat[i] += eps
        xm = x.copy(); xm.flat[i] -= eps
        g.flat[i] = (f(jnp.asarray(xp)) - f(jnp.asarray(xm))) / (2 * eps)
    return g


def _loss_through_solve(solver, A, b):
    x = solver(A, b)[0]
    return jnp.sum(x**2)


@pytest.mark.parametrize("solver,gen", [
    (cg_diff, generators.tridiagonal),
    (bicgstab_diff, generators.convection_diffusion),
    (gmres_diff, generators.convection_diffusion),
])
def test_grad_b_fd(solver, gen):
    n = 16
    A = gen(n)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(n))

    def loss(bb):
        return _loss_through_solve(
            lambda a, r: solver(a, r, tol=1e-12), A, bb)

    g = jax.grad(loss)(b)
    g_fd = fd_grad(loss, b)
    np.testing.assert_allclose(np.asarray(g), g_fd, rtol=1e-4, atol=1e-6)


def test_grad_A_values_fd():
    """Gradient w.r.t. the matrix values on the sparsity pattern — the
    capability the reference only has in Modules B/C (torch_amgx.py:443-462,
    cudss_solver.py:159-163), here for the pure-Krylov backend too."""
    n = 16
    A = to_csr(generators.tridiagonal(n))
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal(n))

    def loss_data(d):
        x = cg_diff(A.with_data(d), b, tol=1e-12)[0]
        return jnp.sum(x**2)

    g = jax.grad(loss_data)(A.data)
    g_fd = fd_grad(loss_data, A.data, eps=1e-5)
    np.testing.assert_allclose(np.asarray(g), g_fd, rtol=1e-3, atol=1e-5)


def test_grad_dia_values():
    n = 16
    A = generators.tridiagonal(n)
    rng = np.random.default_rng(2)
    b = jnp.asarray(rng.standard_normal(n))

    def loss_data(d):
        x = cg_diff(A.with_data(d), b, tol=1e-12)[0]
        return jnp.sum(x**2)

    g = jax.grad(loss_data)(A.data)
    g_fd = fd_grad(loss_data, A.data, eps=1e-5)
    # out-of-band positions (masked-off corners) may hold nonzero grads in
    # the FD only if they're actually used; our spmv ignores them, so both
    # should agree everywhere.
    np.testing.assert_allclose(np.asarray(g), g_fd, rtol=1e-3, atol=1e-5)


def test_grad_matrix_free_callable():
    """Matrix-free operators: grads flow to b and to arrays the operator
    closes over, via lax.custom_linear_solve."""
    n = 16
    A = generators.tridiagonal(n)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(n))

    def loss(bb):
        x = cg_diff(lambda v: A @ v, bb, tol=1e-12)[0]
        return jnp.sum(x**2)

    g = jax.grad(loss)(b)
    g_fd = fd_grad(loss, b)
    np.testing.assert_allclose(np.asarray(g), g_fd, rtol=1e-4, atol=1e-6)


def test_adjoint_identity():
    """For loss = sum(x²): b̄ = A⁻ᵀ(2x) — check against dense linalg."""
    n = 16
    A = generators.convection_diffusion(n)
    Ad = np.asarray(A.todense())
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.standard_normal(n))

    g = jax.grad(
        lambda bb: jnp.sum(bicgstab_diff(A, bb, tol=1e-13)[0] ** 2))(b)
    x = np.linalg.solve(Ad, np.asarray(b))
    expected = np.linalg.solve(Ad.T, 2 * x)
    np.testing.assert_allclose(np.asarray(g), expected, rtol=1e-6, atol=1e-8)


def test_grad_under_jit():
    n = 16
    A = generators.tridiagonal(n)
    b = jnp.asarray(np.random.default_rng(5).standard_normal(n))

    @jax.jit
    def loss_and_grad(d, bb):
        def loss(dd, rhs):
            x = cg_diff(A.with_data(dd), rhs, tol=1e-12)[0]
            return jnp.sum(x**2)

        return jax.value_and_grad(loss, argnums=(0, 1))(d, bb)

    val, (gd, gb) = loss_and_grad(A.data, b)
    assert np.isfinite(float(val))
    assert np.all(np.isfinite(np.asarray(gd)))
    assert np.all(np.isfinite(np.asarray(gb)))
    assert float(jnp.abs(gb).max()) > 0


def test_fcg_grad_b_fd():
    """FCG adjoint gradients (finite-difference verified)."""
    from tpu_sparse.autodiff import fcg_diff

    n = 16
    A = generators.tridiagonal(n)
    b = jnp.asarray(np.random.default_rng(11).standard_normal(n))

    def loss(bb):
        return jnp.sum(fcg_diff(A, bb, tol=1e-12)[0] ** 2)

    g = jax.grad(loss)(b)
    g_fd = fd_grad(loss, b)
    np.testing.assert_allclose(np.asarray(g), g_fd, rtol=1e-4, atol=1e-6)


def test_router_cg_grad_fd_f32():
    """Implicit-diff through the router's CG solve (solve() inside
    jax.grad) in f32: gradients w.r.t. b AND the DIA values are
    finite-difference verified."""
    from tpu_sparse import solve

    n = 12
    A = generators.tridiagonal(n, dtype=np.float32)
    rng = np.random.default_rng(7)
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    kw = dict(method="cg", tol=1e-7, maxiter=200)

    # fd_grad evaluates at f64 points: the system stays f32
    def loss_b(bb):
        return jnp.sum(solve(A, bb.astype(jnp.float32), **kw)[0] ** 2)

    g = jax.grad(loss_b)(b)
    g_fd = fd_grad(loss_b, b, eps=1e-2)  # f32 forward: coarse FD step
    np.testing.assert_allclose(np.asarray(g), g_fd, rtol=2e-2, atol=1e-3)

    def loss_d(d):
        return jnp.sum(solve(A.with_data(d.astype(jnp.float32)), b,
                             **kw)[0] ** 2)

    gd = jax.grad(loss_d)(A.data)
    gd_fd = fd_grad(loss_d, A.data, eps=1e-2)
    np.testing.assert_allclose(np.asarray(gd), gd_fd, rtol=2e-2, atol=5e-3)


def test_router_f64_full_solve_and_grad_fd():
    """Full-precision f64 router CG (precision='full'): solves to f64
    tolerances, with implicit-diff gradients w.r.t. b and the DIA values
    finite-difference verified in f64."""
    from tpu_sparse import solve

    n = 24
    A = generators.tridiagonal(n)  # f64
    rng = np.random.default_rng(13)
    x_true = jnp.asarray(rng.standard_normal(n))
    b = A @ x_true
    kw = dict(method="cg", tol=1e-12, maxiter=400, precision="full")
    x, result = solve(A, b, **kw)
    assert x.dtype == jnp.float64
    assert result.converged
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-9, rel  # far past f32 (1e-7): f64 end to end
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-7, atol=1e-8)

    def loss_b(bb):
        return jnp.sum(solve(A, bb, **kw)[0] ** 2)

    g = jax.grad(loss_b)(b)
    g_fd = fd_grad(loss_b, b, eps=1e-5)
    np.testing.assert_allclose(np.asarray(g), g_fd, rtol=1e-5, atol=1e-6)

    def loss_d(d):
        return jnp.sum(solve(A.with_data(d), b, **kw)[0] ** 2)

    gd = jax.grad(loss_d)(A.data)
    gd_fd = fd_grad(loss_d, A.data, eps=1e-5)
    np.testing.assert_allclose(np.asarray(gd), gd_fd, rtol=1e-4, atol=1e-4)


def test_bicgstab_callable_explicit_transpose():
    """A matrix-free operator whose adjoint is supplied explicitly
    (A_transpose=; the reference's own contract: re-supply At,
    torch_sparse_linalg.py:1238-1248), here the CWELL gather SpMV of a
    nonsymmetric matrix and of its transpose. FD-checks grad of b."""
    import scipy.sparse as sp

    from tpu_sparse.autodiff import bicgstab_diff
    from tpu_sparse.kernels import reference as kref
    from tpu_sparse.sparse.convert import csr_from_arrays
    from tpu_sparse.sparse.cwell import csr_to_cwell

    n = 256
    rng = np.random.default_rng(7)
    T = sp.diags([np.full(n - 1, -1.0), np.full(n, 4.0),
                  np.full(n - 1, -2.0)], [-1, 0, 1], format="csr",
                 dtype=np.float32)
    Tt = T.T.tocsr()
    W = csr_to_cwell(csr_from_arrays(T.data, T.indices, T.indptr, (n, n)))
    Wt = csr_to_cwell(csr_from_arrays(Tt.data, Tt.indices, Tt.indptr,
                                      (n, n)))
    A_fn = lambda v: kref.cwell_spmv(W, v)    # noqa: E731
    At_fn = lambda v: kref.cwell_spmv(Wt, v)  # noqa: E731

    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    x, info, _, _ = bicgstab_diff(A_fn, b, tol=1e-6, A_transpose=At_fn)
    assert int(info) == 0
    np.testing.assert_allclose(T @ np.asarray(x), np.asarray(b),
                               rtol=1e-4, atol=1e-4)

    def loss(bb):
        return jnp.sum(bicgstab_diff(A_fn, bb, tol=1e-8,
                                     A_transpose=At_fn)[0] ** 2)

    g = jax.grad(loss)(b)
    e = jnp.zeros_like(b).at[3].set(1.0)
    h = 1e-2
    fd = (loss(b + h * e) - loss(b - h * e)) / (2 * h)
    np.testing.assert_allclose(float(g[3]), float(fd), rtol=2e-2)


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)
