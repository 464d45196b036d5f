"""Batched (vmapped) solves and complex-dtype support."""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_sparse.solvers import (
    batch_bicgstab,
    batch_cg,
    batch_direct,
    bicgstab,
    cg,
    cg_differentiable,
    gmres,
)
from tpu_sparse.sparse import generators
from tpu_sparse.sparse.convert import dense_to_csr


def test_batch_cg():
    n, k = 64, 4
    A = generators.tridiagonal(n)
    rng = np.random.default_rng(0)
    X_true = jnp.asarray(rng.standard_normal((n, k)))
    B = jnp.stack([A @ X_true[:, j] for j in range(k)], axis=1)
    X, infos, iters, res = batch_cg(A, B, tol=1e-10)
    assert X.shape == (n, k)
    assert np.all(np.asarray(infos) == 0)
    np.testing.assert_allclose(np.asarray(X), np.asarray(X_true),
                               rtol=1e-6, atol=1e-8)


def test_batch_direct():
    n, k = 64, 3
    A = generators.tridiagonal(n)
    rng = np.random.default_rng(1)
    X_true = jnp.asarray(rng.standard_normal((n, k)))
    B = jnp.stack([A @ X_true[:, j] for j in range(k)], axis=1)
    X = batch_direct(A, B)
    np.testing.assert_allclose(np.asarray(X), np.asarray(X_true),
                               rtol=1e-8, atol=1e-10)


def test_legacy_differentiable_alias():
    n = 32
    A = generators.tridiagonal(n)
    b = jnp.asarray(np.random.default_rng(2).standard_normal(n))
    x, info = cg_differentiable(A, b, tol=1e-10)
    assert int(info) == 0
    g = jax.grad(lambda bb: jnp.sum(
        cg_differentiable(A, bb, tol=1e-12)[0] ** 2))(b)
    assert np.all(np.isfinite(np.asarray(g)))


def _hermitian_complex(n, seed=0):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = B @ B.conj().T + n * np.eye(n)
    return jnp.asarray(A)


def test_cg_complex_hermitian():
    """Complex128 support (reference DEFAULT_COMPLEX_DTYPE,
    torch_sparse_linalg.py:57-58)."""
    n = 24
    A = _hermitian_complex(n)
    rng = np.random.default_rng(3)
    x_true = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    b = A @ x_true
    x, info = cg(A, b, tol=1e-12)
    assert int(info) == 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-8, atol=1e-9)


def test_gmres_complex():
    n = 24
    rng = np.random.default_rng(4)
    Ad = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
          + 4 * n * np.eye(n))
    A = jnp.asarray(Ad)
    x_true = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    b = A @ x_true
    x, info = gmres(A, b, tol=1e-12, restart=24)
    assert int(info) == 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-7, atol=1e-8)


def test_bicgstab_complex_sparse():
    n = 32
    rng = np.random.default_rng(5)
    Ad = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    Ad[np.abs(Ad) < 1.0] = 0
    Ad += 4 * n * np.eye(n)
    A = dense_to_csr(Ad)
    x_true = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    b = A @ x_true
    x, info = bicgstab(A, b, tol=1e-12)
    assert int(info) == 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-7, atol=1e-8)


def test_minres_complex_hermitian():
    """MINRES on a hermitian indefinite complex system."""
    from tpu_sparse.solvers import minres_full

    rng = np.random.default_rng(60)
    n = 48
    Q = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (Q + Q.conj().T) / 2
    H = H - 0.5 * np.trace(H).real / n * np.eye(n)  # push eigs both signs
    eig = np.linalg.eigvalsh(H)
    assert eig.min() < 0 < eig.max()
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = jnp.asarray(H @ x_true)
    x, info, iters, res = minres_full(jnp.asarray(H), b, tol=1e-10,
                                      maxiter=2000)
    assert int(info) == 0, float(res)
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-6, atol=1e-7)


def test_block_cg_complex_hpd():
    """Block CG on a hermitian positive-definite complex system."""
    from tpu_sparse.solvers import block_cg

    rng = np.random.default_rng(61)
    n, k = 40, 3
    Q = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = Q @ Q.conj().T / n + 2 * np.eye(n)
    X_true = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    B = jnp.asarray(H @ X_true)
    X, infos, iters, res = block_cg(jnp.asarray(H), B, tol=1e-10)
    assert np.all(np.asarray(infos) == 0)
    np.testing.assert_allclose(np.asarray(X), X_true, rtol=1e-6, atol=1e-7)


def test_batch_solvers_jit_traced_matrix():
    """Round-2 regression: jitting a batch_* solver with the MATRIX as a
    traced argument. batch_safe_matvec used to close over the container's
    leaves, which custom_vmap tried (and failed) to lift as jaxpr
    constants ("No constant handler for DynamicJaxprTracer" — the
    BENCH_r02 block_cg_error). Leaves are explicit operands now."""
    import numpy as np

    from tpu_sparse.solvers import batch_gmres

    A = generators.poisson2d(12, dtype=np.float32)
    rng = np.random.default_rng(5)
    B = jnp.asarray(rng.standard_normal((A.shape[0], 3)).astype(np.float32))

    f = jax.jit(lambda a, bb: batch_cg(a, bb, tol=1e-5, maxiter=2000))
    X, infos, _, _ = f(A, B)
    assert int(jnp.all(infos == 0)) == 1
    rel = float(jnp.linalg.norm(B - A @ X) / jnp.linalg.norm(B))
    assert rel < 1e-4

    g = jax.jit(lambda a, bb: batch_gmres(a, bb, tol=1e-5, restart=30,
                                          maxiter=500))
    X2, infos2, _, _ = g(A, B)
    rel2 = float(jnp.linalg.norm(B - A @ X2) / jnp.linalg.norm(B))
    assert rel2 < 1e-4


def test_complex_spmv_matches_scipy():
    """Native complex SpMV through the dispatch (DIA and CWELL) agrees
    with scipy for complex A with complex x, real A with complex x, and
    complex A with real x."""
    import scipy.sparse as sp

    from tpu_sparse.kernels import spmv
    from tpu_sparse.sparse import generators
    from tpu_sparse.sparse.convert import to_csr
    from tpu_sparse.sparse.cwell import csr_to_cwell

    rng = np.random.default_rng(17)
    n = 96
    A = generators.tridiagonal(n)
    Ac = A.with_data(jnp.asarray(
        np.asarray(A.data) + 1j * rng.standard_normal(A.data.shape)))

    def scipy_of(M):
        C = to_csr(M)
        return sp.csr_matrix((np.asarray(C.data), np.asarray(C.indices),
                              np.asarray(C.indptr)), shape=C.shape)

    xc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    xr = rng.standard_normal(n)
    for Amat, x in ((Ac, xc), (A, xc), (Ac, xr)):
        y = spmv(Amat, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), scipy_of(Amat) @ x,
                                   rtol=1e-12, atol=1e-12)
    W = csr_to_cwell(to_csr(A))
    Wc = W.with_data(jnp.asarray(np.asarray(W.vals) * (1 + 0.5j)))
    np.testing.assert_allclose(np.asarray(spmv(Wc, jnp.asarray(xc))),
                               (1 + 0.5j) * (scipy_of(A) @ xc),
                               rtol=1e-12, atol=1e-12)


def test_complex_router_gmres_solve():
    """Complex systems solve natively through the router: the solution
    matches the manufactured one."""
    from tpu_sparse.api.solver import SparseSolver
    from tpu_sparse.kernels import reference as kref
    from tpu_sparse.sparse import generators

    rng = np.random.default_rng(31)
    A = generators.poisson2d(16, dtype=np.float32)
    Ac = A.with_data(jnp.asarray(
        (np.asarray(A.data) * (1 + 0.2j)).astype(np.complex64)))
    xt = jnp.asarray((rng.standard_normal(256)
                      + 1j * rng.standard_normal(256)).astype(np.complex64))
    b = kref.dia_spmv(Ac, xt)
    x, r = SparseSolver().solve(Ac, b, method="gmres", tol=1e-6,
                                maxiter=2000, restart=30)
    assert r.converged
    assert x.dtype == jnp.complex64
    true_rel = float(jnp.linalg.norm(kref.dia_spmv(Ac, x) - b)
                     / jnp.linalg.norm(b))
    assert true_rel < 1e-4, true_rel
    np.testing.assert_allclose(np.asarray(x), np.asarray(xt),
                               rtol=1e-3, atol=1e-3)


def test_complex_router_complex_A_real_b_and_dense_numpy():
    """A complex matrix with a REAL rhs gives a complex solution, and a
    dense NUMPY complex operand solves to the same answer."""
    from tpu_sparse.api.solver import SparseSolver
    from tpu_sparse.kernels import reference as kref
    from tpu_sparse.sparse import generators

    rng = np.random.default_rng(41)
    A = generators.poisson2d(12, dtype=np.float32)
    Ac = A.with_data(jnp.asarray(
        (np.asarray(A.data) * (1 + 0.3j)).astype(np.complex64)))
    b_real = jnp.asarray(rng.standard_normal(144).astype(np.float32))
    s = SparseSolver()
    x, r = s.solve(Ac, b_real, method="gmres", tol=1e-5, maxiter=2000,
                   restart=30)
    assert np.iscomplexobj(np.asarray(x))
    assert r.converged
    res = np.asarray(kref.dia_spmv(Ac, x)) - np.asarray(
        b_real).astype(np.complex64)
    assert float(np.linalg.norm(res) / np.linalg.norm(np.asarray(b_real))) \
        < 1e-4

    D = np.asarray(Ac.todense())
    x2, r2 = s.solve(D, b_real, method="gmres", tol=1e-5, maxiter=2000,
                     restart=30)
    assert r2.converged
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x),
                               rtol=1e-4, atol=1e-5)


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)


def test_complex_spmm():
    """Native complex SpMM through the dispatch matches scipy."""
    import scipy.sparse as sp

    from tpu_sparse.kernels import spmm
    from tpu_sparse.sparse.convert import to_csr

    k = 5
    rng = np.random.default_rng(5)
    Ac = to_csr(generators.poisson2d(12, dtype=np.float64))
    vals = np.asarray(Ac.data)
    cvals = (vals + 1j * rng.standard_normal(vals.shape)).astype(
        np.complex128)
    n = Ac.shape[0]
    A_sp = sp.csr_matrix((cvals, np.asarray(Ac.indices),
                          np.asarray(Ac.indptr)), shape=Ac.shape)
    B = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    C = np.asarray(spmm(Ac.with_data(jnp.asarray(cvals)), jnp.asarray(B)))
    C_true = A_sp @ B
    assert np.linalg.norm(C - C_true) / np.linalg.norm(C_true) < 1e-12


def test_complex_multirhs_router():
    """Complex (n, k) RHS through the router (native complex)."""
    from tpu_sparse import solve

    n, k = 64, 3
    rng = np.random.default_rng(6)
    A = generators.tridiagonal(n, dtype=np.float64)
    dense = np.zeros((n, n), np.complex128)
    import numpy as _np

    data = _np.asarray(A.data)
    diag = data[1] + 1j * 0.3
    Ad = (_np.diag(diag) + _np.diag(data[0][1:], -1)
          + _np.diag(data[2][:-1], 1))
    Xt = (rng.standard_normal((n, k))
          + 1j * rng.standard_normal((n, k)))
    B = Ad @ Xt
    X, res = solve(jnp.asarray(Ad), jnp.asarray(B), method="gmres",
                   tol=1e-8, restart=30)
    assert res.converged
    assert np.linalg.norm(np.asarray(X) - Xt) / np.linalg.norm(Xt) < 1e-4
