"""Preconditioner tests: Jacobi and aggregation AMG.

AMG parity bar: preconditioned CG on Poisson must converge in far fewer
iterations than plain CG (the reference validates AMGX by residuals only,
test_module_b.py:283-289; we additionally assert the multigrid actually
accelerates)."""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_sparse.precond import (
    amg_preconditioner,
    amg_setup,
    amg_solve,
    diagonal,
    jacobi_preconditioner,
    v_cycle,
)
from tpu_sparse.solvers import cg_full
from tpu_sparse.sparse import generators
from tpu_sparse.sparse.convert import to_csr


def test_diagonal_extraction():
    A = generators.poisson2d(8)
    d = diagonal(A)
    np.testing.assert_allclose(np.asarray(d), 4.0)
    Acsr = to_csr(A)
    np.testing.assert_allclose(np.asarray(diagonal(Acsr)), 4.0)


def test_jacobi_accelerates_cg():
    A = generators.poisson2d(8)
    # scale rows to make Jacobi matter
    n = A.shape[0]
    scale = jnp.asarray(1.0 + 10.0 * np.random.default_rng(0).random(n))
    As = A.with_data(A.data * scale[None, :])  # row scaling breaks symmetry
    # keep it SPD: use symmetric diagonal scaling D A D
    # (row scale then col scale)
    import numpy as onp

    D = onp.diag(onp.asarray(scale) ** 0.5)
    Ad = D @ onp.asarray(A.todense()) @ D
    from tpu_sparse.sparse.convert import csr_to_dia, dense_to_csr

    As = csr_to_dia(dense_to_csr(Ad))
    b = jnp.asarray(np.random.default_rng(1).standard_normal(n))

    M = jacobi_preconditioner(As)
    x_p, info_p, it_p, _ = cg_full(As, b, tol=1e-10, M=M)
    x_n, info_n, it_n, _ = cg_full(As, b, tol=1e-10)
    assert int(info_p) == 0
    assert int(it_p) <= int(it_n)
    res = float(jnp.linalg.norm(b - As @ x_p) / jnp.linalg.norm(b))
    assert res < 1e-6


def test_amg_setup_hierarchy():
    A = generators.poisson2d(16)  # 256 dof
    hier = amg_setup(A, coarse_size=16)
    assert len(hier.levels) >= 1
    # coarsening must reduce size substantially (size-4 aggregates)
    n0 = hier.levels[0].A.shape[0]
    n1 = hier.levels[0].P.shape[1]
    assert n1 <= n0 // 2
    assert hier.coarse_inv.shape[0] <= 16 or len(hier.levels) == 49


def test_vcycle_reduces_residual():
    A = generators.poisson2d(16)
    n = A.shape[0]
    hier = amg_setup(A, coarse_size=16)
    b = jnp.asarray(np.random.default_rng(2).standard_normal(n))
    x = v_cycle(hier, b)
    r1 = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert r1 < 0.5  # one V-cycle kills most of the error


def test_amg_pcg_beats_plain_cg():
    A = generators.poisson2d(16)
    n = A.shape[0]
    b = jnp.asarray(np.random.default_rng(3).standard_normal(n))
    M = amg_preconditioner(A)
    x_p, info_p, it_p, _ = cg_full(A, b, tol=1e-8, M=M, maxiter=200)
    x_n, info_n, it_n, _ = cg_full(A, b, tol=1e-8, maxiter=2000)
    assert int(info_p) == 0
    assert int(it_p) < int(it_n)
    res = float(jnp.linalg.norm(b - A @ x_p) / jnp.linalg.norm(b))
    assert res < 1e-6


def test_amg_solve_api():
    A = generators.poisson2d(16)
    n = A.shape[0]
    b = jnp.asarray(np.random.default_rng(4).standard_normal(n))
    x, info, iters, res = amg_solve(A, b, tol=1e-8)
    assert int(info) == 0
    rr = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rr < 1e-6


def test_amg_precond_differentiable():
    """Gradients flow through an AMG-preconditioned solve (M has zero
    cotangent; x* is M-independent)."""
    A = generators.poisson2d(8)
    n = A.shape[0]
    b = jnp.asarray(np.random.default_rng(5).standard_normal(n))
    M = amg_preconditioner(A)
    from tpu_sparse.autodiff import cg_diff

    g = jax.grad(
        lambda bb: jnp.sum(cg_diff(A, bb, tol=1e-12, M=M)[0] ** 2))(b)
    Ad = np.asarray(A.todense())
    x = np.linalg.solve(Ad, np.asarray(b))
    expected = np.linalg.solve(Ad.T, 2 * x)
    np.testing.assert_allclose(np.asarray(g), expected, rtol=1e-5, atol=1e-7)


def test_chebyshev_smoother_amg():
    """Chebyshev-smoothed AMG must converge at least as fast as L1-Jacobi
    on Poisson (reduction-free smoother)."""
    from tpu_sparse.precond import amg_preconditioner
    from tpu_sparse.solvers import cg_full

    A = generators.poisson2d(16)
    n = A.shape[0]
    b = jnp.asarray(np.random.default_rng(7).standard_normal(n))
    M_j = amg_preconditioner(A, smoother="l1_jacobi")
    M_c = amg_preconditioner(A, smoother="chebyshev", pre_sweeps=2,
                             post_sweeps=2)
    xj, ij, itj, _ = cg_full(A, b, tol=1e-8, M=M_j, maxiter=200)
    xc, ic, itc, _ = cg_full(A, b, tol=1e-8, M=M_c, maxiter=200)
    assert int(ij) == 0 and int(ic) == 0
    assert int(itc) <= int(itj) + 5
    res = float(jnp.linalg.norm(b - A @ xc) / jnp.linalg.norm(b))
    assert res < 1e-6


def test_ilu0_exact_for_tridiagonal():
    """ILU(0) on a tridiagonal pattern IS the exact LU: M(v) = A^-1 v."""
    from tpu_sparse.precond import ilu0_preconditioner

    A = generators.tridiagonal(32)
    M = ilu0_preconditioner(A)
    v = jnp.asarray(np.random.default_rng(8).standard_normal(32))
    x = M(v)
    np.testing.assert_allclose(
        np.asarray(A @ x), np.asarray(v), rtol=1e-10, atol=1e-11)


def test_ilu0_accelerates_cg_poisson():
    from tpu_sparse.precond import ilu0_preconditioner
    from tpu_sparse.solvers import cg_full

    A = generators.poisson2d(12)
    n = A.shape[0]
    b = jnp.asarray(np.random.default_rng(9).standard_normal(n))
    M = ilu0_preconditioner(A)
    xp_, ip_, itp, _ = cg_full(A, b, tol=1e-8, M=M)
    xn_, in_, itn, _ = cg_full(A, b, tol=1e-8)
    assert int(ip_) == 0
    assert int(itp) < int(itn)
    res = float(jnp.linalg.norm(b - A @ xp_) / jnp.linalg.norm(b))
    assert res < 1e-6


def test_chebyshev_and_neumann_preconditioners():
    from tpu_sparse.precond import (
        chebyshev_preconditioner,
        neumann_preconditioner,
    )
    from tpu_sparse.solvers import cg_full

    A = generators.poisson2d(12)
    n = A.shape[0]
    b = jnp.asarray(np.random.default_rng(10).standard_normal(n))
    _, _, it_plain, _ = cg_full(A, b, tol=1e-8)
    for M in (chebyshev_preconditioner(A, degree=4),
              neumann_preconditioner(A, terms=3)):
        x, info, iters, _ = cg_full(A, b, tol=1e-8, M=M)
        assert int(info) == 0
        assert int(iters) < int(it_plain)


def test_smoothed_aggregation_pcg():
    """Jacobi-smoothed aggregation (SA) prolongators: converges, and the
    smoothed hierarchy needs no more PCG iterations than plain
    aggregation on an anisotropic diffusion problem (the case SA exists
    for)."""
    from tpu_sparse.precond.amg import amg_preconditioner
    from tpu_sparse.solvers import cg_full
    from tpu_sparse.sparse.convert import to_csr

    # anisotropic 2-D Poisson: -u_xx - eps*u_yy
    import scipy.sparse as sp

    nx = 16
    eps = 0.01
    Ix = sp.eye(nx)
    T = sp.diags([-1, 2, -1], [-1, 0, 1], shape=(nx, nx))
    A_sp = (sp.kron(Ix, T) + eps * sp.kron(T, Ix)).tocsr()
    from tpu_sparse.sparse.convert import csr_from_arrays

    A = csr_from_arrays(A_sp.data, A_sp.indices, A_sp.indptr, A_sp.shape)
    n = A.shape[0]
    b = jnp.asarray(np.random.default_rng(12).standard_normal(n))

    M_plain = amg_preconditioner(A, smoothed=False)
    M_sa = amg_preconditioner(A, smoothed=True)
    x_p, info_p, it_p, _ = cg_full(A, b, tol=1e-8, M=M_plain, maxiter=400)
    x_s, info_s, it_s, _ = cg_full(A, b, tol=1e-8, M=M_sa, maxiter=400)
    assert int(info_s) == 0
    assert int(it_s) <= int(it_p)
    res = float(jnp.linalg.norm(b - A @ x_s) / jnp.linalg.norm(b))
    assert res < 1e-6


def test_fsai_exact_on_dense_pattern():
    """On a fully dense SPD pattern the FSAI factor IS inv(chol(A))."""
    from tpu_sparse.precond import fsai_setup
    from tpu_sparse.sparse.convert import dense_to_csr

    rng = np.random.default_rng(0)
    n = 6
    Q = rng.standard_normal((n, n))
    Ad = Q @ Q.T + n * np.eye(n)
    G, Gt = fsai_setup(dense_to_csr(jnp.asarray(Ad)))
    Ginv = np.linalg.inv(np.linalg.cholesky(Ad))
    np.testing.assert_allclose(np.asarray(G.todense()), Ginv, atol=1e-6)
    np.testing.assert_allclose(np.asarray(Gt.todense()), Ginv.T, atol=1e-6)


def test_fsai_accelerates_cg_and_is_symmetric():
    from tpu_sparse.precond import fsai_preconditioner

    A = generators.poisson2d(48)
    n = A.shape[0]
    rng = np.random.default_rng(1)
    xt = rng.standard_normal(n).astype(np.float32)
    b = A @ jnp.asarray(xt)
    _, _, it_plain, _ = cg_full(A, b, tol=1e-6, maxiter=1000)
    Mf = fsai_preconditioner(A)
    x, info, it_fsai, _ = cg_full(A, b, tol=1e-6, maxiter=1000, M=Mf)
    assert int(info) == 0
    assert int(it_fsai) < 0.7 * int(it_plain), (int(it_fsai),
                                                int(it_plain))
    np.testing.assert_allclose(np.asarray(x), xt, rtol=1e-3, atol=1e-3)
    # FSAI(2): denser pattern must be at least as strong
    M2 = fsai_preconditioner(A, pattern_power=2)
    _, info2, it2, _ = cg_full(A, b, tol=1e-6, maxiter=1000, M=M2)
    assert int(info2) == 0 and int(it2) <= int(it_fsai)
    # M = GᵀG is symmetric (required for plain CG)
    u = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    v = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    s1 = float(jnp.vdot(u, Mf(v)))
    s2 = float(jnp.vdot(Mf(u), v))
    assert abs(s1 - s2) < 1e-3 * max(abs(s1), 1e-30)


def test_string_preconditioner_names_in_router():
    from tpu_sparse.api.solver import SparseSolver

    A = generators.poisson2d(24)
    n = A.shape[0]
    rng = np.random.default_rng(2)
    xt = rng.standard_normal(n).astype(np.float32)
    b = A @ jnp.asarray(xt)
    s = SparseSolver()
    iters = {}
    for name in ("jacobi", "fsai", "fsai2", "chebyshev", "neumann",
                 "ilu0", "amg"):
        x, r = s.solve(A, b, method="cg", tol=1e-6, M=name)
        assert r.converged, name
        np.testing.assert_allclose(np.asarray(x), xt, rtol=1e-3,
                                   atol=1e-3, err_msg=name)
        iters[name] = r.iterations
    assert iters["fsai"] < iters["jacobi"]
    # string M reaches the batched multi-RHS path too
    B = jnp.stack([b, 0.5 * b], axis=1)
    X, rB = s.solve(A, B, method="cg", tol=1e-6, M="fsai")
    assert rB.converged
    np.testing.assert_allclose(np.asarray(X[:, 0]), xt, rtol=1e-3,
                               atol=1e-3)
    with pytest.raises(ValueError, match="unknown preconditioner"):
        s.solve(A, b, method="cg", M="nope")
    with pytest.raises(ValueError, match="matrix-free"):
        s.solve(lambda v: v, b, method="cg", M="fsai")


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)
