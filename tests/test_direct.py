"""Direct solver tests — mirrors reference test_module_c.py: tridiagonal
direct solve with residual < 1e-10 (:141), small Poisson (:145-179),
autodiff w.r.t. b (:181-238)."""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_sparse.direct import (
    CR_MIN_N,
    banded_lu_solve,
    banded_solve,
    direct_solve,
    direct_solve_full_diff,
    thomas_solve,
)
from tpu_sparse.sparse import generators
from tpu_sparse.sparse.containers import DIA


def test_thomas_tridiagonal():
    n = 64
    A = generators.tridiagonal(n)
    rng = np.random.default_rng(0)
    x_true = jnp.asarray(rng.standard_normal(n))
    b = A @ x_true
    x = thomas_solve(A, b)
    # direct-solver accuracy bar (reference test_module_c.py:141)
    res = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert res < 1e-10
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-8, atol=1e-10)


def test_banded_lu_poisson2d():
    nx = 8
    A = generators.poisson2d(nx)  # bandwidth 8
    rng = np.random.default_rng(1)
    x_true = jnp.asarray(rng.standard_normal(nx * nx))
    b = A @ x_true
    x = banded_lu_solve(A, b)
    res = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert res < 1e-10
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-8, atol=1e-9)


def test_banded_vs_dense_oracle():
    n = 64
    A = generators.convection_diffusion(n)  # nonsymmetric banded
    rng = np.random.default_rng(2)
    b = jnp.asarray(rng.standard_normal(n))
    x = banded_solve(A, b)
    x_np = np.linalg.solve(np.asarray(A.todense()), np.asarray(b))
    np.testing.assert_allclose(np.asarray(x), x_np, rtol=1e-9, atol=1e-10)


def test_direct_dispatch_dense():
    rng = np.random.default_rng(3)
    Ad = generators.random_spd_dense(16, seed=3)
    b = jnp.asarray(rng.standard_normal(16))
    x = direct_solve(Ad, b)
    np.testing.assert_allclose(
        np.asarray(x), np.linalg.solve(np.asarray(Ad), np.asarray(b)),
        rtol=1e-9, atol=1e-10)


def test_direct_jit():
    A = generators.tridiagonal(64)
    b = jnp.asarray(np.random.default_rng(4).standard_normal(64))
    f = jax.jit(lambda a, rhs: direct_solve(a, rhs))
    x = f(A, b)
    res = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert res < 1e-10


def test_direct_grad_b():
    """Adjoint gradients through the direct solve (cudss_solver.py:78-173
    analogue), verified against dense linear algebra."""
    n = 16
    A = generators.convection_diffusion(n)
    Ad = np.asarray(A.todense())
    b = jnp.asarray(np.random.default_rng(5).standard_normal(n))

    g = jax.grad(
        lambda bb: jnp.sum(direct_solve_full_diff(A, bb)[0] ** 2))(b)
    x = np.linalg.solve(Ad, np.asarray(b))
    expected = np.linalg.solve(Ad.T, 2 * x)
    np.testing.assert_allclose(np.asarray(g), expected, rtol=1e-8, atol=1e-9)


def test_direct_grad_A_values():
    n = 16
    A = generators.tridiagonal(n)
    b = jnp.asarray(np.random.default_rng(6).standard_normal(n))

    def loss(d):
        x = direct_solve_full_diff(A.with_data(d), b)[0]
        return jnp.sum(x**2)

    g = jax.grad(loss)(A.data)
    eps = 1e-6
    dat = np.asarray(A.data)
    # spot-check a few FD entries
    for (di, i) in [(1, 5), (0, 3), (2, 7)]:
        dp = dat.copy(); dp[di, i] += eps
        dm = dat.copy(); dm[di, i] -= eps
        fd = (float(loss(jnp.asarray(dp))) - float(loss(jnp.asarray(dm)))) / (2 * eps)
        np.testing.assert_allclose(float(g[di, i]), fd, rtol=1e-4, atol=1e-6)


def test_pcr_matches_thomas():
    """Parallel cyclic reduction == Thomas on tridiagonal systems."""
    from tpu_sparse.direct import pcr_solve

    for n in (17, 64, 500):
        A = generators.tridiagonal(n)
        rng = np.random.default_rng(n)
        x_true = jnp.asarray(rng.standard_normal(n))
        b = A @ x_true
        x_pcr = pcr_solve(A, b)
        np.testing.assert_allclose(np.asarray(x_pcr), np.asarray(x_true),
                                   rtol=1e-9, atol=1e-10)


def test_pcr_nonsymmetric():
    from tpu_sparse.direct import pcr_solve

    A = generators.convection_diffusion(128)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(128))
    x = pcr_solve(A, b)
    x_np = np.linalg.solve(np.asarray(A.todense()), np.asarray(b))
    np.testing.assert_allclose(np.asarray(x), x_np, rtol=1e-9, atol=1e-10)


def test_host_splu_large_sparse():
    """General sparse systems beyond the densify limit go to the
    host-assisted SuperLU path, inside jit, with adjoint gradients."""
    from tpu_sparse.direct import direct_solve, direct_solve_full_diff
    from tpu_sparse.sparse import generators

    A = generators.random_csr(5000, 5000, density=0.001, seed=7)
    rng = np.random.default_rng(7)
    x_true = jnp.asarray(rng.standard_normal(5000))
    b = A @ x_true
    x = jax.jit(lambda a, rhs: direct_solve(a, rhs))(A, b)
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-10
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-7, atol=1e-8)

    g = jax.grad(lambda rhs: jnp.sum(
        direct_solve_full_diff(A, rhs)[0] ** 2))(b)
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.abs(g).max()) > 0


def test_block_pcr_poisson2d():
    from tpu_sparse.direct import block_pcr_solve

    nx = 12
    A = generators.poisson2d(nx)  # bandwidth nx
    rng = np.random.default_rng(7)
    x_true = jnp.asarray(rng.standard_normal(nx * nx))
    b = A @ x_true
    x = block_pcr_solve(A, b)
    res = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert res < 1e-10
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-8, atol=1e-9)


def test_block_pcr_matches_banded_lu():
    from tpu_sparse.direct import block_pcr_solve

    # nonsymmetric, diagonally dominant, odd size (exercises the identity
    # padding), non-power-of-two block count
    A = generators.convection_diffusion(97)
    rng = np.random.default_rng(8)
    b = jnp.asarray(rng.standard_normal(97))
    x = block_pcr_solve(A, b)
    x_lu = banded_lu_solve(A, b)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_lu),
                               rtol=1e-9, atol=1e-10)


def test_block_pcr_wide_band_f32():
    from tpu_sparse.direct import block_pcr_solve
    from tpu_sparse.sparse.containers import DIA

    # random diagonally-dominant band, bandwidth 5, f32, explicit block
    # size larger than the bandwidth
    n, w = 130, 5
    rng = np.random.default_rng(9)
    offs = list(range(-w, w + 1))
    rows = np.arange(n)
    data = np.zeros((len(offs), n), np.float32)
    for d, o in enumerate(offs):
        v = rng.standard_normal(n).astype(np.float32) * 0.1
        v[(rows + o < 0) | (rows + o >= n)] = 0.0
        if o == 0:
            v = v + 4.0
        data[d] = v
    A = DIA(jnp.asarray(data), offs, (n, n))
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    x = block_pcr_solve(A, b, block_size=8)
    assert x.dtype == jnp.float32
    x_np = np.linalg.solve(np.asarray(A.todense(), np.float64),
                           np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(x, np.float64), x_np,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n,kind", [
    (CR_MIN_N - 1, "thomas"), (CR_MIN_N, "pcr"),
])
def test_banded_solve_tridiagonal_threshold(n, kind, monkeypatch):
    """Tridiagonal systems switch from the Thomas scan to parallel cyclic
    reduction (plus one refinement step) at CR_MIN_N rows; both sides
    solve correctly."""
    import tpu_sparse.direct as d

    called = []
    for name in ("thomas_solve", "pcr_solve"):
        fn = getattr(d, name)
        monkeypatch.setattr(d, name, lambda A, b, _f=fn, _n=name: (
            called.append(_n), _f(A, b))[1])
    A = generators.tridiagonal(n)
    xt = np.random.default_rng(n).standard_normal(n)
    x = d.banded_solve(A, A @ jnp.asarray(xt))
    assert set(called) == {f"{kind}_solve"}
    np.testing.assert_allclose(np.asarray(x), xt, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("n,kind", [
    (CR_MIN_N - 1, "banded_lu"), (CR_MIN_N, "block_pcr"),
])
def test_banded_solve_wide_band_threshold(n, kind, monkeypatch):
    """Wider bands switch from the banded-LU scan to block cyclic
    reduction at CR_MIN_N rows; both sides solve correctly."""
    import tpu_sparse.direct as d

    called = []
    for name in ("banded_lu_solve", "block_pcr_solve"):
        fn = getattr(d, name)
        monkeypatch.setattr(d, name, lambda A, b, _f=fn, _n=name: (
            called.append(_n), _f(A, b))[1])
    rng = np.random.default_rng(n)
    offs = (-3, -1, 0, 2, 3)
    data = rng.standard_normal((len(offs), n))
    data[offs.index(0)] = 12.0  # diagonally dominant
    A = DIA(jnp.asarray(data), offs, (n, n))
    xt = rng.standard_normal(n)
    Ad = np.asarray(A.todense())
    x = d.banded_solve(A, jnp.asarray(Ad @ xt))
    assert set(called) == {f"{kind}_solve"}
    np.testing.assert_allclose(np.asarray(x), xt, rtol=1e-9, atol=1e-9)


class TestSparseLU:
    """Jit-composable general sparse direct solve (direct/sparse_lu.py):
    host SuperLU factorization at setup, exact on-device triangular solves
    via the nilpotent fixed-point iteration. Capability parity with the
    reference's compiled-graph spsolve (cudss_solver.py:107,176-252)."""

    def _general_matrix(self, n_grid=20, density=0.002, seed=1):
        import scipy.sparse as sp

        from tpu_sparse.sparse.convert import csr_from_arrays, to_csr

        A = to_csr(generators.poisson2d(n_grid))
        n = A.shape[0]
        Asp = sp.csr_matrix((np.asarray(A.data), np.asarray(A.indices),
                             np.asarray(A.indptr)), shape=A.shape)
        Asp = (Asp + sp.random(n, n, density=density,
                               random_state=seed, format="csr")).tocsr()
        return Asp, csr_from_arrays(Asp.data, Asp.indices, Asp.indptr,
                                    Asp.shape)

    def test_solve_exact_and_jit_composable(self):
        from tpu_sparse.direct import SparseLU

        Asp, Ac = self._general_matrix()
        n = Ac.shape[0]
        lu = SparseLU.factor(Ac)
        xt = np.random.default_rng(0).standard_normal(n)
        b = jnp.asarray(Asp @ xt)
        np.testing.assert_allclose(np.asarray(lu.solve(b)), xt,
                                   rtol=1e-10, atol=1e-10)
        # the factors are a pytree: solve composes with jit as an argument
        xj = jax.jit(lambda l, bb: l.solve(bb))(lu, b)
        np.testing.assert_allclose(np.asarray(xj), xt, rtol=1e-10,
                                   atol=1e-10)
        # transpose solve (the adjoint pass) uses the same factors
        bt = jnp.asarray(Asp.T @ xt)
        np.testing.assert_allclose(np.asarray(lu.solve_transpose(bt)), xt,
                                   rtol=1e-10, atol=1e-10)
        # multi-RHS
        B = jnp.stack([b, 2 * b], axis=1)
        XB = lu.solve(B)
        np.testing.assert_allclose(np.asarray(XB[:, 1]), 2 * xt,
                                   rtol=1e-9, atol=1e-9)

    def test_gradient_one_adjoint_solve(self):
        import scipy.sparse.linalg as spl

        from tpu_sparse.direct import SparseLU, sparse_lu_solve_diff

        Asp, Ac = self._general_matrix(n_grid=12)
        n = Ac.shape[0]
        lu = SparseLU.factor(Ac)
        b = jnp.asarray(np.random.default_rng(2).standard_normal(n))
        g = jax.grad(
            lambda bb: jnp.sum(sparse_lu_solve_diff(lu, bb)))(b)
        gref = spl.splu(Asp.tocsc()).solve(np.ones(n), trans="T")
        np.testing.assert_allclose(np.asarray(g), gref, rtol=1e-9,
                                   atol=1e-9)

    def test_router_general_direct_uses_host_superlu(self):
        """Past the densify limit the router's general direct solve runs
        host SuperLU inside the compiled program (pure_callback)."""
        from tpu_sparse.api.solver import SparseSolver
        from tpu_sparse.direct import _DENSE_DIRECT_LIMIT, needs_host_splu

        Asp, Ac = self._general_matrix(n_grid=72)
        n = Ac.shape[0]
        assert n > _DENSE_DIRECT_LIMIT and needs_host_splu(Ac)
        xt = np.random.default_rng(3).standard_normal(n)
        b = jnp.asarray(Asp @ xt)
        x, r = SparseSolver().solve(Ac, b, method="direct")
        assert r.converged
        np.testing.assert_allclose(np.asarray(x), xt, rtol=1e-9,
                                   atol=1e-9)
        assert r.residual < 1e-10


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)
