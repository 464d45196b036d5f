"""Level-scheduled supernodal sparse LU (direct/supernodal.py).

Covers the cuDSS capability class the reference reaches through
torch.sparse.spsolve (cudss_solver.py:176-252): general CSR systems,
transpose solves, jit composition, multi-RHS, and the one-adjoint-solve
differentiation contract (cudss_solver.py:115-148).
"""

import os as _os
import sys as _sys

if __name__ == "__main__":
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from tpu_sparse.direct.supernodal import (SupernodalLU, supernodal_solve,
                                          supernodal_solve_diff)
from tpu_sparse.sparse import generators
from tpu_sparse.sparse.convert import to_csr


def _scipy_of(Ac):
    return sp.csr_matrix((np.asarray(Ac.data), np.asarray(Ac.indices),
                          np.asarray(Ac.indptr)), shape=Ac.shape)


def _mk(name):
    if name == "poisson2d":
        return to_csr(generators.poisson2d(48, dtype=np.float32))
    if name == "poisson3d":
        return to_csr(generators.poisson3d_27pt(12, dtype=np.float32))
    if name == "nonsym":
        # convection-diffusion: strongly nonsymmetric
        return to_csr(generators.convection_diffusion_3d_27pt(10, beta=0.4, dtype=np.float32))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["poisson2d", "poisson3d", "nonsym"])
def test_solve_matches_truth(name):
    Ac = _mk(name)
    A_sp = _scipy_of(Ac)
    n = Ac.shape[0]
    rng = np.random.default_rng(3)
    xt = rng.standard_normal(n).astype(np.float32)
    b = (A_sp @ xt).astype(np.float32)
    lu = SupernodalLU.factor(Ac)
    x = np.asarray(lu.solve(jnp.asarray(b)))
    assert np.linalg.norm(x - xt) / np.linalg.norm(xt) < 5e-4
    # transpose solve
    bT = (A_sp.T @ xt).astype(np.float32)
    xT = np.asarray(lu.solve_transpose(jnp.asarray(bT)))
    assert np.linalg.norm(xT - xt) / np.linalg.norm(xt) < 5e-4


def test_jit_and_multirhs():
    Ac = _mk("poisson2d")
    A_sp = _scipy_of(Ac)
    n = Ac.shape[0]
    rng = np.random.default_rng(0)
    Xt = rng.standard_normal((n, 3)).astype(np.float32)
    B = (A_sp @ Xt).astype(np.float32)
    lu = SupernodalLU.factor(Ac)
    # factors ride through jit as pytree arguments
    X = jax.jit(lambda l, bb: l.solve(bb))(lu, jnp.asarray(B))
    assert np.linalg.norm(np.asarray(X) - Xt) / np.linalg.norm(Xt) < 5e-4
    # functional alias
    x0 = supernodal_solve(lu, jnp.asarray(B[:, 0]))
    np.testing.assert_allclose(np.asarray(x0), np.asarray(X[:, 0]),
                               rtol=1e-4, atol=1e-5)


def test_level_schedule_structure():
    """Levels are ~tree height, not ~block count (the point of ND +
    aligned packing), and every level pack fits the CWELL pack limits
    (no CSR fallback level)."""
    from tpu_sparse.sparse.containers import CSR

    Ac = to_csr(generators.poisson2d(96, dtype=np.float32))
    lu = SupernodalLU.factor(Ac)
    B = lu.n_pad // lu.block
    assert lu.n_levels < B / 2, (lu.n_levels, B)
    packs = [N for level in (*lu.packsL, *lu.packsU, *lu.packsLT,
                             *lu.packsUT) if level is not None
             for N in level if N is not None]
    assert packs and not any(isinstance(N, CSR) for N in packs)


def test_gradient_contract():
    """d/db through supernodal_solve_diff is one adjoint solve: matches
    finite differences (reference contract cudss_solver.py:115-148)."""
    Ac = _mk("nonsym")
    A_sp = _scipy_of(Ac)
    n = Ac.shape[0]
    rng = np.random.default_rng(1)
    b = rng.standard_normal(n).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32)
    lu = SupernodalLU.factor(Ac)

    def loss(bb):
        return jnp.vdot(w, supernodal_solve_diff(lu, bb))

    g = np.asarray(jax.grad(loss)(jnp.asarray(b)))
    # analytic: grad_b = A^-T w
    g_true = sp.linalg.spsolve(sp.csc_matrix(A_sp.T.astype(np.float64)),
                               w.astype(np.float64))
    assert np.linalg.norm(g - g_true) / np.linalg.norm(g_true) < 1e-3


def test_singular_matrix_raises():
    data = np.array([1.0, 0.0], dtype=np.float32)
    indices = np.array([0, 1], dtype=np.int32)
    indptr = np.array([0, 1, 2], dtype=np.int32)
    from tpu_sparse.sparse.convert import csr_from_arrays

    Ac = csr_from_arrays(data, indices, indptr, (2, 2))
    with pytest.raises(Exception):
        SupernodalLU.factor(Ac)


def test_with_transpose_false():
    Ac = _mk("poisson2d")
    lu = SupernodalLU.factor(Ac, with_transpose=False)
    b = np.ones(Ac.shape[0], np.float32)
    x = lu.solve(jnp.asarray(b))
    assert np.all(np.isfinite(np.asarray(x)))
    with pytest.raises(ValueError):
        lu.solve_transpose(jnp.asarray(b))


if __name__ == "__main__":
    from _standalone import run_standalone

    run_standalone(__file__)
