"""BELL (block-ELL) container + kernel tests."""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_sparse.kernels import reference as kref
from tpu_sparse.kernels import spmm, spmv
from tpu_sparse.sparse import bsr_to_bell, csr_to_bsr, dense_to_csr


def make_block_matrix(rng, nb=6, bs=8, density=0.4):
    n = nb * bs
    mask = rng.random((nb, nb)) < density
    np.fill_diagonal(mask, True)
    A = np.zeros((n, n))
    for i in range(nb):
        for j in range(nb):
            if mask[i, j]:
                A[i*bs:(i+1)*bs, j*bs:(j+1)*bs] = rng.standard_normal((bs, bs))
    return A


def test_bell_roundtrip_and_spmv(rng):
    A = make_block_matrix(rng)
    n = A.shape[0]
    bsr = csr_to_bsr(dense_to_csr(A), 8)
    bell = bsr_to_bell(bsr)
    np.testing.assert_allclose(np.asarray(bell.todense()), A, atol=1e-13)

    x = rng.standard_normal(n)
    y = spmv(bell, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), A @ x, rtol=1e-12, atol=1e-12)
    # __matmul__
    np.testing.assert_allclose(np.asarray(bell @ jnp.asarray(x)), A @ x,
                               rtol=1e-12, atol=1e-12)


def test_bell_spmm(rng):
    A = make_block_matrix(rng)
    n = A.shape[0]
    bell = bsr_to_bell(csr_to_bsr(dense_to_csr(A), 8))
    B = rng.standard_normal((n, 5))
    Y = spmm(bell, jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(Y), A @ B, rtol=1e-12, atol=1e-12)


def test_bell_in_solver(rng):
    A = make_block_matrix(rng)
    n = A.shape[0]
    A = A + A.T + 2 * n * np.eye(n)  # SPD
    bell = bsr_to_bell(csr_to_bsr(dense_to_csr(A), 8))
    from tpu_sparse.solvers import cg

    x_true = rng.standard_normal(n)
    b = jnp.asarray(A @ x_true)
    x, info = cg(bell, b, tol=1e-12)
    assert int(info) == 0
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-8, atol=1e-9)


def test_bell_grad(rng):
    A = make_block_matrix(rng, nb=4, bs=8)
    n = A.shape[0]
    A = A + A.T + 2 * n * np.eye(n)
    bell = bsr_to_bell(csr_to_bsr(dense_to_csr(A), 8))
    x = jnp.asarray(rng.standard_normal(n))
    g = jax.grad(lambda blk: jnp.sum(
        spmv(bell.with_data(blk), x)))(bell.blocks)
    assert g.shape == bell.blocks.shape
    assert np.all(np.isfinite(np.asarray(g)))


@pytest.mark.parametrize("k", [130, 300])
def test_bell_spmm_wide_rhs(rng, k):
    """BELL SpMM through the dispatch for wide right-hand-side blocks
    (k not a multiple of 128) vs the dense oracle."""
    from tpu_sparse.kernels import spmm

    A = make_block_matrix(rng, nb=4, bs=8)
    n = A.shape[0]
    bell = bsr_to_bell(csr_to_bsr(dense_to_csr(A.astype(np.float32)), 8))
    B = rng.standard_normal((n, k)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(spmm(bell, jnp.asarray(B))),
                               A @ B, rtol=2e-4, atol=2e-4)


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)
