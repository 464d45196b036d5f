"""Deterministic test-matrix generators.

Parity target: utils/matrix_utils.py:143-257 in the reference
(`create_tridiagonal_sparse_coo`, `create_poisson_2d_sparse_coo`) plus the
north-star 27-point 3-D Poisson system from BASELINE.json and the
nonsymmetric convection-diffusion matrix used by the BiCGStab/GMRES tests.

All generators build on host in numpy and return both a DIA (stencil fast path)
and the information needed for CSR/COO via convert; matrices are returned as
DIA by default since every generated family is a stencil matrix.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tpu_sparse.sparse.containers import CSR, DIA
from tpu_sparse.sparse.convert import coo_to_csr, dia_from_offsets


def tridiagonal(n: int, main: float = 2.0, off: float = -1.0, dtype=np.float64) -> DIA:
    """Tridiagonal Toeplitz matrix (reference: matrix_utils.py:143-190)."""
    data = np.zeros((3, n), dtype=dtype)
    data[0, :] = off  # offset -1: A[i, i-1], valid for i >= 1
    data[1, :] = main
    data[2, :] = off  # offset +1: A[i, i+1], valid for i <= n-2
    data[0, 0] = 0.0
    data[2, n - 1] = 0.0
    return dia_from_offsets((-1, 0, 1), data, (n, n))


def poisson2d(nx: int, ny: int | None = None, dtype=np.float64) -> DIA:
    """2-D 5-point Poisson (Dirichlet), row-major grid ordering.

    Reference: matrix_utils.py:193-257. A[i,i]=4, neighbors -1, with the
    x-neighbor diagonals zeroed at grid-row boundaries.
    """
    if ny is None:
        ny = nx
    n = nx * ny
    data = np.zeros((5, n), dtype=dtype)
    i = np.arange(n)
    ix = i % nx
    data[2, :] = 4.0
    # offset -1 (west): invalid when ix == 0
    data[1, :] = np.where(ix > 0, -1.0, 0.0)
    # offset +1 (east): invalid when ix == nx-1
    data[3, :] = np.where(ix < nx - 1, -1.0, 0.0)
    # offset -nx (south): invalid for first grid row (handled by bounds)
    data[0, :] = -1.0
    data[0, :nx] = 0.0
    # offset +nx (north)
    data[4, :] = -1.0
    data[4, n - nx :] = 0.0
    return dia_from_offsets((-nx, -1, 0, 1, nx), data, (n, n))


def poisson3d_27pt(nx: int, ny: int | None = None, nz: int | None = None,
                   dtype=np.float32) -> DIA:
    """3-D 27-point Poisson-like stencil (north-star distributed target,
    BASELINE.json configs[4]). Diagonally dominant SPD:
    center 26, all 26 neighbors -1 (zeroed outside the grid)."""
    if ny is None:
        ny = nx
    if nz is None:
        nz = nx
    n = nx * ny * nz
    i = np.arange(n)
    ix = i % nx
    iy = (i // nx) % ny
    iz = i // (nx * ny)

    offsets = []
    masks = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0 and dz == 0:
                    continue
                offsets.append(dx + nx * dy + nx * ny * dz)
                ok = (
                    (ix + dx >= 0) & (ix + dx < nx)
                    & (iy + dy >= 0) & (iy + dy < ny)
                    & (iz + dz >= 0) & (iz + dz < nz)
                )
                masks.append(ok)
    # include the main diagonal, keep offsets sorted
    offsets.append(0)
    masks.append(np.ones(n, dtype=bool))
    order = np.argsort(offsets)
    ndiag = len(offsets)
    data = np.zeros((ndiag, n), dtype=dtype)
    out_offsets = []
    for d, k in enumerate(order):
        o = offsets[k]
        out_offsets.append(o)
        if o == 0:
            data[d, :] = 26.0
        else:
            data[d, :] = np.where(masks[k], -1.0, 0.0)
    return dia_from_offsets(out_offsets, data, (n, n))


def convection_diffusion(n: int, beta: float = 0.5, dtype=np.float64) -> DIA:
    """Nonsymmetric diagonally-dominant tridiagonal convection-diffusion
    operator (upwind), for BiCGStab/GMRES tests (reference
    test_module_a.py:126-195 uses a nonsymmetric diagonally dominant matrix)."""
    data = np.zeros((3, n), dtype=dtype)
    data[0, :] = -1.0 - beta  # sub-diagonal
    data[1, :] = 2.0 + 2.0 * beta + 1.0  # diagonal (shifted for dominance)
    data[2, :] = -1.0 + beta  # super-diagonal
    data[0, 0] = 0.0
    data[2, n - 1] = 0.0
    return dia_from_offsets((-1, 0, 1), data, (n, n))


def poisson2d_anisotropic(nx: int, eps: float = 100.0,
                          dtype=np.float64) -> DIA:
    """2-D 5-point Poisson with anisotropic coefficients: −u_xx − ε u_yy
    (x-coupling 1, y-coupling ε). The classic AMG showcase system (AMGX's
    own example matrices are of this family): plain CG degrades with the
    effective condition number while strength-based aggregation coarsens
    along the strong direction and stays O(1) in iterations."""
    n = nx * nx
    i = np.arange(n)
    ix = i % nx
    iy = i // nx
    data = np.zeros((5, n), dtype=dtype)
    # offsets sorted: -nx, -1, 0, 1, nx
    data[0] = np.where(iy > 0, -eps, 0.0)
    data[1] = np.where(ix > 0, -1.0, 0.0)
    data[2] = 2.0 + 2.0 * eps
    data[3] = np.where(ix < nx - 1, -1.0, 0.0)
    data[4] = np.where(iy < nx - 1, -eps, 0.0)
    return dia_from_offsets((-nx, -1, 0, 1, nx), data, (n, n))


def convection_diffusion_3d_27pt(nx: int, beta: float = 0.3,
                                 dtype=np.float32) -> DIA:
    """Nonsymmetric 3-D 27-point convection-diffusion: the 27-pt Poisson
    stencil with upwind-skewed ±x couplings (−(1+β) upstream, −(1−β)
    downstream). Row-sum diagonal dominance is preserved (off-diagonal
    magnitude sum stays 26 = center), so BiCGStab/GMRES converge without
    preconditioning — the at-scale nonsymmetric benchmark system
    (reference nonsymmetric coverage: test_module_a.py:126-195)."""
    A = poisson3d_27pt(nx, dtype=dtype)
    data = np.array(A.data)
    offs = list(A.offsets)
    data[offs.index(-1)] *= dtype(1.0 + beta)
    data[offs.index(1)] *= dtype(1.0 - beta)
    return dia_from_offsets(tuple(offs), data, A.shape)


def random_spd_dense(n: int, seed: int = 0, dtype=np.float64) -> jnp.ndarray:
    """Dense SPD matrix B Bᵀ + n·I (reference test_gpu_validation.py:72-76)."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n)).astype(dtype)
    A = B @ B.T + n * np.eye(n, dtype=dtype)
    return jnp.asarray(A)


def random_csr(n: int, m: int, density: float = 0.01, seed: int = 0,
               dtype=np.float64, dominant: bool = True) -> CSR:
    """Random sparse CSR with optional diagonal dominance."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(n * m * density))
    row = rng.integers(0, n, nnz).astype(np.int32)
    col = rng.integers(0, m, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(dtype)
    from tpu_sparse.sparse.containers import COO

    A = coo_to_csr(COO(jnp.asarray(vals), jnp.asarray(row), jnp.asarray(col), (n, m)))
    if dominant and n == m:
        dense = np.array(A.todense())  # np.asarray of a jax array is RO
        dense[np.arange(n), np.arange(n)] += np.abs(dense).sum(axis=1) + 1.0
        from tpu_sparse.sparse.convert import dense_to_csr

        return dense_to_csr(dense)
    return A
