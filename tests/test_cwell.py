"""CWELL (column-window ELL) general-format tests: packing correctness vs
the CSR oracle, and the library SpMV/SpMM dispatch (kernels.spmv /
kernels.spmm) against scipy. The general-structure SpMV capability row of
SURVEY.md §2.2 (reference: torch.sparse/cuSPARSE, solver.py:365)."""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_sparse.kernels import reference as ref
from tpu_sparse.kernels import spmm, spmv
from tpu_sparse.sparse import generators
from tpu_sparse.sparse.convert import dense_to_csr, to_csr
from tpu_sparse.sparse.cwell import CWELL, csr_to_cwell, rcm_permutation


def _random_csr(n, m, density, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = (rng.random((n, m)) < density) * rng.standard_normal((n, m))
    return dense_to_csr(A.astype(dtype)), A.astype(dtype)


def _scipy(A):
    """Host scipy CSR (f64) of a library CSR: the independent oracle."""
    import scipy.sparse as sp

    return sp.csr_matrix((np.asarray(A.data, dtype=np.float64),
                          np.asarray(A.indices), np.asarray(A.indptr)),
                         shape=A.shape)


def _assert_close(y, y_ref, rel):
    """max|y - y_ref| / max|y_ref| <= rel."""
    y = np.asarray(y, dtype=np.float64)
    err = np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1e-300)
    assert err <= rel, err


@pytest.mark.parametrize("n,m,density", [
    (50, 50, 0.1), (200, 130, 0.05), (128, 128, 0.3), (300, 520, 0.02),
])
def test_cwell_pack_roundtrip(n, m, density):
    A, Ad = _random_csr(n, m, density, seed=n + m)
    W = csr_to_cwell(A)
    np.testing.assert_allclose(np.asarray(W.todense()), Ad,
                               rtol=1e-6, atol=1e-6)
    assert W.nnz == A.nnz
    assert 0.0 < W.fill <= 1.0


def test_cwell_spmv_reference_matches_csr():
    A, Ad = _random_csr(257, 190, 0.08, seed=3)
    W = csr_to_cwell(A)
    x = jnp.asarray(
        np.random.default_rng(4).standard_normal(190).astype(np.float32))
    y_csr = ref.csr_spmv(A, x)
    y_w = ref.cwell_spmv(W, x)
    np.testing.assert_allclose(np.asarray(y_w), np.asarray(y_csr),
                               rtol=1e-5, atol=1e-5)


def test_cwell_spmm_reference():
    A, Ad = _random_csr(100, 80, 0.1, seed=5)
    W = csr_to_cwell(A)
    B = jnp.asarray(
        np.random.default_rng(6).standard_normal((80, 7)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(ref.cwell_spmm(W, B)),
                               Ad @ np.asarray(B), rtol=1e-4, atol=1e-4)


def test_cwell_stencil_fill():
    # locality-heavy matrix: fill must be decent (>0.4), proving the
    # window/plane assignment exploits column locality
    A = to_csr(generators.poisson2d(32))
    W = csr_to_cwell(A)
    assert W.fill > 0.4, W.fill
    x = jnp.asarray(np.random.default_rng(7).standard_normal(1024))
    np.testing.assert_allclose(np.asarray(ref.cwell_spmv(W, x)),
                               np.asarray(ref.csr_spmv(A, x)),
                               rtol=1e-10, atol=1e-10)


def test_cwell_spmv_random():
    A, Ad = _random_csr(300, 300, 0.05, seed=8)
    W = csr_to_cwell(A)
    x = np.random.default_rng(9).standard_normal(300).astype(np.float32)
    _assert_close(spmv(W, jnp.asarray(x)), _scipy(A) @ x, 1e-5)


def test_cwell_spmv_stencil():
    A = to_csr(generators.poisson3d_27pt(8, dtype=np.float32))
    W = csr_to_cwell(A)
    x = np.random.default_rng(10).standard_normal(512).astype(np.float32)
    _assert_close(spmv(W, jnp.asarray(x)), _scipy(A) @ x, 1e-5)


def test_cwell_spmv_f64():
    """f64 general structure: native f64 arithmetic, round-off only."""
    A = to_csr(generators.poisson3d_27pt(8, dtype=np.float64))
    W = csr_to_cwell(A)
    assert W.vals.dtype == jnp.float64
    x = np.random.default_rng(12).standard_normal(512)
    y = spmv(W, jnp.asarray(x))
    assert y.dtype == jnp.float64
    _assert_close(y, _scipy(A) @ x, 1e-13)


def test_cwell_transpose():
    A, Ad = _random_csr(90, 60, 0.1, seed=11)
    W = csr_to_cwell(A)
    np.testing.assert_allclose(np.asarray(W.T.todense()), Ad.T,
                               rtol=1e-6, atol=1e-6)


def test_cwell_empty_and_tiny():
    A = dense_to_csr(np.zeros((5, 5), np.float32))
    W = csr_to_cwell(A)
    x = jnp.ones(5, jnp.float32)
    np.testing.assert_allclose(np.asarray(ref.cwell_spmv(W, x)),
                               np.zeros(5), atol=0)


def test_rcm_improves_fill():
    # random permutation destroys locality; RCM restores it
    # big enough that column scatter spans many 256-wide windows
    rng = np.random.default_rng(12)
    A = to_csr(generators.poisson2d(48))  # n=2304
    n = A.shape[0]
    perm = rng.permutation(n)
    Ad = np.asarray(A.todense())[np.ix_(perm, perm)]
    Ap = dense_to_csr(Ad)
    fill_scrambled = csr_to_cwell(Ap).fill
    p = rcm_permutation(Ap)
    Ar = dense_to_csr(Ad[np.ix_(p, p)])
    fill_rcm = csr_to_cwell(Ar).fill
    assert fill_rcm > 2 * fill_scrambled, (fill_scrambled, fill_rcm)


def test_cwell_in_cg():
    from tpu_sparse.solvers.krylov import cg_full

    A = to_csr(generators.poisson2d(16, dtype=np.float32))
    W = csr_to_cwell(A)
    rng = np.random.default_rng(13)
    x_true = jnp.asarray(rng.standard_normal(256).astype(np.float32))
    b = spmv(W, x_true)
    x, info, iters, res = cg_full(W, b, tol=1e-6)
    assert int(info) == 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-3, atol=1e-3)


def test_cwell_spmm_random():
    A, _ = _random_csr(300, 260, 0.08, seed=13)
    W = csr_to_cwell(A)
    B = np.random.default_rng(13).standard_normal((260, 5)).astype(np.float32)
    Y = spmm(W, jnp.asarray(B))
    assert Y.shape == (300, 5)
    _assert_close(Y, _scipy(A) @ B, 1e-5)


def test_cwell_spmm_stencil_wide_rhs():
    A = to_csr(generators.poisson3d_27pt(8, dtype=np.float32))
    W = csr_to_cwell(A)
    B = np.random.default_rng(14).standard_normal((512, 17)).astype(np.float32)
    _assert_close(spmm(W, jnp.asarray(B)), _scipy(A) @ B, 1e-5)


def test_cwell_spmm_across_group_quanta():
    """SpMM agrees with scipy for every group quantum of the pack."""
    A = to_csr(generators.poisson2d(20, dtype=np.float32))
    B = np.random.default_rng(15).standard_normal((400, 20)).astype(np.float32)
    for Q in (1, 2, 4):
        W = csr_to_cwell(A, group=Q)
        _assert_close(spmm(W, jnp.asarray(B)), _scipy(A) @ B, 1e-5)


def test_cwell_spmv_bf16_values():
    A = to_csr(generators.poisson3d_27pt(8, dtype=np.float32))
    Wb = csr_to_cwell(A)
    Wb = Wb.with_data(Wb.vals.astype(jnp.bfloat16))
    x = np.random.default_rng(15).standard_normal(512).astype(np.float32)
    y = spmv(Wb, jnp.asarray(x))
    # the product is taken in bf16 (the values' dtype): its error bound
    # is bf16 round-off of 27-term sums
    _assert_close(y, _scipy(A) @ x, 3e-2)


def test_cwellseg_spmv_matches_oracle():
    """Column-segmented CWELL for wide m."""
    from tpu_sparse.sparse.cwell import CWELLSeg, csr_to_cwell_segments

    A, Ad = _random_csr(600, 1500, 0.02, seed=16)
    W = csr_to_cwell_segments(A, seg_cols=512)
    assert isinstance(W, CWELLSeg)
    assert len(W.segments) == 3
    assert W.nnz == A.nnz
    x = jnp.asarray(np.random.default_rng(16).standard_normal(1500)
                    .astype(np.float32))
    y = spmv(W, x)
    np.testing.assert_allclose(np.asarray(y), Ad @ np.asarray(x),
                               rtol=1e-4, atol=1e-4)
    # SpMM, transpose, and CSR round trip
    B = jnp.asarray(np.random.default_rng(17).standard_normal((1500, 4))
                    .astype(np.float32))
    Y = W @ B
    np.testing.assert_allclose(np.asarray(Y), Ad @ np.asarray(B),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(W.tocsr().todense()), Ad,
                               rtol=1e-6, atol=1e-6)
    xt = jnp.asarray(np.random.default_rng(18).standard_normal(600)
                     .astype(np.float32))
    yt = spmv(W.T, xt)
    np.testing.assert_allclose(np.asarray(yt), Ad.T @ np.asarray(xt),
                               rtol=1e-4, atol=1e-4)


def test_cwellseg_solver_and_grad():
    """CWELLSeg through CG + the implicit-diff adjoint."""
    from tpu_sparse.autodiff import cg_diff
    from tpu_sparse.sparse.convert import to_csr
    from tpu_sparse.sparse.cwell import csr_to_cwell_segments

    A = to_csr(generators.poisson2d(22))  # n=484
    W = csr_to_cwell_segments(A, seg_cols=256)
    assert len(W.segments) > 1
    rng = np.random.default_rng(19)
    b = jnp.asarray(rng.standard_normal(484))

    x, info, iters, res = cg_diff(W, b, tol=1e-10)
    assert int(info) == 0

    def loss(bb):
        return jnp.sum(cg_diff(W, bb, tol=1e-12)[0] ** 2)

    g = jax.grad(loss)(b)
    e = jnp.zeros_like(b).at[3].set(1.0)
    h = 1e-6
    fd = (loss(b + h * e) - loss(b - h * e)) / (2 * h)
    np.testing.assert_allclose(float(g[3]), float(fd), rtol=1e-4)


def test_to_tpu_operator_promotes_wide_to_segments():
    from tpu_sparse.sparse.cwell import CWELLSeg
    from tpu_sparse.sparse.optimize import to_tpu_operator
    import scipy.sparse as sp
    from tpu_sparse.sparse.convert import csr_from_arrays

    # wide banded-random matrix, m > the 1.5M cap, tiny density so the
    # host pack stays fast
    n = 512
    m = 1_600_000
    rng = np.random.default_rng(20)
    rows = np.repeat(np.arange(n), 16)
    # column locality per 128-row block (CWELL's packing requirement):
    # each block's rows draw from the same ~1K-column neighborhood
    cols = ((rows // 128) * 400_000 + rng.integers(0, 1024,
                                                   rows.size)) % m
    Asp = sp.coo_matrix((np.ones(rows.size, np.float32),
                         (rows, cols)), shape=(n, m)).tocsr()
    A = csr_from_arrays(Asp.data, Asp.indices, Asp.indptr, (n, m))
    W = to_tpu_operator(A)
    assert isinstance(W, CWELLSeg)
    x = jnp.asarray(rng.standard_normal(m).astype(np.float32))
    y = spmv(W, x)
    y_ref = Asp @ np.asarray(x)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# grouped-plane pack: each aligned run of Q planes shares one window row.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Q", [2, 4, 8])
@pytest.mark.parametrize("n,m,density", [
    (50, 50, 0.1), (200, 130, 0.05), (300, 520, 0.02),
])
def test_cwell_grouped_pack_roundtrip(n, m, density, Q):
    A, Ad = _random_csr(n, m, density, seed=n + m)
    W = csr_to_cwell(A, group=Q)
    assert W.grouped and W.group == Q
    np.testing.assert_allclose(np.asarray(W.todense()), Ad,
                               rtol=1e-6, atol=1e-6)
    assert W.nnz == A.nnz


@pytest.mark.parametrize("Q", [2, 4, 8])
def test_cwell_grouped_srow_uniform_within_runs(Q):
    """The grouped pack's invariant: srow is constant within every
    aligned run of Q planes."""
    A = to_csr(generators.poisson3d_27pt(8, dtype=np.float32))
    W = csr_to_cwell(A, group=Q)
    srow = np.asarray(W.srow)
    vals = np.asarray(W.vals)
    nb, S = srow.shape
    assert S % 8 == 0
    sg = srow.reshape(nb, S // Q, Q)
    vg = vals.reshape(nb, S // Q, Q, 128)
    # within a run, every USED plane (any nonzero val) must carry the
    # run's first-plane srow; padding planes are free but in-bounds
    used = (vg != 0).any(axis=3)
    first = sg[:, :, :1]
    assert np.all(np.where(used, sg == first, True))


@pytest.mark.parametrize("Q", [2, 4, 8])
def test_cwell_grouped_spmv_random(Q):
    A, _ = _random_csr(300, 300, 0.05, seed=8)
    W = csr_to_cwell(A, group=Q)
    x = np.random.default_rng(9).standard_normal(300).astype(np.float32)
    _assert_close(spmv(W, jnp.asarray(x)), _scipy(A) @ x, 1e-5)


@pytest.mark.parametrize("Q", [2, 8])
def test_cwell_grouped_spmv_stencil(Q):
    A = to_csr(generators.poisson3d_27pt(8, dtype=np.float32))
    W = csr_to_cwell(A, group=Q)
    x = np.random.default_rng(10).standard_normal(512).astype(np.float32)
    _assert_close(spmv(W, jnp.asarray(x)), _scipy(A) @ x, 1e-5)


@pytest.mark.parametrize("Q", [2, 4, 8])
def test_cwell_grouped_spmv_f64(Q):
    A = to_csr(generators.poisson3d_27pt(8, dtype=np.float64))
    W = csr_to_cwell(A, group=Q)
    x = np.random.default_rng(12).standard_normal(512)
    y = spmv(W, jnp.asarray(x))
    assert y.dtype == jnp.float64
    _assert_close(y, _scipy(A) @ x, 1e-13)


def test_cwell_grouped_fill_inflation():
    """Plane inflation per quantum on the 27-pt system: Q=2 stays within
    ~1.2x of the ungrouped pack."""
    A = to_csr(generators.poisson3d_27pt(12, dtype=np.float32))
    W = csr_to_cwell(A)
    S1 = W.planes
    W2 = csr_to_cwell(A, group=2)
    assert W2.planes % 8 == 0
    assert W2.planes / S1 <= 1.25, (S1, W2.planes)


def test_cwell_grouped_pack_fuzz():
    """Property fuzz across shapes/densities/quanta: pack -> CSR
    roundtrip equality and oracle SpMV agreement (catches window/run
    boundary edge cases: m < 256, empty row blocks, single window,
    ragged tails)."""
    rng = np.random.default_rng(99)
    for trial in range(16):
        n = int(rng.integers(1, 400))
        m = int(rng.integers(1, 600))
        density = float(rng.uniform(0.01, 0.4))
        Q = int(rng.choice([1, 2, 4, 8]))
        Ad = ((rng.random((n, m)) < density)
              * rng.standard_normal((n, m))).astype(np.float32)
        W = csr_to_cwell(dense_to_csr(Ad), group=Q)
        np.testing.assert_allclose(
            np.asarray(W.todense()), Ad, rtol=1e-6, atol=1e-6,
            err_msg=f"trial={trial} n={n} m={m} Q={Q}")
        x = rng.standard_normal(m).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(ref.cwell_spmv(W, jnp.asarray(x))), Ad @ x,
            rtol=2e-4, atol=2e-4, err_msg=f"trial={trial} Q={Q}")


@pytest.mark.parametrize("Q", [2, 4, 8])
def test_cwell_grouped_spmm_random(Q):
    A, _ = _random_csr(300, 260, 0.08, seed=13)
    W = csr_to_cwell(A, group=Q)
    B = np.random.default_rng(13).standard_normal((260, 5)).astype(np.float32)
    _assert_close(spmm(W, jnp.asarray(B)), _scipy(A) @ B, 1e-5)


def test_cwell_grouped_spmm_stencil_wide_rhs():
    A = to_csr(generators.poisson3d_27pt(8, dtype=np.float32))
    W = csr_to_cwell(A, group=4)
    B = np.random.default_rng(14).standard_normal((512, 17)).astype(np.float32)
    _assert_close(spmm(W, jnp.asarray(B)), _scipy(A) @ B, 1e-5)


@pytest.mark.parametrize("k", [150, 256])
def test_cwell_spmm_wide_k(k):
    """Wide right-hand-side blocks (k in the hundreds) through spmm."""
    rng = np.random.default_rng(5)
    n = 512
    Ad = ((rng.random((n, n)) < 0.05)
          * rng.standard_normal((n, n))).astype(np.float32)
    A = dense_to_csr(Ad)
    W = csr_to_cwell(A, group=2)
    B = rng.standard_normal((n, k)).astype(np.float32)
    _assert_close(spmm(W, jnp.asarray(B)), _scipy(A) @ B, 1e-5)


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)


def test_cwell_spmv_plane_rich():
    """A dense-ish pack (many planes per row block) through spmv."""
    A, _ = _random_csr(640, 640, 0.08, seed=11)
    W = csr_to_cwell(A)
    assert W.planes >= 32
    x = np.random.default_rng(12).standard_normal(640).astype(np.float32)
    _assert_close(spmv(W, jnp.asarray(x)), _scipy(A) @ x, 1e-5)
