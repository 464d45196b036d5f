"""Unified router tests — mirrors reference test_unified.py: availability
reporting, solver construction, explicit-backend routing, auto selection
(:129-154), shortcut methods, module-level convenience functions, error
handling for invalid backend (:314-344)."""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_sparse.api import SolverResult, SparseSolver, solve
from tpu_sparse.api import solver as solver_mod
from tpu_sparse.api.availability import (
    availability_dict,
    get_available_backends,
    print_availability_report,
)
from tpu_sparse.sparse import generators


@pytest.fixture(scope="module")
def spd():
    A = generators.tridiagonal(64)
    b = A @ jnp.asarray(np.random.default_rng(0).standard_normal(64))
    return A, b


def test_availability_report():
    avail = print_availability_report(verbose=False)
    assert avail["krylov"]
    assert avail["amg"]
    assert avail["direct"]
    assert avail["distributed"]  # 8 virtual CPU devices in conftest
    assert set(get_available_backends()) == {"krylov", "amg", "direct"}


def test_amg_probe_is_functional(monkeypatch):
    """check_amg_available runs a live setup + V-cycle (reference
    availability.py:58-105 pattern): a broken AMG setup must report
    unavailable, not fail later at first use."""
    import tpu_sparse.precond.amg as amg_mod
    from tpu_sparse.api import availability as av

    def boom(A, **kw):
        raise RuntimeError("broken toolchain")

    av.check_amg_available.cache_clear()
    monkeypatch.setattr(amg_mod, "amg_preconditioner", boom)
    try:
        assert av.check_amg_available() is False
    finally:
        monkeypatch.undo()
        av.check_amg_available.cache_clear()
    assert av.check_amg_available() is True


def test_solver_construction():
    s = SparseSolver()
    assert s.default_backend == "auto"
    assert s.default_method == "cg"
    assert "krylov" in s.available_backends


@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
def test_auto_routes_iterative_to_krylov(spd, method):
    A, b = spd
    s = SparseSolver()
    x, result = s.solve(A, b, method=method, tol=1e-10)
    assert result.backend == "krylov"
    assert result.method == method
    assert result.converged
    assert result.residual < 1e-6


def test_auto_routes_direct(spd):
    A, b = spd
    x, result = solve(A, b, method="direct")
    assert result.backend == "direct"
    assert result.converged
    assert result.residual < 1e-10


def test_auto_routes_amg():
    A = generators.poisson2d(16)
    b = A @ jnp.asarray(np.random.default_rng(1).standard_normal(256))
    x, result = solve(A, b, method="amg", tol=1e-8)
    assert result.backend == "amg"
    assert result.converged
    assert result.residual < 1e-6


def test_reference_backend_aliases(spd):
    """module_a/b/c names route to their analogues here."""
    A, b = spd
    s = SparseSolver()
    x, result = s.solve(A, b, method="cg", backend="module_a", tol=1e-10)
    assert result.backend == "krylov"
    x, result = s.solve(A, b, method="direct", backend="module_c")
    assert result.backend == "direct"


def test_shortcut_methods(spd):
    A, b = spd
    s = SparseSolver()
    x, r = s.cg(A, b, tol=1e-10)
    assert r.converged
    x, r = s.direct(A, b)
    assert r.converged


def test_module_level_functions(spd):
    A, b = spd
    x, r = solver_mod.cg(A, b, tol=1e-10)
    assert r.converged
    x, r = solver_mod.direct_solve(A, b)
    assert r.converged


def test_invalid_backend_raises(spd):
    A, b = spd
    s = SparseSolver()
    with pytest.raises(ValueError, match="not available"):
        s.solve(A, b, backend="nonexistent")


def test_result_dataclass(spd):
    A, b = spd
    x, r = solve(A, b, method="cg", tol=1e-10)
    assert isinstance(r, SolverResult)
    assert r.iterations is not None and r.iterations > 0
    assert isinstance(r.converged, bool)


def test_dimension_mismatch_raises(spd):
    A, _ = spd
    s = SparseSolver()
    with pytest.raises(ValueError, match="dimension mismatch"):
        s.solve(A, jnp.ones(10))


def test_session_context(spd):
    A, b = spd
    s = SparseSolver()
    with s.session() as sess:
        x1, r1 = sess.solve(A, b, method="cg", tol=1e-10)
        x2, r2 = sess.solve(A, 2 * b, method="cg", tol=1e-10)
    assert r1.converged and r2.converged


def test_residual_helpers(spd):
    A, b = spd
    from tpu_sparse.utils import compute_residual, relative_residual

    x, _ = solve(A, b, method="cg", tol=1e-10)
    assert float(relative_residual(A, x, b)) < 1e-6
    r = compute_residual(A, x, b)
    assert r.shape == b.shape


def test_callable_operator_through_router(spd):
    """Matrix-free callables must work through solve() (router wraps them
    for jit)."""
    A, b = spd

    x, r = solve(lambda v: A @ v, b, method="cg", tol=1e-10)
    assert r.converged
    assert r.residual < 1e-6


def test_fcg_through_router():
    from tpu_sparse.precond import amg_preconditioner
    from tpu_sparse.sparse import generators

    A = generators.poisson2d(16)
    b = A @ jnp.ones(256)
    M = amg_preconditioner(A, pre_sweeps=0, post_sweeps=3)  # nonsymmetric
    x, r = solve(A, b, method="fcg", tol=1e-8, M=M)
    assert r.converged and r.residual < 1e-6


def test_fgmres_through_router():
    from tpu_sparse.precond import amg_preconditioner
    from tpu_sparse.sparse import generators

    A = generators.convection_diffusion(128)
    b = A @ jnp.ones(128)
    M = amg_preconditioner(A, pre_sweeps=0, post_sweeps=3)
    x, r = solve(A, b, method="fgmres", tol=1e-8, M=M, restart=30)
    assert r.converged and r.residual < 1e-6


def test_solve_multi_rhs_block_and_batched():
    """A 2-D b routes to the block/batched solvers (reference loops per
    RHS sequentially, cudss_solver.py:297-324)."""
    from tpu_sparse.api.solver import SparseSolver
    from tpu_sparse.sparse import generators

    s = SparseSolver()
    A = generators.poisson2d(10)
    n = A.shape[0]
    rng = np.random.default_rng(31)
    Xt = np.asarray(rng.standard_normal((n, 3)))
    B = jnp.asarray(np.asarray(A.todense()) @ Xt)
    for method in ("cg", "bicgstab", "gmres", "amg", "direct"):
        X, r = s.solve(A, B, method=method, tol=1e-8)
        assert X.shape == (n, 3), method
        assert r.converged, (method, r)
        np.testing.assert_allclose(np.asarray(X), Xt, rtol=1e-4,
                                   atol=1e-6, err_msg=method)
    # mixed-precision multi-RHS: vmapped defect-correction refinement
    X4, r4 = s.solve(A, B, method="cg", precision="mixed", tol=1e-10)
    assert r4.converged
    np.testing.assert_allclose(np.asarray(X4), Xt, rtol=1e-8, atol=1e-8)
    # every Krylov method has a mixed variant now — minres multi-RHS
    # routes through the vmapped minres_refined
    X5, r5 = s.solve(A, B, method="minres", precision="mixed", tol=1e-10)
    assert r5.converged
    np.testing.assert_allclose(np.asarray(X5), Xt, rtol=1e-8, atol=1e-8)


def test_solve_multi_rhs_warm_start_and_reporting():
    """X0 must reach the batched solvers; AMG must report as amg; fcg
    routes multi-RHS (code-review round-2 findings)."""
    from tpu_sparse.api.solver import SparseSolver
    from tpu_sparse.sparse import generators

    s = SparseSolver()
    A = generators.poisson2d(10)
    n = A.shape[0]
    rng = np.random.default_rng(33)
    Xt = np.asarray(rng.standard_normal((n, 2)))
    B = jnp.asarray(np.asarray(A.todense()) @ Xt)
    # warm start at the exact solution: gmres must converge in ~0 iters
    X, r = s.solve(A, B, jnp.asarray(Xt), method="gmres", tol=1e-8)
    assert r.converged and (r.iterations or 0) <= 1, r
    # AMG reporting
    X2, r2 = s.solve(A, B, method="amg", tol=1e-8)
    assert r2.converged and r2.backend == "amg" and r2.method == "amg"
    # fcg/fgmres multi-RHS routes to the batched solvers
    for meth in ("fcg", "fgmres"):
        X3, r3 = s.solve(A, B, method=meth, tol=1e-8)
        assert r3.converged, meth
        np.testing.assert_allclose(np.asarray(X3), Xt, rtol=1e-4,
                                   atol=1e-6)


def test_to_tpu_operator_f64_wide_uses_df_compatible_segments():
    """f64 wide matrices segment at <=512K columns (half the f32 pack
    limit of sparse/cwell.py), and the segmented SpMV matches scipy."""
    import scipy.sparse as sp

    from tpu_sparse.sparse.convert import csr_from_arrays
    from tpu_sparse.sparse.cwell import CWELLSeg
    from tpu_sparse.sparse.optimize import to_tpu_operator

    n, m = 256, 900_000  # above the f64 cap (768K), below the f32 cap
    rng = np.random.default_rng(34)
    rows = np.repeat(np.arange(n), 16)
    cols = ((rows // 128) * 450_000 + rng.integers(0, 1024,
                                                   rows.size)) % m
    S = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, m)).tocsr()
    A = csr_from_arrays(S.data, S.indices, S.indptr, (n, m))
    W = to_tpu_operator(A)
    assert isinstance(W, CWELLSeg)
    assert all(w <= (1 << 19) for w in W.widths)
    from tpu_sparse.kernels import spmv

    x = jnp.asarray(rng.standard_normal(m))
    np.testing.assert_allclose(np.asarray(spmv(W, x)), S @ np.asarray(x),
                               rtol=1e-10, atol=1e-10)


def test_m_ignored_warning_for_amg_and_direct(spd):
    """Backends that don't use M must say so, not silently drop it —
    and string-M setup must be skipped entirely there."""
    A, b = spd
    s = SparseSolver()
    with pytest.warns(UserWarning, match="M is ignored"):
        x, r = s.solve(A, b, method="amg", M="jacobi", tol=1e-8)
    assert r.converged
    with pytest.warns(UserWarning, match="M is ignored"):
        x, r = s.solve(A, b, method="direct", M="jacobi")
    assert r.converged


def test_batch_safe_matvec_spmm_route():
    """vmapped matvec must produce the SpMM result (batch axis handling)."""
    from tpu_sparse.kernels import batch_safe_matvec
    from tpu_sparse.sparse.convert import dense_to_csr
    from tpu_sparse.sparse.optimize import to_tpu_operator

    rng = np.random.default_rng(7)
    Ad = np.asarray(rng.standard_normal((96, 96)))
    Ad[np.abs(Ad) < 1.2] = 0.0
    W = to_tpu_operator(dense_to_csr(jnp.asarray(Ad)))
    mv = batch_safe_matvec(W)
    X = jnp.asarray(rng.standard_normal((96, 5)))
    Y = jax.vmap(mv, in_axes=-1, out_axes=-1)(X)
    np.testing.assert_allclose(np.asarray(Y), Ad @ np.asarray(X),
                               rtol=1e-5, atol=1e-5)


def test_solve_reorder_rcm_scrambled_poisson():
    """reorder='rcm' must recover the original-ordering solution of a
    locality-destroyed system (and build M from the permuted matrix)."""
    from tpu_sparse.sparse import generators
    from tpu_sparse.sparse.convert import dense_to_csr

    rng = np.random.default_rng(55)
    A0 = generators.poisson2d(20)          # n=400
    n = A0.shape[0]
    Ad = np.asarray(A0.todense())
    perm = rng.permutation(n)
    As = dense_to_csr(Ad[np.ix_(perm, perm)])  # scrambled SPD system
    x_true = rng.standard_normal(n)
    b = jnp.asarray(As.todense() @ x_true)

    s = SparseSolver()
    x, r = s.solve(As, b, method="cg", tol=1e-10, reorder="rcm")
    assert r.converged
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-6, atol=1e-6)
    # string preconditioner rides the permuted matrix
    x, r = s.solve(As, b, method="cg", tol=1e-10, M="jacobi",
                   reorder="rcm")
    assert r.converged
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-6, atol=1e-6)
    # multi-RHS path
    Xt = rng.standard_normal((n, 3))
    B = jnp.asarray(As.todense() @ Xt)
    X, r = s.solve(As, B, method="cg", tol=1e-10, reorder="rcm")
    assert r.converged
    np.testing.assert_allclose(np.asarray(X), Xt, rtol=1e-5, atol=1e-5)


def test_solve_reorder_rejects_callables_and_callable_M(spd):
    A, b = spd
    s = SparseSolver()
    with pytest.raises(ValueError, match="matrix operand"):
        s.solve(lambda v: v, b, method="cg", reorder="rcm")
    with pytest.raises(ValueError, match="wrong ordering"):
        s.solve(A, b, method="cg", M=lambda v: v, reorder="rcm")
    with pytest.raises(ValueError, match="unknown reorder"):
        s.solve(A, b, method="cg", reorder="amd")


def test_solve_reorder_rejects_wrong_length_b(spd):
    """Dimension validation must fire before the permutation gather
    (review finding: clamping gather silently accepted short b)."""
    A, b = spd
    s = SparseSolver()
    with pytest.raises(ValueError, match="dimension mismatch"):
        s.solve(A, b[:-5], method="cg", reorder="rcm")


def test_amg_stationary_accelerant_none():
    """`solve(A, b, method='amg', accelerant=None)` runs AMG as a
    stationary solver with its own convergence loop (AMGX amg-as-solver
    parity, reference torch_amgx.py:481-483)."""
    A = generators.poisson2d(16)
    n = A.shape[0]
    rng = np.random.default_rng(3)
    xt = jnp.asarray(rng.standard_normal(n))
    b = A @ xt
    x, result = solve(A, b, method="amg", accelerant=None, tol=1e-8,
                      maxiter=200)
    assert result.backend == "amg"
    assert result.converged
    assert result.iterations is not None and result.iterations > 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(xt), rtol=1e-5,
                               atol=1e-5)
    # stationary needs more sweeps than PCG acceleration on the same A
    _, r_pcg = solve(A, b, method="amg", tol=1e-8, maxiter=200)
    assert result.iterations >= r_pcg.iterations


def test_multirhs_direct_one_program_report_parity():
    """Multi-RHS direct reporting is vmapped into the solve program; its
    info/residual must match per-column direct_residual_info."""
    from tpu_sparse.direct import direct_residual_info, direct_solve

    A = generators.tridiagonal(96)
    rng = np.random.default_rng(4)
    B = jnp.asarray(rng.standard_normal((96, 5)))
    s = SparseSolver()
    X, result = s.solve(A, B, method="direct")
    assert result.converged
    rels = []
    for j in range(5):
        xj = direct_solve(A, B[:, j])
        _, _, rel_j = direct_residual_info(A, B[:, j], xj)
        rels.append(float(rel_j))
        np.testing.assert_allclose(np.asarray(X[:, j]), np.asarray(xj),
                                   rtol=1e-12, atol=1e-12)
    assert result.residual == pytest.approx(max(rels), rel=1e-6)


def test_benchmark_result_memory_field():
    """BenchmarkResult carries memory_used_mb (reference benchmark.py:63
    parity); None is allowed when the runtime hides allocator stats."""
    from tpu_sparse.bench.harness import BenchmarkConfig, run_single_benchmark

    cfg = BenchmarkConfig(runs=1, warmup=1, verbose=False)
    r = run_single_benchmark("krylov", "cg", "tridiagonal", 64, cfg)
    assert not r.error_message
    assert hasattr(r, "memory_used_mb")
    if r.memory_used_mb is not None:
        assert r.memory_used_mb >= 0.0


def test_multi_rhs_cg_batch_default_and_block_option():
    """The router defaults to vmapped batch CG for independent RHS when no
    preconditioner is supplied, keeps block CG under M (shared Krylov
    space pays there), and accepts explicit multi_rhs= overrides."""
    from tpu_sparse.api.solver import SparseSolver

    s = SparseSolver()
    A = generators.poisson2d(12)
    n = A.shape[0]
    rng = np.random.default_rng(41)
    Xt = np.asarray(rng.standard_normal((n, 3)))
    B = jnp.asarray(np.asarray(A.todense()) @ Xt)
    for kw in ({}, {"multi_rhs": "batch"}, {"multi_rhs": "block"},
               {"M": "jacobi"}):
        X, r = s.solve(A, B, method="cg", tol=1e-8, **kw)
        assert r.converged, kw
        np.testing.assert_allclose(np.asarray(X), Xt, rtol=1e-4,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="multi_rhs"):
        s.solve(A, B, method="cg", multi_rhs="nope")


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)
