"""Distributed-layer tests on the CPU-simulated 8-device mesh.

The reference cannot express any of this (no distributed code, SURVEY.md
§2.3); validated here against single-device oracles, per the BASELINE.json
north star."""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_sparse.dist import (
    distributed_cg,
    halo_dia_spmv,
    make_row_mesh,
    shard_dia,
    shard_vector,
)
from tpu_sparse.dist.solvers import distributed_bicgstab
from tpu_sparse.kernels import spmv
from tpu_sparse.sparse import generators

NDEV = 8


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= NDEV
    return make_row_mesh(NDEV)


def test_halo_spmv_matches_local(mesh):
    A = generators.poisson2d(16)  # n=256, divisible by 8; bandwidth 16 < 32
    x = jnp.asarray(np.random.default_rng(0).standard_normal(256))
    y_local = spmv(A, x)
    A_sh = shard_dia(A, mesh)
    x_sh = shard_vector(x, mesh)
    y_dist = halo_dia_spmv(A_sh, x_sh, mesh)
    np.testing.assert_allclose(np.asarray(y_dist), np.asarray(y_local),
                               rtol=1e-12, atol=1e-12)


def test_halo_spmv_nondivisible(mesh):
    # n=100 pads to 104; identity padding leaves result correct on :100
    A = generators.tridiagonal(100)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(100))
    from tpu_sparse.dist.partition import pad_vector

    A_sh = shard_dia(A, mesh)
    x_sh = shard_vector(x, mesh)
    y = halo_dia_spmv(A_sh, x_sh, mesh)
    np.testing.assert_allclose(np.asarray(y[:100]), np.asarray(spmv(A, x)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["gspmd", "halo"])
def test_distributed_cg_matches_serial(mesh, mode):
    A = generators.poisson2d(16)
    n = A.shape[0]
    rng = np.random.default_rng(2)
    x_true = jnp.asarray(rng.standard_normal(n))
    b = A @ x_true
    x, info, iters, res = distributed_cg(A, b, mesh=mesh, mode=mode,
                                         tol=1e-10)
    assert int(info) == 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-6, atol=1e-8)
    # bit-comparable convergence: same iteration count as single-device
    from tpu_sparse.solvers import cg_full

    _, _, iters_serial, _ = cg_full(A, b, tol=1e-10)
    assert abs(int(iters) - int(iters_serial)) <= 2


def test_distributed_bicgstab(mesh):
    A = generators.convection_diffusion(128)
    rng = np.random.default_rng(3)
    x_true = jnp.asarray(rng.standard_normal(128))
    b = A @ x_true
    x, info, iters, res = distributed_bicgstab(A, b, mesh=mesh, mode="halo",
                                               tol=1e-10)
    assert int(info) == 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-6, atol=1e-8)


def test_distributed_cg_poisson3d(mesh):
    """27-point 3-D stencil (the north-star operator) on the virtual mesh."""
    # nx=10 → n=1000, shard 125 ≥ bandwidth 10·10+10+1=111
    A = generators.poisson3d_27pt(10, dtype=np.float64)
    n = A.shape[0]
    rng = np.random.default_rng(4)
    x_true = jnp.asarray(rng.standard_normal(n))
    b = A @ x_true
    x, info, iters, res = distributed_cg(A, b, mesh=mesh, mode="halo",
                                         tol=1e-8)
    assert int(info) == 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-5, atol=1e-6)


def test_distributed_gmres(mesh):
    from tpu_sparse.dist.solvers import distributed_gmres

    A = generators.convection_diffusion(128)
    rng = np.random.default_rng(5)
    x_true = jnp.asarray(rng.standard_normal(128))
    b = A @ x_true
    x, info, iters, res = distributed_gmres(A, b, mesh=mesh, mode="halo",
                                            tol=1e-10, restart=30)
    assert int(info) == 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-6, atol=1e-8)


def test_distributed_cg_deterministic(mesh):
    """Bit-identical results across repeated runs (fixed psum reduction
    order — the determinism analogue of AMGX's determinism_flag,
    SURVEY.md §5)."""
    A = generators.poisson2d(16)
    b = A @ jnp.asarray(np.random.default_rng(6).standard_normal(256))
    x1, *_ = distributed_cg(A, b, mesh=mesh, mode="halo", tol=1e-10)
    x2, *_ = distributed_cg(A, b, mesh=mesh, mode="halo", tol=1e-10)
    assert np.array_equal(np.asarray(x1), np.asarray(x2))  # bitwise


@pytest.mark.parametrize("mode", ["gspmd", "halo"])
def test_distributed_amg_pcg(mesh, mode):
    """AMG-preconditioned distributed CG: fine level row-sharded, the
    hierarchy replicated; restriction/prolongation auto-collective."""
    from tpu_sparse.precond import amg_preconditioner

    A = generators.poisson2d(16)
    b = A @ jnp.asarray(np.random.default_rng(7).standard_normal(256))
    M = amg_preconditioner(A)
    x, info, iters, res = distributed_cg(A, b, mesh=mesh, mode=mode,
                                         tol=1e-8, M=M)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-6
    assert int(iters) < 40  # multigrid actually accelerating


def test_distributed_preconditioned_needs_divisible_n(mesh):
    from tpu_sparse.precond import jacobi_preconditioner

    A = generators.tridiagonal(100)  # 100 not divisible by 8
    b = jnp.ones(100)
    with pytest.raises(ValueError, match="divisible"):
        distributed_cg(A, b, mesh=mesh, M=jacobi_preconditioner(A))


def test_allgather_spmv_wide_bandwidth(mesh):
    # bandwidth 43 > shard 27 on the 8-device mesh: single-hop halos cannot
    # cover the stencil; the explicit all_gather SpMV must.
    from tpu_sparse.dist.spmv import make_allgather_spmv

    A = generators.poisson3d_27pt(6)  # n=216, bandwidth 43
    x = jnp.asarray(np.random.default_rng(7).standard_normal(216))
    y_local = spmv(A, x)
    A_sh = shard_dia(A, mesh)
    x_sh = shard_vector(x, mesh)
    y_dist = make_allgather_spmv(A_sh, mesh)(x_sh)
    np.testing.assert_allclose(np.asarray(y_dist), np.asarray(y_local),
                               rtol=1e-12, atol=1e-12)


def test_distributed_cg_wide_bandwidth_degrades_to_allgather(mesh):
    # mode='halo' on a bandwidth>shard system must solve the REAL matrix
    # via the all_gather fallback (round-1 dryrun silently substituted a
    # tridiagonal here).
    A = generators.poisson3d_27pt(6)
    n = A.shape[0]
    rng = np.random.default_rng(8)
    x_true = jnp.asarray(rng.standard_normal(n))
    b = A @ x_true
    x, info, iters, res = distributed_cg(A, b, mesh=mesh, mode="halo",
                                         tol=1e-8)
    assert int(info) == 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true),
                               rtol=1e-6, atol=1e-6)


def test_distributed_amg_sharded_hierarchy(mesh):
    """Round-2: every AMG level row-sharded (CWELL block sharding), not
    replicated. Must converge identically to the replicated-hierarchy PCG."""
    from tpu_sparse.dist.amg import (
        distributed_amg_preconditioner,
        shard_amg_hierarchy,
    )
    from tpu_sparse.precond.amg import amg_setup
    from tpu_sparse.sparse.cwell import CWELL

    A = generators.poisson2d(16)
    b = A @ jnp.asarray(np.random.default_rng(9).standard_normal(256))
    M = distributed_amg_preconditioner(A, mesh)
    # levels really are sharded CWELL matrices
    hier = M.args[0]
    assert len(hier.levels) >= 1
    for lvl in hier.levels[1:]:
        assert isinstance(lvl.A, CWELL)
        shard_names = {
            s for leaf in (lvl.A.vals,)
            for s in [leaf.sharding]
        }
        assert all("rows" in str(s.spec) for s in shard_names), shard_names
    x, info, iters, res = distributed_cg(A, b, mesh=mesh, mode="gspmd",
                                         tol=1e-8, M=M)
    assert int(info) == 0
    rel = float(jnp.linalg.norm(b - A @ x) / jnp.linalg.norm(b))
    assert rel < 1e-6
    assert int(iters) < 40


def test_distributed_general_cwell_spmv():
    """General-structure (non-stencil) distributed SpMV: random sparse
    matrix row-sharded as CWELL blocks + all_gather x; matches the serial
    oracle. Closes the round-1 'DIA-only distribution' gap."""
    import scipy.sparse as sp

    from tpu_sparse.dist import make_row_mesh
    from tpu_sparse.dist.partition import shard_general, shard_vector
    from tpu_sparse.dist.spmv import make_cwell_allgather_spmv
    from tpu_sparse.sparse.convert import csr_from_arrays

    rng = np.random.default_rng(21)
    n = 700  # not divisible by 8*128: exercises identity padding
    A_sp = sp.random(n, n, density=0.01, random_state=42,
                     dtype=np.float64, format="csr")
    A_sp.setdiag(A_sp.diagonal() + 1.0)
    A_sp = A_sp.tocsr()
    A = csr_from_arrays(A_sp.data, A_sp.indices, A_sp.indptr, A_sp.shape)

    mesh = make_row_mesh()
    W_sh = shard_general(A, mesh)
    mv = make_cwell_allgather_spmv(W_sh, mesh)
    x = rng.standard_normal(n)
    x_sh = shard_vector(jnp.asarray(x), mesh, unit=128)
    y = np.asarray(jax.jit(mv)(x_sh))[:n]
    y_ref = A_sp @ x
    np.testing.assert_allclose(y, y_ref, rtol=1e-10, atol=1e-12)


def test_distributed_cg_general_matrix():
    """Distributed CG on a general (non-DIA) SPD matrix matches the serial
    solve and converges."""
    import scipy.sparse as sp

    from tpu_sparse.dist import distributed_cg, make_row_mesh
    from tpu_sparse.solvers import cg_full
    from tpu_sparse.sparse.convert import csr_from_arrays

    rng = np.random.default_rng(22)
    n = 500
    B = sp.random(n, n, density=0.01, random_state=7, format="csr")
    A_sp = (B @ B.T + 10.0 * sp.identity(n)).tocsr()
    A = csr_from_arrays(A_sp.data, A_sp.indices, A_sp.indptr, A_sp.shape)
    b = jnp.asarray(rng.standard_normal(n))

    mesh = make_row_mesh()
    x, info, iters, res = distributed_cg(A, b, mesh=mesh, tol=1e-10)
    assert int(info) == 0
    x_s, info_s, iters_s, _ = cg_full(A, b, tol=1e-10)
    assert int(info_s) == 0
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_s),
                               rtol=1e-7, atol=1e-9)
    # iteration counts match the serial solver (deterministic reductions)
    assert abs(int(iters) - int(iters_s)) <= 2


def test_general_halo_plan_and_cg_matches_serial(mesh):
    """Boundary-volume halo SpMV for GENERAL matrices:
    a banded-locality CSR plans single-hop halos (receive volume = cut,
    not n), the halo solve matches the serial one, and the resolved mode
    really is the halo path."""
    from tpu_sparse.dist.solvers import _shard_and_resolve
    from tpu_sparse.dist.spmv import (HaloCWELL, make_cwell_halo_spmv,
                                      plan_cwell_halo)
    from tpu_sparse.dist import distributed_cg
    from tpu_sparse.kernels import spmv as _spmv
    from tpu_sparse.solvers import cg_full
    from tpu_sparse.sparse.convert import to_csr

    A = generators.poisson2d(32, dtype=np.float32)  # n=1024 = 8*128
    Ac = to_csr(A)
    A_sh, mode = _shard_and_resolve(Ac, mesh, "gspmd")
    assert mode == "cwell_halo"
    assert isinstance(A_sh, HaloCWELL)
    # halo volume is the stencil cut rounded to the 256-wide/128-aligned
    # CWELL window granularity — far below n
    assert A_sh.wl + A_sh.wr <= 4 * 128
    assert A_sh.wl + A_sh.wr < A_sh.shape[0] // 2 + 1

    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal(1024).astype(np.float32))
    from tpu_sparse.dist.partition import shard_vector

    y = make_cwell_halo_spmv(A_sh, mesh)(shard_vector(x, mesh))
    np.testing.assert_allclose(np.asarray(y), np.asarray(_spmv(A, x)),
                               rtol=1e-5, atol=1e-5)

    b = A @ jnp.asarray(rng.standard_normal(1024).astype(np.float32))
    xd, info, iters, _ = distributed_cg(Ac, b, mesh=mesh, tol=1e-5)
    xs, info_s, iters_s, _ = cg_full(A, b, tol=1e-5)
    assert int(info) == 0 and int(info_s) == 0
    np.testing.assert_allclose(np.asarray(xd), np.asarray(xs),
                               rtol=2e-4, atol=2e-4)

    # cut-scaling: 4x the rows at the same stencil bandwidth keeps the
    # halo volume CONSTANT (allgather volume would scale with n)
    A2 = to_csr(generators.poisson2d(64, dtype=np.float32))  # n=4096
    A2_sh, mode2 = _shard_and_resolve(A2, mesh, "gspmd")
    assert mode2 == "cwell_halo"
    assert (A2_sh.wl + A2_sh.wr) == (A_sh.wl + A_sh.wr)


def test_general_no_locality_falls_back_to_allgather(mesh):
    """A scrambled-column matrix cannot plan single-hop halos — the
    resolver must keep the all_gather SpMV (and still solve right)."""
    import scipy.sparse as sp

    from tpu_sparse.dist.solvers import _shard_and_resolve
    from tpu_sparse.sparse.convert import csr_from_arrays

    rng = np.random.default_rng(9)
    n = 1024
    B = sp.random(n, n, density=0.02, random_state=3, format="csr")
    A_sp = (B @ B.T + 10.0 * sp.identity(n)).tocsr()  # global coupling
    perm = rng.permutation(n)
    A_sp = A_sp[perm][:, perm].tocsr()
    Ac = csr_from_arrays(A_sp.data.astype(np.float32),
                         A_sp.indices, A_sp.indptr, A_sp.shape)
    A_sh, mode = _shard_and_resolve(Ac, mesh, "gspmd")
    assert mode == "cwell_allgather"


def test_distributed_block_cg(mesh):
    """Row-sharded multi-RHS block CG matches the serial block solve."""
    from tpu_sparse.dist.solvers import distributed_block_cg
    from tpu_sparse.solvers import block_cg

    A = generators.poisson2d(16)  # n=256
    rng = np.random.default_rng(40)
    B = jnp.asarray(rng.standard_normal((256, 3)))
    X_d, infos_d, iters_d, res_d = distributed_block_cg(
        A, B, mesh=mesh, mode="gspmd", tol=1e-8)
    assert np.all(np.asarray(infos_d) == 0)
    X_s, infos_s, iters_s, _ = block_cg(A, B, tol=1e-8)
    assert int(iters_d) == int(iters_s)  # same math, sharded execution
    np.testing.assert_allclose(np.asarray(X_d), np.asarray(X_s),
                               rtol=1e-8, atol=1e-10)


def test_distributed_block_cg_halo(mesh):
    from tpu_sparse.dist.solvers import distributed_block_cg

    A = generators.poisson2d(16)
    rng = np.random.default_rng(41)
    Xt = np.asarray(rng.standard_normal((256, 2)))
    B = jnp.asarray(np.asarray(A.todense()) @ Xt)
    X, infos, _, _ = distributed_block_cg(A, B, mesh=mesh, mode="halo",
                                          tol=1e-9)
    assert np.all(np.asarray(infos) == 0)
    np.testing.assert_allclose(np.asarray(X), Xt, rtol=1e-5, atol=1e-7)


def test_distributed_minres(mesh):
    """Row-sharded MINRES on an indefinite system matches serial."""
    from tpu_sparse.dist.solvers import distributed_minres
    from tpu_sparse.solvers import minres_full
    from tpu_sparse.sparse.containers import DIA

    A0 = generators.poisson2d(16)
    d0 = A0.offsets.index(0)
    A = DIA(A0.data.at[d0].add(-1.1), A0.offsets, A0.shape)  # indefinite
    rng = np.random.default_rng(42)
    b = jnp.asarray(rng.standard_normal(256))
    x_d, info_d, it_d, _ = distributed_minres(A, b, mesh=mesh, tol=1e-9)
    assert int(info_d) == 0
    x_s, info_s, it_s, _ = minres_full(A, b, tol=1e-9)
    assert int(it_d) == int(it_s)
    np.testing.assert_allclose(np.asarray(x_d), np.asarray(x_s),
                               rtol=1e-7, atol=1e-9)


def test_distributed_cg_pipeline_matches_serial():
    """pipeline=True (single-reduction CG) on the 8-device mesh must
    reproduce the serial solution on the 27-pt system."""
    from tpu_sparse.dist import distributed_cg
    from tpu_sparse.solvers import cg_full
    from tpu_sparse.sparse import generators

    A = generators.poisson3d_27pt(16)
    n = A.shape[0]
    rng = np.random.default_rng(41)
    x_true = jnp.asarray(rng.standard_normal(n))
    b = A @ x_true
    xs, i0, k0, _ = cg_full(A, b, tol=1e-10)
    xd, info, iters, res = distributed_cg(A, b, tol=1e-10, pipeline=True)
    assert int(info) == 0
    np.testing.assert_allclose(np.asarray(xd), np.asarray(xs),
                               rtol=1e-7, atol=1e-7)
    # same mathematics: iteration counts stay in the same neighbourhood
    assert abs(int(iters) - int(k0)) <= 10, (int(k0), int(iters))


def test_comm_model_measured_collectives_and_efficiency():
    """Compiled-HLO collective counting (dist/comm_model.py): the halo
    SpMV must show exactly 2 one-hop permutes of bandwidth*4 bytes, and
    distributed CG exactly 2 scalar all-reduce rounds per iteration
    (1 for the single-reduction variant), and no collective outside the
    loop but the setup's."""
    import numpy as np

    from tpu_sparse.dist import distributed_matvec_op, make_row_mesh
    from tpu_sparse.dist.comm_model import measure_collectives
    from tpu_sparse.dist.partition import shard_vector
    from tpu_sparse.dist.solvers import _matvec_builder, _shard_and_resolve
    from tpu_sparse.solvers.krylov import cg_full
    from tpu_sparse.solvers.pipelined import cg_sr_full
    from tpu_sparse.sparse import generators

    nx = 8
    A = generators.poisson3d_27pt(nx, nx, nx * 8, dtype=np.float32)
    mesh = make_row_mesh(8)
    A_sh, matvec = distributed_matvec_op(A, mesh, "halo")
    v = shard_vector(jnp.zeros(A.shape[0], jnp.float32), mesh)

    st = measure_collectives(lambda x: matvec(x), v)
    s = st.summary()
    assert s["collective-permute"]["count"] == 2
    w = max(A_sh.bandwidth, 1)
    assert s["collective-permute"]["bytes"] == 2 * w * 4

    b_sh = shard_vector(jnp.ones(A.shape[0], jnp.float32), mesh)
    per_iter_reduces = {}
    for name, solver in (("cg", cg_full), ("cg_sr", cg_sr_full)):
        def run(aa, bb, _s=solver):
            return _s(_matvec_builder(aa, mesh, "halo"), bb, None,
                      tol=1e-6, maxiter=50)

        stats = measure_collectives(run, A_sh, b_sh)
        per_it = stats.summary(per_iteration=True)
        assert per_it["collective-permute"]["count"] == 2, name
        per_iter_reduces[name] = per_it["all-reduce"]["count"]
        # every op is either per-iteration or setup, never both
        assert (len(stats.per_iteration) + len(stats.setup)
                == len(stats.ops)) and stats.per_iteration
    # the single-reduction recurrence must measure exactly one fused
    # reduction round vs CG's two
    assert per_iter_reduces["cg"] == 2
    assert per_iter_reduces["cg_sr"] == 1


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)
