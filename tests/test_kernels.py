"""The SpMV/SpMM dispatch (kernels/) against scipy — the XLA kernels and
the Triton DIA kernel in the Pallas interpreter — the full-precision
products, the compile-cache rule, the smoke script's refusal of anything
but a GPU, and the tests that need the card (marker ``gpu``)."""


import os as _os
import sys as _sys

if __name__ == "__main__":  # allow `python tests/test_*.py` before package imports
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from tpu_sparse.kernels import reference as ref
from tpu_sparse.kernels import spmm, spmv
from tpu_sparse.sparse import generators

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GENS = {
    "tridiagonal_1500": lambda dt: generators.tridiagonal(1500, dtype=dt),
    "tridiagonal_5000": lambda dt: generators.tridiagonal(5000, dtype=dt),
    "poisson2d_40": lambda dt: generators.poisson2d(40, dtype=dt),
    "poisson3d_27pt_12": lambda dt: generators.poisson3d_27pt(12, dtype=dt),
}


def _scipy_of_dia(A):
    """scipy CSR (f64) built from the DIA diagonals: data[d, i] is
    A[i, i + offsets[d]]."""
    n, m = A.shape
    data = np.asarray(A.data, dtype=np.float64)
    rows, cols, vals = [], [], []
    for d, o in enumerate(A.offsets):
        i = np.arange(max(0, -o), min(n, m - o))
        rows.append(i)
        cols.append(i + o)
        vals.append(data[d, i])
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=A.shape)


def _rel(y, y_ref):
    y = np.asarray(y)
    y = y.astype(np.result_type(y.dtype, np.float64))
    return np.abs(y - y_ref).max() / np.abs(y_ref).max()


@pytest.mark.parametrize("gen", sorted(_GENS))
@pytest.mark.parametrize("dt,tol", [(np.float32, 1e-6), (np.float64, 1e-14)])
def test_dia_spmv_matches_scipy(gen, dt, tol):
    A = _GENS[gen](dt)
    x = np.random.default_rng(0).standard_normal(A.shape[0]).astype(dt)
    assert _rel(spmv(A, jnp.asarray(x)), _scipy_of_dia(A) @ x) <= tol


@pytest.mark.parametrize("gen", sorted(_GENS))
@pytest.mark.parametrize("dt,tol", [(np.float32, 1e-6), (np.float64, 1e-14)])
def test_dia_triton_kernel_interpreted(gen, dt, tol):
    """The Triton DIA kernel (Pallas interpreter) matches scipy; sizes
    span one partial tile to several tiles."""
    from tpu_sparse.kernels import dia_triton

    A = _GENS[gen](dt)
    x = np.random.default_rng(1).standard_normal(A.shape[0]).astype(dt)
    y = dia_triton.dia_spmv(A, jnp.asarray(x), interpret=True)
    assert y.dtype == dt
    assert _rel(y, _scipy_of_dia(A) @ x) <= tol


def test_dia_triton_kernel_rectangular_interpreted():
    from tpu_sparse.kernels import dia_triton
    from tpu_sparse.sparse.containers import DIA

    rng = np.random.default_rng(6)
    for shape in ((1500, 1700), (1700, 1500)):
        A = DIA(jnp.asarray(rng.standard_normal((3, shape[0]))),
                (-3, 0, 5), shape)
        x = rng.standard_normal(shape[1])
        y = dia_triton.dia_spmv(A, jnp.asarray(x), interpret=True)
        assert _rel(y, _scipy_of_dia(A) @ x) < 1e-14


def test_dia_triton_gradients_match_xla():
    """The kernel's custom JVP (XLA tangent) gives the XLA formulation's
    gradients w.r.t. the diagonals and x."""
    from tpu_sparse.kernels import dia_triton

    A = generators.poisson3d_27pt(9)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(A.shape[0]))

    def loss(fn):
        return lambda d, v: jnp.sum(jnp.sin(fn(A.with_data(d), v)))

    tri = loss(lambda B, v: dia_triton.dia_spmv(B, v, interpret=True))
    g_tri = jax.grad(tri, argnums=(0, 1))(A.data, x)
    g_xla = jax.grad(loss(ref.dia_spmv), argnums=(0, 1))(A.data, x)
    for a, b in zip(g_tri, g_xla):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-12, atol=1e-12)


def test_dia_triton_supports():
    from tpu_sparse.kernels import dia_triton

    A = generators.poisson2d(8, dtype=np.float32)
    x32 = jnp.zeros(64, jnp.float32)
    assert dia_triton.supports(A, x32)
    assert not dia_triton.supports(A, x32.astype(jnp.float64))  # mixed
    A64 = A.with_data(A.data.astype(jnp.float64))  # f64: XLA path
    assert not dia_triton.supports(A64, x32.astype(jnp.float64))
    assert not dia_triton.supports(A, jnp.zeros((64, 2), jnp.float32))
    Ac = A.with_data(A.data.astype(jnp.complex64))
    assert not dia_triton.supports(Ac, x32.astype(jnp.complex64))
    Ab = A.with_data(A.data.astype(jnp.bfloat16))
    assert not dia_triton.supports(Ab, x32.astype(jnp.bfloat16))


@pytest.mark.parametrize("on_gpu", [False, True])
def test_spmv_dispatch_picks_triton_on_gpu(on_gpu, monkeypatch):
    """kernels.spmv runs the Triton kernel for f32 DIA on the GPU and the
    XLA formulation otherwise (CPU, f64, complex operands)."""
    import tpu_sparse.kernels as K
    from tpu_sparse.kernels import dia_triton

    calls = []
    real = dia_triton.dia_spmv
    monkeypatch.setattr(K, "_on_gpu", lambda: on_gpu)
    monkeypatch.setattr(dia_triton, "dia_spmv", lambda A, x: (
        calls.append(A.data.dtype), real(A, x, interpret=True))[1])
    A = generators.poisson2d(20)
    S = _scipy_of_dia(A)
    x = np.random.default_rng(3).standard_normal(A.shape[0])
    for dt in (np.float32, np.float64):
        Ad = A.with_data(A.data.astype(dt))
        assert _rel(spmv(Ad, jnp.asarray(x.astype(dt))), S @ x) < 1e-6
    xc = x + 1j * x
    yc = spmv(A.with_data(A.data.astype(jnp.complex128)), jnp.asarray(xc))
    assert _rel(yc, S @ xc) < 1e-14
    assert calls == ([jnp.float32] if on_gpu else [])


def test_router_cg_through_triton_kernel(monkeypatch):
    """The router's CG with the Triton kernel (interpreted) as the DIA
    SpMV: same iterations and solution as the XLA path, and the implicit
    gradient flows through the kernel's JVP rule."""
    import tpu_sparse.kernels as K
    from tpu_sparse import solve
    from tpu_sparse.kernels import dia_triton

    A = generators.poisson2d(12, dtype=np.float32)
    b = A @ jnp.asarray(np.random.default_rng(4).standard_normal(144)
                        .astype(np.float32))
    kw = dict(method="cg", tol=1e-6)
    x_xla, r_xla = solve(A, b, **kw)
    g_xla = jax.grad(lambda bb: jnp.sum(solve(A, bb, **kw)[0] ** 2))(b)
    real = dia_triton.dia_spmv
    monkeypatch.setattr(K, "_on_gpu", lambda: True)
    monkeypatch.setattr(dia_triton, "dia_spmv",
                        lambda A_, x_: real(A_, x_, interpret=True))
    # jitted solves are cached per solver options, not per SpMV choice:
    # a tolerance the XLA run did not compile makes them trace again
    kw["tol"] = 1.0000001e-6
    x_tri, r_tri = solve(A, b, **kw)
    g_tri = jax.grad(lambda bb: jnp.sum(solve(A, bb, **kw)[0] ** 2))(b)
    assert r_tri.converged and r_tri.iterations == r_xla.iterations
    np.testing.assert_allclose(np.asarray(x_tri), np.asarray(x_xla),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g_tri), np.asarray(g_xla),
                               rtol=1e-4, atol=1e-5)


def test_dia_spmv_f64_values_spanning_magnitudes():
    """f64 SpMV is native f64: values spanning 15 orders of magnitude keep
    round-off accuracy."""
    A = generators.tridiagonal(1024)
    data = np.asarray(A.data) * (1 + 1e-9 * np.arange(A.data.shape[1]))
    data[:, ::7] *= 1e6
    A = A.with_data(jnp.asarray(data))
    x = np.random.default_rng(3).standard_normal(1024) * 1e3
    assert _rel(spmv(A, jnp.asarray(x)), _scipy_of_dia(A) @ x) < 1e-13


@pytest.mark.parametrize("k", [1, 17, 130])
def test_dia_spmm_matches_scipy(k):
    A = generators.poisson3d_27pt(8)
    B = np.random.default_rng(k).standard_normal((A.shape[0], k))
    assert _rel(spmm(A, jnp.asarray(B)), _scipy_of_dia(A) @ B) < 1e-13


def test_dia_rectangular_spmv():
    """Non-square DIA: rows past the last column and columns past the
    last row."""
    from tpu_sparse.sparse.containers import DIA

    rng = np.random.default_rng(4)
    for shape in ((50, 70), (70, 50)):
        offs = (-3, 0, 5)
        A = DIA(jnp.asarray(rng.standard_normal((3, shape[0]))), offs, shape)
        x = rng.standard_normal(shape[1])
        assert _rel(spmv(A, jnp.asarray(x)), _scipy_of_dia(A) @ x) < 1e-14


def _dot_precisions(fn, *args):
    """Precision config of every dot_general in fn's jaxpr (recursively)."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                sub = getattr(v, "jaxpr", None)
                if sub is not None:
                    walk(getattr(sub, "jaxpr", sub))

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _all_highest(precs):
    H = jax.lax.Precision.HIGHEST
    return precs and all(p is not None and all(q == H for q in p)
                         for p in precs)


@pytest.mark.parametrize("name", ["_lstsq_normal", "_lstsq_qr"])
def test_gmres_lstsq_products_are_highest(name):
    """GMRES's least-squares Gram / projection products ask for full
    precision (no TF32 on the GPU)."""
    from tpu_sparse.solvers import krylov

    fn = getattr(krylov, name)
    H = jnp.asarray(np.random.default_rng(5).standard_normal((6, 7)),
                    jnp.float32)
    precs = _dot_precisions(lambda h: fn(h, jnp.float32(1.0), 6), H)
    assert _all_highest(precs), precs


def test_block_matrix_products_are_highest(rng):
    """The BSR/BELL block products and the block cyclic reduction ask for
    full precision."""
    from tpu_sparse.direct.banded import block_pcr_solve
    from tpu_sparse.sparse import bsr_to_bell, csr_to_bsr, dense_to_csr

    Ad = np.kron(np.eye(4), rng.standard_normal((8, 8))).astype(np.float32)
    bsr = csr_to_bsr(dense_to_csr(Ad), 8)
    bell = bsr_to_bell(bsr)
    x = jnp.ones(32, jnp.float32)
    B = jnp.ones((32, 3), jnp.float32)
    for fn, arg in ((lambda v: ref.bsr_spmv(bsr, v), x),
                    (lambda v: ref.bsr_spmm(bsr, v), B),
                    (lambda v: ref.bell_spmv(bell, v), x),
                    (lambda v: ref.bell_spmm(bell, v), B)):
        assert _all_highest(_dot_precisions(fn, arg))
    A = generators.poisson2d(6, dtype=np.float32)
    assert _all_highest(_dot_precisions(
        lambda b: block_pcr_solve(A, b), jnp.ones(36, jnp.float32)))


class _FakeJax:
    """Records config updates instead of applying them."""

    def __init__(self):
        self.updates = []
        self.config = self

    def update(self, name, value):
        self.updates.append((name, value))


@pytest.mark.parametrize("env", [None, "cache_from_env"])
def test_compile_cache_rule(env, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: used as is, nothing set in code.
    Unset: the fixed <checkout>/.jax_cache."""
    from tpu_sparse.utils import compile_cache as cc

    fake = _FakeJax()
    monkeypatch.setattr(cc, "jax", fake)
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cc.setup_compile_cache() == os.path.join(REPO, ".jax_cache")
        assert fake.updates == [("jax_compilation_cache_dir",
                                 os.path.join(REPO, ".jax_cache"))]
    else:
        path = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
        assert cc.setup_compile_cache() == path
        assert fake.updates == []


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except (json.JSONDecodeError, AttributeError):
        return False


def test_chip_smoke_refuses_cpu():
    """On a CPU device the smoke exits non-zero and prints no result."""
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert not _printed_result(out.stdout)
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py (no package) it fails."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not _printed_result(out.stdout)


def test_no_tpu_kernel_code_left():
    """The package holds no TPU kernel, TPU branch or TPU memory-space
    code: every path runs on the GPU (and the CPU)."""
    bad = ("pallas.tpu", "pltpu", 'default_backend() == "tpu"',
           '"tpu"', "make_async_copy")
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "tpu_sparse")):
        for f in files:
            if f.endswith((".py", ".cc")):
                text = open(os.path.join(root, f)).read()
                hits += [(f, b) for b in bad if b in text]
    assert not hits, hits


@pytest.mark.gpu
def test_gpu_spmv_and_cg(gpu):
    """On the card: DIA SpMV in f32/f64 matches scipy and router CG meets
    the true-residual contract."""
    from tpu_sparse import solve

    for dt, tol in ((np.float32, 1e-6), (np.float64, 1e-14)):
        A = generators.poisson3d_27pt(32, dtype=dt)
        x = np.random.default_rng(0).standard_normal(A.shape[0]).astype(dt)
        y = spmv(A, jnp.asarray(x))
        assert y.devices() == {gpu}
        assert _rel(y, _scipy_of_dia(A) @ x) <= tol
        # the dispatch runs the Triton kernel on the card
        assert "pallas_call" in str(jax.make_jaxpr(spmv)(A, jnp.asarray(x)))
    A = generators.poisson3d_27pt(32)
    S = _scipy_of_dia(A)
    b = S @ np.random.default_rng(1).standard_normal(A.shape[0])
    x, r = solve(A, jnp.asarray(b), method="cg", tol=1e-8,
                 precision="full")
    assert r.converged
    assert np.linalg.norm(b - S @ np.asarray(x)) <= 1.05e-8 * np.linalg.norm(b)


@pytest.mark.gpu
def test_gpu_general_direct_host_callback(gpu):
    """On the card: the general direct path's host SuperLU callback runs
    inside the compiled program."""
    from tpu_sparse import solve
    from tpu_sparse.sparse.convert import to_csr

    A = to_csr(generators.poisson2d(72))
    S = sp.csr_matrix((np.asarray(A.data), np.asarray(A.indices),
                       np.asarray(A.indptr)), shape=A.shape)
    b = S @ np.random.default_rng(2).standard_normal(A.shape[0])
    x, r = solve(A, jnp.asarray(b), method="direct")
    assert r.converged
    assert np.linalg.norm(b - S @ np.asarray(x)) <= 1e-10 * np.linalg.norm(b)


if __name__ == "__main__":  # standalone entry (reference test_module_a.py:358-377)
    from _standalone import run_standalone

    run_standalone(__file__)
