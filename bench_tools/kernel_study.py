#!/usr/bin/env python3
"""Kernel decisions on the GPU: each candidate against what XLA makes of
the plain version, at the sizes chip_smoke.py runs.

* DIA SpMV at 27-pt 160³ (4.1M rows, 110M nnz), f32 and f64: the XLA
  formulation `reference.dia_spmv` (pad x once, full-length shifted
  products), the per-diagonal slice formulation it replaced, and the
  Pallas Triton kernel `kernels/dia_triton.py` — chained SpMV time, bytes
  over the copy bandwidth, and CG to tolerance with each as the matvec;
  then XLA vs Triton in CG, alternating, several rounds for the spread.
* General-structure SpMV on to_csr(27-pt 128³) (56M nnz): CSR segment-sum
  vs the CWELL gather.
* CG time per iteration at 160³ f32 against its byte floor.
* Tridiagonal / banded direct solves: the sequential scans (Thomas,
  banded LU) vs cyclic reduction (PCR, block PCR) across sizes, and the
  `banded_solve` dispatcher (threshold + one refinement step).

Prints one JSON line per measurement. Run on the card:
  python bench_tools/kernel_study.py [dia] [general] [banded] [banded_small]
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def dia_spmv_slices(A, x):
    """The other XLA formulation, kept here for the record: per diagonal, a
    static slice of x times the diagonal, written into a zero vector with
    dynamic_update_slice and summed."""
    n, m = A.shape
    y = jnp.zeros(n, jnp.result_type(A.data.dtype, x.dtype))
    for d, o in enumerate(A.offsets):
        i0, i1 = max(0, -o), min(n, m - o)
        seg = A.data[d, i0:i1] * jax.lax.slice(x, (i0 + o,), (i1 + o,))
        y = y + jax.lax.dynamic_update_slice(jnp.zeros_like(y), seg, (i0,))
    return y


def emit(study, **fields):
    print(json.dumps({"study": study, **fields}), flush=True)


def _time(f, *args, reps=3):
    """min seconds of f(*args) over reps, compiled beforehand."""
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def study_dia(copy, nx=160, triton=True, rounds=5):
    from tpu_sparse.kernels import dia_triton
    from tpu_sparse.kernels import reference as ref
    from tpu_sparse.solvers import cg_full
    from tpu_sparse.sparse import generators
    from tpu_sparse.utils.timing import per_iter_time

    variants = {"xla_dia_spmv": ref.dia_spmv,
                "xla_slices": dia_spmv_slices}
    if triton:
        variants["triton"] = dia_triton.dia_spmv
    A64 = generators.poisson3d_27pt(nx, dtype=np.float64)
    rng = np.random.default_rng(0)
    for dt, tol in ((jnp.float32, 1e-6), (jnp.float64, 1e-8)):
        A = A64.with_data(A64.data.astype(dt))
        x = jnp.asarray(rng.standard_normal(A.shape[0]), dt)
        b = ref.dia_spmv(A, x)
        nbytes = A.data.size * A.data.dtype.itemsize \
            + 2 * A.shape[0] * x.dtype.itemsize
        scale = np.asarray(1.0 / 27.0, dt)
        solves = {}
        for name, fn in variants.items():
            y = fn(A, x)
            err = float(jnp.max(jnp.abs(y - b)) / jnp.max(jnp.abs(b)))
            sec = per_iter_time(lambda v, _f=fn: _f(A, v) * scale, x,
                                K1=10, K2=110)
            solves[name] = jax.jit(lambda a, rhs, _f=fn: cg_full(
                lambda v: _f(a, v), rhs, tol=tol, maxiter=3000))
            t_cg = _time(solves[name], A, b)
            _, info, iters, _ = solves[name](A, b)
            emit("dia_spmv", variant=name, dtype=jnp.dtype(dt).name,
                 err_vs_xla=err, us=sec * 1e6,
                 gbs=nbytes / sec / 1e9, frac_of_copy=nbytes / sec / 1e9
                 / copy, cg_s=t_cg, cg_iters=int(iters),
                 cg_converged=int(info) == 0,
                 cg_us_per_iter=t_cg / max(int(iters), 1) * 1e6)
        if triton:
            # alternating rounds (xla, triton, triton, xla, ...) for the
            # run-to-run spread of the end-to-end comparison
            times = {"xla_dia_spmv": [], "triton": []}
            for r in range(rounds):
                order = ("xla_dia_spmv", "triton") if r % 2 == 0 \
                    else ("triton", "xla_dia_spmv")
                for name in order:
                    times[name].append(_time(solves[name], A, b, reps=1))
            emit("dia_cg_rounds", dtype=jnp.dtype(dt).name, **times)
        if dt == jnp.float32:
            # byte floor of one CG iteration: the matrix stream plus about
            # six vector passes (x read by the SpMV, y written, p/r/x
            # updates and two dot products, fused as XLA does)
            floor = (A.data.size * 4 + 6 * A.shape[0] * 4) / (copy * 1e9)
            emit("cg_floor", dtype="float32", floor_us_per_iter=floor * 1e6)
        del A, x, b


def study_general(copy, nx=128):
    from tpu_sparse.kernels import reference as ref
    from tpu_sparse.sparse import generators
    from tpu_sparse.sparse.convert import to_csr
    from tpu_sparse.sparse.cwell import csr_to_cwell
    from tpu_sparse.utils.timing import per_iter_time

    with jax.default_device(jax.devices("cpu")[0]):
        C = to_csr(generators.poisson3d_27pt(nx, dtype=np.float32))
        t0 = time.perf_counter()
        W = csr_to_cwell(C)
        t_pack = time.perf_counter() - t0
    C, W = jax.device_put((C, W), jax.devices()[0])
    x = jnp.asarray(np.random.default_rng(1).standard_normal(C.shape[0]),
                    jnp.float32)
    scale = np.float32(1.0 / 27.0)
    y_c, y_w = ref.csr_spmv(C, x), ref.cwell_spmv(W, x)
    err = float(jnp.max(jnp.abs(y_c - y_w)) / jnp.max(jnp.abs(y_c)))
    for name, fn, nbytes in (
            ("csr_segment_sum", ref.csr_spmv,
             C.nnz * 8 + (C.shape[0] + 1) * 4 + 2 * C.shape[0] * 4),
            ("cwell_gather", ref.cwell_spmv,
             W.vals.size * 8 + W.srow.size * 4 + 2 * C.shape[0] * 4)):
        sec = per_iter_time(lambda v, _f=fn, _a={"csr_segment_sum": C,
                                                 "cwell_gather": W}[name]:
                            _f(_a, v) * scale, x, K1=5, K2=25)
        emit("general_spmv", variant=name, n=C.shape[0], nnz=int(C.nnz),
             us=sec * 1e6, gnnz_per_s=C.nnz / sec / 1e9,
             gbs=nbytes / sec / 1e9, frac_of_copy=nbytes / sec / 1e9 / copy,
             cwell_fill=W.fill, cwell_pack_s=t_pack, max_rel_diff=err)


def study_banded(sizes=(500, 4096, 32768, 1 << 20)):
    from tpu_sparse.direct import banded_solve
    from tpu_sparse.direct.banded import (banded_lu_solve, block_pcr_solve,
                                          pcr_solve, thomas_solve)
    from tpu_sparse.sparse import generators
    from tpu_sparse.sparse.containers import DIA

    rng = np.random.default_rng(2)
    for n in sizes:
        offs = (-2, -1, 0, 1, 2)
        data = np.tile(np.array([[-1.0], [-1.0], [6.0], [-1.0], [-1.0]]),
                       (1, n))
        for family, A, solvers in (
                ("tridiagonal", generators.tridiagonal(n),
                 (("thomas", thomas_solve), ("pcr", pcr_solve),
                  ("banded_solve", banded_solve))),
                ("banded_w2", DIA(jnp.asarray(data), offs, (n, n)),
                 (("banded_lu", banded_lu_solve),
                  ("block_pcr", block_pcr_solve),
                  ("banded_solve", banded_solve)))):
            b = A @ jnp.asarray(rng.standard_normal(n))
            for name, fn in solvers:
                f = jax.jit(fn)
                sec = _time(f, A, b, reps=1 if n > 100000 else 3)
                rel = float(jnp.linalg.norm(A @ f(A, b) - b)
                            / jnp.linalg.norm(b))
                emit(family, solver=name, n=n, ms=sec * 1e3, true_rel=rel)


def main():
    from tpu_sparse.utils.compile_cache import setup_compile_cache
    from tpu_sparse.utils.timing import copy_bandwidth_gbs

    setup_compile_cache()
    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"kernel_study measures the GPU; JAX found {dev.platform}")
    copy = copy_bandwidth_gbs()
    emit("device", device_kind=dev.device_kind, copy_gbs=copy)
    which = set(sys.argv[1:]) or {"dia", "general", "banded"}
    if "dia" in which:
        study_dia(copy)
    if "general" in which:
        study_general(copy)
    if "banded" in which:
        study_banded()
    if "banded_small" in which:
        study_banded(sizes=(8, 16, 32, 64, 128, 256))


if __name__ == "__main__":
    main()
