#!/usr/bin/env python3
"""Benchmark on the GPU. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {...}, "extra": {...}}

Headline: 27-point 3-D Poisson SpMV throughput (Gnnz/s) through
``kernels.spmv`` at n = 128³. ``vs_baseline`` is the SpMV's bytes per
application (matrix data + x + y) over the time, as a fraction of the
copy bandwidth measured in the same process. Extras report the
reference's RTX 4090 fp64 protocol rows (BASELINE.md: CG 500x500 =
46.2 ms, tol=1e-8; README.md:632-634) and the at-scale solver rows.

Per-op device cost is measured as the slope between chained K1- and
K2-iteration jitted loops, so fixed dispatch latency cancels out. Solve
rows report wall time per call, dispatch included, like the reference's
protocol.

The benchmark measures the GPU only: it exits non-zero, printing no
result, when JAX finds no GPU.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sparse.bench.harness import device_peak_memory_mb
from tpu_sparse.utils.compile_cache import setup_compile_cache
from tpu_sparse.utils.timing import (copy_bandwidth_gbs, per_iter_time,
                                     wall_time)

_FULL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "bench_full.json")


def _progress(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main():
    from tpu_sparse.kernels import spmv
    from tpu_sparse.solvers import cg_refined
    from tpu_sparse.sparse import generators

    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev.platform}",
              file=sys.stderr)
        sys.exit(1)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    rng = np.random.default_rng(0)
    extra = {}

    _progress("copy bandwidth")
    copy_gbs = copy_bandwidth_gbs()
    extra["copy_gbs_measured"] = copy_gbs

    _progress("headline spmv")
    nx3 = 128
    A3 = generators.poisson3d_27pt(nx3, dtype=np.float32)
    n3 = A3.shape[0]
    v0 = jnp.asarray(rng.standard_normal(n3).astype(np.float32))
    scale = np.float32(1.0 / 27.0)
    dt = per_iter_time(lambda y: spmv(A3, y) * scale, v0)
    gnnz = A3.nnz / dt / 1e9
    # bytes per application: the stored diagonals + x read + y written
    bw = (A3.data.size * 4 + 2 * n3 * 4) / dt / 1e9
    frac = bw / copy_gbs
    extra.update({"spmv_27pt_n": n3, "spmv_27pt_us": dt * 1e6,
                  "spmv_27pt_gbs": bw, "spmv_27pt_frac_of_copy": frac})
    del A3, v0

    _progress("cg tridiag500")
    # --- reference-protocol rows at n=500 (BASELINE.md: CG 46.2 ms,
    # GMRES 515.7 ms, cuDSS direct 21.4 ms on the RTX 4090) ---
    jax.config.update("jax_enable_x64", True)
    A = generators.tridiagonal(500)
    b = A @ jnp.asarray(rng.standard_normal(500))
    solve = jax.jit(lambda a, rhs: cg_refined(a, rhs, tol=1e-8,
                                              maxiter=5000))
    t_wall = wall_time(solve, A, b)
    _, info, iters, res = jax.block_until_ready(solve(A, b))
    extra.update({
        "cg_tridiag500_wall_ms": t_wall * 1e3,
        "cg_tridiag500_vs_rtx4090": 46.2 / (t_wall * 1e3),
        "cg_converged": bool(int(info) == 0),
        "cg_inner_iters": int(iters),
    })

    _progress("gmres/direct 500")
    from tpu_sparse.direct import direct_solve
    from tpu_sparse.solvers import gmres_refined

    gsolve = jax.jit(lambda a, rhs: gmres_refined(
        a, rhs, tol=1e-8, restart=20, maxiter=5000))
    t_g = wall_time(gsolve, A, b)
    _, info_g, _, _ = jax.block_until_ready(gsolve(A, b))
    dsolve = jax.jit(direct_solve)
    t_d = wall_time(dsolve, A, b)
    xd5 = jax.block_until_ready(dsolve(A, b))
    extra.update({
        "gmres_tridiag500_wall_ms": t_g * 1e3,
        "gmres_tridiag500_vs_rtx4090": 515.7 / (t_g * 1e3),
        "gmres_converged": bool(int(info_g) == 0),
        "direct_tridiag500_wall_ms": t_d * 1e3,
        "direct_tridiag500_vs_rtx4090": 21.4 / (t_d * 1e3),
        "direct_rel_residual": float(jnp.linalg.norm(b - A @ xd5)
                                     / jnp.linalg.norm(b)),
    })

    _progress("general direct")
    # --- general sparse direct: n=262144 skewed 2-D Poisson as general
    # CSR (nonsymmetric, no structure hint to the solver) ---
    import scipy.sparse as sp

    from tpu_sparse.api.solver import SparseSolver
    from tpu_sparse.sparse.convert import csr_from_arrays, to_csr

    Ag0 = to_csr(generators.poisson2d(512, dtype=np.float64))
    Asp = sp.csr_matrix((np.asarray(Ag0.data), np.asarray(Ag0.indices),
                         np.asarray(Ag0.indptr)), shape=Ag0.shape)
    Asp = (Asp + 0.1 * sp.triu(Asp, k=1)).tocsr()
    Agen = csr_from_arrays(Asp.data, Asp.indices, Asp.indptr, Asp.shape)
    bgen = jnp.asarray(Asp @ rng.standard_normal(Agen.shape[0]))
    sv = SparseSolver()
    t0 = time.perf_counter()
    _, rg1 = sv.solve(Agen, bgen, method="direct")
    ok1 = bool(rg1.converged)
    t_first = time.perf_counter() - t0
    t_rep = wall_time(lambda: sv.solve(Agen, bgen, method="direct")[0],
                      warmup=1, iters=3)
    extra.update({
        "general_direct_n": int(Agen.shape[0]),
        "general_direct_first_solve_s": t_first,
        "general_direct_repeat_ms": t_rep * 1e3,
        "general_direct_converged": ok1,
        "general_direct_rel_residual": float(rg1.residual),
    })
    del Agen, bgen, Asp

    _progress("block cg")
    from tpu_sparse.solvers import batch_cg, block_cg

    jax.config.update("jax_enable_x64", False)
    Ab = generators.poisson2d(96, dtype=np.float32)  # n=9216
    Bb = jnp.asarray(rng.standard_normal((Ab.shape[0], 8)).astype(np.float32))
    fblk = jax.jit(lambda a, bb: block_cg(a, bb, tol=1e-5, maxiter=2000))
    fbat = jax.jit(lambda a, bb: batch_cg(a, bb, tol=1e-5, maxiter=2000))
    t_blk = wall_time(fblk, Ab, Bb, warmup=1, iters=3)
    t_bat = wall_time(fbat, Ab, Bb, warmup=1, iters=3)
    _, inf_b, it_blk, _ = fblk(Ab, Bb)
    extra.update({
        "block_cg_8rhs_ms": t_blk * 1e3,
        "block_cg_8rhs_iters": int(it_blk),
        "block_cg_8rhs_converged": bool(jnp.all(inf_b == 0)),
        "block_cg_vs_batch_cg": t_bat / t_blk,
    })
    del Ab, Bb

    _progress("cg 110M")
    # --- >100M-nnz 27-pt CG time-to-tol ---
    from tpu_sparse.precond.amg import amg_preconditioner
    from tpu_sparse.solvers import bicgstab_full, cg_full, gmres_full

    Abig = generators.poisson3d_27pt(160, dtype=np.float32)
    xb = jnp.asarray(rng.standard_normal(Abig.shape[0]).astype(np.float32))
    bb = Abig @ xb
    gbig = jax.jit(lambda a, rhs: cg_full(a, rhs, tol=1e-6, maxiter=500))
    t_big = wall_time(gbig, Abig, bb, warmup=1, iters=3)
    _, info_b, it_b, _ = gbig(Abig, bb)
    sbig = SparseSolver()
    t_router = wall_time(
        lambda: sbig.solve(Abig, bb, method="cg", tol=1e-6,
                           maxiter=500)[0], warmup=1, iters=3)
    _, r_router = sbig.solve(Abig, bb, method="cg", tol=1e-6, maxiter=500)
    extra.update({
        "cg_110M_nnz": int(Abig.nnz),
        "cg_110M_ms": t_big * 1e3,
        "cg_110M_iters": int(it_b),
        "cg_110M_converged": bool(int(info_b) == 0),
        "cg_110M_gnnz_per_s_effective": Abig.nnz * int(it_b) / t_big / 1e9,
        "cg_110M_router_ms": t_router * 1e3,
        "cg_110M_router_converged": bool(r_router.converged),
    })
    extra["cg_110M_peak_mb"] = device_peak_memory_mb()

    _progress("amg-pcg 110M")
    t0 = time.perf_counter()
    Mamg = amg_preconditioner(Abig, smoother="chebyshev",
                              pre_sweeps=2, post_sweeps=2)
    t_setup_amg = time.perf_counter() - t0
    gam = jax.jit(lambda a, rhs, m: cg_full(a, rhs, tol=1e-6, maxiter=200,
                                            M=m))
    t_amg = wall_time(lambda: gam(Abig, bb, Mamg), warmup=1, iters=3)
    _, info_a, it_a, _ = gam(Abig, bb, Mamg)
    extra.update({
        "amg_pcg_110M_setup_s": t_setup_amg,
        "amg_pcg_110M_ms": t_amg * 1e3,
        "amg_pcg_110M_iters": int(it_a),
        "amg_pcg_110M_converged": bool(int(info_a) == 0),
    })
    del Mamg, Abig, bb

    _progress("amg aniso")
    # --- stiff anisotropic system (eps=1e-3): plain CG needs thousands of
    # iterations; aggressive coarsening keeps the AMG hierarchy short ---
    Aan = generators.poisson2d_anisotropic(2048, eps=1e-3, dtype=np.float32)
    ban = jnp.asarray(rng.standard_normal(Aan.shape[0]).astype(np.float32))
    sva = SparseSolver()
    t_cg_an = wall_time(
        lambda: sva.solve(Aan, ban, method="cg", tol=1e-5,
                          maxiter=20000)[0], warmup=1, iters=3)
    _, r_an = sva.solve(Aan, ban, method="cg", tol=1e-5, maxiter=20000)
    t0 = time.perf_counter()
    Man = amg_preconditioner(Aan, smoother="chebyshev", pre_sweeps=2,
                             post_sweeps=2, aggressive=1)
    t_setup_an = time.perf_counter() - t0
    gan = jax.jit(lambda a, rhs, m: cg_full(a, rhs, tol=1e-5, maxiter=500,
                                            M=m))
    t_amg_an = wall_time(lambda: gan(Aan, ban, Man), warmup=1, iters=3)
    _, info_an, it_an, _ = gan(Aan, ban, Man)
    extra.update({
        "aniso_n": int(Aan.shape[0]),
        "aniso_cg_ms": t_cg_an * 1e3,
        "aniso_cg_iters": r_an.iterations,
        "aniso_amg_setup_s": t_setup_an,
        "aniso_amg_pcg_ms": t_amg_an * 1e3,
        "aniso_amg_pcg_iters": int(it_an),
        "aniso_amg_pcg_converged": bool(int(info_an) == 0),
    })
    del Aan, ban, Man

    _progress("bicgstab/gmres 110M")
    Acd = generators.convection_diffusion_3d_27pt(160, dtype=np.float32)
    bcd = Acd @ xb
    gbi = jax.jit(lambda a, rhs: bicgstab_full(a, rhs, tol=1e-6,
                                               maxiter=500))
    t_bi = wall_time(gbi, Acd, bcd, warmup=1, iters=3)
    _, inf_bi, it_bi, _ = gbi(Acd, bcd)
    ggm = jax.jit(lambda a, rhs: gmres_full(a, rhs, tol=1e-6, restart=20,
                                            maxiter=500))
    t_gm = wall_time(ggm, Acd, bcd, warmup=1, iters=3)
    _, inf_g, it_g, _ = ggm(Acd, bcd)
    extra.update({
        "bicgstab_110M_ms": t_bi * 1e3,
        "bicgstab_110M_iters": int(it_bi),
        "bicgstab_110M_converged": bool(int(inf_bi) == 0),
        "gmres_110M_ms": t_gm * 1e3,
        "gmres_110M_restarts": int(it_g),
        "gmres_110M_converged": bool(int(inf_g) == 0),
    })
    del Acd, bcd, xb

    _progress("f64 spmv and router")
    # --- f64 (the reference's default dtype, torch_sparse_linalg.py:57-58)
    jax.config.update("jax_enable_x64", True)
    A64 = generators.poisson3d_27pt(64, dtype=np.float64)
    v64 = jnp.asarray(rng.standard_normal(A64.shape[0]))
    s64 = np.float64(1.0 / 27.0)
    dt64 = per_iter_time(lambda y: spmv(A64, y) * s64, v64, K1=10, K2=110)
    b64 = A64 @ v64
    s_64 = SparseSolver()
    t_auto = wall_time(lambda: s_64.solve(A64, b64, method="cg", tol=1e-8,
                                          maxiter=3000)[0],
                       warmup=1, iters=3)
    _, r_a = s_64.solve(A64, b64, method="cg", tol=1e-8, maxiter=3000)
    t_full = wall_time(lambda: s_64.solve(A64, b64, method="cg", tol=1e-8,
                                          maxiter=3000,
                                          precision="full")[0],
                       warmup=1, iters=3)
    extra.update({
        "spmv_f64_n": int(A64.shape[0]),
        "spmv_f64_gnnz_per_s": A64.nnz / dt64 / 1e9,
        "router_f64_auto_ms": t_auto * 1e3,
        "router_f64_auto_converged": bool(r_a.converged),
        "router_f64_full_ms": t_full * 1e3,
    })
    del A64, v64, b64

    _progress("ldc e2e")
    # --- end-to-end application: lid-driven-cavity CFD (the reference's
    # own e2e demo, SURVEY.md §3.5); steps/s includes momentum, BCs,
    # pressure CG and correction ---
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "examples", "ldc"))
    from ldc_solver import LDCConfig, LDCSolver

    sim = LDCSolver(LDCConfig(nx=100, Re=400.0, solver="cg",
                              precond="jacobi", tol=1e-8, dt=0.01))
    sim.run(20, chunk=20)  # warmup/compile
    out_ldc = sim.run(100, chunk=100)
    extra.update({
        "ldc_nx100_steps_per_s": out_ldc["steps_per_s"],
        "ldc_nx100_mass_residual": out_ldc["mass_residual"],
    })
    jax.config.update("jax_enable_x64", False)

    out = {
        "metric": "spmv_27pt_poisson3d_gnnz_per_s",
        "value": gnnz,
        "unit": "Gnnz/s",
        "vs_baseline": frac,
        "device": device,
        "extra": extra,
    }
    with open(_FULL_PATH, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
