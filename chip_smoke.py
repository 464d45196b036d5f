#!/usr/bin/env python3
"""Smoke test of the solver stack on one NVIDIA GPU.

Drives the main path through the public entry points at sizes a user of
a sparse solver would call real, and checks every result against an
independent host reference (scipy, float64):

  1. device      — the card's name and power limit; refuses anything but a GPU
  2. DIA SpMV    — kernels.spmv on the 27-point Poisson operator at 160³
                   (4.1M rows, 110M nnz) in f32 and f64 vs scipy CSR
  3. Krylov      — solve(): CG at 160³ in f32 and f64 (precision 'full'
                   and 'auto'); BiCGStab and GMRES(20) at 96³ in f32 and f64
  4. AMG-PCG     — solve(method='amg') on the 1024² 5-point Poisson, f64
  5. direct      — solve(method='direct'): tridiagonal 2^20 (banded path)
                   and the 256² Poisson as general CSR (host SuperLU)
  6. gradient    — jax.grad through solve() vs a central finite difference
  7. application — the lid-driven-cavity example, 128², 50 steps, f64

With ``--cards 4`` it runs only the distributed path on four cards:
distributed CG (halo and gspmd SpMV) and distributed AMG-PCG at 160³ in
f32, each compared with the single-card solve on card 0.

Any failed check raises, and the script exits non-zero. The last line of
standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Run:  python chip_smoke.py            (one card)
      python chip_smoke.py --cards 4  (four cards)
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def log(msg):
    print(msg, flush=True)


def report(phase, **fields):
    log(f"[{phase}] " + json.dumps(fields))


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def nvidia_smi():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def host_csr(A):
    """scipy CSR (f64) of a DIA matrix, built from its diagonals: the
    reference SpMV, independent of the library's kernels."""
    import scipy.sparse as sp

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


def true_rel(S, b, x):
    """‖b − A x‖ / ‖b‖ in f64 on the host."""
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(b - S @ np.asarray(x, dtype=np.float64))
                 / np.linalg.norm(b))


def timed(fn):
    """(result, seconds) with the device work finished inside the clock."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def phase_device(cards):
    import jax

    log("nvidia-smi: " + nvidia_smi())
    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"chip_smoke needs a GPU; JAX found {dev.platform}")
    check(len(jax.devices()) >= cards,
          f"need {cards} cards, JAX found {len(jax.devices())}")
    report("device", platform=dev.platform, kind=dev.device_kind,
           count=len(jax.devices()))
    return dev


def phase_spmv(nx):
    import jax.numpy as jnp

    from tpu_sparse.kernels import spmv
    from tpu_sparse.sparse import generators
    from tpu_sparse.utils.timing import copy_bandwidth_gbs, per_iter_time

    copy = copy_bandwidth_gbs()
    A64 = generators.poisson3d_27pt(nx, dtype=np.float64)
    S = host_csr(A64)
    x = np.random.default_rng(0).standard_normal(A64.shape[0])
    y_ref = S @ x
    out = {"n": A64.shape[0], "nnz": int(S.nnz), "copy_gbs": copy}
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        A = A64 if dt == np.float64 else A64.with_data(
            A64.data.astype(jnp.float32))
        xd = jnp.asarray(x.astype(dt))
        y = np.asarray(spmv(A, xd), dtype=np.float64)
        err = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
        check(err <= tol, f"SpMV {dt.__name__} error {err} > {tol}")
        scale = dt(1.0 / 27.0)
        sec = per_iter_time(lambda v: spmv(A, v) * scale, xd)
        nbytes = A.data.size * A.data.dtype.itemsize \
            + 2 * A.shape[0] * xd.dtype.itemsize
        name = np.dtype(dt).name
        out.update({f"{name}_err": err, f"{name}_us": sec * 1e6,
                    f"{name}_gbs": nbytes / sec / 1e9,
                    f"{name}_frac_of_copy": nbytes / sec / 1e9 / copy})
    report("spmv", **out)
    return A64, S


def _solve_case(A, S, b, tol, bound, label, **kw):
    """One router solve, compiled then timed, checked in f64 on the host."""
    from tpu_sparse import solve

    _, t_first = timed(lambda: solve(A, b, tol=tol, **kw)[0])
    (x, r), t = timed(lambda: solve(A, b, tol=tol, **kw))
    rel = true_rel(S, b, x)
    check(r.converged, f"{label}: not converged ({r})")
    check(rel <= bound * tol, f"{label}: true residual {rel} > {bound}*{tol}")
    return {"label": label, "iters": r.iterations, "true_rel": rel,
            "solve_s": t, "first_call_s": t_first}


def phase_krylov(A64, S64, nx_small):
    import jax.numpy as jnp

    from tpu_sparse.sparse import generators

    rng = np.random.default_rng(1)
    A32 = A64.with_data(A64.data.astype(jnp.float32))
    b64 = S64 @ rng.standard_normal(A64.shape[0])
    b32 = b64.astype(np.float32)
    rows = [
        _solve_case(A32, S64, jnp.asarray(b32), 1e-6, 2.0, "cg_f32",
                    method="cg", maxiter=2000),
        _solve_case(A64, S64, jnp.asarray(b64), 1e-8, 1.05, "cg_f64_full",
                    method="cg", maxiter=4000, precision="full"),
        _solve_case(A64, S64, jnp.asarray(b64), 1e-8, 1.05, "cg_f64_auto",
                    method="cg", maxiter=4000, precision="auto"),
    ]
    As64 = generators.poisson3d_27pt(nx_small, dtype=np.float64)
    Ss = host_csr(As64)
    bs64 = Ss @ rng.standard_normal(As64.shape[0])
    for dt, tol, bound in ((np.float32, 1e-6, 2.0), (np.float64, 1e-8, 1.05)):
        As = As64.with_data(As64.data.astype(dt))
        bs = jnp.asarray(bs64.astype(dt))
        name = np.dtype(dt).name
        rows.append(_solve_case(As, Ss, bs, tol, bound, f"bicgstab_{name}",
                                method="bicgstab", maxiter=2000,
                                precision="full"))
        rows.append(_solve_case(As, Ss, bs, tol, bound, f"gmres20_{name}",
                                method="gmres", restart=20, maxiter=500,
                                precision="full"))
    for row in rows:
        report("krylov", **row)


def phase_amg(nx):
    import jax.numpy as jnp

    from tpu_sparse.precond import amg_preconditioner
    from tpu_sparse.sparse import generators

    A = generators.poisson2d(nx, dtype=np.float64)
    S = host_csr(A)
    b = jnp.asarray(S @ np.random.default_rng(2).standard_normal(A.shape[0]))
    t0 = time.perf_counter()
    amg_preconditioner(A)
    t_setup = time.perf_counter() - t0
    row = _solve_case(A, S, b, 1e-8, 1.05, "amg_pcg_f64", method="amg",
                      maxiter=200)
    report("amg", n=A.shape[0], setup_s=t_setup, **row)


def phase_direct(n_tri, nx_general):
    import jax.numpy as jnp

    from tpu_sparse import solve
    from tpu_sparse.sparse import generators
    from tpu_sparse.sparse.convert import to_csr

    rng = np.random.default_rng(3)
    cases = (("tridiagonal", generators.tridiagonal(n_tri)),
             ("general_csr", to_csr(generators.poisson2d(nx_general))))
    for label, A in cases:
        S = host_csr(A) if label == "tridiagonal" else None
        if S is None:
            import scipy.sparse as sp

            S = sp.csr_matrix((np.asarray(A.data), np.asarray(A.indices),
                               np.asarray(A.indptr)), shape=A.shape)
        b = jnp.asarray(S @ rng.standard_normal(A.shape[0]))
        _, t_first = timed(lambda: solve(A, b, method="direct")[0])
        (x, r), t = timed(lambda: solve(A, b, method="direct"))
        rel = true_rel(S, b, x)
        check(rel <= 1e-10, f"direct {label}: true residual {rel}")
        check(r.converged, f"direct {label}: not converged")
        report("direct", label=label, n=A.shape[0], true_rel=rel,
               solve_s=t, first_call_s=t_first)


def phase_gradient(nx):
    import jax
    import jax.numpy as jnp

    from tpu_sparse import solve
    from tpu_sparse.sparse import generators

    A = generators.poisson3d_27pt(nx, dtype=np.float64)
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.standard_normal(A.shape[0]))
    d = jnp.asarray(rng.standard_normal(A.shape[0]))

    def loss(bb):
        x = solve(A, bb, method="cg", tol=1e-12, maxiter=2000,
                  precision="full")[0]
        return 0.5 * jnp.sum(x * x)

    g = jax.grad(loss)(b)
    h = 1e-3 * float(jnp.linalg.norm(b) / jnp.linalg.norm(d))
    fd = float((loss(b + h * d) - loss(b - h * d)) / (2 * h))
    ad = float(jnp.vdot(g, d))
    rel = abs(ad - fd) / abs(fd)
    check(rel <= 1e-5, f"gradient vs finite difference: rel {rel}")
    report("gradient", n=A.shape[0], directional_ad=ad, directional_fd=fd,
           rel=rel)


def phase_application(nx, steps):
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "examples", "ldc"))
    from ldc_solver import LDCConfig, LDCSolver

    sim = LDCSolver(LDCConfig(nx=nx, solver="cg", precond="jacobi",
                              tol=1e-8))
    out = sim.run(steps, chunk=steps)
    check(out["mass_residual"] < 1e-7,
          f"LDC mass residual {out['mass_residual']}")
    report("application", nx=nx, **out)


def phase_four_cards(nx):
    """Distributed CG (halo, gspmd) and distributed AMG-PCG on four cards
    vs the single-card solve on card 0."""
    import jax
    import jax.numpy as jnp

    from tpu_sparse.dist import distributed_cg, make_row_mesh
    from tpu_sparse.dist.amg import distributed_amg_preconditioner
    from tpu_sparse.precond import amg_preconditioner
    from tpu_sparse.solvers import cg_full
    from tpu_sparse.sparse import generators

    devs = jax.devices()[:4]
    mesh = make_row_mesh(devices=devs)
    A = generators.poisson3d_27pt(nx, dtype=np.float32)
    S = host_csr(A)
    b = jnp.asarray((S @ np.random.default_rng(5).standard_normal(
        A.shape[0])).astype(np.float32))
    tol, maxiter = 1e-6, 2000

    def single(M=None):
        f = jax.jit(lambda a, bb, m: cg_full(a, bb, tol=tol, maxiter=maxiter,
                                             M=m))
        f(A, b, M)
        return timed(lambda: f(A, b, M))

    def compare(label, single_out, dist_fn):
        (x1, info1, it1, _), t1 = single_out
        dist_fn()  # compile
        (xd, infod, itd, _), td = timed(dist_fn)
        # on the host: the two solutions live on different device sets
        x1n, xdn = np.asarray(x1, np.float64), np.asarray(xd, np.float64)
        rel_x = float(np.linalg.norm(xdn - x1n) / np.linalg.norm(x1n))
        check(int(info1) == 0 and int(infod) == 0, f"{label}: not converged")
        check(abs(int(itd) - int(it1)) <= 2,
              f"{label}: iterations {int(itd)} vs single-card {int(it1)}")
        check(rel_x <= 1e-5, f"{label}: solutions differ by {rel_x}")
        report("four_cards", label=label, iters=int(itd),
               single_iters=int(it1), rel_x=rel_x, solve_s=td,
               single_solve_s=t1, true_rel=true_rel(S, b, xd))

    base = single()
    for mode in ("halo", "gspmd"):
        compare(f"cg_{mode}", base, lambda: distributed_cg(
            A, b, mesh=mesh, mode=mode, tol=tol, maxiter=maxiter))
    t0 = time.perf_counter()
    Md = distributed_amg_preconditioner(A, mesh)
    t_setup = time.perf_counter() - t0
    M1 = amg_preconditioner(A)
    compare("amg_pcg_halo", single(M1), lambda: distributed_cg(
        A, b, mesh=mesh, mode="halo", tol=tol, maxiter=maxiter, M=Md))
    peaks = {str(d.id): (d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devs}
    report("four_cards", amg_setup_s=t_setup, peak_bytes_per_card=peaks)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card distributed phase")
    args = ap.parse_args(argv)

    import jax

    from tpu_sparse.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    jax.config.update("jax_enable_x64", True)
    dev = phase_device(args.cards)
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_four_cards(160)
    else:
        A64, S64 = phase_spmv(160)
        phase_krylov(A64, S64, 96)
        del A64, S64
        phase_amg(1024)
        phase_direct(1 << 20, 256)
        phase_gradient(64)
        phase_application(128, 50)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
