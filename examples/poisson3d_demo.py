"""Demo: large 27-point 3-D Poisson solves on the GPU.

Runs the BASELINE.json target workload — CG on a >100M-nnz 27-point 3-D
Poisson system — on whatever device is available, reporting time-to-
tolerance and effective nnz/s. `--distributed` row-shards the system over
all local devices with halo-exchange SpMV.

  python examples/poisson3d_demo.py --nx 160          # 110M nnz, 1 card
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/poisson3d_demo.py --nx 48 --distributed --cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=160,
                    help="grid edge; n = nx^3 (160 -> 110M nnz)")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from tpu_sparse.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from tpu_sparse.sparse import generators
    from tpu_sparse.utils.timing import force

    t0 = time.time()
    A = generators.poisson3d_27pt(args.nx, dtype=np.float32)
    n = A.shape[0]
    print(f"operator: 27-pt Poisson  n={n:,}  nnz={A.nnz:,}  "
          f"built in {time.time() - t0:.1f}s on "
          f"{jax.default_backend()} x{jax.device_count()}")

    rng = np.random.default_rng(0)
    x_true = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    b = A @ x_true

    if args.distributed:
        from tpu_sparse.dist import distributed_cg, make_row_mesh

        mesh = make_row_mesh()
        # warm: compile + shard before timing (match the single-device path)
        force(distributed_cg(A, b, mesh=mesh, mode="halo", tol=args.tol,
                             maxiter=args.maxiter)[0])
        t0 = time.time()
        x, info, iters, res = distributed_cg(
            A, b, mesh=mesh, mode="halo", tol=args.tol,
            maxiter=args.maxiter)
        force(x)
        dt = time.time() - t0
        label = f"distributed CG over {mesh.devices.size} devices"
    else:
        from tpu_sparse.solvers import cg_full

        g = jax.jit(lambda a, rhs: cg_full(a, rhs, tol=args.tol,
                                           maxiter=args.maxiter))
        force(g(A, b))  # compile + warm
        t0 = time.time()
        out = g(A, b)
        force(out)
        dt = time.time() - t0
        x, info, iters, res = out
        label = "single-device CG"

    rel = float(res) / float(jnp.linalg.norm(b))
    err = float(jnp.max(jnp.abs(x - x_true)))
    print(f"{label}: {'converged' if int(info) == 0 else 'NOT converged'} "
          f"in {int(iters)} iterations, {dt*1e3:.0f} ms")
    print(f"  rel residual {rel:.2e}   max|x - x_true| {err:.2e}")
    print(f"  effective {A.nnz * int(iters) / dt / 1e9:.1f} Gnnz/s "
          f"through the full CG")
    return 0 if int(info) == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
