"""Weak-scaling measurement for the distributed halo-exchange SpMV/CG.

nnz/s scaling efficiency from 1 card to N devices on a 27-point 3-D
Poisson system. On several GPUs this measures the halo exchange over
NVLink; on a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=N, with --cpu) it
validates the mechanics and communication volume, not absolute bandwidth.

Usage:
  python bench_tools/scaling.py --mode halo --devices 1 2 4
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python bench_tools/scaling.py --cpu --devices 1 2 4 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--mode", default="halo", choices=["halo", "gspmd"])
    ap.add_argument("--nx-per-device", type=int, default=48,
                    help="weak scaling: grid grows with device count")
    ap.add_argument("--cpu", action="store_true",
                    help="force the virtual CPU mesh")
    args = ap.parse_args(argv)

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from tpu_sparse.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    import numpy as np

    from tpu_sparse.dist import make_row_mesh, distributed_matvec_op
    from tpu_sparse.dist.partition import shard_vector
    from tpu_sparse.sparse import generators
    from tpu_sparse.utils.timing import per_iter_time

    results = []
    base_rate = None
    for nd in args.devices:
        if nd > jax.device_count():
            print(f"skip {nd} devices (have {jax.device_count()})")
            continue
        # weak scaling: constant work per device (grow z extent)
        nx = args.nx_per_device
        nz = nx * nd
        A = generators.poisson3d_27pt(nx, nx, nz, dtype=np.float32)
        mesh = make_row_mesh(nd)
        A_sh, matvec = distributed_matvec_op(A, mesh, args.mode)
        import jax.numpy as jnp

        v = shard_vector(
            jnp.asarray(np.random.default_rng(0)
                        .standard_normal(A.shape[0]).astype(np.float32)),
            mesh)
        scale = np.float32(1.0 / 27.0)
        dt = per_iter_time(lambda y: matvec(y) * scale, v, K1=3, K2=23)
        rate = A.nnz / dt / 1e9
        if base_rate is None:
            base_rate = rate / nd  # per-device rate at the first size
        eff = rate / (base_rate * nd)
        results.append({"devices": nd, "n": A.shape[0], "nnz": A.nnz,
                        "us_per_spmv": round(dt * 1e6, 1),
                        "gnnz_per_s": round(rate, 2),
                        "weak_scaling_efficiency": round(eff, 3)})
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
