#!/usr/bin/env python3
"""Per-iteration communication volumes of the distributed CG programs.

Runs on the virtual CPU mesh, compiles the distributed CG programs for a
27-point 3-D Poisson system with a per-device slab of nx³ rows, and counts
every collective with its exact byte size from the optimized HLO
(tpu_sparse.dist.comm_model): the stencil (DIA) system in halo mode, and
the same system as general CSR. No time is modeled: collective times come
only from runs on real cards.

Prints ONE JSON line.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python bench_tools/comm_model.py --nx 96
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=96,
                    help="per-device subgrid edge (rows/device = nx^3)")
    ap.add_argument("--general-nx", type=int, default=48,
                    help="per-device slab edge for the general-CSR "
                         "measurement")
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from tpu_sparse.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    import numpy as np
    import jax.numpy as jnp

    from tpu_sparse.dist import make_row_mesh
    from tpu_sparse.dist.comm_model import measure_collectives
    from tpu_sparse.dist.partition import shard_vector
    from tpu_sparse.dist.solvers import _matvec_builder, _shard_and_resolve
    from tpu_sparse.solvers.krylov import cg_full
    from tpu_sparse.solvers.pipelined import cg_sr_full
    from tpu_sparse.sparse import generators
    from tpu_sparse.sparse.convert import to_csr

    n_dev = jax.device_count()
    mesh = make_row_mesh(n_dev)
    out = {"measured_on": f"{n_dev}-device CPU mesh (virtual)",
           "per_device_rows": args.nx ** 3}

    def per_iteration(A, mode, solver):
        A_sh, rmode = _shard_and_resolve(A, mesh, mode)
        b_sh = shard_vector(jnp.ones(A.shape[0], jnp.float32), mesh)

        def run(aa, bb):
            return solver(_matvec_builder(aa, mesh, rmode), bb, None,
                          tol=1e-6, maxiter=100)

        stats = measure_collectives(run, A_sh, b_sh)
        return {"resolved_mode": rmode,
                "per_iteration_collectives":
                    stats.summary(per_iteration=True)}

    nx = args.nx
    A = generators.poisson3d_27pt(nx, nx, nx * n_dev, dtype=np.float32)
    for name, solver in (("cg", cg_full), ("cg_sr", cg_sr_full)):
        out[name] = per_iteration(A, "halo", solver)
    nxg = min(nx, args.general_nx)
    Ag = to_csr(generators.poisson3d_27pt(nxg, nxg, nxg * n_dev,
                                          dtype=np.float32))
    out["cg_general"] = dict(per_iteration(Ag, "gspmd", cg_full),
                             per_device_rows=nxg ** 3)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
