#!/usr/bin/env python3
"""One process of a multi-controller (multi-host) validation run.

Validates the DCN/multi-host path that the reference cannot express at
all (SURVEY.md §2.3: the reference is strictly single-device): a real
``jax.distributed`` cluster of N processes, each owning a slice of the
global device mesh, running the SAME distributed solvers used on a
single host. Here the "hosts" are processes with 4 virtual CPU devices
each, connected through the gRPC coordination service — the same control
plane a multi-host GPU cluster uses, minus the interconnect bandwidth.

Launched by tests/test_multihost.py (and usable standalone):

    python bench_tools/multihost_worker.py \
        --coordinator localhost:9876 --num-processes 2 --process-id 0

Each process prints one JSON line with the solve stats; the launcher
asserts both processes converge and agree bitwise on the solution.
"""

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--nx", type=int, default=16)
    args = ap.parse_args()

    # Device count must be fixed before the backend initializes.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.local_devices}"
    ).strip()

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tpu_sparse.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

    import numpy as np

    from tpu_sparse.dist import distributed_cg, initialize_multihost
    from tpu_sparse.dist.mesh import make_row_mesh
    from tpu_sparse.sparse import generators

    initialize_multihost(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    n_global = jax.device_count()
    n_local = len(jax.local_devices())
    assert n_global == args.num_processes * args.local_devices, (
        n_global, args.num_processes, args.local_devices)

    mesh = make_row_mesh()

    # Every controller builds the same global operands (multi-controller
    # SPMD: identical programs, device_put fills only addressable shards).
    A = generators.poisson3d_27pt(args.nx, dtype=np.float32)
    rng = np.random.default_rng(7)
    x_true = rng.standard_normal(A.shape[0]).astype(np.float32)
    b = A @ x_true

    results = {}
    for mode in ("gspmd", "halo"):
        x, info, iters, res = distributed_cg(A, b, mesh=mesh, mode=mode,
                                             tol=1e-6)
        from jax.experimental import multihost_utils

        x_np = np.asarray(multihost_utils.process_allgather(x, tiled=True))
        rel = float(np.linalg.norm(np.asarray(b) - A @ x_np)
                    / np.linalg.norm(np.asarray(b)))
        results[mode] = {
            "info": int(info),
            "iters": int(iters),
            "rel_residual": rel,
            # digest lets the launcher check bitwise cross-process and
            # cross-mode-determinism agreement
            "x_crc": int(np.frombuffer(
                x_np.tobytes(), dtype=np.uint32).sum(dtype=np.uint64)),
        }

    # General-structure path across processes: the halo plan is
    # computed from the PRE-SHARD host pack (partition.shard_general_planned)
    # — every controller derives it identically, so the multi-process mesh
    # gets cut-volume ppermute exchange, not all_gather. Record the
    # resolved mode so the launcher can assert cwell_halo engaged.
    from tpu_sparse.dist.solvers import _shard_and_resolve
    from tpu_sparse.sparse.convert import to_csr

    Ag = to_csr(A)
    _, gmode = _shard_and_resolve(Ag, mesh, "gspmd")
    xg, infog, itersg, resg = distributed_cg(Ag, b, mesh=mesh,
                                             mode="gspmd", tol=1e-6)
    from jax.experimental import multihost_utils

    xg_np = np.asarray(multihost_utils.process_allgather(xg, tiled=True))
    relg = float(np.linalg.norm(np.asarray(b) - A @ xg_np)
                 / np.linalg.norm(np.asarray(b)))
    results["general_csr"] = {
        "info": int(infog),
        "iters": int(itersg),
        "rel_residual": relg,
        "resolved_mode": gmode,
        "x_crc": int(np.frombuffer(
            xg_np.tobytes(), dtype=np.uint32).sum(dtype=np.uint64)),
    }

    # AMG-PCG: host setup runs identically (deterministically) on every
    # controller; the sharded hierarchy rides through jit as a Partial
    # ARGUMENT (dist/solvers._as_pytree_m) — the multi-host-critical path.

    from tpu_sparse.dist.amg import distributed_amg_preconditioner

    M = distributed_amg_preconditioner(A, mesh)
    x, info, iters, res = distributed_cg(A, b, mesh=mesh, mode="gspmd",
                                         tol=1e-6, M=M)
    x_np = np.asarray(multihost_utils.process_allgather(x, tiled=True))
    rel = float(np.linalg.norm(np.asarray(b) - A @ x_np)
                / np.linalg.norm(np.asarray(b)))
    results["amg_pcg"] = {
        "info": int(info),
        "iters": int(iters),
        "rel_residual": rel,
        "x_crc": int(np.frombuffer(
            x_np.tobytes(), dtype=np.uint32).sum(dtype=np.uint64)),
    }

    print(json.dumps({
        "process_id": args.process_id,
        "num_processes": args.num_processes,
        "global_devices": n_global,
        "local_devices": n_local,
        "results": results,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
