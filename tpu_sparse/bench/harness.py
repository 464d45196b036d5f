"""Benchmark harness with markdown/CSV reports.

Capability parity: the reference's tests/benchmark.py —
`BenchmarkConfig` (:68-81), `BenchmarkResult` (:54-65),
`run_single_benchmark` (:149-273) with warmup + multi-run timing,
`run_all_benchmarks` sweep (:275-319), markdown report generation with
system info / per-size tables / cross-backend comparison (:369-546), CSV
export (:350-367) and the CLI (:549-610).

Measurement notes: timing uses `jax.block_until_ready`; per-call
dispatch latency can exceed small kernels, so each measurement jits the
whole solve as one program and runs ``runs`` timed repetitions, reporting
the median.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime
import json
import os
import platform
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class BenchmarkConfig:
    """Mirror of reference BenchmarkConfig (benchmark.py:68-81)."""

    sizes: Sequence[int] = (100, 200, 500)
    matrix_types: Sequence[str] = ("tridiagonal", "poisson2d", "dense_spd")
    backends: Sequence[str] = ("krylov", "amg", "direct")
    methods: Sequence[str] = ("cg", "bicgstab", "gmres")
    tol: float = 1e-8
    maxiter: int = 1000
    runs: int = 3
    warmup: int = 1
    precision: str = "full"  # 'full' (f64) | 'mixed'
    verbose: bool = True


@dataclasses.dataclass
class BenchmarkResult:
    """Mirror of reference BenchmarkResult (benchmark.py:54-65)."""

    backend: str
    method: str
    matrix_type: str
    size: int
    solve_time_ms: float
    residual: float
    converged: bool
    iterations: Optional[int]
    memory_used_mb: Optional[float] = None
    error_message: str = ""


def _live_array_mb() -> Optional[float]:
    """Client-side accounting of live jax.Array bytes on the default
    device — a lower bound (excludes XLA temporaries) used when the
    runtime does not expose allocator stats (memory_stats() returns
    None on the CPU backend)."""
    try:
        dev = jax.local_devices()[0]
        total = 0
        for a in jax.live_arrays():
            if dev in getattr(a.sharding, "device_set", ()):
                total += a.nbytes
        return float(total) / (1024.0 * 1024.0)
    except Exception:
        return None


def _device_memory_mb() -> Optional[float]:
    """Current device bytes-in-use in MB (parity with the reference's
    `_get_memory_usage_mb`, benchmark.py:142-146, which reads
    `torch.cuda.memory_allocated`); falls back to live-array accounting
    when the runtime hides allocator stats."""
    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats and "bytes_in_use" in stats:
            return float(stats["bytes_in_use"]) / (1024.0 * 1024.0)
    except Exception:
        pass
    return _live_array_mb()


def device_peak_memory_mb() -> Optional[float]:
    """Peak device bytes-in-use in MB since process start, if the
    allocator exposes it; else current live-array total (lower bound)."""
    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats and "peak_bytes_in_use" in stats:
            return float(stats["peak_bytes_in_use"]) / (1024.0 * 1024.0)
    except Exception:
        pass
    return _live_array_mb()


def _create_matrix(matrix_type: str, n: int):
    """Deterministic matrices (reference `_create_matrix`,
    benchmark.py:103-140)."""
    from tpu_sparse.sparse import generators

    if matrix_type == "tridiagonal":
        return generators.tridiagonal(n)
    if matrix_type == "poisson2d":
        nx = max(2, int(round(n ** 0.5)))
        return generators.poisson2d(nx)
    if matrix_type == "poisson3d_27pt":
        nx = max(2, int(round(n ** (1.0 / 3.0))))
        return generators.poisson3d_27pt(nx, dtype=np.float64)
    if matrix_type == "dense_spd":
        return generators.random_spd_dense(n, seed=n)
    raise ValueError(f"unknown matrix type: {matrix_type}")


def run_single_benchmark(backend: str, method: str, matrix_type: str,
                         size: int, config: BenchmarkConfig
                         ) -> BenchmarkResult:
    """One (backend, method, matrix, size) cell with warmup + median timing
    (reference benchmark.py:149-273)."""
    from tpu_sparse.api.solver import SparseSolver

    try:
        A = _create_matrix(matrix_type, size)
        n = A.shape[0]
        rng = np.random.default_rng(0)
        x_true = jnp.asarray(rng.standard_normal(n))
        from tpu_sparse.kernels import spmv

        b = spmv(A, x_true) if not hasattr(A, "ndim") else A @ x_true

        solver = SparseSolver()
        kwargs = dict(method=method, backend=backend, tol=config.tol,
                      maxiter=config.maxiter)
        if backend == "krylov":
            kwargs["precision"] = config.precision

        def run():
            x, result = solver.solve(A, b, **kwargs)
            jax.block_until_ready(x)
            return x, result

        mem_before = _device_memory_mb()
        for _ in range(config.warmup):
            x, result = run()
        times = []
        for _ in range(config.runs):
            t0 = time.perf_counter()
            x, result = run()
            times.append(time.perf_counter() - t0)
        mem_after = _device_memory_mb()
        memory_used_mb = (round(mem_after - mem_before, 2)
                          if mem_before is not None and mem_after is not None
                          else None)

        return BenchmarkResult(
            backend=backend, method=method, matrix_type=matrix_type,
            size=size, solve_time_ms=float(np.median(times)) * 1e3,
            residual=float(result.residual), converged=bool(result.converged),
            iterations=result.iterations, memory_used_mb=memory_used_mb,
        )
    except Exception as exc:  # error capture (reference :249-260)
        return BenchmarkResult(
            backend=backend, method=method, matrix_type=matrix_type,
            size=size, solve_time_ms=float("nan"), residual=float("nan"),
            converged=False, iterations=None, error_message=str(exc)[:300],
        )


def run_all_benchmarks(config: BenchmarkConfig) -> List[BenchmarkResult]:
    """Sweep sizes × types × backends × methods (reference :275-319).
    Method/backend combinations are filtered for validity."""
    results = []
    for matrix_type in config.matrix_types:
        for size in config.sizes:
            for backend in config.backends:
                methods = {
                    "krylov": [m for m in config.methods
                               if m in ("cg", "fcg", "minres", "bicgstab",
                                        "gmres", "fgmres")],
                    "amg": ["amg"],
                    "direct": ["direct"],
                }[backend]
                for method in methods:
                    if config.verbose:
                        print(f"  bench {backend}/{method} "
                              f"{matrix_type} n={size} ...", flush=True)
                    r = run_single_benchmark(backend, method, matrix_type,
                                             size, config)
                    if config.verbose:
                        status = ("ERR " + r.error_message[:60]
                                  if r.error_message else
                                  f"{r.solve_time_ms:.2f} ms "
                                  f"conv={r.converged}")
                        print(f"    -> {status}", flush=True)
                    results.append(r)
    return results


def _system_info() -> Dict[str, str]:
    return {
        "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "devices": str(jax.device_count()),
        "x64": str(bool(jax.config.jax_enable_x64)),
    }


def generate_markdown_report(results: List[BenchmarkResult],
                             config: BenchmarkConfig,
                             output_dir: str = "Logger") -> str:
    """Timestamped markdown report (reference benchmark.py:369-546):
    system info, availability, per-size tables, best performers."""
    from tpu_sparse.api.availability import availability_dict

    os.makedirs(output_dir, exist_ok=True)
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(output_dir, f"benchmark_report_{ts}.md")

    lines = ["# tpu_sparse benchmark report", ""]
    lines.append("## System")
    lines.append("")
    for k, v in _system_info().items():
        lines.append(f"- **{k}**: {v}")
    lines.append("")
    lines.append("## Capability availability")
    lines.append("")
    for k, v in availability_dict().items():
        lines.append(f"- {k}: {'yes' if v else 'no'}")
    lines.append("")
    lines.append(
        f"## Protocol: tol={config.tol}, maxiter={config.maxiter}, "
        f"{config.runs} runs + {config.warmup} warmup, "
        f"precision={config.precision}")
    lines.append("")

    for matrix_type in config.matrix_types:
        subset = [r for r in results if r.matrix_type == matrix_type]
        if not subset:
            continue
        lines.append(f"## {matrix_type}")
        lines.append("")
        lines.append("| n | backend | method | time (ms) | residual | "
                     "converged | iters | mem (MB) |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for r in sorted(subset, key=lambda r: (r.size, r.backend, r.method)):
            if r.error_message:
                lines.append(
                    f"| {r.size} | {r.backend} | {r.method} | ERROR | | | "
                    f"{r.error_message[:40]} | |")
            else:
                mem = (f"{r.memory_used_mb:.2f}"
                       if r.memory_used_mb is not None else "-")
                lines.append(
                    f"| {r.size} | {r.backend} | {r.method} | "
                    f"{r.solve_time_ms:.2f} | {r.residual:.2e} | "
                    f"{'yes' if r.converged else 'NO'} | "
                    f"{r.iterations if r.iterations is not None else '-'} | "
                    f"{mem} |")
        lines.append("")

    # best performer per (type, size) — reference's comparison table
    lines.append("## Best performers")
    lines.append("")
    lines.append("| matrix | n | fastest | time (ms) |")
    lines.append("|---|---|---|---|")
    seen = {}
    for r in results:
        if r.error_message or not r.converged:
            continue
        key = (r.matrix_type, r.size)
        if key not in seen or r.solve_time_ms < seen[key].solve_time_ms:
            seen[key] = r
    for (mt, size), r in sorted(seen.items()):
        lines.append(f"| {mt} | {size} | {r.backend}/{r.method} | "
                     f"{r.solve_time_ms:.2f} |")
    lines.append("")

    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def export_csv(results: List[BenchmarkResult], path: str) -> str:
    """CSV export (reference benchmark.py:350-367)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([fld.name for fld in
                         dataclasses.fields(BenchmarkResult)])
        for r in results:
            writer.writerow(dataclasses.astuple(r))
    return path


def main(argv: Optional[List[str]] = None) -> None:
    """CLI mirroring reference benchmark.py:549-610."""
    import argparse

    ap = argparse.ArgumentParser(description="tpu_sparse benchmark harness")
    ap.add_argument("--sizes", type=int, nargs="+", default=[100, 200, 500])
    ap.add_argument("--types", nargs="+",
                    default=["tridiagonal", "poisson2d", "dense_spd"])
    ap.add_argument("--backends", nargs="+",
                    default=["krylov", "direct", "amg"])
    ap.add_argument("--methods", nargs="+",
                    default=["cg", "bicgstab", "gmres"])
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--precision", default="full",
                    choices=["full", "mixed"])
    ap.add_argument("--csv", default=None)
    ap.add_argument("--output", default="Logger")
    ap.add_argument("--x64", action="store_true", default=True)
    args = ap.parse_args(argv)

    from tpu_sparse.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    if args.x64:
        jax.config.update("jax_enable_x64", True)

    config = BenchmarkConfig(
        sizes=args.sizes, matrix_types=args.types, backends=args.backends,
        methods=args.methods, tol=args.tol, maxiter=args.maxiter,
        runs=args.runs, precision=args.precision)
    results = run_all_benchmarks(config)
    report = generate_markdown_report(results, config, args.output)
    print(f"report written to {report}")
    if args.csv:
        print(f"csv written to {export_csv(results, args.csv)}")


if __name__ == "__main__":
    main()
