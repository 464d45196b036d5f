"""Unified test + benchmark runner CLI.

Capability parity: the reference's src/run.py —
`--test/--benchmark/--all`, `--quick`, `--sizes`, `--runs`, `--quiet`
(run.py:285-366), orchestrating the test suites with availability-based
skipping (:60-167) and the benchmark sweep (:174-278).

Usage:
    python -m tpu_sparse.run --test
    python -m tpu_sparse.run --benchmark --quick
    python -m tpu_sparse.run --all
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List, Optional


def run_tests(quick: bool = False, quiet: bool = False) -> bool:
    """Run the pytest suite (the availability-gated skipping lives inside
    the tests themselves, matching the reference's structure)."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = [sys.executable, "-m", "pytest",
            os.path.join(repo_root, "tests"), "-x"]
    args.append("-q" if quiet else "-v")
    if quick:
        # representative smoke: solver/router/container correctness;
        # the heavy FD-gradient, distributed, mixed-refinement, and
        # application files run in the full mode
        args = args[:3] + [
            os.path.join(repo_root, "tests", f) for f in
            ("test_solvers.py", "test_api.py", "test_sparse.py",
             "test_direct.py", "test_supernodal.py")
        ] + args[4:]
    proc = subprocess.run(args, cwd=repo_root)
    return proc.returncode == 0


def run_benchmarks(quick: bool = False, sizes: Optional[List[int]] = None,
                   runs: int = 3, quiet: bool = False,
                   precision: str = "full") -> None:
    from tpu_sparse.bench.harness import (
        BenchmarkConfig,
        generate_markdown_report,
        run_all_benchmarks,
    )
    import jax

    from tpu_sparse.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    jax.config.update("jax_enable_x64", True)
    if quick:
        config = BenchmarkConfig(
            sizes=sizes or [100], matrix_types=("tridiagonal", "poisson2d"),
            backends=("krylov", "direct"), methods=("cg",), runs=1,
            warmup=1, precision=precision, verbose=not quiet)
    else:
        config = BenchmarkConfig(
            sizes=sizes or [100, 200, 500], runs=runs, precision=precision,
            verbose=not quiet)
    results = run_all_benchmarks(config)
    path = generate_markdown_report(results, config)
    ok = sum(1 for r in results if r.converged)
    print(f"{ok}/{len(results)} benchmark cells converged; report: {path}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="tpu_sparse unified test/benchmark runner")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--benchmark", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sizes", type=int, nargs="+", default=None)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--precision", default="full",
                    choices=["full", "mixed"])
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if not (args.test or args.benchmark or args.all):
        ap.print_help()
        return 2

    ok = True
    if args.test or args.all:
        ok = run_tests(quick=args.quick, quiet=args.quiet)
    if args.benchmark or args.all:
        run_benchmarks(quick=args.quick, sizes=args.sizes, runs=args.runs,
                       quiet=args.quiet, precision=args.precision)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
