"""Timing and profiling utilities.

The reference's observability is ad-hoc wall timing with cuda.synchronize
(SURVEY.md §5: benchmark.py:238-243, test timings). Equivalents here:

* `force(tree)` — wait for device completion (`jax.block_until_ready`).
* `wall_time(fn, *args)` — per-call wall time including dispatch, median
  of N.
* `per_iter_time(op, v)` — per-application cost of a linear operator,
  measured as the slope between two chained `fori_loop` programs so fixed
  dispatch latency cancels out.
* `copy_bandwidth_gbs()` — the device's copy bandwidth, the yardstick
  for memory-bound kernels.
* `trace(path)` — context manager around `jax.profiler` for XProf traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def force(tree: Any) -> Any:
    """Block until ``tree`` is computed; returns it."""
    return jax.block_until_ready(tree)


def wall_time(fn: Callable, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall seconds per call, dispatch included, completion forced."""
    for _ in range(warmup):
        force(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def chain_time(op: Callable, v: Any, K: int, reps: int = 3) -> float:
    """Total wall seconds for K dependent applications of ``op`` in one
    compiled program (min over reps)."""
    # the barrier keeps XLA from unrolling the loop and fusing consecutive
    # applications (which would read the operands once for several)
    g = jax.jit(lambda x: lax.fori_loop(
        0, K, lambda i, y: lax.optimization_barrier(op(y)), x))
    force(g(v))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        force(g(v))
        times.append(time.perf_counter() - t0)
    return min(times)


def per_iter_time(op: Callable, v: Any, K1: int = 5, K2: int = 50) -> float:
    """Per-application seconds of a (shape-preserving) operator, with fixed
    dispatch latency cancelled via the K2−K1 slope."""
    t1 = chain_time(op, v, K1)
    t2 = chain_time(op, v, K2)
    return max((t2 - t1) / (K2 - K1), 1e-12)


def copy_bandwidth_gbs(n_elems: int = 64 * 1024 * 1024) -> float:
    """Device copy bandwidth (GB/s) from a chained triad z ← a·z + y over
    two f32 vectors of ``n_elems``: 3 vectors move per step (read z, read
    y, write z). The yardstick for memory-bound kernels measured in the
    same process."""
    z = jnp.arange(n_elems, dtype=jnp.float32)
    a = np.float32(1.000001)
    # y rides in the loop carry: a closed-over y would be a compile-time
    # constant that XLA may fold instead of reading it
    dt = per_iter_time(lambda zy: (a * zy[0] + zy[1], zy[1]), (z, z + 1),
                       K1=5, K2=50)
    return 3 * z.nbytes / dt / 1e9


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture an XProf trace of the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
