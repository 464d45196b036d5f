"""Global configuration for tpu_sparse.

The reference library defaults to float64 everywhere
(module_a/torch_sparse_linalg.py:57-58). Here the *numerical contract* is
configurable: tests use x64 for parity with the reference tolerances, and
float32 halves the bytes a memory-bound solve streams.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def enable_x64(enable: bool = True) -> None:
    """Enable (or disable) 64-bit mode in JAX. Call before building arrays."""
    jax.config.update("jax_enable_x64", enable)


def x64_enabled() -> bool:
    return bool(jax.config.jax_enable_x64)


def default_float() -> jnp.dtype:
    """The widest float available under the current x64 setting."""
    return jnp.float64 if x64_enabled() else jnp.float32


def default_index() -> jnp.dtype:
    return jnp.int32


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Options shared by the iterative solvers.

    Mirrors the reference's keyword surface (tol/atol/maxiter/M,
    torch_sparse_linalg.py:1019-1088) plus GMRES knobs.
    """

    tol: float = 1e-5
    atol: float = 0.0
    maxiter: int | None = None
    restart: int = 20  # GMRES only
    solve_method: str = "batched"  # GMRES only: 'batched' | 'incremental'
