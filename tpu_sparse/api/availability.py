"""Capability detection and reporting.

Replaces the reference's backend-availability probes
(utils/availability.py:13-174). There is no external-library boundary —
every backend is in-repo — so "availability" becomes a hardware /
configuration capability report: platform, device count, x64 mode, and
per-method support.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import jax


@functools.lru_cache(maxsize=None)
def backend_platform() -> str:
    try:
        return jax.default_backend()
    except Exception:
        return "unknown"


@functools.lru_cache(maxsize=None)
def device_count() -> int:
    try:
        return jax.device_count()
    except Exception:
        return 0


@functools.lru_cache(maxsize=None)
def check_krylov_available() -> bool:
    """Iterative solvers work on any JAX backend."""
    try:
        import tpu_sparse.solvers  # noqa: F401

        return device_count() > 0
    except Exception:
        return False


@functools.lru_cache(maxsize=None)
def check_amg_available() -> bool:
    """AMG: live functionality probe, mirroring the reference's real-solve
    backend checks (utils/availability.py:58-105) — a tiny hierarchy setup
    plus one V-cycle application, so a broken scipy / native-toolchain
    state is caught here rather than at first use."""
    try:
        import jax.numpy as jnp

        from tpu_sparse.precond.amg import amg_preconditioner
        from tpu_sparse.sparse.generators import poisson2d

        A = poisson2d(4, dtype=jnp.zeros(0).dtype)  # 16 dof
        M = amg_preconditioner(A)
        y = M(jnp.ones(A.shape[0], dtype=A.dtype))
        return bool(jnp.all(jnp.isfinite(y)))
    except Exception:
        return False


@functools.lru_cache(maxsize=None)
def check_direct_available() -> bool:
    """Direct solvers: probe with a live 3x3 tridiagonal solve, mirroring the
    reference's functional cuDSS probe (utils/availability.py:58-105)."""
    try:
        import jax.numpy as jnp

        from tpu_sparse.direct import banded_solve
        from tpu_sparse.sparse.generators import tridiagonal

        A = tridiagonal(3, dtype=jnp.zeros(0).dtype)
        b = jnp.ones(3, dtype=A.dtype)
        x = banded_solve(A, b)
        return bool(jnp.all(jnp.isfinite(x)))
    except Exception:
        return False


@functools.lru_cache(maxsize=None)
def check_distributed_available() -> bool:
    return device_count() > 1


def get_available_backends() -> List[str]:
    out = []
    if check_krylov_available():
        out.append("krylov")
    if check_amg_available():
        out.append("amg")
    if check_direct_available():
        out.append("direct")
    return out


def availability_dict() -> Dict[str, bool]:
    return {
        "krylov": check_krylov_available(),
        "amg": check_amg_available(),
        "direct": check_direct_available(),
        "distributed": check_distributed_available(),
    }


def print_availability_report(verbose: bool = True) -> Dict[str, bool]:
    """Human-readable capability report (reference availability.py:133-174)."""
    avail = availability_dict()
    x64 = bool(jax.config.jax_enable_x64)
    lines = [
        "tpu_sparse capability report",
        "=" * 40,
        f"  platform           : {backend_platform()}",
        f"  devices            : {device_count()}",
        f"  x64 enabled        : {x64}",
        f"  krylov solvers     : {'yes' if avail['krylov'] else 'NO'}",
        f"  AMG preconditioner : {'yes' if avail['amg'] else 'NO'}",
        f"  direct solvers     : {'yes' if avail['direct'] else 'NO'}",
        f"  multi-device       : {'yes' if avail['distributed'] else 'no'}",
    ]
    if verbose:
        print("\n".join(lines))
    return avail
