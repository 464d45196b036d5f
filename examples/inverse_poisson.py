"""Inverse problem demo: differentiating through a sparse solve.

Recovers a spatially-varying conductivity field sigma from an observed
solution of the 1-D diffusion equation -(sigma u')' = f by gradient descent
through the CG solve — exercising the implicit-diff gradients w.r.t. the
matrix values on the sparsity pattern (the capability the reference only
documents for its AMGX/cuDSS backends, torch_amgx.py:443-462).

Run:  python examples/inverse_poisson.py [--n 64] [--steps 200]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from tpu_sparse.autodiff import cg_diff
from tpu_sparse.sparse.containers import DIA


def assemble(sigma: jax.Array) -> DIA:
    """Tridiagonal FV discretization of -(sigma u')' with face-averaged
    coefficients; sigma lives on n+1 faces for n cells (h=1)."""
    n = sigma.shape[0] - 1
    lo = -sigma[:-1]
    hi = -sigma[1:]
    diag = sigma[:-1] + sigma[1:]
    data = jnp.stack([
        jnp.concatenate([jnp.zeros(1, sigma.dtype), lo[1:]]),
        diag,
        jnp.concatenate([hi[:-1], jnp.zeros(1, sigma.dtype)]),
    ])
    return DIA(data, (-1, 0, 1), (n, n))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.5)
    args = ap.parse_args(argv)

    from tpu_sparse.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    jax.config.update("jax_enable_x64", True)
    n = args.n
    x_grid = jnp.linspace(0, 1, n + 1)
    sigma_true = 1.0 + 0.8 * jnp.sin(2 * jnp.pi * x_grid) ** 2
    f = jnp.ones(n)

    u_obs = cg_diff(assemble(sigma_true), f, tol=1e-12)[0]

    def loss(log_sigma):
        sigma = jnp.exp(log_sigma)
        u = cg_diff(assemble(sigma), f, tol=1e-12)[0]
        return jnp.mean((u - u_obs) ** 2)

    grad_fn = jax.jit(jax.value_and_grad(loss))
    theta = jnp.zeros(n + 1)  # sigma = 1
    for i in range(args.steps):
        val, g = grad_fn(theta)
        theta = theta - args.lr * g / (jnp.linalg.norm(g) + 1e-12)
        if (i + 1) % max(1, args.steps // 10) == 0:
            err = float(jnp.max(jnp.abs(jnp.exp(theta) - sigma_true)))
            print(f"step {i+1:4d}  loss {float(val):.3e}  "
                  f"max|sigma-sigma_true| {err:.3f}")

    final_err = float(jnp.max(jnp.abs(jnp.exp(theta) - sigma_true)))
    print(f"\nrecovered sigma, max abs error {final_err:.3f} "
          f"(true field range [1.0, 1.8])")
    return final_err


if __name__ == "__main__":
    main()
