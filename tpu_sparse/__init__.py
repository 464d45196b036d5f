"""tpu_sparse — a sparse linear-algebra framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
reference `Pytorch-Sparse-Linalg-torch-amgx.cg.bicg.gmres` library:

* Krylov solvers (CG, BiCGStab, GMRES with restart) over pytree operands with
  matrix-free callables and implicit-differentiation autograd.
* First-class sparse containers (COO/CSR/DIA/BSR/CWELL/BELL) with jit-safe
  XLA SpMV/SpMM kernels.
* Algebraic-multigrid preconditioned solves (replaces the AMGX backend).
* Banded/dense direct solvers with adjoint autograd (replaces cuDSS).
* A unified `SparseSolver` / `solve()` router with capability detection.
* Distributed (multi-device / multi-host) row-partitioned solvers via
  `jax.sharding.Mesh` + `shard_map`, halo-exchange SpMV and psum reductions.
"""

from tpu_sparse import config, kernels, sparse, utils
from tpu_sparse.sparse import BSR, COO, CSR, DIA

__version__ = "0.1.0"

# Solver API re-exports (populated as modules land).
from tpu_sparse.solvers import bicgstab, cg, gmres  # noqa: E402
from tpu_sparse.api import SolverResult, SparseSolver, solve  # noqa: E402

__all__ = [
    "config", "kernels", "sparse", "utils",
    "BSR", "COO", "CSR", "DIA",
    "cg", "bicgstab", "gmres",
    "SparseSolver", "SolverResult", "solve",
]
