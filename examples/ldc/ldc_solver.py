"""FVM lid-driven cavity — the reference's end-to-end application in JAX.

Capability parity: FVM_example/LDC_by_torchsp/ldc_solver_common.py in the
reference — staggered-grid fractional-step incompressible Navier-Stokes:
explicit momentum (central convection + diffusion, :151-180),
pressure-Poisson with Neumann walls assembled once (:90-135), pluggable
pressure solve (:182-201), velocity correction (:203-206), mass-residual
monitor (:208-215), CFL dt (:59-61).

Re-design: the entire time step (boundary conditions, momentum,
pressure CG/BiCGStab solve, correction) is ONE jitted function; the Poisson
matrix is a 5-point DIA stencil solved by the in-repo Krylov solvers with a
Jacobi or AMG preconditioner — no host round-trips inside the loop.

Staggered layout (MAC):
  p[J, I]            cell centers, shape (ny, nx)
  u[j, i]            x-velocity at vertical faces, shape (ny+2, nx+1)
                     (rows 1..ny interior; rows 0 / ny+1 are ghosts)
  v[j, i]            y-velocity at horizontal faces, shape (ny+1, nx+2)
                     (cols 1..nx interior; cols 0 / nx+1 are ghosts)
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from functools import partial
from typing import Callable, Optional, Tuple

# Allow running as a standalone script: `python examples/ldc/ldc_solver.py`.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import jax
import jax.numpy as jnp

from tpu_sparse.direct import banded_solve
from tpu_sparse.precond import amg_preconditioner, jacobi_preconditioner
from tpu_sparse.solvers import (bicgstab_full, bicgstab_refined, cg_full,
                                cg_refined, gmres_full, gmres_refined)
from tpu_sparse.sparse.containers import DIA
from tpu_sparse.sparse.convert import dia_from_offsets


def build_pressure_matrix(nx: int, ny: int, dx: float, dy: float,
                          dtype=np.float64) -> DIA:
    """Negated pressure-Poisson operator with Neumann walls, as 5-point DIA.

    Zeroed boundary coefficients + reduced diagonal make the wall faces
    Neumann; the matrix is symmetric positive semi-definite (singular up to
    a constant), exactly like the reference's assembly
    (ldc_solver_common.py:90-135).
    """
    n = nx * ny
    c = np.arange(n)
    I = c % nx
    J = c // nx
    ax, ay = 1.0 / dx**2, 1.0 / dy**2
    west = np.where(I > 0, ax, 0.0)
    east = np.where(I < nx - 1, ax, 0.0)
    south = np.where(J > 0, ay, 0.0)
    north = np.where(J < ny - 1, ay, 0.0)
    diag = west + east + south + north
    data = np.zeros((5, n), dtype=dtype)
    data[0] = -south
    data[1] = -west
    data[2] = diag
    data[3] = -east
    data[4] = -north
    return dia_from_offsets((-nx, -1, 0, 1, nx), data, (n, n))


def pin_pressure_matrix(A: DIA) -> DIA:
    """Replace row 0 with the identity row e0, removing the constant
    null space of the Neumann system so a DIRECT solve is well-posed
    (the reference's module-C cuDSS variant relies on the same
    fix-one-dof trick; iterative variants instead project the mean).
    Row 0's original equation is redundant (rank n-1), and with
    rhs[0] = 0 the solution matches the projected iterative one up to
    the additive constant, removed afterwards."""
    data = np.array(A.data)
    for d, o in enumerate(A.offsets):
        data[d, 0] = 1.0 if o == 0 else 0.0
    return DIA(jnp.asarray(data), A.offsets, A.shape)


@dataclasses.dataclass
class LDCConfig:
    nx: int = 32
    ny: Optional[int] = None
    Re: float = 100.0
    lid_velocity: float = 1.0
    L: float = 1.0
    cfl: float = 0.5
    solver: str = "cg"          # 'cg' | 'bicgstab' | 'gmres' | 'direct'
    tol: float = 1e-8
    maxiter: int = 2000
    precond: str = "jacobi"     # 'none' | 'jacobi' | 'amg' | 'fsai'
    precision: str = "full"     # 'full' | 'mixed' (f32 inner pressure CG)
    dt: Optional[float] = None  # explicit time step (default: CFL rule)

    def __post_init__(self):
        if self.ny is None:
            self.ny = self.nx


class LDCSolver:
    """Lid-driven cavity solver with a pluggable pressure solve —
    the analogue of the reference's BaseLDCSolver + per-backend subclasses
    (ldc_solver_common.py:30-297, ldc_solver_module_{a,b,c,d}.py)."""

    def __init__(self, config: LDCConfig):
        cfg = self.config = config
        nx, ny = cfg.nx, cfg.ny
        self.dx = cfg.L / nx
        self.dy = cfg.L / ny
        self.nu = cfg.lid_velocity * cfg.L / cfg.Re
        # CFL-limited dt (reference :59-61): convective + viscous limits;
        # cfg.dt overrides (e.g. to match the origin script's fixed rule
        # for field-level cross-validation).
        self.dt = cfg.dt if cfg.dt is not None else cfg.cfl * min(
            self.dx / cfg.lid_velocity,
            0.25 * self.dx**2 / self.nu,
        )
        self.A = build_pressure_matrix(nx, ny, self.dx, self.dy)
        # direct pressure solves need the null space pinned, not projected
        self.A_pin = (pin_pressure_matrix(self.A)
                      if cfg.solver == "direct" else None)
        if cfg.precond == "jacobi":
            self.M = jacobi_preconditioner(self.A)
        elif cfg.precond == "amg":
            self.M = amg_preconditioner(self.A)
        elif cfg.precond == "fsai":
            from tpu_sparse.precond import fsai_preconditioner

            self.M = fsai_preconditioner(self.A)
        else:
            self.M = None

        self.u = jnp.zeros((ny + 2, nx + 1))
        self.v = jnp.zeros((ny + 1, nx + 2))
        self.p = jnp.zeros((ny, nx))
        self._step = jax.jit(self._make_step())
        self._multi_step = jax.jit(self._make_multi_step(),
                                   static_argnames=("nsteps",))

    # -- physics -----------------------------------------------------------

    def _make_step(self) -> Callable:
        cfg = self.config
        nx, ny = cfg.nx, cfg.ny
        dx, dy, nu, dt = self.dx, self.dy, self.nu, self.dt
        Ulid = cfg.lid_velocity
        A, M = self.A, self.M
        A_pin = self.A_pin
        solver = cfg.solver
        tol, maxiter = cfg.tol, cfg.maxiter
        mixed = cfg.precision == "mixed"

        def apply_bcs(u, v):
            # side walls: u = 0 at boundary faces
            u = u.at[:, 0].set(0.0).at[:, nx].set(0.0)
            # bottom no-slip ghost / top lid ghost (u_ghost = 2U - u_int)
            u = u.at[0, :].set(-u[1, :])
            u = u.at[ny + 1, :].set(2.0 * Ulid - u[ny, :])
            # top/bottom walls: v = 0 at boundary faces
            v = v.at[0, :].set(0.0).at[ny, :].set(0.0)
            # side no-slip ghosts
            v = v.at[:, 0].set(-v[:, 1])
            v = v.at[:, nx + 1].set(-v[:, nx])
            return u, v

        def momentum(u, v):
            # u* on interior faces (j=1..ny, i=1..nx-1)
            uc = u[1:-1, 1:-1]                       # (ny, nx-1)
            ue = 0.5 * (u[1:-1, 1:-1] + u[1:-1, 2:])
            uw = 0.5 * (u[1:-1, :-2] + u[1:-1, 1:-1])
            un = 0.5 * (u[1:-1, 1:-1] + u[2:, 1:-1])
            us = 0.5 * (u[:-2, 1:-1] + u[1:-1, 1:-1])
            vn = 0.5 * (v[1:, 1:nx] + v[1:, 2:nx + 1])     # (ny, nx-1)
            vs = 0.5 * (v[:-1, 1:nx] + v[:-1, 2:nx + 1])
            conv = (ue**2 - uw**2) / dx + (un * vn - us * vs) / dy
            lap = ((u[1:-1, 2:] - 2 * uc + u[1:-1, :-2]) / dx**2
                   + (u[2:, 1:-1] - 2 * uc + u[:-2, 1:-1]) / dy**2)
            u_star = u.at[1:-1, 1:-1].set(uc + dt * (-conv + nu * lap))

            # v* on interior faces (j=1..ny-1, i=1..nx)
            vc = v[1:-1, 1:-1]                       # (ny-1, nx)
            vn2 = 0.5 * (v[1:-1, 1:-1] + v[2:, 1:-1])
            vs2 = 0.5 * (v[:-2, 1:-1] + v[1:-1, 1:-1])
            ve = 0.5 * (v[1:-1, 1:-1] + v[1:-1, 2:])
            vw = 0.5 * (v[1:-1, :-2] + v[1:-1, 1:-1])
            ue2 = 0.5 * (u[1:ny, 1:] + u[2:ny + 1, 1:])    # (ny-1, nx)
            uw2 = 0.5 * (u[1:ny, :-1] + u[2:ny + 1, :-1])
            conv_v = (ue2 * ve - uw2 * vw) / dx + (vn2**2 - vs2**2) / dy
            lap_v = ((v[1:-1, 2:] - 2 * vc + v[1:-1, :-2]) / dx**2
                     + (v[2:, 1:-1] - 2 * vc + v[:-2, 1:-1]) / dy**2)
            v_star = v.at[1:-1, 1:-1].set(vc + dt * (-conv_v + nu * lap_v))
            return u_star, v_star

        def pressure_rhs(u_star, v_star):
            div = ((u_star[1:-1, 1:] - u_star[1:-1, :-1]) / dx
                   + (v_star[1:, 1:-1] - v_star[:-1, 1:-1]) / dy)
            rhs = -div.reshape(-1) / dt   # negated: A = -∇² is PSD
            # Project out the null-space component for the singular Neumann
            # system (compatibility is exact analytically; this removes
            # round-off drift).
            return rhs - jnp.mean(rhs)

        def solve_pressure(rhs, p_prev):
            if solver == "direct":
                # reference module-C analogue (cuDSS spsolve per step,
                # ldc_solver_module_c.py): banded direct solve on the
                # row-0-pinned system; no iteration count
                x = banded_solve(A_pin, rhs.at[0].set(0.0))
                x = x - jnp.mean(x)
                return x.reshape(ny, nx), jnp.array(0, jnp.int32)
            x0 = p_prev.reshape(-1)
            krylov = {"cg": (cg_refined, cg_full),
                      "bicgstab": (bicgstab_refined, bicgstab_full),
                      "gmres": (gmres_refined, gmres_full)}[solver]
            fn = krylov[0] if mixed else krylov[1]
            x, info, iters, res = fn(A, rhs, x0, tol=tol, maxiter=maxiter,
                                     M=M)
            x = x - jnp.mean(x)
            return x.reshape(ny, nx), iters

        def correct(u_star, v_star, p):
            u = u_star.at[1:-1, 1:-1].add(
                -dt * (p[:, 1:] - p[:, :-1]) / dx)
            v = v_star.at[1:-1, 1:-1].add(
                -dt * (p[1:, :] - p[:-1, :]) / dy)
            return u, v

        def mass_residual(u, v):
            div = ((u[1:-1, 1:] - u[1:-1, :-1]) / dx
                   + (v[1:, 1:-1] - v[:-1, 1:-1]) / dy)
            return jnp.sqrt(jnp.mean(div**2))

        def step(u, v, p):
            u, v = apply_bcs(u, v)
            u_star, v_star = momentum(u, v)
            u_star, v_star = apply_bcs(u_star, v_star)
            rhs = pressure_rhs(u_star, v_star)
            p_new, iters = solve_pressure(rhs, p)
            u, v = correct(u_star, v_star, p_new)
            u, v = apply_bcs(u, v)
            return u, v, p_new, mass_residual(u, v), iters

        return step

    def _make_multi_step(self):
        step = self._make_step()

        def multi(u, v, p, nsteps: int):
            def body(carry, _):
                u, v, p = carry
                u, v, p, mres, iters = step(u, v, p)
                return (u, v, p), (mres, iters)

            (u, v, p), (mres, iters) = jax.lax.scan(
                body, (u, v, p), None, length=nsteps)
            return u, v, p, mres[-1], jnp.sum(iters)

        return multi

    # -- driver ------------------------------------------------------------

    def step(self):
        self.u, self.v, self.p, mres, iters = self._step(
            self.u, self.v, self.p)
        return float(mres), int(iters)

    def run(self, nsteps: int, verbose: bool = False, chunk: int = 100
            ) -> dict:
        """Advance nsteps. Steps are batched ``chunk`` per dispatch with
        lax.scan — one device program per chunk instead of one per step,
        which removes the per-step host round trip (the reference runs one
        Python step per loop, ldc_solver_common.py:232-253)."""
        t0 = time.perf_counter()
        mres, iters_total = 0.0, 0
        done = 0
        while done < nsteps:
            k = min(chunk, nsteps - done)
            self.u, self.v, self.p, mres_a, iters_a = self._multi_step(
                self.u, self.v, self.p, nsteps=k)
            mres = float(mres_a)
            iters_total += int(iters_a)
            done += k
            if verbose:
                print(f"step {done:5d}  mass-res {mres:.3e}  "
                      f"p-iters(chunk) {int(iters_a)}")
        elapsed = time.perf_counter() - t0
        return {
            "steps": nsteps,
            "elapsed_s": elapsed,
            "steps_per_s": nsteps / elapsed,
            "mass_residual": mres,
            "pressure_iters_total": iters_total,
        }

    def velocity_magnitude(self) -> np.ndarray:
        """Cell-centered |u| for plotting/inspection."""
        uc = 0.5 * (self.u[1:-1, :-1] + self.u[1:-1, 1:])
        vc = 0.5 * (self.v[:-1, 1:-1] + self.v[1:, 1:-1])
        return np.asarray(jnp.sqrt(uc**2 + vc**2))

    def save_plot(self, path: str) -> str:
        """Velocity-magnitude contour + streamlines PNG (reference
        ldc_solver_common.py:255-297)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        nx, ny = self.config.nx, self.config.ny
        xc = (np.arange(nx) + 0.5) * self.dx
        yc = (np.arange(ny) + 0.5) * self.dy
        uc = np.asarray(0.5 * (self.u[1:-1, :-1] + self.u[1:-1, 1:]))
        vc = np.asarray(0.5 * (self.v[:-1, 1:-1] + self.v[1:, 1:-1]))
        mag = np.sqrt(uc**2 + vc**2)
        fig, ax = plt.subplots(figsize=(6, 5))
        cs = ax.contourf(xc, yc, mag, levels=24)
        fig.colorbar(cs, ax=ax, label="|u|")
        ax.streamplot(xc, yc, uc, vc, color="w", density=1.2, linewidth=0.6)
        ax.set_title(f"Lid-driven cavity  Re={self.config.Re:g}  "
                     f"{nx}x{ny}  ({self.config.solver}/"
                     f"{self.config.precond})")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_aspect("equal")
        fig.tight_layout()
        fig.savefig(path, dpi=130)
        plt.close(fig)
        return path

    def save_state(self, path: str) -> str:
        """Checkpoint the simulation state (no reference counterpart —
        the reference runs start-to-finish only, SURVEY.md §5)."""
        np.savez(path, u=np.asarray(self.u), v=np.asarray(self.v),
                 p=np.asarray(self.p))
        return path

    def restore_state(self, path: str) -> None:
        data = np.load(path)
        if data["u"].shape != self.u.shape:
            raise ValueError(
                f"checkpoint grid {data['p'].shape} does not match solver "
                f"grid {(self.config.ny, self.config.nx)}; construct the "
                f"solver with the checkpoint's --nx")
        self.u = jnp.asarray(data["u"])
        self.v = jnp.asarray(data["v"])
        self.p = jnp.asarray(data["p"])


def run_solver_cli():
    """CLI mirroring the reference's run_solver_cli
    (ldc_solver_common.py:300-338): --nx --Re --steps --method --quick."""
    import argparse

    ap = argparse.ArgumentParser(description="FVM lid-driven cavity")
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--Re", type=float, default=100.0)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--dt", type=float, default=None,
                    help="explicit time step (default: CFL rule)")
    ap.add_argument("--method", default="cg",
                    choices=["cg", "bicgstab", "gmres", "direct", "amg"])
    ap.add_argument("--precond", default="jacobi",
                    choices=["none", "jacobi", "amg", "fsai"])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-precision pressure solves (f32 inner CG + "
                         "f64 refinement) at fp64 accuracy")
    ap.add_argument("--f32", action="store_true",
                    help="run single precision (pressure tolerance is "
                         "relaxed to f32-reachable levels)")
    ap.add_argument("--save-dir", default=None,
                    help="write a velocity contour/streamline PNG here")
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--save-state", default=None,
                    help="write final (u, v, p) state to this .npz")
    ap.add_argument("--restore-state", default=None,
                    help="resume from a saved .npz state")
    args = ap.parse_args()
    from tpu_sparse.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    if args.quick:
        args.nx, args.steps = 32, 100

    if not args.f32:
        # fp64 parity with the reference (torch_sparse_linalg.py:57-58).
        jax.config.update("jax_enable_x64", True)

    method = args.method
    precond = args.precond
    if method == "amg":
        method, precond = "cg", "amg"
    tol = 1e-8 if not args.f32 else 2e-5  # f32 CG stalls below ~1e-6 rel
    cfg = LDCConfig(nx=args.nx, Re=args.Re, solver=method, precond=precond,
                    tol=tol, precision="mixed" if args.mixed else "full",
                    dt=args.dt)
    solver = LDCSolver(cfg)
    if args.restore_state:
        solver.restore_state(args.restore_state)
    stats = solver.run(args.steps, verbose=True)
    print(f"\n{stats['steps']} steps in {stats['elapsed_s']:.2f}s "
          f"({stats['steps_per_s']:.1f} steps/s), "
          f"final mass residual {stats['mass_residual']:.3e}")
    if args.save_state:
        print("state saved to", solver.save_state(args.save_state))
    if args.save_dir and not args.no_plot:
        os.makedirs(args.save_dir, exist_ok=True)
        out = os.path.join(
            args.save_dir,
            f"ldc_Re{int(cfg.Re)}_{cfg.nx}x{cfg.ny}.png")
        print("plot saved to", solver.save_plot(out))


if __name__ == "__main__":
    run_solver_cli()
