#!/usr/bin/env python3
"""Field-level cross-validation of the LDC solver against the reference
repository's scipy ORIGIN script.

The origin (the reference's FVM_example/LDC_by_scipy/
FVM_Staggered_uniform_scipy_tonysaad_origin.py) runs nx=100, Re=400
(miu=0.0025), dt=0.01, 1000 steps, initial u=1 everywhere. This script
runs the tpu_sparse LDC solver under the SAME configuration (explicit
dt, matching initial condition) and compares the final cell-centered
velocity and pressure fields.

Usage:
  python examples/ldc/validate_reference.py --origin ldc_origin_nx100.npz
(The .npz is produced by running the origin script and saving u/v/p.)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--origin", default="ldc_origin_nx100.npz")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--solver", default="cg")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from tpu_sparse.utils.compile_cache import setup_compile_cache

    jax.config.update("jax_enable_x64", True)
    setup_compile_cache()
    import jax.numpy as jnp

    from examples.ldc.ldc_solver import LDCConfig, LDCSolver

    ref = np.load(args.origin)
    nx = int(ref["nx"])
    Re = float(ref["Re"])
    dt = float(ref["dt"])
    nsteps = int(ref["nsteps"])
    if args.steps != nsteps:
        nsteps = args.steps
    print(f"origin: nx={nx} Re={Re} dt={dt} steps={nsteps}")

    cfg = LDCConfig(nx=nx, Re=Re, solver=args.solver, tol=1e-10,
                    maxiter=5000, dt=dt)
    solver = LDCSolver(cfg)
    # origin initial condition: u = 1 everywhere (including ghosts)
    solver.u = jnp.ones_like(solver.u)
    solver.run(nsteps=nsteps, verbose=False)

    # cell-centered fields, both layouts -> (ny, nx)
    u_o, v_o = np.asarray(ref["u"]), np.asarray(ref["v"])
    ucc_o = 0.5 * (u_o[1:-1, 2:] + u_o[1:-1, 1:-1])
    vcc_o = 0.5 * (v_o[2:, 1:-1] + v_o[1:-1, 1:-1])
    u_m, v_m = np.asarray(solver.u), np.asarray(solver.v)
    ucc_m = 0.5 * (u_m[1:-1, 1:] + u_m[1:-1, :-1])
    vcc_m = 0.5 * (v_m[1:, 1:-1] + v_m[:-1, 1:-1])

    def rel(a, b):
        return float(np.linalg.norm(a - b)
                     / max(np.linalg.norm(b), 1e-30))

    ru, rv = rel(ucc_m, ucc_o), rel(vcc_m, vcc_o)
    # pressure up to an additive constant (projected vs pinned gauges)
    p_o = np.asarray(ref["p"])
    p_o_i = p_o[1:-1, 1:-1] if p_o.shape[0] == nx + 2 else p_o
    p_m = np.asarray(solver.p)
    p_o_c = p_o_i - p_o_i.mean()
    p_m_c = p_m - p_m.mean()
    rp = rel(p_m_c, p_o_c)
    print(f"rel_u={ru:.3e} rel_v={rv:.3e} rel_p={rp:.3e}")
    ok = ru < 2e-3 and rv < 2e-3 and rp < 5e-3
    print("FIELDS MATCH" if ok else "FIELDS DIVERGE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
