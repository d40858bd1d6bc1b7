"""Generate fp64 physics anchors for bench.py's acceptance gate.

For each (family, nx, total_steps) point that bench.py's workers can
produce, run the SAME deterministic trajectory (zero / fixed IC, fixed
dt) on the CPU backend in float64 and record the physical metrics the
workers measure (psi_min / psi_l2 for the cavity, wmax / enstrophy for
ps23).  bench.py compares every raced variant against these within
rel_tol (default 1%) — legitimate variants differ by <=4e-4 (fp32) /
2e-5 (bf16x3), so the gate only fires on genuinely wrong numerics
(BASELINE.md fp32 study, PERF.md precision findings).

    python benchmarks/gen_physics_anchors.py [--quick-only]

Writes/updates benchmarks/physics_anchors.json (merge, not overwrite,
so the cheap small-grid test anchors survive a big-grid regeneration).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cfd_julia_tpu.jaxconfig import configure_cache, pin_platform  # noqa: E402

pin_platform("cpu")
configure_cache()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "physics_anchors.json")


def cavity_anchor(nx: int, total_steps: int):
    from cfd_julia_tpu.models import cavity
    from cfd_julia_tpu.stepping import loop

    cfg = cavity.CavityConfig(nx=nx, ny=nx, dt=2e-5)
    step = cavity.make_step_fn(cfg)
    w0 = jnp.zeros((nx + 1, nx + 1), jnp.float64)
    state = (w0, jnp.zeros_like(w0), jnp.zeros((), jnp.float64))
    state = jax.jit(lambda s: loop.run_steps(step, s, total_steps))(state)
    psi = state[1]
    return {"psi_min": float(psi.min()),
            "psi_l2": float(jnp.sqrt((psi ** 2).mean()))}


def ps23_anchor(nx: int, total_steps: int):
    from cfd_julia_tpu.models import vortex
    from cfd_julia_tpu.stepping import loop

    cfg = vortex.VortexConfig(nx=nx, ny=nx, solver="ps23", dt=1e-3)
    step = vortex.make_spectral_step_half_packed(cfg, jnp.float64)
    hf0 = jax.jit(vortex.half_init_packed)(
        vortex.initial_vorticity(cfg, jnp.float64))
    hf = jax.jit(lambda h: loop.run_steps(step, h, total_steps))(hf0)
    w = jax.jit(lambda h: vortex.half_decode_packed(h, cfg.ny,
                                                    jnp.float64))(hf)
    return {"wmax": float(jnp.abs(w).max()),
            "enstrophy": float((w ** 2).sum())}


def euler_anchor(solver: str, nx: int, total_steps: int):
    from cfd_julia_tpu.models import euler1d
    from cfd_julia_tpu.stepping import loop, ssprk3

    cfg = euler1d.EulerConfig(nx=nx, solver=solver,
                              dt=1e-4 * 256 / nx)   # = bench worker dt
    _, q0 = euler1d.sod_initial_state(cfg, jnp.float64)
    rhs = euler1d.make_rhs(cfg)
    step = lambda q: ssprk3.ssprk3_step(rhs, q, cfg.dt)
    q = jax.jit(lambda q: loop.run_steps(step, q, total_steps))(q0)
    return {"rho_min": float(q[0].min()),
            "rho_l2": float(jnp.sqrt((q[0] ** 2).mean()))}


def crweno_anchor(nx: int, total_steps: int):
    from cfd_julia_tpu.models import burgers1d
    from cfd_julia_tpu.stepping import loop, ssprk3

    cfg = burgers1d.BurgersConfig(nx=nx, solver="crweno", bc="periodic",
                                  dt=1e-4 * 200 / nx)
    rhs = burgers1d.make_rhs(cfg)
    x = burgers1d.grid_coords(cfg, jnp.float64)
    u0 = jnp.sin(2.0 * jnp.pi * x)
    step = lambda u: ssprk3.ssprk3_step(rhs, u, cfg.dt)
    u = jax.jit(lambda u: loop.run_steps(step, u, total_steps))(u0)
    return {"u_max": float(jnp.abs(u).max()),
            "u_l2": float(jnp.sqrt((u ** 2).mean()))}


def vortex2_anchor(solver: str, nx: int, total_steps: int):
    from cfd_julia_tpu.models import vortex
    from cfd_julia_tpu.stepping import loop, ssprk3

    cfg = vortex.VortexConfig(nx=nx, ny=nx, solver=solver, dt=1e-3)
    w0 = vortex.initial_vorticity(cfg, jnp.float64)
    if solver == "fdm":
        rhs = lambda w: vortex.fdm_rhs(w, cfg.dx, cfg.dy, cfg.re)
        step = lambda w: ssprk3.ssprk3_step(rhs, w, cfg.dt)
        w = jax.jit(lambda w: loop.run_steps(step, w, total_steps))(w0)
    else:
        step = vortex.make_spectral_step_half_packed(cfg, jnp.float64)
        hf = jax.jit(vortex.half_init_packed)(w0)
        hf = jax.jit(lambda h: loop.run_steps(step, h, total_steps))(hf)
        w = jax.jit(lambda h: vortex.half_decode_packed(
            h, cfg.ny, jnp.float64))(hf)
    return {"wmax": float(jnp.abs(w).max()),
            "enstrophy": float((w ** 2).sum())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick-only", action="store_true",
                    help="only the cheap small-grid test anchors")
    ap.add_argument("--coverage-only", action="store_true",
                    help="only the round-5 coverage-battery anchors")
    args = ap.parse_args()

    # (key, fn, kwargs): total_steps = 2x the bench scan window (warmup
    # + timed).  Small grids anchor the pytest integration cases; the
    # north-star grids anchor the real battery (full: steps=1000 cavity
    # / 100 ps23; quick: steps=50 cavity).
    jobs = [("cavity:64:40", cavity_anchor, dict(nx=64, total_steps=40)),
            ("ps23:64:20", ps23_anchor, dict(nx=64, total_steps=20))]
    if args.coverage_only:
        jobs = []
    if not args.quick_only and not args.coverage_only:
        jobs += [
            ("cavity:1024:100", cavity_anchor,
             dict(nx=1024, total_steps=100)),
            ("cavity:1024:2000", cavity_anchor,
             dict(nx=1024, total_steps=2000)),
            ("ps23:2048:200", ps23_anchor, dict(nx=2048, total_steps=200)),
        ]
    if not args.quick_only:
        # round-5 coverage battery (bench.py COVERAGE_ROWS): total_steps
        # = 2x the worker scan window at the exact worker configs
        jobs += [
            ("euler_hllc:8192:2000", euler_anchor,
             dict(solver="hllc", nx=8192, total_steps=2000)),
            ("euler_rusanov:8192:2000", euler_anchor,
             dict(solver="rusanov", nx=8192, total_steps=2000)),
            ("euler_roe:256:2000", euler_anchor,
             dict(solver="roe", nx=256, total_steps=2000)),
            ("crweno:1600:2000", crweno_anchor,
             dict(nx=1600, total_steps=2000)),
            ("fdm:2048:200", vortex2_anchor,
             dict(solver="fdm", nx=2048, total_steps=200)),
            ("hybrid:2048:200", vortex2_anchor,
             dict(solver="hybrid", nx=2048, total_steps=200)),
            ("ps32:2048:200", vortex2_anchor,
             dict(solver="ps32", nx=2048, total_steps=200)),
        ]

    anchors = {}
    if os.path.exists(OUT):
        with open(OUT) as fh:
            anchors = json.load(fh)
    for key, fn, kw in jobs:
        t0 = time.perf_counter()
        anchors[key] = {**fn(**kw), "rel_tol": 0.01}
        print(f"{key}: {anchors[key]} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        with open(OUT, "w") as fh:  # checkpoint after each (slow jobs)
            json.dump(anchors, fh, indent=1, sort_keys=True)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
