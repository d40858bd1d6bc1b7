"""fp32-vs-fp64 solution-error study at the north-star problem sizes.

The >=100x throughput claim is conditional on fp32 running "at matching
solution error" (BASELINE.md).  This quantifies it: run the same
configuration in fp32 and fp64 (CPU backend, which has both dtypes) and
report field deltas relative to the field scale, plus the physical
metrics the reference validates (psi_min for the cavity, enstrophy /
wmax for the vortex merger).

    python benchmarks/fp32_error_study.py [--quick]

Results are recorded in BASELINE.md "fp32 precision study".
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from cfd_julia_tpu.jaxconfig import configure_cache, pin_platform

pin_platform("cpu")
configure_cache()
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def cavity_study(nx: int, steps: int):
    from cfd_julia_tpu.models import cavity
    from cfd_julia_tpu.stepping import loop

    out = {}
    for dtype in (jnp.float32, jnp.float64):
        cfg = cavity.CavityConfig(nx=nx, ny=nx, dt=2e-5)
        step = cavity.make_step_fn(cfg)
        w0 = jnp.zeros((nx + 1, nx + 1), dtype)
        state = (w0, jnp.zeros_like(w0), jnp.zeros((), dtype))
        t0 = time.perf_counter()
        state = jax.jit(lambda s: loop.run_steps(step, s, steps))(state)
        s = np.asarray(state[1], np.float64)
        out[np.dtype(dtype).name] = {
            "psi": s, "psi_min": float(s.min()),
            "wall_s": time.perf_counter() - t0,
        }
    a, b = out["float32"], out["float64"]
    scale = np.abs(b["psi"]).max()
    return {
        "problem": f"cavity {nx}^2, {steps} steps (dt=2e-5, Re=100)",
        "rel_linf_psi": float(np.abs(a["psi"] - b["psi"]).max() / scale),
        "rel_l2_psi": float(np.sqrt(((a["psi"] - b["psi"]) ** 2).mean())
                            / scale),
        "psi_min_fp32": a["psi_min"], "psi_min_fp64": b["psi_min"],
        "wall_fp32_s": a["wall_s"], "wall_fp64_s": b["wall_s"],
    }


def ps23_study(nx: int, steps: int):
    from cfd_julia_tpu.models import vortex
    from cfd_julia_tpu.stepping import loop

    out = {}
    for dtype in (jnp.float32, jnp.float64):
        cfg = vortex.VortexConfig(nx=nx, ny=nx, solver="ps23", dt=1e-3)
        step = vortex.make_spectral_step_half_packed(cfg, dtype)
        hf0 = jax.jit(vortex.half_init_packed)(
            vortex.initial_vorticity(cfg, dtype))
        t0 = time.perf_counter()
        hf = jax.jit(lambda h: loop.run_steps(step, h, steps))(hf0)
        w = np.asarray(
            jax.jit(lambda h: vortex.half_decode_packed(h, cfg.ny, dtype))(hf),
            np.float64)
        out[np.dtype(dtype).name] = {
            "w": w, "wmax": float(np.abs(w).max()),
            "enstrophy": float((w ** 2).sum()),
            "wall_s": time.perf_counter() - t0,
        }
    a, b = out["float32"], out["float64"]
    scale = np.abs(b["w"]).max()
    return {
        "problem": f"ps23 {nx}^2, {steps} steps (dt=1e-3, Re=1000)",
        "rel_linf_w": float(np.abs(a["w"] - b["w"]).max() / scale),
        "rel_l2_w": float(np.sqrt(((a["w"] - b["w"]) ** 2).mean()) / scale),
        "wmax_fp32": a["wmax"], "wmax_fp64": b["wmax"],
        "enstrophy_rel_diff": abs(a["enstrophy"] - b["enstrophy"])
        / b["enstrophy"],
        "wall_fp32_s": a["wall_s"], "wall_fp64_s": b["wall_s"],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if args.quick:
        jobs = [("cavity", cavity_study, dict(nx=128, steps=200)),
                ("ps23", ps23_study, dict(nx=256, steps=50))]
    else:
        jobs = [("cavity", cavity_study, dict(nx=1024, steps=1000)),
                ("ps23", ps23_study, dict(nx=2048, steps=60))]
    for name, fn, kw in jobs:
        r = fn(**kw)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
