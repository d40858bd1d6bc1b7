"""Certify the matmul_bf16x1 cavity record's precision tier: run the REFERENCE phys config (Re=100, t_final=10 —
lid_driven_cavity.jl:58-118 — at the north-star 1024^2 with the bench's
diffusively-stable dt=2e-5, i.e. 500k steps to steady state) under BOTH
the record variant (matmul_bf16x1 + Pallas RHS) and the fp32 baseline
(fst + Pallas RHS), then compare:

  * Ghia et al. (1982) Re=100 centerline velocities (the literature
    benchmark the north star names),
  * psi_min,
  * the cross-variant field/centerline deltas vs the fp32-vs-fp64
    envelope (4e-4, BASELINE.md fp32 study).

If bf16x1's Ghia deviations match fp32's (the discretization error
dominates both) and the cross deltas sit inside the fp32 envelope, the
130x headline's "matching solution error" claim is defended and the
cavity anchors' rel_tol can tighten to 2e-3 (gate certifies the tier).

Output: one JSON line per variant + a verdict line.

Usage: python benchmarks/bf16x1_ghia_certify.py [--nx 1024]
       [--t-final 10.0]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

GHIA_Y = np.array([0.0, 0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813,
                   0.4531, 0.5, 0.6172, 0.7344, 0.8516, 0.9531, 0.9609,
                   0.9688, 0.9766, 1.0])
GHIA_U = np.array([0.0, -0.03717, -0.04192, -0.04775, -0.06434, -0.10150,
                   -0.15662, -0.21090, -0.20581, -0.13641, 0.00332, 0.23151,
                   0.68717, 0.73722, 0.78871, 0.84123, 1.0])
GHIA_X = np.array([0.0, 0.0625, 0.0703, 0.0781, 0.0938, 0.1563, 0.2266,
                   0.2344, 0.5, 0.8047, 0.8594, 0.9063, 0.9453, 0.9531,
                   0.9609, 0.9688, 1.0])
GHIA_V = np.array([0.0, 0.09233, 0.10091, 0.10890, 0.12317, 0.16077,
                   0.17507, 0.17527, 0.05454, -0.24533, -0.22445, -0.16914,
                   -0.10313, -0.08864, -0.07391, -0.05906, 0.0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--t-final", type=float, default=10.0)
    ap.add_argument("--dt", type=float, default=2e-5)
    ap.add_argument("--dispatch-steps", type=int, default=10_000,
                    help="steps per device call")
    ap.add_argument("--variants", default="bf16x1:matmul_bf16x1,fp32:fst",
                    help="comma list of label:poisson pairs (one pair -> "
                         "no cross verdict, compare offline against a "
                         "saved run)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from cfd_julia_tpu.models import cavity
    from cfd_julia_tpu.stepping import loop

    print(f"# devices: {jax.devices()}", flush=True)
    nx = args.nx
    nt = round(args.t_final / args.dt)
    chunk = 50
    per_call = (args.dispatch_steps // chunk) * chunk
    results = {}

    pairs = [v.split(":") for v in args.variants.split(",")]
    for label, poisson in pairs:
        cfg = cavity.CavityConfig(nx=nx, ny=nx, dt=args.dt,
                                  poisson=poisson, rhs_impl="pallas")
        step = cavity.make_step_fn(cfg)
        k = jnp.asarray(per_call // chunk, jnp.int32)
        run = jax.jit(lambda s, k=k: loop.run_steps_dynamic(step, s, k,
                                                            chunk))
        w = jnp.zeros((nx + 1, nx + 1), jnp.float32)
        state = (w, jnp.zeros_like(w), jnp.zeros((), jnp.float32))
        done = 0
        t0 = time.perf_counter()
        while done < nt:
            state = run(state)
            jax.block_until_ready(state[0])
            done += per_call
            if done % (10 * per_call) == 0:
                print(f"# {label}: {done}/{nt} steps "
                      f"({time.perf_counter() - t0:.0f}s, last rms "
                      f"{float(state[2]):.3e})", flush=True)
        wall = time.perf_counter() - t0
        s = np.asarray(state[1], np.float64)
        rms = float(state[2])

        # centerline velocities from psi (u = dpsi/dy, v = -dpsi/dx)
        dx = dy = 1.0 / nx
        mid = nx // 2
        u_line = np.gradient(s[mid, :], dy)
        v_line = -np.gradient(s[:, mid], dx)
        grid = np.linspace(0.0, 1.0, nx + 1)
        ui = np.interp(GHIA_Y, grid, u_line)
        vi = np.interp(GHIA_X, grid, v_line)
        results[label] = {
            "psi_min": float(s.min()),
            "ghia_u_maxdev": float(np.abs(ui - GHIA_U).max()),
            "ghia_v_maxdev": float(np.abs(vi - GHIA_V).max()),
            "final_step_rms": rms,
            "steps": int(done), "wall_s": round(wall, 1),
            "u_line": u_line.tolist()[:: max(1, nx // 256)],
            "v_line": v_line.tolist()[:: max(1, nx // 256)],
            "psi": None,
        }
        results[label]["_s"] = s
        print(json.dumps({k: v for k, v in results[label].items()
                          if k not in ("u_line", "v_line", "_s", "psi")}
                         | {"variant": label}), flush=True)

    labels = [p[0] for p in pairs]
    if len(labels) < 2:
        print('{"note": "single-variant run; no cross verdict"}',
              flush=True)
        a = b = results[labels[0]]
    else:
        a, b = results[labels[0]], results[labels[1]]
    cross_psi = float(np.abs(a["_s"] - b["_s"]).max()
                      / max(np.abs(b["_s"]).max(), 1e-30))
    verdict = {
        "cross_rel_linf_psi": cross_psi,
        "psi_min_rel_delta": abs(a["psi_min"] - b["psi_min"])
        / abs(b["psi_min"]),
        "ghia_u_dev_ratio": a["ghia_u_maxdev"] / max(b["ghia_u_maxdev"],
                                                     1e-30),
        "ghia_v_dev_ratio": a["ghia_v_maxdev"] / max(b["ghia_v_maxdev"],
                                                     1e-30),
        "fp32_vs_fp64_envelope": 4e-4,
        "defended": bool(cross_psi <= 2e-3
                         and a["ghia_u_maxdev"] <= b["ghia_u_maxdev"] * 1.1
                         + 1e-4
                         and a["ghia_v_maxdev"] <= b["ghia_v_maxdev"] * 1.1
                         + 1e-4),
    }
    print(json.dumps({"verdict": verdict}), flush=True)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results",
                       f"ghia_certify_{time.strftime('%Y%m%dT%H%M%S')}.json")
    for r in results.values():
        r.pop("_s", None)
    with open(out, "w") as fh:
        json.dump({"nx": nx, "t_final": args.t_final, "dt": args.dt,
                   "results": results, "verdict": verdict}, fh, indent=1)
    print(f"# saved {out}", flush=True)


if __name__ == "__main__":
    main()
