"""Run the lid-driven cavity to steady state and compare against the
Ghia et al. (1982) benchmark centerlines.

    python examples/cavity_ghia.py [--nx 128] [--re 100]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np

from cfd_julia_tpu.jaxconfig import configure_cache, pin_platform

pin_platform()  # honor a user-set JAX_PLATFORMS
configure_cache()

from cfd_julia_tpu.models import cavity

parser = argparse.ArgumentParser()
parser.add_argument("--nx", type=int, default=64)
parser.add_argument("--re", type=float, default=100.0)
parser.add_argument("--t", type=float, default=10.0)
args = parser.parse_args()

cfg = cavity.CavityConfig(nx=args.nx, ny=args.nx, re=args.re, t_final=args.t)
res = cavity.solve(cfg)
u, v = cavity.centerline_velocities(res, cfg)

print(f"steady-state ||dpsi||: {float(res.rms_history[-1]):.3e}")
print(f"psi_min: {float(np.asarray(res.s).min()):.6f} "
      f"(Ghia Re=100: -0.103423)")

ghia_y = [0.0547, 0.1719, 0.4531, 0.5, 0.8516, 0.9531]
ghia_u = [-0.03717, -0.10150, -0.21090, -0.20581, 0.23151, 0.68717]
y = np.linspace(0, 1, cfg.ny + 1)
ui = np.interp(ghia_y, y, np.asarray(u))
for yy, ug, un in zip(ghia_y, ghia_u, ui):
    print(f"  y={yy:.4f}  ghia={ug:+.5f}  ours={un:+.5f}")
