"""Vortex merger with any of the four solver formulations; writes the
vorticity snapshots and a contour figure.

    python examples/vortex_merger.py --solver ps23 --nx 256 --t 20
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import os

import numpy as np

from cfd_julia_tpu.jaxconfig import configure_cache, pin_platform

pin_platform()  # honor a user-set JAX_PLATFORMS
configure_cache()

from cfd_julia_tpu.models import vortex
from cfd_julia_tpu.utils import io

parser = argparse.ArgumentParser()
parser.add_argument("--solver", default="ps23",
                    choices=["fdm", "hybrid", "ps32", "ps23"])
parser.add_argument("--nx", type=int, default=128)
parser.add_argument("--re", type=float, default=1000.0)
parser.add_argument("--t", type=float, default=20.0)
parser.add_argument("--outdir", default="out/vm")
args = parser.parse_args()

cfg = vortex.VortexConfig(nx=args.nx, ny=args.nx, solver=args.solver,
                          re=args.re, t_final=args.t)
res = vortex.solve(cfg)
os.makedirs(args.outdir, exist_ok=True)
io.write_vortex_snapshots(args.outdir, res.x, res.y, res.snapshots)
print(f"final |w|max = {float(np.abs(np.asarray(res.w)).max()):.4f}; "
      f"snapshots in {args.outdir}/vm*.txt")

try:
    from cfd_julia_tpu.utils import plotting

    plotting.field_contours(os.path.join(args.outdir, "vm1.txt"),
                            os.path.join(args.outdir, "vm_first.png"),
                            n_fields=1, titles=("vorticity",))
    print(f"figure: {args.outdir}/vm_first.png")
except Exception as e:
    print("plotting skipped:", e)
