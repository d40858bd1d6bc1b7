"""Flow diagnostics on the decaying vortex merger: radial energy
spectrum E(k) and the enstrophy-budget identity dZ/dt = -2 nu P.

Capabilities beyond the reference (which only writes vorticity
snapshots, vm.jl:78-86): `utils.diagnostics` computes the E/Z/P
integral invariants spectrally and bins E(k), so a run can be checked
against 2D-turbulence phenomenology (enstrophy cascade ~ k^-3 range)
and its viscous budgets verified while it runs.

    JAX_PLATFORMS=cpu python examples/vortex_diagnostics.py --nx 128
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

from cfd_julia_tpu.jaxconfig import configure_cache, pin_platform

pin_platform()
configure_cache()

import numpy as np                                # noqa: E402

from cfd_julia_tpu.models import vortex           # noqa: E402
from cfd_julia_tpu.utils import diagnostics       # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--nx", type=int, default=128)
parser.add_argument("--re", type=float, default=1000.0)
parser.add_argument("--t", type=float, default=10.0)
parser.add_argument("--solver", default="ps23",
                    choices=["fdm", "hybrid", "ps32", "ps23"])
parser.add_argument("--outdir", default="out/vm_diag")
args = parser.parse_args()

cfg = vortex.VortexConfig(nx=args.nx, ny=args.nx, solver=args.solver,
                          re=args.re, t_final=args.t)
nu = 1.0 / cfg.re

res = vortex.solve(cfg)
os.makedirs(args.outdir, exist_ok=True)

# budget check across the stored snapshots: Z(t) should decay and its
# decay rate should match -2 nu P (trapezoidal in time)
snaps = [np.asarray(s) for s in res.snapshots]
n_snap = len(snaps)
# snapshots sit at steps 0, every, 2*every, ... (run_steps_with_snapshots;
# remainder steps after the last snapshot are NOT snapshotted), so the
# time axis is k*every*dt — a linspace to t_final would mislabel every
# snapshot whenever nt % ns != 0 and corrupt the budget's (t1 - t0)
every = max(1, cfg.nt // cfg.ns)
times = np.arange(n_snap) * every * cfg.dt
rows = []
for t, w in zip(times, snaps):
    e, z, p = (float(v) for v in diagnostics.invariants(w, cfg.dx, cfg.dy))
    rows.append((t, e, z, p))
print(f"{'t':>6} {'E':>12} {'Z':>12} {'P':>12}")
for t, e, z, p in rows:
    print(f"{t:6.2f} {e:12.6e} {z:12.6e} {p:12.6e}")

# discrete budget: Z(t_{i+1}) - Z(t_i) vs -2 nu int P dt
budget_err = 0.0
for (t0, _, z0, p0), (t1, _, z1, p1) in zip(rows, rows[1:]):
    lhs = z1 - z0
    rhs = -2.0 * nu * 0.5 * (p0 + p1) * (t1 - t0)
    budget_err = max(budget_err, abs(lhs - rhs) / max(abs(lhs), 1e-30))
print(f"\nenstrophy budget dZ = -2 nu int P dt: "
      f"max relative defect {budget_err:.2%} "
      "(trapezoidal-in-time + Jacobian transfer; refines with dt and "
      "snapshot spacing)")

# final-state spectrum
k, ek = diagnostics.energy_spectrum(snaps[-1])
spec = np.stack([np.asarray(k), np.asarray(ek)], axis=1)
path = os.path.join(args.outdir, "spectrum_final.txt")
np.savetxt(path, spec, header="k E(k)")
kmax = int(np.asarray(k)[np.argmax(np.asarray(ek))])
print(f"E(k) peak at k={kmax}; spectrum written to {path}")
