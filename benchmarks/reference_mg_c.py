"""Compiled-loop reference-multigrid denominator: the ch. 17 mg_N
algorithm (N-level V-cycle, lexicographic Gauss-Seidel smoothing,
full-weighting restriction, bilinear prolongation; mg_N.jl:7-114) with
every loop as single-thread C (-O3), timed end to end on the bench
problem (4096^2 ``poly``, solve to rms/rms0 <= 1e-5 — the exact
configuration bench.py's mg worker times on the GPU).

    python benchmarks/reference_mg_c.py [--nx 4096] [--tol 1e-5]

Why (BASELINE.md round 3): the 4096^2 multigrid secondary has only an
analytic "est. 10-30 s" denominator.  The V-cycle is pure compiled
stencil loops (no FFT), so a C implementation IS the Julia estimate —
no backend-speed grant needed, just a direct measurement of the same
algorithm on the same single core that anchors the other denominators.

Structure mirrors mg_N.jl:53-106: relax v1 on the finest level, check
rms/rms0, descend (residual -> restrict -> zero -> relax v1, v2 at the
coarsest), ascend (prolong+correct -> relax v3), v1=v2=v3=2 as in the
reference main (mg_N.jl:116-130).  fp64 throughout (the reference is
fp64-only).  Self-check: the ``poly`` exact solution is biquadratic, so
the 5-point Laplacian has zero truncation error and the converged field
must match ue to tol level.

Output: one JSON line with solve seconds, cycles, per-cycle seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import native_kernels as nk  # noqa: E402


def build_poly(nx: int):
    """The iterative chapters' ipr=1 problem (gauss_seidel.jl:96-119):
    ue = (x^2-1)(y^2-1), f = -2(2-x^2-y^2), Dirichlet boundary from ue,
    zero interior start."""
    x = np.linspace(0.0, 1.0, nx + 1)
    X, Y = np.meshgrid(x, x, indexing="ij")
    ue = (X**2 - 1.0) * (Y**2 - 1.0)
    f = -2.0 * (2.0 - X**2 - Y**2)
    u0 = np.zeros_like(ue)
    u0[0, :], u0[-1, :] = ue[0, :], ue[-1, :]
    u0[:, 0], u0[:, -1] = ue[:, 0], ue[:, -1]
    return ue, f, u0


def interior_rms(r: np.ndarray) -> float:
    """compute_l2norm's interior convention (Common.jl:224-232)."""
    ri = r[1:-1, 1:-1]
    return float(np.sqrt(np.mean(ri * ri)))


def solve(nx: int, f: np.ndarray, u0: np.ndarray, tol: float,
          v1: int = 2, v2: int = 2, v3: int = 2, max_cycles: int = 200):
    """mg_N solve-to-tol; returns (u, cycles, rms/rms0 history)."""
    n_level = int(np.log2(nx)) - 1          # coarsest grid is 2x2 cells
    dx = 1.0 / nx
    u = [np.ascontiguousarray(u0, dtype=np.float64)]
    fs = [np.ascontiguousarray(f, dtype=np.float64)]
    rs = [np.zeros_like(u[0])]
    h = [dx]
    m = nx
    for _ in range(1, n_level):
        m //= 2
        u.append(np.zeros((m + 1, m + 1)))
        fs.append(np.zeros((m + 1, m + 1)))
        rs.append(np.zeros((m + 1, m + 1)))
        h.append(h[-1] * 2.0)
    L = n_level

    nk.residual(u[0], fs[0], rs[0], h[0], h[0])
    rms0 = interior_rms(rs[0])
    hist = []
    cycles = 0
    while cycles < max_cycles:
        cycles += 1
        nk.gs_sweep(u[0], fs[0], h[0], h[0], v1)
        nk.residual(u[0], fs[0], rs[0], h[0], h[0])
        rel = interior_rms(rs[0]) / rms0
        hist.append(rel)
        if rel <= tol:
            break
        for k in range(1, L):               # descend (mg_N.jl:74-92)
            if k > 1:
                nk.residual(u[k - 1], fs[k - 1], rs[k - 1],
                            h[k - 1], h[k - 1])
            nk.restrict_fw(rs[k - 1], fs[k])
            u[k].fill(0.0)
            nk.gs_sweep(u[k], fs[k], h[k], h[k],
                        v1 if k < L - 1 else v2)
        for k in range(L - 1, 0, -1):       # ascend (mg_N.jl:94-105)
            nk.prolong_correct(u[k], u[k - 1])
            nk.gs_sweep(u[k - 1], fs[k - 1], h[k - 1], h[k - 1], v3)
    return u[0], cycles, hist


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=4096)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--max-cycles", type=int, default=200)
    args = ap.parse_args()
    ue, f, u0 = build_poly(args.nx)
    t0 = time.perf_counter()
    uN, cycles, hist = solve(args.nx, f, u0, args.tol,
                             max_cycles=args.max_cycles)
    dt = time.perf_counter() - t0
    err = float(np.abs(uN - ue).max())
    print(json.dumps({
        "metric": f"reference_mg_c_{args.nx}",
        "solve_s": round(dt, 3),
        "cycles": cycles,
        "per_cycle_s": round(dt / cycles, 4),
        "rel_residual": hist[-1],
        "max_err_vs_exact": err,
        "tol": args.tol,
    }))


if __name__ == "__main__":
    main()
