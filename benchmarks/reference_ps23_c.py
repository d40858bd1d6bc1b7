"""C-compiled reference-ps23 denominator: the ch. 22
pseudospectral 2/3-rule ALGORITHM (pseudospectral_23_rule.jl:95-144 —
15 complex 2D transforms per 3-stage step) with every non-transform
loop as single-thread C at -O3 (benchmarks/native/ref_kernels.c
ps23_* kernels) and the transforms via numpy-pocketfft (complex128,
what FFTW.jl computes), timed at the north-star 2048^2 on one core.

    python benchmarks/reference_ps23_c.py [--nx 2048] [--steps 3]

This supersedes reference_ps23_numpy.py's "elementwise granted FREE"
bound: the elementwise share is now MEASURED compiled, so the only
remaining grant is FFTW-vs-pocketfft on the transform share (1.5-2.5x,
the round-2 MKL-class calibration measured 1.9x):

    julia_est = t_fft / f_fftw + t_c_rest / 1.0

Trajectory verified identical to reference_ps23_numpy.py (same
numerics; parity vs the JAX model pinned in test_reference_parity.py).
Nothing is copied from the reference sources.

Output: one JSON line with the C-proxy steps/s, the component split,
and the derived Julia range.
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
import reference_ps23_numpy as refnp  # noqa: E402

_FFT_SECONDS = 0.0


def _ifft2(a):
    global _FFT_SECONDS
    t0 = time.perf_counter()
    r = np.fft.ifft2(a)
    _FFT_SECONDS += time.perf_counter() - t0
    return r


def _fft2(a):
    global _FFT_SECONDS
    t0 = time.perf_counter()
    r = np.fft.fft2(a)
    _FFT_SECONDS += time.perf_counter() - t0
    return r


def make_stepper(nx, ny, dx, dy, dt, re):
    kx0, ky0, k2, mask, _mean = refnp.make_consts(nx, ny, dx, dy)
    kx0 = np.ascontiguousarray(kx0)
    ky0 = np.ascontiguousarray(ky0)
    k2 = np.ascontiguousarray(k2)
    mask_u8 = np.ascontiguousarray(mask.astype(np.uint8))
    # preallocated work buffers (the reference reuses its six spectra)
    sxf = np.empty((nx, ny), np.complex128)
    wyf, syf, wxf, jacp = (np.empty_like(sxf) for _ in range(4))
    out = np.empty_like(sxf)

    def jacobian(wf):
        nk.ps23_derivs(wf, kx0, ky0, k2, mask_u8, sxf, wyf, syf, wxf)
        sx = _ifft2(sxf)
        wy = _ifft2(wyf)
        sy = _ifft2(syf)
        wx = _ifft2(wxf)
        nk.ps23_product(np.ascontiguousarray(sx), np.ascontiguousarray(wy),
                        np.ascontiguousarray(sy), np.ascontiguousarray(wx),
                        jacp)
        return _fft2(jacp)

    def step(wf):
        jprev = np.ascontiguousarray(jacobian(wf))
        cur = wf
        for s in range(3):
            j = jprev if s == 0 else np.ascontiguousarray(jacobian(cur))
            nk.ps23_stage(cur, jprev, j, k2,
                          refnp.ALPHAS[s] * 0.5 * dt / re,
                          refnp.RHOS[s] * dt, refnp.GAMMAS[s] * dt, out)
            out[0, 0] = 0.0
            cur = out.copy()
            jprev = j
        return cur

    return step


def main():
    global _FFT_SECONDS
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--re", type=float, default=1000.0)
    ap.add_argument("--dt", type=float, default=1e-3)
    ap.add_argument("--check", action="store_true",
                    help="verify trajectory equality vs the NumPy port")
    args = ap.parse_args()
    nx = ny = args.nx
    dx = dy = 2 * np.pi / nx
    step = make_stepper(nx, ny, dx, dy, args.dt, args.re)
    wf = np.fft.fft2(refnp.vm_ic(nx, ny, dx, dy).astype(complex))
    wf[0, 0] = 0.0

    if args.check:
        consts = refnp.make_consts(nx, ny, dx, dy)
        wn = wf.copy()
        wc = np.ascontiguousarray(wf)
        for _ in range(3):
            wn = refnp.step(wn, consts, args.dt, args.re)
            wc = step(wc)
        scale = np.abs(wn).max()
        rel = np.abs(wc - wn).max() / scale
        print(json.dumps({"check_rel_vs_numpy": float(rel)}))
        assert rel < 1e-12, rel

    wf = np.ascontiguousarray(wf)
    wf = step(wf)                               # warm
    _FFT_SECONDS = 0.0
    t0 = time.perf_counter()
    for _ in range(args.steps):
        wf = step(wf)
    total = time.perf_counter() - t0
    assert np.isfinite(wf).all()
    per_step = total / args.steps
    t_fft = _FFT_SECONDS / args.steps
    t_rest = per_step - t_fft
    julia_fast = t_fft / 2.5 + t_rest
    julia_slow = t_fft / 1.5 + t_rest
    print(json.dumps({
        "metric": f"reference_ps23_c_{nx}",
        "c_proxy_steps_per_sec": round(1.0 / per_step, 4),
        "per_step_s": round(per_step, 4),
        "fft_share_s": round(t_fft, 4),
        "c_rest_share_s": round(t_rest, 4),
        "julia_est_steps_per_sec": [round(1.0 / julia_slow, 3),
                                    round(1.0 / julia_fast, 3)],
        "steps": args.steps,
    }))


if __name__ == "__main__":
    main()
