"""Four-step (Bailey) FFT as MXU matmuls, shaped for the 128x128 array.

The FFT is most of the cost of the ps23 step.  The Cooley-Tukey split n = n1*n2 turns one length-n DFT into

    X[k2 + n2 k1] = sum_j1 F1[k1,j1] * TW[j1,k2]
                    * ( sum_j2 x[j1 + n1 j2] F2[j2,k2] )

i.e. two dense matmuls plus an elementwise twiddle.  The naive balanced
split (64 x 32 at n=2048) starves the MXU: a K=N=32 matmul uses ~6% of
the 128x128 systolic array.  Here both stages are shaped to full
utilization:

* n1 is chosen as the largest divisor <= 128 (128 for every power-of-two
  and 3/2-padded grid in this code base), so the big stage is a
  K=N=n1~128 matmul;
* the small n2-point stage is lifted to a BLOCK-DIAGONAL matrix
  I_g (x) F2 with g = largest divisor of n1 with g*n2 <= 128: the
  contraction becomes K=N=g*n2~128 with zero extra relayout — the
  (…, n1, n2) -> (…, n1/g, g*n2) regrouping is a pure (contiguous)
  reshape.

FLOPs grow by (n1+n2)/log2(n) over a true FFT (~13x at n=2048) but at
full MXU rate that is ~50 us of matmul per 2048^2 axis — the VPU FFT and
the relayout passes are far slower.  On the GPU, whether it beats cuFFT
is not measured yet; policy.py keeps jnp.fft.

Index conventions (decimation-in-time): j = j1 + n1*j2, k = k2 + n2*k1;
the input gather is one (.., n2, n1) -> (.., n1, n2) transpose, the
output one (.., k2, k1) ordering fix — both fusable by XLA into the
adjacent matmuls.  Any COMPOSITE n works (the DFT factors are dense
matrices — no radix restriction); prime lengths raise.

`precision`: "highest" (default) is fp32-exact-grade (6-pass bf16);
"high" (3-pass bf16, ~fp32 accuracy for these unit-modulus factors) runs
the MXU at twice the throughput — the perf path for fp32 solvers.
fp64 (CPU tests) ignores it and is exact to roundoff.
"""
from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp

from cfd_julia_tpu.core import precision as precision_lib


def _split(n: int) -> tuple[int, int]:
    """(n1, n2) with n = n1*n2: n1 the largest divisor <= 128 (falling
    back to the most balanced factor pair for n with no divisor in
    range); any composite n works — the DFT factors are dense
    matrices."""
    if n <= 128:
        return n, 1            # single dense matmul, no small stage
    best = None
    for d in range(2, n):
        if d * d > n:
            break
        if n % d == 0:
            for c in (d, n // d):
                if c <= 128 and (best is None or c > best):
                    best = c
    if best is None:
        # no divisor <= 128 (e.g. large prime factors): most balanced
        for d in range(int(n**0.5), 1, -1):
            if n % d == 0:
                return n // d, d
        raise ValueError(f"mxu_fft requires composite length, got prime {n}")
    return best, n // best


def _block_factor(n1: int, n2: int) -> int:
    """Largest g | n1 with g*n2 <= 128 (block-diagonal lift of F2)."""
    g = 1
    for d in range(1, n1 + 1):
        if n1 % d == 0 and d * n2 <= 128:
            g = d
    return g


def supported(n: int) -> bool:
    try:
        _split(n)
        return True
    except ValueError:
        return False


@functools.lru_cache(maxsize=None)
def _consts_np(n: int, inverse: bool):
    """(F1, TW, F2blk) as float64 numpy complex — cast at use site.

    With j = j1 + n1*j2 and k = k2 + n2*k1:
        X[k1,k2] = sum_j1 F1[k1,j1] * TW[j1,k2]
                   * ( sum_j2 x[j1,j2] F2[j2,k2] )
    (the twiddle couples the INNER input index j1 with the inner output
    index k2 — the n2-point transform runs first).  F2 is returned
    lifted to I_g (x) F2 (see module docstring); the ifft's 1/n is
    folded into TW."""
    n1, n2 = _split(n)
    g = _block_factor(n1, n2)
    sign = 2j if inverse else -2j
    j1 = np.arange(n1)
    j2 = np.arange(n2)
    f1 = np.exp(sign * np.pi * np.outer(j1, j1) / n1)      # [k1, j1]
    tw = np.exp(sign * np.pi * np.outer(j1, j2) / n)       # [j1, k2]
    if inverse:
        tw = tw / n
    f2 = np.exp(sign * np.pi * np.outer(j2, j2) / n2)      # [j2, k2]
    f2blk = np.kron(np.eye(g), f2)                         # (g n2, g n2)
    return f1, tw, f2blk


def _apply_last(x, n: int, inverse: bool, precision: str = "highest"):
    n1, n2 = _split(n)
    g = _block_factor(n1, n2)
    cdtype = x.dtype if jnp.issubdtype(x.dtype, jnp.complexfloating) else (
        jnp.complex128 if x.dtype == jnp.float64 else jnp.complex64)
    f1, tw, f2blk = (jnp.asarray(a, cdtype)
                     for a in _consts_np(n, inverse))
    lead = x.shape[:-1]
    # x[..., j] with j = j1 + n1*j2  ->  xm[..., j1, j2]
    xm = jnp.swapaxes(x.reshape(lead + (n2, n1)), -1, -2)
    # small stage, block-diagonal: regroup j1 = a*g + b and contract the
    # merged (b, j2) index of length g*n2 — a pure reshape, K=N=g*n2
    zm = xm.reshape(lead + (n1 // g, g * n2))
    y = precision_lib.einsum("...am,mc->...ac", zm, f2blk, precision)
    z = y.reshape(lead + (n1, n2)) * tw
    # big stage: contract j1, K=N=n1
    out = precision_lib.einsum("ka,...ac->...kc", f1, z, precision)
    # out[..., k1, k2] flattens to k = k2 + n2*k1 (natural order)
    return out.reshape(lead + (n,))


def fft_matmul(x, axis: int = -1, precision: str = "highest"):
    """DFT along `axis` via full-width MXU matmuls; matches jnp.fft.fft."""
    x = jnp.moveaxis(x, axis, -1)
    out = _apply_last(x, x.shape[-1], False, precision)
    return jnp.moveaxis(out, -1, axis)


def ifft_matmul(x, axis: int = -1, precision: str = "highest"):
    x = jnp.moveaxis(x, axis, -1)
    out = _apply_last(x, x.shape[-1], True, precision)
    return jnp.moveaxis(out, -1, axis)


def fft2_matmul(x, precision: str = "highest"):
    """2D DFT over the last two axes; matches jnp.fft.fft2."""
    return fft_matmul(fft_matmul(x, -1, precision), -2, precision)


def ifft2_matmul(x, precision: str = "highest"):
    return ifft_matmul(ifft_matmul(x, -1, precision), -2, precision)


def _apply_last_real(x, n: int, precision: str):
    """Forward transform of a REAL last axis as two real-valued matmul
    stages (Re/Im handled separately — half the flops of promoting the
    input to complex), keeping only the non-redundant half spectrum.
    The big stage contracts with only the k1 <= n1//2 rows of F1 that
    feed the kept half (k = k2 + n2*k1 <= n//2) — half its flops."""
    n1, n2 = _split(n)
    g = _block_factor(n1, n2)
    rdtype = x.dtype
    f1, tw, f2blk = _consts_np(n, False)
    lead = x.shape[:-1]
    xm = jnp.swapaxes(x.reshape(lead + (n2, n1)), -1, -2)
    zm = xm.reshape(lead + (n1 // g, g * n2))
    yr = precision_lib.einsum("...am,mc->...ac", zm,
                              jnp.asarray(f2blk.real, rdtype), precision)
    yi = precision_lib.einsum("...am,mc->...ac", zm,
                              jnp.asarray(f2blk.imag, rdtype), precision)
    cdtype = jnp.complex128 if rdtype == jnp.float64 else jnp.complex64
    z = (yr.reshape(lead + (n1, n2)) + 1j * yi.reshape(lead + (n1, n2))
         ).astype(cdtype) * jnp.asarray(tw, cdtype)
    n1h = n1 // 2 + 1
    f1h = jnp.asarray(f1[:n1h], z.dtype)
    out = precision_lib.einsum("ka,...ac->...kc", f1h, z, precision)
    return out.reshape(lead + (n1h * n2,))[..., : n // 2 + 1]


def rfft_matmul(x, axis: int = -1, precision: str = "highest"):
    """rfft along `axis` of a REAL array via the two-real-matmul first
    stage; matches jnp.fft.rfft."""
    x = jnp.moveaxis(x, axis, -1)
    out = _apply_last_real(x, x.shape[-1], precision)
    return jnp.moveaxis(out, -1, axis)


def rfft2_matmul(x, precision: str = "highest"):
    """rfft2 of a REAL field: real-matmul transform along the last axis
    keeps only the non-redundant half before the (complex) second-axis
    transform — matches jnp.fft.rfft2."""
    half = _apply_last_real(x, x.shape[-1], precision)
    return fft_matmul(half, axis=-2, precision=precision)
