"""Precision policy: fp32 by default, fp64 opt-in for parity tests, and
the matrix-product tiers.

The reference runs everything in Float64 on CPU.  The engine's fast path
is fp32; `jax_enable_x64` switches every solver to fp64 (the CPU parity
tests, and fp64 runs on the GPU).

Matrix-product tiers.  The dense transforms (sine-matrix DST, matmul FFT,
fused cavity step) take a tier name, and `dot_algorithm` maps it once to
an explicit `jax.lax.DotAlgorithmPreset`:

    highest            -> F32_F32_F32       (fp32 products)
    high   / *_bf16x3  -> BF16_BF16_F32_X3  (3-pass bf16, fp32 accumulate)
    default/ *_bf16x1  -> BF16_BF16_F32     (1-pass bf16, fp32 accumulate)

A bare `precision="high"` lets a GPU run TF32; an explicit preset does
not, so each tier is the same arithmetic on every platform that accepts
it.  A platform that refuses a preset fails to compile; `check_tier`
compiles one product and reports the refusal under the tier's name.
fp64 operands always take F64_F64_F64: the tiers name reduced-precision
fp32 arithmetic, and an fp64 run asked for fp64.  Complex products are
taken as four real products at the tier (XLA 0.9 drops the imaginary
part of a complex dot that carries a preset).

Usage:
    from cfd_julia_tpu.core import precision
    dtype = precision.default_dtype()         # fp32, or fp64 if x64 enabled
    with precision.x64():                      # context-managed fp64
        ...
    precision.matmul(a, b, "high")             # 3-pass bf16 product
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp

_PRESET = jax.lax.DotAlgorithmPreset

TIERS = {
    "highest": _PRESET.F32_F32_F32,
    "high": _PRESET.BF16_BF16_F32_X3,
    "default": _PRESET.BF16_BF16_F32,
}


def x64_enabled() -> bool:
    return bool(jax.config.jax_enable_x64)


def default_dtype():
    """Default real dtype: float64 when x64 is enabled, else float32."""
    return jnp.float64 if x64_enabled() else jnp.float32


def complex_dtype(real_dtype=None):
    """Matching complex dtype for a real dtype."""
    rd = jnp.dtype(real_dtype or default_dtype())
    return jnp.complex128 if rd == jnp.float64 else jnp.complex64


@contextlib.contextmanager
def x64(enable: bool = True):
    """Temporarily toggle fp64 globally (affects subsequent traces only)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", enable)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def dot_algorithm(tier: str, dtype):
    """The DotAlgorithmPreset of `tier` for operands of `dtype`."""
    if tier not in TIERS:
        raise ValueError(f"unknown precision tier {tier!r} "
                         f"(one of {' | '.join(TIERS)})")
    if jnp.dtype(dtype) in (jnp.float64, jnp.complex128):
        return _PRESET.F64_F64_F64
    return TIERS[tier]


def _tiered(dot, a, b, tier):
    """dot(a, b, precision=preset) for real operands; for complex ones,
    the four real products recombined."""
    if not (jnp.iscomplexobj(a) or jnp.iscomplexobj(b)):
        return dot(a, b, precision=dot_algorithm(tier, jnp.result_type(a, b)))

    def parts(x):
        if jnp.iscomplexobj(x):
            return jnp.real(x), jnp.imag(x)
        return x, None

    (ar, ai), (br, bi) = parts(a), parts(b)
    prod = lambda x, y: dot(x, y, precision=dot_algorithm(
        tier, jnp.result_type(x, y)))
    re = prod(ar, br)
    im = None
    if ai is not None and bi is not None:
        re = re - prod(ai, bi)
    if bi is not None:
        im = prod(ar, bi)
    if ai is not None:
        im = prod(ai, br) if im is None else im + prod(ai, br)
    return jax.lax.complex(re, im)


def matmul(a, b, tier: str = "highest"):
    """jnp.matmul at `tier` (see the module note)."""
    return _tiered(jnp.matmul, a, b, tier)


def einsum(spec: str, a, b, tier: str = "highest"):
    """Two-operand jnp.einsum at `tier`."""
    return _tiered(lambda x, y, precision: jnp.einsum(
        spec, x, y, precision=precision), a, b, tier)


def check_tier(tier: str, dtype=jnp.float32, n: int = 256) -> float:
    """Compile and run one (n, n) product at `tier` on the default device;
    return its max error relative to an fp64 host product.  A preset the
    backend refuses raises RuntimeError naming the tier."""
    import numpy as np

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    if jnp.issubdtype(dtype, jnp.complexfloating):
        a = a + 1j * rng.standard_normal((n, n))
        b = b + 1j * rng.standard_normal((n, n))
    try:
        out = jax.jit(lambda x, y: matmul(x, y, tier))(
            jnp.asarray(a, dtype), jnp.asarray(b, dtype))
        out = np.asarray(out)
    except Exception as e:  # the compiler's own refusal, re-labelled
        raise RuntimeError(
            f"precision tier {tier!r} ({dot_algorithm(tier, dtype).name}) "
            f"does not compile on {jax.devices()[0].platform}: {e}") from e
    ref = a @ b
    return float(np.abs(out - ref).max() / np.abs(ref).max())
