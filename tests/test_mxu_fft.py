"""Four-step matmul FFT vs jnp.fft (exactness in fp64, tolerance in
fp32), all layouts the solvers use: 1D lines, batched 2D, rfft2."""
import numpy as np
import pytest

import jax.numpy as jnp

from cfd_julia_tpu.ops import mxu_fft

RNG = np.random.default_rng(42)


@pytest.mark.parametrize("n", [16, 64, 128, 512])
def test_fft_matmul_matches(n):
    x = jnp.asarray(RNG.standard_normal((5, n))
                    + 1j * RNG.standard_normal((5, n)))
    np.testing.assert_allclose(np.asarray(mxu_fft.fft_matmul(x)),
                               np.asarray(jnp.fft.fft(x)),
                               rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(np.asarray(mxu_fft.ifft_matmul(x)),
                               np.asarray(jnp.fft.ifft(x)),
                               rtol=1e-10, atol=1e-12)


def test_fft_matmul_axis0():
    x = jnp.asarray(RNG.standard_normal((64, 7))
                    + 1j * RNG.standard_normal((64, 7)))
    np.testing.assert_allclose(np.asarray(mxu_fft.fft_matmul(x, axis=0)),
                               np.asarray(jnp.fft.fft(x, axis=0)),
                               rtol=1e-10, atol=1e-9)


@pytest.mark.parametrize("shape", [(64, 64), (2, 32, 128)])
def test_fft2_matmul_matches(shape):
    x = jnp.asarray(RNG.standard_normal(shape)
                    + 1j * RNG.standard_normal(shape))
    np.testing.assert_allclose(np.asarray(mxu_fft.fft2_matmul(x)),
                               np.asarray(jnp.fft.fft2(x)),
                               rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(np.asarray(mxu_fft.ifft2_matmul(x)),
                               np.asarray(jnp.fft.ifft2(x)),
                               rtol=1e-9, atol=1e-11)


def test_rfft2_matmul_matches():
    x = jnp.asarray(RNG.standard_normal((64, 128)))
    np.testing.assert_allclose(np.asarray(mxu_fft.rfft2_matmul(x)),
                               np.asarray(jnp.fft.rfft2(x)),
                               rtol=1e-10, atol=1e-9)


def test_fp32_accuracy():
    """fp32 matmul-FFT error stays near jnp.fft's own fp32 error."""
    x64 = RNG.standard_normal((128, 128)) + 1j * RNG.standard_normal((128, 128))
    ref = np.fft.fft2(x64)
    x32 = jnp.asarray(x64, jnp.complex64)
    err_mm = np.abs(np.asarray(mxu_fft.fft2_matmul(x32)) - ref).max()
    err_jx = np.abs(np.asarray(jnp.fft.fft2(x32)) - ref).max()
    scale = np.abs(ref).max()
    assert err_mm / scale < 1e-5, (err_mm / scale, err_jx / scale)
    assert err_mm < 20 * err_jx + 1e-4 * scale


def test_high_precision_bf16x3_bound():
    """precision="high" lowers every einsum to the BF16_BF16_F32_X3
    preset, 3-pass bf16 (a.hi@b.hi + a.hi@b.lo + a.lo@b.hi, fp32
    accumulation; core.precision).  The CPU backend may run fp32
    products instead, so emulate the decomposition in NumPy against the
    same four-step constants and bound the end-to-end FFT error it
    introduces on a backend that honours the preset — it must stay near
    fp32-FFT roundoff (the `fst_half_mxu,high` cavity and ps23
    `matmul,high` bench variants, bench.py)."""
    import ml_dtypes

    from cfd_julia_tpu.ops.mxu_fft import _block_factor, _consts_np, _split

    def split_bf16(a):
        hi = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        lo = (a - hi).astype(ml_dtypes.bfloat16).astype(np.float32)
        return hi, lo

    def mm3x(a, b):
        # one real matmul at the 3-pass tier (fp32 accumulate)
        ah, al = split_bf16(np.asarray(a, np.float32))
        bh, bl = split_bf16(np.asarray(b, np.float32))
        acc = (ah.astype(np.float64) @ bh.astype(np.float64)).astype(np.float32)
        acc += (ah.astype(np.float64) @ bl.astype(np.float64)).astype(np.float32)
        acc += (al.astype(np.float64) @ bh.astype(np.float64)).astype(np.float32)
        return acc

    def cmm3x(a, b):
        # complex matmul as XLA lowers it: 4 real contractions
        re = mm3x(a.real, b.real) - mm3x(a.imag, b.imag)
        im = mm3x(a.real, b.imag) + mm3x(a.imag, b.real)
        return re + 1j * im.astype(np.float64)

    n = 2048                      # the ps23/vortex production length
    n1, n2 = _split(n)
    g = _block_factor(n1, n2)
    f1, tw, f2blk = _consts_np(n, False)

    x = RNG.standard_normal((4, n)) + 1j * RNG.standard_normal((4, n))
    # replicate _apply_last's dataflow with emulated-precision matmuls
    xm = np.swapaxes(x.reshape(4, n2, n1), -1, -2)
    zm = xm.reshape(4, n1 // g, g * n2)
    y = np.stack([cmm3x(zm[i], f2blk) for i in range(4)])
    z = y.reshape(4, n1, n2) * tw
    out = np.stack([cmm3x(f1, z[i]) for i in range(4)]).reshape(4, n)

    ref = np.fft.fft(x)
    scale = np.abs(ref).max()
    rel_high = np.abs(out - ref).max() / scale
    # fp32 jnp.fft's own roundoff on the same data, for context
    err_fp32 = np.abs(
        np.asarray(jnp.fft.fft(jnp.asarray(x, jnp.complex64))) - ref
    ).max() / scale
    assert rel_high < 2e-4, (rel_high, err_fp32)
    assert rel_high < 50 * err_fp32 + 1e-5, (rel_high, err_fp32)


@pytest.mark.parametrize("n", [48, 96, 3072 // 16])
def test_composite_lengths(n):
    x = jnp.asarray(RNG.standard_normal((3, n))
                    + 1j * RNG.standard_normal((3, n)))
    np.testing.assert_allclose(np.asarray(mxu_fft.fft_matmul(x)),
                               np.asarray(jnp.fft.fft(x)),
                               rtol=1e-10, atol=1e-9)


def test_prime_length_handling():
    """Primes <= 128 run as one dense matmul; larger primes (no composite
    split, dense matrix would be huge) still raise."""
    x = jnp.asarray(np.random.default_rng(3).standard_normal((4, 37)),
                    jnp.complex128)
    np.testing.assert_allclose(np.asarray(mxu_fft.fft_matmul(x)),
                               np.fft.fft(np.asarray(x)),
                               rtol=1e-12, atol=1e-11)
    with pytest.raises(ValueError):
        mxu_fft.fft_matmul(jnp.zeros((4, 131), jnp.complex128))
