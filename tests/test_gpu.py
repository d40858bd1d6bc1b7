"""GPU tier: small fp32 runs on the card, one per family.

    CFD_TEST_GPU=1 python -m pytest -m gpu tests/test_gpu.py -q

The CPU suite never exercises the GPU backend's own code: cuFFT, the
compiled Triton kernel, the dot-algorithm presets.  Each case here
compiles and runs on the card and, where it can, cross-checks the same
program on the in-process CPU backend.  Without a GPU every case skips
(the `gpu` fixture, tests/conftest.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _on_cpu(fn, *args):
    """Run fn on the in-process CPU backend for cross-checking."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return fn(*[jax.device_put(a, cpu) for a in args])


def test_cavity_step_matches_cpu(gpu):
    """One cavity step (Arakawa + DST-I Poisson): GPU vs CPU backend,
    the Poisson solver pinned so both run the same program."""
    from cfd_julia_tpu.models import cavity

    cfg = cavity.CavityConfig(nx=64, ny=64, poisson="fst")
    step = cavity.make_step_fn(cfg)
    w0 = jnp.zeros((65, 65), jnp.float32)
    state = (w0, jnp.zeros_like(w0), jnp.zeros((), jnp.float32))
    run = lambda st: step(step(st))  # two steps so BCs feed back
    out_gpu = jax.jit(run)(jax.device_put(state, gpu))
    out_cpu = _on_cpu(jax.jit(run), state)
    np.testing.assert_allclose(np.asarray(out_gpu[0]), np.asarray(out_cpu[0]),
                               rtol=0, atol=5e-5)


def test_cavity_matmul_poisson_matches_fst(gpu):
    """Dense sine-matmul Poisson vs the rfft DST path, both on the GPU."""
    from cfd_julia_tpu.models import cavity

    w0 = jnp.zeros((65, 65), jnp.float32)
    state = (w0, jnp.zeros_like(w0), jnp.zeros((), jnp.float32))
    outs = {}
    for poisson in ("fst", "matmul"):
        cfg = cavity.CavityConfig(nx=64, ny=64, poisson=poisson)
        step = jax.jit(cavity.make_step_fn(cfg))
        st = state
        for _ in range(3):
            st = step(st)
        outs[poisson] = np.asarray(st[1])
    np.testing.assert_allclose(outs["matmul"], outs["fst"],
                               rtol=0, atol=5e-5)


def test_ps23_half_spectrum_step(gpu):
    """Half-spectrum pseudospectral step executes on the GPU (rfft2
    forward, packed-pair inverse) and matches CPU."""
    from cfd_julia_tpu.models import vortex

    cfg = vortex.VortexConfig(nx=64, ny=64, solver="ps23", dt=0.01)
    step = vortex.make_spectral_step_half_packed(cfg, jnp.float32)
    w0 = vortex.initial_vorticity(cfg, jnp.float32)
    run = jax.jit(lambda w: step(step(vortex.half_init_packed(w))))
    out_gpu = np.asarray(run(jax.device_put(w0, gpu)))
    out_cpu = np.asarray(_on_cpu(run, w0))
    np.testing.assert_allclose(out_gpu, out_cpu, rtol=0, atol=1e-4)


def test_multigrid_fp32(gpu):
    """One V-cycle stack at 256^2 converges on the GPU (red-black
    smoother, conv transfers)."""
    from cfd_julia_tpu.models import poisson2d
    from cfd_julia_tpu.poisson import multigrid

    mgc = multigrid.MGConfig(tol=1e-5, max_cycles=20)
    cfg = poisson2d.PoissonConfig(nx=256, ny=256, solver="multigrid",
                                  problem="poly", mg=mgc)
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, jnp.float32)
    u0 = poisson2d._dirichlet_init(ue)
    res = multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=mgc)
    # res.rms is the RAW residual rms (the round-4 residual-report
    # contract); the convergence claim is relative — CPU gives the same
    # 8.4e-7 ratio / 4 cycles for this problem (rms0 ~ 4255)
    assert float(res.rms / res.rms0) <= mgc.tol
    assert np.isfinite(np.asarray(res.u)).all()


def test_multigrid_cheb_fp32(gpu):
    """The Chebyshev-smoothed form (matmul transfers) converges on the
    card at 512^2 and matches the RB solve within fp32 slack."""
    from cfd_julia_tpu.models import poisson2d
    from cfd_julia_tpu.poisson import multigrid

    sols = {}
    for smoother in ("auto", "cheb"):
        mgc = multigrid.MGConfig(tol=1e-5, max_cycles=20,
                                 transfers="matmul", smoother=smoother)
        cfg = poisson2d.PoissonConfig(nx=512, ny=512, solver="multigrid",
                                      problem="poly", mg=mgc)
        _, _, _, _, ue, f = poisson2d.build_problem(cfg, jnp.float32)
        u0 = poisson2d._dirichlet_init(ue)
        res = multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=mgc)
        assert float(res.rms / res.rms0) <= 1e-5, smoother
        sols[smoother] = np.asarray(res.u)
    scale = np.abs(sols["auto"]).max()
    assert np.abs(sols["cheb"] - sols["auto"]).max() / scale < 1e-3


@pytest.mark.parametrize("n", [255, 4096])
def test_rb_kernel_compiled(gpu, n):
    """The Triton red-black kernel compiles for the card (not interpret
    mode) and matches the XLA sweep, at an odd size and at 4096^2."""
    from cfd_julia_tpu.ops import rb_kernel
    from cfd_julia_tpu.poisson import iterative

    dx = dy = 1.0 / n
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal((n + 1, n + 1)), jnp.float32)
    f = jnp.asarray(rng.standard_normal((n + 1, n + 1)), jnp.float32)
    mr, mb = iterative.color_masks(n, n, jnp.float32)
    ref = jax.jit(lambda u, f, mr, mb: iterative.redblack_sweep(
        u, f, dx, dy, mr, mb))(u, f, mr, mb)
    out = rb_kernel.redblack_sweep(u, f, dx, dy)
    scale = float(jnp.abs(ref).max())
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("tier,bound", [("highest", 1e-5), ("high", 1e-5),
                                        ("default", 1e-2)])
@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_precision_tier_compiles(gpu, tier, bound, dtype):
    """Each tier's DotAlgorithmPreset compiles on the card and delivers
    its arithmetic: fp32 / 3-pass bf16 near fp32, 1-pass bf16 ~1e-3."""
    from cfd_julia_tpu.core import precision

    err = precision.check_tier(tier, jnp.dtype(dtype))
    assert err < bound, (tier, dtype, err)


def test_euler_sod_fp32(gpu):
    """Euler HLLC Sod tube at the ch. 10 config stays physical."""
    from cfd_julia_tpu.models import euler1d

    cfg = euler1d.EulerConfig(nx=1024, t_final=0.05, solver="hllc")
    res = euler1d.solve(cfg, jnp.float32)
    rho, u, p, _ = euler1d.primitives_from_result(res, cfg.gamma)
    assert float(jnp.min(rho)) > 0 and float(jnp.min(p)) > 0
    assert np.isfinite(np.asarray(res.q)).all()


def test_fp32_tgv_error(gpu):
    """fp32 TGV decay error on the GPU stays near the fp64 CPU value
    (spectral solver: CN time error ~8.5e-6 at 64^2 in fp64; fp32 adds
    roundoff -> allow 5e-5)."""
    from cfd_julia_tpu.models import vortex

    cfg = vortex.VortexConfig(nx=64, ny=64, solver="ps23", dt=0.01,
                              t_final=1.0, re=10.0, ic="tgv", ns=1)
    res = vortex.solve(cfg, jnp.float32)
    l2, _ = vortex.tgv_error(cfg, res)
    assert float(l2) < 5e-5, float(l2)


def test_mxu_fft_variants(gpu):
    """Four-step matmul FFT on the card: fp32 round trip and rfft2
    parity vs cuFFT at both tiers."""
    from cfd_julia_tpu.ops import mxu_fft, spectral

    rng = np.random.default_rng(8)
    h = jnp.asarray(rng.standard_normal((2, 256, 256)), jnp.float32)
    xr = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)
    # bounds RELATIVE to the spectrum scale (fwd values are O(N)): fp32
    # products accumulate ~1e-6 over the 128-long contractions
    for prec, rel in (("highest", 1e-5), ("high", 2e-4)):
        @jax.jit
        def err(hh, p=prec):
            z = spectral.unpack_c(hh)
            fwd = jnp.fft.fft2(z)
            a = jnp.abs(mxu_fft.fft2_matmul(z, p) - fwd).max()
            b = jnp.abs(mxu_fft.ifft2_matmul(z, p) - jnp.fft.ifft2(z)).max()
            rr = jnp.fft.rfft2(xr)
            c = jnp.abs(mxu_fft.rfft2_matmul(xr, p) - rr).max()
            return (a / jnp.abs(fwd).max(), b,
                    c / jnp.abs(rr).max())

        a, b, c = err(h)
        assert float(a) < rel, (prec, float(a))
        assert float(b) < 1e-5, (prec, float(b))   # inverse is O(1)
        assert float(c) < rel, (prec, float(c))


def test_ps23_variant_steps_match(gpu):
    """The ps23 formulations (matmul FFT at the high tier,
    mirror-after-rows pairs) all step to the same fp32 state."""
    from cfd_julia_tpu.models import vortex

    w0 = None
    outs = {}
    for name, kw in {
        "base": dict(),
        "mm_high": dict(fft_impl="matmul", fft_precision="high"),
        "rowsfirst": dict(pair_impl="rowsfirst"),
    }.items():
        cfg = vortex.VortexConfig(nx=128, ny=128, solver="ps23", dt=5e-3,
                                  **kw)
        step = vortex.make_spectral_step_half_packed(cfg, jnp.float32)
        if w0 is None:
            w0 = vortex.initial_vorticity(cfg, jnp.float32)
        run = jax.jit(lambda w, s=step: s(s(vortex.half_init_packed(w))))
        outs[name] = np.asarray(run(w0))
    scale = np.abs(outs["base"]).max()
    for name in ("mm_high", "rowsfirst"):
        d = np.abs(outs[name] - outs["base"]).max() / scale
        assert d < 1e-4, (name, d)


def test_cavity_new_poisson_variants(gpu):
    """fst_half, fst_half_mxu (both tiers) and the bf16x3 matmul solver
    step to the fst baseline's state on the card."""
    from cfd_julia_tpu.models import cavity

    w0 = jnp.zeros((129, 129), jnp.float32)
    state = (w0, jnp.zeros_like(w0), jnp.zeros((), jnp.float32))
    outs = {}
    for name, kw in {
        "base": dict(poisson="fst"),
        "half_mxu_hi": dict(poisson="fst_half_mxu"),
        "half_mxu_fast": dict(poisson="fst_half_mxu", fft_precision="high"),
        "half": dict(poisson="fst_half"),
        "bf16x3": dict(poisson="matmul_bf16x3"),
    }.items():
        cfg = cavity.CavityConfig(nx=128, ny=128, **kw)
        step = jax.jit(cavity.make_step_fn(cfg))
        st = state
        for _ in range(3):
            st = step(st)
        outs[name] = np.asarray(st[1])
    scale = max(np.abs(outs["base"]).max(), 1e-30)
    for name in ("half_mxu_hi", "half_mxu_fast", "half", "bf16x3"):
        d = np.abs(outs[name] - outs["base"]).max() / scale
        assert d < 1e-3, (name, d)
