"""The Pallas red-black kernel (ops.rb_kernel, Triton route) in interpret
mode on CPU, against the XLA sweep it replaces."""
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_julia_tpu.ops import rb_kernel
from cfd_julia_tpu.poisson import iterative


@pytest.mark.parametrize("n,tile", [(32, 8), (33, 16), (65, 32)])
def test_redblack_fused_matches(n, tile):
    rng = np.random.default_rng(0)
    dx = dy = 1.0 / (n - 1)
    u = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    f = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    mr, mb = iterative.color_masks(n - 1, n - 1, jnp.float32)
    ref = iterative.redblack_sweep(u, f, dx, dy, mr, mb)
    out = rb_kernel.redblack_sweep(u, f, dx, dy, block=(tile, 2 * tile),
                                   interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("iters", [2, 4, 5])
def test_redblack_multi_sweep_per_call(iters):
    """`iters` sweeps (one launch each) equal iterated XLA sweeps."""
    n = 64
    dx = dy = 1.0 / n
    rng = np.random.default_rng(9)
    u = jnp.asarray(rng.standard_normal((n + 1, n + 1)))
    f = jnp.asarray(rng.standard_normal((n + 1, n + 1)))
    mr, mb = iterative.color_masks(n, n, u.dtype)
    ref = u
    for _ in range(iters):
        ref = iterative.redblack_sweep(ref, f, dx, dy, mr, mb)
    out = rb_kernel.redblack_sweeps(u, f, dx, dy, iters, interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("shape,block", [((17, 129), (8, 32)),
                                         ((41, 23), (4, 16)),
                                         ((65, 33), (8, 128))])
def test_rb_kernel_block_shapes(shape, block):
    """Tiles that do not divide the grid, in either direction, and tiles
    wider than the grid: the clamped loads and the masked store keep the
    sweep exact, boundary ring included."""
    rng = np.random.default_rng(2)
    nr, nc = shape
    dx, dy = 1.0 / (nr - 1), 1.0 / (nc - 1)
    u = jnp.asarray(rng.standard_normal(shape))
    f = jnp.asarray(rng.standard_normal(shape))
    mr, mb = iterative.color_masks(nr - 1, nc - 1, u.dtype)
    ref = iterative.redblack_sweep(u, f, dx, dy, mr, mb)
    out = rb_kernel.redblack_sweep(u, f, dx, dy, block=block,
                                   interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=1e-12)
    ring = np.ones(shape, bool)
    ring[1:-1, 1:-1] = False
    np.testing.assert_array_equal(np.asarray(out)[ring],
                                  np.asarray(u)[ring])


def test_rb_kernel_never_picks_interpret_itself():
    """Off the GPU the kernel raises unless interpret=True is asked for."""
    u = jnp.zeros((9, 9))
    with pytest.raises(ValueError, match="GPU only"):
        rb_kernel.redblack_sweep(u, u, 0.1, 0.1)


def test_mg_triton_smoother_needs_gpu():
    """smoother='triton' reaches the kernel only on large levels; on a
    CPU host the kernel's own check refuses it loudly."""
    from cfd_julia_tpu.poisson import multigrid

    assert multigrid._pick_smoother(64, 64, "triton", "cpu") == "xla"
    assert multigrid._pick_smoother(4096, 4096, "triton", "cpu") == "triton"
    u = jnp.zeros((513, 513))
    masks = iterative.color_masks(512, 512, u.dtype)
    with pytest.raises(ValueError, match="GPU only"):
        multigrid.smooth(u, u, 1 / 512, 1 / 512, 1, masks, "triton")
