"""Adjoint sensitivity of the lid-driven cavity to the Reynolds number.

The reference's Julia scripts can only *run* the cavity; here the whole
solver (RK3 + wall BCs + DST Poisson, inside lax.scan) is a pure JAX
function, so reverse-mode AD delivers d(loss)/d(Re) in one backward
pass — the building block for data assimilation / design optimization.

    JAX_PLATFORMS=cpu python examples/adjoint_cavity.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from cfd_julia_tpu.jaxconfig import configure_cache, pin_platform

pin_platform()
configure_cache()

from cfd_julia_tpu.models import cavity          # noqa: E402
from cfd_julia_tpu.stepping import loop          # noqa: E402

NX, STEPS, DT = 32, 100, 1e-3
cfg = cavity.CavityConfig(nx=NX, ny=NX, dt=DT)


def loss(re):
    """Mean-square streamfunction after STEPS steps, as a function of a
    *traced* Reynolds number — make_step_fn accepts re as a tracer, so
    this is the production step, not a re-implementation."""
    step = cavity.make_step_fn(cfg, re=re)
    w0 = jnp.zeros((NX + 1, NX + 1), jnp.float32)
    final = loop.run_steps(step, (w0, jnp.zeros_like(w0),
                                  jnp.zeros((), jnp.float32)), STEPS)
    return 1e6 * jnp.mean(final[1] ** 2)


if __name__ == "__main__":
    val, grad = jax.jit(jax.value_and_grad(loss))(100.0)
    print(f"loss(Re=100)      = {float(val):.6f}")
    print(f"d loss / d Re     = {float(grad):.6e}")
    res = jnp.asarray([50.0, 100.0, 200.0])
    grads = jax.jit(jax.vmap(jax.grad(loss)))(res)
    for r, g in zip(res, grads):
        print(f"d loss / d Re @ Re={float(r):5.0f} : {float(g):.6e}")
