"""Ensemble (data-parallel) simulation: vmap over initial conditions or
physics parameters.

The reference's only concurrency is launching its 22 scripts as separate
OS processes (run.sh:14-52). On an accelerator the equivalent is free:
`jax.vmap` turns any solver step into a batched step over an ensemble of
states (and, via in_axes, over per-member parameters such as Reynolds
number), which XLA fuses into batched kernels on one chip — or shards
across chips with a mesh axis (SURVEY §2.5, DP row).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from cfd_julia_tpu.core import precision
from cfd_julia_tpu.models import vortex
from cfd_julia_tpu.stepping import loop, ssprk3


@dataclasses.dataclass
class EnsembleResult:
    res: jnp.ndarray      # Reynolds numbers (B,)
    w: jnp.ndarray        # final vorticity (B, nx, ny)


def vortex_fdm_re_sweep(cfg: vortex.VortexConfig, reynolds, dtype=None
                        ) -> EnsembleResult:
    """Run the FDM vortex merger for a batch of Reynolds numbers in one
    batched device program (vmapped over the viscous coefficient)."""
    dtype = dtype or precision.default_dtype()
    cfg = vortex._resolved(cfg)
    res = jnp.asarray(reynolds, dtype)
    w0 = vortex.initial_vorticity(cfg, dtype)
    w0_b = jnp.broadcast_to(w0, (res.shape[0],) + w0.shape)

    def solve_one(w, re):
        rhs = lambda ww: vortex.fdm_rhs(ww, cfg.dx, cfg.dy, re,
                                        fft_impl=cfg.fft_impl)
        step = lambda ww: ssprk3.ssprk3_step(rhs, ww, cfg.dt)
        return loop.run_steps(step, w, cfg.nt)

    w_final = jax.vmap(solve_one)(w0_b, res)
    return EnsembleResult(res=res, w=w_final)
