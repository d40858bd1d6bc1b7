"""Automatic-SPMD solver steps: jit + NamedSharding over a 2D device mesh.

The full simulation step (the framework's "training step") compiles once
with the fields sharded P("x","y"); XLA's SPMD partitioner inserts the
collectives — halo exchanges for the stencil terms, all-to-all transposes
for the pencil-decomposed FFTs (ops.spectral mesh plumbing). The manual
ppermute path for the stencil half lives in parallel.halo.

Node-centred (n+1-sized) fields are padded up to mesh-divisible shapes at
the jit boundary (GSPMD requires divisible in/out shardings); the step
operates on the logical [:n+1, :n+1] view and the padding rides along.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from cfd_julia_tpu.models import cavity as cavity_model
from cfd_julia_tpu.models import vortex as vortex_model
from cfd_julia_tpu.parallel import mesh as mesh_lib


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_shape(shape, mesh):
    px, py = mesh.devices.shape
    return (_round_up(shape[0], px), _round_up(shape[1], py))


def pad_to_mesh(arr, mesh):
    ps = padded_shape(arr.shape, mesh)
    return jnp.pad(arr, ((0, ps[0] - arr.shape[0]), (0, ps[1] - arr.shape[1])))


def make_sharded_cavity_step(cfg, mesh):
    """Sharded full cavity step over padded fields:
    (w_pad, s_pad, rms) -> (w_pad, s_pad, rms).

    Uses the pure-dataflow padded step (masked rolls + MXU-matmul DST):
    every op keeps its operands' sharding, so the partitioner emits plain
    halo collectives and matmul all-gathers — no involuntary full
    rematerialization (the logical-grid step's slice/concat BC assembly
    triggered it on every stage)."""
    sh = mesh_lib.field_sharding(mesh)
    rep = mesh_lib.replicated(mesh)
    ps = padded_shape((cfg.nx + 1, cfg.ny + 1), mesh)
    step = cavity_model.make_padded_step_fn(cfg, ps)
    return jax.jit(
        step,
        in_shardings=((sh, sh, rep),),
        out_shardings=(sh, sh, rep),
    )


def make_sharded_vortex_step(cfg, mesh, dtype):
    """Sharded pseudospectral / hybrid / FDM vortex-merger step (periodic
    grids are nx x ny — naturally mesh-divisible for power-of-two sizes).

    fdm: real (nx, ny) state, field-sharded.  Spectral solvers: the
    state at the jit boundary is the PACKED real (2, nx, ny) Re/Im
    stack (packed_full_sharding, spectral.pack_c), so the complex
    spectrum lives only inside jit."""
    if cfg.solver == "fdm":
        from cfd_julia_tpu.stepping import ssprk3

        # the matmul FFT is a single-device form (parallel.halo carries
        # the manual-collective stencil RHS) — "auto" resolves to the XLA
        # FFT here; anything else explicit fails loudly rather than
        # silently timing the default
        cfg = vortex_model._resolved(cfg, single_device=False)
        if cfg.fft_impl != "xla":
            raise ValueError(
                f"sharded fdm step supports fft_impl='xla' only (got "
                f"{cfg.fft_impl!r}); the matmul FFT is single-device")
        sh = mesh_lib.field_sharding(mesh)
        rhs = lambda w: vortex_model.fdm_rhs(
            w, cfg.dx, cfg.dy, cfg.re, mesh, fft_impl=cfg.fft_impl)
        step = lambda w: ssprk3.ssprk3_step(rhs, w, cfg.dt)
        return jax.jit(step, in_shardings=(sh,), out_shardings=sh)

    from cfd_julia_tpu.ops import spectral

    inner = vortex_model.make_spectral_step(cfg, dtype, mesh=mesh)
    step = lambda h: spectral.pack_c(inner(spectral.unpack_c(h)))
    sh = packed_full_sharding(mesh)
    return jax.jit(step, in_shardings=(sh,), out_shardings=sh)


def packed_full_sharding(mesh):
    """(2, nx, ny) packed full-spectrum sharding: the Re/Im axis
    replicated, the spatial axes over the 2D mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P(None, *mesh.axis_names))


def make_sharded_vortex_step_half(cfg, mesh, dtype):
    """Sharded HALF-SPECTRUM packed step — the fast single-chip
    formulation (real (2, nx, ny//2+1) rfft2 state, two-for-one packed
    inverses) extended to the mesh: transforms pencil-decompose via
    sharding constraints inside make_spectral_step_half, and the packed
    state itself shards its kx axis over the flattened mesh."""
    step = vortex_model.make_spectral_step_half_packed(cfg, dtype, mesh)
    sh = packed_half_sharding(mesh)
    return jax.jit(step, in_shardings=(sh,), out_shardings=sh)


def packed_half_sharding(mesh):
    """(2, nx, ny//2+1) packed half-spectrum sharding: kx axis over the
    flattened mesh, Re/Im and ky axes replicated."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P(None, tuple(mesh.axis_names), None))


def place(arr, mesh):
    """Place a field with the mesh's 2D sharding (shape must divide)."""
    return jax.device_put(arr, mesh_lib.field_sharding(mesh))
