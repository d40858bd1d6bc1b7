"""Explicit halo exchange over the device mesh (shard_map + ppermute).

The stencil half of every solver (Arakawa Jacobian, Laplacians, WENO) only
needs a 1-2 node halo from each neighbour — the device-mesh equivalent of
the reference's ghost-cell copies (vm.jl:30-76). `halo_exchange_periodic`
moves exactly those edges over the interconnect with `lax.ppermute`; the fused stencil
then runs on the padded local block with plain slice arithmetic.

This is the manual-collective path (scales to meshes where XLA's automatic
SPMD partitioner would materialize larger transfers); the automatic path
(jit + NamedSharding, XLA inserts the collectives) lives in
parallel.sharded.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P


def _ring_perm(n: int, shift: int):
    """Send-to permutation for a ring of size n (shift=+1 sends to i+1)."""
    return [(i, (i + shift) % n) for i in range(n)]


def halo_exchange_periodic(ul, mesh_shape: dict, width: int = 1,
                           axes=("x", "y")):
    """Pad a local block with `width` halo rows/cols from ring neighbours.

    Must be called inside shard_map over a 2D mesh. ul: (..., bx, by)
    local block -> (..., bx + 2w, by + 2w) padded block, periodic global
    topology.  Leading axes are batch: stacking several operands into
    one exchange halves the number of latency-bound ppermute rounds.
    """
    ax, ay = axes
    px, py = mesh_shape[ax], mesh_shape[ay]
    w = width

    # x-direction: my low halo = high edge of x-neighbour i-1
    hi_edge = ul[..., -w:, :]
    lo_edge = ul[..., :w, :]
    if px > 1:
        lo_halo = lax.ppermute(hi_edge, ax, _ring_perm(px, 1))
        hi_halo = lax.ppermute(lo_edge, ax, _ring_perm(px, -1))
    else:
        lo_halo, hi_halo = hi_edge, lo_edge
    up = jnp.concatenate([lo_halo, ul, hi_halo], axis=-2)

    # y-direction (exchange the already-x-padded edges so corners arrive)
    hi_edge = up[..., :, -w:]
    lo_edge = up[..., :, :w]
    if py > 1:
        lo_halo = lax.ppermute(hi_edge, ay, _ring_perm(py, 1))
        hi_halo = lax.ppermute(lo_edge, ay, _ring_perm(py, -1))
    else:
        lo_halo, hi_halo = hi_edge, lo_edge
    return jnp.concatenate([lo_halo, up, hi_halo], axis=-1)


def make_distributed_vorticity_rhs(mesh: Mesh, dx: float, dy: float,
                                   re: float):
    """shard_map'd r = -J(w,s) + lap(w)/re over a 2D-decomposed periodic
    field: ONE stacked 1-deep halo exchange for both operands (w and s
    ride a (2, bx, by) exchange — 4 ppermutes per RHS instead of 8; the
    halo edges are tiny latency-bound messages, so the collective
    count is the cost).  The local stencils are ops.arakawa's — the
    rolls never wrap on the [1:-1, 1:-1] interior of a 1-halo padded
    block (arakawa.jacobian docstring), so there is exactly one
    implementation of the 17-point coefficient set."""
    from cfd_julia_tpu.ops import arakawa

    mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    spec = P(*mesh.axis_names)

    def local_rhs(wl, sl):
        bp = halo_exchange_periodic(jnp.stack([wl, sl]), mesh_shape, 1,
                                    mesh.axis_names)
        wp, sp = bp[0], bp[1]
        return (-arakawa.jacobian(wp, sp, dx, dy)[1:-1, 1:-1]
                + arakawa.laplacian(wp, dx, dy)[1:-1, 1:-1] / re)

    return jax.shard_map(
        local_rhs, mesh=mesh, in_specs=(spec, spec), out_specs=spec
    )


def halo_exchange_1d_periodic(ul, axis_name: str, n_dev: int, width: int):
    """Pad a local 1D block with `width` ring-neighbour values per side."""
    hi_edge = ul[..., -width:]
    lo_edge = ul[..., :width]
    if n_dev > 1:
        lo_halo = lax.ppermute(hi_edge, axis_name, _ring_perm(n_dev, 1))
        hi_halo = lax.ppermute(lo_edge, axis_name, _ring_perm(n_dev, -1))
    else:
        lo_halo, hi_halo = hi_edge, lo_edge
    return jnp.concatenate([lo_halo, ul, hi_halo], axis=-1)


def make_distributed_burgers_weno_rhs(mesh: Mesh, dx: float,
                                      axis_name: str | None = None):
    """shard_map'd periodic WENO-5 Burgers RHS over a 1D-decomposed line:
    one width-3 halo exchange, then full local reconstruction of both
    edge-state families and the upwind derivative
    (weno_periodic.jl:58-68 semantics; cf. models.burgers1d
    ._rhs_upwind_periodic for the single-device form)."""
    from cfd_julia_tpu.ops import weno

    axis_name = axis_name or mesh.axis_names[0]
    n_dev = dict(zip(mesh.axis_names, mesh.devices.shape))[axis_name]
    spec = P(axis_name)

    def local_rhs(ul):
        n = ul.shape[-1]
        up = halo_exchange_1d_periodic(ul, axis_name, n_dev, 3)
        # uL[j] for j=-1..n-1: stencil u_{j-2..j+2} -> pad idx k..k+n
        vL = [up[..., k : k + n + 1] for k in range(5)]
        uL = weno.weno5_L(*vL)
        # uR[j] for j=0..n: pad idx 1+k..1+k+n
        vR = [up[..., 1 + k : 1 + k + n + 1] for k in range(5)]
        uR = weno.weno5_R(*vR)
        dpos = (uL[..., 1:] - uL[..., :-1]) / dx
        dneg = (uR[..., 1:] - uR[..., :-1]) / dx
        return -ul * jnp.where(ul >= 0.0, dpos, dneg)

    return jax.shard_map(
        local_rhs, mesh=mesh, in_specs=(spec,), out_specs=spec
    )


def make_distributed_jacobi_step(mesh: Mesh, dx: float, dy: float):
    """One distributed point-Jacobi sweep for periodic Poisson
    lap(u) = f (zero-mean gauge handled by the caller)."""
    mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    spec = P(*mesh.axis_names)
    diag = -2.0 / dx**2 - 2.0 / dy**2

    def sweep(ul, fl):
        from cfd_julia_tpu.ops import arakawa

        up = halo_exchange_periodic(ul, mesh_shape, 1, mesh.axis_names)
        r = fl - arakawa.laplacian(up, dx, dy)[1:-1, 1:-1]
        return ul + r / diag

    return jax.shard_map(
        sweep, mesh=mesh, in_specs=(spec, spec), out_specs=spec
    )
