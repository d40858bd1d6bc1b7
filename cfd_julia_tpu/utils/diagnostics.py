"""Flow diagnostics for the periodic 2D solvers (beyond the reference,
which only writes raw fields): kinetic-energy spectrum E(k), integral
invariants (energy, enstrophy, palinstrophy), and their viscous decay
rates — the standard quantities for 2D-turbulence studies like the
vortex merger (reference ch. 19-22 problems).

All device-resident jnp; the radial binning is a one-hot matmul (no
scatters).  The public entry points are jitted: complex
values appear only as jit-internal intermediates and every return is
real, per the project's complex-boundary rule (ops.spectral.pack_c) —
so they are safe to call eagerly on the solver's device-resident
state."""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _wavenumber_grid(nx: int, ny: int):
    """Integer wavenumber components on the rfft2 half grid (nx, ny//2+1)
    and the multiplicity weights that make half-spectrum sums equal full
    ones (interior columns count twice)."""
    kx = jnp.where(jnp.arange(nx) < nx // 2, jnp.arange(nx),
                   jnp.arange(nx) - nx)[:, None]
    ky = jnp.arange(ny // 2 + 1)[None, :]
    ftype = jnp.zeros(()).dtype            # follows the x64 config
    kxf = jnp.broadcast_to(kx.astype(ftype), (nx, ny // 2 + 1))
    kyf = jnp.broadcast_to(ky.astype(ftype), (nx, ny // 2 + 1))
    w = jnp.where((ky == 0) | ((ny % 2 == 0) & (ky == ny // 2)), 1.0, 2.0)
    return kxf, kyf, jnp.broadcast_to(w, (nx, ny // 2 + 1))


@partial(jax.jit, static_argnames=("packed", "ny"))
def energy_spectrum(w, packed: bool = False, ny: int | None = None):
    """Radially binned kinetic-energy spectrum E(k) of a periodic 2D
    vorticity field w (nx, ny): E(k) = sum_{|k'| in [k-1/2,k+1/2)}
    |w_hat|^2 / (2 |k'|^2) with Parseval normalization 1/(nx ny)^2.

    Returns (k_bins, E) with k_bins = 1..min(nx,ny)//2.  packed=True
    takes the real-packed (2, nx, ny//2+1) half spectrum instead of the
    physical field (the solver state — no extra transform).

    The integer-|k| radial binning assumes equal physical domain lengths
    (nx dx == ny dy, e.g. the reference's [0,2pi]^2 with any nx == ny);
    for anisotropic domains bin on physical |k| instead."""
    if packed:
        H = w[0] + 1j * w[1]
        nx, hy = H.shape
        if ny is None:
            # the half width hy = ny//2+1 is ambiguous: both ny=2(hy-1)
            # (even) and ny=2hy-1 (odd) map to it — assume even, as the
            # solver grids are, and require the explicit ny otherwise
            ny = 2 * (hy - 1)
        elif ny // 2 + 1 != hy:
            raise ValueError(f"ny={ny} inconsistent with half width {hy}")
    else:
        nx, ny = w.shape
        H = jnp.fft.rfft2(w)
    kx, ky, mult = _wavenumber_grid(nx, ny)
    kmag = jnp.sqrt(kx**2 + ky**2)
    k2 = jnp.maximum(kmag**2, 1e-12)
    dens = mult * jnp.abs(H) ** 2 / (2.0 * k2) / (nx * ny) ** 2
    nbins = min(nx, ny) // 2
    kb = jnp.arange(1, nbins + 1)
    # segment-sum binning: the one-hot einsum materialized a
    # (nbins, nx, ny/2+1) tensor — ~8.6 GB at the 2048^2 bench grid.
    # This is a scatter-add (a slow op class) but it is a one-off
    # diagnostic, and memory beats speed here.
    r = jnp.round(kmag).astype(jnp.int32)
    r = jnp.where((r >= 1) & (r <= nbins), r, nbins + 1)
    e = jax.ops.segment_sum(dens.ravel(), r.ravel(),
                            num_segments=nbins + 2)
    return kb, e[1 : nbins + 1]


@jax.jit
def invariants(w, dx: float, dy: float):
    """(energy, enstrophy, palinstrophy) integrals of a periodic 2D
    vorticity field: E = 1/2 int |u|^2, Z = 1/2 int w^2,
    P = 1/2 int |grad w|^2.  For decaying 2D NS: dE/dt = -2 nu Z,
    dZ/dt = -2 nu P (the enstrophy-budget identity used as a solver
    diagnostic).  Correct for anisotropic domains: |k|^2 is built from
    per-axis physical wavenumber spacings 2 pi/(n d)."""
    nx, ny = w.shape
    H = jnp.fft.rfft2(w)
    kx, ky, mult = _wavenumber_grid(nx, ny)
    sx = 2.0 * jnp.pi / (nx * dx)        # physical wavenumber spacings,
    sy = 2.0 * jnp.pi / (ny * dy)        # per axis
    k2phys = (kx * sx) ** 2 + (ky * sy) ** 2
    zero = (kx == 0) & (ky == 0)
    k2phys = jnp.where(zero, 1.0, k2phys)    # guarded; mode masked below
    mult = jnp.where(zero, 0.0, mult)    # gauge: mean mode carries
                                         # no velocity/enstrophy
    area = (nx * dx) * (ny * dy)
    cell = area / (nx * ny) ** 2
    # spectral integrals (exact for band-limited fields)
    e = 0.5 * jnp.sum(mult * jnp.abs(H) ** 2 / k2phys) * cell
    z = 0.5 * jnp.sum(mult * jnp.abs(H) ** 2) * cell
    p = 0.5 * jnp.sum(mult * k2phys * jnp.abs(H) ** 2) * cell
    return e, z, p
