"""Direct (transform-based) Poisson solvers on node-centred grids.

Wraps ops.spectral with the reference's full-grid conventions:
* periodic FFT solvers take/return (nx+1, ny+1) node grids, solving on the
  nx x ny unique nodes and wrapping the duplicated boundary
  (fft_p.jl:92-104, fft_s.jl).
* the FST solver takes the full grid, solves the (nx-1)x(ny-1) interior
  with homogeneous Dirichlet boundaries and zero-fills the boundary ring
  (fft_d.jl:70-76).
"""
from __future__ import annotations

import jax.numpy as jnp

from cfd_julia_tpu.core import precision
from cfd_julia_tpu.ops import spectral


def solve_fft(f, dx: float, dy: float, eigen: str = "fdm", mesh=None):
    """Periodic Poisson solve; f, result: (nx+1, ny+1) with wrapped edges."""
    un = spectral.fft_poisson_periodic(f[:-1, :-1], dx, dy, eigen=eigen, mesh=mesh)
    row = un[:1, :]
    un_full = jnp.concatenate([un, row], axis=0)
    col = un_full[:, :1]
    return jnp.concatenate([un_full, col], axis=1)


def solve_fst(f, dx: float, dy: float, mesh=None, impl: str = "rfft",
              precision: str = "highest"):
    """Homogeneous-Dirichlet Poisson solve via DST-I on the interior.
    (Boundary ring rebuilt with jnp.pad, not scatter — GSPMD-safe.)"""
    interior = spectral.fst_poisson_dirichlet(f[1:-1, 1:-1], dx, dy,
                                              mesh=mesh, impl=impl,
                                              precision=precision)
    return jnp.pad(interior, 1)


def sine_matrix(n: int, size: int, dtype):
    """(size, size) zero-extended DST-I matrix: S[r, c] = sin(pi r c / n)
    for r, c < n and 0 elsewhere.  S restricted to indices 1..n-1 is the
    (unscaled) DST-I; rows/cols 0 vanish naturally (sin 0), so applying S
    to a field whose walls and padding are zero both transforms the
    interior and keeps the zero ring — no slicing in or out.

    The argument is reduced by sin's period BEFORE it grows (see
    _sine_entries), so the fp32 argument stays <= 2 pi and entries are
    accurate to ~3e-7 instead of the ~3e-4 an unreduced fp32 pi*r*c/n
    product carries at n=1024.  Kept as traced iota ops, not an
    embedded constant: a 1025^2 fp32 literal adds ~4 MB to the program
    body."""
    ri = jnp.arange(size, dtype=jnp.int32)[:, None]
    ci = jnp.arange(size, dtype=jnp.int32)[None, :]
    s = _sine_entries(ri, ci, n, dtype)
    return jnp.where((ri < n) & (ci < n), s, jnp.zeros((), dtype))


def _sine_entries(ri, ci, n: int, dtype):
    """sin(pi * (ri*ci mod 2n) / n) with the product period-reduced in
    int32 BEFORE the fp cast — the shared fp32-accuracy-critical recipe
    behind every dense DST matrix here (commit f4dd5e5 had to patch two
    divergent copies; keep ONE).

    Exactness bound: ri*ci is computed in int32 before the mod, so the
    guard is (max index)^2 < 2^31 — i.e. dense sizes up to ~46k per
    side — NOT n*size (the product wraps before the reduction can
    help).  Far beyond any viable dense transform either way."""
    m = (ri * ci) % (2 * n)
    return jnp.sin(jnp.pi * m.astype(dtype) / n)


def solve_fst_matmul_padded(f, nx: int, ny: int, dx: float, dy: float,
                            mm_precision: str = "highest"):
    """Dirichlet Poisson solve as four dense matmuls (MXU path).

    f: (P, Q) padded field whose logical content lives at [0..nx, 0..ny];
    only interior values (1..nx-1, 1..ny-1) are read.  Returns the padded
    solution, exactly zero on the walls and padding.  Same eigenvalues and
    normalization as the DST-I solve (fft_d.jl:7-23): with S the unscaled
    sine matrix, u = S((S g S)/den)S * 4/(nx ny), since S^2 = (n/2) I on
    the interior and FFTW's RODFT00 pair scales by 2nx * 2ny.

    This is the multi-chip formulation of choice: every op is a dense
    matmul or elementwise — GSPMD partitions them natively (no pencil
    reshardings, no odd-extension concats, no uneven-by-one slices that
    trigger involuntary rematerialization)."""
    P, Q = f.shape[-2], f.shape[-1]
    dtype = f.dtype
    sx = sine_matrix(nx, P, dtype)
    sy = sine_matrix(ny, Q, dtype)
    k = jnp.arange(P, dtype=dtype)[:, None]
    l_ = jnp.arange(Q, dtype=dtype)[None, :]
    valid = ((k >= 1) & (k <= nx - 1)) & ((l_ >= 1) & (l_ <= ny - 1))
    den = (2.0 / dx**2) * (jnp.cos(jnp.pi * k / nx) - 1.0) + (
        2.0 / dy**2
    ) * (jnp.cos(jnp.pi * l_ / ny) - 1.0)
    den = jnp.where(valid, den, jnp.ones((), dtype))
    g = jnp.where(valid, f, jnp.zeros((), dtype))
    # mm_precision: a core.precision tier (highest | high | default)
    mm = lambda a, b: precision.matmul(a, b, mm_precision)
    coeff = mm(mm(sx, g), sy) / den
    return mm(mm(sx, coeff), sy) * (4.0 / (nx * ny))


def solve_fst_matmul_interior(f, nx: int, ny: int, dx: float, dy: float,
                              mm_precision: str = "highest"):
    """Single-device form of solve_fst_matmul_padded with MXU-tile-
    aligned operands.  The (nx+1, ny+1) walls carry no information, so
    slice the (nx-1, ny-1) interior, apply exact interior-sized sine
    matrices, and pad the zero ring back.  At the north-star 1024^2
    this replaces 1025-wide dot operands with 1023-wide ones (one short
    of a power of two instead of one past it).  Same eigenvalues and
    normalization as solve_fst_matmul_padded; the sharded padded step
    keeps the zero-extended form (its masking does the wall handling).
    """
    dtype = f.dtype
    g = f[1:nx, 1:ny]

    def sine_interior(n):
        k = jnp.arange(1, n, dtype=jnp.int32)
        return _sine_entries(k[:, None], k[None, :], n, dtype)

    sx = sine_interior(nx)
    sy = sine_interior(ny)
    kx = jnp.arange(1, nx, dtype=dtype)
    ky = jnp.arange(1, ny, dtype=dtype)
    den = (2.0 / dx**2) * (jnp.cos(jnp.pi * kx[:, None] / nx) - 1.0) + (
        2.0 / dy**2
    ) * (jnp.cos(jnp.pi * ky[None, :] / ny) - 1.0)
    mm = lambda a, b: precision.matmul(a, b, mm_precision)
    coeff = mm(mm(sx, g), sy) / den
    u = mm(mm(sx, coeff), sy) * (4.0 / (nx * ny))
    return jnp.pad(u, 1)


def solve_fst_matmul_refined(f, nx: int, ny: int, dx: float, dy: float):
    """NEGATIVE RESULT (kept as documentation + CPU-verified plumbing;
    not user-selectable): one iterative-refinement pass around the
    single-pass-bf16 DST solve — u1 = solve_1pass(f); r = f - lap(u1);
    u = u1 + solve_1pass(r).

    The hoped-for eps^2 error does NOT materialize on chip: measured
    PHYSICS REJECT at 1024^2 (psi_l2 17% LOW, round-5 battery).  Why:
    classic iterative refinement needs eps * kappa(A) < 1.  The bf16
    transform error acts as a ~eps backward error ON THE RESIDUAL'S
    TRANSFORM, and r = -L(delta1) is dominated by delta1's broadband
    rounding content amplified by ||L|| ~ 4/h^2; the correction solve's
    own transform error then lands on the SMALL eigenvalues (divided by
    den_min ~ 2 pi^2), so the error of e relative to u is
    ~ eps * kappa(L) * ||delta1|| with kappa(L) ~ 4e5 at 1024^2 —
    larger than the delta1 it removes.  The only working lever is
    reducing eps at the transform level, which is exactly the bf16x3
    tier (precision='high').  Reference semantics:
    14_Poisson_Solver_FST/fft_d.jl:7-23."""
    from cfd_julia_tpu.ops import arakawa

    u1 = solve_fst_matmul_interior(f, nx, ny, dx, dy,
                                   mm_precision="default")
    # interior residual; the laplacian's boundary rows are garbage but
    # the correction solve reads [1:nx, 1:ny] only
    r = f - arakawa.laplacian(u1, dx, dy)
    e = solve_fst_matmul_interior(r, nx, ny, dx, dy,
                                  mm_precision="default")
    return u1 + e
