"""Iterative Poisson solvers: Jacobi, red-black Gauss-Seidel, conjugate
gradient — all as single `lax.while_loop` programs with on-device residual
histories (zero host round-trips until the solve finishes).

Reference parity notes:
* ch. 15's `gauss_seidel` (gauss_seidel.jl:8-54) is **point Jacobi** despite
  its name (the residual of the whole field is computed before any update);
  `jacobi` here is the exact equivalent.
* The reference's true Gauss-Seidel (`gauss_seidel_mg`, Common.jl:78-92) is
  lexicographic and order-dependent — inherently serial. `redblack_gs` is
  the data-parallel replacement: two data-parallel half-sweeps with the same
  asymptotic smoothing behaviour.
* `cg` follows conjugate_gradient.jl:7-79 update-for-update.
* Residual histories: the reference streams "(it, rms, rms/rms0)" lines to
  text files every `freq` iterations (gauss_seidel.jl:41-47,
  conjugate_gradient.jl:64-71). Here a preallocated on-device buffer is
  filled at the same cadence and returned.

Formulation: every sweep is roll-shift + mask elementwise math on the
FULL (nx+1, ny+1) array — no scatters (a masked `.at[1:-1,1:-1].add`
scatter was several times slower than the roll form). Boundary garbage from the
periodic rolls is killed by the interior mask, so Dirichlet boundary
values are preserved exactly.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class IterativeResult:
    u: jax.Array
    iterations: jax.Array       # scalar int
    rms: jax.Array              # final residual L2 norm
    rms0: jax.Array             # initial residual L2 norm
    history: jax.Array          # (max_records, 3): it, rms, rms/rms0 (NaN pad)
    n_records: jax.Array


def _lap_roll(u, dx, dy):
    """5-point Laplacian via rolls (edge rows invalid -> mask them).
    Delegates to ops.arakawa.laplacian: ONE stencil implementation for
    Poisson residuals and the NS diffusion term (the shift-direction
    difference is irrelevant — the stencil is symmetric and IEEE
    addition is commutative, so results are bit-identical)."""
    from cfd_julia_tpu.ops import arakawa

    return arakawa.laplacian(u, dx, dy)


def interior_mask(nx: int, ny: int, dtype):
    i = jnp.arange(nx + 1)
    j = jnp.arange(ny + 1)
    m = ((i > 0) & (i < nx))[:, None] & ((j > 0) & (j < ny))[None, :]
    return m.astype(dtype)


def color_masks(nx: int, ny: int, dtype):
    """(red, black) interior checkerboard masks, full (nx+1, ny+1) size."""
    i = jnp.arange(nx + 1)
    j = jnp.arange(ny + 1)
    par = (i[:, None] + j[None, :]) % 2
    inter = interior_mask(nx, ny, dtype)
    return inter * (par == 0), inter * (par == 1)


def residual_full(f, u, dx, dy, mask):
    """r = (f - lap u) on the interior, 0 on the boundary ring."""
    return (f - _lap_roll(u, dx, dy)) * mask


def _rms_from_full(r_full, nx, ny):
    """Matches compute_l2norm over interior nodes (Common.jl:229-232)."""
    return jnp.sqrt(jnp.sum(r_full**2) / ((nx - 1) * (ny - 1)))


def jacobi_sweep(u, f, dx: float, dy: float, mask):
    """One point-Jacobi update (gauss_seidel.jl:33-39)."""
    r = residual_full(f, u, dx, dy, mask)
    return u + r / (-2.0 / dx**2 - 2.0 / dy**2)


def chebyshev_smooth(u, f, dx: float, dy: float, iters: int, imask,
                     lmax: float = 2.0, lmin_frac: float = 0.25):
    """Degree-`iters` Chebyshev-accelerated Jacobi smoother.

    Damps the upper eigenvalue band [lmin_frac*lmax, lmax] of the
    Jacobi-preconditioned 5-pt Laplacian (spectrum in (0, 2); classic
    MG smoothing choice — Saad, Iterative Methods, alg. 12.1, with the
    textbook 1/4 band split used by hypre/AMG practice).

    Rationale vs red-black GS: each degree is ONE unmasked 5-pt
    residual + elementwise axpys — no checkerboard masks and half the
    stencil passes of an RB sweep (which needs two masked half-updates
    so black sees fresh red), and the whole update is pure dataflow
    that GSPMD shards without mask constants.  Smoothing quality per
    stencil pass is comparable (raced on the card by chip_smoke.py's
    multigrid phase and bench MG_VARIANTS)."""
    if iters <= 0:
        return u
    diag = -2.0 / dx**2 - 2.0 / dy**2
    b = lmax
    a = lmax * lmin_frac
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma1 = theta / delta

    r = residual_full(f, u, dx, dy, imask)
    d = (r / diag) / theta
    u = u + d
    rho = jnp.asarray(1.0 / sigma1, u.dtype)

    def body(_, c):
        uu, dd, rr = c
        z = residual_full(f, uu, dx, dy, imask) / diag
        rho_n = 1.0 / (2.0 * sigma1 - rr)
        dd = rho_n * rr * dd + (2.0 * rho_n / delta) * z
        return uu + dd, dd, rho_n.astype(uu.dtype)

    u, _, _ = lax.fori_loop(0, iters - 1, body, (u, d, rho))
    return u


def redblack_sweep(u, f, dx: float, dy: float, mask_red, mask_black):
    """One red-black Gauss-Seidel sweep: two masked half-updates; the black
    half sees the freshly updated red values (data-parallel true GS)."""
    diag = -2.0 / dx**2 - 2.0 / dy**2
    u = u + residual_full(f, u, dx, dy, mask_red) / diag
    return u + residual_full(f, u, dx, dy, mask_black) / diag


@partial(jax.jit, static_argnames=("method", "max_iter", "freq", "dx", "dy"))
def relax_solve(
    f,
    u0,
    dx: float,
    dy: float,
    tol: float = 1e-9,
    max_iter: int = 100_000,
    freq: int = 100,
    method: str = "jacobi",
) -> IterativeResult:
    """Relaxation solve (Jacobi or red-black GS) until rms/rms0 <= tol.

    Runs `freq` sweeps per convergence check, exactly the reference cadence
    (gauss_seidel.jl:41-47 with freq=10_000)."""
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    mask = interior_mask(nx, ny, f.dtype)
    if method == "jacobi":
        sweep = lambda u: jacobi_sweep(u, f, dx, dy, mask)
    elif method == "redblack":
        mr, mb = color_masks(nx, ny, f.dtype)
        sweep = lambda u: redblack_sweep(u, f, dx, dy, mr, mb)
    else:
        raise ValueError(f"unknown relaxation {method!r}")

    max_records = max(1, max_iter // freq) + 1
    rms0 = _rms_from_full(residual_full(f, u0, dx, dy, mask), nx, ny)
    hist0 = jnp.full((max_records, 3), jnp.nan, f.dtype)

    def cond(c):
        u, it, rms, hist, nrec = c
        return (it < max_iter) & (rms / rms0 > tol)

    def body(c):
        u, it, rms, hist, nrec = c
        u = lax.fori_loop(0, freq, lambda _, uu: sweep(uu), u)
        it = it + freq
        rms = _rms_from_full(residual_full(f, u, dx, dy, mask), nx, ny)
        rec = jnp.stack([it.astype(f.dtype), rms, rms / rms0])
        hist = lax.dynamic_update_slice(hist, rec[None], (nrec, 0))
        return (u, it, rms, hist, nrec + 1)

    u, it, rms, hist, nrec = lax.while_loop(
        cond, body, (u0, jnp.array(0), rms0, hist0, jnp.array(0))
    )
    return IterativeResult(u=u, iterations=it, rms=rms, rms0=rms0,
                           history=hist, n_records=nrec)


@partial(jax.jit, static_argnames=("max_iter", "freq", "dx", "dy"))
def cg_solve(
    f,
    u0,
    dx: float,
    dy: float,
    tol: float = 1e-9,
    max_iter: int = 100_000,
    freq: int = 100,
) -> IterativeResult:
    """Matrix-free conjugate gradient (conjugate_gradient.jl:7-79): the
    5-point Laplacian is applied as a stencil, convergence on rms/rms0,
    history recorded every `freq` iterations."""
    eps = 1e-16
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    mask = interior_mask(nx, ny, f.dtype)
    r0 = residual_full(f, u0, dx, dy, mask)
    rms0 = _rms_from_full(r0, nx, ny)
    max_records = max(1, max_iter // freq) + 1
    hist0 = jnp.full((max_records, 3), jnp.nan, f.dtype)

    def cond(c):
        u, r, p, it, rms, hist, nrec = c
        return (it < max_iter) & (rms / rms0 > tol)

    def body(c):
        u, r, p, it, rms, hist, nrec = c
        it = it + 1
        ap = _lap_roll(p, dx, dy) * mask
        rr = jnp.sum(r**2)
        alpha = rr / (jnp.sum(ap * p) + eps)
        u = u + alpha * p          # p is 0 on the boundary ring
        r = r - alpha * ap
        rr_new = jnp.sum(r**2)
        beta = rr_new / (rr + eps)
        p = r + beta * p
        rms = jnp.sqrt(rr_new / ((nx - 1) * (ny - 1)))
        rec = jnp.stack([it.astype(f.dtype), rms, rms / rms0])
        do_rec = (it % freq) == 0
        hist = lax.cond(
            do_rec,
            lambda h: lax.dynamic_update_slice(h, rec[None], (nrec, 0)),
            lambda h: h,
            hist,
        )
        nrec = nrec + do_rec.astype(nrec.dtype)
        return (u, r, p, it, rms, hist, nrec)

    init = (u0, r0, r0, jnp.array(0), rms0, hist0, jnp.array(0))
    u, r, p, it, rms, hist, nrec = lax.while_loop(cond, body, init)
    return IterativeResult(u=u, iterations=it, rms=rms, rms0=rms0,
                           history=hist, n_records=nrec)


@partial(jax.jit, static_argnames=("max_iter", "dx", "dy", "mg_cfg"))
def mgcg_solve(
    f,
    u0,
    dx: float,
    dy: float,
    tol: float = 1e-9,
    max_iter: int = 200,
    mg_cfg=None,
) -> IterativeResult:
    """Multigrid-preconditioned flexible CG — a solver the reference does
    not have: one V-cycle (from zero) as the preconditioner M^-1 inside
    CG, with the Polak-Ribiere beta = <z, r - r_prev> / <z_prev, r_prev>
    (flexible CG: the red-black V-cycle is a fixed linear but
    non-symmetric operator, so standard PCG's beta can stall).
    Converges in O(10) iterations independent of grid size where plain
    CG needs O(n).  History is recorded EVERY iteration."""
    from cfd_julia_tpu.poisson import multigrid

    mg_cfg = mg_cfg or multigrid.MGConfig()
    eps = 1e-300 if f.dtype == jnp.float64 else 1e-30
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    mask = interior_mask(nx, ny, f.dtype)
    levels = multigrid._build_levels(nx, ny, dx, dy, mg_cfg.n_levels)
    masks = [color_masks(l[0], l[1], f.dtype) for l in levels]
    imasks = [interior_mask(l[0], l[1], f.dtype) for l in levels]

    def precond(r):
        return multigrid.v_cycle(jnp.zeros_like(r), r, levels, masks,
                                 imasks, mg_cfg) * mask

    r0 = residual_full(f, u0, dx, dy, mask)
    rms0 = _rms_from_full(r0, nx, ny)
    z0 = precond(r0)
    hist0 = jnp.full((max_iter + 1, 3), jnp.nan, f.dtype)

    def cond(c):
        u, r, z, p, it, rms, hist, nrec = c
        return (it < max_iter) & (rms / rms0 > tol)

    def body(c):
        u, r, z, p, it, rms, hist, nrec = c
        it = it + 1
        ap = _lap_roll(p, dx, dy) * mask
        rz = jnp.sum(r * z)
        alpha = rz / (jnp.sum(ap * p) + eps)
        u = u + alpha * p
        r_new = r - alpha * ap
        z_new = precond(r_new)
        # Polak-Ribiere (flexible) beta
        beta = jnp.sum(z_new * (r_new - r)) / (rz + eps)
        p = z_new + beta * p
        rms = _rms_from_full(r_new, nx, ny)
        rec = jnp.stack([it.astype(f.dtype), rms, rms / rms0])
        hist = lax.dynamic_update_slice(hist, rec[None], (nrec, 0))
        return (u, r_new, z_new, p, it, rms, hist, nrec + 1)

    init = (u0, r0, z0, z0, jnp.array(0), rms0, hist0, jnp.array(0))
    u, r, z, p, it, rms, hist, nrec = lax.while_loop(cond, body, init)
    return IterativeResult(u=u, iterations=it, rms=rms, rms0=rms0,
                           history=hist, n_records=nrec)
