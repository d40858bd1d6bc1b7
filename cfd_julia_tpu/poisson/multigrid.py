"""Geometric multigrid V-cycle for the 2D Poisson equation.

Reference: 17_Poisson_Solver_Multigrid/mg.jl (2-level) and mg_N.jl
(N-level, the general case this module implements). Transfer operators are
full-weighting restriction (Common.jl:21-48) and bilinear prolongation
(Common.jl:50-76).

Deviations from the reference:
* The smoother is red-black Gauss-Seidel (two data-parallel half-sweeps)
  instead of the order-dependent lexicographic sweep of `gauss_seidel_mg`
  (Common.jl:78-92) — same O(1) smoothing factor, fully vector-parallel
  (SURVEY §3.3: the one reference algorithm that cannot map directly to
  data-parallel hardware).
* The level pyramid is static (shapes fixed at trace time); the V-cycle is
  Python-unrolled inside a single `lax.while_loop`, convergence checked
  on-device once per cycle — zero host round-trips.
* No scatters anywhere: sweeps are roll+mask elementwise math
  (poisson.iterative) or one kernel launch (ops.rb_kernel), restriction
  assembles by concatenation, and prolongation is a transposed
  convolution.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cfd_julia_tpu.poisson.iterative import (
    IterativeResult,
    _rms_from_full,
    chebyshev_smooth,
    color_masks,
    interior_mask,
    redblack_sweep,
    residual_full,
)


# NumPy on purpose: a module-level jnp.array would initialize the JAX
# backend at import time (before a caller can pick the platform).  These
# convert to device constants at trace time.
_RESTRICT_KERNEL = np.array(
    [[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]
) / 16.0
_PROLONG_KERNEL = np.array(
    [[0.25, 0.5, 0.25], [0.5, 1.0, 0.5], [0.25, 0.5, 0.25]]
)


def restriction(r):
    """Full-weighting fine -> coarse transfer on node-centred grids
    (Common.jl:21-48). r: (nxf+1, nyf+1) -> (nxf//2+1, nyf//2+1).

    Interior = 3x3 full-weighting stencil at even fine nodes, expressed as
    a stride-2 convolution; boundary rows/cols are direct injection of
    the coincident fine nodes."""
    k = _RESTRICT_KERNEL.astype(r.dtype)[None, None]
    # precision pinned: a reduced-precision default (TF32 on a GPU) would
    # cost ~1e-3 rel on 1/dx^2-scaled residuals, while the other transfer
    # forms (matmul, reshape) are fp32-exact
    interior = lax.conv_general_dilated(
        r[None, None], k, window_strides=(2, 2), padding=((1, 1), (1, 1)),
        precision=lax.Precision.HIGHEST,
    )[0, 0, 1:-1, 1:-1]
    mid = jnp.concatenate(
        [r[2:-2:2, :1], interior, r[2:-2:2, -1:]], axis=1
    )
    return jnp.concatenate([r[:1, ::2], mid, r[-1:, ::2]], axis=0)


def prolongation(uc):
    """Bilinear coarse -> fine transfer (Common.jl:50-76): transposed
    stride-2 convolution with the bilinear kernel (lhs dilation); verified
    element-identical to the reference's injection/average formulas."""
    k = _PROLONG_KERNEL.astype(uc.dtype)[None, None]
    return lax.conv_general_dilated(
        uc[None, None], k, window_strides=(1, 1),
        padding=((1, 1), (1, 1)), lhs_dilation=(2, 2),
        precision=lax.Precision.HIGHEST,  # see restriction
    )[0, 0]


# ------------------------------- alternative transfer formulations
#
# Two dataflow-equivalent alternatives to the stride-2 conv pair,
# selectable with MGConfig.transfers (the auto choice is policy.py's):
#  * matmul: R @ r @ R^T with banded transfer matrices — O(n^3) flops,
#    but GSPMD partitions dense matmuls natively (the multi-chip choice).
#  * reshape: even/odd deinterleave via a (nc+1, 2, nc+1, 2) reshape and
#    pure elementwise recombination — O(n^2), one relayout.

def _restrict_matrix(nf: int, dtype):
    """(nc+1, nf+1) separable full-weighting rows: interior row c holds
    [1/4, 1/2, 1/4] at fine 2c-1..2c+1; rows 0/nc inject the coincident
    boundary node (exact for interior-masked residuals, whose boundary
    ring is zero)."""
    nc = nf // 2
    c = jnp.arange(nc + 1)[:, None]
    fine = jnp.arange(nf + 1)[None, :]
    d = fine - 2 * c
    w = jnp.where(d == 0, 0.5, jnp.where(jnp.abs(d) == 1, 0.25, 0.0))
    inject = (fine == 2 * c).astype(dtype)
    boundary = (c == 0) | (c == nc)
    return jnp.where(boundary, inject, w.astype(dtype))


def _prolong_matrix(nc: int, dtype):
    """(nf+1, nc+1) bilinear columns: fine even row 2c copies coarse c,
    fine odd row 2c+1 averages coarse c and c+1 — identical to the
    lhs-dilated conv."""
    nf = 2 * nc
    fine = jnp.arange(nf + 1)[:, None]
    c = jnp.arange(nc + 1)[None, :]
    even = (fine == 2 * c).astype(dtype)
    odd = ((fine == 2 * c + 1) | (fine == 2 * c - 1)).astype(dtype) * 0.5
    return jnp.where(fine % 2 == 0, even, odd)


def restriction_matmul(r):
    nf = r.shape[0] - 1
    mx = _restrict_matrix(nf, r.dtype)
    my = _restrict_matrix(r.shape[1] - 1, r.dtype)
    mm = lambda a, b: jnp.matmul(a, b, precision="highest")
    return mm(mm(mx, r), my.T)


def prolongation_matmul(uc):
    px = _prolong_matrix(uc.shape[0] - 1, uc.dtype)
    py = _prolong_matrix(uc.shape[1] - 1, uc.dtype)
    mm = lambda a, b: jnp.matmul(a, b, precision="highest")
    return mm(mm(px, uc), py.T)


def _shift(a, di: int, dj: int):
    """Zero-fill shift: out[i, j] = a[i+di, j+dj] (in-range) else 0."""
    pads = ((max(-di, 0), max(di, 0)), (max(-dj, 0), max(dj, 0)))
    return lax.slice(
        jnp.pad(a, pads),
        (pads[0][1], pads[1][1]),
        (a.shape[0] + pads[0][1], a.shape[1] + pads[1][1]),
    )


def restriction_reshape(r):
    """Full weighting via even/odd deinterleave: one reshape relayout,
    then elementwise combines on quarter-size grids.  Exact for
    interior-masked residuals (zero boundary ring), like the conv form."""
    nf = r.shape[0] - 1
    nc, mc = nf // 2, (r.shape[1] - 1) // 2
    rp = jnp.pad(r, ((0, 1), (0, 1)))
    q = rp.reshape(nc + 1, 2, mc + 1, 2)
    ee = q[:, 0, :, 0]        # r[2c,   2d]
    eo = q[:, 0, :, 1]        # r[2c,   2d+1]
    oe = q[:, 1, :, 0]        # r[2c+1, 2d]
    oo = q[:, 1, :, 1]        # r[2c+1, 2d+1]
    out = (4.0 * ee
           + 2.0 * (oe + _shift(oe, -1, 0) + eo + _shift(eo, 0, -1))
           + oo + _shift(oo, -1, 0) + _shift(oo, 0, -1)
           + _shift(oo, -1, -1)) / 16.0
    c = jnp.arange(nc + 1)[:, None]
    d = jnp.arange(mc + 1)[None, :]
    boundary = (c == 0) | (c == nc) | (d == 0) | (d == mc)
    return jnp.where(boundary, ee, out)


def smooth(u, f, dx: float, dy: float, iters: int, masks,
           impl: str = "xla"):
    """`iters` smoothing sweeps (replaces gauss_seidel_mg).

    impl="xla": red-black GS as two masked roll+mask half-sweeps
    (iterative.redblack_sweep).  impl="triton": the same sweep as one
    kernel launch (ops.rb_kernel; GPU only).  impl="cheb": the
    Chebyshev-Jacobi smoother (iterative.chebyshev_smooth), one unmasked
    stencil pass per degree."""
    if impl == "triton":
        from cfd_julia_tpu.ops import rb_kernel

        return rb_kernel.redblack_sweeps(u, f, dx, dy, iters)
    mr, mb = masks
    if impl == "cheb":
        return chebyshev_smooth(u, f, dx, dy, iters, mr + mb)
    if impl != "xla":
        raise ValueError(f"unknown smoother impl {impl!r} "
                         "(xla | triton | cheb)")
    return lax.fori_loop(
        0, iters, lambda _, uu: redblack_sweep(uu, f, dx, dy, mr, mb), u
    )


def _pick_smoother(nx: int, ny: int, name: str = "auto",
                   platform: str | None = None, dtype=jnp.float32) -> str:
    """Smoother of one (nx, ny) level of `dtype`.  "auto" takes policy.py's
    mg_smoother; a kernel smoother ("triton") runs only on levels of at
    least mg_kernel_min cells per side, smaller ones keep the XLA sweep
    (launch overhead dominates there).  Under "auto" the kernel also
    takes fp32 levels only: fp32 is the arithmetic it was timed and
    checked in on the card."""
    from cfd_julia_tpu import policy

    if name == "cheb":
        return "cheb"
    impl = policy.choice("mg_smoother", platform) if name == "auto" \
        else name
    if impl == "triton" and (
            min(nx, ny) < policy.choice("mg_kernel_min", platform)
            or (name == "auto" and jnp.dtype(dtype) != jnp.float32)):
        return "xla"
    return impl


@dataclasses.dataclass(frozen=True)
class MGConfig:
    n_levels: int = 0          # 0 -> auto (coarsen to 2x2 cells)
    v1: int = 2                # pre-smoothing sweeps (mg_N.jl v1)
    v2: int = 2                # coarsest-level sweeps (v2)
    v3: int = 2                # post-smoothing sweeps (v3)
    tol: float = 1e-9
    max_cycles: int = 100
    transfers: str = "auto"    # auto (policy.py) | conv | matmul | reshape
    smoother: str = "auto"     # auto (policy.py) | xla (red-black GS,
                               # roll+mask half-sweeps) | triton (the same
                               # sweep as one GPU kernel launch on large
                               # levels, ops.rb_kernel) | cheb (Chebyshev-
                               # Jacobi: one unmasked stencil pass per
                               # degree)
    fmg: bool = False          # full-multigrid (nested-iteration) start:
                               # solve the homogenized problem coarsest-
                               # first, one V-cycle per level on the way
                               # up — the first fine V-cycle then starts
                               # at ~discretization accuracy (beyond the
                               # reference, which always starts from 0)
    cycle_dtype: str = "fp32"  # fp32 | bf16: bf16 runs every V-cycle in
                               # bfloat16 inside an fp32 iterative-
                               # refinement outer loop (A e = r solved in
                               # bf16 from e=0, u += e; residual, rms
                               # check and the returned u stay fp32).
                               # GRID-SIZE LIMIT (PERF.md): bf16 storage
                               # rounding of the fine-level correction is
                               # high-frequency noise that the operator
                               # amplifies ~1/h^2, so convergence degrades
                               # with grid size — 128^2..1024^2 reach 1e-5
                               # rel in +0..3 cycles vs fp32 (tested), but
                               # the cycle stalls at 4096^2.  Opt-in only.
                               # mixed: finest level in the input dtype,
                               # coarser levels bf16.


_TRANSFERS = {
    "conv": (restriction, prolongation),
    "matmul": (restriction_matmul, prolongation_matmul),
    "reshape": (restriction_reshape, prolongation),
}


def _transfers_choice(name: str, platform: str | None = None) -> str:
    if name != "auto":
        return name
    from cfd_julia_tpu import policy

    return policy.choice("mg_transfers", platform)


def _pick_transfers(name: str, platform: str | None = None):
    return _TRANSFERS[_transfers_choice(name, platform)]


def _build_levels(nx, ny, dx, dy, n_levels):
    # BOTH axes must stay even at every coarsening: an anisotropic
    # grid whose axes have different 2-adic valuations (e.g. 20x16)
    # would otherwise produce an odd intermediate level and crash
    # the prolongation on a shape mismatch
    max_levels = 1
    mx, my = nx, ny
    while mx % 2 == 0 and my % 2 == 0 and mx > 2 and my > 2:
        mx //= 2
        my //= 2
        max_levels += 1
    # <=0 -> auto (coarsen to 2x2 cells); an explicit request deeper
    # than the grid allows is clamped, not rejected — a preset's pinned
    # depth (e.g. poisson_mgN's 9 for 512^2) must compose with
    # `run --nx`/`--sweep` overrides on smaller grids
    n_levels = max_levels if n_levels <= 0 else min(n_levels, max_levels)
    return [(nx >> l, ny >> l, dx * (1 << l), dy * (1 << l))
            for l in range(n_levels)]


def v_cycle(u, f, levels, masks, imasks, cfg: MGConfig, impls=None):
    """One V-cycle over the static level pyramid (mg_N.jl:53-106)."""
    n = len(levels)
    impls = impls or [_pick_smoother(l[0], l[1], cfg.smoother,
                                     dtype=m[0].dtype)
                      for l, m in zip(levels, masks)]
    restrict_fn, prolong_fn = _pick_transfers(cfg.transfers)
    # cycle_dtype="mixed": finest level stays in the input dtype (fp32),
    # every coarser level runs bf16 — the fine-level correction (whose
    # bf16 storage rounding stalls the full-bf16 pyramid at 4096^2,
    # PERF.md) never leaves fp32, while the pyramid below halves its
    # memory traffic.  The casts live on the level-0/1 edges.
    mixed = cfg.cycle_dtype == "mixed"

    # descend: pre-smooth -> residual -> restrict -> next level from zero
    fs = [f]
    us = [u]
    for k in range(n - 1):
        nxk, nyk, dxk, dyk = levels[k]
        uk = smooth(us[k], fs[k], dxk, dyk, cfg.v1, masks[k], impls[k])
        r = residual_full(fs[k], uk, dxk, dyk, imasks[k])
        fk = restrict_fn(r)
        us[k] = uk
        if mixed and k == 0:
            fk = fk.astype(jnp.bfloat16)
        fs.append(fk)
        nxn, nyn, _, _ = levels[k + 1]
        us.append(jnp.zeros((nxn + 1, nyn + 1), fk.dtype))
    nxc, nyc, dxc, dyc = levels[n - 1]
    us[n - 1] = smooth(us[n - 1], fs[n - 1], dxc, dyc,
                       cfg.v2 if n > 1 else cfg.v1,
                       masks[n - 1], impls[n - 1])

    # ascend: prolongate -> correct -> relax
    for k in range(n - 1, 0, -1):
        nxp, nyp, dxp, dyp = levels[k - 1]
        uc = us[k].astype(us[k - 1].dtype)    # mixed: bf16 -> fp32 edge
        corr = prolong_fn(uc) * imasks[k - 1]
        us[k - 1] = us[k - 1] + corr
        us[k - 1] = smooth(us[k - 1], fs[k - 1], dxp, dyp, cfg.v3,
                           masks[k - 1], impls[k - 1])
    return us[0]


def fmg_start(f, u0, levels, masks, imasks, cfg: MGConfig):
    """Nested-iteration start: homogenize (v = u - u0 has zero boundary,
    A v = f - A u0 =: g), restrict g down the pyramid, then from the
    coarsest level up: prolong the current solution and run one V-cycle
    of the sub-pyramid.  Returns u0 + v at ~discretization accuracy for
    one-V-cycle-per-level cost."""
    n = len(levels)
    nx0, ny0, dx0, dy0 = levels[0]
    g = residual_full(f, u0, dx0, dy0, imasks[0])
    restrict_fn, prolong_fn = _pick_transfers(cfg.transfers)
    gs = [g]
    for k in range(1, n):
        gs.append(restrict_fn(gs[k - 1] * imasks[k - 1]))

    nxc, nyc, dxc, dyc = levels[n - 1]
    v = jnp.zeros((nxc + 1, nyc + 1), f.dtype)
    v = smooth(v, gs[n - 1], dxc, dyc, cfg.v2, masks[n - 1],
               _pick_smoother(nxc, nyc, cfg.smoother, dtype=v.dtype))
    for k in range(n - 2, -1, -1):
        # the cfg-selected pair, not hardcoded conv: matmul prolongation
        # measured 2.3x faster at 4096^2 — FMG's upleg must honor it
        v = prolong_fn(v) * imasks[k]
        v = v_cycle(v, gs[k], levels[k:], masks[k:], imasks[k:], cfg)
    return u0 + v


@partial(jax.jit, static_argnames=("dx", "dy", "cfg", "mesh"))
def solve(f, u0, dx: float, dy: float, cfg: MGConfig = MGConfig(),
          mesh=None) -> IterativeResult:
    """V-cycle iteration until rms/rms0 <= tol (mg_N.jl:53-106), residual
    history recorded once per cycle on-device.  cfg.fmg starts from a
    full-multigrid (nested iteration) initial guess instead of u0.

    With `mesh` (a jax.sharding.Mesh) the solve runs as one GSPMD
    program over the device mesh — see the multi-chip section below
    (_mesh_solve): padded domain decomposition on fine levels, coarse
    levels agglomerated to replicated, Chebyshev smoother + matmul
    transfers."""
    if cfg.cycle_dtype not in ("fp32", "bf16", "mixed"):
        raise ValueError(f"unknown cycle_dtype {cfg.cycle_dtype!r} "
                         "(fp32 | bf16 | mixed)")
    if mesh is not None:
        return _mesh_solve(f, u0, dx, dy, cfg, mesh)
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    levels = _build_levels(nx, ny, dx, dy, cfg.n_levels)
    # mixed pyramid: coarse-level masks in bf16 so the dtype flow stays
    # bf16 through the coarse smoothers (an fp32 mask would upcast)
    ldt = [f.dtype] + [jnp.bfloat16 if cfg.cycle_dtype == "mixed"
                       else f.dtype] * (len(levels) - 1)
    masks = [color_masks(l[0], l[1], d) for l, d in zip(levels, ldt)]
    imasks = [interior_mask(l[0], l[1], d) for l, d in zip(levels, ldt)]

    mask0 = imasks[0]
    rms0 = _rms_from_full(residual_full(f, u0, dx, dy, mask0), nx, ny)
    if cfg.fmg:
        u0 = fmg_start(f, u0, levels, masks, imasks, cfg)
    hist0 = jnp.full((cfg.max_cycles + 1, 3), jnp.nan, f.dtype)

    ir = cfg.cycle_dtype == "bf16"
    if ir:
        # iterative refinement: each cycle solves the correction
        # equation A e = r from e = 0 with the whole pyramid in bf16;
        # u, the residual, and the rms check stay fp32.  The loop
        # carries r in bf16 — it is exactly the next cycle's RHS, and
        # the fp32 residual values only ever feed the (scale-free) rms
        # reduction and this cast, so XLA fuses the residual + rms +
        # cast into one pass with a half-size store
        cdt = jnp.bfloat16
        cmasks = [color_masks(l[0], l[1], cdt) for l in levels]
        cimasks = [interior_mask(l[0], l[1], cdt) for l in levels]
        # with fmg this is the post-start residual (the first cycle's RHS)
        rb0 = residual_full(f, u0, dx, dy, mask0).astype(cdt)

        def cond(c):
            u, it, rms, rb, hist, nrec = c
            return (it < cfg.max_cycles) & (rms / rms0 > cfg.tol)

        def body(c):
            u, it, rms, rb, hist, nrec = c
            e = v_cycle(jnp.zeros(rb.shape, cdt), rb,
                        levels, cmasks, cimasks, cfg)
            u = u + e.astype(u.dtype)
            it = it + 1
            r = residual_full(f, u, dx, dy, mask0)
            rms = _rms_from_full(r, nx, ny)
            rec = jnp.stack([it.astype(f.dtype), rms, rms / rms0])
            hist = lax.dynamic_update_slice(hist, rec[None], (nrec, 0))
            return (u, it, rms, r.astype(cdt), hist, nrec + 1)

        u, it, rms, _, hist, nrec = lax.while_loop(
            cond, body, (u0, jnp.array(0), rms0, rb0, hist0, jnp.array(0))
        )
        return IterativeResult(u=u, iterations=it, rms=rms, rms0=rms0,
                               history=hist, n_records=nrec)

    def cond(c):
        u, it, rms, hist, nrec = c
        return (it < cfg.max_cycles) & (rms / rms0 > cfg.tol)

    def body(c):
        u, it, rms, hist, nrec = c
        u = v_cycle(u, f, levels, masks, imasks, cfg)
        rms = _rms_from_full(residual_full(f, u, dx, dy, mask0), nx, ny)
        it = it + 1
        rec = jnp.stack([it.astype(f.dtype), rms, rms / rms0])
        hist = lax.dynamic_update_slice(hist, rec[None], (nrec, 0))
        return (u, it, rms, hist, nrec + 1)

    u, it, rms, hist, nrec = lax.while_loop(
        cond, body, (u0, jnp.array(0), rms0, hist0, jnp.array(0))
    )
    return IterativeResult(u=u, iterations=it, rms=rms, rms0=rms0,
                           history=hist, n_records=nrec)


# --------------------------------------------------- multi-chip V-cycle
#
# Distributed multigrid (mg_N.jl:53-106 re-designed for a device mesh).
# Two constraints shape the design:
#  * the (n+1)-node grids are RAGGED over any mesh axis, and
#    with_sharding_constraint silently REPLICATES shardings whose dims
#    don't divide (measured on jax 0.9: a (65,65) P('x','y') constraint
#    comes back P()) — so every level is zero-PADDED to mesh-divisible
#    extents, the same strategy as models.cavity.make_padded_step_fn;
#  * masks already make the padded algebra exact: stencil rolls never
#    reach the interior from the padding, smoother updates are
#    interior-masked, and the transfer matrices are zero-extended
#    (sine_matrix-style), so padded entries stay exactly zero through
#    the whole cycle.
#
# Per level: shard while every device keeps >= _AGGLOM_TILE rows/lanes,
# below that REPLICATE (classic coarse-level agglomeration — the coarse
# problems are tiny; one all_gather per descend past the switch level,
# re-sharding on the ascend is a local slice).  The smoother is the
# Chebyshev-Jacobi one (pure unmasked dataflow — partitions into
# stencil + halo exchanges with no checkerboard mask constants), and
# transfers are the separable matmul pair (GSPMD partitions dense
# matmuls natively).  The whole solve — while_loop, convergence check,
# history — is ONE GSPMD program; no host round-trips, no manual
# collectives.

import collections

from jax.sharding import NamedSharding, PartitionSpec

_AGGLOM_TILE = 8   # min per-device rows/cols before a level replicates
                   # (below it the shard is mostly halo/padding)

_MeshLevel = collections.namedtuple(
    "_MeshLevel", ("nx", "ny", "dx", "dy", "P", "Q", "spec"))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mesh_grid(mesh):
    names = tuple(mesh.axis_names)
    shape = tuple(mesh.devices.shape)
    px = shape[0]
    py = shape[1] if len(shape) > 1 else 1
    yn = names[1] if len(names) > 1 else None
    return px, py, names[0], yn


def _mesh_levels(nx, ny, dx, dy, n_levels, mesh):
    """Padded level pyramid: logical (nxl+1, nyl+1) nodes inside padded
    (P, Q) extents; sharded axes pad to multiples of 8*pdev so every
    shard is whole sublanes, replicated axes keep the logical extent."""
    px, py, xn, yn = _mesh_grid(mesh)
    out = []
    for nxl, nyl, dxl, dyl in _build_levels(nx, ny, dx, dy, n_levels):
        sx = xn if px > 1 and (nxl + 1) >= _AGGLOM_TILE * px else None
        sy = yn if yn and py > 1 and (nyl + 1) >= _AGGLOM_TILE * py \
            else None
        P = _round_up(nxl + 1, 8 * px) if sx else nxl + 1
        Q = _round_up(nyl + 1, 8 * py) if sy else nyl + 1
        out.append(_MeshLevel(nxl, nyl, dxl, dyl, P, Q,
                              PartitionSpec(sx, sy)))
    return out


def _padded_imask(nx, ny, P, Q, dtype):
    """Interior mask with LOGICAL bounds inside a padded (P, Q) extent
    (interior_mask with the padding rows/cols forced to zero)."""
    i = jnp.arange(P)
    j = jnp.arange(Q)
    m = ((i > 0) & (i < nx))[:, None] & ((j > 0) & (j < ny))[None, :]
    return m.astype(dtype)


def _restrict_matrix_padded(nf, Pc, Pf, dtype):
    """_restrict_matrix zero-extended to (Pc, Pf) padded extents."""
    nc = nf // 2
    c = jnp.arange(Pc)[:, None]
    fine = jnp.arange(Pf)[None, :]
    d = fine - 2 * c
    w = jnp.where(d == 0, 0.5,
                  jnp.where(jnp.abs(d) == 1, 0.25, 0.0)).astype(dtype)
    inject = (fine == 2 * c).astype(dtype)
    m = jnp.where((c == 0) | (c == nc), inject, w)
    return jnp.where((c <= nc) & (fine <= nf), m, jnp.zeros((), dtype))


def _prolong_matrix_padded(nc, Pf, Pc, dtype):
    """_prolong_matrix zero-extended to (Pf, Pc) padded extents."""
    nf = 2 * nc
    fine = jnp.arange(Pf)[:, None]
    c = jnp.arange(Pc)[None, :]
    even = (fine == 2 * c).astype(dtype)
    odd = ((fine == 2 * c + 1) | (fine == 2 * c - 1)).astype(dtype) * 0.5
    m = jnp.where(fine % 2 == 0, even, odd)
    return jnp.where((fine <= nf) & (c <= nc), m, jnp.zeros((), dtype))


def _mesh_cfg(cfg: MGConfig) -> MGConfig:
    """Resolve an MGConfig for mesh execution; reject single-device-only
    options loudly rather than silently falling back."""
    transfers = "matmul" if cfg.transfers == "auto" else cfg.transfers
    if transfers != "matmul":
        raise ValueError("mesh multigrid uses transfers='matmul' (the "
                         "conv/reshape forms are single-device; dense "
                         f"matmuls partition natively), got {transfers!r}")
    if cfg.smoother not in ("auto", "cheb"):
        raise ValueError("mesh multigrid uses the Chebyshev smoother "
                         f"(smoother='cheb'|'auto'), got {cfg.smoother!r}")
    if cfg.cycle_dtype != "fp32":
        raise ValueError("mesh multigrid supports cycle_dtype='fp32' only "
                         "(the bf16-IR pyramid is single-device)")
    return dataclasses.replace(cfg, transfers=transfers, smoother="cheb")


def _mesh_v_cycle(u, f, plv, imasks, cfg, mesh):
    """One V-cycle over the padded pyramid `plv` (a slice of the full
    pyramid during FMG).  Element-equal to v_cycle with the Chebyshev
    smoother and matmul transfers on the unpadded grids."""
    n = len(plv)
    mm = lambda a, b: jnp.matmul(a, b, precision="highest")
    cs = lambda a, L: lax.with_sharding_constraint(
        a, NamedSharding(mesh, L.spec))
    dt_ = u.dtype

    fs = [f]
    us = [u]
    for k in range(n - 1):
        L, Ln = plv[k], plv[k + 1]
        uk = chebyshev_smooth(us[k], fs[k], L.dx, L.dy, cfg.v1, imasks[k])
        r = residual_full(fs[k], uk, L.dx, L.dy, imasks[k])
        rx = _restrict_matrix_padded(L.nx, Ln.P, L.P, dt_)
        ry = _restrict_matrix_padded(L.ny, Ln.Q, L.Q, dt_)
        us[k] = uk
        fs.append(cs(mm(mm(rx, r), ry.T), Ln))
        us.append(jnp.zeros((Ln.P, Ln.Q), dt_))
    Lc = plv[-1]
    us[-1] = chebyshev_smooth(us[-1], fs[-1], Lc.dx, Lc.dy,
                              cfg.v2 if n > 1 else cfg.v1, imasks[-1])

    for k in range(n - 1, 0, -1):
        L, Lf = plv[k], plv[k - 1]
        pxm = _prolong_matrix_padded(L.nx, Lf.P, L.P, dt_)
        pym = _prolong_matrix_padded(L.ny, Lf.Q, L.Q, dt_)
        corr = mm(mm(pxm, us[k]), pym.T) * imasks[k - 1]
        uf = cs(us[k - 1] + corr, Lf)
        us[k - 1] = chebyshev_smooth(uf, fs[k - 1], Lf.dx, Lf.dy,
                                     cfg.v3, imasks[k - 1])
    return us[0]


def _mesh_fmg_start(fp, up, plv, imasks, cfg, mesh):
    """fmg_start on the padded pyramid (homogenize, restrict down, one
    V-cycle per level on the way up)."""
    n = len(plv)
    mm = lambda a, b: jnp.matmul(a, b, precision="highest")
    cs = lambda a, L: lax.with_sharding_constraint(
        a, NamedSharding(mesh, L.spec))
    L0 = plv[0]
    g = residual_full(fp, up, L0.dx, L0.dy, imasks[0])
    gs = [g]
    for k in range(1, n):
        L, Ln = plv[k - 1], plv[k]
        rx = _restrict_matrix_padded(L.nx, Ln.P, L.P, fp.dtype)
        ry = _restrict_matrix_padded(L.ny, Ln.Q, L.Q, fp.dtype)
        gs.append(cs(mm(mm(rx, gs[k - 1]), ry.T), Ln))
    Lc = plv[-1]
    v = jnp.zeros((Lc.P, Lc.Q), fp.dtype)
    v = chebyshev_smooth(v, gs[-1], Lc.dx, Lc.dy, cfg.v2, imasks[-1])
    for k in range(n - 2, -1, -1):
        L, Lf = plv[k + 1], plv[k]
        pxm = _prolong_matrix_padded(L.nx, Lf.P, L.P, fp.dtype)
        pym = _prolong_matrix_padded(L.ny, Lf.Q, L.Q, fp.dtype)
        v = cs(mm(mm(pxm, v), pym.T) * imasks[k], Lf)
        v = _mesh_v_cycle(v, gs[k], plv[k:], imasks[k:], cfg, mesh)
    return up + v


def _mesh_solve(f, u0, dx: float, dy: float, cfg: MGConfig,
                mesh) -> IterativeResult:
    """solve() over a device mesh (called from solve under its jit; mesh
    is a static arg).  Takes/returns UNPADDED (nx+1, ny+1) arrays."""
    cfg = _mesh_cfg(cfg)
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    plv = _mesh_levels(nx, ny, dx, dy, cfg.n_levels, mesh)
    imasks = [_padded_imask(L.nx, L.ny, L.P, L.Q, f.dtype) for L in plv]
    L0 = plv[0]
    cs0 = lambda a: lax.with_sharding_constraint(
        a, NamedSharding(mesh, L0.spec))
    fp = cs0(jnp.pad(f, ((0, L0.P - (nx + 1)), (0, L0.Q - (ny + 1)))))
    up = cs0(jnp.pad(u0, ((0, L0.P - (nx + 1)), (0, L0.Q - (ny + 1)))))

    rms0 = _rms_from_full(residual_full(fp, up, dx, dy, imasks[0]),
                          nx, ny)
    if cfg.fmg:
        up = _mesh_fmg_start(fp, up, plv, imasks, cfg, mesh)
    hist0 = jnp.full((cfg.max_cycles + 1, 3), jnp.nan, f.dtype)

    def cond(c):
        u, it, rms, hist, nrec = c
        return (it < cfg.max_cycles) & (rms / rms0 > cfg.tol)

    def body(c):
        u, it, rms, hist, nrec = c
        u = _mesh_v_cycle(u, fp, plv, imasks, cfg, mesh)
        rms = _rms_from_full(residual_full(fp, u, dx, dy, imasks[0]),
                             nx, ny)
        it = it + 1
        rec = jnp.stack([it.astype(f.dtype), rms, rms / rms0])
        hist = lax.dynamic_update_slice(hist, rec[None], (nrec, 0))
        return (u, it, rms, hist, nrec + 1)

    u, it, rms, hist, nrec = lax.while_loop(
        cond, body, (up, jnp.array(0), rms0, hist0, jnp.array(0)))
    return IterativeResult(u=u[: nx + 1, : ny + 1], iterations=it,
                           rms=rms, rms0=rms0, history=hist,
                           n_records=nrec)
