"""Lid-driven cavity — fused interior-padded formulation.

Same math as models.cavity.make_step_fn (reference ch. 18,
lid_driven_cavity.jl:58-118), reorganized so the hot loop never touches a
misaligned array:

* State holds the (nx-1, ny-1) INTERIOR of w and psi inside buffers padded
  UP to (8k, 128k) tile extents — at the north-star 1024^2 that is a
  1024x1024 buffer (vs the 1025x1025 full grid, whose every [1:-1] slice /
  concat / pad is an offset-by-one relayout pass, and whose matmul
  operands are one row and column off a power of two).
* Wall vorticity enters the Arakawa/Laplacian stencils as four O(n) wall
  VECTORS (lid_driven_cavity.jl:24-51) applied with `where` masks on the
  zero-fill shifts — XLA fuses the whole RHS + RK combine + wall
  correction into one elementwise pass; no (nx+1)^2 assembly is ever
  materialized.
* The DST-I Poisson solve is the dense MXU sine-transform pair
  (poisson.direct.solve_fst_matmul_interior's math) with matrices
  zero-extended to the padded extents: operands are exact MXU tiles and
  the solution lands back in the padded layout with no pad/slice pass.
* psi's walls are exactly zero, so its zero-fill shifts need no
  correction; w's padding is re-zeroed by one fused mask per stage.

Trajectory-equality with the reference formulation is pinned by
tests/test_cavity_fused.py (fp64, vs make_step_fn poisson="matmul").

Subtlety carried from the reference: the wall BCs of the vorticity field
entering a stage's RHS were assembled from the PRE-solve psi of the
previous stage (lid_driven_cavity.jl:80,89-93: bc2 runs before fps), so
the packed state carries the four wall vectors alongside the interior —
they lag psi by one solve, exactly like the full-grid step.  The lid
corners w(0,ny) = w(nx,ny) = -3/dy (order 2; -2/dy order 1) are nonzero
(the y-walls own the corners) and feed the diagonal stencil shifts of the
first/last interior columns.
"""
from __future__ import annotations

from functools import partial

import jax.numpy as jnp
from jax import lax

from cfd_julia_tpu.core import precision
from cfd_julia_tpu.poisson.direct import _sine_entries


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def padded_extents(nx: int, ny: int) -> tuple[int, int]:
    """Interior (nx-1, ny-1) padded to sublane/lane tile multiples."""
    return _round_up(nx - 1, 8), _round_up(ny - 1, 128)


def _shift(a, da: int, db: int):
    """out[i, j] = a[i+da, j+db] (in range) else 0 — aligned dataflow
    (pad + slice), never a roll (no wraparound values to mask off)."""
    pads = ((max(-da, 0), max(da, 0)), (max(-db, 0), max(db, 0)))
    return lax.slice(
        jnp.pad(a, pads),
        (pads[0][1], pads[1][1]),
        (a.shape[0] + pads[0][1], a.shape[1] + pads[1][1]),
    )


def _vshift(v, d: int, L: int, corner):
    """Wall-vector shift with the corner value at the LOGICAL edge:
    out[k] = v[k+d] in-range, `corner` at the slot whose neighbour is the
    adjacent wall (k = L-1 for d=+1, k = 0 for d=-1), zero beyond the
    logical range (the buffer may be padded past L, so a plain
    end-of-buffer fill would land on padding, not the corner)."""
    assert d in (1, -1)
    pad = (max(-d, 0), max(d, 0))
    out = lax.slice(jnp.pad(v, pad), (pad[1],), (v.shape[0] + pad[1],))
    k = jnp.arange(v.shape[0])
    exposed = (k == L - 1) if d > 0 else (k == 0)
    return jnp.where(exposed, jnp.asarray(corner, v.dtype), out)


# CavityConfig.poisson name -> core.precision tier of the sine transforms
FUSED_TIERS = {"fused": "highest", "fused_bf16x3": "high",
               "fused_bf16x1": "default"}


def make_fused_step_fn(cfg, mm_precision: str = "highest"):
    """Step on packed state (w_int, s_int, walls, rms).

    w_int, s_int: (P, Q) padded interior buffers (padding exactly zero);
    walls: (rl, rh, cl, ch) wall-vorticity vectors — rl/rh over j (length
    Q: w at i=0 / i=nx), cl/ch over i (length P: w at j=0 / j=ny), all in
    interior index space (entry b is full node j=b+1), zero outside the
    logical range; rms: the step's ||psi^n - psi^{n-1}|| scalar.
    """
    nx, ny = cfg.nx, cfg.ny
    dx, dy, dt, re = cfg.dx, cfg.dy, cfg.dt, cfg.re
    m, n = nx - 1, ny - 1
    P, Q = padded_extents(nx, ny)
    order = cfg.bc_order
    if order not in (1, 2):
        raise ValueError("bc_order must be 1 or 2")
    lid = -3.0 / dy if order == 2 else -2.0 / dy  # moving-lid term; also
    # the value at BOTH lid corners (ny-wall rows own the corners and the
    # streamfunction vanishes on every wall)

    ai = jnp.arange(P)[:, None]
    bj = jnp.arange(Q)[None, :]
    valid = (ai < m) & (bj < n)
    a_first, a_last = ai == 0, ai == m - 1
    b_first, b_last = bj == 0, bj == n - 1

    def sine_padded(nn, size, dtype):
        k = jnp.arange(size, dtype=jnp.int32)
        s = _sine_entries(k[:, None] + 1, k[None, :] + 1, nn, dtype)
        return jnp.where((k[:, None] < nn - 1) & (k[None, :] < nn - 1),
                         s, jnp.zeros((), dtype))

    def make_solve(dtype):
        sx = sine_padded(nx, P, dtype)
        sy = sine_padded(ny, Q, dtype)
        kx = (ai + 1).astype(dtype)
        ky = (bj + 1).astype(dtype)
        den = (2.0 / dx**2) * (jnp.cos(jnp.pi * kx / nx) - 1.0) + (
            2.0 / dy**2) * (jnp.cos(jnp.pi * ky / ny) - 1.0)
        den = jnp.where(valid, den, jnp.ones((), dtype))
        mm = lambda a, b: precision.matmul(a, b, mm_precision)

        def solve_neg(wt):
            """psi with lap(psi) = -wt on the interior (walls zero)."""
            coeff = mm(mm(sx, wt), sy) / (-den)
            return mm(mm(sx, coeff), sy) * (4.0 / (nx * ny))

        return solve_neg

    def wall_vecs(s):
        """Wall vorticity from the (pre-solve) interior psi
        (lid_driven_cavity.jl:24-51 in interior index space).  Logical
        tails beyond m/n are zero because s's padding is zero."""
        if order == 1:
            rl = -2.0 * s[0, :] / dx**2
            rh = -2.0 * s[m - 1, :] / dx**2
            cl = -2.0 * s[:, 0] / dy**2
            ch = -2.0 * s[:, n - 1] / dy**2 + lid
        else:
            rl = (-4.0 * s[0, :] + 0.5 * s[1, :]) / dx**2
            rh = (-4.0 * s[m - 1, :] + 0.5 * s[m - 2, :]) / dx**2
            cl = (-4.0 * s[:, 0] + 0.5 * s[:, 1]) / dy**2
            ch = (-4.0 * s[:, n - 1] + 0.5 * s[:, n - 2]) / dy**2 + lid
        # the lid term applies on the logical wall only — the padded tail
        # must stay zero or the ch-based diagonal corrections at b = n-1
        # would read it (they don't: _vshift fills explicitly; but the
        # axis correction `where(b_last, ch, .)` broadcasts ch[a] over
        # rows a >= m, which the final validity mask re-zeroes)
        ivec = jnp.arange(P)
        ch = jnp.where(ivec < m, ch, jnp.zeros((), s.dtype))
        cl = jnp.where(ivec < m, cl, jnp.zeros((), s.dtype))
        return rl, rh, cl, ch

    def rhs(w, s, walls):
        """-J(w, s) + lap(w)/re on the padded interior (ops.arakawa's
        expression structure, with the wall values of w supplied by the
        carried vectors; psi's walls are exactly zero)."""
        rl, rh, cl, ch = walls
        rlr, rhr = rl[None, :], rh[None, :]
        clc, chc = cl[:, None], ch[:, None]

        # axis shifts of w, wall-corrected.  E/W = +/-i, N/S = +/-j.
        wE = jnp.where(a_last, rhr, _shift(w, 1, 0))
        wW = jnp.where(a_first, rlr, _shift(w, -1, 0))
        wN = jnp.where(b_last, chc, _shift(w, 0, 1))
        wS = jnp.where(b_first, clc, _shift(w, 0, -1))
        # diagonals: row-wall correction first, then the col-wall one —
        # the y-walls own the corners (reference write order), and the
        # corner fills keep both layers consistent at (0|m-1, 0|n-1)
        wNE = _shift(w, 1, 1)
        wNE = jnp.where(a_last, _vshift(rh, 1, n, lid)[None, :], wNE)
        wNE = jnp.where(b_last, _vshift(ch, 1, m, lid)[:, None], wNE)
        wSE = _shift(w, 1, -1)
        wSE = jnp.where(a_last, _vshift(rh, -1, n, 0.0)[None, :], wSE)
        wSE = jnp.where(b_first, _vshift(cl, 1, m, 0.0)[:, None], wSE)
        wNW = _shift(w, -1, 1)
        wNW = jnp.where(a_first, _vshift(rl, 1, n, lid)[None, :], wNW)
        wNW = jnp.where(b_last, _vshift(ch, -1, m, lid)[:, None], wNW)
        wSW = _shift(w, -1, -1)
        wSW = jnp.where(a_first, _vshift(rl, -1, n, 0.0)[None, :], wSW)
        wSW = jnp.where(b_first, _vshift(cl, -1, m, 0.0)[:, None], wSW)

        # psi: zero walls, zero padding — plain zero-fill shifts
        sE, sW = _shift(s, 1, 0), _shift(s, -1, 0)
        sN, sS = _shift(s, 0, 1), _shift(s, 0, -1)
        sNE, sSW = _shift(s, 1, 1), _shift(s, -1, -1)
        sNW, sSE = _shift(s, -1, 1), _shift(s, 1, -1)

        gg = 1.0 / (4.0 * dx * dy)
        j1 = (wE - wW) * (sN - sS) - (wN - wS) * (sE - sW)
        j2 = (wE * (sNE - sSE) - wW * (sNW - sSW)
              - wN * (sNE - sNW) + wS * (sSE - sSW))
        j3 = (wNE * (sN - sE) - wSW * (sW - sS)
              - wNW * (sN - sW) + wSE * (sE - sS))
        jac = gg * (j1 + j2 + j3) / 3.0
        lap = (wE - 2 * w + wW) / dx**2 + (wN - 2 * w + wS) / dy**2
        return -jac + lap / re

    n_nodes = float((nx + 1) * (ny + 1))

    def step(state):
        w, s, walls, _ = state
        solve_neg = make_solve(w.dtype)  # trace-time only: the matrices
        # are iota-built constants at the carried dtype
        sp = s

        def close(wt_raw, s_pre):
            wt = jnp.where(valid, wt_raw, jnp.zeros((), wt_raw.dtype))
            return wt, solve_neg(wt), wall_vecs(s_pre)

        r = rhs(w, s, walls)
        wt, s, walls = close(w + dt * r, s)
        r = rhs(wt, s, walls)
        wt, s, walls = close(0.75 * w + 0.25 * wt + 0.25 * dt * r, s)
        r = rhs(wt, s, walls)
        wn, s, walls = close((w + 2.0 * wt + 2.0 * dt * r) / 3.0, s)

        rms = jnp.sqrt(jnp.sum((s - sp) ** 2) / n_nodes)
        return (wn, s, walls, rms)

    return step


def init_state(cfg, dtype=jnp.float32):
    """Packed state of the from-rest start (w = 0, psi = 0, ZERO wall
    vectors — the full-grid step's first RHS also sees the all-zero w0,
    not BC-consistent walls; trajectory equality requires matching it)."""
    P, Q = padded_extents(cfg.nx, cfg.ny)
    z = jnp.zeros((P, Q), dtype)
    walls = (jnp.zeros((Q,), dtype), jnp.zeros((Q,), dtype),
             jnp.zeros((P,), dtype), jnp.zeros((P,), dtype))
    return (z, jnp.zeros_like(z), walls, jnp.zeros((), dtype))


def pack_state(cfg, w_full, s_full):
    """Full-grid (w, s) -> packed state (walls taken from w_full)."""
    m, n = cfg.nx - 1, cfg.ny - 1
    P, Q = padded_extents(cfg.nx, cfg.ny)
    pad = ((0, P - m), (0, Q - n))
    wi = jnp.pad(w_full[1:-1, 1:-1], pad)
    si = jnp.pad(s_full[1:-1, 1:-1], pad)
    walls = (jnp.pad(w_full[0, 1:-1], (0, Q - n)),
             jnp.pad(w_full[-1, 1:-1], (0, Q - n)),
             jnp.pad(w_full[1:-1, 0], (0, P - m)),
             jnp.pad(w_full[1:-1, -1], (0, P - m)))
    return (wi, si, walls, jnp.zeros((), w_full.dtype))


def decode_state(cfg, state):
    """Packed state -> full-grid (w, s) — walls re-attached from the
    carried vectors (the corner values are the y-wall ones, matching
    assemble_with_wall_bc's write order), psi's walls are zero."""
    w, s, (rl, rh, cl, ch), _ = state
    m, n = cfg.nx - 1, cfg.ny - 1
    lid_corner = (-3.0 if cfg.bc_order == 2 else -2.0) / cfg.dy
    dtype = w.dtype
    mid = jnp.concatenate([rl[None, :n], w[:m, :n], rh[None, :n]], axis=0)
    col_lo = jnp.concatenate([jnp.zeros((1,), dtype), cl[:m],
                              jnp.zeros((1,), dtype)])
    corner = jnp.asarray(lid_corner, dtype)
    # a from-rest zero state must decode to the all-zero w_full: the lid
    # corners are only nonzero once the walls themselves are (first close)
    corner = jnp.where(ch[:m].any(), corner, jnp.zeros((), dtype))
    col_hi = jnp.concatenate([corner[None], ch[:m], corner[None]])
    w_full = jnp.concatenate(
        [col_lo[:, None], mid, col_hi[:, None]], axis=1)
    s_full = jnp.pad(s[:m, :n], 1)
    return w_full, s_full
