"""Batched tridiagonal solvers — the engine behind Crank–Nicolson, the
implicit compact Padé scheme, and CRWENO-5 reconstruction.

The reference uses sequential Thomas sweeps (`tdms` Common.jl:257-271,
`tdma` Common.jl:276-287) and a cyclic Sherman–Morrison wrapper (`ctdms`,
06_Inviscid_Burgers_CRWENO/crweno_periodic.jl:74-93). A Thomas sweep is an
inherently serial O(n) recurrence — the single worst fit for data-parallel
hardware. The engine here is **parallel cyclic reduction (PCR)**:
ceil(log2 n) fully data-parallel elimination rounds of O(n) work each, all
expressible as shifted-array arithmetic that XLA fuses and vectorizes.

All solvers operate on the **last axis** and broadcast over leading batch
axes (CRWENO solves one system per RK3 stage per sweep direction; Euler
solves 3 components; 2D ADI-style usage solves nx systems at once).

A sequential `thomas` (lax.scan) is kept as the reference/fallback path and
for cross-validation in tests.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def _shift_last(x, k: int, fill):
    """x[..., i-k] with constant fill outside range (k may be negative)."""
    if k == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (abs(k),), fill, dtype=x.dtype)
    if k > 0:
        return jnp.concatenate([pad, x[..., :-k]], axis=-1)
    return jnp.concatenate([x[..., -k:], pad], axis=-1)


def pcr(a, b, c, d):
    """Solve tridiagonal systems by parallel cyclic reduction.

    a: sub-diagonal   (a[..., 0] ignored / must be 0)
    b: main diagonal
    c: super-diagonal (c[..., -1] ignored / must be 0)
    d: right-hand side(s); broadcasts with a/b/c over leading axes.
    Returns x with d's shape.

    Each round eliminates the coupling at stride s by row-combining with
    rows i-s and i+s (out-of-range rows behave as identity rows
    a=0, b=1, c=0, d=0), doubling the stride until every row is decoupled.
    Stable for the diagonally-dominant systems this engine serves.
    """
    n = d.shape[-1]
    a, b, c, d = jnp.broadcast_arrays(a, b, c, d)
    one = jnp.asarray(1.0, dtype=b.dtype)
    zero = jnp.asarray(0.0, dtype=b.dtype)
    steps = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    s = 1
    for _ in range(steps):
        a_m = _shift_last(a, s, zero)
        b_m = _shift_last(b, s, one)
        c_m = _shift_last(c, s, zero)
        d_m = _shift_last(d, s, zero)
        a_p = _shift_last(a, -s, zero)
        b_p = _shift_last(b, -s, one)
        c_p = _shift_last(c, -s, zero)
        d_p = _shift_last(d, -s, zero)
        alpha = -a / b_m
        gamma = -c / b_p
        b = b + alpha * c_m + gamma * a_p
        d = d + alpha * d_m + gamma * d_p
        a = alpha * a_m
        c = gamma * c_p
        s *= 2
    return d / b


def _thomas_1d(a, b, c, d):
    """Sequential Thomas solve of one system (lax.scan; reference parity
    with Common.jl:257-271)."""
    # forward elimination: carry (beta, x_prev)
    def fwd(carry, abcd):
        beta_prev, x_prev = carry
        ai, bi, ci_prev, di = abcd
        z = ci_prev / beta_prev
        beta = bi - ai * z
        x = (di - ai * x_prev) / beta
        return (beta, x), (x, z)

    c_prev = jnp.concatenate([jnp.zeros((1,), c.dtype), c[:-1]])
    beta0 = b[0]
    x0 = d[0] / beta0
    (_, _), (xs, zs) = lax.scan(
        fwd, (beta0, x0), (a[1:], b[1:], c_prev[1:], d[1:])
    )
    xs = jnp.concatenate([x0[None], xs])
    zs = jnp.concatenate([jnp.zeros((1,), d.dtype), zs])

    # back substitution: x[i] -= z[i+1] * x[i+1]
    def bwd(x_next, xz):
        xi, zi1 = xz
        x = xi - zi1 * x_next
        return x, x

    z_next = jnp.concatenate([zs[1:], jnp.zeros((1,), d.dtype)])
    _, xs_rev = lax.scan(bwd, xs[-1], (xs[:-1][::-1], z_next[:-1][::-1]))
    return jnp.concatenate([xs_rev[::-1], xs[-1][None]])


def thomas(a, b, c, d):
    """Sequential Thomas solve, batched over leading axes via vmap."""
    a, b, c, d = jnp.broadcast_arrays(a, b, c, d)
    flat = [x.reshape((-1, x.shape[-1])) for x in (a, b, c, d)]
    out = jax.vmap(_thomas_1d)(*flat)
    return out.reshape(d.shape)


def solve(a, b, c, d, method: str = "pcr"):
    """Solve (batched) tridiagonal systems along the last axis."""
    if method == "pcr":
        return pcr(a, b, c, d)
    if method == "thomas":
        return thomas(a, b, c, d)
    raise ValueError(f"unknown tridiagonal method {method!r}")


@partial(jax.jit, static_argnames=("method",))
def solve_cyclic(a, b, c, d, method: str = "pcr"):
    """Solve a *cyclic* (periodic) tridiagonal system by Sherman–Morrison.

    The corner couplings are taken from a[..., 0] (row 0 -> x_{n-1}) and
    c[..., -1] (row n-1 -> x_0), exactly the layout the reference's `ctdms`
    consumes (crweno_periodic.jl:74-93). Solves the rank-1-corrected
    acyclic system twice (batched into one PCR call) and combines.
    """
    a, b, c, d = jnp.broadcast_arrays(a, b, c, d)
    alpha = a[..., 0]   # A[0, n-1]
    beta = c[..., -1]   # A[n-1, 0]
    gamma = -b[..., 0]

    # A = T + u v^T with u = (gamma, 0..0, beta), v = (1, 0..0, alpha/gamma)
    b_mod = b.at[..., 0].add(-gamma)
    b_mod = b_mod.at[..., -1].add(-alpha * beta / gamma)
    a_mod = a.at[..., 0].set(0.0)
    c_mod = c.at[..., -1].set(0.0)

    u = jnp.zeros_like(d)
    u = u.at[..., 0].set(gamma)
    u = u.at[..., -1].set(beta)

    rhs = jnp.stack([d, u], axis=0)
    yz = solve(a_mod[None], b_mod[None], c_mod[None], rhs, method=method)
    y, z = yz[0], yz[1]

    fact = (y[..., 0] + alpha * y[..., -1] / gamma) / (
        1.0 + z[..., 0] + alpha * z[..., -1] / gamma
    )
    return y - fact[..., None] * z
