"""1D heat equation u_t = alpha u_xx — four schemes (reference ch. 01-04).

Problem (identical across all four reference scripts, e.g. ftcs.jl:9-27):
    x in [-1, 1], Dirichlet u(+-1)=0, alpha = 1/pi^2,
    u(x,0) = -sin(pi x),  exact u(x,t) = -exp(-t) sin(pi x),
    default nx=80 (dx=.025), dt=.0025, t_final=1.

Schemes:
* ``ftcs``  explicit forward-time centred-space      (ftcs.jl:35-40)
* ``rk3``   SSP-RK3 with central second difference   (rk3.jl:14-58)
* ``cn``    Crank–Nicolson, tridiagonal per step     (cn.jl:8-26)
* ``icp``   implicit compact Padé, 4th order in space (icp.jl:8-29)

Design: the per-step tridiagonal coefficient arrays the reference
rebuilds every iteration (cn.jl:16-23) are constant -> precomputed once; the
whole time loop is one `lax.scan`; CN/ICP solve their tridiagonal systems
with parallel cyclic reduction (ops.tridiag) instead of serial Thomas.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from cfd_julia_tpu.core import precision
from cfd_julia_tpu.ops import norms, tridiag
from cfd_julia_tpu.stepping import loop, ssprk3


@dataclasses.dataclass(frozen=True)
class HeatConfig:
    nx: int = 80
    x0: float = -1.0
    x1: float = 1.0
    dt: float = 0.0025
    t_final: float = 1.0
    alpha: float = 1.0 / jnp.pi**2
    scheme: str = "ftcs"  # ftcs | rk3 | cn | icp
    tridiag_method: str = "pcr"

    @property
    def dx(self) -> float:
        return (self.x1 - self.x0) / self.nx

    @property
    def nt(self) -> int:
        return round(self.t_final / self.dt)


@dataclasses.dataclass
class HeatResult:
    x: jax.Array
    u: jax.Array
    u_exact: jax.Array
    l2_error: jax.Array
    linf_error: jax.Array
    history: jax.Array | None = None  # (nt+1, nx+1) when requested


def initial_condition(cfg: HeatConfig, dtype):
    x = jnp.linspace(cfg.x0, cfg.x1, cfg.nx + 1, dtype=dtype)
    u0 = -jnp.sin(jnp.pi * x)
    u0 = u0.at[0].set(0.0).at[-1].set(0.0)
    return x, u0


def exact_solution(x, t):
    return -jnp.exp(-t) * jnp.sin(jnp.pi * x)


# ---------------------------------------------------------------- explicit

def ftcs_step(u, beta):
    """u[i] += beta (u[i+1] - 2u[i] + u[i-1]) on interior; Dirichlet 0 ends."""
    un = u.at[1:-1].add(beta * (u[2:] - 2 * u[1:-1] + u[:-2]))
    return un.at[0].set(0.0).at[-1].set(0.0)


def _central_rhs(u, alpha, dx):
    r = jnp.zeros_like(u)
    return r.at[1:-1].set(alpha * (u[2:] - 2 * u[1:-1] + u[:-2]) / dx**2)


def rk3_step(u, alpha, dx, dt):
    un = ssprk3.ssprk3_step(lambda v: _central_rhs(v, alpha, dx), u, dt)
    return un.at[0].set(0.0).at[-1].set(0.0)


# ---------------------------------------------------------------- implicit

def cn_system(cfg: HeatConfig, dtype):
    """Constant Crank–Nicolson LHS diagonals with identity boundary rows
    (cn.jl:14-24). Returns (a, b, c, rhs_fn)."""
    n = cfg.nx + 1
    a1 = cfg.alpha * cfg.dt / (2 * cfg.dx**2)
    a = jnp.full((n,), -a1, dtype=dtype).at[0].set(0.0).at[-1].set(0.0)
    b = jnp.full((n,), 1 + 2 * a1, dtype=dtype).at[0].set(1.0).at[-1].set(1.0)
    c = jnp.full((n,), -a1, dtype=dtype).at[0].set(0.0).at[-1].set(0.0)

    def rhs(u):
        r = a1 * u[2:] + (1 - 2 * a1) * u[1:-1] + a1 * u[:-2]
        return jnp.concatenate([jnp.zeros((1,), dtype), r, jnp.zeros((1,), dtype)])

    return a, b, c, rhs


def icp_system(cfg: HeatConfig, dtype):
    """Implicit compact Padé (4th order): (1,10,1)/12-type mass stencil on
    both sides (icp.jl:14-24). Returns (a, b, c, rhs_fn)."""
    n = cfg.nx + 1
    dx2 = cfg.dx**2
    adt = cfg.alpha * cfg.dt
    off = 12.0 / dx2 - 2.0 / adt
    dia = -24.0 / dx2 - 20.0 / adt
    a = jnp.full((n,), off, dtype=dtype).at[0].set(0.0).at[-1].set(0.0)
    b = jnp.full((n,), dia, dtype=dtype).at[0].set(1.0).at[-1].set(1.0)
    c = jnp.full((n,), off, dtype=dtype).at[0].set(0.0).at[-1].set(0.0)

    def rhs(u):
        r = (
            -2.0 / adt * (u[2:] + 10 * u[1:-1] + u[:-2])
            - 12.0 / dx2 * (u[2:] - 2 * u[1:-1] + u[:-2])
        )
        return jnp.concatenate([jnp.zeros((1,), dtype), r, jnp.zeros((1,), dtype)])

    return a, b, c, rhs


# ------------------------------------------------------------------ driver

def make_step_fn(cfg: HeatConfig, dtype):
    if cfg.scheme == "ftcs":
        beta = jnp.asarray(cfg.alpha * cfg.dt / cfg.dx**2, dtype)
        return lambda u: ftcs_step(u, beta)
    if cfg.scheme == "rk3":
        return lambda u: rk3_step(u, cfg.alpha, cfg.dx, cfg.dt)
    if cfg.scheme in ("cn", "icp"):
        build = cn_system if cfg.scheme == "cn" else icp_system
        a, b, c, rhs = build(cfg, dtype)

        def step(u):
            un = tridiag.solve(a, b, c, rhs(u), method=cfg.tridiag_method)
            return un.at[0].set(0.0).at[-1].set(0.0)

        return step
    raise ValueError(f"unknown heat scheme {cfg.scheme!r}")


def solve(cfg: HeatConfig, dtype=None, keep_history: bool = False) -> HeatResult:
    """keep_history=True also returns the full (nt+1, nx+1) time history,
    matching the reference's `un[(nx+1) x (nt+1)]` storage (ftcs.jl:21) —
    opt-in here (device-resident scan stack) rather than always-on."""
    dtype = dtype or precision.default_dtype()
    x, u0 = initial_condition(cfg, dtype)
    step = make_step_fn(cfg, dtype)
    history = None
    if keep_history:
        u, hist = loop.run_steps_with_snapshots(step, u0, cfg.nt, 1)
        history = jnp.concatenate([u0[None], hist], axis=0)
    else:
        u = loop.run_steps(step, u0, cfg.nt)
    ue = exact_solution(x, cfg.t_final)
    err = u - ue
    return HeatResult(
        x=x, u=u, u_exact=ue,
        l2_error=norms.l2norm_interior(err),
        linf_error=norms.linf(err),
        history=history,
    )
