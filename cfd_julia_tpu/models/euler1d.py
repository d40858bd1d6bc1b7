"""1D Euler equations — Sod shock tube with Roe / HLLC / Rusanov fluxes
(reference ch. 09-11).

Pipeline per RK3 stage (euler_roe.jl:86-102, identical in ch. 10/11):
WENO-5 mirror-boundary reconstruction of the conservative state to both
sides of each interface -> Euler fluxes of the reconstructed states ->
pointwise Riemann flux -> conservative flux divergence.

Layout: q is component-major (3, nx); the WENO reconstruction
batches the three components along the leading axis in one fused kernel;
the whole rhs is branchless vector code.

Reference configs: Roe nx=256, dt=1e-4; HLLC/Rusanov nx=8192, dt=5e-5;
t_final=0.2, gamma=1.4, Sod states (1,0,1) | (0.125,0,0.1), diaphragm x=0.5,
cell centres x_i = (i+1/2)dx on [0,1] (euler_roe.jl:27-45).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from cfd_julia_tpu.core import precision
from cfd_julia_tpu.ops import riemann, weno
from cfd_julia_tpu.stepping import loop, ssprk3


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    nx: int = 256
    solver: str = "roe"          # roe | hllc | rusanov
    dt: float = 1e-4
    t_final: float = 0.2
    ns: int = 20
    gamma: float = 1.4
    rusanov_wavespeed: str = "roe"
    # Sod states
    rho_l: float = 1.0
    u_l: float = 0.0
    p_l: float = 1.0
    rho_r: float = 0.125
    u_r: float = 0.0
    p_r: float = 0.1
    x_diaphragm: float = 0.5

    @property
    def dx(self) -> float:
        return 1.0 / self.nx

    @property
    def nt(self) -> int:
        return round(self.t_final / self.dt)


@dataclasses.dataclass
class EulerResult:
    x: jnp.ndarray
    q: jnp.ndarray          # (3, nx) final conservative state
    snapshots: jnp.ndarray  # (ns+1, 3, nx)


def sod_initial_state(cfg: EulerConfig, dtype):
    x = (jnp.arange(cfg.nx, dtype=dtype) + 0.5) * cfg.dx
    right = x > cfg.x_diaphragm
    one = jnp.asarray(1.0, dtype)  # pin dtype (where() of python floats
    rho = jnp.where(right, cfg.rho_r * one, cfg.rho_l * one)  # is weak f64)
    u = jnp.where(right, cfg.u_r * one, cfg.u_l * one)
    p = jnp.where(right, cfg.p_r * one, cfg.p_l * one)
    e = p / (rho * (cfg.gamma - 1.0)) + 0.5 * u**2
    q = jnp.stack([rho, rho * u, rho * e])
    return x, q


_RIEMANN = {"roe": riemann.roe, "hllc": riemann.hllc, "rusanov": riemann.rusanov}


def make_rhs(cfg: EulerConfig):
    dx = cfg.dx
    gamma = cfg.gamma
    solver = _RIEMANN[cfg.solver]
    kwargs = (
        {"wavespeed": cfg.rusanov_wavespeed} if cfg.solver == "rusanov" else {}
    )

    def rhs(q):
        qL = weno.reconstruct_left(q, "mirror")    # (3, nx+1)
        qR = weno.reconstruct_right(q, "mirror")   # (3, nx+1)
        fL = riemann.flux(qL, gamma)
        fR = riemann.flux(qR, gamma)
        extra = dict(kwargs)
        if extra.get("wavespeed") == "spectral":
            # wavespeed2 parity: the reference evaluates the spectral
            # radius at CELL centres, not the reconstructed interfaces
            extra["ps"] = riemann.rusanov_wavespeed2(q, gamma)
        f = solver(qL, qR, fL, fR, gamma, **extra)
        return -(f[:, 1:] - f[:, :-1]) / dx

    return rhs


def solve(cfg: EulerConfig, dtype=None) -> EulerResult:
    dtype = dtype or precision.default_dtype()
    x, q0 = sod_initial_state(cfg, dtype)
    rhs = make_rhs(cfg)
    step = lambda q: ssprk3.ssprk3_step(rhs, q, cfg.dt)
    final, snaps = loop.run_steps_with_snapshots(
        step, q0, cfg.nt, max(1, cfg.nt // cfg.ns)
    )
    snapshots = jnp.concatenate([q0[None], snaps], axis=0)
    return EulerResult(x=x, q=final, snapshots=snapshots)


def primitives_from_result(res: EulerResult, gamma: float = 1.4):
    """(rho, u, p, E_total_specific) for plotting/validation — matches
    the reference output columns (euler_roe.jl:187-205).  The energy is
    the TOTAL specific energy E = q3/rho (internal + kinetic), exactly
    the reference's plotted column; internal energy alone would be
    p/((gamma-1) rho)."""
    rho, u, e, p, _ = riemann.primitives(res.q, gamma)
    return rho, u, p, e
