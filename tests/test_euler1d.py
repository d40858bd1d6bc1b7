"""Euler Sod shock tube vs the exact Riemann solution (reference ch. 09-11).

The reference validates Sod only by plotting low-res profiles against an
nx=8192 HLLC run labelled "True" (09_.../plotting.jl:33-61); here the exact
Riemann solution (Toro ch. 4) is the oracle.
"""

import numpy as np
import pytest

from cfd_julia_tpu.models import euler1d


def exact_sod(x, t, gamma=1.4, rhoL=1.0, uL=0.0, pL=1.0,
              rhoR=0.125, uR=0.0, pR=0.1, x0=0.5):
    """Exact solution of the Riemann problem, sampled at (x - x0)/t."""
    aL = np.sqrt(gamma * pL / rhoL)
    aR = np.sqrt(gamma * pR / rhoR)
    g1 = (gamma - 1) / (2 * gamma)
    g2 = (gamma + 1) / (2 * gamma)

    def f_side(p, ps, rhos, as_):
        if p > ps:  # shock
            A = 2 / ((gamma + 1) * rhos)
            B = (gamma - 1) / (gamma + 1) * ps
            return (p - ps) * np.sqrt(A / (p + B))
        # rarefaction
        return 2 * as_ / (gamma - 1) * ((p / ps) ** g1 - 1)

    def fp_side(p, ps, rhos, as_):
        if p > ps:
            A = 2 / ((gamma + 1) * rhos)
            B = (gamma - 1) / (gamma + 1) * ps
            return np.sqrt(A / (p + B)) * (1 - (p - ps) / (2 * (p + B)))
        return (p / ps) ** (-g2) / (rhos * as_)

    du = uR - uL
    p = 0.5 * (pL + pR)
    for _ in range(60):  # Newton
        f = f_side(p, pL, rhoL, aL) + f_side(p, pR, rhoR, aR) + du
        df = fp_side(p, pL, rhoL, aL) + fp_side(p, pR, rhoR, aR)
        p = max(1e-8, p - f / df)
    us = 0.5 * (uL + uR) + 0.5 * (
        f_side(p, pR, rhoR, aR) - f_side(p, pL, rhoL, aL)
    )

    s = (np.asarray(x) - x0) / t
    rho = np.empty_like(s)
    u = np.empty_like(s)
    pp = np.empty_like(s)
    for i, si in enumerate(s):
        if si < us:  # left of contact
            if p > pL:  # left shock
                SL = uL - aL * np.sqrt(g2 * p / pL + g1)
                if si < SL:
                    rho[i], u[i], pp[i] = rhoL, uL, pL
                else:
                    rho[i] = rhoL * (p / pL + (gamma - 1) / (gamma + 1)) / (
                        (gamma - 1) / (gamma + 1) * p / pL + 1
                    )
                    u[i], pp[i] = us, p
            else:  # left rarefaction
                SHL = uL - aL
                aSL = aL * (p / pL) ** g1
                STL = us - aSL
                if si < SHL:
                    rho[i], u[i], pp[i] = rhoL, uL, pL
                elif si > STL:
                    rho[i] = rhoL * (p / pL) ** (1 / gamma)
                    u[i], pp[i] = us, p
                else:  # fan
                    u[i] = 2 / (gamma + 1) * (aL + (gamma - 1) / 2 * uL + si)
                    a = aL - (gamma - 1) / 2 * (u[i] - uL)
                    rho[i] = rhoL * (a / aL) ** (2 / (gamma - 1))
                    pp[i] = pL * (a / aL) ** (2 * gamma / (gamma - 1))
        else:  # right of contact
            if p > pR:  # right shock
                SR = uR + aR * np.sqrt(g2 * p / pR + g1)
                if si > SR:
                    rho[i], u[i], pp[i] = rhoR, uR, pR
                else:
                    rho[i] = rhoR * (p / pR + (gamma - 1) / (gamma + 1)) / (
                        (gamma - 1) / (gamma + 1) * p / pR + 1
                    )
                    u[i], pp[i] = us, p
            else:  # right rarefaction
                SHR = uR + aR
                aSR = aR * (p / pR) ** g1
                STR = us + aSR
                if si > SHR:
                    rho[i], u[i], pp[i] = rhoR, uR, pR
                elif si < STR:
                    rho[i] = rhoR * (p / pR) ** (1 / gamma)
                    u[i], pp[i] = us, p
                else:
                    u[i] = 2 / (gamma + 1) * (-aR + (gamma - 1) / 2 * uR + si)
                    a = aR + (gamma - 1) / 2 * (u[i] - uR)
                    rho[i] = rhoR * (a / aR) ** (2 / (gamma - 1))
                    pp[i] = pR * (a / aR) ** (2 * gamma / (gamma - 1))
    return rho, u, pp


@pytest.mark.parametrize(
    "solver,nx,l1_tol",
    [("roe", 256, 6e-3), ("hllc", 256, 6e-3), ("rusanov", 256, 9e-3),
     ("hllc", 1024, 2e-3)],
)
def test_sod_density_profile(solver, nx, l1_tol):
    cfg = euler1d.EulerConfig(nx=nx, solver=solver, dt=0.2 / (2000 * nx // 256))
    res = euler1d.solve(cfg)
    rho_e, u_e, p_e = exact_sod(np.asarray(res.x), cfg.t_final)
    rho, u, p, _ = euler1d.primitives_from_result(res)
    assert np.abs(np.asarray(rho) - rho_e).mean() < l1_tol
    assert np.abs(np.asarray(p) - p_e).mean() < l1_tol
    assert np.all(np.asarray(rho) > 0) and np.all(np.asarray(p) > 0)


def test_solvers_agree():
    qs = {}
    for solver in ("roe", "hllc", "rusanov"):
        cfg = euler1d.EulerConfig(nx=256, solver=solver)
        qs[solver] = np.asarray(euler1d.solve(cfg).q)
    assert np.abs(qs["roe"] - qs["hllc"]).max() < 0.03
    assert np.abs(qs["roe"] - qs["rusanov"]).max() < 0.05


def test_conservation():
    """Mass and energy have zero boundary flux (u=0 at both ends until the
    waves arrive) -> conserved exactly; total momentum grows at the exact
    rate (pL - pR) from the boundary pressure difference."""
    cfg = euler1d.EulerConfig(nx=512, solver="hllc", dt=5e-5)
    res = euler1d.solve(cfg)
    q0 = np.asarray(res.snapshots[0])
    qf = np.asarray(res.q)
    dx = cfg.dx
    d_tot = (qf.sum(axis=1) - q0.sum(axis=1)) * dx
    assert abs(d_tot[0]) < 1e-11                      # mass
    assert abs(d_tot[2]) < 1e-11                      # energy
    expected_dmom = (cfg.p_l - cfg.p_r) * cfg.t_final  # = 0.18
    assert abs(d_tot[1] - expected_dmom) < 1e-9, d_tot[1]


def test_rusanov_wavespeed2_reference_parity():
    """riemann.rusanov_wavespeed2 vs a literal port of the reference's
    wavespeed2 (euler_rusanov.jl:122-139): cell-centred spectral radius,
    neighbor-max interfaces, copied ends."""
    import jax.numpy as jnp

    from cfd_julia_tpu.ops import riemann

    rng = np.random.default_rng(5)
    nx, gamma = 64, 1.4
    rho = rng.uniform(0.1, 2.0, nx)
    u = rng.uniform(-1.5, 1.5, nx)
    p = rng.uniform(0.1, 2.0, nx)
    q = np.stack([rho, rho * u, p / (gamma - 1) + 0.5 * rho * u**2])

    rad = np.empty(nx)
    for i in range(nx):
        a = np.sqrt(gamma * ((gamma - 1.0) *
                             (q[2, i] - 0.5 * q[1, i]**2 / q[0, i]))
                    / q[0, i])
        rad[i] = max(abs(q[1, i] / q[0, i]),
                     abs(q[1, i] / q[0, i] + a),
                     abs(q[1, i] / q[0, i] - a))
    ps = np.empty(nx + 1)
    ps[1:nx] = np.maximum(rad[:-1], rad[1:])
    ps[0] = ps[1]
    ps[nx] = ps[nx - 1]

    mine = np.asarray(riemann.rusanov_wavespeed2(jnp.asarray(q), gamma))
    np.testing.assert_allclose(mine, ps, rtol=1e-12, atol=0)


def test_rusanov_spectral_uses_cell_centred_speed():
    """Under rusanov_wavespeed='spectral' the RHS takes its Rusanov speed
    from the CELL-centred wavespeed2 (riemann.rusanov_wavespeed2), not
    from the reconstructed interface states."""
    from cfd_julia_tpu.models import euler1d
    from cfd_julia_tpu.ops import riemann, weno

    cfg = euler1d.EulerConfig(nx=128, solver="rusanov",
                              rusanov_wavespeed="spectral")
    from cfd_julia_tpu.stepping import ssprk3

    x, q0 = euler1d.sod_initial_state(cfg, np.float64)
    rhs = euler1d.make_rhs(cfg)
    # a few steps in, so the shock, contact and fan are resolved over
    # several cells and interface states differ from cell states
    for _ in range(20):
        q0 = ssprk3.ssprk3_step(rhs, q0, cfg.dt)
    r_rhs = rhs(q0)
    qL = weno.reconstruct_left(q0, "mirror")
    qR = weno.reconstruct_right(q0, "mirror")
    fL, fR = riemann.flux(qL, cfg.gamma), riemann.flux(qR, cfg.gamma)
    f = riemann.rusanov(qL, qR, fL, fR, cfg.gamma,
                        ps=riemann.rusanov_wavespeed2(q0, cfg.gamma))
    want = -(f[:, 1:] - f[:, :-1]) / cfg.dx
    np.testing.assert_allclose(np.asarray(r_rhs), np.asarray(want),
                               rtol=1e-12, atol=1e-12)
    # the interface-state bound differs near the shock: the choice matters
    f_if = riemann.rusanov(qL, qR, fL, fR, cfg.gamma, wavespeed="spectral")
    assert not np.allclose(np.asarray(f), np.asarray(f_if))
