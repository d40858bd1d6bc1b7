"""The XLA forms that replaced the hand-written kernels, against literal NumPy loops.

The multigrid level edges (smooth -> residual -> restrict on the way down,
prolong -> correct -> smooth on the way up), the periodic Arakawa
vorticity RHS, and the 1D Euler RHS per Riemann solver, each checked at
small sizes in fp64 against a loop translation of the reference
(mg_N.jl / Common.jl, euler_*.jl).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_julia_tpu.poisson import iterative, multigrid

# ----------------------------------------------------- NumPy references


def np_residual(f, u, dx, dy):
    """f - lap(u) on the interior, 0 on the boundary ring."""
    r = np.zeros_like(u)
    for i in range(1, u.shape[0] - 1):
        for j in range(1, u.shape[1] - 1):
            lap = ((u[i + 1, j] - 2 * u[i, j] + u[i - 1, j]) / dx**2
                   + (u[i, j + 1] - 2 * u[i, j] + u[i, j - 1]) / dy**2)
            r[i, j] = f[i, j] - lap
    return r


def np_restrict(r):
    """Full weighting, boundary injection (Common.jl:21-48)."""
    nc, mc = (r.shape[0] - 1) // 2, (r.shape[1] - 1) // 2
    ec = np.zeros((nc + 1, mc + 1))
    for i in range(1, nc):
        for j in range(1, mc):
            ec[i, j] = (4 * r[2 * i, 2 * j]
                        + 2 * (r[2 * i, 2 * j + 1] + r[2 * i, 2 * j - 1]
                               + r[2 * i + 1, 2 * j] + r[2 * i - 1, 2 * j])
                        + r[2 * i + 1, 2 * j + 1] + r[2 * i + 1, 2 * j - 1]
                        + r[2 * i - 1, 2 * j + 1]
                        + r[2 * i - 1, 2 * j - 1]) / 16
    ec[0, :] = r[0, ::2]
    ec[-1, :] = r[-1, ::2]
    ec[:, 0] = r[::2, 0]
    ec[:, -1] = r[::2, -1]
    return ec


def np_prolong(uc):
    """Bilinear coarse -> fine (Common.jl:50-76)."""
    nf, mf = 2 * (uc.shape[0] - 1), 2 * (uc.shape[1] - 1)
    u = np.zeros((nf + 1, mf + 1))
    for i in range(nf + 1):
        for j in range(mf + 1):
            ic, jc = i // 2, j // 2
            di, dj = i % 2, j % 2
            u[i, j] = 0.25 * (uc[ic, jc] + uc[min(ic + di, uc.shape[0] - 1), jc]
                              + uc[ic, min(jc + dj, uc.shape[1] - 1)]
                              + uc[min(ic + di, uc.shape[0] - 1),
                                   min(jc + dj, uc.shape[1] - 1)])
    return u


def np_rb_sweeps(u, f, dx, dy, sweeps):
    """Red-black Gauss-Seidel, point by point: red ((i+j) even) first."""
    u = u.copy()
    diag = -2.0 / dx**2 - 2.0 / dy**2
    for _ in range(sweeps):
        for colour in (0, 1):
            new = u.copy()
            for i in range(1, u.shape[0] - 1):
                for j in range(1, u.shape[1] - 1):
                    if (i + j) % 2 != colour:
                        continue
                    lap = ((u[i + 1, j] - 2 * u[i, j] + u[i - 1, j]) / dx**2
                           + (u[i, j + 1] - 2 * u[i, j] + u[i, j - 1])
                           / dy**2)
                    new[i, j] = u[i, j] + (f[i, j] - lap) / diag
            u = new
    return u


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    nr, nc = shape
    return (rng.standard_normal(shape), rng.standard_normal(shape),
            1.0 / (nr - 1), 1.0 / (nc - 1))


# ------------------------------------------------------- multigrid edges

@pytest.mark.parametrize("shape", [(65, 65), (33, 65), (129, 129)])
def test_residual_restrict_matches_numpy(shape):
    """The descend edge's transfer: restriction(residual_full(f, u))."""
    u, f, dx, dy = _fields(shape, 3)
    mask = iterative.interior_mask(shape[0] - 1, shape[1] - 1, jnp.float64)
    out = multigrid.restriction(iterative.residual_full(
        jnp.asarray(f), jnp.asarray(u), dx, dy, mask))
    np.testing.assert_allclose(np.asarray(out),
                               np_restrict(np_residual(f, u, dx, dy)),
                               rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("shape,sweeps", [((65, 65), 0), ((65, 65), 2),
                                          ((33, 65), 3), ((65, 33), 4)])
def test_prolong_correct_smooth_matches_numpy(shape, sweeps):
    """The ascend edge: smooth(u + prolongation(uc) * imask, f, sweeps)."""
    u, f, dx, dy = _fields(shape, 4)
    rng = np.random.default_rng(5)
    uc = rng.standard_normal(((shape[0] - 1) // 2 + 1,
                              (shape[1] - 1) // 2 + 1))
    nx, ny = shape[0] - 1, shape[1] - 1
    imask = iterative.interior_mask(nx, ny, jnp.float64)
    masks = iterative.color_masks(nx, ny, jnp.float64)
    out = multigrid.smooth(
        jnp.asarray(u) + multigrid.prolongation(jnp.asarray(uc)) * imask,
        jnp.asarray(f), dx, dy, sweeps, masks, "xla")
    corr = np_prolong(uc)
    corr[0, :] = corr[-1, :] = 0.0
    corr[:, 0] = corr[:, -1] = 0.0
    want = np_rb_sweeps(u + corr, f, dx, dy, sweeps)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-11,
                               atol=1e-11)


@pytest.mark.parametrize("shape,sweeps", [((65, 65), 1), ((33, 65), 2),
                                          ((65, 65), 3)])
def test_smooth_residual_restrict_matches_numpy(shape, sweeps):
    """The whole descend edge: smooth, residual, restrict."""
    u, f, dx, dy = _fields(shape, 6)
    nx, ny = shape[0] - 1, shape[1] - 1
    masks = iterative.color_masks(nx, ny, jnp.float64)
    mask = iterative.interior_mask(nx, ny, jnp.float64)
    us = multigrid.smooth(jnp.asarray(u), jnp.asarray(f), dx, dy, sweeps,
                          masks, "xla")
    fc = multigrid.restriction(iterative.residual_full(
        jnp.asarray(f), us, dx, dy, mask))
    want_u = np_rb_sweeps(u, f, dx, dy, sweeps)
    np.testing.assert_allclose(np.asarray(us), want_u, rtol=1e-11,
                               atol=1e-11)
    np.testing.assert_allclose(
        np.asarray(fc), np_restrict(np_residual(f, want_u, dx, dy)),
        rtol=1e-10, atol=1e-7)


# ------------------------------------------------------ Arakawa RHS

@pytest.mark.parametrize("n", [32, 48])
def test_arakawa_rhs_matches_numpy(n):
    """-J(w, s) + lap(w)/re, periodic (Common.jl:132-182, literal loop)."""
    from cfd_julia_tpu.ops import arakawa

    rng = np.random.default_rng(1)
    w = rng.standard_normal((n, n))
    s = rng.standard_normal((n, n))
    dx = dy = 2 * np.pi / n
    re = 100.0
    gg = 1 / (4 * dx * dy)
    want = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            ip, im = (i + 1) % n, (i - 1) % n
            jp, jm = (j + 1) % n, (j - 1) % n
            j1 = (w[ip, j] - w[im, j]) * (s[i, jp] - s[i, jm]) - (
                w[i, jp] - w[i, jm]) * (s[ip, j] - s[im, j])
            j2 = (w[ip, j] * (s[ip, jp] - s[ip, jm])
                  - w[im, j] * (s[im, jp] - s[im, jm])
                  - w[i, jp] * (s[ip, jp] - s[im, jp])
                  + w[i, jm] * (s[ip, jm] - s[im, jm]))
            j3 = (w[ip, jp] * (s[i, jp] - s[ip, j])
                  - w[im, jm] * (s[im, j] - s[i, jm])
                  - w[im, jp] * (s[i, jp] - s[im, j])
                  + w[ip, jm] * (s[ip, j] - s[i, jm]))
            lap = ((w[ip, j] - 2 * w[i, j] + w[im, j]) / dx**2
                   + (w[i, jp] - 2 * w[i, j] + w[i, jm]) / dy**2)
            want[i, j] = -gg * (j1 + j2 + j3) / 3 + lap / re
    out = arakawa.vorticity_rhs(jnp.asarray(w), jnp.asarray(s), dx, dy, re)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-11,
                               atol=1e-11)


# --------------------------------------------------------- Euler RHS

def _np_weno_l(v):
    eps = 1e-6
    v1, v2, v3, v4, v5 = v
    s1 = 13 / 12 * (v1 - 2 * v2 + v3) ** 2 + 0.25 * (v1 - 4 * v2 + 3 * v3) ** 2
    s2 = 13 / 12 * (v2 - 2 * v3 + v4) ** 2 + 0.25 * (v2 - v4) ** 2
    s3 = 13 / 12 * (v3 - 2 * v4 + v5) ** 2 + 0.25 * (3 * v3 - 4 * v4 + v5) ** 2
    c1, c2, c3 = 0.1 / (eps + s1) ** 2, 0.6 / (eps + s2) ** 2, \
        0.3 / (eps + s3) ** 2
    q1 = v1 / 3 - 7 / 6 * v2 + 11 / 6 * v3
    q2 = -v2 / 6 + 5 / 6 * v3 + v4 / 3
    q3 = v3 / 3 + 5 / 6 * v4 - v5 / 6
    return (c1 * q1 + c2 * q2 + c3 * q3) / (c1 + c2 + c3)


def _np_weno_r(v):
    eps = 1e-6
    v1, v2, v3, v4, v5 = v
    s1 = 13 / 12 * (v1 - 2 * v2 + v3) ** 2 + 0.25 * (v1 - 4 * v2 + 3 * v3) ** 2
    s2 = 13 / 12 * (v2 - 2 * v3 + v4) ** 2 + 0.25 * (v2 - v4) ** 2
    s3 = 13 / 12 * (v3 - 2 * v4 + v5) ** 2 + 0.25 * (3 * v3 - 4 * v4 + v5) ** 2
    c1, c2, c3 = 0.3 / (eps + s1) ** 2, 0.6 / (eps + s2) ** 2, \
        0.1 / (eps + s3) ** 2
    q1 = -v1 / 6 + 5 / 6 * v2 + v3 / 3
    q2 = v2 / 3 + 5 / 6 * v3 - v4 / 6
    q3 = 11 / 6 * v3 - 7 / 6 * v4 + v5 / 3
    return (c1 * q1 + c2 * q2 + c3 * q3) / (c1 + c2 + c3)


def _np_prims(q, g):
    rho, m, E = q
    u = m / rho
    p = (g - 1) * (E - 0.5 * m * u)
    return rho, u, p, (E + p) / rho


def _np_flux(q, g):
    rho, u, p, _ = _np_prims(q, g)
    return np.array([q[1], q[1] * u + p, (q[2] + p) * u])


def _np_riemann(solver, qL, qR, g):
    """One interface, scalar code (euler_roe.jl:107-167,
    euler_hllc.jl:105-152, euler_rusanov.jl:107-168)."""
    fL, fR = _np_flux(qL, g), _np_flux(qR, g)
    rhoL, uL, pL, hL = _np_prims(qL, g)
    rhoR, uR, pR, hR = _np_prims(qR, g)
    sl, sr = np.sqrt(abs(rhoL)), np.sqrt(abs(rhoR))
    uu = (sl * uL + sr * uR) / (sl + sr)
    hh = (sl * hL + sr * hR) / (sl + sr)
    aa = np.sqrt(abs((g - 1) * (hh - 0.5 * uu**2)))
    if solver == "rusanov":
        return 0.5 * (fR + fL) - 0.5 * abs(aa + uu) * (qR - qL)
    if solver == "roe":
        gm = g - 1
        # right eigenvectors R, left eigenvectors L = R^-1, |Lambda|
        R = np.array([[1, 1, 1], [uu, uu + aa, uu - aa],
                      [0.5 * uu**2, hh + uu * aa, hh - uu * aa]])
        lam = np.abs(np.array([uu, uu + aa, uu - aa]))
        A = R @ np.diag(lam) @ np.linalg.inv(R)
        del gm
        return 0.5 * (fR + fL) - 0.5 * A @ (qR - qL)
    aL, aR = np.sqrt(abs(g * pL / rhoL)), np.sqrt(abs(g * pR / rhoR))
    SL = min(uL, uR) - max(aL, aR)
    SR = max(uL, uR) + max(aL, aR)
    SP = (pR - pL + rhoL * uL * (SL - uL) - rhoR * uR * (SR - uR)) / (
        rhoL * (SL - uL) - rhoR * (SR - uR))
    PLR = 0.5 * (pL + pR + rhoL * (SL - uL) * (SP - uL)
                 + rhoR * (SR - uR) * (SP - uR))
    D = np.array([0.0, 1.0, SP])
    if SL >= 0:
        return fL
    if SR <= 0:
        return fR
    if SP >= 0:
        return (SP * (SL * qL - fL) + SL * PLR * D) / (SL - SP)
    return (SP * (SR * qR - fR) + SR * PLR * D) / (SR - SP)


@pytest.mark.parametrize("solver", ["hllc", "roe", "rusanov"])
def test_euler_rhs_matches_numpy(solver):
    """make_rhs = mirror WENO-5 at both interface sides -> Riemann flux
    -> flux divergence, against scalar per-interface code."""
    from cfd_julia_tpu.models import euler1d

    cfg = euler1d.EulerConfig(nx=32, solver=solver)
    _, q0 = euler1d.sod_initial_state(cfg, jnp.float64)
    # smooth the jump a little so every WENO branch sees varied data
    q = np.asarray(q0) * (1.0 + 0.05 * np.sin(np.arange(32) / 3.0))
    n, g = q.shape[1], cfg.gamma

    def ghost(i):            # mirror ghosts: u_{-k} = u_{k-1}
        return -i - 1 if i < 0 else (2 * n - 1 - i if i >= n else i)

    flux = np.zeros((3, n + 1))
    for j in range(n + 1):
        qL = np.array([_np_weno_l([q[c, ghost(j - 3 + k)] for k in range(5)])
                       for c in range(3)])
        qR = np.array([_np_weno_r([q[c, ghost(j - 2 + k)] for k in range(5)])
                       for c in range(3)])
        flux[:, j] = _np_riemann(solver, qL, qR, g)
    want = -(flux[:, 1:] - flux[:, :-1]) / cfg.dx
    out = euler1d.make_rhs(cfg)(jnp.asarray(q))
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-9, atol=1e-9)
