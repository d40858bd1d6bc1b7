"""2D Poisson stack (reference ch. 12-17): direct transform solvers,
iterative relaxation/CG, multigrid — error norms, convergence orders,
residual histories, and cross-solver agreement.
"""
import numpy as np
import pytest

from cfd_julia_tpu.models import poisson2d
from cfd_julia_tpu.poisson import multigrid


def test_fft_fdm_reference_accuracy():
    """The only numbers recorded in the reference repo: FFT-FDM L2 error
    1.56e-3 at 32^2 down to 8.87e-6 at 512^2
    (13_.../specrtral_vs_FDM/order.jl:11)."""
    errs = {}
    for nx in (32, 64, 128, 256):
        cfg = poisson2d.PoissonConfig(nx=nx, ny=nx, solver="fft", problem="sine32")
        errs[nx] = float(poisson2d.solve(cfg).l2_error)
    # measured here: 1.66e-3, 6.18e-4, 1.45e-4, 3.58e-5 vs reference-recorded
    # 1.56e-3, 5.99e-4, 1.43e-4, 3.55e-5 (coarse-grid gap = fp roundoff of the
    # aliased 32 pi mode, sin(pi*i) != 0 in floating point)
    assert abs(errs[32] - 1.56e-3) / 1.56e-3 < 0.08, errs
    assert abs(errs[256] - 3.55e-5) / 3.55e-5 < 0.02, errs
    # asymptotic second-order convergence
    p = np.log(errs[64] / errs[256]) / np.log(4.0)
    assert p > 1.9, (errs, p)


def test_fft_spectral_machine_precision():
    """Spectral eigenvalues resolve the MMS exactly: error ~ machine eps
    (recorded ~1.3e-16 in 13_.../order.jl:10)."""
    cfg = poisson2d.PoissonConfig(nx=64, ny=64, solver="fft_spectral", problem="sine32")
    res = poisson2d.solve(cfg)
    assert float(res.l2_error) < 1e-13, float(res.l2_error)


def test_fst_matches_fft_fdm_accuracy():
    """DST-I solver is the same 2nd-order FDM inverse on Dirichlet BCs."""
    cfg = poisson2d.PoissonConfig(nx=128, ny=128, solver="fst", problem="sine32")
    res = poisson2d.solve(cfg)
    cfg2 = poisson2d.PoissonConfig(nx=128, ny=128, solver="fft", problem="sine32")
    res2 = poisson2d.solve(cfg2)
    assert float(res.l2_error) < 2 * float(res2.l2_error) + 1e-6


@pytest.mark.parametrize("solver", ["jacobi", "redblack", "cg", "multigrid"])
def test_iterative_solvers_converge(solver):
    """All iterative solvers reach tol and match the exact poly solution.
    For ue = (x^2-1)(y^2-1) the 5-point Laplacian is exact (second
    differences of quadratics are exact), so discretization error is zero
    and the final error reflects only the solve tolerance."""
    kwargs = {}
    if solver == "multigrid":
        kwargs["mg"] = multigrid.MGConfig(tol=1e-10, max_cycles=60)
    cfg = poisson2d.PoissonConfig(
        nx=64, ny=64, solver=solver, problem="poly",
        tol=1e-10, max_iter=200_000, freq=1000, **kwargs,
    )
    res = poisson2d.solve(cfg)
    assert float(res.rms) / float(res.rms0) <= (
        kwargs["mg"].tol if solver == "multigrid" else cfg.tol
    ) * 1.001, (solver, float(res.rms / res.rms0))
    assert float(res.linf_error) < 1e-6, (solver, float(res.linf_error))


def test_multigrid_is_fast():
    """V-cycle converges in O(10) cycles independent of grid size
    (mg_N.jl runs 512^2 to 1e-9 in a handful of cycles)."""
    for nx in (64, 128):
        cfg = poisson2d.PoissonConfig(
            nx=nx, ny=nx, solver="multigrid", problem="sine16",
            mg=multigrid.MGConfig(tol=1e-9, max_cycles=50),
        )
        res = poisson2d.solve(cfg)
        assert int(res.iterations) <= 15, (nx, int(res.iterations))


def test_redblack_beats_jacobi():
    """True GS converges ~2x faster than Jacobi per sweep."""
    out = {}
    for solver in ("jacobi", "redblack"):
        cfg = poisson2d.PoissonConfig(
            nx=32, ny=32, solver=solver, problem="poly",
            tol=1e-8, max_iter=100_000, freq=100,
        )
        out[solver] = int(poisson2d.solve(cfg).iterations)
    assert out["redblack"] < 0.7 * out["jacobi"], out


def test_residual_history_recorded():
    cfg = poisson2d.PoissonConfig(
        nx=32, ny=32, solver="cg", problem="poly", tol=1e-9,
        max_iter=10_000, freq=10,
    )
    res = poisson2d.solve(cfg)
    n = int(res.iterations)
    hist = np.asarray(res.history)
    nrec = int(np.sum(~np.isnan(hist[:, 0])))
    assert nrec >= max(1, n // 10 - 1)
    rms_ratio = hist[:nrec, 2]
    assert (np.diff(rms_ratio) < 1e-6).mean() > 0.6  # mostly decreasing


def test_two_level_multigrid_preset():
    """mg.jl's 2-level V-cycle (reference ch. 17 first variant): converges
    slowly because the coarse level gets only v3=2 sweeps (mg.jl:60,101) —
    same behaviour as the reference; the deep pyramid is the fast path."""
    cfg = poisson2d.PoissonConfig(
        nx=64, ny=64, solver="multigrid", problem="poly",
        mg=multigrid.MGConfig(n_levels=2, tol=1e-9, max_cycles=400),
    )
    res = poisson2d.solve(cfg)
    assert float(res.rms) / float(res.rms0) < 1e-6
    # steady residual decrease across recorded cycles
    hist = np.asarray(res.history)
    rel = hist[~np.isnan(hist[:, 0]), 2]
    assert rel[-1] < rel[0] * 1e-3


def test_transfer_variants_match():
    """matmul / reshape transfer formulations are element-identical to the
    conv forms on interior-masked residuals (the only MG inputs)."""
    import jax.numpy as jnp
    from cfd_julia_tpu.poisson import iterative, multigrid

    rng = np.random.default_rng(11)
    for nf in (16, 32):
        r = jnp.asarray(rng.standard_normal((nf + 1, nf + 1)))
        r = r * iterative.interior_mask(nf, nf, r.dtype)
        ref = np.asarray(multigrid.restriction(r))
        np.testing.assert_allclose(
            np.asarray(multigrid.restriction_matmul(r)), ref,
            rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(
            np.asarray(multigrid.restriction_reshape(r)), ref,
            rtol=1e-13, atol=1e-13)
        uc = jnp.asarray(rng.standard_normal((nf // 2 + 1, nf // 2 + 1)))
        np.testing.assert_allclose(
            np.asarray(multigrid.prolongation_matmul(uc)),
            np.asarray(multigrid.prolongation(uc)), rtol=1e-13, atol=1e-13)


def test_mg_transfer_configs_converge():
    """Full V-cycle solve under each transfer implementation."""
    import jax.numpy as jnp
    from cfd_julia_tpu.models import poisson2d
    from cfd_julia_tpu.poisson import multigrid

    for transfers in ("conv", "matmul", "reshape"):
        mgc = multigrid.MGConfig(tol=1e-9, max_cycles=30,
                                 transfers=transfers)
        cfg = poisson2d.PoissonConfig(nx=64, ny=64, solver="multigrid",
                                      problem="poly", mg=mgc)
        _, _, _, _, ue, f = poisson2d.build_problem(cfg, jnp.float64)
        u0 = poisson2d._dirichlet_init(ue)
        res = multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=mgc)
        assert float(res.rms / res.rms0) <= 1e-9, transfers


def test_mg_anisotropic_2adic_levels():
    """Grids whose axes have different 2-adic valuations (20x16: nx path
    20->10->5 goes odd first) must coarsen only while BOTH axes stay
    even — previously crashed on a prolongation shape mismatch (review
    repro).  Also covers the rectangular CLI --nx/--ny override path."""
    import jax.numpy as jnp
    from cfd_julia_tpu.poisson import multigrid

    rng = np.random.default_rng(3)
    for nx, ny in ((20, 16), (16, 20), (80, 64)):
        f = np.zeros((nx + 1, ny + 1))
        f[1:-1, 1:-1] = rng.standard_normal((nx - 1, ny - 1))
        f = jnp.asarray(f)
        mgc = multigrid.MGConfig(tol=1e-6, max_cycles=40)
        res = multigrid.solve(f, jnp.zeros_like(f), 1.0 / nx, 1.0 / ny,
                              cfg=mgc)
        assert float(res.rms / res.rms0) <= 1e-6, (nx, ny)


def test_mg_requested_levels_clamped():
    """An explicit n_levels deeper than the grid allows is clamped to
    the feasible depth, not rejected — the poisson_mgN preset pins 9
    levels for 512^2 and must still compose with `run --nx 128` /
    `--sweep nx=...` overrides (verify repro)."""
    from cfd_julia_tpu.poisson import multigrid

    levels = multigrid._build_levels(128, 128, 1 / 128, 1 / 128, 9)
    assert levels == multigrid._build_levels(128, 128, 1 / 128, 1 / 128, 0)
    assert levels[-1][0] == 2
    # and a feasible explicit request is honored exactly
    assert len(multigrid._build_levels(128, 128, 1 / 128, 1 / 128, 3)) == 3


def test_mg_bf16_iterative_refinement():
    """cycle_dtype='bf16' runs the V-cycle pyramid in bfloat16 under an
    fp32 iterative-refinement outer loop.  Convergence contract: same
    order of cycle count as fp32 to the bench tolerance (1e-5 rel), and
    the returned u matches the exact solution at the same discretization
    error — the bf16 mantissa only rounds contraction steps, the fp32
    residual keeps the outer loop honest."""
    import jax.numpy as jnp
    from cfd_julia_tpu.models import poisson2d
    from cfd_julia_tpu.poisson import multigrid

    errs, cycles = {}, {}
    for cd in ("fp32", "bf16"):
        mgc = multigrid.MGConfig(tol=1e-5, max_cycles=30, cycle_dtype=cd)
        cfg = poisson2d.PoissonConfig(nx=128, ny=128, solver="multigrid",
                                      problem="poly", mg=mgc)
        _, _, _, _, ue, f = poisson2d.build_problem(cfg, jnp.float32)
        u0 = poisson2d._dirichlet_init(ue)
        res = multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=mgc)
        assert float(res.rms / res.rms0) <= 1e-5, cd
        errs[cd] = float(jnp.abs(res.u - ue).max())
        cycles[cd] = int(res.iterations)
    # bf16 IR may take at most a couple extra cycles, never 2x
    assert cycles["bf16"] <= cycles["fp32"] + 2, cycles
    # and the solution is as accurate as fp32's (both at discretization
    # error; 1.5x headroom for the different rounding paths)
    assert errs["bf16"] <= 1.5 * errs["fp32"] + 1e-6, errs

    with pytest.raises(ValueError, match="cycle_dtype"):
        bad = multigrid.MGConfig(cycle_dtype="fp16")
        multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=bad)


def test_fmg_honors_transfer_choice():
    """FMG's upleg uses the cfg-selected prolongation (was hardcoded to
    the conv form, silently ignoring transfers='matmul')."""
    import jax.numpy as jnp
    from cfd_julia_tpu.models import poisson2d
    from cfd_julia_tpu.poisson import multigrid

    mgc = multigrid.MGConfig(tol=1e-6, max_cycles=30, transfers="matmul",
                             fmg=True)
    cfg = poisson2d.PoissonConfig(nx=64, ny=64, solver="multigrid",
                                  problem="poly", mg=mgc)
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, jnp.float64)
    res = multigrid.solve(f, poisson2d._dirichlet_init(ue), cfg.dx,
                          cfg.dy, cfg=mgc)
    assert float(res.rms / res.rms0) <= 1e-6


def test_mg_chebyshev_smoother_converges():
    """Chebyshev-Jacobi smoothed V-cycles (smoother='cheb', raced in
    bench MG_VARIANTS) reach the bench tolerance (1e-5, worker_mg's
    regime) within +2 cycles of the RB baseline — at ~half the stencil
    passes per cycle, that is fewer total passes — and land on the same
    solution.  Also covers the fmg composition.  (At much deeper
    tolerances cheb's asymptotic factor is worse: 10 vs 7 cycles to
    1e-9 at 128^2 — the race targets the bench regime.)"""
    import jax.numpy as jnp
    from cfd_julia_tpu.models import poisson2d
    from cfd_julia_tpu.poisson import multigrid

    cycles = {}
    sols = {}
    for smoother, fmg in (("auto", False), ("cheb", False), ("cheb", True)):
        mgc = multigrid.MGConfig(tol=1e-5, max_cycles=30,
                                 smoother=smoother, fmg=fmg)
        cfg = poisson2d.PoissonConfig(nx=128, ny=128, solver="multigrid",
                                      problem="poly", mg=mgc)
        _, _, _, _, ue, f = poisson2d.build_problem(cfg, jnp.float64)
        u0 = poisson2d._dirichlet_init(ue)
        res = multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=mgc)
        assert float(res.rms / res.rms0) <= 1e-5, (smoother, fmg)
        cycles[(smoother, fmg)] = int(res.iterations)
        sols[(smoother, fmg)] = np.asarray(res.u)
    assert cycles[("cheb", False)] <= cycles[("auto", False)] + 2, cycles
    scale = np.abs(sols[("auto", False)]).max()
    d = np.abs(sols[("cheb", False)] - sols[("auto", False)]).max()
    assert d / scale < 1e-4, d / scale  # same solution to tol level


def test_chebyshev_smooth_damps_high_frequencies():
    """Smoothing property: degree-3 Chebyshev-Jacobi knocks down a
    highest-frequency error mode by >10x in one call (the band the
    smoother targets), leaving the boundary ring untouched."""
    import jax.numpy as jnp
    from cfd_julia_tpu.poisson import iterative

    n = 64
    dx = 1.0 / n
    i = jnp.arange(n + 1)
    # (-1)^{i+j} checkerboard: the lambda~2 extreme of D^{-1}A
    e0 = ((-1.0) ** (i[:, None] + i[None, :]))
    imask = iterative.interior_mask(n, n, e0.dtype)
    e0 = e0 * imask
    f = jnp.zeros_like(e0)  # exact solution is 0 -> error IS the state
    e1 = iterative.chebyshev_smooth(e0, f, dx, dx, 3, imask)
    assert float(jnp.abs(e1).max()) < 0.1 * float(jnp.abs(e0).max())
    np.testing.assert_array_equal(np.asarray(e1 * (1 - imask)),
                                  np.zeros_like(e1))


def test_mgcg_converges_grid_independent():
    """V-cycle-preconditioned flexible CG (beyond the reference): O(10)
    iterations at both 64^2 and 128^2 (grid-independent), vs plain CG's
    O(n) iteration counts, to the same tolerance and solution."""
    import jax.numpy as jnp
    from cfd_julia_tpu.models import poisson2d

    its = {}
    for nx in (64, 128):
        cfg = poisson2d.PoissonConfig(nx=nx, ny=nx, solver="mgcg",
                                      problem="poly", tol=1e-9)
        res = poisson2d.solve(cfg, jnp.float64)
        assert float(res.rms / res.rms0) <= 1e-9
        assert float(res.l2_error) < 1e-4       # discretization-level
        its[nx] = int(res.iterations)
        cg = poisson2d.solve(
            poisson2d.PoissonConfig(nx=nx, ny=nx, solver="cg",
                                    problem="poly", tol=1e-9), jnp.float64)
        assert int(cg.iterations) > 3 * its[nx]
    assert its[128] <= its[64] + 4              # grid independence
    assert its[128] <= 25


def test_fmg_start_cuts_vcycles():
    """Full-multigrid (nested iteration) start: reaches the same tolerance
    in fewer V-cycles than the zero start, and the first residual after
    the FMG start is already far below the plain rms0."""
    import jax.numpy as jnp
    from cfd_julia_tpu.models import poisson2d
    from cfd_julia_tpu.poisson import multigrid

    its = {}
    for fmg in (False, True):
        mgc = multigrid.MGConfig(tol=1e-10, max_cycles=60, fmg=fmg)
        cfg = poisson2d.PoissonConfig(nx=256, ny=256, solver="multigrid",
                                      problem="poly", mg=mgc)
        _, _, _, _, ue, f = poisson2d.build_problem(cfg, jnp.float64)
        u0 = poisson2d._dirichlet_init(ue)
        res = multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=mgc)
        assert float(res.rms / res.rms0) <= 1e-10
        its[fmg] = int(res.iterations)
    assert its[True] < its[False], its


def test_matmul_bf16x3_precision_bound():
    """cavity poisson='matmul_bf16x3' lowers its dots to the
    BF16_BF16_F32_X3 preset = 3-pass bf16 (a.hi@b.hi + a.hi@b.lo +
    a.lo@b.hi, fp32 accumulation; core.precision).  The CPU backend may
    run fp32 products instead, so emulate the decomposition in NumPy and
    bound the DST-solve error it introduces on a backend that honours
    the preset: it must sit well below the fp32-vs-fp64 study's 4e-4 psi
    tolerance (BASELINE.md)."""
    import jax.numpy as jnp
    import ml_dtypes

    from cfd_julia_tpu.poisson import direct

    def split(a):
        hi = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        lo = (a - hi).astype(ml_dtypes.bfloat16).astype(np.float32)
        return hi, lo

    def mm3x(a, b):
        ah, al = split(np.asarray(a, np.float32))
        bh, bl = split(np.asarray(b, np.float32))
        return ((ah.astype(np.float64) @ bh.astype(np.float64)).astype(
            np.float32)
            + (ah.astype(np.float64) @ bl.astype(np.float64)).astype(
                np.float32)
            + (al.astype(np.float64) @ bh.astype(np.float64)).astype(
                np.float32))

    nx = ny = 512
    dx = dy = 1.0 / nx
    P = Q = nx + 1
    rng = np.random.default_rng(7)
    f = np.zeros((P, Q))
    f[1:-1, 1:-1] = rng.standard_normal((nx - 1, ny - 1))

    s = np.asarray(direct.sine_matrix(nx, P, jnp.float64))
    k = np.arange(P)[:, None]
    l_ = np.arange(Q)[None, :]
    valid = ((k >= 1) & (k <= nx - 1)) & ((l_ >= 1) & (l_ <= ny - 1))
    den = np.where(
        valid,
        (2.0 / dx**2) * (np.cos(np.pi * k / nx) - 1.0)
        + (2.0 / dy**2) * (np.cos(np.pi * l_ / ny) - 1.0),
        1.0,
    )
    scale = 4.0 / (nx * ny)

    u64 = (s @ ((s @ f @ s) / den) @ s) * scale
    coeff3 = mm3x(s, mm3x(f.astype(np.float32), s)) / den
    u3x = mm3x(s, mm3x(coeff3.astype(np.float32), s)) * scale

    rel = np.abs(u3x - u64).max() / np.abs(u64).max()
    assert rel < 5e-5, rel

    # single-pass bf16 would NOT satisfy that bound
    def mm1x(a, b):
        ah, _ = split(np.asarray(a, np.float32))
        bh, _ = split(np.asarray(b, np.float32))
        return (ah.astype(np.float64) @ bh.astype(np.float64)).astype(
            np.float32)

    coeff1 = mm1x(s, mm1x(f.astype(np.float32), s)) / den
    u1x = mm1x(s, mm1x(coeff1.astype(np.float32), s)) * scale
    rel1 = np.abs(u1x - u64).max() / np.abs(u64).max()
    assert rel1 > 20 * rel, (rel1, rel)


def test_matmul_interior_matches_padded():
    """The MXU-tile-aligned interior matmul solver (the single-device
    cavity path) computes the same solution as the zero-extended padded
    form (the sharded path) — only the operand shapes differ."""
    import jax.numpy as jnp

    from cfd_julia_tpu.poisson import direct

    nx = ny = 32
    dx = dy = 1.0 / nx
    rng = np.random.default_rng(3)
    f = np.zeros((nx + 1, ny + 1))
    f[1:-1, 1:-1] = rng.standard_normal((nx - 1, ny - 1))
    f = jnp.asarray(f)
    up = direct.solve_fst_matmul_padded(f, nx, ny, dx, dy)
    ui = direct.solve_fst_matmul_interior(f, nx, ny, dx, dy)
    assert ui.shape == up.shape
    np.testing.assert_allclose(np.asarray(ui), np.asarray(up),
                               rtol=0, atol=1e-12)
    assert np.abs(np.asarray(ui)[0, :]).max() == 0.0  # exact-zero walls


def test_sine_matrix_fp32_construction_accuracy():
    """The DST matrices are built at trace time in the solve dtype; the
    period-reduced argument (int32 r*c mod 2n) keeps fp32 entries
    correctly rounded (~3e-7) where the naive pi*r*c/n fp32 product
    drifts to ~3e-4 at n=1024 (argument ~3.2e3 rad, ulp 2.4e-4)."""
    import jax.numpy as jnp

    from cfd_julia_tpu.poisson import direct

    n, size = 1024, 1025
    s32 = np.asarray(direct.sine_matrix(n, size, jnp.float32), np.float64)
    r = np.arange(size, dtype=np.float64)
    ref = np.sin(np.pi * r[:, None] * r[None, :] / n)
    ref[n:, :] = 0.0
    ref[:, n:] = 0.0
    assert np.abs(s32 - ref).max() < 1e-6


@pytest.mark.parametrize("nx,ny", [(100, 48), (40, 100), (96, 96)])
def test_matmul_interior_matches_fst_irregular_sizes(nx, ny):
    """The interior matmul solver equals the rfft odd-extension DST
    solver at non-reference, non-square, non-power-of-two grids — the
    sizes a `run --sweep nx=...` user actually hits."""
    import jax.numpy as jnp

    from cfd_julia_tpu.poisson import direct

    dx, dy = 1.0 / nx, 1.0 / ny
    rng = np.random.default_rng(11)
    f = np.zeros((nx + 1, ny + 1))
    f[1:-1, 1:-1] = rng.standard_normal((nx - 1, ny - 1))
    f = jnp.asarray(f)
    u_fst = direct.solve_fst(f, dx, dy)
    u_int = direct.solve_fst_matmul_interior(f, nx, ny, dx, dy)
    assert u_int.shape == u_fst.shape == (nx + 1, ny + 1)
    np.testing.assert_allclose(np.asarray(u_int), np.asarray(u_fst),
                               rtol=0, atol=1e-11)


def test_matmul_refined_matches_fst_and_refines():
    """solve_fst_matmul_refined (negative-result artifact, see its
    docstring: on-chip the eps*kappa(L) amplification makes refinement
    WORSE and the physics gate rejected it): the construction itself is
    still exact math — on CPU (precision knobs no-op) it must equal the
    plain solvers, pinning that the documented failure is the bf16
    conditioning analysis, not broken plumbing."""
    import jax.numpy as jnp

    from cfd_julia_tpu.poisson import direct

    nx = ny = 48
    dx = dy = 1.0 / nx
    rng = np.random.default_rng(7)
    f = np.zeros((nx + 1, ny + 1))
    f[1:-1, 1:-1] = rng.standard_normal((nx - 1, ny - 1))
    f = jnp.asarray(f)
    u_fst = direct.solve_fst(f, dx, dy)
    u_ref = direct.solve_fst_matmul_refined(f, nx, ny, dx, dy)
    assert u_ref.shape == u_fst.shape
    np.testing.assert_allclose(np.asarray(u_ref), np.asarray(u_fst),
                               rtol=0, atol=1e-10)
    assert np.abs(np.asarray(u_ref)[0, :]).max() == 0.0   # zero walls
    assert np.abs(np.asarray(u_ref)[:, -1]).max() == 0.0


def test_mg_mixed_precision_pyramid():
    """cycle_dtype='mixed' (round 5): finest level fp32, coarser levels
    bf16.  Unlike the full-bf16 pyramid (which stalls at 4096^2 because
    the FINE-level correction rounds to bf16 — PERF.md), the mixed
    pyramid's fine state never leaves fp32, so convergence must match
    fp32 cycle-for-cycle (+1 slack) at the bench tolerance, and the
    solution lands at the same discretization error.  The casts live on
    the level-0/1 edges (multigrid.v_cycle)."""
    import jax.numpy as jnp
    from cfd_julia_tpu.models import poisson2d
    from cfd_julia_tpu.poisson import multigrid

    errs, cycles = {}, {}
    for cd in ("fp32", "mixed"):
        mgc = multigrid.MGConfig(tol=1e-5, max_cycles=30, cycle_dtype=cd)
        cfg = poisson2d.PoissonConfig(nx=128, ny=128, solver="multigrid",
                                      problem="poly", mg=mgc)
        _, _, _, _, ue, f = poisson2d.build_problem(cfg, jnp.float32)
        u0 = poisson2d._dirichlet_init(ue)
        res = multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=mgc)
        assert float(res.rms / res.rms0) <= 1e-5, cd
        assert res.u.dtype == jnp.float32
        errs[cd] = float(jnp.abs(res.u - ue).max())
        cycles[cd] = int(res.iterations)
    assert cycles["mixed"] <= cycles["fp32"] + 1, cycles
    assert errs["mixed"] <= 1.5 * errs["fp32"] + 1e-6, errs
