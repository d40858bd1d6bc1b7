"""The 22 reference chapter configurations as named presets.

Each preset reproduces a reference script's hardcoded `main()` setup
(solver family, grid, time step, physics constants) — the rebuild's
replacement for "edit the constants and rerun the script" (SURVEY §5,
config/flag system). Run with `python -m cfd_julia_tpu run <preset>`;
any config field can be overridden on the CLI (e.g. --nx 1024).
"""
from __future__ import annotations

import dataclasses

from cfd_julia_tpu.models import burgers1d, cavity, euler1d, heat1d, poisson2d, vortex
from cfd_julia_tpu.poisson import multigrid


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    family: str          # heat | burgers | euler | poisson | cavity | vortex
    cfg: object
    reference: str       # reference script this mirrors
    description: str = ""


def _p(name, family, cfg, reference, description=""):
    return Preset(name, family, cfg, reference, description)


PRESETS = {
    p.name: p
    for p in [
        # --- 1D heat (ch. 01-04) -----------------------------------------
        _p("heat_ftcs", "heat", heat1d.HeatConfig(scheme="ftcs"),
           "01_Heat_Equation_FTCS/ftcs.jl", "explicit FTCS, nx=80"),
        _p("heat_rk3", "heat", heat1d.HeatConfig(scheme="rk3"),
           "02_Heat_Equation_RK3/rk3.jl", "SSP-RK3"),
        _p("heat_cn", "heat", heat1d.HeatConfig(scheme="cn"),
           "03_Heat_Equation_CN/cn.jl", "Crank-Nicolson"),
        _p("heat_icp", "heat", heat1d.HeatConfig(scheme="icp"),
           "04_Heat_Equation_ICP/icp.jl", "implicit compact Pade (4th order)"),
        # --- 1D Burgers (ch. 05-08) ----------------------------------------
        _p("burgers_weno_dirichlet", "burgers",
           burgers1d.BurgersConfig(nx=400, solver="weno", bc="dirichlet"),
           "05_Inviscid_Burgers_WENO/weno_dirichlet.jl"),
        _p("burgers_weno_periodic", "burgers",
           burgers1d.BurgersConfig(nx=400, solver="weno", bc="periodic"),
           "05_Inviscid_Burgers_WENO/weno_periodic.jl"),
        _p("burgers_central", "burgers",
           burgers1d.BurgersConfig(nx=400, solver="central", bc="dirichlet"),
           "05_Inviscid_Burgers_WENO/weno_trial.jl",
           "central-difference baseline"),
        _p("burgers_crweno_dirichlet", "burgers",
           burgers1d.BurgersConfig(nx=1600, solver="crweno", bc="dirichlet"),
           "06_Inviscid_Burgers_CRWENO/crweno_dirichlet.jl"),
        _p("burgers_crweno_periodic", "burgers",
           burgers1d.BurgersConfig(nx=1600, solver="crweno", bc="periodic"),
           "06_Inviscid_Burgers_CRWENO/crweno_periodic.jl"),
        _p("burgers_flux_splitting", "burgers",
           burgers1d.BurgersConfig(nx=150, solver="flux_split"),
           "07_Inviscid_Burgers_Flux_Splitting/burgers_flux_splitting.jl"),
        _p("burgers_riemann", "burgers",
           burgers1d.BurgersConfig(nx=200, solver="rusanov"),
           "08_Inviscid_Burgers_Rieman/burgers_riemann.jl"),
        # --- 1D Euler Sod (ch. 09-11) ----------------------------------------
        _p("euler_roe", "euler", euler1d.EulerConfig(nx=256, solver="roe"),
           "09_Euler_1D_Roe/euler_roe.jl"),
        _p("euler_hllc", "euler",
           euler1d.EulerConfig(nx=8192, solver="hllc", dt=5e-5),
           "10_Euler_1D_HLLC/euler_hllc.jl", "high-res 'True' run"),
        _p("euler_rusanov", "euler",
           euler1d.EulerConfig(nx=8192, solver="rusanov", dt=5e-5),
           "11_Euler_1D_Rusanov/euler_rusanov.jl"),
        # --- 2D Poisson (ch. 12-17) ------------------------------------------
        _p("poisson_fft", "poisson",
           poisson2d.PoissonConfig(nx=512, ny=512, solver="fft",
                                   problem="sine32"),
           "12_Poisson_Solver_FFT/fft_p.jl", "FDM eigenvalues"),
        _p("poisson_fft_spectral", "poisson",
           poisson2d.PoissonConfig(nx=512, ny=512, solver="fft_spectral",
                                   problem="sine32"),
           "13_Poisson_Solver_FFT_Spectral/fft_s.jl"),
        _p("poisson_fst", "poisson",
           poisson2d.PoissonConfig(nx=128, ny=128, solver="fst",
                                   problem="sine32"),
           "14_Poisson_Solver_FST/fft_d.jl", "DST-I direct solve"),
        _p("poisson_jacobi", "poisson",
           poisson2d.PoissonConfig(nx=512, ny=512, solver="jacobi",
                                   problem="poly", tol=1e-9,
                                   max_iter=2_000_000, freq=10_000),
           "15_Poisson_Solver_Gauss_Seidel/gauss_seidel.jl",
           "the reference's 'gauss_seidel' is point Jacobi"),
        _p("poisson_gs_redblack", "poisson",
           poisson2d.PoissonConfig(nx=512, ny=512, solver="redblack",
                                   problem="poly", tol=1e-9,
                                   max_iter=2_000_000, freq=10_000),
           "15_... (data-parallel true Gauss-Seidel variant)",
           "red-black GS: data-parallel true GS"),
        _p("poisson_cg", "poisson",
           poisson2d.PoissonConfig(nx=512, ny=512, solver="cg",
                                   problem="poly", tol=1e-9,
                                   # 20 * 100_000, the reference main()'s
                                   # cap (conjugate_gradient.jl)
                                   max_iter=2_000_000, freq=100),
           "16_Poisson_Solver_Conjugate_Gradient/conjugate_gradient.jl"),
        _p("poisson_mg2", "poisson",
           poisson2d.PoissonConfig(nx=256, ny=256, solver="multigrid",
                                   problem="poly",
                                   mg=multigrid.MGConfig(n_levels=2,
                                                         tol=1e-9,
                                                         max_cycles=1000)),
           "17_Poisson_Solver_Multigrid/mg.jl", "2-level V-cycle"),
        _p("poisson_mgcg", "poisson",
           poisson2d.PoissonConfig(nx=512, ny=512, solver="mgcg",
                                   problem="poly", tol=1e-9),
           "16_.../conjugate_gradient.jl + 17_.../mg_N.jl",
           "V-cycle-preconditioned flexible CG (beyond the reference)"),
        _p("poisson_mgN", "poisson",
           poisson2d.PoissonConfig(nx=512, ny=512, solver="multigrid",
                                   problem="poly",
                                   mg=multigrid.MGConfig(n_levels=9,
                                                         tol=1e-9,
                                                         max_cycles=100)),
           "17_Poisson_Solver_Multigrid/mg_N.jl", "9-level V-cycle"),
        # --- 2D Navier-Stokes (ch. 18-22) -------------------------------------
        _p("cavity", "cavity", cavity.CavityConfig(),
           "18_NS2D_Lid_Driven_Cavity/lid_driven_cavity.jl",
           "Re=100, 64^2, t=10"),
        _p("vortex_merger_fdm", "vortex", vortex.VortexConfig(solver="fdm"),
           "19_NS2D_Vortex_Merger/vm.jl", "128^2, Re=1000, t=20"),
        _p("tgv", "vortex",
           vortex.VortexConfig(nx=64, ny=64, solver="fdm", dt=0.01,
                               t_final=1.0, re=10.0, ic="tgv", ns=1),
           "19_NS2D_Vortex_Merger/tgv.jl", "Taylor-Green validation"),
        _p("vortex_merger_hybrid", "vortex",
           vortex.VortexConfig(solver="hybrid"),
           "20_NS2D_Hybrid_Solver/hybrid.jl", "semi-implicit RK3/CN"),
        _p("vortex_merger_ps32", "vortex", vortex.VortexConfig(solver="ps32"),
           "21_NS2D_PseudoSpectral_32_Rule/pseudospectral_32_rule.jl"),
        _p("vortex_merger_ps23", "vortex", vortex.VortexConfig(solver="ps23"),
           "22_NS2D_PseudoSpectral_23_Rule/pseudospectral_23_rule.jl"),
    ]
}


def get(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {', '.join(sorted(PRESETS))}"
        )
    return PRESETS[name]


def with_overrides(preset: Preset, **overrides) -> Preset:
    """Replace config fields (CLI --key value overrides)."""
    if not overrides:
        return preset
    cfg = dataclasses.replace(preset.cfg, **overrides)
    return dataclasses.replace(preset, cfg=cfg)
