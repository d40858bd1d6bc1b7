"""Smoke run of the engine's main path on one GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the mesh paths only

Runs the solvers through their normal entry points at the sizes of the
fp64 anchors in benchmarks/physics_anchors.json (the configurations of
benchmarks/gen_physics_anchors.py), in ONE process:

  tiers      each core.precision tier compiles (fp32 and complex64), and
             its cavity 1024^2 trajectory deviation from the fp64 anchor
  cavity     cavity.solve 100 steps + make_step_fn 2000 steps at 1024^2;
             fst_half against fst
  vortex     vortex.solve ps23 and the fdm / hybrid / ps32 steps at 2048^2
  euler      hllc / rusanov at 8192 and roe at 256, 2000 steps
  crweno     CRWENO Burgers at 1600, 2000 steps
  multigrid  poisson2d.solve multigrid 4096^2 to rms/rms0 <= 1e-5 with the
             residual re-derived outside the solver; the red-black
             smoother three ways (XLA sweep, ops.rb_kernel, Chebyshev)
             per sweep and inside a full solve
  validate   `python -m cfd_julia_tpu validate`, in process

Each phase prints one JSON line: compile seconds, steady steps/s (or
s/solve) timed with block_until_ready, the compiled program's memory
(compiled.memory_analysis()) and the device's peak_bytes_in_use, and
every anchor comparison beside its tolerance and the tolerance's reason.
The card's `name, power.limit` line comes from nvidia-smi in a child
process that never imports JAX.  The script exits non-zero when JAX finds
no GPU, when a phase fails, or when a comparison breaks its tolerance.
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ANCHORS = os.path.join(ROOT, "benchmarks", "physics_anchors.json")

# Tolerances on the relative deviation of a scalar trajectory metric from
# its fp64 anchor, with their reasons.
TOL_FP32_CAVITY = (1e-3, "fp32 path: 2.5x the 4e-4 rel L-inf psi bound of "
                   "the CPU fp32-vs-fp64 study at 1024^2 (BASELINE.md); "
                   "cuFFT sums in another order")
TOL_FP32_SPECTRAL = (1e-4, "fp32 spectral path: the CPU study bounds omega "
                     "at 1.5e-6 rel (ps23 2048^2); enstrophy sums 4M "
                     "squares in fp32")
TOL_FP32_1D = (1e-4, "fp32 1D path: 2000 steps of WENO/Riemann updates, "
               "the metric is a min / rms of O(1) values")
TOL_BF16X3 = (1e-3, "3-pass bf16 products carry ~fp32 accuracy: same "
              "bound as the fp32 cavity path")
TOL_BF16X1 = (1e-2, "1-pass bf16 products (~4e-3 per product): held only "
              "to the 1% physics gate of the bench anchors")
TOL_MG = (4.0, "independent residual rms/rms0 <= 4x the 1e-5 solve "
          "tolerance (fp32 summation order; same check as bench.py)")

# grid sizes: the anchored sizes, and a tiny set for the CPU rehearsal
FULL = dict(cavity=1024, cavity_steps=(100, 2000), vortex=2048,
            vortex_steps=200, euler=8192, euler_roe=256, euler_steps=2000,
            crweno=1600, crweno_steps=2000, mg=4096, mg_tol=1e-5,
            sweeps=20, reps=7, chunk=100)
TINY = dict(cavity=64, cavity_steps=(40, 80), vortex=64, vortex_steps=20,
            euler=64, euler_roe=32, euler_steps=20, crweno=50,
            crweno_steps=20, mg=64, mg_tol=1e-5, sweeps=2, reps=1, chunk=20)


def card_line() -> str:
    """`name, power.limit` from nvidia-smi, read by a child process that
    never imports JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return r.stdout.strip() if r.returncode == 0 else \
        f"nvidia-smi rc={r.returncode}"


class PhaseFailure(AssertionError):
    pass


def _anchor(key):
    with open(ANCHORS) as fh:
        return json.load(fh).get(key)


def compare(key, metrics, tol):
    """Relative deviation of each anchored metric; raises PhaseFailure
    when the largest breaks `tol` = (bound, reason).  An unanchored key
    (the CPU rehearsal's tiny sizes) checks finiteness only."""
    import math

    bound, reason = tol
    a = _anchor(key)
    if not a:
        if not all(math.isfinite(v) for v in metrics.values()):
            raise PhaseFailure(f"{key}: non-finite {metrics}")
        return {"anchor": key, "metrics": metrics, "max_rel_dev": None}
    devs = {k: abs(metrics[k] - a[k]) / max(abs(a[k]), 1e-30)
            for k in a if k not in ("rel_tol", "note")}
    worst = max(devs.values(), key=lambda d: (d != d, d))  # NaN first
    out = {"anchor": key, "metrics": metrics, "rel_dev": devs,
           "max_rel_dev": worst, "tol": bound, "tol_reason": reason}
    if not worst <= bound:      # NaN fails too
        raise PhaseFailure(f"{key}: max rel dev {worst:.3e} > {bound:g} "
                           f"({metrics} vs {a})")
    return out


def _program_bytes(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return None
    return int(m.argument_size_in_bytes + m.output_size_in_bytes
               + m.temp_size_in_bytes - m.alias_size_in_bytes)


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_window(step, state, steps, chunk):
    """AOT-compile `steps` applications of step (chunked scan under a
    traced trip count), run them once from `state`, then time one more
    window of the same length.  Returns (state after `steps`, record)."""
    import jax
    import jax.numpy as jnp

    from cfd_julia_tpu.stepping import loop

    assert steps % chunk == 0, (steps, chunk)
    k = jnp.asarray(steps // chunk, jnp.int32)
    fn = jax.jit(lambda s, kk: loop.run_steps_dynamic(step, s, kk, chunk))
    t0 = time.perf_counter()
    compiled = fn.lower(state, k).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(state, k))
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(out, k))
    dt = time.perf_counter() - t0
    return out, {"compile_s": compile_s, "steps": steps,
                 "steps_per_s": steps / dt,
                 "program_bytes": _program_bytes(compiled)}


# ----------------------------------------------------------------- phases

def phase_tiers(sz):
    """Each tier's preset compiles for fp32 and complex64 operands, and
    the cavity trajectory at each tier against the fp64 anchor."""
    import jax.numpy as jnp

    from cfd_julia_tpu.core import precision
    from cfd_julia_tpu.models import cavity

    rec = {"compile_check": {}}
    for tier in precision.TIERS:
        rec["compile_check"][tier] = {
            dt.__name__: precision.check_tier(tier, dt)
            for dt in (jnp.float32, jnp.complex64)}
    n, steps = sz["cavity"], sz["cavity_steps"][0]
    for poisson, tol in (("matmul", TOL_FP32_CAVITY),
                         ("matmul_bf16x3", TOL_BF16X3),
                         ("matmul_bf16x1", TOL_BF16X1)):
        cfg = cavity.CavityConfig(nx=n, ny=n, dt=2e-5, poisson=poisson)
        state, r = run_window(cavity.make_step_fn(cfg), _cavity0(n), steps,
                              sz["chunk"])
        r.update(compare(f"cavity:{n}:{steps}", _psi_metrics(state[1]), tol))
        rec[poisson] = r
    return rec


def _cavity0(n):
    import jax.numpy as jnp

    w0 = jnp.zeros((n + 1, n + 1), jnp.float32)
    return (w0, jnp.zeros_like(w0), jnp.zeros((), jnp.float32))


def _psi_metrics(psi):
    import jax.numpy as jnp

    return {"psi_min": float(psi.min()),
            "psi_l2": float(jnp.sqrt((psi ** 2).mean()))}


def phase_cavity(sz):
    import jax.numpy as jnp
    import numpy as np

    from cfd_julia_tpu.models import cavity

    n = sz["cavity"]
    s1, s2 = sz["cavity_steps"]
    rec = {}
    # the user entry point: cavity.solve (auto Poisson from policy.py)
    cfg = cavity.CavityConfig(nx=n, ny=n, dt=2e-5, t_final=s1 * 2e-5)
    t0 = time.perf_counter()
    res = cavity.solve(cfg, jnp.float32)
    res.s.block_until_ready()
    rec["solve"] = {"wall_s_incl_compile": time.perf_counter() - t0,
                    **compare(f"cavity:{n}:{s1}", _psi_metrics(res.s),
                              TOL_FP32_CAVITY)}
    # make_step_fn, long trajectory + steady rate
    step = cavity.make_step_fn(cavity.CavityConfig(nx=n, ny=n, dt=2e-5))
    state, r = run_window(step, _cavity0(n), s2, sz["chunk"])
    r.update(compare(f"cavity:{n}:{s2}", _psi_metrics(state[1]),
                     TOL_FP32_CAVITY))
    rec["fst"] = r
    # fst_half with the XLA RHS against fst, same steps
    half = cavity.make_step_fn(cavity.CavityConfig(nx=n, ny=n, dt=2e-5,
                                                   poisson="fst_half"))
    hstate, r = run_window(half, _cavity0(n), s2, sz["chunk"])
    a, b = np.asarray(hstate[1]), np.asarray(state[1])
    dev = float(np.abs(a - b).max() / np.abs(b).max())
    bound, reason = TOL_FP32_CAVITY
    r.update(rel_linf_vs_fst=dev, tol=bound,
             tol_reason="same DST-I eigenvalues, other transform: " + reason)
    if not dev <= bound:
        raise PhaseFailure(f"fst_half vs fst rel L-inf {dev:.3e} > {bound}")
    rec["fst_half"] = r
    return rec


def _w_metrics(w):
    import jax.numpy as jnp

    w = w.astype(jnp.float32)
    return {"wmax": float(jnp.abs(w).max()),
            "enstrophy": float((w ** 2).sum())}


def phase_vortex(sz):
    import jax
    import jax.numpy as jnp

    from cfd_julia_tpu.models import vortex
    from cfd_julia_tpu.stepping import ssprk3

    n, steps = sz["vortex"], sz["vortex_steps"]
    rec = {}
    # the user entry point: vortex.solve, ps23
    cfg = vortex.VortexConfig(nx=n, ny=n, solver="ps23", dt=1e-3,
                              t_final=steps * 1e-3, ns=1)
    t0 = time.perf_counter()
    res = vortex.solve(cfg, jnp.float32)
    res.w.block_until_ready()
    rec["ps23_solve"] = {"wall_s_incl_compile": time.perf_counter() - t0,
                         **compare(f"ps23:{n}:{steps}", _w_metrics(res.w),
                                   TOL_FP32_SPECTRAL)}
    for solver in ("ps23", "fdm", "hybrid", "ps32"):
        cfg = vortex.VortexConfig(nx=n, ny=n, solver=solver, dt=1e-3)
        w0 = vortex.initial_vorticity(cfg, jnp.float32)
        if solver == "fdm":
            rhs = lambda w, c=cfg: vortex.fdm_rhs(w, c.dx, c.dy, c.re)
            step = lambda w, c=cfg, r=rhs: ssprk3.ssprk3_step(r, w, c.dt)
            w, r = run_window(step, w0, steps, sz["chunk"] // 5)
        else:
            step = vortex.make_spectral_step_half_packed(cfg, jnp.float32)
            h0 = jax.jit(vortex.half_init_packed)(w0)
            h, r = run_window(step, h0, steps, sz["chunk"] // 5)
            w = jax.jit(lambda hh, c=cfg: vortex.half_decode_packed(
                hh, c.ny, jnp.float32))(h)
        r.update(compare(f"{solver}:{n}:{steps}", _w_metrics(w),
                         TOL_FP32_SPECTRAL))
        rec[solver] = r
    return rec


def phase_euler(sz):
    import jax.numpy as jnp

    from cfd_julia_tpu.models import euler1d
    from cfd_julia_tpu.stepping import ssprk3

    rec = {}
    steps = sz["euler_steps"]
    for solver, n in (("hllc", sz["euler"]), ("rusanov", sz["euler"]),
                      ("roe", sz["euler_roe"])):
        cfg = euler1d.EulerConfig(nx=n, solver=solver, dt=1e-4 * 256 / n)
        _, q0 = euler1d.sod_initial_state(cfg, jnp.float32)
        rhs = euler1d.make_rhs(cfg)
        step = lambda q, r=rhs, c=cfg: ssprk3.ssprk3_step(r, q, c.dt)
        q, r = run_window(step, q0, steps, sz["chunk"])
        m = {"rho_min": float(q[0].min()),
             "rho_l2": float(jnp.sqrt((q[0] ** 2).mean()))}
        r.update(compare(f"euler_{solver}:{n}:{steps}", m, TOL_FP32_1D))
        rec[f"{solver}_{n}"] = r
    return rec


def phase_crweno(sz):
    import jax.numpy as jnp

    from cfd_julia_tpu.models import burgers1d
    from cfd_julia_tpu.stepping import ssprk3

    n, steps = sz["crweno"], sz["crweno_steps"]
    cfg = burgers1d.BurgersConfig(nx=n, solver="crweno", bc="periodic",
                                  dt=1e-4 * 200 / n)
    rhs = burgers1d.make_rhs(cfg)
    u0 = jnp.sin(2.0 * jnp.pi * burgers1d.grid_coords(cfg, jnp.float32))
    step = lambda u: ssprk3.ssprk3_step(rhs, u, cfg.dt)
    u, r = run_window(step, u0, steps, sz["chunk"])
    m = {"u_max": float(jnp.abs(u).max()),
         "u_l2": float(jnp.sqrt((u ** 2).mean()))}
    r.update(compare(f"crweno:{n}:{steps}", m, TOL_FP32_1D))
    return {f"crweno_{n}": r}


def _independent_rel_residual(f, u, u0, dx, dy):
    """rms of f - lap(u) over the interior, relative to that of u0, with
    plain slicing (not the solver's residual path)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def rms(ff, v):
        lap = ((v[2:, 1:-1] - 2 * v[1:-1, 1:-1] + v[:-2, 1:-1]) / dx**2
               + (v[1:-1, 2:] - 2 * v[1:-1, 1:-1] + v[1:-1, :-2]) / dy**2)
        return jnp.sqrt(((ff[1:-1, 1:-1] - lap) ** 2).mean())

    return float(rms(f, u)) / max(float(rms(f, u0)), 1e-30)


def phase_multigrid(sz):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cfd_julia_tpu.models import poisson2d
    from cfd_julia_tpu.ops import rb_kernel
    from cfd_julia_tpu.poisson import iterative, multigrid

    n, tol = sz["mg"], sz["mg_tol"]
    on_gpu = jax.devices()[0].platform == "gpu"
    rec = {}
    # the user entry point
    cfg = poisson2d.PoissonConfig(
        nx=n, ny=n, solver="multigrid", problem="poly",
        mg=multigrid.MGConfig(tol=tol, max_cycles=20))
    t0 = time.perf_counter()
    res = poisson2d.solve(cfg, jnp.float32)
    res.u.block_until_ready()
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, jnp.float32)
    u0 = poisson2d._dirichlet_init(ue)
    rel = _independent_rel_residual(f, res.u, u0, cfg.dx, cfg.dy)
    bound = TOL_MG[0] * tol
    rec["poisson2d_solve"] = {
        "wall_s_incl_compile": time.perf_counter() - t0,
        "cycles": int(res.iterations), "solver_rel": float(res.rms / res.rms0),
        "independent_rel": rel, "tol": bound, "tol_reason": TOL_MG[1]}
    if not rel <= bound:
        raise PhaseFailure(f"mg {n}^2 independent residual {rel:.3e}")

    # the red-black smoother three ways, per sweep
    dx = dy = 1.0 / n
    masks = iterative.color_masks(n, n, jnp.float32)
    imask = iterative.interior_mask(n, n, jnp.float32)
    rng = np.random.default_rng(0)
    ur = jnp.asarray(rng.standard_normal((n + 1, n + 1)), jnp.float32)
    k = sz["sweeps"]
    # fields enter as arguments: a closed-over array would be embedded in
    # the program as a constant
    forms = {"xla": lambda u, ff, m: multigrid.smooth(u, ff, dx, dy, k,
                                                      m[:2], "xla"),
             "cheb": lambda u, ff, m: iterative.chebyshev_smooth(
                 u, ff, dx, dy, k, m[2])}
    if on_gpu:
        forms["triton"] = lambda u, ff, m: rb_kernel.redblack_sweeps(
            u, ff, dx, dy, k)
        one = jax.jit(lambda u, ff: rb_kernel.redblack_sweep(
            u, ff, dx, dy))(ur, f)
        ref = jax.jit(lambda u, ff, mr, mb: iterative.redblack_sweep(
            u, ff, dx, dy, mr, mb))(ur, f, *masks)
        dev = float(jnp.abs(one - ref).max() / jnp.abs(ref).max())
        rec["rb_kernel_vs_xla_one_sweep"] = {
            "rel_linf": dev, "tol": 1e-6,
            "tol_reason": "same fp32 arithmetic, other operation order"}
        if not dev <= 1e-6:
            raise PhaseFailure(f"rb kernel vs XLA sweep rel {dev:.3e}")
    def race(calls):
        """Median, min and max of `reps` timed calls of each form, the
        forms taken round-robin so drift hits them alike."""
        times = {name: [] for name in calls}
        for _ in range(sz["reps"]):
            for name, call in calls.items():
                t0 = time.perf_counter()
                jax.block_until_ready(call())
                times[name].append(time.perf_counter() - t0)
        return {name: (float(np.median(t)), min(t), max(t))
                for name, t in times.items()}

    m = (*masks, imask)
    calls = {}
    for name, fn in forms.items():
        c = jax.jit(fn).lower(ur, f, m).compile()
        jax.block_until_ready(c(ur, f, m))
        calls[name] = lambda c=c: c(ur, f, m)
    rec["smoother_per_sweep"] = {
        name: {"ms_per_sweep": 1e3 * med / k, "min_ms": 1e3 * lo / k,
               "max_ms": 1e3 * hi / k}
        for name, (med, lo, hi) in race(calls).items()}

    # ... and inside a full solve to tol (a perturbed right-hand side, so
    # no timed call repeats the warm-up's inputs)
    f2 = f * (1.0 + 1e-6)
    calls, solves = {}, {}
    for name in forms:
        mgc = multigrid.MGConfig(tol=tol, max_cycles=20, smoother=name)
        solve = multigrid.solve.lower(f, u0, dx, dy, cfg=mgc).compile()
        jax.block_until_ready(solve(f, u0).u)
        r = solve(f2, u0)
        rel = _independent_rel_residual(f2, r.u, u0, dx, dy)
        if not rel <= bound:
            raise PhaseFailure(f"mg smoother={name}: residual {rel:.3e}")
        solves[name] = {"cycles": int(r.iterations), "independent_rel": rel,
                        "tol": bound}
        calls[name] = lambda s=solve: s(f2, u0).u
    for name, (med, lo, hi) in race(calls).items():
        solves[name].update(s_per_solve=med, min_s=lo, max_s=hi)
    rec["solve_to_tol"] = solves
    return rec


def phase_validate(sz):
    import contextlib
    import io

    from cfd_julia_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["validate"])
    lines = buf.getvalue().strip().splitlines()
    if rc != 0:
        raise PhaseFailure("validate failed:\n" + "\n".join(lines))
    return {"checks": lines}


PHASES = {"tiers": phase_tiers, "cavity": phase_cavity,
          "vortex": phase_vortex, "euler": phase_euler,
          "crweno": phase_crweno, "multigrid": phase_multigrid,
          "validate": phase_validate}


# ------------------------------------------------------------- four cards

def four_card_phases(sz4):
    """Mesh paths on a 2x2 mesh, each against the same computation on
    one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cfd_julia_tpu.models import cavity, poisson2d, vortex
    from cfd_julia_tpu.parallel import halo, mesh as mesh_lib, sharded
    from cfd_julia_tpu.poisson import multigrid
    from cfd_julia_tpu.stepping import loop

    devs = jax.devices()
    mesh = mesh_lib.make_mesh(devs[:4])
    one = devs[0]
    out = {}

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise PhaseFailure("non-finite field (four cards: "
                               f"{np.isfinite(a).all()}, one card: "
                               f"{np.isfinite(b).all()} finite)")
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    failures = []

    def check(name, dev, bound, reason, **extra):
        """Print the comparison; a broken bound fails the run once every
        path has printed its line."""
        out[name] = {"rel_linf_vs_one_card": dev, "tol": bound,
                     "tol_reason": reason, **extra}
        print(json.dumps({"phase": name, **out[name]}), flush=True)
        if not dev <= bound:
            failures.append(f"{name}: {dev:.3e} > {bound}")

    def timed(fn, *args):
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(*args))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(*args))
        return r, first, time.perf_counter() - t0

    n, steps = sz4["cavity"], sz4["cavity_steps"]
    fp32 = ("fp32, sharded transforms and halo collectives reorder sums "
            "against one card")
    # the cavity's wall vorticity amplifies fp32 rounding ~1/h^2: any two
    # fp32 summation orders differ on the scale of fp32 vs fp64
    cav_bound, cav_reason = TOL_FP32_CAVITY
    cav_reason = ("sharded contractions reorder fp32 sums; " + cav_reason)
    # pencil-fst cavity step
    # the anchored 1024^2 dt, cut with dx^2 above 1024^2: nu dt / dx^2
    # stays at its 0.21 (the explicit diffusion limit)
    cfg = cavity.CavityConfig(nx=n, ny=n, dt=2e-5 * min(1.0, (1024 / n) ** 2))
    st = _cavity0(n)
    run4 = jax.jit(lambda s: loop.run_steps(
        cavity.make_step_fn(cfg, mesh=mesh), s, steps))
    run1 = jax.jit(lambda s: loop.run_steps(cavity.make_step_fn(cfg), s,
                                            steps))
    s4, _, t4 = timed(run4, st)
    s1, _, t1 = timed(run1, jax.device_put(st, one))
    check("cavity_fst_mesh", rel(s4[1], s1[1]), cav_bound, cav_reason,
          steps_per_s_4=steps / t4, steps_per_s_1=steps / t1)
    # padded sharded step (dense-matmul DST)
    pstep = sharded.make_sharded_cavity_step(cfg, mesh)
    w0 = sharded.pad_to_mesh(jnp.zeros((n + 1, n + 1), jnp.float32), mesh)
    pst = (sharded.place(w0, mesh), sharded.place(jnp.zeros_like(w0), mesh),
           jnp.zeros((), jnp.float32))
    prun4 = jax.jit(lambda s: loop.run_steps(pstep, s, steps))
    ps1 = cavity.make_padded_step_fn(cfg, w0.shape)
    prun1 = jax.jit(lambda s: loop.run_steps(ps1, s, steps))
    p4, _, t4 = timed(prun4, pst)
    p1, _, t1 = timed(prun1, jax.device_put(
        (w0, jnp.zeros_like(w0), jnp.zeros((), jnp.float32)), one))
    check("cavity_padded_sharded", rel(p4[1], p1[1]), cav_bound, cav_reason,
          steps_per_s_4=steps / t4, steps_per_s_1=steps / t1)

    # sharded half-spectrum ps23 step
    nv, vsteps = sz4["vortex"], sz4["vortex_steps"]
    vcfg = vortex.VortexConfig(nx=nv, ny=nv, solver="ps23", dt=1e-3)
    w0v = vortex.initial_vorticity(vcfg, jnp.float32)
    h0 = jax.jit(vortex.half_init_packed)(w0v)
    vstep4 = sharded.make_sharded_vortex_step_half(vcfg, mesh, jnp.float32)
    vrun4 = jax.jit(lambda h: loop.run_steps(vstep4, h, vsteps))
    vstep1 = vortex.make_spectral_step_half_packed(vcfg, jnp.float32)
    vrun1 = jax.jit(lambda h: loop.run_steps(vstep1, h, vsteps))
    h4, _, t4 = timed(vrun4, jax.device_put(
        h0, sharded.packed_half_sharding(mesh)))
    h1, _, t1 = timed(vrun1, jax.device_put(h0, one))
    check("ps23_half_sharded", rel(h4, h1), 1e-4, fp32,
          steps_per_s_4=vsteps / t4, steps_per_s_1=vsteps / t1)

    # ppermute halo RHS
    rhs4 = jax.jit(halo.make_distributed_vorticity_rhs(
        mesh, vcfg.dx, vcfg.dy, vcfg.re))
    from cfd_julia_tpu.ops import arakawa
    s_field = jnp.roll(w0v, 3, axis=1)
    r4 = rhs4(sharded.place(w0v, mesh), sharded.place(s_field, mesh))
    r1 = jax.jit(lambda w, s: arakawa.vorticity_rhs(
        w, s, vcfg.dx, vcfg.dy, vcfg.re))(jax.device_put(w0v, one),
                                          jax.device_put(s_field, one))
    check("halo_rhs", rel(r4, r1), 1e-5,
          "same fp32 stencil arithmetic; only the halo source differs")

    # mesh multigrid to tol
    nm, tol = sz4["mg"], sz4["mg_tol"]
    mgc = multigrid.MGConfig(tol=tol, max_cycles=30, transfers="matmul",
                             smoother="cheb")
    pcfg = poisson2d.PoissonConfig(nx=nm, ny=nm, solver="multigrid",
                                   problem="poly", mg=mgc)
    _, _, _, _, ue, f = poisson2d.build_problem(pcfg, jnp.float32)
    u0 = poisson2d._dirichlet_init(ue)
    solve4 = jax.jit(lambda ff, uu: multigrid.solve(
        ff, uu, pcfg.dx, pcfg.dy, cfg=mgc, mesh=mesh))
    solve1 = jax.jit(lambda ff, uu: multigrid.solve(
        ff, uu, pcfg.dx, pcfg.dy, cfg=mgc))
    m4, _, t4 = timed(solve4, f, u0)
    m1, _, t1 = timed(solve1, jax.device_put(f, one),
                      jax.device_put(u0, one))
    res4 = _independent_rel_residual(f, m4.u, u0, pcfg.dx, pcfg.dy)
    res1 = _independent_rel_residual(jax.device_put(f, one), m1.u,
                                     jax.device_put(u0, one),
                                     pcfg.dx, pcfg.dy)
    bound = TOL_MG[0] * tol
    check("mg_mesh", rel(m4.u, m1.u), 1e-3,
          "both solves stop at rms/rms0 <= tol, not at the exact discrete "
          "solution; their iterates agree to ~tol times the field scale",
          cycles_4=int(m4.iterations), cycles_1=int(m1.iterations),
          independent_rel_4=res4, independent_rel_1=res1, residual_tol=bound,
          s_per_solve_4=t4, s_per_solve_1=t1)
    if not (res4 <= bound and res1 <= bound):
        failures.append(f"mg_mesh residuals {res4:.3e} / {res1:.3e}")
    if failures:
        raise PhaseFailure("; ".join(failures))
    return out


FOUR = dict(cavity=2048, cavity_steps=100, vortex=4096, vortex_steps=20,
            mg=8192, mg_tol=1e-5)
FOUR_TINY = dict(cavity=64, cavity_steps=4, vortex=64, vortex_steps=4,
                 mg=64, mg_tol=1e-5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="four cards: the mesh paths and their one-card "
                         "comparisons, no other phase")
    args = ap.parse_args(argv)

    print(f"# card: {card_line()}", flush=True)
    sys.path.insert(0, ROOT)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    from cfd_julia_tpu.jaxconfig import configure_cache

    configure_cache()
    print(json.dumps({"device": devices[0].device_kind,
                      "count": len(devices), "jax": jax.__version__,
                      "xla_flags": os.environ.get("XLA_FLAGS", "")}),
          flush=True)

    if args.four:
        four_card_phases(FOUR)
    else:
        for name in PHASES:
            t0 = time.perf_counter()
            rec = PHASES[name](FULL)
            print(json.dumps({"phase": name, "ok": True,
                              "wall_s": time.perf_counter() - t0,
                              "peak_bytes_in_use": peak_bytes(), **rec}),
                  flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
