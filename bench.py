"""Headline benchmark: lid-driven cavity steps/sec at 1024^2 (fp32, one GPU).

Prints JSON lines; the last stdout line is the complete record:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}
with the device it ran on (platform, device_kind, device count, the
nvidia-smi name and power limit, XLA_FLAGS).  A run that finds no GPU, or
whose every cavity variant fails, prints an error record and exits 1.

Methodology: the whole measured window is ONE jit call — a 50-step
`lax.scan` chunk inside a traced-count `fori_loop` (zero host
round-trips per step, the framework's real execution mode; quick and
full tiers share the compiled program, see loop.run_steps_dynamic); a
scalar host pull after the scan ends the window. dt is set diffusively
stable for 1024^2 at Re=100 (nu dt/dx^2 <= 0.2 -> dt = 2e-5) and the
result is checked against the fp64 physics anchors.

Process model: every (family, variant) pair runs in its OWN subprocess
(`--worker` mode), one after another, while this orchestrating process
never touches a device.  A JAX process reserves most of the card's
memory when it first uses it, so exactly one process holds the card at
any time; a variant that fails, hangs or runs out of memory costs only
that variant.  Workers share the persistent compile cache
(jaxconfig.configure_cache).

vs_baseline: the reference publishes no numbers and Julia is not in this
image, so the denominator is a MEASUREMENT of the actual cavity
algorithm with its stencil/BC/stage loops COMPILED — single-thread C at
-O3 (benchmarks/reference_cavity_c.py + native/ref_kernels.c, verified
equal to the NumPy port and hence the JAX model to 1e-13) — plus
scipy-pocketfft DST-I: 5.43 steps/s at 1024^2 on one CPU core (0.140 s
DST + 0.044 s C stencils per step).  The only remaining grant is FFTW
1.5-2.5x over pocketfft on the DST share, giving Julia 7.3-10.0
steps/s; the divisor is 10.0 — the most generous end — so vs_baseline
is a lower bound (history in BASELINE.md).

Secondary metrics: ps23 2048^2 steps/s, multigrid 4096^2 solve-to-tol
wall-clock, and one anchored coverage row per remaining family.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# measured-anchored Julia estimates: upper bounds of the ranges derived
# from the direct algorithm measurements (docstring + BASELINE.md):
# cavity 1024^2 measured 5.43 C-proxy steps/s -> Julia 7.3-10.0;
# ps23 2048^2 measured 0.208 C-proxy steps/s (reference_ps23_c.py:
# 4.455 s/step pocketfft complex transforms + 0.344 s compiled C
# elementwise) -> Julia 0.302-0.47 with the 1.5-2.5x FFTW grant on the
# transform share only; divisor = 0.47, the most generous end.
JULIA_BASELINE_STEPS_PER_SEC = 10.0
PS23_BASELINE_STEPS_PER_SEC = 0.47
# mg 4096^2 to rms/rms0<=1e-5: the V-cycle is pure compiled stencil
# loops (no FFT), so the C implementation IS the Julia denominator —
# measured 3.68 s / 5 cycles (benchmarks/reference_mg_c.py).
MG_BASELINE_SOLVE_S = 3.68
HEADLINE_METRIC = "cavity_1024_steps_per_sec"
# physics acceptance anchors (benchmarks/gen_physics_anchors.py): fp64
# trajectory metrics at the exact (family, nx, total_steps) points the
# workers produce.  CFD_BENCH_ANCHORS overrides for tests.
ANCHORS_JSON = os.environ.get(
    "CFD_BENCH_ANCHORS",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "benchmarks", "physics_anchors.json"))


def _check_anchor(family: str, nx: int, total_steps: int, metrics: dict):
    """Physics acceptance gate: compare the measured trajectory's
    physical metrics against the committed fp64 anchor.

    A fast-but-wrong variant (bad BC assembly, index shift, broken
    transform) must not post a number.  Legitimate variants sit orders
    below the gate: fp32-vs-fp64 field deltas are ~4e-4 (BASELINE.md fp32
    study) vs the 1% default tolerance; real corruption shifts psi_min /
    enstrophy by tens of percent.

    Returns "ok" or "no-anchor" (unknown grid/steps combination — e.g.
    a --nx/--steps debug override); raises AssertionError on violation
    so the worker subprocess dies and the race skips the variant."""
    try:
        with open(ANCHORS_JSON) as fh:
            anchors = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return "no-anchor"
    a = anchors.get(f"{family}:{nx}:{total_steps}")
    if not a:
        return "no-anchor"
    tol = a.get("rel_tol", 0.01)
    for key, ref in a.items():
        if key in ("rel_tol", "note"):
            continue
        got = metrics.get(key)
        if got is None:
            # an anchor key the worker did not measure (typo'd or
            # hand-edited anchors file) must reject loudly, not die as
            # an opaque KeyError in the subprocess
            raise AssertionError(
                f"PHYSICS REJECT {family} {nx}^2 @{total_steps} steps: "
                f"anchor metric {key!r} was not measured by the worker")
        rel = abs(got - ref) / max(abs(ref), 1e-30)
        if not rel <= tol:  # NaN compares false -> rejected
            raise AssertionError(
                f"PHYSICS REJECT {family} {nx}^2 @{total_steps} steps: "
                f"{key}={got!r} vs anchor {ref!r} "
                f"(rel {rel:.3e} > tol {tol:g})")
    return "ok"


def _emit(value, vs_baseline, metric=HEADLINE_METRIC, **extra):
    print(json.dumps({
        "metric": metric,
        "value": value,
        "unit": "steps/s",
        "vs_baseline": vs_baseline,
        **extra,
    }), flush=True)


_PROBE = """
import json, os, jax
p = os.environ.get("JAX_PLATFORMS")
if p:
    jax.config.update("jax_platforms", p)
d = jax.devices()
print(json.dumps({"platform": d[0].platform, "device_kind": d[0].device_kind,
                  "device_count": len(d)}))
"""


def _probe_devices(timeout_s: int = 300) -> dict | None:
    """The device JAX finds, probed ONCE in a subprocess so that this
    orchestrating process never holds the card; None when the probe
    fails."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE],
                           capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        print(f"# device probe timed out ({timeout_s}s)", file=sys.stderr)
        return None
    if r.returncode != 0:
        print(f"# device probe rc={r.returncode}: {r.stderr.strip()[-300:]}",
              file=sys.stderr)
        return None
    return json.loads(r.stdout.strip().splitlines()[-1])


def _nvidia_smi() -> str | None:
    """`name, power.limit` of the card, as nvidia-smi reports it."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def _timed_scan(step, state, steps: int, sync, chunk: int = 50,
                repeats: int = 3):
    """Time `steps` of `step` on device; return (steps/s, state@2*steps).

    The rate is the BEST of `repeats` timed windows.  Every window's
    input is the previous window's output.

    The returned state is the state after the FIRST timed window (i.e.
    after exactly 2*steps total), because physics anchors are keyed at
    (family, nx, 2*steps) — later windows only contribute timing.
    """
    import jax
    import jax.numpy as jnp
    from cfd_julia_tpu.stepping import loop

    if steps % chunk == 0:
        # chunked window with a TRACED outer trip count: the quick tier
        # (50-step windows) and the full tier (1000) hash to the same
        # program, so one compile serves both (identical trajectory;
        # loop.run_steps_dynamic docstring)
        k = jnp.asarray(steps // chunk, jnp.int32)
        run = lambda s: loop.run_steps_dynamic(step, s, k, chunk)
    else:
        run = jax.jit(lambda s: loop.run_steps(step, s, steps))
    state = run(state)          # compile + warm up
    sync(state)
    best = float("inf")
    anchor_state = None
    for r in range(max(1, repeats)):
        t0 = time.perf_counter()
        state = run(state)      # warm output as input
        sync(state)
        best = min(best, time.perf_counter() - t0)
        if r == 0:
            anchor_state = state
    return steps / best, anchor_state


# (poisson, fft_precision).  bf16x1 = single-pass bf16 transforms,
# bf16x3 = 3-pass bf16 (core.precision tiers); the fused variants are the
# interior-padded formulation (models/cavity_fused.py; trajectory-
# equality pinned by tests/test_cavity_fused.py).  Not yet raced on the
# GPU: the order is the listing order, not a measured ranking.
CAVITY_VARIANTS = (
    ("fused_bf16x1", "highest"),
    ("fused_bf16x3", "highest"),
    ("fused", "highest"),
    ("matmul_bf16x1", "highest"),
    ("matmul_bf16x3", "highest"),
    ("fst", "highest"),
    ("matmul", "highest"),
    ("fst_mxu", "highest"),
)

# (fft_impl, fft_precision, pair_impl)
PS_VARIANTS = (
    ("matmul", "high", "pack"),
    ("matmul", "default", "pack"),
    ("matmul", "high", "rowsfirst"),
    ("xla", "highest", "rowsfirst"), ("xla", "highest", "pack"),
    ("matmul", "highest", "pack"),
)

# (transfers, fmg[, smoother[, cycle_dtype]]).  Not raced: the bf16
# iterative-refinement cycle (MGConfig.cycle_dtype="bf16"), which stalls
# at 4096^2 (PERF.md).
MG_VARIANTS = (
    ("matmul", "plain"), ("matmul", "fmg"),
    ("matmul", "plain", "cheb"),
    ("conv", "plain"),
)


def _variant_name(worker, impl, prec, third=None):
    name = impl if prec == "highest" else f"{impl}:{prec}"
    if worker == "ps23" and third != "pack":
        name += f"+{third}"
    return name


def _precision_tier(cavity_impl: str) -> str:
    """Precision tier of a cavity Poisson variant (core.precision), for
    headline JSON tagging: the advertised record and the shipped auto
    default can be different tiers, and the consumer must tell them
    apart."""
    impl = cavity_impl.split("+")[0].split(":")[0]
    if impl.endswith("_bf16x1"):
        return "bf16-1pass"
    if impl.endswith("_bf16x3"):
        return "bf16-3pass"
    return "fp32"


def worker_cavity(variant: str, nx: int, steps: int):
    """Measure ONE cavity variant; return (steps/s, physics metrics)."""
    import jax.numpy as jnp
    from cfd_julia_tpu.models import cavity

    poisson, prec = variant.split(",")
    if poisson.startswith("fused"):
        # interior-padded fused formulation: packed state, decoded to the
        # full grid only for the physics gate (tests/test_cavity_fused.py
        # pins trajectory equality with the full-grid step)
        import jax
        from cfd_julia_tpu.models import cavity_fused

        cfg = cavity.CavityConfig(nx=nx, ny=nx, dt=2e-5)
        step = cavity_fused.make_fused_step_fn(
            cfg, mm_precision=cavity_fused.FUSED_TIERS[poisson])
        state = cavity_fused.init_state(cfg, jnp.float32)
        sps, state = _timed_scan(step, state, steps,
                                 lambda s: float(s[0].sum()))
        assert bool(jnp.isfinite(state[0]).all()), \
            f"cavity ({variant}) went non-finite"
        _, psi = jax.jit(lambda st: cavity_fused.decode_state(cfg, st))(
            state)
    else:
        cfg = cavity.CavityConfig(nx=nx, ny=nx, dt=2e-5, poisson=poisson,
                                  fft_precision=prec)
        step = cavity.make_step_fn(cfg)
        w0 = jnp.zeros((nx + 1, nx + 1), jnp.float32)
        state = (w0, jnp.zeros_like(w0), jnp.zeros((), jnp.float32))
        sps, state = _timed_scan(step, state, steps,
                                 lambda s: float(s[0].sum()))
        assert bool(jnp.isfinite(state[0]).all()), \
            f"cavity ({variant}) went non-finite"
        psi = state[1]
    metrics = {"psi_min": float(psi.min()),
               "psi_l2": float(jnp.sqrt((psi ** 2).mean()))}
    metrics["physics"] = _check_anchor("cavity", nx, 2 * steps, metrics)
    return sps, metrics


def worker_ps23(variant: str, nx: int, steps: int):
    """Measure ONE ps23 variant; return steps/s."""
    import jax
    import jax.numpy as jnp
    from cfd_julia_tpu.models import vortex

    fft_impl, prec, pair = variant.split(",")
    cfg = vortex.VortexConfig(nx=nx, ny=nx, solver="ps23", dt=1e-3,
                              fft_impl=fft_impl, fft_precision=prec,
                              pair_impl=pair)
    # packed (real) state at the jit boundary (ops.spectral.pack_c)
    step = vortex.make_spectral_step_half_packed(cfg, jnp.float32)
    w0 = vortex.initial_vorticity(cfg, jnp.float32)
    hf = jax.jit(vortex.half_init_packed)(w0)
    sps, hf = _timed_scan(step, hf, steps,
                          lambda s: float(jnp.abs(s).sum()))
    assert bool(jnp.isfinite(hf).all()), f"ps23 ({variant}) went non-finite"
    w = jax.jit(lambda h: vortex.half_decode_packed(h, cfg.ny,
                                                    jnp.float32))(hf)
    metrics = {"wmax": float(jnp.abs(w).max()),
               "enstrophy": float((w.astype(jnp.float32) ** 2).sum())}
    metrics["physics"] = _check_anchor("ps23", nx, 2 * steps, metrics)
    return sps, metrics


def worker_mg(variant: str, nx: int, tol: float, window: int = 4):
    """Measure ONE multigrid variant: 4096^2 solve to rms/rms0 <= tol.
    Returns (seconds per solve, cycles).

    Timing discipline (same as the cavity/ps23 scan windows): the timed
    region is ONE jit call running `window` complete solves back-to-back
    on device, each on a distinctly scaled RHS (scaling does not change
    the relative-tol iteration count), divided by `window`, so per-call
    dispatch latency does not count against the solve."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from cfd_julia_tpu.models import poisson2d
    from cfd_julia_tpu.poisson import multigrid

    parts = variant.split(",")
    transfers, fmg = parts[:2]
    smoother = parts[2] if len(parts) > 2 else "auto"
    cycle_dtype = parts[3] if len(parts) > 3 else "fp32"
    mgc = multigrid.MGConfig(tol=tol, max_cycles=20, transfers=transfers,
                             fmg=(fmg == "fmg"), smoother=smoother,
                             cycle_dtype=cycle_dtype)
    cfg = poisson2d.PoissonConfig(nx=nx, ny=nx, solver="multigrid",
                                  problem="poly", mg=mgc)
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, jnp.float32)
    u0 = poisson2d._dirichlet_init(ue)

    @jax.jit
    def solve_window(ff, uu, scale):
        def body(i, acc):
            chk, _, _ = acc
            # per-solve distinct RHS; `0 * chk` serializes on the
            # previous solve's output without changing the value (XLA
            # cannot fold it: chk is not provably non-NaN)
            fi = ff * (scale * (1.0 + 1e-7 * (i.astype(ff.dtype) + 1.0))) \
                + 0.0 * chk
            r = multigrid.solve(fi, uu, cfg.dx, cfg.dy, cfg=mgc)
            return (r.u[1, 1], r.iterations, r.rms / r.rms0)
        return lax.fori_loop(
            0, window, body,
            (jnp.zeros((), ff.dtype), jnp.array(0), jnp.zeros((), ff.dtype)))

    one = jnp.ones((), f.dtype)
    chk, _, _ = solve_window(f, u0, one)           # compile + warm up
    float(chk)
    # best of 3 timed windows, each on a distinctly scaled RHS
    dt = float("inf")
    rel = None
    for r in range(3):
        t0 = time.perf_counter()
        chk, _its, rel_t = solve_window(f, u0, one * (1.0 + 1e-6 * (r + 1)))
        rel_r = float(rel_t)
        dt = min(dt, (time.perf_counter() - t0) / window)
        rel = rel_r if rel is None else max(rel, rel_r)
    assert rel <= tol, f"did not reach tol ({rel:.2e})"

    # full-methodology correctness pass OUTSIDE the timed window: one
    # plain solve whose solution feeds the independent residual recheck
    f1 = f * (1.0 + 1e-6)
    res = multigrid.solve(f1, u0, cfg.dx, cfg.dy, cfg=mgc)
    assert float(res.rms / res.rms0) <= tol, "recheck solve missed tol"
    # independent residual recheck: recompute r = f - lap(u) with plain
    # ops right here, NOT through the solver's own residual path, so a
    # V-cycle that mis-tracks its rms cannot self-certify. 4x slack for
    # summation-order fp32 differences.
    def _rms(u):
        lap = ((u[2:, 1:-1] - 2 * u[1:-1, 1:-1] + u[:-2, 1:-1]) / cfg.dx**2
               + (u[1:-1, 2:] - 2 * u[1:-1, 1:-1] + u[1:-1, :-2]) / cfg.dy**2)
        r = f1[1:-1, 1:-1] - lap
        return float(jnp.sqrt((r ** 2).mean()))

    rel_ind = _rms(res.u) / max(_rms(u0), 1e-30)
    assert rel_ind <= 4 * tol, \
        f"PHYSICS REJECT mg {nx}^2: independent residual " \
        f"rel {rel_ind:.3e} > 4x tol {tol:g}"
    return dt, int(res.iterations)


# ------------------------------ coverage battery ------------------------
# One physics-anchored row per remaining reference family: the 1D Euler
# shock solvers at their reference configs (euler_hllc.jl:154-190 scaled
# to nx=8192, roe at the ch. 9 nx=256), CRWENO Burgers (crweno_periodic
# .jl:195-206 at nx=1600), and the three NS2D formulations that are not
# the ps23 headline (vm.jl:138-140 fdm, hybrid.jl:198, 21_.../
# pseudospectral_32_rule.jl:224-228) at 2048^2, with the same scan-window
# + anchor-gate methodology; rows land in the final JSON line.
# (family, variant, nx, steps) — variant strings are worker-specific; the
# euler variant keeps its ",xla" suffix, which is part of the metric name.
COVERAGE_ROWS = (
    ("euler", "hllc,xla", 8192, 1000),
    ("euler", "roe,xla", 256, 1000),
    ("crweno", "pcr", 1600, 1000),
    ("vortex2", "fdm", 2048, 100),
    ("vortex2", "hybrid", 2048, 100),
    ("vortex2", "ps32", 2048, 100),
)


def worker_euler(variant: str, nx: int, steps: int):
    """One 1D Euler Sod family: steps/s + anchored density metrics."""
    import jax.numpy as jnp
    from cfd_julia_tpu.models import euler1d
    from cfd_julia_tpu.stepping import ssprk3

    solver = variant.split(",")[0]
    # diffusive-free CFL: dt scaled with nx from the ch. 9/10 reference
    # configs (dt=1e-4 at nx=256; max wavespeed ~2.4 on Sod)
    dt = 1e-4 * 256 / nx
    cfg = euler1d.EulerConfig(nx=nx, solver=solver, dt=dt)
    _, q0 = euler1d.sod_initial_state(cfg, jnp.float32)
    rhs = euler1d.make_rhs(cfg)
    step = lambda q: ssprk3.ssprk3_step(rhs, q, cfg.dt)
    sps, q = _timed_scan(step, q0, steps, lambda q: float(q[0].sum()))
    assert bool(jnp.isfinite(q).all()), f"euler {variant} non-finite"
    metrics = {"rho_min": float(q[0].min()),
               "rho_l2": float(jnp.sqrt((q[0] ** 2).mean()))}
    metrics["physics"] = _check_anchor(f"euler_{solver}", nx, 2 * steps,
                                       metrics)
    return sps, metrics


def worker_crweno(variant: str, nx: int, steps: int):
    """CRWENO-5 periodic Burgers (cyclic tridiagonal via PCR)."""
    import jax.numpy as jnp
    from cfd_julia_tpu.models import burgers1d
    from cfd_julia_tpu.stepping import ssprk3

    dt = 1e-4 * 200 / nx
    cfg = burgers1d.BurgersConfig(nx=nx, solver="crweno", bc="periodic",
                                  dt=dt, tridiag_method=variant)
    rhs = burgers1d.make_rhs(cfg)
    x, = (burgers1d.grid_coords(cfg, jnp.float32),)
    u0 = jnp.sin(2.0 * jnp.pi * x)
    step = lambda u: ssprk3.ssprk3_step(rhs, u, cfg.dt)
    sps, u = _timed_scan(step, u0, steps, lambda u: float(u.sum()))
    assert bool(jnp.isfinite(u).all()), "crweno non-finite"
    metrics = {"u_max": float(jnp.abs(u).max()),
               "u_l2": float(jnp.sqrt((u ** 2).mean()))}
    metrics["physics"] = _check_anchor("crweno", nx, 2 * steps, metrics)
    return sps, metrics


def worker_vortex2(variant: str, nx: int, steps: int):
    """NS2D vortex merger, non-ps23 formulations (fdm | hybrid | ps32)."""
    import jax
    import jax.numpy as jnp
    from cfd_julia_tpu.models import vortex
    from cfd_julia_tpu.stepping import ssprk3

    cfg = vortex.VortexConfig(nx=nx, ny=nx, solver=variant, dt=1e-3)
    w0 = vortex.initial_vorticity(cfg, jnp.float32)
    if variant == "fdm":
        rhs = lambda w: vortex.fdm_rhs(w, cfg.dx, cfg.dy, cfg.re)
        step = lambda w: ssprk3.ssprk3_step(rhs, w, cfg.dt)
        sps, w = _timed_scan(step, w0, steps, lambda w: float(w.sum()))
    else:
        step = vortex.make_spectral_step_half_packed(cfg, jnp.float32)
        hf = jax.jit(vortex.half_init_packed)(w0)
        sps, hf = _timed_scan(step, hf, steps,
                              lambda s: float(jnp.abs(s).sum()))
        w = jax.jit(lambda h: vortex.half_decode_packed(
            h, cfg.ny, jnp.float32))(hf)
    assert bool(jnp.isfinite(w).all()), f"vortex {variant} non-finite"
    metrics = {"wmax": float(jnp.abs(w).max()),
               "enstrophy": float((w.astype(jnp.float32) ** 2).sum())}
    metrics["physics"] = _check_anchor(variant, nx, 2 * steps, metrics)
    return sps, metrics


def run_coverage(summary, all_results, variant_timeout_s: float,
                 budget_s: float = 1500.0):
    """Measure every COVERAGE_ROWS family once (per-row subprocess);
    record coverage_<family>_<variant>_<nx> rows in the summary."""
    t0 = time.perf_counter()
    for family, variant, nx, steps in COVERAGE_ROWS:
        if time.perf_counter() - t0 > budget_s:
            print(f"# coverage budget exhausted; stopping", file=sys.stderr)
            break
        r = _spawn_variant(family, variant, nx, steps, 0.0,
                           variant_timeout_s)
        all_results.append(r)
        key = f"coverage_{family}_{variant.replace(',', '_')}_{nx}"
        if "error" in r:
            print(f"# coverage {family} {variant} {nx}: {r['error']}",
                  file=sys.stderr)
            continue
        print(f"# coverage {family} {variant} {nx}: {r['value']:.4g} "
              f"steps/s [physics {r.get('physics')}]", file=sys.stderr)
        summary[key] = round(r["value"], 2)
        summary[f"{key}_physics"] = r.get("physics")


def run_worker(args):
    """Single-variant subprocess body: one JSON result line on stdout."""
    from cfd_julia_tpu.jaxconfig import configure_cache, pin_platform

    pin_platform()
    configure_cache()
    out = {"worker": args.worker, "variant": args.variant}
    if args.worker == "cavity":
        out["value"], metrics = worker_cavity(args.variant, args.nx,
                                              args.steps)
        out["unit"] = "steps/s"
        out.update(metrics)
    elif args.worker == "ps23":
        out["value"], metrics = worker_ps23(args.variant, args.nx,
                                            args.steps)
        out["unit"] = "steps/s"
        out.update(metrics)
    elif args.worker == "mg":
        dt, cycles = worker_mg(args.variant, args.nx, args.tol)
        out.update(value=dt, unit="s", cycles=cycles)
    elif args.worker in ("euler", "crweno", "vortex2"):
        fn = {"euler": worker_euler, "crweno": worker_crweno,
              "vortex2": worker_vortex2}[args.worker]
        out["value"], metrics = fn(args.variant, args.nx, args.steps)
        out["unit"] = "steps/s"
        out.update(metrics)
    else:
        raise SystemExit(f"unknown worker {args.worker!r}")
    print(json.dumps(out), flush=True)
    return 0


def _spawn_variant(worker: str, variant: str, nx: int, steps: int,
                   tol: float, timeout_s: float, env: dict | None = None):
    """Run one variant in a subprocess; return its result dict or an
    error dict.  The caller holds no device and runs one worker at a
    time, so the worker is the only process on the card; a failure, a
    hang or an out-of-memory in one variant costs only that variant."""
    cmd = [sys.executable, os.path.abspath(__file__),
           "--worker", worker, "--variant", variant,
           "--nx", str(nx), "--steps", str(steps), "--tol", str(tol)]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        return {"worker": worker, "variant": variant,
                "error": f"TIMEOUT {timeout_s:.0f}s"}
    sys.stderr.write(p.stderr)          # pass through diagnostics
    for line in reversed(p.stdout.strip().splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                break
    tail = (p.stderr or "").strip().splitlines()
    return {"worker": worker, "variant": variant,
            "error": (tail[-1] if tail else f"rc={p.returncode}")[-300:]}


def race(worker: str, variants, nx: int, steps: int = 0, tol: float = 0.0,
         budget_s: float = 1500.0, variant_timeout_s: float = 840.0,
         minimize: bool = False, results=None):
    """Race variants in sequential per-variant subprocesses; return
    (best, name).

    budget_s: once one variant has been measured, stop racing when the
    elapsed time exceeds the budget.  Before ANY success the guard is 2x
    budget, so a family whose every variant fails still stops."""
    t_start = time.perf_counter()
    best, best_name = None, None
    for v in variants:
        name = _variant_name(worker, *v.split(",")) if worker != "mg" else v
        elapsed = time.perf_counter() - t_start
        if elapsed > (budget_s if best_name is not None else 2 * budget_s):
            print(f"# {worker} race budget exhausted ({elapsed:.0f}s; "
                  f"measured={best_name is not None}); stopping",
                  file=sys.stderr)
            break
        r = _spawn_variant(worker, v, nx, steps, tol, variant_timeout_s)
        if results is not None:
            results.append(r)
        if "error" in r:
            print(f"# {worker} {nx}^2 {name} failed: {r['error']}",
                  file=sys.stderr)
            continue
        val = r["value"]
        extra = f" ({r['cycles']} V-cycles)" if "cycles" in r else ""
        if r.get("physics"):
            extra += f" [physics {r['physics']}]"
        print(f"# {worker} {nx}^2 {name}: {val:.4g} {r['unit']}{extra}",
              file=sys.stderr)
        if best is None or (val < best if minimize else val > best):
            best, best_name = val, name
    return best, best_name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="fewer steps, one cavity variant, no secondaries")
    ap.add_argument("--probe-timeout", type=int, default=300)
    ap.add_argument("--nx", type=int, default=1024,
                    help="cavity grid override (debug only; the headline "
                         "metric is defined at 1024)")
    ap.add_argument("--steps", type=int, default=0,
                    help="scan-window length override (0 = default)")
    ap.add_argument("--tol", type=float, default=1e-5,
                    help="multigrid solve tolerance (rms/rms0)")
    ap.add_argument("--ps-nx", type=int, default=2048,
                    help="ps23 secondary grid override")
    ap.add_argument("--mg-nx", type=int, default=4096,
                    help="multigrid secondary grid override")
    ap.add_argument("--worker", default=None,
                    help="internal: run one variant in-process")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--budget", type=float, default=1500.0,
                    help="cavity race budget, seconds")
    ap.add_argument("--variant-timeout", type=float, default=840.0)
    ap.add_argument("--no-coverage", action="store_true",
                    help="skip the per-family coverage battery after the "
                         "three north-star races")
    ap.add_argument("--max-variants", type=int, default=0,
                    help="cap each family's race to its first N variants "
                         "(0 = all)")
    args = ap.parse_args(argv)

    if args.worker:
        return run_worker(args)

    device = _probe_devices(args.probe_timeout)
    if device is None or device["platform"] != "gpu":
        _emit(0.0, 0.0, error=f"no GPU found (device probe: {device})")
        return 1
    device.update(nvidia_smi=_nvidia_smi(),
                  xla_flags=os.environ.get("XLA_FLAGS", ""))
    print(f"# device: {device}", file=sys.stderr)

    steps = args.steps or (50 if args.quick else 1000)

    def _cap(fam):
        return fam[: args.max_variants] if args.max_variants > 0 else fam

    variants = (",".join(CAVITY_VARIANTS[0]),) if args.quick else \
        tuple(",".join(v) for v in _cap(CAVITY_VARIANTS))
    all_results = []
    cavity_sps, cavity_impl = race(
        "cavity", variants, args.nx, steps=steps, budget_s=args.budget,
        variant_timeout_s=args.variant_timeout, results=all_results)
    if cavity_sps is None:
        _emit(0.0, 0.0, error="every cavity variant failed", **device)
        return 1
    print(f"# cavity {args.nx}^2 fp32 best={cavity_impl}: "
          f"{cavity_sps:.1f} steps/s", file=sys.stderr)

    # headline first (secondaries compile for minutes and must never block
    # it); a non-headline grid reports under its OWN metric name so no
    # consumer can record it as the 1024^2 number, and --quick is marked
    metric = HEADLINE_METRIC if args.nx == 1024 \
        else f"cavity_{args.nx}_steps_per_sec"
    extra = {"poisson_impl": cavity_impl,
             "precision_tier": _precision_tier(cavity_impl), **device}
    if args.nx == 1024:
        # the baseline is DEFINED at 1024^2 — other grids report raw
        extra["baseline_steps_per_sec"] = (
            "10.0 (C-compiled cavity-algorithm measurement, Julia range "
            "7.3-10.0; see BASELINE.md)")
        vs = round(cavity_sps / JULIA_BASELINE_STEPS_PER_SEC, 1)
    else:
        vs = 0.0
    if args.quick:
        extra["quick"] = True
    _emit(round(cavity_sps, 2), vs, metric=metric, **extra)
    if args.quick:
        return 0

    summary = {}
    ps_sps, ps_impl = race(
        "ps23", tuple(",".join(v) for v in _cap(PS_VARIANTS)), args.ps_nx,
        steps=100, budget_s=900.0, variant_timeout_s=args.variant_timeout,
        results=all_results)
    if ps_sps is not None:
        print(f"# pseudospectral {args.ps_nx}^2 fp32 best={ps_impl}: "
              f"{ps_sps:.1f} steps/s", file=sys.stderr)
        summary[f"ps23_{args.ps_nx}_steps_per_sec"] = round(ps_sps, 2)
        summary["ps23_impl"] = ps_impl
        summary["ps23_precision_tier"] = (
            "bf16-1pass" if ":default" in ps_impl
            else "bf16-3pass" if ":high" in ps_impl else "fp32")
        if args.ps_nx == 2048:
            summary["ps23_vs_baseline"] = round(
                ps_sps / PS23_BASELINE_STEPS_PER_SEC, 1)
    else:
        print("# pseudospectral bench failed (all variants)",
              file=sys.stderr)

    mg_s, mg_impl = race(
        "mg", tuple(",".join(v) for v in _cap(MG_VARIANTS)), args.mg_nx,
        tol=args.tol, budget_s=900.0,
        variant_timeout_s=args.variant_timeout,
        minimize=True, results=all_results)
    if mg_s is not None:
        print(f"# multigrid {args.mg_nx}^2 fp32 solve to "
              f"rms/rms0<={args.tol:g} best={mg_impl}: {mg_s:.3f} s",
              file=sys.stderr)
        summary[f"mg_{args.mg_nx}_solve_s"] = round(mg_s, 4)
        summary["mg_impl"] = mg_impl
        if (args.mg_nx, args.tol) == (4096, 1e-5):
            summary["mg_vs_baseline"] = round(MG_BASELINE_SOLVE_S / mg_s, 1)
    else:
        print("# multigrid bench failed (all variants)", file=sys.stderr)

    # The COMPLETE record (headline + ps23_* + mg_* + coverage_*) is the
    # LAST stdout line; re-emitted after the coverage battery so a run
    # cut mid-coverage still ends on a complete JSON line.
    def _final_emit():
        _emit(round(cavity_sps, 2), vs, metric=metric, final=True, **extra,
              **summary)

    _final_emit()
    if not args.no_coverage and args.max_variants == 0:
        run_coverage(summary, all_results, args.variant_timeout)
        _final_emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
