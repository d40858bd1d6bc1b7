"""Lid-driven cavity — 2D incompressible NS in vorticity-streamfunction
form (reference ch. 18, lid_driven_cavity.jl).

Per SSP-RK3 stage (lid_driven_cavity.jl:72-110):
  1. r = -J(w, psi) + (1/Re) lap(w)   (Arakawa, interior nodes)
  2. stage-combine w on the interior
  3. vorticity wall BCs from the current psi (Hoffmann 1st-order `bc` or
     Jensen 2nd-order `bc2`, lid_driven_cavity.jl:24-51; moving lid adds
     -3/dy on the top wall for bc2, -2/dy for bc)
  4. psi = DST-I Poisson solve of lap(psi) = -w (fps_sine :11-21)

Six DST-I transforms per time step — the #1 hot path of the north-star
metric (cavity steps/sec at 1024^2). The whole step is one fused XLA
program; the steady-state monitor ||psi^n - psi^{n-1}|| stacks as a scan
output (reference writes it per-step to res_plot.txt, :112-116).

Domain [0,1]^2, Re=100, 64^2, dt=1e-3, t=10 in the reference run; the lid
moves in +x at the TOP wall (j = ny).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from cfd_julia_tpu.core import precision
from cfd_julia_tpu.ops import arakawa
from cfd_julia_tpu.poisson import direct


def _poisson_choice(name: str, platform: str | None = None, *,
                    single_device: bool = True,
                    allow_fused: bool = False) -> str:
    """Resolve poisson="auto" from policy.py.  Mesh runs take the
    pencil-shardable rfft DST ("fst"); the packed-state fused step is
    open only to solve() (allow_fused=True), since make_step_fn carries
    the full-grid state."""
    if name != "auto":
        return name
    if not single_device:
        return "fst"
    from cfd_julia_tpu import policy

    return policy.choice(
        "cavity_solve_poisson" if allow_fused else "cavity_poisson",
        platform)


@dataclasses.dataclass(frozen=True)
class CavityConfig:
    nx: int = 64
    ny: int = 64
    dt: float = 1e-3
    t_final: float = 10.0
    re: float = 100.0
    bc_order: int = 2        # 1 = Hoffmann, 2 = Jensen (reference default)
    poisson: str = "auto"    # auto (policy.py, per platform; resolved
                             # when the step is built) |
                             # fst (DST-I via odd-extension rfft) |
                             # fst_half (DST-I via the half-length rfft +
                             # pre/post passes) | matmul (dense sine-matrix
                             # transform; _bf16x3 = 3-pass bf16 tier,
                             # _bf16x1 = single-pass bf16, see
                             # core.precision) | fst_mxu (DST-I via the
                             # four-step matmul FFT) | fst_half_mxu
                             # (half-length rfft as matmuls) — same
                             # eigenvalues and results
                             # | fused / fused_bf16x3 / fused_bf16x1 — the
                             # interior-padded fused formulation
                             # (models.cavity_fused, packed state; routed
                             # by solve(), not make_step_fn)
    fft_precision: str = "highest"   # matmul-FFT impls: a core.precision
                             # tier (highest | high | default)

    @property
    def dx(self) -> float:
        return 1.0 / self.nx

    @property
    def dy(self) -> float:
        return 1.0 / self.ny

    @property
    def nt(self) -> int:
        return round(self.t_final / self.dt)


@dataclasses.dataclass
class CavityResult:
    x: jnp.ndarray
    y: jnp.ndarray
    w: jnp.ndarray             # vorticity (nx+1, ny+1)
    s: jnp.ndarray             # streamfunction
    rms_history: jnp.ndarray   # ||psi^n - psi^{n-1}|| per step (nt,)


def assemble_with_wall_bc(w_interior, s, dx: float, dy: float,
                          order: int = 2):
    """Assemble the full (nx+1, ny+1) vorticity field from its interior
    block and the wall boundary conditions derived from the streamfunction
    (lid_driven_cavity.jl:24-51). Top wall (j=ny) is the moving lid; the
    y-wall rows own the corners (the reference writes them last).

    Built by concatenation, not scatter — identical values, and GSPMD
    partitions concatenations correctly where chained scatters on
    unevenly-sharded operands miscompile on the CPU test backend."""
    if order == 1:
        row_lo = -2.0 * s[1, 1:-1] / dx**2            # x=0 wall
        row_hi = -2.0 * s[-2, 1:-1] / dx**2           # x=1 wall
        col_lo = -2.0 * s[:, 1] / dy**2               # y=0 wall
        col_hi = -2.0 * s[:, -2] / dy**2 - 2.0 / dy   # moving lid
    elif order == 2:
        row_lo = (-4.0 * s[1, 1:-1] + 0.5 * s[2, 1:-1]) / dx**2
        row_hi = (-4.0 * s[-2, 1:-1] + 0.5 * s[-3, 1:-1]) / dx**2
        col_lo = (-4.0 * s[:, 1] + 0.5 * s[:, 2]) / dy**2
        col_hi = (-4.0 * s[:, -2] + 0.5 * s[:, -3]) / dy**2 - 3.0 / dy
    else:
        raise ValueError("bc_order must be 1 or 2")
    mid = jnp.concatenate(
        [row_lo[None, :], w_interior, row_hi[None, :]], axis=0
    )
    return jnp.concatenate([col_lo[:, None], mid, col_hi[:, None]], axis=1)


def apply_wall_bc(w, s, dx: float, dy: float, order: int = 2):
    """Wall-BC fill of an existing full field (interior kept)."""
    return assemble_with_wall_bc(w[1:-1, 1:-1], s, dx, dy, order)


def _wall_bc_fields(s, dx: float, dy: float, order: int):
    """Full-shape wall-BC candidate fields from rolls of psi — each is
    valid on its own wall line (i=0, i=nx, j=0, j=ny) and selected there
    by a mask.  Roll-based so every intermediate keeps the array's
    sharding (slices like s[1, 1:-1] reshard under GSPMD)."""
    sxm, sxm2 = jnp.roll(s, -1, 0), jnp.roll(s, -2, 0)   # s[i+1], s[i+2]
    sxp, sxp2 = jnp.roll(s, 1, 0), jnp.roll(s, 2, 0)     # s[i-1], s[i-2]
    sym, sym2 = jnp.roll(s, -1, 1), jnp.roll(s, -2, 1)
    syp, syp2 = jnp.roll(s, 1, 1), jnp.roll(s, 2, 1)
    if order not in (1, 2):
        raise ValueError("bc_order must be 1 or 2")  # same contract as
        # assemble_with_wall_bc — the two step formulations must not
        # diverge on an invalid config
    if order == 1:
        return (-2.0 * sxm / dx**2,
                -2.0 * sxp / dx**2,
                -2.0 * sym / dy**2,
                -2.0 * syp / dy**2 - 2.0 / dy)
    return ((-4.0 * sxm + 0.5 * sxm2) / dx**2,
            (-4.0 * sxp + 0.5 * sxp2) / dx**2,
            (-4.0 * sym + 0.5 * sym2) / dy**2,
            (-4.0 * syp + 0.5 * syp2) / dy**2 - 3.0 / dy)


def make_padded_step_fn(cfg: CavityConfig, padded_shape):
    """Cavity step on mesh-divisible padded (P, Q) fields — the multi-chip
    formulation.  Same math as make_step_fn, but pure dataflow: rolls +
    masks for the RHS/BC assembly and the dense-matmul DST for the Poisson
    solve, so GSPMD partitions every op in place (the slice/concat/pad
    assembly of the logical-grid step forces involuntary full
    rematerialization of edge tensors under a 2D sharding).

    State: (w, s, rms) with w, s of shape padded_shape; the logical field
    lives at [0..nx, 0..ny], padding stays exactly zero."""
    nx, ny = cfg.nx, cfg.ny
    dx, dy, dt, re = cfg.dx, cfg.dy, cfg.dt, cfg.re
    P, Q = padded_shape
    i = jnp.arange(P)[:, None]
    j = jnp.arange(Q)[None, :]
    interior = (i >= 1) & (i <= nx - 1) & (j >= 1) & (j <= ny - 1)
    logical = (i <= nx) & (j <= ny)
    n_nodes = float((nx + 1) * (ny + 1))

    def close(wt_raw, s_prev):
        """Mask in the wall BCs (y-walls own the corners: applied last,
        matching the reference's write order), zero the padding, fresh
        psi from the matmul Poisson solve."""
        bx_lo, bx_hi, by_lo, by_hi = _wall_bc_fields(
            s_prev, dx, dy, cfg.bc_order)
        wt = jnp.where(interior, wt_raw, 0.0)
        wt = jnp.where(i == 0, bx_lo, wt)
        wt = jnp.where(i == nx, bx_hi, wt)
        wt = jnp.where(j == 0, by_lo, wt)
        wt = jnp.where(j == ny, by_hi, wt)
        wt = jnp.where(logical, wt, 0.0)
        s = direct.solve_fst_matmul_padded(-wt, nx, ny, dx, dy)
        return wt, s

    def step(state):
        w, s, _ = state
        sp = s
        r = arakawa.vorticity_rhs(w, s, dx, dy, re)
        wt, s = close(w + dt * r, s)
        r = arakawa.vorticity_rhs(wt, s, dx, dy, re)
        wt, s = close(0.75 * w + 0.25 * wt + 0.25 * dt * r, s)
        r = arakawa.vorticity_rhs(wt, s, dx, dy, re)
        wn, s = close((w + 2.0 * wt + 2.0 * dt * r) / 3.0, s)
        rms = jnp.sqrt(
            jnp.sum(jnp.where(logical, (s - sp) ** 2, 0.0)) / n_nodes)
        return (wn, s, rms)

    return step


def make_step_fn(cfg: CavityConfig, mesh=None, re=None):
    """Cavity step.  `re` overrides cfg.re and may be a JAX tracer — the
    step is then differentiable w.r.t. the Reynolds number
    (tests/test_autodiff.py, examples/adjoint_cavity.py)."""
    dx, dy, dt = cfg.dx, cfg.dy, cfg.dt
    re = cfg.re if re is None else re
    poisson = _poisson_choice(cfg.poisson, single_device=mesh is None)

    def rhs_interior(w, s):
        return arakawa.vorticity_rhs(w, s, dx, dy, re)[1:-1, 1:-1]

    if poisson in ("fused", "fused_bf16x3", "fused_bf16x1"):
        raise ValueError(
            "poisson='fused*' selects the interior-padded fused step "
            "(models.cavity_fused), which carries a packed state and so "
            "cannot be built by make_step_fn; use cavity.solve (which "
            "routes it) or cavity_fused.make_fused_step_fn directly")
    if poisson not in ("fst", "matmul", "matmul_bf16x3", "matmul_bf16x1",
                       "fst_mxu", "fst_half", "fst_half_mxu"):
        # a typo'd variant name must never silently run (and get
        # benchmarked as) the default solver
        raise ValueError(f"unknown poisson solver {poisson!r}")
    if mesh is not None and poisson not in ("fst", "fst_half"):
        raise ValueError(
            f"poisson={poisson!r} is single-device only; the mesh-"
            "aware step uses poisson='fst'/'fst_half' (pencil DST) or "
            "make_padded_step_fn (matmul DST with native sharding)")
    if poisson in ("matmul", "matmul_bf16x3", "matmul_bf16x1"):
        # interior-aligned matmul solver: reads the interior, returns
        # exact-zero walls — same contract as solve_fst.  Precision tiers
        # (core.precision): highest = fp32 products, high = 3-pass bf16,
        # default = single-pass bf16
        prec = {"matmul_bf16x3": "high",
                "matmul_bf16x1": "default"}.get(poisson, "highest")
        solve = lambda f: direct.solve_fst_matmul_interior(
            f, cfg.nx, cfg.ny, dx, dy, mm_precision=prec)
    elif poisson == "fst_half_mxu":
        # half-length DST with its rfft as matmuls
        solve = lambda f: direct.solve_fst(f, dx, dy, impl="half_mxu",
                                           precision=cfg.fft_precision)
    elif poisson == "fst_mxu":
        # odd-extension DST through the four-step matmul FFT
        solve = lambda f: direct.solve_fst(f, dx, dy, impl="matmul",
                                           precision=cfg.fft_precision)
    elif poisson == "fst_half":
        # half-length-rfft DST (FFTPACK-style pre/post passes); the
        # pre/post passes are axis-local elementwise+cumsum, so the
        # pencil constraint shards them like the rfft itself
        solve = lambda f: direct.solve_fst(f, dx, dy, impl="half",
                                           mesh=mesh)
    else:
        solve = lambda f: direct.solve_fst(f, dx, dy, mesh=mesh)

    def stage_close(wt_interior, s_prev):
        """Assemble with wall BCs from the pre-stage psi, then fresh psi."""
        wt = assemble_with_wall_bc(wt_interior, s_prev, dx, dy, cfg.bc_order)
        s = solve(-wt)
        return wt, s

    def step(state):
        w, s, _ = state
        sp = s

        r = rhs_interior(w, s)
        wt, s = stage_close(w[1:-1, 1:-1] + dt * r, s)

        r = rhs_interior(wt, s)
        wt, s = stage_close(
            0.75 * w[1:-1, 1:-1] + 0.25 * wt[1:-1, 1:-1] + 0.25 * dt * r, s
        )

        r = rhs_interior(wt, s)
        wn, s = stage_close(
            (w[1:-1, 1:-1] + 2.0 * wt[1:-1, 1:-1] + 2.0 * dt * r) / 3.0, s
        )

        rms = jnp.sqrt(jnp.mean((s - sp) ** 2))
        return (wn, s, rms)

    return step


@partial(jax.jit, static_argnames=("cfg", "nt"))
def _run(cfg: CavityConfig, w0, s0, nt: int):
    if cfg.poisson.startswith("fused"):
        # interior-padded fused formulation (models.cavity_fused):
        # pack -> scan the packed step -> decode.  Trajectory-identical
        # to the full-grid step, including across chunk boundaries
        # (tests/test_cavity_fused.py::test_pack_midrun_state_...)
        from cfd_julia_tpu.models import cavity_fused

        step = cavity_fused.make_fused_step_fn(
            cfg, mm_precision=cavity_fused.FUSED_TIERS[cfg.poisson])

        def body_f(state, _):
            state = step(state)
            return state, state[3]

        packed = cavity_fused.pack_state(cfg, w0, s0)
        packed, rms_hist = lax.scan(body_f, packed, None, length=nt)
        w, s = cavity_fused.decode_state(cfg, packed)
        return w, s, rms_hist

    step = make_step_fn(cfg)

    def body(state, _):
        state = step(state)
        return state, state[2]

    init = (w0, s0, jnp.zeros((), w0.dtype))
    (w, s, _), rms_hist = lax.scan(body, init, None, length=nt)
    return w, s, rms_hist


def solve(cfg: CavityConfig, dtype=None, checkpoint_every: int = 0,
          checkpoint_path: str | None = None,
          resume: bool = False) -> CavityResult:
    """Integrate nt steps from rest (lid_driven_cavity.jl:58-118).

    checkpoint_every/checkpoint_path: save a resumable on-disk
    checkpoint (state + rms history + step count) every N steps —
    crash recovery for multi-hour runs, a capability the reference
    lacks (SURVEY §5).  resume: continue from checkpoint_path if it
    exists (bit-for-bit identical to the uninterrupted run: the chunk
    scans apply the same step function; the per-step rms is computed
    from that step's psi change, so the carry reset is invisible)."""
    import numpy as np

    from cfd_julia_tpu.utils import checkpoint

    # solve() owns the packed-state fused path, so its auto may resolve
    # to the fused winner (make_step_fn's auto cannot — packed state)
    resolved = _poisson_choice(cfg.poisson, allow_fused=True)
    if resolved != cfg.poisson:
        cfg = dataclasses.replace(cfg, poisson=resolved)

    dtype = dtype or precision.default_dtype()
    x = jnp.linspace(0.0, 1.0, cfg.nx + 1, dtype=dtype)
    y = jnp.linspace(0.0, 1.0, cfg.ny + 1, dtype=dtype)
    w = jnp.zeros((cfg.nx + 1, cfg.ny + 1), dtype)
    s = jnp.zeros_like(w)
    done = 0
    hist = np.zeros((0,), np.asarray(jnp.zeros((), dtype)).dtype)

    if (checkpoint_every or resume) and not checkpoint_path:
        raise ValueError("checkpointing requires checkpoint_path")
    if resume:
        if checkpoint.exists(checkpoint_path):
            (w, s, h), done = checkpoint.load_state(
                checkpoint_path, (w, s, jnp.asarray(hist)))
            hist = np.asarray(h)
            if done is None or len(hist) != done:
                raise ValueError(
                    f"checkpoint {checkpoint_path} has no/inconsistent "
                    f"step record (step={done}, rms entries={len(hist)})")
            if done > cfg.nt:
                raise ValueError(
                    f"checkpoint at step {done} is beyond this run's "
                    f"nt={cfg.nt}; restart without --resume")

    while done < cfg.nt:
        n = cfg.nt - done
        if checkpoint_every:
            n = min(checkpoint_every, n)
        w, s, rms = _run(cfg, w, s, n)
        hist = np.concatenate([hist, np.asarray(rms)])
        done += n
        if checkpoint_every and checkpoint_path:
            jax.block_until_ready(s)
            checkpoint.save_state(checkpoint_path,
                                  (w, s, jnp.asarray(hist)), step=done)

    return CavityResult(x=x, y=y, w=w, s=s, rms_history=jnp.asarray(hist))


def centerline_velocities(res: CavityResult, cfg: CavityConfig):
    """u(y) on the vertical centerline x=0.5 and v(x) on the horizontal
    centerline y=0.5 (u = d psi/dy, v = -d psi/dx, central differences) —
    the Ghia et al. (1982) benchmark quantities."""
    s = res.s
    i = cfg.nx // 2
    j = cfg.ny // 2
    u = jnp.zeros(cfg.ny + 1, s.dtype)
    u = u.at[1:-1].set((s[i, 2:] - s[i, :-2]) / (2 * cfg.dy))
    u = u.at[-1].set(1.0)  # lid
    v = jnp.zeros(cfg.nx + 1, s.dtype)
    v = v.at[1:-1].set(-(s[2:, j] - s[:-2, j]) / (2 * cfg.dx))
    return u, v
