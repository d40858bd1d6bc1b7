"""Fused interior-padded cavity formulation vs the reference step.

models.cavity_fused reorganizes the ch. 18 step (lid_driven_cavity.jl:
58-118) onto tile-aligned interior buffers; these tests pin its
trajectory to models.cavity.make_step_fn (the formulation already
parity-tested against the reference) in fp64, where the only admissible
difference is matmul accumulation order (~1e-13 rel).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_julia_tpu.models import cavity, cavity_fused


def _ref_step(cfg):
    c = cavity.CavityConfig(**{**cfg.__dict__, "poisson": "matmul"})
    return cavity.make_step_fn(c)


def _run_ref(cfg, nt, w0=None, s0=None):
    step = _ref_step(cfg)
    n = cfg.nx + 1
    w = jnp.zeros((n, cfg.ny + 1), jnp.float64) if w0 is None else w0
    s = jnp.zeros_like(w) if s0 is None else s0
    state = (w, s, jnp.zeros((), jnp.float64))
    rms = []
    for _ in range(nt):
        state = step(state)
        rms.append(float(state[2]))
    return state[0], state[1], np.asarray(rms)


def _run_fused(cfg, nt, state=None):
    step = cavity_fused.make_fused_step_fn(cfg)
    if state is None:
        state = cavity_fused.init_state(cfg, jnp.float64)
    rms = []
    for _ in range(nt):
        state = step(state)
        rms.append(float(state[3]))
    w, s = cavity_fused.decode_state(cfg, state)
    return w, s, np.asarray(rms), state


@pytest.mark.parametrize("bc_order", [1, 2])
def test_trajectory_matches_reference_step(bc_order):
    cfg = cavity.CavityConfig(nx=16, ny=16, dt=2e-3, re=100.0,
                              bc_order=bc_order)
    w_ref, s_ref, rms_ref = _run_ref(cfg, 20)
    w_f, s_f, rms_f, _ = _run_fused(cfg, 20)
    assert np.allclose(np.asarray(w_f), np.asarray(w_ref),
                       rtol=1e-11, atol=1e-11)
    assert np.allclose(np.asarray(s_f), np.asarray(s_ref),
                       rtol=1e-11, atol=1e-13)
    assert np.allclose(rms_f, rms_ref, rtol=1e-10)


def test_trajectory_matches_nonsquare():
    """Non-square grid catches axis/wall-vector transposition bugs."""
    cfg = cavity.CavityConfig(nx=24, ny=16, dt=1e-3, re=50.0)
    w_ref, s_ref, _ = _run_ref(cfg, 12)
    w_f, s_f, _, _ = _run_fused(cfg, 12)
    assert np.allclose(np.asarray(w_f), np.asarray(w_ref),
                       rtol=1e-11, atol=1e-11)
    assert np.allclose(np.asarray(s_f), np.asarray(s_ref),
                       rtol=1e-11, atol=1e-13)


def test_pack_midrun_state_continues_identically():
    """pack_state of a mid-run full-grid state continues the same
    trajectory (walls are carried, not recomputed — they lag psi by one
    solve, and pack takes them from w_full verbatim)."""
    cfg = cavity.CavityConfig(nx=16, ny=16, dt=2e-3, re=100.0)
    w_ref, s_ref, _ = _run_ref(cfg, 10)
    packed = cavity_fused.pack_state(cfg, w_ref, s_ref)
    w_ref2, s_ref2, _ = _run_ref(cfg, 6, w0=w_ref, s0=s_ref)
    w_f, s_f, _, _ = _run_fused(cfg, 6, state=packed)
    assert np.allclose(np.asarray(w_f), np.asarray(w_ref2),
                       rtol=1e-11, atol=1e-11)
    assert np.allclose(np.asarray(s_f), np.asarray(s_ref2),
                       rtol=1e-11, atol=1e-13)


def test_init_state_decodes_to_rest():
    cfg = cavity.CavityConfig(nx=16, ny=16)
    w, s = cavity_fused.decode_state(cfg, cavity_fused.init_state(cfg))
    assert not np.asarray(w).any()
    assert not np.asarray(s).any()


def test_padding_stays_exactly_zero():
    cfg = cavity.CavityConfig(nx=16, ny=16, dt=2e-3)
    _, _, _, state = _run_fused(cfg, 8)
    w, s, (rl, rh, cl, ch), _ = state
    m, n = cfg.nx - 1, cfg.ny - 1
    assert not np.asarray(w[m:, :]).any() and not np.asarray(w[:, n:]).any()
    assert not np.asarray(s[m:, :]).any() and not np.asarray(s[:, n:]).any()
    for v, L in ((rl, n), (rh, n), (cl, m), (ch, m)):
        assert not np.asarray(v[L:]).any()


def test_padded_extents_are_tile_multiples():
    P, Q = cavity_fused.padded_extents(1024, 1024)
    assert (P, Q) == (1024, 1024)  # the whole point: 1023 -> 1024, not 1152
    P, Q = cavity_fused.padded_extents(16, 16)
    assert P % 8 == 0 and Q % 128 == 0


def test_solve_routes_fused_poisson():
    """cavity.solve(poisson='fused') must reproduce the default-path
    trajectory (rms history and fields), including across checkpoint
    chunk boundaries (pack/decode at each chunk)."""
    ref = cavity.solve(cavity.CavityConfig(nx=16, ny=16, dt=2e-3,
                                           t_final=0.04,
                                           poisson="matmul"))
    fus = cavity.solve(cavity.CavityConfig(nx=16, ny=16, dt=2e-3,
                                           t_final=0.04, poisson="fused"))
    assert np.allclose(np.asarray(fus.s), np.asarray(ref.s),
                       rtol=1e-11, atol=1e-13)
    assert np.allclose(np.asarray(fus.rms_history),
                       np.asarray(ref.rms_history), rtol=1e-10)


def test_make_step_fn_rejects_fused_names():
    cfg = cavity.CavityConfig(nx=16, ny=16, poisson="fused")
    with pytest.raises(ValueError, match="fused"):
        cavity.make_step_fn(cfg)


def test_invalid_bc_order_rejected():
    cfg = cavity.CavityConfig(nx=16, ny=16, bc_order=3)
    with pytest.raises(ValueError):
        cavity_fused.make_fused_step_fn(cfg)
