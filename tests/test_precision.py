"""fp32-vs-fp64 tolerance matrix (SURVEY §4f): every solver family runs in
fp32 (the accelerator throughput dtype) within a known factor of its fp64 accuracy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_julia_tpu.models import burgers1d, cavity, euler1d, heat1d, poisson2d, vortex
from cfd_julia_tpu.utils import debug


@pytest.mark.parametrize(
    "scheme,f32_tol",
    # fp64 golden L2: ftcs 1.93e-4, cn 1.34e-4 — fp32 adds rounding noise
    # over 400 steps but stays within ~2x; icp's 1e-7 signal drowns in fp32
    # rounding, so it is only required to stay under the 2nd-order schemes
    [("ftcs", 4e-4), ("cn", 4e-4), ("icp", 1e-4)],
)
def test_heat_fp32(scheme, f32_tol):
    res = heat1d.solve(heat1d.HeatConfig(scheme=scheme), dtype=jnp.float32)
    assert res.u.dtype == jnp.float32
    assert float(res.l2_error) < f32_tol


def test_burgers_fp32_matches_fp64():
    cfg = burgers1d.BurgersConfig(nx=128, solver="weno", bc="periodic",
                                  t_final=0.1, ns=1)
    u64 = np.asarray(burgers1d.solve(cfg, dtype=jnp.float64).u)
    u32 = np.asarray(burgers1d.solve(cfg, dtype=jnp.float32).u)
    assert np.abs(u64 - u32).max() < 5e-4


def test_euler_fp32_sod():
    cfg = euler1d.EulerConfig(nx=256, solver="hllc")
    q32 = euler1d.solve(cfg, dtype=jnp.float32)
    q64 = euler1d.solve(cfg, dtype=jnp.float64)
    assert q32.q.dtype == jnp.float32
    diff = np.abs(np.asarray(q32.q) - np.asarray(q64.q)).max()
    assert diff < 5e-4, diff


def test_poisson_fst_fp32():
    cfg = poisson2d.PoissonConfig(nx=128, ny=128, solver="fst", problem="sine32")
    e32 = float(poisson2d.solve(cfg, dtype=jnp.float32).l2_error)
    e64 = float(poisson2d.solve(cfg, dtype=jnp.float64).l2_error)
    # discretization error ~1.45e-4 dominates fp32 rounding
    assert abs(e32 - e64) < 0.2 * e64


def test_cavity_fp32_ghia_ballpark():
    cfg = cavity.CavityConfig(t_final=5.0)
    s32 = np.asarray(cavity.solve(cfg, dtype=jnp.float32).s)
    s64 = np.asarray(cavity.solve(cfg, dtype=jnp.float64).s)
    assert np.abs(s32 - s64).max() < 1e-4


def test_tgv_fp32():
    cfg = vortex.VortexConfig(nx=64, ny=64, solver="ps23", dt=0.01,
                              t_final=1.0, re=10.0, ic="tgv", ns=1)
    res = vortex.solve(cfg, dtype=jnp.float32)
    l2, _ = vortex.tgv_error(cfg, res)
    # fp64 value 8.5e-6; fp32 rounding floor dominates
    assert float(l2) < 5e-4


def test_check_finite():
    debug.check_finite({"a": jnp.ones(3)})
    with pytest.raises(FloatingPointError):
        debug.check_finite({"a": jnp.array([1.0, jnp.nan])})
