"""Framework surface: presets, runner outputs (reference-compatible text
contract), checkpoint/resume, CLI."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from cfd_julia_tpu import presets, run
from cfd_julia_tpu.utils import checkpoint


def test_all_presets_resolve():
    assert len(presets.PRESETS) >= 27  # 22 chapters + variants
    for name, p in presets.PRESETS.items():
        assert p.family in ("heat", "burgers", "euler", "poisson",
                            "cavity", "vortex"), name


def test_preset_override():
    p = presets.with_overrides(presets.get("heat_ftcs"), nx=40)
    assert p.cfg.nx == 40
    assert presets.get("heat_ftcs").cfg.nx == 80


def test_run_heat_preset_outputs(tmp_path):
    m = run.run_preset("heat_ftcs", outdir=str(tmp_path))
    assert m["l2_error"] < 2.1e-4
    out = (tmp_path / "output.txt").read_text()
    assert out.startswith("Error details:")
    assert "L-2 Norm=" in out and "Maximum Norm=" in out
    lines = (tmp_path / "field_final.csv").read_text().splitlines()
    assert lines[0] == "x ue un uerror"
    assert len(lines) == 82  # header + nx+1 nodes
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert metrics["preset"] == "heat_ftcs"


def test_run_burgers_preset_outputs(tmp_path):
    m = run.run_preset("burgers_weno_dirichlet", outdir=str(tmp_path),
                       nx=100, t_final=0.05)
    sol = (tmp_path / "solution_d_100.txt").read_text().splitlines()
    assert len(sol) == 101
    assert len(sol[0].split()) == 11  # x + 10 snapshots


def test_run_poisson_iterative_outputs(tmp_path):
    m = run.run_preset("poisson_cg", outdir=str(tmp_path), nx=64, ny=64)
    assert m["iterations"] > 0
    hist = (tmp_path / "cg_residual.txt").read_text().splitlines()
    assert len(hist) >= 1
    it, rms, rel = hist[0].split()
    assert int(it) > 0 and float(rel) <= 1.0


def test_run_cavity_preset_outputs(tmp_path):
    m = run.run_preset("cavity", outdir=str(tmp_path), t_final=0.5)
    assert (tmp_path / "res_plot.txt").exists()
    assert (tmp_path / "centerlines.txt").exists()
    assert m["steady_rms"] > 0


def test_run_tgv_preset(tmp_path):
    m = run.run_preset("tgv", outdir=str(tmp_path))
    assert m["l2_error"] < 8e-3


def test_checkpoint_roundtrip(tmp_path):
    state = (jnp.arange(12.0).reshape(3, 4), jnp.zeros(()),
             {"a": jnp.ones(5)})
    path = str(tmp_path / "ck.npz")
    checkpoint.save_state(path, state, step=42)
    restored, step = checkpoint.load_state(path, state)
    assert step == 42
    np.testing.assert_array_equal(np.asarray(restored[0]),
                                  np.asarray(state[0]))
    np.testing.assert_array_equal(np.asarray(restored[2]["a"]),
                                  np.asarray(state[2]["a"]))


def test_checkpoint_resume_equivalence(tmp_path):
    """Stop-and-resume reproduces an uninterrupted run bit-for-bit."""
    from cfd_julia_tpu.models import heat1d
    from cfd_julia_tpu.stepping import loop

    cfg = heat1d.HeatConfig(scheme="rk3")
    import jax

    x, u0 = heat1d.initial_condition(cfg, jnp.float64)
    step = heat1d.make_step_fn(cfg, jnp.float64)
    full = loop.run_steps(step, u0, 100)
    half = loop.run_steps(step, u0, 50)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_state(path, half, step=50)
    resumed, s = checkpoint.load_state(path, half)
    rest = loop.run_steps(step, resumed, 100 - s)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(rest))


def test_cavity_checkpoint_resume_bitexact(tmp_path):
    """Checkpointed + interrupted + resumed cavity run reproduces the
    uninterrupted trajectory bit-for-bit, including the rms history."""
    import dataclasses

    from cfd_julia_tpu.models import cavity

    ck = str(tmp_path / "ck.npz")
    cfg50 = cavity.CavityConfig(nx=24, ny=24, dt=1e-3, t_final=0.05)
    assert cfg50.nt == 50
    cavity.solve(cfg50, jnp.float64, checkpoint_every=20,
                 checkpoint_path=ck)  # "crash" after completing 50
    cfg100 = dataclasses.replace(cfg50, t_final=0.1)
    resumed = cavity.solve(cfg100, jnp.float64, checkpoint_path=ck,
                           resume=True)
    full = cavity.solve(cfg100, jnp.float64)
    np.testing.assert_array_equal(np.asarray(resumed.w),
                                  np.asarray(full.w))
    np.testing.assert_array_equal(np.asarray(resumed.s),
                                  np.asarray(full.s))
    np.testing.assert_array_equal(np.asarray(resumed.rms_history),
                                  np.asarray(full.rms_history))


def test_cavity_checkpoint_cli(tmp_path):
    """CLI surface: run with --checkpoint-every writes checkpoint.npz;
    --resume on a finished run is a no-op returning the same metrics;
    unsupported family and --sweep combinations are rejected."""
    from cfd_julia_tpu import cli

    d = tmp_path / "cav"
    rc = cli.main(["run", "cavity", "--outdir", str(d),
                   "--checkpoint-every", "25", "--t_final", "0.05",
                   "--dt", "0.001", "--nx", "16", "--ny", "16"])
    assert rc == 0
    assert (d / "checkpoint.npz").exists()
    m1 = json.load(open(d / "metrics.json"))
    rc = cli.main(["run", "cavity", "--outdir", str(d), "--resume",
                   "--t_final", "0.05", "--dt", "0.001",
                   "--nx", "16", "--ny", "16"])
    assert rc == 0
    m2 = json.load(open(d / "metrics.json"))
    assert m2["psi_min"] == m1["psi_min"]
    with pytest.raises(ValueError, match="cavity, vortex"):
        run.run_preset("heat_cn", outdir=str(tmp_path / "h"),
                       checkpoint_every=10)
    assert cli.main(["run", "cavity", "--outdir", str(d),
                     "--checkpoint-every", "5",
                     "--sweep", "nx=16,24"]) == 2


@pytest.mark.parametrize("solver", ["fdm", "ps23"])
def test_vortex_checkpoint_resume_bitexact(tmp_path, solver):
    """Interrupted + resumed vortex run (either solver family)
    reproduces the checkpoint-free solve exactly, snapshots included."""
    import dataclasses

    from cfd_julia_tpu.models import vortex

    ck = str(tmp_path / f"v_{solver}.npz")
    cfg_half = vortex.VortexConfig(nx=32, ny=32, solver=solver, dt=1e-3,
                                   t_final=0.02, ns=4)
    assert cfg_half.nt == 20
    vortex.solve(cfg_half, jnp.float64, checkpoint_every=5,
                 checkpoint_path=ck)  # "crash" after 20 of 40 steps
    cfg_full = dataclasses.replace(cfg_half, t_final=0.04, ns=8)
    resumed = vortex.solve(cfg_full, jnp.float64, checkpoint_path=ck,
                           resume=True)
    full = vortex.solve(cfg_full, jnp.float64)
    np.testing.assert_array_equal(np.asarray(resumed.w),
                                  np.asarray(full.w))
    np.testing.assert_array_equal(np.asarray(resumed.snapshots),
                                  np.asarray(full.snapshots))


def test_checkpoint_contract_rejections(tmp_path):
    """A resume whose snapshot cadence no longer matches the checkpoint
    (nt changed, ns kept) must be rejected, NOT silently returned stale
    (found in review: done was stored in chunk units and a doubled
    t_final skipped integration entirely); a shorter-than-checkpoint run
    is rejected; checkpoint_every without a path raises for both
    families."""
    import dataclasses

    from cfd_julia_tpu.models import cavity, vortex

    ck = str(tmp_path / "v.npz")
    cfg = vortex.VortexConfig(nx=32, ny=32, solver="fdm", dt=1e-3,
                              t_final=0.02, ns=4)  # nt=20, every=5
    vortex.solve(cfg, jnp.float64, checkpoint_every=5, checkpoint_path=ck)
    # t_final doubled with ns kept -> every 5 -> 10: snapshots misalign
    with pytest.raises(ValueError, match="snapshot"):
        vortex.solve(dataclasses.replace(cfg, t_final=0.04),
                     jnp.float64, checkpoint_path=ck, resume=True)
    # run shorter than the checkpointed progress
    with pytest.raises(ValueError, match="beyond"):
        vortex.solve(dataclasses.replace(cfg, t_final=0.01),
                     jnp.float64, checkpoint_path=ck, resume=True)
    with pytest.raises(ValueError, match="checkpoint_path"):
        vortex.solve(cfg, jnp.float64, checkpoint_every=5)
    with pytest.raises(ValueError, match="checkpoint_path"):
        cavity.solve(cavity.CavityConfig(nx=16, ny=16, dt=1e-3,
                                         t_final=0.01),
                     jnp.float64, checkpoint_every=5)


def test_run_steps_dynamic_trajectory_and_shared_compile():
    """run_steps_dynamic(k, chunk) walks the exact run_steps(k*chunk)
    trajectory, and different window lengths hit ONE compiled executable
    (the point: bench.py's quick 50-step and full 1000-step windows
    share a single compile)."""
    from cfd_julia_tpu.models import heat1d
    from cfd_julia_tpu.stepping import loop

    cfg = heat1d.HeatConfig(scheme="rk3")
    _, u0 = heat1d.initial_condition(cfg, jnp.float64)
    step = heat1d.make_step_fn(cfg, jnp.float64)

    before = loop.run_steps_dynamic._cache_size()
    short = loop.run_steps_dynamic(step, u0, jnp.asarray(1, jnp.int32), 50)
    long = loop.run_steps_dynamic(step, u0, jnp.asarray(4, jnp.int32), 50)
    np.testing.assert_array_equal(np.asarray(short),
                                  np.asarray(loop.run_steps(step, u0, 50)))
    np.testing.assert_array_equal(np.asarray(long),
                                  np.asarray(loop.run_steps(step, u0, 200)))
    assert loop.run_steps_dynamic._cache_size() == before + 1


def test_cli_list_and_run(tmp_path, capsys):
    from cfd_julia_tpu import cli

    assert cli.main(["list"]) == 0
    out = capsys.readouterr().out
    assert "heat_ftcs" in out and "vortex_merger_ps23" in out

    rc = cli.main(["run", "heat_cn", "--outdir", str(tmp_path),
                   "--nx", "40", "--dt", "0.005"])
    assert rc == 0
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert metrics["preset"] == "heat_cn"
