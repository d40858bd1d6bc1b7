"""bench.py: worker-mode subprocess contract, the physics gate, the race
budget, the final-line record, and failing loudly without a GPU."""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import bench  # noqa: E402


def _last_json_line(text: str):
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line in: {text[-500:]}")


def test_worker_cavity_subprocess_contract():
    r = subprocess.run(
        [sys.executable, str(ROOT / "bench.py"), "--worker", "cavity",
         "--variant", "fst,highest", "--nx", "32", "--steps", "3"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-800:]
    out = _last_json_line(r.stdout)
    assert out["worker"] == "cavity" and out["value"] > 0
    # no anchor exists for (32, 6): gate reports, does not reject
    assert out["physics"] == "no-anchor"


def test_timed_scan_repeats_keep_anchor_state_at_2x_steps():
    """Best-of-3 timing (round-5 contention defense) must not move the
    physics-gate point: the returned state is the state after exactly
    2*steps (warm window + FIRST timed window), because anchors are
    keyed at (family, nx, 2*steps); later windows only contribute
    timing."""
    import jax.numpy as jnp

    step = lambda s: s + 1.0
    sps, state = bench._timed_scan(step, jnp.zeros(()), steps=50,
                                   sync=lambda s: float(s), repeats=3)
    assert float(state) == 100.0          # 2 * steps applications
    assert sps > 0


def test_check_anchor_gate(monkeypatch, tmp_path):
    """Unit contract of the physics acceptance gate: within-tolerance
    metrics pass, out-of-tolerance raise, unknown keys are no-anchor."""
    p = tmp_path / "anchors.json"
    p.write_text(json.dumps({"cavity:64:40": {
        "psi_min": -1.0e-3, "psi_l2": 5.0e-4, "rel_tol": 0.01}}))
    monkeypatch.setattr(bench, "ANCHORS_JSON", str(p))
    ok = bench._check_anchor("cavity", 64, 40,
                             {"psi_min": -1.0005e-3, "psi_l2": 5.002e-4})
    assert ok == "ok"
    assert bench._check_anchor("cavity", 128, 40, {}) == "no-anchor"
    with pytest.raises(AssertionError, match="PHYSICS REJECT"):
        bench._check_anchor("cavity", 64, 40,
                            {"psi_min": -1.2e-3, "psi_l2": 5.002e-4})
    # NaN must reject, never pass
    with pytest.raises(AssertionError, match="PHYSICS REJECT"):
        bench._check_anchor("cavity", 64, 40,
                            {"psi_min": float("nan"), "psi_l2": 5e-4})


def test_worker_physics_gate_end_to_end(tmp_path, monkeypatch):
    """A corrupted variant CANNOT post a number: with a tampered anchor
    standing in for a wrong-physics variant, the worker subprocess dies
    with PHYSICS REJECT and race() records an error for it.  With the committed anchor the same run passes."""
    # committed anchor: the true fp32 trajectory passes the gate
    ok = bench.worker_cavity("fst,highest", 64, 20)
    assert ok[1]["physics"] == "ok"

    # tampered anchor (= a variant whose physics drifted 10%): reject
    tampered = dict(json.load(open(ROOT / "benchmarks" /
                                   "physics_anchors.json")))
    tampered["cavity:64:40"] = {
        **tampered["cavity:64:40"],
        "psi_min": tampered["cavity:64:40"]["psi_min"] * 1.10}
    p = tmp_path / "tampered.json"
    p.write_text(json.dumps(tampered))
    monkeypatch.setattr(bench, "ANCHORS_JSON", str(p))
    with pytest.raises(AssertionError, match="PHYSICS REJECT"):
        bench.worker_cavity("fst,highest", 64, 20)

    # end-to-end through the race: the subprocess inherits the tampered
    # anchors via CFD_BENCH_ANCHORS and the variant is skipped
    monkeypatch.setenv("CFD_BENCH_ANCHORS", str(p))
    results = []
    best, name = bench.race("cavity", ["fst,highest"], 64, steps=20,
                            variant_timeout_s=280.0, results=results)
    assert best is None and name is None
    assert len(results) == 1 and "PHYSICS REJECT" in results[0]["error"]


def test_worker_mg_subprocess_contract():
    r = subprocess.run(
        [sys.executable, str(ROOT / "bench.py"), "--worker", "mg",
         "--variant", "matmul,plain", "--nx", "64", "--tol", "1e-5"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-800:]
    out = _last_json_line(r.stdout)
    assert out["unit"] == "s" and out["value"] > 0 and out["cycles"] >= 1


def test_worker_mg_rejects_self_certifying_solver(monkeypatch):
    """worker_mg's independent residual recheck: a solver that lies
    about its own rms (returns the INITIAL guess with a tiny reported
    residual) must be rejected, because the worker re-derives the
    residual with plain stencil ops outside the solver's code path."""
    import types

    from cfd_julia_tpu.poisson import multigrid

    real_solve = multigrid.solve

    def lying_solve(f, u0, dx, dy, cfg=None):
        r = real_solve(f, u0, dx, dy, cfg=cfg)
        # claim convergence but hand back the unconverged initial guess
        return types.SimpleNamespace(u=u0, rms=r.rms0 * 1e-9, rms0=r.rms0,
                                     iterations=r.iterations)

    monkeypatch.setattr(multigrid, "solve", lying_solve)
    with pytest.raises(AssertionError, match="PHYSICS REJECT mg"):
        bench.worker_mg("matmul,plain", 64, 1e-5)


def test_probe_devices_reports_the_device():
    """The device probe runs once, in a subprocess, and names the device
    (platform, kind, count) — here the CPU the suite runs on."""
    dev = bench._probe_devices(timeout_s=120)
    assert dev["platform"] == "cpu" and dev["device_count"] >= 1
    assert "device_kind" in dev


def test_main_exits_nonzero_without_gpu(monkeypatch, capsys):
    """No GPU: an error record and exit 1, never a number."""
    monkeypatch.setattr(bench, "_probe_devices", lambda *a, **k: {
        "platform": "cpu", "device_kind": "cpu", "device_count": 1})
    monkeypatch.setattr(bench, "race", lambda *a, **k: pytest.fail(
        "raced without a GPU"))
    assert bench.main([]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["value"] == 0.0 and "no GPU" in out["error"]
    monkeypatch.setattr(bench, "_probe_devices", lambda *a, **k: None)
    assert bench.main([]) == 1


def test_main_exits_nonzero_when_every_variant_fails(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_probe_devices", lambda *a, **k: {
        "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "device_count": 1})
    monkeypatch.setattr(bench, "_nvidia_smi", lambda: None)
    monkeypatch.setattr(bench, "race", lambda *a, **k: (None, None))
    assert bench.main([]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "every cavity variant failed" in out["error"]


def test_race_no_success_guard_bounds_total_failure(monkeypatch):
    """A family whose every variant hangs to its timeout must not chew
    through all variants' full timeouts: with zero successes the race
    stops at 2x budget."""
    clock = {"t": 0.0}
    calls = []

    def fake_spawn(worker, v, nx, steps, tol, timeout_s):
        calls.append(v)
        clock["t"] += 400.0
        return {"worker": worker, "variant": v, "error": "TIMEOUT 400s"}

    monkeypatch.setattr(bench, "_spawn_variant", fake_spawn)
    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock["t"])
    best, name = bench.race("cavity", [f"v{i},highest,xla" for i in range(9)],
                            1024, steps=10, budget_s=500.0)
    assert best is None and name is None
    assert len(calls) == 3  # elapsed 0, 400, 800 spawn; 1200 > 2x500 stops


def test_race_post_success_budget(monkeypatch):
    """After one measured variant the budget drops to 1x: the best-so-far
    is emitted instead of racing every cold compile."""
    clock = {"t": 0.0}

    def fake_spawn(worker, v, nx, steps, tol, timeout_s):
        clock["t"] += 400.0
        return {"worker": worker, "variant": v, "value": 100.0,
                "unit": "steps/s"}

    monkeypatch.setattr(bench, "_spawn_variant", fake_spawn)
    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock["t"])
    best, name = bench.race("cavity", [f"v{i},highest,xla" for i in range(9)],
                            1024, steps=10, budget_s=500.0)
    assert best == 100.0
    assert clock["t"] == 800.0  # two spawns, then 800 > 500 stops


def test_final_stdout_line_is_complete_battery_json(monkeypatch, tmp_path,
                                                    capsys):
    """The LAST stdout line of a full run parses as JSON and carries the
    headline value, the ps23 and mg secondaries, their vs_baselines, the
    coverage rows and the device it ran on."""
    monkeypatch.setattr(bench, "_probe_devices", lambda *a, **k: {
        "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "device_count": 1})
    monkeypatch.setattr(bench, "_nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")

    def fake_race(worker, variants, nx, steps=0, tol=0.0, budget_s=0.0,
                  variant_timeout_s=0.0, minimize=False, results=None):
        if minimize:
            return 0.11, variants[0]
        return (1303.0, "matmul_bf16x1") if worker == "cavity" \
            else (179.3, "matmul:high")

    monkeypatch.setattr(bench, "race", fake_race)

    def fake_coverage(summary, all_results, timeout_s, budget_s=0.0):
        summary["coverage_euler_hllc_xla_8192"] = 9000.0

    monkeypatch.setattr(bench, "run_coverage", fake_coverage)
    assert bench.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(last)       # the LAST line parses, full stop
    assert out["final"] is True
    assert out["metric"] == "cavity_1024_steps_per_sec"
    assert out["value"] == 1303.0 and out["vs_baseline"] == 130.3
    assert out["ps23_2048_steps_per_sec"] == 179.3
    assert out["ps23_vs_baseline"] == round(179.3 / 0.47, 1)
    assert out["mg_4096_solve_s"] == 0.11
    assert out["mg_vs_baseline"] == round(3.68 / 0.11, 1)
    # the record's precision tier is explicit
    assert out["precision_tier"] == "bf16-1pass"
    assert out["ps23_precision_tier"] == "bf16-3pass"
    # coverage rows ride the final line too
    assert out["coverage_euler_hllc_xla_8192"] == 9000.0
    # the device it ran on
    assert out["platform"] == "gpu" and out["device_count"] == 1
    assert out["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert out["nvidia_smi"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert "xla_flags" in out


def test_variant_names():
    assert bench._variant_name("cavity", "fst", "highest", "xla") == "fst"
    assert bench._variant_name("cavity", "fst_half_mxu", "high") == \
        "fst_half_mxu:high"
    assert bench._variant_name("ps23", "xla", "highest", "pack") == "xla"
    assert bench._variant_name("ps23", "matmul", "high", "rowsfirst") == \
        "matmul:high+rowsfirst"


def test_max_variants_caps_every_family(monkeypatch, tmp_path, capsys):
    """--max-variants 1 races exactly the first variant per family."""
    monkeypatch.setattr(bench, "_probe_devices", lambda *a, **k: {
        "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "device_count": 1})
    monkeypatch.setattr(bench, "_nvidia_smi", lambda: None)
    raced = {}

    def fake_race(worker, variants, nx, steps=0, tol=0.0, budget_s=0.0,
                  variant_timeout_s=0.0, minimize=False, results=None):
        raced[worker] = variants
        return (0.5, variants[0]) if minimize else (100.0, variants[0])

    monkeypatch.setattr(bench, "race", fake_race)
    assert bench.main(["--max-variants", "1"]) == 0
    assert raced["cavity"] == ("fused_bf16x1,highest",)
    assert raced["ps23"] == ("matmul,high,pack",)
    assert raced["mg"] == ("matmul,plain",)
    out = capsys.readouterr().out
    assert '"value": 100.0' in out
