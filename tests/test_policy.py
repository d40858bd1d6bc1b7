"""The one per-platform auto policy, the precision tiers, the compile-cache
rule and chip_smoke.py's behaviour off the GPU."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_julia_tpu import policy
from cfd_julia_tpu.core import precision
from cfd_julia_tpu.models import cavity, vortex
from cfd_julia_tpu.poisson import multigrid

ROOT = pathlib.Path(__file__).parent.parent
KEYS = sorted(policy.POLICY["cpu"])

# ------------------------------------------------------------- policy


@pytest.mark.parametrize("platform_name", ["cpu", "gpu"])
@pytest.mark.parametrize("key", KEYS)
def test_policy_entry_per_platform(platform_name, key):
    """Every key exists for both platforms and names an option the
    resolvers accept."""
    allowed = {
        "cavity_poisson": {"fst", "fst_half", "matmul", "matmul_bf16x3",
                           "matmul_bf16x1", "fst_mxu", "fst_half_mxu"},
        "cavity_solve_poisson": {"fst", "fst_half", "matmul",
                                 "matmul_bf16x3", "matmul_bf16x1", "fused",
                                 "fused_bf16x3", "fused_bf16x1"},
        "vortex_fft_impl": {"xla", "matmul"},
        "fft_precision": set(precision.TIERS),
        "mg_transfers": {"conv", "matmul", "reshape"},
        "mg_smoother": {"xla", "triton", "cheb"},
    }
    v = policy.choice(key, platform_name)
    if key == "mg_kernel_min":
        assert isinstance(v, int) and v > 0
    else:
        assert v in allowed[key], (key, v)


def test_policy_unknown_platform_raises():
    with pytest.raises(ValueError, match="no auto policy"):
        policy.choice("mg_smoother", "metal")
    with pytest.raises(ValueError, match="no auto policy"):
        cavity._poisson_choice("auto", "rocm")


def test_policy_platform_is_device_zero():
    assert policy.platform() == jax.devices()[0].platform == "cpu"


def test_resolvers_read_the_table(monkeypatch):
    """cavity, vortex and multigrid resolve `auto` from the table and
    pass explicit names through."""
    monkeypatch.setitem(policy.POLICY["cpu"], "cavity_poisson", "matmul")
    monkeypatch.setitem(policy.POLICY["cpu"], "vortex_fft_impl", "matmul")
    monkeypatch.setitem(policy.POLICY["cpu"], "fft_precision", "high")
    monkeypatch.setitem(policy.POLICY["cpu"], "mg_transfers", "reshape")
    assert cavity._poisson_choice("auto") == "matmul"
    assert cavity._poisson_choice("auto", single_device=False) == "fst"
    assert cavity._poisson_choice("fst_half") == "fst_half"
    r = vortex._resolved(vortex.VortexConfig(solver="ps23"))
    assert (r.fft_impl, r.fft_precision) == ("matmul", "high")
    assert vortex._resolved(vortex.VortexConfig(),
                            single_device=False).fft_impl == "xla"
    assert multigrid._transfers_choice("auto") == "reshape"
    assert multigrid._transfers_choice("conv") == "conv"


def test_mg_smoother_policy_and_kernel_threshold(monkeypatch):
    assert multigrid._pick_smoother(4096, 4096) == \
        policy.choice("mg_smoother")
    assert multigrid._pick_smoother(64, 64, "cheb") == "cheb"
    monkeypatch.setitem(policy.POLICY["gpu"], "mg_smoother", "triton")
    small = policy.choice("mg_kernel_min", "gpu") // 2
    assert multigrid._pick_smoother(4096, 4096, platform="gpu") == "triton"
    assert multigrid._pick_smoother(small, small, platform="gpu") == "xla"
    # auto sends only fp32 levels to the kernel; an explicit name is kept
    for dt in (jnp.float64, jnp.bfloat16):
        assert multigrid._pick_smoother(4096, 4096, platform="gpu",
                                        dtype=dt) == "xla"
        assert multigrid._pick_smoother(4096, 4096, "triton", platform="gpu",
                                        dtype=dt) == "triton"


# ------------------------------------------------------ precision tiers

@pytest.mark.parametrize("tier,preset", [
    ("highest", "F32_F32_F32"), ("high", "BF16_BF16_F32_X3"),
    ("default", "BF16_BF16_F32")])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.complex64])
def test_tier_maps_to_preset(tier, preset, dtype):
    assert precision.dot_algorithm(tier, dtype).name == preset


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.complex128])
def test_fp64_operands_stay_fp64(dtype):
    for tier in precision.TIERS:
        assert precision.dot_algorithm(tier, dtype).name == "F64_F64_F64"


def test_unknown_tier_raises():
    with pytest.raises(ValueError, match="unknown precision tier"):
        precision.dot_algorithm("tf32", jnp.float32)


@pytest.mark.parametrize("tier", list(precision.TIERS))
def test_tier_complex_products_exact_in_fp64(tier):
    """Complex products go through four real products: exact to fp64
    roundoff at fp64, for every tier, in matmul and einsum form."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 8)) + 1j * rng.standard_normal((16, 8))
    b = rng.standard_normal((8, 4)) + 1j * rng.standard_normal((8, 4))
    r = rng.standard_normal((8, 4))
    np.testing.assert_allclose(
        np.asarray(precision.matmul(jnp.asarray(a), jnp.asarray(b), tier)),
        a @ b, rtol=1e-13)
    np.testing.assert_allclose(
        np.asarray(precision.einsum("ij,jk->ik", jnp.asarray(a),
                                    jnp.asarray(r), tier)),
        a @ r, rtol=1e-13)
    np.testing.assert_allclose(
        np.asarray(precision.einsum("ij,jk->ik", jnp.asarray(r.T),
                                    jnp.asarray(b), tier)),
        r.T @ b, rtol=1e-13)


@pytest.mark.parametrize("tier", list(precision.TIERS))
def test_check_tier_compiles_on_this_backend(tier):
    assert precision.check_tier(tier, jnp.float32, n=64) < 1e-2
    assert precision.check_tier(tier, jnp.complex64, n=64) < 1e-2


# ------------------------------------------------------- compile cache

_CACHE_PROBE = (
    "import sys; sys.path.insert(0, {root!r})\n"
    "from cfd_julia_tpu.jaxconfig import configure_cache\n"
    "print(configure_cache())\n")


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_rule(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that directory and no other;
    unset: the fixed <checkout>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(ROOT / ".jax_cache")
    if env_dir:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    r = subprocess.run([sys.executable, "-c",
                        _CACHE_PROBE.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.strip().splitlines()[-1] == want


# ---------------------------------------------------------- chip_smoke

def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


def test_chip_smoke_exits_nonzero_without_gpu():
    r = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    r = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _smoke_module():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("phase", ["tiers", "cavity", "vortex", "euler",
                                   "crweno", "multigrid"])
def test_chip_smoke_phase_rehearsal(phase):
    """Each one-card phase runs end to end on the CPU at tiny sizes (the
    anchored 64^2 cavity / ps23 points are checked against their fp64
    anchors; the rest for finiteness)."""
    cs = _smoke_module()
    with precision.x64(False):
        rec = cs.PHASES[phase](cs.TINY)
    json.dumps(rec)     # every record is printable as one JSON line
    assert rec


def test_chip_smoke_compare_rejects_deviation():
    cs = _smoke_module()
    ok = cs.compare("cavity:64:40", {"psi_min": -0.0013792607425738,
                                     "psi_l2": 0.000504300395676472},
                    cs.TOL_FP32_CAVITY)
    assert ok["max_rel_dev"] == 0.0
    with pytest.raises(cs.PhaseFailure):
        cs.compare("cavity:64:40", {"psi_min": -0.0014,
                                    "psi_l2": 0.000504300395676472},
                   cs.TOL_FP32_CAVITY)
    with pytest.raises(cs.PhaseFailure):
        cs.compare("cavity:64:40", {"psi_min": float("nan"),
                                    "psi_l2": 0.000504300395676472},
                   cs.TOL_FP32_CAVITY)


def test_chip_smoke_four_card_rehearsal_on_cpu_mesh():
    """The --four phases on the suite's virtual CPU devices at tiny
    sizes: every mesh path agrees with its one-device run."""
    cs = _smoke_module()
    assert len(jax.devices()) >= 4
    with precision.x64(False):
        out = cs.four_card_phases(cs.FOUR_TINY)
    assert set(out) == {"cavity_fst_mesh", "cavity_padded_sharded",
                        "ps23_half_sharded", "halo_rhs", "mg_mesh"}
