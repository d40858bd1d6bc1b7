"""Test configuration.

Default: the CPU backend with 8 virtual devices, so the multi-device paths
in cfd_julia_tpu.parallel compile and execute without hardware, and fp64
enabled for accuracy parity with the Float64 reference.

GPU tier: `CFD_TEST_GPU=1 python -m pytest -m gpu tests/test_gpu.py` keeps
JAX's default backend (the card) in fp32.  Tests marked `gpu` take the
`gpu` fixture, which skips them inside the test when JAX finds no GPU;
which tests exist never depends on the machine.
"""
import hashlib
import os

import pytest

ON_GPU = os.environ.get("CFD_TEST_GPU") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

from cfd_julia_tpu.jaxconfig import configure_cache  # noqa: E402


def _host_cache_key() -> str:
    """Short fingerprint of this host's CPU feature set.  XLA:CPU caches
    AOT-compiled executables keyed only by the computation, so a cache
    read on a host with other vector extensions could hold code this host
    cannot run: the CPU suite's cache directory is keyed by the features."""
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    if not feats:
        import platform as _platform

        feats = f"{_platform.machine()}-{_platform.processor()}"
    return hashlib.sha1(feats.encode()).hexdigest()[:10]


# Compiles dominate test runtime (execution is microseconds/step); the
# persistent cache is keyed on HLO so repeated pytest runs skip XLA
# compilation.  The GPU tier uses the program's own cache rule.
if ON_GPU:
    configure_cache()
else:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.expanduser("~/.cache/jax_test_cache"),
                     f"host-{_host_cache_key()}"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="session")
def gpu():
    """The GPU device; skips the test when JAX runs on anything else."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run CFD_TEST_GPU=1 python -m pytest "
                    "-m gpu tests/test_gpu.py on a machine with a card")
    return dev
