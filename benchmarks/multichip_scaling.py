"""Multi-device scaling harness: times the sharded cavity and spectral
vortex steps on an n-device mesh vs the single-device step.

Rehearse on virtual CPU devices (not a speed measurement):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python benchmarks/multichip_scaling.py --nx 256 --devices 1,2,4

One JSON line per (problem, n_devices), naming the device it ran on.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from jax import lax

from cfd_julia_tpu.jaxconfig import configure_cache, pin_platform

pin_platform()
configure_cache()


def timed(name, fn, x, iters=20, repeats=3):
    """ms per application of fn: `iters` applications under one scan,
    median of `repeats` windows, each ended by block_until_ready."""
    run = jax.jit(lambda x0: lax.scan(lambda c, _: (fn(c), None), x0,
                                      None, length=iters)[0])
    x = jax.block_until_ready(run(x))           # compile + warm up
    windows = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        x = jax.block_until_ready(run(x))
        windows.append(time.perf_counter() - t0)
    windows.sort()
    dev = jax.devices()[0]
    print(json.dumps({"name": name, "ms_per_step":
                      1e3 * windows[len(windows) // 2] / iters,
                      "platform": dev.platform, "kind": dev.device_kind}),
          flush=True)


def bench_point(nx: int, ndev: int):
    from cfd_julia_tpu.models import cavity, vortex
    from cfd_julia_tpu.parallel import mesh as mesh_lib, sharded

    devices = jax.devices()[:ndev]
    mesh = mesh_lib.make_mesh(devices)

    cfg = cavity.CavityConfig(nx=nx, ny=nx, dt=2e-5)
    step = sharded.make_sharded_cavity_step(cfg, mesh)
    w0 = sharded.place(
        sharded.pad_to_mesh(jnp.zeros((nx + 1, nx + 1), jnp.float32), mesh),
        mesh)
    st = (w0, jnp.zeros_like(w0), jnp.zeros((), jnp.float32))
    timed(f"sharded_cavity_{nx}_dev{ndev}", step, st)

    from cfd_julia_tpu.ops import spectral

    vcfg = vortex.VortexConfig(nx=nx, ny=nx, solver="ps23", dt=1e-3)
    vstep = sharded.make_sharded_vortex_step(vcfg, mesh, jnp.float32)
    hf0 = jax.device_put(
        jax.jit(lambda w: spectral.pack_c(
            jnp.fft.fft2(w.astype(jnp.complex64))))(
            vortex.initial_vorticity(vcfg, jnp.float32)),
        sharded.packed_full_sharding(mesh))
    timed(f"sharded_ps23_{nx}_dev{ndev}", vstep, hf0)

    # the half-spectrum packed fast path
    hstep = sharded.make_sharded_vortex_step_half(vcfg, mesh, jnp.float32)
    h0 = jax.device_put(
        jax.jit(vortex.half_init_packed)(
            vortex.initial_vorticity(vcfg, jnp.float32)),
        sharded.packed_half_sharding(mesh))
    timed(f"sharded_ps23_half_{nx}_dev{ndev}", hstep, h0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--devices", default="1,2,4")
    args = ap.parse_args()
    avail = len(jax.devices())
    print(f"# {avail} devices ({jax.devices()[0].platform})",
          file=sys.stderr)
    for nd in (int(v) for v in args.devices.split(",")):
        if nd > avail:
            print(f"# skipping n={nd} (> {avail} available)",
                  file=sys.stderr)
            continue
        bench_point(args.nx, nd)


if __name__ == "__main__":
    main()
