"""Cavity step sharded over a 2D device mesh (domain decomposition).

On a CPU host, emulate 8 chips:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip_cavity.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from cfd_julia_tpu.jaxconfig import configure_cache, pin_platform

pin_platform()  # honor a user-set JAX_PLATFORMS
configure_cache()

from cfd_julia_tpu.models import cavity
from cfd_julia_tpu.parallel import mesh as mesh_lib, sharded

mesh = mesh_lib.make_mesh()
print("mesh:", dict(zip(mesh.axis_names, mesh.devices.shape)))

cfg = cavity.CavityConfig(nx=64, ny=64)
step = sharded.make_sharded_cavity_step(cfg, mesh)
w0 = sharded.pad_to_mesh(jnp.zeros((65, 65), jnp.float32), mesh)
state = (sharded.place(w0, mesh), sharded.place(jnp.zeros_like(w0), mesh),
         jnp.zeros((), jnp.float32))
for k in range(100):
    state = step(state)
    # block per step: XLA:CPU's emulated collectives crash with ~100
    # unsynced executions in flight (the device runs fully async)
    jax.block_until_ready(state)
print("100 sharded steps done; ||dpsi|| =", float(state[2]))
print("w sharding:", state[0].sharding)
