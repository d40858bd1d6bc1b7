"""Device-mesh construction for 2D domain decomposition.

The reference is single-process (SURVEY.md §2.5: no DP/TP/PP/SP, no
NCCL/MPI); the scaling story here is spatial domain decomposition of
the field arrays over a 2D `jax.sharding.Mesh` ("x", "y"), with XLA
collectives (NVLink on a GPU host): halo exchanges for stencils, transposes for FFTs.
"""
from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def factor_2d(n: int) -> tuple[int, int]:
    """Near-square factorization of n devices into (px, py)."""
    px = int(math.isqrt(n))
    while n % px:
        px -= 1
    return px, n // px


def make_mesh(devices=None, axis_names=("x", "y")) -> Mesh:
    """Build a 2D mesh over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    px, py = factor_2d(len(devices))
    arr = np.asarray(devices).reshape(px, py)
    return Mesh(arr, axis_names)


def field_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a 2D field (x-major) over the full mesh."""
    return NamedSharding(mesh, P(*mesh.axis_names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
