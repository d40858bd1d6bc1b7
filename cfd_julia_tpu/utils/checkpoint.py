"""Checkpoint / resume — a new (cheap) capability the reference lacks
(SURVEY §5: "no restart capability" in the reference; solution snapshots
only). Any pytree-of-arrays solver state saves to a single .npz and
restores exactly; solvers are pure step functions, so resume is just
"load state, keep stepping".

Two backends:
* save_state/load_state — single-host .npz (gathers to host). Right for
  single-chip runs and small states.
* save_sharded/load_sharded — orbax PyTree checkpointing. Sharded
  multi-chip states save WITHOUT a host gather (each device writes its
  own shards) and restore directly into the given shardings — the
  path for large distributed fields.
"""
from __future__ import annotations

import os

import jax
import numpy as np


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' to suffix-less paths; normalize so
    save/load/exists all agree on ONE on-disk name."""
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state, step: int | None = None):
    """Save a pytree of arrays to .npz (flattened with treedef repr).

    ATOMIC: writes a temp file in the same directory and os.replace()s
    it over the target — a crash mid-save (the exact scenario this
    feature recovers from) must never destroy the previous good
    checkpoint."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    payload = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    payload["__treedef__"] = np.asarray(str(treedef))
    if step is not None:
        payload["__step__"] = np.asarray(step)
    path = _npz_path(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def exists(path: str) -> bool:
    """True if a save_state checkpoint exists at (the normalized) path."""
    return os.path.exists(_npz_path(path))


def load_state(path: str, like):
    """Restore a pytree saved by save_state; `like` supplies the treedef.

    Returns (state, step) where step is None if it was not recorded."""
    data = np.load(_npz_path(path), allow_pickle=False)
    _, treedef = jax.tree_util.tree_flatten(like)
    n = len([k for k in data.files if k.startswith("leaf_")])
    leaves = [jax.numpy.asarray(data[f"leaf_{i}"]) for i in range(n)]
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    step = int(data["__step__"]) if "__step__" in data.files else None
    return state, step


def save_sharded(path: str, state):
    """Save a (possibly sharded) pytree with orbax: on a multi-device
    mesh every device writes its own array shards — no host gather, no
    single-host memory spike.  `path` is a checkpoint DIRECTORY."""
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path), state, force=True)


def load_sharded(path: str, like):
    """Restore an orbax checkpoint directly into `like`'s structure,
    dtypes, AND shardings (abstract template — sharded arrays
    materialize already distributed, never resident on one host)."""
    import orbax.checkpoint as ocp

    template = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=a.sharding)
        if isinstance(a, jax.Array) else a, like)
    with ocp.PyTreeCheckpointer() as ckptr:
        return ckptr.restore(os.path.abspath(path),
                             restore_args=ocp.checkpoint_utils.
                             construct_restore_args(template))
