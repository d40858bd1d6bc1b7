"""Device-resident time loops.

The reference's `for k in 2:nt+1` host loops (with per-step Julia dispatch
and, in ch. 01-04, a full time-history array `un[(nx+1)x(nt+1)]`,
ftcs.jl:21) become `lax.scan` over a pure step function: the whole
integration compiles to one XLA program with **zero host round-trips per
step**. Snapshot histories stack as scan outputs, device-resident, dumped
once at the end (replacing mid-loop text writes like vm.jl:78-86).
"""
from __future__ import annotations

from functools import partial

import jax
from jax import lax


@partial(jax.jit, static_argnames=("step_fn", "nt"))
def run_steps(step_fn, state, nt: int):
    """Advance `state` by nt applications of step_fn(state) -> state."""
    def body(s, _):
        return step_fn(s), None

    final, _ = lax.scan(body, state, None, length=nt)
    return final


@partial(jax.jit, static_argnames=("step_fn", "chunk"))
def run_steps_dynamic(step_fn, state, n_chunks, chunk: int):
    """Advance `state` by n_chunks * chunk steps with n_chunks a RUNTIME
    scalar: the inner chunk is a static `lax.scan`, the outer trip count
    a traced `fori_loop`, so ONE compiled executable serves every window
    length that is a multiple of `chunk` (identical trajectory to
    run_steps(step_fn, state, n_chunks*chunk)).

    Built for bench.py, where compiles are the cost to save: the quick tier's 50-step windows and the
    full tier's 1000-step windows hash to the SAME program, so the
    persistent compile cache serves the second tier for free.  Loop
    overhead is one while-iteration per `chunk` steps (<0.1%)."""
    def inner(_, s):
        def body(ss, __):
            return step_fn(ss), None

        s, _ = lax.scan(body, s, None, length=chunk)
        return s

    return lax.fori_loop(0, n_chunks, inner, state)


def run_steps_with_checkpoints(step_fn, state, nt: int, every: int,
                               path: str, start_step: int = 0):
    """Advance nt steps, saving a resumable on-disk checkpoint every
    `every` steps (crash recovery — a capability the reference lacks,
    SURVEY §5). Device-resident within each chunk; one host sync per
    checkpoint. Resume with utils.checkpoint.load_state + this function."""
    from cfd_julia_tpu.utils import checkpoint

    done = 0
    while done < nt:
        chunk = min(every, nt - done)
        state = run_steps(step_fn, state, chunk)
        done += chunk
        jax.block_until_ready(state)
        checkpoint.save_state(path, state, step=start_step + done)
    return state


@partial(jax.jit, static_argnames=("step_fn", "nt", "every", "observe"))
def run_steps_with_snapshots(step_fn, state, nt: int, every: int, observe=None):
    """Advance nt steps, stacking `observe(state)` every `every` steps.

    Returns (final_state, snapshots) where snapshots has a leading axis of
    length nt // every (snapshot AFTER steps every, 2*every, ...). `observe`
    defaults to identity (full state snapshot).
    """
    obs = observe or (lambda s: s)
    n_chunks = nt // every
    rem = nt - n_chunks * every

    def chunk(s, _):
        def body(ss, _):
            return step_fn(ss), None

        s, _ = lax.scan(body, s, None, length=every)
        return s, obs(s)

    state, snaps = lax.scan(chunk, state, None, length=n_chunks)
    for _ in range(rem):
        state = step_fn(state)
    return state, snaps
