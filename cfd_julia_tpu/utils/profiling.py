"""Timing + profiling helpers — the replacements for the reference's
`@time`/`@timed`/`@btime` wall-clock macros (SURVEY §5: ftcs.jl:34,
fft_p.jl:90-92, rk3.jl:80-84).

`steps_per_second` times a device-resident lax.scan window with a forced
host sync (a scalar pulled to the host ends the window). `trace` wraps jax.profiler for TensorBoard-viewable traces.
"""
from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp


def _sync(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    for l in leaves:
        if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.complexfloating):
            float(jnp.abs(l).sum())
        else:
            float(jnp.asarray(l).sum())


def steps_per_second(step_fn, state, steps: int = 100, repeats: int = 1):
    """Throughput of `step_fn` over a compiled scan window of `steps`."""
    from cfd_julia_tpu.stepping import loop

    run = jax.jit(lambda s: loop.run_steps(step_fn, s, steps))
    state = run(state)  # compile + warm up
    _sync(state)
    best = 0.0
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        state = run(state)
        _sync(state)
        best = max(best, steps / (time.perf_counter() - t0))
    return best, state


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timer(label: str = "", sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"{label} {time.perf_counter() - t0:.4f}s")
