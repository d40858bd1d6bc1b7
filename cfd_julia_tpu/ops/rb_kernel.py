"""One red-black Gauss-Seidel sweep as a single Pallas kernel (Triton route).

The XLA form (poisson.iterative.redblack_sweep) makes two masked
half-sweep passes and reads the checkerboard mask arrays, so one sweep
moves u four times and f twice through device memory.  Here each program
owns one (br, bc) tile of the output and computes it in one launch:

* it loads the radius-2 footprint of u and the radius-1 footprint of f
  around its tile, from global memory (13 shifted u blocks and 5 shifted
  f blocks; neighbouring blocks overlap, so the repeats hit the cache);
* it evaluates the red half-update on the tile plus a one-cell ring, so
  every black point of the tile sees its freshly updated red neighbours
  without any exchange between programs;
* it writes the tile once, to a separate output buffer: neighbouring
  programs still read the old u.

Interior and colour masks come from iota of global indices; no mask
arrays are read.  Loads use clamped global indices, so no access leaves
the array: a clamped value only ever feeds a point outside the domain or
on its boundary ring, and those are never updated.

The kernel compiles for the GPU only.  `interpret=True` runs it through
the Pallas interpreter (the CPU tests); any other platform raises.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# the 13-point radius-2 diamond of u offsets that the tile + ring needs
_U_OFFSETS = tuple((di, dj) for di in range(-2, 3) for dj in range(-2, 3)
                   if abs(di) + abs(dj) <= 2)
_RING = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))


def _rb_sweep_kernel(u_ref, f_ref, o_ref, *, n_rows, n_cols, br, bc,
                     dx2i, dy2i):
    rows = pl.program_id(0) * br + jax.lax.broadcasted_iota(
        jnp.int32, (br, bc), 0)
    cols = pl.program_id(1) * bc + jax.lax.broadcasted_iota(
        jnp.int32, (br, bc), 1)

    def load(ref, di, dj):
        ri = jnp.clip(rows + di, 0, n_rows - 1)
        ci = jnp.clip(cols + dj, 0, n_cols - 1)
        return plgpu.load(ref.at[ri, ci])

    u = {o: load(u_ref, *o) for o in _U_OFFSETS}
    diag = -2.0 * dx2i - 2.0 * dy2i

    def interior(di, dj):
        r, c = rows + di, cols + dj
        return (r > 0) & (r < n_rows - 1) & (c > 0) & (c < n_cols - 1)

    def lap(v, di, dj):
        """5-point Laplacian at offset (di, dj), same operation order as
        ops.arakawa.laplacian."""
        return ((v[(di + 1, dj)] - 2.0 * v[(di, dj)] + v[(di - 1, dj)]) * dx2i
                + (v[(di, dj + 1)] - 2.0 * v[(di, dj)] + v[(di, dj - 1)])
                * dy2i)

    # red half-update on the tile and its one-cell ring
    red = {}
    for di, dj in _RING:
        is_red = interior(di, dj) & ((rows + di + cols + dj) % 2 == 0)
        r = load(f_ref, di, dj) - lap(u, di, dj)
        red[(di, dj)] = u[(di, dj)] + jnp.where(is_red, r, 0.0) / diag
    # black half-update on the tile, from the fresh red values
    is_black = interior(0, 0) & ((rows + cols) % 2 == 1)
    r = load(f_ref, 0, 0) - lap(red, 0, 0)
    out = red[(0, 0)] + jnp.where(is_black, r, 0.0) / diag
    inside = (rows < n_rows) & (cols < n_cols)
    plgpu.store(o_ref.at[pl.ds(pl.program_id(0) * br, br),
                         pl.ds(pl.program_id(1) * bc, bc)],
                out.astype(o_ref.dtype), mask=inside)


@functools.partial(jax.jit, static_argnames=(
    "dx", "dy", "block", "num_warps", "interpret"))
def redblack_sweep(u, f, dx: float, dy: float, block=(8, 128),
                   num_warps: int = 4, interpret: bool = False):
    """One full red-black GS sweep; matches iterating
    poisson.iterative.redblack_sweep (Dirichlet boundary ring kept).

    block = (rows, cols) of one program's tile, powers of two; the
    default is the fastest of the shapes timed at 4096^2 on an H100
    (PERF.md)."""
    if not interpret and jax.devices()[0].platform != "gpu":
        raise ValueError(
            "rb_kernel.redblack_sweep compiles for the GPU only; pass "
            "interpret=True to run it through the Pallas interpreter")
    n_rows, n_cols = u.shape
    br, bc = block
    kernel = functools.partial(
        _rb_sweep_kernel, n_rows=n_rows, n_cols=n_cols, br=br, bc=bc,
        dx2i=1.0 / dx**2, dy2i=1.0 / dy**2)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(u.shape, u.dtype),
        grid=(pl.cdiv(n_rows, br), pl.cdiv(n_cols, bc)),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="rb_sweep",
    )(u, f)


def redblack_sweeps(u, f, dx: float, dy: float, iters: int, **kw):
    """`iters` sweeps, one launch each."""
    return jax.lax.fori_loop(
        0, iters, lambda _, uu: redblack_sweep(uu, f, dx, dy, **kw), u)
