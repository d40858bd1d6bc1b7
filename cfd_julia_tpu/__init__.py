"""cfd_julia_tpu — a CFD simulation engine built on JAX/XLA.

A ground-up, accelerator-first re-design of the capability surface of the CFD_Julia
coursework collection (22 solver scripts, reference: t-bltg/CFD_Julia):

* 1D parabolic:   heat equation — FTCS, SSP-RK3, Crank–Nicolson, implicit
                  compact Padé (reference ch. 01–04).
* 1D hyperbolic:  inviscid Burgers — WENO-5 / CRWENO-5 reconstruction,
                  Lax–Friedrichs flux splitting, Rusanov Riemann form
                  (reference ch. 05–08).
* 1D systems:     Euler Sod shock tube — WENO-5 + RK3 with Roe / HLLC /
                  Rusanov Riemann solvers (reference ch. 09–11).
* 2D elliptic:    Poisson — FFT (FDM + spectral eigenvalues), fast sine
                  transform (DST-I), Jacobi, red-black Gauss–Seidel,
                  conjugate gradient, V-cycle multigrid (reference ch. 12–17).
* 2D Navier–Stokes (vorticity–streamfunction): lid-driven cavity
                  (Arakawa + FST + RK3), vortex merger / Taylor–Green
                  (Arakawa + FFT + RK3), hybrid semi-implicit RK3/CN,
                  pseudospectral with 3/2- and 2/3-rule dealiasing
                  (reference ch. 18–22).

Design principles (data-parallel first, not a translation):

* Everything device-resident: time loops are `lax.scan` / `lax.while_loop`
  with zero host round-trips per step; snapshots stack as scan outputs.
* Sequential reference algorithms become data-parallel ones: Thomas
  tridiagonal sweeps -> batched parallel cyclic reduction; lexicographic
  Gauss–Seidel -> red-black relaxation; `@unroll` loops -> fused array ops.
* FFTW r2r (DST-I) -> odd-extension `rfft` (XLA has no r2r transforms).
* Static shapes throughout; multigrid pyramids are statically unrolled.
* fp32 by default on the GPU, fp64 toggle for accuracy parity (`precision`).
* Multi-chip scaling by 2D domain decomposition over a `jax.sharding.Mesh`
  (halo exchange for stencils, transpose-based distributed FFT), in
  `cfd_julia_tpu.parallel`.
"""

__version__ = "0.1.0"

from cfd_julia_tpu.core.grid import Grid1D, Grid2D  # noqa: F401
from cfd_julia_tpu.core import precision  # noqa: F401
