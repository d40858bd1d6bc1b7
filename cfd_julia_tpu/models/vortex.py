"""Periodic 2D NS (vorticity-streamfunction): vortex merger and
Taylor-Green vortex — four solver formulations (reference ch. 19-22).

* ``fdm``     Arakawa + FFT Poisson + SSP-RK3, all physical space
              (19_.../vm.jl + Common.vm_rhs). State: vorticity w (nx, ny).
* ``hybrid``  Arakawa Jacobian in physical space via FFT round trips,
              diffusion integrated semi-implicitly in Fourier space with a
              3-stage low-storage RK3/CN scheme (20_.../hybrid.jl).
              State: vorticity spectrum wf (nx, ny) complex.
* ``ps32``    fully pseudospectral Jacobian with 3/2-rule zero-padding
              dealiasing (21_.../pseudospectral_32_rule.jl).
* ``ps23``    same with 2/3-rule truncation (22_.../pseudospectral_23_rule.jl).

Design notes: no ghost arrays — periodicity is jnp.roll; the spectral
state stays complex on-device across the whole lax.scan (the reference
ifft's to write text snapshots mid-loop, vm.jl:78-86; here snapshots stack
as scan outputs).

Reference run config: 128^2, [0, 2pi]^2, Re=1000, dt=0.01, t=20 (vm);
TGV validation: 64^2, Re=10, dt=0.01, t=1 (tgv.jl:92-146).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cfd_julia_tpu.core import precision
from cfd_julia_tpu.ops import arakawa, spectral
from cfd_julia_tpu.stepping import loop, ssprk3

TWO_PI = 2.0 * jnp.pi

# low-storage RK3/CN coefficients (hybrid.jl:30-32)
ALPHAS = (8.0 / 15.0, 2.0 / 15.0, 1.0 / 3.0)
GAMMAS = (8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0)
RHOS = (0.0, -17.0 / 60.0, -5.0 / 12.0)


@dataclasses.dataclass(frozen=True)
class VortexConfig:
    nx: int = 128
    ny: int = 128
    solver: str = "fdm"      # fdm | hybrid | ps32 | ps23
    dt: float = 0.01
    t_final: float = 20.0
    re: float = 1000.0
    ns: int = 10             # snapshots
    ic: str = "vm"           # vm | tgv
    tgv_n: int = 4
    fft_impl: str = "auto"   # auto (policy.py) | xla | matmul (four-step
                             # matmul FFT, ops.mxu_fft; any composite
                             # grid size)
    fft_precision: str = "auto"      # matmul-FFT precision tier
                             # (core.precision): auto (policy.py) |
                             # "highest" (fp32 products) | "high" (3-pass
                             # bf16) | "default" (single-pass bf16)
    pair_impl: str = "pack"  # pack (full Hermitian mirror, then ifft2) |
                             # rowsfirst (mirror after the kx transform:
                             # no row flip, all half-blocks in one
                             # batched transform — see
                             # spectral.ifft2_pairs_mirror_after_rows)

    @property
    def dx(self) -> float:
        return TWO_PI / self.nx

    @property
    def dy(self) -> float:
        return TWO_PI / self.ny

    @property
    def nt(self) -> int:
        return round(self.t_final / self.dt)

    def __post_init__(self):
        # a typo'd variant selector must never silently run (and get
        # benchmarked as) the default implementation
        _check = (("solver", ("fdm", "hybrid", "ps32", "ps23")),
                  ("ic", ("vm", "tgv")),
                  ("fft_impl", ("auto", "xla", "matmul")),
                  ("fft_precision", ("auto", "highest", "high",
                                     "default")),
                  ("pair_impl", ("pack", "rowsfirst")))
        for name, allowed in _check:
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} "
                                 f"{getattr(self, name)!r} (one of "
                                 f"{' | '.join(allowed)})")
        if self.ns < 1:
            raise ValueError("ns (snapshot count) must be >= 1")


def _resolved(cfg: VortexConfig, *, single_device: bool = True
              ) -> VortexConfig:
    """Resolve the "auto" selectors from policy.py.  Under a mesh the
    transforms are the XLA FFT: the matmul FFT is a single-device form."""
    from cfd_julia_tpu import policy

    kw = {}
    if cfg.fft_impl == "auto":
        kw["fft_impl"] = policy.choice("vortex_fft_impl") \
            if single_device else "xla"
    if cfg.fft_precision == "auto":
        kw["fft_precision"] = policy.choice("fft_precision")
    return dataclasses.replace(cfg, **kw) if kw else cfg


@dataclasses.dataclass
class VortexResult:
    x: jnp.ndarray            # nx+1 nodes (periodic wrap included)
    y: jnp.ndarray
    w: jnp.ndarray            # final vorticity (nx, ny) unique nodes
    snapshots: jnp.ndarray    # (nt//every + 1, nx, ny) incl. the IC,
                              # every = max(1, nt//ns): ns+1 rows when
                              # ns divides nt


# ------------------------------------------------------------------- ICs

def vm_ic(X, Y):
    """Two co-rotating Gaussian vortices (Common.jl:208-219)."""
    sigma = jnp.pi
    xc1, yc1 = jnp.pi - jnp.pi / 4.0, jnp.pi
    xc2, yc2 = jnp.pi + jnp.pi / 4.0, jnp.pi
    return jnp.exp(-sigma * ((X - xc1) ** 2 + (Y - yc1) ** 2)) + jnp.exp(
        -sigma * ((X - xc2) ** 2 + (Y - yc2) ** 2)
    )


def tgv_exact(X, Y, t, re: float, n: int = 4):
    """Analytic Taylor-Green vorticity (tgv.jl:82-90)."""
    return (
        2.0 * n * jnp.cos(n * X) * jnp.cos(n * Y)
        * jnp.exp(-2.0 * n**2 * t / re)
    )


def initial_vorticity(cfg: VortexConfig, dtype):
    x = jnp.arange(cfg.nx, dtype=dtype) * cfg.dx
    y = jnp.arange(cfg.ny, dtype=dtype) * cfg.dy
    X, Y = jnp.meshgrid(x, y, indexing="ij")
    if cfg.ic == "vm":
        return vm_ic(X, Y)
    if cfg.ic == "tgv":
        return tgv_exact(X, Y, 0.0, cfg.re, cfg.tgv_n)
    raise ValueError(f"unknown IC {cfg.ic!r}")


# ----------------------------------------------------------------- FDM

def fdm_rhs(w, dx, dy, re, mesh=None, fft_impl: str = "xla"):
    """vm_rhs: psi from FFT Poisson (FDM eigenvalues), Arakawa + viscous
    Laplacian (Common.jl:132-182).  fft_impl="matmul" solves the Poisson
    step with the matmul FFT."""
    s = spectral.fft_poisson_periodic(-w, dx, dy, eigen="fdm", mesh=mesh,
                                      impl=fft_impl)
    return arakawa.vorticity_rhs(w, s, dx, dy, re)


# ------------------------------------------------- spectral formulations

def _spectral_consts(cfg: VortexConfig, dtype):
    k2 = spectral.wavespace(cfg.nx, cfg.ny, cfg.dx, cfg.dy, dtype)
    kx = spectral.fft_wavenumber_index(cfg.nx, cfg.dx, dtype)
    ky = spectral.fft_wavenumber_index(cfg.ny, cfg.dy, dtype)
    return k2, kx, ky


def _kvec_traced(n: int, d: float, dtype, eps: float):
    """Traced eps-guarded FFT wavenumber vector (the jnp twin of
    spectral.fft_wavenumber_index; see _half_consts_traced for why)."""
    h = 2.0 * np.pi / (n * d)
    i = jnp.arange(n)
    k = (h * jnp.where(i < n // 2, i, i - n)).astype(dtype)
    return jnp.where(i == 0, jnp.asarray(eps, dtype), k)


def _spectral_consts_traced(cfg: VortexConfig, dtype, eps: float = 1e-6):
    """_spectral_consts as traced jnp (iota + elementwise) — embedded
    numpy literals bloat the compiled program (_half_consts_traced)."""
    kx = _kvec_traced(cfg.nx, cfg.dx, dtype, eps)
    ky = _kvec_traced(cfg.ny, cfg.dy, dtype, eps)
    return kx[:, None] ** 2 + ky[None, :] ** 2, kx, ky


def jacobian_hybrid(wf, k2, dx, dy, mesh=None):
    """-J(w, psi) computed in physical space with the Arakawa scheme, psi
    from the spectrum (hybrid.jl:92-152).

    Single-chip fast path: w and psi are real, so ONE complex ifft2 of
    wf + i(wf/k2) recovers both (Hermitian packing), and the forward
    transform of the real Jacobian goes through rfft2 + Hermitian mirror —
    3 full c2c transforms become ~1.5."""
    if mesh is None:
        w, s = spectral.ifft2_pair(wf, wf / k2)
        return spectral.fft2_real(-arakawa.jacobian(w, s, dx, dy))
    w = jnp.real(spectral.ifft2(wf, mesh))
    s = jnp.real(spectral.ifft2(wf / k2, mesh))
    return spectral.fft2(-arakawa.jacobian(w, s, dx, dy), mesh)


def _deriv_spectra(wf, k2, kx, ky):
    """psi_x, w_y, psi_y, w_x spectra (pseudospectral_32_rule.jl:113-122).

    Unlike the reference, the *multiplicative* wavenumbers zero (a) the
    k=0 entry — the reference's eps=1e-6 guard there breaks exact Hermitian
    symmetry and injects O(eps) noise (the guard is only needed for the
    1/k^2 division, where k2 keeps it) — and (b) the Nyquist mode, whose
    first derivative is not representable as a Hermitian (real-field)
    spectrum; zeroing it is the standard pseudospectral convention."""
    nx_, ny_ = kx.shape[0], ky.shape[0]
    ix = jnp.arange(nx_)
    iy = jnp.arange(ny_)
    kx0 = jnp.where(ix == 0, 0.0, kx)
    ky0 = jnp.where(iy == 0, 0.0, ky)
    # drop the Nyquist row/column entirely: its placement under the 3/2-rule
    # pad (one-sided negative block, pad_32) cannot be Hermitian
    wf = wf * _nyquist_mask(nx_, ny_)
    ikx = 1j * kx0[:, None]
    iky = 1j * ky0[None, :]
    return ikx * wf / k2, iky * wf, iky * wf / k2, ikx * wf


def _nyquist_mask(nx: int, ny: int):
    ix = jnp.arange(nx)[:, None]
    iy = jnp.arange(ny)[None, :]
    return (((nx % 2 != 0) | (ix != nx // 2))
            & ((ny % 2 != 0) | (iy != ny // 2)))


def jacobian_ps32(wf, k2, kx, ky, nx, ny, mesh=None):
    """Pseudospectral Jacobian, 3/2-rule zero-padding dealiasing
    (pseudospectral_32_rule.jl:95-177): jf = fft(psi_x w_y - psi_y w_x)
    evaluated on the 1.5x grid, truncated back.

    Deviation: the truncated spectrum's Nyquist row/column are zeroed.
    The reference's truncation keeps the fine grid's -n/2 modes without
    their +n/2 partners (truncate_32's one-sided negative block), leaving
    non-Hermitian content on the coarse Nyquist line — unrepresentable for
    a real field and inert anyway (_deriv_spectra masks it before every
    jacobian).  Zeroing it keeps the state exactly Hermitian so the
    half-spectrum fast path is bit-equivalent."""
    nxe, nye = 3 * nx // 2, 3 * ny // 2
    scale = (nxe * nye) / (nx * ny)
    specs = [spectral.pad_32(s, nxe, nye) * scale
             for s in _deriv_spectra(wf, k2, kx, ky)]
    if mesh is None:
        # Hermitian packing: 4 inverse transforms -> 2 (batched), forward
        # via rfft2 + mirror -> 5 padded c2c transforms become ~2.5
        z = jnp.fft.ifft2(jnp.stack([specs[0] + 1j * specs[1],
                                     specs[2] + 1j * specs[3]]))
        jacp = z[0].real * z[0].imag - z[1].real * z[1].imag
        jacpf = spectral.fft2_real(jacp)
    else:
        j1, j2, j3, j4 = (jnp.real(spectral.ifft2(s, mesh)) for s in specs)
        jacpf = spectral.fft2(j1 * j2 - j3 * j4, mesh)
    return (spectral.truncate_32(jacpf, nx, ny) / scale) * _nyquist_mask(nx, ny)


def jacobian_ps23(wf, k2, kx, ky, nx, ny, mesh=None):
    """Pseudospectral Jacobian, 2/3-rule truncation
    (pseudospectral_23_rule.jl:93-144): derivative spectra are masked
    before the physical product; the product spectrum is NOT re-masked
    (reference behaviour)."""
    nxe, nye = (2 * nx) // 3, (2 * ny) // 3
    ix = jnp.arange(nx)
    iy = jnp.arange(ny)
    # symmetric band |k| < nxe//2 (the reference's index range keeps one
    # extra negative mode, pseudospectral_23_rule.jl:127-133 — that breaks
    # the Hermitian symmetry of a real field's spectrum; the symmetric
    # band is the standard 2/3 rule and differs only in that one mode)
    keep_x = (ix < nxe // 2) | (ix > nx - nxe // 2)
    keep_y = (iy < nye // 2) | (iy > ny - nye // 2)
    mask = keep_x[:, None] & keep_y[None, :]
    specs = [s * mask for s in _deriv_spectra(wf, k2, kx, ky)]
    if mesh is None:
        # Hermitian packing (see jacobian_ps32)
        z = jnp.fft.ifft2(jnp.stack([specs[0] + 1j * specs[1],
                                     specs[2] + 1j * specs[3]]))
        return spectral.fft2_real(z[0].real * z[0].imag
                                  - z[1].real * z[1].imag)
    j1, j2, j3, j4 = (jnp.real(spectral.ifft2(s, mesh)) for s in specs)
    return spectral.fft2(j1 * j2 - j3 * j4, mesh)


# ------------------------------------------- half-spectrum fast path
#
# Single-chip state is the rfft2 HALF spectrum H (nx, ny//2+1) of the real
# vorticity — half the HBM traffic of the full spectrum for every
# elementwise op in the step.  The jacobian collapses further: the four
# derivative spectra (psi_x, w_y, psi_y, w_x) are CONSTANT multiples of H,
# so each packed pair full(A) + i*full(B) needed by the two-for-one
# inverse is (const1 * H | const2 * H) + the pack_hermitian_pair concat —
# two fused multiplies per stage instead of rebuilding four full spectra.
# The forward transform of the real Jacobian is a bare rfft2 (the
# hermitian_full mirror that round 1 paid every stage disappears: its
# output *is* the state).  FFT work is unchanged (2.5 c2c-equivalents per
# stage — the roofline of this formulation); everything else shrinks.

def _half_consts_traced(cfg: VortexConfig, dtype, eps: float = 1e-6):
    """The _half_wavenumbers constants as TRACED jnp computations (iota +
    elementwise) instead of embedded numpy literals.

    Why: closed-over/numpy constants are serialized into the compiled
    program — at 2048^2 the packed jacobian + CN constants are ~140 MB,
    which slows compilation and bloats the executable.  Inside jit the
    same formulas are a dozen cheap fused iota passes."""
    nx, ny = cfg.nx, cfg.ny
    hy = 2.0 * np.pi / (ny * cfg.dy)
    ix = jnp.arange(nx)[:, None]
    iy = jnp.arange(ny // 2 + 1)[None, :]
    kx = _kvec_traced(nx, cfg.dx, dtype, eps)[:, None]
    kyh = (hy * iy).astype(dtype)
    kyg = jnp.where(kyh == 0.0, jnp.asarray(eps, dtype), kyh)
    k2h = kx**2 + kyg**2
    kx0 = jnp.where(ix == 0, jnp.zeros((), dtype), kx)
    ky0 = kyh                                   # j=0 entry is already 0
    nyq = (((nx % 2 != 0) | (ix != nx // 2))
           & ((ny % 2 != 0) | (iy != ny // 2))).astype(dtype)
    return kx0, ky0, k2h, nyq


def _cn_consts_traced(cfg: VortexConfig, k2h, dtype):
    """_cn_consts as traced jnp (see _half_consts_traced)."""
    dt, re = cfg.dt, cfg.re
    nx, hy = k2h.shape
    mean = 1.0 - ((jnp.arange(nx)[:, None] == 0)
                  & (jnp.arange(hy)[None, :] == 0)).astype(dtype)
    out = []
    for s in range(3):
        d = ALPHAS[s] * 0.5 * dt * k2h / re
        out.append((mean * (1.0 - d) / (1.0 + d),
                    mean * GAMMAS[s] * dt / (1.0 + d),
                    mean * RHOS[s] * dt / (1.0 + d)))
    return out


def _packed_jacobian_consts_traced(cfg: VortexConfig, dtype,
                                   band_mask=None):
    """_packed_jacobian_consts as traced jnp: complex intermediates stay
    INSIDE jit (see _half_consts_traced)."""
    kx0, ky0, k2h, nyq = _half_consts_traced(cfg, dtype)
    m = nyq if band_mask is None else nyq * band_mask.astype(dtype)
    gx, gy = kx0 / k2h, ky0 / k2h
    return ((1j * gx - ky0) * m, (1j * gx + ky0) * m,
            (1j * gy - kx0) * m, (1j * gy + kx0) * m)


def _band_mask_23_half_traced(cfg: VortexConfig):
    nxe, nye = (2 * cfg.nx) // 3, (2 * cfg.ny) // 3
    ix = jnp.arange(cfg.nx)[:, None]
    iy = jnp.arange(cfg.ny // 2 + 1)[None, :]
    keep_x = (ix < nxe // 2) | (ix > cfg.nx - nxe // 2)
    return keep_x & (iy < nye // 2)


def make_spectral_step_half(cfg: VortexConfig, dtype, mesh=None):
    """3-stage RK3/CN step over the rfft2 half spectrum.

    Numerically identical to make_spectral_step (same operations on the
    Hermitian-redundant representation removed); validated against it in
    tests/test_ns2d.py.

    All solver constants are computed inside the traced step (iota +
    elementwise) — embedded-literal constants made the 2048^2
    program ~270 MB (_half_consts_traced).

    mesh: multi-chip pencil decomposition — every transform is made
    axis-local via sharding constraints (spectral.rfft2/ifft2), the
    pack_hermitian_pair concats/flips partition natively, and the
    elementwise stage math keeps the field sharding.  Mesh mode requires
    the XLA FFT + "pack" pair path (matmul FFT and rowsfirst are
    single-device formulations)."""
    cfg = _resolved(cfg, single_device=mesh is None)
    nx, ny = cfg.nx, cfg.ny
    if mesh is not None and (cfg.fft_impl != "xla"
                             or cfg.pair_impl != "pack"):
        raise ValueError(
            "mesh mode requires fft_impl='xla' and pair_impl='pack' "
            f"(got {cfg.fft_impl!r}/{cfg.pair_impl!r})")

    # one home for every (fft_impl, fft_precision)-derived transform
    if mesh is not None:
        ifft2_fn = lambda z: spectral.ifft2(z, mesh)
        rfft2_fn = lambda x: spectral.rfft2(x, mesh)
        ifft_rows_fn = ifft_cols_fn = None
    elif cfg.fft_impl == "matmul":
        import functools

        from cfd_julia_tpu.ops import mxu_fft

        prec = cfg.fft_precision
        ifft2_fn = functools.partial(mxu_fft.ifft2_matmul, precision=prec)
        rfft2_fn = functools.partial(mxu_fft.rfft2_matmul, precision=prec)
        ifft_rows_fn = functools.partial(mxu_fft.ifft_matmul, axis=-2,
                                         precision=prec)
        ifft_cols_fn = functools.partial(mxu_fft.ifft_matmul, axis=-1,
                                         precision=prec)
    else:
        ifft2_fn, rfft2_fn = jnp.fft.ifft2, jnp.fft.rfft2
        ifft_rows_fn = ifft_cols_fn = None

    def pairs_inverse(heads, tails, active_cols=None):
        """(P, nx, ny//2+1) packed-pair halves -> (P, nx, ny) physical.
        active_cols: band-limit of the inputs (rowsfirst skips the zero
        columns in its kx transform)."""
        if cfg.pair_impl == "rowsfirst":
            return spectral.ifft2_pairs_mirror_after_rows(
                heads, tails, ny, ifft_rows_fn, ifft_cols_fn, active_cols)
        return ifft2_fn(spectral.pack_hermitian_pair(heads, tails, ny))

    if cfg.solver == "hybrid":
        def jac_consts():
            _, _, k2h, _ = _half_consts_traced(cfg, dtype)
            return (1.0 + 1j / k2h, 1.0 - 1j / k2h)

        def jac(H, jc):
            head, tail = jc
            z = pairs_inverse((head * H)[None], (tail * H)[None])[0]
            return rfft2_fn(
                -arakawa.jacobian(z.real, z.imag, cfg.dx, cfg.dy))
    elif cfg.solver == "ps23":
        def jac_consts():
            band = _band_mask_23_half_traced(cfg)
            return _packed_jacobian_consts_traced(cfg, dtype, band)

        def jac(H, jc):
            h1, t1, h2, t2 = jc
            # the 2/3 band keeps only columns iy < nye//2 = ny/3
            z = pairs_inverse(jnp.stack([h1 * H, h2 * H]),
                              jnp.stack([t1 * H, t2 * H]),
                              active_cols=((2 * ny) // 3) // 2)
            return rfft2_fn(z[0].real * z[0].imag
                            - z[1].real * z[1].imag)
    elif cfg.solver == "ps32":
        nxe, nye = 3 * nx // 2, 3 * ny // 2
        scale = (nxe * nye) / (nx * ny)
        if cfg.fft_impl == "matmul":
            from cfd_julia_tpu.ops import mxu_fft

            # the 3/2-padded lengths must also be matmul-supported
            ok = mxu_fft.supported(nxe) and mxu_fft.supported(nye)
            ifft_e = ifft2_fn if ok else jnp.fft.ifft2
            rfft_e = rfft2_fn if ok else jnp.fft.rfft2
        else:
            ifft_e, rfft_e = ifft2_fn, rfft2_fn

        def jac_consts():
            _, _, _, nyq = _half_consts_traced(cfg, dtype)
            # fold the Nyquist zeroing (see jacobian_ps32) + rescale
            return (*_packed_jacobian_consts_traced(cfg, dtype),
                    nyq / scale)

        def jac(H, jc):
            h1, t1, h2, t2, nyq_over_scale = jc
            pads = jnp.stack([
                spectral.pad_32(spectral.pack_hermitian_pair(
                    h1 * H, t1 * H, ny), nxe, nye),
                spectral.pad_32(spectral.pack_hermitian_pair(
                    h2 * H, t2 * H, ny), nxe, nye),
            ]) * scale
            z = ifft_e(pads)
            jf = rfft_e(z[0].real * z[0].imag
                        - z[1].real * z[1].imag)
            return spectral.truncate_32_half(jf, nx, ny) * nyq_over_scale
    else:
        raise ValueError(cfg.solver)

    def step(H):
        # all constants rebuilt from iota INSIDE the trace: a dozen fused
        # elementwise passes, vs ~270 MB of embedded literals at 2048^2
        _, _, k2h, _ = _half_consts_traced(cfg, dtype)
        (a1, b1, _), (a2, b2, r2), (a3, b3, r3) = _cn_consts_traced(
            cfg, k2h, dtype)
        jc = jac_consts()
        jn = jac(H, jc)
        H1 = a1 * H + b1 * jn
        j1 = jac(H1, jc)
        H2 = a2 * H1 + r2 * jn + b2 * j1
        j2 = jac(H2, jc)
        return a3 * H2 + r3 * j1 + b3 * j2

    return step


def half_init(w0):
    """rfft2 half-spectrum state with the mean mode projected out."""
    return spectral.zero_mean_mode(jnp.fft.rfft2(w0))


def half_decode(H, ny: int, dtype):
    """Real vorticity from the half spectrum (Hermitian mirror + complex
    ifft2)."""
    return jnp.real(jnp.fft.ifft2(spectral.hermitian_full(H, ny))).astype(dtype)


# Packed-state variants: every solver-level entry/exit (see
# spectral.pack_c) carries the half spectrum as a real (2, nx, ny//2+1) stack.

def half_init_packed(w0):
    return spectral.pack_c(half_init(w0))


def half_decode_packed(h, ny: int, dtype):
    return half_decode(spectral.unpack_c(h), ny, dtype)


def make_spectral_step_half_packed(cfg: VortexConfig, dtype, mesh=None):
    """make_spectral_step_half with real-packed state at the boundary."""
    step = make_spectral_step_half(cfg, dtype, mesh)
    return lambda h: spectral.pack_c(step(spectral.unpack_c(h)))


def make_spectral_step_packed(cfg: VortexConfig, dtype, mesh=None):
    """make_spectral_step (full spectrum) with real-packed state."""
    step = make_spectral_step(cfg, dtype, mesh)
    return lambda h: spectral.pack_c(step(spectral.unpack_c(h)))


def full_init_packed(w0):
    """Packed full-spectrum state from real vorticity (fft2 built from the
    rfft2 half via the Hermitian mirror — real input end to end)."""
    return spectral.pack_c(
        spectral.zero_mean_mode(spectral.fft2_real(w0)))


def make_spectral_step(cfg: VortexConfig, dtype, mesh=None):
    """3-stage low-storage RK3/CN step over the vorticity spectrum
    (hybrid.jl:34-69, identical stepper in ch. 21/22)."""
    dt, re = cfg.dt, cfg.re
    if cfg.solver == "hybrid":
        jac = lambda wf, k2, kx, ky: jacobian_hybrid(
            wf, k2, cfg.dx, cfg.dy, mesh)
    elif cfg.solver == "ps32":
        jac = lambda wf, k2, kx, ky: jacobian_ps32(
            wf, k2, kx, ky, cfg.nx, cfg.ny, mesh)
    elif cfg.solver == "ps23":
        jac = lambda wf, k2, kx, ky: jacobian_ps23(
            wf, k2, kx, ky, cfg.nx, cfg.ny, mesh)
    else:
        raise ValueError(cfg.solver)

    def step(wf):
        # constants rebuilt from iota inside the trace (embedded-literal
        # wavenumber arrays bloat the compiled program)
        k2, kx, ky = _spectral_consts_traced(cfg, dtype)
        ds = [a * 0.5 * dt * k2 / re for a in ALPHAS]
        jac_ = lambda w: jac(w, k2, kx, ky)
        jn = jac_(wf)
        w1 = ((1.0 - ds[0]) / (1.0 + ds[0])) * wf + (
            GAMMAS[0] * dt * jn
        ) / (1.0 + ds[0])
        w1 = spectral.zero_mean_mode(w1)
        j1 = jac_(w1)
        w2 = ((1.0 - ds[1]) / (1.0 + ds[1])) * w1 + (
            RHOS[1] * dt * jn + GAMMAS[1] * dt * j1
        ) / (1.0 + ds[1])
        w2 = spectral.zero_mean_mode(w2)
        j2 = jac_(w2)
        wn = ((1.0 - ds[2]) / (1.0 + ds[2])) * w2 + (
            RHOS[2] * dt * j1 + GAMMAS[2] * dt * j2
        ) / (1.0 + ds[2])
        return spectral.zero_mean_mode(wn)

    return step


# ----------------------------------------------------------------- driver

def solve(cfg: VortexConfig, dtype=None, checkpoint_every: int = 0,
          checkpoint_path: str | None = None,
          resume: bool = False) -> VortexResult:
    """Integrate nt steps collecting cfg.ns snapshots (vm.jl:60-88).

    checkpoint_every/checkpoint_path/resume: periodic resumable on-disk
    checkpoints (state + snapshots so far + chunk count), cadence
    rounded UP to the snapshot interval; the chunked host loop applies
    the same per-chunk scans as the single-jit path, so an interrupted
    and resumed run reproduces it bit-for-bit."""
    dtype = dtype or precision.default_dtype()
    cfg = _resolved(cfg)
    w0 = initial_vorticity(cfg, dtype)
    x = jnp.arange(cfg.nx + 1, dtype=dtype) * cfg.dx
    y = jnp.arange(cfg.ny + 1, dtype=dtype) * cfg.dy
    every = max(1, cfg.nt // cfg.ns)

    if cfg.solver == "fdm":
        rhs = lambda w: fdm_rhs(w, cfg.dx, cfg.dy, cfg.re,
                                fft_impl=cfg.fft_impl)
        step = lambda w: ssprk3.ssprk3_step(rhs, w, cfg.dt)
        state0, observe, decode = w0, None, lambda s: s
    else:
        # packed (real) state at every jit boundary (spectral.pack_c)
        step = make_spectral_step_half_packed(cfg, dtype)
        state0 = jax.jit(half_init_packed)(w0)
        observe = lambda h: half_decode_packed(h, cfg.ny, dtype)
        decode = jax.jit(observe)

    if not (checkpoint_every or resume):
        state, snaps = loop.run_steps_with_snapshots(
            step, state0, cfg.nt, every, observe=observe)
        return VortexResult(x=x, y=y, w=decode(state),
                            snapshots=jnp.concatenate([w0[None], snaps]))

    from cfd_julia_tpu.utils import checkpoint

    if (checkpoint_every or resume) and not checkpoint_path:
        raise ValueError("checkpointing requires checkpoint_path")
    n_chunks = cfg.nt // every
    rem = cfg.nt - n_chunks * every
    obs = decode  # per-chunk snapshot = decoded state (identity for fdm)
    state, done, parts = state0, 0, []
    snaps_like = jnp.zeros((0,) + w0.shape, dtype)
    if resume and checkpoint.exists(checkpoint_path):
        # the checkpoint records the ABSOLUTE step count: a resume under
        # a different snapshot cadence (nt or ns changed so that `every`
        # no longer divides it) or a shorter run cannot be silently
        # misinterpreted as a chunk count
        (state, prev), step_ct = checkpoint.load_state(
            checkpoint_path, (state0, snaps_like))
        if step_ct % every:
            raise ValueError(
                f"checkpoint at step {step_ct} is incompatible with the "
                f"current snapshot interval {every} (= nt//ns — snapshot "
                f"times would not line up); rerun with the original "
                f"nt/ns or restart without --resume")
        if step_ct > cfg.nt:
            raise ValueError(
                f"checkpoint at step {step_ct} is beyond this run's "
                f"nt={cfg.nt}; restart without --resume")
        done = step_ct // every
        if np.shape(prev)[0]:
            parts = [np.asarray(prev)]
        if np.shape(prev)[0] != done:
            raise ValueError(
                f"checkpoint snapshot count {np.shape(prev)[0]} does not "
                f"match its step count {step_ct} at interval {every}")
    per_ckpt = max(1, -(-checkpoint_every // every)) if checkpoint_every \
        else n_chunks
    while done < n_chunks:
        state = loop.run_steps(step, state, every)
        parts.append(np.asarray(obs(state))[None])
        done += 1
        if done % per_ckpt == 0 or done == n_chunks:
            jax.block_until_ready(state)
            arr = jnp.asarray(np.concatenate(parts)) if parts \
                else snaps_like
            checkpoint.save_state(checkpoint_path, (state, arr),
                                  step=done * every)
    if rem:
        state = loop.run_steps(step, state, rem)
    snaps = (jnp.asarray(np.concatenate(parts)) if parts else snaps_like)
    return VortexResult(x=x, y=y, w=decode(state),
                        snapshots=jnp.concatenate([w0[None], snaps]))


def tgv_error(cfg: VortexConfig, res: VortexResult):
    """L2/max error vs the analytic TGV decay (tgv.jl:129-139), evaluated
    at the time actually integrated, nt*dt — when dt does not divide
    t_final evenly, comparing at t_final would charge the solver a
    spurious decay mismatch that is not a discretization error."""
    dtype = res.w.dtype
    x = jnp.arange(cfg.nx, dtype=dtype) * cfg.dx
    y = jnp.arange(cfg.ny, dtype=dtype) * cfg.dy
    X, Y = jnp.meshgrid(x, y, indexing="ij")
    ue = tgv_exact(X, Y, cfg.nt * cfg.dt, cfg.re, cfg.tgv_n)
    err = res.w - ue
    return jnp.sqrt(jnp.mean(err**2)), jnp.max(jnp.abs(err))
