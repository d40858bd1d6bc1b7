"""Spectral primitives: FFT Poisson eigenvalue solves, DST-I (fast sine
transform), wavenumber arrays, dealiasing masks.

Notes:
* XLA has no real-to-real transforms, so DST-I (FFTW RODFT00, used by the
  reference for Dirichlet Poisson and the cavity solver, fft_d.jl:13,
  lid_driven_cavity.jl:11-21) is built from an odd extension + rfft:
  for v of length m, the odd extension y = [0, v, 0, -reverse(v)] of length
  2(m+1) satisfies FFT(y)_k = -i * DST1(v)_k, so DST1(v) = -Im rfft(y)[1:m+1].
  DST-I is its own inverse up to the factor 2(m+1).
* Periodic Poisson eigenvalue solves follow fps (Common.jl:97-125) /
  ps_fft (fft_p.jl:8-42) / ps_spectral (fft_s.jl:8-37): forward FFT of the
  source, divide by (FDM or spectral) eigenvalues, zero the mean mode,
  inverse FFT.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P


# ------------------------------------------------- mesh-aware transforms
#
# Multi-chip note: XLA's partitioned-FFT path is avoided entirely by the
# classic *pencil decomposition*: a sharding constraint makes the transform
# axis fully local before each 1D FFT, so the partitioner emits plain
# all-to-all transposes between devices and every FFT runs locally. (On the CPU
# test backend the partitioned-FFT path is actually broken —
# fft_thunk.cc layout RET_CHECK — so this is also the correctness path.)
# With mesh=None all helpers degrade to plain single-device transforms.

def _constrain(x, mesh, spec):
    if mesh is None:
        return x
    return lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def _pencil_specs(mesh, ndim: int = 2):
    """(last-axis-local, second-last-axis-local) specs for the trailing
    two axes of an ndim array; leading (batch) axes stay replicated."""
    flat = tuple(mesh.axis_names)
    lead = (None,) * (ndim - 2)
    return P(*lead, flat, None), P(*lead, None, flat)


def fft2(x, mesh=None):
    """2D FFT over the last two axes; pencil-decomposed when mesh given."""
    if mesh is None:
        return jnp.fft.fft2(x)
    sx, sy = _pencil_specs(mesh, x.ndim)
    x = _constrain(x, mesh, sx)
    x = jnp.fft.fft(x, axis=-1)
    x = _constrain(x, mesh, sy)
    return jnp.fft.fft(x, axis=-2)


def ifft2(x, mesh=None):
    if mesh is None:
        return jnp.fft.ifft2(x)
    sx, sy = _pencil_specs(mesh, x.ndim)
    x = _constrain(x, mesh, sy)
    x = jnp.fft.ifft(x, axis=-2)
    x = _constrain(x, mesh, sx)
    return jnp.fft.ifft(x, axis=-1)


def rfft2(x, mesh=None):
    """rfft2 over the last two axes; pencil-decomposed when mesh given
    (real rfft along the local last axis, then a complex fft along the
    locally-resharded second-last axis — the forward half of the
    half-spectrum solver state, multi-chip)."""
    if mesh is None:
        return jnp.fft.rfft2(x)
    sx, sy = _pencil_specs(mesh, x.ndim)
    x = _constrain(x, mesh, sx)
    h = jnp.fft.rfft(x, axis=-1)
    h = _constrain(h, mesh, sy)
    return jnp.fft.fft(h, axis=-2)


def pack_hermitian_pair(head, tail_src, n: int):
    """Build the full (.., n, n) packed spectrum full(A) + i*full(B) of two
    REAL fields a, b from half-spectrum-shaped inputs (.., n, n//2+1):

        head     = A + iB   (columns j = 0 .. n/2 of the packed spectrum)
        tail_src = A - iB   (source for columns j > n/2)

    because for j > n/2 the Hermitian symmetry of A and B gives
    full[i, j] = conj(A - iB)[(n-i) % n, n-j].  One complex ifft2 of the
    result recovers a = Re, b = Im — the two-for-one inverse that replaces
    a separate IRFFT per field.  Pure flips/concats otherwise."""
    tail = jnp.conj(tail_src[..., :, 1 : n - n // 2])  # j = 1..ceil(n/2)-1
    tail = tail[..., :, ::-1]                          # -> j' = n-j ascending
    tail = jnp.concatenate(
        [tail[..., :1, :], tail[..., 1:, :][..., ::-1, :]], axis=-2
    )                                                  # i -> (n-i) % n
    return jnp.concatenate([head, tail], axis=-1)


def ifft2_pairs_mirror_after_rows(heads, tails, n: int,
                                  ifft_rows_fn=None, ifft_cols_fn=None,
                                  active_cols: int | None = None):
    """Batched ifft2(pack_hermitian_pair(head_p, tail_p, n)) for P pairs
    WITHOUT the row-direction Hermitian flip: the kx-axis inverse
    commutes with the mirror — ifft of conj(s[(n-i) % n]) equals
    conj(ifft(s)) — so all 2P half-width blocks transform FIRST (one
    batched axis -2 transform of (2P, n, n//2+1)) and only a column
    flip+concat assembles the full-width intermediate before the axis -1
    transform.  heads/tails: (P, n, n//2+1); returns (P, n, n).

    active_cols: if the inputs are band-limited (columns >= active_cols
    all zero — e.g. the 2/3-rule dealias band keeps only ky < ny/3), the
    zero columns are sliced off BEFORE the row transform and zero-padded
    back after — the batched kx transform does only active_cols/(n/2+1)
    of the work."""
    if ifft_rows_fn is None:
        ifft_rows_fn = lambda x: jnp.fft.ifft(x, axis=-2)
    if ifft_cols_fn is None:
        ifft_cols_fn = lambda x: jnp.fft.ifft(x, axis=-1)
    hy = heads.shape[-1]
    x = jnp.concatenate([heads, tails], axis=0)
    if active_cols is not None and active_cols < hy:
        x = x[..., :active_cols]
    r = ifft_rows_fn(x)
    if active_cols is not None and active_cols < hy:
        r = jnp.concatenate(
            [r, jnp.zeros(r.shape[:-1] + (hy - active_cols,), r.dtype)],
            axis=-1)
    r1, r2 = r[: heads.shape[0]], jnp.conj(r[heads.shape[0] :])
    tail = r2[..., :, 1 : n - n // 2][..., :, ::-1]
    return ifft_cols_fn(jnp.concatenate([r1, tail], axis=-1))


def hermitian_full(h, n: int):
    """Rebuild the full (.., n, n) spectrum of a REAL field from its rfft2
    half spectrum (.., n, n//2+1): full[i, j] = conj(h[(n-i)%n, n-j]) for
    j > n/2 (the A = h, B = 0 case of pack_hermitian_pair)."""
    return pack_hermitian_pair(h, h, n)


def fft2_real(x, mesh=None):
    """Full FFT2 spectrum of a real field at ~half cost: rfft2 + Hermitian
    mirror (forward-only trick)."""
    n = x.shape[-1]
    if mesh is not None:
        return fft2(x.astype(complex_for(x.dtype)), mesh)
    return hermitian_full(jnp.fft.rfft2(x), n)


def complex_for(real_dtype):
    return jnp.complex128 if jnp.dtype(real_dtype) == jnp.float64 else jnp.complex64


def pack_c(H):
    """Complex array -> real (2, ...) stack [Re, Im].

    The solvers' state crosses jit boundaries (params, outputs, host
    transfers) as real arrays only; complex values are jit-internal
    intermediates.  The GPU accepts complex I/O, so this contract is
    kept for one state layout on every backend, not out of need there.
    pack_c/unpack_c are the boundary adapters — both are free inside jit
    (they fuse into the neighbouring passes)."""
    return jnp.stack([jnp.real(H), jnp.imag(H)])


def unpack_c(h):
    """Real (2, ...) stack [Re, Im] -> complex array (see pack_c)."""
    return lax.complex(h[0], h[1])


def ifft2_pair(A, B, mesh=None):
    """Inverse-transform two Hermitian spectra (of real fields) with ONE
    complex ifft2: ifft2(A + iB) = a + ib elementwise for real a, b."""
    z = ifft2(A + 1j * B, mesh)
    return jnp.real(z), jnp.imag(z)


def zero_mean_mode(e):
    """Zero the k=(0,0) Fourier mode via an elementwise mask (a scatter on
    an FFT output miscompiles under GSPMD on the CPU backend; the mask is
    equivalent and fuses)."""
    nx, ny = e.shape[-2], e.shape[-1]
    mask = 1.0 - (jnp.arange(nx)[:, None] == 0) * (jnp.arange(ny)[None, :] == 0)
    return e * mask.astype(e.real.dtype)


def fft_wavenumber_index(n: int, dx: float, dtype, eps: float = 1e-6):
    """k_i = hx * [0, 1, .., n/2-1, -n/2, .., -1] with hx = 2 pi/(n dx) and
    the k_0 = eps guard (wavespace, Common.jl:184-204).

    Built with NUMPY: wavenumbers are solver constants assembled at
    step-build time, often OUTSIDE jit — eager device ops at build time
    would each cost a dispatch (and initialize the backend at import).
    As numpy values they embed as literals when traced."""
    hx = 2 * np.pi / (n * dx)
    i = np.arange(n)
    k = hx * np.where(i < n // 2, i, i - n)
    k[0] = eps
    return k.astype(dtype)


def wavespace(nx: int, ny: int, dx: float, dy: float, dtype, eps: float = 1e-6):
    """k^2 = kx_i^2 + ky_j^2 (Common.jl:184-204)."""
    kx = fft_wavenumber_index(nx, dx, dtype, eps)
    ky = fft_wavenumber_index(ny, dy, dtype, eps)
    return kx[:, None] ** 2 + ky[None, :] ** 2


def fft_poisson_periodic(f, dx: float, dy: float, eigen: str = "fdm",
                         eps: float = 1e-6, mesh=None, impl: str = "xla"):
    """Solve laplacian(u) = f on an nx x ny periodic grid (unique nodes).

    eigen="fdm": second-order FDM eigenvalues aa + bb cos(kx) + cc cos(ky)
    with the *index-space* wavenumbers kx = 2 pi i / n (fft_p.jl:8-42,
    identical to fps Common.jl:97-125).
    eigen="spectral": exact eigenvalues -(kx^2 + ky^2) with physical
    wavenumbers (fft_s.jl:8-37).
    The mean mode is zeroed (solvability / gauge fixing)."""
    if impl not in ("xla", "matmul"):
        # a typo'd variant name must never silently run (and get
        # benchmarked as) the default implementation
        raise ValueError(f"unknown fft impl {impl!r} (xla | matmul)")
    nx, ny = f.shape[-2], f.shape[-1]
    dtype = f.dtype
    use_matmul = impl == "matmul" and mesh is None  # matmul path is
    # single-device; under a mesh the pencil decomposition applies
    if use_matmul:
        from cfd_julia_tpu.ops import mxu_fft

        fwd, inv = mxu_fft.fft2_matmul, mxu_fft.ifft2_matmul
    else:
        fwd, inv = (lambda x: fft2(x, mesh)), (lambda x: ifft2(x, mesh))
    e = fwd(f.astype(complex_for(dtype)) if use_matmul else f)
    if eigen == "fdm":
        # index-space wavenumbers 2 pi i / n = fft_wavenumber_index at
        # dx=1 (numpy build-time constants — the jnp version cost eager
        # device ops incl. two scatters per solver build)
        kx = fft_wavenumber_index(nx, 1.0, dtype, eps)
        ky = fft_wavenumber_index(ny, 1.0, dtype, eps)
        aa = -2.0 / dx**2 - 2.0 / dy**2
        bb = 2.0 / dx**2
        cc = 2.0 / dy**2
        den = aa + bb * jnp.cos(kx)[:, None] + cc * jnp.cos(ky)[None, :]
    elif eigen == "spectral":
        kx = fft_wavenumber_index(nx, dx, dtype, eps)
        ky = fft_wavenumber_index(ny, dy, dtype, eps)
        den = -(kx[:, None] ** 2) - ky[None, :] ** 2
    else:
        raise ValueError(f"unknown eigenvalue mode {eigen!r}")
    # Explicit mean-mode guard: the reference's eps trick keeps den[0,0]
    # nonzero only in fp64 (cos(1e-6) == 1.0 exactly in fp32, giving
    # 0/0 = NaN that the subsequent ifft spreads everywhere); e[0,0] is
    # zeroed, so den[0,0] is arbitrary — pin it to 1.
    nzx = jnp.arange(nx)[:, None] == 0
    nzy = jnp.arange(ny)[None, :] == 0
    den = jnp.where(nzx & nzy, jnp.ones((), dtype), den)
    e = zero_mean_mode(e)
    return jnp.real(inv(e / den))


# ----------------------------------------------------------------- DST-I

def _dst1_half_last(v, rfft_fn=None):
    """DST-I along the last axis via a length-(m+1) rfft — HALF the
    odd-extension transform length (FFTPACK RODFT00 pre/post processing,
    Swarztrauber 1982; verified to roundoff vs scipy.fft.dst type 1).

    With N = m+1:  y_0 = 0,
        y_j = sin(pi j/N) (x_j + x_{N-j}) + (x_j - x_{N-j})/2,  j=1..N-1
        Y = rfft(y)
        S_{2r}   = -Im Y_r                       (r = 1 .. m//2)
        S_{2r+1} = S_{2r-1} + Re Y_r,  S_1 = Re Y_0 / 2
                 = cumsum(Re Y)_r - Re Y_0 / 2   (r = 0 .. ceil(m/2)-1)

    Returns the UNSCALED sine sum S_k = sum_j x_j sin(pi j k / N); dst1
    doubles it for FFTW-RODFT00 parity.  The cumsum is one log-depth XLA
    pass; everything else is elementwise — the FFT work halves."""
    m = v.shape[-1]
    n = m + 1
    dtype = v.dtype
    jj = jnp.arange(1, n, dtype=dtype)
    s = jnp.sin(jnp.pi * jj / n)
    b = v[..., ::-1]                             # x[N-j], j = 1..N-1
    y1 = s * (v + b) + 0.5 * (v - b)
    y = jnp.concatenate(
        [jnp.zeros(v.shape[:-1] + (1,), dtype), y1], axis=-1)
    Y = (rfft_fn or (lambda a: jnp.fft.rfft(a, axis=-1)))(y)  # (..., N//2+1)
    re = jnp.real(Y).astype(dtype)
    im = jnp.imag(Y).astype(dtype)
    odd = jnp.cumsum(re, axis=-1) - 0.5 * re[..., :1]   # k = 1, 3, 5, ...
    n_odd = (m + 1) // 2
    n_even = m // 2
    odd = odd[..., :n_odd]
    even = -im[..., 1 : n_even + 1]                     # k = 2, 4, 6, ...
    if n_even < n_odd:   # pad so the interleave stays a pure reshape
        even = jnp.concatenate(
            [even, jnp.zeros(v.shape[:-1] + (n_odd - n_even,), dtype)],
            axis=-1)
    inter = jnp.stack([odd, even], axis=-1).reshape(
        v.shape[:-1] + (2 * n_odd,))
    return inter[..., :m]


def dst1(v, axis: int = -1, mesh=None, impl: str = "rfft",
         precision: str = "highest"):
    """DST-I along `axis`: X_k = 2 sum_j v_j sin(pi (j+1)(k+1) / (m+1)),
    matching FFTW's unnormalized RODFT00 on m interior points.

    impl="rfft": odd extension + rfft (VPU FFT).
    impl="half": length-(m+1) rfft + pre/post passes (_dst1_half_last) —
    half the transform length of the odd extension.
    impl="matmul": same odd extension through the four-step MXU FFT
    (ops.mxu_fft, real-input path) — the transform becomes full-width
    matmuls on the systolic array.
    impl="half_mxu": the half-length formulation with its rfft on the MXU
    — the fastest matmul form (half the matmul flops of "matmul").
    `precision` reaches the MXU impls ("high" = 3-pass bf16 perf path).

    With a mesh, the transform axis is made local (pencil constraint) and —
    because DST rows are independent — the non-transform axis is zero-padded
    up to a device-count multiple first, so the constraint sharding is even
    (ragged shardings miscompile through the CPU FFT path)."""
    if impl not in ("rfft", "half", "matmul", "half_mxu"):
        # a typo'd variant name must never silently run (and get
        # benchmarked as) the default odd-extension path
        raise ValueError(f"unknown DST impl {impl!r} "
                         "(rfft | half | matmul | half_mxu)")
    v = jnp.moveaxis(v, axis, -1)
    m = v.shape[-1]
    n0 = None
    if mesh is not None and v.ndim != 2:
        # the pencil constraint below is only built for the 2D case; a
        # batched sharded DST would silently skip it and can lower into
        # XLA's partitioned-FFT path (broken on CPU, module header)
        raise NotImplementedError("dst1 with a mesh expects a 2D array")
    if mesh is not None and v.ndim == 2:
        ndev = mesh.devices.size
        n0 = v.shape[0]
        n0_pad = ((n0 + ndev - 1) // ndev) * ndev
        if n0_pad != n0:
            v = jnp.concatenate(
                [v, jnp.zeros((n0_pad - n0, m), v.dtype)], axis=0
            )
        v = _constrain(v, mesh, P(tuple(mesh.axis_names), None))
    if impl == "half":
        X = 2.0 * _dst1_half_last(v)
    elif impl == "half_mxu":
        from cfd_julia_tpu.ops import mxu_fft

        X = 2.0 * _dst1_half_last(
            v, lambda a: mxu_fft.rfft_matmul(a, precision=precision))
    else:
        z = jnp.zeros(v.shape[:-1] + (1,), v.dtype)
        y = jnp.concatenate([z, v, z, -v[..., ::-1]], axis=-1)  # len 2(m+1)
        if impl == "matmul":
            from cfd_julia_tpu.ops import mxu_fft

            X = -mxu_fft.rfft_matmul(y, precision=precision
                                     ).imag[..., 1 : m + 1]
        else:
            X = -jnp.fft.rfft(y, axis=-1).imag[..., 1 : m + 1]
    X = X.astype(v.dtype)
    if n0 is not None:
        X = X[:n0]
    return jnp.moveaxis(X, -1, axis)


def dst1_2d(v, mesh=None, impl: str = "rfft", precision: str = "highest"):
    """2D DST-I over the last two axes (= FFTW.r2r(..., RODFT00))."""
    return dst1(dst1(v, axis=-1, mesh=mesh, impl=impl, precision=precision),
                axis=-2, mesh=mesh, impl=impl, precision=precision)


def idst1_2d(v, norm_nx: int, norm_ny: int, mesh=None, impl: str = "rfft",
             precision: str = "highest"):
    """Inverse 2D DST-I with the reference normalization /(2 nx * 2 ny)
    (fft_d.jl:22): the forward pair applied twice scales by 4 nx ny."""
    return dst1_2d(v, mesh, impl, precision) / (4.0 * norm_nx * norm_ny)


def fst_poisson_dirichlet(f_interior, dx: float, dy: float, mesh=None,
                          impl: str = "rfft", precision: str = "highest"):
    """Solve laplacian(u) = f with homogeneous Dirichlet BCs via DST-I.

    f_interior: (nx-1, ny-1) interior nodes of an (nx+1, ny+1) grid.
    Returns interior solution of the same shape. Eigenvalues are the DST
    diagonalization of the 5-point Laplacian (fft_d.jl:7-23)."""
    mx, my = f_interior.shape[-2], f_interior.shape[-1]
    nx, ny = mx + 1, my + 1
    dtype = f_interior.dtype
    i = jnp.arange(1, nx, dtype=dtype)
    j = jnp.arange(1, ny, dtype=dtype)
    den = (2.0 / dx**2) * (jnp.cos(jnp.pi * i / nx) - 1.0)[:, None] + (
        2.0 / dy**2
    ) * (jnp.cos(jnp.pi * j / ny) - 1.0)[None, :]
    # Transform order: rows, cols | divide | cols, rows.  1D DSTs on
    # different axes commute, so this equals dst1_2d + idst1_2d — but the
    # two axis -2 transforms sit back to back around the elementwise
    # divide, letting XLA cancel their moveaxis transpose pairs (one
    # fewer relayout round trip per Poisson solve; the cavity does 3).
    e = dst1(dst1(f_interior, axis=-1, mesh=mesh, impl=impl,
                  precision=precision),
             axis=-2, mesh=mesh, impl=impl, precision=precision)
    u = dst1(dst1(e / den, axis=-2, mesh=mesh, impl=impl,
                  precision=precision),
             axis=-1, mesh=mesh, impl=impl, precision=precision)
    return u / (4.0 * nx * ny)


# ------------------------------------------------------------- dealiasing

def dealias_mask_23(nx: int, ny: int):
    """Symmetric 2/3-rule mask: with ne = floor(2n/3), keep |k| < ne//2.
    (The reference's index range, pseudospectral_23_rule.jl:124-133, keeps
    one extra negative mode, which breaks Hermitian symmetry of real-field
    spectra; the symmetric band is the standard rule.)"""
    nxe, nye = (2 * nx) // 3, (2 * ny) // 3
    ix = jnp.arange(nx)
    iy = jnp.arange(ny)
    keep_x = (ix < nxe // 2) | (ix > nx - nxe // 2)
    keep_y = (iy < nye // 2) | (iy > ny - nye // 2)
    return keep_x[:, None] & keep_y[None, :]


def _require_even_32(nx: int, ny: int):
    """The 3/2-rule block moves assume even nx/ny: odd sizes would split
    a frequency row across the positive/negative blocks and come back
    one row short (shape (nx-1, ...)) — fail loudly, not downstream."""
    if nx % 2 or ny % 2:
        raise ValueError(
            f"3/2-rule dealiasing requires even grid sizes, got "
            f"({nx}, {ny}); use the 2/3-rule solver for odd grids")


def pad_32(fhat, nxe: int, nye: int):
    """Zero-pad an (nx, ny) spectrum into an (nxe, nye) spectrum (3/2-rule
    dealiasing, pseudospectral_32_rule.jl:124-153), preserving Parseval
    scaling for the round trip (scale by (nxe nye)/(nx ny) on ifft).

    Concat-built (zeros inserted between the positive- and negative-
    frequency blocks): scatters (.at[].set) are 6-25x slower than dataflow
    and miscompile on FFT outputs under GSPMD."""
    nx, ny = fhat.shape[-2], fhat.shape[-1]
    _require_even_32(nx, ny)
    hx, hy = nx // 2, ny // 2
    zc = jnp.zeros(fhat.shape[:-1] + (nye - ny,), fhat.dtype)
    cols = jnp.concatenate([fhat[..., :, :hy], zc, fhat[..., :, hy:]],
                           axis=-1)
    zr = jnp.zeros(fhat.shape[:-2] + (nxe - nx, nye), fhat.dtype)
    return jnp.concatenate([cols[..., :hx, :], zr, cols[..., hx:, :]],
                           axis=-2)


def rfft_wavenumber_index(n: int, dx: float, dtype):
    """Half-axis wavenumbers k_j = hx * j, j = 0..n/2 (the rfft layout),
    with no eps guard — callers fold their own k=0 handling.
    Numpy (build-time constant — see fft_wavenumber_index)."""
    hx = 2 * np.pi / (n * dx)
    return (hx * np.arange(n // 2 + 1)).astype(dtype)


def truncate_32_half(h_e, nx: int, ny: int):
    """truncate_32 for rfft2 HALF spectra: gather an (nxe, nye//2+1) half
    spectrum on the 3/2 grid back to (nx, ny//2+1).

    Columns 0..ny/2-1 map to the same positive frequencies.  The target
    Nyquist column (j = ny/2) must carry the reference's kept coefficient,
    which is the *negative* frequency -ny/2 on the fine grid
    (truncate_32 keeps columns [nye-hy:], i.e. -hy..-1); in half layout
    that is conj(h_e[(nxe - i) % nxe, +hy])."""
    _require_even_32(nx, ny)
    nxe = h_e.shape[-2]
    hx, hy = nx // 2, ny // 2
    rows = jnp.concatenate([h_e[..., :hx, :], h_e[..., nxe - hx :, :]],
                           axis=-2)
    head = rows[..., :, :hy]
    col = jnp.conj(h_e[..., :, hy])                      # (.., nxe)
    col = jnp.concatenate([col[..., :1], col[..., 1:][..., ::-1]],
                          axis=-1)                        # i -> (nxe-i)%nxe
    nyq = jnp.concatenate([col[..., :hx], col[..., nxe - hx :]], axis=-1)
    return jnp.concatenate([head, nyq[..., :, None]], axis=-1)


def truncate_32(fhat_e, nx: int, ny: int):
    """Inverse of pad_32: gather the retained modes back to (nx, ny)."""
    _require_even_32(nx, ny)
    nxe, nye = fhat_e.shape[-2], fhat_e.shape[-1]
    hx, hy = nx // 2, ny // 2
    rows = jnp.concatenate(
        [fhat_e[..., :hx, :], fhat_e[..., nxe - hx :, :]], axis=-2
    )
    return jnp.concatenate(
        [rows[..., :, :hy], rows[..., :, nye - hy :]], axis=-1
    )
