"""Multi-chip paths on the 8-virtual-device CPU mesh: manual halo-exchange
stencils match the single-device ops; sharded full steps (pencil-FFT
Poisson + stencils) compile, execute, and match unsharded results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_julia_tpu.models import cavity as cavity_model
from cfd_julia_tpu.models import vortex as vortex_model
from cfd_julia_tpu.ops import arakawa
from cfd_julia_tpu.parallel import halo, mesh as mesh_lib, sharded


@pytest.fixture(scope="module")
def mesh2d():
    assert len(jax.devices()) == 8, jax.devices()
    return mesh_lib.make_mesh()


def test_mesh_factorization():
    assert mesh_lib.factor_2d(8) == (2, 4)
    assert mesh_lib.factor_2d(16) == (4, 4)
    assert mesh_lib.factor_2d(7) == (1, 7)


def test_distributed_rhs_matches_single(mesh2d):
    rng = np.random.default_rng(0)
    n = 32
    dx = dy = 2 * np.pi / n
    w = jnp.asarray(rng.standard_normal((n, n)))
    s = jnp.asarray(rng.standard_normal((n, n)))
    ref = arakawa.vorticity_rhs(w, s, dx, dy, 100.0)
    dist = halo.make_distributed_vorticity_rhs(mesh2d, dx, dy, 100.0)
    out = dist(sharded.place(w, mesh2d), sharded.place(s, mesh2d))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


def test_distributed_jacobi_converges(mesh2d):
    """Distributed periodic Jacobi reduces the Poisson error."""
    n = 32
    dx = dy = 1.0 / n
    x = jnp.arange(n) * dx
    X, Y = jnp.meshgrid(x, x, indexing="ij")
    ue = jnp.sin(2 * jnp.pi * X) * jnp.sin(2 * jnp.pi * Y)
    f = -8 * jnp.pi**2 * ue
    sweep = halo.make_distributed_jacobi_step(mesh2d, dx, dy)
    u = sharded.place(jnp.zeros_like(f), mesh2d)
    fs = sharded.place(f, mesh2d)
    for _ in range(200):
        u = sweep(u, fs)
    u = u - jnp.mean(u)
    err0 = float(jnp.abs(ue).max())
    err = float(jnp.abs(u - ue).max())
    assert err < 0.5 * err0, (err, err0)


def test_sharded_cavity_step_matches(mesh2d):
    cfg = cavity_model.CavityConfig(nx=32, ny=32)
    w0 = jnp.zeros((33, 33))
    s0 = jnp.zeros_like(w0)
    ref_step = cavity_model.make_step_fn(cfg)
    ref = (w0, s0, jnp.zeros(()))
    for _ in range(4):
        ref = ref_step(ref)

    step_sharded = sharded.make_sharded_cavity_step(cfg, mesh2d)
    st = (
        sharded.place(sharded.pad_to_mesh(w0, mesh2d), mesh2d),
        sharded.place(sharded.pad_to_mesh(s0, mesh2d), mesh2d),
        jnp.zeros(()),
    )
    for _ in range(4):
        st = step_sharded(st)
    np.testing.assert_allclose(np.asarray(st[0])[:33, :33], np.asarray(ref[0]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st[1])[:33, :33], np.asarray(ref[1]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(st[2]), float(ref[2]), rtol=1e-10)


def test_sharded_cavity_no_rematerialization(mesh2d, capfd):
    """The padded cavity step must partition without GSPMD 'involuntary
    full rematerialization' (the slice/concat BC assembly used to trigger
    it on every stage).  Compile cache disabled so a warm cache can't skip
    partitioning and trivially pass."""
    cache_dir = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        cfg = cavity_model.CavityConfig(nx=32, ny=32)
        step = sharded.make_sharded_cavity_step(cfg, mesh2d)
        st = (
            sharded.place(sharded.pad_to_mesh(jnp.zeros((33, 33)), mesh2d),
                          mesh2d),
            sharded.place(sharded.pad_to_mesh(jnp.zeros((33, 33)), mesh2d),
                          mesh2d),
            jnp.zeros(()),
        )
        jax.block_until_ready(step(st))
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    err = capfd.readouterr().err
    assert "Involuntary full rematerialization" not in err, err[-2000:]


@pytest.mark.parametrize("solver", ["ps23", "ps32", "hybrid", "fdm"])
def test_sharded_vortex_step_matches(mesh2d, solver):
    cfg = vortex_model.VortexConfig(nx=32, ny=32, solver=solver, t_final=0.1)
    dtype = jnp.float64
    w0 = vortex_model.initial_vorticity(cfg, dtype)
    if solver == "fdm":
        x0 = w0
        from cfd_julia_tpu.stepping import ssprk3

        rhs = lambda w: vortex_model.fdm_rhs(w, cfg.dx, cfg.dy, cfg.re)
        ref_step = lambda w: ssprk3.ssprk3_step(rhs, w, cfg.dt)
    else:
        from cfd_julia_tpu.ops import spectral

        wf0 = spectral.zero_mean_mode(
            jnp.fft.fft2(w0.astype(jnp.complex128)))
        ref_step = vortex_model.make_spectral_step(cfg, dtype)
        ref = spectral.pack_c(ref_step(wf0))
        # the sharded step's boundary is the PACKED real Re/Im stack
        step_sharded = sharded.make_sharded_vortex_step(cfg, mesh2d, dtype)
        out = step_sharded(jax.device_put(
            spectral.pack_c(wf0), sharded.packed_full_sharding(mesh2d)))
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-10, atol=1e-12)
        return
    ref = ref_step(x0)

    step_sharded = sharded.make_sharded_vortex_step(cfg, mesh2d, dtype)
    out = step_sharded(sharded.place(x0, mesh2d))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-10, atol=1e-12)


def test_distributed_burgers_weno_rhs():
    """Width-3 halo WENO-5 RHS on a 1D 8-device mesh matches the
    single-device periodic form."""
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from cfd_julia_tpu.models.burgers1d import _rhs_upwind_periodic
    from cfd_julia_tpu.ops import weno as weno_ops

    devs = np.array(jax.devices())
    mesh1d = Mesh(devs, ("x",))
    n = 256
    dx = 1.0 / n
    u = jnp.sin(2 * jnp.pi * jnp.arange(n) / n) + 0.3
    ref = _rhs_upwind_periodic(
        u, dx,
        lambda v: weno_ops.reconstruct_left(v, "periodic"),
        lambda v: weno_ops.reconstruct_right(v, "periodic"),
    )
    rhs = halo.make_distributed_burgers_weno_rhs(mesh1d, dx)
    us = jax.device_put(u, NamedSharding(mesh1d, P("x")))
    out = rhs(us)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("solver", ["ps23", "ps32", "hybrid"])
def test_sharded_half_packed_step_matches(mesh2d, solver):
    """The HALF-SPECTRUM packed step (the fast formulation) under the
    mesh (pencil rfft2/ifft2, sharded packed state) matches the
    single-device half-packed step."""
    cfg = vortex_model.VortexConfig(nx=32, ny=32, solver=solver, dt=5e-3)
    dtype = jnp.float64
    w0 = vortex_model.initial_vorticity(cfg, dtype)
    h0 = jax.jit(vortex_model.half_init_packed)(w0)

    ref_step = vortex_model.make_spectral_step_half_packed(cfg, dtype)
    ref = ref_step(ref_step(h0))

    step_sh = sharded.make_sharded_vortex_step_half(cfg, mesh2d, dtype)
    h = jax.device_put(h0, sharded.packed_half_sharding(mesh2d))
    out = step_sh(step_sh(h))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-10, atol=1e-12)


def test_sharded_cavity_fst_half_matches(mesh2d):
    """poisson='fst_half' under the mesh (pencil half-length DST) matches
    the single-device step."""
    cfg = cavity_model.CavityConfig(nx=32, ny=32, poisson="fst_half")
    w0 = jnp.zeros((33, 33))
    ref_step = cavity_model.make_step_fn(cfg)
    ref = (w0, jnp.zeros_like(w0), jnp.zeros(()))
    for _ in range(3):
        ref = ref_step(ref)

    step_m = jax.jit(cavity_model.make_step_fn(cfg, mesh=mesh2d))
    st = (w0, jnp.zeros_like(w0), jnp.zeros(()))
    for _ in range(3):
        st = step_m(st)
    np.testing.assert_allclose(np.asarray(st[0]), np.asarray(ref[0]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st[1]), np.asarray(ref[1]),
                               rtol=1e-10, atol=1e-12)


def test_weak_scaling_device_counts_agree():
    """The sharded fast-path step produces the same trajectory on 1-, 2-,
    4- and 8-device meshes (the correctness half of the weak-scaling
    harness, benchmarks/multichip_scaling.py)."""
    cfg = vortex_model.VortexConfig(nx=32, ny=32, solver="ps23", dt=5e-3)
    dtype = jnp.float64
    w0 = vortex_model.initial_vorticity(cfg, dtype)
    h0 = jax.jit(vortex_model.half_init_packed)(w0)
    outs = {}
    for ndev in (1, 2, 4, 8):
        mesh = mesh_lib.make_mesh(jax.devices()[:ndev])
        step = sharded.make_sharded_vortex_step_half(cfg, mesh, dtype)
        h = jax.device_put(h0, sharded.packed_half_sharding(mesh))
        outs[ndev] = np.asarray(step(step(h)))
    for ndev in (2, 4, 8):
        np.testing.assert_allclose(outs[ndev], outs[1],
                                   rtol=1e-10, atol=1e-12)


def test_sharded_checkpoint_roundtrip(mesh2d, tmp_path):
    """orbax sharded checkpointing: a mesh-sharded state saves without a
    host gather and restores with values AND shardings intact."""
    from cfd_julia_tpu.utils import checkpoint

    sh = mesh_lib.field_sharding(mesh2d)
    w = jax.device_put(
        jnp.arange(64.0 * 64).reshape(64, 64).astype(jnp.float64), sh)
    t = jax.device_put(jnp.float64(1.5), mesh_lib.replicated(mesh2d))
    state = {"w": w, "t": t}
    path = tmp_path / "ckpt"
    checkpoint.save_sharded(str(path), state)
    back = checkpoint.load_sharded(str(path), state)
    np.testing.assert_array_equal(np.asarray(back["w"]), np.asarray(w))
    assert float(back["t"]) == 1.5
    assert back["w"].sharding.is_equivalent_to(sh, w.ndim)
    # restored shards continue stepping under the same mesh program
    out = jax.jit(lambda s: s["w"] * 2.0 + s["t"])(back)
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(w) * 2.0 + 1.5)


def _mg_problem(nx, dtype=jnp.float64):
    from cfd_julia_tpu.models import poisson2d
    from cfd_julia_tpu.poisson import multigrid

    mgc = multigrid.MGConfig(tol=1e-8, max_cycles=30, transfers="matmul",
                             smoother="cheb")
    cfg = poisson2d.PoissonConfig(nx=nx, ny=nx, solver="multigrid",
                                  problem="poly", mg=mgc)
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, dtype)
    u0 = poisson2d._dirichlet_init(ue)
    return mgc, f, u0, cfg.dx, cfg.dy


def test_mesh_multigrid_matches_single_device(mesh2d):
    """The GSPMD V-cycle solve: same cfg, same
    trajectory — the ONLY difference is the mesh, so any sharding-induced
    divergence (halo handling, agglomeration edges, partitioned matmul
    transfers) shows up as a mismatch here."""
    from cfd_julia_tpu.poisson import multigrid

    mgc, f, u0, dx, dy = _mg_problem(64)
    ref = multigrid.solve(f, u0, dx, dy, cfg=mgc)
    # unpadded (65, 65) inputs go in as-is: the mesh path pads + shards
    # internally (device_put of a ragged field sharding is rejected by
    # jax, so there is nothing useful to pre-place here)
    out = multigrid.solve(f, u0, dx, dy, cfg=mgc, mesh=mesh2d)
    assert int(out.iterations) == int(ref.iterations)
    assert float(out.rms / out.rms0) <= mgc.tol
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               rtol=1e-10, atol=1e-12)


def test_mesh_multigrid_device_counts_agree():
    """Same solution on 1-, 2-, 4- and 8-device meshes."""
    from cfd_julia_tpu.poisson import multigrid

    mgc, f, u0, dx, dy = _mg_problem(64)
    outs = {}
    for ndev in (1, 2, 4, 8):
        mesh = mesh_lib.make_mesh(jax.devices()[:ndev])
        r = multigrid.solve(f, u0, dx, dy, cfg=mgc, mesh=mesh)
        outs[ndev] = np.asarray(r.u)
    for ndev in (2, 4, 8):
        np.testing.assert_allclose(outs[ndev], outs[1],
                                   rtol=1e-10, atol=1e-12)


def test_mesh_multigrid_rejects_single_device_options(mesh2d):
    """conv transfers / the bf16 cycle are single-device; the mesh
    path must reject them loudly, never silently fall back."""
    from cfd_julia_tpu.poisson import multigrid

    mgc, f, u0, dx, dy = _mg_problem(32)
    import dataclasses as dc
    with pytest.raises(ValueError, match="transfers"):
        multigrid.solve(f, u0, dx, dy,
                        cfg=dc.replace(mgc, transfers="conv"), mesh=mesh2d)
    with pytest.raises(ValueError, match="single-device"):
        multigrid.solve(f, u0, dx, dy,
                        cfg=dc.replace(mgc, cycle_dtype="bf16"),
                        mesh=mesh2d)


def test_mesh_multigrid_fmg(mesh2d):
    """The FMG (nested-iteration) start also runs under the mesh."""
    from cfd_julia_tpu.poisson import multigrid

    mgc, f, u0, dx, dy = _mg_problem(64)
    import dataclasses as dc
    mgf = dc.replace(mgc, fmg=True)
    ref = multigrid.solve(f, u0, dx, dy, cfg=mgf)
    out = multigrid.solve(f, u0, dx, dy, cfg=mgf, mesh=mesh2d)
    assert float(out.rms / out.rms0) <= mgc.tol
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               rtol=1e-10, atol=1e-12)
