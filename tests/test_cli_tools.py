"""CLI order study, plot generation, and writer round-trips."""
import os

import numpy as np

from cfd_julia_tpu import cli, run
from cfd_julia_tpu.utils import plotting


def test_order_study_heat_icp(tmp_path, capsys):
    rc = cli.main(["order", "heat", "--scheme", "icp",
                   "--grids", "20,40,80", "--outdir", str(tmp_path)])
    assert rc == 0
    txt = (tmp_path / "order.txt").read_text()
    orders = [float(v) for v in txt.splitlines()[-1].split(":")[1].split()]
    assert all(p > 3.5 for p in orders), orders
    assert (tmp_path / "order.png").exists()


def _self_rows(path):
    rows = [line.split() for line in path.read_text().splitlines()
            if not line.startswith("#")]
    return [(r[3], float(r[6])) for r in rows]  # (norm, p)


def test_order_self_burgers_crweno_dirichlet(tmp_path):
    """Grid-pair self-convergence (06_.../order.jl:53-75) on the
    dirichlet CRWENO solve — the reference case with NO exact solution.
    CRWENO-5 on the pre-shock smooth profile: observed p well above 3.5
    in every norm (measured ~4.2-6.0 across the triplets)."""
    rc = cli.main(["order", "burgers", "--scheme", "crweno", "--self",
                   "--bc", "dirichlet", "--grids", "100,200,400",
                   "--outdir", str(tmp_path)])
    assert rc == 0
    rows = _self_rows(tmp_path / "order_self.txt")
    assert rows and all(p > 3.5 for _, p in rows), rows
    assert (tmp_path / "order_self.png").exists()


def test_order_self_poisson_fdm(tmp_path):
    """FDM-eigenvalue FFT Poisson self-converges at order 2 without
    consulting the exact solution (12_.../fft_p.jl discretization)."""
    rc = cli.main(["order", "poisson", "--scheme", "fft", "--self",
                   "--grids", "32,64,128", "--outdir", str(tmp_path)])
    assert rc == 0
    rows = _self_rows(tmp_path / "order_self.txt")
    assert rows and all(abs(p - 2.0) < 0.3 for _, p in rows), rows


def test_order_self_needs_three_grids(tmp_path):
    assert cli.main(["order", "poisson", "--scheme", "fft", "--self",
                     "--grids", "32,64", "--outdir", str(tmp_path)]) == 2


def test_plot_cavity_and_heat(tmp_path):
    d1 = tmp_path / "cav"
    run.run_preset("cavity", outdir=str(d1), t_final=0.2)
    assert cli.main(["plot", str(d1)]) == 0
    assert (d1 / "contours.png").exists()

    d2 = tmp_path / "heat"
    run.run_preset("heat_cn", outdir=str(d2))
    assert cli.main(["plot", str(d2)]) == 0
    assert (d2 / "field_final.png").exists()


def test_plot_residual_comparison(tmp_path):
    d = tmp_path / "cg"
    run.run_preset("poisson_cg", outdir=str(d), nx=64, ny=64)
    assert cli.main(["plot", str(d)]) == 0
    assert (d / "residuals.png").exists()


def test_cli_no_prefix_abbreviation(tmp_path):
    """argparse prefix matching consumed '--re 1000' as --resume, making
    the documented Reynolds override impossible (review repro); stray
    flags on non-run subcommands are rejected instead of silently
    ignored ('bench --quik' ran the FULL bench)."""
    rc = cli.main(["run", "cavity", "--outdir", str(tmp_path),
                   "--re", "400", "--t_final", "0.005", "--dt", "0.001",
                   "--nx", "16", "--ny", "16"])
    assert rc == 0
    import json as _json

    m = _json.load(open(tmp_path / "metrics.json"))
    assert m["preset"] == "cavity"
    assert cli.main(["bench", "--quik"]) == 2
    assert cli.main(["run", "heat_ftcs", "--nx"]) == 2  # missing value


def test_observed_orders_helper():
    ns = [32, 64, 128]
    errs = [1e-2, 2.5e-3, 6.25e-4]
    p = plotting.observed_orders(ns, errs)
    np.testing.assert_allclose(p, [2.0, 2.0])


def test_sod_plot(tmp_path):
    d = tmp_path / "sod"
    run.run_preset("euler_roe", outdir=str(d), nx=128, dt=2e-4)
    assert cli.main(["plot", str(d)]) == 0
    assert (d / "sod.png").exists()


def test_import_does_not_init_backend():
    """`python -m cfd_julia_tpu list` must work with the platform pointing
    at a backend that cannot start: importing presets (hence every
    model/ops/poisson module) may not initialize a JAX backend.  A
    module-level jnp constant is enough to break this (it compiles on the
    default backend at import)."""
    import subprocess
    import sys

    code = (
        "import os\n"
        "os.environ['JAX_PLATFORMS'] = 'no_such_backend'\n"
        "import jax._src.xla_bridge as xb\n"
        "def _trap(*a, **k): raise SystemExit('backend init at import')\n"
        "xb.backends = _trap\n"
        "from cfd_julia_tpu import presets\n"
        "print('ok', len(presets.PRESETS))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 0 and r.stdout.startswith("ok"), \
        (r.stdout, r.stderr[-800:])
