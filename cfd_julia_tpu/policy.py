"""What every `auto` option resolves to, per platform: one table.

Keyed by `jax.devices()[0].platform`.  A platform missing from the table
is an error, never a silent default.  The resolvers in models.cavity,
models.vortex and poisson.multigrid read it; nothing else in the package
branches on the platform.

Both rows are the fp32-exact XLA paths, except the `gpu` smoother.  Only
that entry has been raced on the card (PERF.md: the MG 4096^2 solve to
1e-5 on an H100); the rest of the `gpu` row is not yet raced there, and
a benchmark that measures the alternatives is what may change it.
`mg_smoother` names the red-black smoother of large multigrid levels:
"xla" is poisson.iterative.redblack_sweep, "triton" the one-launch
kernel in ops.rb_kernel (levels below `mg_kernel_min` nodes per side
keep the XLA sweep; that threshold is not raced yet).
"""
from __future__ import annotations

POLICY = {
    "cpu": {
        "cavity_poisson": "fst",        # make_step_fn (full-grid state)
        "cavity_solve_poisson": "fst",  # cavity.solve (may pick fused*)
        "vortex_fft_impl": "xla",
        "fft_precision": "highest",
        "mg_transfers": "conv",
        "mg_smoother": "xla",
        "mg_kernel_min": 512,
    },
    "gpu": {
        "cavity_poisson": "fst",
        "cavity_solve_poisson": "fst",
        "vortex_fft_impl": "xla",
        "fft_precision": "highest",
        "mg_transfers": "conv",
        "mg_smoother": "triton",
        "mg_kernel_min": 512,
    },
}


def platform() -> str:
    import jax

    return jax.devices()[0].platform


def choice(key: str, platform_name: str | None = None):
    """The table entry `key` for `platform_name` (default: the platform
    of jax.devices()[0])."""
    name = platform_name or platform()
    if name not in POLICY:
        raise ValueError(
            f"no auto policy for platform {name!r} (known: "
            f"{', '.join(sorted(POLICY))}); pass explicit options instead "
            "of 'auto'")
    return POLICY[name][key]
