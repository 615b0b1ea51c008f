"""RK45 accept/reject observability — study CLI.

Core accounting lives in ``raytrace_tpu.ops.diagnostics`` (importable
from installed console scripts); this script runs the canonical-workload
sweep table:

    python -m analysis.rk45_rejects [tol ...]

The reject fraction is a property of the controller and the tolerance,
not of the device; bench.py reports it beside the RK45 rate.
"""

from __future__ import annotations

from raytrace_tpu.ops.diagnostics import rk45_reject_stats  # noqa: F401


def main(argv=None):
    import sys

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace_tpu.config import enable_compilation_cache
    from raytrace_tpu.ops import use_march_kernel
    from raytrace_tpu.ops.integrate import StepControl
    from raytrace_tpu.sources import PointSourceGrid, point_source

    enable_compilation_cache()
    tols = [float(t) for t in (argv or sys.argv[1:])] or [1e-6, 1e-8, 1e-10]
    spin = 0.998
    grid = PointSourceGrid.from_steps(0.05, 0.05)
    rays = point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=spin, grid=grid)
    if use_march_kernel("rk45"):
        # measure the controller in the precision the GPU march runs in
        rays = jax.tree.map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a,
            rays,
        )
    print(f"canonical lamppost workload, {int((np.asarray(rays.steps) == 0).sum())} "
          f"rays, device={jax.devices()[0].device_kind}")
    for tol in tols:
        stats = rk45_reject_stats(
            rays, jnp.asarray(spin, rays.r.dtype),
            ctrl=StepControl(rk45_tol=tol),
        )
        print(f"tol={tol:g}: {stats}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
