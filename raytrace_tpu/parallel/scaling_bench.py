"""Multi-chip / multi-host scaling benchmark harness.

Measures rays/s for the canonical lamppost workload over growing mesh
sizes and reports weak-scaling efficiency (BASELINE target: > 90% rays/s
efficiency from 1 chip to N >= 2 hosts).

Run single-host (mesh over local chips):
    python -m raytrace_tpu.parallel.scaling_bench

Run multi-host (one process per host, before anything touches jax):
    import jax; jax.distributed.initialize()
    ...same entry point; the mesh spans all addressable devices and every
    function here is host-agnostic SPMD.

On CPU the mesh is virtual (XLA_FLAGS=--xla_force_host_platform_device_count)
and wall-clock efficiency is meaningless (shards share the host) — the run
then only validates mechanics. The workload is embarrassingly parallel with
a single psum per observable, so across real cards the scaling loss is
bounded by the one collective plus load imbalance between ray shards.
"""

from __future__ import annotations

import json
import time

import jax
import numpy as np


def run(mesh_sizes=None, n_rays_per_shard=16384, steplim=4000):
    from raytrace_tpu.ops.reductions import bin_edges
    from raytrace_tpu.parallel import (
        make_ray_mesh,
        pad_rays,
        shard_rays,
        sharded_emissivity_bins,
    )
    from raytrace_tpu.sources import PointSourceGrid, point_source

    n_dev = jax.device_count()
    if mesh_sizes is None:
        mesh_sizes = [s for s in (1, 2, 4, 8, 16, 32, 64) if s <= n_dev]

    spin = 0.998
    results = []
    for n in mesh_sizes:
        # weak scaling: rays proportional to shards
        total = n_rays_per_shard * n
        d = float(np.sqrt(2.0 * 2 * np.pi / total))
        grid = PointSourceGrid.from_steps(d, d, -0.995, 0.995, -np.pi, np.pi)
        rays = point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=spin, grid=grid)
        mesh = make_ray_mesh(n)
        rays = shard_rays(pad_rays(rays, n), mesh)

        r_min = 1.3
        _, _, dr = bin_edges(r_min, 500.0, 100, True)
        kw = dict(
            r_min=r_min, dr=float(dr), n_r=100,
            n_primary=float(grid.n_rays), method="rk4", r_max=1000.0,
            steplim=steplim,
        )
        counts, _ = sharded_emissivity_bins(rays, spin, mesh, **kw)
        np.asarray(counts)  # compile + run
        t0 = time.time()
        counts, _ = sharded_emissivity_bins(rays, spin, mesh, **kw)
        np.asarray(counts)
        dt = time.time() - t0
        rps = rays.n_rays / dt
        results.append({"shards": n, "rays": rays.n_rays, "wall_s": round(dt, 4),
                        "rays_per_s": round(rps)})
        print(json.dumps(results[-1]))

    if len(results) > 1:
        base = results[0]["rays_per_s"] / results[0]["rays"] * results[0]["rays"]
        per_shard0 = results[0]["rays_per_s"]
        for r in results[1:]:
            eff = (r["rays_per_s"] / r["shards"]) / per_shard0
            r["weak_scaling_efficiency"] = round(eff, 3)
            print(f"shards={r['shards']}: weak-scaling efficiency {eff:.1%}")
    return results


if __name__ == "__main__":
    run()
