"""Driver benchmark: geodesic throughput on the canonical lamppost workload.

Workload matches the reference perf test (integrator_perf_test.cpp:35-44)
at the dense grid the reference uses for emissivity comparisons
(dcosalpha = dbeta = 0.01 -> 125,800 rays; docs/session_2026-03-01.md:40):
spin 0.998, source at r = 5, theta = 1e-3, march to the disc/escape.

Prints ONE JSON line:
  {"metric": "rk4_steps_per_s_chip", "value": N, "unit": "steps/s",
   "vs_baseline": N / 1e7, "device": {...}, ...}
vs_baseline is against the target of >= 10M RK4 steps/s/chip
(BASELINE.json); the reference CPU whole-box figure is ~4.5e8 steps/s
(BASELINE.md).

Every invocation benches BOTH integrators: the primary method (RK4, or
RT_BENCH_METHOD to override) supplies the metric; the other (RK45 — the
reference's production integrator, emissivity.cpp:91) is measured in the
same process and reported beside it (set RT_BENCH_SECONDARY=0 to skip).
``stuck_ok`` says whether any measured integrator left stuck rays.

Runs only on a GPU: the march goes through the engine ops.use_march_kernel
picks for it, in f32 (source construction in f64, then cast). Without a GPU
it exits with an error rather than timing the CPU.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from raytrace_tpu.config import enable_compilation_cache

enable_compilation_cache()


def bench_once(method):
    """One timed propagation of the canonical workload after a warm-up;
    returns the primary value (useful steps/s) and the secondary-metrics
    record."""
    from raytrace_tpu.ops import trace_auto
    from raytrace_tpu.sources import PointSourceGrid, point_source

    spin = 0.998
    grid = PointSourceGrid.from_steps(0.01, 0.01)
    rays = point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=spin, grid=grid)
    rays = jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, rays
    )
    s = jnp.asarray(spin, jnp.float32)

    # RK4: 30k steps covers every well-behaved ray (the reference measured a
    # 27,154-step max on this workload, docs/session_2026-03-01.md).
    # RK45: well-behaved max is 34,223 (BASELINE.md); 40k bounds the stuck
    # photon-sphere tail while never cutting a legitimate ray.
    steplim = 40_000 if method == "rk45" else 30_000

    def run():
        return jax.block_until_ready(
            trace_auto(rays, s, method=method, r_max=1000.0, steplim=steplim)
        )

    run()  # compile + warm-up
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0

    live = np.asarray(rays.steps) == 0
    steps = np.abs(np.asarray(out.steps)).astype(np.int64)
    stuck = (np.asarray(out.status) & 8) != 0
    done = live & ~stuck
    useful = steps[done].sum()

    value = useful / wall
    pct = np.percentile(steps[done], [50, 90, 99]).tolist() if done.any() else []
    n_stuck = int((stuck & live).sum())
    notes = {
        "method": method,
        "n_rays": int(live.sum()),
        "wall_s": wall,
        "steps_per_s": float(value),
        "rays_per_s": float(live.sum() / wall),
        "stuck_rays": n_stuck,
        "stuck_ok": n_stuck == 0,
        "steps_p50_p90_p99": [round(p) for p in pct],
    }

    if method == "rk45" and os.environ.get("RT_BENCH_REJECTS", "1") != "0":
        # Reject-trial accounting (integrator_perf_test.cpp:119-169
        # analogue): decomposes the RK4<->RK45 throughput ratio into
        # stage-count vs controller-rejection waste. Measured on the 0.05
        # sub-grid (the reference perf-test density) — the fraction is a
        # controller property, not a batch-size one.
        from raytrace_tpu.ops.diagnostics import rk45_reject_stats

        sub = point_source(
            (0.0, 5.0, 1e-3, 0.0), V=0.0, spin=spin,
            grid=PointSourceGrid.from_steps(0.05, 0.05),
        )
        sub = jax.tree.map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, sub
        )
        notes["rejects"] = rk45_reject_stats(sub, s, n_steps=8192)

    return value, notes


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    primary = os.environ.get("RT_BENCH_METHOD", "rk4")
    value, notes = bench_once(primary)

    record = {
        "metric": f"{primary}_steps_per_s_chip",
        "value": round(value),
        "unit": "steps/s",
        "vs_baseline": round(value / 1e7, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        primary: notes,
        "stuck_ok": bool(notes["stuck_ok"]),
    }
    if os.environ.get("RT_BENCH_SECONDARY", "1") != "0":
        # a secondary failure must not suppress the primary metric line:
        # the contract is exactly one JSON line on stdout
        other = "rk45" if primary != "rk45" else "rk4"
        try:
            value2, notes2 = bench_once(other)
            record[f"{other}_steps_per_s"] = round(value2)
            record[other] = notes2
            record["stuck_ok"] = bool(notes["stuck_ok"] and notes2["stuck_ok"])
        except Exception as exc:
            record["secondary_error"] = repr(exc)[:200]
    print(json.dumps(record))


if __name__ == "__main__":
    main()
