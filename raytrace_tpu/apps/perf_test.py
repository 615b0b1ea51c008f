"""Integrator performance harness.

Capability of the reference's ``src/tests/integrator_perf_test.cpp``: for
each integrator on the canonical lamppost workload (spin 0.998, source
r = 5, theta = 1e-3 — integrator_perf_test.cpp:35-44) report

  * wall-clock time of the propagation phase only (compile excluded, the
    reference likewise times run_raytrace alone),
  * step-count percentiles over completed rays (median / p90 / p99 / max),
  * estimated ODE function evaluations (1 per Euler step, 4 per RK4 step,
    6 per accepted DOPRI5 step — integrator_perf_test.cpp:49-50),
  * an ASCII log-binned step histogram (integrator_perf_test.cpp:119-169 —
    the bimodal shape of this histogram is how the reference found its
    stuck-ray RK45_STEPLIM pathology, docs/session_2026-03-01.md:105-137),
  * throughput in steps/s, the figure bench.py tracks.

Par keys (all optional): spin, source (t r theta phi), dcosalpha, dbeta,
r_max, steplim, methods (space-separated subset of euler rk4 rk45),
repeats.
"""

from __future__ import annotations

import time

import numpy as np

import jax

from raytrace_tpu.config import Config, enable_compilation_cache
from raytrace_tpu.ops import StepControl, trace_auto, use_march_kernel
from raytrace_tpu.rays import RAY_STATUS_STEPLIM
from raytrace_tpu.sources import PointSourceGrid, point_source

_FEVALS = {"euler": 1, "rk4": 4, "rk45": 6}


def run_method(rays, spin, method, *, r_max, steplim, ctrl,
               repeats=1):
    """Time one integrator; returns a stats dict."""
    import jax.numpy as jnp

    if use_march_kernel(method):
        # the kernel marches in f32: hand it f32 rays so the timing holds
        # no dtype casts
        dtype = jnp.float32
        rays = jax.tree.map(
            lambda a: a.astype(dtype) if a.dtype == jnp.float64 else a, rays
        )
        s = jnp.asarray(spin, dtype)
    else:
        s = spin

    run = lambda: trace_auto(
        rays, s, method=method, r_max=r_max, steplim=steplim, ctrl=ctrl,
    )
    out = jax.block_until_ready(run())  # warm-up / compile

    best = np.inf
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        best = min(best, time.perf_counter() - t0)

    live = np.asarray(rays.steps) >= 0
    steps = np.abs(np.asarray(out.steps)).astype(np.int64)[live]
    stuck = (np.asarray(out.status)[live] & RAY_STATUS_STEPLIM) != 0
    done = steps[~stuck]
    useful = int(done.sum())
    return {
        "method": method,
        "wall_s": best,
        "n_rays": int(live.sum()),
        "n_stuck": int(stuck.sum()),
        "steps_total": useful,
        "steps_per_s": useful / best,
        "median": float(np.median(done)) if done.size else 0.0,
        "p90": float(np.percentile(done, 90)) if done.size else 0.0,
        "p99": float(np.percentile(done, 99)) if done.size else 0.0,
        "max": int(done.max()) if done.size else 0,
        "fevals": useful * _FEVALS[method],
        "steps": steps,
    }


def step_histogram(steps, width=60, n_bins=12):
    """ASCII log-binned step histogram (integrator_perf_test.cpp:119-169)."""
    steps = steps[steps > 0]
    if steps.size == 0:
        return ["  (no completed rays)"]
    lo, hi = steps.min(), steps.max()
    edges = np.unique(np.geomspace(max(lo, 1), hi + 1, n_bins + 1).astype(np.int64))
    counts, _ = np.histogram(steps, bins=edges)
    peak = max(1, counts.max())
    lines = []
    for i, c in enumerate(counts):
        bar = "#" * max(0, int(round(width * c / peak)))
        lines.append(f"  {edges[i]:>8d}-{edges[i+1]-1:<8d} |{bar} {c}")
    return lines


def main(argv=None):
    enable_compilation_cache()
    cfg = Config(argv)
    spin = cfg.get("spin", float, 0.998)
    source = (cfg.get_array("source", float, 4)
              if cfg.key_exists("source") else [0.0, 5.0, 1e-3, 0.0])
    dca = cfg.get("dcosalpha", float, 0.05)
    db = cfg.get("dbeta", float, 0.05)
    r_max = cfg.get("r_max", float, 1000.0)
    steplim = cfg.get("steplim", int, 30_000)
    repeats = cfg.get("repeats", int, 1)
    methods = cfg.get("methods", str, "euler rk4 rk45").split()

    grid = PointSourceGrid.from_steps(dca, db)
    rays = point_source(tuple(source), V=0.0, spin=spin, grid=grid)
    print(f"integrator perf test: {grid.n_rays} rays, spin {spin}, "
          f"source r = {source[1]}, device {jax.devices()[0].device_kind}")

    ctrl = StepControl()
    results = []
    for m in methods:
        st = run_method(rays, spin, m, r_max=r_max, steplim=steplim,
                        ctrl=ctrl, repeats=repeats)
        results.append(st)
        print(f"\n== {m} ==")
        print(f"  propagation wall time   {st['wall_s']*1e3:10.1f} ms"
              f"  ({st['n_rays']} rays, {st['n_stuck']} stuck)")
        print(f"  steps total / per s     {st['steps_total']:>10d} /"
              f" {st['steps_per_s']:.3e}")
        print(f"  steps median/p90/p99/max  {st['median']:.0f} /"
              f" {st['p90']:.0f} / {st['p99']:.0f} / {st['max']}")
        print(f"  est. function evals     {st['fevals']:>10d}")
        if m == "rk45" and cfg.get("rejects", bool, True):
            # reject-trial accounting (the step-histogram's adaptive-path
            # sibling; analysis/rk45_rejects.py): trials the controller
            # refused — full 7-stage evaluations that advanced nothing
            try:
                from raytrace_tpu.ops.diagnostics import rk45_reject_stats

                rj = rk45_reject_stats(rays, spin, r_max=r_max,
                                       n_steps=8192, ctrl=ctrl)
                print(f"  reject fraction p50/p90/p99/mean  "
                      f"{rj['reject_frac_p50']:.3f} / {rj['reject_frac_p90']:.3f}"
                      f" / {rj['reject_frac_p99']:.3f} / {rj['reject_frac_mean']:.3f}"
                      f"  ({rj['rejects_total']} of {rj['trials_total']} trials,"
                      f" {rj['n_unfinished']} unfinished)")
            except Exception as exc:
                print(f"  reject stats unavailable: {exc!r}")
        print("  step histogram:")
        for line in step_histogram(st["steps"]):
            print(line)

    if len(results) > 1:
        base = results[0]
        print("\n== ratios vs", base["method"], "==")
        for st in results[1:]:
            print(f"  {st['method']}: wall {st['wall_s']/base['wall_s']:.2f}x,"
                  f" fevals {st['fevals']/max(1, base['fevals']):.2f}x")
    # console-script entry: a truthy return becomes a non-zero exit status
    return 0


if __name__ == "__main__":
    main()
