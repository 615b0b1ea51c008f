"""RK45 tolerance sweep on the binned emissivity profile.

Capability of the reference's ``src/tests/emissivity_rk45_tol_sweep.py``:
run the full emissivity pipeline under RK4 (tolerance-free baseline) and
under DOPRI5 at a sweep of rk45_tol values, compare per-radial-bin
emissivity on well-populated bins (>= 100 rays in both runs AND ray counts
within 10% — the reference's count-gating methodology,
emissivity_rk45_test.cpp:57-63), and report RMS / max relative deviation
plus wall time per tolerance.

The reference's documented result (docs/session_2026-03-01.md:235-258):
the deviation is FLAT in tolerance (RMS 11.8-13.4% over 1e-6..1e-10) —
the photon-sphere separatrix disagreement is topological, not
accuracy-driven. This script reproduces that diagnostic for this
framework.

Usage:
    python -m analysis.tol_sweep [--dcosalpha=0.05] [--out=tol_sweep.csv]
                                 [--plot=tol_sweep.png]
"""

from __future__ import annotations

import sys
import time

import numpy as np


def sweep(tols=(1e-6, 1e-7, 1e-8, 1e-9, 1e-10), dcosalpha=0.05, dbeta=0.05,
          spin=0.998, source=(0.0, 5.0, 1e-3, 0.0), count_min=100, n_r=100):
    from raytrace_tpu.apps.emissivity import compute
    from raytrace_tpu.ops import StepControl
    from raytrace_tpu.sources import PointSourceGrid

    grid = PointSourceGrid.from_steps(dcosalpha, dbeta)

    def run(method, tol=None):
        ctrl = StepControl() if tol is None else StepControl(rk45_tol=tol)
        t0 = time.perf_counter()
        out = compute(spin, source, 0.0, grid, method=method, ctrl=ctrl, n_r=n_r)
        return out, time.perf_counter() - t0

    base, _ = run("rk4")
    # warm-up so the first swept tolerance is not charged for compilation
    run("rk45", tols[0])

    rows = []
    for tol in tols:
        out, wall = run("rk45", tol)
        good = (
            (base["rays"] >= count_min)
            & (out["rays"] >= count_min)
            & (np.abs(out["rays"] - base["rays"]) <= 0.1 * base["rays"])
        )
        dev = np.abs(out["emis"][good] / base["emis"][good] - 1.0)
        rows.append({
            "tol": tol,
            "wall_s": wall,
            "n_bins": int(good.sum()),
            "rms_dev": float(np.sqrt(np.mean(dev**2))) if good.any() else np.nan,
            "max_dev": float(dev.max()) if good.any() else np.nan,
        })
    return rows


def main(argv=None):
    from raytrace_tpu.config import Config, enable_compilation_cache

    enable_compilation_cache()
    cfg = Config(argv if argv is not None else sys.argv[1:])
    dca = cfg.get("dcosalpha", float, 0.05)
    db = cfg.get("dbeta", float, 0.05)
    out_csv = cfg.get("out", str, "tol_sweep.csv")
    plot = cfg.get("plot", str, "")
    count_min = cfg.get("count_min", int, 100)
    n_r = cfg.get("Nr", int, 100)

    rows = sweep(dcosalpha=dca, dbeta=db, count_min=count_min, n_r=n_r)
    with open(out_csv, "w") as f:
        f.write("tol,wall_s,n_bins,rms_dev,max_dev\n")
        for r in rows:
            f.write(f"{r['tol']:.1e},{r['wall_s']:.3f},{r['n_bins']},"
                    f"{r['rms_dev']:.4f},{r['max_dev']:.4f}\n")
            print(f"tol {r['tol']:.0e}: {r['n_bins']} bins, "
                  f"RMS dev {100*r['rms_dev']:.1f}%, max {100*r['max_dev']:.1f}%, "
                  f"wall {r['wall_s']:.2f}s")
    print(f"wrote {out_csv}")

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        tols = [r["tol"] for r in rows]
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.5))
        ax1.loglog(tols, [r["rms_dev"] for r in rows], "o-", label="RMS")
        ax1.loglog(tols, [r["max_dev"] for r in rows], "s--", label="max")
        ax1.set_xlabel("rk45_tol"); ax1.set_ylabel("emissivity deviation vs RK4")
        ax1.legend()
        ax2.semilogx(tols, [r["wall_s"] for r in rows], "o-")
        ax2.set_xlabel("rk45_tol"); ax2.set_ylabel("wall time [s]")
        fig.tight_layout(); fig.savefig(plot, dpi=120)
        print(f"wrote {plot}")
    return rows


if __name__ == "__main__":
    main()
