"""Returning radiation: disc-to-disc re-illumination.

Capability of the reference return_radiation family (src/return_radiation/,
bitrotted): launch rays isotropically (optionally limb-darkened) from a
point ON the disc surface (theta = pi/2 - eps, material in Keplerian
orbit), trace them, and measure

  * ``disc_source_photonfrac``    — fractions returning to the disc vs
    escaping vs captured, per launch radius;
  * ``disc_source_photonfrac_r``  — the returning fraction binned by
    landing radius (the re-illumination kernel);
  * ``disc_source_return_angdist``— the angular emission distribution of
    the rays that return (which launch directions come back).

Strong gravity bends a large fraction of inner-disc emission back onto the
disc — the returning-radiation correction to emissivity profiles.
"""

from __future__ import annotations

import sys

import numpy as np

import jax.numpy as jnp

from raytrace_tpu.config import Config, enable_compilation_cache
from raytrace_tpu.geometry import isco_radius, keplerian_omega
from raytrace_tpu.io import TextOutput
from raytrace_tpu.ops import StepControl, trace_auto
from raytrace_tpu.ops.reductions import bin_edges, radial_bin_profile
from raytrace_tpu.ops.redshift import apply_redshift, range_phi, redshift_start
from raytrace_tpu.rays import RAY_STATUS_DEST, RAY_STATUS_HORIZON, RAY_STATUS_RLIM
from raytrace_tpu.sources import PointSourceGrid, point_source

DISC_EPS = 1e-3  # launch height above the disc plane (disc_source_photonfrac.cpp:55-62)


def disc_source_rays(r_launch, spin, grid: PointSourceGrid):
    """Ray batch from a point on the disc at radius r_launch, orbiting
    Keplerian."""
    V = keplerian_omega(r_launch, spin)
    return point_source(
        (0.0, r_launch, jnp.pi / 2 - DISC_EPS, 0.0), V, spin, grid
    )


def photon_fractions(
    r_launch,
    spin,
    grid: PointSourceGrid,
    r_esc=500.0,
    r_disc=500.0,
    method="rk45",
    steplim=20000,
    ctrl=StepControl(),
):
    """Trace one disc-source launch radius; returns the per-fate counts and
    the traced batch (for downstream binning)."""
    rays = disc_source_rays(r_launch, spin, grid)
    rays = redshift_start(rays, spin, V=keplerian_omega(r_launch, spin))
    out = trace_auto(rays, spin, method=method, r_max=r_esc, steplim=steplim, ctrl=ctrl)
    out = range_phi(out)
    out = apply_redshift(out, spin, V=-1.0)

    st = np.asarray(out.status)
    live = np.asarray(rays.steps) == 0
    r_isco = float(isco_radius(spin))
    r_end = np.asarray(out.r)
    disc_hit = (
        ((st & RAY_STATUS_DEST) != 0)
        & (r_end >= r_isco)
        & (r_end < r_disc)
        & live
    )
    horizon = ((st & RAY_STATUS_HORIZON) != 0) & live
    escaped = ((st & RAY_STATUS_RLIM) != 0) & live
    # rays crossing inside the ISCO terminate on the plane; they plunge
    plunge = ((st & RAY_STATUS_DEST) != 0) & (r_end < r_isco) & live
    return {
        "n_live": int(live.sum()),
        "n_return": int(disc_hit.sum()),
        "n_escape": int(escaped.sum()),
        "n_horizon": int(horizon.sum() + plunge.sum()),
        "out": out,
        "return_mask": disc_hit,
        "live": live,
    }


def main_photonfrac(argv=None):
    """Return/escape/capture fractions per launch radius
    (disc_source_photonfrac.cpp)."""
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    spin = cfg.get("spin", float)
    grid = PointSourceGrid.from_steps(
        cfg.get("dcosalpha", float, 0.05),
        cfg.get("dbeta", float, 0.05),
        cfg.get("cosalpha0", float, -0.995),
        cfg.get("cosalphamax", float, 0.995),
        cfg.get("beta0", float, -np.pi),
        cfg.get("betamax", float, np.pi),
    )
    r_esc = cfg.get("r_esc", float, 500.0)
    r0 = cfg.get("r0", float, float(isco_radius(spin)) * 1.01)
    r_max = cfg.get("rmax", float, 50.0)
    n_r = cfg.get("Nr", int, 20)
    logbin = cfg.get("logbin_r", bool, True)
    steplim = cfg.get("steplim", int, 20000)

    radii, _, _ = bin_edges(r0, r_max, n_r, logbin)
    from raytrace_tpu.utils.progress import ProgressBar

    bar = ProgressBar(len(np.asarray(radii)), label="launch radii")
    with TextOutput(outfile) as f:
        for i, r_l in enumerate(np.asarray(radii)):
            res = photon_fractions(float(r_l), spin, grid, r_esc=r_esc,
                                   r_disc=r_esc, steplim=steplim)
            n = max(res["n_live"], 1)
            f.row(r_l, res["n_return"] / n, res["n_escape"] / n,
                  res["n_horizon"] / n, res["n_live"])
            bar.show(i + 1, extra=f"r={r_l:.3f} return {res['n_return']/n:.3f} "
                     f"escape {res['n_escape']/n:.3f} "
                     f"capture {res['n_horizon']/n:.3f}")
    bar.done()
    print(f"wrote {outfile}")
    return 0


def main_photonfrac_r(argv=None):
    """Returning flux binned by landing radius (disc_source_photonfrac_r.cpp)."""
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    spin = cfg.get("spin", float)
    r_launch = cfg.get("r_source", float, 6.0)
    grid = PointSourceGrid.from_steps(
        cfg.get("dcosalpha", float, 0.02),
        cfg.get("dbeta", float, 0.02),
    )
    r_esc = cfg.get("r_esc", float, 500.0)
    n_r = cfg.get("Nr", int, 50)
    logbin = cfg.get("logbin_r", bool, True)
    r_min = float(isco_radius(spin))
    r_disc = cfg.get("r_disc", float, 100.0)
    steplim = cfg.get("steplim", int, 20000)

    res = photon_fractions(r_launch, spin, grid, r_esc=r_esc, r_disc=r_disc,
                           steplim=steplim)
    out = res["out"]
    mask = jnp.asarray(res["return_mask"])
    _, _, dr = bin_edges(r_min, r_disc, n_r, logbin)
    counts, sums = radial_bin_profile(
        out.r, mask,
        {"flux": 1.0 / out.redshift, "redshift": out.redshift, "time": out.t},
        r_min, dr, n_r, logbin,
    )
    radii, widths, _ = bin_edges(r_min, r_disc, n_r, logbin)
    counts = np.asarray(counts)
    with np.errstate(divide="ignore", invalid="ignore"):
        with TextOutput(outfile) as f:
            f.write_columns(
                np.asarray(radii), counts,
                np.asarray(sums["flux"]) / res["n_live"],
                np.asarray(sums["redshift"]) / counts,
                np.asarray(sums["time"]) / counts,
            )
    print(f"wrote {outfile}: {res['n_return']}/{res['n_live']} rays returned")
    return 0


def main_return_angdist(argv=None):
    """Angular distribution of launch directions that return
    (disc_source_return_angdist.cpp)."""
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    spin = cfg.get("spin", float)
    r_launch = cfg.get("r_source", float, 6.0)
    grid = PointSourceGrid.from_steps(
        cfg.get("dcosalpha", float, 0.02),
        cfg.get("dbeta", float, 0.02),
    )
    steplim = cfg.get("steplim", int, 20000)
    res = photon_fractions(r_launch, spin, grid, steplim=steplim)
    out = res["out"]
    ret = res["return_mask"]
    live = res["live"]
    # histogram over launch cos(alpha) (stored in .alpha)
    cosa = np.asarray(out.alpha)
    edges = np.linspace(-1, 1, cfg.get("Nang", int, 40) + 1)
    total, _ = np.histogram(cosa[live], bins=edges)
    returned, _ = np.histogram(cosa[ret], bins=edges)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = returned / total
    with TextOutput(outfile) as f:
        f.write_columns(0.5 * (edges[:-1] + edges[1:]), total, returned,
                        np.nan_to_num(frac))
    print(f"wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main_photonfrac())
