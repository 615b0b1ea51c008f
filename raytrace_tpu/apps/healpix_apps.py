"""HEALPix-source applications: solid-angle-correct illumination.

Capability of the reference src/healpix/ family (bitrotted):
  * ``healpix_to_disc`` — HEALPix-uniform emission from a lamppost,
    binned onto the disc with exactly equal per-pixel solid angle
    weighting (healpix_to_disc.cpp).
  * ``healpix_disc_source_photonfrac`` — returning-radiation fractions
    from a disc-surface source emitting uniformly over its upward
    hemisphere (healpix_disc_source_photonfrac.cpp).
"""

from __future__ import annotations

import sys

import numpy as np

import jax.numpy as jnp

from raytrace_tpu.config import Config, enable_compilation_cache
from raytrace_tpu.geometry import isco_radius, keplerian_omega
from raytrace_tpu.io import TextOutput
from raytrace_tpu.ops import trace_auto
from raytrace_tpu.ops.reductions import bin_edges, radial_bin_profile
from raytrace_tpu.ops.redshift import apply_redshift, range_phi, redshift_start
from raytrace_tpu.rays import RAY_STATUS_DEST, RAY_STATUS_HORIZON, RAY_STATUS_RLIM
from raytrace_tpu.sources import healpix_point_source


def _trace(cfg, rays, spin):
    r_max = cfg.get("r_esc", float, 500.0)
    steplim = cfg.get("steplim", int, 20000)
    rays = redshift_start(rays, spin, V=cfg.get("V", float, 0.0))
    out = trace_auto(rays, spin, method=cfg.get("integrator", str, "rk45").lower(),
                          r_max=r_max, steplim=steplim)
    out = range_phi(out)
    return apply_redshift(out, spin, V=-1.0)


def main_to_disc(argv=None):
    """HEALPix lamppost -> per-annulus illumination with equal solid-angle
    pixel weights (centre rays; the corner rays carry the bundle
    distortion diagnostics)."""
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    spin = cfg.get("spin", float)
    order = cfg.get("order", int, 4)
    source = cfg.get_array("source", float, 4)
    rays, npix = healpix_point_source(tuple(source), spin, order=order,
                                      V=cfg.get("V", float, 0.0))
    print(f"healpix_to_disc: {npix} pixels x 5 rays, order {order}")
    out = _trace(cfg, rays, spin)

    # centre rays are slot 0
    centre = jnp.arange(npix)
    sub = __import__("jax").tree.map(lambda a: a[centre], out)
    r_isco = isco_radius(spin)
    g = sub.redshift
    mask = sub.ok & ((sub.status & RAY_STATUS_DEST) != 0) & (g > 0) & (sub.r >= r_isco)

    r_min = cfg.get("rmin", float, float(r_isco))
    r_disc = cfg.get("r_disc", float, 100.0)
    n_r = cfg.get("Nr", int, 50)
    radii, _, dr = bin_edges(r_min, r_disc, n_r, True)
    # each pixel carries exactly 4*pi/npix steradians
    w = 4.0 * np.pi / npix
    counts, sums = radial_bin_profile(
        sub.r, mask,
        {"flux": w / g, "emis": w / g**2, "redshift": g},
        r_min, dr, n_r, True,
    )
    counts = np.asarray(counts)
    with np.errstate(divide="ignore", invalid="ignore"):
        with TextOutput(outfile) as f:
            f.write_columns(
                np.asarray(radii), counts, np.asarray(sums["flux"]),
                np.asarray(sums["emis"]),
                np.asarray(sums["redshift"]) / counts,
            )
    print(f"wrote {outfile}: {int(counts.sum())} disc hits")
    return 0


def main_disc_photonfrac(argv=None):
    """Disc-surface HEALPix source -> return/escape/capture fractions with
    exact solid-angle weighting."""
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str, "")
    spin = cfg.get("spin", float)
    order = cfg.get("order", int, 4)
    r_src = cfg.get("r_source", float, 6.0)
    V = float(keplerian_omega(r_src, spin))
    rays, npix = healpix_point_source(
        (0.0, r_src, np.pi / 2 - 1e-3, 0.0), spin, order=order, V=V,
        disc_source=True,
    )
    out = _trace(cfg, rays, spin)
    centre = jnp.arange(npix)
    sub = __import__("jax").tree.map(lambda a: a[centre], out)
    live = np.asarray(sub.steps) > 0
    st = np.asarray(sub.status)
    r_isco = float(isco_radius(spin))
    ret = live & ((st & RAY_STATUS_DEST) != 0) & (np.asarray(sub.r) >= r_isco)
    esc = live & ((st & RAY_STATUS_RLIM) != 0)
    cap = live & (((st & RAY_STATUS_HORIZON) != 0)
                  | (((st & RAY_STATUS_DEST) != 0) & (np.asarray(sub.r) < r_isco)))
    n = max(live.sum(), 1)
    print(f"r={r_src}: return {ret.sum()/n:.4f} escape {esc.sum()/n:.4f} "
          f"capture {cap.sum()/n:.4f} ({n} hemisphere pixels)")
    if outfile:
        with TextOutput(outfile) as f:
            f.row(r_src, ret.sum() / n, esc.sum() / n, cap.sum() / n, int(n))
        print(f"wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main_to_disc())
