"""Relativistic line profile from a traced disc image.

Capability of the reference's ``python/line_from_image.ipynb`` analysis:
fold a redshifted disc image into the observed profile of an intrinsically
narrow emission line — the classic broad, skewed iron-K line shape. Each
pixel contributes its flux at observed energy E = E_rest / (1/g); summing
over pixels in energy bins gives the profile.

Provided both as a post-processing function over a disc-image FITS file
and as a direct pipeline (trace + fold) CLI, with the disc image produced
by apps.imageplane_disc_image.
"""

from __future__ import annotations

import sys

import numpy as np

from raytrace_tpu.config import Config, enable_compilation_cache
from raytrace_tpu.io import TextOutput, read_fits


def line_profile_from_maps(flux, enshift, counts, e_rest=6.4, n_en=200,
                           e0=None, e1=None):
    """Fold per-pixel (flux, 1/g) maps into an observed line profile.

    flux is the count-normalised per-pixel flux map (already epsilon/g^3);
    enshift is the mean 1/g per pixel. Pixel luminosity = flux * counts
    (undo the count normalisation so each ray contributes once).
    """
    good = (counts > 0) & np.isfinite(flux) & np.isfinite(enshift) & (enshift > 0)
    # the image's ENSHIFT map stores 1/redshift = E_obs/E_emit = g_obs
    e_obs = e_rest * enshift[good]
    w = (flux * counts)[good]
    if e0 is None:
        e0 = 0.3 * e_rest
    if e1 is None:
        e1 = 1.3 * e_rest
    edges = np.linspace(e0, e1, n_en + 1)
    prof, _ = np.histogram(e_obs, bins=edges, weights=w)
    centres = 0.5 * (edges[:-1] + edges[1:])
    return centres, prof


def main(argv=None):
    """rt-line-profile: either --image=<disc_image.fits> (post-process) or a
    full trace using the disc-image parameters."""
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    e_rest = cfg.get("line_en", float, 6.4)
    n_en = cfg.get("Nen", int, 200)

    if cfg.key_exists("image"):
        maps = read_fits(cfg.get("image", str))
        flux = maps["FLUX"].astype(float)
        enshift = maps["ENSHIFT"].astype(float)
        counts = maps["NRAYS"].astype(float)
    else:
        from raytrace_tpu.apps.imageplane_disc_image import compute
        from raytrace_tpu.sources import ImagePlaneGrid

        dist = cfg.get("dist", float)
        incl = cfg.get("incl", float)
        spin = cfg.get("spin", float)
        r_disc = cfg.get("r_disc", float)
        x0 = cfg.get("x0", float, -r_disc)
        xmax = cfg.get("xmax", float, r_disc)
        nx = cfg.get("Nx", int)
        dx = (xmax - x0) / nx
        grid = ImagePlaneGrid.from_steps(x0, xmax, dx, x0, xmax, dx)
        out = compute(
            spin, dist, incl, grid, r_disc,
            q1=cfg.get("q1", float, 3.0), rb1=cfg.get("rb1", float, 4.0),
            q2=cfg.get("q2", float, 3.0), rb2=cfg.get("rb2", float, 10.0),
            q3=cfg.get("q3", float, 3.0),
            method=cfg.get("integrator", str, "rk45").lower(),
            steplim=cfg.get("steplim", int, 20000),
        )
        flux, enshift, counts = out["flux"], out["enshift"], out["counts"]

    centres, prof = line_profile_from_maps(
        np.nan_to_num(flux), np.nan_to_num(enshift), counts, e_rest, n_en
    )
    with TextOutput(outfile) as f:
        f.write_columns(centres, prof)
    print(f"wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
