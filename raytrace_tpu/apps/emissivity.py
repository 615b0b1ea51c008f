"""Lamppost -> disc emissivity profile (the reference's flagship app).

Capability of ``src/emissivity/emissivity.cpp``: trace an isotropic grid of
rays from a point source above the hole, keep those striking the equatorial
disc outside the ISCO, and accumulate per-radial-bin ray counts, photon
flux, emissivity (for a power-law source spectrum of index gamma the
received emissivity scales as the redshift to the power -gamma), mean
redshift and mean arrival time, each normalised by the proper annulus area.

Output: 7 text columns (r, area, N_rays, flux, emis, <g>, <t>) compatible
with the reference's plotting layer (emissivity.cpp:136-148).
"""

from __future__ import annotations

import sys

import numpy as np

import jax
import jax.numpy as jnp

from raytrace_tpu.config import Config, enable_compilation_cache
from raytrace_tpu.geometry import integrate_disc_area_bins, isco_radius
from raytrace_tpu.geometry.kerr import bl_to_cartesian
from raytrace_tpu.io import TextOutput
from raytrace_tpu.ops import StepControl, trace_auto
from raytrace_tpu.ops.reductions import bin_edges, radial_bin_profile
from raytrace_tpu.ops.redshift import apply_redshift, range_phi, redshift_start
from raytrace_tpu.sources import PointSourceGrid, point_source


def disc_hit_mask(out, spin, r_isco=None):
    """Disc-hit selection of the plain emissivity app (emissivity.cpp:99-107):
    completed ray, close to the equatorial plane in height z, physical
    redshift, outside the ISCO.

    One definition shared by ``compute`` and the multi-chip
    ``parallel.sharded_emissivity_bins`` / differentiable
    ``ops.diff.emissivity_binned_profile`` paths — a change to the gating
    here changes all of them together.
    """
    if r_isco is None:
        r_isco = isco_radius(spin)
    _, _, z = bl_to_cartesian(out.r, out.theta, out.phi, spin)
    return out.ok & (z < 1e-2) & (out.redshift > 0) & (out.r >= r_isco)


def emissivity_bin_weights(out, gamma, n_primary=1.0):
    """Per-ray weights accumulated into the radial bins
    (emissivity.cpp:108-121): photon flux 1/(N·g), emissivity 1/g^gamma for
    a power-law source spectrum, redshift and arrival time for the per-bin
    means. Shared with the sharded and differentiable pipelines."""
    g = out.redshift
    return {
        "flux": 1.0 / (n_primary * g),
        "emis": 1.0 / g**gamma,
        "redshift": g,
        "time": out.t,
    }


def compute(
    spin,
    source,
    V=0.0,
    grid: PointSourceGrid | None = None,
    r_max=1000.0,
    r_min=None,
    r_disc=500.0,
    n_r=100,
    logbin_r=True,
    gamma=2.0,
    method="rk45",
    steplim=None,
    ctrl=StepControl(),
    trace_fn=trace_auto,
    variant="plain",  # "plain" (emissivity.cpp) | "rd" (emissivity_rd.cpp)
    theta_lim=jnp.pi / 2,
    mesh=None,
):
    """Run the emissivity pipeline; returns a dict of per-bin columns.

    With a ``mesh`` (plain variant) the whole step runs data-parallel over
    the mesh's ``rays`` axis through parallel.sharded_emissivity_bins —
    per-shard march + redshift + local binning, one psum merging the
    histograms.
    """
    r_isco = isco_radius(spin)
    if r_min is None or r_min < 0:
        r_min = float(r_isco)

    disc_r, disc_width, dr = bin_edges(r_min, r_disc, n_r, logbin_r)
    # per-bin proper area in the disc material rest frame (emissivity.cpp:79);
    # one vectorised jit call over all bins
    areas = jax.jit(integrate_disc_area_bins)(disc_r, disc_r + disc_width, spin)

    # grid-cell count for the primary-flux normalisation (emissivity.cpp:61):
    # the reference counts cells without the +1 fencepost
    n_primary = ((grid.cosalphamax - grid.cosalpha0) / grid.dcosalpha) * (
        (grid.betamax - grid.beta0) / grid.dbeta
    )

    rays = point_source(source, V, spin, grid)
    if mesh is not None and variant == "plain":
        from raytrace_tpu.parallel import (
            pad_rays,
            shard_rays,
            sharded_emissivity_bins,
        )

        sharded = shard_rays(pad_rays(rays, mesh.devices.size), mesh)
        counts, sums = sharded_emissivity_bins(
            sharded, spin, mesh, V=V, r_min=float(r_min), dr=float(dr),
            n_r=n_r, logbin_r=logbin_r, gamma=gamma, n_primary=n_primary,
            method=method, r_max=r_max, steplim=steplim, ctrl=ctrl,
        )
        counts_np = np.asarray(counts)
        with np.errstate(divide="ignore", invalid="ignore"):
            return {
                "r": np.asarray(disc_r),
                "area": np.asarray(areas),
                "rays": counts_np.astype(np.int64),
                "flux": np.asarray(sums["flux"]) / np.asarray(areas),
                "emis": np.asarray(sums["emis"]) / np.asarray(areas),
                "redshift": np.asarray(sums["redshift"]) / counts_np,
                "time": np.asarray(sums["time"]) / counts_np,
            }

    rays = redshift_start(rays, spin, V)
    if variant == "rd":
        # destination-API route (emissivity_rd.cpp:99-116): FlatDisc surface
        # + RK4 + 4-velocity redshift, hit test on the landing polar angle
        from raytrace_tpu.destinations import FlatDisc
        from raytrace_tpu.ops.redshift import apply_redshift_dest

        dest = FlatDisc(theta_lim)
        rays = trace_fn(rays, spin, method=method, dest=dest, r_max=r_max,
                        steplim=steplim, ctrl=ctrl)
        rays = range_phi(rays)
        rays = apply_redshift_dest(rays, spin, dest)
        g = rays.redshift
        mask = (
            rays.ok
            & (rays.theta >= theta_lim - 1e-3)
            & (g > 0)
            & (rays.r >= r_isco)
        )
    else:
        rays = trace_fn(rays, spin, method=method, r_max=r_max, steplim=steplim, ctrl=ctrl)
        rays = range_phi(rays)
        rays = apply_redshift(rays, spin, V=-1.0)
        mask = disc_hit_mask(rays, spin, r_isco)

    counts, sums = radial_bin_profile(
        rays.r,
        mask,
        emissivity_bin_weights(rays, gamma, n_primary),
        r_min,
        dr,
        n_r,
        logbin_r,
    )

    counts_np = np.asarray(counts)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = {
            "r": np.asarray(disc_r),
            "area": np.asarray(areas),
            "rays": counts_np.astype(np.int64),
            "flux": np.asarray(sums["flux"]) / np.asarray(areas),
            "emis": np.asarray(sums["emis"]) / np.asarray(areas),
            "redshift": np.asarray(sums["redshift"]) / counts_np,
            "time": np.asarray(sums["time"]) / counts_np,
        }
    return out


def _main(variant):
    def main(argv=None):
        return _run_main(argv, variant)

    return main


def _run_main(argv, variant):
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    source = cfg.get_array("source", float, 4)
    if cfg.args.key_exists("source_h"):
        source[1] = cfg.args.get("source_h", float)
    spin = cfg.get("spin", float)
    V = cfg.get("V", float, 0.0)
    grid = PointSourceGrid.from_steps(
        cfg.get("dcosalpha", float),
        cfg.get("dbeta", float),
        cfg.get("cosalpha0", float, -0.995),
        cfg.get("cosalphamax", float, 0.995),
        cfg.get("beta0", float, -np.pi),
        cfg.get("betamax", float, np.pi),
    )
    # the reference reads both limits from the key "r_esc"
    # (emissivity.cpp:46,51 — documented quirk, SURVEY.md §7)
    r_max = cfg.get("r_esc", float, 1000.0)
    r_disc = cfg.get("r_esc", float, 500.0)
    r_min = cfg.get("rmin", float, -1.0)
    n_r = cfg.get("Nr", int, 100)
    logbin_r = cfg.get("logbin_r", bool, True)
    gamma = cfg.get("gamma", float, 2.0)
    method = cfg.get("integrator", str, "rk4" if variant == "rd" else "rk45").lower()
    steplim = cfg.get("steplim", int, -1)
    theta_lim = cfg.get("theta_lim", float, np.pi / 2)
    # reference par key (emissivity.par_example): per-phase progress
    if cfg.get("show_progress", bool, False):
        import os

        os.environ.setdefault("RT_PROGRESS", "1")

    print(f"emissivity[{variant}]: spin={spin} source={source} {grid.n_rays} rays")
    from raytrace_tpu.parallel import auto_mesh
    from raytrace_tpu.utils.progress import app_phase

    mesh = auto_mesh() if variant == "plain" else None
    if mesh is not None:
        print(f"sharding {grid.n_rays} rays over {mesh.devices.size} devices")
    with app_phase(f"emissivity {variant} march+bin"):
        out = compute(
            spin,
            source,
            V,
            grid,
            r_max=r_max,
            r_min=None if r_min < 0 else r_min,
            r_disc=r_disc,
            n_r=n_r,
            logbin_r=logbin_r,
            gamma=gamma,
            method=method,
            steplim=None if steplim <= 0 else steplim,
            variant=variant,
            theta_lim=theta_lim,
            mesh=mesh,
        )

    with TextOutput(outfile) as f:
        f.write_columns(
            out["r"], out["area"], out["rays"], out["flux"], out["emis"],
            out["redshift"], out["time"],
        )
    print(f"wrote {outfile}")
    return 0


main = _main("plain")
main_rd = _main("rd")

if __name__ == "__main__":
    sys.exit(main())
