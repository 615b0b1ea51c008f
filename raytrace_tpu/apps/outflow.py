"""Outflow / wind line-profile applications.

Capability of the reference outflow family (src/outflow/, bitrotted):
  * ``outflow`` — backward image-plane rays traced through an emitting
    wind volume; per-ray (= per impact parameter) emission and absorption
    spectra written as text (outflow.cpp).
  * ``outflow_ent`` — adds the summed (energy, time) response for
    reverberation of the wind features.
  * ``outflow_spectrum`` — folds the per-ray emission through an input
    line spectrum read from text/QDP (outflow_spectrum.cpp + spectrum.h).
  * ``pointsource_mapper`` — lamppost illumination of the 3-D (r, theta,
    phi) volume via the Mapper: per-cell mean arrival time, redshift and
    ray counts with proper cell volumes (pointsource_mapper.cpp; the only
    HDF5 app in the reference — we write NPZ plus a FITS cube).
  * ``outflow_emis_bin`` — wind emissivity binned through the
    image-plane Mapper (outflow_emis_bin.cpp).
"""

from __future__ import annotations

import sys

import numpy as np

import jax.numpy as jnp

from raytrace_tpu.config import Config, enable_compilation_cache
from raytrace_tpu.io import FITSOutput, TextOutput
from raytrace_tpu.io.spectrum import read_spectrum
from raytrace_tpu.ops.mapper import MapperGrid, average_maps, cell_volumes, map_rays
from raytrace_tpu.ops.redshift import redshift_start
from raytrace_tpu.ops.source_tracer import (
    EnergyTimeBins,
    SphericalStop,
    WindModel,
    run_source_trace,
)
from raytrace_tpu.sources import (
    ImagePlaneGrid,
    PointSourceGrid,
    image_plane,
    point_source,
)


def _wind_setup(cfg):
    wind = WindModel(
        v0=cfg.get("source_vel", float, 0.1),
        r_in=cfg.get("wind_rin", float, 10.0),
        r_out=cfg.get("wind_rout", float, 50.0),
        theta_min=cfg.get("wind_thetamin", float, 0.5),
        theta_max=cfg.get("wind_thetamax", float, np.pi / 2),
    )
    bins = EnergyTimeBins(
        en0=cfg.get("en0", float, 0.1),
        en_max=cfg.get("enmax", float, 10.0),
        n_en=cfg.get("Nen", int, 200),
        logbin_en=cfg.get("logbin_en", bool, True),
        t0=cfg.get("t0", float, 0.0),
        dt=cfg.get("dt", float, 100.0),
        n_t=cfg.get("Nt", int, 1),
    )
    return wind, bins


def _image_plane_rays(cfg):
    dist = cfg.get("dist", float)
    incl = cfg.get("incl", float)
    spin = cfg.get("spin", float)
    x0 = cfg.get("x0", float)
    xmax = cfg.get("xmax", float)
    nx = cfg.get("Nx", int)
    y0 = cfg.get("y0", float, x0)
    ymax = cfg.get("ymax", float, xmax)
    ny = cfg.get("Ny", int, nx)
    dx = (xmax - x0) / max(nx - 1, 1)
    dy = (ymax - y0) / max(ny - 1, 1)
    grid = ImagePlaneGrid(nx=nx, ny=ny, x0=x0, y0=y0, dx=dx, dy=dy)
    rays = image_plane(dist, incl, grid, spin)
    rays = redshift_start(rays, -spin, V=0.0, reverse=True)
    return rays, grid, spin, dist


def _run_outflow(cfg):
    rays, grid, spin, dist = _image_plane_rays(cfg)
    wind, bins = _wind_setup(cfg)
    stop = SphericalStop(cfg.get("source_radius", float, 0.0))
    steplim = cfg.get("steplim", int, 100_000)
    final, emis, absorb, resp = run_source_trace(
        rays, -spin, wind, bins, stop=stop, r_lim=1.5 * dist, steplim=steplim
    )
    return grid, bins, np.asarray(emis), np.asarray(absorb), np.asarray(resp)


def main(argv=None):
    """Per-ray emission/absorption spectra (outflow.cpp)."""
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    grid, bins, emis, absorb, _ = _run_outflow(cfg)
    energies = bins.energies()
    with TextOutput(outfile) as f:
        for ray in range(emis.shape[0]):
            if emis[ray].sum() == 0:
                continue
            for ien in range(bins.n_en):
                f.row(ray, energies[ien], emis[ray, ien], absorb[ray, ien])
            f.newline(2)
    print(f"wrote {outfile}")
    return 0


def main_ent(argv=None):
    """Summed spectrum plus the (energy, time) response (outflow_ent.cpp)."""
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    grid, bins, emis, absorb, resp = _run_outflow(cfg)
    energies = bins.energies()
    spec = emis.sum(axis=0)
    with TextOutput(outfile) as f:
        f.write_columns(energies, spec)
    np.savez(outfile + ".ent.npz", energies=energies, response=resp)
    print(f"wrote {outfile} (+.ent.npz response {resp.shape})")
    return 0


def main_spectrum(argv=None):
    """Wind profile folded through an input line spectrum
    (outflow_spectrum.cpp)."""
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    specfile = cfg.get("spectrum", str)
    line_en, line_counts = read_spectrum(specfile)
    grid, bins, emis, absorb, _ = _run_outflow(cfg)
    energies = bins.energies()
    profile = emis.sum(axis=0)
    # fold: spectrum(E) = sum_l counts_l * profile(E / E_l), with the wind
    # profile computed around unit rest energy
    folded = np.zeros_like(energies)
    for e_l, c_l in zip(line_en, line_counts):
        shifted = np.interp(energies / e_l, energies, profile, left=0, right=0)
        folded += c_l * shifted
    with TextOutput(outfile) as f:
        f.write_columns(energies, folded)
    print(f"wrote {outfile}")
    return 0


def main_pointsource_mapper(argv=None):
    """Lamppost -> 3-D illumination map (pointsource_mapper.cpp)."""
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    source = cfg.get_array("source", float, 4)
    V = cfg.get("V", float, 0.0)
    spin = cfg.get("spin", float)
    grid = PointSourceGrid.from_steps(
        cfg.get("dcosalpha", float),
        cfg.get("dbeta", float),
        cfg.get("cosalpha0", float, -0.995),
        cfg.get("cosalphamax", float, 0.995),
        cfg.get("beta0", float, -np.pi),
        cfg.get("betamax", float, np.pi),
    )
    mgrid = MapperGrid(
        r0=cfg.get("map_r0", float, 1.5),
        r_max=cfg.get("map_rmax", float, 100.0),
        n_r=cfg.get("map_Nr", int, 50),
        n_theta=cfg.get("map_Ntheta", int, 25),
        n_phi=cfg.get("map_Nphi", int, 50),
        logbin_r=cfg.get("map_logbin_r", bool, True),
        theta_max=cfg.get("map_thetamax", float, np.pi),
    )
    steplim = cfg.get("steplim", int, 100_000)

    rays = point_source(tuple(source), V, spin, grid)
    rays = redshift_start(rays, spin, V)
    print(f"pointsource_mapper: {grid.n_rays} rays -> "
          f"{mgrid.n_r}x{mgrid.n_theta}x{mgrid.n_phi} cells")
    final, maps = map_rays(
        rays, spin, mgrid,
        r_lim=cfg.get("r_max", float, mgrid.r_max),
        theta_lim=cfg.get("theta_max", float, np.pi / 2),
        steplim=steplim,
    )
    avg = average_maps(maps)
    vol = np.asarray(cell_volumes(mgrid, spin))

    np.savez(
        outfile + ".npz",
        time=avg["time"], redshift=avg["redshift"], count=avg["count"],
        volume=vol, r0=mgrid.r0, r_max=mgrid.r_max, logbin_r=mgrid.logbin_r,
        n_rays=grid.n_rays,
    )
    fits = FITSOutput(outfile)
    fits.set_keyword("GENERATOR", "pointsource_mapper")
    fits.set_keyword("SPIN", spin)
    fits.set_keyword("NRAYS", grid.n_rays)
    for name, data in [("TIME", avg["time"]), ("REDSHIFT", avg["redshift"]),
                       ("NRAYS", avg["count"]), ("VOLUME", vol)]:
        fits.write_image(np.nan_to_num(data, nan=0.0), extname=name, transpose=False)
    fits.close()
    extra = ""
    try:
        from raytrace_tpu.ops.mapper import save_hdf

        save_hdf(outfile + ".h5", mgrid, avg, vol, n_rays=grid.n_rays)
        extra = f", {outfile}.h5"
    except ImportError:  # h5py-less installs keep NPZ + FITS
        pass
    except OSError as exc:  # the NPZ + FITS products above already landed
        print(f"HDF5 export failed ({exc}); NPZ/FITS outputs are complete")
    print(f"wrote {outfile} and {outfile}.npz{extra}")
    return 0


def main_emis_bin(argv=None):
    """Wind emissivity binned through the image-plane Mapper
    (outflow_emis_bin.cpp)."""
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str)
    rays, grid, spin, dist = _image_plane_rays(cfg)
    mgrid = MapperGrid(
        r0=cfg.get("map_r0", float, 1.5),
        r_max=cfg.get("map_rmax", float, 100.0),
        n_r=cfg.get("map_Nr", int, 50),
        n_theta=cfg.get("map_Ntheta", int, 25),
        n_phi=cfg.get("map_Nphi", int, 50),
        logbin_r=cfg.get("map_logbin_r", bool, True),
        theta_max=cfg.get("map_thetamax", float, np.pi),
    )
    final, maps = map_rays(
        rays, -spin, mgrid, r_lim=1.5 * dist, theta_lim=0.0,
        motion=1, vel=cfg.get("source_vel", float, 0.1),
        vel_mode=cfg.get("vel_mode", int, 0), reverse=True,
        steplim=cfg.get("steplim", int, 100_000),
    )
    avg = average_maps(maps)
    vol = np.asarray(cell_volumes(mgrid, spin))
    with np.errstate(divide="ignore", invalid="ignore"):
        emissivity = avg["count"] / (grid.n_rays * vol) * np.nan_to_num(avg["redshift"]) ** -2
    np.savez(outfile + ".npz", emissivity=emissivity, **avg, volume=vol)
    print(f"wrote {outfile}.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
