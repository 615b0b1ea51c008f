"""Redshifted accretion-disc images from a backward-traced observer plane.

Capability of the reference image apps:
  * ``imageplane_disc_image`` (src/imageplane/imageplane_disc_image.cpp) —
    plain theta-limit disc, per-pixel maps of flux epsilon(r)/g^3 with a
    3-segment broken power-law emissivity, radius, phi, energy shift 1/g,
    arrival time and emissivity, count-normalised, written as a
    multi-extension FITS file.
  * ``imageplane_disc_image_rd`` (…_rd.cpp) — same science through the
    destination API: FlatDisc surface at theta_lim + RK4 + 4-velocity
    redshift. (The reference calls redshift(dest) without the reverse flag
    — an inconsistency with every other backward-traced app; we pass
    reverse=True.)
  * ``imageplane_disc_image_isco`` (…_isco.cpp) — DiscWithISCO annulus
    destination: rays crossing the equator inside the ISCO correctly
    continue to the horizon instead of being counted (Euler rejected,
    …_isco.cpp:76-80).
"""

from __future__ import annotations

import sys

import numpy as np

import jax
import jax.numpy as jnp

from raytrace_tpu.config import Config, enable_compilation_cache
from raytrace_tpu.destinations import DiscWithISCO, FlatDisc, ThetaLimit
from raytrace_tpu.geometry import isco_radius
from raytrace_tpu.geometry.kerr import bl_to_cartesian
from raytrace_tpu.io import FITSOutput
from raytrace_tpu.ops import StepControl, trace_auto
from raytrace_tpu.ops.redshift import (
    apply_redshift,
    apply_redshift_dest,
    range_phi,
    redshift_start,
)
from raytrace_tpu.ops.reductions import pixel_accumulate
from raytrace_tpu.sources import ImagePlaneGrid, image_plane


def powerlaw3(r, q1, rb1, q2, rb2, q3):
    """3-segment broken power-law emissivity profile
    (imageplane_disc_image.cpp:20-28)."""
    inner = r ** (-q1)
    middle = rb1 ** (q2 - q1) * r ** (-q2)
    outer = rb1 ** (q2 - q1) * rb2 ** (q3 - q2) * r ** (-q3)
    return jnp.where(r < rb1, inner, jnp.where(r < rb2, middle, outer))


def accumulate_image_maps(
    out,
    spin,
    grid: ImagePlaneGrid,
    r_disc,
    img_nx,
    img_ny,
    *,
    variant="plain",
    dest=None,
    theta_lim=jnp.pi / 2,
    r_isco=None,
    q1=3.0,
    rb1=4.0,
    q2=3.0,
    rb2=10.0,
    q3=3.0,
    flip_image=True,
):
    """Post-march image accumulation: redshift -> hit mask -> per-pixel maps.

    Pure traced function of the marched batch, shared by the single-device
    ``compute`` and the multi-chip ``parallel.sharded_disc_image`` (one
    definition of the hit criterion and pixel binning for both paths —
    imageplane_disc_image.cpp:118-176). Returns (counts, images dict),
    un-normalised (callers divide by counts).
    """
    a_trace = -spin
    if r_isco is None:
        r_isco = isco_radius(spin)

    if variant == "rd":
        out = apply_redshift_dest(out, a_trace, dest, reverse=True)
    else:
        out = apply_redshift(out, a_trace, V=-1.0, reverse=True)
    out = range_phi(out)

    g = out.redshift
    if variant == "plain":
        _, _, z = bl_to_cartesian(out.r, out.theta, out.phi, spin)
        hit = out.ok & (z < 1e-2) & (out.r >= r_isco) & (out.r < r_disc) & (g > 0)
    elif variant == "rd":
        hit = (
            out.ok
            & (out.theta >= theta_lim - 1e-3)
            & (out.r >= r_isco)
            & (out.r < r_disc)
            & (g > 0)
        )
    else:  # isco: the destination already encodes the annulus
        from raytrace_tpu.rays import RAY_STATUS_DEST

        hit = out.ok & ((out.status & RAY_STATUS_DEST) != 0) & (g > 0)

    # pixel binning from the stored plane coordinates
    # (imageplane_disc_image.cpp:132-140): img_dx = (xmax - x0)/img_Nx, and
    # the grid spans x0 .. x0 + (nx-1)*dx = xmax
    img_dx = grid.dx * (grid.nx - 1) / img_nx
    img_dy = grid.dy * (grid.ny - 1) / img_ny
    ix = jnp.floor((out.alpha - grid.x0) / img_dx).astype(jnp.int32)
    iy = jnp.floor((out.beta - grid.y0) / img_dy).astype(jnp.int32)
    if flip_image:
        iy = img_ny - iy - 1

    emis = powerlaw3(out.r, q1, rb1, q2, rb2, q3)
    return pixel_accumulate(
        ix,
        iy,
        hit,
        {
            "flux": emis / g**3,
            "r": out.r,
            "phi": out.phi,
            "enshift": 1.0 / g,
            "time": out.t,
            "emis": emis,
        },
        img_nx,
        img_ny,
    )


def compute(
    spin,
    dist,
    incl_deg,
    grid: ImagePlaneGrid,
    r_disc,
    img_nx=None,
    img_ny=None,
    q1=3.0,
    rb1=4.0,
    q2=3.0,
    rb2=10.0,
    q3=3.0,
    phi0=0.0,
    variant="plain",  # "plain" | "rd" | "isco"
    theta_lim=jnp.pi / 2,
    method="rk45",
    flip_image=True,
    steplim=None,
    ctrl=StepControl(),
    trace_fn=trace_auto,
    dtype=jnp.float64,
    mesh=None,
):
    """Trace the camera grid and accumulate the per-pixel disc maps.

    Returns dict of (img_nx, img_ny) arrays: counts, flux, r, phi, enshift,
    time, emis — count-normalised like the reference
    (imageplane_disc_image.cpp:166-176).

    ``dtype`` is the working precision of the traced pipeline; pass
    jnp.float32 to run the explicit-f32 path the GPU kernel executes. With a
    ``mesh`` the whole step (march + redshift + per-shard pixel
    accumulation + psum map merge) runs data-parallel over the mesh's
    ``rays`` axis (parallel.sharded_disc_image) — the multi-chip twin of
    the reference's OpenMP ray loop over this app (raytracer.cpp:104).
    """
    img_nx = img_nx or grid.nx
    img_ny = img_ny or grid.ny
    a_trace = -spin  # propagation uses the negated spin (imageplane.cpp:12)
    r_isco = isco_radius(spin)

    if variant == "isco" and method == "euler":
        raise ValueError("Euler integrator not supported for the ISCO variant "
                         "(imageplane_disc_image_isco.cpp:76-80)")

    rays = image_plane(dist, incl_deg, grid, spin, phi0, dtype=dtype)

    if variant == "plain":
        dest = ThetaLimit(jnp.pi / 2)
    elif variant == "rd":
        dest = FlatDisc(theta_lim)
    elif variant == "isco":
        dest = DiscWithISCO(r_isco=r_isco, r_out=r_disc)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    # destination params share the working dtype (no silent f64 promotion)
    dest = jax.tree.map(lambda v: jnp.asarray(v, dtype), dest)

    kwargs = dict(
        variant=variant, dest=dest, theta_lim=theta_lim, r_isco=r_isco,
        q1=q1, rb1=rb1, q2=q2, rb2=rb2, q3=q3, flip_image=flip_image,
    )
    if mesh is not None:
        from raytrace_tpu.parallel import sharded_disc_image

        counts, images = sharded_disc_image(
            rays, spin, mesh, grid=grid, r_disc=r_disc,
            img_nx=img_nx, img_ny=img_ny, method=method,
            r_max=1.1 * dist, steplim=steplim, ctrl=ctrl, **kwargs,
        )
    else:
        rays = redshift_start(rays, a_trace, V=0.0, reverse=True)
        out = trace_fn(
            rays, a_trace, method=method, dest=dest, r_max=1.1 * dist,
            steplim=steplim, ctrl=ctrl,
        )
        counts, images = accumulate_image_maps(
            out, spin, grid, r_disc, img_nx, img_ny, **kwargs,
        )

    counts_np = np.asarray(counts)
    with np.errstate(divide="ignore", invalid="ignore"):
        result = {k: np.asarray(v) / counts_np for k, v in images.items()}
    result["counts"] = counts_np
    return result


def _main(variant):
    def main(argv=None):
        enable_compilation_cache()
        cfg = Config(argv)
        outfile = cfg.get("outfile", str)
        dist = cfg.get("dist", float)
        incl = cfg.get("incl", float)
        phi0 = cfg.get("plane_phi0", float, 0.0)
        spin = cfg.get("spin", float)
        r_disc = cfg.get("r_disc", float)
        x0 = cfg.get("x0", float, -r_disc)
        xmax = cfg.get("xmax", float, r_disc)
        nx = cfg.get("Nx", int)
        y0 = cfg.get("y0", float, x0)
        ymax = cfg.get("ymax", float, xmax)
        ny = cfg.get("Ny", int, nx)
        img_nx = cfg.get("img_Nx", int, nx)
        img_ny = cfg.get("img_Ny", int, img_nx)
        q1 = cfg.get("q1", float, 3.0)
        rb1 = cfg.get("rb1", float, 4.0)
        q2 = cfg.get("q2", float, 3.0)
        rb2 = cfg.get("rb2", float, 10.0)
        q3 = cfg.get("q3", float, 3.0)
        flip_image = cfg.get("flip_image", bool, True)
        method = cfg.get("integrator", str, "rk4" if variant == "rd" else "rk45").lower()
        rk45_tol = cfg.get("rk45_tol", float, 1e-8)
        theta_lim = cfg.get("theta_lim", float, np.pi / 2)
        steplim = cfg.get("steplim", int, -1)
        # reference par keys (imageplane_disc_image.par_example)
        precision = cfg.get("precision", float, 100.0)
        max_tstep = cfg.get("max_tstep", float, 1.0)
        if cfg.get("show_progress", bool, False):
            import os

            os.environ.setdefault("RT_PROGRESS", "1")

        # ray-grid spacing convention of the app (imageplane_disc_image.cpp:79):
        # dx = (xmax - x0)/Nx, and the plane then carries Nx+1 rays per axis
        dx = (xmax - x0) / nx
        dy = (ymax - y0) / ny
        grid = ImagePlaneGrid.from_steps(x0, xmax, dx, y0, ymax, dy)
        print(f"disc_image[{variant}]: spin={spin} incl={incl} "
              f"{grid.nx}x{grid.ny} rays -> {img_nx}x{img_ny} image")

        from raytrace_tpu.parallel import auto_mesh
        from raytrace_tpu.utils.progress import app_phase

        mesh = auto_mesh()
        if mesh is not None:
            print(f"sharding {grid.n_rays} rays over {mesh.devices.size} devices")
        with app_phase(f"disc_image {variant} march+accumulate"):
            out = compute(
                spin, dist, incl, grid, r_disc,
                img_nx=img_nx, img_ny=img_ny,
                q1=q1, rb1=rb1, q2=q2, rb2=rb2, q3=q3, phi0=phi0,
                variant=variant, theta_lim=theta_lim, method=method,
                flip_image=flip_image,
                steplim=None if steplim <= 0 else steplim,
                ctrl=StepControl(rk45_tol=rk45_tol, precision=precision,
                                 max_tstep=max_tstep),
                mesh=mesh,
            )

        n_disc = int(out["counts"].sum())
        print(f"{n_disc} rays hit the disc")

        fits = FITSOutput(outfile)
        fits.write_comment("Raytraced images of accretion disc")
        fits.set_keyword("GENERATOR", f"imageplane_disc_image_{variant}")
        fits.set_keyword("DIST", dist, "Distance to image plane")
        fits.set_keyword("INCL", incl, "Inclination of line of sight")
        fits.set_keyword("SPIN", spin, "Black hole spin")
        fits.set_keyword("ISCO", float(isco_radius(spin)), "Innermost stable circular orbit")
        fits.set_keyword("RDISC", r_disc, "Maximum radius of disc")
        for key, val in [("Q1", q1), ("RB1", rb1), ("Q2", q2), ("RB2", rb2), ("Q3", q3)]:
            fits.set_keyword(key, val, "Emissivity profile parameter")
        fits.set_keyword("NRAYS", grid.n_rays, "Number of rays")
        fits.set_keyword("DISCRAYS", n_disc, "Rays hitting disc")
        for name, key in [
            ("FLUX", "flux"), ("RADIUS", "r"), ("PHI", "phi"),
            ("ENSHIFT", "enshift"), ("TIME", "time"), ("EMIS", "emis"),
            ("NRAYS", "counts"),
        ]:
            img = np.nan_to_num(out[key], nan=0.0, posinf=0.0, neginf=0.0)
            fits.write_image(img, extname=name)
            fits.set_keyword("AXIS1", "Image plane X", "Quantity along X axis")
            fits.set_keyword("AXIS2", "Image plane Y", "Quantity along Y axis")
            fits.set_keyword("XMAX", xmax, "End of X axis")
            fits.set_keyword("YMAX", ymax, "End of Y axis")
        fits.close()
        print(f"wrote {outfile}")
        return 0

    return main


main = _main("plain")
main_rd = _main("rd")
main_isco = _main("isco")

if __name__ == "__main__":
    sys.exit(main())
