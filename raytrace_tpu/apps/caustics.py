"""Caustic / critical-curve maps of the Kerr lens mapping.

Capability of the reference caustic apps (src/caustic/):
  * ``caustic_discplane`` — lens map image plane -> equatorial disc annulus:
    per-pixel Jacobian det J = d(x_d, y_d)/d(x, y) by central differences
    over 5-ray bundles (or grid neighbours), image-order classification,
    SENTINEL marking where satellites cross geodesic branch boundaries, and
    an alternating-sign checkerboard suppression pass.
  * ``caustic_plane`` — same machinery onto a flat source plane z_s behind
    the hole (FlatPlane destination, East/North source coordinates).
  * ``caustic_sourceplane`` — Jacobian of (theta_s, phi_s) on a far source
    sphere at r_lim (thetalim disabled; grid-neighbour differences only).

All the post-processing (Jacobians, order gates, suppression) is pure array
arithmetic — data-parallel device work; the reference's per-pixel loops become shifted
slices.
"""

from __future__ import annotations

import sys

import numpy as np

import jax.numpy as jnp

from raytrace_tpu.config import Config, enable_compilation_cache
from raytrace_tpu.destinations import DiscWithISCO, FlatPlane, ThetaLimit
from raytrace_tpu.geometry import isco_radius
from raytrace_tpu.io import FITSOutput
from raytrace_tpu.ops import StepControl, trace_auto
from raytrace_tpu.ops.redshift import apply_redshift_dest, redshift_start
from raytrace_tpu.rays import (
    RAY_STATUS_DEST,
    RAY_STATUS_HORIZON,
    RAY_STATUS_RLIM,
    RAY_STATUS_STEPLIM,
)
from raytrace_tpu.sources import ImagePlaneGrid, image_plane, image_plane_bundles

SENTINEL = 1e30


def _order_map(phi_acc, rdot_flips, winding=2.0 * np.pi):
    """Image order: max of the phi-winding and radial-turning estimators
    (caustic_discplane.cpp:184-202)."""
    phi_ord = np.floor(np.abs(phi_acc) / winding).astype(np.int32)
    r_ord = (rdot_flips // 2).astype(np.int32)
    return np.maximum(phi_ord, r_ord)


def _order_map_sphere(phi_acc):
    """Source-sphere image order (caustic_sourceplane.cpp:205-215): a
    backward-traced direct-image ray naturally accumulates ~pi reaching the
    far side, so order = max(floor(|phi_acc|/pi) - 1, 0); no radial-turning
    estimator."""
    phi_ord = np.floor(np.abs(phi_acc) / np.pi).astype(np.int32)
    return np.maximum(phi_ord - 1, 0)


def _jacobian_bundle(coords, valid, phi_acc, rdot_flips, eps, hit_centre):
    """det J from E/W/N/S satellite target coordinates.

    coords: (xd, yd) each of shape (5, nx, ny) ordered
    [centre, east, west, north, south]; the order-match gate compares
    satellite rdot_flips and accumulated phi against the centre ray
    (caustic_discplane.cpp:296-317)."""
    xd, yd = coords
    c, e, w, n, s = range(5)
    order_match = (
        (rdot_flips[e] == rdot_flips[c])
        & (rdot_flips[w] == rdot_flips[c])
        & (rdot_flips[n] == rdot_flips[c])
        & (rdot_flips[s] == rdot_flips[c])
        & (np.abs(phi_acc[e] - phi_acc[c]) < np.pi / 2)
        & (np.abs(phi_acc[w] - phi_acc[c]) < np.pi / 2)
        & (np.abs(phi_acc[n] - phi_acc[c]) < np.pi / 2)
        & (np.abs(phi_acc[s] - phi_acc[c]) < np.pi / 2)
    )
    sats_ok = valid[e] & valid[w] & valid[n] & valid[s]

    dxd_da = (xd[e] - xd[w]) / (2 * eps)
    dxd_db = (xd[n] - xd[s]) / (2 * eps)
    dyd_da = (yd[e] - yd[w]) / (2 * eps)
    dyd_db = (yd[n] - yd[s]) / (2 * eps)
    det = dxd_da * dyd_db - dxd_db * dyd_da

    det_map = np.full(det.shape, np.nan)
    det_map = np.where(hit_centre & sats_ok & order_match, det, det_map)
    det_map = np.where(hit_centre & sats_ok & ~order_match, SENTINEL, det_map)
    sign_map = np.where(
        np.isfinite(det_map) & (det_map != SENTINEL), np.sign(det_map), 0.0
    )
    return det_map, sign_map


def _jacobian_grid(xd, yd, valid, phi_acc, rdot_flips, dx, dy):
    """Grid-neighbour central differences (fallback path,
    caustic_discplane.cpp:340-440): neighbours in the ray grid itself."""
    nx, ny = xd.shape

    def shift(a, di, dj, fill=np.nan):
        out = np.full_like(a, fill, dtype=a.dtype if a.dtype.kind == "f" else None)
        src = a[max(0, -di): nx - max(0, di), max(0, -dj): ny - max(0, dj)]
        out[max(0, di): nx - max(0, -di), max(0, dj): ny - max(0, -dj)] = src
        return out

    xe, xw = shift(xd, -1, 0), shift(xd, 1, 0)
    ye, yw = shift(yd, -1, 0), shift(yd, 1, 0)
    xn, xs = shift(xd, 0, -1), shift(xd, 0, 1)
    yn, ys = shift(yd, 0, -1), shift(yd, 0, 1)
    v = valid.astype(bool)
    ve, vw = shift(v, -1, 0, False), shift(v, 1, 0, False)
    vn, vs = shift(v, 0, -1, False), shift(v, 0, 1, False)
    fe, fw = shift(rdot_flips, -1, 0, -99), shift(rdot_flips, 1, 0, -99)
    fn, fs = shift(rdot_flips, 0, -1, -99), shift(rdot_flips, 0, 1, -99)
    pe, pw = shift(phi_acc, -1, 0), shift(phi_acc, 1, 0)
    pn, ps = shift(phi_acc, 0, -1), shift(phi_acc, 0, 1)

    order_match = (
        (fe == rdot_flips) & (fw == rdot_flips) & (fn == rdot_flips) & (fs == rdot_flips)
        & (np.abs(pe - phi_acc) < np.pi / 2) & (np.abs(pw - phi_acc) < np.pi / 2)
        & (np.abs(pn - phi_acc) < np.pi / 2) & (np.abs(ps - phi_acc) < np.pi / 2)
    )
    sats_ok = ve & vw & vn & vs

    det = ((xe - xw) / (2 * dx)) * ((yn - ys) / (2 * dy)) - (
        (xn - xs) / (2 * dy)
    ) * ((ye - yw) / (2 * dx))

    det_map = np.full(det.shape, np.nan)
    det_map = np.where(v & sats_ok & order_match, det, det_map)
    det_map = np.where(v & sats_ok & ~order_match, SENTINEL, det_map)
    sign_map = np.where(
        np.isfinite(det_map) & (det_map != SENTINEL), np.sign(det_map), 0.0
    )
    return det_map, sign_map


def _jacobian_grid_sphere(theta_s, phi_s, escaped, order, dx, dy):
    """Source-sphere Jacobian J = d(theta_s, phi_s)/d(x, y) by grid-neighbour
    central differences (caustic_sourceplane.cpp:244-305): defined only where
    the pixel and its four cardinal neighbours escaped AND share the same
    image order (SENTINEL at order boundaries = photon-ring critical curves);
    each phi difference is wrapped into [-pi, pi] to cross the branch cut."""
    nx, ny = theta_s.shape

    def shift(a, di, dj, fill=np.nan):
        out = np.full_like(a, fill, dtype=a.dtype if a.dtype.kind == "f" else None)
        src = a[max(0, -di): nx - max(0, di), max(0, -dj): ny - max(0, dj)]
        out[max(0, di): nx - max(0, -di), max(0, dj): ny - max(0, -dj)] = src
        return out

    wrap = lambda d: np.mod(d + np.pi, 2.0 * np.pi) - np.pi

    te, tw = shift(theta_s, -1, 0), shift(theta_s, 1, 0)
    tn, ts = shift(theta_s, 0, -1), shift(theta_s, 0, 1)
    pe, pw = shift(phi_s, -1, 0), shift(phi_s, 1, 0)
    pn, ps = shift(phi_s, 0, -1), shift(phi_s, 0, 1)
    v = escaped.astype(bool)
    ve, vw = shift(v, -1, 0, False), shift(v, 1, 0, False)
    vn, vs = shift(v, 0, -1, False), shift(v, 0, 1, False)
    oe, ow = shift(order, -1, 0, -99), shift(order, 1, 0, -99)
    on, os_ = shift(order, 0, -1, -99), shift(order, 0, 1, -99)

    sats_ok = ve & vw & vn & vs
    order_match = (oe == order) & (ow == order) & (on == order) & (os_ == order)

    dth_dx = (te - tw) / (2 * dx)
    dth_dy = (tn - ts) / (2 * dy)
    dph_dx = wrap(pe - pw) / (2 * dx)
    dph_dy = wrap(pn - ps) / (2 * dy)
    det = dth_dx * dph_dy - dth_dy * dph_dx

    det_map = np.full(det.shape, np.nan)
    det_map = np.where(v & sats_ok & order_match, det, det_map)
    det_map = np.where(v & sats_ok & ~order_match, SENTINEL, det_map)
    sign_map = np.where(
        np.isfinite(det_map) & (det_map != SENTINEL), np.sign(det_map), 0.0
    )
    return det_map, sign_map


def suppress_checkerboard(det_map, sign_map):
    """Suppress isolated alternating-sign pixels at geodesic branch
    boundaries (caustic_discplane.cpp:442-493): a pixel with more
    opposite-sign than same-sign 4-neighbours (and >= 2 of them) becomes
    SENTINEL."""
    s = sign_map
    nx, ny = s.shape
    padded = np.zeros((nx + 2, ny + 2))
    padded[1:-1, 1:-1] = s
    neigh = [padded[:-2, 1:-1], padded[2:, 1:-1], padded[1:-1, :-2], padded[1:-1, 2:]]
    n_same = sum(((nb * s) > 0) for nb in neigh)
    n_opp = sum(((nb * s) < 0) for nb in neigh)
    suppress = (s != 0) & (n_opp > n_same) & (n_opp >= 2)
    det_out = np.where(suppress, SENTINEL, det_map)
    sign_out = np.where(suppress, 0.0, sign_map)
    return det_out, sign_out, int(suppress.sum())


def compute(
    spin,
    dist,
    incl_deg,
    grid: ImagePlaneGrid,
    target="disc",  # "disc" | "plane" | "sphere"
    r_disc=None,
    z_s=None,
    r_lim=None,
    phi0=0.0,
    use_bundles=True,
    bundle_eps_frac=0.01,
    method="rk45",
    steplim=None,
    ctrl=StepControl(),
    trace_fn=trace_auto,
    dtype=jnp.float64,
    mesh=None,
):
    """Trace the camera (bundles or plain grid) and build the caustic maps.

    Returns a dict of (nx, ny) maps whose keys depend on the target, always
    including det_j, sign_j, order, plus diagnostics.

    ``dtype`` is the working precision of the whole traced pipeline
    (sources, destination parameters, march); pass jnp.float32 to run the
    explicit-f32 path the GPU kernel executes. With a ``mesh`` the bundle march
    runs data-parallel over the mesh's ``rays`` axis
    (parallel.sharded_caustic_trace); the Jacobian post-processing below
    stays host-side either way.
    """
    import jax

    a_trace = -spin
    incl = np.deg2rad(incl_deg)
    r_isco = isco_radius(spin)

    if target == "disc":
        dest = DiscWithISCO(r_isco=r_isco, r_out=r_disc)
        r_max = 1.1 * dist
        winding = 2 * np.pi
    elif target == "plane":
        dest = FlatPlane(incl=incl, phi0=phi0, z_s=z_s)
        r_max = r_lim if r_lim else 4.0 * z_s
        winding = 2 * np.pi
    elif target == "sphere":
        dest = ThetaLimit(0.0)  # never stop on theta; run to r_lim
        r_max = r_lim if r_lim else 1.5 * dist
        winding = np.pi
        use_bundles = False  # reference supports grid-neighbour only
    else:
        raise ValueError(f"unknown target {target!r}")

    # the destination's traced parameters must share the working dtype, or
    # the jitted march silently promotes every op back to f64
    dest = jax.tree.map(lambda v: jnp.asarray(v, dtype), dest)

    if use_bundles:
        rays, eps = image_plane_bundles(
            dist, incl_deg, grid, spin, phi0, eps_frac=bundle_eps_frac,
            dtype=dtype,
        )
    else:
        rays = image_plane(dist, incl_deg, grid, spin, phi0, dtype=dtype)
        eps = None

    rays = redshift_start(rays, a_trace, V=0.0, reverse=True)
    if mesh is not None:
        from raytrace_tpu.parallel import sharded_caustic_trace

        out = sharded_caustic_trace(rays, a_trace, mesh, dest=dest,
                                    r_max=r_max, method=method,
                                    steplim=steplim, ctrl=ctrl)
    else:
        out = trace_fn(rays, a_trace, method=method, dest=dest, r_max=r_max,
                       steplim=steplim, ctrl=ctrl)
    if target == "disc":
        out = apply_redshift_dest(out, a_trace, dest, reverse=True)

    n_pix = grid.n_rays
    n_slots = 5 if use_bundles else 1

    def gather(field, dtype=float):
        a = np.asarray(field)
        return a.reshape(n_slots, grid.nx, grid.ny)

    r = gather(out.r)
    theta = gather(out.theta)
    phi_acc = gather(out.phi)
    steps = gather(out.steps)
    status = gather(out.status).astype(np.int64)
    flips = gather(out.rdot_flips).astype(np.int64)
    eq_cross = gather(out.equatorial_crossings).astype(np.int64)
    g = gather(out.redshift)

    if target == "disc":
        valid = (steps > 0) & (r >= float(r_isco)) & (r < r_disc) & (g > 0)
        phi_s = np.arctan2(np.sin(phi_acc), np.cos(phi_acc))
        xd = r * np.cos(phi_s)
        yd = r * np.sin(phi_s)
    elif target == "plane":
        valid = (steps > 0) & ((status & RAY_STATUS_DEST) != 0)
        X = r * np.sin(theta) * np.cos(phi_acc)
        Y = r * np.sin(theta) * np.sin(phi_acc)
        Z = r * np.cos(theta)
        xd = -X * np.sin(phi0) + Y * np.cos(phi0)
        yd = (-X * np.cos(incl) * np.cos(phi0) - Y * np.cos(incl) * np.sin(phi0)
              + Z * np.sin(incl))
    else:  # sphere
        valid = (steps > 0) & ((status & RAY_STATUS_RLIM) != 0)
        xd = theta
        yd = np.arctan2(np.sin(phi_acc), np.cos(phi_acc))

    if target == "sphere":
        order = _order_map_sphere(phi_acc[0])
    else:
        order = _order_map(phi_acc[0], flips[0], winding)
    hit = valid[0]

    maps = {
        "hit": hit.astype(np.int32),
        "order": np.where(hit, order, -1).astype(np.int32),
        "rdot_flips": flips[0].astype(np.int32),
        "equat_cross": eq_cross[0].astype(np.int32),
    }
    if target == "disc":
        phi_s0 = np.arctan2(np.sin(phi_acc[0]), np.cos(phi_acc[0]))
        maps |= {
            "radius": np.where(hit, r[0], 0.0),
            "phi": np.where(hit, phi_s0, 0.0),
            "x_disc": np.where(hit, xd[0], 0.0),
            "y_disc": np.where(hit, yd[0], 0.0),
            "redshift": np.where(hit, g[0], 0.0),
        }
    elif target == "plane":
        maps |= {"x_s": np.where(hit, xd[0], 0.0), "y_s": np.where(hit, yd[0], 0.0)}
    else:
        maps |= {
            "theta_s": np.where(hit, xd[0], np.nan),
            "phi_s": np.where(hit, yd[0], np.nan),
            "escaped": hit.astype(np.int32),
        }

    if use_bundles:
        det_map, sign_map = _jacobian_bundle(
            (xd, yd), valid, phi_acc, flips, eps, hit
        )
    elif target == "sphere":
        det_map, sign_map = _jacobian_grid_sphere(
            np.where(hit, xd[0], np.nan), np.where(hit, yd[0], np.nan),
            hit, np.where(hit, order, -1), grid.dx, grid.dy,
        )
    else:
        det_map, sign_map = _jacobian_grid(
            np.where(valid[0], xd[0], np.nan),
            np.where(valid[0], yd[0], np.nan),
            valid[0], phi_acc[0], flips[0], grid.dx, grid.dy,
        )

    if target == "sphere":
        # the reference sourceplane app has no checkerboard-suppression pass
        n_sup = 0
    else:
        det_map, sign_map, n_sup = suppress_checkerboard(det_map, sign_map)
    maps["det_j"] = det_map
    maps["sign_j"] = sign_map
    maps["n_suppressed"] = n_sup

    # per-status failure diagnostics (caustic_discplane.cpp:255-276)
    st0 = status[0]
    maps["diag"] = {
        "horizon": int(((st0 & RAY_STATUS_HORIZON) != 0).sum()),
        "rlim": int(((st0 & RAY_STATUS_RLIM) != 0).sum()),
        "steplim": int(((st0 & RAY_STATUS_STEPLIM) != 0).sum()),
        "hits": int(hit.sum()),
    }
    return maps


_EXTENSIONS = {
    "disc": [
        ("DET_J", "det_j"), ("SIGN_J", "sign_j"), ("ORDER", "order"),
        ("HIT", "hit"), ("RADIUS", "radius"), ("PHI", "phi"),
        ("X_DISC", "x_disc"), ("Y_DISC", "y_disc"), ("REDSHIFT", "redshift"),
    ],
    "plane": [
        ("DET_J", "det_j"), ("SIGN_J", "sign_j"), ("ORDER", "order"),
        ("HIT_PLANE", "hit"), ("X_S", "x_s"), ("Y_S", "y_s"),
        ("RDOT_FLIPS", "rdot_flips"), ("EQUAT_CROSS", "equat_cross"),
    ],
    "sphere": [
        ("DET_J", "det_j"), ("SIGN_J", "sign_j"), ("ORDER", "order"),
        ("ESCAPED", "escaped"), ("THETA_S", "theta_s"), ("PHI_S", "phi_s"),
        ("RDOT_FLIPS", "rdot_flips"), ("EQUAT_CROSS", "equat_cross"),
    ],
}


def _main(target):
    def main(argv=None):
        enable_compilation_cache()
        cfg = Config(argv)
        outfile = cfg.get("outfile", str)
        dist = cfg.get("dist", float)
        incl = cfg.get("incl", float)
        phi0 = cfg.get("plane_phi0", float, 0.0)
        spin = cfg.get("spin", float)
        r_disc = cfg.get("r_disc", float, 30.0) if target == "disc" else None
        z_s = cfg.get("z_s", float, dist) if target == "plane" else None
        if target == "plane":
            r_lim = cfg.get("r_max", float, 4.0 * z_s)
        elif target == "sphere":
            r_lim = cfg.get("r_lim", float, 1.5 * dist)
        else:
            r_lim = None
        span = r_disc if r_disc else 30.0
        x0 = cfg.get("x0", float, -span)
        xmax = cfg.get("xmax", float, span)
        nx = cfg.get("Nx", int)
        y0 = cfg.get("y0", float, x0)
        ymax = cfg.get("ymax", float, xmax)
        ny = cfg.get("Ny", int, nx)
        use_bundles = cfg.get("use_bundles", bool, target != "sphere")
        eps_frac = cfg.get("bundle_eps_frac", float, 0.01)
        method = cfg.get("integrator", str, "rk45").lower()
        rk45_tol = cfg.get("rk45_tol", float, 1e-8)
        precision = cfg.get("precision", float, 100.0)
        steplim = cfg.get("steplim", int, -1)
        # reference par key (caustic_*.par_example): per-phase progress
        if cfg.get("show_progress", bool, False):
            import os

            os.environ.setdefault("RT_PROGRESS", "1")

        dx = (xmax - x0) / nx
        dy = (ymax - y0) / ny
        grid = ImagePlaneGrid.from_steps(x0, xmax, dx, y0, ymax, dy)
        print(f"caustic_{target}: spin={spin} incl={incl} {grid.nx}x{grid.ny} "
              f"pixels, bundles={use_bundles}")

        from raytrace_tpu.parallel import auto_mesh
        from raytrace_tpu.utils.progress import app_phase

        mesh = auto_mesh()
        if mesh is not None:
            print(f"sharding rays over {mesh.devices.size} devices")
        with app_phase(f"caustic {target} march+jacobians"):
            maps = compute(
                spin, dist, incl, grid, target=target,
                r_disc=r_disc, z_s=z_s, r_lim=r_lim, phi0=np.deg2rad(phi0),
                use_bundles=use_bundles, bundle_eps_frac=eps_frac,
                method=method, steplim=None if steplim <= 0 else steplim,
                ctrl=StepControl(rk45_tol=rk45_tol, precision=precision),
                mesh=mesh,
            )
        d = maps["diag"]
        print(f"{d['hits']} hits; horizon={d['horizon']} rlim={d['rlim']} "
              f"steplim={d['steplim']}; {maps['n_suppressed']} pixels suppressed")

        fits = FITSOutput(outfile)
        fits.write_comment(f"Kerr caustic / critical curve mapping ({target})")
        fits.set_keyword("GENERATOR", f"caustic_{target}")
        fits.set_keyword("DIST", dist)
        fits.set_keyword("INCL", incl)
        fits.set_keyword("SPIN", spin)
        if r_disc:
            fits.set_keyword("RDISC", r_disc)
        if z_s:
            fits.set_keyword("Z_S", z_s)
        if r_lim:
            fits.set_keyword("RLIM", r_lim)
        fits.set_keyword("SENTINEL", SENTINEL, "branch-boundary marker value")
        if target == "disc":
            from raytrace_tpu.geometry import isco_radius

            fits.set_keyword("ISCO", float(isco_radius(spin)))
        for extname, key in _EXTENSIONS[target]:
            fits.write_image(np.nan_to_num(np.asarray(maps[key], dtype=float),
                                           nan=0.0), extname=extname)
            # per-extension axis keywords (caustic_discplane.cpp:520-540)
            for k, v in (("X0", x0), ("XMAX", xmax), ("DX", dx),
                         ("NX", grid.nx), ("Y0", y0), ("YMAX", ymax),
                         ("DY", dy), ("NY", grid.ny)):
                fits.set_keyword(k, v)
        fits.close()
        print(f"wrote {outfile}")
        return 0

    return main


main_discplane = _main("disc")
main_plane = _main("plane")
main_sourceplane = _main("sphere")

if __name__ == "__main__":
    sys.exit(main_discplane())
