"""Backward-traced image plane: the observer's camera grid.

Capability of the reference ImagePlane / ImagePlaneBundles
(src/raytracer/imageplane.cpp, imageplane_bundles.h): rays start on a
distant plane perpendicular to the line of sight (distance D, inclination
incl) and are traced *backwards in time* towards the hole. Time reversal is
implemented by negating the spin for the propagation (imageplane.cpp:12) —
the Kerr time-reversal symmetry t -> -t, phi -> -phi is equivalent to
a -> -a. All redshift calls must therefore pass reverse=True.

The constants of motion come from the analytic impact parameters
(imageplane.cpp:100-113): k = 1 (unit energy at infinity), h = -x sin i,
l_theta = y, Q = l_theta^2 - (a cos theta)^2 + (h / tan theta)^2. The
closed forms for h and l_theta are what the reference's
(b, beta)-parametrised expressions reduce to; they avoid the b = 0 center
singularity.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from raytrace_tpu.geometry.kerr import metric_coeffs
from raytrace_tpu.rays import RayBatch, blank_batch


@dataclasses.dataclass(frozen=True)
class ImagePlaneGrid:
    """Static image-plane grid geometry.

    Note: the reference x-grid strides by dy due to a copy-paste quirk
    (imageplane.cpp:43); every app passes dx == dy so this grid uses dx
    properly (SURVEY.md §7, quirks to normalise).
    """

    nx: int
    ny: int
    x0: float
    y0: float
    dx: float
    dy: float

    @classmethod
    def from_steps(cls, x0, xmax, dx, y0, ymax, dy):
        nx = int((xmax - x0) / dx) + 1
        ny = int((ymax - y0) / dy) + 1
        return cls(nx, ny, float(x0), float(y0), float(dx), float(dy))

    @property
    def n_rays(self) -> int:
        return self.nx * self.ny

    def xy(self, dtype=jnp.float64):
        x = self.x0 + jnp.arange(self.nx, dtype=dtype) * self.dx
        y = self.y0 + jnp.arange(self.ny, dtype=dtype) * self.dy
        X, Y = jnp.meshgrid(x, y, indexing="ij")
        return X.reshape(-1), Y.reshape(-1)

    def x_index(self, x):
        """Pixel index from a stored plane coordinate (imageplane.h:36-60)."""
        return jnp.round((x - self.x0) / self.dx).astype(jnp.int32)

    def y_index(self, y):
        return jnp.round((y - self.y0) / self.dy).astype(jnp.int32)


def _plane_ray(x, y, D, incl, phi0, a_trace, dtype, work_eps=None):
    """Initial BL position, momentum and constants for one plane point.

    Geometry and null-condition quadratic per imageplane.cpp:50-113;
    a_trace is the (already negated) propagation spin. ``work_eps`` is the
    machine epsilon of the dtype the MARCH will run in (may be coarser than
    the dtype this function computes in — f64 seeding of an f32 pipeline);
    it sets the knife-edge regularisation floor below.
    """
    t = jnp.zeros_like(x)
    r = jnp.sqrt(D * D + x * x + y * y)
    theta = jnp.arccos((D * jnp.cos(incl) + y * jnp.sin(incl)) / r)
    phi = phi0 + jnp.arctan2(x, D * jnp.sin(incl) - y * jnp.cos(incl))

    pr = D / r
    ptheta = jnp.sin(jnp.arccos(D / r)) / r
    denom = x * x + (D * jnp.sin(incl) - y * jnp.cos(incl)) ** 2
    pphi = x * jnp.sin(incl) / denom

    # p^t from the null condition g_munu p^mu p^nu = 0 (positive root)
    g = metric_coeffs(r, theta, a_trace)
    A = g.g_tt
    B = 2.0 * g.g_tphi * pphi
    C = g.g_rr * pr * pr + g.g_thth * ptheta * ptheta + g.g_phph * pphi * pphi
    disc = jnp.sqrt(B * B - 4.0 * A * C)
    pt = (-B + disc) / (2.0 * A)
    pt = jnp.where(pt < 0, (-B - disc) / (2.0 * A), pt)

    # analytic constants of motion (imageplane.cpp:100-113; closed forms).
    # Rays with y ~ 0 start *exactly at their polar turning point*
    # (thetadot_sq(theta_0) = l_theta^2 ~ 0 identically), where the
    # integrator's turning-point sign gate degenerates to a rounding
    # coin-flip — the unlucky sign marches the ray into the forbidden
    # region and it spirals off over the pole (the reference has the same
    # y = 0 knife edge). Regularise with a small polar impact parameter
    # scaled to the MARCH dtype's cancellation noise: each step re-derives
    # thetadot_sq = Q + cos^2(k^2 a^2 - h^2/sin^2) from the carried
    # constants, with rounding noise ~ eps_work * |terms| — the floor must
    # dominate it (factor 100 in variance) or the polar velocity becomes
    # noise-driven and the ray can random-walk over the pole. In f64 the
    # historical 1e-4 r_g floor dominates everywhere; in f32 with |h| ~ 30
    # the floor is ~0.02 r_g (still far below practical pixel scales).
    k = jnp.ones_like(x)
    h = -x * jnp.sin(incl)
    if work_eps is None:
        work_eps = jnp.finfo(jnp.result_type(x)).eps
    cos_t, tan_t = jnp.cos(theta), jnp.tan(theta)
    noise = work_eps * (1.0 + (h / tan_t) ** 2 + (a_trace * cos_t) ** 2)
    floor = jnp.maximum(1e-4, jnp.sqrt(100.0 * noise))
    ltheta = jnp.where(jnp.abs(y) < floor, jnp.where(y < 0, -floor, floor), y)
    Q = ltheta * ltheta - (a_trace * cos_t) ** 2 + (h / tan_t) ** 2

    rdot_sign = -jnp.ones_like(x)
    thetadot_sign = jnp.where(ltheta >= 0, 1.0, -1.0).astype(dtype)
    return t, r, theta, phi, (pt, pr, ptheta, pphi), (k, h, Q), rdot_sign, thetadot_sign


def _seed_f64(grid: ImagePlaneGrid, dist, incl_deg, phi0, a_trace, xy=None,
              work_dtype=jnp.float64):
    """Run _plane_ray in true f64 on the host CPU, returning numpy arrays.

    The far-field image plane is precision-critical (SURVEY §7): at the
    reference's canonical dist = 10^4 the f32 ulp of r is ~10^-3 r_g and the
    ulp of theta ~1.2e-7 rad (~10^-3 r_g transverse), so f32-computed
    arccos/quadratic chains would put several-ulp errors on every starting
    position. Seeding in f64 and rounding once to the working dtype keeps
    the start error at <= 0.5 ulp — the representability floor. Runs
    eagerly on the host CPU because source construction is one-shot.
    """
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.enable_x64(True):
        incl = jnp.asarray(float(incl_deg), jnp.float64) * jnp.pi / 180.0
        if xy is None:
            x, y = grid.xy(jnp.float64)
        else:
            x = jnp.asarray(np.asarray(xy[0], np.float64))
            y = jnp.asarray(np.asarray(xy[1], np.float64))
        out = _plane_ray(
            x, y,
            jnp.asarray(float(dist), jnp.float64), incl,
            jnp.asarray(float(phi0), jnp.float64),
            jnp.asarray(float(a_trace), jnp.float64), jnp.float64,
            work_eps=float(jnp.finfo(jax.dtypes.canonicalize_dtype(work_dtype)).eps),
        )
        return jax.tree.map(np.asarray, out), np.asarray(x), np.asarray(y)


def _is_concrete(*vals) -> bool:
    return not any(isinstance(v, jax.core.Tracer) for v in vals)


def image_plane(
    dist,
    incl_deg,
    grid: ImagePlaneGrid,
    spin,
    phi0=0.0,
    dtype=jnp.float64,
) -> RayBatch:
    """Build the backward-traced camera batch.

    Propagate the result with ``trace(rays, spin=-spin, ...)`` (or use
    ``trace_spin`` below) and pass reverse=True to all redshift calls.
    ``rays.alpha`` / ``rays.beta`` store the plane (x, y) coordinates
    (imageplane.cpp:117-118).

    Whenever the parameters are concrete the initial conditions are seeded
    in true f64 on the host CPU and rounded once to the working dtype — see
    _seed_f64 (bit-identical on the CPU f64 path; for an f32 march it fixes
    the far-field start precision).
    Traced parameters (e.g. spin under jax.grad) keep the all-traced
    construction.
    """
    a_trace = -spin  # time reversal (imageplane.cpp:12)
    if _is_concrete(dist, incl_deg, spin, phi0):
        parts, x, y = _seed_f64(grid, dist, incl_deg, phi0, a_trace,
                                 work_dtype=dtype)
    else:
        incl = jnp.asarray(incl_deg, dtype=dtype) * jnp.pi / 180.0
        x, y = grid.xy(dtype)
        D = jnp.asarray(dist, dtype=dtype)
        parts = _plane_ray(
            x, y, D, incl, jnp.asarray(phi0, dtype=dtype), a_trace, dtype
        )
    return _batch_from_parts(parts, x, y, dtype)


def _batch_from_parts(parts, x, y, dtype) -> RayBatch:
    """Assemble a live RayBatch, rounding every field once to the working
    dtype (a no-op for the all-traced construction)."""
    t, r, theta, phi, mom, consts, rdot_sign, thetadot_sign = parts
    ft = jax.dtypes.canonicalize_dtype(dtype)
    c = lambda v: jnp.asarray(v, ft)
    n = int(np.shape(x)[0])
    base = blank_batch(n, dtype)
    return base.replace(
        t=c(t),
        r=c(r),
        theta=c(theta),
        phi=c(phi),
        pt=c(mom[0]),
        pr=c(mom[1]),
        ptheta=c(mom[2]),
        pphi=c(mom[3]),
        k=c(consts[0]),
        h=c(consts[1]),
        Q=c(consts[2]),
        rdot_sign=c(rdot_sign),
        thetadot_sign=c(thetadot_sign),
        steps=jnp.zeros((n,), dtype=jnp.int32),
        alpha=c(x),
        beta=c(y),
    )


def image_plane_bundles(
    dist,
    incl_deg,
    grid: ImagePlaneGrid,
    spin,
    phi0=0.0,
    eps_frac=0.01,
    dtype=jnp.float64,
):
    """5-ray bundles per pixel: centre + E/W/N/S satellites at +-eps.

    Capability of imageplane_bundles.h:44-200, used by the caustic apps for
    local lensing Jacobians. Returns a RayBatch of 5 * nx * ny rays ordered
    [centre, east(+x), west(-x), north(+y), south(-y)] x pixels — i.e. ray
    index = bundle_slot * n_pixels + pixel — plus the eps actually used.

    f32 precision envelope: the satellites' starting positions differ by
    ~eps/D in theta, so once the working dtype is f32 the bundle geometry
    is quantised at the ulp of theta (~1.2e-7 rad). At eps_frac = 0.01 and
    pixel scales ~0.1 r_g that is adequate up to D ~ 10^3; beyond that,
    raise eps_frac (the Jacobian is linear well past 10x this eps) or stay
    in f64 — the seeding below is already exact to 0.5 ulp either way.
    """
    a_trace = -spin
    eps = eps_frac * min(grid.dx, grid.dy)
    offsets = [(0.0, 0.0), (eps, 0.0), (-eps, 0.0), (0.0, eps), (0.0, -eps)]

    if _is_concrete(dist, incl_deg, spin, phi0):
        # plane coordinates and seeds in f64; one rounding at the end
        xg = np.asarray(grid.x0, np.float64) + np.arange(grid.nx) * grid.dx
        yg = np.asarray(grid.y0, np.float64) + np.arange(grid.ny) * grid.dy
        Xc, Yc = np.meshgrid(xg, yg, indexing="ij")
        xc, yc = Xc.reshape(-1), Yc.reshape(-1)
        xs = np.concatenate([xc + ox for ox, _ in offsets])
        ys = np.concatenate([yc + oy for _, oy in offsets])
        parts, xs, ys = _seed_f64(grid, dist, incl_deg, phi0, a_trace,
                                  xy=(xs, ys), work_dtype=dtype)
    else:
        incl = jnp.asarray(incl_deg, dtype=dtype) * jnp.pi / 180.0
        xc, yc = grid.xy(dtype)
        D = jnp.asarray(dist, dtype=dtype)
        xs = jnp.concatenate([xc + ox for ox, _ in offsets])
        ys = jnp.concatenate([yc + oy for _, oy in offsets])
        parts = _plane_ray(
            xs, ys, D, incl, jnp.asarray(phi0, dtype=dtype), a_trace, dtype
        )
    return _batch_from_parts(parts, xs, ys, dtype), eps
