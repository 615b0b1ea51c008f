"""Proper areas of equatorial accretion-disc annuli.

Capability of the reference ``src/include/disc.h``: tetrad-projected
parallelogram areas of thin annuli, in the Keplerian region (r >= ISCO, frame
of the circular orbit) and the plunging region inside the ISCO (frame of a
geodesic plunge conserving the ISCO energy and angular momentum), plus the
integrated bin areas used by every emissivity-profile application for
per-bin normalisation.
"""

from __future__ import annotations

import jax.numpy as jnp

from raytrace_tpu.geometry.kerr import (
    Tetrad,
    horizon_radius,
    isco_radius,
    keplerian_omega,
    metric_coeffs,
    metric_dot,
    orbit_tetrad,
)
from raytrace_tpu.geometry.gramschmidt import gram_schmidt_tetrad


def coordinate_disc_area(r, dr, a):
    """Proper area of an equatorial annulus for a static slice (kerr.h:249-265)."""
    rhosq = r * r
    delta = r * r - 2.0 * r + a * a
    return jnp.sqrt(r * r + a * a + 2.0 * a * a * r / rhosq) * jnp.sqrt(rhosq / delta) * dr


def _parallelogram_area(r, dr, dphi, a, tet: Tetrad):
    """Area of the (dr x dphi) coordinate parallelogram in the frame `tet`.

    Projects the two coordinate sides onto the tetrad legs and takes the
    norm of the 3-space cross product (disc.h:23-31). The projected
    components are ordered (phi, theta, r) to match the tetrad leg order.
    """
    g = metric_coeffs(r, jnp.full_like(r, jnp.pi / 2), a)
    zero = jnp.zeros_like(r)
    side_r = (zero, dr, zero, zero)
    side_phi = (zero, zero, zero, dphi)

    def project(side):
        return (
            metric_dot(g, side, tet.ephi),
            metric_dot(g, side, tet.etheta),
            metric_dot(g, side, tet.er),
        )

    u = project(side_r)
    v = project(side_phi)
    cx = u[1] * v[2] - u[2] * v[1]
    cy = u[2] * v[0] - u[0] * v[2]
    cz = u[0] * v[1] - u[1] * v[0]
    return jnp.sqrt(cx * cx + cy * cy + cz * cz)


def rel_disc_area(r, dr, dphi, a):
    """Annulus area in the local rest frame of Keplerian disc material.

    Capability of disc.h:11-32 (`rel_vector_disc_area`).
    """
    theta = jnp.full_like(jnp.asarray(r, dtype=jnp.result_type(r, 1.0)), jnp.pi / 2)
    V = keplerian_omega(r, a)
    tet = orbit_tetrad(r, theta, a, V)
    return _parallelogram_area(r, dr, dphi, a, tet)


def plunge_velocity(r, a, r_plunge=None):
    """4-velocity of a geodesic plunge from the ISCO at equatorial radius r.

    The plunging material conserves the energy k and angular momentum h of
    the circular orbit at the plunge radius (default: the ISCO), giving
    (disc.h:44-57):
      u^t   = ((r^2 + a^2 + 2a^2/r) k - 2 a h / r) / delta
      u^r   = -sqrt(k^2 - 1 + 2/r + (a^2(k^2-1) - h^2)/r^2 + 2(h - a k)^2/r^3)
      u^phi = (2 a k / r + (1 - 2/r) h) / delta
    At r = r_plunge the u^r operand underflows to ~0; it is clamped to zero.
    """
    if r_plunge is None:
        r_plunge = isco_radius(a)
    delta = r * r - 2.0 * r + a * a
    u = 1.0 / r_plunge
    root = jnp.sqrt(u * u * u)
    den = jnp.sqrt(1.0 - 3.0 * u + 2.0 * a * root)
    k = (1.0 - 2.0 * u + a * root) / den
    h = (1.0 + a * a * u * u - 2.0 * a * root) / (jnp.sqrt(u) * den)

    ut = ((r * r + a * a + 2.0 * a * a / r) * k - 2.0 * a * h / r) / delta
    ur_sq = (
        k * k
        - 1.0
        + 2.0 / r
        + (a * a * (k * k - 1.0) - h * h) / (r * r)
        + 2.0 * (h - a * k) * (h - a * k) / (r * r * r)
    )
    ur = -jnp.sqrt(jnp.maximum(ur_sq, 0.0))
    uphi = (2.0 * a * k / r + (1.0 - 2.0 / r) * h) / delta
    return (ut, ur, jnp.zeros_like(ut), uphi)


def plunge_disc_area(r, dr, dphi, a, r_plunge=None):
    """Annulus area in the rest frame of ISCO-plunge material (disc.h:34-76)."""
    theta = jnp.full_like(jnp.asarray(r, dtype=jnp.result_type(r, 1.0)), jnp.pi / 2)
    u = plunge_velocity(r, a, r_plunge)
    tet = gram_schmidt_tetrad(r, theta, u, a)
    return _parallelogram_area(r, dr, dphi, a, tet)


def _kep_plunge_area(r, dr, dphi, a, switch_r, force_keplerian, r_plunge):
    """Keplerian-vs-plunge area switch, AD-safe on the dead branch.

    Each frame is only valid on its own side of the switch radius (the
    plunge u^r operand goes negative outside it, the orbit Lorentz factor
    degenerates deep inside), so the unselected branch must be evaluated at
    a clamped radius: a dead branch whose value or gradient is non-finite
    poisons reverse-mode AD of the selected one (0 * inf = NaN through the
    jnp.where cotangent). Gradients of binned-emissivity area
    normalisations w.r.t. spin depend on this (tests/test_diff.py).
    """
    if force_keplerian:
        return rel_disc_area(r, dr, dphi, a)
    in_plunge = r < switch_r
    kep = rel_disc_area(jnp.maximum(r, switch_r), dr, dphi, a)
    # interior point of the plunge region, strictly between horizon and ISCO
    r_h = horizon_radius(a)
    r_safe = 0.5 * (r_h + switch_r)
    above_horizon = r > r_h * (1.0 + 1e-9)
    plunge = plunge_disc_area(
        jnp.where(in_plunge & above_horizon, r, r_safe), dr, dphi, a, r_plunge
    )
    area = jnp.where(in_plunge, plunge, kep)
    # sub-horizon annuli are unphysical (delta <= 0 made them NaN -> dropped
    # before); exclude them on the raw radius so the clamped evaluation
    # above cannot leak a finite value into them
    return jnp.where(above_horizon, area, 0.0)


def integrate_disc_area_bins(
    r_lo, r_hi, a, force_keplerian=False, n_sub=50, dphi=0.1, logbin=True,
    r_plunge=None,
):
    """Rest-frame areas of many [r_lo_i, r_hi_i) bins at once.

    Vectorised twin of `integrate_disc_area` over a batch of bins: one
    (n_bins, n_sub) evaluation instead of a Python loop of per-bin calls.
    """
    r_lo = jnp.asarray(r_lo, dtype=jnp.result_type(r_lo, 1.0))
    r_hi = jnp.asarray(r_hi, dtype=r_lo.dtype)
    r_isco = isco_radius(a)
    idx = jnp.arange(n_sub - 1)
    if logbin:
        ratio = jnp.exp(jnp.log(r_hi / r_lo) / (n_sub - 1))  # [n_bins]
        r = r_lo[:, None] * ratio[:, None] ** idx[None, :]
        dr = r * (ratio[:, None] - 1.0)
    else:
        dr_lin = (r_hi - r_lo) / (n_sub - 1)
        r = r_lo[:, None] + idx[None, :] * dr_lin[:, None]
        dr = jnp.broadcast_to(dr_lin[:, None], r.shape)

    switch_r = r_isco if r_plunge is None else r_plunge
    area = _kep_plunge_area(r, dr, dphi, a, switch_r, force_keplerian, r_plunge)
    return jnp.sum(jnp.where(area > 0, area, 0.0), axis=1)


def integrate_disc_area(rmin, rmax, a, force_keplerian=False, n_sub=50, dphi=0.1, logbin=True, r_plunge=None):
    """Total rest-frame area of the disc between rmin and rmax.

    Splits [rmin, rmax) into n_sub-1 sub-annuli (log or linear), evaluates
    each in the Keplerian frame outside the ISCO and the plunge frame inside
    (unless force_keplerian), and sums the positive contributions
    (disc.h:125-141). Vectorised over the sub-annuli; rmin/rmax must be
    scalars (they are in every reference app).
    """
    rmin = jnp.asarray(rmin, dtype=jnp.result_type(rmin, 1.0))
    r_isco = isco_radius(a)
    idx = jnp.arange(n_sub - 1)
    if logbin:
        ratio = jnp.exp(jnp.log(rmax / rmin) / (n_sub - 1))
        r = rmin * ratio**idx
        dr = r * (ratio - 1.0)
    else:
        dr_lin = (rmax - rmin) / (n_sub - 1)
        r = rmin + idx * dr_lin
        dr = jnp.full_like(r, dr_lin)

    switch_r = r_isco if r_plunge is None else r_plunge
    area = _kep_plunge_area(r, dr, dphi, a, switch_r, force_keplerian, r_plunge)
    return jnp.sum(jnp.where(area > 0, area, 0.0))
