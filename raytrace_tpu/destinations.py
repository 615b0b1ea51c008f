"""Ray termination surfaces and their observer velocity fields.

Capability of the reference ``src/raytracer/ray_destination.h``: pluggable
stopping criteria consulted after every integrator step, a step-size cap to
stop the adaptive integrator overshooting the surface, and the 4-velocity
field of the material at the surface (for redshift calculations).

Design: destinations are pytree dataclasses (raytrace_tpu.pytree) whose parameters
(theta_lim, r_isco, ...) are traced arrays — so gradients flow through them —
while the *choice* of destination is static Python polymorphism resolved at
trace time (no virtual dispatch, no lax.switch).

`ThetaLimit` doubles as the reference's plain ``thetalim`` propagation mode
(raytracer.cpp:172): theta_lim > 0 stops at theta >= theta_lim, theta_lim < 0
stops at theta <= |theta_lim| (tracing back towards the pole), theta_lim == 0
never stops on theta (used with an outer radial limit only).
"""

from __future__ import annotations

import jax.numpy as jnp

from raytrace_tpu import pytree
from raytrace_tpu.geometry.kerr import keplerian_omega, metric_coeffs

_INF = jnp.inf


def _keplerian_four_velocity(r, theta, spin, V=None):
    """Circular-orbit 4-velocity at angular velocity V (Keplerian if None).

    Mirrors RayDestination<T>::four_velocity (ray_destination.h:59-78).
    """
    g = metric_coeffs(r, theta, spin)
    if V is None:
        V = keplerian_omega(r, spin)
    dv = V - g.omega
    gamma = 1.0 / jnp.sqrt(1.0 - dv * dv * g.e2psi / g.e2nu)
    ut = gamma / jnp.sqrt(g.e2nu)
    zero = jnp.zeros_like(ut)
    return (ut, zero, zero, gamma * V / jnp.sqrt(g.e2nu))


class Destination:
    """Interface; concrete destinations are pytree dataclasses implementing these."""

    def reached(self, r, theta, phi, prev_theta):
        raise NotImplementedError

    def step_limit(self, r, theta, phi, pr, ptheta, pphi):
        """Upper bound on the next step so the surface is not overshot.

        Return +inf where no meaningful bound exists (ray_destination.h:55-57).
        """
        return jnp.full_like(r, _INF)

    def four_velocity(self, r, theta, phi, spin):
        return _keplerian_four_velocity(r, theta, spin)


@pytree.dataclass
class ThetaLimit(Destination):
    """Stop on a polar-angle limit — the reference's thetalim mode and its
    FlatDiscDestination (ray_destination.h:85-102) in one."""

    theta_lim: jnp.ndarray = jnp.pi / 2

    def reached(self, r, theta, phi, prev_theta):
        tl = self.theta_lim
        pos = (tl > 0) & (theta >= tl)
        neg = (tl < 0) & (theta <= -tl)
        return pos | neg

    def step_limit(self, r, theta, phi, pr, ptheta, pphi):
        tl = self.theta_lim
        one = jnp.ones_like(ptheta)
        inf = jnp.full_like(ptheta, _INF)
        up = (tl > 0) & (ptheta > 0) & (theta < tl)
        down = (tl < 0) & (ptheta < 0) & (theta > -tl)
        lim_up = (tl - theta) / jnp.where(ptheta == 0, one, ptheta)
        lim_down = (-tl - theta) / jnp.where(ptheta == 0, one, ptheta)
        return jnp.where(up, lim_up, jnp.where(down, lim_down, inf))


# The reference exposes FlatDiscDestination(theta_lim) with identical
# semantics to the thetalim mode; alias it for API parity.
FlatDisc = ThetaLimit


@pytree.dataclass
class DiscWithISCO(Destination):
    """Equatorial annulus r in [r_isco, r_out]; rays inside the ISCO or beyond
    r_out pass through (ray_destination.h:115-152). Crossing-aware: a ray
    stops only when theta actually crossed theta_lim since the previous step,
    from either side."""

    r_isco: jnp.ndarray
    r_out: jnp.ndarray = -1.0
    theta_lim: jnp.ndarray = jnp.pi / 2

    def _in_annulus(self, r):
        inside = r >= self.r_isco
        outer_ok = (self.r_out <= 0) | (r <= self.r_out)
        return inside & outer_ok

    def reached(self, r, theta, phi, prev_theta):
        lim = jnp.where(self.theta_lim > 0, self.theta_lim, -self.theta_lim)
        crossed = ((prev_theta < lim) & (theta >= lim)) | (
            (prev_theta > lim) & (theta <= lim)
        )
        return self._in_annulus(r) & crossed & (self.theta_lim != 0)

    def step_limit(self, r, theta, phi, pr, ptheta, pphi):
        tl = self.theta_lim
        one = jnp.ones_like(ptheta)
        inf = jnp.full_like(ptheta, _INF)
        applicable = self._in_annulus(r)
        up = (tl > 0) & (ptheta > 0) & (theta < tl)
        down = (tl < 0) & (ptheta < 0) & (theta > -tl)
        lim_up = (tl - theta) / jnp.where(ptheta == 0, one, ptheta)
        lim_down = (-tl - theta) / jnp.where(ptheta == 0, one, ptheta)
        lim = jnp.where(up, lim_up, jnp.where(down, lim_down, inf))
        return jnp.where(applicable, lim, inf)


@pytree.dataclass
class FlatPlane(Destination):
    """Flat lensing source plane perpendicular to the observer line of sight,
    z_s gravitational radii behind the hole (ray_destination.h:172-204).

    The observer direction is n = (sin i cos phi0, sin i sin phi0, cos i) in
    spin-axis Cartesian coordinates; the ray stops when its signed projection
    along n drops below -z_s.
    """

    incl: jnp.ndarray
    phi0: jnp.ndarray = 0.0
    z_s: jnp.ndarray = 100.0

    def projection(self, r, theta, phi):
        return r * (
            jnp.sin(theta) * jnp.sin(self.incl) * jnp.cos(phi - self.phi0)
            + jnp.cos(theta) * jnp.cos(self.incl)
        )

    def reached(self, r, theta, phi, prev_theta):
        return self.projection(r, theta, phi) <= -self.z_s

    def source_coords(self, r, theta, phi):
        """East/North Cartesian coordinates on the source plane, oriented as
        the image plane (ray_destination.h:195-203)."""
        X = r * jnp.sin(theta) * jnp.cos(phi)
        Y = r * jnp.sin(theta) * jnp.sin(phi)
        Z = r * jnp.cos(theta)
        x_s = -X * jnp.sin(self.phi0) + Y * jnp.cos(self.phi0)
        y_s = (
            -X * jnp.cos(self.incl) * jnp.cos(self.phi0)
            - Y * jnp.cos(self.incl) * jnp.sin(self.phi0)
            + Z * jnp.sin(self.incl)
        )
        return x_s, y_s


@pytree.dataclass
class SphericalShell(Destination):
    """Stop on r >= r_shell — an explicit far-sphere destination (the
    reference achieves this with thetalim=0 plus the rlim termination;
    provided for symmetry and for outflow stopping surfaces)."""

    r_shell: jnp.ndarray

    def reached(self, r, theta, phi, prev_theta):
        return r >= self.r_shell

    def step_limit(self, r, theta, phi, pr, ptheta, pphi):
        out = (pr > 0) & (r < self.r_shell)
        lim = (self.r_shell - r) / jnp.where(pr == 0, jnp.ones_like(pr), pr)
        return jnp.where(out, lim, jnp.full_like(pr, _INF))


@pytree.dataclass
class RadialVelocityField(Destination):
    """Never-stopping destination carrying a purely radial observer velocity
    field, for redshifts of material moving radially at dr/dt = v (the
    reference's motion=1 redshift mode, raytracer.cpp:528-535).

    v < 0 is interpreted as |v| times the local coordinate speed of light
    (delta + 2 a) / (r^2 + a^2) scaling as in the reference."""

    v: jnp.ndarray

    def reached(self, r, theta, phi, prev_theta):
        return jnp.zeros_like(r, dtype=bool)

    def four_velocity(self, r, theta, phi, spin):
        g = metric_coeffs(r, theta, spin)
        v = self.v
        v = jnp.where(
            v < 0,
            jnp.abs(v) * (r * r - 2.0 * r + spin + spin) / (r * r + spin * spin),
            v,
        )
        ut = 1.0 / jnp.sqrt(g.g_tt + g.g_rr * v * v)
        zero = jnp.zeros_like(ut)
        return (ut, v * ut, zero, zero)
