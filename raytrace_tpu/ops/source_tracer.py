"""Radiative transfer along backward-traced rays through an emitting volume.

Capability of the reference SourceTracer (src/source_tracer/
source_tracer.cpp, bitrotted): as each (image-plane) ray marches, inside a
configurable emitting region accumulate into per-ray energy bins

    emis[ray, ien]   += epsilon * rho * E_loc^3 * exp(-absorb[ray, ien])
    absorb[ray, ien] += dl * rho

with dl the local proper length of the step, rho the wind density, E_loc
the energy shift into the local wind frame (a configurable velocity law),
and an optional global (energy, time) response accumulated alongside
(source_tracer.cpp:232-275). A pluggable stopping criterion terminates
rays that run into the opaque central source (outflow.cpp:17-32).

The region / density / velocity model is supplied as a WindModel rather
than the reference's hard-coded shell, with defaults reproducing it.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from raytrace_tpu import pytree
from raytrace_tpu.destinations import ThetaLimit
from raytrace_tpu.geometry.kerr import horizon_radius
from raytrace_tpu.ops.integrate import StepControl, _euler_rk4_body
from raytrace_tpu.ops.mapper import _local_redshift
from raytrace_tpu.rays import RayBatch


@pytree.dataclass
class WindModel:
    """Emitting-wind description (parameters traced; gradients flow).

    Defaults reproduce the reference's hard-coded model
    (source_tracer.cpp:245-252): a shell 10 < r < 50, 0.5 < theta < pi/2,
    radial beta-law velocity v(r) = v0 (0.01 + 0.99 (1 - 1/r)), mass
    continuity density rho = 1/(r^2 |v|).
    """

    v0: jnp.ndarray = 0.1
    r_in: jnp.ndarray = 10.0
    r_out: jnp.ndarray = 50.0
    theta_min: jnp.ndarray = 0.5
    theta_max: jnp.ndarray = jnp.pi / 2
    motion: int = pytree.static_field(default=1)  # radial

    def in_region(self, r, theta, phi):
        return (
            (r > self.r_in)
            & (r < self.r_out)
            & (theta > self.theta_min)
            & (theta < self.theta_max)
        )

    def velocity(self, r):
        return self.v0 * (0.01 + 0.99 * (1.0 - 1.0 / r))

    def density(self, r):
        return 1.0 / (r * r * jnp.abs(self.velocity(r)))


@pytree.dataclass
class SphericalStop:
    """Stop rays entering a sphere of radius R centred on the origin —
    the opaque central X-ray source (outflow.cpp:17-32)."""

    radius: jnp.ndarray = 0.0

    def __call__(self, t, r, theta, phi):
        return r < self.radius


@dataclasses.dataclass(frozen=True)
class EnergyTimeBins:
    """Static (energy, time) response binning (source_tracer.h:60-75)."""

    en0: float = 0.1
    en_max: float = 10.0
    n_en: int = 200
    logbin_en: bool = True
    t0: float = 0.0
    dt: float = 10.0
    n_t: int = 1

    @property
    def den(self):
        import math

        if self.logbin_en:
            return math.exp(math.log(self.en_max / self.en0) / self.n_en)
        return (self.en_max - self.en0) / self.n_en

    def energy_index(self, e):
        if self.logbin_en:
            i = jnp.floor(jnp.log(e / self.en0) / jnp.log(self.den))
        else:
            i = jnp.floor((e - self.en0) / self.den)
        return i.astype(jnp.int32)

    def energies(self):
        import numpy as np

        i = np.arange(self.n_en)
        if self.logbin_en:
            return self.en0 * self.den**i
        return self.en0 + self.den * i


@partial(
    jax.jit,
    static_argnames=("bins", "method", "reverse", "steplim", "ctrl", "max_iters"),
)
def run_source_trace(
    rays: RayBatch,
    spin,
    wind: WindModel,
    bins: EnergyTimeBins,
    *,
    stop=SphericalStop(0.0),
    method: str = "euler",
    r_lim=1000.0,
    theta_lim=0.0,
    reverse: bool = True,
    steplim: int = 100_000,
    ctrl: StepControl = StepControl(),
    max_iters: int | None = None,
):
    """March the batch through the wind, accumulating per-ray spectra.

    Returns (final_rays, emis[N, n_en], absorb[N, n_en],
    response[n_en, n_t]).
    """
    if max_iters is None:
        max_iters = steplim + 16
    horizon = horizon_radius(spin)
    dest = ThetaLimit(theta_lim)

    rays = rays.replace(
        r_was_positive=jnp.zeros_like(rays.r_was_positive),
        theta_was_positive=jnp.ones_like(rays.theta_was_positive),
    )
    n = rays.n_rays
    dtype = rays.r.dtype
    emis0 = jnp.zeros((n, bins.n_en + 1), dtype=dtype)
    absorb0 = jnp.zeros((n, bins.n_en + 1), dtype=dtype)
    resp0 = jnp.zeros((bins.n_en + 1, bins.n_t + 1), dtype=dtype)
    lanes = jnp.arange(n)

    def cond(carry):
        st, _, _, _, it = carry
        return jnp.any(st.active) & (it < max_iters)

    def body(carry):
        st, emis, absorb, resp, it = carry
        active = st.active
        prev = (st.t, st.r, st.theta, st.phi)
        st2, _ = _euler_rk4_body(st, spin, horizon, dest, r_lim, steplim, ctrl, method, active)

        moved = active & (st2.steps > st.steps)
        # stopping criterion: freeze the ray where it enters the source
        stopped = moved & stop(st2.t, st2.r, st2.theta, st2.phi)
        st2 = st2.replace(
            status=st2.status | jnp.where(stopped, jnp.int32(1), jnp.int32(0))  # DEST
        )

        dr = st2.r - prev[1]
        dth = st2.theta - prev[2]
        dph = st2.phi - prev[3]
        from raytrace_tpu.geometry.kerr import metric_coeffs

        g = metric_coeffs(st2.r, st2.theta, spin)
        dl_sq = -(g.g_rr * dr * dr + g.g_thth * dth * dth + g.g_phph * dph * dph)
        dl = jnp.sqrt(jnp.maximum(dl_sq, 0.0))

        in_wind = moved & ~stopped & wind.in_region(st2.r, st2.theta, st2.phi)
        v = wind.velocity(st2.r)
        rho = wind.density(st2.r)
        g_loc = _local_redshift(
            st2.r, st2.theta, st2.phi, st2.k, st2.h, st2.Q,
            st2.rdot_sign, st2.thetadot_sign, st2.emit, spin, v, reverse,
            wind.motion,
        )
        energy = 1.0 / g_loc
        ien = bins.energy_index(jnp.maximum(energy, 1e-30))
        it_bin = jnp.floor((st2.t - bins.t0) / bins.dt).astype(jnp.int32)

        good = in_wind & (ien >= 0) & (ien < bins.n_en) & (dl > 0) & jnp.isfinite(energy)
        ien_s = jnp.where(good, ien, bins.n_en)
        it_s = jnp.clip(jnp.where(good, it_bin, bins.n_t), 0, bins.n_t)

        # single point-source patch approximation (source_tracer.cpp:259-262)
        emissivity = (dl * dl) / (4.0 * jnp.pi * st2.r * st2.r)
        tau = absorb[lanes, ien_s]
        dem = jnp.where(good, emissivity * rho * energy**3 * jnp.exp(-tau), 0.0)
        dab = jnp.where(good, dl * rho, 0.0)
        emis = emis.at[lanes, ien_s].add(dem)
        absorb = absorb.at[lanes, ien_s].add(dab)
        resp = resp.at[ien_s, it_s].add(
            jnp.where(good, emissivity * dl * rho * energy**3, 0.0)
        )
        return st2, emis, absorb, resp, it + 1

    final, emis, absorb, resp, _ = lax.while_loop(
        cond, body, (rays, emis0, absorb0, resp0, jnp.int32(0))
    )
    return final, emis[:, :-1], absorb[:, :-1], resp[:-1, :-1]
