"""Volumetric transfer maps: the reverberation / time-lag machinery.

Capability of the reference Mapper (src/mapper/mapper.{h,cpp}, bitrotted):
propagate rays and, every time a ray enters a new cell of a 3-D
(r, theta, phi) grid, accumulate the arrival time, the local redshift (in
the frame of material following a configurable velocity law) and a ray
count into that cell; divide by counts at the end and pair with the
per-cell proper volume sqrt(-g_rr g_thth g_phph) dr dtheta dphi
(mapper.cpp:110-338). The cell-averaged (time, redshift, N/volume) maps
are the Green's function for X-ray reverberation modelling.

Batched: the 3-D histogram lives in the while-loop carry and every
lock-step iteration scatter-adds the (masked) cell-entry events for the
whole batch.

Notes vs the reference:
  * The reference's propagation loop still uses the legacy COUNT_MIN
    sign-guard (mapper.cpp:171-190), which the author identified as
    physics-distorting (docs/session_2026-03-01.md:166-178); we use the
    corrected was-positive gates shared with the main integrator.
  * The reference excludes bin index 0 on every axis (`ir > 0 && ...`,
    mapper.cpp:247) — an off-by-one that silently drops the innermost
    radial, first polar and first azimuthal bins; we include them.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from raytrace_tpu.destinations import ThetaLimit
from raytrace_tpu.geometry.kerr import horizon_radius, metric_coeffs, momentum_from_consts, metric_dot
from raytrace_tpu.ops.integrate import StepControl, _euler_rk4_body
from raytrace_tpu.rays import RayBatch


@dataclasses.dataclass(frozen=True)
class MapperGrid:
    """Static 3-D binning geometry (mapper.h:51-53)."""

    r0: float
    r_max: float
    n_r: int
    n_theta: int
    n_phi: int
    logbin_r: bool = True
    theta_max: float = jnp.pi

    @property
    def dr(self):
        if self.logbin_r:
            import math

            return math.exp(math.log(self.r_max / self.r0) / self.n_r)
        return (self.r_max - self.r0) / self.n_r

    @property
    def dtheta(self):
        return self.theta_max / self.n_theta

    @property
    def dphi(self):
        return 2.0 * jnp.pi / self.n_phi

    @property
    def n_cells(self):
        return self.n_r * self.n_theta * self.n_phi

    def cell_index(self, r, theta, phi):
        """Flattened cell index; -1 when out of range. phi is wrapped."""
        if self.logbin_r:
            ir = jnp.floor(jnp.log(r / self.r0) / jnp.log(self.dr)).astype(jnp.int32)
        else:
            ir = jnp.floor((r - self.r0) / self.dr).astype(jnp.int32)
        itheta = jnp.floor(theta / self.dtheta).astype(jnp.int32)
        phi_w = phi - 2 * jnp.pi * jnp.floor((phi + jnp.pi) / (2 * jnp.pi))
        iphi = jnp.floor((phi_w + jnp.pi) / self.dphi).astype(jnp.int32)
        ok = (
            (ir >= 0)
            & (ir < self.n_r)
            & (itheta >= 0)
            & (itheta < self.n_theta)
            & (iphi >= 0)
            & (iphi < self.n_phi)
        )
        flat = (ir * self.n_theta + itheta) * self.n_phi + iphi
        return jnp.where(ok, flat, -1), ok


def _local_redshift(r, theta, phi, k, h, Q, rdot_sign, thetadot_sign, emit, spin,
                    V, reverse, motion):
    """emit / E_local in the frame of material at (r, theta) moving with
    angular velocity V (motion 0) or radial velocity V (motion 1) — the
    mapper's per-cell redshift (mapper.cpp:249-258)."""
    a = -spin if reverse else spin
    g = metric_coeffs(r, theta, a)
    if motion == 0:
        dv = V - g.omega
        gamma = 1.0 / jnp.sqrt(1.0 - dv * dv * g.e2psi / g.e2nu)
        ut = gamma / jnp.sqrt(g.e2nu)
        zero = jnp.zeros_like(ut)
        et = (ut, zero, zero, ut * V)
    else:
        ut = 1.0 / jnp.sqrt(g.g_tt + g.g_rr * V * V)
        zero = jnp.zeros_like(ut)
        et = (ut, V * ut, zero, zero)
    pt, pr, pth, pph = momentum_from_consts(r, theta, k, h, Q, rdot_sign, thetadot_sign, spin)
    if reverse:
        pr, pth, pph = -pr, -pth, -pph
    recv = metric_dot(g, et, (pt, pr, pth, pph))
    return jnp.where(reverse, recv / emit, emit / recv)


def velocity_law(motion, vel, vel_mode, r, theta, r_max, spin=0.0,
                 reverse=False):
    """The mapper's material velocity field (mapper.cpp:249-256):
    motion 0 -> projected-radius Keplerian orbit Omega = 1/(a + r_p^{3/2})
    (spin negated for backward-traced planes); motion 1 -> radial with
    vel_mode 0 constant, 1 linear in r/r_max, 2 sqrt(r/r_max)."""
    if motion == 0:
        a_eff = -spin if reverse else spin
        r_p = r * jnp.sin(theta)
        return 1.0 / (a_eff + r_p * jnp.sqrt(r_p))
    if vel_mode == 0:
        return vel * jnp.ones_like(r)
    if vel_mode == 1:
        return vel * (r / r_max)
    return vel * jnp.sqrt(r / r_max)


@partial(
    jax.jit,
    static_argnames=("grid", "method", "motion", "vel_mode", "reverse", "steplim", "ctrl", "max_iters"),
)
def map_rays(
    rays: RayBatch,
    spin,
    grid: MapperGrid,
    *,
    method: str = "euler",
    r_lim=1000.0,
    theta_lim=jnp.pi,
    motion: int = 0,
    vel: float = 0.0,
    vel_mode: int = 0,
    reverse: bool = False,
    steplim: int = 100_000,
    ctrl: StepControl = StepControl(),
    max_iters: int | None = None,
):
    """March the batch, accumulating cell-entry events into the 3-D maps.

    Returns (final_rays, dict(time, redshift, count) each [n_r, n_theta,
    n_phi], not yet count-averaged).
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
    zero_map = jnp.zeros((grid.n_cells + 1,), dtype=rays.r.dtype)
    maps0 = (zero_map, zero_map, zero_map)  # time, redshift, count
    last0 = jnp.full((n,), -2, dtype=jnp.int32)

    def cond(carry):
        st, _, _, it = carry
        return jnp.any(st.active) & (it < max_iters)

    def body(carry):
        st, last, maps, it = carry
        active = st.active
        st2, _ = _euler_rk4_body(st, spin, horizon, dest, r_lim, steplim, ctrl, method, active)

        cell, in_range = grid.cell_index(st2.r, st2.theta, st2.phi)
        moved = active & in_range & (cell != last)

        V = velocity_law(motion, vel, vel_mode, st2.r, st2.theta,
                         grid.r_max, spin, reverse)

        g_local = _local_redshift(
            st2.r, st2.theta, st2.phi, st2.k, st2.h, st2.Q,
            st2.rdot_sign, st2.thetadot_sign, st2.emit, spin, V, reverse, motion,
        )
        good = moved & (g_local > 0) & jnp.isfinite(g_local)
        idx = jnp.where(good, cell, grid.n_cells)  # scrap cell

        t_map, g_map, n_map = maps
        t_map = t_map.at[idx].add(jnp.where(good, st2.t, 0.0))
        g_map = g_map.at[idx].add(jnp.where(good, g_local, 0.0))
        n_map = n_map.at[idx].add(jnp.where(good, 1.0, 0.0))

        last = jnp.where(active & in_range, cell, last)
        return st2, last, (t_map, g_map, n_map), it + 1

    final, _, maps, _ = lax.while_loop(cond, body, (rays, last0, maps0, jnp.int32(0)))
    shape = (grid.n_r, grid.n_theta, grid.n_phi)
    out = {
        "time": maps[0][:-1].reshape(shape),
        "redshift": maps[1][:-1].reshape(shape),
        "count": maps[2][:-1].reshape(shape),
    }
    return final, out


def cell_volumes(grid: MapperGrid, spin):
    """Proper volume of every cell (mapper.cpp:311-338)."""
    ir = jnp.arange(grid.n_r)
    if grid.logbin_r:
        r = grid.r0 * grid.dr**ir
        dr = r * (grid.dr - 1.0)
    else:
        r = grid.r0 + grid.dr * ir
        dr = jnp.full_like(r, grid.dr)
    theta = jnp.arange(grid.n_theta) * grid.dtheta
    g = metric_coeffs(r[:, None], theta[None, :], spin)
    dv = (
        jnp.sqrt(-g.g_rr * g.g_thth * g.g_phph)
        * dr[:, None]
        * grid.dtheta
        * grid.dphi
    )
    return jnp.broadcast_to(dv[:, :, None], (grid.n_r, grid.n_theta, grid.n_phi))


def average_maps(maps: dict) -> dict:
    """Count-average the accumulated maps (mapper.cpp:304-309)."""
    import numpy as np

    count = np.asarray(maps["count"])
    with np.errstate(divide="ignore", invalid="ignore"):
        return {
            "time": np.asarray(maps["time"]) / count,
            "redshift": np.asarray(maps["redshift"]) / count,
            "count": count,
        }


def save_hdf(path, grid: MapperGrid, avg: dict, volume, n_rays=None):
    """HDF5 export with the reference's exact layout (mapper.h:75-107):
    datasets ``time`` / ``redshift`` / ``Nrays`` / ``volume`` of shape
    (n_r, n_theta, n_phi), plus the grid geometry as root attributes
    (r0, rmax, Nr, dr, logbin_r, theta_max, Ntheta, dtheta, Nphi, dphi).
    Uses h5py (present on this image; only the C++ headers are absent).
    """
    import h5py
    import numpy as np

    with h5py.File(path, "w") as f:
        f.attrs["r0"] = float(grid.r0)
        f.attrs["rmax"] = float(grid.r_max)
        f.attrs["Nr"] = int(grid.n_r)
        f.attrs["dr"] = float(grid.dr)
        f.attrs["logbin_r"] = int(grid.logbin_r)
        f.attrs["theta_max"] = float(grid.theta_max)
        f.attrs["Ntheta"] = int(grid.n_theta)
        f.attrs["dtheta"] = float(grid.dtheta)
        f.attrs["Nphi"] = int(grid.n_phi)
        f.attrs["dphi"] = float(grid.dphi)
        if n_rays is not None:
            f.attrs["n_rays"] = int(n_rays)
        f.create_dataset("time", data=np.nan_to_num(np.asarray(avg["time"], np.float64)))
        f.create_dataset("redshift", data=np.nan_to_num(np.asarray(avg["redshift"], np.float64)))
        f.create_dataset("Nrays", data=np.asarray(avg["count"], np.float64))
        f.create_dataset("volume", data=np.asarray(volume, np.float64))


def load_hdf(path):
    """Read a save_hdf file back: (MapperGrid, {time, redshift, count},
    volume)."""
    import h5py
    import numpy as np

    with h5py.File(path, "r") as f:
        grid = MapperGrid(
            r0=float(f.attrs["r0"]),
            r_max=float(f.attrs["rmax"]),
            n_r=int(f.attrs["Nr"]),
            n_theta=int(f.attrs["Ntheta"]),
            n_phi=int(f.attrs["Nphi"]),
            logbin_r=bool(f.attrs["logbin_r"]),
            theta_max=float(f.attrs["theta_max"]),
        )
        avg = {
            "time": np.asarray(f["time"]),
            "redshift": np.asarray(f["redshift"]),
            "count": np.asarray(f["Nrays"]),
        }
        volume = np.asarray(f["volume"])
    return grid, avg, volume
