"""Flat-space P-Cygni line profile from a spherical beta-law wind.

Capability of the reference standalone ``pcyg`` (src/outflow/pcyg.cpp): a
Cartesian grid of parallel sightlines marches through a spherical wind
shell (r_min < r < r_sph) around a star of radius r_star; per sightline
and per energy bin, resonant line emission with self-absorption
accumulates along z, the continuum from star-covering sightlines is
attenuated by the integrated line opacity, and the summed spectrum shows
the classic P-Cygni blue absorption trough + red emission wing.

The reference marches each sightline serially; here all sightlines advance
together in one lax.scan over z with the [rays, energies] emission and
absorption carried — the same lock-step pattern as the geodesic march.
"""

from __future__ import annotations

import sys
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from raytrace_tpu.config import Config, enable_compilation_cache
from raytrace_tpu.io import TextOutput


def compute(*args, **kwargs):
    """Wrapper resolving the static z-step count before jit."""
    if kwargs.get("n_z") is None:
        r_sph = kwargs.get("r_sph", args[0] if args else 10.0)
        dz = kwargs.get("dz", 0.01)
        kwargs["n_z"] = int(2 * float(r_sph) / float(dz))
    return _compute(*args, **kwargs)


@partial(jax.jit, static_argnames=("nx", "n_en", "logbin_en", "n_z"))
def _compute(
    r_sph=10.0,
    r_min=5.0,
    r_star=5.0,
    v0=0.2,
    nx: int = 200,
    dz=0.01,
    en0=0.8,
    en_max=1.2,
    n_en: int = 400,
    logbin_en: bool = False,
    dens0=10.0,
    tau=1.5,
    line_emis=1e-6,
    n_z: int | None = None,
):
    """Returns (energy, obs_emis, obs_continuum, obs_total)."""
    dx = 2 * r_sph / nx
    x = -r_sph + jnp.arange(nx) * dx
    X, Y = jnp.meshgrid(x, x, indexing="ij")
    X = X.reshape(-1)
    Y = Y.reshape(-1)
    n_rays = nx * nx

    if logbin_en:
        den = jnp.exp(jnp.log(en_max / en0) / (n_en - 1))
    else:
        den = (en_max - en0) / (n_en - 1)
    energy_grid = en0 * den ** jnp.arange(n_en) if logbin_en else en0 + den * jnp.arange(n_en)

    rho_sq = X * X + Y * Y
    alive0 = jnp.ones((n_rays,), dtype=bool)
    emis0 = jnp.zeros((n_rays, n_en + 1))
    absorb0 = jnp.zeros((n_rays, n_en + 1))
    lanes = jnp.arange(n_rays)

    def step(carry, iz):
        emis, absorb, alive = carry
        z = r_sph - iz * dz
        r = jnp.sqrt(rho_sq + z * z)
        this_v = v0 * (0.01 + 0.99 * (1.0 - 1.0 / r))
        costh = z / r
        gamma = 1.0 / jnp.sqrt(1.0 - this_v * this_v)
        e_loc = 1.0 / (gamma * (1.0 - this_v * costh))
        if logbin_en:
            ien = jnp.floor(jnp.log(e_loc / en0) / jnp.log(den)).astype(jnp.int32)
        else:
            ien = jnp.floor((e_loc - en0) / den).astype(jnp.int32)
        dens = dens0 / (r * r * jnp.abs(this_v))

        in_shell = alive & (r < r_sph) & (r > r_min) & (ien >= 0) & (ien < n_en)
        idx = jnp.where(in_shell, ien, n_en)
        tau_here = absorb[lanes, idx]
        demis = jnp.where(
            in_shell, (1.0 / (r * r)) * dz * dens * jnp.exp(-tau_here) * e_loc**3, 0.0
        )
        emis = emis.at[lanes, idx].add(demis)
        absorb = absorb.at[lanes, idx].add(jnp.where(in_shell, dz * dens, 0.0))

        alive = alive & (r >= r_star)  # sightline stops at the stellar surface
        return (emis, absorb, alive), None

    (emis, absorb, _), _ = lax.scan(step, (emis0, absorb0, alive0), jnp.arange(n_z))
    emis = emis[:, :-1]
    absorb = absorb[:, :-1]

    obs_emis = emis.sum(axis=0)
    emis_sum = obs_emis.sum()

    # continuum: sightlines covering the stellar disc, attenuated by the
    # integrated line opacity scaled to the requested total tau
    # (pcyg.cpp:103-143; the reference scales by the central ray's total)
    centre = jnp.argmin(rho_sq)
    tau_total = absorb[centre].sum()
    on_star = rho_sq < r_star * r_star
    cont = jnp.where(on_star[:, None], jnp.exp(-(tau / tau_total) * absorb), 0.0)
    obs_continuum = cont.sum(axis=0)
    continuum_sum = obs_continuum.sum()

    obs_total = (line_emis / emis_sum) * obs_emis + obs_continuum / continuum_sum
    return energy_grid, obs_emis, obs_continuum, obs_total


def main(argv=None):
    enable_compilation_cache()
    cfg = Config(argv)
    outfile = cfg.get("outfile", str, "pcyg.dat")
    out = compute(
        r_sph=cfg.get("rsph", float, 10.0),
        r_min=cfg.get("rmin", float, 5.0),
        r_star=cfg.get("rstar", float, 5.0),
        v0=cfg.get("V", float, 0.2),
        nx=cfg.get("Nx", int, 200),
        dz=cfg.get("dz", float, 0.01),
        en0=cfg.get("en0", float, 0.8),
        en_max=cfg.get("enmax", float, 1.2),
        n_en=cfg.get("Nen", int, 400),
        logbin_en=cfg.get("logbin_en", bool, False),
        dens0=cfg.get("dens0", float, 10.0),
        tau=cfg.get("tau", float, 1.5),
        line_emis=cfg.get("line_emis", float, 1e-6),
    )
    energy, obs_emis, obs_cont, obs_total = (np.asarray(o) for o in out)
    with TextOutput(outfile) as f:
        f.write_columns(energy, obs_emis, obs_cont, obs_total)
    print(f"wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
