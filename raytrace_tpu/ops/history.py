"""Trajectory recording: the per-step ray-path dump capability.

The reference writes trajectories from inside its propagators (serial
per-ray file writes every write_step steps within a radius window,
raytracer.cpp:293-312). The batched equivalent records snapshots of the
whole batch into a preallocated device array — one [n_snapshots, 4, N]
tensor, written every ``write_step`` lock-step iterations — and applies the
radius-window / stop-after-leaving-window filters as host post-processing.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from raytrace_tpu.destinations import Destination, ThetaLimit
from raytrace_tpu.geometry.kerr import bl_to_cartesian, horizon_radius
from raytrace_tpu.ops.integrate import (
    StepControl,
    _euler_rk4_body,
    _rk45_body,
    _seed_rk45_step,
)
from raytrace_tpu.rays import RayBatch


@partial(
    jax.jit,
    static_argnames=("method", "write_step", "n_snapshots", "ctrl"),
)
def trace_with_history(
    rays: RayBatch,
    spin,
    *,
    method: str = "euler",
    dest: Destination = None,
    r_max=100.0,
    write_step: int = 10,
    n_snapshots: int = 512,
    ctrl: StepControl = StepControl(),
    boundary=None,
):
    """March the batch recording (t, r, theta, phi, active) snapshots.

    Runs n_snapshots * write_step lock-step iterations (the snapshot cadence
    is per lock-step iteration, which equals the per-ray step count for
    continuously-active rays). Returns (final_rays, history) where history
    has shape [n_snapshots, 5, N]: the 4 coordinates plus an
    active-at-snapshot flag.
    """
    if dest is None:
        dest = ThetaLimit(jnp.pi / 2)
    horizon = horizon_radius(spin) if boundary is None else boundary
    steplim = n_snapshots * write_step + 1

    rays = rays.replace(
        r_was_positive=jnp.zeros_like(rays.r_was_positive),
        theta_was_positive=jnp.ones_like(rays.theta_was_positive),
    )
    if method == "rk45":
        rays = rays.replace(dt=_seed_rk45_step(rays, spin, horizon, ctrl))

    def one_step(carry, _):
        if method == "rk45":
            st, step, rates = carry
            st, step, rates = _rk45_body(
                st, spin, horizon, dest, r_max, steplim, ctrl, st.active,
                step, rates,
            )
            return (st, step, rates), None
        st, step = carry
        st, _unused = _euler_rk4_body(
            st, spin, horizon, dest, r_max, steplim, ctrl, method, st.active
        )
        return (st, step), None

    def chunk(carry, _):
        carry, _ = lax.scan(one_step, carry, None, length=write_step)
        st = carry[0]
        snap = jnp.stack(
            [st.t, st.r, st.theta, st.phi, st.active.astype(st.r.dtype)]
        )
        return carry, snap

    if method == "rk45":
        from raytrace_tpu.ops.integrate import _seed_rk45_rates

        init = (rays, rays.dt, _seed_rk45_rates(rays, rays.active, spin))
    else:
        init = (rays, rays.dt)
    carry_f, history = lax.scan(chunk, init, None, length=n_snapshots)
    final, step_f = carry_f[0], carry_f[1]
    return final.replace(dt=step_f), history


def dump_trajectories(
    filename: str,
    rays_in: RayBatch,
    history,
    spin,
    write_rmax=-1.0,
    write_rmin=-1.0,
    cartesian: bool = True,
    precision: int = 6,
    width: int = 15,
):
    """Write the recorded trajectories in the reference text format:
    one ``t x y z`` (or ``t r theta phi``) row per snapshot, rays separated
    by two blank lines, restricted to the radius window with recording
    stopping once a ray leaves it after having entered
    (raytracer.cpp:293-312 semantics)."""
    hist = np.asarray(history)  # [S, 5, N]
    n = hist.shape[2]
    live = np.asarray(rays_in.steps) >= 0
    with open(filename, "w") as f:
        for ray in range(n):
            if not live[ray]:
                continue
            t, r, theta, phi, active = hist[:, 0, ray], hist[:, 1, ray], hist[:, 2, ray], hist[:, 3, ray], hist[:, 4, ray]
            started = False
            for s in range(hist.shape[0]):
                if active[s] == 0 and s > 0 and active[s - 1] == 0:
                    break  # ray finished; no more snapshots
                in_window = (write_rmax < 0 or r[s] < write_rmax) and (
                    write_rmin < 0 or r[s] > write_rmin
                )
                if in_window:
                    started = True
                    if cartesian:
                        x, y, z = (
                            float(v)
                            for v in bl_to_cartesian(r[s], theta[s], phi[s], spin)
                        )
                        row = (t[s], x, y, z)
                    else:
                        row = (t[s], r[s], theta[s], phi[s])
                    f.write(
                        " ".join(f"{float(v):>{width}.{precision}e}" for v in row)
                        + "\n"
                    )
                elif started:
                    break
            f.write("\n\n")
