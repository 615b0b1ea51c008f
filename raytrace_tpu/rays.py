"""Struct-of-arrays ray batch — the device-side ray state.

The reference stores rays as an array-of-structs ``Ray<T>* rays``
(src/raytracer/raytracer.h:65-78). On the device the struct-of-arrays layout is the
right one (it is also the layout the reference's GPU ancestor used): each
field is a flat [N] array living in a pytree, so every propagation step is
pure vectorised elementwise work over the ray axis, shardable over a device
mesh with no further ado.
"""

from __future__ import annotations

import jax.numpy as jnp

from raytrace_tpu import pytree

# Ray status bit flags (raytracer.h:57-63). Combinable with bitwise OR.
RAY_STATUS_DEST = 1 << 0  # reached destination surface / polar-angle limit
RAY_STATUS_HORIZON = 1 << 1  # fell through the event horizon
RAY_STATUS_RLIM = 1 << 2  # reached the outer radial limit
RAY_STATUS_STEPLIM = 1 << 3  # exceeded the maximum step count (stuck)
RAY_STATUS_ERGO = 1 << 4  # p^t <= 0 inside the ergosphere (non-physical)
RAY_STATUS_NEG_ENERGY = 1 << 5  # negative Killing energy (non-physical)
# Numerically dead: the rate evaluation at the ray's position over/underflowed
# the working dtype (e.g. an f32 knife-edge ray driven onto the polar axis,
# where h^2/sin^2 theta overflows). No reference counterpart (its f64 noise
# floor never reaches these states); terminal, excluded like STEPLIM.
RAY_STATUS_NUMERIC = 1 << 6


@pytree.dataclass
class RayBatch:
    """Batched ray state: every field is a [N] array (or scalar broadcastable).

    Mirrors the per-ray state of the reference ``Ray<T>`` struct
    (raytracer.h:65-78) plus the in-flight sign-gate booleans that the
    reference keeps as propagator locals (raytracer.cpp:137-138) — they must
    live in the carry here because the batched integrator is re-entrant.

    ``steps`` keeps the reference's conventions: -1 marks a dead/padding ray
    that must never be traced (pointsource.cpp:42), and rays that hit the
    step limit have their (positive) count negated so downstream
    ``steps > 0`` filters drop them (raytracer.cpp:336-337).
    """

    # position
    t: jnp.ndarray
    r: jnp.ndarray
    theta: jnp.ndarray
    phi: jnp.ndarray
    # contravariant momentum (last evaluated; re-derived from constants each step)
    pt: jnp.ndarray
    pr: jnp.ndarray
    ptheta: jnp.ndarray
    pphi: jnp.ndarray
    # constants of motion
    k: jnp.ndarray
    h: jnp.ndarray
    Q: jnp.ndarray
    # signed square-root bookkeeping (+-1, stored in the float dtype)
    rdot_sign: jnp.ndarray
    thetadot_sign: jnp.ndarray
    # sign-flip gates: a flip is only allowed after the squared rate has been
    # positive (raytracer.cpp:137-138,196-220)
    r_was_positive: jnp.ndarray  # bool
    theta_was_positive: jnp.ndarray  # bool
    # adaptive integrator step size (DOPRI5 controller state); carried on the
    # ray so that tracing can be suspended and resumed (phase compaction)
    dt: jnp.ndarray
    # diagnostics
    steps: jnp.ndarray  # int32
    status: jnp.ndarray  # int32 bitmask
    rdot_flips: jnp.ndarray  # int32: number of radial turning points
    equatorial_crossings: jnp.ndarray  # int32: theta crossings of pi/2
    # energies for redshift
    emit: jnp.ndarray
    redshift: jnp.ndarray
    # source-grid coordinates (cos(alpha)/beta for point sources, x/y for
    # image planes)
    alpha: jnp.ndarray
    beta: jnp.ndarray

    @property
    def n_rays(self) -> int:
        return self.r.shape[-1]

    @property
    def active(self) -> jnp.ndarray:
        """Rays eligible for (further) propagation: steps >= 0 and no
        terminal status bit set."""
        terminal = (
            RAY_STATUS_DEST
            | RAY_STATUS_HORIZON
            | RAY_STATUS_RLIM
            | RAY_STATUS_STEPLIM
            | RAY_STATUS_NUMERIC
        )
        return (self.steps >= 0) & ((self.status & terminal) == 0)

    @property
    def ok(self) -> jnp.ndarray:
        """Rays that completed normally (the reference's ``steps > 0`` filter)."""
        return self.steps > 0

    def cartesian(self, a):
        from raytrace_tpu.geometry.kerr import bl_to_cartesian

        return bl_to_cartesian(self.r, self.theta, self.phi, a)


def blank_batch(n: int, dtype=jnp.float64) -> RayBatch:
    """An all-dead batch of n rays (steps = -1), to be filled by a source."""
    zeros = jnp.zeros((n,), dtype=dtype)
    izeros = jnp.zeros((n,), dtype=jnp.int32)
    ones = jnp.ones((n,), dtype=dtype)
    return RayBatch(
        t=zeros,
        r=zeros,
        theta=zeros,
        phi=zeros,
        pt=zeros,
        pr=zeros,
        ptheta=zeros,
        pphi=zeros,
        k=zeros,
        h=zeros,
        Q=zeros,
        rdot_sign=ones,
        thetadot_sign=ones,
        r_was_positive=jnp.zeros((n,), dtype=bool),
        theta_was_positive=jnp.ones((n,), dtype=bool),
        dt=zeros,
        steps=izeros - 1,
        status=izeros,
        rdot_flips=izeros,
        equatorial_crossings=izeros,
        emit=ones,
        redshift=ones,
        alpha=zeros,
        beta=zeros,
    )
