"""Pallas GPU march kernel equivalence (interpreter mode on CPU).

The Triton-compiled kernel runs on the GPU in chip_smoke.py and in the
``gpu``-marked test below; here the kernel's *logic* is pinned against the
XLA integrator in Pallas interpreter mode, f32 on both sides, where results
must agree except for f32 constant-rounding noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytrace_tpu.ops.pallas_kernel as pk
from raytrace_tpu.destinations import DiscWithISCO
from raytrace_tpu.geometry import isco_radius
from raytrace_tpu.ops import trace
from raytrace_tpu.sources import PointSourceGrid, point_source

SPIN = 0.998


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    real_call = pk.pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    monkeypatch.setattr(pk.pl, "pallas_call", interp)


def _f32(rays):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, rays
    )


def test_pallas_matches_xla_f32():
    grid = PointSourceGrid.from_steps(0.3, 0.5, -0.9, 0.9, -3.0, 3.0)
    rays = _f32(point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=grid))
    s = jnp.float32(SPIN)
    a = pk.trace_pallas(rays, s, method="rk4", r_max=300.0, steplim=3000)
    b = trace(rays, s, method="rk4", r_max=300.0, steplim=3000)
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))
    same = np.asarray(a.status) == np.asarray(b.status)
    dr = np.abs(np.asarray(a.r) - np.asarray(b.r))[same]
    assert np.median(dr) < 1e-4
    np.testing.assert_array_equal(np.asarray(a.steps), np.asarray(b.steps))


def test_pallas_isco_destination():
    a_spin = 0.5
    grid = PointSourceGrid.from_steps(0.45, 0.8, -0.9, 0.9, -3.0, 3.0)
    rays = _f32(point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=a_spin, grid=grid))
    s = jnp.float32(a_spin)
    dest = DiscWithISCO(
        r_isco=jnp.float32(isco_radius(a_spin)), r_out=jnp.float32(30.0)
    )
    a = pk.trace_pallas(rays, s, method="rk4", dest=dest, r_max=300.0, steplim=3000)
    b = trace(rays, s, method="rk4", dest=dest, r_max=300.0, steplim=3000)
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))


def test_pallas_pads_odd_batches():
    grid = PointSourceGrid.from_steps(0.6, 1.2, -0.9, 0.9, -3.0, 3.0)
    rays = _f32(point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=grid))
    assert rays.n_rays % pk.BLOCK != 0
    out = pk.trace_pallas(rays, jnp.float32(SPIN), method="rk4", r_max=300.0, steplim=2000)
    assert out.n_rays == rays.n_rays


def test_pallas_fused_matches_single_phase():
    """The one-dispatch fused schedule must be observationally identical to
    the single full-width march (same termination statuses and step counts;
    positions equal on the common path)."""
    grid = PointSourceGrid.from_steps(0.3, 0.5, -0.9, 0.9, -3.0, 3.0)
    rays = _f32(point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=grid))
    s = jnp.float32(SPIN)
    kw = dict(method="rk4", r_max=300.0, steplim=3000)
    a = pk.trace_pallas_fused(
        rays, s, schedule=((64, None, 128, 2), (128, 2048, 64, 2), (5000, 1024, 32, 4)), **kw
    )
    b = pk.trace_pallas(rays, s, **kw)
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))
    np.testing.assert_array_equal(np.asarray(a.steps), np.asarray(b.steps))
    np.testing.assert_allclose(np.asarray(a.r), np.asarray(b.r), rtol=1e-5, atol=1e-5)


def test_pallas_fused_overflow_drains():
    """A schedule whose widths cannot hold the survivors must still finish
    every ray (the trailing full-width drain phase), not strand them."""
    grid = PointSourceGrid.from_steps(0.3, 0.5, -0.9, 0.9, -3.0, 3.0)
    rays = _f32(point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=grid))
    s = jnp.float32(SPIN)
    kw = dict(method="rk4", r_max=300.0, steplim=3000)
    # after 8 iterations every ray is still active; width 1024 < n overflows
    a = pk.trace_pallas_fused(rays, s, schedule=((8, None, 128, 2), (16, 1024, 32, 2)), **kw)
    b = pk.trace_pallas(rays, s, **kw)
    assert not np.asarray(a.active).any()
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))
    np.testing.assert_array_equal(np.asarray(a.steps), np.asarray(b.steps))


def test_pallas_fused_compacted_first_phase_rk45():
    """A user schedule whose FIRST phase is width-compacted must still reset
    the propagation gates and seed the adaptive dt (regression: the fused
    driver used to skip both when the opening phase was narrower than n)."""
    grid = PointSourceGrid.from_steps(0.3, 0.5, -0.9, 0.9, -3.0, 3.0)
    rays = _f32(point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=grid))
    n_pad = -(-rays.n_rays // 1024) * 1024
    s = jnp.float32(SPIN)
    kw = dict(method="rk45", r_max=300.0, steplim=3000)
    a = pk.trace_pallas_fused(rays, s, schedule=((5000, n_pad, 32, 2),), **kw)
    b = pk.trace_pallas(rays, s, **kw)
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))
    np.testing.assert_array_equal(np.asarray(a.steps), np.asarray(b.steps))


def test_pallas_flatplane_destination():
    """FlatPlane (caustic_plane's surface, ray_destination.h:172-204) on the
    kernel path must match the XLA integrator."""
    from raytrace_tpu.destinations import FlatPlane

    grid = PointSourceGrid.from_steps(0.45, 0.8, -0.9, 0.9, -3.0, 3.0)
    rays = _f32(point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=grid))
    s = jnp.float32(SPIN)
    dest = FlatPlane(
        incl=jnp.float32(1.0), phi0=jnp.float32(0.0), z_s=jnp.float32(50.0)
    )
    a = pk.trace_pallas(rays, s, method="rk4", dest=dest, r_max=300.0, steplim=3000)
    b = trace(rays, s, method="rk4", dest=dest, r_max=300.0, steplim=3000)
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))
    np.testing.assert_array_equal(np.asarray(a.steps), np.asarray(b.steps))
    same = np.asarray(a.status) == np.asarray(b.status)
    assert np.median(np.abs(np.asarray(a.r) - np.asarray(b.r))[same]) < 1e-3


def test_pallas_shell_and_boundary():
    """SphericalShell destination and the inner-boundary override (a
    neutron-star surface, raytracer.h:152-162) on the kernel path."""
    from raytrace_tpu.destinations import SphericalShell

    grid = PointSourceGrid.from_steps(0.45, 0.8, -0.9, 0.9, -3.0, 3.0)
    rays = _f32(point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=0.3, grid=grid))
    s = jnp.float32(0.3)
    dest = SphericalShell(r_shell=jnp.float32(40.0))
    kw = dict(method="rk45", dest=dest, r_max=300.0, steplim=3000,
              boundary=jnp.float32(2.5))
    a = pk.trace_pallas(rays, s, **kw)
    b = trace(rays, s, **kw)
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))
    np.testing.assert_array_equal(np.asarray(a.steps), np.asarray(b.steps))

    # boundary capture: rk4's MIN_STEP floor crosses the raised boundary in
    # finite steps (rk45's boundary step-cap makes rays creep, same as the
    # reference's RK45 at the horizon); captured rays stop at r ~ 2.5,
    # outside the a=0.3 event horizon (1.954)
    from raytrace_tpu.rays import RAY_STATUS_HORIZON

    kw4 = dict(method="rk4", dest=dest, r_max=300.0, steplim=3000,
               boundary=jnp.float32(2.5))
    a4 = pk.trace_pallas(rays, s, **kw4)
    b4 = trace(rays, s, **kw4)
    np.testing.assert_array_equal(np.asarray(a4.status), np.asarray(b4.status))
    cap = (np.asarray(a4.status) & RAY_STATUS_HORIZON) != 0
    assert cap.any()
    # f32 capture shell is 200 ulp-floored (integrate.py::_commit)
    assert (np.asarray(a4.r)[cap] <= 2.5 * (1 + 1e-4)).all()
    assert (np.asarray(a4.r)[cap] > 2.2).all()


@pytest.mark.parametrize("block", [64, 128, 256])
def test_pallas_block_padding(block):
    """Every power-of-two block pads the batch with dead rays to whole
    programs and returns the caller's n rays, identical to the default
    launch shape (one ray per thread: the block only groups rays)."""
    grid = PointSourceGrid.from_steps(0.45, 0.8, -0.9, 0.9, -3.0, 3.0)
    rays = _f32(point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=grid))
    assert rays.n_rays % block != 0
    s = jnp.float32(SPIN)
    kw = dict(method="rk4", r_max=300.0, steplim=2000)
    a = pk.trace_pallas(rays, s, block=block, unroll=1, **kw)
    b = pk.trace_pallas(rays, s, **kw)
    assert a.n_rays == rays.n_rays
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))
    np.testing.assert_array_equal(np.asarray(a.steps), np.asarray(b.steps))
    np.testing.assert_array_equal(np.asarray(a.r), np.asarray(b.r))


def test_pallas_f32_boundary_cast():
    """The kernel marches in f32 whatever the caller's dtype, and hands the
    results back in that dtype: f64 rays in, f64 rays out, equal to the
    f32 march of the same rays."""
    grid = PointSourceGrid.from_steps(0.45, 0.8, -0.9, 0.9, -3.0, 3.0)
    rays64 = point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=grid)
    # rk4: nothing is seeded in the caller's dtype before the cast (rk45
    # seeds its adaptive step first), so the two marches start identical
    kw = dict(method="rk4", r_max=300.0, steplim=3000)
    a = pk.trace_pallas_fused(rays64, jnp.float64(SPIN), **kw)
    b = pk.trace_pallas_fused(_f32(rays64), jnp.float32(SPIN), **kw)
    for name in ("t", "r", "theta", "phi", "pr", "emit"):
        assert getattr(a, name).dtype == jnp.float64, name
    assert a.steps.dtype == jnp.int32 and a.r_was_positive.dtype == bool
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))
    np.testing.assert_array_equal(np.asarray(a.steps), np.asarray(b.steps))
    np.testing.assert_allclose(np.asarray(a.r), np.asarray(b.r), rtol=1e-6)


def test_default_schedule_uses_kernel_launch_shape(monkeypatch):
    """The fused driver's schedule runs every phase, and the drain, with the
    kernel's own block and unroll, so one compiled kernel serves it all."""
    seen = []
    real = pk._trace_pallas_padded

    def spy(*args, **kw):
        seen.append((kw["block"], kw["unroll"]))
        return real(*args, **kw)

    monkeypatch.setattr(pk, "_trace_pallas_padded", spy)
    grid = PointSourceGrid.from_steps(0.3, 0.5, -0.9, 0.9, -3.0, 3.0)
    rays = _f32(point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=grid))
    pk.trace_pallas_fused(rays, jnp.float32(SPIN), method="rk4", r_max=300.0,
                          steplim=3000, schedule=None)
    assert seen and set(seen) == {(pk.BLOCK, pk.UNROLL)}
    sched = pk.auto_schedule(125_800, 37_516, block=pk.BLOCK, unroll=pk.UNROLL)
    assert len(sched) == 2 and sched[1][1] % pk.BLOCK == 0 and sched[1][1] < 125_800
