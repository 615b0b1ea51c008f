"""Explicit-f32 pipeline validation at reference far-field scales.

The GPU march kernel executes f32 arithmetic; the CPU suite otherwise runs f64. These
tests run the SAME explicit-f32 program on CPU and gate it against the f64
pipeline at the precision-critical configurations SURVEY §7 flags: the
canonical imageplane_disc_image distance (dist = 10^4,
/root/reference/par_example/imageplane_disc_image.par_example) and caustic
bundle Jacobians at dist = 10^3 and 10^4. On-card agreement of the same f32
path vs the reference golden is checked by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np

from raytrace_tpu.apps.caustics import SENTINEL, compute as caustic_compute
from raytrace_tpu.apps.imageplane_disc_image import compute as image_compute
from raytrace_tpu.sources import ImagePlaneGrid

SPIN = 0.998


def test_disc_image_f32_matches_f64_at_dist_1e4():
    """f32 disc image at the reference's canonical dist = 10^4: exact ray
    count parity with f64 and sub-0.1% per-pixel landing observables at
    count >= 3. Exercises the f64 start seeding, the dtype-scaled knife-edge
    regulariser, and the f32 march over 4 decades of radius."""
    grid = ImagePlaneGrid.from_steps(-30.0, 30.0, 1.5, -30.0, 30.0, 1.5)
    kw = dict(r_disc=30.0, img_nx=20, img_ny=20, method="rk45")
    o32 = image_compute(SPIN, 10000.0, 80.0, grid, dtype=jnp.float32, **kw)
    o64 = image_compute(SPIN, 10000.0, 80.0, grid, dtype=jnp.float64, **kw)

    c32, c64 = o32["counts"], o64["counts"]
    assert abs(int(c32.sum()) - int(c64.sum())) <= 0.01 * c64.sum()
    both = (c32 >= 3) & (c64 >= 3)
    assert both.sum() > 20
    for f, tol in [("r", 2e-3), ("enshift", 1e-3), ("time", 1e-4),
                   ("flux", 5e-3)]:
        rel = np.abs(o32[f][both] / o64[f][both] - 1)
        assert np.median(rel) < tol, f"{f}: median {np.median(rel):.2e}"


def test_caustic_bundles_f32_at_dist_1e4():
    """f32 bundle Jacobians at the reference's canonical far-field distance
    (dist = 10^4): at this scale the satellite splittings sit ~40 f32 ulps
    apart in the starting angles, so the measured envelope is a sharp
    median (the f64-seeded starts keep the bulk clean) with a fat chaotic
    tail — median det J dev ~2e-4, ~92% of order-matched pixels
    well-measured (sign correct and magnitude within 50%), sign agreement
    ~99.7%. This pins that envelope so an initialisation or kernel change
    that degrades the far-field f32 derivative path fails loudly."""
    grid = ImagePlaneGrid.from_steps(-12.0, 12.0, 1.0, -12.0, 12.0, 1.0)
    kw = dict(target="disc", r_disc=20.0, method="rk45", steplim=80000,
              bundle_eps_frac=0.05)
    m32 = caustic_compute(SPIN, 10000.0, 60.0, grid, dtype=jnp.float32, **kw)
    m64 = caustic_compute(SPIN, 10000.0, 60.0, grid, dtype=jnp.float64, **kw)

    h32, h64 = m32["hit"].astype(bool), m64["hit"].astype(bool)
    assert (h32 == h64).mean() > 0.98
    both = h32 & h64
    assert np.median(np.abs(m32["radius"][both] / m64["radius"][both] - 1)) < 1e-3

    d32, d64 = m32["det_j"], m64["det_j"]
    ok = (both & np.isfinite(d32) & np.isfinite(d64)
          & (d32 != SENTINEL) & (d64 != SENTINEL)
          & (m32["order"] == m64["order"]))
    assert ok.sum() > 200
    rel = np.abs(d32[ok] / d64[ok] - 1)
    sign = np.sign(d32[ok]) == np.sign(d64[ok])
    assert np.median(rel) < 0.02, f"det_j median {np.median(rel):.2e}"
    assert sign.mean() > 0.97
    assert ((rel < 0.5) & sign).mean() > 0.85


def test_caustic_bundles_f32_at_dist_1000():
    """f32 bundle Jacobians at dist = 10^3: the satellites' starting thetas
    differ by ~eps/D ~ 10 f32 ulps, so the f32 envelope needs a larger
    eps_frac than f64's default (documented in image_plane_bundles). With
    eps_frac = 0.05 the f32 det J tracks f64 to a few percent and the
    caustic sign structure is preserved."""
    grid = ImagePlaneGrid.from_steps(-12.0, 12.0, 0.4, -12.0, 12.0, 0.4)
    kw = dict(target="disc", r_disc=20.0, method="rk45", steplim=60000,
              bundle_eps_frac=0.05)
    m32 = caustic_compute(SPIN, 1000.0, 60.0, grid, dtype=jnp.float32, **kw)
    m64 = caustic_compute(SPIN, 1000.0, 60.0, grid, dtype=jnp.float64, **kw)

    h32 = m32["hit"].astype(bool)
    h64 = m64["hit"].astype(bool)
    assert (h32 == h64).mean() > 0.98
    both = h32 & h64

    rel_r = np.abs(m32["radius"][both] / m64["radius"][both] - 1)
    assert np.median(rel_r) < 1e-3

    d32, d64 = m32["det_j"], m64["det_j"]
    ok = (both & np.isfinite(d32) & np.isfinite(d64)
          & (d32 != SENTINEL) & (d64 != SENTINEL)
          & (m32["order"] == m64["order"]))
    assert ok.sum() > 1000
    rel = np.abs(d32[ok] / d64[ok] - 1)
    assert np.median(rel) < 0.05, f"det_j median {np.median(rel):.3f}"
    assert (np.sign(d32[ok]) == np.sign(d64[ok])).mean() > 0.97


def test_emissivity_f32_bins_match_f64():
    """f32 lamppost emissivity bins vs f64, count-gated with the
    reference's statistical methodology (emissivity_rk45_test.cpp:57-63):
    the GPU's production f32 arithmetic must land the same rays in the
    same well-populated radial bins with sub-percent binned observables.
    Complements chip_smoke.py (same comparison vs the
    reference binary, on hardware) with a hermetic CPU version."""
    import jax

    from raytrace_tpu.apps.emissivity import disc_hit_mask
    from raytrace_tpu.ops import trace
    from raytrace_tpu.ops.redshift import apply_redshift, range_phi, redshift_start
    from raytrace_tpu.ops.reductions import bin_edges, radial_bin_profile
    from raytrace_tpu.sources import PointSourceGrid, point_source

    grid = PointSourceGrid.from_steps(0.05, 0.05)
    rays64 = point_source((0.0, 5.0, 1e-3, 0.0), V=0.0, spin=SPIN, grid=grid)
    rays32 = jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a,
        rays64,
    )

    r_min, r_disc, n_r = 1.25, 500.0, 50
    _, _, dr = bin_edges(r_min, r_disc, n_r, True)

    def bins(rays, dtype):
        s = jnp.asarray(SPIN, dtype)
        rays = redshift_start(rays, s, V=0.0)
        out = trace(rays, s, method="rk45", r_max=1000.0, steplim=40000)
        out = range_phi(out)
        out = apply_redshift(out, s, V=-1.0)
        mask = disc_hit_mask(out, s)
        g = jnp.where(mask, out.redshift, 1.0)
        counts, sums = radial_bin_profile(
            out.r, mask, {"emis": 1.0 / g**2, "g": g}, r_min, float(dr),
            n_r, True,
        )
        return np.asarray(counts), {k: np.asarray(v) for k, v in sums.items()}

    c32, s32 = bins(rays32, jnp.float32)
    c64, s64 = bins(rays64, jnp.float64)

    assert abs(c32.sum() - c64.sum()) <= 0.005 * c64.sum()
    gate = (c32 >= 100) & (c64 >= 100) & (np.abs(c32 - c64) <= 0.1 * c64)
    assert gate.sum() >= 12
    emis32 = s32["emis"][gate] / c32[gate]
    emis64 = s64["emis"][gate] / c64[gate]
    assert np.abs(emis32 / emis64 - 1).max() < 0.10
    g32 = s32["g"][gate] / c32[gate]
    g64 = s64["g"][gate] / c64[gate]
    assert np.abs(g32 / g64 - 1).max() < 0.005


def test_f32_gradients_finite_and_track_f64():
    """The differentiable march in f32 (what a device-resident fitting loop
    would run): gradients must stay finite and track the f64 values to the
    f32 ensemble noise level for the smooth emissivity observable."""
    import jax

    from raytrace_tpu.ops.diff import emissivity_gradient_pipeline
    from raytrace_tpu.sources import PointSourceGrid

    grid = PointSourceGrid.from_steps(0.3, 0.3, -0.9, 0.9, -3.0, 3.0)
    f = lambda s, h, g: emissivity_gradient_pipeline(
        s, h, g, grid, n_steps=1024, r0=4.0, r_max=50.0
    )
    v64, g64 = jax.value_and_grad(f, argnums=(0, 1, 2))(0.9, 5.0, 2.0)
    v32, g32 = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.float32(0.9), jnp.float32(5.0), jnp.float32(2.0)
    )
    assert np.isfinite(float(v32))
    np.testing.assert_allclose(float(v32), float(v64), rtol=0.02)
    for a, b in zip(g32, g64):
        assert np.isfinite(float(a))
        # chaotic-ensemble f32 gradients carry percent-level noise; sign
        # and magnitude must hold
        assert np.sign(float(a)) == np.sign(float(b))
        np.testing.assert_allclose(float(a), float(b), rtol=0.15)
