"""End-to-end emissivity regression against a stored reference golden run.

The golden file is the output of the reference binary (emissivity.cpp,
compiled from /root/reference) for: spin 0.998, lamppost at r = 5,
theta = 1e-3, V = 0, dcosalpha = dbeta = 0.05, Nr = 100 log bins,
r_max = 1000, r_disc = 500, gamma = 2 — the par_example configuration at a
test-sized grid density.

Comparison methodology is the reference's own (emissivity_rk45_test.cpp:
57-63): judge only bins with >= 100 rays in both runs and ray counts within
10%; thresholds emissivity +-10%, redshift +-0.5%, time +-5%.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from raytrace_tpu.apps.emissivity import compute
from raytrace_tpu.sources import PointSourceGrid

GOLDEN = "tests/golden/emissivity_a0.998_h5_g0.05.dat"
SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 1.5707)


@pytest.fixture(scope="module")
def golden():
    ref = np.loadtxt(GOLDEN)
    return dict(
        zip(["r", "area", "rays", "flux", "emis", "redshift", "time"], ref.T)
    )


@pytest.fixture(scope="module")
def grid():
    return PointSourceGrid.from_steps(0.05, 0.05, -0.995, 0.995, -np.pi, np.pi)


@pytest.fixture(scope="module")
def mine(grid):
    return compute(SPIN, SOURCE, V=0.0, grid=grid, r_max=1000.0, r_disc=500.0,
                   n_r=100, logbin_r=True, gamma=2.0, steplim=20000)


def _gated_bins(golden, mine):
    n_ref = golden["rays"]
    n_mine = mine["rays"]
    good = (n_ref >= 100) & (n_mine >= 100)
    with np.errstate(divide="ignore", invalid="ignore"):
        return good & (np.abs(n_mine - n_ref) / np.where(n_ref == 0, 1, n_ref) < 0.10)


def test_bin_geometry_matches(golden, mine):
    np.testing.assert_allclose(mine["r"], golden["r"], rtol=1e-6)
    np.testing.assert_allclose(mine["area"], golden["area"], rtol=1e-6)


def test_enough_wellpopulated_bins(golden, mine):
    ok = _gated_bins(golden, mine)
    assert ok.sum() >= 12  # the reference test judged 12 bins


def test_emissivity_profile_allclose(golden, mine):
    ok = _gated_bins(golden, mine)
    rel = np.abs(mine["emis"][ok] / golden["emis"][ok] - 1)
    assert rel.max() < 0.10, f"emissivity max dev {rel.max():.3f}"
    rel = np.abs(mine["flux"][ok] / golden["flux"][ok] - 1)
    assert rel.max() < 0.10, f"flux max dev {rel.max():.3f}"


def test_redshift_and_time_allclose(golden, mine):
    ok = _gated_bins(golden, mine)
    rel_g = np.abs(mine["redshift"][ok] / golden["redshift"][ok] - 1)
    assert rel_g.max() < 0.005, f"redshift max dev {rel_g.max():.4f}"
    rel_t = np.abs(mine["time"][ok] / golden["time"][ok] - 1)
    assert rel_t.max() < 0.05, f"time max dev {rel_t.max():.4f}"


def test_f32_binned_consistency(golden, grid, mine):
    """The GPU hot path computes in f32; binned observables must agree with
    the f64 run at the same statistical level the two reference integrators
    agree with each other."""
    import raytrace_tpu.sources.pointsource as ps
    from raytrace_tpu.ops import trace_compacted

    def trace_f32(rays, spin, **kw):
        rays32 = jax.tree.map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, rays
        )
        out = trace_compacted(rays32, jnp.asarray(spin, jnp.float32), **kw)
        return jax.tree.map(
            lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a, out
        )

    out32 = compute(SPIN, SOURCE, V=0.0, grid=grid, r_max=1000.0, r_disc=500.0,
                    n_r=100, logbin_r=True, gamma=2.0, steplim=20000,
                    trace_fn=trace_f32)
    n64, n32 = mine["rays"], out32["rays"]
    ok = (n64 >= 100) & (n32 >= 100)
    with np.errstate(divide="ignore", invalid="ignore"):
        ok &= np.abs(n32 - n64) / np.where(n64 == 0, 1, n64) < 0.10
    assert ok.sum() >= 12
    rel = np.abs(out32["emis"][ok] / mine["emis"][ok] - 1)
    assert rel.max() < 0.10, f"f32 emissivity max dev {rel.max():.3f}"
    rel_g = np.abs(out32["redshift"][ok] / mine["redshift"][ok] - 1)
    assert rel_g.max() < 0.005


def test_app_cli(tmp_path):
    """Drive the CLI surface end-to-end with a small grid."""
    from raytrace_tpu.apps.emissivity import main

    par = tmp_path / "emis.par"
    par.write_text(
        f"""
outfile = {tmp_path}/out.dat
source = 0 5 1E-3 1.5707
V = 0
spin = 0.998
dcosalpha = 0.2
dbeta = 0.2
Nr = 20
logbin_r = 1
steplim = 4000
"""
    )
    assert main([f"--parfile={par}"]) == 0
    out = np.loadtxt(tmp_path / "out.dat")
    assert out.shape == (20, 7)
    assert (out[:, 2] >= 0).all()
    assert np.nansum(out[:, 4]) > 0


GOLDEN_RD = "tests/golden/emissivity_rd_a0.998_h5_g0.05.dat"


def test_rd_variant_matches_reference_binary():
    """The destination-API route (FlatDisc + RK4 + 4-velocity redshift,
    emissivity_rd.cpp:99-116) against the reference emissivity_rd binary,
    same count-gated methodology."""
    ref = np.loadtxt(GOLDEN_RD)
    g = dict(zip(["r", "area", "rays", "flux", "emis", "redshift", "time"], ref.T))
    grd = PointSourceGrid.from_steps(0.05, 0.05, -0.995, 0.995, -np.pi, np.pi)
    mine = compute(SPIN, SOURCE, V=0.0, grid=grd, r_max=1000.0, r_disc=500.0,
                   n_r=100, logbin_r=True, gamma=2.0, steplim=20000,
                   method="rk4", variant="rd")
    gated = (
        (g["rays"] >= 100) & (mine["rays"] >= 100)
        & (np.abs(mine["rays"] - g["rays"]) < 0.10 * np.maximum(g["rays"], 1))
    )
    assert gated.sum() >= 10
    for fld, tol in (("emis", 0.10), ("redshift", 0.005), ("time", 0.05)):
        dev = np.abs(mine[fld][gated] / g[fld][gated] - 1.0)
        assert dev.max() < tol, f"{fld}: max dev {dev.max():.4f}"


GOLDEN_MIDSPIN = "tests/golden/emissivity_a0.5_h3_g0.05.dat"


def test_midspin_low_source_matches_reference_binary():
    """Second point in parameter space: spin 0.5 (ISCO at 4.233) with the
    lamppost BELOW the ISCO at h = 3 — most rays are captured, the disc
    illumination comes from strongly bent escapers, and the plunge-region
    area integral and mid-spin metric terms are all off the a=0.998 path
    the other goldens exercise. Same reference binary, same count-gated
    methodology."""
    ref = np.loadtxt(GOLDEN_MIDSPIN)
    g = dict(zip(["r", "area", "rays", "flux", "emis", "redshift", "time"], ref.T))
    grd = PointSourceGrid.from_steps(0.05, 0.05, -0.995, 0.995, -np.pi, np.pi)
    mine = compute(0.5, (0.0, 3.0, 1e-3, 1.5707), V=0.0, grid=grd,
                   r_max=1000.0, r_disc=500.0, n_r=100, logbin_r=True,
                   gamma=2.0, steplim=20000, method="rk45")
    np.testing.assert_allclose(mine["r"], g["r"], rtol=1e-6)
    # The reference's integrate_disc_area marches sub-annuli with an
    # iterated product (`for(r=rmin; r<rmax; r*=dr)`, disc.h:133); at
    # fp-unlucky spins the accumulated rounding lets a 50th sub-annulus
    # through, overestimating every bin area by ~1/49 (~2%) — it does at
    # a=0.5, not at the 0.9/0.998 goldens (probe: areatest vs
    # integrate_disc_area_bins, 2026-08-21). Normalised here (SURVEY §7),
    # so area parity at this spin is the systematic 2%:
    rel_area = np.abs(mine["area"] / g["area"] - 1.0)
    assert rel_area.max() < 0.025
    assert rel_area.min() > 0.015  # the quirk is systematic, not noise
    gated = (
        (g["rays"] >= 100) & (mine["rays"] >= 100)
        & (np.abs(mine["rays"] - g["rays"]) < 0.10 * np.maximum(g["rays"], 1))
    )
    assert gated.sum() >= 6
    for fld, tol in (("emis", 0.10), ("redshift", 0.005), ("time", 0.05)):
        dev = np.abs(mine[fld][gated] / g[fld][gated] - 1.0)
        assert dev.max() < tol, f"{fld}: max dev {dev.max():.4f}"
