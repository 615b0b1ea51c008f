"""Smoke test on the GPU: the main path at full width, checked.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the sharded apps vs card 0

One process drives the card (a second JAX process would find its memory
taken). The app mains are called in-process with argv, as a user's CLI call
would run them. Phases on one card:

  device      fail unless JAX's first device is a GPU; print its kind, the
              device count, the JAX version and nvidia-smi's name and power
              limit
  compile     compile the march kernel at the canonical width for every
              method and destination kind; print compile seconds and
              memory_analysis()
  engine      the kernel route (trace_pallas_fused) against the plain XLA
              route (trace_compacted), both f32, RK4 and RK45, at 125,800
              and 2.51M rays: statuses agree on >= 99.5% of live rays,
              median |dr|/r < 1e-4 on rays of equal status, no stuck rays;
              both times printed
  validation  the production pipelines through trace_auto against the
              reference goldens (tests/golden), count-gated as the
              reference's own tests are: emissivity, the far-field image,
              the three caustic targets, the rt-emissivity CLI
  full_width  rt-emissivity on par_example/emissivity.par (2.51M rays,
              RK45) and rt-disc-image on par_example/imageplane_disc_image.par
              (1001 x 1001 rays at d = 1e4, RK45); finite outputs; the
              emissivity profile against the golden's cumulative rays per
              primary ray, and count-gated against the plain f64 XLA route
              at the same width

Any failed phase makes the exit status nonzero. The last line of stdout is
one JSON object: {"ok": ..., "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import traceback
from functools import partial
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

import raytrace_tpu  # noqa: F401  (enables x64; fails outside a checkout)
from raytrace_tpu.config import enable_compilation_cache

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
SPIN = 0.998
LAMPPOST = (0.0, 5.0, 1e-3, 0.0)

# canonical lamppost (bench.py) and production emissivity grids
# (par_example/emissivity.par): (dcosalpha, dbeta)
SIZES = {"125800": (0.01, 0.01), "2.51M": (0.005, 0.001)}

# engine agreement gates (statistical: chaotic photon-sphere rays may flip
# status on last-bit differences between libdevice and XLA's math)
STATUS_AGREE = 0.995
MEDIAN_REL_DR = 1e-4

# reference-golden gates (emissivity_rk45_test.cpp:57-63 methodology)
EMIS_GOLDEN = GOLDEN / "emissivity_a0.998_h5_g0.05.dat"
EMIS_COLUMNS = ["r", "area", "rays", "flux", "emis", "redshift", "time"]
THRESHOLDS = {"emis": 0.10, "redshift": 0.005, "time": 0.05}
# the full-width profile against the golden's cumulative count, in golden
# cos(alpha) rows: one row of sampling quantum plus half a row for the f32
# march and the two grids' fenceposts (0.85 rows measured on the CPU f64
# path with the par file's cos(alpha) rows)
GOLDEN_ROWS_TOL = 1.5

IMAGE_GOLDEN = GOLDEN / "disc_image_d10000_a0.998_i80_rk45.bin"
IMAGE_N = 250
# medians over count-gated pixels; the f32 envelope measured on CPU at this
# config (tests/test_f32.py methodology) is r ~3e-4, enshift ~1e-4
IMAGE_THRESHOLDS = {"r": 0.01, "enshift": 0.005, "time": 0.001, "flux": 0.05}

CAUSTIC_GOLDEN = GOLDEN / "caustic_discplane_a0.998_i60_rk45.bin"
# f32 envelope at this config (dist 500, eps_frac 0.01): median det J dev
# ~1.2%, but ~15% of order-matched pixels are garbage — bundles that graze
# near-critical phase-space regions amplify the f32 landing noise
# chaotically (cf. the reference's own separatrix methodology, SURVEY.md
# §4). So the gate is the median plus the well-measured fraction (sign
# correct AND magnitude within 50%), not a raw sign-match rate; the f64 CPU
# suite (tests/test_caustics.py) pins the thin-tail behaviour.
CAUSTIC_THRESHOLDS = {"radius": 1e-3, "det_j": 0.10, "good_frac": 0.80}

PLANE_GOLDEN = GOLDEN / "caustic_plane_a0.998_i30_rk45.bin"
# The far-PLANE target marches every bundle ~500 r_g PAST the hole, so f32
# landing noise is ~1.3 r_g median and the per-pixel Jacobians are
# Lyapunov-swamped even f32-vs-f64 on our own pipeline (measured on the CPU
# f32 path: median dev 3.8x, 440 surviving pixels) — det J is therefore
# REPORTED but not gated for this target; the f64 CPU suite
# (tests/test_caustics.py) pins it to 1%. The gate is the structure that
# survives f32: hit map, image order, landing positions.
PLANE_THRESHOLDS = {"landing": 2.5, "order_agree": 0.98}
SPHERE_GOLDEN = GOLDEN / "caustic_sourceplane_a0.998_i30_rk45.bin"
# sphere landing ANGLES divide out the lever arm (f32 envelope measured on
# the CPU f32 path: median 1.4e-3 rad, det J median 6.9%, well-measured
# fraction 96%)
SPHERE_THRESHOLDS = {"angle": 5e-3, "det_j": 0.15, "good_frac": 0.85}

# sharded vs single-card sums: the psum adds the partials in another order
SHARD_RTOL = 1e-5


def say(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# comparison helpers (pure numpy; tests/test_chip_smoke.py runs them on CPU)


def engine_agreement(a_status, a_r, b_status, b_r, live):
    """Kernel route (a) vs plain route (b) on one batch: the share of live
    rays whose termination status agrees, the median |dr|/r over rays of
    equal status, the stuck-ray counts of each, and the verdict."""
    sa, sb = np.asarray(a_status)[live], np.asarray(b_status)[live]
    same = sa == sb
    ra = np.asarray(a_r, np.float64)[live][same]
    rb = np.asarray(b_r, np.float64)[live][same]
    rel = np.abs(ra - rb) / np.maximum(np.abs(rb), np.finfo(np.float64).tiny)
    stuck_a = int(((sa & 8) != 0).sum())
    stuck_b = int(((sb & 8) != 0).sum())
    agree = float(same.mean()) if same.size else 0.0
    med = float(np.median(rel)) if rel.size else float("inf")
    return {
        "status_agree": agree,
        "median_rel_dr": med,
        "stuck_kernel": stuck_a,
        "stuck_xla": stuck_b,
        "ok": agree >= STATUS_AGREE and med < MEDIAN_REL_DR
        and stuck_a == 0 and stuck_b == 0,
    }


def gated_bins(mine_rays, ref_rays):
    """Bins with >= 100 rays in both runs whose ray counts agree within 10%
    (emissivity_rk45_test.cpp:57-63). Meaningful between runs of one grid
    (see phase_full_width)."""
    mine = np.asarray(mine_rays, np.float64)
    ref = np.asarray(ref_rays, np.float64)
    return (ref >= 100) & (mine >= 100) & (
        np.abs(mine - ref) < 0.10 * np.maximum(ref, 1)
    )


def profile_deviation(mine, ref, gated):
    """Max and median relative deviation of each gated field."""
    out = {}
    for fld, tol in THRESHOLDS.items():
        dev = np.abs(np.asarray(mine[fld])[gated] / np.asarray(ref[fld])[gated] - 1.0)
        mx = float(dev.max()) if dev.size else float("inf")
        out[fld] = {"max_dev": mx, "median_dev": float(np.median(dev)) if dev.size else float("inf"),
                    "tol": tol, "pass": mx < tol}
    return out


def sharded_agreement(counts_sharded, counts_single, maps_sharded, maps_single):
    """Sharded vs single-card observables: counts equal exactly, every map
    within SHARD_RTOL where it is populated."""
    cs, c1 = np.asarray(counts_sharded), np.asarray(counts_single)
    counts_eq = bool(np.array_equal(cs, c1))
    filled = c1 > 0
    worst = 0.0
    for k in maps_single:
        a = np.asarray(maps_sharded[k], np.float64)[filled]
        b = np.asarray(maps_single[k], np.float64)[filled]
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.abs(a - b) / np.maximum(np.abs(b), np.finfo(np.float64).tiny)
        rel = rel[np.isfinite(a) & np.isfinite(b)]
        if rel.size:
            worst = max(worst, float(rel.max()))
    return {"counts_equal": counts_eq, "max_rel_dev": worst,
            "ok": counts_eq and worst < SHARD_RTOL}


def cumulative_rows_deviation(mine_rays, ref_rays, scale, row):
    """Largest gap, in reference rows of ``row`` rays, between the two
    cumulative ray counts over radius, ``mine`` scaled by ``scale`` to the
    reference's number of primary rays."""
    cm = np.cumsum(np.asarray(mine_rays, np.float64)) * scale
    cr = np.cumsum(np.asarray(ref_rays, np.float64))
    return float(np.abs(cm - cr).max() / row)


def n_primary(grid):
    """Grid-cell count of the emissivity normalisation (emissivity.cpp:61)."""
    return ((grid.cosalphamax - grid.cosalpha0) / grid.dcosalpha) * (
        (grid.betamax - grid.beta0) / grid.dbeta
    )


# ---------------------------------------------------------------------------
# device helpers


def lamppost_f32(dcosalpha, dbeta):
    from raytrace_tpu.sources import PointSourceGrid, point_source

    rays = point_source(LAMPPOST, V=0.0, spin=SPIN,
                        grid=PointSourceGrid.from_steps(dcosalpha, dbeta))
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, rays
    )


def compiled(fn, *args):
    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    return exe, time.perf_counter() - t0


def run_timed(exe, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(exe(*args))
    return out, time.perf_counter() - t0


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def memory_line(exe):
    ma = exe.memory_analysis()
    return (f"arguments {ma.argument_size_in_bytes} B, outputs "
            f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B")


# ---------------------------------------------------------------------------
# phases (each returns True on success)


def phase_device(n_cards):
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu" or len(devs) < n_cards:
        print(f"chip_smoke needs {n_cards} GPU(s); JAX found {len(devs)} "
              f"{d.platform!r} device(s)", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say(f"device: {d.device_kind} x{len(devs)}, jax {jax.__version__}")
    for line in smi.splitlines():
        say(f"nvidia-smi: {line}")
    return True


def phase_compile(state):
    from raytrace_tpu.destinations import (
        DiscWithISCO, FlatPlane, SphericalShell, ThetaLimit,
    )
    from raytrace_tpu.ops import kernel_steplim
    from raytrace_tpu.ops.pallas_kernel import trace_pallas_fused

    f32 = jnp.float32
    rays = lamppost_f32(*SIZES["125800"])
    state["rays"] = {"125800": rays}
    dests = {
        "theta": ThetaLimit(f32(np.pi / 2)),
        "isco": DiscWithISCO(r_isco=f32(1.2370), r_out=f32(500.0)),
        "plane": FlatPlane(incl=f32(1.0), phi0=f32(0.0), z_s=f32(50.0)),
        "shell": SphericalShell(r_shell=f32(500.0)),
    }
    s = f32(SPIN)
    for method in ("rk4", "rk45", "euler"):
        for kind, dest in dests.items():
            fn = partial(trace_pallas_fused, method=method, r_max=1000.0,
                         steplim=kernel_steplim(method))
            exe, dt = compiled(lambda r, s, d, fn=fn: fn(r, s, dest=d), rays, s, dest)
            say(f"compile {method:5s} {kind:5s}: {dt:7.2f} s; {memory_line(exe)}")
            if kind == "theta":
                state[("kernel", "125800", method)] = lambda r, s, exe=exe, d=dest: exe(r, s, d)
    return True


def phase_engine(state):
    from raytrace_tpu.ops import kernel_steplim, trace_compacted
    from raytrace_tpu.ops.pallas_kernel import trace_pallas_fused

    ok = True
    s = jnp.float32(SPIN)
    for size, steps in SIZES.items():
        rays = state["rays"].get(size)
        if rays is None:
            rays = lamppost_f32(*steps)
        live = np.asarray(rays.steps) >= 0
        for method in ("rk4", "rk45"):
            kw = dict(method=method, r_max=1000.0, steplim=kernel_steplim(method))
            kern = state.get(("kernel", size, method))
            if kern is None:
                kern, dt = compiled(partial(trace_pallas_fused, **kw), rays, s)
                say(f"compile kernel {method} at {size}: {dt:.2f} s; {memory_line(kern)}")
            xla, dt = compiled(partial(trace_compacted, **kw), rays, s)
            say(f"compile xla    {method} at {size}: {dt:.2f} s; {memory_line(xla)}")
            times = {"kernel": [], "xla": []}
            for _ in range(2):  # the first kernel run also warms it up
                a, t = run_timed(kern, rays, s)
                times["kernel"].append(t)
            for _ in range(2):
                b, t = run_timed(xla, rays, s)
                times["xla"].append(t)
            res = engine_agreement(a.status, a.r, b.status, b.r, live)
            ok &= res["ok"]
            say(f"engine {method} {size} ({int(live.sum())} rays): kernel "
                f"{times['kernel'][-1]:.4f} s, xla {times['xla'][-1]:.4f} s "
                f"(all runs: {times}); status agree {res['status_agree']:.5f}, "
                f"median |dr|/r {res['median_rel_dr']:.2e}, stuck "
                f"{res['stuck_kernel']}/{res['stuck_xla']} -> "
                f"{'PASS' if res['ok'] else 'FAIL'}")
            del a, b, kern, xla
    state["rays"].clear()
    return ok


def check_emissivity():
    from raytrace_tpu.apps.emissivity import compute
    from raytrace_tpu.sources import PointSourceGrid

    ref = dict(zip(EMIS_COLUMNS, np.loadtxt(EMIS_GOLDEN).T))
    grid = PointSourceGrid.from_steps(0.05, 0.05, -0.995, 0.995, -np.pi, np.pi)
    mine = compute(SPIN, (0.0, 5.0, 1e-3, 1.5707), V=0.0, grid=grid,
                   r_max=1000.0, r_disc=500.0, n_r=100, logbin_r=True,
                   gamma=2.0, steplim=20000, method="rk45")
    gated = gated_bins(mine["rays"], ref["rays"])
    dev = profile_deviation(mine, ref, gated)
    say(f"  emissivity: {int(gated.sum())} gated bins; " + ", ".join(
        f"{k} max dev {v['max_dev']:.4f} (tol {v['tol']})" for k, v in dev.items()))
    return all(v["pass"] for v in dev.values())


def check_disc_image_far_field():
    from raytrace_tpu.apps.imageplane_disc_image import compute
    from raytrace_tpu.sources import ImagePlaneGrid

    raw = IMAGE_GOLDEN.read_bytes()
    n = IMAGE_N * IMAGE_N
    names = ["flux", "r", "phi", "enshift", "time", "emis"]
    ref = {
        nm: np.frombuffer(raw, dtype="<f8", count=n, offset=i * n * 8).reshape(
            IMAGE_N, IMAGE_N)
        for i, nm in enumerate(names)
    }
    counts = np.fromfile(str(IMAGE_GOLDEN) + ".counts", dtype="<i4").reshape(
        IMAGE_N, IMAGE_N)
    dx = 60.0 / 500
    grid = ImagePlaneGrid.from_steps(-30.0, 30.0, dx, -30.0, 30.0, dx)
    mine = compute(SPIN, 10000.0, 80.0, grid, r_disc=30.0,
                   img_nx=IMAGE_N, img_ny=IMAGE_N, method="rk45",
                   dtype=jnp.float32)
    n_mine, n_ref = int(mine["counts"].sum()), int(counts.sum())
    ok = abs(n_mine - n_ref) <= 0.02 * n_ref
    gated = (counts >= 3) & (mine["counts"] >= 3)
    parts = []
    for fld, tol in IMAGE_THRESHOLDS.items():
        med = float(np.median(np.abs(mine[fld][gated] / ref[fld][gated] - 1.0)))
        ok &= med < tol
        parts.append(f"{fld} median dev {med:.5f} (tol {tol})")
    say(f"  disc image d=1e4: rays on disc {n_mine} (ref {n_ref}), "
        f"{int(gated.sum())} gated pixels; " + ", ".join(parts))
    return ok


def _caustic_ref(path, n, names):
    raw = np.fromfile(path, "<f8")
    return {nm: raw[i * n * n:(i + 1) * n * n].reshape(n, n)
            for i, nm in enumerate(names)}


def check_caustic_discplane():
    from raytrace_tpu.apps.caustics import SENTINEL, compute
    from raytrace_tpu.sources import ImagePlaneGrid

    ref = _caustic_ref(CAUSTIC_GOLDEN, 81, ["det_j", "sign_j", "order", "hit",
                                            "radius", "phi", "x_disc", "y_disc",
                                            "redshift"])
    grid = ImagePlaneGrid.from_steps(-12.0, 12.0, 0.3, -12.0, 12.0, 0.3)
    maps = compute(SPIN, 500.0, 60.0, grid, target="disc", r_disc=20.0,
                   method="rk45", steplim=60000, bundle_eps_frac=0.01,
                   dtype=jnp.float32)
    hit_m, hit_r = maps["hit"].astype(bool), ref["hit"] > 0.5
    hit_agree = float((hit_m == hit_r).mean())
    both = hit_m & hit_r
    rel_r = np.abs(maps["radius"][both] / ref["radius"][both] - 1)
    dm, dr = maps["det_j"], ref["det_j"]
    okp = (both & np.isfinite(dm) & np.isfinite(dr) & (dm != SENTINEL)
           & (np.abs(dr) < 1e29) & (maps["order"] == ref["order"]))
    rel_d = np.abs(dm[okp] / dr[okp] - 1)
    good = float(((rel_d < 0.5) & (np.sign(dm[okp]) == np.sign(dr[okp]))).mean())
    med_r, med_d = float(np.median(rel_r)), float(np.median(rel_d))
    ok = (hit_agree > 0.98 and okp.sum() > 3000
          and med_r < CAUSTIC_THRESHOLDS["radius"]
          and med_d < CAUSTIC_THRESHOLDS["det_j"]
          and good > CAUSTIC_THRESHOLDS["good_frac"])
    say(f"  caustic_discplane: hit agreement {hit_agree:.4f}, {int(okp.sum())} "
        f"order-matched pixels, radius {med_r:.2e}, det J {med_d:.4f}, "
        f"well-measured {good:.4f}")
    return ok


def check_caustic_plane():
    from raytrace_tpu.apps.caustics import SENTINEL, compute
    from raytrace_tpu.sources import ImagePlaneGrid

    ref = _caustic_ref(PLANE_GOLDEN, 81, ["det_j", "sign_j", "order", "hit",
                                          "x_s", "y_s", "rdot_flips",
                                          "equat_cross"])
    grid = ImagePlaneGrid.from_steps(-10.0, 10.0, 0.25, -10.0, 10.0, 0.25)
    maps = compute(SPIN, 500.0, 30.0, grid, target="plane", z_s=500.0,
                   method="rk45", steplim=100000, bundle_eps_frac=0.01,
                   dtype=jnp.float32)
    hm, hr = maps["hit"].astype(bool), ref["hit"] > 0.5
    hit_agree = float((hm == hr).mean())
    both = hm & hr
    land = float(np.median(np.concatenate([
        np.abs(maps["x_s"][both] - ref["x_s"][both]),
        np.abs(maps["y_s"][both] - ref["y_s"][both]),
    ])))
    order_agree = float((maps["order"][both] == ref["order"][both]).mean())
    dm, dr = maps["det_j"], ref["det_j"]
    okp = (both & np.isfinite(dm) & np.isfinite(dr) & (dm != SENTINEL)
           & (np.abs(dr) < 1e29) & (maps["order"] == ref["order"]))
    med_d = float(np.median(np.abs(dm[okp] / dr[okp] - 1))) if okp.any() else float("nan")
    ok = (hit_agree > 0.97 and land < PLANE_THRESHOLDS["landing"]
          and order_agree > PLANE_THRESHOLDS["order_agree"])
    say(f"  caustic_plane: hit agreement {hit_agree:.4f}, landing {land:.4f}, "
        f"order agreement {order_agree:.4f}; det J median dev {med_d:.3f} over "
        f"{int(okp.sum())} pixels (reported, not gated)")
    return ok


def check_caustic_sourceplane():
    from raytrace_tpu.apps.caustics import SENTINEL, compute
    from raytrace_tpu.sources import ImagePlaneGrid

    ref = _caustic_ref(SPHERE_GOLDEN, 82, ["det_j", "sign_j", "order",
                                           "escaped", "theta_s", "phi_s",
                                           "rdot_flips", "equat_cross"])
    dx = 24.0 / 81
    grid = ImagePlaneGrid.from_steps(-12.0, 12.0, dx, -12.0, 12.0, dx)
    maps = compute(SPIN, 500.0, 30.0, grid, target="sphere", r_lim=1000.0,
                   method="rk45", steplim=100000, dtype=jnp.float32)
    em, er = maps["escaped"].astype(bool), ref["escaped"] > 0.5
    esc_agree = float((em == er).mean())
    both = em & er
    dphi = np.abs(maps["phi_s"][both] - ref["phi_s"][both])
    dphi = np.minimum(dphi, 2 * np.pi - dphi)
    ang = float(np.median(np.concatenate([
        np.abs(maps["theta_s"][both] - ref["theta_s"][both]), dphi])))
    dm, dr = maps["det_j"], ref["det_j"]
    okp = (both & np.isfinite(dm) & np.isfinite(dr) & (dm != SENTINEL)
           & (np.abs(dr) < 1e29) & (maps["order"] == ref["order"]))
    rel = np.abs(dm[okp] / dr[okp] - 1)
    med_d = float(np.median(rel)) if okp.any() else float("nan")
    good = (float(((rel < 0.5) & (np.sign(dm[okp]) == np.sign(dr[okp]))).mean())
            if okp.any() else 0.0)
    ok = (esc_agree > 0.97 and okp.sum() > 3000
          and ang < SPHERE_THRESHOLDS["angle"]
          and med_d < SPHERE_THRESHOLDS["det_j"]
          and good > SPHERE_THRESHOLDS["good_frac"])
    say(f"  caustic_sourceplane: escape agreement {esc_agree:.4f}, "
        f"{int(okp.sum())} order-matched pixels, angle {ang:.2e}, det J "
        f"{med_d:.4f}, well-measured {good:.4f}")
    return ok


def check_emissivity_cli(tmp):
    from raytrace_tpu.apps.emissivity import main

    ref = dict(zip(EMIS_COLUMNS, np.loadtxt(EMIS_GOLDEN).T))
    par = Path(tmp) / "emis_golden.par"
    out_path = Path(tmp) / "emis_cli.dat"
    par.write_text(
        "source = 0 5 1E-3 1.5707\nV = 0\nspin = 0.998\n"
        "dcosalpha = 0.05\ndbeta = 0.05\nNr = 100\nlogbin_r = 1\n"
        "integrator = rk45\nsteplim = 20000\n"
    )
    rc = main([f"--parfile={par}", f"--outfile={out_path}"])
    mine = dict(zip(EMIS_COLUMNS, np.loadtxt(out_path).T))
    gated = gated_bins(mine["rays"], ref["rays"])
    dev = profile_deviation(mine, ref, gated)
    say(f"  emissivity CLI: exit {rc}, {int(gated.sum())} gated bins; " + ", ".join(
        f"{k} max dev {v['max_dev']:.4f}" for k, v in dev.items()))
    return rc == 0 and gated.sum() >= 15 and all(v["pass"] for v in dev.values())


def phase_validation(tmp):
    ok = True
    for name, check in [
        ("emissivity", check_emissivity),
        ("disc_image_far_field", check_disc_image_far_field),
        ("caustic_discplane", check_caustic_discplane),
        ("caustic_plane", check_caustic_plane),
        ("caustic_sourceplane", check_caustic_sourceplane),
        ("emissivity_cli", partial(check_emissivity_cli, tmp)),
    ]:
        t0 = time.perf_counter()
        good = bool(check())
        ok &= good
        say(f"validation {name}: {'PASS' if good else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")
    return ok


def phase_full_width(tmp):
    from raytrace_tpu.apps import emissivity, imageplane_disc_image
    from raytrace_tpu.config import ParameterFile
    from raytrace_tpu.io import read_fits
    from raytrace_tpu.sources import PointSourceGrid

    ok = True
    out = Path(tmp) / "emissivity.dat"
    par_path = ROOT / "par_example" / "emissivity.par"
    par = ParameterFile(str(par_path))
    grid = PointSourceGrid.from_steps(par.get("dcosalpha"), par.get("dbeta"))
    t0 = time.perf_counter()
    rc = emissivity.main([f"--parfile={par_path}", f"--outfile={out}"])
    wall = time.perf_counter() - t0
    cols = np.atleast_2d(np.loadtxt(out))
    mine = dict(zip(EMIS_COLUMNS, cols.T))
    filled = mine["rays"] > 0
    finite = bool(np.isfinite(cols[filled]).all() and np.isfinite(cols[:, :5]).all())
    say(f"full_width rt-emissivity ({grid.n_rays} rays, RK45): exit {rc}, wall "
        f"{wall:.2f} s, peak_bytes_in_use {peak_bytes()}, "
        f"{int(mine['rays'].sum())} rays binned, finite {finite}")
    ok &= rc == 0 and finite

    # (1) The reference golden ran the 0.05 x 0.05 grid. The source sits on
    # the axis, so every ray of one cos(alpha) row lands at one radius: the
    # golden's bins hold whole rows of 126 rays, point samples rather than
    # densities, and a bin-by-bin comparison with 10x finer rows measures
    # the golden's sampling. Its cumulative count of rays per primary ray
    # is exact to about one row (an interval of cos(alpha) landing inside
    # r holds its length / 0.05 rows, +-1), so the run must stay within
    # GOLDEN_ROWS_TOL golden rows of it at every bin edge.
    gold = dict(zip(EMIS_COLUMNS, np.loadtxt(EMIS_GOLDEN).T))
    ggrid = PointSourceGrid.from_steps(0.05, 0.05)
    rows = cumulative_rows_deviation(mine["rays"], gold["rays"],
                                     n_primary(ggrid) / n_primary(grid),
                                     ggrid.n_beta)
    good = rows < GOLDEN_ROWS_TOL
    ok &= good
    say(f"  vs golden (0.05 grid): cumulative rays per primary ray within "
        f"{rows:.3f} golden rows (tol {GOLDEN_ROWS_TOL}) -> "
        f"{'PASS' if good else 'FAIL'}")

    # (2) The count-gated methodology at identical resolution: the same
    # profile through the plain XLA route in f64 on the card.
    from raytrace_tpu.ops import trace_compacted

    t0 = time.perf_counter()
    plain = emissivity.compute(
        par.get("spin"), par.get_array("source", float, 4), par.get("V"),
        grid, r_max=1000.0, r_disc=500.0, n_r=par.get("Nr", int),
        logbin_r=par.get("logbin_r", bool), gamma=2.0, method="rk45",
        trace_fn=trace_compacted)
    gated = gated_bins(mine["rays"], plain["rays"])
    dev = profile_deviation(mine, plain, gated)
    good = gated.sum() >= 15 and all(v["pass"] for v in dev.values())
    ok &= good
    say(f"  vs plain f64 XLA route ({time.perf_counter() - t0:.2f} s): "
        f"{int(gated.sum())} gated bins; " + ", ".join(
            f"{k} max dev {v['max_dev']:.2e} (tol {v['tol']})" for k, v in dev.items())
        + f" -> {'PASS' if good else 'FAIL'}")

    out = Path(tmp) / "disc_image.fits"
    par = ROOT / "par_example" / "imageplane_disc_image.par"
    img_n = ParameterFile(str(par)).get("img_Nx", int)
    t0 = time.perf_counter()
    rc = imageplane_disc_image.main([f"--parfile={par}", f"--outfile={out}"])
    wall = time.perf_counter() - t0
    maps = read_fits(str(out))
    names = ["FLUX", "RADIUS", "PHI", "ENSHIFT", "TIME", "EMIS", "NRAYS"]
    finite = all(np.isfinite(maps[k]).all() for k in names)
    n_disc = int(maps["NRAYS"].sum())
    shape = maps["NRAYS"].shape
    good = rc == 0 and finite and n_disc > 0 and shape == (img_n, img_n)
    ok &= good
    say(f"full_width rt-disc-image (par file rays, d=1e4, RK45): exit {rc}, "
        f"wall {wall:.2f} s, peak_bytes_in_use {peak_bytes()}, maps {shape}, "
        f"{n_disc} rays on the disc, finite {finite} -> "
        f"{'PASS' if good else 'FAIL'}")
    return ok


def phase_four_cards():
    """The apps' sharded path on a 4-card mesh vs the same run on card 0."""
    from raytrace_tpu.apps import emissivity, imageplane_disc_image
    from raytrace_tpu.config import ParameterFile
    from raytrace_tpu.parallel import make_ray_mesh
    from raytrace_tpu.sources import ImagePlaneGrid, PointSourceGrid

    mesh = make_ray_mesh(4)
    ok = True
    # the two production par files' grids (par_example/)
    epar = ParameterFile(str(ROOT / "par_example" / "emissivity.par"))
    grid = PointSourceGrid.from_steps(epar.get("dcosalpha"), epar.get("dbeta"))
    kw = dict(V=0.0, grid=grid, r_max=1000.0, r_disc=500.0, n_r=100,
              logbin_r=True, gamma=2.0, method="rk45")
    runs = {}
    for tag, m in (("sharded", mesh), ("card0", None)):
        t0 = time.perf_counter()
        runs[tag] = emissivity.compute(SPIN, (0.0, 5.0, 1e-3, 1.5707), mesh=m, **kw)
        say(f"four_cards emissivity {tag}: {time.perf_counter() - t0:.2f} s "
            "(compile included)")
    fields = ["flux", "emis", "redshift", "time"]
    res = sharded_agreement(
        runs["sharded"]["rays"], runs["card0"]["rays"],
        {k: runs["sharded"][k] for k in fields}, {k: runs["card0"][k] for k in fields})
    ok &= res["ok"]
    say(f"four_cards emissivity ({grid.n_rays} rays, RK45): counts equal "
        f"{res['counts_equal']}, max rel dev {res['max_rel_dev']:.2e} "
        f"(tol {SHARD_RTOL}) -> {'PASS' if res['ok'] else 'FAIL'}")

    # The par file's Nx + 1 = 1001 rays per axis put every ray exactly on a
    # pixel edge of its 1000-pixel image, so which pixel a ray lands in is a
    # rounding tie that one compiled program breaks differently from
    # another (a jitted division by a constant becomes a multiplication by
    # its reciprocal). So: 1000 x 1000 rays for the 1000 x 1000 image, which
    # leaves ties only for the last ray of each row and column, on a field
    # widened from +-30 to +-32 r_g so those border rays miss the disc.
    ipar = ParameterFile(str(ROOT / "par_example" / "imageplane_disc_image.par"))
    img_n = ipar.get("img_Nx", int)
    half = 32.0
    dx = 2 * half / img_n
    igrid = ImagePlaneGrid(img_n, img_n, dx / 2 - half, dx / 2 - half, dx, dx)
    ikw = dict(r_disc=ipar.get("r_disc"), img_nx=img_n, img_ny=img_n,
               method="rk45")
    images = {}
    for tag, m in (("sharded", mesh), ("card0", None)):
        t0 = time.perf_counter()
        images[tag] = imageplane_disc_image.compute(
            ipar.get("spin"), ipar.get("dist"), ipar.get("incl"), igrid,
            mesh=m, **ikw)
        say(f"four_cards disc image {tag}: {time.perf_counter() - t0:.2f} s "
            "(compile included)")
    keys = ["flux", "r", "phi", "enshift", "time", "emis"]
    res = sharded_agreement(
        images["sharded"]["counts"], images["card0"]["counts"],
        {k: images["sharded"][k] for k in keys}, {k: images["card0"][k] for k in keys})
    ok &= res["ok"]
    say(f"four_cards disc image ({igrid.nx}x{igrid.ny} rays, RK45): counts "
        f"equal {res['counts_equal']}, max rel dev {res['max_rel_dev']:.2e} "
        f"(tol {SHARD_RTOL}) -> {'PASS' if res['ok'] else 'FAIL'}")
    return ok


def run_phase(name, fn, *args):
    t0 = time.perf_counter()
    try:
        good = bool(fn(*args))
    except Exception:
        traceback.print_exc()
        good = False
    say(f"phase {name}: {'PASS' if good else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")
    return good


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    enable_compilation_cache()
    phase_device(4 if four else 1)
    ok = True
    if four:
        ok &= run_phase("four_cards", phase_four_cards)
    else:
        state = {}
        with tempfile.TemporaryDirectory() as tmp:
            ok &= run_phase("compile", phase_compile, state)
            ok &= run_phase("engine", phase_engine, state)
            ok &= run_phase("validation", phase_validation, tmp)
            ok &= run_phase("full_width", phase_full_width, tmp)
    d = jax.devices()[0]
    print(json.dumps({"ok": bool(ok), "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
