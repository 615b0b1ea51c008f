"""Differentiable geodesic tracing.

``trace()`` uses lax.while_loop, which is not reverse-mode differentiable;
this module provides ``trace_scan`` — the same masked lock-step march over a
*fixed* number of iterations via lax.scan with gradient checkpointing — so
the whole pipeline (source constants -> march -> redshift -> smooth
observables) is differentiable with respect to spin, source position /
height, velocity and emissivity parameters.

The reference has no gradient capability at all; this is the new
framework's north star (BASELINE.json): parameter gradients for fitting
observed emissivity profiles / line profiles / images.

Differentiation notes:
  * Masked freezing is AD-transparent: a frozen lane's state is an identity
    function of the carry, so gradients flow through the step at which each
    ray terminated.
  * The turning-point sign machinery uses sqrt(|x|), whose derivative blows
    up at turning points; rays passing exactly through one contribute noisy
    gradients (the underlying dynamics is genuinely non-smooth there:
    photon-sphere chaos). Validate gradients on smooth observables over
    robust ray sets, as the reference's own statistical test methodology
    suggests for forward values (SURVEY.md §4).
  * Step counts must cover the slowest ray of interest; unterminated rays
    simply keep integrating (their contribution to terminal-masked
    observables is zero but their gradient work is wasted), so pick
    n_steps around the p99 of the workload's step distribution.
  * Which parameters are *usefully* differentiable is physics, not
    implementation: gamma enters through a smooth analytic weight (exact
    gradients); source height/position move individual landing points
    smoothly (validated against the reference binary's finite differences,
    tests/test_diff.py); but the SPIN response of inner-disc observables
    at high spin is dominated by discrete membership changes — rays
    crossing the capture/escape boundary — whose boundary members are
    exactly the chaotic set. Stop-gradded masks cannot carry that term,
    and the rays that do are Lyapunov-amplified, so ensemble spin
    gradients serve sensitivity analysis on membership-stable observables
    (the FD-validated regime), not black-box descent through capture
    transitions.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from raytrace_tpu.destinations import Destination, ThetaLimit
from raytrace_tpu.geometry.kerr import horizon_radius
from raytrace_tpu.ops.integrate import (
    StepControl,
    _euler_rk4_body,
    _refine_theta_crossing,
    _rk45_body,
    _seed_rk45_step,
)
from raytrace_tpu.rays import RAY_STATUS_NUMERIC, RAY_STATUS_STEPLIM, RayBatch


@partial(
    jax.jit,
    static_argnames=("method", "n_steps", "ctrl", "checkpoint_every", "refine_crossing"),
)
def trace_scan(
    rays: RayBatch,
    spin,
    *,
    method: str = "rk4",
    dest: Destination = None,
    r_max=1000.0,
    n_steps: int = 2048,
    ctrl: StepControl = StepControl(),
    boundary=None,
    checkpoint_every: int = 64,
    refine_crossing: bool = True,
) -> RayBatch:
    """Fixed-iteration differentiable twin of trace().

    Runs exactly n_steps lock-step iterations (terminated lanes frozen) as
    ceil(n_steps/checkpoint_every) scanned chunks, each rematerialised on
    the backward pass — memory O(n_steps/checkpoint_every) states instead
    of O(n_steps).
    """
    if dest is None:
        dest = ThetaLimit(jnp.pi / 2)

    horizon = horizon_radius(spin) if boundary is None else boundary
    steplim = n_steps + 1  # per-ray STEPLIM can't trigger within the budget

    # gate resets consume the incoming leaves (x & False / x | True) rather
    # than allocating fresh constants, so the scan carry keeps the batch's
    # device-variance under shard_map vma checking
    rays = rays.replace(
        r_was_positive=rays.r_was_positive & False,
        theta_was_positive=rays.theta_was_positive | True,
    )
    if method == "rk45":
        rays = rays.replace(dt=_seed_rk45_step(rays, spin, horizon, ctrl))

    n_chunks = -(-n_steps // checkpoint_every)

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

    # outer scan of rematerialised chunks, inner scan of steps: the forward
    # pass stores only chunk boundaries; the backward pass recomputes one
    # chunk at a time, whose inner scan then holds checkpoint_every
    # residual states.
    @jax.checkpoint
    def chunk(carry, _):
        carry, _ = lax.scan(one_step, carry, None, length=checkpoint_every)
        return carry, None

    from raytrace_tpu.ops.integrate import _seed_rk45_rates

    if method == "rk45":
        init = (rays, rays.dt, _seed_rk45_rates(rays, rays.active, spin))
    else:
        init = (rays, rays.dt)
    carry_f, _ = lax.scan(chunk, init, None, length=n_chunks)
    final, step_f = carry_f[0], carry_f[1]
    final = final.replace(dt=step_f)

    stuck = (
        (final.status & (RAY_STATUS_STEPLIM | RAY_STATUS_NUMERIC)) != 0
    ) & (final.steps > 0)
    final = final.replace(steps=jnp.where(stuck, -final.steps, final.steps))
    if refine_crossing:
        final = _refine_theta_crossing(final, dest, spin)
    return final


def separatrix_score(k, h, Q, spin, n_grid=64):
    """Smooth per-ray distance to the Kerr photon-shell separatrix.

    A photon with constants (k, h, Q) is captured or escapes according to
    the sign of min_r R(r) over the photon shell, where R is Carter's
    radial potential rho^4 rdot^2 = (k(r^2+a^2) - a h)^2 - Delta (Q +
    (h - a k)^2); rays with min_r R near zero are the chaotic
    photon-sphere-skimming set whose landing point is Lyapunov-amplified
    fp noise. The score is that minimum over a fixed log grid spanning
    every spherical photon orbit radius (r in [1, 4.5] covers prograde
    through retrograde for all |a| <= 1), normalised by the magnitude of
    the cancelling terms so it is dimensionless and O(1) away from the
    separatrix. Smooth in (k, h, Q, spin) — and, unlike anything computed
    from the marched trajectory, it depends only on the initial constants,
    so recompilation/fusion changes cannot move it beyond one ulp.
    """
    ftype = jnp.result_type(k)
    k_safe = jnp.where(jnp.abs(k) > 1e-30, k, jnp.ones_like(k))
    xi = (h / k_safe)[..., None]
    eta = (Q / (k_safe * k_safe))[..., None]
    r = jnp.logspace(0.0, jnp.log10(4.5), n_grid, dtype=ftype)
    delta = r * r - 2.0 * r + spin * spin
    A = (r * r + spin * spin) - spin * xi
    B = eta + (xi - spin) ** 2
    R = A * A - delta * B
    norm = A * A + jnp.abs(delta) * B + 1.0
    return jnp.min(R / norm, axis=-1)


def launch_turning_scores(r0, theta0, k, h, Q, spin):
    """Normalised radial and polar potentials at the launch point.

    Rays launched exactly AT a turning point — cos(alpha) = 0 lamppost
    rays have R(r0) = 0 identically, sin(beta) = 0 rays have
    Theta(theta0) = 0 — re-derive the corresponding momentum from
    sqrt(|potential|) every step, so the sign of their first move is a
    rounding coin flip that any recompilation/re-fusion can land on the
    other side (measured: cos(alpha) = 0 rays at spin 0.9 fall in to
    r = 3.3 under one fusion and climb to r = 10.5 under another). The
    sources already floor the IMAGE-plane version of this knife edge
    (sources/imageplane.py y = 0 regularisation); for observables the
    smooth fix is to weight such rays out (chaos_weight). Both scores are
    pure functions of the initial state/constants — recompilation cannot
    move them."""
    k_safe = jnp.where(jnp.abs(k) > 1e-30, k, jnp.ones_like(k))
    xi = h / k_safe
    eta = Q / (k_safe * k_safe)
    delta = r0 * r0 - 2.0 * r0 + spin * spin
    A = r0 * r0 + spin * spin - spin * xi
    B = eta + (xi - spin) ** 2
    r_score = (A * A - delta * B) / (A * A + jnp.abs(delta) * B + 1.0)
    sin2 = jnp.maximum(jnp.sin(theta0) ** 2, 1e-30)
    cos2 = jnp.cos(theta0) ** 2
    barrier = xi * xi / sin2
    th_score = (eta + cos2 * (spin * spin - barrier)) / (
        eta + spin * spin + barrier + 1.0
    )
    return r_score, th_score


def chaos_weight(sep_score, launch_scores=(), sep_margin=0.05,
                 launch_margin=0.02):
    """Smooth membership weight suppressing the recompilation-sensitive
    ray sets: kills their influence on the *value* of an observable (not
    just its gradient), so the observable is robust to the fp/step-phase
    trajectory perturbations that recompilation, re-fusion or hardware
    changes introduce — those can only move rays whose weight is already
    negligible. This is what lets the sharded gradient step be one jitted
    program (parallel/sharding.py::_sharded_gradient_program).

    One factor 1 - exp(-(s/margin)^2) per sensitive set:
      * photon-shell separatrix: Lyapunov amplification of ulp noise near
        capture/escape criticality (separatrix_score);
      * launch turning points: the momentum-sign coin flip of rays
        launched where R(r0) or Theta(theta0) vanish
        (launch_turning_scores) — the flip window is rounding-scale, far
        inside the margin, so only the knife-edge rays lose weight.
    """
    xs = sep_score / sep_margin
    w = -jnp.expm1(-(xs * xs))
    for s in launch_scores:
        x = s / launch_margin
        w = w * -jnp.expm1(-(x * x))
    return w


def smooth_radial_observable(out: RayBatch, mask, weights, r0, sigma_ln=0.25):
    """A smooth scalar observable for gradient work: the weights of masked
    rays accumulated under a log-normal radial window centred on r0.

    Bin-histogram observables are piecewise constant in the parameters
    (rays jump bins); this Gaussian kernel in ln r is the smooth analogue
    the gradients need.
    """
    r_safe = jnp.where(mask, out.r, r0)
    w_safe = jnp.where(mask, weights, 0.0)
    w = jnp.exp(-0.5 * ((jnp.log(r_safe) - jnp.log(r0)) / sigma_ln) ** 2)
    return jnp.sum(jnp.where(mask, w * w_safe, 0.0))


def emissivity_observable_from_angles(spin, h_source, gamma, cosalpha, beta,
                                      dead, *, n_steps=3072, r0=5.0,
                                      sigma_ln=0.3, r_max=500.0):
    """Differentiable emissivity observable for an explicit angle set.

    The per-ray kernel shared by ``emissivity_gradient_pipeline`` (full grid,
    one device) and ``parallel.sharded_emissivity_gradient`` (angle arrays
    sharded over the ray mesh axis): lamppost constants -> differentiable RK4
    march -> GR redshift -> smooth radial emissivity observable. The angle
    arrays are static grid geometry (not differentiated); spin / h / gamma
    are the differentiable parameters.
    """
    from raytrace_tpu.geometry import isco_radius
    from raytrace_tpu.ops.redshift import apply_redshift, redshift_start
    from raytrace_tpu.rays import RAY_STATUS_DEST
    from raytrace_tpu.sources import point_source_from_angles

    rays = point_source_from_angles(
        (0.0, h_source, 1e-3, 0.0), V=0.0, spin=spin,
        cosalpha=cosalpha, beta=beta, dead=dead,
    )
    rays = redshift_start(rays, spin, V=0.0)
    out = trace_scan(rays, spin, method="rk4", r_max=r_max, n_steps=n_steps)
    out = apply_redshift(out, spin, V=-1.0)
    hit = (
        out.ok
        & ((out.status & RAY_STATUS_DEST) != 0)
        & (out.redshift > 0)
        & (out.r >= isco_radius(spin))
    )
    # stop_gradient on the mask: it is piecewise constant in the parameters;
    # its jumps are the chaotic separatrix noise the smooth observable
    # averages over.
    hit = lax.stop_gradient(hit)
    # Soft membership: near-separatrix rays are smoothly weighted out of the
    # VALUE, not just the gradient — a hard mask leaves the observable
    # sensitive to which side of the capture boundary each chaotic ray's
    # fp-noise-amplified trajectory lands on, which shifts it at the percent
    # level under mere re-fusion (the round-3 sharded-gradient jit hazard).
    # The weight is a smooth function of the pre-march constants, so it both
    # carries honest gradient terms and cannot itself move under
    # recompilation.
    w_stable = chaos_weight(
        separatrix_score(rays.k, rays.h, rays.Q, spin),
        launch_turning_scores(rays.r, rays.theta, rays.k, rays.h, rays.Q, spin),
    )
    g_safe = jnp.where(hit, out.redshift, 1.0)
    return smooth_radial_observable(
        out, hit, w_stable / g_safe**gamma, r0, sigma_ln
    )


def _line_profile_fold(out, spin, a_trace, r_disc, q, e_rest, energies,
                       sigma_e):
    """Shared post-march fold of the two line-profile observables: disc-hit
    mask, chaos weight, flux epsilon(r)/g^3, Gaussian energy kernel. ONE
    definition — the grid-based (line_profile_observable) and sharded
    (line_profile_from_xy) fitting paths must stay bit-identical here or
    the multi-chip fit diverges from its single-chip twin (round-4
    advice)."""
    from raytrace_tpu.geometry import isco_radius
    from raytrace_tpu.geometry.kerr import bl_to_cartesian

    g = out.redshift
    _, _, z = bl_to_cartesian(out.r, out.theta, out.phi, spin)
    hit = (
        out.ok & (z < 1e-2) & (out.r >= isco_radius(spin))
        & (out.r < r_disc) & (g > 0)
    )
    hit = lax.stop_gradient(hit)
    w = chaos_weight(separatrix_score(out.k, out.h, out.Q, a_trace))

    g_safe = jnp.where(hit, g, 1.0)
    r_safe = jnp.where(hit, out.r, 1.0)
    flux = jnp.where(hit, w * r_safe ** (-q) / g_safe**3, 0.0)
    e_obs = e_rest / g_safe
    kern = jnp.exp(-0.5 * ((energies[None, :] - e_obs[:, None]) / sigma_e) ** 2)
    return jnp.sum(flux[:, None] * kern, axis=0)


def line_profile_observable(spin, incl_deg, grid, *, dist=500.0, r_disc=50.0,
                            q=3.0, e_rest=1.0, energies=None, sigma_e=0.035,
                            n_steps=2048, checkpoint_every=64):
    """Differentiable relativistic line profile P(E; spin, incl).

    The science target of the gradient north star: fitting observed
    iron-K line shapes for spin and inclination. Folds a backward-traced
    image plane through the differentiable march into a smooth observed
    line profile — each disc-hitting ray contributes its flux
    epsilon(r)/g^3 at observed energy e_rest/g under a Gaussian energy
    kernel (the smooth analogue of the histogram fold in
    apps/line_profile.py::line_profile_from_maps, itself the
    python/line_from_image.ipynb capability; per-pixel accumulation
    reference: imageplane_disc_image.cpp:146-153).

    Both ``spin`` and ``incl_deg`` are differentiable: traced parameters
    route image_plane through its all-traced construction, and the march
    is the checkpointed trace_scan. The hit mask is stop-gradded
    (piecewise constant); near-separatrix rays are chaos_weight-suppressed
    from the value so the profile is recompilation-robust like the
    emissivity observable. Launch turning points cannot occur on an image
    plane (pr = -D/r < 0 everywhere, and the y = 0 polar knife edge is
    already floored in the source), so only the separatrix score applies.

    Returns the [n_e] profile for ``energies`` (default: 48 points spanning
    0.3..1.3 e_rest, the classic broad-line window).
    """
    from raytrace_tpu.ops.redshift import apply_redshift, redshift_start
    from raytrace_tpu.sources import image_plane

    if energies is None:
        energies = jnp.linspace(0.3 * e_rest, 1.3 * e_rest, 48)
    a_trace = -spin
    rays = image_plane(dist, incl_deg, grid, spin)
    rays = redshift_start(rays, a_trace, V=0.0, reverse=True)
    out = trace_scan(rays, a_trace, method="rk4", r_max=1.1 * dist,
                     n_steps=n_steps, checkpoint_every=checkpoint_every)
    out = apply_redshift(out, a_trace, V=-1.0, reverse=True)

    return _line_profile_fold(out, spin, a_trace, r_disc, q, e_rest,
                              energies, sigma_e)


def line_profile_from_xy(spin, incl_deg, x, y, dead=None, *, dist=500.0,
                         r_disc=50.0, q=3.0, e_rest=1.0, energies=None,
                         sigma_e=0.035, n_steps=2048, checkpoint_every=64):
    """line_profile_observable over EXPLICIT plane coordinates.

    The per-shard kernel for the multi-chip fitting step
    (parallel.sharded_line_profile_fit_step): camera (x, y) arrays can be
    sharded over the ray mesh axis, ``dead`` marks padding rows (excluded
    from the profile), and the ray construction is all-traced (gradients
    flow through spin AND incl). Traced construction computes the starting
    conditions in the working dtype — in f32 that is adequate for
    dist up to ~1e3 (sources/imageplane.py's precision envelope); the
    far-field f64-seeded path is the grid-based wrapper below.
    """
    from raytrace_tpu.ops.redshift import apply_redshift, redshift_start
    from raytrace_tpu.sources.imageplane import _batch_from_parts, _plane_ray

    ftype = jnp.result_type(x)
    if energies is None:
        energies = jnp.linspace(0.3 * e_rest, 1.3 * e_rest, 48)
    a_trace = -spin
    incl = jnp.asarray(incl_deg, ftype) * jnp.pi / 180.0
    parts = _plane_ray(x, y, jnp.asarray(dist, ftype), incl,
                       jnp.asarray(0.0, ftype), a_trace, ftype)
    rays = _batch_from_parts(parts, x, y, ftype)
    if dead is not None:
        rays = rays.replace(
            steps=jnp.where(dead, jnp.full_like(rays.steps, -1), rays.steps)
        )
    rays = redshift_start(rays, a_trace, V=0.0, reverse=True)
    out = trace_scan(rays, a_trace, method="rk4", r_max=1.1 * dist,
                     n_steps=n_steps, checkpoint_every=checkpoint_every)
    out = apply_redshift(out, a_trace, V=-1.0, reverse=True)

    return _line_profile_fold(out, spin, a_trace, r_disc, q, e_rest,
                              energies, sigma_e)


def emissivity_binned_profile(spin, h_source, gamma, grid, *, r_min=None,
                              r_disc=500.0, n_r=100, logbin_r=True,
                              n_steps=6144, r_max=1000.0, method="rk4",
                              checkpoint_every=64):
    """Differentiable twin of ``apps.emissivity.compute``'s binned output.

    Same bins, same hit criterion (apps.emissivity.disc_hit_mask), same
    per-ray emissivity weight 1/g^gamma and proper-area normalisation as
    the app — but marched with trace_scan so the profile is differentiable
    with respect to (spin, h_source, gamma). The hit mask and bin
    assignment are stop-gradiented: they are piecewise constant in the
    parameters, and their jump contributions (rays migrating between bins)
    are exactly what the reference-FD validation methodology gates out
    (count-gated bins / smooth radial functionals — tests/test_diff.py).

    Returns (emis, counts): per-bin area-normalised emissivity [n_r] and
    ray counts [n_r].
    """
    from raytrace_tpu.apps.emissivity import disc_hit_mask
    from raytrace_tpu.geometry import integrate_disc_area_bins, isco_radius
    from raytrace_tpu.ops.redshift import apply_redshift, redshift_start
    from raytrace_tpu.ops.reductions import bin_edges, radial_bin_profile
    from raytrace_tpu.sources import grid_angles, point_source_from_angles

    rmin = isco_radius(spin) if r_min is None else r_min
    disc_r, disc_width, dr = bin_edges(rmin, r_disc, n_r, logbin_r)
    areas = integrate_disc_area_bins(disc_r, disc_r + disc_width, spin)

    cosalpha, beta, dead = grid_angles(grid)
    rays = point_source_from_angles(
        (0.0, h_source, 1e-3, 0.0), V=0.0, spin=spin,
        cosalpha=cosalpha, beta=beta, dead=dead,
    )
    rays = redshift_start(rays, spin, V=0.0)
    out = trace_scan(rays, spin, method=method, r_max=r_max, n_steps=n_steps,
                     checkpoint_every=checkpoint_every)
    out = apply_redshift(out, spin, V=-1.0)
    mask = lax.stop_gradient(disc_hit_mask(out, spin))
    g = jnp.where(mask, out.redshift, 1.0)
    counts, sums = radial_bin_profile(
        lax.stop_gradient(out.r), mask, {"emis": 1.0 / g**gamma},
        rmin, dr, n_r, logbin_r,
    )
    return sums["emis"] / areas, counts


def emissivity_gradient_pipeline(spin, h_source, gamma, grid, *, n_steps=3072,
                                 r0=5.0, sigma_ln=0.3, r_max=500.0):
    """End-to-end differentiable emissivity observable E(spin, h, gamma).

    Builds the lamppost, marches with the differentiable RK4 core, applies
    the GR redshift, and evaluates the smooth radial emissivity observable.
    All three arguments are differentiable; use jax.grad on this directly.
    """
    from raytrace_tpu.sources import grid_angles

    cosalpha, beta, dead = grid_angles(grid)
    return emissivity_observable_from_angles(
        spin, h_source, gamma, cosalpha, beta, dead,
        n_steps=n_steps, r0=r0, sigma_ln=sigma_ln, r_max=r_max,
    )
