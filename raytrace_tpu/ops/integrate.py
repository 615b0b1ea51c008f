"""Batched null-geodesic integration in the Kerr spacetime.

The batched replacement for the reference's per-ray propagators
(``src/raytracer/raytracer.cpp``): instead of an OpenMP loop over rays each
running its own data-dependent while loop, the whole ray batch is marched in
lock-step by one ``lax.while_loop`` whose body advances every ray one step
under masks. Finished rays are frozen; the loop exits when every ray is done
(or the step limit is reached). All three reference integrators are provided:

  * ``euler`` — semi-analytic first order: momenta re-derived algebraically
    from the conserved (k, h, Q) each step, only positions integrated
    (raytracer.cpp:129-340).
  * ``rk4`` — classical RK4 on positions, stage momenta from the constants
    (raytracer.cpp:755-970).
  * ``rk45`` — adaptive Dormand-Prince DOPRI5 with per-lane step size and
    per-lane accept/reject folded into the lock-step loop: a rejected lane
    simply keeps its state and retries with the shrunk step on the next
    iteration (raytracer.cpp:1260-1598).

The radial/polar turning-point bookkeeping (sign flips of the square-rooted
rates, gated on the squared rate having previously been positive), the polar
axis reflection, the ergosphere / negative-Killing-energy diagnostics, the
horizon step-cap for DOPRI5's negative tableau coefficients, and the
stuck-ray step-limit negation all follow the reference semantics; see the
inline citations.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from raytrace_tpu.destinations import Destination, ThetaLimit
from raytrace_tpu.geometry.kerr import geodesic_rates, horizon_radius, momentum_from_consts
from raytrace_tpu.ops.compaction import auto_schedule, run_phases
from raytrace_tpu.rays import (
    RAY_STATUS_DEST,
    RAY_STATUS_ERGO,
    RAY_STATUS_HORIZON,
    RAY_STATUS_NEG_ENERGY,
    RAY_STATUS_NUMERIC,
    RAY_STATUS_RLIM,
    RAY_STATUS_STEPLIM,
    RayBatch,
)

# Reference step limits (raytracer.h:30-39): adaptive steps are much larger,
# so legitimate RK45 rays finish in far fewer steps and stuck photon-sphere
# rays can be cut off 100x earlier.
STEPLIM = 10_000_000
RK45_STEPLIM = 100_000

_PI = jnp.pi
_HALF_PI = jnp.pi / 2


@dataclasses.dataclass(frozen=True)
class StepControl:
    """Static step-size tuning constants (raytracer.h:18-46).

    These are compile-time constants of the traced program (hashable, used as
    a static jit argument); the physical parameters (spin, limits, destination
    geometry) stay traced.
    """

    precision: float = 100.0
    theta_precision: float = 50.0
    max_tstep: float = 1.0  # MAXDT: cap on coordinate-time step ...
    maxtstep_rlim: float = 100.0  # ... applied only inside this radius
    max_phistep: float = 0.1  # MAXDPHI
    min_step: float = 1e-3  # MIN_STEP
    rk45_tol: float = 1e-8  # DOPRI5 mixed abs/rel error tolerance
    # Relative thickness of the horizon-capture shell: rays inside
    # r <= r_h * (1 + horizon_eps) are classified RAY_STATUS_HORIZON.
    # In Boyer-Lindquist coordinates infalling rays only reach the horizon
    # asymptotically; the reference's Euler/RK4 cross it numerically thanks
    # to the MIN_STEP floor, while its RK45 horizon-cap makes them creep at
    # (r - r_h)/precision per step until the step limit eats them
    # (raytracer.cpp:1412-1434 + RK45_STEPLIM) — equally excluded from
    # science output, but in a lock-step batch those creeping lanes dominate
    # wall-clock. The shell stops them in O(10^3) steps instead of 10^5.
    # 1e-6 is far inside any photon-sphere turning radius even at a = 0.998
    # (prograde r_ph - r_h ~ 1e-2).
    horizon_eps: float = 1e-6
    safety: float = 0.9  # Hairer-Wanner controller constants
    fac_min: float = 0.1
    fac_max: float = 5.0


# ---------------------------------------------------------------------------
# DOPRI5 Butcher tableau (Dormand & Prince 1980). b2 = 0 so stage 2 drops out
# of the 5th-order solution; e_i = b_i - b*_i give the embedded error.
# ---------------------------------------------------------------------------
_A21 = 1 / 5
_A31, _A32 = 3 / 40, 9 / 40
_A41, _A42, _A43 = 44 / 45, -56 / 15, 32 / 9
_A51, _A52, _A53, _A54 = 19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729
_A61, _A62, _A63, _A64, _A65 = 9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656
_B1, _B3, _B4, _B5, _B6 = 35 / 384, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84
_E1, _E3, _E4, _E5, _E6, _E7 = (
    71 / 57600,
    -71 / 16695,
    71 / 1920,
    -17253 / 339200,
    22 / 525,
    -1 / 40,
)


def _k1_stage(st: RayBatch, spin, rates=None):
    """First-stage momenta with the turning-point sign bookkeeping.

    Returns (updated signs/gates/flip info, stage momenta). A lane where the
    polar rate went negative while its gate was open flips its theta sign and
    *skips this step entirely* — the reference's ``continue``
    (raytracer.cpp:196-201); everything downstream must mask on
    ``~theta_flip``.

    ``rates`` is the optional FSAL carry: GeodesicRates already evaluated
    at this lane's CURRENT position (a rejected trial's k1, or an accepted
    trial's k7 — DOPRI5's first-same-as-last property). Reusing it skips
    one of the seven stage evaluations per RK45 iteration. The carried
    values are bitwise what a fresh evaluation would produce: everything
    except pr/ptheta is sign-independent, pr is re-signed below (abs *
    rdot_sign, as always), and ptheta is re-signed here against the lane's
    current polar sign (geodesic_rates computes sqrt(...) * sign, so
    |carried| * current_sign == recomputed).
    """
    if rates is None:
        rates = geodesic_rates(st.r, st.theta, st.k, st.h, st.Q, st.rdot_sign, st.thetadot_sign, spin)
    else:
        rates = rates._replace(ptheta=jnp.abs(rates.ptheta) * st.thetadot_sign)

    theta_flip = (rates.thetadot_sq < 0) & st.theta_was_positive
    thetadot_sign = jnp.where(theta_flip, -st.thetadot_sign, st.thetadot_sign)
    theta_was_positive = ~theta_flip & (rates.thetadot_sq >= 0)

    r_flip = (rates.rdot_sq <= 0) & st.r_was_positive & ~theta_flip
    rdot_sign = jnp.where(r_flip, -st.rdot_sign, st.rdot_sign)
    # boolean select via logic ops (no select_n on booleans)
    r_was_positive = (theta_flip & st.r_was_positive) | (~theta_flip & (rates.rdot_sq > 0))

    # pr is taken with the *new* radial sign (the flip happens before the
    # square root, raytracer.cpp:211-222); ptheta keeps the old sign (flip
    # lanes never use it this step).
    pr1 = jnp.abs(rates.pr) * rdot_sign
    return (
        theta_flip,
        r_flip,
        rdot_sign,
        thetadot_sign,
        r_was_positive,
        theta_was_positive,
        rates.pt,
        pr1,
        rates.ptheta,
        rates.pphi,
        rates,
    )


def _nonphysical_status(st, spin, pt1, pphi1, active, rates):
    """ERGO (p^t <= 0) and negative-Killing-energy flags (raytracer.cpp:263-273).

    Reuses the k1 stage's sin/cos/1/rhosq (per-step hot path)."""
    sin_t, inv_rhosq = rates.sin_t, rates.inv_rhosq
    killing = (1.0 - 2.0 * st.r * inv_rhosq) * pt1 + (
        2.0 * spin * st.r * sin_t * sin_t * inv_rhosq
    ) * pphi1
    status = st.status
    status = status | _flag(active & (pt1 <= 0), RAY_STATUS_ERGO)
    status = status | _flag(active & (killing < 0), RAY_STATUS_NEG_ENERGY)
    return status


def _base_step_size(st, horizon, pt1, pr1, ptheta1, pphi1, rlim, ctrl: StepControl):
    """Fixed-step heuristic shared by Euler and RK4 (raytracer.cpp:224-243):
    distance-to-horizon over radial speed, polar cap, coordinate-time cap
    inside maxtstep_rlim, azimuthal cap, MIN_STEP floor, rlim overshoot clamp.
    """
    # zero rates only occur exactly at turning points; guard the divisions
    # so their (discarded) branches cannot poison reverse-mode gradients
    step = jnp.abs(_safe_div(st.r - horizon, pr1)) / ctrl.precision
    theta_cap = jnp.abs(_safe_div(st.theta, ptheta1))
    step = jnp.where(step > theta_cap / ctrl.precision, theta_cap / ctrl.theta_precision, step)
    if ctrl.max_tstep > 0:
        t_cap = jnp.abs(_safe_div(ctrl.max_tstep, pt1))
        step = jnp.where((st.r < ctrl.maxtstep_rlim) & (step > t_cap), t_cap, step)
    if ctrl.max_phistep > 0:
        phi_cap = jnp.abs(_safe_div(ctrl.max_phistep, pphi1))
        step = jnp.where(step > phi_cap, phi_cap, step)
    step = jnp.maximum(step, ctrl.min_step)
    step = jnp.where(
        (rlim > 0) & (st.r + pr1 * step > rlim), jnp.abs(_safe_div(rlim - st.r, pr1)), step
    )
    return step


def _polar_reflect(theta, phi, thetadot_sign):
    """Reflect at the polar axes, clamping theta to [0, pi] and rotating phi
    by pi (raytracer.cpp:281-283)."""
    low = theta < 0
    high = theta > _PI
    theta = jnp.where(low, -theta, jnp.where(high, 2 * _PI - theta, theta))
    phi = jnp.where(low | high, phi + _PI, phi)
    thetadot_sign = jnp.where(low | high, -thetadot_sign, thetadot_sign)
    return theta, phi, thetadot_sign


def _commit(st: RayBatch, spin, dest, rlim, horizon, steplim, horizon_eps, commit_mask, new_pos, new_mom, signs, counters):
    """Apply an accepted step for the lanes in commit_mask and update status.

    new_pos = (t, r, theta, phi); new_mom = (pt, pr, ptheta, pphi) to store;
    signs = (rdot_sign, thetadot_sign, r_was_positive, theta_was_positive);
    counters = (step_counted_mask, rdot_flip_mask).
    """
    t_n, r_n, th_n, ph_n = new_pos
    pt_n, pr_n, pth_n, pph_n = new_mom
    rdot_sign, thetadot_sign, rwp, twp = signs
    counted, r_flip = counters

    prev_theta = st.theta
    sel = lambda new, old: jnp.where(commit_mask, new, old)

    t = sel(t_n, st.t)
    r = sel(r_n, st.r)
    theta = sel(th_n, st.theta)
    phi = sel(ph_n, st.phi)

    crossed_eq = commit_mask & (
        ((prev_theta < _HALF_PI) & (theta >= _HALF_PI))
        | ((prev_theta > _HALF_PI) & (theta <= _HALF_PI))
    )

    steps = st.steps + counted.astype(st.steps.dtype)
    rdot_flips = st.rdot_flips + (r_flip & counted).astype(st.rdot_flips.dtype)
    eq_cross = st.equatorial_crossings + crossed_eq.astype(st.equatorial_crossings.dtype)

    # Termination checks on freshly-advanced lanes (raytracer.cpp:287-320).
    # The capture shell is floored at 200 ulp of the working dtype: the RK45
    # horizon step-cap approaches the horizon geometrically at
    # (r - r_h)/precision per step, which stalls once that falls below one
    # ulp of r (~precision * eps relative) — in f32 that stall distance
    # (~1.2e-5) is OUTSIDE the f64-calibrated 1e-6 shell, so infalling rays
    # would creep forever and burn the whole step budget as STEPLIM. 200 eps
    # is 2.4e-5 in f32 (far inside the a=0.998 prograde photon orbit at
    # r_ph - r_h ~ 1e-2) and 4.4e-14 in f64 (inert: 1e-6 dominates).
    eps_eff = jnp.maximum(
        jnp.asarray(horizon_eps, r.dtype), 200 * jnp.finfo(r.dtype).eps
    )
    hit_horizon = commit_mask & (r <= horizon * (1.0 + eps_eff))
    hit_rlim = commit_mask & ~hit_horizon & (rlim > 0) & (r >= rlim)
    hit_dest = commit_mask & ~hit_horizon & ~hit_rlim & dest.reached(r, theta, phi, prev_theta)
    status = st.status
    status = status | _flag(hit_horizon, RAY_STATUS_HORIZON)
    status = status | _flag(hit_rlim, RAY_STATUS_RLIM)
    status = status | _flag(hit_dest, RAY_STATUS_DEST)

    # Stuck rays: when the per-ray step budget is exhausted, flag and stop.
    active_after = (steps >= 0) & (
        (status & (RAY_STATUS_DEST | RAY_STATUS_HORIZON | RAY_STATUS_RLIM)) == 0
    )
    stuck = active_after & (steps >= steplim)
    status = status | _flag(stuck, RAY_STATUS_STEPLIM)

    return st.replace(
        t=t,
        r=r,
        theta=theta,
        phi=phi,
        pt=sel(pt_n, st.pt),
        pr=sel(pr_n, st.pr),
        ptheta=sel(pth_n, st.ptheta),
        pphi=sel(pph_n, st.pphi),
        rdot_sign=rdot_sign,
        thetadot_sign=thetadot_sign,
        r_was_positive=rwp,
        theta_was_positive=twp,
        steps=steps,
        status=status,
        rdot_flips=rdot_flips,
        equatorial_crossings=eq_cross,
    )


def _flag(mask, flag):
    """Status-bit contribution as int32 (a bare Python int in jnp.where
    becomes int64 under x64, which the f32 kernel must not see)."""
    return jnp.where(mask, jnp.int32(flag), jnp.int32(0))


def _safe_div(num, den):
    """num / den with the denominator bounded away from exact zero.

    The bound is the dtype's smallest normal so it never changes a nonzero
    denominator; both branches are cast to den's dtype (a bare Python-float
    jnp.where would weak-promote the whole expression to f64 under x64 —
    breaking the f32 kernel path). Both signed bounds are host constants:
    the Triton lowering cannot negate a literal.
    """
    tiny = jnp.finfo(den.dtype).tiny
    t = jnp.asarray(tiny, den.dtype)
    safe = jnp.where(
        jnp.abs(den) < t, jnp.where(den < 0, jnp.asarray(-tiny, den.dtype), t), den
    )
    return num / safe


def _k1_finite(pt1, pr1, ptheta1, pphi1):
    """Lanes whose first-stage rates over/underflowed the working dtype.

    A lane with non-finite k1 can never advance (every retry re-evaluates
    the same poisoned point), so it must be flagged RAY_STATUS_NUMERIC and
    frozen — otherwise it rejects forever and a single lane pins the whole
    lock-step batch to max_iters (observed: f32 knife-edge rays driven onto
    the polar axis burning 125k iterations for a 2k-step ensemble).
    """
    return (
        jnp.isfinite(pt1)
        & jnp.isfinite(pr1)
        & jnp.isfinite(ptheta1)
        & jnp.isfinite(pphi1)
    )


def _safe_eval_state(st: RayBatch, active):
    """Give inactive lanes a benign evaluation point.

    Frozen and dead-padding lanes still flow through every rate evaluation
    each iteration; at degenerate positions (r = 0 padding, near-horizon
    endpoints) those produce inf/NaN which the masked `where` commits would
    discard in the forward pass but which poison reverse-mode gradients
    (0 * NaN). Evaluating them at a harmless point changes nothing visible
    — their results are never committed — and keeps the VJP finite.
    """
    one = jnp.ones_like(st.k)
    return st.replace(
        r=jnp.where(active, st.r, 10.0 * one),
        theta=jnp.where(active, st.theta, 1.0 * one),
        # padding rays carry k = h = Q = 0, for which every sqrt in the rate
        # evaluation sits exactly at its branch point (infinite VJP); unit
        # energy is harmless since nothing they produce is committed
        k=jnp.where(active, st.k, one),
        h=jnp.where(active, st.h, 0.0 * one),
        Q=jnp.where(active, st.Q, one),
    )


def _euler_rk4_body(st: RayBatch, spin, horizon, dest, rlim, steplim, ctrl, method, active):
    st_eval = _safe_eval_state(st, active)
    (
        theta_flip,
        r_flip,
        rdot_sign,
        thetadot_sign,
        rwp,
        twp,
        pt1,
        pr1,
        ptheta1,
        pphi1,
        rates1,
    ) = _k1_stage(st_eval, spin)

    advance = active & ~theta_flip
    status = _nonphysical_status(st_eval, spin, pt1, pphi1, advance, rates1)
    k1_bad = advance & ~_k1_finite(pt1, pr1, ptheta1, pphi1)
    advance = advance & ~k1_bad
    status = status | _flag(k1_bad, RAY_STATUS_NUMERIC)
    st = st.replace(status=status)

    step = _base_step_size(st_eval, horizon, pt1, pr1, ptheta1, pphi1, rlim, ctrl)
    # The plain thetalim mode additionally clamps the final step onto the disc
    # plane (raytracer.cpp:243); destination mode does not (RK4-dest variant,
    # raytracer.cpp:1036-1254).
    if isinstance(dest, ThetaLimit):
        lim = dest.step_limit(st_eval.r, st_eval.theta, st_eval.phi, pr1, ptheta1, pphi1)
        step = jnp.minimum(step, lim)

    if method == "euler":
        t_n = st.t + pt1 * step
        r_n = st_eval.r + pr1 * step
        th_raw = st_eval.theta + ptheta1 * step
        ph_n = st.phi + pphi1 * step
        mom = (pt1, pr1, ptheta1, pphi1)
    else:  # rk4
        half = step / 2
        pt2, pr2, pth2, pph2 = momentum_from_consts(
            st_eval.r + half * pr1, st_eval.theta + half * ptheta1, st.k, st.h, st.Q, rdot_sign, thetadot_sign, spin
        )
        pt3, pr3, pth3, pph3 = momentum_from_consts(
            st_eval.r + half * pr2, st_eval.theta + half * pth2, st.k, st.h, st.Q, rdot_sign, thetadot_sign, spin
        )
        pt4, pr4, pth4, pph4 = momentum_from_consts(
            st_eval.r + step * pr3, st_eval.theta + step * pth3, st.k, st.h, st.Q, rdot_sign, thetadot_sign, spin
        )
        w = step / 6
        t_n = st.t + w * (pt1 + 2 * pt2 + 2 * pt3 + pt4)
        r_n = st_eval.r + w * (pr1 + 2 * pr2 + 2 * pr3 + pr4)
        th_raw = st_eval.theta + w * (ptheta1 + 2 * pth2 + 2 * pth3 + pth4)
        ph_n = st.phi + w * (pphi1 + 2 * pph2 + 2 * pph3 + pph4)
        mom = (pt4, pr4, pth4, pph4)

    th_n, ph_n, thetadot_sign_r = _polar_reflect(th_raw, ph_n, thetadot_sign)
    thetadot_sign = jnp.where(advance, thetadot_sign_r, thetadot_sign)

    # Sign/gate state updates apply to every active lane (flip lanes update
    # their signs without moving); position commits only on advancing lanes.
    signs = (
        jnp.where(active, rdot_sign, st.rdot_sign),
        jnp.where(active, thetadot_sign, st.thetadot_sign),
        (active & rwp) | (~active & st.r_was_positive),
        (active & twp) | (~active & st.theta_was_positive),
    )
    return _commit(
        st,
        spin,
        dest,
        rlim,
        horizon,
        steplim,
        ctrl.horizon_eps,
        advance,
        (t_n, r_n, th_n, ph_n),
        mom,
        signs,
        (active, r_flip),
    ), None


def _rk45_body(st: RayBatch, spin, horizon, dest, rlim, steplim, ctrl, active,
               step, rates):
    """One lock-step DOPRI5 iteration.

    ``rates`` is the packed FSAL carry (_pack_rates layout, seeded by
    _seed_rk45_rates): GeodesicRates already evaluated at each lane's
    current position. Returns (st, step, rates_next)."""
    st_eval = _safe_eval_state(st, active)
    (
        theta_flip,
        r_flip,
        rdot_sign,
        thetadot_sign,
        rwp,
        twp,
        pt1,
        pr1,
        ptheta1,
        pphi1,
        rates1,
    ) = _k1_stage(st_eval, spin, _unpack_rates(rates))

    advance = active & ~theta_flip
    status = _nonphysical_status(st_eval, spin, pt1, pphi1, advance, rates1)
    k1_bad = advance & ~_k1_finite(pt1, pr1, ptheta1, pphi1)
    advance = advance & ~k1_bad
    st = st.replace(status=status | _flag(k1_bad, RAY_STATUS_NUMERIC))

    # Horizon step-cap: DOPRI5's large negative tableau coefficients can push
    # intermediate stages inside the horizon where the error estimator cannot
    # see the corruption; cap the carried step by the same distance-to-horizon
    # heuristic (plus phi/t caps) every iteration (raytracer.cpp:1412-1434).
    step_max = jnp.abs(_safe_div(st_eval.r - horizon, pr1)) / ctrl.precision
    if ctrl.max_phistep > 0:
        step_max = jnp.minimum(step_max, jnp.abs(_safe_div(ctrl.max_phistep, pphi1)))
    if ctrl.max_tstep > 0:
        step_max = jnp.where(
            st_eval.r < ctrl.maxtstep_rlim,
            jnp.minimum(step_max, jnp.abs(_safe_div(ctrl.max_tstep, pt1))),
            step_max,
        )
    step = jnp.where(advance & (step > step_max), step_max, step)

    # Clamp the trial step so the destination surface is not overshot; a
    # clamped accepted step does not update the running step size
    # (raytracer.cpp:1442-1453, 1752-1755).
    lim = dest.step_limit(st_eval.r, st_eval.theta, st_eval.phi, pr1, ptheta1, pphi1)
    clamped = lim < step
    h_try = jnp.where(clamped, lim, step)

    k, h, Q = st.k, st.h, st.Q
    stage = partial(
        momentum_from_consts, k=k, h=h, Q=Q, rdot_sign=rdot_sign, thetadot_sign=thetadot_sign, a=spin
    )

    def at(dr, dth):
        return stage(st_eval.r + h_try * dr, st_eval.theta + h_try * dth)

    pt2, pr2, pth2, pph2 = at(_A21 * pr1, _A21 * ptheta1)
    pt3, pr3, pth3, pph3 = at(_A31 * pr1 + _A32 * pr2, _A31 * ptheta1 + _A32 * pth2)
    pt4, pr4, pth4, pph4 = at(
        _A41 * pr1 + _A42 * pr2 + _A43 * pr3,
        _A41 * ptheta1 + _A42 * pth2 + _A43 * pth3,
    )
    pt5, pr5, pth5, pph5 = at(
        _A51 * pr1 + _A52 * pr2 + _A53 * pr3 + _A54 * pr4,
        _A51 * ptheta1 + _A52 * pth2 + _A53 * pth3 + _A54 * pth4,
    )
    pt6, pr6, pth6, pph6 = at(
        _A61 * pr1 + _A62 * pr2 + _A63 * pr3 + _A64 * pr4 + _A65 * pr5,
        _A61 * ptheta1 + _A62 * pth2 + _A63 * pth3 + _A64 * pth4 + _A65 * pth5,
    )

    # 5th-order solution (b2 = 0): positions only, then reflect, then the
    # FSAL stage k7 at the new point for the error estimate.
    r_new = st_eval.r + h_try * (_B1 * pr1 + _B3 * pr3 + _B4 * pr4 + _B5 * pr5 + _B6 * pr6)
    th_new_raw = st_eval.theta + h_try * (
        _B1 * ptheta1 + _B3 * pth3 + _B4 * pth4 + _B5 * pth5 + _B6 * pth6
    )
    t_new = st.t + h_try * (_B1 * pt1 + _B3 * pt3 + _B4 * pt4 + _B5 * pt5 + _B6 * pt6)
    phi_new = st.phi + h_try * (
        _B1 * pphi1 + _B3 * pph3 + _B4 * pph4 + _B5 * pph5 + _B6 * pph6
    )

    th_new, phi_new, thetadot_sign_r = _polar_reflect(th_new_raw, phi_new, thetadot_sign)

    # FSAL stage k7 at the new point, as full GeodesicRates so accepted
    # lanes can carry it forward as the next iteration's k1
    rates7 = geodesic_rates(r_new, th_new, k, h, Q, rdot_sign, thetadot_sign, spin)
    pt7, pr7, pth7, pph7 = rates7.pt, rates7.pr, rates7.ptheta, rates7.pphi

    err_r = h_try * (_E1 * pr1 + _E3 * pr3 + _E4 * pr4 + _E5 * pr5 + _E6 * pr6 + _E7 * pr7)
    err_th = h_try * (
        _E1 * ptheta1 + _E3 * pth3 + _E4 * pth4 + _E5 * pth5 + _E6 * pth6 + _E7 * pth7
    )
    sc_r = ctrl.rk45_tol * (1.0 + jnp.maximum(jnp.abs(st_eval.r), jnp.abs(r_new)))
    sc_th = ctrl.rk45_tol * (1.0 + jnp.maximum(jnp.abs(st_eval.theta), jnp.abs(th_new)))
    err_norm = jnp.sqrt(0.5 * ((err_r / sc_r) ** 2 + (err_th / sc_th) ** 2))

    # A non-finite trial (stages wandered into an over/underflow region of
    # the working dtype) is treated as a maximal-error reject so the step
    # shrinks at fac_min instead of poisoning the carried step with NaN; a
    # lane whose trial is still non-finite AT the MIN_STEP floor has nowhere
    # left to go and is flagged numerically dead (terminal).
    trial_ok = (
        jnp.isfinite(err_norm)
        & jnp.isfinite(r_new)
        & jnp.isfinite(th_new)
        & jnp.isfinite(t_new)
        & jnp.isfinite(phi_new)
    )
    err_eff = jnp.where(trial_ok, err_norm, jnp.full_like(err_norm, 1e30))
    numeric_stuck = advance & ~trial_ok & (h_try <= ctrl.min_step)
    st = st.replace(status=st.status | _flag(numeric_stuck, RAY_STATUS_NUMERIC))

    fac = ctrl.safety * jnp.power(1.0 / jnp.maximum(err_eff, 1e-10), 0.2)
    fac = jnp.clip(fac, ctrl.fac_min, ctrl.fac_max)
    step_new = jnp.maximum(h_try * fac, ctrl.min_step)

    accept_err = err_eff <= 1.0
    force = ~accept_err & (step_new <= ctrl.min_step)
    accept = advance & (accept_err | force) & trial_ok

    # Carried step update (raytracer.cpp:1521-1539): accepted unclamped steps
    # adopt the controller prediction; accepted clamped steps keep the old
    # step; rejected lanes shrink.
    new_step = jnp.where(
        advance,
        jnp.where(accept_err & clamped, step, step_new),
        step,
    )

    thetadot_sign = jnp.where(accept, thetadot_sign_r, thetadot_sign)
    signs = (
        jnp.where(active, rdot_sign, st.rdot_sign),
        jnp.where(active, thetadot_sign, st.thetadot_sign),
        (active & rwp) | (~active & st.r_was_positive),
        (active & twp) | (~active & st.theta_was_positive),
    )
    counted = active & (theta_flip | accept)
    st = _commit(
        st,
        spin,
        dest,
        rlim,
        horizon,
        steplim,
        ctrl.horizon_eps,
        accept,
        (t_new, r_new, th_new, phi_new),
        (pt7, pr7, pth7, pph7),
        signs,
        (counted, r_flip),
    )
    # FSAL carry: accepted lanes' k7 is exactly the next k1; every other
    # lane (rejected trial, flip-skip, frozen) keeps its current-position
    # rates — both choices are bitwise what the next iteration would
    # recompute.
    rates_next = jax.tree.map(
        lambda a, b: jnp.where(accept, a, b),
        _pack_rates(rates7), _pack_rates(rates1),
    )
    # Frozen-lane hygiene: a lane that went inactive THIS iteration freezes
    # its last rates in the carry forever, bypassing the _safe_eval_state
    # pass active lanes get — if those rates are non-finite (f32 polar-axis
    # k1_bad, overflowed edge case) the inf rides the scan carry and 0*inf
    # in multiply transposes NaN-poisons ensemble gradients under
    # trace_scan(method="rk45"). Zero the non-finite entries of inactive
    # lanes only: bitwise no-op on every live lane and on the (overwhelming)
    # all-finite case.
    alive = st.active
    rates_next = jax.tree.map(
        lambda a: jnp.where(alive | jnp.isfinite(a), a, jnp.zeros_like(a)),
        rates_next,
    )
    return st, new_step, rates_next


def _pack_rates(r):
    """FSAL carry layout: only the GeodesicRates fields the next
    iteration's k1 stage and status flags consume. cos_t and rhosq are
    byproducts nothing downstream reads — carrying them through every
    while-loop iteration (two extra registers per ray in the GPU kernel)
    would be pure pressure."""
    return (r.pt, r.pr, r.ptheta, r.pphi, r.thetadot_sq, r.rdot_sq,
            r.sin_t, r.inv_rhosq)


def _unpack_rates(c):
    from raytrace_tpu.geometry.kerr import GeodesicRates

    pt, pr, ptheta, pphi, thetadot_sq, rdot_sq, sin_t, inv_rhosq = c
    # cos_t/rhosq slots are never read on the k1/status path; sin_t stands
    # in to keep the tuple well-formed
    return GeodesicRates(pt, pr, ptheta, pphi, thetadot_sq, rdot_sq,
                         sin_t, sin_t, sin_t, inv_rhosq)


def _fresh_propagation_state(rays: RayBatch, spin, horizon, method,
                             ctrl: StepControl) -> RayBatch:
    """Fresh-propagation setup shared by every driver: reset the per-
    propagation sign gates (propagator locals in the reference,
    raytracer.cpp:137-138) and seed the adaptive step for rk45. Resumed
    phases skip this — the gates and dt travel in-batch."""
    rays = rays.replace(
        r_was_positive=jnp.zeros_like(rays.r_was_positive),
        theta_was_positive=jnp.ones_like(rays.theta_was_positive),
    )
    if method == "rk45":
        rays = rays.replace(dt=_seed_rk45_step(rays, spin, horizon, ctrl))
    return rays


def _seed_rk45_rates(st: RayBatch, active, spin):
    """Seed the DOPRI5 FSAL carry (packed, _pack_rates layout): rates at
    each lane's current (safe-evaluated) position — what the first
    iteration's k1 stage would compute."""
    se = _safe_eval_state(st, active)
    return _pack_rates(
        geodesic_rates(se.r, se.theta, se.k, se.h, se.Q, se.rdot_sign,
                       se.thetadot_sign, spin)
    )


def _seed_rk45_step(st: RayBatch, spin, horizon, ctrl):
    """Initial adaptive step from the fixed-step heuristic (raytracer.cpp:1339-1359)."""
    rates = geodesic_rates(st.r, st.theta, st.k, st.h, st.Q, st.rdot_sign, st.thetadot_sign, spin)
    step = jnp.abs((st.r - horizon) / rates.pr) / ctrl.precision
    theta_cap = jnp.abs(st.theta / rates.ptheta)
    step = jnp.where(
        (jnp.abs(rates.ptheta) > 0) & (step > theta_cap / ctrl.theta_precision),
        theta_cap / ctrl.theta_precision,
        step,
    )
    if ctrl.max_tstep > 0:
        t_cap = jnp.abs(ctrl.max_tstep / rates.pt)
        step = jnp.where((st.r < ctrl.maxtstep_rlim) & (step > t_cap), t_cap, step)
    if ctrl.max_phistep > 0:
        phi_cap = jnp.abs(ctrl.max_phistep / rates.pphi)
        step = jnp.where(step > phi_cap, phi_cap, step)
    return jnp.maximum(step, ctrl.min_step)


@partial(
    jax.jit,
    static_argnames=("method", "steplim", "ctrl", "max_iters", "unroll", "resume", "refine_crossing"),
)
def trace(
    rays: RayBatch,
    spin,
    *,
    method: str = "rk45",
    dest: Destination = None,
    r_max=1000.0,
    steplim: int | None = None,
    ctrl: StepControl = StepControl(),
    boundary=None,
    max_iters: int | None = None,
    unroll: int = 1,
    resume: bool = False,
    refine_crossing: bool = True,
) -> RayBatch:
    """Propagate every ray to its destination / the horizon / the radial limit.

    Args:
      rays: the ray batch (from a source constructor). Rays with steps < 0
        are dead padding and are never advanced (pointsource.cpp:40-44).
      spin: black-hole spin a (traced; gradients flow through it). Image
        planes pass the *negated* spin here to implement time reversal.
      method: "euler" | "rk4" | "rk45".
      dest: termination surface (default ThetaLimit(pi/2), the equatorial
        disc plane).
      r_max: outer radial limit (RAY_STATUS_RLIM); <= 0 disables.
      steplim: per-ray step budget; defaults to the reference's
        RK45_STEPLIM / STEPLIM.
      ctrl: static step-size tuning constants.
      boundary: override the inner absorbing radius (e.g. a neutron-star
        surface, raytracer.h:152-162); defaults to the event horizon.
      max_iters: hard bound on lock-step iterations (defaults to steplim
        plus 25% headroom for RK45 rejection retries).
      unroll: body repetitions per while-loop iteration.
    """
    if dest is None:
        dest = ThetaLimit(jnp.pi / 2)
    if steplim is None:
        steplim = RK45_STEPLIM if method == "rk45" else STEPLIM
    if max_iters is None:
        max_iters = steplim + steplim // 4 + 16

    horizon = horizon_radius(spin) if boundary is None else boundary

    if not resume:
        rays = _fresh_propagation_state(rays, spin, horizon, method, ctrl)

    def cond(carry):
        st = carry[0]
        it = carry[2]
        return jnp.any(st.active) & (it < max_iters)

    def body(carry):
        if method == "rk45":
            st, step, it, rates = carry
            for _ in range(unroll):
                st, step, rates = _rk45_body(
                    st, spin, horizon, dest, r_max, steplim, ctrl, st.active,
                    step, rates,
                )
            return st, step, it + unroll, rates
        st, step, it = carry
        for _ in range(unroll):
            st, _ = _euler_rk4_body(
                st, spin, horizon, dest, r_max, steplim, ctrl, method, st.active
            )
        return st, step, it + unroll

    if method == "rk45":
        init = (rays, rays.dt, jnp.asarray(0, jnp.int32),
                _seed_rk45_rates(rays, rays.active, spin))
        final, step_f = lax.while_loop(cond, body, init)[:2]
    else:
        final, step_f, _ = lax.while_loop(
            cond, body, (rays, rays.dt, jnp.asarray(0, jnp.int32))
        )
    final = final.replace(dt=step_f)

    # Stuck rays get their step count negated so downstream steps > 0 filters
    # drop them (raytracer.cpp:336-337). Only freshly-stuck rays (positive
    # count) are negated — a resumed batch may already carry negated ones.
    stuck = (
        (final.status & (RAY_STATUS_STEPLIM | RAY_STATUS_NUMERIC)) != 0
    ) & (final.steps > 0)
    final = final.replace(steps=jnp.where(stuck, -final.steps, final.steps))

    if refine_crossing:
        final = _refine_theta_crossing(final, dest, spin)
    return final


def _refine_theta_crossing(st: RayBatch, dest, spin) -> RayBatch:
    """Back-interpolate destination hits onto the theta_lim surface.

    The last integrator step lands *past* the surface by up to its own step
    size; for polar-angle surfaces a linear correction along the final
    momentum removes that overshoot (position error drops from O(step) to
    O(step^2)). This beats the reference's raw landing (it has no such
    pass), which matters for finite-difference lensing Jacobians in the
    weak field where steps are large. Only theta-surface destinations
    qualify; others are returned unchanged.
    """
    theta_lim = getattr(dest, "theta_lim", None)
    if theta_lim is None:
        return st
    lim = jnp.where(theta_lim > 0, theta_lim, -theta_lim)
    hit = (st.status & RAY_STATUS_DEST) != 0
    # momenta evaluated at the final position (the stored ones can lag by a
    # stage for Euler/RK4)
    pt, pr, pth, pph = momentum_from_consts(
        st.r, st.theta, st.k, st.h, st.Q, st.rdot_sign, st.thetadot_sign, spin
    )
    safe_pth = jnp.where(pth == 0, 1.0, pth)
    delta = (st.theta - lim) / safe_pth
    ok = hit & (pth != 0) & (jnp.abs(delta) < 1.0)
    apply = lambda q, dq: jnp.where(ok, q - dq * delta, q)
    return st.replace(
        t=apply(st.t, pt),
        r=apply(st.r, pr),
        theta=jnp.where(ok, lim, st.theta),
        phi=apply(st.phi, pph),
    )


@partial(
    jax.jit,
    static_argnames=("method", "schedule", "steplim", "ctrl", "unroll"),
)
def _trace_fused_xla(
    rays, spin, dest, boundary, r_max, *, method, schedule, steplim, ctrl, unroll
):
    total = steplim + steplim // 4 + 16
    horizon = horizon_radius(spin) if boundary is None else boundary
    # Fresh-propagation setup happens once on the full batch (so a schedule
    # whose first phase is width-compacted still gets the gate reset and the
    # rk45 dt seeding); every phase below resumes.
    out = _fresh_propagation_state(rays, spin, horizon, method, ctrl)

    def phase(batch, s, iters, _block, _unroll):
        # block is the GPU kernel's launch shape; the XLA engine ignores it
        return trace(
            batch, s, method=method, dest=dest, r_max=r_max, steplim=steplim,
            ctrl=ctrl, boundary=boundary, max_iters=iters, unroll=unroll,
            resume=True, refine_crossing=False,
        )

    out = run_phases(out, spin, schedule, total, phase)
    return _refine_theta_crossing(out, dest, spin)


def trace_compacted(
    rays: RayBatch,
    spin,
    *,
    method: str = "rk45",
    dest: Destination = None,
    r_max=1000.0,
    steplim: int | None = None,
    ctrl: StepControl = StepControl(),
    boundary=None,
    phase_iters: int = 2048,
    min_batch: int = 256,
    unroll: int = 1,
    schedule=None,
    progress: bool = False,
) -> RayBatch:
    """trace() with fused phase compaction for heterogeneous ray lifetimes.

    In a lock-step batch a handful of stuck photon-sphere rays (the
    reference's RK45_STEPLIM pathology, docs/session_2026-03-01.md:105-137)
    force every iteration to process the full batch. This driver runs the
    shared static compaction schedule (ops/compaction.py): a full-width
    opening march of ``phase_iters`` iterations covering the p99 mass of
    rays, device-side gathers of the survivors into narrower sub-batches,
    and a full-width drain backstop — all inside ONE jitted program (no
    host round trips; the same schedule engine drives the Pallas kernel via
    trace_pallas_fused). ``min_batch`` floors the compacted widths.

    Semantics are identical to trace(): per-ray step counts, statuses and
    the adaptive dt are carried across phases.

    ``progress=True`` dispatches the schedule phase by phase from the host
    with a terminal progress bar between dispatches (the compiled analogue
    of the reference's in-loop progress bar, progress_bar.h:25-74 /
    raytracer.cpp:107-115) — a few extra host round trips, so the fused
    single-dispatch path stays the default.
    """
    if dest is None:
        dest = ThetaLimit(jnp.pi / 2)
    if steplim is None:
        steplim = RK45_STEPLIM if method == "rk45" else STEPLIM
    total = steplim + steplim // 4 + 16
    if schedule is None:
        schedule = tuple(
            (it, None if w is None else max(w, min_batch), block, u)
            for it, w, block, u in auto_schedule(
                rays.n_rays, total, open_iters=phase_iters
            )
        )
    if progress:
        return _trace_phased_progress(
            rays, spin, dest, boundary, r_max,
            method=method, schedule=tuple(tuple(p) for p in schedule),
            steplim=steplim, ctrl=ctrl, unroll=unroll, total=total,
        )
    return _trace_fused_xla(
        rays, spin, dest, boundary, r_max,
        method=method, schedule=tuple(tuple(p) for p in schedule),
        steplim=steplim, ctrl=ctrl, unroll=unroll,
    )


def _trace_phased_progress(
    rays, spin, dest, boundary, r_max, *, method, schedule, steplim, ctrl,
    unroll, total
):
    """Host-driven twin of _trace_fused_xla: same phases as the fused
    program (jitted trace() calls in resume mode), dispatched one by one
    through compaction.run_phases_progress for the progress bar."""
    from raytrace_tpu.ops.compaction import run_phases_progress

    horizon = horizon_radius(spin) if boundary is None else boundary
    out = _fresh_propagation_state(rays, spin, horizon, method, ctrl)

    def phase(batch, s, iters, _block, _unroll):
        return trace(
            batch, s, method=method, dest=dest, r_max=r_max, steplim=steplim,
            ctrl=ctrl, boundary=boundary, max_iters=iters, unroll=unroll,
            resume=True, refine_crossing=False,
        )

    out = run_phases_progress(out, spin, schedule, total, phase,
                              label=f"march[{method}] {rays.n_rays} rays")
    return _refine_theta_crossing(out, dest, spin)
