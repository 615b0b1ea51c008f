"""Pallas GPU kernel for the geodesic march, through Triton.

The XLA while-loop integrator streams the whole ~20-array ray state through
device memory on every lock-step iteration, and pays the loop condition for
the whole batch each time. This kernel marches each block of rays to
completion inside one ``pallas_call``: one ray per thread, its state held
in registers for the whole propagation, so device memory sees exactly one
load and one store per ray. Every program runs its own ``lax.while_loop``
and retires as soon as its own rays are done, so the long tail of
photon-sphere-orbiting rays costs iterations only for the blocks that hold
them.

The step math is the same ``_euler_rk4_body`` / ``_rk45_body`` used by the
XLA path (the helpers are pure jnp and trace identically inside the kernel),
so in interpret mode the two paths agree to f32 rounding
(tests/test_pallas.py). On the card, libdevice transcendentals and Triton's
f32 division differ from XLA's in the last bits, so chaotic photon-sphere
rays can change status: compare the two routes statistically.

The march runs in f32; the caller's dtype is restored at the boundary.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytrace_tpu.destinations import (
    DiscWithISCO,
    FlatPlane,
    SphericalShell,
    ThetaLimit,
)
from raytrace_tpu.geometry.kerr import horizon_radius
from raytrace_tpu.ops.compaction import auto_schedule, run_phases, run_phases_progress
from raytrace_tpu.ops.integrate import (
    StepControl,
    _euler_rk4_body,
    _fresh_propagation_state,
    _refine_theta_crossing,
    _rk45_body,
    _seed_rk45_rates,
)
from raytrace_tpu.rays import RAY_STATUS_NUMERIC, RAY_STATUS_STEPLIM, RayBatch

# Launch shape, from a block x unroll sweep on the H100 (PERF.md,
# "Findings"): 32 rays per program (one ray per thread, one warp) and one
# step body per while iteration, for RK4 and RK45 alike. A program iterates
# until its slowest ray ends, so the smallest block retires earliest;
# unrolling bought nothing and multiplied compile time.
BLOCK = 32
UNROLL = 1

# RayBatch fields marched by the kernel, in a fixed order. Signs travel as
# f32; the two sign gates travel as int32 and are booleans inside.
_F_FIELDS = (
    "t", "r", "theta", "phi", "pt", "pr", "ptheta", "pphi",
    "k", "h", "Q", "rdot_sign", "thetadot_sign", "dt", "emit",
)
_I_FIELDS = ("steps", "status", "rdot_flips", "equatorial_crossings")
_B_FIELDS = ("r_was_positive", "theta_was_positive")
_N_SCALARS = 8  # spin, r_max, horizon, 3 destination parameters, 2 spare


def _make_kernel(method, dest_kind, ctrl: StepControl, unroll: int):
    n_f, n_i, n_b = len(_F_FIELDS), len(_I_FIELDS), len(_B_FIELDS)

    def kernel(scalars_ref, limits_ref, *refs):
        spin = scalars_ref[0]
        r_max = scalars_ref[1]
        # termination radius: the event horizon, or a boundary override (a
        # neutron-star surface, raytracer.h:152-162) — the caller decides
        horizon = scalars_ref[2]
        p0 = scalars_ref[3]  # theta_lim | r_isco | incl   | r_shell
        p1 = scalars_ref[4]  # unused    | r_out  | phi0   | unused
        p2 = scalars_ref[5]  # unused    | th_lim | z_s    | unused
        # runtime step budgets: one compiled kernel per (method, destination)
        # serves every steplim and phase length
        steplim = limits_ref[0]
        max_iters = limits_ref[1]

        in_refs = refs[: n_f + n_i + n_b]
        out_refs = refs[n_f + n_i + n_b:]

        if dest_kind == "theta":
            dest = ThetaLimit(p0)
        elif dest_kind == "isco":
            dest = DiscWithISCO(r_isco=p0, r_out=p1, theta_lim=p2)
        elif dest_kind == "plane":
            dest = FlatPlane(incl=p0, phi0=p1, z_s=p2)
        elif dest_kind == "shell":
            dest = SphericalShell(r_shell=p0)
        else:
            raise ValueError(dest_kind)

        fields = {}
        for idx, name in enumerate(_F_FIELDS):
            fields[name] = in_refs[idx][...]
        for idx, name in enumerate(_I_FIELDS):
            fields[name] = in_refs[n_f + idx][...]
        for idx, name in enumerate(_B_FIELDS):
            fields[name] = in_refs[n_f + n_i + idx][...] != 0
        fields["alpha"] = jnp.zeros_like(fields["t"])
        fields["beta"] = jnp.zeros_like(fields["t"])
        fields["redshift"] = jnp.ones_like(fields["t"])
        st0 = RayBatch(**fields)

        def cond(carry):
            st, _, it = carry[:3]
            # block-wide reduction; int32 max rather than a boolean any
            alive = jnp.max(st.active.astype(jnp.int32)) > 0
            return alive & (it < max_iters)

        def body(carry):
            # unrolled sub-steps amortise the loop's block reduction; the
            # active mask is recomputed per sub-step, so semantics are
            # unchanged (a retired block overshoots the check by < unroll
            # iterations of masked no-ops)
            if method == "rk45":
                st, step, it, rates = carry
                for _ in range(unroll):
                    st, step, rates = _rk45_body(
                        st, spin, horizon, dest, r_max, steplim, ctrl,
                        st.active, step, rates,
                    )
                return st, step, it + unroll, rates
            st, step, it = carry
            for _ in range(unroll):
                st, _ = _euler_rk4_body(
                    st, spin, horizon, dest, r_max, steplim, ctrl, method,
                    st.active,
                )
            return st, step, it + unroll

        init = (st0, st0.dt, jnp.int32(0))
        if method == "rk45":
            init = init + (_seed_rk45_rates(st0, st0.active, spin),)
        final, step_f = lax.while_loop(cond, body, init)[:2]
        final = final.replace(dt=step_f)
        stuck = (
            (final.status & (RAY_STATUS_STEPLIM | RAY_STATUS_NUMERIC)) != 0
        ) & (final.steps > 0)
        final = final.replace(steps=jnp.where(stuck, -final.steps, final.steps))

        for idx, name in enumerate(_F_FIELDS):
            out_refs[idx][...] = getattr(final, name)
        for idx, name in enumerate(_I_FIELDS):
            out_refs[n_f + idx][...] = getattr(final, name)
        for idx, name in enumerate(_B_FIELDS):
            out_refs[n_f + n_i + idx][...] = getattr(final, name).astype(jnp.int32)

    return kernel


@partial(
    jax.jit,
    static_argnames=("method", "dest_kind", "ctrl", "block", "unroll"),
)
def _trace_pallas_padded(
    arrays, scalars, limits, *, method, dest_kind, ctrl, block, unroll
):
    n = arrays[0].shape[0]
    lanes = pl.BlockSpec((block,), lambda i: (i,))
    # Trace the kernel with x64 disabled: the package enables x64 globally
    # (for CPU/f64 accuracy), but under x64 bare Python scalars trace as
    # 64-bit constants and the step math would silently run in f64. Every
    # kernel input is explicitly f32/int32, so 32-bit weak typing is right.
    with jax.enable_x64(False):
        return pl.pallas_call(
            _make_kernel(method, dest_kind, ctrl, unroll),
            grid=(n // block,),
            in_specs=[
                pl.BlockSpec((_N_SCALARS,), lambda i: (0,)),
                pl.BlockSpec((2,), lambda i: (0,)),
            ] + [lanes] * len(arrays),
            out_specs=[lanes] * len(arrays),
            out_shape=[jax.ShapeDtypeStruct((n,), a.dtype) for a in arrays],
            backend="triton",
            compiler_params=plgpu.CompilerParams(
                num_warps=max(1, block // 32), num_stages=1
            ),
            name=f"march_{method}_{dest_kind}",
        )(scalars, limits, *arrays)


def _dest_params(dest):
    """(kernel destination kind, its three scalar parameters)."""
    if isinstance(dest, DiscWithISCO):
        return "isco", (dest.r_isco, dest.r_out, dest.theta_lim)
    if isinstance(dest, ThetaLimit):
        return "theta", (dest.theta_lim, 0.0, 0.0)
    if isinstance(dest, FlatPlane):
        return "plane", (dest.incl, dest.phi0, dest.z_s)
    if isinstance(dest, SphericalShell):
        return "shell", (dest.r_shell, 0.0, 0.0)
    raise NotImplementedError(
        "the march kernel supports ThetaLimit/DiscWithISCO/FlatPlane/"
        f"SphericalShell, got {type(dest)}"
    )


def trace_pallas(
    rays: RayBatch,
    spin,
    *,
    method: str = "rk4",
    dest=None,
    r_max=1000.0,
    steplim: int = 30_000,
    ctrl: StepControl = StepControl(),
    max_iters: int | None = None,
    resume: bool = False,
    refine_crossing: bool = True,
    block: int | None = None,
    unroll: int | None = None,
    boundary=None,
) -> RayBatch:
    """Kernel twin of trace() (f32; ThetaLimit / DiscWithISCO / FlatPlane /
    SphericalShell destinations, optional boundary override).

    Pads the batch to a whole number of ``block``-ray programs with dead
    rays and returns the same RayBatch contract as trace(), in the caller's
    dtype, including the final theta-crossing back-interpolation
    (idempotent, so applying it per compaction phase is safe).

    ``block``/``unroll`` default to ``BLOCK``/``UNROLL``. Each
    distinct (block, unroll, method, destination) combination compiles its
    own kernel; destination parameters, the boundary override and the step
    budgets are runtime scalars, so varying them never recompiles.
    """
    if dest is None:
        dest = ThetaLimit(jnp.pi / 2)
    dest_kind, params = _dest_params(dest)
    if max_iters is None:
        max_iters = steplim + steplim // 4 + 16
    block = BLOCK if block is None else block
    unroll = UNROLL if unroll is None else unroll

    n = rays.n_rays
    pad = (-n) % block
    f32 = jnp.float32

    def pad_to(a, fill=0):
        return jnp.pad(a, (0, pad), constant_values=fill) if pad else a

    horizon = horizon_radius(spin) if boundary is None else boundary
    if not resume:
        rays = _fresh_propagation_state(rays, spin, horizon, method, ctrl)

    arrays = (
        [pad_to(getattr(rays, f).astype(f32)) for f in _F_FIELDS]
        + [pad_to(getattr(rays, f).astype(jnp.int32), fill=-1 if f == "steps" else 0)
           for f in _I_FIELDS]
        + [pad_to(getattr(rays, f).astype(jnp.int32)) for f in _B_FIELDS]
    )
    scalars = jnp.stack(
        [jnp.asarray(v, f32) for v in (spin, r_max, horizon, *params)]
        + [jnp.zeros((), f32)] * (_N_SCALARS - 3 - len(params))
    )
    limits = jnp.asarray([steplim, max_iters], dtype=jnp.int32)

    outs = _trace_pallas_padded(
        arrays, scalars, limits,
        method=method, dest_kind=dest_kind, ctrl=ctrl, block=block,
        unroll=unroll,
    )
    n_f, n_i = len(_F_FIELDS), len(_I_FIELDS)
    upd = {}
    for idx, name in enumerate(_F_FIELDS):
        upd[name] = outs[idx][:n].astype(rays.r.dtype)
    for idx, name in enumerate(_I_FIELDS):
        upd[name] = outs[n_f + idx][:n]
    for idx, name in enumerate(_B_FIELDS):
        upd[name] = outs[n_f + n_i + idx][:n] != 0
    out = rays.replace(**upd)
    if refine_crossing:
        out = _refine_crossing_jit(out, dest, spin)
    return out


# dest is a pytree, so its traced parameters flow through the jit
_refine_crossing_jit = jax.jit(_refine_theta_crossing)


@partial(
    jax.jit,
    static_argnames=("method", "schedule", "steplim", "ctrl", "r_max"),
)
def _trace_pallas_fused_jit(
    rays, spin, dest, boundary, *, method, schedule, steplim, ctrl, r_max
):
    total = steplim + steplim // 4 + 16
    horizon = horizon_radius(spin) if boundary is None else boundary
    # Fresh-propagation setup happens once here, on the full batch, so a
    # schedule whose FIRST phase is width-compacted still gets the gate
    # reset and (for rk45) the dt seeding; every kernel call below resumes.
    out = _fresh_propagation_state(rays, spin, horizon, method, ctrl)

    def phase(batch, s, iters, block, unroll):
        return trace_pallas(
            batch, s, method=method, dest=dest, r_max=r_max, steplim=steplim,
            ctrl=ctrl, max_iters=iters, refine_crossing=False, block=block,
            unroll=unroll, resume=True, boundary=boundary,
        )

    out = run_phases(out, spin, schedule, total, phase)
    return _refine_theta_crossing(out, dest, spin)


def trace_pallas_phased(
    rays: RayBatch,
    spin,
    *,
    method: str = "rk4",
    dest=None,
    r_max=1000.0,
    steplim: int = 30_000,
    ctrl: StepControl = StepControl(),
    schedule=None,
    boundary=None,
) -> RayBatch:
    """Host-dispatched twin of trace_pallas_fused with progress reporting.

    Runs the same compaction schedule, but one kernel dispatch per phase
    with a progress-bar update (iterations used / budget + live survivor
    count) between dispatches (compaction.run_phases_progress, the shared
    host driver) — the compiled analogue of the reference's in-loop
    progress bar (progress_bar.h:25-74, raytracer.cpp:107-115). trace_auto
    selects it only when progress is requested.
    """
    if dest is None:
        dest = ThetaLimit(jnp.pi / 2)
    total = steplim + steplim // 4 + 16
    if schedule is None:
        schedule = auto_schedule(rays.n_rays, total, block=BLOCK, unroll=UNROLL)
    horizon = horizon_radius(spin) if boundary is None else boundary
    out = _fresh_propagation_state(rays, spin, horizon, method, ctrl)

    def phase(batch, s, iters, block, unroll):
        return trace_pallas(
            batch, s, method=method, dest=dest, r_max=r_max, steplim=steplim,
            ctrl=ctrl, max_iters=iters, refine_crossing=False, block=block,
            unroll=unroll, resume=True, boundary=boundary,
        )

    out = run_phases_progress(out, spin, schedule, total, phase,
                              label=f"march[{method}] {rays.n_rays} rays")
    return _refine_crossing_jit(out, dest, spin)


def trace_pallas_fused(
    rays: RayBatch,
    spin,
    *,
    method: str = "rk4",
    dest=None,
    r_max=1000.0,
    steplim: int = 30_000,
    ctrl: StepControl = StepControl(),
    schedule=None,
    boundary=None,
) -> RayBatch:
    """Multi-phase kernel march fused into ONE device program.

    The whole schedule (march -> device-side compaction of the survivors
    -> march -> ... -> full-width drain -> crossing refinement) is a single
    jitted program: phase widths are static, chosen up front by
    ``auto_schedule`` (or passed explicitly), so the only host interaction
    is the final fetch. The trailing drain phase (ops/compaction.py)
    finishes any lanes the static widths could not hold, with identical
    resume semantics — no host fallback, which also makes this function
    safe to call inside shard_map (parallel/sharding.py).
    """
    if dest is None:
        dest = ThetaLimit(jnp.pi / 2)
    total = steplim + steplim // 4 + 16
    if schedule is None:
        schedule = auto_schedule(rays.n_rays, total, block=BLOCK, unroll=UNROLL)
    return _trace_pallas_fused_jit(
        rays, spin, dest, boundary,
        method=method, schedule=tuple(tuple(p) for p in schedule),
        steplim=steplim, ctrl=ctrl, r_max=float(r_max),
    )
