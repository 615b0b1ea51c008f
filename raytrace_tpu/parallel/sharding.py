"""Ray-axis data parallelism over a device mesh.

The reference parallelises with a single-node OpenMP loop over rays
(raytracer.cpp:104) and has no distributed backend (SURVEY.md §2.6). The
equivalent here is pure data parallelism over a 1-D ``rays`` mesh axis:
rays never communicate, so the only collectives are psums merging
per-shard histogram/image partials, inserted explicitly via shard_map.

Multi-host runs initialise ``jax.distributed`` before calling in here; the
mesh spans all addressable devices and every function below is
host-agnostic SPMD.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from raytrace_tpu.ops import kernel_steplim, use_march_kernel
from raytrace_tpu.ops.integrate import StepControl, trace
from raytrace_tpu.ops.reductions import radial_bin_profile
from raytrace_tpu.ops.redshift import apply_redshift, range_phi, redshift_start
from raytrace_tpu.rays import RayBatch


def _shard_engine(use_kernel, method, r_max, steplim, ctrl):
    """Shard-local propagation engine: the Pallas GPU kernel where
    ``ops.use_march_kernel`` picks it, the XLA lock-step loop otherwise.

    This is the multi-device twin of ops.trace_auto (same routing
    predicate, evaluated by the callers), so each mesh device runs the same
    single-device engine on its shard (the reference's only parallel
    mechanism is the ray loop, raytracer.cpp:104).
    """
    if use_kernel:
        from raytrace_tpu.ops.pallas_kernel import trace_pallas_fused

        lim = kernel_steplim(method, steplim)

        def run(shard, s, dest, boundary):
            return trace_pallas_fused(
                shard, s, method=method, dest=dest, r_max=r_max,
                steplim=lim, ctrl=ctrl, boundary=boundary,
            )

        return run

    def run(shard, s, dest, boundary):
        return trace(
            shard, s, method=method, dest=dest, r_max=r_max,
            steplim=steplim, ctrl=ctrl, boundary=boundary,
        )

    return run


def make_ray_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the ray axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("rays",))


def auto_mesh() -> Mesh | None:
    """Mesh over all addressable devices when there is more than one, else
    None — the apps' auto-sharding hook (every reference app parallelises
    through the one OpenMP ray loop, raytracer.cpp:104; here every app
    shards its ray batch whenever a multi-device backend is present)."""
    return make_ray_mesh() if jax.device_count() > 1 else None


def _pad_tail(a, pad, edge: bool):
    """Pad the trailing axis by ``pad`` rows — zeros, or the edge value
    (for quantities that must stay in their finite domain)."""
    widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return jnp.pad(a, widths, mode="edge" if edge else "constant")


def pad_rays(rays: RayBatch, multiple: int) -> RayBatch:
    """Pad the batch with dead rays (steps = -1) to a multiple of the shard
    count; dead rays are never traced and fall out of every reduction.

    This and ``_pad_angles`` (the pre-RayBatch twin for sharded gradient
    pipelines, where deadness is the ``dead`` mask) are the framework's two
    padding surfaces; both route through ``_pad_tail``.
    """
    n = rays.n_rays
    rem = n % multiple
    if rem == 0:
        return rays
    pad = multiple - rem
    padded = jax.tree.map(lambda a: _pad_tail(a, pad, edge=False), rays)
    steps = padded.steps.at[n:].set(-1)
    return padded.replace(steps=steps)


def _pad_angles(cosalpha, beta, dead, multiple: int):
    """Pad flat emission-angle arrays to a multiple of the shard count.

    Padding rows carry the edge angle values (so the constants-of-motion
    math stays in its finite domain) and are flagged dead — the angle-array
    equivalent of pad_rays' steps = -1 convention (rays built from them get
    steps = -1 in point_source_from_angles and are excluded from every
    observable)."""
    rem = cosalpha.shape[0] % multiple
    if rem == 0:
        return cosalpha, beta, dead
    pad = multiple - rem
    return (
        _pad_tail(cosalpha, pad, edge=True),
        _pad_tail(beta, pad, edge=True),
        jnp.concatenate([dead, jnp.ones((pad,), dtype=bool)]),
    )


def shard_rays(rays: RayBatch, mesh: Mesh) -> RayBatch:
    """Place the batch with the ray axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P("rays"))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), rays)


@lru_cache(maxsize=64)
def _sharded_trace_program(mesh, use_kernel, method, dest_treedef, r_max,
                           steplim, ctrl, has_boundary):
    """Build (once per configuration) the shard_map propagation program.

    The program object must be cached across calls: a fresh closure per
    invocation defeats JAX's trace/compile cache, and a re-trace of the
    fused kernel schedule costs seconds per call. Destination parameters
    and the boundary radius enter as traced arguments so one cached program
    serves every parameter value of the same destination type."""
    engine = _shard_engine(use_kernel, method, r_max, steplim, ctrl)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rays"), P(), P(), P()),
        out_specs=P("rays"),
        check_vma=False,
    )
    def run(r, s, dest_leaves, boundary):
        dest = (jax.tree.unflatten(dest_treedef, list(dest_leaves))
                if dest_treedef is not None else None)
        return engine(r, s, dest, boundary if has_boundary else None)

    # jit the shard_map program: called bare it dispatches its body
    # eagerly, op by op; jitted it is a single device program per call.
    return jax.jit(run)


def sharded_trace(
    rays: RayBatch,
    spin,
    mesh: Mesh,
    *,
    method: str = "rk45",
    dest=None,
    r_max=1000.0,
    steplim: int | None = None,
    ctrl: StepControl = StepControl(),
    boundary=None,
) -> RayBatch:
    """Sharded propagation: each device marches its ray shard independently
    (embarrassingly parallel; zero collectives). The shard-local engine is
    the one ``ops.use_march_kernel`` picks: the Pallas GPU kernel (full
    fused compaction schedule per shard) or the XLA lock-step loop."""
    use_kernel = use_march_kernel(method, dest)
    if dest is None:
        leaves, treedef = (), None
    else:
        leaves, treedef = jax.tree.flatten(dest)
    run = _sharded_trace_program(
        mesh, use_kernel, method, treedef, float(r_max), steplim, ctrl,
        boundary is not None,
    )
    return run(rays, spin, tuple(leaves),
               boundary if boundary is not None else 0.0)


def sharded_emissivity_bins(
    rays: RayBatch,
    spin,
    mesh: Mesh,
    *,
    V=0.0,
    r_min,
    dr,
    n_r: int,
    logbin_r: bool = True,
    gamma=2.0,
    n_primary=1.0,
    method: str = "rk45",
    r_max=1000.0,
    steplim: int | None = None,
    ctrl: StepControl = StepControl(),
):
    """Full sharded emissivity step: per-shard trace + redshift + local
    radial binning, then a psum over the mesh merges the partial histograms
    (replicated output). This is the framework's canonical multi-device
    step shape: independent shard compute + one all-reduce. The
    shard-local march uses the same engine selection as sharded_trace. The hit criterion
    and bin weights are the app's own (apps.emissivity.disc_hit_mask /
    emissivity_bin_weights) — one definition for the single-chip and
    multi-chip paths."""
    run = _sharded_bins_program(
        mesh, use_march_kernel(method, None), method, float(V),
        float(r_min), float(dr), int(n_r), bool(logbin_r), float(gamma),
        float(n_primary), float(r_max), steplim, ctrl,
    )
    return run(rays, spin)


@lru_cache(maxsize=64)
def _sharded_bins_program(mesh, use_kernel, method, V, r_min, dr, n_r,
                          logbin_r, gamma, n_primary, r_max, steplim, ctrl):
    """Cached shard_map program for the full emissivity step (see
    _sharded_trace_program for why caching is load-bearing)."""
    from raytrace_tpu.apps.emissivity import disc_hit_mask, emissivity_bin_weights

    engine = _shard_engine(use_kernel, method, r_max, steplim, ctrl)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rays"), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(shard, s):
        shard = redshift_start(shard, s, V)
        out = engine(shard, s, None, None)
        out = range_phi(out)
        out = apply_redshift(out, s, V=-1.0)
        mask = disc_hit_mask(out, s)
        counts, sums = radial_bin_profile(
            out.r,
            mask,
            emissivity_bin_weights(out, gamma, n_primary),
            r_min,
            dr,
            n_r,
            logbin_r,
        )
        merged = jax.lax.psum((counts, sums), "rays")
        return merged

    return jax.jit(run)


def sharded_disc_image(
    rays: RayBatch,
    spin,
    mesh: Mesh,
    *,
    grid,
    r_disc,
    img_nx: int,
    img_ny: int,
    variant: str = "plain",
    dest=None,
    theta_lim=np.pi / 2,
    r_isco=None,
    q1=3.0,
    rb1=4.0,
    q2=3.0,
    rb2=10.0,
    q3=3.0,
    flip_image: bool = True,
    method: str = "rk45",
    r_max=1000.0,
    steplim: int | None = None,
    ctrl: StepControl = StepControl(),
):
    """Full sharded disc-image step: per-shard march (the engine
    ``ops.use_march_kernel`` picks) + redshift + per-shard pixel accumulation, then
    one psum over the ``rays`` mesh axis merges the 6 partial maps + counts
    (replicated output). The multi-chip twin of the reference's OpenMP ray
    loop over its flagship image app (raytracer.cpp:104,
    imageplane_disc_image.cpp:122-176); the hit criterion and pixel binning
    are the app's own accumulate_image_maps — one definition for the
    single-chip and multi-chip paths (tests/test_parallel.py pins 8-device
    == single-device bitwise counts).

    ``rays`` is the un-sharded camera batch (padding/sharding happens
    here); returns (counts, {flux, r, phi, enshift, time, emis}),
    un-normalised like accumulate_image_maps.
    """
    from raytrace_tpu.geometry import isco_radius

    if r_isco is None:
        r_isco = isco_radius(spin)
    rays = pad_rays(rays, mesh.devices.size)
    rays = shard_rays(rays, mesh)
    if dest is None:
        leaves, treedef = (), None
    else:
        leaves, treedef = jax.tree.flatten(dest)
    run = _sharded_image_program(
        mesh, use_march_kernel(method, dest), method, variant, treedef,
        grid, float(r_disc), int(img_nx), int(img_ny), float(theta_lim),
        float(r_isco), float(q1), float(rb1), float(q2), float(rb2),
        float(q3), bool(flip_image), float(r_max), steplim, ctrl,
    )
    return run(rays, spin, tuple(leaves))


@lru_cache(maxsize=64)
def _sharded_image_program(mesh, use_kernel, method, variant, dest_treedef,
                           grid, r_disc, img_nx, img_ny, theta_lim, r_isco,
                           q1, rb1, q2, rb2, q3, flip_image, r_max, steplim,
                           ctrl):
    """Cached shard_map program for the full image step (see
    _sharded_trace_program for why caching is load-bearing). ``grid`` is
    the frozen ImagePlaneGrid dataclass (hashable static geometry)."""
    from raytrace_tpu.apps.imageplane_disc_image import accumulate_image_maps

    engine = _shard_engine(use_kernel, method, r_max, steplim, ctrl)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rays"), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(shard, s, dest_leaves):
        dest = (jax.tree.unflatten(dest_treedef, list(dest_leaves))
                if dest_treedef is not None else None)
        a_trace = -s  # time reversal (imageplane.cpp:12)
        shard = redshift_start(shard, a_trace, V=0.0, reverse=True)
        out = engine(shard, a_trace, dest, None)
        counts, images = accumulate_image_maps(
            out, s, grid, r_disc, img_nx, img_ny, variant=variant,
            dest=dest, theta_lim=theta_lim, r_isco=r_isco,
            q1=q1, rb1=rb1, q2=q2, rb2=rb2, q3=q3, flip_image=flip_image,
        )
        return jax.lax.psum((counts, images), "rays")

    return jax.jit(run)


def sharded_caustic_trace(
    rays: RayBatch,
    spin,
    mesh: Mesh,
    *,
    dest=None,
    r_max=1000.0,
    method: str = "rk45",
    steplim: int | None = None,
    ctrl: StepControl = StepControl(),
) -> RayBatch:
    """Sharded march for the caustic bundle pipelines: pad + shard the
    (5-rays-per-pixel) bundle batch over the ``rays`` mesh axis, march each
    shard with the backend's fastest engine, and return the full-width
    batch (padding stripped) for the host-side Jacobian post-processing
    (apps/caustics.py — pure array arithmetic, not worth a collective).
    ``spin`` is the propagation spin (already negated for backward
    tracing). Bundles need no co-residency: the Jacobian differences are
    taken after the replicated gather, so slot-major sharding is safe."""
    n = rays.n_rays
    rays = pad_rays(rays, mesh.devices.size)
    rays = shard_rays(rays, mesh)
    out = sharded_trace(
        rays, spin, mesh, method=method, dest=dest, r_max=r_max,
        steplim=steplim, ctrl=ctrl,
    )
    return jax.tree.map(lambda a: a[:n], out)


def sharded_emissivity_gradient(
    spin,
    h_source,
    gamma,
    grid,
    mesh: Mesh,
    *,
    n_steps: int = 2048,
    r0=5.0,
    sigma_ln=0.3,
    r_max=500.0,
):
    """Sharded gradient step: value and d/d(spin, h, gamma) of the smooth
    emissivity observable, with the ray batch data-parallel over the mesh.

    Each device differentiates its own shard of the pipeline (source
    constants -> checkpointed RK4 march -> redshift -> observable) locally
    on the backward sweep; the per-shard parameter gradients are then merged
    with one psum over the ``rays`` axis. This is the BASELINE.json north
    star's multi-device shape: embarrassingly parallel per-ray forward+backward
    compute, collective traffic only for the (tiny) parameter gradients.

    Returns (value, (d_spin, d_h, d_gamma)), all replicated.
    """
    from raytrace_tpu.sources import grid_angles

    n_dev = mesh.devices.size
    cosalpha, beta, dead = _pad_angles(*grid_angles(grid), n_dev)

    angle_sharding = NamedSharding(mesh, P("rays"))
    cosalpha, beta, dead = (
        jax.device_put(a, angle_sharding) for a in (cosalpha, beta, dead)
    )

    run = _sharded_gradient_program(
        mesh, int(n_steps), float(r0), float(sigma_ln), float(r_max)
    )
    ftype = jnp.result_type(float)  # f64 under x64
    return run(
        jnp.asarray(spin, ftype), jnp.asarray(h_source, ftype),
        jnp.asarray(gamma, ftype), cosalpha, beta, dead,
    )


def sharded_line_profile_fit_step(
    spin,
    incl_deg,
    grid,
    target,
    mesh: Mesh,
    *,
    dist=500.0,
    r_disc=50.0,
    q=3.0,
    e_rest=1.0,
    n_energies: int = 48,
    sigma_e=0.035,
    n_steps: int = 2048,
):
    """One multi-chip line-profile fitting step: chi-square loss of the
    observed profile against ``target`` and its gradients d/d(spin, incl).

    The production shape of the BASELINE north star (fitting iron-K line
    shapes for spin/inclination): camera coordinates shard over the
    ``rays`` mesh axis, each device runs forward+backward through its own
    rays' differentiable march, the per-shard partial profiles meet in ONE
    in-graph psum (the loss is a nonlinear function of the TOTAL profile,
    so the reduction must sit inside the differentiated computation — its
    transpose broadcasts the cotangent back to every shard), and the
    per-shard parameter gradients all-reduce with a second psum. Output
    (loss, (d_spin, d_incl)) is replicated; the whole step is one jitted
    program (fusion-robust via the observable's chaos_weight suppression,
    ops/diff.py).

    ``target`` is the [n_energies] profile to fit (replicated); energies
    span 0.3..1.3 e_rest like line_profile_observable.
    """
    x, y = grid.xy()
    dead = jnp.zeros(x.shape, dtype=bool)
    n_dev = mesh.devices.size
    x, y, dead = _pad_angles(x, y, dead, n_dev)
    sh = NamedSharding(mesh, P("rays"))
    x, y, dead = (jax.device_put(a, sh) for a in (x, y, dead))
    target = jnp.asarray(target)

    run = _sharded_line_fit_program(
        mesh, float(dist), float(r_disc), float(q), float(e_rest),
        int(n_energies), float(sigma_e), int(n_steps),
    )
    ftype = jnp.result_type(float)
    return run(jnp.asarray(spin, ftype), jnp.asarray(incl_deg, ftype),
               x, y, dead, target)


@lru_cache(maxsize=64)
def _sharded_line_fit_program(mesh, dist, r_disc, q, e_rest, n_energies,
                              sigma_e, n_steps):
    """Cached shard_map program for the line-profile fit step (see
    _sharded_trace_program for why caching is load-bearing)."""
    from raytrace_tpu.ops.diff import line_profile_from_xy

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("rays"), P("rays"), P("rays"), P()),
        out_specs=(P(), (P(), P())),
        check_vma=False,
    )
    def run(s, incl, x, y, dd, target):
        energies = jnp.linspace(0.3 * e_rest, 1.3 * e_rest, n_energies,
                                dtype=x.dtype)

        def loss_fn(s_, incl_):
            p_local = line_profile_from_xy(
                s_, incl_, x, y, dd, dist=dist, r_disc=r_disc, q=q,
                e_rest=e_rest, energies=energies, sigma_e=sigma_e,
                n_steps=n_steps,
            )
            p_total = jax.lax.psum(p_local, "rays")
            return jnp.sum((p_total - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(s, incl)
        # loss is identical on every shard (it sees the psummed profile).
        # Gradients need TWO corrections folded into one: each shard's
        # grad covers only its own rays' paths (-> psum to total), but the
        # loss graph is REPLICATED per shard and shard_map's psum
        # transpose sums the identical cotangents, inflating every
        # per-shard grad by the axis size (measured exactly 8x on the
        # 8-device mesh) -> divide it back out. Validated against the
        # single-device value_and_grad of the same composition
        # (tests/test_parallel.py).
        n_ax = jax.lax.psum(jnp.ones((), x.dtype), "rays")
        grads = jax.tree.map(lambda g: g / n_ax, jax.lax.psum(grads, "rays"))
        return loss, grads

    return jax.jit(run)


@lru_cache(maxsize=64)
def _sharded_gradient_program(mesh, n_steps, r0, sigma_ln, r_max):
    """Cached shard_map program for the sharded gradient step (see
    _sharded_trace_program for why caching is load-bearing)."""
    from raytrace_tpu.ops.diff import emissivity_observable_from_angles

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("rays"), P("rays"), P("rays")),
        out_specs=(P(), (P(), P(), P())),
        check_vma=False,
    )
    def run(s, h, g, ca, be, dd):
        f = lambda s_, h_, g_: emissivity_observable_from_angles(
            s_, h_, g_, ca, be, dd,
            n_steps=n_steps, r0=r0, sigma_ln=sigma_ln, r_max=r_max,
        )
        val, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(s, h, g)
        return jax.lax.psum(val, "rays"), jax.lax.psum(grads, "rays")

    # jit-wrapped like every other sharded program: one compiled device
    # program per call.
    # Round 3 had to leave this bare because the observable used a HARD
    # stop-gradient hit mask: outer-jit re-fusion perturbs the march at the
    # ulp/step-phase level, and rays on two knife edges — near-separatrix
    # chaotic lanes, and lanes launched exactly at a turning point whose
    # momentum sign is a rounding coin flip — then land elsewhere, shifting
    # the observable percent-level (measured 60.59 bare vs 67.3-79.1 across
    # jitted runs). The fix is in the observable itself
    # (ops/diff.py::chaos_weight + separatrix_score/launch_turning_scores):
    # both sensitive sets are smoothly weighted out of the VALUE by
    # functions of the pre-march constants only, so re-fusion can move
    # nothing with non-negligible weight — tests/test_parallel.py pins
    # jitted == bare (measured 1e-13 value / 1e-9 grads at spins 0.9 and
    # 0.998) and sharded == single-device.
    return jax.jit(run)
