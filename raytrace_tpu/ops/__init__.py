"""Integrator cores and on-device reductions (L1)."""

from raytrace_tpu.ops.integrate import (
    StepControl,
    trace,
    trace_compacted,
    STEPLIM,
    RK45_STEPLIM,
)
from raytrace_tpu.ops.reductions import radial_bin_profile, pixel_accumulate


def use_march_kernel(method="rk45", dest=None, platform=None) -> bool:
    """The one engine choice, keyed on the platform of ``jax.devices()[0]``
    (or ``platform``), shared by ``trace_auto``, the shard-local engines of
    ``raytrace_tpu.parallel`` and the perf harnesses.

    On ``"gpu"`` every fixed-step or DOPRI5 march to one of the surfaces
    the kernel implements (ThetaLimit / DiscWithISCO / FlatPlane /
    SphericalShell, with or without a boundary override) runs through the
    Pallas GPU kernel (``ops/pallas_kernel.py``); never-stopping
    velocity-field destinations take the XLA lock-step path. On ``"cpu"``
    everything takes the XLA lock-step path. Any other platform is an
    error: no engine has been built or checked for it.
    """
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    if platform == "cpu":
        return False
    if platform != "gpu":
        raise RuntimeError(
            f"no march engine for platform {platform!r} (supported: gpu, cpu)"
        )
    from raytrace_tpu.destinations import (
        DiscWithISCO,
        FlatPlane,
        SphericalShell,
        ThetaLimit,
    )

    return method in ("euler", "rk4", "rk45") and (
        dest is None
        or type(dest) in (ThetaLimit, DiscWithISCO, FlatPlane, SphericalShell)
    )


def kernel_steplim(method, steplim=None) -> int:
    """Stuck-ray cap for the GPU kernel when the caller gave none.

    The XLA-path defaults are sized for f64 CPU. RK4 is capped at 30k —
    just above the measured well-behaved maximum for the benched workloads.
    RK45 keeps the reference's own RK45_STEPLIM = 1e5 (raytracer.h:33-39):
    well-behaved RK45 rays stay under ~35k steps, but near-separatrix rays
    between "well-behaved" and "stuck" legitimately use the 35k-100k range
    at tight tolerances, and the fused compaction schedule makes the tail
    cheap (narrow blocks), so the conservative cap costs little.
    """
    if steplim is None or steplim <= 0:
        return 100_000 if method == "rk45" else 30_000
    return steplim


def trace_auto(rays, spin, **kw):
    """Route a propagation to the engine ``use_march_kernel`` picks.

    On the GPU every supported destination runs through the Pallas kernel
    — each ray's state in registers for the whole march, f32, results cast
    back to the caller's dtype — with the fused multi-phase long-tail
    compaction; otherwise the XLA lock-step path (f64 on CPU). Accepts the
    trace_compacted keyword set.

    ``progress=True`` (or RT_PROGRESS=1 in the environment) dispatches the
    compaction schedule phase by phase with a terminal progress bar
    between dispatches, on either engine — the compiled analogue of the
    reference's in-loop progress bar (raytracer.cpp:107-115).
    """
    import os

    method = kw.get("method", "rk45")
    dest = kw.get("dest")
    progress = kw.pop("progress", None)
    if progress is None:
        progress = os.environ.get("RT_PROGRESS", "0") == "1"
    if use_march_kernel(method, dest):
        # the fused driver runs the whole compaction schedule (wide march,
        # device-side survivor gather, narrow stuck-ray tail, full-width
        # drain) as a single dispatch, with no host round trips between
        # phases
        from raytrace_tpu.ops.pallas_kernel import (
            trace_pallas_fused,
            trace_pallas_phased,
        )

        run = trace_pallas_phased if progress else trace_pallas_fused
        return run(
            rays,
            spin,
            method=method,
            dest=dest,
            r_max=kw.get("r_max", 1000.0),
            steplim=kernel_steplim(method, kw.get("steplim")),
            ctrl=kw.get("ctrl", StepControl()),
            boundary=kw.get("boundary"),
        )
    return trace_compacted(rays, spin, progress=progress, **kw)


__all__ = [
    "StepControl",
    "kernel_steplim",
    "use_march_kernel",
    "trace",
    "trace_auto",
    "trace_compacted",
    "STEPLIM",
    "RK45_STEPLIM",
    "radial_bin_profile",
    "pixel_accumulate",
]
