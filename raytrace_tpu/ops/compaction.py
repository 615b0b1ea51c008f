"""Shared fused-compaction machinery for heterogeneous ray lifetimes.

A lock-step batch pays every iteration for its slowest lane: a handful of
stuck photon-sphere rays (the reference's RK45_STEPLIM pathology,
/root/reference/docs/session_2026-03-01.md:105-137) would force the whole
batch through 30k+ iterations. Both propagation engines (the XLA while-loop
``trace`` and the Pallas GPU kernel) instead run a *static* multi-phase
schedule: a full-width opening march, then device-side gathers of the
still-active survivors into progressively narrower sub-batches, and a final
full-width drain phase that finishes any lanes a width misjudged — so the
whole schedule is one jitted program with no host round trips and no width
can strand a ray mid-flight.

The gather/scatter pair preserves per-lane state exactly, so a fused run is
observationally identical to the single-phase march: same step counts,
statuses, positions and adaptive dt.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytrace_tpu.rays import RayBatch

# Compacted widths are whole multiples of _WIDTH_ALIGN rays, so they split
# into whole kernel programs for any power-of-two block up to that size; the
# XLA engine has no block constraint.
_WIDTH_ALIGN = 1024

# Opening-phase length of the two-phase schedule: long enough to retire the
# smooth mass of both the fixed-step and adaptive canonical workloads.
OPEN_ITERS = 1536


def auto_schedule(n: int, total: int, open_iters: int = OPEN_ITERS,
                  block: int = 128, unroll: int = 1):
    """Static compaction schedule: (iters, width, block, unroll) per phase.

    ``block`` (rays per kernel program) and ``unroll`` (step bodies per
    while iteration) are the kernel's launch shape for every phase; the XLA
    engine ignores ``block``.

    The per-ray step distribution of the canonical disc workloads is
    sharply bimodal: every ray needs a few hundred steps, and ~0.04%
    photon-sphere creepers run to the step limit. So the schedule is TWO
    phases: a full-width opening march long enough to retire the smooth
    mass (canonical RK4 max 782 steps, RK45 p99 well under 1536), then the
    long stuck-ray tail on the survivors gathered into a width of about
    n/24. A retired kernel block in the full-width phase costs only its own
    loop-condition check, and the tail's gather is cond-skipped entirely
    when nothing survives the opening phase. A workload whose survivors
    overflow the tail width is drained correctly (if more slowly) by the
    full-width drain phase appended by ``run_phases``.
    """
    full = -(-n // (2 * _WIDTH_ALIGN)) * 2 * _WIDTH_ALIGN
    w3 = -(-max(2 * _WIDTH_ALIGN, n // 24) // _WIDTH_ALIGN) * _WIDTH_ALIGN
    if w3 >= full or n <= 8 * _WIDTH_ALIGN:
        return ((total, None, block, unroll),)
    return ((open_iters, None, block, unroll), (total, w3, block, unroll))


def compact_gather(out: RayBatch, width: int):
    """Gather the active lanes into a width-wide sub-batch, on device.

    The packed index list is a sort of ``where(active, iota, n)``:
    ascending active indices, padded with the out-of-bounds index n, which
    gathers as zeros, is marked dead (steps = -1), and is dropped again by
    the mode="drop" scatter on the way back. If more than ``width`` lanes
    are active, the excess stays behind untouched (still active in
    ``out``) — finished by the drain phase.
    """
    n = out.n_rays
    active = out.active
    key = jnp.where(active, jnp.arange(n, dtype=jnp.int32), jnp.int32(n))
    idx = jax.lax.sort(key)[:width]
    live = idx < n
    sub = jax.tree.map(
        # fill_value must be static (it is baked into the gather primitive)
        lambda a: jnp.take(a, idx, axis=0, mode="fill", fill_value=0),
        out,
    )
    sub = sub.replace(steps=jnp.where(live, sub.steps, jnp.full_like(sub.steps, -1)))
    return sub, idx


def compact_scatter(out: RayBatch, sub: RayBatch, idx):
    return jax.tree.map(lambda o, s: o.at[idx].set(s, mode="drop"), out, sub)


# jitted twins for the host-driven (fuse=False) path: called eagerly,
# compact_gather/compact_scatter would dispatch ~45 individual ops, against
# the "one dispatch per phase" the progress drivers advertise
_gather_jit = jax.jit(compact_gather, static_argnums=1)
_scatter_jit = jax.jit(compact_scatter)
_count_active_jit = jax.jit(lambda st: jnp.sum(st.active.astype(jnp.int32)))


def run_phases(out: RayBatch, spin, schedule, total: int, phase_fn,
               fuse: bool = True) -> RayBatch:
    """Run the compaction schedule, then a full-width drain phase.

    ``phase_fn(batch, spin, iters, block, unroll) -> batch`` marches a batch
    for at most ``iters`` lock-step iterations in resume mode (gates/dt
    already seeded by the caller). The trailing drain phase re-marches the
    full batch with the whole iteration budget: if every lane already
    finished it exits after one loop-condition check (per block, for the
    Pallas engine), and otherwise it finishes the lanes the static widths
    could not hold — identical resume semantics, so the result is exactly
    as if the schedule had fit.

    ``fuse=False`` is for host-driven callers (the progress drivers) whose
    phase_fn has host side-effects: the empty-gather skip becomes a plain
    Python branch on a fetched activity count instead of a traced
    lax.cond.
    """
    n = out.n_rays
    used = 0
    full_to_end = False
    for iters, width, block, unroll in schedule:
        iters = min(iters, total - used)
        if iters <= 0:
            break
        if width is None or width >= n:
            out = phase_fn(out, spin, iters, block, unroll)
            full_to_end = used + iters >= total
        else:
            # cond-skip an empty compaction: when every lane has retired
            # (the common case for fixed-step workloads once the opening
            # phase covers their max), the gather's sort + 21-array
            # take/scatter would be pure waste
            if fuse:
                def _compacted(o, w=width, it=iters, bl=block, un=unroll):
                    sub, idx = compact_gather(o, w)
                    sub = phase_fn(sub, spin, it, bl, un)
                    return compact_scatter(o, sub, idx)

                out = jax.lax.cond(
                    jnp.any(out.active), _compacted, lambda o: o, out
                )
            elif int(_count_active_jit(out)) > 0:
                sub, idx = _gather_jit(out, width)
                sub = phase_fn(sub, spin, iters, block, unroll)
                out = _scatter_jit(out, sub, idx)
            full_to_end = False
        used += iters
    if not full_to_end:
        # drain: correctness backstop for schedule-overflow lanes (a no-op
        # one-condition-check pass when every lane already finished), with
        # the opening phase's launch shape so it reuses that compiled kernel
        _, _, block, unroll = schedule[0]
        out = phase_fn(out, spin, total, block, unroll)
    return out


def run_phases_progress(out: RayBatch, spin, schedule, total: int, phase_fn,
                        label: str) -> RayBatch:
    """Host-dispatched run_phases with a terminal progress bar between
    dispatches — the compiled analogue of the reference's in-loop progress
    bar (progress_bar.h:25-74, raytracer.cpp:107-115). Shared by both
    engines' progress drivers (ops.trace_compacted(progress=True) and the
    Pallas trace_pallas_phased); ``phase_fn`` is the engine's jitted
    resume-mode march, so each phase costs one dispatch plus one live-count
    fetch."""
    import numpy as np

    from raytrace_tpu.utils.progress import ProgressBar

    bar = ProgressBar(total, label=label)
    done = {"it": 0}

    def wrapped(batch, s, iters, block, unroll):
        res = phase_fn(batch, s, iters, block, unroll)
        n_live = int(np.asarray(_count_active_jit(res)))
        done["it"] = min(done["it"] + iters, total)
        bar.show(done["it"], extra=f"{n_live} live")
        return res

    out = run_phases(out, spin, schedule, total, wrapped, fuse=False)
    bar.done()
    return out
