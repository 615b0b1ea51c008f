"""Profiler integration.

The reference's only timing is std::chrono in its perf test (SURVEY.md §5);
here any traced section can be captured as a full XLA device profile readable
in TensorBoard or Perfetto.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def profile_trace(logdir: str | None = None, label: str = "trace"):
    """Context manager timing a section; with a logdir, also records a
    jax.profiler trace (open in TensorBoard / xprof)."""
    import jax

    t0 = time.time()
    if logdir:
        with jax.profiler.trace(logdir):
            yield
    else:
        yield
    dt = time.time() - t0
    print(f"[profile] {label}: {dt:.3f}s" + (f" -> {logdir}" if logdir else ""))
