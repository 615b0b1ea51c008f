"""Terminal progress reporting for multi-phase runs.

The reference shows a per-ray progress bar inside its OpenMP loop
(src/include/progress_bar.h:25-74, called under omp critical from
raytracer.cpp:107-115); compiled lock-step batches complete as a unit, so
progress here is per phase/chunk — used by the phase-dispatched compaction
driver (ops.trace_compacted(progress=True)), the app-level phase reporter
(``app_phase``) and apps looping over launch radii
(apps/return_radiation.py).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import time


class ProgressBar:
    """In-place terminal bar on a TTY; plain progress lines otherwise (the
    reference's ioctl-width bar is TTY-only, but apps here also run under
    drivers capturing stderr — silence there would be no progress at all).
    """

    def __init__(self, total: int, label: str = "", enabled: bool = True):
        self.total = max(total, 1)
        self.label = label
        self.enabled = enabled
        self.tty = sys.stderr.isatty()
        self.t0 = time.time()
        self._last = -1.0

    def show(self, done: int, extra: str = ""):
        if not self.enabled:
            return
        frac = min(done / self.total, 1.0)
        self._last = frac
        suffix = f" [{extra}]" if extra else ""
        if self.tty:
            width = max(shutil.get_terminal_size((80, 20)).columns - 34, 10)
            filled = int(frac * width)
            bar = "=" * filled + ">" + " " * (width - filled)
            sys.stderr.write(
                f"\r{self.label} [{bar}] {100 * frac:5.1f}% "
                f"({time.time() - self.t0:.1f}s){suffix}"
            )
        else:
            sys.stderr.write(
                f"{self.label}: {100 * frac:5.1f}% "
                f"({time.time() - self.t0:.1f}s){suffix}\n"
            )
        sys.stderr.flush()

    def done(self):
        if not self.enabled:
            return
        # don't repeat an already-printed 100% line on non-TTY streams
        if self.tty or self._last < 1.0:
            self.show(self.total)
        if self.tty:
            sys.stderr.write("\n")
            sys.stderr.flush()


@contextlib.contextmanager
def app_phase(label: str):
    """Coarse per-phase progress for the apps: announce a phase (source
    build / march / reduction / output), report its wall time on exit, and
    — with RT_PROFILE=<dir> in the environment — capture a jax.profiler
    trace of the phase into <dir>/<label> via utils.profiling.profile_trace
    (open in TensorBoard/xprof or Perfetto; SURVEY §5's profiling
    equivalent)."""
    from raytrace_tpu.utils.profiling import profile_trace

    logdir = os.environ.get("RT_PROFILE")
    sys.stderr.write(f"[{label}] ...\n")
    sys.stderr.flush()
    with profile_trace(
        os.path.join(logdir, label.replace(" ", "_")) if logdir else None,
        label=label,
    ):
        yield
