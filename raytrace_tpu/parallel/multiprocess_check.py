"""Real multi-process SPMD exercise: N CPU processes under jax.distributed.

The single untested layer between the virtual-device dryrun and a real
multi-host run is process-spanning mesh mechanics (jax.distributed.initialize,
global device ordering, cross-process collectives). This script
spins up two OS processes, each owning half of a virtual 8-device CPU
mesh, and runs the canonical sharded gradient step
(``sharded_emissivity_gradient``: per-shard forward+backward + psum
gradient all-reduce) over the process-spanning mesh, then checks the
result against a single-process run of the identical pipeline.

Usage (launcher mode, spawns the workers):
    python -m raytrace_tpu.parallel.multiprocess_check [out.json]

Worker mode (internal):
    RT_MPC_WORKER=<pid> RT_MPC_NPROC=2 RT_MPC_COORD=127.0.0.1:PORT \
        python -m raytrace_tpu.parallel.multiprocess_check

Skips gracefully (exit 0, "skipped": true in the JSON) where the jax build
does not support multi-process CPU collectives.

The reference has no distributed execution at all (SURVEY.md §2.6); this
validates the framework's multi-host story on commodity hardware, exactly
as jax.distributed would be used across GPU hosts.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

# Topology: RT_MPC_PROCS processes x RT_MPC_DEVS virtual CPU devices each
# (defaults 2x4; the round-5 artifact runs 4x2 to exercise >2-way
# cross-process collectives). The single-process reference always uses the
# same total device count, so the mesh numerics are directly comparable.
DEVS_PER_PROC = int(os.environ.get("RT_MPC_DEVS", "4"))
NPROC = int(os.environ.get("RT_MPC_PROCS", "2"))


def _worker() -> None:
    pid = int(os.environ["RT_MPC_WORKER"])
    nproc = int(os.environ["RT_MPC_NPROC"])
    coord = os.environ["RT_MPC_COORD"]

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={DEVS_PER_PROC}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )

    from raytrace_tpu.parallel import (
        make_ray_mesh,
        sharded_emissivity_gradient,
        sharded_line_profile_fit_step,
    )
    from raytrace_tpu.sources import PointSourceGrid

    n_dev = nproc * DEVS_PER_PROC
    assert jax.device_count() == n_dev, (jax.device_count(), n_dev)
    assert jax.process_count() == nproc
    # global mesh spanning both processes
    mesh = make_ray_mesh(n_dev)

    spin = 0.998
    grid = PointSourceGrid.from_steps(0.25, 0.25, -0.9, 0.9, -3.0, 3.0)
    val, grads = sharded_emissivity_gradient(
        spin, 5.0, 2.0, grid, mesh, n_steps=1024, r0=4.0, r_max=50.0
    )

    # line-profile fitting step across the process boundary: the in-graph
    # psum of partial profiles (inside value_and_grad) rides the
    # inter-process path here, not just the intra-process one
    fit = _fit_step_case(mesh)
    result = {
        "value": float(val),
        "grads": [float(g) for g in grads],
        "fit_loss": fit[0],
        "fit_grads": fit[1],
        "process_count": jax.process_count(),
        "device_count": jax.device_count(),
    }
    if pid == 0:
        print("RESULT " + json.dumps(result), flush=True)
    jax.distributed.shutdown()


def _fit_step_case(mesh):
    """The shared line-profile fit configuration (worker + reference)."""
    import jax.numpy as jnp

    from raytrace_tpu.ops.diff import line_profile_from_xy
    from raytrace_tpu.parallel import sharded_line_profile_fit_step
    from raytrace_tpu.sources import ImagePlaneGrid

    fit_grid = ImagePlaneGrid.from_steps(-10.5, 11.5, 2.75, -10.5, 11.5, 2.75)
    fx, fy = fit_grid.xy()
    target = line_profile_from_xy(
        0.9, 55.0, fx, fy, dist=100.0, r_disc=15.0, n_steps=768,
        energies=jnp.linspace(0.3, 1.3, 48),
    )
    loss, grads = sharded_line_profile_fit_step(
        0.85, 57.0, fit_grid, target, mesh, dist=100.0, r_disc=15.0,
        n_steps=768,
    )
    return float(loss), [float(g) for g in grads]


def _single_process_reference() -> dict:
    """Same pipeline on one process (virtual 8-device mesh) for comparison."""
    n_dev = NPROC * DEVS_PER_PROC
    # device count injected as a literal — never %-format a string holding
    # the user's own XLA_FLAGS (a % in their flags would crash the child)
    code = f"N_DEV = {n_dev}\n" + r"""
import os, json
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={N_DEV}").strip()
import jax
jax.config.update("jax_platforms", "cpu")
from raytrace_tpu.parallel import make_ray_mesh, sharded_emissivity_gradient
from raytrace_tpu.parallel.multiprocess_check import _fit_step_case
from raytrace_tpu.sources import PointSourceGrid
mesh = make_ray_mesh(N_DEV)
grid = PointSourceGrid.from_steps(0.25, 0.25, -0.9, 0.9, -3.0, 3.0)
val, grads = sharded_emissivity_gradient(0.998, 5.0, 2.0, grid, mesh,
                                         n_steps=1024, r0=4.0, r_max=50.0)
fit = _fit_step_case(mesh)
print("RESULT " + json.dumps({"value": float(val),
                              "grads": [float(g) for g in grads],
                              "fit_loss": fit[0], "fit_grads": fit[1]}))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=1800
    )
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"single-process reference failed:\n{out.stderr[-2000:]}")


def _launch(out_path: str) -> int:
    # free TCP port for the coordinator
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    procs = []
    for pid in range(NPROC):
        env = dict(os.environ)
        env.update(
            RT_MPC_WORKER=str(pid), RT_MPC_NPROC=str(NPROC), RT_MPC_COORD=coord
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "raytrace_tpu.parallel.multiprocess_check"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        )

    outs = []
    ok = True
    for p in procs:
        try:
            so, se = p.communicate(timeout=1800)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
            ok = False
        outs.append((p.returncode, so, se))
        ok = ok and p.returncode == 0

    record: dict = {"ok": False, "skipped": False, "n_processes": NPROC,
                    "devices_per_process": DEVS_PER_PROC}
    if not ok:
        err = "\n".join(se[-1500:] for _, _, se in outs)
        unsupported = any(
            key in err
            for key in ("UNIMPLEMENTED", "not supported", "NotImplementedError",
                        "cross-host", "collectives")
        )
        record.update(skipped=unsupported, error=err[-3000:])
        print(json.dumps({k: v for k, v in record.items() if k != "error"}))
    else:
        result = None
        for _, so, _ in outs:
            for line in so.splitlines():
                if line.startswith("RESULT "):
                    result = json.loads(line[len("RESULT "):])
        ref = _single_process_reference()
        import math

        rel = max(
            abs(g2 - g1) / max(abs(g1), 1e-30)
            for g2, g1 in zip(result["grads"], ref["grads"])
        )
        val_rel = abs(result["value"] - ref["value"]) / abs(ref["value"])
        fit_rel = max(
            abs(result["fit_loss"] - ref["fit_loss"]) / abs(ref["fit_loss"]),
            *(abs(g2 - g1) / max(abs(g1), 1e-30)
              for g2, g1 in zip(result["fit_grads"], ref["fit_grads"])),
        )
        # gradient parity to the ensemble noise floor (see test_parallel.py);
        # the fit step (in-graph psum under value_and_grad across the
        # process boundary) is chaos-weight protected and tighter
        record.update(
            ok=bool(val_rel < 1e-8 and rel < 2e-3 and fit_rel < 1e-6 and
                    all(math.isfinite(g) for g in result["grads"])),
            two_process=result, single_process=ref,
            value_rel_err=val_rel, grad_rel_err=rel, fit_rel_err=fit_rel,
        )
        print(json.dumps(record))
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return 0 if (record["ok"] or record["skipped"]) else 1


def main() -> int:
    if "RT_MPC_WORKER" in os.environ:
        _worker()
        return 0
    out = sys.argv[1] if len(sys.argv) > 1 else "MULTIPROC.json"
    return _launch(out)


if __name__ == "__main__":
    sys.exit(main())
