"""Checkpoint / resume of in-flight ray state.

The reference has no checkpointing of ray state (SURVEY.md §5 — only the
Mapper's binary map save/load, mapper.cpp:284-301). Here the whole RayBatch
is a pytree of arrays, so a checkpoint is a single NPZ; combined with
``trace(..., resume=True)`` a long propagation can be suspended and resumed
across processes — including moving a batch between backends (CPU <-> GPU)
or continuing a partially-traced batch after preemption.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from raytrace_tpu.rays import RayBatch

_VERSION = 1


def save_rays(path: str, rays: RayBatch, **metadata):
    """Write the batch (and optional scalar metadata) to an NPZ."""
    payload = {
        f"field_{name}": np.asarray(getattr(rays, name))
        for name in (f.name for f in dataclasses.fields(rays))
    }
    payload["checkpoint_version"] = np.asarray(_VERSION)
    for k, v in metadata.items():
        payload[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_rays(path: str) -> tuple[RayBatch, dict]:
    """Read a batch checkpoint; returns (rays, metadata)."""
    with np.load(path) as data:
        version = int(data["checkpoint_version"])
        if version != _VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        fields = {}
        meta = {}
        for key in data.files:
            if key.startswith("field_"):
                fields[key[len("field_"):]] = jnp.asarray(data[key])
            elif key.startswith("meta_"):
                meta[key[len("meta_"):]] = data[key]
    return RayBatch(**fields), meta
