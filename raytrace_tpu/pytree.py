"""Frozen dataclasses registered as JAX pytrees.

Array-valued fields are pytree leaves (traced, differentiable); fields made
with ``static_field`` are static metadata, part of the tree structure, so a
change of value means a new trace.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept out of the pytree leaves."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _replace(self, **updates):
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Frozen dataclass, registered as a pytree, with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = _replace
    return cls
