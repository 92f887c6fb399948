"""Frozen dataclasses registered as JAX pytrees.

`@dataclass` makes a class a frozen dataclass whose fields are pytree
children, except those declared with `field(pytree_node=False)`, which are
static metadata (hashable; part of the jit cache key).  Instances get
`.replace(**changes)`.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """dataclasses.field with a flag marking the field static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)
