"""core/struct.py: frozen dataclasses registered as pytrees, with static
fields kept out of the leaves and in the jit cache key."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from drmlt_mitsuba.core import struct


@struct.dataclass
class Rec:
    a: jnp.ndarray
    b: jnp.ndarray | None = None
    kind: int = struct.field(pytree_node=False, default=0)


def test_leaves_exclude_static_fields():
    r = Rec(a=jnp.ones(2), b=jnp.zeros(3), kind=7)
    leaves, treedef = jax.tree_util.tree_flatten(r)
    assert [x.shape for x in leaves] == [(2,), (3,)]
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.kind == 7 and isinstance(back, Rec)
    # None data fields are empty subtrees
    assert len(jax.tree_util.tree_leaves(Rec(a=jnp.ones(2)))) == 1


def test_replace_returns_new_instance():
    r = Rec(a=jnp.ones(2), kind=1)
    r2 = r.replace(kind=2, b=jnp.zeros(1))
    assert (r.kind, r.b) == (1, None)
    assert r2.kind == 2 and r2.b.shape == (1,)


def test_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        Rec(a=jnp.ones(2)).a = jnp.zeros(2)


def test_static_field_is_jit_cache_key():
    traces = []

    @jax.jit
    def f(r):
        traces.append(r.kind)
        return r.a * r.kind

    one, three = jnp.float32(1.0), jnp.float32(3.0)
    assert float(f(Rec(a=one, kind=2))) == 2.0
    assert float(f(Rec(a=three, kind=2))) == 6.0
    assert float(f(Rec(a=one, kind=5))) == 5.0
    assert traces == [2, 5]      # data change reuses, static change retraces


def test_tree_map_and_grad():
    r = Rec(a=jnp.asarray([1.0, 2.0]), b=jnp.asarray(3.0), kind=4)
    g = jax.grad(lambda r: jnp.sum(r.a ** 2) * r.b * r.kind)(r)
    assert isinstance(g, Rec) and g.kind == 4
    assert jnp.allclose(g.a, jnp.asarray([24.0, 48.0]))
    assert float(jax.tree.map(lambda x: x + 1, r).b) == 4.0
