"""Ray-scene intersection tests (ShapeKDTree::rayIntersect analog)."""
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.ops.intersect import intersect, occluded
from drmlt_mitsuba.scene.builders import cornell_box, furnace_sphere


def test_cornell_walls():
    scene = cornell_box()
    # straight into the back wall, above the boxes (tall box is 330 high)
    o = jnp.asarray([[278.0, 400.0, -100.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    h = intersect(scene, o, d)
    assert bool(h.valid[0])
    np.testing.assert_allclose(float(h.t[0]), 656.0, atol=0.5)
    np.testing.assert_allclose(np.asarray(h.p[0]), [278, 400, 556], atol=0.5)
    # normal faces the ray
    assert float(jnp.sum(h.ng[0] * d[0])) < 0

    # upward ray hits the light patch
    o = jnp.asarray([[278.0, 273.0, 279.0]])
    d = jnp.asarray([[0.0, 1.0, 0.0]])
    h = intersect(scene, o, d)
    assert bool(h.valid[0]) and int(h.emitter_id[0]) >= 0


def test_miss():
    scene = cornell_box()
    o = jnp.asarray([[278.0, 273.0, -900.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    h = intersect(scene, o, d)
    assert not bool(h.valid[0])


def test_sphere():
    scene = furnace_sphere()
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    h = intersect(scene, o, d)
    assert bool(h.valid[0])
    np.testing.assert_allclose(float(h.t[0]), 2.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(h.ng[0]), [0, 0, -1], atol=1e-4)


def test_occlusion():
    scene = cornell_box()
    o = jnp.asarray([[278.0, 100.0, 279.0]] * 2)
    d = jnp.asarray([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    # up: blocked by the light/ceiling within 600 units; down: floor at 100
    occ = occluded(scene, o, d, jnp.asarray([600.0, 50.0]))
    assert bool(occ[0])
    assert not bool(occ[1])


def test_tmax_respected():
    scene = cornell_box()
    o = jnp.asarray([[278.0, 273.0, -100.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    h = intersect(scene, o, d, t_max=jnp.asarray([100.0]))
    assert not bool(h.valid[0])
