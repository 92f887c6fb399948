"""Checkpoint/resume tests."""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.mcmc import ChainState
from drmlt_mitsuba.parallel.checkpoint import (
    load_checkpoint, save_checkpoint,
)


def test_roundtrip(tmp_path):
    key = jax.random.PRNGKey(0)
    state = ChainState(
        u=jax.random.uniform(key, (64, 16)),
        lum=jnp.ones((64,)),
        pos=jnp.zeros((64, 1, 2)),
        value=jnp.ones((64, 1, 3)),
    )
    film = jnp.ones((8, 8, 4))
    p = str(tmp_path / "ckpt")
    save_checkpoint(p, state, film, 0.5, 123, key)
    st2, film2, b2, step2, key2, acc2 = load_checkpoint(p)
    np.testing.assert_array_equal(np.asarray(st2.u), np.asarray(state.u))
    np.testing.assert_array_equal(np.asarray(film2), np.asarray(film))
    assert b2 == 0.5 and step2 == 123 and acc2 is None
    np.testing.assert_array_equal(np.asarray(key2), np.asarray(key))


def test_point_light_nee():
    """Delta emitters feed NEE with MIS weight 1: a point light above a
    floor matches the inverse-square analytic value."""
    import drmlt_mitsuba.scene.types as st
    from drmlt_mitsuba.core import transform
    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.path import trace_paths

    verts = np.asarray(
        [[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]], np.float32
    )
    faces = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    tris = st.build_triangles(verts, faces, np.zeros(2, np.int32),
                              np.full(2, -1, np.int32))
    h, inten, rho = 10.0, 200.0, 0.6
    emitters = st.build_emitters(
        tris, np.zeros((1, 3), np.float32),
        point_pos=np.asarray([[0, h, 0]], np.float32),
        point_intensity=np.full((1, 3), inten, np.float32),
    )
    mats = st.make_material_table(
        [dict(kind=st.BSDF_DIFFUSE, albedo=(rho, rho, rho))]
    )
    cam = st.make_camera(
        transform.look_at([0, 5, -20], [0, 0, 0], [0, 1, 0]), 10.0, 1.0
    )
    scene = st.Scene(tris=tris, spheres=st.empty_spheres(), materials=mats,
                     emitters=emitters, camera=cam)
    cfg = PathConfig(max_depth=2, rr_depth=100)
    u = jax.random.uniform(jax.random.PRNGKey(1), (4096, cfg.n_dims))
    sp = trace_paths(scene, cfg, u)
    # all camera rays land near the origin; L = rho/pi * I cos / d^2 with
    # cos ~ h/d; sample mean should sit near the analytic value at (0,0,0)
    lum = np.asarray(sp.value[:, 0, 0])
    expected_center = rho / np.pi * inten * 1.0 / (h * h)
    assert 0.5 * expected_center < lum.mean() < 1.5 * expected_center
    assert np.all(np.isfinite(lum)) and lum.mean() > 0
