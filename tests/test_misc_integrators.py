"""Small inventoried integrators (integrators/misc.py): ptracer MC
consistency against the path tracer, field AOV sanity, motion AOV
against Scene.motion, multichannel stacking."""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.misc import (
    render_field, render_motion_aov, render_multichannel, render_ptracer,
)
from drmlt_mitsuba.integrators.path import render_pt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box


def test_ptracer_matches_pt_mean():
    """Light tracing covers every transport length through its single
    t=1 strategy per length, so the image MEAN must agree with the
    unidirectional path tracer within MC noise (the per-pixel variance
    profile differs — that is the point of the technique)."""
    scene = cornell_box(16, 16)
    fc = filmlib.make_film_config(16, 16, "box")
    img_lt = np.asarray(render_ptracer(
        scene, fc, jax.random.PRNGKey(0), 1 << 18, max_depth=4))[..., :3]
    pcfg = PathConfig(max_depth=4, rr_depth=100)
    film = render_pt(scene, pcfg, jax.random.PRNGKey(1), 16 * 16 * 256,
                     fc, mode="accum")
    img_pt = np.asarray(filmlib.develop(fc, film, mode="accum"))[..., :3]
    assert abs(img_lt.mean() - img_pt.mean()) / img_pt.mean() < 0.05, (
        img_lt.mean(), img_pt.mean())
    # row means agree coarsely (light tracing is noisy on bright rows
    # at this budget; the global mean above is the real oracle)
    rl = img_lt.mean(axis=(1, 2))
    rp = img_pt.mean(axis=(1, 2))
    assert np.abs(rl - rp).max() / img_pt.mean() < 0.6


def test_field_aovs():
    scene = cornell_box(16, 16)
    fc = filmlib.make_film_config(16, 16, "box")
    n = np.asarray(render_field(scene, fc, jax.random.PRNGKey(1),
                                "shnormal", spp=8))[..., :3]
    # normals are unit where hit (most of the film for the cornell cam)
    mag = np.linalg.norm(n, axis=-1)
    # box-filter averaging shrinks normals on geometric boundaries, so
    # magnitudes are <= ~1 with interior pixels near 1
    assert mag.max() < 1.05 and mag[mag > 0.5].mean() > 0.7
    d = np.asarray(render_field(scene, fc, jax.random.PRNGKey(2),
                                "distance", spp=8))[..., 0]
    assert d[d > 0].min() > 100 and d.max() < 5000   # cornell units
    a = np.asarray(render_field(scene, fc, jax.random.PRNGKey(3),
                                "albedo", spp=8))[..., :3]
    assert a.max() <= 1.0 + 1e-4 and a.mean() > 0.05


def test_motion_aov():
    from drmlt_mitsuba.scene.types import build_motion

    scene = cornell_box(16, 16)
    fc = filmlib.make_film_config(16, 16, "box")
    z = np.asarray(render_motion_aov(scene, fc, jax.random.PRNGKey(2)))
    assert np.abs(z).max() == 0.0                     # static scene
    # translate every triangle +x over the shutter: velocities point
    # right (positive pixel x) wherever the film sees geometry
    dx = jnp.where((scene.tris.emitter_id < 0)[:, None],
                   jnp.asarray([20.0, 0.0, 0.0]), 0.0)
    t1 = scene.tris.replace(v0=scene.tris.v0 + dx)
    scene_m = scene.replace(motion=build_motion(scene.tris, t1))
    v = np.asarray(render_motion_aov(scene_m, fc, jax.random.PRNGKey(2)))
    vx = v[..., 0]
    assert (vx > 0).mean() > 0.5 and np.abs(v[..., 2]).max() == 0.0


def test_multichannel():
    scene = cornell_box(16, 16)
    fc = filmlib.make_film_config(16, 16, "box")
    out = render_multichannel(scene, fc, jax.random.PRNGKey(0),
                              channels=("shnormal", "distance"), spp=4)
    assert out.shape == (16, 16, 6)
    assert np.isfinite(out).all()
