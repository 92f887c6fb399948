"""Thinlens camera in the bidirectional layer.

VERDICT round-1 weak item: bidir sensor importance was pinhole-only.  With
the focal-plane film mapping, the conditional directional density from any
lens point keeps the pinhole form 1/(A cos^3) and only the uv mapping
shifts, so BDPT/MMLT with a lens must agree with the thinlens path tracer
(ref: src/sensors/thinlens.cpp bidir eval/pdf).
"""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.bidir import (
    BDPTConfig, trace_bdpt, trace_mmlt, trace_mmlt_dense,
)
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import render_pt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box

W = H = 16


def _lens_scene():
    scene = cornell_box(W, H)
    cam = scene.camera.replace(
        aperture_radius=jnp.float32(25.0),
        focus_distance=jnp.float32(1073.0),   # the back wall plane
    )
    return scene.replace(camera=cam)


def test_bdpt_thinlens_matches_pt():
    scene = _lens_scene()
    fc = filmlib.make_film_config(W, H, "box")
    pt = render_pt(
        scene, PathConfig(max_depth=3, rr_depth=100, thinlens=True),
        jax.random.PRNGKey(0), 16384 * 16, fc, mode="accum",
    )
    pt = np.asarray(filmlib.develop(fc, pt, mode="accum")).mean(axis=(0, 1))

    bcfg = BDPTConfig(max_depth=3, thinlens=True)

    @jax.jit
    def run(key, film):
        u = jax.random.uniform(key, (4096, bcfg.n_dims))
        sp = trace_bdpt(scene, bcfg, u)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                             mode="splat")

    film = filmlib.new_film(fc)
    n = 16
    for i in range(n):
        film = run(jax.random.fold_in(jax.random.PRNGKey(7), i), film)
    bd = np.asarray(
        filmlib.develop(fc, film, mode="splat", scale=W * H / (n * 4096))
    ).mean(axis=(0, 1))
    np.testing.assert_allclose(bd, pt, rtol=0.1)


def test_mmlt_selected_matches_dense_thinlens():
    scene = _lens_scene()
    cfg = BDPTConfig(max_depth=4, thinlens=True)
    R = 2048
    key = jax.random.PRNGKey(5)
    u = jax.random.uniform(key, (R, 1 + cfg.n_dims))
    depth = 1 + jax.random.randint(jax.random.fold_in(key, 1), (R,), 0,
                                   cfg.max_depth)
    a = trace_mmlt_dense(scene, cfg, u, depth)
    b = trace_mmlt(scene, cfg, u, depth)
    va, vb = np.asarray(a.value[:, 0]), np.asarray(b.value[:, 0])
    rel = np.abs(va - vb) / (np.abs(va) + 1e-4)
    bad = (rel > 1e-3).any(-1)
    assert bad.sum() <= R // 1000, bad.sum()
    np.testing.assert_allclose(va.mean(0), vb.mean(0), rtol=2e-3, atol=1e-5)
