"""BDPT/MMLT with non-area emitters: point, spot, constant environment.

VERDICT round 1 item: the bidir layer silently dropped everything but
area emitters (light_subpath rejected other rows, escaped eye rays never
evaluated the environment).  These tests pin BDPT == PT on point-lit,
spot-lit, and env-lit scenes (ref: vertex.cpp:37-350 handles every
emitter kind through the vertex abstraction).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.integrators.bidir import (
    BDPTConfig, trace_bdpt, trace_mmlt,
)
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import render_pt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene import types as st
from drmlt_mitsuba.scene.builders import cornell_box

W = H = 16


def _delight(scene):
    """Cornell geometry with the area light removed."""
    tris = scene.tris.replace(
        emitter_id=jnp.full_like(scene.tris.emitter_id, -1)
    )
    return scene.replace(tris=tris)


def _point_lit():
    scene = _delight(cornell_box(W, H))
    em = st.build_emitters(
        scene.tris, np.zeros((0, 3), np.float32),
        point_pos=np.asarray([[278.0, 500.0, 279.5]]),
        point_intensity=np.asarray([[4e5, 3.4e5, 1.7e5]]),
    )
    return scene.replace(emitters=em)


def _spot_lit():
    scene = _delight(cornell_box(W, H))
    em = st.build_emitters(
        scene.tris, np.zeros((0, 3), np.float32),
        spots=[([278.0, 500.0, 279.5], [6e5, 5e5, 2.5e5],
                [0.0, -1.0, 0.0], 40.0)],
    )
    return scene.replace(emitters=em)


def _env_lit():
    scene = _delight(cornell_box(W, H))
    em = st.build_emitters(
        scene.tris, np.zeros((0, 3), np.float32),
        env_radiance=(1.0, 0.9, 0.7),
    )
    return scene.replace(emitters=em)


def _pt_mean(scene, fc, depth, spp_factor=24):
    f = render_pt(scene, PathConfig(max_depth=depth, rr_depth=100),
                  jax.random.PRNGKey(17), 16384 * spp_factor, fc,
                  mode="accum")
    return np.asarray(filmlib.develop(fc, f, mode="accum")).mean(axis=(0, 1))


def _bdpt_mean(scene, fc, bcfg, n_batches=16, batch=4096):
    @jax.jit
    def run(key, film):
        u = jax.random.uniform(key, (batch, bcfg.n_dims))
        sp = trace_bdpt(scene, bcfg, u)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                             mode="splat")

    film = filmlib.new_film(fc)
    for i in range(n_batches):
        film = run(jax.random.fold_in(jax.random.PRNGKey(9), i), film)
    img = filmlib.develop(fc, film, mode="splat",
                          scale=W * H / (n_batches * batch))
    return np.asarray(img).mean(axis=(0, 1))


@pytest.mark.parametrize("make", [_point_lit, _spot_lit, _env_lit],
                         ids=["point", "spot", "env"])
def test_bdpt_matches_pt(make):
    scene = make()
    fc = filmlib.make_film_config(W, H, "box")
    depth = 3
    pt = _pt_mean(scene, fc, depth)
    bd = _bdpt_mean(scene, fc, BDPTConfig(max_depth=depth))
    np.testing.assert_allclose(bd, pt, rtol=0.12)


def test_mmlt_strategies_match_pt_env():
    """MMLT per-depth strategy sum == PT on the env-lit scene (the env
    contribution rides the s=0 strategies)."""
    scene = _env_lit()
    fc = filmlib.make_film_config(W, H, "box")
    D = 3
    bcfg = BDPTConfig(max_depth=D)
    pt = _pt_mean(scene, fc, D)

    @jax.jit
    def run(key, film):
        k1, k2 = jax.random.split(key)
        u = jax.random.uniform(k1, (4096, bcfg.n_dims + 1))
        depth = jax.random.randint(k2, (4096,), 1, D + 1)
        sp = trace_mmlt(scene, bcfg, u, depth)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3) * D,
                             mode="splat")

    film = filmlib.new_film(fc)
    n = 16
    for i in range(n):
        film = run(jax.random.fold_in(jax.random.PRNGKey(6), i), film)
    img = np.asarray(filmlib.develop(fc, film, mode="splat",
                                     scale=W * H / (n * 4096)))
    np.testing.assert_allclose(img.mean(axis=(0, 1)), pt, rtol=0.12)
