"""Image environment map + ERPT tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import drmlt_mitsuba.scene.types as st
from drmlt_mitsuba.core import transform
from drmlt_mitsuba.integrators.erpt import ERPTConfig, render_erpt
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import render_pt, trace_paths
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.render.emitter import (
    env_dir_to_uv, env_uv_to_dir,
)
from drmlt_mitsuba.scene.builders import cornell_box


def _env_scene():
    he, we = 32, 64
    img = np.full((he, we, 3), 0.05, np.float32)
    img[8:12, 10:16] = [50.0, 30.0, 10.0]
    verts = np.asarray(
        [[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]], np.float32
    )
    faces = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    tris = st.build_triangles(verts, faces, np.zeros(2, np.int32),
                              np.full(2, -1, np.int32))
    emitters = st.build_emitters(tris, np.zeros((1, 3), np.float32),
                                 env_image=img)
    mats = st.make_material_table(
        [dict(kind=st.BSDF_DIFFUSE, albedo=(0.7, 0.7, 0.7))]
    )
    cam = st.make_camera(
        transform.look_at([0, 5, -20], [0, 0, 0], [0, 1, 0]), 30.0, 1.0
    )
    return st.Scene(tris=tris, spheres=st.empty_spheres(), materials=mats,
                    emitters=emitters, camera=cam)


class TestEnvmap:
    def test_uv_dir_roundtrip(self):
        uv = jax.random.uniform(jax.random.PRNGKey(0), (1000, 2))
        uv = uv * jnp.asarray([1.0, 0.98]) + jnp.asarray([0.0, 0.01])
        d = env_uv_to_dir(uv)
        np.testing.assert_allclose(
            np.asarray(jnp.linalg.norm(d, axis=-1)), 1.0, atol=1e-5
        )
        uv2 = env_dir_to_uv(d)
        np.testing.assert_allclose(np.asarray(uv2), np.asarray(uv),
                                   atol=1e-4)

    def test_nee_matches_bsdf_sampling(self):
        """The env-NEE+MIS estimator agrees with pure BSDF sampling — the
        importance-sampling unbiasedness oracle."""
        scene = _env_scene()
        cfg_mis = PathConfig(max_depth=2, rr_depth=100, use_nee=True)
        cfg_bs = PathConfig(max_depth=2, rr_depth=100, use_nee=False)
        m_mis = m_bs = 0.0
        for i in range(3):
            u = jax.random.uniform(jax.random.PRNGKey(i),
                                   (300_000, cfg_mis.n_dims))
            m_mis += float(trace_paths(scene, cfg_mis, u).lum.mean()) / 3
        for i in range(8):
            u = jax.random.uniform(jax.random.PRNGKey(50 + i),
                                   (300_000, cfg_bs.n_dims))
            m_bs += float(trace_paths(scene, cfg_bs, u).lum.mean()) / 8
        assert abs(m_mis - m_bs) / m_bs < 0.05, (m_mis, m_bs)

    def test_variance_reduction(self):
        """Env importance sampling slashes variance vs BSDF sampling for a
        small bright patch."""
        scene = _env_scene()
        u = jax.random.uniform(jax.random.PRNGKey(7), (100_000, 23 * 4))
        cfg_mis = PathConfig(max_depth=2, rr_depth=100, use_nee=True)
        cfg_bs = PathConfig(max_depth=2, rr_depth=100, use_nee=False)
        u = jax.random.uniform(jax.random.PRNGKey(7),
                               (100_000, cfg_mis.n_dims))
        s_mis = float(trace_paths(scene, cfg_mis, u).lum.std())
        s_bs = float(trace_paths(scene, cfg_bs, u).lum.std())
        assert s_mis < 0.5 * s_bs, (s_mis, s_bs)


class TestERPT:
    def test_matches_pt(self):
        """ERPT converges to the PT reference (per-batch normalization)."""
        scene = cornell_box(16, 16)
        cfg = PathConfig(max_depth=3, rr_depth=100)
        fc = filmlib.make_film_config(16, 16, "box")
        film = render_pt(scene, cfg, jax.random.PRNGKey(42), 16384 * 16, fc,
                         mode="accum")
        ref = np.asarray(filmlib.develop(fc, film, mode="accum"))

        trace = lambda u: trace_paths(scene, cfg, u)
        ecfg = ERPTConfig(n_chains=1024, chain_length=50,
                          samples_per_batch=8192)
        img, aux = render_erpt(trace, ecfg, fc, jax.random.PRNGKey(3),
                               cfg.n_dims, n_batches=6)
        img = np.asarray(img)
        assert np.all(np.isfinite(img))
        err = np.abs(img.mean((0, 1)) - ref.mean((0, 1))).mean() / ref.mean()
        assert err < 0.15, err
        acc = float(np.asarray(aux["accept"]).mean())
        assert 0.1 < acc < 0.95
