"""Bidirectional layer tests: per-strategy unbiasedness, full-MIS BDPT and
MMLT consistency against the unidirectional path tracer (the reference's
bdpt-vs-path cross-check), and MMLT-over-MCMC integration."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.integrators.bidir import (
    BDPTConfig, trace_bdpt, trace_mmlt,
)
from drmlt_mitsuba.integrators.drmlt import DRMLTConfig, render_drmlt
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.mmlt import make_mmlt_trace, mmlt_masks
from drmlt_mitsuba.integrators.path import render_pt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box

W = H = 16


@pytest.fixture(scope="module")
def refs():
    scene = cornell_box(W, H)
    fc = filmlib.make_film_config(W, H, "box")

    def pt_mean(depth, spp_factor=16):
        f = render_pt(scene, PathConfig(max_depth=depth, rr_depth=100),
                      jax.random.PRNGKey(40 + depth), 16384 * spp_factor, fc,
                      mode="accum")
        return np.asarray(
            filmlib.develop(fc, f, mode="accum")
        ).mean(axis=(0, 1))

    return scene, fc, pt_mean(1), pt_mean(2), pt_mean(3)


def _mc_mean(scene, fc, bcfg, n_batches=12, batch=4096, **kw):
    @jax.jit
    def run(key, film):
        u = jax.random.uniform(key, (batch, bcfg.n_dims))
        sp = trace_bdpt(scene, bcfg, u, **kw)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                             mode="splat")

    film = filmlib.new_film(fc)
    for i in range(n_batches):
        film = run(jax.random.fold_in(jax.random.PRNGKey(5), i), film)
    img = filmlib.develop(fc, film, mode="splat",
                          scale=W * H / (n_batches * batch))
    return np.asarray(img).mean(axis=(0, 1))


class TestStrategies:
    """Each (s,t) strategy alone is unbiased for its path-length transport."""

    def test_direct_strategies_agree(self, refs):
        scene, fc, pt1, pt2, _ = refs
        bcfg = BDPTConfig(max_depth=2)
        direct = pt2 - pt1   # 3-vertex transport
        for only in [(0, 3), (1, 2), (2, 1)]:
            m = _mc_mean(scene, fc, bcfg, mis=False, only=only)
            np.testing.assert_allclose(
                m, direct, rtol=0.25,
                err_msg=f"strategy {only} biased: {m} vs {direct}",
            )

    def test_visible_light_strategies(self, refs):
        scene, fc, pt1, _, _ = refs
        bcfg = BDPTConfig(max_depth=2)
        for only in [(0, 2), (1, 1)]:
            m = _mc_mean(scene, fc, bcfg, mis=False, only=only)
            np.testing.assert_allclose(m, pt1, rtol=0.15, err_msg=str(only))


class TestBDPT:
    def test_matches_pt(self, refs):
        scene, fc, _, _, pt3 = refs
        m = _mc_mean(scene, fc, BDPTConfig(max_depth=3), n_batches=16)
        np.testing.assert_allclose(m, pt3, rtol=0.1)

    def test_no_light_image(self, refs):
        """light_image=False drops t=1 strategies; MIS reweights so the
        total stays unbiased."""
        scene, fc, _, _, pt3 = refs
        m = _mc_mean(scene, fc,
                     BDPTConfig(max_depth=3, light_image=False),
                     n_batches=16)
        np.testing.assert_allclose(m, pt3, rtol=0.1)


class TestMMLT:
    def test_matches_pt(self, refs):
        scene, fc, _, _, pt3 = refs
        bcfg = BDPTConfig(max_depth=3)
        D = 3

        @jax.jit
        def run(key, film):
            k1, k2 = jax.random.split(key)
            u = jax.random.uniform(k1, (4096, bcfg.n_dims + 1))
            depth = jax.random.randint(k2, (4096,), 1, D + 1)
            sp = trace_mmlt(scene, bcfg, u, depth)
            pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
            return filmlib.splat(fc, film, pos,
                                 sp.value.reshape(-1, 3) * D, mode="splat")

        film = filmlib.new_film(fc)
        n = 16
        for i in range(n):
            film = run(jax.random.fold_in(jax.random.PRNGKey(6), i), film)
        img = np.asarray(filmlib.develop(fc, film, mode="splat",
                                         scale=W * H / (n * 4096)))
        np.testing.assert_allclose(img.mean(axis=(0, 1)), pt3, rtol=0.1)

    def test_drmlt_over_mmlt(self, refs):
        """The flagship configuration: DRMLT (orbital) driving the MMLT
        technique with pinned depth + frozen strategy dims."""
        scene, fc, _, _, pt3 = refs
        bcfg = BDPTConfig(max_depth=3)
        frozen, pinned, n_dims = mmlt_masks(bcfg)
        trace = make_mmlt_trace(scene, bcfg)
        img, aux = render_drmlt(
            trace, DRMLTConfig(type="orbital", n_chains=1024,
                               n_bootstrap=16384),
            fc, jax.random.PRNGKey(2), n_dims, 500,
            frozen_mask=frozen, pinned_mask=pinned,
        )
        img = np.asarray(img)
        assert np.all(np.isfinite(img))
        err = np.abs(img.mean((0, 1)) - pt3).mean() / pt3.mean()
        assert err < 0.15, err
        # depth dim pinned: chains kept their bootstrap depth
        assert float(np.asarray(aux["stats"]["accept2"]).mean()) > 1e-4


class TestFixEmitterPath:
    def test_drmlt_mmlt_fix_emitter(self, refs):
        """fixEmitterPath: stage 2 freezes the emitter dims except for
        light-tracing chains; the render stays consistent with PT."""
        scene, fc, _, _, pt3 = refs
        from drmlt_mitsuba.integrators.mmlt import (
            mmlt_emitter_mask, mmlt_lt_mask_fn,
        )

        bcfg = BDPTConfig(max_depth=3)
        frozen, pinned, n_dims = mmlt_masks(bcfg)
        trace = make_mmlt_trace(scene, bcfg)
        img, aux = render_drmlt(
            trace,
            DRMLTConfig(type="green", n_chains=1024, n_bootstrap=16384,
                        fix_emitter_path=True),
            fc, jax.random.PRNGKey(9), n_dims, 500,
            frozen_mask=frozen, pinned_mask=pinned,
            emitter_mask=mmlt_emitter_mask(bcfg, n_dims),
            lt_mask_fn=mmlt_lt_mask_fn(bcfg),
        )
        img = np.asarray(img)
        assert np.all(np.isfinite(img))
        err = np.abs(img.mean((0, 1)) - pt3).mean() / pt3.mean()
        assert err < 0.2, err


def test_bdpt_mirror_chain_matches_pt():
    """Regression for the delta-chain MIS bias: with a mirror tall box,
    k>=3 specular chains were weighted 1/(1+sum_ri) with an inconsistent
    Dirac convention (forward pdf stored 1*conversion, reverse stored a
    remapped 0 without conversion), measuring ~8% low at max_depth 4
    cumulatively (scripts/repro_mirror_bias.py).  BDPT must match PT."""
    scene = cornell_box(W, H, tall_box_material="mirror")
    fc = filmlib.make_film_config(W, H, "box")
    f = render_pt(scene, PathConfig(max_depth=4, rr_depth=100),
                  jax.random.PRNGKey(44), 16384 * 32, fc, mode="accum")
    pt = np.asarray(filmlib.develop(fc, f, mode="accum")).mean((0, 1))
    bd = _mc_mean(scene, fc, BDPTConfig(max_depth=4), n_batches=24,
                  batch=8192)
    ratio = bd.mean() / pt.mean()
    assert 0.96 < ratio < 1.04, ratio


def test_bdpt_textured_scene_matches_pt(tmp_path):
    """Textured albedos now evaluate inside bidir connections (SubpathSoA
    carries uv): BDPT on a checkerboard-floor scene matches PT.  Before
    the uv threading, connections used the constant base albedo and this
    oracle failed."""
    import numpy as np

    from drmlt_mitsuba.integrators.bidir import BDPTConfig, trace_bdpt
    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.path import render_pt
    from drmlt_mitsuba.render import film as filmlib
    from drmlt_mitsuba.scene.xml import load_scene_xml

    W = H = 16
    xml = f"""<scene version="0.6.0">
      <sensor type="perspective">
        <float name="fov" value="60"/>
        <transform name="toWorld">
          <lookat origin="0, 1.2, -3" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
          <integer name="width" value="{W}"/>
          <integer name="height" value="{H}"/>
        </film>
      </sensor>
      <shape type="rectangle">
        <transform name="toWorld">
          <scale value="3"/>
          <rotate x="1" angle="-90"/>
          <translate y="-0.5"/>
        </transform>
        <bsdf type="diffuse">
          <texture name="reflectance" type="checkerboard">
            <rgb name="color0" value="0.1, 0.1, 0.7"/>
            <rgb name="color1" value="0.7, 0.1, 0.1"/>
            <float name="uscale" value="4"/>
            <float name="vscale" value="4"/>
          </texture>
        </bsdf>
      </shape>
      <shape type="rectangle">
        <transform name="toWorld">
          <rotate x="1" angle="90"/>
          <translate y="2.5"/>
        </transform>
        <emitter type="area"><rgb name="radiance" value="6"/></emitter>
      </shape>
    </scene>"""
    xf = tmp_path / "tex.xml"
    xf.write_text(xml)
    scene, _ = load_scene_xml(str(xf))
    assert scene.textures is not None

    fc = filmlib.make_film_config(W, H, "box")
    f = render_pt(scene, PathConfig(max_depth=3, rr_depth=100),
                  jax.random.PRNGKey(0), 16384 * 16, fc, mode="accum")
    pt = np.asarray(filmlib.develop(fc, f, mode="accum"))

    bcfg = BDPTConfig(max_depth=3)

    @jax.jit
    def run(key, film):
        u = jax.random.uniform(key, (4096, bcfg.n_dims))
        sp = trace_bdpt(scene, bcfg, u)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                             mode="splat")

    film = filmlib.new_film(fc)
    n = 24
    for i in range(n):
        film = run(jax.random.fold_in(jax.random.PRNGKey(7), i), film)
    bd = np.asarray(filmlib.develop(fc, film, mode="splat",
                                    scale=W * H / (n * 4096)))
    # overall energy AND per-channel balance must agree (the checkerboard
    # colors differ per channel: a constant-albedo fallback shifts them)
    np.testing.assert_allclose(bd.mean(axis=(0, 1)), pt.mean(axis=(0, 1)),
                               rtol=0.1)
