"""Irawan woven-cloth BRDF: wft parsing, yarn lookup, closed-form
integrands, normalization (ref: src/bsdfs/irawan.{h,cpp})."""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.render.irawan import (
    build_pattern, irawan_eval, irawan_kd, parse_wft,
)

# A plain-weave pattern in the reference's wft dialect (cotton-like
# numbers; staple warp/weft yarns with twist).
PLAIN_WEAVE = """
/* plain weave */
weave {
  name = "Cotton",
  tileWidth = 2,
  tileHeight = 2,
  alpha = 0.3,
  beta = 12,
  ss = 0,
  hWidth = 0.6,
  warpArea = 1,
  weftArea = 1,
  dWarpUmaxOverDWarp = 15,
  dWarpUmaxOverDWeft = 15,
  dWeftUmaxOverDWarp = 15,
  dWeftUmaxOverDWeft = 15,
  fineness = 10,
  period = 100,

  pattern {
    1, 2,
    2, 1
  },

  yarn {
    type = warp,
    psi = 10,
    umax = 25,
    kappa = 0.3,
    width = 1.2,
    length = 2.4,
    centerU = 0.25,
    centerV = 0.5,
    kd = {0.3, 0.05, 0.05},
    ks = {0.4, 0.35, 0.35},
  },
  yarn {
    type = weft,
    psi = 10,
    umax = 25,
    kappa = 0.3,
    width = 1.2,
    length = 2.4,
    centerU = 0.75,
    centerV = 0.5,
    kd = {0.05, 0.05, 0.3},
    ks = {0.35, 0.35, 0.4},
  },
}
"""

FILAMENT_WEAVE = PLAIN_WEAVE.replace("psi = 10", "psi = 0").replace(
    'name = "Cotton"', 'name = "Silk"')


class TestParser:
    def test_fields(self):
        spec = parse_wft(PLAIN_WEAVE)
        assert spec["name"] == "Cotton"
        assert spec["tileWidth"] == 2 and spec["tileHeight"] == 2
        assert spec["pattern"] == [1, 2, 2, 1]
        assert len(spec["yarns"]) == 2
        y0, y1 = spec["yarns"]
        assert y0["type"] == 0 and y1["type"] == 1
        np.testing.assert_allclose(y0["umax"], np.deg2rad(25), rtol=1e-6)
        np.testing.assert_allclose(y0["psi"], np.deg2rad(10), rtol=1e-6)
        np.testing.assert_allclose(y0["kd"], [0.3, 0.05, 0.05])
        np.testing.assert_allclose(spec["beta"], 12.0)
        np.testing.assert_allclose(spec["dWarpUmaxOverDWarp"],
                                   np.deg2rad(15), rtol=1e-6)

    def test_dollar_substitution(self):
        txt = PLAIN_WEAVE.replace("alpha = 0.3", "alpha = $alpha")
        spec = parse_wft(txt, {"alpha": 0.7})
        np.testing.assert_allclose(spec["alpha"], 0.7)

    def test_pattern_size_check(self):
        import pytest
        bad = PLAIN_WEAVE.replace("1, 2,\n    2, 1", "1, 2, 1")
        with pytest.raises(ValueError):
            parse_wft(bad)


def _cos_hemi(key, n):
    u = jax.random.uniform(key, (n, 2))
    r = jnp.sqrt(u[:, 0])
    phi = 2 * jnp.pi * u[:, 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi),
                      jnp.sqrt(jnp.maximum(1 - u[:, 0], 0.0))], -1)


class TestEval:
    def _pat(self, txt=PLAIN_WEAVE):
        return build_pattern(parse_wft(txt), repeat_u=4.0, repeat_v=4.0)

    def test_finite_nonnegative(self):
        pat = self._pat()
        n = 8192
        k = jax.random.PRNGKey(0)
        wi = _cos_hemi(jax.random.fold_in(k, 0), n)
        wo = _cos_hemi(jax.random.fold_in(k, 1), n)
        uv = jax.random.uniform(jax.random.fold_in(k, 2), (n, 2))
        f = np.asarray(irawan_eval(pat, uv, wi, wo))
        assert np.isfinite(f).all()
        assert (f >= 0).all()
        assert f.max() > 0

    def test_filament_variant(self):
        pat = self._pat(FILAMENT_WEAVE)
        n = 8192
        k = jax.random.PRNGKey(3)
        wi = _cos_hemi(jax.random.fold_in(k, 0), n)
        wo = _cos_hemi(jax.random.fold_in(k, 1), n)
        uv = jax.random.uniform(jax.random.fold_in(k, 2), (n, 2))
        f = np.asarray(irawan_eval(pat, uv, wi, wo))
        assert np.isfinite(f).all() and (f >= 0).all() and f.max() > 0

    def test_below_horizon_zero(self):
        pat = self._pat()
        wi = jnp.asarray([[0.0, 0.0, 1.0]])
        wo = jnp.asarray([[0.0, 0.5, -0.8]])
        uv = jnp.asarray([[0.3, 0.6]])
        assert float(irawan_eval(pat, uv, wi, wo).sum()) == 0.0

    def test_diffuse_lookup_matches_pattern(self):
        """kd lookup returns the selected yarn's diffuse color."""
        pat = self._pat()
        # repeat 4: uv in the first tile quadrant cell (0,0) -> pattern[0,0]
        # = yarn 1 (warp, red-ish kd)
        uv = jnp.asarray([[0.01, 0.99]])   # v flipped in lookup
        kd = np.asarray(irawan_kd(pat, uv))[0]
        assert kd[0] > kd[2], kd           # warp yarn is red-dominant
        uv2 = jnp.asarray([[0.13, 0.99]])  # next cell -> weft (blue)
        kd2 = np.asarray(irawan_kd(pat, uv2))[0]
        assert kd2[2] > kd2[0], kd2

    def test_specular_normalization(self):
        """With the MC normalization, the cosine-averaged max-channel
        specular reflectance is ~1 for ks=1 (the reference's invariant:
        nSamples / (result.max() * pi))."""
        txt = PLAIN_WEAVE.replace("ks = {0.4, 0.35, 0.35}",
                                  "ks = {1, 1, 1}").replace(
            "ks = {0.35, 0.35, 0.4}", "ks = {1, 1, 1}").replace(
            "kd = {0.3, 0.05, 0.05}", "kd = {0, 0, 0}").replace(
            "kd = {0.05, 0.05, 0.3}", "kd = {0, 0, 0}")
        pat = build_pattern(parse_wft(txt), repeat_u=4.0, repeat_v=4.0)
        n = 60000
        k = jax.random.PRNGKey(9)
        wi = _cos_hemi(jax.random.fold_in(k, 0), n)
        wo = _cos_hemi(jax.random.fold_in(k, 1), n)
        uv = jax.random.uniform(jax.random.fold_in(k, 2), (n, 2))
        f = np.asarray(irawan_eval(pat, uv, wi, wo))
        # E_cos-wo[f/cos] * pi = directional-hemispherical reflectance
        # averaged over cosine wi and uv; max channel ~ 1 by construction
        refl = f / np.maximum(np.asarray(wo)[:, 2:3], 1e-9) * np.pi
        assert abs(refl.mean(0).max() - 1.0) < 0.1, refl.mean(0)


class TestSceneIntegration:
    def _xml_scene(self, wft_text, extra_bsdf=""):
        import os
        import tempfile

        from drmlt_mitsuba.scene.xml import load_scene_xml
        wf = tempfile.NamedTemporaryFile("w", suffix=".wft", delete=False)
        wf.write(wft_text)
        wf.close()
        xml = f"""<scene version="0.5.0">
          <sensor type="perspective">
            <float name="fov" value="60"/>
            <transform name="toWorld">
              <lookat origin="0, 0, -3" target="0, 0, 0" up="0, 1, 0"/>
            </transform>
            <film type="hdrfilm">
              <integer name="width" value="16"/>
              <integer name="height" value="16"/>
            </film>
          </sensor>
          <shape type="rectangle">
            <bsdf type="irawan">
              <string name="filename" value="{wf.name}"/>
              <float name="repeatU" value="4"/>
              <float name="repeatV" value="4"/>
            </bsdf>
          </shape>
          <shape type="rectangle">
            <transform name="toWorld">
              <scale value="4"/>
              <translate z="-5"/>
            </transform>
            <emitter type="area"><rgb name="radiance" value="3"/></emitter>
          </shape>
        </scene>"""
        xf = tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False)
        xf.write(xml)
        xf.close()
        try:
            scene, _ = load_scene_xml(xf.name)
        finally:
            os.unlink(xf.name)
            os.unlink(wf.name)
        return scene

    def test_xml_load(self):
        from drmlt_mitsuba.scene.types import BSDF_IRAWAN
        scene = self._xml_scene(PLAIN_WEAVE)
        assert scene.irawan is not None
        assert scene.irawan.tile == (2, 2)
        kinds = np.asarray(scene.materials.kind)
        assert (kinds == BSDF_IRAWAN).any()

    def test_diffuse_cloth_equals_diffuse(self):
        """Cloth with ks=0 and uniform kd is EXACTLY a diffuse surface:
        full-render image equality against a diffuse-material scene."""
        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import render_pt
        from drmlt_mitsuba.render import film as filmlib
        from drmlt_mitsuba.scene.types import (
            BSDF_DIFFUSE,
        )

        txt = PLAIN_WEAVE
        for old in ("ks = {0.4, 0.35, 0.35}", "ks = {0.35, 0.35, 0.4}"):
            txt = txt.replace(old, "ks = {0, 0, 0}")
        for old in ("kd = {0.3, 0.05, 0.05}", "kd = {0.05, 0.05, 0.3}"):
            txt = txt.replace(old, "kd = {0.7, 0.7, 0.7}")
        cloth = self._xml_scene(txt)

        # same scene with the cloth row swapped to plain diffuse 0.7
        diff = cloth.replace(
            irawan=None,
            materials=cloth.materials.replace(
                kind=jnp.where(
                    cloth.materials.kind == 15, BSDF_DIFFUSE,
                    cloth.materials.kind),
                albedo=jnp.full_like(cloth.materials.albedo, 0.7),
                kinds_present=(BSDF_DIFFUSE,),
            ))
        cfg = PathConfig(max_depth=3, rr_depth=100)
        fc = filmlib.make_film_config(16, 16, "box")
        f1 = render_pt(cloth, cfg, jax.random.PRNGKey(0), 16 * 16 * 16,
                       fc, mode="accum")
        f2 = render_pt(diff, cfg, jax.random.PRNGKey(0), 16 * 16 * 16,
                       fc, mode="accum")
        i1 = np.asarray(filmlib.develop(fc, f1, mode="accum"))
        i2 = np.asarray(filmlib.develop(fc, f2, mode="accum"))
        np.testing.assert_allclose(i1, i2, rtol=2e-3, atol=1e-5)

    def test_specular_cloth_renders(self):
        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import render_pt
        from drmlt_mitsuba.render import film as filmlib

        scene = self._xml_scene(PLAIN_WEAVE)
        cfg = PathConfig(max_depth=3, rr_depth=100)
        fc = filmlib.make_film_config(16, 16, "box")
        film = render_pt(scene, cfg, jax.random.PRNGKey(1), 16 * 16 * 16,
                         fc, mode="accum")
        img = np.asarray(filmlib.develop(fc, film, mode="accum"))
        assert np.isfinite(img).all()
        assert img.max() > 0
