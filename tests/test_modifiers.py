"""Modifier BSDF layer: mask / 2-way mixture / smooth coating.

The reference wraps inner BSDF plugins in modifier plugins
(src/bsdfs/{mask,mixturebsdf,blendbsdf,coating}.cpp); here the modifiers
are per-row MaterialTable parameters applied by render/bsdf.py around the
core lobes.  Tests: eval/sample pdf consistency, furnace energy oracles,
and XML round-trips for each wrapper kind.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import trace_paths
from drmlt_mitsuba.render.bsdf import eval_bsdf, is_delta_kind, sample_bsdf
from drmlt_mitsuba.scene import types as st
from drmlt_mitsuba.scene.builders import furnace_sphere
from drmlt_mitsuba.scene.xml import load_scene_xml

R = 8192


def _wi(R):
    w = jnp.tile(jnp.asarray([0.3, 0.1, 0.95]), (R, 1))
    return w / jnp.linalg.norm(w, axis=-1, keepdims=True)


def _consistency(table, albedo=(0.6, 0.6, 0.6)):
    """For non-delta draws, sample weight must equal eval f/pdf exactly."""
    wi = _wi(R)
    u3 = jax.random.uniform(jax.random.PRNGKey(1), (R, 3))
    mat = jnp.zeros((R,), jnp.int32)
    alb = jnp.tile(jnp.asarray(albedo), (R, 1))
    s = sample_bsdf(table, mat, alb, wi, u3)
    v, p = eval_bsdf(table, mat, alb, wi, s.wo)
    nd = np.asarray(~s.delta)
    w_chk = np.asarray(v / jnp.maximum(p, 1e-12)[:, None])
    err = np.abs(w_chk - np.asarray(s.weight))[nd]
    assert np.all(np.isfinite(np.asarray(s.weight)))
    np.testing.assert_allclose(err.max(), 0.0, atol=1e-5)
    return s


def test_mask_consistency_and_energy():
    t = st.make_material_table(
        [dict(kind=st.BSDF_DIFFUSE, albedo=(0.6, 0.6, 0.6),
              opacity=(0.3, 0.3, 0.3))]
    )
    s = _consistency(t)
    # single-scatter reflectance: opacity*albedo + (1-opacity) passthrough
    np.testing.assert_allclose(
        float(s.weight.mean()), 0.3 * 0.6 + 0.7, atol=0.02
    )
    # null passthrough goes straight through
    thru = np.asarray(s.delta)
    assert thru.any()
    np.testing.assert_allclose(
        np.asarray(s.wo)[thru], -np.asarray(_wi(R))[thru], atol=1e-6
    )


def test_mixture_consistency_and_energy():
    t = st.make_material_table([
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.6, 0.6, 0.6), mix_other=1,
             mix_weight=0.4),
        dict(kind=st.BSDF_MIRROR, spec_refl=(1.0, 1.0, 1.0)),
    ])
    s = _consistency(t)
    # 0.6 * albedo(0.6) + 0.4 * mirror(1.0)
    np.testing.assert_allclose(
        float(s.weight.mean()), 0.6 * 0.6 + 0.4, atol=0.02
    )
    assert not bool(is_delta_kind(t, jnp.zeros((4,), jnp.int32))[0])


def test_mixture_two_diffuse_exact():
    """Blend of two diffuse lobes: f is the weighted albedo everywhere."""
    t = st.make_material_table([
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.9, 0.9, 0.9), mix_other=1,
             mix_weight=0.25),
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.1, 0.1, 0.1)),
    ])
    wi = _wi(16)
    wo = _wi(16) * jnp.asarray([-1.0, 1.0, 1.0])
    mat = jnp.zeros((16,), jnp.int32)
    alb = jnp.full((16, 3), 0.9)
    v, p = eval_bsdf(t, mat, alb, wi, wo)
    expect = (0.75 * 0.9 + 0.25 * 0.1) / np.pi * float(wo[0, 2])
    np.testing.assert_allclose(np.asarray(v), expect, rtol=1e-5)


def test_coating_consistency():
    t = st.make_material_table(
        [dict(kind=st.BSDF_DIFFUSE, albedo=(1.0, 1.0, 1.0), coat_eta=1.5)]
    )
    s = _consistency(t, albedo=(1.0, 1.0, 1.0))
    # coat reflection + transmitted diffuse; single-transmission model
    # loses a little energy (no internal TIR bounce), stays in [0.85, 1]
    m = float(s.weight.mean())
    assert 0.85 < m <= 1.0 + 1e-6, m
    # absorption tint darkens
    t2 = st.make_material_table(
        [dict(kind=st.BSDF_DIFFUSE, albedo=(1.0, 1.0, 1.0), coat_eta=1.5,
              coat_sigma_a=(0.5, 0.5, 0.5))]
    )
    s2 = _consistency(t2, albedo=(1.0, 1.0, 1.0))
    assert float(s2.weight.mean()) < m


def test_mask_furnace():
    """Masked unit-albedo diffuse is energy conserving: white furnace."""
    scene = furnace_sphere(albedo=1.0, env=1.0).replace(
        materials=st.make_material_table(
            [dict(kind=st.BSDF_DIFFUSE, albedo=(1.0, 1.0, 1.0),
                  opacity=(0.4, 0.4, 0.4))]
        )
    )
    cfg = PathConfig(max_depth=48, rr_depth=100, use_nee=False)
    u = jax.random.uniform(jax.random.PRNGKey(2), (4096, cfg.n_dims))
    sp = trace_paths(scene, cfg, u)
    vals = np.asarray(sp.value[:, 0, :])
    assert np.all(np.isfinite(vals))
    np.testing.assert_allclose(vals.mean(), 1.0, atol=1e-2)


def test_mixture_furnace():
    """50/50 mix of unit diffuse and mirror conserves energy."""
    scene = furnace_sphere(albedo=1.0, env=1.0).replace(
        materials=st.make_material_table([
            dict(kind=st.BSDF_DIFFUSE, albedo=(1.0, 1.0, 1.0), mix_other=1,
                 mix_weight=0.5),
            dict(kind=st.BSDF_MIRROR, spec_refl=(1.0, 1.0, 1.0)),
        ])
    )
    cfg = PathConfig(max_depth=48, rr_depth=100, use_nee=False)
    u = jax.random.uniform(jax.random.PRNGKey(3), (4096, cfg.n_dims))
    sp = trace_paths(scene, cfg, u)
    vals = np.asarray(sp.value[:, 0, :])
    np.testing.assert_allclose(vals.mean(), 1.0, atol=1e-2)


XML_TMPL = """<scene version="0.6.0">
  <integrator type="path"/>
  <sensor type="perspective">
    <transform name="toWorld">
      <lookat origin="0,0,3" target="0,0,0" up="0,1,0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="8"/><integer name="height" value="8"/>
    </film>
  </sensor>
  <shape type="rectangle">{bsdf}</shape>
  <emitter type="constant"><spectrum name="radiance" value="1"/></emitter>
</scene>"""


def _load(tmp_path, bsdf_xml):
    f = tmp_path / "s.xml"
    f.write_text(XML_TMPL.format(bsdf=bsdf_xml))
    scene, _ = load_scene_xml(str(f))
    return scene


def test_xml_mask(tmp_path):
    scene = _load(tmp_path, """
      <bsdf type="mask">
        <spectrum name="opacity" value="0.25"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.7,0.7,0.7"/></bsdf>
      </bsdf>""")
    t = scene.materials
    assert t.has_mask and not t.has_mixture and not t.has_coating
    np.testing.assert_allclose(np.asarray(t.opacity)[0], 0.25)
    np.testing.assert_allclose(np.asarray(t.albedo)[0], 0.7)


def test_xml_coating(tmp_path):
    scene = _load(tmp_path, """
      <bsdf type="coating">
        <float name="intIOR" value="1.7"/>
        <float name="thickness" value="2.0"/>
        <rgb name="sigmaA" value="0.1,0.2,0.3"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.5,0.5,0.5"/></bsdf>
      </bsdf>""")
    t = scene.materials
    assert t.has_coating
    np.testing.assert_allclose(np.asarray(t.coat_eta)[0], 1.7 / 1.000277,
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(t.coat_sigma_a)[0],
                               [0.2, 0.4, 0.6], rtol=1e-5)


def test_xml_blend(tmp_path):
    scene = _load(tmp_path, """
      <bsdf type="blendbsdf">
        <float name="weight" value="0.3"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.8,0.8,0.8"/></bsdf>
        <bsdf type="conductor"><string name="material" value="Au"/></bsdf>
      </bsdf>""")
    t = scene.materials
    assert t.has_mixture
    # row 0 = shape's material (first component), blended 0.3 to the other
    i = int(np.asarray(scene.tris.mat_id)[0])
    assert int(np.asarray(t.mix_other)[i]) >= 0
    np.testing.assert_allclose(float(np.asarray(t.mix_weight)[i]), 0.3,
                               rtol=1e-6)
    other = int(np.asarray(t.mix_other)[i])
    assert int(np.asarray(t.kind)[other]) == st.BSDF_CONDUCTOR


def test_xml_mixture_three_way(tmp_path):
    """3-component mixture becomes a chain of 2-way rows with renormalized
    link weights; the effective lobe weights match the declared ones."""
    scene = _load(tmp_path, """
      <bsdf type="mixturebsdf">
        <string name="weights" value="0.5, 0.3, 0.2"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="1,0,0"/></bsdf>
        <bsdf type="diffuse"><rgb name="reflectance" value="0,1,0"/></bsdf>
        <bsdf type="diffuse"><rgb name="reflectance" value="0,0,1"/></bsdf>
      </bsdf>""")
    t = scene.materials
    i = int(np.asarray(scene.tris.mat_id)[0])
    wi = _wi(4)
    wo = jnp.tile(jnp.asarray([0.0, 0.0, 1.0]), (4, 1))
    mat = jnp.full((4,), i, jnp.int32)
    alb = jnp.tile(jnp.asarray(np.asarray(t.albedo)[i]), (4, 1))
    v, _ = eval_bsdf(t, mat, alb, wi, wo)
    # f*cos = weighted albedo / pi (cos=1): channels recover the weights
    np.testing.assert_allclose(np.asarray(v)[0] * np.pi, [0.5, 0.3, 0.2],
                               rtol=1e-4)


def test_xml_plain_unchanged(tmp_path):
    """Scenes without modifiers keep the static fast path."""
    scene = _load(tmp_path, '<bsdf type="diffuse"/>')
    t = scene.materials
    assert not (t.has_mask or t.has_mixture or t.has_coating)
    assert t.opacity is None and t.mix_other is None and t.coat_eta is None
