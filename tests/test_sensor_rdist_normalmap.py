"""perspective_rdist radial distortion + bumpmap/normalmap perturbation +
the procedural texture kinds added in round 2.

Refs: src/sensors/perspective_rdist.cpp (kc polynomial),
src/bsdfs/{bumpmap,normalmap}.cpp, src/textures/.
"""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.core.transform import look_at
from drmlt_mitsuba.render.sensor import sample_ray
from drmlt_mitsuba.scene import types as st
from drmlt_mitsuba.scene.xml import load_scene_xml


def test_rdist_inversion_roundtrip():
    """sample_ray inverts the distortion polynomial: re-distorting the
    generated plane coords recovers the film coords exactly."""
    cam0 = st.make_camera(look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]), 60.0,
                          1.0)
    camd = st.make_camera(look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]), 60.0,
                          1.0, kc=[0.3, 0.1])
    uv = jnp.asarray([[0.5, 0.5], [0.9, 0.5], [0.9, 0.9], [0.1, 0.3]])
    _, d0 = sample_ray(cam0, uv)
    _, dd = sample_ray(camd, uv)
    # center ray unchanged; edge rays bend inward for positive kc
    np.testing.assert_allclose(np.asarray(d0[0]), np.asarray(dd[0]),
                               atol=1e-6)
    assert not np.allclose(np.asarray(d0[1]), np.asarray(dd[1]), atol=1e-4)
    x, y = dd[:, 0] / dd[:, 2], dd[:, 1] / dd[:, 2]
    r2 = x * x + y * y
    f = 1.0 + 0.3 * r2 + 0.1 * r2 * r2
    np.testing.assert_allclose(np.asarray(x * f),
                               np.asarray(d0[:, 0] / d0[:, 2]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(y * f),
                               np.asarray(d0[:, 1] / d0[:, 2]), atol=1e-5)


def test_rdist_xml(tmp_path):
    f = tmp_path / "r.xml"
    f.write_text("""<scene version="0.6.0">
      <sensor type="perspective_rdist">
        <string name="kc" value="0.2, -0.05"/>
        <film type="hdrfilm">
          <integer name="width" value="8"/><integer name="height" value="8"/>
        </film>
      </sensor>
      <shape type="rectangle"><bsdf type="diffuse"/></shape>
    </scene>""")
    scene, _ = load_scene_xml(str(f))
    assert scene.camera.rdist
    np.testing.assert_allclose(np.asarray(scene.camera.kc), [0.2, -0.05])


XML_NM = """<scene version="0.6.0">
  <sensor type="perspective">
    <transform name="toWorld">
      <lookat origin="0,0,3" target="0,0,0" up="0,1,0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="8"/><integer name="height" value="8"/>
    </film>
  </sensor>
  <shape type="rectangle">
    <bsdf type="{kind}">
      <texture type="{tex}" name="{texname}">{texprops}</texture>
      {inner}
    </bsdf>
  </shape>
  <emitter type="constant"><spectrum name="radiance" value="1"/></emitter>
</scene>"""


def test_normalmap_xml_and_identity(tmp_path):
    """A flat normal map (0.5, 0.5, 1) leaves the shading normal exactly
    unperturbed through the full tangent-frame transform."""
    import PIL.Image as Image

    flat = np.zeros((8, 8, 3), np.uint8)
    flat[..., 0] = 128
    flat[..., 1] = 128
    flat[..., 2] = 255
    Image.fromarray(flat).save(tmp_path / "flat.png")
    f = tmp_path / "n.xml"
    f.write_text(XML_NM.format(
        kind="normalmap", tex="bitmap", texname="normal",
        texprops=f'<string name="filename" value="{tmp_path}/flat.png"/>',
        inner='<bsdf type="diffuse"/>'))
    scene, _ = load_scene_xml(str(f))
    assert scene.materials.has_normalmap
    assert int(np.asarray(scene.materials.normal_tex_id)[
        int(np.asarray(scene.tris.mat_id)[0])]) >= 0

    from drmlt_mitsuba.integrators.path import apply_normal_map
    from drmlt_mitsuba.ops.intersect import intersect

    o = jnp.asarray([[0.2, 0.1, 3.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit = intersect(scene, o, d)
    ns2 = apply_normal_map(scene, hit, hit.ns)
    # sRGB-decoded 128/255 is not exactly 0.5; allow the quantization
    np.testing.assert_allclose(np.asarray(ns2), np.asarray(hit.ns),
                               atol=0.08)
    np.testing.assert_allclose(
        float(jnp.sum(ns2 * hit.ns, -1)[0]), 1.0, atol=5e-3)


def test_bumpmap_tilts_normals(tmp_path):
    """A height ramp bakes to tilted tangent-space normals: the perturbed
    normal leans against the gradient direction."""
    import PIL.Image as Image

    ramp = np.tile((np.arange(64, dtype=np.float32) * 4)[None, :, None],
                   (64, 1, 3)).astype(np.uint8)
    Image.fromarray(ramp).save(tmp_path / "ramp.png")
    f = tmp_path / "b.xml"
    f.write_text(XML_NM.format(
        kind="bumpmap", tex="bitmap", texname="map",
        texprops=f'<string name="filename" value="{tmp_path}/ramp.png"/>',
        inner='<bsdf type="diffuse"/>'))
    scene, _ = load_scene_xml(str(f))
    assert scene.materials.has_normalmap

    from drmlt_mitsuba.integrators.path import apply_normal_map
    from drmlt_mitsuba.ops.intersect import intersect

    o = jnp.asarray([[0.0, 0.0, 3.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit = intersect(scene, o, d)
    ns2 = apply_normal_map(scene, hit, hit.ns)
    cos = float(jnp.sum(ns2 * hit.ns, -1)[0])
    assert cos < 0.999, "ramp bumpmap must tilt the normal"
    assert np.isfinite(np.asarray(ns2)).all()


def test_grid_and_scale_textures(tmp_path):
    f = tmp_path / "g.xml"
    f.write_text(XML_NM.format(
        kind="diffuse", tex="gridtexture", texname="reflectance",
        texprops='<rgb name="color0" value="0.8,0.8,0.8"/>'
                 '<rgb name="color1" value="0.1,0.1,0.1"/>',
        inner=""))
    scene, _ = load_scene_xml(str(f))
    page = np.asarray(scene.textures.data[0])
    assert page.min() <= 0.11 and page.max() >= 0.79

    f2 = tmp_path / "s.xml"
    f2.write_text(XML_NM.format(
        kind="diffuse", tex="scale", texname="reflectance",
        texprops='<float name="scale" value="0.5"/>'
                 '<texture type="checkerboard" name="value">'
                 '<rgb name="color0" value="0.8,0.8,0.8"/>'
                 '<rgb name="color1" value="0.4,0.4,0.4"/></texture>',
        inner=""))
    scene2, _ = load_scene_xml(str(f2))
    page2 = np.asarray(scene2.textures.data[0])
    np.testing.assert_allclose(sorted(set(np.round(page2.ravel(), 3)))[:2],
                               [0.2, 0.4], atol=1e-3)
