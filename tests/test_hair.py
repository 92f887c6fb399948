"""Hair shape: .hair loaders (text + binary), fiber simplification, tube
tessellation, and XML/scene integration (ref: src/shapes/hair.cpp)."""
import os
import struct
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.scene.hair import (
    load_hair, simplify_fibers, tessellate_hair,
)


def _write_text_hair(path):
    with open(path, "w") as f:
        f.write("0 0 0\n0 0 1\n0 0 2\n\n1 0 0\n1 0 1\n")


def _write_binary_hair(path):
    with open(path, "wb") as f:
        f.write(b"BINARY_HAIR")
        f.write(struct.pack("<I", 5))
        inf = float("inf")
        # fiber 1: 3 vertices (first prefixed by inf), fiber 2: 2 vertices
        f.write(struct.pack("<4f", inf, 0, 0, 0))
        f.write(struct.pack("<3f", 0, 0, 1))
        f.write(struct.pack("<3f", 0, 0, 2))
        f.write(struct.pack("<4f", inf, 1, 0, 0))
        f.write(struct.pack("<3f", 1, 0, 1))


class TestLoader:
    def test_text(self):
        with tempfile.NamedTemporaryFile(suffix=".hair", delete=False) as f:
            path = f.name
        _write_text_hair(path)
        try:
            v, fid = load_hair(path)
        finally:
            os.unlink(path)
        assert v.shape == (5, 3)
        np.testing.assert_array_equal(fid, [0, 0, 0, 1, 1])

    def test_binary(self):
        with tempfile.NamedTemporaryFile(suffix=".hair", delete=False) as f:
            path = f.name
        _write_binary_hair(path)
        try:
            v, fid = load_hair(path)
        finally:
            os.unlink(path)
        assert v.shape == (5, 3)
        np.testing.assert_array_equal(fid, [0, 0, 0, 1, 1])
        np.testing.assert_allclose(v[3], [1, 0, 0])

    def test_simplify_straight_runs(self):
        """Collinear interior vertices get merged (1-degree threshold)."""
        v = np.array([[0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 0, 3],
                      [0, 1, 3]], np.float32)
        fid = np.zeros(5, np.int32)
        v2, f2 = simplify_fibers(v, fid)
        assert len(v2) < 5
        # endpoints and the corner survive
        assert any(np.allclose(x, [0, 0, 0]) for x in v2)
        assert any(np.allclose(x, [0, 1, 3]) for x in v2)


class TestTessellation:
    def test_counts_and_radius(self):
        v = np.array([[0, 0, 0], [0, 0, 1], [0, 0, 2]], np.float32)
        fid = np.zeros(3, np.int32)
        verts, faces, nrm = tessellate_hair(v, fid, 0.1, sides=4)
        assert verts.shape == (12, 3)      # 3 rings x 4
        assert faces.shape == (16, 3)      # 2 segments x 4 x 2
        # ring vertices lie at the radius from the fiber axis (z)
        r = np.linalg.norm(verts[:, :2], axis=1)
        np.testing.assert_allclose(r, 0.1, atol=1e-5)
        # radial normals are unit and perpendicular to the axis
        np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0,
                                   atol=1e-5)
        np.testing.assert_allclose(nrm[:, 2], 0.0, atol=1e-5)

    def test_fiber_breaks_are_respected(self):
        """No faces bridge two different fibers."""
        v = np.array([[0, 0, 0], [0, 0, 1], [5, 0, 0], [5, 0, 1]],
                     np.float32)
        fid = np.array([0, 0, 1, 1], np.int32)
        verts, faces, _ = tessellate_hair(v, fid, 0.1, sides=3)
        assert faces.shape == (12, 3)      # 2 segments only
        fv = verts[faces.reshape(-1)].reshape(-1, 3, 3)
        span = fv[:, :, 0].max(axis=1) - fv[:, :, 0].min(axis=1)
        assert (span < 1.0).all()          # never spans x=0 to x=5


class TestSceneIntegration:
    def test_xml_render_hits_hair(self):
        """A thick 'hair' in front of the camera occludes the emitter
        behind it: center pixels differ from an empty scene."""
        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import render_pt
        from drmlt_mitsuba.render import film as filmlib
        from drmlt_mitsuba.scene.xml import load_scene_xml

        with tempfile.NamedTemporaryFile(suffix=".hair", delete=False,
                                         mode="w") as f:
            hpath = f.name
            f.write("-2 0 2\n0 0.4 2\n2 0 2\n")
        xml = f"""<scene version="0.5.0">
          <sensor type="perspective">
            <float name="fov" value="60"/>
            <transform name="toWorld">
              <lookat origin="0, 0, -2" target="0, 0, 1" up="0, 1, 0"/>
            </transform>
            <film type="hdrfilm">
              <integer name="width" value="32"/>
              <integer name="height" value="32"/>
            </film>
          </sensor>
          <shape type="hair">
            <string name="filename" value="{hpath}"/>
            <float name="radius" value="0.3"/>
            <bsdf type="diffuse"><rgb name="reflectance" value="0.5"/></bsdf>
          </shape>
          <shape type="rectangle">
            <transform name="toWorld">
              <scale value="4"/>
              <rotate y="1" angle="180"/>
              <translate z="6"/>
            </transform>
            <emitter type="area"><rgb name="radiance" value="5"/></emitter>
          </shape>
        </scene>"""
        with tempfile.NamedTemporaryFile("w", suffix=".xml",
                                         delete=False) as f:
            xpath = f.name
            f.write(xml)
        try:
            scene, _ = load_scene_xml(xpath)
        finally:
            os.unlink(xpath)
            os.unlink(hpath)
        cfg = PathConfig(max_depth=2, rr_depth=100)
        fc = filmlib.make_film_config(32, 32, "box")
        film = render_pt(scene, cfg, jax.random.PRNGKey(0), 32 * 32 * 8,
                         fc, mode="accum")
        img = np.asarray(filmlib.develop(fc, film, mode="accum"))
        assert np.isfinite(img).all()
        lum = img.mean(-1) if img.ndim == 3 else img
        # the strand crosses the central band: its darkest pixels are far
        # below the emitter-lit background
        band = lum[8:24, 4:28]
        assert band.min() < 0.3 * np.median(lum), (
            band.min(), np.median(lum))
        # and most of the image still sees the emitter
        assert np.median(lum) > 1.0


class TestDeformable:
    """Keyframe mesh interpolation at a fixed render time (ref:
    src/shapes/deformable.cpp; no shutter dimension here, see PARITY)."""

    def _scene(self, time_default=None):
        import textwrap
        objs = []
        for z in (0.0, 2.0):
            f = tempfile.NamedTemporaryFile("w", suffix=".obj",
                                            delete=False)
            f.write(textwrap.dedent(f"""\
                v -1 -1 {z}
                v 1 -1 {z}
                v 0 1 {z}
                f 1 2 3
            """))
            f.close()
            objs.append(f.name)
        xml = f"""<scene version="0.5.0">
          <sensor type="perspective">
            <film type="hdrfilm">
              <integer name="width" value="8"/>
              <integer name="height" value="8"/>
            </film>
          </sensor>
          <shape type="deformable">
            <string name="times" value="0, 1"/>
            <shape type="obj"><string name="filename" value="{objs[0]}"/></shape>
            <shape type="obj"><string name="filename" value="{objs[1]}"/></shape>
          </shape>
          <shape type="rectangle">
            <emitter type="area"><rgb name="radiance" value="1"/></emitter>
          </shape>
        </scene>"""
        f = tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False)
        f.write(xml)
        f.close()
        from drmlt_mitsuba.scene.xml import load_scene_xml
        try:
            defaults = {} if time_default is None else {
                "time": time_default}
            scene, _ = load_scene_xml(f.name, defaults=defaults)
        finally:
            os.unlink(f.name)
            for o in objs:
                os.unlink(o)
        return scene

    def test_midpoint_interpolation(self):
        scene = self._scene()            # default time = 0.5
        # the deformable triangle is the first mesh: z must be 1.0
        z = np.asarray(scene.tris.v0)[:, 2]
        assert np.isclose(z[0], 1.0, atol=1e-5), z[:3]

    def test_time_zero(self):
        scene = self._scene(time_default="0")
        z = np.asarray(scene.tris.v0)[:, 2]
        assert np.isclose(z[0], 0.0, atol=1e-5), z[:3]

    def test_time_clamped(self):
        scene = self._scene(time_default="7")   # beyond last keyframe
        z = np.asarray(scene.tris.v0)[:, 2]
        assert np.isclose(z[0], 2.0, atol=1e-5), z[:3]
