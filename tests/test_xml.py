"""Scene-XML loader + mesh IO + EXR IO tests."""
import os

import jax
import numpy as np
import pytest

from drmlt_mitsuba.scene.xml import load_scene_xml
from drmlt_mitsuba.scene import mesh_io
from drmlt_mitsuba.utils.exr import read_exr, write_exr

DATA = os.path.join(os.path.dirname(__file__), "data")


class TestXml:
    def test_load_cornell(self):
        scene, settings = load_scene_xml(
            os.path.join(DATA, "cornell.xml"),
            defaults={"integrator": "drmlt"},
        )
        assert settings.integrator["type"] == "drmlt"
        assert settings.integrator["maxDepth"] == 4
        assert settings.width == 64 and settings.filter_name == "box"
        assert settings.spp == 16
        # 6 rectangles x 2 tris = 12 triangles; 1 sphere
        assert scene.tris.v0.shape[0] == 12
        assert scene.spheres.center.shape[0] == 1
        # light: 2 emissive triangles with power-weighted pmf
        assert scene.emitters.tri_idx.shape[0] == 2
        np.testing.assert_allclose(
            float(np.asarray(scene.emitters.pmf).sum()), 1.0, atol=1e-6
        )
        # materials: white/red/green(twosided)/metal + inline light bsdf
        assert scene.materials.kind.shape[0] == 5

    def test_default_substitution(self):
        _, s1 = load_scene_xml(os.path.join(DATA, "cornell.xml"),
                               defaults={"integrator": "path", "spp": 99})
        assert s1.integrator["type"] == "path"
        assert s1.spp == 99

    def test_renders(self):
        """The loaded scene actually renders with the path tracer."""
        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import trace_paths
        import jax.numpy as jnp

        scene, _ = load_scene_xml(os.path.join(DATA, "cornell.xml"),
                                  defaults={"integrator": "path"})
        cfg = PathConfig(max_depth=3, rr_depth=100)
        u = jax.random.uniform(jax.random.PRNGKey(0), (512, cfg.n_dims))
        sp = trace_paths(scene, cfg, u)
        assert bool(jnp.all(jnp.isfinite(sp.value)))
        assert float(jnp.mean(sp.lum)) > 0


class TestMeshIO:
    def test_obj_roundtrip(self, tmp_path):
        p = tmp_path / "tri.obj"
        p.write_text(
            "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
            "vn 0 0 1\nvn 0 0 1\nvn 0 0 1\nvn 0 0 1\n"
            "f 1//1 2//2 4//4 3//3\n"
        )
        v, f, n, uv = mesh_io.load_obj(str(p))
        assert v.shape == (4, 3)
        assert f.shape == (2, 3)  # quad fan-triangulated
        np.testing.assert_allclose(n, [[0, 0, 1]] * 4)

    def test_ply_ascii(self, tmp_path):
        p = tmp_path / "tri.ply"
        p.write_text(
            "ply\nformat ascii 1.0\n"
            "element vertex 3\nproperty float x\nproperty float y\n"
            "property float z\n"
            "element face 1\nproperty list uchar int vertex_indices\n"
            "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n"
        )
        v, f, n, uv = mesh_io.load_ply(str(p))
        assert v.shape == (3, 3) and f.shape == (1, 3) and n is None

    def test_ply_binary(self, tmp_path):
        import struct

        header = (
            b"ply\nformat binary_little_endian 1.0\n"
            b"element vertex 3\nproperty float x\nproperty float y\n"
            b"property float z\n"
            b"element face 1\nproperty list uchar int vertex_indices\n"
            b"end_header\n"
        )
        body = b"".join(
            struct.pack("<fff", *v) for v in [(0, 0, 0), (1, 0, 0), (0, 1, 0)]
        ) + struct.pack("<Biii", 3, 0, 1, 2)
        p = tmp_path / "b.ply"
        p.write_bytes(header + body)
        v, f, n, uv = mesh_io.load_ply(str(p))
        np.testing.assert_allclose(v[1], [1, 0, 0])
        np.testing.assert_array_equal(f[0], [0, 1, 2])

    def test_serialized(self, tmp_path):
        """Write a minimal Mitsuba .serialized container and read it back."""
        import struct
        import zlib

        verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        faces = np.asarray([[0, 1, 2]], np.uint32)
        flags = 0x1000  # single precision, no normals/uvs
        stream = struct.pack("<I", flags) + struct.pack("<QQ", 3, 1)
        stream += verts.tobytes() + faces.tobytes()
        blob = struct.pack("<HH", 0x041C, 0x0003) + zlib.compress(stream)
        blob += struct.pack("<Q", 0) + struct.pack("<I", 1)
        p = tmp_path / "m.serialized"
        p.write_bytes(blob)
        v, f, n, uv = mesh_io.load_serialized(str(p))
        np.testing.assert_allclose(v, verts)
        np.testing.assert_array_equal(f, faces.astype(np.int32))


class TestExr:
    @pytest.mark.parametrize("half,comp", [
        (False, "none"), (True, "none"), (False, "zip"), (False, "zips"),
    ])
    def test_roundtrip(self, tmp_path, half, comp):
        img = np.random.default_rng(0).random((17, 23, 3)).astype(np.float32)
        p = str(tmp_path / "t.exr")
        write_exr(p, img, half=half, compression=comp)
        r = read_exr(p)
        tol = 2e-3 if half else 1e-7
        assert r.shape == img.shape
        np.testing.assert_allclose(r, img, atol=tol)


class TestMediumXml:
    def test_vol_roundtrip(self, tmp_path):
        import numpy as np

        from drmlt_mitsuba.scene.xml import read_vol, write_vol

        dens = np.random.RandomState(0).rand(4, 5, 6).astype(np.float32)
        p = str(tmp_path / "d.vol")
        write_vol(p, dens, [-1, -2, -3], [1, 2, 3])
        back, bmin, bmax = read_vol(p)
        np.testing.assert_array_equal(back, dens)
        np.testing.assert_allclose(bmin, [-1, -2, -3])
        np.testing.assert_allclose(bmax, [1, 2, 3])

    def test_heterogeneous_medium_loads(self, tmp_path):
        import numpy as np

        from drmlt_mitsuba.render.medium import HeterogeneousMedium
        from drmlt_mitsuba.scene.xml import load_scene_xml, write_vol

        dens = np.random.RandomState(1).rand(8, 8, 8).astype(np.float32)
        write_vol(str(tmp_path / "smoke.vol"), dens, [-1, -1, -1], [1, 1, 1])
        (tmp_path / "s.xml").write_text("""<scene version="0.6.0">
  <sensor type="perspective"><float name="fov" value="45"/>
   <film type="hdrfilm"><integer name="width" value="8"/>
    <integer name="height" value="8"/></film></sensor>
  <medium type="heterogeneous" name="exterior">
   <volume name="density" type="gridvolume">
    <string name="filename" value="smoke.vol"/></volume>
   <rgb name="sigmaT" value="0.8 0.8 0.8"/>
   <rgb name="albedo" value="0.9"/>
   <phase type="hg"><float name="g" value="0.3"/></phase>
  </medium>
  <emitter type="constant"><rgb name="radiance" value="1"/></emitter>
 </scene>""")
        scene, _ = load_scene_xml(str(tmp_path / "s.xml"))
        assert isinstance(scene.medium, HeterogeneousMedium)
        np.testing.assert_allclose(np.asarray(scene.medium.density), dens)
        np.testing.assert_allclose(float(scene.medium.g), 0.3, atol=1e-6)

    def test_homogeneous_medium_sigma_s_a(self, tmp_path):
        import numpy as np

        from drmlt_mitsuba.render.medium import HomogeneousMedium
        from drmlt_mitsuba.scene.xml import load_scene_xml

        (tmp_path / "h.xml").write_text("""<scene version="0.6.0">
  <sensor type="perspective"><float name="fov" value="45"/>
   <film type="hdrfilm"><integer name="width" value="8"/>
    <integer name="height" value="8"/></film></sensor>
  <medium type="homogeneous" name="exterior">
   <rgb name="sigmaS" value="0.6"/>
   <rgb name="sigmaA" value="0.2"/>
  </medium>
  <emitter type="constant"><rgb name="radiance" value="1"/></emitter>
 </scene>""")
        scene, _ = load_scene_xml(str(tmp_path / "h.xml"))
        assert isinstance(scene.medium, HomogeneousMedium)
        np.testing.assert_allclose(np.asarray(scene.medium.sigma_t), 0.8,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(scene.medium.albedo), 0.75,
                                   atol=1e-6)


class TestSunsky:
    def test_bake_physical_behavior(self):
        import numpy as np

        from drmlt_mitsuba.scene.sunsky import bake_sky

        sd = np.array([0.3, 0.8, 0.5])
        sd /= np.linalg.norm(sd)
        img = bake_sky(turbidity=3.0, sun_dir=sd, height=64)
        H, W = img.shape[:2]
        assert img.shape == (64, 128, 3)
        assert np.isfinite(img).all() and img.min() >= 0.0
        zen = img[2].mean(axis=0)
        hz = img[H // 2 - 2].mean(axis=0)
        # blue zenith, whiter horizon (classic clear-sky gradient)
        assert zen[2] > zen[0], zen
        assert hz[2] / hz.sum() < zen[2] / zen.sum()
        # ground hemisphere is much dimmer than the sky
        assert img[H // 2 + 4:].mean() < 0.5 * img[:H // 2 - 4].mean()

    def test_sun_energy_conserved_subpixel(self):
        """The sub-texel sun deposits the same total power at any bake
        resolution (disk-resolved or not)."""
        import numpy as np

        from drmlt_mitsuba.scene.sunsky import bake_sky

        sd = np.array([0.2, 0.9, 0.4])
        sd /= np.linalg.norm(sd)

        def power(h):
            img = bake_sky(sun_dir=sd, with_sky=False, height=h)
            H, W = img.shape[:2]
            v = (np.arange(H) + 0.5) / H
            sr = (np.pi / H) * (2 * np.pi / W) * np.sin(v * np.pi)
            return float((img.mean(-1) * sr[:, None]).sum())

        p64, p512 = power(64), power(512)
        assert p64 > 0 and abs(p64 - p512) / p512 < 0.25, (p64, p512)

    def test_sunsky_xml_loads_as_envmap(self, tmp_path):
        import numpy as np

        from drmlt_mitsuba.scene.xml import load_scene_xml

        (tmp_path / "s.xml").write_text("""<scene version="0.6.0">
  <sensor type="perspective"><float name="fov" value="45"/>
   <film type="hdrfilm"><integer name="width" value="8"/>
    <integer name="height" value="8"/></film></sensor>
  <emitter type="sunsky">
   <float name="turbidity" value="3"/>
   <vector name="sunDirection" x="0.3" y="0.8" z="0.5"/>
   <float name="scale" value="0.01"/>
  </emitter>
 </scene>""")
        scene, _ = load_scene_xml(str(tmp_path / "s.xml"))
        assert scene.emitters.env_image is not None
        img = np.asarray(scene.emitters.env_image)
        assert np.isfinite(img).all() and img.max() > 0

    def test_sun_position_algorithm(self):
        import numpy as np

        from drmlt_mitsuba.scene.sunsky import sun_direction_from_time

        hi = sun_direction_from_time(month=6, day=21, hour=12.0,
                                     latitude=35.0, longitude=135.0,
                                     timezone=9.0)
        lo = sun_direction_from_time(month=12, day=21, hour=12.0,
                                     latitude=35.0, longitude=135.0,
                                     timezone=9.0)
        assert hi[1] > lo[1] > 0.0      # summer noon higher than winter
        night = sun_direction_from_time(month=6, day=21, hour=0.0,
                                        latitude=35.0, longitude=135.0,
                                        timezone=9.0)
        assert night[1] < 0.0           # midnight: below horizon


class TestVertexColors:
    """vertexcolors texture: per-vertex PLY colors interpolated
    barycentrically (ref: src/textures/vertexcolors.cpp)."""

    def _scene(self, colors):
        import tempfile

        import numpy as np

        from drmlt_mitsuba.scene.xml import load_scene_xml
        ply = tempfile.NamedTemporaryFile("w", suffix=".ply", delete=False)
        ply.write("ply\nformat ascii 1.0\n"
                  "element vertex 4\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  "property uchar red\nproperty uchar green\n"
                  "property uchar blue\n"
                  "element face 2\n"
                  "property list uchar int vertex_indices\nend_header\n")
        verts = [(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)]
        for (x, y, z), c in zip(verts, colors):
            ply.write(f"{x} {y} {z} {c[0]} {c[1]} {c[2]}\n")
        ply.write("3 0 1 2\n3 0 2 3\n")
        ply.close()
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
          <shape type="ply">
            <string name="filename" value="{ply.name}"/>
            <bsdf type="diffuse">
              <texture name="reflectance" type="vertexcolors"/>
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
            os.unlink(ply.name)
        return scene

    def test_scene_carries_colors(self):
        import numpy as np
        scene = self._scene([(255, 0, 0)] * 4)
        assert scene.vcolors is not None
        assert scene.vcolors.shape[1:] == (3, 3)
        np.testing.assert_allclose(
            np.asarray(scene.vcolors)[0], [[1, 0, 0]] * 3, atol=1e-6)

    def test_uniform_colors_match_constant_diffuse(self):
        import jax
        import numpy as np

        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import render_pt
        from drmlt_mitsuba.render import film as filmlib
        import jax.numpy as jnp

        vc = self._scene([(178, 178, 178)] * 4)
        const = vc.replace(
            vcolors=None,
            materials=vc.materials.replace(
                tex_id=jnp.full_like(vc.materials.tex_id, -1),
                albedo=jnp.full_like(vc.materials.albedo, 178.0 / 255.0),
            ))
        cfg = PathConfig(max_depth=3, rr_depth=100)
        fc = filmlib.make_film_config(16, 16, "box")
        f1 = render_pt(vc, cfg, jax.random.PRNGKey(0), 16 * 16 * 16, fc,
                       mode="accum")
        f2 = render_pt(const, cfg, jax.random.PRNGKey(0), 16 * 16 * 16, fc,
                       mode="accum")
        i1 = np.asarray(filmlib.develop(fc, f1, mode="accum"))
        i2 = np.asarray(filmlib.develop(fc, f2, mode="accum"))
        assert i1.mean() > 0.01
        np.testing.assert_allclose(i1, i2, rtol=2e-3, atol=1e-5)

    def test_gradient_colors_vary_across_image(self):
        import jax
        import numpy as np

        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import render_pt
        from drmlt_mitsuba.render import film as filmlib

        scene = self._scene(
            [(255, 0, 0), (0, 0, 255), (0, 0, 255), (255, 0, 0)])
        cfg = PathConfig(max_depth=2, rr_depth=100)
        fc = filmlib.make_film_config(16, 16, "box")
        film = render_pt(scene, cfg, jax.random.PRNGKey(0), 16 * 16 * 32,
                         fc, mode="accum")
        img = np.asarray(filmlib.develop(fc, film, mode="accum"))
        # left half of the quad is red-dominant, right half blue-dominant
        left = img[6:10, 4:7]
        right = img[6:10, 9:12]
        red_left = left[..., 0].mean() > 1.2 * left[..., 2].mean()
        blue_right = right[..., 2].mean() > 1.2 * right[..., 0].mean()
        assert red_left and blue_right, (left.mean(0).mean(0),
                                         right.mean(0).mean(0))


REF_TESTS = "/root/reference/data/tests"


@pytest.mark.skipif(not os.path.isdir(REF_TESTS),
                    reason="reference scenes not mounted")
def test_reference_dialect_scenes_load():
    """Every scene the reference ships for its own test harness loads
    through this loader and builds a renderable Scene (dialect
    compatibility evidence; warnings for approximated constructs are
    fine, exceptions are not)."""
    import glob
    import warnings as _w

    from drmlt_mitsuba.scene.xml import load_scene_xml

    paths = sorted(glob.glob(os.path.join(REF_TESTS, "*.xml")))
    assert paths, "no reference scenes found"
    for p in paths:
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            scene, settings = load_scene_xml(p)
        assert scene.tris.v0.shape[0] >= 1, p
