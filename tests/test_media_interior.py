"""Per-shape interior media: lane-tracked medium ids + boundary
transitions (ref: shapes carry interior/exterior medium refs,
src/librender/shape.cpp; HomogeneousMedium src/medium/homogeneous.cpp).

Oracles: Beer-Lambert attenuation through an absorbing null-boundary cube
(closed form per channel), the volumetric white furnace (albedo-1
scattering interior in a unit environment must return exactly 1), and XML
round-trips for shape-attached and ref-attached media.
"""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import trace_paths
from drmlt_mitsuba.scene.xml import load_scene_xml

XML_CUBE = """<scene version="0.6.0">
  <integrator type="volpath"/>
  <sensor type="perspective">
    <float name="fov" value="8"/>
    <transform name="toWorld">
      <lookat origin="0,0,6" target="0,0,0" up="0,1,0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="4"/><integer name="height" value="4"/>
    </film>
  </sensor>
  <shape type="cube">
    <bsdf type="null"/>
    <medium name="interior" type="homogeneous">
      <rgb name="sigmaT" value="{sigt}"/>
      <rgb name="albedo" value="{alb}"/>
      {phase}
    </medium>
  </shape>
  <emitter type="constant"><spectrum name="radiance" value="1"/></emitter>
</scene>"""


def _scene(tmp_path, sigt, alb, phase=""):
    f = tmp_path / "s.xml"
    f.write_text(XML_CUBE.format(sigt=sigt, alb=alb, phase=phase))
    scene, _ = load_scene_xml(str(f))
    return scene


def test_xml_interior_medium(tmp_path):
    scene = _scene(tmp_path, "0.3,0.5,0.7", "0,0,0")
    assert scene.media is not None
    np.testing.assert_allclose(np.asarray(scene.media.sigma_t)[0],
                               [0.3, 0.5, 0.7], rtol=1e-6)
    im = np.asarray(scene.materials.interior_medium)
    mat = np.asarray(scene.tris.mat_id)
    assert (im[mat] >= 0).all()
    # interior media must NOT leak into the global medium slot
    assert scene.medium is None


def test_xml_interior_medium_by_ref(tmp_path):
    f = tmp_path / "r.xml"
    f.write_text("""<scene version="0.6.0">
      <medium id="goo" type="homogeneous">
        <rgb name="sigmaS" value="0.4"/><rgb name="sigmaA" value="0.1"/>
      </medium>
      <sensor type="perspective">
        <film type="hdrfilm">
          <integer name="width" value="4"/><integer name="height" value="4"/>
        </film>
      </sensor>
      <shape type="cube">
        <bsdf type="dielectric"/>
        <ref name="interior" id="goo"/>
      </shape>
    </scene>""")
    scene, _ = load_scene_xml(str(f))
    assert scene.media is not None and scene.medium is None
    np.testing.assert_allclose(np.asarray(scene.media.sigma_t)[0], 0.5,
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(scene.media.albedo)[0], 0.8,
                               rtol=1e-5)


def test_beer_lambert_through_null_cube(tmp_path):
    """Absorbing-only interior: every channel attenuates exp(-sigma_c * 2)
    along the straight path through the unit-scaled ([-1,1]^3) cube."""
    sig = np.asarray([0.3, 0.5, 0.7])
    scene = _scene(tmp_path, "0.3,0.5,0.7", "0,0,0")
    cfg = PathConfig(max_depth=6, rr_depth=100, use_nee=False)
    u = jax.random.uniform(jax.random.PRNGKey(0), (16384, cfg.n_dims))
    sp = trace_paths(scene, cfg, u)
    vals = np.asarray(sp.value[:, 0, :])
    assert np.all(np.isfinite(vals))
    # fov 8 deg at distance 6: all rays pass nearly straight through
    expect = np.exp(-sig * 2.0)
    np.testing.assert_allclose(vals.mean(0), expect, rtol=0.03)


def test_volumetric_furnace_interior():
    """Albedo-1 scattering interior behind a null boundary in a unit
    environment is a furnace: radiance 1 regardless of sigma/g."""
    import pytest
    scene = None
    try:
        import tempfile, pathlib
        with tempfile.TemporaryDirectory() as td:
            scene = _scene(
                pathlib.Path(td), "1.5,1.5,1.5", "1,1,1",
                phase='<phase type="hg"><float name="g" value="0.4"/></phase>',
            )
    except Exception as e:   # pragma: no cover
        pytest.skip(f"scene build failed: {e}")
    cfg = PathConfig(max_depth=64, rr_depth=200, use_nee=False)
    u = jax.random.uniform(jax.random.PRNGKey(1), (8192, cfg.n_dims))
    sp = trace_paths(scene, cfg, u)
    vals = np.asarray(sp.value[:, 0, :])
    assert np.all(np.isfinite(vals))
    # truncation at depth 64 loses a little tail energy
    assert 0.97 < vals.mean() <= 1.005, vals.mean()


def test_nee_inside_medium(tmp_path):
    """NEE from scattering vertices attenuates by the lane's medium; the
    render with NEE must agree with the BSDF-sampling-only estimate."""
    f = tmp_path / "n.xml"
    f.write_text("""<scene version="0.6.0">
      <sensor type="perspective">
        <float name="fov" value="30"/>
        <transform name="toWorld">
          <lookat origin="0,0,6" target="0,0,0" up="0,1,0"/>
        </transform>
        <film type="hdrfilm">
          <integer name="width" value="4"/><integer name="height" value="4"/>
        </film>
      </sensor>
      <shape type="cube">
        <bsdf type="null"/>
        <medium name="interior" type="homogeneous">
          <rgb name="sigmaT" value="0.8"/><rgb name="albedo" value="0.9"/>
        </medium>
      </shape>
      <shape type="rectangle">
        <transform name="toWorld">
          <translate z="3.5"/><scale value="2"/>
        </transform>
        <emitter type="area"><rgb name="radiance" value="5,5,5"/></emitter>
      </shape>
    </scene>""")
    scene, _ = load_scene_xml(str(f))
    u = jax.random.uniform(jax.random.PRNGKey(2), (32768, 64))
    cfg_nee = PathConfig(max_depth=6, rr_depth=100, use_nee=True)
    cfg_no = PathConfig(max_depth=6, rr_depth=100, use_nee=False)
    a = np.asarray(
        trace_paths(scene, cfg_nee, u[:, :cfg_nee.n_dims]).value).mean()
    b = np.asarray(
        trace_paths(scene, cfg_no, u[:, :cfg_no.n_dims]).value).mean()
    assert np.isfinite(a) and np.isfinite(b)
    np.testing.assert_allclose(a, b, rtol=0.08)


class TestInteriorPhaseKinds:
    """Per-row phase kinds in the interior-media table (lane-parallel
    dispatch over the statically-present kind set)."""

    def test_rayleigh_row_energy(self, tmp_path):
        """Rayleigh interior fog: finite, positive, and close to the
        isotropic fog (same extinction; the lobe only redistributes)."""
        iso = _scene(tmp_path, "1.5,1.5,1.5", "0.7,0.7,0.7")
        ray = _scene(tmp_path, "1.5,1.5,1.5", "0.7,0.7,0.7",
                     phase='<phase type="rayleigh"/>')
        assert int(np.asarray(ray.media.phase_kind)[0]) == 1
        cfg = PathConfig(max_depth=16, rr_depth=100, use_nee=False)
        u = jax.random.uniform(jax.random.PRNGKey(3), (16384, cfg.n_dims))
        l_iso = float(trace_paths(iso, cfg, u).value[:, 0, :].mean())
        l_ray = float(trace_paths(ray, cfg, u).value[:, 0, :].mean())
        assert np.isfinite(l_ray) and l_ray > 0
        assert abs(l_iso - l_ray) / l_iso < 0.1, (l_iso, l_ray)

    def test_kkay_row_absorbs(self, tmp_path):
        """kkay (ks+kd < 1) loses energy per scatter: darker than the
        lossless isotropic fog in the furnace geometry."""
        iso = _scene(tmp_path, "1.5,1.5,1.5", "1,1,1")
        kkay = _scene(tmp_path, "1.5,1.5,1.5", "1,1,1",
                      phase='<phase type="kkay">'
                            '<float name="ks" value="0.4"/>'
                            '<float name="kd" value="0.2"/>'
                            '</phase>')
        assert int(np.asarray(kkay.media.phase_kind)[0]) == 2
        cfg = PathConfig(max_depth=16, rr_depth=100, use_nee=False)
        u = jax.random.uniform(jax.random.PRNGKey(4), (16384, cfg.n_dims))
        l_iso = float(trace_paths(iso, cfg, u).value[:, 0, :].mean())
        l_k = float(trace_paths(kkay, cfg, u).value[:, 0, :].mean())
        assert np.isfinite(l_k) and 0 < l_k < 0.9 * l_iso, (l_k, l_iso)

    def test_mixed_kind_rows_compile_and_render(self, tmp_path):
        """Two interior media with DIFFERENT phase kinds (HG + microflake)
        in one scene: the masked per-lane dispatch handles mixed lanes."""
        f = tmp_path / "mixed.xml"
        f.write_text("""<scene version="0.6.0">
          <sensor type="perspective">
            <float name="fov" value="25"/>
            <transform name="toWorld">
              <lookat origin="0,0,8" target="0,0,0" up="0,1,0"/>
            </transform>
            <film type="hdrfilm">
              <integer name="width" value="8"/>
              <integer name="height" value="8"/>
            </film>
          </sensor>
          <shape type="cube">
            <transform name="toWorld"><translate x="-1.2"/></transform>
            <bsdf type="null"/>
            <medium name="interior" type="homogeneous">
              <rgb name="sigmaT" value="1.2"/>
              <rgb name="albedo" value="0.8"/>
              <phase type="hg"><float name="g" value="0.4"/></phase>
            </medium>
          </shape>
          <shape type="cube">
            <transform name="toWorld"><translate x="1.2"/></transform>
            <bsdf type="null"/>
            <medium name="interior" type="homogeneous">
              <rgb name="sigmaT" value="1.2"/>
              <rgb name="albedo" value="0.8"/>
              <phase type="microflake">
                <float name="stddev" value="0.2"/>
                <vector name="orientation" x="0" y="1" z="0"/>
              </phase>
            </medium>
          </shape>
          <emitter type="constant">
            <spectrum name="radiance" value="1"/>
          </emitter>
        </scene>""")
        scene, _ = load_scene_xml(str(f))
        assert sorted(np.asarray(scene.media.phase_kind).tolist()) == [0, 3]
        cfg = PathConfig(max_depth=12, rr_depth=100, use_nee=False)
        u = jax.random.uniform(jax.random.PRNGKey(5), (8192, cfg.n_dims))
        vals = trace_paths(scene, cfg, u).value[:, 0, :]
        assert bool(jnp.isfinite(vals).all())
        assert float(vals.mean()) > 0

    def test_mixturephase_row(self, tmp_path):
        """2-component interior mixturephase: a 1.0-weight HG component
        equals plain HG exactly; a 50/50 hg+rayleigh blend renders
        finite with energy close to the isotropic fog."""
        hg = _scene(tmp_path, "1.5,1.5,1.5", "0.7,0.7,0.7",
                    phase='<phase type="hg"><float name="g" value="0.4"/>'
                          '</phase>')
        mix1 = _scene(tmp_path, "1.5,1.5,1.5", "0.7,0.7,0.7",
                      phase='<phase type="mixturephase">'
                            '<string name="weights" value="1, 0"/>'
                            '<phase type="hg"><float name="g" value="0.4"/></phase>'
                            '<phase type="rayleigh"/>'
                            '</phase>')
        cfg = PathConfig(max_depth=16, rr_depth=100, use_nee=False)
        u = jax.random.uniform(jax.random.PRNGKey(6), (8192, cfg.n_dims))
        l_hg = float(trace_paths(hg, cfg, u).value[:, 0, :].mean())
        l_m1 = float(trace_paths(mix1, cfg, u).value[:, 0, :].mean())
        np.testing.assert_allclose(l_m1, l_hg, rtol=1e-4)

        blend = _scene(tmp_path, "1.5,1.5,1.5", "0.7,0.7,0.7",
                       phase='<phase type="mixturephase">'
                             '<string name="weights" value="0.5, 0.5"/>'
                             '<phase type="hg"><float name="g" value="0.4"/></phase>'
                             '<phase type="rayleigh"/>'
                             '</phase>')
        assert int(np.asarray(blend.media.phase_kind)[0]) == 4
        l_b = float(trace_paths(blend, cfg, u).value[:, 0, :].mean())
        assert np.isfinite(l_b) and l_b > 0
        iso = _scene(tmp_path, "1.5,1.5,1.5", "0.7,0.7,0.7")
        l_iso = float(trace_paths(iso, cfg, u).value[:, 0, :].mean())
        assert abs(l_b - l_iso) / l_iso < 0.1, (l_b, l_iso)
