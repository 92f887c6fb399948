"""Camera-model tests (ref: src/sensors/* behavioral contracts)."""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.render.sensor import sample_ray
from drmlt_mitsuba.scene.types import (
    CAMERA_ORTHOGRAPHIC, CAMERA_RADIANCEMETER, CAMERA_SPHERICAL,
    CAMERA_TELECENTRIC, make_camera,
)

EYE = np.eye(4, dtype=np.float32)


def _uv(n=256, seed=0):
    return jax.random.uniform(jax.random.PRNGKey(seed), (n, 2))


class TestCameras:
    def test_perspective_through_center(self):
        cam = make_camera(EYE, 60.0, 1.0)
        o, d = sample_ray(cam, jnp.asarray([[0.5, 0.5]]))
        np.testing.assert_allclose(np.asarray(d[0]), [0, 0, 1], atol=1e-6)

    def test_orthographic_parallel(self):
        cam = make_camera(EYE, 2.0, 1.0, kind=CAMERA_ORTHOGRAPHIC)
        o, d = sample_ray(cam, _uv())
        np.testing.assert_allclose(np.asarray(d), [[0, 0, 1]] * 256,
                                   atol=1e-6)
        assert float(jnp.std(o[:, 0])) > 0.1   # origins spread over film

    def test_radiancemeter_single_ray(self):
        cam = make_camera(EYE, 1.0, 1.0, kind=CAMERA_RADIANCEMETER)
        o, d = sample_ray(cam, _uv())
        assert float(jnp.std(o, axis=0).max()) == 0.0
        assert float(jnp.std(d, axis=0).max()) == 0.0

    def test_spherical_covers_sphere(self):
        cam = make_camera(EYE, 1.0, 1.0, kind=CAMERA_SPHERICAL)
        o, d = sample_ray(cam, _uv(4096))
        np.testing.assert_allclose(
            np.asarray(jnp.linalg.norm(d, axis=-1)), 1.0, atol=1e-5)
        assert float(jnp.mean(d, 0).max()) < 0.1   # roughly isotropic

    def test_telecentric_zero_aperture_is_ortho(self):
        cam = make_camera(EYE, 2.0, 1.0, aperture_radius=0.0,
                          focus_distance=5.0, kind=CAMERA_TELECENTRIC)
        o, d = sample_ray(cam, _uv(), _uv(seed=1))
        np.testing.assert_allclose(np.asarray(d), [[0, 0, 1]] * 256,
                                   atol=1e-6)

    def test_telecentric_focuses_at_focal_plane(self):
        """With finite aperture, rays from one film point converge at the
        focal plane (sharp there, blurred elsewhere)."""
        cam = make_camera(EYE, 2.0, 1.0, aperture_radius=0.3,
                          focus_distance=5.0, kind=CAMERA_TELECENTRIC)
        uv = jnp.tile(jnp.asarray([[0.3, 0.7]]), (512, 1))
        o, d = sample_ray(cam, uv, _uv(512, seed=2))
        t = (5.0 - o[:, 2]) / d[:, 2]
        p_focus = o + t[:, None] * d
        spread_focus = float(jnp.std(p_focus[:, 0]) + jnp.std(p_focus[:, 1]))
        t2 = (1.0 - o[:, 2]) / d[:, 2]
        p_near = o + t2[:, None] * d
        spread_near = float(jnp.std(p_near[:, 0]) + jnp.std(p_near[:, 1]))
        assert spread_focus < 1e-5, spread_focus
        assert spread_near > 0.05, spread_near

    def test_fluencemeter_uniform_sphere(self):
        from drmlt_mitsuba.scene.types import CAMERA_FLUENCEMETER

        cam = make_camera(EYE, 1.0, 1.0, kind=CAMERA_FLUENCEMETER)
        o, d = sample_ray(cam, _uv(8192))
        np.testing.assert_allclose(np.asarray(jnp.std(o, axis=0)), 0.0)
        np.testing.assert_allclose(
            np.asarray(jnp.linalg.norm(d, axis=-1)), 1.0, atol=1e-5)
        assert float(jnp.abs(jnp.mean(d, 0)).max()) < 0.05

    def test_fluencemeter_furnace(self):
        """In a unit furnace the fluence probe reads exactly 1."""
        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import trace_paths
        from drmlt_mitsuba.scene.builders import furnace_sphere
        from drmlt_mitsuba.scene.types import (
            CAMERA_FLUENCEMETER, make_camera,
        )

        scene = furnace_sphere(albedo=1.0, env=1.0)
        scene = scene.replace(camera=make_camera(
            np.asarray(scene.camera.to_world), 1.0, 1.0,
            kind=CAMERA_FLUENCEMETER))
        cfg = PathConfig(max_depth=6, rr_depth=100, use_nee=False)
        u = jax.random.uniform(jax.random.PRNGKey(0), (16384, cfg.n_dims))
        lum = trace_paths(scene, cfg, u).lum
        np.testing.assert_allclose(float(lum.mean()), 1.0, atol=1e-3)

    def test_irradiancemeter_cosine(self):
        """Directions are cosine-distributed around the probe's +z."""
        from drmlt_mitsuba.scene.types import CAMERA_IRRADIANCEMETER

        cam = make_camera(EYE, 1.0, 1.0, kind=CAMERA_IRRADIANCEMETER)
        o, d = sample_ray(cam, _uv(100_000))
        assert float(jnp.min(d[:, 2])) >= 0.0
        np.testing.assert_allclose(float(jnp.mean(d[:, 2])), 2.0 / 3.0,
                                   atol=5e-3)

    def test_irradiancemeter_uniform_env(self):
        """Facing a unit constant environment the probe's sample mean is 1
        (E = pi with cosine-pdf importance absorbed)."""
        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import trace_paths
        from drmlt_mitsuba.scene.builders import furnace_sphere
        from drmlt_mitsuba.scene.types import (
            CAMERA_IRRADIANCEMETER, make_camera,
        )

        scene = furnace_sphere(albedo=1.0, env=1.0)
        scene = scene.replace(camera=make_camera(
            np.asarray(scene.camera.to_world), 1.0, 1.0,
            kind=CAMERA_IRRADIANCEMETER))
        cfg = PathConfig(max_depth=6, rr_depth=100, use_nee=False)
        u = jax.random.uniform(jax.random.PRNGKey(2), (16384, cfg.n_dims))
        lum = trace_paths(scene, cfg, u).lum
        np.testing.assert_allclose(float(lum.mean()), 1.0, atol=1e-3)
