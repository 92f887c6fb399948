"""Volumetric path tracing tests (homogeneous medium + HG phase)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import trace_paths
from drmlt_mitsuba.integrators.pssmlt import PSSMLTConfig, render_pssmlt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.render.medium import (
    hg_phase, make_medium, sample_distance, sample_hg, transmittance,
)
from drmlt_mitsuba.scene.builders import cornell_box


class TestMedium:
    def test_hg_normalized(self):
        """HG phase integrates to 1 over the sphere."""
        for g in [0.0, 0.3, -0.5, 0.9]:
            mu = np.linspace(-1, 1, 400_001)
            p = np.asarray(hg_phase(jnp.float32(g), jnp.asarray(mu)))
            integral = 2 * np.pi * np.trapezoid(p, mu)
            np.testing.assert_allclose(integral, 1.0, atol=2e-3, err_msg=str(g))

    def test_hg_sampling_matches_pdf(self):
        """Sampled cos(theta) mean matches the analytic HG mean = g."""
        for g in [0.0, 0.5, -0.3]:
            wi = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), (100_000, 3))
            u2 = jax.random.uniform(jax.random.PRNGKey(1), (100_000, 2))
            wo, pdf = sample_hg(jnp.float32(g), wi, u2)
            # forward direction is -wi = +z
            cos = np.asarray(wo[:, 2])
            np.testing.assert_allclose(cos.mean(), g, atol=5e-3, err_msg=str(g))
            np.testing.assert_allclose(
                np.asarray(jnp.linalg.norm(wo, axis=-1)), 1.0, atol=1e-5
            )

    def test_distance_sampling_unbiased(self):
        """E[weight * indicator] reproduces transmittance: for a beam to a
        surface at distance D, E[w | escape] * P(escape est) = tr(D)."""
        med = make_medium([0.5, 1.0, 2.0], [1.0, 1.0, 1.0])
        n = 200_000
        k1, k2 = jax.random.split(jax.random.PRNGKey(2))
        uc = jax.random.uniform(k1, (n,))
        ud = jax.random.uniform(k2, (n,))
        D = 1.3
        md = sample_distance(med, uc, ud, jnp.full((n,), D))
        # escape estimator: weight where not scattered averages to tr(D)
        w_esc = np.where(~np.asarray(md["scattered"])[:, None],
                         np.asarray(md["weight"]), 0.0)
        tr = np.asarray(transmittance(med, jnp.asarray(D)))
        np.testing.assert_allclose(w_esc.mean(axis=0), tr, rtol=0.02)


@pytest.fixture(scope="module")
def fog_scenes():
    vac = cornell_box(16, 16)
    thin = vac.replace(medium=make_medium([2e-4] * 3, [1.0] * 3, 0.0))
    absb = vac.replace(medium=make_medium([2e-3] * 3, [0.0] * 3, 0.0))
    return vac, thin, absb


class TestVolpath:
    def test_vacuum_regression(self, fog_scenes):
        vac, _, _ = fog_scenes
        cfg = PathConfig(max_depth=4, rr_depth=100)
        u = jax.random.uniform(jax.random.PRNGKey(3), (4096, cfg.n_dims))
        sp = trace_paths(vac, cfg, u)
        assert bool(jnp.all(jnp.isfinite(sp.value)))

    def test_fog_energy(self, fog_scenes):
        vac, thin, absb = fog_scenes
        cfg = PathConfig(max_depth=6, rr_depth=100)
        u = jax.random.uniform(jax.random.PRNGKey(4), (16384, cfg.n_dims))
        l_vac = float(trace_paths(vac, cfg, u).lum.mean())
        l_thin = float(trace_paths(thin, cfg, u).lum.mean())
        l_abs = float(trace_paths(absb, cfg, u).lum.mean())
        # pure-scattering thin fog only redirects light: close to vacuum
        assert abs(l_thin - l_vac) / l_vac < 0.15, (l_thin, l_vac)
        # absorbing fog is strictly dimmer
        assert l_abs < 0.8 * l_vac, (l_abs, l_vac)

    def test_mcmc_fog_consistency(self, fog_scenes):
        """PSSMLT over the volumetric trace matches plain MC."""
        _, _, absb = fog_scenes
        scene = absb.replace(medium=make_medium([1e-3] * 3, [0.7] * 3, 0.3))
        cfg = PathConfig(max_depth=4, rr_depth=100)
        fc = filmlib.make_film_config(16, 16, "box")
        u = jax.random.uniform(jax.random.PRNGKey(5), (16384 * 4, cfg.n_dims))
        # reference: direct mean luminance of the estimator
        ref = float(trace_paths(scene, cfg, u).lum.mean())
        trace = lambda uu: trace_paths(scene, cfg, uu)
        img, aux = render_pssmlt(
            trace, PSSMLTConfig(n_chains=512, n_bootstrap=8192,
                                kelemen_style_weights=False),
            fc, jax.random.PRNGKey(6), cfg.n_dims, 300,
        )
        assert np.all(np.isfinite(np.asarray(img)))
        np.testing.assert_allclose(float(aux["b"]), ref, rtol=0.1)


class TestHeterogeneous:
    """Grid-medium oracles (ref: src/medium/heterogeneous.cpp — Woodcock
    tracking; here the collision stream is PSS-derived so L(u) stays pure)."""

    def _grid_scene(self, density, sig=2e-3):
        import numpy as np

        from drmlt_mitsuba.render.medium import make_hetero_medium
        from drmlt_mitsuba.scene.builders import cornell_box

        scene = cornell_box(16, 16)
        # grid spans [-900, 900]^3: covers the camera AND the box
        w2g = np.eye(4, dtype=np.float32) / 1800.0
        w2g[:3, 3] = 0.5
        w2g[3, 3] = 1.0
        med = make_hetero_medium(density, w2g, [sig] * 3, [0.6] * 3, 0.1)
        return scene.replace(medium=med)

    def test_grid_density_trilinear(self):
        import numpy as np

        from drmlt_mitsuba.render.medium import (
            _grid_density, make_hetero_medium,
        )

        w2g = np.eye(4, dtype=np.float32)
        dens = np.zeros((2, 2, 2), np.float32)
        dens[1] = 1.0  # density = z in the unit cube
        med = make_hetero_medium(dens, w2g, [1.0] * 3, [1.0] * 3)
        p = jnp.asarray([[0.5, 0.5, 0.25], [0.5, 0.5, 0.75],
                         [0.5, 0.5, 2.0]])
        d = _grid_density(med, p)
        np.testing.assert_allclose(np.asarray(d), [0.25, 0.75, 0.0],
                                   atol=1e-5)

    def test_transmittance_ratio_tracking(self):
        """Constant grid: ratio tracking must reproduce exp(-sigma d)."""
        import numpy as np

        from drmlt_mitsuba.render.medium import (
            make_hetero_medium, transmittance_hetero,
        )

        sig = 3e-3
        w2g = np.eye(4, dtype=np.float32) / 1800.0
        w2g[:3, 3] = 0.5
        w2g[3, 3] = 1.0
        med = make_hetero_medium(np.ones((4, 4, 4), np.float32), w2g,
                                 [sig] * 3, [1.0] * 3)
        R = 20000
        o = jnp.zeros((R, 3)) + jnp.asarray([278.0, 273.0, -100.0])
        d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (R, 1))
        dist = jnp.full((R,), 500.0)
        u = jax.random.uniform(jax.random.PRNGKey(3), (R,))
        tr = transmittance_hetero(med, o, d, dist, u)
        np.testing.assert_allclose(
            float(tr.mean()), np.exp(-sig * 500.0), rtol=0.03
        )

    def test_constant_grid_matches_homogeneous(self):
        """A constant-density grid is a homogeneous medium: full-path
        estimates must agree within MC error."""
        import numpy as np

        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import trace_paths
        from drmlt_mitsuba.render.medium import make_medium
        from drmlt_mitsuba.scene.builders import cornell_box

        sig = 2e-3
        homo = cornell_box(16, 16).replace(
            medium=make_medium([sig] * 3, [0.6] * 3, 0.1)
        )
        het = self._grid_scene(np.ones((4, 4, 4), np.float32), sig)
        cfg = PathConfig(max_depth=4, rr_depth=100)
        u = jax.random.uniform(jax.random.PRNGKey(0), (65536, cfg.n_dims))
        sh = trace_paths(homo, cfg, u).lum
        sg = trace_paths(het, cfg, u).lum
        se = float(sh.std() + sg.std()) / np.sqrt(sh.shape[0])
        assert abs(float(sh.mean() - sg.mean())) < 4.0 * se, (
            float(sh.mean()), float(sg.mean()), se)

    def test_nonuniform_grid_between_bounds(self):
        """Half-density grid sits between vacuum and full density, and a
        spatially-varying grid differs from its mean-density constant."""
        import numpy as np

        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import trace_paths
        from drmlt_mitsuba.scene.builders import cornell_box

        cfg = PathConfig(max_depth=4, rr_depth=100)
        u = jax.random.uniform(jax.random.PRNGKey(1), (32768, cfg.n_dims))
        l_vac = float(trace_paths(cornell_box(16, 16), cfg, u).lum.mean())
        l_full = float(trace_paths(
            self._grid_scene(np.ones((4, 4, 4), np.float32)), cfg, u
        ).lum.mean())
        l_half = float(trace_paths(
            self._grid_scene(np.full((4, 4, 4), 0.5, np.float32)), cfg, u
        ).lum.mean())
        assert l_full < l_half < l_vac, (l_full, l_half, l_vac)

    def test_mcmc_over_hetero(self):
        """DRMLT over the heterogeneous volpath target stays consistent
        with plain MC on the same trace function."""
        import numpy as np

        from drmlt_mitsuba.core.spectrum import luminance
        from drmlt_mitsuba.integrators.drmlt import (
            DRMLTConfig, render_drmlt,
        )
        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import trace_paths
        from drmlt_mitsuba.render.film import make_film_config

        scene = self._grid_scene(np.ones((4, 4, 4), np.float32))
        pcfg = PathConfig(max_depth=3, rr_depth=100)
        trace = lambda u: trace_paths(scene, pcfg, u)
        u = jax.random.uniform(jax.random.PRNGKey(2), (65536, pcfg.n_dims))
        ref = float(trace(u).lum.mean())
        fc = make_film_config(8, 8, "box")
        dcfg = DRMLTConfig(type="green", n_chains=2048, n_bootstrap=8192)
        n_dims = pcfg.n_dims + (pcfg.n_dims % 2)
        img, _ = render_drmlt(trace, dcfg, fc, jax.random.PRNGKey(7),
                              n_dims, n_steps=200)
        got = float(luminance(jnp.asarray(img)).mean())
        np.testing.assert_allclose(got, ref, rtol=0.25)


def test_rayleigh_fog_renders():
    """Cornell fog with a Rayleigh phase renders finite and differs from
    the HG g=0 fog only through the phase lobe (same extinction)."""
    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.path import trace_paths
    from drmlt_mitsuba.render.medium import PHASE_RAYLEIGH, make_medium
    from drmlt_mitsuba.scene.builders import cornell_box

    cfg = PathConfig(max_depth=4, rr_depth=100)
    u = jax.random.uniform(jax.random.PRNGKey(4), (32768, cfg.n_dims))
    base = cornell_box(16, 16)
    iso = base.replace(medium=make_medium([2e-3] * 3, [0.6] * 3, 0.0))
    ray = base.replace(medium=make_medium(
        [2e-3] * 3, [0.6] * 3, 0.0, phase_kind=PHASE_RAYLEIGH))
    l_iso = float(trace_paths(iso, cfg, u).lum.mean())
    l_ray = float(trace_paths(ray, cfg, u).lum.mean())
    assert np.isfinite(l_ray) and l_ray > 0
    # same extinction and albedo: means agree within ~10% (phase only
    # redistributes directions)
    assert abs(l_iso - l_ray) / l_iso < 0.1, (l_iso, l_ray)


def test_exotic_phases_render():
    """Cornell fog with kkay / microflake / mixturephase media: finite,
    positive, and energy plausibly ordered — a 1-component HG mixture must
    agree closely with the plain HG medium (same estimator modulo code
    path), and microflake's directional extinction must differ from the
    HG fog's isotropic extinction."""
    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.path import trace_paths
    from drmlt_mitsuba.render.medium import (
        PHASE_KKAY, PHASE_MICROFLAKE, PHASE_MIXTURE, make_medium,
    )
    from drmlt_mitsuba.scene.builders import cornell_box

    cfg = PathConfig(max_depth=4, rr_depth=100)
    u = jax.random.uniform(jax.random.PRNGKey(6), (32768, cfg.n_dims))
    base = cornell_box(16, 16)
    sig = [2e-3] * 3

    hg = base.replace(medium=make_medium(sig, [0.6] * 3, 0.3))
    mix1 = base.replace(medium=make_medium(
        sig, [0.6] * 3, phase_kind=PHASE_MIXTURE,
        mixture=[("hg", 0.3, 1.0)]))
    l_hg = float(trace_paths(hg, cfg, u).lum.mean())
    l_mix = float(trace_paths(mix1, cfg, u).lum.mean())
    np.testing.assert_allclose(l_mix, l_hg, rtol=1e-5)

    kkay = base.replace(medium=make_medium(
        sig, [0.6] * 3, phase_kind=PHASE_KKAY, fiber=(0.0, 1.0, 0.0),
        kkay=(0.4, 0.2, 4.0)))
    l_kkay = float(trace_paths(kkay, cfg, u).lum.mean())
    assert np.isfinite(l_kkay) and l_kkay > 0
    # kkay absorbs 1-ks-kd of each scatter on top of the albedo: dimmer
    # than the lossless HG fog
    assert l_kkay < l_hg, (l_kkay, l_hg)

    flake = base.replace(medium=make_medium(
        sig, [0.6] * 3, phase_kind=PHASE_MICROFLAKE,
        fiber=(0.0, 0.0, 1.0), stddev=0.2))
    l_flake = float(trace_paths(flake, cfg, u).lum.mean())
    assert np.isfinite(l_flake) and l_flake > 0
    # projected area <= 1 => never more extinction than the plain fog;
    # with a tight fiber it is strictly less along the fiber axis
    l_iso = float(trace_paths(
        base.replace(medium=make_medium(sig, [0.6] * 3, 0.0)),
        cfg, u).lum.mean())
    assert l_flake > 0.95 * l_iso, (l_flake, l_iso)


class TestHeteroExtensions:
    """Per-voxel albedo grids + exotic phases in grid media (ref:
    heterogeneous.cpp albedo volume / phase dispatch)."""

    def _grid(self, **kw):
        from drmlt_mitsuba.render.medium import make_hetero_medium
        from drmlt_mitsuba.scene.builders import cornell_box

        # grid spans [-900, 900]^3: covers the camera AND the box
        w2g = np.eye(4, dtype=np.float32) / 1800.0
        w2g[:3, 3] = 0.5
        w2g[3, 3] = 1.0
        med = make_hetero_medium(np.ones((4, 4, 4), np.float32), w2g,
                                 [2e-3] * 3, [0.6] * 3, **kw)
        return cornell_box(16, 16).replace(medium=med)

    def test_constant_albedo_grid_matches_scalar(self):
        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import trace_paths

        cfg = PathConfig(max_depth=4, rr_depth=100)
        u = jax.random.uniform(jax.random.PRNGKey(8), (32768, cfg.n_dims))
        s_scalar = self._grid()
        s_grid = self._grid(
            albedo_grid=np.full((4, 4, 4, 3), 0.6, np.float32))
        l0 = float(trace_paths(s_scalar, cfg, u).lum.mean())
        l1 = float(trace_paths(s_grid, cfg, u).lum.mean())
        np.testing.assert_allclose(l1, l0, rtol=1e-5)

    def test_varying_albedo_grid_between_bounds(self):
        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import trace_paths

        cfg = PathConfig(max_depth=4, rr_depth=100)
        u = jax.random.uniform(jax.random.PRNGKey(9), (32768, cfg.n_dims))
        lo = float(trace_paths(self._grid(
            albedo_grid=np.full((4, 4, 4, 3), 0.0, np.float32)),
            cfg, u).lum.mean())
        hi = float(trace_paths(self._grid(
            albedo_grid=np.full((4, 4, 4, 3), 1.0, np.float32)),
            cfg, u).lum.mean())
        half = float(trace_paths(self._grid(
            albedo_grid=np.full((4, 4, 4, 3), 0.5, np.float32)),
            cfg, u).lum.mean())
        assert lo < half < hi, (lo, half, hi)

    def test_rayleigh_grid_matches_homogeneous(self):
        from drmlt_mitsuba.integrators.layout import PathConfig
        from drmlt_mitsuba.integrators.path import trace_paths
        from drmlt_mitsuba.render.medium import (
            PHASE_RAYLEIGH, make_medium,
        )
        from drmlt_mitsuba.scene.builders import cornell_box

        cfg = PathConfig(max_depth=4, rr_depth=100)
        u = jax.random.uniform(jax.random.PRNGKey(10), (65536, cfg.n_dims))
        het = self._grid(phase_kind=PHASE_RAYLEIGH)
        hom = cornell_box(16, 16).replace(medium=make_medium(
            [2e-3] * 3, [0.6] * 3, phase_kind=PHASE_RAYLEIGH))
        lh = trace_paths(het, cfg, u).lum
        lo = trace_paths(hom, cfg, u).lum
        se = float(lh.std() + lo.std()) / np.sqrt(lh.shape[0])
        assert abs(float(lh.mean() - lo.mean())) < 4.0 * se

    def test_microflake_grid_directional_transmittance(self):
        from drmlt_mitsuba.render.medium import (
            PHASE_MICROFLAKE, transmittance_hetero,
        )

        scene = self._grid(phase_kind=PHASE_MICROFLAKE,
                           fiber=(0.0, 0.0, 1.0), stddev=0.1)
        med = scene.medium.replace(sigma_t=jnp.full(3, 5e-3))
        R = 20000
        o = jnp.zeros((R, 3)) + jnp.asarray([278.0, 273.0, 100.0])
        u = jax.random.uniform(jax.random.PRNGKey(3), (R,))
        dist = jnp.full((R,), 300.0)
        d_along = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (R, 1))
        d_across = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]]), (R, 1))
        tr_along = float(transmittance_hetero(med, o, d_along, dist,
                                              u).mean())
        tr_across = float(transmittance_hetero(med, o, d_across, dist,
                                               u).mean())
        # extinction along the fiber is ~eps; across it the full sigma_t
        assert tr_along > tr_across + 0.2, (tr_along, tr_across)
        np.testing.assert_allclose(tr_across, np.exp(-5e-3 * 300.0),
                                   rtol=0.05)


class TestOrientationVolumes:
    """Per-voxel fiber orientation grids for anisotropic phases (ref:
    heterogeneous.cpp 'orientation' volume)."""

    def _scene(self, **kw):
        from drmlt_mitsuba.render.medium import make_hetero_medium
        from drmlt_mitsuba.scene.builders import cornell_box

        w2g = np.eye(4, dtype=np.float32) / 1800.0
        w2g[:3, 3] = 0.5
        w2g[3, 3] = 1.0
        med = make_hetero_medium(np.ones((4, 4, 4), np.float32), w2g,
                                 [5e-3] * 3, [0.6] * 3, **kw)
        return cornell_box(16, 16).replace(medium=med)

    def test_constant_grid_matches_constant_fiber(self):
        """An orientation grid filled with one direction must reproduce
        the constant-fiber medium exactly (same RNG stream)."""
        from drmlt_mitsuba.render.medium import (
            PHASE_MICROFLAKE, transmittance_hetero,
        )

        kw = dict(phase_kind=PHASE_MICROFLAKE, stddev=0.15)
        m_const = self._scene(fiber=(0.0, 0.0, 1.0), **kw).medium
        og = np.broadcast_to(np.asarray([0, 0, 1], np.float32),
                             (4, 4, 4, 3)).copy()
        m_grid = self._scene(fiber=(1.0, 0.0, 0.0), orient_grid=og,
                             **kw).medium
        R = 4096
        o = jnp.zeros((R, 3)) + jnp.asarray([278.0, 273.0, 100.0])
        d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (R, 1))
        u = jax.random.uniform(jax.random.PRNGKey(0), (R,))
        dist = jnp.full((R,), 300.0)
        t0 = np.asarray(transmittance_hetero(m_const, o, d, dist, u))
        t1 = np.asarray(transmittance_hetero(m_grid, o, d, dist, u))
        np.testing.assert_allclose(t1, t0, rtol=1e-5)

    def test_varying_orientation_changes_extinction(self):
        """Fibers along +z on one side, along +x on the other: a +z ray
        sees far less extinction where it travels along the fibers."""
        from drmlt_mitsuba.render.medium import (
            PHASE_MICROFLAKE, transmittance_hetero,
        )

        og = np.zeros((4, 4, 4, 3), np.float32)
        og[:, :, :2, 2] = 1.0   # x < center: fibers along z
        og[:, :, 2:, 0] = 1.0   # x >= center: fibers along x
        scene = self._scene(phase_kind=PHASE_MICROFLAKE, stddev=0.1,
                            orient_grid=og)
        med = scene.medium
        R = 4096
        u = jax.random.uniform(jax.random.PRNGKey(1), (R,))
        dist = jnp.full((R,), 400.0)
        d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (R, 1))
        # two ray bundles on either side of the split (x in grid coords)
        o_left = jnp.zeros((R, 3)) + jnp.asarray([-600.0, 0.0, -200.0])
        o_right = jnp.zeros((R, 3)) + jnp.asarray([600.0, 0.0, -200.0])
        t_l = float(np.asarray(transmittance_hetero(
            med, o_left, d, dist, u)).mean())
        t_r = float(np.asarray(transmittance_hetero(
            med, o_right, d, dist, u)).mean())
        # left region: ray ALONG fibers -> tiny projected area -> bright
        assert t_l > t_r + 0.2, (t_l, t_r)

    def test_xml_orientation_gridvolume(self, tmp_path):
        from drmlt_mitsuba.scene.xml import load_scene_xml, write_vol

        dpath = tmp_path / "d.vol"
        write_vol(str(dpath), np.ones((2, 2, 2), np.float32),
                  np.full(3, -10.0, np.float32),
                  np.full(3, 10.0, np.float32))
        # 3-channel orientation volume
        opath = tmp_path / "o.vol"
        ori = np.zeros((2, 2, 2, 3), np.float32)
        ori[..., 1] = 1.0
        import struct as _s
        with open(opath, "wb") as f:
            f.write(b"VOL\x03")
            f.write(np.asarray([1, 2, 2, 2, 3], np.int32).tobytes())
            f.write(np.asarray([-10, -10, -10, 10, 10, 10],
                               np.float32).tobytes())
            f.write(ori.astype(np.float32).tobytes())
        xml = f"""<scene version="0.6.0">
          <sensor type="perspective">
            <film type="hdrfilm">
              <integer name="width" value="4"/>
              <integer name="height" value="4"/>
            </film>
          </sensor>
          <medium type="heterogeneous" id="fog">
            <volume name="density" type="gridvolume">
              <string name="filename" value="{dpath}"/>
            </volume>
            <volume name="orientation" type="gridvolume">
              <string name="filename" value="{opath}"/>
            </volume>
            <phase type="microflake"><float name="stddev" value="0.2"/></phase>
            <rgb name="sigmaT" value="0.4"/>
          </medium>
          <shape type="rectangle">
            <emitter type="area"><rgb name="radiance" value="1"/></emitter>
          </shape>
        </scene>"""
        xf = tmp_path / "s.xml"
        xf.write_text(xml)
        scene, _ = load_scene_xml(str(xf))
        assert scene.medium.orient_grid is not None
        assert scene.medium.orient_grid.shape == (2, 2, 2, 3)
        np.testing.assert_allclose(
            np.asarray(scene.medium.orient_grid)[0, 0, 0], [0, 1, 0])
