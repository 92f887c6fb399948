"""Anisotropic/composite phase functions (kkay, SGGX microflake,
mixturephase) — chi-square sampling consistency, normalization oracles,
directional extinction, XML dispatch.  (Analogs of the reference's
test_chisquare runs over src/phase/*.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.core.chisquare import chi2_test
from drmlt_mitsuba.render.medium import (
    PHASE_KKAY, PHASE_MICROFLAKE, PHASE_MIXTURE, hg_phase, make_medium,
    phase_eval_dir, phase_pdf_dir, phase_sample_dir, sigma_dir,
)
from drmlt_mitsuba.render.phase import (
    kkay_eval, kkay_normalization, sggx_eval, sggx_fiber_S, sggx_sample,
    sggx_sigma,
)

WI = jnp.asarray([0.48, -0.6, 0.64], jnp.float32)  # unit


class TestSGGX:
    def test_chi_square_sampling(self):
        """Visible-normal sampling matches the closed-form phase density."""
        S = sggx_fiber_S(jnp.asarray([0.3, 0.5, 0.81]), 0.35)
        wi = jnp.broadcast_to(WI, (1, 3))

        def sample_fn(key, n):
            u2 = jax.random.uniform(key, (n, 2))
            wo, _ = sggx_sample(S, jnp.broadcast_to(WI, (n, 3)), u2)
            return wo

        def pdf_fn(d):
            return sggx_eval(S, jnp.broadcast_to(WI, d.shape), d)

        r = chi2_test(sample_fn, pdf_fn, n_samples=400_000)
        assert r.passed, r

    def test_normalized(self):
        """p integrates to 1 over the sphere for any wi (energy-preserving
        specular flakes; matches the reference model's normalization)."""
        S = sggx_fiber_S(jnp.asarray([0.1, -0.7, 0.7]), 0.25)
        rng = np.random.default_rng(3)
        z = rng.normal(size=(300_000, 3))
        z /= np.linalg.norm(z, axis=1, keepdims=True)
        for wi in ([0.0, 0.0, 1.0], [0.9, 0.1, np.sqrt(1 - 0.82)]):
            wiR = jnp.broadcast_to(jnp.asarray(wi, jnp.float32), z.shape)
            p = np.asarray(sggx_eval(S, wiR, jnp.asarray(z, jnp.float32)))
            assert abs(p.mean() * 4 * np.pi - 1.0) < 0.02

    def test_reciprocity(self):
        """p(wi,wo) sigma(wi) == p(wo,wi) sigma(wo) (microflake theory)."""
        S = sggx_fiber_S(jnp.asarray([0.0, 0.0, 1.0]), 0.4)
        rng = np.random.default_rng(0)
        a = rng.normal(size=(512, 3)); a /= np.linalg.norm(a, axis=1, keepdims=True)
        b = rng.normal(size=(512, 3)); b /= np.linalg.norm(b, axis=1, keepdims=True)
        a = jnp.asarray(a, jnp.float32); b = jnp.asarray(b, jnp.float32)
        lhs = np.asarray(sggx_eval(S, a, b) * sggx_sigma(S, a))
        rhs = np.asarray(sggx_eval(S, b, a) * sggx_sigma(S, b))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-4)

    def test_sigma_dir_anisotropy(self):
        """Projected area is minimal along the fiber, 1 across it."""
        fib = jnp.asarray([0.0, 0.0, 1.0])
        med = make_medium([1.0] * 3, [0.5] * 3,
                          phase_kind=PHASE_MICROFLAKE, fiber=fib,
                          stddev=0.1)
        along = float(sigma_dir(med, jnp.asarray([[0.0, 0.0, 1.0]]))[0])
        across = float(sigma_dir(med, jnp.asarray([[1.0, 0.0, 0.0]]))[0])
        assert along < 0.2 and abs(across - 1.0) < 1e-5
        # symmetric in +-d
        neg = float(sigma_dir(med, jnp.asarray([[0.0, 0.0, -1.0]]))[0])
        assert abs(neg - along) < 1e-6


class TestKKay:
    def test_normalization_oracle(self):
        """Perpendicular illumination integrates to ks + kd (the
        reference's stated no-energy-loss normalization, kkay.cpp:33)."""
        norm = kkay_normalization(4.0)
        fib = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
        rng = np.random.default_rng(5)
        z = rng.normal(size=(400_000, 3))
        z /= np.linalg.norm(z, axis=1, keepdims=True)
        wi = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
                              z.shape)
        p = np.asarray(kkay_eval(fib, 0.4, 0.2, 4.0, norm, wi,
                                 jnp.asarray(z, jnp.float32)))
        assert abs(p.mean() * 4 * np.pi - 0.6) < 0.01

    def test_sample_weight_consistency(self):
        """Uniform-sphere sampling: E[value/pdf * f(wo)] equals the
        integral of p*f — checked against HG-free isotropic moments."""
        med = make_medium([1.0] * 3, [1.0] * 3, phase_kind=PHASE_KKAY,
                          fiber=(0.0, 0.0, 1.0), kkay=(0.5, 0.3, 8.0))
        n = 400_000
        wi = jnp.broadcast_to(WI, (n, 3))
        u2 = jax.random.uniform(jax.random.PRNGKey(2), (n, 2))
        wo, pdf, val = phase_sample_dir(med, wi, u2)
        w = np.asarray(val / pdf)
        # total scattered energy for this geometry
        est = w.mean()
        # brute-force integral
        rng = np.random.default_rng(11)
        z = rng.normal(size=(n, 3)); z /= np.linalg.norm(z, axis=1,
                                                         keepdims=True)
        p = np.asarray(phase_eval_dir(med, wi, jnp.asarray(z, jnp.float32)))
        ref = p.mean() * 4 * np.pi
        assert abs(est - ref) < 0.02, (est, ref)
        # pdf is the uniform-sphere density
        np.testing.assert_allclose(np.asarray(pdf), 1.0 / (4 * np.pi),
                                   rtol=1e-6)


class TestMixture:
    def test_chi_square_sampling(self):
        med = make_medium([1.0] * 3, [1.0] * 3, phase_kind=PHASE_MIXTURE,
                          mixture=[("hg", 0.6, 0.4), ("rayleigh", 0.0, 0.35),
                                   ("isotropic", 0.0, 0.25)])

        def sample_fn(key, n):
            u2 = jax.random.uniform(key, (n, 2))
            wo, _, _ = phase_sample_dir(
                med, jnp.broadcast_to(WI, (n, 3)), u2)
            return wo

        def pdf_fn(d):
            return phase_pdf_dir(med, jnp.broadcast_to(WI, d.shape), d)

        r = chi2_test(sample_fn, pdf_fn, n_samples=400_000)
        assert r.passed, r

    def test_single_component_equals_hg(self):
        """A 1-component HG mixture is numerically the plain HG phase."""
        med_mix = make_medium([1.0] * 3, [1.0] * 3,
                              phase_kind=PHASE_MIXTURE,
                              mixture=[("hg", 0.4, 1.0)])
        n = 4096
        wi = jnp.broadcast_to(WI, (n, 3))
        u2 = jax.random.uniform(jax.random.PRNGKey(4), (n, 2))
        wo_m, pdf_m, val_m = phase_sample_dir(med_mix, wi, u2)
        rng = np.random.default_rng(1)
        z = rng.normal(size=(n, 3)); z /= np.linalg.norm(z, axis=1,
                                                         keepdims=True)
        z = jnp.asarray(z, jnp.float32)
        np.testing.assert_allclose(
            np.asarray(phase_eval_dir(med_mix, wi, z)),
            np.asarray(hg_phase(0.4, jnp.sum(-wi * z, -1))), rtol=2e-5)
        np.testing.assert_allclose(np.asarray(val_m), np.asarray(pdf_m))


class TestXMLPhases:
    def _load(self, phase_xml):
        import os
        import tempfile

        from drmlt_mitsuba.scene.xml import load_scene_xml
        xml = f"""<scene version="0.5.0">
          <sensor type="perspective">
            <film type="hdrfilm">
              <integer name="width" value="8"/>
              <integer name="height" value="8"/>
            </film>
          </sensor>
          <medium type="homogeneous" id="fog">
            <rgb name="sigmaT" value="0.4"/>
            <rgb name="albedo" value="0.7"/>
            {phase_xml}
          </medium>
          <shape type="rectangle">
            <emitter type="area"><rgb name="radiance" value="1"/></emitter>
          </shape>
        </scene>"""
        with tempfile.NamedTemporaryFile("w", suffix=".xml",
                                         delete=False) as f:
            f.write(xml)
            path = f.name
        try:
            scene, _settings = load_scene_xml(path)
            return scene
        finally:
            os.unlink(path)

    def test_kkay(self):
        sc = self._load("""<phase type="kkay">
              <float name="ks" value="0.5"/>
              <float name="exponent" value="8"/>
              <vector name="orientation" x="1" y="0" z="0"/>
            </phase>""")
        assert sc.medium.phase_kind == PHASE_KKAY
        np.testing.assert_allclose(np.asarray(sc.medium.fiber), [1, 0, 0])
        assert float(sc.medium.ph_params[0]) == 0.5
        assert float(sc.medium.ph_params[2]) == 8.0

    def test_microflake(self):
        sc = self._load("""<phase type="microflake">
              <float name="stddev" value="0.2"/>
            </phase>""")
        assert sc.medium.phase_kind == PHASE_MICROFLAKE
        assert sc.medium.ph_params.shape == (3, 3)

    def test_mixturephase(self):
        sc = self._load("""<phase type="mixturephase">
              <string name="weights" value="0.7, 0.3"/>
              <phase type="hg"><float name="g" value="0.5"/></phase>
              <phase type="rayleigh"/>
            </phase>""")
        assert sc.medium.phase_kind == PHASE_MIXTURE
        np.testing.assert_allclose(np.asarray(sc.medium.mix_w), [0.7, 0.3],
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(sc.medium.mix_g[0]), 0.5)
