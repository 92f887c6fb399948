"""Core numerics tests (warps, frames, fresnel, rng contract)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.core import frame, math as mm, rng, warp


def keys(n=1, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), n)


class TestWarps:
    def test_cosine_hemisphere_distribution(self):
        """Mean cos(theta) under cosine-weighted sampling is 2/3."""
        u = jax.random.uniform(jax.random.PRNGKey(0), (200_000, 2))
        d = warp.square_to_cosine_hemisphere(u)
        assert float(jnp.min(d[:, 2])) >= 0.0
        np.testing.assert_allclose(float(jnp.mean(d[:, 2])), 2.0 / 3.0, atol=2e-3)
        # unit vectors
        np.testing.assert_allclose(
            np.asarray(jnp.linalg.norm(d, axis=-1)), 1.0, atol=1e-5
        )

    def test_uniform_sphere(self):
        u = jax.random.uniform(jax.random.PRNGKey(1), (200_000, 2))
        d = warp.square_to_uniform_sphere(u)
        np.testing.assert_allclose(np.asarray(jnp.mean(d, 0)), 0.0, atol=5e-3)
        np.testing.assert_allclose(
            np.asarray(jnp.linalg.norm(d, axis=-1)), 1.0, atol=1e-5
        )

    def test_triangle_uniform(self):
        u = jax.random.uniform(jax.random.PRNGKey(2), (100_000, 2))
        b = warp.square_to_uniform_triangle(u)
        assert float(jnp.min(b)) >= 0
        assert float(jnp.max(jnp.sum(b, -1))) <= 1.0 + 1e-6
        # centroid of the unit triangle is (1/3, 1/3)
        np.testing.assert_allclose(np.asarray(jnp.mean(b, 0)), 1 / 3, atol=3e-3)

    def test_disk_concentric(self):
        u = jax.random.uniform(jax.random.PRNGKey(3), (100_000, 2))
        p = warp.square_to_uniform_disk_concentric(u)
        r = jnp.linalg.norm(p, axis=-1)
        assert float(jnp.max(r)) <= 1.0 + 1e-6
        # E[r] = 2/3 for uniform disk
        np.testing.assert_allclose(float(jnp.mean(r)), 2 / 3, atol=3e-3)

    def test_box_muller_moments(self):
        u = jax.random.uniform(jax.random.PRNGKey(4), (200_000, 2))
        n = warp.square_to_std_normal(u).reshape(-1)
        np.testing.assert_allclose(float(jnp.mean(n)), 0.0, atol=8e-3)
        np.testing.assert_allclose(float(jnp.std(n)), 1.0, atol=8e-3)


class TestFrame:
    def test_roundtrip(self):
        k1, k2 = keys(2)
        n = mm.normalize(jax.random.normal(k1, (1000, 3)))
        v = mm.normalize(jax.random.normal(k2, (1000, 3)))
        local = frame.to_local(n, v)
        back = frame.to_world(n, local)
        np.testing.assert_allclose(np.asarray(back), np.asarray(v), atol=1e-5)
        # z component is the projection onto n
        np.testing.assert_allclose(
            np.asarray(local[:, 2]), np.asarray(jnp.sum(n * v, -1)), atol=1e-5
        )

    def test_orthonormal(self):
        n = mm.normalize(jax.random.normal(jax.random.PRNGKey(7), (500, 3)))
        s, t = frame.coordinate_system(n)
        np.testing.assert_allclose(np.asarray(mm.dot(s, t)), 0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(mm.dot(s, n)), 0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(mm.norm(s)), 1, atol=1e-5)


class TestFresnel:
    def test_dielectric_normal_incidence(self):
        f, _, _ = mm.fresnel_dielectric(jnp.asarray(1.0), jnp.asarray(1.5))
        np.testing.assert_allclose(float(f), ((1.5 - 1) / (1.5 + 1)) ** 2, atol=1e-5)

    def test_dielectric_tir(self):
        # from inside glass at grazing angle -> total internal reflection
        f, _, tir = mm.fresnel_dielectric(jnp.asarray(-0.1), jnp.asarray(1.5))
        assert bool(tir)
        np.testing.assert_allclose(float(f), 1.0)

    def test_conductor_bounds(self):
        c = jnp.linspace(0.01, 1.0, 64)
        f = mm.fresnel_conductor(c, jnp.full((64,), 0.2), jnp.full((64,), 3.9))
        assert float(jnp.min(f)) >= 0.0 and float(jnp.max(f)) <= 1.0 + 1e-6


class TestRng:
    def test_replay_contract(self):
        """PathSeed semantics: the same (root, index) always reproduces the
        same primary-sample vector (ReplayableSampler equivalence)."""
        root = jax.random.PRNGKey(42)
        u1 = rng.pss_uniform(rng.seed_to_key(root, 1234), 64)
        u2 = rng.pss_uniform(rng.seed_to_key(root, 1234), 64)
        u3 = rng.pss_uniform(rng.seed_to_key(root, 1235), 64)
        np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
        assert not np.allclose(np.asarray(u1), np.asarray(u3))

    def test_pss_wrap(self):
        y = jnp.asarray([-0.3, 0.0, 0.4, 1.0, 1.3])
        w = rng.pss_wrap(y)
        np.testing.assert_allclose(np.asarray(w), [0.3, 0.0, 0.4, 1.0, 0.7], atol=1e-6)
        assert float(jnp.min(w)) >= 0 and float(jnp.max(w)) <= 1


class TestMis:
    def test_balance_and_power(self):
        a, b = jnp.asarray(0.3), jnp.asarray(0.7)
        np.testing.assert_allclose(float(mm.mis_balance(a, b)), 0.3, atol=1e-6)
        np.testing.assert_allclose(
            float(mm.mis_power(a, b)), 0.09 / (0.09 + 0.49), atol=1e-6
        )
        # degenerate
        assert float(mm.mis_power(jnp.asarray(0.0), jnp.asarray(0.0))) == 0.0


class TestQuadSpline:
    def test_gauss_legendre(self):
        from drmlt_mitsuba.core.quad import integrate

        v = float(integrate(lambda x: jnp.sin(x), 0.0, np.pi, 32))
        np.testing.assert_allclose(v, 2.0, atol=1e-5)

    def test_gauss_lobatto(self):
        from drmlt_mitsuba.core.quad import gauss_lobatto

        x, w = gauss_lobatto(6)
        np.testing.assert_allclose(float(jnp.sum(w)), 2.0, atol=1e-5)
        # integrates cubics exactly
        v = float(jnp.sum(w * (np.asarray(x) ** 3 + 1.0)))
        np.testing.assert_allclose(v, 2.0, atol=1e-5)

    def test_catmull_rom(self):
        from drmlt_mitsuba.core.quad import catmull_rom

        xs = jnp.linspace(0, 1, 11)
        ys = xs ** 2
        v = catmull_rom(jnp.asarray(0.55), xs, ys)
        np.testing.assert_allclose(float(v), 0.55 ** 2, atol=1e-3)


class TestVmf:
    def test_chi2(self):
        from drmlt_mitsuba.core.chisquare import chi2_test

        for kappa in [1.0, 10.0]:
            r = chi2_test(
                lambda key, n, k=kappa: warp.square_to_vmf(
                    jax.random.uniform(key, (n, 2)), k
                ),
                lambda d, k=kappa: warp.square_to_vmf_pdf(d, k),
                n_samples=300_000,
            )
            assert r.passed, (kappa, r)


class TestSh:
    def test_orthonormality(self):
        """MC estimate of <Y_i, Y_j> over the sphere is the identity."""
        from drmlt_mitsuba.core.sh import N_COEFFS, eval_sh

        u = jax.random.uniform(jax.random.PRNGKey(0), (400_000, 2))
        d = warp.square_to_uniform_sphere(u)
        b = eval_sh(d)
        gram = (b.T @ b) * (4.0 * jnp.pi / d.shape[0])
        np.testing.assert_allclose(
            np.asarray(gram), np.eye(N_COEFFS), atol=0.03)

    def test_project_reconstruct_lowpass(self):
        """A band-limited function (itself an SH expansion) round-trips."""
        from drmlt_mitsuba.core.sh import project, reconstruct

        rng = np.random.RandomState(3)
        c_true = jnp.asarray(rng.randn(16).astype(np.float32))
        u = jax.random.uniform(jax.random.PRNGKey(1), (400_000, 2))
        d = warp.square_to_uniform_sphere(u)
        vals = reconstruct(c_true, d)
        c_est = project(vals, d)
        np.testing.assert_allclose(np.asarray(c_est), np.asarray(c_true),
                                   atol=0.05)


class TestBrent:
    def test_scalar_roots(self):
        from drmlt_mitsuba.core.quad import brent

        r = brent(lambda x: x ** 3 - 2 * x - 5, jnp.asarray(2.0),
                  jnp.asarray(3.0))
        np.testing.assert_allclose(float(r), 2.0945515, atol=1e-5)
        r2 = brent(lambda x: jnp.cos(x) - x, jnp.asarray(0.0),
                   jnp.asarray(1.0))
        np.testing.assert_allclose(float(r2), 0.7390851, atol=1e-5)

    def test_batched_under_jit(self):
        from drmlt_mitsuba.core.quad import brent

        k = jnp.arange(1.0, 9.0)
        f = jax.jit(lambda: brent(lambda x: x * x - k, jnp.zeros(8),
                                  jnp.full(8, 3.0)))
        np.testing.assert_allclose(np.asarray(f()), np.sqrt(np.arange(1, 9)),
                                   atol=1e-5)
