"""The DRMLT proposal kernels (integrators/kernels.py) against their closed
forms: each sampler is an inverse-CDF map of uniforms, and each pdf is the
derivative of the matching CDF."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

from drmlt_mitsuba.integrators import kernels

GRID = (np.arange(4096) + 0.5) / 4096


@pytest.mark.parametrize("s1,s2", [(1 / 1024, 1 / 64), (1e-4, 0.1),
                                   (1.9 / 1024, 1.9 / 64)])
def test_kelemen_sample_is_inverse_cdf(s1, s2):
    """|du| is log-uniform on [s1, s2]: |du| = s1 (s2/s1)^x, sign from the
    half of [0, 1) that u falls in."""
    u = np.stack([GRID, np.zeros_like(GRID)], -1)
    got = np.asarray(kernels.Kelemen(s1, s2).sample(jnp.asarray(u)))
    x = np.where(GRID < 0.5, 2 * GRID, 2 * (GRID - 0.5))
    want = np.where(GRID < 0.5, 1.0, -1.0) * s1 * (s2 / s1) ** x
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("s1,s2", [(1 / 1024, 1 / 64), (1e-4, 0.1),
                                   (1.9 / 1024, 1.9 / 64)])
def test_kelemen_pdf_is_cdf_derivative(s1, s2):
    """pdf(du) = d/du of the folded CDF ln(|du|/s1) / (2 ln(s2/s1)), and
    zero outside [s1, s2]."""
    k = kernels.Kelemen(s1, s2)
    d = np.exp(np.linspace(np.log(s1), np.log(s2), 257))[1:-1]
    h = d * 1e-3
    cdf = lambda x: np.log(x / s1) / (2.0 * np.log(s2 / s1))
    want = (cdf(d + h) - cdf(d - h)) / (2 * h)
    for sign in (1.0, -1.0):
        got = np.asarray(k.pdf(jnp.asarray(sign * d, jnp.float32)))
        np.testing.assert_allclose(got, want, rtol=1e-3)
    out = jnp.asarray([0.5 * s1, 2.0 * s2, -2.0 * s2], jnp.float32)
    assert float(jnp.abs(k.pdf(out)).max()) == 0.0


@pytest.mark.parametrize("sigma", [1 / 64, 0.3])
def test_gaussian_pdf_closed_form(sigma):
    k = kernels.Gaussian(sigma)
    x = np.linspace(-4 * sigma, 4 * sigma, 101)
    np.testing.assert_allclose(np.asarray(k.pdf(jnp.asarray(x))),
                               stats.norm.pdf(x, scale=sigma), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(k.log_pdf(jnp.asarray(x))),
                               stats.norm.logpdf(x, scale=sigma), atol=1e-4)


@pytest.mark.parametrize("sigma", [1 / 64, 0.3])
def test_gaussian_sample_is_box_muller(sigma):
    """At u1 = 0 the Box-Muller radius is the Rayleigh inverse CDF
    sigma * sqrt(-2 ln(1 - u0)); at u1 = 1/2 it flips sign."""
    k = kernels.Gaussian(sigma)
    want = sigma * np.sqrt(-2.0 * np.log(1.0 - GRID))
    for u1, sign in ((0.0, 1.0), (0.5, -1.0)):
        u = np.stack([GRID, np.full_like(GRID, u1)], -1)
        got = np.asarray(k.sample(jnp.asarray(u, jnp.float32)))
        np.testing.assert_allclose(got, sign * want, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("rho", [math.exp(-0.25), 0.5, 0.95])
def test_wrapped_cauchy_pdf_is_wrapped_sum(rho):
    """The wrapped-Cauchy density equals the Cauchy density of scale
    gamma = -ln(rho) summed over all 2 pi wraps."""
    gamma = -math.log(rho)
    th = np.linspace(-np.pi, np.pi, 201)
    ks = np.arange(-4000, 4001)[:, None]
    want = (gamma / np.pi / (gamma ** 2 + (th[None] + 2 * np.pi * ks) ** 2)
            ).sum(0)
    got = np.asarray(kernels.WrappedCauchy(rho).pdf(jnp.asarray(th)))
    np.testing.assert_allclose(got, want, rtol=2e-3)


@pytest.mark.parametrize("rho", [math.exp(-0.25), 0.5, 0.95])
def test_wrapped_cauchy_sample_cdf(rho):
    """Samples over a uniform grid follow the folded closed-form CDF
    P(|theta| <= a) = (2/pi) atan((1+rho)/(1-rho) tan(a/2))."""
    u = np.stack([GRID, np.zeros_like(GRID)], -1)
    s = np.abs(np.asarray(kernels.WrappedCauchy(rho).sample(
        jnp.asarray(u, jnp.float32))))
    a = np.linspace(0.05, np.pi - 0.05, 40)
    emp = (s[None, :] <= a[:, None]).mean(1)
    want = 2.0 / np.pi * np.arctan((1 + rho) / (1 - rho) * np.tan(a / 2))
    np.testing.assert_allclose(emp, want, atol=2e-3)
