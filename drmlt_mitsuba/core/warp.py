"""Square -> distribution warps with matching pdfs.

Replacement for the reference's `include/mitsuba/core/warp.h` /
`src/libcore/warp.cpp`.  Every warp is a pure elementwise map of 2D uniforms
(..., 2) -> samples, paired with a pdf function, so each one is testable by
the chi-square harness (core/chisquare.py — the analog of
src/tests/test_chisquare.cpp).
"""
from __future__ import annotations

import jax.numpy as jnp

from drmlt_mitsuba.core.math import INV_PI, INV_TWO_PI, safe_sqrt


def square_to_uniform_disk_concentric(u):
    """Shirley-Chiu concentric disk mapping (low-distortion)."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    zero = (x == 0) & (y == 0)
    use_x = jnp.abs(x) > jnp.abs(y)
    r = jnp.where(use_x, x, y)
    # guard 0/0 at the origin
    ratio = jnp.where(
        use_x,
        jnp.where(x != 0, y / jnp.where(x != 0, x, 1.0), 0.0),
        jnp.where(y != 0, x / jnp.where(y != 0, y, 1.0), 0.0),
    )
    phi = jnp.where(
        use_x, (jnp.pi / 4.0) * ratio, (jnp.pi / 2.0) - (jnp.pi / 4.0) * ratio
    )
    r = jnp.where(zero, 0.0, r)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def square_to_cosine_hemisphere(u):
    """Cosine-weighted hemisphere direction (z up), via concentric disk."""
    p = square_to_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return jnp.stack([p[..., 0], p[..., 1], z], axis=-1)


def square_to_cosine_hemisphere_pdf(d):
    return jnp.maximum(d[..., 2], 0.0) * INV_PI


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_sphere_pdf(d):
    return jnp.full(d.shape[:-1], 0.25 * INV_PI)


def square_to_uniform_hemisphere(u):
    z = u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_hemisphere_pdf(d):
    return jnp.where(d[..., 2] >= 0, 0.5 * INV_PI, 0.0)


def square_to_uniform_triangle(u):
    """Barycentric (b0, b1) uniform on the unit triangle (sqrt warp)."""
    t = safe_sqrt(1.0 - u[..., 0])
    return jnp.stack([1.0 - t, t * u[..., 1]], axis=-1)


def square_to_uniform_cone(u, cos_cutoff):
    """Uniform direction in a cone around +z with aperture cos_cutoff."""
    z = 1.0 - u[..., 0] * (1.0 - cos_cutoff)
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_cone_pdf(cos_cutoff):
    return INV_TWO_PI / (1.0 - cos_cutoff)


def square_to_std_normal(u):
    """Box-Muller: two U(0,1) -> two N(0,1).

    Matches the reference GaussianKernel::sample Box-Muller form
    (src/integrators/drmlt/tools/transition.h).
    """
    r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(1.0 - u[..., 0], 1e-38)))
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def interval_to_tent(u):
    """U(0,1) -> tent distribution on [-1, 1]."""
    s = jnp.where(u < 0.5, 1.0, -1.0)
    x = jnp.where(u < 0.5, 2.0 * u, 2.0 - 2.0 * u)
    return s * (1.0 - safe_sqrt(x))


def square_to_vmf(u, kappa):
    """von Mises-Fisher direction around +z with concentration kappa
    (ref: include/mitsuba/core/vmf.h)."""
    w = 1.0 + jnp.log(
        jnp.maximum(u[..., 0], 1e-38)
        + (1.0 - u[..., 0]) * jnp.exp(-2.0 * kappa)
    ) / kappa
    r = safe_sqrt(1.0 - w * w)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), w], axis=-1)


def square_to_vmf_pdf(d, kappa):
    """vMF pdf: kappa * e^{kappa cos} / (2 pi (e^k - e^-k))."""
    c = kappa / (2.0 * jnp.pi * (1.0 - jnp.exp(-2.0 * kappa)))
    return c * jnp.exp(kappa * (d[..., 2] - 1.0))
