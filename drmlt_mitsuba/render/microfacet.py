"""GGX / Beckmann microfacet distributions with visible-normal sampling.

Capability match for the reference's src/bsdfs/microfacet.h (Beckmann/GGX,
sampleVisible), re-derived from the standard published formulations (Heitz
2018 VNDF sampling) in branchless jit-safe form.  All directions are in the
local shading frame (z up); alpha is the isotropic roughness.
"""
from __future__ import annotations

import jax.numpy as jnp

from drmlt_mitsuba.core.math import safe_sqrt


def ggx_ndf(m, alpha):
    """GGX normal distribution D(m)."""
    a2 = alpha * alpha
    c2 = m[..., 2] * m[..., 2]
    denom = c2 * (a2 - 1.0) + 1.0
    d = a2 / jnp.maximum(jnp.pi * denom * denom, 1e-12)
    return jnp.where(m[..., 2] > 0, d, 0.0)


def ggx_lambda(w, alpha):
    """Smith Lambda for GGX."""
    cz = jnp.abs(w[..., 2])
    s2 = jnp.maximum(1.0 - cz * cz, 0.0)
    a2 = alpha * alpha
    return 0.5 * (safe_sqrt(1.0 + a2 * s2 / jnp.maximum(cz * cz, 1e-12)) - 1.0)


def ggx_g1(w, alpha):
    return 1.0 / (1.0 + ggx_lambda(w, alpha))


def ggx_g2(wi, wo, alpha):
    """Height-correlated Smith shadowing-masking."""
    return 1.0 / (1.0 + ggx_lambda(wi, alpha) + ggx_lambda(wo, alpha))


def ggx_sample_vndf(wi, alpha, u):
    """Sample the GGX distribution of visible normals (Heitz 2018).

    wi must be in the upper hemisphere (callers flip beforehand).
    Returns the sampled half-vector m (unit, upper hemisphere).
    """
    # stretch view direction
    vh = jnp.stack(
        [alpha * wi[..., 0], alpha * wi[..., 1], wi[..., 2]], axis=-1
    )
    vh = vh / jnp.maximum(
        jnp.linalg.norm(vh, axis=-1, keepdims=True), 1e-12
    )
    # orthonormal basis around vh
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / jnp.sqrt(jnp.maximum(lensq, 1e-20))
    t1 = jnp.where(
        (lensq > 1e-18)[..., None],
        jnp.stack([-vh[..., 1] * inv, vh[..., 0] * inv, jnp.zeros_like(inv)], -1),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), vh.shape),
    )
    t2 = jnp.cross(vh, t1)
    # parameterize projected area
    r = safe_sqrt(u[..., 0])
    phi = 2.0 * jnp.pi * u[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = safe_sqrt(jnp.maximum(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    # unstretch
    m = jnp.stack(
        [alpha * nh[..., 0], alpha * nh[..., 1], jnp.maximum(nh[..., 2], 1e-6)],
        axis=-1,
    )
    return m / jnp.maximum(jnp.linalg.norm(m, axis=-1, keepdims=True), 1e-12)


def ggx_vndf_pdf(wi, m, alpha):
    """pdf of ggx_sample_vndf in the half-vector measure."""
    g1 = ggx_g1(wi, alpha)
    d = ggx_ndf(m, alpha)
    dot_im = jnp.maximum(jnp.sum(wi * m, axis=-1), 0.0)
    return g1 * dot_im * d / jnp.maximum(jnp.abs(wi[..., 2]), 1e-12)
