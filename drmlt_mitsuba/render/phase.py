"""Anisotropic + composite phase functions (ref: src/phase/kkay.cpp,
microflake.cpp + microflake_fiber.h, mixturephase.cpp).

Design notes:

* kkay — the Kajiya-Kay fiber phase exactly as the reference defines it
  (diffuse kd/(4pi) + ks * max(0, R.wo)^exponent around the specular cone
  of the fiber), with the perpendicular-illumination normalization the
  reference computes by Simpson quadrature at configure() time
  (kkay.cpp:58-75) — here evaluated once in numpy at build.  Sampling is
  uniform-sphere like the reference (kkay.cpp:88-100).

* microflake — the reference implements the Gaussian-fiber microflake
  model with fitted series expansions and REJECTION sampling
  (microflake.cpp:118-136), which is hostile to a lock-step SIMD machine.
  The native equivalent here is the SGGX microflake distribution (Heitz et
  al. 2015), which is the same microflake theory with closed forms for the
  flake density D(m), the projected area sigma(w), and exact visible-
  normal sampling — zero iteration, zero tables.  A fiber along f with
  Gaussian stddev s maps to S = eps^2 f f^T + (I - f f^T), eps ~ sqrt(2) s
  (matched so the projected area along the fiber agrees to first order).
  Like the reference's model this phase has directionally-varying
  extinction: sigma(w) modulates sigma_t per ray (sigma_dir below).

* mixturephase — weight-normalized sum of HG/Rayleigh/isotropic lobes;
  one-draw component selection with the full mixture density as the pdf
  (balance heuristic over components, matching mixturephase.cpp:150-176).

All functions are batched over lanes; wi/wo both point AWAY from the
scattering event (wi toward the previous vertex), the convention of the
reference's PhaseFunctionSamplingRecord.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.core import frame

HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------- kkay --

def kkay_normalization(exponent: float) -> float:
    """Simpson quadrature of the reference's perpendicular-illumination
    normalization integral (kkay.cpp:58-75)."""
    n = 1000
    theta = np.linspace(0.0, np.pi, n + 1)
    f = np.cos(theta - np.pi / 2) ** exponent * np.sin(theta)
    w = np.ones(n + 1)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    integral = (np.pi / n) / 3.0 * float(np.sum(w * f)) * 2.0 * np.pi
    return 1.0 / integral


def kkay_eval(fiber, ks, kd, exponent, norm, wi, wo):
    """Kajiya-Kay phase value.  fiber (3,) or (R,3); wi/wo (R,3)."""
    fiber = jnp.broadcast_to(fiber, wo.shape)
    # decompose wo into fiber-axial and perpendicular parts
    wo_z = jnp.sum(wo * fiber, -1)
    perp = wo - wo_z[:, None] * fiber
    perp_len = jnp.linalg.norm(perp, axis=-1)
    # R: same azimuth as wo around the fiber, axial component -wi.fiber
    r_z = -jnp.sum(wi * fiber, -1)
    a = jnp.sqrt(jnp.maximum(1.0 - r_z * r_z, 0.0)) / jnp.maximum(
        perp_len, 1e-12)
    R = perp * a[:, None] + r_z[:, None] * fiber
    spec = jnp.maximum(jnp.sum(R * wo, -1), 0.0) ** exponent
    return spec * norm * ks + kd / (4.0 * jnp.pi)


def kkay_sample(fiber, ks, kd, exponent, norm, wi, u2):
    """Uniform-sphere sampling (ref kkay.cpp): returns (wo, pdf, value)."""
    cos_t = 1.0 - 2.0 * u2[..., 0]
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * jnp.pi * u2[..., 1]
    wo = jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], -1)
    pdf = jnp.full(wo.shape[:-1], 1.0 / (4.0 * jnp.pi))
    return wo, pdf, kkay_eval(fiber, ks, kd, exponent, norm, wi, wo)


# ---------------------------------------------------------------- SGGX --

def sggx_fiber_S(fiber, stddev):
    """S matrix for a fiber microflake distribution: eps^2 along the fiber,
    1 across it.  fiber (..., 3), stddev scalar or (...,) ->
    (..., 3, 3) (per-lane S batches supported)."""
    f = fiber / jnp.maximum(
        jnp.linalg.norm(fiber, axis=-1, keepdims=True), 1e-12)
    eps = jnp.clip(jnp.asarray(stddev) * jnp.sqrt(2.0), 1e-3, 1.0)
    eye = jnp.broadcast_to(jnp.eye(3), f.shape[:-1] + (3, 3))
    ff = f[..., :, None] * f[..., None, :]
    return (eps * eps)[..., None, None] * ff + (eye - ff)


def _sq(S, a, b):
    """a^T S b for shared (3,3) or per-lane (R,3,3) S."""
    if S.ndim == 3:
        return jnp.einsum("ri,rij,rj->r", a, S, b, precision=HIGHEST)
    return jnp.einsum("ri,ij,rj->r", a, S, b, precision=HIGHEST)


def sggx_sigma(S, w):
    """Projected flake area sigma(w) = sqrt(w^T S w).  w (R,3); S may be
    shared (3,3) or per-lane (R,3,3)."""
    return jnp.sqrt(jnp.maximum(_sq(S, w, w), 1e-16))


def sggx_D(S, m):
    """Flake normal density D(m) = 1/(pi sqrt|S| (m^T S^-1 m)^2)."""
    det = jnp.linalg.det(S)
    S_inv = jnp.linalg.inv(S)
    q = _sq(S_inv, m, m)
    return 1.0 / (jnp.pi * jnp.sqrt(jnp.maximum(det, 1e-20))
                  * jnp.maximum(q, 1e-12) ** 2)


def sggx_sample_vndf(S, wi, u2):
    """Sample a visible flake normal (Heitz et al. 2015, listing 3).

    wi (R,3) points away from the event; returns wm (R,3)."""
    r = jnp.sqrt(u2[..., 0])
    phi = 2.0 * jnp.pi * u2[..., 1]
    u = r * jnp.cos(phi)
    v = r * jnp.sin(phi)
    w = jnp.sqrt(jnp.maximum(1.0 - u * u - v * v, 0.0))

    # orthonormal basis (wk, wj, wi)
    wk, wj = frame.coordinate_system(wi)
    Sw = lambda a, b: _sq(S, a, b)
    S_kk, S_jj, S_ii = Sw(wk, wk), Sw(wj, wj), Sw(wi, wi)
    S_kj, S_ki, S_ji = Sw(wk, wj), Sw(wk, wi), Sw(wj, wi)

    det = (S_kk * S_jj * S_ii - S_kj * S_kj * S_ii - S_ki * S_ki * S_jj
           - S_ji * S_ji * S_kk + 2.0 * S_kj * S_ki * S_ji)
    sqrt_det = jnp.sqrt(jnp.maximum(jnp.abs(det), 1e-24))
    inv_sqrt_Sii = 1.0 / jnp.sqrt(jnp.maximum(S_ii, 1e-12))
    tmp = jnp.sqrt(jnp.maximum(S_jj * S_ii - S_ji * S_ji, 1e-24))
    Mk = jnp.stack([sqrt_det / tmp,
                    jnp.zeros_like(tmp), jnp.zeros_like(tmp)], -1)
    Mj = jnp.stack([-inv_sqrt_Sii * (S_ki * S_ji - S_kj * S_ii) / tmp,
                    inv_sqrt_Sii * tmp, jnp.zeros_like(tmp)], -1)
    Mi = jnp.stack([inv_sqrt_Sii * S_ki, inv_sqrt_Sii * S_ji,
                    inv_sqrt_Sii * S_ii], -1)
    wm_kji = (u[:, None] * Mk + v[:, None] * Mj + w[:, None] * Mi)
    wm_kji = wm_kji / jnp.maximum(
        jnp.linalg.norm(wm_kji, axis=-1, keepdims=True), 1e-12)
    return (wm_kji[:, 0:1] * wk + wm_kji[:, 1:2] * wj
            + wm_kji[:, 2:3] * wi)


def sggx_eval(S, wi, wo):
    """Specular microflake phase: p = D(h) / (4 sigma(wi))."""
    h = wi + wo
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    return sggx_D(S, h) / (4.0 * jnp.maximum(sggx_sigma(S, wi), 1e-12))


def sggx_sample(S, wi, u2):
    """Perfect specular-microflake sampling: visible normal + mirror
    reflection; weight 1, pdf = phase value.  Returns (wo, pdf)."""
    wm = sggx_sample_vndf(S, wi, u2)
    wo = 2.0 * jnp.sum(wi * wm, -1, keepdims=True) * wm - wi
    return wo, sggx_eval(S, wi, wo)
