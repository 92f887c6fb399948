"""Branchless BSDF evaluation/sampling over the material table.

The reference dispatches virtually to 23 BSDF plugins (src/bsdfs/); here a
surface interaction carries a `kind` enum and the lobes PRESENT IN THE SCENE
(MaterialTable.kinds_present, a static field) are evaluated and blended with
masks — the idiomatic SPMD replacement for per-lane virtual dispatch.  A
diffuse-only scene compiles to just the cosine-hemisphere code.

Conventions (local shading frame, z = shading normal):
  * wi points toward the viewer/camera, wo toward the light/next bounce.
  * eval() returns f(wi,wo) * |cos_theta_o| and the sampling pdf
    (solid angle), zero for Dirac lobes.
  * sample() consumes exactly 3 uniforms (component pick + 2D) and returns
    (wo, weight = f*cos/pdf, pdf, sampled_delta, eta).

Smooth-transmission radiance scaling uses the (1/eta)^2 factor for radiance
transport (ref: dielectric.cpp).
"""
from __future__ import annotations

import jax.numpy as jnp

from drmlt_mitsuba.core import struct
from drmlt_mitsuba.core.math import (
    INV_PI, fresnel_conductor, fresnel_dielectric, reflect, safe_div,
)
from drmlt_mitsuba.core.warp import (
    square_to_cosine_hemisphere, square_to_cosine_hemisphere_pdf,
)
from drmlt_mitsuba.render.microfacet import (
    ggx_g1, ggx_g2, ggx_ndf, ggx_sample_vndf, ggx_vndf_pdf,
)
from drmlt_mitsuba.scene.types import (
    BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE, BSDF_MIRROR, BSDF_NULL,
    BSDF_PHONG, BSDF_PLASTIC, BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC,
    BSDF_DIFFTRANS, BSDF_HK, BSDF_IRAWAN, BSDF_ROUGH_DIFFUSE,
    BSDF_ROUGH_PLASTIC, BSDF_THIN_DIELECTRIC,
    BSDF_WARD, MaterialTable,
)

ALL_KINDS = (
    BSDF_DIFFUSE, BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_ROUGH_CONDUCTOR,
    BSDF_PLASTIC, BSDF_ROUGH_PLASTIC, BSDF_THIN_DIELECTRIC,
    BSDF_ROUGH_DIELECTRIC, BSDF_MIRROR, BSDF_NULL, BSDF_PHONG, BSDF_WARD,
    BSDF_ROUGH_DIFFUSE, BSDF_DIFFTRANS, BSDF_HK, BSDF_IRAWAN,
)

DELTA_KINDS = (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_MIRROR, BSDF_NULL,
               BSDF_THIN_DIELECTRIC)

# kinds grouped by which shared lobe machinery they need.  BSDF_IRAWAN
# shares the diffuse machinery: without a uv-carrying caller it evaluates
# as a diffuse surface with the average yarn kd (the reference shader's
# own fallback, irawan.cpp:684-691); uv-aware callers overlay the full
# cloth model via the `irawan=`/`uv=` arguments of eval/sample/pdf.
_DIFFUSE_LIKE = (BSDF_DIFFUSE, BSDF_IRAWAN)
_GGX_LIKE = (BSDF_ROUGH_CONDUCTOR,)
_PLASTIC_LIKE = (BSDF_PLASTIC, BSDF_ROUGH_PLASTIC)
_DIELECTRIC_LIKE = (BSDF_DIELECTRIC, BSDF_THIN_DIELECTRIC)


@struct.dataclass
class BsdfSample:
    wo: jnp.ndarray        # (R, 3) sampled direction, local frame
    weight: jnp.ndarray    # (R, 3) f * cos / pdf (includes discrete probs)
    pdf: jnp.ndarray       # (R,) solid-angle pdf (0 for delta lobes)
    delta: jnp.ndarray     # (R,) bool: sampled a Dirac lobe
    eta: jnp.ndarray       # (R,) relative IOR of the sampled transition


def _present(table: MaterialTable, *kinds) -> bool:
    if not table.kinds_present:
        return True
    return any(k in table.kinds_present for k in kinds)


def _mat(table: MaterialTable, mat_id):
    """One fused row-select over the packed parameter matrix (built live
    from the table fields so gradients flow; hoisted out of scans)."""
    from drmlt_mitsuba.ops.gather import onehot_gather, pack_rows

    packed = pack_rows(table.kind, table.albedo, table.eta, table.k,
                       table.roughness, table.spec_refl, table.spec_trans)
    row = onehot_gather(packed, mat_id)
    return (
        row[..., 0].astype(jnp.int32),
        row[..., 1:4],
        row[..., 4:7],
        row[..., 7:10],
        jnp.maximum(row[..., 10], 1e-3),
        row[..., 11:14],
        row[..., 14:17],
    )


def _plastic_specular_prob(f_i):
    return jnp.clip(f_i, 0.05, 0.95)


def _eval_core(table: MaterialTable, mat_id, albedo_tex, wi, wo):
    """(f * |cos wo|, pdf) for non-delta lobes; (0, 0) for Dirac kinds."""
    kind, _, eta, k, alpha, spec_refl, spec_trans = _mat(table, mat_id)
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    same_side = (cos_i * cos_o) > 0
    upper = cos_i > 0
    abs_cos_o = jnp.abs(cos_o)

    value = jnp.zeros(wi.shape[:-1] + (3,))
    pdf = jnp.zeros(wi.shape[:-1])

    diff_pdf = None
    if _present(table, *_DIFFUSE_LIKE, *_PLASTIC_LIKE):
        diff_val = albedo_tex * (INV_PI * abs_cos_o)[..., None]
        diff_pdf = square_to_cosine_hemisphere_pdf(
            jnp.stack([wo[..., 0], wo[..., 1], abs_cos_o], -1)
        )

    if _present(table, *_DIFFUSE_LIKE):
        for kk in _DIFFUSE_LIKE:
            m = (kind == kk) & same_side
            value = jnp.where(m[..., None], diff_val, value)
            pdf = jnp.where(m, diff_pdf, pdf)

    if _present(table, *_GGX_LIKE):
        h = wo + wi
        h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
        h = h * jnp.sign(h[..., 2:3])
        wi_u = wi * jnp.sign(cos_i)[..., None]
        wo_u = wo * jnp.sign(cos_i)[..., None]
        d = ggx_ndf(h, alpha)
        g = ggx_g2(wi_u, wo_u, alpha)
        f_cond = fresnel_conductor(jnp.abs(jnp.sum(wi * h, axis=-1)), eta, k)
        rc_val = (
            spec_refl * f_cond * safe_div(d * g, 4.0 * jnp.abs(cos_i))[..., None]
        )
        m_pdf = ggx_vndf_pdf(wi_u, h, alpha)
        rc_pdf = m_pdf / jnp.maximum(
            4.0 * jnp.abs(jnp.sum(wo * h, axis=-1)), 1e-12
        )
        for kk in _GGX_LIKE:
            m = (kind == kk) & same_side
            value = jnp.where(m[..., None], rc_val, value)
            pdf = jnp.where(m, rc_pdf, pdf)

    if _present(table, *_PLASTIC_LIKE):
        eta_d = eta[..., 0]
        f_i, _, _ = fresnel_dielectric(jnp.abs(cos_i), eta_d)
        f_o, _, _ = fresnel_dielectric(jnp.abs(cos_o), eta_d)
        pl_val = albedo_tex * (
            (1.0 - f_i) * (1.0 - f_o) * INV_PI * abs_cos_o
        )[..., None]
        spec_prob = _plastic_specular_prob(f_i)
        pl_pdf = (1.0 - spec_prob) * diff_pdf
        for kk in _PLASTIC_LIKE:
            m = (kind == kk) & same_side & upper
            value = jnp.where(m[..., None], pl_val, value)
            pdf = jnp.where(m, pl_pdf, pdf)

    if _present(table, BSDF_DIFFTRANS):
        # diffuse transmitter: T/pi on the OPPOSITE hemisphere
        # (ref: difftrans.cpp behavior)
        dt_val = albedo_tex * (INV_PI * abs_cos_o)[..., None]
        dt_pdf = square_to_cosine_hemisphere_pdf(
            jnp.stack([wo[..., 0], wo[..., 1], abs_cos_o], -1)
        )
        m = (kind == BSDF_DIFFTRANS) & ~same_side
        value = jnp.where(m[..., None], dt_val, value)
        pdf = jnp.where(m, dt_pdf, pdf)


    if _present(table, BSDF_HK):
        # Hanrahan-Krueger single-scattering slab (ref: hk.cpp).  Chromatic
        # optical depth tau = (sigmaS+sigmaA)*thickness; HG phase between
        # the propagation direction -wi and wo.  Smooth lobes only here —
        # the unscattered attenuated straight-through ray is a Dirac lobe
        # handled in sample_bsdf.
        from drmlt_mitsuba.render.medium import hg_phase

        sigma_s = spec_refl
        sigma_t_hk = spec_refl + spec_trans
        alb_ss = sigma_s / jnp.maximum(sigma_t_hk, 1e-20)
        tau = sigma_t_hk * alpha[..., None]
        g_hk = k[..., 0]
        mu_i = jnp.maximum(jnp.abs(cos_i), 1e-4)
        mu_o = jnp.maximum(abs_cos_o, 1e-4)
        cos_gamma = -jnp.sum(wi * wo, axis=-1)
        ph = hg_phase(g_hk, cos_gamma)[..., None]
        # reflection: alpha p/(mu_i+mu_o) (1 - e^{-tau(1/mu_i+1/mu_o)})
        f_r = alb_ss * ph / (mu_i + mu_o)[..., None] * (
            1.0 - jnp.exp(-tau * (1.0 / mu_i + 1.0 / mu_o)[..., None])
        )
        # transmission: alpha p (e^{-tau/mu_i} - e^{-tau/mu_o})/(mu_i-mu_o)
        dmu = (mu_i - mu_o)[..., None]
        ratio = (jnp.exp(-tau / mu_i[..., None])
                 - jnp.exp(-tau / mu_o[..., None])) / jnp.where(
            jnp.abs(dmu) < 1e-4, 1.0, dmu)
        lim = tau / (mu_i * mu_i)[..., None] * jnp.exp(
            -tau / mu_i[..., None])
        f_t = alb_ss * ph * jnp.where(jnp.abs(dmu) < 1e-4, lim, ratio)
        hk_f = jnp.where(same_side[..., None], f_r, f_t)
        hk_val = hk_f * abs_cos_o[..., None]
        # pdf: (1 - p_delta) * cosine on the chosen hemisphere * 1/2
        t0_mean = jnp.exp(-jnp.mean(tau, -1) / mu_i)
        hk_pdf = (1.0 - t0_mean) * 0.5 * square_to_cosine_hemisphere_pdf(
            jnp.stack([wo[..., 0], wo[..., 1], abs_cos_o], -1))
        m = kind == BSDF_HK
        value = jnp.where(m[..., None], hk_val, value)
        pdf = jnp.where(m, hk_pdf, pdf)

    if _present(table, BSDF_ROUGH_DIFFUSE):
        # Oren-Nayar qualitative model (ref: roughdiffuse.cpp "fast" mode)
        sigma = alpha  # roughness doubles as sigma (radians)
        s2 = sigma * sigma
        A = 1.0 - 0.5 * s2 / (s2 + 0.33)
        B = 0.45 * s2 / (s2 + 0.09)
        ci = jnp.abs(cos_i)
        co = abs_cos_o
        sin_i = jnp.sqrt(jnp.maximum(1 - ci * ci, 0.0))
        sin_o = jnp.sqrt(jnp.maximum(1 - co * co, 0.0))
        # cos(phi_i - phi_o) from the tangent-plane projections
        denom = jnp.maximum(sin_i * sin_o, 1e-7)
        cos_dphi = jnp.clip(
            (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / denom,
            -1.0, 1.0,
        )
        sin_alpha = jnp.maximum(sin_i, sin_o)
        tan_beta = jnp.minimum(sin_i / jnp.maximum(ci, 1e-7),
                               sin_o / jnp.maximum(co, 1e-7))
        on = A + B * jnp.maximum(cos_dphi, 0.0) * sin_alpha * tan_beta
        on_val = albedo_tex * (INV_PI * abs_cos_o * on)[..., None]
        m = (kind == BSDF_ROUGH_DIFFUSE) & same_side
        value = jnp.where(m[..., None], on_val, value)
        pdf = jnp.where(m, diff_pdf if diff_pdf is not None else
                        square_to_cosine_hemisphere_pdf(
                            jnp.stack([wo[..., 0], wo[..., 1], abs_cos_o],
                                      -1)), pdf)

    if _present(table, BSDF_PHONG):
        # modified Phong (ref: phong.cpp): diffuse + (n+2)/2pi cos^n lobe
        n_exp = _phong_exponent(alpha)
        refl = jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)
        cos_r = jnp.clip(jnp.sum(refl * wo, axis=-1), 0.0, 1.0)
        spec = spec_refl * ((n_exp + 2) / (2 * jnp.pi)
                            * cos_r ** n_exp)[..., None]
        ph_val = (albedo_tex * INV_PI + spec) * abs_cos_o[..., None]
        w_s = _phong_spec_weight(albedo_tex, spec_refl)
        ph_pdf = (
            (1 - w_s) * (diff_pdf if diff_pdf is not None else abs_cos_o * INV_PI)
            + w_s * (n_exp + 1) / (2 * jnp.pi) * cos_r ** n_exp
        )
        m = (kind == BSDF_PHONG) & same_side & upper
        value = jnp.where(m[..., None], ph_val, value)
        pdf = jnp.where(m, ph_pdf, pdf)

    if _present(table, BSDF_WARD):
        # isotropic Ward-Duer (ref: ward.cpp, EWardDuer variant)
        h = wi + wo
        hn = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True),
                             1e-12)
        a2 = alpha * alpha
        ct_h2 = jnp.maximum(hn[..., 2] ** 2, 1e-7)
        tt2 = (1.0 - ct_h2) / ct_h2
        expf = jnp.exp(-tt2 / a2)
        norm_w = expf / (4 * jnp.pi * a2 * jnp.maximum(
            jnp.abs(cos_i) * abs_cos_o, 1e-7))
        wd_val = (albedo_tex * INV_PI
                  + spec_refl * norm_w[..., None]) * abs_cos_o[..., None]
        # sampling pdf: half-vector ward lobe + diffuse mixture
        h_pdf = expf / (jnp.pi * a2 * ct_h2 * jnp.maximum(
            jnp.sqrt(ct_h2), 1e-7))
        wo_dot_h = jnp.maximum(jnp.abs(jnp.sum(wo * hn, -1)), 1e-7)
        w_s = _phong_spec_weight(albedo_tex, spec_refl)
        wd_pdf = ((1 - w_s) * abs_cos_o * INV_PI
                  + w_s * h_pdf / (4 * wo_dot_h))
        m = (kind == BSDF_WARD) & same_side & upper
        value = jnp.where(m[..., None], wd_val, value)
        pdf = jnp.where(m, wd_pdf, pdf)

    if _present(table, BSDF_ROUGH_DIELECTRIC):
        value, pdf = _rough_dielectric_eval(
            kind, eta, alpha, spec_refl, spec_trans, wi, wo, value, pdf
        )

    return value, pdf


def _phong_exponent(alpha):
    """roughness alpha <-> Phong exponent (inverse of the xml mapping)."""
    return jnp.maximum(2.0 / jnp.maximum(alpha * alpha, 1e-6) - 2.0, 1.0)


def _phong_spec_weight(albedo, spec_refl):
    from drmlt_mitsuba.core.spectrum import luminance

    ls = luminance(spec_refl)
    ld = luminance(albedo)
    return jnp.clip(safe_div(ls, ls + ld, 0.5), 0.05, 0.95)


def _rough_dielectric_eval(kind, eta, alpha, spec_refl, spec_trans, wi, wo,
                           value, pdf):
    """Walter 2007 rough dielectric (GGX, VNDF pdf): reflection +
    refraction lobes."""
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    eta_d = eta[..., 0]
    sign_i = jnp.sign(jnp.where(cos_i == 0, 1.0, cos_i))
    wi_u = wi * sign_i[..., None]
    wo_u = wo * sign_i[..., None]
    reflecting = (cos_i * cos_o) > 0
    # relative IOR of the transmission side
    eta_rel = jnp.where(cos_i > 0, eta_d, 1.0 / eta_d)

    # reflection half-vector
    h_r = wi_u + wo_u
    h_r = h_r / jnp.maximum(
        jnp.linalg.norm(h_r, axis=-1, keepdims=True), 1e-12)
    # transmission half-vector (Walter eq. 16), in the upper frame
    h_t = -(wi_u + wo_u * eta_rel[..., None])
    h_t = h_t / jnp.maximum(
        jnp.linalg.norm(h_t, axis=-1, keepdims=True), 1e-12)
    h_t = h_t * jnp.sign(h_t[..., 2:3])
    h = jnp.where(reflecting[..., None], h_r, h_t)

    d = ggx_ndf(h, alpha)
    g = ggx_g2(wi_u, wo_u, alpha)
    i_dot_h = jnp.sum(wi_u * h, -1)
    o_dot_h = jnp.sum(wo_u * h, -1)
    f, _, _ = fresnel_dielectric(i_dot_h, eta_d)

    refl_val = spec_refl * safe_div(d * g * f, 4.0 * jnp.abs(cos_i))[..., None]
    # Walter eq. 21 (x |cos_o| folded in), with the radiance (1/eta)^2 scale
    denom = i_dot_h + eta_rel * o_dot_h
    jac = safe_div(eta_rel * eta_rel * jnp.abs(o_dot_h),
                   jnp.maximum(denom * denom, 1e-12))
    trans = safe_div(
        jnp.abs(i_dot_h) * d * g * (1.0 - f), jnp.abs(cos_i)
    ) * jac / jnp.maximum(jnp.abs(cos_o), 1e-7) / (eta_rel * eta_rel)
    trans_val = spec_trans * (trans * jnp.abs(cos_o))[..., None]

    m_pdf = ggx_vndf_pdf(wi_u, h, alpha)
    pdf_refl = f * m_pdf / jnp.maximum(4.0 * jnp.abs(o_dot_h), 1e-12)
    pdf_trans = (1.0 - f) * m_pdf * jac

    mk = kind == BSDF_ROUGH_DIELECTRIC
    vv = jnp.where(reflecting[..., None], refl_val, trans_val)
    pp = jnp.where(reflecting, pdf_refl, pdf_trans)
    # Walter sidedness checks: the half-vector must see the incident ray
    # from above and the transmitted ray from below (eq. 7 constraints) —
    # without them the pdf overcounts near-grazing transmission
    side_ok = jnp.where(
        reflecting, (i_dot_h > 0) & (o_dot_h > 0),
        (i_dot_h > 0) & (o_dot_h < 0),
    )
    ok = (h[..., 2] > 0) & side_ok
    value = jnp.where((mk & ok)[..., None], vv, value)
    pdf = jnp.where(mk & ok, pp, pdf)
    return value, pdf


def pdf_bsdf(table: MaterialTable, mat_id, albedo_tex, wi, wo):
    _, pdf = eval_bsdf(table, mat_id, albedo_tex, wi, wo)
    return pdf


def _sample_core(table: MaterialTable, mat_id, albedo_tex, wi, u3) -> BsdfSample:
    """Sample wo from the BSDF; u3 = (component, u, v) uniforms (R, 3)."""
    kind, _, eta, k, alpha, spec_refl, spec_trans = _mat(table, mat_id)
    cos_i = wi[..., 2]
    sign_i = jnp.sign(jnp.where(cos_i == 0, 1.0, cos_i))
    wi_u = wi * sign_i[..., None]
    u2 = u3[..., 1:3]
    uc = u3[..., 0]
    ones = jnp.ones_like(cos_i)
    R3 = wi.shape[:-1] + (3,)

    wo = jnp.zeros(R3)
    weight = jnp.zeros(R3)
    pdf = jnp.zeros_like(cos_i)
    delta = jnp.zeros_like(cos_i, dtype=bool)
    eta_out = ones

    def setk(kk, wo_k, w_k, pdf_k, delta_k, eta_k=None):
        nonlocal wo, weight, pdf, delta, eta_out
        mk = kind == kk
        wo = jnp.where(mk[..., None], wo_k, wo)
        weight = jnp.where(mk[..., None], w_k, weight)
        pdf = jnp.where(mk, pdf_k, pdf)
        delta = jnp.where(mk, delta_k, delta)
        if eta_k is not None:
            eta_out = jnp.where(mk, eta_k, eta_out)

    true_ = jnp.ones_like(delta)
    false_ = jnp.zeros_like(delta)

    need_spec_dir = _present(
        table, BSDF_CONDUCTOR, BSDF_MIRROR, *_DIELECTRIC_LIKE, *_PLASTIC_LIKE
    )
    if need_spec_dir:
        wo_spec = jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)

    if _present(table, *_DIFFUSE_LIKE, *_PLASTIC_LIKE):
        wo_diff = square_to_cosine_hemisphere(u2) * sign_i[..., None]
        pdf_diff = square_to_cosine_hemisphere_pdf(wo_diff * sign_i[..., None])

    if _present(table, *_DIFFUSE_LIKE):
        for kk in _DIFFUSE_LIKE:
            setk(kk, wo_diff, albedo_tex, pdf_diff, false_)

    if _present(table, BSDF_CONDUCTOR):
        f_cond = fresnel_conductor(jnp.abs(cos_i), eta, k)
        setk(BSDF_CONDUCTOR, wo_spec, spec_refl * f_cond,
             jnp.zeros_like(pdf), true_)
    if _present(table, BSDF_MIRROR):
        setk(BSDF_MIRROR, wo_spec, spec_refl, jnp.zeros_like(pdf), true_)

    if _present(table, *_DIELECTRIC_LIKE):
        eta_d = eta[..., 0]
        f_d, cos_t, _tir = fresnel_dielectric(cos_i, eta_d)
        if _present(table, BSDF_DIELECTRIC):
            pick_refl = uc < f_d
            eta_ti = jnp.where(cos_i > 0, 1.0 / eta_d, eta_d)
            # transmitted ray exits on the OPPOSITE side of the interface
            # (fresnel_dielectric returns |cos_t|; regression: refraction
            # used +cos_t for entering rays, bouncing them back up)
            cos_t_signed = jnp.where(cos_i > 0, -cos_t, cos_t)
            wo_refr = jnp.stack(
                [-wi[..., 0] * eta_ti, -wi[..., 1] * eta_ti, cos_t_signed], -1
            )
            wo_diel = jnp.where(pick_refl[..., None], wo_spec, wo_refr)
            factor = jnp.where(cos_i > 0, 1.0 / eta_d, eta_d)
            w_diel = jnp.where(
                pick_refl[..., None], spec_refl,
                spec_trans * (factor * factor)[..., None],
            )
            eta_diel = jnp.where(
                pick_refl, 1.0, jnp.where(cos_i > 0, eta_d, 1.0 / eta_d)
            )
            setk(BSDF_DIELECTRIC, wo_diel, w_diel, jnp.zeros_like(pdf),
                 true_, eta_diel)
        if _present(table, BSDF_THIN_DIELECTRIC):
            f_thin = jnp.where(f_d < 1.0, f_d * 2.0 / (1.0 + f_d), 1.0)
            pick_rt = uc < f_thin
            wo_thin = jnp.where(pick_rt[..., None], wo_spec, -wi)
            w_thin = jnp.where(pick_rt[..., None], spec_refl, spec_trans)
            setk(BSDF_THIN_DIELECTRIC, wo_thin, w_thin,
                 jnp.zeros_like(pdf), true_)

    if _present(table, *_GGX_LIKE):
        m = ggx_sample_vndf(wi_u, alpha, u2)
        wo_rc_u = reflect(wi_u, m)
        wo_rc = wo_rc_u * sign_i[..., None]
        m_pdf = ggx_vndf_pdf(wi_u, m, alpha)
        pdf_rc = m_pdf / jnp.maximum(
            4.0 * jnp.abs(jnp.sum(wo_rc_u * m, -1)), 1e-12
        )
        g2 = ggx_g2(wi_u, wo_rc_u, alpha)
        g1 = ggx_g1(wi_u, alpha)
        f_rc = fresnel_conductor(jnp.abs(jnp.sum(wi_u * m, -1)), eta, k)
        w_rc = spec_refl * f_rc * safe_div(g2, g1)[..., None]
        rc_valid = wo_rc_u[..., 2] > 0
        w_rc = jnp.where(rc_valid[..., None], w_rc, 0.0)
        pdf_rc = jnp.where(rc_valid, pdf_rc, 0.0)
        for kk in _GGX_LIKE:
            setk(kk, wo_rc, w_rc, pdf_rc, false_)

    if _present(table, *_PLASTIC_LIKE):
        eta_d = eta[..., 0]
        f_i, _, _ = fresnel_dielectric(jnp.abs(cos_i), eta_d)
        spec_prob = _plastic_specular_prob(f_i)
        pick_spec = uc < spec_prob
        wo_pl = jnp.where(pick_spec[..., None], wo_spec, wo_diff)
        f_o, _, _ = fresnel_dielectric(jnp.abs(wo_pl[..., 2]), eta_d)
        w_pl_spec = spec_refl * safe_div(f_i, spec_prob)[..., None]
        w_pl_diff = albedo_tex * safe_div(
            (1.0 - f_i) * (1.0 - f_o), 1.0 - spec_prob
        )[..., None]
        w_pl = jnp.where(pick_spec[..., None], w_pl_spec, w_pl_diff)
        pdf_pl = jnp.where(pick_spec, 0.0, (1.0 - spec_prob) * pdf_diff)
        for kk in _PLASTIC_LIKE:
            setk(kk, wo_pl, w_pl, pdf_pl, pick_spec)

    if _present(table, BSDF_ROUGH_DIFFUSE):
        # Oren-Nayar: cosine-hemisphere sampled; weight = f*cos/pdf
        wo_on = square_to_cosine_hemisphere(u2) * sign_i[..., None]
        val_on, pdf_on = _eval_core(table, mat_id, albedo_tex, wi, wo_on)
        w_on = val_on / jnp.maximum(pdf_on, 1e-12)[..., None]
        setk(BSDF_ROUGH_DIFFUSE, wo_on, w_on, pdf_on, false_)

    if _present(table, BSDF_DIFFTRANS):
        # cosine-sample the hemisphere OPPOSITE the incident side
        wo_dt = square_to_cosine_hemisphere(u2) * (-sign_i[..., None])
        pdf_dt = square_to_cosine_hemisphere_pdf(
            wo_dt * (-sign_i[..., None]))
        setk(BSDF_DIFFTRANS, wo_dt, albedo_tex, pdf_dt, false_)

    if _present(table, BSDF_HK):
        # component pick: Dirac straight-through with prob T0, else 50/50
        # cosine hemispheres weighted by eval/pdf
        sigma_t_hk = spec_refl + spec_trans
        tau_hk = sigma_t_hk * alpha[..., None]
        mu_i_hk = jnp.maximum(jnp.abs(cos_i), 1e-4)
        t0 = jnp.exp(-tau_hk / mu_i_hk[..., None])
        t0_mean = jnp.clip(jnp.mean(t0, -1), 1e-4, 1.0 - 1e-4)
        pick_delta = uc < t0_mean
        u_rest = (uc - t0_mean) / (1.0 - t0_mean)
        pick_refl = u_rest < 0.5
        wo_cos = square_to_cosine_hemisphere(u2)
        side = jnp.where(pick_refl, 1.0, -1.0) * sign_i
        wo_hk_s = wo_cos * side[..., None]
        val_hk, pdf_hk = _eval_core(table, mat_id, albedo_tex, wi, wo_hk_s)
        w_smooth = val_hk / jnp.maximum(pdf_hk, 1e-12)[..., None]
        wo_hk = jnp.where(pick_delta[..., None], -wi, wo_hk_s)
        w_hk = jnp.where(pick_delta[..., None],
                         t0 / t0_mean[..., None], w_smooth)
        pdf_out = jnp.where(pick_delta, 0.0, pdf_hk)
        setk(BSDF_HK, wo_hk, w_hk, pdf_out, pick_delta)

    if _present(table, BSDF_PHONG) or _present(table, BSDF_WARD):
        # mixture: diffuse cosine lobe vs specular lobe, picked by uc
        w_s = _phong_spec_weight(albedo_tex, spec_refl)
        pick_spec = uc < w_s
        wo_diff2 = square_to_cosine_hemisphere(u2) * sign_i[..., None]
        if _present(table, BSDF_PHONG):
            n_exp = _phong_exponent(alpha)
            # power-cosine around the mirror direction
            cos_l = u2[..., 0] ** (1.0 / (n_exp + 1.0))
            sin_l = jnp.sqrt(jnp.maximum(1 - cos_l * cos_l, 0.0))
            phi_l = 2 * jnp.pi * u2[..., 1]
            lobe = jnp.stack(
                [sin_l * jnp.cos(phi_l), sin_l * jnp.sin(phi_l), cos_l], -1
            )
            from drmlt_mitsuba.core import frame as _frame

            refl_u = jnp.stack(
                [-wi_u[..., 0], -wi_u[..., 1], wi_u[..., 2]], -1
            )
            wo_ph_u = _frame.to_world(refl_u, lobe)
            wo_ph = jnp.where(pick_spec[..., None],
                              wo_ph_u * sign_i[..., None], wo_diff2)
            val_ph, pdf_ph = _eval_core(table, mat_id, albedo_tex, wi, wo_ph)
            w_ph = val_ph / jnp.maximum(pdf_ph, 1e-12)[..., None]
            ok_ph = wo_ph[..., 2] * sign_i > 0
            setk(BSDF_PHONG, wo_ph,
                 jnp.where(ok_ph[..., None], w_ph, 0.0), pdf_ph, false_)
        if _present(table, BSDF_WARD):
            # sample the Ward half-vector: tan^2 = -a^2 ln u
            a2 = alpha * alpha
            t2 = -a2 * jnp.log(jnp.maximum(u2[..., 0], 1e-38))
            ct = 1.0 / jnp.sqrt(1.0 + t2)
            st = jnp.sqrt(jnp.maximum(1 - ct * ct, 0.0))
            phi_h = 2 * jnp.pi * u2[..., 1]
            hvec = jnp.stack(
                [st * jnp.cos(phi_h), st * jnp.sin(phi_h), ct], -1
            )
            wo_wd_u = reflect(wi_u, hvec)
            wo_wd = jnp.where(pick_spec[..., None],
                              wo_wd_u * sign_i[..., None], wo_diff2)
            val_wd, pdf_wd = _eval_core(table, mat_id, albedo_tex, wi, wo_wd)
            w_wd = val_wd / jnp.maximum(pdf_wd, 1e-12)[..., None]
            ok_wd = wo_wd[..., 2] * sign_i > 0
            setk(BSDF_WARD, wo_wd,
                 jnp.where(ok_wd[..., None], w_wd, 0.0), pdf_wd, false_)

    if _present(table, BSDF_ROUGH_DIELECTRIC):
        m = ggx_sample_vndf(wi_u, alpha, u2)
        i_dot_m = jnp.sum(wi_u * m, -1)
        eta_d = eta[..., 0]
        f_rd, _, _ = fresnel_dielectric(i_dot_m * sign_i, eta_d)
        pick_refl = uc < f_rd
        wo_refl_u = reflect(wi_u, m)
        # Snell refraction about m (Walter eq. 40), in the upper frame
        eta_rel = jnp.where(cos_i > 0, eta_d, 1.0 / eta_d)
        inv_eta = 1.0 / eta_rel
        c = i_dot_m
        under = 1.0 + inv_eta * inv_eta * (c * c - 1.0)
        tir = under < 0
        wo_refr_u = (
            (inv_eta * c - jnp.sqrt(jnp.maximum(under, 0.0)))[..., None] * m
            - inv_eta[..., None] * wi_u
        )
        wo_rd_u = jnp.where((pick_refl | tir)[..., None], wo_refl_u,
                            wo_refr_u)
        wo_rd = wo_rd_u * sign_i[..., None]
        _, pdf_rd = _eval_core(table, mat_id, albedo_tex, wi, wo_rd)
        # exact VNDF weight G2/G1 (independent of the single-branch pdf
        # approximation near the refraction fold; F and the discrete pick
        # cancel, transmission carries the radiance (1/eta)^2 scale)
        g2_rd = ggx_g2(wi_u, wo_rd_u, alpha)
        g1_rd = ggx_g1(wi_u, alpha)
        base_w = safe_div(g2_rd, g1_rd)[..., None]
        w_rd = jnp.where(
            (pick_refl | tir)[..., None], spec_refl * base_w,
            spec_trans * base_w / (eta_rel * eta_rel)[..., None],
        )
        ok_rd = jnp.abs(wo_rd_u[..., 2]) > 1e-6
        eta_rd = jnp.where(
            pick_refl | tir, 1.0,
            jnp.where(cos_i > 0, eta_d, 1.0 / eta_d),
        )
        setk(BSDF_ROUGH_DIELECTRIC, wo_rd,
             jnp.where(ok_rd[..., None], w_rd, 0.0), pdf_rd, false_,
             eta_rd)

    if _present(table, BSDF_NULL):
        setk(BSDF_NULL, -wi, jnp.ones(R3), jnp.zeros_like(pdf), true_)

    bad = jnp.abs(cos_i) < 1e-7
    weight = jnp.where(bad[..., None], 0.0, weight)
    return BsdfSample(wo=wo, weight=weight, pdf=pdf, delta=delta, eta=eta_out)


# ---------------------------------------------------------------------------
# Modifier wrappers (ref: src/bsdfs/{mask,mixturebsdf,blendbsdf,coating}.cpp)
#
# The reference nests modifier plugins around an inner BSDF object at scene
# load; the SoA equivalent is optional per-row modifier parameters on
# MaterialTable applied around the core lobes in a fixed order:
#     mask (outermost) -> smooth coating -> 2-way mixture -> core kind.
# Static has_* flags keep scenes without modifiers on the bare-core path
# (zero extra compiled code).  Modifier picks consume the component uniform
# u3[...,0] by successive range-rescaling, so the core still sees a uniform
# component draw and replay determinism is preserved.
# ---------------------------------------------------------------------------

def _gather_cols(mat_id, *fields):
    """Row-select modifier parameter columns (exact onehot matmul)."""
    from drmlt_mitsuba.ops.gather import onehot_gather, pack_rows

    return onehot_gather(pack_rows(*fields), mat_id)


def _mixture_params(table: MaterialTable, mat_id):
    row = _gather_cols(mat_id, table.mix_other, table.mix_weight)
    other = row[..., 0].astype(jnp.int32)
    w = jnp.where(other >= 0, jnp.clip(row[..., 1], 0.0, 1.0), 0.0)
    return jnp.maximum(other, 0), w


def _coating_params(table: MaterialTable, mat_id, cos_i):
    """(coated, Fresnel(wi), p_spec, eta, sigma_a) for the coating layer."""
    row = _gather_cols(mat_id, table.coat_eta, table.coat_sigma_a)
    ce, sig = row[..., 0], row[..., 1:4]
    coated = ce > 0
    e = jnp.where(coated, jnp.maximum(ce, 1.0 + 1e-4), 1.5)
    f_i, _, _ = fresnel_dielectric(cos_i, e)
    f_i = jnp.where(coated, f_i, 0.0)
    p_spec = jnp.where(coated, jnp.clip(f_i, 0.05, 0.95), 0.0)
    return coated, f_i, p_spec, e, sig


def _coat_absorb(coated, sig, cos_i, cos_o):
    """exp(-sigma_a * thickness * (sec wi + sec wo)) through the layer."""
    secs = 1.0 / jnp.maximum(jnp.abs(cos_i), 1e-4) + 1.0 / jnp.maximum(
        jnp.abs(cos_o), 1e-4
    )
    a = jnp.exp(-sig * secs[..., None])
    return jnp.where(coated[..., None], a, 1.0)


def _mixture_eval(table: MaterialTable, mat_id, albedo_tex, wi, wo):
    """Core eval with the mixture chain folded in (f and pdf blended).

    N-way mixtures are chains of 2-way links (row r = (1-w_r)*core(r) +
    w_r * mixture(other_r)); the static mix_depth bounds the unroll.
    Non-root components use their row's constant albedo (textures are
    supported on the root component only)."""
    v1, p1 = _eval_core(table, mat_id, albedo_tex, wi, wo)
    if not table.has_mixture:
        return v1, p1
    from drmlt_mitsuba.ops.gather import onehot_gather

    other, w = _mixture_params(table, mat_id)
    val = (1.0 - w)[..., None] * v1
    pdf = (1.0 - w) * p1
    scale, cur = w, other
    for _ in range(table.mix_depth):
        alb = onehot_gather(table.albedo, cur)
        v2, p2 = _eval_core(table, cur, alb, wi, wo)
        other, w = _mixture_params(table, cur)
        val = val + (scale * (1.0 - w))[..., None] * v2
        pdf = pdf + scale * (1.0 - w) * p2
        scale, cur = scale * w, other
    return val, pdf


def _irawan_flip(wi, wo):
    """Two-sided shading: mirror both directions into the upper hemisphere
    when the incident is below (the table's two_sided convention; the
    reference wraps irawan in a twosided adapter for the same effect)."""
    sign = jnp.where(wi[..., 2:3] < 0, -1.0, 1.0)
    flip = jnp.concatenate([jnp.ones_like(sign), jnp.ones_like(sign),
                            sign], -1)
    return wi * flip, wo * flip


def _irawan_overlay(table: MaterialTable, mat_id, irawan, uv, wi, wo, val):
    """Replace the diffuse fallback value with the full woven-cloth model
    on BSDF_IRAWAN lanes (sampling pdf stays the cosine density both ways,
    matching the reference's cosine sampler, irawan.cpp:330-360)."""
    from drmlt_mitsuba.render.irawan import irawan_eval

    kind = _mat(table, mat_id)[0]
    sel = kind == BSDF_IRAWAN
    wi_f, wo_f = _irawan_flip(wi, wo)
    f_ir = irawan_eval(irawan, uv, wi_f, wo_f)
    return jnp.where(sel[..., None], f_ir, val)


def eval_bsdf(table: MaterialTable, mat_id, albedo_tex, wi, wo,
              irawan=None, uv=None):
    """(f * |cos wo|, pdf) for non-delta lobes; (0, 0) for Dirac kinds.
    `irawan`/`uv` activate the woven-cloth overlay on BSDF_IRAWAN lanes."""
    if not (table.has_mask or table.has_mixture or table.has_coating):
        val, pdf = _eval_core(table, mat_id, albedo_tex, wi, wo)
        if irawan is not None and uv is not None \
                and _present(table, BSDF_IRAWAN):
            val = _irawan_overlay(table, mat_id, irawan, uv, wi, wo, val)
        return val, pdf
    val, pdf = _mixture_eval(table, mat_id, albedo_tex, wi, wo)
    if irawan is not None and uv is not None \
            and _present(table, BSDF_IRAWAN):
        val = _irawan_overlay(table, mat_id, irawan, uv, wi, wo, val)
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    if table.has_coating:
        coated, f_i, p_spec, e, sig = _coating_params(table, mat_id, cos_i)
        f_o, _, _ = fresnel_dielectric(cos_o, e)
        f_o = jnp.where(coated, f_o, 0.0)
        val = val * ((1.0 - f_i) * (1.0 - f_o))[..., None]
        val = val * _coat_absorb(coated, sig, cos_i, cos_o)
        pdf = (1.0 - p_spec) * pdf
    if table.has_mask:
        from drmlt_mitsuba.ops.gather import onehot_gather

        opac = onehot_gather(table.opacity, mat_id)
        p_keep = jnp.clip(jnp.mean(opac, -1), 0.0, 1.0)
        val = val * opac
        pdf = pdf * p_keep
    return val, pdf


def _irawan_sample_overlay(table, mat_id, irawan, uv, wi, s: BsdfSample):
    """Fix up the cosine-sampled diffuse lanes: weight = f_ir / pdf."""
    from drmlt_mitsuba.render.irawan import irawan_eval

    kind = _mat(table, mat_id)[0]
    sel = (kind == BSDF_IRAWAN) & ~s.delta
    wi_f, wo_f = _irawan_flip(wi, s.wo)
    f_ir = irawan_eval(irawan, uv, wi_f, wo_f)
    w_ir = f_ir / jnp.maximum(s.pdf, 1e-9)[..., None]
    return s.replace(weight=jnp.where(sel[..., None], w_ir, s.weight))


def sample_bsdf(table: MaterialTable, mat_id, albedo_tex, wi, u3,
                irawan=None, uv=None) -> BsdfSample:
    """Sample wo from the BSDF; u3 = (component, u, v) uniforms (R, 3).
    `irawan`/`uv` activate the woven-cloth overlay on BSDF_IRAWAN lanes."""
    if not (table.has_mask or table.has_mixture or table.has_coating):
        s = _sample_core(table, mat_id, albedo_tex, wi, u3)
        if irawan is not None and uv is not None \
                and _present(table, BSDF_IRAWAN):
            s = _irawan_sample_overlay(table, mat_id, irawan, uv, wi, s)
        return s
    from drmlt_mitsuba.ops.gather import onehot_gather

    uc = u3[..., 0]
    cos_i = wi[..., 2]

    if table.has_mask:
        opac = onehot_gather(table.opacity, mat_id)
        p_keep = jnp.clip(jnp.mean(opac, -1), 0.0, 1.0)
        pick_null = uc >= p_keep
        uc = jnp.where(pick_null, safe_div(uc - p_keep, 1.0 - p_keep),
                       safe_div(uc, jnp.maximum(p_keep, 1e-6)))
    if table.has_coating:
        coated, f_i, p_spec, e, sig = _coating_params(table, mat_id, cos_i)
        pick_spec = uc < p_spec
        uc = jnp.where(pick_spec, uc, safe_div(uc - p_spec, 1.0 - p_spec))
    if table.has_mixture:
        # walk the mixture chain: at each link either settle on the link's
        # own core lobes (prob 1-w) or descend to `other`
        wmix_root = _mixture_params(table, mat_id)[1]
        cur = mat_id
        done = jnp.zeros(uc.shape, bool)
        for _ in range(table.mix_depth + 1):
            other, w = _mixture_params(table, cur)
            pick = (~done) & (uc < w)
            uc = jnp.where(
                pick, safe_div(uc, jnp.maximum(w, 1e-6)),
                jnp.where(done, uc,
                          safe_div(uc - w, jnp.maximum(1.0 - w, 1e-6))),
            )
            done = done | ~pick
            cur = jnp.where(pick, other, cur)
        mat_eff = cur
        alb_eff = jnp.where((cur == mat_id)[..., None], albedo_tex,
                            onehot_gather(table.albedo, cur))
    else:
        mat_eff, alb_eff = mat_id, albedo_tex

    u3n = jnp.stack([jnp.clip(uc, 0.0, 1.0 - 1e-7), u3[..., 1], u3[..., 2]],
                    -1)
    s = _sample_core(table, mat_eff, alb_eff, wi, u3n)
    wo, weight, pdf = s.wo, s.weight, s.pdf
    delta, eta_out = s.delta, s.eta

    if table.has_mixture:
        # one-sample MIS over the two components for non-delta picks; a
        # Dirac pick keeps the core weight (component weight / pick
        # probability cancels exactly since they are equal)
        v_mix, p_mix = _mixture_eval(table, mat_id, albedo_tex, wi, wo)
        lane_mix = wmix_root > 0
        use_nd = lane_mix & ~delta
        w_nd = v_mix / jnp.maximum(p_mix, 1e-12)[..., None]
        weight = jnp.where(use_nd[..., None], w_nd, weight)
        pdf = jnp.where(use_nd, p_mix, pdf)

    if table.has_coating:
        cos_o = wo[..., 2]
        f_o, _, _ = fresnel_dielectric(cos_o, e)
        f_o = jnp.where(coated, f_o, 0.0)
        scale = safe_div((1.0 - f_i) * (1.0 - f_o), 1.0 - p_spec, 1.0)
        scale = jnp.where(coated, scale, 1.0)
        weight = weight * scale[..., None] * _coat_absorb(
            coated, sig, cos_i, cos_o
        )
        pdf = jnp.where(coated, (1.0 - p_spec) * pdf, pdf)
        # specular coat lobe: perfect mirror with reflectance F(wi);
        # weight = F / p_spec
        wo_spec = jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)
        w_spec = safe_div(f_i, p_spec)[..., None] * jnp.ones_like(weight)
        wo = jnp.where(pick_spec[..., None], wo_spec, wo)
        weight = jnp.where(pick_spec[..., None], w_spec, weight)
        pdf = jnp.where(pick_spec, 0.0, pdf)
        delta = jnp.where(pick_spec, True, delta)
        eta_out = jnp.where(pick_spec, 1.0, eta_out)

    if table.has_mask:
        # null passthrough lobe carries (1 - opacity) / P(pick null)
        w_null = (1.0 - opac) * safe_div(
            1.0, 1.0 - p_keep, 0.0
        )[..., None]
        w_kept = weight * opac * safe_div(
            1.0, p_keep, 0.0
        )[..., None]
        wo = jnp.where(pick_null[..., None], -wi, wo)
        weight = jnp.where(pick_null[..., None], w_null, w_kept)
        pdf = jnp.where(pick_null, 0.0, pdf * p_keep)
        delta = jnp.where(pick_null, True, delta)
        eta_out = jnp.where(pick_null, 1.0, eta_out)

    s = BsdfSample(wo=wo, weight=weight, pdf=pdf, delta=delta,
                   eta=eta_out)
    if irawan is not None and uv is not None \
            and _present(table, BSDF_IRAWAN):
        s = _irawan_sample_overlay(table, mat_id, irawan, uv, wi, s)
    return s


def is_delta_kind(table: MaterialTable, mat_id):
    """True for materials whose every lobe is Dirac (no NEE contribution).

    Modifier-aware: a mask's null lobe and a coating's specular lobe are
    Dirac, so neither changes the answer; a 2-way mixture is all-Dirac only
    if BOTH components are."""
    kind = _mat(table, mat_id)[0]

    def kind_delta(k):
        out = jnp.zeros(k.shape, bool)
        for kk in DELTA_KINDS:
            if _present(table, kk):
                out = out | (k == kk)
        return out

    out = kind_delta(kind)
    if table.has_mixture:
        cur = mat_id
        for _ in range(table.mix_depth + 1):
            other, w = _mixture_params(table, cur)
            kind2 = _mat(table, other)[0]
            out = out & ((w <= 0) | kind_delta(kind2))
            cur = other
    return out
