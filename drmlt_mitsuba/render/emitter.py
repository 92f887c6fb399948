"""Emitter sampling and evaluation (ref: Scene::sampleEmitterDirect /
pdfEmitterDirect, src/librender/scene.cpp; src/emitters/{area,point,spot,
directional,constant}.cpp).

Direct sampling consumes 3 uniforms: emitter pick + 2D surface sample.
Delta rows (point/spot/directional) return delta=True — their pick pdf is
discrete, the NEE MIS weight is 1, and BSDF sampling never hits them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from drmlt_mitsuba.core import struct
from drmlt_mitsuba.core.math import normalize, safe_div
from drmlt_mitsuba.core.warp import square_to_uniform_triangle
from drmlt_mitsuba.scene.types import (
    EMITTER_AREA, EMITTER_DIRECTIONAL, EMITTER_ENV, EMITTER_POINT,
    EMITTER_SPOT, Scene,
)

_DIR_DIST = 1.0e7   # pseudo-distance for directional/env shadow rays


def env_uv_to_dir(uv):
    """Lat-long (u, v) in [0,1)^2 -> world direction (Mitsuba Y-up)."""
    theta = uv[..., 1] * jnp.pi
    phi = (uv[..., 0] * 2.0 - 1.0) * jnp.pi
    st = jnp.sin(theta)
    return jnp.stack(
        [st * jnp.sin(phi), jnp.cos(theta), -st * jnp.cos(phi)], axis=-1
    )


def env_dir_to_uv(d):
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 0], -d[..., 2])
    return jnp.stack(
        [(phi / jnp.pi + 1.0) * 0.5, theta / jnp.pi], axis=-1
    )


def env_lookup(em, d):
    """Bilinear lat-long lookup of the environment image."""
    img = em.env_image
    he, we = img.shape[:2]
    uv = env_dir_to_uv(d)
    x = jnp.clip(uv[..., 0], 0.0, 1.0 - 1e-6) * we - 0.5
    y = jnp.clip(uv[..., 1], 0.0, 1.0 - 1e-6) * he - 0.5
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, we - 1)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, he - 1)
    x1 = (x0 + 1) % we
    y1 = jnp.minimum(y0 + 1, he - 1)
    fx = jnp.clip(x - x0, 0, 1)[..., None]
    fy = jnp.clip(y - y0, 0, 1)[..., None]
    return ((img[y0, x0] * (1 - fx) + img[y0, x1] * fx) * (1 - fy)
            + (img[y1, x0] * (1 - fx) + img[y1, x1] * fx) * fy)


def env_pdf_dir(scene: Scene, d):
    """Solid-angle pdf of env NEE sampling for direction d (0 when no
    image env); includes the emitter-row pick probability."""
    em = scene.emitters
    if em.env_image is None:
        return jnp.zeros(d.shape[:-1])
    he, we = em.env_pmf.shape
    uv = env_dir_to_uv(d)
    x = jnp.clip((uv[..., 0] * we).astype(jnp.int32), 0, we - 1)
    y = jnp.clip((uv[..., 1] * he).astype(jnp.int32), 0, he - 1)
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    sin_t = jnp.maximum(jnp.sin(theta), 1e-6)
    pdf_pix = em.env_pmf[y, x]
    pdf_sa = pdf_pix * (he * we) / (2.0 * jnp.pi * jnp.pi * sin_t)
    env_row_pick = jnp.sum(
        jnp.where(em.kind == EMITTER_ENV, em.pmf, 0.0)
    )
    return pdf_sa * env_row_pick


@struct.dataclass
class DirectSample:
    """A sampled connection toward an emitter from a reference point."""
    d: jnp.ndarray          # (R, 3) unit direction ref -> emitter
    dist: jnp.ndarray       # (R,)
    radiance: jnp.ndarray   # (R, 3) incident radiance factor: the NEE
    #                          contribution is f * radiance * w / pdf
    pdf: jnp.ndarray        # (R,) solid-angle (area rows) or discrete pdf
    delta: jnp.ndarray      # (R,) bool: delta emitter (MIS weight 1)
    n: jnp.ndarray          # (R, 3) emitter surface normal (area rows)


def sample_emitter_direct(scene: Scene, p_ref, u3) -> DirectSample:
    """Sample a direct connection; u3 = (pick, u, v) in (R, 3)."""
    from drmlt_mitsuba.ops.gather import onehot_gather, pack_rows

    em = scene.emitters
    tris = scene.tris
    row = jnp.searchsorted(em.cdf, u3[..., 0], side="right")
    row = jnp.clip(row, 0, em.cdf.shape[0] - 1).astype(jnp.int32)
    packed = pack_rows(em.kind, em.tri_idx, em.radiance, em.area, em.pos,
                       em.aux, em.pmf)
    erow = onehot_gather(packed, row)
    kind = erow[..., 0].astype(jnp.int32)
    ti = erow[..., 1].astype(jnp.int32)
    e_rad = erow[..., 2:5]
    e_area = erow[..., 5]
    e_pos = erow[..., 6:9]
    e_aux = erow[..., 9:13]
    pmf = erow[..., 13]

    # ---- area rows --------------------------------------------------------
    tri_pack = pack_rows(tris.v0, tris.e1, tris.e2)
    trow = onehot_gather(tri_pack, ti)
    tv0, te1, te2 = trow[..., 0:3], trow[..., 3:6], trow[..., 6:9]
    b = square_to_uniform_triangle(u3[..., 1:3])
    p_l = tv0 + b[..., 0:1] * te1 + b[..., 1:2] * te2
    n_l = normalize(jnp.cross(te1, te2))
    to_l = p_l - p_ref
    dist2_a = jnp.sum(to_l * to_l, axis=-1)
    dist_a = jnp.sqrt(jnp.maximum(dist2_a, 1e-20))
    d_a = to_l / dist_a[..., None]
    cos_l = -jnp.sum(d_a * n_l, axis=-1)
    vis_a = cos_l > 1e-7
    pdf_a = safe_div(pmf * dist2_a, cos_l * e_area)
    rad_a = e_rad

    # ---- point / spot rows ------------------------------------------------
    to_p = e_pos - p_ref
    dist2_p = jnp.sum(to_p * to_p, axis=-1)
    dist_p = jnp.sqrt(jnp.maximum(dist2_p, 1e-20))
    d_p = to_p / dist_p[..., None]
    # clamp at 1e-12, not 1e-20: the quotient rule's 1/x^2 at the clamp
    # must stay below f32 max or reverse-mode produces masked inf -> NaN
    rad_p = e_rad / jnp.maximum(dist2_p, 1e-12)[..., None]
    # spot falloff: smooth quadratic ramp inside the cone (ref spot.cpp
    # falloff simplified to hard cutoff + cosine ramp)
    axis = e_aux[..., :3]
    cos_cut = e_aux[..., 3]
    cos_spot = -jnp.sum(d_p * axis, axis=-1)
    # smooth falloff between beamWidth (0.75 * cutoff angle, the
    # reference default) and the cutoff (ref: spot.cpp falloffCurve)
    cos_beam = jnp.cos(jnp.arccos(jnp.clip(cos_cut, -1, 1)) * 0.75)
    t_spot = safe_div(cos_spot - cos_cut, cos_beam - cos_cut)
    spot_f = jnp.clip(t_spot, 0.0, 1.0)
    spot_f = jnp.where(cos_spot >= cos_beam, 1.0, spot_f)
    rad_spot = rad_p * spot_f[..., None]

    # ---- directional rows -------------------------------------------------
    d_dir = -e_pos   # pos stores the direction TOWARD the scene
    rad_dir = e_rad

    # ---- environment rows (image importance sampling) ---------------------
    if em.env_image is not None:
        he, we = em.env_pmf.shape
        y = jnp.searchsorted(em.env_row_cdf, u3[..., 1], side="right")
        y = jnp.clip(y, 0, he - 1)
        x = jax.vmap(
            lambda row_cdf, uu: jnp.searchsorted(row_cdf, uu, side="right")
        )(em.env_col_cdf[y], u3[..., 2])
        x = jnp.clip(x, 0, we - 1)
        # reuse the cdf-inversion residuals as exact within-pixel jitter so
        # the sampling is continuous (matches the bilinear-filtered
        # radiance the escape path evaluates)
        row_lo = jnp.where(y > 0, em.env_row_cdf[jnp.maximum(y - 1, 0)], 0.0)
        row_hi = em.env_row_cdf[y]
        ju = jnp.clip((u3[..., 1] - row_lo)
                      / jnp.maximum(row_hi - row_lo, 1e-12), 0.0, 1.0 - 1e-6)
        col_lo = jnp.where(
            x > 0,
            em.env_col_cdf[y, jnp.maximum(x - 1, 0)], 0.0,
        )
        col_hi = em.env_col_cdf[y, x]
        jv = jnp.clip((u3[..., 2] - col_lo)
                      / jnp.maximum(col_hi - col_lo, 1e-12), 0.0, 1.0 - 1e-6)
        uv_env = jnp.stack(
            [(x.astype(jnp.float32) + jv) / we,
             (y.astype(jnp.float32) + ju) / he], axis=-1,
        )
        d_env = env_uv_to_dir(uv_env)
        theta_env = uv_env[..., 1] * jnp.pi
        sin_t = jnp.maximum(jnp.sin(theta_env), 1e-6)
        pdf_env = em.env_pmf[y, x] * (he * we) / (
            2.0 * jnp.pi * jnp.pi * sin_t
        )
        rad_env = env_lookup(em, d_env)
    else:
        d_env = d_dir
        pdf_env = jnp.ones_like(pmf)
        rad_env = e_rad

    is_area = kind == EMITTER_AREA
    is_point = kind == EMITTER_POINT
    is_spot = kind == EMITTER_SPOT
    is_dir = kind == EMITTER_DIRECTIONAL
    is_env = kind == EMITTER_ENV

    d = jnp.where(is_area[..., None], d_a,
                  jnp.where(is_dir[..., None], d_dir,
                            jnp.where(is_env[..., None], d_env, d_p)))
    dist = jnp.where(is_area, dist_a,
                     jnp.where(is_dir | is_env, _DIR_DIST, dist_p))
    radiance = jnp.where(
        is_area[..., None], jnp.where(vis_a[..., None], rad_a, 0.0),
        jnp.where(is_point[..., None], rad_p,
                  jnp.where(is_spot[..., None], rad_spot,
                            jnp.where(is_env[..., None], rad_env, rad_dir))),
    )
    # env rows use a solid-angle pdf (pick pmf x pixel pdf) and ARE subject
    # to BSDF-sampling MIS (the BSDF can hit the env); others are delta
    pdf = jnp.where(is_area, jnp.where(vis_a, pdf_a, 0.0),
                    jnp.where(is_env, pmf * pdf_env, pmf))
    delta = ~is_area & ~is_env
    return DirectSample(d=d, dist=dist, radiance=radiance, pdf=pdf,
                        delta=delta, n=n_l)


def pdf_emitter_direct(scene: Scene, p_ref, hit_emitter_id, hit_p, hit_n):
    """Solid-angle pdf of sample_emitter_direct for the surface point a
    BSDF-sampled ray hit (area rows only — delta rows are unreachable)."""
    em = scene.emitters
    row = jnp.clip(hit_emitter_id, 0, em.pmf.shape[0] - 1)
    to_l = hit_p - p_ref
    dist2 = jnp.sum(to_l * to_l, axis=-1)
    d = to_l / jnp.sqrt(jnp.maximum(dist2, 1e-20))[..., None]
    cos_l = -jnp.sum(d * hit_n, axis=-1)
    pdf = safe_div(em.pmf[row] * dist2, cos_l * em.area[row])
    ok = (hit_emitter_id >= 0) & (cos_l > 0) & (em.kind[row] == EMITTER_AREA)
    return jnp.where(ok, pdf, 0.0)


def eval_emitter(scene: Scene, hit_emitter_id, wi_world, hit_ng):
    """Radiance emitted toward -wi_world by the area emitter a ray hit."""
    em = scene.emitters
    row = jnp.clip(hit_emitter_id, 0, em.radiance.shape[0] - 1)
    front = jnp.sum(wi_world * hit_ng, axis=-1) > 0
    ok = (hit_emitter_id >= 0) & front & (em.kind[row] == EMITTER_AREA)
    return jnp.where(ok[..., None], em.radiance[row], 0.0)


def eval_env(scene: Scene, d_world):
    """Environment radiance for escaped rays (constant or image env)."""
    em = scene.emitters
    if em.env_image is not None:
        return env_lookup(em, d_world)
    return jnp.broadcast_to(em.env_radiance, d_world.shape)
