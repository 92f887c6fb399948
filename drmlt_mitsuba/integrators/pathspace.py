"""Veach path-space MLT: mutations over explicit vertex paths.

Reference: src/libbidir/mut_bidir.cpp (bidirectional mutation),
mut_lens.cpp (lens perturbation), mut_caustic.cpp (caustic perturbation),
driven by src/integrators/mlt/mlt_proc.cpp:90-260.  This module is the
batched reformulation: a path is a fixed-slot SoA tensor over chains
(vertex 0 = pinhole camera, vertex k[c] = emitter-surface point), and
each mutation is one masked SIMD step over the whole chain batch.

Structural deviations from the reference (all semantics-preserving for
the stationary distribution):
  * Mutator selection cycles deterministically per step (bidir, lens,
    bidir, caustic) instead of per-path suitability sampling — a
    composition of MH kernels, each in detailed balance.  Lanes whose
    structure fails a mutator's preconditions reject (identity move).
  * Supernodes are implicit: the camera vertex is the fixed pinhole
    position; "deleting the emitter sample vertex" is an anchor at
    m = k+1 whose light-side walk begins with a fresh emitter-position
    sample.  Connections AT the supernode (s = 0 there) are excluded
    from the proposal support — and, consistently, from pmf and Q — so
    detailed balance is unaffected.
  * The multi-chain and manifold perturbations stay descoped (PARITY
    §2.3 carries the measured manifold evidence); the lens + caustic +
    bidirectional trio is the classic Veach set (mlt_proc.cpp:96-107).

Acceptance math:
  * bidirectional: a = Q(y->x)/Q(x->y),
    Q(x->y) = pmf(record) * sum_s 1/lum(weight_s(y)), where weight_s is
    the product of per-vertex sampling weights (f cos / pdf; Dirac pairs
    cancel to the delta component weight) over the replacement region
    generated with s light-side steps, times the connection contribution
    (the cached-weight form of mut_bidir.cpp:221-268).  Retained factors
    are common to x, y and all s, so they cancel and are omitted.
  * lens/caustic: the screen/cone perturbation density is symmetric, so
    a = lum(W(y))/lum(W(x)) with W = retrace-chain sampling weights x the
    re-connection contribution (mut_lens.cpp:177-205).

Scene subset (mlt_eligible): triangles with FLAT shading (ns == ng; the
shading-normal transport-asymmetry corrections are not implemented),
area emitters, pinhole perspective, any surface BSDF including delta
kinds, no media.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.core import struct
from drmlt_mitsuba.core import frame
from drmlt_mitsuba.core.math import safe_div
from drmlt_mitsuba.core.spectrum import luminance
from drmlt_mitsuba.integrators.bidir import sensor_importance
from drmlt_mitsuba.ops.intersect import intersect, occluded
from drmlt_mitsuba.render.bsdf import (
    eval_bsdf, is_delta_kind, sample_bsdf,
)
from drmlt_mitsuba.scene.types import CAMERA_PERSPECTIVE, EMITTER_AREA, Scene

RAY_EPS = 1e-4


# ---------------------------------------------------------------- state
@struct.dataclass
class PathState:
    """C paths with V = kmax+1 vertex slots.  Slot 0 = camera pinhole;
    slot k[c] = emitter point; slots > k[c] inactive."""
    pos: jnp.ndarray   # (C, V, 3)
    ng: jnp.ndarray    # (C, V, 3)  (flat shading: ns == ng)
    mat: jnp.ndarray   # (C, V) int32, -1 at endpoints
    em: jnp.ndarray    # (C,) emitter row of the light vertex
    k: jnp.ndarray     # (C,) edge count in [2, kmax]


@dataclasses.dataclass(frozen=True)
class MLTConfig:
    max_depth: int = 5             # kmax (edges camera..light)
    kmin: int = 2
    n_chains: int = 8192
    n_bootstrap: int = 65536
    lens_r1: float = 0.1           # min screen jump (fraction of 0.05-area)
    lens_frac: float = 0.05        # coveredArea (mlt_proc.cpp:88)
    caustic_t1: float = 0.0001     # cone perturbation angles (radians);
    caustic_t2: float = 0.1        # mirrors theta = atan(r / filmDist)


def mlt_eligible(scene: Scene) -> bool:
    try:
        if scene.medium is not None or getattr(scene, "media", None):
            return False
        if scene.camera.kind != CAMERA_PERSPECTIVE:
            return False
        if float(np.asarray(scene.camera.aperture_radius)) > 0:
            return False
        em = scene.emitters
        if em.env_image is not None:
            return False
        if float(np.abs(np.asarray(em.env_radiance)).sum()) > 0:
            return False
        if not bool(np.all(np.asarray(em.kind) == EMITTER_AREA)):
            return False
        # spheres are fine as PATH vertices: intersect() returns their
        # exact analytic normal (ns == ng pointwise, so no shading-normal
        # transport asymmetry) and every weight/mutator consumes only the
        # stored (pos, ng, mat).  Only sphere EMITTERS are out: the light
        # vertex anchor samples emitters.tri_idx triangles (ref:
        # src/libbidir/vertex.cpp:37-350 is shape-generic; our emitter
        # anchor is triangle-only).
        sph_valid = np.asarray(scene.spheres.valid)
        if bool(np.any(sph_valid
                       & (np.asarray(scene.spheres.emitter_id) >= 0))):
            return False
        # flat shading required for TRIANGLES (ns == ng)
        tris = scene.tris
        ng = np.cross(np.asarray(tris.e1), np.asarray(tris.e2))
        ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
        for n in (tris.n0, tris.n1, tris.n2):
            if np.abs(np.abs((np.asarray(n) * ng).sum(-1)) - 1).max() > 1e-3:
                return False
        return True
    except Exception:
        return False


# ------------------------------------------------------------- helpers
def _dirto(a, b):
    d = b - a
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, -1), 1e-20))
    return d / dist[..., None], dist


def _gslot(arr, idx):
    """arr (C, V, ...) -> per-chain slot idx (C,)."""
    V = arr.shape[1]
    oh = jax.nn.one_hot(jnp.clip(idx, 0, V - 1), V, dtype=arr.dtype)
    if arr.ndim == 3:
        return jnp.einsum("cv,cvd->cd", oh, arr,
                          precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(oh * arr.astype(oh.dtype), axis=1).astype(arr.dtype)


def _vw(scene, mat_id, ng, wi, wo):
    """Post-hoc sampling weight at a surface vertex: f(wi,wo)|cos wo|/pdf
    for smooth kinds; the deterministic component weight for delta kinds
    when wo matches it (the reference's cached vertex weight)."""
    wi_l = frame.to_local(ng, wi)
    wo_l = frame.to_local(ng, wo)
    albedo = scene.materials.albedo[jnp.clip(mat_id, 0, None)]
    fcos, pdf = eval_bsdf(scene.materials, mat_id, albedo, wi_l, wo_l)
    w_smooth = fcos * safe_div(1.0, pdf)[..., None]

    same_side = (wi_l[..., 2] * wo_l[..., 2]) > 0
    uc = jnp.where(same_side, 0.0, 0.999)
    u3 = jnp.stack([uc, jnp.full_like(uc, 0.5), jnp.full_like(uc, 0.5)], -1)
    bs = sample_bsdf(scene.materials, mat_id, albedo, wi_l, u3)
    match = jnp.sum(bs.wo * wo_l, -1) > 1.0 - 1e-5
    w_delta = jnp.where(match[..., None], bs.weight, 0.0)

    delta = is_delta_kind(scene.materials, mat_id)
    ok = mat_id >= 0
    return jnp.where((delta & ok)[..., None], w_delta,
                     jnp.where(ok[..., None], w_smooth, 0.0))


def _f_raw(scene, mat_id, ng, wi, wo):
    """Raw BSDF value x |cos wo| (0 for delta kinds)."""
    wi_l = frame.to_local(ng, wi)
    wo_l = frame.to_local(ng, wo)
    albedo = scene.materials.albedo[jnp.clip(mat_id, 0, None)]
    fcos, _ = eval_bsdf(scene.materials, mat_id, albedo, wi_l, wo_l)
    return jnp.where((mat_id >= 0)[..., None], fcos, 0.0)


def _emit_Le(scene, row):
    em = scene.emitters
    r = jnp.clip(row, 0, em.radiance.shape[0] - 1)
    return jnp.where((row >= 0)[:, None], em.radiance[r], 0.0)


def _emit_pos_pdf(scene, row):
    em = scene.emitters
    r = jnp.clip(row, 0, em.area.shape[0] - 1)
    return jnp.where(row >= 0,
                     safe_div(em.pmf[r], em.area[r]), 0.0)


def _is_delta_v(scene, ps, i):
    """Vertex slot i is a delta-BSDF surface vertex."""
    return is_delta_kind(scene.materials, ps.mat[:, i]) & (ps.mat[:, i] >= 0)


# ------------------------------------------------------------ evaluation
def eval_path(scene: Scene, ps: PathState, kmax: int):
    """Area-measure contribution (value, lum, pixel_uv, inside).

    Delta vertices contribute their component weight with the adjoining
    Dirac pdf canceled — the same convention the mutation weights use, so
    every ratio the chain consumes is measure-consistent."""
    C, V = ps.mat.shape
    d01, dist01 = _dirto(ps.pos[:, 0], ps.pos[:, 1])
    imp, pix, inside = sensor_importance(scene.camera, d01)
    cos_c = jnp.abs(jnp.sum(d01 * ps.ng[:, 0], -1))
    cos_1 = jnp.abs(jnp.sum(d01 * ps.ng[:, 1], -1))
    val = (imp * cos_c * safe_div(cos_1, dist01 * dist01))[:, None] \
        * jnp.ones((C, 3))

    for i in range(1, kmax):
        nxt = min(i + 1, V - 1)
        inrange = i < ps.k
        wi, _ = _dirto(ps.pos[:, i], ps.pos[:, i - 1])
        wo, dist = _dirto(ps.pos[:, i], ps.pos[:, nxt])
        delta = _is_delta_v(scene, ps, i)
        # smooth: f|cos| at this vertex + far cosine / d^2
        f_s = _f_raw(scene, ps.mat[:, i], ps.ng[:, i], wi, wo)
        # delta: component weight, Dirac cancels this edge's d^2/cos pair
        w_d = _vw(scene, ps.mat[:, i], ps.ng[:, i], wi, wo)
        cos_far = jnp.abs(jnp.sum(wo * ps.ng[:, nxt], -1))
        g = safe_div(cos_far, dist * dist)
        fac = jnp.where(delta[:, None], w_d, f_s * g[:, None])
        val = jnp.where(inrange[:, None], val * fac, val)

    lpos = _gslot(ps.pos, ps.k)
    lng = _gslot(ps.ng, ps.k)
    prev = _gslot(ps.pos, ps.k - 1)
    w_out, _ = _dirto(lpos, prev)
    front = jnp.sum(w_out * lng, -1) > 0
    val = val * _emit_Le(scene, ps.em) * jnp.where(front, 1.0, 0.0)[:, None]
    ok = inside & front & (ps.k >= 2)
    val = jnp.where(ok[:, None], val, 0.0)
    return val, luminance(val), pix, ok


# -------------------------------------------------- two-tailed geometric
def _two_tailed_cdf_sample(u, center, lo, hi, support):
    """Sample the base-2 two-tailed geometric on [lo, hi] centered at
    `center` (TwoTailedGeoDistr(2) of mut_bidir.cpp).  support: static
    int array of candidate values.  Returns (value, pmf_fn) where
    pmf_fn(v) gives the normalized pmf of any v."""
    sup = jnp.asarray(support, jnp.float32)[None, :]         # (1, S)
    w = 2.0 ** (-jnp.abs(sup - center[:, None]))
    w = jnp.where((sup >= lo[:, None]) & (sup <= hi[:, None]), w, 0.0)
    tot = jnp.sum(w, -1)
    cdf = jnp.cumsum(w, -1)
    pick = u[:, None] * tot[:, None]
    idx = jnp.sum((cdf < pick).astype(jnp.int32), -1)
    idx = jnp.clip(idx, 0, len(support) - 1)
    value = jnp.asarray(support)[idx]

    def pmf(v):
        wv = 2.0 ** (-jnp.abs(v.astype(jnp.float32) - center))
        ok = (v >= lo) & (v <= hi) & (tot > 0)
        return jnp.where(ok, safe_div(wv, tot), 0.0)

    return value, pmf, tot > 0


# ---------------------------------------------------------------- walks
def _bsdf_dir_sample(scene, key, mat_id, ng, wi):
    u3 = jax.random.uniform(key, wi.shape[:-1] + (3,))
    wi_l = frame.to_local(ng, wi)
    albedo = scene.materials.albedo[jnp.clip(mat_id, 0, None)]
    bs = sample_bsdf(scene.materials, mat_id, albedo, wi_l, u3)
    wo = frame.to_world(ng, bs.wo)
    ok = (mat_id >= 0) & ((bs.pdf > 0) | bs.delta) \
        & (luminance(bs.weight) > 0)
    return wo, bs.weight, ok


def _extend_walk(scene, key, p0, ng0, mat0, wi0, first_kind, em_dir_ng,
                 n_steps, max_steps, cam_pix_key=None):
    """Masked walk of up to max_steps vertices from an anchor.

    first_kind: 0 = BSDF step from the anchor surface vertex;
                1 = camera-direction step (fresh pixel sample);
                2 = emitter-position step (fresh light sample);
                3 = emission-direction step (cosine lobe around em_dir_ng).
    Returns dict with (C, max_steps) vertex arrays + per-step sampling
    weights (the f cos/pdf products that enter weight_s) + validity.
    """
    C = p0.shape[0]
    out = dict(
        pos=jnp.zeros((C, max_steps, 3)), ng=jnp.zeros((C, max_steps, 3)),
        mat=jnp.full((C, max_steps), -1, jnp.int32),
        em=jnp.full((C, max_steps), -1, jnp.int32),
        w=jnp.zeros((C, max_steps, 3)), valid=jnp.zeros((C, max_steps),
                                                        bool),
    )
    p, ng, mat, wi = p0, ng0, mat0, wi0
    active = n_steps > 0
    emitters = scene.emitters

    for j in range(max_steps):
        kj = jax.random.fold_in(key, j)
        if j == 0:
            # endpoint-aware first step
            k1, k2 = jax.random.split(kj)
            # (a) fresh emitter position (first_kind == 2)
            u3 = jax.random.uniform(k1, (C, 3))
            row = jnp.clip(
                jnp.searchsorted(emitters.cdf, u3[:, 0]), 0,
                emitters.cdf.shape[0] - 1).astype(jnp.int32)
            ti = jnp.clip(emitters.tri_idx[row], 0,
                          scene.tris.v0.shape[0] - 1)
            tw = jnp.sqrt(jnp.maximum(1.0 - u3[:, 1], 0.0))
            b0 = 1.0 - tw
            b1 = tw * u3[:, 2]
            e_pos = (scene.tris.v0[ti] + b0[:, None] * scene.tris.e1[ti]
                     + b1[:, None] * scene.tris.e2[ti])
            e_ng = jnp.cross(scene.tris.e1[ti], scene.tris.e2[ti])
            e_ng = e_ng / jnp.maximum(
                jnp.linalg.norm(e_ng, axis=-1, keepdims=True), 1e-20)
            w_pos = _emit_Le(scene, row) * safe_div(
                1.0, _emit_pos_pdf(scene, row))[:, None]
            if first_kind == 2:
                step_valid = active & (luminance(w_pos) > 0)
                out = _store(out, j, e_pos, e_ng,
                             jnp.full((C,), -1, jnp.int32), row, w_pos,
                             step_valid)
                p, ng, mat = e_pos, e_ng, jnp.full((C,), -1, jnp.int32)
                wi = e_ng
                em_dir_ng = e_ng   # next step: emission lobe from here
                active = step_valid & (n_steps > j + 1)
                continue

        ks, kd = jax.random.split(jax.random.fold_in(kj, 17))
        emit_step = (j == 0 and first_kind == 3) or \
            (j == 1 and first_kind == 2)
        if j == 0 and first_kind == 1:
            # camera direction through a fresh film point
            from drmlt_mitsuba.render.sensor import sample_ray
            uvpix = jax.random.uniform(ks, (C, 2))
            o_c, d = sample_ray(scene.camera, uvpix)[:2]
            w_step = jnp.ones((C, 3))
            d_ok = jnp.ones((C,), bool)
        elif emit_step:
            # cosine emission lobe around the emitter normal
            from drmlt_mitsuba.core.warp import (
                square_to_cosine_hemisphere,
            )
            u2 = jax.random.uniform(ks, (C, 2))
            d_l = square_to_cosine_hemisphere(u2)
            d = frame.to_world(em_dir_ng, d_l)
            w_step = jnp.full((C, 3), math.pi)
            d_ok = jnp.ones((C,), bool)
        else:
            d, w_step, d_ok = _bsdf_dir_sample(scene, ks, mat, ng, wi)

        o = p + d * RAY_EPS * 10.0
        hit = intersect(scene, o, d)
        step_valid = active & d_ok & hit.valid
        out = _store(out, j, hit.p, hit.ng, hit.mat_id, hit.emitter_id,
                     w_step, step_valid)
        wi_new, _ = _dirto(hit.p, p)
        p = jnp.where(step_valid[:, None], hit.p, p)
        ng = jnp.where(step_valid[:, None], hit.ng, ng)
        mat = jnp.where(step_valid, hit.mat_id, mat)
        wi = jnp.where(step_valid[:, None], wi_new, wi)
        active = step_valid & (n_steps > j + 1)

    return out


def _store(out, j, pos, ng, mat, em, w, valid):
    out = dict(out)
    out["pos"] = out["pos"].at[:, j].set(pos)
    out["ng"] = out["ng"].at[:, j].set(ng)
    out["mat"] = out["mat"].at[:, j].set(jnp.asarray(mat, jnp.int32))
    out["em"] = out["em"].at[:, j].set(jnp.asarray(em, jnp.int32))
    out["w"] = out["w"].at[:, j].set(w)
    out["valid"] = out["valid"].at[:, j].set(valid)
    return out


# ----------------------------------------------------- strategy weights
def _edge_full(scene, ps, a_pos, a_ng, a_mat, a_prev, b_pos, b_ng, b_mat,
               b_next, b_is_light, b_front_ok):
    """Connection contribution between vertices a (eye side) and b (light
    side): f_a(wi=->a_prev, wo=->b) cos_a  x  cos_b / d^2  x
    f_b(wi=->a, wo=->b_next) — f_b is the front indicator when b is the
    (retained) light vertex."""
    wab, dist = _dirto(a_pos, b_pos)
    wi_a, _ = _dirto(a_pos, a_prev)
    f_a = _f_raw(scene, a_mat, a_ng, wi_a, wab)   # includes cos_a
    cos_b = jnp.abs(jnp.sum(wab * b_ng, -1))
    g = safe_div(cos_b, dist * dist)
    wo_b, _ = _dirto(b_pos, b_next)
    f_b_s = _f_raw(scene, b_mat, b_ng, -wab, wo_b)
    cos_bn = jnp.abs(jnp.sum(wo_b * b_ng, -1))
    f_b_s = f_b_s * safe_div(1.0, jnp.maximum(cos_bn, 1e-9))[:, None]
    # light endpoint: emission lobe front test (Le is handled by caller)
    front = jnp.sum(-wab * b_ng, -1) > 0
    f_b = jnp.where(b_is_light[:, None],
                    jnp.where((front & b_front_ok)[:, None], 1.0, 0.0),
                    f_b_s)
    return f_a * g[:, None] * f_b, dist, wab


def _path_vertex_weight_eye(scene, ps, i):
    """Weight of generating vertex i+1 from vertex i (eye orientation):
    camera-dir weight at i == 0, else f cos/pdf at vertex i."""
    C, V = ps.mat.shape
    nxt = jnp.minimum(i + 1, ps.k)
    p_i = _gslot(ps.pos, i)
    p_n = _gslot(ps.pos, nxt)
    wo, _ = _dirto(p_i, p_n)
    # camera case
    imp, pix, inside = sensor_importance(scene.camera, wo)
    w_cam = jnp.where(inside, 1.0, 0.0)[:, None] * jnp.ones((C, 3))
    # surface case
    p_prev = _gslot(ps.pos, jnp.maximum(i - 1, 0))
    wi, _ = _dirto(p_i, p_prev)
    ng = _gslot(ps.ng, i)
    mat = _gslot(ps.mat, i)
    w_srf = _vw(scene, mat, ng, wi, wo)
    return jnp.where((i == 0)[:, None], w_cam, w_srf)


def _path_vertex_weight_light(scene, ps, i):
    """Weight of generating vertex i from vertex i+1 (light orientation):
    emitter position weight when i+1 == k+1 (supernode: Le/pdf_pos of the
    light vertex itself), emission lobe (pi, front) when i+1 == k, else
    f cos/pdf at vertex i+1."""
    C, V = ps.mat.shape
    gen = jnp.minimum(i + 1, ps.k + 1)
    is_super = gen == ps.k + 1
    is_emit = gen == ps.k

    # supernode: position sampling of the light vertex (index i == k)
    w_pos = _emit_Le(scene, ps.em) * safe_div(
        1.0, _emit_pos_pdf(scene, ps.em))[:, None]

    p_g = _gslot(ps.pos, jnp.minimum(gen, ps.k))
    p_i = _gslot(ps.pos, jnp.minimum(i, ps.k))
    wo, _ = _dirto(p_g, p_i)
    lng = _gslot(ps.ng, ps.k)
    cos_l = jnp.sum(wo * lng, -1)
    w_emit = jnp.where(cos_l > 0, math.pi, 0.0)[:, None] * jnp.ones((C, 3))

    p_next = _gslot(ps.pos, jnp.minimum(gen + 1, ps.k))
    wi, _ = _dirto(p_g, p_next)
    ng_g = _gslot(ps.ng, jnp.minimum(gen, ps.k))
    mat_g = _gslot(ps.mat, jnp.minimum(gen, ps.k))
    w_srf = _vw(scene, mat_g, ng_g, wi, wo)

    return jnp.where(is_super[:, None], w_pos,
                     jnp.where(is_emit[:, None], w_emit, w_srf))


def _sum_inv_weights(scene, ps, l, ka, m_is_super, kmax):
    """sum_s 1/lum(weight_s) over the replacement region [l, l+ka] of ps,
    plus the per-record strategy count (for the pmf factor).

    weight_s = prod_{j=1..t} wE[j] * prod_{j=t+1..ka-1} wL[j] * C_t with
    t = ka-1-s; sMin = 1 if the light anchor is the supernode else 0;
    sMax = ka-2 if l == 0 (pinhole camera degenerate) else ka-1.
    """
    KA = kmax + 1
    C = ps.k.shape[0]
    one3 = jnp.ones((C, 3))

    # cumulative eye products: prodE[t] = prod_{j<=t} wE[j], t = 0..KA-1
    prodE = [one3]
    for j in range(1, KA):
        w = _path_vertex_weight_eye(scene, ps, l + j - 1)
        w = jnp.where((j <= ka - 1)[:, None], w, 1.0)
        prodE.append(prodE[-1] * w)
    # cumulative light products: prodL[s] = prod of s light-side steps
    prodL = [one3]
    for j in range(1, KA):
        # s light steps generate slots l+ka-1 .. l+ka-s
        w = _path_vertex_weight_light(scene, ps, l + ka - j)
        w = jnp.where((j <= ka - 1)[:, None], w, 1.0)
        prodL.append(prodL[-1] * w)

    s_min = jnp.where(m_is_super, 1, 0)
    s_max = jnp.where(l == 0, ka - 2, ka - 1)
    total = jnp.zeros((C,))
    b_is_light = None
    for s in range(KA):
        t = ka - 1 - s
        a_idx = l + t
        b_idx = l + t + 1
        a_prev = _gslot(ps.pos, jnp.maximum(a_idx - 1, 0))
        b_next = _gslot(ps.pos, jnp.minimum(b_idx + 1, ps.k))
        conn, dist, _ = _edge_full(
            scene, ps,
            _gslot(ps.pos, a_idx), _gslot(ps.ng, a_idx),
            _gslot(ps.mat, a_idx), a_prev,
            _gslot(ps.pos, jnp.minimum(b_idx, ps.k)),
            _gslot(ps.ng, jnp.minimum(b_idx, ps.k)),
            _gslot(ps.mat, jnp.minimum(b_idx, ps.k)), b_next,
            b_idx == ps.k, jnp.ones((C,), bool))
        tE = jnp.clip(t, 0, KA - 1)
        pe = jnp.stack(prodE, 1)          # (C, KA, 3)
        pl_ = jnp.stack(prodL, 1)
        wE = _gslot(pe, tE)
        wL = _gslot(pl_, jnp.clip(jnp.full_like(ps.k, s), 0, KA - 1))
        w_s = wE * wL * conn
        lum = luminance(w_s)
        ok = (jnp.full((C,), s) >= s_min) & (s <= s_max) & (t >= 0) \
            & jnp.isfinite(lum) & (lum > 1e-20)
        total = total + jnp.where(ok, safe_div(1.0, lum), 0.0)
    n_strats = jnp.maximum(s_max - s_min + 1, 0)
    return total, n_strats


# ------------------------------------------------- bidirectional mutation
def _assemble(ps, eye_walk, light_walk, l, t, ka, kd, k_new, em_new,
              kmax):
    """Splice retained prefix/suffix with the two replacement walks.

    Slot map of the proposal: [0..l] = ps[0..l]; (l, l+t] = eye walk
    steps 1..t; (l+t, l+ka) = light walk (step jj -> slot l+ka-1-jj);
    [l+ka..k'] = ps shifted by kd-ka."""
    V = ps.pos.shape[1]
    C = ps.k.shape[0]
    new = dict(pos=[], ng=[], mat=[])
    for i in range(V):
        fi = jnp.full((C,), i)
        in_prefix = fi <= l
        in_eye = (fi > l) & (fi <= l + t)
        in_light = (fi > l + t) & (fi < l + ka)
        # old slot for the suffix region
        old_i = jnp.clip(i - ka + kd, 0, V - 1)
        je = jnp.clip(fi - l - 1, 0, eye_walk["pos"].shape[1] - 1)
        jl = jnp.clip(l + ka - 1 - fi, 0, light_walk["pos"].shape[1] - 1)
        for f in ("pos", "ng", "mat"):
            v_old = ps.__getattribute__(f)[:, i]
            v_sfx = _gslot(ps.__getattribute__(f), old_i)
            v_eye = _gslot(eye_walk[f], je)
            v_lgt = _gslot(light_walk[f], jl)
            sel = jnp.where(in_prefix[..., None] if v_old.ndim == 2
                            else in_prefix, v_old,
                            jnp.where(in_eye[..., None] if v_old.ndim == 2
                                      else in_eye, v_eye,
                                      jnp.where(
                                          in_light[..., None]
                                          if v_old.ndim == 2 else in_light,
                                          v_lgt, v_sfx)))
            new[f].append(sel)
    pos = jnp.stack(new["pos"], 1)
    ng = jnp.stack(new["ng"], 1)
    mat = jnp.stack(new["mat"], 1).astype(jnp.int32)
    return PathState(pos=pos, ng=ng, mat=mat, em=em_new, k=k_new)


def _bidir_pmf(scene, ps, k, k_prime, kd, l, kmin, kmax):
    """pmf of the mutation record (mut_bidir.cpp pmfMutation): the l pick
    is uniform over valid anchors; s uniform over [sMin, sMax]."""
    C = k.shape[0]
    support = np.arange(0, kmax + 2)
    _, pmf_len, _ = _two_tailed_cdf_sample(
        jnp.zeros((C,)), k.astype(jnp.float32),
        jnp.full((C,), kmin), jnp.full((C,), kmax), support)
    f1 = pmf_len(k_prime)
    min_del = jnp.maximum(jnp.where(k == k_prime, 2, 1), k - k_prime + 1)
    _, pmf_del, _ = _two_tailed_cdf_sample(
        jnp.zeros((C,)), jnp.full((C,), 2.0), min_del,
        k + 1, support)
    f2 = pmf_del(kd)
    ctr = _count_valid_anchors(scene, ps, k, kd, kmax)
    f3 = safe_div(1.0, ctr.astype(jnp.float32))
    ka = k_prime - k + kd
    s_min = jnp.where(l + kd == k + 1, 1, 0)
    s_max = jnp.where(l == 0, ka - 2, ka - 1)
    n_s = jnp.maximum(s_max - s_min + 1, 0)
    f4 = safe_div(1.0, n_s.astype(jnp.float32))
    return f1 * f2 * f3 * f4


def _anchor_ok(scene, ps, idx, k):
    """Anchor vertex validity: camera (0), interior non-delta, emitter
    vertex (k), or the emitter supernode (k+1)."""
    is_cam = idx == 0
    is_sup = idx == k + 1
    is_emit = idx == k
    interior = (idx > 0) & (idx < k)
    mat = _gslot(ps.mat, jnp.clip(idx, 0, ps.mat.shape[1] - 1))
    delta = is_delta_kind(scene.materials, mat) & (mat >= 0)
    return is_cam | is_sup | is_emit | (interior & ~delta)


def _count_valid_anchors(scene, ps, k, kd, kmax):
    C = k.shape[0]
    ctr = jnp.zeros((C,), jnp.int32)
    for l in range(kmax + 1):
        fl = jnp.full((C,), l)
        m = fl + kd
        ok = (m <= k + 1) & _anchor_ok(scene, ps, fl, k) \
            & _anchor_ok(scene, ps, m, k)
        ctr = ctr + ok.astype(jnp.int32)
    return ctr


def mut_bidir(scene, cfg: MLTConfig, key, ps: PathState,
              debug: bool = False):
    """One bidirectional-mutation proposal + acceptance for all chains.
    Returns (proposal PathState, accept prob a, structural-ok mask)."""
    kmax = cfg.max_depth
    C = ps.k.shape[0]
    V = ps.pos.shape[1]
    keys = jax.random.split(key, 8)
    support = np.arange(0, kmax + 2)

    k = ps.k
    k_prime, _, ok_len = _two_tailed_cdf_sample(
        jax.random.uniform(keys[0], (C,)), k.astype(jnp.float32),
        jnp.full((C,), cfg.kmin), jnp.full((C,), kmax), support)
    min_del = jnp.maximum(jnp.where(k == k_prime, 2, 1), k - k_prime + 1)
    kd, _, ok_del = _two_tailed_cdf_sample(
        jax.random.uniform(keys[1], (C,)), jnp.full((C,), 2.0),
        min_del, k + 1, support)
    ka = k_prime - k + kd

    # anchor l: uniform over valid positions (masked cdf inversion)
    valid_l = []
    for l in range(kmax + 1):
        fl = jnp.full((C,), l)
        m = fl + kd
        valid_l.append((m <= k + 1) & _anchor_ok(scene, ps, fl, k)
                       & _anchor_ok(scene, ps, m, k))
    valid_l = jnp.stack(valid_l, 1).astype(jnp.float32)   # (C, kmax+1)
    ctr = valid_l.sum(1)
    cdf_l = jnp.cumsum(valid_l, 1)
    pick = jax.random.uniform(keys[2], (C,)) * ctr
    l = jnp.sum((cdf_l < pick[:, None]).astype(jnp.int32), 1)
    l = jnp.clip(l, 0, kmax)
    m = l + kd
    m_is_super = m == k + 1

    s_min = jnp.where(m_is_super, 1, 0)
    s_max = jnp.where(l == 0, ka - 2, ka - 1)
    n_s = s_max - s_min + 1
    s = s_min + jnp.floor(
        jax.random.uniform(keys[3], (C,)) * jnp.maximum(n_s, 1)
    ).astype(jnp.int32)
    s = jnp.clip(s, s_min, jnp.maximum(s_max, s_min))
    t = ka - 1 - s

    ok = ok_len & ok_del & (ctr > 0) & (n_s > 0) & (ka >= 1) \
        & (k_prime >= cfg.kmin) & (k_prime <= kmax)

    # ---- eye-side extension (t steps from anchor v_l) ---------------------
    p_l = _gslot(ps.pos, l)
    ng_l = _gslot(ps.ng, l)
    mat_l = _gslot(ps.mat, l)
    wi_l, _ = _dirto(p_l, _gslot(ps.pos, jnp.maximum(l - 1, 0)))
    eye_walk = _extend_walk(
        scene, keys[4], p_l, ng_l, mat_l, wi_l, 0, ng_l, t, kmax)
    # camera anchor: re-dispatch first step through the sensor
    eye_walk_cam = _extend_walk(
        scene, keys[4], jnp.broadcast_to(scene.camera.to_world[:3, 3],
                                         (C, 3)),
        ng_l, mat_l, wi_l, 1, ng_l, t, kmax)
    at_cam = (l == 0)
    eye_walk = {f: jnp.where(
        at_cam[:, None, None] if eye_walk[f].ndim == 3 else at_cam[:, None],
        eye_walk_cam[f], eye_walk[f]) for f in eye_walk}

    # ---- light-side extension (s steps from anchor v_m / supernode) -------
    p_m = _gslot(ps.pos, jnp.minimum(m, k))
    ng_m = _gslot(ps.ng, jnp.minimum(m, k))
    mat_m = _gslot(ps.mat, jnp.minimum(m, k))
    wi_m, _ = _dirto(p_m, _gslot(ps.pos, jnp.minimum(m + 1, k)))
    lw_srf = _extend_walk(scene, keys[5], p_m, ng_m, mat_m, wi_m, 0,
                          ng_m, s, kmax)
    lw_emit = _extend_walk(scene, keys[5], p_m, ng_m, mat_m, wi_m, 3,
                           ng_m, s, kmax)
    lw_sup = _extend_walk(scene, keys[5], p_m, ng_m, mat_m, wi_m, 2,
                          ng_m, s, kmax)
    at_emit = m == k
    light_walk = {}
    for f in lw_srf:
        a_ = jnp.where(
            at_emit[:, None, None] if lw_srf[f].ndim == 3
            else at_emit[:, None], lw_emit[f], lw_srf[f])
        light_walk[f] = jnp.where(
            m_is_super[:, None, None] if lw_srf[f].ndim == 3
            else m_is_super[:, None], lw_sup[f], a_)

    # walk success: all requested steps valid
    def steps_ok(walk, n):
        got = jnp.zeros((C,), jnp.int32)
        for j in range(walk["valid"].shape[1]):
            got = got + (walk["valid"][:, j] & (j < n)).astype(jnp.int32)
        return got == n
    ok = ok & steps_ok(eye_walk, t) & steps_ok(light_walk, s)

    # new emitter row: supernode anchor regenerates the light vertex
    em_sup = light_walk["em"][:, 0]
    em_new = jnp.where(m_is_super, em_sup, ps.em)

    prop = _assemble(ps, eye_walk, light_walk, l, t, ka, kd,
                     k_prime, em_new, kmax)

    # connection visibility between slots l+t and l+t+1 of the proposal
    a_pos = _gslot(prop.pos, l + t)
    b_pos = _gslot(prop.pos, jnp.minimum(l + t + 1, prop.k))
    wab, dist = _dirto(a_pos, b_pos)
    o = a_pos + wab * RAY_EPS * 10.0
    blocked = occluded(scene, o, wab, dist * (1.0 - 1e-3) - RAY_EPS)
    ok = ok & ~blocked

    # ---- acceptance --------------------------------------------------------
    inv_y, _ = _sum_inv_weights(scene, prop, l, ka, m_is_super, kmax)
    inv_x, _ = _sum_inv_weights(scene, ps, l, kd, m_is_super, kmax)
    pmf_xy = _bidir_pmf(scene, ps, k, k_prime, kd, l, cfg.kmin, kmax)
    pmf_yx = _bidir_pmf(scene, prop, k_prime, k, ka, l, cfg.kmin, kmax)
    q_xy = pmf_xy * inv_y
    q_yx = pmf_yx * inv_x
    a = jnp.where((q_xy > 1e-30) & jnp.isfinite(q_xy) & jnp.isfinite(q_yx),
                  jnp.minimum(q_yx / jnp.maximum(q_xy, 1e-30), 1.0), 0.0)
    a = jnp.where(ok, a, 0.0)
    if debug:
        return prop, a, ok, dict(q_xy=q_xy, q_yx=q_yx, l=l, ka=ka, kd=kd,
                                 s=s, t=t, k_prime=k_prime,
                                 m_is_super=m_is_super)
    return prop, a, ok


# ------------------------------------------------------ lens perturbation
def _specular_retrace(scene, ps, start_dir, n_spec, from_eye, kmax):
    """Retrace a specular chain: from the camera (from_eye) or the light
    vertex, following direction start_dir, re-resolving each delta
    interaction with the SAME discrete component as the source path.
    Returns (new vertex arrays (C, kmax, .), chain weights, per-step ok).
    n_spec: number of NEW vertices to place = specular count + 1 (the
    final non-specular vertex)."""
    C = ps.k.shape[0]
    V = ps.pos.shape[1]
    out = dict(pos=jnp.zeros((C, kmax, 3)), ng=jnp.zeros((C, kmax, 3)),
               mat=jnp.full((C, kmax), -1, jnp.int32),
               w=jnp.ones((C, kmax, 3)),
               valid=jnp.zeros((C, kmax), bool))
    p = jnp.broadcast_to(scene.camera.to_world[:3, 3], (C, 3)) \
        if from_eye else _gslot(ps.pos, ps.k)
    d = start_dir
    active = n_spec > 0
    for j in range(kmax):
        o = p + d * RAY_EPS * 10.0
        hit = intersect(scene, o, d)
        step_ok = active & hit.valid
        out["pos"] = out["pos"].at[:, j].set(hit.p)
        out["ng"] = out["ng"].at[:, j].set(hit.ng)
        out["mat"] = out["mat"].at[:, j].set(hit.mat_id)
        out["valid"] = out["valid"].at[:, j].set(step_ok)
        # source vertex at this chain position must have matching
        # delta-ness; resolve the delta interaction for the next leg
        wi = -d
        wi_l = frame.to_local(hit.ng, wi)
        albedo = scene.materials.albedo[jnp.clip(hit.mat_id, 0, None)]
        same = wi_l[..., 2] > 0
        # choose reflect for same-side sources; dielectric branch picked
        # to match the SOURCE path's side change at this chain slot
        src_i = jnp.where(from_eye, jnp.full((C,), j + 1),
                          ps.k - 1 - j)
        src_p = _gslot(ps.pos, jnp.clip(src_i, 0, V - 1))
        src_n = _gslot(ps.pos, jnp.clip(
            jnp.where(from_eye, src_i + 1, src_i - 1), 0, V - 1))
        w_src, _ = _dirto(src_p, src_n)
        ng_src = _gslot(ps.ng, jnp.clip(src_i, 0, V - 1))
        wi_src, _ = _dirto(src_p, _gslot(ps.pos, jnp.clip(
            jnp.where(from_eye, src_i - 1, src_i + 1), 0, V - 1)))
        src_same = (jnp.sum(wi_src * ng_src, -1)
                    * jnp.sum(w_src * ng_src, -1)) > 0
        uc = jnp.where(src_same, 0.0, 0.999)
        u3 = jnp.stack([uc, jnp.full_like(uc, 0.5),
                        jnp.full_like(uc, 0.5)], -1)
        bs = sample_bsdf(scene.materials, hit.mat_id, albedo, wi_l, u3)
        out["w"] = out["w"].at[:, j].set(
            jnp.where(step_ok[:, None], bs.weight, 1.0))
        d_new = frame.to_world(hit.ng, bs.wo)
        p = jnp.where(step_ok[:, None], hit.p, p)
        d = jnp.where(step_ok[:, None], d_new, d)
        active = step_ok & (n_spec > j + 1) \
            & (luminance(bs.weight) > 0)
    return out


def _eye_spec_len(scene, ps, kmax):
    """j = index of the first non-delta vertex from the eye side."""
    C = ps.k.shape[0]
    j = jnp.full((C,), -1, jnp.int32)
    for i in range(1, kmax + 1):
        delta = _is_delta_v(scene, ps, min(i, ps.mat.shape[1] - 1))
        is_light = jnp.full((C,), i) >= ps.k
        found = (j < 0) & (~delta | is_light) & (i <= ps.k)
        j = jnp.where(found, i, j)
    return j


def _light_spec_len(scene, ps, kmax):
    """index (from eye side) of the first non-delta vertex scanning from
    the light end: largest i < k with non-delta mat."""
    C = ps.k.shape[0]
    j = jnp.full((C,), -1, jnp.int32)
    for i in range(1, kmax + 1):
        fi = jnp.full((C,), i)
        delta = _is_delta_v(scene, ps, min(i, ps.mat.shape[1] - 1))
        ok = (fi < ps.k) & ~delta
        j = jnp.where(ok, fi, j)    # keep the largest qualifying i
    return j


def _chain_W(scene, ps, j_end, side_eye, retrace, n_new, kmax):
    """Perturbation weight W = prod(chain delta weights) x connection
    contribution (mut_lens.cpp Q / my derivation; camera & perturbation
    pdfs cancel)."""
    C = ps.k.shape[0]
    w = jnp.ones((C, 3))
    for j in range(kmax):
        use = jnp.full((C,), j) < (n_new - 1)   # specular steps only
        w = w * jnp.where(use[:, None], retrace["w"][:, j], 1.0)
    # connection: new final vertex vj' -> its retained neighbor
    jj = jnp.clip(n_new - 1, 0, kmax - 1)
    vj_pos = _gslot(retrace["pos"], jj)
    vj_ng = _gslot(retrace["ng"], jj)
    vj_mat = _gslot(retrace["mat"], jj)
    if side_eye:
        nb = jnp.minimum(j_end + 1, ps.k)       # toward the light side
        nb2 = jnp.minimum(j_end + 2, ps.k)
        prev = _gslot(retrace["pos"], jnp.clip(jj - 1, 0, kmax - 1))
        prev = jnp.where((n_new == 1)[:, None],
                         jnp.broadcast_to(scene.camera.to_world[:3, 3],
                                          (C, 3)), prev)
        conn, dist, wab = _edge_full(
            scene, ps, vj_pos, vj_ng, vj_mat, prev,
            _gslot(ps.pos, nb), _gslot(ps.ng, nb), _gslot(ps.mat, nb),
            _gslot(ps.pos, nb2), nb == ps.k, jnp.ones((C,), bool))
        o = vj_pos + wab * RAY_EPS * 10.0
        blocked = occluded(scene, o, wab, dist * (1.0 - 1e-3) - RAY_EPS)
        return w * conn, blocked, vj_pos
    else:
        # caustic: connect vj' to the camera; include the camera factor
        cam = jnp.broadcast_to(scene.camera.to_world[:3, 3], (C, 3))
        w_to_cam, dist = _dirto(vj_pos, cam)
        d01 = -w_to_cam
        imp, pix, inside = sensor_importance(scene.camera, d01)
        cos_c = jnp.abs(jnp.sum(d01 * scene.camera.to_world[:3, 2], -1))
        cos_v = jnp.abs(jnp.sum(d01 * vj_ng, -1))
        g = imp * cos_c * safe_div(cos_v, dist * dist)
        prev = _gslot(retrace["pos"], jnp.clip(jj - 1, 0, kmax - 1))
        prev = jnp.where((n_new == 1)[:, None],
                         _gslot(ps.pos, ps.k), prev)
        wi_v, _ = _dirto(vj_pos, prev)
        f_v = _f_raw(scene, vj_mat, vj_ng, wi_v, w_to_cam)
        o = vj_pos + w_to_cam * RAY_EPS * 10.0
        blocked = occluded(scene, o, w_to_cam,
                           dist * (1.0 - 1e-3) - RAY_EPS)
        W = w * f_v * g[:, None] * jnp.where(inside, 1.0, 0.0)[:, None]
        return W, blocked, pix


def mut_lens(scene, cfg: MLTConfig, key, ps: PathState, res_x, res_y):
    """Lens perturbation (mut_lens.cpp:72-205): annulus jump of the image
    point, deterministic retrace through the eye-side specular chain,
    reconnect at the first non-specular vertex."""
    kmax = cfg.max_depth
    C = ps.k.shape[0]
    k1, k2 = jax.random.split(key)

    j_end = _eye_spec_len(scene, ps, kmax)     # first non-delta eye vertex
    # the connection partner must itself be connectable
    nb = jnp.minimum(j_end + 1, ps.k)
    nb_mat = _gslot(ps.mat, nb)
    nb_delta = is_delta_kind(scene.materials, nb_mat) & (nb_mat >= 0)
    ok = (j_end >= 1) & (j_end < ps.k) & ~nb_delta

    # current and proposed image points
    d01, _ = _dirto(ps.pos[:, 0], ps.pos[:, 1])
    _, pix0, ins0 = sensor_importance(scene.camera, d01)
    r2 = math.sqrt(cfg.lens_frac / math.pi)
    r1 = cfg.lens_r1 / max(res_x, res_y)
    r = r2 * jnp.exp(-math.log(r2 / r1) * jax.random.uniform(k1, (C,)))
    phi = jax.random.uniform(k2, (C,)) * 2 * math.pi
    pix = pix0 + jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], -1)
    inside = (pix[:, 0] > 0) & (pix[:, 0] < 1) & (pix[:, 1] > 0) \
        & (pix[:, 1] < 1)
    ok = ok & inside & ins0

    from drmlt_mitsuba.render.sensor import sample_ray
    _, d_new = sample_ray(scene.camera, pix)[:2]
    retrace = _extend_retrace_ok = _specular_retrace(
        scene, ps, d_new, j_end, True, kmax)
    # every retraced slot must land on a surface of matching delta-ness
    for j in range(kmax):
        fj = jnp.full((C,), j)
        need = fj < j_end
        src_delta = _is_delta_v(scene, ps, min(j + 1,
                                               ps.mat.shape[1] - 1))
        new_mat = retrace["mat"][:, j]
        new_delta = is_delta_kind(scene.materials, new_mat) & (new_mat >= 0)
        ok = ok & (~need | (retrace["valid"][:, j]
                            & (new_delta == src_delta)))
    last_ok = retrace["valid"] & True
    Wy, blocked, _ = _chain_W(scene, ps, j_end, True, retrace, j_end, kmax)
    ok = ok & ~blocked

    # reverse weight from the source path's own chain
    src_retrace = dict(
        pos=ps.pos[:, 1:kmax + 1], ng=ps.ng[:, 1:kmax + 1],
        mat=ps.mat[:, 1:kmax + 1],
        w=jnp.ones((C, kmax, 3)), valid=jnp.ones((C, kmax), bool))
    # source chain weights: recompute the delta weights post-hoc
    wsrc = jnp.ones((C, kmax, 3))
    for j in range(kmax):
        i = min(j + 1, ps.mat.shape[1] - 1)
        wi, _ = _dirto(ps.pos[:, i], ps.pos[:, max(i - 1, 0)])
        wo, _ = _dirto(ps.pos[:, i], ps.pos[:, min(i + 1,
                                                   ps.pos.shape[1] - 1)])
        wsrc = wsrc.at[:, j].set(_vw(scene, ps.mat[:, i], ps.ng[:, i],
                                     wi, wo))
    src_retrace["w"] = wsrc
    Wx, blocked_x, _ = _chain_W(scene, ps, j_end, True, src_retrace,
                                j_end, kmax)

    a = jnp.where(ok & (luminance(Wx) > 1e-30),
                  jnp.minimum(safe_div(luminance(Wy), luminance(Wx)), 1.0),
                  0.0)

    # assemble the proposal: slots 1..j_end replaced
    prop_pos, prop_ng, prop_mat = [ps.pos[:, 0]], [ps.ng[:, 0]], \
        [ps.mat[:, 0]]
    V = ps.pos.shape[1]
    for i in range(1, V):
        fi = jnp.full((C,), i)
        in_chain = fi <= j_end
        jj = jnp.clip(fi - 1, 0, kmax - 1)
        prop_pos.append(jnp.where(in_chain[:, None],
                                  _gslot(retrace["pos"], jj),
                                  ps.pos[:, i]))
        prop_ng.append(jnp.where(in_chain[:, None],
                                 _gslot(retrace["ng"], jj), ps.ng[:, i]))
        prop_mat.append(jnp.where(in_chain, _gslot(retrace["mat"], jj),
                                  ps.mat[:, i]))
    prop = PathState(pos=jnp.stack(prop_pos, 1), ng=jnp.stack(prop_ng, 1),
                     mat=jnp.stack(prop_mat, 1).astype(jnp.int32),
                     em=ps.em, k=ps.k)
    return prop, a, ok


def mut_mchain(scene, cfg: MLTConfig, key, ps: PathState, res_x, res_y):
    """Multi-chain perturbation (mut_mchain.cpp:70-230): an annulus jump
    of the image point propagated through SUCCESSIVE eye-side specular
    chains — at every intermediate connectable (separator) vertex the old
    outgoing direction is cone-perturbed (log-exponential theta, the same
    symmetric kernel as the caustic perturbation) and the next chain is
    retraced deterministically; the final vertex reconnects to the
    retained suffix.  Both the screen and the cone densities are
    symmetric, so the acceptance is the cached-weight ratio
    a = lum(W(y))/lum(W(x)) with W = chain weights x connection
    contribution — delta vertices contribute their component weight, and
    separators contribute f |cos| (mut_mchain.cpp Q: EValueCosineRad; no
    pdf division because the cone density cancels)."""
    kmax = cfg.max_depth
    C = ps.k.shape[0]
    V = ps.pos.shape[1]
    k1, k2, k3 = jax.random.split(key, 3)

    # ---- structure scan (mut_mchain.cpp:72-80 translated to camera-first
    # indexing): walk i = 1.. while NOT (conn(v_i) & conn(v_{i+1})),
    # counting connectable v_i (chain ends); j_end = first i where both
    # are connectable; eligible iff >= 2 chains were crossed
    j_end = jnp.full((C,), -1, jnp.int32)
    nch = jnp.ones((C,), jnp.int32)
    scanning = jnp.ones((C,), bool)
    for i in range(1, kmax + 1):
        fi = jnp.full((C,), i)
        in_path = fi < ps.k           # v_{i+1} exists (may be the light)
        conn_i = ~_is_delta_v(scene, ps, min(i, V - 1))
        conn_n = ~_is_delta_v(scene, ps, min(i + 1, V - 1))
        stop = scanning & in_path & conn_i & conn_n
        j_end = jnp.where(stop, i, j_end)
        nch = jnp.where(scanning & ~stop & in_path & conn_i,
                        nch + 1, nch)
        scanning = scanning & ~stop & in_path
    ok = (j_end >= 1) & (nch >= 2)

    # ---- screen-space annulus jump (identical to mut_lens) --------------
    d01, _ = _dirto(ps.pos[:, 0], ps.pos[:, 1])
    _, pix0, ins0 = sensor_importance(scene.camera, d01)
    r2 = math.sqrt(cfg.lens_frac / math.pi)
    r1 = cfg.lens_r1 / max(res_x, res_y)
    r = r2 * jnp.exp(-math.log(r2 / r1) * jax.random.uniform(k1, (C,)))
    phi0 = jax.random.uniform(k2, (C,)) * 2 * math.pi
    pix = pix0 + jnp.stack([r * jnp.cos(phi0), r * jnp.sin(phi0)], -1)
    inside = (pix[:, 0] > 0) & (pix[:, 0] < 1) & (pix[:, 1] > 0) \
        & (pix[:, 1] < 1)
    ok = ok & inside & ins0

    from drmlt_mitsuba.render.sensor import sample_ray
    _, d_new = sample_ray(scene.camera, pix)[:2]

    # ---- multi-chain retrace -------------------------------------------
    out = dict(pos=jnp.zeros((C, kmax, 3)), ng=jnp.zeros((C, kmax, 3)),
               mat=jnp.full((C, kmax), -1, jnp.int32),
               w=jnp.ones((C, kmax, 3)),
               valid=jnp.zeros((C, kmax), bool))
    p = jnp.broadcast_to(scene.camera.to_world[:3, 3], (C, 3))
    d = d_new
    active = j_end > 0
    t1, t2 = cfg.caustic_t1, cfg.caustic_t2
    for j in range(kmax):
        o = p + d * RAY_EPS * 10.0
        hit = intersect(scene, o, d)
        step_ok = active & hit.valid
        out["pos"] = out["pos"].at[:, j].set(hit.p)
        out["ng"] = out["ng"].at[:, j].set(hit.ng)
        out["mat"] = out["mat"].at[:, j].set(hit.mat_id)
        out["valid"] = out["valid"].at[:, j].set(step_ok)
        src_i = min(j + 1, V - 1)
        src_delta = _is_delta_v(scene, ps, src_i)
        wi_l = frame.to_local(hit.ng, -d)
        albedo = scene.materials.albedo[jnp.clip(hit.mat_id, 0, None)]
        # delta branch: re-resolve the SAME discrete component
        src_p = _gslot(ps.pos, jnp.full((C,), src_i))
        src_nxt = _gslot(ps.pos, jnp.clip(
            jnp.full((C,), src_i + 1), 0, V - 1))
        w_src_dir, _ = _dirto(src_p, src_nxt)
        ng_src = _gslot(ps.ng, jnp.full((C,), src_i))
        wi_src, _ = _dirto(src_p, _gslot(ps.pos, jnp.clip(
            jnp.full((C,), src_i - 1), 0, V - 1)))
        src_same = (jnp.sum(wi_src * ng_src, -1)
                    * jnp.sum(w_src_dir * ng_src, -1)) > 0
        uc = jnp.where(src_same, 0.0, 0.999)
        u3 = jnp.stack([uc, jnp.full_like(uc, 0.5),
                        jnp.full_like(uc, 0.5)], -1)
        bs = sample_bsdf(scene.materials, hit.mat_id, albedo, wi_l, u3)
        d_delta = frame.to_world(hit.ng, bs.wo)
        # separator branch: cone-perturb the source outgoing direction
        th = t2 * jnp.exp(-math.log(t2 / t1) * jax.random.uniform(
            jax.random.fold_in(k3, 2 * j), (C,)))
        ph = jax.random.uniform(jax.random.fold_in(k3, 2 * j + 1),
                                (C,)) * 2 * math.pi
        s_, t_ = frame.coordinate_system(w_src_dir)
        d_pert = (w_src_dir * jnp.cos(th)[:, None]
                  + (s_ * jnp.cos(ph)[:, None] + t_ * jnp.sin(ph)[:, None])
                  * jnp.sin(th)[:, None])
        w_sep = _f_raw(scene, hit.mat_id, hit.ng, -d, d_pert)
        w_j = jnp.where(src_delta[:, None], bs.weight, w_sep)
        d_next = jnp.where(src_delta[:, None], d_delta, d_pert)
        out["w"] = out["w"].at[:, j].set(
            jnp.where(step_ok[:, None], w_j, 1.0))
        p = jnp.where(step_ok[:, None], hit.p, p)
        d = jnp.where(step_ok[:, None], d_next, d)
        active = step_ok & (j_end > j + 1) & (luminance(w_j) > 0)

    # structure: every replaced slot must land with matching delta-ness
    for j in range(kmax):
        fj = jnp.full((C,), j)
        need = fj < j_end
        src_delta = _is_delta_v(scene, ps, min(j + 1, V - 1))
        new_mat = out["mat"][:, j]
        new_delta = is_delta_kind(scene.materials, new_mat) & (new_mat >= 0)
        ok = ok & (~need | (out["valid"][:, j]
                            & (new_delta == src_delta)))

    Wy, blocked, _ = _chain_W(scene, ps, j_end, True, out, j_end, kmax)
    ok = ok & ~blocked

    # reverse weight from the source path's own chain: delta vertices use
    # the cached component weight, separators use f |cos| (symmetric cone)
    wsrc = jnp.ones((C, kmax, 3))
    for j in range(kmax):
        i = min(j + 1, V - 1)
        wi, _ = _dirto(ps.pos[:, i], ps.pos[:, max(i - 1, 0)])
        wo, _ = _dirto(ps.pos[:, i], ps.pos[:, min(i + 1, V - 1)])
        sd = _is_delta_v(scene, ps, i)
        w_v = _vw(scene, ps.mat[:, i], ps.ng[:, i], wi, wo)
        w_f = _f_raw(scene, ps.mat[:, i], ps.ng[:, i], wi, wo)
        wsrc = wsrc.at[:, j].set(jnp.where(sd[:, None], w_v, w_f))
    src_retrace = dict(
        pos=ps.pos[:, 1:kmax + 1], ng=ps.ng[:, 1:kmax + 1],
        mat=ps.mat[:, 1:kmax + 1], w=wsrc,
        valid=jnp.ones((C, kmax), bool))
    Wx, blocked_x, _ = _chain_W(scene, ps, j_end, True, src_retrace,
                                j_end, kmax)

    a = jnp.where(ok & (luminance(Wx) > 1e-30),
                  jnp.minimum(safe_div(luminance(Wy), luminance(Wx)), 1.0),
                  0.0)

    # assemble: slots 1..j_end replaced
    prop_pos, prop_ng, prop_mat = [ps.pos[:, 0]], [ps.ng[:, 0]], \
        [ps.mat[:, 0]]
    for i in range(1, V):
        fi = jnp.full((C,), i)
        in_chain = fi <= j_end
        jj = jnp.clip(fi - 1, 0, kmax - 1)
        prop_pos.append(jnp.where(in_chain[:, None],
                                  _gslot(out["pos"], jj),
                                  ps.pos[:, i]))
        prop_ng.append(jnp.where(in_chain[:, None],
                                 _gslot(out["ng"], jj), ps.ng[:, i]))
        prop_mat.append(jnp.where(in_chain, _gslot(out["mat"], jj),
                                  ps.mat[:, i]))
    prop = PathState(pos=jnp.stack(prop_pos, 1), ng=jnp.stack(prop_ng, 1),
                     mat=jnp.stack(prop_mat, 1).astype(jnp.int32),
                     em=ps.em, k=ps.k)
    return prop, a, ok


def mut_caustic(scene, cfg: MLTConfig, key, ps: PathState):
    """Caustic perturbation (mut_caustic.cpp): cone-perturb the emission
    direction, retrace through the light-side specular chain, reconnect
    the final non-specular vertex to the camera."""
    kmax = cfg.max_depth
    C = ps.k.shape[0]
    k1, k2 = jax.random.split(key)

    # structure: v1 non-delta, v2..v_{k-1} ALL delta (L S* D E)
    all_delta = jnp.ones((C,), bool)
    for i in range(2, kmax):
        fi = jnp.full((C,), i)
        inchain = fi < ps.k
        d = _is_delta_v(scene, ps, min(i, ps.mat.shape[1] - 1))
        all_delta = all_delta & (~inchain | d)
    v1_delta = _is_delta_v(scene, ps, 1)
    ok = all_delta & ~v1_delta & (ps.k >= 2)

    # perturb the direction light -> v_{k-1} inside a cone
    lpos = _gslot(ps.pos, ps.k)
    lng = _gslot(ps.ng, ps.k)
    d0, _ = _dirto(lpos, _gslot(ps.pos, ps.k - 1))
    t1, t2 = cfg.caustic_t1, cfg.caustic_t2
    theta = t2 * jnp.exp(-math.log(t2 / t1)
                         * jax.random.uniform(k1, (C,)))
    phi = jax.random.uniform(k2, (C,)) * 2 * math.pi
    # rotate d0 by theta around a frame of d0
    s_, t_ = frame.coordinate_system(d0)
    d_new = (d0 * jnp.cos(theta)[:, None]
             + (s_ * jnp.cos(phi)[:, None] + t_ * jnp.sin(phi)[:, None])
             * jnp.sin(theta)[:, None])
    front = jnp.sum(d_new * lng, -1) > 0
    ok = ok & front

    n_new = ps.k - 1    # replaced vertices v_{k-1} .. v_1
    retrace = _specular_retrace(scene, ps, d_new, n_new, False, kmax)
    for j in range(kmax):
        fj = jnp.full((C,), j)
        need = fj < n_new - 1
        src_i = jnp.clip(ps.k - 1 - j, 0, ps.mat.shape[1] - 1)
        src_delta = is_delta_kind(
            scene.materials, _gslot(ps.mat, src_i)) \
            & (_gslot(ps.mat, src_i) >= 0)
        new_mat = retrace["mat"][:, j]
        new_delta = is_delta_kind(scene.materials, new_mat) & (new_mat >= 0)
        ok = ok & (~need | (retrace["valid"][:, j]
                            & (new_delta == src_delta)))
    ok = ok & _gslot(retrace["valid"], jnp.clip(n_new - 1, 0, kmax - 1))

    Wy, blocked, pix_y = _chain_W(scene, ps, None, False, retrace, n_new,
                                  kmax)
    ok = ok & ~blocked

    # reverse: the source chain in light->eye order
    wsrc = jnp.ones((C, kmax, 3))
    src = dict(pos=jnp.zeros((C, kmax, 3)), ng=jnp.zeros((C, kmax, 3)),
               mat=jnp.full((C, kmax), -1, jnp.int32),
               valid=jnp.ones((C, kmax), bool))
    for j in range(kmax):
        i = jnp.clip(ps.k - 1 - j, 0, ps.mat.shape[1] - 1)
        src["pos"] = src["pos"].at[:, j].set(_gslot(ps.pos, i))
        src["ng"] = src["ng"].at[:, j].set(_gslot(ps.ng, i))
        src["mat"] = src["mat"].at[:, j].set(_gslot(ps.mat, i))
        wi, _ = _dirto(_gslot(ps.pos, i),
                       _gslot(ps.pos, jnp.minimum(i + 1, ps.k)))
        wo, _ = _dirto(_gslot(ps.pos, i),
                       _gslot(ps.pos, jnp.maximum(i - 1, 0)))
        wsrc = wsrc.at[:, j].set(
            _vw(scene, _gslot(ps.mat, i), _gslot(ps.ng, i), wi, wo))
    src["w"] = wsrc
    Wx, blocked_x, _ = _chain_W(scene, ps, None, False, src, n_new, kmax)

    a = jnp.where(ok & (luminance(Wx) > 1e-30),
                  jnp.minimum(safe_div(luminance(Wy), luminance(Wx)), 1.0),
                  0.0)

    # assemble: slots 1..k-1 replaced (retrace j -> slot k-1-j)
    V = ps.pos.shape[1]
    prop_pos, prop_ng, prop_mat = [ps.pos[:, 0]], [ps.ng[:, 0]], \
        [ps.mat[:, 0]]
    for i in range(1, V):
        fi = jnp.full((C,), i)
        in_chain = (fi >= 1) & (fi < ps.k)
        jj = jnp.clip(ps.k - 1 - fi, 0, kmax - 1)
        prop_pos.append(jnp.where(in_chain[:, None],
                                  _gslot(retrace["pos"], jj),
                                  ps.pos[:, i]))
        prop_ng.append(jnp.where(in_chain[:, None],
                                 _gslot(retrace["ng"], jj), ps.ng[:, i]))
        prop_mat.append(jnp.where(in_chain, _gslot(retrace["mat"], jj),
                                  ps.mat[:, i]))
    prop = PathState(pos=jnp.stack(prop_pos, 1), ng=jnp.stack(prop_ng, 1),
                     mat=jnp.stack(prop_mat, 1).astype(jnp.int32),
                     em=ps.em, k=ps.k)
    return prop, a, ok


# --------------------------------------------------------------- seeding
def build_seed_paths(scene: Scene, cfg: MLTConfig, key, n_chains: int,
                     n_bootstrap: int):
    """Bootstrap: sample MMLT-style single-strategy paths, estimate
    b = E[f/p] (the image normalization), resample seeds ∝ contribution,
    and materialize PathState tensors from the winning subpaths.

    Returns (PathState, b)."""
    from drmlt_mitsuba.integrators.bidir import (
        BDPTConfig, eye_subpath, light_subpath, trace_mmlt,
    )

    kmax = cfg.max_depth
    bcfg = BDPTConfig(max_depth=kmax)
    n_core = 1 + bcfg.eye_dims + bcfg.light_dims
    V = kmax + 1

    def sample_u(idx):
        return jax.random.uniform(jax.random.fold_in(key, idx),
                                  (n_core + 1,))

    batch = 8192
    n_batches = max(1, -(-n_bootstrap // batch))

    def lum_of(u):
        depth = jnp.clip((u[:, 0] * (kmax - cfg.kmin + 1)).astype(jnp.int32)
                         + cfg.kmin, cfg.kmin, kmax)
        sp = trace_mmlt(scene, bcfg, u[:, 1:], depth)
        lum = jnp.where(jnp.isfinite(sp.lum) & (sp.lum >= 0), sp.lum, 0.0)
        return lum * (kmax - cfg.kmin + 1)   # undo the depth pmf

    def body(carry, i):
        u = jax.vmap(sample_u)(i * batch + jnp.arange(batch))
        lum = lum_of(u)
        return carry + jnp.sum(lum), lum

    total, lums = jax.lax.scan(body, jnp.float32(0.0),
                               jnp.arange(n_batches))
    lums = lums.reshape(-1)
    b = total / lums.shape[0]

    cdf = jnp.cumsum(lums)
    upick = jax.random.uniform(jax.random.fold_in(key, 0x5EED),
                               (n_chains,)) * cdf[-1]
    idx = jnp.clip(jnp.searchsorted(cdf, upick), 0, lums.shape[0] - 1)
    u0 = jax.vmap(sample_u)(idx)

    # rebuild the winning paths' geometry from the subpaths
    depth = jnp.clip((u0[:, 0] * (kmax - cfg.kmin + 1)).astype(jnp.int32)
                     + cfg.kmin, cfg.kmin, kmax)
    u = u0[:, 1:]
    n_strats = (depth + 1).astype(jnp.float32)
    s_pick = jnp.minimum((u[:, 0] * n_strats).astype(jnp.int32), depth)
    t_pick = depth + 1 - s_pick
    E, _ = eye_subpath(scene, bcfg, u[:, 1:1 + bcfg.eye_dims])
    L = light_subpath(scene, bcfg, u[:, 1 + bcfg.eye_dims:
                                     1 + bcfg.eye_dims + bcfg.light_dims])

    C = n_chains
    pos = jnp.zeros((C, V, 3))
    ng = jnp.zeros((C, V, 3))
    mat = jnp.full((C, V), -1, jnp.int32)
    for i in range(V):
        fi = jnp.full((C,), i)
        on_eye = fi < t_pick
        # eye slot i; light slot: path index i >= t corresponds to light
        # subpath index s-1 - (i - t) = depth - i  (light: 0 = emitter)
        li = jnp.clip(depth - fi, 0, L.p.shape[1] - 1)
        ei = jnp.clip(fi, 0, E.p.shape[1] - 1)
        pos = pos.at[:, i].set(jnp.where(on_eye[:, None],
                                         _gslot(E.p, ei), _gslot(L.p, li)))
        ng = ng.at[:, i].set(jnp.where(on_eye[:, None],
                                       _gslot(E.ng, ei), _gslot(L.ng, li)))
        mat = mat.at[:, i].set(jnp.where(on_eye, _gslot(E.mat_id, ei),
                                         _gslot(L.mat_id, li)))
    # emitter row: s = 0 strategies end on an emitter hit by the eye walk
    em_eye = _gslot(E.emitter_id, jnp.clip(depth, 0, E.p.shape[1] - 1))
    em_l = L.emitter_id[:, 0]
    em = jnp.where(s_pick == 0, em_eye, em_l).astype(jnp.int32)
    # endpoints carry no material
    mat = mat.at[:, 0].set(-1)
    oh = jax.nn.one_hot(depth, V, dtype=mat.dtype)
    mat = mat * (1 - oh) + (-1) * oh
    ps = PathState(pos=pos, ng=ng, mat=mat, em=em, k=depth)
    return ps, b


# ---------------------------------------------------------------- driver
def mutate_once(scene: Scene, cfg: MLTConfig, key, state, which: str, res):
    """One Metropolis step of mutator `which` over the chain ensemble.

    state = (PathState, val, lum, pix); returns (new_state,
    (a, pval, plum, ppix)) — the acceptance probabilities plus the
    proposal's splat data, so callers can expected-value splat both
    sides.  Shared by render_mlt and the path-space ERPT driver
    (erpt.py — ref src/integrators/erpt/erpt_proc.cpp runs exactly
    these perturbations inside its redistribution chains)."""
    ps, val, lum, pix = state
    if which == "bidir":
        prop, a, ok = mut_bidir(scene, cfg, key, ps)
    elif which == "lens":
        prop, a, ok = mut_lens(scene, cfg, key, ps, *res)
    elif which == "mchain":
        prop, a, ok = mut_mchain(scene, cfg, key, ps, *res)
    else:
        prop, a, ok = mut_caustic(scene, cfg, key, ps)
    pval, plum, ppix, pok = eval_path(scene, prop, cfg.max_depth)
    # a zero-contribution proposal can never be accepted
    a = jnp.where(pok & (plum > 0), a, 0.0)
    accept = jax.random.uniform(jax.random.fold_in(key, 7),
                                a.shape) < a
    new_ps = jax.tree.map(
        lambda p, c: jnp.where(
            accept.reshape((-1,) + (1,) * (c.ndim - 1)), p, c),
        prop, ps)
    return (new_ps,
            jnp.where(accept[:, None], pval, val),
            jnp.where(accept, plum, lum),
            jnp.where(accept[:, None], ppix, pix)), \
        (a, pval, plum, ppix)


def render_mlt(scene: Scene, cfg: MLTConfig, film_cfg, root_key,
               n_steps: int, mutators=("bidir", "lens", "bidir",
                                       "caustic", "bidir", "mchain")):
    """Veach path-space MLT render (ref: mlt.cpp / mlt_proc.cpp).

    Cycles the mutator set per step; splats current/proposal with
    expected-value weights (1-a, a); develops with b like pssmlt."""
    from drmlt_mitsuba.render import film as filmlib

    kb, kr = jax.random.split(root_key)
    ps, b = build_seed_paths(scene, cfg, kb, cfg.n_chains, cfg.n_bootstrap)
    val, lum, pix, _ = eval_path(scene, ps, cfg.max_depth)
    # drop dead seeds' weight (lum 0 chains never splat)
    film = filmlib.new_film(film_cfg)
    res = (film_cfg.width, film_cfg.height)

    def one_step(state, key, which):
        return mutate_once(scene, cfg, key, state, which, res)

    @jax.jit
    def run(ps, val, lum, pix, film):
        def body(carry, i):
            state, film = carry
            key = jax.random.fold_in(kr, i)
            stats_acc = []
            for j, which in enumerate(mutators):
                kj = jax.random.fold_in(key, j)
                (state), (a, pval, plum, ppix) = one_step(
                    state, kj, which)
                ps_, val_, lum_, pix_ = state
                # expected-value splat: current w=(1-a), proposal w=a
                unit_c = jnp.where(
                    (lum_ > 0)[:, None],
                    val_ / jnp.maximum(lum_, 1e-30)[:, None], 0.0)
                unit_p = jnp.where(
                    (plum > 0)[:, None],
                    pval / jnp.maximum(plum, 1e-30)[:, None], 0.0)
                scale = jnp.asarray([film_cfg.width, film_cfg.height],
                                    jnp.float32)
                film = filmlib.splat(
                    film_cfg, film,
                    jnp.concatenate([pix_ * scale, ppix * scale]),
                    jnp.concatenate([unit_c, unit_p]),
                    jnp.concatenate([1.0 - a, a]), mode="splat")
                stats_acc.append(jnp.mean(a))
            return (state, film), jnp.stack(stats_acc)

        (state, film), stats = jax.lax.scan(
            body, ((ps, val, lum, pix), film),
            jnp.arange(n_steps // len(mutators)))
        return state, film, stats

    state, film, stats = run(ps, val, lum, pix, film)
    steps_eff = (n_steps // len(mutators)) * len(mutators)
    n_per_pixel = cfg.n_chains * steps_eff / film_cfg.npixels
    from drmlt_mitsuba.render import film as filmlib2
    img = filmlib2.develop(film_cfg, film, mode="splat",
                           scale=b / max(n_per_pixel, 1e-9))
    return img, dict(b=b, stats=stats, state=state)
