"""Ray-scene intersection (the analog of ShapeKDTree::rayIntersect,
include/mitsuba/render/skdtree.h:125).

Rays arrive in large batches (one per Markov chain / pixel lane), and
`intersect` / `occluded` run a chunked brute-force sweep over the triangle
soup: lax.scan over static-size chunks, with the (R, chunk) Moller-Trumbore
temporaries fused by XLA.  Spheres are tested analytically.

All functions broadcast over a single leading ray axis R.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from drmlt_mitsuba.core import struct
from drmlt_mitsuba.core.math import RAY_EPS, normalize, safe_sqrt
from drmlt_mitsuba.scene.types import Scene

INF = jnp.float32(3.0e38)

# static chunk size for the triangle sweep.  Timed on an H100 (65536 rays):
# 36 triangles 0.32 / 0.73 / 2.61 ms at chunks 256 / 1024 / 4096; 19.6k
# triangles 13.2 / 12.8 / 12.1 ms.  256 is best for small scenes and within
# 10 % of the best for the large one.
TRI_CHUNK = 256


@struct.dataclass
class Hit:
    """Surface interaction record (ref: Intersection, shape.h)."""
    valid: jnp.ndarray    # (R,) bool
    t: jnp.ndarray        # (R,)
    p: jnp.ndarray        # (R, 3) hit position
    ng: jnp.ndarray       # (R, 3) geometric normal (unit)
    ns: jnp.ndarray       # (R, 3) shading normal (unit)
    uv: jnp.ndarray       # (R, 2) barycentric / param coords
    tex_uv: jnp.ndarray   # (R, 2) interpolated texture coords
    mat_id: jnp.ndarray   # (R,) int32
    emitter_id: jnp.ndarray  # (R,) int32 (-1 = none)
    prim: jnp.ndarray     # (R,) int32 triangle index (or ~sphere_idx)


def _tri_sweep(tris, o, d, t_max, find_best: bool, motion=None, time=None,
               chunk: int = TRI_CHUNK):
    """Scan all triangles in chunks of `chunk`; returns (best_t, best_idx,
    best_b1, best_b2) or an any-hit mask when find_best is False.

    With (motion, time), each ray intersects the geometry LERPED to its
    own normalized shutter time (linear motion blur, ref
    src/shapes/deformable.cpp per-ray space-time lookup): v0(t) = v0 +
    t*dv0 etc.  Per-(ray, chunk) lerp costs one fma per vertex field —
    the same order as the Moller-Trumbore intermediates already paid."""
    T = tris.v0.shape[0]
    moving = motion is not None and time is not None
    pad = (-T) % chunk
    fields = [tris.v0, tris.e1, tris.e2]
    if moving:
        fields += [motion.dv0, motion.de1, motion.de2]
    if pad:
        padf = lambda a: jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], 0)
        fields = [padf(a) for a in fields]
        valid = jnp.concatenate([tris.valid, jnp.zeros((pad,), bool)], 0)
    else:
        valid = tris.valid
    n_chunks = fields[0].shape[0] // chunk
    fields = [a.reshape(n_chunks, chunk, 3) for a in fields]
    valid = valid.reshape(n_chunks, chunk)

    R = o.shape[0]
    o_ = o[:, None, :]
    d_ = d[:, None, :]
    tl = time[:, None, None] if moving else None

    def chunk_hits(fields_c):
        cvalid = fields_c[-1]
        if moving:
            cv0, ce1, ce2, cdv0, cde1, cde2 = fields_c[:-1]
            cv0 = cv0[None] + tl * cdv0[None]
            ce1 = ce1[None] + tl * cde1[None]
            ce2 = ce2[None] + tl * cde2[None]
        else:
            cv0, ce1, ce2 = (a[None] for a in fields_c[:-1])
        # Moller-Trumbore against one chunk: (R, chunk)
        pvec = jnp.cross(d_, ce2)
        det = jnp.sum(ce1 * pvec, axis=-1)
        ok = jnp.abs(det) > 1e-12
        inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        tvec = o_ - cv0
        b1 = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, ce1)
        b2 = jnp.sum(d_ * qvec, axis=-1) * inv_det
        t = jnp.sum(ce2 * qvec, axis=-1) * inv_det
        hit = (
            ok & cvalid[None]
            & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
            & (t > RAY_EPS) & (t < t_max[:, None])
        )
        return hit, t, b1, b2

    if not find_best:
        def body(any_hit, fields_c):
            hit, _, _, _ = chunk_hits(fields_c)
            return any_hit | jnp.any(hit, axis=-1), None

        any_hit, _ = jax.lax.scan(body, jnp.zeros((R,), bool),
                                  (*fields, valid))
        return any_hit

    def body(carry, fields_c):
        best_t, best_idx, best_b1, best_b2 = carry
        base = fields_c[-1]
        hit, t, b1, b2 = chunk_hits(fields_c[:-1])
        t = jnp.where(hit, t, INF)
        j = jnp.argmin(t, axis=-1)
        rows = jnp.arange(R)
        tj = t[rows, j]
        better = tj < best_t
        best_idx = jnp.where(better, base + j, best_idx)
        best_b1 = jnp.where(better, b1[rows, j], best_b1)
        best_b2 = jnp.where(better, b2[rows, j], best_b2)
        best_t = jnp.minimum(best_t, tj)
        return (best_t, best_idx, best_b1, best_b2), None

    base = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    init = (
        jnp.full((R,), INF),
        jnp.full((R,), -1, jnp.int32),
        jnp.zeros((R,)),
        jnp.zeros((R,)),
    )
    (best_t, best_idx, b1, b2), _ = jax.lax.scan(
        body, init, (*fields, valid, base)
    )
    return best_t, best_idx, b1, b2


def _sphere_hits(spheres, o, d, t_max):
    """Analytic sphere intersection; returns (t, idx) best over spheres."""
    oc = o[:, None, :] - spheres.center[None]          # (R, S, 3)
    b = jnp.sum(oc * d[:, None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - spheres.radius[None] ** 2
    disc = b * b - c
    ok = (disc >= 0.0) & spheres.valid[None]
    sq = safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where(t0 > RAY_EPS, t0, t1)
    hit = ok & (t > RAY_EPS) & (t < t_max[:, None])
    t = jnp.where(hit, t, INF)
    j = jnp.argmin(t, axis=-1)
    rows = jnp.arange(o.shape[0])
    return t[rows, j], j.astype(jnp.int32)


def intersect(scene: Scene, o, d, t_max=None, time=None) -> Hit:
    """Closest-hit query for a batch of rays (R, 3).

    `time` (R,) in [0,1]: per-ray shutter time for motion scenes
    (scene.motion is not None); each ray sees the geometry at its time."""
    R = o.shape[0]
    if t_max is None:
        t_max = jnp.full((R,), INF)
    moving = scene.motion is not None and time is not None
    tri_t, tri_idx, b1, b2 = _tri_sweep(
        scene.tris, o, d, t_max, find_best=True,
        motion=scene.motion if moving else None, time=time,
    )
    return _assemble_hit(scene, o, d, t_max, tri_t, tri_idx, b1, b2,
                         time=time if moving else None)


def _assemble_hit(scene: Scene, o, d, t_max, tri_t, tri_idx, b1, b2,
                  time=None) -> Hit:
    """Hit assembly with ONE packed-row lookup (one-hot matmul for small
    scenes) instead of a dozen separate gathers.  The row matrix is built
    from the live triangle fields (gradients flow; hoisted out of scans).
    With `time`, the winner's vertex fields lerp to the ray's shutter
    time before shading-frame construction (motion blur)."""
    from drmlt_mitsuba.ops.gather import onehot_gather, pack_rows

    tris_ = scene.tris
    tri_shade = pack_rows(
        tris_.v0, tris_.e1, tris_.e2, tris_.n0, tris_.n1, tris_.n2,
        tris_.uv0, tris_.uv1, tris_.uv2, tris_.mat_id, tris_.emitter_id,
    )
    sph_t, sph_idx = _sphere_hits(scene.spheres, o, d, t_max)
    use_sph = sph_t < tri_t
    t = jnp.where(use_sph, sph_t, tri_t)
    valid = t < INF

    ti = jnp.clip(tri_idx, 0, scene.tris.v0.shape[0] - 1)
    row = onehot_gather(tri_shade, ti)          # (R, 26)
    geo = row[:, 0:18]
    if time is not None and scene.motion is not None:
        mo = scene.motion
        drow = onehot_gather(
            pack_rows(mo.dv0, mo.de1, mo.de2, mo.dn0, mo.dn1, mo.dn2), ti)
        geo = geo + time[:, None] * drow
    v0 = geo[:, 0:3]
    e1 = geo[:, 3:6]
    e2 = geo[:, 6:9]
    p_tri = v0 + b1[:, None] * e1 + b2[:, None] * e2
    ng_tri = normalize(jnp.cross(e1, e2))
    w = 1.0 - b1 - b2
    ns_tri = normalize(
        w[:, None] * geo[:, 9:12] + b1[:, None] * geo[:, 12:15]
        + b2[:, None] * geo[:, 15:18]
    )
    uv_tri = jnp.stack([b1, b2], axis=-1)
    tex_tri = (
        w[:, None] * row[:, 18:20] + b1[:, None] * row[:, 20:22]
        + b2[:, None] * row[:, 22:24]
    )
    mat_tri = row[:, 24].astype(jnp.int32)
    emit_tri = row[:, 25].astype(jnp.int32)

    si = sph_idx
    # SAFE t for geometry construction: sphere-missing rays carry t = INF,
    # and inf positions NaN the reverse-mode pass through the masked
    # where (0 * NaN); the where below still selects the triangle fields
    t_sph = jnp.where(use_sph, sph_t, 1.0)
    p_sph = o + t_sph[:, None] * d
    ng_sph = normalize(p_sph - scene.spheres.center[si])
    mat_sph = scene.spheres.mat_id[si]
    emit_sph = scene.spheres.emitter_id[si]
    uv_sph = jnp.stack(
        [jnp.arccos(jnp.clip(ng_sph[..., 2], -1, 1)) / jnp.pi,
         (jnp.arctan2(ng_sph[..., 1], ng_sph[..., 0]) / (2 * jnp.pi)) + 0.5],
        axis=-1,
    )

    us = use_sph[:, None]
    return Hit(
        valid=valid,
        t=jnp.where(valid, t, INF),
        p=jnp.where(us, p_sph, p_tri),
        ng=jnp.where(us, ng_sph, ng_tri),
        ns=jnp.where(us, ng_sph, ns_tri),
        uv=jnp.where(us, uv_sph, uv_tri),
        tex_uv=jnp.where(us, uv_sph, tex_tri),
        mat_id=jnp.where(valid, jnp.where(use_sph, mat_sph, mat_tri), 0),
        emitter_id=jnp.where(valid,
                             jnp.where(use_sph, emit_sph, emit_tri), -1),
        prim=jnp.where(use_sph, ~si, tri_idx),
    )


def occluded(scene: Scene, o, d, t_max, time=None) -> jnp.ndarray:
    """Any-hit (shadow ray) query; t_max should already be shortened by eps."""
    moving = scene.motion is not None and time is not None
    tri_any = _tri_sweep(scene.tris, o, d, t_max, find_best=False,
                         motion=scene.motion if moving else None, time=time)
    sph_t, _ = _sphere_hits(scene.spheres, o, d, t_max)
    return tri_any | (sph_t < INF)
