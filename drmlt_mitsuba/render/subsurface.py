"""Dipole BSSRDF subsurface scattering (ref: src/subsurface/dipole.cpp).

The reference preprocesses a blue-noise point set over the subsurface
shapes, gathers per-point irradiance, and answers shading-time queries
Lo(xo, wo) = (1-Fr(cos)) / pi * sum_i Rd(|xo - xi|) E_i A_i through a
hierarchical irradiance octree (dipole.cpp:335-442, irrtree.cpp).

Dense design: there is NO octree.  The query is a dense
Rd-weighted reduction over ALL sample points — an (R, N) elementwise
kernel feeding a (R,N)x(N,3) contraction.  For the
point-set sizes the octree was built to make tractable on a scalar CPU
(N ~ 1e3-1e4), the dense form is both faster on this hardware and
exact (no quality/error-threshold knob needed; the reference's
`quality` parameter controls octree approximation error and is
intentionally absent).  Point placement uses stratified area sampling
(one strata block per triangle, area-proportional counts) instead of
blue-noise dart throwing — same expected density, documented deviation.

Irradiance at each point is gathered with M emitter-direct samples plus
an optional K-sample cosine-hemisphere indirect pass through the path
tracer (the reference's irrSamples / irrIndirect, dipole.cpp:279-281).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.core import struct

_INV_PI = 1.0 / np.pi


@struct.dataclass
class DipoleParams:
    """Per-material dipole coefficients (dipole.cpp configure())."""
    zr: jnp.ndarray        # (3,) real source depth = 1/sigma_t'
    zv: jnp.ndarray        # (3,) virtual source depth = zr(1 + 4/3 A)
    sigma_tr: jnp.ndarray  # (3,) effective transport coefficient
    eta: jnp.ndarray       # () relative IOR


@struct.dataclass
class DipoleTable:
    """Preprocessed irradiance point cloud for ONE subsurface instance."""
    points: jnp.ndarray      # (N, 3)
    irradiance: jnp.ndarray  # (N, 3)
    area: jnp.ndarray        # (N,) per-point area weight (total area / N)
    params: DipoleParams
    mat_id: int = struct.field(pytree_node=False, default=0)


def fresnel_diffuse_reflectance(inv_eta: float) -> float:
    """Polynomial fit used by the reference (fresnelDiffuseReflectance,
    libcore/util.cpp) for eta approximations."""
    e = float(inv_eta)
    if e < 1.0:
        return float(-0.4399 + 0.7099 / (1 / e) - 0.3319 / (1 / e) ** 2
                     + 0.0636 / (1 / e) ** 3)
    return float(-1.4399 / (e * e) + 0.7099 / e + 0.6681 + 0.0636 * e)


def dipole_params(sigma_s, sigma_a, g=0.0, eta=1.33) -> DipoleParams:
    """dipole.cpp configure(): reduced coefficients -> dipole sources."""
    sigma_s = jnp.asarray(sigma_s, jnp.float32)
    sigma_a = jnp.asarray(sigma_a, jnp.float32)
    sigma_s_p = sigma_s * (1.0 - g)
    sigma_t_p = jnp.maximum(sigma_s_p + sigma_a, 1e-6)
    mfp = 1.0 / sigma_t_p
    fdr = fresnel_diffuse_reflectance(1.0 / float(eta))
    a_bc = (1.0 + fdr) / (1.0 - fdr)
    sigma_tr = jnp.sqrt(3.0 * sigma_a * sigma_t_p)
    return DipoleParams(
        zr=mfp, zv=mfp * (1.0 + 4.0 / 3.0 * a_bc), sigma_tr=sigma_tr,
        eta=jnp.float32(eta),
    )


def rd(params: DipoleParams, r2):
    """Diffuse reflectance kernel Rd(r^2) per channel; r2 (...,) ->
    (..., 3).  Mirrors IsotropicDipoleQuery (dipole.cpp:35-57) including
    its alpha'-free normalization (the 1/(4 pi) factor; the reference
    folds alpha' into the irradiance-octree weights via its own Rd)."""
    r2 = r2[..., None]
    zr, zv, st = params.zr, params.zv, params.sigma_tr
    dr = jnp.sqrt(r2 + zr * zr)
    dv = jnp.sqrt(r2 + zv * zv)
    c1 = zr * (st + 1.0 / dr)
    c2 = zv * (st + 1.0 / dv)
    val = 0.25 * _INV_PI * (c1 * jnp.exp(-st * dr) / (dr * dr)
                            + c2 * jnp.exp(-st * dv) / (dv * dv))
    return jnp.maximum(val, 0.0)


def sample_surface_points(scene, mat_id: int, n_points: int, key):
    """Stratified area-proportional point set over the material's
    triangles.  Returns (points (N,3), normals (N,3), total_area)."""
    tris = scene.tris
    sel = (np.asarray(tris.mat_id) == mat_id) & np.asarray(tris.valid)
    idx = np.nonzero(sel)[0]
    if idx.size == 0:
        raise ValueError(f"no triangles with mat_id {mat_id}")
    e1 = np.asarray(tris.e1)[idx]
    e2 = np.asarray(tris.e2)[idx]
    v0 = np.asarray(tris.v0)[idx]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total = float(area.sum())
    # area-proportional counts, at least 1 per triangle
    counts = np.maximum(1, np.round(n_points * area / total)).astype(int)
    tri_of = np.repeat(np.arange(idx.size), counts)
    n = int(tri_of.size)
    u = np.asarray(jax.random.uniform(key, (n, 2)))
    # uniform triangle warp (sqrt parameterization)
    su = np.sqrt(u[:, 0:1])
    b1 = 1.0 - su
    b2 = u[:, 1:2] * su
    p = v0[tri_of] + b1 * e1[tri_of] + b2 * e2[tri_of]
    ng = np.cross(e1[tri_of], e2[tri_of])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    return (jnp.asarray(p, jnp.float32), jnp.asarray(ng, jnp.float32),
            total)


def gather_irradiance(scene, points, normals, key, n_samples: int = 16,
                      indirect: bool = True, max_depth: int = 4):
    """Per-point irradiance E_i: M emitter-direct samples (cosine-weighted
    visibility sum, the irradiance estimator) + optional cosine-hemisphere
    indirect bounce through trace_scene_radiance (irrIndirect)."""
    from drmlt_mitsuba.core.warp import square_to_cosine_hemisphere
    from drmlt_mitsuba.core.frame import to_world as frame_to_world
    from drmlt_mitsuba.ops.intersect import occluded
    from drmlt_mitsuba.render.emitter import sample_emitter_direct

    n = points.shape[0]
    eps = 1e-3
    p_off = points + eps * normals
    e_acc = jnp.zeros((n, 3))
    for i in range(n_samples):
        u3 = jax.random.uniform(jax.random.fold_in(key, i), (n, 3))
        ds = sample_emitter_direct(scene, p_off, u3)
        cos_i = jnp.sum(ds.d * normals, axis=-1)
        vis = ~occluded(scene, p_off, ds.d, ds.dist * (1 - 1e-3))
        w = jnp.where((cos_i > 0) & vis & (ds.pdf > 0),
                      cos_i / jnp.maximum(ds.pdf, 1e-12), 0.0)
        e_acc = e_acc + ds.radiance * w[:, None]
    e_direct = e_acc / n_samples

    e_ind = jnp.zeros((n, 3))
    if indirect:
        k2 = jax.random.fold_in(key, 10_000)
        n_ind = max(4, n_samples // 2)
        for i in range(n_ind):
            u2 = jax.random.uniform(jax.random.fold_in(k2, i), (n, 2))
            d_loc = square_to_cosine_hemisphere(u2)
            d_w = frame_to_world(normals, d_loc)
            # cosine-weighted estimator: E += pi * mean(L_in)
            # (pdf = cos/pi cancels the cosine)
            li = _radiance_probe(scene, p_off, d_w,
                                 jax.random.fold_in(k2, 777 + i),
                                 max_depth)
            e_ind = e_ind + jnp.pi * li
        e_ind = e_ind / n_ind
    return e_direct + e_ind


def _radiance_probe(scene, o, d, key, max_depth: int):
    """Incident radiance L(o <- d): a compact NEE-only path trace from
    arbitrary rays (the reference gathers indirect irradiance with the
    scene's full integrator, irrproc.cpp; this probe skips MIS and counts
    emission only at the FIRST hit — later hits are NEE-lit — a standard
    NEE-only estimator that slightly undercounts emitters seen through
    specular chains, fine for a smooth irradiance precompute)."""
    from drmlt_mitsuba.integrators.path import _albedo
    from drmlt_mitsuba.ops.intersect import intersect, occluded
    from drmlt_mitsuba.render.bsdf import eval_bsdf, sample_bsdf
    from drmlt_mitsuba.render.emitter import (
        eval_emitter, sample_emitter_direct,
    )

    n = o.shape[0]
    tp = jnp.ones((n, 3))
    L = jnp.zeros((n, 3))
    active = jnp.ones((n,), bool)
    eps = 1e-3
    for b in range(max_depth):
        hit = intersect(scene, o, d)
        active = active & hit.valid
        if b == 0:
            le = eval_emitter(scene, hit.emitter_id, -d, hit.ng)
            L = L + jnp.where((active & (hit.emitter_id >= 0))[:, None],
                              tp * le, 0.0)
        # NEE at the hit
        u3 = jax.random.uniform(jax.random.fold_in(key, 2 * b), (n, 3))
        ds = sample_emitter_direct(scene, hit.p + eps * hit.ng, u3)
        wi_l = _to_local(hit.ns, -d)
        wo_l = _to_local(hit.ns, ds.d)
        alb = _albedo(scene, hit)
        f, _ = eval_bsdf(scene.materials, hit.mat_id, alb, wi_l, wo_l)
        vis = ~occluded(scene, hit.p + eps * hit.ng, ds.d,
                        ds.dist * (1 - 1e-3))
        contrib = tp * f * ds.radiance / jnp.maximum(ds.pdf, 1e-12)[:, None]
        L = L + jnp.where((active & vis & (ds.pdf > 0))[:, None],
                          contrib, 0.0)
        if b + 1 == max_depth:
            break
        # continue the walk
        ub = jax.random.uniform(jax.random.fold_in(key, 2 * b + 1), (n, 3))
        bs = sample_bsdf(scene.materials, hit.mat_id, alb, wi_l, ub)
        d_new = _from_local(hit.ns, bs.wo)
        tp = tp * bs.weight
        active = active & (jnp.abs(bs.weight).sum(-1) > 0)
        o = hit.p + eps * jnp.sign(
            jnp.sum(d_new * hit.ng, -1))[:, None] * hit.ng
        d = d_new
    return L


def _to_local(n, v):
    from drmlt_mitsuba.core import frame
    return frame.to_local(n, v)


def _from_local(n, v):
    from drmlt_mitsuba.core import frame
    return frame.to_world(n, v)


def prepare_dipole(scene, mat_id: int, sigma_s, sigma_a, g=0.0, eta=1.33,
                   n_points: int = 2048, irr_samples: int = 16,
                   indirect: bool = True, key=None) -> DipoleTable:
    """Full preprocess (dipole.cpp preprocess()): point set + irradiance.
    The returned table attaches to Scene.subsurface (a tuple, one entry
    per subsurface instance)."""
    if key is None:
        key = jax.random.PRNGKey(1234)
    pts, nrm, total_area = sample_surface_points(
        scene, mat_id, n_points, jax.random.fold_in(key, 0))
    irr = gather_irradiance(scene, pts, nrm, jax.random.fold_in(key, 1),
                            n_samples=irr_samples, indirect=indirect)
    n = pts.shape[0]
    return DipoleTable(
        points=pts, irradiance=irr,
        area=jnp.full((n,), total_area / n, jnp.float32),
        params=dipole_params(sigma_s, sigma_a, g, eta),
        mat_id=int(mat_id),
    )


def dipole_lo(table: DipoleTable, p, ns, wo):
    """Shading-time query Lo(xo, wo) (dipole.cpp Lo()): dense Rd-weighted
    sum over the point cloud, times (1 - Fr(cos)) / pi.

    p (R,3), ns (R,3), wo (R,3) unit outgoing (toward camera).
    The (R,N) pairwise term feeds one (R,N)x(N,3) contraction per query,
    no tree traversal."""
    from drmlt_mitsuba.core.math import fresnel_dielectric

    diff = p[:, None, :] - table.points[None, :, :]      # (R, N, 3)
    r2 = jnp.sum(diff * diff, axis=-1)                   # (R, N)
    w = rd(table.params, r2)                             # (R, N, 3)
    ew = table.irradiance * table.area[:, None]          # (N, 3)
    mo = jnp.einsum("rnc,nc->rc", w, ew,
                    precision=jax.lax.Precision.HIGHEST)
    cos_o = jnp.sum(ns * wo, axis=-1)
    fr, _, _ = fresnel_dielectric(jnp.abs(cos_o),
                                  table.params.eta[None] * jnp.ones_like(
                                      cos_o))
    lo = _INV_PI * (1.0 - fr)[:, None] * mo
    return jnp.where((cos_o > 0)[:, None], lo, 0.0)
