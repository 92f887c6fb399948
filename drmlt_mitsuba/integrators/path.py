"""Unidirectional path tracer with NEE + MIS, as L(u).

Capability match for the reference `path` plugin (src/integrators/path/
path.cpp MIPathTracer: BSDF sampling + emitter sampling combined with the
power heuristic, Russian roulette after rrDepth) and the
PathSampler::EUnidirectional technique (src/libbidir/pathsampler.cpp:529-567)
that drives PSSMLT/DRMLT.

Batch form: a masked fixed-depth wavefront.  The whole batch of R lanes (one
per chain or pixel sample) advances together through `max_depth` bounces
under lax.scan; dead lanes carry zero throughput.  The function is pure in
the primary-sample matrix u (R, n_dims), so the same code serves
  * plain path tracing   (u ~ U[0,1)^n from jax.random)
  * MCMC                 (u = chain state)
  * gradients            (jax.grad through scene parameters)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from drmlt_mitsuba.core import struct
from drmlt_mitsuba.core.math import RAY_EPS, mis_power
from drmlt_mitsuba.core.spectrum import luminance
from drmlt_mitsuba.core import frame
from drmlt_mitsuba.integrators.layout import (
    BOUNCE_DIMS, OFF_BSDF_CMP, OFF_BSDF_U, OFF_LIGHT_PICK, OFF_MED_CHANNEL,
    OFF_MED_DIST, OFF_RR, SENSOR_DIMS, PathConfig,
)
from drmlt_mitsuba.ops.intersect import intersect, occluded
from drmlt_mitsuba.render.bsdf import (
    eval_bsdf, is_delta_kind, sample_bsdf,
)
from drmlt_mitsuba.render.emitter import (
    eval_emitter, eval_env, pdf_emitter_direct, sample_emitter_direct,
)
from drmlt_mitsuba.render.sensor import sample_ray
from drmlt_mitsuba.scene.types import Scene


@struct.dataclass
class Splats:
    """Fixed-size splat list for a batch of samples (ref: SplatList,
    include/mitsuba/bidir/pathsampler.h:317).  For the unidirectional
    technique there is exactly one splat per sample (S=1)."""
    pos: jnp.ndarray   # (R, S, 2) continuous [0,1)^2 film position
    value: jnp.ndarray  # (R, S, 3)
    lum: jnp.ndarray   # (R,) total luminance (MCMC target density)


def _albedo(scene: Scene, hit):
    """Textured albedo lookup (bilinear) with constant fallback; tex_id -2
    interpolates the mesh's per-vertex colors (vertexcolors texture)."""
    mat = scene.materials
    base = mat.albedo[hit.mat_id]
    tex_id = mat.tex_id[hit.mat_id]
    if scene.textures is not None:
        tex = scene.textures.data  # (N, H, W, 3)
        n, h, w, _ = tex.shape
        uv = hit.tex_uv
        x = jnp.clip(uv[..., 0] % 1.0, 0.0, 1.0) * (w - 1)
        y = jnp.clip(uv[..., 1] % 1.0, 0.0, 1.0) * (h - 1)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        x1 = jnp.minimum(x0 + 1, w - 1)
        y1 = jnp.minimum(y0 + 1, h - 1)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        ti = jnp.clip(tex_id, 0, n - 1)
        c00 = tex[ti, y0, x0]
        c01 = tex[ti, y0, x1]
        c10 = tex[ti, y1, x0]
        c11 = tex[ti, y1, x1]
        val = ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
               + (c10 * (1 - fx) + c11 * fx) * fy)
        base = jnp.where((tex_id >= 0)[..., None], val, base)
    if scene.vcolors is not None:
        prim = jnp.clip(hit.prim, 0, scene.vcolors.shape[0] - 1)
        vc = scene.vcolors[prim]           # (R, 3 corners, 3)
        b1, b2 = hit.uv[..., 0], hit.uv[..., 1]
        w0 = 1.0 - b1 - b2
        col = (w0[..., None] * vc[..., 0, :] + b1[..., None] * vc[..., 1, :]
               + b2[..., None] * vc[..., 2, :])
        sel = (tex_id == -2) & (hit.prim >= 0)
        base = jnp.where(sel[..., None], col, base)
    return base


def apply_normal_map(scene: Scene, hit, ns):
    """Perturb the shading normal from the material's tangent-space normal
    page (bumpmaps are baked to normal pages at load; ref:
    src/bsdfs/{bumpmap,normalmap}.cpp).  Tangents follow the triangle's uv
    parametrization; degenerate uvs fall back to the deterministic ONB."""
    from drmlt_mitsuba.core.math import normalize as _norm

    mat = scene.materials
    if not mat.has_normalmap or scene.textures is None:
        return ns
    ntid = mat.normal_tex_id[hit.mat_id]
    tex = scene.textures.data
    n_pages, h, w, _ = tex.shape
    uv = hit.tex_uv
    x = jnp.clip(uv[..., 0] % 1.0, 0.0, 1.0) * (w - 1)
    y = jnp.clip(uv[..., 1] % 1.0, 0.0, 1.0) * (h - 1)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    ti = jnp.clip(ntid, 0, n_pages - 1)
    val = ((tex[ti, y0, x0] * (1 - fx) + tex[ti, y0, x1] * fx) * (1 - fy)
           + (tex[ti, y1, x0] * (1 - fx) + tex[ti, y1, x1] * fx) * fy)
    n_ts = val * 2.0 - 1.0

    tris = scene.tris
    pi = jnp.clip(hit.prim, 0, tris.v0.shape[0] - 1)
    duv1 = tris.uv1[pi] - tris.uv0[pi]
    duv2 = tris.uv2[pi] - tris.uv0[pi]
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    t_uv = tris.e1[pi] * duv2[..., 1:2] - tris.e2[pi] * duv1[..., 1:2]
    t_fb = frame.to_world(ns, jnp.broadcast_to(
        jnp.asarray([1.0, 0.0, 0.0]), ns.shape))
    t = jnp.where((jnp.abs(det) > 1e-12)[..., None], t_uv, t_fb)
    t = t - ns * jnp.sum(t * ns, -1, keepdims=True)
    t_len = jnp.sqrt(jnp.maximum(jnp.sum(t * t, -1, keepdims=True), 1e-20))
    t = jnp.where(t_len > 1e-9, t / t_len, t_fb)
    b = jnp.cross(ns, t)
    n_new = _norm(t * n_ts[..., 0:1] + b * n_ts[..., 1:2]
                  + ns * jnp.maximum(n_ts[..., 2:3], 1e-3))
    use = (ntid >= 0) & (hit.prim >= 0)
    return jnp.where(use[..., None], n_new, ns)


def trace_paths(scene: Scene, cfg: PathConfig, u) -> Splats:
    """Trace a batch of camera paths from primary samples u (R, cfg.n_dims).

    Returns the SplatList: film position (= u[:, :2]) and RGB contribution.
    """
    R = u.shape[0]
    uv = u[:, 0:2]
    o, d = sample_ray(
        scene.camera, uv, u[:, 2:4] if cfg.thinlens else None
    )
    # motion blur: one shutter time per path, constant across its bounces
    # (ref: ray.time set once by the sensor, sensor.h:202)
    ray_time = (u[:, cfg.time_dim]
                if cfg.motion and scene.motion is not None else None)

    # reshape the per-bounce dims for lax.scan: (max_depth, R, BOUNCE_DIMS)
    ub = u[:, SENSOR_DIMS:SENSOR_DIMS + cfg.max_depth * BOUNCE_DIMS]
    ub = ub.reshape(R, cfg.max_depth, BOUNCE_DIMS).transpose(1, 0, 2)

    carry = dict(
        o=o,
        d=d,
        throughput=jnp.ones((R, 3)),
        L=jnp.zeros((R, 3)),
        active=jnp.ones((R,), bool),
        prev_pdf=jnp.zeros((R,)),      # bsdf pdf of the segment we're on
        prev_delta=jnp.ones((R,), bool),  # camera vertex counts as delta
        eta_scale=jnp.ones((R,)),
        # pipelined NEE: the shadow ray of bounce b resolves together with
        # the closest-hit of bounce b+1 in ONE fused sweep
        sh_o=o,
        sh_d=d,
        sh_tmax=jnp.zeros((R,)),
        sh_contrib=jnp.zeros((R, 3)),
    )

    medium = scene.medium
    # per-shape interior media (Scene.media): each lane tracks its current
    # medium id; -1 = exterior (the global homogeneous medium, or vacuum).
    # Row 0 of the packed table is the exterior so the gather is id+1.
    lane_media = (scene.media is not None
                  and scene.materials.interior_medium is not None)
    if lane_media:
        from drmlt_mitsuba.ops.gather import onehot_gather, pack_rows
        from drmlt_mitsuba.render.medium import HomogeneousMedium

        from drmlt_mitsuba.render.medium import (
            PHASE_KKAY, PHASE_MICROFLAKE, PHASE_MIXTURE,
        )

        ext_kind = 0
        ext_fiber = jnp.asarray([0.0, 0.0, 1.0])
        ext_pha = jnp.zeros(4)
        if isinstance(medium, HomogeneousMedium):
            ext = (medium.sigma_t, medium.albedo, jnp.reshape(medium.g, (1,)))
            ext_kind = getattr(medium, "phase_kind", 0)
            if ext_kind == PHASE_MIXTURE:
                # mixture exterior + interior media: fall back to HG
                ext_kind = 0
            if medium.fiber is not None:
                ext_fiber = medium.fiber
            if ext_kind == PHASE_KKAY:
                ext_pha = medium.ph_params
            elif ext_kind == PHASE_MICROFLAKE:
                # recover stddev from the S matrix: eps^2 = f^T S f
                eps2 = jnp.einsum("i,ij,j->", ext_fiber, medium.ph_params,
                                  ext_fiber,
                                  precision=jax.lax.Precision.HIGHEST)
                ext_pha = jnp.concatenate(
                    [jnp.sqrt(jnp.maximum(eps2, 1e-12))[None]
                     / jnp.sqrt(2.0), jnp.zeros(3)])
        else:   # vacuum exterior (heterogeneous globals are not lane-mixed)
            ext = (jnp.zeros(3), jnp.ones(3), jnp.zeros(1))
        mt = scene.media
        med_kind = (mt.phase_kind if mt.phase_kind is not None
                    else jnp.zeros(mt.g.shape, jnp.int32))
        med_fiber = (mt.fiber if mt.fiber is not None
                     else jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]),
                                           mt.sigma_t.shape))
        med_pha = (mt.ph_a if mt.ph_a is not None
                   else jnp.zeros(mt.g.shape + (4,)))
        med_packed = pack_rows(
            jnp.concatenate([ext[0][None], mt.sigma_t]),
            jnp.concatenate([ext[1][None], mt.albedo]),
            jnp.concatenate([ext[2], mt.g]),
            jnp.concatenate([jnp.asarray([ext_kind], jnp.float32),
                             med_kind.astype(jnp.float32)]),
            jnp.concatenate([ext_fiber[None], med_fiber]),
            jnp.concatenate([ext_pha[None], med_pha]),
        )
        lane_kinds = tuple(sorted(
            set(getattr(mt, "kinds_present", (0,))) | {int(ext_kind)}))
        carry["med"] = jnp.full((R,), -1, jnp.int32)
    any_media = lane_media or medium is not None

    def bounce(carry, xs):
        ub_b, depth = xs   # depth = 1-based segment count of the current ray
        # the previous bounce's pending NEE shadow ray resolves here
        hit = intersect(scene, carry["o"], carry["d"], time=ray_time)
        sh_blocked = occluded(scene, carry["sh_o"], carry["sh_d"],
                              carry["sh_tmax"], time=ray_time)
        active = carry["active"]
        tp = carry["throughput"]

        # ---- participating medium: distance sampling (volpath) -----------
        if lane_media:
            from drmlt_mitsuba.render.medium import (
                sample_distance_lanes, sigma_dir_lanes,
            )

            t_surf = jnp.where(hit.valid, hit.t, 1.0e7)
            mrow = onehot_gather(med_packed, carry["med"] + 1)
            sig_l, alb_l, g_l = mrow[:, 0:3], mrow[:, 3:6], mrow[:, 6]
            kind_l = mrow[:, 7].astype(jnp.int32)
            fiber_l, pha_l = mrow[:, 8:11], mrow[:, 11:15]
            # microflake rows: directional extinction along this ray
            sig_l = sig_l * sigma_dir_lanes(
                lane_kinds, kind_l, fiber_l, pha_l, carry["d"])[:, None]
            md = sample_distance_lanes(
                sig_l, alb_l, ub_b[:, OFF_MED_CHANNEL],
                ub_b[:, OFF_MED_DIST], t_surf,
            )
            scattered = md["scattered"] & active
            tp = tp * md["weight"]
            p_med = carry["o"] + md["t"][:, None] * carry["d"]
            eps_t = jnp.where(scattered, md["t"], jnp.minimum(hit.t, 1e7))
        elif medium is not None:
            from drmlt_mitsuba.render.medium import (
                HeterogeneousMedium, PHASE_MICROFLAKE, sample_distance,
                sample_distance_hetero,
            )

            t_surf = jnp.where(hit.valid, hit.t, 1.0e7)
            if isinstance(medium, HeterogeneousMedium):
                md = sample_distance_hetero(
                    medium, carry["o"], carry["d"],
                    ub_b[:, OFF_MED_CHANNEL], ub_b[:, OFF_MED_DIST], t_surf,
                )
            elif getattr(medium, "phase_kind", 0) == PHASE_MICROFLAKE:
                # directionally-varying extinction sigma_t * sigma(d)
                # (constant along a straight ray => per-lane homogeneous)
                from drmlt_mitsuba.render.medium import (
                    sample_distance_lanes, sigma_dir,
                )

                sig_d = medium.sigma_t[None, :] * sigma_dir(
                    medium, carry["d"])[:, None]
                md = sample_distance_lanes(
                    sig_d, jnp.broadcast_to(medium.albedo, sig_d.shape),
                    ub_b[:, OFF_MED_CHANNEL], ub_b[:, OFF_MED_DIST], t_surf,
                )
            else:
                md = sample_distance(
                    medium, ub_b[:, OFF_MED_CHANNEL],
                    ub_b[:, OFF_MED_DIST], t_surf,
                )
            scattered = md["scattered"] & active
            tp = tp * md["weight"]
            p_med = carry["o"] + md["t"][:, None] * carry["d"]
            # epsilon scale must stay finite for scattered lanes whose
            # surface hit is at infinity
            eps_t = jnp.where(scattered, md["t"], jnp.minimum(hit.t, 1e7))
        else:
            scattered = jnp.zeros((R,), bool)
            eps_t = hit.t

        # ---- emitted radiance at the hit (BSDF-sampling strategy) --------
        wi_world = -carry["d"]
        le = eval_emitter(scene, hit.emitter_id, wi_world, hit.ng)
        # MIS against NEE at the *previous* vertex; delta previous vertex
        # (or the camera) had no NEE competitor.
        nee_pdf = pdf_emitter_direct(
            scene, carry["o"], hit.emitter_id, hit.p, hit.ng
        )
        # without NEE there is no competing strategy: weight 1 (a biased
        # 40%-dark render otherwise; caught by the cpu_oracle cross-check)
        w_bsdf = jnp.where(
            carry["prev_delta"] | (not cfg.use_nee), 1.0,
            mis_power(carry["prev_pdf"], nee_pdf),
        )
        # resolve the previous bounce's pending NEE contribution
        L = carry["L"] + jnp.where(
            sh_blocked[:, None], 0.0, carry["sh_contrib"]
        )

        depth_ok = depth >= cfg.min_depth
        hit_emitter = (
            active & hit.valid & (hit.emitter_id >= 0) & depth_ok & ~scattered
        )
        L = L + jnp.where(
            hit_emitter[:, None], tp * le * w_bsdf[:, None], 0.0
        )

        # ---- subsurface (dipole BSSRDF) at the hit ------------------------
        # ref: path.cpp adds its.LoSub at EVERY intersected subsurface
        # shape; Lo is the dense Rd-weighted irradiance-cloud query
        # (render/subsurface.py — the octree's dense replacement)
        if scene.subsurface:
            from drmlt_mitsuba.render.subsurface import dipole_lo

            for sst in scene.subsurface:
                m_ss = (active & hit.valid & ~scattered
                        & (hit.mat_id == sst.mat_id) & depth_ok)
                lo_ss = dipole_lo(sst, hit.p, hit.ns, wi_world)
                L = L + jnp.where(m_ss[:, None], tp * lo_ss, 0.0)

        # ---- environment on escape ---------------------------------------
        escaped = active & ~hit.valid & depth_ok & ~scattered
        env = eval_env(scene, carry["d"])
        if scene.emitters.env_image is not None and cfg.use_nee:
            # MIS vs env NEE at the previous vertex
            from drmlt_mitsuba.render.emitter import env_pdf_dir

            e_pdf = env_pdf_dir(scene, carry["d"])
            w_env = jnp.where(
                carry["prev_delta"], 1.0,
                mis_power(carry["prev_pdf"], e_pdf),
            )
            env = env * w_env[:, None]
        L = L + jnp.where(escaped[:, None], tp * env, 0.0)

        active = (active & hit.valid) | scattered

        # ---- local frame -------------------------------------------------
        # flip shading normal to the side of the incident ray (two-sided
        # shading; the BSDF kinds decide transmission themselves)
        ns = apply_normal_map(scene, hit, hit.ns)
        wi = frame.to_local(ns, wi_world)
        albedo = _albedo(scene, hit)

        # ---- next-event estimation (visibility resolved next bounce) ------
        if cfg.use_nee:
            delta_mat = is_delta_kind(scene.materials, hit.mat_id)
            p_nee = hit.p if not any_media else jnp.where(
                scattered[:, None], p_med, hit.p
            )
            ds = sample_emitter_direct(scene, p_nee, ub_b[:, OFF_LIGHT_PICK:OFF_LIGHT_PICK + 3])
            wo_l = frame.to_local(ns, ds.d)
            f_val, f_pdf = eval_bsdf(scene.materials, hit.mat_id, albedo,
                                     wi, wo_l, irawan=scene.irawan,
                                     uv=hit.tex_uv)
            if any_media:
                from drmlt_mitsuba.render.medium import (
                    HeterogeneousMedium, hg_phase, phase_eval_dir,
                    phase_pdf_dir, transmittance, transmittance_hetero,
                )

                if lane_media:
                    from drmlt_mitsuba.render.medium import (
                        phase_eval_lanes, phase_pdf_lanes,
                    )

                    ph_v = phase_eval_lanes(lane_kinds, kind_l, g_l,
                                            fiber_l, pha_l, -carry["d"],
                                            ds.d)
                    ph_pdf = phase_pdf_lanes(lane_kinds, kind_l, g_l,
                                             fiber_l, pha_l, -carry["d"],
                                             ds.d)
                elif (isinstance(medium, HeterogeneousMedium)
                        and medium.orient_grid is not None):
                    # per-voxel fiber orientation at the scatter point
                    from drmlt_mitsuba.render.medium import (
                        hetero_phase_ctx, phase_eval_lanes,
                        phase_pdf_lanes,
                    )

                    hk, hg_, hf, hp = hetero_phase_ctx(medium, p_med)
                    hkinds = (medium.phase_kind,)
                    ph_v = phase_eval_lanes(hkinds, hk, hg_, hf, hp,
                                            -carry["d"], ds.d)
                    ph_pdf = phase_pdf_lanes(hkinds, hk, hg_, hf, hp,
                                             -carry["d"], ds.d)
                else:
                    ph_v = phase_eval_dir(medium, -carry["d"], ds.d)
                    ph_pdf = phase_pdf_dir(medium, -carry["d"], ds.d)
                # phase "BSDF" (albedo already applied by the
                # distance-sampling weight); pdf can differ from the value
                # for kkay's uniform-sphere sampler
                f_val = jnp.where(scattered[:, None], ph_v[:, None], f_val)
                f_pdf = jnp.where(scattered, ph_pdf, f_pdf)
                delta_mat = delta_mat & ~scattered
            nee_ok = (
                active & ~delta_mat & (ds.pdf > 0)
                & (luminance(f_val) > 0) & (depth + 1 <= cfg.max_depth)
                & (depth + 1 >= cfg.min_depth)
            )
            shadow_o = p_nee + ds.d * RAY_EPS * jnp.maximum(1.0, eps_t)[:, None]
            # delta emitters (point/spot/directional) have no BSDF-sampling
            # competitor: MIS weight 1
            w_nee = jnp.where(ds.delta, 1.0, mis_power(ds.pdf, f_pdf))
            contrib = tp * f_val * ds.radiance * (w_nee / jnp.maximum(ds.pdf, 1e-20))[:, None]
            if lane_media:
                from drmlt_mitsuba.render.medium import (
                    sigma_dir_lanes, transmittance_lanes,
                )

                # shadow ray attenuated by the lane's CURRENT medium (the
                # fused occlusion sweep blocks any boundary crossing, so
                # the segment stays inside one medium); microflake rows
                # re-project sigma along the shadow direction
                sig_sh = mrow[:, 0:3] * sigma_dir_lanes(
                    lane_kinds, kind_l, fiber_l, pha_l, ds.d)[:, None]
                contrib = contrib * transmittance_lanes(sig_sh, ds.dist)
            elif medium is not None:
                if isinstance(medium, HeterogeneousMedium):
                    contrib = contrib * transmittance_hetero(
                        medium, shadow_o, ds.d, ds.dist,
                        ub_b[:, OFF_MED_DIST],
                    )
                else:
                    from drmlt_mitsuba.render.medium import sigma_dir

                    # sigma_dir = 1 except for microflake media, whose
                    # extinction varies with the shadow-ray direction
                    contrib = contrib * jnp.exp(
                        -medium.sigma_t[None, :]
                        * sigma_dir(medium, ds.d)[:, None]
                        * ds.dist[:, None])
            sh_contrib = jnp.where(nee_ok[:, None], contrib, 0.0)
            sh_o = shadow_o
            sh_d = ds.d
            sh_tmax = jnp.where(nee_ok, ds.dist * (1.0 - 1e-3) - RAY_EPS, 0.0)
        else:
            sh_contrib = jnp.zeros((R, 3))
            sh_o = hit.p
            sh_d = carry["d"]
            sh_tmax = jnp.zeros((R,))

        # ---- BSDF sampling ------------------------------------------------
        bs = sample_bsdf(
            scene.materials, hit.mat_id, albedo, wi,
            ub_b[:, OFF_BSDF_CMP:OFF_BSDF_CMP + 3],
            irawan=scene.irawan, uv=hit.tex_uv,
        )
        wo_world = frame.to_world(ns, bs.wo)
        bs_weight = bs.weight
        bs_pdf = bs.pdf
        bs_delta = bs.delta
        if any_media:
            from drmlt_mitsuba.render.medium import (
                phase_sample_dir, sample_hg,
            )

            if lane_media:
                from drmlt_mitsuba.render.medium import (
                    phase_sample_lanes,
                )

                wo_ph, pdf_ph, val_ph = phase_sample_lanes(
                    lane_kinds, kind_l, g_l, fiber_l, pha_l, -carry["d"],
                    ub_b[:, OFF_BSDF_U:OFF_BSDF_U + 2])
                w_ph = val_ph / jnp.maximum(pdf_ph, 1e-20)
            else:
                from drmlt_mitsuba.render.medium import (
                    HeterogeneousMedium as _Het,
                )

                if (isinstance(medium, _Het)
                        and medium.orient_grid is not None):
                    from drmlt_mitsuba.render.medium import (
                        hetero_phase_ctx, phase_sample_lanes,
                    )

                    hk, hg_, hf, hp = hetero_phase_ctx(medium, p_med)
                    wo_ph, pdf_ph, val_ph = phase_sample_lanes(
                        (medium.phase_kind,), hk, hg_, hf, hp,
                        -carry["d"], ub_b[:, OFF_BSDF_U:OFF_BSDF_U + 2])
                else:
                    wo_ph, pdf_ph, val_ph = phase_sample_dir(
                        medium, -carry["d"],
                        ub_b[:, OFF_BSDF_U:OFF_BSDF_U + 2])
                w_ph = val_ph / jnp.maximum(pdf_ph, 1e-20)
            wo_world = jnp.where(scattered[:, None], wo_ph, wo_world)
            # estimator weight value/pdf (1 for perfectly-sampled kinds)
            bs_weight = jnp.where(
                scattered[:, None], w_ph[:, None], bs_weight)
            bs_pdf = jnp.where(scattered, pdf_ph, bs_pdf)
            bs_delta = jnp.where(scattered, False, bs_delta)
        tp = tp * bs_weight
        eta_scale = carry["eta_scale"] * bs.eta
        alive = active & (luminance(tp) > 0) & (depth + 1 <= cfg.max_depth)

        # ---- russian roulette (ref: path.cpp rr after rrDepth) ------------
        u_rr = ub_b[:, OFF_RR]
        q = jnp.minimum(jnp.max(tp, axis=-1) * eta_scale * eta_scale, 0.95)
        do_rr = depth >= cfg.rr_depth
        survive = jnp.where(do_rr, u_rr < q, True)
        tp = jnp.where(
            (do_rr & survive)[:, None], tp / jnp.maximum(q, 1e-8)[:, None], tp
        )
        alive = alive & survive

        origin = hit.p if not any_media else jnp.where(
            scattered[:, None], p_med, hit.p
        )
        new_o = origin + wo_world * RAY_EPS * jnp.maximum(1.0, eps_t)[:, None]
        if lane_media:
            # medium transition: a transmissive crossing of a material that
            # declares an interior medium switches the lane's medium
            # (entering -> interior row, exiting -> exterior -1); materials
            # without an interior are not boundaries (ref convention:
            # shapes without medium refs don't change the medium)
            interior = onehot_gather(
                pack_rows(scene.materials.interior_medium), hit.mat_id
            )[:, 0].astype(jnp.int32)
            crossed = (active & ~scattered & hit.valid
                       & (bs.wo[..., 2] * wi[..., 2] < 0))
            going_in = jnp.sum(wo_world * hit.ng, -1) < 0
            med_new = jnp.where(
                crossed & (interior >= 0),
                jnp.where(going_in, interior, -1), carry["med"],
            )
        carry_out = dict(
            o=jnp.where(active[:, None], new_o, carry["o"]),
            d=jnp.where(active[:, None], wo_world, carry["d"]),
            throughput=jnp.where(alive[:, None], tp, 0.0),
            L=L,
            active=alive,
            prev_pdf=bs_pdf,
            prev_delta=bs_delta,
            eta_scale=eta_scale,
            sh_o=sh_o,
            sh_d=sh_d,
            sh_tmax=sh_tmax,
            sh_contrib=sh_contrib,
        )
        if lane_media:
            carry_out["med"] = med_new
        return carry_out, None

    depths = jnp.arange(1, cfg.max_depth + 1)
    carry, _ = jax.lax.scan(bounce, carry, (ub, depths))

    # resolve the final bounce's pending NEE
    last_blocked = occluded(
        scene, carry["sh_o"], carry["sh_d"], carry["sh_tmax"],
        time=ray_time,
    )
    value = carry["L"] + jnp.where(
        last_blocked[:, None], 0.0, carry["sh_contrib"]
    )
    return Splats(
        pos=uv[:, None, :],
        value=value[:, None, :],
        lum=luminance(value),
    )


def make_path_trace(scene: Scene, cfg: PathConfig):
    """trace(u)->Splats for MCMC: u may carry padding dims past cfg.n_dims
    (orbital needs an even dimension count)."""

    def trace(u):
        return trace_paths(scene, cfg, u[:, : cfg.n_dims])

    return trace


def render_pt(scene: Scene, cfg: PathConfig, key, n_samples: int, film_cfg,
              mode: str = "accum", sampler: str = "independent"):
    """Plain Monte-Carlo render: n_samples random paths splatted to a film.

    `sampler` picks the sample generator for the PSS vectors (ref: the
    sampler plugins drive the forward integrators; MLT legally uses only
    independent) — independent/stratified/halton/hammersley/ldsampler/
    sobol via render.sampler.make_sampler.

    Returns the raw film (H, W, 4); develop with render.film.develop.
    """
    from drmlt_mitsuba.render import film as filmlib
    from drmlt_mitsuba.render.sampler import make_sampler

    chunk = 16384
    n_chunks = max(1, -(-n_samples // chunk))
    scale = jnp.array([film_cfg.width, film_cfg.height], jnp.float32)
    trace = make_path_trace(scene, cfg)
    sample_fn = make_sampler(sampler)

    @jax.jit
    def run():
        def body(film, i):
            if sampler == "independent":
                u = jax.random.uniform(jax.random.fold_in(key, i),
                                       (chunk, cfg.n_dims))
            else:
                u = sample_fn(key, i * chunk, chunk, cfg.n_dims,
                              n_chunks * chunk)
            sp = trace(u)
            film = filmlib.splat(
                film_cfg, film, sp.pos[:, 0, :] * scale, sp.value[:, 0, :],
                mode=mode,
            )
            return film, None

        f = filmlib.new_film(film_cfg)
        f, _ = jax.lax.scan(body, f, jnp.arange(n_chunks))
        return f

    return run()
