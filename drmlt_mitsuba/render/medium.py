"""Participating media: homogeneous medium + Henyey-Greenstein phase.

Capability match for src/medium/homogeneous.cpp and src/phase/hg.cpp (the
sensible volumetric subset per SURVEY §2.6): chromatic sigma_t with
single-channel distance sampling (pick channel uniformly, MIS over channels
via the mean-pdf), scattering albedo, HG directional sampling with perfect
importance (weight 1).

The medium is global (camera/exterior); per-shape interior media are a
round-2 extension.
"""
from __future__ import annotations

import jax.numpy as jnp

from drmlt_mitsuba.core import struct
from drmlt_mitsuba.core.math import safe_div


PHASE_HG = 0
PHASE_RAYLEIGH = 1
PHASE_KKAY = 2         # Kajiya-Kay fiber phase (ref: src/phase/kkay.cpp)
PHASE_MICROFLAKE = 3   # SGGX microflake (ref: src/phase/microflake.cpp)
PHASE_MIXTURE = 4      # weighted lobes (ref: src/phase/mixturephase.cpp)


@struct.dataclass
class HomogeneousMedium:
    sigma_t: jnp.ndarray   # (3,) extinction
    albedo: jnp.ndarray    # (3,) single-scattering albedo sigma_s/sigma_t
    g: jnp.ndarray         # scalar HG asymmetry
    phase_kind: int = struct.field(pytree_node=False, default=PHASE_HG)
    # kkay: (4,) [ks, kd, exponent, normalization]; microflake: (3,3) SGGX S
    ph_params: jnp.ndarray | None = None
    fiber: jnp.ndarray | None = None      # (3,) fiber orientation
    mix_w: jnp.ndarray | None = None      # (K,) mixture weights (sum 1)
    mix_g: jnp.ndarray | None = None      # (K,) per-component g
    mix_kinds: tuple = struct.field(pytree_node=False, default=())


def make_medium(sigma_t, albedo, g=0.0, phase_kind: int = PHASE_HG,
                fiber=(0.0, 0.0, 1.0), kkay=(0.4, 0.2, 4.0), stddev=0.3,
                mixture=None) -> HomogeneousMedium:
    """mixture: list of (kind_str 'hg'|'rayleigh'|'isotropic', g, weight)."""
    from drmlt_mitsuba.render import phase as ph

    fiber_v = jnp.asarray(fiber, jnp.float32).reshape(3)
    fiber_v = fiber_v / jnp.maximum(jnp.linalg.norm(fiber_v), 1e-12)
    ph_params = None
    mix_w = mix_g = None
    mix_kinds = ()
    if phase_kind == PHASE_KKAY:
        ks, kd, expo = kkay
        ph_params = jnp.asarray(
            [ks, kd, expo, ph.kkay_normalization(float(expo))], jnp.float32)
    elif phase_kind == PHASE_MICROFLAKE:
        ph_params = ph.sggx_fiber_S(fiber_v, jnp.float32(stddev))
    elif phase_kind == PHASE_MIXTURE:
        kinds, gs, ws = [], [], []
        for kind_s, g_k, w_k in mixture:
            kinds.append(PHASE_RAYLEIGH if kind_s == "rayleigh" else PHASE_HG)
            gs.append(0.0 if kind_s == "isotropic" else float(g_k))
            ws.append(float(w_k))
        tot = sum(ws)
        mix_kinds = tuple(kinds)
        mix_g = jnp.asarray(gs, jnp.float32)
        mix_w = jnp.asarray([w / tot for w in ws], jnp.float32)
    return HomogeneousMedium(
        sigma_t=jnp.asarray(sigma_t, jnp.float32).reshape(3),
        albedo=jnp.asarray(albedo, jnp.float32).reshape(3),
        g=jnp.float32(g),
        phase_kind=phase_kind,
        ph_params=ph_params,
        fiber=fiber_v,
        mix_w=mix_w,
        mix_g=mix_g,
        mix_kinds=mix_kinds,
    )


def transmittance(med: HomogeneousMedium, dist):
    """exp(-sigma_t * d) per channel; dist (...,) -> (..., 3)."""
    return jnp.exp(-med.sigma_t * dist[..., None])


def sample_distance(med: HomogeneousMedium, u_channel, u_dist, t_surface):
    """Sample a scattering distance along the ray (ref:
    HomogeneousMedium::sampleDistance).

    Returns dict with:
      scattered: (R,) bool — medium event before the surface
      t:         (R,) sampled distance (= t_surface when not scattered)
      weight:    (R, 3) throughput factor (includes sigma_s on scatter),
                 i.e. tr*sigma_s/pdf_scatter or tr/pdf_escape.
    """
    c = jnp.minimum((u_channel * 3).astype(jnp.int32), 2)
    sig_c = med.sigma_t[c]
    t_m = -jnp.log(jnp.maximum(1.0 - u_dist, 1e-38)) / jnp.maximum(sig_c, 1e-20)
    scattered = t_m < t_surface
    t = jnp.where(scattered, t_m, t_surface)
    tr = jnp.exp(-med.sigma_t * t[..., None])       # (R, 3)
    # channel-averaged pdfs (one-sample MIS over the 3 channels)
    pdf_scatter = jnp.mean(med.sigma_t * tr, axis=-1)
    pdf_escape = jnp.mean(tr, axis=-1)
    sigma_s = med.sigma_t * med.albedo
    w_scatter = tr * sigma_s / jnp.maximum(pdf_scatter, 1e-30)[..., None]
    w_escape = tr / jnp.maximum(pdf_escape, 1e-30)[..., None]
    weight = jnp.where(scattered[..., None], w_scatter, w_escape)
    return dict(scattered=scattered, t=t, weight=weight,
                pdf_scatter=pdf_scatter, pdf_escape=pdf_escape)


def distance_pdfs(med: HomogeneousMedium, dist):
    """(pdf_scatter_density, pdf_escape_mass) of the channel-MIS distance
    sampler at `dist` — the per-edge factors a volumetric path pdf carries
    (used by the bidir MIS; ref: medium pdfs in vertex.cpp/edge.cpp)."""
    tr = jnp.exp(-med.sigma_t * dist[..., None])
    return (jnp.mean(med.sigma_t * tr, axis=-1), jnp.mean(tr, axis=-1))


def sample_distance_lanes(sigma_t, albedo, u_channel, u_dist, t_surface):
    """Per-lane variant of sample_distance: sigma_t/albedo are (R, 3) —
    the current medium of each lane, gathered from Scene.media (vacuum
    lanes pass sigma_t = 0 and get weight exactly 1, never scattering)."""
    c = jnp.minimum((u_channel * 3).astype(jnp.int32), 2)
    sig_c = jnp.take_along_axis(sigma_t, c[:, None], axis=-1)[:, 0]
    t_m = -jnp.log(jnp.maximum(1.0 - u_dist, 1e-38)) / jnp.maximum(
        sig_c, 1e-20)
    scattered = t_m < t_surface
    t = jnp.where(scattered, t_m, t_surface)
    tr = jnp.exp(-sigma_t * t[..., None])
    pdf_scatter = jnp.mean(sigma_t * tr, axis=-1)
    pdf_escape = jnp.mean(tr, axis=-1)
    sigma_s = sigma_t * albedo
    w_scatter = tr * sigma_s / jnp.maximum(pdf_scatter, 1e-30)[..., None]
    w_escape = tr / jnp.maximum(pdf_escape, 1e-30)[..., None]
    weight = jnp.where(scattered[..., None], w_scatter, w_escape)
    return dict(scattered=scattered, t=t, weight=weight)


def transmittance_lanes(sigma_t, dist):
    """exp(-sigma_t * d) with per-lane (R, 3) extinction."""
    return jnp.exp(-sigma_t * dist[..., None])


def hg_phase(g, cos_theta):
    """HG phase function value (normalized over the sphere)."""
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_theta
    return (1.0 - g2) / (4.0 * jnp.pi * jnp.maximum(denom, 1e-8) ** 1.5)


def rayleigh_phase(cos_theta):
    """Rayleigh phase (ref: src/phase/rayleigh.cpp): 3/(16 pi)(1+cos^2)."""
    return 3.0 / (16.0 * jnp.pi) * (1.0 + cos_theta * cos_theta)


def sample_rayleigh(wi, u2):
    """Exact Rayleigh direction sampling around the propagation direction
    -wi.  The cdf cubic (3 mu + mu^3 + 4)/8 = u inverts analytically via
    mu = 2 sinh(asinh(4u - 2)/3).  Weight 1; pdf = phase value."""
    from drmlt_mitsuba.core import frame

    q = 4.0 * u2[..., 0] - 2.0
    cos_t = 2.0 * jnp.sinh(jnp.arcsinh(q) / 3.0)
    cos_t = jnp.clip(cos_t, -1.0, 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * jnp.pi * u2[..., 1]
    local = jnp.stack(
        [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1
    )
    wo = frame.to_world(-wi, local)
    return wo, rayleigh_phase(cos_t)


def eval_phase(med, cos_theta):
    """Phase value for isotropic-in-azimuth kinds (HG/Rayleigh/mixture);
    anisotropic kinds need phase_eval_dir."""
    k = getattr(med, "phase_kind", PHASE_HG)
    if k == PHASE_RAYLEIGH:
        return rayleigh_phase(cos_theta)
    if k == PHASE_MIXTURE:
        return _mixture_eval(med, cos_theta)
    return hg_phase(med.g, cos_theta)


def _mixture_eval(med, cos_theta):
    val = jnp.zeros(jnp.shape(cos_theta))
    for i, kind in enumerate(med.mix_kinds):
        p = (rayleigh_phase(cos_theta) if kind == PHASE_RAYLEIGH
             else hg_phase(med.mix_g[i], cos_theta))
        val = val + med.mix_w[i] * p
    return val


def phase_eval_dir(med, wi, wo):
    """Generalized phase value; wi/wo world directions pointing AWAY from
    the event (wi toward the previous vertex)."""
    from drmlt_mitsuba.render import phase as ph

    k = getattr(med, "phase_kind", PHASE_HG)
    if k == PHASE_KKAY:
        ks, kd, expo, norm = (med.ph_params[0], med.ph_params[1],
                              med.ph_params[2], med.ph_params[3])
        return ph.kkay_eval(med.fiber, ks, kd, expo, norm, wi, wo)
    if k == PHASE_MICROFLAKE:
        return ph.sggx_eval(med.ph_params, wi, wo)
    return eval_phase(med, jnp.sum(-wi * wo, -1))


def phase_pdf_dir(med, wi, wo):
    """Sampling pdf of phase_sample_dir for direction wo."""
    k = getattr(med, "phase_kind", PHASE_HG)
    if k == PHASE_KKAY:  # uniform-sphere sampling (ref kkay.cpp)
        return jnp.full(wo.shape[:-1], 1.0 / (4.0 * jnp.pi))
    return phase_eval_dir(med, wi, wo)


def phase_sample_dir(med, wi, u2):
    """Generalized direction sampling.  Returns (wo, pdf, value); the
    estimator weight is value/pdf (1 for HG/Rayleigh/microflake)."""
    from drmlt_mitsuba.core import frame
    from drmlt_mitsuba.render import phase as ph

    k = getattr(med, "phase_kind", PHASE_HG)
    if k == PHASE_KKAY:
        ks, kd, expo, norm = (med.ph_params[0], med.ph_params[1],
                              med.ph_params[2], med.ph_params[3])
        return ph.kkay_sample(med.fiber, ks, kd, expo, norm, wi, u2)
    if k == PHASE_MICROFLAKE:
        wo, pdf = ph.sggx_sample(med.ph_params, wi, u2)
        return wo, pdf, pdf
    if k == PHASE_MIXTURE:
        # component selection folded into u2[...,0] (rescaled remainder);
        # pdf/value = full mixture density (one-sample balance heuristic,
        # ref mixturephase.cpp:150-176)
        cdf = jnp.cumsum(med.mix_w)
        u0 = u2[..., 0]
        wo = None
        for i, kind in enumerate(med.mix_kinds):
            lo = cdf[i] - med.mix_w[i]
            sel = (u0 >= lo) & (u0 < cdf[i]) if i + 1 < len(med.mix_kinds) \
                else (u0 >= lo)
            u0_r = jnp.clip((u0 - lo) / jnp.maximum(med.mix_w[i], 1e-12),
                            0.0, 1.0 - 1e-7)
            u_i = jnp.stack([u0_r, u2[..., 1]], -1)
            wo_i, _ = (sample_rayleigh(wi, u_i) if kind == PHASE_RAYLEIGH
                       else sample_hg(med.mix_g[i], wi, u_i))
            wo = wo_i if wo is None else jnp.where(sel[..., None], wo_i, wo)
        val = _mixture_eval(med, jnp.sum(-wi * wo, -1))
        return wo, val, val
    if k == PHASE_RAYLEIGH:
        wo, pdf = sample_rayleigh(wi, u2)
        return wo, pdf, pdf
    wo, pdf = sample_hg(med.g, wi, u2)
    return wo, pdf, pdf


def sigma_dir(med, d):
    """Directional extinction multiplier along ray direction d: the SGGX
    projected flake area sqrt(d^T S d) for microflake media (ref:
    microflake.cpp sigmaDir / needsDirectionallyVaryingCoefficients);
    1 for all other phase kinds.  Symmetric in +-d, so one value serves a
    whole straight ray segment."""
    from drmlt_mitsuba.render import phase as ph

    if getattr(med, "phase_kind", PHASE_HG) == PHASE_MICROFLAKE:
        return ph.sggx_sigma(med.ph_params, d)
    return jnp.ones(d.shape[:-1])


def sample_phase(med, wi, u2):
    """Direction sampling for the medium's phase function; weight 1.
    (Legacy 2-tuple API; HG/Rayleigh only.)"""
    if getattr(med, "phase_kind", PHASE_HG) == PHASE_RAYLEIGH:
        return sample_rayleigh(wi, u2)
    return sample_hg(med.g, wi, u2)


# ---- per-lane phase dispatch for the interior-media table --------------
# (scene.media rows can mix phase kinds; like the BSDF table, only the
# statically-present kinds compile — kinds_present gates each branch)

def phase_eval_lanes(kinds_present, kind_l, g_l, fiber_l, ph_a_l, wi, wo):
    """Per-lane phase value; wi/wo world directions away from the event.

    PHASE_MIXTURE rows encode a 2-component mixture in ph_a:
    [g2, w1, kind2 (0=hg 1=rayleigh), 0], component 1 = HG(g)."""
    from drmlt_mitsuba.render import phase as ph

    cos_t = jnp.sum(-wi * wo, -1)
    val = hg_phase(g_l, cos_t)
    if PHASE_RAYLEIGH in kinds_present:
        val = jnp.where(kind_l == PHASE_RAYLEIGH, rayleigh_phase(cos_t),
                        val)
    if PHASE_MIXTURE in kinds_present:
        val = jnp.where(kind_l == PHASE_MIXTURE,
                        _mix2_eval(g_l, ph_a_l, cos_t), val)
    if PHASE_KKAY in kinds_present:
        v = ph.kkay_eval(fiber_l, ph_a_l[:, 0], ph_a_l[:, 1],
                         ph_a_l[:, 2], ph_a_l[:, 3], wi, wo)
        val = jnp.where(kind_l == PHASE_KKAY, v, val)
    if PHASE_MICROFLAKE in kinds_present:
        S = ph.sggx_fiber_S(fiber_l, ph_a_l[:, 0])
        val = jnp.where(kind_l == PHASE_MICROFLAKE,
                        ph.sggx_eval(S, wi, wo), val)
    return val


def phase_pdf_lanes(kinds_present, kind_l, g_l, fiber_l, ph_a_l, wi, wo):
    pdf = phase_eval_lanes(kinds_present, kind_l, g_l, fiber_l, ph_a_l,
                           wi, wo)
    if PHASE_KKAY in kinds_present:   # uniform-sphere sampler
        pdf = jnp.where(kind_l == PHASE_KKAY, 1.0 / (4.0 * jnp.pi), pdf)
    return pdf


def _mix2_eval(g_l, ph_a_l, cos_t):
    g2, w1 = ph_a_l[:, 0], ph_a_l[:, 1]
    p1 = hg_phase(g_l, cos_t)
    p2 = jnp.where(ph_a_l[:, 2] > 0.5, rayleigh_phase(cos_t),
                   hg_phase(g2, cos_t))
    return w1 * p1 + (1.0 - w1) * p2


def phase_sample_lanes(kinds_present, kind_l, g_l, fiber_l, ph_a_l, wi,
                       u2):
    """Per-lane direction sampling: (wo, pdf, value)."""
    from drmlt_mitsuba.render import phase as ph

    wo, pdf = sample_hg(g_l, wi, u2)
    val = pdf
    if PHASE_RAYLEIGH in kinds_present:
        wo_r, p_r = sample_rayleigh(wi, u2)
        sel = kind_l == PHASE_RAYLEIGH
        wo = jnp.where(sel[:, None], wo_r, wo)
        pdf = jnp.where(sel, p_r, pdf)
        val = jnp.where(sel, p_r, val)
    if PHASE_MIXTURE in kinds_present:
        g2, w1 = ph_a_l[:, 0], ph_a_l[:, 1]
        u0 = u2[..., 0]
        pick1 = u0 < w1
        u0r = jnp.where(pick1, u0 / jnp.maximum(w1, 1e-9),
                        (u0 - w1) / jnp.maximum(1.0 - w1, 1e-9))
        u2r = jnp.stack([jnp.clip(u0r, 0.0, 1.0 - 1e-7), u2[..., 1]], -1)
        wo1, _ = sample_hg(g_l, wi, u2r)
        wo2h, _ = sample_hg(g2, wi, u2r)
        wo2r, _ = sample_rayleigh(wi, u2r)
        wo2 = jnp.where((ph_a_l[:, 2] > 0.5)[:, None], wo2r, wo2h)
        wo_m = jnp.where(pick1[:, None], wo1, wo2)
        p_m = _mix2_eval(g_l, ph_a_l, jnp.sum(-wi * wo_m, -1))
        sel = kind_l == PHASE_MIXTURE
        wo = jnp.where(sel[:, None], wo_m, wo)
        pdf = jnp.where(sel, p_m, pdf)
        val = jnp.where(sel, p_m, val)
    if PHASE_KKAY in kinds_present:
        wo_k, p_k, v_k = ph.kkay_sample(fiber_l, ph_a_l[:, 0],
                                        ph_a_l[:, 1], ph_a_l[:, 2],
                                        ph_a_l[:, 3], wi, u2)
        sel = kind_l == PHASE_KKAY
        wo = jnp.where(sel[:, None], wo_k, wo)
        pdf = jnp.where(sel, p_k, pdf)
        val = jnp.where(sel, v_k, val)
    if PHASE_MICROFLAKE in kinds_present:
        S = ph.sggx_fiber_S(fiber_l, ph_a_l[:, 0])
        wo_m, p_m = ph.sggx_sample(S, wi, u2)
        sel = kind_l == PHASE_MICROFLAKE
        wo = jnp.where(sel[:, None], wo_m, wo)
        pdf = jnp.where(sel, p_m, pdf)
        val = jnp.where(sel, p_m, val)
    return wo, pdf, val


def sigma_dir_lanes(kinds_present, kind_l, fiber_l, ph_a_l, d):
    """Per-lane directional-extinction multiplier (1 except microflake)."""
    from drmlt_mitsuba.render import phase as ph

    out = jnp.ones(d.shape[:-1])
    if PHASE_MICROFLAKE in kinds_present:
        S = ph.sggx_fiber_S(fiber_l, ph_a_l[:, 0])
        out = jnp.where(kind_l == PHASE_MICROFLAKE, ph.sggx_sigma(S, d),
                        out)
    return out


def sample_hg(g, wi, u2):
    """Sample a direction from HG around -wi (forward scattering for g>0).

    wi points toward the previous vertex; returns unit wo (continuation
    direction).  Perfect importance sampling: weight is 1, pdf equals the
    phase value.
    """
    from drmlt_mitsuba.core import frame

    u = u2[..., 0]
    g_safe = jnp.where(jnp.abs(g) < 1e-4, 1e-4, g)
    sq = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
    cos_iso = 1.0 - 2.0 * u
    cos_hg = (1.0 + g * g - sq * sq) / (2.0 * g_safe)
    cos_t = jnp.where(jnp.abs(g) < 1e-4, cos_iso, jnp.clip(cos_hg, -1.0, 1.0))
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * jnp.pi * u2[..., 1]
    fwd = -wi   # propagate forward
    local = jnp.stack(
        [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1
    )
    wo = frame.to_world(fwd, local)
    pdf = hg_phase(g, cos_t)
    return wo, pdf


@struct.dataclass
class HeterogeneousMedium:
    """Grid-density medium (ref: src/medium/heterogeneous.cpp + gridvolume):
    density (D, H, W) sampled trilinearly in the unit cube mapped by
    world_to_grid; extinction = density * sigma_t.

    Distance sampling is Woodcock (delta) tracking with a bounded step
    count.  The tracking RNG stream derives deterministically from the
    per-bounce PSS uniforms, so L(u) stays a pure, replayable function —
    MCMC proposals that move the medium dims re-randomize the collision
    chain (a measurable, unbiased re-parameterization; mixing, not
    correctness, is affected)."""
    density: jnp.ndarray        # (D, H, W)
    world_to_grid: jnp.ndarray  # (4, 4): world -> [0,1]^3
    sigma_t: jnp.ndarray        # (3,)
    albedo: jnp.ndarray         # (3,)
    g: jnp.ndarray              # scalar
    majorant: jnp.ndarray       # scalar: max density
    # optional per-voxel single-scattering albedo (ref: heterogeneous.cpp
    # 'albedo' volume data source); None = the constant `albedo` above
    albedo_grid: jnp.ndarray | None = None   # (D, H, W, 3)
    # optional per-voxel fiber orientation (ref: heterogeneous.cpp
    # 'orientation' volume); None = the constant `fiber` below.  Only
    # meaningful for kkay/microflake phase kinds.
    orient_grid: jnp.ndarray | None = None   # (D, H, W, 3)
    # phase function (same fields as HomogeneousMedium)
    phase_kind: int = struct.field(pytree_node=False, default=PHASE_HG)
    ph_params: jnp.ndarray | None = None
    fiber: jnp.ndarray | None = None
    mix_w: jnp.ndarray | None = None
    mix_g: jnp.ndarray | None = None
    mix_kinds: tuple = struct.field(pytree_node=False, default=())
    # (4,) lanes-API parameters: kkay [ks,kd,exp,norm] / sggx [stddev,...]
    ph_a: jnp.ndarray | None = None


def make_hetero_medium(density, world_to_grid, sigma_t, albedo, g=0.0,
                       albedo_grid=None, orient_grid=None,
                       phase_kind: int = PHASE_HG,
                       fiber=(0.0, 0.0, 1.0), kkay=(0.4, 0.2, 4.0),
                       stddev=0.3, mixture=None):
    density = jnp.asarray(density, jnp.float32)
    # reuse the homogeneous constructor for the packed phase params
    ph = make_medium(sigma_t, albedo, g, phase_kind=phase_kind,
                     fiber=fiber, kkay=kkay, stddev=stddev,
                     mixture=mixture)
    return HeterogeneousMedium(
        density=density,
        world_to_grid=jnp.asarray(world_to_grid, jnp.float32),
        sigma_t=ph.sigma_t,
        albedo=ph.albedo,
        g=ph.g,
        majorant=jnp.max(density),
        albedo_grid=(None if albedo_grid is None
                     else jnp.asarray(albedo_grid, jnp.float32)),
        orient_grid=(None if orient_grid is None
                     else jnp.asarray(orient_grid, jnp.float32)),
        phase_kind=phase_kind,
        ph_params=ph.ph_params,
        fiber=ph.fiber,
        mix_w=ph.mix_w,
        mix_g=ph.mix_g,
        mix_kinds=ph.mix_kinds,
        ph_a=(ph.ph_params if phase_kind == PHASE_KKAY
              else jnp.asarray([stddev, 0.0, 0.0, 0.0], jnp.float32)
              if phase_kind == PHASE_MICROFLAKE else None),
    )


def _grid_density(med: HeterogeneousMedium, p_world):
    """Trilinear density lookup; zero outside the unit-cube mapping."""
    from drmlt_mitsuba.core.transform import apply_point

    q = apply_point(med.world_to_grid, p_world)
    D, H, W = med.density.shape
    inside = jnp.all((q >= 0.0) & (q <= 1.0), axis=-1)
    x = jnp.clip(q[..., 0], 0.0, 1.0 - 1e-6) * (W - 1)
    y = jnp.clip(q[..., 1], 0.0, 1.0 - 1e-6) * (H - 1)
    z = jnp.clip(q[..., 2], 0.0, 1.0 - 1e-6) * (D - 1)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    z0 = jnp.floor(z).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    z1 = jnp.minimum(z0 + 1, D - 1)
    fx, fy, fz = x - x0, y - y0, z - z0
    g = med.density
    c = (
        (g[z0, y0, x0] * (1 - fx) + g[z0, y0, x1] * fx) * (1 - fy)
        + (g[z0, y1, x0] * (1 - fx) + g[z0, y1, x1] * fx) * fy
    ) * (1 - fz) + (
        (g[z1, y0, x0] * (1 - fx) + g[z1, y0, x1] * fx) * (1 - fy)
        + (g[z1, y1, x0] * (1 - fx) + g[z1, y1, x1] * fx) * fy
    ) * fz
    return jnp.where(inside, c, 0.0)


def _grid_albedo(med: HeterogeneousMedium, p_world):
    """Per-voxel single-scattering albedo (trilinear); falls back to the
    constant albedo when no albedo grid is attached."""
    if med.albedo_grid is None:
        return jnp.broadcast_to(med.albedo, p_world.shape[:-1] + (3,))
    return _grid_rgb(med.albedo_grid, med.world_to_grid, p_world)


def hetero_fiber(med: HeterogeneousMedium, p_world):
    """Per-voxel fiber orientation (unit), falling back to the constant
    fiber where the orientation volume is (near-)zero or absent (ref:
    heterogeneous.cpp 'orientation' volume lookup)."""
    base = med.fiber if med.fiber is not None else jnp.asarray(
        [0.0, 0.0, 1.0])
    if med.orient_grid is None:
        return jnp.broadcast_to(base, p_world.shape[:-1] + (3,))
    v = _grid_rgb(med.orient_grid, med.world_to_grid, p_world)
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return jnp.where(n > 1e-6, v / jnp.maximum(n, 1e-12),
                     jnp.broadcast_to(base, v.shape))


def hetero_phase_ctx(med: HeterogeneousMedium, p_world):
    """Per-lane (kind, g, fiber, ph_a) arrays for the lanes phase API."""
    R = p_world.shape[0]
    kind_l = jnp.full((R,), med.phase_kind, jnp.int32)
    g_l = jnp.broadcast_to(med.g, (R,))
    fiber_l = hetero_fiber(med, p_world)
    pha = med.ph_a if med.ph_a is not None else jnp.zeros(4)
    return kind_l, g_l, fiber_l, jnp.broadcast_to(pha, (R, 4))


def _grid_rgb(g, world_to_grid, p_world):
    """Trilinear 3-channel grid lookup."""
    from drmlt_mitsuba.core.transform import apply_point

    D, H, W, _ = g.shape
    q = apply_point(world_to_grid, p_world)
    x = jnp.clip(q[..., 0], 0.0, 1.0 - 1e-6) * (W - 1)
    y = jnp.clip(q[..., 1], 0.0, 1.0 - 1e-6) * (H - 1)
    z = jnp.clip(q[..., 2], 0.0, 1.0 - 1e-6) * (D - 1)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    z0 = jnp.floor(z).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    z1 = jnp.minimum(z0 + 1, D - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    fz = (z - z0)[..., None]
    c = (
        (g[z0, y0, x0] * (1 - fx) + g[z0, y0, x1] * fx) * (1 - fy)
        + (g[z0, y1, x0] * (1 - fx) + g[z0, y1, x1] * fx) * fy
    ) * (1 - fz) + (
        (g[z1, y0, x0] * (1 - fx) + g[z1, y0, x1] * fx) * (1 - fy)
        + (g[z1, y1, x0] * (1 - fx) + g[z1, y1, x1] * fx) * fy
    ) * fz
    return c


_WOODCOCK_STEPS = 64


def sample_distance_hetero(med: HeterogeneousMedium, o, d, u_channel,
                           u_dist, t_surface):
    """Woodcock tracking along rays (o, d) up to t_surface.

    The collision stream derives from (u_channel, u_dist): bits of the two
    uniforms seed a threefry key per lane.  Returns the same dict contract
    as the homogeneous sample_distance; the weight is the standard
    delta-tracking single-sample estimator (albedo applied on scatter).
    """
    import jax

    R = o.shape[0]
    sig_bar = jnp.maximum(
        med.majorant * jnp.max(med.sigma_t), 1e-12
    )
    # lane keys from the PSS uniforms (deterministic, replayable)
    seeds = (
        (u_channel * 16777216.0).astype(jnp.uint32) * jnp.uint32(65537)
        + (u_dist * 16777216.0).astype(jnp.uint32)
    )
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(1234), seeds
    )

    max_sig = jnp.max(med.sigma_t)
    # microflake media: extinction varies with the (fixed) ray direction;
    # sigma(d) <= 1 so the direction-independent majorant still bounds.
    # With an orientation volume the projected area also varies along the
    # ray, so it is re-evaluated at every tentative collision.
    per_voxel_dir = (med.orient_grid is not None
                     and med.phase_kind == PHASE_MICROFLAKE)
    sdir = jnp.ones(d.shape[:-1]) if per_voxel_dir else sigma_dir(med, d)

    def _sdir_at(p):
        if not per_voxel_dir:
            return sdir
        from drmlt_mitsuba.render import phase as phmod

        S = phmod.sggx_fiber_S(hetero_fiber(med, p), med.ph_a[0])
        return phmod.sggx_sigma(S, d)

    def body(i, carry):
        t, done, scattered, w, key = carry
        k1, k2, key = jax.vmap(lambda k: tuple(jax.random.split(k, 3)))(key)
        step = -jnp.log(jnp.maximum(
            1.0 - jax.vmap(lambda k: jax.random.uniform(k))(k1), 1e-38
        )) / sig_bar
        t_new = t + step
        exited = t_new >= t_surface
        p = o + t_new[:, None] * d
        dens = _grid_density(med, p)
        sdir = _sdir_at(p)
        sig_local = dens * max_sig * sdir             # collision channel
        real = (jax.vmap(lambda k: jax.random.uniform(k))(k2)
                < sig_local / sig_bar)
        newly_scattered = ~done & ~exited & real
        # spectral weighted delta tracking: null collisions carry the
        # per-channel factor (sig_bar - dens*sigma_c)/(sig_bar - sig_local)
        # so chromatic sigma_t is exact, not max-channel grey
        null = ~done & ~exited & ~real
        null_num = sig_bar - (dens * sdir)[:, None] * med.sigma_t[None, :]
        null_den = jnp.maximum(sig_bar - sig_local, 1e-12)[:, None]
        w = jnp.where(null[:, None], w * null_num / null_den, w)
        newly_done = ~done & (exited | real)
        t = jnp.where(done, t, t_new)
        scattered = scattered | newly_scattered
        done = done | newly_done
        return t, done, scattered, w, key

    t0 = jnp.zeros((R,))
    done0 = jnp.zeros((R,), bool)
    sc0 = jnp.zeros((R,), bool)
    w0 = jnp.ones((R, 3))
    t, done, scattered, w, _ = jax.lax.fori_loop(
        0, _WOODCOCK_STEPS, body, (t0, done0, sc0, w0, keys)
    )
    # lanes that never terminated within the step budget escape
    t = jnp.where(scattered, jnp.minimum(t, t_surface * (1 - 1e-6)),
                  t_surface)
    # real collision: per-channel factor (dens*sigma_c/sig_bar)/(sig_local/
    # sig_bar) = sigma_c/max_sig (density cancels), times the albedo at
    # the scatter point (per-voxel when an albedo grid is attached)
    p_scat = o + t[:, None] * d
    alb = _grid_albedo(med, p_scat)
    scatter_fac = alb * (med.sigma_t / jnp.maximum(max_sig, 1e-20))[None, :]
    weight = w * jnp.where(scattered[:, None], scatter_fac, 1.0)
    return dict(scattered=scattered, t=t, weight=weight)


def transmittance_hetero(med: HeterogeneousMedium, o, d, dist, u_seed,
                         n_steps: int = 32):
    """Ratio-tracking transmittance estimate along shadow rays (unbiased;
    the stream again derives from a PSS uniform)."""
    import jax

    R = o.shape[0]
    sig_bar = jnp.maximum(med.majorant * jnp.max(med.sigma_t), 1e-12)
    seeds = (u_seed * 16777216.0).astype(jnp.uint32)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(4321), seeds
    )

    per_voxel_dir = (med.orient_grid is not None
                     and med.phase_kind == PHASE_MICROFLAKE)
    sdir0 = jnp.ones(d.shape[:-1]) if per_voxel_dir else sigma_dir(med, d)

    def body(i, carry):
        t, tr, key = carry
        k1, key = jax.vmap(lambda k: tuple(jax.random.split(k)))(key)
        step = -jnp.log(jnp.maximum(
            1.0 - jax.vmap(lambda k: jax.random.uniform(k))(k1), 1e-38
        )) / sig_bar
        t = t + step
        inside = t < dist
        p = o + t[:, None] * d
        dens = _grid_density(med, p)
        if per_voxel_dir:
            from drmlt_mitsuba.render import phase as phmod

            S = phmod.sggx_fiber_S(hetero_fiber(med, p), med.ph_a[0])
            sdir = phmod.sggx_sigma(S, d)
        else:
            sdir = sdir0
        # per-channel ratio against the shared majorant => chromatic
        # sigma_t transmittance is exact in expectation
        ratio = 1.0 - (dens * sdir)[:, None] * med.sigma_t[None, :] \
            / sig_bar
        tr = jnp.where(inside[:, None], tr * jnp.maximum(ratio, 0.0), tr)
        return t, tr, key

    t0 = jnp.zeros((R,))
    tr0 = jnp.ones((R, 3))
    _, tr, _ = jax.lax.fori_loop(0, n_steps, body, (t0, tr0, keys))
    return tr


def optical_depth_hetero(med: HeterogeneousMedium, a, b, n_steps: int = 32):
    """DETERMINISTIC per-channel optical depth along segment a->b via
    midpoint quadrature of the trilinear density (the analog of
    heterogeneous.cpp integrateDensity, which the reference's bidir pdf
    factors are built on).  Deterministic => replayable MIS factors; the
    quadrature error only perturbs MIS weights (a consistent, not
    statistical, approximation — the estimator stays unbiased in the
    balance-heuristic partition up to this smooth perturbation)."""
    seg = b - a
    dist = jnp.sqrt(jnp.maximum(jnp.sum(seg * seg, -1), 1e-20))
    d = seg / dist[..., None]
    ts = (jnp.arange(n_steps) + 0.5) / n_steps
    dens = jnp.zeros(dist.shape)
    for i in range(n_steps):
        p = a + seg * ts[i]
        dens = dens + _grid_density(med, p)
    mean_dens = dens / n_steps
    sdir = sigma_dir(med, d)
    return (mean_dens * dist * sdir)[..., None] * med.sigma_t[None, :]


def distance_pdfs_hetero_det(med: HeterogeneousMedium, a, b,
                             n_steps: int = 32):
    """(scatter density at b, escape mass past b) in the deterministic
    marched approximation: T(a,b) = exp(-tau); scatter density uses the
    luminance-mean channel (the walk's per-channel weighting already
    carries the chromatic ratio, mirroring distance_pdfs' role for the
    homogeneous case)."""
    tau = optical_depth_hetero(med, a, b, n_steps)
    tr = jnp.exp(-tau)
    tr_m = jnp.mean(tr, -1)
    sig_b = _grid_density(med, b) * jnp.mean(med.sigma_t)
    seg = b - a
    d = seg / jnp.sqrt(jnp.maximum(jnp.sum(seg * seg, -1), 1e-20))[..., None]
    sig_b = sig_b * sigma_dir(med, d)
    return tr_m * sig_b, tr_m
