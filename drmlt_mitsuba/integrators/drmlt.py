"""DRMLT — bold-then-timid delayed-rejection MLT (ref:
src/integrators/drmlt/drmlt_proc.cpp:515-770, drmlt_sampler.cpp).

Every chain runs the two-stage proposal each mutation:

  stage 1 (bold):  Kelemen-hole full-state proposal y ~ Q1(.|x)
                   a1 = min(1, Ly/Lx)
  stage 2 (timid): on stage-1 rejection, z ~ Q2(.|y) with the per-type
                   second-stage acceptance a2:
    * green   — reversible-jump: trace the reverse path y* = z - (y - x),
                a2 = min(1, (Lz/Lx)·(1-a(y*|z))/(1-a1)), 0 if a(y*|z)=1
                (Eq. 13-14; three traces per mutation)
    * mira    — naive Tierney&Mira: a2 = min(1, (Lz/Lx)·q-ratio·(1-a(y|z))
                /(1-a1)) with q-ratio = Q1(z|y)/Q1(x|y) in log space
    * orbital — pairwise orbital stage-2 (rotate y-x about y by a
                wrapped-Cauchy angle, preserving the norm) cancels the
                q-ratio: a2 = clamp((Lz-Ly)/(Lx-Ly)) with 0/1 early-exits
                (Eq. 11)

  splat all three states with weights  w(y)=a1, w(z)=(1-a1)·a2,
  w(x)=1-w(y)-w(z)  (paper Fig. 10; drmlt_proc.cpp:676-688).

Batch form: no per-chain control flow — every chain evaluates stage 2 with
masking (`do_second` zeroes its weight after large steps unless
timidAfterLarge, drmlt_proc.cpp:552-558); green's third trace is likewise
batch-wide.  `frozen_mask` marks PSS dims driven by identity kernels (MMLT
strategy dims / fixEmitterPath).  The `use_mixture` baseline (equal-weight
two-kernel MH, drmlt_proc.cpp:161-380) is in drmlt_mixture_step.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from drmlt_mitsuba.core.rng import pss_wrap
from drmlt_mitsuba.integrators import kernels
from drmlt_mitsuba.integrators.mcmc import (
    ChainState, bootstrap, metropolis_clamp, select_state, splat_state,
    state_from_splats,
)

TYPE_GREEN = "green"
TYPE_MIRA = "mira"
TYPE_ORBITAL = "orbital"


@dataclasses.dataclass(frozen=True)
class DRMLTConfig:
    """Mirrors DRMLTConfiguration (drmlt.h:35-191)."""
    type: str = TYPE_GREEN             # green | mira | orbital
    n_chains: int = 8192
    p_large: float = 0.3
    s1: float = kernels.S1_DEFAULT
    s2: float = kernels.S2_DEFAULT
    sigma: float = kernels.SIGMA_DEFAULT
    scale_second: float = kernels.SCALE_SECOND_DEFAULT
    rho: float = kernels.RHO_DEFAULT
    kelemen_scale: float = kernels.KELEMEN_SCALE_ORBITAL
    timid_after_large: bool = False
    acceptance_map: bool = False
    use_mixture: bool = False
    fix_emitter_path: bool = False   # MMLT: freeze emitter dims in stage 2
    #                                  unless the chain is light-tracing
    #                                  (drmlt_proc.cpp:133-141)
    n_bootstrap: int = 100_000
    fuse_traces: bool = True         # batch the stage-1/stage-2 (and green
    #                                  reverse) traces into ONE trace_fn call
    #                                  — proposals never depend on each
    #                                  other's trace results.  Timed on an
    #                                  H100 (orbital, grouped MMLT depth 2):
    #                                  0.41 vs 0.50 ms per step at 7168
    #                                  chains, 1.51 vs 1.50 ms at 65536.
    #                                  False only for the equivalence test.

    def __post_init__(self):
        if self.type not in (TYPE_GREEN, TYPE_MIRA, TYPE_ORBITAL):
            raise ValueError(f"unknown DRMLT type {self.type!r}")

    def stage1_kernel(self):
        if self.type == TYPE_ORBITAL:
            return kernels.Kelemen(self.s1 * self.kelemen_scale,
                                   self.s2 * self.kelemen_scale)
        return kernels.Kelemen(self.s1, self.s2)

    def stage2_kernel(self):
        if self.type == TYPE_ORBITAL:
            return kernels.WrappedCauchy(self.rho)
        return kernels.Gaussian(self.scale_second * self.sigma)


def propose_stage1(cfg: DRMLTConfig, key, u, frozen_mask, pinned_mask=None):
    """Bold proposal y (unwrapped) + large-step mask.

    frozen_mask: dims driven by identity kernels — unchanged on small steps
    but resampled on large steps (MMLT strategy dims; fillSpace large-step
    branch is uniform even for identity kernels).
    pinned_mask: dims that NEVER move (MMLT per-chain depth) — invariant
    under both small and large steps.
    """
    C, D = u.shape
    k_coin, k_large, k_kern = jax.random.split(key, 3)
    large = jax.random.uniform(k_coin, (C,)) < cfg.p_large
    u_large = jax.random.uniform(k_large, (C, D))
    kern = cfg.stage1_kernel()
    if cfg.type == TYPE_ORBITAL:
        # pairwise 2-D Kelemen: radius from dim 2i, angle from dim 2i+1
        # (drmlt_sampler.cpp:339-360)
        u2 = jax.random.uniform(k_kern, (C, D // 2, 2, 2))
        d = kern.sample(u2[:, :, 0, :])               # (C, D/2)
        ang = u2[:, :, 1, 0] * (2.0 * jnp.pi)
        duv = jnp.stack([d * jnp.cos(ang), d * jnp.sin(ang)], axis=-1)
        du = duv.reshape(C, D)
    else:
        u2 = jax.random.uniform(k_kern, (C, D, 2))
        du = kern.sample(u2)
    du = jnp.where(frozen_mask[None, :], 0.0, du)
    y = u + du
    y = jnp.where(large[:, None], u_large, y)
    if pinned_mask is not None:
        y = jnp.where(pinned_mask[None, :], u, y)
    return y, large


def propose_stage2(cfg: DRMLTConfig, key, x, y, frozen_mask,
                   pinned_mask=None, freeze2=None):
    """Timid proposal z (unwrapped) given current x and stage-1 proposal y.

    Green/Mira: z = x + small-Gaussian — fillSpace always perturbs
    m_uCurrent, i.e. the timid kernel is anchored on the CURRENT state
    (drmlt_sampler.cpp:313-332).  Orbital: rotate the pair-vector (y-x)
    about y by a wrapped-Cauchy angle, preserving its norm, which lands z
    on the ||x-y|| sphere around y (near x for small angles) and cancels
    the q-ratio (drmlt_sampler.cpp:361-394).
    """
    C, D = x.shape
    kern = cfg.stage2_kernel()
    if cfg.type == TYPE_ORBITAL:
        theta = kern.sample(jax.random.uniform(key, (C, D // 2, 2)))
        du = (y - x).reshape(C, D // 2, 2)
        nrm = jnp.sqrt(jnp.maximum(jnp.sum(du * du, axis=-1), 1e-30))
        mu = jnp.arctan2(-du[..., 1], -du[..., 0])
        c1 = y.reshape(C, D // 2, 2)[..., 0] + jnp.cos(theta + mu) * nrm
        c2 = y.reshape(C, D // 2, 2)[..., 1] + jnp.sin(theta + mu) * nrm
        z = jnp.stack([c1, c2], axis=-1).reshape(C, D)
    else:
        u2 = jax.random.uniform(key, (C, D, 2))
        z = x + kern.sample(u2)
    z = jnp.where(frozen_mask[None, :], x, z)
    if pinned_mask is not None:
        z = jnp.where(pinned_mask[None, :], x, z)
    if freeze2 is not None:
        # per-chain stage-2 identity dims (fixEmitterPath)
        z = jnp.where(freeze2, x, z)
    return z


def mira_transition_ratio(cfg: DRMLTConfig, x, y, z, frozen_mask,
                          pinned_mask=None):
    """Q1(z|y) / Q1(x|y) in log space (drmlt_sampler.cpp:400-414)."""
    kern = cfg.stage1_kernel()
    lp_num = kern.log_pdf(z - y)
    lp_den = kern.log_pdf(x - y)
    skip = frozen_mask
    if pinned_mask is not None:
        skip = skip | pinned_mask
    lp = jnp.where(skip[None, :], 0.0, lp_num - lp_den)
    return jnp.exp(jnp.sum(lp, axis=-1))


def drmlt_step(trace_fn, cfg: DRMLTConfig, film_cfg, frozen_mask,
               carry, key, accmap_cfg=None, pinned_mask=None,
               emitter_mask=None, lt_mask_fn=None):
    """One DRMLT mutation for all chains.

    carry = (state, film, accmap) where accmap accumulates stage-1/stage-2
    acceptance splats in R/G when cfg.acceptance_map (box filter required,
    drmlt_proc.cpp:76-79,443-450); pass accmap=film-like array or None.
    """
    state, film, accmap = carry
    k1, k2, kacc1, kacc2 = jax.random.split(key, 4)

    x = state.u
    y_raw, large = propose_stage1(cfg, k1, x, frozen_mask, pinned_mask)
    y = pss_wrap(y_raw)

    freeze2 = None
    if cfg.fix_emitter_path and emitter_mask is not None \
            and lt_mask_fn is not None:
        lt = lt_mask_fn(x)    # (C,) is the CURRENT chain light-tracing?
        freeze2 = emitter_mask[None, :] & ~lt[:, None]
    z_raw = propose_stage2(cfg, k2, x, y_raw, frozen_mask, pinned_mask,
                           freeze2)
    z = pss_wrap(z_raw)
    if cfg.type == TYPE_GREEN:
        y_star = pss_wrap(z_raw - (y_raw - x))

    # ---- trace the proposals (one batched call when fused) ---------------
    # No proposal depends on another's trace result (green's reverse path
    # y* = z - (y - x) uses raw proposals only), so all 2 (3 for green)
    # traces can run as ONE trace_fn call — same total work, but per-call
    # fixed cost is paid once, which dominates small depth-grouped batches.
    C = x.shape[0]
    if cfg.fuse_traces:
        batch = [y, z] + ([y_star] if cfg.type == TYPE_GREEN else [])
        sp_all = trace_fn(jnp.concatenate(batch, axis=0))
        parts = [jax.tree.map(lambda a, i=i: a[i * C:(i + 1) * C], sp_all)
                 for i in range(len(batch))]
        sp_y, sp_z = parts[0], parts[1]
        sp_rev = parts[2] if cfg.type == TYPE_GREEN else None
    else:
        sp_y = trace_fn(y)
        sp_z = trace_fn(z)
        sp_rev = trace_fn(y_star) if cfg.type == TYPE_GREEN else None

    prop1 = state_from_splats(y, sp_y)
    a1 = metropolis_clamp(prop1.lum / jnp.maximum(state.lum, 1e-30))
    accept1 = jax.random.uniform(kacc1, a1.shape) < a1

    # ---- stage 2 (computed for all lanes; masked where not taken) --------
    do_second = ~accept1
    if not cfg.timid_after_large:
        do_second = do_second & ~large

    prop2 = state_from_splats(z, sp_z)
    lum_ratio = prop2.lum / jnp.maximum(state.lum, 1e-30)

    if cfg.type == TYPE_GREEN:
        # reverse path y* = z - (y - x) (third trace, batched when fused)
        a_rev = metropolis_clamp(
            jnp.where(jnp.isfinite(sp_rev.lum) & (sp_rev.lum >= 0), sp_rev.lum, 0.0)
            / jnp.maximum(prop2.lum, 1e-30)
        )
        a2 = metropolis_clamp(lum_ratio * (1.0 - a_rev) / jnp.maximum(1.0 - a1, 1e-12))
        a2 = jnp.where(a_rev >= 1.0, 0.0, a2)
    elif cfg.type == TYPE_MIRA:
        a_rev = metropolis_clamp(prop1.lum / jnp.maximum(prop2.lum, 1e-30))
        q_ratio = mira_transition_ratio(cfg, x, y_raw, z_raw, frozen_mask,
                                        pinned_mask)
        q_ratio = jnp.where(large, 1.0, q_ratio)
        a2 = metropolis_clamp(
            lum_ratio * q_ratio * (1.0 - a_rev) / jnp.maximum(1.0 - a1, 1e-12)
        )
        a2 = jnp.where(a_rev >= 1.0, 0.0, a2)
        a2 = jnp.where(jnp.isfinite(q_ratio), a2, 0.0)
    elif cfg.type == TYPE_ORBITAL:
        # Eq. 11 with early exits (drmlt_proc.cpp:655-669)
        num = prop2.lum - prop1.lum
        den = state.lum - prop1.lum
        a2 = jnp.where(
            prop2.lum < prop1.lum,
            0.0,
            jnp.where(
                prop2.lum >= state.lum,
                1.0,
                metropolis_clamp(num / jnp.where(jnp.abs(den) > 0, den, 1.0)),
            ),
        )
    else:
        raise ValueError(cfg.type)

    a2 = jnp.where(prop2.lum > 0, a2, 0.0)
    a2 = jnp.where(do_second, a2, 0.0)
    accept2 = (jax.random.uniform(kacc2, a2.shape) < a2) & do_second

    # ---- three-state weighted splatting (Fig. 10) ------------------------
    w_y = a1
    w_z = (1.0 - a1) * a2
    w_x = 1.0 - w_y - w_z
    # one splat call for all three states (fewer scatter launches)
    film = splat_state(
        film_cfg, film,
        jnp.concatenate([state.pos, prop1.pos, prop2.pos]),
        jnp.concatenate([state.value, prop1.value, prop2.value]),
        jnp.concatenate([w_x, w_y, w_z]))

    if cfg.acceptance_map and accmap is not None:
        # R = stage-1 accepts (small steps only), G = stage-2 accepts
        r = (accept1 & ~large).astype(jnp.float32)
        g = accept2.astype(jnp.float32)
        zeros = jnp.zeros_like(r)
        acc_rgb = jnp.stack([r, g, zeros], axis=-1)[:, None, :]
        pos = jnp.where(accept2[:, None, None], prop2.pos, prop1.pos)
        accmap = splat_state(accmap_cfg or film_cfg, accmap, pos,
                             acc_rgb, jnp.ones_like(r))

    state = select_state(accept1, prop1, select_state(accept2, prop2, state))
    stats = dict(
        a1=jnp.mean(a1), a2=jnp.mean(a2),
        accept1=jnp.mean(accept1.astype(jnp.float32)),
        accept2=jnp.mean(accept2.astype(jnp.float32)),
        large=jnp.mean(large.astype(jnp.float32)),
    )
    return (state, film, accmap), stats


def drmlt_mixture_step(trace_fn, cfg: DRMLTConfig, film_cfg, frozen_mask,
                       carry, key):
    """`useMixture` baseline: single-stage MH whose proposal is an
    equal-weight mixture of the bold and timid kernels
    (drmlt_proc.cpp:161-380)."""
    state, film, accmap = carry
    kp, kc, kacc = jax.random.split(key, 3)
    x = state.u
    pick_bold = jax.random.uniform(kc, (x.shape[0],)) < 0.5
    y_bold, large = propose_stage1(cfg, kp, x, frozen_mask)
    z_timid = propose_stage2(cfg, kp, x, x, frozen_mask)
    y_raw = jnp.where((pick_bold | large)[:, None], y_bold, z_timid)
    y = pss_wrap(y_raw)
    prop = state_from_splats(y, trace_fn(y))
    a = metropolis_clamp(prop.lum / jnp.maximum(state.lum, 1e-30))
    film = splat_state(film_cfg, film, state.pos, state.value, 1.0 - a)
    film = splat_state(film_cfg, film, prop.pos, prop.value, a)
    accept = jax.random.uniform(kacc, a.shape) < a
    state = select_state(accept, prop, state)
    return (state, film, accmap), dict(a1=jnp.mean(a))


def render_drmlt(trace_fn, cfg: DRMLTConfig, film_cfg, root_key, n_dims: int,
                 n_steps: int, frozen_mask=None, average_luminance=None,
                 pinned_mask=None, emitter_mask=None, lt_mask_fn=None):
    """Full DRMLT render.  Returns (image, aux) with aux carrying b, final
    chain state, per-step stats, and the acceptance map (if enabled)."""
    from drmlt_mitsuba.render import film as filmlib

    if n_dims % 2 and cfg.type == TYPE_ORBITAL:
        raise ValueError("orbital requires an even PSS dimension count")
    if frozen_mask is None:
        frozen_mask = jnp.zeros((n_dims,), bool)

    k_boot, k_run = jax.random.split(root_key)
    state, b = bootstrap(trace_fn, k_boot, n_dims, cfg.n_bootstrap, cfg.n_chains)
    if average_luminance is not None:
        b = jnp.float32(average_luminance)

    film = filmlib.new_film(film_cfg)
    accmap = filmlib.new_film(film_cfg) if cfg.acceptance_map else None
    step = drmlt_mixture_step if cfg.use_mixture else drmlt_step

    @jax.jit
    def run(state, film, accmap):
        def body(carry, i):
            key = jax.random.fold_in(k_run, i)
            if step is drmlt_step:
                return step(trace_fn, cfg, film_cfg, frozen_mask, carry,
                            key, pinned_mask=pinned_mask,
                            emitter_mask=emitter_mask,
                            lt_mask_fn=lt_mask_fn)
            return step(trace_fn, cfg, film_cfg, frozen_mask, carry, key)

        (state, film, accmap), stats = jax.lax.scan(
            body, (state, film, accmap), jnp.arange(n_steps)
        )
        return state, film, accmap, stats

    state, film, accmap, stats = run(state, film, accmap)
    n_per_pixel = cfg.n_chains * n_steps / film_cfg.npixels
    img = filmlib.develop(film_cfg, film, mode="splat", scale=b / n_per_pixel)
    return img, dict(b=b, state=state, stats=stats, accmap=accmap)


def render_drmlt_path(scene, pcfg, cfg: DRMLTConfig, film_cfg, root_key,
                      n_steps: int, average_luminance=None):
    """DRMLT over the unidirectional path technique (the reference's
    default configuration: drmlt.cpp:434-444 technique=path).
    Returns (image, aux) like render_drmlt."""
    from drmlt_mitsuba.integrators.path import make_path_trace

    n_dims = pcfg.n_dims + pcfg.n_dims % 2   # orbital needs even dims
    return render_drmlt(make_path_trace(scene, pcfg), cfg, film_cfg,
                        root_key, n_dims, n_steps,
                        average_luminance=average_luminance)
