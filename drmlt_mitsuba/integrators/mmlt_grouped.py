"""Depth-grouped MMLT: static per-depth chain batches.

The MMLT depth dimension is PINNED — a chain never changes path depth —
so the chain population factorizes into independent per-depth groups.
The pooled encoding (integrators/mmlt.py) still carries every chain
through max_depth-length subpath walks even though a depth-k chain only
ever uses k of them.  Grouping chains by depth and compiling a depth-k
trace per group cuts the walk work from O(max_depth) to O(k) per
mutation; with luminance-proportional allocation the expected k is small
(most transport is short paths), a multi-x end-to-end win.

This mirrors the reference MORE closely than the pooled form: the
reference allocates bootstrap budget per depth (drmlt.cpp:456-473),
generates per-depth seeds (pathsampler.cpp:884-934), and each of its
MMLT work units is a fixed-depth chain.

Normalization: group k's chains target the depth-k restriction pi_k of
the luminance with mass b_k = E[lum_k].  Each group accumulates into its
OWN film and develops with scale b_k * npixels / (N_k * n_steps), so the
integer rounding of the group sizes N_k cancels exactly (every group is
normalized by its own mutation count); the final image is the sum.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from drmlt_mitsuba.integrators.bidir import BDPTConfig, trace_mmlt
from drmlt_mitsuba.integrators.drmlt import (
    DRMLTConfig, drmlt_mixture_step, drmlt_step,
)
from drmlt_mitsuba.integrators.mcmc import state_from_splats
from drmlt_mitsuba.integrators.path import Splats
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.types import Scene


def make_mmlt_trace_fixed(scene: Scene, k: int, light_image: bool = True,
                          thinlens: bool = False, medium: bool = False):
    """trace(u) for a depth-k group.

    u = [strategy dim, eye dims(k)..., light dims(k)..., (pad)].  There is
    no depth dim and no uniform-depth pmf factor (the pooled x max_depth):
    luminance-proportional group ALLOCATION replaces the pmf.

    Returns (trace, cfg_k, n_dims) with n_dims even-padded for orbital.
    """
    cfg = BDPTConfig(max_depth=k, light_image=light_image,
                     thinlens=thinlens, medium=medium)
    n_core = 1 + cfg.eye_dims + cfg.light_dims
    n_dims = n_core + (n_core % 2)

    def trace(u) -> Splats:
        depth = jnp.full((u.shape[0],), k, jnp.int32)
        return trace_mmlt(scene, cfg, u[:, :n_core], depth)

    return trace, cfg, n_dims


def grouped_masks(cfg: BDPTConfig, n_dims: int):
    """frozen mask for a depth-k group: the strategy dim (index 0) moves
    only on large steps; there is no pinned dim."""
    return jnp.zeros((n_dims,), bool).at[0].set(True)


def grouped_emitter_mask(cfg: BDPTConfig, n_dims: int):
    mask = jnp.zeros((n_dims,), bool)
    start = 1 + cfg.eye_dims
    return mask.at[start:start + cfg.light_dims].set(True)


def grouped_lt_mask_fn(cfg: BDPTConfig):
    k = cfg.max_depth

    def lt(u):
        s = jnp.minimum((u[:, 0] * (k + 1)).astype(jnp.int32), k)
        return s == k   # t = k+1-s == 1
    return lt


def _group_bootstrap(trace, root_key, n_dims: int, n_boot: int,
                     batch: int = 8192):
    """Luminance pass only: returns (lums (n_total,), b_k, sampler) where
    sampler(idx) regenerates candidate idx's u (the PathSeed contract)."""
    n_batches = max(1, -(-n_boot // batch))
    n_total = n_batches * batch

    def sample_u(sample_idx):
        return jax.random.uniform(
            jax.random.fold_in(root_key, sample_idx), (n_dims,))

    @jax.jit
    def lum_pass():
        def body(carry, i):
            u = jax.vmap(sample_u)(i * batch + jnp.arange(batch))
            sp = trace(u)
            lum = jnp.where(jnp.isfinite(sp.lum) & (sp.lum >= 0), sp.lum, 0.0)
            return carry + jnp.sum(lum), lum

        total, lums = jax.lax.scan(body, jnp.float32(0.0),
                                   jnp.arange(n_batches))
        return lums.reshape(n_total), total / n_total

    lums, b_k = lum_pass()
    return lums, b_k, sample_u


def _group_starts(trace, sample_u, lums, root_key, n_chains: int):
    """cdf-inversion resample of n_chains starts proportional to lums."""
    cdf = jnp.cumsum(lums)
    u_pick = jax.random.uniform(
        jax.random.fold_in(root_key, 0x5EED), (n_chains,)) * cdf[-1]
    idx = jnp.clip(jnp.searchsorted(cdf, u_pick), 0, lums.shape[0] - 1)
    u0 = jax.vmap(sample_u)(idx)
    return jax.jit(lambda u: state_from_splats(u, trace(u)))(u0)


def _bootstrap_groups(scene, bcfg: BDPTConfig, k_boot, n_boot_grp: int,
                      average_luminance=None):
    """Per-depth traces + luminance bootstraps.  Returns (groups, b_ks,
    b_total) with b_ks rescaled to average_luminance when given."""
    groups = []
    for k in range(1, bcfg.max_depth + 1):
        trace_k, cfg_k, n_k = make_mmlt_trace_fixed(
            scene, k, bcfg.light_image,
            thinlens=bcfg.thinlens, medium=bcfg.medium)
        lums, b_k, sample_u = _group_bootstrap(
            trace_k, jax.random.fold_in(k_boot, k), n_k, n_boot_grp)
        groups.append(dict(k=k, trace=trace_k, cfg=cfg_k, n_dims=n_k,
                           lums=lums, b=b_k, sample_u=sample_u))

    b_ks = [float(g["b"]) for g in groups]     # one host sync at setup
    b_total = sum(b_ks)
    if average_luminance is not None and b_total > 0:
        scale_b = float(average_luminance) / b_total
        b_ks = [bk * scale_b for bk in b_ks]
        b_total = float(average_luminance)
    return groups, b_ks, b_total


def _group_body(g, dcfg: DRMLTConfig, film_cfg):
    """body(carry, key) -> (carry, stats): one mutation of group g's chains
    (carry = (state, film, accmap))."""
    step = drmlt_mixture_step if dcfg.use_mixture else drmlt_step
    cfg_k, n_dims = g["cfg"], g["n_dims"]
    frozen = grouped_masks(cfg_k, n_dims)
    if step is drmlt_mixture_step:
        return lambda carry, key: step(g["trace"], dcfg, film_cfg, frozen,
                                       carry, key)
    emitter_mask = (grouped_emitter_mask(cfg_k, n_dims)
                    if dcfg.fix_emitter_path else None)
    lt_fn = grouped_lt_mask_fn(cfg_k) if dcfg.fix_emitter_path else None
    return lambda carry, key: step(g["trace"], dcfg, film_cfg, frozen, carry,
                                   key, emitter_mask=emitter_mask,
                                   lt_mask_fn=lt_fn)


def render_drmlt_mmlt_grouped(scene: Scene, bcfg: BDPTConfig,
                              dcfg: DRMLTConfig, film_cfg, root_key,
                              n_steps: int, average_luminance=None,
                              min_group: int = 1024,
                              equal_chains: bool = True):
    """Full depth-grouped DRMLT-over-MMLT render.

    Returns (image, aux) like drmlt.render_drmlt; aux adds per-group
    sizes/b_k.  Ref: drmlt.cpp:393-611 (the process being beaten) with
    the per-depth work-unit structure of pathsampler.cpp:884-934.

    Two allocation schemes (mutations per depth stay proportional to the
    depth's luminance mass b_k either way, so the estimator is unchanged):

    * equal_chains=True (default): EVERY group runs dcfg.n_chains chains
      and the per-group STEP count scales with b_k, so each group's batch
      stays at the full chain count instead of starving deep groups (the
      per-call overhead dominates tiny batches).  Valid because bootstrap
      resampling draws starts from the stationary distribution, so many
      short chains are as unbiased as few long ones (Kelemen et al. 2002,
      §5.1; drmlt.cpp:456-473 uses many independent short work units the
      same way).
    * equal_chains=False: luminance-proportional chain counts, a common
      n_steps.
    """
    D = bcfg.max_depth
    k_boot, k_run = jax.random.split(root_key)
    groups, b_ks, b_total = _bootstrap_groups(
        scene, bcfg, k_boot, max(8192, dcfg.n_bootstrap // D),
        average_luminance)

    # group sizes + per-group step counts (see docstring)
    sizes, steps_per_group = [], []
    for bk in b_ks:
        if b_total <= 0 or bk <= 0:
            sizes.append(0)
            steps_per_group.append(0)
            continue
        if equal_chains:
            # no max(1, ...) floor: a negligible-mass group whose
            # proportional share rounds to zero steps is SKIPPED rather
            # than promoted to a full n_chains-wide step (at small n_steps
            # the floor silently degraded the documented proportional
            # allocation to near-equal allocation)
            sizes.append(dcfg.n_chains)
            steps_per_group.append(int(round(n_steps * bk / b_total)))
        else:
            raw = dcfg.n_chains * bk / b_total
            sizes.append(max(min_group,
                             int(round(raw / min_group)) * min_group))
            steps_per_group.append(n_steps)

    img = jnp.zeros((film_cfg.height, film_cfg.width, 3))
    accmap = filmlib.new_film(film_cfg) if dcfg.acceptance_map else None
    all_stats = {}

    for g, n_k_chains, bk, n_steps_k in zip(groups, sizes, b_ks,
                                            steps_per_group):
        if n_k_chains == 0 or n_steps_k == 0:
            continue
        state = _group_starts(g["trace"], g["sample_u"], g["lums"],
                              jax.random.fold_in(k_boot, 100 + g["k"]),
                              n_k_chains)
        film = filmlib.new_film(film_cfg)
        key_g = jax.random.fold_in(k_run, g["k"])

        @jax.jit
        def run(state, film, accmap, key_g=key_g,
                body=_group_body(g, dcfg, film_cfg), n_steps_k=n_steps_k):
            (state, film, accmap), stats = jax.lax.scan(
                lambda c, i: body(c, jax.random.fold_in(key_g, i)),
                (state, film, accmap), jnp.arange(n_steps_k))
            return state, film, accmap, stats

        state, film, accmap, stats = run(state, film, accmap)
        n_per_pixel = n_k_chains * n_steps_k / film_cfg.npixels
        img = img + filmlib.develop(
            film_cfg, film, mode="splat", scale=bk / n_per_pixel)[..., :3]
        all_stats[g["k"]] = stats

    return img, dict(b=b_total, b_k=b_ks, sizes=sizes,
                     steps_per_group=steps_per_group, stats=all_stats,
                     accmap=accmap)


def render_drmlt_mmlt_grouped_sharded(
        mesh, scene: Scene, bcfg: BDPTConfig, dcfg: DRMLTConfig, film_cfg,
        root_key, n_steps: int, average_luminance=None):
    """render_drmlt_mmlt_grouped (equal-chains allocation) under a device
    mesh: each depth group's dcfg.n_chains chains shard over
    ('host','chain') and every device runs the same drmlt_step scan on its
    shard (chains are exchangeable -> pure data parallelism, SURVEY
    §2.8.1).  This subsumes the reference's remote work-unit scheduler
    (src/libcore/sched_remote.cpp:156-287).

    Bootstrap (small) runs replicated; only the mutation loop is sharded.
    Returns (image, aux) like render_drmlt_mmlt_grouped; aux["states"]
    holds each group's final chain state, still sharded over the mesh."""
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from drmlt_mitsuba.parallel.mesh import CHAIN_AXES, shard_chain_state

    n_shards = mesh.devices.size
    if dcfg.n_chains % n_shards:
        raise ValueError(f"n_chains={dcfg.n_chains} does not divide over "
                         f"{n_shards} devices")
    if dcfg.acceptance_map:
        raise ValueError("acceptance_map is not supported when sharded")
    k_boot, k_run = jax.random.split(root_key)
    groups, b_ks, b_total = _bootstrap_groups(
        scene, bcfg, k_boot, max(8192, dcfg.n_bootstrap // bcfg.max_depth),
        average_luminance)

    # per-device film accumulator, sharded over the mesh: each group adds
    # its LOCAL (unreduced) film here, so the cross-device film reduction
    # happens ONCE at the end of the render instead of once per depth
    # group (SURVEY §5.8 "overlapping film reduction with the next
    # mutation batch").
    img_shards = jax.device_put(
        jnp.zeros((n_shards, film_cfg.height, film_cfg.width, 3)),
        jax.sharding.NamedSharding(mesh, P(CHAIN_AXES)))
    all_stats, states = {}, {}
    for g, bk in zip(groups, b_ks):
        steps_k = (int(round(n_steps * bk / b_total))
                   if b_total > 0 and bk > 0 else 0)
        if steps_k == 0:
            continue
        state = shard_chain_state(mesh, _group_starts(
            g["trace"], g["sample_u"], g["lums"],
            jax.random.fold_in(k_boot, 100 + g["k"]), dcfg.n_chains))
        body = _group_body(g, dcfg, film_cfg)
        scale = bk * film_cfg.npixels / (dcfg.n_chains * steps_k)

        @partial(
            shard_map, mesh=mesh,
            in_specs=(P(CHAIN_AXES), P(), P(CHAIN_AXES)),
            out_specs=(P(CHAIN_AXES), P(CHAIN_AXES), P()),
            check_vma=False,
        )
        def run(state_l, key, img_l, body=body, steps_k=steps_k,
                scale=scale):
            # independent per-device streams: fold in the mesh position
            for ax in CHAIN_AXES:
                key = jax.random.fold_in(key, jax.lax.axis_index(ax))
            (state_l, film, _), stats = jax.lax.scan(
                lambda c, i: body(c, jax.random.fold_in(key, i)),
                (state_l, filmlib.new_film(film_cfg), None),
                jnp.arange(steps_k))
            # NO film psum here: the local film joins the sharded
            # accumulator; one reduction happens after the group loop
            img_l = img_l + film[None, ..., :3] * scale
            stats = jax.tree.map(
                lambda x: jax.lax.pmean(x, CHAIN_AXES), stats)
            return state_l, img_l, stats

        state, img_shards, stats = jax.jit(run)(
            state, jax.random.fold_in(k_run, g["k"]), img_shards)
        all_stats[g["k"]] = stats
        states[g["k"]] = state
    img = img_shards.sum(0)      # the single cross-device film reduction
    return img, dict(b=b_total, b_k=b_ks, stats=all_stats, states=states)
