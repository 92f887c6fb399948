"""Shared MCMC machinery: batched chain state, bootstrap seeding, splat
accumulation.

Reference mapping:
  * PathSampler::generateSeeds (pathsampler.cpp:859-960)  -> `bootstrap`
    (vmapped luminance pass + categorical resampling ∝ luminance).
  * PathSeed / ReplayableSampler                           -> counter-based
    keys (core/rng.py); a chain's initial state is re-traced directly from
    its primary-sample vector, so the seed-replay luminance oracle
    (drmlt_proc.cpp:506-512) holds by construction and is asserted in tests.
  * per-work-unit chains + mutexed accum (drmlt_proc.cpp)  -> one dense
    chain batch per device; film updates are scatter-adds.

A `trace_fn(u) -> Splats` closure makes the machinery technique-agnostic
(path | bdpt | mmlt), mirroring PathSampler's ETechnique dispatch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from drmlt_mitsuba.core import struct
from drmlt_mitsuba.integrators.path import Splats
from drmlt_mitsuba.render import film as filmlib


@struct.dataclass
class ChainState:
    """State of C parallel chains with fixed PSS dimension D and S splats."""
    u: jnp.ndarray       # (C, D) current primary samples (wrapped to [0,1])
    lum: jnp.ndarray     # (C,) luminance of the current state
    pos: jnp.ndarray     # (C, S, 2) current splat positions ([0,1)^2)
    value: jnp.ndarray   # (C, S, 3) current splat values


def state_from_splats(u, sp: Splats) -> ChainState:
    """Normalize the splat list by its total luminance (ref:
    SplatList::normalize, pathsampler.cpp:1001-1028): stored splat values
    have unit luminance; MH weights multiply them at splat time and the
    film develops with the global b factor."""
    lum = jnp.where(jnp.isfinite(sp.lum), sp.lum, 0.0)
    value = jnp.where(
        (lum > 0)[:, None, None], sp.value / jnp.maximum(lum, 1e-30)[:, None, None], 0.0
    )
    return ChainState(u=u, lum=lum, pos=sp.pos, value=value)


def bootstrap(trace_fn, root_key, n_dims: int, n_bootstrap: int,
              n_chains: int, batch: int = 8192):
    """Kelemen bootstrap: estimate b = E[L] over n_bootstrap uniform samples
    and resample n_chains seeds proportional to luminance.

    Returns (chain_state, b).  Each seed is replayable: chain i's initial u
    is uniform(fold_in(root_key, seed_index_i)).
    """
    n_batches = -(-n_bootstrap // batch)
    n_total = n_batches * batch

    def sample_u(sample_idx):
        """Per-sample replayable primary vector (the PathSeed contract)."""
        return jax.random.uniform(
            jax.random.fold_in(root_key, sample_idx), (n_dims,)
        )

    def body(carry, i):
        u = jax.vmap(sample_u)(i * batch + jnp.arange(batch))
        sp = trace_fn(u)
        lum = jnp.where(jnp.isfinite(sp.lum) & (sp.lum >= 0), sp.lum, 0.0)
        return carry + jnp.sum(lum), lum

    total, lums = jax.lax.scan(body, jnp.float32(0.0), jnp.arange(n_batches))
    lums = lums.reshape(n_total)
    b = total / n_total

    # categorical resampling ∝ luminance (ref: seedCount resample loop);
    # cdf inversion, NOT jax.random.categorical (which materializes a
    # (n_chains, n_bootstrap) Gumbel matrix)
    pick_key = jax.random.fold_in(root_key, n_total + 1)
    cdf = jnp.cumsum(lums)
    u_pick = jax.random.uniform(pick_key, (n_chains,)) * cdf[-1]
    idx = jnp.clip(jnp.searchsorted(cdf, u_pick), 0, n_total - 1)
    # replay the chosen seeds: O(n_chains) regeneration, no stream rewind
    u0 = jax.vmap(sample_u)(idx)
    # jitted: traced op by op, a whole trace is thousands of dispatches
    return jax.jit(lambda u: state_from_splats(u, trace_fn(u)))(u0), b


def splat_state(film_cfg, film, pos, value, weight):
    """Accumulate one weighted SplatList batch into the film.

    pos: (C, S, 2) in [0,1)^2; value: (C, S, 3); weight: (C,).
    """
    C, S, _ = pos.shape
    scale = jnp.array([film_cfg.width, film_cfg.height], jnp.float32)
    p = (pos * scale).reshape(C * S, 2)
    v = value.reshape(C * S, 3)
    w = jnp.repeat(weight, S)
    return filmlib.splat(film_cfg, film, p, v, weight=w, mode="splat")


def metropolis_clamp(ratio):
    """min(1, ratio) with NaN/negative guarded to 0 (ref: metropolisClamp +
    isInvalid proposal handling, drmlt_proc.cpp:543-546)."""
    ratio = jnp.where(jnp.isfinite(ratio) & (ratio >= 0), ratio, 0.0)
    return jnp.minimum(ratio, 1.0)


def select_state(accept, proposed: ChainState, current: ChainState) -> ChainState:
    a1 = accept[:, None]
    return ChainState(
        u=jnp.where(a1, proposed.u, current.u),
        lum=jnp.where(accept, proposed.lum, current.lum),
        pos=jnp.where(accept[:, None, None], proposed.pos, current.pos),
        value=jnp.where(accept[:, None, None], proposed.value, current.value),
    )
