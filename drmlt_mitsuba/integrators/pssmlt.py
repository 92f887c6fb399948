"""PSSMLT — Kelemen-style primary-sample-space MLT (ref:
src/integrators/pssmlt/).

One jitted step advances every chain in the batch: propose (large step =
fresh uniforms, small step = Kelemen-hole or Gaussian offsets on all dims),
trace, Metropolis accept, and splat BOTH states with their expected weights.

Differences from the reference that are deliberate batch design (not gaps):
  * The reference mutates PSS dims lazily with backup/restore
    (pssmlt_sampler.h:117-186); we use full-state proposals like its DRMLT
    sampler — same distribution, fixed tensor shapes.
  * Kelemen's cumulative-weight trick (pssmlt_proc.cpp:226-237) batches
    splats on CPU; scatter-adds are cheap here so both states splat every
    step (identical expectation).

Both Kelemen-style and Veach-style splat weights are supported
(pssmlt_proc.cpp:204-225).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from drmlt_mitsuba.core.rng import pss_wrap
from drmlt_mitsuba.integrators import kernels
from drmlt_mitsuba.integrators.mcmc import (
    ChainState, bootstrap, metropolis_clamp, select_state, splat_state,
    state_from_splats,
)


@dataclasses.dataclass(frozen=True)
class PSSMLTConfig:
    """Options mirror the reference pssmlt plugin (pssmlt.cpp:297-307).

    p_lens adds a PSS analog of the Veach lens perturbation
    (src/libbidir/mut_lens.cpp): with that probability a small step
    perturbs ONLY the image-plane dims (re-aiming the eye ray while the
    rest of the path replays), the primary-sample-space counterpart of
    perturbing the lens edge.  p_caustic analogously perturbs only the
    final-bounce dims (mut_caustic.cpp re-seeds the last segment)."""
    n_chains: int = 8192
    p_large: float = 0.3
    kelemen_style_mutation: bool = True   # Kelemen hole vs Gaussian
    kelemen_style_weights: bool = True
    mutation_size_low: float = kernels.S1_DEFAULT
    mutation_size_high: float = kernels.S2_DEFAULT
    sigma: float = kernels.SIGMA_DEFAULT
    n_bootstrap: int = 100_000            # luminanceSamples
    p_lens: float = 0.0                   # lens-perturbation probability
    p_caustic: float = 0.0                # caustic-perturbation probability
    lens_sigma: float = 0.02              # image-space gaussian
    caustic_dims: int = 7                 # trailing dims for p_caustic


def _small_step_kernel(cfg: PSSMLTConfig):
    if cfg.kelemen_style_mutation:
        return kernels.Kelemen(cfg.mutation_size_low, cfg.mutation_size_high)
    return kernels.Gaussian(cfg.sigma)


def propose(cfg: PSSMLTConfig, key, u, pinned_mask=None):
    """Full-state proposal for all chains: (u', large_step_mask).

    Mutation mixture per chain: large step | full small step | lens
    perturbation (image dims only) | caustic perturbation (trailing
    dims only).  pinned_mask: dims never mutated (MMLT per-chain depth)."""
    C, D = u.shape
    k_coin, k_large, k_kern, k_mut = jax.random.split(key, 4)
    coin = jax.random.uniform(k_coin, (C,))
    large = coin < cfg.p_large
    pick_lens = (~large) & (coin < cfg.p_large + cfg.p_lens)
    pick_caustic = (
        (~large) & ~pick_lens
        & (coin < cfg.p_large + cfg.p_lens + cfg.p_caustic)
    )
    u_large = jax.random.uniform(k_large, (C, D))
    u2 = jax.random.uniform(k_kern, (C, D, 2))
    du = _small_step_kernel(cfg).sample(u2)
    if cfg.p_lens > 0 or cfg.p_caustic > 0:
        dim = jnp.arange(D)
        img_dims = dim < 2
        tail_dims = dim >= (D - cfg.caustic_dims)
        du_lens = jnp.where(
            img_dims[None, :],
            kernels.Gaussian(cfg.lens_sigma).sample(u2), 0.0,
        )
        du = jnp.where(pick_lens[:, None], du_lens, du)
        du = jnp.where(
            pick_caustic[:, None],
            jnp.where(tail_dims[None, :], du, 0.0), du,
        )
    u_small = pss_wrap(u + du)
    out = jnp.where(large[:, None], u_large, u_small)
    if pinned_mask is not None:
        out = jnp.where(pinned_mask[None, :], u, out)
    return out, large


def pssmlt_step(trace_fn, cfg: PSSMLTConfig, b, film_cfg, carry, key,
                pinned_mask=None):
    """One mutation for every chain; carry = (state, film)."""
    state, film = carry
    k_prop, k_acc = jax.random.split(key)
    u_prop, large = propose(cfg, k_prop, state.u, pinned_mask)
    sp = trace_fn(u_prop)
    proposed = state_from_splats(u_prop, sp)

    a = metropolis_clamp(proposed.lum / jnp.maximum(state.lum, 1e-30))

    if cfg.kelemen_style_weights:
        # pssmlt_proc.cpp:205-215
        w_cur = (1.0 - a) * state.lum / (state.lum / b + cfg.p_large)
        w_prop = (a + jnp.where(large, 1.0, 0.0)) * proposed.lum / (
            proposed.lum / b + cfg.p_large
        )
        w_prop = jnp.where(a > 0, w_prop, 0.0)
        w_cur = jnp.where(a > 0, w_cur, state.lum / (state.lum / b + cfg.p_large))
        # Kelemen weights already include the 1/b·pLarge MIS with large
        # steps; the film develops with scale 1/nAvg instead of b/nAvg.
    else:
        w_cur = 1.0 - a
        w_prop = a

    film = splat_state(film_cfg, film, state.pos, state.value, w_cur)
    film = splat_state(film_cfg, film, proposed.pos, proposed.value, w_prop)

    accept = jax.random.uniform(k_acc, a.shape) < a
    state = select_state(accept, proposed, state)
    stats = dict(
        accept=jnp.mean(accept.astype(jnp.float32)),
        large=jnp.mean(large.astype(jnp.float32)),
    )
    return (state, film), stats


def render_pssmlt(trace_fn, cfg: PSSMLTConfig, film_cfg, root_key,
                  n_dims: int, n_steps: int, average_luminance=None,
                  pinned_mask=None):
    """Full PSSMLT render: bootstrap -> n_steps mutations -> developed image.

    Returns (image (H,W,3), aux dict).  `average_luminance` overrides the
    bootstrap b estimate (ref: drmlt.cpp:298-299, for equal-comparison runs).
    """
    from drmlt_mitsuba.render import film as filmlib

    k_boot, k_run = jax.random.split(root_key)
    state, b = bootstrap(trace_fn, k_boot, n_dims, cfg.n_bootstrap, cfg.n_chains)
    if average_luminance is not None:
        b = jnp.float32(average_luminance)

    film = filmlib.new_film(film_cfg)

    @jax.jit
    def run(state, film):
        def body(carry, i):
            key = jax.random.fold_in(k_run, i)
            return pssmlt_step(trace_fn, cfg, b, film_cfg, carry, key,
                               pinned_mask)

        (state, film), stats = jax.lax.scan(
            body, (state, film), jnp.arange(n_steps)
        )
        return state, film, stats

    state, film, stats = run(state, film)
    total_mutations = cfg.n_chains * n_steps
    n_per_pixel = total_mutations / film_cfg.npixels
    if cfg.kelemen_style_weights:
        scale = 1.0 / n_per_pixel
    else:
        scale = b / n_per_pixel
    img = filmlib.develop(film_cfg, film, mode="splat", scale=scale)
    return img, dict(b=b, state=state, stats=stats)
