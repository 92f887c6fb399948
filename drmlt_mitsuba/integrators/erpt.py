"""ERPT — energy-redistribution path tracing (ref: src/integrators/erpt/).

The reference redistributes each path-traced sample's energy through short
Veach-PERTURBATION Metropolis chains (lens / caustic / multi-chain,
erpt_proc.cpp:187-278) under the equal-deposition rule: chains are seeded
stochastically ~ sample energy and every mutation deposits a fixed energy
quantum derived from the batch's own luminance estimate.

Two batched drivers, both batch-normalized (the defining ERPT
property — no global bootstrap pass; each batch's PT samples normalize
that batch):

- render_erpt_mlt — PATH-SPACE chains: seeds are materialized vertex
  paths (pathspace.build_seed_paths, resampled ~ energy = the vectorized
  analog of erpt_proc.cpp:157-166's stochastic chain counts) and the
  chains run the reference's actual perturbations via
  pathspace.mutate_once.  Perturbations alone are not ergodic; the fresh
  per-batch reseeding is what restores coverage — exactly the reference's
  design.  Requires pathspace.mlt_eligible scenes.
- render_erpt — primary-sample-space fallback (Kelemen/Gaussian small
  steps), scene-generic; same estimator family, kept for scenes outside
  the path-space subset.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from drmlt_mitsuba.core.rng import pss_wrap
from drmlt_mitsuba.integrators import kernels
from drmlt_mitsuba.integrators.mcmc import (
    metropolis_clamp, select_state, splat_state, state_from_splats,
)


@dataclasses.dataclass(frozen=True)
class ERPTConfig:
    n_chains: int = 4096          # chains per batch
    chain_length: int = 100       # numChains*mutations equivalent
    samples_per_batch: int = 16384
    sigma: float = kernels.SIGMA_DEFAULT
    kelemen: bool = True


def render_erpt(trace_fn, cfg: ERPTConfig, film_cfg, root_key, n_dims: int,
                n_batches: int):
    """Returns (image, aux)."""
    from drmlt_mitsuba.render import film as filmlib

    kern = (kernels.Kelemen() if cfg.kelemen
            else kernels.Gaussian(cfg.sigma))

    def one_batch(film_total, bi):
        from drmlt_mitsuba.render import film as filmlib

        film = filmlib.new_film(film_cfg)
        key = jax.random.fold_in(root_key, bi)
        k_pt, k_pick, k_run = jax.random.split(key, 3)

        # PT stage: energies + batch normalization
        u = jax.random.uniform(k_pt, (cfg.samples_per_batch, n_dims))
        sp = trace_fn(u)
        e = jnp.where(jnp.isfinite(sp.lum) & (sp.lum >= 0), sp.lum, 0.0)
        b = jnp.mean(e)

        # redistribute: chain seeds ~ energy (cdf inversion)
        cdf = jnp.cumsum(e)
        u_pick = jax.random.uniform(k_pick, (cfg.n_chains,)) * cdf[-1]
        idx = jnp.clip(jnp.searchsorted(cdf, u_pick),
                       0, cfg.samples_per_batch - 1)
        state = state_from_splats(
            u[idx],
            jax.tree.map(lambda a: a[idx], sp),
        )

        def mh(carry, i):
            state, film = carry
            kk = jax.random.fold_in(k_run, i)
            k1, k2 = jax.random.split(kk)
            du = kern.sample(
                jax.random.uniform(k1, state.u.shape + (2,))
            )
            u_prop = pss_wrap(state.u + du)
            prop = state_from_splats(u_prop, trace_fn(u_prop))
            a = metropolis_clamp(prop.lum / jnp.maximum(state.lum, 1e-30))
            film = splat_state(film_cfg, film, state.pos, state.value,
                               1.0 - a)
            film = splat_state(film_cfg, film, prop.pos, prop.value, a)
            accept = jax.random.uniform(k2, a.shape) < a
            return (select_state(accept, prop, state), film), jnp.mean(a)

        (state, film), accs = jax.lax.scan(
            mh, (state, film), jnp.arange(cfg.chain_length)
        )
        # each batch is normalized by ITS OWN b (the ERPT property)
        return film_total + film * b, (b, jnp.mean(accs))

    @jax.jit
    def run():
        film0 = filmlib.new_film(film_cfg)
        film, (bs, accs) = jax.lax.scan(
            one_batch, film0, jnp.arange(n_batches)
        )
        return film, bs, accs

    film, bs, accs = run()
    n_pp = (n_batches * cfg.n_chains * cfg.chain_length) / film_cfg.npixels
    img = filmlib.develop(film_cfg, film, mode="splat", scale=1.0 / n_pp)
    return img, dict(b=bs, accept=accs)


def render_erpt_mlt(scene, cfg: ERPTConfig, film_cfg, root_key,
                    n_batches: int, max_depth: int = 6, kmin: int = 2,
                    mutators=("lens", "caustic", "mchain")):
    """Path-space ERPT (ref: erpt_proc.cpp): per batch, bootstrap-trace
    paths, resample chain seeds ~ energy, run `chain_length` Veach
    perturbations per chain with expected-value (1-a, a) deposition, and
    normalize the batch's film by ITS OWN luminance estimate b.

    Returns (image, aux)."""
    from drmlt_mitsuba.integrators import pathspace as P
    from drmlt_mitsuba.render import film as filmlib

    mcfg = P.MLTConfig(max_depth=max_depth, kmin=kmin,
                       n_chains=cfg.n_chains,
                       n_bootstrap=cfg.samples_per_batch)
    res = (film_cfg.width, film_cfg.height)
    scale = jnp.asarray([film_cfg.width, film_cfg.height], jnp.float32)
    n_rounds = max(1, cfg.chain_length // len(mutators))

    @jax.jit
    def run_chains(ps, val, lum, pix, kr):
        """chain_length perturbation steps; returns (film, mean accept)."""
        def body(carry, i):
            state, film = carry
            key = jax.random.fold_in(kr, i)
            accs = []
            for j, which in enumerate(mutators):
                kj = jax.random.fold_in(key, j)
                state, (a, pval, plum, ppix) = P.mutate_once(
                    scene, mcfg, kj, state, which, res)
                ps_, val_, lum_, pix_ = state
                # equal deposition: both sides splat at UNIT luminance
                # (x b at develop), weights (1-a, a) — erpt_proc.cpp:253-278
                unit_c = jnp.where(
                    (lum_ > 0)[:, None],
                    val_ / jnp.maximum(lum_, 1e-30)[:, None], 0.0)
                unit_p = jnp.where(
                    (plum > 0)[:, None],
                    pval / jnp.maximum(plum, 1e-30)[:, None], 0.0)
                film = filmlib.splat(
                    film_cfg, film,
                    jnp.concatenate([pix_ * scale, ppix * scale]),
                    jnp.concatenate([unit_c, unit_p]),
                    jnp.concatenate([1.0 - a, a]), mode="splat")
                accs.append(jnp.mean(a))
            return (state, film), jnp.stack(accs)

        film0 = filmlib.new_film(film_cfg)
        (state, film), accs = jax.lax.scan(
            body, ((ps, val, lum, pix), film0), jnp.arange(n_rounds))
        return film, accs

    film_total = filmlib.new_film(film_cfg)
    bs, accs = [], []
    for bi in range(n_batches):
        kb = jax.random.fold_in(root_key, 0x0E49 + bi)
        ps, b = P.build_seed_paths(scene, mcfg, kb, cfg.n_chains,
                                   cfg.samples_per_batch)
        val, lum, pix, _ = P.eval_path(scene, ps, mcfg.max_depth)
        film, acc = run_chains(ps, val, lum, pix,
                               jax.random.fold_in(root_key, bi))
        # the batch's PT samples normalize the batch (ERPT property)
        film_total = film_total + film * b
        bs.append(b)
        accs.append(acc)

    steps_eff = n_rounds * len(mutators)
    n_pp = (n_batches * cfg.n_chains * steps_eff) / film_cfg.npixels
    img = filmlib.develop(film_cfg, film_total, mode="splat",
                          scale=1.0 / n_pp)
    return img, dict(b=jnp.stack(bs), accept=jnp.stack(accs))
