"""Profile the depth-grouped DRMLT-over-MMLT step on the accelerator.

Times end-to-end scan variants: full step / no-splat step / trace-only /
proposal-only / splat-only, at 65536 chains and a 256^2 film.

    python scripts/profile_step.py
"""
from __future__ import annotations

import time
from unittest import mock

import jax
import jax.numpy as jnp

from drmlt_mitsuba.integrators.drmlt import DRMLTConfig, drmlt_step
from drmlt_mitsuba.integrators import drmlt as drmlt_mod
from drmlt_mitsuba.integrators.mcmc import state_from_splats
from drmlt_mitsuba.integrators.mmlt_grouped import (
    grouped_emitter_mask, grouped_lt_mask_fn, grouped_masks,
    make_mmlt_trace_fixed,
)
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box

N_CHAINS = 65536
STEPS = 16
N_CALLS = 4


def timeit(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(N_CALLS):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / (N_CALLS * STEPS)


def main():
    width = height = 256
    scene = cornell_box(width, height)
    fc = filmlib.make_film_config(width, height, "box")
    root = jax.random.PRNGKey(0)
    dcfg = DRMLTConfig(type="orbital", n_chains=N_CHAINS)

    for k in (1, 2, 4, 6):
        trace_k, cfg_k, n_dims = make_mmlt_trace_fixed(scene, k)
        frozen = grouped_masks(cfg_k, n_dims)
        extras = dict(emitter_mask=grouped_emitter_mask(cfg_k, n_dims),
                      lt_mask_fn=grouped_lt_mask_fn(cfg_k))
        u0 = jax.random.uniform(root, (N_CHAINS, n_dims))
        state = state_from_splats(u0, trace_k(u0))
        film = filmlib.new_film(fc)

        @jax.jit
        def full(state, film):
            def body(carry, i):
                key = jax.random.fold_in(root, i)
                (st, fi, _), stats = drmlt_step(
                    trace_k, dcfg, fc, frozen, (carry[0], carry[1], None),
                    key, **extras)
                return (st, fi), stats["a1"]
            (state, film), _ = jax.lax.scan(body, (state, film),
                                            jnp.arange(STEPS))
            return film

        t_full = timeit(full, state, film)

        # ---- no-splat variant (splat_state -> identity) -------------------
        def _nosplat(film_cfg, film, pos, value, weight):
            # keep a data dependency so nothing is DCE'd
            return film + jnp.sum(value) * jnp.sum(weight) * 0.0 + \
                film * 0 + film_like_eps(pos)

        def film_like_eps(pos):
            return jnp.zeros_like(film) + jnp.sum(pos) * 1e-30

        with mock.patch.object(drmlt_mod, "splat_state", _nosplat):
            @jax.jit
            def nosplat(state, film):
                def body(carry, i):
                    key = jax.random.fold_in(root, i)
                    (st, fi, _), stats = drmlt_step(
                        trace_k, dcfg, fc, frozen,
                        (carry[0], carry[1], None), key, **extras)
                    return (st, fi), stats["a1"]
                (state, film), _ = jax.lax.scan(body, (state, film),
                                                jnp.arange(STEPS))
                return film
            t_nosplat = timeit(nosplat, state, film)

        # ---- trace-only: 2 unfused trace calls per step --------------------
        @jax.jit
        def traceonly(u):
            def body(u, i):
                sp1 = trace_k(u)
                sp2 = trace_k(jnp.mod(u + 0.37, 1.0))
                u = jnp.mod(u + (sp1.lum + sp2.lum)[:, None] * 1e-12 + 0.1,
                            1.0)
                return u, sp1.lum[0]
            u, _ = jax.lax.scan(body, u, jnp.arange(STEPS))
            return u
        t_trace = timeit(traceonly, u0)

        # ---- splat-only: one 3C-splat call per step ------------------------
        pos3 = jnp.concatenate([state.pos] * 3)
        val3 = jnp.concatenate([state.value] * 3)
        @jax.jit
        def splatonly(film, w0):
            def body(film, i):
                w = w0 + i.astype(jnp.float32) * 1e-9
                film = drmlt_mod.splat_state(
                    fc, film, pos3, val3,
                    jnp.broadcast_to(w, (3 * N_CHAINS,)))
                return film, w
            film, _ = jax.lax.scan(body, film, jnp.arange(STEPS))
            return film
        t_splat = timeit(splatonly, film, jnp.float32(0.5))

        ms = lambda t: f"{t * 1e3:7.3f}"
        rate = N_CHAINS / t_full / 1e6
        print(f"k={k} dims={n_dims:3d} | full {ms(t_full)} ms "
              f"({rate:6.2f}M mut/s) | nosplat {ms(t_nosplat)} | "
              f"trace2x {ms(t_trace)} | splat3C {ms(t_splat)} | "
              f"glue~{ms(t_nosplat - t_trace)}", flush=True)


if __name__ == "__main__":
    main()
