"""Benchmark: DRMLT mutations/s and gradient paths/s on one GPU.

Rows, each printed as its own JSON line as soon as it is measured:

  * drmlt_path_wavefront  — DRMLT (orbital) over the path technique,
    depth 6, through drmlt_step on the XLA wavefront;
  * drmlt_mmlt_pooled     — DRMLT over the pooled MMLT encoding, depth 6;
  * grad_replay           — forward+backward paths/s of d(mean lum) /
    d(emitter radiance) through the wavefront (jax.grad of trace_paths).

Every line names the device it ran on; compile time is reported as set-up.
Exits non-zero when JAX finds no GPU.

    python bench.py
"""
from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

N_CHAINS = 65536
STEPS_PER_CALL = 16


def _emit(row: dict) -> None:
    dev = jax.devices()[0]
    row.update(platform=dev.platform, device_kind=dev.device_kind,
               device_count=len(jax.devices()))
    print(json.dumps(row), flush=True)


def _time(fn, args, n_calls: int):
    """(compile+first-call seconds, steady seconds per call)."""
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_calls):
        out = fn(*args)
    jax.block_until_ready(out)
    return t_first, (time.perf_counter() - t0) / n_calls


def main() -> int:
    from drmlt_mitsuba.core.cache import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        print(f"no GPU: JAX found {jax.devices()[0].platform}",
              file=sys.stderr)
        return 1

    from drmlt_mitsuba.integrators.bidir import BDPTConfig
    from drmlt_mitsuba.integrators.drmlt import DRMLTConfig, drmlt_step
    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.mcmc import state_from_splats
    from drmlt_mitsuba.integrators.mmlt import (
        make_mmlt_trace, mmlt_emitter_mask, mmlt_lt_mask_fn, mmlt_masks,
    )
    from drmlt_mitsuba.integrators.path import make_path_trace, trace_paths
    from drmlt_mitsuba.render import film as filmlib
    from drmlt_mitsuba.scene.builders import cornell_box

    width = height = 256
    scene = cornell_box(width, height)
    fc = filmlib.make_film_config(width, height, "box")
    root = jax.random.PRNGKey(0)
    dcfg = DRMLTConfig(type="orbital", n_chains=N_CHAINS)

    def bench_xla(name, trace, n_dims, frozen, pinned=None, extras=None):
        extras = extras or {}

        @jax.jit
        def run_block(state, film, i0):
            def body(carry, i):
                key = jax.random.fold_in(root, i)
                (st, fi, _), stats = drmlt_step(
                    trace, dcfg, fc, frozen, (carry[0], carry[1], None),
                    key, pinned_mask=pinned,
                    emitter_mask=extras.get("emitter_mask"),
                    lt_mask_fn=extras.get("lt_mask_fn"))
                return (st, fi), stats["a1"]

            (state, film), _ = jax.lax.scan(
                body, (state, film), i0 + jnp.arange(STEPS_PER_CALL))
            return state, film

        u0 = jax.random.uniform(root, (N_CHAINS, n_dims))
        state = state_from_splats(u0, trace(u0))
        t_first, dt = _time(run_block,
                            (state, filmlib.new_film(fc), jnp.int32(0)), 5)
        _emit(dict(row=name, chains=N_CHAINS, film=[width, height],
                   compile_s=t_first,
                   mutations_per_s=STEPS_PER_CALL * N_CHAINS / dt))

    pcfg = PathConfig(max_depth=6, rr_depth=5)
    n_path = pcfg.n_dims + pcfg.n_dims % 2
    bench_xla("drmlt_path_wavefront", make_path_trace(scene, pcfg), n_path,
              jnp.zeros((n_path,), bool))

    bcfg = BDPTConfig(max_depth=6)
    frozen, pinned, n_mmlt = mmlt_masks(bcfg)
    bench_xla("drmlt_mmlt_pooled", make_mmlt_trace(scene, bcfg), n_mmlt,
              frozen, pinned,
              dict(emitter_mask=mmlt_emitter_mask(bcfg, n_mmlt),
                   lt_mask_fn=mmlt_lt_mask_fn(bcfg)))

    u_g = jax.random.uniform(jax.random.fold_in(root, 9),
                             (N_CHAINS, pcfg.n_dims))

    @jax.jit
    def grad_step_replay(radiance):
        def loss(r):
            s = scene.replace(emitters=scene.emitters.replace(radiance=r))
            return jnp.mean(trace_paths(s, pcfg, u_g).lum)
        return jax.grad(loss)(radiance)

    t_first, dt = _time(grad_step_replay, (scene.emitters.radiance,), 2)
    _emit(dict(row="grad_replay", chains=N_CHAINS, compile_s=t_first,
               grad_paths_per_s=N_CHAINS / dt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
