"""Sharded MCMC execution over a device mesh.

One shard_map'd program runs bootstrap + the whole mutation scan per device
shard, then reduces the film (and b) with psum — the full replacement for
the reference's remote-scheduler work-unit pipeline.  Per-device RNG streams
fold in the device's mesh position so chains are independent across shards.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from jax import shard_map

from drmlt_mitsuba.integrators.mcmc import bootstrap
from drmlt_mitsuba.parallel.mesh import CHAIN_AXES
from drmlt_mitsuba.render import film as filmlib


def _device_key(key):
    """Fold the mesh coordinates into the key for per-shard streams."""
    for ax in CHAIN_AXES:
        key = jax.random.fold_in(key, jax.lax.axis_index(ax))
    return key


def render_mcmc_sharded(mesh, trace_fn, step_fn, film_cfg, root_key,
                        n_dims: int, n_chains: int, n_steps: int,
                        n_bootstrap: int, extra_carry=None,
                        average_luminance=None):
    """Run a full sharded MCMC render.

    step_fn(b, carry, key) -> (carry, stats) operates on the local chain
    shard; carry = (state, film, extra).  Returns (film_replicated, b,
    final_state_sharded, stats).

    n_chains and n_bootstrap are GLOBAL counts; they must divide evenly by
    the mesh size.
    """
    n_shards = mesh.devices.size
    assert n_chains % n_shards == 0, (n_chains, n_shards)
    local_chains = n_chains // n_shards
    local_boot = max(1024, n_bootstrap // n_shards)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(),),
        out_specs=(P(), P(), P(CHAIN_AXES), P()),
        check_vma=False,
    )
    def run(key):
        key = _device_key(key[0])
        k_boot, k_run = jax.random.split(key)
        state, b_local = bootstrap(
            trace_fn, k_boot, n_dims, local_boot, local_chains,
            batch=min(4096, local_boot),
        )
        # global normalization constant: mean over shards
        b = jax.lax.pmean(jax.lax.pmean(b_local, CHAIN_AXES[0]), CHAIN_AXES[1])
        if average_luminance is not None:
            b = jnp.float32(average_luminance)

        film = filmlib.new_film(film_cfg)
        carry = (state, film, extra_carry)

        def body(carry, i):
            return step_fn(b, carry, jax.random.fold_in(k_run, i))

        carry, stats = jax.lax.scan(body, carry, jnp.arange(n_steps))
        state, film, _ = carry
        # the single film all-reduce of the run (ICI/DCN)
        film = jax.lax.psum(jax.lax.psum(film, CHAIN_AXES[0]), CHAIN_AXES[1])
        stats = jax.tree.map(
            lambda x: jax.lax.pmean(
                jax.lax.pmean(x, CHAIN_AXES[0]), CHAIN_AXES[1]
            ),
            stats,
        )
        return film, b, state, stats

    return jax.jit(run)(root_key[None])
