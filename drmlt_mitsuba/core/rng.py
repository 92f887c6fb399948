"""Primary-sample-space RNG contract.

The reference relies on an SFMT-19937 stream plus a `ReplayableSampler`
(include/mitsuba/bidir/rsampler.h) that can rewind to an absolute sample
index so a bootstrap `PathSeed` (= stream index) fully determines a chain's
initial state.  Here that becomes JAX's counter-based threefry:

    chain seed  := fold_in(root_key, sample_index)
    u           := uniform(seed, (MAX_DIM,))

which is a strictly stronger replay contract (O(1) rewind, no serial stream),
while keeping the *fixed-dimension* PSS invariant the DRMLT samplers require
(drmlt_sampler.cpp fillSpace always consumes exactly maxDim uniforms).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def pss_uniform(key, n_dims: int):
    """A full primary-sample vector u ~ U[0,1)^n from a key."""
    return jax.random.uniform(key, (n_dims,), dtype=jnp.float32)


def seed_to_key(root_key, sample_index):
    """PathSeed-equivalent: absolute bootstrap index -> replayable key."""
    return jax.random.fold_in(root_key, sample_index)


def pss_wrap(y):
    """Reflective [0,1] wrap of a perturbed primary sample.

    Mirror of the reference DRMLTSampler::wrap (drmlt_sampler.h:140-144):
        y > 1  -> 2 - y;   y <= 0 -> |y|;   else y
    generalized to arbitrary offsets via the mod-2 reflection (identical on
    |offset| < 1; needed because orbital stage-2 after a large step can move
    a pair coordinate by up to sqrt(2), and green's reverse path y*=z-(y-x)
    can likewise leave (-1, 2)).  The reflection is a piecewise isometry, so
    symmetric proposal kernels stay symmetric under it.
    """
    t = jnp.mod(y, 2.0)
    return jnp.where(t > 1.0, 2.0 - t, t)


def split_many(key, n: int):
    """Split a key into n keys as a stacked (n, 2) array."""
    return jax.random.split(key, n)
