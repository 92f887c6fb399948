"""Sample generators (ref: src/samplers/ — independent, stratified,
halton, hammersley, ldsampler, sobol).

MLT legally uses only `independent` (enforced like drmlt.cpp:380); the
low-discrepancy generators serve the forward renderers (render_pt) and the
direct pass.  All are pure functions of (key, sample index) — Cranley-
Patterson rotation by the key keeps them unbiased across batches.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.render.sobol import ld02, sobol

def _first_primes(n: int) -> np.ndarray:
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out if p * p <= c):
            out.append(c)
        c += 1
    return np.asarray(out, np.int64)


# one distinct base per dimension (wrapping would correlate high dims)
PRIMES = _first_primes(160)


def radical_inverse(index, base: int):
    """Van der Corput radical inverse of integer indices in a given base."""
    index = index.astype(jnp.int64) if hasattr(index, "astype") else index

    def body(carry, _):
        i, inv, scale = carry
        digit = i % base
        return (i // base, inv + digit * scale, scale / base), None

    n_digits = int(np.ceil(np.log(2**31) / np.log(base)))
    (i, inv, _), _ = jax.lax.scan(
        body,
        (index, jnp.zeros(index.shape, jnp.float32),
         jnp.full(index.shape, 1.0 / base, jnp.float32)),
        None, length=n_digits,
    )
    return jnp.minimum(inv, 1.0 - 1e-7)


def halton(key, idx, n_dims: int):
    """Halton points with Cranley-Patterson rotation.  idx (N,) integer
    sample indices -> (N, n_dims) in [0,1)."""
    dims = []
    for d in range(n_dims):
        dims.append(radical_inverse(idx, int(PRIMES[d])))
    pts = jnp.stack(dims, axis=-1)
    shift = jax.random.uniform(key, (n_dims,))
    return (pts + shift[None, :]) % 1.0


def hammersley(key, idx, n_total: int, n_dims: int):
    """Hammersley set: first dim = i/N, rest Halton."""
    first = (idx.astype(jnp.float32) + 0.5) / n_total
    rest = halton(key, idx, n_dims - 1)
    pts = jnp.concatenate([first[:, None], rest], axis=-1)
    shift = jax.random.uniform(key, (n_dims,))
    return (pts + shift[None, :]) % 1.0


def stratified(key, idx, n_total: int, n_dims: int):
    """1-D stratification on the first two dims (pixel position), jittered;
    remaining dims independent (ref: stratified.cpp behavior per pixel)."""
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, (idx.shape[0], n_dims))
    n_strata = int(np.floor(np.sqrt(n_total)))
    sx = (idx % n_strata).astype(jnp.float32)
    sy = ((idx // n_strata) % n_strata).astype(jnp.float32)
    u = u.at[:, 0].set((sx + u[:, 0]) / n_strata)
    u = u.at[:, 1].set((sy + u[:, 1]) / n_strata)
    return u


def make_sampler(kind: str):
    """Returns sample_fn(key, start_index, n, n_dims, n_total) -> (n, D)."""
    kind = kind.lower()

    def fn(key, start, n, n_dims, n_total):
        idx = start + jnp.arange(n)
        if kind in ("independent",):
            return jax.random.uniform(jax.random.fold_in(key, start),
                                      (n, n_dims))
        if kind == "halton":
            return halton(key, idx, n_dims)
        if kind == "sobol":
            return sobol(key, idx, n_dims)
        if kind == "ldsampler":
            return ld02(key, idx, n_dims)
        if kind == "hammersley":
            return hammersley(key, idx, n_total, n_dims)
        if kind == "stratified":
            return stratified(jax.random.fold_in(key, start), idx, n_total,
                              n_dims)
        raise ValueError(f"unknown sampler '{kind}'")

    return fn
