"""Sobol' low-discrepancy sequence (ref: src/samplers/sobol.cpp,
ldsampler.cpp).

Direction numbers: the first 21 dimensions use the canonical Joe-Kuo
(new-joe-kuo-6.21201) table entries; higher dimensions derive their
primitive polynomials by an exhaustive GF(2) search at import time (cheap:
degree <= 10 covers 160+ dims) with deterministic odd initial values from a
fixed LCG.  Every dimension is therefore a valid base-2 (0,1)-sequence;
the tabulated dims additionally carry Joe-Kuo's optimized 2-D projections.

Randomization is a per-dimension digital XOR shift (Owen-style shift,
not Cranley-Patterson): it preserves the digital-net structure exactly,
unlike the rotation used for Halton.

All points are computed directly (no Gray-code state): x_i = XOR of the
direction vectors selected by the bits of i, evaluated as a 32-step
lax.scan -> jit friendly, O(1) random access like the rest of the
sampler module.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# --- Joe-Kuo table rows (d, s, a, m_1..m_s) for dims 2..21 (dim 1 is the
# van der Corput sequence, handled specially). ---
_JOE_KUO = [
    (2, 1, 0, [1]),
    (3, 2, 1, [1, 3]),
    (4, 3, 1, [1, 3, 1]),
    (5, 3, 2, [1, 1, 1]),
    (6, 4, 1, [1, 1, 3, 3]),
    (7, 4, 4, [1, 3, 5, 13]),
    (8, 5, 2, [1, 1, 5, 5, 17]),
    (9, 5, 4, [1, 1, 5, 5, 5]),
    (10, 5, 7, [1, 1, 7, 11, 19]),
    (11, 5, 11, [1, 1, 5, 1, 1]),
    (12, 5, 13, [1, 1, 1, 3, 11]),
    (13, 5, 14, [1, 3, 5, 5, 31]),
    (14, 6, 1, [1, 3, 3, 9, 7, 49]),
    (15, 6, 13, [1, 1, 1, 15, 21, 21]),
    (16, 6, 16, [1, 3, 1, 13, 27, 49]),
    (17, 6, 19, [1, 1, 1, 15, 7, 5]),
    (18, 6, 22, [1, 3, 1, 15, 13, 25]),
    (19, 6, 25, [1, 1, 5, 5, 19, 61]),
    (20, 7, 1, [1, 3, 7, 11, 23, 15, 103]),
    (21, 7, 4, [1, 3, 7, 13, 13, 15, 69]),
]

_N_BITS = 32
MAX_DIMS = 160


def _poly_mul_mod(a: int, b: int, p: int, s: int) -> int:
    """(a*b) mod p over GF(2), p of degree s (bitmask encoding)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> s & 1:
            a ^= p
    return r


def _is_irreducible(p: int, s: int) -> bool:
    """Trial division by all polynomials of degree 1..s//2."""
    for d in range(1, s // 2 + 1):
        for q in range(1 << d, 1 << (d + 1)):
            # polynomial long division p / q over GF(2)
            rem = p
            while rem.bit_length() - 1 >= d:
                rem ^= q << (rem.bit_length() - 1 - d)
            if rem == 0:
                return False
    return True


def _prime_factors(n: int):
    out, d = set(), 2
    while d * d <= n:
        while n % d == 0:
            out.add(d)
            n //= d
        d += 1
    if n > 1:
        out.add(n)
    return out


def _poly_pow_x(e: int, p: int, s: int) -> int:
    """x^e mod p over GF(2)."""
    result, base = 1, 2  # 1 and x
    while e:
        if e & 1:
            result = _poly_mul_mod(result, base, p, s)
        base = _poly_mul_mod(base, base, p, s)
        e >>= 1
    return result


def _primitive_polys(degree: int):
    """All primitive polynomials of the given degree, as 'a' encodings
    (interior coefficient bits, Joe-Kuo convention)."""
    n = (1 << degree) - 1
    factors = _prime_factors(n)
    out = []
    for interior in range(1 << (degree - 1)):
        # full poly bitmask: x^s + interior bits + 1
        p = (1 << degree) | (interior << 1) | 1
        if not _is_irreducible(p, degree):
            continue
        if any(_poly_pow_x(n // f, p, degree) == 1 for f in factors):
            continue
        out.append(interior)
    return out


def _direction_vectors(n_dims: int) -> np.ndarray:
    """(n_dims, 32) uint32 direction vectors V_k = m_k << (32-k)."""
    assert n_dims <= MAX_DIMS, f"sobol: {n_dims} dims > {MAX_DIMS}"
    rows = []
    # dim 1: van der Corput, m_k = 1 for all k.
    rows.append([1 << (_N_BITS - k) for k in range(1, _N_BITS + 1)])

    specs = [(s, a, list(m)) for (_, s, a, m) in _JOE_KUO]
    if n_dims - 1 > len(specs):
        # extend with searched primitive polynomials + LCG odd initials
        lcg = 0x9E3779B9
        degree = 1
        while len(specs) < n_dims - 1:
            for a in _primitive_polys(degree):
                if (degree, a) in [(s0, a0) for s0, a0, _ in specs]:
                    continue
                m = []
                for i in range(1, degree + 1):
                    lcg = (lcg * 1664525 + 1013904223) & 0xFFFFFFFF
                    m.append(((lcg >> 8) % (1 << i)) | 1)  # odd, < 2^i
                specs.append((degree, a, m))
                if len(specs) >= n_dims - 1:
                    break
            degree += 1

    for s, a, m in specs[: n_dims - 1]:
        m = list(m)
        for k in range(s, _N_BITS):
            new = m[k - s] ^ (m[k - s] << s)
            for i in range(1, s):
                if (a >> (s - 1 - i)) & 1:
                    new ^= m[k - i] << i
            m.append(new)
        rows.append([m[k] << (_N_BITS - 1 - k) for k in range(_N_BITS)])
    return np.asarray(rows, np.uint32)


_V_CACHE: dict[int, np.ndarray] = {}


def _vectors(n_dims: int) -> np.ndarray:
    if n_dims not in _V_CACHE:
        _V_CACHE[n_dims] = _direction_vectors(n_dims)
    return _V_CACHE[n_dims]


def sobol(key, idx, n_dims: int, scramble: bool = True):
    """Sobol' points.  idx (N,) integer sample indices -> (N, n_dims) in
    [0,1).  `key` drives the per-dimension digital XOR shift."""
    v = jnp.asarray(_vectors(n_dims))  # (D, 32)
    idx = jnp.asarray(idx, jnp.uint32)

    def body(acc, k):
        bit = (idx >> k) & 1  # (N,)
        return acc ^ (v[None, :, k] * bit[:, None].astype(jnp.uint32)), None

    acc0 = jnp.zeros((idx.shape[0], n_dims), jnp.uint32)
    x, _ = jax.lax.scan(body, acc0, jnp.arange(_N_BITS, dtype=jnp.uint32))
    if scramble:
        shift = jax.random.bits(key, (n_dims,), jnp.uint32)
        x = x ^ shift[None, :]
    # keep 24 mantissa-exact bits
    return (x >> 8).astype(jnp.float32) * jnp.float32(2.0 ** -24)


def ld02(key, idx, n_dims: int):
    """ldsampler semantics (ref: src/samplers/ldsampler.cpp): every
    consecutive dimension PAIR is an independently digital-shifted copy of
    the canonical (0,2)-sequence (Sobol dims 1-2) — each 2-D sample request
    sees a full (0,2)-stratified point set, unlike plain Sobol where only
    the first pair is (0,2)."""
    pair = sobol(key, idx, 2, scramble=False)  # canonical (0,2) pair
    bits = (pair * jnp.float32(2.0 ** 24)).astype(jnp.uint32) << 8
    n_pairs = (n_dims + 1) // 2
    shift = jax.random.bits(key, (n_pairs, 2), jnp.uint32)
    x = bits[:, None, :] ^ shift[None, :, :]  # (N, n_pairs, 2)
    x = x.reshape(idx.shape[0], n_pairs * 2)[:, :n_dims]
    return (x >> 8).astype(jnp.float32) * jnp.float32(2.0 ** -24)
