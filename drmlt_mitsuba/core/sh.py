"""Real spherical harmonics, bands l = 0..3 (16 coefficients).

Capability match for the reference's SH utilities (include/mitsuba/core/
shvector.h — evaluation, projection, dot products).  Batch form: `eval_sh`
is a pure elementwise map (..., 3) -> (..., 16) of hardcoded real-SH
polynomials (no recurrences, fully vectorizable), and
projection/reconstruction are plain matmuls over sample batches.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

N_COEFFS = 16  # bands 0..3


def eval_sh(d):
    """Evaluate the 16 real SH basis functions at unit directions d
    (..., 3) -> (..., 16), Condon-Shortley-free convention."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    return jnp.stack([
        jnp.full_like(x, 0.28209479177387814),          # l=0
        0.4886025119029199 * y,                          # l=1, m=-1
        0.4886025119029199 * z,                          # l=1, m=0
        0.4886025119029199 * x,                          # l=1, m=1
        1.0925484305920792 * x * y,                      # l=2, m=-2
        1.0925484305920792 * y * z,                      # l=2, m=-1
        0.31539156525252005 * (3.0 * z2 - 1.0),          # l=2, m=0
        1.0925484305920792 * x * z,                      # l=2, m=1
        0.5462742152960396 * (x2 - y2),                  # l=2, m=2
        0.5900435899266435 * y * (3.0 * x2 - y2),        # l=3, m=-3
        2.890611442640554 * x * y * z,                   # l=3, m=-2
        0.4570457994644658 * y * (5.0 * z2 - 1.0),       # l=3, m=-1
        0.3731763325901154 * z * (5.0 * z2 - 3.0),       # l=3, m=0
        0.4570457994644658 * x * (5.0 * z2 - 1.0),       # l=3, m=1
        1.445305721320277 * z * (x2 - y2),               # l=3, m=2
        0.5900435899266435 * x * (x2 - 3.0 * y2),        # l=3, m=3
    ], axis=-1)


def project(values, dirs):
    """Monte-Carlo SH projection of a spherical function sampled uniformly:
    values (N,) or (N, C) at unit dirs (N, 3) -> coeffs (16,) or (16, C)."""
    basis = eval_sh(dirs)                      # (N, 16)
    n = dirs.shape[0]
    v = values if values.ndim > 1 else values[:, None]
    coeffs = jnp.matmul(basis.T, v, precision=HIGHEST) * (
        4.0 * jnp.pi / n)                      # uniform-sphere pdf 1/4pi
    return coeffs if values.ndim > 1 else coeffs[:, 0]


def reconstruct(coeffs, dirs):
    """Evaluate the SH expansion at unit dirs: (16,)|(16, C), (N, 3) ->
    (N,)|(N, C)."""
    basis = eval_sh(dirs)
    return jnp.matmul(basis, coeffs, precision=HIGHEST)
