"""4x4 homogeneous transforms (ref: include/mitsuba/core/transform.h).

Transforms are plain (4, 4) float32 arrays; helpers build the standard
look-at / scale / translate / rotate matrices used by the Mitsuba XML scene
subset, and apply them to points/vectors/normals with broadcasting.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# f32 products stay f32 on every backend (a GPU may otherwise use TF32)
HIGHEST = jax.lax.Precision.HIGHEST


def identity():
    return jnp.eye(4, dtype=jnp.float32)


def translate(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, dtype=np.float32)
    return jnp.asarray(m)


def scale(v):
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = np.broadcast_to(np.asarray(v, np.float32), (3,))
    return jnp.asarray(m)


def rotate(axis, angle_deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(float(angle_deg))
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ]
    )
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r.astype(np.float32)
    return jnp.asarray(m)


def look_at(origin, target, up):
    """Camera-to-world transform, Mitsuba convention (+z = view direction)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    d = target - origin
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    new_up = np.cross(d, left)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return jnp.asarray(m)


def apply_point(m, p):
    """Apply (4,4) to points (..., 3)."""
    return jnp.matmul(p, m[:3, :3].T, precision=HIGHEST) + m[:3, 3]


def apply_vector(m, v):
    return jnp.matmul(v, m[:3, :3].T, precision=HIGHEST)


def apply_normal(m, n):
    """Normals transform by the inverse-transpose of the linear part."""
    inv = jnp.linalg.inv(m[:3, :3])
    return jnp.matmul(n, inv, precision=HIGHEST)
