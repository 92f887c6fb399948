"""Hair shape: .hair fiber loader + tube tessellation (ref:
src/shapes/hair.cpp, hair.h).

The reference intersects analytic cylinder segments with miter joints
through a dedicated kd-tree specialization (hair.cpp:199-520).  A second
intersection primitive would fragment the triangle sweep, so the
native equivalent tessellates each fiber into a k-sided tube whose rings
sit at the fiber vertices with miter tangents (the same joint geometry the
reference clips its cylinders to) and radial smooth normals; the triangles
then ride the normal triangle path.  Section count trades accuracy
for triangle count (k=3 is visually indistinguishable at hair radii).

File format (hair.cpp:638-760): binary "BINARY_HAIR" header + uint32
vertex count + little-endian float32 triplets where an +inf x marks the
start of a new fiber (the actual x follows); or plain text with one
"x y z" per line and blank lines separating fibers.  The reference's
angle-threshold vertex merging (hair.cpp:612-614, default 1 degree) is
applied after loading.
"""
from __future__ import annotations

import numpy as np


def load_hair(path: str):
    """Returns (vertices (N,3) float32, fiber_id (N,) int32)."""
    with open(path, "rb") as f:
        head = f.read(11)
    verts = []
    fiber = []
    if head == b"BINARY_HAIR":
        raw = np.fromfile(path, np.uint8, offset=11)
        count = int(np.frombuffer(raw[:4].tobytes(), np.uint32)[0])
        data = np.frombuffer(raw[4:].tobytes(), "<f4")
        i = 0
        fid = -1
        read = 0
        while read < count and i + 2 < len(data):
            x = data[i]
            if np.isinf(x):
                fid += 1
                i += 1
            p = data[i:i + 3]
            if len(p) < 3:
                break
            verts.append(p)
            fiber.append(max(fid, 0))
            i += 3
            read += 1
    else:
        fid = 0
        fresh = True
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    if not fresh:
                        fid += 1
                        fresh = True
                    continue
                parts = line.split()
                if len(parts) < 3:
                    continue
                verts.append([float(parts[0]), float(parts[1]),
                              float(parts[2])])
                fiber.append(fid)
                fresh = False
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    return v, np.asarray(fiber, np.int32)


def simplify_fibers(v, fiber, angle_deg: float = 1.0):
    """Drop vertices whose tangent changes less than angle_deg (the
    reference's dpThresh merging)."""
    if len(v) < 3:
        return v, fiber
    keep = np.ones(len(v), bool)
    dp_thresh = np.cos(np.deg2rad(angle_deg))
    last_kept = 0
    for i in range(1, len(v) - 1):
        if fiber[i] != fiber[i - 1] or fiber[i + 1] != fiber[i]:
            last_kept = i
            continue
        t0 = v[i] - v[last_kept]
        t1 = v[i + 1] - v[i]
        n0 = np.linalg.norm(t0)
        n1 = np.linalg.norm(t1)
        if n0 < 1e-12 or n1 < 1e-12:
            keep[i] = False
            continue
        if np.dot(t0, t1) / (n0 * n1) > dp_thresh:
            keep[i] = False
        else:
            last_kept = i
    return v[keep], fiber[keep]


def tessellate_hair(v, fiber, radius: float, sides: int = 3):
    """Tube tessellation: one k-ring per fiber vertex on the miter
    tangent's perpendicular plane, 2k triangles per segment, radial
    normals.  Returns (verts (M,3), faces (F,3), normals (M,3))."""
    n = len(v)
    if n < 2:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros((0, 3), np.float32))
    same_prev = np.zeros(n, bool)
    same_prev[1:] = fiber[1:] == fiber[:-1]
    same_next = np.zeros(n, bool)
    same_next[:-1] = same_prev[1:]

    seg_prev = np.zeros((n, 3), np.float32)
    seg_prev[1:] = v[1:] - v[:-1]
    seg_next = np.zeros((n, 3), np.float32)
    seg_next[:-1] = v[1:] - v[:-1]

    def _norm(a):
        return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True),
                              1e-12)

    tan = _norm(np.where(same_prev[:, None], seg_prev, 0.0)
                + np.where(same_next[:, None], seg_next, 0.0))

    # branchless orthonormal frame per vertex (Duff et al.)
    sign = np.where(tan[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + tan[:, 2])
    b = tan[:, 0] * tan[:, 1] * a
    t1 = np.stack([1.0 + sign * tan[:, 0] ** 2 * a, sign * b,
                   -sign * tan[:, 0]], -1)
    t2 = np.stack([b, sign + tan[:, 1] ** 2 * a, -tan[:, 1]], -1)

    ang = 2.0 * np.pi * np.arange(sides) / sides
    # rings: (n, sides, 3)
    offs = (np.cos(ang)[None, :, None] * t1[:, None, :]
            + np.sin(ang)[None, :, None] * t2[:, None, :])
    rings = v[:, None, :] + radius * offs
    verts = rings.reshape(-1, 3).astype(np.float32)
    normals = offs.reshape(-1, 3).astype(np.float32)

    seg_start = np.nonzero(same_next)[0]  # vertex i starts a segment
    k = sides
    i0 = seg_start[:, None] * k + np.arange(k)[None, :]
    i1 = seg_start[:, None] * k + (np.arange(k)[None, :] + 1) % k
    j0 = i0 + k
    j1 = i1 + k
    f_a = np.stack([i0, i1, j1], -1).reshape(-1, 3)
    f_b = np.stack([i0, j1, j0], -1).reshape(-1, 3)
    faces = np.concatenate([f_a, f_b]).astype(np.int32)
    return verts, faces, normals
