"""BVH build: native C++ binned-SAH builder (native/bvh_builder.cpp via
ctypes) with a pure-numpy median-split fallback.

The BVH is the analog of ShapeKDTree (include/mitsuba/render/skdtree.h);
flattened depth-first with escape pointers so traversal needs no stack.
Intersection itself is a brute-force sweep today (ops/intersect.py); the
BVH is kept for the per-ray traversal meant to replace it.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

import jax.numpy as jnp

from drmlt_mitsuba.scene.types import BVH
from drmlt_mitsuba.utils.native import build_native, native_path

_LIB_PATH = native_path("libdrmlt_native.so")
_lib = None


def _load_native():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            build_native("libdrmlt_native.so", timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.drmlt_build_bvh.restype = ctypes.c_int
    lib.drmlt_build_bvh.argtypes = [
        ctypes.POINTER(ctypes.c_float)] * 3 + [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    _lib = lib
    return lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def build_bvh_native(v0, e1, e2, max_leaf: int = 8):
    """C++ binned-SAH build; returns (BVH, tri_order) or None if the native
    library is unavailable."""
    lib = _load_native()
    if lib is None:
        return None
    n = len(v0)
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    max_nodes = max(4, 2 * n)
    nmin = np.zeros((max_nodes, 3), np.float32)
    nmax = np.zeros((max_nodes, 3), np.float32)
    first = np.zeros(max_nodes, np.int32)
    count = np.zeros(max_nodes, np.int32)
    skip = np.zeros(max_nodes, np.int32)
    order = np.zeros(n, np.int32)
    n_nodes = lib.drmlt_build_bvh(
        _fp(v0), _fp(e1), _fp(e2), n, max_leaf,
        _fp(nmin), _fp(nmax), _ip(first), _ip(count), _ip(skip),
        _ip(order), max_nodes,
    )
    if n_nodes < 0:
        return None
    bvh = BVH(
        nodes_min=jnp.asarray(nmin[:n_nodes]),
        nodes_max=jnp.asarray(nmax[:n_nodes]),
        first=jnp.asarray(first[:n_nodes]),
        count=jnp.asarray(count[:n_nodes]),
        skip=jnp.asarray(skip[:n_nodes]),
    )
    return bvh, order


def build_bvh_numpy(v0, e1, e2, max_leaf: int = 8):
    """Median-split fallback builder (same output contract)."""
    v0 = np.asarray(v0, np.float32)
    p1 = v0 + np.asarray(e1, np.float32)
    p2 = v0 + np.asarray(e2, np.float32)
    lo = np.minimum(np.minimum(v0, p1), p2)
    hi = np.maximum(np.maximum(v0, p1), p2)
    cent = 0.5 * (lo + hi)
    n = len(v0)
    order = np.arange(n)
    nodes = []  # (lo, hi, first, count, left, right)

    def rec(first, count):
        idx = order[first:first + count]
        blo = lo[idx].min(axis=0)
        bhi = hi[idx].max(axis=0)
        self_i = len(nodes)
        nodes.append([blo, bhi, first, count, -1, -1])
        if count <= max_leaf:
            return self_i
        c = cent[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        key = c[:, axis]
        perm = np.argsort(key, kind="stable")
        order[first:first + count] = idx[perm]
        mid = first + count // 2
        l = rec(first, mid - first)
        r = rec(mid, first + count - mid)
        nodes[self_i][3] = 0
        nodes[self_i][4] = l
        nodes[self_i][5] = r
        return self_i

    rec(0, n)
    n_nodes = len(nodes)
    skip = np.full(n_nodes, -1, np.int32)

    def fill(i, s):
        skip[i] = s
        if nodes[i][3] == 0:
            fill(nodes[i][4], nodes[i][5])
            fill(nodes[i][5], s)

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    fill(0, -1)
    sys.setrecursionlimit(old)

    bvh = BVH(
        nodes_min=jnp.asarray(np.stack([x[0] for x in nodes])),
        nodes_max=jnp.asarray(np.stack([x[1] for x in nodes])),
        first=jnp.asarray(np.asarray(
            [x[2] if x[3] > 0 else x[4] for x in nodes], np.int32)),
        count=jnp.asarray(np.asarray([x[3] for x in nodes], np.int32)),
        skip=jnp.asarray(skip),
    )
    return bvh, order.astype(np.int32)


def build_bvh(v0, e1, e2, max_leaf: int = 8):
    """Preferred entry: native builder with numpy fallback."""
    out = build_bvh_native(v0, e1, e2, max_leaf)
    if out is None:
        out = build_bvh_numpy(v0, e1, e2, max_leaf)
    return out


def validate_bvh(bvh: BVH, order, v0, e1, e2) -> bool:
    """Structural invariants: every triangle in exactly one leaf; leaf
    bounds contain their triangles; skip pointers form a DFS."""
    count = np.asarray(bvh.count)
    first = np.asarray(bvh.first)
    nmin = np.asarray(bvh.nodes_min)
    nmax = np.asarray(bvh.nodes_max)
    n_tris = len(order)
    seen = np.zeros(n_tris, bool)
    v0 = np.asarray(v0)
    p1 = v0 + np.asarray(e1)
    p2 = v0 + np.asarray(e2)
    for i in range(len(count)):
        if count[i] > 0:
            idx = order[first[i]:first[i] + count[i]]
            assert not seen[idx].any(), "triangle in two leaves"
            seen[idx] = True
            for p in (v0[idx], p1[idx], p2[idx]):
                if not (
                    (p >= nmin[i] - 1e-3).all() and (p <= nmax[i] + 1e-3).all()
                ):
                    return False
    return bool(seen.all())
