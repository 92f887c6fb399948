"""BVH builder tests, and the triangle sweep against a numpy reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.ops.intersect import _tri_sweep
from drmlt_mitsuba.scene import types as st
from drmlt_mitsuba.scene.bvh import (
    build_bvh, build_bvh_native, build_bvh_numpy, validate_bvh,
)


def _soup(T, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-10, 10, (T, 3)).astype(np.float32)
    e1 = rng.uniform(-0.6, 0.6, (T, 3)).astype(np.float32)
    e2 = rng.uniform(-0.6, 0.6, (T, 3)).astype(np.float32)
    return v0, e1, e2


class TestBuilders:
    @pytest.mark.parametrize("leaf", [4, 8, 64, 256])
    def test_native_valid(self, leaf):
        v0, e1, e2 = _soup(3000)
        out = build_bvh_native(v0, e1, e2, max_leaf=leaf)
        if out is None:
            pytest.skip("native builder unavailable (no compiler)")
        bvh, order = out
        assert validate_bvh(bvh, order, v0, e1, e2)
        assert int(np.asarray(bvh.count).max()) <= leaf

    def test_numpy_valid(self):
        v0, e1, e2 = _soup(1000)
        bvh, order = build_bvh_numpy(v0, e1, e2, max_leaf=8)
        assert validate_bvh(bvh, order, v0, e1, e2)

    def test_dfs_layout(self):
        """Inner node's left child is node+1 (depth-first emission)."""
        v0, e1, e2 = _soup(500)
        bvh, _ = build_bvh(v0, e1, e2, max_leaf=8)
        count = np.asarray(bvh.count)
        first = np.asarray(bvh.first)
        inner = count == 0
        np.testing.assert_array_equal(
            first[inner], np.nonzero(inner)[0] + 1
        )


def _np_closest(o, d, v0, e1, e2):
    """Per-ray Moller-Trumbore over every triangle in float64: (t, idx)."""
    o, d, v0, e1, e2 = (np.asarray(a, np.float64) for a in (o, d, v0, e1, e2))
    pvec = np.cross(d[:, None], e2[None])
    det = np.sum(e1[None] * pvec, -1)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tvec = o[:, None] - v0[None]
    b1 = np.sum(tvec * pvec, -1) * inv
    qvec = np.cross(tvec, e1[None])
    b2 = np.sum(d[:, None] * qvec, -1) * inv
    t = np.sum(e2[None] * qvec, -1) * inv
    hit = ok & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) & (t > 1e-4)
    t = np.where(hit, t, np.inf)
    return t.min(-1), np.where(np.isfinite(t.min(-1)), t.argmin(-1), -1)


class TestTriSweep:
    """The chunked XLA sweep (ops/intersect.py) against a plain numpy
    brute force, at triangle counts around the chunk size (padding)."""

    @pytest.mark.parametrize("chunk", [256, 1024])
    @pytest.mark.parametrize("T", [1, 255, 257, 1500])
    def test_closest_matches_numpy(self, T, chunk):
        v0, e1, e2 = _soup(T, seed=T)
        tris = st.TriangleSoA(
            v0=jnp.asarray(v0), e1=jnp.asarray(e1), e2=jnp.asarray(e2),
            n0=jnp.asarray(v0), n1=jnp.asarray(v0), n2=jnp.asarray(v0),
            uv0=jnp.zeros((T, 2)), uv1=jnp.zeros((T, 2)),
            uv2=jnp.zeros((T, 2)), mat_id=jnp.zeros(T, jnp.int32),
            emitter_id=jnp.zeros(T, jnp.int32), valid=jnp.ones(T, bool),
        )
        R = 256
        rng = np.random.default_rng(2)
        o = rng.uniform(-12, 12, (R, 3)).astype(np.float32)
        # aim half the rays at triangle centroids so small T still hits
        tgt = v0[rng.integers(0, T, R)] + (e1[:1] + e2[:1]) / 3
        d = np.where(np.arange(R)[:, None] % 2 == 0, tgt - o,
                     rng.normal(size=(R, 3))).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        bt, bi, _, _ = _tri_sweep(tris, jnp.asarray(o), jnp.asarray(d),
                                  jnp.full((R,), 3e38), True, chunk=chunk)
        any_hit = _tri_sweep(tris, jnp.asarray(o), jnp.asarray(d),
                             jnp.full((R,), 3e38), False, chunk=chunk)
        t_ref, i_ref = _np_closest(o, d, v0, e1, e2)
        hit_ref = np.isfinite(t_ref)
        assert hit_ref.any()
        np.testing.assert_array_equal(np.asarray(any_hit), hit_ref)
        np.testing.assert_array_equal(np.asarray(bi), i_ref)
        np.testing.assert_allclose(np.asarray(bt)[hit_ref], t_ref[hit_ref],
                                   rtol=1e-4)
