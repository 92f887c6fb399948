"""trace_mmlt (per-lane gathered single-strategy) == trace_mmlt_dense
(all-strategy sweep + mask), lane for lane.

The fast path replaces the O(depth^2) strategy sweep with per-lane vertex
gathers + one connection + one shadow ray + a mask-controlled MIS
recursion; both must produce identical selected-strategy values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.integrators.bidir import (
    BDPTConfig, trace_mmlt, trace_mmlt_dense,
)
from drmlt_mitsuba.scene.builders import cornell_box

R = 2048


def _compare(scene, cfg, seed=0):
    n = 1 + cfg.n_dims
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (R, n))
    depth = 1 + jax.random.randint(jax.random.fold_in(key, 1), (R,), 0,
                                   cfg.max_depth)
    a = trace_mmlt_dense(scene, cfg, u, depth)
    b = trace_mmlt(scene, cfg, u, depth)
    va, vb = np.asarray(a.value[:, 0]), np.asarray(b.value[:, 0])
    pa, pb = np.asarray(a.pos[:, 0]), np.asarray(b.pos[:, 0])
    rel = np.abs(va - vb) / (np.abs(va) + 1e-4)
    bad = (rel > 1e-3).any(-1)
    assert bad.sum() <= R // 1000, (
        f"{bad.sum()} lanes diverge; worst {rel.max()}"
    )
    np.testing.assert_allclose(va.mean(0), vb.mean(0), rtol=2e-3, atol=1e-5)
    # splat positions agree where values are nonzero (light-tracing lanes
    # splat at the sensor-importance uv)
    lit = (np.abs(va) > 0).any(-1) & ~bad
    np.testing.assert_allclose(pa[lit], pb[lit], atol=1e-6)


@pytest.mark.parametrize("tall", ["diffuse", "mirror", "roughconductor"])
def test_mmlt_selected_matches_dense(tall):
    scene = cornell_box(32, 32, tall_box_material=tall)
    _compare(scene, BDPTConfig(max_depth=5))


def test_mmlt_selected_matches_dense_no_light_image():
    scene = cornell_box(32, 32)
    _compare(scene, BDPTConfig(max_depth=4, light_image=False), seed=2)


def test_mmlt_selected_matches_dense_point_light():
    from drmlt_mitsuba.scene import types as st

    scene = cornell_box(32, 32)
    tris = scene.tris.replace(
        emitter_id=jnp.full_like(scene.tris.emitter_id, -1)
    )
    em = st.build_emitters(
        tris, np.zeros((0, 3), np.float32),
        point_pos=np.asarray([[278.0, 500.0, 279.5]]),
        point_intensity=np.asarray([[4e5, 3.4e5, 1.7e5]]),
    )
    scene = scene.replace(tris=tris, emitters=em)
    _compare(scene, BDPTConfig(max_depth=4), seed=3)
