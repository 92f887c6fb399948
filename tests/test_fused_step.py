"""Fused-trace DRMLT step == unfused (bitwise chain state, film to fp).

drmlt_step can batch the stage-1/stage-2 (and green reverse) traces into
one trace_fn call and the three state splats into one splat call
(DRMLTConfig.fuse_traces).  The proposals never depend on each other's
trace results (green's reverse path y* = z - (y - x) is built from RAW
proposals, drmlt_proc.cpp:606-616), so fusing must not change the chain
trajectory at all — this pins that invariant for all three DR variants.
"""
import jax
import jax.numpy as jnp
import pytest

from drmlt_mitsuba.integrators.drmlt import DRMLTConfig, drmlt_step
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.mcmc import state_from_splats
from drmlt_mitsuba.integrators.path import make_path_trace
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box


@pytest.mark.parametrize("typ", ["orbital", "mira", "green"])
def test_fused_equals_unfused(typ):
    scene = cornell_box(32, 32)
    pcfg = PathConfig(max_depth=3, rr_depth=100)
    n = pcfg.n_dims + pcfg.n_dims % 2
    trace = make_path_trace(scene, pcfg)
    fc = filmlib.make_film_config(32, 32, "box")
    frozen = jnp.zeros((n,), bool)
    key = jax.random.PRNGKey(7)
    u0 = jax.random.uniform(key, (64, n))
    state0 = state_from_splats(u0, trace(u0))

    finals = []
    for fuse in (True, False):
        cfg = DRMLTConfig(type=typ, n_chains=64, fuse_traces=fuse)
        carry = (state0, filmlib.new_film(fc), None)
        for i in range(4):
            carry, _ = drmlt_step(trace, cfg, fc, frozen, carry,
                                  jax.random.fold_in(key, i))
        finals.append(carry)

    (s1, f1, _), (s2, f2, _) = finals
    assert jnp.array_equal(s1.u, s2.u)          # identical trajectory
    assert jnp.array_equal(s1.lum, s2.lum)
    assert jnp.allclose(f1, f2, rtol=1e-5, atol=1e-7)
