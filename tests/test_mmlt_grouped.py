"""Depth-grouped MMLT (integrators/mmlt_grouped.py): the static per-depth
chain batches must integrate to the same image as the unidirectional path
tracer — same oracle as the pooled flagship test (test_bidir.TestMMLT).
"""
import jax
import numpy as np
import pytest

from drmlt_mitsuba.integrators.bidir import BDPTConfig
from drmlt_mitsuba.integrators.drmlt import DRMLTConfig
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.mmlt_grouped import (
    make_mmlt_trace_fixed, render_drmlt_mmlt_grouped,
)
from drmlt_mitsuba.integrators.path import render_pt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box

W = H = 16


@pytest.fixture(scope="module")
def refs():
    scene = cornell_box(W, H)
    fc = filmlib.make_film_config(W, H, "box")
    film = render_pt(scene, PathConfig(max_depth=3, rr_depth=100),
                     jax.random.PRNGKey(43), 16384 * 16, fc, mode="accum")
    pt3 = np.asarray(filmlib.develop(fc, film, mode="accum")).mean((0, 1))
    return scene, fc, pt3


def test_fixed_trace_is_unbiased_per_depth(refs):
    """Sum over k of E[trace_fixed_k] = the PT image (each group's trace
    is the depth-k transport restriction with no depth-pmf factor)."""
    import jax.numpy as jnp

    scene, fc, pt3 = refs
    total = np.zeros(3)
    for k in (1, 2, 3):
        trace, _, n_dims = make_mmlt_trace_fixed(scene, k)

        @jax.jit
        def run(key, film, trace=trace, n_dims=n_dims):
            u = jax.random.uniform(key, (4096, n_dims))
            sp = trace(u)
            pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
            return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                                 mode="splat")

        film = filmlib.new_film(fc)
        n = 16
        for i in range(n):
            film = run(jax.random.fold_in(jax.random.PRNGKey(60 + k), i),
                       film)
        img = np.asarray(filmlib.develop(fc, film, mode="splat",
                                         scale=W * H / (n * 4096)))
        total += img.mean(axis=(0, 1))[:3]
    np.testing.assert_allclose(total, pt3, rtol=0.1)


def test_grouped_drmlt_matches_pt(refs):
    """End-to-end: depth-grouped DRMLT(orbital)-over-MMLT == PT."""
    scene, fc, pt3 = refs
    img, aux = render_drmlt_mmlt_grouped(
        scene, BDPTConfig(max_depth=3),
        DRMLTConfig(type="orbital", n_chains=1024, n_bootstrap=16384),
        fc, jax.random.PRNGKey(3), 500, min_group=128,
    )
    img = np.asarray(img)
    assert np.all(np.isfinite(img))
    err = np.abs(img.mean((0, 1)) - pt3).mean() / pt3.mean()
    assert err < 0.15, err
    # allocation follows the per-depth luminance masses
    assert aux["sizes"][0] > 0 and sum(aux["sizes"]) > 0
    assert aux["b"] > 0


def test_grouped_fix_emitter_path(refs):
    scene, fc, pt3 = refs
    img, _ = render_drmlt_mmlt_grouped(
        scene, BDPTConfig(max_depth=3),
        DRMLTConfig(type="green", n_chains=1024, n_bootstrap=16384,
                    fix_emitter_path=True),
        fc, jax.random.PRNGKey(4), 500, min_group=128,
    )
    img = np.asarray(img)
    assert np.all(np.isfinite(img))
    err = np.abs(img.mean((0, 1)) - pt3).mean() / pt3.mean()
    assert err < 0.2, err


@pytest.mark.parametrize("dr_type", ["green", "mira", "orbital"])
def test_grouped_drmlt_types_match_pt(refs, dr_type):
    """Every DRMLT second-stage type over the depth-grouped MMLT driver
    integrates to the PT image (small chain count, short chains)."""
    scene, fc, pt3 = refs
    img, _ = render_drmlt_mmlt_grouped(
        scene, BDPTConfig(max_depth=3),
        DRMLTConfig(type=dr_type, n_chains=256, n_bootstrap=16384),
        fc, jax.random.PRNGKey(11), 400)
    img = np.asarray(img)
    assert np.all(np.isfinite(img))
    err = np.abs(img.mean((0, 1)) - pt3).mean() / pt3.mean()
    assert err < 0.15, err
