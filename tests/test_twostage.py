"""Two-stage MLT, timidAfterLarge, and determinism tests."""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.drmlt import DRMLTConfig, render_drmlt
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import render_pt, trace_paths
from drmlt_mitsuba.integrators.pssmlt import PSSMLTConfig, render_pssmlt
from drmlt_mitsuba.integrators.twostage import (
    apply_importance_to_image, luminance_pass, sample_importance,
    with_importance_map,
)
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box


def test_importance_map_lookup():
    imap = jnp.arange(16.0).reshape(4, 4) + 1.0
    # center of pixel (1, 2) -> value row2 col1 = 2*4+1+1 = 10
    v = sample_importance(imap, jnp.asarray([[(1 + 0.5) / 4, (2 + 0.5) / 4]]))
    np.testing.assert_allclose(float(v[0]), 10.0, atol=1e-5)


def test_two_stage_consistency():
    """PSSMLT with a two-stage importance map converges to the same image
    as plain PSSMLT (the map reweights chains, not the answer)."""
    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=3, rr_depth=100)
    fc = filmlib.make_film_config(16, 16, "box")
    film = render_pt(scene, cfg, jax.random.PRNGKey(42), 16384 * 16, fc,
                     mode="accum")
    ref = np.asarray(filmlib.develop(fc, film, mode="accum"))

    def lowres(w, h):
        fc2 = filmlib.make_film_config(w, h, "box")
        f2 = render_pt(scene, cfg, jax.random.PRNGKey(9), w * h * 256, fc2,
                       mode="accum")
        return filmlib.develop(fc2, f2, mode="accum")

    imap = luminance_pass(lowres, fc, downsample=4)
    trace = with_importance_map(lambda u: trace_paths(scene, cfg, u), imap)
    img, aux = render_pssmlt(
        trace, PSSMLTConfig(n_chains=1024, n_bootstrap=16384,
                            kelemen_style_weights=False),
        fc, jax.random.PRNGKey(1), cfg.n_dims, 600,
    )
    img = np.asarray(apply_importance_to_image(img, imap))
    assert np.all(np.isfinite(img))
    err = np.abs(img.mean((0, 1)) - ref.mean((0, 1))).mean() / ref.mean()
    assert err < 0.15, err


def test_timid_after_large():
    """timidAfterLarge lets stage 2 fire after large steps too; the render
    stays consistent."""
    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=3, rr_depth=100)
    fc = filmlib.make_film_config(16, 16, "box")
    film = render_pt(scene, cfg, jax.random.PRNGKey(42), 16384 * 8, fc,
                     mode="accum")
    ref = np.asarray(filmlib.develop(fc, film, mode="accum"))
    trace = lambda u: trace_paths(scene, cfg, u[:, : cfg.n_dims])
    n_dims = cfg.n_dims + cfg.n_dims % 2
    img, aux = render_drmlt(
        trace, DRMLTConfig(type="orbital", n_chains=1024,
                           n_bootstrap=16384, timid_after_large=True),
        fc, jax.random.PRNGKey(2), n_dims, 500,
    )
    img = np.asarray(img)
    err = np.abs(img.mean((0, 1)) - ref.mean((0, 1))).mean() / ref.mean()
    assert err < 0.15, err


def test_determinism():
    """Same seed => bitwise-identical film (SURVEY §5.2: the determinism
    analog of race detection)."""
    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=2, rr_depth=100)
    fc = filmlib.make_film_config(16, 16, "box")
    trace = lambda u: trace_paths(scene, cfg, u)
    mcfg = PSSMLTConfig(n_chains=256, n_bootstrap=4096,
                        kelemen_style_weights=False)
    img1, _ = render_pssmlt(trace, mcfg, fc, jax.random.PRNGKey(5),
                            cfg.n_dims, 50)
    img2, _ = render_pssmlt(trace, mcfg, fc, jax.random.PRNGKey(5),
                            cfg.n_dims, 50)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
