"""Film splatting tests (ImageBlock::put semantics)."""
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.render import film as filmlib


def test_splat_conserves_energy_all_filters():
    """A splat in splat-mode deposits exactly its value (footprint weights
    normalized), for every reconstruction filter."""
    for name in ["box", "tent", "gaussian", "mitchell", "catmullrom", "lanczos"]:
        cfg = filmlib.make_film_config(16, 16, name)
        f = filmlib.new_film(cfg)
        pos = jnp.asarray([[7.3, 8.9], [3.0, 3.0]])
        val = jnp.asarray([[1.0, 2.0, 3.0], [0.5, 0.5, 0.5]])
        f = filmlib.splat(cfg, f, pos, val, mode="splat")
        total = np.asarray(jnp.sum(f[..., :3], axis=(0, 1)))
        np.testing.assert_allclose(total, [1.5, 2.5, 3.5], atol=1e-5, err_msg=name)


def test_splat_weighted():
    cfg = filmlib.make_film_config(8, 8, "box")
    f = filmlib.new_film(cfg)
    pos = jnp.asarray([[4.5, 4.5]])
    val = jnp.asarray([[1.0, 1.0, 1.0]])
    f = filmlib.splat(cfg, f, pos, val, weight=jnp.asarray([0.25]), mode="splat")
    np.testing.assert_allclose(float(jnp.sum(f[..., 0])), 0.25, atol=1e-6)


def test_border_clipping():
    """Splats at the image border lose out-of-bounds taps but stay finite."""
    cfg = filmlib.make_film_config(8, 8, "gaussian")
    f = filmlib.new_film(cfg)
    pos = jnp.asarray([[0.1, 0.1], [7.9, 7.9]])
    val = jnp.ones((2, 3))
    f = filmlib.splat(cfg, f, pos, val, mode="splat")
    assert bool(jnp.all(jnp.isfinite(f)))
    # energy still conserved: in-image weights renormalized
    np.testing.assert_allclose(float(jnp.sum(f[..., 0])), 2.0, atol=1e-5)


def test_accum_develop_average():
    """ACCUM mode divides by filter weight: constant-radiance samples
    develop to that constant."""
    cfg = filmlib.make_film_config(4, 4, "tent")
    f = filmlib.new_film(cfg)
    n = 4000
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.uniform(0, 4, size=(n, 2)), jnp.float32)
    val = jnp.ones((n, 3)) * 2.0
    f = filmlib.splat(cfg, f, pos, val, mode="accum")
    img = filmlib.develop(cfg, f, mode="accum")
    np.testing.assert_allclose(np.asarray(img), 2.0, atol=1e-4)


def _np_splat(cfg, pos, value, weight, mode):
    """Plain reference: every splat weighs every pixel by the separable
    filter at the pixel centre (zero outside the filter radius)."""
    f = cfg.filter
    film = np.zeros((cfg.height, cfg.width, 4))
    cx = np.arange(cfg.width) + 0.5
    cy = np.arange(cfg.height) + 0.5
    for (x, y), v, w in zip(pos, value, weight):
        wx = np.asarray(f.eval1d(jnp.asarray(cx - x, jnp.float32)), np.float64)
        wy = np.asarray(f.eval1d(jnp.asarray(cy - y, jnp.float32)), np.float64)
        w2 = wy[:, None] * wx[None, :]
        if mode == "splat":
            w2 = w2 / max(w2.sum(), 1e-12)
        film += w2[..., None] * np.concatenate([v * w, [w]])[None, None]
    return film


@pytest.mark.parametrize("mode", ["splat", "accum"])
@pytest.mark.parametrize("name", ["box", "tent", "gaussian", "mitchell",
                                  "catmullrom", "lanczos"])
def test_scatter_splat_matches_reference(name, mode):
    """The scatter-add splat (render/film.py) against the dense numpy
    reference, on a non-square film with weighted splats near borders."""
    cfg = filmlib.make_film_config(13, 9, name)
    rng = np.random.default_rng(3)
    n = 64
    pos = rng.uniform([-0.5, -0.5], [13.5, 9.5], (n, 2)).astype(np.float32)
    val = rng.gamma(1.0, 1.0, (n, 3)).astype(np.float32)
    w = rng.uniform(0, 1, n).astype(np.float32)
    got = filmlib.splat(cfg, filmlib.new_film(cfg), jnp.asarray(pos),
                        jnp.asarray(val), jnp.asarray(w), mode=mode)
    want = _np_splat(cfg, pos, val, w, mode)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)
