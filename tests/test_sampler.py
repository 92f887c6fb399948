"""Sample-generator tests (halton/hammersley/stratified correctness —
the analog of src/tests/test_samplers.cpp radical-inverse checks)."""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.render.sampler import (
    halton, hammersley, make_sampler, radical_inverse,
)


def test_radical_inverse_base2():
    """First values of the van der Corput sequence in base 2."""
    idx = jnp.arange(8)
    v = np.asarray(radical_inverse(idx, 2))
    np.testing.assert_allclose(
        v, [0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875], atol=1e-6
    )


def test_radical_inverse_base3():
    idx = jnp.arange(4)
    v = np.asarray(radical_inverse(idx, 3))
    np.testing.assert_allclose(v, [0, 1 / 3, 2 / 3, 1 / 9], atol=1e-6)


def test_halton_discrepancy_beats_random():
    """Halton integrates a smooth function with less error than MC."""
    n = 4096
    key = jax.random.PRNGKey(0)
    pts_h = halton(key, jnp.arange(n), 2)
    pts_r = jax.random.uniform(key, (n, 2))

    def f(p):
        return jnp.sin(jnp.pi * p[:, 0]) * p[:, 1] ** 2

    truth = (2 / np.pi) * (1 / 3)
    err_h = abs(float(f(pts_h).mean()) - truth)
    err_r = abs(float(f(pts_r).mean()) - truth)
    assert err_h < err_r, (err_h, err_r)


def test_sampler_ranges():
    for kind in ["independent", "halton", "hammersley", "stratified"]:
        fn = make_sampler(kind)
        u = fn(jax.random.PRNGKey(1), 0, 1000, 8, 1000)
        u = np.asarray(u)
        assert u.shape == (1000, 8)
        assert (u >= 0).all() and (u < 1).all(), kind
        # roughly uniform marginals
        assert abs(u.mean() - 0.5) < 0.05, kind


class TestSobol:
    """Sobol'-sequence structure (analog of the reference sobol.cpp's
    Grünschloß matrices; direction numbers per Joe-Kuo)."""

    def test_first_dims_unscrambled(self):
        """Known first points of dims 1-2 of the canonical sequence."""
        from drmlt_mitsuba.render.sobol import sobol
        pts = np.asarray(sobol(jax.random.PRNGKey(0), jnp.arange(8), 2,
                               scramble=False))
        np.testing.assert_allclose(
            pts[:, 0], [0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875],
            atol=1e-6)
        np.testing.assert_allclose(
            pts[:, 1], [0, 0.5, 0.75, 0.25, 0.625, 0.125, 0.375, 0.875],
            atol=1e-6)

    def test_zero2_sequence_first_pair(self):
        """Dims (1,2) form a (0,2)-sequence: the first 16 points land
        one-per-cell on every base-2 16-cell grid."""
        from drmlt_mitsuba.render.sobol import sobol
        pts = np.asarray(sobol(jax.random.PRNGKey(0), jnp.arange(16), 2,
                               scramble=False))
        for (nx, ny) in [(4, 4), (2, 8), (8, 2), (16, 1), (1, 16)]:
            cx = np.floor(pts[:, 0] * nx).astype(int)
            cy = np.floor(pts[:, 1] * ny).astype(int)
            cells = set(zip(cx.tolist(), cy.tolist()))
            assert len(cells) == 16, (nx, ny)

    def test_ld02_every_pair_is_02(self):
        """ldsampler: EVERY consecutive dim pair is an independently
        shifted (0,2)-sequence (ref ldsampler.cpp semantics)."""
        from drmlt_mitsuba.render.sobol import ld02
        pts = np.asarray(ld02(jax.random.PRNGKey(3), jnp.arange(16), 8))
        for d in range(0, 8, 2):
            for (nx, ny) in [(4, 4), (2, 8), (8, 2)]:
                cx = np.floor(pts[:, d] * nx).astype(int)
                cy = np.floor(pts[:, d + 1] * ny).astype(int)
                cells = set(zip(cx.tolist(), cy.tolist()))
                assert len(cells) == 16, (d, nx, ny)
        # and the pairs differ from each other (independent shifts)
        assert not np.allclose(pts[:, 0:2], pts[:, 2:4])

    def test_one_d_stratification_all_dims(self):
        """Every dim (incl. the searched-polynomial tail) is a base-2
        (0,1)-sequence: first 64 points hit all 64 intervals."""
        from drmlt_mitsuba.render.sobol import sobol
        pts = np.asarray(sobol(jax.random.PRNGKey(0), jnp.arange(64), 40,
                               scramble=False))
        for d in range(40):
            cells = np.floor(pts[:, d] * 64).astype(int)
            assert len(set(cells.tolist())) == 64, d

    def test_scramble_preserves_stratification(self):
        from drmlt_mitsuba.render.sobol import sobol
        pts = np.asarray(sobol(jax.random.PRNGKey(7), jnp.arange(16), 2))
        cx = np.floor(pts[:, 0] * 4).astype(int)
        cy = np.floor(pts[:, 1] * 4).astype(int)
        assert len(set(zip(cx.tolist(), cy.tolist()))) == 16

    def test_make_sampler_sobol(self):
        for kind in ("sobol", "ldsampler"):
            fn = make_sampler(kind)
            u = np.asarray(fn(jax.random.PRNGKey(1), 0, 1000, 8, 1000))
            assert u.shape == (1000, 8)
            assert (u >= 0).all() and (u < 1).all()
            assert abs(u.mean() - 0.5) < 0.05


def test_render_pt_with_ld_samplers():
    """The forward renderer consumes the configured sample generator:
    sobol/halton renders agree with the independent-sampler render and
    cut noise on this smooth scene."""
    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.path import render_pt
    from drmlt_mitsuba.render import film as filmlib
    from drmlt_mitsuba.scene.builders import cornell_box

    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=3, rr_depth=100)
    fc = filmlib.make_film_config(16, 16, "box")
    spp = 64
    means = {}
    for kind in ("independent", "sobol", "halton", "ldsampler"):
        f = render_pt(scene, cfg, jax.random.PRNGKey(0), 16 * 16 * spp,
                      fc, mode="accum", sampler=kind)
        img = np.asarray(filmlib.develop(fc, f, mode="accum"))
        assert np.isfinite(img).all(), kind
        means[kind] = float(img.mean())
    ref = means["independent"]
    for kind, m in means.items():
        assert abs(m - ref) / ref < 0.05, (kind, m, ref)
