"""Media in the bidirectional layer (VERDICT round-1 missing item #3).

Walks produce medium-scatter vertices (distance sampling per segment),
connections use the phase function and edge transmittance, and all MIS
pdfs carry the distance-sampling factors (ref: vertex.cpp:273
EMediumInteraction, src/libbidir/edge.cpp).  Oracles: BDPT == volpath-PT
on a foggy Cornell, and the fast selected-strategy MMLT == the dense
sweep lane-for-lane in a medium.
"""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.bidir import (
    BDPTConfig, trace_bdpt, trace_mmlt, trace_mmlt_dense,
)
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import render_pt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.render.medium import make_medium
from drmlt_mitsuba.scene.builders import cornell_box

W = H = 16


def _fog_scene(g=0.0):
    scene = cornell_box(W, H)
    # mean free path ~ 700 units in a ~550-unit box: a light, visibly
    # scattering haze that keeps depth-3 transport meaningful
    return scene.replace(
        medium=make_medium((0.0014, 0.0014, 0.0014), (0.8, 0.8, 0.8), g)
    )


def test_bdpt_fog_matches_volpath_pt():
    scene = _fog_scene()
    fc = filmlib.make_film_config(W, H, "box")
    f = render_pt(scene, PathConfig(max_depth=3, rr_depth=100),
                  jax.random.PRNGKey(0), 16384 * 24, fc, mode="accum")
    pt = np.asarray(filmlib.develop(fc, f, mode="accum")).mean(axis=(0, 1))

    bcfg = BDPTConfig(max_depth=3, medium=True)

    @jax.jit
    def run(key, film):
        u = jax.random.uniform(key, (4096, bcfg.n_dims))
        sp = trace_bdpt(scene, bcfg, u)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                             mode="splat")

    film = filmlib.new_film(fc)
    n = 24
    for i in range(n):
        film = run(jax.random.fold_in(jax.random.PRNGKey(3), i), film)
    bd = np.asarray(
        filmlib.develop(fc, film, mode="splat", scale=W * H / (n * 4096))
    ).mean(axis=(0, 1))
    np.testing.assert_allclose(bd, pt, rtol=0.1)


def test_mmlt_selected_matches_dense_fog():
    scene = _fog_scene(g=0.3)
    cfg = BDPTConfig(max_depth=4, medium=True)
    R = 2048
    key = jax.random.PRNGKey(9)
    u = jax.random.uniform(key, (R, 1 + cfg.n_dims))
    depth = 1 + jax.random.randint(jax.random.fold_in(key, 1), (R,), 0,
                                   cfg.max_depth)
    a = trace_mmlt_dense(scene, cfg, u, depth)
    b = trace_mmlt(scene, cfg, u, depth)
    va, vb = np.asarray(a.value[:, 0]), np.asarray(b.value[:, 0])
    rel = np.abs(va - vb) / (np.abs(va) + 1e-4)
    bad = (rel > 1e-3).any(-1)
    assert bad.sum() <= R // 1000, f"{bad.sum()} lanes, worst {rel.max()}"
    np.testing.assert_allclose(va.mean(0), vb.mean(0), rtol=2e-3, atol=1e-5)


def test_bdpt_fog_without_flag_is_surface_only():
    """cfg.medium=False in a medium scene keeps the surface-only layout
    (dims unchanged) and runs without error."""
    scene = _fog_scene()
    cfg_s = BDPTConfig(max_depth=3, medium=False)
    assert cfg_s.n_dims == BDPTConfig(max_depth=3).n_dims
    u = jax.random.uniform(jax.random.PRNGKey(1), (256, cfg_s.n_dims))
    sp = trace_bdpt(scene, cfg_s, u)
    assert np.all(np.isfinite(np.asarray(sp.value)))


def test_bdpt_rayleigh_fog_matches_volpath_pt():
    """BDPT in a Rayleigh-phase fog agrees with unidirectional volpath —
    the generalized phase dispatch (eval/pdf/sample + reverse pdfs) in
    the bidirectional layer."""
    from drmlt_mitsuba.render.medium import PHASE_RAYLEIGH

    scene = cornell_box(W, H).replace(
        medium=make_medium((0.0014,) * 3, (0.8,) * 3,
                           phase_kind=PHASE_RAYLEIGH))
    fc = filmlib.make_film_config(W, H, "box")
    f = render_pt(scene, PathConfig(max_depth=3, rr_depth=100),
                  jax.random.PRNGKey(1), 16384 * 24, fc, mode="accum")
    pt = np.asarray(filmlib.develop(fc, f, mode="accum")).mean(axis=(0, 1))

    bcfg = BDPTConfig(max_depth=3, medium=True)

    @jax.jit
    def run(key, film):
        u = jax.random.uniform(key, (4096, bcfg.n_dims))
        sp = trace_bdpt(scene, bcfg, u)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                             mode="splat")

    film = filmlib.new_film(fc)
    n = 24
    for i in range(n):
        film = run(jax.random.fold_in(jax.random.PRNGKey(5), i), film)
    bd = np.asarray(
        filmlib.develop(fc, film, mode="splat", scale=W * H / (n * 4096))
    ).mean(axis=(0, 1))
    np.testing.assert_allclose(bd, pt, rtol=0.1)


def test_bdpt_mixture_fog_matches_volpath_pt():
    """Same consistency oracle with a 2-component mixturephase."""
    from drmlt_mitsuba.render.medium import PHASE_MIXTURE

    scene = cornell_box(W, H).replace(
        medium=make_medium((0.0014,) * 3, (0.8,) * 3,
                           phase_kind=PHASE_MIXTURE,
                           mixture=[("hg", 0.5, 0.6),
                                    ("rayleigh", 0.0, 0.4)]))
    fc = filmlib.make_film_config(W, H, "box")
    f = render_pt(scene, PathConfig(max_depth=3, rr_depth=100),
                  jax.random.PRNGKey(2), 16384 * 24, fc, mode="accum")
    pt = np.asarray(filmlib.develop(fc, f, mode="accum")).mean(axis=(0, 1))

    bcfg = BDPTConfig(max_depth=3, medium=True)

    @jax.jit
    def run(key, film):
        u = jax.random.uniform(key, (4096, bcfg.n_dims))
        sp = trace_bdpt(scene, bcfg, u)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                             mode="splat")

    film = filmlib.new_film(fc)
    n = 24
    for i in range(n):
        film = run(jax.random.fold_in(jax.random.PRNGKey(6), i), film)
    bd = np.asarray(
        filmlib.develop(fc, film, mode="splat", scale=W * H / (n * 4096))
    ).mean(axis=(0, 1))
    np.testing.assert_allclose(bd, pt, rtol=0.1)


def _hetero_fog_scene(g=0.0):
    """Cornell filled with a smooth low-frequency density grid."""
    from drmlt_mitsuba.render.medium import make_hetero_medium

    scene = cornell_box(W, H)
    z, y, x = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 1, 9),
                          np.linspace(0, 1, 9), indexing="ij")
    dens = (0.5 + 0.5 * np.sin(3.0 * x) * np.cos(2.0 * y)
            + 0.3 * z).astype(np.float32)
    # world box ~ [0,556]x[0,549]x[0,560] -> unit cube
    w2g = np.diag([1 / 556.0, 1 / 549.0, 1 / 560.0, 1.0]).astype(np.float32)
    med = make_hetero_medium(dens, w2g, (0.002, 0.002, 0.002),
                             (0.8, 0.8, 0.8), g)
    return scene.replace(medium=med)


def test_bdpt_hetero_fog_matches_volpath_pt():
    """Heterogeneous media inside bidir walks (VERDICT r2 #5): BDPT with
    Woodcock-sampled medium vertices + marched MIS factors == volpath PT
    on a grid-density fog."""
    scene = _hetero_fog_scene()
    fc = filmlib.make_film_config(W, H, "box")
    f = render_pt(scene, PathConfig(max_depth=3, rr_depth=100),
                  jax.random.PRNGKey(0), 16384 * 24, fc, mode="accum")
    pt = np.asarray(filmlib.develop(fc, f, mode="accum")).mean(axis=(0, 1))

    bcfg = BDPTConfig(max_depth=3, medium=True)

    @jax.jit
    def run(key, film):
        u = jax.random.uniform(key, (4096, bcfg.n_dims))
        sp = trace_bdpt(scene, bcfg, u)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                             mode="splat")

    film = filmlib.new_film(fc)
    n = 24
    for i in range(n):
        film = run(jax.random.fold_in(jax.random.PRNGKey(3), i), film)
    bd = np.asarray(
        filmlib.develop(fc, film, mode="splat", scale=W * H / (n * 4096))
    ).mean(axis=(0, 1))
    np.testing.assert_allclose(bd, pt, rtol=0.1)


def test_mmlt_hetero_selected_matches_dense():
    """Selected-strategy MMLT == dense sweep lane-for-lane in a
    heterogeneous medium (the fast path stays exact)."""
    scene = _hetero_fog_scene()
    bcfg = BDPTConfig(max_depth=3, medium=True)
    R = 512
    key = jax.random.PRNGKey(7)
    u = jax.random.uniform(key, (R, 1 + bcfg.n_dims))
    depth = 1 + jax.random.randint(jax.random.fold_in(key, 1), (R,), 0,
                                   bcfg.max_depth)
    a = trace_mmlt_dense(scene, bcfg, u, depth)
    b = trace_mmlt(scene, bcfg, u, depth)
    va, vb = np.asarray(a.value[:, 0]), np.asarray(b.value[:, 0])
    rel = np.abs(va - vb) / (np.abs(va) + 1e-4)
    bad = (rel > 1e-3).any(-1)
    assert bad.sum() <= 2, f"{bad.sum()} lanes, worst {rel.max()}"
    np.testing.assert_allclose(va.mean(0), vb.mean(0), rtol=2e-3,
                               atol=1e-5)


def test_collimated_beam_through_fog():
    """Exact collimated emitter (ref src/emitters/collimated.cpp): a
    position+direction Dirac beam is invisible to direct sampling and
    reaches the film only through light-subpath strategies; in fog the
    BDPT image shows a localized bright beam line."""
    import drmlt_mitsuba.scene.types as st
    from drmlt_mitsuba.render.medium import make_medium

    scene = cornell_box(W, H)
    nem = int(np.asarray(scene.tris.emitter_id).max()) + 1
    em = st.build_emitters(
        scene.tris, np.zeros((nem, 3), np.float32),
        collimated=[(np.array([50.0, 273.0, 279.0]),
                     np.array([1.0, 0.0, 0.0]),
                     np.array([2e5, 2e5, 2e5]))])
    scene = scene.replace(
        medium=make_medium((0.004,) * 3, (0.9,) * 3, 0.0),
        emitters=em)
    bcfg = BDPTConfig(max_depth=3, medium=True)
    key = jax.random.PRNGKey(0)
    fc = filmlib.make_film_config(W, H, "box")
    film = filmlib.new_film(fc)
    for i in range(6):
        u = jax.random.uniform(jax.random.fold_in(key, i),
                               (8192, bcfg.n_dims))
        sp = trace_bdpt(scene, bcfg, u)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        film = filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                             mode="splat")
    img = np.asarray(filmlib.develop(fc, film, mode="splat",
                                     scale=W * H / (6 * 8192)))
    assert np.isfinite(img).all() and img.max() > 0
    rowsum = img.mean(-1).sum(1)
    # the beam concentrates energy in a narrow horizontal band
    assert rowsum.max() > 5 * (np.median(rowsum) + 1e-9)
