"""Path-space MLT (integrators/pathspace.py): structure + MCMC-vs-MC.

The binding oracle (SURVEY §4 hierarchy) is image consistency against the
plain path tracer restricted to the same depth range: any acceptance or
measure error in the vertex-path mutations shows up as image bias.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.integrators import pathspace as P
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import render_pt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box


def _scene(tall="diffuse", wh=32, sphere=None):
    return cornell_box(wh, wh, tall_box_material=tall,
                       sphere_material=sphere)


def test_seed_paths_valid():
    scene = _scene()
    cfg = P.MLTConfig(max_depth=4, n_chains=128, n_bootstrap=4096)
    ps, b = P.build_seed_paths(scene, cfg, jax.random.PRNGKey(0), 128, 4096)
    val, lum, pix, ok = P.eval_path(scene, ps, cfg.max_depth)
    assert float(b) > 0
    assert float((lum > 0).mean()) > 0.95
    assert bool(jnp.all((ps.k >= 2) & (ps.k <= 4)))
    # pixel positions in range
    assert bool(jnp.all((pix >= 0) & (pix <= 1)))


@pytest.mark.parametrize("tall", ["diffuse", "mirror"])
def test_mutators_propose(tall):
    scene = _scene(tall)
    cfg = P.MLTConfig(max_depth=4, n_chains=256, n_bootstrap=8192)
    ps, _ = P.build_seed_paths(scene, cfg, jax.random.PRNGKey(0), 256, 8192)
    prop, a, ok = P.mut_bidir(scene, cfg, jax.random.PRNGKey(1), ps)
    assert 0.05 < float(a.mean()) < 0.95
    prop, a, ok = P.mut_lens(scene, cfg, jax.random.PRNGKey(2), ps, 32, 32)
    assert float(a.mean()) > 0.05
    prop, a, ok = P.mut_caustic(scene, cfg, jax.random.PRNGKey(3), ps)
    assert float(jnp.isfinite(a).all())
    assert float(a.max()) <= 1.0


@pytest.mark.parametrize("tall,sphere,steps,p95_tol", [
    ("diffuse", None, 768, 0.12), ("mirror", None, 768, 0.12),
    # sphere path vertices (round-4 eligibility widening that makes
    # cornell.xml dispatch): analytic normals (ns == ng).  The diffuse
    # sphere converges like the base scenes and carries the tight bias
    # bar; a MIRROR sphere's caustics mix slowly (measured p95
    # 0.20 @768 -> 0.117 @3072 steps — shrinking with steps = noise,
    # not bias), so that case gets more steps and a looser local bound.
    ("diffuse", "diffuse", 768, 0.12),
    ("diffuse", "mirror", 3072, 0.15),
])
def test_mlt_matches_pt(tall, sphere, steps, p95_tol):
    """MCMC-vs-MC: path-space MLT == PT restricted to k in [2, maxDepth]."""
    W = H = 32
    scene = _scene(tall, W, sphere)
    assert P.mlt_eligible(scene)
    fc = filmlib.make_film_config(W, H, "box")
    cfg = P.MLTConfig(max_depth=4, n_chains=2048, n_bootstrap=32768)
    img, aux = P.render_mlt(scene, cfg, fc, jax.random.PRNGKey(0),
                            n_steps=steps)
    a = np.asarray(img)

    pcfg = PathConfig(max_depth=4, rr_depth=100, min_depth=2)
    film = render_pt(scene, pcfg, jax.random.PRNGKey(9), W * H * steps, fc,
                     mode="accum")
    ref = np.asarray(filmlib.develop(fc, film, mode="accum"))

    ratio = a.mean() / ref.mean()
    assert 0.9 < ratio < 1.1, f"global mean off: {ratio}"
    import scipy.ndimage as ndi
    sa = ndi.uniform_filter(a.mean(-1), 6)
    sb = ndi.uniform_filter(ref.mean(-1), 6)
    rerr = np.abs(sa - sb) / (sb + 1e-2)
    assert np.percentile(rerr, 95) < p95_tol, \
        f"local bias: p95 {np.percentile(rerr, 95)}"


def test_mlt_cli_dispatch(tmp_path):
    """-D integrator=mlt runs the path-space integrator on an eligible
    scene (no substitution warning)."""
    import os
    import warnings

    from drmlt_mitsuba.utils.cli import main

    scene_xml = os.path.join(os.path.dirname(__file__), "data",
                             "cornell.xml")
    out = tmp_path / "out.npy"
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # the pssmlt fallback would warn
        rc = main([str(scene_xml), "-D", "integrator=mlt",
                   "-D", "maxDepth=4", "-D", "luminanceSamples=8192",
                   "-o", str(out), "-q", "--chains", "512", "--spp", "4"])
    assert rc == 0
    img = np.load(out)
    assert np.isfinite(img).all() and img.mean() > 0


def test_mchain_proposes_on_double_chain_scene():
    """mut_mchain (mut_mchain.cpp): eligible on E (S+ D)+ suffixes —
    a mirror tall box AND a mirror sphere give paths crossing >= 2
    specular chains; the mutator must propose with nonzero acceptance
    there and reject (identity) elsewhere."""
    scene = _scene("mirror", 32, "mirror")
    cfg = P.MLTConfig(max_depth=6, n_chains=512, n_bootstrap=16384)
    ps, _ = P.build_seed_paths(scene, cfg, jax.random.PRNGKey(0), 512,
                               16384)
    prop, a, ok = P.mut_mchain(scene, cfg, jax.random.PRNGKey(1), ps,
                               32, 32)
    assert bool(jnp.isfinite(a).all())
    assert float(a.max()) <= 1.0
    # at least some lanes are structurally eligible and accept sometimes
    assert float(ok.mean()) > 0.005, float(ok.mean())
    assert float(a[ok].mean()) > 0.01, float(a[ok].mean())
    # a plain diffuse box has no double chains: everything rejects
    scene0 = _scene("diffuse", 32)
    ps0, _ = P.build_seed_paths(scene0, cfg, jax.random.PRNGKey(2), 512,
                                16384)
    _, a0, ok0 = P.mut_mchain(scene0, cfg, jax.random.PRNGKey(3), ps0,
                              32, 32)
    assert float(a0.max()) == 0.0


def test_mlt_matches_pt_mchain_cycle():
    """MCMC-vs-MC with the mchain mutator IN the cycle on a
    double-specular-chain scene (mirror box + mirror sphere): any
    acceptance/measure error in the multi-chain perturbation shows up as
    image bias against PT."""
    W = H = 32
    scene = _scene("mirror", W, "mirror")
    fc = filmlib.make_film_config(W, H, "box")
    cfg = P.MLTConfig(max_depth=4, n_chains=2048, n_bootstrap=32768)
    steps = 3072
    img, aux = P.render_mlt(
        scene, cfg, fc, jax.random.PRNGKey(0), n_steps=steps,
        mutators=("bidir", "mchain", "bidir", "lens"))
    a = np.asarray(img)
    pcfg = PathConfig(max_depth=4, rr_depth=100, min_depth=2)
    film = render_pt(scene, pcfg, jax.random.PRNGKey(9), W * H * steps,
                     fc, mode="accum")
    ref = np.asarray(filmlib.develop(fc, film, mode="accum"))
    ratio = a.mean() / ref.mean()
    assert 0.9 < ratio < 1.1, f"global mean off: {ratio}"
    import scipy.ndimage as ndi
    sa = ndi.uniform_filter(a.mean(-1), 6)
    sb = ndi.uniform_filter(ref.mean(-1), 6)
    rerr = np.abs(sa - sb) / (sb + 1e-2)
    assert np.percentile(rerr, 95) < 0.15, \
        f"local bias: p95 {np.percentile(rerr, 95)}"
