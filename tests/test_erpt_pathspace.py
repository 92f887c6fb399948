"""Path-space ERPT (integrators/erpt.py render_erpt_mlt): the reference's
energy-redistribution chains run Veach PERTURBATIONS over vertex paths
with per-batch equal-deposition normalization (erpt_proc.cpp:142-278).

Binding oracle (SURVEY §4 hierarchy): image consistency against the plain
path tracer restricted to the same depth range — any acceptance/measure
error in the perturbations or the per-batch b bookkeeping shows up as
image bias.  Perturbations alone are NOT ergodic; the per-batch
reseeding is what restores coverage, so this test also exercises that
defining ERPT property (multiple batches, each with its own b).
"""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.erpt import ERPTConfig, render_erpt_mlt
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import render_pt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box


def test_erpt_mlt_matches_pt():
    """MCMC-vs-MC: path-space ERPT == PT restricted to k in [2, 4]."""
    W = H = 32
    scene = cornell_box(W, H)
    fc = filmlib.make_film_config(W, H, "box")
    cfg = ERPTConfig(n_chains=2048, chain_length=96,
                     samples_per_batch=16384)
    n_batches = 4
    img, aux = render_erpt_mlt(scene, cfg, fc, jax.random.PRNGKey(0),
                               n_batches, max_depth=4, kmin=2)
    a = np.asarray(img)
    assert np.isfinite(a).all()
    # every batch produced a sane luminance estimate and some movement
    assert np.asarray(aux["b"]).min() > 0
    assert float(np.asarray(aux["accept"]).mean()) > 0.01

    steps = n_batches * (cfg.chain_length // 3) * 3 * cfg.n_chains // (W * H)
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
    assert np.percentile(rerr, 95) < 0.15, \
        f"local bias: p95 {np.percentile(rerr, 95)}"


def test_erpt_cli_dispatch(tmp_path):
    """-D integrator=erpt runs the PATH-SPACE redistribution chains on an
    eligible scene (cornell.xml) and produces a finite, lit image."""
    import os

    from drmlt_mitsuba.utils.cli import main

    scene_xml = os.path.join(os.path.dirname(__file__), "data",
                             "cornell.xml")
    out = tmp_path / "out.npy"
    rc = main([str(scene_xml), "-D", "integrator=erpt",
               "-D", "maxDepth=4", "-D", "luminanceSamples=8192",
               "-D", "numChains=24", "-D", "chains=512",
               "-o", str(out), "-q", "--spp", "1"])
    assert rc == 0
    img = np.load(out)
    assert np.isfinite(img).all() and img.mean() > 0
