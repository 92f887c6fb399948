"""External cross-implementation parity: JAX tracer vs native/cpu_oracle.

The reference Mitsuba build is impossible in this image (boost/xerces
headers and the OpenEXR-2 API are absent), so the external oracle is an
independently written scalar C++ renderer (native/cpu_oracle.cpp) sharing
no code with the JAX stack.  A shared bug in trace_paths + the MCMC layer
would be invisible to the repo's self-consistency tests but disagrees
here (this harness caught a real one: the emitted-hit MIS weight was
applied even with use_nee=False).

The reference's own cross-check is src/libbidir/verification.cpp (pdf vs
pdf); ours is image-space.
"""
import os
import subprocess

import numpy as np
import pytest

import jax

from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import render_pt
from drmlt_mitsuba.render.film import FilmConfig, develop
from drmlt_mitsuba.render.filters import make_filter
from drmlt_mitsuba.scene.xml import load_scene_xml
from drmlt_mitsuba.utils.scene_dump import dump_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(ROOT, "native", "cpu_oracle")
CORNELL = os.path.join(ROOT, "tests", "data", "cornell.xml")
W = H = 64
SPP = 512


@pytest.fixture(autouse=True)
def _oracle_built(native_built):
    assert os.path.exists(ORACLE), "make -C native did not build cpu_oracle"


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    fc = FilmConfig(width=W, height=H, filter=make_filter("box"))
    scene, _ = load_scene_xml(CORNELL)
    path = str(tmp_path_factory.mktemp("oracle") / "cornell.bin")
    dump_scene(scene, fc, path)
    return scene, fc, path


def _oracle_pt(scene_bin, out, spp, depth, strat="both"):
    r = subprocess.run(
        [ORACLE, "pt", scene_bin, out, str(spp), str(depth), strat],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    return np.fromfile(out, np.float32).reshape(H, W, 3)


def _jax_pt(scene, fc, spp, depth, use_nee=True):
    cfg = PathConfig(max_depth=depth, rr_depth=99, use_nee=use_nee)
    film = render_pt(scene, cfg, jax.random.PRNGKey(11), W * H * spp, fc,
                     mode="accum")
    return np.asarray(develop(fc, film, mode="accum"))[..., :3]


@pytest.mark.parametrize("depth", [2, 6])
def test_pt_image_parity(dumped, tmp_path, depth):
    scene, fc, scene_bin = dumped
    a = _jax_pt(scene, fc, SPP, depth)
    b = _oracle_pt(scene_bin, str(tmp_path / "o.raw"), SPP, depth)
    rel = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
    rel /= np.maximum(b.mean(axis=(0, 1)), 1e-9)
    # channel means agree to ~0.2% at convergence; 1.5% leaves noise room
    assert np.all(rel < 0.015), rel
    # per-pixel: symmetric relative RMSE dominated by MC noise
    sym = (a - b) / (0.5 * (np.abs(a) + np.abs(b)) + 5e-2)
    assert np.sqrt((sym ** 2).mean()) < 0.25


def test_pt_bsdf_only_parity(dumped, tmp_path):
    """No-NEE configuration (regression for the w_bsdf use_nee bug)."""
    scene, fc, scene_bin = dumped
    a = _jax_pt(scene, fc, SPP, 3, use_nee=False)
    b = _oracle_pt(scene_bin, str(tmp_path / "o.raw"), SPP, 3, "bsdf")
    rel = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
    rel /= np.maximum(b.mean(axis=(0, 1)), 1e-9)
    assert np.all(rel < 0.03), rel


def test_pt_glass_sphere_parity(tmp_path):
    """Smooth-dielectric transport vs the oracle (regression for the
    refraction-side bug: entering rays were refracted back into the upper
    hemisphere)."""
    src = open(CORNELL).read()
    mod = src.replace(
        '<bsdf type="roughconductor" id="metal">\n'
        '        <string name="material" value="Cu"/>\n'
        '        <float name="alpha" value="0.15"/>',
        '<bsdf type="dielectric" id="metal">'
        '<float name="intIOR" value="1.5"/>',
    )
    assert mod != src
    xml = tmp_path / "cornell_glass.xml"
    xml.write_text(mod)
    fc = FilmConfig(width=W, height=H, filter=make_filter("box"))
    scene, _ = load_scene_xml(str(xml))
    scene_bin = str(tmp_path / "glass.bin")
    dump_scene(scene, fc, scene_bin)
    # depth 4: beyond that the double-refraction caustic tail is firefly
    # noise at test spp (glass energy-exactness is pinned separately by
    # the dielectric furnace in tests/test_path.py)
    a = _jax_pt(scene, fc, SPP, 4)
    b = _oracle_pt(scene_bin, str(tmp_path / "o.raw"), SPP, 4)
    rel = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
    rel /= np.maximum(b.mean(axis=(0, 1)), 1e-9)
    assert np.all(rel < 0.03), rel


def test_pt_veach_door_parity(tmp_path):
    """Second bench scene vs the oracle: cross-validates the Oren-Nayar
    rough-diffuse term in BOTH implementations."""
    from drmlt_mitsuba.scene.builders import veach_door

    scene = veach_door(W, H)
    fc = FilmConfig(width=W, height=H, filter=make_filter("box"))
    scene_bin = str(tmp_path / "veach.bin")
    dump_scene(scene, fc, scene_bin)
    a = _jax_pt(scene, fc, SPP * 2, 5)
    b = _oracle_pt(scene_bin, str(tmp_path / "o.raw"), SPP * 2, 5)
    rel = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
    rel /= np.maximum(b.mean(axis=(0, 1)), 1e-9)
    # a high-variance scene (lit through the door gap): channel means to
    # 4% at 1024 spp
    assert np.all(rel < 0.04), rel


def _oracle_mmltmc(scene_bin, out, spp, depth):
    r = subprocess.run(
        [ORACLE, "mmltmc", scene_bin, out, str(spp), str(depth)],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    return np.fromfile(out, np.float32).reshape(H, W, 3)


def test_mmlt_image_parity(dumped, tmp_path):
    """Cross-implementation parity for the FULL bidirectional MMLT
    estimator: the oracle's scalar eye/light walks + selected-strategy
    connection + ratio-recursion MIS (cpu_oracle.cpp trace_mmlt_o) vs the
    JAX trace_mmlt, both driven by uniform PSS samples.  Each side uses
    its own pdf family (VNDF vs Walter NDF sampling), which the balance
    heuristic absorbs — the combined images must agree in expectation."""
    import jax.numpy as jnp

    from drmlt_mitsuba.integrators.bidir import BDPTConfig
    from drmlt_mitsuba.integrators.mmlt import make_mmlt_trace, mmlt_masks
    from drmlt_mitsuba.render import film as filmlib

    scene, fc, scene_bin = dumped
    depth, spp = 4, 384
    b = _oracle_mmltmc(scene_bin, str(tmp_path / "m.raw"), spp, depth)

    bcfg = BDPTConfig(max_depth=depth)
    _, _, n_dims = mmlt_masks(bcfg)
    trace = make_mmlt_trace(scene, bcfg)
    batch = 65536

    @jax.jit
    def run(key, film):
        u = jax.random.uniform(key, (batch, n_dims))
        sp = trace(u)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                             mode="splat")

    n_batches = (W * H * spp) // batch
    film = filmlib.new_film(fc)
    for i in range(n_batches):
        film = run(jax.random.fold_in(jax.random.PRNGKey(7), i), film)
    a = np.asarray(filmlib.develop(
        fc, film, mode="splat", scale=W * H / (n_batches * batch)))[..., :3]

    rel = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
    rel /= np.maximum(b.mean(axis=(0, 1)), 1e-9)
    assert np.all(rel < 0.03), rel
    # per-pixel shape agreement (light-tracing splats land image-wide)
    sym = (a - b) / (0.5 * (np.abs(a) + np.abs(b)) + 5e-2)
    assert np.sqrt((sym ** 2).mean()) < 0.3


def test_oracle_mmlt_vs_pt(dumped, tmp_path):
    """Oracle-internal: the scalar MMLT estimator integrates to the same
    image as the scalar path tracer (checks the MIS partition of unity
    over every (s,t) strategy at every depth)."""
    _, _, scene_bin = dumped
    a = _oracle_pt(scene_bin, str(tmp_path / "p.raw"), SPP, 6)
    b = _oracle_mmltmc(scene_bin, str(tmp_path / "m.raw"), SPP, 6)
    rel = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
    rel /= np.maximum(a.mean(axis=(0, 1)), 1e-9)
    assert np.all(rel < 0.02), rel


def test_oracle_mmlt_chain_consistency(dumped, tmp_path):
    """Oracle-internal: DRMLT(orbital) driving the mmlt technique (pinned
    depth dim, frozen strategy dim, chain pool ∝ per-depth luminance)
    integrates to the pt image.  Tolerance covers bootstrap-b noise (a
    global scale) plus MCMC mixing error."""
    _, _, scene_bin = dumped
    a = _oracle_pt(scene_bin, str(tmp_path / "p.raw"), SPP, 6)
    out = str(tmp_path / "c.raw")
    r = subprocess.run(
        [ORACLE, "mlt", scene_bin, out, "orbital", "10", "6", "4", "mmlt"],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    c = np.fromfile(out, np.float32).reshape(H, W, 3)
    rel = np.abs(a.mean(axis=(0, 1)) - c.mean(axis=(0, 1)))
    rel /= np.maximum(a.mean(axis=(0, 1)), 1e-9)
    assert np.all(rel < 0.06), rel


def test_oracle_strategy_self_consistency(dumped, tmp_path):
    """Oracle's own NEE / BSDF / MIS estimators agree (sanity of the
    oracle itself)."""
    _, _, scene_bin = dumped
    imgs = {
        s: _oracle_pt(scene_bin, str(tmp_path / f"{s}.raw"), SPP, 2, s)
        for s in ("both", "nee", "bsdf")
    }
    m = {s: i.mean(axis=(0, 1)) for s, i in imgs.items()}
    assert np.allclose(m["both"], m["nee"], rtol=0.02)
    assert np.allclose(m["both"], m["bsdf"], rtol=0.02)
