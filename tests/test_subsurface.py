"""Dipole BSSRDF subsurface scattering (ref: src/subsurface/dipole.cpp).

Correctness oracle hierarchy (CLAUDE.md): analytic — the planar integral
of the reference-form Rd has the closed form
    int Rd dA = (exp(-sigma_tr*zr) + exp(-sigma_tr*zv)) / 2
(each dipole term integrates exactly: substituting s = sqrt(r^2+z^2)
collapses 2*pi*r*z*(s_tr + 1/s)exp(-s_tr s)/s^2 to a perfect derivative
of -exp(-s_tr s)/s).  The uniform-plane furnace test below checks the
dense-sum query machinery against that closed form end-to-end.
"""
import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import render_pt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.render.subsurface import (
    DipoleTable, dipole_lo, dipole_params, prepare_dipole, rd,
)
from drmlt_mitsuba.scene.builders import cornell_box

SIGMA_S = (2.19, 2.62, 3.00)   # marble (Jensen et al. 2001)
SIGMA_A = (0.0021, 0.0041, 0.0071)


def _closed_form_integral(params):
    zr, zv, st = (np.asarray(params.zr), np.asarray(params.zv),
                  np.asarray(params.sigma_tr))
    return 0.5 * (np.exp(-st * zr) + np.exp(-st * zv))


def test_rd_integral_matches_closed_form():
    """Numeric planar integral of Rd == the analytic value, per channel."""
    params = dipole_params(SIGMA_S, SIGMA_A, g=0.0, eta=1.5)
    r = np.linspace(1e-4, 60.0, 400_000)
    dr = r[1] - r[0]
    vals = np.asarray(rd(params, jnp.asarray(r * r, jnp.float32)))
    integral = (2 * np.pi * r[:, None] * vals).sum(0) * dr
    np.testing.assert_allclose(integral, _closed_form_integral(params),
                               rtol=2e-3)
    # energy conservation: a BSSRDF cannot return more than arrived
    assert (integral <= 1.0 + 1e-4).all()


def test_uniform_plane_furnace():
    """Unit irradiance on a large densely-sampled plane: the dense query
    at the center must equal (1-Fr)/pi * int Rd dA (the furnace analog —
    checks point weights, the (R,N) reduction and the Fresnel factor)."""
    from drmlt_mitsuba.core.math import fresnel_dielectric

    params = dipole_params(SIGMA_S, SIGMA_A, g=0.0, eta=1.5)
    half, n_side = 30.0, 600
    xs = np.linspace(-half, half, n_side, endpoint=False) + half / n_side
    gx, gy = np.meshgrid(xs, xs)
    pts = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], -1)
    cell = (2 * half / n_side) ** 2
    table = DipoleTable(
        points=jnp.asarray(pts, jnp.float32),
        irradiance=jnp.ones((pts.shape[0], 3), jnp.float32),
        area=jnp.full((pts.shape[0],), cell, jnp.float32),
        params=params, mat_id=0,
    )
    p = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    ns = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    wo = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    lo = np.asarray(dipole_lo(table, p, ns, wo))[0]
    fr, _, _ = fresnel_dielectric(jnp.asarray([1.0]), jnp.asarray([1.5]))
    expect = (1 - float(fr[0])) / np.pi * _closed_form_integral(params)
    np.testing.assert_allclose(lo, expect, rtol=0.02)


def test_dipole_scene_renders():
    """E2E: marble dipole on the Cornell tall box — the preprocess runs,
    the render is finite, and the subsurface glow ADDS energy on the box
    relative to the same render without the table."""
    W = H = 32
    scene = cornell_box(W, H)
    tall_mat = 4   # builders.cornell_box: tall_m = 4
    # millimeter-ish coefficients on a ~550-unit box: scale down so the
    # mean free path is a visible fraction of the box
    table = prepare_dipole(scene, tall_mat,
                           np.asarray(SIGMA_S) / 50.0,
                           np.asarray(SIGMA_A) / 50.0,
                           eta=1.5, n_points=512, irr_samples=8,
                           indirect=False, key=jax.random.PRNGKey(7))
    assert np.isfinite(np.asarray(table.irradiance)).all()
    assert float(np.asarray(table.irradiance).max()) > 0
    scene_ss = scene.replace(subsurface=(table,))
    cfg = PathConfig(max_depth=3, rr_depth=100)
    fc = filmlib.make_film_config(W, H, "box")
    f1 = render_pt(scene_ss, cfg, jax.random.PRNGKey(0), W * H * 64, fc,
                   mode="accum")
    img_ss = np.asarray(filmlib.develop(fc, f1, mode="accum"))
    f0 = render_pt(scene, cfg, jax.random.PRNGKey(0), W * H * 64, fc,
                   mode="accum")
    img0 = np.asarray(filmlib.develop(fc, f0, mode="accum"))
    assert np.isfinite(img_ss).all()
    diff = (img_ss - img0).mean(-1)
    assert diff.max() > 0.01            # the box visibly glows
    assert diff.min() > -0.02           # and nothing lost energy


def test_xml_subsurface_parsed():
    import os
    import tempfile

    xml = """<scene version="0.5.0">
      <sensor type="perspective">
        <film type="hdrfilm">
          <integer name="width" value="8"/>
          <integer name="height" value="8"/>
        </film>
      </sensor>
      <shape type="sphere">
        <float name="radius" value="1"/>
        <subsurface type="dipole">
          <string name="material" value="marble"/>
          <float name="scale" value="0.5"/>
          <integer name="irrSamples" value="8"/>
        </subsurface>
      </shape>
      <shape type="rectangle">
        <emitter type="area"><rgb name="radiance" value="1"/></emitter>
      </shape>
    </scene>"""
    f = tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False)
    f.write(xml)
    f.close()
    from drmlt_mitsuba.scene.xml import load_scene_xml
    try:
        scene, settings = load_scene_xml(f.name)
    finally:
        os.unlink(f.name)
    assert settings.subsurface and len(settings.subsurface) == 1
    req = settings.subsurface[0]
    np.testing.assert_allclose(req["sigma_s"],
                               np.asarray((2.19, 2.62, 3.00)) * 0.5,
                               rtol=1e-6)
    assert req["irr_samples"] == 8
    # the cloned material row keys the instance uniquely: the sphere's
    # base material is row 0, its subsurface clone row 1, the emitter
    # rectangle's default row 2
    assert req["mat_id"] == 1
    assert np.asarray(scene.materials.kind).shape[0] == 3
    assert int(np.asarray(scene.spheres.mat_id)[0]) == 1
