"""Motion blur: per-ray shutter time lerps triangle keyframes.

Reference semantics: sensors sample a time per ray
(include/mitsuba/render/sensor.h:202) and src/shapes/deformable.cpp
interpolates keyframes per ray.  Here linear motion lives in
Scene.motion (TriangleMotion deltas) and one trailing PSS dim
(PathConfig.motion) carries the normalized time — trailing so every
existing offset, and hence the static-scene replay contract, is
unchanged (layout version bump is deliberate and scoped to motion
configs only).
"""
import os
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import render_pt, trace_paths
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box
from drmlt_mitsuba.scene.types import TriangleMotion, build_motion


def _with_motion(scene, shift):
    """Translate every NON-emissive triangle by `shift` over the shutter."""
    tris = scene.tris
    emissive = np.asarray(tris.emitter_id) >= 0
    dv = np.where(emissive[:, None], 0.0,
                  np.asarray(shift, np.float32)[None, :]).astype(np.float32)
    zeros = jnp.zeros_like(tris.v0)
    motion = TriangleMotion(dv0=jnp.asarray(dv), de1=zeros, de2=zeros,
                            dn0=zeros, dn1=zeros, dn2=zeros)
    return scene.replace(motion=motion)


def _lerped_static(scene, shift, t):
    tris = scene.tris
    emissive = np.asarray(tris.emitter_id) >= 0
    dv = np.where(emissive[:, None], 0.0,
                  np.asarray(shift, np.float32)[None, :])
    v0 = np.asarray(tris.v0) + t * dv
    return scene.replace(tris=tris.replace(v0=jnp.asarray(
        v0.astype(np.float32))))


def test_pinned_time_matches_lerped_static():
    """With the time dim PINNED to t, the motion tracer must equal the
    plain tracer on a static scene lerped to t — same code path modulo
    one fma per vertex field."""
    shift = (40.0, 0.0, 0.0)
    scene_m = _with_motion(cornell_box(32, 32), shift)
    cfg_m = PathConfig(max_depth=3, rr_depth=100, motion=True)
    cfg_s = PathConfig(max_depth=3, rr_depth=100)
    R = 2048
    u = jax.random.uniform(jax.random.PRNGKey(0), (R, cfg_m.n_dims))
    for t in (0.0, 0.37, 1.0):
        um = u.at[:, cfg_m.time_dim].set(t)
        va = np.asarray(trace_paths(scene_m, cfg_m, um).value[:, 0, :])
        vb = np.asarray(trace_paths(
            _lerped_static(cornell_box(32, 32), shift, t), cfg_s,
            u[:, : cfg_s.n_dims]).value[:, 0, :])
        rel = np.abs(va - vb) / (np.abs(va) + 1e-3)
        assert (rel > 1e-3).any(-1).sum() <= R // 500, t


def test_motion_render_shows_smear():
    """A box moving across the frame smears: the time-averaged render
    covers strictly more pixels than either endpoint render alone."""
    shift = (120.0, 0.0, 0.0)
    W = H = 32
    scene_m = _with_motion(cornell_box(W, H), shift)
    cfg = PathConfig(max_depth=2, rr_depth=100, motion=True)
    fc = filmlib.make_film_config(W, H, "box")
    film = render_pt(scene_m, cfg, jax.random.PRNGKey(1), W * H * 128, fc,
                     mode="accum")
    img_m = np.asarray(filmlib.develop(fc, film, mode="accum"))

    cfg_s = PathConfig(max_depth=2, rr_depth=100)
    imgs = []
    for t in (0.0, 1.0):
        f = render_pt(_lerped_static(cornell_box(W, H), shift, t), cfg_s,
                      jax.random.PRNGKey(1), W * H * 128, fc, mode="accum")
        imgs.append(np.asarray(filmlib.develop(fc, f, mode="accum")))
    d01 = np.abs(imgs[0] - imgs[1]).mean(-1)
    moved = d01 > 0.1 * d01.max()          # pixels the motion sweeps over
    dm0 = np.abs(img_m - imgs[0]).mean(-1)
    dm1 = np.abs(img_m - imgs[1]).mean(-1)
    # the blurred image differs from BOTH endpoints on the swept band
    assert dm0[moved].mean() > 0.2 * d01[moved].mean()
    assert dm1[moved].mean() > 0.2 * d01[moved].mean()
    # and the average brightness sits between-ish (time-average property)
    lo = np.minimum(imgs[0], imgs[1]).mean()
    hi = np.maximum(imgs[0], imgs[1]).mean()
    assert lo * 0.9 <= img_m.mean() <= hi * 1.1


def test_moving_emitter_rejected():
    import pytest

    scene = cornell_box(16, 16)
    tris1 = scene.tris.replace(v0=scene.tris.v0 + 1.0)
    with pytest.raises(ValueError):
        build_motion(scene.tris, tris1)


def test_deformable_xml_shutter_builds_motion():
    """A two-keyframe deformable under an open shutter loads with
    Scene.motion deltas matching the keyframe difference, and
    settings.motion is set for the CLI."""
    objs = []
    for z in (0.0, 2.0):
        f = tempfile.NamedTemporaryFile("w", suffix=".obj", delete=False)
        f.write(textwrap.dedent(f"""\
            v -1 -1 {z}
            v 1 -1 {z}
            v 0 1 {z}
            f 1 2 3
        """))
        f.close()
        objs.append(f.name)
    xml = f"""<scene version="0.5.0">
      <sensor type="perspective">
        <float name="shutterOpen" value="0"/>
        <float name="shutterClose" value="1"/>
        <film type="hdrfilm">
          <integer name="width" value="8"/>
          <integer name="height" value="8"/>
        </film>
      </sensor>
      <shape type="deformable">
        <string name="times" value="0, 1"/>
        <shape type="obj"><string name="filename" value="{objs[0]}"/></shape>
        <shape type="obj"><string name="filename" value="{objs[1]}"/></shape>
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
        for o in objs:
            os.unlink(o)
    assert settings.motion and scene.motion is not None
    dz = np.asarray(scene.motion.dv0)[:, 2]
    # the deformable triangle moves +2 in z; the emitter rectangle doesn't
    assert np.isclose(dz[0], 2.0, atol=1e-5), dz[:4]
    assert np.allclose(dz[1:], 0.0) or np.abs(dz[1:]).max() < 1e-5
    # geometry itself is at shutter OPEN (z = 0)
    assert np.isclose(np.asarray(scene.tris.v0)[0, 2], 0.0, atol=1e-5)
