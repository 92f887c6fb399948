"""Small inventoried integrators (VERDICT r4 item 9 / SURVEY §2.5 tail):

* render_ptracer — adjoint particle tracer: light subpaths with every
  vertex connected to the sensor at weight 1 (the t=1 strategy family;
  ref: src/integrators/ptracer/ptracer.cpp:203 — CaptureParticleWorker
  connects each particle vertex to the sensor without MIS, the light
  image IS the render).
* render_field — first-hit field AOVs: position / normal / depth /
  albedo / uv / shading-frame / distance (ref: misc/field.cpp:189's
  EField enumeration subset that exists in this scene model).
* render_multichannel — stacked field channels in one pass (ref:
  misc/multichannel.cpp:282: child integrators write into channel
  groups; here the children are field AOVs + a radiance pass).
* render_motion_aov — film-space velocity of the first hit over the
  shutter interval from Scene.motion deltas (ref: misc/motion.cpp).

All pure XLA (wavefront intersect); these are utility renders, not hot
paths.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.bidir import BDPTConfig, trace_bdpt
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.render import film as filmlib


def render_ptracer(scene, film_cfg, key, n_paths: int, max_depth: int = 5,
                   chunk: int = 8192):
    """Adjoint particle tracer.  Every path length k has exactly ONE
    t=1 strategy (s=k), so summing the unweighted light-image splats of
    trace_bdpt(mis=False) reproduces ptracer.cpp's estimator: complete
    transport for lengths 1..max_depth through sensor connections only.
    Returns the developed (H, W, 3) image."""
    bcfg = BDPTConfig(max_depth=max_depth, light_image=True)
    W, H = film_cfg.width, film_cfg.height
    n_chunks = max(1, n_paths // chunk)

    @jax.jit
    def run():
        def body(film, i):
            u = jax.random.uniform(jax.random.fold_in(key, i),
                                   (chunk, bcfg.n_dims))
            sp = trace_bdpt(scene, bcfg, u, mis=False)
            # splat slot 0 is the eye-pixel accumulation (t >= 2):
            # ptracer uses ONLY the sensor-connection splats (slots 1..)
            val = sp.value.at[:, 0, :].set(0.0)
            pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
            return filmlib.splat(film_cfg, film, pos,
                                 val.reshape(-1, 3), mode="splat"), None

        f, _ = jax.lax.scan(body, filmlib.new_film(film_cfg),
                            jnp.arange(n_chunks))
        return f

    film = run()
    return filmlib.develop(film_cfg, film, mode="splat",
                           scale=W * H / (n_chunks * chunk))


FIELD_KINDS = ("position", "relposition", "distance", "geonormal",
               "shnormal", "uv", "albedo", "primindex", "shapeindex")


def _first_hit_fields(scene, film_cfg, key, spp: int):
    """Stratified-pixel first-hit intersection records for field AOVs."""
    from drmlt_mitsuba.ops.intersect import intersect
    from drmlt_mitsuba.render.sensor import sample_ray

    W, H = film_cfg.width, film_cfg.height
    R = W * H * spp
    u = jax.random.uniform(key, (R, 4))
    pix = jnp.arange(R) % (W * H)
    px = (pix % W).astype(jnp.float32)
    py = (pix // W).astype(jnp.float32)
    uv = jnp.stack([(px + u[:, 0]) / W, (py + u[:, 1]) / H], axis=-1)
    o, d = sample_ray(scene.camera, uv, u[:, 2:4])
    hit = intersect(scene, o, d)
    return uv, o, d, hit


def render_field(scene, film_cfg, key, kind: str, spp: int = 4):
    """First-hit field AOV image (misc/field.cpp:189).  Misses produce
    zeros (the reference writes the undefined value)."""
    assert kind in FIELD_KINDS, kind
    from drmlt_mitsuba.integrators.path import _albedo

    W, H = film_cfg.width, film_cfg.height
    uv, o, d, hit = _first_hit_fields(scene, film_cfg, key, spp)
    valid = hit.valid
    p = o + hit.t[:, None] * d
    if kind == "position":
        val = p
    elif kind == "relposition":
        cam_p = jnp.asarray(scene.camera.to_world)[:3, 3]
        val = p - cam_p
    elif kind == "distance":
        val = jnp.repeat(hit.t[:, None], 3, axis=-1)
    elif kind == "geonormal":
        val = hit.ng
    elif kind == "shnormal":
        val = hit.ns
    elif kind == "uv":
        val = jnp.concatenate([hit.tex_uv,
                               jnp.zeros_like(hit.tex_uv[:, :1])], -1)
    elif kind == "albedo":
        val = _albedo(scene, hit)
    elif kind == "primindex":
        val = jnp.repeat(hit.prim.astype(jnp.float32)[:, None], 3, -1)
    else:                                        # shapeindex ~ mat id
        val = jnp.repeat(hit.mat_id.astype(jnp.float32)[:, None], 3, -1)
    val = jnp.where(valid[:, None], val, 0.0)
    pos = uv * jnp.asarray([W, H], jnp.float32)
    film = filmlib.splat(film_cfg, filmlib.new_film(film_cfg), pos, val,
                         mode="splat")
    return filmlib.develop(film_cfg, film, mode="splat",
                           scale=W * H / uv.shape[0])


def render_multichannel(scene, film_cfg, key, channels=None, spp: int = 4,
                        radiance_spp: int = 16, max_depth: int = 5):
    """Multi-channel render (misc/multichannel.cpp:282): one pass per
    requested channel, stacked into an (H, W, 3*n_channels) array; the
    special channel "radiance" runs the path tracer."""
    from drmlt_mitsuba.integrators.path import render_pt

    channels = channels or ("radiance", "shnormal", "distance", "albedo")
    planes = []
    for i, ch in enumerate(channels):
        k = jax.random.fold_in(key, i)
        if ch == "radiance":
            pcfg = PathConfig(max_depth=max_depth, rr_depth=100)
            film = render_pt(scene, pcfg, k,
                             film_cfg.npixels * radiance_spp, film_cfg,
                             mode="accum")
            planes.append(np.asarray(
                filmlib.develop(film_cfg, film, mode="accum"))[..., :3])
        else:
            planes.append(np.asarray(
                render_field(scene, film_cfg, k, ch, spp))[..., :3])
    return np.concatenate(planes, axis=-1)


def render_motion_aov(scene, film_cfg, key, spp: int = 4):
    """Film-space velocity AOV (misc/motion.cpp): the first hit's
    shutter-interval displacement from Scene.motion, projected through
    the camera; (vx_pixels, vy_pixels, 0) per pixel.  Static scenes
    produce zeros."""
    from drmlt_mitsuba.integrators.bidir import sensor_importance
    from drmlt_mitsuba.core.math import normalize

    W, H = film_cfg.width, film_cfg.height
    uv, o, d, hit = _first_hit_fields(scene, film_cfg, key, spp)
    p = o + hit.t[:, None] * d
    if scene.motion is None:
        vel = jnp.zeros_like(p)
    else:
        ti = jnp.clip(hit.prim, 0, scene.motion.dv0.shape[0] - 1)
        b1 = hit.uv[:, 0:1]
        b2 = hit.uv[:, 1:2]
        vel = (scene.motion.dv0[ti]
               + scene.motion.de1[ti] * b1 + scene.motion.de2[ti] * b2)
    cam_p = jnp.asarray(scene.camera.to_world)[:3, 3]
    _w0, uv0, ok0 = sensor_importance(scene.camera, normalize(p - cam_p))
    _w1, uv1, ok1 = sensor_importance(scene.camera,
                                      normalize(p + vel - cam_p))
    dpix = jnp.where((ok0 & ok1 & hit.valid)[:, None],
                     (uv1 - uv0) * jnp.asarray([W, H], jnp.float32), 0.0)
    val = jnp.concatenate([dpix, jnp.zeros_like(dpix[:, :1])], -1)
    pos = uv * jnp.asarray([W, H], jnp.float32)
    film = filmlib.splat(film_cfg, filmlib.new_film(film_cfg), pos, val,
                         mode="splat")
    return filmlib.develop(film_cfg, film, mode="splat",
                           scale=W * H / uv.shape[0])
