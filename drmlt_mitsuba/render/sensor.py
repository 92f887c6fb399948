"""Camera ray generation (ref: src/sensors/perspective.cpp, thinlens.cpp).

sample_ray consumes the first 2 (pinhole) or 4 (thinlens) primary-sample
dimensions — the sensor part of the PSS layout (pathsampler.cpp:530-546
consumes position 2D + aperture 2D when needed).
"""
from __future__ import annotations

import jax.numpy as jnp

from drmlt_mitsuba.core.math import normalize
from drmlt_mitsuba.core.transform import apply_point, apply_vector
from drmlt_mitsuba.core.warp import square_to_uniform_disk_concentric
from drmlt_mitsuba.scene.types import Camera


def sample_ray(camera: Camera, uv, u_aperture=None):
    """Generate camera rays.

    uv: (R, 2) continuous film position in [0,1)^2 (x right, y down).
    u_aperture: (R, 2) lens uniforms (thinlens only; ignored for pinhole).
    Returns (o, d) world-space origins/directions (unit).
    """
    from drmlt_mitsuba.scene.types import (
        CAMERA_FLUENCEMETER, CAMERA_IRRADIANCEMETER, CAMERA_ORTHOGRAPHIC,
        CAMERA_RADIANCEMETER, CAMERA_SPHERICAL, CAMERA_TELECENTRIC,
    )

    if camera.kind == CAMERA_RADIANCEMETER:
        # every sample measures the same ray (ref: radiancemeter.cpp)
        o = jnp.broadcast_to(camera.to_world[:3, 3], uv.shape[:-1] + (3,))
        d = jnp.broadcast_to(
            normalize(camera.to_world[:3, 2]), uv.shape[:-1] + (3,)
        )
        return o, d

    if camera.kind == CAMERA_TELECENTRIC:
        # ref: telecentric.cpp — parallel projection with per-pixel thin
        # lens: each film point carries its own aperture disk; rays
        # converge on the focal plane at focus_distance along +z
        x = (2.0 * uv[..., 0] - 1.0) * camera.tan_half_fov_x
        y = (1.0 - 2.0 * uv[..., 1]) * camera.tan_half_fov_y
        if u_aperture is None:
            u_aperture = jnp.full(uv.shape[:-1] + (2,), 0.5)
        lens = (square_to_uniform_disk_concentric(u_aperture)
                * camera.aperture_radius)
        o_cam = jnp.stack([x + lens[..., 0], y + lens[..., 1],
                           jnp.zeros_like(x)], axis=-1)
        p_focus = jnp.stack(
            [x, y, jnp.full_like(x, camera.focus_distance)], axis=-1
        )
        o = apply_point(camera.to_world, o_cam)
        d = normalize(apply_vector(camera.to_world, p_focus - o_cam))
        return o, d

    if camera.kind == CAMERA_IRRADIANCEMETER:
        # ref: irradiancemeter.cpp — cosine-weighted hemisphere around the
        # sensor's +z axis measures E = int L cos dw; with cosine-pdf
        # importance the estimator is the plain sample mean times pi
        from drmlt_mitsuba.core.warp import square_to_cosine_hemisphere

        d_cam = square_to_cosine_hemisphere(uv)
        o = jnp.broadcast_to(camera.to_world[:3, 3], d_cam.shape)
        return o, normalize(apply_vector(camera.to_world, d_cam))

    if camera.kind == CAMERA_FLUENCEMETER:
        # ref: fluencemeter.cpp — integrate radiance uniformly over the
        # sphere at the sensor position; uv doubles as the direction warp
        from drmlt_mitsuba.core.warp import square_to_uniform_sphere

        d_cam = square_to_uniform_sphere(uv)
        o = jnp.broadcast_to(camera.to_world[:3, 3], d_cam.shape)
        return o, normalize(apply_vector(camera.to_world, d_cam))

    if camera.kind == CAMERA_ORTHOGRAPHIC:
        # parallel rays along +z; film extents in tan_half_fov_*
        x = (2.0 * uv[..., 0] - 1.0) * camera.tan_half_fov_x
        y = (1.0 - 2.0 * uv[..., 1]) * camera.tan_half_fov_y
        o_cam = jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)
        o = apply_point(camera.to_world, o_cam)
        d = normalize(apply_vector(
            camera.to_world, jnp.broadcast_to(
                jnp.asarray([0.0, 0.0, 1.0]), o_cam.shape
            )
        ))
        return o, d
    if camera.kind == CAMERA_SPHERICAL:
        # full lat-long panorama from the camera position
        theta = uv[..., 1] * jnp.pi
        phi = (uv[..., 0] * 2.0 - 1.0) * jnp.pi
        st_ = jnp.sin(theta)
        d_cam = jnp.stack(
            [st_ * jnp.sin(phi), jnp.cos(theta), st_ * jnp.cos(phi)], -1
        )
        o = jnp.broadcast_to(
            camera.to_world[:3, 3], d_cam.shape
        )
        d = normalize(apply_vector(camera.to_world, d_cam))
        return o, d

    # film plane at z=1 in camera space; +x right, +y up in camera space
    x = (2.0 * uv[..., 0] - 1.0) * camera.tan_half_fov_x
    y = (1.0 - 2.0 * uv[..., 1]) * camera.tan_half_fov_y
    if camera.rdist:
        # radial distortion (ref: src/sensors/perspective_rdist.cpp): the
        # film carries DISTORTED plane coords p_d = p_u (1 + k0 r^2 +
        # k1 r^4); invert by Newton on the radius
        k0, k1 = camera.kc[0], camera.kc[1]
        rd = jnp.sqrt(x * x + y * y)
        ru = rd
        for _ in range(4):
            f = ru * (1.0 + k0 * ru * ru + k1 * ru ** 4) - rd
            fp = 1.0 + 3.0 * k0 * ru * ru + 5.0 * k1 * ru ** 4
            ru = ru - f / jnp.maximum(fp, 1e-6)
        scale = jnp.where(rd > 1e-9, ru / jnp.maximum(rd, 1e-9), 1.0)
        x = x * scale
        y = y * scale
    d_cam = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)

    if u_aperture is not None:
        # thinlens: focus plane at focus_distance
        p_focus = d_cam * camera.focus_distance
        lens = square_to_uniform_disk_concentric(u_aperture) * camera.aperture_radius
        o_cam = jnp.stack([lens[..., 0], lens[..., 1], jnp.zeros_like(lens[..., 0])], -1)
        d_cam = p_focus - o_cam
    else:
        o_cam = jnp.zeros_like(d_cam)

    o = apply_point(camera.to_world, o_cam)
    d = normalize(apply_vector(camera.to_world, d_cam))
    return o, d
