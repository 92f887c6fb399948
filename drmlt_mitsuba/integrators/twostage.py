"""Two-stage MLT (importance map) and the separate direct pass.

Reference: BidirectionalUtils::mltLuminancePass renders a 1/16-resolution
luminance image and upsamples it into an importance map
(src/libbidir/util.cpp:96-200); SplatList::normalize(importanceMap) divides
splats by the map (pathsampler.cpp:1001-1028) so chains spread uniformly in
image space; develop multiplies the map back (drmlt_proc.cpp:813-854).
renderDirectComponent (util.cpp:30-95) renders direct illumination with a
plain sampler so the MLT stage only handles indirect transport.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from drmlt_mitsuba.core.spectrum import luminance
from drmlt_mitsuba.integrators.path import Splats


def luminance_pass(render_lowres_fn, film_cfg, downsample: int = 16,
                   floor_frac: float = 0.1):
    """First-stage luminance image -> full-res importance map (H, W).

    render_lowres_fn(width, height) -> (h, w, 3) radiance image (any cheap
    renderer; the reference nests an MLT at 1/16 res, a path tracer is the
    same capability).  The map is clamped below at floor_frac * mean to
    avoid starving dark regions (the reference adds a similar offset).
    """
    lw = max(1, film_cfg.width // downsample)
    lh = max(1, film_cfg.height // downsample)
    img = render_lowres_fn(lw, lh)
    lum = luminance(img)
    lum = jnp.maximum(lum, floor_frac * jnp.mean(lum))
    # bilinear upsample to full res
    return jax.image.resize(lum, (film_cfg.height, film_cfg.width),
                            method="bilinear")


def sample_importance(imap, pos):
    """Bilinear lookup of the importance map at film uv positions (..., 2)."""
    h, w = imap.shape
    x = jnp.clip(pos[..., 0], 0.0, 1.0 - 1e-6) * w - 0.5
    y = jnp.clip(pos[..., 1], 0.0, 1.0 - 1e-6) * h - 0.5
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = jnp.clip(x - x0, 0.0, 1.0)
    fy = jnp.clip(y - y0, 0.0, 1.0)
    v = (
        imap[y0, x0] * (1 - fx) * (1 - fy) + imap[y0, x1] * fx * (1 - fy)
        + imap[y1, x0] * (1 - fx) * fy + imap[y1, x1] * fx * fy
    )
    return jnp.maximum(v, 1e-12)


def with_importance_map(trace_fn, imap):
    """Wrap a trace so splats are divided by the importance map (two-stage
    target density); develop must multiply the map back (see
    apply_importance_to_image)."""

    def trace(u) -> Splats:
        sp = trace_fn(u)
        w = sample_importance(imap, sp.pos)      # (R, S)
        val = sp.value / w[..., None]
        return Splats(pos=sp.pos, value=val,
                      lum=luminance(jnp.sum(val, axis=1)))

    return trace


def apply_importance_to_image(img, imap):
    """Final develop step of two-stage MLT: multiply the map back."""
    return img * imap[..., None]
