"""Film and splatting (ref: include/mitsuba/render/imageblock.h:130-210,
src/films/hdrfilm.cpp).

The reference accumulates per-thread `ImageBlock`s and merges them under a
mutex; here the film is a device array and every splat batch is one fused
scatter-add.  Two accumulation modes, matching ImageBlock's dual use:

  * ACCUM  — sampling integrators: accumulate filter-weighted radiance and
    filter weight separately; develop() divides (weighted average).
  * SPLAT  — MLT/light-tracing splats: per-splat the footprint weights are
    normalized to sum 1 so each splat deposits exactly its value; develop()
    scales by the caller-provided factor (b / mutations per pixel).

Film state is (H, W, 4): rgb + weight channel.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from drmlt_mitsuba.render.filters import Filter, make_filter


@dataclasses.dataclass(frozen=True)
class FilmConfig:
    width: int
    height: int
    filter: Filter

    @property
    def npixels(self):
        return self.width * self.height


def make_film_config(width: int, height: int, filter_name: str = "gaussian",
                     radius: float | None = None) -> FilmConfig:
    return FilmConfig(width=width, height=height,
                      filter=make_filter(filter_name, radius))


def new_film(cfg: FilmConfig):
    return jnp.zeros((cfg.height, cfg.width, 4), jnp.float32)


def _footprint(cfg: FilmConfig, pos):
    """Static-size separable footprint for continuous positions (N, 2).

    Returns (pix_x, pix_y, wx, wy) each (N, F): clamped pixel indices and
    1-D filter weights; out-of-image taps get zero weight.
    """
    f = cfg.filter
    F = f.footprint
    # first pixel whose center could be inside the support
    base_x = jnp.floor(pos[:, 0] - f.radius + 0.5).astype(jnp.int32)
    base_y = jnp.floor(pos[:, 1] - f.radius + 0.5).astype(jnp.int32)
    offs = jnp.arange(F, dtype=jnp.int32)
    px = base_x[:, None] + offs[None, :]
    py = base_y[:, None] + offs[None, :]
    wx = f.eval1d(px.astype(jnp.float32) + 0.5 - pos[:, 0:1])
    wy = f.eval1d(py.astype(jnp.float32) + 0.5 - pos[:, 1:2])
    in_x = (px >= 0) & (px < cfg.width)
    in_y = (py >= 0) & (py < cfg.height)
    wx = jnp.where(in_x, wx, 0.0)
    wy = jnp.where(in_y, wy, 0.0)
    px = jnp.clip(px, 0, cfg.width - 1)
    py = jnp.clip(py, 0, cfg.height - 1)
    return px, py, wx, wy


def splat(cfg: FilmConfig, film, pos, value, weight=None, mode: str = "splat"):
    """Scatter a batch of splats into the film.

    pos: (N, 2) continuous pixel coordinates; value: (N, 3); weight: (N,)
    optional per-splat scalar (MLT acceptance weights).  mode: "splat" or
    "accum" (see module docstring).
    """
    px, py, wx, wy = _footprint(cfg, pos)
    F = cfg.filter.footprint
    # (N, F, F) separable weights
    w2 = wx[:, :, None] * wy[:, None, :]
    if mode == "splat":
        total = jnp.sum(w2, axis=(1, 2), keepdims=True)
        w2 = w2 / jnp.maximum(total, 1e-12)
    if weight is not None:
        value = value * weight[:, None]
        w_chan = weight
    else:
        w_chan = jnp.ones(value.shape[:1], value.dtype)

    contrib = jnp.concatenate([value, w_chan[:, None]], axis=-1)  # (N, 4)
    vals = (w2[:, :, :, None] * contrib[:, None, None, :]).reshape(-1, 4)
    flat_idx = (py[:, None, :] * cfg.width + px[:, :, None]).reshape(-1)
    flat = film.reshape(-1, 4)
    flat = flat.at[flat_idx].add(vals)
    return flat.reshape(cfg.height, cfg.width, 4)


def develop(cfg: FilmConfig, film, mode: str = "splat", scale: float = 1.0):
    """Produce the final (H, W, 3) image.

    accum: weighted average (divide by filter-weight channel).
    splat: scale by `scale` (e.g. b / mutations_per_pixel for MLT, or
    1/spp for splat-mode sampling).
    """
    rgb = film[..., :3]
    if mode == "accum":
        w = film[..., 3:4]
        return jnp.where(w > 0, rgb / jnp.maximum(w, 1e-12), 0.0)
    return rgb * scale
