"""MMLT technique wiring for the MCMC layer.

The reference runs MMLT chains with a fixed path depth per chain (PathSeed
carries `depth`; drmlt.cpp:456-473 allocates bootstrap budget x50 x maxDepth)
and a strategy dimension drawn by the direct sampler, frozen to identity
within DRMLT stages (drmlt_proc.cpp:133-141).

Encoding: the chain's PSS vector gets two leading technique dims:
  u[0]  depth dim    — PINNED (never mutated); depth = 1 + floor(u0 * D).
        Bootstrap resampling ∝ luminance automatically allocates chains to
        depths proportional to their brightness b_k (the reference's
        per-depth stratification, pathsampler.cpp:884-934).
  u[1]  strategy dim — FROZEN (identity kernels: moves only on large steps,
        matching the direct sampler's stage freeze).
The traced value is multiplied by D (uniform depth pmf), so b and all MH
ratios are consistent with the plain-MC estimator.
"""
from __future__ import annotations

import jax.numpy as jnp

from drmlt_mitsuba.integrators.bidir import BDPTConfig, trace_mmlt
from drmlt_mitsuba.integrators.path import Splats
from drmlt_mitsuba.scene.types import Scene

TECH_DIMS = 2  # depth + strategy


def mmlt_n_dims(cfg: BDPTConfig) -> int:
    return TECH_DIMS + cfg.eye_dims + cfg.light_dims


def mmlt_masks(cfg: BDPTConfig, even: bool = True):
    """(frozen_mask, pinned_mask) for DRMLT over the MMLT technique."""
    n = mmlt_n_dims(cfg)
    if even and n % 2:
        n += 1
    frozen = jnp.zeros((n,), bool).at[1].set(True)
    pinned = jnp.zeros((n,), bool).at[0].set(True)
    return frozen, pinned, n


def mmlt_emitter_mask(cfg: BDPTConfig, n_dims: int):
    """Mask of the light-subpath PSS dims (for fixEmitterPath)."""
    mask = jnp.zeros((n_dims,), bool)
    start = TECH_DIMS + cfg.eye_dims
    return mask.at[start:start + cfg.light_dims].set(True)


def mmlt_lt_mask_fn(cfg: BDPTConfig):
    """Returns lt(u) -> (C,) bool: is the chain's current strategy light
    tracing (t == 1)?"""
    D = cfg.max_depth

    def lt(u):
        depth = 1 + jnp.minimum((u[:, 0] * D).astype(jnp.int32), D - 1)
        n_strats = depth + 1
        s_pick = jnp.minimum(
            (u[:, 1] * n_strats.astype(jnp.float32)).astype(jnp.int32),
            depth,
        )
        t = depth + 1 - s_pick
        return t == 1

    return lt


def make_mmlt_trace(scene: Scene, cfg: BDPTConfig):
    """trace(u) for MCMC: u = [depth, strategy, eye..., light...(, pad)]."""
    D = cfg.max_depth
    n_core = mmlt_n_dims(cfg)

    def trace(u) -> Splats:
        depth = 1 + jnp.minimum(
            (u[:, 0] * D).astype(jnp.int32), D - 1
        )
        sp = trace_mmlt(scene, cfg, u[:, 1:n_core], depth)
        return Splats(pos=sp.pos, value=sp.value * D, lum=sp.lum * D)

    return trace
