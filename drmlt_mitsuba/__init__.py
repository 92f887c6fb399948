"""drmlt_mitsuba — a differentiable Monte-Carlo renderer in JAX.

A from-scratch JAX/XLA implementation of the capabilities of the
reference DRMLT system (joeylitalien/drmlt-mitsuba): a wavefront path tracer
(BVH ray-scene intersection, BSDF eval/sample, NEE+MIS), bidirectional /
multiplexed path sampling, and primary-sample-space MCMC (PSSMLT and the
bold-then-timid DRMLT family: Green, Mira, pairwise-Orbital) — expressed as
pure functions over batched Markov-chain state, sharded across devices.

Design stance (see SURVEY.md §7): NOT a port.  The reference's
Object/plugin/Scheduler machinery collapses into a config registry + jitted
SPMD programs; its work-unit parallelism becomes vmapped chain batches under
`jax.sharding`; its per-thread splat ImageBlocks become scatter-add film
reductions; its SFMT replayable-sampler seeds become counter-based PRNG keys.
"""

__version__ = "0.1.0"

from drmlt_mitsuba.core import rng, warp, spectrum, frame, transform
from drmlt_mitsuba.core import math as mmath

__all__ = ["rng", "warp", "spectrum", "frame", "transform", "mmath"]
