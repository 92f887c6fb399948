"""Device mesh and sharding layout.

The reference scales by shipping serialized WorkUnits to remote schedulers
over TCP/SSH (src/libcore/sched_remote.cpp) and merging full float images
back — its own docs call the image return the scaling bottleneck
(drmlt.cpp:96-103).  The replacement here (SURVEY.md §5.8) is one SPMD
program: chains shard over the mesh, the scene/BVH replicate, and exactly
two cross-device reductions exist — the luminance normalization b and the
splat-film accumulation — both `psum` over the device interconnect.

Mesh layout: 2-D ('host', 'chain'); chains shard over both axes (pure data
parallelism over independent Markov chains — SURVEY §2.8.1).  The 'host'
axis maps to the network when running multi-host via jax.distributed;
single-host meshes fold it to size 1.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXES = ("host", "chain")


def make_mesh(n_devices: int | None = None, n_hosts: int | None = None) -> Mesh:
    """Build the ('host', 'chain') mesh over the first n_devices devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n_hosts is None:
        n_hosts = max(1, jax.process_count())
    assert n % n_hosts == 0, (n, n_hosts)
    arr = np.asarray(devs).reshape(n_hosts, n // n_hosts)
    return Mesh(arr, CHAIN_AXES)


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for arrays whose leading axis is the chain batch."""
    return NamedSharding(mesh, P(CHAIN_AXES))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_chain_state(mesh: Mesh, state):
    """Place a ChainState (or any pytree with leading chain axis) onto the
    mesh, sharded over chains."""
    sh = chain_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), state)
