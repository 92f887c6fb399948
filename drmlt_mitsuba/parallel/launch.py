"""Multi-host launch helper (the mtssrv / cluster.py replacement).

The reference scales out with a hand-rolled TCP/SSH worker protocol
(src/libcore/sched_remote.cpp, mtssrv, data/ec2/cluster.py).  Under SPMD
there is no wire protocol to speak: every host runs the SAME program, and
`jax.distributed.initialize` + the (host, chain) mesh make the chains span
the fleet; film and b reduce over ICI/DCN inside the jitted step
(parallel/distributed.py).

Usage on each host (coordinator = host 0):

    from drmlt_mitsuba.parallel.launch import init_distributed
    init_distributed(coordinator="host0:9876", num_processes=2,
                     process_id=<this host's rank>)
    # ... then build the mesh with parallel.mesh.make_mesh() as usual
"""
from __future__ import annotations

import os


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    No-op for single-process runs."""
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True
