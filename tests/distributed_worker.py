"""Worker process for the 2-process jax.distributed test.

Usage: python distributed_worker.py <rank> <nproc> <port> <out.npz>

Each process owns ONE cpu device; jax.distributed.initialize stitches
them into a global 2-device runtime, and the (host, chain) mesh spans
both processes — the same program a real 2-host fleet would run
(the SPMD replacement for the reference's remote scheduler,
src/libcore/sched_remote.cpp).
"""
import os
import sys

rank, nproc, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=rank,
)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from drmlt_mitsuba.integrators.drmlt import (  # noqa: E402
    DRMLTConfig, drmlt_step,
)
from drmlt_mitsuba.integrators.layout import PathConfig  # noqa: E402
from drmlt_mitsuba.integrators.path import trace_paths  # noqa: E402
from drmlt_mitsuba.parallel.distributed import (  # noqa: E402
    render_mcmc_sharded,
)
from drmlt_mitsuba.parallel.mesh import make_mesh  # noqa: E402
from drmlt_mitsuba.render import film as filmlib  # noqa: E402
from drmlt_mitsuba.scene.builders import cornell_box  # noqa: E402

assert len(jax.devices()) == nproc, jax.devices()

scene = cornell_box(16, 16)
pcfg = PathConfig(max_depth=2, rr_depth=100)
n_dims = pcfg.n_dims + pcfg.n_dims % 2
fc = filmlib.make_film_config(16, 16, "box")
trace = lambda u: trace_paths(scene, pcfg, u[:, : pcfg.n_dims])  # noqa: E731

mesh = make_mesh(nproc, n_hosts=nproc)
dcfg = DRMLTConfig(type="orbital", n_chains=64, n_bootstrap=8 * 1024)
frozen = jnp.zeros((n_dims,), bool)


def step(b, carry, key):
    return drmlt_step(trace, dcfg, fc, frozen, carry, key)


film, b, state, stats = render_mcmc_sharded(
    mesh, trace, step, fc, jax.random.PRNGKey(0), n_dims,
    n_chains=64, n_steps=4, n_bootstrap=8 * 1024,
)
if rank == 0:
    np.savez(out, film=np.asarray(film), b=float(b))
jax.distributed.shutdown()
