"""Real 2-process jax.distributed run == single-process 2-device run.

SURVEY §4 implication (e): the multi-host path must have at least a
simulated 2-process correctness leg.  Two OS processes (one CPU device
each) initialize jax.distributed, span the (host, chain) mesh, and run
the sharded DRMLT render; the reduced film must match a single-process
run over the same 2-device mesh shape (per-shard RNG streams depend only
on mesh coordinates, so the programs are identical).
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_matches_single_process(tmp_path):
    port = _free_port()
    out = tmp_path / "film2.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(HERE)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "distributed_worker.py"),
             str(rank), "2", str(port), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in range(2)
    ]
    outs = [p.communicate(timeout=540)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-2000:]
    two = np.load(out)

    # single-process reference over the same (2, 1) mesh shape, using two
    # of the pytest session's virtual CPU devices
    from drmlt_mitsuba.integrators.drmlt import DRMLTConfig, drmlt_step
    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.path import trace_paths
    from drmlt_mitsuba.parallel.distributed import render_mcmc_sharded
    from drmlt_mitsuba.parallel.mesh import make_mesh
    from drmlt_mitsuba.render import film as filmlib
    from drmlt_mitsuba.scene.builders import cornell_box

    scene = cornell_box(16, 16)
    pcfg = PathConfig(max_depth=2, rr_depth=100)
    n_dims = pcfg.n_dims + pcfg.n_dims % 2
    fc = filmlib.make_film_config(16, 16, "box")
    trace = lambda u: trace_paths(scene, pcfg, u[:, : pcfg.n_dims])  # noqa

    mesh = make_mesh(2, n_hosts=2)
    dcfg = DRMLTConfig(type="orbital", n_chains=64, n_bootstrap=8 * 1024)
    frozen = jnp.zeros((n_dims,), bool)

    def step(b, carry, key):
        return drmlt_step(trace, dcfg, fc, frozen, carry, key)

    film, b, _, _ = render_mcmc_sharded(
        mesh, trace, step, fc, jax.random.PRNGKey(0), n_dims,
        n_chains=64, n_steps=4, n_bootstrap=8 * 1024,
    )
    np.testing.assert_allclose(float(b), float(two["b"]), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(film), two["film"], rtol=1e-4, atol=1e-6
    )
