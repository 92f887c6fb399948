"""Chain-state checkpoint/resume.

The reference's only resume mechanism is the PathSeed replay contract plus
periodic partial images (SURVEY §5.4).  Here the full MCMC state is a pytree
— (chain PSS vectors, luminances, current splats, film, b, step counter, RNG
key) — so checkpointing it gives true mid-render resume, strictly stronger
than the reference.  Uses orbax when available, npz otherwise.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.mcmc import ChainState


def save_checkpoint(path: str, state: ChainState, film, b, step: int,
                    key, accmap=None):
    """Write a render checkpoint (atomic via tmp+rename)."""
    arrays = dict(
        u=state.u, lum=state.lum, pos=state.pos, value=state.value,
        film=film, b=jnp.asarray(b), step=jnp.asarray(step, jnp.int32),
        key=key,
    )
    if accmap is not None:
        arrays["accmap"] = accmap
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, path if path.endswith(".npz") else path + ".npz")


def load_checkpoint(path: str):
    """Returns (ChainState, film, b, step, key, accmap|None)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path)
    state = ChainState(
        u=jnp.asarray(z["u"]), lum=jnp.asarray(z["lum"]),
        pos=jnp.asarray(z["pos"]), value=jnp.asarray(z["value"]),
    )
    accmap = jnp.asarray(z["accmap"]) if "accmap" in z else None
    return (state, jnp.asarray(z["film"]), float(z["b"]), int(z["step"]),
            jnp.asarray(z["key"]), accmap)


def save_checkpoint_orbax(path: str, pytree):
    """Orbax-backed variant for multi-host sharded state."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), pytree, force=True)
    ckptr.wait_until_finished()


def load_checkpoint_orbax(path: str, abstract_pytree):
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(os.path.abspath(path), abstract_pytree)
