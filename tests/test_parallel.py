"""Multi-device sharding tests on the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.integrators.drmlt import DRMLTConfig, drmlt_step
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import trace_paths
from drmlt_mitsuba.parallel.distributed import render_mcmc_sharded
from drmlt_mitsuba.parallel.mesh import chain_sharding, make_mesh
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box


@pytest.fixture(scope="module")
def setup():
    scene = cornell_box(16, 16)
    pcfg = PathConfig(max_depth=2, rr_depth=100)
    n_dims = pcfg.n_dims + pcfg.n_dims % 2
    fc = filmlib.make_film_config(16, 16, "box")

    def trace(u):
        return trace_paths(scene, pcfg, u[:, : pcfg.n_dims])

    return scene, pcfg, n_dims, fc, trace


def test_device_count():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_sharded_drmlt(setup, n_hosts):
    _, _, n_dims, fc, trace = setup
    mesh = make_mesh(8, n_hosts=n_hosts)
    dcfg = DRMLTConfig(type="orbital", n_chains=64, n_bootstrap=8 * 1024)
    frozen = jnp.zeros((n_dims,), bool)

    def step(b, carry, key):
        return drmlt_step(trace, dcfg, fc, frozen, carry, key)

    film, b, state, stats = render_mcmc_sharded(
        mesh, trace, step, fc, jax.random.PRNGKey(0), n_dims,
        n_chains=64, n_steps=4, n_bootstrap=8 * 1024,
    )
    assert film.shape == (16, 16, 4)
    assert bool(jnp.all(jnp.isfinite(film)))
    assert float(b) > 0
    # chains stayed sharded over the mesh
    assert state.u.shape == (64, n_dims)
    # every shard contributed splats (film weight > 0)
    assert float(jnp.sum(film[..., 3])) > 0


def test_chain_sharding_placement(setup):
    _, _, n_dims, _, _ = setup
    mesh = make_mesh(8)
    u = jnp.zeros((64, n_dims))
    sharded = jax.device_put(u, chain_sharding(mesh))
    assert len(sharded.sharding.device_set) == 8


def test_sharded_grouped_megadrmlt(setup):
    """The flagship under a mesh: the depth-grouped DRMLT driver with each
    group's drmlt_step scan shard_map'd over ('host','chain').  Pins (a)
    determinism across identical runs, (b) agreement of the sharded image
    with the single-device grouped driver on the same scene (independent
    RNG streams -> statistical agreement of the developed means), (c) the
    final chain state is spread over every device, one shard each."""
    from drmlt_mitsuba.integrators.bidir import BDPTConfig
    from drmlt_mitsuba.integrators.mmlt_grouped import (
        render_drmlt_mmlt_grouped, render_drmlt_mmlt_grouped_sharded,
    )

    W = H = 32
    scene = cornell_box(W, H)
    fc = filmlib.make_film_config(W, H, "box")
    bcfg = BDPTConfig(max_depth=3)
    dcfg = DRMLTConfig(type="orbital", n_chains=512, n_bootstrap=8192)
    mesh = make_mesh(8)

    img, aux = render_drmlt_mmlt_grouped_sharded(
        mesh, scene, bcfg, dcfg, fc, jax.random.PRNGKey(3), n_steps=64)
    a = np.asarray(img)
    assert np.isfinite(a).all() and a.mean() > 0
    img2, _ = render_drmlt_mmlt_grouped_sharded(
        mesh, scene, bcfg, dcfg, fc, jax.random.PRNGKey(3), n_steps=64)
    np.testing.assert_array_equal(a, np.asarray(img2))   # deterministic
    for state in aux["states"].values():
        shards = state.u.addressable_shards
        assert len({s.device for s in shards}) == 8
        assert all(s.data.shape[0] == 512 // 8 for s in shards)

    ref, _ = render_drmlt_mmlt_grouped(
        scene, bcfg, dcfg, fc, jax.random.PRNGKey(4), n_steps=64)
    r = np.asarray(ref)
    ratio = a.mean() / r.mean()
    assert 0.8 < ratio < 1.25, f"sharded vs single image mean: {ratio}"


@pytest.fixture(scope="module")
def grouped_small():
    """Tiny grouped-render setup plus its single-device reference image."""
    from drmlt_mitsuba.integrators.bidir import BDPTConfig
    from drmlt_mitsuba.integrators.mmlt_grouped import (
        render_drmlt_mmlt_grouped,
    )

    scene = cornell_box(16, 16)
    fc = filmlib.make_film_config(16, 16, "box")
    bcfg = BDPTConfig(max_depth=2)
    dcfg = DRMLTConfig(type="orbital", n_chains=256, n_bootstrap=8192)
    ref, _ = render_drmlt_mmlt_grouped(
        scene, bcfg, dcfg, fc, jax.random.PRNGKey(5), n_steps=48)
    return scene, fc, bcfg, dcfg, np.asarray(ref)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_sharded_grouped_device_counts(grouped_small, n_devices):
    """The sharded grouped driver runs on 1, 2, 4 and 8 devices and its
    image mean agrees with the single-device grouped render."""
    from drmlt_mitsuba.integrators.mmlt_grouped import (
        render_drmlt_mmlt_grouped_sharded,
    )

    scene, fc, bcfg, dcfg, ref = grouped_small
    img, aux = render_drmlt_mmlt_grouped_sharded(
        make_mesh(n_devices), scene, bcfg, dcfg, fc, jax.random.PRNGKey(5),
        n_steps=48)
    a = np.asarray(img)
    assert a.shape == (16, 16, 3) and np.isfinite(a).all()
    for state in aux["states"].values():
        assert len(state.u.sharding.device_set) == n_devices
    ratio = a.mean() / ref.mean()
    assert 0.8 < ratio < 1.25, ratio


def test_sharded_grouped_rejects_uneven_chains():
    from drmlt_mitsuba.integrators.bidir import BDPTConfig
    from drmlt_mitsuba.integrators.mmlt_grouped import (
        render_drmlt_mmlt_grouped_sharded,
    )

    with pytest.raises(ValueError, match="does not divide"):
        render_drmlt_mmlt_grouped_sharded(
            make_mesh(8), cornell_box(16, 16), BDPTConfig(max_depth=2),
            DRMLTConfig(type="orbital", n_chains=100),
            filmlib.make_film_config(16, 16, "box"), jax.random.PRNGKey(0),
            n_steps=4)
