"""Every f32 matrix product on the render and gradient paths asks for
Precision.HIGHEST.

A GPU may run a default-precision f32 dot in TF32 (about three decimal
digits), which would move camera rays and one-hot row selects by visible
amounts.  The CPU cannot show TF32, so this guard reads the traced jaxprs
instead: any dot_general without HIGHEST on both operands fails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.integrators.bidir import BDPTConfig, trace_mmlt
from drmlt_mitsuba.integrators.drmlt import DRMLTConfig, drmlt_step
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.mcmc import state_from_splats
from drmlt_mitsuba.integrators.mmlt_grouped import make_mmlt_trace_fixed
from drmlt_mitsuba.integrators.path import make_path_trace, trace_paths
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box

HIGHEST = jax.lax.Precision.HIGHEST
R = 64


def _dots(jaxpr):
    """Yield every dot_general equation, descending into sub-jaxprs (scan,
    cond, while, pjit, custom_jvp/vjp bodies)."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if hasattr(sub, "eqns"):
                    yield from _dots(sub)
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    yield from _dots(sub.jaxpr)


def _assert_highest(fn, *args):
    dots = list(_dots(jax.make_jaxpr(fn)(*args).jaxpr))
    assert dots, "no dot_general traced: the walker missed the sub-jaxprs"
    bad = [str(e.params["precision"]) for e in dots
           if e.params["precision"] is None
           or any(p != HIGHEST for p in e.params["precision"])]
    assert not bad, f"{len(bad)}/{len(dots)} dots below HIGHEST: {bad[:5]}"


def _u(n_dims, seed=0):
    return jax.random.uniform(jax.random.PRNGKey(seed), (R, n_dims))


def _scene_medium(kind):
    from drmlt_mitsuba.render.medium import (
        PHASE_HG, PHASE_MICROFLAKE, make_hetero_medium, make_medium,
    )

    scene = cornell_box(16, 16)
    if kind == "homogeneous":
        return scene.replace(medium=make_medium([2e-3] * 3, [0.6] * 3, 0.3))
    if kind == "microflake":
        return scene.replace(medium=make_medium(
            [2e-3] * 3, [0.6] * 3, phase_kind=PHASE_MICROFLAKE))
    w2g = np.eye(4, dtype=np.float32) / 1800.0
    w2g[:3, 3] = 0.5
    w2g[3, 3] = 1.0
    dens = np.random.default_rng(0).uniform(0, 1, (4, 4, 4))
    return scene.replace(medium=make_hetero_medium(
        dens, w2g, [2e-3] * 3, [0.6] * 3, phase_kind=PHASE_HG))


def _scene_subsurface():
    from drmlt_mitsuba.render.subsurface import DipoleTable, dipole_params

    n = 32
    rng = np.random.default_rng(0)
    table = DipoleTable(
        points=jnp.asarray(rng.uniform(100, 400, (n, 3)), jnp.float32),
        irradiance=jnp.ones((n, 3), jnp.float32),
        area=jnp.ones((n,), jnp.float32),
        params=dipole_params([0.7, 1.2, 1.6], [0.001, 0.004, 0.03],
                             eta=1.5),
        mat_id=4)
    return cornell_box(16, 16).replace(subsurface=(table,))


@pytest.mark.parametrize("scene_kind", [
    "cornell", "homogeneous", "microflake", "heterogeneous", "subsurface",
])
def test_trace_paths_dots_are_highest(scene_kind):
    scene = {"cornell": lambda: cornell_box(16, 16),
             "subsurface": _scene_subsurface}.get(
        scene_kind, lambda: _scene_medium(scene_kind))()
    cfg = PathConfig(max_depth=3, rr_depth=100)
    _assert_highest(lambda u: trace_paths(scene, cfg, u), _u(cfg.n_dims))


def test_trace_mmlt_dots_are_highest():
    scene = cornell_box(16, 16)
    cfg = BDPTConfig(max_depth=3)
    depth = jnp.full((R,), 3, jnp.int32)
    _assert_highest(lambda u: trace_mmlt(scene, cfg, u, depth),
                    _u(cfg.eye_dims + cfg.light_dims + 1))


@pytest.mark.parametrize("technique", ["path", "grouped_mmlt"])
def test_drmlt_step_dots_are_highest(technique):
    scene = cornell_box(16, 16)
    if technique == "path":
        pcfg = PathConfig(max_depth=3, rr_depth=100)
        trace = make_path_trace(scene, pcfg)
        n_dims = pcfg.n_dims + pcfg.n_dims % 2
    else:
        trace, _, n_dims = make_mmlt_trace_fixed(scene, 2)
    dcfg = DRMLTConfig(type="orbital", n_chains=R)
    fc = filmlib.make_film_config(16, 16, "box")
    frozen = jnp.zeros((n_dims,), bool)

    def step(u, key):
        state = state_from_splats(u, trace(u))
        return drmlt_step(trace, dcfg, fc, frozen,
                          (state, filmlib.new_film(fc), None), key)

    _assert_highest(step, _u(n_dims), jax.random.PRNGKey(1))


def test_pathspace_mutations_dots_are_highest():
    from drmlt_mitsuba.integrators import pathspace as P

    scene = cornell_box(16, 16)
    cfg = P.MLTConfig(max_depth=4, n_chains=R, n_bootstrap=1024)
    ps, _ = P.build_seed_paths(scene, cfg, jax.random.PRNGKey(0), R, 1024)
    state = (ps, *P.eval_path(scene, ps, cfg.max_depth)[:3])

    def mutate_all(key):
        out = []
        for which in ("bidir", "lens", "caustic", "mchain"):
            out.append(P.mutate_once(scene, cfg, key, state, which,
                                     (16, 16)))
        return out

    _assert_highest(mutate_all, jax.random.PRNGKey(2))


def test_path_gradient_dots_are_highest():
    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=3, rr_depth=100)
    u = _u(cfg.n_dims)

    def loss(albedo, radiance):
        s = scene.replace(
            materials=scene.materials.replace(albedo=albedo),
            emitters=scene.emitters.replace(radiance=radiance))
        return jnp.mean(trace_paths(s, cfg, u).lum)

    _assert_highest(jax.grad(loss, argnums=(0, 1)),
                    scene.materials.albedo, scene.emitters.radiance)
