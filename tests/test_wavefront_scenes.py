"""Bidirectional against unidirectional transport on the wavefront, per
scene feature.

Two estimators of the same image mean that share only the scene code:
the path tracer (trace_paths: BSDF sampling + NEE) and the pooled MMLT
technique (trace_mmlt: light and eye subpaths, one connection strategy per
sample, MIS-weighted).  A wrong pdf, MIS weight or connection term in
either shows up as a mismatch.  The cases cover the scene features the
wavefront must carry: every BSDF family on the tall box, analytic
spheres, bitmap textures, constant and image environments, a thin lens,
the veach-door scene, depth 6, and no light image.  Without the light
image the camera-visible emitter (depth 1) has one high-variance strategy
left, so that case compares depths 2 and up through the fixed-depth traces.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drmlt_mitsuba.integrators.bidir import BDPTConfig
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.mmlt import make_mmlt_trace, mmlt_n_dims
from drmlt_mitsuba.integrators.mmlt_grouped import make_mmlt_trace_fixed
from drmlt_mitsuba.integrators.path import trace_paths
from drmlt_mitsuba.scene import types as st
from drmlt_mitsuba.scene.builders import cornell_box, veach_door

BATCH = 8192


def _textured():
    scene = cornell_box(16, 16)
    wuv = lambda p: jnp.stack([p[:, 0] / 556.0, p[:, 1] / 556.0], axis=-1)
    p0 = scene.tris.v0
    tris = scene.tris.replace(uv0=wuv(p0), uv1=wuv(p0 + scene.tris.e1),
                              uv2=wuv(p0 + scene.tris.e2))
    tex = 0.2 + 0.8 * jax.random.uniform(jax.random.PRNGKey(5),
                                         (1, 16, 16, 3))
    mats = scene.materials.replace(tex_id=scene.materials.tex_id.at[0].set(0))
    return scene.replace(tris=tris, materials=mats,
                         textures=st.TextureAtlas(data=tex))


def _image_env():
    scene = cornell_box(16, 16)
    env = 0.1 + 2.0 * jax.random.uniform(jax.random.PRNGKey(7), (16, 32, 3))
    src_eid = jnp.where(scene.tris.emitter_id >= 0, 0, -1)
    tris = scene.tris.replace(emitter_id=src_eid)
    emitters = st.build_emitters(
        tris, np.asarray([[18.4, 15.6, 8.0]], np.float32),
        env_image=np.asarray(env))
    area_rows = np.nonzero(np.asarray(emitters.kind) == st.EMITTER_AREA)[0]
    row_of_tri = np.full(tris.v0.shape[0], -1, np.int32)
    row_of_tri[np.asarray(emitters.tri_idx)[area_rows]] = area_rows
    return scene.replace(
        tris=tris.replace(emitter_id=jnp.asarray(row_of_tri)),
        emitters=emitters)


def _thinlens():
    scene = cornell_box(16, 16)
    return scene.replace(camera=scene.camera.replace(
        aperture_radius=jnp.float32(25.0), focus_distance=jnp.float32(800.0)))


def _constant_env():
    scene = cornell_box(16, 16)
    return scene.replace(emitters=scene.emitters.replace(
        env_radiance=jnp.asarray([0.4, 0.5, 0.7])))


# name -> (scene factory, max depth, light image, thin lens, rtol); every
# case draws 4 x 8192 samples per estimator except veach-door (16 x 8192:
# its light arrives indirectly, through a narrow opening)
CASES = {
    "diffuse": (lambda: cornell_box(16, 16), 3, True, False, 0.06),
    "mirror": (lambda: cornell_box(16, 16, tall_box_material="mirror"),
               3, True, False, 0.06),
    "glass": (lambda: cornell_box(16, 16, tall_box_material="glass"),
              3, True, False, 0.08),
    "roughconductor": (lambda: cornell_box(
        16, 16, tall_box_material="roughconductor"), 3, True, False, 0.06),
    "sphere_diffuse": (lambda: cornell_box(16, 16, sphere_material="diffuse"),
                       3, True, False, 0.06),
    "sphere_mirror": (lambda: cornell_box(16, 16, sphere_material="mirror"),
                      3, True, False, 0.06),
    "sphere_glass": (lambda: cornell_box(16, 16, sphere_material="glass"),
                     3, True, False, 0.08),
    "textured": (_textured, 3, True, False, 0.06),
    "constant_env": (_constant_env, 3, True, False, 0.06),
    "image_env": (_image_env, 3, True, False, 0.08),
    "thinlens": (_thinlens, 3, True, True, 0.06),
    "veach_door": (lambda: veach_door(16, 16), 4, True, False, 0.1),
    "depth6": (lambda: cornell_box(16, 16), 6, True, False, 0.06),
    "no_light_image": (lambda: cornell_box(16, 16), 3, False, False, 0.06),
}


def _mean(fn, n_dims, seed, n_batches):
    """Mean over n_batches x BATCH uniform samples of fn(u) (3,)."""
    run = jax.jit(lambda key: fn(jax.random.uniform(key, (BATCH, n_dims))))
    tot = sum(np.asarray(run(jax.random.fold_in(jax.random.PRNGKey(seed), i)))
              for i in range(n_batches))
    return tot / n_batches


def _splat_mean(trace):
    """u -> mean over samples of the splat values that land on the film."""
    def f(u):
        sp = trace(u)
        inside = jnp.all((sp.pos >= 0.0) & (sp.pos <= 1.0), axis=-1)
        return jnp.mean(jnp.sum(jnp.where(inside[..., None], sp.value, 0.0),
                                axis=1), axis=0)
    return f


@pytest.mark.parametrize("case", sorted(CASES))
def test_mmlt_matches_pt(case):
    make, depth, light_image, thinlens, rtol = CASES[case]
    scene = make()
    n_batches = 16 if case == "veach_door" else 4
    min_depth = 1 if light_image else 2
    pcfg = PathConfig(max_depth=depth, rr_depth=100, thinlens=thinlens,
                      min_depth=min_depth)

    def pt(u):
        return jnp.mean(trace_paths(scene, pcfg, u).value[:, 0, :], axis=0)

    a = _mean(pt, pcfg.n_dims, 1, n_batches)
    if light_image:
        bcfg = BDPTConfig(max_depth=depth, thinlens=thinlens)
        b = _mean(_splat_mean(make_mmlt_trace(scene, bcfg)),
                  mmlt_n_dims(bcfg), 2, n_batches)
    else:
        b = 0.0
        for k in range(min_depth, depth + 1):
            trace, _, n_dims = make_mmlt_trace_fixed(scene, k,
                                                     light_image=False)
            b = b + _mean(_splat_mean(trace), n_dims, 2 + k, n_batches)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert a.mean() > 0
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=rtol)
