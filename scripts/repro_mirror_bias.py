"""Repro: BDPT/MMLT MIS bias on specular (mirror) chains at k>=3.

Compares image-mean per max_depth for PT vs full-MIS BDPT on the mirror
Cornell.  Pre-fix: BDPT ~17% low at depth>=3 (delta-chain MIS ratios use
a remapped 0 for the reverse pdf across a Dirac vertex while the forward
pdf stores 1*conversion, so Dirac factors don't cancel in sum_ri).
"""
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators.bidir import BDPTConfig, trace_bdpt
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import render_pt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box

W = H = 16
scene = cornell_box(W, H, tall_box_material="mirror")
fc = filmlib.make_film_config(W, H, "box")


def pt_mean(depth, spp_factor=64):
    f = render_pt(scene, PathConfig(max_depth=depth, rr_depth=100),
                  jax.random.PRNGKey(40 + depth), 16384 * spp_factor, fc,
                  mode="accum")
    return np.asarray(filmlib.develop(fc, f, mode="accum")).mean((0, 1))


def bdpt_mean(depth, n_batches=48, batch=8192):
    bcfg = BDPTConfig(max_depth=depth)

    @jax.jit
    def run(key, film):
        u = jax.random.uniform(key, (batch, bcfg.n_dims))
        sp = trace_bdpt(scene, bcfg, u)
        pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
        return filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                             mode="splat")

    film = filmlib.new_film(fc)
    for i in range(n_batches):
        film = run(jax.random.fold_in(jax.random.PRNGKey(5), i), film)
    img = filmlib.develop(fc, film, mode="splat",
                          scale=W * H / (n_batches * batch))
    return np.asarray(img).mean((0, 1))


for depth in (2, 3, 4):
    pt = pt_mean(depth)
    bd = bdpt_mean(depth)
    print(f"depth {depth}: PT {pt.mean():.5f}  BDPT {bd.mean():.5f}  "
          f"ratio {bd.mean() / pt.mean():.4f}")
