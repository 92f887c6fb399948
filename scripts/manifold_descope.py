"""Manifold-perturbation descope evidence (VERDICT r3 #8).

The reference's manifold walk (mut_manifold.cpp + manifold.cpp:1324)
targets tight specular-chain neighborhoods via per-vertex Newton
iteration — hostile to SIMD lanes.  Our coverage claim: orbital DRMLT's
pairwise rotations + the path-space lens/caustic/MCHAIN trio explore the
same neighborhoods.  This script measures, on THREE scenes of rising
specular-chain difficulty (single chain, double chain, long double
chain), masked mean relative error vs an equal-mutation-count PT
reference for (a) pssmlt, (b) drmlt-orbital, (c) path-space mlt without
mchain, (d) with mchain.  Writes MANIFOLD_DESCOPE.json.

    python scripts/manifold_descope.py
"""
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")   # a CPU study

import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.integrators import pathspace as P
from drmlt_mitsuba.integrators.bidir import BDPTConfig
from drmlt_mitsuba.integrators.drmlt import DRMLTConfig, render_drmlt
from drmlt_mitsuba.integrators.layout import PathConfig
from drmlt_mitsuba.integrators.path import make_path_trace, render_pt
from drmlt_mitsuba.integrators.pssmlt import PSSMLTConfig, render_pssmlt
from drmlt_mitsuba.render import film as filmlib
from drmlt_mitsuba.scene.builders import cornell_box


def err(img, ref):
    m = np.asarray(ref).mean(-1)
    a = np.asarray(img).mean(-1)
    mask = m > 0.05 * m.mean()
    return float(np.abs(a - m)[mask].mean() / m[mask].mean())


def main():
    from drmlt_mitsuba.scene.builders import pool_box

    chains = 4096
    # (scene, W, depth, steps): the pool SDS torture scene runs at the
    # VERDICT-required 64^2 film and depth 8 (its floor paths are k=6)
    scenes = {
        "glass-box (1 chain)": (
            cornell_box(32, 32, tall_box_material="glass"), 32, 6, 1500),
        "mirror-box+mirror-sphere (2 chains)": (
            cornell_box(32, 32, tall_box_material="mirror",
                        sphere_material="mirror"), 32, 6, 1500),
        "glass-box+glass-sphere (long chains)": (
            cornell_box(32, 32, tall_box_material="glass",
                        sphere_material="glass"), 32, 6, 1500),
        "pool-SDS (glass slab, every floor path SDS)": (
            pool_box(64, 64), 64, 8, 3000),
    }
    if os.environ.get("MANIFOLD_SCENES"):
        want = os.environ["MANIFOLD_SCENES"].split(",")
        scenes = {k: v for k, v in scenes.items()
                  if any(w in k for w in want)}
    out = {"chains": chains, "scenes": {}, "film_per_scene": {
        k: [v[1], v[1]] for k, v in scenes.items()}}
    if os.path.exists("MANIFOLD_DESCOPE.json"):
        with open("MANIFOLD_DESCOPE.json") as f:
            prev = json.load(f)
        out["scenes"].update(prev.get("scenes", {}))
    for name, (scene, W, depth, steps) in scenes.items():
        H = W
        fc = filmlib.make_film_config(W, H, "box")
        pcfg = PathConfig(max_depth=depth, rr_depth=100)
        # full-range reference (pssmlt/drmlt rows) and a k>=2 restricted
        # one (the path-space mlt targets k in [2, max_depth])
        pcfg2 = PathConfig(max_depth=depth, rr_depth=100, min_depth=2)
        ref = ref2 = None
        for i in range(8):
            film = render_pt(scene, pcfg, jax.random.fold_in(
                jax.random.PRNGKey(77), i), W * H * 512, fc, mode="accum")
            img = np.asarray(filmlib.develop(fc, film, mode="accum"))
            ref = img if ref is None else ref + img
            film = render_pt(scene, pcfg2, jax.random.fold_in(
                jax.random.PRNGKey(99), i), W * H * 512, fc, mode="accum")
            img = np.asarray(filmlib.develop(fc, film, mode="accum"))
            ref2 = img if ref2 is None else ref2 + img
        ref /= 8
        ref2 /= 8
        rows = {}
        is_pool = "pool" in name

        def rec(tag, img, refimg):
            rows[tag] = err(img, refimg)
            if is_pool:
                # the through-slab (SDS) region is the lower film third;
                # the global masked metric is dominated by the easy
                # above-slab transport, so report the SDS band alone
                cut = 2 * H // 3
                rows[tag + "@sds-band"] = err(img[cut:], refimg[cut:])

        trace = make_path_trace(scene, pcfg)
        n_dims = pcfg.n_dims + pcfg.n_dims % 2
        img, _ = render_pssmlt(trace, PSSMLTConfig(
            n_chains=chains, n_bootstrap=32768), fc,
            jax.random.PRNGKey(1), n_dims, steps)
        rec("pssmlt", img[..., :3], ref)

        img, _ = render_drmlt(trace, DRMLTConfig(
            type="orbital", n_chains=chains, n_bootstrap=32768), fc,
            jax.random.PRNGKey(2), n_dims, steps)
        rec("drmlt-orbital", np.asarray(img)[..., :3], ref)

        mcfg = P.MLTConfig(max_depth=depth, n_chains=chains,
                           n_bootstrap=32768)
        img, _ = P.render_mlt(scene, mcfg, fc, jax.random.PRNGKey(3),
                              n_steps=steps // 2,
                              mutators=("bidir", "lens", "bidir",
                                        "caustic"))
        rec("mlt(no mchain)", img, ref2)
        img, _ = P.render_mlt(scene, mcfg, fc, jax.random.PRNGKey(3),
                              n_steps=steps // 2,
                              mutators=("bidir", "lens", "mchain",
                                        "caustic"))
        rec("mlt(+mchain)", img, ref2)

        out["scenes"][name] = rows
        print(name, rows, flush=True)
        with open("MANIFOLD_DESCOPE.json", "w") as f:
            json.dump(out, f, indent=1)
    with open("MANIFOLD_DESCOPE.json", "w") as f:
        json.dump(out, f, indent=1)
    print("wrote MANIFOLD_DESCOPE.json")


if __name__ == "__main__":
    main()
