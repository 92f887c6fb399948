"""Renderer CLI (ref: src/mitsuba/mitsuba.cpp:129-436).

    python -m drmlt_mitsuba.utils.cli scene.xml -D integrator=drmlt \
        -D technique=mmlt -D type=orbital -o out.exr

Flag mapping from the reference CLI:
  -D key=value   $key substitution in the scene XML (mitsuba.cpp:169-175)
  -o output      output EXR
  -q             quiet
  -L level       log level (trace/debug/info/warn/error)
  -r seconds     write partial images every N seconds + _time.csv
                 (Scene::flush, scene.cpp:467-510)
  -t seconds     render timeout (equal-time comparisons, drmlt.cpp:295)
  -s seed        RNG seed
  -x             skip if the output file already exists (mitsuba.cpp:391)
  -z             suppress progress output
Distribution flags (-c/-s hosts, -p cores) are subsumed by the SPMD design:
chain parallelism covers every device JAX sees (SURVEY.md §5.8).
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import numpy as np


def _pbool(v, default=False):
    """Boolean integrator option that may arrive as an XML bool or as a
    `-D key=false` CLI string (bool("false") is truthy — the trap the
    round-2 advisor flagged for equalChains/grouped)."""
    if v is None:
        return default
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes", "on")
    return bool(v)


def _thinlens(scene):
    """True when the camera has a lens (aperture > 0): the integrators
    consume 2 lens dims and bidir importance projects through the lens."""
    return float(np.asarray(scene.camera.aperture_radius)) > 0.0


def _bidir_medium(scene):
    """True when the global medium participates in bidir walks —
    homogeneous (analytic pdf factors) or heterogeneous (Woodcock walks +
    deterministic marched MIS factors, bidir.py round-3)."""
    from drmlt_mitsuba.render.medium import (
        HeterogeneousMedium, HomogeneousMedium,
    )

    return isinstance(scene.medium,
                      (HomogeneousMedium, HeterogeneousMedium))


def build_trace(scene, settings, icfg):
    """Map an integrator config onto (trace_fn, n_dims, frozen, pinned,
    technique)."""
    import jax.numpy as jnp

    from drmlt_mitsuba.integrators.bidir import BDPTConfig, trace_bdpt
    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.mmlt import (
        make_mmlt_trace, mmlt_masks,
    )
    from drmlt_mitsuba.integrators.path import trace_paths

    technique = icfg.get("technique", "path")
    max_depth = int(icfg.get("maxDepth", 8))
    if max_depth <= 0:
        max_depth = 12
    tl = _thinlens(scene)
    if technique in ("path", "volpath", "volpath_simple"):
        from drmlt_mitsuba.integrators.path import make_path_trace

        pcfg = PathConfig(max_depth=max_depth, rr_depth=100,
                          min_depth=int(icfg.get("minDepth", 1)),
                          thinlens=tl,
                          motion=getattr(settings, "motion", False)
                          and scene.motion is not None)
        n = pcfg.n_dims + pcfg.n_dims % 2
        trace = make_path_trace(scene, pcfg)
        return trace, n, jnp.zeros((n,), bool), jnp.zeros((n,), bool), {}
    if technique == "bdpt":
        bcfg = BDPTConfig(max_depth=max_depth,
                          light_image=_pbool(icfg.get("lightImage"), True),
                          thinlens=tl, medium=_bidir_medium(scene))
        n = bcfg.n_dims + bcfg.n_dims % 2
        trace = lambda u: trace_bdpt(scene, bcfg, u[:, : bcfg.n_dims])
        return trace, n, jnp.zeros((n,), bool), jnp.zeros((n,), bool), {}
    if technique == "mmlt":
        from drmlt_mitsuba.integrators.mmlt import (
            mmlt_emitter_mask, mmlt_lt_mask_fn,
        )

        bcfg = BDPTConfig(max_depth=max_depth,
                          light_image=_pbool(icfg.get("lightImage"), True),
                          thinlens=tl, medium=_bidir_medium(scene))
        frozen, pinned, n = mmlt_masks(bcfg)
        trace = make_mmlt_trace(scene, bcfg)
        extras = dict(emitter_mask=mmlt_emitter_mask(bcfg, n),
                      lt_mask_fn=mmlt_lt_mask_fn(bcfg))
        return trace, n, frozen, pinned, extras
    raise SystemExit(f"unknown technique '{technique}'")


def render(scene, settings, args, log):
    import jax
    import jax.numpy as jnp

    from drmlt_mitsuba.core.logger import dump_config
    from drmlt_mitsuba.core.stats import Statistics
    from drmlt_mitsuba.integrators.bidir import BDPTConfig, trace_bdpt
    from drmlt_mitsuba.integrators.drmlt import (
        DRMLTConfig, drmlt_step,
    )
    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.mcmc import bootstrap
    from drmlt_mitsuba.integrators.path import render_pt, trace_paths
    from drmlt_mitsuba.integrators.pssmlt import (
        PSSMLTConfig, pssmlt_step,
    )
    from drmlt_mitsuba.integrators.twostage import (
        apply_importance_to_image, luminance_pass, with_importance_map,
    )
    from drmlt_mitsuba.render import film as filmlib
    from drmlt_mitsuba.scene.builders import cornell_box  # noqa: F401

    icfg = dict(settings.integrator)
    # -D pairs that no $key in the XML consumed still act as integrator
    # options (equalChains/grouped/variant/... never appear in scene files);
    # XML-provided keys win, matching the reference's substitution-only
    # semantics (mitsuba.cpp:169-175).
    for kv in getattr(args, "D", []):
        k, _, v = kv.partition("=")
        icfg.setdefault(k, v)
    itype = icfg.get("type", "path")
    W, H = settings.width, settings.height
    fc = filmlib.make_film_config(W, H, settings.filter_name)
    key = jax.random.PRNGKey(args.seed)
    stats = Statistics()
    t_start = time.time()
    dump_config(log, itype, icfg)

    # ---- non-MCMC integrators --------------------------------------------
    if itype in ("path", "volpath", "volpath_simple", "direct"):
        depth = int(icfg.get("maxDepth", 8))
        if itype == "direct":
            depth = 2
        pcfg = PathConfig(max_depth=max(1, depth), rr_depth=100,
                          thinlens=_thinlens(scene),
                          motion=getattr(settings, "motion", False)
                          and scene.motion is not None)
        film = render_pt(scene, pcfg, key, W * H * settings.spp, fc,
                         mode="accum",
                         sampler=getattr(settings, "sampler",
                                         "independent"))
        img = filmlib.develop(fc, film, mode="accum")
        return np.asarray(img), stats, None

    if itype == "ptracer":
        # adjoint particle tracer (ptracer.cpp:203): light-tracing-only
        from drmlt_mitsuba.integrators.misc import render_ptracer

        img = render_ptracer(
            scene, fc, key, W * H * settings.spp,
            max_depth=max(1, int(icfg.get("maxDepth", 5))))
        return np.asarray(img), stats, None

    if itype == "field":
        from drmlt_mitsuba.integrators.misc import render_field

        img = render_field(scene, fc, key,
                           icfg.get("field", "shnormal"),
                           spp=max(1, settings.spp))
        return np.asarray(img), stats, None

    if itype == "multichannel":
        from drmlt_mitsuba.integrators.misc import render_multichannel

        chans = tuple(icfg.get(
            "channels", "radiance,shnormal,distance,albedo").split(","))
        img = render_multichannel(scene, fc, key, channels=chans,
                                  radiance_spp=max(1, settings.spp))
        return np.asarray(img), stats, None

    if itype == "motion":
        from drmlt_mitsuba.integrators.misc import render_motion_aov

        img = render_motion_aov(scene, fc, key, spp=max(1, settings.spp))
        return np.asarray(img), stats, None

    if itype == "bdpt":
        bcfg = BDPTConfig(max_depth=int(icfg.get("maxDepth", 5)),
                          light_image=_pbool(icfg.get("lightImage"), True),
                          thinlens=_thinlens(scene),
                          medium=_bidir_medium(scene))
        n_total = W * H * settings.spp
        chunk = 8192
        n_chunks = max(1, n_total // chunk)

        @jax.jit
        def run():
            def body(film, i):
                u = jax.random.uniform(jax.random.fold_in(key, i),
                                       (chunk, bcfg.n_dims))
                sp = trace_bdpt(scene, bcfg, u)
                pos = sp.pos.reshape(-1, 2) * jnp.asarray([W, H], jnp.float32)
                film = filmlib.splat(fc, film, pos, sp.value.reshape(-1, 3),
                                     mode="splat")
                return film, None

            f, _ = jax.lax.scan(body, filmlib.new_film(fc),
                                jnp.arange(n_chunks))
            return f

        film = run()
        img = filmlib.develop(fc, film, mode="splat",
                              scale=W * H / (n_chunks * chunk))
        return np.asarray(img), stats, None

    if itype == "erpt":
        from drmlt_mitsuba.integrators.erpt import (
            ERPTConfig, render_erpt, render_erpt_mlt,
        )
        from drmlt_mitsuba.integrators.layout import (
            PathConfig as _PC,
        )
        from drmlt_mitsuba.integrators.pathspace import mlt_eligible

        pcfg = PathConfig(max_depth=int(icfg.get("maxDepth", 8)),
                          rr_depth=100)
        ecfg = ERPTConfig(
            n_chains=int(icfg.get("chains", 4096)),
            chain_length=int(icfg.get("numChains", 100)),
            samples_per_batch=int(icfg.get("luminanceSamples", 16384)),
        )
        n_batches = max(1, W * H * settings.spp
                        // (ecfg.n_chains * ecfg.chain_length))
        if mlt_eligible(scene):
            # the reference's erpt: path-space perturbation chains
            # (erpt_proc.cpp) with per-batch equal-deposition energy;
            # direct (k < 2) via plain PT like the mlt branch
            if pcfg.max_depth < 2:
                log.info("erpt: raising maxDepth %d -> 2 (the chain "
                         "stage needs at least one indirect bounce)",
                         pcfg.max_depth)
            img, aux = render_erpt_mlt(
                scene, ecfg, fc, key, n_batches,
                max_depth=max(pcfg.max_depth, 2), kmin=2)
            dp = PathConfig(max_depth=1, rr_depth=100, min_depth=1)
            dfilm = render_pt(scene, dp, jax.random.fold_in(key, 902),
                              W * H * int(icfg.get("directSamples", 64)),
                              fc, mode="accum")
            img = np.asarray(img)[..., :3] + np.asarray(
                filmlib.develop(fc, dfilm, mode="accum"))[..., :3]
            return np.asarray(img), stats, None
        log.info("erpt: scene outside the path-space subset; using the "
                 "primary-sample-space redistribution chains")
        trace = lambda u: trace_paths(scene, pcfg, u)
        img, aux = render_erpt(trace, ecfg, fc, key, pcfg.n_dims, n_batches)
        return np.asarray(img), stats, None

    if itype == "mlt":
        # Veach path-space MLT: real vertex-path mutations
        # (integrators/pathspace.py — bidirectional mutation + lens +
        # caustic perturbations; ref src/libbidir/mut_*.cpp driven by
        # mlt_proc.cpp).  Scenes outside the path-space subset (media,
        # env/delta lights, thinlens, smooth-shaded meshes) fall back to
        # Gaussian-mutation PSSMLT with a loud warning.
        from drmlt_mitsuba.integrators.pathspace import (
            MLTConfig, mlt_eligible, render_mlt,
        )

        if mlt_eligible(scene):
            sep = _pbool(icfg.get("separateDirect"), True)
            kmin = 3 if sep else 2
            mcfg = MLTConfig(
                max_depth=max(int(icfg.get("maxDepth", 6)), kmin + 1),
                kmin=kmin,
                n_chains=int(icfg.get("chains", args.chains)),
                n_bootstrap=int(icfg.get("luminanceSamples", 65536)),
            )
            n_steps = max(4, W * H * settings.spp // mcfg.n_chains)
            img, aux = render_mlt(scene, mcfg, fc, key, n_steps)
            log.info("mlt: b=%.6f, mean acceptance=%s", aux["b"],
                     np.asarray(aux["stats"]).mean(0))
            # direct component (paths shorter than kmin) via plain PT,
            # the reference's renderDirectComponent (util.cpp:30-95)
            dp = PathConfig(max_depth=kmin - 1, rr_depth=100, min_depth=1)
            dfilm = render_pt(scene, dp, jax.random.fold_in(key, 901),
                              W * H * int(icfg.get("directSamples", 64)),
                              fc, mode="accum")
            img = np.asarray(img)[..., :3] + np.asarray(
                filmlib.develop(fc, dfilm, mode="accum"))[..., :3]
            return np.asarray(img), stats, None

        import warnings

        warnings.warn(
            "integrator 'mlt': scene outside the path-space mutation "
            "subset (media/env/delta lights/thinlens/smooth shading); "
            "running as Gaussian-mutation PSSMLT instead")
        icfg = {**icfg, "type": "pssmlt", "kelemenStyleMutation": False}
        itype = "pssmlt"

    if itype not in ("pssmlt", "drmlt"):
        raise SystemExit(f"unknown integrator '{itype}'")

    # ---- depth-grouped MMLT driver (default on for drmlt+mmlt) ----------
    # Static per-depth chain groups mirror the reference's per-depth work
    # units (pathsampler.cpp:884-934); by default every group runs the full
    # chain batch with luminance-proportional STEP counts
    # (-D equalChains=false restores luminance-proportional chain counts).
    # Disable with -D grouped=false (e.g. to compare, or for
    # twoStage/separateDirect which run through the pooled path).
    if (itype == "drmlt" and icfg.get("technique") == "mmlt"
            and _pbool(icfg.get("grouped"), True)
            and not icfg.get("twoStage") and not icfg.get("separateDirect")
            and not (args.shard and len(jax.devices()) > 1)):
        from drmlt_mitsuba.integrators.mmlt_grouped import (
            render_drmlt_mmlt_grouped,
        )

        bcfg = BDPTConfig(max_depth=int(icfg.get("maxDepth", 5)),
                          light_image=_pbool(icfg.get("lightImage"), True),
                          thinlens=_thinlens(scene),
                          medium=_bidir_medium(scene))
        n_chains = int(icfg.get("chains", args.chains))
        dcfg = DRMLTConfig(
            type=icfg.get("variant", "green"),
            n_chains=n_chains,
            p_large=float(icfg.get("pLarge", 0.3)),
            sigma=float(icfg.get("sigma", 1 / 64)),
            scale_second=float(icfg.get("scaleSecond", 0.1)),
            timid_after_large=_pbool(icfg.get("timidAfterLarge"), False),
            acceptance_map=_pbool(icfg.get("acceptanceMap"), False),
            use_mixture=_pbool(icfg.get("useMixture"), False),
            fix_emitter_path=_pbool(icfg.get("fixEmitterPath"), False),
            n_bootstrap=int(icfg.get("luminanceSamples", 100_000)),
        )
        n_steps = max(1, W * H * settings.spp // n_chains)
        avg_lum = (float(icfg["averageLuminance"])
                   if float(icfg.get("averageLuminance", -1)) > 0 else None)
        log.info("depth-grouped MMLT driver: %d chains, %d steps",
                 n_chains, n_steps)
        img, aux = render_drmlt_mmlt_grouped(
            scene, bcfg, dcfg, fc, key, n_steps, average_luminance=avg_lum,
            min_group=max(64, min(1024, n_chains // 4)),
            equal_chains=_pbool(icfg.get("equalChains"), True))
        log.info("b = %.6f, group sizes = %s, steps = %s", aux["b"],
                 aux["sizes"], aux["steps_per_group"])
        acc = (np.asarray(aux["accmap"])
               if aux.get("accmap") is not None else None)
        return np.asarray(img), stats, acc

    # DRMLT over the path technique
    if (itype == "drmlt"
            and icfg.get("technique", "path") == "path"
            and not icfg.get("twoStage") and not icfg.get("separateDirect")
            and not _pbool(icfg.get("acceptanceMap"), False)
            and not _pbool(icfg.get("useMixture"), False)
            and not (args.shard and len(jax.devices()) > 1)):
        from drmlt_mitsuba.integrators.drmlt import render_drmlt_path

        n_chains = int(icfg.get("chains", args.chains))
        dcfg = DRMLTConfig(
            type=icfg.get("variant", "green"),
            n_chains=n_chains,
            p_large=float(icfg.get("pLarge", 0.3)),
            sigma=float(icfg.get("sigma", 1 / 64)),
            scale_second=float(icfg.get("scaleSecond", 0.1)),
            timid_after_large=_pbool(icfg.get("timidAfterLarge"), False),
            n_bootstrap=int(icfg.get("luminanceSamples", 100_000)),
        )
        md = int(icfg.get("maxDepth", 8))
        pcfg_d = PathConfig(max_depth=md if md > 0 else 12,
                            rr_depth=100,   # no RR inside MCMC (build_trace)
                            min_depth=int(icfg.get("minDepth", 1)),
                            thinlens=_thinlens(scene),
                            motion=getattr(settings, "motion", False)
                            and scene.motion is not None)
        n_steps = max(1, W * H * settings.spp // n_chains)
        avg_lum = (float(icfg["averageLuminance"])
                   if float(icfg.get("averageLuminance", -1)) > 0 else None)
        img, aux = render_drmlt_path(scene, pcfg_d, dcfg, fc, key, n_steps,
                                     average_luminance=avg_lum)
        log.info("b = %.6f", float(aux["b"]))
        return np.asarray(img)[..., :3], stats, None

    # ---- MCMC integrators -------------------------------------------------
    trace, n_dims, frozen, pinned, extras = build_trace(scene, settings, icfg)

    # separate direct-illumination pass (renderDirectComponent)
    direct_img = None
    if _pbool(icfg.get("separateDirect"), False) and icfg.get(
        "technique", "path"
    ) == "path":
        dcfg_pt = PathConfig(max_depth=2, rr_depth=100)
        dfilm = render_pt(scene, dcfg_pt, jax.random.fold_in(key, 901),
                          W * H * int(icfg.get("directSamples", 16)), fc,
                          mode="accum")
        direct_img = np.asarray(filmlib.develop(fc, dfilm, mode="accum"))
        pcfg = PathConfig(max_depth=int(icfg.get("maxDepth", 8)),
                          rr_depth=100, min_depth=3)
        trace = lambda u: trace_paths(scene, pcfg, u[:, : pcfg.n_dims])

    # two-stage importance map (mltLuminancePass)
    imap = None
    if _pbool(icfg.get("twoStage"), False):
        def lowres(w, h):
            fc2 = filmlib.make_film_config(w, h, "box")
            pcfg2 = PathConfig(max_depth=int(icfg.get("maxDepth", 8)),
                               rr_depth=100)
            f2 = render_pt(scene, pcfg2, jax.random.fold_in(key, 902),
                           w * h * 64, fc2, mode="accum")
            return filmlib.develop(fc2, f2, mode="accum")

        imap = luminance_pass(lowres, fc)
        trace = with_importance_map(trace, imap)
        log.info("two-stage importance map ready (mean %.4f)",
                 float(jnp.mean(imap)))

    n_chains = int(icfg.get("chains", args.chains))
    n_boot = int(icfg.get("luminanceSamples", 100_000))
    total_mut = W * H * settings.spp
    n_steps = max(1, total_mut // n_chains)

    k_boot, k_run = jax.random.split(jax.random.fold_in(key, 7))
    log.info("bootstrap: %d samples, %d chains", n_boot, n_chains)
    state, b = bootstrap(trace, k_boot, n_dims, n_boot, n_chains)
    if icfg.get("averageLuminance", -1) and float(
        icfg.get("averageLuminance", -1)
    ) > 0:
        b = jnp.float32(float(icfg["averageLuminance"]))
    log.info("b = %.6f", float(b))

    if itype == "pssmlt":
        mcfg = PSSMLTConfig(
            n_chains=n_chains,
            p_large=float(icfg.get("pLarge", 0.3)),
            kelemen_style_mutation=_pbool(icfg.get("kelemenStyleMutation"), True),
            kelemen_style_weights=_pbool(icfg.get("kelemenStyleWeights"), True)
            and imap is None,
            mutation_size_low=float(icfg.get("mutationSizeLow", 1 / 1024)),
            mutation_size_high=float(icfg.get("mutationSizeHigh", 1 / 64)),
            sigma=float(icfg.get("sigma", 1 / 64)),
            n_bootstrap=n_boot,
            # PSS analogs of the Veach lens/caustic perturbations
            # (mut_lens.cpp / mut_caustic.cpp; tested in
            # tests/test_mcmc.py::TestMutationMixture)
            p_lens=float(icfg.get("pLens", 0.0)),
            p_caustic=float(icfg.get("pCaustic", 0.0)),
            lens_sigma=float(icfg.get("lensSigma", 1 / 16)),
            caustic_dims=int(icfg.get("causticDims", 7)),
        )

        def step(carry, k):
            (st, fl), s = pssmlt_step(trace, mcfg, b, fc, (carry[0], carry[1]),
                                      k, pinned)
            return (st, fl, carry[2]), s
        kelemen_w = mcfg.kelemen_style_weights
    else:
        variant = icfg.get("variant", "green")
        if variant not in ("green", "mira", "orbital"):
            log.warning("unknown drmlt type '%s', using green", variant)
            variant = "green"
        dcfg = DRMLTConfig(
            type=variant,
            n_chains=n_chains,
            p_large=float(icfg.get("pLarge", 0.3)),
            sigma=float(icfg.get("sigma", 1 / 64)),
            scale_second=float(icfg.get("scaleSecond", 0.1)),
            timid_after_large=_pbool(icfg.get("timidAfterLarge"), False),
            acceptance_map=_pbool(icfg.get("acceptanceMap"), False),
            use_mixture=_pbool(icfg.get("useMixture"), False),
            fix_emitter_path=_pbool(icfg.get("fixEmitterPath"), False),
            n_bootstrap=n_boot,
        )
        kelemen_w = False

        def step(carry, k):
            return drmlt_step(trace, dcfg, fc, frozen, carry, k,
                              pinned_mask=pinned, **extras)

    # ---- sharded multi-device run (chains over the (host, chain) mesh) --
    if args.shard and len(jax.devices()) > 1:
        from drmlt_mitsuba.parallel.distributed import (
            render_mcmc_sharded,
        )
        from drmlt_mitsuba.parallel.mesh import make_mesh

        mesh = make_mesh()
        log.info("sharded render over mesh %s", dict(mesh.shape))

        if itype == "pssmlt":
            def sharded_step(bv, carry, k):
                (st2, fl2), s2 = pssmlt_step(
                    trace, mcfg, bv, fc, (carry[0], carry[1]), k, pinned
                )
                return (st2, fl2, carry[2]), s2
        else:
            def sharded_step(bv, carry, k):
                return drmlt_step(trace, dcfg, fc, frozen, carry, k,
                                  pinned_mask=pinned, **extras)

        film_s, b_s, state_s, stats_s = render_mcmc_sharded(
            mesh, trace, sharded_step, fc, jax.random.fold_in(key, 7),
            n_dims, n_chains=n_chains, n_steps=n_steps, n_bootstrap=n_boot,
        )
        log.info("chain state shards: %s",
                 [(str(s.device), s.data.shape)
                  for s in state_s.u.addressable_shards])
        stats.record_mcmc(jax.tree.map(np.asarray, stats_s), n_chains)
        img = _develop_mcmc(fc, film_s, b_s, n_chains, n_steps, kelemen_w,
                            imap, direct_img)
        return img, stats, None

    film = filmlib.new_film(fc)
    accmap = filmlib.new_film(fc) if icfg.get("acceptanceMap") else None

    block = max(1, min(256, n_steps))

    @jax.jit
    def run_block(carry, i0):
        def body(c, i):
            return step(c, jax.random.fold_in(k_run, i))

        carry, s = jax.lax.scan(body, carry, i0 + jnp.arange(block))
        return carry, s

    carry = (state, film, accmap)
    all_stats = []
    done = 0
    part = 0
    last_dump = time.time()
    times_csv = []
    if args.resume and args.checkpoint and os.path.exists(
        args.checkpoint if args.checkpoint.endswith(".npz")
        else args.checkpoint + ".npz"
    ):
        from drmlt_mitsuba.parallel.checkpoint import load_checkpoint

        st0, film0, b0, done, k0, acc0 = load_checkpoint(args.checkpoint)
        carry = (st0, film0, acc0 if accmap is not None else None)
        b = jnp.float32(b0)
        log.info("resumed from %s at step %d", args.checkpoint, done)
    while done < n_steps:
        carry, s = run_block(carry, jnp.int32(done))
        done += block
        all_stats.append(jax.tree.map(np.asarray, s))
        if args.timeout and time.time() - t_start > args.timeout:
            log.info("timeout reached after %d/%d steps", done, n_steps)
            break
        if args.refresh and time.time() - last_dump > args.refresh:
            img = _develop_mcmc(fc, carry[1], b, n_chains, done, kelemen_w,
                                imap, direct_img)
            _write_partial(args, img, part, time.time() - t_start, times_csv)
            part += 1
            last_dump = time.time()
        if args.checkpoint:
            from drmlt_mitsuba.parallel.checkpoint import save_checkpoint

            save_checkpoint(args.checkpoint, carry[0], carry[1], float(b),
                            done, k_run, carry[2])

    stats_cat = {
        k: np.concatenate([st[k] for st in all_stats])
        for k in all_stats[0]
    }
    stats.record_mcmc(stats_cat, n_chains)
    img = _develop_mcmc(fc, carry[1], b, n_chains, done, kelemen_w, imap,
                        direct_img)
    acc = np.asarray(carry[2]) if carry[2] is not None else None
    return img, stats, acc


def _develop_mcmc(fc, film, b, n_chains, n_steps, kelemen_w, imap,
                  direct_img):
    from drmlt_mitsuba.integrators.twostage import (
        apply_importance_to_image,
    )
    from drmlt_mitsuba.render import film as filmlib
    import numpy as np

    n_pp = max(1, n_chains * n_steps) / fc.npixels
    scale = (1.0 / n_pp) if kelemen_w else float(b) / n_pp
    img = filmlib.develop(fc, film, mode="splat", scale=scale)
    if imap is not None:
        img = apply_importance_to_image(img, imap)
    img = np.asarray(img)
    if direct_img is not None:
        img = img + direct_img
    return img


def _write_partial(args, img, part, elapsed, times_csv):
    from drmlt_mitsuba.utils.exr import write_exr

    base, _ = os.path.splitext(args.output)
    write_exr(f"{base}_{part}.exr", img)
    times_csv.append((part, elapsed))
    with open(f"{base}_time.csv", "w", newline="") as f:
        wr = csv.writer(f)
        for row in times_csv:
            wr.writerow(row)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="drmlt-mitsuba",
        description="DRMLT renderer in JAX (mitsuba CLI equivalent)",
    )
    ap.add_argument("scene", help="Mitsuba scene XML")
    ap.add_argument("-D", action="append", default=[], metavar="key=value",
                    help="parameter substitution ($key in the XML)")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("-L", "--log-level", default="info")
    ap.add_argument("-r", "--refresh", type=float, default=0,
                    help="partial image dump interval (seconds)")
    ap.add_argument("-t", "--timeout", type=float, default=0)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("-x", "--skip-existing", action="store_true")
    ap.add_argument("-z", "--no-progress", action="store_true")
    ap.add_argument("--chains", type=int, default=16384,
                    help="MCMC chain batch size per device")
    ap.add_argument("--spp", type=int, default=None,
                    help="override sampler sampleCount")
    ap.add_argument("--checkpoint", default=None,
                    help="chain-state checkpoint file (written per block)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if present")
    ap.add_argument("--shard", action="store_true",
                    help="shard chains over all visible devices "
                         "(multi-chip/multi-host SPMD)")
    args = ap.parse_args(argv)

    import jax

    from drmlt_mitsuba.core.cache import enable_compile_cache
    from drmlt_mitsuba.core.logger import setup_logging
    from drmlt_mitsuba.scene.xml import load_scene_xml
    from drmlt_mitsuba.utils.exr import write_exr

    if args.output is None:
        args.output = os.path.splitext(args.scene)[0] + ".exr"
    if args.skip_existing and os.path.exists(args.output):
        print(f"{args.output} exists, skipping (-x)")
        return 0

    log = setup_logging(args.log_level, quiet=args.quiet)
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform == "cpu" and not os.environ.get("JAX_PLATFORMS"):
        log.warning("JAX found no accelerator: rendering on the CPU")
    log.info("devices: %d x %s (%s)", len(jax.devices()), dev.device_kind,
             dev.platform)
    defaults = dict(kv.split("=", 1) for kv in args.D)
    scene, settings = load_scene_xml(args.scene, defaults)
    if args.spp:
        settings.spp = args.spp
    if getattr(settings, "subsurface", None):
        # dipole preprocess: irradiance point clouds (needs the built
        # scene for visibility; ref dipole.cpp preprocess())
        from drmlt_mitsuba.render.subsurface import prepare_dipole

        tables = []
        for i, req in enumerate(settings.subsurface):
            log.info("subsurface dipole preprocess (mat %d)...",
                     req["mat_id"])
            tables.append(prepare_dipole(
                scene, req["mat_id"], req["sigma_s"], req["sigma_a"],
                g=req["g"], eta=req["eta"],
                irr_samples=req["irr_samples"], indirect=req["indirect"],
                key=jax.random.PRNGKey(4321 + i)))
        scene = scene.replace(subsurface=tuple(tables))
    log.info("scene: %d triangles, %d spheres, %dx%d film",
             scene.tris.v0.shape[0], scene.spheres.center.shape[0],
             settings.width, settings.height)

    t0 = time.time()
    img, stats, accmap = render(scene, settings, args, log)
    dt = time.time() - t0
    log.info("render finished in %.1fs", dt)

    if args.output.endswith(".png"):
        from PIL import Image

        srgb = np.where(
            np.clip(img, 0, 1) <= 0.0031308, np.clip(img, 0, 1) * 12.92,
            1.055 * np.maximum(np.clip(img, 0, 1), 1e-8) ** (1 / 2.4) - 0.055,
        )
        Image.fromarray((srgb * 255).astype(np.uint8)).save(args.output)
    elif args.output.endswith(".npy"):
        np.save(args.output, img)   # mfilm equivalent
    else:
        write_exr(args.output, img)
    log.info("wrote %s", args.output)
    if accmap is not None:
        base, _ = os.path.splitext(args.output)
        write_exr(f"{base}_acceptance.exr", accmap[..., :3])
        log.info("wrote %s_acceptance.exr", base)
    base, _ = os.path.splitext(args.output)
    with open(f"{base}_stats.txt", "w") as f:
        f.write(stats.report() + "\n")
    print(stats.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
