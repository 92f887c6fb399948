"""Smoke test of the renderer on one NVIDIA GPU, through its normal entry
points at render sizes.

    python chip_smoke.py          # phases 1-6 plus timings, one GPU
    python chip_smoke.py --four   # the chain-sharded renders, four GPUs

Phases (each prints its compile and run seconds on a line of its own):

  1. device check: exit non-zero unless JAX's default device is a GPU;
  2. render_pt on the GPU against the same render on the CPU, same key;
  3. the CLI flagship (drmlt, technique=mmlt, orbital) at 512x512 with
     65536 chains, checked against a path-traced (PT) image mean;
  4. the CLI DRMLT path technique (render_drmlt_path), same check;
  5. the 19.6k-triangle XML+OBJ scene through render_pt, checked against
     native/cpu_oracle built from source on this host;
  6. jax.grad of an image loss w.r.t. albedo and emitter radiance,
     checked against central finite differences;
  then the wavefront's time for intersection, trace, film splat and a
  whole mutation (the baselines for any future hand-written kernel) and the timings that set
  TRI_CHUNK and the fuse_traces default.

Any failed check raises; the last line, printed only when every phase
passed, is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(ROOT, "tests", "data", "cornell.xml")
LARGE = os.path.join(ROOT, "tests", "data", "large", "cornell_large.xml")

# render sizes; a rehearsal on the CPU shrinks them
SIZES = dict(
    pt_film=64, pt_spp=64,                # phase 2
    film=512, chains=65536, spp=16,       # phases 3-4: 16 mutations/pixel
    ref_spp=64,                           # PT reference for phases 3-4
    boot=1_000_000,                       # luminance samples (b estimate)
    large_film=128, large_spp=64,         # phase 5
    grad_film=256, grad_paths=65536,      # phase 6
    rays=65536, steps=16,                 # timings
    four_film=256, four_spp=16, four_depth=2,  # --four
)

# PT-vs-PT on two backends with the same threefry stream differs only by
# float summation order and libm ulps; a rare path may still flip a branch
# (e.g. a Fresnel pick at a threshold), so a few pixels may move while the
# mean stays put.
GPU_CPU_MEAN_RTOL = 1e-4
GPU_CPU_PIXEL_RTOL = 1e-2
GPU_CPU_MAX_PIXEL_SHARE = 0.005
# MCMC image mean vs PT mean: the MCMC mean is b (a bootstrap estimate from
# SIZES["boot"] samples, ~0.5 % noise) times the splat total; a few percent
# as in the repo's MCMC-vs-MC tests.
MCMC_MEAN_RTOL = 0.03
# JAX PT vs cpu_oracle channel means (tests/test_oracle_parity.py)
ORACLE_MEAN_RTOL = 0.015
# gradient vs central difference: the loss is polynomial in albedo and
# quadratic in radiance; f32 roundoff over the step dominates
GRAD_FD_RTOL = 1e-2


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


class CompileClock:
    """Sums XLA's compile durations (a jax.monitoring event), so each phase
    splits its wall time into compile seconds and the rest (tracing,
    dispatch and device time)."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **_):
        if name == "/jax/core/compile/backend_compile_duration":
            self.total += secs


class Phase:
    def __init__(self, clock: CompileClock, name: str):
        self.clock, self.name = clock, name

    def __enter__(self):
        self.t0, self.c0 = time.perf_counter(), self.clock.total
        say(f"[{self.name}] start")
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self.t0
        comp = self.clock.total - self.c0
        state = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        say(f"[{self.name}] {state}: wall {wall:.2f} s, compile {comp:.2f} s,"
            f" run {wall - comp:.2f} s")
        self.run_s = wall - comp
        return False


def _cli(args: list[str]) -> np.ndarray:
    """Run the renderer CLI in this process (one process per card) and
    return the image it wrote."""
    from drmlt_mitsuba.utils.cli import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "img.npy")
        check(cli_main(args + ["-o", out]) == 0, f"cli {args}")
        return np.load(out)


def _timed(fn, *args, n: int = 5) -> float:
    """Steady seconds per call (after one warm-up call)."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


# ------------------------------------------------------------------ phases

def phase_gpu_vs_cpu() -> None:
    import jax

    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.path import render_pt
    from drmlt_mitsuba.render import film as filmlib
    from drmlt_mitsuba.scene.builders import cornell_box

    n = SIZES["pt_film"]
    cfg = PathConfig(max_depth=4, rr_depth=100)
    fc = filmlib.make_film_config(n, n, "box")

    def render():
        scene = cornell_box(n, n)
        film = render_pt(scene, cfg, jax.random.PRNGKey(0),
                         n * n * SIZES["pt_spp"], fc, mode="accum")
        return np.asarray(filmlib.develop(fc, film, mode="accum"))

    gpu = render()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = render()
    check(np.isfinite(gpu).all() and gpu.mean() > 0, "finite GPU image")
    mean_rel = _rel(gpu.mean(), cpu.mean())
    pix_rel = np.abs(gpu - cpu) / np.maximum(np.abs(cpu), 1e-3)
    share = float((pix_rel.max(-1) > GPU_CPU_PIXEL_RTOL).mean())
    say(f"  gpu vs cpu: mean rel {mean_rel:.3e} (<= {GPU_CPU_MEAN_RTOL}), "
        f"pixels off > {GPU_CPU_PIXEL_RTOL}: {share:.4%} "
        f"(<= {GPU_CPU_MAX_PIXEL_SHARE:.1%})")
    check(mean_rel <= GPU_CPU_MEAN_RTOL, "GPU/CPU image mean")
    check(share <= GPU_CPU_MAX_PIXEL_SHARE, "GPU/CPU pixel share")


def _film_args(n: int) -> list[str]:
    return ["-D", f"width={n}", "-D", f"height={n}"]


def phase_pt_reference(clock) -> float:
    with Phase(clock, "pt reference"):
        ref = _cli([CORNELL, "-D", "integrator=path", "-q",
                    "--spp", str(SIZES["ref_spp"])]
                   + _film_args(SIZES["film"]))
    check(np.isfinite(ref).all() and ref.mean() > 0, "finite PT image")
    say(f"  pt reference mean {ref.mean():.6f}")
    return float(ref.mean())


def phase_mcmc(clock, name: str, technique: str, ref_mean: float) -> None:
    n, chains, spp = SIZES["film"], SIZES["chains"], SIZES["spp"]
    with Phase(clock, name) as ph:
        img = _cli([CORNELL, "-D", "integrator=drmlt",
                    "-D", f"technique={technique}", "-D", "type=orbital",
                    "-D", f"luminanceSamples={SIZES['boot']}", "-q",
                    "--chains", str(chains), "--spp", str(spp)]
                   + _film_args(n))
    mutations = chains * max(1, n * n * spp // chains)
    rel = _rel(img.mean(), ref_mean)
    say(f"  {name}: {n}x{n}, {chains} chains, {mutations} mutations "
        f"({mutations / (n * n):.1f}/pixel), {mutations / ph.run_s:.4g} "
        f"mutations/s (run time incl. bootstrap), mean {img.mean():.6f} vs "
        f"PT {ref_mean:.6f}: rel {rel:.4f} (<= {MCMC_MEAN_RTOL})")
    check(img.shape == (n, n, 3) and np.isfinite(img).all(), "finite image")
    check(rel <= MCMC_MEAN_RTOL, f"{name} mean vs PT")


def phase_large_vs_oracle(clock, build) -> None:
    import jax

    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.path import render_pt
    from drmlt_mitsuba.render import film as filmlib
    from drmlt_mitsuba.scene.xml import load_scene_xml
    from drmlt_mitsuba.utils.native import native_path
    from drmlt_mitsuba.utils.scene_dump import dump_scene

    n, spp, depth = SIZES["large_film"], SIZES["large_spp"], 4
    with Phase(clock, "large scene pt"):
        scene, _ = load_scene_xml(LARGE)
        fc = filmlib.make_film_config(n, n, "box")
        film = render_pt(scene, PathConfig(max_depth=depth, rr_depth=99),
                         jax.random.PRNGKey(11), n * n * spp, fc,
                         mode="accum")
        a = np.asarray(filmlib.develop(fc, film, mode="accum"))[..., :3]
    with Phase(clock, "large scene cpu_oracle"):
        build()
        with tempfile.TemporaryDirectory() as tmp:
            sb, raw = os.path.join(tmp, "s.bin"), os.path.join(tmp, "o.raw")
            dump_scene(scene, fc, sb)
            r = subprocess.run([native_path("cpu_oracle"), "pt", sb, raw,
                                str(spp), str(depth), "both"],
                               capture_output=True, text=True, timeout=600)
            check(r.returncode == 0, f"cpu_oracle: {r.stderr[-500:]}")
            b = np.fromfile(raw, np.float32).reshape(n, n, 3)
    tris = int(scene.tris.v0.shape[0])
    rel = np.abs(a.mean((0, 1)) - b.mean((0, 1))) / np.maximum(
        b.mean((0, 1)), 1e-9)
    say(f"  {tris} triangles, {n}x{n} at {spp} spp, depth {depth}: channel "
        f"mean rel vs cpu_oracle {np.round(rel, 5).tolist()} "
        f"(<= {ORACLE_MEAN_RTOL})")
    check(tris > 15000, "large scene loaded")
    check(np.isfinite(a).all() and bool(np.all(rel < ORACLE_MEAN_RTOL)),
          "large scene vs cpu_oracle")


def phase_gradient() -> None:
    import jax
    import jax.numpy as jnp

    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.path import trace_paths
    from drmlt_mitsuba.render import film as filmlib
    from drmlt_mitsuba.scene.builders import cornell_box

    n = SIZES["grad_film"]
    scene = cornell_box(n, n)
    cfg = PathConfig(max_depth=4, rr_depth=100)
    fc = filmlib.make_film_config(n, n, "box")
    u = jax.random.uniform(jax.random.PRNGKey(3),
                           (SIZES["grad_paths"], cfg.n_dims))
    scale = jnp.asarray([n, n], jnp.float32)

    def image(albedo, radiance):
        s = scene.replace(
            materials=scene.materials.replace(albedo=albedo),
            emitters=scene.emitters.replace(radiance=radiance))
        sp = trace_paths(s, cfg, u)
        film = filmlib.splat(fc, filmlib.new_film(fc), sp.pos[:, 0] * scale,
                             sp.value[:, 0], mode="splat")
        return film[..., :3] * (n * n / u.shape[0])

    alb0, rad0 = scene.materials.albedo, scene.emitters.radiance
    target = 0.5 * image(alb0, rad0)
    loss = jax.jit(lambda a, r: jnp.mean((image(a, r) - target) ** 2))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(alb0, rad0)
    rng = np.random.default_rng(0)
    for name, i, x0, h in (("albedo", 0, alb0, 1e-3),
                           ("radiance", 1, rad0, 1e-2 * float(
                               jnp.max(rad0)))):
        v = jnp.asarray(rng.normal(size=x0.shape), jnp.float32)
        v = v / jnp.linalg.norm(v)
        args_p = [alb0, rad0]
        args_m = [alb0, rad0]
        args_p[i] = x0 + h * v
        args_m[i] = x0 - h * v
        fd = (float(loss(*args_p)) - float(loss(*args_m))) / (2 * h)
        ad = float(jnp.vdot(grads[i], v))
        rel = _rel(ad, fd)
        say(f"  d loss / d {name} along a random direction: jax.grad "
            f"{ad:.6e}, central difference {fd:.6e}: rel {rel:.2e} "
            f"(<= {GRAD_FD_RTOL})")
        check(np.isfinite(ad) and ad != 0.0, f"{name} gradient nonzero")
        check(rel <= GRAD_FD_RTOL, f"{name} gradient vs finite difference")


def phase_timings(clock) -> None:
    """The wavefront's time for intersection, trace, splat and a whole
    mutation, and the measurements behind TRI_CHUNK and fuse_traces."""
    import jax
    import jax.numpy as jnp

    from drmlt_mitsuba.integrators.drmlt import DRMLTConfig, drmlt_step
    from drmlt_mitsuba.integrators.layout import PathConfig
    from drmlt_mitsuba.integrators.mcmc import state_from_splats
    from drmlt_mitsuba.integrators.mmlt_grouped import (
        grouped_masks, make_mmlt_trace_fixed,
    )
    from drmlt_mitsuba.integrators.path import trace_paths
    from drmlt_mitsuba.ops.intersect import INF, _tri_sweep
    from drmlt_mitsuba.render import film as filmlib
    from drmlt_mitsuba.scene.builders import cornell_box
    from drmlt_mitsuba.scene.xml import load_scene_xml

    R = SIZES["rays"]
    key = jax.random.PRNGKey(5)
    o = jax.random.uniform(key, (R, 3)) * 500.0 + 25.0
    d = jax.random.normal(jax.random.fold_in(key, 1), (R, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    t_max = jnp.full((R,), INF)
    small = cornell_box(256, 256)
    large, _ = load_scene_xml(LARGE)
    with Phase(clock, "timing: intersection (TRI_CHUNK)"):
        for label, sc in (("cornell", small), ("large", large)):
            for chunk in (256, 1024, 4096):
                f = jax.jit(lambda o, d, sc=sc, chunk=chunk: _tri_sweep(
                    sc.tris, o, d, t_max, True, chunk=chunk)[0])
                dt = _timed(f, o, d)
                say(f"  closest-hit sweep {label} "
                    f"({int(sc.tris.v0.shape[0])} tris), {R} rays, chunk "
                    f"{chunk}: {dt * 1e3:.3f} ms")

    with Phase(clock, "timing: trace and splat"):
        pcfg = PathConfig(max_depth=6, rr_depth=100)
        u = jax.random.uniform(key, (R, pcfg.n_dims))
        f = jax.jit(lambda u: trace_paths(small, pcfg, u).value)
        say(f"  trace_paths depth 6, {R} paths: "
            f"{_timed(f, u) * 1e3:.3f} ms")
        trace_k, cfg_k, n_dims = make_mmlt_trace_fixed(small, 2)
        uk = jax.random.uniform(key, (R, n_dims))
        f = jax.jit(lambda u: trace_k(u).value)
        say(f"  grouped MMLT trace depth 2, {R} paths: "
            f"{_timed(f, uk) * 1e3:.3f} ms")
        fc = filmlib.make_film_config(256, 256, "box")
        pos = jax.random.uniform(key, (3 * R, 2)) * 256.0
        val = jax.random.uniform(key, (3 * R, 3))
        w = jax.random.uniform(key, (3 * R,))
        f = jax.jit(lambda film, p, v, w: filmlib.splat(fc, film, p, v, w))
        say(f"  film splat of {3 * R} weighted splats into 256x256: "
            f"{_timed(f, filmlib.new_film(fc), pos, val, w) * 1e3:.3f} ms")

    with Phase(clock, "timing: whole mutation (fuse_traces)"):
        frozen = grouped_masks(cfg_k, n_dims)
        start = jax.jit(lambda u: state_from_splats(u, trace_k(u)))
        for chains in (7168, R):
            state = start(jax.random.uniform(key, (chains, n_dims)))
            for fuse in (True, False):
                dcfg = DRMLTConfig(type="orbital", n_chains=chains,
                                   fuse_traces=fuse)

                @jax.jit
                def run(state, film, dcfg=dcfg):
                    def body(c, i):
                        return drmlt_step(trace_k, dcfg, fc, frozen, c,
                                          jax.random.fold_in(key, i))
                    return jax.lax.scan(body, (state, film, None),
                                        jnp.arange(SIZES["steps"]))[0][1]

                dt = _timed(run, state, filmlib.new_film(fc), n=3)
                say(f"  drmlt_step orbital, grouped MMLT depth 2, {chains} "
                    f"chains, fuse_traces={fuse}: "
                    f"{dt / SIZES['steps'] * 1e3:.3f} ms/mutation step, "
                    f"{chains * SIZES['steps'] / dt:.4g} mutations/s")


def phase_four(clock) -> None:
    """Chain-sharded renders on every visible GPU against the same render
    on one GPU."""
    import jax

    from drmlt_mitsuba.integrators.bidir import BDPTConfig
    from drmlt_mitsuba.integrators.drmlt import DRMLTConfig
    from drmlt_mitsuba.integrators.mmlt_grouped import (
        render_drmlt_mmlt_grouped_sharded,
    )
    from drmlt_mitsuba.parallel.mesh import make_mesh
    from drmlt_mitsuba.render import film as filmlib
    from drmlt_mitsuba.scene.xml import load_scene_xml

    n, chains, spp = SIZES["four_film"], SIZES["chains"], SIZES["four_spp"]
    depth = SIZES["four_depth"]
    n_dev = len(jax.devices())
    check(n_dev == 4, f"--four needs 4 devices, found {n_dev}")
    base = [CORNELL, "-D", "integrator=drmlt", "-D", "technique=mmlt",
            "-D", "type=orbital", "-D", f"luminanceSamples={SIZES['boot']}",
            "-D", f"maxDepth={depth}", "--chains", str(chains),
            "--spp", str(spp)] + _film_args(n)
    with Phase(clock, "four: one-card grouped render (cli)"):
        one = _cli(base + ["-q"])
    with Phase(clock, "four: cli --shard"):
        sharded = _cli(base + ["--shard"])
    rel = _rel(sharded.mean(), one.mean())
    say(f"  cli --shard over {n_dev} GPUs: mean {sharded.mean():.6f} vs one "
        f"card {one.mean():.6f}: rel {rel:.4f} (<= {MCMC_MEAN_RTOL})")
    check(np.isfinite(sharded).all() and rel <= MCMC_MEAN_RTOL,
          "cli --shard vs one card")

    mesh = make_mesh()
    with Phase(clock, "four: grouped sharded"):
        scene, settings = load_scene_xml(CORNELL, {"width": str(n),
                                                   "height": str(n),
                                                   "maxDepth": str(depth)})
        fc = filmlib.make_film_config(n, n, settings.filter_name)
        img, aux = render_drmlt_mmlt_grouped_sharded(
            mesh, scene, BDPTConfig(max_depth=depth),
            DRMLTConfig(type="orbital", n_chains=chains,
                        n_bootstrap=SIZES["boot"]),
            fc, jax.random.PRNGKey(0), n * n * spp // chains)
        img = np.asarray(img)
    rel = _rel(img.mean(), one.mean())
    say(f"  grouped sharded on mesh {dict(mesh.shape)}: mean "
        f"{img.mean():.6f} vs one card {one.mean():.6f}: rel {rel:.4f} "
        f"(<= {MCMC_MEAN_RTOL})")
    for k, state in aux["states"].items():
        shards = [(str(s.device), tuple(s.data.shape))
                  for s in state.u.addressable_shards]
        say(f"  depth group {k} chain state addressable_shards: {shards}")
        check(len({d for d, _ in shards}) == n_dev
              and all(shape[0] == chains // n_dev for _, shape in shards),
              "one chain shard per device")
    check(np.isfinite(img).all() and rel <= MCMC_MEAN_RTOL,
          "grouped sharded vs one card")


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the chain-sharded phase, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's default device is {dev.platform})",
              file=sys.stderr)
        return 1
    from drmlt_mitsuba.core.cache import enable_compile_cache
    from drmlt_mitsuba.utils.native import build_native, native_path

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    say(f"card: {card.stdout.strip().splitlines()[0]}")
    say(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")
    clock = CompileClock()

    if args.four:
        phase_four(clock)
    else:
        # cpu_oracle compiles on the host CPU while the GPU phases run
        make = subprocess.Popen(["make", "-C", native_path(""),
                                 "cpu_oracle"], stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)

        def build():
            if make.wait(timeout=600) != 0:
                build_native("cpu_oracle")     # raises with make's output

        try:
            with Phase(clock, "1 device check"):
                say(f"  default device: {dev.platform} {dev.device_kind}")
            with Phase(clock, "2 render_pt gpu vs cpu"):
                phase_gpu_vs_cpu()
            ref_mean = phase_pt_reference(clock)
            phase_mcmc(clock, "3 flagship drmlt mmlt (cli)", "mmlt", ref_mean)
            phase_mcmc(clock, "4 drmlt path technique (cli)", "path",
                       ref_mean)
            phase_large_vs_oracle(clock, build)
            with Phase(clock, "6 gradient vs finite difference"):
                phase_gradient()
            phase_timings(clock)
        finally:
            if make.poll() is None:
                make.kill()
                make.wait()

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
