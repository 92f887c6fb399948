"""Ray-throughput benchmark (ref: the 10M-ray bunny benchmark in
src/tests/test_kd.cpp:86-133 and the `kdbench` utility) — prints MRays/s
for the triangle sweep on a procedurally tessellated mesh.

    python -m drmlt_mitsuba.utils.raybench --tris 20000 --rays 1048576
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="drmlt-raybench")
    ap.add_argument("--tris", type=int, default=20000)
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from drmlt_mitsuba.ops.intersect import intersect
    from drmlt_mitsuba.scene import types as st

    rng = np.random.default_rng(0)
    T = args.tris
    # a bumpy sphere shell (structured like a real mesh, not a soup)
    nu = max(8, int(np.sqrt(T / 2)))
    th = np.linspace(1e-3, np.pi - 1e-3, nu)
    ph = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.1 * np.sin(5 * TH) * np.cos(7 * PH)
    V = np.stack([r * np.sin(TH) * np.cos(PH), r * np.sin(TH) * np.sin(PH),
                  r * np.cos(TH)], -1).reshape(-1, 3).astype(np.float32)
    F = []
    for i in range(nu - 1):
        for j in range(nu):
            a, b = i * nu + j, i * nu + (j + 1) % nu
            c, d = (i + 1) * nu + j, (i + 1) * nu + (j + 1) % nu
            F.append([a, b, d])
            F.append([a, d, c])
    F = np.asarray(F, np.int32)
    tris = st.build_triangles(V, F, np.zeros(len(F), np.int32),
                              np.full(len(F), -1, np.int32))
    scene = st.Scene(
        tris=tris, spheres=st.empty_spheres(),
        materials=st.make_material_table([dict(kind=st.BSDF_DIFFUSE)]),
        emitters=st.build_emitters(tris, np.zeros((1, 3), np.float32)),
        camera=st.make_camera(jnp.eye(4), 60.0, 1.0),
    )

    R = args.rays
    key = jax.random.PRNGKey(0)
    o = jnp.asarray(rng.uniform(-3, 3, (R, 3)).astype(np.float32))
    d = jax.random.normal(key, (R, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    f = jax.jit(lambda o, d: intersect(scene, o, d).t)
    t = f(o, d)
    t.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        t = f(o, d)
    t.block_until_ready()
    dt = (time.perf_counter() - t0) / args.iters
    mrays = R / dt / 1e6
    print(f"{len(F)} tris, {R} rays on {jax.devices()[0].device_kind}: "
          f"{dt * 1e3:.2f} ms -> {mrays:.1f} MRays/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
