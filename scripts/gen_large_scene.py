"""Generate the asset-scale bench scene (VERDICT r4 item 7): the
tessellated cornell (19.6k tris) exported as real OBJ meshes + a
mitsuba-format XML, so the large-scene benchmark exercises the full
XML loader -> mesh IO -> clustered-kernel path end-to-end, not just the
procedural builder.  The geometry is IDENTICAL to
cornell_box(tessellate=24), so the cpu_oracle anchors measured on the
builder scene transfer.

    python scripts/gen_large_scene.py   # writes tests/data/large/*
"""
import os

import numpy as np


def write_obj(path, v0, e1, e2, n0, n1, n2):
    verts, faces, norms = [], [], []
    for i in range(len(v0)):
        a = v0[i]
        b = v0[i] + e1[i]
        c = v0[i] + e2[i]
        base = len(verts)
        verts += [a, b, c]
        norms += [n0[i], n1[i], n2[i]]
        faces.append((base + 1, base + 2, base + 3))
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for n in norms:
            f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for a, b, c in faces:
            f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from drmlt_mitsuba.scene.builders import cornell_box

    sc = cornell_box(256, 256, tessellate=24)
    v0 = np.asarray(sc.tris.v0)
    e1 = np.asarray(sc.tris.e1)
    e2 = np.asarray(sc.tris.e2)
    n0 = np.asarray(sc.tris.n0)
    n1 = np.asarray(sc.tris.n1)
    n2 = np.asarray(sc.tris.n2)
    mat = np.asarray(sc.tris.mat_id)
    emit = np.asarray(sc.tris.emitter_id)
    out = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                       "large")
    os.makedirs(out, exist_ok=True)
    groups = {
        "white": (mat == 0) | (mat == 4),     # walls/boxes share diffuse
        "red": mat == 1,
        "green": mat == 2,
        "light": emit >= 0,
    }
    groups["white"] &= emit < 0
    groups["red"] &= emit < 0
    groups["green"] &= emit < 0
    for name, m in groups.items():
        write_obj(os.path.join(out, f"{name}.obj"),
                  v0[m], e1[m], e2[m], n0[m], n1[m], n2[m])
        print(name, int(m.sum()), "tris")


if __name__ == "__main__":
    main()
