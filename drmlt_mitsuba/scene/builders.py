"""Procedural test scenes.

The reference's parity scenes (Cornell variants, veach-door) ship as external
zips; these builders reproduce the standard constructions procedurally so the
test-suite and benchmarks are self-contained.
"""
from __future__ import annotations

import numpy as np

from drmlt_mitsuba.core import transform
from drmlt_mitsuba.scene import types as st


def _quad(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (ccw)."""
    return [p0, p1, p2], [p0, p2, p3]


def _box(pmin, pmax):
    """12 triangles of an axis-aligned box, normals outward."""
    x0, y0, z0 = pmin
    x1, y1, z1 = pmax
    quads = [
        # floor (y0, normal -y -> outward = down; we want inward-facing walls
        # for the cornell box so callers choose winding via this order)
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),  # bottom
        ([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0]),  # top
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),  # back(+z)
        ([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0]),  # front(-z)
        ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),  # left
        ([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1]),  # right
    ]
    tris = []
    for q in quads:
        tris.extend(_quad(*q))
    return tris


def _tessellate(tris, n):
    """Subdivide each triangle into n^2 congruent triangles (big-scene
    stress geometry: identical radiometry, n^2 x the triangle count)."""
    out = []
    for tri in tris:
        p0, p1, p2 = (np.asarray(v, np.float64) for v in tri)
        e1 = (p1 - p0) / n
        e2 = (p2 - p0) / n
        for i in range(n):
            for j in range(n - i):
                a = p0 + i * e1 + j * e2
                out.append([a, a + e1, a + e2])
                if i + j < n - 1:
                    out.append([a + e1, a + e1 + e2, a + e2])
    return out


def _rotate_y(pts, angle_deg, center):
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return (np.asarray(pts) - center) @ r.T + center


def cornell_box(
    width: int = 128,
    height: int = 128,
    light_radiance=(18.4, 15.6, 8.0),
    tall_box_material: str = "diffuse",
    sphere_material: str | None = None,
    tessellate: int = 1,
) -> st.Scene:
    """The classic Cornell box (dimensions after the CG-standard 556-unit
    box), camera on -z looking in.  tall_box_material picks the round-trip
    hard case: "diffuse" | "mirror" | "glass" | "roughconductor".
    sphere_material (same choices) adds an analytic sphere like the one in
    tests/data/cornell.xml (center 400,90,300 radius 90) for shape-mix
    coverage.
    """
    verts: list = []
    faces: list = []
    mat_ids: list = []
    emit_ids: list = []

    def add_tri(tri, mat, emit=-1):
        # emitters stay untessellated (the emitter TABLE is row-per-tri;
        # big-scene stress only needs geometry count, not light rows)
        tess = tessellate if (tessellate > 1 and emit < 0) else 1
        for t in (_tessellate([tri], tess) if tess > 1 else [tri]):
            base = len(verts)
            verts.extend(t)
            faces.append([base, base + 1, base + 2])
            mat_ids.append(mat)
            emit_ids.append(emit)

    white, red, green, light_m, tall_m = 0, 1, 2, 3, 4

    s = 556.0
    # floor
    for t in _quad([0, 0, 0], [0, 0, s], [s, 0, s], [s, 0, 0]):
        add_tri(t, white)
    # ceiling
    for t in _quad([0, s, 0], [s, s, 0], [s, s, s], [0, s, s]):
        add_tri(t, white)
    # back wall
    for t in _quad([0, 0, s], [0, s, s], [s, s, s], [s, 0, s]):
        add_tri(t, white)
    # left wall (x=0) red
    for t in _quad([0, 0, 0], [0, s, 0], [0, s, s], [0, 0, s]):
        add_tri(t, red)
    # right wall (x=s) green
    for t in _quad([s, 0, 0], [s, 0, s], [s, s, s], [s, s, 0]):
        add_tri(t, green)

    # light: 130x105 patch slightly below ceiling, normal down (-y)
    lx0, lx1 = 213.0, 343.0
    lz0, lz1 = 227.0, 332.0
    ly = s - 0.5
    for t in _quad([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1], [lx0, ly, lz1]):
        add_tri(t, light_m, emit=0)

    # short box
    short = _box([0, 0, 0], [166, 165, 166])
    for t in short:
        add_tri(_rotate_y(t, -17.0, np.array([83, 0, 83])) + np.array([130, 0, 65]), white)
    # tall box
    tall = _box([0, 0, 0], [166, 330, 166])
    for t in tall:
        add_tri(_rotate_y(t, 107.0, np.array([83, 0, 83])) + np.array([265, 0, 296]), tall_m)

    tall_mats = {
        "diffuse": dict(kind=st.BSDF_DIFFUSE, albedo=(0.725, 0.71, 0.68)),
        "mirror": dict(kind=st.BSDF_MIRROR, albedo=(0.9, 0.9, 0.9)),
        "glass": dict(kind=st.BSDF_DIELECTRIC, eta=(1.5, 1.5, 1.5)),
        "roughconductor": dict(
            kind=st.BSDF_ROUGH_CONDUCTOR, roughness=0.15,
            eta=(0.2, 0.92, 1.1), k=(3.9, 2.45, 2.14),
        ),
        "roughglass": dict(kind=st.BSDF_ROUGH_DIELECTRIC,
                           eta=(1.5, 1.5, 1.5), roughness=0.2),
        "orennayar": dict(kind=st.BSDF_ROUGH_DIFFUSE,
                          albedo=(0.725, 0.71, 0.68), roughness=0.4),
        "phong": dict(kind=st.BSDF_PHONG, albedo=(0.4, 0.4, 0.4),
                      spec_refl=(0.4, 0.4, 0.4), roughness=0.25),
        "ward": dict(kind=st.BSDF_WARD, albedo=(0.3, 0.3, 0.3),
                     spec_refl=(0.5, 0.5, 0.5), roughness=0.2),
        "plastic": dict(kind=st.BSDF_PLASTIC, albedo=(0.6, 0.2, 0.2),
                        eta=(1.49, 1.49, 1.49)),
    }
    mats = [
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.725, 0.71, 0.68)),   # white
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.63, 0.065, 0.05)),   # red
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.14, 0.45, 0.091)),   # green
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.78, 0.78, 0.78)),    # light surf
        tall_mats[tall_box_material],                              # tall box
    ]
    if sphere_material is not None:
        mats.append(tall_mats[sphere_material])                    # sphere

    tris = st.build_triangles(
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(mat_ids, np.int32),
        np.asarray(emit_ids, np.int32),
    )
    emitters = st.build_emitters(tris, np.asarray([light_radiance], np.float32))
    # rewrite per-triangle emitter ids to emitter-table rows
    import jax.numpy as jnp

    area_rows = np.nonzero(np.asarray(emitters.kind) == 0)[0]
    row_of_tri = np.full(len(faces), -1, np.int32)
    row_of_tri[np.asarray(emitters.tri_idx)[area_rows]] = area_rows.astype(
        np.int32
    )
    tris = tris.replace(emitter_id=jnp.asarray(row_of_tri))

    cam = st.make_camera(
        transform.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]),
        fov_x_deg=39.3077,
        aspect=width / height,
    )
    if sphere_material is not None:
        import jax.numpy as jnp

        spheres = st.SphereSoA(
            center=jnp.asarray([[400.0, 90.0, 300.0]], jnp.float32),
            radius=jnp.asarray([90.0], jnp.float32),
            mat_id=jnp.asarray([len(mats) - 1], jnp.int32),
            emitter_id=jnp.asarray([-1], jnp.int32),
            valid=jnp.asarray([True]),
        )
    else:
        spheres = st.empty_spheres()
    return st.Scene(
        tris=tris,
        spheres=spheres,
        materials=st.make_material_table(mats),
        emitters=emitters,
        camera=cam,
    )


def pool_box(width: int = 64, height: int = 64,
             light_radiance=(60.0, 52.0, 30.0)) -> st.Scene:
    """Pool-caustic SDS torture scene (VERDICT r4 item 5): a cornell-
    style box with a horizontal GLASS SLAB (y in [100, 120]) spanning
    the whole interior.  The camera (y=278) and the ceiling light both
    sit above the slab, and the diffuse floor below it — so EVERY
    floor-transport path is E S S D S S L (specular-diffuse-specular,
    the domain of the reference's ManifoldPerturbation,
    mut_manifold.cpp:1476 / manifold.cpp:1324).  Walls above the slab
    give the chains easy non-SDS mass to mix through."""
    verts: list = []
    faces: list = []
    mat_ids: list = []
    emit_ids: list = []

    def add_tri(tri, mat, emit=-1):
        base = len(verts)
        verts.extend(tri)
        faces.append([base, base + 1, base + 2])
        mat_ids.append(mat)
        emit_ids.append(emit)

    white, red, green, light_m, glass = 0, 1, 2, 3, 4
    s = 556.0
    for t in _quad([0, 0, 0], [0, 0, s], [s, 0, s], [s, 0, 0]):
        add_tri(t, white)                                       # floor
    for t in _quad([0, s, 0], [s, s, 0], [s, s, s], [0, s, s]):
        add_tri(t, white)                                       # ceiling
    for t in _quad([0, 0, s], [0, s, s], [s, s, s], [s, 0, s]):
        add_tri(t, white)                                       # back
    for t in _quad([0, 0, 0], [0, s, 0], [0, s, s], [0, 0, s]):
        add_tri(t, red)                                         # left
    for t in _quad([s, 0, 0], [s, 0, s], [s, s, s], [s, s, 0]):
        add_tri(t, green)                                       # right
    lx0, lx1, lz0, lz1, ly = 213.0, 343.0, 227.0, 332.0, s - 0.5
    for t in _quad([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1],
                   [lx0, ly, lz1]):
        add_tri(t, light_m, emit=0)
    # glass slab: top face (normal +y) and bottom face (normal -y)
    y0, y1 = 100.0, 120.0
    for t in _quad([0, y1, 0], [0, y1, s], [s, y1, s], [s, y1, 0]):
        add_tri(t, glass)
    for t in _quad([0, y0, 0], [s, y0, 0], [s, y0, s], [0, y0, s]):
        add_tri(t, glass)

    mats = [
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.725, 0.71, 0.68)),
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.63, 0.065, 0.05)),
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.14, 0.45, 0.091)),
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.78, 0.78, 0.78)),
        dict(kind=st.BSDF_DIELECTRIC, eta=(1.5, 1.5, 1.5)),
    ]
    tris = st.build_triangles(
        np.asarray(verts, np.float32), np.asarray(faces, np.int32),
        np.asarray(mat_ids, np.int32), np.asarray(emit_ids, np.int32))
    emitters = st.build_emitters(
        tris, np.asarray([light_radiance], np.float32))
    import jax.numpy as jnp

    area_rows = np.nonzero(np.asarray(emitters.kind) == 0)[0]
    row_of_tri = np.full(len(faces), -1, np.int32)
    row_of_tri[np.asarray(emitters.tri_idx)[area_rows]] = (
        area_rows.astype(np.int32))
    tris = tris.replace(emitter_id=jnp.asarray(row_of_tri))
    cam = st.make_camera(
        transform.look_at([278, 278, -800], [278, 120, 0], [0, 1, 0]),
        fov_x_deg=39.3077, aspect=width / height)
    return st.Scene(tris=tris, spheres=st.empty_spheres(),
                    materials=st.make_material_table(mats),
                    emitters=emitters, camera=cam)


def furnace_sphere(albedo=0.8, env=1.0) -> st.Scene:
    """A diffuse sphere in a constant environment — the analytic 'furnace'
    oracle: every pixel converges to env (white furnace) when albedo
    summation is handled correctly."""
    tris = st.build_triangles(
        np.zeros((3, 3), np.float32) + np.array([[0, 0, 0], [1e-5, 0, 0], [0, 1e-5, 0]]),
        np.array([[0, 1, 2]], np.int32),
        np.zeros(1, np.int32),
        np.full(1, -1, np.int32),
    )
    import jax.numpy as jnp

    tris = tris.replace(valid=jnp.zeros(1, dtype=bool))
    spheres = st.SphereSoA(
        center=jnp.asarray([[0.0, 0.0, 3.0]], jnp.float32),
        radius=jnp.asarray([1.0], jnp.float32),
        mat_id=jnp.asarray([0], jnp.int32),
        emitter_id=jnp.asarray([-1], jnp.int32),
        valid=jnp.ones(1, dtype=bool),
    )
    emitters = st.build_emitters(tris, np.zeros((1, 3), np.float32),
                                 env_radiance=(env, env, env))
    mats = st.make_material_table(
        [dict(kind=st.BSDF_DIFFUSE, albedo=(albedo, albedo, albedo))]
    )
    cam = st.make_camera(
        transform.look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]), 60.0, 1.0
    )
    return st.Scene(tris=tris, spheres=spheres, materials=mats,
                    emitters=emitters, camera=cam)


def veach_door(
    width: int = 128,
    height: int = 128,
    door_angle_deg: float = 12.0,
    light_radiance=(60.0, 55.0, 45.0),
) -> st.Scene:
    """Procedural stand-in for the veach-door parity scene (README
    "Scenes"): two rooms joined by a slightly-open door, the light in the
    far room — the camera room is lit almost entirely through the door gap,
    the classic MLT/DRMLT stress case.
    """
    verts: list = []
    faces: list = []
    mat_ids: list = []
    emit_ids: list = []

    def add_tri(tri, mat, emit=-1):
        base = len(verts)
        verts.extend(tri)
        faces.append([base, base + 1, base + 2])
        mat_ids.append(mat)
        emit_ids.append(emit)

    def add_quad(p0, p1, p2, p3, mat, emit=-1):
        for t in _quad(p0, p1, p2, p3):
            add_tri(t, mat, emit)

    white, red, wood, light_m = 0, 1, 2, 3
    X, Y, Z = 10.0, 5.0, 10.0        # total footprint; divider at x=5
    dx = 5.0
    dz0, dz1 = 4.0, 6.0              # doorway span in z
    dh = 4.0                          # doorway height

    # outer shell (normals inward)
    add_quad([0, 0, 0], [0, 0, Z], [X, 0, Z], [X, 0, 0], white)        # floor
    add_quad([0, Y, 0], [X, Y, 0], [X, Y, Z], [0, Y, Z], white)        # ceil
    add_quad([0, 0, Z], [0, Y, Z], [X, Y, Z], [X, 0, Z], white)        # back
    add_quad([X, 0, 0], [X, Y, 0], [0, Y, 0], [0, 0, 0], white)        # front
    add_quad([0, 0, 0], [0, Y, 0], [0, Y, Z], [0, 0, Z], red)          # left
    add_quad([X, 0, 0], [X, 0, Z], [X, Y, Z], [X, Y, 0], white)        # right

    # divider wall at x=dx with doorway hole (two-sided white)
    def divider(z0, z1, y0, y1):
        add_quad([dx, y0, z0], [dx, y1, z0], [dx, y1, z1], [dx, y0, z1],
                 white)

    divider(0.0, dz0, 0.0, Y)        # solid section z<doorway
    divider(dz1, Z, 0.0, Y)          # solid section z>doorway
    divider(dz0, dz1, dh, Y)         # lintel above the door

    # door panel: hinge at (dx, *, dz0), swings into room A
    a = np.deg2rad(door_angle_deg)
    dirv = np.array([-np.sin(a), 0.0, np.cos(a)])
    p0 = np.array([dx, 0.0, dz0])
    p1 = p0 + dirv * (dz1 - dz0)
    add_quad(list(p0), list(p0 + [0, dh, 0]),
             list(p1 + [0, dh, 0]), list(p1), wood)
    add_quad(list(p1), list(p1 + [0, dh, 0]),
             list(p0 + [0, dh, 0]), list(p0), wood)

    # light panel on the far-room ceiling
    lx0, lx1, lz0, lz1 = 7.0, 8.5, 4.0, 6.0
    ly = Y - 0.01
    add_quad([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1], [lx0, ly, lz1],
             light_m, emit=0)

    mats = [
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.73, 0.71, 0.68)),
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.61, 0.10, 0.08)),
        dict(kind=st.BSDF_ROUGH_DIFFUSE, albedo=(0.44, 0.27, 0.14),
             roughness=0.35),
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.78, 0.78, 0.78)),
    ]
    tris = st.build_triangles(
        np.asarray(verts, np.float32), np.asarray(faces, np.int32),
        np.asarray(mat_ids, np.int32), np.asarray(emit_ids, np.int32),
    )
    emitters = st.build_emitters(tris, np.asarray([light_radiance],
                                                  np.float32))
    import jax.numpy as jnp

    area_rows = np.nonzero(np.asarray(emitters.kind) == 0)[0]
    row_of_tri = np.full(len(faces), -1, np.int32)
    row_of_tri[np.asarray(emitters.tri_idx)[area_rows]] = area_rows.astype(
        np.int32
    )
    tris = tris.replace(emitter_id=jnp.asarray(row_of_tri))

    cam = st.make_camera(
        transform.look_at([1.2, 2.2, 1.5], [dx, 2.0, dz0 + 1.0],
                          [0, 1, 0]),
        fov_x_deg=55.0, aspect=width / height,
    )
    return st.Scene(
        tris=tris, spheres=st.empty_spheres(),
        materials=st.make_material_table(mats),
        emitters=emitters, camera=cam,
    )
