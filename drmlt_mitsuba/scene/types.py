"""Flat SoA scene representation (device-resident pytrees).

The reference keeps a refcounted object graph (Scene -> Shape -> BSDF ...,
include/mitsuba/render/scene.h) and dispatches virtually per ray.  Here the
whole scene lives in device memory as structure-of-arrays; per-lane "virtual dispatch"
becomes branchless evaluate-and-select over small enum tables.  Everything
here is a registered pytree so scenes pass straight through jit/vmap/shard.

Capability mapping (SURVEY.md §2.6):
  shapes obj/ply/rect/cube/sphere -> TriangleSoA + SphereSoA
  bsdf plugins                    -> MaterialTable (kind enum + params)
  area/point/constant emitters    -> EmitterTable + env/point fields
  perspective/thinlens sensor     -> Camera
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.core import struct

# BSDF kind enum (MaterialTable.kind)
BSDF_DIFFUSE = 0
BSDF_CONDUCTOR = 1       # smooth, delta
BSDF_DIELECTRIC = 2      # smooth, delta (reflect+refract)
BSDF_ROUGH_CONDUCTOR = 3  # GGX microfacet
BSDF_PLASTIC = 4          # smooth dielectric coat over diffuse
BSDF_ROUGH_PLASTIC = 5
BSDF_THIN_DIELECTRIC = 6
BSDF_ROUGH_DIELECTRIC = 7
BSDF_MIRROR = 8           # ideal mirror (conductor with F=reflectance)
BSDF_NULL = 9             # passthrough
BSDF_PHONG = 10
BSDF_WARD = 11
BSDF_ROUGH_DIFFUSE = 12   # Oren-Nayar
BSDF_DIFFTRANS = 13       # diffuse transmitter (ref: src/bsdfs/difftrans.cpp)
BSDF_HK = 14              # Hanrahan-Krueger single-scattering slab
BSDF_IRAWAN = 15          # Irawan woven cloth (render/irawan.py)
#                           (ref: src/bsdfs/hk.cpp); field mapping:
#                           spec_refl=sigmaS, spec_trans=sigmaA,
#                           roughness=thickness, k[0]=phase g

DELTA_BSDFS = (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_MIRROR, BSDF_NULL,
               BSDF_THIN_DIELECTRIC)


@struct.dataclass
class TriangleSoA:
    """Triangle soup: p = v0 + b1*e1 + b2*e2."""
    v0: jnp.ndarray      # (T, 3)
    e1: jnp.ndarray      # (T, 3)
    e2: jnp.ndarray      # (T, 3)
    n0: jnp.ndarray      # (T, 3) per-vertex shading normals
    n1: jnp.ndarray      # (T, 3)
    n2: jnp.ndarray      # (T, 3)
    uv0: jnp.ndarray     # (T, 2) texture coords
    uv1: jnp.ndarray     # (T, 2)
    uv2: jnp.ndarray     # (T, 2)
    mat_id: jnp.ndarray  # (T,) int32
    emitter_id: jnp.ndarray  # (T,) int32, -1 = not emissive
    valid: jnp.ndarray   # (T,) bool — False for padding triangles


@struct.dataclass
class SphereSoA:
    center: jnp.ndarray   # (S, 3)
    radius: jnp.ndarray   # (S,)
    mat_id: jnp.ndarray   # (S,) int32
    emitter_id: jnp.ndarray  # (S,) int32
    valid: jnp.ndarray    # (S,) bool


@struct.dataclass
class MaterialTable:
    kind: jnp.ndarray        # (M,) int32 enum above
    albedo: jnp.ndarray      # (M, 3) diffuse reflectance / specular tint
    eta: jnp.ndarray         # (M, 3) real IOR (dielectric: channel 0)
    k: jnp.ndarray           # (M, 3) imaginary IOR (conductors)
    roughness: jnp.ndarray   # (M,) GGX alpha
    spec_refl: jnp.ndarray   # (M, 3) specular reflectance scale
    spec_trans: jnp.ndarray  # (M, 3) specular transmittance scale
    tex_id: jnp.ndarray      # (M,) int32, -1 = constant albedo
    two_sided: jnp.ndarray   # (M,) bool
    # ---- modifier wrappers (ref: src/bsdfs/{mask,mixturebsdf,blendbsdf,
    # coating}.cpp).  Defaults are identity; the static has_* flags let
    # scenes without modifiers compile zero extra code. ----
    # mask: opacity o — f = o * f_nested plus a (1-o) null passthrough lobe
    opacity: jnp.ndarray | None = None       # (M, 3), None = all opaque
    # 2-component mixture: this row's BSDF with weight (1-w), `mix_other`
    # row's with weight w (mixturebsdf/blendbsdf flattened to 2 lobes)
    mix_other: jnp.ndarray | None = None     # (M,) int32, -1 = no mixture
    mix_weight: jnp.ndarray | None = None    # (M,)
    # smooth dielectric coating layer over the nested BSDF
    coat_eta: jnp.ndarray | None = None      # (M,), 0 = uncoated
    coat_sigma_a: jnp.ndarray | None = None  # (M, 3) absorption * thickness
    # per-shape interior medium: row into Scene.media, -1 = none.  A
    # transmissive crossing of a material with a row >= 0 switches the
    # lane's current medium (entering -> row, exiting -> exterior).
    interior_medium: jnp.ndarray | None = None   # (M,) int32
    # tangent-space normal map page (bumpmaps are baked to normal maps at
    # load; ref: src/bsdfs/{bumpmap,normalmap}.cpp); -1 = unperturbed
    normal_tex_id: jnp.ndarray | None = None     # (M,) int32
    # static set of kinds present — lets the BSDF kernels skip absent lobes
    # at compile time (the SPMD answer to per-plugin virtual dispatch)
    kinds_present: tuple = struct.field(pytree_node=False, default=())
    has_mask: bool = struct.field(pytree_node=False, default=False)
    has_normalmap: bool = struct.field(pytree_node=False, default=False)
    has_mixture: bool = struct.field(pytree_node=False, default=False)
    has_coating: bool = struct.field(pytree_node=False, default=False)
    # longest mix_other chain (N-way mixtures are chains of 2-way links);
    # static so eval/sample unroll exactly this many levels
    mix_depth: int = struct.field(pytree_node=False, default=0)


@struct.dataclass
class TextureAtlas:
    """Bitmap textures packed into one fixed-size atlas page per scene.

    data is (N, H, W, 3); lookups are bilinear.  Constant textures do not
    occupy a page (tex_id = -1).
    """
    data: jnp.ndarray        # (N, H, W, 3) float32


# emitter row kinds
EMITTER_AREA = 0
EMITTER_POINT = 1        # position delta, intensity I (W/sr)
EMITTER_DIRECTIONAL = 2  # direction delta, irradiance E
EMITTER_SPOT = 3         # point + cone falloff
EMITTER_ENV = 4          # image environment map (lat-long)
EMITTER_COLLIMATED = 5   # position AND direction delta beam (power W)


@struct.dataclass
class EmitterTable:
    """Unified emitter rows: area triangles, point/spot lights, directional
    sources, plus a constant environment.  The sampling pmf is proportional
    to power, matching Scene::sampleEmitterDirect behavior
    (src/librender/scene.cpp).  Delta rows (point/spot/directional) have
    discrete pick pdfs and never receive BSDF-sampling MIS competition."""
    kind: jnp.ndarray       # (E,) int32 row kind
    tri_idx: jnp.ndarray    # (E,) int32 triangle (area rows)
    radiance: jnp.ndarray   # (E, 3) radiance / intensity / irradiance
    area: jnp.ndarray       # (E,) triangle area (area rows)
    pos: jnp.ndarray        # (E, 3) position (point/spot) or direction
    #                          TOWARD the scene (directional)
    aux: jnp.ndarray        # (E, 4) spot: axis xyz + cos(cutoff)
    pmf: jnp.ndarray        # (E,) selection pmf
    cdf: jnp.ndarray        # (E,) inclusive cdf for categorical sampling
    # constant environment emitter (zeros = none)
    env_radiance: jnp.ndarray    # (3,)
    # image environment map (lat-long, Mitsuba Y-up); None = constant only
    env_image: jnp.ndarray | None = None      # (He, We, 3)
    env_row_cdf: jnp.ndarray | None = None    # (He,) marginal row cdf
    env_col_cdf: jnp.ndarray | None = None    # (He, We) conditional cdf
    env_pmf: jnp.ndarray | None = None        # (He, We) pixel pmf


CAMERA_PERSPECTIVE = 0
CAMERA_ORTHOGRAPHIC = 1
CAMERA_SPHERICAL = 2
CAMERA_RADIANCEMETER = 3   # single-direction probe
CAMERA_TELECENTRIC = 4     # orthographic with finite aperture (DOF)
CAMERA_FLUENCEMETER = 5    # uniform-sphere probe at a point
CAMERA_IRRADIANCEMETER = 6  # cosine-hemisphere probe (surface irradiance)


@struct.dataclass
class Camera:
    """Perspective / thinlens / orthographic / spherical sensor (ref:
    src/sensors/).  aperture_radius == 0 -> pinhole perspective; for the
    orthographic camera tan_half_fov_* carry the half-extents."""
    to_world: jnp.ndarray        # (4, 4)
    tan_half_fov_x: jnp.ndarray  # scalar
    tan_half_fov_y: jnp.ndarray  # scalar
    aperture_radius: jnp.ndarray  # scalar
    focus_distance: jnp.ndarray   # scalar
    kind: int = struct.field(pytree_node=False, default=0)
    # radial distortion (ref: src/sensors/perspective_rdist.cpp): film
    # coords are DISTORTED plane coords p_d = p_u * (1 + kc0 r^2 + kc1
    # r^4); rdist is static so undistorted scenes compile no inversion
    kc: jnp.ndarray | None = None  # (2,)
    rdist: bool = struct.field(pytree_node=False, default=False)


@struct.dataclass
class BVH:
    """Flattened 2-wide BVH in depth-first layout (built on host, scene/bvh.py).

    nodes_min/max: (N, 3) AABBs.  For leaf nodes, `left` is the first
    triangle index (into the BVH-reordered triangle arrays) and `count` > 0;
    for inner nodes `count` == 0 and `left`/`right` are child node indices.
    `skip` is the escape pointer for stackless traversal.
    """
    nodes_min: jnp.ndarray  # (N, 3)
    nodes_max: jnp.ndarray  # (N, 3)
    first: jnp.ndarray      # (N,) int32 first prim (leaf) or left child
    count: jnp.ndarray      # (N,) int32 prim count (0 = inner)
    skip: jnp.ndarray       # (N,) int32 escape-pointer node index (stackless)


@struct.dataclass
class TriangleMotion:
    """Linear per-triangle motion over the shutter interval (ref:
    src/shapes/deformable.cpp keyframe interpolation + the sensor's
    shutterOpen/shutterClose, include/mitsuba/render/sensor.h:202).

    Deltas are keyframe(shutter_close) - keyframe(shutter_open) in the
    SAME SoA layout as TriangleSoA, so geometry at normalized path time
    t in [0,1] is v0 + t*dv0 etc.  Static meshes carry zero deltas; the
    table exists only when some shape actually moves (presence is
    static — trace functions specialize, zero cost when None)."""
    dv0: jnp.ndarray     # (T, 3)
    de1: jnp.ndarray     # (T, 3)
    de2: jnp.ndarray     # (T, 3)
    dn0: jnp.ndarray     # (T, 3) shading-normal deltas (renormalized at t)
    dn1: jnp.ndarray     # (T, 3)
    dn2: jnp.ndarray     # (T, 3)


@struct.dataclass
class Scene:
    tris: TriangleSoA
    spheres: SphereSoA
    materials: MaterialTable
    emitters: EmitterTable
    camera: Camera
    bvh: BVH | None = None
    textures: TextureAtlas | None = None
    # global homogeneous participating medium (render/medium.py);
    # None = vacuum. Presence is static: trace functions specialize.
    medium: object | None = None
    # per-shape interior media (ref: shapes carry interior/exterior medium
    # refs, src/librender/scene.cpp).  Rows are referenced by
    # MaterialTable.interior_medium; lane-tracked medium id -1 = exterior
    # (the global `medium` above, or vacuum).  Presence is static.
    media: "MediumTable | None" = None
    # woven-cloth weave pattern shared by all BSDF_IRAWAN materials
    # (render/irawan.py IrawanPattern; ref: src/bsdfs/irawan.cpp).
    # Presence is static: trace functions specialize on it.
    irawan: object | None = None
    # (T, 3, 3) per-corner vertex colors for the vertexcolors texture
    # (materials with tex_id == -2; ref: src/textures/vertexcolors.cpp)
    vcolors: jnp.ndarray | None = None
    # linear triangle motion over the shutter (TriangleMotion above);
    # None = static scene (the common case, zero cost).  Motion scenes
    # intersect with a per-ray keyframe lerp in the triangle sweep.
    motion: TriangleMotion | None = None
    # dipole BSSRDF instances (render/subsurface.py DipoleTable, one per
    # <subsurface> declaration).  Presence is static; attached by
    # prepare_dipole after scene construction (needs visibility queries).
    subsurface: tuple | None = None


@struct.dataclass
class MediumTable:
    """Homogeneous interior media as SoA rows.

    The lane-parallel volpath gathers a row per path (current-medium id)
    instead of dispatching to per-shape Medium objects.  Per-row phase
    kinds (HG/Rayleigh/kkay/microflake) evaluate branchlessly over the
    statically-present kind set, like the BSDF table."""
    sigma_t: jnp.ndarray   # (K, 3) extinction
    albedo: jnp.ndarray    # (K, 3) single-scattering albedo
    g: jnp.ndarray         # (K,) HG asymmetry
    phase_kind: jnp.ndarray | None = None  # (K,) int32 (medium.PHASE_*)
    fiber: jnp.ndarray | None = None       # (K, 3) orientation
    ph_a: jnp.ndarray | None = None        # (K, 4) kkay [ks,kd,exp,norm]
    #   or sggx [stddev,0,0,0]
    kinds_present: tuple = struct.field(pytree_node=False, default=(0,))


def make_medium_table(rows: list[dict]) -> "MediumTable":
    kinds = [int(r.get("phase_kind", 0)) for r in rows]
    return MediumTable(
        sigma_t=jnp.asarray(
            np.stack([np.broadcast_to(np.asarray(r["sigma_t"], np.float32),
                                      (3,)) for r in rows])),
        albedo=jnp.asarray(
            np.stack([np.broadcast_to(np.asarray(r["albedo"], np.float32),
                                      (3,)) for r in rows])),
        g=jnp.asarray(np.asarray([float(r.get("g", 0.0)) for r in rows],
                                 np.float32)),
        phase_kind=jnp.asarray(kinds, jnp.int32),
        fiber=jnp.asarray(
            np.stack([np.asarray(r.get("fiber", (0.0, 0.0, 1.0)),
                                 np.float32) for r in rows])),
        ph_a=jnp.asarray(
            np.stack([np.asarray(r.get("ph_a", (0.0,) * 4), np.float32)
                      for r in rows])),
        kinds_present=tuple(sorted(set(kinds))),
    )


def make_material_table(mats: list[dict]) -> MaterialTable:
    """Build a MaterialTable from a list of parameter dicts (host-side)."""
    m = len(mats)

    def field(name, default, shape):
        out = np.zeros((m,) + shape, dtype=np.float32)
        for i, d in enumerate(mats):
            v = d.get(name, default)
            out[i] = np.broadcast_to(np.asarray(v, np.float32), shape)
        return out

    kind = np.array([d["kind"] for d in mats], dtype=np.int32)
    tex_id = np.array([d.get("tex_id", -1) for d in mats], dtype=np.int32)
    two_sided = np.array([bool(d.get("two_sided", True)) for d in mats])
    has_mask = any("opacity" in d for d in mats)
    has_mixture = any(d.get("mix_other", -1) >= 0 for d in mats)
    has_coating = any(d.get("coat_eta", 0.0) > 0 for d in mats)
    mix_other = np.array([d.get("mix_other", -1) for d in mats],
                         dtype=np.int32)
    M = len(mats)
    depth = np.zeros(M, np.int64)
    for _ in range(M):   # fixed-point; chains are acyclic and short
        nxt = np.where(mix_other >= 0,
                       depth[np.clip(mix_other, 0, M - 1)] + 1, 0)
        if np.array_equal(nxt, depth):
            break
        depth = nxt
    fields = dict(
        kind=jnp.asarray(kind),
        kinds_present=tuple(sorted(set(int(k) for k in kind))),
        albedo=jnp.asarray(field("albedo", 0.5, (3,))),
        eta=jnp.asarray(field("eta", 1.5, (3,))),
        k=jnp.asarray(field("k", 0.0, (3,))),
        roughness=jnp.asarray(field("roughness", 0.1, ())),
        spec_refl=jnp.asarray(field("spec_refl", 1.0, (3,))),
        spec_trans=jnp.asarray(field("spec_trans", 1.0, (3,))),
        tex_id=jnp.asarray(tex_id),
        two_sided=jnp.asarray(two_sided),
        has_mask=has_mask,
        has_mixture=has_mixture,
        has_coating=has_coating,
        mix_depth=int(depth.max()),
        opacity=jnp.asarray(field("opacity", 1.0, (3,))) if has_mask
        else None,
        mix_other=jnp.asarray(mix_other) if has_mixture else None,
        mix_weight=jnp.asarray(field("mix_weight", 0.0, ()))
        if has_mixture else None,
        coat_eta=jnp.asarray(field("coat_eta", 0.0, ())) if has_coating
        else None,
        coat_sigma_a=jnp.asarray(field("coat_sigma_a", 0.0, (3,)))
        if has_coating else None,
        interior_medium=jnp.asarray(
            np.array([d.get("interior_medium", -1) for d in mats], np.int32)
        ) if any(d.get("interior_medium", -1) >= 0 for d in mats) else None,
        has_normalmap=any(d.get("normal_tex", -1) >= 0 for d in mats),
        normal_tex_id=jnp.asarray(
            np.array([d.get("normal_tex", -1) for d in mats], np.int32)
        ) if any(d.get("normal_tex", -1) >= 0 for d in mats) else None,
    )
    return MaterialTable(**fields)


def build_motion(tris0: TriangleSoA, tris1: TriangleSoA) -> TriangleMotion:
    """Per-triangle linear motion deltas from two keyframe SoAs (same
    topology).  Moving emissive triangles are rejected: NEE samples
    emitter geometry without a time argument, so a moving light would
    break MIS consistency (document-first constraint; the reference's
    deformable scenes don't animate lights either)."""
    dv0 = np.asarray(tris1.v0) - np.asarray(tris0.v0)
    moving_rows = np.abs(dv0).max(-1) > 0
    emitting = np.asarray(tris0.emitter_id) >= 0
    if bool((moving_rows & emitting).any()):
        raise ValueError("moving emissive triangles are not supported "
                         "(NEE samples lights at shutter open)")
    return TriangleMotion(
        dv0=jnp.asarray(dv0, jnp.float32),
        de1=jnp.asarray(np.asarray(tris1.e1) - np.asarray(tris0.e1),
                        jnp.float32),
        de2=jnp.asarray(np.asarray(tris1.e2) - np.asarray(tris0.e2),
                        jnp.float32),
        dn0=jnp.asarray(np.asarray(tris1.n0) - np.asarray(tris0.n0),
                        jnp.float32),
        dn1=jnp.asarray(np.asarray(tris1.n1) - np.asarray(tris0.n1),
                        jnp.float32),
        dn2=jnp.asarray(np.asarray(tris1.n2) - np.asarray(tris0.n2),
                        jnp.float32),
    )


def build_triangles(
    vertices: np.ndarray,
    faces: np.ndarray,
    mat_id: np.ndarray,
    emitter_id: np.ndarray,
    normals: np.ndarray | None = None,
    uvs: np.ndarray | None = None,
) -> TriangleSoA:
    """Host-side constructor from an indexed mesh."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int32)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    gn = np.cross(e1, e2)
    gl = np.linalg.norm(gn, axis=-1, keepdims=True)
    gn = gn / np.maximum(gl, 1e-20)
    if normals is None:
        n0 = n1 = n2 = gn
    else:
        n = np.asarray(normals, np.float32)
        n0, n1, n2 = n[f[:, 0]], n[f[:, 1]], n[f[:, 2]]
    if uvs is None:
        z2 = np.zeros((len(f), 2), np.float32)
        uv0 = uv1 = uv2 = z2
    else:
        uv = np.asarray(uvs, np.float32)
        uv0, uv1, uv2 = uv[f[:, 0]], uv[f[:, 1]], uv[f[:, 2]]
    return TriangleSoA(
        v0=jnp.asarray(p0), e1=jnp.asarray(e1), e2=jnp.asarray(e2),
        n0=jnp.asarray(n0), n1=jnp.asarray(n1), n2=jnp.asarray(n2),
        uv0=jnp.asarray(uv0), uv1=jnp.asarray(uv1), uv2=jnp.asarray(uv2),
        mat_id=jnp.asarray(np.asarray(mat_id, np.int32)),
        emitter_id=jnp.asarray(np.asarray(emitter_id, np.int32)),
        valid=jnp.ones(len(f), dtype=bool),
    )


def empty_spheres() -> SphereSoA:
    """A single degenerate (invalid) sphere — keeps shapes static."""
    return SphereSoA(
        center=jnp.zeros((1, 3), jnp.float32),
        radius=jnp.full((1,), -1.0, jnp.float32),
        mat_id=jnp.zeros((1,), jnp.int32),
        emitter_id=jnp.full((1,), -1, jnp.int32),
        valid=jnp.zeros((1,), dtype=bool),
    )


_LUM_W = np.array([0.212671, 0.715160, 0.072169], np.float32)


def build_emitters(
    tris: TriangleSoA,
    radiance_by_emitter: np.ndarray,
    env_radiance=(0.0, 0.0, 0.0),
    point_pos: np.ndarray | None = None,
    point_intensity: np.ndarray | None = None,
    directional: list | None = None,
    spots: list | None = None,
    env_image: np.ndarray | None = None,
    scene_radius: float = 1000.0,
    collimated: list | None = None,
) -> EmitterTable:
    """Collect all emitters into one power-weighted sampling table.

    Each emissive *triangle* becomes one area row (pick ∝ power, then
    uniform barycentric).  directional: list of (dir_toward_scene (3,),
    irradiance (3,)); spots: list of (pos, intensity, axis, cutoff_deg).
    """
    rows_kind, rows_tri, rows_rad, rows_area, rows_pos, rows_aux = (
        [], [], [], [], [], []
    )
    power = []

    eid = np.asarray(tris.emitter_id)
    emissive = np.nonzero(eid >= 0)[0]
    for i in emissive:
        e1 = np.asarray(tris.e1)[i]
        e2 = np.asarray(tris.e2)[i]
        area = 0.5 * float(np.linalg.norm(np.cross(e1, e2)))
        rad = np.asarray(radiance_by_emitter, np.float32)[eid[i]]
        rows_kind.append(EMITTER_AREA)
        rows_tri.append(int(i))
        rows_rad.append(rad)
        rows_area.append(area)
        rows_pos.append(np.zeros(3, np.float32))
        rows_aux.append(np.zeros(4, np.float32))
        power.append(max(float(rad @ _LUM_W) * area * np.pi, 1e-12))

    if point_pos is not None:
        for p, inten in zip(np.asarray(point_pos, np.float32),
                            np.asarray(point_intensity, np.float32)):
            rows_kind.append(EMITTER_POINT)
            rows_tri.append(0)
            rows_rad.append(inten)
            rows_area.append(0.0)
            rows_pos.append(p)
            rows_aux.append(np.zeros(4, np.float32))
            power.append(max(float(inten @ _LUM_W) * 4.0 * np.pi, 1e-12))

    for d, irr in (directional or []):
        d = np.asarray(d, np.float32)
        d = d / np.linalg.norm(d)
        irr = np.asarray(irr, np.float32)
        rows_kind.append(EMITTER_DIRECTIONAL)
        rows_tri.append(0)
        rows_rad.append(irr)
        rows_area.append(0.0)
        rows_pos.append(d)
        rows_aux.append(np.zeros(4, np.float32))
        power.append(
            max(float(irr @ _LUM_W) * np.pi * scene_radius**2, 1e-12)
        )

    if env_image is not None:
        rows_kind.append(EMITTER_ENV)
        rows_tri.append(0)
        rows_rad.append(np.asarray(env_image, np.float32).mean(axis=(0, 1)))
        rows_area.append(0.0)
        rows_pos.append(np.zeros(3, np.float32))
        rows_aux.append(np.zeros(4, np.float32))
        mean_lum = float(
            (np.asarray(env_image, np.float32) @ _LUM_W).mean()
        )
        power.append(max(mean_lum * np.pi * scene_radius**2, 1e-12))

    for p, inten, axis, cutoff_deg in (spots or []):
        axis = np.asarray(axis, np.float32)
        axis = axis / np.linalg.norm(axis)
        rows_kind.append(EMITTER_SPOT)
        rows_tri.append(0)
        rows_rad.append(np.asarray(inten, np.float32))
        rows_area.append(0.0)
        rows_pos.append(np.asarray(p, np.float32))
        cosc = float(np.cos(np.deg2rad(cutoff_deg)))
        rows_aux.append(np.asarray([*axis, cosc], np.float32))
        power.append(
            max(float(np.asarray(inten, np.float32) @ _LUM_W)
                * 2.0 * np.pi * (1 - cosc), 1e-12)
        )

    for p, d, pw in (collimated or []):
        # ref: src/emitters/collimated.cpp — a 0-dimensional response:
        # position + direction Dirac carrying `power` W.  Direct sampling
        # always fails (sampleDirect pdf 0, collimated.cpp:126-130);
        # transport reaches the film only through light-subpath walks.
        d = np.asarray(d, np.float32)
        d = d / np.linalg.norm(d)
        rows_kind.append(EMITTER_COLLIMATED)
        rows_tri.append(0)
        rows_rad.append(np.asarray(pw, np.float32))
        rows_area.append(0.0)
        rows_pos.append(np.asarray(p, np.float32))
        rows_aux.append(np.asarray([*d, 0.0], np.float32))
        power.append(max(float(np.asarray(pw, np.float32) @ _LUM_W),
                         1e-12))

    if not rows_kind:   # keep shapes static: one dummy zero-power area row
        rows_kind = [EMITTER_AREA]
        rows_tri = [0]
        rows_rad = [np.zeros(3, np.float32)]
        rows_area = [0.0]
        rows_pos = [np.zeros(3, np.float32)]
        rows_aux = [np.zeros(4, np.float32)]
        power = [1.0]

    power = np.asarray(power, np.float32)
    pmf = power / power.sum()
    cdf = np.cumsum(pmf).astype(np.float32)
    cdf[-1] = 1.0

    env_fields = dict(env_image=None, env_row_cdf=None, env_col_cdf=None,
                      env_pmf=None)
    if env_image is not None:
        img = np.asarray(env_image, np.float32)
        he, we = img.shape[:2]
        lum = img @ _LUM_W
        theta = (np.arange(he) + 0.5) / he * np.pi
        w = lum * np.sin(theta)[:, None]
        w = np.maximum(w, 1e-12)
        px = w / w.sum()
        row_p = px.sum(axis=1)
        row_cdf = np.cumsum(row_p); row_cdf[-1] = 1.0
        col_cdf = np.cumsum(px / row_p[:, None], axis=1)
        col_cdf[:, -1] = 1.0
        env_fields = dict(
            env_image=jnp.asarray(img),
            env_row_cdf=jnp.asarray(row_cdf.astype(np.float32)),
            env_col_cdf=jnp.asarray(col_cdf.astype(np.float32)),
            env_pmf=jnp.asarray(px.astype(np.float32)),
        )
    return EmitterTable(
        **env_fields,
        kind=jnp.asarray(np.asarray(rows_kind, np.int32)),
        tri_idx=jnp.asarray(np.asarray(rows_tri, np.int32)),
        radiance=jnp.asarray(np.stack(rows_rad)),
        area=jnp.asarray(np.asarray(rows_area, np.float32)),
        pos=jnp.asarray(np.stack(rows_pos)),
        aux=jnp.asarray(np.stack(rows_aux)),
        pmf=jnp.asarray(pmf),
        cdf=jnp.asarray(cdf),
        env_radiance=jnp.asarray(np.asarray(env_radiance, np.float32)),
    )


def make_camera(to_world, fov_x_deg: float, aspect: float,
                aperture_radius: float = 0.0,
                focus_distance: float = 1.0,
                kind: int = CAMERA_PERSPECTIVE,
                kc=None) -> Camera:
    tan_x = float(np.tan(np.deg2rad(fov_x_deg) / 2.0)) \
        if kind == CAMERA_PERSPECTIVE else float(fov_x_deg)
    rdist = kc is not None and float(np.abs(np.asarray(kc)).sum()) > 0
    return Camera(
        to_world=jnp.asarray(to_world, jnp.float32),
        tan_half_fov_x=jnp.float32(tan_x),
        tan_half_fov_y=jnp.float32(tan_x / aspect),
        aperture_radius=jnp.float32(aperture_radius),
        focus_distance=jnp.float32(focus_distance),
        kind=kind,
        kc=jnp.asarray(kc, jnp.float32) if rdist else None,
        rdist=rdist,
    )
