"""Irawan-Marschner woven cloth BRDF (ref: src/bsdfs/irawan.{h,cpp}).

The reference parses `.wft` weave descriptions with a boost::spirit
grammar (irawan.h:220-330) and evaluates the closed-form Irawan model:
a tiled yarn-segment lookup, per-segment curved-cylinder specular
integrand (filament or staple depending on fiber twist), a von Mises
azimuthal term, Seeliger shadowing, TEA-hash intensity variation, and a
Monte-Carlo specular normalization at configure time (irawan.cpp:105-127).

Batch form: the weave pattern packs into small dense arrays (pattern tile +
one parameter row per yarn); per-hit yarn selection is a one-hot row
select; both integrand variants evaluate branchlessly and where-select on
the yarn's psi.  Sampling is cosine-weighted exactly like the reference
(irawan.cpp:330-360) so the BSDF framework treats it as a textured
diffuse-like lobe with a direction-dependent value.  The reference's
Perlin-noise umax jitter (period > 0) is approximated with the same TEA
hash that drives the intensity variation — a different but equally
deterministic noise source (documented deviation; affects look, not
energy).
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np

from drmlt_mitsuba.core import struct

INV_PI = 1.0 / np.pi


# ------------------------------------------------------------- parsing --

def _strip_comments(s: str) -> str:
    return re.sub(r"/\*.*?\*/", " ", s, flags=re.S)


def _resolve(tok: str, props: dict):
    tok = tok.strip()
    if tok.startswith("$"):
        return props[tok[1:]]
    return float(tok)


def _balanced_blocks(s: str, keyword: str):
    """Yield the brace-balanced body of every `keyword { ... }` block."""
    for m in re.finditer(rf"{keyword}\s*\{{", s):
        depth = 1
        i = m.end()
        while i < len(s) and depth:
            if s[i] == "{":
                depth += 1
            elif s[i] == "}":
                depth -= 1
            i += 1
        yield s[m.end(): i - 1], m.start(), i


def parse_wft(text: str, props: dict | None = None) -> dict:
    """Parse a weave-pattern description into a plain dict.  `props`
    resolves `$identifier` placeholders (the XML-side parameters the
    reference routes through Properties)."""
    props = props or {}
    s = _strip_comments(text)
    blocks = list(_balanced_blocks(s, "weave"))
    if not blocks:
        raise ValueError("not a weave pattern (missing 'weave { ... }')")
    body = blocks[0][0]

    out: dict = {"yarns": [], "pattern": None, "name": ""}
    deg = np.pi / 180.0

    nm = re.search(r'name\s*=\s*"([^"]*)"', body)
    if nm:
        out["name"] = nm.group(1)

    pat = re.search(r"pattern\s*\{([^}]*)\}", body)
    if pat:
        out["pattern"] = [int(x) for x in
                          re.split(r"[\s,]+", pat.group(1).strip()) if x]

    yarn_spans = []
    for yb, y0, y1 in _balanced_blocks(body, "yarn"):
        yarn_spans.append((y0, y1))
        y = dict(type=0, psi=0.0, umax=0.0, kappa=0.0, width=0.0,
                 length=0.0, centerU=0.0, centerV=0.0,
                 kd=np.zeros(3, np.float32), ks=np.zeros(3, np.float32))
        tm = re.search(r"type\s*=\s*(warp|weft)", yb)
        if tm:
            y["type"] = 0 if tm.group(1) == "warp" else 1
        for key, scale in (("psi", deg), ("umax", deg), ("kappa", 1.0),
                           ("width", 1.0), ("length", 1.0),
                           ("centerU", 1.0), ("centerV", 1.0)):
            m = re.search(rf"{key}\s*=\s*(\$?[\w.+-]+)", yb)
            if m:
                y[key] = _resolve(m.group(1), props) * scale
        for key in ("kd", "ks"):
            m = re.search(
                rf"{key}\s*=\s*\{{\s*([^}}]*)\s*\}}", yb)
            if m:
                y[key] = np.asarray(
                    [float(x) for x in re.split(r"[\s,]+",
                                                m.group(1).strip()) if x],
                    np.float32)[:3]
            else:
                m = re.search(rf"{key}\s*=\s*\$(\w+)", yb)
                if m:
                    y[key] = np.asarray(props[m.group(1)],
                                        np.float32).reshape(3)
        out["yarns"].append(y)

    # scalar keys (yarn/pattern blocks removed so their fields can't match)
    scalars = body
    for y0, y1 in sorted(yarn_spans, reverse=True):
        scalars = scalars[:y0] + scalars[y1:]
    scalars = re.sub(r"pattern\s*\{[^}]*\}", " ", scalars)
    for key, scale in (
        ("tileWidth", 1.0), ("tileHeight", 1.0), ("alpha", 1.0),
        ("beta", 1.0), ("ss", 1.0), ("hWidth", 1.0), ("warpArea", 1.0),
        ("weftArea", 1.0), ("dWarpUmaxOverDWarp", deg),
        ("dWarpUmaxOverDWeft", deg), ("dWeftUmaxOverDWarp", deg),
        ("dWeftUmaxOverDWeft", deg), ("fineness", 1.0), ("period", 1.0),
    ):
        m = re.search(rf"{key}\s*=\s*(\$?[\w.+-]+)", scalars)
        if m:
            out[key] = _resolve(m.group(1), props) * scale
    out["tileWidth"] = int(out.get("tileWidth", 1))
    out["tileHeight"] = int(out.get("tileHeight", 1))
    for k in ("alpha", "beta", "ss", "hWidth", "warpArea", "weftArea",
              "dWarpUmaxOverDWarp", "dWarpUmaxOverDWeft",
              "dWeftUmaxOverDWarp", "dWeftUmaxOverDWeft", "fineness",
              "period"):
        out.setdefault(k, 0.0)
    if out["pattern"] is None or not out["yarns"]:
        raise ValueError("weave pattern needs 'pattern' and 'yarn' blocks")
    if len(out["pattern"]) != out["tileWidth"] * out["tileHeight"]:
        raise ValueError("pattern size != tileWidth * tileHeight")
    return out


@struct.dataclass
class IrawanPattern:
    """Packed weave pattern.  yarn_geo columns: [type, psi, umax, kappa,
    width, length, centerU, centerV]."""
    pattern: jnp.ndarray      # (Th, Tw) int32, yarn index (0-based)
    yarn_geo: jnp.ndarray     # (Y, 8)
    yarn_kd: jnp.ndarray      # (Y, 3)
    yarn_ks: jnp.ndarray      # (Y, 3)
    scalars: jnp.ndarray      # (14,) [alpha, beta, ss, hWidth, warpArea,
    #   weftArea, dWarpWarp, dWarpWeft, dWeftWarp, dWeftWeft, fineness,
    #   period, repeatU, repeatV]
    spec_norm: jnp.ndarray    # scalar MC normalization
    tile: tuple = struct.field(pytree_node=False, default=(1, 1))


def build_pattern(spec: dict, repeat_u: float, repeat_v: float,
                  n_norm_samples: int = 10000) -> IrawanPattern:
    tw, th = spec["tileWidth"], spec["tileHeight"]
    pattern = (np.asarray(spec["pattern"], np.int32).reshape(th, tw) - 1)
    geo = np.asarray(
        [[y["type"], y["psi"], y["umax"], y["kappa"], y["width"],
          y["length"], y["centerU"], y["centerV"]] for y in spec["yarns"]],
        np.float32)
    kd = np.stack([y["kd"] for y in spec["yarns"]]).astype(np.float32)
    ks = np.stack([y["ks"] for y in spec["yarns"]]).astype(np.float32)
    scal = np.asarray(
        [spec["alpha"], spec["beta"], spec["ss"], spec["hWidth"],
         spec["warpArea"], spec["weftArea"], spec["dWarpUmaxOverDWarp"],
         spec["dWarpUmaxOverDWeft"], spec["dWeftUmaxOverDWarp"],
         spec["dWeftUmaxOverDWeft"], spec["fineness"], spec["period"],
         repeat_u, repeat_v], np.float32)
    pat = IrawanPattern(
        pattern=jnp.asarray(pattern), yarn_geo=jnp.asarray(geo),
        yarn_kd=jnp.asarray(kd), yarn_ks=jnp.asarray(ks),
        scalars=jnp.asarray(scal), spec_norm=jnp.float32(1.0),
        tile=(th, tw))
    # MC specular normalization (ref irawan.cpp:105-127): max channel of
    # E[integrand] over cosine wi/wo and uniform uv, normalized so the
    # average specular reflectance is <= 1
    rng = np.random.default_rng(1234)
    u1 = rng.random((n_norm_samples, 2)).astype(np.float32)
    u2 = rng.random((n_norm_samples, 2)).astype(np.float32)
    uv = rng.random((n_norm_samples, 2)).astype(np.float32)

    def cos_hemi(u):
        r = np.sqrt(u[:, 0])
        phi = 2 * np.pi * u[:, 1]
        z = np.sqrt(np.maximum(1 - u[:, 0], 0.0))
        return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)

    wi = jnp.asarray(cos_hemi(u1))
    wo = jnp.asarray(cos_hemi(u2))
    integrand = np.asarray(_specular_integrand(pat, jnp.asarray(uv), wi,
                                               wo))
    mean = float(integrand.mean())
    norm = 0.0 if mean <= 0 else 1.0 / (mean * np.pi)
    return pat.replace(spec_norm=jnp.float32(norm))


# ----------------------------------------------------------- evaluation --

def _tea_float(v0, v1, rounds: int = 8):
    """TEA-hash uniform float in [0,1) (ref: core/qmc.h sampleTEAFloat)."""
    sum_ = jnp.uint32(0)
    delta = jnp.uint32(0x9E3779B9)
    k = (jnp.uint32(0xA341316C), jnp.uint32(0xC8013EA4),
         jnp.uint32(0xAD90777D), jnp.uint32(0x7E95761E))
    v0 = v0.astype(jnp.uint32)
    v1 = v1.astype(jnp.uint32)
    for _ in range(rounds):
        sum_ = sum_ + delta
        v0 = v0 + ((((v1 << 4) + k[0]) ^ (v1 + sum_)) ^ ((v1 >> 5) + k[1]))
        v1 = v1 + ((((v0 << 4) + k[2]) ^ (v0 + sum_)) ^ ((v0 >> 5) + k[3]))
    return (v0 >> 8).astype(jnp.float32) * jnp.float32(2.0 ** -24)


def _von_mises(cos_x, b):
    """exp(b cos x) / (2 pi I0(b)) with the Abramowitz-Stegun I0 fit the
    reference transcribes (irawan.cpp:469-487)."""
    ab = jnp.abs(b)
    t_small = (ab / 3.75) ** 2
    i0_small = 1.0 + t_small * (3.5156229 + t_small * (3.0899424 + t_small * (
        1.2067492 + t_small * (0.2659732 + t_small * (
            0.0360768 + t_small * 0.0045813)))))
    t_big = 3.75 / jnp.maximum(ab, 1e-6)
    i0_big = jnp.exp(ab) / jnp.sqrt(jnp.maximum(ab, 1e-6)) * (
        0.39894228 + t_big * (0.01328592 + t_big * (0.00225319 + t_big * (
            -0.00157565 + t_big * (0.00916281 + t_big * (
                -0.02057706 + t_big * (0.02635537 + t_big * (
                    -0.01647633 + t_big * 0.00392377))))))))
    i0 = jnp.where(ab <= 3.75, i0_small, i0_big)
    return jnp.exp(b * cos_x) / (2.0 * jnp.pi * i0)


def _seeliger(c1, c2):
    c1 = jnp.maximum(c1, 0.0)
    c2 = jnp.maximum(c2, 0.0)
    return jnp.where((c1 <= 0) | (c2 <= 0), 0.0,
                     c1 * c2 / (4.0 * jnp.pi * jnp.maximum(c1 + c2, 1e-12)))


def _smoothstep(x):
    x = jnp.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def _radius_of_curvature(u, umax, kappa, w, l):
    """Yarn spine radius of curvature (irawan.cpp:436-466): circle,
    ellipse, hyperbola, or parabola depending on rhat."""
    a = 0.5 * w
    tan_umax = jnp.tan(jnp.maximum(umax, 1e-4))
    rhat = 1.0 + kappa * (1.0 + 1.0 / tan_umax)
    sin_umax = jnp.sin(umax)

    r_circle = (0.5 * l - a * sin_umax) / jnp.maximum(sin_umax, 1e-6)

    tmax_e = jnp.arctan(rhat * tan_umax)
    bhat_e = (0.5 * l - a * sin_umax) / jnp.maximum(
        jnp.sin(tmax_e), 1e-6)
    ahat_e = bhat_e / jnp.where(jnp.abs(rhat) < 1e-6, 1e-6, rhat)
    t_e = jnp.arctan(rhat * jnp.tan(u))
    r_ellipse = (bhat_e ** 2 * jnp.cos(t_e) ** 2
                 + ahat_e ** 2 * jnp.sin(t_e) ** 2) ** 1.5 / jnp.maximum(
        jnp.abs(ahat_e * bhat_e), 1e-9)

    atanh = lambda x: 0.5 * jnp.log(jnp.maximum(
        (1.0 + x) / jnp.maximum(1.0 - x, 1e-9), 1e-9))
    tmax_h = -atanh(jnp.clip(rhat * tan_umax, -1.0 + 1e-6, 1.0 - 1e-6))
    bhat_h = (0.5 * l - a * sin_umax) / jnp.where(
        jnp.abs(jnp.sinh(tmax_h)) < 1e-6, 1e-6, jnp.sinh(tmax_h))
    ahat_h = bhat_h / jnp.where(jnp.abs(rhat) < 1e-6, 1e-6, rhat)
    t_h = -atanh(jnp.clip(rhat * jnp.tan(u), -1.0 + 1e-6, 1.0 - 1e-6))
    r_hyper = -(bhat_h ** 2 * jnp.cosh(t_h) ** 2
                + ahat_h ** 2 * jnp.sinh(t_h) ** 2) ** 1.5 / jnp.where(
        jnp.abs(ahat_h * bhat_h) < 1e-9, 1e-9, ahat_h * bhat_h)

    tmax_p = tan_umax
    ahat_p = (0.5 * l - a * sin_umax) / jnp.maximum(2.0 * tmax_p, 1e-6)
    t_p = jnp.tan(u)
    r_parab = 2.0 * ahat_p * (1.0 + t_p * t_p) ** 1.5

    R = jnp.where(jnp.abs(rhat - 1.0) < 1e-6, r_circle,
                  jnp.where(rhat > 0.0, r_ellipse,
                            jnp.where(rhat < 0.0, r_hyper, r_parab)))
    return R


def _filament_integrand(u, v, om_i, om_r, alpha, beta, ss, umax, kappa,
                        w, l, h_width):
    """irawan.cpp evalFilamentIntegrand (psi == 0 yarns)."""
    h = om_i + om_r
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    u_of_v = jnp.arctan(h[..., 1] / jnp.maximum(jnp.abs(h[..., 2]), 1e-9)
                        * jnp.sign(h[..., 2] + 1e-30))
    ok = jnp.abs(u_of_v) < umax

    n = jnp.stack([jnp.sin(v), jnp.sin(u_of_v) * jnp.cos(v),
                   jnp.cos(u_of_v) * jnp.cos(v)], -1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    t = jnp.stack([jnp.zeros_like(u_of_v), jnp.cos(u_of_v),
                   -jnp.sin(u_of_v)], -1)

    R = _radius_of_curvature(
        jnp.minimum(jnp.abs(u_of_v), (1.0 - ss) * umax),
        (1.0 - ss) * umax, kappa, w, l)
    a = 0.5 * w
    sum_ior = om_i + om_r
    t_cross_h = jnp.cross(t, h)
    Gu = a * (R + a * jnp.cos(v)) / jnp.maximum(
        jnp.linalg.norm(sum_ior, axis=-1)
        * jnp.abs(t_cross_h[..., 0]), 1e-9)

    fc = alpha + _von_mises(-jnp.sum(om_i * om_r, -1), beta)
    A = _seeliger(jnp.sum(n * om_i, -1), jnp.sum(n * om_r, -1))
    As = jnp.where(
        ss <= 1e-6, A,
        A * (1.0 - _smoothstep((jnp.abs(u_of_v) - (1.0 - ss) * umax)
                               / jnp.maximum(ss * umax, 1e-9))))
    fs = Gu * fc * As * jnp.pi * l

    delta_y = l * h_width
    y_of_v = u_of_v * 0.5 * l / jnp.maximum(umax, 1e-6)
    y_of_v = jnp.clip(y_of_v, 0.5 * (delta_y - l), 0.5 * (l - delta_y))
    inside = jnp.abs(y_of_v - u * 0.5 * l / jnp.maximum(umax, 1e-6)) \
        < 0.5 * delta_y
    valid = ok & inside & (w * jnp.sin(umax) < l) & (kappa >= -1.0)
    return jnp.where(valid, fs / jnp.maximum(delta_y, 1e-9), 0.0)


def _staple_integrand(u, v, om_i, om_r, alpha, beta, psi, umax, kappa,
                      w, l, h_width):
    """irawan.cpp evalStapleIntegrand (psi != 0 yarns)."""
    h = om_i + om_r
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    tan_psi = jnp.tan(jnp.where(jnp.abs(psi) < 1e-5, 1e-5, psi))
    D = (hy * jnp.cos(u) - hz * jnp.sin(u)) / jnp.maximum(
        jnp.sqrt(hx * hx + (hy * jnp.sin(u) + hz * jnp.cos(u)) ** 2)
        * jnp.abs(tan_psi), 1e-9) * jnp.sign(tan_psi)
    safe_acos = lambda x: jnp.arccos(jnp.clip(x, -1.0, 1.0))
    v_of_u = jnp.arctan2(-hy * jnp.sin(u) - hz * jnp.cos(u), hx) \
        + safe_acos(D)
    ok = (jnp.abs(D) < 1.0) & (jnp.abs(v_of_u) < jnp.pi / 2.0)

    n = jnp.stack([jnp.sin(v_of_u), jnp.sin(u) * jnp.cos(v_of_u),
                   jnp.cos(u) * jnp.cos(v_of_u)], -1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    R = _radius_of_curvature(jnp.abs(u), umax, kappa, w, l)
    a = 0.5 * w
    sum_ior = om_i + om_r
    Gv = a * (R + a * jnp.cos(v_of_u)) / jnp.maximum(
        jnp.linalg.norm(sum_ior, axis=-1) * jnp.abs(jnp.sum(n * h, -1))
        * jnp.abs(jnp.sin(psi)), 1e-9)

    fc = alpha + _von_mises(-jnp.sum(om_i * om_r, -1), beta)
    A = _seeliger(jnp.sum(n * om_i, -1), jnp.sum(n * om_r, -1))
    fs = Gv * fc * A * 2.0 * w * umax

    delta_x = w * h_width
    x_of_u = v_of_u * w / jnp.pi
    x_of_u = jnp.clip(x_of_u, 0.5 * (delta_x - w), 0.5 * (w - delta_x))
    inside = jnp.abs(x_of_u - v * w / jnp.pi) < 0.5 * delta_x
    valid = ok & inside & (w * jnp.sin(umax) < l) & (kappa >= -1.0)
    return jnp.where(valid, fs / jnp.maximum(delta_x, 1e-9), 0.0)


def _yarn_context(pat: IrawanPattern, uv):
    """Per-hit yarn selection + local (u, v) + noise factors.  uv (R, 2)
    in [0,1].  Returns dict of (R,) / (R,3) arrays."""
    s = pat.scalars
    repeat_u, repeat_v = s[12], s[13]
    th, tw = pat.tile
    uu = uv[:, 0] * repeat_u
    vv = (1.0 - uv[:, 1]) * repeat_v
    x = uu * tw
    y = vv * th
    lx = jnp.mod(jnp.floor(x).astype(jnp.int32), tw)
    ly = jnp.mod(jnp.floor(y).astype(jnp.int32), th)
    yid = pat.pattern[ly, lx]
    onehot = (yid[:, None] == jnp.arange(pat.yarn_geo.shape[0])[None, :]
              ).astype(jnp.float32)
    geo, kd, ks = (jnp.matmul(onehot, t, precision=jax.lax.Precision.HIGHEST)
                   for t in (pat.yarn_geo, pat.yarn_kd, pat.yarn_ks))
    is_weft = geo[:, 0] > 0.5

    center_x = jnp.floor(x / tw) * tw + geo[:, 6] * tw
    center_y = jnp.floor(y / th) * th + (1.0 - geo[:, 7]) * th
    rel_x = x - center_x
    rel_y = -(y - center_y)

    # weft yarns: rotate 90 degrees (ref irawan.cpp:247-258)
    rx = jnp.where(is_weft, -rel_y, rel_x)
    ry = jnp.where(is_weft, rel_x, rel_y)

    umax = geo[:, 2]
    d_warp = jnp.where(is_weft, s[8], s[6])
    d_weft = jnp.where(is_weft, s[9], s[7])
    period = s[11]
    # umax jitter: the reference perturbs via Perlin noise on the segment
    # center (irawan.cpp:262-276); here the same TEA hash supplies the
    # two pseudo-random values (documented deviation)
    r1 = 2.0 * _tea_float(center_x.astype(jnp.int32),
                          2 * center_y.astype(jnp.int32)) - 1.0
    r2 = 2.0 * _tea_float(center_x.astype(jnp.int32),
                          2 * center_y.astype(jnp.int32) + 1) - 1.0
    umax = jnp.where(period > 0.0,
                     umax + r1 * d_warp + r2 * d_weft, umax)

    w = geo[:, 4]
    l = geo[:, 5]
    u = ry / jnp.maximum(l / 2.0, 1e-9) * umax
    v = rx * jnp.pi / jnp.maximum(w, 1e-9)

    # intensity variation (irawan.cpp:292-300)
    fineness = s[10]
    idx1 = ((center_x + rx) * fineness).astype(jnp.int32)
    idx2 = ((center_y + ry) * fineness).astype(jnp.int32)
    xi = _tea_float(idx1, idx2)
    intensity = jnp.where(
        fineness > 0.0,
        jnp.minimum(-jnp.log(jnp.maximum(xi, 1e-10)), 10.0), 1.0)

    area_ratio = jnp.where(
        is_weft, (s[4] + s[5]) / jnp.maximum(s[5], 1e-9),
        (s[4] + s[5]) / jnp.maximum(s[4], 1e-9))
    return dict(u=u, v=v, is_weft=is_weft, psi=geo[:, 1], umax=umax,
                kappa=geo[:, 3], w=w, l=l, kd=kd, ks=ks,
                intensity=intensity, area_ratio=area_ratio)


def _specular_integrand(pat: IrawanPattern, uv, wi, wo):
    """Raw specular integrand * intensity * area ratio (the quantity the
    MC normalization averages; irawan.cpp m_initialization branch)."""
    ctx = _yarn_context(pat, uv)
    s = pat.scalars
    # rotate directions for weft yarns
    flip = ctx["is_weft"][:, None]
    rot = jnp.stack([-wi[:, 1], wi[:, 0], wi[:, 2]], -1)
    om_i = jnp.where(flip, rot, wi)
    rot_r = jnp.stack([-wo[:, 1], wo[:, 0], wo[:, 2]], -1)
    om_r = jnp.where(flip, rot_r, wo)

    f_fil = _filament_integrand(ctx["u"], ctx["v"], om_i, om_r, s[0], s[1],
                                s[2], ctx["umax"], ctx["kappa"], ctx["w"],
                                ctx["l"], s[3])
    f_sta = _staple_integrand(ctx["u"], ctx["v"], om_i, om_r, s[0], s[1],
                              ctx["psi"], ctx["umax"], ctx["kappa"],
                              ctx["w"], ctx["l"], s[3])
    integrand = jnp.where(jnp.abs(ctx["psi"]) > 1e-6, f_sta, f_fil)
    return integrand * ctx["intensity"] * ctx["area_ratio"]


def irawan_eval(pat: IrawanPattern, uv, wi, wo):
    """f(wi, wo) * cos_theta_o, (R, 3).  Local frame, z-up; zero below the
    horizon (the reference's cosTheta checks)."""
    ctx = _yarn_context(pat, uv)
    spec = _specular_integrand(pat, uv, wi, wo)
    f = (ctx["ks"] * (spec * pat.spec_norm)[:, None]
         + ctx["kd"] * INV_PI)
    cos_o = wo[..., 2]
    vis = (wi[..., 2] > 0) & (cos_o > 0)
    return jnp.where(vis[:, None], f * jnp.maximum(cos_o, 0.0)[:, None],
                     0.0)


def irawan_kd(pat: IrawanPattern, uv):
    """Diffuse reflectance lookup (ref getDiffuseReflectance)."""
    return _yarn_context(pat, uv)["kd"]
