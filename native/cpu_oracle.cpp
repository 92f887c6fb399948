// cpu_oracle — an INDEPENDENT scalar CPU renderer (own code, not a port of
// either the reference or the JAX tracer) serving two purposes:
//
//  1. External numerical cross-check: the Mitsuba-0.6 reference cannot be
//     built in this image (no boost/xerces headers, OpenEXR-3-only), so this
//     separately-written C++ path tracer + PSSMLT/DRMLT implementation is
//     the oracle that a shared bug in the JAX trace_paths/MCMC stack would
//     disagree with.  tests/test_oracle_parity.py compares images.
//  2. Measured CPU anchor: BASELINE.md's mutations/s denominator.  Runs the
//     same per-mutation work as the reference DRMLT loop (stage-1 trace
//     always, stage-2 trace on rejection, green adds a reverse trace;
//     /root/reference/src/integrators/drmlt/drmlt_proc.cpp:518-770) with
//     branchy scalar control flow, multithreaded over chains.
//
// Scene input: flat binary dump written by drmlt_mitsuba/utils/
// scene_dump.py.  PSS layout matches integrators/layout.py (the replay
// contract): 4 sensor dims + 9 dims/bounce.
//
// Usage:
//   cpu_oracle pt   scene.bin out.raw <spp> <max_depth>
//   cpu_oracle mlt  scene.bin out.raw <pssmlt|green|mira|orbital>
//                   <seconds> <max_depth> [threads]
// Prints one JSON line with timing + throughput.
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------- vectors
struct V3 {
  float x = 0, y = 0, z = 0;
};
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float len(V3 a) { return std::sqrt(dot(a, a)); }
static inline V3 norm(V3 a) {
  float l = len(a);
  return l > 0 ? a * (1.0f / l) : V3{0, 0, 1};
}
static inline V3 vmin(V3 a, V3 b) { return {std::fmin(a.x, b.x), std::fmin(a.y, b.y), std::fmin(a.z, b.z)}; }
static inline V3 vmax(V3 a, V3 b) { return {std::fmax(a.x, b.x), std::fmax(a.y, b.y), std::fmax(a.z, b.z)}; }
static inline float maxc(V3 a) { return std::fmax(a.x, std::fmax(a.y, a.z)); }
static inline float lum(V3 c) {
  return 0.212671f * c.x + 0.715160f * c.y + 0.072169f * c.z;
}

// ---------------------------------------------------------------- RNG
struct Rng {  // xoshiro256++, seeded via splitmix64
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    uint64_t z = seed;
    for (int i = 0; i < 4; i++) {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t t = z;
      t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
      t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
      s[i] = t ^ (t >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    uint64_t r = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return r;
  }
  float uf() { return float((next() >> 40) * (1.0 / 16777216.0)); }
};

// ---------------------------------------------------------------- scene
enum { B_DIFFUSE = 0, B_CONDUCTOR = 1, B_DIELECTRIC = 2, B_ROUGH_CONDUCTOR = 3,
       B_MIRROR = 8, B_NULL = 9, B_ROUGH_DIFFUSE = 12 };

struct Mat {
  int kind;
  V3 albedo, eta, k;
  float rough;
  int two_sided;
};
struct Tri {
  V3 v0, e1, e2, n0, n1, n2;
  int mat, erow;
  V3 ng;  // derived
};
struct ERow {
  int tri;
  V3 rad;
  float area, pmf, cdf;
};
struct Sph {
  V3 c;
  float r;
  int mat;
};
struct BvhNode {
  V3 lo, hi;
  int start = 0, count = 0, skip = -1;  // count>0 = leaf
};
struct Bvh {
  std::vector<BvhNode> nodes;
};
struct Scene {
  Bvh bvh;
  std::vector<Tri> tris;
  std::vector<Mat> mats;
  std::vector<ERow> ems;
  std::vector<Sph> sphs;
  float cam[16];
  float thx, thy;
  int W, H;
};

static bool load_scene(const char* path, Scene& sc) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint32_t hdr[7];
  if (fread(hdr, 4, 7, f) != 7 || hdr[0] != 0x4452544F) { fclose(f); return false; }
  uint32_t T = hdr[2], M = hdr[3], E = hdr[4];
  sc.W = int(hdr[5]); sc.H = int(hdr[6]);
  uint32_t S = 0;
  if (hdr[1] >= 2) fread(&S, 4, 1, f);
  fread(sc.cam, 4, 16, f);
  fread(&sc.thx, 4, 1, f); fread(&sc.thy, 4, 1, f);
  sc.mats.resize(M);
  for (auto& m : sc.mats) {
    fread(&m.kind, 4, 1, f);
    fread(&m.albedo, 4, 3, f); fread(&m.eta, 4, 3, f); fread(&m.k, 4, 3, f);
    fread(&m.rough, 4, 1, f); fread(&m.two_sided, 4, 1, f);
  }
  sc.tris.resize(T);
  for (auto& t : sc.tris) {
    fread(&t.v0, 4, 3, f); fread(&t.e1, 4, 3, f); fread(&t.e2, 4, 3, f);
    fread(&t.n0, 4, 3, f); fread(&t.n1, 4, 3, f); fread(&t.n2, 4, 3, f);
    fread(&t.mat, 4, 1, f); fread(&t.erow, 4, 1, f);
    t.ng = norm(cross(t.e1, t.e2));
  }
  sc.ems.resize(E);
  float acc = 0;
  for (auto& e : sc.ems) {
    fread(&e.tri, 4, 1, f);
    fread(&e.rad, 4, 3, f);
    fread(&e.area, 4, 1, f); fread(&e.pmf, 4, 1, f);
    acc += e.pmf;
    e.cdf = acc;
  }
  sc.sphs.resize(S);
  for (auto& s : sc.sphs) {
    fread(&s.c, 4, 3, f);
    fread(&s.r, 4, 1, f);
    fread(&s.mat, 4, 1, f);
  }
  fclose(f);
  return true;
}

// ---------------------------------------------------------------- BVH
// Binned-SAH BVH build, flattened depth-first with skip pointers
// (stackless): the oracle-side analog of the rebuild's
// native/bvh_builder.cpp and the reference's ShapeKDTree
// (gkdtree.h:958) — keeps the 64-core anchor honest at parity-scene
// triangle counts instead of collapsing O(T).
static void bvh_build(Scene& sc) {
  size_t T = sc.tris.size();
  // tiny scenes: the brute loop beats the node walk (measured 663k vs
  // 272k mut/s/core on the 36-tri cornell flagship bench) — leave the
  // BVH empty and let intersect/occluded fall back
  if (T <= 1024) return;
  std::vector<V3> lo(T), hi(T), cen(T);
  for (size_t i = 0; i < T; i++) {
    const Tri& t = sc.tris[i];
    V3 p1 = t.v0 + t.e1, p2 = t.v0 + t.e2;
    lo[i] = vmin(vmin(t.v0, p1), p2);
    hi[i] = vmax(vmax(t.v0, p1), p2);
    cen[i] = (lo[i] + hi[i]) * 0.5f;
  }
  std::vector<int> order(T);
  for (size_t i = 0; i < T; i++) order[i] = int(i);
  std::vector<BvhNode>& nodes = sc.bvh.nodes;
  nodes.clear();
  nodes.reserve(2 * T);
  // top-down build; children are emitted depth-first so skip pointers
  // can be fixed up afterwards
  std::function<int(int, int)> rec = [&](int first, int count) -> int {
    V3 blo = {1e30f, 1e30f, 1e30f}, bhi = {-1e30f, -1e30f, -1e30f};
    V3 clo = blo, chi = bhi;
    for (int i = first; i < first + count; i++) {
      blo = vmin(blo, lo[order[i]]);
      bhi = vmax(bhi, hi[order[i]]);
      clo = vmin(clo, cen[order[i]]);
      chi = vmax(chi, cen[order[i]]);
    }
    int self = int(nodes.size());
    nodes.push_back({blo, bhi, first, count, -1});
    if (count <= 4) return self;
    V3 ext = chi - clo;
    int ax = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2)
                           : (ext.y > ext.z ? 1 : 2);
    float cmin = ax == 0 ? clo.x : ax == 1 ? clo.y : clo.z;
    float cext = ax == 0 ? ext.x : ax == 1 ? ext.y : ext.z;
    int mid;
    if (cext < 1e-12f) {
      mid = first + count / 2;
    } else {
      // 16-bin SAH sweep
      const int NB = 16;
      int cnt[NB] = {0};
      V3 blos[NB], bhis[NB];
      for (int b = 0; b < NB; b++) {
        blos[b] = {1e30f, 1e30f, 1e30f};
        bhis[b] = {-1e30f, -1e30f, -1e30f};
      }
      auto bin_of = [&](int i) {
        float c = ax == 0 ? cen[i].x : ax == 1 ? cen[i].y : cen[i].z;
        int b = int((c - cmin) / cext * NB);
        return b < 0 ? 0 : b >= NB ? NB - 1 : b;
      };
      for (int i = first; i < first + count; i++) {
        int b = bin_of(order[i]);
        cnt[b]++;
        blos[b] = vmin(blos[b], lo[order[i]]);
        bhis[b] = vmax(bhis[b], hi[order[i]]);
      }
      auto ha = [](V3 a, V3 b) {
        V3 d = b - a;
        d.x = d.x > 0 ? d.x : 0; d.y = d.y > 0 ? d.y : 0;
        d.z = d.z > 0 ? d.z : 0;
        return d.x * d.y + d.y * d.z + d.z * d.x;
      };
      float best = 1e30f;
      int best_b = NB / 2;
      for (int s = 1; s < NB; s++) {
        V3 l0 = {1e30f, 1e30f, 1e30f}, l1 = {-1e30f, -1e30f, -1e30f};
        V3 r0 = l0, r1 = l1;
        int nl = 0, nr = 0;
        for (int b = 0; b < s; b++) {
          if (!cnt[b]) continue;
          l0 = vmin(l0, blos[b]); l1 = vmax(l1, bhis[b]); nl += cnt[b];
        }
        for (int b = s; b < NB; b++) {
          if (!cnt[b]) continue;
          r0 = vmin(r0, blos[b]); r1 = vmax(r1, bhis[b]); nr += cnt[b];
        }
        if (!nl || !nr) continue;
        float cost = ha(l0, l1) * nl + ha(r0, r1) * nr;
        if (cost < best) { best = cost; best_b = s; }
      }
      int* it = std::partition(
          order.data() + first, order.data() + first + count,
          [&](int i) { return bin_of(i) < best_b; });
      mid = int(it - order.data());
      if (mid == first || mid == first + count) mid = first + count / 2;
    }
    nodes[self].count = 0;
    rec(first, mid - first);
    rec(mid, first + count - mid);
    return self;
  };
  rec(0, int(T));
  // skip pointers: next DFS node that is NOT my descendant, via
  // subtree extents
  std::vector<int> end(nodes.size());
  std::function<int(int)> extent = [&](int self) -> int {
    if (nodes[self].count > 0) { end[self] = self + 1; return self + 1; }
    int l = self + 1;
    int r = extent(l);
    int e = extent(r);
    end[self] = e;
    return e;
  };
  extent(0);
  std::function<void(int, int)> fix2 = [&](int self, int skip) {
    nodes[self].skip = skip;
    if (nodes[self].count == 0) {
      int l = self + 1;
      int r = end[l];
      fix2(l, r);
      fix2(r, skip);
    }
  };
  fix2(0, -1);
  // permute the triangle array leaf-contiguous and remap emitter rows
  std::vector<Tri> nt(T);
  std::vector<int> inv(T);
  for (size_t i = 0; i < T; i++) { nt[i] = sc.tris[order[i]]; inv[order[i]] = int(i); }
  sc.tris.swap(nt);
  for (auto& e : sc.ems) e.tri = inv[e.tri];
}

// ---------------------------------------------------------------- intersect
struct Hit {
  bool valid = false;
  float t = 1e30f;
  int tri = -1;
  int sph = -1;
  float b1 = 0, b2 = 0;
};
static inline bool sphere_hit(const Sph& s, V3 o, V3 d, float tmin, float tmax,
                              float& t_out) {
  V3 oc = o - s.c;
  float b = dot(oc, d);
  float c = dot(oc, oc) - s.r * s.r;
  float disc = b * b - c;
  if (disc < 0) return false;
  float sq = std::sqrt(disc);
  float t0 = -b - sq, t1 = -b + sq;
  float t = t0 > tmin ? t0 : t1;
  if (t <= tmin || t >= tmax) return false;
  t_out = t;
  return true;
}
static inline void tri_test(const Scene& sc, int i, V3 o, V3 d, Hit& h) {
  const Tri& tr = sc.tris[i];
  V3 p = cross(d, tr.e2);
  float det = dot(tr.e1, p);
  if (std::fabs(det) < 1e-12f) return;
  float inv = 1.0f / det;
  V3 s = o - tr.v0;
  float b1 = dot(s, p) * inv;
  if (b1 < 0 || b1 > 1) return;
  V3 q = cross(s, tr.e1);
  float b2 = dot(d, q) * inv;
  if (b2 < 0 || b1 + b2 > 1) return;
  float t = dot(tr.e2, q) * inv;
  if (t > 1e-4f && t < h.t) {
    h.valid = true; h.t = t; h.tri = i; h.sph = -1;
    h.b1 = b1; h.b2 = b2;
  }
}
static inline bool box_hit(const BvhNode& n, V3 o, V3 inv, float tmax) {
  float tx0 = (n.lo.x - o.x) * inv.x, tx1 = (n.hi.x - o.x) * inv.x;
  float ty0 = (n.lo.y - o.y) * inv.y, ty1 = (n.hi.y - o.y) * inv.y;
  float tz0 = (n.lo.z - o.z) * inv.z, tz1 = (n.hi.z - o.z) * inv.z;
  float tmin = std::fmax(std::fmax(std::fmin(tx0, tx1), std::fmin(ty0, ty1)),
                         std::fmin(tz0, tz1));
  float tmx = std::fmin(std::fmin(std::fmax(tx0, tx1), std::fmax(ty0, ty1)),
                        std::fmax(tz0, tz1));
  return tmx >= std::fmax(tmin, 0.0f) && tmin < tmax;
}
static Hit intersect(const Scene& sc, V3 o, V3 d, float tmax = 1e30f) {
  Hit h;
  h.t = tmax;
  for (size_t i = 0; i < sc.sphs.size(); i++) {
    float t;
    if (sphere_hit(sc.sphs[i], o, d, 1e-4f, h.t, t)) {
      h.valid = true; h.t = t; h.sph = int(i); h.tri = -1;
    }
  }
  V3 inv = {1.0f / (std::fabs(d.x) > 1e-20f ? d.x : 1e-20f),
            1.0f / (std::fabs(d.y) > 1e-20f ? d.y : 1e-20f),
            1.0f / (std::fabs(d.z) > 1e-20f ? d.z : 1e-20f)};
  if (sc.bvh.nodes.empty()) {
    for (size_t i = 0; i < sc.tris.size(); i++)
      tri_test(sc, int(i), o, d, h);
    return h;
  }
  int node = 0;
  while (node >= 0) {
    const BvhNode& n = sc.bvh.nodes[node];
    if (!box_hit(n, o, inv, h.t)) { node = n.skip; continue; }
    if (n.count > 0) {
      for (int i = n.start; i < n.start + n.count; i++)
        tri_test(sc, i, o, d, h);
      node = n.skip;
    } else {
      node = node + 1;
    }
  }
  return h;
}
static bool occluded(const Scene& sc, V3 o, V3 d, float tmax) {
  if (tmax <= 0) return false;
  for (const Sph& s : sc.sphs) {
    float t;
    if (sphere_hit(s, o, d, 1e-4f, tmax, t)) return true;
  }
  V3 inv = {1.0f / (std::fabs(d.x) > 1e-20f ? d.x : 1e-20f),
            1.0f / (std::fabs(d.y) > 1e-20f ? d.y : 1e-20f),
            1.0f / (std::fabs(d.z) > 1e-20f ? d.z : 1e-20f)};
  Hit h;
  h.t = tmax;
  if (sc.bvh.nodes.empty()) {
    for (size_t i = 0; i < sc.tris.size(); i++) {
      tri_test(sc, int(i), o, d, h);
      if (h.valid) return true;
    }
    return false;
  }
  int node = 0;
  while (node >= 0) {
    const BvhNode& n = sc.bvh.nodes[node];
    if (!box_hit(n, o, inv, tmax)) { node = n.skip; continue; }
    if (n.count > 0) {
      for (int i = n.start; i < n.start + n.count; i++) {
        tri_test(sc, i, o, d, h);
        if (h.valid) return true;
      }
      node = n.skip;
    } else {
      node = node + 1;
    }
  }
  return false;
}

// ---------------------------------------------------------------- frames
static void basis(V3 n, V3& t, V3& b) {
  // Duff et al. branchless ONB
  float sg = n.z >= 0 ? 1.0f : -1.0f;
  float a = -1.0f / (sg + n.z);
  float c = n.x * n.y * a;
  t = {1.0f + sg * n.x * n.x * a, sg * c, -sg * n.x};
  b = {c, sg + n.y * n.y * a, -n.y};
}
static V3 to_world(V3 n, V3 local) {
  V3 t, b;
  basis(n, t, b);
  return t * local.x + b * local.y + n * local.z;
}

// ---------------------------------------------------------------- BSDFs
static V3 fresnel_cond(float ci, V3 eta, V3 k) {
  auto fr1 = [&](float e, float kk) {
    float c2 = ci * ci, s2 = 1 - c2;
    float e2 = e * e, k2 = kk * kk;
    float t0 = e2 - k2 - s2;
    float a2b2 = std::sqrt(std::fmax(t0 * t0 + 4 * e2 * k2, 0.0f));
    float t1 = a2b2 + c2;
    float a = std::sqrt(std::fmax(0.5f * (a2b2 + t0), 0.0f));
    float t2 = 2 * a * ci;
    float rs = (t1 - t2) / (t1 + t2);
    float t3 = c2 * a2b2 + s2 * s2;
    float t4 = t2 * s2;
    float rp = rs * (t3 - t4) / (t3 + t4);
    return 0.5f * (rs + rp);
  };
  return {fr1(eta.x, k.x), fr1(eta.y, k.y), fr1(eta.z, k.z)};
}
static float fresnel_diel(float ci, float eta) {  // eta = int/ext
  float s2 = (1 - ci * ci) / (eta * eta);
  if (s2 >= 1) return 1.0f;
  float ct = std::sqrt(1 - s2);
  float rs = (ci - eta * ct) / (ci + eta * ct);
  float rp = (eta * ci - ct) / (eta * ci + ct);
  return 0.5f * (rs * rs + rp * rp);
}
static float ggx_d(float cm, float alpha) {
  if (cm <= 0) return 0;
  float a2 = alpha * alpha, c2 = cm * cm;
  float d = c2 * (a2 - 1) + 1;
  return a2 / (float(M_PI) * d * d);
}
static float ggx_lambda(float cv, float alpha) {
  if (cv <= 0) return 1e9f;
  float c2 = cv * cv;
  float t2 = (1 - c2) / c2;  // tan^2
  return 0.5f * (std::sqrt(1 + alpha * alpha * t2) - 1.0f);
}
static float ggx_g2(float ci, float co, float alpha) {
  // height-correlated Smith (matches render/microfacet.py ggx_g2)
  return 1.0f / (1.0f + ggx_lambda(ci, alpha) + ggx_lambda(co, alpha));
}

struct BsdfSample {
  V3 wo;       // local
  V3 weight;   // f*cos/pdf
  float pdf = 0;
  bool delta = false;
  float eta = 1.0f;
};

// local-frame convention: z = shading normal (oriented toward incident ray
// for two-sided kinds); wi points back along the incoming ray.
// qualitative Oren-Nayar factor (matches render/bsdf.py; roughness=sigma)
static float oren_nayar(const Mat& m, V3 wi, V3 wo) {
  float s2 = m.rough * m.rough;
  float A = 1.0f - 0.5f * s2 / (s2 + 0.33f);
  float B = 0.45f * s2 / (s2 + 0.09f);
  float ci = std::fabs(wi.z), co = std::fabs(wo.z);
  float sin_i = std::sqrt(std::fmax(1 - ci * ci, 0.0f));
  float sin_o = std::sqrt(std::fmax(1 - co * co, 0.0f));
  float denom = std::fmax(sin_i * sin_o, 1e-7f);
  float cd = std::fmin(std::fmax((wi.x * wo.x + wi.y * wo.y) / denom,
                                 -1.0f), 1.0f);
  float sa = std::fmax(sin_i, sin_o);
  float tb = std::fmin(sin_i / std::fmax(ci, 1e-7f),
                       sin_o / std::fmax(co, 1e-7f));
  return A + B * std::fmax(cd, 0.0f) * sa * tb;
}

static void bsdf_eval(const Mat& m, V3 wi, V3 wo, V3& f, float& pdf) {
  f = {0, 0, 0}; pdf = 0;
  if (m.kind == B_DIFFUSE || m.kind == B_ROUGH_DIFFUSE) {
    if (wi.z <= 0 || wo.z <= 0) return;
    f = m.albedo * (wo.z / float(M_PI));
    if (m.kind == B_ROUGH_DIFFUSE) f = f * oren_nayar(m, wi, wo);
    pdf = wo.z / float(M_PI);
  } else if (m.kind == B_ROUGH_CONDUCTOR) {
    if (wi.z <= 0 || wo.z <= 0) return;
    V3 hm = norm(wi + wo);
    float D = ggx_d(hm.z, m.rough);
    float G = ggx_g2(wi.z, wo.z, m.rough);
    V3 F = fresnel_cond(std::fabs(dot(wi, hm)), m.eta, m.k);
    // f_r * cos(wo) = F D G / (4 cos_i)   (height-correlated Smith G2)
    f = F * (D * G / (4.0f * wi.z));
    pdf = D * hm.z / (4.0f * std::fabs(dot(wo, hm)) + 1e-12f);
  }
}
static BsdfSample bsdf_sample(const Mat& m, V3 wi, float u0, float u1, float u2) {
  BsdfSample s;
  (void)u0;
  if (m.kind == B_DIFFUSE || m.kind == B_ROUGH_DIFFUSE) {
    if (wi.z <= 0) return s;
    float r = std::sqrt(u1);
    float ph = 2 * float(M_PI) * u2;
    s.wo = {r * std::cos(ph), r * std::sin(ph), std::sqrt(std::fmax(1 - u1, 0.0f))};
    s.pdf = s.wo.z / float(M_PI);
    s.weight = m.albedo;
    if (m.kind == B_ROUGH_DIFFUSE) s.weight = s.weight * oren_nayar(m, wi, s.wo);
    return s;
  }
  if (m.kind == B_MIRROR || m.kind == B_CONDUCTOR) {
    if (wi.z <= 0) return s;
    s.wo = {-wi.x, -wi.y, wi.z};
    s.pdf = 1;
    s.delta = true;
    s.weight = m.kind == B_MIRROR ? m.albedo : fresnel_cond(wi.z, m.eta, m.k);
    return s;
  }
  if (m.kind == B_DIELECTRIC) {
    float eta = m.eta.x > 0 ? m.eta.x : 1.5f;
    bool outside = wi.z > 0;
    float e = outside ? eta : 1.0f / eta;
    float F = fresnel_diel(std::fabs(wi.z), e);
    s.delta = true;
    s.pdf = 1;
    if (u1 < F) {
      s.wo = {-wi.x, -wi.y, wi.z};
      s.weight = {1, 1, 1};
    } else {
      float inv = 1.0f / e;
      float s2 = (1 - wi.z * wi.z) * inv * inv;
      float cz = std::sqrt(std::fmax(1 - s2, 0.0f));
      s.wo = {-wi.x * inv, -wi.y * inv, outside ? -cz : cz};
      s.weight = {inv * inv, inv * inv, inv * inv};  // radiance scaling
      s.eta = e;
    }
    return s;
  }
  if (m.kind == B_ROUGH_CONDUCTOR) {
    if (wi.z <= 0) return s;
    // classic Walter NDF sampling of the half vector
    float a2 = m.rough * m.rough;
    float cm = std::sqrt(std::fmax((1 - u1) / (1 + (a2 - 1) * u1), 0.0f));
    float sm = std::sqrt(std::fmax(1 - cm * cm, 0.0f));
    float ph = 2 * float(M_PI) * u2;
    V3 hm = {sm * std::cos(ph), sm * std::sin(ph), cm};
    float wih = dot(wi, hm);
    s.wo = hm * (2.0f * wih) - wi;
    if (s.wo.z <= 0 || wih <= 0) return BsdfSample{};
    float D = ggx_d(cm, m.rough);
    s.pdf = D * cm / (4.0f * wih);
    V3 f;
    float pdf;
    bsdf_eval(m, wi, s.wo, f, pdf);
    if (s.pdf <= 0) return BsdfSample{};
    s.weight = f * (1.0f / s.pdf);
    return s;
  }
  if (m.kind == B_NULL) {
    s.wo = wi * -1.0f;
    s.pdf = 1; s.delta = true; s.weight = {1, 1, 1};
    return s;
  }
  return s;
}
static bool is_delta(const Mat& m) {
  return m.kind == B_MIRROR || m.kind == B_CONDUCTOR || m.kind == B_DIELECTRIC ||
         m.kind == B_NULL;
}

// ---------------------------------------------------------------- tracer
// PSS layout = integrators/layout.py: u[0:2] pixel, u[2:4] aperture,
// bounce b: base=4+9b: +0 light pick, +1:3 light uv, +3 bsdf cmp,
// +4:6 bsdf uv, +6 RR, +7:9 media (unused here).
struct TraceCfg {
  int max_depth = 6;
  int min_depth = 1;
  int rr_depth = 5;
  // strategy decomposition for cross-checks: both (MIS), nee-only, bsdf-only
  bool use_nee = true;
  bool use_bsdf_hit = true;
};
static const int SENSOR_DIMS = 4, BOUNCE_DIMS = 9;
static int n_dims(const TraceCfg& c) { return SENSOR_DIMS + c.max_depth * BOUNCE_DIMS; }

struct Splat {
  float u, v;
  V3 rgb;
};

static float mis2(float a, float b) {
  float a2 = a * a, b2 = b * b;
  return a2 + b2 > 0 ? a2 / (a2 + b2) : 0.0f;
}

static Splat trace(const Scene& sc, const TraceCfg& cfg, const float* u) {
  Splat out{u[0], u[1], {0, 0, 0}};
  // camera ray
  float x = (2 * u[0] - 1) * sc.thx, y = (1 - 2 * u[1]) * sc.thy;
  V3 dl = norm({x, y, 1});
  const float* c = sc.cam;
  V3 o = {c[3], c[7], c[11]};
  V3 d = norm({c[0] * dl.x + c[1] * dl.y + c[2] * dl.z,
               c[4] * dl.x + c[5] * dl.y + c[6] * dl.z,
               c[8] * dl.x + c[9] * dl.y + c[10] * dl.z});
  V3 tp = {1, 1, 1};
  float prev_pdf = 0;
  bool prev_delta = true;
  float eta_scale = 1;
  for (int depth = 1; depth <= cfg.max_depth; depth++) {
    const float* ub = u + SENSOR_DIMS + (depth - 1) * BOUNCE_DIMS;
    Hit h = intersect(sc, o, d);
    if (!h.valid) break;
    V3 p = o + d * h.t;
    V3 ns, ng;
    int mat_id, erow;
    if (h.sph >= 0) {
      const Sph& sp = sc.sphs[h.sph];
      ng = ns = norm(p - sp.c);
      mat_id = sp.mat;
      erow = -1;
    } else {
      const Tri& tr = sc.tris[h.tri];
      ns = norm(tr.n0 * (1 - h.b1 - h.b2) + tr.n1 * h.b1 + tr.n2 * h.b2);
      ng = tr.ng;
      mat_id = tr.mat;
      erow = tr.erow;
    }
    const Mat& m = sc.mats[mat_id];
    // emitted radiance (one-sided, front = geometric normal side)
    if (erow >= 0 && depth >= cfg.min_depth && dot(d, ng) < 0 &&
        (cfg.use_bsdf_hit || prev_delta)) {
      const ERow& e = sc.ems[erow];
      float w = 1.0f;
      if (!prev_delta && cfg.use_nee) {
        float cl = -dot(d, ng);
        float nee_pdf = e.pmf * (h.t * h.t) / std::fmax(cl * e.area, 1e-12f);
        w = mis2(prev_pdf, nee_pdf);
      }
      out.rgb = out.rgb + tp * e.rad * w;
    }
    // two-sided shading: orient shading frame toward the incident ray
    V3 nsh = ns;
    if (m.two_sided && dot(nsh, d) > 0) nsh = nsh * -1.0f;
    V3 wi = {0, 0, 0};
    {
      V3 t, b;
      basis(nsh, t, b);
      V3 w = d * -1.0f;
      wi = {dot(w, t), dot(w, b), dot(w, nsh)};
    }
    // NEE
    if (cfg.use_nee && !is_delta(m) && !sc.ems.empty() &&
        depth + 1 <= cfg.max_depth && depth + 1 >= cfg.min_depth) {
      float pick = ub[0] * sc.ems.back().cdf;
      size_t ei = 0;
      while (ei + 1 < sc.ems.size() && sc.ems[ei].cdf < pick) ei++;
      const ERow& e = sc.ems[ei];
      const Tri& lt = sc.tris[e.tri];
      float su = ub[1], sv = ub[2];
      float b1 = su, b2 = sv;  // uniform triangle via sqrt warp
      float r = std::sqrt(su);
      b1 = 1 - r;
      b2 = sv * r;
      V3 pl = lt.v0 + lt.e1 * b1 + lt.e2 * b2;
      V3 tol = pl - p;
      float d2 = dot(tol, tol);
      float dist = std::sqrt(std::fmax(d2, 1e-20f));
      V3 dl2 = tol * (1.0f / dist);
      float cl = -dot(dl2, lt.ng);
      if (cl > 1e-7f) {
        float pdf = e.pmf * d2 / std::fmax(cl * e.area, 1e-12f);
        V3 wol;
        {
          V3 t, b;
          basis(nsh, t, b);
          wol = {dot(dl2, t), dot(dl2, b), dot(dl2, nsh)};
        }
        V3 f;
        float fpdf;
        bsdf_eval(m, wi, wol, f, fpdf);
        if (lum(f) > 0 && pdf > 0) {
          V3 so = p + dl2 * (1e-4f * std::fmax(1.0f, h.t));
          if (!occluded(sc, so, dl2, dist * (1 - 1e-3f) - 1e-4f)) {
            float w = cfg.use_bsdf_hit ? mis2(pdf, fpdf) : 1.0f;
            out.rgb = out.rgb + tp * f * e.rad * (w / pdf);
          }
        }
      }
    }
    // BSDF sampling
    BsdfSample bs = bsdf_sample(m, wi, ub[3], ub[4], ub[5]);
    if (bs.pdf <= 0 || lum(bs.weight) <= 0) break;
    tp = tp * bs.weight;
    eta_scale *= bs.eta;
    prev_pdf = bs.pdf;
    prev_delta = bs.delta;
    V3 wow = to_world(nsh, bs.wo);
    o = p + wow * (1e-4f * std::fmax(1.0f, h.t));
    d = wow;
    // RR
    if (depth >= cfg.rr_depth) {
      float q = std::fmin(maxc(tp) * eta_scale * eta_scale, 0.95f);
      if (ub[6] >= q) break;
      tp = tp * (1.0f / std::fmax(q, 1e-8f));
    }
    if (lum(tp) <= 0) break;
  }
  return out;
}

// ------------------------------------------------- bidirectional / MMLT
// Scalar mirror of integrators/bidir.py trace_mmlt (multiplexed MLT,
// PathSampler::EMMLT in the reference): eye + light random walks carrying
// forward/reverse AREA pdfs, ONE selected (s, t) connection, balance-
// heuristic MIS via the ratio recursion.  Area emitters, surface-only
// (the Cornell parity scene).  Serves as (a) the measured CPU anchor for
// the flagship drmlt-mmlt benchmark and (b) an external mmlt image oracle
// for tests/test_oracle_parity.py.
static const int BD_MAXV = 24;  // max vertices per subpath (depth <= 23)

struct PVert {
  V3 p, ns, ng, wi, beta;
  float pdf_fwd = 0, pdf_rev = 0;
  bool delta = false;
  int mat = -1, erow = -1;
};

static inline float sa_to_area(float pdf_sa, V3 p_from, V3 p_to, V3 n_to) {
  V3 dd = p_to - p_from;
  float d2 = dot(dd, dd);
  if (d2 <= 1e-20f) return 0.0f;
  V3 w = dd * (1.0f / std::sqrt(d2));
  return pdf_sa * std::fabs(dot(w, n_to)) / d2;
}
static inline double pratio(float p_num, float p_den) {
  return double(p_num > 0 ? p_num : 1.0f) / double(p_den > 0 ? p_den : 1.0f);
}

// raw f (no cosine) + solid-angle pdf for world directions; the frame is
// oriented toward the incident direction (mirrors _bsdf_eval_pdf plus the
// JAX same_side two-sided semantics)
static void bsdf_eval_world(const Mat& m, V3 ns, V3 wi_w, V3 wo_w,
                            V3& f, float& pdf) {
  V3 nsh = ns;
  if (m.two_sided && dot(nsh, wi_w) < 0) nsh = nsh * -1.0f;
  V3 t, b;
  basis(nsh, t, b);
  V3 wi = {dot(wi_w, t), dot(wi_w, b), dot(wi_w, nsh)};
  V3 wo = {dot(wo_w, t), dot(wo_w, b), dot(wo_w, nsh)};
  V3 fc;
  float p;
  bsdf_eval(m, wi, wo, fc, p);
  float aco = std::fmax(std::fabs(wo.z), 1e-9f);
  f = fc * (1.0f / aco);
  pdf = p;
}

// Walk up to n_surf surface vertices from a start ray (mirrors
// bidir.py _walk): fills out[0..] with consecutive reached vertices and
// returns their count.  u = 3 PSS dims per step (component, 2D); the last
// reached vertex samples nothing.  *src_rev gets the reverse-chain area
// pdf of the source endpoint (pdf of the endpoint from vertex 1).
static int bd_walk(const Scene& sc, V3 o, V3 d, V3 beta, float pdf_sa,
                   V3 prev_p, V3 prev_ns, int n_surf, const float* u,
                   bool importance_mode, PVert* out, float* src_rev) {
  *src_rev = 0;
  for (int k = 0; k < n_surf; k++) {
    Hit h = intersect(sc, o, d);
    if (!h.valid) return k;
    V3 p = o + d * h.t, ns, ng;
    int mat_id, erow;
    if (h.sph >= 0) {
      const Sph& sp = sc.sphs[h.sph];
      ng = ns = norm(p - sp.c);
      mat_id = sp.mat;
      erow = -1;
    } else {
      const Tri& tr = sc.tris[h.tri];
      ns = norm(tr.n0 * (1 - h.b1 - h.b2) + tr.n1 * h.b1 + tr.n2 * h.b2);
      ng = tr.ng;
      mat_id = tr.mat;
      erow = tr.erow;
    }
    const Mat& m = sc.mats[mat_id];
    PVert& v = out[k];
    v.p = p; v.ns = ns; v.ng = ng;
    v.wi = d * -1.0f;
    v.beta = beta;
    v.pdf_fwd = sa_to_area(pdf_sa, prev_p, p, ng);
    v.pdf_rev = 0;
    v.delta = is_delta(m);
    v.mat = mat_id;
    v.erow = erow;
    if (k + 1 >= n_surf) return k + 1;  // final vertex samples nothing
    // continuation in the incident-oriented frame
    V3 nsh = ns;
    if (m.two_sided && dot(nsh, v.wi) < 0) nsh = nsh * -1.0f;
    V3 tx, bx;
    basis(nsh, tx, bx);
    V3 wi = {dot(v.wi, tx), dot(v.wi, bx), dot(v.wi, nsh)};
    BsdfSample bs = bsdf_sample(m, wi, u[3 * k], u[3 * k + 1], u[3 * k + 2]);
    if (bs.pdf <= 0 || lum(bs.weight) <= 0) return k + 1;
    V3 wo_w = tx * bs.wo.x + bx * bs.wo.y + nsh * bs.wo.z;
    // reverse pdf of the previous vertex (sample wi from wo here);
    // Dirac kinds store rev pdf 1*conversion, mirroring the forward
    // pdf_sa convention below (matches the JAX _walk semantics; fixes
    // the delta-chain MIS bias)
    {
      V3 fr;
      float rev_sa;
      bsdf_eval(m, bs.wo, wi, fr, rev_sa);
      if (bs.delta) rev_sa = 1.0f;
      float rev_area = sa_to_area(rev_sa, p, prev_p, prev_ns);
      if (k == 0) *src_rev = rev_area;
      else out[k - 1].pdf_rev = rev_area;
    }
    V3 beta_next = beta * bs.weight;
    if (importance_mode) {  // shading-normal correction (Veach 5.17)
      float num = std::fabs(dot(v.wi, ns)) * std::fabs(dot(wo_w, ng));
      float den = std::fabs(dot(v.wi, ng)) * std::fabs(dot(wo_w, ns));
      if (den > 0) beta_next = beta_next * (num / den);
    }
    if (lum(beta_next) <= 0) return k + 1;
    o = p + wo_w * (1e-4f * std::fmax(1.0f, h.t));
    d = wo_w;
    beta = beta_next;
    pdf_sa = bs.delta ? 1.0f : bs.pdf;  // delta: unit pdf in the chain
    prev_p = p;
    prev_ns = ns;
  }
  return n_surf;
}

struct Cam {
  V3 o, left, up, fwd;
  float thx, thy, A;
};
static Cam cam_of(const Scene& sc) {
  const float* c = sc.cam;
  Cam cm;
  cm.o = {c[3], c[7], c[11]};
  cm.left = {c[0], c[4], c[8]};
  cm.up = {c[1], c[5], c[9]};
  cm.fwd = {c[2], c[6], c[10]};
  cm.thx = sc.thx;
  cm.thy = sc.thy;
  cm.A = 4.0f * sc.thx * sc.thy;
  return cm;
}
// p(w) = 1/(A cos^3) for a uniform film point (bidir.py sensor_pdf_dir)
static float sensor_pdf_dir_o(const Cam& cm, V3 d) {
  float c = dot(d, cm.fwd);
  return c > 1e-6f ? 1.0f / (cm.A * c * c * c) : 0.0f;
}
// We = 1/(A cos^4) + film uv for a direction leaving the camera
static bool sensor_importance_o(const Cam& cm, V3 d, float& we,
                                float& u, float& v) {
  float c = dot(d, cm.fwd);
  we = 0;
  if (c <= 1e-6f) return false;
  float inv = 1.0f / c;
  float xc = dot(d, cm.left) * inv, yc = dot(d, cm.up) * inv;
  u = (xc / cm.thx + 1.0f) * 0.5f;
  v = (1.0f - yc / cm.thy) * 0.5f;
  if (u < 0 || u >= 1 || v < 0 || v >= 1) return false;
  we = 1.0f / (cm.A * c * c * c * c);
  return true;
}

// area pdf at p_to of the emitter's cosine-lobe direction sampling
static float emission_dir_pdf_area_o(const PVert& l, V3 p_to, V3 n_to) {
  V3 dd = p_to - l.p;
  float d2 = dot(dd, dd);
  if (d2 <= 1e-20f) return 0;
  V3 w = dd * (1.0f / std::sqrt(d2));
  float cl = std::fmax(dot(w, l.ng), 0.0f);
  return (cl / float(M_PI)) * std::fabs(dot(w, n_to)) / d2;
}

// PSS layout = integrators/mmlt.py: [depth(pinned), strategy(frozen),
// eye dims, light dims, (pad to even)]
static int mmlt_eye_dims(int D) { return 2 + 3 * (D - 1); }
static int mmlt_light_dims(int D) { return 5 + 3 * (D >= 2 ? D - 2 : 0); }
static int mmlt_dims(int D) {
  int n = 2 + mmlt_eye_dims(D) + mmlt_light_dims(D);
  return n + (n & 1);
}

static Splat trace_mmlt_o(const Scene& sc, const Cam& cm, int D,
                          const float* u) {
  Splat out{u[2], u[3], {0, 0, 0}};
  if (sc.ems.empty()) return out;
  int depth = 1 + std::min(int(u[0] * D), D - 1);
  int n_strats = depth + 1;
  int s = std::min(int(u[1] * n_strats), depth);
  int t = depth + 1 - s;
  const float* ue = u + 2;
  const float* ul = u + 2 + mmlt_eye_dims(D);
  const float scale = float(n_strats) * float(D);

  // ---- eye subpath: camera endpoint + t-1 surface vertices -------------
  PVert Ev[BD_MAXV], Lv[BD_MAXV];
  Ev[0].p = cm.o;
  Ev[0].ns = Ev[0].ng = cm.fwd;
  Ev[0].wi = cm.fwd * -1.0f;
  Ev[0].beta = {1, 1, 1};
  Ev[0].pdf_fwd = 1;
  Ev[0].pdf_rev = 0;
  Ev[0].delta = true;  // positional Dirac
  if (t >= 2) {
    float x = (2 * ue[0] - 1) * cm.thx, y = (1 - 2 * ue[1]) * cm.thy;
    V3 dl = norm({x, y, 1});
    V3 d = norm(cm.left * dl.x + cm.up * dl.y + cm.fwd * dl.z);
    float dummy;
    int ne = 1 + bd_walk(sc, cm.o, d, {1, 1, 1}, sensor_pdf_dir_o(cm, d),
                         cm.o, cm.fwd, t - 1, ue + 2, true, Ev + 1, &dummy);
    if (ne < t) return out;  // walk died before the junction vertex
  }

  // ---- light subpath: emitter endpoint + s-1 bounce vertices -----------
  if (s >= 1) {
    float pick = ul[0] * sc.ems.back().cdf;
    size_t ei = 0;
    while (ei + 1 < sc.ems.size() && sc.ems[ei].cdf < pick) ei++;
    const ERow& e = sc.ems[ei];
    const Tri& lt = sc.tris[e.tri];
    float tq = std::sqrt(std::fmax(1.0f - ul[1], 0.0f));
    float b1 = 1.0f - tq, b2 = tq * ul[2];
    V3 p0 = lt.v0 + lt.e1 * b1 + lt.e2 * b2;
    V3 n0 = lt.ng;
    float pdf_pos = e.pmf / std::fmax(e.area, 1e-20f);
    Lv[0].p = p0;
    Lv[0].ns = Lv[0].ng = Lv[0].wi = n0;
    Lv[0].beta = e.rad * (1.0f / std::fmax(pdf_pos, 1e-20f));
    Lv[0].pdf_fwd = pdf_pos;
    Lv[0].pdf_rev = 0;
    Lv[0].delta = false;
    Lv[0].erow = int(ei);
    if (s >= 2) {
      float rr = std::sqrt(ul[3]);
      float ph = 2 * float(M_PI) * ul[4];
      V3 dloc = {rr * std::cos(ph), rr * std::sin(ph),
                 std::sqrt(std::fmax(1 - ul[3], 0.0f))};
      V3 d0 = to_world(n0, dloc);
      float pdf_dir = std::fmax(dloc.z / float(M_PI), 1e-12f);
      V3 beta1 = e.rad * (std::fmax(dloc.z, 0.0f) / (pdf_pos * pdf_dir));
      float src_rev;
      int nl = 1 + bd_walk(sc, p0 + d0 * 1e-3f, d0, beta1, pdf_dir, p0, n0,
                           s - 1, ul + 5, false, Lv + 1, &src_rev);
      Lv[0].pdf_rev = src_rev;
      if (nl < s) return out;
    }
  }

  // ---- selected strategy + junction pdfs --------------------------------
  float pL_s = 0, pL_s1 = 0, pE_t = 0, pE_t1 = 0;
  V3 contrib = {0, 0, 0};
  float su = out.u, sv = out.v;

  if (s == 0) {  // eye path's junction vertex IS the emitter
    const PVert& E1 = Ev[t - 1];
    if (E1.erow < 0) return out;
    if (dot(E1.wi, E1.ng) <= 0) return out;  // one-sided emission
    const ERow& eh = sc.ems[E1.erow];
    contrib = E1.beta * eh.rad;
    pL_s = eh.pmf / std::fmax(eh.area, 1e-20f);
    if (t >= 3) pL_s1 = emission_dir_pdf_area_o(E1, Ev[t - 2].p, Ev[t - 2].ng);
  } else {
    const PVert& L1 = Lv[s - 1];
    const PVert& E1 = Ev[t - 1];  // camera endpoint when t == 1
    V3 dvec = E1.p - L1.p;
    float d2 = dot(dvec, dvec);
    if (d2 <= 1e-12f) return out;
    float dist = std::sqrt(d2);
    V3 w_le = dvec * (1.0f / dist);
    if (t == 1) {  // light tracing
      if (L1.delta) return out;
      float we, fu, fv;
      if (!sensor_importance_o(cm, w_le * -1.0f, we, fu, fv)) return out;
      float cos_l = std::fabs(dot(w_le, L1.ng));
      float cos_c = std::fabs(dot(w_le, cm.fwd));
      float g = cos_l * cos_c / d2;
      V3 f_l;
      if (s == 1) {
        f_l = dot(w_le, L1.ng) > 0 ? V3{1, 1, 1} : V3{0, 0, 0};
      } else {
        float pdum;
        bsdf_eval_world(sc.mats[L1.mat], L1.ns, L1.wi, w_le, f_l, pdum);
      }
      contrib = L1.beta * f_l * (g * we);
      if (lum(contrib) <= 0) return out;
      V3 so = L1.p + w_le * (1e-4f * std::fmax(1.0f, dist));
      if (occluded(sc, so, w_le, dist * (1 - 1e-3f))) return out;
      pE_t = sa_to_area(sensor_pdf_dir_o(cm, w_le * -1.0f), E1.p, L1.p,
                        L1.ng);
      if (s >= 2) {
        V3 fr;
        float sa;
        bsdf_eval_world(sc.mats[L1.mat], L1.ns, w_le, L1.wi, fr, sa);
        pE_t1 = sa_to_area(sa, L1.p, Lv[s - 2].p, Lv[s - 2].ng);
      }
      su = fu;
      sv = fv;
    } else {  // general connection
      if (E1.delta) return out;
      if (s >= 2 && L1.delta) return out;
      float cos_l = std::fabs(dot(w_le, L1.ng));
      float cos_e = std::fabs(dot(w_le, E1.ng));
      float g = cos_l * cos_e / d2;
      V3 f_l;
      float pdf_l_fwd_sa = 0;
      if (s == 1) {  // area-emitter endpoint lobe (cos_l already in g)
        f_l = dot(w_le, L1.ng) > 0 ? V3{1, 1, 1} : V3{0, 0, 0};
      } else {
        bsdf_eval_world(sc.mats[L1.mat], L1.ns, L1.wi, w_le, f_l,
                        pdf_l_fwd_sa);
      }
      V3 f_e;
      float pdf_e_fwd_sa;
      bsdf_eval_world(sc.mats[E1.mat], E1.ns, E1.wi, w_le * -1.0f, f_e,
                      pdf_e_fwd_sa);
      contrib = L1.beta * f_l * f_e * E1.beta * g;
      if (lum(contrib) <= 0) return out;
      V3 so = L1.p + w_le * (1e-4f * std::fmax(1.0f, dist));
      if (occluded(sc, so, w_le, dist * (1 - 1e-3f))) return out;
      if (s == 1) pL_s = emission_dir_pdf_area_o(Lv[0], E1.p, E1.ng);
      else pL_s = sa_to_area(pdf_l_fwd_sa, L1.p, E1.p, E1.ng);
      if (t >= 3) {
        V3 fr;
        float sa;
        bsdf_eval_world(sc.mats[E1.mat], E1.ns, w_le * -1.0f, E1.wi, fr, sa);
        pL_s1 = sa_to_area(sa, E1.p, Ev[t - 2].p, Ev[t - 2].ng);
      }
      pE_t = sa_to_area(pdf_e_fwd_sa, E1.p, L1.p, L1.ng);
      if (s >= 2) {
        V3 fr;
        float sa;
        bsdf_eval_world(sc.mats[L1.mat], L1.ns, w_le, L1.wi, fr, sa);
        pE_t1 = sa_to_area(sa, L1.p, Lv[s - 2].p, Lv[s - 2].ng);
      }
    }
  }

  // ---- balance-heuristic MIS (ratio recursion, bidir.py _mis_weight) ---
  double sum_ri = 0, ri = 1;
  for (int i = s - 1; i >= 0; i--) {  // junction -> light
    float pE = (i == s - 1) ? pE_t : (i == s - 2) ? pE_t1 : Lv[i].pdf_rev;
    ri *= pratio(pE, Lv[i].pdf_fwd);
    bool d_lo = (i >= 2) ? Lv[i - 1].delta : false;
    if (!(d_lo || Lv[i].delta)) sum_ri += ri;
  }
  double rj = 1;
  for (int j = t - 1; j >= 1; j--) {  // junction -> camera
    float pL = (j == t - 1) ? pL_s : (j == t - 2) ? pL_s1 : Ev[j].pdf_rev;
    rj *= pratio(pL, Ev[j].pdf_fwd);
    bool d_hi = (j - 1 >= 1) ? Ev[j - 1].delta : false;
    if (!(Ev[j].delta || d_hi)) sum_ri += rj;
  }
  float w = float(1.0 / (1.0 + sum_ri));
  out.u = su;
  out.v = sv;
  out.rgb = contrib * (w * scale);
  return out;
}

// ---------------------------------------------------------------- film
struct Film {
  int W, H;
  std::vector<double> px;  // RGB accum
  explicit Film(int w, int h) : W(w), H(h), px(size_t(w) * h * 3, 0.0) {}
  void splat(float u, float v, V3 c, float w) {
    int xi = int(u * W);
    int yi = int(v * H);
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) return;
    size_t i = (size_t(yi) * W + xi) * 3;
    px[i] += double(c.x) * w;
    px[i + 1] += double(c.y) * w;
    px[i + 2] += double(c.z) * w;
  }
  void add(const Film& o) {
    for (size_t i = 0; i < px.size(); i++) px[i] += o.px[i];
  }
  void write_raw(const char* path, double scale) {
    FILE* f = fopen(path, "wb");
    for (double v : px) {
      float x = float(v * scale);
      fwrite(&x, 4, 1, f);
    }
    fclose(f);
  }
};

// ---------------------------------------------------------------- kernels
// constants = drmlt_sampler.h:201-206 via integrators/kernels.py
static const float S1 = 1.0f / 1024.0f, S2 = 1.0f / 64.0f;
static const float SIGMA = 1.0f / 64.0f, SCALE2 = 0.1f;
static const float RHO = std::exp(-0.25f), KSCALE = 1.9f;

static float kelemen_sample(Rng& rng, float s1, float s2) {
  float u = rng.uf();
  float sign = u < 0.5f ? 1.0f : -1.0f;
  float x = u < 0.5f ? 2 * u : 2 * (u - 0.5f);
  float log_ratio = -std::log(s2 / s1);
  return sign * s2 * std::exp((1 - x) * log_ratio);
}
static float gauss_sample(Rng& rng, float sigma) {
  float u1 = rng.uf(), u2 = rng.uf();
  float r = std::sqrt(-2.0f * std::log(std::fmax(1 - u1, 1e-38f)));
  return r * std::cos(2 * float(M_PI) * u2) * sigma;
}
static float wc_sample(Rng& rng, float rho) {
  float u = rng.uf();
  float sign = u < 0.5f ? 1.0f : -1.0f;
  float x = u < 0.5f ? 2 * u : 2 * (u - 0.5f);
  float disp = 2 * rho / (1 + rho * rho);
  float v = std::cos(2 * float(M_PI) * x);
  float ang = (v + disp) / (1 + disp * v);
  return sign * std::acos(std::fmin(std::fmax(ang, -1.0f), 1.0f));
}
static float kelemen_logpdf(float du, float s1, float s2) {
  float d = std::fabs(du);
  if (d < s1 || d > s2) return -87.0f;
  return -std::log(2 * d * std::log(s2 / s1));
}
static float wrap01(float y) {
  float t = std::fmod(y, 2.0f);
  if (t < 0) t += 2.0f;
  return t > 1.0f ? 2.0f - t : t;
}

// ---------------------------------------------------------------- MCMC
typedef std::function<Splat(const float*)> TraceFn;

struct MltResult {
  uint64_t mutations = 0;
  double b = 0;
  uint64_t boot = 0;
};

// MLT driver over an arbitrary trace(u) -> Splat.  mut_lo: first mutable
// dim (dims below it are pinned EXCEPT frozen_dim, which resamples only on
// large steps — the MMLT depth/strategy technique dims, integrators/mmlt.py).
// One worker: bootstrap NBOOT candidates, resample n_sub chain starts
// luminance-proportionally (the reference's per-work-unit seed pool —
// pinned MMLT depth dims get their budget ∝ b_k this way, matching
// drmlt.cpp's per-depth allocation), then round-robin mutations over the
// chain pool until `seconds` elapse.
static void run_chain(const Scene& sc, const TraceFn& tracef, int D,
                      int mut_lo, int frozen_dim, const std::string& type,
                      double seconds, uint64_t seed, Film& film,
                      MltResult& res, int n_sub = 64) {
  Rng rng(seed);
  std::vector<float> yv(D), zv(D), rv(D);
  // bootstrap: candidates + luminances for b and the start pool
  const int NBOOT = 4000;
  std::vector<float> cands(size_t(NBOOT) * D);
  std::vector<float> lums(NBOOT);
  double bsum = 0;
  for (int i = 0; i < NBOOT; i++) {
    float* c = &cands[size_t(i) * D];
    for (int j = 0; j < D; j++) c[j] = rng.uf();
    lums[i] = lum(tracef(c).rgb);
    bsum += lums[i];
  }
  res.b = bsum / NBOOT;
  res.boot = NBOOT;
  // systematic resampling of n_sub starts ∝ luminance
  std::vector<std::vector<float>> X(n_sub);
  std::vector<Splat> SX(n_sub);
  std::vector<float> LX(n_sub);
  {
    double step = bsum / n_sub;
    double pos = (0.5 + rng.uf() * 0.5) * step;
    double acc = 0;
    int i = 0;
    for (int c = 0; c < n_sub; c++) {
      while (i < NBOOT - 1 && acc + lums[i] < pos) acc += lums[i++];
      X[c].assign(cands.begin() + size_t(i) * D,
                  cands.begin() + size_t(i + 1) * D);
      pos += step;
    }
    for (int c = 0; c < n_sub; c++) {
      SX[c] = tracef(X[c].data());
      LX[c] = lum(SX[c].rgb);
      for (int tries = 0; tries < 10000 && LX[c] <= 0; tries++) {
        for (int j = 0; j < D; j++) X[c][j] = rng.uf();
        SX[c] = tracef(X[c].data());
        LX[c] = lum(SX[c].rgb);
      }
    }
  }
  const float P_LARGE = 0.3f;
  const bool is_pssmlt = type == "pssmlt";
  const bool is_green = type == "green", is_mira = type == "mira",
             is_orbital = type == "orbital";
  auto t0 = std::chrono::steady_clock::now();
  uint64_t muts = 0;
  while (true) {
    if ((muts & 1023) == 0) {
      double el = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0).count();
      if (el >= seconds) break;
    }
    std::vector<float>& x = X[muts % n_sub];
    Splat& sx = SX[muts % n_sub];
    float& Lx = LX[muts % n_sub];
    muts++;
    bool large = rng.uf() < P_LARGE;
    // ---- stage 1 (bold) --------------------------------------------------
    yv = x;  // pinned/frozen dims carry over
    if (large) {
      for (int j = mut_lo; j < D; j++) yv[j] = rng.uf();
      if (frozen_dim >= 0) yv[frozen_dim] = rng.uf();
    } else if (is_orbital) {
      for (int j = mut_lo; j + 1 < D; j += 2) {
        float dv = kelemen_sample(rng, S1 * KSCALE, S2 * KSCALE);
        float ang = rng.uf() * 2 * float(M_PI);
        yv[j] = wrap01(x[j] + dv * std::cos(ang));
        yv[j + 1] = wrap01(x[j + 1] + dv * std::sin(ang));
      }
    } else if (is_pssmlt || is_green || is_mira) {
      for (int j = mut_lo; j < D; j++)
        yv[j] = wrap01(x[j] + kelemen_sample(rng, S1, S2));
    }
    Splat sy = tracef(yv.data());
    float Ly = lum(sy.rgb);
    float a1 = Lx > 0 ? std::fmin(1.0f, Ly / Lx) : 1.0f;
    if (is_pssmlt) {
      // Veach-style two-state splat
      film.splat(sx.u, sx.v, sx.rgb * (Lx > 0 ? (1 - a1) / Lx : 0.0f), 1.0f);
      film.splat(sy.u, sy.v, sy.rgb * (Ly > 0 ? a1 / Ly : 0.0f), 1.0f);
      if (rng.uf() < a1) { x = yv; sx = sy; Lx = Ly; }
      continue;
    }
    // ---- DRMLT stage 2 on rejection (branchy like the reference) --------
    bool acc1 = rng.uf() < a1;
    float a2 = 0;
    float Lz = 0;
    Splat sz{0, 0, {0, 0, 0}};
    bool did2 = false;
    if (!acc1 && !large) {
      did2 = true;
      zv = x;  // pinned/frozen dims carry over
      if (is_orbital) {
        for (int j = mut_lo; j + 1 < D; j += 2) {
          float dx = yv[j] - x[j], dy = yv[j + 1] - x[j + 1];
          float nrm = std::sqrt(std::fmax(dx * dx + dy * dy, 1e-30f));
          float mu = std::atan2(-dy, -dx);
          float th = wc_sample(rng, RHO);
          zv[j] = wrap01(yv[j] + nrm * std::cos(th + mu));
          zv[j + 1] = wrap01(yv[j + 1] + nrm * std::sin(th + mu));
        }
      } else {
        for (int j = mut_lo; j < D; j++)
          zv[j] = wrap01(x[j] + gauss_sample(rng, SCALE2 * SIGMA));
      }
      sz = tracef(zv.data());
      Lz = lum(sz.rgb);
      float lr = Lx > 0 ? Lz / Lx : 0.0f;
      if (is_green) {
        rv = x;
        for (int j = mut_lo; j < D; j++)
          rv[j] = wrap01(zv[j] - (yv[j] - x[j]));
        Splat sr = tracef(rv.data());
        float Lr = lum(sr.rgb);
        float arev = Lz > 0 ? std::fmin(1.0f, Lr / Lz) : 1.0f;
        a2 = arev >= 1.0f ? 0.0f
                          : std::fmin(1.0f, lr * (1 - arev) / std::fmax(1 - a1, 1e-12f));
      } else if (is_mira) {
        float arev = Lz > 0 ? std::fmin(1.0f, Ly / Lz) : 1.0f;
        float lq = 0;
        for (int j = mut_lo; j < D; j++)
          lq += kelemen_logpdf(zv[j] - yv[j], S1, S2) -
                kelemen_logpdf(x[j] - yv[j], S1, S2);
        a2 = arev >= 1.0f ? 0.0f
                          : std::fmin(1.0f, lr * std::exp(lq) * (1 - arev) /
                                                std::fmax(1 - a1, 1e-12f));
      } else {  // orbital, Eq. 11
        if (Lz < Ly) a2 = 0;
        else if (Lz >= Lx) a2 = 1;
        else {
          float den = Lx - Ly;
          a2 = den != 0 ? std::fmin(1.0f, std::fmax((Lz - Ly) / den, 0.0f)) : 0.0f;
        }
      }
      if (Lz <= 0) a2 = 0;
    }
    // three-state splat (Fig. 10)
    float wy = a1, wz = (1 - a1) * a2, wx = 1 - wy - wz;
    if (Lx > 0) film.splat(sx.u, sx.v, sx.rgb * (wx / Lx), 1.0f);
    if (Ly > 0) film.splat(sy.u, sy.v, sy.rgb * (wy / Ly), 1.0f);
    if (did2 && Lz > 0) film.splat(sz.u, sz.v, sz.rgb * (wz / Lz), 1.0f);
    if (acc1) { x = yv; sx = sy; Lx = Ly; }
    else if (did2 && rng.uf() < a2) { x = zv; sx = sz; Lx = Lz; }
  }
  res.mutations = muts;
}

// ---------------------------------------------------------------- main
int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: cpu_oracle pt|mlt scene.bin out.raw ...\n");
    return 2;
  }
  Scene sc;
  if (!load_scene(argv[2], sc)) {
    fprintf(stderr, "bad scene %s\n", argv[2]);
    return 1;
  }
  bvh_build(sc);
  std::string mode = argv[1];
  if (mode == "pt") {
    const char* out = argv[3];
    long spp = argc > 4 ? atol(argv[4]) : 64;
    TraceCfg cfg;
    cfg.max_depth = argc > 5 ? atoi(argv[5]) : 6;
    if (argc > 6) {
      std::string strat = argv[6];
      cfg.use_nee = strat != "bsdf";
      cfg.use_bsdf_hit = strat != "nee";
    }
    int T = int(std::thread::hardware_concurrency());
    uint64_t total = uint64_t(spp) * sc.W * sc.H;
    std::vector<Film> films;
    films.reserve(T);
    for (int i = 0; i < T; i++) films.emplace_back(sc.W, sc.H);
    auto t0 = std::chrono::steady_clock::now();
    std::vector<std::thread> ths;
    for (int ti = 0; ti < T; ti++)
      ths.emplace_back([&, ti] {
        Rng rng(0x1234 + ti * 7919);
        std::vector<float> u(n_dims(cfg));
        uint64_t n = total / T;
        for (uint64_t i = 0; i < n; i++) {
          for (auto& uu : u) uu = rng.uf();
          Splat s = trace(sc, cfg, u.data());
          films[ti].splat(s.u, s.v, s.rgb, 1.0f);
        }
      });
    for (auto& t : ths) t.join();
    for (int i = 1; i < T; i++) films[0].add(films[i]);
    double el = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0).count();
    uint64_t done = (total / T) * T;
    films[0].write_raw(out, double(sc.W) * sc.H / double(done));
    printf("{\"mode\": \"pt\", \"paths\": %llu, \"seconds\": %.3f, "
           "\"paths_per_sec\": %.0f, \"threads\": %d}\n",
           (unsigned long long)done, el, done / el, T);
  } else if (mode == "mlt") {
    // cpu_oracle mlt scene.bin out.raw <type> <seconds> <max_depth>
    //            [threads] [path|mmlt]
    const char* out = argv[3];
    std::string type = argc > 4 ? argv[4] : "orbital";
    double seconds = argc > 5 ? atof(argv[5]) : 5.0;
    TraceCfg cfg;
    cfg.max_depth = argc > 6 ? atoi(argv[6]) : 6;
    int T = argc > 7 ? atoi(argv[7]) : int(std::thread::hardware_concurrency());
    std::string tech = argc > 8 ? argv[8] : "path";
    Cam cm = cam_of(sc);
    TraceFn tf;
    int D, mut_lo = 0, frozen = -1;
    if (tech == "mmlt") {
      D = mmlt_dims(cfg.max_depth);
      mut_lo = 2;   // dim 0 = depth (pinned), dim 1 = strategy (frozen)
      frozen = 1;
      int md = cfg.max_depth;
      tf = [&sc, cm, md](const float* u) { return trace_mmlt_o(sc, cm, md, u); };
    } else {
      D = n_dims(cfg);
      tf = [&sc, &cfg](const float* u) { return trace(sc, cfg, u); };
    }
    std::vector<Film> films;
    films.reserve(T);
    for (int i = 0; i < T; i++) films.emplace_back(sc.W, sc.H);
    std::vector<MltResult> res(T);
    auto t0 = std::chrono::steady_clock::now();
    std::vector<std::thread> ths;
    for (int ti = 0; ti < T; ti++)
      ths.emplace_back([&, ti] {
        run_chain(sc, tf, D, mut_lo, frozen, type, seconds,
                  0xBEEF + ti * 104729, films[ti], res[ti]);
      });
    for (auto& t : ths) t.join();
    double el = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0).count();
    uint64_t muts = 0;
    double b = 0;
    for (int i = 0; i < T; i++) { muts += res[i].mutations; b += res[i].b; }
    b /= T;
    for (int i = 1; i < T; i++) films[0].add(films[i]);
    // splat film is normalized: each mutation contributes unit luminance
    films[0].write_raw(out, b * double(sc.W) * sc.H / double(muts));
    printf("{\"mode\": \"mlt\", \"type\": \"%s\", \"technique\": \"%s\", "
           "\"mutations\": %llu, "
           "\"seconds\": %.3f, \"mutations_per_sec\": %.0f, "
           "\"mutations_per_sec_per_core\": %.0f, \"threads\": %d, "
           "\"b\": %.6g}\n",
           type.c_str(), tech.c_str(), (unsigned long long)muts, el,
           muts / el, muts / el / T, T, b);
  } else if (mode == "mmltmc") {
    // uniform-PSS Monte Carlo over the MMLT estimator (image parity):
    // cpu_oracle mmltmc scene.bin out.raw <spp> <max_depth>
    const char* out = argv[3];
    long spp = argc > 4 ? atol(argv[4]) : 64;
    int max_depth = argc > 5 ? atoi(argv[5]) : 6;
    Cam cm = cam_of(sc);
    int D = mmlt_dims(max_depth);
    int T = int(std::thread::hardware_concurrency());
    uint64_t total = uint64_t(spp) * sc.W * sc.H;
    std::vector<Film> films;
    films.reserve(T);
    for (int i = 0; i < T; i++) films.emplace_back(sc.W, sc.H);
    auto t0 = std::chrono::steady_clock::now();
    std::vector<std::thread> ths;
    for (int ti = 0; ti < T; ti++)
      ths.emplace_back([&, ti] {
        Rng rng(0x5151 + ti * 7919);
        std::vector<float> u(D);
        uint64_t n = total / T;
        for (uint64_t i = 0; i < n; i++) {
          for (auto& uu : u) uu = rng.uf();
          Splat s = trace_mmlt_o(sc, cm, max_depth, u.data());
          films[ti].splat(s.u, s.v, s.rgb, 1.0f);
        }
      });
    for (auto& t : ths) t.join();
    for (int i = 1; i < T; i++) films[0].add(films[i]);
    double el = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0).count();
    uint64_t done = (total / T) * T;
    films[0].write_raw(out, double(sc.W) * sc.H / double(done));
    printf("{\"mode\": \"mmltmc\", \"samples\": %llu, \"seconds\": %.3f, "
           "\"samples_per_sec\": %.0f, \"threads\": %d}\n",
           (unsigned long long)done, el, done / el, T);
  } else {
    fprintf(stderr, "unknown mode %s\n", mode.c_str());
    return 2;
  }
  return 0;
}
