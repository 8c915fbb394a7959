// Device code shared by the render kernels (regen_render.cu,
// compact_render.cu, stream_render.cu) and the train kernels
// (train_render.cu, stream_train.cu): vector math, the device-exact f32
// functions, the Threefry streams, the camera, the scene as a kernel sees
// it, the two closest-hit tests (the brute-force scan and the stream block
// walk), one bounce's scatter and the trace of one sample's path. One
// copy, so that a train kernel's forward and the compact kernel's bounces
// are the regen kernel's arithmetic bit for bit. The f64 kernel
// (f64_render.cu) takes only the f32 draws from here.
//
// Exactness. Every expression keeps the association of the plain PyTorch
// versions (ops/tracer.py, ops/render_kernel.py:regen_reference,
// ops/stream_kernel.py:stream_reference) and of the JAX kernels. The build
// uses --fmad=false and no fast math, and sqrt, rsqrt, sin and cos are the
// fixed IEEE sequences of ops/f32math.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr float kTMin = 1.0e-3f;
constexpr float kTMiss = 1.0e30f;
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);
// scene SoA columns (the packed matrix's first 11)
enum { kCx, kCy, kCz, kRadius, kAlbR, kAlbG, kAlbB, kFuzz, kIor, kMat,
       kActive, kNumCols };
// gather columns staged in shared memory after the float4 scan table
constexpr int kGather = 7;  // radius, albedo rgb, fuzz, ior, mat
constexpr int kDrawScatter = 0, kDrawCoin = 1, kDrawRR = 2;
constexpr int kDrawJitter = 4, kDrawDefocus = 5;

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
// The device-exact f32 math of ops/f32math.py: sqrtf is the correctly
// rounded sqrt; rsqrt is 1/sqrt in double, rounded; sin/cos are glibc's
// sinf/cosf algorithm (reduction by pi/2 and a polynomial in double).
__device__ __forceinline__ float rsqrt_f32(float x) { return (float)(1.0 / sqrt((double)x)); }

__device__ __forceinline__ double sincos_poly(double x, double x2, bool odd, double cs) {
  if (!odd) {
    const double x3 = x * x2;
    const double s1 = 0x1.1107605230bc4p-7 + x2 * -0x1.994eb3774cf24p-13;
    const double x7 = x3 * x2;
    return (x + x3 * -0x1.555545995a603p-3) + x7 * s1;
  }
  const double x4 = x2 * x2;
  const double c2 = cs * -0x1.6c087e89a359dp-10 + x2 * (cs * 0x1.99343027bf8c3p-16);
  const double c1 = cs * 1.0 + x2 * (cs * -0x1.ffffffd0c621cp-2);
  const double x6 = x4 * x2;
  return (c1 + x4 * (cs * 0x1.55553e1068f19p-5)) + x6 * c2;
}

// valid for |y| < 120 (the samplers pass angles in [0, 2 pi))
__device__ __forceinline__ float sincos_f32(float y, bool cos) {
  const double x = y;
  const uint32_t bits = __float_as_uint(y) & 0x7fffffffu;
  if (bits < 0x39800000u) return cos ? 1.0f : y;  // |y| < 2^-12
  if ((bits >> 20) < (0x3F490FDBu >> 20)) return (float)sincos_poly(x, x * x, cos, 1.0);
  const int n = ((int32_t)(x * 0x1.45F306DC9C883p+23) + 0x800000) >> 24;
  const double r = x - (double)n * 0x1.921FB54442D18p0;
  const double sign = ((n + 1) & 2) ? -1.0 : 1.0;
  const int quad = cos ? (n ^ 1) : n;
  return (float)sincos_poly(r * sign, r * r, quad & 1, (n & 2) ? -1.0 : 1.0);
}

// unit(v) = v * rsqrt(max(|v|^2, 1e-30))
__device__ __forceinline__ V3 unit(V3 v) { return v * rsqrt_f32(fmaxf(dot(v, v), 1e-30f)); }
__device__ __forceinline__ V3 reflect(V3 v, V3 n) { return v - n * (2.0f * dot(v, n)); }

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// 20-round Threefry-2x32, bit-equal to ops/rng.py:threefry2x32.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t c0,
                                         uint32_t c1, uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[g & 1][r]);
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
  o0 = x0;
  o1 = x1;
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

struct Stream {
  uint32_t k0, k1, pixel;
  __device__ __forceinline__ void uniform2(uint32_t sample, uint32_t bounce,
                                           uint32_t draw, float& u0, float& u1) const {
    uint32_t b0, b1;
    threefry(k0, k1, pixel, (sample << 11) | (bounce << 3) | draw, b0, b1);
    u0 = unit_float(b0);
    u1 = unit_float(b1);
  }
  // the scatter draw: uniform on S^2 by inversion (rng.random_unit_vector)
  __device__ __forceinline__ V3 unit_vector(uint32_t sample, uint32_t bounce) const {
    float u0, u1;
    uniform2(sample, bounce, kDrawScatter, u0, u1);
    const float z = 1.0f - 2.0f * u0;
    const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
    const float phi = kTwoPi * u1;
    return {r * sincos_f32(phi, true), r * sincos_f32(phi, false), z};
  }
};

struct Cam {
  V3 pixel00, du, dv, center, disk_u, disk_v;
  bool defocus;
};

__device__ __forceinline__ Cam load_cam(const float* c) {
  Cam cam;
  cam.pixel00 = {c[0], c[1], c[2]};
  cam.du = {c[3], c[4], c[5]};
  cam.dv = {c[6], c[7], c[8]};
  cam.center = {c[9], c[10], c[11]};
  cam.disk_u = {c[12], c[13], c[14]};
  cam.disk_v = {c[15], c[16], c[17]};
  cam.defocus = c[18] > 0.5f;
  return cam;
}

// The primary ray's draws: pixel jitter (u0, u1) and the defocus disk
// point (px, py) (tracer.primary_ray_draws).
__device__ __forceinline__ void primary_draws(const Stream& st, uint32_t s, float& u0,
                                              float& u1, float& px, float& py) {
  float v0, v1;
  st.uniform2(s, 0, kDrawJitter, u0, u1);
  st.uniform2(s, 0, kDrawDefocus, v0, v1);
  const float r = sqrtf(v0);
  const float theta = kTwoPi * v1;
  px = r * sincos_f32(theta, true);
  py = r * sincos_f32(theta, false);
}

// Jittered, defocus-blurred primary ray (ops/tracer.py:primary_rays_from_ij).
__device__ __forceinline__ void primary_ray(const Cam& cam, float fi, float fj,
                                            const Stream& st, uint32_t s, V3& o,
                                            V3& d) {
  float u0, u1, px, py;
  primary_draws(st, s, u0, u1, px, py);
  const float ox = u0 - 0.5f, oy = u1 - 0.5f;
  const V3 sample_pt = cam.pixel00 + cam.du * (fi + ox) + cam.dv * (fj + oy);
  o = cam.defocus ? cam.center + cam.disk_u * px + cam.disk_v * py : cam.center;
  d = sample_pt - o;
}

// Blue-to-white gradient: lerp(0.5 * (unit(d).y + 1), white, blue).
__device__ __forceinline__ V3 sky(V3 d) {
  const float uy = d.y * rsqrt_f32(fmaxf(dot(d, d), 1e-30f));
  const float a = 0.5f * (uy + 1.0f);
  const float w = 1.0f - a;
  return {w * 1.0f + 0.5f * a, w * 1.0f + 0.7f * a, w * 1.0f + 1.0f * a};
}

__device__ __forceinline__ float schlick(float cosine, float ri) {
  float r0 = (1.0f - ri) / (1.0f + ri);
  r0 = r0 * r0;
  const float m = 1.0f - cosine;
  const float m2 = m * m;
  return r0 + (1.0f - r0) * (m * (m2 * m2));  // m**5 as lax.integer_pow lowers it
}

// One slot's scan entry: (cx, cy, cz, c2r2), c2r2 = NaN when inactive so
// that its discriminant is NaN and the slot never hits.
__device__ __forceinline__ float4 scan_entry(const float* scene, int n, int k) {
  const float cx = scene[kCx * n + k], cy = scene[kCy * n + k], cz = scene[kCz * n + k];
  const float r = scene[kRadius * n + k];
  const float c2r2 = cx * cx + cy * cy + cz * cz - r * r;
  return make_float4(cx, cy, cz,
                     scene[kActive * n + k] > 0.5f ? c2r2 : __int_as_float(0x7fffffff));
}

// The scene as a kernel sees it. layout='vmem' stages a float4 scan table
// and the seven gather columns in shared memory (44 bytes a slot);
// layout='hbm' reads the SoA in device memory.
struct SceneView {
  const float* soa;    // (kNumCols, n) in device memory
  const float4* scan;  // vmem: the shared scan table
  const float* gath;   // gather columns: shared (vmem) or soa + kRadius * n (hbm)
  int n;
  // gathered columns: 0 radius, 1-3 albedo rgb, 4 fuzz, 5 ior, 6 mat
  __device__ __forceinline__ float col(int c, int k) const { return gath[c * n + k]; }
};

// All threads of the block stage the scene, then the caller syncs.
__device__ __forceinline__ void stage_scene(const float* soa, int n, float4* scan,
                                            float* gath) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    scan[k] = scan_entry(soa, n, k);
#pragma unroll
    for (int c = 0; c < kGather; ++c) gath[c * n + k] = soa[(kRadius + c) * n + k];
  }
}

template <bool kHbm>
__device__ __forceinline__ float4 slot_entry(const SceneView& sc, int k) {
  return kHbm ? scan_entry(sc.soa, sc.n, k) : sc.scan[k];
}

template <bool kHbm>
__device__ __forceinline__ V3 slot_center(const SceneView& sc, int k) {
  if (kHbm) return {sc.soa[kCx * sc.n + k], sc.soa[kCy * sc.n + k], sc.soa[kCz * sc.n + k]};
  const float4 e = sc.scan[k];
  return {e.x, e.y, e.z};
}

// One slot's hit test in the numerator domain (ops/intersect.py): keeps
// the smallest root numerator with a strict '<', so the first slot wins an
// exact tie.
__device__ __forceinline__ void test_slot(const float4 e, V3 o, V3 d, float a,
                                          float d_dot_o, float o2, float tmin_a, int k,
                                          float& best, int& win) {
  const float h = (e.x * d.x + e.y * d.y + e.z * d.z) - d_dot_o;
  const float cc = (e.w + o2) - 2.0f * (e.x * o.x + e.y * o.y + e.z * o.z);
  const float disc = h * h - a * cc;
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float near = h - sq;
    const float root = near > tmin_a ? near : h + sq;
    if (root > tmin_a && root < best) {
      best = root;
      win = k;
    }
  }
}

// The closest hit over every slot of a SceneView (the regen and train
// kernels): true on a hit, with the winning slot and t = numerator / a.
template <bool kHbm_>
struct ScanHit {
  static constexpr bool kHbm = kHbm_;
  SceneView sc;
  __device__ __forceinline__ bool operator()(V3 o, V3 d, int& win, float& t) const {
    const float a = fmaxf(dot(d, d), 1e-12f);
    const float d_dot_o = dot(d, o);
    const float o2 = dot(o, o);
    const float tmin_a = kTMin * a;
    float best = kTMiss;
    win = 0;
    for (int k = 0; k < sc.n; ++k)
      test_slot(slot_entry<kHbm>(sc, k), o, d, a, d_dot_o, o2, tmin_a, k, best, win);
    if (!(best < kTMiss)) return false;
    t = best * (1.0f / a);
    return true;
  }
};

// Can the ray improve on t_cur inside a block's bound sphere b = (centre,
// radius)? The half-b quadratic against the bound, as
// pallas_stream.py:_block_bound_any_hit tests it for one lane:
// [t_near, t_far] must overlap (T_MIN, t_cur). Conservative: the bounds
// carry slack (prepare_stream_scene), so a block that could improve is
// never skipped.
__device__ __forceinline__ bool bound_can_improve(const float4 b, V3 o, V3 d, float a,
                                                  float d_dot_o, float o2, float t_cur) {
  const float cdx = b.x * d.x + b.y * d.y + b.z * d.z;
  const float cdo = b.x * o.x + b.y * o.y + b.z * o.z;
  const float h = cdx - d_dot_o;
  const float c2r2 = b.x * b.x + b.y * b.y + b.z * b.z - b.w * b.w;
  const float c = (c2r2 + o2) - 2.0f * cdo;
  const float disc = h * h - a * c;
  if (!(disc > 0.0f)) return false;
  const float sq = sqrtf(disc);
  return h + sq > kTMin * a && h - sq < t_cur * a && b.w > 0.0f;
}

// The stream walk's closest hit (stream_render.cu, stream_train.cu): the
// bounds rows in their order (Morton, or front to back from the camera);
// each row gives its block's bound sphere and first matrix row. A block is
// opened only if this thread's ray can improve inside the bound; within a
// block the smallest root numerator wins (first row on a tie); across
// blocks a block's hit replaces the best only when t_b < t_cur, so a tie
// between blocks goes to the block visited first. The gate is per thread:
// a warp runs a block's loop once if any lane opens it either way, and a
// per-lane gate makes the merge decisions the plain version's lane by lane.
// With kCount, `opened` counts the blocks the thread opened.
template <bool kCount>
struct WalkHit {
  static constexpr bool kHbm = true;
  SceneView sc;         // the stream matrix as SoA (kNumCols, rows)
  const float* bounds;  // (nb, 8): cx, cy, cz, r_bound, first row, unused
  int nb, block;
  mutable int opened = 0;
  __device__ __forceinline__ bool operator()(V3 o, V3 d, int& win, float& t) const {
    const float a = fmaxf(dot(d, d), 1e-12f);
    const float d_dot_o = dot(d, o);
    const float o2 = dot(o, o);
    const float tmin_a = kTMin * a;
    const float4* rows = reinterpret_cast<const float4*>(bounds);
    float t_cur = kTMiss;
    win = 0;
    for (int j = 0; j < nb; ++j) {
      if (!bound_can_improve(__ldg(rows + 2 * j), o, d, a, d_dot_o, o2, t_cur)) continue;
      if (kCount) ++opened;
      const int k0 = (int)__ldg(bounds + 8 * j + 4);
      float best = kTMiss;
      int wb = 0;
      for (int k = k0; k < k0 + block; ++k)
        test_slot(scan_entry(sc.soa, sc.n, k), o, d, a, d_dot_o, o2, tmin_a, k, best, wb);
      const float t_b = best * (1.0f / a);
      if (best < kTMiss && t_b < t_cur) {
        t_cur = t_b;
        win = wb;
      }
    }
    if (!(t_cur < kTMiss)) return false;
    t = t_cur;
    return true;
  }
};

// Gamma 2 of a finished pixel: sqrt of positive values, 0 at black.
__device__ __forceinline__ V3 gamma2(V3 v) {
  return {v.x > 0.0f ? sqrtf(v.x) : 0.0f, v.y > 0.0f ? sqrtf(v.y) : 0.0f,
          v.z > 0.0f ? sqrtf(v.z) : 0.0f};
}

// The state entering one bounce and its winning slot (-1 on a miss): one
// entry of the train kernels' per-thread residual stack.
struct Entry {
  V3 o, d, atten;
  int slot;
};

// How a sample's path ended: at bounce `bounce`, by a miss (contrib =
// atten * sky, the radiance it banks) or black (absorbed, the depth cap,
// Russian roulette).
struct PathEnd {
  int bounce;
  bool missed;
  V3 contrib;
};

// Bounce b of sample s after a hit on slot `win` at t: the hit point, the
// oriented normal and the material's scatter from this bounce's draws. A
// scatter at bounce max_depth-1 exits black; from rr_start on (>= 0),
// Russian roulette keeps a path with p = clip(max channel, 0.05, 1) and
// weights survivors by 1/p. Returns false when the path ends black here;
// else moves (o, d, atten) to the scattered ray.
template <bool kHbm>
__device__ __forceinline__ bool scatter_bounce(const SceneView& sc, const Stream& st,
                                               uint32_t s, int b, int max_depth,
                                               int rr_start, int win, float t, V3& o,
                                               V3& d, V3& atten) {
  const V3 hp = o + d * t;
  const V3 center = slot_center<kHbm>(sc, win);
  const float radius = sc.col(0, win);
  const float rs = fabsf(radius) > 1e-12f ? radius : 1e-12f;
  const V3 outward = (hp - center) * (1.0f / rs);
  const bool front = dot(d, outward) < 0.0f;
  const V3 normal = front ? outward : -outward;
  const int mat = (int)sc.col(6, win);

  V3 dir, att;
  bool scattered = true;
  if (mat == 0 || mat == 1) {
    const V3 ur = st.unit_vector(s, (uint32_t)b);
    if (mat == 0) {  // lambertian
      dir = normal + ur;
      if (fabsf(dir.x) < 1e-6f && fabsf(dir.y) < 1e-6f && fabsf(dir.z) < 1e-6f)
        dir = normal;
    } else {  // metal
      dir = unit(reflect(d, normal)) + ur * sc.col(4, win);
      scattered = dot(dir, normal) > 0.0f;
    }
    att = {sc.col(1, win), sc.col(2, win), sc.col(3, win)};
  } else {  // dielectric (any other id takes this direction, as in JAX)
    float coin, unused;
    st.uniform2(s, (uint32_t)b, kDrawCoin, coin, unused);
    const float ior = sc.col(5, win);
    const float ri = front ? 1.0f / ior : ior;
    const V3 ud = unit(d);
    const float cos_t = fminf(dot(-ud, normal), 1.0f);
    const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
    if (ri * sin_t > 1.0f || schlick(cos_t, ri) > coin) {
      dir = reflect(ud, normal);
    } else {  // refract
      const float ct = fminf(dot(-ud, normal), 1.0f);
      const V3 perp = (ud + normal * ct) * ri;
      const float par = sqrtf(fmaxf(fabsf(1.0f - dot(perp, perp)), 1e-12f));
      dir = perp + normal * (-par);
    }
    att = mat == 2 ? V3{1.0f, 1.0f, 1.0f}
                   : V3{sc.col(1, win), sc.col(2, win), sc.col(3, win)};
  }
  // absorbed, or scattering at the depth cap: the path ends black
  if (!scattered || b >= max_depth - 1) return false;
  V3 next = atten * att;
  if (rr_start >= 0) {
    const float ps = fminf(fmaxf(fmaxf(fmaxf(next.x, next.y), next.z), 0.05f), 1.0f);
    float u_rr, unused;
    st.uniform2(s, (uint32_t)b, kDrawRR, u_rr, unused);
    const bool zone = b >= rr_start;
    if (zone && u_rr >= ps) return false;
    next = next * (zone ? 1.0f / ps : 1.0f);
  }
  atten = next;
  o = hp;
  d = dir;
  return true;
}

// Where trace_sample sends the entry of each bounce: nowhere (the
// renders), or a train kernel's stack or park (train_render.cu).
struct NoSink {
  __device__ __forceinline__ void operator()(int, const Entry&) const {}
};

// Trace sample s of one pixel, with `hit` (ScanHit or WalkHit) as the
// closest hit and scatter_bounce after each hit; `sink` receives the state
// entering every bounce and its winning slot.
template <class Hit, class Sink = NoSink>
__device__ __forceinline__ PathEnd trace_sample(const Hit& hit, const Cam& cam,
                                                const Stream& st, float fi, float fj,
                                                uint32_t s, int max_depth, int rr_start,
                                                bool legacy_sky, const Sink& sink = {}) {
  V3 o, d;
  primary_ray(cam, fi, fj, st, s, o, d);
  const V3 prim_d = d;
  V3 atten = {1.0f, 1.0f, 1.0f};
  for (int b = 0;; ++b) {
    int win;
    float t;
    const bool missed = !hit(o, d, win, t);
    sink(b, Entry{o, d, atten, missed ? -1 : win});
    if (missed) return {b, true, atten * sky(legacy_sky ? prim_d : d)};
    if (!scatter_bounce<Hit::kHbm>(hit.sc, st, s, b, max_depth, rr_start, win, t, o, d,
                                   atten))
      return {b, false, {0.0f, 0.0f, 0.0f}};
  }
}

}  // namespace
