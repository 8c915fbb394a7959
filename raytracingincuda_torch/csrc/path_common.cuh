// Device code shared by the render kernels (regen_render.cu,
// compact_render.cu, stream_render.cu) and the train kernels
// (train_render.cu, stream_train.cu): vector math, the device-exact f32
// functions, the Threefry streams, the camera, the scene as a kernel sees
// it, the closest hit (one- or two-level) and the stream walk's bound test, one
// bounce's scatter, the trace of one sample's path (trace_sample) and the
// regenerating loop over a lane's samples (regen_lane). One copy, so that
// a train kernel's forward and the compact kernel's bounces are the regen
// kernel's arithmetic bit for bit. The stream walk itself is in
// staged_walk.cuh. The f64 kernel (f64_render.cu) takes only the f32
// draws from here.
//
// Exactness. Every expression keeps the association of the plain PyTorch
// versions (ops/tracer.py, ops/render_kernel.py:regen_reference,
// ops/stream_kernel.py:stream_reference) and of the JAX kernels. The build
// uses --fmad=false and no fast math, and sqrt, rsqrt, sin and cos are the
// fixed IEEE sequences of ops/f32math.py.
//
// The two-level scan (ScanHit with a group table, layout 'vmem'; the table
// is group_table.cu's, its plain twin ops/group_scan.py's). It tests the
// large slots, then walks groups of kGroup small slots in the table's
// order, and a warp tests a group's slots when any of its lanes' bound
// tests (group_can_improve) says the lane's best root numerator can
// improve there. Why the winner is the brute-force scan's, bit for bit:
//   1. Each slot's root numerator is slot_disc/take_root's arithmetic, as
//      in the one-level scan. A root replaces the best on root < best, or
//      root == best with a lower slot: over any set of tested slots the
//      scan keeps the least (root, slot) pair, and the one-level scan, in
//      slot order with a strict '<', keeps the least pair over all slots.
//      So it is enough that the group holding that pair is never skipped.
//   2. A warp skips a group only when every lane's own test fails, so it
//      is enough that a lane's test passes whenever a member k of the group
//      has a root Z with tmin_a < Z <= best (the lane's best so far, which
//      is at least its final best).
//   3. The slot test's rounding (u = 2^-24). Let S = |c_k| + |r_k| + |o|
//      and A the computed |d|^2, within 3u of the exact one. The 16 rounded
//      operations of slot_disc leave disc within 22 u A S^2 of the exact
//      A (r^2 - rho^2), rho the distance from c_k to the ray's line; so the
//      point P at t = Z / A, which the root places on the sphere, lies
//      within r_k + sqrt(40 u) S = r_k + 1.55e-3 S of c_k (the sqrt bounds
//      a grazing ray, where disc is near 0).
//   4. The bound. Every member lies within R of the bound's centre C
//      (R: the largest centre distance plus |r|, rounded up by the slack
//      below), so |P - C| <= R + 1.55e-3 S', S' = |C| + R + |o| >= S. The
//      test widens R to R + kPad S' (kPad |C| + R on the table, kPad |o|
//      a lane) plus kSlack: P lies inside the widened sphere by at least
//      (kPad - 1.55e-3) S' = 6.3e-3 S'.
//   5. The bound test's own rounding moves its chord ends h -/+ sqrt(disc)
//      by at most sqrt(22 u) (|C| + |o| + R_widened) |d| <= 2.3e-3 S' |d|,
//      and P's depth inside the widened sphere puts the exact chord ends at
//      least 6.3e-3 S' |d| from Z: the computed h - sq stays below Z <= best,
//      h + sq above Z > tmin_a, and disc above 0.
//   6. Where the argument's magnitudes do not hold the lane tests every
//      group: a ray with |d|^2 below 1e-12 (A is clamped there) or |d|^2 or
//      |o|^2 above kSafe. A slot with |c|^2 + r^2 above kSafe, or not
//      finite, is tested with the large slots. Within kSafe no product
//      overflows, and kSlack covers any underflow.
// A lane whose own test fails still tests a group its warp opens; by 1 that
// changes nothing.
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
// The two-level scan (see above; ops/group_scan.py reads these lines).
constexpr int kGroup = 16;              // small slots a group
constexpr float kLargeScale = 2.0f;     // large: |r| above this times the median |r|
constexpr float kPad = 0x1p-7f;         // bound widening per unit of |C| + R + |o|
constexpr float kSlack = 1.0e-4f;       // and absolute
constexpr float kSafe = 0x1p40f;        // magnitudes the argument covers
constexpr int kTableHead = 4;           // ints: large entries (padded to 4), groups, large, small

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

// One slot's hit test in the numerator domain (ops/intersect.py), in two
// parts: the half-b numerator h and the discriminant, then the root, which
// keeps the smallest root numerator with a strict '<', so the first slot
// wins an exact tie.
struct SlotDisc {
  float h, disc;
};
__device__ __forceinline__ SlotDisc slot_disc(const float4 e, V3 o, V3 d, float a,
                                              float d_dot_o, float o2) {
  const float h = (e.x * d.x + e.y * d.y + e.z * d.z) - d_dot_o;
  const float cc = (e.w + o2) - 2.0f * (e.x * o.x + e.y * o.y + e.z * o.z);
  return {h, h * h - a * cc};
}
__device__ __forceinline__ void take_root(SlotDisc q, float tmin_a, int k, float& best,
                                          int& win) {
  if (q.disc > 0.0f) {
    const float sq = sqrtf(q.disc);
    const float near = q.h - sq;
    const float root = near > tmin_a ? near : q.h + sq;
    if (root > tmin_a && root < best) {
      best = root;
      win = k;
    }
  }
}
__device__ __forceinline__ void test_slot(const float4 e, V3 o, V3 d, float a,
                                          float d_dot_o, float o2, float tmin_a, int k,
                                          float& best, int& win) {
  take_root(slot_disc(e, o, d, a, d_dot_o, o2), tmin_a, k, best, win);
}

// The two-level table's geometry for n slots: scan entries (the large
// slots padded to 4, then the groups' members padded to kGroup), their
// slots, and one bound a group. In device memory (group_table.cu) after
// kTableHead ints: entries, bounds, slots; a block stages the same three
// after its gather columns.
__host__ __device__ __forceinline__ int group_entries(int n) { return (n + kGroup + 5) & ~3; }
__host__ __device__ __forceinline__ int group_bounds(int n) { return (n + kGroup - 1) / kGroup; }
__host__ __device__ __forceinline__ size_t group_bytes(int n) {
  return (size_t)group_entries(n) * (sizeof(float4) + sizeof(int)) +
         (size_t)group_bounds(n) * sizeof(float4);
}
// Shared memory a block stages: the scan table, the gather columns and,
// with a group table, the table (16-byte aligned after the columns).
__host__ __device__ __forceinline__ size_t stage_offset(int n) {
  return ((size_t)n * (sizeof(float4) + kGather * sizeof(float)) + 15) & ~(size_t)15;
}
__host__ __device__ __forceinline__ size_t staged_bytes(int n, bool hbm, bool groups) {
  if (hbm) return 0;
  return groups ? stage_offset(n) + group_bytes(n) : (size_t)n * (sizeof(float4) + kGather * sizeof(float));
}

// The two-level table as a kernel reads it; entry null: the one-level scan.
struct Groups {
  const float4* entry = nullptr;  // (n_large + n_groups * kGroup) scan entries
  const int* slot = nullptr;      // their slots (-1: padding, never hits)
  const float4* bound = nullptr;  // (n_groups) centre, R widened by kPad (|C| + R) + kSlack
  int n_large = 0, n_groups = 0;
};

// All threads of the block copy the used part of the table in device
// memory (group_table.cu's words; null: none, the one-level scan) to `dst`
// (the shared memory after the staged scene), then the caller syncs.
__device__ __forceinline__ Groups stage_groups(const int32_t* table, int n, void* dst) {
  Groups g;
  if (!table) return g;
  const float4* src_e = reinterpret_cast<const float4*>(table + kTableHead);
  const float4* src_b = src_e + group_entries(n);
  const int* src_s = reinterpret_cast<const int*>(src_b + group_bounds(n));
  g.n_large = table[0];
  g.n_groups = table[1];
  float4* e = static_cast<float4*>(dst);
  float4* b = e + group_entries(n);
  int* s = reinterpret_cast<int*>(b + group_bounds(n));
  const int used = g.n_large + g.n_groups * kGroup;
  for (int k = threadIdx.x; k < used; k += blockDim.x) {
    e[k] = src_e[k];
    s[k] = src_s[k];
  }
  for (int k = threadIdx.x; k < g.n_groups; k += blockDim.x) b[k] = src_b[k];
  g.entry = e;
  g.bound = b;
  g.slot = s;
  return g;
}

// take_root for the two-level scan, whose slots come out of order: a root
// equal to the best replaces it when its slot is lower (the one-level
// scan's first slot). The slot is read only for a root at or below best.
__device__ __forceinline__ void take_root_at(SlotDisc q, float tmin_a, const int* slot, int p,
                                             float& best, int& win) {
  if (q.disc > 0.0f) {
    const float sq = sqrtf(q.disc);
    const float near = q.h - sq;
    const float root = near > tmin_a ? near : q.h + sq;
    if (root > tmin_a && root <= best) {
      const int k = slot[p];
      if (root < best || k < win) {
        best = root;
        win = k;
      }
    }
  }
}

// Entries p..p+3 of the table, as the one-level scan's four-slot step.
__device__ __forceinline__ void test_four(const Groups& gr, int p, V3 o, V3 d, float a,
                                          float d_dot_o, float o2, float tmin_a, float& best,
                                          int& win) {
  const SlotDisc q0 = slot_disc(gr.entry[p], o, d, a, d_dot_o, o2);
  const SlotDisc q1 = slot_disc(gr.entry[p + 1], o, d, a, d_dot_o, o2);
  const SlotDisc q2 = slot_disc(gr.entry[p + 2], o, d, a, d_dot_o, o2);
  const SlotDisc q3 = slot_disc(gr.entry[p + 3], o, d, a, d_dot_o, o2);
  if (q0.disc > 0.0f || q1.disc > 0.0f || q2.disc > 0.0f || q3.disc > 0.0f) {
    take_root_at(q0, tmin_a, gr.slot, p, best, win);
    take_root_at(q1, tmin_a, gr.slot, p + 1, best, win);
    take_root_at(q2, tmin_a, gr.slot, p + 2, best, win);
    take_root_at(q3, tmin_a, gr.slot, p + 3, best, win);
  }
}

// Can the lane's best root numerator improve inside group bound b, widened
// by pad_o = kPad |o|? The half-b quadratic of the widened sphere, in the
// numerator domain: its chord must overlap (tmin_a, best).
__device__ __forceinline__ bool group_can_improve(const float4 b, float pad_o, V3 o, V3 d,
                                                  float a, float d_dot_o, float o2,
                                                  float tmin_a, float best) {
  const float r = b.w + pad_o;
  const float h = (b.x * d.x + b.y * d.y + b.z * d.z) - d_dot_o;
  const float c2r2 = (b.x * b.x + b.y * b.y + b.z * b.z) - r * r;
  const float cc = (c2r2 + o2) - 2.0f * (b.x * o.x + b.y * o.y + b.z * o.z);
  const float disc = h * h - a * cc;
  if (!(disc > 0.0f)) return false;
  const float sq = sqrtf(disc);
  return h + sq > tmin_a && h - sq < best;
}

// The closest hit over every slot of a SceneView (the regen, compact and
// train kernels): true on a hit, with the winning slot and t = numerator /
// a. Without a group table (layout 'hbm', or a launch whose wrapper built
// none) the one-level scan: four slots a step, their entries loaded and
// their discriminants computed before any root, so the four tests' loads
// and arithmetic are independent work for the scheduler, and one branch
// (taken where any of the four discriminants is positive) guards the
// roots, which then run in slot order: the same slot wins as in a one-slot
// loop. With a table, the two-level scan (header): the large slots four a
// step, then each group whose bound any lane of the warp can improve in
// (__any_sync over the lanes in the scan), its members four a step. kCount
// (the count mode): the leader of the lanes in the scan adds the warp's
// opened groups and slot tests of the two-level scan to its own `opened`
// and `tests`, which the kernel sums over the warp's lanes (a one-level
// scan tests every slot; its wrapper counts those). Registers, not a
// pointer to shared memory in this struct: with one there, nvcc read the
// gather columns of layout 'hbm' as shared memory (an illegal instruction).
// Built with no table (Groups{}), the two-level code folds away.
template <bool kHbm_, bool kCount = false>
struct ScanHit {
  static constexpr bool kHbm = kHbm_;
  static constexpr bool kLockstep = false;
  SceneView sc;
  Groups gr;
  mutable int opened = 0, tests = 0;
  __device__ __forceinline__ bool operator()(V3 o, V3 d, int& win, float& t) const {
    const float dd = dot(d, d);
    const float a = fmaxf(dd, 1e-12f);
    const float d_dot_o = dot(d, o);
    const float o2 = dot(o, o);
    const float tmin_a = kTMin * a;
    float best = kTMiss;
    win = 0;
    if (!kHbm && gr.entry) {
      bool lead = false;
      if (kCount) {
        lead = (threadIdx.x & 31) == __ffs(__activemask()) - 1;
        if (lead) tests += gr.n_large;
      }
      for (int p = 0; p < gr.n_large; p += 4)
        test_four(gr, p, o, d, a, d_dot_o, o2, tmin_a, best, win);
      const bool wide = !(dd >= 1e-12f && dd <= kSafe && o2 <= kSafe);
      const float pad_o = kPad * sqrtf(o2);
      for (int g = 0, p = gr.n_large; g < gr.n_groups; ++g, p += kGroup) {
        const bool can =
            wide || group_can_improve(gr.bound[g], pad_o, o, d, a, d_dot_o, o2, tmin_a, best);
        if (!__any_sync(__activemask(), can)) continue;
        if (kCount && lead) {
          ++opened;
          tests += kGroup;
        }
#pragma unroll
        for (int j = 0; j < kGroup; j += 4)
          test_four(gr, p + j, o, d, a, d_dot_o, o2, tmin_a, best, win);
      }
    } else {
      int k = 0;
      for (; k + 4 <= sc.n; k += 4) {
        const float4 e0 = slot_entry<kHbm>(sc, k), e1 = slot_entry<kHbm>(sc, k + 1);
        const float4 e2 = slot_entry<kHbm>(sc, k + 2), e3 = slot_entry<kHbm>(sc, k + 3);
        const SlotDisc q0 = slot_disc(e0, o, d, a, d_dot_o, o2);
        const SlotDisc q1 = slot_disc(e1, o, d, a, d_dot_o, o2);
        const SlotDisc q2 = slot_disc(e2, o, d, a, d_dot_o, o2);
        const SlotDisc q3 = slot_disc(e3, o, d, a, d_dot_o, o2);
        if (q0.disc > 0.0f || q1.disc > 0.0f || q2.disc > 0.0f || q3.disc > 0.0f) {
          take_root(q0, tmin_a, k, best, win);
          take_root(q1, tmin_a, k + 1, best, win);
          take_root(q2, tmin_a, k + 2, best, win);
          take_root(q3, tmin_a, k + 3, best, win);
        }
      }
      for (; k < sc.n; ++k)
        test_slot(slot_entry<kHbm>(sc, k), o, d, a, d_dot_o, o2, tmin_a, k, best, win);
    }
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

// Trace sample s of one pixel, with `hit` (ScanHit) as the
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

// The regenerating loop of one lane (kernel 1, kernel 2's park render,
// kernel 4): samples [s, budget) of one pixel, one traced segment an
// iteration. At bounce 0 the iteration starts the sample's primary ray;
// then the closest hit; a miss banks atten * sky and a scatter that ends
// the path ends it black; either way the lane moves to its next sample,
// which starts at the next iteration. A lane thus pays its own segments
// and not, sample by sample, the longest path of its warp, as a loop over
// trace_sample would (a warp leaves a loop only when all its lanes have).
// Each lane's arithmetic and the order of its samples are trace_sample's,
// so sums over on_end are the same bits. on_bounce(b, entry) receives the
// state entering each bounce and its winning slot (-1 at the miss);
// on_end(PathEnd) each sample's end, in sample order.
//
// A Hit with kLockstep (StagedWalk) must be called by every lane of its
// mask together: the loop then runs while any lane of the mask has
// samples left, and a lane whose budget is spent calls the walk with
// live = false.
template <class Hit, class OnBounce, class OnEnd>
__device__ __forceinline__ void regen_lane(const Hit& hit, const Cam& cam, const Stream& st,
                                           float fi, float fj, uint32_t s, float budget,
                                           int max_depth, int rr_start, bool legacy_sky,
                                           OnBounce&& on_bounce, OnEnd&& on_end) {
  V3 o = {0.0f, 0.0f, 0.0f}, d = o, prim_d = o, atten = o;
  int b = 0;
  for (;;) {
    const bool live = (float)s < budget;
    if constexpr (Hit::kLockstep) {
      if (!__any_sync(hit.mask, live)) break;
    } else if (!live) {
      break;
    }
    if (live && b == 0) {
      primary_ray(cam, fi, fj, st, s, o, d);
      prim_d = d;
      atten = {1.0f, 1.0f, 1.0f};
    }
    int win;
    float t;
    bool found;
    if constexpr (Hit::kLockstep) {
      found = hit(o, d, live, win, t);
      if (!live) continue;
    } else {
      found = hit(o, d, win, t);
    }
    on_bounce(b, Entry{o, d, atten, found ? win : -1});
    if (!found) {
      on_end(PathEnd{b, true, atten * sky(legacy_sky ? prim_d : d)});
    } else if (!scatter_bounce<Hit::kHbm>(hit.sc, st, s, b, max_depth, rr_start, win, t, o,
                                          d, atten)) {
      on_end(PathEnd{b, false, {0.0f, 0.0f, 0.0f}});
    } else {
      ++b;
      continue;
    }
    ++s;
    b = 0;
  }
}

}  // namespace
