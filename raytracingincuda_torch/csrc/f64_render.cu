// Forward path-tracing render in double precision, for Hopper (sm_90a).
//
// Replaces the TPU kernels raytracingincuda_tpu/ops/pallas_df64.py:
// _df64_tile_kernel and _df64_tile_kernel_multi (body
// ops/df64_trace.py:regen_trace_df64). The TPU has no FP64 units and
// carries each value as a pair of f32 (about 48 significand bits); the
// H100 has FP64 units, so this kernel computes in native double. One
// kernel serves both TPU kernels: their K pixels per lane are a schedule
// and change no image.
//
// What it computes. Kernel 1's loop (regen_render.cu), one thread per
// pixel, samples [sample_offset, sample_offset + samples) back to back
// (a window of a render in rounds), under the df64 path's scope: the parity
// estimator, the current-bounce sky, uniform budgets. The camera row, the
// geometry (primary rays, the hit-test quadratic, roots, hit points,
// normals, scatter directions), attenuation, the sky and the radiance sums
// are double. The random draws stay the f32 Threefry values of
// path_common.cuh, promoted exactly: the jitter, the defocus disk (f32
// sqrt, sin, cos), the unit vector and the coin, as df64_trace.py draws
// them. Output: the per-lane radiance sums, (3, padded) double.
//
// Association. Every expression keeps df64_trace.py's, which the plain
// version (ops/f64_kernel.py:f64_reference) repeats in torch.float64:
// the sample position fi + (u0 - 0.5) in double (not the f32 rounding of
// kernel 1); t = t_num / a, a division; dot products left to right;
// c = (c2r2 + |O|^2) - 2 C.O; Schlick's (1-cos)^5 as (om2 * om2) * om;
// unit(v) = v * (1 / sqrt(max(|v|^2, 1e-30))). Double + - * / and sqrt
// are correctly rounded here and in eager PyTorch, and the build keeps
// --fmad=false, so the kernel equals its plain version bit for bit. The
// closest hit keeps the first slot at an exact tie (df64 blends tied
// slots through its one-hot gather).
//
// What bounds it. The FP64 hit loop: 17 double operations a sphere test
// and its guard, on an SM that has half as many FP64 lanes as FP32 lanes
// (34 TFLOP/s). What the design does about that:
//   * the loop regenerates, as kernel 1's (path_common.cuh's regen_lane,
//     followed statement for statement in double here): one path segment
//     an iteration, and a lane whose path ended starts its pixel's next
//     sample at the next iteration. A warp then pays its longest lane's
//     total of segments, where a loop over samples around a bounce loop
//     paid, sample by sample, the longest path of the warp;
//   * the hit test takes kSlotStep (4) slots a step: their entries are
//     loaded and their discriminants computed before one branch, taken
//     where any discriminant is positive, and the roots then run in slot
//     order, so the same slot wins as in a one-slot loop. Four slots'
//     chains are independent work for the FP64 pipe's latency;
//   * the compiler is asked for 4 blocks an SM (128 registers): without
//     the minimum the four-slot step takes 135 and 3 blocks. The 16-byte
//     spill lies outside the scan loop, and the fourth block ran 5%
//     faster (PERF.md's ladder; 5 blocks, 64 bytes of spill, were no
//     faster);
//   * layout 'vmem' stages only the scan table, as double (cx, cy, cz,
//     |C|^2 - r^2: 32 B a slot, 16 KB at 512 slots, converted once per
//     block and not once per test); every lane reads the same slot, a
//     broadcast. Kernel 1's f32 staging doubled would need 360 KB at 4096
//     slots, so the seven gather columns, read once per bounce for the
//     winning slot, come from device memory in both layouts. Layout 'hbm'
//     reads the f32 SoA per test and converts there;
//   * with a group table (group_table.cu, one launch before this one; the
//     wrapper builds it where group_scan.uses_groups holds: layout 'vmem',
//     2 * kGroup to kMaxSlots slots) the scan runs in two levels, as
//     kernel 1's ScanHit (path_common.cuh) does in f32: the large slots
//     four a step, then the table's groups of kGroup small slots in its
//     order (front to back from the camera), and a warp tests a group's
//     members, four a step, only where some lane's bound test in double
//     (group_can_improve_d) says its best root numerator can improve
//     inside the group's widened bound sphere (__any_sync). The block
//     stages the table's entries as double Slots in place of the slot-order
//     scan table, each built from the SoA by the table's slot id (padding,
//     slot -1, gets a NaN |C|^2 - r^2 and never hits), with the slot ids
//     and the f32 bounds: 36 B an entry and 16 B a group, 19.7 KB at 512
//     slots, so the 4 blocks an SM stay.
//
// The two-level scan's winner is the one-level scan's, bit for bit: the
// argument of path_common.cuh's header, items 1, 2 and 6 as they stand
// (each slot's root numerator is slot_disc_d/take_root_d's arithmetic; a
// root equal to the best replaces it only at a lower slot, take_root_at_d,
// so any set of tested slots keeps the least (root, slot) pair; a warp
// skips a group only when every lane's own test fails; the wide fallback),
// and items 3-5 in double, u = 2^-53:
//   3. The slot test's 16 rounded operations leave disc within 22 u A S^2
//      of the exact A (r^2 - rho^2) (S = |c_k| + |r_k| + |o|, A the
//      computed |d|^2): the point P at t = Z / A that the root Z places on
//      the sphere lies within r_k + sqrt(40 u) S = r_k + 6.7e-8 S of c_k.
//   4. The bound is the table's f32 (C, R widened to R + kPad (|C| + R) +
//      kSlack), promoted exactly; every member (its f32 centre and radius,
//      which the double test promotes exactly too) lies within the
//      unwidened R of C up to the f32 rounding of R, which the table's
//      widening covers as in the f32 scan. The lane adds kPad |o| in
//      double (pad_o, two roundings). So P lies inside the widened sphere
//      by at least (kPad - 6.7e-8 - 4u) S' > 7.8e-3 S', S' = |C| + R + |o|.
//   5. The bound test's own rounding (group_can_improve_d, in double on
//      the promoted bound) moves its chord ends h -/+ sqrt(disc) by at most
//      sqrt(22 u) (|C| + |o| + R_widened) |d| <= 1.0e-7 S' |d|, and P's
//      depth puts the exact chord ends at least 7.8e-3 S' |d| from Z: the
//      computed h - sq stays below Z <= best, h + sq above Z > tmin_a, and
//      disc above 0.
// Both error terms sit some 10^5 times inside the table's kPad = 2^-7,
// which was sized for the f32 scan's 1.55e-3 S; the slack is not narrowed.
// The wide fallback carries over: a lane with |d|^2 below 1e-12 or above
// kSafe, or |o|^2 above kSafe, opens every group.
//
// The count mode (f64_counts: f64_count_kernel, render_lane's kCount
// instance, which the render's instance does not carry) runs the same loop
// and counts, (4, padded) int32 a lane: the lane's segments (its scans),
// and at the leader of the lanes in each scan the scan's issue, the groups
// it opened and the slot tests it issued (the large entries and kGroup an
// opened group); the wrapper sums each warp's.

#include "path_common.cuh"

namespace {

constexpr double kTMin64 = 1.0e-3;
constexpr double kTMiss64 = 1.0e30;

struct D3 {
  double x, y, z;
};
__device__ __forceinline__ D3 operator+(D3 a, D3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ D3 operator-(D3 a, D3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ D3 operator-(D3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ D3 operator*(D3 a, D3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ D3 operator*(D3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ double dot(D3 a, D3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
// torch.maximum / torch.minimum against a bound
__device__ __forceinline__ double max_d(double x, double lo) { return x < lo ? lo : x; }
__device__ __forceinline__ double min_d(double x, double hi) { return x > hi ? hi : x; }
__device__ __forceinline__ D3 unit(D3 v) { return v * (1.0 / sqrt(max_d(dot(v, v), 1e-30))); }
__device__ __forceinline__ D3 reflect(D3 v, D3 n) { return v - n * (2.0 * dot(v, n)); }
__device__ __forceinline__ D3 promote(V3 v) { return {(double)v.x, (double)v.y, (double)v.z}; }

struct CamD {
  D3 pixel00, du, dv, center, disk_u, disk_v;
  bool defocus;
};

__device__ __forceinline__ CamD load_cam_d(const double* c) {
  return {{c[0], c[1], c[2]},    {c[3], c[4], c[5]},    {c[6], c[7], c[8]},
          {c[9], c[10], c[11]},  {c[12], c[13], c[14]}, {c[15], c[16], c[17]},
          c[18] > 0.5};
}

// One slot's scan entry in double; c2r2 = NaN when inactive (and for the
// group table's padding), so that its discriminant is NaN and the slot
// never hits.
struct alignas(16) Slot {
  double cx, cy, cz, c2r2;
};
__device__ __forceinline__ double never() { return __longlong_as_double(0x7ff8000000000000ll); }

__device__ __forceinline__ Slot slot_of(const float* scene, int n, int k) {
  const double cx = scene[kCx * n + k], cy = scene[kCy * n + k], cz = scene[kCz * n + k];
  const double r = scene[kRadius * n + k];
  const double c2r2 = ((cx * cx + cy * cy) + cz * cz) - r * r;
  return {cx, cy, cz, scene[kActive * n + k] > 0.5f ? c2r2 : never()};
}

struct Params {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* scene;  // SoA (kNumCols, n), f32
  int n;
  const double* cam;   // (24,) double
  double* out;         // (3, padded)
  // at most render_kernel.MAX_LANES: 3 x lanes fits int, so the (3, lanes) rows index in int
  int padded;
  int max_depth;
  uint32_t k0, k1;
  // the lane renders samples [sample_offset, sample_end); the host sums
  // the end, which summed in the loop's test cost the f64 headline 2.5%
  // on the H100 (PERF.md)
  int sample_offset, sample_end;
  const int32_t* groups;  // the group table, or null: the one-level scan
  int32_t* counts;        // the count mode: (4, padded) segments, issues, opened, tests
};

// Slots tested a step by the closest hit, and the blocks an SM asked of
// the compiler.
constexpr int kSlotStep = 4;
constexpr int kMinBlocks = 4;
static_assert(kGroup % kSlotStep == 0, "a group is whole steps");

template <bool kHbm>
__device__ __forceinline__ Slot slot_at(const Params& p, const Slot* scan, int k) {
  return kHbm ? slot_of(p.scene, p.n, k) : scan[k];
}

// The staged group table: `scan` holds its entries (double Slots), then
// group_bounds(n) f32 bounds and group_entries(n) slot ids. on: staged
// (layout 'vmem' with a table); else `scan` is the slot-order table.
struct Walk {
  bool on;
  int n_large, n_groups;
};

// Shared memory a block stages (0 for layout 'hbm').
__host__ __device__ __forceinline__ size_t stage_bytes_d(int n, bool hbm, bool groups) {
  if (hbm) return 0;
  if (!groups) return (size_t)n * sizeof(Slot);
  return (size_t)group_entries(n) * (sizeof(Slot) + sizeof(int)) +
         (size_t)group_bounds(n) * sizeof(float4);
}
__device__ __forceinline__ const float4* walk_bounds(const Slot* scan, int n) {
  return reinterpret_cast<const float4*>(scan + group_entries(n));
}
__device__ __forceinline__ const int* walk_slots(const Slot* scan, int n) {
  return reinterpret_cast<const int*>(walk_bounds(scan, n) + group_bounds(n));
}

// All threads of the block stage the scan table (the slot-order one, or
// the group table's entries, bounds and slot ids), then the caller syncs.
__device__ __forceinline__ Walk stage_d(const Params& p, Slot* scan) {
  const int n = p.n;
  if (!p.groups) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) scan[k] = slot_of(p.scene, n, k);
    return {false, 0, 0};
  }
  const float4* src_b = reinterpret_cast<const float4*>(p.groups + kTableHead) + group_entries(n);
  const int* src_s = reinterpret_cast<const int*>(src_b + group_bounds(n));
  const Walk w{true, p.groups[0], p.groups[1]};
  float4* bound = const_cast<float4*>(walk_bounds(scan, n));
  int* slot = const_cast<int*>(walk_slots(scan, n));
  for (int q = threadIdx.x; q < w.n_large + w.n_groups * kGroup; q += blockDim.x) {
    const int k = src_s[q];
    slot[q] = k;
    scan[q] = k >= 0 ? slot_of(p.scene, n, k) : Slot{0.0, 0.0, 0.0, never()};
  }
  for (int g = threadIdx.x; g < w.n_groups; g += blockDim.x) bound[g] = src_b[g];
  return w;
}

// One slot's test in two parts: the half-b numerator h and the
// discriminant, then the root, which keeps the smallest root numerator
// with a strict '<', so the first slot wins an exact tie.
struct DiscD {
  double h, disc;
};
__device__ __forceinline__ DiscD slot_disc_d(const Slot& e, D3 o, D3 d, double a,
                                             double d_dot_o, double o2) {
  const double h = ((e.cx * d.x + e.cy * d.y) + e.cz * d.z) - d_dot_o;
  const double c = (e.c2r2 + o2) - 2.0 * ((e.cx * o.x + e.cy * o.y) + e.cz * o.z);
  return {h, h * h - a * c};
}
__device__ __forceinline__ void take_root_d(DiscD q, double tmin_a, int k, double& best,
                                            int& win) {
  if (q.disc > 0.0) {
    const double sq = sqrt(q.disc);
    const double near = q.h - sq;
    const double root = near > tmin_a ? near : q.h + sq;
    if (root > tmin_a && root < best) {
      best = root;
      win = k;
    }
  }
}
// take_root_d for the two-level scan, whose slots come out of order
// (path_common.cuh's take_root_at): a root equal to the best replaces it
// when its slot is lower. The slot is read only for a root at or below best.
__device__ __forceinline__ void take_root_at_d(DiscD q, double tmin_a, const int* slot, int e,
                                               double& best, int& win) {
  if (q.disc > 0.0) {
    const double sq = sqrt(q.disc);
    const double near = q.h - sq;
    const double root = near > tmin_a ? near : q.h + sq;
    if (root > tmin_a && root <= best) {
      const int k = slot[e];
      if (root < best || k < win) {
        best = root;
        win = k;
      }
    }
  }
}

// Entries e..e+3 of the staged group table, as the one-level scan's step.
__device__ __forceinline__ void test_step_at(const Slot* scan, const int* slot, int e, D3 o,
                                             D3 d, double a, double d_dot_o, double o2,
                                             double tmin_a, double& best, int& win) {
  DiscD q[kSlotStep];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kSlotStep; ++j) {
    q[j] = slot_disc_d(scan[e + j], o, d, a, d_dot_o, o2);
    any = any || q[j].disc > 0.0;
  }
  if (any) {
#pragma unroll
    for (int j = 0; j < kSlotStep; ++j) take_root_at_d(q[j], tmin_a, slot, e + j, best, win);
  }
}

// Can the lane's best root numerator improve inside group bound b (f32,
// promoted), widened by pad_o = kPad |o|? The half-b quadratic of the
// widened sphere in double: its chord must overlap (tmin_a, best).
__device__ __forceinline__ bool group_can_improve_d(const float4 b, double pad_o, D3 o, D3 d,
                                                    double a, double d_dot_o, double o2,
                                                    double tmin_a, double best) {
  const D3 c = {(double)b.x, (double)b.y, (double)b.z};
  const double r = (double)b.w + pad_o;
  const double h = dot(c, d) - d_dot_o;
  const double c2r2 = dot(c, c) - r * r;
  const double cc = (c2r2 + o2) - 2.0 * dot(c, o);
  const double disc = h * h - a * cc;
  if (!(disc > 0.0)) return false;
  const double sq = sqrt(disc);
  return h + sq > tmin_a && h - sq < best;
}

// A lane's count-mode counters: its scans, and what it adds as the leader
// of a scan's lanes.
struct Counts {
  int segments = 0, issues = 0, opened = 0, tests = 0;
};

// The closest hit over every slot: true on a hit, with the winning slot
// and t = t_num / a. One level (layout 'hbm', or no table): every slot,
// four a step. Two levels (a staged table): the header's walk.
template <bool kHbm, bool kCount>
__device__ __forceinline__ bool hit_d(const Params& p, const Slot* scan, const Walk& w, D3 o,
                                      D3 d, int& win, double& t, Counts& cnt) {
  const double dd = dot(d, d);
  const double a = max_d(dd, 1e-12);
  const double d_dot_o = dot(d, o);
  const double o2 = dot(o, o);
  const double tmin_a = kTMin64 * a;
  double best = kTMiss64;
  win = 0;
  bool lead = false;
  if constexpr (kCount) {
    ++cnt.segments;
    lead = (threadIdx.x & 31) == __ffs(__activemask()) - 1;
    if (lead) ++cnt.issues;
  }
  if (!kHbm && w.on) {
    const float4* bound = walk_bounds(scan, p.n);
    const int* slot = walk_slots(scan, p.n);
    if (kCount && lead) cnt.tests += w.n_large;
    for (int e = 0; e < w.n_large; e += kSlotStep)
      test_step_at(scan, slot, e, o, d, a, d_dot_o, o2, tmin_a, best, win);
    const bool wide = !(dd >= 1e-12 && dd <= (double)kSafe && o2 <= (double)kSafe);
    const double pad_o = (double)kPad * sqrt(o2);
    for (int g = 0, e = w.n_large; g < w.n_groups; ++g, e += kGroup) {
      const bool can =
          wide || group_can_improve_d(bound[g], pad_o, o, d, a, d_dot_o, o2, tmin_a, best);
      if (!__any_sync(__activemask(), can)) continue;
      if (kCount && lead) {
        ++cnt.opened;
        cnt.tests += kGroup;
      }
#pragma unroll
      for (int j = 0; j < kGroup; j += kSlotStep)
        test_step_at(scan, slot, e + j, o, d, a, d_dot_o, o2, tmin_a, best, win);
    }
  } else {
    int k = 0;
    for (; k + kSlotStep <= p.n; k += kSlotStep) {
      DiscD q[kSlotStep];
      bool any = false;
#pragma unroll
      for (int j = 0; j < kSlotStep; ++j) {
        q[j] = slot_disc_d(slot_at<kHbm>(p, scan, k + j), o, d, a, d_dot_o, o2);
        any = any || q[j].disc > 0.0;
      }
      if (any) {
#pragma unroll
        for (int j = 0; j < kSlotStep; ++j) take_root_d(q[j], tmin_a, k + j, best, win);
      }
    }
    for (; k < p.n; ++k) {
      const DiscD q = slot_disc_d(slot_at<kHbm>(p, scan, k), o, d, a, d_dot_o, o2);
      take_root_d(q, tmin_a, k, best, win);
    }
  }
  if (!(best < kTMiss64)) return false;
  t = best / a;
  return true;
}

// Blue-to-white gradient: (1 - a) * white + a * blue, a = 0.5 (unit(d).y + 1).
__device__ __forceinline__ D3 sky_d(D3 d) {
  const double uy = d.y * (1.0 / sqrt(max_d(dot(d, d), 1e-30)));
  const double a = 0.5 * (uy + 1.0);
  const double w = 1.0 - a;
  return {w * 1.0 + a * 0.5, w * 1.0 + a * 0.7, w * 1.0 + a * 1.0};
}

// Bounce b of sample s after a hit on slot `win` at t: the hit point, the
// oriented normal and the material's scatter from this bounce's draws. A
// scatter at bounce max_depth-1 exits black. Returns false when the path
// ends black here; else moves (o, d, atten) to the scattered ray.
__device__ __forceinline__ bool scatter_d(const Params& p, const Stream& st, int s, int b,
                                          int win, double t, D3& o, D3& d, D3& atten) {
  const int n = p.n;
  const float* col = p.scene + kRadius * n;  // radius, albedo rgb, fuzz, ior, mat
  const D3 hp = o + d * t;
  const D3 center = {(double)p.scene[kCx * n + win], (double)p.scene[kCy * n + win],
                     (double)p.scene[kCz * n + win]};
  const double radius = col[win];
  const double rs = fabs(radius) > 1e-12 ? radius : 1e-12;
  const D3 outward = (hp - center) * (1.0 / rs);
  const bool front = dot(d, outward) < 0.0;
  const D3 normal = front ? outward : -outward;
  const int mat = (int)col[6 * n + win];
  const D3 albedo = {(double)col[n + win], (double)col[2 * n + win], (double)col[3 * n + win]};

  D3 dir, att;
  bool scattered = true;
  if (mat == 0 || mat == 1) {
    const D3 ur = promote(st.unit_vector((uint32_t)s, (uint32_t)b));
    if (mat == 0) {  // lambertian
      dir = normal + ur;
      if (fabs(dir.x) < 1e-6 && fabs(dir.y) < 1e-6 && fabs(dir.z) < 1e-6) dir = normal;
    } else {  // metal
      dir = unit(reflect(d, normal)) + ur * (double)col[4 * n + win];
      scattered = dot(dir, normal) > 0.0;
    }
    att = albedo;
  } else {  // dielectric (any other id takes this direction, as in JAX)
    float coin, unused;
    st.uniform2((uint32_t)s, (uint32_t)b, kDrawCoin, coin, unused);
    const double ior = col[5 * n + win];
    const double ri = front ? 1.0 / ior : ior;
    const D3 ud = unit(d);
    const double cos_t = min_d(dot(-ud, normal), 1.0);
    const double sin_t = sqrt(max_d(1.0 - cos_t * cos_t, 0.0));
    double r0 = (1.0 - ri) / (1.0 + ri);
    r0 = r0 * r0;
    const double om = 1.0 - cos_t;
    const double om2 = om * om;
    const double refl = r0 + (1.0 - r0) * ((om2 * om2) * om);
    if (ri * sin_t > 1.0 || refl > (double)coin) {
      dir = reflect(ud, normal);
    } else {  // refract
      const double ct = min_d(dot(-ud, normal), 1.0);
      const D3 perp = (ud + normal * ct) * ri;
      const double par = sqrt(max_d(fabs(1.0 - dot(perp, perp)), 1e-12));
      dir = perp + normal * (-par);
    }
    att = mat == 2 ? D3{1.0, 1.0, 1.0} : albedo;
  }
  // absorbed, or scattering at the depth cap: the path ends black
  if (!scattered || b >= p.max_depth - 1) return false;
  atten = atten * att;
  o = hp;
  d = dir;
  return true;
}

// The kernels' body: stage the scan table, then lane i's loop.
template <bool kHbm, bool kCount>
__device__ __forceinline__ void render_lane(const Params& p, Slot* scan) {
  Walk w{false, 0, 0};
  if (!kHbm) {
    w = stage_d(p, scan);
    __syncthreads();
  }
  Counts cnt;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.padded) return;
  const CamD cam = load_cam_d(p.cam);
  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  const double fi = p.ii[i], fj = p.jj[i];
  D3 acc = {0.0, 0.0, 0.0}, o = acc, d = acc, atten = acc;
  // regen_lane's loop: one segment an iteration; a miss banks atten * sky
  // and a scatter that ends the path ends it black; either way the lane
  // moves to its next sample, which starts at the next iteration. Samples
  // are counted from sample_offset: the draws are keyed on the absolute
  // sample index, so a window renders that window's samples exactly
  int s = p.sample_offset, b = 0;
  while (s < p.sample_end) {
    if (b == 0) {  // the primary ray: f32 draws, double geometry
      float u0, u1, px, py;
      primary_draws(st, (uint32_t)s, u0, u1, px, py);
      const double ix = fi + (double)(u0 - 0.5f), jy = fj + (double)(u1 - 0.5f);
      const D3 sample_pt = (cam.pixel00 + cam.du * ix) + cam.dv * jy;
      o = cam.defocus ? (cam.center + cam.disk_u * (double)px) + cam.disk_v * (double)py
                      : cam.center;
      d = sample_pt - o;
      atten = {1.0, 1.0, 1.0};
    }
    int win;
    double t;
    if (!hit_d<kHbm, kCount>(p, scan, w, o, d, win, t, cnt)) {
      acc = acc + atten * sky_d(d);
    } else if (scatter_d(p, st, s, b, win, t, o, d, atten)) {
      ++b;
      continue;
    }
    ++s;
    b = 0;
  }
  p.out[i] = acc.x;
  p.out[p.padded + i] = acc.y;
  p.out[2 * p.padded + i] = acc.z;
  if constexpr (kCount) {
    p.counts[i] = cnt.segments;
    p.counts[p.padded + i] = cnt.issues;
    p.counts[2 * p.padded + i] = cnt.opened;
    p.counts[3 * p.padded + i] = cnt.tests;
  }
}

template <bool kHbm>
__global__ void __launch_bounds__(kBlock, kMinBlocks) f64_kernel(Params p) {
  extern __shared__ Slot scan[];
  render_lane<kHbm, false>(p, scan);
}

// The count mode's instance: the same loop with the counters.
template <bool kHbm>
__global__ void __launch_bounds__(kBlock, kMinBlocks) f64_count_kernel(Params p) {
  extern __shared__ Slot scan[];
  render_lane<kHbm, true>(p, scan);
}

// Launch `kernel` over p.padded lanes with `smem` bytes of staged table
// (allowed above 48 KB).
int launch(void (*kernel)(Params), const Params& p, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(p.padded + kBlock - 1) / kBlock, kBlock, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries: each launches on `stream` and returns cudaGetLastError().
// `groups`: the group table (group_table.cu) for the two-level scan, or
// null; layout 'hbm' takes none.
extern "C" int f64_render(const int32_t* ids, const float* ii, const float* jj,
                          const float* scene, int n, const double* cam, double* out, int padded,
                          int samples, int max_depth, uint32_t k0, uint32_t k1,
                          int sample_offset, int hbm, const int32_t* groups, void* stream) {
  if (hbm && groups) return (int)cudaErrorInvalidValue;
  const Params p{ids, ii, jj, scene, n, cam, out, padded, max_depth, k0, k1,
                 sample_offset, sample_offset + samples, groups, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = stage_bytes_d(n, hbm, groups != nullptr);
  return launch(hbm ? f64_kernel<true> : f64_kernel<false>, p, smem, st);
}

// The count mode: the render's loop (out gets the same sums) with
// counts (4, padded) int32: each lane's segments, and its issues, groups
// opened and slot tests as the leader of its scans (the one-level scan
// counts segments and issues only).
extern "C" int f64_counts(const int32_t* ids, const float* ii, const float* jj,
                          const float* scene, int n, const double* cam, double* out,
                          int32_t* counts, int padded, int samples, int max_depth, uint32_t k0,
                          uint32_t k1, int sample_offset, int hbm, const int32_t* groups,
                          void* stream) {
  if (hbm && groups) return (int)cudaErrorInvalidValue;
  const Params p{ids, ii, jj, scene, n, cam, out, padded, max_depth, k0, k1,
                 sample_offset, sample_offset + samples, groups, counts};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = stage_bytes_d(n, hbm, groups != nullptr);
  return launch(hbm ? f64_count_kernel<true> : f64_count_kernel<false>, p, smem, st);
}
