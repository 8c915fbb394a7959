// Forward path-tracing render, one thread per pixel, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingincuda_tpu/ops/pallas_kernel.py:
// _render_tile_kernel_regen, with its bodies _regen_body (K = 1) and
// _regen_body_multi (K > 1 pixels per lane; K only shapes the TPU
// schedule and never changes an image).
//
// What it computes. Lane i renders pixel ids[i]: for each sample s in
// [sample_offset, budget[i]) it starts a jittered, defocused primary ray,
// finds the closest of N spheres at each bounce, scatters (lambertian,
// metal or dielectric) from one unit-vector draw and one coin draw, and
// banks attenuation * sky on a miss. A scatter at bounce max_depth-1
// exits black; from rr_start on, Russian roulette keeps a path with
// p = clip(max channel, 0.05, 1) and weights survivors by 1/p. The
// samples' radiance is summed in sample order, as the JAX kernel sums it.
// With emit_depth the lane instead sums (bounce + 1) at each path's death
// (the difficulty prepass).
//
// What bounds it. The FP32 hit loop: about 20 flops per sphere per
// bounce, every thread scanning all N slots, plus warp divergence from
// unequal path lengths (a warp runs until its longest pixel finishes).
// What the design does about that: the scene sits in shared memory as
// one float4 per slot for the scan (a broadcast load, every thread of a
// warp reads the same slot), |C|^2 - r^2 is computed once per block while
// staging, and the host's difficulty order groups pixels of similar
// traced depth into the same warps (measured not to pay yet, PERF.md).
// The TPU's wave cap
// (samples * max_depth) never binds per thread, since no sample takes
// more than max_depth bounces.
//
// Exactness. Every expression keeps the association of the plain PyTorch
// version (ops/render_kernel.py:regen_reference) and of the JAX kernel.
// The build uses --fmad=false and no fast math, and sqrt, rsqrt, sin and
// cos are the fixed IEEE sequences of ops/f32math.py, so the kernel and
// the plain version agree bit for bit on the card. The closest hit keeps
// the smallest root numerator with a strict '<', so the first slot wins
// an exact tie; the JAX kernel blends such ties through its one-hot
// product. Exact-t ties between distinct spheres are measure-zero and
// absent from the three reference scenes. No atomics and no cross-block
// state: a render is bitwise deterministic from run to run.

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
};

struct Cam {
  V3 pixel00, du, dv, center, disk_u, disk_v;
  bool defocus;
};

// Jittered, defocus-blurred primary ray (ops/tracer.py:primary_rays_from_ij).
__device__ __forceinline__ void primary_ray(const Cam& cam, float fi, float fj,
                                            const Stream& st, uint32_t s, V3& o,
                                            V3& d) {
  float u0, u1, v0, v1;
  st.uniform2(s, 0, kDrawJitter, u0, u1);
  st.uniform2(s, 0, kDrawDefocus, v0, v1);
  const float r = sqrtf(v0);
  const float theta = kTwoPi * v1;
  const float px = r * sincos_f32(theta, true), py = r * sincos_f32(theta, false);
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

struct Params {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* budget;
  const float* scene;  // SoA (kNumCols, n)
  int n;
  const float* cam;
  float* out;          // (3, padded) radiance or (1, padded) segments
  int padded;
  int max_depth;
  uint32_t k0, k1;
  int sample_offset;
  int rr_start;        // < 0: off
  int legacy_sky, emit_depth, finalize;
  float scale;
};

// One slot's scan entry: (cx, cy, cz, c2r2), c2r2 = NaN when inactive so
// that its discriminant is NaN and the slot never hits.
__device__ __forceinline__ float4 scan_entry(const float* scene, int n, int k) {
  const float cx = scene[kCx * n + k], cy = scene[kCy * n + k], cz = scene[kCz * n + k];
  const float r = scene[kRadius * n + k];
  const float c2r2 = cx * cx + cy * cy + cz * cz - r * r;
  return make_float4(cx, cy, cz,
                     scene[kActive * n + k] > 0.5f ? c2r2 : __int_as_float(0x7fffffff));
}

template <bool kHbm>
__global__ void __launch_bounds__(kBlock) regen_kernel(Params p) {
  extern __shared__ float4 smem[];
  const int n = p.n;
  float4* scan = smem;
  float* gath = reinterpret_cast<float*>(smem + n);  // (kGather, n)
  if (!kHbm) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      scan[k] = scan_entry(p.scene, n, k);
#pragma unroll
      for (int c = 0; c < kGather; ++c) gath[c * n + k] = p.scene[(kRadius + c) * n + k];
    }
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.padded) return;
  // gathered columns: radius, albedo rgb, fuzz, ior, mat
  const float* g = kHbm ? p.scene + kRadius * n : gath;

  Cam cam;
  const float* c = p.cam;
  cam.pixel00 = {c[0], c[1], c[2]};
  cam.du = {c[3], c[4], c[5]};
  cam.dv = {c[6], c[7], c[8]};
  cam.center = {c[9], c[10], c[11]};
  cam.disk_u = {c[12], c[13], c[14]};
  cam.disk_v = {c[15], c[16], c[17]};
  cam.defocus = c[18] > 0.5f;

  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  const float fi = p.ii[i], fj = p.jj[i], budget = p.budget[i];
  V3 acc = {0.0f, 0.0f, 0.0f};
  float seg = 0.0f;

  for (uint32_t s = (uint32_t)p.sample_offset; (float)s < budget; ++s) {
    V3 o, d;
    primary_ray(cam, fi, fj, st, s, o, d);
    const V3 prim_d = d;
    V3 atten = {1.0f, 1.0f, 1.0f};
    for (int b = 0;; ++b) {
      // closest hit over all slots, minimum taken over root numerators
      const float a = fmaxf(dot(d, d), 1e-12f);
      const float d_dot_o = dot(d, o);
      const float o2 = dot(o, o);
      const float tmin_a = kTMin * a;
      float best = kTMiss;
      int win = 0;
      for (int k = 0; k < n; ++k) {
        const float4 e = kHbm ? scan_entry(p.scene, n, k) : scan[k];
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
      if (!(best < kTMiss)) {  // miss: bank the sky, the path ends
        if (!p.emit_depth) acc = acc + atten * sky(p.legacy_sky ? prim_d : d);
        seg += (float)b + 1.0f;
        break;
      }
      const float t = best * (1.0f / a);
      const V3 hp = o + d * t;
      const V3 center = kHbm ? V3{p.scene[kCx * n + win], p.scene[kCy * n + win],
                                  p.scene[kCz * n + win]}
                             : V3{scan[win].x, scan[win].y, scan[win].z};
      const float radius = g[0 * n + win];
      const float rs = fabsf(radius) > 1e-12f ? radius : 1e-12f;
      const V3 outward = (hp - center) * (1.0f / rs);
      const bool front = dot(d, outward) < 0.0f;
      const V3 normal = front ? outward : -outward;
      const int mat = (int)g[6 * n + win];

      V3 dir, att;
      bool scattered = true;
      if (mat == 0 || mat == 1) {
        float u0, u1;
        st.uniform2(s, (uint32_t)b, kDrawScatter, u0, u1);
        const float z = 1.0f - 2.0f * u0;
        const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
        const float phi = kTwoPi * u1;
        const V3 ur = {r * sincos_f32(phi, true), r * sincos_f32(phi, false), z};
        if (mat == 0) {  // lambertian
          dir = normal + ur;
          if (fabsf(dir.x) < 1e-6f && fabsf(dir.y) < 1e-6f && fabsf(dir.z) < 1e-6f)
            dir = normal;
        } else {  // metal
          dir = unit(reflect(d, normal)) + ur * g[4 * n + win];
          scattered = dot(dir, normal) > 0.0f;
        }
        att = {g[1 * n + win], g[2 * n + win], g[3 * n + win]};
      } else {  // dielectric (any other id takes this direction, as in JAX)
        float coin, unused;
        st.uniform2(s, (uint32_t)b, kDrawCoin, coin, unused);
        const float ior = g[5 * n + win];
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
                       : V3{g[1 * n + win], g[2 * n + win], g[3 * n + win]};
      }
      // absorbed, or scattering at the depth cap: the path ends black
      if (!scattered || b >= p.max_depth - 1) {
        seg += (float)b + 1.0f;
        break;
      }
      V3 next = atten * att;
      if (p.rr_start >= 0) {
        const float ps = fminf(fmaxf(fmaxf(fmaxf(next.x, next.y), next.z), 0.05f), 1.0f);
        float u_rr, unused;
        st.uniform2(s, (uint32_t)b, kDrawRR, u_rr, unused);
        const bool zone = b >= p.rr_start;
        if (zone && u_rr >= ps) {
          seg += (float)b + 1.0f;
          break;
        }
        next = next * (zone ? 1.0f / ps : 1.0f);
      }
      atten = next;
      o = hp;
      d = dir;
    }
  }

  if (p.emit_depth) {
    p.out[i] = seg;
    return;
  }
  if (p.finalize) {  // 1/spp, then gamma 2 (sqrt of positive values)
    acc = acc * p.scale;
    acc = {acc.x > 0.0f ? sqrtf(acc.x) : 0.0f, acc.y > 0.0f ? sqrtf(acc.y) : 0.0f,
           acc.z > 0.0f ? sqrtf(acc.z) : 0.0f};
  }
  p.out[i] = acc.x;
  p.out[p.padded + i] = acc.y;
  p.out[2 * p.padded + i] = acc.z;
}

}  // namespace

// C entry: launches on `stream` and returns cudaGetLastError().
extern "C" int regen_render(const int32_t* ids, const float* ii, const float* jj,
                            const float* budget, const float* scene, int n,
                            const float* cam, float* out, int padded, int max_depth,
                            uint32_t k0, uint32_t k1, int sample_offset, int rr_start,
                            int legacy_sky, int emit_depth, int finalize, float scale,
                            int hbm, void* stream) {
  const Params p{ids, ii, jj, budget, scene, n, cam, out, padded, max_depth, k0, k1,
                 sample_offset, rr_start, legacy_sky, emit_depth, finalize, scale};
  const dim3 grid((padded + kBlock - 1) / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hbm) {
    regen_kernel<true><<<grid, kBlock, 0, st>>>(p);
  } else {
    const size_t smem = (size_t)n * (sizeof(float4) + kGather * sizeof(float));
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          regen_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    regen_kernel<false><<<grid, kBlock, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}
