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
// What bounds it. The FP32 hit loop: 18 operations per sphere per traced
// segment, every thread scanning all N slots (about 21 instructions a
// slot: --fmad=false keeps each multiply and add apart), and warp
// divergence from unequal path lengths. What the design does about that:
//   * the loop regenerates (path_common.cuh's regen_lane), as the TPU
//     kernel does: one segment an iteration, and a lane whose path ended
//     starts its pixel's next sample at the next iteration. A warp then
//     pays its longest lane's total of segments, where a loop over samples
//     around trace_sample's bounce loop paid, sample by sample, the
//     longest path of the warp (2.9x the lanes' mean at the headline's
//     parity, 1.5x at rr2, against 1.23x and 1.08x now);
//   * the scene sits in shared memory as one float4 per slot for the scan
//     (a broadcast load: every thread of a warp reads the same slot), with
//     |C|^2 - r^2 computed once per block while staging, and ScanHit tests
//     four slots a step, their loads and discriminants ahead of the roots.
// No minimum of blocks an SM is asked of the compiler: at 7 the four-slot
// step spills, and 6 blocks without spills render faster. The host's
// difficulty order is not used: raster neighbours share their depth, and
// the order's warps took longer (PERF.md). The TPU's wave cap
// (samples * max_depth) never binds per thread, since no sample takes
// more than max_depth bounces.
//
// The count mode (count_kernel) runs the same loop and writes each lane's
// traced segments and, per warp, the times the hit test was issued: the
// leader of each group of lanes that runs it together adds one.
//
// Exactness. The device code is path_common.cuh's, one copy for this
// kernel and the train kernels: the association of the plain PyTorch
// version (ops/render_kernel.py:regen_reference) and of the JAX kernel,
// --fmad=false, no fast math, and the fixed IEEE sqrt, rsqrt, sin and cos
// of ops/f32math.py, so the kernel and the plain version agree bit for
// bit on the card. The closest hit keeps the smallest root numerator with
// a strict '<', so the first slot wins an exact tie; the JAX kernel
// blends such ties through its one-hot product. Exact-t ties between
// distinct spheres are measure-zero and absent from the three reference
// scenes. No atomics (but the count mode's) and no cross-block state: a
// render is bitwise deterministic from run to run.

#include "path_common.cuh"

namespace {

struct Params {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* budget;
  const float* scene;  // SoA (kNumCols, n)
  int n;
  const float* cam;
  float* out;          // (3, padded) radiance or (1, padded) segments
  // at most render_kernel.MAX_LANES: 3 x lanes fits int, so the (3, lanes) rows index in int
  int padded;
  int max_depth;
  uint32_t k0, k1;
  int sample_offset;
  int rr_start;        // < 0: off
  int legacy_sky, emit_depth, finalize;
  float scale;
};

template <bool kHbm>
__device__ __forceinline__ ScanHit<kHbm> staged_hit(const Params& p, float4* smem) {
  const int n = p.n;
  float* gath = reinterpret_cast<float*>(smem + n);  // (kGather, n)
  if (!kHbm) {
    stage_scene(p.scene, n, smem, gath);
    __syncthreads();
  }
  return ScanHit<kHbm>{SceneView{p.scene, smem, kHbm ? p.scene + kRadius * n : gath, n}};
}

template <bool kHbm>
__global__ void __launch_bounds__(kBlock) regen_kernel(Params p) {
  extern __shared__ float4 smem[];
  const ScanHit<kHbm> hit = staged_hit<kHbm>(p, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.padded) return;
  const Cam cam = load_cam(p.cam);
  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  V3 acc = {0.0f, 0.0f, 0.0f};
  float seg = 0.0f;
  regen_lane(hit, cam, st, p.ii[i], p.jj[i], (uint32_t)p.sample_offset, p.budget[i],
             p.max_depth, p.rr_start, p.legacy_sky, [](int, const Entry&) {},
             [&](const PathEnd& e) {
               if (e.missed) acc = acc + e.contrib;
               seg += (float)e.bounce + 1.0f;
             });

  if (p.emit_depth) {
    p.out[i] = seg;
    return;
  }
  if (p.finalize) acc = gamma2(acc * p.scale);  // 1/spp, then gamma 2
  p.out[i] = acc.x;
  p.out[p.padded + i] = acc.y;
  p.out[2 * p.padded + i] = acc.z;
}

// The count mode: out (1, padded) gets each lane's segments and issues
// (padded / 32) the hit-test issues of each warp.
template <bool kHbm>
__global__ void __launch_bounds__(kBlock) count_kernel(Params p, int32_t* issues) {
  extern __shared__ float4 smem[];
  __shared__ int warp_issues[kBlock / 32];
  if (threadIdx.x < kBlock / 32) warp_issues[threadIdx.x] = 0;
  const ScanHit<kHbm> hit = staged_hit<kHbm>(p, smem);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Cam cam = load_cam(p.cam);
  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  float seg = 0.0f;
  regen_lane(hit, cam, st, p.ii[i], p.jj[i], (uint32_t)p.sample_offset, p.budget[i],
             p.max_depth, p.rr_start, p.legacy_sky,
             [&](int, const Entry&) {
               if (lane == __ffs(__activemask()) - 1) atomicAdd(&warp_issues[warp], 1);
             },
             [&](const PathEnd& e) { seg += (float)e.bounce + 1.0f; });
  p.out[i] = seg;
  __syncwarp();
  if (lane == 0) issues[i / 32] = warp_issues[warp];
}

// Dynamic shared memory for the staged scene, allowed above 48 KB.
template <class K>
int stage_bytes(K kernel, int n, int hbm, size_t* smem) {
  *smem = hbm ? 0 : (size_t)n * (sizeof(float4) + kGather * sizeof(float));
  if (*smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*smem);
}

}  // namespace

// C entries: each launches on `stream` and returns cudaGetLastError().
extern "C" int regen_render(const int32_t* ids, const float* ii, const float* jj,
                            const float* budget, const float* scene, int n,
                            const float* cam, float* out, int padded, int max_depth,
                            uint32_t k0, uint32_t k1, int sample_offset, int rr_start,
                            int legacy_sky, int emit_depth, int finalize, float scale,
                            int hbm, void* stream) {
  const Params p{ids, ii, jj, budget, scene, n, cam, out, padded, max_depth, k0, k1,
                 sample_offset, rr_start, legacy_sky, emit_depth, finalize, scale};
  auto kernel = hbm ? regen_kernel<true> : regen_kernel<false>;
  size_t smem;
  const int e = stage_bytes(kernel, n, hbm, &smem);
  if (e) return e;
  kernel<<<(padded + kBlock - 1) / kBlock, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The count mode over `padded` lanes (a multiple of kBlock): segments per
// lane into seg, hit-test issues per warp into issues.
extern "C" int regen_counts(const int32_t* ids, const float* ii, const float* jj,
                            const float* budget, const float* scene, int n,
                            const float* cam, float* seg, int32_t* issues, int padded,
                            int max_depth, uint32_t k0, uint32_t k1, int sample_offset,
                            int rr_start, int legacy_sky, int hbm, void* stream) {
  if (padded % kBlock) return (int)cudaErrorInvalidValue;
  const Params p{ids, ii, jj, budget, scene, n, cam, seg, padded, max_depth, k0, k1,
                 sample_offset, rr_start, legacy_sky, 1, 0, 0.0f};
  auto kernel = hbm ? count_kernel<true> : count_kernel<false>;
  size_t smem;
  const int e = stage_bytes(kernel, n, hbm, &smem);
  if (e) return e;
  kernel<<<padded / kBlock, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(p, issues);
  return (int)cudaGetLastError();
}
