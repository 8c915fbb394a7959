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
// The TPU's wave cap (samples * max_depth) never binds per thread, since
// no sample takes more than max_depth bounces.
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
// scenes. No atomics and no cross-block state: a render is bitwise
// deterministic from run to run.

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
  int padded;
  int max_depth;
  uint32_t k0, k1;
  int sample_offset;
  int rr_start;        // < 0: off
  int legacy_sky, emit_depth, finalize;
  float scale;
};

template <bool kHbm>
__global__ void __launch_bounds__(kBlock) regen_kernel(Params p) {
  extern __shared__ float4 smem[];
  const int n = p.n;
  float* gath = reinterpret_cast<float*>(smem + n);  // (kGather, n)
  if (!kHbm) {
    stage_scene(p.scene, n, smem, gath);
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.padded) return;
  const ScanHit<kHbm> hit{SceneView{p.scene, smem, kHbm ? p.scene + kRadius * n : gath, n}};
  const Cam cam = load_cam(p.cam);
  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  const float fi = p.ii[i], fj = p.jj[i], budget = p.budget[i];
  V3 acc = {0.0f, 0.0f, 0.0f};
  float seg = 0.0f;

  for (uint32_t s = (uint32_t)p.sample_offset; (float)s < budget; ++s) {
    const PathEnd e = trace_sample(hit, cam, st, fi, fj, s, p.max_depth, p.rr_start,
                                   p.legacy_sky);
    if (e.missed && !p.emit_depth) acc = acc + e.contrib;
    seg += (float)e.bounce + 1.0f;
  }

  if (p.emit_depth) {
    p.out[i] = seg;
    return;
  }
  if (p.finalize) acc = gamma2(acc * p.scale);  // 1/spp, then gamma 2
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
