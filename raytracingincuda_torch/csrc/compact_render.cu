// Forward render by live-ray compaction, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingincuda_tpu/ops/pallas_kernel.py:
// _render_tile_kernel_compact (with _bounce_rows, _lane_prefix_sum and
// _permute_lanes), render_pallas(mode='compact').
//
// What it computes. The image of the regeneration kernel (regen_render.cu)
// under the parity estimator and the current-bounce sky, bit for bit, by
// another schedule: a block owns a tile of kTile lanes (one pixel each)
// and renders its samples one after another. Per sample, every lane's
// primary ray enters a pool; each wave advances the live rays of the pool
// by one bounce, and the survivors are then packed to the front of the
// pool in their order (a stable pack). A ray that misses banks
// atten * sky into its lane's slot; after the sample each lane adds its
// slot to its sum, so the samples' radiance is summed in sample order, as
// kernel 1 sums it.
//
// What bounds it. The FP32 hit loop, as in kernel 1 (about 18 operations
// a sphere test with |C|^2 - r^2 staged). Kernel 1's threads each trace
// their own pixel, so a warp runs until its longest path ends; here the
// live rays of the tile fill the first warps after every wave, and warps
// wholly past the live count sit the wave out. What it pays for that: two
// block barriers a wave, a round trip of each survivor's state (11 words)
// through shared memory, and a block that waits for its longest path each
// sample. The design, a block-local pool, is the analog of the TPU
// kernel's per-tile VMEM pool and its dead-block skip (a device-wide queue
// with a launch per wave was not built). The pack is a warp ballot and
// popc, then a prefix over the block's eight warp counts. No atomics.
//
// Exactness. Each bounce is path_common.cuh's ScanHit and scatter_bounce,
// the arithmetic of regen_render.cu; a sample's radiance is added only on
// a miss, as there. The plain version is ops/compact_kernel.py:
// compact_reference (the JAX compact recurrence).

#include "path_common.cuh"

namespace {

constexpr int kTile = 256;  // lanes (threads) per block, the ray pool's size
constexpr int kWarps = kTile / 32;

struct Params {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* scene;  // SoA (kNumCols, n)
  int n;
  const float* cam;
  float* out;          // (3, padded)
  int padded;
  int samples, max_depth;
  uint32_t k0, k1;
  int finalize;
  float scale;
};

// The pool: a live ray's state between waves.
struct Pool {
  float o[3][kTile], d[3][kTile], atten[3][kTile];
  uint32_t pix[kTile];
  int lane[kTile];
  float rad[3][kTile];  // each lane's radiance for this sample
  bool banked[kTile];   // the lane's ray missed this sample
  int warp_alive[kWarps];
};

template <bool kHbm>
__global__ void __launch_bounds__(kTile) compact_kernel(Params p) {
  extern __shared__ float4 smem[];
  __shared__ Pool pool;
  const int n = p.n;
  float* gath = reinterpret_cast<float*>(smem + n);  // (kGather, n)
  if (!kHbm) stage_scene(p.scene, n, smem, gath);
  __syncthreads();
  const ScanHit<kHbm> hit{SceneView{p.scene, smem, kHbm ? p.scene + kRadius * n : gath, n}};
  const Cam cam = load_cam(p.cam);
  const int t = threadIdx.x, warp = t / 32, wl = t % 32;
  const int first = blockIdx.x * kTile;
  const int n_lanes = min(kTile, p.padded - first);  // lanes 0..n_lanes-1 take part
  const int i = first + t;
  const uint32_t my_pix = t < n_lanes ? (uint32_t)p.ids[i] : 0u;
  const float fi = t < n_lanes ? p.ii[i] : 0.0f, fj = t < n_lanes ? p.jj[i] : 0.0f;
  V3 acc = {0.0f, 0.0f, 0.0f};

  for (int s = 0; s < p.samples; ++s) {
    // every lane's primary ray enters the pool at its own slot
    V3 o = {0.0f, 0.0f, 0.0f}, d = o, atten = {1.0f, 1.0f, 1.0f};
    uint32_t pix = my_pix;
    int lane = t;
    if (t < n_lanes) primary_ray(cam, fi, fj, Stream{p.k0, p.k1, pix}, (uint32_t)s, o, d);
    pool.banked[t] = false;
    int n_alive = n_lanes;
    for (int b = 0; b < p.max_depth && n_alive > 0; ++b) {
      bool alive = false;
      if (t < n_alive) {
        const Stream st{p.k0, p.k1, pix};
        int win;
        float th;
        if (!hit(o, d, win, th)) {
          const V3 c = atten * sky(d);
          pool.rad[0][lane] = c.x;
          pool.rad[1][lane] = c.y;
          pool.rad[2][lane] = c.z;
          pool.banked[lane] = true;
        } else {
          alive = scatter_bounce<kHbm>(hit.sc, st, (uint32_t)s, b, p.max_depth, -1, win, th, o,
                                       d, atten);
        }
      }
      // stable pack of the survivors to the front of the pool
      const unsigned m = __ballot_sync(0xffffffffu, alive);
      if (wl == 0) pool.warp_alive[warp] = __popc(m);
      __syncthreads();
      int base = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = pool.warp_alive[w];
        base += w < warp ? c : 0;
        total += c;
      }
      if (alive) {
        const int dst = base + __popc(m & ((1u << wl) - 1u));
        pool.o[0][dst] = o.x, pool.o[1][dst] = o.y, pool.o[2][dst] = o.z;
        pool.d[0][dst] = d.x, pool.d[1][dst] = d.y, pool.d[2][dst] = d.z;
        pool.atten[0][dst] = atten.x, pool.atten[1][dst] = atten.y, pool.atten[2][dst] = atten.z;
        pool.pix[dst] = pix;
        pool.lane[dst] = lane;
      }
      __syncthreads();
      n_alive = total;
      if (t < n_alive) {
        o = {pool.o[0][t], pool.o[1][t], pool.o[2][t]};
        d = {pool.d[0][t], pool.d[1][t], pool.d[2][t]};
        atten = {pool.atten[0][t], pool.atten[1][t], pool.atten[2][t]};
        pix = pool.pix[t];
        lane = pool.lane[t];
      }
      // the next wave writes warp_alive and the pool only after its first
      // barrier, which every thread reaches after these reads
    }
    __syncthreads();  // the sample's banked radiance is in place
    if (pool.banked[t]) acc = acc + V3{pool.rad[0][t], pool.rad[1][t], pool.rad[2][t]};
    __syncthreads();  // read before the next sample's resets
  }

  if (t >= n_lanes) return;
  if (p.finalize) acc = gamma2(acc * p.scale);  // 1/spp, then gamma 2
  p.out[i] = acc.x;
  p.out[p.padded + i] = acc.y;
  p.out[2 * p.padded + i] = acc.z;
}

}  // namespace

// C entry: launches on `stream` and returns cudaGetLastError().
extern "C" int compact_render(const int32_t* ids, const float* ii, const float* jj,
                              const float* scene, int n, const float* cam, float* out,
                              int padded, int samples, int max_depth, uint32_t k0, uint32_t k1,
                              int finalize, float scale, int hbm, void* stream) {
  const Params p{ids, ii, jj, scene, n, cam, out, padded, samples, max_depth, k0, k1,
                 finalize, scale};
  const dim3 grid((padded + kTile - 1) / kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // static (the pool) plus dynamic (the staged scene) above 48 KB needs
  // the attribute even when the dynamic part alone is below it
  const size_t smem = hbm ? 0 : (size_t)n * (sizeof(float4) + kGather * sizeof(float));
  if (smem + sizeof(Pool) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hbm ? compact_kernel<true> : compact_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (hbm) {
    compact_kernel<true><<<grid, kTile, 0, st>>>(p);
  } else {
    compact_kernel<false><<<grid, kTile, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}
