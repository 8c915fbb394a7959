// Forward render by live-ray compaction, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingincuda_tpu/ops/pallas_kernel.py:
// _render_tile_kernel_compact (with _bounce_rows, _lane_prefix_sum and
// _permute_lanes), render_pallas(mode='compact').
//
// What it computes. The image of the regeneration kernel (regen_render.cu)
// under the parity estimator and the current-bounce sky, bit for bit, by
// another schedule: a block owns a tile of kTile lanes (one pixel each)
// and keeps a pool of kTile rays in flight, one for each lane that has
// samples left. At the start lane t's sample-0 primary ray sits in entry
// t. Each wave advances every live entry by one path segment: the closest
// hit, then scatter_bounce after a hit. A miss adds atten * sky to the
// lane's sum. When the path ends (a miss or black) and the lane has
// samples left, the entry starts the lane's next sample at the next wave
// and stays live; so a lane has one ray in flight, its samples' radiance
// is summed in sample order, as kernel 1 sums it, and an entry leaves the
// pool only with its lane's last sample, writing the lane's sum.
//
// What bounds it. The FP32 hit loop, as in kernel 1 (about 18 operations
// a sphere test with |C|^2 - r^2 staged). Kernel 1's threads each trace
// their own pixel, so a warp runs until its longest lane's total of
// segments ends; here the live entries fill the first warps after every
// wave in which some entry left, and warps wholly past the live count sit
// the wave out, so the block issues about ceil(live / 32) warp scans a
// wave and waits only for its longest lane's total. What it pays for
// that: one block barrier a wave (__syncthreads_count, which also gives
// the live count), and in the waves where the live count fell, a stable
// pack of the survivors to the front of the pool (a warp ballot and popc,
// then a prefix over the block's warp counts; no atomics) that moves each
// survivor's 16 words through shared memory, with one more barrier. The
// design, a block-local pool, is the analog of the TPU kernel's per-tile
// VMEM pool and its dead-block skip (a device-wide queue with a launch
// per wave was not built). kTile = 128: at 256 lanes a block holds 74
// registers a thread and 3 blocks an SM (24 warps) and ran 12% slower;
// at 128, 72 registers and 7 blocks (28 warps), level with kernel 1 at
// 100 spp and faster at 2 spp (PERF.md).
//
// The closest hit is ScanHit's: the two-level scan where the wrapper passes
// a group table (staged beside the scene), the lanes in the scan voting on
// each group among themselves.
//
// Exactness. Each segment is path_common.cuh's primary_ray, ScanHit and
// scatter_bounce, the arithmetic of regen_render.cu, in the statements'
// order of its regen_lane; a sample's radiance is added only on a miss,
// as there. The plain version is ops/compact_kernel.py:compact_reference
// (the JAX per-sample compact recurrence), which gives the same bits.

#include "path_common.cuh"

namespace {

constexpr int kTile = 128;  // lanes (threads) per block, the ray pool's size
constexpr int kWarps = kTile / 32;

struct Params {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* scene;  // SoA (kNumCols, n)
  int n;
  const float* cam;
  float* out;          // (3, padded)
  // at most render_kernel.MAX_LANES: 3 x lanes fits int, so the (3, lanes) rows index in int
  int padded;
  int samples, max_depth;
  uint32_t k0, k1;
  int finalize;
  float scale;
  const int32_t* groups;  // the group table, or null: the one-level scan
};

// The pool: each live entry's state, read and written only in the waves
// where the live count fell.
struct Pool {
  float o[3][kTile], d[3][kTile], atten[3][kTile], acc[3][kTile];
  uint32_t pix[kTile];
  int lane[kTile], sample[kTile], bounce[kTile];
  int warp_alive[kWarps];
};

template <bool kHbm>
__global__ void __launch_bounds__(kTile) compact_kernel(Params p) {
  extern __shared__ float4 smem[];
  __shared__ Pool pool;
  const int n = p.n;
  float* gath = reinterpret_cast<float*>(smem + n);  // (kGather, n)
  Groups gr;
  if (!kHbm) {
    stage_scene(p.scene, n, smem, gath);
    gr = stage_groups(p.groups, n, reinterpret_cast<char*>(smem) + stage_offset(n));
  }
  __syncthreads();
  const ScanHit<kHbm> hit{SceneView{p.scene, smem, kHbm ? p.scene + kRadius * n : gath, n}, gr};
  const Cam cam = load_cam(p.cam);
  const int t = threadIdx.x, warp = t / 32, wl = t % 32;
  const int first = blockIdx.x * kTile;
  // entry t starts as lane t at sample 0, bounce 0; lanes past the image's
  // padded lanes never enter
  int n_alive = min(kTile, p.padded - first);
  int lane = t, s = 0, b = 0;
  uint32_t pix = t < n_alive ? (uint32_t)p.ids[first + t] : 0u;
  V3 o = {0.0f, 0.0f, 0.0f}, d = o, atten = o, acc = o;

  for (;;) {
    bool alive = false;
    if (t < n_alive) {  // one segment of this entry's path
      const int i = first + lane;
      const Stream st{p.k0, p.k1, pix};
      if (b == 0) {
        primary_ray(cam, p.ii[i], p.jj[i], st, (uint32_t)s, o, d);
        atten = {1.0f, 1.0f, 1.0f};
      }
      int win;
      float th;
      bool ended = true;
      if (!hit(o, d, win, th)) {
        acc = acc + atten * sky(d);
      } else {
        ended = !scatter_bounce<kHbm>(hit.sc, st, (uint32_t)s, b, p.max_depth, -1, win, th, o,
                                      d, atten);
      }
      if (ended) {
        ++s;
        b = 0;
      } else {
        ++b;
      }
      alive = s < p.samples;
      if (!alive) {  // the lane's last sample: it leaves with its sum
        if (p.finalize) acc = gamma2(acc * p.scale);  // 1/spp, then gamma 2
        p.out[i] = acc.x;
        p.out[p.padded + i] = acc.y;
        p.out[2 * p.padded + i] = acc.z;
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, alive);
    if (wl == 0) pool.warp_alive[warp] = __popc(m);
    const int total = __syncthreads_count(alive);
    if (total == 0) break;
    if (total < n_alive) {
      // stable pack of the survivors to the front of the pool
      int base = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) base += w < warp ? pool.warp_alive[w] : 0;
      if (alive) {
        const int dst = base + __popc(m & ((1u << wl) - 1u));
        pool.o[0][dst] = o.x, pool.o[1][dst] = o.y, pool.o[2][dst] = o.z;
        pool.d[0][dst] = d.x, pool.d[1][dst] = d.y, pool.d[2][dst] = d.z;
        pool.atten[0][dst] = atten.x, pool.atten[1][dst] = atten.y, pool.atten[2][dst] = atten.z;
        pool.acc[0][dst] = acc.x, pool.acc[1][dst] = acc.y, pool.acc[2][dst] = acc.z;
        pool.lane[dst] = lane;
        pool.pix[dst] = pix;
        pool.sample[dst] = s;
        pool.bounce[dst] = b;
      }
      __syncthreads();
      if (t < total) {
        o = {pool.o[0][t], pool.o[1][t], pool.o[2][t]};
        d = {pool.d[0][t], pool.d[1][t], pool.d[2][t]};
        atten = {pool.atten[0][t], pool.atten[1][t], pool.atten[2][t]};
        acc = {pool.acc[0][t], pool.acc[1][t], pool.acc[2][t]};
        lane = pool.lane[t];
        pix = pool.pix[t];
        s = pool.sample[t];
        b = pool.bounce[t];
      }
      // the next wave writes warp_alive and the pool only after its
      // barrier, which every thread reaches after these reads
    }
    n_alive = total;
  }
}

}  // namespace

// C entry: launches on `stream` and returns cudaGetLastError().
extern "C" int compact_render(const int32_t* ids, const float* ii, const float* jj,
                              const float* scene, int n, const float* cam, float* out,
                              int padded, int samples, int max_depth, uint32_t k0, uint32_t k1,
                              int finalize, float scale, int hbm, const int32_t* groups,
                              void* stream) {
  if (hbm && groups) return (int)cudaErrorInvalidValue;
  const Params p{ids, ii, jj, scene, n, cam, out, padded, samples, max_depth, k0, k1,
                 finalize, scale, groups};
  const dim3 grid((padded + kTile - 1) / kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // static (the pool) plus dynamic (the staged scene) above 48 KB needs
  // the attribute even when the dynamic part alone is below it
  const size_t smem = staged_bytes(n, hbm, groups != nullptr);
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
