// Scene and camera gradients, and the fused per-pixel-loss train step, one
// thread per pixel, for Hopper (sm_90a).
//
// Replaces the TPU kernels of raytracingincuda_tpu/ops/pallas_backward.py:
//   * grad_render (kernel 3): _grad_tile_kernel_hbm (:1424), and the two
//     other schedules of the same function, _grad_tile_kernel_wave (:1396)
//     and _grad_tile_kernel (:579);
//   * fused_train_render (kernel 2): _fused_tile_kernel (:1464) in its
//     park='hbm' mode (_regen_render_k, _hbm_park_render :1137,
//     _hbm_reverse :1221).
//
// What they compute. Kernel 3: for an upstream cotangent g of each lane's
// radiance sum, the cotangents of the scene matrix's columns 0-8 (centre,
// radius, albedo, fuzz, ior) and of the 18 camera scalars, under the
// detached-sampler convention (ops/backward.py). Kernel 2: the regen render
// of every lane's pixel (path_common.cuh's regen_lane, so the image equals
// regen_render's bit for bit), the pointwise image, loss term and g (mse,
// l1, huber or relmse, through 1/spp and gamma), then kernel 3's reverse
// with that g.
//
// Kernel 2 is two launches per window of lanes; kernel 3 is the second.
//   1. park_render_kernel: regen_render's loop (path_common.cuh's
//      regen_lane) at regen_render's resources (the staged scene and
//      nothing else in shared memory, no stack), so it runs at the regen
//      kernel's occupancy. Each sample's winning slots
//      are appended to the lane's park column: one int32 per bounce, -1 at
//      the miss, and a single -2 for a path that ends black (it passes
//      nothing back). Entry j of lane i sits at j * lanes + i (64-bit
//      index), so a warp's stores coalesce where its lanes stand at the same
//      entry. A lane parks whole samples from sample 0 on, up to its
//      capacity; the first sample that would overflow and all after it are
//      not parked, and the lane records how many were. Then loss_block gives
//      the image, g and the loss term; the loss meets in a fixed block tree.
//   2. reverse_kernel: per sample in order, the state entering each bounce
//      (origin, direction, attenuation) is rebuilt into a per-thread stack
//      of kDepth entries (40 bytes each, in local memory; an instance for 64
//      bounces, the main paths' depths, and one for 256, the sampler's bound,
//      taken only above 64):
//      from the park by replay (the primary ray, then per bounce the winner's
//      own sphere test, which is the scan's arithmetic for that slot, and
//      scatter_bounce: the entries are the render's bit for bit, at one test
//      a bounce instead of one per slot), or, for a sample that was not
//      parked, by a full trace. A path that banked radiance then walks its
//      stack backwards through scatter_vjp (ops/backward.py:
//      winner_bounce_vjp line for line) and the primary ray's adjoint.
// The TPU parks the full state (40 bytes a bounce); the winning slot is all
// the replay needs, so the park is 4 bytes an entry: about 190 entries a
// lane at the headline (rr2, 100 spp) and 760 MB for the whole image, which
// fits the wrapper's budget in one window (ops/train_kernel.py:plan_park).
//
// Determinism, with no float atomics and no block-wide barrier in the
// reverse. The warp walks its lanes' paths in rounds (one bounce a round,
// __any_sync over the warp): each lane stages its nine cotangents in the
// warp's columns of shared memory, the lanes of one slot (__match_any_sync)
// are summed in lane order by the lowest, and that lane adds the sum to the
// warp's own (slots, 9) accumulator: a slice of shared memory where four
// fit beside the staged scene without lowering the reverse's 4 blocks an SM
// (about 270 slots), else the warp's slice of a scratch buffer in device
// memory (the same order, so the same bits). At the block's end its
// four accumulators are summed in warp order into the block's partial, and
// reduce_rows sums the partials in block order. The camera's 18 sums (and
// the loss) stay in registers over the samples and meet in a fixed tree.
// A sample's cotangents enter the sums in the same order whether it was
// parked or re-traced, so the gradients are the same bits at any capacity
// and any window.
//
// What bounds it. The render: the FP32 hit loop (18 operations a sphere
// test, every slot each bounce), as kernel 1. The park: 4 bytes written
// and read per bounce. The reverse: a few hundred FP32 operations per
// bounce (replay and adjoint), and the warp's rounds, which wait for its
// longest path.
#include "train_common.cuh"

namespace {

constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // bytes a Hopper block may take
constexpr size_t kReverseStatic = sizeof(float) * kGradCols * kBlock;
constexpr int32_t kParkedBlack = -2;

// Where the entry of each bounce goes: the reverse's per-thread stack
// (trace_sample), and the park render's column (regen_lane), which takes
// the winning slot of each bounce.
struct StackSink {
  Entry* stack;
  __device__ __forceinline__ void operator()(int b, const Entry& e) const { stack[b] = e; }
};
struct ParkSink {
  int32_t* col;   // the lane's next free entry
  size_t stride;  // the window's lanes
  int room;       // entries left; 0 once a sample has overflowed
  __device__ __forceinline__ void operator()(int b, const Entry& e) const {
    if (b < room) col[(size_t)b * stride] = e.slot;
  }
};

struct ParkParams {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* target;  // (3, stride)
  const float* scene;   // SoA (kNumCols, n)
  int n;
  const float* cam;
  // at most render_kernel.MAX_LANES: 3 x lanes fits int, so the (3, lanes) rows index in int
  int lanes, stride, samples, max_depth;
  uint32_t k0, k1;
  int rr_start;
  LossConsts lk;
  float* image;         // (3, stride)
  float* g;             // (3, stride)
  float* loss_part;     // (lanes / kBlock)
  int32_t* park;        // (capacity, lanes); null when capacity is 0
  int capacity;
  int32_t* parked;      // (2, stride): samples parked, entries used
};

template <bool kHbm>
__global__ void __launch_bounds__(kBlock) park_render_kernel(ParkParams p) {
  extern __shared__ float4 smem[];
  __shared__ float red[1][kBlock];
  const int n = p.n;
  float* gath = reinterpret_cast<float*>(smem + n);
  if (!kHbm) {
    stage_scene(p.scene, n, smem, gath);
    __syncthreads();
  }
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kBlock + tid;  // lanes is a multiple of kBlock
  const ScanHit<kHbm> hit{SceneView{p.scene, smem, kHbm ? p.scene + kRadius * n : gath, n}};
  const Cam cam = load_cam(p.cam);
  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  const float fi = p.ii[i], fj = p.jj[i];
  ParkSink sink{p.park ? p.park + i : nullptr, (size_t)p.lanes, p.capacity};
  int parked = 0, used = 0;
  V3 rad = {0.0f, 0.0f, 0.0f};
  regen_lane(hit, cam, st, fi, fj, 0u, (float)p.samples, p.max_depth, p.rr_start, false, sink,
             [&](const PathEnd& e) {
               if (e.missed) rad = rad + e.contrib;
               const int entries = e.missed ? e.bounce + 1 : 1;
               if (entries <= sink.room) {
                 if (!e.missed) sink.col[0] = kParkedBlack;
                 sink.col += (size_t)entries * sink.stride;
                 sink.room -= entries;
                 used += entries;
                 ++parked;
               } else {
                 sink.room = 0;
               }
             });
  const V3 row = {p.target[i], p.target[p.stride + i], p.target[2 * p.stride + i]};
  V3 img;
  float loss_term;
  const V3 g = loss_block(p.lk, rad, row, p.ids[i] < p.lk.num_pixels, img, loss_term);
  p.image[i] = img.x;
  p.image[p.stride + i] = img.y;
  p.image[2 * p.stride + i] = img.z;
  p.g[i] = g.x;
  p.g[p.stride + i] = g.y;
  p.g[2 * p.stride + i] = g.z;
  p.parked[i] = parked;
  p.parked[p.stride + i] = used;
  red[0][tid] = loss_term;
  block_tree(red, 1);
  if (tid == 0) p.loss_part[blockIdx.x] = red[0][0];
}

// The winner's t at (o, d): ScanHit's arithmetic for the one slot k, so the
// same bits as the scan that chose it.
template <bool kHbm>
__device__ __forceinline__ float winner_t(const SceneView& sc, V3 o, V3 d, int k) {
  const float a = fmaxf(dot(d, d), 1e-12f);
  float best = kTMiss;
  int win = k;
  test_slot(slot_entry<kHbm>(sc, k), o, d, a, dot(d, o), dot(o, o), kTMin * a, k, best, win);
  return best * (1.0f / a);
}

// Rebuild a parked sample's stack from its winning slots, advancing `col`
// past its entries.
template <bool kHbm>
__device__ __forceinline__ PathEnd replay(const SceneView& sc, const Cam& cam,
                                          const Stream& st, float fi, float fj, uint32_t s,
                                          int max_depth, int rr_start, const int32_t*& col,
                                          size_t stride, Entry* stack) {
  V3 o, d;
  primary_ray(cam, fi, fj, st, s, o, d);
  V3 atten = {1.0f, 1.0f, 1.0f};
  for (int b = 0;; ++b) {
    const int k = __ldg(col);
    col += stride;
    if (k == kParkedBlack) return {b, false, {0.0f, 0.0f, 0.0f}};
    stack[b] = Entry{o, d, atten, k};
    if (k < 0) return {b, true, {0.0f, 0.0f, 0.0f}};
    scatter_bounce<kHbm>(sc, st, s, b, max_depth, rr_start, k, winner_t<kHbm>(sc, o, d, k), o,
                         d, atten);
  }
}

// One round of the warp's reverse: the lanes of each slot are summed in lane
// order by the lowest, which adds the sum to the warp's accumulator. `val`
// is the warp's 32 columns of the staging array. Called by all 32 lanes.
__device__ __forceinline__ void commit_warp(float* acc, bool have, int slot, const float* dv,
                                            float (*val)[kBlock], int base) {
  const int lane = threadIdx.x & 31;
  const int sl = have ? slot : -1;
  if (have)
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) val[c][base + lane] = dv[c];
  __syncwarp();
  const unsigned peers = __match_any_sync(kFull, sl);
  if (sl >= 0 && lane == __ffs(peers) - 1) {
    float v[kGradCols];
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) v[c] = dv[c];
    for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1) {
      const int l = base + __ffs(rest) - 1;
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) v[c] += val[c][l];
    }
    float* a = acc + (size_t)sl * kGradCols;
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) a[c] += v[c];
  }
  __syncwarp();
}

struct ReverseParams {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* g;          // (3, stride)
  const float* scene;      // SoA (kNumCols, n)
  int n;
  const float* cam;
  // at most render_kernel.MAX_LANES: 3 x lanes fits int, so the (3, lanes) rows index in int
  int lanes, stride, samples, max_depth;
  uint32_t k0, k1;
  int sample_offset, rr_start;
  const int32_t* park;     // (capacity, lanes), or null
  const int32_t* parked;   // (2, stride), or null: nothing parked
  float* warp_acc;         // (lanes / 32, n * kGradCols), or null: shared memory
  float* scene_part;       // (lanes / kBlock, n * kGradCols)
  float* cam_part;         // (lanes / kBlock, kNCam)
};

template <bool kHbm, int kDepth>
__global__ void __launch_bounds__(kBlock) reverse_kernel(ReverseParams p) {
  extern __shared__ float4 smem[];
  __shared__ float val[kGradCols][kBlock];
  const int n = p.n;
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t nacc = (size_t)n * kGradCols;
  float* gath = reinterpret_cast<float*>(smem + n);
  float* acc_all = p.warp_acc ? p.warp_acc + (size_t)blockIdx.x * kWarps * nacc
                              : (kHbm ? reinterpret_cast<float*>(smem) : gath + kGather * n);
  float* acc = acc_all + warp * nacc;
  if (!kHbm) stage_scene(p.scene, n, smem, gath);
  for (size_t k = tid & 31; k < nacc; k += 32) acc[k] = 0.0f;
  __syncthreads();

  const int i = blockIdx.x * kBlock + tid;
  const ScanHit<kHbm> hit{SceneView{p.scene, smem, kHbm ? p.scene + kRadius * n : gath, n}};
  const Cam cam = load_cam(p.cam);
  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  const float fi = p.ii[i], fj = p.jj[i];
  const V3 g = {p.g[i], p.g[p.stride + i], p.g[2 * p.stride + i]};
  const int parked = p.parked ? p.parked[i] : 0;
  const int32_t* col = parked ? p.park + i : nullptr;
  float cam_acc[kNCam];
#pragma unroll
  for (int c = 0; c < kNCam; ++c) cam_acc[c] = 0.0f;
  Entry stack[kDepth];
  for (int si = 0; si < p.samples; ++si) {
    const uint32_t s = (uint32_t)(p.sample_offset + si);
    const PathEnd e = si < parked
        ? replay<kHbm>(hit.sc, cam, st, fi, fj, s, p.max_depth, p.rr_start, col,
                       (size_t)p.lanes, stack)
        : trace_sample(hit, cam, st, fi, fj, s, p.max_depth, p.rr_start, false,
                       StackSink{stack});
    V3 ct_o = {0.0f, 0.0f, 0.0f}, ct_d = ct_o, ct_at = ct_o;
    int steps = 0;
    if (e.missed) {  // the cotangent starts where the path banked its radiance
      const Entry& m = stack[e.bounce];
      ct_at = g * sky(m.d);
      ct_d = sky_vjp(m.d, g * m.atten);
      steps = e.bounce;
    }
    for (int r = 0; __any_sync(kFull, r < steps); ++r) {
      const bool have = r < steps;
      float dv[kGradCols];
      int slot = -1;
      if (have) {
        const int b = steps - 1 - r;
        const Entry en = stack[b];
        slot = en.slot;
        scatter_vjp<kHbm>(hit.sc, st, s, b, p.rr_start, en, ct_o, ct_d, ct_at, dv);
      }
      commit_warp(acc, have, slot, dv, val, warp * 32);
    }
    // the primary ray -> the 18 camera scalars
    if (e.missed) camera_adjoint(cam, st, s, fi, fj, ct_o, ct_d, cam_acc);
  }

  __syncthreads();
  // the block's partial: its warps' accumulators in warp order
  float* part = p.scene_part + (size_t)blockIdx.x * nacc;
  for (size_t k = tid; k < nacc; k += kBlock) {
    float v = acc_all[k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += acc_all[w * nacc + k];
    part[k] = v;
  }
  // the camera's 18 sums: a fixed tree, nine columns at a time
  for (int h = 0; h < kNCam / kGradCols; ++h) {
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) val[c][tid] = cam_acc[h * kGradCols + c];
    block_tree(val, kGradCols);
    if (tid < kGradCols) p.cam_part[(size_t)blockIdx.x * kNCam + h * kGradCols + tid] = val[tid][0];
    __syncthreads();
  }
}

// Dynamic shared memory for a kernel that needs more than the default 48 KB
// (static and dynamic together) must be allowed first.
template <class K>
int allow_smem(K kernel, size_t dynamic, size_t fixed) {
  if (dynamic + fixed <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)dynamic);
}

// `stack` picks the instance: 0 the smaller one that holds max_depth, else
// kStackShallow or kMaxBounce (tests and measurements compare the two).
int launch_reverse(const ReverseParams& p, int hbm, int stack, cudaStream_t st) {
  if (stack == 0) stack = p.max_depth > kStackShallow ? kMaxBounce : kStackShallow;
  if (p.lanes % kBlock || p.max_depth > stack ||
      (stack != kStackShallow && stack != kMaxBounce))
    return (int)cudaErrorInvalidValue;
  const size_t stage = hbm ? 0 : (size_t)p.n * (sizeof(float4) + kGather * sizeof(float));
  const size_t smem =
      stage + (p.warp_acc ? 0 : (size_t)kWarps * p.n * kGradCols * sizeof(float));
  if (smem + kReverseStatic > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool deep = stack == kMaxBounce;
  auto kernel = hbm ? (deep ? reverse_kernel<true, kMaxBounce>
                            : reverse_kernel<true, kStackShallow>)
                    : (deep ? reverse_kernel<false, kMaxBounce>
                            : reverse_kernel<false, kStackShallow>);
  const int e = allow_smem(kernel, smem, kReverseStatic);
  if (e) return e;
  kernel<<<p.lanes / kBlock, kBlock, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// out[g, j] = sum of in[r, j] over rows r in [g * chunk, (g + 1) * chunk),
// in row order.
__global__ void reduce_rows_kernel(const float* in, int rows, int cols, int chunk,
                                   float* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(rows, r0 + chunk);
  float s = in[(size_t)r0 * cols + j];
  for (int r = r0 + 1; r < r1; ++r) s += in[(size_t)r * cols + j];
  out[(size_t)blockIdx.y * cols + j] = s;
}

}  // namespace

// C entries: each launches on `stream` and returns cudaGetLastError().
// Pointers to per-lane arrays point at the window's first lane; `stride` is
// the row stride of the (3, ...) and (2, ...) arrays.

// Launch 1 of kernel 2 over `lanes` lanes.
extern "C" int fused_park_render(const int32_t* ids, const float* ii, const float* jj,
                                 const float* target, int stride, const float* scene, int n,
                                 const float* cam, int lanes, int samples, int max_depth,
                                 uint32_t k0, uint32_t k1, int rr_start, int hbm, int gamma,
                                 int loss, int num_pixels, float inv_spp, float w,
                                 float two_w, float hd, float half_hd, float* image, float* g,
                                 float* loss_part, int32_t* park, int capacity,
                                 int32_t* parked, void* stream) {
  if (lanes % kBlock || max_depth > kMaxBounce || capacity < 0 || (capacity && !park))
    return (int)cudaErrorInvalidValue;
  ParkParams p{};
  p.ids = ids; p.ii = ii; p.jj = jj; p.target = target; p.scene = scene; p.n = n;
  p.cam = cam; p.lanes = lanes; p.stride = stride; p.samples = samples;
  p.max_depth = max_depth; p.k0 = k0; p.k1 = k1; p.rr_start = rr_start;
  p.lk = LossConsts{gamma, loss, num_pixels, inv_spp, w, two_w, hd, half_hd};
  p.image = image; p.g = g; p.loss_part = loss_part; p.park = park; p.capacity = capacity;
  p.parked = parked;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = hbm ? 0 : (size_t)n * (sizeof(float4) + kGather * sizeof(float));
  auto kernel = hbm ? park_render_kernel<true> : park_render_kernel<false>;
  const int e = allow_smem(kernel, smem, sizeof(float) * kBlock);
  if (e) return e;
  kernel<<<lanes / kBlock, kBlock, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// The reverse over `lanes` lanes: launch 2 of kernel 2 (park and parked
// from launch 1), or kernel 3 (both null: every sample re-traced).
// warp_acc null keeps the warps' accumulators in shared memory; `stack` as
// launch_reverse's.
extern "C" int reverse_render(const int32_t* ids, const float* ii, const float* jj,
                              const float* g, int stride, const float* scene, int n,
                              const float* cam, int lanes, int samples, int max_depth,
                              uint32_t k0, uint32_t k1, int sample_offset, int rr_start,
                              int hbm, int stack, const int32_t* park, const int32_t* parked,
                              float* warp_acc, float* scene_part, float* cam_part,
                              void* stream) {
  if (parked && !park) return (int)cudaErrorInvalidValue;
  ReverseParams p{};
  p.ids = ids; p.ii = ii; p.jj = jj; p.g = g; p.scene = scene; p.n = n; p.cam = cam;
  p.lanes = lanes; p.stride = stride; p.samples = samples; p.max_depth = max_depth;
  p.k0 = k0; p.k1 = k1; p.sample_offset = sample_offset; p.rr_start = rr_start;
  p.park = park; p.parked = parked; p.warp_acc = warp_acc;
  p.scene_part = scene_part; p.cam_part = cam_part;
  return launch_reverse(p, hbm, stack, static_cast<cudaStream_t>(stream));
}

extern "C" int reduce_rows(const float* in, int rows, int cols, int chunk, float* out,
                           void* stream) {
  const int groups = (rows + chunk - 1) / chunk;
  const dim3 grid((cols + 255) / 256, groups);
  reduce_rows_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(in, rows, cols,
                                                                         chunk, out);
  return (int)cudaGetLastError();
}
