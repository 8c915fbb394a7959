// Scene and camera gradients, and the fused per-pixel-loss train step, one
// thread per pixel, for Hopper (sm_90a).
//
// Replaces the TPU kernels of raytracingincuda_tpu/ops/pallas_backward.py:
//   * grad_render (kernel A): _grad_tile_kernel_hbm (:1424), and the two
//     other schedules of the same function, _grad_tile_kernel_wave (:1396)
//     and _grad_tile_kernel (:579);
//   * fused_train_render (kernel B): _fused_tile_kernel (:1464) in its
//     park='hbm' mode (_regen_render_k, _hbm_park_render, _hbm_reverse).
//
// What they compute. Kernel A: for an upstream cotangent g of each lane's
// radiance sum, the cotangents of the scene matrix's columns 0-8 (centre,
// radius, albedo, fuzz, ior) and of the 18 camera scalars, under the
// detached-sampler convention (ops/backward.py). Kernel B: the regen
// render of every lane's pixel (path_common.cuh's trace_sample, so the
// image equals regen_render's bit for bit), the pointwise image, loss term
// and g (mse, l1, huber or relmse, through 1/spp and gamma), then kernel
// A's reverse with that g. The loss is per pixel, so a thread renders its
// pixel, derives its g and runs its reverse with no grid-wide sync.
//
// The reverse. Per sample the thread re-traces its path with the full hit
// scan and pushes the state entering each bounce (origin, direction,
// attenuation, winning slot: 40 bytes) onto a stack in local memory,
// kMaxDepth bounces deep. Only a path that ends in a miss banks radiance,
// so only such a path has a cotangent: it starts at the miss (g * sky and
// the sky's adjoint) and walks the stack backwards through the hand
// adjoint of each scatter (scatter_vjp, ops/backward.py:winner_bounce_vjp
// line for line), then through the primary ray into the camera. The
// winner's parameters are read back from the scene by slot. The TPU's
// full park (every wave of every tile in HBM) would need about 393 GB at
// the headline on a card whose tiles all run at once; the stack needs
// 2.5 KB a thread.
//
// Determinism: no float atomics. Each block keeps a (slots, 9)
// accumulator; its threads walk their stacks in lockstep rounds (one
// bounce per round, a block-wide barrier between rounds), stage
// (slot, 9 cotangents) per lane, and warp 0 commits the 128 lanes in lane
// order: per 32-lane chunk the lanes of one slot (__match_any_sync) are
// summed in lane order by their lowest lane, and chunks commit in order.
// The camera's 18 sums (and kernel B's loss) stay in registers over the
// samples and meet in a fixed tree at the block's end. Block partials go
// to device memory and reduce_rows sums them in block order, so the
// gradients are the same bits from run to run. The accumulator sits in
// shared memory (36 bytes a slot) beside the staged scene (44 bytes a
// slot, layout vmem) when both fit in the 227 KB a block may take; else
// (vmem above about 2,600 slots) it lives in the block's own slice of
// the partials buffer in device memory, with the same commit order and so
// the same bits.
//
// What bounds it. Kernel B is one render plus one re-trace (each the
// regen kernel's hit loop) plus the reverse; kernel A is the re-trace plus
// the reverse. The lockstep reverse waits each sample for the block's
// longest path, which the render does not.
#include "train_common.cuh"

namespace {

constexpr int kStaticSmem = kBlock * (4 + 4 * kGradCols + 4 * kNCam);
constexpr int kMaxSmem = 232448;  // bytes a Hopper block may take

// Commit one round of the reverse: every lane stages (slot, nine
// cotangents) or slot -1; warp 0 adds them to the block accumulator in
// lane order (ops/train_kernel.py documents the order). Called by every
// thread of the block.
__device__ __forceinline__ void commit_round(float* acc, bool have, int slot,
                                             const float* dv, int* st_slot,
                                             float (*st_val)[kBlock]) {
  const int tid = threadIdx.x;
  st_slot[tid] = have ? slot : -1;
#pragma unroll
  for (int c = 0; c < kGradCols; ++c) st_val[c][tid] = have ? dv[c] : 0.0f;
  __syncthreads();
  if (tid < 32) {
    for (int chunk = 0; chunk < kBlock / 32; ++chunk) {
      const int j = chunk * 32 + tid;
      const int sl = st_slot[j];
      const unsigned peers = __match_any_sync(0xffffffffu, sl);
      if (sl >= 0 && tid == __ffs(peers) - 1) {
        float v[kGradCols];
#pragma unroll
        for (int c = 0; c < kGradCols; ++c) v[c] = st_val[c][j];
        for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1) {
          const int l = chunk * 32 + __ffs(rest) - 1;
#pragma unroll
          for (int c = 0; c < kGradCols; ++c) v[c] += st_val[c][l];
        }
#pragma unroll
        for (int c = 0; c < kGradCols; ++c) acc[sl * kGradCols + c] += v[c];
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

struct TrainParams {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* rows;   // kernel A: g; kernel B: the target (3, padded)
  const float* scene;  // SoA (kNumCols, n)
  int n;
  const float* cam;
  int padded, samples, max_depth;
  uint32_t k0, k1;
  int sample_offset, rr_start;
  LossConsts lk;       // kernel B's loss block
  float* image;        // kernel B: (3, padded)
  float* scene_part;   // (blocks, n * kGradCols)
  float* cam_part;     // (blocks, kNCam)
  float* loss_part;    // kernel B: (blocks, 1)
  int acc_in_smem;
};

template <bool kHbm, bool kFused>
__global__ void __launch_bounds__(kBlock) train_kernel(TrainParams p) {
  extern __shared__ float4 smem[];
  __shared__ int st_slot[kBlock];
  __shared__ float st_val[kGradCols][kBlock];
  __shared__ float red[kNCam][kBlock];
  const int n = p.n;
  const int tid = threadIdx.x;
  float* gath = reinterpret_cast<float*>(smem + n);
  float* acc = p.acc_in_smem
                   ? (kHbm ? reinterpret_cast<float*>(smem) : gath + kGather * n)
                   : p.scene_part + (size_t)blockIdx.x * n * kGradCols;
  if (!kHbm) stage_scene(p.scene, n, smem, gath);
  for (int k = tid; k < n * kGradCols; k += kBlock) acc[k] = 0.0f;
  __syncthreads();

  const int i = blockIdx.x * kBlock + tid;  // padded is a multiple of kBlock
  const ScanHit<kHbm> hit{SceneView{p.scene, smem, kHbm ? p.scene + kRadius * n : gath, n}};
  const Cam cam = load_cam(p.cam);
  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  const float fi = p.ii[i], fj = p.jj[i];
  const V3 row = {p.rows[i], p.rows[p.padded + i], p.rows[2 * p.padded + i]};

  V3 g = row;
  float loss_term = 0.0f;
  if (kFused) {
    // the regen render (regen_render's loop and finalize), then the loss
    V3 rad = {0.0f, 0.0f, 0.0f};
    for (uint32_t s = 0; (int)s < p.samples; ++s) {
      const PathEnd e = trace_sample<ScanHit<kHbm>, false>(hit, cam, st, fi, fj, s,
                                                           p.max_depth, p.rr_start, false,
                                                           nullptr);
      if (e.missed) rad = rad + e.contrib;
    }
    V3 img;
    g = loss_block(p.lk, rad, row, p.ids[i] < p.lk.num_pixels, img, loss_term);
    p.image[i] = img.x;
    p.image[p.padded + i] = img.y;
    p.image[2 * p.padded + i] = img.z;
  }

  float cam_acc[kNCam];
#pragma unroll
  for (int c = 0; c < kNCam; ++c) cam_acc[c] = 0.0f;
  Entry stack[kMaxDepth];
  for (uint32_t s = (uint32_t)p.sample_offset; (int)s < p.sample_offset + p.samples; ++s) {
    const PathEnd e = trace_sample<ScanHit<kHbm>, true>(hit, cam, st, fi, fj, s, p.max_depth,
                                                        p.rr_start, false, stack);
    V3 ct_o = {0.0f, 0.0f, 0.0f}, ct_d = ct_o, ct_at = ct_o;
    int steps = 0;
    if (e.missed) {  // the cotangent starts where the path banked its radiance
      const Entry& m = stack[e.bounce];
      ct_at = g * sky(m.d);
      ct_d = sky_vjp(m.d, g * m.atten);
      steps = e.bounce;
    }
    for (int r = 0; __syncthreads_or(r < steps); ++r) {
      const bool have = r < steps;
      float dv[kGradCols];
      int slot = -1;
      if (have) {
        const int b = steps - 1 - r;
        const Entry en = stack[b];
        slot = en.slot;
        scatter_vjp<kHbm>(hit.sc, st, s, b, p.rr_start, en, ct_o, ct_d, ct_at, dv);
      }
      commit_round(acc, have, slot, dv, st_slot, st_val);
    }
    // the primary ray -> the 18 camera scalars
    if (e.missed) camera_adjoint(cam, st, s, fi, fj, ct_o, ct_d, cam_acc);
  }

  __syncthreads();
  if (p.acc_in_smem)
    for (int k = tid; k < n * kGradCols; k += kBlock)
      p.scene_part[(size_t)blockIdx.x * n * kGradCols + k] = acc[k];
#pragma unroll
  for (int c = 0; c < kNCam; ++c) red[c][tid] = cam_acc[c];
  block_tree(red, kNCam);
  if (tid < kNCam) p.cam_part[(size_t)blockIdx.x * kNCam + tid] = red[tid][0];
  if (kFused) {
    __syncthreads();
    red[0][tid] = loss_term;
    block_tree(red, 1);
    if (tid == 0) p.loss_part[blockIdx.x] = red[0][0];
  }
}

template <bool kFused>
int launch_train(const TrainParams& p0, int hbm, cudaStream_t st) {
  TrainParams p = p0;
  const size_t stage = hbm ? 0 : (size_t)p.n * (sizeof(float4) + kGather * sizeof(float));
  const size_t accb = (size_t)p.n * kGradCols * sizeof(float);
  p.acc_in_smem = stage + accb + kStaticSmem <= (size_t)kMaxSmem;
  const size_t smem = stage + (p.acc_in_smem ? accb : 0);
  const dim3 grid(p.padded / kBlock);
  auto kernel = hbm ? train_kernel<true, kFused> : train_kernel<false, kFused>;
  if (smem + kStaticSmem > 48 * 1024) {  // static and dynamic share the default 48 KB
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kBlock, smem, st>>>(p);
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
extern "C" int grad_render(const int32_t* ids, const float* ii, const float* jj,
                           const float* g, const float* scene, int n, const float* cam,
                           int padded, int samples, int max_depth, uint32_t k0,
                           uint32_t k1, int sample_offset, int rr_start, int hbm,
                           float* scene_part, float* cam_part, void* stream) {
  if (padded % kBlock || max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  TrainParams p{};
  p.ids = ids; p.ii = ii; p.jj = jj; p.rows = g; p.scene = scene; p.n = n; p.cam = cam;
  p.padded = padded; p.samples = samples; p.max_depth = max_depth; p.k0 = k0; p.k1 = k1;
  p.sample_offset = sample_offset; p.rr_start = rr_start;
  p.scene_part = scene_part; p.cam_part = cam_part;
  return launch_train<false>(p, hbm, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_train_render(const int32_t* ids, const float* ii, const float* jj,
                                  const float* target, const float* scene, int n,
                                  const float* cam, int padded, int samples,
                                  int max_depth, uint32_t k0, uint32_t k1, int rr_start,
                                  int hbm, int gamma, int loss, int num_pixels,
                                  float inv_spp, float w, float two_w, float hd,
                                  float half_hd, float* image, float* scene_part,
                                  float* cam_part, float* loss_part, void* stream) {
  if (padded % kBlock || max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  TrainParams p{};
  p.ids = ids; p.ii = ii; p.jj = jj; p.rows = target; p.scene = scene; p.n = n; p.cam = cam;
  p.padded = padded; p.samples = samples; p.max_depth = max_depth; p.k0 = k0; p.k1 = k1;
  p.rr_start = rr_start;
  p.lk = LossConsts{gamma, loss, num_pixels, inv_spp, w, two_w, hd, half_hd};
  p.image = image; p.scene_part = scene_part; p.cam_part = cam_part; p.loss_part = loss_part;
  return launch_train<true>(p, hbm, static_cast<cudaStream_t>(stream));
}

extern "C" int reduce_rows(const float* in, int rows, int cols, int chunk, float* out,
                           void* stream) {
  const int groups = (rows + chunk - 1) / chunk;
  const dim3 grid((cols + 255) / 256, groups);
  reduce_rows_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(in, rows, cols,
                                                                         chunk, out);
  return (int)cudaGetLastError();
}
