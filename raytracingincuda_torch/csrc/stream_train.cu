// Gradients and the fused train step for streamed scenes, one thread per
// pixel, for Hopper (sm_90a), and the deterministic scatter of their
// sphere cotangents.
//
// Replaces the TPU kernel raytracingincuda_tpu/ops/pallas_stream_backward.py:
// _stream_grad_kernel (:92): cotangents from a given g_acc (mse=False),
// or the fused stream step (mse=True: render, the per-pixel loss and its
// cotangent, then the reverse), with its scatter _scatter_rows (:360).
//
// What it computes. stream_train_render follows train_render.cu's kernels
// with the hit test swapped for the stream walk (path_common.cuh's
// WalkHit): the fused variant first renders its pixel (trace_sample over
// the walk, so the image equals stream_render's bit for bit) and derives g
// through the loss block; then per sample the thread re-traces its path,
// pushing the state entering each bounce onto a 64-bounce stack in local
// memory, and walks a path that ended in a miss back through scatter_vjp
// and the primary ray's adjoint. Entry.slot is the winner's STREAM row.
//
// The scatter. The TPU kernel adds into one (16, N) accumulator because its
// grid runs in order; on this card all blocks run at once, and
// train_render.cu's per-block partials would need blocks x N x 36 bytes
// (69 GB at 1M spheres). Instead each reverse step writes its record
// (stream row, nine cotangents) at a fixed index ((lane, sample), bounce),
// unwritten records keeping row -1: memory O(pixels x samples x depth). The
// wrapper orders the written records stably by row (a permutation,
// torch.argsort), and the two kernels below add each row's records in
// record order: chunk_sums sums the runs of equal rows inside each chunk of
// kChunk sorted records, segment_sums adds a row's chunk partials in chunk
// order. No float atomics: the gradients are the same bits from run to run.
// The camera's 18 sums and the loss meet in a fixed tree per block, as in
// train_render.cu, and reduce_rows sums the block partials in order.
//
// What bounds it. The fused step is two walks per sample (the render and
// the re-trace) plus the reverse; the gradient variant one walk plus the
// reverse. The walks are FP32 arithmetic bound as in stream_render.cu; the
// reverse costs about one scatter_vjp (a few hundred FP32 operations) per
// record; the scatter moves each record (48 bytes with its sort index)
// twice.

#include "train_common.cuh"

namespace {

constexpr int kChunk = 256;  // sorted records per chunk_sums thread

struct StreamTrainParams {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* rows;    // g (gradients) or the target (fused), (3, padded)
  const float* scene;   // SoA (kNumCols, n_rows) of the stream matrix
  int n_rows;
  const float* bounds;  // (nb, 8)
  int nb, block;
  const float* cam;
  int padded, samples, max_depth;
  uint32_t k0, k1;
  int sample_offset, rr_start;
  LossConsts lk;        // fused only
  float* image;         // fused: (3, padded)
  int32_t* rec_row;     // (padded * samples * max_depth), -1 where unwritten
  float* rec_val;       // (padded * samples * max_depth, kGradCols)
  float* cam_part;      // (blocks, kNCam)
  float* loss_part;     // fused: (blocks, 1)
};

template <bool kFused>
__global__ void __launch_bounds__(kBlock) stream_train_kernel(StreamTrainParams p) {
  __shared__ float red[kNCam][kBlock];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kBlock + tid;  // padded is a multiple of kBlock
  const WalkHit<false> hit{SceneView{p.scene, nullptr, p.scene + kRadius * p.n_rows, p.n_rows},
                           p.bounds, p.nb, p.block};
  const Cam cam = load_cam(p.cam);
  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  const float fi = p.ii[i], fj = p.jj[i];
  const V3 row = {p.rows[i], p.rows[p.padded + i], p.rows[2 * p.padded + i]};

  V3 g = row;
  float loss_term = 0.0f;
  if (kFused) {
    // stream_render's loop and finalize, then the loss block
    V3 rad = {0.0f, 0.0f, 0.0f};
    for (uint32_t s = 0; (int)s < p.samples; ++s) {
      const PathEnd e = trace_sample<WalkHit<false>, false>(hit, cam, st, fi, fj, s,
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
  for (int si = 0; si < p.samples; ++si) {
    const uint32_t s = (uint32_t)(p.sample_offset + si);
    const PathEnd e = trace_sample<WalkHit<false>, true>(hit, cam, st, fi, fj, s,
                                                         p.max_depth, p.rr_start, false,
                                                         stack);
    if (!e.missed) continue;  // a path that ends black passes nothing back
    const Entry& m = stack[e.bounce];
    V3 ct_o = {0.0f, 0.0f, 0.0f}, ct_at = g * sky(m.d);
    V3 ct_d = sky_vjp(m.d, g * m.atten);
    const size_t base = ((size_t)i * p.samples + si) * p.max_depth;
    for (int b = e.bounce - 1; b >= 0; --b) {
      const Entry en = stack[b];
      float dv[kGradCols];
      scatter_vjp<true>(hit.sc, st, s, b, p.rr_start, en, ct_o, ct_d, ct_at, dv);
      p.rec_row[base + b] = en.slot;
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) p.rec_val[(base + b) * kGradCols + c] = dv[c];
    }
    camera_adjoint(cam, st, s, fi, fj, ct_o, ct_d, cam_acc);
  }

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

// Pass 1 of the scatter. Thread c takes sorted records [c * kChunk,
// (c + 1) * kChunk): it adds each run of equal rows in sorted order
// (records of one row are in record order: the sort is stable) and writes
// the run's sum at the run's first position in `part`.
__global__ void chunk_sums_kernel(const int32_t* keys, const int64_t* src, const float* vals,
                                  long long m, float* part) {
  const long long p0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kChunk;
  if (p0 >= m) return;
  const long long p1 = p0 + kChunk < m ? p0 + kChunk : m;
  long long start = p0;
  float v[kGradCols];
#pragma unroll
  for (int c = 0; c < kGradCols; ++c) v[c] = vals[src[p0] * kGradCols + c];
  for (long long q = p0 + 1; q < p1; ++q) {
    const float* x = vals + src[q] * kGradCols;
    if (keys[q] != keys[start]) {
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) {
        part[start * kGradCols + c] = v[c];
        v[c] = x[c];
      }
      start = q;
    } else {
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) v[c] += x[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kGradCols; ++c) part[start * kGradCols + c] = v[c];
}

// Pass 2. Thread q, where a row's sorted records begin, adds that row's
// partials in order: the one at q, then one at each chunk start inside the
// row's span, and writes the row of `out`.
__global__ void segment_sums_kernel(const int32_t* keys, long long m, const float* part,
                                    float* out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= m) return;
  const int32_t key = keys[q];
  if (q > 0 && keys[q - 1] == key) return;
  long long lo = q + 1, hi = m;  // the span's end: the first key above `key`
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (keys[mid] == key) lo = mid + 1; else hi = mid;
  }
  float v[kGradCols];
#pragma unroll
  for (int c = 0; c < kGradCols; ++c) v[c] = part[q * kGradCols + c];
  for (long long r = (q / kChunk + 1) * kChunk; r < lo; r += kChunk) {
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) v[c] += part[r * kGradCols + c];
  }
#pragma unroll
  for (int c = 0; c < kGradCols; ++c) out[(size_t)key * kGradCols + c] = v[c];
}

}  // namespace

// C entries: each launches on `stream` and returns cudaGetLastError().
extern "C" int stream_train_render(const int32_t* ids, const float* ii, const float* jj,
                                   const float* rows, const float* scene, int n_rows,
                                   const float* bounds, int nb, int block, const float* cam,
                                   int padded, int samples, int max_depth, uint32_t k0,
                                   uint32_t k1, int sample_offset, int rr_start, int fused,
                                   int gamma, int loss, int num_pixels, float inv_spp,
                                   float w, float two_w, float hd, float half_hd,
                                   float* image, int32_t* rec_row, float* rec_val,
                                   float* cam_part, float* loss_part, void* stream) {
  if (padded % kBlock || max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  StreamTrainParams p{};
  p.ids = ids; p.ii = ii; p.jj = jj; p.rows = rows; p.scene = scene; p.n_rows = n_rows;
  p.bounds = bounds; p.nb = nb; p.block = block; p.cam = cam;
  p.padded = padded; p.samples = samples; p.max_depth = max_depth; p.k0 = k0; p.k1 = k1;
  p.sample_offset = sample_offset; p.rr_start = rr_start;
  p.lk = LossConsts{gamma, loss, num_pixels, inv_spp, w, two_w, hd, half_hd};
  p.image = image; p.rec_row = rec_row; p.rec_val = rec_val;
  p.cam_part = cam_part; p.loss_part = loss_part;
  const dim3 grid(padded / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fused)
    stream_train_kernel<true><<<grid, kBlock, 0, st>>>(p);
  else
    stream_train_kernel<false><<<grid, kBlock, 0, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int segment_sum(const int32_t* keys, const int64_t* src, const float* vals,
                           long long m, float* part, float* out, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = (m + kChunk - 1) / kChunk;
  chunk_sums_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(keys, src, vals, m,
                                                                      part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  segment_sums_kernel<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(keys, m, part, out);
  return (int)cudaGetLastError();
}
