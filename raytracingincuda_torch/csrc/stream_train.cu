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
// with the hit test swapped for the stream walk: the fused mode renders its
// pixel (the image equals stream_render's bit for bit) and derives g
// through the loss block, then walks each sample that ended in a miss back
// through scatter_vjp and the primary ray's adjoint. Entry.slot is the
// winner's STREAM row.
//
// The park. Each sample is walked once. The state entering every bounce
// (o, d, atten: 9 floats, and the winning row) is parked in the record
// buffers themselves, entry b of sample si of lane i at index
// idx = (si * max_depth + b) * padded + i, so a warp's 32 lanes write and
// read 32 consecutive records: the TPU kernel's park='hbm'
// (pallas_stream_backward.py:125-131, :265-275, :523-532). The reverse at
// bounce b reads entry b, then overwrites it with record b (nine
// cotangents; the row stays the winner's). The fused mode parks every
// sample during the render and reverses from the park alone once g is
// known; the gradient mode reverses each sample right after its walk. A
// path that ends black leaves every row of its entries at -1 (the fused
// render marks its first row -2 so that the reverse knows the sample ended
// black, and the reverse sets it to -1); the miss entry's row is -1.
//
// The walk is staged_walk.cuh's StagedWalk, kernel 4's walk: a packed
// scan table built per launch by scan_table_kernel, each warp's opened
// blocks staged in shared memory with cp.async. StagedWalk's slots in shared
// memory have one owner only if every lane of the warp calls it together,
// so trace_parked runs the bounce loop in lockstep across the warp: a lane
// whose path has ended rides along to the warp's last bounce of the sample,
// as a reconverging warp waits for it anyway. Each lane's decisions are its
// own, so images and records are kernel 4's.
//
// The scatter. The TPU kernel adds into one (16, N) accumulator because its
// grid runs in order; on this card all blocks run at once, and
// train_render.cu's per-block partials would need blocks x N x 36 bytes
// (69 GB at 1M spheres). Instead the records stay where the reverse wrote
// them, unwritten ones keeping row -1: memory O(pixels x samples x depth).
// The wrapper orders the written records stably by row (torch.argsort), and
// two kernels add each row's records with an association fixed by kTile
// alone. tile_sums_kernel: one CTA per tile of kTile sorted records, one
// record a thread, loads the keys and record indices coalesced, gathers
// each record's nine values, and sums runs of equal rows by a segmented
// inclusive scan (head flag at each run start and at the tile start):
// Kogge-Stone steps of 1, 2, 4, 8, 16 lanes by warp shuffles, then the same
// scan over the 32 warps' totals, whose exclusive prefix each lane adds on
// the left. A run wholly inside a tile is written to `out` at its last
// record; a run that crosses a tile edge leaves its tile partials (the
// tile's first run's sum in `head`, its last run's in `tail`).
// cross_sums_kernel: one warp per tile that owns such a run (the run starts
// there) adds the run's partials in tile order, lane l taking partials l,
// l + 32, ..., then a shuffle tree, so a row across many tiles is summed
// by a tree too. No float atomics: the gradients are the same bits from
// run to run. The camera's 18 sums and the loss meet in a fixed tree per
// block, as in train_render.cu, and reduce_rows sums the block partials in
// order.
//
// What bounds it. The walk: one pass per sample, FP32 arithmetic (a bound
// test per bounds row per traced segment, 18 operations per sphere test of
// an opened block), and divergence, since the warp tests the union of its
// lanes' opened blocks (the count mode measures that union). Then the
// reverse, about one scatter_vjp (a few hundred FP32 operations) per
// record; the park moves 40 bytes per traced segment twice. The segmented
// sum is bound by bytes: each record's 36 bytes gathered once, its key and
// index read once.

#include "staged_walk.cuh"
#include "train_common.cuh"

namespace {

constexpr int kTile = 1024;  // sorted records per tile_sums_kernel CTA
enum { kGrads, kFused, kCount };

__device__ __forceinline__ void park(int32_t* rec_row, float* rec_val, size_t idx, V3 o, V3 d,
                                     V3 at, int slot) {
  float* v = rec_val + idx * kGradCols;
  v[0] = o.x; v[1] = o.y; v[2] = o.z;
  v[3] = d.x; v[4] = d.y; v[5] = d.z;
  v[6] = at.x; v[7] = at.y; v[8] = at.z;
  rec_row[idx] = slot;
}

__device__ __forceinline__ Entry unpark(const int32_t* rec_row, const float* rec_val, size_t idx) {
  const float* v = rec_val + idx * kGradCols;
  return Entry{{v[0], v[1], v[2]}, {v[3], v[4], v[5]}, {v[6], v[7], v[8]}, rec_row[idx]};
}

// Sample s of one lane: trace_sample's loop with StagedWalk, in lockstep
// across the warp (a lane whose path has ended rides along to the warp's
// last bounce); with kPark the state entering bounce b goes to the park at
// idx + b * plane.
template <bool kPark, class Walk>
__device__ __forceinline__ PathEnd trace_parked(const Walk& walk, const Cam& cam,
                                                const Stream& st, float fi, float fj,
                                                uint32_t s, int max_depth, int rr_start,
                                                int32_t* rec_row, float* rec_val, size_t idx,
                                                size_t plane) {
  V3 o, d;
  primary_ray(cam, fi, fj, st, s, o, d);
  V3 atten = {1.0f, 1.0f, 1.0f};
  PathEnd e = {0, false, {0.0f, 0.0f, 0.0f}};
  bool live = true;
  for (int b = 0; __any_sync(walk.mask, live); ++b) {
    int win;
    float t;
    const bool hit = walk(o, d, live, win, t);
    if (!live) continue;
    if (kPark) park(rec_row, rec_val, idx + b * plane, o, d, atten, hit ? win : -1);
    if (!hit) {
      e = {b, true, atten * sky(d)};
      live = false;
    } else if (!scatter_bounce<true>(walk.sc, st, s, b, max_depth, rr_start, win, t, o, d,
                                     atten)) {
      e = {b, false, {0.0f, 0.0f, 0.0f}};
      live = false;
    }
  }
  return e;
}

struct StreamTrainParams {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* rows;    // g (gradients) or the target (fused), (3, padded)
  const float* scene;   // SoA (kNumCols, n_rows) of the stream matrix
  int n_rows;
  const float4* scan;   // (n_rows) scan table, built by scan_table_kernel
  const float* bounds;  // (nb, 8)
  int nb, block;
  const float* cam;
  int padded, samples, max_depth;
  uint32_t k0, k1;
  int sample_offset, rr_start;
  LossConsts lk;        // fused only
  float* image;         // fused: (3, padded)
  int32_t* rec_row;     // (samples * max_depth * padded), -1 where no record
  float* rec_val;       // (samples * max_depth * padded, kGradCols)
  float* cam_part;      // (blocks, kNCam)
  float* loss_part;     // fused: (blocks, 1)
  int32_t* opened;      // count mode: (padded) blocks opened per lane
  int32_t* fetched;     // count mode: (padded / 32) blocks tested per warp
};

template <int kMode>
__global__ void __launch_bounds__(kBlock) stream_train_kernel(StreamTrainParams p) {
  extern __shared__ float4 stage[];
  __shared__ float red[kNCam][kBlock];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kBlock + tid;  // padded is a multiple of kBlock
  const StagedWalk<kMode == kCount> walk{
      SceneView{p.scene, nullptr, p.scene + kRadius * p.n_rows, p.n_rows}, p.scan, p.bounds,
      p.nb, p.block, stage + (tid / 32) * 2 * kPiece, __activemask()};
  const Cam cam = load_cam(p.cam);
  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  const float fi = p.ii[i], fj = p.jj[i];
  const size_t plane = (size_t)p.padded, per_sample = (size_t)p.max_depth * plane;

  V3 g = {0.0f, 0.0f, 0.0f};
  if (kMode != kCount) g = {p.rows[i], p.rows[p.padded + i], p.rows[2 * p.padded + i]};
  float loss_term = 0.0f;
  if (kMode != kGrads) {
    // stream_render's loop and finalize (parking every sample), then the
    // loss block
    V3 rad = {0.0f, 0.0f, 0.0f};
    for (int si = 0; si < p.samples; ++si) {
      const size_t base = si * per_sample + i;
      __syncwarp();
      const PathEnd e = trace_parked<kMode == kFused>(
          walk, cam, st, fi, fj, (uint32_t)(p.sample_offset + si), p.max_depth, p.rr_start,
          p.rec_row, p.rec_val, base, plane);
      if (e.missed) {
        rad = rad + e.contrib;
      } else if (kMode == kFused) {  // ended black: no records (-2 tells the reverse)
        p.rec_row[base] = -2;
        for (int b = 1; b <= e.bounce; ++b) p.rec_row[base + b * plane] = -1;
      }
    }
    if (kMode == kCount) {
      p.opened[i] = walk.opened;
      if ((tid & 31) == 0) p.fetched[i / 32] = walk.fetched;
      return;
    }
    V3 img;
    g = loss_block(p.lk, rad, g, p.ids[i] < p.lk.num_pixels, img, loss_term);
    p.image[i] = img.x;
    p.image[p.padded + i] = img.y;
    p.image[2 * p.padded + i] = img.z;
  }

  float cam_acc[kNCam];
#pragma unroll
  for (int c = 0; c < kNCam; ++c) cam_acc[c] = 0.0f;
  for (int si = 0; si < p.samples; ++si) {
    const uint32_t s = (uint32_t)(p.sample_offset + si);
    const size_t base = si * per_sample + i;
    int end;  // the bounce of the sample's miss
    if (kMode == kGrads) {
      __syncwarp();
      const PathEnd e = trace_parked<true>(walk, cam, st, fi, fj, s, p.max_depth,
                                                  p.rr_start, p.rec_row, p.rec_val, base,
                                                  plane);
      if (!e.missed) {  // a path that ends black passes nothing back
        for (int b = 0; b <= e.bounce; ++b) p.rec_row[base + b * plane] = -1;
        continue;
      }
      end = e.bounce;
    } else {
      if (p.rec_row[base] == -2) {
        p.rec_row[base] = -1;
        continue;
      }
      end = 0;
      while (p.rec_row[base + end * plane] >= 0) ++end;
    }
    const Entry m = unpark(p.rec_row, p.rec_val, base + end * plane);
    V3 ct_o = {0.0f, 0.0f, 0.0f}, ct_at = g * sky(m.d);
    V3 ct_d = sky_vjp(m.d, g * m.atten);
    for (int b = end - 1; b >= 0; --b) {
      const size_t idx = base + b * plane;
      const Entry en = unpark(p.rec_row, p.rec_val, idx);
      float dv[kGradCols];
      scatter_vjp<true>(walk.sc, st, s, b, p.rr_start, en, ct_o, ct_d, ct_at, dv);
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) p.rec_val[idx * kGradCols + c] = dv[c];
    }
    camera_adjoint(cam, st, s, fi, fj, ct_o, ct_d, cam_acc);
  }

#pragma unroll
  for (int c = 0; c < kNCam; ++c) red[c][tid] = cam_acc[c];
  block_tree(red, kNCam);
  if (tid < kNCam) p.cam_part[(size_t)blockIdx.x * kNCam + tid] = red[tid][0];
  if (kMode == kFused) {
    __syncthreads();
    red[0][tid] = loss_term;
    block_tree(red, 1);
    if (tid == 0) p.loss_part[blockIdx.x] = red[0][0];
  }
}

// The segmented inclusive scan of one warp, (f, v) per lane with f the
// head flag: steps of 1, 2, 4, 8 and 16 lanes, lane l taking
// (f_{l-s}, v_{l-s}) then (f_l, v_l) -> (f_{l-s} | f_l, f_l ? v_l : v_{l-s} + v_l).
__device__ __forceinline__ void warp_segmented_scan(bool& f, float (&v)[kGradCols]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int step = 1; step < 32; step <<= 1) {
    const bool fp = __shfl_up_sync(0xffffffffu, f, step);
    float vp[kGradCols];
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) vp[c] = __shfl_up_sync(0xffffffffu, v[c], step);
    if (lane >= step) {
      if (!f)
#pragma unroll
        for (int c = 0; c < kGradCols; ++c) v[c] = vp[c] + v[c];
      f = f || fp;
    }
  }
}

// Pass 1 of the scatter: tile blockIdx.x of kTile sorted records, one a
// thread (see the header). head/tail: (tiles, kGradCols) partials of runs
// that cross a tile edge.
__global__ void __launch_bounds__(kTile) tile_sums_kernel(const int32_t* keys,
                                                          const int64_t* src, const float* vals,
                                                          long long m, float* out, float* head,
                                                          float* tail) {
  __shared__ float agg_v[32][kGradCols];
  __shared__ int agg_f[32];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long base = (long long)blockIdx.x * kTile, q = base + tid;
  const bool valid = q < m;
  const int32_t key = valid ? keys[q] : -1;
  float v[kGradCols];
  const float* x = vals + (valid ? src[q] : 0) * kGradCols;
#pragma unroll
  for (int c = 0; c < kGradCols; ++c) v[c] = valid ? x[c] : 0.0f;
  bool f = valid && (tid == 0 || keys[q - 1] != key);
  warp_segmented_scan(f, v);
  if (lane == 31) {
    agg_f[w] = f;
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) agg_v[w][c] = v[c];
  }
  __syncthreads();
  if (w == 0) {
    bool fw = agg_f[lane];
    float vw[kGradCols];
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) vw[c] = agg_v[lane][c];
    warp_segmented_scan(fw, vw);
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) agg_v[lane][c] = vw[c];
  }
  __syncthreads();
  if (w > 0 && !f)
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) v[c] = agg_v[w - 1][c] + v[c];
  // a run's last record in this tile holds the run's sum over the tile
  const bool last_in_tile = tid == kTile - 1 || q + 1 >= m || keys[q + 1] != key;
  if (!valid || !last_in_tile) return;
  const bool from_before = base > 0 && keys[base] == key && keys[base - 1] == key;
  const bool to_after = tid == kTile - 1 && q + 1 < m && keys[q + 1] == key;
  float* dst = out + (size_t)key * kGradCols;
  if (from_before || to_after) {
    if (from_before) dst = head + (size_t)blockIdx.x * kGradCols;
    if (to_after) {
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) tail[(size_t)blockIdx.x * kGradCols + c] = v[c];
      if (!from_before) return;
    }
  }
#pragma unroll
  for (int c = 0; c < kGradCols; ++c) dst[c] = v[c];
}

// Pass 2: warp t finishes the run that crosses out of tile t, where the run
// starts in tile t: tail[t], then head[t + 1 .. tb] (tb the run's last
// tile), lane l adding partials l, l + 32, ... in order, then a shuffle tree.
__global__ void cross_sums_kernel(const int32_t* keys, long long m, long long tiles,
                                  const float* head, const float* tail, float* out) {
  const long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (t >= tiles) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const long long base = t * kTile, last = (base + kTile < m ? base + kTile : m) - 1;
  const int32_t key = keys[last];
  if (last + 1 >= m || keys[last + 1] != key) return;  // no run crosses out
  if (base > 0 && keys[base - 1] == key) return;        // it starts in an earlier tile
  long long lo = last + 1, hi = m;  // the run's end: the first key above `key`
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (keys[mid] == key) lo = mid + 1; else hi = mid;
  }
  const long long n = (lo - 1) / kTile - t + 1;  // partials: tiles t .. tb
  float v[kGradCols];
#pragma unroll
  for (int c = 0; c < kGradCols; ++c) v[c] = 0.0f;
  for (long long k = lane; k < n; k += 32) {
    const float* pk = k == 0 ? tail + t * kGradCols : head + (t + k) * kGradCols;
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) v[c] += pk[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) v[c] += __shfl_down_sync(0xffffffffu, v[c], off);
  if (lane == 0)
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) out[(size_t)key * kGradCols + c] = v[c];
}

// The scan table, then kernel 5 in `mode` on `stream`.
int launch(StreamTrainParams& p, float* scan, int mode, cudaStream_t stream) {
  if (p.padded % kBlock || p.max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  scan_table_kernel<<<(p.n_rows + 255) / 256, 256, 0, stream>>>(p.scene, p.n_rows,
                                                                reinterpret_cast<float4*>(scan));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  p.scan = reinterpret_cast<const float4*>(scan);
  const dim3 grid(p.padded / kBlock);
  if (mode == kFused)
    stream_train_kernel<kFused><<<grid, kBlock, kStageBytes, stream>>>(p);
  else if (mode == kGrads)
    stream_train_kernel<kGrads><<<grid, kBlock, kStageBytes, stream>>>(p);
  else
    stream_train_kernel<kCount><<<grid, kBlock, kStageBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries: each launches on `stream` and returns cudaGetLastError().
extern "C" int stream_train_render(const int32_t* ids, const float* ii, const float* jj,
                                   const float* rows, const float* scene, int n_rows,
                                   float* scan, const float* bounds, int nb, int block,
                                   const float* cam, int padded, int samples, int max_depth,
                                   uint32_t k0, uint32_t k1, int sample_offset, int rr_start,
                                   int fused, int gamma, int loss, int num_pixels,
                                   float inv_spp, float w, float two_w, float hd,
                                   float half_hd, float* image, int32_t* rec_row,
                                   float* rec_val, float* cam_part, float* loss_part,
                                   void* stream) {
  StreamTrainParams p{};
  p.ids = ids; p.ii = ii; p.jj = jj; p.rows = rows; p.scene = scene; p.n_rows = n_rows;
  p.bounds = bounds; p.nb = nb; p.block = block; p.cam = cam;
  p.padded = padded; p.samples = samples; p.max_depth = max_depth; p.k0 = k0; p.k1 = k1;
  p.sample_offset = sample_offset; p.rr_start = rr_start;
  p.lk = LossConsts{gamma, loss, num_pixels, inv_spp, w, two_w, hd, half_hd};
  p.image = image; p.rec_row = rec_row; p.rec_val = rec_val;
  p.cam_part = cam_part; p.loss_part = loss_part;
  return launch(p, scan, fused ? kFused : kGrads, static_cast<cudaStream_t>(stream));
}

// The fused mode's walk alone (no Russian roulette), counting: blocks
// opened per lane and blocks tested per warp (the union of its lanes').
extern "C" int stream_walk_counts(const int32_t* ids, const float* ii, const float* jj,
                                  const float* scene, int n_rows, float* scan,
                                  const float* bounds, int nb, int block, const float* cam,
                                  int padded, int samples, int max_depth, uint32_t k0,
                                  uint32_t k1, int32_t* opened, int32_t* fetched,
                                  void* stream) {
  StreamTrainParams p{};
  p.ids = ids; p.ii = ii; p.jj = jj; p.scene = scene; p.n_rows = n_rows;
  p.bounds = bounds; p.nb = nb; p.block = block; p.cam = cam;
  p.padded = padded; p.samples = samples; p.max_depth = max_depth; p.k0 = k0; p.k1 = k1;
  p.rr_start = -1; p.opened = opened; p.fetched = fetched;
  return launch(p, scan, kCount, static_cast<cudaStream_t>(stream));
}

// part: (2 * tiles, kGradCols) scratch, the head then the tail partials.
extern "C" int segment_sum(const int32_t* keys, const int64_t* src, const float* vals,
                           long long m, float* part, float* out, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = (m + kTile - 1) / kTile;
  float* head = part;
  float* tail = part + tiles * kGradCols;
  tile_sums_kernel<<<(unsigned)tiles, kTile, 0, st>>>(keys, src, vals, m, out, head, tail);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cross_sums_kernel<<<(unsigned)((tiles + 7) / 8), 256, 0, st>>>(keys, m, tiles, head, tail,
                                                                   out);
  return (int)cudaGetLastError();
}
