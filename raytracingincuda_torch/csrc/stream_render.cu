// Forward render of a streamed scene, one thread per pixel, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel raytracingincuda_tpu/ops/pallas_stream.py:
// _stream_tile_kernel (:504), with its closest hit _hit_world_stream
// (:307) and the bound test _block_bound_any_hit (:282).
//
// What it computes. The regen render of regen_render.cu (lane i renders
// pixel ids[i] over samples [sample_offset, budget[i]), a dying path
// regenerates with the pixel's next sample, radiance summed in sample
// order), with the closest hit taken by a culled walk over the sphere
// blocks of a prepared stream scene (ops/stream_kernel.py:
// prepare_stream_scene): spheres Morton-sorted into blocks of `block`
// matrix rows, one conservative bound sphere per block. The bounds rows are
// walked in their order; each row names its block's first matrix row, so
// reordering the rows (front to back from the camera) reorders the walk
// without moving the matrix. path_common.cuh's WalkHit holds the walk;
// the bounce body is trace_sample's, shared with the regen and train
// kernels.
//
// What bounds it. FP32 arithmetic: a bound test per block per traced
// segment, and a sphere test (about 25 FP32 operations, c2r2 included) per
// row of every block opened; the f64 sqrt/sin/cos recipes of
// ops/f32math.py per scatter; and divergence, since a warp walks the union
// of its lanes' opened blocks and runs until its longest path ends. Not
// bytes: the walk reads five columns a slot (20 bytes; 2 MB at 100k
// spheres, 20 MB at 1M), which sit in the 50 MB L2 after the first touch.
// What the design does about the arithmetic: culling. A block is opened
// only if the thread's ray can beat its current best inside the block's
// bound, and the front-to-back order tightens the best early so that far
// blocks cull. The bounds table (at most 1792 rows) is read through the
// read-only cache. Staging blocks in shared memory (cp.async or TMA) and a
// warp-cooperative walk are left to a later PR.
//
// Exactness. --fmad=false, no fast math, path_common.cuh's arithmetic: the
// kernel equals ops/stream_kernel.py:stream_reference bit for bit. Within a
// block the smallest root numerator wins (first row on a tie); across
// blocks a block's hit replaces the best only when t_b < t_cur, so an exact
// tie between blocks goes to the block visited first. No atomics and no
// cross-block state: a render is the same bits from run to run.
//
// With kStats the kernel writes, instead of radiance, each lane's traced
// segments and the blocks its walk opened: the work counts behind the
// bound that chip_smoke.py reports.

#include "path_common.cuh"

namespace {

struct StreamParams {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* budget;
  const float* scene;   // SoA (kNumCols, rows) of the stream matrix
  int rows;
  const float* bounds;  // (nb, 8)
  int nb, block;
  const float* cam;
  float* out;           // (3, padded) radiance, or (2, padded) counts
  int padded, max_depth;
  uint32_t k0, k1;
  int sample_offset, rr_start, finalize;
  float scale;
};

template <bool kStats>
__global__ void __launch_bounds__(kBlock) stream_kernel(StreamParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.padded) return;
  const WalkHit<kStats> hit{SceneView{p.scene, nullptr, p.scene + kRadius * p.rows, p.rows},
                            p.bounds, p.nb, p.block};
  const Cam cam = load_cam(p.cam);
  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  const float fi = p.ii[i], fj = p.jj[i], budget = p.budget[i];
  V3 acc = {0.0f, 0.0f, 0.0f};
  float seg = 0.0f;
  for (uint32_t s = (uint32_t)p.sample_offset; (float)s < budget; ++s) {
    const PathEnd e = trace_sample<WalkHit<kStats>, false>(hit, cam, st, fi, fj, s,
                                                           p.max_depth, p.rr_start, false,
                                                           nullptr);
    if (e.missed) acc = acc + e.contrib;
    seg += (float)e.bounce + 1.0f;
  }
  if (kStats) {
    p.out[i] = seg;
    p.out[p.padded + i] = (float)hit.opened;
    return;
  }
  if (p.finalize) acc = gamma2(acc * p.scale);  // 1/spp, then gamma 2
  p.out[i] = acc.x;
  p.out[p.padded + i] = acc.y;
  p.out[2 * p.padded + i] = acc.z;
}

}  // namespace

// C entry: launches on `stream` and returns cudaGetLastError().
extern "C" int stream_render(const int32_t* ids, const float* ii, const float* jj,
                             const float* budget, const float* scene, int rows,
                             const float* bounds, int nb, int block, const float* cam,
                             float* out, int padded, int max_depth, uint32_t k0, uint32_t k1,
                             int sample_offset, int rr_start, int finalize, float scale,
                             int stats, void* stream) {
  const StreamParams p{ids,    ii,    jj,    budget,    scene,     rows,
                       bounds, nb,    block, cam,       out,       padded,
                       max_depth, k0, k1,    sample_offset, rr_start, finalize,
                       scale};
  const dim3 grid((padded + kBlock - 1) / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats)
    stream_kernel<true><<<grid, kBlock, 0, st>>>(p);
  else
    stream_kernel<false><<<grid, kBlock, 0, st>>>(p);
  return (int)cudaGetLastError();
}
