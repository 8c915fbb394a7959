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
// without moving the matrix.
//
// What bounds it. FP32 arithmetic in the walk, issued warp-wide: a bound
// test and a ballot per bounds row per traced segment; 16 group box tests
// per piece of 256 rows of a block that some lane of the warp opens (until
// a piece with a group to test); an 18-operation sphere test per row of the
// groups the warp opens; the f64 sqrt/sin/cos recipes of ops/f32math.py per
// scatter; and divergence, since a warp walks the union of its lanes'
// blocks and tests the union of their groups. At the 100k stream render's
// shape (640x384, 10 spp, 10 bounces) a warp iteration tests 392 bounds
// rows and the boxes of 26.7 blocks, and the rows it tests are 3.9% of
// those blocks' rows (1 before the groups), so the bound rows and the boxes
// now take most of the walk. Not bytes: the tables are 16 bytes a row and
// 32 a group (1.8 MB at 100k spheres, 18 MB at 1M), in the 50 MB L2 after
// the first touch.
// What the design does about it:
//   * culling in two levels: a block is opened only where the lane's ray
//     can beat its current best inside the block's bound, and a group of
//     the block's rows only where the ray can beat min(its best in the
//     block, t_cur) inside the group's box (staged_walk.cuh's header); the
//     front-to-back order tightens t_cur early so that far blocks cull;
//   * kernel 5's walk (staged_walk.cuh's StagedWalk): the scan table and
//     the group table (one launch of scan_table_kernel before the render),
//     the lanes' ballots over each bounds row and each group, and each
//     piece with an opened group staged per warp in shared memory by
//     cp.async with the next one in flight;
//   * the regenerating loop (path_common.cuh's regen_lane), which gives the
//     walk what it needs, every lane of the warp at each call: one segment
//     an iteration, a lane whose path ended starting its next sample at the
//     next iteration, and a lane whose budget is spent walking along with
//     live = false until the warp's last lane is done.
//
// Exactness. --fmad=false, no fast math, path_common.cuh's arithmetic: the
// kernel equals ops/stream_kernel.py:stream_reference bit for bit, and its
// image equals kernel 5's fused image. Within a block the smallest root
// numerator wins (first row on a tie); across blocks a block's hit replaces
// the best only when t_b < t_cur, so an exact tie between blocks goes to
// the block visited first. No atomics and no cross-block state: a render is
// the same bits from run to run.
//
// With kStats the kernel writes, instead of radiance, each lane's traced
// segments and the blocks its walk opened, and at each warp's lane 0 the
// blocks the warp walked (the union of its lanes' at each iteration) and
// the rows it tested in them: the work counts behind the bound that
// chip_smoke.py reports.

#include "staged_walk.cuh"

namespace {

struct StreamParams {
  const int32_t* ids;
  const float* ii;
  const float* jj;
  const float* budget;
  const float* scene;   // SoA (kNumCols, rows) of the stream matrix
  int rows;
  const float4* scan;   // (rows) scan table, then the group table
  const float* bounds;  // (nb, 8)
  int nb, block;
  const float* cam;
  float* out;           // (3, padded) radiance, or (4, padded) counts
  // at most render_kernel.MAX_LANES: 3 x lanes fits int, so the (3, lanes) rows index in int
  int padded, max_depth;
  uint32_t k0, k1;
  int sample_offset, rr_start, finalize;
  float scale;
};

template <bool kStats>
__global__ void __launch_bounds__(kBlock) stream_kernel(StreamParams p) {
  extern __shared__ float4 stage[];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kBlock + tid;  // padded is a multiple of kBlock
  const StagedWalk<kStats> walk{
      SceneView{p.scene, nullptr, p.scene + kRadius * p.rows, p.rows}, p.scan, p.bounds, p.nb,
      p.block, stage + (tid / 32) * 2 * kPiece, 0xffffffffu};
  const Cam cam = load_cam(p.cam);
  const Stream st{p.k0, p.k1, (uint32_t)p.ids[i]};
  V3 acc = {0.0f, 0.0f, 0.0f};
  float seg = 0.0f;
  regen_lane(walk, cam, st, p.ii[i], p.jj[i], (uint32_t)p.sample_offset, p.budget[i],
             p.max_depth, p.rr_start, false, [](int, const Entry&) {},
             [&](const PathEnd& e) {
               if (e.missed) acc = acc + e.contrib;
               seg += (float)e.bounce + 1.0f;
             });
  if (kStats) {
    p.out[i] = seg;
    p.out[p.padded + i] = (float)walk.opened;
    p.out[2 * p.padded + i] = (tid & 31) ? 0.0f : (float)walk.fetched;
    p.out[3 * p.padded + i] = (tid & 31) ? 0.0f : (float)walk.tested;
    return;
  }
  if (p.finalize) acc = gamma2(acc * p.scale);  // 1/spp, then gamma 2
  p.out[i] = acc.x;
  p.out[p.padded + i] = acc.y;
  p.out[2 * p.padded + i] = acc.z;
}

}  // namespace

// C entries: each launches on `stream` and returns cudaGetLastError().
// The walk's tables (scan_table_kernel) alone, into `table` (n scan rows,
// then two float4 a group).
extern "C" int stream_tables(const float* scene, int rows, int block, float* table,
                             void* stream) {
  return (int)launch_tables(scene, rows, block, table, static_cast<cudaStream_t>(stream));
}

// The walk's tables, then the render.
extern "C" int stream_render(const int32_t* ids, const float* ii, const float* jj,
                             const float* budget, const float* scene, int rows, float* scan,
                             const float* bounds, int nb, int block, const float* cam,
                             float* out, int padded, int max_depth, uint32_t k0, uint32_t k1,
                             int sample_offset, int rr_start, int finalize, float scale,
                             int stats, void* stream) {
  if (padded % kBlock) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_tables(scene, rows, block, scan, st);
  if (e != cudaSuccess) return (int)e;
  const float4* table = reinterpret_cast<const float4*>(scan);
  const StreamParams p{ids,  ii,        jj,       budget,   scene,  rows,          table,
                       bounds, nb,      block,    cam,      out,    padded,        max_depth,
                       k0,   k1,        sample_offset, rr_start, finalize, scale};
  const dim3 grid(padded / kBlock);
  if (stats)
    stream_kernel<true><<<grid, kBlock, kStageBytes, st>>>(p);
  else
    stream_kernel<false><<<grid, kBlock, kStageBytes, st>>>(p);
  return (int)cudaGetLastError();
}
