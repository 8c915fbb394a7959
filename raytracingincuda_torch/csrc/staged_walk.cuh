// The stream walk's closest hit, shared by the stream render (kernel 4,
// stream_render.cu) and the stream train kernel (kernel 5,
// stream_train.cu): StagedWalk, its cp.async helpers and the scan-table
// kernel that builds its input.
//
// The walk. The bounds rows are walked in their order (Morton, or front to
// back from the camera); each row gives its block's bound sphere and first
// matrix row. A block is opened only where the lane's ray can improve on
// its t_cur inside the bound (path_common.cuh's bound_can_improve); within
// a block the first row wins a tie of root numerators; a block's hit
// replaces the best only when t_b < t_cur, so a tie between blocks goes to
// the block visited first. These are the plain walk's rules
// (ops/stream_kernel.py:_Walk), lane by lane.
//
// The sphere test reads a packed scan table (cx, cy, cz, c2r2 or NaN where
// inactive), built once per launch by scan_table_kernel through scan_entry:
// one 16-byte read and 18 FP32 operations a test. A warp walks its lanes'
// blocks together: the lanes ballot each bounds row at their own t_cur; a
// block that any lane opens is copied into the warp's slot of shared memory
// with cp.async (in pieces of kPiece rows, so blocks of 1024 rows take
// four), and only the lanes that opened it test its rows. While a piece is
// tested the next one is already in flight: the block's next piece, or the
// first piece of the next bounds row that any lane passes at its current
// t_cur (t_cur only falls, so that is a superset of what the lanes will
// open; a prefetched block that no lane opens any more is dropped).
//
// Every lane of `mask` must call the walk together, or two groups of the
// warp's lanes would share its slots: a lane with nothing to trace calls it
// with live = false (path_common.cuh's regen_lane does so for a Hit with
// kLockstep; kernel 5's trace_parked runs its bounce loop in lockstep).
#pragma once

#include "path_common.cuh"

namespace {

constexpr int kPiece = 256;  // scan rows one warp stages at once (4 KB)
constexpr int kWarps = kBlock / 32;
constexpr size_t kStageBytes = (size_t)kWarps * 2 * kPiece * sizeof(float4);

// cp.async of 16 bytes from device memory into shared memory (L2 only).
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The scan table of a stream matrix's SoA: one float4 a row.
__global__ void scan_table_kernel(const float* soa, int n, float4* scan) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) scan[k] = scan_entry(soa, n, k);
}

// Called by every lane of `mask` together; `live` is false for a lane with
// nothing to trace. With kCount, `opened` counts the blocks this lane
// opened and `fetched` the blocks the warp tested, the union of its lanes'.
template <bool kCount>
struct StagedWalk {
  static constexpr bool kHbm = true;
  static constexpr bool kLockstep = true;
  SceneView sc;          // the stream matrix as SoA (kNumCols, rows): the gather
  const float4* scan;    // (rows) scan table
  const float* bounds;   // (nb, 8): cx, cy, cz, r_bound, first row, unused
  int nb, block;
  float4* buf;           // this warp's two slots of kPiece rows, shared memory
  unsigned mask;         // the warp's lanes
  mutable int opened = 0, fetched = 0;

  __device__ __forceinline__ float4 bound(int j) const {
    return __ldg(reinterpret_cast<const float4*>(bounds) + 2 * j);
  }
  __device__ __forceinline__ int first_row(int j) const { return (int)__ldg(bounds + 8 * j + 4); }
  __device__ __forceinline__ int piece_rows(int q) const {
    return block - q * kPiece < kPiece ? block - q * kPiece : kPiece;
  }
  // Copy scan rows [k, k + n) into `slot`, spread over the mask's lanes;
  // every lane commits one group.
  __device__ __forceinline__ void fetch(int k, int n, int slot) const {
    const unsigned lane = threadIdx.x & 31;
    const int rank = __popc(mask & ((1u << lane) - 1u)), lanes = __popc(mask);
    float4* dst = buf + slot * kPiece;
    for (int r = rank; r < n; r += lanes) cp_async16(dst + r, scan + k + r);
    cp_async_commit();
  }
  // The first bounds row from j on that some lane can improve in at its
  // t_cur; nb if none.
  __device__ __forceinline__ int next_open(int j, bool live, V3 o, V3 d, float a,
                                           float d_dot_o, float o2, float t_cur) const {
    for (; j < nb; ++j)
      if (__any_sync(mask, live && bound_can_improve(bound(j), o, d, a, d_dot_o, o2, t_cur)))
        break;
    return j;
  }

  __device__ __forceinline__ bool operator()(V3 o, V3 d, bool live, int& win, float& t) const {
    const float a = fmaxf(dot(d, d), 1e-12f);
    const float d_dot_o = dot(d, o);
    const float o2 = dot(o, o);
    const float tmin_a = kTMin * a;
    const int pieces = (block + kPiece - 1) / kPiece;
    float t_cur = kTMiss;
    win = 0;
    int slot = 0;
    int j = next_open(0, live, o, d, a, d_dot_o, o2, t_cur);
    if (j < nb) fetch(first_row(j), piece_rows(0), slot);
    while (j < nb) {
      const bool pass = live && bound_can_improve(bound(j), o, d, a, d_dot_o, o2, t_cur);
      if (!__any_sync(mask, pass)) {  // t_cur fell since the prefetch: drop it
        cp_async_wait<0>();
        __syncwarp(mask);
        j = next_open(j + 1, live, o, d, a, d_dot_o, o2, t_cur);
        if (j < nb) fetch(first_row(j), piece_rows(0), slot);
        continue;
      }
      if (kCount) {
        opened += pass;
        ++fetched;
      }
      const int k0 = first_row(j);
      float best = kTMiss;
      int wb = 0, jn = nb;
      for (int q = 0; q < pieces; ++q) {
        bool ahead = q + 1 < pieces;
        if (ahead) {
          fetch(k0 + (q + 1) * kPiece, piece_rows(q + 1), slot ^ 1);
        } else {
          jn = next_open(j + 1, live, o, d, a, d_dot_o, o2, t_cur);
          ahead = jn < nb;
          if (ahead) fetch(first_row(jn), piece_rows(0), slot ^ 1);
        }
        if (ahead) cp_async_wait<1>(); else cp_async_wait<0>();
        __syncwarp(mask);
        if (pass) {
          const float4* rows = buf + slot * kPiece;
          const int n = piece_rows(q), kq = k0 + q * kPiece;
          for (int r = 0; r < n; ++r)
            test_slot(rows[r], o, d, a, d_dot_o, o2, tmin_a, kq + r, best, wb);
        }
        __syncwarp(mask);  // the slot is read before a later fetch refills it
        slot ^= 1;
      }
      const float t_b = best * (1.0f / a);
      if (best < kTMiss && t_b < t_cur) {
        t_cur = t_b;
        win = wb;
      }
      j = jn;
    }
    if (!(t_cur < kTMiss)) return false;
    t = t_cur;
    return true;
  }
};

}  // namespace
