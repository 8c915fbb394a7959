// The group table of the two-level closest-hit scan (path_common.cuh's
// ScanHit), built on the card from the scene's SoA as it stands at the
// launch, in one block, before each launch of a kernel that scans with it.
// No host copy of the scene and no host sync: a train step that moved
// centres or radii gets bounds of its current spheres.
//
// What it computes (ops/group_scan.py:group_table_reference is the plain
// twin, equal word for word):
//   * the median |r| of the active slots within kSafe (|c|^2 + r^2), the
//     lower of the two middle values; a slot is large when it is active and
//     its |r| exceeds kLargeScale times that median, or it lies outside
//     kSafe (the scan tests it with the large slots);
//   * the other active slots are small: sorted by the Morton code of their
//     centres (10 bits an axis, interleaved as ops/stream_kernel.py:_morton3
//     interleaves them, over the cube of the small centres' box's longest
//     side, so that a flat layer's thin axis does not scatter the groups),
//     then by slot, and cut into groups of kGroup;
//   * a group's bound: centre C the middle of its members' box, R the
//     largest centre distance plus |r|, widened to R + kPad (|C| + R) +
//     kSlack (the scan adds kPad |o| a ray);
//   * the groups front to back from the camera centre: by |C - camera| -
//     the widened R, then by Morton rank.
// Output (int32 words): [n_large padded to 4, n_groups, n_large, n_small],
// then group_entries(n) scan entries (scan_entry's float4: the large slots
// in slot order, then each group's members in table order; padding is an
// inactive entry, which never hits), group_bounds(n) bounds (C, widened R)
// and group_entries(n) slots (-1 for padding); unused words are zero
// (bounds) or padding (entries, slots).
//
// Every float is computed with the twin's association (--fmad=false); a
// minimum or maximum of zeros is taken +0 (adding +0.0f), so the sign of a
// zero never depends on the order of a reduction.

#include "path_common.cuh"

namespace {

constexpr int kThreads = 1024;
// ops/group_scan.py:MAX_SLOTS. Up to here the two-level scan renders
// faster than the one-level scan although its staged table halves a
// block's occupancy near the top (probes/scan_range.py, PERF.md).
constexpr int kMaxSlots = 2048;
constexpr unsigned long long kNone = ~0ull;
constexpr unsigned kLow = 0xffffffffu;

__device__ __forceinline__ bool in_safe(const float* soa, int n, int k) {
  const float cx = soa[kCx * n + k], cy = soa[kCy * n + k], cz = soa[kCz * n + k];
  const float r = soa[kRadius * n + k];
  return ((cx * cx + cy * cy) + cz * cz) + r * r <= kSafe;  // false for inf and NaN
}

// The 10 low bits of v spread to every third bit.
__device__ __forceinline__ uint32_t spread3(uint32_t v) {
  v &= 0x3ffu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

__device__ __forceinline__ uint32_t quant(float c, float lo, float span) {
  const float q = fminf(fmaxf((c - lo) / span * 1023.0f, 0.0f), 1023.0f);
  return (uint32_t)q;
}

// A float's bits as an unsigned key that sorts as the float does.
__device__ __forceinline__ uint32_t orderable(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Ascending bitonic sort of key[0, m), m a power of two; all threads.
__device__ void block_sort(unsigned long long* key, int m) {
  for (int k = 2; k <= m; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < m; i += kThreads) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = key[i], b = key[l];
          if ((a > b) == ((i & k) == 0)) {
            key[i] = b;
            key[l] = a;
          }
        }
      }
      __syncthreads();
    }
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int m = 2;
  while (m < n) m <<= 1;
  return m;
}

// min (sign -1) or max over the block of one value a thread; all threads.
__device__ float block_extreme(float v, bool is_max, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : fminf(v, w);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kThreads / 32; ++w) v = is_max ? fmaxf(v, red[w]) : fminf(v, red[w]);
  __syncthreads();
  return v + 0.0f;
}

__global__ void __launch_bounds__(kThreads) group_table_kernel(const float* soa, int n,
                                                               const float* cam,
                                                               int32_t* table) {
  __shared__ unsigned long long key[kMaxSlots];
  __shared__ unsigned long long gkey[kMaxSlots / kGroup];
  __shared__ float4 gbound[kMaxSlots / kGroup];
  __shared__ float red[kThreads / 32];
  const int tid = threadIdx.x;
  const int m = pow2_at_least(n);

  // 1. the median |r| of the active slots within kSafe
  int counted = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int k = base + tid;
    const bool ok = k < n && soa[kActive * n + k] > 0.5f && in_safe(soa, n, k);
    if (k < m)
      key[k] = ok ? ((unsigned long long)__float_as_uint(fabsf(soa[kRadius * n + k])) << 32) | k
                  : kNone;
    counted += __syncthreads_count(ok);
  }
  block_sort(key, m);
  const float thr =
      counted ? kLargeScale * __uint_as_float((uint32_t)(key[(counted - 1) / 2] >> 32)) : 0.0f;
  __syncthreads();

  // 2. the small slots' box, then the sort keys: large slots by slot, then
  // small slots by Morton code and slot
  float lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    float l = kTMiss, h = -kTMiss;
    for (int k = tid; k < n; k += kThreads) {
      const bool act = soa[kActive * n + k] > 0.5f;
      if (act && in_safe(soa, n, k) && !(fabsf(soa[kRadius * n + k]) > thr)) {
        l = fminf(l, soa[a * n + k]);
        h = fmaxf(h, soa[a * n + k]);
      }
    }
    lo[a] = block_extreme(l, false, red);
    hi[a] = block_extreme(h, true, red);
  }
  const float span = fmaxf(fmaxf(fmaxf(hi[0] - lo[0], hi[1] - lo[1]), hi[2] - lo[2]), 1e-9f);
  int n_large = 0, n_small = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int k = base + tid;
    bool large = false, small = false;
    unsigned long long v = kNone;
    if (k < n && soa[kActive * n + k] > 0.5f) {
      small = in_safe(soa, n, k) && !(fabsf(soa[kRadius * n + k]) > thr);
      large = !small;
      if (large) {
        v = (unsigned long long)k;
      } else {
        const uint32_t code = spread3(quant(soa[kCx * n + k], lo[0], span)) |
                              (spread3(quant(soa[kCy * n + k], lo[1], span)) << 1) |
                              (spread3(quant(soa[kCz * n + k], lo[2], span)) << 2);
        v = (1ull << 62) | ((unsigned long long)code << 32) | k;
      }
    }
    if (k < m) key[k] = v;
    n_large += __syncthreads_count(large);
    n_small += __syncthreads_count(small);
  }
  block_sort(key, m);

  // 3. each group's bound and its place front to back
  const int n_groups = (n_small + kGroup - 1) / kGroup;
  const int gm = pow2_at_least(n_groups);
  const V3 eye = {cam[9], cam[10], cam[11]};
  for (int j = tid; j < gm; j += kThreads) {
    if (j >= n_groups) {
      gkey[j] = kNone;
      continue;
    }
    const int first = n_large + j * kGroup, last = min(first + kGroup, n_large + n_small);
    float l[3] = {kTMiss, kTMiss, kTMiss}, h[3] = {-kTMiss, -kTMiss, -kTMiss};
    for (int q = first; q < last; ++q) {
      const int k = (int)(key[q] & kLow);
      for (int a = 0; a < 3; ++a) {
        l[a] = fminf(l[a], soa[a * n + k]);
        h[a] = fmaxf(h[a], soa[a * n + k]);
      }
    }
    const V3 c = {(l[0] + h[0]) * 0.5f + 0.0f, (l[1] + h[1]) * 0.5f + 0.0f,
                  (l[2] + h[2]) * 0.5f + 0.0f};
    float r = 0.0f;
    for (int q = first; q < last; ++q) {
      const int k = (int)(key[q] & kLow);
      const V3 e = V3{soa[kCx * n + k], soa[kCy * n + k], soa[kCz * n + k]} - c;
      r = fmaxf(r, sqrtf((e.x * e.x + e.y * e.y) + e.z * e.z) + fabsf(soa[kRadius * n + k]));
    }
    const float cn = sqrtf((c.x * c.x + c.y * c.y) + c.z * c.z);
    const float rw = (r + kPad * (cn + r)) + kSlack;
    const V3 e = c - eye;
    const float dist = sqrtf((e.x * e.x + e.y * e.y) + e.z * e.z) - rw;
    gbound[j] = make_float4(c.x, c.y, c.z, rw);
    gkey[j] = ((unsigned long long)orderable(dist) << 32) | j;
  }
  __syncthreads();
  block_sort(gkey, gm);

  // 4. the table
  const int ne = group_entries(n), nbd = group_bounds(n);
  const int n_large_pad = (n_large + 3) & ~3;
  float4* entry = reinterpret_cast<float4*>(table + kTableHead);
  float4* bound = entry + ne;
  int32_t* slot = reinterpret_cast<int32_t*>(bound + nbd);
  if (tid == 0) {
    table[0] = n_large_pad;
    table[1] = n_groups;
    table[2] = n_large;
    table[3] = n_small;
  }
  for (int p = tid; p < ne; p += kThreads) {
    int k = -1;
    if (p < n_large) {
      k = (int)(key[p] & kLow);
    } else if (p >= n_large_pad) {
      const int q = (p - n_large_pad) / kGroup, i = (p - n_large_pad) % kGroup;
      if (q < n_groups) {
        const int at = (int)(gkey[q] & kLow) * kGroup + i;
        if (at < n_small) k = (int)(key[n_large + at] & kLow);
      }
    }
    slot[p] = k;
    entry[p] = k >= 0 ? scan_entry(soa, n, k)
                      : make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7fffffff));
  }
  for (int q = tid; q < nbd; q += kThreads)
    bound[q] = q < n_groups ? gbound[gkey[q] & kLow] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace

// C entry: builds the table of the n-slot SoA scene (2 * kGroup <= n <=
// kMaxSlots) for camera row `cam` into `table` (group_table.cu's words) on
// `stream`; returns cudaGetLastError().
extern "C" int group_table(const float* soa, int n, const float* cam, int32_t* table,
                           void* stream) {
  if (n < 2 * kGroup || n > kMaxSlots) return (int)cudaErrorInvalidValue;
  group_table_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(soa, n, cam, table);
  return (int)cudaGetLastError();
}
