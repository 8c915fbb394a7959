// The stream walk's closest hit, shared by the stream render (kernel 4,
// stream_render.cu) and the stream train kernel (kernel 5,
// stream_train.cu): StagedWalk, its cp.async helpers and the table kernel
// that builds its input.
//
// The walk, in two levels. The bounds rows are walked in their order
// (Morton, or front to back from the camera); each row gives its block's
// bound sphere and first matrix row. A block is opened only where the
// lane's ray can improve on its t_cur inside the bound (path_common.cuh's
// bound_can_improve). Inside an opened block the rows are cut, in matrix
// order, into groups of kGroup rows (the last one of a block shorter when
// kGroup does not divide the block), each behind a conservative box
// (group_box), and a lane tests a group's rows only where its box test
// (box_can_improve) says that the lane's ray can improve there on
// min(its best root numerator in the block, t_cur a). Within a block the
// first row wins a tie of root numerators; a block's hit replaces the best
// only when t_b < t_cur, so a tie between blocks goes to the block visited
// first. These are the plain walk's rules (ops/stream_kernel.py:_Walk),
// lane by lane, and its grouped twin (_Walk with groups) counts the same
// work.
//
// Why the cull changes nothing (u = 2^-24; path_common.cuh's header, items
// 1-3, for the slot test):
//   1. The groups of a block are visited in row order and take_root keeps
//      a root only on a strict '<'. The block's winner over every row is
//      its least root numerator Z*, first row k* on a tie. Skipping a
//      group that holds no root Z with tmin_a < Z <= best (the lane's best
//      in the block so far, which never falls below Z*) keeps (Z*, k*): the
//      group of k* is tested, every row tested before k* has a root above
//      Z* or none, and none after it takes the best. A lane that tests a
//      group its own test skips (its warp opened it) changes nothing by the
//      same argument.
//   2. The cap t_cur a. The block's hit counts only when t_b = Z* (1/a) <
//      t_cur. Where it does, Z* <= t_cur a (1 + 4u) (three roundings), so
//      a test that passes whenever a root Z <= cap (1 + 4u) lies in the
//      group, cap = min(best, t_cur a), tests the group of k* and the
//      winner is (Z*, k*). Where it does not, the subset's least root is at
//      least Z*, its t_b at least t_cur (rounding is monotone), and the
//      block changes nothing either way.
//   3. Where a root lies. Item 3 puts the point P at t = Z / a within
//      r_k + sqrt(40 u) S_k = r_k + 1.5446e-3 S_k of the member's centre
//      c_k, S_k = |c_k| + |r_k| + |o|: in every axis |P - C| is at most the
//      box's half-extent H (centre C the middle of the members' centres'
//      box) plus r_k + 1.5446e-3 S_k.
//   4. The box. group_box stores C and E = H + W, W = R + kBoxPad (|M| +
//      R) + kSlack, where R is the members' largest |r| and |M| the length
//      of the corner (max |lo|, max |hi| an axis), at least every |c_k|;
//      the lane adds kBoxPad |o|. kBoxPad = 0x1.ap-10 = 1.5869e-3, so E +
//      kBoxPad |o| exceeds the reach of item 3 by (kBoxPad - 1.5446e-3) S' =
//      4.23e-5 S' = 709 u S', S' = |M| + R + |o| >= S_k, less the roundings
//      of C, H, |M|, W, E and the lane's kBoxPad |o| (under 16 u S', since
//      H <= 2 |M|). kBoxPad has to exceed sqrt(40 u) + 64 u = 1.5479e-3, the
//      reach and every rounding of items 4 and 5; the tests hold it there.
//   5. The box test. In the numerator domain along each axis, with s =
//      a / d: the ray is in the slab between (C - o) s -/+ (E + kBoxPad
//      |o|) |s|, and near (far) is the largest (smallest) of the three
//      ends. The test's roundings (s, C - o, the two products, the sum and
//      the two ends: under 8 u of (|C| + |o| + E + kBoxPad |o|) <= 4 S' in
//      position) and the cap's (4u of Z, Z a at most |P - o| <= 2 S' in
//      position) total under 48 u S', so P's margin of at least 693 u S'
//      leaves near <= Z <= cap (1 + 4u) passing and far >= Z > tmin_a.
//   6. Infinities. An axis with d = 0 (or a / d above FLT_MAX) gives ends
//      of +-inf or NaN (inf - inf, 0 inf); fmaxf and fminf drop a NaN, so
//      such an axis never narrows the test. The axis of the largest |d|
//      always gives finite ends within the magnitudes below.
//   7. Where the argument's magnitudes do not hold the lane tests every
//      group that has an active member: a ray with |d|^2 below 1e-12 or
//      |d|^2 or |o|^2 above kSafe (`wide`). A group with an active member
//      whose |c|^2 + r^2 exceeds kSafe, or is not finite, has E = +inf and
//      always passes; a group with no active member (padding) has E = -inf
//      and never passes. Hollow glass (r < 0) is bounded by |r|.
//
// The tables. One launch before each walk launch, scan_table_kernel, builds
// from the stream matrix's SoA both the scan table (cx, cy, cz, c2r2 or
// NaN where inactive: one 16-byte read and 18 FP32 operations a slot test,
// scan_entry) and, after it, the group table (two float4 a group: C, then
// E), so that a train step that moved centres or radii walks bounds of its
// current spheres.
//
// The staging. A warp walks its lanes' blocks together: the lanes ballot
// each bounds row at their own t_cur, and the lanes that open a block
// ballot each group of its pieces (kPiece rows, so blocks of 1024 rows take
// four) at min(best, t_cur a). A piece that some lane can improve in is an
// item: its rows are copied into the warp's slot of shared memory with
// cp.async, and while one item is tested the next one is in flight: the
// block's next piece with a group some lane opens, or the first such piece
// of a later bounds row that some lane passes at its current t_cur. best
// and t_cur only fall, so those ballots are supersets of what the lanes
// will open; when an item is tested its groups are tested again at the
// current best, and a prefetched block that no lane opens any more is
// dropped. So the groups a warp tests do not depend on the prefetch.
//
// Every lane of `mask` must call the walk together, or two groups of the
// warp's lanes would share its slots: a lane with nothing to trace calls it
// with live = false (path_common.cuh's regen_lane does so for a Hit with
// kLockstep; kernel 5's trace_parked runs its bounce loop in lockstep).
#pragma once

#include "path_common.cuh"

namespace {

constexpr int kPiece = 256;             // scan rows one warp stages at once (4 KB)
constexpr int kPieceGroups = kPiece / kGroup;
constexpr float kBoxPad = 0x1.ap-10f;   // group box widening per unit of |M| + R + |o|
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

// Groups a block of `block` rows holds, and in a stream matrix of n rows.
__host__ __device__ __forceinline__ int block_groups(int block) {
  return (block + kGroup - 1) / kGroup;
}
__host__ __device__ __forceinline__ int walk_groups(int n, int block) {
  return n / block * block_groups(block);
}

// The box of matrix rows [k0, k1) (header, items 4 and 7): c = (C, 0) and
// e = (E, 0); E = -inf with no active row, +inf with an active row outside
// kSafe. Minima and maxima of zeros are taken +0 (adding +0.0f), so the
// sign of a zero never depends on the rows' order.
__device__ __forceinline__ void group_box(const float* soa, int n, int k0, int k1, float4& c,
                                          float4& e) {
  const float inf = __int_as_float(0x7f800000);
  V3 lo = {inf, inf, inf}, hi = {-inf, -inf, -inf};
  float rmax = 0.0f;
  bool any = false, safe = true;
  for (int k = k0; k < k1; ++k) {
    if (!(soa[kActive * n + k] > 0.5f)) continue;
    const float x = soa[kCx * n + k], y = soa[kCy * n + k], z = soa[kCz * n + k];
    const float r = soa[kRadius * n + k];
    any = true;
    safe = safe && ((x * x + y * y) + z * z) + r * r <= kSafe;  // false for inf and NaN
    lo = {fminf(lo.x, x), fminf(lo.y, y), fminf(lo.z, z)};
    hi = {fmaxf(hi.x, x), fmaxf(hi.y, y), fmaxf(hi.z, z)};
    rmax = fmaxf(rmax, fabsf(r));
  }
  c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!any || !safe) {
    const float w = any ? inf : -inf;
    e = make_float4(w, w, w, 0.0f);
    return;
  }
  lo = {lo.x + 0.0f, lo.y + 0.0f, lo.z + 0.0f};
  hi = {hi.x + 0.0f, hi.y + 0.0f, hi.z + 0.0f};
  const V3 ctr = (lo + hi) * 0.5f;
  const V3 m = {fmaxf(fabsf(lo.x), fabsf(hi.x)), fmaxf(fabsf(lo.y), fabsf(hi.y)),
                fmaxf(fabsf(lo.z), fabsf(hi.z))};
  const float w = (rmax + kBoxPad * (sqrtf(dot(m, m)) + rmax)) + kSlack;
  c = make_float4(ctr.x, ctr.y, ctr.z, 0.0f);
  e = make_float4(fmaxf(hi.x - ctr.x, ctr.x - lo.x) + w, fmaxf(hi.y - ctr.y, ctr.y - lo.y) + w,
                  fmaxf(hi.z - ctr.z, ctr.z - lo.z) + w, 0.0f);
}

// The walk's tables of a stream matrix's SoA of n rows in blocks of
// `block`: the scan table (n float4), then the group table (two float4 a
// group, C then E). One thread a row; the first walk_groups(n, block)
// threads also build one group each.
__global__ void scan_table_kernel(const float* soa, int n, int block, float4* table) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) table[k] = scan_entry(soa, n, k);
  const int per = block_groups(block);
  if (k < walk_groups(n, block)) {
    const int b = k / per, g = k % per;
    const int k0 = b * block + g * kGroup;
    const int k1 = g + 1 < per ? k0 + kGroup : (b + 1) * block;
    group_box(soa, n, k0, k1, table[n + 2 * k], table[n + 2 * k + 1]);
  }
}

__host__ __forceinline__ cudaError_t launch_tables(const float* soa, int n, int block,
                                                   float* table, cudaStream_t st) {
  scan_table_kernel<<<(n + 255) / 256, 256, 0, st>>>(soa, n, block,
                                                    reinterpret_cast<float4*>(table));
  return cudaGetLastError();
}

// A lane's ray as the bound tests read it.
struct WalkRay {
  V3 o, d, s;   // s = a / d, an axis
  float a, d_dot_o, o2, tmin_a, pad_o;
  bool wide;    // outside the argument's magnitudes: every non-empty group passes
};

// Can the lane's root numerator improve on `cap` inside the box (c, e)?
// The slab test of the header, items 5-7.
__device__ __forceinline__ bool box_can_improve(const float4 c, const float4 e, const WalkRay& r,
                                                float cap) {
  const float mx = (c.x - r.o.x) * r.s.x, hx = (e.x + r.pad_o) * fabsf(r.s.x);
  const float my = (c.y - r.o.y) * r.s.y, hy = (e.y + r.pad_o) * fabsf(r.s.y);
  const float mz = (c.z - r.o.z) * r.s.z, hz = (e.z + r.pad_o) * fabsf(r.s.z);
  const float near = fmaxf(fmaxf(mx - hx, my - hy), mz - hz);
  const float far = fminf(fminf(mx + hx, my + hy), mz + hz);
  return r.wide ? e.x >= 0.0f : near <= fminf(far, cap) && far > r.tmin_a;
}

// Called by every lane of `mask` together; `live` is false for a lane with
// nothing to trace. With kCount, `opened` counts the blocks this lane
// opened, `fetched` the blocks the warp walked (the union of its lanes')
// and `tested` the rows the warp tested, whatever the prefetch skipped.
template <bool kCount>
struct StagedWalk {
  static constexpr bool kHbm = true;
  static constexpr bool kLockstep = true;
  SceneView sc;          // the stream matrix as SoA (kNumCols, rows): the gather
  const float4* scan;    // (rows) scan table, then the group table
  const float* bounds;   // (nb, 8): cx, cy, cz, r_bound, first row, unused
  int nb, block;
  float4* buf;           // this warp's two slots of kPiece rows, shared memory
  unsigned mask;         // the warp's lanes
  mutable int opened = 0, fetched = 0, tested = 0;

  // A piece to stage: bounds row j (nb: none), piece q, and its groups that
  // some lane opened (bit i: the piece's group i).
  struct Item {
    int j, q;
    unsigned m;
  };

  __device__ __forceinline__ float4 bound(int j) const {
    return __ldg(reinterpret_cast<const float4*>(bounds) + 2 * j);
  }
  __device__ __forceinline__ int first_row(int j) const { return (int)__ldg(bounds + 8 * j + 4); }
  __device__ __forceinline__ int pieces() const { return (block + kPiece - 1) / kPiece; }
  __device__ __forceinline__ int piece_rows(int q) const {
    return block - q * kPiece < kPiece ? block - q * kPiece : kPiece;
  }
  // The group table's index of the first group of piece q at bounds row j.
  __device__ __forceinline__ int first_group(int j, int q) const {
    return first_row(j) / block * block_groups(block) + q * kPieceGroups;
  }
  __device__ __forceinline__ bool box(int g, const WalkRay& r, float cap) const {
    const float4* t = scan + sc.n + 2 * g;
    return box_can_improve(__ldg(t), __ldg(t + 1), r, cap);
  }
  // Copy the rows of item `it`'s piece into `slot`, spread over the mask's
  // lanes; every lane commits one group.
  __device__ __forceinline__ void fetch(const Item& it, int slot) const {
    const unsigned lane = threadIdx.x & 31;
    const int rank = __popc(mask & ((1u << lane) - 1u)), lanes = __popc(mask);
    const int k = first_row(it.j) + it.q * kPiece, n = piece_rows(it.q);
    float4* dst = buf + slot * kPiece;
    for (int r = rank; r < n; r += lanes) cp_async16(dst + r, scan + k + r);
    cp_async_commit();
  }
  // The groups of piece q at bounds row j that some lane of `on` can
  // improve in at cap, as bits.
  __device__ __forceinline__ unsigned piece_groups(int j, int q, bool on, const WalkRay& r,
                                                   float cap) const {
    const int g0 = first_group(j, q);
    const int left = block_groups(block) - q * kPieceGroups;
    const int ng = left < kPieceGroups ? left : kPieceGroups;
    unsigned bits = 0;
    if (on) {
#pragma unroll 4
      for (int i = 0; i < ng; ++i)
        if (box(g0 + i, r, cap)) bits |= 1u << i;
    }
    return __reduce_or_sync(mask, bits);
  }
  // The next item after piece q - 1 of bounds row j (lanes `pass` at the
  // block's cap; j = -1: none), else in the first later bounds row that
  // some lane can improve in at t_cur (cap t_cur a).
  __device__ __forceinline__ Item next_item(int j, int q, bool pass, float cap, bool live,
                                            const WalkRay& r, float t_cur) const {
    if (j >= 0)
      for (; q < pieces(); ++q)
        if (const unsigned m = piece_groups(j, q, pass, r, cap)) return {j, q, m};
    const float tca = t_cur * r.a;
    for (++j; j < nb; ++j) {
      const bool p =
          live && bound_can_improve(bound(j), r.o, r.d, r.a, r.d_dot_o, r.o2, t_cur);
      if (!__any_sync(mask, p)) continue;
      for (q = 0; q < pieces(); ++q)
        if (const unsigned m = piece_groups(j, q, p, r, tca)) return {j, q, m};
    }
    return {nb, 0, 0u};
  }
  // Count mode: the bounds rows after j0 and before j1, which the items
  // skipped, as the lanes pass them at t_cur.
  __device__ __forceinline__ void count_skipped(int j0, int j1, bool live, const WalkRay& r,
                                                float t_cur) const {
    for (int j = j0 + 1; j < j1; ++j) {
      const bool p =
          live && bound_can_improve(bound(j), r.o, r.d, r.a, r.d_dot_o, r.o2, t_cur);
      opened += p;
      fetched += __any_sync(mask, p);
    }
  }

  __device__ __forceinline__ bool operator()(V3 o, V3 d, bool live, int& win, float& t) const {
    const float dd = dot(d, d);
    WalkRay r;
    r.o = o;
    r.d = d;
    r.a = fmaxf(dd, 1e-12f);
    r.s = {r.a / d.x, r.a / d.y, r.a / d.z};
    r.d_dot_o = dot(d, o);
    r.o2 = dot(o, o);
    r.tmin_a = kTMin * r.a;
    r.pad_o = kBoxPad * sqrtf(r.o2);
    r.wide = !(dd >= 1e-12f && dd <= kSafe && r.o2 <= kSafe);
    float t_cur = kTMiss;
    win = 0;
    int slot = 0, cur = -1;
    bool pass = false;
    float best = kTMiss;
    int wb = 0;
    Item it = next_item(-1, 0, false, 0.0f, live, r, t_cur);
    if (it.j < nb) fetch(it, slot);
    while (it.j < nb) {
      if (it.j != cur) {  // a new block: its lanes at the current t_cur
        if (kCount) count_skipped(cur, it.j, live, r, t_cur);
        cur = it.j;
        pass = live && bound_can_improve(bound(cur), o, d, r.a, r.d_dot_o, r.o2, t_cur);
        if (!__any_sync(mask, pass)) {  // t_cur fell since the prefetch: drop it
          cp_async_wait<0>();
          __syncwarp(mask);
          it = next_item(cur, pieces(), false, 0.0f, live, r, t_cur);
          if (it.j < nb) fetch(it, slot);
          continue;
        }
        if (kCount) {
          opened += pass;
          ++fetched;
        }
        best = kTMiss;
        wb = 0;
      }
      const float tca = t_cur * r.a;
      const Item nx = next_item(cur, it.q + 1, pass, fminf(best, tca), live, r, t_cur);
      if (nx.j < nb) {
        fetch(nx, slot ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp(mask);
      const int g0 = first_group(cur, it.q);
      const float4* rows = buf + slot * kPiece;
      const int n = piece_rows(it.q), kq = first_row(cur) + it.q * kPiece;
      for (unsigned mm = it.m; mm; mm &= mm - 1) {
        const int i = __ffs(mm) - 1, r0 = i * kGroup;
        const bool can = pass && box(g0 + i, r, fminf(best, tca));
        if (!__any_sync(mask, can)) continue;
        const int r1 = r0 + kGroup < n ? r0 + kGroup : n;
        if (kCount) tested += r1 - r0;
        if (!pass) continue;
        int k = r0;
        for (; k + 4 <= r1; k += 4) {
          const SlotDisc q0 = slot_disc(rows[k], o, d, r.a, r.d_dot_o, r.o2);
          const SlotDisc q1 = slot_disc(rows[k + 1], o, d, r.a, r.d_dot_o, r.o2);
          const SlotDisc q2 = slot_disc(rows[k + 2], o, d, r.a, r.d_dot_o, r.o2);
          const SlotDisc q3 = slot_disc(rows[k + 3], o, d, r.a, r.d_dot_o, r.o2);
          if (q0.disc > 0.0f || q1.disc > 0.0f || q2.disc > 0.0f || q3.disc > 0.0f) {
            take_root(q0, r.tmin_a, kq + k, best, wb);
            take_root(q1, r.tmin_a, kq + k + 1, best, wb);
            take_root(q2, r.tmin_a, kq + k + 2, best, wb);
            take_root(q3, r.tmin_a, kq + k + 3, best, wb);
          }
        }
        for (; k < r1; ++k)
          test_slot(rows[k], o, d, r.a, r.d_dot_o, r.o2, r.tmin_a, kq + k, best, wb);
      }
      __syncwarp(mask);  // the slot is read before a later fetch refills it
      slot ^= 1;
      if (nx.j != cur) {  // the block is done: its hit against t_cur
        const float t_b = best * (1.0f / r.a);
        if (best < kTMiss && t_b < t_cur) {
          t_cur = t_b;
          win = wb;
        }
      }
      it = nx;
    }
    if (kCount) count_skipped(cur, nb, live, r, t_cur);
    if (!(t_cur < kTMiss)) return false;
    t = t_cur;
    return true;
  }
};

}  // namespace
