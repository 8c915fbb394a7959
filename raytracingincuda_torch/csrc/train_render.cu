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
#include "path_common.cuh"

namespace {

constexpr int kMaxDepth = 64;   // ops/train_kernel.py:MAX_DEPTH
constexpr int kGradCols = 9;    // centre xyz, radius, albedo rgb, fuzz, ior
constexpr int kNCam = 18;       // pack_camera columns 0..17
constexpr int kStaticSmem = kBlock * (4 + 4 * kGradCols + 4 * kNCam);
constexpr int kMaxSmem = 232448;  // bytes a Hopper block may take
enum { kMse, kL1, kHuber, kRelMse };

__device__ __forceinline__ float dmax(float x, float lo) {
  return x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dmin(float x, float hi) {
  return x < hi ? 1.0f : (x == hi ? 0.5f : 0.0f);
}

// adjoint of unit(v) = v * rsqrt(max(|v|^2, 1e-30)): dr/dq = -0.5 r / q
__device__ __forceinline__ V3 unit_vjp(V3 v, V3 ct) {
  const float s = dot(v, v);
  const float q = fmaxf(s, 1e-30f);
  const float r = rsqrt_f32(q);
  const float ct_s = dot(ct, v) * (-0.5f * (r / q)) * dmax(s, 1e-30f);
  return ct * r + v * (2.0f * ct_s);
}

// adjoint of r = v - n * (2 v.n)
__device__ __forceinline__ void reflect_vjp(V3 v, V3 n, V3 ct, V3& ct_v, V3& ct_n) {
  const float cn = dot(ct, n);
  ct_v = ct - n * (2.0f * cn);
  ct_n = (ct * (-2.0f * dot(v, n))) - v * (2.0f * cn);
}

// adjoint of vec.refract(uv, n, ri)
__device__ __forceinline__ void refract_vjp(V3 uv, V3 n, float ri, V3 ct, V3& ct_uv,
                                            V3& ct_n, float& ct_ri) {
  const float x = dot(-uv, n);
  const float cos = fminf(x, 1.0f);
  const V3 base = uv + n * cos;
  const V3 perp = base * ri;
  const float u = 1.0f - dot(perp, perp);
  const float amag = fabsf(u);
  const float par = sqrtf(fmaxf(amag, 1e-12f));
  ct_n = ct * (-par);
  const float ct_par = -dot(ct, n);
  const float ct_q = ct_par * (0.5f / par);
  const float sgn = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : 0.0f);
  const float ct_u = ct_q * dmax(amag, 1e-12f) * sgn;
  const V3 ct_perp = ct + perp * (2.0f * -ct_u);
  ct_ri = dot(ct_perp, base);
  const V3 ct_base = ct_perp * ri;
  ct_n = ct_n + ct_base * cos;
  const float ct_x = dot(ct_base, n) * dmin(x, 1.0f);
  ct_uv = ct_base - n * ct_x;
  ct_n = ct_n - uv * ct_x;
}

// adjoint of sky(d) with respect to d
__device__ __forceinline__ V3 sky_vjp(V3 d, V3 ct_sky) {
  const float ct_a = dot(ct_sky, V3{(float)(0.5 - 1.0), (float)(0.7 - 1.0), 0.0f});
  return unit_vjp(d, V3{0.0f, 0.5f * ct_a, 0.0f});
}

// The adjoint of one surviving scatter at bounce b (ops/backward.py:
// winner_bounce_vjp on a live lane that hit and scattered on). In: the
// entry e and the cotangents of the outgoing state (ct_o, ct_d, ct_at);
// out: those of the incoming state, in place, and the winner's nine.
template <bool kHbm>
__device__ __forceinline__ void scatter_vjp(const SceneView& sc, const Stream& st,
                                            uint32_t s, int b, int rr_start,
                                            const Entry& e, V3& ct_o, V3& ct_d,
                                            V3& ct_at, float* dv) {
  const int k = e.slot;
  const V3 o = e.o, d = e.d, atten = e.atten;
  const V3 wc = slot_center<kHbm>(sc, k);
  const float wr = sc.col(0, k);
  const V3 walb = {sc.col(1, k), sc.col(2, k), sc.col(3, k)};
  const float ior = sc.col(5, k);
  const int mat = (int)sc.col(6, k);

  // ---- the primal, as trace_sample computed it ----------------------------
  const float dd = dot(d, d);
  const float a = fmaxf(dd, 1e-12f);
  const float h = (wc.x * d.x + wc.y * d.y + wc.z * d.z) - dot(d, o);
  const float c2r2 = wc.x * wc.x + wc.y * wc.y + wc.z * wc.z - wr * wr;
  const float c = (c2r2 + dot(o, o)) - 2.0f * (wc.x * o.x + wc.y * o.y + wc.z * o.z);
  const float disc = h * h - a * c;
  const float sq = sqrtf(disc);
  const float near = h - sq;
  const bool take_near = near > kTMin * a;
  const float root = take_near ? near : h + sq;
  const float inv_a = 1.0f / a;
  const float t = root * inv_a;
  const V3 p = o + d * t;
  const bool big = fabsf(wr) > 1e-12f;
  const float rs = big ? wr : 1e-12f;
  const float inv_r = 1.0f / rs;
  const V3 diff = p - wc;
  const V3 outward = diff * inv_r;
  const bool front = dot(d, outward) < 0.0f;
  const V3 normal = front ? outward : -outward;
  const V3 att = mat == 2 ? V3{1.0f, 1.0f, 1.0f} : walb;
  const V3 m = atten * att;

  // ---- RR weight and the attenuation product ------------------------------
  V3 ct_m = ct_at;
  if (rr_start >= 0 && b >= rr_start) {
    const float mx = fmaxf(fmaxf(m.x, m.y), m.z);
    const float q = fmaxf(mx, 0.05f);
    const float ps = fminf(q, 1.0f);
    const float w = 1.0f / ps;
    const float ct_w = dot(ct_at, m);
    ct_m = ct_at * w;
    const float ct_ps = -ct_w / (ps * ps);
    const float ct_mx = ct_ps * dmin(q, 1.0f) * dmax(mx, 0.05f);
    const float m1 = fmaxf(m.x, m.y);
    const float d_m1 = m1 > m.z ? 1.0f : (m1 == m.z ? 0.5f : 0.0f);
    const float d_x = m.x > m.y ? 1.0f : (m.x == m.y ? 0.5f : 0.0f);
    ct_m = ct_m + V3{ct_mx * d_m1 * d_x, ct_mx * d_m1 * (1.0f - d_x),
                     ct_mx * (1.0f - d_m1)};
  }
  const V3 ct_in_at = ct_m * att;
  const V3 d_alb = mat == 2 ? V3{0.0f, 0.0f, 0.0f} : ct_m * atten;

  // ---- the scattered direction --------------------------------------------
  const V3 ct_dir = ct_d;
  V3 ct_n = {0.0f, 0.0f, 0.0f}, ct_d_dir = {0.0f, 0.0f, 0.0f};
  float d_fuzz = 0.0f, ct_ior = 0.0f;
  if (mat == 0) {  // dir = normal + unit_rand, or normal
    ct_n = ct_dir;
  } else if (mat == 1) {  // dir = unit(reflect(d, n)) + unit_rand * fuzz
    const V3 ur = st.unit_vector(s, (uint32_t)b);
    const V3 ct_refl = unit_vjp(reflect(d, normal), ct_dir);
    reflect_vjp(d, normal, ct_refl, ct_d_dir, ct_n);
    d_fuzz = dot(ct_dir, ur);
  } else {  // dielectric: reflect(ud, n) or refract(ud, n, ri)
    float coin, unused;
    st.uniform2(s, (uint32_t)b, kDrawCoin, coin, unused);
    const float ri = front ? 1.0f / ior : ior;
    const V3 ud = unit(d);
    const float cos_t = fminf(dot(-ud, normal), 1.0f);
    const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
    V3 ct_ud;
    if (ri * sin_t > 1.0f || schlick(cos_t, ri) > coin) {
      reflect_vjp(ud, normal, ct_dir, ct_ud, ct_n);
    } else {
      float ct_ri;
      refract_vjp(ud, normal, ri, ct_dir, ct_ud, ct_n, ct_ri);
      ct_ior = front ? -ct_ri / (ior * ior) : ct_ri;
    }
    ct_d_dir = unit_vjp(d, ct_ud);
  }

  // ---- normal -> outward -> (hit point, centre, radius) --------------------
  const V3 ct_out = front ? ct_n : -ct_n;
  const V3 ct_diff = ct_out * inv_r;
  const float ct_rs = -dot(ct_out, diff) / (rs * rs);
  float ct_wr = big ? ct_rs : 0.0f;
  const V3 ct_p = ct_o + ct_diff;
  V3 ct_wc = -ct_diff;
  // p = o + d * t
  V3 ct_o_s = ct_p;
  V3 ct_d_s = ct_d_dir + ct_p * t;
  const float ct_t = dot(ct_p, d);
  // t = root * (1 / a)
  const float ct_root = ct_t * inv_a;
  float ct_a = -(ct_t * root) / (a * a);
  // root = h -+ sqrt(disc)
  float ct_h = ct_root;
  const float ct_sq = take_near ? -ct_root : ct_root;
  const float ct_disc = ct_sq * (0.5f / sq);
  ct_h = ct_h + ct_disc * (2.0f * h);
  ct_a = ct_a - ct_disc * c;
  const float ct_c = -ct_disc * a;
  // c = (|wc|^2 - wr^2 + |o|^2) - 2 wc.o
  ct_wc = ct_wc + wc * (2.0f * ct_c) - o * (2.0f * ct_c);
  ct_wr = ct_wr - wr * (2.0f * ct_c);
  ct_o_s = ct_o_s + o * (2.0f * ct_c) - wc * (2.0f * ct_c);
  // h = wc.d - d.o
  ct_wc = ct_wc + d * ct_h;
  ct_d_s = ct_d_s + (wc - o) * ct_h;
  ct_o_s = ct_o_s - d * ct_h;
  // a = max(|d|^2, 1e-12)
  ct_d_s = ct_d_s + d * (2.0f * ct_a * dmax(dd, 1e-12f));

  dv[0] = ct_wc.x;
  dv[1] = ct_wc.y;
  dv[2] = ct_wc.z;
  dv[3] = ct_wr;
  dv[4] = d_alb.x;
  dv[5] = d_alb.y;
  dv[6] = d_alb.z;
  dv[7] = d_fuzz;
  dv[8] = ct_ior;
  ct_o = ct_o_s;
  ct_d = ct_d_s;
  ct_at = ct_in_at;
}

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

// A fixed-order tree over the block's lanes of red[c][*], c < cols; the
// result lands in red[c][0]. Called by every thread of the block.
__device__ __forceinline__ void block_tree(float (*red)[kBlock], int cols) {
  __syncthreads();
  for (int stride = kBlock / 2; stride > 0; stride >>= 1) {
    if ((int)threadIdx.x < stride)
      for (int c = 0; c < cols; ++c) red[c][threadIdx.x] += red[c][threadIdx.x + stride];
    __syncthreads();
  }
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
  int gamma, loss, num_pixels;
  float inv_spp, w, two_w, hd, half_hd;
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
  const SceneView sc{p.scene, smem, kHbm ? p.scene + kRadius * n : gath, n};
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
      const PathEnd e = trace_sample<kHbm, false>(sc, cam, st, fi, fj, s, p.max_depth,
                                                  p.rr_start, false, nullptr);
      if (e.missed) rad = rad + e.contrib;
    }
    V3 img = rad * p.inv_spp;
    if (p.gamma)
      img = {img.x > 0.0f ? sqrtf(img.x) : 0.0f, img.y > 0.0f ? sqrtf(img.y) : 0.0f,
             img.z > 0.0f ? sqrtf(img.z) : 0.0f};
    p.image[i] = img.x;
    p.image[p.padded + i] = img.y;
    p.image[2 * p.padded + i] = img.z;
    const V3 diff = p.ids[i] < p.num_pixels ? img - row : V3{0.0f, 0.0f, 0.0f};
    const float dx[3] = {diff.x, diff.y, diff.z};
    const float tg[3] = {row.x, row.y, row.z};
    float per[3], gi[3];
    for (int c = 0; c < 3; ++c) {
      const float dc = dx[c];
      if (p.loss == kMse) {
        per[c] = dc * dc;
        gi[c] = dc * p.two_w;
      } else if (p.loss == kL1) {
        per[c] = fabsf(dc);
        gi[c] = (dc > 0.0f ? 1.0f : (dc < 0.0f ? -1.0f : 0.0f)) * p.w;
      } else if (p.loss == kHuber) {
        const float am = fabsf(dc);
        per[c] = am <= p.hd ? 0.5f * dc * dc : p.hd * (am - p.half_hd);
        gi[c] = fminf(fmaxf(dc, -p.hd), p.hd) * p.w;
      } else {
        const float den = tg[c] * tg[c] + 0.01f;
        per[c] = dc * dc / den;
        gi[c] = (dc * p.two_w) / den;
      }
    }
    loss_term = (per[0] + per[1]) + per[2];
    const float im[3] = {img.x, img.y, img.z};
    if (p.gamma)
      for (int c = 0; c < 3; ++c) gi[c] = im[c] > 0.0f ? (0.5f * gi[c]) / im[c] : 0.0f;
    g = V3{gi[0], gi[1], gi[2]} * p.inv_spp;
  }

  float cam_acc[kNCam];
#pragma unroll
  for (int c = 0; c < kNCam; ++c) cam_acc[c] = 0.0f;
  Entry stack[kMaxDepth];
  for (uint32_t s = (uint32_t)p.sample_offset; (int)s < p.sample_offset + p.samples; ++s) {
    const PathEnd e = trace_sample<kHbm, true>(sc, cam, st, fi, fj, s, p.max_depth,
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
        scatter_vjp<kHbm>(sc, st, s, b, p.rr_start, en, ct_o, ct_d, ct_at, dv);
      }
      commit_round(acc, have, slot, dv, st_slot, st_val);
    }
    if (e.missed) {  // the primary ray -> the 18 camera scalars
      float u0, u1, px, py;
      primary_draws(st, s, u0, u1, px, py);
      const float su = fi + (u0 - 0.5f), sv = fj + (u1 - 0.5f);
      const V3 ct_origin = ct_o - ct_d;
      const float pxs = cam.defocus ? px : 0.0f, pys = cam.defocus ? py : 0.0f;
      const V3 rows6[6] = {ct_d, ct_d * su, ct_d * sv, ct_origin, ct_origin * pxs,
                           ct_origin * pys};
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        cam_acc[3 * q] += rows6[q].x;
        cam_acc[3 * q + 1] += rows6[q].y;
        cam_acc[3 * q + 2] += rows6[q].z;
      }
    }
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
  p.rr_start = rr_start; p.gamma = gamma; p.loss = loss; p.num_pixels = num_pixels;
  p.inv_spp = inv_spp; p.w = w; p.two_w = two_w; p.hd = hd; p.half_hd = half_hd;
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
