// Device code shared by the train kernels (train_render.cu,
// stream_train.cu): the hand adjoint of one scatter (scatter_vjp,
// ops/backward.py:winner_bounce_vjp line for line), the sky's adjoint, the
// primary ray's adjoint into the 18 camera scalars, the fused step's
// pointwise loss block, and a fixed-order block tree. One copy, so that
// both kernels differentiate the same arithmetic.
#pragma once

#include "path_common.cuh"

namespace {

constexpr int kMaxDepth = 64;   // ops/train_kernel.py:MAX_DEPTH
constexpr int kGradCols = 9;    // centre xyz, radius, albedo rgb, fuzz, ior
constexpr int kNCam = 18;       // pack_camera columns 0..17
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

// The constants of the fused step's pointwise loss block.
struct LossConsts {
  int gamma, loss, num_pixels;
  float inv_spp, w, two_w, hd, half_hd;
};

// The fused step's pointwise block (ops/train_kernel.py:loss_and_cotangent)
// for one lane: from the radiance sum `rad` and the target row, the image
// (1/spp, then gamma), the lane's loss term and the cotangent g of `rad`.
// Padding lanes (pixel id >= num_pixels) give zero.
__device__ __forceinline__ V3 loss_block(const LossConsts& k, V3 rad, V3 row, bool valid,
                                         V3& img, float& loss_term) {
  img = rad * k.inv_spp;
  if (k.gamma) img = gamma2(img);
  const V3 diff = valid ? img - row : V3{0.0f, 0.0f, 0.0f};
  const float dx[3] = {diff.x, diff.y, diff.z};
  const float tg[3] = {row.x, row.y, row.z};
  float per[3], gi[3];
  for (int c = 0; c < 3; ++c) {
    const float dc = dx[c];
    if (k.loss == kMse) {
      per[c] = dc * dc;
      gi[c] = dc * k.two_w;
    } else if (k.loss == kL1) {
      per[c] = fabsf(dc);
      gi[c] = (dc > 0.0f ? 1.0f : (dc < 0.0f ? -1.0f : 0.0f)) * k.w;
    } else if (k.loss == kHuber) {
      const float am = fabsf(dc);
      per[c] = am <= k.hd ? 0.5f * dc * dc : k.hd * (am - k.half_hd);
      gi[c] = fminf(fmaxf(dc, -k.hd), k.hd) * k.w;
    } else {
      const float den = tg[c] * tg[c] + 0.01f;
      per[c] = dc * dc / den;
      gi[c] = (dc * k.two_w) / den;
    }
  }
  loss_term = (per[0] + per[1]) + per[2];
  const float im[3] = {img.x, img.y, img.z};
  if (k.gamma)
    for (int c = 0; c < 3; ++c) gi[c] = im[c] > 0.0f ? (0.5f * gi[c]) / im[c] : 0.0f;
  return V3{gi[0], gi[1], gi[2]} * k.inv_spp;
}

// The primary ray's adjoint for sample s: adds the 18 camera cotangents
// (pack_camera columns 0..17) to cam_acc.
__device__ __forceinline__ void camera_adjoint(const Cam& cam, const Stream& st, uint32_t s,
                                               float fi, float fj, V3 ct_o, V3 ct_d,
                                               float* cam_acc) {
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

}  // namespace
