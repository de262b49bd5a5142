// Fused Laplace-sigma + quadrature composite, forward and backward, for
// Hopper (sm_90a). Built with nvcc into a shared library with a plain C
// interface and called through ctypes (rendering/fused_composite.py).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   lc_forward  <- level_s2fm_tpu/rendering/pallas_composite.py::_fwd_kernel
//                  (launched by _forward_pallas)
//   lc_backward <- level_s2fm_tpu/rendering/pallas_composite.py::_bwd_kernel
//                  (launched by _backward_pallas)
//
// Per ray, over K samples (inputs already compacted and masked):
//   sigma_k = alpha * psi_beta(sdf_k) * valid_k       (Laplace CDF)
//   s_k     = sigma_k * delta                         (delta: one per ray)
//   T_k     = exp(-sum_{j<k} s_j)                     (strict prefix)
//   w_k     = T_k * (1 - exp(-s_k))
//   out     = (sum w rgb, sum w depth, sum w normal, sum w)
// Backward (hand-derived VJP, same as the TPU kernel):
//   G_k     = g_rgb.rgb_k + g_d d_k + g_n.n_k + g_op
//   dL/ds_k = G_k T_k e^{-s_k} - sum_{j>k} G_j w_j    (strict suffix)
//   d_delta = sum_k dL/ds_k sigma_k                   (per ray)
//
// Layout: the renderer's own. sdf/depth [R,K] f32, valid [R,K] bytes
// (torch.bool), delta [R] f32, rgb/normal [R,K,3] f32; alpha and beta are
// device scalars (no host sync). Outputs rgb/normal [R,3], depth/op [R];
// the backward writes d_sdf/d_depth [R,K], d_rgb/d_normal [R,K,3], the
// per-ray d_delta [R] (optional) and d_ab = (d_alpha, d_beta).
//
// Bound. Both kernels do ~30 (forward) / ~75 (backward) f32 operations per
// sample against 33 (forward) / 65 (backward) bytes per sample, far under
// the card's 20 operations per byte: they are bound by bytes. At the main
// path's R=4096, K=32 the inputs are 4.3 MB, already in the 50 MB L2, so a
// launch is a few microseconds, and the fixed cost of a launch (an empty
// kernel takes 1.9 us back to back on the H100) matters as much as the
// bytes.
//
// Design (the "register instance", K <= 128 and K % 4 == 0, the main
// path's K = 32 and the full K = 128):
// - A ray's samples stay in registers for the whole kernel. Each lane owns
//   kSpl = 4 consecutive samples; a segment of L lanes (a template
//   parameter, L = next power of two of K/4) owns one ray, so 32/L rays
//   share a warp (8 lanes per ray at K = 32). The strict prefix of s and
//   the strict suffix of G*w are a sequential sum inside the lane plus one
//   exclusive warp scan over the segment's lane totals (shuffles with
//   width L); the suffix is a true suffix over the reversed lanes, never
//   total minus prefix, which cancels. The backward is one pass: the CDF
//   is computed once and no input is read twice.
// - A lane's four samples are one 16-byte vector of sdf, depth, d_sdf and
//   d_depth, 4 bytes of valid, three 16-byte vectors of rgb, normal, d_rgb
//   and d_normal: loads and stores are 16 bytes a thread, neighbouring
//   lanes on neighbouring addresses (coalesced), ~150 bytes in flight per
//   thread.
// - One block of 128 threads is one tile of 128 / L rays (16 at K = 32),
//   one tile per block: every lane issues its nine vector loads at once,
//   and 256 blocks cover the main path's 4096 rays. This was measured
//   against a persistent grid (up to 4 blocks per SM) that staged each
//   tile's six contiguous slabs into a double-buffered shared-memory ring
//   with the 1-D bulk asynchronous copy (cp.async.bulk, completion on an
//   mbarrier, one issuing thread), so that the next tile's loads overlap
//   this tile's scans. On an H100 80GB HBM3 at 700 W (chip_smoke.py) the
//   vector loads were faster at every shape timed: at R = 4096, K = 32
//   3.527 / 7.736 us (forward / backward) against 3.773 / 8.193 us for
//   the bulk ring, at R = 65,536 27.918 / 58.184 us against 29.330 /
//   60.679 us. Our reading: at the main path's 256 tiles a persistent
//   grid has almost nothing to overlap, and at 65,536 rays the vector
//   loads of many resident blocks already keep enough bytes in flight,
//   so the ring adds only its barrier waits and a block-wide sync per
//   tile. The vector loads are kept; the ring is in the repository's
//   history.
// - dalpha/dbeta in the same launch, deterministically: each block reduces
//   its partials in a fixed order and writes them to its own slot, then
//   takes an integer ticket (an acquire-release atomic add, which makes the
//   slot visible); the last block sums the slots in a fixed order into
//   d_ab[0..1] and resets the ticket. No float atomics, so two calls on
//   the same inputs agree bit for bit. This reduction costs the backward
//   ~1.5 us at the main path's shape (composite_ablation.py), the latency
//   of the ticket and of the slot reads after the last block's stores; a
//   __threadfence before a plain atomicAdd cost ~0.4 us more there.
//
// The "chunked instance" (128 < K <= 2048, or K % 4 != 0): one ray per
// warp, 128-sample chunks of 4 samples per lane read with scalar loads.
// The forward carries the prefix from chunk to chunk; the backward first
// walks the chunks forward to store each chunk's incoming prefix in shared
// memory, then walks them in reverse so the suffix carry is a true running
// suffix.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpl = 4;                     // samples per lane
constexpr int kThreads = 128;               // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32 * kSpl;           // samples per chunk (chunked)
constexpr int kMaxK = 2048;
constexpr int kMaxChunks = kMaxK / kChunk;  // 16

// ---------------------------------------------------------------- helpers

template <int L>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) { return seg_sum<32>(v); }

// sum of v over the lanes before this one in its segment of L lanes
template <int L>
__device__ __forceinline__ float seg_excl_prefix(float v, int li) {
  float x = __shfl_up_sync(kFull, v, 1, L);
  if (li == 0) x = 0.f;
#pragma unroll
  for (int off = 1; off < L; off <<= 1) {
    const float n = __shfl_up_sync(kFull, x, off, L);
    if (li >= off) x += n;
  }
  return x;
}

// sum of v over the lanes after this one in its segment (reversed scan)
template <int L>
__device__ __forceinline__ float seg_excl_suffix(float v, int li) {
  float x = __shfl_down_sync(kFull, v, 1, L);
  if (li == L - 1) x = 0.f;
#pragma unroll
  for (int off = 1; off < L; off <<= 1) {
    const float n = __shfl_down_sync(kFull, x, off, L);
    if (li + off < L) x += n;
  }
  return x;
}

// The inputs, in the renderer's layout.
struct Src {
  const float* sdf;
  const float* depth;
  const float* rgb;
  const float* nrm;
  const float* delta;
  const uint8_t* valid;
};

// One lane's kSpl consecutive samples.
struct Samples {
  float sdf[kSpl], valid[kSpl], depth[kSpl], rgb[kSpl][3], nrm[kSpl][3];
};

__device__ __forceinline__ void unpack12(const float4* p, float (&o)[kSpl][3]) {
  const float4 a = p[0], b = p[1], c = p[2];
  const float t[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                       c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < kSpl; ++i)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[i][ch] = t[3 * i + ch];
}

__device__ __forceinline__ void pack12(float4* p, const float (&v)[kSpl][3]) {
  p[0] = make_float4(v[0][0], v[0][1], v[0][2], v[1][0]);
  p[1] = make_float4(v[1][1], v[1][2], v[2][0], v[2][1]);
  p[2] = make_float4(v[2][2], v[3][0], v[3][1], v[3][2]);
}

// samples e..e+3 (e % 4 == 0) by 16-byte vectors; zeros when !in
__device__ __forceinline__ void load_vec(Samples& x, const Src& s, long long e,
                                         bool in) {
  if (in) {
    const float4 a = *reinterpret_cast<const float4*>(s.sdf + e);
    const float4 d = *reinterpret_cast<const float4*>(s.depth + e);
    const uchar4 v = *reinterpret_cast<const uchar4*>(s.valid + e);
    x.sdf[0] = a.x; x.sdf[1] = a.y; x.sdf[2] = a.z; x.sdf[3] = a.w;
    x.depth[0] = d.x; x.depth[1] = d.y; x.depth[2] = d.z; x.depth[3] = d.w;
    x.valid[0] = v.x ? 1.f : 0.f; x.valid[1] = v.y ? 1.f : 0.f;
    x.valid[2] = v.z ? 1.f : 0.f; x.valid[3] = v.w ? 1.f : 0.f;
    unpack12(reinterpret_cast<const float4*>(s.rgb + 3 * e), x.rgb);
    unpack12(reinterpret_cast<const float4*>(s.nrm + 3 * e), x.nrm);
  } else {
#pragma unroll
    for (int i = 0; i < kSpl; ++i) {
      x.sdf[i] = x.valid[i] = x.depth[i] = 0.f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) x.rgb[i][ch] = x.nrm[i][ch] = 0.f;
    }
  }
}

// samples k0..k0+3 of the ray starting at element e0, scalar loads, any K
__device__ __forceinline__ void load_scalar(Samples& x, const Src& s, long long e0,
                                            int k0, int K) {
#pragma unroll
  for (int i = 0; i < kSpl; ++i) {
    const bool in = k0 + i < K;
    const long long e = e0 + k0 + i;
    x.sdf[i] = in ? s.sdf[e] : 0.f;
    x.valid[i] = in && s.valid[e] ? 1.f : 0.f;
    x.depth[i] = in ? s.depth[e] : 0.f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      x.rgb[i][ch] = in ? s.rgb[3 * e + ch] : 0.f;
      x.nrm[i][ch] = in ? s.nrm[3 * e + ch] : 0.f;
    }
  }
}

struct Coeffs {
  float alpha, inv_b;
};

// s_k (and the pieces the backward reuses) for a lane's samples; samples
// outside the ray have valid = 0, hence s = w = 0
__device__ __forceinline__ void sample_s(const Samples& x, float delta, Coeffs c,
                                         float (&expabs)[kSpl], float (&psi)[kSpl],
                                         float (&sigma)[kSpl], float (&s)[kSpl]) {
#pragma unroll
  for (int i = 0; i < kSpl; ++i) {
    expabs[i] = expf(-fabsf(x.sdf[i]) * c.inv_b);
    psi[i] = x.sdf[i] >= 0.f ? 0.5f * expabs[i] : 1.f - 0.5f * expabs[i];
    sigma[i] = c.alpha * psi[i] * x.valid[i];
    s[i] = sigma[i] * delta;
  }
}

// weights w_k and transmittance T_k from s and the prefix entering the lane
__device__ __forceinline__ void weights(const float (&s)[kSpl], float prefix,
                                        float (&T)[kSpl], float (&es)[kSpl],
                                        float (&w)[kSpl]) {
  float run = prefix;
#pragma unroll
  for (int i = 0; i < kSpl; ++i) {
    T[i] = expf(-run);
    es[i] = expf(-s[i]);
    w[i] = T[i] * (1.f - es[i]);
    run += s[i];
  }
}

// Per-ray cotangents, nullptr meaning zero. Ray r = b * group + i, channel
// ch of a cotangent x sits at x[b * x_sb + i * x_sr + ch * x_sc]: the
// strided slices and broadcasts autograd hands back are read in place.
struct Grads {
  const float *rgb, *depth, *nrm, *op;
  long long rgb_sb, rgb_sr, rgb_sc, depth_sb, depth_sr, depth_sc;
  long long nrm_sb, nrm_sr, nrm_sc, op_sb, op_sr, op_sc;
  int group;
};

struct RayGrad {
  float r[3], d, n[3], o;
};

__device__ __forceinline__ RayGrad load_grad(const Grads& g, int r) {
  const long long b = r / g.group, i = r - b * g.group;
  RayGrad q;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    q.r[ch] = g.rgb ? g.rgb[b * g.rgb_sb + i * g.rgb_sr + ch * g.rgb_sc] : 0.f;
    q.n[ch] = g.nrm ? g.nrm[b * g.nrm_sb + i * g.nrm_sr + ch * g.nrm_sc] : 0.f;
  }
  q.d = g.depth ? g.depth[b * g.depth_sb + i * g.depth_sr] : 0.f;
  q.o = g.op ? g.op[b * g.op_sb + i * g.op_sr] : 0.f;
  return q;
}

struct Outs {
  float *rgb, *depth, *nrm, *op;
};

struct DOuts {
  float *sdf, *rgb, *depth, *nrm, *delta;  // delta may be nullptr
  float* ab;                                // [2 + 2 * gridDim.x]
  int* ticket;                              // 0 on entry, reset on exit
};

// One lane's per-sample cotangents, stored as vectors.
struct BwdLane {
  float d_sdf[kSpl], d_depth[kSpl], d_rgb[kSpl][3], d_nrm[kSpl][3];
};

// Block partials in a fixed order, then the last block (integer ticket)
// sums every block's slot in block order into d_ab[0..1]. Only thread 0's
// slot store has to reach the last block: its ticket increment releases
// it, and the last block's thread 0 acquires every slot with its own
// increment (the __syncthreads after it orders the block's loads).
__device__ void reduce_ab(float pa, float pb, const DOuts& d) {
  __shared__ float part[kWarps][2];
  __shared__ bool last;
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  pa = warp_sum(pa);
  pb = warp_sum(pb);
  if (lane == 0) {
    part[wid][0] = pa;
    part[wid][1] = pb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sa = 0.f, sb = 0.f;
    for (int i = 0; i < kWarps; ++i) {
      sa += part[i][0];
      sb += part[i][1];
    }
    d.ab[2 + 2 * blockIdx.x] = sa;
    d.ab[3 + 2 * blockIdx.x] = sb;
    int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(ticket) : "l"(d.ticket) : "memory");
    last = ticket == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // thread i sums slots i, i + kThreads, ... in order; then each warp by a
  // fixed butterfly, and thread 0 the warps in order
  const float2* slot = reinterpret_cast<const float2*>(d.ab + 2);
  float sa = 0.f, sb = 0.f;
#pragma unroll 4
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    const float2 v = __ldcg(slot + b);
    sa += v.x;
    sb += v.y;
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  if (lane == 0) {
    part[wid][0] = sa;
    part[wid][1] = sb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ta = 0.f, tb = 0.f;
    for (int i = 0; i < kWarps; ++i) {
      ta += part[i][0];
      tb += part[i][1];
    }
    d.ab[0] = ta;
    d.ab[1] = tb;
    *d.ticket = 0;
  }
}

// ------------------------------------------------- forward, register instance

// A block is a tile of kThreads / L rays; lane li of a ray's segment owns
// its samples kSpl * li .. kSpl * li + 3.
template <int L>
__global__ void __launch_bounds__(kThreads)
fwd_regs(Src g, const float* __restrict__ alpha_p, const float* __restrict__ beta_p,
         int R, int K, Outs out) {
  const Coeffs c{*alpha_p, 1.f / *beta_p};
  const int li = threadIdx.x % L;
  const int r = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const bool ray_in = r < R;
  Samples x;
  load_vec(x, g, (long long)r * K + kSpl * li, ray_in && kSpl * li < K);
  const float delta = ray_in ? g.delta[r] : 0.f;
  float expabs[kSpl], psi[kSpl], sigma[kSpl], s[kSpl];
  sample_s(x, delta, c, expabs, psi, sigma, s);
  const float lane_s = (s[0] + s[1]) + (s[2] + s[3]);
  float T[kSpl], es[kSpl], w[kSpl];
  weights(s, seg_excl_prefix<L>(lane_s, li), T, es, w);
  float acc_r[3] = {0.f, 0.f, 0.f}, acc_n[3] = {0.f, 0.f, 0.f};
  float acc_d = 0.f, acc_w = 0.f;
#pragma unroll
  for (int i = 0; i < kSpl; ++i) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      acc_r[ch] += w[i] * x.rgb[i][ch];
      acc_n[ch] += w[i] * x.nrm[i][ch];
    }
    acc_d += w[i] * x.depth[i];
    acc_w += w[i];
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    acc_r[ch] = seg_sum<L>(acc_r[ch]);
    acc_n[ch] = seg_sum<L>(acc_n[ch]);
  }
  acc_d = seg_sum<L>(acc_d);
  acc_w = seg_sum<L>(acc_w);
  if (ray_in && li == 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      out.rgb[3 * r + ch] = acc_r[ch];
      out.nrm[3 * r + ch] = acc_n[ch];
    }
    out.depth[r] = acc_d;
    out.op[r] = acc_w;
  }
}

// ------------------------------------------------ backward, register instance

template <int L>
__global__ void __launch_bounds__(kThreads)
bwd_regs(Src g, const float* __restrict__ alpha_p, const float* __restrict__ beta_p,
         int R, int K, Grads gr, DOuts d) {
  const Coeffs c{*alpha_p, 1.f / *beta_p};
  const int li = threadIdx.x % L;
  const int r = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const bool ray_in = r < R;
  const bool in = ray_in && kSpl * li < K;
  const long long e = (long long)r * K + kSpl * li;
  Samples x;
  load_vec(x, g, e, in);
  const float delta = ray_in ? g.delta[r] : 0.f;
  const RayGrad q = ray_in ? load_grad(gr, r) : RayGrad{};
  float expabs[kSpl], psi[kSpl], sigma[kSpl], s[kSpl];
  sample_s(x, delta, c, expabs, psi, sigma, s);
  const float lane_s = (s[0] + s[1]) + (s[2] + s[3]);
  float T[kSpl], es[kSpl], w[kSpl], G[kSpl], Gw[kSpl];
  weights(s, seg_excl_prefix<L>(lane_s, li), T, es, w);
#pragma unroll
  for (int i = 0; i < kSpl; ++i) {
    G[i] = q.r[0] * x.rgb[i][0] + q.r[1] * x.rgb[i][1] + q.r[2] * x.rgb[i][2]
           + q.d * x.depth[i]
           + q.n[0] * x.nrm[i][0] + q.n[1] * x.nrm[i][1] + q.n[2] * x.nrm[i][2]
           + q.o;
    Gw[i] = G[i] * w[i];
  }
  const float lane_gw = (Gw[0] + Gw[1]) + (Gw[2] + Gw[3]);
  float suffix = seg_excl_suffix<L>(lane_gw, li);
  BwdLane o;
  float dd = 0.f, pa = 0.f, pb = 0.f;  // d_delta, dalpha, dbeta partials
#pragma unroll
  for (int i = kSpl - 1; i >= 0; --i) {
    const float dL_ds = G[i] * T[i] * es[i] - suffix;
    suffix += Gw[i];
    const float dL_dsigma = dL_ds * delta;
    dd += dL_ds * sigma[i];
    o.d_sdf[i] = dL_dsigma * x.valid[i] * c.alpha * (-0.5f * c.inv_b) * expabs[i];
    o.d_depth[i] = q.d * w[i];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      o.d_rgb[i][ch] = q.r[ch] * w[i];
      o.d_nrm[i][ch] = q.n[ch] * w[i];
    }
    pa += dL_dsigma * x.valid[i] * psi[i];
    pb += dL_dsigma * x.valid[i] * c.alpha
          * (0.5f * x.sdf[i] * c.inv_b * c.inv_b) * expabs[i];
  }
  if (in) {
    *reinterpret_cast<float4*>(d.sdf + e) =
        make_float4(o.d_sdf[0], o.d_sdf[1], o.d_sdf[2], o.d_sdf[3]);
    *reinterpret_cast<float4*>(d.depth + e) =
        make_float4(o.d_depth[0], o.d_depth[1], o.d_depth[2], o.d_depth[3]);
    pack12(reinterpret_cast<float4*>(d.rgb + 3 * e), o.d_rgb);
    pack12(reinterpret_cast<float4*>(d.nrm + 3 * e), o.d_nrm);
  }
  dd = seg_sum<L>(dd);
  if (d.delta && ray_in && li == 0) d.delta[r] = dd;
  reduce_ab(pa, pb, d);
}

// ------------------------------------------------------- chunked instance

__global__ void __launch_bounds__(kThreads)
fwd_chunked(Src g, const float* __restrict__ alpha_p, const float* __restrict__ beta_p,
            int R, int K, Outs out) {
  const Coeffs c{*alpha_p, 1.f / *beta_p};
  const int li = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= R) return;  // the whole warp leaves together
  const long long e0 = (long long)r * K;
  const float delta = g.delta[r];
  float carry = 0.f;
  float acc_r[3] = {0.f, 0.f, 0.f}, acc_n[3] = {0.f, 0.f, 0.f};
  float acc_d = 0.f, acc_w = 0.f;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    Samples x;
    load_scalar(x, g, e0, k0 + kSpl * li, K);
    float expabs[kSpl], psi[kSpl], sigma[kSpl], s[kSpl];
    sample_s(x, delta, c, expabs, psi, sigma, s);
    const float lane_s = (s[0] + s[1]) + (s[2] + s[3]);
    float T[kSpl], es[kSpl], w[kSpl];
    weights(s, carry + seg_excl_prefix<32>(lane_s, li), T, es, w);
#pragma unroll
    for (int i = 0; i < kSpl; ++i) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        acc_r[ch] += w[i] * x.rgb[i][ch];
        acc_n[ch] += w[i] * x.nrm[i][ch];
      }
      acc_d += w[i] * x.depth[i];
      acc_w += w[i];
    }
    carry += warp_sum(lane_s);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    acc_r[ch] = warp_sum(acc_r[ch]);
    acc_n[ch] = warp_sum(acc_n[ch]);
  }
  acc_d = warp_sum(acc_d);
  acc_w = warp_sum(acc_w);
  if (li == 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      out.rgb[3 * r + ch] = acc_r[ch];
      out.nrm[3 * r + ch] = acc_n[ch];
    }
    out.depth[r] = acc_d;
    out.op[r] = acc_w;
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_chunked(Src g, const float* __restrict__ alpha_p, const float* __restrict__ beta_p,
            int R, int K, Grads gr, DOuts d) {
  __shared__ float chunk_prefix[kWarps][kMaxChunks];
  const Coeffs c{*alpha_p, 1.f / *beta_p};
  const int li = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int r = blockIdx.x * kWarps + wid;
  float pa = 0.f, pb = 0.f;
  if (r < R) {
    const long long e0 = (long long)r * K;
    const float delta = g.delta[r];
    const int n_chunks = (K + kChunk - 1) / kChunk;
    // pass 1, forward over the chunks: the prefix of s entering each chunk
    float carry = 0.f;
    for (int ci = 0; ci < n_chunks; ++ci) {
      float s[kSpl];
#pragma unroll
      for (int i = 0; i < kSpl; ++i) {  // as sample_s, reading sdf and valid only
        const int k = ci * kChunk + kSpl * li + i;
        const float sdf = k < K ? g.sdf[e0 + k] : 0.f;
        const float valid = k < K && g.valid[e0 + k] ? 1.f : 0.f;
        const float e = expf(-fabsf(sdf) * c.inv_b);
        s[i] = c.alpha * (sdf >= 0.f ? 0.5f * e : 1.f - 0.5f * e) * valid * delta;
      }
      const float lane_s = (s[0] + s[1]) + (s[2] + s[3]);
      if (li == 0) chunk_prefix[wid][ci] = carry;
      carry += warp_sum(lane_s);
    }
    __syncwarp();
    const RayGrad q = load_grad(gr, r);
    // pass 2, reverse over the chunks: running strict suffix of G*w
    float suffix_carry = 0.f, dd = 0.f;
    for (int ci = n_chunks - 1; ci >= 0; --ci) {
      const int k0 = ci * kChunk + kSpl * li;
      Samples x;
      load_scalar(x, g, e0, k0, K);
      float expabs[kSpl], psi[kSpl], sigma[kSpl], s[kSpl];
      sample_s(x, delta, c, expabs, psi, sigma, s);
      const float lane_s = (s[0] + s[1]) + (s[2] + s[3]);
      float T[kSpl], es[kSpl], w[kSpl], G[kSpl], Gw[kSpl];
      weights(s, chunk_prefix[wid][ci] + seg_excl_prefix<32>(lane_s, li), T, es, w);
#pragma unroll
      for (int i = 0; i < kSpl; ++i) {
        G[i] = q.r[0] * x.rgb[i][0] + q.r[1] * x.rgb[i][1] + q.r[2] * x.rgb[i][2]
               + q.d * x.depth[i]
               + q.n[0] * x.nrm[i][0] + q.n[1] * x.nrm[i][1] + q.n[2] * x.nrm[i][2]
               + q.o;
        Gw[i] = G[i] * w[i];
      }
      const float lane_gw = (Gw[0] + Gw[1]) + (Gw[2] + Gw[3]);
      float suffix = suffix_carry + seg_excl_suffix<32>(lane_gw, li);
      suffix_carry += warp_sum(lane_gw);
#pragma unroll
      for (int i = kSpl - 1; i >= 0; --i) {
        const float dL_ds = G[i] * T[i] * es[i] - suffix;
        suffix += Gw[i];
        const float dL_dsigma = dL_ds * delta;
        dd += dL_ds * sigma[i];
        pa += dL_dsigma * x.valid[i] * psi[i];
        pb += dL_dsigma * x.valid[i] * c.alpha
              * (0.5f * x.sdf[i] * c.inv_b * c.inv_b) * expabs[i];
        const int k = k0 + i;
        if (k < K) {
          const long long e = e0 + k;
          d.sdf[e] = dL_dsigma * x.valid[i] * c.alpha * (-0.5f * c.inv_b) * expabs[i];
          d.depth[e] = q.d * w[i];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            d.rgb[3 * e + ch] = q.r[ch] * w[i];
            d.nrm[3 * e + ch] = q.n[ch] * w[i];
          }
        }
      }
    }
    dd = warp_sum(dd);
    if (d.delta && li == 0) d.delta[r] = dd;
  }
  reduce_ab(pa, pb, d);
}

// ------------------------------------------------------------ dispatch

int lanes_for(int K) {
  int L = 1;
  while (L * kSpl < K) L <<= 1;
  return L;
}

bool regs_instance(int K) { return K <= 32 * kSpl && K % kSpl == 0; }

int grid_for(int R, int K) {
  if (!regs_instance(K)) return (R + kWarps - 1) / kWarps;
  const int TR = kThreads / lanes_for(K);
  return (R + TR - 1) / TR;
}

template <int L>
cudaError_t launch_regs(bool fwd, int grid, cudaStream_t st, const Src& g,
                        const float* a, const float* b, int R, int K,
                        const Outs& out, const Grads& gr, const DOuts& d) {
  if (fwd)
    fwd_regs<L><<<grid, kThreads, 0, st>>>(g, a, b, R, K, out);
  else
    bwd_regs<L><<<grid, kThreads, 0, st>>>(g, a, b, R, K, gr, d);
  return cudaGetLastError();
}

cudaError_t launch(bool fwd, cudaStream_t st, const Src& g, const float* a,
                   const float* b, int R, int K, const Outs& out, const Grads& gr,
                   const DOuts& d) {
  const int grid = grid_for(R, K);
  if (!regs_instance(K)) {
    if (fwd)
      fwd_chunked<<<grid, kThreads, 0, st>>>(g, a, b, R, K, out);
    else
      bwd_chunked<<<grid, kThreads, 0, st>>>(g, a, b, R, K, gr, d);
    return cudaGetLastError();
  }
  switch (lanes_for(K)) {
    case 1: return launch_regs<1>(fwd, grid, st, g, a, b, R, K, out, gr, d);
    case 2: return launch_regs<2>(fwd, grid, st, g, a, b, R, K, out, gr, d);
    case 4: return launch_regs<4>(fwd, grid, st, g, a, b, R, K, out, gr, d);
    case 8: return launch_regs<8>(fwd, grid, st, g, a, b, R, K, out, gr, d);
    case 16: return launch_regs<16>(fwd, grid, st, g, a, b, R, K, out, gr, d);
    default: return launch_regs<32>(fwd, grid, st, g, a, b, R, K, out, gr, d);
  }
}

}  // namespace

extern "C" {

int lc_max_k() { return kMaxK; }
// Rays per block of the chunked instance: the most blocks any launch uses
// is ceil(R / lc_min_rays_per_block()), which sizes d_ab's partial slots.
int lc_min_rays_per_block() { return kWarps; }

// Device pointers: sdf/depth [R,K] f32, valid [R,K] u8, delta [R] f32,
// rgb/normal [R,K,3] f32, alpha/beta scalars; outputs rgb_out/normal_out
// [R,3], depth_out/op_out [R]. Every pointer 16-byte aligned, 0 < K <=
// lc_max_k().
int lc_forward(const float* sdf, const unsigned char* valid, const float* delta,
               const float* rgb, const float* depth, const float* normal,
               const float* alpha, const float* beta, int R, int K,
               float* rgb_out, float* depth_out, float* normal_out, float* op_out,
               void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  const Src g{sdf, depth, rgb, normal, delta, valid};
  const Outs out{rgb_out, depth_out, normal_out, op_out};
  return (int)launch(true, (cudaStream_t)stream, g, alpha, beta, R, K, out,
                     Grads{}, DOuts{});
}

// Extra inputs: the per-ray cotangents g_rgb/g_normal [.,3], g_depth/g_op
// [.], channel ch of ray r = b * group + i at element b * sb + i * sr +
// ch * sc, or nullptr for zero. Outputs d_sdf/d_depth [R,K], d_rgb/d_normal
// [R,K,3], d_delta [R] (nullptr: not written), d_ab [2 + 2 * ceil(R /
// lc_min_rays_per_block())] with (d_alpha, d_beta) in d_ab[0..1] and the
// rest scratch; ticket: one int, 0 on entry and left 0.
int lc_backward(const float* sdf, const unsigned char* valid, const float* delta,
                const float* rgb, const float* depth, const float* normal,
                const float* alpha, const float* beta,
                const float* g_rgb, long long g_rgb_sb, long long g_rgb_sr,
                long long g_rgb_sc, const float* g_depth, long long g_depth_sb,
                long long g_depth_sr, long long g_depth_sc, const float* g_normal,
                long long g_normal_sb, long long g_normal_sr, long long g_normal_sc,
                const float* g_op, long long g_op_sb, long long g_op_sr,
                long long g_op_sc, int group,
                int R, int K, float* d_sdf, float* d_rgb, float* d_depth,
                float* d_normal, float* d_delta, float* d_ab, int* ticket,
                void* stream) {
  if (R <= 0) return (int)cudaMemsetAsync(d_ab, 0, 2 * sizeof(float),
                                          (cudaStream_t)stream);
  const Src g{sdf, depth, rgb, normal, delta, valid};
  const Grads gr{g_rgb, g_depth, g_normal, g_op,
                 g_rgb_sb, g_rgb_sr, g_rgb_sc, g_depth_sb, g_depth_sr, g_depth_sc,
                 g_normal_sb, g_normal_sr, g_normal_sc, g_op_sb, g_op_sr, g_op_sc,
                 group};
  const DOuts d{d_sdf, d_rgb, d_depth, d_normal, d_delta, d_ab, ticket};
  return (int)launch(false, (cudaStream_t)stream, g, alpha, beta, R, K,
                     Outs{}, gr, d);
}

// An empty kernel, launched by the same path, to time the launch floor.
int lc_empty(void* stream);

}  // extern "C"

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int lc_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
