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
//   s_k     = sigma_k * delta_k
//   T_k     = exp(-sum_{j<k} s_j)                     (strict prefix)
//   w_k     = T_k * (1 - exp(-s_k))
//   out     = (sum w rgb, sum w depth, sum w normal, sum w)
// Backward (hand-derived VJP, same as the TPU kernel):
//   G_k     = g_rgb.rgb_k + g_d d_k + g_n.n_k + g_op
//   dL/ds_k = G_k T_k e^{-s_k} - sum_{j>k} G_j w_j    (strict suffix)
//
// Design. One warp per ray, one lane per sample; K > 32 loops over
// 32-wide chunks with the running prefix carried in a register and the
// ragged tail masked. The TPU kernel's [Rt,K]x[K,K] triangular matmuls
// become warp-shuffle scans: an inclusive scan of s (strict prefix =
// scan - s) and, in the backward, a scan over the REVERSED lane order for
// the suffix (not total minus prefix, which cancels badly). The backward
// first walks the chunks forward to store each chunk's incoming prefix in
// shared memory, then walks them in reverse so the suffix carry is a true
// running suffix. d_alpha/d_beta partials are reduced per block in a
// fixed order and written to a [n_blocks, 2] buffer that the caller sums:
// deterministic, no float atomics.
//
// Bound. Memory-bound: the forward reads 10 f32 per sample (sdf, valid,
// delta, depth, 3 rgb, 3 normal) and writes 8 f32 per ray; the backward
// reads the same 10 per sample plus 8 per ray and writes 9 per sample.
// At the main path's R=4096..8192, K=32 that is ~5-10 MB forward and
// ~10-20 MB backward: a few microseconds at 3.35 TB/s, so at these sizes
// the kernels are launch-bound. alpha and beta are read from a device
// buffer so the call never synchronises with the host.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChunks = 64;  // K <= 2048 (checked by the caller)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// inclusive prefix over lanes 0..lane
__device__ __forceinline__ float warp_scan_up(float v, int lane) {
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    float n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += n;
  }
  return v;
}

// inclusive suffix over lanes lane..31 (a scan over the reversed lanes)
__device__ __forceinline__ float warp_scan_down(float v, int lane) {
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    float n = __shfl_down_sync(kFull, v, off);
    if (lane + off < kWarp) v += n;
  }
  return v;
}

struct Sample {
  float sdf, valid, delta, depth, rgb[3], nrm[3];
};

__device__ __forceinline__ Sample load_sample(
    const float* __restrict__ sdf, const float* __restrict__ valid,
    const float* __restrict__ delta, const float* __restrict__ rgb,
    const float* __restrict__ depth, const float* __restrict__ normal,
    long long idx, long long plane, bool in) {
  Sample s;
  s.sdf = in ? sdf[idx] : 0.f;
  s.valid = in ? valid[idx] : 0.f;
  s.delta = in ? delta[idx] : 0.f;
  s.depth = in ? depth[idx] : 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.rgb[c] = in ? rgb[c * plane + idx] : 0.f;
    s.nrm[c] = in ? normal[c * plane + idx] : 0.f;
  }
  return s;
}

__device__ __forceinline__ float laplace_psi(float sdf, float beta) {
  float e = 0.5f * expf(-fabsf(sdf) / beta);
  return sdf >= 0.f ? e : 1.f - e;
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
fwd_kernel(const float* __restrict__ sdf, const float* __restrict__ valid,
           const float* __restrict__ delta, const float* __restrict__ rgb,
           const float* __restrict__ depth, const float* __restrict__ normal,
           const float* __restrict__ ab, int R, int K,
           float* __restrict__ rgb_out, float* __restrict__ depth_out,
           float* __restrict__ normal_out, float* __restrict__ op_out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // whole warp exits together
  const float alpha = ab[0], beta = ab[1];
  const long long plane = (long long)R * K;
  float carry = 0.f;
  float acc_rgb[3] = {0.f, 0.f, 0.f}, acc_n[3] = {0.f, 0.f, 0.f};
  float acc_d = 0.f, acc_w = 0.f;
  for (int k0 = 0; k0 < K; k0 += kWarp) {
    const int k = k0 + lane;
    const bool in = k < K;
    const long long idx = (long long)r * K + k;
    Sample x = load_sample(sdf, valid, delta, rgb, depth, normal, idx, plane, in);
    const float s = alpha * laplace_psi(x.sdf, beta) * x.valid * x.delta;
    const float incl = warp_scan_up(s, lane);
    const float T = expf(-(carry + incl - s));
    const float w = in ? T * (1.f - expf(-s)) : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc_rgb[c] += w * x.rgb[c];
      acc_n[c] += w * x.nrm[c];
    }
    acc_d += w * x.depth;
    acc_w += w;
    carry += __shfl_sync(kFull, incl, kWarp - 1);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc_rgb[c] = warp_sum(acc_rgb[c]);
    acc_n[c] = warp_sum(acc_n[c]);
  }
  acc_d = warp_sum(acc_d);
  acc_w = warp_sum(acc_w);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rgb_out[(long long)c * R + r] = acc_rgb[c];
      normal_out[(long long)c * R + r] = acc_n[c];
    }
    depth_out[r] = acc_d;
    op_out[r] = acc_w;
  }
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
bwd_kernel(const float* __restrict__ sdf, const float* __restrict__ valid,
           const float* __restrict__ delta, const float* __restrict__ rgb,
           const float* __restrict__ depth, const float* __restrict__ normal,
           const float* __restrict__ ab,
           const float* __restrict__ g_rgb, const float* __restrict__ g_depth,
           const float* __restrict__ g_normal, const float* __restrict__ g_op,
           int R, int K,
           float* __restrict__ d_sdf, float* __restrict__ d_delta,
           float* __restrict__ d_rgb, float* __restrict__ d_depth,
           float* __restrict__ d_normal, float* __restrict__ d_ab) {
  __shared__ float chunk_prefix[kWarpsPerBlock][kMaxChunks];
  __shared__ float part[kWarpsPerBlock][2];
  const int lane = threadIdx.x & (kWarp - 1);
  const int wid = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarpsPerBlock + wid;
  const float alpha = ab[0], beta = ab[1];
  const long long plane = (long long)R * K;
  float pa = 0.f, pb = 0.f;  // this lane's d_alpha / d_beta partials
  if (r < R) {
    const int n_chunks = (K + kWarp - 1) / kWarp;
    // pass 1 (forward over chunks): the prefix entering each chunk
    float carry = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int k = c * kWarp + lane;
      const bool in = k < K;
      const long long idx = (long long)r * K + k;
      const float s = in ? alpha * laplace_psi(sdf[idx], beta) * valid[idx] * delta[idx] : 0.f;
      if (lane == 0) chunk_prefix[wid][c] = carry;
      carry += __shfl_sync(kFull, warp_scan_up(s, lane), kWarp - 1);
    }
    __syncwarp();
    float gr[3], gn[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gr[c] = g_rgb[(long long)c * R + r];
      gn[c] = g_normal[(long long)c * R + r];
    }
    const float gd = g_depth[r], go = g_op[r];
    // pass 2 (reverse over chunks): running strict suffix of G*w
    float suffix_carry = 0.f;
    for (int c = n_chunks - 1; c >= 0; --c) {
      const int k = c * kWarp + lane;
      const bool in = k < K;
      const long long idx = (long long)r * K + k;
      Sample x = load_sample(sdf, valid, delta, rgb, depth, normal, idx, plane, in);
      const float expabs = expf(-fabsf(x.sdf) / beta);
      const float psi = x.sdf >= 0.f ? 0.5f * expabs : 1.f - 0.5f * expabs;
      const float sigma = alpha * psi * x.valid;
      const float s = sigma * x.delta;
      const float incl = warp_scan_up(s, lane);
      const float T = expf(-(chunk_prefix[wid][c] + incl - s));
      const float es = expf(-s);
      const float w = in ? T * (1.f - es) : 0.f;
      const float G = gr[0] * x.rgb[0] + gr[1] * x.rgb[1] + gr[2] * x.rgb[2]
                      + gd * x.depth
                      + gn[0] * x.nrm[0] + gn[1] * x.nrm[1] + gn[2] * x.nrm[2]
                      + go;
      const float Gw = G * w;
      const float suf_incl = warp_scan_down(Gw, lane);
      const float dL_ds = G * T * es - (suffix_carry + suf_incl - Gw);
      suffix_carry += __shfl_sync(kFull, suf_incl, 0);
      const float dL_dsigma = dL_ds * x.delta;
      if (in) {
        d_delta[idx] = dL_ds * sigma;
        d_sdf[idx] = dL_dsigma * x.valid * alpha * (-(0.5f / beta)) * expabs;
        d_depth[idx] = gd * w;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          d_rgb[ch * plane + idx] = gr[ch] * w;
          d_normal[ch * plane + idx] = gn[ch] * w;
        }
        pa += dL_dsigma * x.valid * psi;
        pb += dL_dsigma * x.valid * alpha * (0.5f * x.sdf / (beta * beta)) * expabs;
      }
    }
  }
  pa = warp_sum(pa);
  pb = warp_sum(pb);
  if (lane == 0) {
    part[wid][0] = pa;
    part[wid][1] = pb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sa = 0.f, sb = 0.f;
    for (int i = 0; i < kWarpsPerBlock; ++i) {
      sa += part[i][0];
      sb += part[i][1];
    }
    d_ab[2 * blockIdx.x] = sa;
    d_ab[2 * blockIdx.x + 1] = sb;
  }
}

}  // namespace

extern "C" {

int lc_warps_per_block() { return kWarpsPerBlock; }
int lc_max_k() { return kMaxChunks * kWarp; }

// All pointers are device pointers to contiguous float32 buffers:
// sdf/valid/delta/depth [R,K]; rgb/normal [3,R,K]; ab [2] = (alpha, beta);
// outputs rgb_out/normal_out [3,R], depth_out/op_out [R].
int lc_forward(const float* sdf, const float* valid, const float* delta,
               const float* rgb, const float* depth, const float* normal,
               const float* ab, int R, int K, float* rgb_out,
               float* depth_out, float* normal_out, float* op_out,
               void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fwd_kernel<<<blocks, kWarp * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      sdf, valid, delta, rgb, depth, normal, ab, R, K, rgb_out, depth_out,
      normal_out, op_out);
  return (int)cudaGetLastError();
}

// Extra inputs: g_rgb/g_normal [3,R], g_depth/g_op [R]. Outputs
// d_sdf/d_delta/d_depth [R,K], d_rgb/d_normal [3,R,K], and d_ab
// [ceil(R / lc_warps_per_block()), 2] per-block (d_alpha, d_beta) partials.
int lc_backward(const float* sdf, const float* valid, const float* delta,
                const float* rgb, const float* depth, const float* normal,
                const float* ab, const float* g_rgb, const float* g_depth,
                const float* g_normal, const float* g_op, int R, int K,
                float* d_sdf, float* d_delta, float* d_rgb, float* d_depth,
                float* d_normal, float* d_ab, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bwd_kernel<<<blocks, kWarp * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      sdf, valid, delta, rgb, depth, normal, ab, g_rgb, g_depth, g_normal,
      g_op, R, K, d_sdf, d_delta, d_rgb, d_depth, d_normal, d_ab);
  return (int)cudaGetLastError();
}

}  // extern "C"
