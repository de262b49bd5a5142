// Ordered segment sum: the hash grid's table cotangent, summed row by row
// in a fixed order, for Hopper (sm_90a). Built with nvcc into a shared
// library with a plain C interface and called through ctypes
// (fields/hash_scatter.py).
//
// Replaces no TPU kernel. The JAX package scatters the table cotangent in
// XLA, outside any Pallas kernel, and its runs repeat. The port's first
// version used index_add_, whose float atomics on the card add each row's
// contributions in an order that changes from run to run, so card runs
// did not repeat. This kernel adds them in one fixed order: the CPU's.
//
// Computes, for rows r in [0, m) and features f in [0, F):
//   out[r, f] = (((0 + g[i0, f]) + g[i1, f]) + ...)   i0 < i1 < ... the
//               contributions with key[i] == r, in ascending index
// which is the order in which the CPU's index_add_ adds them, so the two
// agree bit for bit. Rows with no contribution are left as the caller
// zeroed them.
//
// Input: the keys sorted by a stable sort (torch.sort(keys, stable=True),
// int32, since m < 2^31) and the permutation that sorts them (int64), so
// each row's contributions form one segment of the sorted keys, in
// ascending original index; the cotangent g [n, F] f32, row-major.
//
// Bound. Bytes: n keys (4 B) and n permutation entries (8 B) read once,
// n*F cotangents (4 B) read once through the permutation, m*F rows
// (4 B) written once; one add per cotangent, far under the card's rate.
// The real limit of this design is latency: one thread sums a whole
// segment, so the kernel lasts as long as its longest segment. On the
// coarse dense levels of the hash grid (17^3 rows at level 0) a row
// collects hundreds to thousands of contributions.
//
// Design (simple first; ROADMAP H2 is the faster one). One thread per
// sorted position; the thread at a segment's start (key differs from its
// left neighbour) sums the segment and writes its row, the others return.
// The segment is walked in batches of kBatch: the batch's keys and
// permutation entries are loaded together, then its cotangents, then
// added one after another up to the first key of another row (keys are
// sorted, so the segment ends there). Loads of a batch overlap; the adds
// stay in order. Keys outside [0, m) are skipped: the port's indices are
// reduced modulo the table size before they get here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 16;

template <int F>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int* __restrict__ keys,
                   const long long* __restrict__ perm,
                   const float* __restrict__ g, long long n, int m,
                   float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  if (i > 0 && keys[i - 1] == key) return;  // not a segment's start
  if (key < 0 || key >= m) return;

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;

  long long j = i;
  bool open = true;
  while (open) {
    int k[kBatch];
    long long p[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long jb = j + b;
      k[b] = jb < n ? keys[jb] : -1;
      p[b] = jb < n ? perm[jb] : 0;
    }
    float v[kBatch][F];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int f = 0; f < F; ++f)
        v[b][f] = k[b] == key ? g[p[b] * F + f] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (k[b] != key) {
        open = false;
        break;
      }
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += v[b][f];
    }
    j += kBatch;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) out[(long long)key * F + f] = acc[f];
}

template <int F>
int launch(const void* keys, const void* perm, const void* g, long long n,
           int m, void* out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  segment_sum_kernel<F><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int*)keys, (const long long*)perm, (const float*)g, n, m,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Features per row that the kernel takes; the wrapper refuses others.
int hs_supports_features(int f) { return f == 1 || f == 2 || f == 4 || f == 8; }

// out[m, f] (zeroed by the caller) += the ordered segment sums of g[n, f]
// over the sorted int32 keys and their int64 permutation. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unsupported f).
int hs_segment_sum(const void* sorted_keys, const void* perm, const void* g,
                   long long n, int f, int m, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (f) {
    case 1: return launch<1>(sorted_keys, perm, g, n, m, out, s);
    case 2: return launch<2>(sorted_keys, perm, g, n, m, out, s);
    case 4: return launch<4>(sorted_keys, perm, g, n, m, out, s);
    case 8: return launch<8>(sorted_keys, perm, g, n, m, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
