// Ordered scatter-add: the hash grid's table cotangent, summed row by row
// in a fixed order, for Hopper (sm_90a). Built with nvcc into a shared
// library with a plain C interface and called through ctypes
// (fields/hash_scatter.py).
//
// Replaces no TPU kernel. The JAX package scatters the table cotangent in
// XLA, outside any Pallas kernel, and its runs repeat. index_add_ on the
// card adds each row's contributions with float atomics, in an order that
// changes from run to run. These kernels add them in one fixed order: the
// CPU's.
//
// Computes, for rows r in [0, m) and features f in [0, F):
//   out[r, f] = (((0 + g[i0, f]) + g[i1, f]) + ...)   i0 < i1 < ... the
//               contributions with key[i] == r, in ascending index
// which is the order in which the CPU's index_add_ adds them, so the two
// agree bit for bit. Rows with no contribution are 0; keys outside
// [0, m) touch no row.
//
// Design: a stable LSD radix sort of the keys, then a segment sum.
//
// 1. digit_histogram_kernel reads the int64 keys once. Each key outside
//    [0, m) becomes the sentinel m, so the keys take b = bit_length(m)
//    bits (24 for the hash grid's 16 x 2^19 rows) and the sort makes
//    ceil(b / 8) passes of 8-bit digits. It counts every pass's digits in
//    that one read, writes the keys as int32 for the first pass and
//    zeroes the output.
// 2. onesweep_pass_kernel, once a pass (Onesweep: Adinets & Merrill,
//    2022). A block takes a tile of kTile keys with their int32
//    contribution indices (the first pass makes the indices itself),
//    counts the tile's digits with shared atomics and publishes the
//    counts at once, then ranks the keys stably: warp by warp, 32 keys at
//    a time, the lanes of one digit found by one ballot a digit bit, with
//    warp-private digit counters. Tile ids come from an atomic counter in
//    launch order; a tile finds the digit counts of the tiles before it
//    by decoupled look-back, so a pass is one launch that reads and
//    writes 8 B a contribution. The scatter goes through shared memory,
//    so each digit's run of a tile is written contiguously.
// 3. segment_sum_kernel. A warp takes 256 sorted positions, finds the
//    segment starts there by one compare with the left neighbour and a
//    ballot, and stages their cotangents, gathered through the sorted
//    indices, in shared memory. (Writing the cotangents in sorted order
//    in the last pass instead, so that the sum reads them contiguously,
//    measured 0.11 ms slower a call at the hash grid's shape: that
//    pass gathers the cotangents as much at random as the sum does.) Segments that end inside those
//    positions are summed one per lane from shared memory. The last one,
//    which may run on into the next positions (level 0's 17^3 rows hold
//    up to ~3,400 contributions), is summed by the whole warp: its part
//    here from shared memory, then its lanes load 128 positions at once,
//    coalesced, and every lane adds them in index order through a
//    shuffle chain. Only the loads run in parallel; every row's adds stay
//    one chain, left to right.
//
// Bound. The sum needs n keys (8 B) and n * F cotangents (4 B) read once
// and m * F rows (4 B) written once. A sort cannot reach that: each pass
// reads and writes 8 B a contribution, and the segment sum reads the
// sorted keys, indices and cotangents again. On an H100 a pass moves its
// 8 B a contribution at about half the memory rate: its ranking, not its
// bytes, sets its time. The launches are one memset of the look-back
// state, the histogram, one per pass and the sum.
//
// Scratch (the caller's, one int32 buffer of hs_scratch_words words):
// the state (digit counts, tile counters, look-back words) zeroed by the
// memset, and two buffers of keys and of indices (the second holds the
// histogram's int32 keys until pass 0 has read them). Nothing here
// allocates, copies to the host or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kMaxPasses = 4;               // b <= 31 bits
constexpr int kSortWarps = 8;
constexpr int kSortThreads = 32 * kSortWarps;
constexpr int kSortItems = 16;              // keys a thread ranks
constexpr int kTile = kSortThreads * kSortItems;
constexpr int kSortBlocks = 3;              // blocks an SM holds: caps the registers
constexpr int kHistThreads = 256;
constexpr int kSumWarps = 4;
constexpr int kSumThreads = 32 * kSumWarps;
constexpr int kSumItems = 8;
constexpr int kChunk = 32 * kSumItems;      // sorted positions a warp takes
constexpr int kCoop = 4;                    // 32-position loads in flight, long segment
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffffu;    // past the end (keys are <= m < 2^31)
constexpr unsigned kInclusive = 0x80000000u;
constexpr long long kAlign = 32;            // words: 128 B

static_assert(kSortThreads == kRadix, "one thread per digit");

// Look-back words: 0 not ready; count + 1 (< 2^31) this tile's count
// alone; kInclusive | prefix the count of all tiles up to this one.
__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of the warp whose valid key has digit d (a lane's own
// included when it is valid): one ballot a bit of the digit.
__device__ __forceinline__ unsigned match_digit(unsigned d, bool valid) {
  unsigned peers = __ballot_sync(kFull, valid);
#pragma unroll
  for (int b = 0; b < kRadixBits; ++b) {
    const bool one = (d >> b) & 1;
    const unsigned ones = __ballot_sync(kFull, one);
    peers &= one ? ones : ~ones;
  }
  return peers;
}

__device__ __forceinline__ unsigned sentinel_key(long long k, int m) {
  return (k >= 0 && k < m) ? (unsigned)k : (unsigned)m;
}

// Exclusive prefix sum of v over the block's threads in thread order;
// every thread of the block calls it.
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  unsigned base = 0;
  for (int w = 0; w < warp; ++w) base += warp_sums[w];
  __syncthreads();
  return base + x - v;
}

// Every pass's digit counts over all keys, in one read, and the keys as
// int32 (the sentinel m for a key outside [0, m)); zeroes out.
__global__ void __launch_bounds__(kHistThreads)
digit_histogram_kernel(const long long* __restrict__ gi, long long n, int m,
                       int passes, unsigned* __restrict__ counts,
                       unsigned* __restrict__ keys, float* __restrict__ out,
                       long long out_len) {
  __shared__ unsigned hist[kMaxPasses][kRadix];
  for (int i = threadIdx.x; i < kMaxPasses * kRadix; i += kHistThreads)
    (&hist[0][0])[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kHistThreads;
  const long long first = (long long)blockIdx.x * kHistThreads + threadIdx.x;
  for (long long i = first; i < n; i += 4 * stride) {
    unsigned k[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = i + u * stride;
      k[u] = j < n ? sentinel_key(gi[j], m) : kNoKey;
      if (j < n) keys[j] = k[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k[u] == kNoKey) continue;
      for (int p = 0; p < passes; ++p)
        atomicAdd(&hist[p][(k[u] >> (p * kRadixBits)) & (kRadix - 1)], 1u);
    }
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const unsigned c = hist[p][threadIdx.x];
    if (c) atomicAdd(&counts[p * kRadix + threadIdx.x], c);
  }
  for (long long i = first; i < out_len; i += stride) out[i] = 0.0f;
}

// One pass of the stable sort over the digit at `shift`. FIRST: the
// indices are made here.
template <bool FIRST>
__global__ void __launch_bounds__(kSortThreads, kSortBlocks)
onesweep_pass_kernel(const unsigned* __restrict__ keys_in, const int* __restrict__ idx_in,
                     unsigned* __restrict__ keys_out, int* __restrict__ idx_out,
                     long long n, int shift,
                     const unsigned* __restrict__ counts, unsigned* lookback,
                     unsigned* tile_counter) {
  __shared__ unsigned warp_hist[kSortWarps][kRadix];
  __shared__ unsigned tile_hist[kRadix];
  __shared__ unsigned stage_keys[kTile];
  __shared__ int stage_idx[kTile];
  __shared__ unsigned digit_base[kRadix];
  __shared__ unsigned local_start[kRadix];
  __shared__ unsigned warp_sums[kSortWarps];
  __shared__ unsigned tile_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, d = tid;
  for (int i = lane; i < kRadix; i += 32) warp_hist[warp][i] = 0;
  tile_hist[d] = 0;
  if (tid == 0) tile_s = atomicAdd(tile_counter, 1u);
  __syncthreads();
  const unsigned tile = tile_s;
  const long long tile_start = (long long)tile * kTile;
  const long long warp_start = tile_start + warp * (32 * kSortItems);

  unsigned key[kSortItems];
  int payload[kSortItems];
#pragma unroll
  for (int it = 0; it < kSortItems; ++it) {
    const long long e = warp_start + it * 32 + lane;
    key[it] = kNoKey;
    payload[it] = 0;
    if (e < n) {
      key[it] = keys_in[e];
      if constexpr (FIRST) payload[it] = (int)e;
      else payload[it] = idx_in[e];
    }
  }

  // The tile's digit counts first, published for the tiles after it, so
  // that their look-back overlaps this tile's ranking.
#pragma unroll
  for (int it = 0; it < kSortItems; ++it)
    if (key[it] != kNoKey) atomicAdd(&tile_hist[(key[it] >> shift) & (kRadix - 1)], 1u);
  __syncthreads();
  const unsigned count = tile_hist[d];
  unsigned* mine = lookback + (long long)tile * kRadix + d;
  store_relaxed(mine, tile == 0 ? (kInclusive | count) : count + 1);

  // Rank within the warp, in element order: 32 keys at a time, lanes
  // holding one digit counted together.
  unsigned pos[kSortItems];
#pragma unroll
  for (int it = 0; it < kSortItems; ++it) {
    const bool valid = key[it] != kNoKey;
    const unsigned d = (key[it] >> shift) & (kRadix - 1);
    const unsigned peers = match_digit(d, valid);
    unsigned before = 0;
    if (valid) before = warp_hist[warp][d];
    __syncwarp();
    if (valid && lane == 31 - __clz(peers)) warp_hist[warp][d] = before + __popc(peers);
    __syncwarp();
    pos[it] = before + __popc(peers & lanemask_lt());
  }
  __syncthreads();

  // Thread d: the warps' offsets within digit d.
  unsigned below = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const unsigned c = warp_hist[w][d];
    warp_hist[w][d] = below;
    below += c;
  }
  const unsigned local = block_exclusive_scan(count, warp_sums);
  const unsigned global = block_exclusive_scan(counts[d], warp_sums);
  // Look back over the tiles before this one, adding counts up to the
  // first inclusive word.
  unsigned prefix = 0;
  for (long long t = (long long)tile - 1; t >= 0; --t) {
    unsigned v;
    do { v = load_relaxed(lookback + t * kRadix + d); } while (v == 0);
    if (v & kInclusive) {
      prefix += v & ~kInclusive;
      break;
    }
    prefix += v - 1;
  }
  if (tile > 0) store_relaxed(mine, kInclusive | (prefix + count));
  local_start[d] = local;
  digit_base[d] = global + prefix - local;   // + the tile-local position
  __syncthreads();

#pragma unroll
  for (int it = 0; it < kSortItems; ++it) {
    if (key[it] != kNoKey) {
      const unsigned dd = (key[it] >> shift) & (kRadix - 1);
      const unsigned at = pos[it] + local_start[dd] + warp_hist[warp][dd];
      stage_keys[at] = key[it];
      stage_idx[at] = payload[it];
    }
  }
  __syncthreads();
  const long long rest = n - tile_start;
  const int in_tile = rest < kTile ? (int)rest : kTile;
#pragma unroll 4
  for (int j = tid; j < in_tile; j += kSortThreads) {
    const unsigned k = stage_keys[j];
    const int p = stage_idx[j];
    const unsigned at = digit_base[(k >> shift) & (kRadix - 1)] + j;
    keys_out[at] = k;
    idx_out[at] = p;
  }
}

// Row sums of the sorted keys' segments: row i of g is the cotangent of
// contribution i and idx[p] the contribution at sorted position p.
template <int F>
__global__ void __launch_bounds__(kSumThreads)
segment_sum_kernel(const unsigned* __restrict__ keys, const int* __restrict__ idx,
                   const float* __restrict__ g, long long n, int m,
                   float* __restrict__ out) {
  __shared__ float vals[kSumWarps][F][kChunk];
  __shared__ unsigned chunk_keys[kSumWarps][kChunk];
  __shared__ int starts[kSumWarps][kChunk + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c0 = ((long long)blockIdx.x * kSumWarps + warp) * kChunk;
  if (c0 >= n) return;
  const int len = n - c0 < kChunk ? (int)(n - c0) : kChunk;

  unsigned k[kSumItems];
  bool start[kSumItems];
  long long r[kSumItems];
#pragma unroll
  for (int it = 0; it < kSumItems; ++it) {
    const int q = it * 32 + lane;
    const long long p = c0 + q;
    k[it] = q < len ? keys[p] : kNoKey;
    start[it] = q < len && (p == 0 || keys[p - 1] != k[it]);
    r[it] = q < len ? (long long)idx[p] : -1;
  }
  float v[kSumItems][F];
#pragma unroll
  for (int it = 0; it < kSumItems; ++it)
#pragma unroll
    for (int f = 0; f < F; ++f) v[it][f] = r[it] >= 0 ? g[r[it] * F + f] : 0.0f;

  int n_starts = 0;
#pragma unroll
  for (int it = 0; it < kSumItems; ++it) {
    const int q = it * 32 + lane;
    const unsigned b = __ballot_sync(kFull, start[it]);
    if (start[it]) starts[warp][n_starts + __popc(b & lanemask_lt())] = q;
    n_starts += __popc(b);
    chunk_keys[warp][q] = k[it];
#pragma unroll
    for (int f = 0; f < F; ++f) vals[warp][f][q] = v[it][f];
  }
  if (lane == 0) starts[warp][n_starts] = len;
  __syncwarp();
  if (n_starts == 0) return;

  // Segments that end inside the chunk: one lane each, in order.
  for (int j = lane; j < n_starts - 1; j += 32) {
    const int s = starts[warp][j], e = starts[warp][j + 1];
    const unsigned kj = chunk_keys[warp][s];
    if (kj >= (unsigned)m) continue;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
    for (int q = s; q < e; ++q)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += vals[warp][f][q];
#pragma unroll
    for (int f = 0; f < F; ++f) out[(long long)kj * F + f] = acc[f];
  }
  // The chunk's last segment, which may run on into the next chunks: the
  // whole warp adds its part in this chunk (every lane the same chain),
  // then loads 32 x kCoop positions at once and adds them in order
  // through a shuffle chain until the key changes.
  const int last = starts[warp][n_starts - 1];
  const unsigned key = chunk_keys[warp][last];
  if (key >= (unsigned)m) return;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  for (int q = last; q < len; ++q)
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += vals[warp][f][q];
  for (long long base = c0 + len;; base += 32 * kCoop) {
    unsigned kk[kCoop];
    long long rr[kCoop];
#pragma unroll
    for (int c = 0; c < kCoop; ++c) {
      const long long p = base + c * 32 + lane;
      kk[c] = p < n ? keys[p] : kNoKey;
      rr[c] = p < n ? (long long)idx[p] : 0;
    }
    float vv[kCoop][F];
#pragma unroll
    for (int c = 0; c < kCoop; ++c)
#pragma unroll
      for (int f = 0; f < F; ++f) vv[c][f] = kk[c] == key ? g[rr[c] * F + f] : 0.0f;
    bool open = true;
#pragma unroll
    for (int c = 0; c < kCoop; ++c) {
      if (!open) continue;
      // keys are sorted: the lanes still in the segment are a prefix
      const int live = __popc(__ballot_sync(kFull, kk[c] == key));
      for (int l = 0; l < live; ++l)
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += __shfl_sync(kFull, vv[c][f], l);
      open = live == 32;
    }
    if (!open) break;
  }
  if (lane == 0)
#pragma unroll
    for (int f = 0; f < F; ++f) out[(long long)key * F + f] = acc[f];
}

int passes_for(int m) {
  int bits = 0;
  while (bits < 31 && (m >> bits) != 0) ++bits;   // bit_length(m): keys and the sentinel m
  const int p = (bits + kRadixBits - 1) / kRadixBits;
  return p < 1 ? 1 : p;
}

long long round_up(long long x) { return (x + kAlign - 1) / kAlign * kAlign; }

long long state_words(long long n, int m) {
  const long long tiles = (n + kTile - 1) / kTile;
  const int p = passes_for(m);
  return p * kRadix + kAlign + (long long)p * tiles * kRadix;
}

template <int F>
cudaError_t launch_sum(long long n, cudaStream_t s, const unsigned* keys, const int* idx,
                       const float* g, int m, float* out) {
  const long long blocks = (n + kSumWarps * kChunk - 1) / (kSumWarps * kChunk);
  segment_sum_kernel<F><<<(unsigned)blocks, kSumThreads, 0, s>>>(keys, idx, g, n, m, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Features per row that the kernels take; the wrapper refuses others.
int hs_supports_features(int f) { return f == 1 || f == 2 || f == 4 || f == 8; }

// Keys a block of a sort pass takes (its tile).
int hs_sort_tile(void) { return kTile; }

// int32 words of scratch hs_ordered_scatter needs.
long long hs_scratch_words(long long n, int m) {
  return round_up(state_words(n, m)) + 4 * round_up(n);
}

// out[m, f] = the ordered row sums of g[n, f] (f32) over the int64 keys
// gi[n]: the memset of the state, the histogram, the sort passes and the
// sum, on `stream`. Returns the first cudaError_t of the launches
// (cudaErrorInvalidValue for an unsupported f).
int hs_ordered_scatter(const void* gi, const void* g, long long n, int f, int m,
                       void* out, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!hs_supports_features(f) || n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  cudaError_t st;
  if (n == 0) {
    st = cudaMemsetAsync(out, 0, (size_t)m * f * sizeof(float), s);
    return (int)st;
  }
  const int passes = passes_for(m);
  const unsigned tiles = (unsigned)((n + kTile - 1) / kTile);
  const long long stride = round_up(n);
  unsigned* base = static_cast<unsigned*>(scratch);
  unsigned* counts = base;
  unsigned* tile_counters = counts + passes * kRadix;
  unsigned* lookback = tile_counters + kAlign;
  unsigned* bufs = base + round_up(state_words(n, m));
  unsigned* keys[2] = {bufs, bufs + stride};
  int* idx[2] = {reinterpret_cast<int*>(bufs + 2 * stride),
                 reinterpret_cast<int*>(bufs + 3 * stride)};

  st = cudaMemsetAsync(base, 0, (size_t)state_words(n, m) * sizeof(unsigned), s);
  if (st != cudaSuccess) return (int)st;
  const long long work = n > (long long)m * f ? n : (long long)m * f;
  const long long want = (work + 4LL * kHistThreads - 1) / (4LL * kHistThreads);
  const int hist_blocks = (int)(want < 1024 ? want : 1024);
  digit_histogram_kernel<<<hist_blocks, kHistThreads, 0, s>>>(
      static_cast<const long long*>(gi), n, m, passes, counts, keys[1],
      static_cast<float*>(out), (long long)m * f);
  st = cudaGetLastError();
  if (st != cudaSuccess) return (int)st;

  for (int p = 0; p < passes; ++p) {
    const int o = p & 1;
    unsigned* lb = lookback + (long long)p * tiles * kRadix;
    // pass 0 reads the histogram's int32 keys from keys[1]
    if (p == 0)
      onesweep_pass_kernel<true><<<tiles, kSortThreads, 0, s>>>(
          keys[1], nullptr, keys[0], idx[0], n, 0, counts, lb, tile_counters);
    else
      onesweep_pass_kernel<false><<<tiles, kSortThreads, 0, s>>>(
          keys[o ^ 1], idx[o ^ 1], keys[o], idx[o], n, p * kRadixBits,
          counts + p * kRadix, lb, tile_counters + p);
    st = cudaGetLastError();
    if (st != cudaSuccess) return (int)st;
  }

  const int o = (passes - 1) & 1;
  const float* gf = static_cast<const float*>(g);
  float* o_ptr = static_cast<float*>(out);
  switch (f) {
    case 1: st = launch_sum<1>(n, s, keys[o], idx[o], gf, m, o_ptr); break;
    case 2: st = launch_sum<2>(n, s, keys[o], idx[o], gf, m, o_ptr); break;
    case 4: st = launch_sum<4>(n, s, keys[o], idx[o], gf, m, o_ptr); break;
    default: st = launch_sum<8>(n, s, keys[o], idx[o], gf, m, o_ptr); break;
  }
  return (int)st;
}

}  // extern "C"
