// The detector maps' weighted bincount, hand-written for Hopper (sm_90a),
// bit for bit the plain version (ops/bincount.py::bincount_sorted_torch).
//
// Replaces no Pallas kernel: the reference sums each detector map with an
// XLA scatter-add (lightpycl_tpu/tracer/step.py:1478 `.at[flat].add`),
// whose order on the TPU is its own. The port fixes the association so
// that the same inputs give the same bits: a stable sort by bin, then a
// segmented Hillis-Steele scan. Eager torch runs that scan as log2(n)
// passes of five ops each (20 passes over 800,000 slots: ~100 launches of
// a few microseconds a map, each shorter than the host takes to launch it).
//
// What it computes. The scan's association has a closed form. Number the
// slots of one bin's run backwards from its last, q = e - i for i in
// [a, e], L = e - a + 1. The run's sum is the binary tree over q whose
// node (level j, index p) covers q in [p 2^j, (p + 1) 2^j): a node whose
// left child (the higher q, the lower slot) holds a slot of the run is
// left + right; otherwise it is its right child. (Pass s of the scan adds
// the partial ending s slots earlier, from the left, unless the run's
// head lies within s slots: that is the node rule at level log2 s.) So a
// run of L = 13 slots sums as ((B1 + B4) + B8), each B a balanced tree of
// that many slots, the smallest at the run's start. Each * and + stays
// one IEEE operation (-fmad=false; there are only additions here), and
// every addition is written left + right as the scan writes it.
//
// Design. Three launches a call, none of which the host waits for:
//   runs_kernel    one thread a bin: its run [a, a + L) in the sorted keys
//                  by two binary searches; bin b owns the chunk slots
//                  [a / kChunk + b, a' / kChunk + b + 1), a' = a + L (bin
//                  0 also those below, the slots of keys below 0), and
//                  writes its own index into each (`owner`).
//   chunks_kernel  one CTA a chunk slot: the tree over kChunk = 8,192
//                  leaves q in [c kChunk, (c + 1) kChunk) of its bin's run
//                  (a node of the run's tree, aligned at the run's end),
//                  from vals[order[e - q]] through the sort's permutation:
//                  32 leaves a warp shuffle tree, 32 of those a second
//                  shuffle tree, 8 warps a third. A run of one chunk is
//                  written to `out`; longer runs write a partial a chunk.
//                  A slot outside its bin's chunks exits; an empty bin's
//                  first slot writes 0.
//   combine_kernel one CTA for 256 bins: each bin with more than one
//                  chunk sums its partials by the same tree, the node
//                  rule now over chunk indices (in rounds of kChunk
//                  partials, in place, if a run has more).
// A node's leaves are fixed by the run's length alone, so the result does
// not depend on the grid, on timing or on what runs beside it, and no
// float atomic is used. Each column of a (n, W) vals is its own sum.
//
// What bounds it on the card: bytes. Its bound (ops/bincount.py
// `bound_ms`) reads each sorted key and each value once and writes the
// (n_bins, W) sums: at 800,000 slots of float32 with int32 keys ~6.4 MB,
// 1.9 us at 3.35 TB/s. The kernel reads more: the sort's permutation (8
// bytes a slot; 12.8 MB, 3.8 us with it), the keys of its binary searches
// (~2 log2 n per bin, from L2), and through the permutation a 32-byte
// sector for each 4-byte value, from L2 where the values fit (50 MB). The
// three launches' fixed cost is of the same order at these sizes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 32;  // 32-leaf groups a warp
constexpr int kBatch = 8;    // groups whose leaves a warp loads together
constexpr long long kChunk = static_cast<long long>(kWarps) * kGroups * 32;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kGroups == 32, "lane m holds group m's sum");
static_assert(kGroups % kBatch == 0, "whole batches of groups");

// The tree over leaves q in [0, len), 1 <= len <= kChunk, leaf q given by
// load(q); the node rule of the header. Lane l of warp w holds leaf
// (w kGroups + m) 32 + l of group m; a shuffle down by `off` brings the
// left child (the higher q) to the lane of its right one. Valid in thread
// 0; every thread of the CTA must call it.
template <typename T, typename Load>
__device__ T chunk_tree(Load load, long long len, T* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long wbase = static_cast<long long>(warp) * kGroups * 32;
  T mine = T(0);  // lane m: the sum of group m
  for (int m0 = 0; m0 < kGroups; m0 += kBatch) {
    if (wbase + m0 * 32LL >= len) break;  // warp-uniform
    T x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long q = wbase + (m0 + j) * 32LL + lane;
      x[j] = q < len ? load(q) : T(0);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long base = wbase + (m0 + j) * 32LL;
      T v = x[j];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const T left = __shfl_down_sync(kFull, v, off);
        if (base + lane + off < len) v = left + v;
      }
      v = __shfl_sync(kFull, v, 0);
      if (lane == m0 + j) mine = v;
    }
  }
  T v = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T left = __shfl_down_sync(kFull, v, off);
    if (wbase + (lane + off) * 32LL < len) v = left + v;
  }
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  T r = T(0);
  if (warp == 0) {
    r = lane < kWarps ? smem[lane] : T(0);
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const T left = __shfl_down_sync(kFull, r, off);
      if (static_cast<long long>(lane + off) * kGroups * 32 < len) {
        r = left + r;
      }
    }
  }
  __syncthreads();  // smem is free again
  return r;
}

template <typename K>
__device__ long long lower_bound(const K* keys, long long n, long long b) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (static_cast<long long>(keys[mid]) < b) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename K>
__global__ void runs_kernel(const K* __restrict__ keys, long long n,
                            int n_bins, long long slots,
                            long long* __restrict__ runs,
                            int* __restrict__ owner) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_bins) return;
  const long long a = lower_bound(keys, n, b);
  const long long a1 = lower_bound(keys, n, static_cast<long long>(b) + 1);
  runs[2 * b] = a;
  runs[2 * b + 1] = a1 - a;
  const long long s0 = b == 0 ? 0 : a / kChunk + b;
  const long long s1 = b + 1 == n_bins ? slots : a1 / kChunk + b + 1;
  for (long long s = s0; s < s1; ++s) owner[s] = b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunks_kernel(const long long* __restrict__ order, const T* __restrict__ vals,
              int W, const long long* __restrict__ runs,
              const int* __restrict__ owner, T* __restrict__ partial,
              T* __restrict__ out) {
  __shared__ T smem[kWarps];
  const long long g = blockIdx.x;
  const int b = owner[g];
  const long long a = runs[2 * b], L = runs[2 * b + 1];
  const long long c = g - (a / kChunk + b);
  const long long chunks = L == 0 ? 1 : (L + kChunk - 1) / kChunk;
  if (c < 0 || c >= chunks) return;
  T* dst = chunks == 1 ? out + static_cast<long long>(b) * W
                       : partial + g * W;
  if (L == 0) {
    for (int w = threadIdx.x; w < W; w += kThreads) dst[w] = T(0);
    return;
  }
  const long long end = a + L - 1 - c * kChunk;  // the slot of leaf q = 0
  const long long rest = L - c * kChunk;
  const long long len = rest < kChunk ? rest : kChunk;
  for (int w = 0; w < W; ++w) {
    const T r = chunk_tree<T>(
        [=](long long q) { return vals[order[end - q] * W + w]; }, len,
        smem);
    if (threadIdx.x == 0) dst[w] = r;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(int n_bins, int W, const long long* __restrict__ runs,
               T* partial, T* __restrict__ out) {
  __shared__ T smem[kWarps];
  __shared__ int many[kThreads];
  const int b0 = blockIdx.x * kThreads;
  const int mine = b0 + threadIdx.x;
  many[threadIdx.x] = mine < n_bins && runs[2 * mine + 1] > kChunk;
  __syncthreads();
  for (int t = 0; t < kThreads; ++t) {
    if (!many[t]) continue;  // CTA-uniform
    const int b = b0 + t;
    const long long a = runs[2 * b], L = runs[2 * b + 1];
    T* first = partial + (a / kChunk + b) * W;  // chunk 0's partials
    for (int w = 0; w < W; ++w) {
      // rounds: tile u of the m partials left sums into partial u, until
      // one tile, the run's sum, is left
      for (long long m = (L + kChunk - 1) / kChunk;;) {
        const long long tiles = (m + kChunk - 1) / kChunk;
        for (long long u = 0; u < tiles; ++u) {
          const long long rest = m - u * kChunk;
          const T r = chunk_tree<T>(
              [=](long long q) { return first[(u * kChunk + q) * W + w]; },
              rest < kChunk ? rest : kChunk, smem);
          if (threadIdx.x == 0) {
            (tiles == 1 ? out[static_cast<long long>(b) * W + w]
                        : first[u * W + w]) = r;
          }
          __syncthreads();
        }
        if (tiles == 1) break;
        m = tiles;
      }
    }
  }
}

template <typename K, typename T>
cudaError_t launch(const K* keys, const long long* order, const T* vals,
                   long long n, int W, int n_bins, long long* runs,
                   int* owner, T* partial, T* out, cudaStream_t stream) {
  const long long slots = n / kChunk + n_bins;
  const int bin_blocks = (n_bins + kThreads - 1) / kThreads;
  runs_kernel<K><<<bin_blocks, kThreads, 0, stream>>>(keys, n, n_bins, slots,
                                                      runs, owner);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunks_kernel<T><<<static_cast<unsigned>(slots), kThreads, 0, stream>>>(
      order, vals, W, runs, owner, partial, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<T><<<bin_blocks, kThreads, 0, stream>>>(n_bins, W, runs,
                                                         partial, out);
  return cudaGetLastError();
}

template <typename K>
cudaError_t by_value(const K* keys, const long long* order, const void* vals,
                     int val_bytes, long long n, int W, int n_bins,
                     long long* runs, int* owner, void* partial, void* out,
                     cudaStream_t stream) {
  if (val_bytes == 4) {
    return launch(keys, order, static_cast<const float*>(vals), n, W, n_bins,
                  runs, owner, static_cast<float*>(partial),
                  static_cast<float*>(out), stream);
  }
  return launch(keys, order, static_cast<const double*>(vals), n, W, n_bins,
                runs, owner, static_cast<double*>(partial),
                static_cast<double*>(out), stream);
}

}  // namespace

// Chunk slots of a call: its `owner` holds that many ints, its `partial`
// that many rows of W values.
extern "C" long long lpcl_bincount_slots(long long n, int n_bins) {
  return n / kChunk + n_bins;
}

// Weighted bincount of the rows of vals (n, W) at keys sorted ascending
// (int32 or int64, key_bytes 4 or 8; keys outside [0, n_bins) are left
// out), order[i] the row of the i-th sorted key (int64; a stable sort), to
// out (n_bins, W); vals and out float32 or float64 (val_bytes 4 or 8).
// Workspace: runs (n_bins, 2) int64, owner and partial as
// lpcl_bincount_slots says. Launches on `stream`; returns a cudaError_t.
extern "C" int lpcl_bincount_sorted(const void* keys, int key_bytes,
                                    const long long* order, const void* vals,
                                    int val_bytes, long long n, int W,
                                    int n_bins, long long* runs, int* owner,
                                    void* partial, void* out, void* stream) {
  if (n <= 0 || W <= 0 || n_bins <= 0 || n >= (1LL << 40) ||
      (key_bytes != 4 && key_bytes != 8) ||
      (val_bytes != 4 && val_bytes != 8) ||
      n / kChunk + n_bins >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      key_bytes == 4
          ? by_value(static_cast<const int32_t*>(keys), order, vals,
                     val_bytes, n, W, n_bins, runs, owner, partial, out, s)
          : by_value(static_cast<const int64_t*>(keys), order, vals,
                     val_bytes, n, W, n_bins, runs, owner, partial, out, s);
  return static_cast<int>(err);
}
