// K1: masked top-k scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scorer_kernel` in ganmf_tpu/ops/pallas_scorer.py,
// launched there by `masked_topk_scores`. For every user row b it computes
// scores = U[b] . V^T in full float32, sets masked items to -inf and returns
// the k best (value descending, ties to the lowest item id). It takes any
// k in [1, I], by one of two launches chosen from k:
//
// - k <= kMaxK (every ranking cutoff of the evaluation): the fused kernel.
//   The [B, I] score matrix is never written to device memory.
// - k > kMaxK (`recommend`'s default cutoff is I - 1): the wide pair. The
//   first kernel writes every score of a chunk of rows as a 64-bit sort key,
//   the second sorts each row's keys and writes its first k.
//
// Both compute every score the same way, so they agree bitwise on it.
//
// What bounds it on an H100. One evaluation block of the GANMF slice is
// B = 3024 rows, K = 250 factors, I = 3706 items, k = 50: about 5.6 GFLOP of
// scores. TF32 is not allowed (the reference scores at Precision.HIGHEST), so
// the products run as float32 FMAs on the CUDA cores (67 TFLOP/s peak, about
// 0.1 ms). The operands are small (V is 3.7 MB and stays in L2; the mask is
// 11 MB and is read once). What bounds the fused kernel is its top-k merge:
// every item tile is sorted in shared memory before it is merged. The wide
// pair is bound by its sort: log2(N) * (log2(N) + 1) / 2 compare-and-swap
// stages over the row's N = next_pow2(I) keys, in shared memory where a
// stage stays inside an 8192-key chunk and in global memory (L2) otherwise.
//
// Design of the scores. One block of 256 threads owns kRows user rows. Their
// factors are staged in shared memory once. The block walks the items in
// tiles of 256, one item per thread; V's tile passes through shared memory in
// K-chunks, transposed so that the reads are free of bank conflicts. Each
// thread keeps kRows accumulators and adds the K products in order, so
// exactly duplicated item factors give bitwise-equal scores.
//
// Fused kernel. The tile's scores are sorted per row by a bitonic network on
// the key (value descending, id ascending), and its first k entries are
// merged with the running top-k by rank: each of the 2k candidates finds its
// output position with one binary search in the other list. The TPU kernel
// carried the running top-k across a sequential grid axis and selected by k
// max/argmax sweeps; here the tile loop runs inside the block and the
// selection is a sort and a merge.
//
// Wide pair. The key of item j is (~monotone(score) << 32) | j, where
// monotone() is the order-preserving map of a float onto uint32 (with -0.0
// read as +0.0), so ascending keys are value descending, ties to the lowest
// id, and every key is distinct. Pad columns j in [I, N) hold the largest
// key. One block of 1024 threads sorts one row by a bitonic network: the
// stages whose pairs lie inside an aligned chunk of 8192 keys run on the
// chunk in shared memory (64 KB), the others on the row in global memory.
// The row's scratch is 8 N bytes; the wrapper sizes the chunk of rows.
//
// Semantics kept from the reference: ties go to the lowest item id; a masked
// item (-inf) never precedes an unmasked one; a row with fewer than k unmasked
// items returns -inf in its tail, with ids that are real items (k <= I).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // one item per thread in a tile
constexpr int kTile = 256;     // items per tile; a power of two for the sort
constexpr int kRows = 8;       // user rows per block
constexpr int kChunk = 16;     // K-slice of V staged per step
constexpr int kMaxK = 64;      // largest k of the fused kernel

constexpr int kSortThreads = 1024;
constexpr int kSortChunk = 8192;  // keys of one shared-memory sort chunk

__device__ __forceinline__ bool ranks_before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

size_t score_smem_bytes(int K) {
  return ((size_t)kRows * K + (size_t)kChunk * (kTile + 1)) * sizeof(float);
}

size_t smem_bytes(int K) {
  size_t pairs = (size_t)kRows * kTile + 2 * (size_t)kRows * kMaxK;  // value + id
  return score_smem_bytes(K) + pairs * (sizeof(float) + sizeof(int));
}

// Stages the block's kRows user rows in `us` (zeros past B). The first
// barrier of score_tile orders these writes before any read.
__device__ __forceinline__ void stage_users(float* us, const float* __restrict__ U, int row0,
                                            int B, int K, int tid) {
  for (int e = tid; e < kRows * K; e += kThreads) {
    const int r = e / K;
    const int row = row0 + r;
    us[e] = row < B ? U[(size_t)row * K + (e - r * K)] : 0.f;
  }
}

// acc[r] = U[row0 + r] . V[base + tid], summed in K order; zero past I.
__device__ __forceinline__ void score_tile(const float* us, float* vs,
                                           const float* __restrict__ V, int base, int I, int K,
                                           int tid, float (&acc)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int kc = 0; kc < K; kc += kChunk) {
    const int width = min(kChunk, K - kc);
    __syncthreads();  // the previous slice is consumed (and us is staged)
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int t = e / kChunk;
      const int c = e - t * kChunk;
      const int item = base + t;
      vs[c * (kTile + 1) + t] = (item < I && c < width) ? V[(size_t)item * K + kc + c] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < width; ++c) {
      const float v = vs[c * (kTile + 1) + tid];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(us[r * K + kc + c], v, acc[r]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
masked_topk_kernel(const float* __restrict__ U, const float* __restrict__ V,
                   const uint8_t* __restrict__ mask, float* __restrict__ out_vals,
                   int64_t* __restrict__ out_ids, int B, int I, int K, int k) {
  extern __shared__ float smem[];
  float* us = smem;                                // [kRows][K] user factors
  float* vs = us + (size_t)kRows * K;              // [kChunk][kTile + 1] V slice
  float* tv = vs + kChunk * (kTile + 1);           // [kRows][kTile] tile scores
  int* ti = reinterpret_cast<int*>(tv + kRows * kTile);      // tile ids
  float* rv = reinterpret_cast<float*>(ti + kRows * kTile);  // [kRows][kMaxK] running top-k
  int* ri = reinterpret_cast<int*>(rv + kRows * kMaxK);
  float* nv = reinterpret_cast<float*>(ri + kRows * kMaxK);  // merge output
  int* ni = reinterpret_cast<int*>(nv + kRows * kMaxK);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;

  stage_users(us, U, row0, B, K, tid);
  // the running list starts with -inf entries whose ids lie past every item
  // and differ from each other, so the merge's keys stay distinct
  for (int e = tid; e < kRows * kMaxK; e += kThreads) {
    rv[e] = -INFINITY;
    ri[e] = INT_MAX - (e % kMaxK);
  }

  for (int base = 0; base < I; base += kTile) {
    const int j = base + tid;
    float acc[kRows];
    score_tile(us, vs, V, base, I, K, tid, acc);

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      float s = -INFINITY;
      if (j < I && row < B && mask[(size_t)row * I + j] == 0) s = acc[r];
      tv[r * kTile + tid] = s;
      ti[r * kTile + tid] = j;  // j >= I is a pad column: after every real item on ties
    }
    __syncthreads();

    // bitonic sort of each row's tile, best first
    for (int size = 2; size <= kTile; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int p = tid; p < kRows * (kTile / 2); p += kThreads) {
          const int r = p / (kTile / 2);
          const int q = p - r * (kTile / 2);
          const int lo = 2 * q - (q & (stride - 1));
          const int hi = lo + stride;
          float* v = tv + r * kTile;
          int* id = ti + r * kTile;
          const float a = v[lo], b = v[hi];
          const int ia = id[lo], ib = id[hi];
          const bool best_first = (lo & size) == 0;
          if (best_first ? ranks_before(b, ib, a, ia) : ranks_before(a, ia, b, ib)) {
            v[lo] = b;
            v[hi] = a;
            id[lo] = ib;
            id[hi] = ia;
          }
        }
        __syncthreads();
      }
    }

    // merge the running top-k with the tile's first k by rank
    for (int e = tid; e < kRows * 2 * k; e += kThreads) {
      const int r = e / (2 * k);
      const int x = e - r * 2 * k;
      const float* av = rv + r * kMaxK;
      const int* ai = ri + r * kMaxK;
      const float* bv = tv + r * kTile;
      const int* bi = ti + r * kTile;
      float val;
      int id, pos;
      int lo = 0, hi = k;
      if (x < k) {  // from the running list: count tile entries strictly before it
        val = av[x];
        id = ai[x];
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ranks_before(bv[mid], bi[mid], val, id)) lo = mid + 1; else hi = mid;
        }
        pos = x + lo;
      } else {  // from the tile: count running entries before or equal to it
        const int y = x - k;
        val = bv[y];
        id = bi[y];
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (!ranks_before(val, id, av[mid], ai[mid])) lo = mid + 1; else hi = mid;
        }
        pos = y + lo;
      }
      if (pos < k) {
        nv[r * kMaxK + pos] = val;
        ni[r * kMaxK + pos] = id;
      }
    }
    __syncthreads();
    for (int e = tid; e < kRows * k; e += kThreads) {
      const int r = e / k;
      const int x = e - r * k;
      rv[r * kMaxK + x] = nv[r * kMaxK + x];
      ri[r * kMaxK + x] = ni[r * kMaxK + x];
    }
    // the next tile's first __syncthreads orders these writes before any read
  }
  __syncthreads();

  for (int e = tid; e < kRows * k; e += kThreads) {
    const int r = e / k;
    const int x = e - r * k;
    const int row = row0 + r;
    if (row < B) {
      out_vals[(size_t)row * k + x] = rv[r * kMaxK + x];
      out_ids[(size_t)row * k + x] = ri[r * kMaxK + x];
    }
  }
}

// -- wide pair (k > kMaxK) ---------------------------------------------------

// Ascending order of the key = score descending, then id ascending.
__device__ __forceinline__ uint64_t rank_key(float s, int j) {
  const uint32_t b = __float_as_uint(s == 0.f ? 0.f : s);  // -0.0 ranks as +0.0
  const uint32_t m = (b >> 31) ? ~b : (b | 0x80000000u);   // monotone in s
  return ((uint64_t)(~m) << 32) | (uint32_t)j;
}

__device__ __forceinline__ float key_score(uint64_t key) {
  const uint32_t m = ~(uint32_t)(key >> 32);
  return __uint_as_float((m >> 31) ? (m & 0x7fffffffu) : ~m);
}

// keys[r][j] = rank_key of row r's masked score of item j, for j < I, and
// the largest key for the pad columns j in [I, N). No state crosses item
// tiles, so blockIdx.y spreads the tiles over blocks: a handful of rows
// (recommend's batch) still fills the card.
__global__ void __launch_bounds__(kThreads)
masked_keys_kernel(const float* __restrict__ U, const float* __restrict__ V,
                   const uint8_t* __restrict__ mask, uint64_t* __restrict__ keys, int B, int I,
                   int K, int N) {
  extern __shared__ float smem[];
  float* us = smem;                    // [kRows][K] user factors
  float* vs = us + (size_t)kRows * K;  // [kChunk][kTile + 1] V slice

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;

  stage_users(us, U, row0, B, K, tid);
  for (int base = blockIdx.y * kTile; base < I; base += gridDim.y * kTile) {
    const int j = base + tid;
    float acc[kRows];
    score_tile(us, vs, V, base, I, K, tid, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (j < I && row < B) {
        const float s = mask[(size_t)row * I + j] == 0 ? acc[r] : -INFINITY;
        keys[(size_t)row * N + j] = rank_key(s, j);
      }
    }
  }
  const int pad = N - I;
  for (int e = blockIdx.y * kThreads + tid; e < kRows * pad; e += gridDim.y * kThreads) {
    const int r = e / pad;
    const int row = row0 + r;
    if (row < B) keys[(size_t)row * N + I + (e - r * pad)] = ~0ull;
  }
}

// One bitonic stage on `keys` (n keys; `offset` is their index in the row):
// pairs (lo, lo + stride), ascending where bit `size` of the row index is 0.
__device__ __forceinline__ void bitonic_stage(uint64_t* keys, int n, int offset, int size,
                                              int stride, int tid) {
  for (int q = tid; q < n / 2; q += kSortThreads) {
    const int lo = 2 * q - (q & (stride - 1));
    const int hi = lo + stride;
    const uint64_t a = keys[lo], b = keys[hi];
    if ((a > b) == (((offset + lo) & size) == 0)) {
      keys[lo] = b;
      keys[hi] = a;
    }
  }
}

// Bitonic stages of sizes size_from..size_to (strides below the chunk) on
// each aligned chunk of CH keys of the row, in shared memory: a stage whose
// stride is below CH pairs keys of one chunk.
__device__ __forceinline__ void chunk_stages(uint64_t* row, uint64_t* chunk, int N, int CH,
                                             int size_from, int size_to, int tid) {
  for (int c0 = 0; c0 < N; c0 += CH) {
    for (int e = tid; e < CH; e += kSortThreads) chunk[e] = row[c0 + e];
    __syncthreads();
    for (int size = size_from; size <= size_to; size <<= 1) {
      for (int stride = min(size, CH) >> 1; stride > 0; stride >>= 1) {
        bitonic_stage(chunk, CH, c0, size, stride, tid);
        __syncthreads();
      }
    }
    for (int e = tid; e < CH; e += kSortThreads) row[c0 + e] = chunk[e];
    __syncthreads();
  }
}

// Sorts each row of keys [B, N] ascending (N a power of two) and writes its
// first k as (score, id).
__global__ void __launch_bounds__(kSortThreads)
sort_rows_kernel(uint64_t* __restrict__ keys, float* __restrict__ out_vals,
                 int64_t* __restrict__ out_ids, int N, int k) {
  extern __shared__ uint64_t chunk[];
  const int tid = threadIdx.x;
  uint64_t* row = keys + (size_t)blockIdx.x * N;
  const int CH = min(N, kSortChunk);

  chunk_stages(row, chunk, N, CH, 2, CH, tid);  // every chunk sorted, alternating direction
  for (int size = 2 * CH; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride >= CH; stride >>= 1) {  // pairs span chunks
      bitonic_stage(row, N, 0, size, stride, tid);
      __syncthreads();
    }
    chunk_stages(row, chunk, N, CH, size, size, tid);
  }

  for (int x = tid; x < k; x += kSortThreads) {
    const uint64_t key = row[x];
    out_vals[(size_t)blockIdx.x * k + x] = key_score(key);
    out_ids[(size_t)blockIdx.x * k + x] = (int64_t)(uint32_t)key;
  }
}

}  // namespace

extern "C" {

// Launches K1's fused kernel (k <= 64) on `stream` and returns
// cudaGetLastError() (0 on success). U [B, K] f32, V [I, K] f32, mask [B, I]
// bytes (nonzero = exclude), all row-major and contiguous; vals [B, k] f32
// and ids [B, k] int64 are written.
int ganmf_masked_topk(const void* U, const void* V, const void* mask, void* vals, void* ids,
                      int B, int I, int K, int k, void* stream) {
  if (B <= 0 || I <= 0 || K <= 0 || k <= 0 || k > kMaxK || k > I) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      masked_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  masked_topk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(U), static_cast<const float*>(V),
      static_cast<const uint8_t*>(mask), static_cast<float*>(vals),
      static_cast<int64_t*>(ids), B, I, K, k);
  return (int)cudaGetLastError();
}

// Launches K1's wide pair (any k in [1, I]) on `stream`, `chunk_rows` rows at
// a time, and returns the first CUDA error (0 on success). Arguments as for
// ganmf_masked_topk, plus scratch [chunk_rows, N] uint64 with N the smallest
// power of two >= I.
int ganmf_masked_topk_wide(const void* U, const void* V, const void* mask, void* vals,
                           void* ids, void* scratch, int B, int I, int K, int k, int N,
                           int chunk_rows, void* stream) {
  if (B <= 0 || I <= 0 || K <= 0 || k <= 0 || k > I || N < I || (N & (N - 1)) != 0 ||
      chunk_rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t key_smem = score_smem_bytes(K);
  const size_t sort_smem = (size_t)min(N, kSortChunk) * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      masked_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)key_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      sort_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sort_smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* keys = static_cast<uint64_t*>(scratch);
  const int tiles = min((I + kTile - 1) / kTile, 65535);
  for (int r0 = 0; r0 < B; r0 += chunk_rows) {
    const int rows = min(chunk_rows, B - r0);
    const dim3 key_grid((rows + kRows - 1) / kRows, tiles);
    masked_keys_kernel<<<key_grid, kThreads, key_smem, s>>>(
        static_cast<const float*>(U) + (size_t)r0 * K, static_cast<const float*>(V),
        static_cast<const uint8_t*>(mask) + (size_t)r0 * I, keys, rows, I, K, N);
    sort_rows_kernel<<<rows, kSortThreads, sort_smem, s>>>(
        keys, static_cast<float*>(vals) + (size_t)r0 * k,
        static_cast<int64_t*>(ids) + (size_t)r0 * k, N, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* ganmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
