// K1: fused masked top-k scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scorer_kernel` in ganmf_tpu/ops/pallas_scorer.py,
// launched there by `masked_topk_scores`. For every user row b it computes
// scores = U[b] . V^T in full float32, sets masked items to -inf and returns
// the k best (value descending, ties to the lowest item id). The [B, I] score
// matrix is never written to device memory.
//
// What bounds it on an H100. One evaluation block of the GANMF slice is
// B = 3024 rows, K = 250 factors, I = 3706 items, k = 50: about 5.6 GFLOP of
// scores. TF32 is not allowed (the reference scores at Precision.HIGHEST), so
// the products run as float32 FMAs on the CUDA cores (67 TFLOP/s peak, about
// 0.1 ms). The operands are small (V is 3.7 MB and stays in L2; the mask is
// 11 MB and is read once). What bounds this first version is the top-k merge:
// every item tile is sorted in shared memory before it is merged.
//
// Design. One block of 256 threads owns kRows user rows. Their factors are
// staged in shared memory once. The block walks the items in tiles of 256,
// one item per thread; V's tile passes through shared memory in K-chunks,
// transposed so that the reads are free of bank conflicts. Each thread keeps
// kRows accumulators and adds the K products in order, so exactly duplicated
// item factors give bitwise-equal scores. The tile's scores are then sorted
// per row by a bitonic network on the key (value descending, id ascending),
// and its first k entries are merged with the running top-k by rank: each of
// the 2k candidates finds its output position with one binary search in the
// other list. The TPU kernel carried the running top-k across a sequential
// grid axis and selected by k max/argmax sweeps; here the tile loop runs
// inside the block and the selection is a sort and a merge.
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
constexpr int kMaxK = 64;      // largest k the kernel takes

__device__ __forceinline__ bool ranks_before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

size_t smem_bytes(int K) {
  size_t floats = (size_t)kRows * K + (size_t)kChunk * (kTile + 1);
  size_t pairs = (size_t)kRows * kTile + 2 * (size_t)kRows * kMaxK;  // value + id
  return floats * sizeof(float) + pairs * (sizeof(float) + sizeof(int));
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

  for (int e = tid; e < kRows * K; e += kThreads) {
    const int r = e / K;
    const int row = row0 + r;
    us[e] = row < B ? U[(size_t)row * K + (e - r * K)] : 0.f;
  }
  // the running list starts with -inf entries whose ids lie past every item
  // and differ from each other, so the merge's keys stay distinct
  for (int e = tid; e < kRows * kMaxK; e += kThreads) {
    rv[e] = -INFINITY;
    ri[e] = INT_MAX - (e % kMaxK);
  }

  for (int base = 0; base < I; base += kTile) {
    const int j = base + tid;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

    for (int kc = 0; kc < K; kc += kChunk) {
      const int width = min(kChunk, K - kc);
      __syncthreads();  // the previous slice is consumed (and us is staged)
      for (int e = tid; e < kTile * kChunk; e += kThreads) {
        const int t = e / kChunk;
        const int c = e - t * kChunk;
        const int item = base + t;
        vs[c * (kTile + 1) + t] =
            (item < I && c < width) ? V[(size_t)item * K + kc + c] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < width; ++c) {
        const float v = vs[c * (kTile + 1) + tid];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(us[r * K + kc + c], v, acc[r]);
      }
    }

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

}  // namespace

extern "C" {

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// U [B, K] f32, V [I, K] f32, mask [B, I] bytes (nonzero = exclude), all
// row-major and contiguous; vals [B, k] f32 and ids [B, k] int64 are written.
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

const char* ganmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
