// K1: masked top-k scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scorer_kernel` in ganmf_tpu/ops/pallas_scorer.py,
// launched there by `masked_topk_scores`. For every user row b it computes
// scores = U[b] . V^T in full float32, sets masked items to -inf and returns
// the k best (value descending, ties to the lowest item id). It takes any
// k in [1, I], by one of two launches chosen from k:
//
// - k <= kMaxK (every ranking cutoff of the evaluation): the fused kernel,
//   then, when the items were split over blocks, a small merge pass. The
//   [B, I] score matrix is never written to device memory.
// - k > kMaxK (`recommend`'s default cutoff is I - 1): the wide pair. The
//   first kernel writes every score of a chunk of rows as a 64-bit sort key,
//   the second sorts each row's keys and writes its first k.
//
// Every score, in both forms, is one chain fmaf(U[b][c], V[j][c], acc) over
// c = 0..K-1 from acc = 0.f, so exactly duplicated item factors tie bitwise
// and the two forms agree bitwise on every score.
//
// The key. Selection compares 64-bit keys (~monotone(score) << 32) | id,
// where monotone() is the order-preserving map of a float onto uint32 (with
// -0.0 read as +0.0): ascending keys are value descending, ties to the lowest
// id, and two real items never share a key. A masked item's key holds -inf.
//
// What bounds the fused kernel on an H100. One evaluation block of the GANMF
// slice is B = 3024 rows, K = 250 factors, I = 3706 items, k = 50: 5.60 GFLOP
// of scores. TF32 is not allowed (the reference scores at Precision.HIGHEST),
// so the products run as float32 FMAs on the CUDA cores: 67 TFLOP/s, a bound
// of 0.0836 ms. Its bytes (U, V, the mask, the lists: 19.7 MB) take 5.9 us at
// 3.35 TB/s. So the bound is compute on the f32 CUDA cores. The design:
//
// 1. Register-tiled scoring. A block of 256 threads owns kBM = 64 rows and
//    walks item tiles of kBN = 128. Each thread holds a 4 x 8 micro-tile of
//    accumulators (4 rows x 8 items). U's and V's K-slices sit in shared
//    memory factor-major, so one factor step reads one float4 of U (a
//    broadcast) and two of V (two wavefronts each) and feeds 32 FMAs.
// 2. Overlapped loads. K-slices of kBK = 16 factors stream through a ring of
//    kStages = 3 stages filled by cp.async, with one barrier per slice: two
//    slices are in flight while one is multiplied, across tile boundaries.
// 3. Selection by threshold, warp by warp. Each row keeps its running top-k
//    as sorted keys in shared memory. A split's first tile is sorted per row
//    in registers (a bitonic network over the row's half-warp, by shuffles)
//    and its first k become the running list. In a later tile a score that
//    ranks before the row's k-th running key (value first, then id) is
//    appended to the row's candidate buffer of kCap keys (prefix sums over
//    the half-warp, no atomics); every other score is dropped by that one
//    compare. Each warp then merges its rows' candidates into their lists by
//    rank (kCap at a time). No block barrier is involved: a first version
//    that bitonic-sorted whole buffers block-wide on overflow spent more
//    time in those barriers and sorts than in scoring. Pad items of a first
//    tile take start keys (-inf, with distinct ids past every item and every
//    other split's), so masked items stay admissible until k real items are
//    in (rows with fewer than k unmasked items still end with real ids).
// 4. Item split. The grid is (row blocks x item splits); the wrapper picks
//    the split count S from B and I so that the blocks fill the card at two
//    per SM. Each block writes its split's top-k keys to scratch [S, B, k];
//    the merge pass ranks each row's S lists into the output. With S = 1 the
//    fused kernel writes the output itself.
// 5. Alignment. K = 250 gives U and V a row stride of 1000 bytes, 8-byte but
//    not 16-byte aligned, and the mask's row stride is I bytes. So the global
//    loads are 4-byte cp.async copies (transposed into the factor-major
//    slices, zero-filled out of range) and the mask is read one byte at a
//    time. K is not padded: the last slice multiplies only its own factors,
//    so every score keeps its exact fmaf chain (a -0.0 score reaches the key
//    as -0.0, which the key maps to +0.0, as in the wide pair).
//
// The TPU kernel ran a (row block x item tile) grid with item tiles in
// sequence, the running top-k in its output refs, and a k-step max/argmax
// sweep per tile; blocks here run in no order, so the tile loop runs inside
// the block and the splits meet in the merge pass.
//
// Wide pair. Pad columns j in [I, N) hold the largest key. One block of 1024
// threads sorts one row by a bitonic network: the stages whose pairs lie
// inside an aligned chunk of 8192 keys run on the chunk in shared memory
// (64 KB), the others on the row in global memory. The row's scratch is 8 N
// bytes; the wrapper sizes the chunk of rows. It is bound by its sort:
// log2(N) * (log2(N) + 1) / 2 compare-and-swap stages over N = next_pow2(I).
//
// Semantics kept from the reference: ties go to the lowest item id; a masked
// item (-inf) never precedes an unmasked one; a row with fewer than k unmasked
// items returns -inf in its tail, with ids that are real items (k <= I).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

// Measurement variants of the fused kernel, built only by
// scripts/k1_breakdown.py (nvcc -DK1_BREAKDOWN=n); their lists are wrong by
// design. 1: a later tile's candidates are compacted but never merged into
// the running lists. 2: no selection at all; every accumulator feeds a
// checksum, so no FMA is dropped as dead code. 0 (the default): the kernel.
#ifndef K1_BREAKDOWN
#define K1_BREAKDOWN 0
#endif

namespace {

constexpr int kMaxK = 64;  // largest k of the fused kernel

// fused kernel
constexpr int kFusedThreads = 256;
constexpr int kBM = 64;   // user rows per block
constexpr int kBN = 128;  // items per tile
constexpr int kBK = 16;   // factors per staged K-slice
constexpr int kStages = 3;  // K-slices in flight (a cp.async ring)
constexpr int kTM = 4;    // rows of a thread's micro-tile
constexpr int kTN = 8;    // items of a thread's micro-tile (two groups of 4)
constexpr int kAStride = kBM + 4;  // K-major slice rows, float4-aligned
constexpr int kBStride = kBN + 4;
constexpr int kCap = 64;          // candidate keys per row and merge round
constexpr int kMaxSplits = 16;
constexpr int kMergeThreads = 256;
static_assert(kBM == 16 * kTM && kBN == 16 * kTN, "16 x 16 threads cover the block tile");
static_assert(kBN >= kMaxK, "a split's first tile fills the running top-k");
static_assert(kFusedThreads == 256 && kBK == 16, "load_slice's copy layout");

// wide pair
constexpr int kThreads = 256;  // one item per thread in a tile
constexpr int kTile = 256;     // items per tile
constexpr int kRows = 8;       // user rows per block
constexpr int kChunk = 16;     // K-slice of V staged per step
constexpr int kSortThreads = 1024;
constexpr int kSortChunk = 8192;  // keys of one shared-memory sort chunk

// Ascending order of the key = score descending, then id ascending.
__device__ __forceinline__ uint64_t rank_key(float s, uint32_t j) {
  const uint32_t b = __float_as_uint(s == 0.f ? 0.f : s);  // -0.0 ranks as +0.0
  const uint32_t m = (b >> 31) ? ~b : (b | 0x80000000u);   // monotone in s
  return ((uint64_t)(~m) << 32) | j;
}

__device__ __forceinline__ float key_score(uint64_t key) {
  const uint32_t m = ~(uint32_t)(key >> 32);
  return __uint_as_float((m >> 31) ? (m & 0x7fffffffu) : ~m);
}

// Number of keys in the ascending list[0, n) below key.
__device__ __forceinline__ int count_below(const uint64_t* list, int n, uint64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// -- fused kernel (k <= kMaxK) -------------------------------------------------

size_t fused_smem_bytes() {
  return (size_t)kBM * (kMaxK + kCap) * sizeof(uint64_t) +
         (size_t)kStages * kBK * (kAStride + kBStride) * sizeof(float);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issues the copies of one K-slice into a stage: As[c][r] = U[row0 + r][kc
// + c] and Bs[c][t] = V[base + t][kc + c], zero outside [B, I, K). A warp's
// copy covers 8 factors of 4 rows: 32 contiguous bytes of each row, and 32
// distinct banks of the factor-major stage.
__device__ __forceinline__ void load_slice(float* As, float* Bs, const float* __restrict__ U,
                                           const float* __restrict__ V, int row0, int base,
                                           int kc, int B, int I, int K, int tid) {
  const int lane = tid % 32;
  const int r0 = lane / 8 + 4 * (tid / 32);
#pragma unroll
  for (int m = 0; m < kBM * kBK / kFusedThreads; ++m) {
    const int c = lane % 8 + 8 * (m & 1), r = r0 + 32 * (m >> 1);
    const bool ok = kc + c < K && row0 + r < B;
    cp_async4(As + c * kAStride + r, ok ? U + (size_t)(row0 + r) * K + kc + c : U, ok);
  }
#pragma unroll
  for (int m = 0; m < kBN * kBK / kFusedThreads; ++m) {
    const int c = lane % 8 + 8 * (m & 1), t = r0 + 32 * (m >> 1);
    const bool ok = kc + c < K && base + t < I;
    cp_async4(Bs + c * kBStride + t, ok ? V + (size_t)(base + t) * K + kc + c : V, ok);
  }
}

// Item offset in the tile of micro-tile column j: two groups of 4, half a
// tile apart, so a warp's float4 reads of V cover 256 contiguous bytes.
__device__ __forceinline__ int item_of(int tx, int j) {
  return (j < 4 ? 0 : kBN / 2) + tx * 4 + (j & 3);
}

__device__ __forceinline__ void fma_step(const float* As, const float* Bs, int c, int ty,
                                         int tx, float (&acc)[kTM][kTN]) {
  const float4 a = *reinterpret_cast<const float4*>(As + c * kAStride + ty * kTM);
  const float4 b0 = *reinterpret_cast<const float4*>(Bs + c * kBStride + tx * 4);
  const float4 b1 = *reinterpret_cast<const float4*>(Bs + c * kBStride + kBN / 2 + tx * 4);
  const float av[kTM] = {a.x, a.y, a.z, a.w};
  const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int lane_mask) {
  const uint32_t lo = __shfl_xor_sync(0xffffffffu, (uint32_t)v, lane_mask, 16);
  const uint32_t hi = __shfl_xor_sync(0xffffffffu, (uint32_t)(v >> 32), lane_mask, 16);
  return ((uint64_t)hi << 32) | lo;
}

// Sorts the 128 keys a half-warp holds (8 per lane, key j of lane tx at
// index 8 tx + j) ascending by a bitonic network in registers.
__device__ __forceinline__ void sort_half_warp(uint64_t (&v)[kTN], int tx) {
#pragma unroll
  for (int size = 2; size <= kBN; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int idx = tx * kTN + j;
        const bool asc = (idx & size) == 0;
        if (stride >= kTN) {  // the partner is key j of lane tx ^ (stride / 8)
          const uint64_t o = shfl_xor64(v[j], stride / kTN);
          v[j] = (asc == ((idx & stride) == 0)) ? min(v[j], o) : max(v[j], o);
        } else if ((j & stride) == 0) {  // the partner is key j + stride of this lane
          const uint64_t x = v[j], y = v[j + stride];
          if ((x > y) == asc) {
            v[j] = y;
            v[j + stride] = x;
          }
        }
      }
    }
  }
}

// Merges a row's c unsorted candidate keys into its sorted running top-k by
// rank, with the 32 lanes of a warp: an entry's place is its rank in its own
// list plus the keys below it in the other (all keys are distinct). Each
// lane holds kSlots entries; one pass over the candidates counts for all.
__device__ __forceinline__ void merge_row(uint64_t* rr, const uint64_t* cr, int c, int k,
                                          int lane) {
  constexpr int kSlots = (kCap + kMaxK) / 32;
  uint64_t key[kSlots];
  int below[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int e = lane + 32 * m;
    key[m] = ~0ull;
    below[m] = k;  // an empty slot is never placed
    if (e < c) {
      key[m] = cr[e];
    } else if (e < c + k) {
      key[m] = rr[e - c];
      below[m] = e - c;
    }
  }
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    if (lane + 32 * m < c) below[m] = count_below(rr, k, key[m]);
  }
#pragma unroll 4
  for (int z = 0; z < c; ++z) {
    const uint64_t y = cr[z];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) below[m] += y < key[m];
  }
  __syncwarp();  // every lane has read the old list
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    if (below[m] < k) rr[below[m]] = key[m];
  }
  __syncwarp();
}

// The tile's epilogue, warp by warp (a warp's rows are its own: no block
// barrier). The split's first tile: each half-warp sorts each of its rows'
// 128 keys in registers and keeps the first k as the running top-k; items
// past I take start keys (-inf, with distinct ids past every item and every
// other split's), which keep masked items admissible. A later tile: a score
// whose key ranks before its row's k-th running key is appended to the
// row's candidate buffer (prefix sums over the row's half-warp); every other
// score is dropped by that one compare; then each warp merges its rows'
// candidates into their running lists.
__device__ void select_tile(const float (&acc)[kTM][kTN], uint64_t* run, uint64_t* cand,
                            const uint8_t* __restrict__ mask, int row0, int base, int B, int I,
                            int k, int split, bool first, int tx, int ty) {
  uint32_t valid = 0, masked = 0;  // bit i * kTN + j
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int item = base + item_of(tx, j);
      if (row < B && item < I) {
        valid |= 1u << (i * kTN + j);
        if (mask[(size_t)row * I + item]) masked |= 1u << (i * kTN + j);
      }
    }
  }
  auto key = [&](int i, int j) {
    const float s = (masked >> (i * kTN + j)) & 1u ? -INFINITY : acc[i][j];
    return rank_key(s, (uint32_t)(base + item_of(tx, j)));
  };
  if (first) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      uint64_t v[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        v[j] = (valid >> (i * kTN + j)) & 1u
                   ? key(i, j)
                   : rank_key(-INFINITY, 0x80000000u + (uint32_t)(split * kBN + tx * kTN + j));
      }
      sort_half_warp(v, tx);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (tx * kTN + j < k) run[(ty * kTM + i) * kMaxK + tx * kTN + j] = v[j];
      }
    }
    __syncwarp();
    return;
  }
  // whether score j of row i ranks before the key thr: the same order as
  // key(i, j) < thr, tested on the value first
  auto before = [&](int i, int j, uint64_t thr) {
    const float s = (masked >> (i * kTN + j)) & 1u ? -INFINITY : acc[i][j];
    const float tv = key_score(thr);
    return s > tv || (s == tv && (uint32_t)(base + item_of(tx, j)) < (uint32_t)thr);
  };
  uint32_t pend[kTM];  // bit j: score j of row i ranks before the row's k-th key
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const uint64_t thr = run[(ty * kTM + i) * kMaxK + k - 1];
    pend[i] = 0;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      if (((valid >> (i * kTN + j)) & 1u) && before(i, j, thr)) pend[i] |= 1u << j;
    }
  }
  const int lane = tx + 16 * (ty & 1);
  // rounds: each row's first kCap pending candidates (in lane order) go to
  // its buffer and are merged; the rest are tested again against the
  // tightened k-th key (one round unless a tile holds many candidates)
  while (__any_sync(0xffffffffu, pend[0] | pend[1] | pend[2] | pend[3])) {
    int took[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty * kTM + i;
      const int c = __popc(pend[i]);
      int incl = c;
#pragma unroll
      for (int d = 1; d < 16; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d, 16);
        if (tx >= d) incl += t;
      }
      took[i] = min(kCap, __shfl_sync(0xffffffffu, incl, 15, 16));
      int pos = incl - c;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (((pend[i] >> j) & 1u) && pos < kCap) {
          cand[r * kCap + pos++] = key(i, j);
          pend[i] &= ~(1u << j);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int c = __shfl_sync(0xffffffffu, took[i], 16 * h);
        const int r = ((ty & ~1) + h) * kTM + i;
#if K1_BREAKDOWN == 1
        if (c > 1000) run[r] = c;  // keeps the compaction live
#else
        if (c > 0) merge_row(run + r * kMaxK, cand + r * kCap, c, k, lane);
#endif
      }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const uint64_t thr = run[(ty * kTM + i) * kMaxK + k - 1];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (((pend[i] >> j) & 1u) && !before(i, j, thr)) pend[i] &= ~(1u << j);
      }
    }
  }
}

// One block: kBM rows x the item tiles [t0, t1) of split blockIdx.y. Writes
// the split's top-k keys to part [S, B, k], or, when part is null (S = 1),
// the scores and ids to the output.
__global__ void __launch_bounds__(kFusedThreads, 2)
masked_topk_kernel(const float* __restrict__ U, const float* __restrict__ V,
                   const uint8_t* __restrict__ mask, float* __restrict__ out_vals,
                   int64_t* __restrict__ out_ids, uint64_t* __restrict__ part, int B, int I,
                   int K, int k, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char fused_smem[];
  uint64_t* run = reinterpret_cast<uint64_t*>(fused_smem);      // [kBM][kMaxK] running top-k
  uint64_t* cand = run + kBM * kMaxK;                            // [kBM][kCap] candidates
  float* stage_mem = reinterpret_cast<float*>(cand + kBM * kCap);  // the K-slice ring

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int n_tiles = (I + kBN - 1) / kBN;
  const int t0 = split * tiles_per_split;
  const int t1 = min(n_tiles, t0 + tiles_per_split);
  const int n_slices = (K + kBK - 1) / kBK;

  float* As = stage_mem;                           // [kStages][kBK][kAStride]
  float* Bs = stage_mem + kStages * kBK * kAStride;  // [kStages][kBK][kBStride]
  // the ring: slice (lt, lk) is the next to load, into stage `ls`
  int lt = t0, lk = 0, ls = 0;
  auto issue = [&]() {
    if (lt < t1) {
      load_slice(As + ls * kBK * kAStride, Bs + ls * kBK * kBStride, U, V, row0, lt * kBN,
                 lk * kBK, B, I, K, tid);
      if (++lk == n_slices) {
        lk = 0;
        ++lt;
      }
    }
    cp_async_commit();  // possibly empty: one group per slice keeps the count
    ls = ls == kStages - 1 ? 0 : ls + 1;
  };
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) issue();

  int cs = 0;  // stage of the slice being multiplied
  for (int t = t0; t < t1; ++t) {
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
    }
    for (int sl = 0; sl < n_slices; ++sl) {
      cp_async_wait<kStages - 2>();  // this thread's copies of the slice have landed
      __syncthreads();  // everyone's have, and the stage refilled next is consumed
      issue();
      const float* as = As + cs * kBK * kAStride;
      const float* bs = Bs + cs * kBK * kBStride;
      const int width = min(kBK, K - sl * kBK);
      if (width == kBK) {
#pragma unroll
        for (int c = 0; c < kBK; ++c) fma_step(as, bs, c, ty, tx, acc);
      } else {  // the last slice: only its own factors, so no product is added
        for (int c = 0; c < width; ++c) fma_step(as, bs, c, ty, tx, acc);
      }
      cs = cs == kStages - 1 ? 0 : cs + 1;
    }
#if K1_BREAKDOWN == 2
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) z += acc[i][j];
    }
    if (z == 12345.f) run[0] = 1;
#else
    select_tile(acc, run, cand, mask, row0, t * kBN, B, I, k, split, t == t0, tx, ty);
#endif
  }
  __syncthreads();  // every warp's lists are final

  for (int e = tid; e < kBM * k; e += kFusedThreads) {
    const int r = e / k, x = e - r * k;
    const int row = row0 + r;
    if (row >= B) continue;
    const uint64_t key = run[r * kMaxK + x];
    if (part != nullptr) {
      part[((size_t)split * B + row) * k + x] = key;
    } else {
      out_vals[(size_t)row * k + x] = key_score(key);
      out_ids[(size_t)row * k + x] = (int64_t)(uint32_t)key;
    }
  }
}

// One block per row: ranks the row's S sorted lists of k keys (part
// [S, B, k]) together and writes the first k. Keys are distinct, so an
// entry's place is its index plus the keys below it in the other lists.
__global__ void __launch_bounds__(kMergeThreads)
merge_splits_kernel(const uint64_t* __restrict__ part, float* __restrict__ out_vals,
                    int64_t* __restrict__ out_ids, int B, int k, int S) {
  extern __shared__ uint64_t lists[];  // [S][k]
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  for (int e = tid; e < S * k; e += kMergeThreads) {
    const int s = e / k;
    lists[e] = part[((size_t)s * B + row) * k + (e - s * k)];
  }
  __syncthreads();
  for (int e = tid; e < S * k; e += kMergeThreads) {
    const int s = e / k;
    const uint64_t key = lists[e];
    int pos = e - s * k;
    for (int o = 0; o < S && pos < k; ++o) {
      if (o != s) pos += count_below(lists + o * k, k, key);
    }
    if (pos < k) {
      out_vals[(size_t)row * k + pos] = key_score(key);
      out_ids[(size_t)row * k + pos] = (int64_t)(uint32_t)key;
    }
  }
}

// -- wide pair (k > kMaxK) ---------------------------------------------------

size_t score_smem_bytes(int K) {
  return ((size_t)kRows * K + (size_t)kChunk * (kTile + 1)) * sizeof(float);
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
        keys[(size_t)row * N + j] = rank_key(s, (uint32_t)j);
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

// Dynamic shared memory of one fused-kernel block, in bytes.
int ganmf_masked_topk_smem_bytes() { return (int)fused_smem_bytes(); }

// Fused-kernel blocks one SM holds at once on the current device (0 on a
// CUDA error).
int ganmf_masked_topk_blocks_per_sm() {
  int n = 0;
  if (cudaFuncSetAttribute(masked_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)fused_smem_bytes()) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, masked_topk_kernel, kFusedThreads,
                                                    fused_smem_bytes()) != cudaSuccess) {
    return 0;
  }
  return n;
}

// Launches K1's fused kernel (k <= 64) over `splits` item splits of
// `tiles_per_split` tiles of 128 items, then, for splits > 1, the merge pass,
// on `stream`; returns the first cudaGetLastError() (0 on success). U [B, K]
// f32, V [I, K] f32, mask [B, I] bytes (nonzero = exclude), all row-major and
// contiguous; vals [B, k] f32 and ids [B, k] int64 are written. part is
// scratch [splits, B, k] uint64 (unused, and may be null, when splits = 1).
// Every split must hold at least one tile.
int ganmf_masked_topk(const void* U, const void* V, const void* mask, void* vals, void* ids,
                      void* part, int B, int I, int K, int k, int tiles_per_split, int splits,
                      void* stream) {
  if (B <= 0 || I <= 0 || K <= 0 || k <= 0 || k > kMaxK || k > I || I > (1 << 30) ||
      tiles_per_split <= 0 || splits <= 0 || splits > kMaxSplits) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_tiles = (I + kBN - 1) / kBN;
  if ((long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= n_tiles || (splits > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = fused_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      masked_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kBM - 1) / kBM, splits);
  masked_topk_kernel<<<grid, kFusedThreads, smem, s>>>(
      static_cast<const float*>(U), static_cast<const float*>(V),
      static_cast<const uint8_t*>(mask), static_cast<float*>(vals), static_cast<int64_t*>(ids),
      splits > 1 ? static_cast<uint64_t*>(part) : nullptr, B, I, K, k, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  merge_splits_kernel<<<B, kMergeThreads, (size_t)splits * k * sizeof(uint64_t), s>>>(
      static_cast<const uint64_t*>(part), static_cast<float*>(vals),
      static_cast<int64_t*>(ids), B, k, splits);
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
