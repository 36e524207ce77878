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
//   first kernel scores a tile of items for a few rows and sorts each row's
//   tile; the second places every kept key by rank among the row's tiles.
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
// 1. Register-tiled scoring (FusedTile<false>, any K and alignment; point 6
//    gives the aligned instance). A block of 256 threads owns kBM = 64 rows and
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
// 6. The aligned instance (FusedTile<true>). ML-20M's evaluation block is
//    B = 3648, K = 128, I = 26744, k = 50: 24.97 GFLOP, a bound of 0.373 ms,
//    where points 1-5 ran at a fifth of it. Timed variants and per-phase
//    clock counters on the card put scoring alone at 40% of the bound (its
//    4-byte copies a third of that time) and the selection at two thirds
//    of each warp's cycles: the merges most (706,628 a launch, 8.5 keys on
//    average, each over 128 slots of 32 lanes), then the threshold pass and
//    the mask's byte loads. Where K % 4 == 0 and U and V are 16-byte aligned
//    (so are rows of 4K bytes) and the batch fills row blocks, the wrapper
//    takes this instance. Same tile and micro-tile (an 8 x 8 micro-tile was
//    slower: at 128 registers it could not keep the next factors' loads in
//    flight, and spilled); what differs:
//    - K-slices of 32 factors arrive by 16-byte cp.async.cg copies, 6 a
//      thread a slice, into row-major stages whose 16-byte chunks are
//      swizzled (conflict-free float4 reads of 4 factors); two stages keep
//      two blocks an SM, with half the slice barriers.
//    - A lane's 8 items are contiguous, so its mask bytes of a row are one
//      8-byte load where they lie whole in the row and aligned.
//    - A row whose candidates and list fit 64 entries is merged by its own
//      half-warp (4 slots of 16 lanes), the warp's two half-warps at once.
//    Each score is still the one fmaf chain in factor order and the merges
//    rank the same keys, so both instances return the same bits. (Deferring
//    merges until a row's buffer overflows, and reading the mask only for
//    candidates, were slower: a stale threshold doubles the keys merged,
//    and a byte load behind each candidate's branch pays its latency once
//    for each.)
//
// The TPU kernel ran a (row block x item tile) grid with item tiles in
// sequence, the running top-k in its output refs, and a k-step max/argmax
// sweep per tile; blocks here run in no order, so the tile loop runs inside
// the block and the splits meet in the merge pass.
//
// Wide pair (k > kMaxK). Its work is small (recommend's default cutoff: B=5
// rows, K=250, I=3706, k=3705: 9 MFLOP and 3.8 MB, a bound of 1.2 us), so
// what it pays is latency: launches, barriers and a nearly idle card. So no
// row is sorted by one block (a 4096-key bitonic sort is 78 stages, each
// ending in a block barrier, on as many SMs as there are rows). Instead:
//
// 1. wide_tiles_kernel, grid (item tiles x row blocks): a block of 256
//    threads scores a tile of TW items for kWideRows = 8 rows (K-slices of
//    8192 / TW factors staged in shared memory, the next slice prefetched
//    into registers). The wrapper picks TW: 512 once the row blocks alone
//    fill the card or a row would take more than 32 tiles of 128, else 128,
//    so a handful of rows still spreads over many SMs (recommend's B = 5 at
//    I = 3706: 29 blocks of 128 items). A block of 512 items takes ~16
//    K-slices of 32 KB each through one SM, and at a small batch that SM's
//    load rate, not the card's, would set the time. The keys go to shared
//    memory; then warp r sorts row r's TW keys in registers (TW / 32 a
//    lane, a bitonic network whose strides of TW / 32 and more are
//    shuffles): no block barrier after scoring. Each row writes the first
//    L = min(k, TW) keys of its sorted tile to scratch [rows, T, L] (a key
//    at place L or later in its tile ranks at least L overall, so it is
//    never among the first k). Pad items past I take the largest key.
// 2. rank_tiles_kernel, grid (tiles x rows): a key's place in the row is its
//    place in its own tile plus, for every other tile, the kept keys below
//    it (a binary search; keys are distinct). A key placed below k is
//    written to the output. The other tiles' kept keys are searched in
//    shared memory, 48 KB of them at a time (all at once for recommend).
// Rows go in chunks whose scratch fits the wrapper's limit.
//
// Semantics kept from the reference: ties go to the lowest item id; a masked
// item (-inf) never precedes an unmasked one; a row with fewer than k unmasked
// items returns -inf in its tail, with ids that are real items (k <= I).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxK = 64;  // largest k of the fused kernel

// fused kernel
constexpr int kFusedThreads = 256;
constexpr int kMaxSplits = 16;
constexpr int kMergeThreads = 256;

// The fused kernel's two main loops (head note, points 1-2 and 6). A block
// of 256 threads owns kBM = 64 rows and walks item tiles of kBN = 128; each
// thread holds a 4 x 8 micro-tile of accumulators (4 rows, 8 items), the 16
// threads of a half-warp sharing their rows; K-slices of kBK factors stream
// through a ring of kStages stages; each row keeps its running top-k (kMaxK
// keys) and a candidate buffer of kCap keys.
template <bool kAligned>
struct FusedTile {
  static constexpr int kBM = 64;
  static constexpr int kBN = 128;
  static constexpr int kBK = kAligned ? 32 : 16;
  static constexpr int kStages = kAligned ? 2 : 3;
  static constexpr int kTM = 4;
  static constexpr int kTN = 8;
  static constexpr int kCap = 64;
  // factor-major stages of the unaligned loop have rows padded by 4 floats;
  // the aligned loop's stages are row-major, kBK floats a row
  static constexpr int kAStride = kBM + 4;
  static constexpr int kBStride = kBN + 4;
  static constexpr int kStageFloats =
      kAligned ? (kBM + kBN) * kBK : kBK * (kAStride + kBStride);
  static constexpr size_t kSmemBytes = (size_t)kBM * (kMaxK + kCap) * sizeof(uint64_t) +
                                       (size_t)kStages * kStageFloats * sizeof(float);
  static_assert(kBM == 16 * kTM && kBN == 16 * kTN, "16 x 16 threads cover the block tile");
  static_assert(kBN >= kMaxK, "a split's first tile fills the running top-k");
  static_assert(kBK % 4 == 0 && (!kAligned || kBK / 4 == 8), "a row-major stage row is 8 chunks");
};

// wide pair
constexpr int kWideThreads = 256;
constexpr int kWideRows = kWideThreads / 32;  // user rows per tile block: a warp each
constexpr int kRankThreads = 256;
constexpr int kRankSmemKeys = 6144;  // kept keys a rank block stages at once (48 KB)
constexpr int kMaxGridY = 65535;

// The layout of a wide tile of TW items (128 or 512) for kWideRows rows.
template <int TW>
struct WideTile {
  static constexpr int kCols = TW < kWideThreads ? TW : kWideThreads;  // threads along items
  static constexpr int kItems = TW / kCols;                  // items a thread scores
  static constexpr int kRowsPer = kWideRows * kCols / kWideThreads;  // rows a thread scores
  static constexpr int kLane = TW / 32;                      // keys a lane sorts
  // factors per staged K-slice: the narrower the tile, the wider the slice
  // (fewer round trips to L2 per block at the same registers a thread)
  static constexpr int kSlice = 16 * 512 / TW;
  static constexpr int kVStride = TW + 1;                    // V slice rows, floats
  // a row's keys in shared memory, one pad key every kLane so that a lane's
  // keys lie in distinct banks
  static constexpr int kKeyStride = TW + TW / kLane;
  static constexpr int kFetch = TW * kSlice / kWideThreads;  // V values a thread stages
  static constexpr int kUFetch = (kWideRows * kSlice + kWideThreads - 1) / kWideThreads;
  // the V slice's shared memory holds the keys once scoring is done
  static constexpr int kKeyBytes = kWideRows * kKeyStride * (int)sizeof(uint64_t);
  static constexpr int kSliceBytes = kSlice * kVStride * (int)sizeof(float);
  static constexpr int kSharedBytes = kKeyBytes > kSliceBytes ? kKeyBytes : kSliceBytes;
  static_assert(kRowsPer == 4 || kRowsPer == 8, "a thread's rows are one or two float4s");
  static_assert(kFetch * kWideThreads == TW * kSlice && kWideThreads % kSlice == 0,
                "the slice copy covers the tile");
};

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

// A 64-bit key of the lane lane ^ lane_mask within groups of W lanes.
template <int W>
__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int lane_mask) {
  const uint32_t lo = __shfl_xor_sync(0xffffffffu, (uint32_t)v, lane_mask, W);
  const uint32_t hi = __shfl_xor_sync(0xffffffffu, (uint32_t)(v >> 32), lane_mask, W);
  return ((uint64_t)hi << 32) | lo;
}

// Sorts the W E keys that a group of W lanes holds (key e of lane l at index
// E l + e) ascending by a bitonic network in registers: strides below E
// inside a lane, the others by shuffles.
template <int W, int E>
__device__ __forceinline__ void sort_lanes(uint64_t (&v)[E], int lane) {
#pragma unroll
  for (int size = 2; size <= W * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int idx = lane * E + e;
        const bool asc = (idx & size) == 0;
        if (stride >= E) {  // the partner is key e of lane l ^ (stride / E)
          const uint64_t o = shfl_xor64<W>(v[e], stride / E);
          v[e] = (asc == ((idx & stride) == 0)) ? min(v[e], o) : max(v[e], o);
        } else if ((e & stride) == 0) {  // the partner is key e + stride of this lane
          const uint64_t x = v[e], y = v[e + stride];
          if ((x > y) == asc) {
            v[e] = y;
            v[e + stride] = x;
          }
        }
      }
    }
  }
}

// -- fused kernel (k <= kMaxK) -------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// A 16-byte copy (L2 only), zero-filled when not valid; both addresses are
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issues the copies of one K-slice into a stage, zero outside [B, I, K).
//
// Unaligned (any K): As[c][r] = U[row0 + r][kc + c] and Bs[c][t] = V[base +
// t][kc + c], factor-major, by 4-byte copies. A warp's copy covers 8 factors
// of 4 rows: 32 contiguous bytes of each row, and 32 distinct banks of the
// stage.
//
// Aligned (K % 4 == 0, U and V 16-byte aligned): As[r][c] and Bs[t][c],
// row-major, by 16-byte copies of 4 factors (K's tail needs no test inside a
// copy); a warp's copy covers 128 contiguous bytes of each of 4 rows. The
// 16-byte chunk q of U's row r sits at chunk q ^ (r & 7) of its 128-byte
// stage row, and that of V's item t at q ^ ((t >> 3) & 7), so fma_slice's
// reads hit 8 distinct chunks in each quarter-warp.
template <bool kAligned>
__device__ __forceinline__ void load_slice(float* stage, const float* __restrict__ U,
                                           const float* __restrict__ V, int row0, int base,
                                           int kc, int B, int I, int K, int tid) {
  using T = FusedTile<kAligned>;
  float* As = stage;
  float* Bs = stage + (kAligned ? T::kBM * T::kBK : T::kBK * T::kAStride);
  if constexpr (kAligned) {
#pragma unroll
    for (int m = 0; m < T::kBM * T::kBK / 4 / kFusedThreads; ++m) {
      const int e = tid + kFusedThreads * m, r = e / 8, q = e % 8;
      const bool ok = row0 + r < B && kc + 4 * q < K;
      cp_async16(As + r * T::kBK + 4 * (q ^ (r & 7)),
                 ok ? U + (size_t)(row0 + r) * K + kc + 4 * q : U, ok);
    }
#pragma unroll
    for (int m = 0; m < T::kBN * T::kBK / 4 / kFusedThreads; ++m) {
      const int e = tid + kFusedThreads * m, t = e / 8, q = e % 8;
      const bool ok = base + t < I && kc + 4 * q < K;
      cp_async16(Bs + t * T::kBK + 4 * (q ^ ((t >> 3) & 7)),
                 ok ? V + (size_t)(base + t) * K + kc + 4 * q : V, ok);
    }
  } else {
    static_assert(T::kBK == 16, "the copy layout");
    const int lane = tid % 32;
    const int r0 = lane / 8 + 4 * (tid / 32);
#pragma unroll
    for (int m = 0; m < T::kBM * T::kBK / kFusedThreads; ++m) {
      const int c = lane % 8 + 8 * (m & 1), r = r0 + 32 * (m >> 1);
      const bool ok = kc + c < K && row0 + r < B;
      cp_async4(As + c * T::kAStride + r, ok ? U + (size_t)(row0 + r) * K + kc + c : U, ok);
    }
#pragma unroll
    for (int m = 0; m < T::kBN * T::kBK / kFusedThreads; ++m) {
      const int c = lane % 8 + 8 * (m & 1), t = r0 + 32 * (m >> 1);
      const bool ok = kc + c < K && base + t < I;
      cp_async4(Bs + c * T::kBStride + t, ok ? V + (size_t)(base + t) * K + kc + c : V, ok);
    }
  }
}

// Item offset in the tile of micro-tile column j of lane tx. Unaligned: two
// groups of 4, half a tile apart, so a warp's float4 reads of V cover 256
// contiguous bytes. Aligned: 8 tx + j, so a lane's mask bytes of a row are
// one 8-byte word.
template <bool kAligned>
__device__ __forceinline__ int item_of(int tx, int j) {
  if constexpr (kAligned) return tx * FusedTile<true>::kTN + j;
  else return (j < 4 ? 0 : FusedTile<false>::kBN / 2) + tx * 4 + (j & 3);
}

// Multiplies the first `width` factors of a staged slice into the
// accumulators, each score's chain in factor order. Unaligned: one factor
// step reads one float4 of U (a broadcast) and two of V and feeds 32 FMAs.
// Aligned (width a multiple of 4): four factors of each of the 8 items and
// the 4 rows (a float4 each) feed 128 FMAs, 4 in a row into each sum.
template <bool kAligned>
__device__ __forceinline__ void fma_slice(const float* stage, int width, int tx, int ty,
                                          float (&acc)[FusedTile<kAligned>::kTM][FusedTile<kAligned>::kTN]) {
  using T = FusedTile<kAligned>;
  if constexpr (kAligned) {
    const float* As = stage;
    const float* Bs = stage + T::kBM * T::kBK;
    auto step = [&](int q) {
      float4 b[T::kTN];
#pragma unroll
      for (int j = 0; j < T::kTN; ++j) {  // item 8 tx + j: its chunks' swizzle is tx & 7
        b[j] = *reinterpret_cast<const float4*>(Bs + (tx * T::kTN + j) * T::kBK + 4 * (q ^ (tx & 7)));
      }
#pragma unroll
      for (int i = 0; i < T::kTM; ++i) {
        const int r = ty * T::kTM + i;
        const float4 a = *reinterpret_cast<const float4*>(As + r * T::kBK + 4 * (q ^ (r & 7)));
#pragma unroll
        for (int j = 0; j < T::kTN; ++j) {
          float s = acc[i][j];
          s = fmaf(a.x, b[j].x, s);
          s = fmaf(a.y, b[j].y, s);
          s = fmaf(a.z, b[j].z, s);
          acc[i][j] = fmaf(a.w, b[j].w, s);
        }
      }
    };
    if (width == T::kBK) {
#pragma unroll
      for (int q = 0; q < T::kBK / 4; ++q) step(q);
    } else {  // the last slice: only its own factors, so no product is added
      for (int q = 0; q < width / 4; ++q) step(q);
    }
  } else {
    const float* As = stage;
    const float* Bs = stage + T::kBK * T::kAStride;
    auto step = [&](int c) {
      const float4 a = *reinterpret_cast<const float4*>(As + c * T::kAStride + ty * T::kTM);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + c * T::kBStride + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + c * T::kBStride + T::kBN / 2 + tx * 4);
      const float av[T::kTM] = {a.x, a.y, a.z, a.w};
      const float bv[T::kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < T::kTM; ++i) {
#pragma unroll
        for (int j = 0; j < T::kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    };
    if (width == T::kBK) {
#pragma unroll
      for (int c = 0; c < T::kBK; ++c) step(c);
    } else {  // the last slice: only its own factors, so no product is added
      for (int c = 0; c < width; ++c) step(c);
    }
  }
}

// Merges a row's c unsorted candidate keys into its sorted running top-k by
// rank, with kLanes lanes (the warp, or the row's half-warp: `lanes` names
// them): an entry's place is its rank in its own list plus the keys below it
// in the other (all keys are distinct). Each lane holds kSlots entries, so
// c + k <= kLanes kSlots; one pass over the candidates counts for all.
template <int kLanes, int kSlots>
__device__ __forceinline__ void merge_row(uint64_t* rr, const uint64_t* cr, int c, int k,
                                          int lane, unsigned lanes) {
  uint64_t key[kSlots];
  int below[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int e = lane + kLanes * m;
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
    if (lane + kLanes * m < c) below[m] = count_below(rr, k, key[m]);
  }
#pragma unroll 4
  for (int z = 0; z < c; ++z) {
    const uint64_t y = cr[z];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) below[m] += y < key[m];
  }
  __syncwarp(lanes);  // every lane has read the old list
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    if (below[m] < k) rr[below[m]] = key[m];
  }
  __syncwarp(lanes);
}

// merge_row as a call (the aligned loop): one copy of its code, not one a
// row, keeps the selection's code within the instruction caches.
template <int kLanes, int kSlots>
__device__ __noinline__ void merge_row_call(uint64_t* rr, const uint64_t* cr, int c, int k,
                                            int lane, unsigned lanes) {
  merge_row<kLanes, kSlots>(rr, cr, c, k, lane, lanes);
}

// Which of a thread's micro-tile scores are real (row < B, item < I) and
// which are masked, from the mask's bytes in global memory: one byte at a
// time, or, in the aligned loop, a row's 8 bytes as one word where they lie
// whole in the row and 8-byte aligned.
template <bool kAligned>
__device__ __forceinline__ void tile_bits(const uint8_t* __restrict__ mask, int row0, int base,
                                          int B, int I, int tx, int ty, uint32_t& valid,
                                          uint32_t& masked) {
  using T = FusedTile<kAligned>;
  valid = 0;
  masked = 0;
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int row = row0 + ty * T::kTM + i;
    if constexpr (kAligned) {
      if (row >= B) continue;
      const uint8_t* p = mask + (size_t)row * I + base + T::kTN * tx;
      uint64_t w = 0;
      if (base + T::kTN * (tx + 1) <= I && (uintptr_t)p % 8 == 0) {
        w = *reinterpret_cast<const uint64_t*>(p);
      } else {
#pragma unroll
        for (int j = 0; j < T::kTN; ++j) {
          if (base + T::kTN * tx + j < I && p[j]) w |= 1ull << (8 * j);
        }
      }
      // bit j of the byte: whether byte j of the word is nonzero
      w |= w >> 4;
      w |= w >> 2;
      w |= w >> 1;
      w &= 0x0101010101010101ull;
      const uint32_t m8 = (uint32_t)((w * 0x0102040810204080ull) >> 56);
      const int n = min(T::kTN, max(0, I - base - T::kTN * tx));  // items of the lane in [0, I)
      valid |= ((1u << n) - 1) << (i * T::kTN);
      masked |= m8 << (i * T::kTN);
    } else {
#pragma unroll
      for (int j = 0; j < T::kTN; ++j) {
        const int item = base + item_of<kAligned>(tx, j);
        if (row < B && item < I) {
          valid |= 1u << (i * T::kTN + j);
          if (mask[(size_t)row * I + item]) masked |= 1u << (i * T::kTN + j);
        }
      }
    }
  }
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
template <bool kAligned>
__device__ void select_tile(const float (&acc)[FusedTile<kAligned>::kTM][FusedTile<kAligned>::kTN],
                            const uint8_t* __restrict__ mask, uint64_t* run, uint64_t* cand,
                            int row0, int base, int B, int I, int k, int split, bool first,
                            int tx, int ty) {
  using T = FusedTile<kAligned>;
  constexpr int kTM = T::kTM, kTN = T::kTN, kCap = T::kCap;
  uint32_t valid, masked;  // bit i * kTN + j
  tile_bits<kAligned>(mask, row0, base, B, I, tx, ty, valid, masked);
  auto key = [&](int i, int j) {
    const float s = (masked >> (i * kTN + j)) & 1u ? -INFINITY : acc[i][j];
    return rank_key(s, (uint32_t)(base + item_of<kAligned>(tx, j)));
  };
  if (first) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      uint64_t v[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        v[j] = (valid >> (i * kTN + j)) & 1u
                   ? key(i, j)
                   : rank_key(-INFINITY, 0x80000000u + (uint32_t)(split * T::kBN + tx * kTN + j));
      }
      sort_lanes<16>(v, tx);
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
    return s > tv || (s == tv && (uint32_t)(base + item_of<kAligned>(tx, j)) < (uint32_t)thr);
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
    if constexpr (kAligned) {
      // a row whose candidates and list fit 64 entries is merged by its own
      // half-warp, both half-warps at once; else by the warp, row by row
      // (a rolled loop of calls: code size, not the loop, costs here)
#pragma unroll 1
      for (int i = 0; i < kTM; ++i) {
        const int r = ty * kTM + i;
        if (!__any_sync(0xffffffffu, took[i] + k > 64)) {
          if (took[i] > 0) {
            merge_row_call<16, 4>(run + r * kMaxK, cand + r * kCap, took[i], k, tx,
                                  0xffffu << (16 * (ty & 1)));
          }
          continue;
        }
        for (int h = 0; h < 2; ++h) {
          const int c = __shfl_sync(0xffffffffu, took[i], 16 * h);
          const int rh = ((ty & ~1) + h) * kTM + i;
          if (c > 0) merge_row_call<32, 4>(run + rh * kMaxK, cand + rh * kCap, c, k, lane, 0xffffffffu);
        }
      }
      if (!(pend[0] | pend[1] | pend[2] | pend[3])) continue;  // nothing to test again
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int c = __shfl_sync(0xffffffffu, took[i], 16 * h);
          const int r = ((ty & ~1) + h) * kTM + i;
          if (c > 0) merge_row<32, 4>(run + r * kMaxK, cand + r * kCap, c, k, lane, 0xffffffffu);
        }
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
template <bool kAligned>
__global__ void __launch_bounds__(kFusedThreads, 2)
masked_topk_kernel(const float* __restrict__ U, const float* __restrict__ V,
                   const uint8_t* __restrict__ mask, float* __restrict__ out_vals,
                   int64_t* __restrict__ out_ids, uint64_t* __restrict__ part, int B, int I,
                   int K, int k, int tiles_per_split) {
  using T = FusedTile<kAligned>;
  extern __shared__ __align__(16) unsigned char fused_smem[];
  uint64_t* run = reinterpret_cast<uint64_t*>(fused_smem);      // [kBM][kMaxK] running top-k
  uint64_t* cand = run + T::kBM * kMaxK;                         // [kBM][kCap] candidates
  float* stage_mem = reinterpret_cast<float*>(cand + T::kBM * T::kCap);  // the K-slice ring

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * T::kBM;
  const int split = blockIdx.y;
  const int n_tiles = (I + T::kBN - 1) / T::kBN;
  const int t0 = split * tiles_per_split;
  const int t1 = min(n_tiles, t0 + tiles_per_split);
  const int n_slices = (K + T::kBK - 1) / T::kBK;

  // the ring: slice (lt, lk) is the next to load, into stage `ls`
  int lt = t0, lk = 0, ls = 0;
  auto issue = [&]() {
    if (lt < t1) {
      load_slice<kAligned>(stage_mem + ls * T::kStageFloats, U, V, row0, lt * T::kBN,
                           lk * T::kBK, B, I, K, tid);
      if (++lk == n_slices) {
        lk = 0;
        ++lt;
      }
    }
    cp_async_commit();  // possibly empty: one group per slice keeps the count
    ls = ls == T::kStages - 1 ? 0 : ls + 1;
  };
#pragma unroll
  for (int p = 0; p < T::kStages - 1; ++p) issue();

  int cs = 0;  // stage of the slice being multiplied
  for (int t = t0; t < t1; ++t) {
    float acc[T::kTM][T::kTN];
#pragma unroll
    for (int i = 0; i < T::kTM; ++i) {
#pragma unroll
      for (int j = 0; j < T::kTN; ++j) acc[i][j] = 0.f;
    }
    for (int sl = 0; sl < n_slices; ++sl) {
      cp_async_wait<T::kStages - 2>();  // this thread's copies of the slice have landed
      __syncthreads();  // everyone's have, and the stage refilled next is consumed
      issue();
      fma_slice<kAligned>(stage_mem + cs * T::kStageFloats, min(T::kBK, K - sl * T::kBK), tx,
                          ty, acc);
      cs = cs == T::kStages - 1 ? 0 : cs + 1;
    }
    select_tile<kAligned>(acc, mask, run, cand, row0, t * T::kBN, B, I, k, split, t == t0, tx,
                          ty);
  }
  __syncthreads();  // every warp's lists are final

  for (int e = tid; e < T::kBM * k; e += kFusedThreads) {
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

template <bool kAligned>
cudaError_t launch_fused(const void* U, const void* V, const void* mask, void* vals, void* ids,
                         void* part, int B, int I, int K, int k, int tiles_per_split, int splits,
                         cudaStream_t s) {
  using T = FusedTile<kAligned>;
  const long long n_tiles = (I + T::kBN - 1) / T::kBN;
  if ((long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= n_tiles || (splits > 1 && part == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = FusedTile<kAligned>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      masked_topk_kernel<kAligned>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + T::kBM - 1) / T::kBM, splits);
  masked_topk_kernel<kAligned><<<grid, kFusedThreads, smem, s>>>(
      static_cast<const float*>(U), static_cast<const float*>(V),
      static_cast<const uint8_t*>(mask), static_cast<float*>(vals), static_cast<int64_t*>(ids),
      splits > 1 ? static_cast<uint64_t*>(part) : nullptr, B, I, K, k, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  merge_splits_kernel<<<B, kMergeThreads, (size_t)splits * k * sizeof(uint64_t), s>>>(
      static_cast<const uint64_t*>(part), static_cast<float*>(vals),
      static_cast<int64_t*>(ids), B, k, splits);
  return cudaGetLastError();
}

template <bool kAligned>
int blocks_per_sm() {
  int n = 0;
  const size_t smem = FusedTile<kAligned>::kSmemBytes;
  if (cudaFuncSetAttribute(masked_topk_kernel<kAligned>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, masked_topk_kernel<kAligned>,
                                                    kFusedThreads, smem) != cudaSuccess) {
    return 0;
  }
  return n;
}

// -- wide pair (k > kMaxK) ---------------------------------------------------

// This thread's share of K-slice kc (S = kSlice factors), into registers:
// pv[m] = V[base + t][kc + c] with t = tid / S + (256 / S) m, c = tid % S (S
// threads read one item's 4 S contiguous bytes), and pu[m] = U[row0 + r][kc
// + c] with r, c = (tid + 256 m) / S, % S; zero outside [B, I, K).
template <int TW>
__device__ __forceinline__ void wide_fetch(float (&pv)[WideTile<TW>::kFetch],
                                           float (&pu)[WideTile<TW>::kUFetch],
                                           const float* __restrict__ U,
                                           const float* __restrict__ V, int row0, int base,
                                           int kc, int B, int I, int K, int tid) {
  constexpr int S = WideTile<TW>::kSlice;
  const int c = tid % S;
  const bool in_k = kc + c < K;
#pragma unroll
  for (int m = 0; m < WideTile<TW>::kFetch; ++m) {
    const int t = tid / S + m * (kWideThreads / S);
    pv[m] = (in_k && base + t < I) ? __ldg(V + (size_t)(base + t) * K + kc + c) : 0.f;
  }
#pragma unroll
  for (int m = 0; m < WideTile<TW>::kUFetch; ++m) {
    const int e = tid + m * kWideThreads, r = e / S;
    pu[m] = (r < kWideRows && in_k && row0 + r < B) ? __ldg(U + (size_t)(row0 + r) * K + kc + c)
                                                    : 0.f;
  }
}

// One block: the masked scores of items [base, base + TW) for rows [row0,
// row0 + kWideRows) as keys (the largest key past I), each row's tile sorted
// by its warp; writes the first L keys of each sorted tile to part [B, T, L].
template <int TW>
__global__ void __launch_bounds__(kWideThreads)
wide_tiles_kernel(const float* __restrict__ U, const float* __restrict__ V,
                  const uint8_t* __restrict__ mask, uint64_t* __restrict__ part, int B, int I,
                  int K, int L) {
  using W = WideTile<TW>;
  __shared__ __align__(16) unsigned char wide_smem[W::kSharedBytes];
  __shared__ __align__(16) float us[W::kSlice * kWideRows];  // [c][r]
  float* vs = reinterpret_cast<float*>(wide_smem);             // [c][kVStride]
  uint64_t* keys = reinterpret_cast<uint64_t*>(wide_smem);     // [r][kKeyStride]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int col = tid % W::kCols, rows0 = (tid / W::kCols) * W::kRowsPer;  // this thread's share
  const int tile = blockIdx.x, T = gridDim.x;
  const int base = tile * TW;
  const int row0 = blockIdx.y * kWideRows;

  float acc[W::kRowsPer][W::kItems];
#pragma unroll
  for (int r = 0; r < W::kRowsPer; ++r) {
#pragma unroll
    for (int i = 0; i < W::kItems; ++i) acc[r][i] = 0.f;
  }
  auto step = [&](int c) {
    float u[W::kRowsPer];
#pragma unroll
    for (int q = 0; q < W::kRowsPer / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(us + c * kWideRows + rows0 + 4 * q);
      u[4 * q] = a.x;
      u[4 * q + 1] = a.y;
      u[4 * q + 2] = a.z;
      u[4 * q + 3] = a.w;
    }
#pragma unroll
    for (int i = 0; i < W::kItems; ++i) {
      const float v = vs[c * W::kVStride + col + i * W::kCols];
#pragma unroll
      for (int r = 0; r < W::kRowsPer; ++r) acc[r][i] = fmaf(u[r], v, acc[r][i]);
    }
  };
  float pv[W::kFetch], pu[W::kUFetch];
  wide_fetch<TW>(pv, pu, U, V, row0, base, 0, B, I, K, tid);
  for (int kc = 0; kc < K; kc += W::kSlice) {
    __syncthreads();  // the previous slice is consumed
#pragma unroll
    for (int m = 0; m < W::kFetch; ++m) {
      vs[(tid % W::kSlice) * W::kVStride + tid / W::kSlice + m * (kWideThreads / W::kSlice)] =
          pv[m];
    }
#pragma unroll
    for (int m = 0; m < W::kUFetch; ++m) {
      const int e = tid + m * kWideThreads;
      if (e < kWideRows * W::kSlice) us[(e % W::kSlice) * kWideRows + e / W::kSlice] = pu[m];
    }
    __syncthreads();
    if (kc + W::kSlice < K) {
      wide_fetch<TW>(pv, pu, U, V, row0, base, kc + W::kSlice, B, I, K, tid);
    }
    const int width = min(W::kSlice, K - kc);
    if (width == W::kSlice) {
#pragma unroll
      for (int c = 0; c < W::kSlice; ++c) step(c);
    } else {  // the last slice: only its own factors, so no product is added
      for (int c = 0; c < width; ++c) step(c);
    }
  }
  __syncthreads();  // every thread is done with the slices: the keys take their place

#pragma unroll
  for (int i = 0; i < W::kItems; ++i) {
    const int j = col + i * W::kCols;
    const int item = base + j;
#pragma unroll
    for (int r = 0; r < W::kRowsPer; ++r) {
      const int row = row0 + rows0 + r;
      uint64_t key = ~0ull;
      if (item < I && row < B) {
        key = rank_key(mask[(size_t)row * I + item] ? -INFINITY : acc[r][i], (uint32_t)item);
      }
      keys[(rows0 + r) * W::kKeyStride + j + j / W::kLane] = key;
    }
  }
  __syncthreads();

  const int row = row0 + warp;  // warp by warp from here: no block barrier
  if (row >= B) return;
  uint64_t* rk = keys + warp * W::kKeyStride;
  uint64_t v[W::kLane];
#pragma unroll
  for (int e = 0; e < W::kLane; ++e) v[e] = rk[lane * (W::kLane + 1) + e];
  sort_lanes<32>(v, lane);
#pragma unroll
  for (int e = 0; e < W::kLane; ++e) rk[lane * (W::kLane + 1) + e] = v[e];
  __syncwarp();
  uint64_t* out = part + ((size_t)row * T + tile) * L;
  for (int x = lane; x < L; x += 32) out[x] = rk[x + x / W::kLane];
}

// One block per (tile, row): places the tile's L kept keys among the row's
// T tiles (part [B, T, L], each tile's keys ascending) and writes those
// placed below k. Keys are distinct, so a key's place is its index in its
// tile plus the keys below it in every other tile (binary searches). The
// other tiles' kept keys are staged in shared memory, as many tiles at a
// time as kRankSmemKeys holds (every tile at once for recommend's rows).
__global__ void __launch_bounds__(kRankThreads)
rank_tiles_kernel(const uint64_t* __restrict__ part, float* __restrict__ out_vals,
                  int64_t* __restrict__ out_ids, int L, int k) {
  extern __shared__ uint64_t kept[];  // [per][L]
  constexpr int kMaxKeys = 2;         // keys a thread places (L <= 512)
  const int tid = threadIdx.x;
  const int tile = blockIdx.x, T = gridDim.x, row = blockIdx.y;
  const uint64_t* lists = part + (size_t)row * T * L;
  const int per = kRankSmemKeys / L;  // tiles staged at a time
  uint64_t key[kMaxKeys];
  int pos[kMaxKeys];
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) {
    const int x = tid + i * kRankThreads;
    pos[i] = x < L ? x : k;  // a thread with no key places nothing
    key[i] = x < L ? lists[(size_t)tile * L + x] : 0;
  }
  for (int o0 = 0; o0 < T; o0 += per) {
    const int n = min(per, T - o0);
    __syncthreads();  // the previous tiles are consumed
    for (int e = tid; e < n * L; e += kRankThreads) kept[e] = lists[(size_t)o0 * L + e];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxKeys; ++i) {
      if (pos[i] >= k) continue;
      int below = 0;  // the searches are independent: unrolled, they overlap
#pragma unroll 4
      for (int o = 0; o < n; ++o) {
        if (o0 + o != tile) below += count_below(kept + o * L, L, key[i]);
      }
      pos[i] += below;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) {
    if (pos[i] < k) {
      out_vals[(size_t)row * k + pos[i]] = key_score(key[i]);
      out_ids[(size_t)row * k + pos[i]] = (int64_t)(uint32_t)key[i];
    }
  }
}

template <int TW>
cudaError_t launch_wide(const float* U, const float* V, const uint8_t* mask, float* vals,
                        int64_t* ids, uint64_t* part, int B, int I, int K, int k,
                        int chunk_rows, cudaStream_t s) {
  const int T = (I + TW - 1) / TW;
  const int L = min(k, TW);
  const size_t rank_smem = (size_t)min(T, kRankSmemKeys / L) * L * sizeof(uint64_t);
  for (int r0 = 0; r0 < B; r0 += chunk_rows) {
    const int rows = min(chunk_rows, B - r0);
    const dim3 tile_grid(T, (rows + kWideRows - 1) / kWideRows);
    wide_tiles_kernel<TW><<<tile_grid, kWideThreads, 0, s>>>(
        U + (size_t)r0 * K, V, mask + (size_t)r0 * I, part, rows, I, K, L);
    rank_tiles_kernel<<<dim3(T, rows), kRankThreads, rank_smem, s>>>(
        part, vals + (size_t)r0 * k, ids + (size_t)r0 * k, L, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one fused-kernel block, in bytes, of the aligned
// main loop (aligned != 0) or the other.
int ganmf_masked_topk_smem_bytes(int aligned) {
  return (int)(aligned ? FusedTile<true>::kSmemBytes : FusedTile<false>::kSmemBytes);
}

// Fused-kernel blocks one SM holds at once on the current device, of either
// main loop (0 on a CUDA error).
int ganmf_masked_topk_blocks_per_sm(int aligned) {
  return aligned ? blocks_per_sm<true>() : blocks_per_sm<false>();
}

// Launches K1's fused kernel (k <= 64) over `splits` item splits of
// `tiles_per_split` tiles of 128 items, then, for splits > 1, the merge
// pass, on `stream`; returns the first cudaGetLastError() (0 on success).
// U [B, K] f32, V [I, K] f32, mask [B, I] bytes (nonzero = exclude), all
// row-major and contiguous; vals [B, k] f32 and ids [B, k] int64 are
// written. part is scratch [splits, B, k] uint64 (unused, and may be null,
// when splits = 1). Every split must hold at least one tile. aligned != 0
// takes the aligned main loop (head note, point 6), which needs K % 4 == 0
// and U and V 16-byte aligned.
int ganmf_masked_topk(const void* U, const void* V, const void* mask, void* vals, void* ids,
                      void* part, int B, int I, int K, int k, int tiles_per_split, int splits,
                      int aligned, void* stream) {
  if (B <= 0 || I <= 0 || K <= 0 || k <= 0 || k > kMaxK || k > I || I > (1 << 30) ||
      tiles_per_split <= 0 || splits <= 0 || splits > kMaxSplits) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!aligned) {
    return (int)launch_fused<false>(U, V, mask, vals, ids, part, B, I, K, k, tiles_per_split,
                                    splits, s);
  }
  if (K % 4 != 0 || (uintptr_t)U % 16 != 0 || (uintptr_t)V % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_fused<true>(U, V, mask, vals, ids, part, B, I, K, k, tiles_per_split,
                                 splits, s);
}

// Launches K1's wide pair (any k in [1, I]) on `stream`, `chunk_rows` rows at
// a time, and returns the first CUDA error (0 on success). Arguments as for
// ganmf_masked_topk, plus the tile width (128 or 512 items) and scratch
// [chunk_rows, T, L] uint64: T = ceil(I / tile) tiles of L = min(k, tile)
// kept keys. chunk_rows is at most 65535.
int ganmf_masked_topk_wide(const void* U, const void* V, const void* mask, void* vals,
                           void* ids, void* scratch, int B, int I, int K, int k, int tile,
                           int chunk_rows, void* stream) {
  if (B <= 0 || I <= 0 || K <= 0 || k <= 0 || k > I || chunk_rows <= 0 ||
      chunk_rows > kMaxGridY || scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* u = static_cast<const float*>(U);
  const auto* v = static_cast<const float*>(V);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* vl = static_cast<float*>(vals);
  auto* id = static_cast<int64_t*>(ids);
  auto* part = static_cast<uint64_t*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 128: return (int)launch_wide<128>(u, v, m, vl, id, part, B, I, K, k, chunk_rows, s);
    case 512: return (int)launch_wide<512>(u, v, m, vl, id, part, B, I, K, k, chunk_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ganmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
