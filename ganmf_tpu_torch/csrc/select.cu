// K2: exact-k row selection for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in ganmf_tpu/ops/pallas_select.py,
// launched there by `smallest_k_mask_pallas`. For every row r it writes a
// bool mask of the k[r] smallest float32 keys, ties to the lowest column;
// k[r] is clamped to [0, I] as the JAX function does: a row with k <= 0 is
// all false, a row with k >= I all true, with no radix pass. The order is
// that of the monotone uint32 image of the key bits, so +inf lies above
// every finite key and -0.0 below +0.0. The mask is bitwise that of
// the TPU kernel, of the XLA bisection (ganmf_tpu/ops/topk.py:87-104) and of
// the stable rank table argsort(argsort(keys)) < k.
//
// What bounds it on an H100. CFGAN draws its negative masks over the whole
// training matrix once per epoch: [1884, 17632] keys in user mode and
// [17632, 1884] in item mode at LastFM's shape, 133 MB of float32 read and
// 33 MB of mask written. Each key needs a few integer operations per radix
// pass, so the bound is the 5 bytes a key moves over HBM: 0.0496 ms.
//
// Design. A radix select, most significant byte first: up to 4 passes, each
// a 256-bin histogram of the keys that match the prefix found so far, yield
// T, the k-th smallest image (the bisection's threshold), needed = k -
// count(u < T) >= 1 and the number of keys equal to T. A pass whose chosen
// bin is needed whole ends the select early (T = the prefix with every lower
// bit set): for CFGAN's keys, after the second or third pass. Then the
// write: u < T is selected and, of the keys equal to T, the first `needed`
// in column order; when every key equal to T is needed (the usual case for
// random keys) that is u <= T. The keys are read from HBM once:
//
// - One block per row, the row's images in shared memory, read with 16-byte
//   loads when I % 4 == 0 (the first pass is counted as they arrive), then
//   at most 3 passes over shared memory with three block barriers each.
//   Rows of up to 2048 keys (item mode: 7.5 KB) take blocks of 128 threads,
//   so an SM holds 12 rows; longer rows, up to 56320 keys (user mode: 70
//   KB, three blocks an SM), take 512. (A warp per short row, the row in
//   its registers, needs 128 registers a thread: 16 rows an SM, and a
//   quarter of the bound.)
// - Wider rows (the streamed [128, 65536] and [5, 131072] cases): the same
//   block kernel streams every pass from global memory (L2 after the first).
//
// Histograms. CFGAN's keys are uniforms in [0, 1) and +inf, whose top byte
// is 0xBE or 0xBF for 7/8 of them, so a warp's atomics on one histogram
// collide on two bins and serialize. Each histogram is 8 sub-histograms of
// 16-bit counts (lane l counts into copy l % 8, two bins a 32-bit word, 4.5
// KB with a padding that keeps the digit search's reads free of bank
// conflicts), so at most 4 lanes of a warp share an address. (Grouping a
// warp's lanes by __match_any_sync, by rounds of ballots, counting in
// per-thread (bin, count) slots, merging equal digits of a thread's four
// keys, or 32 sub-histograms (one a lane, 16 KB) cost more than the
// collisions they saved.) The 16-bit counts bound a row to 8 x 65535 keys
// (the JAX kernel takes at most 131072). The rare tie cut (some keys equal
// to T are not needed) gives each thread a contiguous run of columns and a
// block-wide prefix count of equal keys. Drawing the uniform keys inside
// the kernel is left for later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBins = 256;
constexpr int kCopies = 8;                       // lane l counts into copy l % 8
// 16-bit counts, two bins a word: the 8 bins a find_bin lane owns are 4
// words of kCopies copies, padded by 16 bytes so that the lanes' 16-byte
// reads fall in distinct banks (4.5 KB in all)
constexpr int kLaneWords = 4 * kCopies + 4;
constexpr int kHistWords = 32 * kLaneWords;
constexpr int kShortThreads = 128;   // a block per row of at most kShortCols keys
constexpr int kShortCols = 2048;
constexpr int kLongThreads = 512;    // a block per longer row
constexpr int kSmemMaxCols = 56320;  // widest row kept in shared memory (220 KB)
constexpr int kMaxCols = kCopies * 0xFFFF;  // no 16-bit count can overflow

__device__ __forceinline__ uint32_t monotone(uint32_t b) {
  // order-preserving map of IEEE-754 bits onto uint32 (the keys hold no NaN)
  return (b >> 31) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint4 monotone4(float4 f) {
  return make_uint4(monotone(__float_as_uint(f.x)), monotone(__float_as_uint(f.y)),
                    monotone(__float_as_uint(f.z)), monotone(__float_as_uint(f.w)));
}

// k[row] from an int32 or int64 array, clamped to [0, I] as the JAX function
// selects: none for k <= 0, every column for k >= I.
__device__ __forceinline__ int row_k(const void* ks, int k64, size_t row, int I) {
  const long long k = k64 ? static_cast<const long long*>(ks)[row]
                          : (long long)static_cast<const int*>(ks)[row];
  return (int)(k < 0 ? 0 : (k > I ? I : k));
}

// Counts one key of digit `bin` into hist [32][kLaneWords]: bins 2w and 2w +
// 1 are the low and high halves of word w, whose copy c sits at (w / 4,
// (w % 4) kCopies + c).
__device__ __forceinline__ void hist_add(uint32_t* hist, uint32_t bin, int lane) {
  const int copy = lane % kCopies;
  const uint32_t w = bin >> 1;
  atomicAdd(hist + (w >> 2) * kLaneWords + (w & 3) * kCopies + copy, 1u << ((bin & 1) * 16));
}

// Zeroes hist with threads t, t + stride, ...
__device__ __forceinline__ void hist_clear(uint32_t* hist, int t, int stride) {
  for (int q = t; q < kHistWords / 4; q += stride) {
    reinterpret_cast<uint4*>(hist)[q] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The digit of the rank-th smallest counted key (1 <= rank <= total), read
// by one whole warp; every lane gets the digit, the keys at lower digits
// (*before) and the keys at it (*count). Lane l owns bins [8 l, 8 l + 8),
// row l of hist; an inclusive scan of the lane sums finds the one lane whose
// range holds the rank-th key.
__device__ __forceinline__ int find_bin(const uint32_t* hist, int rank, int lane, int* before,
                                        int* count) {
  int local[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const uint4* h = reinterpret_cast<const uint4*>(hist + lane * kLaneWords);
#pragma unroll
  for (int q = 0; q < kCopies; ++q) {  // 4 words of kCopies copies, 4 at a time
    const uint4 x = h[q];
    const int i = 2 * (q / (kCopies / 4));  // the word's low bin
    local[i] += (int)((x.x & 0xFFFFu) + (x.y & 0xFFFFu) + (x.z & 0xFFFFu) + (x.w & 0xFFFFu));
    local[i + 1] += (int)((x.x >> 16) + (x.y >> 16) + (x.z >> 16) + (x.w >> 16));
  }
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += local[i];
  int inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += v;
  }
  const int excl = inc - sum;
  const bool mine = excl < rank && rank <= inc;
  int digit = 0, b = 0, c = 0;
  if (mine) {
    int run = excl;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c == 0 && run + local[i] >= rank) {
        digit = lane * 8 + i;
        b = run;
        c = local[i];
      }
      run += local[i];
    }
  }
  const int owner = __ffs(__ballot_sync(kFull, mine)) - 1;
  *before = __shfl_sync(kFull, b, owner);
  *count = __shfl_sync(kFull, c, owner);
  return __shfl_sync(kFull, digit, owner);
}

__device__ __forceinline__ uint32_t pack4(bool a, bool b, bool c, bool d) {
  return (uint32_t)a | ((uint32_t)b << 8) | ((uint32_t)c << 16) | ((uint32_t)d << 24);
}

// A block of kThreads per row. kResident: the row's images sit in dynamic
// shared memory (I <= kSmemMaxCols) and are read from HBM once; else every
// pass streams the row from global memory.
template <bool kResident, int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == kLongThreads ? 3 : 1536 / kThreads)
select_block_kernel(const float* __restrict__ keys, const void* __restrict__ ks, int k64,
                    uint8_t* __restrict__ out, int I) {
  extern __shared__ __align__(16) uint32_t img[];  // [I] when resident
  __shared__ __align__(16) uint32_t hist[kHistWords];
  __shared__ int found[3];  // digit, keys before it, keys at it
  __shared__ int warp_sums[kThreads / 32];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t row = blockIdx.x;
  const float* kr = keys + row * (size_t)I;
  uint8_t* orow = out + row * (size_t)I;
  const int k = row_k(ks, k64, row, I);  // read now, tested once the keys are in
  const bool vec = (I & 3) == 0;  // the row's keys 16-byte and its mask 4-byte aligned
  const int n4 = I / 4;

  auto image = [&](int j) { return kResident ? img[j] : monotone(__float_as_uint(__ldg(kr + j))); };
  auto image4 = [&](int q) {
    return kResident ? reinterpret_cast<const uint4*>(img)[q]
                     : monotone4(__ldg(reinterpret_cast<const float4*>(kr) + q));
  };

  hist_clear(hist, tid, kThreads);
  __syncthreads();
  // the first pass, as the row is read (and kept, when resident)
  if (vec) {
#pragma unroll 4
    for (int q = tid; q < n4; q += kThreads) {
      const uint4 x = monotone4(__ldg(reinterpret_cast<const float4*>(kr) + q));
      if (kResident) reinterpret_cast<uint4*>(img)[q] = x;
      hist_add(hist, x.x >> 24, lane);
      hist_add(hist, x.y >> 24, lane);
      hist_add(hist, x.z >> 24, lane);
      hist_add(hist, x.w >> 24, lane);
    }
  } else {
#pragma unroll 4
    for (int j = tid; j < I; j += kThreads) {
      const uint32_t x = monotone(__float_as_uint(__ldg(kr + j)));
      if (kResident) img[j] = x;
      hist_add(hist, x >> 24, lane);
    }
  }
  if (k == 0 || k == I) {
    const bool all = k == I;
    if (vec) {
      for (int q = tid; q < n4; q += kThreads) {
        reinterpret_cast<uint32_t*>(orow)[q] = all ? 0x01010101u : 0u;
      }
    } else {
      for (int j = tid; j < I; j += kThreads) orow[j] = all;
    }
    return;
  }
  __syncthreads();  // the first pass is counted (and the row is in shared memory)

  // 1. radix select
  uint32_t prefix = 0, pmask = 0;
  int rank = k, n_equal = 0;
  for (int shift = 24;; shift -= 8) {
    if (warp == 0) {
      int before, count;
      const int digit = find_bin(hist, rank, lane, &before, &count);
      if (lane == 0) {
        found[0] = digit;
        found[1] = before;
        found[2] = count;
      }
    }
    __syncthreads();
    prefix |= (uint32_t)found[0] << shift;
    pmask |= 0xFFu << shift;
    rank -= found[1];
    n_equal = found[2];
    if (shift == 0) break;
    if (rank == n_equal) {  // every key of this prefix is needed: T is its largest image
      prefix |= ~pmask;
      break;
    }
    hist_clear(hist, tid, kThreads);
    __syncthreads();  // found[] is read and the histogram cleared
    const int next = shift - 8;
    if (vec) {
      for (int q = tid; q < n4; q += kThreads) {
        const uint4 x = image4(q);
        if ((x.x & pmask) == prefix) hist_add(hist, (x.x >> next) & 0xFFu, lane);
        if ((x.y & pmask) == prefix) hist_add(hist, (x.y >> next) & 0xFFu, lane);
        if ((x.z & pmask) == prefix) hist_add(hist, (x.z >> next) & 0xFFu, lane);
        if ((x.w & pmask) == prefix) hist_add(hist, (x.w >> next) & 0xFFu, lane);
      }
    } else {
      for (int j = tid; j < I; j += kThreads) {
        const uint32_t x = image(j);
        if ((x & pmask) == prefix) hist_add(hist, (x >> next) & 0xFFu, lane);
      }
    }
    __syncthreads();  // the pass is counted
  }
  const uint32_t T = prefix;
  const int needed = rank;  // = k - count(u < T), in [1, n_equal]

  // 2. the mask, in column order
  if (n_equal != needed) {
    // the tie cut: each thread takes a contiguous run of columns, and a
    // block-wide prefix count of the keys equal to T picks the first `needed`
    const int per = (I + kThreads - 1) / kThreads;
    const int lo = min(I, tid * per), hi = min(I, lo + per);
    int c = 0;
    for (int j = lo; j < hi; ++j) c += image(j) == T;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int run = incl - c;
    for (int w = 0; w < warp; ++w) run += warp_sums[w];
    for (int j = lo; j < hi; ++j) {
      const uint32_t u = image(j);
      const bool eq = u == T;
      orow[j] = u < T || (eq && run < needed);
      run += eq;
    }
    return;
  }
  if (vec) {
    for (int q = tid; q < n4; q += kThreads) {
      const uint4 u = image4(q);
      reinterpret_cast<uint32_t*>(orow)[q] = pack4(u.x <= T, u.y <= T, u.z <= T, u.w <= T);
    }
  } else {
    for (int j = tid; j < I; j += kThreads) orow[j] = image(j) <= T;
  }
}

}  // namespace

extern "C" {

// Blocks of the kernel that takes rows of I keys one SM holds at once on the
// current device (0 on a CUDA error).
int ganmf_smallest_k_mask_blocks_per_sm(int I) {
  int n = 0;
  const size_t smem = I <= kSmemMaxCols ? (size_t)I * sizeof(uint32_t) : 0;
  cudaError_t err;
  if (I <= kShortCols) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, select_block_kernel<true, kShortThreads>, kShortThreads, smem);
  } else if (I <= kSmemMaxCols) {
    err = cudaFuncSetAttribute(select_block_kernel<true, kLongThreads>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, select_block_kernel<true, kLongThreads>, kLongThreads, smem);
    }
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, select_block_kernel<false, kLongThreads>, kLongThreads, 0);
  }
  return err == cudaSuccess ? n : 0;
}

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// keys [R, I] f32 and k [R] (int64 when k_is_int64, else int32), row-major
// and contiguous, with I <= 8 x 65535; out [R, I] bytes (0 or 1) is
// written. Any k is taken: it is clamped to [0, I] per row.
int ganmf_smallest_k_mask(const void* keys, const void* k, int k_is_int64, void* out, int R,
                          int I, void* stream) {
  if (R <= 0 || I <= 0 || I > kMaxCols) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kp = static_cast<const float*>(keys);
  uint8_t* op = static_cast<uint8_t*>(out);
  const size_t smem = (size_t)I * sizeof(uint32_t);
  if (I <= kShortCols) {
    select_block_kernel<true, kShortThreads><<<R, kShortThreads, smem, s>>>(kp, k, k_is_int64, op, I);
  } else if (I <= kSmemMaxCols) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          select_block_kernel<true, kLongThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    select_block_kernel<true, kLongThreads><<<R, kLongThreads, smem, s>>>(kp, k, k_is_int64, op, I);
  } else {
    select_block_kernel<false, kLongThreads><<<R, kLongThreads, 0, s>>>(kp, k, k_is_int64, op, I);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
