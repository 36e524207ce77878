// K2: exact-k row selection for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in ganmf_tpu/ops/pallas_select.py,
// launched there by `smallest_k_mask_pallas`. For every row r it writes a
// bool mask of the k[r] smallest float32 keys, ties to the lowest column;
// a row with k[r] = 0 is all false. The order is that of the monotone uint32
// image of the key bits, so +inf lies above every finite key and -0.0 below
// +0.0. The mask is bitwise that of the TPU kernel, of the XLA bisection
// (ganmf_tpu/ops/topk.py:87-104) and of the stable rank table
// argsort(argsort(keys)) < k.
//
// What bounds it on an H100. CFGAN draws its negative masks over the whole
// training matrix once per epoch: at LastFM's user-mode shape that is
// [2048, 17632] keys, 144 MB of float32 read and 36 MB of mask written. The
// kernel does a few integer compares and one shared-memory atomic per key
// and pass, so it is bound by device-memory and L2 bandwidth: 5 passes over
// the keys, of which the first comes from HBM and the rest mostly from L2
// (a 70 KB row is re-read by the same block while it is still cached).
//
// Design. The TPU kernel holds a block of rows in VMEM and runs 32 full-row
// compare-and-count sweeps of a value bisection, then an index bisection for
// the tie cut. Here one block of 512 threads owns one row and streams it from
// global memory:
//   1. Radix select, most significant byte first: 4 passes, each a 256-bin
//      histogram in shared memory of the keys that match the prefix found so
//      far. It yields T, the k-th smallest image, which is the bisection's
//      threshold (the smallest T with count(u <= T) >= k), and
//      needed = k - count(u < T) >= 1, and the number of keys equal to T.
//   2. One write pass in index order: u < T is selected; of the keys equal
//      to T, the first `needed` are. When every key equal to T is needed
//      (the usual case for random keys) that is u <= T. Otherwise a
//      block-wide prefix count of the equal keys (warp ballots plus one
//      shared count per warp) carries the running count across chunks.
// Shared memory: 256 + 16 + 3 ints. Keeping the row resident in shared
// memory, clusters for rows past 227 KB, and drawing the keys inside the
// kernel are left for later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;

__device__ __forceinline__ uint32_t monotone(float key) {
  // order-preserving map of IEEE-754 onto uint32 (the keys hold no NaN)
  const uint32_t b = __float_as_uint(key);
  return (b >> 31) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
smallest_k_kernel(const float* __restrict__ keys, const int* __restrict__ ks,
                  uint8_t* __restrict__ out, int I) {
  __shared__ int hist[kBins];
  __shared__ int warp_eq[kWarps];
  __shared__ int found[3];  // digit, count before the digit, count at it

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* kr = keys + row * (size_t)I;
  uint8_t* orow = out + row * (size_t)I;
  const int k = ks[row];

  if (k <= 0) {
    for (int j = tid; j < I; j += kThreads) orow[j] = 0;
    return;
  }

  // 1. radix select of the k-th smallest image
  uint32_t prefix = 0, pmask = 0;
  int rank = k;     // rank of the target among the keys matching the prefix
  int n_equal = 0;  // keys equal to T, known after the last pass
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
    __syncthreads();
    for (int j = tid; j < I; j += kThreads) {
      const uint32_t u = monotone(__ldg(kr + j));
      if ((u & pmask) == prefix) atomicAdd(&hist[(u >> shift) & 0xFF], 1);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins [8l, 8l + 8); an inclusive scan of the lane sums
      // finds the one lane whose range holds the rank-th key
      int local[8];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        local[i] = hist[lane * 8 + i];
        sum += local[i];
      }
      int inc = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += v;
      }
      int before = inc - sum;
      if (before < rank && rank <= inc) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (before + local[i] >= rank) {
            found[0] = lane * 8 + i;
            found[1] = before;
            found[2] = local[i];
            break;
          }
          before += local[i];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)found[0] << shift;
    pmask |= 0xFFu << shift;
    rank -= found[1];
    n_equal = found[2];
    // found[] is rewritten only after two more barriers
  }
  const uint32_t T = prefix;
  const int needed = rank;  // = k - count(u < T), in [1, n_equal]

  // 2. the mask, in index order
  if (n_equal == needed) {
    for (int j = tid; j < I; j += kThreads) orow[j] = monotone(__ldg(kr + j)) <= T;
    return;
  }
  const unsigned lanes_below = (1u << lane) - 1u;
  int taken = 0;  // equal keys before this chunk; the same in every thread
  for (int base = 0; base < I; base += kThreads) {
    const int j = base + tid;
    const uint32_t u = j < I ? monotone(__ldg(kr + j)) : 0u;
    const bool lt = j < I && u < T;
    const bool eq = j < I && u == T;
    bool sel = lt;
    if (taken < needed) {  // block-uniform
      const unsigned ballot = __ballot_sync(0xffffffffu, eq);
      if (lane == 0) warp_eq[warp] = __popc(ballot);
      __syncthreads();
      int before = taken, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_eq[w];
        if (w < warp) before += c;
        total += c;
      }
      sel = lt || (eq && before + __popc(ballot & lanes_below) < needed);
      taken += total;
      __syncthreads();  // warp_eq is rewritten by the next chunk
    }
    if (j < I) orow[j] = sel;
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// keys [R, I] f32 and k [R] int32, row-major and contiguous, with
// 0 <= k[r] <= I (the wrapper checks); out [R, I] bytes (0 or 1) is written.
int ganmf_smallest_k_mask(const void* keys, const void* k, void* out, int R, int I,
                          void* stream) {
  if (R <= 0 || I <= 0) return (int)cudaErrorInvalidValue;
  smallest_k_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keys), static_cast<const int*>(k),
      static_cast<uint8_t*>(out), I);
  return (int)cudaGetLastError();
}

}  // extern "C"
