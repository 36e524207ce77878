// Keyed per-row uniforms for Hopper (sm_90a).
//
// Not a port of a TPU kernel: the JAX package draws CFGAN's per-row mask
// keys with XLA, jax.random.uniform(fold_in(base, row), (I,))
// (ganmf_tpu/models/cfgan.py:156-159). The port's draw is its own: the
// uniform at (seed, epoch, stream, row r, column c) is word c % 4 of
// Philox4x32-10 at counter (c / 4, r, epoch, stream) under the key (seed's
// low word, seed's high word), mapped to (x >> 8) * 2^-24. It is a pure
// function of its indices, so a row's keys do not depend on the batch it is
// drawn in. The plain version (ops/keyed.py) repeats the arithmetic in int64
// tensors and is bitwise equal.
//
// What bounds it on an H100: the [B, I] float32 output, 4 bytes a key
// written once (the row ids read are negligible): at CFGAN's G batch on the
// LastFM-shaped split, [1024, 17632], 72 MB, 0.0216 ms at 3.35 TB/s. One
// Philox block (10 rounds of two 32-bit multiplies) gives four keys, about
// 15 integer operations a key, well under the integer rate at that byte
// rate.
//
// Design: one thread a Philox block, four consecutive columns of one row,
// stored as one 16-byte store when I % 4 == 0 (every row then starts on a
// 16-byte boundary), else as up to four scalar stores. A grid-stride loop
// over the B * ceil(I / 4) blocks. Fusing the draw into K2, so that the
// keys are never written, is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

__device__ __forceinline__ float to_unit(uint32_t x) {
  return __uint2float_rn(x >> 8) * 5.9604644775390625e-08f;  // 2^-24, exact
}

__global__ void keyed_uniforms_kernel(const int64_t* __restrict__ rows, int B, int I, uint32_t k0,
                                      uint32_t k1, uint32_t epoch, uint32_t stream,
                                      float* __restrict__ out) {
  const int64_t quads = (I + 3) / 4;
  const int64_t total = (int64_t)B * quads;
  const bool vec = (I % 4) == 0;
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * kThreads) {
    const int64_t r = t / quads;
    const uint32_t q = (uint32_t)(t - r * quads);
    const uint4 w = philox4x32_10(make_uint4(q, (uint32_t)rows[r], epoch, stream), k0, k1);
    float* o = out + r * (int64_t)I + 4 * (int64_t)q;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(to_unit(w.x), to_unit(w.y), to_unit(w.z), to_unit(w.w));
    } else {
      const int n = min(4, I - 4 * (int)q);
      o[0] = to_unit(w.x);
      if (n > 1) o[1] = to_unit(w.y);
      if (n > 2) o[2] = to_unit(w.z);
      if (n > 3) o[3] = to_unit(w.w);
    }
  }
}

}  // namespace

extern "C" {

// Writes out [B, I] float32 (row-major, contiguous) on `stream` from rows
// [B] int64; returns cudaGetLastError() (0 on success).
int ganmf_keyed_uniforms(const void* rows, int B, int I, unsigned int k0, unsigned int k1,
                         unsigned int epoch, unsigned int stream_id, void* out, void* stream) {
  if (B <= 0 || I <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * ((I + 3) / 4);
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  keyed_uniforms_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rows), B, I, k0, k1, epoch, stream_id, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
