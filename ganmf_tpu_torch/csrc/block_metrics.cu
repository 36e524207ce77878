// An evaluation block's ranking metrics at every cutoff (K3) for Hopper (sm_90a).
//
// Not a port of a TPU kernel: the JAX package computes the metrics with XLA
// ops (ganmf_tpu/eval/metrics.py, _evaluate_core), and the port computed
// them with about 40 eager PyTorch ops a cutoff over a dense [B, I] block of
// test ratings and a radix top-k of it. K3 computes the same BatchStats
// (eval/metrics.py) in one launch, plus a second, small one for the sums,
// from the block's ranked lists and each user's test pairs in CSR form:
// ids ascending and unique within a row, their values, and the values again
// in descending order. The plain version is ``evaluate_pairs_reference``.
//
// What bounds it on an H100: bytes. At ML-20M's evaluation block (B=3648,
// K=50, 4 cutoffs, I=26744, ~110k test pairs) it reads the lists (12 B a
// slot, 2.2 MB), the users' pairs (~1.3 MB) and the novelty and popularity
// of the listed items, and writes 4 counter rows of I floats and the
// per-user AP: about 4 MB, 1.2 us at 3.35 TB/s. Its time is the latency of
// one warp's chain of dependent loads (a binary search over the user's test
// ids for each listed item), since the whole block is resident at once.
//
// Design: one warp a user row, 8 rows a block. For each cutoff the warp
// walks the list in chunks of 32 places (any K): each lane looks its item's
// rating up by binary search, the 0/1 relevance and list masks become
// ballots, so the running counts that AP and AUC need (cumsums in the plain
// version) are popcounts, exact integers, and the float terms are summed
// over the warp by a fixed butterfly. The ideal DCG takes the user's largest
// test values from the descending copy: the positive values, then the zeros
// of the I - n unrated items, then the negative values, exactly the values a
// dense top-k of the row gives. Rows not valid are zeroed by selection, so a
// NaN RMSE there cannot reach a sum. Each block sums its rows in row order
// into a partial; the second kernel sums the partials in a fixed tree, so a
// run repeats bit for bit. The counters take float atomics of 1.0: integer
// values, exact below 2^24, so their order does not matter. A launch takes
// up to kMaxCutoffs cutoffs; the wrapper launches again for more.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 8;  // user rows a block, one warp each
constexpr int kThreads = 32 * kRows;
constexpr int kFields = 13;  // eval/metrics.py SCALAR_FIELDS
constexpr int kMaxCutoffs = 16;
constexpr int kReduceThreads = 128;
constexpr unsigned kAll = 0xffffffffu;

struct Cutoffs {
  int n;
  int c[kMaxCutoffs];
};

struct Args {
  const float* top_vals;    // [B, K]
  const int64_t* top_idx;   // [B, K]
  const int64_t* uids;      // [B]
  const int64_t* indptr;    // [U + 1]
  const int32_t* ids;       // [nnz], ascending within a row
  const float* vals;        // [nnz]
  const float* desc;        // [nnz], each row's values in descending order
  const int64_t* n_pos;     // [B]
  const bool* valid;        // [B]
  const float* user_rmse;   // [B]
  const float* novelty;     // [I]
  const float* pop;         // [I]
  float* partial;           // [gridDim.x, n, kFields]
  float* counters;          // [n, I], zero on entry
  float* user_ap;           // [n, B]
  int B, K, I;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(kAll, v, m);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(kAll, v, m);
  return v;
}

// The test value of item `id` in the row [start, start + n) of sorted ids, 0
// when the user has none.
__device__ __forceinline__ float rating_of(const Args& a, int64_t start, int n, int id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a.ids[start + mid] < id) lo = mid + 1; else hi = mid;
  }
  return (lo < n && a.ids[start + lo] == id) ? a.vals[start + lo] : 0.0f;
}

// Place j (j < I) of the row's I test values sorted descending, zeros for
// the unrated items: the q positive values, the `zeros` zeros, the rest.
__device__ __forceinline__ float ideal_at(const Args& a, int64_t start, int q, int64_t zeros, int j) {
  if (j < q) return a.desc[start + j];
  if (j < q + zeros) return 0.0f;
  return a.desc[start + j - zeros];
}

__global__ void __launch_bounds__(kThreads) block_metrics_kernel(Args a, Cutoffs cuts) {
  __shared__ float rows_out[kRows][kMaxCutoffs][kFields];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRows + warp;
  const unsigned upto = kAll >> (31 - lane);  // this lane and those before it

  if (b < a.B) {  // the same for every lane of the warp
    const int64_t u = a.uids[b];
    const int64_t start = a.indptr[u];
    const int n = (int)(a.indptr[u + 1] - start);
    const float npos = (float)a.n_pos[b];
    const bool ok = a.valid[b];
    const float rmse = a.user_rmse[b];
    int q = 0, hi = n;  // the positive values lead the descending copy
    while (q < hi) {
      const int mid = (q + hi) >> 1;
      if (a.desc[start + mid] > 0.0f) q = mid + 1; else hi = mid;
    }
    const int64_t zeros = (int64_t)a.I - n;
    const float* vals_row = a.top_vals + (int64_t)b * a.K;
    const int64_t* idx_row = a.top_idx + (int64_t)b * a.K;

    for (int ci = 0; ci < cuts.n; ++ci) {
      const int c = min(cuts.c[ci], a.K);
      long long hits = 0, length = 0, negs = 0, auc_sub = 0;
      float ap_sum = 0.0f, arhr = 0.0f, dcg = 0.0f, nov = 0.0f, pop = 0.0f;
      int first_hit = -1;
      for (int j0 = 0; j0 < c; j0 += 32) {
        const int j = j0 + lane;
        bool m = false, r = false;
        float gain = 0.0f, nv = 0.0f, pp = 0.0f;
        if (j < c && isfinite(vals_row[j])) {
          m = true;
          const int id = (int)idx_row[j];
          const float rating = rating_of(a, start, n, id);
          r = rating != 0.0f;
          gain = (exp2f(rating) - 1.0f) / logf((float)j + 2.0f);
          nv = a.novelty[id];
          pp = a.pop[id];
          if (ok) atomicAdd(a.counters + (int64_t)ci * a.I + id, 1.0f);
        }
        const unsigned mm = __ballot_sync(kAll, m), rm = __ballot_sync(kAll, r);
        const unsigned nm = mm & ~rm;
        const long long cum_rel = hits + __popc(rm & upto);  // inclusive, as cumsum
        const long long cum_neg = negs + __popc(nm & upto);
        const float place = (float)j + 1.0f;
        ap_sum += warp_sum(r ? (float)cum_rel / place : 0.0f);
        arhr += warp_sum(r ? 1.0f / place : 0.0f);
        dcg += warp_sum(gain);
        nov += warp_sum(nv);
        pop += warp_sum(pp);
        auc_sub += warp_sum(r ? cum_neg : 0LL);
        if (first_hit < 0 && rm) first_hit = j0 + __ffs(rm) - 1;
        hits += __popc(rm);
        length += __popc(mm);
        negs += __popc(nm);
      }
      float idcg = 0.0f;
      for (int j0 = 0; j0 < length; j0 += 32) {
        const int j = j0 + lane;
        float t = 0.0f;
        if (j < length) t = (exp2f(ideal_at(a, start, q, zeros, j)) - 1.0f) / logf((float)j + 2.0f);
        idcg += warp_sum(t);
      }
      if (lane == 0) {
        const float len = (float)length, h = (float)hits;
        const float den = fmaxf(fminf(npos, len), 1.0f);
        const float ap = length > 0 ? ap_sum / den : 0.0f;
        // AUC within the list: sum over hits of the negatives after them
        const long long pairs = hits * negs;
        const float auc = negs == 0 ? 1.0f
                          : hits > 0 ? (float)(pairs - auc_sub) / fmaxf((float)pairs, 1.0f) : 0.0f;
        const float f[kFields] = {
            auc,
            length > 0 ? h / fmaxf(len, 1.0f) : 0.0f,  // precision
            length > 0 ? h / den : 0.0f,               // precision, min denominator
            h / fmaxf(npos, 1.0f),                      // recall
            ap,
            first_hit >= 0 ? 1.0f / ((float)first_hit + 1.0f) : 0.0f,  // reciprocal rank
            dcg == 0.0f ? 0.0f : dcg / fmaxf(idcg, 1e-30f),            // NDCG
            h,
            arhr,
            rmse,
            nov,
            length > 0 ? pop / fmaxf(len, 1.0f) : 0.0f,  // average popularity
            length > 0 ? 1.0f : 0.0f,                    // covered user
        };
        a.user_ap[(int64_t)ci * a.B + b] = ap;
#pragma unroll
        for (int k = 0; k < kFields; ++k) rows_out[warp][ci][k] = ok ? f[k] : 0.0f;
      }
    }
  } else if (lane == 0) {
    for (int ci = 0; ci < cuts.n; ++ci)
      for (int k = 0; k < kFields; ++k) rows_out[warp][ci][k] = 0.0f;
  }
  __syncthreads();
  const int width = cuts.n * kFields;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kRows; ++w) s += rows_out[w][i / kFields][i % kFields];
    a.partial[(int64_t)blockIdx.x * width + i] = s;
  }
}

// out[i] = the sum of partial[p][i] over the blocks p, in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
    block_metrics_sum_kernel(const float* __restrict__ partial, int blocks, int width, float* __restrict__ out) {
  __shared__ float s[kReduceThreads];
  const int i = blockIdx.x;
  float v = 0.0f;
  for (int p = threadIdx.x; p < blocks; p += kReduceThreads) v += partial[(int64_t)p * width + i];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int h = kReduceThreads / 2; h; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[i] = s[0];
}

}  // namespace

extern "C" {

// Rows a block of the first kernel takes (the wrapper sizes `partial` by it).
int ganmf_block_metrics_rows() { return kRows; }

// Cutoffs one launch takes.
int ganmf_block_metrics_max_cutoffs() { return kMaxCutoffs; }

// Launches K3 on `stream` for the n_cutoffs (1..kMaxCutoffs) cutoffs at
// `cutoffs` (host memory, read here): scalars [n, 13], counters [n, I]
// (zero on entry), user_ap [n, B]; partial holds ceil(B / rows) * n * 13
// floats. Returns the first cudaGetLastError() (0 on success).
int ganmf_block_metrics(const void* top_vals, const void* top_idx, int B, int K, const void* uids,
                        const void* indptr, const void* ids, const void* vals, const void* desc,
                        const void* n_pos, const void* valid, const void* user_rmse, const void* novelty,
                        const void* pop, int I, const int* cutoffs, int n_cutoffs, void* partial,
                        void* scalars, void* counters, void* user_ap, void* stream) {
  if (B <= 0 || K <= 0 || I <= 0 || n_cutoffs <= 0 || n_cutoffs > kMaxCutoffs)
    return (int)cudaErrorInvalidValue;
  Cutoffs cuts;
  cuts.n = n_cutoffs;
  for (int i = 0; i < kMaxCutoffs; ++i) cuts.c[i] = i < n_cutoffs ? cutoffs[i] : 0;
  Args a;
  a.top_vals = static_cast<const float*>(top_vals);
  a.top_idx = static_cast<const int64_t*>(top_idx);
  a.uids = static_cast<const int64_t*>(uids);
  a.indptr = static_cast<const int64_t*>(indptr);
  a.ids = static_cast<const int32_t*>(ids);
  a.vals = static_cast<const float*>(vals);
  a.desc = static_cast<const float*>(desc);
  a.n_pos = static_cast<const int64_t*>(n_pos);
  a.valid = static_cast<const bool*>(valid);
  a.user_rmse = static_cast<const float*>(user_rmse);
  a.novelty = static_cast<const float*>(novelty);
  a.pop = static_cast<const float*>(pop);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<float*>(counters);
  a.user_ap = static_cast<float*>(user_ap);
  a.B = B;
  a.K = K;
  a.I = I;
  const int blocks = (B + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  block_metrics_kernel<<<blocks, kThreads, 0, s>>>(a, cuts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block_metrics_sum_kernel<<<n_cutoffs * kFields, kReduceThreads, 0, s>>>(
      a.partial, blocks, n_cutoffs * kFields, static_cast<float*>(scalars));
  return (int)cudaGetLastError();
}

}  // extern "C"
