// Host-side data engine for ganmf-tpu.
//
// Native (C++/OpenMP) equivalents of the reference's Cython kernel surface
// (GANRec/Cython/cython_utils.pyx: get_non_interactions :30, compute_masks
// :48, random_choice :74 with nogil binary search :166), plus the CSR row
// densification that dominated the reference's host time
// (GANRec/GANMF.py:184). Exposed through extern "C" and loaded via ctypes
// (ganmf_tpu/ops/host.py); every entry point has a numpy fallback.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC cf_host.cpp -o libcf_host.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Materialize dense float32 rows from a CSR matrix: out[i, :] = csr[row_ids[i], :].
void csr_gather_dense(const int64_t* indptr, const int32_t* indices, const float* data,
                      int64_t n_cols, const int64_t* row_ids, int64_t n_rows_out,
                      float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_rows_out; ++i) {
    float* dst = out + i * n_cols;
    std::memset(dst, 0, sizeof(float) * n_cols);
    const int64_t r = row_ids[i];
    for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
      dst[indices[p]] = data[p];
    }
  }
}

// Per-user non-interaction lists, concatenated. offsets[u]..offsets[u+1]
// delimit user u's zero-column indices (cython_utils.get_non_interactions).
void non_interactions(const int64_t* indptr, const int32_t* indices, int64_t n_users,
                      int64_t n_items, int32_t* out, int64_t* offsets) {
  offsets[0] = 0;
  for (int64_t u = 0; u < n_users; ++u) {
    offsets[u + 1] = offsets[u] + (n_items - (indptr[u + 1] - indptr[u]));
  }
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t u = 0; u < n_users; ++u) {
    int32_t* dst = out + offsets[u];
    int64_t p = indptr[u];
    int64_t j = 0;
    for (int64_t item = 0; item < n_items; ++item) {
      if (p < indptr[u + 1] && indices[p] == (int32_t)item) {
        ++p;
      } else {
        dst[j++] = (int32_t)item;
      }
    }
  }
}

// Exact-k without-replacement negative sampling per user: for each user u,
// draw k_u = int(n_zeros(u) * ratio) items uniformly from its zero columns
// (cython_utils.compute_masks semantics, with the zp_ratio bug fixed by the
// caller passing the right ratio). Output is a [n_users, n_items] uint8
// mask. Partial Fisher-Yates over the user's zero list.
void sample_negative_mask(const int64_t* indptr, const int32_t* indices, int64_t n_users,
                          int64_t n_items, double ratio, uint64_t seed, uint8_t* mask_out) {
#pragma omp parallel
  {
    std::vector<int32_t> zeros;
    zeros.reserve((size_t)n_items);
#pragma omp for schedule(dynamic, 16)
    for (int64_t u = 0; u < n_users; ++u) {
      uint8_t* dst = mask_out + u * n_items;
      std::memset(dst, 0, (size_t)n_items);
      zeros.clear();
      int64_t p = indptr[u];
      for (int64_t item = 0; item < n_items; ++item) {
        if (p < indptr[u + 1] && indices[p] == (int32_t)item) {
          ++p;
        } else {
          zeros.push_back((int32_t)item);
        }
      }
      const int64_t k = (int64_t)((double)zeros.size() * ratio);
      std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + (uint64_t)u);
      for (int64_t j = 0; j < k; ++j) {
        std::uniform_int_distribution<int64_t> pick(j, (int64_t)zeros.size() - 1);
        std::swap(zeros[j], zeros[pick(rng)]);
        dst[zeros[j]] = 1;
      }
    }
  }
}

// Inverse-CDF categorical sampling: for each requested row r = rows[i],
// binary-search cdf[r] for a uniform sample (cython_utils.random_choice).
void random_choice_cdf(const float* cdf, int64_t n_items, const int32_t* rows,
                       int64_t n_draws, uint64_t seed, int32_t* out) {
#pragma omp parallel
  {
#ifdef _OPENMP
    const uint64_t tid = (uint64_t)omp_get_thread_num();
#else
    const uint64_t tid = 0;
#endif
    std::mt19937_64 rng(seed ^ (tid * 0xD1342543DE82EF95ULL + 1));
    std::uniform_real_distribution<float> unif(0.0f, 1.0f);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n_draws; ++i) {
      const float* row_cdf = cdf + (int64_t)rows[i] * n_items;
      const float a = unif(rng);
      int64_t lo = 0, hi = n_items;
      while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (row_cdf[mid] < a) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      out[i] = (int32_t)(lo >= n_items ? n_items - 1 : lo);
    }
  }
}

// Build the shuffled (user, item) interaction list of a CSR matrix
// (CAAE.py:193-220's all_interactions + shuffle) in one pass.
void shuffled_interactions(const int64_t* indptr, const int32_t* indices, int64_t n_users,
                           uint64_t seed, int32_t* users_out, int32_t* items_out) {
  int64_t nnz = indptr[n_users];
  int64_t pos = 0;
  for (int64_t u = 0; u < n_users; ++u) {
    for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
      users_out[pos] = (int32_t)u;
      items_out[pos] = indices[p];
      ++pos;
    }
  }
  std::mt19937_64 rng(seed);
  for (int64_t i = nnz - 1; i > 0; --i) {
    std::uniform_int_distribution<int64_t> pick(0, i);
    const int64_t j = pick(rng);
    std::swap(users_out[i], users_out[j]);
    std::swap(items_out[i], items_out[j]);
  }
}

// -- interactions-file parser -------------------------------------------------
//
// Native equivalent of the reference's per-line ratings parse
// (datasets/DataReader.py:275-379 read_interactions): delimiter-separated
// (user, item, rating) columns, multi-char delimiters ("::"), empty lines
// skipped. Output order == file order — the downstream splitter's RNG
// parity depends on within-row interaction order, so the parallel parse
// computes exact per-segment output offsets first.

namespace {

inline bool line_empty(const char* p, const char* e) {
  for (; p < e; ++p) {
    if (*p != ' ' && *p != '\t' && *p != '\r') return false;
  }
  return true;
}

inline void parse_line(const char* p, const char* e, const char* delim, int64_t dlen,
                       int32_t u_col, int32_t i_col, int32_t r_col,
                       int64_t* u, int64_t* it, float* r) {
  const int32_t maxc = std::max(std::max(u_col, i_col), r_col);
  int32_t col = 0;
  const char* f = p;
  while (f < e && col <= maxc) {
    if (col == u_col) *u = strtoll(f, nullptr, 10);
    if (col == i_col) *it = strtoll(f, nullptr, 10);
    if (col == r_col) *r = strtof(f, nullptr);
    const char* q = f;
    while (q + dlen <= e && std::memcmp(q, delim, dlen) != 0) ++q;
    if (q + dlen > e) break;
    f = q + dlen;
    ++col;
  }
}

}  // namespace

// Returns the number of parsed rows. `buf` MUST end with '\n' (the Python
// caller appends one); r_col < 0 emits rating 1.0f for every row.
int64_t parse_interactions(const char* buf, int64_t n, const char* delim, int64_t dlen,
                           int32_t u_col, int32_t i_col, int32_t r_col,
                           int64_t* users, int64_t* items, float* ratings) {
  int T = 1;
#ifdef _OPENMP
  T = omp_get_max_threads();
#endif
  if ((int64_t)T > n) T = 1;
  std::vector<int64_t> seg((size_t)T + 1, 0);
  seg[T] = n;
  for (int t = 1; t < T; ++t) {
    int64_t p = (n * t) / T;
    const char* nl = (const char*)std::memchr(buf + p, '\n', (size_t)(n - p));
    seg[t] = nl ? (nl - buf) + 1 : n;
  }
  for (int t = 1; t <= T; ++t) seg[t] = std::max(seg[t], seg[t - 1]);

  std::vector<int64_t> off((size_t)T + 1, 0);
#pragma omp parallel for schedule(static)
  for (int t = 0; t < T; ++t) {
    int64_t c = 0;
    const char* p = buf + seg[t];
    const char* stop = buf + seg[t + 1];
    while (p < stop) {
      const char* nl = (const char*)std::memchr(p, '\n', (size_t)(stop - p));
      const char* e = nl ? nl : stop;
      if (!line_empty(p, e)) ++c;
      p = e + 1;
    }
    off[t + 1] = c;
  }
  for (int t = 0; t < T; ++t) off[t + 1] += off[t];

#pragma omp parallel for schedule(static)
  for (int t = 0; t < T; ++t) {
    int64_t w = off[t];
    const char* p = buf + seg[t];
    const char* stop = buf + seg[t + 1];
    while (p < stop) {
      const char* nl = (const char*)std::memchr(p, '\n', (size_t)(stop - p));
      const char* e = nl ? nl : stop;
      if (!line_empty(p, e)) {
        int64_t u = 0, it = 0;
        float r = 1.0f;
        parse_line(p, e, delim, dlen, u_col, i_col, r_col, &u, &it, &r);
        users[w] = u;
        items[w] = it;
        ratings[w] = r;
        ++w;
      }
      p = e + 1;
    }
  }
  return off[T];
}

int cf_host_version() { return 2; }

}  // extern "C"
