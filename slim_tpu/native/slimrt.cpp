// slim_tpu native runtime: host-side sparse kernels.
//
// Components:
//   * slim_cd_learn  - OpenMP coordinate-descent SLIM solver over CSC
//     columns.  Implements the same per-column elastic-net nonneg problem
//     as the device solver (see slim_tpu/ops/cd_kernel.py and SURVEY.md §0);
//     used as the measured CPU baseline in bench.py and as a host fallback
//     backend.  Written from the mathematical spec:
//       min 1/2||y - Ax||^2 + l2r/2||x||^2 + l1r||x||_1,  x >= 0, x_j = 0
//     active set {i != j : a_i.y > l1r}; coordinate update
//       x_i <- max(a_i.(y - yhat_{-i}) - l1r, 0) / (||a_i||^2 + l2r)
//     stop when sum (dx)^2 < optTol or after min(50*nnz_j, maxniters)
//     sweeps.
//   * slim_gram_dense - threaded sparse Gram (A^T A) into a dense buffer,
//     the host path for feeding the device solver when the matrix is too
//     sparse for the dense-matmul Gram to be worthwhile.
//   * slim_parse_csr  - fast text parser for the csr/cluto rating formats.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ------------------------------------------------------------------ //
// memory management for buffers returned to python
// ------------------------------------------------------------------ //
void slim_free(void *p) { std::free(p); }

// ------------------------------------------------------------------ //
// coordinate descent learn
// ------------------------------------------------------------------ //
// Inputs: CSC view of the (users x items) matrix.  colval == nullptr
// means implicit 1.0 ratings.  Outputs are malloc'd CSC arrays of the
// model (column j holds the solution for item j); caller must
// slim_free them.  Returns total nnz, or -1 on error.
int64_t slim_cd_learn(int32_t nrows, int32_t ncols, const int64_t *colptr,
                      const int32_t *colind, const float *colval,
                      double l1r, double l2r, double optTol,
                      int32_t maxniters, int32_t shuffle, uint64_t seed,
                      int32_t nthreads,
                      int64_t **out_colptr, int32_t **out_colind,
                      float **out_colval, double *out_err, double *out_obj) {
  if (nthreads > 0) {
#ifdef _OPENMP
    omp_set_num_threads(nthreads);
#endif
  }

  // squared column norms = diag of the Gram
  std::vector<double> cnorm2(ncols, 0.0);
  for (int32_t c = 0; c < ncols; ++c) {
    double s = 0.0;
    for (int64_t p = colptr[c]; p < colptr[c + 1]; ++p) {
      double v = colval ? colval[p] : 1.0;
      s += v * v;
    }
    cnorm2[c] = s;
  }

  std::vector<std::vector<int32_t>> res_ind(ncols);
  std::vector<std::vector<float>> res_val(ncols);
  double err_total = 0.0, obj_total = 0.0;

#pragma omp parallel reduction(+ : err_total, obj_total)
  {
    std::vector<double> y(nrows, 0.0), yhat(nrows, 0.0);
    std::vector<double> x(ncols, 0.0), aty(ncols, 0.0);
    std::vector<int32_t> active;
    active.reserve(ncols);
    uint64_t rng_state = seed + 0x9e3779b97f4a7c15ULL;
#ifdef _OPENMP
    rng_state += (uint64_t)omp_get_thread_num() * 0x100000001b3ULL;
#endif
    auto next_rand = [&rng_state]() {
      // xorshift64*
      rng_state ^= rng_state >> 12;
      rng_state ^= rng_state << 25;
      rng_state ^= rng_state >> 27;
      return rng_state * 0x2545F4914F6CDD1DULL;
    };

#pragma omp for schedule(dynamic, 32)
    for (int32_t j = 0; j < ncols; ++j) {
      // scatter the target column
      for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p)
        y[colind[p]] = colval ? colval[p] : 1.0;

      // aty[i] = a_i . y for every column (the O(nnz) screen)
      active.clear();
      for (int32_t i = 0; i < ncols; ++i) {
        double ip = 0.0;
        for (int64_t p = colptr[i]; p < colptr[i + 1]; ++p)
          ip += (colval ? colval[p] : 1.0) * y[colind[p]];
        aty[i] = ip;
        if (ip > l1r && i != j) active.push_back(i);
      }

      int64_t nnzj = colptr[j + 1] - colptr[j];
      int32_t cap = (int32_t)std::min<int64_t>(50 * nnzj, maxniters);

      // CD sweeps
      for (int32_t t = 0; t < cap; ++t) {
        double dltx = 0.0;
        if (shuffle) {
          for (size_t k = 0; k < active.size(); ++k) {
            size_t m = next_rand() % active.size();
            std::swap(active[k], active[m]);
          }
        }
        for (int32_t i : active) {
          double xi = x[i];
          // remove x_i's contribution, take the inner product, restore
          double ip = 0.0;
          if (xi != 0.0) {
            for (int64_t p = colptr[i]; p < colptr[i + 1]; ++p) {
              double v = colval ? colval[p] : 1.0;
              yhat[colind[p]] -= xi * v;
            }
          }
          for (int64_t p = colptr[i]; p < colptr[i + 1]; ++p) {
            double v = colval ? colval[p] : 1.0;
            ip += v * yhat[colind[p]];
          }
          double num = aty[i] - ip;
          double nx = num > l1r ? (num - l1r) / (cnorm2[i] + l2r) : 0.0;
          if (nx != 0.0) {
            for (int64_t p = colptr[i]; p < colptr[i + 1]; ++p) {
              double v = colval ? colval[p] : 1.0;
              yhat[colind[p]] += nx * v;
            }
          }
          x[i] = nx;
          dltx += (nx - xi) * (nx - xi);
        }
        if (dltx < optTol) break;
      }

      // residual + objective
      double rnorm = 0.0;
      for (int32_t r = 0; r < nrows; ++r) {
        double d = y[r] - yhat[r];
        rnorm += d * d;
      }
      rnorm *= 0.5;
      double obj = rnorm;
      for (int32_t i : active)
        obj += 0.5 * l2r * x[i] * x[i] + l1r * std::fabs(x[i]);
      err_total += rnorm;
      obj_total += obj;

      // harvest nonzeros, reset workspace
      for (int32_t i : active) {
        if (std::fabs(x[i]) > 1e-7) {
          res_ind[j].push_back(i);
          res_val[j].push_back((float)x[i]);
        }
        x[i] = 0.0;
      }
      for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p) y[colind[p]] = 0.0;
      std::fill(yhat.begin(), yhat.end(), 0.0);
    }
  }

  int64_t tnnz = 0;
  for (int32_t j = 0; j < ncols; ++j) tnnz += (int64_t)res_ind[j].size();

  auto *optr = (int64_t *)std::malloc(sizeof(int64_t) * (ncols + 1));
  auto *oind = (int32_t *)std::malloc(sizeof(int32_t) * std::max<int64_t>(tnnz, 1));
  auto *oval = (float *)std::malloc(sizeof(float) * std::max<int64_t>(tnnz, 1));
  if (!optr || !oind || !oval) return -1;
  int64_t pos = 0;
  optr[0] = 0;
  for (int32_t j = 0; j < ncols; ++j) {
    // keep ascending coordinate order within each column
    std::memcpy(oind + pos, res_ind[j].data(),
                res_ind[j].size() * sizeof(int32_t));
    std::memcpy(oval + pos, res_val[j].data(),
                res_val[j].size() * sizeof(float));
    pos += (int64_t)res_ind[j].size();
    optr[j + 1] = pos;
  }
  *out_colptr = optr;
  *out_colind = oind;
  *out_colval = oval;
  if (out_err) *out_err = err_total;
  if (out_obj) *out_obj = obj_total;
  return tnnz;
}

// ------------------------------------------------------------------ //
// dense Gram from the CSR view: G[i,j] = sum_u A[u,i] A[u,j]
// ------------------------------------------------------------------ //
// out must hold ldg*ncols floats (row-major, ldg >= ncols); only the
// leading ncols x ncols block is written (plus zero padding).
void slim_gram_dense(int32_t nrows, int32_t ncols, const int64_t *rowptr,
                     const int32_t *rowind, const float *rowval,
                     float *out, int64_t ldg, int32_t nthreads) {
  if (nthreads > 0) {
#ifdef _OPENMP
    omp_set_num_threads(nthreads);
#endif
  }
  std::memset(out, 0, sizeof(float) * (size_t)ldg * (size_t)ldg);
#pragma omp parallel
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
    int nth = omp_get_num_threads();
#else
    int tid = 0, nth = 1;
#endif
    // each thread owns a contiguous band of output rows i
    for (int32_t u = 0; u < nrows; ++u) {
      for (int64_t p = rowptr[u]; p < rowptr[u + 1]; ++p) {
        int32_t i = rowind[p];
        if ((int64_t)i % nth != tid) continue;
        double vi = rowval ? rowval[p] : 1.0;
        float *gi = out + (int64_t)i * ldg;
        for (int64_t q = rowptr[u]; q < rowptr[u + 1]; ++q) {
          gi[rowind[q]] += (float)(vi * (rowval ? rowval[q] : 1.0));
        }
      }
    }
  }
}

// ------------------------------------------------------------------ //
// top-N prediction over a sparse model (CPU baseline for bench.py)
// ------------------------------------------------------------------ //
// Scoring parity with the device path (and reference predict.c:40-58):
// score[k] = sum_{i in history} rating_i * W[i,k]; history items are
// excluded; a user gets min(#positive-score items, N) recommendations.
// W is CSR over items (rowptr/rowind/rowval, nitems rows); hist is CSR
// over users.  out_ids is (nusers*N) int32 (-1 pad), out_scores f32.
void slim_predict_topn(int32_t nusers, int32_t nitems,
                       const int64_t *wptr, const int32_t *wind,
                       const float *wval, const int64_t *hptr,
                       const int32_t *hind, const float *hval, int32_t N,
                       int32_t *out_ids, float *out_scores,
                       int32_t *out_counts, int32_t nthreads) {
  if (nthreads > 0) {
#ifdef _OPENMP
    omp_set_num_threads(nthreads);
#endif
  }
#pragma omp parallel
  {
    std::vector<float> score((size_t)nitems);
    std::vector<int32_t> touched;
    touched.reserve(4096);
#pragma omp for schedule(dynamic, 16)
    for (int32_t u = 0; u < nusers; ++u) {
      touched.clear();
      for (int64_t p = hptr[u]; p < hptr[u + 1]; ++p) {
        int32_t i = hind[p];
        if (i < 0 || i >= nitems) continue;
        float r = hval ? hval[p] : 1.0f;
        for (int64_t q = wptr[i]; q < wptr[i + 1]; ++q) {
          int32_t k = wind[q];
          if (score[k] == 0.0f) touched.push_back(k);
          score[k] += r * wval[q];
        }
      }
      // mark history (reference marker = -2, predict.c:33-37)
      for (int64_t p = hptr[u]; p < hptr[u + 1]; ++p) {
        int32_t i = hind[p];
        if (i >= 0 && i < nitems) {
          if (score[i] == 0.0f) touched.push_back(i);
          score[i] = -1.0f;
        }
      }
      // partial top-N over the touched candidates
      int32_t *ids = out_ids + (int64_t)u * N;
      float *scs = out_scores + (int64_t)u * N;
      int32_t cnt = 0;
      for (int32_t k : touched) {
        float s = score[k];
        score[k] = 0.0f;  // reset now; also guards duplicate touched ids
        if (s <= 0.0f) continue;
        if (cnt < N) {
          ids[cnt] = k;
          scs[cnt] = s;
          ++cnt;
          for (int32_t t = cnt - 1; t > 0 && scs[t] > scs[t - 1]; --t) {
            std::swap(scs[t], scs[t - 1]);
            std::swap(ids[t], ids[t - 1]);
          }
        } else if (s > scs[N - 1]) {
          scs[N - 1] = s;
          ids[N - 1] = k;
          for (int32_t t = N - 1; t > 0 && scs[t] > scs[t - 1]; --t) {
            std::swap(scs[t], scs[t - 1]);
            std::swap(ids[t], ids[t - 1]);
          }
        }
      }
      for (int32_t t = cnt; t < N; ++t) {
        ids[t] = -1;
        scs[t] = 0.0f;
      }
      out_counts[u] = cnt;
    }
  }
}

// ------------------------------------------------------------------ //
// fast whitespace tokeniser for csr-style text files
// ------------------------------------------------------------------ //
// Parses up to max_tokens doubles from buf; returns count.  Newlines are
// recorded in line_breaks (token index where each line ends).
int64_t slim_parse_tokens(const char *buf, int64_t len, double *out,
                          int64_t max_tokens, int64_t *line_breaks,
                          int64_t *n_lines) {
  int64_t ntok = 0, nline = 0;
  const char *p = buf, *end = buf + len;
  while (p < end && ntok < max_tokens) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    if (p < end && *p == '\n') {
      line_breaks[nline++] = ntok;
      ++p;
      continue;
    }
    if (p >= end) break;
    char *next = nullptr;
    double v = std::strtod(p, &next);
    if (next == p) { ++p; continue; }
    out[ntok++] = v;
    p = next;
  }
  if (len > 0 && buf[len - 1] != '\n') line_breaks[nline++] = ntok;
  *n_lines = nline;
  return ntok;
}

// ------------------------------------------------------------------ //
// parallel CSR assembly from COO fragments
// ------------------------------------------------------------------ //
// Builds a row-sorted CSR from nfrag COO fragments (rows/cols/vals
// triplet arrays).  Caller guarantees no duplicate (row, col) pairs and
// rows in [0, nrows) -- the model-harvest contract (each (coord, target)
// appears exactly once; see solvers/cd.py assembly).  Replaces the
// host assembly pipeline `np.concatenate x3 -> scipy coo->csr ->
// sort_indices` (~6 s single-threaded at the 34M-entry ML-20M model)
// with one threaded counting sort + per-row column sorts.
//
// indptr must hold nrows+1 int64; indices/data must hold sum(sizes).
void slim_csr_from_blocks(int32_t nfrag, const int32_t *const *rows_list,
                          const int32_t *const *cols_list,
                          const float *const *vals_list,
                          const int64_t *sizes, int32_t nrows,
                          int64_t *indptr, int32_t *indices, float *data) {
  // 1. row histogram (thread-local, merged)
  std::vector<int64_t> hist(nrows, 0);
#pragma omp parallel
  {
    std::vector<int64_t> loc(nrows, 0);
#pragma omp for schedule(dynamic) nowait
    for (int32_t f = 0; f < nfrag; ++f) {
      const int32_t *r = rows_list[f];
      const int64_t sz = sizes[f];
      for (int64_t i = 0; i < sz; ++i) ++loc[r[i]];
    }
#pragma omp critical
    for (int32_t row = 0; row < nrows; ++row) hist[row] += loc[row];
  }
  // 2. prefix sum -> indptr; cursors start at the row offsets
  indptr[0] = 0;
  for (int32_t row = 0; row < nrows; ++row)
    indptr[row + 1] = indptr[row] + hist[row];
  std::vector<int64_t> cur(indptr, indptr + nrows);
  // 3. placement: atomic per-row cursors keep fragments parallel without
  //    per-(fragment, row) offset tables (which would be nfrag*nrows --
  //    32 GB at a 2M-item catalogue's 2000 blocks)
#pragma omp parallel for schedule(dynamic)
  for (int32_t f = 0; f < nfrag; ++f) {
    const int32_t *r = rows_list[f];
    const int32_t *c = cols_list[f];
    const float *v = vals_list[f];
    const int64_t sz = sizes[f];
    for (int64_t i = 0; i < sz; ++i) {
      int64_t p;
#pragma omp atomic capture
      p = cur[r[i]]++;
      indices[p] = c[i];
      data[p] = v[i];
    }
  }
  // 4. per-row column sort (the CSR invariant every consumer assumes).
  //    Keys are < nrows (the model is square), so an LSD byte-radix needs
  //    only 2 passes below 65536 columns -- ~3x fewer memory touches than
  //    std::sort's ~log2(m) compare-swap passes at the model's ~1e3-wide
  //    rows.  Short rows keep std::sort (radix setup dominates there).
  int radix_passes = 0;
  for (uint32_t v = (nrows > 1) ? (uint32_t)(nrows - 1) : 0; v; v >>= 8)
    ++radix_passes;
#pragma omp parallel
  {
    std::vector<std::pair<int32_t, float>> tmp, tmp2;
#pragma omp for schedule(dynamic, 256)
    for (int32_t row = 0; row < nrows; ++row) {
      const int64_t s = indptr[row], e = indptr[row + 1];
      const int64_t m = e - s;
      if (m < 2) continue;
      bool sorted = true;
      for (int64_t i = s + 1; i < e; ++i)
        if (indices[i] < indices[i - 1]) { sorted = false; break; }
      if (sorted) continue;
      tmp.resize(m);
      for (int64_t i = 0; i < m; ++i)
        tmp[i] = {indices[s + i], data[s + i]};
      if (m >= 128 && radix_passes <= 4) {
        tmp2.resize(m);
        std::pair<int32_t, float> *src = tmp.data(), *dst = tmp2.data();
        for (int pass = 0; pass < radix_passes; ++pass) {
          const int shift = pass * 8;
          int64_t cnt[256] = {0};
          for (int64_t i = 0; i < m; ++i)
            ++cnt[(src[i].first >> shift) & 255];
          int64_t pos = 0;
          for (int b = 0; b < 256; ++b) {
            const int64_t c = cnt[b];
            cnt[b] = pos;
            pos += c;
          }
          for (int64_t i = 0; i < m; ++i)
            dst[cnt[(src[i].first >> shift) & 255]++] = src[i];
          std::swap(src, dst);
        }
        for (int64_t i = 0; i < m; ++i) {
          indices[s + i] = src[i].first;
          data[s + i] = src[i].second;
        }
        continue;
      }
      std::sort(tmp.begin(), tmp.end(),
                [](const std::pair<int32_t, float> &a,
                   const std::pair<int32_t, float> &b) {
                  return a.first < b.first;
                });
      for (int64_t i = 0; i < m; ++i) {
        indices[s + i] = tmp[i].first;
        data[s + i] = tmp[i].second;
      }
    }
  }
}

}  // extern "C"
