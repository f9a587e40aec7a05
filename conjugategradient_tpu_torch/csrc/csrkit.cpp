// csrkit: the host-side sparse-format kit of conjugategradient_tpu_torch.
//
// A copy of conjugategradient_tpu/native/src/csrkit.cpp, the JAX package's
// kit, with the same C ABI: COO -> CSR assembly, format conversion (CSR ->
// DIA, CSR -> ELL), per-shard halo ranges, the banded |sin(i+j)| generator
// in DIA layout, an OpenMP CSR SpMV and CG (the oracle's policy) and the
// greedy smoothed-aggregation clustering of the AMG setup.  Host code only:
// nothing here touches the card.
//
// Built by conjugategradient_tpu_torch/ops/_build.py::build_host with the
// host C++ compiler and -fopenmp (without it where the compiler has no
// OpenMP), loaded with ctypes by conjugategradient_tpu_torch/native.  The
// port builds without -march=native, so where the JAX kit's compiler
// contracts a*b+c into an FMA the two kits' csrkit_spmv and csrkit_cg may
// differ in the last bits; the conversions, the halo ranges, the generator
// and the aggregation do no rounding that depends on it.
// csrkit_threads (the OpenMP thread count) is this copy's addition.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Sort COO triplets into CSR, summing duplicate (row, col) entries.
// Returns the deduplicated nnz. Output arrays must be sized >= nnz.
int64_t csrkit_coo_to_csr(int64_t n_rows, int64_t nnz,
                          const int32_t* rows, const int32_t* cols,
                          const double* vals, int32_t* out_indptr,
                          int32_t* out_indices, double* out_data,
                          int32_t* out_rowids) {
  std::vector<int64_t> order(nnz);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });
  int64_t out = -1;
  int32_t prev_r = -1, prev_c = -1;
  for (int64_t k = 0; k < nnz; ++k) {
    const int64_t idx = order[k];
    if (rows[idx] == prev_r && cols[idx] == prev_c) {
      out_data[out] += vals[idx];
    } else {
      ++out;
      prev_r = rows[idx];
      prev_c = cols[idx];
      out_rowids[out] = prev_r;
      out_indices[out] = prev_c;
      out_data[out] = vals[idx];
    }
  }
  const int64_t m = out + 1;
  std::memset(out_indptr, 0, sizeof(int32_t) * (n_rows + 1));
  for (int64_t k = 0; k < m; ++k) out_indptr[out_rowids[k] + 1]++;
  for (int64_t i = 0; i < n_rows; ++i) out_indptr[i + 1] += out_indptr[i];
  return m;
}

// CSR SpMV oracle: y = A x.  OpenMP across rows.
void csrkit_spmv(int64_t n_rows, const int32_t* indptr, const int32_t* indices,
                 const double* data, const double* x, double* y) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_rows; ++i) {
    double acc = 0.0;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
      acc += data[k] * x[indices[k]];
    y[i] = acc;
  }
}

// Per-shard exact halo column ranges [minJ, maxJ] from CSR structure —
// the host-time equivalent of the reference's device-side min/max_element
// discovery (Mgcg/cuBlas/MgcgGpu/Mgcg.cu:82-84).
void csrkit_halo_ranges(int64_t num_shards, const int64_t* offsets,
                        const int64_t* counts, const int32_t* indptr,
                        const int32_t* indices, int32_t* out_minj,
                        int32_t* out_maxj) {
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < num_shards; ++s) {
    const int64_t lo = indptr[offsets[s]];
    const int64_t hi = indptr[offsets[s] + counts[s]];
    int32_t mn = static_cast<int32_t>(offsets[s]);
    int32_t mx = static_cast<int32_t>(offsets[s]);
    if (hi > lo) {
      mn = indices[lo];
      mx = indices[lo];
      for (int64_t k = lo + 1; k < hi; ++k) {
        mn = std::min(mn, indices[k]);
        mx = std::max(mx, indices[k]);
      }
    }
    out_minj[s] = mn;
    out_maxj[s] = mx;
  }
}

// Detect the diagonal structure of a CSR matrix: writes a dense histogram of
// present diagonal offsets into present[off + n - 1] and returns the count of
// distinct diagonals.  Used to pick DIA offsets without densifying.
int64_t csrkit_diag_census(int64_t n_rows, const int32_t* indptr,
                           const int32_t* indices, uint8_t* present /* 2n-1 */) {
  std::memset(present, 0, 2 * n_rows - 1);
  for (int64_t i = 0; i < n_rows; ++i)
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
      present[indices[k] - i + n_rows - 1] = 1;
  int64_t cnt = 0;
  for (int64_t d = 0; d < 2 * n_rows - 1; ++d) cnt += present[d];
  return cnt;
}

// CSR -> DIA scatter: data[k*n + i] = A[i, i+offsets[k]].  offsets must be
// sorted ascending and cover every present diagonal.  Returns 0 on success,
// -1 if an entry falls outside the offset set.
int32_t csrkit_csr_to_dia(int64_t n_rows, const int32_t* indptr,
                          const int32_t* indices, const double* vals,
                          int64_t ndiags, const int64_t* offsets,
                          double* data /* ndiags * n, zeroed by caller */) {
  int32_t bad = 0;
#pragma omp parallel for schedule(static) reduction(| : bad)
  for (int64_t i = 0; i < n_rows; ++i) {
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int64_t off = static_cast<int64_t>(indices[k]) - i;
      const int64_t* p = std::lower_bound(offsets, offsets + ndiags, off);
      if (p == offsets + ndiags || *p != off) {
        bad |= 1;
        continue;
      }
      data[(p - offsets) * n_rows + i] += vals[k];
    }
  }
  return bad ? -1 : 0;
}

// CSR -> ELL (diag-first): data/cols are n_rows x width, caller-zeroed, with
// cols prefilled to the row index.  Returns -1 if a row exceeds width.
int32_t csrkit_csr_to_ell(int64_t n_rows, const int32_t* indptr,
                          const int32_t* indices, const double* vals,
                          int64_t width, double* data, int32_t* cols) {
  int32_t bad = 0;
#pragma omp parallel for schedule(static) reduction(| : bad)
  for (int64_t i = 0; i < n_rows; ++i) {
    const int32_t lo = indptr[i], hi = indptr[i + 1];
    if (hi - lo > width) {
      bad |= 1;
      continue;
    }
    int64_t slot = 0;
    // diagonal first, as in the reference's ELL layout
    for (int32_t k = lo; k < hi; ++k) {
      if (indices[k] == i) {
        data[i * width + slot] = vals[k];
        cols[i * width + slot] = indices[k];
        ++slot;
      }
    }
    for (int32_t k = lo; k < hi; ++k) {
      if (indices[k] != i) {
        data[i * width + slot] = vals[k];
        cols[i * width + slot] = indices[k];
        ++slot;
      }
    }
  }
  return bad ? -1 : 0;
}

// Banded |sin(i+j)| SPD generator (the reference's shared fixture,
// Mgcg/cuBlas/Mgcg/MgcgMain.cs:53-84) emitted directly in DIA layout.
// offsets are implicitly -h..h with h = band/2 - 1; data is (2h+1) x n.
void csrkit_banded_sin_dia(int64_t n, int64_t band, double* data) {
  const int64_t h = band / 2 - 1;
  const int64_t nd = 2 * h + 1;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double diag = 0.0;
    for (int64_t k = 0; k < nd; ++k) {
      const int64_t off = k - h;
      if (off == 0) continue;
      const int64_t j = i + off;
      double v = 0.0;
      if (j >= 0 && j < n) v = std::fabs(std::sin(static_cast<double>(i + j)));
      data[k * n + i] = v;
      diag += v;
    }
    data[h * n + i] = diag;
  }
}

// Full CG solve over CSR, OpenMP-parallel — the completed native CPU
// computer the reference left dangling (SimpleConjugateGradientCpu.cpp:35 is
// the whole "loop") and the uBLAS computer's capability
// (Mgcg/ViennaCL/Mgcg/ComputerCpu.cpp:42-98), with the policy contract of
// ConjugateGradient.cs:56-79.  norm: 0 = L2, 1 = Linf, 2 = relative L2.
// Returns iterations on convergence, -(iterations) - 1 if max_iter exhausted.
int64_t csrkit_cg(int64_t n, const int32_t* indptr, const int32_t* indices,
                  const double* data, const double* b, double* x /* in: x0, out */,
                  double tol, int32_t norm, int64_t min_iter, int64_t max_iter,
                  double* out_residual) {
  std::vector<double> r(n), p(n), ap(n);
  auto spmv = [&](const double* v, double* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      double acc = 0.0;
      for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
        acc += data[k] * v[indices[k]];
      out[i] = acc;
    }
  };
  auto dot = [&](const double* u, const double* v) {
    double acc = 0.0;
#pragma omp parallel for schedule(static) reduction(+ : acc)
    for (int64_t i = 0; i < n; ++i) acc += u[i] * v[i];
    return acc;
  };
  auto max_abs = [&](const double* u) {
    double m = 0.0;
#pragma omp parallel for schedule(static) reduction(max : m)
    for (int64_t i = 0; i < n; ++i) m = std::max(m, std::fabs(u[i]));
    return m;
  };

  spmv(x, ap.data());
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    r[i] = b[i] - ap[i];
    p[i] = r[i];
  }
  double rr = dot(r.data(), r.data());
  const double rr0 = rr;
  auto residual = [&](double rr_now) {
    if (norm == 1) return max_abs(r.data());
    if (norm == 2) return rr0 > 0 ? std::sqrt(rr_now / rr0) : 0.0;
    return std::sqrt(rr_now);
  };

  int64_t it = 0;
  double res = residual(rr);
  while (!(it >= min_iter && res < tol)) {
    if (it >= max_iter) {
      *out_residual = res;
      return -it - 1;
    }
    spmv(p.data(), ap.data());
    // zero-denominator guard: if x0 already solves the system (rr == 0) while
    // min_iter forces loop entry, 0/0 would poison x with NaN — match the
    // oracle.cg / solvers.cg _safe_div semantics (0 when the denominator is 0).
    const double pap = dot(p.data(), ap.data());
    const double alpha = pap != 0.0 ? rr / pap : 0.0;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      x[i] += alpha * p[i];
      r[i] -= alpha * ap[i];
    }
    const double rr_new = dot(r.data(), r.data());
    const double beta = rr != 0.0 ? rr_new / rr : 0.0;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) p[i] = r[i] + beta * p[i];
    rr = rr_new;
    ++it;
    res = residual(rr);
  }
  *out_residual = res;
  return it;
}

int32_t csrkit_version() { return 3; }

// Threads an OpenMP region of this library runs on; 0 where it was built
// without OpenMP (every loop serial).
int32_t csrkit_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 0;
#endif
}

// Greedy smoothed-aggregation clustering over a strength-graph CSR —
// the native twin of precond.amg._aggregate (Vaněk's three passes), kept
// bit-for-bit order-identical to the Python reference so hierarchies built
// either way are the same objects.  Sequential by construction (pass 1's
// seeding is order-dependent).  |data| must be precomputed by the caller.
// Returns the number of aggregates; out_agg must be sized n.
int64_t csrkit_aggregate(int64_t n, const int32_t* indptr,
                         const int32_t* indices, const double* absdata,
                         int64_t* out_agg) {
  std::fill(out_agg, out_agg + n, int64_t{-1});
  int64_t n_agg = 0;
  for (int64_t i = 0; i < n; ++i) {  // pass 1: seed untouched neighborhoods
    if (out_agg[i] != -1) continue;
    bool clean = true;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t j = indices[k];
      if (j != i && out_agg[j] != -1) { clean = false; break; }
    }
    if (!clean) continue;
    out_agg[i] = n_agg;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t j = indices[k];
      if (j != i) out_agg[j] = n_agg;
    }
    ++n_agg;
  }
  for (int64_t i = 0; i < n; ++i) {  // pass 2: attach to strongest neighbor
    if (out_agg[i] != -1) continue;
    double best = -1.0;
    int64_t best_agg = -1;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t j = indices[k];
      if (j == i || out_agg[j] == -1) continue;
      // strict > keeps numpy argmax's first-max tie-breaking (CSR column
      // order is ascending, matching the Python slice order)
      if (absdata[k] > best) { best = absdata[k]; best_agg = out_agg[j]; }
    }
    if (best_agg != -1) out_agg[i] = best_agg;
  }
  for (int64_t i = 0; i < n; ++i) {  // pass 3: isolated pockets
    if (out_agg[i] != -1) continue;
    out_agg[i] = n_agg;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t j = indices[k];
      if (out_agg[j] == -1) out_agg[j] = n_agg;
    }
    ++n_agg;
  }
  return n_agg;
}

}  // extern "C"
