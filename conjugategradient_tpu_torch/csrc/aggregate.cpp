// Greedy smoothed-aggregation clustering over a strength-graph CSR, the
// host half of precond/amg.py::_aggregate (Vanek's three passes).  Built
// with the host C++ compiler by ops/_build.py (no nvcc), loaded by ctypes.
// The same passes in the same order as the Python loop kept beside it in
// amg.py, so the two give the same aggregates bit for bit.  Sequential by
// construction: pass 1's seeding depends on the order of the rows.
#include <algorithm>
#include <cstdint>

extern "C" {

// |data| is precomputed by the caller; out_agg holds n entries.  Returns
// the number of aggregates; every node is assigned.
int64_t cg_aggregate(int64_t n, const int32_t* indptr, const int32_t* indices,
                     const double* absdata, int64_t* out_agg) {
  std::fill(out_agg, out_agg + n, int64_t{-1});
  int64_t n_agg = 0;
  for (int64_t i = 0; i < n; ++i) {  // pass 1: seed untouched neighbourhoods
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
  for (int64_t i = 0; i < n; ++i) {  // pass 2: attach to the strongest neighbour
    if (out_agg[i] != -1) continue;
    double best = -1.0;
    int64_t best_agg = -1;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t j = indices[k];
      if (j == i || out_agg[j] == -1) continue;
      // strict > keeps numpy argmax's first maximum (columns ascend)
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
