// Native host-side format converters (ctypes ABI).
//
// Counterpart of the reference's C++ converter layer (L3 in SURVEY.md §1:
// matrix_csr.cpp, wsp.cpp, awsp.cpp ...). The algorithms are the packed
// layouts defined in tpusparse/formats/*.py — NOT the reference's
// bit orders — implemented as streaming single-pass packers with OpenMP
// over independent column tiles. Python falls back to vectorized numpy when
// this library is unavailable; results are bit-identical (tested).
//
// Build: see tpusparse/native/__init__.py (g++ -O3 -shared -fopenmp).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr int64_t kLanes = 128;
}

extern "C" {

// ---------------------------------------------------------------------------
// SELL (formats/sell.py): vals[jb, t, w, r] / idx[jb, t, w, r]
//   jb: column tile (n/128), t: m-window (m/128), w: slot, r: lane (n%128)
// a: dense (mp, np) row-major, mp % 128 == 0, np % 128 == 0.
// ---------------------------------------------------------------------------

// Pass 1: the global max window-column nonzero count (decides W).
int32_t sell_max_window_nnz(const float* a, int64_t mp, int64_t np) {
  const int64_t nt = mp / kLanes;
  const int64_t nb = np / kLanes;
  int32_t global_max = 0;
#pragma omp parallel for reduction(max : global_max) collapse(2)
  for (int64_t jb = 0; jb < nb; ++jb) {
    for (int64_t t = 0; t < nt; ++t) {
      int32_t cnt[kLanes] = {0};
      for (int64_t c = 0; c < kLanes; ++c) {
        const float* row = a + (t * kLanes + c) * np + jb * kLanes;
        for (int64_t r = 0; r < kLanes; ++r) cnt[r] += (row[r] != 0.0f);
      }
      for (int64_t r = 0; r < kLanes; ++r)
        if (cnt[r] > global_max) global_max = cnt[r];
    }
  }
  return global_max;
}

// Pass 2: fill pre-zeroed vals (f32) and idx (int8) arrays of width w.
// Returns 0 on success, -1 if any window-column overflows w.
int32_t sell_fill(const float* a, int64_t mp, int64_t np, int64_t w,
                  float* vals, int8_t* idx) {
  const int64_t nt = mp / kLanes;
  const int64_t nb = np / kLanes;
  int32_t overflow = 0;
#pragma omp parallel for reduction(| : overflow) collapse(2)
  for (int64_t jb = 0; jb < nb; ++jb) {
    for (int64_t t = 0; t < nt; ++t) {
      int32_t cnt[kLanes] = {0};
      const int64_t base = ((jb * nt + t) * w) * kLanes;  // [jb,t,0,0]
      for (int64_t c = 0; c < kLanes; ++c) {
        const float* row = a + (t * kLanes + c) * np + jb * kLanes;
        for (int64_t r = 0; r < kLanes; ++r) {
          const float v = row[r];
          if (v != 0.0f) {
            const int32_t slot = cnt[r]++;
            if (slot >= w) {
              overflow = 1;
              continue;
            }
            vals[base + slot * kLanes + r] = v;
            idx[base + slot * kLanes + r] = static_cast<int8_t>(c);
          }
        }
      }
    }
  }
  return overflow ? -1 : 0;
}

// ---------------------------------------------------------------------------
// CSR of A-transpose (formats/csr.py): row r of the CSR = output column r.
// ---------------------------------------------------------------------------

// Pass 1: per-output-column nonzero counts -> cnt[n].
void csr_count(const float* a, int64_t m, int64_t n, int32_t* cnt) {
  std::memset(cnt, 0, n * sizeof(int32_t));
#pragma omp parallel
  {
#pragma omp for
    for (int64_t j = 0; j < n; ++j) {
      int32_t c = 0;
      for (int64_t i = 0; i < m; ++i) c += (a[i * n + j] != 0.0f);
      cnt[j] = c;
    }
  }
}

// Pass 2: fill col_idx / values given row_ptr (exclusive prefix of cnt,
// length n+1, computed by the caller).
void csr_fill(const float* a, int64_t m, int64_t n, const int32_t* row_ptr,
              int32_t* col_idx, float* values) {
#pragma omp parallel for
  for (int64_t j = 0; j < n; ++j) {
    int32_t p = row_ptr[j];
    for (int64_t i = 0; i < m; ++i) {
      const float v = a[i * n + j];
      if (v != 0.0f) {
        col_idx[p] = static_cast<int32_t>(i);
        values[p] = v;
        ++p;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// SELL straight from CSR of A-transpose (formats/sell.py sell_pack_csr):
// entries of output column c are sorted by m; rank resets per 128-row
// window. Parallel over columns (each column owns disjoint (slot, r=c%128)
// cells). Returns max window-column nnz seen, or -1 on overflow of w
// (w <= 0 means "count only": vals/idx may be null).
// ---------------------------------------------------------------------------

int32_t sell_fill_csr(const int32_t* row_ptr, const int32_t* col_idx,
                      const float* values, int64_t n, int64_t nt, int64_t w,
                      float* vals, int8_t* idx) {
  int32_t global_max = 0;
  int32_t overflow = 0;
#pragma omp parallel for reduction(max : global_max) reduction(| : overflow)
  for (int64_t c = 0; c < n; ++c) {
    const int64_t jb = c / kLanes;
    const int64_t r = c % kLanes;
    int64_t cur_t = -1;
    int32_t slot = 0;
    for (int32_t k = row_ptr[c]; k < row_ptr[c + 1]; ++k) {
      const int64_t m = col_idx[k];
      const int64_t t = m / kLanes;
      if (t != cur_t) {
        cur_t = t;
        slot = 0;
      }
      if (slot + 1 > global_max) global_max = slot + 1;
      if (w > 0) {
        if (slot >= w) {
          overflow = 1;
          ++slot;
          continue;
        }
        const int64_t base = ((jb * nt + t) * w + slot) * kLanes + r;
        vals[base] = values[k];
        idx[base] = static_cast<int8_t>(m % kLanes);
      }
      ++slot;
    }
  }
  return overflow ? -1 : global_max;
}

// ---------------------------------------------------------------------------
// RSELL (formats/rsell.py): ragged SELL as a flat stream of 8-slot chunks.
// Pass 1: per-(group, window) tile width demand over the dense tile grid
// (nb * nt int32 — e.g. 153k entries at 50k^2, trivial); python derives
// kept tiles and exclusive chunk bases from it.
// ---------------------------------------------------------------------------

void rsell_demand_csr(const int32_t* row_ptr, const int32_t* col_idx,
                      int64_t n, int64_t nt, int32_t* demand) {
  const int64_t nb = (n + kLanes - 1) / kLanes;
  std::memset(demand, 0, nb * nt * sizeof(int32_t));
  // parallel over GROUPS: a demand cell is shared by the 128 columns of
  // one group, so group-per-thread keeps the max update race-free
#pragma omp parallel for
  for (int64_t jb = 0; jb < nb; ++jb) {
    const int64_t c_end = (jb + 1) * kLanes < n ? (jb + 1) * kLanes : n;
    for (int64_t c = jb * kLanes; c < c_end; ++c) {
      int64_t cur_t = -1;
      int32_t slot = 0;
      for (int32_t k = row_ptr[c]; k < row_ptr[c + 1]; ++k) {
        const int64_t t = col_idx[k] / kLanes;
        if (t != cur_t) {
          cur_t = t;
          slot = 0;
        }
        ++slot;
        int32_t* d = demand + jb * nt + t;
        if (slot > *d) *d = slot;
      }
    }
  }
}

// Pass 2: fill pre-zeroed chunk arrays. tile_chunk_base[jb*nt + t] is the
// first chunk index of that tile (python computes it from demand), or -1
// for empty tiles. Parallel over columns: each column owns disjoint
// (chunk-sublane, lane r=c%128) cells.
void rsell_fill_csr(const int32_t* row_ptr, const int32_t* col_idx,
                    const float* values, int64_t n, int64_t nt,
                    const int64_t* tile_chunk_base, float* vals,
                    int8_t* idx) {
#pragma omp parallel for
  for (int64_t c = 0; c < n; ++c) {
    const int64_t jb = c / kLanes;
    const int64_t r = c % kLanes;
    int64_t cur_t = -1;
    int32_t slot = 0;
    for (int32_t k = row_ptr[c]; k < row_ptr[c + 1]; ++k) {
      const int64_t m = col_idx[k];
      const int64_t t = m / kLanes;
      if (t != cur_t) {
        cur_t = t;
        slot = 0;
      }
      const int64_t chunk = tile_chunk_base[jb * nt + t] + slot / 8;
      const int64_t pos = (chunk * 8 + slot % 8) * kLanes + r;
      vals[pos] = values[k];
      idx[pos] = static_cast<int8_t>(m % kLanes);
      ++slot;
    }
  }
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// AMG standard aggregation (amg.py _aggregate): the Vanek '96 3-pass over
// the strength graph |a_ij| >= theta * sqrt(|a_ii a_jj|) + 1e-300.
// Sequential by nature (greedy over node order — parity with the numpy
// reference path is asserted in tests), but C beats a 1M-iteration Python
// loop by ~two orders of magnitude. absdata/diagabs are float64 so the
// strength comparisons match the numpy float64 setup bit-for-bit.
// Returns the aggregate count; agg[i] in [0, n_agg).
// ---------------------------------------------------------------------------

int64_t amg_aggregate(const int32_t* indptr, const int32_t* indices,
                      const double* absdata, const double* diagabs,
                      int64_t n, double theta, int64_t* agg) {
  for (int64_t i = 0; i < n; ++i) agg[i] = -1;
  auto strong = [&](int64_t i, int64_t e) {
    const int64_t j = indices[e];
    return j != i &&
           absdata[e] >= theta * std::sqrt(diagabs[i] * diagabs[j]) + 1e-300;
  };
  int64_t next_id = 0;
  // pass 1: seed aggregates from fully-unaggregated strong neighborhoods
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    bool free_nbrs = true;
    for (int64_t e = indptr[i]; e < indptr[i + 1]; ++e)
      if (strong(i, e) && agg[indices[e]] != -1) { free_nbrs = false; break; }
    if (!free_nbrs) continue;
    agg[i] = next_id;
    for (int64_t e = indptr[i]; e < indptr[i + 1]; ++e)
      if (strong(i, e)) agg[indices[e]] = next_id;
    ++next_id;
  }
  // pass 2: attach leftovers to the strongest pass-1 aggregate (snapshot
  // semantics so attachments don't chain)
  std::vector<int64_t> pass1(agg, agg + n);
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    double best_w = 0.0;
    int64_t best = -1;
    for (int64_t e = indptr[i]; e < indptr[i + 1]; ++e) {
      if (!strong(i, e) || pass1[indices[e]] == -1) continue;
      if (best == -1 || absdata[e] > best_w) {   // first-max, like np.argmax
        best_w = absdata[e];
        best = pass1[indices[e]];
      }
    }
    if (best != -1) agg[i] = best;
  }
  // pass 3: remaining nodes aggregate with what's left around them
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    agg[i] = next_id;
    for (int64_t e = indptr[i]; e < indptr[i + 1]; ++e)
      if (strong(i, e) && agg[indices[e]] == -1) agg[indices[e]] = next_id;
    ++next_id;
  }
  return next_id;
}

}  // extern "C"
