// Native AMG setup kernels (host side).
//
// Replacement for the *native* setup phase the reference gets
// from the AMGX C++ library (torch_amgx.py:140 solver.setup): strength-of-
// connection + greedy aggregation and the Galerkin RAP coarse-operator
// product. The solve phase runs on the device; this setup phase is a host
// graph algorithm with data-dependent shapes, so it is implemented in C++
// (deterministic, single-pass, no Python/scipy in the loop) and reached
// through a ctypes binding (tpu_sparse/native/__init__.py).
//
// Conventions: CSR with int32 indptr/indices, float64 values, symmetric
// pattern (SPD-style operators — the AMG target class). Aggregate ids are
// int64.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Greedy size-targeted aggregation with symmetric strength-of-connection
// |a_ij| >= theta * sqrt(|a_ii a_jj|). Mirrors the AGGREGATION/SIZE_4
// selector behavior the reference configures (torch_amgx.py:50-73).
// Deterministic: nodes visited in index order.
// Returns the number of aggregates; agg_out[i] in [0, n_agg).
int64_t ts_aggregate(int64_t n, const int32_t* indptr,
                     const int32_t* indices, const double* data,
                     double theta, int32_t target_size, int64_t* agg_out) {
  std::vector<double> diag(n, 0.0);
  for (int64_t i = 0; i < n; ++i)
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
      if (indices[k] == i) diag[i] += data[k];

  std::vector<int64_t> agg(n, -1);
  int64_t next = 0;

  // Phase 1: seed an aggregate at each unassigned node, absorbing up to
  // target_size-1 unassigned strong neighbors.
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    agg[i] = next;
    int32_t taken = 1;
    for (int32_t k = indptr[i]; k < indptr[i + 1] && taken < target_size;
         ++k) {
      int32_t j = indices[k];
      if (j == i || agg[j] != -1) continue;
      double thr = theta * std::sqrt(std::fabs(diag[i] * diag[j]));
      if (std::fabs(data[k]) >= thr) {
        agg[j] = next;
        ++taken;
      }
    }
    ++next;
  }

  // Phase 2: merge singleton aggregates into a neighboring aggregate.
  std::vector<int64_t> sizes(next, 0);
  for (int64_t i = 0; i < n; ++i) ++sizes[agg[i]];
  for (int64_t i = 0; i < n; ++i) {
    if (sizes[agg[i]] != 1) continue;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t j = indices[k];
      if (j == i) continue;
      int64_t t = agg[j];
      if (t != agg[i] && sizes[t] < 2 * target_size) {
        --sizes[agg[i]];
        agg[i] = t;
        ++sizes[t];
        break;
      }
    }
  }

  // Compact ids in first-use order (== ascending original id order).
  std::vector<int64_t> remap(next, -1);
  int64_t na = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (remap[agg[i]] == -1) remap[agg[i]] = na++;
    agg_out[i] = remap[agg[i]];
  }
  return na;
}

// Galerkin RAP for a piecewise-constant (unsmoothed-aggregation)
// prolongator: Ac[agg[i], agg[j]] = sum A[i, j]. Parallel by contiguous
// coarse-row ranges (std::thread), balanced by entry counts; each range is
// gathered, sorted and coalesced independently, so the output is
// bit-identical for a fixed thread count (and identical in structure to
// the sequential global sort). Caller provides output buffers of capacity
// >= nnz(A). Returns nnz(Ac), or -1 if the capacity is insufficient.
int64_t ts_rap_pc(int64_t n, int64_t nc, const int32_t* indptr,
                  const int32_t* indices, const double* data,
                  const int64_t* agg, int32_t* indptr_c, int32_t* indices_c,
                  double* data_c, int64_t cap) {
  int64_t nnz = indptr[n];

  // Group fine rows by coarse row (counting sort; deterministic order).
  std::vector<int64_t> grp_cnt(nc + 1, 0);       // entries per coarse row
  std::vector<int64_t> row_cnt(nc + 1, 0);       // fine rows per coarse row
  for (int64_t i = 0; i < n; ++i) {
    row_cnt[agg[i] + 1]++;
    grp_cnt[agg[i] + 1] += indptr[i + 1] - indptr[i];
  }
  for (int64_t r = 0; r < nc; ++r) {
    row_cnt[r + 1] += row_cnt[r];
    grp_cnt[r + 1] += grp_cnt[r];
  }
  std::vector<int64_t> rows_by_agg(n);
  {
    std::vector<int64_t> cur(row_cnt.begin(), row_cnt.end() - 1);
    for (int64_t i = 0; i < n; ++i) rows_by_agg[cur[agg[i]]++] = i;
  }

  int nt = (int)std::min<int64_t>(
      std::max(1u, std::thread::hardware_concurrency()),
      std::max<int64_t>(nnz / (1 << 18), 1));
  // Contiguous coarse-row ranges with ~equal entry counts.
  std::vector<int64_t> range(nt + 1, nc);
  range[0] = 0;
  for (int t = 1; t < nt; ++t) {
    int64_t target = grp_cnt[nc] * t / nt;
    range[t] = std::lower_bound(grp_cnt.begin(), grp_cnt.begin() + nc + 1,
                                target) - grp_cnt.begin();
    if (range[t] > nc) range[t] = nc;
  }
  for (int t = 1; t <= nt; ++t) range[t] = std::max(range[t], range[t - 1]);

  std::vector<std::vector<int32_t>> out_idx(nt);
  std::vector<std::vector<double>> out_val(nt);
  std::vector<std::vector<int32_t>> out_rcnt(nt);  // nnz per coarse row

  auto work = [&](int t) {
    std::vector<std::pair<int32_t, double>> buf;
    out_rcnt[t].assign(range[t + 1] - range[t], 0);
    for (int64_t r = range[t]; r < range[t + 1]; ++r) {
      buf.clear();
      for (int64_t q = row_cnt[r]; q < row_cnt[r + 1]; ++q) {
        int64_t i = rows_by_agg[q];
        for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
          buf.emplace_back((int32_t)agg[indices[k]], data[k]);
      }
      std::sort(buf.begin(), buf.end(),
                [](const auto& a, const auto& b) {
                  return a.first < b.first ||
                         (a.first == b.first && a.second < b.second);
                });
      int32_t cnt = 0;
      for (size_t k = 0; k < buf.size();) {
        int32_t c = buf[k].first;
        double v = 0.0;
        while (k < buf.size() && buf[k].first == c) v += buf[k++].second;
        out_idx[t].push_back(c);
        out_val[t].push_back(v);
        ++cnt;
      }
      out_rcnt[t][r - range[t]] = cnt;
    }
  };
  if (nt == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }

  int64_t out = 0;
  for (int t = 0; t < nt; ++t) out += (int64_t)out_idx[t].size();
  if (out > cap) return -1;

  indptr_c[0] = 0;
  int64_t pos = 0, rr = 0;
  for (int t = 0; t < nt; ++t) {
    std::copy(out_idx[t].begin(), out_idx[t].end(), indices_c + pos);
    std::copy(out_val[t].begin(), out_val[t].end(), data_c + pos);
    pos += (int64_t)out_idx[t].size();
    for (int64_t r = range[t]; r < range[t + 1]; ++r, ++rr)
      indptr_c[rr + 1] = indptr_c[rr] + out_rcnt[t][r - range[t]];
  }
  return out;
}

// Row L1 norms (the L1-Jacobi smoother diagonal). Row-parallel.
void ts_l1_row_norms(int64_t n, const int32_t* indptr, const double* data,
                     double* out) {
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t i = r0; i < r1; ++i) {
      double s = 0.0;
      for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
        s += std::fabs(data[k]);
      out[i] = s;
    }
  };
  int64_t nnz = indptr[n];
  int nt = (int)std::min<int64_t>(
      std::max(1u, std::thread::hardware_concurrency()),
      std::max<int64_t>(nnz / (1 << 20), 1));
  if (nt <= 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t)
    threads.emplace_back(work, n * t / nt, n * (t + 1) / nt);
  for (auto& th : threads) th.join();
}

}  // extern "C" (reopened below — template needs C++ linkage)

// DIA (row-indexed diagonals: data[d*n + i] = A[i, i + offs[d]]) → CSR.
// offs_sorted must be ascending; dorder[dpos] is the original diagonal
// index of sorted position dpos. Emits explicit in-band zeros (pattern
// semantics) with sorted column indices. indptr is computed by the caller
// (cheap closed form); this kernel fills data/indices row-parallel — the
// multithreaded writes also parallelize first-touch page faults, which
// dominate large fresh numpy allocations on microVM hosts.
template <typename T>
static void dia_to_csr_impl(int64_t n, int64_t m, int64_t ndiag,
                            const int64_t* offs_sorted, const int64_t* dorder,
                            const T* data, const int64_t* indptr, T* out,
                            int32_t* indices) {
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t i = r0; i < r1; ++i) {
      // valid sorted diagonals at row i: offs in [-i, m - i)
      int64_t lo = std::lower_bound(offs_sorted, offs_sorted + ndiag, -i) -
                   offs_sorted;
      int64_t hi = std::lower_bound(offs_sorted, offs_sorted + ndiag, m - i) -
                   offs_sorted;
      int64_t p = indptr[i];
      for (int64_t dpos = lo; dpos < hi; ++dpos, ++p) {
        out[p] = data[dorder[dpos] * n + i];
        indices[p] = (int32_t)(i + offs_sorted[dpos]);
      }
    }
  };
  int nt = (int)std::min<int64_t>(
      std::max(1u, std::thread::hardware_concurrency()),
      std::max<int64_t>((n * ndiag) / (1 << 20), 1));
  if (nt <= 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t)
    threads.emplace_back(work, n * t / nt, n * (t + 1) / nt);
  for (auto& th : threads) th.join();
}

extern "C" {

void ts_dia_to_csr_f64(int64_t n, int64_t m, int64_t ndiag,
                       const int64_t* offs_sorted, const int64_t* dorder,
                       const double* data, const int64_t* indptr, double* out,
                       int32_t* indices) {
  dia_to_csr_impl<double>(n, m, ndiag, offs_sorted, dorder, data, indptr, out,
                          indices);
}

void ts_dia_to_csr_f32(int64_t n, int64_t m, int64_t ndiag,
                       const int64_t* offs_sorted, const int64_t* dorder,
                       const float* data, const int64_t* indptr, float* out,
                       int32_t* indices) {
  dia_to_csr_impl<float>(n, m, ndiag, offs_sorted, dorder, data, indptr, out,
                         indices);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CWELL packing (sparse/cwell.py csr_to_cwell, C++ fast path).
//
// The numpy pack is ~20 full passes over nnz-sized intermediates; on this
// host fresh-page population costs ~6 s/GB, so a 110M-nnz pack took ~95 s.
// Here: two streaming passes over the CSR arrays (plane counting, then
// fill), threaded over row blocks, writing each output element exactly
// once. Requires column-sorted CSR indices (scipy canonical form).
// ---------------------------------------------------------------------------

namespace {

constexpr int kLW = 128;   // lanes per row block
constexpr int kWinShift = 8;  // window width 256 = 1 << 8

struct WinInfo {
  int32_t win;
  int32_t planes;
  int32_t base;
};

// Collect, per row block [r0, r1), each column window's plane need
// (max per-row run length) in ascending window order.
inline void scan_block(int64_t r0, int64_t r1, const int64_t* indptr,
                       const int32_t* indices, std::vector<WinInfo>& wins) {
  wins.clear();
  for (int64_t r = r0; r < r1; ++r) {
    int64_t p = indptr[r], e = indptr[r + 1];
    while (p < e) {
      int32_t w = indices[p] >> kWinShift;
      int32_t c = 0;
      while (p < e && (indices[p] >> kWinShift) == w) {
        ++p;
        ++c;
      }
      bool found = false;
      for (auto& kv : wins) {
        if (kv.win == w) {
          if (c > kv.planes) kv.planes = c;
          found = true;
          break;
        }
      }
      if (!found) wins.push_back({w, c, 0});
    }
  }
  std::sort(wins.begin(), wins.end(),
            [](const WinInfo& a, const WinInfo& b) { return a.win < b.win; });
  int32_t base = 0;
  for (auto& kv : wins) {
    kv.base = base;
    base += kv.planes;
  }
}

template <typename T>
void cwell_fill_impl(int64_t n, int64_t m, int64_t S, int64_t rmax,
                     const int64_t* indptr, const int32_t* indices,
                     const T* data, T* vals, int32_t* idx2, int32_t* srow) {
  int64_t nb = (n + kLW - 1) / kLW;
  int nt = (int)std::min<int64_t>(
      nb, std::max(1u, std::thread::hardware_concurrency()));
  auto work = [&](int t) {
    std::vector<WinInfo> wins;
    wins.reserve(64);
    for (int64_t b = t; b < nb; b += nt) {
      int64_t r0 = b * kLW, r1 = std::min(n, r0 + kLW);
      scan_block(r0, r1, indptr, indices, wins);
      // srow per plane of each window
      for (const auto& kv : wins) {
        int32_t sr = (int32_t)std::min<int64_t>((int64_t)kv.win * 2, rmax);
        for (int32_t k = 0; k < kv.planes; ++k)
          srow[b * S + kv.base + k] = sr;
      }
      for (int64_t r = r0; r < r1; ++r) {
        int lane = (int)(r - r0);
        int64_t p = indptr[r], e = indptr[r + 1];
        size_t wi = 0;
        while (p < e) {
          int32_t w = indices[p] >> kWinShift;
          while (wins[wi].win != w) ++wi;  // windows ascend within a row
          int32_t base = wins[wi].base;
          int32_t sr = (int32_t)std::min<int64_t>((int64_t)w * 2, rmax);
          int32_t k = 0;
          while (p < e && (indices[p] >> kWinShift) == w) {
            int64_t slot = (b * S + base + k) * kLW + lane;
            vals[slot] = data[p];
            idx2[slot] = indices[p] - sr * kLW;
            ++p;
            ++k;
          }
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Pass A: planes needed per row block (S_b). Returns nothing; S_b out.
void ts_cwell_planes(int64_t n, const int64_t* indptr,
                     const int32_t* indices, int32_t* S_b) {
  int64_t nb = (n + kLW - 1) / kLW;
  int nt = (int)std::min<int64_t>(
      nb, std::max(1u, std::thread::hardware_concurrency()));
  auto work = [&](int t) {
    std::vector<WinInfo> wins;
    wins.reserve(64);
    for (int64_t b = t; b < nb; b += nt) {
      int64_t r0 = b * kLW, r1 = std::min(n, r0 + kLW);
      scan_block(r0, r1, indptr, indices, wins);
      int32_t total = 0;
      for (const auto& kv : wins) total += kv.planes;
      S_b[b] = total;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto& th : threads) th.join();
}

void ts_cwell_fill_f32(int64_t n, int64_t m, int64_t S, int64_t rmax,
                       const int64_t* indptr, const int32_t* indices,
                       const float* data, float* vals, int32_t* idx2,
                       int32_t* srow) {
  cwell_fill_impl<float>(n, m, S, rmax, indptr, indices, data, vals, idx2,
                         srow);
}

void ts_cwell_fill_f64(int64_t n, int64_t m, int64_t S, int64_t rmax,
                       const int64_t* indptr, const int32_t* indices,
                       const double* data, double* vals, int32_t* idx2,
                       int32_t* srow) {
  cwell_fill_impl<double>(n, m, S, rmax, indptr, indices, data, vals, idx2,
                          srow);
}

}  // extern "C"
