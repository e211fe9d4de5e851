// k-reciprocal re-ranking (Zhong et al., CVPR 2017): the host C++ engine
// of pps_tpu_torch (pps_tpu_torch/native.py), a copy of the JAX package's
// pps_tpu/native/rerank.cc.
//
// Same numerics as the numpy golden path (pps_tpu_torch/evaluation/
// rerank.py re_ranking), two structural changes:
//   * per-row partial top-K selection instead of a full argsort
//     (only the top max(k1, k2)+1 neighbors are ever used)
//   * sparse membership vectors V kept as (index, weight) lists end-to-end
//     (the numpy path materializes dense [N, N] V).
//
// Exposed as a plain C ABI for ctypes; built with the host compiler
// (pps_tpu_torch/kernels/build.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

using SparseRow = std::vector<std::pair<int32_t, float>>;  // sorted by index

// top-(k+1) nearest (including self) of row i of the n x n matrix dist,
// ascending by value, ties by index (stable).
void topk_row(const float* dist, int64_t n, int64_t i, int k,
              int32_t* out) {
    const float* row = dist + i * n;
    std::vector<int32_t> idx(n);
    std::iota(idx.begin(), idx.end(), 0);
    int kk = std::min<int64_t>(k + 1, n);
    std::partial_sort(idx.begin(), idx.begin() + kk, idx.end(),
                      [row](int32_t a, int32_t b) {
                          if (row[a] != row[b]) return row[a] < row[b];
                          return a < b;
                      });
    std::copy(idx.begin(), idx.begin() + kk, out);
}

// R(i, k): forward top-(k+1) of i restricted to entries whose own
// top-(k+1) contains i (k-reciprocal set).  k is clamped to the stored
// rank width: with n <= k the whole set is used, matching the
// reference's numpy slicing (initial_rank[i, :k+1] clamps silently,
// reference :470-473) — without the clamp tiny galleries (n < k1)
// read past the partial-rank rows.
void k_reciprocal(const int32_t* ranks, int stride, int64_t i, int k,
                  std::vector<int32_t>* out) {
    out->clear();
    const int lim = std::min(k, stride - 1);
    const int32_t* fwd = ranks + i * stride;
    for (int a = 0; a <= lim; ++a) {
        int32_t cand = fwd[a];
        const int32_t* back = ranks + (int64_t)cand * stride;
        for (int b = 0; b <= lim; ++b) {
            if (back[b] == (int32_t)i) {
                out->push_back(cand);
                break;
            }
        }
    }
}

}  // namespace

extern "C" {

// q_g [nq, ng], q_q [nq, nq], g_g [ng, ng] row-major float32.
// out [nq, ng].  Returns 0 on success.
int pps_rerank(const float* q_g, const float* q_q, const float* g_g,
               int64_t nq, int64_t ng, int k1, int k2, float lambda,
               float* out) {
    const int64_t n = nq + ng;
    const int half_k1 = (int)std::lround(k1 / 2.0);
    const int kmax = std::max(k1, std::max(half_k1, k2));

    // original_dist: squared, column-max normalized, transposed
    // (reference :455-459).  Build the full symmetric matrix first.
    std::vector<float> dist((size_t)n * n);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = 0; j < n; ++j) {
            float v;
            if (i < nq && j < nq) v = q_q[i * nq + j];
            else if (i < nq) v = q_g[i * ng + (j - nq)];
            else if (j < nq) v = q_g[j * ng + (i - nq)];
            else v = g_g[(i - nq) * ng + (j - nq)];
            dist[i * n + j] = v * v;
        }
    }
    // column max -> normalize -> transpose == row-normalize the transpose;
    // dist is symmetric pre-normalization, so transpose(dist / colmax) =
    // dist / rowmax-after... keep it literal: compute column maxes, then
    // out[i][j] = dist[j][i] / colmax[i].  With symmetric dist this equals
    // dist[i][j] / colmax[i] (row scaling).
    std::vector<float> colmax(n, 0.f);
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < n; ++j) {
        float m = 0.f;
        for (int64_t i = 0; i < n; ++i)
            m = std::max(m, dist[i * n + j]);
        colmax[j] = m > 0.f ? m : 1.f;
    }
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const float inv = 1.0f / colmax[i];
        for (int64_t j = 0; j < n; ++j) dist[i * n + j] *= inv;
    }

    // partial ranks: top-(kmax+1) per row
    const int stride = std::min<int64_t>(kmax + 1, n);
    std::vector<int32_t> ranks((size_t)n * stride);
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t i = 0; i < n; ++i)
        topk_row(dist.data(), n, i, stride - 1, ranks.data() + i * stride);

    // V rows: k-reciprocal expansion + gaussian weights (reference :470-496)
    std::vector<SparseRow> V(n);
#pragma omp parallel
    {
        std::vector<int32_t> base, cand, merged;
#pragma omp for schedule(dynamic, 64)
        for (int64_t i = 0; i < n; ++i) {
            k_reciprocal(ranks.data(), stride, i, k1, &base);
            std::vector<int32_t> sorted_base = base;
            std::sort(sorted_base.begin(), sorted_base.end());
            merged = base;
            for (int32_t c : base) {
                k_reciprocal(ranks.data(), stride, c, half_k1, &cand);
                int inter = 0;
                for (int32_t x : cand)
                    if (std::binary_search(sorted_base.begin(),
                                           sorted_base.end(), x))
                        ++inter;
                if (inter > (2.0 / 3.0) * cand.size())
                    merged.insert(merged.end(), cand.begin(), cand.end());
            }
            std::sort(merged.begin(), merged.end());
            merged.erase(std::unique(merged.begin(), merged.end()),
                         merged.end());
            float sum = 0.f;
            SparseRow& row = V[i];
            row.reserve(merged.size());
            for (int32_t j : merged) {
                float w = std::exp(-dist[i * n + j]);
                row.emplace_back(j, w);
                sum += w;
            }
            const float inv = sum > 0.f ? 1.0f / sum : 0.f;
            for (auto& p : row) p.second *= inv;
        }
    }

    // local query expansion: V2[i] = mean of V over i's top-k2 neighbors
    std::vector<SparseRow> V2;
    const std::vector<SparseRow>* Vp = &V;
    if (k2 != 1) {
        V2.resize(n);
        const int k2c = (int)std::min<int64_t>(k2, stride);  // tiny-n clamp
#pragma omp parallel for schedule(dynamic, 64)
        for (int64_t i = 0; i < n; ++i) {
            // merge k2 sorted sparse rows
            std::vector<std::pair<int32_t, float>> acc;
            for (int a = 0; a < k2c; ++a) {
                const SparseRow& r = V[ranks[i * stride + a]];
                acc.insert(acc.end(), r.begin(), r.end());
            }
            std::sort(acc.begin(), acc.end());
            SparseRow& out_row = V2[i];
            const float inv = 1.0f / k2c;  // mean over the rows actually
            // present (numpy mean over a clamped slice divides by its
            // true length)
            for (size_t a = 0; a < acc.size();) {
                int32_t j = acc[a].first;
                float s = 0.f;
                while (a < acc.size() && acc[a].first == j) {
                    s += acc[a].second;
                    ++a;
                }
                out_row.emplace_back(j, s * inv);
            }
        }
        Vp = &V2;
    }
    const std::vector<SparseRow>& Vr = *Vp;

    // inverted index: for column j, rows g with V[g][j] != 0
    std::vector<std::vector<std::pair<int32_t, float>>> inv_index(n);
    for (int64_t g = 0; g < n; ++g)
        for (const auto& p : Vr[g])
            inv_index[p.first].emplace_back((int32_t)g, p.second);

    // jaccard + blend (reference :497-517)
#pragma omp parallel
    {
        std::vector<float> temp_min(n);
#pragma omp for schedule(dynamic, 16)
        for (int64_t i = 0; i < nq; ++i) {
            std::fill(temp_min.begin(), temp_min.end(), 0.f);
            for (const auto& pj : Vr[i]) {
                const float vi = pj.second;
                for (const auto& pg : inv_index[pj.first])
                    temp_min[pg.first] += std::min(vi, pg.second);
            }
            for (int64_t g = 0; g < ng; ++g) {
                const float tm = temp_min[nq + g];
                const float jac = 1.0f - tm / (2.0f - tm);
                out[i * ng + g] = jac * (1.0f - lambda) +
                                  dist[i * n + (nq + g)] * lambda;
            }
        }
    }
    return 0;
}

}  // extern "C"
