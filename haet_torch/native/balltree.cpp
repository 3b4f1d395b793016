// Native exact ball-tree builder (host-side parity / preprocessing library).
//
// Semantics mirror the reference's C++/Cython component
// (reference models/components/balltree/balltree.h + balltree.pyx),
// re-implemented from scratch:
//   * complete binary tree over each batch's points,
//   * split dimension = max spread (balltree.h:32-66),
//   * median partition via std::nth_element (balltree.h:82-101),
//   * max_level = ceil(log2(n)) - 1; leaves hold 2 slots; a singleton leaf
//     duplicates its point with mask=false (balltree.h:136-150),
//   * partition-only builder that re-partitions existing (rotated) leaves
//     target_level times (balltree.h:205-259),
//   * OpenMP parallelism over batch entries (balltree.pyx:287-298).
//
// A copy of the JAX package's native/balltree.cpp for the PyTorch port.
// This library is OFF the hot path: grouping runs on the device
// (haet_torch/ops/ball_groups.py). It exists as (a) the parity oracle for
// tests and (b) a host-side preprocessing option for static point sets
// (e.g. mesh positions known before training).
//
// Build (haet_torch/native/__init__.py does it at first use, into
// haet_torch/_build/):
//   g++ -O3 -std=c++17 -fopenmp -shared -fPIC balltree.cpp -o libballtree.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

using idx_t = int64_t;

// Split dimension = max spread over the active index range.
idx_t max_spread_dim(const double* pts, const idx_t* idx, idx_t lo, idx_t hi,
                     idx_t dim) {
    idx_t best = 0;
    double best_spread = -1.0;
    for (idx_t d = 0; d < dim; ++d) {
        double mn = pts[idx[lo] * dim + d];
        double mx = mn;
        for (idx_t i = lo + 1; i < hi; ++i) {
            const double v = pts[idx[i] * dim + d];
            mn = std::min(mn, v);
            mx = std::max(mx, v);
        }
        const double spread = mx - mn;
        if (spread > best_spread) {
            best_spread = spread;
            best = d;
        }
    }
    return best;
}

void median_partition(const double* pts, idx_t* idx, idx_t lo, idx_t mid,
                      idx_t hi, idx_t dim, idx_t split_dim) {
    std::nth_element(
        idx + lo, idx + mid, idx + hi,
        [pts, dim, split_dim](idx_t a, idx_t b) {
            return pts[a * dim + split_dim] < pts[b * dim + split_dim];
        });
}

// Recursive complete-tree build writing 2 slots per leaf.
void build_rec(const double* pts, idx_t* idx, idx_t* out_idx, uint8_t* out_mask,
               idx_t lo, idx_t hi, idx_t out_lo, idx_t dim, idx_t level,
               idx_t max_level) {
    const idx_t n = hi - lo;
    if (level == max_level) {
        if (n == 1) {
            out_idx[out_lo] = idx[lo];
            out_idx[out_lo + 1] = idx[lo];
            out_mask[out_lo] = 1;
            out_mask[out_lo + 1] = 0;  // duplicate slot
        } else {
            out_idx[out_lo] = idx[lo];
            out_idx[out_lo + 1] = idx[lo + 1];
            out_mask[out_lo] = 1;
            out_mask[out_lo + 1] = 1;
        }
        return;
    }
    const idx_t mid = (lo + hi) / 2;
    if (n > 1) {
        const idx_t d = max_spread_dim(pts, idx, lo, hi, dim);
        median_partition(pts, idx, lo, mid, hi, dim, d);
    }
    const idx_t left_slots = (idx_t(1) << (max_level - level - 1)) * 2;
    build_rec(pts, idx, out_idx, out_mask, lo, mid, out_lo, dim, level + 1,
              max_level);
    build_rec(pts, idx, out_idx, out_mask, mid, hi, out_lo + left_slots, dim,
              level + 1, max_level);
}

// Partition-only: split `target_level` times, then copy current order.
void partition_rec(const double* pts, idx_t* idx, idx_t* out_idx, idx_t lo,
                   idx_t hi, idx_t out_lo, idx_t dim, idx_t level,
                   idx_t target_level) {
    const idx_t n = hi - lo;
    if (level == target_level || n <= 1) {
        for (idx_t i = 0; i < n; ++i) out_idx[out_lo + i] = idx[lo + i];
        return;
    }
    const idx_t mid = (lo + hi) / 2;
    const idx_t d = max_spread_dim(pts, idx, lo, hi, dim);
    median_partition(pts, idx, lo, mid, hi, dim, d);
    partition_rec(pts, idx, out_idx, lo, mid, out_lo, dim, level + 1,
                  target_level);
    partition_rec(pts, idx, out_idx, mid, hi, out_lo + (mid - lo), dim,
                  level + 1, target_level);
}

idx_t tree_slots(idx_t n) {
    // max_level = ceil(log2(n)) - 1; num_leaves = 2^max_level; 2 slots/leaf.
    if (n <= 1) return 2;
    idx_t max_level = static_cast<idx_t>(std::ceil(std::log2(double(n)))) - 1;
    if (max_level < 0) max_level = 0;
    return (idx_t(1) << max_level) * 2;
}

}  // namespace

extern "C" {

// Slots needed for one batch of n points.
int64_t haet_tree_slots(int64_t n) { return tree_slots(n); }

// Batched complete-tree build.
//   pts:        [total_points, dim] row-major doubles
//   offsets:    [num_batches + 1] start offsets into pts
//   out_offsets:[num_batches + 1] start offsets into out_idx/out_mask
//                (caller computes via haet_tree_slots)
//   out_idx:    [total_slots] global point indices, tree order
//   out_mask:   [total_slots] 1 = real point, 0 = duplicate pad
// Returns 0 on success.
int64_t haet_build_balltree(const double* pts, int64_t dim,
                            const int64_t* offsets,
                            const int64_t* out_offsets, int64_t num_batches,
                            int64_t* out_idx, uint8_t* out_mask) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t b = 0; b < num_batches; ++b) {
        const idx_t lo = offsets[b], hi = offsets[b + 1];
        const idx_t n = hi - lo;
        if (n <= 0) continue;
        std::vector<idx_t> idx(n);
        for (idx_t i = 0; i < n; ++i) idx[i] = lo + i;
        idx_t max_level =
            n <= 1 ? 0
                   : std::max<idx_t>(
                         0, static_cast<idx_t>(std::ceil(std::log2(double(n)))) - 1);
        build_rec(pts, idx.data(), out_idx, out_mask, 0, n, out_offsets[b], dim,
                  0, max_level);
    }
    return 0;
}

// Batched partition-only build over existing (e.g. rotated) leaf orderings.
//   Same layout as above but out arrays have one slot per input point.
int64_t haet_partition_balltree(const double* pts, int64_t dim,
                                const int64_t* offsets, int64_t num_batches,
                                int64_t target_level, int64_t* out_idx) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t b = 0; b < num_batches; ++b) {
        const idx_t lo = offsets[b], hi = offsets[b + 1];
        const idx_t n = hi - lo;
        if (n <= 0) continue;
        std::vector<idx_t> idx(n);
        for (idx_t i = 0; i < n; ++i) idx[i] = lo + i;
        partition_rec(pts, idx.data(), out_idx, 0, n, lo, dim, 0, target_level);
    }
    return 0;
}

int64_t haet_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
