// One whole Erwin transformer block, forward and backward, for Hopper
// (sm_90a), float32.
//
// Forward: replaces the Pallas TPU kernel _fwd_kernel of
// haet_tpu/ops/pallas/erwin_block.py (called from _fused_block_impl):
//   xn  = RMSNorm(x) * g1                        (eps 1e-6)
//   hm  = xn + (pos - ball centroid) @ Wpe^T + bpe
//   q,k,v per head = hm @ Wqkv^T + bqkv           (columns ordered 3, h, hd)
//   a   = softmax_ball(q k^T / sqrt(hd) + sigma_h * |p_i - p_j|)
//   x1  = x + (a v) @ Wo^T + bo
//   out = x1 + (t * silu(u)) @ W3^T + b3,  u = zn W1^T + b1, t = zn W2^T + b2,
//         zn = RMSNorm(x1) * g2
//
// What bounds it on an H100: latency, not bytes or FLOP. At the car shapes a
// call is 8 clouds (B*H) of n = 32 points at C = 32, SwiGLU 128 (or n = 16
// at C = 64, SwiGLU 256): ~0.1-0.3 MB and ~2-5 MFLOP, a bound of ~0.2 us,
// against a chain of dependent phases (norm, qkv, attention, Wo, norm,
// SwiGLU, W3) each of which waits on the one before. One CTA per cloud (the
// first design) ran that chain on 8 of the 132 SMs with every product a
// scalar loop waiting on weights in L2.
//
// Design: a thread-block cluster of K CTAs (K = 8, set by the wrapper) per
// cloud, launched with cudaLaunchKernelEx; K * clouds CTAs in all (64 at the
// car's batch 1, 256 at a batch of 4).
//   * Rank r of a cluster owns 1/K of the attention (head, query) pairs and
//     computes q, k and v of the heads those pairs use (a head shared by two
//     ranks is computed by both: no exchange), and 1/K of the Wo columns and
//     of the SwiGLU hidden columns of W1/W2; for W3, which reduces over the
//     hidden dimension, it computes a partial [n, C] from its hidden slice.
//     Row-wise work that every rank needs (RMSNorm, the relative positions,
//     hm) is recomputed by every rank instead of exchanged.
//   * Cluster shared memory (DSMEM): a rank stores its slice into its own
//     copy of the activation (the attention output, x1); after one cluster
//     barrier every rank copies the other ranks' slices out of their shared
//     memory (map_shared_rank), so every rank holds the whole [n, .]
//     activation the next phase reads. Reductions across ranks (the W3
//     partials; in the backward dX = dY W over split output columns) read
//     the K partials in rank order 0..K-1: deterministic, no atomics.
//   * Each rank's weight slices and the block's parameter vectors are copied
//     into its shared memory with cp.async at kernel entry, the weights
//     overlapping RMSNorm 1 and the relative positions; at C = 64 the
//     ~240 KB of weights become ~35 KB per rank, so no product waits on L2.
//   * Per rank at n 32 / C 32 / SwiGLU 128 / 8 heads the forward does ~77 K
//     FMA (qkv 12 K, attention 8 K, Wo 4 K, W1+W2 33 K, W3 16 K, hm 4 K),
//     ~300 per thread, and holds 8.5 KB of weights; at n 16 / C 64 / SwiGLU
//     256, ~135 K FMA and 35 KB. Products stay float32 SIMT FMAs, register-
//     tiled 2x2 from shared memory: a cloud has 16-32 rows, below wgmma's
//     64-row tile, and TF32 would break the float32 policy every parity
//     tolerance rests on.
//   * Buffers: the wrapper (erwin_block.py:fwd_layout/bwd_layout) places them
//     into shared memory in priority order (the exchanged activations, then
//     the parameter vectors and weight slices, then the rank's own buffers);
//     what does not fit goes to a per-CTA global scratch (an exchanged
//     buffer then has K copies there, one per rank, synchronised by the same
//     cluster barriers), and a weight slice that does not fit is read from
//     the weight tensor itself. At the car shapes everything is in shared
//     memory, and the kernels' SMEM instantiation runs.
//   * The distance bias is computed from coordinate differences,
//     sqrt(|d|^2 + 1e-12), as the plain path does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;         // threads per CTA
constexpr int MAX_CLUSTER = 8;  // portable cluster size
constexpr int MAX_BUF = 32;

struct BlockParams {
  const float* g1;    // [c]
  const float* wpe;   // [c, d]
  const float* bpe;   // [c]
  const float* wqkv;  // [3c, c]
  const float* bqkv;  // [3c]
  const float* sigma; // [heads]
  const float* wo;    // [c, c]
  const float* bo;    // [c]
  const float* g2;    // [c]
  const float* w1;    // [hidden, c]
  const float* b1;    // [hidden]
  const float* w2;    // [hidden, c]
  const float* b2;    // [hidden]
  const float* w3;    // [c, hidden]
  const float* b3;    // [c]
};

// i / d and i % d by a multiply with m = ceil(2^32 / d): a runtime integer
// division is ~20 dependent instructions, and the phases' index arithmetic
// is on their critical path. Exact for 0 <= i and i * d < 2^32.
struct FastDiv {
  unsigned d, m;
  __host__ __device__ explicit FastDiv(int div = 1)
      : d(static_cast<unsigned>(div)),
        m(div <= 1 ? 0u : 0xffffffffu / static_cast<unsigned>(div) + 1u) {}
  __device__ int div(int i) const {
    return d == 1 ? i : static_cast<int>(__umulhi(static_cast<unsigned>(i), m));
  }
  __device__ int mod(int i) const { return i - div(i) * static_cast<int>(d); }
};

// Block shapes; n and bs are powers of two (the gate and the ball rule), so
// their divisions are shifts (ln, lbs), and fc, fd, fhd divide by c, d and
// the head width.
struct Dims {
  int n, c, d, heads, bs, hidden, use_dist_bias;
  int ln, lbs;
  FastDiv fc, fd, fhd;
};

// Where each buffer lives: offset in floats, in shared memory (1) or in the
// CTA's global scratch (0), and the scratch floats per CTA.
struct Layout {
  int off[MAX_BUF];
  int in_smem[MAX_BUF];
  int scratch_stride;
};

// The forward's and the backward's buffers, in the order of
// erwin_block.py:FWD_BUFFERS / BWD_BUFFERS (the exchanged ones first, then
// the small parameter vectors and the weight slices, then the rank's own).
enum FwdBuf {
  F_X, F_QKV, F_O, F_VEC, F_WQKVH, F_WQKV, F_WO, F_W1, F_W2, F_W3, F_HM, F_U,
  F_T, F_POS, F_REL, F_RINV, F_P, NFWD
};
enum BwdBuf {
  B_QKV, B_O, B_X1, B_DQKV, B_VEC, B_WQKVH, B_WQKV, B_WO, B_W1, B_W2, B_W3,
  B_X, B_GD, B_HM, B_ZN, B_DZ, B_POS, B_REL, B_R1, B_R2, B_ROW, B_U, B_T, B_G,
  B_P, B_DS, NBWD
};

// A 1/K share [lo, hi) of n items for rank r.
struct Slice {
  int lo, hi;
  __device__ int w() const { return hi - lo; }
};

__device__ __forceinline__ Slice slice_of(int n, int r, int k) {
  return {n * r / k, n * (r + 1) / k};
}

// The cluster, and the buffers of this CTA and of its peers. With SMEM
// every buffer is in shared memory (the layout spilled nothing), so the
// compiler sees shared addresses and emits 32-bit shared loads and stores;
// without, a buffer may live in the global scratch and every access is
// generic.
template <bool SMEM>
struct Ctx {
  int k, rank;
  float* sm;             // this CTA's shared memory
  float* cloud_scratch;  // the cluster's scratch: K CTAs of stride floats
  const Layout* L;
  bool spilled_shared;   // an exchanged buffer lives in the global scratch

  // Buffer b of the CTA of rank q.
  __device__ float* peer(int b, int q) const {
    if (SMEM || L->in_smem[b])
      return cg::this_cluster().map_shared_rank(sm + L->off[b], q);
    return cloud_scratch + static_cast<size_t>(q) * L->scratch_stride +
           L->off[b];
  }
  __device__ bool resident(int b) const { return SMEM || L->in_smem[b]; }
  __device__ float* own(int b) const {
    return SMEM || L->in_smem[b] ? sm + L->off[b]
                                 : cloud_scratch +
                               static_cast<size_t>(rank) * L->scratch_stride +
                               L->off[b];
  }
  // All threads of the cluster; orders shared and global memory at cluster
  // scope. The gpu-scope fences cover copies in the global scratch that
  // another SM wrote.
  __device__ void sync() const {
    if (spilled_shared) __threadfence();
    cg::this_cluster().sync();
    if (spilled_shared) __threadfence();
  }
};

// Latency: every phase is a short chain, so a load from L2 on it (~600
// cycles) costs as much as the phase's arithmetic. Everything the block
// reads from global memory (x, pos, the parameter vectors and the weight
// slices) is copied into shared memory by cp.async at kernel entry, in two
// groups: x, pos and the vectors first, the weights overlapping RMSNorm 1.
// Loops are not unrolled: a launch runs each phase once and fetches its
// instructions from L2 (the forward is ~10 K instructions), so smaller code
// is faster code.

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for all but the newest n committed groups of this thread's copies.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[i * dst_ld + j] = src[i * src_ld + j] for i < rows, j < cols: by
// cp.async into shared memory (the caller commits and waits), by plain
// loads and stores into a buffer the layout put in the global scratch.
__device__ __forceinline__ void stage(float* dst, int dst_ld,
                                      const float* src, int src_ld, int rows,
                                      int cols) {
  const bool shared = __isShared(dst);
  const FastDiv fcols(cols);
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int i = fcols.div(e), j = e - i * cols;
    const float* s = src + static_cast<size_t>(i) * src_ld + j;
    if (shared)
      cp_async4(dst + i * dst_ld + j, s);
    else
      dst[i * dst_ld + j] = *s;
  }
}

// A weight slice: element (i, k) at p[i * ld + k] for the row slices, and
// (j, k) at p[j * ld + k] for W3's column slice ([c, hidden share]).
struct WView {
  const float* p;
  int ld;
};
// This rank's weight slices: the Wqkv rows of the nh heads from hlo on that
// its attention pairs use, per section (q, k, v); its 1/K share of the
// Wqkv rows (the backward's dhm), of the Wo rows, of the W1/W2 rows and of
// the W3 columns.
struct Weights {
  WView qh[3], qkv, o, w1, w2, w3;
  int hlo, nh;
  bool qh_stacked;  // qh[0..2] are consecutive rows of one buffer
};

// This rank's weight slices (buffer wh for the head rows, w0 .. w0 + 4 for
// the others): copies into shared memory issued where the layout keeps
// them there, else views of the weight tensors.
template <class Cx>
__device__ Weights stage_weights(const BlockParams& p, const Cx& x, int wh,
                                 int w0, const Dims& D, Slice s3, Slice sc,
                                 Slice sh, int hlo, int nh) {
  const int c = D.c, hd = D.fhd.d, hidden = D.hidden;
  Weights w;
  w.hlo = hlo;
  w.nh = nh;
  w.qh_stacked = x.resident(wh);
  for (int sec = 0; sec < 3; ++sec) {
    const float* src = p.wqkv + static_cast<size_t>(sec * c + hlo * hd) * c;
    if (x.resident(wh)) {
      float* dst = x.own(wh) + sec * nh * hd * (c + 1);
      w.qh[sec] = {dst, c + 1};
      stage(dst, c + 1, src, c, nh * hd, c);
    } else {
      w.qh[sec] = {src, c};
    }
  }
  const float* src[5] = {p.wqkv + static_cast<size_t>(s3.lo) * c,
                         p.wo + static_cast<size_t>(sc.lo) * c,
                         p.w1 + static_cast<size_t>(sh.lo) * c,
                         p.w2 + static_cast<size_t>(sh.lo) * c,
                         p.w3 + sh.lo};
  const int rows[5] = {s3.w(), sc.w(), sh.w(), sh.w(), c};
  const int cols[5] = {c, c, c, c, sh.w()};
  WView v[5];
  for (int i = 0; i < 5; ++i) {
    const int src_ld = i == 4 ? hidden : c;
    if (x.resident(w0 + i)) {
      v[i] = {x.own(w0 + i), cols[i] + 1};
      stage(x.own(w0 + i), cols[i] + 1, src[i], src_ld, rows[i], cols[i]);
    } else {
      v[i] = {src[i], src_ld};
    }
  }
  w.qkv = v[0];
  w.o = v[1];
  w.w1 = v[2];
  w.w2 = v[3];
  w.w3 = v[4];
  return w;
}

// p with its parameter vectors (all but the four matrices and W3) copied
// into buffer b by cp.async, when the layout keeps b in shared memory.
template <class Cx>
__device__ BlockParams stage_vectors(const BlockParams& p, const Cx& x,
                                     int b, const Dims& D) {
  if (!x.resident(b)) return p;
  const int c = D.c, h = D.hidden;
  const float* src[10] = {p.g1, p.wpe, p.bpe, p.bqkv, p.sigma,
                          p.bo, p.g2,  p.b1,  p.b2,   p.b3};
  const int len[10] = {c, c * D.d, c, 3 * c, D.heads, c, c, h, h, c};
  float* dst[10];
  float* at = x.own(b);
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    dst[i] = at;
    if (src[i] != nullptr) stage(at, len[i], src[i], len[i], 1, len[i]);
    at += len[i];
  }
  BlockParams q = p;
  q.g1 = dst[0];
  q.wpe = dst[1];
  q.bpe = dst[2];
  q.bqkv = dst[3];
  q.sigma = p.sigma == nullptr ? nullptr : dst[4];
  q.bo = dst[5];
  q.g2 = dst[6];
  q.b1 = dst[7];
  q.b2 = dst[8];
  q.b3 = dst[9];
  return q;
}

// Where a product's element (r, j) goes: index i = r * ld + col0 + col of
// p (stored, or added to), plus bias[col] and res[i] when given, with
// col = j, or with segments (seg.d > 0) col = j % seg + (j / seg) seg_jump
// (the q, k and v sections of a head's columns in one product).
enum OutMode { STORE, ADD };
struct Out {
  OutMode mode;
  float* p;
  int ld, col0;
  const float* bias;  // already offset to this slice
  const float* res;   // this CTA's copy, indexed like the destination
  FastDiv seg{0};
  int seg_jump = 0;
};

__device__ __forceinline__ void put(const Out& o, int r, int j, float v) {
  const int s = o.seg.div(j);
  const int col = j + s * (o.seg_jump - static_cast<int>(o.seg.d));
  const int i = r * o.ld + o.col0 + col;
  if (o.bias != nullptr) v = o.bias[col] + v;
  if (o.res != nullptr) v = o.res[i] + v;
  if (o.mode == ADD)
    o.p[i] += v;
  else
    o.p[i] = v;
}

// Lanes per item when items < NT: a power of two up to a warp that keeps
// every thread busy, each lane summing 1/S of the item's terms. A phase's
// time is the length of its longest dependent chain, not its FLOP.
__device__ __forceinline__ int split_of(int items) {
  int s = 1;
  while (s < 32 && items * s * 2 <= NT) s <<= 1;
  return s;
}

__device__ __forceinline__ int log2i(int pow2) { return __ffs(pow2) - 1; }

// The sum of v over the S lanes of an item (all of them get it).
__device__ __forceinline__ float lane_sum(float v, int S) {
  for (int o = S >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out (r, j) = sum_k A[r * lda + k] * W[j * wj + k * wk] for r < n, j < m.
// Each tile of 2x2 outputs, rows {r, r + n/2} and columns {j, j + m/2}, is
// summed by S lanes (split_of), lane s taking k = s, s + S, ...;
// consecutive tiles take consecutive rows (odd row strides: distinct
// banks) of the same columns (one broadcast weight read), and the tile's
// lanes share out its four stores. Every thread runs the same iterations
// (the lanes reduce by shuffles).
__device__ __forceinline__ void gemm(int n, int m, int kd, const float* A,
                                     int lda, const float* W, int wj, int wk,
                                     Out o) {
  const int rs = (n + 1) >> 1, cs = (m + 1) >> 1, tiles = rs * cs;
  const int S = split_of(tiles), ls = log2i(S), lrs = log2i(rs);  // n: 2^k
  for (int base = 0; base < tiles * S; base += NT) {
    const int t = base + threadIdx.x, s = t & (S - 1);
    const bool ok = (t >> ls) < tiles;
    const int tile = ok ? t >> ls : 0;
    const int r0 = tile & (rs - 1), c0 = tile >> lrs;
    const int r1 = r0 + rs, c1 = c0 + cs;
    const float* a0 = A + r0 * lda;
    const float* a1 = A + min(r1, n - 1) * lda;
    const float* w0 = W + c0 * wj;
    const float* w1 = W + min(c1, m - 1) * wj;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int k = s; k < kd; k += S) {
      const float x0 = a0[k], x1 = a1[k], y0 = w0[k * wk], y1 = w1[k * wk];
      acc[0] = fmaf(x0, y0, acc[0]);
      acc[1] = fmaf(x0, y1, acc[1]);
      acc[2] = fmaf(x1, y0, acc[2]);
      acc[3] = fmaf(x1, y1, acc[3]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = lane_sum(acc[q], S);
    if (!ok) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = q < 2 ? r0 : r1, j = q % 2 == 0 ? c0 : c1;
      if ((q & (S - 1)) == s && r < n && j < m) put(o, r, j, acc[q]);
    }
  }
}

// dst[i * rs + j] = sum_r A[r * lda + i] * B[r * ldb + j] for i < na,
// j < nb: the gradient of a torch-layout weight [na, nb] from the output
// gradient A and the input B, into global memory; 2x2 tiles summed by S
// lanes each over the rows, as gemm.
__device__ __forceinline__ void outer_sum(int rows, int na, int nb,
                                          const float* A, int lda,
                                          const float* B, int ldb, float* dst,
                                          int rs) {
  const int is = (na + 1) >> 1, js = (nb + 1) >> 1, tiles = is * js;
  const int S = split_of(tiles), ls = log2i(S);
  const FastDiv fjs(js);
  for (int base = 0; base < tiles * S; base += NT) {
    const int t = base + threadIdx.x, s = t & (S - 1);
    const bool ok = (t >> ls) < tiles;
    const int tile = ok ? t >> ls : 0;
    const int i0 = fjs.div(tile), j0 = tile - i0 * js;
    const int i1 = i0 + is, j1 = j0 + js;
    const int i1c = min(i1, na - 1), j1c = min(j1, nb - 1);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int r = s; r < rows; r += S) {
      const float x0 = A[r * lda + i0], x1 = A[r * lda + i1c];
      const float y0 = B[r * ldb + j0], y1 = B[r * ldb + j1c];
      acc[0] = fmaf(x0, y0, acc[0]);
      acc[1] = fmaf(x0, y1, acc[1]);
      acc[2] = fmaf(x1, y0, acc[2]);
      acc[3] = fmaf(x1, y1, acc[3]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = lane_sum(acc[q], S);
    if (!ok) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = q < 2 ? i0 : i1, j = q % 2 == 0 ? j0 : j1;
      if ((q & (S - 1)) == s && i < na && j < nb) dst[i * rs + j] = acc[q];
    }
  }
}

// dst[i] = sum_r A[r * lda + i] * (B ? B[r * lda + i] * s[r] : 1) for
// i < na: a bias gradient, or with B and s that of an RMSNorm weight; each
// column summed by S lanes over the rows.
__device__ __forceinline__ void col_sum(float* dst, const float* A,
                                        const float* B, const float* sc,
                                        int lda, int na, int rows) {
  const int S = split_of(na), ls = log2i(S);
  for (int base = 0; base < na * S; base += NT) {
    const int t = base + threadIdx.x, s = t & (S - 1);
    const bool ok = (t >> ls) < na;
    const int i = ok ? t >> ls : 0;
    float acc = 0.f;
    for (int r = s; r < rows; r += S)
      acc = B == nullptr ? acc + A[r * lda + i]
                         : fmaf(A[r * lda + i] * B[r * lda + i], sc[r], acc);
    acc = lane_sum(acc, S);
    if (ok && s == 0) dst[i] = acc;
  }
}

// Lanes per row for a row-wise reduction over n rows: a power of two up to
// a warp, as many as the CTA's threads allow.
__device__ __forceinline__ int group_size(int n) {
  int g = 32;
  while (g > 1 && g * n > NT) g >>= 1;
  return g;
}

// out[r] = sum_j A[r * ld + j] * B[r * ld + j] * (g ? g[j] : 1) for r < n,
// or its RMSNorm 1/rms, rsqrt(sum / c + 1e-6), when rms; a group of lanes
// per row reduces by shuffles, every thread running the same iterations.
__device__ __forceinline__ void row_sums(const float* A, const float* B,
                                      const float* g, int ld, int n, int c,
                                      float* out, bool rms) {
  const int gs = group_size(n);
  const int lane = threadIdx.x & (gs - 1), grp = threadIdx.x >> log2i(gs);
  const int ngrp = NT >> log2i(gs);
  for (int r0 = 0; r0 < n; r0 += ngrp) {
    const int r = r0 + grp;
    float acc = 0.f;
    if (r < n)
      for (int j = lane; j < c; j += gs) {
        const float v = A[r * ld + j] * B[r * ld + j];
        acc = g == nullptr ? acc + v : fmaf(v, g[j], acc);
      }
    for (int o = gs >> 1; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (r < n && lane == 0) out[r] = rms ? rsqrtf(acc / c + 1e-6f) : acc;
  }
}

// Each of the rows rows of S ([rows, bs]) in place: its softmax, or with A
// the softmax backward S = A (S - sum_j S A) from S = dL/dA.
__device__ __forceinline__ void softmax_rows(float* S, const float* A,
                                          int rows, int bs) {
  const int g = group_size(rows);
  const int lane = threadIdx.x & (g - 1), grp = threadIdx.x >> log2i(g);
  const int ngrp = NT >> log2i(g);
  for (int r0 = 0; r0 < rows; r0 += ngrp) {
    const int r = r0 + grp;
    float* row = S + static_cast<size_t>(r) * bs;
    const float* arow =
        A == nullptr ? nullptr : A + static_cast<size_t>(r) * bs;
    if (A != nullptr) {
      float dsum = 0.f;
      if (r < rows)
        for (int j = lane; j < bs; j += g) dsum = fmaf(row[j], arow[j], dsum);
      for (int o = g >> 1; o > 0; o >>= 1)
        dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
      if (r < rows)
        for (int j = lane; j < bs; j += g) row[j] = arow[j] * (row[j] - dsum);
      continue;
    }
    float mx = -INFINITY;
    if (r < rows)
      for (int j = lane; j < bs; j += g) mx = fmaxf(mx, row[j]);
    for (int o = g >> 1; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    if (r < rows)
      for (int j = lane; j < bs; j += g) {
        const float e = expf(row[j] - mx);
        row[j] = e;
        sum += e;
      }
    for (int o = g >> 1; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (r < rows) {
      const float inv = 1.f / sum;
      for (int j = lane; j < bs; j += g) row[j] *= inv;
    }
  }
}

// Over the (head, query) pairs t = h * n + r in [t0, t1), S[(t - t0) * bs
// + jj] = a logit: with dist, that of query r against key b0 + jj of its
// ball, q k / sqrt(hd) + sigma_h |p_r - p_j| (sigma when use_dist_bias);
// without, the dot of row r of X (columns h * hd ..) and row j of Y.
__device__ __forceinline__ void pair_dots(float* S, const float* X,
                                       const float* Y, int ldx, int ldy,
                                       const float* ps, const float* sigma,
                                       const Dims& D, int t0, int t1,
                                       float scale) {
  const int d = D.d, bs = D.bs, hd = D.fhd.d;
  for (int e = threadIdx.x; e < (t1 - t0) * bs; e += NT) {
    const int t = t0 + (e >> D.lbs), jj = e & (bs - 1);
    const int h = t >> D.ln, r = t & (D.n - 1);
    const int j = (r & ~(bs - 1)) + jj;
    const float* q = X + r * ldx + h * hd;
    const float* kk = Y + j * ldy + h * hd;
    float l = 0.f;
    for (int i = 0; i < hd; ++i) l = fmaf(q[i], kk[i], l);
    l *= scale;
    if (sigma != nullptr) {
      float d2 = 0.f;
      for (int i = 0; i < d; ++i) {
        const float df = ps[r * d + i] - ps[j * d + i];
        d2 = fmaf(df, df, d2);
      }
      l += sigma[h] * sqrtf(d2 + 1e-12f);
    }
    S[e] = l;
  }
}

// For the pairs [t0, t1) of pair_dots: with keys false, out (r, h hd + k) =
// scale sum_jj S[t - t0][jj] V[(b0 + jj) ldv + h hd + k], the attention
// output (or dq); with keys true, the same sum over the queries b0 + ii of
// the ball of key r, S[(t - t0) - i + ii][i] (dk, dv). Each output summed
// by split_of lanes; put by o.
__device__ __forceinline__ void pair_sums(const float* S,
                                          const float* V, int ldv,
                                          const Dims& D, int t0, int t1,
                                          bool keys, float scale, Out o) {
  const int bs = D.bs, hd = D.fhd.d;
  const int items = (t1 - t0) * hd, L = split_of(items), ll = log2i(L);
  for (int base = 0; base < items * L; base += NT) {
    const int u = base + threadIdx.x, l = u & (L - 1);
    const bool ok = (u >> ll) < items;
    const int e = ok ? u >> ll : 0;
    const int te = D.fhd.div(e), k = e - te * hd, t = t0 + te;
    const int h = t >> D.ln, r = t & (D.n - 1), b0 = r & ~(bs - 1);
    const int i = r - b0;
    const int lr = t - t0;
    const float* v = V + b0 * ldv + h * hd + k;
    float acc = 0.f;
    if (keys) {
      const float* col = S + static_cast<size_t>(lr - i) * bs + i;
      for (int ii = l; ii < bs; ii += L)
        acc = fmaf(col[ii * bs], v[ii * ldv], acc);
    } else {
      const float* row = S + static_cast<size_t>(lr) * bs;
      for (int jj = l; jj < bs; jj += L) acc = fmaf(row[jj], v[jj * ldv], acc);
    }
    acc = lane_sum(acc, L);
    if (ok && l == 0) put(o, r, h * hd + k, acc * scale);
  }
}

// How an exchanged buffer's elements are shared out: by column (qkv, x1),
// by (head, query) pair (the forward's attention output) or by (head, ball)
// unit (the backward's attention output and dqkv).
enum Owner { BY_COLUMN, BY_PAIR, BY_UNIT };

// The items an exchanged buffer w wide is shared out by: its columns, or
// the heads' (pairs or units).
__device__ __forceinline__ int owned_items(Owner kind, int w, const Dims& D) {
  return kind == BY_COLUMN ? w
                           : D.heads << (kind == BY_PAIR ? D.ln
                                                         : D.ln - D.lbs);
}

// The rank that computes element (r, col) of an exchanged buffer: the q
// with its item i in slice_of(N, q, K), i.e. ((i + 1) K - 1) / N; fN
// divides by N = owned_items.
__device__ __forceinline__ int owner(Owner kind, int r, int col,
                                     const FastDiv& fN, const Dims& D,
                                     int k) {
  int i = col;
  if (kind != BY_COLUMN) {
    const int h = D.fhd.div(D.fc.mod(col)), lnb = D.ln - D.lbs;
    i = kind == BY_PAIR ? (h << D.ln) + r : (h << lnb) + (r >> D.lbs);
  }
  return fN.div((i + 1) * k - 1);
}

// Exchange: copy into this CTA's copy of buffer b ([n, w], row stride ld)
// every element another rank computed, from that rank's copy, after the
// cluster barrier that follows the computing phase. A rank only ever
// stores into its own copy.
template <class Cx>
__device__ __forceinline__ void gather(const Cx& x, int b, int n, int w,
                                       int ld, Owner kind, const Dims& D) {
  float* mine = x.own(b);
  const FastDiv fw(w), fN(owned_items(kind, w, D));
  for (int e = threadIdx.x; e < n * w; e += NT) {
    const int r = fw.div(e), col = e - r * w;
    const int q = owner(kind, r, col, fN, D, x.k);
    if (q != x.rank) mine[r * ld + col] = x.peer(b, q)[r * ld + col];
  }
}

// dst[r * dst_ld + col0 + j] = sum over ranks 0..K-1 of element
// r * ld + col0 + j of exchanged buffer b, for r < n, j < w; with bias,
// res[r * ld + col0 + j] + (bias[j] + that sum). The K loads of an element
// are in flight together (a load from a peer's shared memory takes
// hundreds of cycles).
template <class Cx>
__device__ __forceinline__ void pull_rows(const Cx& x, int b, int n, int ld,
                                       int col0, int w, float* dst,
                                       int dst_ld, const float* res,
                                       const float* bias) {
  const FastDiv fw(w);
  for (int e = threadIdx.x; e < n * w; e += NT) {
    const int r = fw.div(e), j = e - r * w, i = r * ld + col0 + j;
    float v[MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      v[q] = q < x.k ? x.peer(b, q)[i] : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < x.k) acc += v[q];
    if (bias != nullptr) acc = res[i] + (bias[j] + acc);
    dst[r * dst_ld + col0 + j] = acc;
  }
}

// The block's forward up to the SwiGLU hidden, shared by both kernels:
// RMSNorm 1, hm, the exchanged qkv, attention over the pairs [t0, t1) with
// their probabilities left in S, the exchanged x1 (into buffer b_x1, from x
// in xs), RMSNorm 2 into zn, and this rank's u and t. The caller loaded xs
// and ps (and waited for them) and issued the weight copies (not waited).
struct FwdBufs {
  float *xs, *hs, *zn, *us, *ts, *ps, *rel, *rinv, *r2, *S;
  int b_qkv, b_o, b_x1;
  Owner o_owner;
};

template <class Cx>
__device__ __forceinline__ void block_forward(const Cx& x,
                                           const BlockParams& p,
                                           const Dims& D, const Weights& w,
                                           const FwdBufs& f, int t0, int t1) {
  const int n = D.n, c = D.c, d = D.d, bs = D.bs;
  const int ldc = c + 1, ld3 = 3 * c + 1;
  const Slice sc = slice_of(c, x.rank, x.k);
  const Slice sh = slice_of(D.hidden, x.rank, x.k);
  const int ldh = sh.w() + 1;
  const float* qkv = x.own(f.b_qkv);
  const float* x1 = x.own(f.b_x1);

  row_sums(f.xs, f.xs, nullptr, ldc, n, c, f.rinv, true);
  for (int i = threadIdx.x; i < n * d; i += NT) {
    const int r = D.fd.div(i), k = i - r * d;
    const int b0 = r & ~(bs - 1);
    float sum = 0.f;
    for (int j = 0; j < bs; ++j) sum += f.ps[(b0 + j) * d + k];
    f.rel[i] = f.ps[i] - sum / bs;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * c; i += NT) {
    const int r = D.fc.div(i), j = i - r * c;
    float pe = p.bpe[j];
    for (int k = 0; k < d; ++k)
      pe = fmaf(f.rel[r * d + k], p.wpe[j * d + k], pe);
    f.hs[r * ldc + j] = f.xs[r * ldc + j] * f.rinv[r] * p.g1[j] + pe;
  }
  cp_async_wait<0>();
  __syncthreads();

  // q, k and v of the heads this rank's pairs attend with (computed again
  // by a rank that shares a head): no exchange. The first access to a
  // peer's shared memory comes after the cluster barrier below, by which
  // every CTA of the cluster has started.
  const int hd = D.fhd.d, wq = w.nh * hd;
  if (w.qh_stacked) {   // one product over the three sections' rows
    gemm(n, 3 * wq, c, f.hs, ldc, w.qh[0].p, w.qh[0].ld, 1,
         {STORE, x.own(f.b_qkv), ld3, w.hlo * hd, p.bqkv + w.hlo * hd,
          nullptr, FastDiv(wq), c});
  } else {
    for (int sec = 0; sec < 3; ++sec) {
      const int col0 = sec * c + w.hlo * hd;
      gemm(n, wq, c, f.hs, ldc, w.qh[sec].p, w.qh[sec].ld, 1,
           {STORE, x.own(f.b_qkv), ld3, col0, p.bqkv + col0, nullptr});
    }
  }
  __syncthreads();

  pair_dots(f.S, qkv, qkv + c, ld3, ld3, f.ps,
            D.use_dist_bias ? p.sigma : nullptr, D, t0, t1,
            rsqrtf(static_cast<float>(hd)));
  __syncthreads();
  softmax_rows(f.S, nullptr, t1 - t0, bs);
  __syncthreads();
  pair_sums(f.S, qkv + 2 * c, ld3, D, t0, t1, false, 1.f,
            {STORE, x.own(f.b_o), ldc, 0, nullptr, nullptr});
  x.sync();
  gather(x, f.b_o, n, c, ldc, f.o_owner, D);
  __syncthreads();

  gemm(n, sc.w(), c, x.own(f.b_o), ldc, w.o.p, w.o.ld, 1,
       {STORE, x.own(f.b_x1), ldc, sc.lo, p.bo + sc.lo, f.xs});
  x.sync();
  gather(x, f.b_x1, n, c, ldc, BY_COLUMN, D);
  __syncthreads();

  row_sums(x1, x1, nullptr, ldc, n, c, f.r2, true);
  __syncthreads();
  for (int i = threadIdx.x; i < n * c; i += NT) {
    const int r = D.fc.div(i), j = i - r * c;
    f.zn[r * ldc + j] = x1[r * ldc + j] * f.r2[r] * p.g2[j];
  }
  __syncthreads();
  gemm(n, sh.w(), c, f.zn, ldc, w.w1.p, w.w1.ld, 1,
       {STORE, f.us, ldh, 0, p.b1 + sh.lo, nullptr});
  gemm(n, sh.w(), c, f.zn, ldc, w.w2.p, w.w2.ld, 1,
       {STORE, f.ts, ldh, 0, p.b2 + sh.lo, nullptr});
  __syncthreads();
}

template <bool SMEM>
__device__ Ctx<SMEM> make_ctx(const Layout& L, float* sm, float* scratch,
                              int nshared) {
  Ctx<SMEM> x{0, 0, sm, nullptr, &L, false};
  cg::cluster_group cl = cg::this_cluster();
  x.k = static_cast<int>(cl.num_blocks());
  x.rank = static_cast<int>(cl.block_rank());
  const size_t cloud = blockIdx.x / x.k;
  if (scratch != nullptr)
    x.cloud_scratch =
        scratch + cloud * x.k * static_cast<size_t>(L.scratch_stride);
  for (int b = 0; b < nshared; ++b) x.spilled_shared |= !L.in_smem[b];
  return x;
}

template <bool SMEM>
__global__ void __launch_bounds__(NT)
erwin_block_fwd(const float* __restrict__ xin, const float* __restrict__ pos,
                float* __restrict__ out, float* scratch, BlockParams p,
                Dims D, Layout L) {
  extern __shared__ float sm[];
  const auto x = make_ctx<SMEM>(L, sm, scratch, 3);
  const int n = D.n, c = D.c, d = D.d, ldc = c + 1;
  const size_t cloud = blockIdx.x / x.k;
  const Slice s3{0, 0};  // the forward needs no share of the Wqkv rows
  const Slice sc = slice_of(c, x.rank, x.k);
  const Slice sh = slice_of(D.hidden, x.rank, x.k);
  const Slice sp = slice_of(D.heads * n, x.rank, x.k);
  const float* xb = xin + cloud * n * c;
  const float* pb = pos + cloud * n * d;
  const BlockParams v = stage_vectors(p, x, F_VEC, D);
  stage(x.own(F_X), ldc, xb, c, n, c);
  stage(x.own(F_POS), d, pb, d, n, d);
  cp_async_commit();
  const Weights w = stage_weights(p, x, F_WQKVH, F_WQKV, D, s3, sc, sh,
                                  sp.lo >> D.ln,
                                  sp.w() ? ((sp.hi - 1) >> D.ln) -
                                               (sp.lo >> D.ln) + 1
                                         : 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // The residual stream x (then x1) is exchanged: x1 lands in the same
  // buffer, each rank writing its own columns after every rank read x.
  const FwdBufs f{x.own(F_X), x.own(F_HM), x.own(F_HM), x.own(F_U),
                  x.own(F_T), x.own(F_POS), x.own(F_REL), x.own(F_RINV),
                  x.own(F_RINV), x.own(F_P), F_QKV, F_O, F_X,
                  BY_PAIR};
  block_forward(x, v, D, w, f, sp.lo, sp.hi);

  // gv = t * silu(u) in place of u, then this rank's W3 partial [n, c] into
  // its qkv buffer (no longer read by anyone).
  const int ldh = sh.w() + 1;
  const FastDiv fh(sh.w());
  for (int i = threadIdx.x; i < n * sh.w(); i += NT) {
    const int r = fh.div(i), k = i - r * sh.w();
    const float u = f.us[r * ldh + k];
    f.us[r * ldh + k] = f.ts[r * ldh + k] * (u / (1.f + expf(-u)));
  }
  __syncthreads();
  gemm(n, c, sh.w(), f.us, ldh, w.w3.p, w.w3.ld, 1,
       {STORE, x.own(F_QKV), ldc, 0, nullptr, nullptr});
  x.sync();

  // out = x1 + (b3 + the K partials), for this rank's columns.
  pull_rows(x, F_QKV, n, ldc, sc.lo, sc.w(), out + cloud * n * c, c,
            f.xs, v.b3 + sc.lo);
  x.sync();  // no CTA leaves while a peer still reads its partial
}

// ---------------------------------------------------------------------------
// Backward of the same block, float32.
//
// Replaces the Pallas TPU kernel _bwd_kernel of
// haet_tpu/ops/pallas/erwin_block.py (called from _fused_block_bwd). Given
// the saved (x, pos) and dout it recomputes the block's forward, then runs
// the chain of _bwd_kernel:
//   SwiGLU:  dW3 = gv^T dout, dgv = dout W3, du = dgv t silu'(u),
//            dt = dgv silu(u), dW1 = zn^T du, dW2 = zn^T dt,
//            dzn = du W1 + dt W2
//   RMSNorm 2: dg2, dx1 = dout + rms_bwd(dzn g2, x1, r2)
//   attention: dWo = o^T dx1, do = dx1 Wo, per head and query
//            ds = a (da - sum_j da a) with da = do v^T, dq = ds k / sqrt(hd),
//            dk = ds^T q / sqrt(hd), dv = a^T do; dWqkv = hm^T dqkv,
//            dhm = dqkv Wqkv
//   rel-pos: dWpe = dhm^T rel, drel = dhm Wpe, dpos = drel - ball_mean(drel)
//   RMSNorm 1: dg1, dx = dx1 + rms_bwd(dhm g1, x, r1)
// The distance bias sigma * |p_i - p_j| gets no gradient (the reference
// computes it under no_grad), so there is none for sigma, and none from it
// for pos.
//
// What bounds it on an H100: as the forward, the chain of dependent phases;
// a call moves ~0.2-0.6 MB and does ~3x the forward's FLOP (~230 K FMA per
// rank at n 32 / C 32, ~400 K at n 16 / C 64).
//
// Design: the forward's cluster decomposition, run backwards.
//   * Rank r computes the gradient of the weight slice it owns from the full
//     activations it holds (dWqkv, dWo, dW1, dW2 rows, dW3 columns, and its
//     columns of every vector), so each cloud's [P] row of the [clouds, P]
//     partials is written by disjoint ranks; erwin_block_sum_partials sums
//     them over the clouds in a fixed order.
//   * dzn, do and dhm (dX = dY W over this rank's slice of W's output
//     columns) are partials [n, C] summed over the ranks in order 0..K-1 by
//     every rank, each in a buffer the forward no longer needs (dqkv, x1,
//     o), so one cluster barrier before each sum and the next exchange's
//     barrier after it keep writer and readers apart.
//   * Attention works on whole (head, ball) units, 1/K of them per rank: the
//     probabilities and softmax gradients stay in the rank's own memory and
//     dk, dv (sums over the queries of a key) need nothing from a peer; dq,
//     dk and dv are exchanged as the forward exchanges qkv.
//   * Weight gradients are 2x2 register tiles per thread (outer_sum).

// Offsets of each parameter's gradient in a cloud's partials (PARAM_NAMES
// order without sigma); returns P, the count of all of them.
__host__ __device__ inline int param_offsets(int c, int d, int hidden,
                                             int* o) {
  const int sizes[14] = {c,      c * d,      c, 3 * c * c, 3 * c,
                         c * c,  c,          c, hidden * c, hidden,
                         hidden * c, hidden, c * hidden, c};
  int acc = 0;
  for (int i = 0; i < 14; ++i) {
    o[i] = acc;
    acc += sizes[i];
  }
  return acc;
}

enum ParamGrad {
  G_G1, G_WPE, G_BPE, G_WQKV, G_BQKV, G_WO, G_BO, G_G2, G_W1, G_B1, G_W2,
  G_B2, G_W3, G_B3
};

template <bool SMEM>
__global__ void __launch_bounds__(NT)
erwin_block_bwd(const float* __restrict__ xin, const float* __restrict__ pos,
                const float* __restrict__ dout, float* __restrict__ dx,
                float* __restrict__ dpos, float* __restrict__ partials,
                float* scratch, BlockParams p, Dims D, Layout L) {
  extern __shared__ float sm[];
  const auto x = make_ctx<SMEM>(L, sm, scratch, 4);
  const int n = D.n, c = D.c, d = D.d, bs = D.bs, hidden = D.hidden;
  const int ldc = c + 1, ld3 = 3 * c + 1;
  const int hd = D.fhd.d;
  const float scale = rsqrtf(static_cast<float>(hd));
  const size_t cloud = blockIdx.x / x.k;
  const Slice s3 = slice_of(3 * c, x.rank, x.k);
  const Slice sc = slice_of(c, x.rank, x.k);
  const Slice sh = slice_of(hidden, x.rank, x.k);
  const Slice su = slice_of(D.heads << (D.ln - D.lbs), x.rank, x.k);
  const int t0 = su.lo * bs, t1 = su.hi * bs;  // their (head, query) pairs
  const int ldh = sh.w() + 1;
  int go[14];
  const int np = param_offsets(c, d, hidden, go);
  float* part = partials + cloud * static_cast<size_t>(np);
  const BlockParams v = stage_vectors(p, x, B_VEC, D);
  stage(x.own(B_X), ldc, xin + cloud * n * c, c, n, c);
  stage(x.own(B_GD), ldc, dout + cloud * n * c, c, n, c);
  stage(x.own(B_POS), d, pos + cloud * n * d, d, n, d);
  cp_async_commit();
  const int lnb = D.ln - D.lbs;
  const Weights w = stage_weights(p, x, B_WQKVH, B_WQKV, D, s3, sc, sh,
                                  su.lo >> lnb,
                                  su.w() ? ((su.hi - 1) >> lnb) -
                                               (su.lo >> lnb) + 1
                                         : 0);
  cp_async_commit();

  float* xs = x.own(B_X);       // [n, ldc] x
  float* gd = x.own(B_GD);      // [n, ldc] dout, then dx1
  float* hs = x.own(B_HM);      // [n, ldc] hm
  float* zn = x.own(B_ZN);      // [n, ldc] RMSNorm 2 output
  float* dz = x.own(B_DZ);      // [n, ldc] dzn, then do, then dhm
  float* ps = x.own(B_POS);     // [n, d] positions, then drel
  float* rel = x.own(B_REL);    // [n, d]
  float* r1 = x.own(B_R1);      // [n] 1/rms of x
  float* r2 = x.own(B_R2);      // [n] 1/rms of x1
  float* rowdot = x.own(B_ROW); // [n] RMSNorm backward row sums
  float* us = x.own(B_U);       // [n, ldh] u, then du
  float* ts = x.own(B_T);       // [n, ldh] t, then dt
  float* gv = x.own(B_G);       // [n, ldh] t * silu(u), then dgv
  float* pa = x.own(B_P);       // [pairs, bs] attention probabilities
  float* dsa = x.own(B_DS);     // [pairs, bs] softmax gradients
  const float* qkv = x.own(B_QKV);
  const float* os = x.own(B_O);
  const float* x1 = x.own(B_X1);
  const float* dqkv = x.own(B_DQKV);

  cp_async_wait<1>();
  __syncthreads();

  // ---- recompute the forward ----------------------------------------------
  const FwdBufs f{xs, hs,    zn,  us,   ts,  ps,     rel,
                  r1, r2,    pa,  B_QKV, B_O, B_X1, BY_UNIT};
  block_forward(x, v, D, w, f, t0, t1);

  // ---- SwiGLU half: out = x1 + w3(t * silu(u)) ----------------------------
  const FastDiv fh(sh.w());
  for (int i = threadIdx.x; i < n * sh.w(); i += NT) {
    const int r = fh.div(i), k = i - r * sh.w();
    const float u = us[r * ldh + k];
    gv[r * ldh + k] = ts[r * ldh + k] * (u / (1.f + expf(-u)));
  }
  __syncthreads();
  outer_sum(n, c, sh.w(), gd, ldc, gv, ldh, part + go[G_W3] + sh.lo, hidden);
  col_sum(part + go[G_B3] + sc.lo, gd + sc.lo, nullptr, nullptr, ldc, sc.w(),
          n);
  __syncthreads();
  gemm(n, sh.w(), c, gd, ldc, w.w3.p, 1, w.w3.ld,          // dgv
       {STORE, gv, ldh, 0, nullptr, nullptr});
  __syncthreads();
  for (int i = threadIdx.x; i < n * sh.w(); i += NT) {   // du, dt in place
    const int r = fh.div(i), k = i - r * sh.w();
    const float dg = gv[r * ldh + k];
    const float u = us[r * ldh + k], tv = ts[r * ldh + k];
    const float sg = 1.f / (1.f + expf(-u));
    us[r * ldh + k] = dg * tv * sg * (1.f + u * (1.f - sg));
    ts[r * ldh + k] = dg * u * sg;
  }
  __syncthreads();
  outer_sum(n, sh.w(), c, us, ldh, zn, ldc,
            part + go[G_W1] + static_cast<size_t>(sh.lo) * c, c);
  col_sum(part + go[G_B1] + sh.lo, us, nullptr, nullptr, ldh, sh.w(), n);
  outer_sum(n, sh.w(), c, ts, ldh, zn, ldc,
            part + go[G_W2] + static_cast<size_t>(sh.lo) * c, c);
  col_sum(part + go[G_B2] + sh.lo, ts, nullptr, nullptr, ldh, sh.w(), n);
  // This rank's share of dzn = du W1 + dt W2, into its dqkv buffer (free
  // until the attention backward).
  float* pz = x.own(B_DQKV);
  gemm(n, c, sh.w(), us, ldh, w.w1.p, 1, w.w1.ld,
       {STORE, pz, ldc, 0, nullptr, nullptr});
  gemm(n, c, sh.w(), ts, ldh, w.w2.p, 1, w.w2.ld,
       {ADD, pz, ldc, 0, nullptr, nullptr});
  x.sync();
  pull_rows(x, B_DQKV, n, ldc, 0, c, dz, ldc, nullptr, nullptr);
  __syncthreads();

  // ---- RMSNorm 2 ----------------------------------------------------------
  col_sum(part + go[G_G2] + sc.lo, dz + sc.lo, x1 + sc.lo, r2, ldc, sc.w(),
          n);
  row_sums(dz, x1, v.g2, ldc, n, c, rowdot, false);
  __syncthreads();
  for (int i = threadIdx.x; i < n * c; i += NT) {
    const int r = D.fc.div(i), j = i - r * c;
    const float rr = r2[r];
    gd[r * ldc + j] += dz[r * ldc + j] * v.g2[j] * rr -
                       x1[r * ldc + j] * (rowdot[r] * rr * rr * rr / c);
  }
  __syncthreads();

  // ---- attention half: dy = dx1 -------------------------------------------
  col_sum(part + go[G_BO] + sc.lo, gd + sc.lo, nullptr, nullptr, ldc, sc.w(),
          n);
  outer_sum(n, sc.w(), c, gd + sc.lo, ldc, os, ldc,
            part + go[G_WO] + static_cast<size_t>(sc.lo) * c, c);
  // This rank's share of do = dx1 Wo, into its x1 buffer (read above).
  gemm(n, c, sc.w(), gd + sc.lo, ldc, w.o.p, 1, w.o.ld,
       {STORE, x.own(B_X1), ldc, 0, nullptr, nullptr});
  x.sync();
  pull_rows(x, B_X1, n, ldc, 0, c, dz, ldc, nullptr, nullptr);   // do
  __syncthreads();
  // This rank's (head, ball) units: da = do v^T, ds = a (da - sum_j da a),
  // then dq, dk and dv, exchanged.
  pair_dots(dsa, dz, qkv + 2 * c, ldc, ld3, nullptr, nullptr, D, t0, t1,
            1.f);
  __syncthreads();
  softmax_rows(dsa, pa, t1 - t0, bs);
  __syncthreads();
  float* dq = x.own(B_DQKV);
  pair_sums(dsa, qkv + c, ld3, D, t0, t1, false, scale,        // dq
            {STORE, dq, ld3, 0, nullptr, nullptr});
  pair_sums(dsa, qkv, ld3, D, t0, t1, true, scale,             // dk
            {STORE, dq, ld3, c, nullptr, nullptr});
  pair_sums(pa, dz, ldc, D, t0, t1, true, 1.f,                 // dv
            {STORE, dq, ld3, 2 * c, nullptr, nullptr});
  x.sync();
  gather(x, B_DQKV, n, 3 * c, ld3, BY_UNIT, D);
  __syncthreads();
  outer_sum(n, s3.w(), c, dqkv + s3.lo, ld3, hs, ldc,
            part + go[G_WQKV] + static_cast<size_t>(s3.lo) * c, c);
  col_sum(part + go[G_BQKV] + s3.lo, dqkv + s3.lo, nullptr, nullptr, ld3,
          s3.w(), n);
  // This rank's share of dhm = dqkv Wqkv, into its o buffer (read above).
  gemm(n, c, s3.w(), dqkv + s3.lo, ld3, w.qkv.p, 1, w.qkv.ld,
       {STORE, x.own(B_O), ldc, 0, nullptr, nullptr});
  x.sync();
  pull_rows(x, B_O, n, ldc, 0, c, dz, ldc, nullptr, nullptr);    // dhm
  __syncthreads();

  // ---- rel-pos and RMSNorm 1: dz holds dhm --------------------------------
  outer_sum(n, sc.w(), d, dz + sc.lo, ldc, rel, d,
            part + go[G_WPE] + static_cast<size_t>(sc.lo) * d, d);
  col_sum(part + go[G_BPE] + sc.lo, dz + sc.lo, nullptr, nullptr, ldc,
          sc.w(), n);
  col_sum(part + go[G_G1] + sc.lo, dz + sc.lo, xs + sc.lo, r1, ldc, sc.w(),
          n);
  row_sums(dz, xs, v.g1, ldc, n, c, rowdot, false);
  for (int i = threadIdx.x; i < n * d; i += NT) {   // drel, in place of pos
    const int r = D.fd.div(i), k = i - r * d;
    float acc = 0.f;
    for (int j = 0; j < c; ++j)
      acc = fmaf(dz[r * ldc + j], v.wpe[j * d + k], acc);
    ps[i] = acc;
  }
  __syncthreads();
  float* dxb = dx + cloud * n * c;
  const FastDiv fcw(sc.w());
  for (int e = threadIdx.x; e < n * sc.w(); e += NT) {
    const int r = fcw.div(e), j = sc.lo + e - r * sc.w();
    const float rr = r1[r];
    dxb[r * c + j] = gd[r * ldc + j] + dz[r * ldc + j] * v.g1[j] * rr -
                     xs[r * ldc + j] * (rowdot[r] * rr * rr * rr / c);
  }
  float* dpb = dpos + cloud * n * d;
  const Slice sd = slice_of(n * d, x.rank, x.k);
  for (int i = sd.lo + threadIdx.x; i < sd.hi; i += NT) {
    const int r = D.fd.div(i), k = i - r * d;
    const int b0 = r & ~(bs - 1);
    float sum = 0.f;
    for (int j = 0; j < bs; ++j) sum += ps[(b0 + j) * d + k];
    dpb[i] = ps[i] - sum / bs;
  }
  x.sync();  // no CTA leaves while a peer still reads its partial
}

// grads[i] = sum over clouds of partials[cloud, i], clouds in order.
__global__ void erwin_block_sum_partials(const float* __restrict__ partials,
                                         float* __restrict__ grads,
                                         int clouds, int np) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np) return;
  float acc = 0.f;
  for (int b = 0; b < clouds; ++b)
    acc += partials[static_cast<size_t>(b) * np + i];
  grads[i] = acc;
}

// Raise a kernel's dynamic shared memory limit the first time a launch on
// this device needs more than any earlier one, not on every call.
template <class Kernel>
cudaError_t ensure_smem(Kernel kernel, int which, int smem) {
  static std::mutex mu;
  static int limit[64][4];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= limit[dev][which] || smem <= 48 * 1024) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) limit[dev][which] = smem;
  return err;
}

// The launch shape of both kernels: clouds clusters of k CTAs.
cudaLaunchConfig_t cluster_config(int clouds, int k, int smem,
                                  cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clouds * k));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Reads a layout; *all_smem tells whether it keeps every buffer in shared
// memory (the kernels' SMEM instantiation).
int log2_of(int pow2) {
  int l = 0;
  while ((1 << l) < pow2) ++l;
  return l;
}

Dims make_dims(int n, int c, int d, int heads, int bs, int hidden,
               int use_dist_bias) {
  return {n, c, d, heads, bs, hidden, use_dist_bias, log2_of(n), log2_of(bs),
          FastDiv(c), FastDiv(d), FastDiv(c / heads)};
}

bool read_layout(const int* layout, int nbuf, Layout* L, bool* all_smem) {
  if (nbuf > MAX_BUF) return false;
  *all_smem = true;
  for (int i = 0; i < nbuf; ++i) {
    L->off[i] = layout[i];
    L->in_smem[i] = layout[nbuf + i];
    *all_smem = *all_smem && L->in_smem[i];
  }
  L->scratch_stride = layout[2 * nbuf];
  return true;
}

}  // namespace

extern "C" {

const char* haet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x/out [clouds, n, c]; pos [clouds, n, d]; weights in torch Linear layout
// ([out, in]); sigma [heads]. bs divides n. cluster: CTAs per cloud (K).
// layout: NFWD offsets, NFWD shared-memory flags and the scratch stride, from
// erwin_block.py:fwd_layout, which also gives smem; scratch
// [clouds * K, stride] or null when nothing spills.
int haet_erwin_block_fwd_f32(
    const float* x, const float* pos, float* out, float* scratch,
    const float* g1, const float* wpe, const float* bpe, const float* wqkv,
    const float* bqkv, const float* sigma, const float* wo, const float* bo,
    const float* g2, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, int clouds, int n,
    int c, int d, int heads, int bs, int hidden, int use_dist_bias,
    int cluster, const int* layout, int smem, void* stream) {
  Layout L;
  bool all_smem;
  if (cluster < 1 || cluster > MAX_CLUSTER ||
      !read_layout(layout, NFWD, &L, &all_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = all_smem ? erwin_block_fwd<true> : erwin_block_fwd<false>;
  cudaError_t err = ensure_smem(kernel, all_smem ? 0 : 1, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  BlockParams p{g1, wpe, bpe, wqkv, bqkv, sigma, wo, bo, g2,
                w1, b1, w2, b2, w3, b3};
  const Dims D = make_dims(n, c, d, heads, bs, hidden, use_dist_bias);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      clouds, cluster, smem, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, kernel, x, pos, out, scratch, p, D, L);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The backward. x/pos/dout/dx/dpos as the forward's x/pos/out; partials
// [clouds, P] and grads [P] in PARAM_NAMES order without sigma (P from
// param_offsets, checked against np); layout (NBWD entries), scratch and
// smem as the forward's, from erwin_block.py:bwd_layout.
int haet_erwin_block_bwd_f32(
    const float* x, const float* pos, const float* dout, float* dx,
    float* dpos, float* partials, float* grads, float* scratch,
    const float* g1, const float* wpe, const float* bpe, const float* wqkv,
    const float* bqkv, const float* sigma, const float* wo, const float* bo,
    const float* g2, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, int clouds, int n,
    int c, int d, int heads, int bs, int hidden, int use_dist_bias, int np,
    int cluster, const int* layout, int smem, void* stream) {
  int go[14];
  Layout L;
  bool all_smem;
  if (np != param_offsets(c, d, hidden, go) || cluster < 1 ||
      cluster > MAX_CLUSTER || !read_layout(layout, NBWD, &L, &all_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = all_smem ? erwin_block_bwd<true> : erwin_block_bwd<false>;
  cudaError_t err = ensure_smem(kernel, all_smem ? 2 : 3, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  BlockParams p{g1, wpe, bpe, wqkv, bqkv, sigma, wo, bo, g2,
                w1, b1, w2, b2, w3, b3};
  const Dims D = make_dims(n, c, d, heads, bs, hidden, use_dist_bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(clouds, cluster, smem, st, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, x, pos, dout, dx, dpos, partials,
                           scratch, p, D, L);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  erwin_block_sum_partials<<<(np + 255) / 256, 256, 0, st>>>(
      partials, grads, clouds, np);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
