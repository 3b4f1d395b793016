// One whole Erwin transformer block, forward, for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// haet_tpu/ops/pallas/erwin_block.py (called from _fused_block_impl):
//   xn  = RMSNorm(x) * g1                        (eps 1e-6)
//   hm  = xn + (pos - ball centroid) @ Wpe^T + bpe
//   q,k,v per head = hm @ Wqkv^T + bqkv           (columns ordered 3, h, hd)
//   a   = softmax_ball(q k^T / sqrt(hd) + sigma_h * |p_i - p_j|)
//   x1  = x + (a v) @ Wo^T + bo
//   out = x1 + (t * silu(u)) @ W3^T + b3,  u = zn W1^T + b1, t = zn W2^T + b2,
//         zn = RMSNorm(x1) * g2
//
// What bounds it on an H100: nothing but launches. At the car shapes a call
// is 8 clouds (B*H) of n = 32 points at C = 32 (or n = 16 at C = 64) and
// moves ~0.1-0.3 MB of activations and weights: ~0.1 us of HBM time and
// ~2-5 MFLOP, against several microseconds of launch overhead. Twelve calls
// run per Erwin stage, 24 per model forward.
//
// Design:
//   * One block per cloud; the whole block's activations live in shared
//     memory (x, the normed/hm buffer, qkv, the attention output, the SwiGLU
//     hidden, positions). The Pallas kernel folded clouds up to 256 rows and
//     expressed balls as a [rows, rows] block-diagonal mask to keep every op
//     a 2D matmul on the MXU; here each (head, query) thread attends within
//     its own ball directly, with no mask and no folding.
//   * The distance bias is computed from coordinate differences,
//     sqrt(|d|^2 + 1e-12), as the plain path does (not pp + pp^T - 2 p p^T).
//   * Weights are read from global memory (L2-resident after the first
//     cloud): at C = 64, Wqkv + W1 + W2 + W3 alone are ~240 KB of float32,
//     more than the 227 KB of shared memory a block may use.
//   * Shared memory per block is 4 * n * (6C + hidden + 2D + 6) bytes (rows
//     padded by one float against bank conflicts); the wrapper's eligible()
//     gate admits a shape only if that fits in 227 KB (n <= 128 at C = 32,
//     hidden 128; n <= 64 at C = 64, hidden 256).
//   * The matrix products give consecutive threads consecutive rows of one
//     output column, so each warp reads a weight row as one broadcast.
// Simple and right first: every product is a scalar float32 FMA loop.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 512;  // threads per block

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

__device__ __forceinline__ float dot_rows(const float* a, const float* b,
                                          int k) {
  float acc = 0.f;
  for (int i = 0; i < k; ++i) acc = fmaf(a[i], b[i], acc);
  return acc;
}

__global__ void __launch_bounds__(NT)
erwin_block_fwd(const float* __restrict__ x, const float* __restrict__ pos,
                float* __restrict__ out, BlockParams p, int n, int c, int d,
                int heads, int bs, int hidden, int use_dist_bias) {
  // Row strides are padded by one float so that threads of a warp that hold
  // consecutive rows r read row-major shared memory on distinct banks.
  const int ldc = c + 1, ld3 = 3 * c + 1, ldg = hidden + 1;
  extern __shared__ float sm[];
  float* xs = sm;                  // [n, ldc] residual stream (x, x1, out)
  float* hs = xs + n * ldc;        // [n, ldc] hm, then zn
  float* qkv = hs + n * ldc;       // [n, ld3]
  float* os = qkv + n * ld3;       // [n, ldc] attention output
  float* gv = os + n * ldc;        // [n, ldg] SwiGLU hidden
  float* ps = gv + n * ldg;        // [n, d] positions
  float* rel = ps + n * d;         // [n, d] position - ball centroid
  float* rinv = rel + n * d;       // [n] RMSNorm 1/rms

  const int tid = threadIdx.x;
  const size_t cloud = blockIdx.x;
  const float* xb = x + cloud * n * c;
  const float* pb = pos + cloud * n * d;
  float* ob = out + cloud * n * c;
  const int hd = c / heads;
  const float scale = rsqrtf(static_cast<float>(hd));

  for (int i = tid; i < n * c; i += NT) xs[(i / c) * ldc + i % c] = xb[i];
  for (int i = tid; i < n * d; i += NT) ps[i] = pb[i];
  __syncthreads();

  // RMSNorm 1 and the relative positions.
  for (int r = tid; r < n; r += NT)
    rinv[r] = rsqrtf(dot_rows(xs + r * ldc, xs + r * ldc, c) / c + 1e-6f);
  for (int i = tid; i < n * d; i += NT) {
    const int r = i / d, k = i % d;
    const int b0 = (r / bs) * bs;
    float sum = 0.f;
    for (int j = 0; j < bs; ++j) sum += ps[(b0 + j) * d + k];
    rel[i] = ps[i] - sum / bs;
  }
  __syncthreads();

  // hm = xn + rel @ Wpe^T + bpe
  for (int i = tid; i < n * c; i += NT) {
    const int r = i / c, j = i % c;
    const float pe = p.bpe[j] + dot_rows(rel + r * d, p.wpe + j * d, d);
    hs[r * ldc + j] = xs[r * ldc + j] * rinv[r] * p.g1[j] + pe;
  }
  __syncthreads();

  // Products below map consecutive threads to consecutive rows of one
  // output column j: the weight row is one broadcast read per warp.
  // qkv = hm @ Wqkv^T + bqkv
  for (int i = tid; i < n * 3 * c; i += NT) {
    const int j = i / n, r = i % n;
    qkv[r * ld3 + j] = p.bqkv[j] + dot_rows(hs + r * ldc, p.wqkv + j * c, c);
  }
  __syncthreads();

  // Ball attention: one thread per (head, query row), two passes over the
  // keys of its ball (max, then exp-sum and the weighted sum of v).
  for (int t = tid; t < heads * n; t += NT) {
    const int h = t / n, r = t % n;
    const int b0 = (r / bs) * bs;
    const float* q = qkv + r * ld3 + h * hd;
    const float sig = use_dist_bias ? p.sigma[h] : 0.f;
    float mx = -INFINITY;
    for (int jj = 0; jj < bs; ++jj) {
      const int j = b0 + jj;
      float l = dot_rows(q, qkv + j * ld3 + c + h * hd, hd) * scale;
      if (use_dist_bias) {
        float d2 = 0.f;
        for (int k = 0; k < d; ++k) {
          const float df = ps[r * d + k] - ps[j * d + k];
          d2 = fmaf(df, df, d2);
        }
        l += sig * sqrtf(d2 + 1e-12f);
      }
      mx = fmaxf(mx, l);
    }
    float* o = os + r * ldc + h * hd;
    for (int k = 0; k < hd; ++k) o[k] = 0.f;
    float sum = 0.f;
    for (int jj = 0; jj < bs; ++jj) {
      const int j = b0 + jj;
      float l = dot_rows(q, qkv + j * ld3 + c + h * hd, hd) * scale;
      if (use_dist_bias) {
        float d2 = 0.f;
        for (int k = 0; k < d; ++k) {
          const float df = ps[r * d + k] - ps[j * d + k];
          d2 = fmaf(df, df, d2);
        }
        l += sig * sqrtf(d2 + 1e-12f);
      }
      const float e = expf(l - mx);
      sum += e;
      const float* v = qkv + j * ld3 + 2 * c + h * hd;
      for (int k = 0; k < hd; ++k) o[k] = fmaf(e, v[k], o[k]);
    }
    const float inv = 1.f / sum;
    for (int k = 0; k < hd; ++k) o[k] *= inv;
  }
  __syncthreads();

  // x1 = x + o @ Wo^T + bo (each thread owns its element of xs)
  for (int i = tid; i < n * c; i += NT) {
    const int j = i / n, r = i % n;
    xs[r * ldc + j] += p.bo[j] + dot_rows(os + r * ldc, p.wo + j * c, c);
  }
  __syncthreads();

  // RMSNorm 2
  for (int r = tid; r < n; r += NT)
    rinv[r] = rsqrtf(dot_rows(xs + r * ldc, xs + r * ldc, c) / c + 1e-6f);
  __syncthreads();
  for (int i = tid; i < n * c; i += NT) {
    const int r = i / c, j = i % c;
    hs[r * ldc + j] = xs[r * ldc + j] * rinv[r] * p.g2[j];
  }
  __syncthreads();

  // SwiGLU hidden: t * silu(u)
  for (int i = tid; i < n * hidden; i += NT) {
    const int j = i / n, r = i % n;
    const float u = p.b1[j] + dot_rows(hs + r * ldc, p.w1 + j * c, c);
    const float tv = p.b2[j] + dot_rows(hs + r * ldc, p.w2 + j * c, c);
    gv[r * ldg + j] = tv * (u / (1.f + expf(-u)));
  }
  __syncthreads();

  // out = x1 + gv @ W3^T + b3, staged in xs, then stored row-major
  for (int i = tid; i < n * c; i += NT) {
    const int j = i / n, r = i % n;
    xs[r * ldc + j] += p.b3[j] + dot_rows(gv + r * ldg, p.w3 + j * hidden,
                                          hidden);
  }
  __syncthreads();
  for (int i = tid; i < n * c; i += NT) ob[i] = xs[(i / c) * ldc + i % c];
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
// What bounds it on an H100: as the forward, launches and the serial work
// of one CTA per cloud (8 CTAs at the car shapes), not bytes or FLOP: a call
// moves ~0.2-0.6 MB and does ~3x the forward's ~2-5 MFLOP.
//
// Design:
//   * The TPU kernel adds every cloud's parameter gradients into whole-array
//     outputs across its sequential grid. Here the CTAs run in parallel, so
//     each writes its own partial gradients to a [clouds, P] buffer (P: all
//     parameter elements but sigma, in the wrapper's PARAM_NAMES order), and
//     a second kernel, erwin_block_sum_partials, sums them over the clouds
//     in a fixed order: deterministic, no atomics.
//   * The backward holds more live buffers than the forward: 18 of them,
//     listed in the BwdBuf enum. The wrapper (erwin_block.py:bwd_layout)
//     places them in priority order into the 227 KB of shared memory and the
//     rest into a per-cloud global scratch (L2-resident at these sizes); the
//     kernel reaches both through generic pointers. At the car shapes
//     everything is in shared memory (~152 KB at n 32 / C 32, ~103 KB at
//     n 16 / C 64); at the largest clouds the forward's gate admits, the
//     SwiGLU hidden and the attention probabilities spill to the scratch. So
//     the backward takes every shape the forward takes: one gate.
//   * The attention probabilities of every (head, query) row are kept
//     (P, [heads, n, ball]) from the recomputed forward, and the softmax
//     gradients beside them (DS); dk and dv, sums over the queries of a key,
//     then read them by column.
//   * Products map consecutive threads to consecutive rows of one output
//     column (a weight read is one broadcast per warp), and parameter
//     gradients map consecutive threads to consecutive input columns.
// Simple and right first: every product is a scalar float32 FMA loop.

// The backward's buffers, in the order of erwin_block.py:BWD_BUFFERS.
enum BwdBuf {
  B_X, B_HM, B_QKV, B_O, B_X1, B_ZN, B_G, B_DZ, B_DQKV, B_PS, B_REL, B_R1,
  B_R2, B_ROW, B_U, B_T, B_P, B_DS, NBUF
};

struct BwdLayout {
  int off[NBUF];       // offset in floats, in shared memory or the scratch
  int in_smem[NBUF];   // 1: shared memory, 0: the cloud's global scratch
  int scratch_stride;  // floats of global scratch per cloud
};

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

__device__ __forceinline__ float dot_strided(const float* a, const float* b,
                                             int k, int ldb) {
  float acc = 0.f;
  for (int i = 0; i < k; ++i) acc = fmaf(a[i], b[i * ldb], acc);
  return acc;
}

// dst[i * nb + j] = sum_r A[r * lda + i] * B[r * ldb + j]: the gradient of a
// torch-layout weight [na, nb] from the output gradient A and the input B.
__device__ void outer_sum(float* dst, const float* A, int lda, int na,
                          const float* B, int ldb, int nb, int rows) {
  for (int e = threadIdx.x; e < na * nb; e += NT) {
    const int i = e / nb, j = e % nb;
    float acc = 0.f;
    for (int r = 0; r < rows; ++r)
      acc = fmaf(A[r * lda + i], B[r * ldb + j], acc);
    dst[e] = acc;
  }
}

// dst[i] = sum_r A[r * lda + i]: the gradient of a bias.
__device__ void col_sum(float* dst, const float* A, int lda, int na,
                        int rows) {
  for (int i = threadIdx.x; i < na; i += NT) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc += A[r * lda + i];
    dst[i] = acc;
  }
}

__global__ void __launch_bounds__(NT)
erwin_block_bwd(const float* __restrict__ x, const float* __restrict__ pos,
                const float* __restrict__ dout, float* __restrict__ dx,
                float* __restrict__ dpos, float* __restrict__ partials,
                float* scratch, BlockParams p, BwdLayout L, int n, int c,
                int d, int heads, int bs, int hidden, int use_dist_bias) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const size_t cloud = blockIdx.x;
  float* gs = scratch + cloud * static_cast<size_t>(L.scratch_stride);
  float* buf[NBUF];
  for (int i = 0; i < NBUF; ++i)
    buf[i] = (L.in_smem[i] ? sm : gs) + L.off[i];
  float* xs = buf[B_X];      // [n, ldc] x
  float* hs = buf[B_HM];     // [n, ldc] hm
  float* qkv = buf[B_QKV];   // [n, ld3]
  float* os = buf[B_O];      // [n, ldc] attention output
  float* x1 = buf[B_X1];     // [n, ldc] x + attention
  float* zn = buf[B_ZN];     // [n, ldc] RMSNorm 2 output
  float* gd = buf[B_G];      // [n, ldc] dout, then dx1
  float* dz = buf[B_DZ];     // [n, ldc] dzn, then do, then dhm
  float* dqkv = buf[B_DQKV]; // [n, ld3]
  float* ps = buf[B_PS];     // [n, d] positions, then drel
  float* rel = buf[B_REL];   // [n, d]
  float* r1 = buf[B_R1];     // [n] 1/rms of x
  float* r2 = buf[B_R2];     // [n] 1/rms of x1
  float* rowdot = buf[B_ROW];  // [n] RMSNorm backward row sums
  float* us = buf[B_U];      // [n, ldg] u, then du
  float* ts = buf[B_T];      // [n, ldg] t, then dt
  float* pa = buf[B_P];      // [heads, n, bs] attention probabilities
  float* dsa = buf[B_DS];    // [heads, n, bs] softmax gradients

  const int ldc = c + 1, ld3 = 3 * c + 1, ldg = hidden + 1;
  const int hd = c / heads;
  const float scale = rsqrtf(static_cast<float>(hd));
  int go[14];
  const int np = param_offsets(c, d, hidden, go);
  float* part = partials + cloud * static_cast<size_t>(np);
  const float* xb = x + cloud * n * c;
  const float* gb = dout + cloud * n * c;
  const float* pb = pos + cloud * n * d;

  // ---- recompute the forward ----------------------------------------------
  for (int i = tid; i < n * c; i += NT) {
    const int r = i / c, j = i % c;
    xs[r * ldc + j] = xb[i];
    gd[r * ldc + j] = gb[i];
  }
  for (int i = tid; i < n * d; i += NT) ps[i] = pb[i];
  __syncthreads();
  for (int r = tid; r < n; r += NT)
    r1[r] = rsqrtf(dot_rows(xs + r * ldc, xs + r * ldc, c) / c + 1e-6f);
  for (int i = tid; i < n * d; i += NT) {
    const int r = i / d, k = i % d;
    const int b0 = (r / bs) * bs;
    float sum = 0.f;
    for (int j = 0; j < bs; ++j) sum += ps[(b0 + j) * d + k];
    rel[i] = ps[i] - sum / bs;
  }
  __syncthreads();
  for (int i = tid; i < n * c; i += NT) {
    const int r = i / c, j = i % c;
    const float pe = p.bpe[j] + dot_rows(rel + r * d, p.wpe + j * d, d);
    hs[r * ldc + j] = xs[r * ldc + j] * r1[r] * p.g1[j] + pe;
  }
  __syncthreads();
  for (int i = tid; i < n * 3 * c; i += NT) {
    const int j = i / n, r = i % n;
    qkv[r * ld3 + j] = p.bqkv[j] + dot_rows(hs + r * ldc, p.wqkv + j * c, c);
  }
  __syncthreads();
  // One thread per (head, query row): its probabilities over the ball into
  // pa, and its share of the attention output.
  for (int t = tid; t < heads * n; t += NT) {
    const int h = t / n, r = t % n;
    const int b0 = (r / bs) * bs;
    const float* q = qkv + r * ld3 + h * hd;
    const float sig = use_dist_bias ? p.sigma[h] : 0.f;
    float* prow = pa + (h * n + r) * bs;
    float mx = -INFINITY;
    for (int jj = 0; jj < bs; ++jj) {
      const int j = b0 + jj;
      float l = dot_rows(q, qkv + j * ld3 + c + h * hd, hd) * scale;
      if (use_dist_bias) {
        float d2 = 0.f;
        for (int k = 0; k < d; ++k) {
          const float df = ps[r * d + k] - ps[j * d + k];
          d2 = fmaf(df, df, d2);
        }
        l += sig * sqrtf(d2 + 1e-12f);
      }
      prow[jj] = l;
      mx = fmaxf(mx, l);
    }
    float sum = 0.f;
    for (int jj = 0; jj < bs; ++jj) {
      const float e = expf(prow[jj] - mx);
      prow[jj] = e;
      sum += e;
    }
    const float inv = 1.f / sum;
    float* o = os + r * ldc + h * hd;
    for (int k = 0; k < hd; ++k) o[k] = 0.f;
    for (int jj = 0; jj < bs; ++jj) {
      const float a = prow[jj] * inv;
      prow[jj] = a;
      const float* v = qkv + (b0 + jj) * ld3 + 2 * c + h * hd;
      for (int k = 0; k < hd; ++k) o[k] = fmaf(a, v[k], o[k]);
    }
  }
  __syncthreads();
  for (int i = tid; i < n * c; i += NT) {
    const int j = i / n, r = i % n;
    x1[r * ldc + j] = xs[r * ldc + j] + p.bo[j]
                      + dot_rows(os + r * ldc, p.wo + j * c, c);
  }
  __syncthreads();
  for (int r = tid; r < n; r += NT)
    r2[r] = rsqrtf(dot_rows(x1 + r * ldc, x1 + r * ldc, c) / c + 1e-6f);
  __syncthreads();
  for (int i = tid; i < n * c; i += NT) {
    const int r = i / c, j = i % c;
    zn[r * ldc + j] = x1[r * ldc + j] * r2[r] * p.g2[j];
  }
  __syncthreads();
  for (int i = tid; i < n * hidden; i += NT) {
    const int j = i / n, r = i % n;
    us[r * ldg + j] = p.b1[j] + dot_rows(zn + r * ldc, p.w1 + j * c, c);
    ts[r * ldg + j] = p.b2[j] + dot_rows(zn + r * ldc, p.w2 + j * c, c);
  }
  __syncthreads();

  // ---- SwiGLU half: out = x1 + w3(t * silu(u)) ----------------------------
  for (int e = tid; e < c * hidden; e += NT) {
    const int j = e / hidden, k = e % hidden;
    float acc = 0.f;
    for (int r = 0; r < n; ++r) {
      const float u = us[r * ldg + k];
      const float gv = ts[r * ldg + k] * (u / (1.f + expf(-u)));
      acc = fmaf(gd[r * ldc + j], gv, acc);
    }
    part[go[G_W3] + e] = acc;
  }
  col_sum(part + go[G_B3], gd, ldc, c, n);
  __syncthreads();
  // du and dt in place of u and t
  for (int i = tid; i < n * hidden; i += NT) {
    const int k = i / n, r = i % n;
    const float dgv = dot_strided(gd + r * ldc, p.w3 + k, c, hidden);
    const float u = us[r * ldg + k], tv = ts[r * ldg + k];
    const float sg = 1.f / (1.f + expf(-u));
    us[r * ldg + k] = dgv * tv * sg * (1.f + u * (1.f - sg));
    ts[r * ldg + k] = dgv * u * sg;
  }
  __syncthreads();
  outer_sum(part + go[G_W1], us, ldg, hidden, zn, ldc, c, n);
  col_sum(part + go[G_B1], us, ldg, hidden, n);
  outer_sum(part + go[G_W2], ts, ldg, hidden, zn, ldc, c, n);
  col_sum(part + go[G_B2], ts, ldg, hidden, n);
  for (int i = tid; i < n * c; i += NT) {
    const int j = i / n, r = i % n;
    dz[r * ldc + j] = dot_strided(us + r * ldg, p.w1 + j, hidden, c)
                      + dot_strided(ts + r * ldg, p.w2 + j, hidden, c);
  }
  __syncthreads();

  // ---- RMSNorm 2 ----------------------------------------------------------
  for (int i = tid; i < c; i += NT) {
    float acc = 0.f;
    for (int r = 0; r < n; ++r)
      acc = fmaf(dz[r * ldc + i] * x1[r * ldc + i], r2[r], acc);
    part[go[G_G2] + i] = acc;
  }
  for (int r = tid; r < n; r += NT) {
    float acc = 0.f;
    for (int j = 0; j < c; ++j)
      acc = fmaf(dz[r * ldc + j] * p.g2[j], x1[r * ldc + j], acc);
    rowdot[r] = acc;
  }
  __syncthreads();
  for (int i = tid; i < n * c; i += NT) {
    const int r = i / c, j = i % c;
    const float rr = r2[r];
    gd[r * ldc + j] += dz[r * ldc + j] * p.g2[j] * rr
                       - x1[r * ldc + j] * (rowdot[r] * rr * rr * rr / c);
  }
  __syncthreads();

  // ---- attention half: dy = dx1 -------------------------------------------
  col_sum(part + go[G_BO], gd, ldc, c, n);
  outer_sum(part + go[G_WO], gd, ldc, c, os, ldc, c, n);
  for (int i = tid; i < n * c; i += NT) {
    const int j = i / n, r = i % n;
    dz[r * ldc + j] = dot_strided(gd + r * ldc, p.wo + j, c, c);   // do
  }
  __syncthreads();
  // One thread per (head, query row): the softmax gradient row and dq.
  for (int t = tid; t < heads * n; t += NT) {
    const int h = t / n, r = t % n;
    const int b0 = (r / bs) * bs;
    const float* prow = pa + (h * n + r) * bs;
    float* dsrow = dsa + (h * n + r) * bs;
    const float* dor = dz + r * ldc + h * hd;
    float dsum = 0.f;
    for (int jj = 0; jj < bs; ++jj) {
      const float da =
          dot_rows(dor, qkv + (b0 + jj) * ld3 + 2 * c + h * hd, hd);
      dsrow[jj] = da;
      dsum = fmaf(da, prow[jj], dsum);
    }
    for (int jj = 0; jj < bs; ++jj) dsrow[jj] = prow[jj] * (dsrow[jj] - dsum);
    for (int e = 0; e < hd; ++e) {
      float acc = 0.f;
      for (int jj = 0; jj < bs; ++jj)
        acc = fmaf(dsrow[jj], qkv[(b0 + jj) * ld3 + c + h * hd + e], acc);
      dqkv[r * ld3 + h * hd + e] = acc * scale;
    }
  }
  __syncthreads();
  // dk and dv: for key row j, sums over the queries of its ball.
  for (int i = tid; i < n * 2 * c; i += NT) {
    const int col = i / n, j = i % n;
    const int b0 = (j / bs) * bs, jj = j - b0;
    const int cc = col < c ? col : col - c;
    const int h = cc / hd;
    float acc = 0.f;
    if (col < c) {
      for (int rr = 0; rr < bs; ++rr)
        acc = fmaf(dsa[(h * n + b0 + rr) * bs + jj],
                   qkv[(b0 + rr) * ld3 + cc], acc);
      dqkv[j * ld3 + c + cc] = acc * scale;
    } else {
      for (int rr = 0; rr < bs; ++rr)
        acc = fmaf(pa[(h * n + b0 + rr) * bs + jj],
                   dz[(b0 + rr) * ldc + cc], acc);
      dqkv[j * ld3 + 2 * c + cc] = acc;
    }
  }
  __syncthreads();
  outer_sum(part + go[G_WQKV], dqkv, ld3, 3 * c, hs, ldc, c, n);
  col_sum(part + go[G_BQKV], dqkv, ld3, 3 * c, n);
  for (int i = tid; i < n * c; i += NT) {
    const int j = i / n, r = i % n;
    dz[r * ldc + j] = dot_strided(dqkv + r * ld3, p.wqkv + j, 3 * c, c);
  }
  __syncthreads();

  // ---- rel-pos and RMSNorm 1: dz holds dhm --------------------------------
  outer_sum(part + go[G_WPE], dz, ldc, c, rel, d, d, n);
  col_sum(part + go[G_BPE], dz, ldc, c, n);
  for (int i = tid; i < c; i += NT) {
    float acc = 0.f;
    for (int r = 0; r < n; ++r)
      acc = fmaf(dz[r * ldc + i] * xs[r * ldc + i], r1[r], acc);
    part[go[G_G1] + i] = acc;
  }
  for (int r = tid; r < n; r += NT) {
    float acc = 0.f;
    for (int j = 0; j < c; ++j)
      acc = fmaf(dz[r * ldc + j] * p.g1[j], xs[r * ldc + j], acc);
    rowdot[r] = acc;
  }
  for (int i = tid; i < n * d; i += NT) {   // drel, in place of pos
    const int r = i / d, k = i % d;
    ps[i] = dot_strided(dz + r * ldc, p.wpe + k, c, d);
  }
  __syncthreads();
  float* dxb = dx + cloud * n * c;
  for (int i = tid; i < n * c; i += NT) {
    const int r = i / c, j = i % c;
    const float rr = r1[r];
    dxb[i] = gd[r * ldc + j] + dz[r * ldc + j] * p.g1[j] * rr
             - xs[r * ldc + j] * (rowdot[r] * rr * rr * rr / c);
  }
  float* dpb = dpos + cloud * n * d;
  for (int i = tid; i < n * d; i += NT) {
    const int r = i / d, k = i % d;
    const int b0 = (r / bs) * bs;
    float sum = 0.f;
    for (int j = 0; j < bs; ++j) sum += ps[(b0 + j) * d + k];
    dpb[i] = ps[i] - sum / bs;
  }
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

}  // namespace

extern "C" {

const char* haet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x/out [clouds, n, c]; pos [clouds, n, d]; weights in torch Linear layout
// ([out, in]); sigma [heads]. bs divides n. smem is the dynamic shared
// memory, 4 * n * (6c + hidden + 2d + 6) bytes, computed by the wrapper
// (haet_torch/ops/kernels/erwin_block.py:smem_bytes), which also gates it.
int haet_erwin_block_fwd_f32(
    const float* x, const float* pos, float* out, const float* g1,
    const float* wpe, const float* bpe, const float* wqkv, const float* bqkv,
    const float* sigma, const float* wo, const float* bo, const float* g2,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, const float* b3, int clouds, int n, int c, int d,
    int heads, int bs, int hidden, int use_dist_bias, int smem,
    void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        erwin_block_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  BlockParams p{g1, wpe, bpe, wqkv, bqkv, sigma, wo, bo, g2,
                w1, b1, w2, b2, w3, b3};
  erwin_block_fwd<<<clouds, NT, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      x, pos, out, p, n, c, d, heads, bs, hidden, use_dist_bias);
  return static_cast<int>(cudaGetLastError());
}

// The backward. x/pos/dout/dx/dpos as the forward's x/pos/out; partials
// [clouds, P] and grads [P] in PARAM_NAMES order without sigma (P from
// param_offsets, checked against np); scratch [clouds, layout's stride] or
// null. layout: NBUF offsets, NBUF shared-memory flags and the scratch
// stride, from erwin_block.py:bwd_layout, which also gives smem.
int haet_erwin_block_bwd_f32(
    const float* x, const float* pos, const float* dout, float* dx,
    float* dpos, float* partials, float* grads, float* scratch,
    const float* g1, const float* wpe, const float* bpe, const float* wqkv,
    const float* bqkv, const float* sigma, const float* wo, const float* bo,
    const float* g2, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, int clouds, int n,
    int c, int d, int heads, int bs, int hidden, int use_dist_bias, int np,
    const int* layout, int smem, void* stream) {
  int go[14];
  if (np != param_offsets(c, d, hidden, go))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdLayout L;
  for (int i = 0; i < NBUF; ++i) {
    L.off[i] = layout[i];
    L.in_smem[i] = layout[NBUF + i];
  }
  L.scratch_stride = layout[2 * NBUF];
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        erwin_block_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  BlockParams p{g1, wpe, bpe, wqkv, bqkv, sigma, wo, bo, g2,
                w1, b1, w2, b2, w3, b3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  erwin_block_bwd<<<clouds, NT, static_cast<size_t>(smem), st>>>(
      x, pos, dout, dx, dpos, partials, scratch, p, L, n, c, d, heads, bs,
      hidden, use_dist_bias);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  erwin_block_sum_partials<<<(np + 255) / 256, 256, 0, st>>>(
      partials, grads, clouds, np);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
