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

}  // extern "C"
