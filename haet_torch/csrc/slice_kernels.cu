// Rep-slice tokenizer kernels for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of haet_tpu/ops/pallas/slice_kernels.py:
//   * slice_states (_slice_states_kernel, called from _slice_states_impl_f32)
//   * deslice      (_deslice_kernel, called from _deslice_impl)
//
// Math, per (b, h) cloud of N points with C channels and G slices:
//   tau[n]     = base + clamp(x[n] . Wa + ba, -0.4, 0.4)
//   z[n, g]    = (x[n] . Ws[:, g] + bs[g] - log(-log eps)) / tau[n]
//   m[g]       = max_n z[n, g];  s[g] = sum_n exp(z[n, g] - m[g])
//   states[g]  = (sum_n exp(z[n, g] - m[g]) x[n]) / s[g] / (1 + 1e-5)
//   deslice:   out[n, c] = sum_g exp(z[n, g] - m[g]) / s[g] * states[g, c]
// The [B, H, N, G] weight tensor is never written to device memory.
//
// What bounds them on an H100: at the car shapes (BH = 8, N = 32186, C = G =
// 32) slice_states reads 33 MB and does ~1.05 GFLOP of float32 FMA (the
// logits and the weighted sum, 2*N*C*G each per cloud); deslice reads 33 MB,
// writes 33 MB and does the same FLOPs. Against 3.35 TB/s and 67 TFLOP/s
// (float32, no tensor cores: the logits must stay out of TF32, as the JAX
// reference computes them at Precision.HIGHEST) slice_states is bound by
// operations (~16 us) and deslice by bytes (~20 us).
//
// Design:
//   * The Pallas grid (B*H, N tiles) runs its N tiles in order, carrying the
//     online-softmax state (m, s, acc) from tile to tile. On the GPU that
//     would be only B*H = 8 blocks. slice_states instead splits N into
//     chunks of `chunk` points (256 from the wrapper), one block each
//     (8 x 126 blocks at the car shapes); each block runs the online
//     softmax over its chunk and writes a partial (m, s, acc[G, C]). A
//     second launch, one block per (cloud, slice) (8 x 32 blocks), merges
//     the partials by log-sum-exp and writes states, m and s.
//   * Ws, bs and Wa sit in shared memory; every product is float32 FMA.
//   * The ragged last chunk and tile are masked: padded rows get logit -inf
//     and zero features, as the Pallas kernel does.
//   * The Pallas guards stay: a column whose running max is still -inf uses
//     0 as its shift and contributes nothing; s == 0 divides by 1.
//   * deslice needs no reduction across points: one block per (cloud, tile
//     of DTILE points) recomputes the weights from (m, s) and multiplies by
//     the states held in shared memory.
// Simple and right first: no tensor cores, no TMA, no overlap of loads.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int TILE = 32;     // points per inner tile of slice_partials
constexpr int MAX_ACC = 8;   // G*C <= NT*MAX_ACC accumulator entries
constexpr int DTILE = 64;    // points per deslice block

__device__ __forceinline__ float tau_of(const float* xr, const float* wa,
                                        float ba, int c, float base_temp) {
  float raw = ba;
  for (int k = 0; k < c; ++k) raw = fmaf(xr[k], wa[k], raw);
  return base_temp + fminf(fmaxf(raw, -0.4f), 0.4f);
}

__device__ __forceinline__ float logit_of(const float* xr, const float* ws,
                                          float bsj, int j, int c, int g,
                                          float shift, float tau) {
  float acc = 0.f;
  for (int k = 0; k < c; ++k) acc = fmaf(xr[k], ws[k * g + j], acc);
  return (acc + bsj - shift) / tau;
}

// grid (n_chunks, bh); partial softmax state of one chunk of one cloud.
__global__ void __launch_bounds__(NT)
slice_partials(const float* __restrict__ x, const float* __restrict__ ws,
               const float* __restrict__ bs, const float* __restrict__ wa,
               const float* __restrict__ ba, float* __restrict__ part_m,
               float* __restrict__ part_s, float* __restrict__ part_acc,
               int n, int c, int g, int chunk, float base_temp, float shift) {
  extern __shared__ float sm[];
  float* ws_s = sm;                 // [c, g]
  float* bs_s = ws_s + c * g;       // [g]
  float* wa_s = bs_s + g;           // [c]
  float* xt = wa_s + c;             // [TILE, c]
  float* lt = xt + TILE * c;        // [TILE, g] logits, then exp weights
  float* tau = lt + TILE * g;       // [TILE]
  float* m_run = tau + TILE;        // [g] running max
  float* s_run = m_run + g;         // [g] running sum
  float* shift_s = s_run + g;       // [g] finite shift of this tile
  float* resc = shift_s + g;        // [g] rescale of the old state

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int ck = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int row0 = ck * chunk;
  const int rows = min(chunk, n - row0);
  const float* xb = x + ((size_t)bh * n + row0) * c;
  const float ba0 = ba[0];
  const int gc = g * c;

  for (int i = tid; i < c * g; i += NT) ws_s[i] = ws[i];
  for (int i = tid; i < g; i += NT) {
    bs_s[i] = bs[i];
    m_run[i] = -INFINITY;
    s_run[i] = 0.f;
  }
  for (int i = tid; i < c; i += NT) wa_s[i] = wa[i];

  float acc[MAX_ACC];
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) acc[a] = 0.f;

  for (int t0 = 0; t0 < rows; t0 += TILE) {
    const int tr = min(TILE, rows - t0);
    __syncthreads();  // previous tile fully consumed (and weights loaded)
    for (int i = tid; i < TILE * c; i += NT) {
      const int r = i / c;
      xt[i] = r < tr ? xb[(size_t)t0 * c + i] : 0.f;
    }
    __syncthreads();
    for (int r = tid; r < TILE; r += NT)
      tau[r] = tau_of(xt + r * c, wa_s, ba0, c, base_temp);
    __syncthreads();
    for (int i = tid; i < TILE * g; i += NT) {
      const int r = i / g, j = i % g;
      lt[i] = r < tr ? logit_of(xt + r * c, ws_s, bs_s[j], j, c, g, shift,
                                tau[r])
                     : -INFINITY;
    }
    __syncthreads();
    for (int j = tid; j < g; j += NT) {
      float mx = -INFINITY;
      for (int r = 0; r < tr; ++r) mx = fmaxf(mx, lt[r * g + j]);
      const float m_old = m_run[j];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      resc[j] = isfinite(m_old) ? expf(m_old - m_safe) : 0.f;
      shift_s[j] = m_safe;
      m_run[j] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < TILE * g; i += NT) {
      const int r = i / g, j = i % g;
      lt[i] = r < tr ? expf(lt[i] - shift_s[j]) : 0.f;
    }
    __syncthreads();
    for (int j = tid; j < g; j += NT) {
      float sum = 0.f;
      for (int r = 0; r < tr; ++r) sum += lt[r * g + j];
      s_run[j] = s_run[j] * resc[j] + sum;
    }
#pragma unroll
    for (int a = 0; a < MAX_ACC; ++a) {
      const int e = tid + a * NT;
      if (e < gc) {
        const int j = e / c, cc = e % c;
        float v = acc[a] * resc[j];
        for (int r = 0; r < tr; ++r) v = fmaf(lt[r * g + j], xt[r * c + cc], v);
        acc[a] = v;
      }
    }
  }
  __syncthreads();
  const size_t part = (size_t)bh * n_chunks + ck;
  for (int j = tid; j < g; j += NT) {
    part_m[part * g + j] = m_run[j];
    part_s[part * g + j] = s_run[j];
  }
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) {
    const int e = tid + a * NT;
    if (e < gc) part_acc[part * gc + e] = acc[a];
  }
}

constexpr int WARPS = NT / 32;

// Sum (or max) over the block; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  __syncthreads();  // red is free (an earlier reduction has been read)
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < WARPS; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// grid (g, bh); merge the chunk partials of one (cloud, slice) by
// log-sum-exp. The chunks are split over the warps, a warp's lanes over
// channels (coalesced reads of part_acc rows).
__global__ void __launch_bounds__(NT)
slice_merge(const float* __restrict__ part_m, const float* __restrict__ part_s,
            const float* __restrict__ part_acc, float* __restrict__ states,
            float* __restrict__ m_out, float* __restrict__ s_out,
            int n_chunks, int c, int g) {
  __shared__ float red[WARPS];
  __shared__ float vsum[WARPS][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x;
  const int bh = blockIdx.y;
  const float* pm = part_m + (size_t)bh * n_chunks * g + j;  // stride g
  const float* ps = part_s + (size_t)bh * n_chunks * g + j;
  const float* pa = part_acc + ((size_t)bh * n_chunks * g + j) * c;  // stride g*c

  float mx = -INFINITY;
  for (int k = tid; k < n_chunks; k += NT) mx = fmaxf(mx, pm[(size_t)k * g]);
  mx = block_reduce<true>(mx, red);
  const float ms = isfinite(mx) ? mx : 0.f;
  float s = 0.f;
  for (int k = tid; k < n_chunks; k += NT) {
    const float mk = pm[(size_t)k * g];
    if (isfinite(mk)) s = fmaf(ps[(size_t)k * g], expf(mk - ms), s);
  }
  s = block_reduce<false>(s, red);
  const float denom = s > 0.f ? s : 1.f;
  if (tid == 0) {
    m_out[(size_t)bh * g + j] = mx;
    s_out[(size_t)bh * g + j] = s;
  }
  for (int c0 = 0; c0 < c; c0 += 32) {
    const int cc = c0 + lane;
    float v = 0.f;
    if (cc < c) {
      for (int k = warp; k < n_chunks; k += WARPS) {
        const float mk = pm[(size_t)k * g];
        if (isfinite(mk))
          v = fmaf(pa[(size_t)k * g * c + cc], expf(mk - ms), v);
      }
    }
    vsum[warp][lane] = v;
    __syncthreads();
    if (warp == 0 && cc < c) {
      float t = 0.f;
      for (int w = 0; w < WARPS; ++w) t += vsum[w][lane];
      states[((size_t)bh * g + j) * c + cc] = t / denom / (1.0f + 1e-5f);
    }
    __syncthreads();
  }
}

// grid (ceil(n / DTILE), bh); out = w @ states with w recomputed.
__global__ void __launch_bounds__(NT)
deslice_kernel(const float* __restrict__ x, const float* __restrict__ ws,
               const float* __restrict__ bs, const float* __restrict__ wa,
               const float* __restrict__ ba, const float* __restrict__ st,
               const float* __restrict__ m, const float* __restrict__ s,
               float* __restrict__ out, int n, int c, int g, float base_temp,
               float shift) {
  extern __shared__ float sm[];
  float* ws_s = sm;                 // [c, g]
  float* bs_s = ws_s + c * g;       // [g]
  float* wa_s = bs_s + g;           // [c]
  float* st_s = wa_s + c;           // [g, c]
  float* m_s = st_s + g * c;        // [g] finite shift
  float* d_s = m_s + g;             // [g] denominator
  float* xt = d_s + g;              // [DTILE, c]
  float* wt = xt + DTILE * c;       // [DTILE, g]
  float* tau = wt + DTILE * g;      // [DTILE]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * DTILE;
  const int tr = min(DTILE, n - row0);
  const float* xb = x + ((size_t)bh * n + row0) * c;
  float* ob = out + ((size_t)bh * n + row0) * c;

  for (int i = tid; i < c * g; i += NT) {
    ws_s[i] = ws[i];
    st_s[i] = st[(size_t)bh * g * c + i];
  }
  for (int j = tid; j < g; j += NT) {
    bs_s[j] = bs[j];
    const float mj = m[(size_t)bh * g + j];
    const float sj = s[(size_t)bh * g + j];
    m_s[j] = isfinite(mj) ? mj : 0.f;
    d_s[j] = sj > 0.f ? sj : 1.f;
  }
  for (int i = tid; i < c; i += NT) wa_s[i] = wa[i];
  for (int i = tid; i < DTILE * c; i += NT)
    xt[i] = i / c < tr ? xb[i] : 0.f;
  __syncthreads();
  const float ba0 = ba[0];
  for (int r = tid; r < DTILE; r += NT)
    tau[r] = tau_of(xt + r * c, wa_s, ba0, c, base_temp);
  __syncthreads();
  for (int i = tid; i < DTILE * g; i += NT) {
    const int r = i / g, j = i % g;
    wt[i] = r < tr ? expf(logit_of(xt + r * c, ws_s, bs_s[j], j, c, g, shift,
                                   tau[r]) - m_s[j]) / d_s[j]
                   : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < tr * c; i += NT) {
    const int r = i / c, cc = i % c;
    float v = 0.f;
    for (int j = 0; j < g; ++j) v = fmaf(wt[r * g + j], st_s[j * c + cc], v);
    ob[i] = v;
  }
}

}  // namespace

extern "C" {

const char* haet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shapes: x [bh, n, c]; ws [c, g]; bs [g]; wa [c]; ba [1];
// part_m/part_s [bh, n_chunks, g]; part_acc [bh, n_chunks, g, c];
// states [bh, g, c]; m/s [bh, g]. n_chunks = ceil(n / chunk).
int haet_slice_states_f32(const float* x, const float* ws, const float* bs,
                          const float* wa, const float* ba, float* part_m,
                          float* part_s, float* part_acc, float* states,
                          float* m, float* s, int bh, int n, int c, int g,
                          int chunk, float base_temp, float shift,
                          void* stream) {
  if (g * c > NT * MAX_ACC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n + chunk - 1) / chunk;
  const size_t smem1 =
      sizeof(float) * (c * g + g + c + TILE * c + TILE * g + TILE + 4 * g);
  if (smem1 > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        slice_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem1));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  slice_partials<<<dim3(n_chunks, bh), NT, smem1, st>>>(
      x, ws, bs, wa, ba, part_m, part_s, part_acc, n, c, g, chunk, base_temp,
      shift);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  slice_merge<<<dim3(g, bh), NT, 0, st>>>(part_m, part_s, part_acc, states,
                                          m, s, n_chunks, c, g);
  return static_cast<int>(cudaGetLastError());
}

// Shapes: x/out [bh, n, c]; ws [c, g]; bs [g]; wa [c]; ba [1];
// states [bh, g, c]; m/s [bh, g].
int haet_deslice_f32(const float* x, const float* ws, const float* bs,
                     const float* wa, const float* ba, const float* states,
                     const float* m, const float* s, float* out, int bh,
                     int n, int c, int g, float base_temp, float shift,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) *
      (c * g + g + c + g * c + 2 * g + DTILE * c + DTILE * g + DTILE);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        deslice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (n + DTILE - 1) / DTILE;
  deslice_kernel<<<dim3(tiles, bh), NT, smem, st>>>(
      x, ws, bs, wa, ba, states, m, s, out, n, c, g, base_temp, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
