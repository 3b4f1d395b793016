// Rep-slice tokenizer kernels for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of haet_tpu/ops/pallas/slice_kernels.py:
//   * slice_states (_slice_states_kernel, called from _slice_states_impl_f32)
//   * deslice      (_deslice_kernel, called from _deslice_impl)
// and their custom_vjp backwards there (_slice_states_bwd, _deslice_bwd;
// lax.scan over chunks of N in JAX, not Pallas): slice_bwd_fast below.
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
// 32) slice_states reads 33 MB and does ~1.07 GFLOP (the logits and the
// weighted sum, 2*N*C*G each per cloud); deslice reads 33 MB, writes 33 MB
// and does the same FLOPs. In float32 FMA (67 TFLOP/s) slice_states is
// bound by operations (~16 us) and deslice by bytes (~20 us); the JAX
// reference computes the logits at Precision.HIGHEST, so one-pass TF32 is
// ruled out. In float32 FMA with the weights in registers every x value
// would have to reach many lanes for a few FMAs each, and shared memory
// delivers 32 floats per clock per SM against 128 FMAs: FMA cannot get near
// its bound, so the products go to the tensor cores.
//
// Design of the fast kernels (slice_states_fast, deslice_fast), for C <= 32
// and any G (every preset's widths: G 32 and 64 at C 16 and 32):
//   * Both products run on the tensor cores, mma.sync m16n8k8 in 3xTF32:
//     every float32 operand is split into a TF32 high part and the
//     remainder (split()), and each product is lo*hi + hi*lo + hi*hi,
//     accumulated in float32 (the lo*lo term, ~2^-22 of the product, is
//     dropped): float32 accuracy at three tensor-core passes.
//   * slice_states computes Z^T = Ws^T x^T (M = slices, N = 8 rows, K =
//     channels), so that the accumulator fragment of the logits is, entry
//     for entry, the A fragment of states^T-accumulation acc += E^T x (M =
//     slices, K = rows): the weights E never leave registers. deslice
//     computes Z = x Ws (M = 16 rows) and out = W states the same way.
//     Ws, bs, Wa and the states (divided by s) are read once per block
//     into shared memory and from there, split once, into each lane's
//     fragment registers. The channel order inside a k-block is permuted so
//     that a lane's x fragments are Q = C/4 contiguous floats.
//   * A lane holds the fragments of GP = 32 or 64 slices at once (64 where
//     C padded is at most 16 and G > 32): slice_states gives each group of
//     GP slices its own blocks (grid z; the slices' softmaxes are
//     independent), and deslice rebuilds the fragments of each group from
//     shared memory in turn, summing the groups' products in its output
//     fragments. deslice stages every slice's Ws and states / s once per
//     block; where they do not fit the SM's shared memory (past ~540
//     slices at C 32), it stages them in ranges that fit, one after the
//     other, each adding its products to the output.
//   * 1/tau is taken once per row, per tile by the lane of that row, and
//     shuffled to the lanes whose fragments hold the row.
//   * slice_states keeps, per slice, the exact running max, and the sum and
//     accumulator relative to a reference shift that is the same in every
//     lane holding the slice and moves only when a logit exceeds it by more
//     than RESCALE_AT (a warp vote per 32-row tile; the rescale is rare).
//   * Each warp streams its own tiles of TR = 32 rows through a private
//     ring of STAGES shared-memory slots (rows padded to C + 4 floats, bank
//     conflict free) filled by 16-byte cp.async (4-byte copies when C is not
//     a multiple of 4 or x is not 16-byte aligned), so loads overlap the
//     products and no block-wide barrier sits in the loop.
//   * The grid is sized from the SM count and B*H (launch_geometry in the
//     wrapper): each cloud's N is cut into per_cloud ranges of `span` rows,
//     one block each; a block's warps take its tiles in turn.
//   * slice_states merges in the same launch: a block sums its warps'
//     states by log-sum-exp (warp order), writes one partial, and the last
//     block of each cloud and slice group to finish (a counter and
//     __threadfence) merges their partials in block order. The order is
//     fixed, so two calls give bit-identical results. The counter is reset
//     by that block.
//   * deslice writes each output row into the shared slot its x row came
//     from and stores the tile with 16-byte stores.
//   * Guards of the Pallas kernels: a column whose max is -inf uses 0 as its
//     shift and contributes nothing; s == 0 divides by 1; rows past N are
//     masked to zero weight and zero features. (An infinite weight makes the
//     3xTF32 split produce NaN, as a float32 product with a zero input
//     does; finite inputs give finite logits, so m is finite for N >= 1.)
// Wider heads (C > 32, up to 2048) take the generic kernels further down
// (one block per 256-point chunk and group of slices, a second launch to
// merge, per-thread scalar loops): right, not fast. The wrapper decides the
// route.
//
// The backward kernels (slice_bwd_fast, slice_bwd_generic, sum_partials)
// follow the forwards; their own note is there.
//
// Two builds for benchmarks/slice_phases.py, never the wrapper's:
// -DHAET_SLICE_TRACE records per-warp clock64() segments of the fast
// kernels (haet_trace_read), -DHAET_SLICE_NO_MMA replaces each mma.sync by
// one integer and one float operation on the same registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;                  // warps per block (fast kernels)
constexpr int NTF = 32 * WARPS;           // threads per block
constexpr int TR = 32;                    // rows per warp tile
constexpr int STAGES = 2;                 // ring slots per warp
constexpr float L2E = 1.4426950408889634f;
constexpr float RESCALE_AT = 8.f;         // e <= exp(8) between rescales
constexpr float NEG_BIG = -1e30f;         // reference shift before any row
constexpr float NORM = 1.0f + 1e-5f;
constexpr unsigned FULL = 0xffffffffu;

// Slices whose fragments a lane holds at once, for C padded to CM and G
// slices: 64 where CM <= 16 and G > 32, else 32 (mirrors register_slices()
// in the wrapper).
inline int held_slices(int cm, int g) { return cm <= 16 && g > 32 ? 64 : 32; }

#ifdef HAET_SLICE_TRACE
// Per warp of the first TRACE_CTAS blocks of each fast kernel, in SM
// cycles: start (to the main loop), waits for the x ring, compute (the
// rest of the loop) and the tail (slice_states: its block merge up to the
// partial's write; deslice: its last wait).
constexpr int TRACE_CTAS = 512;
__device__ unsigned long long g_trace[2][TRACE_CTAS][WARPS][4];
#define HAET_TRACE(...) __VA_ARGS__

__device__ __forceinline__ void trace_record(int kernel, int lane, int warp,
                                             long long start, long long wait,
                                             long long compute,
                                             long long tail) {
  if (lane != 0) return;
  unsigned long long* r =
      g_trace[kernel][(blockIdx.y * gridDim.x + blockIdx.x) % TRACE_CTAS]
             [warp];
  r[0] = start;
  r[1] = wait;
  r[2] = compute;
  r[3] = tail;
}
#else
#define HAET_TRACE(...)
#endif

__device__ __forceinline__ float ex2(float v) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A float32 value as a TF32 high part and a low part. The tensor core
// reads a TF32 operand from the top 19 bits of its register and ignores the
// low 13: adding half a TF32 ulp (0x1000) makes that truncation a rounding
// to nearest (as CUTLASS's round_half_ulp_truncate does). lo = v - hi is
// exact in float32, and its own truncation costs at most 2^-21 |v|.
struct Split {
  unsigned hi, lo;
};

__device__ __forceinline__ Split split(float v) {
  const unsigned hi = __float_as_uint(v) + 0x1000u;
  return {hi, __float_as_uint(v - __uint_as_float(hi & 0xffffe000u))};
}

// d += a b, one m16n8k8 TF32 tensor-core product (float32 accumulate).
__device__ __forceinline__ void mma(float (&d)[4], unsigned a0, unsigned a1,
                                    unsigned a2, unsigned a3, unsigned b0,
                                    unsigned b1) {
#ifdef HAET_SLICE_NO_MMA
  d[0] += __uint_as_float(a0 ^ b1);
#else
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
#endif
}

// a b in 3xTF32 with the passes in two accumulators: d[0] += lo*hi +
// hi*lo, d[1] += hi*hi, so that a chain over k-blocks is two passes long;
// the product is d[0] + d[1].
__device__ __forceinline__ void mma3_split(float (&d)[2][4],
                                           const Split (&a)[4],
                                           const Split (&b)[2]) {
  mma(d[0], a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma(d[0], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(d[1], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// d += a b in 3xTF32: the two cross terms, then the high parts.
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     const Split (&b)[2]) {
  mma(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// Row stride of a shared x tile: C padded to CM, plus 4 floats so that the
// 8 rows of a fragment load fall on different banks.
template <int CM>
__host__ __device__ constexpr int row_stride() {
  return CM + 4;
}

template <int CM>
__host__ __device__ constexpr int ring_floats() {
  return WARPS * STAGES * TR * row_stride<CM>();
}

using bf16 = __nv_bfloat16;

// The element types the kernels read x, g_out and the states in, and write
// out, dx and the public states in: float32, or bf16 (the JAX model's bf16
// compute dtype). Everything else, the arithmetic, the residuals m and s,
// the weights and the partial sums, is float32: bf16 is widened where it
// is read and rounded (to nearest even) where it is stored.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same_v<T, float>) return v;
  else return __float2bfloat16_rn(v);
}

// Whether rows of c elements of T move as 16-byte chunks: c a multiple of
// the chunk and every pointer 16-byte aligned.
template <typename T>
__device__ __forceinline__ bool vec_ok(int c, uintptr_t ptrs) {
  return c % (16 / static_cast<int>(sizeof(T))) == 0 && (ptrs & 15) == 0;
}

// rows [row0, row0 + rows) of one cloud's x (row stride c) into a slot of
// TR rows; columns c..CM-1 of the slot are left alone. A bf16 tile with
// vec moves as it lies in device memory, rows*c contiguous values packed
// at the start of the slot, and convert_tile widens it in place once it
// has arrived; without vec it is read, widened and stored here.
template <int CM, typename T>
__device__ __forceinline__ void load_tile(float* slot, const T* xb,
                                          int row0, int rows, int c,
                                          bool vec, int lane) {
  constexpr int CS = row_stride<CM>();
  const T* src = xb + static_cast<size_t>(row0) * c;
  if constexpr (std::is_same_v<T, bf16>) {
    if (vec) {
      for (int i = lane; i < rows * c / 8; i += 32)
        cp16(slot + 4 * i, reinterpret_cast<const float*>(src + 8 * i));
    } else {
      for (int i = lane; i < rows * c; i += 32) {
        const int r = i / c, k = i - r * c;
        slot[r * CS + k] = to_f32(src[i]);
      }
    }
  } else if (vec && c == CM) {
    constexpr int Q = CM / 4;
    for (int i = lane; i < rows * Q; i += 32) {
      const int r = i / Q, k = i - r * Q;
      cp16(slot + r * CS + 4 * k, src + r * CM + 4 * k);
    }
  } else if (vec) {
    const int q = c >> 2;
    for (int i = lane; i < rows * q; i += 32) {
      const int r = i / q, k = i - r * q;
      cp16(slot + r * CS + 4 * k, src + r * c + 4 * k);
    }
  } else {
    for (int i = lane; i < rows * c; i += 32) {
      const int r = i / c, k = i - r * c;
      cp4(slot + r * CS + k, src + i);
    }
  }
}

// A bf16 tile that load_tile packed into the slot, widened in place into
// the slot's float32 rows, after its copies have arrived (cp_wait and
// __syncwarp): every lane reads its 16-byte chunks (8 values, a part of
// one row as c is a multiple of 8) into registers, the warp syncs, and
// each lane stores its chunks as two float4 (conflict-free at CS = CM + 4).
// The packed values may have covered padding columns, which are zeroed
// again. A no-op for float32 tiles and for bf16 tiles loaded without vec.
template <int CM, typename T>
__device__ __forceinline__ void convert_tile(float* slot, int rows, int c,
                                             bool vec, int lane) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (!vec) return;
    constexpr int CS = row_stride<CM>(), PER_LANE = TR * CM / 8 / 32;
    const int chunks = rows * c / 8;
    uint4 v[PER_LANE];
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int i = lane + 32 * u;
      if (i < chunks) v[u] = reinterpret_cast<const uint4*>(slot)[i];
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int i = lane + 32 * u;
      if (i < chunks) {
        const int e = 8 * i, r = e / c;
        float* d = slot + r * CS + e - r * c;
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
        const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
        const float2 e2 = __bfloat1622float2(h[2]), f = __bfloat1622float2(h[3]);
        *reinterpret_cast<float4*>(d) = make_float4(a.x, a.y, b.x, b.y);
        *reinterpret_cast<float4*>(d + 4) = make_float4(e2.x, e2.y, f.x, f.y);
      }
    }
    if (c < CM)
      for (int r = lane; r < TR; r += 32)
        for (int k = c; k < CM; ++k) slot[r * CS + k] = 0.f;
    __syncwarp();
  }
}

// The first c columns of the slot's rows out to device memory at dst (row
// stride c): plus acc (float32, the earlier launches' or ranges' sums)
// unless first; into acc unless last, else into out (T). For float32, acc
// and out are the same tensor.
template <int CM, typename T>
__device__ __forceinline__ void store_tile(const float* slot, float* acc,
                                           T* out, size_t off, int rows,
                                           int c, bool vec, bool first,
                                           bool last, int lane) {
  constexpr int CS = row_stride<CM>();
  constexpr int V = std::is_same_v<T, float> ? 4 : 8;
  float* a = acc + off;
  T* o = out + off;
  if (vec) {
    const int q = c / V;
    for (int i = lane; i < rows * q; i += 32) {
      const int r = i / q, k = V * (i - r * q), e = r * c + k;
      float v[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 t = *reinterpret_cast<const float4*>(slot + r * CS + k + j);
        v[j] = t.x, v[j + 1] = t.y, v[j + 2] = t.z, v[j + 3] = t.w;
        if (!first) {
          const float4 u = *reinterpret_cast<const float4*>(a + e + j);
          v[j] += u.x, v[j + 1] += u.y, v[j + 2] += u.z, v[j + 3] += u.w;
        }
      }
      if (!last) {
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(a + e + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      } else if constexpr (std::is_same_v<T, float>) {
        *reinterpret_cast<float4*>(o + e) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        __nv_bfloat162 h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        *reinterpret_cast<uint4*>(o + e) = *reinterpret_cast<const uint4*>(h);
      }
    }
  } else {
    for (int i = lane; i < rows * c; i += 32) {
      const int r = i / c, k = i - r * c;
      float v = slot[r * CS + k];
      if (!first) v += a[i];
      if (last) o[i] = from_f32<T>(v);
      else a[i] = v;
    }
  }
}

// The Q = CM / 4 channels [Q * tig, Q * tig + Q) of one tile row: a lane's
// x fragments for every k-block of a product over channels (channel
// Q * tig + 2 * kb + j is row tig + 4 * j of k-block kb).
template <int CM>
__device__ __forceinline__ void load_quarter(float (&v)[CM / 4],
                                             const float* p) {
  if constexpr (CM / 4 % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CM / 4; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
}

// 1 / tau (times `scale`) of the slot's row `lane` (TR == 32: a lane per
// row; rows past the tile's end give values nobody reads). The padded row
// stride puts the 8 rows of a shared-memory phase on 8 different banks.
// tau lies in [0.1, 0.9], where the fast division is within 2 ulp.
template <int CM>
__device__ __forceinline__ float row_inv_tau(const float* slot,
                                             const float* wa_s, float ba,
                                             float base_temp, float scale,
                                             int lane) {
  const float* xr = slot + lane * row_stride<CM>();
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int k = 0; k < CM; k += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + k);
    const float4 wv = *reinterpret_cast<const float4*>(wa_s + k);
    d0 = fmaf(xv.x, wv.x, d0);
    d1 = fmaf(xv.y, wv.y, d1);
    d0 = fmaf(xv.z, wv.z, d0);
    d1 = fmaf(xv.w, wv.w, d1);
  }
  return __fdividef(scale,
                    base_temp + fminf(fmaxf(d0 + d1 + ba, -0.4f), 0.4f));
}

// Row stride of the staged Ws [CM][GP]: one float of padding, so that the
// four lanes of a fragment (rows Q*tig + ...) fall on different banks.
template <int GP>
__host__ __device__ constexpr int ws_stride() {
  return GP + 1;
}

// Ws's columns [0, g) (rows `ldw` floats apart) zero-padded to [CM][GP],
// bs - shift and Wa into shared memory: one coalesced read by the whole
// block, every load issued before any is used (the loops are unrolled),
// from which each lane then builds its fragments (a lane's own fragment
// entries are scattered over Ws). `between()` runs after the loads are
// issued and before their values are stored, so that more loads can join
// them in flight.
template <int CM, int GP, typename Between>
__device__ __forceinline__ void stage_params(
    float* ws_s, float* bs_s, float* wa_s, const float* __restrict__ ws,
    const float* __restrict__ bs, const float* __restrict__ wa, int c, int g,
    int ldw, float shift, Between&& between) {
  constexpr int R = (CM * GP + NTF - 1) / NTF;
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * NTF, k = i / GP, sl = i - k * GP;
    v[r] = (i < CM * GP && k < c && sl < g) ? ws[k * ldw + sl] : 0.f;
  }
  const int i = threadIdx.x;
  const float bv = i < g ? bs[i] : 0.f, wv = i < c ? wa[i] : 0.f;
  between();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = threadIdx.x + r * NTF, k = j / GP;
    if (j < CM * GP) ws_s[k * ws_stride<GP>() + j - k * GP] = v[r];
  }
  if (i < GP) bs_s[i] = i < g ? bv - shift : 0.f;
  if (i < CM) wa_s[i] = wv;
}

// grid (per_cloud, bh, ceil(g / GP)), NTF threads. Block `blockIdx.x`
// covers rows [blockIdx.x * span, min(n, (blockIdx.x + 1) * span)) of cloud
// blockIdx.y, for slices [blockIdx.z * GP, + GP); its warp w takes tiles w,
// w + WARPS, ... of TR rows.
template <int CM, int GP, typename T>
__global__ void __launch_bounds__(NTF, 1)
slice_states_fast(const T* __restrict__ x, const float* __restrict__ ws,
                  const float* __restrict__ bs, const float* __restrict__ wa,
                  const float* __restrict__ ba, float* __restrict__ part_m,
                  float* __restrict__ part_s, float* __restrict__ part_acc,
                  int* __restrict__ counter, float* __restrict__ states,
                  bf16* __restrict__ states_lo, float* __restrict__ m_out,
                  float* __restrict__ s_out, int n, int c, int g, int span,
                  float base_temp, float shift) {
  constexpr int MB = GP / 16, KB = CM / 8, NC = CM / 8;
  constexpr int Q = CM / 4, CS = row_stride<CM>(), SW = CM + 8;
  extern __shared__ __align__(16) float sm[];
  __shared__ int is_last;
  float* ring = sm;  // [WARPS][STAGES][TR][CS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  HAET_TRACE(long long t0_ = clock64(), t1_ = 0, t2_ = 0, tw_ = 0, tc_ = 0,
             tb_ = 0;)
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, per_cloud = gridDim.x;
  // this block's slices [g0, g0 + gb) and its partials' (cloud, group) row
  const int g0 = blockIdx.z * GP, gb = min(GP, g - g0);
  const int grp = bh * gridDim.z + blockIdx.z;
  const int row_begin = blockIdx.x * span;
  const int rows_blk = min(span, n - row_begin);
  const T* xb = x + static_cast<size_t>(bh) * n * c;
  const bool vec = vec_ok<T>(c, reinterpret_cast<uintptr_t>(x));

  float* ws_s = ring + ring_floats<CM>();  // [CM][ws_stride]
  float* bs_s = ws_s + CM * ws_stride<GP>();  // [GP]
  float* wa_s = bs_s + GP;                    // [CM]
  const int tiles = (rows_blk + TR - 1) / TR;
  const int my_tiles = tiles > warp ? (tiles - warp + WARPS - 1) / WARPS : 0;
  float* my_ring = ring + warp * STAGES * TR * CS;
  const int first_row = row_begin + warp * TR;
  constexpr int STRIDE = WARPS * TR;

  if (c < CM) {  // padding columns must read as zeros
    for (int i = tid; i < ring_floats<CM>(); i += NTF) ring[i] = 0.f;
    __syncthreads();
  }
  // the weights' loads, then the first tiles' loads, in flight together
  stage_params<CM, GP>(ws_s, bs_s, wa_s, ws + g0, bs + g0, wa, c, gb, g,
                       shift, [&] {
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < my_tiles) {
        const int r0 = first_row + j * STRIDE;
        load_tile<CM, T>(my_ring + j * TR * CS, xb, r0, min(TR, n - r0), c,
                         vec, lane);
      }
      cp_commit();
    }
  });
  const float ba0 = ba[0];
  __syncthreads();

  // Ws^T as A fragments of Z^T = Ws^T x^T: slices mb*16 + gid (+ 8),
  // channels Q*tig + 2*kb (+ 1); bs - shift of the lane's slices.
  Split wf[MB][KB][4];
  float bsh[MB][2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const int s0 = mb * 16 + gid;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const float* w0 = ws_s + (Q * tig + 2 * kb) * ws_stride<GP>() + s0;
      wf[mb][kb][0] = split(w0[0]);
      wf[mb][kb][1] = split(w0[8]);
      wf[mb][kb][2] = split(w0[ws_stride<GP>()]);
      wf[mb][kb][3] = split(w0[ws_stride<GP>() + 8]);
    }
    bsh[mb][0] = bs_s[s0];
    bsh[mb][1] = bs_s[s0 + 8];
  }

  // Per slice (mb*16 + gid + 8h): the exact running max of this lane's
  // rows, the reference shift (the same in the slice's four lanes) and this
  // lane's sum; acc[mb][nc] is the accumulator fragment of slices
  // mb*16 + gid (+ 8) and channels nc*8 + 2*tig (+ 1).
  float mrun[MB][2], mref[MB][2], mref2[MB][2], ssum[MB][2];
  float acc[MB][NC][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mrun[mb][h] = -INFINITY;
      mref[mb][h] = NEG_BIG;
      mref2[mb][h] = NEG_BIG * L2E;
      ssum[mb][h] = 0.f;
    }
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][nc][i] = 0.f;
  }

  HAET_TRACE(t1_ = clock64();)
  for (int j = 0; j < my_tiles; ++j) {
    __syncwarp();  // every lane is done with the slot refilled below
    const int jn = j + STAGES - 1;
    if (jn < my_tiles) {
      const int r0 = first_row + jn * STRIDE;
      load_tile<CM, T>(my_ring + (jn % STAGES) * TR * CS, xb, r0,
                       min(TR, n - r0), c, vec, lane);
    }
    cp_commit();
    HAET_TRACE(if (j) tc_ += clock64() - tb_; const long long ta_ = clock64();)
    cp_wait<STAGES - 1>();
    __syncwarp();
    HAET_TRACE(tb_ = clock64(); tw_ += tb_ - ta_;)
    float* slot = my_ring + (j % STAGES) * TR * CS;
    const int rows = min(TR, n - (first_row + j * STRIDE));
    convert_tile<CM, T>(slot, rows, c, vec, lane);
    const float it_row = row_inv_tau<CM>(slot, wa_s, ba0, base_temp, 1.f,
                                         lane);
    // The tile's four blocks of 8 rows (b): Z^T and the logits of all of
    // them, one vote on the reference shifts, then E and acc += E^T x.
    // Logits of rows 8b + 2*tig (z[b][.][0], [2]) and 8b + 2*tig + 1
    // ([1], [3]); rows past N get -inf.
    float z[4][MB][4];
    bool need = false;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float xq[Q];
      load_quarter<CM>(xq, slot + (8 * b + gid) * CS + Q * tig);
      Split xf[KB][2];
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        xf[kb][0] = split(xq[2 * kb]);
        xf[kb][1] = split(xq[2 * kb + 1]);
      }
      const float it0 = __shfl_sync(FULL, it_row, 8 * b + 2 * tig);
      const float it1 = __shfl_sync(FULL, it_row, 8 * b + 2 * tig + 1);
      const bool v0 = 8 * b + 2 * tig < rows, v1 = 8 * b + 2 * tig + 1 < rows;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        // bs - shift rides in the hi*hi accumulator
        float zp[2][4] = {{0.f, 0.f, 0.f, 0.f},
                          {bsh[mb][0], bsh[mb][0], bsh[mb][1], bsh[mb][1]}};
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) mma3_split(zp, wf[mb][kb], xf[kb]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float l0 = (zp[0][2 * h] + zp[1][2 * h]) * it0;
          const float l1 = (zp[0][2 * h + 1] + zp[1][2 * h + 1]) * it1;
          z[b][mb][2 * h] = v0 ? l0 : -INFINITY;
          z[b][mb][2 * h + 1] = v1 ? l1 : -INFINITY;
          const float lm = fmaxf(z[b][mb][2 * h], z[b][mb][2 * h + 1]);
          mrun[mb][h] = fmaxf(mrun[mb][h], lm);
          need |= lm > mref[mb][h] + RESCALE_AT;
        }
      }
    }
    if (__any_sync(FULL, need)) {  // rare: move the reference shifts
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float gm = -INFINITY;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            gm = fmaxf(gm, fmaxf(z[b][mb][2 * h], z[b][mb][2 * h + 1]));
          gm = fmaxf(gm, __shfl_xor_sync(FULL, gm, 1));
          gm = fmaxf(gm, __shfl_xor_sync(FULL, gm, 2));
          if (gm > mref[mb][h] + RESCALE_AT) {
            const float sc = ex2((mref[mb][h] - gm) * L2E);
            ssum[mb][h] *= sc;
#pragma unroll
            for (int nc = 0; nc < NC; ++nc) {
              acc[mb][nc][2 * h] *= sc;
              acc[mb][nc][2 * h + 1] *= sc;
            }
            mref[mb][h] = gm;
            mref2[mb][h] = gm * L2E;
          }
        }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // E as A fragments of acc += E^T x (k = tig is row 2*tig, k = tig + 4
      // is row 2*tig + 1): a0 = z0, a1 = z2, a2 = z1, a3 = z3; x as B
      // fragments (rows 8b + 2*tig (+ 1), channel nc*8 + gid), zero past
      // the last row
      Split ef[MB][4];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          e[i] = ex2(fmaf(z[b][mb][i], L2E, -mref2[mb][i >> 1]));
        ssum[mb][0] += e[0] + e[1];
        ssum[mb][1] += e[2] + e[3];
        ef[mb][0] = split(e[0]);
        ef[mb][1] = split(e[2]);
        ef[mb][2] = split(e[1]);
        ef[mb][3] = split(e[3]);
      }
      const bool v0 = 8 * b + 2 * tig < rows, v1 = 8 * b + 2 * tig + 1 < rows;
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        const float* xp = slot + (8 * b + 2 * tig) * CS + nc * 8 + gid;
        const Split xr[2] = {split(v0 ? xp[0] : 0.f),
                             split(v1 ? xp[CS] : 0.f)};
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) mma3(acc[mb][nc], ef[mb], xr);
      }
    }
  }
  HAET_TRACE(if (my_tiles) tc_ += clock64() - tb_; t2_ = clock64();)
  cp_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the merges

  // 1. The block's warps, merged by log-sum-exp in warp order: each warp
  // publishes its slices' max; each lane rescales its own fragments to the
  // block's max; the warps' terms are summed in warp order.
  float* wm = sm;                   // [WARPS][GP] the warps' exact max
  float* wsum = wm + WARPS * GP;    // [WARPS][GP] rescaled sums
  float* bmax = wsum + WARPS * GP;  // [GP]
  float* wacc = bmax + GP;          // [WARPS][GP][SW] rescaled accumulators
  float wmax[MB][2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = mrun[mb][h];
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      wmax[mb][h] = mx;
      if (tig == 0) wm[warp * GP + mb * 16 + gid + 8 * h] = mx;
    }
  __syncthreads();
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sl = mb * 16 + gid + 8 * h;
      float bm = -INFINITY;
#pragma unroll
      for (int u = 0; u < WARPS; ++u) bm = fmaxf(bm, wm[u * GP + sl]);
      const float sc = isfinite(wmax[mb][h])
          ? expf(mref[mb][h] - (isfinite(bm) ? bm : 0.f)) : 0.f;
      float sg = ssum[mb][h];
      sg += __shfl_xor_sync(FULL, sg, 1);
      sg += __shfl_xor_sync(FULL, sg, 2);
      const int e = warp * GP + sl;
      if (tig == 0) wsum[e] = sg * sc;
      if (warp == 0 && tig == 0) bmax[sl] = bm;
#pragma unroll
      for (int nc = 0; nc < NC; ++nc)
        *reinterpret_cast<float2*>(wacc + e * SW + nc * 8 + 2 * tig) =
            make_float2(acc[mb][nc][2 * h] * sc, acc[mb][nc][2 * h + 1] * sc);
    }
  __syncthreads();
  auto block_sum = [&](int gi) {
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) v += wsum[u * GP + gi];
    return v;
  };
  auto block_acc = [&](int gi, int k) {
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) v += wacc[(u * GP + gi) * SW + k];
    return v;
  };

  // the outputs of this block's slices: the float32 states and, for a bf16
  // x, their bf16 copy (the public output; the float32 states are the
  // backward's residual)
  const size_t st0 = (static_cast<size_t>(bh) * g + g0) * c;
  float* st_out = states + st0;
  auto put_state = [&](int e, float v) {
    st_out[e] = v;
    if (states_lo) states_lo[st0 + e] = __float2bfloat16_rn(v);
  };
  float* m_o = m_out + static_cast<size_t>(bh) * g + g0;
  float* s_o = s_out + static_cast<size_t>(bh) * g + g0;
  if (per_cloud == 1) {  // one block per cloud: write the outputs directly
    for (int e = tid; e < gb * c; e += NTF) {
      const int gi = e / c, k = e - gi * c;
      const float sg = block_sum(gi);
      put_state(e, block_acc(gi, k) / (sg > 0.f ? sg : 1.f) / NORM);
    }
    for (int gi = tid; gi < gb; gi += NTF) {
      m_o[gi] = bmax[gi];
      s_o[gi] = block_sum(gi);
    }
    return;
  }

  const size_t part = static_cast<size_t>(grp) * per_cloud + blockIdx.x;
  for (int e = tid; e < GP * CM; e += NTF)
    part_acc[part * GP * CM + e] = block_acc(e / CM, e % CM);
  if (tid < GP) {
    part_m[part * GP + tid] = bmax[tid];
    part_s[part * GP + tid] = block_sum(tid);
  }
  HAET_TRACE(trace_record(0, lane, warp, t1_ - t0_, tw_, tc_,
                          clock64() - t2_);)

  // 2. The last block of the cloud (and slice group) merges the partials in
  // block order.
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counter + grp, 1) == per_cloud - 1;
  __syncthreads();
  if (!is_last) {
    return;
  }
  __threadfence();
  const size_t cloud = static_cast<size_t>(grp) * per_cloud;
  float* fsc = sm;                      // [per_cloud][GP] max -> scale
  float* fps = fsc + per_cloud * GP;    // [per_cloud][GP] sums
  float* fmx = fps + per_cloud * GP;    // [GP]
  float* fsum = fmx + GP;               // [GP]
  for (int e = tid; e < per_cloud * GP; e += NTF) {
    fsc[e] = __ldcg(part_m + cloud * GP + e);
    fps[e] = __ldcg(part_s + cloud * GP + e);
  }
  __syncthreads();
  for (int gi = tid; gi < GP; gi += NTF) {
    float mx = -INFINITY;
    for (int b = 0; b < per_cloud; ++b) mx = fmaxf(mx, fsc[b * GP + gi]);
    fmx[gi] = mx;
  }
  __syncthreads();
  for (int e = tid; e < per_cloud * GP; e += NTF) {
    const float mx = fmx[e % GP], mb = fsc[e];
    fsc[e] = isfinite(mb) ? expf(mb - (isfinite(mx) ? mx : 0.f)) : 0.f;
  }
  __syncthreads();
  if (tid < GP) {
    float s = 0.f;
    for (int b = 0; b < per_cloud; ++b)
      s = fmaf(fps[b * GP + tid], fsc[b * GP + tid], s);
    fsum[tid] = s;
    if (tid < gb) {
      m_o[tid] = fmx[tid];
      s_o[tid] = s;
    }
  }
  __syncthreads();
  // Each thread sums EPT accumulator entries over the partials, its loads
  // independent of one another (the partials were written by other SMs:
  // read through L2).
  constexpr int EPT = (GP * CM + NTF - 1) / NTF;
  const float* pa = part_acc + cloud * GP * CM;
  float v[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) v[i] = 0.f;
#pragma unroll 4
  for (int b = 0; b < per_cloud; ++b)
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = tid + i * NTF;
      if (e < GP * CM)
        v[i] = fmaf(__ldcg(pa + b * GP * CM + e), fsc[b * GP + e / CM],
                    v[i]);
    }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + i * NTF;
    const int gi = e / CM, k = e - gi * CM;
    if (e < GP * CM && gi < gb && k < c) {
      const float sg = fsum[gi];
      put_state(gi * c + k, v[i] / (sg > 0.f ? sg : 1.f) / NORM);
    }
  }
  if (tid == 0) counter[grp] = 0;  // ready for the next call on this stream
}

// stage_params with the slice count gp known only at run time (deslice):
// Ws's columns [0, g) (rows `ldw` floats apart) zero-padded to [CM][gp]
// with rows gp + 1 floats apart, bs - shift and Wa. The loads run in passes
// of GS slices, all of a pass in flight at once; `between()` runs in the
// first pass, after its loads (and those of bs and Wa) are issued.
template <int CM, int GS, typename Between>
__device__ __forceinline__ void stage_params_rt(
    float* ws_s, float* bs_s, float* wa_s, const float* __restrict__ ws,
    const float* __restrict__ bs, const float* __restrict__ wa, int c, int g,
    int ldw, int gp, float shift, Between&& between) {
  constexpr int R = (CM * GS + NTF - 1) / NTF;
  const int total = CM * gp, i0 = threadIdx.x;
  float bv = 0.f, wv = 0.f;
  for (int base = 0; base < total; base += R * NTF) {
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = base + i0 + r * NTF, k = i / gp, sl = i - k * gp;
      v[r] = (i < total && k < c && sl < g) ? ws[k * ldw + sl] : 0.f;
    }
    if (base == 0) {
      bv = i0 < g ? bs[i0] : 0.f;
      wv = i0 < c ? wa[i0] : 0.f;
      between();
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = base + i0 + r * NTF, k = i / gp;
      if (i < total) ws_s[k * (gp + 1) + i - k * gp] = v[r];
    }
  }
  if (i0 < gp) bs_s[i0] = i0 < g ? bv - shift : 0.f;
  for (int i = i0 + NTF; i < gp; i += NTF)  // past NTF slices
    bs_s[i] = i < g ? bs[i] - shift : 0.f;
  if (i0 < CM) wa_s[i0] = wv;
}

// grid (per_cloud, bh), NTF threads; N cut as for slice_states_fast. The
// slices are staged in shared memory in ranges of gp (a multiple of GH;
// every slice at once where they fit, ~540 at C 32), one range after the
// other, each adding its products to the output rows of the earlier ones
// (each warp reloads its tiles per range). Within a range the fragments
// hold GH slices and are rebuilt from shared memory for each group of GH
// slices in turn, the groups' products summed in the output fragments.
// GPC: gp known at compile time (32 or 64, every G <= 64: the staging's
// loads unrolled and the group loop fixed), or 0 (wider G). The ranges'
// sums meet in acc (float32; out itself for a float32 out), and the last
// range writes out.
template <int CM, int GH, int GPC, typename T>
__global__ void __launch_bounds__(NTF, 1)
deslice_fast(const T* __restrict__ x, const float* __restrict__ ws,
             const float* __restrict__ bs, const float* __restrict__ wa,
             const float* __restrict__ ba, const T* __restrict__ st,
             const float* __restrict__ m, const float* __restrict__ s,
             T* out, float* acc, int n, int c, int g, int gp_arg,
             int span, float base_temp, float shift) {
  constexpr int NB = GH / 8, KB = CM / 8, NC = CM / 8;
  constexpr int Q = CM / 4, CS = row_stride<CM>();
  // slices whose Ws and states loads are in flight together at the start
  constexpr int GS = GPC > 0 ? GPC : 64, RS = (GS * CM + NTF - 1) / NTF;
  const int gp = GPC > 0 ? GPC : gp_arg;
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;  // [WARPS][STAGES][TR][CS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  HAET_TRACE(long long t0_ = clock64(), t1_ = 0, t2_ = 0, tw_ = 0, tc_ = 0,
             tb_ = 0;)
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;
  const int row_begin = blockIdx.x * span;
  const int rows_blk = min(span, n - row_begin);
  const size_t cloud = static_cast<size_t>(bh) * n * c;
  const T* xb = x + cloud;
  const bool vec = vec_ok<T>(c, reinterpret_cast<uintptr_t>(x) |
                                    reinterpret_cast<uintptr_t>(out) |
                                    reinterpret_cast<uintptr_t>(acc));

  const int wsl = gp + 1;                  // row stride of the staged Ws
  float* ws_s = ring + ring_floats<CM>();  // [CM][gp + 1]
  float* bs_s = ws_s + CM * wsl;           // [gp]
  float* wa_s = bs_s + gp;                 // [CM]
  float* st_s = wa_s + CM;                 // [gp][CM + 4] states / s
  float* m_s = st_s + gp * (CM + 4);       // [gp] finite m, times log2(e)
  const int tiles = (rows_blk + TR - 1) / TR;
  const int my_tiles = tiles > warp ? (tiles - warp + WARPS - 1) / WARPS : 0;
  float* my_ring = ring + warp * STAGES * TR * CS;
  const int first_row = row_begin + warp * TR;
  constexpr int STRIDE = WARPS * TR;

  if (c < CM) {  // padding columns must read as zeros
    for (int i = tid; i < ring_floats<CM>(); i += NTF) ring[i] = 0.f;
    __syncthreads();
  }
  // the ranges of staged slices: one, known at compile time, when GPC > 0
  const int ranges = GPC > 0 ? 1 : (g + gp - 1) / gp;
  for (int rg = 0; rg < ranges; ++rg) {
    const int g0 = rg * gp;
    if (rg > 0) __syncthreads();  // every warp is done with the last range
    const int gw = min(gp, g - g0);
    const int ngrp = GPC > 0 ? GPC / GH : (gw + GH - 1) / GH;
    const size_t sg0 = static_cast<size_t>(bh) * g + g0;  // this range's
    const T* stb = st + sg0 * c;                            // first slice
    const int first = min(gp, GS) * CM;  // staged states entries of the start
    float sv[RS], sj[RS], mj;
    // the weights', the first states' and m's and the first tiles' loads in
    // flight together
    auto between = [&] {
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const int i = tid + r * NTF, sl = i / CM, ch = i - sl * CM;
        const bool in = i < first && sl < gw && ch < c;
        sv[r] = in ? to_f32(stb[sl * c + ch]) : 0.f;
        sj[r] = in ? s[sg0 + sl] : 1.f;
      }
      mj = tid < gw ? m[sg0 + tid] : 0.f;
#pragma unroll
      for (int j = 0; j < STAGES - 1; ++j) {
        if (j < my_tiles) {
          const int r0 = first_row + j * STRIDE;
          load_tile<CM, T>(my_ring + j * TR * CS, xb, r0, min(TR, n - r0), c,
                           vec, lane);
        }
        cp_commit();
      }
    };
    if constexpr (GPC > 0)
      stage_params<CM, GPC>(ws_s, bs_s, wa_s, ws + g0, bs + g0, wa, c, gw, g,
                            shift, between);
    else
      stage_params_rt<CM, GS>(ws_s, bs_s, wa_s, ws + g0, bs + g0, wa, c, gw,
                              g, gp, shift, between);
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int i = tid + r * NTF, sl = i / CM;
      if (i < first)
        st_s[sl * (CM + 4) + i - sl * CM] = sv[r] / (sj[r] > 0.f ? sj[r] : 1.f);
    }
    for (int i = first + tid; i < gp * CM; i += NTF) {  // past GS slices
      const int sl = i / CM, ch = i - sl * CM;
      float v = 0.f;
      if (sl < gw && ch < c) {
        const float sd = s[sg0 + sl];
        v = to_f32(stb[sl * c + ch]) / (sd > 0.f ? sd : 1.f);
      }
      st_s[sl * (CM + 4) + ch] = v;
    }
    if (tid < gp) m_s[tid] = (isfinite(mj) ? mj : 0.f) * L2E;
    for (int i = tid + NTF; i < gp; i += NTF) {  // past NTF slices
      const float mi = i < gw ? m[sg0 + i] : 0.f;
      m_s[i] = (isfinite(mi) ? mi : 0.f) * L2E;
    }
    const float ba0 = ba[0];
    __syncthreads();

    // Of the GH slices from h0: Ws as B fragments of Z = x Ws (channels
    // Q*tig + 2*kb (+ 1), slice nb*8 + gid); states / s as B fragments of
    // out = W states (slices nb*8 + 2*tig (+ 1), channel nc*8 + gid); bs -
    // shift and m of the lane's logit columns nb*8 + 2*tig (+ 1).
    Split wf[KB][NB][2], sf[NB][NC][2];
    float bsh[NB][2], m2[NB][2];
    auto fragments = [&](int h0) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int s0 = h0 + nb * 8;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const float* w0 = ws_s + (Q * tig + 2 * kb) * wsl + s0 + gid;
          wf[kb][nb][0] = split(w0[0]);
          wf[kb][nb][1] = split(w0[wsl]);
        }
#pragma unroll
        for (int nc = 0; nc < NC; ++nc) {
          const float* p0 = st_s + (s0 + 2 * tig) * (CM + 4) + nc * 8 + gid;
          sf[nb][nc][0] = split(p0[0]);
          sf[nb][nc][1] = split(p0[CM + 4]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bsh[nb][j] = bs_s[s0 + 2 * tig + j];
          m2[nb][j] = m_s[s0 + 2 * tig + j];
        }
      }
    };
    if (ngrp == 1) fragments(0);

    HAET_TRACE(t1_ = clock64();)
    for (int j = 0; j < my_tiles; ++j) {
      __syncwarp();
      const int jn = j + STAGES - 1;
      if (jn < my_tiles) {
        const int r0 = first_row + jn * STRIDE;
        load_tile<CM, T>(my_ring + (jn % STAGES) * TR * CS, xb, r0,
                         min(TR, n - r0), c, vec, lane);
      }
      cp_commit();
      HAET_TRACE(if (j) tc_ += clock64() - tb_;
                 const long long ta_ = clock64();)
      cp_wait<STAGES - 1>();
      __syncwarp();
      HAET_TRACE(tb_ = clock64(); tw_ += tb_ - ta_;)
      float* slot = my_ring + (j % STAGES) * TR * CS;
      const int row0 = first_row + j * STRIDE;
      const int rows = min(TR, n - row0);
      convert_tile<CM, T>(slot, rows, c, vec, lane);
      const float it_row = row_inv_tau<CM>(slot, wa_s, ba0, base_temp, L2E,
                                           lane);
      for (int r16 = 0; r16 < rows; r16 += 16) {
        // rows r16 + gid and r16 + gid + 8 (rows past N compute garbage that
        // is never stored: each output row depends on its own x row only)
        float* x0 = slot + (r16 + gid) * CS;
        float xq0[Q], xq1[Q];
        load_quarter<CM>(xq0, x0 + Q * tig);
        load_quarter<CM>(xq1, x0 + 8 * CS + Q * tig);
        const float it0 = __shfl_sync(FULL, it_row, r16 + gid);
        const float it1 = __shfl_sync(FULL, it_row, r16 + gid + 8);
        Split xf[KB][4];
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          xf[kb][0] = split(xq0[2 * kb]);
          xf[kb][1] = split(xq1[2 * kb]);
          xf[kb][2] = split(xq0[2 * kb + 1]);
          xf[kb][3] = split(xq1[2 * kb + 1]);
        }
        float o[NC][4];
#pragma unroll
        for (int nc = 0; nc < NC; ++nc)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[nc][i] = 0.f;
#pragma unroll 1
        for (int h = 0; h < ngrp; ++h) {  // the groups' products summed in o
          if (ngrp > 1) fragments(h * GH);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            // Z for slices nb*8 .. + 7: z0, z1 row gid, z2, z3 row gid + 8;
            // columns nb*8 + 2*tig (+ 1)
            float zp[2][4] = {{0.f, 0.f, 0.f, 0.f},
                              {bsh[nb][0], bsh[nb][1], bsh[nb][0], bsh[nb][1]}};
#pragma unroll
            for (int kb = 0; kb < KB; ++kb) mma3_split(zp, xf[kb], wf[kb][nb]);
            float z[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) z[i] = zp[0][i] + zp[1][i];
            const float w0 = ex2(fmaf(z[0], it0, -m2[nb][0]));
            const float w1 = ex2(fmaf(z[1], it0, -m2[nb][1]));
            const float w2 = ex2(fmaf(z[2], it1, -m2[nb][0]));
            const float w3 = ex2(fmaf(z[3], it1, -m2[nb][1]));
            // A fragments of out += W states (k = tig is slice nb*8 + 2*tig)
            const Split wfr[4] = {split(w0), split(w2), split(w1), split(w3)};
#pragma unroll
            for (int nc = 0; nc < NC; ++nc) mma3(o[nc], wfr, sf[nb][nc]);
          }
        }
        __syncwarp();  // every lane has read these rows' x
#pragma unroll
        for (int nc = 0; nc < NC; ++nc) {
          float* op = x0 + nc * 8 + 2 * tig;
          *reinterpret_cast<float2*>(op) = make_float2(o[nc][0], o[nc][1]);
          *reinterpret_cast<float2*>(op + 8 * CS) =
              make_float2(o[nc][2], o[nc][3]);
        }
      }
      __syncwarp();
      store_tile<CM, T>(slot, acc, out, cloud + static_cast<size_t>(row0) * c,
                        rows, c, vec, rg == 0, rg == ranges - 1, lane);
    }
    HAET_TRACE(if (my_tiles) tc_ += clock64() - tb_; t2_ = clock64();)
    cp_wait<0>();
  }
  HAET_TRACE(trace_record(1, lane, warp, t1_ - t0_, tw_, tc_,
                          clock64() - t2_);)
}

// ---------------------------------------------------------------------------
// Generic kernels, for C > 32 (up to MAX_GENERIC_C) and any G: one block per
// CHUNK points and group of slices and a second launch to merge
// (slice_states), one block per dtile points looping over groups of slices
// (deslice); scalar loops, weights in shared memory. The wrapper sizes the
// groups (generic_plan) so that each block's accumulators fit its
// registers and its staged weights the SM's shared memory.
// ---------------------------------------------------------------------------

constexpr int NT = 256;      // threads per block
constexpr int TILE = 32;     // points per inner tile of slice_partials_generic
                             // (at most)
constexpr int MAX_ACC = 8;   // slice_states: gsz*C <= NT*MAX_ACC accumulators
constexpr int MAX_OUT = 32;  // deslice: dtile*C <= NT*MAX_OUT outputs
constexpr int MAX_GENERIC_C = NT * MAX_ACC;  // one slice per block

// sum_k xr[k] w[k * ld] in four interleaved FMA chains, summed in pairs: at
// wide C one chain's rounding error, amplified by 1 / tau up to 10 and by
// the exp, costs digits that a float32 matrix product keeps.
__device__ __forceinline__ float dot4(const float* xr, const float* w,
                                      int ld, int c) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int k = 0;
  for (; k + 4 <= c; k += 4) {
    a0 = fmaf(xr[k], w[k * ld], a0);
    a1 = fmaf(xr[k + 1], w[(k + 1) * ld], a1);
    a2 = fmaf(xr[k + 2], w[(k + 2) * ld], a2);
    a3 = fmaf(xr[k + 3], w[(k + 3) * ld], a3);
  }
  for (; k < c; ++k) a0 = fmaf(xr[k], w[k * ld], a0);
  return (a0 + a1) + (a2 + a3);
}

__device__ __forceinline__ float tau_of(const float* xr, const float* wa,
                                        float ba, int c, float base_temp) {
  return base_temp + fminf(fmaxf(dot4(xr, wa, 1, c) + ba, -0.4f), 0.4f);
}

__device__ __forceinline__ float logit_of(const float* xr, const float* ws,
                                          float bsj, int j, int c, int g,
                                          float shift, float tau) {
  return (dot4(xr, ws + j, g, c) + bsj - shift) / tau;
}

// grid (n_chunks, bh, ceil(g / gsz)); partial softmax state of one chunk
// of one cloud for the slices [blockIdx.z * gsz, + gsz), gsz * c <= NT *
// MAX_ACC accumulator entries (in registers), its points in tiles of `tile`
// (32, fewer where wide rows would not fit the shared memory).
__global__ void __launch_bounds__(NT)
slice_partials_generic(const float* __restrict__ x,
                       const float* __restrict__ ws,
                       const float* __restrict__ bs,
                       const float* __restrict__ wa,
                       const float* __restrict__ ba,
                       float* __restrict__ part_m,
                       float* __restrict__ part_s,
                       float* __restrict__ part_acc, int n, int c, int g,
                       int gsz, int tile, int chunk, float base_temp,
                       float shift) {
  extern __shared__ __align__(16) float sm[];
  // this block's slices [j0, j0 + gb)
  const int j0 = blockIdx.z * gsz, gb = min(gsz, g - j0);
  float* ws_s = sm;                 // [c, gb]
  float* bs_s = ws_s + c * gb;      // [gb]
  float* wa_s = bs_s + gb;          // [c]
  float* xt = wa_s + c;             // [tile, c]
  float* lt = xt + tile * c;        // [tile, gb] logits, then exp weights
  float* tau = lt + tile * gb;      // [tile]
  float* m_run = tau + tile;        // [gb] running max
  float* s_run = m_run + gb;        // [gb] running sum
  float* shift_s = s_run + gb;      // [gb] finite shift of this tile
  float* resc = shift_s + gb;       // [gb] rescale of the old state

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int ck = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int row0 = ck * chunk;
  const int rows = min(chunk, n - row0);
  const float* xb = x + ((size_t)bh * n + row0) * c;
  const float ba0 = ba[0];
  const int gc = gb * c;

  for (int i = tid; i < c * gb; i += NT) {
    const int k = i / gb;
    ws_s[i] = ws[k * g + j0 + i - k * gb];
  }
  for (int i = tid; i < gb; i += NT) {
    bs_s[i] = bs[j0 + i];
    m_run[i] = -INFINITY;
    s_run[i] = 0.f;
  }
  for (int i = tid; i < c; i += NT) wa_s[i] = wa[i];

  float acc[MAX_ACC];
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) acc[a] = 0.f;

  for (int t0 = 0; t0 < rows; t0 += tile) {
    const int tr = min(tile, rows - t0);
    __syncthreads();  // previous tile fully consumed (and weights loaded)
    for (int i = tid; i < tile * c; i += NT) {
      const int r = i / c;
      xt[i] = r < tr ? xb[(size_t)t0 * c + i] : 0.f;
    }
    __syncthreads();
    for (int r = tid; r < tile; r += NT)
      tau[r] = tau_of(xt + r * c, wa_s, ba0, c, base_temp);
    __syncthreads();
    for (int i = tid; i < tile * gb; i += NT) {
      const int r = i / gb, j = i % gb;
      lt[i] = r < tr ? logit_of(xt + r * c, ws_s, bs_s[j], j, c, gb, shift,
                                tau[r])
                     : -INFINITY;
    }
    __syncthreads();
    for (int j = tid; j < gb; j += NT) {
      float mx = -INFINITY;
      for (int r = 0; r < tr; ++r) mx = fmaxf(mx, lt[r * gb + j]);
      const float m_old = m_run[j];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      resc[j] = isfinite(m_old) ? expf(m_old - m_safe) : 0.f;
      shift_s[j] = m_safe;
      m_run[j] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < tile * gb; i += NT) {
      const int r = i / gb, j = i % gb;
      lt[i] = r < tr ? expf(lt[i] - shift_s[j]) : 0.f;
    }
    __syncthreads();
    for (int j = tid; j < gb; j += NT) {
      float sum = 0.f;
      for (int r = 0; r < tr; ++r) sum += lt[r * gb + j];
      s_run[j] = s_run[j] * resc[j] + sum;
    }
#pragma unroll
    for (int a = 0; a < MAX_ACC; ++a) {
      const int e = tid + a * NT;
      if (e < gc) {
        const int j = e / c, cc = e % c;
        float v = acc[a] * resc[j];
        for (int r = 0; r < tr; ++r)
          v = fmaf(lt[r * gb + j], xt[r * c + cc], v);
        acc[a] = v;
      }
    }
  }
  __syncthreads();
  const size_t part = (size_t)bh * n_chunks + ck;
  for (int j = tid; j < gb; j += NT) {
    part_m[part * g + j0 + j] = m_run[j];
    part_s[part * g + j0 + j] = s_run[j];
  }
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) {
    const int e = tid + a * NT;
    if (e < gc) part_acc[(part * g + j0) * c + e] = acc[a];
  }
}

constexpr int GWARPS = NT / 32;

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
  for (int w = 1; w < GWARPS; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// grid (g, bh); merge the chunk partials of one (cloud, slice) by
// log-sum-exp. The chunks are split over the warps, a warp's lanes over
// channels (coalesced reads of part_acc rows).
__global__ void __launch_bounds__(NT)
slice_merge_generic(const float* __restrict__ part_m,
                    const float* __restrict__ part_s,
                    const float* __restrict__ part_acc,
                    float* __restrict__ states, float* __restrict__ m_out,
                    float* __restrict__ s_out, int n_chunks, int c, int g) {
  __shared__ float red[GWARPS];
  __shared__ float vsum[GWARPS][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x;
  const int bh = blockIdx.y;
  const float* pm = part_m + (size_t)bh * n_chunks * g + j;  // stride g
  const float* ps = part_s + (size_t)bh * n_chunks * g + j;
  // stride g*c
  const float* pa = part_acc + ((size_t)bh * n_chunks * g + j) * c;

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
      for (int k = warp; k < n_chunks; k += GWARPS) {
        const float mk = pm[(size_t)k * g];
        if (isfinite(mk))
          v = fmaf(pa[(size_t)k * g * c + cc], expf(mk - ms), v);
      }
    }
    vsum[warp][lane] = v;
    __syncthreads();
    if (warp == 0 && cc < c) {
      float t = 0.f;
      for (int w = 0; w < GWARPS; ++w) t += vsum[w][lane];
      states[((size_t)bh * g + j) * c + cc] = t / denom / (1.0f + 1e-5f);
    }
    __syncthreads();
  }
}

// grid (ceil(n / dtile), bh); out = w @ states with w recomputed, dtile *
// c <= NT * MAX_OUT outputs per block (in registers), the slices taken in
// groups of gsz staged in shared memory in turn.
__global__ void __launch_bounds__(NT)
deslice_generic(const float* __restrict__ x, const float* __restrict__ ws,
                const float* __restrict__ bs, const float* __restrict__ wa,
                const float* __restrict__ ba, const float* __restrict__ st,
                const float* __restrict__ m, const float* __restrict__ s,
                float* __restrict__ out, int n, int c, int g, int gsz,
                int dtile, float base_temp, float shift) {
  extern __shared__ __align__(16) float sm[];
  float* ws_s = sm;                 // [c, gb] this group's columns
  float* st_s = ws_s + c * gsz;     // [gb, c]
  float* bs_s = st_s + gsz * c;     // [gb]
  float* m_s = bs_s + gsz;          // [gb] finite shift
  float* d_s = m_s + gsz;           // [gb] denominator
  float* wa_s = d_s + gsz;          // [c]
  float* xt = wa_s + c;             // [dtile, c]
  float* wt = xt + dtile * c;       // [dtile, gb]
  float* tau = wt + dtile * gsz;    // [dtile]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * dtile;
  const int tr = min(dtile, n - row0);
  const float* xb = x + ((size_t)bh * n + row0) * c;
  float* ob = out + ((size_t)bh * n + row0) * c;

  for (int i = tid; i < c; i += NT) wa_s[i] = wa[i];
  for (int i = tid; i < dtile * c; i += NT)
    xt[i] = i / c < tr ? xb[i] : 0.f;
  __syncthreads();
  const float ba0 = ba[0];
  for (int r = tid; r < dtile; r += NT)
    tau[r] = tau_of(xt + r * c, wa_s, ba0, c, base_temp);

  float acc[MAX_OUT];
#pragma unroll
  for (int a = 0; a < MAX_OUT; ++a) acc[a] = 0.f;
  for (int j0 = 0; j0 < g; j0 += gsz) {
    const int gb = min(gsz, g - j0);
    __syncthreads();  // the previous group is consumed (and tau written)
    for (int i = tid; i < c * gb; i += NT) {
      const int k = i / gb;
      ws_s[i] = ws[k * g + j0 + i - k * gb];
    }
    for (int i = tid; i < gb * c; i += NT)
      st_s[i] = st[((size_t)bh * g + j0) * c + i];
    for (int j = tid; j < gb; j += NT) {
      bs_s[j] = bs[j0 + j];
      const float mj = m[(size_t)bh * g + j0 + j];
      const float sj = s[(size_t)bh * g + j0 + j];
      m_s[j] = isfinite(mj) ? mj : 0.f;
      d_s[j] = sj > 0.f ? sj : 1.f;
    }
    __syncthreads();
    for (int i = tid; i < dtile * gb; i += NT) {
      const int r = i / gb, j = i % gb;
      wt[i] = r < tr ? expf(logit_of(xt + r * c, ws_s, bs_s[j], j, c, gb,
                                     shift, tau[r]) - m_s[j]) / d_s[j]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < MAX_OUT; ++a) {
      const int e = tid + a * NT;
      if (e < tr * c) {
        const int r = e / c, cc = e - r * c;
        float v = acc[a];
        for (int j = 0; j < gb; ++j)
          v = fmaf(wt[r * gb + j], st_s[j * c + cc], v);
        acc[a] = v;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < MAX_OUT; ++a) {
    const int e = tid + a * NT;
    if (e < tr * c) ob[e] = acc[a];
  }
}

// ---------------------------------------------------------------------------
// Backward kernels: slice_bwd_fast and slice_bwd_generic (four modes
// each) and sum_partials.
//
// Replace the backwards of the Pallas kernels' custom_vjp pairs in
// haet_tpu/ops/pallas/slice_kernels.py: _slice_states_bwd (one pass over N
// in JAX, its softmax coupling in closed form) and _deslice_bwd (two
// passes: the coupling t and dL/dstates, then the chain). Per cloud, with
// the weights w[n, g] = exp(z[n, g] - m[g]) / s[g] recomputed from the
// residuals and logit = z = (x . Ws + bs - shift) / tau:
//   dlogit = w (dw - t),  dpre = dlogit / tau,
//   dtau = -sum_g dlogit * logit / tau,  draw = dtau inside (-0.4, 0.4),
//   dx = dpre Ws^T + draw Wa^T (+ w G^ for slice_states),
//   dWs = x^T dpre, dbs = sum_n dpre, dWa = x^T draw, dba = sum_n draw,
// where dw = x G^T (slice_states: G^ = dL/dstates / (1 + 1e-5); the norm's
// own term cancels in dw - t) or g_out states^T (deslice), and t = sum_n w
// dw, summed by a first pass over N in both (and for deslice dstates = w^T
// g_out).
//
// What bounds them on an H100: at the car's training batch (BH 8, N 32768,
// C = G = 32) slice_states_bwd reads x and writes dx (67 MB, 20 us at 3.35
// TB/s; ~30 us for two passes that each read x) and deslice_bwd reads x
// and g_out and writes dx (101 MB, 30 us; ~50 us for two passes that each
// read both); their products, five of 2 N C G FLOP each (seven for
// deslice's two passes), take 17 and 23 us in 3xTF32
// on the tensor cores, 41 and 57 us in float32 FMA. The design keeps the
// [B, H, N, G] tensors of the chunked PyTorch version out of device memory
// and runs every product in 3xTF32 mma.sync as the forwards do:
//   * One kernel, four modes: BWD_STATES_SUMS and BWD_STATES (slice_states'
//     first pass and chain), BWD_SUMS and BWD_CHAIN (deslice's). Each warp
//     streams its tiles of TR rows of x (and g_out) through a cp.async ring,
//     as the forwards do, and handles them 16 rows at a time in the row
//     layout of deslice_fast: Z = x Ws and the dw product are accumulator
//     fragments (rows gid, gid + 8; slices 2 tig, 2 tig + 1 of each block of
//     8), and so are w, dlogit and dpre, elementwise.
//   * dx^T = Ws dpre^T (+ G^T w^T): the accumulator fragment of dpre is,
//     entry for entry, the B fragment of that product (k = tig is slice
//     2 tig), so dx never leaves registers until the tile's store.
//   * dWs^T = dpre^T x (and dstates = w^T g_out) contract over rows, which
//     the fragment layout holds on gid: each warp writes dpre (w) of its 16
//     rows to its own shared buffer and reads it back as A fragments; x is
//     the B fragment, read from the ring slot.
//   * Ws and the G-side matrix (G^ or states) are staged once per block,
//     split into their TF32 high and low parts, in fragment order: a lane
//     reads each fragment as one 16-byte load (four tables, 32 KB at C 32).
//   * Slices come in windows of BW = 32, the accumulators of one window in
//     registers. The first passes take their windows as grid z (their
//     slices are independent); the chains couple a row's slices through
//     dtau, so the wrapper launches them once per window: a launch adds its
//     window's dx and sum_g dlogit * logit to those of the earlier ones
//     (kept in dx and a [B*H, N] scratch), and the last one applies draw.
//     At G <= 32 (the car) there is one window and no scratch.
//   * The weights' normalisation: the first pass also sums S = sum_n w.
//     The residuals (m, s) come from the forward's logits, whose rounding
//     differs from this recomputation's, so S = 1 + O(1e-6); at
//     temperatures near 0.1 and logits near 100 that mismatch, carried
//     through the coupling t, cost deslice_bwd ~1e-4 of max |dx| and
//     slice_states_bwd (with t in closed form, from the forward's states)
//     ~5e-3 of max |d b_slice| against float64. The chains therefore use w
//     / S and t / S: the exact softmax of their own logits. (slice_states'
//     closed form would save its first pass, but needs sum_n w = 1.)
//   * Each block writes its partial sums (dWs^T, dbs, dWa, dba; or t, S and
//     dstates), its warps merged in warp order; sum_partials adds the
//     blocks' partials in block order, then cloud order. No float atomics:
//     two calls give bit-identical results.
//   * Rows past N are masked to zero dpre, w and draw, and zero features in
//     the row-contracted products; a slice past G gets m = +inf (w = 0).
// ---------------------------------------------------------------------------

constexpr int BW = 32;                      // slices per window
constexpr int BUF_STRIDE = BW + 4;          // row stride of the dpre buffer
constexpr int BWD_STATES = 0, BWD_SUMS = 1, BWD_CHAIN = 2;
constexpr int BWD_STATES_SUMS = 3;
constexpr int BWD_FIRST = 1, BWD_LAST = 2;  // window flags

// The first passes (t and sum_n w; deslice's also dstates) against the
// chain modes.
__host__ __device__ constexpr bool bwd_sums(int mode) {
  return mode == BWD_SUMS || mode == BWD_STATES_SUMS;
}

// The modes that read g_out (deslice's) against those that read x alone.
__host__ __device__ constexpr bool bwd_gout(int mode) {
  return mode == BWD_SUMS || mode == BWD_CHAIN;
}

// Channel blocks of 16 of dx^T (M = channels): C 8 takes one, half zero.
template <int CM>
__host__ __device__ constexpr int bwd_mc() {
  return CM >= 16 ? CM / 16 : 1;
}

// Words of a B table ([KB][BW / 8][32 lanes] x uint4: hi, lo of b0, b1) and
// of an A table ([MC][BW / 8][32 lanes] x 2 uint4: hi, lo of a0 .. a3).
template <int CM>
__host__ __device__ constexpr int tab_b_words() {
  return (CM / 8) * (BW / 8) * 32 * 4;
}

template <int CM>
__host__ __device__ constexpr int tab_a_words() {
  return bwd_mc<CM>() * (BW / 8) * 32 * 8;
}

// Row stride of a block's partial sums: the channels, then dbs (chain) or
// t and sum_n w (first pass).
template <int CM, int MODE>
__host__ __device__ constexpr int bwd_row() {
  return CM + (bwd_sums(MODE) ? 2 : 1);
}

// Floats of one block's partial sums: [BW][bwd_row] (dWs^T and dbs, or
// dstates, t and sum_n w), then for the chain modes dWa [CM] and dba.
template <int CM, int MODE>
__host__ __device__ constexpr int bwd_part_floats() {
  return BW * bwd_row<CM, MODE>() + (bwd_sums(MODE) ? 0 : CM + 1);
}

// Dynamic shared memory of slice_bwd_fast in floats (mirrors
// bwd_smem_bytes() in the wrapper): the x ring (and the g_out ring); the B
// tables of Ws and of the G-side matrix; the A tables of Ws (and of G^,
// slice_states); bs - shift, m, 1 / s, u of the window; Wa; the
// warps' dpre buffers [16][BUF_STRIDE] and draw [16].
template <int CM, int MODE>
__host__ __device__ constexpr int bwd_smem_floats() {
  return (bwd_gout(MODE) ? 2 : 1) * ring_floats<CM>() +
         2 * tab_b_words<CM>() +
         (MODE == BWD_STATES ? 2 : MODE == BWD_CHAIN ? 1 : 0) *
             tab_a_words<CM>() +
         4 * BW + CM + WARPS * 16 * (BUF_STRIDE + 1);
}

// 1 / tau and the raw Ada-Temp value x . Wa + ba of the slot's row `lane`.
template <int CM>
__device__ __forceinline__ void row_raw_tau(const float* slot,
                                            const float* wa_s, float ba,
                                            float base_temp, int lane,
                                            float& raw, float& it) {
  const float* xr = slot + lane * row_stride<CM>();
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int k = 0; k < CM; k += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + k);
    const float4 wv = *reinterpret_cast<const float4*>(wa_s + k);
    d0 = fmaf(xv.x, wv.x, d0);
    d1 = fmaf(xv.y, wv.y, d1);
    d0 = fmaf(xv.z, wv.z, d0);
    d1 = fmaf(xv.w, wv.w, d1);
  }
  raw = d0 + d1 + ba;
  it = 1.f / (base_temp + fminf(fmaxf(raw, -0.4f), 0.4f));
}

__device__ __forceinline__ void split_b(Split (&b)[2], uint4 t) {
  b[0] = {t.x, t.y};
  b[1] = {t.z, t.w};
}

__device__ __forceinline__ void split_a(Split (&a)[4], uint4 t0, uint4 t1) {
  a[0] = {t0.x, t0.y};
  a[1] = {t0.z, t0.w};
  a[2] = {t1.x, t1.y};
  a[3] = {t1.z, t1.w};
}

__device__ __forceinline__ uint4 split_pair(float v0, float v1) {
  const Split a = split(v0), b = split(v1);
  return make_uint4(a.hi, a.lo, b.hi, b.lo);
}

// grid (per_cloud, bh, windows), NTF threads; N cut as for the forwards.
// Block (blockIdx.x, blockIdx.y) takes rows [blockIdx.x * span, + span) of
// cloud blockIdx.y for the window of slices [w * BW, + BW), w = win0 +
// blockIdx.z. Inputs: x, g_out [bh, n, c]; Ws [c, g]; bs [g]; Wa [c]; ba;
// bmat [bh, g, c] (dL/dstates for slice_states' modes, the states for
// deslice's); tsum the first pass's sums (chain modes: t and S of cloud b,
// slice w * BW + i at ((w * bh + b) * BW + i) * (CM + 2) + CM and + 1); m,
// s [bh, g]. Outputs: part [windows][bh][per_cloud][bwd_part_floats]; dx
// [bh, n, c] and the scratch q [bh, n] (chain modes). x, g_out, bmat and dx
// are T; the windows' dx sums meet in dacc (float32; dx itself for a
// float32 dx), and the last window writes dx. MODE is the last template
// argument: the profiler's name of a launch tells the mode by it
// (haet_torch/ops/kernels/__init__.py:KERNEL_NAMES).
template <typename T, int CM, int MODE>
__global__ void __launch_bounds__(NTF, 1)
slice_bwd_fast(const T* __restrict__ x, const T* __restrict__ gout,
               const float* __restrict__ ws, const float* __restrict__ bs,
               const float* __restrict__ wa, const float* __restrict__ ba,
               const T* __restrict__ bmat, const float* __restrict__ tsum,
               const float* __restrict__ m, const float* __restrict__ s,
               float* __restrict__ part, T* dx, float* dacc,
               float* __restrict__ qbuf, int n, int c, int g, int span,
               int win0, int flags, float base_temp, float shift) {
  constexpr bool CHAIN = !bwd_sums(MODE);      // the chain to x and the
  constexpr bool APATH = MODE == BWD_STATES;   // weights; dx += w G^
  constexpr bool GOUT = bwd_gout(MODE);        // a g_out stream
  constexpr bool DST = MODE == BWD_SUMS;       // dstates = w^T g_out
  constexpr int KB = CM / 8, NB = BW / 8, NC = CM / 8, MB = BW / 16;
  constexpr int MC = bwd_mc<CM>(), Q = CM / 4, CS = row_stride<CM>();
  constexpr int PW = bwd_part_floats<CM, MODE>(), RW = bwd_row<CM, MODE>();
  extern __shared__ __align__(16) float sm[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, nbh = gridDim.y, per_cloud = gridDim.x;
  const int win = win0 + blockIdx.z, w0 = win * BW, gw = min(BW, g - w0);
  const bool first = flags & BWD_FIRST, last = flags & BWD_LAST;
  const int row_begin = blockIdx.x * span;
  const int rows_blk = min(span, n - row_begin);
  const size_t cloud = static_cast<size_t>(bh) * n * c;
  const T* xb = x + cloud;
  const T* gb = GOUT ? gout + cloud : nullptr;
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(x) |
      (GOUT ? reinterpret_cast<uintptr_t>(gout) : 0) |
      (CHAIN ? reinterpret_cast<uintptr_t>(dx) |
                   reinterpret_cast<uintptr_t>(dacc) : 0);
  const bool vec = vec_ok<T>(c, ptrs);

  float* ring_x = sm;                           // [WARPS][STAGES][TR][CS]
  float* ring_g = ring_x + ring_floats<CM>();   // the same, if GOUT
  uint4* tzb = reinterpret_cast<uint4*>(ring_x + (GOUT ? 2 : 1) *
                                                     ring_floats<CM>());
  uint4* tdb = tzb + tab_b_words<CM>() / 4;   // G-side matrix as B
  uint4* twa = tdb + tab_b_words<CM>() / 4;   // Ws as A (chain modes)
  uint4* tba = twa + (CHAIN ? tab_a_words<CM>() / 4 : 0);  // G^ as A
  float* bsh_s = reinterpret_cast<float*>(
      tba + (APATH ? tab_a_words<CM>() / 4 : 0));          // [BW]
  float* m_s = bsh_s + BW;                                  // [BW]
  float* is_s = m_s + BW;                                  // [BW]
  float* u_s = is_s + BW;                                   // [BW]
  float* wa_s = u_s + BW;                                   // [CM]
  float* buf = wa_s + CM + warp * 16 * BUF_STRIDE;          // [16][BS]
  float* drw = wa_s + CM + WARPS * 16 * BUF_STRIDE + warp * 16;  // [16]

  const int tiles = (rows_blk + TR - 1) / TR;
  const int my_tiles = tiles > warp ? (tiles - warp + WARPS - 1) / WARPS : 0;
  float* my_x = ring_x + warp * STAGES * TR * CS;
  float* my_g = ring_g + warp * STAGES * TR * CS;
  const int first_row = row_begin + warp * TR;
  constexpr int STRIDE = WARPS * TR;
  auto load = [&](int jt) {  // tile jt of this warp into its ring slots
    const int r0 = first_row + jt * STRIDE, rows = min(TR, n - r0);
    load_tile<CM, T>(my_x + (jt % STAGES) * TR * CS, xb, r0, rows, c, vec,
                     lane);
    if constexpr (GOUT)
      load_tile<CM, T>(my_g + (jt % STAGES) * TR * CS, gb, r0, rows, c, vec,
                       lane);
  };

  if (c < CM) {  // padding columns must read as zeros
    for (int i = tid; i < (GOUT ? 2 : 1) * ring_floats<CM>(); i += NTF)
      ring_x[i] = 0.f;
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < my_tiles) load(j);
    cp_commit();
  }

  // The window's Ws and G-side matrix, split, in fragment order; per slice
  // bs - shift, finite m (+inf past G: w = 0), 1 / s and u.
  const float bscale = GOUT ? 1.f : 1.f / NORM;
  const T* bmw = bmat + (static_cast<size_t>(bh) * g + w0) * c;
  auto wsv = [&](int k, int sl) {
    return k < c && sl < gw ? ws[k * g + w0 + sl] : 0.f;
  };
  auto bmv = [&](int sl, int k) {
    return k < c && sl < gw ? to_f32(bmw[sl * c + k]) * bscale : 0.f;
  };
  for (int e = tid; e < KB * NB * 32; e += NTF) {
    // b0, b1 of k-block kb, slice block nb: channels Q*tig + 2*kb (+ 1),
    // slice nb*8 + gid
    const int ln = e & 31, kb = (e >> 5) / NB, nb = (e >> 5) - kb * NB;
    const int k0 = Q * (ln & 3) + 2 * kb, sl = nb * 8 + (ln >> 2);
    tzb[e] = split_pair(wsv(k0, sl), wsv(k0 + 1, sl));
    tdb[e] = split_pair(bmv(sl, k0), bmv(sl, k0 + 1));
  }
  if constexpr (CHAIN) {
    for (int e = tid; e < MC * NB * 32; e += NTF) {
      // a0 .. a3 of channel block mc, slice block nb: channels mc*16 + gid
      // (+ 8), slices nb*8 + 2*tig (+ 1)
      const int ln = e & 31, mc = (e >> 5) / NB, nb = (e >> 5) - mc * NB;
      const int ch = mc * 16 + (ln >> 2), sl = nb * 8 + 2 * (ln & 3);
      twa[2 * e] = split_pair(wsv(ch, sl), wsv(ch + 8, sl));
      twa[2 * e + 1] = split_pair(wsv(ch, sl + 1), wsv(ch + 8, sl + 1));
      if constexpr (APATH) {
        tba[2 * e] = split_pair(bmv(sl, ch), bmv(sl, ch + 8));
        tba[2 * e + 1] = split_pair(bmv(sl + 1, ch), bmv(sl + 1, ch + 8));
      }
    }
  }
  if (tid < BW) {
    const bool in = tid < gw;
    const size_t sg = static_cast<size_t>(bh) * g + w0 + tid;
    const float mj = in ? m[sg] : 0.f, sj = in ? s[sg] : 1.f;
    bsh_s[tid] = in ? bs[w0 + tid] - shift : 0.f;
    m_s[tid] = in ? (isfinite(mj) ? mj : 0.f) : INFINITY;
    float u = 0.f, norm = 1.f;
    if (in && CHAIN) {  // t / S, and w / S
      const float* ts =
          tsum + ((static_cast<size_t>(win) * nbh + bh) * BW + tid) *
                     (CM + 2) + CM;
      norm = ts[1] > 0.f ? ts[1] : 1.f;
      u = -ts[0] / norm;
    }
    is_s[tid] = 1.f / ((sj > 0.f ? sj : 1.f) * norm);
    u_s[tid] = u;
  }
  if (tid < CM) wa_s[tid] = tid < c ? wa[tid] : 0.f;
  const float ba0 = ba[0];
  __syncthreads();

  // acc: dWs^T (chain) or dstates (first pass), slices mb*16 + gid (+ 8),
  // channels nc*8 + 2*tig (+ 1); colsum: dbs or t of the lane's slices
  // nb*8 + 2*tig (+ 1), over its rows, and wsum their sum_n w (first
  // pass); dWa of channel `lane`, dba.
  float acc[MB][NC][4], colsum[NB][2], wsum[NB][2];
  float dwa_l = 0.f, dba_l = 0.f;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][nc][i] = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
    colsum[nb][0] = colsum[nb][1] = wsum[nb][0] = wsum[nb][1] = 0.f;

  for (int j = 0; j < my_tiles; ++j) {
    __syncwarp();  // every lane is done with the slots refilled below
    if (j + STAGES - 1 < my_tiles) load(j + STAGES - 1);
    cp_commit();
    cp_wait<STAGES - 1>();
    __syncwarp();
    float* slot = my_x + (j % STAGES) * TR * CS;
    const int row0 = first_row + j * STRIDE;
    const int rows = min(TR, n - row0);
    convert_tile<CM, T>(slot, rows, c, vec, lane);
    if constexpr (GOUT)
      convert_tile<CM, T>(my_g + (j % STAGES) * TR * CS, rows, c, vec, lane);
    const float* gslot = GOUT ? my_g + (j % STAGES) * TR * CS : slot;
    float raw_l, it_l;
    row_raw_tau<CM>(slot, wa_s, ba0, base_temp, lane, raw_l, it_l);
    for (int r16 = 0; r16 < rows; r16 += 16) {
      // A fragments of rows r16 + gid (a0, a2) and r16 + gid + 8 (a1, a3):
      // x, and g_out for the dw product
      Split xf[KB][4], gf[KB][4];
      {
        const float* x0 = slot + (r16 + gid) * CS + Q * tig;
        float q0[Q], q1[Q];
        load_quarter<CM>(q0, x0);
        load_quarter<CM>(q1, x0 + 8 * CS);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          xf[kb][0] = split(q0[2 * kb]);
          xf[kb][1] = split(q1[2 * kb]);
          xf[kb][2] = split(q0[2 * kb + 1]);
          xf[kb][3] = split(q1[2 * kb + 1]);
        }
        if constexpr (GOUT) {
          const float* g0 = gslot + (r16 + gid) * CS + Q * tig;
          load_quarter<CM>(q0, g0);
          load_quarter<CM>(q1, g0 + 8 * CS);
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            gf[kb][0] = split(q0[2 * kb]);
            gf[kb][1] = split(q1[2 * kb]);
            gf[kb][2] = split(q0[2 * kb + 1]);
            gf[kb][3] = split(q1[2 * kb + 1]);
          }
        }
      }
      const float it0 = __shfl_sync(FULL, it_l, r16 + gid);
      const float it1 = __shfl_sync(FULL, it_l, r16 + gid + 8);
      const bool v0 = r16 + gid < rows, v1 = r16 + gid + 8 < rows;
      float q0 = 0.f, q1 = 0.f;  // sum_g dlogit * logit, rows gid, gid + 8
      float dxt[MC][2][4];       // dx^T: channels mc*16 + gid (+ 8), rows
#pragma unroll                   // nr*8 + 2*tig (+ 1)
      for (int mc = 0; mc < MC; ++mc)
#pragma unroll
        for (int nr = 0; nr < 2; ++nr)
#pragma unroll
          for (int i = 0; i < 4; ++i) dxt[mc][nr][i] = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c0 = nb * 8 + 2 * tig;  // the lane's slices c0, c0 + 1
        // Z and dw (- t): bs - shift and u ride in the hi*hi accumulators
        float zp[2][4] = {{0.f, 0.f, 0.f, 0.f},
                          {bsh_s[c0], bsh_s[c0 + 1], bsh_s[c0],
                           bsh_s[c0 + 1]}};
        float dp[2][4] = {{0.f, 0.f, 0.f, 0.f},
                          {u_s[c0], u_s[c0 + 1], u_s[c0], u_s[c0 + 1]}};
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          Split b[2];
          split_b(b, tzb[(kb * NB + nb) * 32 + lane]);
          mma3_split(zp, xf[kb], b);
          split_b(b, tdb[(kb * NB + nb) * 32 + lane]);
          if constexpr (GOUT) mma3_split(dp, gf[kb], b);
          else mma3_split(dp, xf[kb], b);
        }
        float val[4], wv[4];  // dpre (chain) or w (first pass); w
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int sl = c0 + (i & 1);
          const bool valid = i < 2 ? v0 : v1;
          const float lg = (zp[0][i] + zp[1][i]) * (i < 2 ? it0 : it1);
          const float w = ex2((lg - m_s[sl]) * L2E) * is_s[sl];
          const float d = dp[0][i] + dp[1][i];
          wv[i] = valid ? w : 0.f;
          if constexpr (CHAIN) {
            const float dl = w * d;
            val[i] = valid ? dl * (i < 2 ? it0 : it1) : 0.f;
            if (i < 2) q0 = fmaf(dl, lg, q0);
            else q1 = fmaf(dl, lg, q1);
          } else {
            val[i] = wv[i];
            wsum[nb][i & 1] += wv[i];
            if (valid) colsum[nb][i & 1] = fmaf(w, d, colsum[nb][i & 1]);
          }
        }
        if constexpr (CHAIN) {
          colsum[nb][0] += val[0] + val[2];
          colsum[nb][1] += val[1] + val[3];
        }
        if constexpr (CHAIN || DST) {
          *reinterpret_cast<float2*>(buf + gid * BUF_STRIDE + c0) =
              make_float2(val[0], val[1]);
          *reinterpret_cast<float2*>(buf + (gid + 8) * BUF_STRIDE + c0) =
              make_float2(val[2], val[3]);
        }
        if constexpr (CHAIN) {
          // dx^T += Ws dpre^T (+ G^T w^T): the fragments of dpre (w) are the
          // B fragments, rows gid (nr 0) and gid + 8 (nr 1)
          const Split bp[2][2] = {{split(val[0]), split(val[1])},
                                  {split(val[2]), split(val[3])}};
          Split bw[2][2];
          if constexpr (APATH) {
            bw[0][0] = split(wv[0]);
            bw[0][1] = split(wv[1]);
            bw[1][0] = split(wv[2]);
            bw[1][1] = split(wv[3]);
          }
#pragma unroll
          for (int mc = 0; mc < MC; ++mc) {
            const int e = (mc * NB + nb) * 32 + lane;
            Split a[4];
            split_a(a, twa[2 * e], twa[2 * e + 1]);
            mma3(dxt[mc][0], a, bp[0]);
            mma3(dxt[mc][1], a, bp[1]);
            if constexpr (APATH) {
              split_a(a, tba[2 * e], tba[2 * e + 1]);
              mma3(dxt[mc][0], a, bw[0]);
              mma3(dxt[mc][1], a, bw[1]);
            }
          }
        }
      }
      if constexpr (CHAIN) {
        q0 += __shfl_xor_sync(FULL, q0, 1);
        q0 += __shfl_xor_sync(FULL, q0, 2);
        q1 += __shfl_xor_sync(FULL, q1, 1);
        q1 += __shfl_xor_sync(FULL, q1, 2);
        const size_t qr = static_cast<size_t>(bh) * n + row0 + r16 + gid;
        if (!first) {  // the earlier windows' sums of these rows
          if (v0) q0 += qbuf[qr];
          if (v1) q1 += qbuf[qr + 8];
        }
        if (!last) {
          if (tig == 0 && v0) qbuf[qr] = q0;
          if (tig == 0 && v1) qbuf[qr + 8] = q1;
        } else {
          const float raw0 = __shfl_sync(FULL, raw_l, r16 + gid);
          const float raw1 = __shfl_sync(FULL, raw_l, r16 + gid + 8);
          const float dr0 =
              v0 && raw0 > -0.4f && raw0 < 0.4f ? -q0 * it0 : 0.f;
          const float dr1 =
              v1 && raw1 > -0.4f && raw1 < 0.4f ? -q1 * it1 : 0.f;
          // dx^T[ch][row] += Wa[ch] draw[row] for the lane's rows nr*8 +
          // 2*tig (+ 1), held by the lanes of gid 2*tig (+ 1)
          float d[2][2];
          d[0][0] = __shfl_sync(FULL, dr0, 8 * tig);
          d[0][1] = __shfl_sync(FULL, dr0, 8 * tig + 4);
          d[1][0] = __shfl_sync(FULL, dr1, 8 * tig);
          d[1][1] = __shfl_sync(FULL, dr1, 8 * tig + 4);
#pragma unroll
          for (int mc = 0; mc < MC; ++mc) {
            const int ch = mc * 16 + gid;
            const float wa0 = wa_s[ch], wa1 = ch + 8 < CM ? wa_s[ch + 8] : 0.f;
#pragma unroll
            for (int nr = 0; nr < 2; ++nr) {
              dxt[mc][nr][0] = fmaf(wa0, d[nr][0], dxt[mc][nr][0]);
              dxt[mc][nr][1] = fmaf(wa0, d[nr][1], dxt[mc][nr][1]);
              dxt[mc][nr][2] = fmaf(wa1, d[nr][0], dxt[mc][nr][2]);
              dxt[mc][nr][3] = fmaf(wa1, d[nr][1], dxt[mc][nr][3]);
            }
          }
          if (tig == 0) {
            drw[gid] = dr0;
            drw[gid + 8] = dr1;
            dba_l += dr0 + dr1;
          }
        }
      }
      __syncwarp();  // the buffer (and draw) are written
      // acc += buf^T B over these 16 rows: dpre^T x (chain) or w^T g_out;
      // k = tig is row kr*8 + 2*tig, k = tig + 4 row kr*8 + 2*tig + 1
      const float* bsrc = CHAIN ? slot : gslot;
#pragma unroll
      for (int kr = 0; kr < ((CHAIN || DST) ? 2 : 0); ++kr) {
        const int ra = kr * 8 + 2 * tig;
        const bool va = r16 + ra < rows, vb = r16 + ra + 1 < rows;
        Split af[MB][4];
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const float* p = buf + ra * BUF_STRIDE + mb * 16 + gid;
          af[mb][0] = split(p[0]);
          af[mb][1] = split(p[8]);
          af[mb][2] = split(p[BUF_STRIDE]);
          af[mb][3] = split(p[BUF_STRIDE + 8]);
        }
#pragma unroll
        for (int nc = 0; nc < NC; ++nc) {
          const float* p = bsrc + (r16 + ra) * CS + nc * 8 + gid;
          const Split b[2] = {split(va ? p[0] : 0.f),
                              split(vb ? p[CS] : 0.f)};
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) mma3(acc[mb][nc], af[mb], b);
        }
      }
      if constexpr (CHAIN) {
        if (last && lane < CM) {  // dWa of channel `lane`
          for (int r = 0; r < 16 && r16 + r < rows; ++r)
            dwa_l = fmaf(slot[(r16 + r) * CS + lane], drw[r], dwa_l);
        }
        __syncwarp();  // every lane is done reading these rows' x
#pragma unroll
        for (int mc = 0; mc < MC; ++mc)
#pragma unroll
          for (int nr = 0; nr < 2; ++nr)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int ch = mc * 16 + gid + 8 * (i >> 1);
              const int r = r16 + nr * 8 + 2 * tig + (i & 1);
              if (ch < CM) slot[r * CS + ch] = dxt[mc][nr][i];
            }
      }
      __syncwarp();  // the buffer is free for the next 16 rows
    }
    if constexpr (CHAIN)  // the tile's dx (added to the earlier windows')
      store_tile<CM, T>(slot, dacc, dx, cloud + static_cast<size_t>(row0) * c,
                        rows, c, vec, first, last, lane);
  }
  cp_wait<0>();
  __syncthreads();  // the rings are free: the warps' partials go there

  // The warps' sums, then the block's in warp order.
  float* mg = sm;  // [WARPS][PW]
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = colsum[nb][h];
      v += __shfl_xor_sync(FULL, v, 4);
      v += __shfl_xor_sync(FULL, v, 8);
      v += __shfl_xor_sync(FULL, v, 16);
      float* row = mg + warp * PW + (nb * 8 + 2 * tig + h) * RW;
      if (gid == 0) row[CM] = v;
      if constexpr (!CHAIN) {
        v = wsum[nb][h];
        v += __shfl_xor_sync(FULL, v, 4);
        v += __shfl_xor_sync(FULL, v, 8);
        v += __shfl_xor_sync(FULL, v, 16);
        if (gid == 0) row[CM + 1] = v;
      }
    }
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mg[warp * PW + (mb * 16 + gid + 8 * (i >> 1)) * RW + nc * 8 +
           2 * tig + (i & 1)] = acc[mb][nc][i];
  if constexpr (CHAIN) {
    if (lane < CM) mg[warp * PW + BW * RW + lane] = dwa_l;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dba_l += __shfl_xor_sync(FULL, dba_l, o);
    if (lane == 0) mg[warp * PW + PW - 1] = dba_l;
  }
  __syncthreads();
  float* pb = part + ((static_cast<size_t>(win) * nbh + bh) * per_cloud +
                      blockIdx.x) * PW;
  for (int e = tid; e < PW; e += NTF) {
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) v += mg[u * PW + e];
    pb[e] = v;
  }
}

// Where sum_partials puts its sums, for windows of wr slices (BW for
// slice_bwd_fast, g for slice_bwd_generic). SUM_PARAMS (b a window of the
// chain, rows [wr][rw] of dWs^T and dbs, then dWa, dba): dWs [c][g] (out),
// dbs [g] (o2), and from the last window dWa [c] (o3), dba (o4). SUM_STATES
// (b = window * bh + cloud, rows [wr][rw] of dstates, t and sum_n w):
// out[b][j], and dstates [bh][g][c] (o2, float32, or o2h, bf16, if not
// null).
constexpr int SUM_PARAMS = 1, SUM_STATES = 2;

struct SumOut {
  float *out, *o2, *o3, *o4;
  bf16* o2h;
  int mode, c, g, cm, rw, bh, windows, wr;
};

// grid (ceil(len / 32), batches), NT threads: the sum over p < parts of
// part[b][p][j], each warp adding a contiguous eighth of the p in order,
// then the warps' sums in warp order (a fixed order: two calls agree bit
// for bit).
__global__ void __launch_bounds__(NT)
sum_partials(const float* __restrict__ part, int parts, int len, SumOut o) {
  __shared__ float red[NT / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane, b = blockIdx.y;
  const int per = (parts + NT / 32 - 1) / (NT / 32);
  const int p0 = min(parts, warp * per), p1 = min(parts, p0 + per);
  float v = 0.f;
  if (j < len) {
    const float* p = part + (static_cast<size_t>(b) * parts + p0) * len + j;
#pragma unroll 8
    for (int k = p0; k < p1; ++k) v += p[static_cast<size_t>(k - p0) * len];
  }
  red[warp][lane] = v;
  __syncthreads();
  if (warp != 0 || j >= len) return;
  v = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) v += red[w][lane];
  if (o.mode == SUM_STATES) o.out[static_cast<size_t>(b) * len + j] = v;
  if (j >= o.wr * o.rw) {  // the chain's dWa, dba: the last window's
    const int k = j - o.wr * o.rw;
    if (o.mode == SUM_PARAMS && b == o.windows - 1) {
      if (k < o.c) o.o3[k] = v;
      if (k == o.cm) o.o4[0] = v;
    }
    return;
  }
  const int row = j / o.rw, col = j - row * o.rw;
  if (o.mode == SUM_PARAMS) {
    const int sl = b * o.wr + row;
    if (sl < o.g && col < o.c) o.out[col * o.g + sl] = v;
    if (sl < o.g && col == o.cm) o.o2[sl] = v;
  } else if (o.mode == SUM_STATES) {
    const int win = b / o.bh, cloud = b - win * o.bh, sl = win * o.wr + row;
    const size_t e = (static_cast<size_t>(cloud) * o.g + sl) * o.c + col;
    if (sl < o.g && col < o.c) {
      if (o.o2) o.o2[e] = v;
      if (o.o2h) o.o2h[e] = __float2bfloat16_rn(v);
    }
  }
}

// ---------------------------------------------------------------------------
// slice_bwd_generic: the backward kernels' four modes for C > 32 (up to
// MAX_GENERIC_C) and any G, per-thread loops over shared memory as in the
// generic forwards; right, not fast. The logits, the temperature and the
// dw product run in float64 (dot4d): the bias gradients sum ~N terms that
// cancel, each carrying the logits' rounding through the exp, and at
// these widths float32 logits alone put d b_ada ~1e-3 of its max from
// float64. Everything else is float32 FMA. A block takes rows [blockIdx.x * span, + span) of cloud
// blockIdx.y in tiles of `tile` rows, and the slices in groups of gsz whose
// Ws and G-side matrix it stages (gsz * C <= NT * MAX_ACC: a group's dWs^T
// or dstates accumulators fit the registers). The first passes take their
// groups as grid z. A chain mode loops over the groups in the block: each
// group adds its dx and its rows' sum_g dlogit * logit to the earlier
// groups' (in dx and the scratch q [bh, n], an entry read and written by
// one thread), and the last applies draw. A block's partials: per slice,
// dWs^T and dbs (chain modes) or dstates, t and sum_n w (first passes),
// rows [g][rw]; then dWa [c] and dba (chain modes); sum_partials adds the
// blocks' in a fixed order, as for slice_bwd_fast.
// ---------------------------------------------------------------------------

// Shared memory of slice_bwd_generic in floats, fixed and per row of a
// tile (mirrors generic_bwd_plan() in the wrapper): a group's Ws [c][gsz]
// and G-side matrix [gsz][c], its bs - shift, m, 1 / s and u, and Wa; per
// row, 1 / tau (a double), x and g_out, three [gsz] buffers, raw and draw.
__host__ __device__ inline int generic_bwd_fixed(int c, int gsz) {
  return 2 * c * gsz + 4 * gsz + c;
}

__host__ __device__ inline int generic_bwd_per_row(int c, int gsz) {
  return 2 * c + 3 * gsz + 4;
}

// dot4 in float64.
__device__ __forceinline__ double dot4d(const float* xr, const float* w,
                                        int ld, int c) {
  auto d = [](float v) { return static_cast<double>(v); };
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  int k = 0;
  for (; k + 4 <= c; k += 4) {
    a0 = fma(d(xr[k]), d(w[k * ld]), a0);
    a1 = fma(d(xr[k + 1]), d(w[(k + 1) * ld]), a1);
    a2 = fma(d(xr[k + 2]), d(w[(k + 2) * ld]), a2);
    a3 = fma(d(xr[k + 3]), d(w[(k + 3) * ld]), a3);
  }
  for (; k < c; ++k) a0 = fma(d(xr[k]), d(w[k * ld]), a0);
  return (a0 + a1) + (a2 + a3);
}

template <int MODE>
__global__ void __launch_bounds__(NT)
slice_bwd_generic(const float* __restrict__ x, const float* __restrict__ gout,
                  const float* __restrict__ ws, const float* __restrict__ bs,
                  const float* __restrict__ wa, const float* __restrict__ ba,
                  const float* __restrict__ bmat,
                  const float* __restrict__ tsum, const float* __restrict__ m,
                  const float* __restrict__ s, float* __restrict__ part,
                  float* __restrict__ dx, float* __restrict__ qbuf, int n,
                  int c, int g, int gsz, int tile, int span, float base_temp,
                  float shift) {
  constexpr bool SUMS = bwd_sums(MODE);        // a first pass
  constexpr bool APATH = MODE == BWD_STATES;   // dx += w G^
  constexpr bool GOUT = bwd_gout(MODE);        // a g_out stream
  constexpr bool DST = MODE == BWD_SUMS;       // dstates = w^T g_out
  extern __shared__ __align__(16) float sm[];
  double* it_s = reinterpret_cast<double*>(sm);  // [tile] 1 / tau
  float* ws_s = sm + 2 * tile;       // [c][gsz]
  float* bm_s = ws_s + c * gsz;      // [gsz][c] G^ or the states
  float* bsh_s = bm_s + gsz * c;     // [gsz] bs - shift
  float* m_s = bsh_s + gsz;          // [gsz] finite m (+inf past G)
  float* is_s = m_s + gsz;           // [gsz] 1 / (s S)
  float* u_s = is_s + gsz;           // [gsz] -t / S
  float* wa_s = u_s + gsz;           // [c]
  float* xt = wa_s + c;              // [tile][c]
  float* gt = xt + tile * c;         // [tile][c] (GOUT)
  float* val = gt + tile * c;        // [tile][gsz] dpre, or w (first pass)
  float* wt = val + tile * gsz;      // [tile][gsz] w (APATH), or w * d
  float* ql = wt + tile * gsz;       // [tile][gsz] dlogit * logit
  float* raw_s = ql + tile * gsz;    // [tile]
  float* dr_s = raw_s + tile;        // [tile] draw

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, blk = blockIdx.x;
  const int row_begin = blk * span, rows_blk = min(span, n - row_begin);
  const size_t cloud = static_cast<size_t>(bh) * n;
  const float ba0 = ba[0];
  const float bscale = GOUT ? 1.f : 1.f / NORM;
  const int groups = (g + gsz - 1) / gsz;
  const int rw = c + (SUMS ? 2 : 1);
  float* pb = part + (static_cast<size_t>(bh) * gridDim.x + blk) *
                         (static_cast<size_t>(g) * rw + (SUMS ? 0 : c + 1));

  for (int i = tid; i < c; i += NT) wa_s[i] = wa[i];
  float dwa[MAX_ACC], dba = 0.f;  // dWa of channels tid + a * NT, and dba
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) dwa[a] = 0.f;

  const int grp0 = SUMS ? blockIdx.z : 0, grp1 = SUMS ? grp0 + 1 : groups;
  for (int grp = grp0; grp < grp1; ++grp) {
    const int j0 = grp * gsz, gb = min(gsz, g - j0);
    const bool first = grp == 0, last = grp == groups - 1;
    __syncthreads();  // the previous group's staging is consumed
    for (int i = tid; i < c * gsz; i += NT) {
      const int k = i / gsz, j = i - k * gsz;
      ws_s[i] = j < gb ? ws[k * g + j0 + j] : 0.f;
    }
    const float* bmg = bmat + (static_cast<size_t>(bh) * g + j0) * c;
    for (int i = tid; i < gsz * c; i += NT)
      bm_s[i] = i < gb * c ? bmg[i] * bscale : 0.f;
    for (int j = tid; j < gsz; j += NT) {
      const bool in = j < gb;
      const size_t sg = static_cast<size_t>(bh) * g + j0 + j;
      const float mj = in ? m[sg] : 0.f, sj = in ? s[sg] : 1.f;
      float u = 0.f, norm = 1.f;
      if (in && !SUMS) {  // t / S, and w / S
        const float* ts = tsum + sg * (c + 2) + c;
        norm = ts[1] > 0.f ? ts[1] : 1.f;
        u = -ts[0] / norm;
      }
      bsh_s[j] = in ? bs[j0 + j] - shift : 0.f;
      m_s[j] = in ? (isfinite(mj) ? mj : 0.f) : INFINITY;
      is_s[j] = 1.f / ((sj > 0.f ? sj : 1.f) * norm);
      u_s[j] = u;
    }
    // acc: dWs^T or dstates entries tid + a * NT of the group ([gb][c]);
    // csum: dbs or t of slice tid, wsum its sum_n w
    float acc[MAX_ACC], csum = 0.f, wsum = 0.f;
#pragma unroll
    for (int a = 0; a < MAX_ACC; ++a) acc[a] = 0.f;
    for (int t0 = 0; t0 < rows_blk; t0 += tile) {
      const int tr = min(tile, rows_blk - t0);
      const size_t row0 = cloud + row_begin + t0;
      __syncthreads();  // the previous tile's buffers are consumed
      for (int i = tid; i < tile * c; i += NT) {
        const bool in = i < tr * c;
        xt[i] = in ? x[row0 * c + i] : 0.f;
        if (GOUT) gt[i] = in ? gout[row0 * c + i] : 0.f;
      }
      __syncthreads();
      for (int r = tid; r < tile; r += NT) {
        const double raw = dot4d(xt + r * c, wa_s, 1, c) + ba0;
        raw_s[r] = static_cast<float>(raw);
        it_s[r] = 1.0 / (base_temp + fmin(fmax(raw, -0.4), 0.4));
      }
      __syncthreads();
      for (int i = tid; i < tile * gsz; i += NT) {
        const int r = i / gsz, j = i - r * gsz;
        float v = 0.f, w2 = 0.f, qv = 0.f;
        if (r < tr && j < gb) {
          const float it = static_cast<float>(it_s[r]);
          const double lgd =
              (dot4d(xt + r * c, ws_s + j, gsz, c) + bsh_s[j]) * it_s[r];
          const float lg = static_cast<float>(lgd);
          const float w = static_cast<float>(exp(lgd - m_s[j])) * is_s[j];
          const float d = static_cast<float>(
              dot4d((GOUT ? gt : xt) + r * c, bm_s + j * c, 1, c) + u_s[j]);
          if (SUMS) {
            v = w;
            w2 = w * d;
          } else {
            const float dl = w * d;
            v = dl * it;
            w2 = w;
            qv = dl * lg;
          }
        }
        val[i] = v;
        wt[i] = w2;
        ql[i] = qv;
      }
      __syncthreads();
      if (!SUMS) {
        for (int r = tid; r < tr; r += NT) {
          float q = 0.f;
          for (int j = 0; j < gb; ++j) q += ql[r * gsz + j];
          if (!first) q += qbuf[row0 + r];
          if (!last) qbuf[row0 + r] = q;
          const float raw = raw_s[r];
          dr_s[r] = last && raw > -0.4f && raw < 0.4f
                        ? -q * static_cast<float>(it_s[r]) : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < tr * c; e += NT) {
          const int r = e / c, k = e - r * c;
          float v = 0.f;
          for (int j = 0; j < gb; ++j)
            v = fmaf(val[r * gsz + j], ws_s[k * gsz + j], v);
          if (APATH)
            for (int j = 0; j < gb; ++j)
              v = fmaf(wt[r * gsz + j], bm_s[j * c + k], v);
          if (last) v = fmaf(wa_s[k], dr_s[r], v);
          float* p = dx + row0 * c + e;
          *p = first ? v : *p + v;
        }
        if (last) {
#pragma unroll
          for (int a = 0; a < MAX_ACC; ++a) {
            const int k = tid + a * NT;
            if (k < c)
              for (int r = 0; r < tr; ++r)
                dwa[a] = fmaf(xt[r * c + k], dr_s[r], dwa[a]);
          }
          if (tid == 0)
            for (int r = 0; r < tr; ++r) dba += dr_s[r];
        }
      }
      if (MODE != BWD_STATES_SUMS) {  // x^T dpre, or w^T g_out
        const float* src = DST ? gt : xt;
#pragma unroll
        for (int a = 0; a < MAX_ACC; ++a) {
          const int e = tid + a * NT;
          if (e < gb * c) {
            const int j = e / c, k = e - j * c;
            for (int r = 0; r < tr; ++r)
              acc[a] = fmaf(val[r * gsz + j], src[r * c + k], acc[a]);
          }
        }
      }
      if (tid < gb) {
        for (int r = 0; r < tr; ++r) {
          csum += SUMS ? wt[r * gsz + tid] : val[r * gsz + tid];
          if (SUMS) wsum += val[r * gsz + tid];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < MAX_ACC; ++a) {
      const int e = tid + a * NT;
      if (e < gb * c) {
        const int j = e / c;
        pb[(j0 + j) * rw + e - j * c] = acc[a];
      }
    }
    if (tid < gb) {
      pb[(j0 + tid) * rw + c] = csum;
      if (SUMS) pb[(j0 + tid) * rw + c + 1] = wsum;
    }
  }
  if (!SUMS) {
#pragma unroll
    for (int a = 0; a < MAX_ACC; ++a) {
      const int k = tid + a * NT;
      if (k < c) pb[static_cast<size_t>(g) * rw + k] = dwa[a];
    }
    if (tid == 0) pb[static_cast<size_t>(g) * rw + c] = dba;
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// C padded to CM in {8, 16, 32}, the fast kernels' widths; 0 for wider heads
// (the generic kernels). Mirrors fast_widths() in the wrapper.
int fast_cm(int c) { return c <= 8 ? 8 : c <= 16 ? 16 : c <= 32 ? 32 : 0; }

// Dynamic shared memory of the fast kernels, in bytes (mirrors
// states_smem() and deslice_smem() in the wrapper); a slice_states block
// holds gp slices, a deslice launch stages gp.
size_t states_smem(int cm, int gp, int per_cloud) {
  int f = WARPS * STAGES * TR * (cm + 4)          // the x ring, Ws, bs, Wa
          + cm * (gp + 1) + gp + cm;
  f = max(f, WARPS * gp * (2 + cm + 8) + gp);      // the warps' merge
  f = max(f, (2 * per_cloud + 2) * gp);            // the cloud's merge
  return sizeof(float) * f;
}

size_t deslice_smem(int cm, int gp) {
  // the x ring, Ws, bs, Wa, states / s, m
  return sizeof(float) * (WARPS * STAGES * TR * (cm + 4) + cm * (gp + 1) +
                          gp * (cm + 4) + 2 * gp + cm);
}

constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory per block

// The generic kernels' groups of slices (mirrors generic_plan() in the
// wrapper): slice_states takes gsz * c accumulators in registers;
// deslice's dtile * c outputs stay in registers and gsz slices' Ws and
// states fit in shared memory beside the x tile.
int generic_states_gsz(int c, int g) {
  return min(g, max(1, NT * MAX_ACC / c));
}

int generic_states_tile(int c, int gsz) {
  const int fixed = c * gsz + gsz + c + 4 * gsz;
  return min(TILE, static_cast<int>((MAX_SMEM / sizeof(float) - fixed) /
                                    (c + gsz + 1)));
}

size_t generic_states_smem(int c, int gsz) {
  const int tile = generic_states_tile(c, gsz);
  return sizeof(float) *
         (c * gsz + gsz + c + tile * c + tile * gsz + tile + 4 * gsz);
}

int generic_dtile(int c) { return min(64, NT * MAX_OUT / c); }

int generic_deslice_gsz(int c, int g) {
  const int dt = generic_dtile(c);
  const int fixed = c + dt * (c + 1);
  return min(g, static_cast<int>((MAX_SMEM / sizeof(float) - fixed) /
                                 (2 * c + 3 + dt)));
}

size_t generic_deslice_smem(int c, int gsz) {
  const int dt = generic_dtile(c);
  return sizeof(float) *
         (2 * c * gsz + 3 * gsz + c + dt * c + dt * gsz + dt);
}

// Opt a kernel into more than 48 KB of dynamic shared memory, once per size.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <int CM, int GP, typename T>
cudaError_t launch_states(const void* x, const float* ws, const float* bs,
                          const float* wa, const float* ba, float* part_m,
                          float* part_s, float* part_acc, int* counter,
                          float* states, bf16* states_lo, float* m, float* s,
                          int bh, int n, int c, int g, int per_cloud,
                          int span, float base_temp, float shift, size_t smem,
                          cudaStream_t st) {
  static size_t allowed = 0;
  cudaError_t err = allow_smem(slice_states_fast<CM, GP, T>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const int groups = (g + GP - 1) / GP;
  slice_states_fast<CM, GP, T>
      <<<dim3(per_cloud, bh, groups), NTF, smem, st>>>(
          static_cast<const T*>(x), ws, bs, wa, ba, part_m, part_s, part_acc,
          counter, states, states_lo, m, s, n, c, g, span, base_temp, shift);
  return cudaGetLastError();
}

template <int CM, int GH, int GPC, typename T>
cudaError_t launch_deslice(const void* x, const float* ws, const float* bs,
                           const float* wa, const float* ba,
                           const void* states, const float* m,
                           const float* s, void* out, float* acc, int bh,
                           int n, int c, int g, int gp, int per_cloud,
                           int span, float base_temp, float shift,
                           size_t smem, cudaStream_t st) {
  static size_t allowed = 0;
  cudaError_t err =
      allow_smem(deslice_fast<CM, GH, GPC, T>, smem, &allowed);
  if (err != cudaSuccess) return err;
  deslice_fast<CM, GH, GPC, T><<<dim3(per_cloud, bh), NTF, smem, st>>>(
      static_cast<const T*>(x), ws, bs, wa, ba,
      static_cast<const T*>(states), m, s, static_cast<T*>(out), acc, n, c,
      g, gp, span, base_temp, shift);
  return cudaGetLastError();
}

template <int CM, int MODE, typename T>
cudaError_t launch_bwd(const void* x, const void* gout, const float* ws,
                       const float* bs, const float* wa, const float* ba,
                       const void* bmat, const float* tsum, const float* m,
                       const float* s, float* part, void* dx, float* dacc,
                       float* qbuf, int bh, int n, int c, int g,
                       int per_cloud, int span, int win0, int windows,
                       int flags, float base_temp, float shift, size_t smem,
                       cudaStream_t stream) {
  if (smem != sizeof(float) * bwd_smem_floats<CM, MODE>())
    return cudaErrorInvalidValue;
  static size_t allowed = 0;
  cudaError_t err =
      allow_smem(slice_bwd_fast<T, CM, MODE>, smem, &allowed);
  if (err != cudaSuccess) return err;
  slice_bwd_fast<T, CM, MODE>
      <<<dim3(per_cloud, bh, windows), NTF, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(gout), ws, bs, wa,
          ba, static_cast<const T*>(bmat), tsum, m, s, part,
          static_cast<T*>(dx), dacc, qbuf, n, c, g, span, win0, flags,
          base_temp, shift);
  return cudaGetLastError();
}

int generic_bwd_gsz(int c, int g) { return generic_states_gsz(c, g); }

int generic_bwd_tile(int c, int gsz) {
  return min(TILE, static_cast<int>((MAX_SMEM / sizeof(float) -
                                     generic_bwd_fixed(c, gsz)) /
                                    generic_bwd_per_row(c, gsz)));
}

size_t generic_bwd_smem(int c, int gsz) {
  return sizeof(float) * (generic_bwd_fixed(c, gsz) +
                          generic_bwd_tile(c, gsz) *
                              generic_bwd_per_row(c, gsz));
}

template <int MODE>
cudaError_t launch_bwd_generic(const float* x, const float* gout,
                               const float* ws, const float* bs,
                               const float* wa, const float* ba,
                               const float* bmat, const float* tsum,
                               const float* m, const float* s, float* part,
                               float* dx, float* qbuf, int bh, int n, int c,
                               int g, int per_cloud, int span,
                               float base_temp, float shift, size_t smem,
                               cudaStream_t stream) {
  const int gsz = generic_bwd_gsz(c, g);
  if (smem != generic_bwd_smem(c, gsz)) return cudaErrorInvalidValue;
  static size_t allowed = 0;
  cudaError_t err = allow_smem(slice_bwd_generic<MODE>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const int groups = bwd_sums(MODE) ? (g + gsz - 1) / gsz : 1;
  slice_bwd_generic<MODE><<<dim3(per_cloud, bh, groups), NT, smem, stream>>>(
      x, gout, ws, bs, wa, ba, bmat, tsum, m, s, part, dx, qbuf, n, c, g, gsz,
      generic_bwd_tile(c, gsz), span, base_temp, shift);
  return cudaGetLastError();
}

}  // namespace

// The fast kernels' template widths (CM, slices held per lane group), and
// deslice's (CM, held slices, staged slices known at compile time or 0).
#define HAET_FAST_CASES(X) \
  X(8, 32) X(8, 64) X(16, 32) X(16, 64) X(32, 32)
#define HAET_DESLICE_CASES(X)                                        \
  X(8, 32, 32) X(8, 64, 64) X(8, 64, 0) X(16, 32, 32) X(16, 64, 64) \
  X(16, 64, 0) X(32, 32, 32) X(32, 32, 64) X(32, 32, 0)

extern "C" {

const char* haet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef HAET_SLICE_TRACE
// Copies g_trace [2][TRACE_CTAS][WARPS][4] (slice_states, deslice) to dst.
int haet_trace_read(unsigned long long* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)));
}
#endif

// The fast slice_states, one launch. Shapes: x [bh, n, c], float32 or,
// with bf16, bfloat16; ws [c, g]; bs [g]; wa [c]; ba [1];
// part_m/part_s [bh, Z, per_cloud, GP];
// part_acc [bh, Z, per_cloud, GP, CM] (GP = held_slices, Z = ceil(g / GP)
// slice groups; unused when per_cloud is 1); counter [bh, Z] int32, zero
// on entry and left zero; states [bh, g, c] float32 and, with bf16, its
// bfloat16 copy states_lo (null otherwise); m/s [bh, g].
// per_cloud * span >= n > (per_cloud - 1) * span; smem is the wrapper's
// count of dynamic shared memory, checked here.
int haet_slice_states(const void* x, const float* ws, const float* bs,
                      const float* wa, const float* ba, float* part_m,
                      float* part_s, float* part_acc, int* counter,
                      float* states, void* states_lo, float* m, float* s,
                      int bh, int n, int c, int g, int per_cloud, int span,
                      float base_temp, float shift, int smem, int bf16_io,
                      void* stream) {
  const int cm = fast_cm(c), gp = held_slices(cm, g);
  if (!cm || static_cast<size_t>(smem) != states_smem(cm, gp, per_cloud) ||
      (bf16_io != 0) != (states_lo != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* lo = static_cast<bf16*>(states_lo);
#define HAET_CASE(CM, GP)                                                   \
  case CM * 100 + GP:                                                       \
    return static_cast<int>(                                                \
        bf16_io ? launch_states<CM, GP, bf16>(                              \
                      x, ws, bs, wa, ba, part_m, part_s, part_acc, counter, \
                      states, lo, m, s, bh, n, c, g, per_cloud, span,       \
                      base_temp, shift, smem, st)                           \
                : launch_states<CM, GP, float>(                             \
                      x, ws, bs, wa, ba, part_m, part_s, part_acc, counter, \
                      states, lo, m, s, bh, n, c, g, per_cloud, span,       \
                      base_temp, shift, smem, st));
  switch (cm * 100 + gp) { HAET_FAST_CASES(HAET_CASE) }
#undef HAET_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fast deslice, one launch, its slices staged in ranges of gp (a
// multiple of held_slices). Shapes: x/out [bh, n, c] and states [bh, g, c],
// float32 or, with bf16, bfloat16; ws [c, g]; bs [g]; wa [c]; ba [1];
// m/s [bh, g]; the cut of N as above. acc [bh, n, c] float32: where the
// ranges' sums meet (out itself for float32; unused, may be null, with one
// range).
int haet_deslice(const void* x, const float* ws, const float* bs,
                 const float* wa, const float* ba, const void* states,
                 const float* m, const float* s, void* out, float* acc,
                 int bh, int n, int c, int g, int gp, int per_cloud, int span,
                 float base_temp, float shift, int smem, int bf16_io,
                 void* stream) {
  const int cm = fast_cm(c), gh = held_slices(cm, g);
  if (!cm || gp < gh || gp % gh ||
      static_cast<size_t>(smem) != deslice_smem(cm, gp) ||
      static_cast<size_t>(smem) > MAX_SMEM || (gp < g && acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gpc = (gp == 32 || gp == 64) && gp >= g ? gp : 0;
#define HAET_CASE(CM, GH, GPC)                                             \
  case CM * 10000 + GH * 100 + GPC:                                        \
    return static_cast<int>(                                               \
        bf16_io ? launch_deslice<CM, GH, GPC, bf16>(                       \
                      x, ws, bs, wa, ba, states, m, s, out, acc, bh, n, c, \
                      g, gp, per_cloud, span, base_temp, shift, smem, st)  \
                : launch_deslice<CM, GH, GPC, float>(                      \
                      x, ws, bs, wa, ba, states, m, s, out, acc, bh, n, c, \
                      g, gp, per_cloud, span, base_temp, shift, smem, st));
  switch (cm * 10000 + gh * 100 + gpc) { HAET_DESLICE_CASES(HAET_CASE) }
#undef HAET_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The generic slice_states. Shapes: x [bh, n, c]; ws [c, g]; bs [g];
// wa [c]; ba [1]; part_m/part_s [bh, n_chunks, g];
// part_acc [bh, n_chunks, g, c]; states [bh, g, c]; m/s [bh, g].
// n_chunks = ceil(n / chunk).
int haet_slice_states_generic_f32(const float* x, const float* ws,
                                  const float* bs, const float* wa,
                                  const float* ba, float* part_m,
                                  float* part_s, float* part_acc,
                                  float* states, float* m, float* s, int bh,
                                  int n, int c, int g, int chunk,
                                  float base_temp, float shift,
                                  void* stream) {
  if (c > MAX_GENERIC_C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n + chunk - 1) / chunk;
  const int gsz = generic_states_gsz(c, g);
  const int tile = generic_states_tile(c, gsz);
  const size_t smem1 = generic_states_smem(c, gsz);
  static size_t allowed1 = 0;
  cudaError_t err = allow_smem(slice_partials_generic, smem1, &allowed1);
  if (err != cudaSuccess) return static_cast<int>(err);
  slice_partials_generic<<<dim3(n_chunks, bh, (g + gsz - 1) / gsz), NT,
                           smem1, st>>>(x, ws, bs, wa, ba, part_m, part_s,
                                        part_acc, n, c, g, gsz, tile, chunk,
                                        base_temp, shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  slice_merge_generic<<<dim3(g, bh), NT, 0, st>>>(part_m, part_s, part_acc,
                                                  states, m, s, n_chunks, c,
                                                  g);
  return static_cast<int>(cudaGetLastError());
}

// The generic deslice. Shapes: x/out [bh, n, c]; ws [c, g]; bs [g];
// wa [c]; ba [1]; states [bh, g, c]; m/s [bh, g].
int haet_deslice_generic_f32(const float* x, const float* ws,
                             const float* bs, const float* wa,
                             const float* ba, const float* states,
                             const float* m, const float* s, float* out,
                             int bh, int n, int c, int g, float base_temp,
                             float shift, void* stream) {
  if (c > MAX_GENERIC_C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dtile = generic_dtile(c), gsz = generic_deslice_gsz(c, g);
  const size_t smem = generic_deslice_smem(c, gsz);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(deslice_generic, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + dtile - 1) / dtile;
  deslice_generic<<<dim3(tiles, bh), NT, smem, st>>>(
      x, ws, bs, wa, ba, states, m, s, out, n, c, g, gsz, dtile, base_temp,
      shift);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the backward kernel slice_bwd_fast in `mode` (0:
// slice_states' chain, 1: deslice's first pass, 2: its chain, 3:
// slice_states' first pass), for C <= 32, over `windows` windows of BW
// slices from window win0 (grid z); flags: 1 first window, 2 last window
// (the chain modes). x, gout, bmat and dx float32 or, with bf16, bfloat16;
// dacc float32, where the chain's windows add up their dx (dx itself for
// float32; may be null with one window). Shapes as at slice_bwd_fast;
// smem is the wrapper's count, checked here.
int haet_slice_bwd(int mode, const void* x, const void* gout,
                   const float* ws, const float* bs, const float* wa,
                   const float* ba, const void* bmat, const float* tsum,
                   const float* m, const float* s, float* part, void* dx,
                   float* dacc, float* qbuf, int bh, int n, int c, int g,
                   int per_cloud, int span, int win0, int windows, int flags,
                   float base_temp, float shift, int smem, int bf16_io,
                   void* stream) {
  const int cm = fast_cm(c);
  if (!cm || windows < 1 || win0 < 0 || (win0 + windows - 1) * BW >= g ||
      ((mode == BWD_STATES || mode == BWD_CHAIN) && flags != 3 &&
       dacc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t str = static_cast<cudaStream_t>(stream);
#define HAET_CASE(MODE, CM)                                                  \
  case MODE * 100 + CM:                                                      \
    return static_cast<int>(                                                 \
        bf16_io ? launch_bwd<CM, MODE, bf16>(                                \
                      x, gout, ws, bs, wa, ba, bmat, tsum, m, s, part, dx,   \
                      dacc, qbuf, bh, n, c, g, per_cloud, span, win0,        \
                      windows, flags, base_temp, shift, smem, str)           \
                : launch_bwd<CM, MODE, float>(                               \
                      x, gout, ws, bs, wa, ba, bmat, tsum, m, s, part, dx,   \
                      dacc, qbuf, bh, n, c, g, per_cloud, span, win0,        \
                      windows, flags, base_temp, shift, smem, str));
#define HAET_CASES(MODE) HAET_CASE(MODE, 8) HAET_CASE(MODE, 16) \
  HAET_CASE(MODE, 32)
  switch (mode * 100 + cm) {
    HAET_CASES(BWD_STATES) HAET_CASES(BWD_SUMS) HAET_CASES(BWD_CHAIN)
    HAET_CASES(BWD_STATES_SUMS)
  }
#undef HAET_CASES
#undef HAET_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch of slice_bwd_generic in `mode` (as above), for 32 < C <=
// MAX_GENERIC_C: grid (per_cloud, bh, the groups of slices for the first
// passes); the chain modes loop over the groups in each block. Shapes as
// at slice_bwd_generic; smem is the wrapper's count, checked here.
int haet_slice_bwd_generic_f32(int mode, const float* x, const float* gout,
                               const float* ws, const float* bs,
                               const float* wa, const float* ba,
                               const float* bmat, const float* tsum,
                               const float* m, const float* s, float* part,
                               float* dx, float* qbuf, int bh, int n, int c,
                               int g, int per_cloud, int span,
                               float base_temp, float shift, int smem,
                               void* stream) {
  if (c < 1 || c > MAX_GENERIC_C || g < 1 || per_cloud < 1 || span < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define HAET_CASE(MODE)                                                  \
  case MODE:                                                             \
    return static_cast<int>(launch_bwd_generic<MODE>(                    \
        x, gout, ws, bs, wa, ba, bmat, tsum, m, s, part, dx, qbuf, bh, n, \
        c, g, per_cloud, span, base_temp, shift, smem, str));
    HAET_CASE(BWD_STATES) HAET_CASE(BWD_SUMS) HAET_CASE(BWD_CHAIN)
    HAET_CASE(BWD_STATES_SUMS)
#undef HAET_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The sum over p < parts, in a fixed order, of part[b][p][j], for
// `batches` rows b of `len` floats, put where `mode` says (SumOut, windows
// of wr slices): the backward's parameter gradients (dWs, dbs, dWa, dba in
// their own layouts) or dstates beside the first pass's full sums: in
// float32 (o2) or bfloat16 (o2h), either may be null.
int haet_sum_partials(const float* part, float* out, float* o2, float* o3,
                      float* o4, void* o2h, int batches, int parts, int len,
                      int mode, int c, int g, int cm, int rw, int bh, int wr,
                      void* stream) {
  if (batches < 1 || parts < 1 || (mode != SUM_PARAMS && mode != SUM_STATES)
      || wr < 1 || len < wr * rw)
    return static_cast<int>(cudaErrorInvalidValue);
  const SumOut o{out, o2, o3, o4, static_cast<bf16*>(o2h), mode, c, g, cm,
                 rw, bh, batches, wr};
  sum_partials<<<dim3((len + 31) / 32, batches), NT, 0,
                 static_cast<cudaStream_t>(stream)>>>(part, parts, len, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
