// Rep-slice tokenizer kernels for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of haet_tpu/ops/pallas/slice_kernels.py:
//   * slice_states (_slice_states_kernel, called from _slice_states_impl_f32)
//   * deslice      (_deslice_kernel, called from _deslice_impl)
// and their custom_vjp backwards there (_slice_states_bwd, _deslice_bwd;
// lax.scan over chunks of N in JAX, not Pallas): slice_bwd_fused and
// slice_bwd_f32 below.
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
// The backward kernels (slice_bwd_fused, slice_bwd_f32, slice_bwd_generic,
// sum_partials) follow the forwards; their own note is there.
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
constexpr int FW = 16;                    // warps per block (float32 bwd)
constexpr int NTW = 32 * FW;              // its threads per block
constexpr int FTR = 16;                   // its rows per warp tile
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

// The backward's passes, per warp of the first TRACE_CTAS blocks, in SM
// cycles, indexed by mode (BWD_STATES .. BWD_STATES_SUMS): BWD_SEGS
// segments, each the sum over the warp's tiles (bwd_trace_names() in
// benchmarks/slice_phases.py names them).
constexpr int BWD_SEGS = 8;
__device__ unsigned long long g_trace_bwd[4][TRACE_CTAS][FW][BWD_SEGS];
// Adds the cycles since the last mark to segment i and moves the mark.
#define HAET_SEG(seg, mark, i)                   \
  do {                                           \
    const long long now_ = clock64();            \
    seg[i] += now_ - mark;                       \
    mark = now_;                                 \
  } while (0)
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
// Backward kernels, for C <= 32: slice_bwd_fused (bf16 I/O, one launch per
// call) and slice_bwd_f32 (float32, one launch per pass); for wider heads
// slice_bwd_generic (four modes); sum_partials (the sums of the per-pass
// kernels' block partials).
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
// C = G = 32) slice_states_bwd reads x and writes dx (67 MB in float32, 20
// us at 3.35 TB/s; 34 MB in bf16) and deslice_bwd reads x and g_out and
// writes dx (101 MB, 30 us); their products, five of 2 N C G FLOP each
// (seven for deslice's two passes), take 17 and 23 us in 3xTF32 on the
// tensor cores (fewer passes in bf16, below). Neither binds. The loop of
// dependent steps does: per tile, the products, the softmax, dpre's trip
// through shared memory and dx's store, one after the other in each warp.
// With Ws's fragments held in registers (236-255 a thread) the SM keeps 8
// warps, too few rows in flight to hide that chain's latency; the
// breakdown of the float32 per-pass kernel this route replaced
// (benchmarks/slice_phases.py; PERF.md) put 42-53 % of a chain warp's
// cycles in its slice-block loop, 15-17 % in dpre's round trip, 10 % in
// dx's store, and 21 of a 72 us chain in the mma.sync passes themselves.
//
// Which kernel a call takes is measured, not chosen (slice_kernels --ab,
// PERF.md): the fused kernel is 1.06-1.40x the per-pass kernels in bf16 at
// every preset's shape, as it drops the passes bf16 operands do not need;
// in float32, where it drops none, its merges and grid barrier cost about
// what the launches they replace do, so float32 takes slice_bwd_f32.
//
// slice_bwd_f32, per pass. One kernel, four modes: BWD_STATES_SUMS and
// BWD_STATES (slice_states' first pass and chain), BWD_SUMS and BWD_CHAIN
// (deslice's). Per point of its design:
//   * 16 warps per SM (FW, four warpgroups), at most 128 registers a
//     thread: twice the rows in flight. No operand table lives in the
//     registers: the products whose M is rows run as wgmma over a
//     warpgroup's 64 rows (each warp's tile of FTR = 16 rows), A from the
//     registers and B from shared memory, so a thread holds one tile's
//     fragments and accumulators alone.
//   * The products on the tensor cores, float32 operands in 3xTF32 (lo*hi,
//     hi*lo, hi*hi: three wgmma m64nNk8 tf32 per k-step; one pass misses
//     the tolerance, chip_smoke.py's tf32_control): Z = x Ws and dw = x G^T
//     (or g_out states^T), N = the window's 32 slices, and dx = dpre Ws^T +
//     w G^, N = CM channels. B is staged once per window, split into hi and
//     lo tables in wgmma's no-swizzle K-major layout (8 x 8 core matrices),
//     in the order that the lanes' A fragments take: x's channels
//     permuted as in the forwards (lane tig reads channels Q * tig .. + Q -
//     1), and dpre's slices as the accumulator fragment holds them. A
//     k-step's A registers are released after its wait, so one k-block's
//     fragments are in flight at a time.
//   * dpre stays in the registers for dx: the accumulator fragment of the
//     logits (rows gid, gid + 8; slices 2 tig, 2 tig + 1 of each block of
//     8) is, entry for entry, the A fragment of dx = dpre Ws^T with k the
//     slices, so softmax, dpre and dx never leave the registers, and dx
//     goes from its accumulators straight to device memory, two channels a
//     store, after the draw term (no round trip through the ring, no tile
//     store). dWs^T = dpre^T x (and dstates = w^T g_out) contract over rows
//     with M = the window's 32 slices, below wgmma's 64: they stay on
//     mma.sync m16n8k8 (3xTF32), dpre (w) through the warp's 16-row buffer
//     as A, x (g_out) from the ring as B.
//   * Windows of BW = 32 slices. At CM <= 16 and G > 32 (the Darcy
//     preset's G 64) slice_states' first pass and both chains sweep SW = 2
//     windows per read of their rows (HAET_BWD_F32_CASES): x is read once
//     a pass, and a chain keeps both windows' dx and sum_g dlogit * logit
//     in the registers, one launch where it took two. Not in deslice's
//     first pass, nor at CM 32 (the NS preset): their two windows'
//     accumulators spill past 128 registers, and those sweeps measured
//     slower (PERF.md); a first pass then takes its windows as grid z, and
//     a chain launches once per window, each adding its dx and sum_g
//     dlogit * logit to the earlier launches' (in dx and a [B*H, N]
//     scratch) and the last applying draw.
//   * 1 / tau per row in the forwards' order of summation (row16_raw_tau):
//     at tau 0.1 its rounding reaches every logit of the row (|logit| ~100),
//     and summed otherwise it put slice_states_bwd's d b_slice 1.2e-3 of
//     its max from float64 at chip_smoke.py's low-temperature edge. With
//     it, each k-block's three passes go into one accumulator in one
//     round.
//   * What bounds it now: ptxas serializes its wgmma (C7520, a
//     compiler-inserted warpgroup arrive in a divergent path), so each
//     product waits for the one before it; it runs at 22-26 % of its
//     bound at the car's training batch (PERF.md).
//   * Merges in a fixed order, no float atomics: each lane sums over its
//     rows, a warp's lanes by shuffles in a fixed pattern, a block's warps
//     in warp order into its partial per window; sum_partials adds the
//     blocks' partials in block order (each of its 8 warps a contiguous
//     range, then the warps in order), after the first pass per cloud and
//     window and after the chain over every block of every cloud. Two calls
//     agree bit for bit. A call is four launches at G <= 32 and at the
//     Darcy preset's G 64, five at the NS preset's.
//
// slice_bwd_fused, per point of its design:
//   * One launch per call, at any G. The grid is persistent: at most as
//     many blocks as the card holds at once (the wrapper sizes it from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs), each
//     taking `units` = (cloud, range of span rows) in turn. The first pass
//     runs over every unit and window of 32 slices and writes each unit's
//     partial sums (t, sum_n w, and for deslice dstates); the last unit of
//     each cloud to finish (a counter and __threadfence, as
//     slice_states_fast merges) adds its cloud's in unit order; each block
//     stages its first chain window's tables; a grid-wide barrier follows
//     (grid_sync: an arrival and a departure counter that the last block to
//     leave resets, so a CUDA graph's replays find them at zero); then the
//     chain runs over the same rows. The launch is cooperative: the runtime
//     refuses it unless every block can be resident at once, so no block
//     waits on one that cannot run, whatever else holds the card, and
//     graphs capture it as such. Windows past the first add their dx and
//     sum_g dlogit * logit to the earlier ones' through device memory
//     (dacc, qbuf: the same warp's own rows, in L2), as no launch separates
//     them. No sum_partials launch: each unit's chain partials (dWs^T, dbs
//     per window; dWa, dba) go to device memory, the last unit of each
//     cloud adds its cloud's in unit order, and the last cloud the clouds'
//     in cloud order.
//   * The passes each product needs. x, g_out and the G-side matrix (the
//     states, or dL/dstates) are bf16, exact in TF32, so their 3xTF32 low
//     part is zero and their products skip that pass (mma_p): the chain's
//     logits take two passes, dw one, dx's Ws dpre^T three, G^ w^T two and
//     dpre^T x two (10 of 15). G^'s 1 / (1 + 1e-5) moves to the other
//     operand (dw is scaled after its product, w before G^'s) so that the
//     table stays exact. Float32 operands (Ws, the weights, dpre) keep
//     3xTF32.
//   * x and g_out stay bf16 in the warps' rings (no widening in shared
//     memory: half the bytes), and the fragments of an exact operand are
//     its bits shifted, not split; the fragment tables of an exact operand
//     hold its high parts alone (half the shared-memory reads). It keeps
//     the per-tile loop below at 8 warps per SM (177-247 registers); the
//     float32 route's wgmma loop has not been carried over.
//   * The second read: the chain takes each warp's tiles in reverse order,
//     so that it first re-reads the rows the first pass read last, while
//     they are in L2 (50 MB: x and g_out of the car's training batch in
//     bf16, 34 MB, fit whole). Holding the rows in shared memory instead
//     would buy nothing that shows: the breakdown put the ring waits at 6 %
//     of a warp's cycles.
//   * Per tile: each warp streams its tiles of TR rows (and g_out) through
//     a cp.async ring and handles them 16 rows at a time in the row layout
//     of deslice_fast: Z = x Ws and the dw product are accumulator
//     fragments (rows gid, gid + 8; slices 2 tig, 2 tig + 1 of each block
//     of 8), and so are w, dlogit and dpre, elementwise. dx^T = Ws dpre^T
//     (+ G^T w^T): the accumulator fragment of dpre is, entry for entry,
//     the B fragment of that product (k = tig is slice 2 tig), so dx stays
//     in registers until it goes to device memory through the warp's
//     buffer, 16 rows at a time. dWs^T = dpre^T x (and dstates = w^T
//     g_out) contract over rows: dpre (w) goes through the warp's buffer
//     and back as A fragments; x is the B fragment, read from the ring. Ws
//     and the G-side matrix are staged once per window, in fragment order.
//   * Fixed merge orders and no float atomics: two calls agree bit for
//     bit, and the counters are back at zero after every call.
//
// The weights' normalisation: the first pass also sums S = sum_n w. The
// residuals (m, s) come from the forward's logits, whose rounding differs
// from this recomputation's, so S = 1 + O(1e-6); at temperatures near 0.1
// and logits near 100 that mismatch, carried through the coupling t, cost
// deslice_bwd ~1e-4 of max |dx| and slice_states_bwd (with t in closed
// form, from the forward's states) ~5e-3 of max |d b_slice| against
// float64. The chains therefore use w / S and t / S: the exact softmax of
// their own logits; so does deslice's dstates, on every route, so that
// each route computes one function, the gradient of that softmax
// (sum_partials and the fused kernel's merge_first_pass divide it by S,
// summed in the order of S's own sum: slice_bwd_f32's logits, on wgmma,
// round otherwise than the forward's mma.sync, and at the low-temperature
// edge of chip_smoke.py the unnormalised dstates was 1.0e-4 of its max
// from float64). Rows past N are masked to zero dpre, w and draw, and
// zero features in the row-contracted products; a slice past G gets m =
// +inf (w = 0).
// ---------------------------------------------------------------------------

constexpr int BW = 32;                      // slices per window
constexpr int BUF_STRIDE = BW + 4;          // row stride of the dpre buffer
constexpr int BWD_STATES = 0, BWD_SUMS = 1, BWD_CHAIN = 2;
constexpr int BWD_STATES_SUMS = 3;

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

// Whether every value of T is exact in TF32 (bf16: 8 significant bits), so
// that its low part in 3xTF32 is zero.
template <typename T>
__host__ __device__ constexpr bool tf32_exact() {
  return !std::is_same_v<T, float>;
}

// Words per lane of a fragment table entry: a B fragment (b0, b1) as hi, lo
// pairs, or its hi parts alone for an exact operand; an A fragment (a0 ..
// a3) likewise.
__host__ __device__ constexpr int tab_b_lane(bool exact) {
  return exact ? 2 : 4;
}

__host__ __device__ constexpr int tab_a_lane(bool exact) {
  return exact ? 4 : 8;
}

// Row stride, in elements of T, of a backward ring slot: C padded to CM,
// then 16 bytes, so that rows stay 16-byte aligned.
template <typename T, int CM>
__host__ __device__ constexpr int bwd_cs() {
  return CM + 16 / static_cast<int>(sizeof(T));
}

// Bytes of one ring (all warps' slots) in T.
template <typename T, int CM>
__host__ __device__ constexpr int bwd_ring_bytes() {
  return WARPS * STAGES * TR * bwd_cs<T, CM>() * static_cast<int>(sizeof(T));
}

// Floats of one warp's share of a block merge (the largest, a chain's):
// [BW][CM + 2] rows of the first pass or [BW][CM + 1] of the chain and its
// dWa, dba.
template <int CM>
__host__ __device__ constexpr int bwd_merge_floats() {
  return BW * (CM + 2) + CM + 1;
}

// Words of the fragment tables of one window: Ws as B (the logits) and the
// G-side matrix as B (dw); Ws as A (dx) and, for slice_states, G^ as A.
template <typename T, int CM, bool DESLICE>
__host__ __device__ constexpr int bwd_table_words() {
  constexpr bool EX = tf32_exact<T>();
  return (CM / 8) * (BW / 8) * 32 * (tab_b_lane(false) + tab_b_lane(EX)) +
         bwd_mc<CM>() * (BW / 8) * 32 *
             (tab_a_lane(false) + (DESLICE ? 0 : tab_a_lane(EX)));
}

// Dynamic shared memory of slice_bwd_fused in bytes (mirrors bwd_smem() in
// the wrapper): the x ring (and the g_out ring), where the block merges also
// go; the fragment tables; bs - shift, m, 1 / (s S), u of the window; Wa;
// the warps' dpre buffers [16][BUF_STRIDE] and draw [16].
template <typename T, int CM, bool DESLICE>
__host__ __device__ constexpr int bwd_fused_smem() {
  constexpr int rings = (DESLICE ? 2 : 1) * bwd_ring_bytes<T, CM>();
  constexpr int merge = 4 * WARPS * bwd_merge_floats<CM>();
  return (rings > merge ? rings : merge) +
         4 * (bwd_table_words<T, CM, DESLICE>() + 4 * BW + CM +
              WARPS * 16 * (BUF_STRIDE + 1));
}

// One fused call's tensors and sizes. x, g_out [bh, n, c], the G-side
// matrix bmat [bh, g, c] (dL/dstates, or the states), dstates and dx are T;
// the rest float32. part1 [windows][units][BW][CM + 2] (per unit and
// window: dstates, t, sum_n w per slice) and tsum [bh][windows][BW][2]
// (their merge: t and sum_n w); part2 [units][pw2] and cpart [bh][pw2],
// pw2 = windows * BW * (CM + 1) + CM + 1 (dWs^T and dbs per window, then
// dWa, dba); dacc [bh, n, c] float32 (the windows' dx, past one window)
// and qbuf [bh, n]; bar [3 + 2 bh] int, zero on entry
// and on exit. units = bh * per_cloud; unit u is cloud u / per_cloud, rows
// [(u % per_cloud) * span, + span).
struct BwdArgs {
  const void* x;
  const void* gout;
  const float *ws, *bs, *wa, *ba;
  const void* bmat;
  const float *m, *s;
  float *part1, *tsum, *part2, *cpart;
  void* dstates;
  void* dx;
  float *dacc, *qbuf;
  float *dws, *dbs, *dwa, *dba;
  int* bar;
  int bh, n, c, g, per_cloud, span;
  float base_temp, shift;
};

// d += a b with the passes the operands need: lo*hi where a has a low part,
// hi*lo where b has one, hi*hi; the cross terms in d[0], hi*hi in d[1] (two
// chains over k-blocks).
template <bool ALO, bool BLO>
__device__ __forceinline__ void mma_p2(float (&d)[2][4], const Split (&a)[4],
                                       const Split (&b)[2]) {
  if constexpr (ALO)
    mma(d[0], a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  if constexpr (BLO)
    mma(d[0], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(d[1], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// The same into one accumulator.
template <bool ALO, bool BLO>
__device__ __forceinline__ void mma_p(float (&d)[4], const Split (&a)[4],
                                      const Split (&b)[2]) {
  if constexpr (ALO)
    mma(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  if constexpr (BLO)
    mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// An operand value as a tensor-core operand: split (float32), or its bits
// with no low part (a widened bf16, exact in TF32).
template <bool EXACT>
__device__ __forceinline__ Split operand(float v) {
  if constexpr (EXACT) return {__float_as_uint(v), 0u};
  else return split(v);
}

__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float ldv(const float* p) { return *p; }
__device__ __forceinline__ float ldv(const bf16* p) {
  return __bfloat162float(*p);
}

// rows [row0, row0 + rows) of one cloud (row stride c) into a ring slot of
// T, rows bwd_cs apart: 16-byte cp.async chunks with vec, else plain
// copies. Columns c..CM-1 are left alone. Out of
// line: its inlined copies (x and g_out, each of its paths) spread the
// tile loop's code (deslice_bwd was 8 % slower with it inlined, H100).
template <typename T, int CM>
__device__ __noinline__ void load_rows(T* slot, const T* xb, int row0,
                                          int rows, int c, bool vec,
                                          int lane) {
  constexpr int CS = bwd_cs<T, CM>(), V = 16 / static_cast<int>(sizeof(T));
  const T* src = xb + static_cast<size_t>(row0) * c;
  if (vec && c == CM) {  // the row width known at compile time
    constexpr int Q = CM / V;
    for (int i = lane; i < rows * Q; i += 32) {
      const int r = i / Q, k = i - r * Q;
      cp16(reinterpret_cast<float*>(slot + r * CS + V * k),
           reinterpret_cast<const float*>(src + r * CM + V * k));
    }
  } else if (vec) {
    const int q = c / V;
    for (int i = lane; i < rows * q; i += 32) {
      const int r = i / q, k = i - r * q;
      cp16(reinterpret_cast<float*>(slot + r * CS + V * k),
           reinterpret_cast<const float*>(src + r * c + V * k));
    }
  } else {
    for (int i = lane; i < rows * c; i += 32) {
      const int r = i / c, k = i - r * c;
      slot[r * CS + k] = src[i];
    }
  }
}

// The Q = CM / 4 channels [Q * tig, Q * tig + Q) of one bf16 ring row,
// widened to float32.
template <int CM>
__device__ __forceinline__ void quarter(float (&v)[CM / 4], const bf16* p) {
  constexpr int Q = CM / 4;
  unsigned w[Q / 2];
  if constexpr (Q == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  } else if constexpr (Q == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x, w[1] = t.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
#pragma unroll
  for (int i = 0; i < Q / 2; ++i) {
    v[2 * i] = bf_lo(w[i]);
    v[2 * i + 1] = bf_hi(w[i]);
  }
}

// 1 / tau and the raw Ada-Temp value x . Wa + ba of the bf16 ring row
// `lane` of slice_bwd_fused (two FMA chains, channels k, k + 2 in one and
// k + 1, k + 3 in the other).
template <int CM>
__device__ __forceinline__ void row_raw_tau(const bf16* slot,
                                            const float* wa_s, float ba,
                                            float base_temp, int lane,
                                            float& raw, float& it) {
  const bf16* xr = slot + lane * bwd_cs<bf16, CM>();
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int k = 0; k < CM; k += 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(xr + k);
    const float4 w0 = *reinterpret_cast<const float4*>(wa_s + k);
    const float4 w1 = *reinterpret_cast<const float4*>(wa_s + k + 4);
    d0 = fmaf(bf_lo(t.x), w0.x, d0);
    d1 = fmaf(bf_hi(t.x), w0.y, d1);
    d0 = fmaf(bf_lo(t.y), w0.z, d0);
    d1 = fmaf(bf_hi(t.y), w0.w, d1);
    d0 = fmaf(bf_lo(t.z), w1.x, d0);
    d1 = fmaf(bf_hi(t.z), w1.y, d1);
    d0 = fmaf(bf_lo(t.w), w1.z, d0);
    d1 = fmaf(bf_hi(t.w), w1.w, d1);
  }
  raw = d0 + d1 + ba;
  it = 1.f / (base_temp + fminf(fmaxf(raw, -0.4f), 0.4f));
}

// A B fragment (b0, b1) of a table entry, with or without its low parts.
template <bool EXACT>
__device__ __forceinline__ void table_b(Split (&b)[2], const unsigned* t,
                                        int e) {
  if constexpr (EXACT) {
    const uint2 v = reinterpret_cast<const uint2*>(t)[e];
    b[0] = {v.x, 0u};
    b[1] = {v.y, 0u};
  } else {
    const uint4 v = reinterpret_cast<const uint4*>(t)[e];
    b[0] = {v.x, v.y};
    b[1] = {v.z, v.w};
  }
}

// An A fragment (a0 .. a3) of a table entry, with or without its low parts.
template <bool EXACT>
__device__ __forceinline__ void table_a(Split (&a)[4], const unsigned* t,
                                        int e) {
  if constexpr (EXACT) {
    const uint4 v = reinterpret_cast<const uint4*>(t)[e];
    a[0] = {v.x, 0u};
    a[1] = {v.y, 0u};
    a[2] = {v.z, 0u};
    a[3] = {v.w, 0u};
  } else {
    const uint4 v0 = reinterpret_cast<const uint4*>(t)[2 * e];
    const uint4 v1 = reinterpret_cast<const uint4*>(t)[2 * e + 1];
    a[0] = {v0.x, v0.y};
    a[1] = {v0.z, v0.w};
    a[2] = {v1.x, v1.y};
    a[3] = {v1.z, v1.w};
  }
}

// Stores values into a table entry: hi, lo pairs, or the hi parts alone.
template <bool EXACT, int N>
__device__ __forceinline__ void table_put(unsigned* t, int e,
                                          const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (EXACT) {
      t[N * e + i] = __float_as_uint(v[i]);
    } else {
      const Split p = split(v[i]);
      t[2 * (N * e + i)] = p.hi;
      t[2 * (N * e + i) + 1] = p.lo;
    }
  }
}

// The first c columns (CM at most) of `rows` rows of src (row stride LD
// floats) out to device memory at dst (row stride c): plus acc (float32,
// the earlier windows' sums) unless first; into acc unless last, else into
// out (bf16).
// store_rows element by element (c not a multiple of the 16-byte chunk, or
// a pointer unaligned): out of line, as it is rare.
template <int LD, typename T>
__device__ __noinline__ void store_scalars(const float* src, float* a, T* o,
                                           int rows, int c, bool first,
                                           bool last, int lane) {
  for (int i = lane; i < rows * c; i += 32) {
    const int r = i / c, k = i - r * c;
    float v = src[r * LD + k];
    if (!first) v += a[i];
    if (last) o[i] = from_f32<T>(v);
    else a[i] = v;
  }
}

template <int LD, int CM, typename T>
__device__ __forceinline__ void store_rows(const float* src, float* acc,
                                           T* out, size_t off, int rows,
                                           int c, bool vec, bool first,
                                           bool last, int lane) {
  constexpr int V = 8;
  float* a = acc + off;
  T* o = out + off;
  auto chunks = [&](const int q) {  // q chunks of V per row
    for (int i = lane; i < rows * q; i += 32) {
      const int r = i / q, k = V * (i - r * q), e = r * c + k;
      float v[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 t = *reinterpret_cast<const float4*>(src + r * LD + k + j);
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
      } else {
        __nv_bfloat162 h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        *reinterpret_cast<uint4*>(o + e) = *reinterpret_cast<const uint4*>(h);
      }
    }
  };
  if (vec) chunks(c / V);
  else store_scalars<LD, T>(src, a, o, rows, c, first, last, lane);
}

// The shared memory of slice_bwd_fused, carved as bwd_fused_smem counts it.
template <typename T, int CM, bool DESLICE>
struct BwdSmem {
  static constexpr bool EX = tf32_exact<T>();
  static constexpr int KB = CM / 8, NB = BW / 8, MC = bwd_mc<CM>();
  T* ring_x;        // [WARPS][STAGES][TR][bwd_cs] (the block merges, later)
  T* ring_g;        // the same for g_out (deslice)
  unsigned* tzb;    // Ws as B   [KB][NB][32] x tab_b_lane(false)
  unsigned* tdb;    // G-side as B [KB][NB][32] x tab_b_lane(EX)
  unsigned* twa;    // Ws as A   [MC][NB][32] x tab_a_lane(false)
  unsigned* tba;    // G^ as A   [MC][NB][32] x tab_a_lane(EX) (slice_states)
  float *bsh, *msl, *isl, *usl, *wa;  // [BW] x 4, [CM]
  float *buf, *drw;  // [WARPS][16][BUF_STRIDE], [WARPS][16]
  float* merge;      // [WARPS][bwd_merge_floats] over the rings

  __device__ explicit BwdSmem(unsigned char* sm) {
    constexpr int RB = bwd_ring_bytes<T, CM>();
    constexpr int RINGS = (DESLICE ? 2 : 1) * RB;
    constexpr int MERGE = 4 * WARPS * bwd_merge_floats<CM>();
    ring_x = reinterpret_cast<T*>(sm);
    ring_g = reinterpret_cast<T*>(sm + RB);
    merge = reinterpret_cast<float*>(sm);
    tzb = reinterpret_cast<unsigned*>(sm + (RINGS > MERGE ? RINGS : MERGE));
    tdb = tzb + KB * NB * 32 * tab_b_lane(false);
    twa = tdb + KB * NB * 32 * tab_b_lane(EX);
    tba = twa + MC * NB * 32 * tab_a_lane(false);
    bsh = reinterpret_cast<float*>(
        tba + (DESLICE ? 0 : MC * NB * 32 * tab_a_lane(EX)));
    msl = bsh + BW;
    isl = msl + BW;
    usl = isl + BW;
    wa = usl + BW;
    buf = wa + CM;
    drw = buf + WARPS * 16 * BUF_STRIDE;
  }
};

// Zeroes the padding columns c..CM-1 of every ring row (the loads never
// write them, and the block merges overwrite the rings).
template <typename T, int CM, bool DESLICE>
__device__ __noinline__ void zero_columns(int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem<T, CM, DESLICE> L(smem);
  constexpr int CS = bwd_cs<T, CM>();
  constexpr int ROWS = (DESLICE ? 2 : 1) * WARPS * STAGES * TR;
  for (int i = threadIdx.x; i < ROWS * (CM - c); i += NTF) {
    const int r = i / (CM - c);
    L.ring_x[r * CS + c + i - r * (CM - c)] = from_f32<T>(0.f);
  }
}

template <typename T, int CM, bool DESLICE>
__device__ __forceinline__ void zero_padding(int c) {
  if (c < CM) zero_columns<T, CM, DESLICE>(c);
}

// The tables of one window of one cloud for a pass of MODE: Ws and the
// G-side matrix in fragment order (as B; for a chain also as A); per slice
// bs - shift, finite m (+inf past G: w = 0) and the residual s (guarded),
// which the pass turns into 1 / (s S); Wa. A chain's first tables are
// staged before the grid barrier, while no tile load is in flight to queue
// their reads behind.
template <typename T, int CM, bool DESLICE, int MODE>
__device__ __forceinline__ void stage_tables(const BwdArgs& a, int cloud,
                                             int win) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem<T, CM, DESLICE> L(smem);
  constexpr bool CHAIN = !bwd_sums(MODE), APATH = MODE == BWD_STATES;
  constexpr bool EX = tf32_exact<T>();
  constexpr int KB = CM / 8, NB = BW / 8, MC = bwd_mc<CM>(), Q = CM / 4;
  const int tid = threadIdx.x, c = a.c, g = a.g;
  const int w0 = win * BW, gw = min(BW, g - w0);
  const T* bmw = static_cast<const T*>(a.bmat) +
                 (static_cast<size_t>(cloud) * g + w0) * c;
  auto wsv = [&](int k, int sl) {
    return k < c && sl < gw ? a.ws[k * g + w0 + sl] : 0.f;
  };
  auto bmv = [&](int sl, int k) {
    return k < c && sl < gw ? ldv(bmw + sl * c + k) : 0.f;
  };
  for (int e = tid; e < KB * NB * 32; e += NTF) {
    // b0, b1 of k-block kb, slice block nb: channels Q*tig + 2*kb (+ 1),
    // slice nb*8 + gid
    const int ln = e & 31, kb = (e >> 5) / NB, nb = (e >> 5) - kb * NB;
    const int k0 = Q * (ln & 3) + 2 * kb, sl = nb * 8 + (ln >> 2);
    const float z[2] = {wsv(k0, sl), wsv(k0 + 1, sl)};
    const float d[2] = {bmv(sl, k0), bmv(sl, k0 + 1)};
    table_put<false>(L.tzb, e, z);
    table_put<EX>(L.tdb, e, d);
  }
  if constexpr (CHAIN) {
    for (int e = tid; e < MC * NB * 32; e += NTF) {
      // a0 .. a3 of channel block mc, slice block nb: channels mc*16 + gid
      // (+ 8), slices nb*8 + 2*tig (+ 1)
      const int ln = e & 31, mc = (e >> 5) / NB, nb = (e >> 5) - mc * NB;
      const int ch = mc * 16 + (ln >> 2), sl = nb * 8 + 2 * (ln & 3);
      const float w4[4] = {wsv(ch, sl), wsv(ch + 8, sl), wsv(ch, sl + 1),
                           wsv(ch + 8, sl + 1)};
      table_put<false>(L.twa, e, w4);
      if constexpr (APATH) {
        const float b4[4] = {bmv(sl, ch), bmv(sl, ch + 8), bmv(sl + 1, ch),
                             bmv(sl + 1, ch + 8)};
        table_put<EX>(L.tba, e, b4);
      }
    }
  }
  if (tid < BW) {
    const bool in = tid < gw;
    const size_t sg = static_cast<size_t>(cloud) * g + w0 + tid;
    const float mj = in ? a.m[sg] : 0.f, sj = in ? a.s[sg] : 1.f;
    L.bsh[tid] = in ? a.bs[w0 + tid] - a.shift : 0.f;
    L.msl[tid] = in ? (isfinite(mj) ? mj : 0.f) : INFINITY;
    L.isl[tid] = sj > 0.f ? sj : 1.f;
  }
  if (tid < CM) L.wa[tid] = tid < c ? a.wa[tid] : 0.f;
}

#ifdef HAET_SLICE_TRACE
#define HAET_TRACE_PARAMS , long long (&sg_)[BWD_SEGS], long long &mk_
#define HAET_TRACE_ARGS , sg_, mk_
#else
#define HAET_TRACE_PARAMS
#define HAET_TRACE_ARGS
#endif

// One pass of MODE over one unit's rows for window `win`: stage the
// window's tables (unless `staged`: a chain's first, before the barrier;
// a chain reads its cloud's merged first-pass sums for u and 1 / (s S)),
// run the warps' tiles (the chain in reverse order),
// and merge the warps' partial sums in warp order into part1 (first pass) or
// part2 (chain; at the last window also dWa, dba).
template <typename T, int CM, bool DESLICE, int MODE>
__device__ __forceinline__ void bwd_rows(const BwdArgs& a, int unit, int win,
                                         int windows,
                                         bool staged HAET_TRACE_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem<T, CM, DESLICE> L(smem);
  constexpr bool CHAIN = !bwd_sums(MODE);      // the chain to x and the
  constexpr bool APATH = MODE == BWD_STATES;   // weights; dx += w G^
  constexpr bool GOUT = bwd_gout(MODE);        // a g_out stream
  constexpr bool DST = MODE == BWD_SUMS;       // dstates = w^T g_out
  constexpr bool EX = tf32_exact<T>();
  constexpr int KB = CM / 8, NB = BW / 8, NC = CM / 8, MB = BW / 16;
  constexpr int MC = bwd_mc<CM>(), Q = CM / 4, CS = bwd_cs<T, CM>();
  constexpr int RW = CM + (CHAIN ? 1 : 2);     // row of a partial
  constexpr int PM = bwd_merge_floats<CM>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n = a.n, c = a.c, g = a.g, units = a.bh * a.per_cloud;
  const int cloud = unit / a.per_cloud, part = unit - cloud * a.per_cloud;
  const int w0 = win * BW, gw = min(BW, g - w0);
  const bool first = win == 0, last = win == windows - 1;
  const int row_begin = part * a.span;
  const int rows_blk = min(a.span, n - row_begin);
  const size_t cl = static_cast<size_t>(cloud) * n * c;
  const T* xb = static_cast<const T*>(a.x) + cl;
  const T* gb = GOUT ? static_cast<const T*>(a.gout) + cl : nullptr;
  T* dx = static_cast<T*>(a.dx);
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(a.x) |
      (GOUT ? reinterpret_cast<uintptr_t>(a.gout) : 0) |
      (CHAIN ? reinterpret_cast<uintptr_t>(a.dx) |
                   reinterpret_cast<uintptr_t>(a.dacc) : 0);
  const bool vec = vec_ok<T>(c, ptrs);

  const int tiles = (rows_blk + TR - 1) / TR;
  const int my_tiles = tiles > warp ? (tiles - warp + WARPS - 1) / WARPS : 0;
  T* my_x = L.ring_x + warp * STAGES * TR * CS;
  T* my_g = L.ring_g + warp * STAGES * TR * CS;
  float* buf = L.buf + warp * 16 * BUF_STRIDE;
  float* drw = L.drw + warp * 16;
  // the warp's tile jt (the chain takes them last first)
  auto tile_row = [&](int jt) {
    const int j = CHAIN ? my_tiles - 1 - jt : jt;
    return row_begin + (warp + j * WARPS) * TR;
  };
  auto load = [&](int jt) {  // tile jt of this warp into its ring slots
    const int r0 = tile_row(jt), rows = min(TR, n - r0);
    load_rows<T, CM>(my_x + (jt % STAGES) * TR * CS, xb, r0, rows, c, vec,
                     lane);
    if constexpr (GOUT)
      load_rows<T, CM>(my_g + (jt % STAGES) * TR * CS, gb, r0, rows, c, vec,
                       lane);
  };

  const float bscale = DESLICE ? 1.f : 1.f / NORM;
  const float ba0 = a.ba[0], base_temp = a.base_temp;
  if (!staged) stage_tables<T, CM, DESLICE, MODE>(a, cloud, win);
  if (tid < BW) {  // 1 / (s S) and u = -t / S (S = 1, t = 0 in a first pass)
    float u = 0.f, norm = 1.f;
    if (CHAIN && tid < gw) {  // merged before the grid barrier
      const float* ts = a.tsum + ((static_cast<size_t>(cloud) * windows +
                                   win) * BW + tid) * 2;
      const float sw = __ldcg(ts + 1);
      norm = sw > 0.f ? sw : 1.f;
      u = -__ldcg(ts) / norm;
    }
    L.isl[tid] = 1.f / (L.isl[tid] * norm);
    L.usl[tid] = u;
  }
  // the first tiles' loads, after the tables' and sums' reads (which would
  // otherwise queue behind them), in flight while the block syncs
  int jl = 0;  // the next tile to load
  auto load_next = [&] {
    if (jl < my_tiles) load(jl);
    cp_commit();
    ++jl;
  };
  for (int j = 0; j < STAGES - 1; ++j) load_next();
  __syncthreads();

  // acc: dWs^T (chain) or dstates (first pass), slices mb*16 + gid (+ 8),
  // channels nc*8 + 2*tig (+ 1); colsum: dbs or t of the lane's slices
  // nb*8 + 2*tig (+ 1), over its rows, and wsum their sum_n w (first pass);
  // dWa of channel `lane` and dba (the chain's last window).
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

  HAET_TRACE(HAET_SEG(sg_, mk_, 0);)
  for (int jt = 0; jt < my_tiles; ++jt) {
    __syncwarp();  // every lane is done with the slots refilled below
    load_next();   // tile jt + STAGES - 1
    cp_wait<STAGES - 1>();
    __syncwarp();
    HAET_TRACE(HAET_SEG(sg_, mk_, 1);)
    const T* slot = my_x + (jt % STAGES) * TR * CS;
    const T* gslot = GOUT ? my_g + (jt % STAGES) * TR * CS : slot;
    const int row0 = tile_row(jt);
    const int rows = min(TR, n - row0);
    float raw_l, it_l;
    row_raw_tau<CM>(slot, L.wa, ba0, base_temp, lane, raw_l, it_l);
    for (int r16 = 0; r16 < rows; r16 += 16) {
      // A fragments of rows r16 + gid (a0, a2) and r16 + gid + 8 (a1, a3):
      // x, and g_out for the dw product
      Split xf[KB][4], gf[KB][4];
      {
        float q0[Q], q1[Q];
        const T* x0 = slot + (r16 + gid) * CS + Q * tig;
        quarter<CM>(q0, x0);
        quarter<CM>(q1, x0 + 8 * CS);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          xf[kb][0] = operand<EX>(q0[2 * kb]);
          xf[kb][1] = operand<EX>(q1[2 * kb]);
          xf[kb][2] = operand<EX>(q0[2 * kb + 1]);
          xf[kb][3] = operand<EX>(q1[2 * kb + 1]);
        }
        if constexpr (GOUT) {
          const T* g0 = gslot + (r16 + gid) * CS + Q * tig;
          quarter<CM>(q0, g0);
          quarter<CM>(q1, g0 + 8 * CS);
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            gf[kb][0] = operand<EX>(q0[2 * kb]);
            gf[kb][1] = operand<EX>(q1[2 * kb]);
            gf[kb][2] = operand<EX>(q0[2 * kb + 1]);
            gf[kb][3] = operand<EX>(q1[2 * kb + 1]);
          }
        }
      }
      HAET_TRACE(HAET_SEG(sg_, mk_, 2);)
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
        // Z (bs - shift rides in the hi*hi accumulator) and dw
        float zp[2][4] = {{0.f, 0.f, 0.f, 0.f},
                          {L.bsh[c0], L.bsh[c0 + 1], L.bsh[c0],
                           L.bsh[c0 + 1]}};
        float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const int e = (kb * NB + nb) * 32 + lane;
          Split b[2];
          table_b<false>(b, L.tzb, e);
          mma_p2<!EX, true>(zp, xf[kb], b);
          table_b<EX>(b, L.tdb, e);
          if constexpr (GOUT) mma_p2<!EX, !EX>(dp, gf[kb], b);
          else mma_p2<!EX, !EX>(dp, xf[kb], b);
        }
        float val[4], wv[4];  // dpre (chain) or w (first pass); w
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int sl = c0 + (i & 1);
          const bool valid = i < 2 ? v0 : v1;
          const float lg = (zp[0][i] + zp[1][i]) * (i < 2 ? it0 : it1);
          const float w = ex2((lg - L.msl[sl]) * L2E) * L.isl[sl];
          const float d = fmaf(dp[0][i] + dp[1][i], bscale, L.usl[sl]);
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
          // dx^T += Ws dpre^T (+ G^T (w / (1 + 1e-5))^T): the fragments of
          // dpre (w) are the B fragments, rows gid (nr 0) and gid + 8 (nr 1)
          const Split bp[2][2] = {{split(val[0]), split(val[1])},
                                  {split(val[2]), split(val[3])}};
          Split bw[2][2];
          if constexpr (APATH) {
            bw[0][0] = split(wv[0] * bscale);
            bw[0][1] = split(wv[1] * bscale);
            bw[1][0] = split(wv[2] * bscale);
            bw[1][1] = split(wv[3] * bscale);
          }
#pragma unroll
          for (int mc = 0; mc < MC; ++mc) {
            const int e = (mc * NB + nb) * 32 + lane;
            Split aw[4];
            table_a<false>(aw, L.twa, e);
            mma_p<true, true>(dxt[mc][0], aw, bp[0]);
            mma_p<true, true>(dxt[mc][1], aw, bp[1]);
            if constexpr (APATH) {
              table_a<EX>(aw, L.tba, e);
              mma_p<!EX, true>(dxt[mc][0], aw, bw[0]);
              mma_p<!EX, true>(dxt[mc][1], aw, bw[1]);
            }
          }
        }
      }
      HAET_TRACE(HAET_SEG(sg_, mk_, 3);)
      if constexpr (CHAIN) {
        q0 += __shfl_xor_sync(FULL, q0, 1);
        q0 += __shfl_xor_sync(FULL, q0, 2);
        q1 += __shfl_xor_sync(FULL, q1, 1);
        q1 += __shfl_xor_sync(FULL, q1, 2);
        const size_t qr = static_cast<size_t>(cloud) * n + row0 + r16 + gid;
        if (!first) {  // the earlier windows' sums of these rows
          if (v0) q0 += a.qbuf[qr];
          if (v1) q1 += a.qbuf[qr + 8];
        }
        if (!last) {
          if (tig == 0 && v0) a.qbuf[qr] = q0;
          if (tig == 0 && v1) a.qbuf[qr + 8] = q1;
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
            const float wa0 = L.wa[ch], wa1 = ch + 8 < CM ? L.wa[ch + 8] : 0.f;
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
      HAET_TRACE(HAET_SEG(sg_, mk_, 4);)
      // acc += buf^T B over these 16 rows: dpre^T x (chain) or w^T g_out;
      // k = tig is row kr*8 + 2*tig, k = tig + 4 row kr*8 + 2*tig + 1
      const T* bsrc = CHAIN ? slot : gslot;
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
          const T* p = bsrc + (r16 + ra) * CS + nc * 8 + gid;
          const Split b[2] = {operand<EX>(va ? ldv(p) : 0.f),
                              operand<EX>(vb ? ldv(p + CS) : 0.f)};
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            mma_p<true, !EX>(acc[mb][nc], af[mb], b);
        }
      }
      if constexpr (CHAIN) {
        if (last && lane < CM) {  // dWa of channel `lane`
          for (int r = 0; r < 16 && r16 + r < rows; ++r)
            dwa_l = fmaf(ldv(slot + (r16 + r) * CS + lane), drw[r], dwa_l);
        }
      }
      HAET_TRACE(HAET_SEG(sg_, mk_, 5);)
      if constexpr (CHAIN) {
        // dx through the buffer, 16 rows at a time
        __syncwarp();  // every lane is done reading the buffer and x
#pragma unroll
        for (int mc = 0; mc < MC; ++mc)
#pragma unroll
          for (int nr = 0; nr < 2; ++nr)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int ch = mc * 16 + gid + 8 * (i >> 1);
              const int r = nr * 8 + 2 * tig + (i & 1);
              if (ch < CM) buf[r * BUF_STRIDE + ch] = dxt[mc][nr][i];
            }
        __syncwarp();
        // these rows' dx (added to the earlier windows')
        store_rows<BUF_STRIDE, CM, T>(
            buf, a.dacc, dx, cl + static_cast<size_t>(row0 + r16) * c,
            min(16, rows - r16), c, vec, first, last, lane);
      }
      __syncwarp();  // the buffer is free for the next 16 rows
      HAET_TRACE(HAET_SEG(sg_, mk_, 6);)
    }
  }
  cp_wait<0>();
  __syncthreads();  // the rings are free: the warps' partials go there

  // The warps' sums, then the block's in warp order.
  float* mg = L.merge;  // [WARPS][PM]
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = colsum[nb][h];
      v += __shfl_xor_sync(FULL, v, 4);
      v += __shfl_xor_sync(FULL, v, 8);
      v += __shfl_xor_sync(FULL, v, 16);
      float* row = mg + warp * PM + (nb * 8 + 2 * tig + h) * RW;
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
        mg[warp * PM + (mb * 16 + gid + 8 * (i >> 1)) * RW + nc * 8 +
           2 * tig + (i & 1)] = acc[mb][nc][i];
  const bool tail = CHAIN && last;  // dWa and dba follow the rows
  if (tail) {
    if (lane < CM) mg[warp * PM + BW * RW + lane] = dwa_l;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dba_l += __shfl_xor_sync(FULL, dba_l, o);
    if (lane == 0) mg[warp * PM + BW * RW + CM] = dba_l;
  }
  __syncthreads();
  const int pw2 = windows * BW * (CM + 1) + CM + 1;
  float* pb = CHAIN ? a.part2 + static_cast<size_t>(unit) * pw2 +
                          static_cast<size_t>(win) * BW * (CM + 1)
                    : a.part1 + (static_cast<size_t>(win) * units + unit) *
                                    BW * (CM + 2);
  for (int e = tid; e < BW * RW + (tail ? CM + 1 : 0); e += NTF) {
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) v += mg[u * PM + e];
    pb[e] = v;
  }
  __syncthreads();  // the rings are free again
  zero_padding<T, CM, DESLICE>(c);
  HAET_TRACE(HAET_SEG(sg_, mk_, 7);)
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Every block of the grid meets here (the launcher has checked that all
// are resident at once). bar[0] counts the arrivals, bar[1] the
// departures; the last block to leave, which knows that every block has
// seen all arrivals, resets both to zero.
__device__ __forceinline__ void grid_sync(int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // the block's writes, ordered by the barrier above
    const int blocks = static_cast<int>(gridDim.x);
    atomicAdd(bar, 1);
    while (ld_acquire(bar) < blocks) __nanosleep(64);
    __threadfence();
    if (atomicAdd(bar + 1, 1) == blocks - 1) {
      atomicExch(bar + 1, 0);
      atomicExch(bar, 0);
    }
  }
  __syncthreads();
}

// put(e, sum over q < rows of p[q][e], in q order) for every e < len, the
// block's threads taking E entries each at a time, so that E loads of a row
// (and, unrolled, of the next rows) are in flight together. With RW > 0,
// put(e, v, vs) also gets vs, the same sum of the last entry of e's row of
// RW entries (sum_n w, for a first pass's partials), in the same order.
template <int E, int RW = 0, typename Put>
__device__ __forceinline__ void sum_rows(const float* p, int rows, int len,
                                         Put&& put) {
  for (int e0 = threadIdx.x; e0 < len; e0 += E * NTF) {
    float v[E], vs[E];
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = vs[i] = 0.f;
#pragma unroll 4
    for (int q = 0; q < rows; ++q)
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int e = e0 + i * NTF;
        const float* r = p + static_cast<size_t>(q) * len;
        if (e < len) {
          v[i] += __ldcg(r + e);
          if constexpr (RW > 0) vs[i] += __ldcg(r + (e / RW + 1) * RW - 1);
        }
      }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (e0 + i * NTF >= len) continue;
      if constexpr (RW > 0) put(e0 + i * NTF, v[i], vs[i]);
      else put(e0 + i * NTF, v[i]);
    }
  }
}

// After a unit's first pass (every window): the last unit of its cloud to
// finish (a counter, bar[3 + bh + cloud], reset here) adds the cloud's
// partials in unit order: t and sum_n w into tsum and, for deslice,
// dstates, divided by its slice's sum_n w as sum_partials divides it.
// Before the grid barrier, so that the chain reads the merged sums alone,
// and no tile load queues in front of these reads.
template <typename T, int CM, bool DESLICE>
__device__ __forceinline__ void merge_first_pass(const BwdArgs& a, int unit,
                                                 int windows, int* flag) {
  const int tid = threadIdx.x;
  const int cloud = unit / a.per_cloud, units = a.bh * a.per_cloud;
  int* counter = a.bar + 3 + a.bh + cloud;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *flag = atomicAdd(counter, 1) == a.per_cloud - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  constexpr int RW = CM + 2, LEN = BW * RW;
  for (int w = 0; w < windows; ++w) {
    const int w0 = w * BW, gw = min(BW, a.g - w0);
    const float* p = a.part1 + (static_cast<size_t>(w) * units +
                                static_cast<size_t>(cloud) * a.per_cloud) *
                                   LEN;
    float* ts = a.tsum + (static_cast<size_t>(cloud) * windows + w) * BW * 2;
    T* dst = static_cast<T*>(a.dstates) +
             (static_cast<size_t>(cloud) * a.g + w0) * a.c;
    if constexpr (DESLICE) {
      sum_rows<4, RW>(p, a.per_cloud, LEN, [&](int e, float v, float sw) {
        const int sl = e / RW, col = e - sl * RW;
        if (col >= CM) ts[sl * 2 + col - CM] = v;
        else if (sl < gw && col < a.c)
          dst[sl * a.c + col] = from_f32<T>(v / (sw > 0.f ? sw : 1.f));
      });
    } else {
      sum_rows<4>(p, a.per_cloud, LEN, [&](int e, float v) {
        const int sl = e / RW, col = e - sl * RW;
        if (col >= CM) ts[sl * 2 + col - CM] = v;
      });
    }
  }
  if (tid == 0) *counter = 0;
}

// After a unit's chain partials are in part2: the last unit of its cloud to
// finish adds the cloud's in unit order into cpart; the last cloud to
// finish adds the clouds' in cloud order into dWs [c][g], dbs, dWa and
// dba. Each resets its counter (bar[3 + cloud], bar[2]).
template <int CM>
__device__ __forceinline__ void finish_unit(const BwdArgs& a, int unit,
                                            int windows, int* flag) {
  const int tid = threadIdx.x;
  const int cloud = unit / a.per_cloud;
  const int rows = windows * BW * (CM + 1), pw2 = rows + CM + 1;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *flag = atomicAdd(a.bar + 3 + cloud, 1) == a.per_cloud - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* p = a.part2 + static_cast<size_t>(cloud) * a.per_cloud * pw2;
  float* cp = a.cpart + static_cast<size_t>(cloud) * pw2;
  sum_rows<4>(p, a.per_cloud, pw2, [&](int e, float v) { cp[e] = v; });
  if (tid == 0) a.bar[3 + cloud] = 0;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *flag = atomicAdd(a.bar + 2, 1) == a.bh - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  sum_rows<4>(a.cpart, a.bh, pw2, [&](int e, float v) {
    if (e >= rows) {  // dWa, dba
      const int k = e - rows;
      if (k < a.c) a.dwa[k] = v;
      if (k == CM) a.dba[0] = v;
      return;
    }
    const int win = e / (BW * (CM + 1)), r = e - win * BW * (CM + 1);
    const int sl = win * BW + r / (CM + 1), col = r % (CM + 1);
    if (sl < a.g && col < a.c) a.dws[col * a.g + sl] = v;
    if (sl < a.g && col == CM) a.dbs[sl] = v;
  });
  if (tid == 0) a.bar[2] = 0;
}

// One backward call (slice_states_bwd, or deslice_bwd with DESLICE) for C
// <= 32 and any G: grid (blocks) of at most the card's resident blocks,
// NTF threads; block b takes the units b, b + blocks, ... The first pass
// over every unit and window, the grid barrier, then the chain over the
// same units and windows and the merges (see the note above). The profiler's
// name of a launch tells the kind by its last template argument
// (haet_torch/ops/kernels/__init__.py:KERNEL_NAMES).
template <typename T, int CM, bool DESLICE>
__global__ void __launch_bounds__(NTF, 1)
slice_bwd_fused(const __grid_constant__ BwdArgs a) {
  // float32 takes slice_bwd_f32, faster there (PERF.md)
  static_assert(std::is_same_v<T, bf16>, "slice_bwd_fused is for bf16 I/O");
  constexpr int SUMS = DESLICE ? BWD_SUMS : BWD_STATES_SUMS;
  constexpr int CHAIN = DESLICE ? BWD_CHAIN : BWD_STATES;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flag;
  const int units = a.bh * a.per_cloud;
  const int windows = (a.g + BW - 1) / BW;
#ifdef HAET_SLICE_TRACE
  long long mk_ = clock64(), sg_[BWD_SEGS] = {};
  const int rec_ = blockIdx.x % TRACE_CTAS, warp_ = threadIdx.x >> 5;
  auto record = [&](int mode) {
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < BWD_SEGS; ++i)
        g_trace_bwd[mode][rec_][warp_][i] = sg_[i];
    for (int i = 0; i < BWD_SEGS; ++i) sg_[i] = 0;
  };
#endif
  zero_padding<T, CM, DESLICE>(a.c);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    for (int w = 0; w < windows; ++w)
      bwd_rows<T, CM, DESLICE, SUMS>(a, u, w, windows,
                                     false HAET_TRACE_ARGS);
    merge_first_pass<T, CM, DESLICE>(a, u, windows, &flag);
  }
  if (blockIdx.x < units)  // the first chain window's tables
    stage_tables<T, CM, DESLICE, CHAIN>(a, blockIdx.x / a.per_cloud, 0);
  grid_sync(a.bar);
  HAET_TRACE(HAET_SEG(sg_, mk_, 7); record(SUMS);)
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    for (int w = 0; w < windows; ++w)
      bwd_rows<T, CM, DESLICE, CHAIN>(
          a, u, w, windows, u == blockIdx.x && w == 0 HAET_TRACE_ARGS);
    finish_unit<CM>(a, u, windows, &flag);
  }
  HAET_TRACE(HAET_SEG(sg_, mk_, 7); record(CHAIN);)
}

// ---------------------------------------------------------------------------
// slice_bwd_f32: the float32 backward for C <= 32, one launch per pass (see
// the note above).
// ---------------------------------------------------------------------------

constexpr int BWD_FIRST = 1, BWD_LAST = 2;  // window flags

// Floats of one operand table of one window, hi or lo parts: the B matrix
// of a product over 32 slices and CM channels (K x N = CM x 32 or 32 x CM)
// in wgmma's no-swizzle K-major layout, 8 x 8 per k-step.
template <int CM>
__host__ __device__ constexpr int wg_table_floats() {
  return 32 * CM;
}

// Row stride of a block's partial sums: the channels, then dbs (chain) or
// t and sum_n w (first pass).
template <int CM, int MODE>
__host__ __device__ constexpr int bwd_row() {
  return CM + (bwd_sums(MODE) ? 2 : 1);
}

// Floats of one block's partial sums per window: [BW][bwd_row] (dWs^T and
// dbs, or dstates, t and sum_n w), then for the chain modes dWa [CM] and
// dba.
template <int CM, int MODE>
__host__ __device__ constexpr int bwd_part_floats() {
  return BW * bwd_row<CM, MODE>() + (bwd_sums(MODE) ? 0 : CM + 1);
}

// Floats of one ring of slice_bwd_f32: every warp's STAGES slots of FTR rows.
template <int CM>
__host__ __device__ constexpr int f32_ring_floats() {
  return FW * STAGES * FTR * row_stride<CM>();
}

// Operand tables of one window of a pass of MODE: Ws and the G-side matrix
// as the B of the logits and of dw; the chains' Ws^T (and slice_states' G^)
// as the B of dx. Each as hi and lo parts.
template <int MODE>
__host__ __device__ constexpr int bwd_tables() {
  return 2 + (MODE == BWD_STATES ? 2 : MODE == BWD_CHAIN ? 1 : 0);
}

// Dynamic shared memory of slice_bwd_f32 in floats (mirrors bwd_smem() in
// the wrapper): the x ring (and the g_out ring); per window of the sweep its
// operand tables (hi and lo) and bs - shift, m, 1 / (s S), u; Wa; per warp
// the dpre (or w) buffer [FTR][BUF_STRIDE] and draw [FTR].
template <int CM, int SW, int MODE>
__host__ __device__ constexpr int bwd_smem_floats() {
  return (bwd_gout(MODE) ? 2 : 1) * f32_ring_floats<CM>() +
         SW * (2 * bwd_tables<MODE>() * wg_table_floats<CM>() + 4 * BW) +
         CM + FW * FTR * (BUF_STRIDE + 1);
}

// v as a TF32 high part with its low 13 bits cleared (split()'s own
// rounding to nearest) and the remainder.
__device__ __forceinline__ Split split_t(float v) {
  const unsigned hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(v - __uint_as_float(hi))};
}

// The shared-memory descriptor of a wgmma B operand: no swizzle, K-major,
// 8 x 16-byte core matrices, 128 bytes apart along K and 256 along N.
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += a b for the warpgroup's 64 rows: one wgmma m64nNk8 in TF32, A from
// the registers (each warp's 16 rows, the mma.sync m16n8k8 A layout), B
// from shared memory; d the accumulator layout of N / 8 m16n8 blocks.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const unsigned (&a)[4],
                                      uint64_t b);

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4], const unsigned (&a)[4],
                                         uint64_t b) {
#ifdef HAET_SLICE_NO_MMA
  d[0] += __uint_as_float(a[0] ^ static_cast<unsigned>(b));
#else
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
#endif
}

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8],
                                          const unsigned (&a)[4], uint64_t b) {
#ifdef HAET_SLICE_NO_MMA
  d[0] += __uint_as_float(a[0] ^ static_cast<unsigned>(b));
#else
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
#endif
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16],
                                          const unsigned (&a)[4], uint64_t b) {
#ifdef HAET_SLICE_NO_MMA
  d[0] += __uint_as_float(a[0] ^ static_cast<unsigned>(b));
#else
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
#endif
}

// d += a b in 3xTF32 (lo*hi, hi*lo, hi*hi); `a` split in the registers,
// b's hi and lo tables at bhi and blo.
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N / 2], const Split (&a)[4],
                                       const unsigned* bhi,
                                       const unsigned* blo) {
  const unsigned ah[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
  const unsigned al[4] = {a[0].lo, a[1].lo, a[2].lo, a[3].lo};
  wgmma<N>(d, al, wg_desc(bhi));
  wgmma<N>(d, ah, wg_desc(blo));
  wgmma<N>(d, ah, wg_desc(bhi));
}

// 1 / tau and the raw Ada-Temp value x . Wa + ba of row lane % 16 of a
// 16-row tile (lanes r and r + 16 both take row r), summed in the order of
// the forwards' row_inv_tau (two FMA chains along the row), so that the
// temperatures, and with them the logits, are those of the forward whose
// residuals (m, s) the weights take.
template <int CM>
__device__ __forceinline__ void row16_raw_tau(const float* slot,
                                              const float* wa_s, float ba,
                                              float base_temp, int lane,
                                              float& raw, float& it) {
  const float* xr = slot + (lane & 15) * row_stride<CM>();
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

// The 2 * KP channels [Q * tig + 2 * kb, + 2 * KP) of one tile row: a
// lane's x (or g_out) fragments of k-blocks kb .. kb + KP - 1.
template <int KP>
__device__ __forceinline__ void frag_cols(float (&v)[2 * KP],
                                          const float* p) {
  if constexpr (KP == 2) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
}

// acc += buf^T B over a 16-row tile: the buffer's slices (dpre or w) as A
// (M = slices, K = rows), the slot's channels (x or g_out) as B; k = tig is
// row kr*8 + 2*tig, k = tig + 4 row kr*8 + 2*tig + 1 (both bank-conflict
// free at the strides of 36 and CM + 4 floats). Rows past `rows` read as
// zero features.
template <int CM>
__device__ __forceinline__ void rows_product(float (&acc)[BW / 16][CM / 8][4],
                                             const float* buf,
                                             const float* slot, int rows,
                                             int gid, int tig) {
  constexpr int MB = BW / 16, NC = CM / 8, CS = row_stride<CM>();
#pragma unroll
  for (int kr = 0; kr < 2; ++kr) {
    const int ra = kr * 8 + 2 * tig;
    const bool va = ra < rows, vb = ra + 1 < rows;
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
      const float* p = slot + ra * CS + nc * 8 + gid;
      const Split b[2] = {split(va ? p[0] : 0.f), split(vb ? p[CS] : 0.f)};
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) mma3(acc[mb][nc], af[mb], b);
    }
  }
}

// grid (per_cloud, bh, sweeps), NTW threads (FW / 4 warpgroups); N cut as
// for the forwards. Block (blockIdx.x, blockIdx.y) takes rows
// [blockIdx.x * span, + span) of cloud blockIdx.y for the SW windows of BW
// slices from window win0 + blockIdx.z * SW (fewer at wend). Inputs: x,
// g_out [bh, n, c]; Ws [c, g]; bs [g]; Wa [c]; ba; bmat [bh, g, c]
// (dL/dstates for slice_states' modes, the states for deslice's); tsum the
// first pass's sums (chain modes: t and S of cloud b, slice w * BW + i at
// ((w * bh + b) * BW + i) * (CM + 2) + CM and + 1); m, s [bh, g]. Outputs:
// part [windows][bh][per_cloud][bwd_part_floats]; dx [bh, n, c] and the
// scratch q [bh, n] (chain modes: a launch adds its windows' dx and q to
// those of the earlier launches unless flags has BWD_FIRST, and the one
// with BWD_LAST applies draw). MODE is the last template argument: the
// profiler's name of a launch tells the mode by it
// (haet_torch/ops/kernels/__init__.py:KERNEL_NAMES).
template <int CM, int SW, int MODE>
__global__ void __launch_bounds__(NTW, 1)
slice_bwd_f32(const float* __restrict__ x, const float* __restrict__ gout,
              const float* __restrict__ ws, const float* __restrict__ bs,
              const float* __restrict__ wa, const float* __restrict__ ba,
              const float* __restrict__ bmat, const float* __restrict__ tsum,
              const float* __restrict__ m, const float* __restrict__ s,
              float* __restrict__ part, float* __restrict__ dx,
              float* __restrict__ qbuf, int n, int c, int g, int span,
              int win0, int wend, int flags, float base_temp, float shift) {
  constexpr bool CHAIN = !bwd_sums(MODE);      // the chain to x and the
  constexpr bool APATH = MODE == BWD_STATES;   // weights; dx += w G^
  constexpr bool GOUT = bwd_gout(MODE);        // a g_out stream
  constexpr bool DST = MODE == BWD_SUMS;       // dstates = w^T g_out
  constexpr bool ROWS = CHAIN || DST;          // a row-contracted product
  constexpr int KB = CM / 8, NB = BW / 8, NC = CM / 8, MB = BW / 16;
  constexpr int Q = CM / 4, CS = row_stride<CM>();
  constexpr int KP = KB < 2 ? KB : 2;          // k-blocks per fragment load
  constexpr int PW = bwd_part_floats<CM, MODE>(), RW = bwd_row<CM, MODE>();
  constexpr int TF = wg_table_floats<CM>();    // one table's hi (or lo)
  constexpr int TW = 2 * bwd_tables<MODE>() * TF;  // a window's tables
  constexpr int RING = f32_ring_floats<CM>(), STRIDE = FW * FTR;
  static_assert(FW % 4 == 0, "whole warpgroups");
  static_assert(FW * PW <= RING, "a window's block merge fits one ring");
  static_assert(SW == 1 || (CM <= 16 && !DST), "sweeps: CM <= 16, no dstates");
  extern __shared__ __align__(16) float sm[];
  HAET_TRACE(long long mk_ = clock64(), sg_[BWD_SEGS] = {};)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, nbh = gridDim.y, per_cloud = gridDim.x;
  const int wb = win0 + blockIdx.z * SW;       // the sweep's first window
  const int nw = min(SW, wend - wb);           // and its windows
  const bool first = flags & BWD_FIRST, last = flags & BWD_LAST;
  const int row_begin = blockIdx.x * span;
  const int rows_blk = min(span, n - row_begin);
  const size_t cloud = static_cast<size_t>(bh) * n * c;
  const float* xb = x + cloud;
  const float* gb = GOUT ? gout + cloud : nullptr;
  const bool vec = vec_ok<float>(
      c, reinterpret_cast<uintptr_t>(x) |
             (GOUT ? reinterpret_cast<uintptr_t>(gout) : 0));
  const bool pair = c % 2 == 0 && (reinterpret_cast<uintptr_t>(dx) & 7) == 0;

  float* ring_x = sm;                              // [FW][STAGES][FTR][CS]
  float* ring_g = ring_x + RING;                   // the same, if GOUT
  // per window: [table][hi, lo][TF]: Ws as B of the logits (K channels,
  // N slices), the G-side matrix as B of dw, Ws^T as B of dx (K slices, N
  // channels; chains), G^ as B of dx (slice_states' chain)
  unsigned* tab = reinterpret_cast<unsigned*>(ring_x + (GOUT ? 2 : 1) * RING);
  float* bsh_s = reinterpret_cast<float*>(tab + SW * TW);  // [SW][BW] each
  float* m_s = bsh_s + SW * BW;
  float* is_s = m_s + SW * BW;
  float* u_s = is_s + SW * BW;
  float* wa_s = u_s + SW * BW;                     // [CM]
  float* buf = wa_s + CM + warp * FTR * BUF_STRIDE;          // dpre or w
  float* drw = wa_s + CM + FW * FTR * BUF_STRIDE + warp * FTR;  // draw
  auto table = [&](int sw, int t, int lo) {
    return tab + sw * TW + (2 * t + lo) * TF;
  };

  const int tiles = (rows_blk + FTR - 1) / FTR;
  const int my_tiles = tiles > warp ? (tiles - warp + FW - 1) / FW : 0;
  const int lead = warp & ~3;  // the warpgroup's first warp takes the most
  const int wg_tiles = tiles > lead ? (tiles - lead + FW - 1) / FW : 0;
  float* my_x = ring_x + warp * STAGES * FTR * CS;
  float* my_g = ring_g + warp * STAGES * FTR * CS;
  const int first_row = row_begin + warp * FTR;
  auto load = [&](int j) {  // tile j of this warp into its ring slots
    const int r0 = first_row + j * STRIDE, rows = min(FTR, n - r0);
    load_tile<CM, float>(my_x + (j % STAGES) * FTR * CS, xb, r0, rows, c,
                         vec, lane);
    if constexpr (GOUT)
      load_tile<CM, float>(my_g + (j % STAGES) * FTR * CS, gb, r0, rows, c,
                           vec, lane);
  };

  if (c < CM) {  // padding columns must read as zeros
    for (int i = tid; i < (GOUT ? 2 : 1) * RING; i += NTW) ring_x[i] = 0.f;
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < my_tiles) load(j);
    cp_commit();
  }

  // Each window's operand tables, split; per slice bs - shift, finite m
  // (+inf past G: w = 0), 1 / (s S) and u.
  const float bscale = GOUT ? 1.f : 1.f / NORM;
  auto wsv = [&](int k, int sl) {  // sl a slice of the whole G
    return k < c && sl < g ? ws[k * g + sl] : 0.f;
  };
  auto bmv = [&](int sl, int k) {
    return k < c && sl < g
               ? bmat[(static_cast<size_t>(bh) * g + sl) * c + k] * bscale
               : 0.f;
  };
  auto put = [&](int sw, int t, int e, float v) {
    const Split p = split_t(v);
    table(sw, t, 0)[e] = p.hi;
    table(sw, t, 1)[e] = p.lo;
  };
  for (int i = tid; i < nw * TF; i += NTW) {
    const int sw = i / TF, e = i - sw * TF, w0 = (wb + sw) * BW;
    // B[k][n] of entry e: k-step e / (8 N) of an N-wide product
    const int r = e & 255, q = r >> 5;
    const int k = (q & 1) * 4 + (r & 3), nr = (q >> 1) * 8 + ((r >> 2) & 7);
    {  // the logits and dw (N = 32 slices): channel Q*(k%4) + 2*kb + k/4,
       // the order of the lanes' x (g_out) fragments
      const int sl = w0 + nr, ch = Q * (k & 3) + 2 * (e >> 8) + (k >> 2);
      put(sw, 0, e, wsv(ch, sl));
      put(sw, 1, e, bmv(sl, ch));
    }
    if constexpr (CHAIN) {  // dx (N = CM channels, k-steps of 8 * CM):
                            // slice nb*8 + 2*(k%4) + k/4, the order of the
                            // accumulator fragments of dpre and w
      const int rr = e % (8 * CM), qq = rr >> 5;
      const int kk = (qq & 1) * 4 + (rr & 3);
      const int ch = (qq >> 1) * 8 + ((rr >> 2) & 7);
      const int sl = w0 + (e / (8 * CM)) * 8 + 2 * (kk & 3) + (kk >> 2);
      put(sw, 2, e, wsv(ch, sl));
      if constexpr (APATH) put(sw, 3, e, bmv(sl, ch));
    }
  }
  for (int i = tid; i < nw * BW; i += NTW) {
    const int w = wb + i / BW, j = i % BW, sl = w * BW + j;
    const bool in = sl < g;
    const size_t sg = static_cast<size_t>(bh) * g + sl;
    const float mj = in ? m[sg] : 0.f, sj = in ? s[sg] : 1.f;
    bsh_s[i] = in ? bs[sl] - shift : 0.f;
    m_s[i] = in ? (isfinite(mj) ? mj : 0.f) : INFINITY;
    float u = 0.f, norm = 1.f;
    if (in && CHAIN) {  // t / S, and w / S
      const float* ts =
          tsum + ((static_cast<size_t>(w) * nbh + bh) * BW + j) * (CM + 2) +
          CM;
      norm = ts[1] > 0.f ? ts[1] : 1.f;
      u = -ts[0] / norm;
    }
    is_s[i] = 1.f / ((sj > 0.f ? sj : 1.f) * norm);
    u_s[i] = u;
  }
  if (tid < CM) wa_s[tid] = tid < c ? wa[tid] : 0.f;
  const float ba0 = ba[0];
  // the tables, written by the threads, are read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  HAET_TRACE(HAET_SEG(sg_, mk_, 0);)

  // acc: per window dWs^T (chain) or dstates (deslice's first pass),
  // slices mb*16 + gid (+ 8), channels nc*8 + 2*tig (+ 1); colsum: dbs or t
  // of the lane's slices nb*8 + 2*tig (+ 1) over its rows, and wsum their
  // sum_n w (first pass); dWa of channel lane % CM over its rows, dba.
  constexpr int NACC = ROWS ? SW : 1;
  float acc[NACC][MB][NC][4], colsum[SW][NB][2], wsum[SW][NB][2];
  float dwa_l = 0.f, dba_l = 0.f;
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int nc = 0; nc < NC; ++nc)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[a][mb][nc][i] = 0.f;
#pragma unroll
  for (int sw = 0; sw < SW; ++sw)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      colsum[sw][nb][0] = colsum[sw][nb][1] = wsum[sw][nb][0] =
          wsum[sw][nb][1] = 0.f;

  // every warp of a warpgroup runs the warpgroup's count of tiles (wgmma
  // is collective): past its own, a warp's rows are all masked
  for (int j = 0; j < wg_tiles; ++j) {
    __syncwarp();  // every lane is done with the slot refilled below
    if (j + STAGES - 1 < my_tiles) load(j + STAGES - 1);
    cp_commit();
    cp_wait<STAGES - 1>();
    __syncwarp();
    HAET_TRACE(HAET_SEG(sg_, mk_, 1);)
    const float* slot = my_x + (j % STAGES) * FTR * CS;
    const float* gslot = GOUT ? my_g + (j % STAGES) * FTR * CS : slot;
    const int row0 = first_row + j * STRIDE;
    const int rows = j < my_tiles ? min(FTR, n - row0) : 0;
    float raw_l, it_l;
    row16_raw_tau<CM>(slot, wa_s, ba0, base_temp, lane, raw_l, it_l);
    const float it0 = __shfl_sync(FULL, it_l, gid);
    const float it1 = __shfl_sync(FULL, it_l, gid + 8);
    const bool v0 = gid < rows, v1 = gid + 8 < rows;
    float q0 = 0.f, q1 = 0.f;  // sum_g dlogit * logit, rows gid, gid + 8
    float dxa[CHAIN ? CM / 2 : 1];  // dx: rows gid (+ 8), channels
                                    // 8*j + 2*tig (+ 1)
    HAET_TRACE(HAET_SEG(sg_, mk_, 2);)
#pragma unroll
    for (int sw = 0; sw < SW; ++sw) {
      if (sw >= nw) break;
      // Z and dw (- t) of the warpgroup's 64 rows and the window's 32
      // slices on the tensor cores, [4 * nb + i]: slices nb*8 + 2*tig +
      // (i & 1), rows gid (+ 8 from i = 2); all three passes of a k-block
      // in one round, then bs - shift and u
      float zp[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) zp[i] = dp[i] = 0.f;
#pragma unroll
      for (int p = 0; p < KB; p += KP) {
        float xq[2][2 * KP], gq[2][2 * KP];
        frag_cols<KP>(xq[0], slot + gid * CS + Q * tig + 2 * p);
        frag_cols<KP>(xq[1], slot + (gid + 8) * CS + Q * tig + 2 * p);
        if constexpr (GOUT) {
          frag_cols<KP>(gq[0], gslot + gid * CS + Q * tig + 2 * p);
          frag_cols<KP>(gq[1], gslot + (gid + 8) * CS + Q * tig + 2 * p);
        }
#pragma unroll
        for (int h = 0; h < KP; ++h) {
          const int kb = p + h;
          // A fragments of rows gid (a0, a2) and gid + 8 (a1, a3); one
          // k-block's products in flight at a time, so that their A
          // registers stay few
          const Split xa[4] = {
              split_t(xq[0][2 * h]), split_t(xq[1][2 * h]),
              split_t(xq[0][2 * h + 1]), split_t(xq[1][2 * h + 1])};
          wg_fence();
          wgmma3<32>(zp, xa, table(sw, 0, 0) + kb * 256,
                     table(sw, 0, 1) + kb * 256);
          if constexpr (GOUT) {
            const Split ga[4] = {
                split_t(gq[0][2 * h]), split_t(gq[1][2 * h]),
                split_t(gq[0][2 * h + 1]), split_t(gq[1][2 * h + 1])};
            wgmma3<32>(dp, ga, table(sw, 1, 0) + kb * 256,
                       table(sw, 1, 1) + kb * 256);
          } else {
            wgmma3<32>(dp, xa, table(sw, 1, 0) + kb * 256,
                       table(sw, 1, 1) + kb * 256);
          }
          wg_commit_wait();
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c0 = sw * BW + nb * 8 + 2 * tig;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          zp[4 * nb + i] += bsh_s[c0 + (i & 1)];
          dp[4 * nb + i] += u_s[c0 + (i & 1)];
        }
      }
      HAET_TRACE(HAET_SEG(sg_, mk_, 3);)
      // the softmax: dpre (chain) or w (first pass), kept for dx and put in
      // the buffer for the row-contracted product
      float val[NB][4], wv[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c0 = nb * 8 + 2 * tig;  // the lane's slices c0, c0 + 1
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cs = sw * BW + c0 + (i & 1);
          const bool valid = i < 2 ? v0 : v1;
          const float lg = zp[4 * nb + i] * (i < 2 ? it0 : it1);
          const float w = ex2((lg - m_s[cs]) * L2E) * is_s[cs];
          const float d = dp[4 * nb + i];
          wv[nb][i] = valid ? w : 0.f;
          if constexpr (CHAIN) {
            const float dl = w * d;
            val[nb][i] = valid ? dl * (i < 2 ? it0 : it1) : 0.f;
            if (i < 2) q0 = fmaf(dl, lg, q0);
            else q1 = fmaf(dl, lg, q1);
          } else {
            val[nb][i] = wv[nb][i];
            wsum[sw][nb][i & 1] += wv[nb][i];
            if (valid)
              colsum[sw][nb][i & 1] = fmaf(w, d, colsum[sw][nb][i & 1]);
          }
        }
        if constexpr (CHAIN) {
          colsum[sw][nb][0] += val[nb][0] + val[nb][2];
          colsum[sw][nb][1] += val[nb][1] + val[nb][3];
        }
        if constexpr (ROWS) {
          *reinterpret_cast<float2*>(buf + gid * BUF_STRIDE + c0) =
              make_float2(val[nb][0], val[nb][1]);
          *reinterpret_cast<float2*>(buf + (gid + 8) * BUF_STRIDE + c0) =
              make_float2(val[nb][2], val[nb][3]);
        }
      }
      HAET_TRACE(HAET_SEG(sg_, mk_, 4);)
      if constexpr (CHAIN) {
        // dx += dpre Ws^T (+ w G^) on the tensor cores: the accumulator
        // fragments of dpre (w) are the A fragments, k = tig slice 2*tig,
        // k = tig + 4 slice 2*tig + 1 of each block of 8 (dx zero until
        // the first window's, out of the registers of the logits)
        if (sw == 0)
#pragma unroll
          for (int i = 0; i < CM / 2; ++i) dxa[i] = 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const Split a[4] = {split_t(val[nb][0]), split_t(val[nb][2]),
                              split_t(val[nb][1]), split_t(val[nb][3])};
          wg_fence();
          wgmma3<CM>(dxa, a, table(sw, 2, 0) + nb * 8 * CM,
                     table(sw, 2, 1) + nb * 8 * CM);
          if constexpr (APATH) {
            const Split b[4] = {split_t(wv[nb][0]), split_t(wv[nb][2]),
                                split_t(wv[nb][1]), split_t(wv[nb][3])};
            wgmma3<CM>(dxa, b, table(sw, 3, 0) + nb * 8 * CM,
                       table(sw, 3, 1) + nb * 8 * CM);
          }
          wg_commit_wait();
        }
      }
      if constexpr (ROWS) {
        __syncwarp();  // the buffer is written
        // dWs^T += dpre^T x (chain), dstates += w^T g_out (first pass)
        rows_product<CM>(acc[sw], buf, CHAIN ? slot : gslot, rows, gid, tig);
        __syncwarp();  // the buffer is free for the next window
        HAET_TRACE(HAET_SEG(sg_, mk_, 5);)
      }
    }
    if constexpr (CHAIN) {
      q0 += __shfl_xor_sync(FULL, q0, 1);
      q0 += __shfl_xor_sync(FULL, q0, 2);
      q1 += __shfl_xor_sync(FULL, q1, 1);
      q1 += __shfl_xor_sync(FULL, q1, 2);
      const size_t qr = static_cast<size_t>(bh) * n + row0 + gid;
      if (!first) {  // the earlier launches' sums of these rows
        if (v0) q0 += qbuf[qr];
        if (v1) q1 += qbuf[qr + 8];
      }
      if (!last) {
        if (tig == 0 && v0) qbuf[qr] = q0;
        if (tig == 0 && v1) qbuf[qr + 8] = q1;
      } else {
        const float raw0 = __shfl_sync(FULL, raw_l, gid);
        const float raw1 = __shfl_sync(FULL, raw_l, gid + 8);
        const float dr0 =
            v0 && raw0 > -0.4f && raw0 < 0.4f ? -q0 * it0 : 0.f;
        const float dr1 =
            v1 && raw1 > -0.4f && raw1 < 0.4f ? -q1 * it1 : 0.f;
        // dx[row][ch] += draw[row] Wa[ch]: the lane's rows are gid, gid + 8
#pragma unroll
        for (int jc = 0; jc < CM / 8; ++jc) {
          const float wa0 = wa_s[8 * jc + 2 * tig];
          const float wa1 = wa_s[8 * jc + 2 * tig + 1];
          dxa[4 * jc] = fmaf(wa0, dr0, dxa[4 * jc]);
          dxa[4 * jc + 1] = fmaf(wa1, dr0, dxa[4 * jc + 1]);
          dxa[4 * jc + 2] = fmaf(wa0, dr1, dxa[4 * jc + 2]);
          dxa[4 * jc + 3] = fmaf(wa1, dr1, dxa[4 * jc + 3]);
        }
        if (tig == 0) {
          drw[gid] = dr0;
          drw[gid + 8] = dr1;
          dba_l += dr0 + dr1;
        }
      }
      HAET_TRACE(HAET_SEG(sg_, mk_, 4);)
      // dx straight from the fragments, two channels a store, plus the
      // earlier launches' windows
      float* dxr = dx + cloud + static_cast<size_t>(row0) * c;
#pragma unroll
      for (int jc = 0; jc < CM / 8; ++jc)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gid + 8 * h, ch = 8 * jc + 2 * tig;
          if (r >= rows || ch >= c) continue;
          float e0 = dxa[4 * jc + 2 * h], e1 = dxa[4 * jc + 2 * h + 1];
          float* p = dxr + r * c + ch;
          if (pair) {
            if (!first) {
              const float2 u = *reinterpret_cast<const float2*>(p);
              e0 += u.x, e1 += u.y;
            }
            *reinterpret_cast<float2*>(p) = make_float2(e0, e1);
          } else {
            if (!first) e0 += p[0];
            p[0] = e0;
            if (ch + 1 < c) {
              if (!first) e1 += p[1];
              p[1] = e1;
            }
          }
        }
      HAET_TRACE(HAET_SEG(sg_, mk_, 6);)
      if (last) {  // dWa of channel lane % CM over rows lane / CM + k 32 / CM
        __syncwarp();  // draw is written
        constexpr int LPC = 32 / CM;
        for (int r = lane / CM; r < rows; r += LPC)
          dwa_l = fmaf(slot[r * CS + lane % CM], drw[r], dwa_l);
      }
      HAET_TRACE(HAET_SEG(sg_, mk_, 6);)
    }
  }
  cp_wait<0>();
  __syncthreads();  // the rings are free: the warps' partials go there

  if constexpr (CHAIN) {
#pragma unroll
    for (int o = CM; o < 32; o <<= 1)  // the lanes of a channel
      dwa_l += __shfl_xor_sync(FULL, dwa_l, o);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dba_l += __shfl_xor_sync(FULL, dba_l, o);
  }
  // Per window, the warps' sums, then the block's in warp order.
  float* mg = sm;  // [FW][PW]
#pragma unroll
  for (int sw = 0; sw < SW; ++sw) {
    if (sw >= nw) break;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = colsum[sw][nb][h];
        v += __shfl_xor_sync(FULL, v, 4);
        v += __shfl_xor_sync(FULL, v, 8);
        v += __shfl_xor_sync(FULL, v, 16);
        float* row = mg + warp * PW + (nb * 8 + 2 * tig + h) * RW;
        if (gid == 0) row[CM] = v;
        if constexpr (!CHAIN) {
          v = wsum[sw][nb][h];
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
             2 * tig + (i & 1)] = acc[ROWS ? sw : 0][mb][nc][i];
    if constexpr (CHAIN) {  // dWa and dba with the sweep's last window
      const bool tail = sw == nw - 1;
      if (lane < CM) mg[warp * PW + BW * RW + lane] = tail ? dwa_l : 0.f;
      if (lane == 0) mg[warp * PW + PW - 1] = tail ? dba_l : 0.f;
    }
    __syncthreads();
    float* pb = part + ((static_cast<size_t>(wb + sw) * nbh + bh) * per_cloud +
                        blockIdx.x) * PW;
    for (int e = tid; e < PW; e += NTW) {
      float v = 0.f;
#pragma unroll
      for (int u = 0; u < FW; ++u) v += mg[u * PW + e];
      pb[e] = v;
    }
    __syncthreads();  // the merge area is free for the next window
  }
#ifdef HAET_SLICE_TRACE
  HAET_SEG(sg_, mk_, 7);
  if (lane == 0) {
    const int rec =
        ((blockIdx.z * nbh + bh) * per_cloud + blockIdx.x) % TRACE_CTAS;
    for (int i = 0; i < BWD_SEGS; ++i) g_trace_bwd[MODE][rec][warp][i] = sg_[i];
  }
#endif
}

// Where sum_partials puts its sums, for windows of wr slices (BW for
// slice_bwd_f32, g for slice_bwd_generic: one window). SUM_PARAMS (b a
// window of the chain, rows [wr][rw] of dWs^T and dbs, then dWa, dba): dWs
// [c][g] (out), dbs [g] (o2), and from the last window dWa [c] (o3), dba
// (o4). SUM_STATES (b = window * bh + cloud, rows [wr][rw] of dstates, t and
// sum_n w): out[b][j], and dstates [bh][g][c] divided by each slice's sum_n
// w (o2, if not null).
constexpr int SUM_PARAMS = 1, SUM_STATES = 2;

struct SumOut {
  float *out, *o2, *o3, *o4;
  int mode, c, g, cm, rw, bh, windows, wr;
};

// grid (ceil(len / 32), batches), NT threads: the sum over p < parts of
// part[b][p][j], each warp adding a contiguous eighth of the p in order,
// then the warps' sums in warp order (a fixed order: two calls agree bit
// for bit).
__global__ void __launch_bounds__(NT)
sum_partials(const float* __restrict__ part, int parts, int len, SumOut o) {
  __shared__ float red[2][NT / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane, b = blockIdx.y;
  const int per = (parts + NT / 32 - 1) / (NT / 32);
  const int p0 = min(parts, warp * per), p1 = min(parts, p0 + per);
  // dstates is divided by its slice's sum_n w (column cm + 1 of its row),
  // summed here in the order of that column's own sum
  const bool norm = o.mode == SUM_STATES && o.o2 != nullptr && j < len;
  const int js = norm ? (j / o.rw) * o.rw + o.cm + 1 : j;
  float v = 0.f, vs = 0.f;
  if (j < len) {
    const float* p = part + (static_cast<size_t>(b) * parts + p0) * len;
#pragma unroll 8
    for (int k = p0; k < p1; ++k) {
      const float* q = p + static_cast<size_t>(k - p0) * len;
      v += q[j];
      if (norm) vs += q[js];
    }
  }
  red[0][warp][lane] = v;
  red[1][warp][lane] = vs;
  __syncthreads();
  if (warp != 0 || j >= len) return;
  v = vs = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    v += red[0][w][lane];
    vs += red[1][w][lane];
  }
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
    if (sl < o.g && col < o.c && o.o2) o.o2[e] = v / (vs > 0.f ? vs : 1.f);
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
// blocks' in a fixed order.
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

// Resident blocks per SM of slice_bwd_fused<T, CM, DESLICE> at its shared
// memory (opted in first) on the current device, cached per device: the
// persistent grid's limit.
constexpr int MAX_DEVICES = 64;

template <typename T, int CM, bool DESLICE>
cudaError_t fused_per_sm(int* per_sm) {
  constexpr size_t SMEM = bwd_fused_smem<T, CM, DESLICE>();
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!cached[dev]) {
    err = cudaFuncSetAttribute(slice_bwd_fused<T, CM, DESLICE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached[dev], slice_bwd_fused<T, CM, DESLICE>, NTF, SMEM);
    if (err != cudaSuccess) return err;
  }
  *per_sm = cached[dev];
  return cudaSuccess;
}

// A cooperative launch: the runtime refuses it unless every block can be
// resident at once (so the grid barrier cannot wait on a block that never
// runs, whatever else holds the SMs), and CUDA graphs capture it as such.
template <typename T, int CM, bool DESLICE>
cudaError_t launch_bwd_fused(const BwdArgs& a, int blocks, int smem,
                             cudaStream_t stream) {
  constexpr size_t SMEM = bwd_fused_smem<T, CM, DESLICE>();
  if (static_cast<size_t>(smem) != SMEM || blocks < 1)
    return cudaErrorInvalidValue;
  int per_sm = 0;  // and the kernel opted into its shared memory
  const cudaError_t err = fused_per_sm<T, CM, DESLICE>(&per_sm);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NTF);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, slice_bwd_fused<T, CM, DESLICE>, a);
}

template <int CM, int SW, int MODE>
cudaError_t launch_bwd(const float* x, const float* gout, const float* ws,
                       const float* bs, const float* wa, const float* ba,
                       const float* bmat, const float* tsum, const float* m,
                       const float* s, float* part, float* dx, float* qbuf,
                       int bh, int n, int c, int g, int per_cloud, int span,
                       int win0, int wend, int flags, float base_temp,
                       float shift, size_t smem, cudaStream_t stream) {
  if (smem != sizeof(float) * bwd_smem_floats<CM, SW, MODE>())
    return cudaErrorInvalidValue;
  static size_t allowed = 0;
  cudaError_t err = allow_smem(slice_bwd_f32<CM, SW, MODE>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const int sweeps = (wend - win0 + SW - 1) / SW;
  slice_bwd_f32<CM, SW, MODE>
      <<<dim3(per_cloud, bh, sweeps), NTW, smem, stream>>>(
          x, gout, ws, bs, wa, ba, bmat, tsum, m, s, part, dx, qbuf, n, c, g,
          span, win0, wend, flags, base_temp, shift);
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

// The float32 backward's instantiations: (mode, CM, windows per sweep).
// Two windows in one sweep at C <= 16 alone, and not in deslice's first
// pass: wider, or with dstates' accumulators, the sweep's accumulators spill
// past the 128 registers of 16 warps per SM (slower, as measured: PERF.md).
#define HAET_BWD_F32_CASES(X)                                              \
  X(BWD_STATES, 8, 1) X(BWD_STATES, 16, 1) X(BWD_STATES, 32, 1)            \
  X(BWD_STATES, 8, 2) X(BWD_STATES, 16, 2) X(BWD_CHAIN, 8, 1)              \
  X(BWD_CHAIN, 16, 1) X(BWD_CHAIN, 32, 1) X(BWD_CHAIN, 8, 2)               \
  X(BWD_CHAIN, 16, 2) X(BWD_STATES_SUMS, 8, 1) X(BWD_STATES_SUMS, 16, 1)   \
  X(BWD_STATES_SUMS, 32, 1) X(BWD_STATES_SUMS, 8, 2)                       \
  X(BWD_STATES_SUMS, 16, 2) X(BWD_SUMS, 8, 1) X(BWD_SUMS, 16, 1)           \
  X(BWD_SUMS, 32, 1)

// The fused backward's instantiations (bf16 I/O): (CM, deslice).
#define HAET_BWD_CASES(X)                                           \
  X(8, false) X(16, false) X(32, false) X(8, true) X(16, true) X(32, true)

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

// Copies g_trace_bwd [4][TRACE_CTAS][FW][BWD_SEGS] to dst.
int haet_trace_read_bwd(unsigned long long* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, g_trace_bwd, sizeof(g_trace_bwd)));
}

// Zeroes g_trace_bwd (a record never written reads as zeros).
int haet_trace_reset_bwd() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_trace_bwd);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemset(p, 0, sizeof(g_trace_bwd)));
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

// Blocks per SM of the fused backward (deslice: deslice_bwd, else
// slice_states_bwd) for C channels at its shared memory smem (the wrapper's
// count, checked here): the wrapper sizes the persistent grid from it.
int haet_slice_bwd_per_sm(int deslice, int c, int smem, int* per_sm) {
  const int cm = fast_cm(c);
  cudaError_t err = cudaErrorInvalidValue;
#define HAET_CASE(CM, D)                                            \
  if (cm == CM && (deslice != 0) == D) {                            \
    if (static_cast<size_t>(smem) != bwd_fused_smem<bf16, CM, D>()) \
      return static_cast<int>(cudaErrorInvalidValue);               \
    err = fused_per_sm<bf16, CM, D>(per_sm);                        \
  }
  HAET_BWD_CASES(HAET_CASE)
#undef HAET_CASE
  return static_cast<int>(err);
}

// One call of the fused backward for bf16 I/O, one cooperative launch, for
// C <= 32 and any G (see BwdArgs for the tensors and their layouts): blocks
// at most the resident blocks (haet_slice_bwd_per_sm times the SMs),
// per_cloud * span >= n > (per_cloud - 1) * span; qbuf and dacc needed past
// one window of BW slices; smem is the wrapper's count, checked here.
int haet_slice_bwd_fused(int deslice, const void* x, const void* gout,
                         const float* ws, const float* bs, const float* wa,
                         const float* ba, const void* bmat, const float* m,
                         const float* s, float* part1, float* tsum,
                         float* part2, float* cpart, void* dstates, void* dx,
                         float* dacc, float* qbuf, float* dws, float* dbs,
                         float* dwa, float* dba, int* bar, int bh, int n,
                         int c, int g, int per_cloud, int span, int blocks,
                         float base_temp, float shift, int smem,
                         void* stream) {
  const int cm = fast_cm(c);
  if (!cm || bh < 1 || n < 1 || g < 1 || per_cloud < 1 ||
      static_cast<long long>(per_cloud) * span < n ||
      static_cast<long long>(per_cloud - 1) * span >= n ||
      (g > BW && (qbuf == nullptr || dacc == nullptr)) ||
      (deslice && dstates == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs args{x, gout, ws, bs, wa, ba, bmat, m, s, part1, tsum,
                     part2, cpart, dstates, dx, dacc, qbuf, dws, dbs, dwa,
                     dba, bar, bh, n, c, g, per_cloud, span, base_temp,
                     shift};
  cudaStream_t str = static_cast<cudaStream_t>(stream);
#define HAET_CASE(CM, D)                   \
  if (cm == CM && (deslice != 0) == D)     \
    return static_cast<int>(               \
        launch_bwd_fused<bf16, CM, D>(args, blocks, smem, str));
  HAET_BWD_CASES(HAET_CASE)
#undef HAET_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch of the float32 backward kernel slice_bwd_f32 in `mode` (0:
// slice_states' chain, 1: deslice's first pass, 2: its chain, 3:
// slice_states' first pass), for C <= 32, over the windows [win0, wend) of
// BW slices, `sweep` of them in one sweep of the rows (grid z: the sweeps; a
// chain launch is one sweep); flags: 1 the chain's first launch, 2 its last
// (qbuf needed unless both). Shapes as at slice_bwd_f32; smem is the
// wrapper's count, checked here.
int haet_slice_bwd(int mode, int sweep, const float* x, const float* gout,
                   const float* ws, const float* bs, const float* wa,
                   const float* ba, const float* bmat, const float* tsum,
                   const float* m, const float* s, float* part, float* dx,
                   float* qbuf, int bh, int n, int c, int g, int per_cloud,
                   int span, int win0, int wend, int flags, float base_temp,
                   float shift, int smem, void* stream) {
  const int cm = fast_cm(c);
  const bool chain = mode == BWD_STATES || mode == BWD_CHAIN;
  if (!cm || win0 < 0 || wend <= win0 || (wend - 1) * BW >= g ||
      (chain && (wend - win0 > sweep ||
                 (flags != (BWD_FIRST | BWD_LAST) && qbuf == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t str = static_cast<cudaStream_t>(stream);
#define HAET_CASE(MODE, CM, SW)                                              \
  case (MODE * 100 + CM) * 10 + SW:                                          \
    return static_cast<int>(launch_bwd<CM, SW, MODE>(                        \
        x, gout, ws, bs, wa, ba, bmat, tsum, m, s, part, dx, qbuf, bh, n, c, \
        g, per_cloud, span, win0, wend, flags, base_temp, shift, smem, str));
  switch ((mode * 100 + cm) * 10 + sweep) { HAET_BWD_F32_CASES(HAET_CASE) }
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
// their own layouts) or dstates (o2, if not null) beside the first pass's
// full sums.
int haet_sum_partials(const float* part, float* out, float* o2, float* o3,
                      float* o4, int batches, int parts, int len, int mode,
                      int c, int g, int cm, int rw, int bh, int wr,
                      void* stream) {
  if (batches < 1 || parts < 1 || (mode != SUM_PARAMS && mode != SUM_STATES)
      || wr < 1 || len < wr * rw)
    return static_cast<int>(cudaErrorInvalidValue);
  const SumOut o{out, o2, o3, o4, mode, c, g, cm, rw, bh, batches, wr};
  sum_partials<<<dim3((len + 31) / 32, batches), NT, 0,
                 static_cast<cudaStream_t>(stream)>>>(part, parts, len, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
