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
// and G <= 64 (every preset's widths: G 32 and 64 at C 16 and 32):
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
//   * A lane holds the fragments of all G slices where C * G padded is at
//     most 1024, else of 32 slices at a time (C 32 at G 64): slice_states
//     then gives each 32-slice group its own blocks (grid z; the slices'
//     softmaxes are independent), and deslice rebuilds the fragments of each
//     group from shared memory in turn, summing the groups' products in its
//     output fragments.
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
// Other widths with G*C <= 2048 (C > 32 or G > 64) take the generic kernels
// further down (one block per 256-point chunk, a second launch to merge,
// per-thread scalar loops): right, not fast. The wrapper decides the route.
//
// Two builds for benchmarks/slice_phases.py, never the wrapper's:
// -DHAET_SLICE_TRACE records per-warp clock64() segments of the fast
// kernels (haet_trace_read), -DHAET_SLICE_NO_MMA replaces each mma.sync by
// one integer and one float operation on the same registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// A lane's fragments hold all 32 * GL slices if CM * GL <= 32, else 32 at a
// time (slices per register group; mirrors register_slices() in the
// wrapper).
template <int CM, int GL>
__host__ __device__ constexpr int held_slices() {
  return CM * GL <= 32 ? 32 * GL : 32;
}

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

// rows [row0, row0 + rows) of one cloud's x (row stride c) into a slot of
// TR rows; columns c..CM-1 of the slot are left alone.
template <int CM>
__device__ __forceinline__ void load_tile(float* slot, const float* xb,
                                          int row0, int rows, int c,
                                          bool vec, int lane) {
  constexpr int CS = row_stride<CM>();
  const float* src = xb + static_cast<size_t>(row0) * c;
  if (vec && c == CM) {
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

// grid (per_cloud, bh, 32 * GL / GP) with GP = held_slices, NTF threads.
// Block `blockIdx.x` covers rows [blockIdx.x * span, min(n, (blockIdx.x + 1)
// * span)) of cloud blockIdx.y, for slices [blockIdx.z * GP, + GP); its warp
// w takes tiles w, w + WARPS, ... of TR rows.
template <int CM, int GL>
__global__ void __launch_bounds__(NTF, 1)
slice_states_fast(const float* __restrict__ x, const float* __restrict__ ws,
                  const float* __restrict__ bs, const float* __restrict__ wa,
                  const float* __restrict__ ba, float* __restrict__ part_m,
                  float* __restrict__ part_s, float* __restrict__ part_acc,
                  int* __restrict__ counter, float* __restrict__ states,
                  float* __restrict__ m_out, float* __restrict__ s_out,
                  int n, int c, int g, int span, float base_temp,
                  float shift) {
  constexpr int GP = held_slices<CM, GL>(), GZ = 32 * GL / GP;
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
  const int grp = bh * GZ + blockIdx.z;
  const int row_begin = blockIdx.x * span;
  const int rows_blk = min(span, n - row_begin);
  const float* xb = x + static_cast<size_t>(bh) * n * c;
  const bool vec = (c & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

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
        load_tile<CM>(my_ring + j * TR * CS, xb, r0, min(TR, n - r0), c, vec,
                      lane);
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
      load_tile<CM>(my_ring + (jn % STAGES) * TR * CS, xb, r0,
                    min(TR, n - r0), c, vec, lane);
    }
    cp_commit();
    HAET_TRACE(if (j) tc_ += clock64() - tb_; const long long ta_ = clock64();)
    cp_wait<STAGES - 1>();
    __syncwarp();
    HAET_TRACE(tb_ = clock64(); tw_ += tb_ - ta_;)
    const float* slot = my_ring + (j % STAGES) * TR * CS;
    const int rows = min(TR, n - (first_row + j * STRIDE));
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

  // the outputs of this block's slices
  float* st_out = states + (static_cast<size_t>(bh) * g + g0) * c;
  float* m_o = m_out + static_cast<size_t>(bh) * g + g0;
  float* s_o = s_out + static_cast<size_t>(bh) * g + g0;
  if (per_cloud == 1) {  // one block per cloud: write the outputs directly
    for (int e = tid; e < gb * c; e += NTF) {
      const int gi = e / c, k = e - gi * c;
      const float sg = block_sum(gi);
      st_out[e] = block_acc(gi, k) / (sg > 0.f ? sg : 1.f) / NORM;
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
      st_out[gi * c + k] = v[i] / (sg > 0.f ? sg : 1.f) / NORM;
    }
  }
  if (tid == 0) counter[grp] = 0;  // ready for the next call on this stream
}

// grid (per_cloud, bh), NTF threads; N cut as for slice_states_fast, each
// block taking all slices. The fragments hold GH = held_slices slices; with
// 32 * GL > GH they are rebuilt from shared memory for each group of GH
// slices in turn.
template <int CM, int GL>
__global__ void __launch_bounds__(NTF, 1)
deslice_fast(const float* __restrict__ x, const float* __restrict__ ws,
             const float* __restrict__ bs, const float* __restrict__ wa,
             const float* __restrict__ ba, const float* __restrict__ st,
             const float* __restrict__ m, const float* __restrict__ s,
             float* __restrict__ out, int n, int c, int g, int span,
             float base_temp, float shift) {
  constexpr int GP = 32 * GL, GH = held_slices<CM, GL>(), NGRP = GP / GH;
  constexpr int NB = GH / 8, KB = CM / 8, NC = CM / 8;
  constexpr int Q = CM / 4, CS = row_stride<CM>();
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
  const float* xb = x + cloud;
  float* ob = out + cloud;
  const bool vec = (c & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;

  float* ws_s = ring + ring_floats<CM>();  // [CM][ws_stride]
  float* bs_s = ws_s + CM * ws_stride<GP>();  // [GP]
  float* wa_s = bs_s + GP;                    // [CM]
  float* st_s = wa_s + CM;      // [GP][CM + 4] states / s
  float* m_s = st_s + GP * (CM + 4);  // [GP] finite m, times log2(e)
  const int tiles = (rows_blk + TR - 1) / TR;
  const int my_tiles = tiles > warp ? (tiles - warp + WARPS - 1) / WARPS : 0;
  float* my_ring = ring + warp * STAGES * TR * CS;
  const int first_row = row_begin + warp * TR;
  constexpr int STRIDE = WARPS * TR;

  if (c < CM) {  // padding columns must read as zeros
    for (int i = tid; i < ring_floats<CM>(); i += NTF) ring[i] = 0.f;
    __syncthreads();
  }
  const float* stb = st + static_cast<size_t>(bh) * g * c;
  constexpr int RS = (GP * CM + NTF - 1) / NTF;
  float sv[RS], sj[RS], mj;
  // the weights', the states' and the first tiles' loads in flight together
  stage_params<CM, GP>(ws_s, bs_s, wa_s, ws, bs, wa, c, g, g, shift, [&] {
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int i = tid + r * NTF, sl = i / CM, ch = i - sl * CM;
      const bool in = i < GP * CM && sl < g && ch < c;
      sv[r] = in ? stb[sl * c + ch] : 0.f;
      sj[r] = in ? s[static_cast<size_t>(bh) * g + sl] : 1.f;
    }
    mj = tid < g ? m[static_cast<size_t>(bh) * g + tid] : 0.f;
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < my_tiles) {
        const int r0 = first_row + j * STRIDE;
        load_tile<CM>(my_ring + j * TR * CS, xb, r0, min(TR, n - r0), c, vec,
                      lane);
      }
      cp_commit();
    }
  });
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int i = tid + r * NTF, sl = i / CM;
    if (i < GP * CM)
      st_s[sl * (CM + 4) + i - sl * CM] = sv[r] / (sj[r] > 0.f ? sj[r] : 1.f);
  }
  if (tid < GP) m_s[tid] = (isfinite(mj) ? mj : 0.f) * L2E;
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
        const float* w0 =
            ws_s + (Q * tig + 2 * kb) * ws_stride<GP>() + s0 + gid;
        wf[kb][nb][0] = split(w0[0]);
        wf[kb][nb][1] = split(w0[ws_stride<GP>()]);
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
  if constexpr (NGRP == 1) fragments(0);

  HAET_TRACE(t1_ = clock64();)
  for (int j = 0; j < my_tiles; ++j) {
    __syncwarp();
    const int jn = j + STAGES - 1;
    if (jn < my_tiles) {
      const int r0 = first_row + jn * STRIDE;
      load_tile<CM>(my_ring + (jn % STAGES) * TR * CS, xb, r0,
                    min(TR, n - r0), c, vec, lane);
    }
    cp_commit();
    HAET_TRACE(if (j) tc_ += clock64() - tb_; const long long ta_ = clock64();)
    cp_wait<STAGES - 1>();
    __syncwarp();
    HAET_TRACE(tb_ = clock64(); tw_ += tb_ - ta_;)
    float* slot = my_ring + (j % STAGES) * TR * CS;
    const int row0 = first_row + j * STRIDE;
    const int rows = min(TR, n - row0);
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
      for (int h = 0; h < NGRP; ++h) {  // the groups' products summed in o
        if constexpr (NGRP > 1) fragments(h * GH);
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
    float* dst = ob + static_cast<size_t>(row0) * c;
    if (vec) {
      const int q = c >> 2;
      for (int i = lane; i < rows * q; i += 32) {
        const int r = i / q, k = i - r * q;
        *reinterpret_cast<float4*>(dst + r * c + 4 * k) =
            *reinterpret_cast<const float4*>(slot + r * CS + 4 * k);
      }
    } else {
      for (int i = lane; i < rows * c; i += 32) {
        const int r = i / c, k = i - r * c;
        dst[i] = slot[r * CS + k];
      }
    }
  }
  HAET_TRACE(if (my_tiles) tc_ += clock64() - tb_; t2_ = clock64();)
  cp_wait<0>();
  HAET_TRACE(trace_record(1, lane, warp, t1_ - t0_, tw_, tc_,
                          clock64() - t2_);)
}

// ---------------------------------------------------------------------------
// Generic kernels: any G*C <= NT*MAX_ACC, one block per CHUNK points and a
// second launch to merge (slice_states), one block per DTILE points
// (deslice); scalar loops, weights in shared memory.
// ---------------------------------------------------------------------------

constexpr int NT = 256;      // threads per block
constexpr int TILE = 32;     // points per inner tile of slice_partials_generic
constexpr int MAX_ACC = 8;   // G*C <= NT*MAX_ACC accumulator entries
constexpr int DTILE = 64;    // points per deslice block

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

// grid (n_chunks, bh); partial softmax state of one chunk of one cloud.
__global__ void __launch_bounds__(NT)
slice_partials_generic(const float* __restrict__ x,
                       const float* __restrict__ ws,
                       const float* __restrict__ bs,
                       const float* __restrict__ wa,
                       const float* __restrict__ ba,
                       float* __restrict__ part_m,
                       float* __restrict__ part_s,
                       float* __restrict__ part_acc, int n, int c, int g,
                       int chunk, float base_temp, float shift) {
  extern __shared__ __align__(16) float sm[];
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

// grid (ceil(n / DTILE), bh); out = w @ states with w recomputed.
__global__ void __launch_bounds__(NT)
deslice_generic(const float* __restrict__ x, const float* __restrict__ ws,
                const float* __restrict__ bs, const float* __restrict__ wa,
                const float* __restrict__ ba, const float* __restrict__ st,
                const float* __restrict__ m, const float* __restrict__ s,
                float* __restrict__ out, int n, int c, int g, float base_temp,
                float shift) {
  extern __shared__ __align__(16) float sm[];
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

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// The fast kernels' widths: C padded to CM in {8, 16, 32}, G to 32 * GL
// with GL in {1, 2}. 0 if the shape takes the generic kernels. Mirrors
// fast_widths() in the wrapper.
int fast_key(int c, int g) {
  const int cm = c <= 8 ? 8 : c <= 16 ? 16 : c <= 32 ? 32 : 0;
  const int gl = g <= 32 ? 1 : g <= 64 ? 2 : 0;
  return (cm && gl) ? cm * 10 + gl : 0;
}

// Dynamic shared memory of the fast kernels, in bytes (mirrors
// fast_smem_bytes() in the wrapper); a slice_states block holds gp slices.
size_t states_smem(int cm, int gl, int per_cloud) {
  const int gp = cm * gl <= 32 ? 32 * gl : 32;
  int f = WARPS * STAGES * TR * (cm + 4)          // the x ring, Ws, bs, Wa
          + cm * (gp + 1) + gp + cm;
  f = max(f, WARPS * gp * (2 + cm + 8) + gp);      // the warps' merge
  f = max(f, (2 * per_cloud + 2) * gp);            // the cloud's merge
  return sizeof(float) * f;
}

size_t deslice_smem(int cm, int gl) {
  const int gp = 32 * gl;  // the x ring, Ws, bs, Wa, states / s, m
  return sizeof(float) * (WARPS * STAGES * TR * (cm + 4) + cm * (gp + 1) +
                          gp * (cm + 4) + 2 * gp + cm);
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

template <int CM, int GL>
cudaError_t launch_states(const float* x, const float* ws, const float* bs,
                          const float* wa, const float* ba, float* part_m,
                          float* part_s, float* part_acc, int* counter,
                          float* states, float* m, float* s, int bh, int n,
                          int c, int g, int per_cloud, int span,
                          float base_temp, float shift, size_t smem,
                          cudaStream_t st) {
  static size_t allowed = 0;
  cudaError_t err = allow_smem(slice_states_fast<CM, GL>, smem, &allowed);
  if (err != cudaSuccess) return err;
  constexpr int groups = 32 * GL / held_slices<CM, GL>();
  slice_states_fast<CM, GL><<<dim3(per_cloud, bh, groups), NTF, smem, st>>>(
      x, ws, bs, wa, ba, part_m, part_s, part_acc, counter, states, m, s, n,
      c, g, span, base_temp, shift);
  return cudaGetLastError();
}

template <int CM, int GL>
cudaError_t launch_deslice(const float* x, const float* ws, const float* bs,
                           const float* wa, const float* ba,
                           const float* states, const float* m,
                           const float* s, float* out, int bh, int n, int c,
                           int g, int per_cloud, int span, float base_temp,
                           float shift, size_t smem, cudaStream_t st) {
  static size_t allowed = 0;
  cudaError_t err = allow_smem(deslice_fast<CM, GL>, smem, &allowed);
  if (err != cudaSuccess) return err;
  deslice_fast<CM, GL><<<dim3(per_cloud, bh), NTF, smem, st>>>(
      x, ws, bs, wa, ba, states, m, s, out, n, c, g, span, base_temp, shift);
  return cudaGetLastError();
}

}  // namespace

#define HAET_FAST_CASES(X) \
  X(8, 1) X(8, 2) X(16, 1) X(16, 2) X(32, 1) X(32, 2)

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

// The fast slice_states, one launch. Shapes: x [bh, n, c]; ws [c, g];
// bs [g]; wa [c]; ba [1]; part_m/part_s [bh, Z, per_cloud, GP];
// part_acc [bh, Z, per_cloud, GP, CM] (GP = held_slices, Z = 32 * GL / GP
// slice groups; unused when per_cloud is 1); counter [bh, Z] int32, zero
// on entry and left zero; states [bh, g, c]; m/s [bh, g].
// per_cloud * span >= n > (per_cloud - 1) * span; smem is the wrapper's
// count of dynamic shared memory, checked here.
int haet_slice_states_f32(const float* x, const float* ws, const float* bs,
                          const float* wa, const float* ba, float* part_m,
                          float* part_s, float* part_acc, int* counter,
                          float* states, float* m, float* s, int bh, int n,
                          int c, int g, int per_cloud, int span,
                          float base_temp, float shift, int smem,
                          void* stream) {
  const int key = fast_key(c, g);
  if (!key || static_cast<size_t>(smem) !=
                  states_smem(key / 10, key % 10, per_cloud))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HAET_CASE(CM, GL)                                                  \
  case CM * 10 + GL:                                                       \
    return static_cast<int>(launch_states<CM, GL>(                         \
        x, ws, bs, wa, ba, part_m, part_s, part_acc, counter, states, m, s, \
        bh, n, c, g, per_cloud, span, base_temp, shift, smem, st));
  switch (key) { HAET_FAST_CASES(HAET_CASE) }
#undef HAET_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fast deslice. Shapes: x/out [bh, n, c]; ws [c, g]; bs [g]; wa [c];
// ba [1]; states [bh, g, c]; m/s [bh, g]; the cut of N as above.
int haet_deslice_f32(const float* x, const float* ws, const float* bs,
                     const float* wa, const float* ba, const float* states,
                     const float* m, const float* s, float* out, int bh,
                     int n, int c, int g, int per_cloud, int span,
                     float base_temp, float shift, int smem, void* stream) {
  const int key = fast_key(c, g);
  if (!key ||
      static_cast<size_t>(smem) != deslice_smem(key / 10, key % 10))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HAET_CASE(CM, GL)                                                \
  case CM * 10 + GL:                                                     \
    return static_cast<int>(launch_deslice<CM, GL>(                      \
        x, ws, bs, wa, ba, states, m, s, out, bh, n, c, g, per_cloud,    \
        span, base_temp, shift, smem, st));
  switch (key) { HAET_FAST_CASES(HAET_CASE) }
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
  if (g * c > NT * MAX_ACC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n + chunk - 1) / chunk;
  const size_t smem1 =
      sizeof(float) * (c * g + g + c + TILE * c + TILE * g + TILE + 4 * g);
  static size_t allowed1 = 0;
  cudaError_t err = allow_smem(slice_partials_generic, smem1, &allowed1);
  if (err != cudaSuccess) return static_cast<int>(err);
  slice_partials_generic<<<dim3(n_chunks, bh), NT, smem1, st>>>(
      x, ws, bs, wa, ba, part_m, part_s, part_acc, n, c, g, chunk, base_temp,
      shift);
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
  if (g * c > NT * MAX_ACC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) *
      (c * g + g + c + g * c + 2 * g + DTILE * c + DTILE * g + DTILE);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(deslice_generic, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + DTILE - 1) / DTILE;
  deslice_generic<<<dim3(tiles, bh), NT, smem, st>>>(
      x, ws, bs, wa, ba, states, m, s, out, n, c, g, base_temp, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
