// Scaled copy for Hopper (sm_90a), float32: out = x * 1.000001f.
//
// Replaces the Pallas TPU kernel `copy_kernel` of
// benchmarks/micro_erwin_fused.py (called through `chain_copy`, :70-80),
// which loads its whole input as one VMEM block and writes
// `x_ref[...] * 1.000001`. JAX types the Python constant weakly, so on a
// float32 ref the product is a float32 multiply by float32(1.000001); the
// kernel multiplies by the same constant and gives the same bits.
//
// What bounds it on an H100: one read and one write per element and one
// multiply, so bytes: at the micro driver's shape (x [256, 32], 32 KiB each
// way) 0.02 us at 3.35 TB/s, far below the launch, which bounds the call;
// at [4096, 4096] (64 MiB each way) 40 us, the memory system's rate.
//
// Design: one pass with no loop. Each thread loads VPT 16-byte float4s
// (all loads issued before the first store, neighbouring threads on
// neighbouring addresses), scales and stores them; the grid covers the
// array exactly. Small arrays take VPT 1, so that their few loads spread
// over as many CTAs, and SMs, as there are warps' worth of work; from four
// CTAs of VPT 4 per SM on, VPT 4 keeps 64 bytes in flight per thread.
// Indices are 32-bit below 2^31 elements. The 0-3 floats past the last
// float4 are done by the first CTA's first threads in the same launch.
// Pointers that are not both 16-byte aligned take the same design with
// one float per load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;                // threads per CTA
constexpr float SCALE = 1.000001f;
// from this many items on, each thread takes 4: four CTAs per SM of the
// H100's 132
constexpr long long WIDE_ITEMS = 132LL * 4 * NT * 4;
// 32-bit indices while the last thread's index stays below 2^31
constexpr long long MAX_INT_ITEMS = (1LL << 31) - (1LL << 16);

__device__ __forceinline__ float4 scaled(float4 v) {
  v.x *= SCALE;
  v.y *= SCALE;
  v.z *= SCALE;
  v.w *= SCALE;
  return v;
}

__device__ __forceinline__ float scaled(float v) { return v * SCALE; }

// T: float4 (aligned) or float; items: the T's of the array;
// x_tail/out_tail/tail: the floats past the last float4 (float4 only).
template <typename T, int VPT, typename Index>
__global__ void __launch_bounds__(NT)
    copy_scale(const T* __restrict__ x, T* __restrict__ out, Index items,
               const float* __restrict__ x_tail, float* __restrict__ out_tail,
               int tail) {
  const Index first = static_cast<Index>(blockIdx.x) * (NT * VPT) +
                      static_cast<Index>(threadIdx.x);
  T v[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const Index i = first + k * NT;
    if (i < items) v[k] = x[i];
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const Index i = first + k * NT;
    if (i < items) out[i] = scaled(v[k]);
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    out_tail[threadIdx.x] = x_tail[threadIdx.x] * SCALE;
  }
}

template <typename T, typename Index>
cudaError_t launch(const T* x, T* out, long long items, const float* x_tail,
                   float* out_tail, int tail, cudaStream_t st) {
  const int vpt = items >= WIDE_ITEMS ? 4 : 1;
  long long blocks = (items + NT * vpt - 1) / (NT * vpt);
  if (blocks < 1) blocks = 1;   // a tail alone
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  const Index n = static_cast<Index>(items);
  if (vpt == 4) {
    copy_scale<T, 4, Index><<<grid, NT, 0, st>>>(x, out, n, x_tail,
                                                  out_tail, tail);
  } else {
    copy_scale<T, 1, Index><<<grid, NT, 0, st>>>(x, out, n, x_tail,
                                                  out_tail, tail);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const T* x, T* out, long long items,
                       const float* x_tail, float* out_tail, int tail,
                       cudaStream_t st) {
  if (items < MAX_INT_ITEMS) {
    return launch<T, int>(x, out, items, x_tail, out_tail, tail, st);
  }
  return launch<T, long long>(x, out, items, x_tail, out_tail, tail, st);
}

}  // namespace

extern "C" {

const char* haet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: numel float32 each, not overlapping; numel >= 1.
int haet_copy_scale_f32(const float* x, float* out, long long numel,
                        void* stream) {
  if (numel < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned) {
    const long long n4 = numel / 4;
    return static_cast<int>(launch_any<float4>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
        n4, x + 4 * n4, out + 4 * n4, static_cast<int>(numel - 4 * n4), st));
  }
  return static_cast<int>(
      launch_any<float>(x, out, numel, nullptr, nullptr, 0, st));
}

}  // extern "C"
