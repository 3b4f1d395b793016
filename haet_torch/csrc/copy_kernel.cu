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
// multiply. At the benchmark's shape (x [256, 32], 32 KiB each way) that is
// 65,536 bytes, 0.02 us at 3.35 TB/s, so the launch itself (a few us)
// bounds every call; the kernel exists to time that cost, as its Pallas
// counterpart timed a TPU kernel's fixed cost.
//
// Design: a grid-stride loop, 16-byte float4 loads and stores where both
// pointers are 16-byte aligned, and a scalar loop for the tail (or for the
// whole array when a pointer is not aligned). Blocks: enough for one
// element (or float4) per thread, at most 8 per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                // threads per block
constexpr int MAX_BLOCKS = 132 * 8;    // 8 blocks per SM on an H100 SXM
constexpr float SCALE = 1.000001f;

__global__ void copy_scale_vec(const float4* __restrict__ x,
                               float4* __restrict__ out, long long n4,
                               const float* __restrict__ x_tail,
                               float* __restrict__ out_tail, int tail) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  for (long long i = first; i < n4; i += stride) {
    float4 v = x[i];
    v.x *= SCALE;
    v.y *= SCALE;
    v.z *= SCALE;
    v.w *= SCALE;
    out[i] = v;
  }
  if (first < tail) out_tail[first] = x_tail[first] * SCALE;
}

__global__ void copy_scale_scalar(const float* __restrict__ x,
                                  float* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = x[i] * SCALE;
  }
}

int blocks_for(long long items) {
  long long b = (items + NT - 1) / NT;
  if (b < 1) b = 1;
  return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
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
    const int tail = static_cast<int>(numel - 4 * n4);   // 0..3
    copy_scale_vec<<<blocks_for(n4 > 0 ? n4 : 1), NT, 0, st>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
        n4, x + 4 * n4, out + 4 * n4, tail);
  } else {
    copy_scale_scalar<<<blocks_for(numel), NT, 0, st>>>(x, out, numel);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
