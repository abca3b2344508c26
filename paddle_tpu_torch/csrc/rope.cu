// Rotary position embedding for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/rope.py (_rope_kernel, run
// by _run for rope_fused's forward and, with -sin, its backward). x and out
// are (B, S, H, D) and the tables (S, D/2), all of one dtype; the halves
// split at D/2 (the Llama convention):
//   out[..., :D/2] = x1 c - x2 s,  out[..., D/2:] = x2 c + x1 s,
// with c, s the tables' row for the position, broadcast over B and H, and
// s negated when sign < 0 (the inverse rotation, the backward's dx). The
// arithmetic runs in f32 and each output is rounded once to x's dtype.
//
// What bounds it: bytes. Six flops per pair of elements. One thread per
// output pair (j, j + D/2), consecutive threads on consecutive j, so both
// halves of a row are read and written as contiguous runs; the tables,
// S x D/2 elements, stay in L2 across the B x H rows that share them. A
// grid-stride loop covers any size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const T* __restrict__ x, const T* __restrict__ cos_t,
                const T* __restrict__ sin_t, T* __restrict__ out,
                long long pairs, int S, int H, int d2, float sign) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < pairs; i += stride) {
    const long long row = i / d2;           // (b, s, h)
    const int j = static_cast<int>(i - row * d2);
    const int s = static_cast<int>((row / H) % S);
    const long long o = row * 2 * d2 + j;
    const float x1 = to_f(x[o]);
    const float x2 = to_f(x[o + d2]);
    const float c = to_f(cos_t[s * d2 + j]);
    const float sn = sign * to_f(sin_t[s * d2 + j]);
    out[o] = from_f<T>(x1 * c - x2 * sn);
    out[o + d2] = from_f<T>(x2 * c + x1 * sn);
  }
}

template <typename T>
cudaError_t run(const void* x, const void* c, const void* s, void* out,
                int B, int S, int H, int d2, float sign, cudaStream_t st) {
  const long long pairs = static_cast<long long>(B) * S * H * d2;
  const long long want = (pairs + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  rope_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(c),
      static_cast<const T*>(s), static_cast<T*>(out), pairs, S, H, d2, sign);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, the tables and out alike); sign
// +1 for the rotation, -1 for its inverse. Returns a cudaError_t.
extern "C" int rope_launch(const void* x, const void* cos_t,
                           const void* sin_t, void* out, int B, int S, int H,
                           int D, int sign, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 2 || D % 2 != 0 ||
      (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 1)
    e = run<__nv_bfloat16>(x, cos_t, sin_t, out, B, S, H, D / 2, sg, st);
  else if (dtype == 0)
    e = run<float>(x, cos_t, sin_t, out, B, S, H, D / 2, sg, st);
  return static_cast<int>(e);
}
