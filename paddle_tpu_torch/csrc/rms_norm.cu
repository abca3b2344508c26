// RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/rms_norm.py: rms_fwd
// (_fwd_kernel) and rms_bwd (_bwd_kernel). The normalized axis is the last
// one (H); leading axes are flattened to rows.
//   forward:  inv = rsqrt(mean(x^2) + eps) in f32, y = x * inv rounded to
//             x's dtype, out = y * w in f32 rounded to the promoted dtype;
//             inv (rows, 1) f32 is saved for the backward.
//   backward: yn = x * inv, dy = g * w, dx = inv * (dy - yn * mean(dy * yn))
//             in x's dtype; dw from per-block f32 partials of
//             g * round_to_x_dtype(yn), summed over blocks by the caller
//             (the TPU kernel's (8, H) partial block becomes one row per
//             CUDA block).
//
// What bounds it: bytes. Each element is read once or twice and written
// once with a handful of flops, far below the card's ~295 flops per byte.
// The design keeps every reduction inside one warp: one warp per row, its
// lanes striding the row (neighbouring lanes on neighbouring elements),
// shuffles for the row sums, so no block-wide barrier sits in the row loop.
// The second pass over a row re-reads it from L1/L2, not from device
// memory. The backward's dw partials live in shared memory, one row per
// warp (each lane owns its columns, so no atomics), and are summed in warp
// order once per block: the result does not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one warp per row; grid ceil(rows / kWarps)
template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
    rms_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TO* __restrict__ out, float* __restrict__ inv, int rows,
                   int H, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + static_cast<size_t>(row) * H;
  float ss = 0.f;
  for (int h = lane; h < H; h += 32) {
    const float v = to_f(xr[h]);
    ss += v * v;
  }
  const float r = 1.f / sqrtf(warp_sum(ss) / static_cast<float>(H) + eps);
  TO* orow = out + static_cast<size_t>(row) * H;
  for (int h = lane; h < H; h += 32) {
    const float y = to_f(from_f<TX>(to_f(xr[h]) * r));
    orow[h] = from_f<TO>(y * to_f(w[h]));
  }
  if (lane == 0) inv[row] = r;
}

// grid nb blocks, each over a contiguous run of ceil(rows / nb) rows, its
// warps taking every kWarps-th row of the run. Dynamic shared memory:
// kWarps * H floats of per-warp dw partials. dwp is (nb, H) f32.
template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
    rms_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   const float* __restrict__ inv, const TO* __restrict__ g,
                   TX* __restrict__ dx, float* __restrict__ dwp, int rows,
                   int H) {
  extern __shared__ float sdw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* mine = sdw + warp * H;
  for (int h = lane; h < H; h += 32) mine[h] = 0.f;
  const int per = (rows + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * per;
  const int r1 = min(rows, r0 + per);
  for (int row = r0 + warp; row < r1; row += kWarps) {
    const TX* xr = x + static_cast<size_t>(row) * H;
    const TO* gr = g + static_cast<size_t>(row) * H;
    const float r = inv[row];
    float c = 0.f;
    for (int h = lane; h < H; h += 32)
      c += to_f(gr[h]) * to_f(w[h]) * (to_f(xr[h]) * r);
    c = warp_sum(c) / static_cast<float>(H);
    TX* dxr = dx + static_cast<size_t>(row) * H;
    for (int h = lane; h < H; h += 32) {
      const float yn = to_f(xr[h]) * r;
      const float gf = to_f(gr[h]);
      const float dy = gf * to_f(w[h]);
      dxr[h] = from_f<TX>(r * (dy - yn * c));
      mine[h] += gf * to_f(from_f<TX>(yn));
    }
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s += sdw[k * H + h];
    dwp[static_cast<size_t>(blockIdx.x) * H + h] = s;
  }
}

template <typename TX, typename TW, typename TO>
cudaError_t fwd(const void* x, const void* w, void* out, void* inv, int rows,
                int H, float eps, cudaStream_t s) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  rms_fwd_kernel<TX, TW, TO><<<blocks, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TO*>(out), static_cast<float*>(inv), rows, H, eps);
  return cudaGetLastError();
}

template <typename TX, typename TW, typename TO>
cudaError_t bwd(const void* x, const void* w, const void* inv, const void* g,
                void* dx, void* dwp, int rows, int H, int nb,
                cudaStream_t s) {
  const size_t smem = sizeof(float) * kWarps * H;
  auto kernel = rms_bwd_kernel<TX, TW, TO>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<nb, kThreads, smem, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const float*>(inv), static_cast<const TO*>(g),
      static_cast<TX*>(dx), static_cast<float*>(dwp), rows, H);
  return cudaGetLastError();
}

bool bad_shape(int rows, int H) { return rows < 1 || H < 1 || H > 4096; }

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. out has the promoted dtype of x and
// w (bfloat16 only when both are). Returns a cudaError_t.
extern "C" int rms_norm_fwd_launch(const void* x, const void* w, void* out,
                                   void* inv, int rows, int H, float eps,
                                   int x_dtype, int w_dtype, void* stream) {
  if (bad_shape(rows, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t e;
  if (x_dtype == 0 && w_dtype == 0)
    e = fwd<float, float, float>(x, w, out, inv, rows, H, eps, s);
  else if (x_dtype == 1 && w_dtype == 1)
    e = fwd<bf, bf, bf>(x, w, out, inv, rows, H, eps, s);
  else if (x_dtype == 1 && w_dtype == 0)
    e = fwd<bf, float, float>(x, w, out, inv, rows, H, eps, s);
  else if (x_dtype == 0 && w_dtype == 1)
    e = fwd<float, bf, float>(x, w, out, inv, rows, H, eps, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// g has out's dtype and dx x's; dwp is (nb, H) f32 partials.
extern "C" int rms_norm_bwd_launch(const void* x, const void* w,
                                   const void* inv, const void* g, void* dx,
                                   void* dwp, int rows, int H, int nb,
                                   int x_dtype, int w_dtype, void* stream) {
  if (bad_shape(rows, H) || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t e;
  if (x_dtype == 0 && w_dtype == 0)
    e = bwd<float, float, float>(x, w, inv, g, dx, dwp, rows, H, nb, s);
  else if (x_dtype == 1 && w_dtype == 1)
    e = bwd<bf, bf, bf>(x, w, inv, g, dx, dwp, rows, H, nb, s);
  else if (x_dtype == 1 && w_dtype == 0)
    e = bwd<bf, float, float>(x, w, inv, g, dx, dwp, rows, H, nb, s);
  else if (x_dtype == 0 && w_dtype == 1)
    e = bwd<float, bf, float>(x, w, inv, g, dx, dwp, rows, H, nb, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
