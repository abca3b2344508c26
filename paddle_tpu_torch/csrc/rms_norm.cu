// RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/rms_norm.py: rms_fwd
// (_fwd_kernel) and rms_bwd (_bwd_kernel). The normalized axis is the last
// one (H); leading axes are flattened to rows.
//   forward:  inv = rsqrt(mean(x^2) + eps) in f32, y = x * inv rounded to
//             x's dtype, out = y * w in f32 rounded to the promoted dtype;
//             inv (rows, 1) f32 is saved for the backward.
//   backward: yn = x * inv, dy = g * w, dx = inv * (dy - yn * mean(dy * yn))
//             in x's dtype; dw = sum over rows of g * round_to_x_dtype(yn),
//             from f32 per-block partials (the TPU kernel's (8, H)
//             partial block becomes one row per CUDA block) summed by a
//             second kernel in block order.
//
// What bounds it: bytes. Each element is read once or twice and written
// once with a handful of flops, far below the card's ~295 flops per byte.
// The forward keeps every reduction inside one warp: one warp per row,
// its lanes striding the row, shuffles for the row sum; its second pass
// over a row re-reads it from L1/L2.
//
// The backward (rms_bwd_vec_kernel, H a multiple of 8 up to 1024) reads
// every byte once, 16 bytes a load: a warp takes a row, each lane owns
// chunks of 8 columns (lane, lane + 32, ...), 3 of them at H 768. The
// row's x and g stay in registers from the row sum to the dx pass; w and
// the lane's dw partials stay in registers across every row the warp
// takes, so shared memory (24 KB at H 768) serves only the end. The
// kernel is held to 128 registers a thread so that two blocks, 16 warps,
// run on an SM (it would take 138 at H 768 bf16, one block an SM, which
// int8_rms_variants.py times as ``rms_one_block``). At the end the warps'
// dw partials meet in shared memory
// and are summed in warp order, and rms_dw_reduce_kernel sums the blocks'
// partials in block order and rounds to w's dtype: the result does not
// depend on scheduling. Other widths (H % 8, or H up to 4096) take the
// looped rms_bwd_kernel (lanes striding the row, two passes, per-warp dw
// partials in shared memory) and the same reduction.

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

// 8 consecutive values as f32 from one 16-byte (bf16) or two (f32) loads
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    v[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

constexpr int kVecMax = 4;  // chunks of 8 a lane holds: H up to 1024

// H % 8 == 0, H <= 32 * 8 * VPL. grid nb blocks, each over a contiguous
// run of ceil(rows / nb) rows, its warps taking every kWarps-th row of the
// run. Static shared memory: the warps' dw partials, used once at the end.
// dwp is (nb, H) f32.
template <typename TX, typename TW, typename TO, int VPL>
__global__ void __launch_bounds__(kThreads, 2)
    rms_bwd_vec_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                       const float* __restrict__ inv,
                       const TO* __restrict__ g, TX* __restrict__ dx,
                       float* __restrict__ dwp, int rows, int H) {
  __shared__ float sdw[kWarps][32 * 8 * VPL];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float wv[VPL][8], dw[VPL][8];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int h = (lane + 32 * v) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) dw[v][i] = wv[v][i] = 0.f;
    if (h < H) load8(w + h, wv[v]);
  }
  const int per = (rows + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * per;
  const int r1 = min(rows, r0 + per);
  for (int row = r0 + warp; row < r1; row += kWarps) {
    const size_t base = static_cast<size_t>(row) * H;
    float xv[VPL][8], gv[VPL][8];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int h = (lane + 32 * v) * 8;
      if (h < H) {
        load8(x + base + h, xv[v]);
        load8(g + base + h, gv[v]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[v][i] = gv[v][i] = 0.f;
      }
    }
    const float r = inv[row];
    float c = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int i = 0; i < 8; ++i) c += gv[v][i] * wv[v][i] * (xv[v][i] * r);
    c = warp_sum(c) / static_cast<float>(H);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int h = (lane + 32 * v) * 8;
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float yn = xv[v][i] * r;
        o[i] = r * (gv[v][i] * wv[v][i] - yn * c);
        dw[v][i] += gv[v][i] * to_f(from_f<TX>(yn));
      }
      if (h < H) store8(dx + base + h, o);
    }
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int h = (lane + 32 * v) * 8;
    if (h < H)
#pragma unroll
      for (int i = 0; i < 8; ++i) sdw[warp][h + i] = dw[v][i];
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += sdw[k][h];
    dwp[static_cast<size_t>(blockIdx.x) * H + h] = s;
  }
}

// dw[h] = sum over b of dwp[b, h], in block order, rounded to w's dtype.
// grid ceil(H / 32), block (32, 32): threadIdx.y sums every 32nd block,
// then the 32 sums meet in order.
template <typename TW>
__global__ void rms_dw_reduce_kernel(const float* __restrict__ dwp,
                                     TW* __restrict__ dw, int nb, int H) {
  __shared__ float part[32][33];
  const int h = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (h < H)
    for (int b = threadIdx.y; b < nb; b += 32)
      s += dwp[static_cast<size_t>(b) * H + h];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && h < H) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) t += part[k][threadIdx.x];
    dw[h] = from_f<TW>(t);
  }
}

template <typename TX, typename TW, typename TO>
cudaError_t bwd(const void* x, const void* w, const void* inv, const void* g,
                void* dx, void* dwp, void* dw, int rows, int H, int nb,
                cudaStream_t s) {
  const int vpl = (H / 8 + 31) / 32;
  // 16-byte loads need every row start on a 16-byte boundary
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (H % 8 == 0 && vpl <= kVecMax && aligned) {
    void (*const kernels[kVecMax])(const TX*, const TW*, const float*,
                                   const TO*, TX*, float*, int, int) = {
        rms_bwd_vec_kernel<TX, TW, TO, 1>, rms_bwd_vec_kernel<TX, TW, TO, 2>,
        rms_bwd_vec_kernel<TX, TW, TO, 3>, rms_bwd_vec_kernel<TX, TW, TO, 4>};
    kernels[vpl - 1]<<<nb, kThreads, 0, s>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<const float*>(inv), static_cast<const TO*>(g),
        static_cast<TX*>(dx), static_cast<float*>(dwp), rows, H);
  } else {
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
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rms_dw_reduce_kernel<TW><<<(H + 31) / 32, dim3(32, 32), 0, s>>>(
      static_cast<const float*>(dwp), static_cast<TW*>(dw), nb, H);
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

// g has out's dtype, dx x's and dw w's; dwp is (nb, H) f32 scratch for
// the per-block partials.
extern "C" int rms_norm_bwd_launch(const void* x, const void* w,
                                   const void* inv, const void* g, void* dx,
                                   void* dwp, void* dw, int rows, int H,
                                   int nb, int x_dtype, int w_dtype,
                                   void* stream) {
  if (bad_shape(rows, H) || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t e;
  if (x_dtype == 0 && w_dtype == 0)
    e = bwd<float, float, float>(x, w, inv, g, dx, dwp, dw, rows, H, nb, s);
  else if (x_dtype == 1 && w_dtype == 1)
    e = bwd<bf, bf, bf>(x, w, inv, g, dx, dwp, dw, rows, H, nb, s);
  else if (x_dtype == 1 && w_dtype == 0)
    e = bwd<bf, float, float>(x, w, inv, g, dx, dwp, dw, rows, H, nb, s);
  else if (x_dtype == 0 && w_dtype == 1)
    e = bwd<float, bf, float>(x, w, inv, g, dx, dwp, dw, rows, H, nb, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
