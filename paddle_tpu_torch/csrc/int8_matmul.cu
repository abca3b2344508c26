// Weight-only int8 matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int8_matmul.py
// (int8_matmul / _kernel): out[B, N] = (x[B, K] @ float(w[K, N])) * scale[N]
// for decode-sized B <= 64, f32 accumulation, output in x's dtype; w is
// row-major (K, N) int8 with one f32 scale per output column.
//
// What bounds it: bytes. The int8 weight (K * N bytes) dwarfs x and out at
// B <= 64, and the kernel does 2 * B flops per weight byte, far below the
// card's balance point, so the point is to stream the weight once as int8
// (half the bytes of bf16), never write a dequantized copy, and keep
// enough loads in flight to cover the memory latency:
// - a block owns a strip of kBN = 32 output columns and kBT = 8 rows
//   (grid (ceil(N / 32), ceil(B / 8))); its 256 threads split K 64 ways,
//   4 threads across the strip, each loading 8 int8 columns of one
//   weight row with one 8-byte load (a warp reads 8 whole 32-byte
//   sectors) and accumulating 8 rows x 8 columns in f32 registers;
// - the block walks K in steps of kStep = 512 rows: each thread issues its
//   kUnroll = 8 weight loads of the step first, then the block stages the
//   step's x slice in shared memory as f32 (coalesced along K) while those
//   loads are in flight, then the math runs out of registers;
// - the 64 partial sums of each output are reduced with warp shuffles and
//   one pass through shared memory; the per-column scale is applied there,
//   once. Every weight byte is read by one block per 8 rows of x.
// Known limits, left to a later change: N = 768 gives 24 blocks, which
// leaves most SMs idle (split-K would fill them), and the FMAs run on the
// CUDA cores, not the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                       // columns per thread
constexpr int kColThreads = 4;                 // threads across a strip
constexpr int kBN = kCols * kColThreads;       // 32 columns per block
constexpr int kKLanes = 32 / kColThreads;      // K rows per warp and step
constexpr int kKGroups = kKLanes * kWarps;     // 64 K rows per block step
constexpr int kBT = 8;                         // rows of x per block
constexpr int kUnroll = 8;                     // weight loads per thread
constexpr int kStep = kKGroups * kUnroll;      // K rows per block step
constexpr int kMaxB = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void unpack8(uint2 u, float* f) {
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = static_cast<float>(
        static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xff));
}

// grid (ceil(N / kBN), ceil(B / kBT)), kThreads threads. ``vec``: N is a
// multiple of 8 and w 8-byte aligned, so full column groups load as one
// uint2.
template <typename TX>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const TX* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, TX* __restrict__ out, int B, int K,
    int N, bool vec) {
  __shared__ __align__(16) float xs[kStep][kBT];
  __shared__ float red[kWarps][kBT][kBN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ct = lane % kColThreads;
  const int kg = warp * kKLanes + lane / kColThreads;
  const int n = blockIdx.x * kBN + ct * kCols;
  const int r0 = blockIdx.y * kBT;
  const int nb = min(kBT, B - r0);
  const bool full = vec && n + kCols <= N;

  float acc[kBT][kCols];
#pragma unroll
  for (int b = 0; b < kBT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  for (int kb = 0; kb < K; kb += kStep) {
    // this step's weight loads go out first ...
    uint2 wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kb + u * kKGroups + kg;
      wv[u] = make_uint2(0u, 0u);
      if (k < K) {
        const int8_t* src = w + static_cast<size_t>(k) * N + n;
        if (full) {
          wv[u] = __ldg(reinterpret_cast<const uint2*>(src));
        } else {
          uint32_t lo = 0u, hi = 0u;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const uint32_t byte =
                n + c < N ? static_cast<uint8_t>(src[c]) : 0u;
            if (c < 4) lo |= byte << (8 * c);
            else hi |= byte << (8 * (c - 4));
          }
          wv[u] = make_uint2(lo, hi);
        }
      }
    }
    // ... while the block stages the x slice [kb, kb + kStep) as f32,
    // coalesced along K
    __syncthreads();
    for (int i = threadIdx.x; i < kStep; i += kThreads) {
      const int k = kb + i;
#pragma unroll
      for (int b = 0; b < kBT; ++b)
        xs[i][b] = (k < K && b < nb)
                       ? to_f(x[static_cast<size_t>(r0 + b) * K + k])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float wf[kCols];
      unpack8(wv[u], wf);
      const float4* xr =
          reinterpret_cast<const float4*>(xs[u * kKGroups + kg]);
      const float4 xa = xr[0], xb = xr[1];
      const float xv[kBT] = {xa.x, xa.y, xa.z, xa.w,
                             xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int b = 0; b < kBT; ++b)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[b][c] += xv[b] * wf[c];
    }
  }

  // sum the kKLanes K rows of a warp (lanes kColThreads apart) ...
#pragma unroll
  for (int o = kColThreads; o < 32; o <<= 1)
#pragma unroll
    for (int b = 0; b < kBT; ++b)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[b][c] += __shfl_xor_sync(0xffffffffu, acc[b][c], o);
  if (lane < kColThreads) {
#pragma unroll
    for (int b = 0; b < kBT; ++b)
#pragma unroll
      for (int c = 0; c < kCols; ++c) red[warp][b][ct * kCols + c] = acc[b][c];
  }
  __syncthreads();
  // ... then the warps: one output per thread
  const int b = threadIdx.x / kBN;
  const int col = blockIdx.x * kBN + threadIdx.x % kBN;
  if (b < nb && col < N) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t += red[i][b][threadIdx.x % kBN];
    store_f(t * scale[col], out + static_cast<size_t>(r0 + b) * N + col);
  }
}

static_assert(kBT * kBN == kThreads, "one output per thread in the epilogue");

}  // namespace

// x_dtype: 0 float32, 1 bfloat16 (out has x's dtype). Returns a cudaError_t.
extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* out, int B, int K,
                                  int N, int x_dtype, void* stream) {
  if (B < 1 || B > kMaxB || K < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBN - 1) / kBN, (B + kBT - 1) / kBT);
  const bool vec = N % kCols == 0 && reinterpret_cast<uintptr_t>(w) % 8 == 0;
  if (x_dtype == 0)
    int8_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(out), B, K, N,
        vec);
  else if (x_dtype == 1)
    int8_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
        B, K, N, vec);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
