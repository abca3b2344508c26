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
// What bounds it: bytes. Six flops per pair of elements, so the kernel must
// move x and out at the card's copy rate:
// - a block holds TP positions (b, s) of TJ threads each, both from
//   blockIdx / threadIdx (one 32-bit modulo per thread for s, no division
//   per element);
// - a thread owns 8 consecutive j of the half-rows: one 16-byte load of
//   x[.., j:j+8] and one of x[.., D/2+j:D/2+j+8] (f32: two of each), two
//   16-byte stores (f32: four);
// - it loads cos / sin for (s, j:j+8) once and holds them in registers
//   across all H heads of its position, whose loads it issues kHeads at a
//   time before any math;
// - D/2 off the 8-element grid, or a misaligned pointer, takes the same
//   kernel one element at a time (kVec false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kHeads = 4;   // heads whose loads are in flight together

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

// Eight consecutive elements as loaded and stored (16 bytes of bf16, 32 of
// f32, 16-byte aligned), or one element (kVec false); f32 values out.
template <typename T, bool kVec>
struct Pack;

template <>
struct Pack<__nv_bfloat16, true> {
  static constexpr int N = 8;
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float* f) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[i];
      const float2 t = __bfloat1622float2(h);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Pack<float, true> {
  static constexpr int N = 8;
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <typename T>
struct Pack<T, false> {
  static constexpr int N = 1;
  T v;
  __device__ __forceinline__ void load(const T* p) { v = *p; }
  __device__ __forceinline__ void get(float* f) const { f[0] = to_f(v); }
  __device__ __forceinline__ static void store(T* p, const float* f) {
    *p = from_f<T>(f[0]);
  }
};

// grid ceil(B * S / TP), block (TJ, TP): threadIdx.y picks the position
// p = b * S + s, threadIdx.x walks its nj = d2 / N element groups with
// stride TJ.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const T* __restrict__ x, const T* __restrict__ cos_t,
                const T* __restrict__ sin_t, T* __restrict__ out,
                int positions, int S, int H, int d2, float sign) {
  using PK = Pack<T, kVec>;
  constexpr int N = PK::N;
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= positions) return;
  const int s = p % S;
  const int nj = d2 / N;
  const int D = 2 * d2;
  const size_t row = static_cast<size_t>(p) * H * D;   // (p, head 0)
  for (int jg = threadIdx.x; jg < nj; jg += blockDim.x) {
    const int j = jg * N;
    float c[N], sn[N];
    {
      PK tc, ts;
      tc.load(cos_t + static_cast<size_t>(s) * d2 + j);
      ts.load(sin_t + static_cast<size_t>(s) * d2 + j);
      tc.get(c);
      ts.get(sn);
#pragma unroll
      for (int e = 0; e < N; ++e) sn[e] *= sign;
    }
    for (int h0 = 0; h0 < H; h0 += kHeads) {
      PK a[kHeads], b[kHeads];
#pragma unroll
      for (int u = 0; u < kHeads; ++u) {
        if (h0 + u < H) {
          const T* xr = x + row + static_cast<size_t>(h0 + u) * D + j;
          a[u].load(xr);
          b[u].load(xr + d2);
        }
      }
#pragma unroll
      for (int u = 0; u < kHeads; ++u) {
        if (h0 + u < H) {
          float x1[N], x2[N], o1[N], o2[N];
          a[u].get(x1);
          b[u].get(x2);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            o1[e] = x1[e] * c[e] - x2[e] * sn[e];
            o2[e] = x2[e] * c[e] + x1[e] * sn[e];
          }
          T* orow = out + row + static_cast<size_t>(h0 + u) * D + j;
          PK::store(orow, o1);
          PK::store(orow + d2, o2);
        }
      }
    }
  }
}

template <typename T, bool kVec>
cudaError_t run(const void* x, const void* c, const void* s, void* out,
                int B, int S, int H, int d2, float sign, cudaStream_t st) {
  const int nj = kVec ? d2 / 8 : d2;
  const int tj = nj < kThreads ? nj : kThreads;
  const int tp = kThreads / tj;
  const int positions = B * S;
  const int blocks = (positions + tp - 1) / tp;
  rope_kernel<T, kVec><<<blocks, dim3(tj, tp), 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(c),
      static_cast<const T*>(s), static_cast<T*>(out), positions, S, H, d2,
      sign);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_any(const void* x, const void* c, const void* s, void* out,
                    int B, int S, int H, int d2, float sign,
                    cudaStream_t st) {
  const bool vec = d2 % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(c) |
        reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  if (vec) return run<T, true>(x, c, s, out, B, S, H, d2, sign, st);
  return run<T, false>(x, c, s, out, B, S, H, d2, sign, st);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x, the tables and out alike); sign
// +1 for the rotation, -1 for its inverse. Returns a cudaError_t.
extern "C" int rope_launch(const void* x, const void* cos_t,
                           const void* sin_t, void* out, int B, int S, int H,
                           int D, int sign, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 2 || D % 2 != 0 ||
      static_cast<long long>(B) * S > (1LL << 31) - 1 ||
      (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 1)
    e = run_any<__nv_bfloat16>(x, cos_t, sin_t, out, B, S, H, D / 2, sg, st);
  else if (dtype == 0)
    e = run_any<float>(x, cos_t, sin_t, out, B, S, H, D / 2, sg, st);
  return static_cast<int>(e);
}
