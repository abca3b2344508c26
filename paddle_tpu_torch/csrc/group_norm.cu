// GroupNorm (+SiLU) forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/group_norm.py: gn_fwd
// (_fwd_kernel) and gn_bwd (_bwd_kernel). x is (B, C, *spatial),
// contiguous, HW = prod(spatial); the cg = C / G channels of group g of
// sample b are one contiguous slab of cg * HW elements (NCHW as the
// convolutions write it, no relayout).
//   forward, per (b, g), f32 throughout: pivot = the slab's first element,
//            m = pivot + mean(x - pivot), var = mean((x - m)^2) over a
//            second pass (never E[x^2] - m^2), r = 1 / sqrt(var + eps),
//            y = (x - m) r w[c] + b[c], SiLU in f32 when asked, one
//            rounding to x's dtype at the store; mean and rstd (B * G) f32
//            are saved for the backward.
//   backward: xhat = (x - m) r from the saved statistics; with SiLU
//            z = xhat w + b, s = sigmoid(z), dz = g s (1 + z (1 - s)), else
//            dz = g; dwp[b, c] = sum dz xhat and dbp[b, c] = sum dz over the
//            channel's HW elements, f32 (the caller sums them over B);
//            dxhat = dz w, dx = r (dxhat - mean(dxhat) - xhat mean(dxhat
//            xhat)) over the slab, rounded once to x's dtype.
//
// What bounds it: bytes. A few flops per element against the card's ~295
// flops per byte. The design is the simple, right first version: one block
// of 512 threads owns one (b, g) slab and makes its passes over it (three
// reads in the forward, two reads of x and g in the backward). A slab
// reaches 30 x 64 x 64 = 122,880 elements (240 KB in bf16), more than the
// 227 KB of shared memory a block can have, so every pass streams from
// global memory and the repeat passes lean on the 50 MB L2. A slab is
// walked in work items of one channel by 32 x V elements (V = 8 with
// 16-byte vector accesses when HW is a multiple of 8, else V = 1), warp w
// taking items w, w + 16, ...: w[c] and b[c] are uniform across a warp,
// and any HW works, down to the 8 x 8 maps. The backward's per-channel
// sums are warp shuffles added into the warp's own row of shared memory
// (channel tiles of 64), then summed over warps in warp order: no atomics,
// and the result does not depend on scheduling. Left to later work: a
// group split over several blocks (B * G = 256 blocks is under two per
// SM), one-read variants for slabs that fit shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileC = 64;   // channels per tile of backward partials

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

// V consecutive elements as f32 (V = 8: 16-byte aligned vector accesses)
template <typename T, int V>
struct Pack;

template <typename T>
struct Pack<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float* f) {
    f[0] = to_f(*p);
  }
  static __device__ __forceinline__ void store(T* p, const float* f) {
    *p = from_f<T>(f[0]);
  }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Pack<float, 8> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block sums of (a, b), the same value in every thread (each thread adds
// the warps' sums in warp order). red holds 2 * kWarps floats.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    sa += red[i];
    sb += red[kWarps + i];
  }
  return make_float2(sa, sb);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// grid B * G, one block per (b, g)
template <typename TX, typename TW, int V>
__global__ void __launch_bounds__(kThreads)
    gn_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  const TW* __restrict__ bias, TX* __restrict__ out,
                  float* __restrict__ mean, float* __restrict__ rstd, int G,
                  int cg, int HW, float eps, int silu) {
  __shared__ float red[2 * kWarps];
  const int bg = blockIdx.x;
  const int c0 = (bg % G) * cg;
  const size_t n = static_cast<size_t>(cg) * HW;
  const TX* xs = x + static_cast<size_t>(bg) * n;
  TX* os = out + static_cast<size_t>(bg) * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int per = 32 * V;
  const int chunks = (HW + per - 1) / per;
  const int items = cg * chunks;
  const float inv_n = 1.f / static_cast<float>(n);
  float f[V];

  const float pivot = to_f(xs[0]);
  float s = 0.f;
  for (int it = warp; it < items; it += kWarps) {
    const int c = it / chunks;
    const int e = (it - c * chunks) * per + lane * V;
    if (e < HW) {
      Pack<TX, V>::load(xs + static_cast<size_t>(c) * HW + e, f);
#pragma unroll
      for (int v = 0; v < V; ++v) s += f[v] - pivot;
    }
  }
  const float m = pivot + block_sum2(s, 0.f, red).x * inv_n;

  float q = 0.f;
  for (int it = warp; it < items; it += kWarps) {
    const int c = it / chunks;
    const int e = (it - c * chunks) * per + lane * V;
    if (e < HW) {
      Pack<TX, V>::load(xs + static_cast<size_t>(c) * HW + e, f);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = f[v] - m;
        q += d * d;
      }
    }
  }
  const float r = 1.f / sqrtf(block_sum2(q, 0.f, red).x * inv_n + eps);

  for (int it = warp; it < items; it += kWarps) {
    const int c = it / chunks;
    const int e = (it - c * chunks) * per + lane * V;
    if (e < HW) {
      const float wc = to_f(w[c0 + c]);
      const float bc = to_f(bias[c0 + c]);
      const size_t off = static_cast<size_t>(c) * HW + e;
      Pack<TX, V>::load(xs + off, f);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float y = (f[v] - m) * r * wc + bc;
        if (silu) y = y * sigmoid(y);
        f[v] = y;
      }
      Pack<TX, V>::store(os + off, f);
    }
  }
  if (threadIdx.x == 0) {
    mean[bg] = m;
    rstd[bg] = r;
  }
}

// dz of one element from x, g and the channel's w, b
__device__ __forceinline__ float dz_of(float xh, float gv, float wc, float bc,
                                       int silu) {
  if (!silu) return gv;
  const float z = xh * wc + bc;
  const float sg = sigmoid(z);
  return gv * (sg * (1.f + z * (1.f - sg)));
}

// grid B * G, one block per (b, g); dwp and dbp are (B, C) f32
template <typename TX, typename TW, int V>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  const TW* __restrict__ bias, const float* __restrict__ mean,
                  const float* __restrict__ rstd, const TX* __restrict__ gy,
                  TX* __restrict__ dx, float* __restrict__ dwp,
                  float* __restrict__ dbp, int G, int cg, int HW, int silu) {
  __shared__ float red[2 * kWarps];
  __shared__ float part[2 * kWarps * kTileC];   // per-warp dw, db rows
  const int bg = blockIdx.x;
  const int C = G * cg;
  const int c0 = (bg % G) * cg;
  const size_t n = static_cast<size_t>(cg) * HW;
  const size_t base = static_cast<size_t>(bg) * n;
  const TX* xs = x + base;
  const TX* gs = gy + base;
  TX* dxs = dx + base;
  float* dw_row = dwp + static_cast<size_t>(bg / G) * C + c0;
  float* db_row = dbp + static_cast<size_t>(bg / G) * C + c0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int per = 32 * V;
  const int chunks = (HW + per - 1) / per;
  const float m = mean[bg];
  const float r = rstd[bg];
  float* pdw = part + warp * kTileC;
  float* pdb = part + (kWarps + warp) * kTileC;
  float fx[V], fg[V];

  // pass 1: the channel sums of dz xhat and dz, and the slab sums of dxhat
  // and dxhat xhat, one tile of channels at a time
  float s1 = 0.f, s2 = 0.f;
  for (int t0 = 0; t0 < cg; t0 += kTileC) {
    const int nc = min(kTileC, cg - t0);
    for (int c = lane; c < nc; c += 32) {
      pdw[c] = 0.f;
      pdb[c] = 0.f;
    }
    __syncwarp();
    for (int it = warp; it < nc * chunks; it += kWarps) {
      const int cl = it / chunks;
      const int c = t0 + cl;
      const int e = (it - cl * chunks) * per + lane * V;
      float a_dw = 0.f, a_db = 0.f;
      if (e < HW) {
        const float wc = to_f(w[c0 + c]);
        const float bc = to_f(bias[c0 + c]);
        const size_t off = static_cast<size_t>(c) * HW + e;
        Pack<TX, V>::load(xs + off, fx);
        Pack<TX, V>::load(gs + off, fg);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xh = (fx[v] - m) * r;
          const float dz = dz_of(xh, fg[v], wc, bc, silu);
          a_dw += dz * xh;
          a_db += dz;
          const float dxh = dz * wc;
          s1 += dxh;
          s2 += dxh * xh;
        }
      }
      a_dw = warp_sum(a_dw);
      a_db = warp_sum(a_db);
      if (lane == 0) {
        pdw[cl] += a_dw;
        pdb[cl] += a_db;
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += kThreads) {
      float a = 0.f, b = 0.f;
      for (int k = 0; k < kWarps; ++k) {
        a += part[k * kTileC + c];
        b += part[(kWarps + k) * kTileC + c];
      }
      dw_row[t0 + c] = a;
      db_row[t0 + c] = b;
    }
    __syncthreads();
  }
  const float2 mu = block_sum2(s1, s2, red);
  const float inv_n = 1.f / static_cast<float>(n);
  const float mu1 = mu.x * inv_n;
  const float mu2 = mu.y * inv_n;

  // pass 2: dx
  const int items = cg * chunks;
  for (int it = warp; it < items; it += kWarps) {
    const int c = it / chunks;
    const int e = (it - c * chunks) * per + lane * V;
    if (e < HW) {
      const float wc = to_f(w[c0 + c]);
      const float bc = to_f(bias[c0 + c]);
      const size_t off = static_cast<size_t>(c) * HW + e;
      Pack<TX, V>::load(xs + off, fx);
      Pack<TX, V>::load(gs + off, fg);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xh = (fx[v] - m) * r;
        const float dxh = dz_of(xh, fg[v], wc, bc, silu) * wc;
        fx[v] = r * (dxh - mu1 - xh * mu2);
      }
      Pack<TX, V>::store(dxs + off, fx);
    }
  }
}

template <typename TX, typename TW, int V>
cudaError_t fwd(const void* x, const void* w, const void* b, void* out,
                void* mean, void* rstd, int B, int G, int cg, int HW,
                float eps, int silu, cudaStream_t s) {
  gn_fwd_kernel<TX, TW, V><<<B * G, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const TW*>(b), static_cast<TX*>(out),
      static_cast<float*>(mean), static_cast<float*>(rstd), G, cg, HW, eps,
      silu);
  return cudaGetLastError();
}

template <typename TX, typename TW, int V>
cudaError_t bwd(const void* x, const void* w, const void* b, const void* mean,
                const void* rstd, const void* gy, void* dx, void* dwp,
                void* dbp, int B, int G, int cg, int HW, int silu,
                cudaStream_t s) {
  gn_bwd_kernel<TX, TW, V><<<B * G, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const TW*>(b), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const TX*>(gy),
      static_cast<TX*>(dx), static_cast<float*>(dwp),
      static_cast<float*>(dbp), G, cg, HW, silu);
  return cudaGetLastError();
}

bool bad_shape(int B, int C, int G, int HW, int vec) {
  return B < 1 || G < 1 || C < G || C % G != 0 || HW < 1 ||
         static_cast<long long>(B) * G > 2147483647LL ||
         (vec && HW % 8 != 0);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, for x (and out, g, dx) and for w
// (and b). vec 1: HW % 8 == 0 and every pointer 16-byte aligned (the
// caller checks), 16-byte vector accesses; vec 0: one element at a time.
// Returns a cudaError_t.
extern "C" int group_norm_fwd_launch(const void* x, const void* w,
                                     const void* b, void* out, void* mean,
                                     void* rstd, int B, int C, int G, int HW,
                                     float eps, int silu, int x_dtype,
                                     int w_dtype, int vec, void* stream) {
  if (bad_shape(B, C, G, HW, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const int cg = C / G;
#define PTT_GN_FWD(TX, TW)                                                 \
  (vec ? fwd<TX, TW, 8>(x, w, b, out, mean, rstd, B, G, cg, HW, eps, silu, \
                        s)                                                 \
       : fwd<TX, TW, 1>(x, w, b, out, mean, rstd, B, G, cg, HW, eps, silu, \
                        s))
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == 1 && w_dtype == 1) e = PTT_GN_FWD(bf, bf);
  else if (x_dtype == 0 && w_dtype == 0) e = PTT_GN_FWD(float, float);
  else if (x_dtype == 1 && w_dtype == 0) e = PTT_GN_FWD(bf, float);
  else if (x_dtype == 0 && w_dtype == 1) e = PTT_GN_FWD(float, bf);
#undef PTT_GN_FWD
  return static_cast<int>(e);
}

// gy and dx have x's dtype; dwp and dbp are (B, C) f32 partials.
extern "C" int group_norm_bwd_launch(const void* x, const void* w,
                                     const void* b, const void* mean,
                                     const void* rstd, const void* gy,
                                     void* dx, void* dwp, void* dbp, int B,
                                     int C, int G, int HW, int silu,
                                     int x_dtype, int w_dtype, int vec,
                                     void* stream) {
  if (bad_shape(B, C, G, HW, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const int cg = C / G;
#define PTT_GN_BWD(TX, TW)                                                   \
  (vec ? bwd<TX, TW, 8>(x, w, b, mean, rstd, gy, dx, dwp, dbp, B, G, cg, HW, \
                        silu, s)                                             \
       : bwd<TX, TW, 1>(x, w, b, mean, rstd, gy, dx, dwp, dbp, B, G, cg, HW, \
                        silu, s))
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == 1 && w_dtype == 1) e = PTT_GN_BWD(bf, bf);
  else if (x_dtype == 0 && w_dtype == 0) e = PTT_GN_BWD(float, float);
  else if (x_dtype == 1 && w_dtype == 0) e = PTT_GN_BWD(bf, float);
  else if (x_dtype == 0 && w_dtype == 1) e = PTT_GN_BWD(float, bf);
#undef PTT_GN_BWD
  return static_cast<int>(e);
}
