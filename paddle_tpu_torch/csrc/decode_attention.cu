// Single-token GQA cache attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/decode_attention.py
// (decode_attention / _kernel): q (B, H, D) against the padded head-major
// cache kc/vc (B, KV, L, D), the rep = H / KV query heads of one KV head
// sharing every K/V row, online softmax in f32, each row b reading only
// its valid prefix [0, lens[b]). Optional int8 K/V with per-row f32 scales
// (B, KV, L, 1), dequantized in registers.
//
// What bounds it: bytes. Each (b, kv-head) streams lens[b] * D elements of
// K and of V once and does 4 * rep * D flops per cached row, far below the
// card's ~295 flops per byte balance point. So the design is about keeping
// many loads in flight with no block-wide barrier in the stream:
// - one block of 8 warps per (b, kv-head) (the TPU grid's (B, KV); its L
//   grid axis becomes the row loop inside the block);
// - a row of D elements is split over G = D/8 lanes (rounded up to a power
//   of two), 8 elements and one 8..32-byte load each, so a warp holds
//   32 / G rows at once and the block 8 * 32 / G;
// - every lane group keeps its own online-softmax state (running max, sum
//   and its 8-element slice of the rep accumulators) in registers and
//   walks its rows kUnroll at a time, all K and V loads of a step issued
//   before any math; the rep query slices live in registers too;
// - groups merge once at the end: shuffles inside a warp, shared memory
//   across warps;
// - the row loop stops at lens[b], read on the device, so cache rows past
//   a row's prefix are neither read nor computed (the TPU kernel still
//   copies them). Scores use exp2 with log2(e) folded into q's scale.
// Known limit, left to a later change: B * KV blocks (32 on the served
// model) use 32 of the 132 SMs; a split-L pass (flash-decoding) would
// spread long rows over more of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;
constexpr int kUnroll = 4;  // rows per lane group per step
constexpr float kLog2e = 1.4426950408889634f;

// Eight consecutive elements of one cache row, as loaded (8-element
// aligned): 32 bytes of f32, 16 of bf16, 8 of int8.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
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
};

template <>
struct Chunk<int8_t> {
  uint2 u;
  __device__ __forceinline__ void zero() { u = make_uint2(0u, 0u); }
  __device__ __forceinline__ void load(const int8_t* p) {
    u = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void get(float* f) const {
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = static_cast<float>(
          static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xff));
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// exp2 offsets that stay finite while a state has seen no row yet
__device__ __forceinline__ float safe_base(float m) {
  return m == -INFINITY ? 0.f : m;
}

// grid (KV, B), kThreads threads. G = lanes per cache row (a power of two
// >= D / 8); lanes gl >= D / 8 of a group hold no slice and stay idle.
// REP >= rep is the register-array bound. Dynamic shared memory (floats):
// acc kWarps*rep*D | m kWarps*rep | l kWarps*rep.
template <typename TQ, typename TKV, int REP>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kc,
    const TKV* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ lens,
    TQ* __restrict__ out, int H, int KV, int L, int D, int G,
    float qscale) {
  extern __shared__ float smem[];
  const int rep = H / KV;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane % G;                    // slice within the row
  const int gpw = 32 / G;                     // row groups per warp
  const int gid = warp * gpw + lane / G;      // row group in the block
  const int ng = kWarps * gpw;                // row groups in the block
  const bool has_slice = gl * 8 < D;
  const int len = max(0, min(lens[b], L));
  const size_t row0 = (static_cast<size_t>(b) * KV + g) * L;
  const size_t qoff =
      (static_cast<size_t>(b) * H + static_cast<size_t>(g) * rep) * D;

  float qr[REP][8], acc[REP][8], m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[r][c] = 0.f;
      qr[r][c] = (r < rep && has_slice)
                     ? to_f(q[qoff + r * D + gl * 8 + c]) * qscale
                     : 0.f;
    }
  }

  for (int base = 0; base < len; base += kUnroll * ng) {
    Chunk<TKV> kch[kUnroll], vch[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * ng + gid;
      ok[u] = j < len;
      ksc[u] = vsc[u] = 1.f;
      if (ok[u] && has_slice) {
        const size_t off = (row0 + j) * D + gl * 8;
        kch[u].load(kc + off);
        vch[u].load(vc + off);
        if (ks != nullptr) {
          ksc[u] = __ldg(ks + row0 + j);
          vsc[u] = __ldg(vs + row0 + j);
        }
      } else {
        kch[u].zero();
        vch[u].zero();
      }
    }
    float s[kUnroll][REP];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[8];
      kch[u].get(kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float t = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) t += qr[r][c] * kf[c];
        s[u][r] = t * ksc[u];
      }
    }
    // whole-row scores: sum the slices over the G lanes of each group
    for (int o = 1; o < G; o <<= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int r = 0; r < REP; ++r)
          s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], o);
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) break;
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][r]);
      const float bse = safe_base(mx);
      const float corr = exp2f(m[r] - bse);
      float p[kUnroll];
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float e = ok[u] ? exp2f(s[u][r] - bse) : 0.f;
        sum += e;
        p[u] = e * vsc[u];   // int8 V: its row scale rides on p
      }
      l[r] = l[r] * corr + sum;
      m[r] = mx;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float vf[8];
        vch[u].get(vf);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] += p[u] * vf[c];
      }
    }
  }

  // merge the row groups of a warp (lanes G, 2G, ... apart) ...
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float bse = safe_base(mn);
      const float cs = exp2f(m[r] - bse), co = exp2f(mo - bse);
      l[r] = l[r] * cs + lo * co;
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][c], o);
        acc[r][c] = acc[r][c] * cs + ao * co;
      }
    }
  }
  // ... then the warps, through shared memory
  float* sa = smem;                       // [kWarps][rep][D]
  float* sm = sa + kWarps * rep * D;      // [kWarps][rep]
  float* sl = sm + kWarps * rep;          // [kWarps][rep]
  if (lane < G && has_slice) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r < rep) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          sa[(warp * rep + r) * D + gl * 8 + c] = acc[r][c];
        if (lane == 0) {
          sm[warp * rep + r] = m[r];
          sl[warp * rep + r] = l[r];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w * rep + r]);
    const float bse = safe_base(mx);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sm[w * rep + r] - bse);
      num += sa[(w * rep + r) * D + d] * c;
      den += sl[w * rep + r] * c;
    }
    // an empty prefix (lens[b] == 0) gives 0 / 0 = NaN, as the TPU
    // kernel's acc / l does
    store_f(num / den, out + qoff + i);
  }
}

template <typename TQ, typename TKV, int REP>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* ks, const void* vs, const void* lens,
                   void* out, int B, int H, int KV, int L, int D,
                   cudaStream_t stream) {
  const int rep = H / KV;
  int G = 1;
  while (G * 8 < D) G <<= 1;
  const size_t smem = sizeof(float) * kWarps * rep * (D + 2);
  auto kernel = decode_attention_kernel<TQ, TKV, REP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kc),
      static_cast<const TKV*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lens),
      static_cast<TQ*>(out), H, KV, L, D, G,
      kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_rep(const void* q, const void* kc, const void* vc,
                       const void* ks, const void* vs, const void* lens,
                       void* out, int B, int H, int KV, int L, int D,
                       cudaStream_t s) {
  const int rep = H / KV;
  if (rep <= 1)
    return launch<TQ, TKV, 1>(q, kc, vc, ks, vs, lens, out, B, H, KV, L, D, s);
  if (rep <= 2)
    return launch<TQ, TKV, 2>(q, kc, vc, ks, vs, lens, out, B, H, KV, L, D, s);
  if (rep <= 4)
    return launch<TQ, TKV, 4>(q, kc, vc, ks, vs, lens, out, B, H, KV, L, D, s);
  if (rep <= 8)
    return launch<TQ, TKV, 8>(q, kc, vc, ks, vs, lens, out, B, H, KV, L, D, s);
  return launch<TQ, TKV, kMaxRep>(q, kc, vc, ks, vs, lens, out, B, H, KV, L,
                                  D, s);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (K/V only; then ks/vs are
// the (B, KV, L, 1) f32 scales, otherwise null). Returns a cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* ks,
                                       const void* vs, const void* lens,
                                       void* out, int B, int H, int KV,
                                       int L, int D, int q_dtype,
                                       int kv_dtype, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxRep || D % 8 != 0 ||
      D < 8 || D > 256 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == 0 && kv_dtype == 0)
    e = launch_rep<float, float>(q, kc, vc, nullptr, nullptr, lens, out, B,
                                 H, KV, L, D, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    e = launch_rep<__nv_bfloat16, __nv_bfloat16>(
        q, kc, vc, nullptr, nullptr, lens, out, B, H, KV, L, D, s);
  else if (q_dtype == 0 && kv_dtype == 2)
    e = launch_rep<float, int8_t>(q, kc, vc, ks, vs, lens, out, B, H, KV, L,
                                  D, s);
  else if (q_dtype == 1 && kv_dtype == 2)
    e = launch_rep<__nv_bfloat16, int8_t>(q, kc, vc, ks, vs, lens, out, B, H,
                                          KV, L, D, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
