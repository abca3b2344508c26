// GroupNorm (+SiLU) forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/group_norm.py: gn_fwd
// (_fwd_kernel) and gn_bwd (_bwd_kernel). x is (B, C, *spatial),
// contiguous, HW = prod(spatial); the cg = C / G channels of group g of
// sample b are one contiguous slab of n = cg * HW elements (NCHW as the
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
//            channel's HW elements, f32; dxhat = dz w, dx = r (dxhat -
//            mean(dxhat) - xhat mean(dxhat xhat)) over the slab, rounded
//            once to x's dtype; then gn_dwdb_reduce_kernel sums dwp and dbp
//            over the batch in batch order and rounds once to w's dtype.
//
// What bounds it: bytes in principle (one read of x and g, one write of
// the output, at 3.35 TB/s), and on this card also the instruction issue:
// with SiLU each element costs a sigmoid (the special-function unit's exp2
// and reciprocal) and a few dozen other instructions, and the forward's
// and backward's sums are barriers between phases that a single wave of
// blocks crosses together. The design:
//   * Cluster route (gn_fwd_cluster_kernel, gn_bwd_cluster_kernel). A
//     thread-block cluster of K = 1, 2, 4 or 8 blocks of 256 threads owns
//     one (b, g) slab; block `rank` takes the contiguous elements [rank
//     per, (rank + 1) per) (per = ceil(n / K) rounded up to 8) and copies
//     its x share into shared memory once with 16-byte cp.async, all
//     copies in flight at once. Slab sums go through distributed shared
//     memory: each block writes its partial, the cluster meets at a
//     barrier, and lane q < K of warp 0 reads block q's partial, lane 0
//     adds them in rank order, so every block holds the same m, r (or
//     mean(dxhat), mean(dxhat xhat)). The forward makes two such rounds
//     (mean, then the centred variance, both over shared memory) and writes
//     y once. The backward keeps only x in shared memory (2 bytes an
//     element in bf16, so the UNet's widest step fits one wave of blocks):
//     each warp walks a contiguous run of its share; a lane copies its own
//     x vectors in cp.async groups (pass 1 starts on the first while the
//     rest arrive) and reads g straight into registers kRing steps ahead
//     of its arithmetic; pass 1 sums dz
//     xhat and dz per channel (a lane adds a channel's terms in registers,
//     the warp sums them when the channel changes, then over warps in warp
//     order), and the slab sums of dxhat and dxhat xhat follow from those
//     channel sums times w[c]; a channel that spans blocks is written by
//     the block holding its first element, which adds the others' partials
//     in rank order. Pass 2 recomputes dxhat from x in shared memory and g
//     read again (the L2 still holds it) and writes dx once: a second
//     sigmoid costs less than the shared memory that keeping dxhat would
//     take. No atomics anywhere: results repeat bit for bit. K is chosen
//     by the caller from the shape (ops/kernels/group_norm.py `route`):
//     the fewest blocks whose share fits 48 KB and that give the 132 SMs
//     a block each, so the 8 x 8 maps run one block a slab.
//   * Streaming route (gn_fwd_stream_kernel, gn_bwd_stream_kernel), for a
//     slab whose share does not fit shared memory even at K = 8 with two
//     blocks an SM (slabs of more than about 450 K bf16 elements, off
//     every main path): one block of 512 threads streams its (b, g) slab
//     from device memory, three reads in the forward and two of x and g in
//     the backward, walking work items of one channel by 32 x V elements.
// Both routes read and write 16 bytes a thread when HW is a multiple of 8
// and the pointers are 16-byte aligned, else one element at a time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace coop = cooperative_groups;

namespace {

// streaming route
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
    gn_fwd_stream_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
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
    gn_bwd_stream_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
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


// -- cluster route -----------------------------------------------------------

constexpr int kCThreads = 256;
constexpr int kCWarps = kCThreads / 32;
// most dynamic shared memory a cluster-route block may ask for: two blocks
// an SM (ops/kernels/group_norm.py _SMEM_MAX mirrors it)
constexpr int kCSmemMax = 110 * 1024;

// elements of a block's share: ceil(n / K) rounded up to 8, so a share
// starts 16-byte aligned (mirrored by group_norm.py _per)
__host__ __device__ inline int share_of(int n, int K) {
  return ((n + K - 1) / K + 7) / 8 * 8;
}
// channels a share of `per` elements can touch
__host__ __device__ inline int channels_of(int per, int HW) {
  return (per - 1) / HW + 2;
}
__host__ __device__ inline int align16(int b) { return (b + 15) / 16 * 16; }
// dynamic shared memory of a block (mirrored by group_norm.py _smem): the
// x share and a table of its channels' two affine constants; in the
// backward also the per-warp and per-block (dw, db) rows of its channels
__host__ __device__ inline int cluster_smem(int per, int esz, int HW,
                                            bool bwd) {
  const int rows = bwd ? kCWarps + 2 : 1;
  return align16(per * esz) + rows * channels_of(per, HW) * 8;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's cp.async groups are pending (at
// most 7: a larger n waits for more than it must, never for less).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// the cluster barrier in two halves: arrive (release this block's shared
// memory writes) and wait (acquire the others'). A plain launch is a
// cluster of one.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (a, b) summed over the cluster's blocks in rank order, the same value in
// every thread: lane q < K of warp 0 reads block q's pair from its shared
// memory, lane 0 adds them in rank order, and the block reads the sums
// from `tot` in its own shared memory.
__device__ __forceinline__ float2 cluster_sum2(float2* part, int K,
                                               float2* tot) {
  if (threadIdx.x < 32) {
    float2 v = make_float2(0.f, 0.f);
    if (static_cast<int>(threadIdx.x) < K)
      v = *coop::this_cluster().map_shared_rank(part, threadIdx.x);
    float a = 0.f, b = 0.f;
    for (int q = 0; q < K; ++q) {
      a += __shfl_sync(0xffffffffu, v.x, q);
      b += __shfl_sync(0xffffffffu, v.y, q);
    }
    if (threadIdx.x == 0) *tot = make_float2(a, b);
  }
  __syncthreads();
  return *tot;
}

// One 16-byte vector (V = 8 bf16 or 4 f32) or, unvectorized, one element:
// its raw form and its f32 values.
template <typename TX, bool kVec>
struct Vec;

template <>
struct Vec<__nv_bfloat16, true> {
  static constexpr int V = 8;
  using Raw = uint4;
  // bf16 is the high half of an f32: one shift or mask an element
  static __device__ __forceinline__ void unpack(const Raw& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    Raw u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <>
struct Vec<float, true> {
  static constexpr int V = 4;
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& u, float* f) {
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename TX>
struct Vec<TX, false> {
  static constexpr int V = 1;
  using Raw = TX;
  static __device__ __forceinline__ void unpack(const Raw& u, float* f) {
    f[0] = to_f(u);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return from_f<TX>(f[0]);
  }
};

// Copy len elements from global src to shared dst (16-byte cp.async, all
// in flight; or plain loads one element at a time), then a block barrier.
template <typename TX, bool kVec>
__device__ __forceinline__ void stage(TX* dst, const TX* src, int len) {
  if constexpr (kVec) {
    constexpr int V = Vec<TX, true>::V;
    for (int i = threadIdx.x; i < len / V; i += blockDim.x)
      cp_async16(dst + i * V, src + i * V);
    cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
}

// Block sums of (a, b) in warp order, the same value in every thread; red
// holds 2 * kCWarps floats.
__device__ __forceinline__ float2 cblock_sum2(float a, float b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[warp] = a;
    red[kCWarps + warp] = b;
  }
  __syncthreads();
  float sa = 0.f, sb = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) {
    sa += red[i];
    sb += red[kCWarps + i];
  }
  return make_float2(sa, sb);
}

// sigmoid from the special-function unit's exp2 and reciprocal (ex2 with
// subnormal results flushed to 0, where sigmoid is 1 to f32 precision)
__device__ __forceinline__ float fast_sigmoid(float z) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z * -1.4426950408889634f));
  return __fdividef(1.f, 1.f + e);
}

// The channel (relative to `c0`) and the offset in it of element e, kept up
// to date along a loop that steps `step` elements at a time: one division
// when the loop starts, none per step.
struct ChanWalk {
  int c, rem, dc, dr, HW;
  __device__ __forceinline__ ChanWalk(int e, int c0, int step, int hw)
      : c(e / hw - c0), rem(e % hw), dc(step / hw), dr(step % hw), HW(hw) {}
  __device__ __forceinline__ void next() {
    c += dc;
    rem += dr;
    if (rem >= HW) {
      rem -= HW;
      ++c;
    }
  }
};

// grid B * G * K in clusters of K along x (one cluster a slab), kCThreads
// threads, cluster_smem(per, sizeof(TX), HW, false) bytes of
// dynamic shared memory.
template <typename TX, typename TW, bool kVec>
__global__ void __launch_bounds__(kCThreads, 4)
    gn_fwd_cluster_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                          const TW* __restrict__ bias, TX* __restrict__ out,
                          float* __restrict__ mean, float* __restrict__ rstd,
                          int G, int cg, int HW, int K, int per, float eps,
                          int silu) {
  using Vx = Vec<TX, kVec>;
  constexpr int V = Vx::V;
  using Raw = typename Vx::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * kCWarps];
  __shared__ float2 part[2];   // this block's sums, read by the cluster
  __shared__ float2 tot;
  TX* sx = reinterpret_cast<TX*>(smem);
  float* chan = reinterpret_cast<float*>(smem + align16(per * sizeof(TX)));
  const int rank = static_cast<int>(coop::this_cluster().block_rank());
  const int bg = blockIdx.x / K;
  const int c0 = (bg % G) * cg;
  const int n = cg * HW;
  const size_t base = static_cast<size_t>(bg) * n;
  const int s0 = rank * per;
  const int len = max(0, min(per, n - s0));
  const int cfirst = s0 / HW;
  const float inv_n = 1.f / static_cast<float>(n);
  const int step = static_cast<int>(blockDim.x) * V;
  float f[V], acc[V];

  stage<TX, kVec>(sx, x + base + s0, len);
  const float pivot = to_f(x[base]);
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x * V; i < len; i += step) {
    Vx::unpack(*reinterpret_cast<const Raw*>(sx + i), f);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += f[v] - pivot;
  }
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) s += acc[v];
  s = cblock_sum2(s, 0.f, red).x;
  if (threadIdx.x == 0) part[0] = make_float2(s, 0.f);
  cluster_arrive();
  cluster_wait();
  const float m = pivot + cluster_sum2(part, K, &tot).x * inv_n;

#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x * V; i < len; i += step) {
    Vx::unpack(*reinterpret_cast<const Raw*>(sx + i), f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = f[v] - m;
      acc[v] += d * d;
    }
  }
  float q = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) q += acc[v];
  q = cblock_sum2(q, 0.f, red).x;
  if (threadIdx.x == 0) part[1] = make_float2(q, 0.f);
  cluster_arrive();
  cluster_wait();
  const float r =
      1.f / sqrtf(cluster_sum2(part + 1, K, &tot).x * inv_n + eps);
  cluster_arrive();   // done reading the other blocks' shared memory

  // y = (x - m) (r w[c]) + b[c] from a table of the share's channels
  for (int c = threadIdx.x; c < channels_of(per, HW); c += blockDim.x) {
    if (cfirst + c < cg) {
      chan[2 * c] = r * to_f(w[c0 + cfirst + c]);
      chan[2 * c + 1] = to_f(bias[c0 + cfirst + c]);
    }
  }
  __syncthreads();
  TX* os = out + base + s0;
  ChanWalk cw(s0 + threadIdx.x * V, cfirst, step, HW);
#pragma unroll 4
  for (int i = threadIdx.x * V; i < len; i += step) {
    const float rw = chan[2 * cw.c];
    const float bc = chan[2 * cw.c + 1];
    Vx::unpack(*reinterpret_cast<const Raw*>(sx + i), f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float y = (f[v] - m) * rw + bc;
      if (silu) y = y * fast_sigmoid(y);
      f[v] = y;
    }
    *reinterpret_cast<Raw*>(os + i) = Vx::pack(f);
    cw.next();
  }
  if (rank == 0 && threadIdx.x == 0) {
    mean[bg] = m;
    rstd[bg] = r;
  }
  cluster_wait();
}

// steps of 32 vectors of g a warp keeps in flight ahead of its arithmetic
constexpr int kRing = 4;

// grid B * G * K in clusters of K along x, kCThreads threads,
// cluster_smem(per, sizeof(TX), HW, true) bytes of dynamic shared
// memory; dwp and dbp are (B, C) f32.
template <typename TX, typename TW, bool kVec>
__global__ void __launch_bounds__(kCThreads, 4)
    gn_bwd_cluster_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                          const TW* __restrict__ bias,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const TX* __restrict__ gy, TX* __restrict__ dx,
                          float* __restrict__ dwp, float* __restrict__ dbp,
                          int G, int cg, int HW, int K, int per, int silu) {
  using Vx = Vec<TX, kVec>;
  constexpr int V = Vx::V;
  using Raw = typename Vx::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * kCWarps];
  __shared__ float2 part;   // this block's sums of dxhat, dxhat xhat
  __shared__ float2 tot;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nloc = channels_of(per, HW);
  TX* sx = reinterpret_cast<TX*>(smem);
  float* wpart = reinterpret_cast<float*>(smem + align16(per * sizeof(TX)));
  float* bpart = wpart + nw * nloc * 2;   // [nloc] x (dw, db)
  float* chan = bpart + nloc * 2;         // [nloc] x (w, b)
  coop::cluster_group cluster = coop::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bg = blockIdx.x / K;
  const int C = G * cg;
  const int c0 = (bg % G) * cg;
  const int n = cg * HW;
  const size_t base = static_cast<size_t>(bg) * n;
  const int s0 = rank * per;
  const int len = max(0, min(per, n - s0));
  const int cfirst = s0 / HW;
  const TX* gs = gy + base + s0;

  // Both passes walk each warp's contiguous run of vectors [v0, v1), 32 at
  // a step, and a lane touches only its own vectors of x: it copies them
  // into shared memory itself, one cp.async group for each kRing steps,
  // so pass 1 starts on the first group while the rest arrive.
  const int nvec = len / V;
  const int v0 = warp * nvec / nw, v1 = (warp + 1) * nvec / nw;
  const int steps = (v1 - v0 + 31) / 32;
  const int ngroups = (steps + kRing - 1) / kRing;
  for (int st = 0; st < steps; ++st) {
    const int vi = v0 + st * 32 + lane;
    if (vi < v1) {
      if constexpr (kVec)
        cp_async16(sx + vi * V, x + base + s0 + vi * V);
      else
        sx[vi] = x[base + s0 + vi];
    }
    if (st % kRing == kRing - 1 || st == steps - 1) cp_async_commit();
  }
  for (int i = threadIdx.x; i < nw * nloc * 2; i += blockDim.x)
    wpart[i] = 0.f;
  for (int c = threadIdx.x; c < nloc; c += blockDim.x) {
    if (cfirst + c < cg) {
      chan[2 * c] = to_f(w[c0 + cfirst + c]);
      chan[2 * c + 1] = to_f(bias[c0 + cfirst + c]);
    }
  }
  const float m = mean[bg];
  const float r = rstd[bg];
  // the g vectors of the next kRing steps in flight
  Raw ring[kRing];
#pragma unroll
  for (int j = 0; j < kRing; ++j) {
    const int vi = v0 + j * 32 + lane;
    ring[j] = vi < v1 ? __ldg(reinterpret_cast<const Raw*>(gs + vi * V))
                      : Raw{};
  }
  __syncthreads();   // wpart and chan

  // pass 1: the channel sums of dz xhat and dz. A lane adds a channel's
  // terms in registers while the warp's steps stay in that channel, and
  // the warp sums them into its own row of wpart when the channel changes
  // (a step that spans channels is summed channel by channel at once).
  float* wrow = wpart + warp * nloc * 2;
  float a_dw = 0.f, a_db = 0.f;   // this lane's terms of channel `cur`
  int cur = -1;
  auto flush = [&]() {
    if (cur >= 0) {
      const float pd = warp_sum(a_dw);
      const float pb = warp_sum(a_db);
      if (lane == 0) {
        wrow[2 * cur] += pd;
        wrow[2 * cur + 1] += pb;
      }
    }
    a_dw = a_db = 0.f;
  };
  ChanWalk cw(s0 + (v0 + lane) * V, cfirst, 32 * V, HW);
  for (int vb = v0, grp = 0; vb < v1; vb += 32 * kRing, ++grp) {
    cp_async_wait_upto(ngroups - 1 - grp);   // this lane's x of the steps
#pragma unroll
    for (int u = 0; u < kRing; ++u) {
      const int vs = vb + u * 32;
      if (vs >= v1) break;
      const int vi = vs + lane;
      const bool on = vi < v1;
      const Raw graw = ring[u];
      if (vi + 32 * kRing < v1)
        ring[u] = __ldg(
            reinterpret_cast<const Raw*>(gs + (vi + 32 * kRing) * V));
      float pd = 0.f, pb = 0.f;
      if (on) {
        const int e = vi * V;
        const float wc = chan[2 * cw.c];
        const float bc = chan[2 * cw.c + 1];
        float fx[V], fg[V];
        Vx::unpack(*reinterpret_cast<const Raw*>(sx + e), fx);
        Vx::unpack(graw, fg);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xh = (fx[v] - m) * r;
          float dz = fg[v];
          if (silu) {
            const float z = xh * wc + bc;
            const float sg = fast_sigmoid(z);
            dz *= sg * (1.f + z * (1.f - sg));
          }
          pd += dz * xh;
          pb += dz;
        }
      }
      // lanes hold channels in order
      const int lo = __shfl_sync(0xffffffffu, cw.c, 0);
      const int hi = __shfl_sync(0xffffffffu, cw.c, min(31, v1 - vs - 1));
      if (lo == hi) {
        if (lo != cur) {
          flush();
          cur = lo;
        }
        a_dw += pd;
        a_db += pb;
      } else {
        flush();
        cur = -1;
        for (int cc = lo; cc <= hi; ++cc) {
          const bool mine = on && cw.c == cc;
          const float sdw = warp_sum(mine ? pd : 0.f);
          const float sdb = warp_sum(mine ? pb : 0.f);
          if (lane == 0) {
            wrow[2 * cc] += sdw;
            wrow[2 * cc + 1] += sdb;
          }
        }
      }
      cw.next();
    }
  }
  flush();
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * nloc; c += blockDim.x) {
    float a = 0.f;
    for (int k = 0; k < nw; ++k) a += wpart[k * nloc * 2 + c];
    bpart[c] = a;
  }
  __syncthreads();
  // this block's slab sums: sum dxhat = sum_c w[c] db_c and sum dxhat
  // xhat = sum_c w[c] dw_c over its channels (dxhat = dz w[c])
  if (warp == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < nloc; c += 32) {
      if (cfirst + c < cg) {
        s1 += chan[2 * c] * bpart[2 * c + 1];
        s2 += chan[2 * c] * bpart[2 * c];
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) part = make_float2(s1, s2);
  }
  cluster_arrive();
  cluster_wait();
  const float inv_n = 1.f / static_cast<float>(n);
  const float2 mu = cluster_sum2(&part, K, &tot);
  const float mu1 = mu.x * inv_n;
  const float mu2 = mu.y * inv_n;
  // each channel is written by the block holding its first element, which
  // adds the partials of the blocks holding the rest in rank order
  const size_t row = static_cast<size_t>(bg / G) * C + c0;
  for (int cl = threadIdx.x; cl < nloc; cl += blockDim.x) {
    const int cs = cfirst + cl;
    const int first = cs * HW;
    if (len == 0 || cs >= cg || first < s0 || first >= s0 + len) continue;
    const int end = min(n, first + HW);
    float a = 0.f, b = 0.f;
    for (int q = rank; q < K && q * per < end; ++q) {
      const float* p = cluster.map_shared_rank(bpart, q);
      const int idx = cs - (q * per) / HW;
      a += p[2 * idx];
      b += p[2 * idx + 1];
    }
    dwp[row + cs] = a;
    dbp[row + cs] = b;
  }
  cluster_arrive();   // done reading the other blocks' shared memory

  // pass 2: dx = r (dxhat - mu1 - xhat mu2), dxhat again from x in shared
  // memory and g read a second time (the L2 still holds what pass 1 read)
#pragma unroll
  for (int j = 0; j < kRing; ++j) {
    const int vi = v0 + j * 32 + lane;
    ring[j] = vi < v1 ? __ldg(reinterpret_cast<const Raw*>(gs + vi * V))
                      : Raw{};
  }
  TX* ds = dx + base + s0;
  ChanWalk cw2(s0 + (v0 + lane) * V, cfirst, 32 * V, HW);
  for (int vb = v0; vb < v1; vb += 32 * kRing) {
#pragma unroll
    for (int u = 0; u < kRing; ++u) {
      const int vs = vb + u * 32;
      if (vs >= v1) break;
      const int vi = vs + lane;
      const Raw graw = ring[u];
      if (vi + 32 * kRing < v1)
        ring[u] = __ldg(
            reinterpret_cast<const Raw*>(gs + (vi + 32 * kRing) * V));
      if (vi < v1) {
        const int e = vi * V;
        const float wc = chan[2 * cw2.c];
        const float bc = chan[2 * cw2.c + 1];
        float fx[V], fg[V];
        Vx::unpack(*reinterpret_cast<const Raw*>(sx + e), fx);
        Vx::unpack(graw, fg);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xh = (fx[v] - m) * r;
          float dz = fg[v];
          if (silu) {
            const float z = xh * wc + bc;
            const float sg = fast_sigmoid(z);
            dz *= sg * (1.f + z * (1.f - sg));
          }
          fx[v] = r * (dz * wc - mu1 - xh * mu2);
        }
        *reinterpret_cast<Raw*>(ds + e) = Vx::pack(fx);
      }
      cw2.next();
    }
  }
  cluster_wait();
}

// dw[c], db[c] = sums over b of dwp[b, c], dbp[b, c] in batch order,
// rounded once to w's dtype
template <typename TW>
__global__ void gn_dwdb_reduce_kernel(const float* __restrict__ dwp,
                                      const float* __restrict__ dbp,
                                      TW* __restrict__ dw,
                                      TW* __restrict__ db, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, s = 0.f;
  for (int b = 0; b < B; ++b) {
    a += dwp[static_cast<size_t>(b) * C + c];
    s += dbp[static_cast<size_t>(b) * C + c];
  }
  dw[c] = from_f<TW>(a);
  db[c] = from_f<TW>(s);
}

// one launch of a cluster-route kernel: B * G clusters of K blocks
template <typename... KArgs, typename... Args>
cudaError_t cluster_launch(void (*kernel)(KArgs...), bool* opted, int grid,
                           int K, int smem, cudaStream_t s, Args... args) {
  if (!*opted) {   // once per kernel: the most any launch asks for
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCSmemMax);
    if (e != cudaSuccess) return e;
    *opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kCThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K > 1 ? 1 : 0;   // a plain launch is a cluster of one
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the cluster route's launch arguments are valid: K among those the
// kernels take, every block of a cluster holding part of the slab, and the
// shared memory within two blocks an SM
bool bad_cluster(long long n, int HW, int K, int esz, bool bwd) {
  if ((K != 1 && K != 2 && K != 4 && K != 8) || n > (1LL << 30))
    return true;
  const int per = share_of(static_cast<int>(n), K);
  const int smem = cluster_smem(per, esz, HW, bwd);
  return static_cast<long long>(per) * (K - 1) >= n || smem > kCSmemMax;
}


template <typename TX, typename TW, int V>
cudaError_t fwd_stream(const void* x, const void* w, const void* b,
                       void* out, void* mean, void* rstd, int B, int G,
                       int cg, int HW, float eps, int silu, cudaStream_t s) {
  gn_fwd_stream_kernel<TX, TW, V><<<B * G, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const TW*>(b), static_cast<TX*>(out),
      static_cast<float*>(mean), static_cast<float*>(rstd), G, cg, HW, eps,
      silu);
  return cudaGetLastError();
}

template <typename TX, typename TW, bool kVec>
cudaError_t fwd_cluster(const void* x, const void* w, const void* b,
                        void* out, void* mean, void* rstd, int B, int G,
                        int cg, int HW, float eps, int silu, int K,
                        cudaStream_t s) {
  static bool opted = false;
  const int per = share_of(cg * HW, K);
  return cluster_launch(
      gn_fwd_cluster_kernel<TX, TW, kVec>, &opted, B * G * K, K,
      cluster_smem(per, static_cast<int>(sizeof(TX)), HW, false), s, static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const TW*>(b), static_cast<TX*>(out),
      static_cast<float*>(mean), static_cast<float*>(rstd), G, cg, HW, K,
      per, eps, silu);
}

template <typename TX, typename TW>
cudaError_t fwd(const void* x, const void* w, const void* b, void* out,
                void* mean, void* rstd, int B, int G, int cg, int HW,
                float eps, int silu, int vec, int K, cudaStream_t s) {
  if (K == 0)
    return vec ? fwd_stream<TX, TW, 8>(x, w, b, out, mean, rstd, B, G, cg,
                                       HW, eps, silu, s)
               : fwd_stream<TX, TW, 1>(x, w, b, out, mean, rstd, B, G, cg,
                                       HW, eps, silu, s);
  return vec ? fwd_cluster<TX, TW, true>(x, w, b, out, mean, rstd, B, G, cg,
                                         HW, eps, silu, K, s)
             : fwd_cluster<TX, TW, false>(x, w, b, out, mean, rstd, B, G,
                                          cg, HW, eps, silu, K, s);
}

template <typename TX, typename TW, int V>
cudaError_t bwd_stream(const void* x, const void* w, const void* b,
                       const void* mean, const void* rstd, const void* gy,
                       void* dx, void* dwp, void* dbp, int B, int G, int cg,
                       int HW, int silu, cudaStream_t s) {
  gn_bwd_stream_kernel<TX, TW, V><<<B * G, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const TW*>(b), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const TX*>(gy),
      static_cast<TX*>(dx), static_cast<float*>(dwp),
      static_cast<float*>(dbp), G, cg, HW, silu);
  return cudaGetLastError();
}

template <typename TX, typename TW, bool kVec>
cudaError_t bwd_cluster(const void* x, const void* w, const void* b,
                        const void* mean, const void* rstd, const void* gy,
                        void* dx, void* dwp, void* dbp, int B, int G, int cg,
                        int HW, int silu, int K, cudaStream_t s) {
  static bool opted = false;
  const int per = share_of(cg * HW, K);
  return cluster_launch(
      gn_bwd_cluster_kernel<TX, TW, kVec>, &opted, B * G * K, K,
      cluster_smem(per, static_cast<int>(sizeof(TX)), HW, true), s, static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const TW*>(b), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const TX*>(gy),
      static_cast<TX*>(dx), static_cast<float*>(dwp),
      static_cast<float*>(dbp), G, cg, HW, K, per, silu);
}

template <typename TX, typename TW>
cudaError_t bwd(const void* x, const void* w, const void* b, const void* mean,
                const void* rstd, const void* gy, void* dx, void* dwp,
                void* dbp, void* dw, void* db, int B, int G, int cg, int HW,
                int silu, int vec, int K, cudaStream_t s) {
  cudaError_t e;
  if (K == 0)
    e = vec ? bwd_stream<TX, TW, 8>(x, w, b, mean, rstd, gy, dx, dwp, dbp, B,
                                    G, cg, HW, silu, s)
            : bwd_stream<TX, TW, 1>(x, w, b, mean, rstd, gy, dx, dwp, dbp, B,
                                    G, cg, HW, silu, s);
  else
    e = vec ? bwd_cluster<TX, TW, true>(x, w, b, mean, rstd, gy, dx, dwp,
                                        dbp, B, G, cg, HW, silu, K, s)
            : bwd_cluster<TX, TW, false>(x, w, b, mean, rstd, gy, dx, dwp,
                                         dbp, B, G, cg, HW, silu, K, s);
  if (e != cudaSuccess) return e;
  const int C = G * cg;
  gn_dwdb_reduce_kernel<TW><<<(C + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(dwp), static_cast<const float*>(dbp),
      static_cast<TW*>(dw), static_cast<TW*>(db), B, C);
  return cudaGetLastError();
}

// the shape, vectorization and route arguments are ones the kernels take
bool bad_args(int B, int C, int G, int HW, int vec, int K, int x_dtype,
              bool backward) {
  if (B < 1 || G < 1 || C < G || C % G != 0 || HW < 1 ||
      static_cast<long long>(B) * G * (K > 0 ? K : 1) > 2147483647LL ||
      (vec && HW % 8 != 0))
    return true;
  const long long n = static_cast<long long>(C / G) * HW;
  return K != 0 && bad_cluster(n, HW, K, x_dtype == 1 ? 2 : 4, backward);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, for x (and out, g, dx) and for w
// (and b, dw, db). vec 1: HW % 8 == 0 and every pointer 16-byte aligned
// (the caller checks), 16-byte vector accesses; vec 0: one element at a
// time. K 0: the streaming route; K 1, 2, 4 or 8: the cluster route with
// clusters of K blocks. Returns a cudaError_t.
extern "C" int group_norm_fwd_launch(const void* x, const void* w,
                                     const void* b, void* out, void* mean,
                                     void* rstd, int B, int C, int G, int HW,
                                     float eps, int silu, int x_dtype,
                                     int w_dtype, int vec, int K,
                                     void* stream) {
  if (bad_args(B, C, G, HW, vec, K, x_dtype, false))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const int cg = C / G;
#define PTT_GN_FWD(TX, TW) \
  fwd<TX, TW>(x, w, b, out, mean, rstd, B, G, cg, HW, eps, silu, vec, K, s)
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == 1 && w_dtype == 1) e = PTT_GN_FWD(bf, bf);
  else if (x_dtype == 0 && w_dtype == 0) e = PTT_GN_FWD(float, float);
  else if (x_dtype == 1 && w_dtype == 0) e = PTT_GN_FWD(bf, float);
  else if (x_dtype == 0 && w_dtype == 1) e = PTT_GN_FWD(float, bf);
#undef PTT_GN_FWD
  return static_cast<int>(e);
}

// gy and dx have x's dtype; dwp and dbp are (B, C) f32 scratch for the
// per-(b, channel) partials; dw and db (C,) in w's dtype.
extern "C" int group_norm_bwd_launch(const void* x, const void* w,
                                     const void* b, const void* mean,
                                     const void* rstd, const void* gy,
                                     void* dx, void* dwp, void* dbp,
                                     void* dw, void* db, int B, int C, int G,
                                     int HW, int silu, int x_dtype,
                                     int w_dtype, int vec, int K,
                                     void* stream) {
  if (bad_args(B, C, G, HW, vec, K, x_dtype, true))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const int cg = C / G;
#define PTT_GN_BWD(TX, TW)                                                 \
  bwd<TX, TW>(x, w, b, mean, rstd, gy, dx, dwp, dbp, dw, db, B, G, cg, HW, \
              silu, vec, K, s)
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == 1 && w_dtype == 1) e = PTT_GN_BWD(bf, bf);
  else if (x_dtype == 0 && w_dtype == 0) e = PTT_GN_BWD(float, float);
  else if (x_dtype == 1 && w_dtype == 0) e = PTT_GN_BWD(bf, float);
  else if (x_dtype == 0 && w_dtype == 1) e = PTT_GN_BWD(float, bf);
#undef PTT_GN_BWD
  return static_cast<int>(e);
}
