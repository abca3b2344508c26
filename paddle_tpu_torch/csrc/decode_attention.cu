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
// card's ~295 flops per byte balance point. On the served model (B 8, KV 4,
// L 256) that is 32 (b, kv-head) pairs of at most 64 KB each: a block per
// pair would use a quarter of the 132 SMs and wait on DRAM in dependent
// rounds. So the cache length is split (flash-decoding) over a thread-block
// cluster, and the cluster merges its partial softmax states on chip:
// - grid (P, KV, B) in clusters of P blocks along L, P in {1, 2, 4, 8}
//   chosen by the caller from the shapes alone (ops/kernels/
//   decode_attention.py split_for; never from lens, which live on the
//   device). Rank r streams rows [r * chunk, (r + 1) * chunk) of its
//   (b, kv-head), chunk = ceil(L / P), cut at lens[b];
// - in a block of 4 warps, a row of D elements is split over G = D/8
//   lanes (rounded up to a power of two), 8 elements and one 8..32-byte
//   copy each, so a warp holds 32 / G rows at once and the block
//   4 * 32 / G; every lane group keeps its own online-softmax state
//   (running max, sum and its 8-element slice of the rep accumulators) in
//   registers and walks its rows kUnroll = 4 at a time; the rep query
//   slices live in registers too;
// - a lane's K/V slices (and int8 row scales) reach it through its own
//   ring of kStages steps in shared memory, filled by cp.async: the copies
//   of the next kStages - 1 steps are in flight while a step is computed,
//   so a block that walks a long chunk keeps several DRAM round trips
//   outstanding, not one. A lane reads back only what it copied itself,
//   so the ring needs no block barrier (cp.async.wait_group alone);
// - lane groups merge by shuffles inside a warp, warps through shared
//   memory into one block partial (m, l, acc[rep][D]); after a cluster
//   barrier each block reads the P partials through distributed shared
//   memory in rank order, rescales them to their common max and writes
//   its share of the rep * D outputs; a second cluster barrier keeps every
//   block's shared memory alive until all reads are done. One launch, no
//   atomics, no scratch buffer: outputs repeat bit for bit;
// - rows past a row's prefix are neither read nor computed (the TPU kernel
//   still copies them); a block whose chunk lies past the prefix writes
//   the neutral partial (-inf, 0, 0) and meets both barriers. Scores use
//   exp2 with log2(e) folded into q's scale.
// At the served shape one step covers a block's chunk, and the kernel is
// bound by latency, not bytes: its launch, the lens read, one K/V round
// trip and the cluster merge follow one another. decode_rope_variants.py
// times each of them (its diag_ variants) and the alternatives not taken:
// a ring of 1 or 4 steps, blocks of 8 warps, every P.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace coop = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // rows per lane group per step
constexpr int kMaxRep = 16;
constexpr int kMaxSplit = 8;
constexpr float kLog2e = 1.4426950408889634f;

// Eight consecutive elements of one cache row, as loaded (8-element
// aligned): 32 bytes of f32, 16 of bf16, 8 of int8.
template <typename T>
struct Chunk;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async of 16 bytes (through L2 only), or of 8 or 4 (through L1)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <>
struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static void copy(Chunk* dst, const float* p) {
    cp_async16(&dst->a, p);
    cp_async16(&dst->b, p + 4);
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
  __device__ __forceinline__ static void copy(Chunk* dst,
                                              const __nv_bfloat16* p) {
    cp_async16(&dst->u, p);
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
  __device__ __forceinline__ static void copy(Chunk* dst, const int8_t* p) {
    cp_async8(&dst->u, p);
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

// One step of the ring: every lane's K/V slices and row scales, lane
// index last (consecutive lanes at consecutive addresses, no bank
// conflicts). The ring is as deep as 40 KB holds, 1 to 4 steps (bf16 2,
// int8 3, f32 1): a larger ring leaves fewer blocks an SM, and clusters
// of 8 then no longer fit the card in one wave.
template <typename TKV>
struct Stage {
  Chunk<TKV> k[kUnroll][kThreads], v[kUnroll][kThreads];
  float ks[kUnroll][kThreads], vs[kUnroll][kThreads];
};
template <typename TKV>
__host__ __device__ constexpr int stages() {
  const int n = static_cast<int>(40 * 1024 / sizeof(Stage<TKV>));
  return n < 1 ? 1 : n > 4 ? 4 : n;
}

// dynamic shared memory: the ring of stages, then (floats) the warps'
// partials acc kWarps*rep*D | m kWarps*rep | l kWarps*rep, then the
// block's partial, which the cluster reads: acc rep*D | m rep | l rep
template <typename TKV>
size_t smem_bytes(int rep, int D) {
  return sizeof(Stage<TKV>) * stages<TKV>() +
         sizeof(float) * static_cast<size_t>(kWarps + 1) * rep * (D + 2);
}

// grid (P, KV, B) in clusters of (P, 1, 1), kThreads threads. G = lanes per
// cache row (a power of two >= D / 8); lanes gl >= D / 8 of a group hold
// no slice and stay idle. REP >= rep is the register-array bound.
template <typename TQ, typename TKV, int REP>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kc,
    const TKV* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ lens,
    TQ* __restrict__ out, int H, int KV, int L, int D, int G, int chunk,
    float qscale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kStages = stages<TKV>();
  Stage<TKV>* ring = reinterpret_cast<Stage<TKV>*>(smem_raw);
  float* smem = reinterpret_cast<float*>(ring + kStages);
  const int tid = threadIdx.x;
  coop::cluster_group cluster = coop::this_cluster();
  const int P = gridDim.x;                    // the cluster spans x
  const int rank = static_cast<int>(cluster.block_rank());
  const int rep = H / KV;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane % G;                    // slice within the row
  const int gpw = 32 / G;                     // row groups per warp
  const int gid = warp * gpw + lane / G;      // row group in the block
  const int ng = kWarps * gpw;                // row groups in the block
  const bool has_slice = gl * 8 < D;
  const int len = max(0, min(lens[b], L));
  const int r0 = rank * chunk;                // this block's rows [r0, r1)
  const int r1 = min(r0 + chunk, len);
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

  // step st covers rows r0 + st * kUnroll * ng + [0, kUnroll * ng); the
  // lane copies its slices of step st into slot st % kStages (an empty
  // copy group past the last step keeps the group count uniform)
  const int step_rows = kUnroll * ng;
  const int n_steps = r1 > r0 ? (r1 - r0 + step_rows - 1) / step_rows : 0;
  auto fill = [&](int st) {
    if (st < n_steps && has_slice) {
      Stage<TKV>& sg = ring[st % kStages];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = r0 + st * step_rows + u * ng + gid;
        if (j < r1) {
          const size_t off = (row0 + j) * D + gl * 8;
          Chunk<TKV>::copy(&sg.k[u][tid], kc + off);
          Chunk<TKV>::copy(&sg.v[u][tid], vc + off);
          if (ks != nullptr) {
            cp_async4(&sg.ks[u][tid], ks + row0 + j);
            cp_async4(&sg.vs[u][tid], vs + row0 + j);
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) fill(st);

  for (int st = 0; st < n_steps; ++st) {
    fill(st + kStages - 1);
    cp_async_wait<kStages - 1>();   // step st's copies have landed
    const Stage<TKV>& sg = ring[st % kStages];
    Chunk<TKV> kch[kUnroll], vch[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ok[u] = r0 + st * step_rows + u * ng + gid < r1;
      ksc[u] = vsc[u] = 1.f;
      if (ok[u] && has_slice) {
        kch[u] = sg.k[u][tid];
        vch[u] = sg.v[u][tid];
        if (ks != nullptr) {
          ksc[u] = sg.ks[u][tid];
          vsc[u] = sg.vs[u][tid];
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

  cp_async_wait<0>();

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
  // ... then the warps, through shared memory, into the block's partial
  float* sa = smem;                       // [kWarps][rep][D]
  float* sm = sa + kWarps * rep * D;      // [kWarps][rep]
  float* sl = sm + kWarps * rep;          // [kWarps][rep]
  float* pa = sl + kWarps * rep;          // [rep][D]  the block's partial
  float* pm = pa + rep * D;               // [rep]
  float* pl = pm + rep;                   // [rep]
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
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w * rep + r]);
    const float bse = safe_base(mx);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sm[w * rep + r] - bse);
      num += sa[(w * rep + r) * D + i - r * D] * c;
      den += sl[w * rep + r] * c;
    }
    pa[i] = num;
    if (i == r * D) {
      pm[r] = mx;
      pl[r] = den;
    }
  }
  cluster.sync();   // every block's partial is written and visible

  // rank q of the cluster finishes outputs [q * per, (q + 1) * per): the P
  // partials, read through distributed shared memory in rank order
  const int n_out = rep * D;
  const int per = (n_out + P - 1) / P;
  for (int i = rank * per + threadIdx.x; i < min(n_out, (rank + 1) * per);
       i += kThreads) {
    const int r = i / D;
    float mp[kMaxSplit], ap[kMaxSplit], lp[kMaxSplit];
    float mx = -INFINITY;
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p) {
      if (p < P) {
        mp[p] = *cluster.map_shared_rank(pm + r, p);
        lp[p] = *cluster.map_shared_rank(pl + r, p);
        ap[p] = *cluster.map_shared_rank(pa + i, p);
        mx = fmaxf(mx, mp[p]);
      }
    }
    const float bse = safe_base(mx);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p) {
      if (p < P) {
        const float c = exp2f(mp[p] - bse);
        num += ap[p] * c;
        den += lp[p] * c;
      }
    }
    // an empty prefix (lens[b] == 0) gives 0 / 0 = NaN, as the TPU
    // kernel's acc / l does
    store_f(num / den, out + qoff + i);
  }
  cluster.sync();   // no block leaves while another reads its partial
}

template <typename TQ, typename TKV, int REP>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* ks, const void* vs, const void* lens,
                   void* out, int B, int H, int KV, int L, int D, int P,
                   cudaStream_t stream) {
  static bool opted = false;   // once per kernel: the most any launch asks
  int G = 1;
  while (G * 8 < D) G <<= 1;
  auto kernel = decode_attention_kernel<TQ, TKV, REP>;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<TKV>(REP, 256)));
    if (e != cudaSuccess) return e;
    opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P, KV, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<TKV>(H / KV, D);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = P > 1 ? 1 : 0;   // a plain launch is a cluster of one
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q), static_cast<const TKV*>(kc),
      static_cast<const TKV*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lens),
      static_cast<TQ*>(out), H, KV, L, D, G, (L + P - 1) / P,
      kLog2e / sqrtf(static_cast<float>(D)));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_rep(const void* q, const void* kc, const void* vc,
                       const void* ks, const void* vs, const void* lens,
                       void* out, int B, int H, int KV, int L, int D, int P,
                       cudaStream_t s) {
  const int rep = H / KV;
  if (rep <= 1)
    return launch<TQ, TKV, 1>(q, kc, vc, ks, vs, lens, out, B, H, KV, L, D,
                              P, s);
  if (rep <= 2)
    return launch<TQ, TKV, 2>(q, kc, vc, ks, vs, lens, out, B, H, KV, L, D,
                              P, s);
  if (rep == 3)   // the served model's 12 heads over 4
    return launch<TQ, TKV, 3>(q, kc, vc, ks, vs, lens, out, B, H, KV, L, D,
                              P, s);
  if (rep <= 4)
    return launch<TQ, TKV, 4>(q, kc, vc, ks, vs, lens, out, B, H, KV, L, D,
                              P, s);
  if (rep <= 8)
    return launch<TQ, TKV, 8>(q, kc, vc, ks, vs, lens, out, B, H, KV, L, D,
                              P, s);
  return launch<TQ, TKV, kMaxRep>(q, kc, vc, ks, vs, lens, out, B, H, KV, L,
                                  D, P, s);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (K/V only; then ks/vs are
// the (B, KV, L, 1) f32 scales, otherwise null). P: the blocks of a
// cluster along L (1, 2, 4 or 8; decode_attention.py split_for). Returns a
// cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* ks,
                                       const void* vs, const void* lens,
                                       void* out, int B, int H, int KV,
                                       int L, int D, int P, int q_dtype,
                                       int kv_dtype, void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || KV > 65535 || H % KV != 0 ||
      H / KV > kMaxRep || D % 8 != 0 || D < 8 || D > 256 || L < 1 ||
      (P != 1 && P != 2 && P != 4 && P != kMaxSplit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == 0 && kv_dtype == 0)
    e = launch_rep<float, float>(q, kc, vc, nullptr, nullptr, lens, out, B,
                                 H, KV, L, D, P, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    e = launch_rep<__nv_bfloat16, __nv_bfloat16>(
        q, kc, vc, nullptr, nullptr, lens, out, B, H, KV, L, D, P, s);
  else if (q_dtype == 0 && kv_dtype == 2)
    e = launch_rep<float, int8_t>(q, kc, vc, ks, vs, lens, out, B, H, KV, L,
                                  D, P, s);
  else if (q_dtype == 1 && kv_dtype == 2)
    e = launch_rep<__nv_bfloat16, int8_t>(q, kc, vc, ks, vs, lens, out, B, H,
                                          KV, L, D, P, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
