// Flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:_bwd
// (its pallas_calls _dq_kernel and _dkv_kernel): dq, dk and dv from q, k,
// v, do, the forward's out and its lse. Causal masking is bottom-right
// aligned; a row whose lse is the -1e30 sentinel (it saw no key) gets p = 0.
// Rounding points as there: scores and accumulators in f32, p and ds
// rounded to bf16 before their products, each output rounded once.
//
// What bounds it at the main path's shapes: 5 products of 2 D flops per
// visible (query, key) pair, 32.2 GFLOP at the Llama's B 8, H 12, S 1024,
// D 64 causal and 53.7 GFLOP at the UNet's B 8, H 8, S 1024, D 80
// (operations: 33 and 54 us); the bytes (8 tensors of 12.6 MB or 10.5 MB)
// take less. The design is FlashAttention-2/3's one pass over the keys:
// - flash_bwd_prep_kernel reads do and out once and writes delta =
//   rowsum(do * out) and lse in the log2 domain (+inf for a dead row or a
//   padding row, so exp2 gives p = 0 there), both padded to 64 rows;
// - flash_bwd_wgmma_kernel: a block owns 128 keys of one (b, h), two
//   consumer warpgroups of 64 keys each keeping their k and v tiles
//   resident in shared memory, while a producer thread streams 64-row
//   tiles of q and do by TMA, and lse and delta by bulk copies, through a
//   2-stage mbarrier ring. Per query tile each warpgroup computes, with
//   wgmma into registers, ST = k qT and dPT = v doT (keys as rows, so pT
//   and dST come out in the A operand's register layout); pT = exp2(ST
//   scale log2e - lse2), dST = pT (dPT - delta) scale, both rounded to
//   bf16 in registers; dV += pT do and dK += dST q with A from registers;
//   and dq's share dS k with dST written to a swizzled shared tile read
//   back with wgmma's transpose bit. The share is added in f32 to a (B, H,
//   Sq, D) scratch by one bulk reduce-add (cp.reduce.async.bulk) per
//   warpgroup and tile. That is 5 products per pair, where the first
//   design's split into a dq and a dk/dv kernel recomputed two;
// - flash_bwd_dq_convert_kernel rounds the scratch to bf16 dq (B, Sq, H,
//   D). The order of the f32 additions into the scratch changes from run
//   to run, so dq may differ in its last bits between two runs.
// Causal: query tiles that see none of a block's keys are never loaded,
// and only tiles that cross the diagonal (or the ragged last keys) mask.
// TMA descriptors, the strided (B, S, H, D) layout, the swizzle chunks of
// D (64 + 16 at D 80), the transpose bits, the build split and the
// no-fallback rule are as in flash_fwd.cu's note; here q, do (as B of the
// dV and dK products), k (as B of dq's) and dST (as A of dq's) are the
// operands read across their rows.
// Registers: a consumer thread holds dK and dV (D / 2 floats each), ST and
// dPT (32 each), p and ds in bf16 and dq's share. At D 64 that fits; at
// D 80 and 128 ptxas spills (96 and 788 bytes in the build log) and
// serializes the wgmmas (C7512), with or without setmaxnreg, whose 232
// registers ptxas does not appear to allocate beyond the launch's 168.
//
// f32 io (checks only) runs the first design on the CUDA cores
// (flash_f32.cuh): a dq kernel and a dk/dv kernel, delta from the prep
// kernel.

#include "flash_common.cuh"
#include "flash_f32.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash;

// --------------------------------------------------------- delta and dq

__device__ __forceinline__ float dot16(uint4 a, uint4 b, const bf16*) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]);
    const float2 v = __bfloat1622float2(y[i]);
    s = fmaf(u.x, v.x, fmaf(u.y, v.y, s));
  }
  return s;
}

__device__ __forceinline__ float dot16(uint4 a, uint4 b, const float*) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&b);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}

// delta = rowsum(do * out) in f32 and lse2 = lse log2(e) (+inf for a
// dead row) into (B, H, Sp) rows; padding rows (q >= Sq) get 0 and +inf.
// G lanes share a row of do and out (G a power of two, at least the row's
// 16-byte vectors), rows taken in memory order, so a warp reads 32 / G
// whole rows that lie side by side. Items past the real rows are padding
// rows.
template <typename T, int G>
__global__ void flash_bwd_prep_kernel(const T* __restrict__ out,
                                      const T* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      float* __restrict__ delta,
                                      float* __restrict__ lse2, int H, int Sq,
                                      int Sp, int D, int real, int items) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int item = gid / G;
  const int j = gid % G;
  if (item >= items) return;  // whole groups of G lanes leave together
  if (item >= real) {
    if (j == 0) {
      const int pad = Sp - Sq;
      const int p = item - real;
      const size_t i = static_cast<size_t>(p / pad) * Sp + Sq + p % pad;
      delta[i] = 0.f;
      lse2[i] = INFINITY;
    }
    return;
  }
  // item = (b * Sq + q) * H + h
  const int h = item % H;
  const int bq = item / H;
  const int q = bq % Sq;
  const int b = bq / Sq;
  constexpr int V = 16 / sizeof(T);
  const size_t base = static_cast<size_t>(item) * D;
  float d = 0.f;
  for (int c = j * V; c < D; c += G * V)
    d += dot16(*reinterpret_cast<const uint4*>(out + base + c),
               *reinterpret_cast<const uint4*>(dout + base + c),
               static_cast<const T*>(nullptr));
  // the group's own lanes: other groups of the warp may have left
  const unsigned group = ((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1));
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) d += __shfl_xor_sync(group, d, o);
  if (j == 0) {
    const size_t bh = static_cast<size_t>(b) * H + h;
    const float l = lse[bh * Sq + q];
    delta[bh * Sp + q] = d;
    lse2[bh * Sp + q] = l <= kNegInf * 0.5f ? INFINITY : l * kLog2e;
  }
}

// dq (B, Sq, H, D) bf16 from the f32 scratch (B, H, Sp, D), eight elements
// a thread, in dq's memory order
__global__ void flash_bwd_dq_convert_kernel(const float* __restrict__ acc,
                                            bf16* __restrict__ dq, int H,
                                            int Sq, int Sp, int D,
                                            int octets) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= octets) return;
  const size_t e = 8 * static_cast<size_t>(i);
  const int d = static_cast<int>(e % D);
  size_t rest = e / D;
  const int h = static_cast<int>(rest % H);
  rest /= H;
  const int q = static_cast<int>(rest % Sq);
  const size_t b = rest / Sq;
  const float4* src =
      reinterpret_cast<const float4*>(acc + ((b * H + h) * Sp + q) * D + d);
  const float4 x = src[0], y = src[1];
  uint4 o;
  o.x = pack_bf16(x.x, x.y);
  o.y = pack_bf16(x.z, x.w);
  o.z = pack_bf16(y.x, y.y);
  o.w = pack_bf16(y.z, y.w);
  *reinterpret_cast<uint4*>(dq + e) = o;
}

// ------------------------------------------------------------ bf16, wgmma

template <int D>
struct BwdCfg {
  static constexpr int kBK = 128;  // keys per block: two warpgroups of 64
  static constexpr int kBQ = 64;   // query rows per streamed tile
  static constexpr int kStages = 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kDSBytes = kBox * kBQ * 2;  // one warpgroup's dST
  static constexpr int kDQBytes = kBQ * D * 4;     // one warpgroup's dq share
  // shared memory: k | v | stages x (q, do) | 2 x dST | 2 x dq share |
  // stages x (lse2, delta) | barriers
  static constexpr int kK = 0;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDS = kQ + 2 * kStages * kQBytes;
  static constexpr int kDQ = kDS + 2 * kDSBytes;
  static constexpr int kRow = kDQ + 2 * kDQBytes;
  static constexpr int kBar = kRow + kStages * 2 * kBQ * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

struct BwdMaps {
  CUtensorMap q[2], k[2], v[2], dout[2];
};

// grid (ceil(Sk / 128), B * H), 384 threads
template <int D>
__global__ void __launch_bounds__(kThreadsWS, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                           const float* __restrict__ lse2,
                           const float* __restrict__ delta,
                           float* __restrict__ dq_acc, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int H, int Sq, int Sk,
                           int Sp, float scale, float scale_log2,
                           int causal) {
  using L = BwdCfg<D>;
  using C = Chunks<D>;
  constexpr int BQ = L::kBQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * L::kBK;
  const int offset = Sk - Sq;
  const int nq = (Sq + BQ - 1) / BQ;
  // causal: the first query that sees key k0 is k0 - offset
  const int qt0 = causal ? max(0, k0 - offset) / BQ : 0;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kRegsProducer>();
    if (threadIdx.x == 0) {
      mbar_expect(kv_full, 2 * L::kKVBytes);
      load_rows<D, L::kBK>(smem + L::kK, maps.k, kv_full, h, k0, b);
      load_rows<D, L::kBK>(smem + L::kV, maps.v, kv_full, h, k0, b);
      for (int it = 0, qt = qt0; qt < nq; ++it, ++qt) {
        const int s = it % L::kStages;
        mbar_wait(&empty[s], ((it / L::kStages) & 1) ^ 1);
        unsigned char* qs = smem + L::kQ + 2 * s * L::kQBytes;
        float* rows = reinterpret_cast<float*>(smem + L::kRow) + s * 2 * BQ;
        const size_t r0 = static_cast<size_t>(bh) * Sp + qt * BQ;
        mbar_expect(&full[s], 2 * L::kQBytes + 2 * BQ * 4);
        load_rows<D, BQ>(qs, maps.q, &full[s], h, qt * BQ, b);
        load_rows<D, BQ>(qs + L::kQBytes, maps.dout, &full[s], h, qt * BQ,
                         b);
        bulk_load(rows, lse2 + r0, BQ * 4, &full[s]);
        bulk_load(rows + BQ, delta + r0, BQ * 4, &full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<kRegsConsumer>();

  // consumer warpgroup cw: keys kb0 .. kb0 + 63; this thread holds key
  // rows r and r + 8 and, in every group of 8 columns, c2 and c2 + 1
  const int cw = wg - 1;
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int r = (t >> 5) * 16 + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const int kb0 = k0 + cw * kBox;
  const int krow[2] = {kb0 + r, kb0 + r + 8};
  const bool active = kb0 < Sk;

  float dva[D / 2], dka[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dva[i] = dka[i] = 0.f;
  const uint32_t sK = smem_u32(smem + L::kK);
  const uint32_t sV = smem_u32(smem + L::kV);
  unsigned char* ds_tile = smem + L::kDS + cw * L::kDSBytes;
  float* dq_tile = reinterpret_cast<float*>(smem + L::kDQ + cw * L::kDQBytes);
  const uint32_t sDS = smem_u32(ds_tile);
  mbar_wait(kv_full, 0);

  for (int it = 0, qt = qt0; qt < nq; ++it, ++qt) {
    const int s = it % L::kStages;
    mbar_wait(&full[s], (it / L::kStages) & 1);
    const int q0 = qt * BQ;
    const uint32_t sQ = smem_u32(smem + L::kQ + 2 * s * L::kQBytes);
    const uint32_t sO = sQ + L::kQBytes;
    const float* rows = reinterpret_cast<const float*>(smem + L::kRow) +
                        s * 2 * BQ;
    const bool live = active && (!causal || kb0 <= q0 + BQ - 1 + offset);
    if (live) {
      // ST = k qT and dPT = v doT, 64 keys x 64 queries
      float st[BQ / 2], dpt[BQ / 2];
      wg_fence();
      for_each_chunk<D>([&](auto ci) {
        constexpr int c = decltype(ci)::value;
        constexpr int w = C::width(c);
        const uint32_t a0 = C::offset(c, L::kBK) + cw * kBox * 2 * w;
        const uint32_t b0 = C::offset(c, BQ);
#pragma unroll
        for (int kk = 0; kk < w / 16; ++kk) {
          wgmma_ss<0, 0>(st, desc(sK + a0 + 32 * kk, w),
                         desc(sQ + b0 + 32 * kk, w), c + kk > 0, Int<BQ>());
          wgmma_ss<0, 0>(dpt, desc(sV + a0 + 32 * kk, w),
                         desc(sO + b0 + 32 * kk, w), c + kk > 0, Int<BQ>());
        }
      });
      wg_commit();
      wg_wait<0>();
      fence_regs<BQ / 2>(st);
      fence_regs<BQ / 2>(dpt);

      const bool mask =
          kb0 + kBox > Sk || (causal && kb0 + kBox - 1 > q0 + offset);
      uint32_t pf[BQ / 4], dsf[BQ / 4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + c2 + e;
            const int idx = 4 * j + 2 * i + e;
            float pe = ex2(st[idx] * scale_log2 - rows[col]);
            if (mask && (krow[i] >= Sk ||
                         (causal && krow[i] > q0 + col + offset)))
              pe = 0.f;
            p[e] = pe;
            ds[e] = pe * (dpt[idx] - rows[BQ + col]) * scale;
          }
          pf[2 * j + i] = pack_bf16(p[0], p[1]);
          dsf[2 * j + i] = pack_bf16(ds[0], ds[1]);
        }

      // dST to shared memory, rows of 64 queries (128 bytes) with the
      // 128-byte swizzle: 16-byte group g of row k sits at g ^ (k & 7)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int kr = r + 8 * i;
          *reinterpret_cast<uint32_t*>(ds_tile + kr * 128 +
                                       ((j ^ (kr & 7)) << 4) + c2 * 2) =
              dsf[2 * j + i];
        }
      fence_async_smem();
      wg_bar(1 + cw);
      // dV += pT do and dK += dST q, B read across its rows, then dq's
      // share dS k = (dST)T k (64 queries x D), both of its operands read
      // across rows; one group
      wg_fence();
      for_each_chunk<D>([&](auto ci) {
        constexpr int c = decltype(ci)::value;
        constexpr int w = C::width(c);
        const uint32_t b0 = C::offset(c, BQ);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wgmma_rs<1>(dva + C::col(c) / 2, pf + 4 * kk,
                      desc(sO + b0 + kk * 32 * w, w), 1, Int<w>());
          wgmma_rs<1>(dka + C::col(c) / 2, dsf + 4 * kk,
                      desc(sQ + b0 + kk * 32 * w, w), 1, Int<w>());
        }
      });
      float dqs[D / 2];
      for_each_chunk<D>([&](auto ci) {
        constexpr int c = decltype(ci)::value;
        constexpr int w = C::width(c);
        const uint32_t b0 = sK + C::offset(c, L::kBK) + cw * kBox * 2 * w;
#pragma unroll
        for (int kk = 0; kk < kBox / 16; ++kk)
          wgmma_ss<1, 1>(dqs + C::col(c) / 2, desc(sDS + kk * 2048, 64),
                         desc(b0 + kk * 32 * w, w), kk > 0, Int<w>());
      });
      wg_commit();
      wg_wait<0>();
      fence_regs<D / 2>(dva);
      fence_regs<D / 2>(dka);
      fence_regs<D / 2>(dqs);
      // q, do, lse2 and delta of this stage are read
      mbar_arrive(&empty[s]);
      // the last tile's reduce has read dq_tile
      if (t == 0) bulk_wait_read();
      wg_bar(1 + cw);
#pragma unroll
      for (int J = 0; J < D / 8; ++J)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(dq_tile + (r + 8 * i) * D + 8 * J +
                                     c2) =
              make_float2(dqs[4 * J + 2 * i], dqs[4 * J + 2 * i + 1]);
      fence_async_smem();
      wg_bar(1 + cw);
      if (t == 0)
        bulk_reduce_add(dq_acc + (static_cast<size_t>(bh) * Sp + q0) * D,
                        dq_tile, L::kDQBytes);
    } else {
      mbar_arrive(&empty[s]);
    }
  }
  if (t == 0) bulk_wait();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = krow[i];
    if (key >= Sk) continue;
    const size_t base = ((static_cast<size_t>(b) * Sk + key) * H + h) * D;
#pragma unroll
    for (int J = 0; J < D / 8; ++J) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * J + c2) =
          __floats2bfloat162_rn(dka[4 * J + 2 * i], dka[4 * J + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * J + c2) =
          __floats2bfloat162_rn(dva[4 * J + 2 * i], dva[4 * J + 2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t bwd_bf16(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse2, const float* delta,
                     float* dq_acc, void* dq, void* dk, void* dv, int B,
                     int H, int Sq, int Sk, int Sp, float scale, int causal,
                     cudaStream_t s) {
  using L = BwdCfg<D>;
  BwdMaps maps{};
  cudaError_t e = chunk_maps<D>(maps.q, q, B, Sq, H);
  if (e == cudaSuccess) e = chunk_maps<D>(maps.k, k, B, Sk, H);
  if (e == cudaSuccess) e = chunk_maps<D>(maps.v, v, B, Sk, H);
  if (e == cudaSuccess) e = chunk_maps<D>(maps.dout, dout, B, Sq, H);
  auto kernel = flash_bwd_wgmma_kernel<D>;
  if (e == cudaSuccess) e = allow_smem(kernel, L::kBytes);
  if (e == cudaSuccess) e = check_regs(kernel);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((Sk + L::kBK - 1) / L::kBK, B * H), kThreadsWS, L::kBytes,
           s>>>(maps, lse2, delta, dq_acc, static_cast<bf16*>(dk),
                static_cast<bf16*>(dv), H, Sq, Sk, Sp, scale,
                scale * kLog2e, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int octets = B * Sq * H * D / 8;
  flash_bwd_dq_convert_kernel<<<(octets + 255) / 256, 256, 0, s>>>(
      dq_acc, static_cast<bf16*>(dq), H, Sq, Sp, D, octets);
  return cudaGetLastError();
}

// ------------------------------------------------------ f32, CUDA cores

template <int D>
struct DqF32Smem {
  using P = flash_f32::Pitch<D>;
  static constexpr int kBQ = flash_f32::kBQ, kBK = flash_f32::kBK;
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + sizeof(float) * kBQ * P::io;
  static constexpr size_t k = dout + sizeof(float) * kBQ * P::io;
  static constexpr size_t v = k + sizeof(float) * kBK * P::io;
  static constexpr size_t s = v + sizeof(float) * kBK * P::io;
  static constexpr size_t dp = s + sizeof(float) * kBQ * P::s;
  static constexpr size_t dq = dp + sizeof(float) * kBQ * P::s;
  static constexpr size_t lse = dq + sizeof(float) * kBQ * P::io;
  static constexpr size_t delta = lse + sizeof(float) * kBQ;
  static constexpr size_t bytes = delta + sizeof(float) * kBQ;
};

// grid (ceil(Sq / 64), B * H), 128 threads; delta rows are Sp apart
template <int D>
__global__ void __launch_bounds__(flash_f32::kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int H, int Sq, int Sk,
                            int Sp, float scale, int causal) {
  using namespace flash_f32;
  using P = Pitch<D>;
  using L = DqF32Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sdO = reinterpret_cast<float*>(smem + L::dout);
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sdP = reinterpret_cast<float*>(smem + L::dp);  // dp, then ds
  float* sdQ = reinterpret_cast<float*>(smem + L::dq);
  float* sL = reinterpret_cast<float*>(smem + L::lse);
  float* sDl = reinterpret_cast<float*>(smem + L::delta);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t qoff = (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;
  const int offset = Sk - Sq;

  load_tile<D, kBQ>(sQ, q + qoff, q0, Sq, rs);
  load_tile<D, kBQ>(sdO, dout + qoff, q0, Sq, rs);
  zero(sdQ, kBQ * P::io);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < Sq;
    sL[r] = in ? lse[static_cast<size_t>(bh) * Sq + q0 + r] : kNegInf;
    sDl[r] = in ? delta[static_cast<size_t>(bh) * Sp + q0 + r] : 0.f;
  }

  int nk = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last_key = min(Sq, q0 + kBQ) - 1 + offset;
    nk = last_key < 0 ? 0 : min(nk, last_key / kBK + 1);
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<D, kBK>(sK, kb, k0, Sk, rs);
    load_tile<D, kBK>(sV, vb, k0, Sk, rs);
    __syncthreads();
    block_mm<kBQ, kBK, D, false, true, false>(sS, P::s, sQ, P::io, sK,
                                              P::io);
    block_mm<kBQ, kBK, D, false, true, false>(sdP, P::s, sdO, P::io, sV,
                                              P::io);
    __syncthreads();
    for (int i = threadIdx.x; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i - r * kBK;
      const float s = masked(q0 + r, k0 + c, Sk, offset, causal)
                          ? kNegInf
                          : sS[r * P::s + c] * scale;
      const float lr = sL[r];
      const float p = lr <= kNegInf * 0.5f ? 0.f : expf(s - lr);
      sdP[r * P::s + c] = p * (sdP[r * P::s + c] - sDl[r]) * scale;
    }
    __syncthreads();
    block_mm<kBQ, D, kBK, false, false, true>(sdQ, P::io, sdP, P::s, sK,
                                              P::io);
  }
  __syncthreads();
  store_rows<D, kBQ>(dq + qoff, sdQ, P::io, q0, Sq, rs);
}

template <int D>
struct DkvF32Smem {
  using P = flash_f32::Pitch<D>;
  static constexpr int kBQ = flash_f32::kBQ, kBK = flash_f32::kBK;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + sizeof(float) * kBK * P::io;
  static constexpr size_t q = v + sizeof(float) * kBK * P::io;
  static constexpr size_t dout = q + sizeof(float) * kBQ * P::io;
  static constexpr size_t s = dout + sizeof(float) * kBQ * P::io;
  static constexpr size_t dp = s + sizeof(float) * kBQ * P::s;
  static constexpr size_t dk = dp + sizeof(float) * kBQ * P::s;
  static constexpr size_t dv = dk + sizeof(float) * kBK * P::io;
  static constexpr size_t lse = dv + sizeof(float) * kBK * P::io;
  static constexpr size_t delta = lse + sizeof(float) * kBQ;
  static constexpr size_t bytes = delta + sizeof(float) * kBQ;
};

// grid (ceil(Sk / 64), B * H), 128 threads; delta rows are Sp apart
template <int D>
__global__ void __launch_bounds__(flash_f32::kThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int H, int Sq, int Sk, int Sp, float scale,
                             int causal) {
  using namespace flash_f32;
  using P = Pitch<D>;
  using L = DkvF32Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sdO = reinterpret_cast<float*>(smem + L::dout);
  float* sS = reinterpret_cast<float*>(smem + L::s);    // scores, then p
  float* sdP = reinterpret_cast<float*>(smem + L::dp);  // dp, then ds
  float* sdK = reinterpret_cast<float*>(smem + L::dk);
  float* sdV = reinterpret_cast<float*>(smem + L::dv);
  float* sL = reinterpret_cast<float*>(smem + L::lse);
  float* sDl = reinterpret_cast<float*>(smem + L::delta);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kBK;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t qoff = (static_cast<size_t>(b) * Sq * H + h) * D;
  const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * D;
  const int offset = Sk - Sq;

  load_tile<D, kBK>(sK, k + koff, k0, Sk, rs);
  load_tile<D, kBK>(sV, v + koff, k0, Sk, rs);
  zero(sdK, kBK * P::io);
  zero(sdV, kBK * P::io);

  const int nq = (Sq + kBQ - 1) / kBQ;
  // causal: the first query that sees key k0 is k0 - offset
  const int qt0 = causal ? max(0, k0 - offset) / kBQ : 0;
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();
    load_tile<D, kBQ>(sQ, q + qoff, q0, Sq, rs);
    load_tile<D, kBQ>(sdO, dout + qoff, q0, Sq, rs);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const bool in = q0 + r < Sq;
      sL[r] = in ? lse[static_cast<size_t>(bh) * Sq + q0 + r] : kNegInf;
      sDl[r] = in ? delta[static_cast<size_t>(bh) * Sp + q0 + r] : 0.f;
    }
    __syncthreads();
    block_mm<kBQ, kBK, D, false, true, false>(sS, P::s, sQ, P::io, sK,
                                              P::io);
    block_mm<kBQ, kBK, D, false, true, false>(sdP, P::s, sdO, P::io, sV,
                                              P::io);
    __syncthreads();
    for (int i = threadIdx.x; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i - r * kBK;
      const float s = masked(q0 + r, k0 + c, Sk, offset, causal)
                          ? kNegInf
                          : sS[r * P::s + c] * scale;
      const float lr = sL[r];
      const float p = lr <= kNegInf * 0.5f ? 0.f : expf(s - lr);
      sS[r * P::s + c] = p;
      sdP[r * P::s + c] = p * (sdP[r * P::s + c] - sDl[r]) * scale;
    }
    __syncthreads();
    // dv += p^T do, dk += ds^T q
    block_mm<kBK, D, kBQ, true, false, true>(sdV, P::io, sS, P::s, sdO,
                                             P::io);
    block_mm<kBK, D, kBQ, true, false, true>(sdK, P::io, sdP, P::s, sQ,
                                             P::io);
  }
  __syncthreads();
  store_rows<D, kBK>(dk + koff, sdK, P::io, k0, Sk, rs);
  store_rows<D, kBK>(dv + koff, sdV, P::io, k0, Sk, rs);
}

template <int D>
cudaError_t bwd_f32(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, void* dk, void* dv, int B, int H, int Sq,
                    int Sk, int Sp, float scale, int causal,
                    cudaStream_t s) {
  using flash_f32::kBK;
  using flash_f32::kBQ;
  using flash_f32::kThreads;
  const size_t dq_bytes = DqF32Smem<D>::bytes;
  auto dq_kernel = flash_bwd_dq_f32_kernel<D>;
  cudaError_t e = allow_smem(dq_kernel, dq_bytes);
  if (e != cudaSuccess) return e;
  dq_kernel<<<dim3((Sq + kBQ - 1) / kBQ, B * H), kThreads, dq_bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), H, Sq, Sk, Sp, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t dkv_bytes = DkvF32Smem<D>::bytes;
  auto dkv_kernel = flash_bwd_dkv_f32_kernel<D>;
  e = allow_smem(dkv_kernel, dkv_bytes);
  if (e != cudaSuccess) return e;
  dkv_kernel<<<dim3((Sk + kBK - 1) / kBK, B * H), kThreads, dkv_bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk,
      Sp, scale, causal);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t prep_g(const void* out, const void* dout, const void* lse,
                   void* delta, void* lse2, int B, int H, int Sq, int Sp,
                   int D, cudaStream_t s) {
  const int real = B * Sq * H;
  const int items = real + B * H * (Sp - Sq);
  const long long threads = static_cast<long long>(items) * G;
  flash_bwd_prep_kernel<T, G><<<static_cast<int>((threads + 255) / 256), 256,
                                0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(lse2), H, Sq, Sp, D, real, items);
  return cudaGetLastError();
}

// G: the row's 16-byte vectors rounded up to a power of two
template <typename T>
cudaError_t prep(const void* out, const void* dout, const void* lse,
                 void* delta, void* lse2, int B, int H, int Sq, int Sp, int D,
                 cudaStream_t s) {
  const int vecs = D * static_cast<int>(sizeof(T)) / 16;
  if (vecs <= 2)
    return prep_g<T, 2>(out, dout, lse, delta, lse2, B, H, Sq, Sp, D, s);
  if (vecs <= 4)
    return prep_g<T, 4>(out, dout, lse, delta, lse2, B, H, Sq, Sp, D, s);
  if (vecs <= 8)
    return prep_g<T, 8>(out, dout, lse, delta, lse2, B, H, Sq, Sp, D, s);
  return prep_g<T, 16>(out, dout, lse, delta, lse2, B, H, Sq, Sp, D, s);
}

}  // namespace

// Runs the prep kernel (delta, lse2), then for bf16 the one-pass kernel
// and dq's conversion, for f32 the dq and the dk/dv kernels, on one
// stream. delta and lse2 are (B, H, Sp) f32 with Sp = Sq rounded up to 64;
// dq_acc (bf16 only) is a zeroed (B, H, Sp, D) f32 scratch. dtype codes
// and D as in flash_attention_fwd_launch. Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* lse2, void* dq_acc, int B, int H, int Sq, int Sk,
    int D, float scale, int causal, int dtype, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bf = dtype == 1;
  const bool ok = bf ? (D == 16 || D == 32 || D == 64 || D == 80 || D == 128)
                     : (dtype == 0 && (D == 16 || D == 32 || D == 64));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Sp = (Sq + kBox - 1) / kBox * kBox;
  cudaError_t e = bf ? prep<bf16>(out, dout, lse, delta, lse2, B, H, Sq, Sp,
                                  D, s)
                     : prep<float>(out, dout, lse, delta, lse2, B, H, Sq, Sp,
                                   D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* dl = static_cast<const float*>(delta);
  const float* l2 = static_cast<const float*>(lse2);
  float* acc = static_cast<float*>(dq_acc);
#define PTT_BF(DD) \
  bwd_bf16<DD>(q, k, v, dout, l2, dl, acc, dq, dk, dv, B, H, Sq, Sk, Sp, \
               scale, causal, s)
#define PTT_F32(DD)                                                       \
  bwd_f32<DD>(q, k, v, dout, static_cast<const float*>(lse), dl, dq, dk, \
              dv, B, H, Sq, Sk, Sp, scale, causal, s)
  if (bf) {
    if (D == 16) e = PTT_BF(16);
    else if (D == 32) e = PTT_BF(32);
    else if (D == 64) e = PTT_BF(64);
    else if (D == 80) e = PTT_BF(80);
    else e = PTT_BF(128);
  } else {
    if (D == 16) e = PTT_F32(16);
    else if (D == 32) e = PTT_F32(32);
    else e = PTT_F32(64);
  }
#undef PTT_BF
#undef PTT_F32
  return static_cast<int>(e);
}

// Dynamic shared memory of the bf16 one-pass kernel at head dim D (0:
// none).
extern "C" int flash_attention_bwd_smem(int D) {
  switch (D) {
    case 16: return BwdCfg<16>::kBytes;
    case 32: return BwdCfg<32>::kBytes;
    case 64: return BwdCfg<64>::kBytes;
    case 80: return BwdCfg<80>::kBytes;
    case 128: return BwdCfg<128>::kBytes;
    default: return 0;
  }
}
