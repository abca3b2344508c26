// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:_fwd
// (its pallas_calls _fwd_single_kernel and _fwd_kernel): out = softmax(q kT
// * scale) v and the f32 logsumexp lse. Causal masking is bottom-right
// aligned: query i sees keys j <= i + Sk - Sq. A row that sees no key
// writes out 0 and lse -1e30, the TPU kernel's sentinel. Rounding points
// as there: scores and accumulators in f32, p rounded to bf16 before its
// product with v, out rounded once. q, out are (B, Sq, H, D) and k, v
// (B, Sk, H, D), read and written in place; lse is (B, H, Sq) f32.
//
// What bounds it at the main path's shapes: the Llama's B 8, H 12, S 1024,
// D 64 causal moves 4 x 12.6 MB of bf16 against 12.9 GFLOP of products
// (bytes, 15 us); the UNet's B 8, H 8, S 1024, D 80 does 21.5 GFLOP
// (operations, 22 us). Either way the card must keep its tensor cores fed
// from shared memory while the softmax runs, so the design is
// FlashAttention-3's:
// - a block owns 128 query rows of one (b, h): a producer warpgroup whose
//   one thread issues TMA loads, and two consumer warpgroups of 64 rows;
//   setmaxnreg moves registers from the producer to the consumers;
// - q is loaded once; 128-key tiles of k and v stream through a ring of 3
//   stages (2 at D 128) guarded by full/empty mbarriers;
// - S = q kT is one wgmma per 16 columns of D, both operands in shared
//   memory, the 64 x 128 scores landing in registers;
// - the online softmax runs in those registers: a row lives in one quad,
//   so its max takes two __shfl_xor_sync, and its sum is kept per thread
//   and reduced once at the end;
// - p is rounded to bf16 in registers and is the register A operand of
//   O += P V, whose accumulator stays in registers for the whole key loop;
// - causal tiles wholly past the diagonal are never loaded; only tiles
//   that cross it (or the ragged last tile) are masked.
// Measured on the H100 (flash_variants.py, PERF.md): 64-key tiles were
// 4-5 % slower than 128; exp2f for p instead of the SFU's ex2.approx was
// 10 % slower at D 64 (and the backward 7-9 % slower). Issuing tile j's S
// with tile j - 1's P V inside a warpgroup, as FlashAttention-3 does, made
// ptxas serialize the wgmmas (its C7513 note) and was slower, so each
// warpgroup runs S, softmax, P V in turn and the two warpgroups overlap
// each other.
//
// Where the trouble was, and what this file does about it:
// 1. TMA descriptors: cuTensorMapEncodeTiled is fetched through
//    cudaGetDriverEntryPoint (flash_common.cuh), no -lcuda; the maps are
//    kernel parameters (__grid_constant__).
// 2. Strided layout: each tensor is a 4-D map (D, H, S, B) with boxes of
//    (chunk, 1, 64, 1); TMA fills rows past S with zeros, and those keys
//    are masked to -inf here, since a zero key would score 0.
// 3. Swizzle against D: D is cut into 64-wide chunks with the 128-byte
//    swizzle and a 16- or 32-wide chunk with the 32- or 64-byte one (D 80
//    = 64 + 16); S = q kT takes one descriptor per 16-wide slice of a
//    chunk, P V one instruction per chunk along N.
// 4. Operand majorness: v, contiguous along N, is read with wgmma's
//    transpose bit, its descriptor stepping 16 key rows at a time.
// 5. Build time: the forward and the backward are separate sources built
//    in parallel, instantiated only for the dtype x D table below.
// 6. Names: every kernel here starts with flash_.
// 7. No fallback: a refused launch (or a kernel compiled with too few
//    registers for setmaxnreg's pool) returns its cudaError_t.
//
// f32 io (checks only) runs the first design on the CUDA cores
// (flash_f32.cuh): wgmma has no f32 type.

#include "flash_common.cuh"
#include "flash_f32.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash;

// ------------------------------------------------------------ bf16, wgmma

template <int D>
struct FwdCfg {
  static constexpr int kBQ = 128;  // query rows: two consumer warpgroups
  static constexpr int kBK = 128;  // keys per stage
  static constexpr int kStages = D > 80 ? 2 : 3;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;  // one k or v tile
  // shared memory: q | stages x (k, v) | barriers
  static constexpr int kQ = 0;
  static constexpr int kKV = kQBytes;
  static constexpr int kBar = kKV + 2 * kStages * kKVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

struct FwdMaps {
  CUtensorMap q[2], k[2], v[2];
};

// grid (ceil(Sq / 128), B * H), 384 threads
template <int D>
__global__ void __launch_bounds__(kThreadsWS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int H, int Sq, int Sk, float scale_log2,
                           int causal) {
  using L = FwdCfg<D>;
  using C = Chunks<D>;
  constexpr int BK = L::kBK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  // causal: the last query tiles see the most keys, so they start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * L::kBQ;
  const int offset = Sk - Sq;
  int nk = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_key = min(Sq, q0 + L::kBQ) - 1 + offset;
    nk = last_key < 0 ? 0 : min(nk, last_key / BK + 1);
  }
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<kRegsProducer>();
    if (threadIdx.x == 0) {
      mbar_expect(q_full, L::kQBytes);
      load_rows<D, L::kBQ>(smem + L::kQ, maps.q, q_full, h, q0, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % L::kStages;
        mbar_wait(&empty[s], ((kt / L::kStages) & 1) ^ 1);
        unsigned char* kv = smem + L::kKV + 2 * s * L::kKVBytes;
        mbar_expect(&full[s], 2 * L::kKVBytes);
        load_rows<D, BK>(kv, maps.k, &full[s], h, kt * BK, b);
        load_rows<D, BK>(kv + L::kKVBytes, maps.v, &full[s], h, kt * BK, b);
      }
    }
    return;
  }
  setmaxnreg_inc<kRegsConsumer>();

  // consumer warpgroup: 64 query rows; this thread holds rows r and r + 8
  // of them and, in every group of 8 columns, columns c2 and c2 + 1
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int r = (t >> 5) * 16 + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const int row0 = q0 + (wg - 1) * kBox;
  const int qrow[2] = {row0 + r, row0 + r + 8};
  const bool active = row0 < Sq;
  // the last key any row of this warpgroup sees
  const int key_last = min(Sq, row0 + kBox) - 1 + offset;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const uint32_t sQ = smem_u32(smem + L::kQ);
  mbar_wait(q_full, 0);

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % L::kStages;
    mbar_wait(&full[s], (kt / L::kStages) & 1);
    const int k0 = kt * BK;
    if (active && (!causal || k0 <= key_last)) {
      const uint32_t sK = smem_u32(smem + L::kKV + 2 * s * L::kKVBytes);
      const uint32_t sV = sK + L::kKVBytes;
      float sc[BK / 2];
      // S = q kT, 64 x 128
      wg_fence();
      for_each_chunk<D>([&](auto ci) {
        constexpr int c = decltype(ci)::value;
        constexpr int w = C::width(c);
        const uint32_t a0 =
            sQ + C::offset(c, L::kBQ) + (wg - 1) * kBox * 2 * w;
        const uint32_t b0 = sK + C::offset(c, BK);
#pragma unroll
        for (int kk = 0; kk < w / 16; ++kk)
          wgmma_ss<0, 0>(sc, desc(a0 + 32 * kk, w), desc(b0 + 32 * kk, w),
                         c + kk > 0, Int<BK>());
      });
      wg_commit();
      wg_wait<0>();
      fence_regs<BK / 2>(sc);

      // online softmax in the log2 domain, in registers
      const bool mask =
          k0 + BK > Sk || (causal && k0 + BK - 1 > row0 + offset);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[4 * j + 2 * i + e] * scale_log2;
            const int key = k0 + 8 * j + c2 + e;
            if (mask && (key >= Sk || (causal && key > qrow[i] + offset)))
              x = -INFINITY;
            sc[4 * j + 2 * i + e] = x;
            mx[i] = fmaxf(mx[i], x);
          }
      float mb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);
        mb[i] = mn == -INFINITY ? 0.f : mn;  // a row with no key yet
        const float alpha = exp2f(m[i] - mb[i]);
        m[i] = mn;
        l[i] *= alpha;
#pragma unroll
        for (int J = 0; J < D / 8; ++J) {
          o[4 * J + 2 * i] *= alpha;
          o[4 * J + 2 * i + 1] *= alpha;
        }
      }
      // p, rounded to bf16 in the A operand's register layout
      uint32_t pf[BK / 4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p0 = ex2(sc[4 * j + 2 * i] - mb[i]);
          const float p1 = ex2(sc[4 * j + 2 * i + 1] - mb[i]);
          l[i] += p0 + p1;
          pf[2 * j + i] = pack_bf16(p0, p1);
        }

      // O += P v, one instruction per chunk of D and 16 keys
      wg_fence();
      for_each_chunk<D>([&](auto ci) {
        constexpr int c = decltype(ci)::value;
        constexpr int w = C::width(c);
        const uint32_t b0 = sV + C::offset(c, BK);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<1>(o + C::col(c) / 2, pf + 4 * kk,
                      desc(b0 + kk * 32 * w, w), 1, Int<w>());
      });
      wg_commit();
      wg_wait<0>();
      fence_regs<D / 2>(o);
    }
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int q = qrow[i];
    if (q >= Sq) continue;
    const bool dead = m[i] == -INFINITY;
    const float inv = dead ? 0.f : 1.f / li;
    bf16* orow = out + ((static_cast<size_t>(b) * Sq + q) * H + h) * D;
#pragma unroll
    for (int J = 0; J < D / 8; ++J)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * J + c2) =
          __floats2bfloat162_rn(o[4 * J + 2 * i] * inv,
                                o[4 * J + 2 * i + 1] * inv);
    if ((lane & 3) == 0)
      lse[static_cast<size_t>(bh) * Sq + q] =
          dead ? kNegInf : (m[i] + log2f(li)) * kLn2;
  }
}

template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int H, int Sq, int Sk, float scale,
                     int causal, cudaStream_t s) {
  using L = FwdCfg<D>;
  FwdMaps maps{};
  cudaError_t e = chunk_maps<D>(maps.q, q, B, Sq, H);
  if (e == cudaSuccess) e = chunk_maps<D>(maps.k, k, B, Sk, H);
  if (e == cudaSuccess) e = chunk_maps<D>(maps.v, v, B, Sk, H);
  auto kernel = flash_fwd_wgmma_kernel<D>;
  if (e == cudaSuccess) e = allow_smem(kernel, L::kBytes);
  if (e == cudaSuccess) e = check_regs(kernel);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((Sq + L::kBQ - 1) / L::kBQ, B * H), kThreadsWS, L::kBytes,
           s>>>(maps, static_cast<bf16*>(out), static_cast<float*>(lse), H,
                Sq, Sk, scale * kLog2e, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------ f32, CUDA cores

template <int D>
struct FwdF32Smem {
  using P = flash_f32::Pitch<D>;
  static constexpr int kBQ = flash_f32::kBQ, kBK = flash_f32::kBK;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(float) * kBQ * P::io;
  static constexpr size_t v = k + sizeof(float) * kBK * P::io;
  static constexpr size_t s = v + sizeof(float) * kBK * P::io;
  static constexpr size_t o = s + sizeof(float) * kBQ * P::s;
  static constexpr size_t alpha = o + sizeof(float) * kBQ * P::io;
  static constexpr size_t bytes = alpha + sizeof(float) * kBQ;
};

// grid (ceil(Sq / 64), B * H), 128 threads; the online softmax runs with
// two threads per row, over shared memory
template <int D>
__global__ void __launch_bounds__(flash_f32::kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int H, int Sq, int Sk,
                         float scale, int causal) {
  using namespace flash_f32;
  using P = Pitch<D>;
  using L = FwdF32Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);  // scores, then p
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sAlpha = reinterpret_cast<float*>(smem + L::alpha);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const size_t rs = static_cast<size_t>(H) * D;
  const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;
  const int offset = Sk - Sq;

  load_tile<D, kBQ>(sQ, qb, q0, Sq, rs);
  zero(sO, kBQ * P::io);

  // the two threads of a row keep identical copies of its m and l
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int qi = q0 + row;
  float m = kNegInf, l = 0.f;

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
    __syncthreads();
    {
      float* srow = sS + row * P::s;
      float mx = kNegInf;
      for (int c = half * 32; c < half * 32 + 32; ++c) {
        const float s =
            masked(qi, k0 + c, Sk, offset, causal) ? kNegInf : srow[c] * scale;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      float sum = 0.f;
      for (int c = half * 32; c < half * 32 + 32; ++c) {
        const float p = expf(srow[c] - m_new);
        sum += p;
        srow[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = alpha * l + sum;
      m = m_new;
      if (half == 0) sAlpha[row] = alpha;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
      const int r = i / D;
      sO[r * P::io + (i - r * D)] *= sAlpha[r];
    }
    __syncthreads();
    block_mm<kBQ, D, kBK, false, false, true>(sO, P::io, sS, P::s, sV,
                                              P::io);
  }
  __syncthreads();
  if (qi < Sq) {
    const bool dead = m <= kNegInf * 0.5f;
    const float safe_l = fmaxf(l, 1e-30f);
    float* orow = out + (static_cast<size_t>(b) * Sq * H + h) * D + qi * rs;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      orow[c] = dead ? 0.f : sO[row * P::io + c] / safe_l;
    if (half == 0)
      lse[static_cast<size_t>(bh) * Sq + qi] =
          dead ? kNegInf : m + logf(safe_l);
  }
}

template <int D>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int H, int Sq, int Sk, float scale,
                    int causal, cudaStream_t s) {
  const size_t bytes = FwdF32Smem<D>::bytes;
  auto kernel = flash_fwd_f32_kernel<D>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((Sq + flash_f32::kBQ - 1) / flash_f32::kBQ, B * H),
           flash_f32::kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), H, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32 (D 16, 32 or 64), 1 bfloat16 (D 16, 32, 64, 80
// or 128). Returns a cudaError_t.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int B, int H, int Sq, int Sk, int D,
                                          float scale, int causal, int dtype,
                                          void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_FWD(F, DD) F<DD>(q, k, v, out, lse, B, H, Sq, Sk, scale, causal, s)
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 16) e = PTT_FWD(fwd_bf16, 16);
    else if (D == 32) e = PTT_FWD(fwd_bf16, 32);
    else if (D == 64) e = PTT_FWD(fwd_bf16, 64);
    else if (D == 80) e = PTT_FWD(fwd_bf16, 80);
    else if (D == 128) e = PTT_FWD(fwd_bf16, 128);
  } else if (dtype == 0) {
    if (D == 16) e = PTT_FWD(fwd_f32, 16);
    else if (D == 32) e = PTT_FWD(fwd_f32, 32);
    else if (D == 64) e = PTT_FWD(fwd_f32, 64);
  }
#undef PTT_FWD
  return static_cast<int>(e);
}

// Dynamic shared memory of the bf16 kernel at head dim D (0: none).
extern "C" int flash_attention_fwd_smem(int D) {
  switch (D) {
    case 16: return FwdCfg<16>::kBytes;
    case 32: return FwdCfg<32>::kBytes;
    case 64: return FwdCfg<64>::kBytes;
    case 80: return FwdCfg<80>::kBytes;
    case 128: return FwdCfg<128>::kBytes;
    default: return 0;
  }
}
