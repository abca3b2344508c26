// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py:
//   forward  _fwd (_fwd_single_kernel and _fwd_kernel): out = softmax(q kT
//            * scale) v with the f32 logsumexp lse;
//   backward _bwd (_dq_kernel and _dkv_kernel): dq, and dk with dv, from
//            the saved lse and delta = sum(do * out) (a torch op outside).
// Causal masking is bottom-right aligned: query i sees keys j <= i + Sk - Sq.
// Masked scores take the finite sentinel -1e30, as in the TPU kernel; a row
// that sees no key writes out 0 and lse -1e30, and the backward zeroes its
// p. Rounding points follow the TPU kernel: scores and accumulators in f32,
// p (and ds in the backward) rounded to the io dtype before the products
// with v, do, k and q, each output rounded once.
//
// Layout: q, out, do, dq are (B, Sq, H, D) and k, v, dk, dv (B, Sk, H, D),
// read and written with strides (no transposes to (B*H, S, D)); lse and
// delta are (B, H, Sq) f32. Any Sq and Sk: ragged tiles are zero-filled and
// their keys masked.
//
// What bounds it: operations. At the training shape (B 8, H 12, S 1024,
// D 64, causal) the forward does 4*B*H*S*S*D/2 = 12.9 GFLOP on 2 x 50 MB
// of q/k/v/out, about 130 flops per byte read, close to the card's balance
// point; the backward does 2.5x the flops on the same bytes. The design is
// the simple, right first version: a block of 4 warps owns 64 query rows
// (64 key rows in the dk/dv kernel) and walks the other side in 64-row
// tiles staged in shared memory; the products run on the tensor cores
// through WMMA (bf16 in, f32 accumulate) with the f32 tiles going through
// shared memory between them; the online softmax runs with two threads per
// row. Causal tiles wholly past the diagonal are skipped. The TPU kernel's
// single whole-sequence block (a VMEM choice) and its tiled grid become the
// same tiled loop here. f32 io runs the same code with the products on the
// CUDA cores (exact f32, for checks). Left to later work: wgmma, TMA,
// register-resident accumulators, warp specialization.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;   // query rows per tile
constexpr int kBK = 64;   // key rows per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

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

// Shared-memory pitches in elements. io tiles pad by 8 and f32 tiles by 4
// so rows start on different banks; both keep WMMA's 32-byte alignment for
// every 16 x 16 fragment. D need not be a power of two: D 80 (the UNet's
// 640 channels over 8 heads) is five 16-wide fragments, its io pitch 88
// puts a 16-row fragment 2816 bytes on (88 x 32), its f32 pitch 84 at
// 5376 (168 x 32), and a row is ten 16-byte vectors in load_tile.
template <int D> struct Pitch {
  static constexpr int io = D + 8;       // q/k/v/do tiles (T)
  static constexpr int acc = D + 4;      // f32 (rows, D) accumulators
  static constexpr int s = kBK + 4;      // f32 (64, 64) score tiles
  static constexpr int p = kBK + 8;      // T (64, 64) probability tiles
};

// C[M][N] f32 (pitch ldc) = (ACC ? C : 0) + A[M][K] * B[K][N], A and B tiles
// of T in shared memory. A_COL: A(m, k) = A[k * lda + m], else A[m * lda +
// k]. B_COL: B(k, n) = B[n * ldb + k], else B[k * ldb + n]. The caller
// synchronizes the block before and after.
template <typename T, int M, int N, int K, bool A_COL, bool B_COL, bool ACC>
struct BlockMM;

template <int M, int N, int K, bool A_COL, bool B_COL, bool ACC>
struct BlockMM<__nv_bfloat16, M, N, K, A_COL, B_COL, ACC> {
  static __device__ __forceinline__ void run(float* C, int ldc,
                                             const __nv_bfloat16* A, int lda,
                                             const __nv_bfloat16* B,
                                             int ldb) {
    using LA = typename std::conditional<A_COL, wmma::col_major,
                                         wmma::row_major>::type;
    using LB = typename std::conditional<B_COL, wmma::col_major,
                                         wmma::row_major>::type;
    constexpr int TN = N / 16;
    const int warp = threadIdx.x >> 5;
    for (int t = warp; t < (M / 16) * TN; t += kWarps) {
      const int mi = t / TN;
      const int ni = t - mi * TN;
      float* c = C + mi * 16 * ldc + ni * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (ACC)
        wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int ki = 0; ki < K / 16; ++ki) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
        wmma::load_matrix_sync(
            a, A_COL ? A + ki * 16 * lda + mi * 16 : A + mi * 16 * lda + ki * 16,
            lda);
        wmma::load_matrix_sync(
            b, B_COL ? B + ni * 16 * ldb + ki * 16 : B + ki * 16 * ldb + ni * 16,
            ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
    }
  }
};

template <int M, int N, int K, bool A_COL, bool B_COL, bool ACC>
struct BlockMM<float, M, N, K, A_COL, B_COL, ACC> {
  static __device__ __forceinline__ void run(float* C, int ldc,
                                             const float* A, int lda,
                                             const float* B, int ldb) {
    for (int i = threadIdx.x; i < M * N; i += kThreads) {
      const int m = i / N;
      const int n = i - m * N;
      float s = ACC ? C[m * ldc + n] : 0.f;
      for (int k = 0; k < K; ++k) {
        const float a = A_COL ? A[k * lda + m] : A[m * lda + k];
        const float b = B_COL ? B[n * ldb + k] : B[k * ldb + n];
        s = fmaf(a, b, s);
      }
      C[m * ldc + n] = s;
    }
  }
};

// Rows [r0, r0 + R) of one head of a (B, S, H, D) tensor (row stride rs
// elements) into tile[R][Pitch<D>::io]; rows at or past S are zero.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(T* tile, const T* base, int r0,
                                          int S, size_t rs) {
  constexpr int V = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int CH = D / V;
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i - r * CH) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      v = *reinterpret_cast<const uint4*>(base + (r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(tile + r * Pitch<D>::io + c) = v;
  }
}

// tile[R][pitch] f32 -> rows [r0, r0 + R) of one head, rows past S skipped
template <typename T, int D, int R>
__device__ __forceinline__ void store_rows(T* base, const float* tile,
                                           int pitch, int r0, int S,
                                           size_t rs) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    if (r0 + r < S) base[(r0 + r) * rs + c] = from_f<T>(tile[r * pitch + c]);
  }
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = 0.f;
}

__device__ __forceinline__ bool masked(int qi, int kj, int Sk, int offset,
                                       int causal) {
  return kj >= Sk || (causal && qi + offset < kj);
}

// ---------------------------------------------------------------- forward

template <typename T, int D>
struct FwdSmem {
  using P = Pitch<D>;
  static constexpr bool kLowp = sizeof(T) == 2;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(T) * kBQ * P::io;
  static constexpr size_t v = k + sizeof(T) * kBK * P::io;
  static constexpr size_t s = v + sizeof(T) * kBK * P::io;
  static constexpr size_t o = s + sizeof(float) * kBQ * P::s;
  static constexpr size_t p = o + sizeof(float) * kBQ * P::acc;
  static constexpr size_t alpha = p + (kLowp ? sizeof(T) * kBQ * P::p : 0);
  static constexpr size_t bytes = alpha + sizeof(float) * kBQ;
};

// grid (ceil(Sq / kBQ), B * H)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk,
                     float scale, int causal) {
  using P = Pitch<D>;
  using L = FwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  // f32 io: p overwrites the scores in place
  T* sP = L::kLowp ? reinterpret_cast<T*>(smem + L::p)
                   : reinterpret_cast<T*>(sS);
  constexpr int pp = L::kLowp ? P::p : P::s;
  float* sAlpha = reinterpret_cast<float*>(smem + L::alpha);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const size_t rs = static_cast<size_t>(H) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;
  const int offset = Sk - Sq;

  load_tile<T, D, kBQ>(sQ, qb, q0, Sq, rs);
  zero(sO, kBQ * P::acc);

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
    load_tile<T, D, kBK>(sK, kb, k0, Sk, rs);
    load_tile<T, D, kBK>(sV, vb, k0, Sk, rs);
    __syncthreads();
    BlockMM<T, kBQ, kBK, D, false, true, false>::run(sS, P::s, sQ, P::io, sK,
                                                     P::io);
    __syncthreads();
    {
      float* srow = sS + row * P::s;
      T* prow = sP + row * pp;
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
        prow[c] = from_f<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = alpha * l + sum;
      m = m_new;
      if (half == 0) sAlpha[row] = alpha;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
      const int r = i / D;
      sO[r * P::acc + (i - r * D)] *= sAlpha[r];
    }
    __syncthreads();
    BlockMM<T, kBQ, D, kBK, false, false, true>::run(sO, P::acc, sP, pp, sV,
                                                     P::io);
  }
  __syncthreads();
  if (qi < Sq) {
    const bool dead = m <= kNegInf * 0.5f;
    const float safe_l = fmaxf(l, 1e-30f);
    T* orow = out + (static_cast<size_t>(b) * Sq * H + h) * D + qi * rs;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      orow[c] = from_f<T>(dead ? 0.f : sO[row * P::acc + c] / safe_l);
    if (half == 0)
      lse[static_cast<size_t>(bh) * Sq + qi] =
          dead ? kNegInf : m + logf(safe_l);
  }
}

// ------------------------------------------------------------ backward: dq

template <typename T, int D>
struct DqSmem {
  using P = Pitch<D>;
  static constexpr bool kLowp = sizeof(T) == 2;
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + sizeof(T) * kBQ * P::io;
  static constexpr size_t k = dout + sizeof(T) * kBQ * P::io;
  static constexpr size_t v = k + sizeof(T) * kBK * P::io;
  static constexpr size_t s = v + sizeof(T) * kBK * P::io;
  static constexpr size_t dp = s + sizeof(float) * kBQ * P::s;
  static constexpr size_t dq = dp + sizeof(float) * kBQ * P::s;
  static constexpr size_t ds = dq + sizeof(float) * kBQ * P::acc;
  static constexpr size_t lse = ds + (kLowp ? sizeof(T) * kBQ * P::p : 0);
  static constexpr size_t delta = lse + sizeof(float) * kBQ;
  static constexpr size_t bytes = delta + sizeof(float) * kBQ;
};

// grid (ceil(Sq / kBQ), B * H)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Sq, int Sk, float scale, int causal) {
  using P = Pitch<D>;
  using L = DqSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sdO = reinterpret_cast<T*>(smem + L::dout);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sdP = reinterpret_cast<float*>(smem + L::dp);
  float* sdQ = reinterpret_cast<float*>(smem + L::dq);
  // f32 io: ds overwrites dp in place
  T* sdS = L::kLowp ? reinterpret_cast<T*>(smem + L::ds)
                    : reinterpret_cast<T*>(sdP);
  constexpr int dsp = L::kLowp ? P::p : P::s;
  float* sL = reinterpret_cast<float*>(smem + L::lse);
  float* sDl = reinterpret_cast<float*>(smem + L::delta);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t qoff = (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;
  const int offset = Sk - Sq;

  load_tile<T, D, kBQ>(sQ, q + qoff, q0, Sq, rs);
  load_tile<T, D, kBQ>(sdO, dout + qoff, q0, Sq, rs);
  zero(sdQ, kBQ * P::acc);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < Sq;
    sL[r] = in ? lse[static_cast<size_t>(bh) * Sq + q0 + r] : kNegInf;
    sDl[r] = in ? delta[static_cast<size_t>(bh) * Sq + q0 + r] : 0.f;
  }

  int nk = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last_key = min(Sq, q0 + kBQ) - 1 + offset;
    nk = last_key < 0 ? 0 : min(nk, last_key / kBK + 1);
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<T, D, kBK>(sK, kb, k0, Sk, rs);
    load_tile<T, D, kBK>(sV, vb, k0, Sk, rs);
    __syncthreads();
    BlockMM<T, kBQ, kBK, D, false, true, false>::run(sS, P::s, sQ, P::io, sK,
                                                     P::io);
    BlockMM<T, kBQ, kBK, D, false, true, false>::run(sdP, P::s, sdO, P::io,
                                                     sV, P::io);
    __syncthreads();
    for (int i = threadIdx.x; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i - r * kBK;
      const float s = masked(q0 + r, k0 + c, Sk, offset, causal)
                          ? kNegInf
                          : sS[r * P::s + c] * scale;
      const float lr = sL[r];
      const float p = lr <= kNegInf * 0.5f ? 0.f : expf(s - lr);
      sdS[r * dsp + c] = from_f<T>(p * (sdP[r * P::s + c] - sDl[r]) * scale);
    }
    __syncthreads();
    BlockMM<T, kBQ, D, kBK, false, false, true>::run(sdQ, P::acc, sdS, dsp,
                                                     sK, P::io);
  }
  __syncthreads();
  store_rows<T, D, kBQ>(dq + qoff, sdQ, P::acc, q0, Sq, rs);
}

// -------------------------------------------------------- backward: dk, dv

template <typename T, int D>
struct DkvSmem {
  using P = Pitch<D>;
  static constexpr bool kLowp = sizeof(T) == 2;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + sizeof(T) * kBK * P::io;
  static constexpr size_t q = v + sizeof(T) * kBK * P::io;
  static constexpr size_t dout = q + sizeof(T) * kBQ * P::io;
  static constexpr size_t s = dout + sizeof(T) * kBQ * P::io;
  static constexpr size_t dp = s + sizeof(float) * kBQ * P::s;
  static constexpr size_t dk = dp + sizeof(float) * kBQ * P::s;
  static constexpr size_t dv = dk + sizeof(float) * kBK * P::acc;
  static constexpr size_t t = dv + sizeof(float) * kBK * P::acc;
  static constexpr size_t lse = t + (kLowp ? sizeof(T) * kBQ * P::p : 0);
  static constexpr size_t delta = lse + sizeof(float) * kBQ;
  static constexpr size_t bytes = delta + sizeof(float) * kBQ;
};

// grid (ceil(Sk / kBK), B * H)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Sq, int Sk,
                         float scale, int causal) {
  using P = Pitch<D>;
  using L = DkvSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sdO = reinterpret_cast<T*>(smem + L::dout);
  float* sS = reinterpret_cast<float*>(smem + L::s);    // scores, then p
  float* sdP = reinterpret_cast<float*>(smem + L::dp);  // dp, then ds (f32)
  float* sdK = reinterpret_cast<float*>(smem + L::dk);
  float* sdV = reinterpret_cast<float*>(smem + L::dv);
  // the io-dtype p, then ds (f32 io: the f32 tiles themselves)
  T* sT = reinterpret_cast<T*>(smem + L::t);
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

  load_tile<T, D, kBK>(sK, k + koff, k0, Sk, rs);
  load_tile<T, D, kBK>(sV, v + koff, k0, Sk, rs);
  zero(sdK, kBK * P::acc);
  zero(sdV, kBK * P::acc);

  const int nq = (Sq + kBQ - 1) / kBQ;
  // causal: the first query that sees key k0 is k0 - offset
  const int qt0 = causal ? max(0, k0 - offset) / kBQ : 0;
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();
    load_tile<T, D, kBQ>(sQ, q + qoff, q0, Sq, rs);
    load_tile<T, D, kBQ>(sdO, dout + qoff, q0, Sq, rs);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const bool in = q0 + r < Sq;
      sL[r] = in ? lse[static_cast<size_t>(bh) * Sq + q0 + r] : kNegInf;
      sDl[r] = in ? delta[static_cast<size_t>(bh) * Sq + q0 + r] : 0.f;
    }
    __syncthreads();
    BlockMM<T, kBQ, kBK, D, false, true, false>::run(sS, P::s, sQ, P::io, sK,
                                                     P::io);
    BlockMM<T, kBQ, kBK, D, false, true, false>::run(sdP, P::s, sdO, P::io,
                                                     sV, P::io);
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
      if constexpr (L::kLowp) sT[r * P::p + c] = from_f<T>(p);
    }
    __syncthreads();
    // dv += p^T do
    if constexpr (L::kLowp)
      BlockMM<T, kBK, D, kBQ, true, false, true>::run(sdV, P::acc, sT, P::p,
                                                      sdO, P::io);
    else
      BlockMM<T, kBK, D, kBQ, true, false, true>::run(sdV, P::acc, sS, P::s,
                                                      sdO, P::io);
    __syncthreads();
    for (int i = threadIdx.x; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i - r * kBK;
      const float ds = sS[r * P::s + c] * (sdP[r * P::s + c] - sDl[r]) * scale;
      if constexpr (L::kLowp)
        sT[r * P::p + c] = from_f<T>(ds);
      else
        sdP[r * P::s + c] = ds;
    }
    __syncthreads();
    // dk += ds^T q
    if constexpr (L::kLowp)
      BlockMM<T, kBK, D, kBQ, true, false, true>::run(sdK, P::acc, sT, P::p,
                                                      sQ, P::io);
    else
      BlockMM<T, kBK, D, kBQ, true, false, true>::run(sdK, P::acc, sdP, P::s,
                                                      sQ, P::io);
  }
  __syncthreads();
  store_rows<T, D, kBK>(dk + koff, sdK, P::acc, k0, Sk, rs);
  store_rows<T, D, kBK>(dv + koff, sdV, P::acc, k0, Sk, rs);
}

// ----------------------------------------------------------------- launch

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int H, int Sq, int Sk, float scale,
                int causal, cudaStream_t s) {
  const size_t bytes = FwdSmem<T, D>::bytes;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((Sq + kBQ - 1) / kBQ, B * H), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, void* dk, void* dv, int B, int H, int Sq, int Sk,
                float scale, int causal, cudaStream_t s) {
  const size_t dq_bytes = DqSmem<T, D>::bytes;
  auto dq_kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = allow_smem(dq_kernel, dq_bytes);
  if (e != cudaSuccess) return e;
  dq_kernel<<<dim3((Sq + kBQ - 1) / kBQ, B * H), kThreads, dq_bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Sq, Sk, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t dkv_bytes = DkvSmem<T, D>::bytes;
  auto dkv_kernel = flash_bwd_dkv_kernel<T, D>;
  e = allow_smem(dkv_kernel, dkv_bytes);
  if (e != cudaSuccess) return e;
  dkv_kernel<<<dim3((Sk + kBK - 1) / kBK, B * H), kThreads, dkv_bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Sk) {
  return B < 1 || H < 1 || Sq < 1 || Sk < 1 || B * H > 65535;
}

}  // namespace

// dtype codes: 0 float32 (D 16, 32 or 64), 1 bfloat16 (D 16, 32, 64, 80
// or 128). Returns a cudaError_t.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int B, int H, int Sq, int Sk, int D,
                                          float scale, int causal, int dtype,
                                          void* stream) {
  if (bad_shape(B, H, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
#define PTT_FWD(T, DD) \
  fwd<T, DD>(q, k, v, out, lse, B, H, Sq, Sk, scale, causal, s)
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 16) e = PTT_FWD(bf, 16);
    else if (D == 32) e = PTT_FWD(bf, 32);
    else if (D == 64) e = PTT_FWD(bf, 64);
    else if (D == 80) e = PTT_FWD(bf, 80);
    else if (D == 128) e = PTT_FWD(bf, 128);
  } else if (dtype == 0) {
    if (D == 16) e = PTT_FWD(float, 16);
    else if (D == 32) e = PTT_FWD(float, 32);
    else if (D == 64) e = PTT_FWD(float, 64);
  }
#undef PTT_FWD
  return static_cast<int>(e);
}

// Launches the dq kernel, then the dk/dv kernel, on the same stream.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dq, void* dk, void* dv, int B,
                                          int H, int Sq, int Sk, int D,
                                          float scale, int causal, int dtype,
                                          void* stream) {
  if (bad_shape(B, H, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
#define PTT_BWD(T, DD)                                                     \
  bwd<T, DD>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, scale, \
             causal, s)
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 16) e = PTT_BWD(bf, 16);
    else if (D == 32) e = PTT_BWD(bf, 32);
    else if (D == 64) e = PTT_BWD(bf, 64);
    else if (D == 80) e = PTT_BWD(bf, 80);
    else if (D == 128) e = PTT_BWD(bf, 128);
  } else if (dtype == 0) {
    if (D == 16) e = PTT_BWD(float, 16);
    else if (D == 32) e = PTT_BWD(float, 32);
    else if (D == 64) e = PTT_BWD(float, 64);
  }
#undef PTT_BWD
  return static_cast<int>(e);
}
