// Weight-only int8 matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int8_matmul.py
// (int8_matmul / _kernel): out[B, N] = (x[B, K] @ float(w[K, N])) * scale[N]
// for decode-sized B <= 64, f32 accumulation, output in x's dtype; w is
// row-major (K, N) int8 with one f32 scale per output column.
//
// What bounds it: bytes. The int8 weight (K * N bytes) dwarfs x and out at
// B <= 64: the kernel does 2 * B flops per weight byte, at most 128, below
// the card's ~295 bf16 flops per byte. So each weight byte must come from
// device memory once per call whatever B is, with enough of it in flight
// to cover the memory's latency, and the products must not fall to the
// CUDA cores (at 64 rows the head is 3.1 GFLOP).
//
// The bf16 path (int8_matmul_mma_kernel), the one the served model takes:
// - A block owns a strip of bn = 32, 64 or 128 output columns and ALL B
//   rows of x, padded to NT * 8. Its weight strip streams through a
//   cp.async ring in shared memory, 128 rows of K a stage, with the same
//   K slice of x beside it: one pass over the weight for every row
//   count. The ring is as deep as 110 KB holds (5 stages at 8 rows, 3 at
//   64), so two blocks fit an SM.
// - Tensor cores by mma.sync.m16n8k16 (bf16 in, f32 accumulate), written
//   as out^T = w^T x^T: the 16-row M side of the instruction is 16 weight
//   columns and its 8-wide N side is 8 rows of x, so 8 rows waste nothing
//   and 64 rows are 8 tiles. wgmma would want 64 weight columns by K in a
//   swizzled bf16 layout, i.e. a second pass through shared memory to
//   dequantize; at 2 flops a byte and 8-64 rows mma.sync's rate is far
//   above what the bytes allow, so the fragments are built in registers
//   straight from the int8 tile instead.
// - Dequantization is exact (|q| <= 127): a thread reads one 32-bit word
//   (4 columns) from each of the 4 K rows its A fragment needs, a byte
//   permute puts each byte under the exponent of 2^23 (an f32 of 2^23 +
//   q + 128), one subtraction recovers q, and a pack rounds two of them
//   to bf16x2 (exact). A warp owns 32 columns, permuted so that one word
//   feeds both of its M tiles; the epilogue puts them back.
// - A block's 8 warps are bn / 32 column groups by KP = 256 / bn K parts,
//   the stage's 16-deep steps dealt round-robin to the K parts. The KP
//   partial sums meet in shared memory in a fixed tree order. With 64
//   rows a thread holds 64 accumulators (125 registers), which keeps two
//   blocks on an SM; 64-column warps needed 196 and halved that.
// - Split-K where the strips are too few to fill the SMs (N 768, 1280 and
//   4096): the widest strip whose strips, split at most 8 ways, reach one
//   block an SM, then S = SMs / strips blocks of one strip form a
//   thread-block cluster along K, each takes a contiguous run of stages,
//   and the cluster sums its S partials through distributed shared memory
//   in rank order. No atomics anywhere: the output repeats bit for bit.
//   int8_rms_variants.py times the alternatives not taken: 64-deep
//   stages with two blocks an SM to fill (slower), and 256-column strips
//   (no faster over a decode step's launches). TMA with
//   swizzled tiles and an mbarrier ring was tried too: the head gained,
//   gate_up lost, a decode step's 49 launches did not gain, and every call
//   would encode two tensor maps on the host.
// - The scale multiplies the f32 sum once, before the one rounding.
// Shapes off the 16-byte grid (N % 16, K % 8, or misaligned pointers)
// take the same kernel with plain loads in place of cp.async.
//
// The f32-x path (int8_matmul_kernel, not on the served path) keeps the
// first design on the CUDA cores: a block per 32 columns and 8 rows of x,
// f32 FMAs; a TF32 product would change its result.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxB = 64;

// ------------------------------------------------- f32 x: CUDA-core path

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
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int B, int K,
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
    // ... while the block stages the x slice [kb, kb + kStep), coalesced
    // along K
    __syncthreads();
    for (int i = threadIdx.x; i < kStep; i += kThreads) {
      const int k = kb + i;
#pragma unroll
      for (int b = 0; b < kBT; ++b)
        xs[i][b] = (k < K && b < nb) ? x[static_cast<size_t>(r0 + b) * K + k]
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
    out[static_cast<size_t>(r0 + b) * N + col] = t * scale[col];
  }
}

static_assert(kBT * kBN == kThreads, "one output per thread in the epilogue");

// ------------------------------------------------ bf16 x: tensor-core path

constexpr int kMThreads = 256;
constexpr int kMWarps = kMThreads / 32;
constexpr int kBK = 128;             // K rows of a stage
constexpr int kKSteps = kBK / 16;    // 16-deep mma steps a stage
constexpr int kMaxStages = 8;
constexpr int kRingBudget = 110 * 1024;  // two blocks an SM
constexpr int kXStride = kBK * 2 + 16;  // bytes of a staged x row (padded)
constexpr int kRedSlots = 4;            // CG * KP / 2 for every CG
constexpr int kMaxCluster = 8;

// the weight tile's row stride: 16 bytes of padding put the 4 K rows a
// warp's lanes read (2t, 2t + 1, 2t + 8, 2t + 9) on distinct banks
__host__ __device__ constexpr int w_stride(int bn) { return bn + 16; }

__host__ __device__ constexpr int stage_bytes(int bn, int nt) {
  return kBK * w_stride(bn) + nt * 8 * kXStride;
}

// as many stages as the budget holds at the widest strip, up to 8: the
// fewer rows, the deeper the ring
__host__ __device__ constexpr int stages_for(int nt) {
  return kRingBudget / stage_bytes(128, nt) < kMaxStages
             ? kRingBudget / stage_bytes(128, nt)
             : kMaxStages;
}

__host__ __device__ constexpr int ring_bytes(int bn, int nt) {
  return stages_for(nt) * stage_bytes(bn, nt);
}

// a tree round's slots: each 32 lanes x 8 * NT accumulators
__host__ __device__ constexpr int red_bytes(int nt) {
  return kRedSlots * 32 * 8 * nt * 4;
}

__host__ __device__ constexpr int smem_bytes(int bn, int nt) {
  const int post = red_bytes(nt) + nt * 8 * bn * 4;
  const int ring = ring_bytes(bn, nt);
  return ring > post ? ring : post;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(valid ? 16 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the bf16 pair (byte j of p, byte j of q), low half from p; p and q hold
// int8 bytes already offset by 128 (xor 0x80)
__device__ __forceinline__ uint32_t dequant_pair(uint32_t p, uint32_t q,
                                                 int j) {
  const uint32_t sel = 0x7440u | static_cast<uint32_t>(j);
  const float lo = __uint_as_float(__byte_perm(p, 0x4B000000u, sel)) -
                   8388736.0f;  // 2^23 + 128
  const float hi = __uint_as_float(__byte_perm(q, 0x4B000000u, sel)) -
                   8388736.0f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// Stage st of the block's K range into ring slot ``slot``: the weight's
// rows [st * kBK, + kBK) of the strip's bn columns, and x's rows [0, NT *
// 8) of the same K columns, zero past K, N and B.
template <bool kAligned>
__device__ __forceinline__ void load_stage(
    unsigned char* ring, int slot, int st, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ w, int B, int K, int N, int n0, int bn,
    int rows) {
  const int sw = w_stride(bn);
  unsigned char* ws = ring + slot * stage_bytes(bn, rows / 8);
  unsigned char* xs = ws + kBK * sw;
  const int k0 = st * kBK;
  if constexpr (kAligned) {
    const int wchunks = bn / 16;
    for (int i = threadIdx.x; i < kBK * wchunks; i += kMThreads) {
      const int r = i / wchunks, c = (i % wchunks) * 16;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(ws + r * sw + c,
                 ok ? w + static_cast<size_t>(k0 + r) * N + n0 + c : w, ok);
    }
    constexpr int xchunks = kBK / 8;
    for (int i = threadIdx.x; i < rows * xchunks; i += kMThreads) {
      const int r = i / xchunks, c = (i % xchunks) * 8;
      const bool ok = r < B && k0 + c < K;
      cp_async16(xs + r * kXStride + c * 2,
                 ok ? x + static_cast<size_t>(r) * K + k0 + c : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * bn; i += kMThreads) {
      const int r = i / bn, c = i % bn;
      ws[r * sw + c] = (k0 + r < K && n0 + c < N)
                           ? w[static_cast<size_t>(k0 + r) * N + n0 + c]
                           : int8_t(0);
    }
    for (int i = threadIdx.x; i < rows * kBK; i += kMThreads) {
      const int r = i / kBK, c = i % kBK;
      reinterpret_cast<__nv_bfloat16*>(xs + r * kXStride)[c] =
          (r < B && k0 + c < K) ? x[static_cast<size_t>(r) * K + k0 + c]
                                : __float2bfloat16(0.f);
    }
  }
}

// grid (ceil(N / bn), S) in clusters of (1, S, 1) (a plain launch, a
// cluster of one, when S is 1); kMThreads threads;
// smem_bytes(bn, NT) of dynamic shared memory; bn = 32 * CG. NT = ceil(B
// / 8) rounded up to 1, 2, 4, 6 or 8 (the host picks it). A warp owns 32
// columns: its 2 M tiles take, for M row g, columns 4g + j (rows g + 8:
// 4g + 2 + j) of tile j, so one 32-bit word of a K row feeds both tiles.
template <int NT, bool kAligned>
__global__ void __launch_bounds__(kMThreads, 2) int8_matmul_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int B,
    int K, int N, int CG) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int KP = kMWarps / CG;
  const int cgi = warp / KP, kp = warp % KP;
  const int bn = 32 * CG;
  const int sw = w_stride(bn);
  constexpr int rows = NT * 8;
  constexpr int kStages = stages_for(NT);
  const int n0 = blockIdx.x * bn;
  // this block's run of stages
  const int S = gridDim.y, rank = blockIdx.y;
  const int nk = (K + kBK - 1) / kBK;
  const int st0 = rank * nk / S, n_st = (rank + 1) * nk / S - st0;

  float acc[2][NT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_st)
      load_stage<kAligned>(smem, i, st0 + i, x, w, B, K, N, n0, bn, rows);
    cp_async_commit();
  }
  for (int i = 0; i < n_st; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int nx = i + kStages - 1;
      if (nx < n_st)
        load_stage<kAligned>(smem, nx % kStages, st0 + nx, x, w, B, K, N, n0,
                             bn, rows);
      cp_async_commit();
    }
    const unsigned char* ws = smem + (i % kStages) * stage_bytes(bn, NT);
    const unsigned char* xs = ws + kBK * sw;
    // the block's 16-deep steps, dealt round-robin to the KP K parts
    for (int s = ((kp - i * kKSteps) % KP + KP) % KP; s < kKSteps; s += KP) {
      // x^T as the B operand: one ldmatrix.x2 per 8 rows
      uint32_t b[NT][2];
      const int lr = lane & 15;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        ldmatrix_x2(b[n][0], b[n][1],
                    xs + (n * 8 + (lr & 7)) * kXStride +
                        (s * 16 + (lr >> 3) * 8) * 2);
      // w^T as the A operand: a word of each K row 2t, 2t + 1, 2t + 8,
      // 2t + 9 at columns 4g..4g + 3
      const unsigned char* wr = ws + (s * 16 + 2 * t) * sw + cgi * 32 + 4 * g;
      uint32_t wd[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wd[r] = *reinterpret_cast<const uint32_t*>(
                    wr + ((r & 1) + (r >> 1) * 8) * sw) ^
                0x80808080u;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t a[4] = {dequant_pair(wd[0], wd[1], j),
                               dequant_pair(wd[0], wd[1], j + 2),
                               dequant_pair(wd[2], wd[3], j),
                               dequant_pair(wd[2], wd[3], j + 2)};
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16(acc[j][n], a, b[n][0], b[n][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the KP partial sums of a column group, in a fixed tree order
  float* red = reinterpret_cast<float*>(smem);
  for (int half = KP / 2; half >= 1; half >>= 1) {
    if (kp >= half && kp < 2 * half) {
      float* slot = red + (cgi * half + kp - half) * (8 * NT * 32);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            slot[((j * NT + n) * 4 + e) * 32 + lane] = acc[j][n][e];
    }
    __syncthreads();
    if (kp < half) {
      const float* slot = red + (cgi * half + kp) * (8 * NT * 32);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][n][e] += slot[((j * NT + n) * 4 + e) * 32 + lane];
    }
    __syncthreads();
  }
  // the block's partial as (rows, bn) f32, columns back in place
  float* part = reinterpret_cast<float*>(smem + red_bytes(NT));
  if (kp == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int r = n * 8 + 2 * t;
        const int c = cgi * 32 + 4 * g + j;
        part[r * bn + c] = acc[j][n][0];
        part[(r + 1) * bn + c] = acc[j][n][1];
        part[r * bn + c + 2] = acc[j][n][2];
        part[(r + 1) * bn + c + 2] = acc[j][n][3];
      }
  }
  cluster.sync();
  // each rank of the cluster finishes a share of the outputs, summing the
  // S partials in rank order
  const int E = B * bn;
  const int e1 = (rank + 1) * E / S;
  for (int e = rank * E / S + threadIdx.x; e < e1; e += kMThreads) {
    const int r = e / bn, c = e % bn;
    if (n0 + c >= N) continue;
    float v = 0.f;
    if (S == 1)  // a plain read keeps this loop's loads in flight
      v = part[e];
    else
      for (int q = 0; q < S; ++q) v += cluster.map_shared_rank(part, q)[e];
    out[static_cast<size_t>(r) * N + n0 + c] =
        __float2bfloat16(v * scale[n0 + c]);
  }
  cluster.sync();
}

static_assert(2 * smem_bytes(128, 8) <= 227 * 1024, "two blocks an SM");

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int NT, bool kAligned>
cudaError_t launch_mma(const __nv_bfloat16* x, const int8_t* w,
                       const float* scale, __nv_bfloat16* out, int B, int K,
                       int N, cudaStream_t s) {
  // The widest strip (128, 64 or 32 columns) whose strips, split up to 8
  // ways along K, give every SM a block; then as few K splits as do.
  const int slots = sm_count();
  const int nk = (K + kBK - 1) / kBK;
  const int max_split = nk < kMaxCluster ? nk : kMaxCluster;
  int bn = 128;
  while (bn > 32 && (N + bn - 1) / bn * max_split < slots) bn /= 2;
  const int strips = (N + bn - 1) / bn;
  int S = slots / strips;
  S = S < max_split ? S : max_split;
  S = S > 1 ? S : 1;
  const int smem = smem_bytes(bn, NT);
  auto kernel = int8_matmul_mma_kernel<NT, kAligned>;
  static bool opted_in = false;  // once per instantiation, for any bn
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(128, NT));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips, S, 1);
  cfg.blockDim = dim3(kMThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;  // a plain launch is a cluster of one
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, x, w, scale, out, B, K, N, bn / 32);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kAligned>
cudaError_t launch_rows(const __nv_bfloat16* x, const int8_t* w,
                        const float* scale, __nv_bfloat16* out, int B, int K,
                        int N, cudaStream_t s) {
  const int nt = (B + 7) / 8;
  if (nt <= 1) return launch_mma<1, kAligned>(x, w, scale, out, B, K, N, s);
  if (nt <= 2) return launch_mma<2, kAligned>(x, w, scale, out, B, K, N, s);
  if (nt <= 4) return launch_mma<4, kAligned>(x, w, scale, out, B, K, N, s);
  if (nt <= 6) return launch_mma<6, kAligned>(x, w, scale, out, B, K, N, s);
  return launch_mma<8, kAligned>(x, w, scale, out, B, K, N, s);
}

}  // namespace

// x_dtype: 0 float32, 1 bfloat16 (out has x's dtype). Returns a cudaError_t.
extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* out, int B, int K,
                                  int N, int x_dtype, void* stream) {
  if (B < 1 || B > kMaxB || K < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    const dim3 grid((N + kBN - 1) / kBN, (B + kBT - 1) / kBT);
    const bool vec =
        N % kCols == 0 && reinterpret_cast<uintptr_t>(w) % 8 == 0;
    int8_matmul_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(out), B, K, N,
        vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (x_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const bool aligned = N % 16 == 0 && K % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaError_t e =
      aligned ? launch_rows<true>(xb, wq, sc, ob, B, K, N, s)
              : launch_rows<false>(xb, wq, sc, ob, B, K, N, s);
  return static_cast<int>(e);
}
