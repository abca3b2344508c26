// The f32 flash-attention path (checks only: no main path runs f32 flash
// attention on the card): blocks of 4 warps over 64 x 64 tiles staged in
// shared memory, products on the CUDA cores in exact f32. wgmma has no f32
// type, so this path keeps the first design. Shared by flash_fwd.cu and
// flash_bwd.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_f32 {

constexpr int kBQ = 64;   // query rows per tile
constexpr int kBK = 64;   // key rows per tile
constexpr int kThreads = 128;

// Shared-memory pitches in floats: tiles pad by 4 so rows start on
// different banks.
template <int D>
struct Pitch {
  static constexpr int io = D + 4;    // q/k/v/do tiles and accumulators
  static constexpr int s = kBK + 4;   // (64, 64) score tiles
};

// C[M][N] (pitch ldc) = (ACC ? C : 0) + A[M][K] * B[K][N]. A_COL: A(m, k)
// = A[k * lda + m], else A[m * lda + k]. B_COL: B(k, n) = B[n * ldb + k],
// else B[k * ldb + n]. The caller synchronizes the block before and after.
template <int M, int N, int K, bool A_COL, bool B_COL, bool ACC>
__device__ __forceinline__ void block_mm(float* C, int ldc, const float* A,
                                         int lda, const float* B, int ldb) {
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

// Rows [r0, r0 + R) of one head of a (B, S, H, D) tensor (row stride rs
// elements) into tile[R][Pitch<D>::io]; rows at or past S are zero.
template <int D, int R>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          int r0, int S, size_t rs) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i - r * CH) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      v = *reinterpret_cast<const float4*>(base + (r0 + r) * rs + c);
    *reinterpret_cast<float4*>(tile + r * Pitch<D>::io + c) = v;
  }
}

// tile[R][pitch] -> rows [r0, r0 + R) of one head, rows past S skipped
template <int D, int R>
__device__ __forceinline__ void store_rows(float* base, const float* tile,
                                           int pitch, int r0, int S,
                                           size_t rs) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    if (r0 + r < S) base[(r0 + r) * rs + c] = tile[r * pitch + c];
  }
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = 0.f;
}

__device__ __forceinline__ bool masked(int qi, int kj, int Sk, int offset,
                                       int causal) {
  return kj >= Sk || (causal && qi + offset < kj);
}

}  // namespace flash_f32
