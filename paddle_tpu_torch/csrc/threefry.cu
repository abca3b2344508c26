// Threefry-2x32 counter hashing for Hopper (sm_90a): the bits behind the
// port's `jax.random` (paddle_tpu_torch/random.py).
//
// The JAX package has no Pallas kernel here: its sampling calls
// jax.random (paddle_tpu/inference/generate.py `_sample_from`:2093, the
// per-row `jax.vmap(jax.random.split)` of the chunk programs :867), and
// XLA lowers the `threefry2x32_p` primitive itself
// (jax/_src/prng.py `_threefry2x32_lowering`). With
// `jax_threefry_partitionable` on (JAX 0.9's default) every draw hashes an
// iota of counters: `split(key, n)` is the pair of threefry words of
// counters 0..n-1, 32-bit `random_bits` their xor, and `fold_in(key, d)`
// the pair of counter d. This kernel computes exactly that: for R keys
// and a counter count n it writes, for key r and counter i, the two words
// of threefry2x32(key_r, (hi 0, lo base + i)) as one 8-byte pair, so the
// (R, n, 2) output is the split layout itself. The plain version is
// ops/kernels/threefry.py `threefry_words_ref`, int64 arithmetic masked to
// 32 bits; both give the same bits.
//
// One thread per counter; the 20 rounds (rotations 13 15 26 6 / 17 29 16
// 24) and 5 key injections are unrolled on uint32_t, each rotation one
// funnel shift. Only integers cross the kernel: the floats a sampler
// makes of the bits are torch ops on both routes.
//
// What bounds it: the stores, 8 bytes a counter (the served sampling step
// hashes 8 x 32000 counters: 2 MB, about 0.6 us at 3.35 TB/s); about 75
// integer operations a counter run beside them. Neighbouring
// threads store neighbouring 8-byte pairs, so a warp writes 256
// contiguous bytes. A launch is a few microseconds at that size, so the
// kernel is as simple as the work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

__global__ void __launch_bounds__(kThreads)
threefry_kernel(const uint32_t* __restrict__ keys, int n, uint32_t base,
                uint2* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int r = blockIdx.y;
  const uint32_t k0 = keys[2 * r];
  const uint32_t k1 = keys[2 * r + 1];
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0;                 // counter hi word 0, plus k0
  uint32_t x1 = base + static_cast<uint32_t>(i) + k1;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  out[static_cast<size_t>(r) * n + i] = make_uint2(x0, x1);
}

}  // namespace

// keys: R pairs of uint32 (device); out: R * n pairs (device, 8-byte
// aligned). Counters base .. base + n - 1 (mod 2^32) under each key.
extern "C" int threefry_launch(const void* keys, int R, int n,
                               unsigned int base, void* out, void* stream) {
  if (R < 1 || R > 65535 || n < 1 || keys == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, R);
  threefry_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), n, base, static_cast<uint2*>(out));
  return static_cast<int>(cudaGetLastError());
}
