// Multi-tensor Adam / AdamW update for Hopper (sm_90a).
//
// The JAX package has no Pallas kernel for the optimizer update: its
// trainer (paddle_tpu/parallel/train.py, _single_step_fn) compiles
// optimizer.update for every parameter into the one jitted step, where XLA
// fuses it. This kernel does that work for the port in one pass over
// memory: the update of optimizer/adam.py Adam.update / AdamW.update (the
// plain version is ops/kernels/adam.py adam_ref) for a list of parameters.
//
// Per element, in f32, the plain version's operations in its order, each
// rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn are
// never contracted into an FMA), with its f32 constants: b1 = (float)beta1,
// c1 = (float)(1.0 - beta1) formed on the host in double, the same for
// beta2, eps and wd. So the result equals the plain version's bit for bit.
//   p32  = master weight, or p widened            (f32)
//   g    = g + wd * p32                           (Adam only: L2 decay)
//   b1p' = b1p * b1,  b2p' = b2p * b2              (the parameter's pows)
//   m1   = b1 * m1 + c1 * g
//   m2   = b2 * m2 + c2 * (g * g)
//   p32  = p32 * (1 - lr * wd)                    (AdamW only: decoupled)
//   p32  = p32 - (lr * (m1 / (1 - b1p'))) / (sqrt(m2 / (1 - b2p')) + eps)
// then p = p32 rounded once to p's dtype, the moments rounded to theirs
// (f32, or the parameter's under multi_precision=False), the master weight
// stored in f32. lr is read from device memory (an f32 scalar the trainer
// refills when the rate changes), so a CUDA graph of the step replays with
// the current rate.
//
// Every block of a parameter reads its beta1_pow / beta2_pow, so the update
// kernel never writes them: adam_pow_kernel, launched after it on the same
// stream, advances them.
//
// What bounds it: bytes. About 20 flops an element against 14 bytes (bf16
// p, g, m1, m2 read, p, m1, m2 written; 30 with f32 moments and a master
// weight), so the kernel must stream at the card's copy rate:
// - the tensor table (pointers, sizes, first chunk of each tensor) is a
//   __grid_constant__ kernel parameter, passed by value: a CUDA graph
//   records it with the launch, and no table lives in device memory. Up to
//   kMaxTensors tensors a launch (the table stays under the 4 KB of kernel
//   parameters); the wrapper groups the parameters by dtypes and issues
//   one launch per kMaxTensors of a group;
// - the tensors are cut into chunks of kChunk elements, numbered across the
//   table; blocks walk the chunks grid-stride and find a chunk's tensor by
//   walking the table forward (chunks only increase);
// - a thread takes 8 consecutive elements of a chunk: one 16-byte load or
//   store of each bf16 array, two of each f32 array. A tensor with a
//   pointer off 16 bytes, or the ragged tail of a tensor, goes one element
//   at a time through the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 40;
constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int kChunk = kThreads * kVec;
constexpr int kMaxBlocks = 132 * 8;

struct Table {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  void* m1[kMaxTensors];
  void* m2[kMaxTensors];
  float* master[kMaxTensors];
  float* b1p[kMaxTensors];
  float* b2p[kMaxTensors];
  long long n[kMaxTensors];
  long long chunk0[kMaxTensors + 1];   // chunk0[count]: the table's chunks
  unsigned long long vec_ok;           // bit t: tensor t's pointers 16-byte aligned
  int count;
};

struct Consts {
  float b1, b2, c1, c2, eps, wd;
};

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
  return __float2bfloat16_rn(v);
}

// eight consecutive elements, 16-byte aligned, widened to f32 / rounded back
__device__ __forceinline__ void load8(const float* s, float* v) {
  const float4 a = reinterpret_cast<const float4*>(s)[0];
  const float4 b = reinterpret_cast<const float4*>(s)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* s, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(s);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* d, const float* v) {
  reinterpret_cast<float4*>(d)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(d)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* d, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(d) = u;
}

// the per-parameter scalars of one tensor's update
struct Step {
  float lr, decay, d1, d2;
};

template <bool kAdamW>
__device__ __forceinline__ void adam_elem(float& p, float g, float& m1,
                                          float& m2, const Consts& c,
                                          const Step& s) {
  if (!kAdamW) g = __fadd_rn(g, __fmul_rn(c.wd, p));
  m1 = __fadd_rn(__fmul_rn(c.b1, m1), __fmul_rn(c.c1, g));
  m2 = __fadd_rn(__fmul_rn(c.b2, m2), __fmul_rn(c.c2, __fmul_rn(g, g)));
  const float m1h = __fdiv_rn(m1, s.d1);
  const float m2h = __fdiv_rn(m2, s.d2);
  if (kAdamW) p = __fmul_rn(p, s.decay);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, m1h),
                             __fadd_rn(__fsqrt_rn(m2h), c.eps)));
}

template <typename TP, typename TM, bool kMaster, bool kAdamW>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ Table t,
                const float* __restrict__ lr_ptr, const Consts c) {
  Step s;
  s.lr = *lr_ptr;
  s.decay = kAdamW ? __fsub_rn(1.0f, __fmul_rn(s.lr, c.wd)) : 1.0f;
  const long long total = t.chunk0[t.count];
  int ti = -1;
  for (long long chunk = blockIdx.x; chunk < total; chunk += gridDim.x) {
    if (ti < 0 || chunk >= t.chunk0[ti + 1]) {
      do {
        ++ti;
      } while (chunk >= t.chunk0[ti + 1]);
      s.d1 = __fsub_rn(1.0f, __fmul_rn(*t.b1p[ti], c.b1));
      s.d2 = __fsub_rn(1.0f, __fmul_rn(*t.b2p[ti], c.b2));
    }
    const long long n = t.n[ti];
    const long long e0 =
        (chunk - t.chunk0[ti]) * kChunk + threadIdx.x * kVec;
    if (e0 >= n) continue;
    TP* p = static_cast<TP*>(t.p[ti]) + e0;
    const TP* g = static_cast<const TP*>(t.g[ti]) + e0;
    TM* m1 = static_cast<TM*>(t.m1[ti]) + e0;
    TM* m2 = static_cast<TM*>(t.m2[ti]) + e0;
    float* w = kMaster ? t.master[ti] + e0 : nullptr;
    if (e0 + kVec <= n && ((t.vec_ok >> ti) & 1ULL)) {
      float vp[kVec], vg[kVec], v1[kVec], v2[kVec];
      if (kMaster) load8(w, vp); else load8(p, vp);
      load8(g, vg);
      load8(m1, v1);
      load8(m2, v2);
#pragma unroll
      for (int i = 0; i < kVec; ++i) adam_elem<kAdamW>(vp[i], vg[i], v1[i], v2[i], c, s);
      store8(p, vp);
      store8(m1, v1);
      store8(m2, v2);
      if (kMaster) store8(w, vp);
    } else {
      const int m = static_cast<int>(n - e0 < kVec ? n - e0 : kVec);
      for (int i = 0; i < m; ++i) {
        float vp = kMaster ? w[i] : to_f(p[i]);
        float v1 = to_f(m1[i]), v2 = to_f(m2[i]);
        adam_elem<kAdamW>(vp, to_f(g[i]), v1, v2, c, s);
        p[i] = from_f<TP>(vp);
        m1[i] = from_f<TM>(v1);
        m2[i] = from_f<TM>(v2);
        if (kMaster) w[i] = vp;
      }
    }
  }
}

// after the update: beta1_pow *= b1, beta2_pow *= b2, one thread a tensor
__global__ void adam_pow_kernel(const __grid_constant__ Table t,
                                const float b1, const float b2) {
  const int i = threadIdx.x;
  if (i < t.count) {
    *t.b1p[i] = __fmul_rn(*t.b1p[i], b1);
    *t.b2p[i] = __fmul_rn(*t.b2p[i], b2);
  }
}

template <typename TP, typename TM, bool kMaster, bool kAdamW>
cudaError_t run(const Table& t, const float* lr, const Consts& c,
                cudaStream_t st) {
  const long long total = t.chunk0[t.count];
  if (total > 0) {
    const int grid = static_cast<int>(total < kMaxBlocks ? total : kMaxBlocks);
    adam_kernel<TP, TM, kMaster, kAdamW><<<grid, kThreads, 0, st>>>(t, lr, c);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  adam_pow_kernel<<<1, kMaxTensors, 0, st>>>(t, c.b1, c.b2);
  return cudaGetLastError();
}

template <typename TP, typename TM, bool kMaster>
cudaError_t run_adamw(int adamw, const Table& t, const float* lr,
                      const Consts& c, cudaStream_t st) {
  return adamw ? run<TP, TM, kMaster, true>(t, lr, c, st)
               : run<TP, TM, kMaster, false>(t, lr, c, st);
}

template <typename TP, typename TM>
cudaError_t run_master(int master, int adamw, const Table& t, const float* lr,
                       const Consts& c, cudaStream_t st) {
  return master ? run_adamw<TP, TM, true>(adamw, t, lr, c, st)
                : run_adamw<TP, TM, false>(adamw, t, lr, c, st);
}

}  // namespace

extern "C" int adam_max_tensors() { return kMaxTensors; }

// One update launch (and its pow launch) over `count` <= kMaxTensors
// tensors. `table` holds 8 rows of `count` int64: the addresses of p, g,
// moment1, moment2, master weight (0 without), beta1_pow, beta2_pow, and
// the element counts. dtypes: 0 f32, 1 bf16 (p and g share one; the two
// moments share one). lr: a device pointer to one f32.
extern "C" int adam_launch(const long long* table, int count, int p_dtype,
                           int m_dtype, int master, int adamw, const void* lr,
                           float b1, float b2, float c1, float c2, float eps,
                           float wd, void* stream) {
  if (count < 1 || count > kMaxTensors || p_dtype < 0 || p_dtype > 1 ||
      m_dtype < 0 || m_dtype > 1 || lr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t = {};
  t.count = count;
  t.chunk0[0] = 0;
  for (int i = 0; i < count; ++i) {
    t.p[i] = reinterpret_cast<void*>(table[i]);
    t.g[i] = reinterpret_cast<const void*>(table[count + i]);
    t.m1[i] = reinterpret_cast<void*>(table[2 * count + i]);
    t.m2[i] = reinterpret_cast<void*>(table[3 * count + i]);
    t.master[i] = reinterpret_cast<float*>(table[4 * count + i]);
    t.b1p[i] = reinterpret_cast<float*>(table[5 * count + i]);
    t.b2p[i] = reinterpret_cast<float*>(table[6 * count + i]);
    t.n[i] = table[7 * count + i];
    if (t.n[i] < 0 || (master && t.n[i] > 0 && t.master[i] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    t.chunk0[i + 1] = t.chunk0[i] + (t.n[i] + kChunk - 1) / kChunk;
    const unsigned long long bits =
        static_cast<unsigned long long>(table[i] | table[count + i] |
                                        table[2 * count + i] |
                                        table[3 * count + i] |
                                        table[4 * count + i]);
    if ((bits & 15ULL) == 0) t.vec_ok |= 1ULL << i;
  }
  const Consts c = {b1, b2, c1, c2, eps, wd};
  const float* lrp = static_cast<const float*>(lr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p_dtype == 1 && m_dtype == 1)
    e = run_master<__nv_bfloat16, __nv_bfloat16>(master, adamw, t, lrp, c, st);
  else if (p_dtype == 1)
    e = run_master<__nv_bfloat16, float>(master, adamw, t, lrp, c, st);
  else if (m_dtype == 1)
    e = run_master<float, __nv_bfloat16>(master, adamw, t, lrp, c, st);
  else
    e = run_master<float, float>(master, adamw, t, lrp, c, st);
  return static_cast<int>(e);
}
