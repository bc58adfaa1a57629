// AdamW's optimizer step for Hopper (sm_90a), hand-written: each gradient's
// sum of squares for the global-norm clip, and the update of one tensor's
// moments and parameter (or its update) in one pass.
//
// Replaces: no Pallas body.  The reference's AdamW.update and apply_updates
// (src/repro/train/optimizer.py:38-74) are jnp code inside the jitted train
// step (src/repro/launch/steps.py:66-67), where XLA fuses each leaf's
// update into one pass over its bytes (:50-58) and its squared norm into a
// reduction.  These kernels are that fusion for the port, which runs
// eagerly: its plain version (kernels/adamw.py: adamw_update_plain) is
// about 22 elementwise launches a 2^26-element slice, each one writing and
// reading back a float32 temporary, and apply_updates one more pass.
//
// What it computes.
//  * adamw_sqnorm_partial_kernel / adamw_sqnorm_finish_kernel: the float32
//    sum of squares of one gradient (bfloat16 or float32), added in float32
//    to a running sum when one is given (acc + s, the order in which the
//    plain _squared_norm adds the tensors' sums).  Each thread sums its
//    elements' squares in float64 (exact squares, one rounding an add, far
//    below float32's), the threads of a block in a fixed tree; each block
//    writes its partial to a scratch, and one block of the finish adds the
//    partials in a fixed order and rounds once to float32.  No atomics: the
//    grid depends on n alone, so two calls give the same bits.
//  * adamw_update_kernel<TG, TP, kApply>: per element, in the order and
//    with the roundings of the plain version's separate torch kernels
//    (every operation of _update_slice one IEEE float32 operation rounded
//    to nearest, so explicit __f*_rn intrinsics: nvcc contracts a * b + c
//    into an FMA otherwise)
//      g  = g * scale                      (skipped without a clip: * 1)
//      m  = b1 m + (1 - b1) g
//      v  = b2 v + ((1 - b2) g) g
//      d  = (m / bc1) / (sqrt(v / bc2) + eps)      (IEEE divisions: torch
//                                           divides by a 0-d CUDA tensor)
//      d  = d + wd p                       (decayed tensors only)
//      u  = round_p(-lr d)
//    then writes m and v in place and either u (kApply = 0, AdamW.update)
//    or p = round_p(float(p) + float(u)) in place (kApply = 1,
//    AdamW.update_apply: what update followed by apply_updates' add rounds
//    to).  scale, bc1 and bc2 are read from 0-d device tensors, so nothing
//    waits on the host; the float constants are the float32 roundings of
//    the Python doubles, as torch rounds a Python scalar.
//
// What bounds it on the H100 (3.35 TB/s): bytes.  The update reads g, p, m
// and v and writes m, v and p (or u): 22 bytes an element for bfloat16 p
// and g, 18 flops; the norm reads g once.  The clip needs every gradient's
// norm before any update, so the two passes cannot be one: 24 bytes a
// parameter in all.  The design moves each byte once: 16-byte loads of m
// and v (float4) and 8- or 16-byte loads of g and p, four elements a
// thread an iteration in a grid-stride loop; 64-bit offsets (gemma2-27b's
// embedding holds 1.18e9 elements).  A tensor whose pointers do not all
// sit at the same element offset modulo four (a view that starts mid-
// vector in one of them) runs the scalar loop; otherwise the elements
// before the first aligned vector and after the last one run it.
//
// The wrapper (kernels/adamw.py) passes contiguous tensors on one device,
// one launch a tensor of the step's list; it allocates the partials'
// scratch (kSqBlocks doubles, reused by each tensor in stream order) and
// the running sum the norm launches add to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks of the norm's partial pass (the scratch the wrapper allocates)
constexpr int kSqBlocks = 1024;
// blocks of the update's grid-stride loop, at most
constexpr long long kUpdBlocks = 8192;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back (the parameter dtype's rounding of the update)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float2 bf2_to_f2(unsigned int bits) {
  __nv_bfloat162 h;
  *reinterpret_cast<unsigned int*>(&h) = bits;
  return __bfloat1622float2(h);
}

__device__ __forceinline__ unsigned int f2_to_bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned int*>(&h);
}

// four consecutive elements as float; p at a multiple of four elements
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo = bf2_to_f2(a.x), hi = bf2_to_f2(a.y);
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}
__device__ __forceinline__ void load4_ro(const float* p, float (&x)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}
__device__ __forceinline__ void load4_ro(const __nv_bfloat16* p,
                                         float (&x)[4]) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = bf2_to_f2(a.x), hi = bf2_to_f2(a.y);
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}

// four values stored as T, each rounded to nearest even
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&x)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(f2_to_bf2(x[0], x[1]), f2_to_bf2(x[2], x[3]));
}

// ------------------------------------------------------------- the norm --

// A block's sum in a fixed order (butterfly within each warp, then the
// warps in order by thread 0); the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
  }
  return s;
}

__device__ __forceinline__ double sq_add(double acc, float x) {
  const double d = static_cast<double>(x);
  return __fma_rn(d, d, acc);
}

// 16 bytes of g (four float32 or eight bfloat16), squares added in order
__device__ __forceinline__ double sq16(const float* p, double acc) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  acc = sq_add(acc, a.x);
  acc = sq_add(acc, a.y);
  acc = sq_add(acc, a.z);
  return sq_add(acc, a.w);
}
__device__ __forceinline__ double sq16(const __nv_bfloat16* p, double acc) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned int w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = bf2_to_f2(w[i]);
    acc = sq_add(acc, f.x);
    acc = sq_add(acc, f.y);
  }
  return acc;
}

// Each block's float64 partial of sum(g^2) over its share: elements
// [0, head) and [tail, n) by block 0's first threads, the 16-byte vectors
// between by a grid-stride loop over vector indices, four loads in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    adamw_sqnorm_partial_kernel(const T* __restrict__ g, long long n,
                                long long head, long long nvec,
                                double* __restrict__ partials) {
  constexpr int kVec = 16 / sizeof(T);
  double acc = 0.0;
  const long long tail = head + nvec * kVec;
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) acc = sq_add(acc, to_f(g[threadIdx.x]));
    if (tail + threadIdx.x < n) acc = sq_add(acc, to_f(g[tail + threadIdx.x]));
  }
  const T* base = g + head;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + 3 * stride < nvec; i += 4 * stride) {
    // the four loads issue before the adds that need them
    double a0 = sq16(base + i * kVec, 0.0);
    double a1 = sq16(base + (i + stride) * kVec, 0.0);
    double a2 = sq16(base + (i + 2 * stride) * kVec, 0.0);
    double a3 = sq16(base + (i + 3 * stride) * kVec, 0.0);
    acc += a0;
    acc += a1;
    acc += a2;
    acc += a3;
  }
  for (; i < nvec; i += stride) acc += sq16(base + i * kVec, 0.0);
  const double s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// out = acc + float(sum of the partials), or float(sum) without acc; one
// block, the partials added in a fixed order.  acc and out may be the same
// float (a running sum over a step's tensors), so neither is restrict.
__global__ void __launch_bounds__(kThreads)
    adamw_sqnorm_finish_kernel(const double* __restrict__ partials, int nb,
                               const float* acc, float* out) {
  double x = 0.0;
  for (int i = threadIdx.x; i < nb; i += kThreads) x += partials[i];
  const double s = block_sum(x);
  if (threadIdx.x == 0) {
    const float f = __double2float_rn(s);
    out[0] = acc == nullptr ? f : __fadd_rn(acc[0], f);
  }
}

// ----------------------------------------------------------- the update --

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, neglr;
  int decay;
};

// One element: m and v updated in place, the float32 update -lr d
// returned (before the parameter dtype's rounding).
__device__ __forceinline__ float adamw_elem(float g, float& m, float& v,
                                            float p, bool scaled, float scale,
                                            float bc1, float bc2,
                                            const Hyper& h) {
  if (scaled) g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps);
  float d = __fdiv_rn(__fdiv_rn(m, bc1), den);
  if (h.decay) d = __fadd_rn(d, __fmul_rn(h.wd, p));
  return __fmul_rn(h.neglr, d);
}

template <typename TG, typename TP, int kApply>
__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(const TG* __restrict__ g, float* __restrict__ m,
                        float* __restrict__ v, TP* __restrict__ p,
                        TP* __restrict__ u, long long n, long long head,
                        long long nvec, const float* __restrict__ scale,
                        const float* __restrict__ bc1p,
                        const float* __restrict__ bc2p, Hyper h) {
  const float bc1 = *bc1p, bc2 = *bc2p;
  const bool scaled = scale != nullptr;
  const float sc = scaled ? *scale : 1.0f;
  // p is read for the decay and for the add; neither, nothing to read
  const bool read_p = kApply || h.decay;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // the 4-element vectors from `head` on
  for (long long i = first; i < nvec; i += stride) {
    const long long e = head + 4 * i;
    float gf[4], mf[4], vf[4], pf[4], out[4];
    load4_ro(g + e, gf);
    load4(m + e, mf);
    load4(v + e, vf);
    if (read_p) {
      load4(p + e, pf);
    } else {
      pf[0] = pf[1] = pf[2] = pf[3] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float upd = adamw_elem(gf[j], mf[j], vf[j], pf[j], scaled, sc,
                                   bc1, bc2, h);
      out[j] = kApply ? __fadd_rn(pf[j], round_to<TP>(upd)) : upd;
    }
    store4(m + e, mf);
    store4(v + e, vf);
    store4(kApply ? p + e : u + e, out);
  }
  // the elements before the first vector and after the last (all of them
  // when nvec is 0)
  const long long tail = head + 4 * nvec;
  const long long scalars = head + (n - tail);
  for (long long j = first; j < scalars; j += stride) {
    const long long e = j < head ? j : tail + (j - head);
    float mf = m[e], vf = v[e];
    const float pf = read_p ? to_f(p[e]) : 0.0f;
    const float upd =
        adamw_elem(to_f(g[e]), mf, vf, pf, scaled, sc, bc1, bc2, h);
    m[e] = mf;
    v[e] = vf;
    if (kApply)
      p[e] = from_f<TP>(__fadd_rn(pf, round_to<TP>(upd)));
    else
      u[e] = from_f<TP>(upd);
  }
}

// The element offset of `ptr` modulo `vec` (every tensor's pointer is a
// multiple of its element size).
long long phase(const void* ptr, int size, int vec) {
  return static_cast<long long>((reinterpret_cast<uintptr_t>(ptr) / size) %
                                vec);
}

template <typename T>
int sqnorm(const void* g, long long n, const float* acc, float* out,
           double* partials, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long ph = phase(g, sizeof(T), kVec);
  const long long head = ph == 0 ? 0 : (kVec - ph < n ? kVec - ph : n);
  const long long nvec = (n - head) / kVec;
  long long nb = (nvec + kThreads - 1) / kThreads;
  nb = nb < 1 ? 1 : (nb > kSqBlocks ? kSqBlocks : nb);
  adamw_sqnorm_partial_kernel<T><<<static_cast<int>(nb), kThreads, 0,
                                   stream>>>(static_cast<const T*>(g), n,
                                             head, nvec, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adamw_sqnorm_finish_kernel<<<1, kThreads, 0, stream>>>(
      partials, static_cast<int>(nb), acc, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG, typename TP>
int update(const void* g, void* m, void* v, void* p, void* u, long long n,
           const float* scale, const float* bc1, const float* bc2,
           const Hyper& h, cudaStream_t stream) {
  const long long ph = phase(g, sizeof(TG), 4);
  const bool same = phase(m, 4, 4) == ph && phase(v, 4, 4) == ph &&
                    phase(p, sizeof(TP), 4) == ph &&
                    (u == nullptr || phase(u, sizeof(TP), 4) == ph);
  long long head = 0, nvec = 0;
  if (same) {
    head = ph == 0 ? 0 : (4 - ph < n ? 4 - ph : n);
    nvec = (n - head) / 4;
  }
  const long long work = nvec > 0 ? nvec : n;
  long long nb = (work + kThreads - 1) / kThreads;
  nb = nb < 1 ? 1 : (nb > kUpdBlocks ? kUpdBlocks : nb);
  const TG* gp = static_cast<const TG*>(g);
  float* mp = static_cast<float*>(m);
  float* vp = static_cast<float*>(v);
  TP* pp = static_cast<TP*>(p);
  if (u == nullptr)
    adamw_update_kernel<TG, TP, 1><<<static_cast<int>(nb), kThreads, 0,
                                     stream>>>(gp, mp, vp, pp, nullptr, n,
                                               head, nvec, scale, bc1, bc2,
                                               h);
  else
    adamw_update_kernel<TG, TP, 0><<<static_cast<int>(nb), kThreads, 0,
                                     stream>>>(gp, mp, vp, pp,
                                               static_cast<TP*>(u), n, head,
                                               nvec, scale, bc1, bc2, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of the norm's partial pass at most: the doubles of scratch a call
// needs.
int repro_adamw_sqnorm_blocks() { return kSqBlocks; }

// out[0] = (acc ? acc[0] + : ) float32 sum of g's squares; acc may be out.
// dtype: 0 = float32, 1 = bfloat16; partials:
// repro_adamw_sqnorm_blocks() doubles.
int repro_adamw_sqnorm(const void* g, int dtype, long long n,
                       const void* acc, void* out, void* partials,
                       void* stream) {
  if (n < 0 || (dtype != 0 && dtype != 1) || out == nullptr ||
      partials == nullptr || (n > 0 && g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  float* o = static_cast<float*>(out);
  double* part = static_cast<double*>(partials);
  return dtype == 0 ? sqnorm<float>(g, n, a, o, part, s)
                    : sqnorm<__nv_bfloat16>(g, n, a, o, part, s);
}

// One tensor's AdamW update: m and v (float32) in place, then u (u not
// null) or p in place (u null).  g_dtype, p_dtype: 0 = float32, 1 =
// bfloat16; scale may be null (no clip), bc1 and bc2 are 0-d float32
// device tensors; n elements, every tensor contiguous.
int repro_adamw_update(const void* g, int g_dtype, void* m, void* v, void* p,
                       int p_dtype, void* u, long long n, const void* scale,
                       const void* bc1, const void* bc2, float b1, float omb1,
                       float b2, float omb2, float eps, float wd, float neglr,
                       int decay, void* stream) {
  if (n <= 0 || (g_dtype != 0 && g_dtype != 1) ||
      (p_dtype != 0 && p_dtype != 1) || g == nullptr || m == nullptr ||
      v == nullptr || p == nullptr || bc1 == nullptr || bc2 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{b1, omb1, b2, omb2, eps, wd, neglr, decay};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* c1 = static_cast<const float*>(bc1);
  const float* c2 = static_cast<const float*>(bc2);
  if (g_dtype == 0 && p_dtype == 0)
    return update<float, float>(g, m, v, p, u, n, sc, c1, c2, h, s);
  if (g_dtype == 1 && p_dtype == 1)
    return update<__nv_bfloat16, __nv_bfloat16>(g, m, v, p, u, n, sc, c1, c2,
                                                h, s);
  if (g_dtype == 0)
    return update<float, __nv_bfloat16>(g, m, v, p, u, n, sc, c1, c2, h, s);
  return update<__nv_bfloat16, float>(g, m, v, p, u, n, sc, c1, c2, h, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
