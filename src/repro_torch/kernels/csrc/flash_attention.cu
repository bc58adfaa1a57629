// Flash attention for Hopper (sm_90a), FP32 FFMA, hand-written.
//
// Replaces: src/repro/kernels/flash_attention.py::_attn_kernel, the Pallas
// TPU kernel that computes online-softmax attention over a
// (B, Hq, Sq/bq, Skv/bkv) grid, carrying the running max, denominator and
// output accumulator in VMEM scratch across the kv grid axis.
//
// What it computes, exactly as the TPU kernel does: for q (B, Hq, Sq, D)
// and k, v (B, Hkv, Skv, D), with the kv head of query head h being
// h / (Hq / Hkv) (GQA by index, nothing repeated), per kv block
//   s = (q k^T) * scale                        scale = 1 / sqrt(D)
//   s = softcap * tanh(s / softcap)            when softcap > 0
//   s = mask ? s : -1e30                       causal q >= k, window q - k < w
//   m' = max(m, rowmax s); p = exp(s - m'); alpha = exp(m - m')
//   l = l * alpha + rowsum p;  acc = acc * alpha + round(p) v
// and out = acc / max(l, 1e-30), cast to the input dtype.  round(p) is p
// rounded to the value dtype (a no-op for float32), as the TPU kernel's
// p.astype(v.dtype); the denominator sums the unrounded p.  Masked logits
// take the finite sentinel -1e30, never -inf: a sliding-window row whose
// first kv blocks are all masked accumulates exp(0) = 1 garbage there, and
// the first real block's alpha = exp(-1e30 - m') = 0 wipes it; with -inf
// the same row would give exp(-inf + inf) = NaN.  Every kv block is visited,
// fully masked or not, as on the TPU, so the grid-step count the device
// models scale by (attn_grid_steps) is the work this kernel does.
//
// Design.  On the TPU the kv axis is a sequential grid dimension.  On
// Hopper blocks run in parallel and in no order, so one thread block owns
// one (b, h, query block) and loops over the kv blocks itself, keeping the
// running max, denominator and the (bq x D) accumulator in registers.
// 256 threads form a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i
// (i < TM = bq / 16) of the query block, the logit columns tx + 16 j
// (j < TN = bkv / 16) of the score tile and the output columns tx + 16 c
// (c < TD = D / 16) of the accumulator.  The 16 threads that share a row
// are one half-warp, so the row max and row sum are four xor-shuffles.
// Shared memory holds the query block transposed (D x (bq + 1), read as a
// broadcast), one kv buffer that holds k transposed (D x (bkv + 1)) while
// the logits are formed and then v row-major (bkv x D) for the P V product,
// and the probability tile (bq x ldp, ldp % 32 == 16 so neither its stores
// nor its row-broadcast reads conflict).  Sharing the k/v buffer keeps the
// largest tile, bq = bkv = D = 128, at 205,824 bytes, within the 232,448
// bytes a block may opt into; staging both would need 271,360.  The
// padding of the transposed tiles (+1) keeps their transposing stores free
// of bank conflicts.  bfloat16 inputs are converted to float32 on the way
// into shared memory.
//
// Instantiations: bq, bkv, D in {16, 32, 64, 128} (TM, TN, TD are template
// parameters: register arrays need compile-time sizes), float32 and
// bfloat16: 128 kernels.
//
// What bounds it on the H100: causal attention at D = 128 does 4 D flops
// per (query, key) pair against 16 D bytes of q, k, v and o per row, so
// at long sequences it is bound by operations: the FP32 FFMA rate (67
// TFLOP/s outside the tensor cores, 700 W) for float32, and for bfloat16
// the tensor cores' 989 TFLOP/s, which this FFMA kernel cannot reach.  Each
// logit costs (TM + TN) / (TM TN) shared loads per FFMA (1/4 at 8 x 8),
// and the kernel computes the masked upper triangle too, twice the work a
// causal kernel needs.  Skipping masked blocks (with a visited-block step
// count), wgmma on the tensor cores and a TMA pipeline are later designs.
//
// The launcher allocates nothing, never synchronises, launches on the
// stream it is given, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;          // threads per tile row / column
constexpr float kNegInf = -1e30f;  // the TPU kernel's finite mask sentinel

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch's cast
}

// p as the value dtype holds it (the TPU kernel's p.astype(v.dtype))
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// padded row stride of the probability tile: ldp % 32 == 16
__host__ __device__ constexpr int prob_stride(int bkv) {
  return bkv + 16 - bkv % 32;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int TM, int TN, int TD>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
            int sq, int skv, float scale, int causal, int window,
            float softcap) {
  constexpr int BQ = kSide * TM;
  constexpr int BKV = kSide * TN;
  constexpr int D = kSide * TD;
  constexpr int LDQ = BQ + 1;   // qs[c * LDQ + r] = q[row0 + r][c]
  constexpr int LDK = BKV + 1;  // kv[c * LDK + r] = k[col0 + r][c]
  constexpr int LDP = prob_stride(BKV);
  extern __shared__ float smem[];
  float* qs = smem;            // D x LDQ
  float* kv = qs + D * LDQ;    // D x LDK for k; BKV x D for v
  float* ps = kv + D * LDK;    // BQ x LDP

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int qblk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const size_t q_off =
      ((static_cast<size_t>(b) * hq + h) * sq + static_cast<size_t>(qblk) * BQ) *
      D;
  const size_t kv_base = (static_cast<size_t>(b) * hkv + hk) * skv * D;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    qs[c * LDQ + r] = to_float(q[q_off + idx]);
  }

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.0f;
  }

  const int nkv = skv / BKV;
  for (int j = 0; j < nkv; ++j) {
    const size_t kv_off = kv_base + static_cast<size_t>(j) * BKV * D;
    __syncthreads();  // the previous block's v and p reads are done
    for (int idx = tid; idx < BKV * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      kv[c * LDK + r] = to_float(k[kv_off + idx]);
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) s[i][t] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[TM], bk[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[c * LDQ + ty + kSide * i];
#pragma unroll
      for (int t = 0; t < TN; ++t) bk[t] = kv[c * LDK + tx + kSide * t];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) s[i][t] = fmaf(a[i], bk[t], s[i][t]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qp = qblk * BQ + ty + kSide * i;
      float rmax = kNegInf;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int kp = j * BKV + tx + kSide * t;
        float x = s[i][t] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool keep = true;
        if (causal) keep = qp >= kp;
        if (window > 0) keep = keep && (qp - kp) < window;
        s[i][t] = keep ? x : kNegInf;
        rmax = fmaxf(rmax, s[i][t]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(rmax));
      float rsum = 0.0f;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float p = expf(s[i][t] - m_new);
        rsum += p;
        s[i][t] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(rsum);
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }

    __syncthreads();  // every read of k is done: v takes the buffer
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t)
        ps[(ty + kSide * i) * LDP + tx + kSide * t] = s[i][t];
    for (int idx = tid; idx < BKV * D; idx += kThreads)
      kv[idx] = to_float(v[kv_off + idx]);
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BKV; ++r) {
      float p[TM], vv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = ps[(ty + kSide * i) * LDP + r];
#pragma unroll
      for (int c = 0; c < TD; ++c) vv[c] = kv[r * D + tx + kSide * c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < TD; ++c)
      out[q_off + static_cast<size_t>(ty + kSide * i) * D + tx + kSide * c] =
          from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int TM, int TN, int TD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  constexpr int BQ = kSide * TM;
  constexpr int BKV = kSide * TN;
  constexpr int D = kSide * TD;
  const size_t smem = sizeof(float) * (static_cast<size_t>(D) * (BQ + 1) +
                                       static_cast<size_t>(D) * (BKV + 1) +
                                       static_cast<size_t>(BQ) *
                                           prob_stride(BKV));
  auto kernel = attn_kernel<T, TM, TN, TD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sq / BQ, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv, scale,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TD>
int dispatch_tiles(const void* q, const void* k, const void* v, void* out,
                   int b, int hq, int hkv, int sq, int skv, int bq, int bkv,
                   float scale, int causal, int window, float softcap,
                   cudaStream_t s) {
#define REPRO_TILE(TM_, TN_)                                              \
  if (bq == kSide * (TM_) && bkv == kSide * (TN_))                        \
    return launch<T, TM_, TN_, TD>(q, k, v, out, b, hq, hkv, sq, skv,     \
                                   scale, causal, window, softcap, s);
  REPRO_TILE(1, 1) REPRO_TILE(1, 2) REPRO_TILE(1, 4) REPRO_TILE(1, 8)
  REPRO_TILE(2, 1) REPRO_TILE(2, 2) REPRO_TILE(2, 4) REPRO_TILE(2, 8)
  REPRO_TILE(4, 1) REPRO_TILE(4, 2) REPRO_TILE(4, 4) REPRO_TILE(4, 8)
  REPRO_TILE(8, 1) REPRO_TILE(8, 2) REPRO_TILE(8, 4) REPRO_TILE(8, 8)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int hq, int hkv, int sq, int skv, int d, int bq, int bkv,
             float scale, int causal, int window, float softcap,
             cudaStream_t s) {
  switch (d) {
    case 16:
      return dispatch_tiles<T, 1>(q, k, v, out, b, hq, hkv, sq, skv, bq, bkv,
                                  scale, causal, window, softcap, s);
    case 32:
      return dispatch_tiles<T, 2>(q, k, v, out, b, hq, hkv, sq, skv, bq, bkv,
                                  scale, causal, window, softcap, s);
    case 64:
      return dispatch_tiles<T, 4>(q, k, v, out, b, hq, hkv, sq, skv, bq, bkv,
                                  scale, causal, window, softcap, s);
    case 128:
      return dispatch_tiles<T, 8>(q, k, v, out, b, hq, hkv, sq, skv, bq, bkv,
                                  scale, causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The caller guarantees contiguous
// (B, H, S, D) operands on the current device, hq % hkv == 0 and blocks
// that divide the sequence lengths.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int b, int hq, int hkv, int sq, int skv,
                          int d, int bq, int bkv, float scale, int causal,
                          int window, float softcap, int dtype,
                          void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || skv <= 0 ||
      bq <= 0 || bkv <= 0 || sq % bq || skv % bkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, b, hq, hkv, sq, skv, d, bq, bkv,
                           scale, causal, window, softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, skv, d, bq,
                                   bkv, scale, causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
