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
// and out = acc / max(l, 1e-30), cast to the input dtype.  When the caller
// passes a row-statistics buffer, each row's log-sum-exp m + log(max(l,
// 1e-30)) after its last kv block is written there in float32 (B, Hq, Sq):
// the backward (flash_attention_bwd.cu) recomputes p = exp(s - lse) from
// it.  A null buffer writes nothing, so prefill and serve are unchanged.
// round(p) is p
// rounded to the value dtype (a no-op for float32), as the TPU kernel's
// p.astype(v.dtype); the denominator sums the unrounded p.  Masked logits
// take the finite sentinel -1e30, never -inf.
//
// Block skipping.  The thread block of query block i visits only the kv
// blocks that hold a kept (query, key) pair: under causal those up to the
// diagonal, under window > 0 those from (i bq - window + 1) / bkv (rounded
// down, clamped at 0) -- attn_kv_range in flash_attention.py, which the
// step count and the tests use.  Skipping is exact.  A block masked for a
// whole row adds nothing once a real block has set the row's max
// (p = exp(-1e30 - m) = 0, alpha = 1); before that, what it adds (exp(0) =
// 1 per key) is wiped by the first real block's alpha = exp(-1e30 - m) =
// 0.  One case is not skipped: a query block with a row whose window lies
// wholly past the keys (Sq > Skv).  Such a row keeps no key, so the
// reference returns the mean of v over every key (l = Skv, nothing wipes
// it); the block visits every kv block, as the TPU kernel does.
//
// Design.  On the TPU the kv axis is a sequential grid dimension.  On
// Hopper blocks run in parallel and in no order, so one thread block owns
// one (b, h, query block) and loops over its kv blocks itself, keeping the
// running max, denominator and the (bq x D) accumulator in registers.  The
// grid is one dimension, query blocks in descending order outermost, so
// under causal the blocks with the most kv blocks start first and the
// short ones fill the tail of the last wave.
//
//  * 256 threads form a 16 x 16 grid.  Thread (ty, tx) owns query rows
//    ty + 16 i (i < TM = bq / 16), logit columns tx + 16 t (t < TN =
//    bkv / 16) and output columns tx * 4 + e + 64 g (TD = D / 16 of them;
//    tx * TD + e when TD < 4).  The 16 threads of a row are one half-warp:
//    the row max and row sum are four xor-shuffles.
//  * q k^T reads q and k row-major along D in 16-byte loads: per four
//    D steps a thread loads TN k vectors and TM q vectors for 4 TM TN
//    FFMAs.  The 16-byte chunks of each q and k row are XOR-swizzled by the
//    row's low bits, so the 16 k rows a half-warp reads land in 8 distinct
//    bank groups and the two q rows of a warp never collide.  p v reads
//    the probability tile along kv in 16-byte loads (TM of them per four
//    kv steps) and each v row as TD / 4 neighbouring 16-byte loads.
//  * q, k and v tiles are copied by cp.async (16 bytes each, no registers)
//    into one q tile, one k tile and one v tile.  The k tile of block j + 1
//    is in flight while p v of block j runs, and the v tile of block j + 1
//    while q k^T and the softmax of block j + 1 run: each copy overlaps the
//    other product.  Three barriers a kv block (five at bkv = 128).
//  * Shared memory at D = 128, bq = bkv = 128 in float32: q, k and v take
//    64 KB each, so two stages of both k and v cannot fit in the 232,448
//    bytes a block may opt into.  Splitting k from v (rather than holding q
//    in registers, which would cost 64 more a thread, or exchanging p by
//    shuffles, one shuffle per 8 FFMAs) gives the overlap of two stages at
//    the cost of one.  The probability tile is staged in column chunks of
//    at most 64 (32 KB), so bq = bkv = 128 takes 229,376 bytes and every
//    (bq, bkv) <= 128 stays legal at every head dim.
//  * bfloat16 operands are copied as they are and converted to float32 as
//    threads load them for the FFMAs.
//
// Instantiations: bq, bkv, D in {16, 32, 64, 128} (TM, TN, TD are template
// parameters: register arrays need compile-time sizes), float32 and
// bfloat16: 128 kernels.
//
// What bounds it on the H100: causal attention at D = 128 does 4 D flops
// per kept (query, key) pair against 16 D bytes of q, k, v and o per row,
// so at long sequences it is bound by operations: the FP32 FFMA rate (67
// TFLOP/s outside the tensor cores, 700 W) for float32, and for bfloat16
// the tensor cores' 989 TFLOP/s, which this FFMA kernel cannot reach.  The
// blocks on the diagonal still compute their masked half.  wgmma on the
// tensor cores for bfloat16, TMA and warp specialisation are later designs.
//
// The launcher allocates nothing, never synchronises, launches on the
// stream it is given, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// four consecutive elements of shared memory as float32 (16-byte aligned
// for float, 8-byte for bfloat16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row-major (rows x D) tile of T with the 16-byte chunks of row r stored
// at chunk c ^ (r & kMask): the offset of element (r, col).  Four elements
// from a col % 4 == 0 stay within one chunk.
template <typename T, int D>
struct Swizzled {
  static constexpr int kEpc = 16 / sizeof(T);  // elements per chunk
  static constexpr int kCpr = D / kEpc;         // chunks per row
  static constexpr int kMask = (kCpr < 8 ? kCpr : 8) - 1;
  __device__ static __forceinline__ int at(int r, int col) {
    return r * D + (((col / kEpc) ^ (r & kMask)) * kEpc) + col % kEpc;
  }
};

// cp.async of `rows` contiguous rows of D elements into shared memory,
// swizzled or as they lie
template <typename T, int D, bool kSwizzle>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows,
                                          int tid) {
  using S = Swizzled<T, D>;
  for (int idx = tid; idx < rows * S::kCpr; idx += kThreads) {
    const int r = idx / S::kCpr, c = idx % S::kCpr;
    const int pc = kSwizzle ? (c ^ (r & S::kMask)) : c;
    cp_async16(dst + r * D + pc * S::kEpc,
               src + static_cast<size_t>(r) * D + c * S::kEpc);
  }
}

// output column of a thread's c-th accumulator
template <int TD>
__device__ __forceinline__ int out_col(int tx, int c) {
  return TD >= 4 ? (c / 4) * 64 + tx * 4 + c % 4 : tx * TD + c;
}

template <typename T, int TM, int TN, int TD>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out,
            float* __restrict__ lse, int nb, int hq,
            int hkv, int sq, int skv, float scale, int causal, int window,
            float softcap) {
  constexpr int BQ = kSide * TM;
  constexpr int BKV = kSide * TN;
  constexpr int D = kSide * TD;
  constexpr int PC = BKV < 64 ? BKV : 64;  // probability tile columns
  constexpr int TNC = PC / kSide;          // logit columns a chunk holds
  constexpr int NCH = TN / TNC;            // chunks per kv block
  using SQK = Swizzled<T, D>;
  using SP = Swizzled<float, PC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // BQ x D, swizzled
  T* ks = qs + BQ * D;                     // BKV x D, swizzled
  T* vs = ks + BKV * D;                    // BKV x D, as it lies
  float* ps = reinterpret_cast<float*>(vs + BKV * D);  // BQ x PC, swizzled

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int nq = sq / BQ;
  const int nbh = nb * hq;
  const int qblk = nq - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int bh = static_cast<int>(blockIdx.x) % nbh;
  const int h = bh % hq;
  const int b = bh / hq;
  const int hk = h / (hq / hkv);
  const int q0 = qblk * BQ;
  const size_t q_off =
      ((static_cast<size_t>(b) * hq + h) * sq + static_cast<size_t>(q0)) * D;
  const T* kv_k = k + (static_cast<size_t>(b) * hkv + hk) * skv * D;
  const T* kv_v = v + (static_cast<size_t>(b) * hkv + hk) * skv * D;

  // the kv blocks holding a kept pair (attn_kv_range)
  const int nkv = skv / BKV;
  int lo = 0, hi = nkv;
  if (causal) hi = min(nkv, (q0 + BQ - 1) / BKV + 1);
  if (window > 0) {
    if (q0 + BQ - 1 >= skv + window - 1) {
      lo = 0;  // a row keeps no key: the reference averages all of v
      hi = nkv;
    } else {
      lo = max(0, q0 - window + 1) / BKV;
    }
  }

  load_tile<T, D, true>(qs, q + q_off, BQ, tid);
  load_tile<T, D, true>(ks, kv_k + static_cast<size_t>(lo) * BKV * D, BKV,
                        tid);
  cp_async_commit();
  load_tile<T, D, false>(vs, kv_v + static_cast<size_t>(lo) * BKV * D, BKV,
                         tid);
  cp_async_commit();

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.0f;
  }

  for (int j = lo; j < hi; ++j) {
    cp_async_wait<1>();  // q and k of block j landed (v may be in flight)
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) s[i][t] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kf[TN];
#pragma unroll
      for (int t = 0; t < TN; ++t)
        kf[t] = load4(ks + SQK::at(tx + kSide * t, d));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 qf = load4(qs + SQK::at(ty + kSide * i, d));
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          s[i][t] = fmaf(qf.x, kf[t].x, s[i][t]);
          s[i][t] = fmaf(qf.y, kf[t].y, s[i][t]);
          s[i][t] = fmaf(qf.z, kf[t].z, s[i][t]);
          s[i][t] = fmaf(qf.w, kf[t].w, s[i][t]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qp = q0 + ty + kSide * i;
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
#pragma unroll
      for (int off = kSide / 2; off > 0; off /= 2)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.0f;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float p = expf(s[i][t] - m_new);
        rsum += p;
        s[i][t] = round_to<T>(p);
      }
#pragma unroll
      for (int off = kSide / 2; off > 0; off /= 2)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rsum;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }

#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TNC; ++t)
          ps[SP::at(ty + kSide * i, tx + kSide * t)] = s[i][ch * TNC + t];
      if (ch == 0) cp_async_wait<0>();  // v of block j landed
      __syncthreads();  // p is staged; every read of k is done
      if (ch == 0) {
        if (j + 1 < hi)
          load_tile<T, D, true>(
              ks, kv_k + static_cast<size_t>(j + 1) * BKV * D, BKV, tid);
        cp_async_commit();
      }
#pragma unroll 2
      for (int r = 0; r < PC; r += 4) {
        float4 pf[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          pf[i] = load4(ps + SP::at(ty + kSide * i, r));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T* vrow = vs + (ch * PC + r + e) * D;
          float vv[TD];
          if constexpr (TD >= 4) {
#pragma unroll
            for (int g = 0; g < TD / 4; ++g) {
              const float4 f = load4(vrow + 64 * g + tx * 4);
              vv[4 * g] = f.x;
              vv[4 * g + 1] = f.y;
              vv[4 * g + 2] = f.z;
              vv[4 * g + 3] = f.w;
            }
          } else {
#pragma unroll
            for (int c = 0; c < TD; ++c) vv[c] = to_float(vrow[tx * TD + c]);
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float pv = e == 0 ? pf[i].x : e == 1 ? pf[i].y
                           : e == 2 ? pf[i].z : pf[i].w;
#pragma unroll
            for (int c = 0; c < TD; ++c)
              acc[i][c] = fmaf(pv, vv[c], acc[i][c]);
          }
        }
      }
      __syncthreads();  // every read of this p chunk (and of v) is done
    }
    if (j + 1 < hi)
      load_tile<T, D, false>(
          vs, kv_v + static_cast<size_t>(j + 1) * BKV * D, BKV, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + q_off + static_cast<size_t>(ty + kSide * i) * D;
#pragma unroll
    for (int c = 0; c < TD; ++c)
      orow[out_col<TD>(tx, c)] = from_float<T>(acc[i][c] / denom);
  }
  if (lse != nullptr && tx == 0) {
    // the 16 threads of a row hold the same m and l (xor-shuffled)
#pragma unroll
    for (int i = 0; i < TM; ++i)
      lse[(static_cast<size_t>(b) * hq + h) * sq + q0 + ty + kSide * i] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T, int TM, int TN, int TD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int hq, int hkv, int sq, int skv, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  constexpr int BQ = kSide * TM;
  constexpr int BKV = kSide * TN;
  constexpr int D = kSide * TD;
  constexpr int PC = BKV < 64 ? BKV : 64;
  const size_t smem =
      sizeof(T) * static_cast<size_t>(BQ + 2 * BKV) * D +
      sizeof(float) * static_cast<size_t>(BQ) * PC;
  auto kernel = attn_kernel<T, TM, TN, TD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(sq / BQ) * hq * b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, b, hq, hkv, sq,
      skv, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TD>
int dispatch_tiles(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int hq, int hkv, int sq, int skv,
                   int bq, int bkv, float scale, int causal, int window,
                   float softcap, cudaStream_t s) {
#define REPRO_TILE(TM_, TN_)                                              \
  if (bq == kSide * (TM_) && bkv == kSide * (TN_))                        \
    return launch<T, TM_, TN_, TD>(q, k, v, out, lse, b, hq, hkv, sq, skv,\
                                   scale, causal, window, softcap, s);
  REPRO_TILE(1, 1) REPRO_TILE(1, 2) REPRO_TILE(1, 4) REPRO_TILE(1, 8)
  REPRO_TILE(2, 1) REPRO_TILE(2, 2) REPRO_TILE(2, 4) REPRO_TILE(2, 8)
  REPRO_TILE(4, 1) REPRO_TILE(4, 2) REPRO_TILE(4, 4) REPRO_TILE(4, 8)
  REPRO_TILE(8, 1) REPRO_TILE(8, 2) REPRO_TILE(8, 4) REPRO_TILE(8, 8)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int b, int hq, int hkv, int sq, int skv, int d,
             int bq, int bkv, float scale, int causal, int window,
             float softcap, cudaStream_t s) {
  switch (d) {
    case 16:
      return dispatch_tiles<T, 1>(q, k, v, out, lse, b, hq, hkv, sq, skv,
                                  bq, bkv, scale, causal, window,
                                  softcap, s);
    case 32:
      return dispatch_tiles<T, 2>(q, k, v, out, lse, b, hq, hkv, sq, skv,
                                  bq, bkv, scale, causal, window,
                                  softcap, s);
    case 64:
      return dispatch_tiles<T, 4>(q, k, v, out, lse, b, hq, hkv, sq, skv,
                                  bq, bkv, scale, causal, window,
                                  softcap, s);
    case 128:
      return dispatch_tiles<T, 8>(q, k, v, out, lse, b, hq, hkv, sq, skv,
                                  bq, bkv, scale, causal, window,
                                  softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The caller guarantees contiguous,
// 16-byte aligned (B, H, S, D) operands on the current device,
// hq % hkv == 0 and blocks that divide the sequence lengths.  lse is null
// or a float32 (B, Hq, Sq) buffer for the rows' log-sum-exp.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, void* lse, int b, int hq, int hkv,
                          int sq, int skv, int d, int bq, int bkv,
                          float scale, int causal, int window, float softcap,
                          int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || skv <= 0 ||
      bq <= 0 || bkv <= 0 || sq % bq || skv % bkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, static_cast<float*>(lse), b, hq,
                           hkv, sq, skv, d, bq, bkv, scale, causal, window,
                           softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, static_cast<float*>(lse), b,
                                   hq, hkv, sq, skv, d, bq, bkv, scale,
                                   causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
