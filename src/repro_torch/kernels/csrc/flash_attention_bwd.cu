// Flash-attention backward for Hopper (sm_90a), FP32 FFMA, hand-written.
//
// Replaces: no Pallas body.  The reference trains through chunked_attention
// (src/repro/models/attention.py:24), differentiated by XLA; on the TPU the
// forward kernel (src/repro/kernels/flash_attention.py::_attn_kernel) has no
// backward.  This file is the gradient of the port's forward kernel
// (flash_attention.cu), so a loss through it reaches q, k and v.
//
// What it computes, for the forward's q (B, Hq, S, D), k, v (B, Hkv, S, D),
// output o, the forward's row log-sum-exp lse (B, Hq, S) and the output's
// gradient dO, with the forward's scale, softcap and mask (kv head of query
// head h is h / (Hq / Hkv)):
//   (a) delta = rowsum(dO * o)                                  float32
//   per (query, key) pair, recomputed:
//   x = (q k^T) * scale;  t = tanh(x / cap), x = cap t   when cap > 0
//   p = keep ? exp(x - lse) : 0             (the forward's softmax row)
//   dP = dO v^T
//   dS = keep ? p (dP - delta) (1 - t^2) : 0     (no softcap: 1 - t^2 = 1)
//   (b) dV = sum over pairs and the group's query heads of round(p)^T dO,
//       dK = sum of dS^T q * scale
//   (c) dQ = sum over the row's kv blocks of dS k * scale
// round(p) is p rounded to the value dtype, the gradient of the forward's
// cast passing straight through; for float32 it is p itself.  (The forward
// rounds its unnormalised p before p v and divides by l after, so in
// bfloat16 the two roundings differ by up to one step.)  Every sum runs in
// float32 registers in a fixed order, with no atomics: the result is the
// same from run to run.  Results are cast to the input dtype.
//
// Only S = Sq = Skv is taken, so every row keeps at least its own position
// under any mask and lse is a real log-sum-exp (the forward's "row past
// every key" case cannot occur).
//
// Design.  A block is B x B pairs (B = bq = bkv, 32 or 64; the forward's
// 128 x 128 would need 256 float32 dK and dV accumulators a thread).  256
// threads form a 16 x 16 grid; thread (ty, tx) owns pair rows ty + 16 a and
// columns tx + 16 t (a, t < TB = B / 16), and output rows ty + 16 r with the
// forward's output columns (TD = D / 16 of them).
//  * (b) one thread block per (b, kv head, kv block j) holds k_j and v_j in
//    shared memory and walks the query blocks that keep a pair with j (the
//    inverse of attn_kv_range: under causal from j up, under a window until
//    the window's first block passes j), and, inside each, the Hq / Hkv query
//    heads of its group, so the GQA sum is a loop, not atomics.  Each step
//    stages q_i and dO_i (cp.async), computes s and dP in one pass over D,
//    writes round(p) and dS to shared memory, and adds them into the dV and
//    dK accumulators (TB x TD each) in registers.  kv blocks run in
//    ascending order, so under causal the blocks with the most query blocks
//    start first.
//  * (c) one thread block per (b, query head, query block i) holds q_i, dO_i,
//    lse_i and delta_i and walks attn_kv_range(i), recomputing s, dP and dS
//    (the products (b) also does) and adding dS k_j into TB x TD registers.
//    Query blocks run in descending order, as the forward's.
//  * q, k, v and dO tiles are XOR-swizzled by row, as in the forward, so
//    both the row-major q k^T / dO v^T reads and the row reads of the
//    accumulation stay within distinct bank groups; the p and dS tiles are
//    padded by four floats a row.
//  * bfloat16 operands are staged as they are and widened as threads load
//    them.
//
// Instantiations: B in {32, 64}, D in {16, 32, 64, 128}, float32 and
// bfloat16, for (b) and (c); (a) per dtype: 34 kernels.
//
// What bounds it on the H100: five products of 2 D flops a kept pair (s,
// dP, dV, dK, dQ), 2.5 times the forward's work, against q, k, v, o, dO and
// the three gradients read or written once: bound by operations, at the FP32
// FFMA rate (67 TFLOP/s outside the tensor cores, 700 W) for float32 and by
// the tensor cores' 989 TFLOP/s for bfloat16, which FFMA cannot reach.
// This design does seven products, not five ((c) recomputes s and dP), and
// stages q and dO once per kv block: a first kernel, right before fast.
// wgmma, TMA and a fused dQ are later work.
//
// The launcher allocates nothing, never synchronises, launches the three
// kernels on the stream it is given, and returns cudaGetLastError() (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;  // threads per tile row / column

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

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Row-major (rows x D) tile of T with the 16-byte chunks of row r stored at
// chunk c ^ (r & kMask), as in flash_attention.cu.
template <typename T, int D>
struct Swizzled {
  static constexpr int kEpc = 16 / sizeof(T);  // elements per chunk
  static constexpr int kCpr = D / kEpc;         // chunks per row
  static constexpr int kMask = (kCpr < 8 ? kCpr : 8) - 1;
  __device__ static __forceinline__ int at(int r, int col) {
    return r * D + (((col / kEpc) ^ (r & kMask)) * kEpc) + col % kEpc;
  }
};

// cp.async of `rows` contiguous rows of D elements into a swizzled tile
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows,
                                          int tid) {
  using S = Swizzled<T, D>;
  for (int idx = tid; idx < rows * S::kCpr; idx += kThreads) {
    const int r = idx / S::kCpr, c = idx % S::kCpr;
    cp_async16(dst + r * D + (c ^ (r & S::kMask)) * S::kEpc,
               src + static_cast<size_t>(r) * D + c * S::kEpc);
  }
}

// output column of a thread's c-th accumulator (the forward's out_col)
template <int TD>
__device__ __forceinline__ int out_col(int tx, int c) {
  return TD >= 4 ? (c / 4) * 64 + tx * 4 + c % 4 : tx * TD + c;
}

// row `r` of a swizzled tile at the thread's output columns, as float32
template <typename T, int TD>
__device__ __forceinline__ void load_row(const T* tile, int r, int tx,
                                         float (&out)[TD]) {
  using S = Swizzled<T, kSide * TD>;
  if constexpr (TD >= 4) {
#pragma unroll
    for (int g = 0; g < TD / 4; ++g) {
      const float4 f = load4(tile + S::at(r, 64 * g + tx * 4));
      out[4 * g] = f.x;
      out[4 * g + 1] = f.y;
      out[4 * g + 2] = f.z;
      out[4 * g + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < TD; ++c) out[c] = to_float(tile[S::at(r, tx * TD + c)]);
  }
}

// the kv blocks [lo, hi) query block i keeps a pair with (attn_kv_range at
// bq = bkv = B and Sq = Skv)
__device__ __forceinline__ void kv_range(int i, int nblk, int blk, int causal,
                                         int window, int& lo, int& hi) {
  lo = 0;
  hi = nblk;
  if (causal) hi = min(nblk, i + 1);
  if (window > 0) lo = max(0, i * blk - window + 1) / blk;
}

// s = q k^T and dP = dO v^T over one B x B block, for the thread's pairs
template <typename T, int TB, int D>
__device__ __forceinline__ void block_products(const T* qs, const T* gs,
                                               const T* ks, const T* vs,
                                               int tx, int ty,
                                               float (&s)[TB][TB],
                                               float (&dp)[TB][TB]) {
  using S = Swizzled<T, D>;
#pragma unroll
  for (int a = 0; a < TB; ++a)
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      s[a][t] = 0.0f;
      dp[a][t] = 0.0f;
    }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 kf[TB], vf[TB];
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      kf[t] = load4(ks + S::at(tx + kSide * t, d));
      vf[t] = load4(vs + S::at(tx + kSide * t, d));
    }
#pragma unroll
    for (int a = 0; a < TB; ++a) {
      const float4 qf = load4(qs + S::at(ty + kSide * a, d));
      const float4 gf = load4(gs + S::at(ty + kSide * a, d));
#pragma unroll
      for (int t = 0; t < TB; ++t) {
        s[a][t] = dot4(qf, kf[t], s[a][t]);
        dp[a][t] = dot4(gf, vf[t], dp[a][t]);
      }
    }
  }
}

// the forward's scalars, shared by every pair
struct PairArgs {
  float scale, softcap;
  int causal, window;
};
// p and dS of the pair (query qp, key kp) from its raw logit s and dP; a
// masked pair (the forward's -1e30 logit) has p = dS = 0
__device__ __forceinline__ void pair_grad(const PairArgs& pa, float s,
                                          float dp, float lse, float delta,
                                          int qp, int kp, float& p,
                                          float& ds) {
  float x = s * pa.scale;
  float fac = 1.0f;
  if (pa.softcap > 0.0f) {
    const float t = tanhf(x / pa.softcap);
    x = pa.softcap * t;
    fac = 1.0f - t * t;
  }
  bool keep = true;
  if (pa.causal) keep = qp >= kp;
  if (pa.window > 0) keep = keep && (qp - kp) < pa.window;
  p = keep ? expf(x - lse) : 0.0f;
  ds = keep ? p * (dp - delta) * fac : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, long long rows, int d) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;  // whole warps: one row a warp
  const T* orow = o + row * d;
  const T* grow = dout + row * d;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(to_float(orow[c]), to_float(grow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int TB, int TD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int nb, int hq, int hkv, int s,
                     PairArgs pa) {
  constexpr int B = kSide * TB;
  constexpr int D = kSide * TD;
  constexpr int PS = B + 4;  // padded row of the p and dS tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // B x D each, swizzled
  T* vs = ks + B * D;
  T* qs = vs + B * D;
  T* gs = qs + B * D;                      // dO
  float* ps = reinterpret_cast<float*>(gs + B * D);  // B x PS: round(p)
  float* dss = ps + B * PS;                          // B x PS: dS
  float* lse_s = dss + B * PS;
  float* del_s = lse_s + B;

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int nblk = s / B;
  const int nbh = nb * hkv;
  const int j = static_cast<int>(blockIdx.x) / nbh;
  const int bh = static_cast<int>(blockIdx.x) % nbh;
  const int hk = bh % hkv;
  const int b = bh / hkv;
  const int group = hq / hkv;
  const size_t kv_off =
      ((static_cast<size_t>(b) * hkv + hk) * s + static_cast<size_t>(j) * B) *
      D;
  load_tile<T, D>(ks, k + kv_off, B, tid);
  load_tile<T, D>(vs, v + kv_off, B, tid);
  cp_async_commit();

  float adk[TB][TD], adv[TB][TD];
#pragma unroll
  for (int r = 0; r < TB; ++r)
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      adk[r][c] = 0.0f;
      adv[r][c] = 0.0f;
    }

  for (int i = pa.causal ? j : 0; i < nblk; ++i) {
    int lo, hi;
    kv_range(i, nblk, B, pa.causal, pa.window, lo, hi);
    if (j < lo) break;  // lo only grows with i
    if (j >= hi) continue;
    for (int g = 0; g < group; ++g) {
      const size_t row0 =
          (static_cast<size_t>(b) * hq + hk * group + g) * s +
          static_cast<size_t>(i) * B;
      __syncthreads();  // every read of the last step's q, dO, p, dS is done
      load_tile<T, D>(qs, q + row0 * D, B, tid);
      load_tile<T, D>(gs, dout + row0 * D, B, tid);
      cp_async_commit();
      if (tid < B) {
        lse_s[tid] = lse[row0 + tid];
        del_s[tid] = delta[row0 + tid];
      }
      cp_async_wait_all();
      __syncthreads();

      float sv[TB][TB], dp[TB][TB];
      block_products<T, TB, D>(qs, gs, ks, vs, tx, ty, sv, dp);
#pragma unroll
      for (int a = 0; a < TB; ++a) {
        const int r = ty + kSide * a;
#pragma unroll
        for (int t = 0; t < TB; ++t) {
          const int c = tx + kSide * t;
          float p, ds;
          pair_grad(pa, sv[a][t], dp[a][t], lse_s[r], del_s[r], i * B + r,
                    j * B + c, p, ds);
          ps[r * PS + c] = round_to<T>(p);
          dss[r * PS + c] = ds;
        }
      }
      __syncthreads();

      // dV += round(p)^T dO and dK += dS^T q over the block's query rows
#pragma unroll 2
      for (int r = 0; r < B; ++r) {
        float gv[TD], qv[TD];
        load_row<T, TD>(gs, r, tx, gv);
        load_row<T, TD>(qs, r, tx, qv);
#pragma unroll
        for (int rr = 0; rr < TB; ++rr) {
          const float pv = ps[r * PS + ty + kSide * rr];
          const float dsv = dss[r * PS + ty + kSide * rr];
#pragma unroll
          for (int c = 0; c < TD; ++c) {
            adv[rr][c] = fmaf(pv, gv[c], adv[rr][c]);
            adk[rr][c] = fmaf(dsv, qv[c], adk[rr][c]);
          }
        }
      }
    }
  }
  cp_async_wait_all();  // a kv block no query block keeps never waited

#pragma unroll
  for (int rr = 0; rr < TB; ++rr) {
    const size_t row = kv_off + static_cast<size_t>(ty + kSide * rr) * D;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      dk[row + out_col<TD>(tx, c)] = from_float<T>(adk[rr][c] * pa.scale);
      dv[row + out_col<TD>(tx, c)] = from_float<T>(adv[rr][c]);
    }
  }
}

template <typename T, int TB, int TD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int nb, int hq, int hkv, int s, PairArgs pa) {
  constexpr int B = kSide * TB;
  constexpr int D = kSide * TD;
  constexpr int PS = B + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // B x D each, swizzled
  T* gs = qs + B * D;                      // dO
  T* ks = gs + B * D;
  T* vs = ks + B * D;
  float* dss = reinterpret_cast<float*>(vs + B * D);  // B x PS: dS
  float* lse_s = dss + B * PS;
  float* del_s = lse_s + B;

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int nblk = s / B;
  const int nbh = nb * hq;
  const int i = nblk - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int bh = static_cast<int>(blockIdx.x) % nbh;
  const int h = bh % hq;
  const int b = bh / hq;
  const int hk = h / (hq / hkv);
  const size_t row0 =
      (static_cast<size_t>(b) * hq + h) * s + static_cast<size_t>(i) * B;
  const T* kv_k = k + (static_cast<size_t>(b) * hkv + hk) * s * D;
  const T* kv_v = v + (static_cast<size_t>(b) * hkv + hk) * s * D;
  load_tile<T, D>(qs, q + row0 * D, B, tid);
  load_tile<T, D>(gs, dout + row0 * D, B, tid);
  cp_async_commit();
  if (tid < B) {
    lse_s[tid] = lse[row0 + tid];
    del_s[tid] = delta[row0 + tid];
  }

  int lo, hi;
  kv_range(i, nblk, B, pa.causal, pa.window, lo, hi);
  float adq[TB][TD];
#pragma unroll
  for (int a = 0; a < TB; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) adq[a][c] = 0.0f;

  for (int j = lo; j < hi; ++j) {
    __syncthreads();  // every read of the last block's k, v and dS is done
    load_tile<T, D>(ks, kv_k + static_cast<size_t>(j) * B * D, B, tid);
    load_tile<T, D>(vs, kv_v + static_cast<size_t>(j) * B * D, B, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float sv[TB][TB], dp[TB][TB];
    block_products<T, TB, D>(qs, gs, ks, vs, tx, ty, sv, dp);
#pragma unroll
    for (int a = 0; a < TB; ++a) {
      const int r = ty + kSide * a;
#pragma unroll
      for (int t = 0; t < TB; ++t) {
        const int c = tx + kSide * t;
        float p, ds;
        pair_grad(pa, sv[a][t], dp[a][t], lse_s[r], del_s[r], i * B + r,
                  j * B + c, p, ds);
        dss[r * PS + c] = ds;
      }
    }
    __syncthreads();

    // dQ += dS k over the block's keys, four at a time
#pragma unroll 2
    for (int kk = 0; kk < B; kk += 4) {
      float4 df[TB];
#pragma unroll
      for (int a = 0; a < TB; ++a)
        df[a] = *reinterpret_cast<const float4*>(
            dss + (ty + kSide * a) * PS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float kv[TD];
        load_row<T, TD>(ks, kk + e, tx, kv);
#pragma unroll
        for (int a = 0; a < TB; ++a) {
          const float dsv = e == 0 ? df[a].x : e == 1 ? df[a].y
                          : e == 2 ? df[a].z : df[a].w;
#pragma unroll
          for (int c = 0; c < TD; ++c)
            adq[a][c] = fmaf(dsv, kv[c], adq[a][c]);
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int a = 0; a < TB; ++a) {
    const size_t row = (row0 + ty + kSide * a) * D;
#pragma unroll
    for (int c = 0; c < TD; ++c)
      dq[row + out_col<TD>(tx, c)] = from_float<T>(adq[a][c] * pa.scale);
  }
}

template <typename T, int TB, int TD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int hq, int hkv, int s, PairArgs pa,
           cudaStream_t stream) {
  constexpr int B = kSide * TB;
  constexpr int D = kSide * TD;
  constexpr int PS = B + 4;
  const size_t tiles = sizeof(T) * 4 * static_cast<size_t>(B) * D;
  const size_t stats = sizeof(float) * 2 * static_cast<size_t>(B);
  const size_t smem_dkdv = tiles + sizeof(float) * 2 * B * PS + stats;
  const size_t smem_dq = tiles + sizeof(float) * B * PS + stats;
  auto dkdv = attn_bwd_dkdv_kernel<T, TB, TD>;
  auto dqk = attn_bwd_dq_kernel<T, TB, TD>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dkdv));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(b) * hq * s;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const long long kv_blocks = static_cast<long long>(s / B) * hkv * b;
  const long long q_blocks = static_cast<long long>(s / B) * hq * b;
  if (delta_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_delta_kernel<T><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                             stream>>>(static_cast<const T*>(o),
                                       static_cast<const T*>(dout), delta,
                                       rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<static_cast<unsigned>(kv_blocks), kThreads, smem_dkdv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), b, hq, hkv, s, pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<static_cast<unsigned>(q_blocks), kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), b, hq, hkv, s, pa);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TD>
int dispatch_block(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, int b, int hq, int hkv, int s, int blk,
                   PairArgs pa, cudaStream_t st) {
  if (blk == 32)
    return launch<T, 2, TD>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq,
                            hkv, s, pa, st);
  if (blk == 64)
    return launch<T, 4, TD>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq,
                            hkv, s, pa, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int b, int hq, int hkv, int s, int d,
             int blk, PairArgs pa, cudaStream_t st) {
  switch (d) {
    case 16:
      return dispatch_block<T, 1>(q, k, v, o, dout, lse, delta, dq, dk, dv, b,
                                  hq, hkv, s, blk, pa, st);
    case 32:
      return dispatch_block<T, 2>(q, k, v, o, dout, lse, delta, dq, dk, dv, b,
                                  hq, hkv, s, blk, pa, st);
    case 64:
      return dispatch_block<T, 4>(q, k, v, o, dout, lse, delta, dq, dk, dv, b,
                                  hq, hkv, s, blk, pa, st);
    case 128:
      return dispatch_block<T, 8>(q, k, v, o, dout, lse, delta, dq, dk, dv, b,
                                  hq, hkv, s, blk, pa, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The caller guarantees contiguous,
// 16-byte aligned operands on the current device: q, o, dout, dq (B, Hq, S,
// D), k, v, dk, dv (B, Hkv, S, D), lse and delta float32 (B, Hq, S), hq %
// hkv == 0 and a block that divides S.  delta is scratch written by (a).
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int b, int hq, int hkv,
                              int s, int d, int blk, float scale, int causal,
                              int window, float softcap, int dtype,
                              void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || s <= 0 || blk <= 0 ||
      s % blk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PairArgs pa{scale, softcap, causal, window};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s,
                           d, blk, pa, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq,
                                   hkv, s, d, blk, pa, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
