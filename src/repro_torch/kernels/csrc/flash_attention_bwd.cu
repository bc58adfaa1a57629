// Flash-attention backward for Hopper (sm_90a) on the tensor cores
// (mma.sync), hand-written.
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
// float32 accumulators in a fixed order, with no atomics: the result is the
// same bits from run to run.  Results are cast to the input dtype.
//
// Only S = Sq = Skv is taken, so every row keeps at least its own position
// under any mask and lse is a real log-sum-exp (the forward's "row past
// every key" case cannot occur).
//
// What bounds it on the H100 (700 W): five products of 2 D flops a kept
// pair (s, dP, dV, dK, dQ), 2.5 times the forward's work, against q, k, v,
// o, dO and the three gradients read or written once -- bound by
// operations in every dtype:
//   bfloat16: the five products at the tensor cores' 989 TFLOP/s;
//   float32 by 3xTF32 (this file): the five products' three TF32 parts
//     (hi hi, hi lo, lo hi) at 495 TFLOP/s, six times the bfloat16 bound;
//   float32 by FFMA (the design this replaced): 67 TFLOP/s.
// What the design does about them: every product runs on the tensor cores;
// the kernels do seven products, not five ((c) recomputes s and dP), plus
// the lo half of dS in bfloat16.
//
// Design.
//  * Products with mma.sync: bfloat16 as m16n8k16 (bf16 in, float32
//    accumulate); float32 as three m16n8k8 TF32 products per product, every
//    operand split a = hi + lo with hi the nearest TF32 and lo = a - hi (of
//    which the tensor core reads the top 19 bits), hi hi + hi lo + lo hi
//    summed: the lo lo term and lo's truncation leave about 2^-21 relative,
//    float32's accuracy at three times TF32's cost, and no plain TF32
//    anywhere.  Operands a product reads along their rows go from shared
//    memory to fragments with ldmatrix; those it reads across rows
//    (k-major) with ldmatrix.trans in bfloat16 and, in float32, where .trans
//    moves 16-bit halves only, with two 4-byte loads a fragment in a depth
//    order permuted to match the accumulator layout (depth slot t is row 2t,
//    slot t + 4 row 2t + 1, in both operands).
//  * Precision of the operands built in registers.  p enters dV rounded
//    once, as round(p) is defined.  dS would lose 2^-9 relative in one
//    bfloat16 rounding (about 1.7e-3 normwise in dK and dQ in the CPU
//    emulation, 7 times the 2^-12 gate), so in bfloat16 it enters as hi =
//    bf16(dS) and lo = bf16(dS - hi), two mma into one accumulator; in
//    float32 p and dS are split hi/lo like every other operand.
//  * Tensor-core accumulators truncate.  One accumulator carried over a
//    kv block's 8192 query rows (gemma2's two heads at 4096) drifts past the
//    float32 gate, so the products of a chunk of columns start from zero
//    and are added to the float32 sums by FADD (round to nearest), which
//    tests/test_torch_attention_bwd_tc.py emulates; and in float32 the
//    small hi lo and lo hi terms of s and dP run in accumulators of their
//    own, so the chain of hi hi products over D is a third as long.
//  * (b) one thread block per (b, kv head, kv block j) of B rows (B = 16 W:
//    W row groups of 16 kv rows, two warps each, one per half of every
//    query block).  It holds k_j and v_j in shared memory and walks the
//    query blocks that keep a pair with j (the inverse of attn_kv_range:
//    under causal from j up, under a window until the window's first block
//    passes j) and, inside each, the Hq / Hkv query heads of its group, so
//    the GQA sum is a loop, not atomics.  A warp computes the transposed
//    tiles s^T = k_j q_i^T and dP^T = v_j dO_i^T, whose accumulator rows are
//    its kv rows, forms p^T and dS^T in those registers, and feeds them
//    straight back as the A operand of dV += round(p)^T dO_i and dK += dS^T
//    q_i (an m16n8 accumulator pair is an m16k16 A fragment): nothing goes
//    through shared memory.  dV sums stay in registers; dK sums too in
//    float32, while bfloat16 keeps them in shared memory as float32 (each
//    thread its own elements, read and written once a chunk), which is what
//    kept ptxas from spilling at D = 128.  At the end the two halves' sums
//    are added (x + y = y + x: the same bits whichever warp adds).  q_i,
//    dO_i, lse_i and delta_i are double-buffered: cp.async stages the next
//    (query block, head) while this one computes.
//  * (c) one thread block per (b, query head, query block i), each warp
//    owning 16 query rows with their lse and delta in registers (float32:
//    two warps a row group, one per half of every kv block), walks
//    attn_kv_range(i) in ascending order, recomputing s and dP (the two
//    products (b) also does: a fused dQ would need atomics, and results that
//    vary from run to run) and adding dS k_j into its accumulators; k_j and
//    v_j are double-buffered.  Query blocks run in descending order, as the
//    forward's.
//  * Tiles are row-major with the 16-byte chunks of row r stored at chunk c
//    ^ (r & 7) (as in the forward), so the eight rows one ldmatrix matrix
//    reads, or the eight rows a float32 fragment reads across, fall in
//    distinct bank groups.
//
// What is left: wgmma (warpgroup products from shared memory, the only way
// to the full tensor-core rate; mma.sync reaches part of it), TMA copies
// and warp specialisation in place of cp.async, and a fused dQ that stays
// deterministic (a per-kv-block dQ scratch reduced in a fixed order), which
// would save the two recomputed products.
//
// Instantiations: B in {32, 64}, D in {16, 32, 64, 128}, float32 and
// bfloat16, for (b) and (c); (a) per dtype: 34 kernels.
//
// The launcher allocates nothing, never synchronises, launches the three
// kernels on the stream it is given, and returns cudaGetLastError() (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_tools.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kDeltaThreads = 256;

// ------------------------------------------------------- the pairs --

// the kv blocks [lo, hi) query block i keeps a pair with (attn_kv_range at
// bq = bkv = B and Sq = Skv)
__device__ __forceinline__ void kv_range(int i, int nblk, int blk, int causal,
                                         int window, int& lo, int& hi) {
  lo = 0;
  hi = nblk;
  if (causal) hi = min(nblk, i + 1);
  if (window > 0) lo = max(0, i * blk - window + 1) / blk;
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

// ------------------------------------------------------- (a) delta --

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, long long rows, int d) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kDeltaThreads / kWarp) +
      threadIdx.x / kWarp;
  if (row >= rows) return;  // whole warps: one row a warp
  const T* orow = o + row * d;
  const T* grow = dout + row * d;
  float acc = 0.0f;
  for (int c = lane; c < d; c += kWarp)
    acc = fmaf(to_float(orow[c]), to_float(grow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// --------------------------------------------------- warp layout --

// A block of B = 16 W rows runs W x CW warps: warp (rw, cw) owns rows
// [16 rw, 16 rw + 16) and the cw-th of CW column slices of every block of
// the other operand, so that a block of 8 warps hides latency where one
// block fills the SM (float32's tiles; bfloat16's dK/dV pass, below).  A
// warp takes its columns in chunks, QC in the dK/dV pass and KC in the dQ
// pass, at most its slice: the s and dP tiles of a chunk hold QC / 2 (KC /
// 2) registers each (float32 twice that, with their small terms) beside
// the output accumulators, D / 2 registers a tile.  At D = 128 the dK/dV
// pass, which keeps two, takes half the chunk.
// In bfloat16 the dK/dV pass keeps each slice's dK sums in shared memory
// (float32, the thread's own elements, read and written once a chunk):
// with dK and dV both in registers beside bfloat16's faster-issuing
// products, ptxas spilled at D = 128.
template <typename T, int B, int D>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kDkShared = !kF32;
  static constexpr int CW = 2;              // the dK/dV pass
  static constexpr int CWQ = kF32 ? 2 : 1;  // the dQ pass
  static constexpr int kWant = kF32 ? 32 : 64;
  static constexpr int kWantQC = D >= 128 ? kWant / 2 : kWant;
  static constexpr int QC = kWantQC < B / CW ? kWantQC : B / CW;
  static constexpr int KC = kWant < B / CWQ ? kWant : B / CWQ;
};

__device__ __forceinline__ void add4(float4& acc, const float (&part)[4]) {
  float4 x = acc;
  x.x += part[0];
  x.y += part[1];
  x.z += part[2];
  x.w += part[3];
  acc = x;
}

// The exchange of two column slices' partial sums through shared memory:
// put_tiles writes the output tiles [n_lo, n_hi) of acc to slot `slot` of
// `red`, take_tiles adds them from there.  The loops run over every tile
// with a predicate, so the accumulators stay in registers.
template <int N>
__device__ __forceinline__ void put_tiles(float* red, int slot, int lane,
                                          const float (&acc)[N][4], int n_lo,
                                          int n_hi) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n >= n_lo && n < n_hi)
        red[(slot * N * 4 + n * 4 + e) * kWarp + lane] = acc[n][e];
}
template <int N>
__device__ __forceinline__ void take_tiles(const float* red, int slot,
                                           int lane, float (&acc)[N][4],
                                           int n_lo, int n_hi) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n >= n_lo && n < n_hi)
        acc[n][e] += red[(slot * N * 4 + n * 4 + e) * kWarp + lane];
}

// ------------------------------------------------------- (b) dK dV --

template <typename T, int W, int D>
__global__ void __launch_bounds__(W * Layout<T, 16 * W, D>::CW * kWarp)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int nb, int hq, int hkv, int s,
                     PairArgs pa) {
  using M = Mma<T>;
  using L = Layout<T, 16 * W, D>;
  constexpr int B = 16 * W;
  constexpr int kThreads = W * L::CW * kWarp;
  constexpr int NT = D / 8;        // n-tiles of dK and dV
  constexpr int QC = L::QC;
  constexpr int QT = QC / 8;       // n-tiles of s^T and dP^T
  constexpr int KS = QC / M::K;    // depth steps of dV and dK over a chunk
  static_assert(L::CW == 2, "the final exchange pairs two slices");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // B x D each, swizzled
  T* vs = ks + B * D;
  T* qs = vs + B * D;      // two stages
  T* gs = qs + 2 * B * D;  // dO, two stages
  float* lse_s = reinterpret_cast<float*>(gs + 2 * B * D);  // two stages
  float* del_s = lse_s + 2 * B;                              // two stages
  // bfloat16: dK sums of slot (cw, rw), tile n, lane at (slot NT + n) 32 +
  // lane, four floats each
  float4* dk_s = reinterpret_cast<float4*>(del_s + 2 * B);

  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int rw = warp % W, cw = warp / W;
  const int g = lane >> 2, t = lane & 3;
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
  load_tile<T, D, kThreads>(ks, k + kv_off, B, tid);
  load_tile<T, D, kThreads>(vs, v + kv_off, B, tid);
  cp_async_commit();

  // the query blocks [i0, i1) that keep a pair with j (lo only grows with i)
  const int i0 = pa.causal ? j : 0;
  int i1 = i0;
  for (; i1 < nblk; ++i1) {
    int lo, hi;
    kv_range(i1, nblk, B, pa.causal, pa.window, lo, hi);
    if (j < lo) break;
  }
  const int nsteps = (i1 - i0) * group;  // (query block, head) steps

  // stage step n's q, dO, lse and delta rows into buffer buf
  auto stage = [&](int n, int buf) {
    const size_t row0 =
        (static_cast<size_t>(b) * hq + hk * group + n % group) * s +
        static_cast<size_t>(i0 + n / group) * B;
    load_tile<T, D, kThreads>(qs + buf * B * D, q + row0 * D, B, tid);
    load_tile<T, D, kThreads>(gs + buf * B * D, dout + row0 * D, B, tid);
    for (int idx = tid; idx < B / 2; idx += kThreads) {  // B / 4 chunks each
      const int c = idx % (B / 4);
      if (idx < B / 4)
        cp_async16(lse_s + buf * B + 4 * c, lse + row0 + 4 * c);
      else
        cp_async16(del_s + buf * B + 4 * c, delta + row0 + 4 * c);
    }
  };

  float adk[L::kDkShared ? 1 : NT][4] = {}, adv[NT][4] = {};
  float4* my_dk = dk_s + (cw * W + rw) * NT * kWarp + lane;
  if constexpr (L::kDkShared)
    for (int n = 0; n < NT; ++n) my_dk[n * kWarp] = make_float4(0, 0, 0, 0);

  const int krow = 16 * rw;  // the warp's kv rows in the block
  if (nsteps > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  for (int n = 0; n < nsteps; ++n) {
    const int buf = n & 1;
    if (n + 1 < nsteps) {
      stage(n + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step n's tiles (and k, v) are in for every thread
    const int i = i0 + n / group;
    const T* qb = qs + buf * B * D;
    const T* gb = gs + buf * B * D;
    const float* lb = lse_s + buf * B;
    const float* db = del_s + buf * B;
#pragma unroll 1
    for (int c0 = cw * (B / L::CW); c0 < (cw + 1) * (B / L::CW); c0 += QC) {
      // s^T = k q^T and dP^T = v dO^T over the chunk's query columns
      typename M::Tile st[QT] = {}, dpt[QT] = {};
#pragma unroll 2
      for (int kd = 0; kd < D; kd += M::K) {
        typename M::A ka, va;
        load_a<D>(ka, ks, krow, kd, lane);
        load_a<D>(va, vs, krow, kd, lane);
#pragma unroll
        for (int n2 = 0; n2 < QT; n2 += 2) {
          typename M::B b0, b1;
          load_b<D>(b0, b1, qb, c0 + 8 * n2, kd, lane);
          mma(st[n2], ka, b0);
          mma(st[n2 + 1], ka, b1);
          load_b<D>(b0, b1, gb, c0 + 8 * n2, kd, lane);
          mma(dpt[n2], va, b0);
          mma(dpt[n2 + 1], va, b1);
        }
      }
      // p^T and dS^T: accumulator rows are kv rows, columns queries; both
      // become A fragments of the chunk's depth steps
      // (one depth step's tiles at a time, so that few values are live)
      typename M::A pf[KS];
      typename M::ASplit df[KS];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float pt[M::K / 8][4], dst[M::K / 8][4];
#pragma unroll
        for (int u = 0; u < M::K / 8; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n2 = kk * (M::K / 8) + u;
            const int r = krow + g + (e >> 1) * 8;
            const int c = c0 + 8 * n2 + 2 * t + (e & 1);
            pair_grad(pa, st[n2].get(e), dpt[n2].get(e), lb[c], db[c],
                      i * B + c, j * B + r, pt[u][e], dst[u][e]);
          }
        a_from_acc(pf[kk], pt, 0);
        a_from_acc(df[kk], dst, 0);
      }
      // dV += round(p)^T dO and dK += dS^T q, two output tiles at a time
#pragma unroll
      for (int n2 = 0; n2 < NT; n2 += 2) {
        float pv[2][4] = {}, pk[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          typename M::B b0, b1;
          load_bt<D>(b0, b1, gb, c0 + kk * M::K, 8 * n2, lane);
          mma(pv[0], pf[kk], b0);
          mma(pv[1], pf[kk], b1);
          load_bt<D>(b0, b1, qb, c0 + kk * M::K, 8 * n2, lane);
          mma(pk[0], df[kk], b0);
          mma(pk[1], df[kk], b1);
        }
        add_tiles(adv, n2, pv);
        if constexpr (L::kDkShared) {
          add4(my_dk[n2 * kWarp], pk[0]);
          add4(my_dk[(n2 + 1) * kWarp], pk[1]);
        } else {
          add_tiles(adk, n2, pk);
        }
      }
    }
    __syncthreads();  // every read of this buffer is done before its refill
  }
  cp_async_wait<0>();  // a kv block no query block keeps never waited

  // slice 0 writes dV and slice 1 dK, each after adding the other's
  // partial sums (x + y = y + x: the same bits either way)
  float* red = reinterpret_cast<float*>(qs);  // the stages are free now
  if (cw)
    put_tiles(red, W + rw, lane, adv, 0, NT);
  else if constexpr (!L::kDkShared)
    put_tiles(red, rw, lane, adk, 0, NT);
  __syncthreads();  // (and every slice's dK sums are in shared memory)
  if (cw == 0)
    take_tiles(red, W + rw, lane, adv, 0, NT);
  else if constexpr (!L::kDkShared)
    take_tiles(red, rw, lane, adk, 0, NT);
  const size_t row = kv_off + static_cast<size_t>(krow + g) * D;
#pragma unroll
  for (int n2 = 0; n2 < NT; ++n2) {
    const int col = 8 * n2 + 2 * t;
    if (cw == 1) {
      float x[4];
      if constexpr (L::kDkShared) {
        const float4 own = my_dk[n2 * kWarp];
        const float4 other = dk_s[(rw * NT + n2) * kWarp + lane];
        x[0] = own.x + other.x;
        x[1] = own.y + other.y;
        x[2] = own.z + other.z;
        x[3] = own.w + other.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = adk[n2][e];
      }
      store2(dk + row + col, x[0] * pa.scale, x[1] * pa.scale);
      store2(dk + row + 8 * D + col, x[2] * pa.scale, x[3] * pa.scale);
    } else {
      store2(dv + row + col, adv[n2][0], adv[n2][1]);
      store2(dv + row + 8 * D + col, adv[n2][2], adv[n2][3]);
    }
  }
}

// ---------------------------------------------------------- (c) dQ --

template <typename T, int W, int D>
__global__ void __launch_bounds__(W * Layout<T, 16 * W, D>::CWQ * kWarp)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int nb, int hq, int hkv, int s, PairArgs pa) {
  using M = Mma<T>;
  using L = Layout<T, 16 * W, D>;
  constexpr int B = 16 * W;
  constexpr int kThreads = W * L::CWQ * kWarp;
  constexpr int NT = D / 8;      // n-tiles of dQ
  constexpr int KC = L::KC;      // kv columns at once
  constexpr int KT = KC / 8;
  constexpr int KS = KC / M::K;  // depth steps of dQ over a chunk
  static_assert(L::CWQ <= 2, "the final exchange pairs two slices");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // B x D each, swizzled
  T* gs = qs + B * D;                      // dO
  T* ks = gs + B * D;                      // two stages
  T* vs = ks + 2 * B * D;                  // two stages

  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int rw = warp % W, cw = warp / W;
  const int g = lane >> 2, t = lane & 3;
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
  load_tile<T, D, kThreads>(qs, q + row0 * D, B, tid);
  load_tile<T, D, kThreads>(gs, dout + row0 * D, B, tid);
  cp_async_commit();
  const int qrow = 16 * rw;  // the warp's query rows in the block
  const float lse_r[2] = {lse[row0 + qrow + g], lse[row0 + qrow + g + 8]};
  const float del_r[2] = {delta[row0 + qrow + g], delta[row0 + qrow + g + 8]};

  int lo, hi;
  kv_range(i, nblk, B, pa.causal, pa.window, lo, hi);
  auto stage = [&](int jj, int buf) {
    load_tile<T, D, kThreads>(ks + buf * B * D,
                              kv_k + static_cast<size_t>(jj) * B * D, B, tid);
    load_tile<T, D, kThreads>(vs + buf * B * D,
                              kv_v + static_cast<size_t>(jj) * B * D, B, tid);
  };

  float adq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.0f;

  if (lo < hi) {
    stage(lo, 0);
    cp_async_commit();
  }
  for (int j = lo; j < hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j + 1 < hi) {
      stage(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // k_j, v_j (and q, dO) are in for every thread
    const T* kb = ks + buf * B * D;
    const T* vb = vs + buf * B * D;
#pragma unroll 1
    for (int c0 = cw * (B / L::CWQ); c0 < (cw + 1) * (B / L::CWQ); c0 += KC) {
      // s = q k^T and dP = dO v^T over the chunk's kv columns
      typename M::Tile sv[KT] = {}, dp[KT] = {};
#pragma unroll 2
      for (int kd = 0; kd < D; kd += M::K) {
        typename M::A qa, ga;
        load_a<D>(qa, qs, qrow, kd, lane);
        load_a<D>(ga, gs, qrow, kd, lane);
#pragma unroll
        for (int n2 = 0; n2 < KT; n2 += 2) {
          typename M::B b0, b1;
          load_b<D>(b0, b1, kb, c0 + 8 * n2, kd, lane);
          mma(sv[n2], qa, b0);
          mma(sv[n2 + 1], qa, b1);
          load_b<D>(b0, b1, vb, c0 + 8 * n2, kd, lane);
          mma(dp[n2], ga, b0);
          mma(dp[n2 + 1], ga, b1);
        }
      }
      // dS: accumulator rows are query rows, columns keys
      typename M::ASplit df[KS];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float ds[M::K / 8][4];
#pragma unroll
        for (int u = 0; u < M::K / 8; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n2 = kk * (M::K / 8) + u;
            const int r = qrow + g + (e >> 1) * 8;
            const int c = c0 + 8 * n2 + 2 * t + (e & 1);
            float p;
            pair_grad(pa, sv[n2].get(e), dp[n2].get(e), lse_r[e >> 1],
                      del_r[e >> 1], i * B + r, j * B + c, p, ds[u][e]);
          }
        a_from_acc(df[kk], ds, 0);
      }
      // dQ += dS k, two output tiles at a time
#pragma unroll
      for (int n2 = 0; n2 < NT; n2 += 2) {
        float pq[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          typename M::B b0, b1;
          load_bt<D>(b0, b1, kb, c0 + kk * M::K, 8 * n2, lane);
          mma(pq[0], df[kk], b0);
          mma(pq[1], df[kk], b1);
        }
        add_tiles(adq, n2, pq);
      }
    }
    __syncthreads();  // every read of this buffer is done before its refill
  }
  cp_async_wait<0>();

  // with two column slices, slice 0 writes the first half of dQ's columns
  // and slice 1 the second, each after adding the other's partial sums
  int n_lo = 0, n_hi = NT;
  if constexpr (L::CWQ == 2) {
    float* red = reinterpret_cast<float*>(ks);  // the stages are free now
    n_lo = cw ? NT / 2 : 0;
    n_hi = cw ? NT : NT / 2;
    put_tiles(red, rw, lane, adq, cw ? 0 : NT / 2, cw ? NT / 2 : NT);
    __syncthreads();
    take_tiles(red, rw, lane, adq, n_lo, n_hi);
  }
  const size_t row = (row0 + qrow + g) * D;
#pragma unroll
  for (int n2 = 0; n2 < NT; ++n2) {
    if (n2 < n_lo || n2 >= n_hi) continue;
    const int col = 8 * n2 + 2 * t;
    store2(dq + row + col, adq[n2][0] * pa.scale, adq[n2][1] * pa.scale);
    store2(dq + row + 8 * D + col, adq[n2][2] * pa.scale,
           adq[n2][3] * pa.scale);
  }
}

// ------------------------------------------------------- launching --

template <typename T, int W, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int hq, int hkv, int s, PairArgs pa,
           cudaStream_t stream) {
  using L = Layout<T, 16 * W, D>;
  constexpr int B = 16 * W;
  // k, v and two stages of q and dO (dK/dV) or q, dO and two stages of k
  // and v (dQ); the dK/dV pass also stages two rows of lse and delta and,
  // in bfloat16, keeps the slices' dK sums
  const size_t tiles = sizeof(T) * 6 * static_cast<size_t>(B) * D;
  const size_t smem_dkdv = tiles + sizeof(float) * 4 * B +
                           (L::kDkShared ? sizeof(float) * L::CW * B * D : 0);
  const size_t smem_dq = tiles;
  auto dkdv = attn_bwd_dkdv_kernel<T, W, D>;
  auto dqk = attn_bwd_dq_kernel<T, W, D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dkdv));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(b) * hq * s;
  const long long delta_blocks =
      (rows + kDeltaThreads / kWarp - 1) / (kDeltaThreads / kWarp);
  const long long kv_blocks = static_cast<long long>(s / B) * hkv * b;
  const long long q_blocks = static_cast<long long>(s / B) * hq * b;
  if (delta_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_delta_kernel<T><<<static_cast<unsigned>(delta_blocks),
                             kDeltaThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<static_cast<unsigned>(kv_blocks), W * L::CW * kWarp, smem_dkdv,
         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), b, hq, hkv, s, pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<static_cast<unsigned>(q_blocks), W * L::CWQ * kWarp, smem_dq,
        stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), b, hq, hkv, s, pa);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_block(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, int b, int hq, int hkv, int s, int blk,
                   PairArgs pa, cudaStream_t st) {
  switch (blk) {
    case 32:
      return launch<T, 2, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq,
                             hkv, s, pa, st);
    case 64:
      return launch<T, 4, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq,
                             hkv, s, pa, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int b, int hq, int hkv, int s, int d,
             int blk, PairArgs pa, cudaStream_t st) {
  switch (d) {
    case 16:
      return dispatch_block<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   b, hq, hkv, s, blk, pa, st);
    case 32:
      return dispatch_block<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   b, hq, hkv, s, blk, pa, st);
    case 64:
      return dispatch_block<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   b, hq, hkv, s, blk, pa, st);
    case 128:
      return dispatch_block<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    b, hq, hkv, s, blk, pa, st);
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
    return dispatch<bf16>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s,
                          d, blk, pa, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
