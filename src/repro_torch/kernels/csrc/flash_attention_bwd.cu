// Flash-attention backward for Hopper (sm_90a) on the tensor cores,
// hand-written: bfloat16 on wgmma, float32 (and bfloat16's small blocks)
// on mma.sync.
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
// same bits from run to run.  Results are cast to the input dtype.  x / cap
// is one reciprocal of the cap, taken once on the host, and an FMA
// correction, which gives the IEEE quotient's bits
// (tests/test_torch_attention_bwd_wgmma.py sweeps it at cap 50); tanh keeps
// tanhf's accuracy (no tanh.approx), p expf's.
//
// Only S = Sq = Skv is taken, so every row keeps at least its own position
// under any mask and lse is a real log-sum-exp (the forward's "row past
// every key" case cannot occur).
//
// What bounds it on the H100 (700 W): five products of 2 D flops a kept
// pair (s, dP, dV, dK, dQ), 2.5 times the forward's work, against q, k, v,
// o, dO and the three gradients read or written once -- bound by
// operations in every dtype:
//   bfloat16: the five products at the tensor cores' 989 TFLOP/s; the
//     special-function unit (MUFU, 16 ex2 or rcp results a clock an SM)
//     needs one ex2 a kept pair, three with a softcap (tanhf's ex2 and
//     rcp), a third to a half of the products' time;
//   float32 by 3xTF32: the five products' three TF32 parts (hi hi, hi lo,
//     lo hi) at 495 TFLOP/s, six times the bfloat16 bound;
//   float32 by FFMA (an earlier design of this file): 67 TFLOP/s.
// What the designs do about them: every product runs on the tensor cores;
// the kernels do seven products, not five ((c) recomputes s and dP), plus
// the lo half of dS in bfloat16 (nine a pair).
//
// Two routes, chosen by an explicit table (attn_bwd_route in
// flash_attention.py, route_of below), neither a fall back for the other;
// a config the table does not route is refused.  A route's block `blk`
// is the query block of (c) and, on route 2, also the kv block of (b).
//
//  1. wgmma: bfloat16 at blk in {64, 128} and D in {64, 128} -- every
//     backward of the models' train steps.  (b) and (c) each run consumer
//     warpgroups and one producer warpgroup, of which one thread issues
//     every copy (TMA; the tools of wgmma_tools.cuh, which the forward's
//     wgmma route uses too): the thread block's own rows once, then 64-row
//     tiles of the other side into a ring of two stages on full and empty
//     mbarriers (complete_tx), each tile stored as 64-column panels with
//     the 128-byte swizzle the wgmma descriptors name.
//   * (b), one thread block per (b, kv head, 64 kv rows j), one consumer
//     warpgroup: K_j and V_j once; then, for each 64-row query tile that
//     keeps a pair with j (the inverse of attn_kv_range) and inside it each
//     of the Hq / Hkv query heads of the group, the tile's Q and dO by TMA
//     and its lse and delta rows by 1-D bulk copies, so the GQA sum is a
//     loop, not atomics.  S^T = K_j Q^T and dP^T = V_j dO^T run as wgmma
//     m64n64k16 with both operands in shared memory, in two commit groups:
//     scale, softcap, mask and p^T = exp(s - lse) run on S^T's registers
//     while dP^T's products run, the accumulator's layout already the A
//     fragment's (the thread's query columns read lse and delta from the
//     stage); dV += round(p)^T dO is issued next, and dS^T forms while it
//     runs; then dK += dS^T Q.  dV and dK run as wgmma m64n64k16 with A
//     from registers (dS as hi and lo, two products) and dO and Q read
//     through the transpose bit, one product a 64-column panel.  The
//     softcap and the mask are compile-time in the pair math (one of four
//     copies a tile, chosen once): as runtime branches between the 32
//     pairs a thread forms they cost the lone consumer its instruction-level
//     parallelism (tools/attn_bwd_probe.py).  The warpgroup skips (waits
//     for and releases) a tile that keeps no pair.  kv blocks run in
//     ascending order, the heaviest first under causal; putting a head's
//     blocks together instead, so that the blocks in flight share its Q and
//     dO in L2, ran slower on the card (the heavy blocks of the last heads
//     then start last).
//   * Chains.  dK and dV accumulate in the tensor core for kFlush (tile,
//     head) steps and are then added to float32 sums in shared memory by
//     FADD (each thread its own elements).  Carried over gemma2's two heads
//     of 4096 rows unflushed (1024 truncating k16 products for dK, 512 for
//     dV) they missed the bfloat16 gate on the card (dK 4.1e-4 normwise),
//     though a round-toward-zero emulation of those chains predicts 4e-5:
//     the tensor core's accumulation loses more than that model says, and
//     tests/test_torch_attention_bwd_wgmma.py holds the flushed chains to a
//     margin below the gate that covers the difference.  dQ's chain (512
//     products at 4096 keys, hi and lo) read within the gate unflushed.
//   * (c), one thread block per (b, query head, query block i) of blk rows,
//     blk / 64 consumer warpgroups: Q_i and dO_i once, lse and delta of the
//     thread's two rows in registers, then the 64-row K and V tiles of the
//     kv blocks that keep a pair with i (attn_kv_range at kv tiles of 64),
//     in ascending order; S = Q K^T and dP = dO V^T again by wgmma SS (the
//     two products (b) also does: a fused dQ would need atomics, or
//     partial dQs and a second pass), dS in registers, dQ += dS K by wgmma
//     RS with K through the transpose bit.  Query blocks run in descending
//     order (the heaviest first), as the forward's.  Two calls give the
//     same bits.
//  2. mma.sync: float32 at blk in {32, 64}, and bfloat16 where wgmma does
//     not take it (blk 32; blk 64 at D 16 or 32).  m16n8k16 bfloat16 and
//     three m16n8k8 TF32 products per float32 product, with the tools of
//     mma_tools.cuh:
//   * Products with mma.sync: every float32 operand split a = hi + lo with
//     hi the nearest TF32 and lo = a - hi (of which the tensor core reads
//     the top 19 bits), hi hi + hi lo + lo hi summed: the lo lo term and
//     lo's truncation leave about 2^-21 relative, float32's accuracy at
//     three times TF32's cost, and no plain TF32 anywhere.  Operands a
//     product reads along their rows go from shared memory to fragments
//     with ldmatrix; those it reads across rows (k-major) with
//     ldmatrix.trans in bfloat16 and, in float32, where .trans moves 16-bit
//     halves only, with two 4-byte loads a fragment in a depth order
//     permuted to match the accumulator layout (depth slot t is row 2t,
//     slot t + 4 row 2t + 1, in both operands).
//   * Precision of the operands built in registers (both routes).  p enters
//     dV rounded once, as round(p) is defined.  dS would lose 2^-9 relative
//     in one bfloat16 rounding (about 1.7e-3 normwise in dK and dQ in the
//     CPU emulation, 7 times the 2^-12 gate), so in bfloat16 it enters as hi
//     = bf16(dS) and lo = bf16(dS - hi), two products into one accumulator;
//     in float32 p and dS are split hi/lo like every other operand.
//   * Tensor-core accumulators truncate.  On this route one accumulator
//     carried over a kv block's 8192 query rows drifts past the float32
//     gate, so the products of a chunk of columns start from zero and are
//     added to the float32 sums by FADD (round to nearest), which
//     tests/test_torch_attention_bwd_tc.py emulates; and in float32 the
//     small hi lo and lo hi terms of s and dP run in accumulators of their
//     own, so the chain of hi hi products over D is a third as long.
//   * (b) one thread block per (b, kv head, kv block j) of B rows (B = 16 W:
//     W row groups of 16 kv rows, two warps each, one per half of every
//     query block), walking the query blocks that keep a pair with j and
//     the group's heads as route 1 does.  A warp computes the transposed
//     tiles s^T and dP^T, forms p^T and dS^T in those registers, and feeds
//     them straight back as the A operand of dV += round(p)^T dO_i and dK
//     += dS^T q_i (an m16n8 accumulator pair is an m16k16 A fragment).  dV
//     sums stay in registers; dK sums too in float32, while bfloat16 keeps
//     them in shared memory as float32, which kept ptxas from spilling at D
//     = 128.  At the end the two halves' sums are added (x + y = y + x: the
//     same bits whichever warp adds).  q_i, dO_i, lse_i and delta_i are
//     double-buffered by cp.async.
//   * (c) one thread block per (b, query head, query block i), each warp
//     owning 16 query rows (float32: two warps a row group, one per half of
//     every kv block), walking attn_kv_range(i) in ascending order,
//     recomputing s and dP and adding dS k_j into its accumulators; k_j and
//     v_j are double-buffered.
//   * Tiles are row-major with the 16-byte chunks of row r stored at chunk
//     c ^ (r & 7) (as in the forward's mma.sync route), so the eight rows
//     one ldmatrix matrix reads, or the eight rows a float32 fragment reads
//     across, fall in distinct bank groups.
//
// What is left: route 1 runs its nine products a pair at about 45 % of
// the tensor cores' rate.  Tried on the card and no faster: two consumer
// warpgroups in (b), either on the same 64 kv rows (one forming p and dV,
// the other dP, dS and dK, passing p (1 - t^2) through shared memory) or
// on 64 kv rows each of a 128-row block (its float32 sums in device
// scratch; ptxas compiled them at 168 registers, spilled and serialised
// the products); rings of three and four stages; and issuing a step's S^T
// and dP^T before the last step's dK is in (255 registers).  Not tried:
// larger wgmma N (S over 128 keys), Q and dO multicast to the blocks of a
// cluster (the dK/dV kernel re-reads them for every 64 kv rows), a
// persistent grid, dQ fused into (b) by partials added in a fixed order
// (two of the nine products), and wgmma for float32 (TF32 only K-major).
//
// Instantiations: route 1's (b) at D in {64, 128} and (c) at blk in {64,
// 128} and D in {64, 128}: 6 kernels; route 2 at blk in {32, 64}, D in
// {16, 32, 64, 128} in float32 and the 6 bfloat16 configs route 1 does not
// take, (b) and (c): 28 kernels; (a) per dtype: 2.  36 kernels.
//
// The launcher allocates nothing, never synchronises, launches the three
// kernels on the stream it is given, and returns cudaGetLastError() (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_tools.cuh"
#include "wgmma_tools.cuh"

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

// the forward's scalars, shared by every pair; rcap = 1 / softcap (IEEE,
// on the host)
struct PairArgs {
  float scale, softcap, rcap;
  int causal, window;
};
// x / cap: q = x rcap is within an ulp of the quotient, r = x - q cap is
// exact in one FMA, and q + r rcap rounds to the IEEE quotient
__device__ __forceinline__ float div_cap(float x, const PairArgs& pa) {
  const float q = x * pa.rcap;
  return fmaf(fmaf(-q, pa.softcap, x), pa.rcap, q);
}
// p and p (1 - t^2) of the pair (query qp, key kp) from its raw logit s;
// a masked pair (the forward's -1e30 logit) has p = 0.  dS is p (1 - t^2)
// (dP - delta), which route 1 forms once dP is in.  CAP: a softcap; MASK:
// the pair's tile may hold masked pairs.  Route 1 fixes both for a tile,
// so a tile's 32 pairs a thread run without a branch between them.
template <bool CAP, bool MASK>
__device__ __forceinline__ void pair_p(const PairArgs& pa, float s,
                                       float lse, int qp, int kp, float& p,
                                       float& pfac) {
  float x = s * pa.scale;
  float fac = 1.0f;
  if constexpr (CAP) {
    const float t = tanhf(div_cap(x, pa));
    x = pa.softcap * t;
    fac = 1.0f - t * t;
  }
  bool keep = true;
  if constexpr (MASK)
    keep = (!pa.causal || qp >= kp) && (pa.window <= 0 || qp - kp < pa.window);
  p = keep ? expf(x - lse) : 0.0f;
  pfac = CAP ? p * fac : p;
}

// p and dS of the pair from its raw logit s and dP (route 2)
__device__ __forceinline__ void pair_grad(const PairArgs& pa, float s,
                                          float dp, float lse, float delta,
                                          int qp, int kp, float& p,
                                          float& ds) {
  float pfac;
  if (pa.softcap > 0.0f)
    pair_p<true, true>(pa, s, lse, qp, kp, p, pfac);
  else
    pair_p<false, true>(pa, s, lse, qp, kp, p, pfac);
  ds = pfac * (dp - delta);
}

// f(cap, mask) with std::integral_constant<bool, ...> arguments at the
// tile's softcap and mask
template <typename F>
__device__ __forceinline__ void by_kind(const PairArgs& pa, bool cut, F&& f) {
  using yes = std::true_type;
  using no = std::false_type;
  if (pa.softcap > 0.0f) {
    if (cut)
      f(yes{}, yes{});
    else
      f(yes{}, no{});
  } else {
    if (cut)
      f(no{}, yes{});
    else
      f(no{}, no{});
  }
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

// ------------------------------------------ route 2 (mma.sync): (b) dK dV --

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

// --------------------------------------------- route 2 (mma.sync): (c) dQ --

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


// ---------------------------------------------------- route 1: wgmma --

// The route table (attn_bwd_route in flash_attention.py): route 1 (wgmma)
// for bfloat16 at blk in {64, 128} and D in {64, 128}; route 2 (mma.sync)
// for float32 and the other bfloat16 configs at blk in {32, 64}; 0 for
// none.
__host__ __device__ constexpr bool is_head_dim(int d) {
  return d == 16 || d == 32 || d == 64 || d == 128;
}
__host__ __device__ constexpr bool wgmma_route(bool bf16, int blk, int d) {
  return bf16 && (blk == 64 || blk == 128) && (d == 64 || d == 128);
}
__host__ __device__ constexpr int route_of(int dtype, int blk, int d) {
  return (dtype != 0 && dtype != 1) || !is_head_dim(d)  ? 0
         : wgmma_route(dtype == 1, blk, d)              ? 1
         : blk == 32 || blk == 64                       ? 2
                                                        : 0;
}

// Whether the pairs of queries [qa, qa + nq) and keys [ka, ka + nk) hold a
// kept pair (keep) and a masked one (cut): their differences q - k run
// over [qa - ka - nk + 1, qa + nq - 1 - ka], which the mask keeps where it
// meets [0, window - 1] (causal) or (-inf, window - 1] (a window alone).
struct SubBlock {
  bool keep, cut;
};
__device__ __forceinline__ SubBlock sub_block(const PairArgs& pa, int qa,
                                              int nq, int ka, int nk) {
  const int lo = qa - ka - nk + 1, hi = qa + nq - 1 - ka;
  return {!(pa.causal && hi < 0) && !(pa.window > 0 && lo >= pa.window),
          (pa.causal && lo < 0) || (pa.window > 0 && hi >= pa.window)};
}
// the 64-row query tiles [t0, t1) that keep a pair with keys [k0, k0 + nk)
__device__ __forceinline__ void query_tiles(const PairArgs& pa, int s, int k0,
                                            int nk, int& t0, int& t1) {
  t0 = pa.causal ? k0 / 64 : 0;
  t1 = s / 64;
  if (pa.window > 0) t1 = min(t1, (pa.window + k0 + nk - 2) / 64 + 1);
}
// the 64-row key tiles [u0, u1) that keep a pair with queries [q0, q0 + nq)
// (attn_kv_range at bkv = 64)
__device__ __forceinline__ void key_tiles(const PairArgs& pa, int s, int q0,
                                          int nq, int& u0, int& u1) {
  u0 = pa.window > 0 ? max(0, q0 - pa.window + 1) / 64 : 0;
  u1 = pa.causal ? (q0 + nq - 1) / 64 + 1 : s / 64;
}

// The two kernels' shapes.  ptxas compiles a kernel at the registers its
// launch bounds allow a thread (measured: spills appear exactly where a
// consumer needs more, setmaxnreg or not): 168 at 384 threads, 255 at
// 256 and one block an SM.  (b)'s consumer holds dK and dV (D floats a
// thread at 64 rows) beside S^T, dP^T and the A fragments, about 230
// registers at D = 128 (ptxas: 255, no spills), so (b) runs one consumer
// warpgroup of 64 kv rows and a producer, one block an SM.  (c)'s consumer
// holds dQ (D / 2) beside S, dP and dS: two consumer warpgroups at blk =
// 128 fit 168 (no spills), and setmaxnreg gives their producer 24
// registers and them 240 (24 + 2 x 240 = 3 x 168); one at blk = 64 takes
// 256 threads.
constexpr int kBwdProducerRegs = 24;
constexpr int kBwdConsumerRegs = 240;
// (tile, head) steps a dK / dV accumulator chain runs before it is added
// to the float32 sums by FADD: chains of 8 kFlush (dK, hi and lo) and 4
// kFlush (dV) k16 products
constexpr int kFlush = 16;

// (b): one consumer warpgroup on 64 kv rows, and the producer
template <int D>
struct BwdKv {
  static constexpr int kThreads = 256;
  static constexpr int NS = 2;      // stages of the ring
  static constexpr int P = D / 64;  // 64-column panels a tile
  static constexpr unsigned kTileBytes = 64 * D * 2;
  static constexpr unsigned kRowBytes = 64 * 4;  // lse or delta of a tile
  // K, V, NS stages of Q and of dO, NS rows of lse and of delta, the dK
  // and dV float32 sums (each thread its own elements), then the barriers
  // (K and V, full[NS], empty[NS]); 1024 bytes to align the tiles to the
  // swizzle's period
  static constexpr size_t kSumOff =
      2 * kTileBytes + 2 * NS * (kTileBytes + kRowBytes);
  static constexpr size_t kBarOff = kSumOff + 2 * 64 * D * 4;
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * (1 + 2 * NS);
};
// (c): blk / 64 consumer warpgroups on the block's query rows
template <int BLK, int D>
struct BwdQ {
  static constexpr int NC = BLK / 64;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr bool kSplitRegs = NC > 1;  // setmaxnreg
  static constexpr int NS = 2;
  static constexpr int P = D / 64;
  static constexpr unsigned kBlockBytes = BLK * D * 2;
  static constexpr unsigned kTileBytes = 64 * D * 2;
  // Q, dO, NS stages of K and of V, then the barriers
  static constexpr size_t kBarOff = 2 * kBlockBytes + 2 * NS * kTileBytes;
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * (1 + 2 * NS);
};

__device__ __forceinline__ unsigned char* swizzle_base(unsigned char* raw) {
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void init_ring(uint64_t* own, uint64_t* full,
                                          uint64_t* empty, int ns,
                                          int consumer_warps) {
  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int st = 0; st < ns; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, consumer_warps);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A = rows [r0, r0 + 64) of a tile of `rows` rows stored as 64-column
// panels, B = a 64-row tile; both K-major: d (+)= A B^T over D / 16 steps
template <int D>
__device__ __forceinline__ void product_ss(float (&d)[32],
                                           const unsigned char* a, int rows,
                                           int r0, const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk / 4, off = (kk % 4) * 32;
    wgmma_ss(d, desc_sw128(a + p * rows * 128 + r0 * 128 + off, 16, 1024),
             desc_sw128(b + p * 64 * 128 + off, 16, 1024), kk > 0 ? 1 : 0);
  }
}

// d[p] += a b over a 64-deep step kk of 16: a from registers, b the 64-row
// tile `b` read through the transpose bit, one product a 64-column panel p
template <int P>
__device__ __forceinline__ void product_rs(float (&d)[P][32],
                                           const unsigned (&a)[4],
                                           const unsigned char* b, int kk) {
#pragma unroll
  for (int p = 0; p < P; ++p)
    wgmma_rs(d[p], a, desc_sw128(b + p * 64 * 128 + kk * 16 * 128, 1024,
                                 1024));
}

// the thread's accumulator rows row, row + 8 of a (64 x 64 P) sum, scaled,
// to out (rows of D)
template <int P, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[P][32],
                                           bf16* out, size_t row, int t,
                                           float scale) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 64 * p + 8 * n + 2 * t;
      store2(out + row * D + col, acc[p][4 * n] * scale,
             acc[p][4 * n + 1] * scale);
      store2(out + (row + 8) * D + col, acc[p][4 * n + 2] * scale,
             acc[p][4 * n + 3] * scale);
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

// --------------------------------------------------- route 1: (b) dK dV --

// sums[i][thread] += acc[i], acc = 0: a thread's own elements, so
// neighbouring threads touch neighbouring words
template <int P>
__device__ __forceinline__ void flush(float (&acc)[P][32], float* sums,
                                      int tid) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sums[(32 * p + i) * 128 + tid] += acc[p][i];
      acc[p][i] = 0.0f;
    }
}

template <int D>
__global__ void __launch_bounds__(BwdKv<D>::kThreads, 1)
attn_bwd_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int nb, int hq, int hkv, int s, PairArgs pa) {
  using C = BwdKv<D>;
  constexpr int NS = C::NS, P = C::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sk = swizzle_base(smem_raw);  // P panels of 64 x 64
  unsigned char* sv = sk + C::kTileBytes;
  unsigned char* sq = sv + C::kTileBytes;  // NS stages, P panels each
  unsigned char* sdo = sq + NS * C::kTileBytes;
  float* slse = reinterpret_cast<float*>(sdo + NS * C::kTileBytes);
  float* sdel = slse + NS * 64;
  float* dk_sum = reinterpret_cast<float*>(sk + C::kSumOff);  // 64 D each
  float* dv_sum = dk_sum + 64 * D;
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(sk + C::kBarOff);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + NS;

  const int nbh = nb * hkv;
  const int j = static_cast<int>(blockIdx.x) / nbh;
  const int bh = static_cast<int>(blockIdx.x) % nbh;
  const int hk = bh % hkv, b = bh / hkv;
  const int group = hq / hkv;
  const int ka = 64 * j;  // the block's kv rows [ka, ka + 64)
  int t0, t1;
  query_tiles(pa, s, ka, 64, t0, t1);
  const int nsteps = max(0, t1 - t0) * group;  // (query tile, head) steps
  init_ring(kvfull, full, empty, NS, 4);

  if (threadIdx.x >= 128) {
    // the producer warpgroup: one thread issues every copy
    if (threadIdx.x == 128) {
      const int kvrow = (b * hkv + hk) * s + ka;
      mbar_expect_tx(kvfull, 2 * C::kTileBytes);
      for (int p = 0; p < P; ++p) {
        tma_load(sk + p * 64 * 128, &tk, kvfull, 64 * p, kvrow);
        tma_load(sv + p * 64 * 128, &tv, kvfull, 64 * p, kvrow);
      }
      for (int n = 0; n < nsteps; ++n) {
        const int st = n % NS;
        const unsigned ph = (n / NS) & 1;
        const int qrow =
            (b * hq + hk * group + n % group) * s + 64 * (t0 + n / group);
        mbar_wait(empty + st, ph ^ 1);  // the first round passes at once
        mbar_expect_tx(full + st, 2 * (C::kTileBytes + C::kRowBytes));
        for (int p = 0; p < P; ++p) {
          tma_load(sq + st * C::kTileBytes + p * 64 * 128, &tq, full + st,
                   64 * p, qrow);
          tma_load(sdo + st * C::kTileBytes + p * 64 * 128, &tdo, full + st,
                   64 * p, qrow);
        }
        bulk_load(slse + st * 64, lse + qrow, C::kRowBytes, full + st);
        bulk_load(sdel + st * 64, delta + qrow, C::kRowBytes, full + st);
      }
    }
    return;
  }
  // the consumer warpgroup
  const int tid = threadIdx.x;
  const int lane = tid % 32, wq = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  const int key = ka + 16 * wq + g;  // the thread's keys: key, key + 8
  float adk[P][32], adv[P][32];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    zero(adk[p]);
    zero(adv[p]);
  }
  for (int i = tid; i < 2 * 64 * D; i += 128) dk_sum[i] = 0.0f;
  mbar_wait(kvfull, 0);
  for (int n = 0; n < nsteps; ++n) {
    const int st = n % NS;
    const unsigned ph = (n / NS) & 1;
    const int qa = 64 * (t0 + n / group);
    const SubBlock sb = sub_block(pa, qa, 64, ka, 64);
    mbar_wait(full + st, ph);
    if (sb.keep) {
      const unsigned char* qs = sq + st * C::kTileBytes;
      const unsigned char* gs = sdo + st * C::kTileBytes;
      // S^T = K Q^T and dP^T = V dO^T, rows keys and columns queries, in
      // two groups: p forms while dP^T's products run
      float x[8][4], y[8][4];
      float(&xf)[32] = reinterpret_cast<float(&)[32]>(x);
      float(&yf)[32] = reinterpret_cast<float(&)[32]>(y);
      zero(xf);
      zero(yf);
      fence_regs(xf);
      fence_regs(yf);
      wgmma_fence();
      product_ss<D>(xf, sk, 64, 0, qs);
      wgmma_commit();
      product_ss<D>(yf, sv, 64, 0, gs);
      wgmma_commit();
      wgmma_wait_group<1>();  // S^T is in
      fence_regs(xf);
      // p^T rounded into A fragments, p^T (1 - t^2) in place of S^T; the
      // thread's query columns read lse and delta from the stage
      const float* ls = slse + st * 64;
      const float* dl = sdel + st * 64;
      BfA pf[4];  // round(p)^T, 16 queries a step
      by_kind(pa, sb.cut, [&](auto cap, auto mask) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float pk[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int nn = 2 * kk + u;
            const float2 l2 =
                *reinterpret_cast<const float2*>(ls + 8 * nn + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pair_p<decltype(cap)::value, decltype(mask)::value>(
                  pa, x[nn][e], (e & 1) ? l2.y : l2.x,
                  qa + 8 * nn + 2 * t + (e & 1), key + 8 * (e >> 1),
                  pk[u][e], x[nn][e]);
          }
          a_from_acc(pf[kk], pk, 0);
        }
      });
      // dV += round(p)^T dO, under way while dS^T forms
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) product_rs(adv, pf[kk].x, gs, kk);
      wgmma_commit();
      wgmma_wait_group<1>();  // dP^T is in
      fence_regs(yf);
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(dl + 8 * nn + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[nn][e] = x[nn][e] * (y[nn][e] - ((e & 1) ? d2.y : d2.x));
      }
      BfA2 df[4];  // dS^T as hi + lo
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_from_acc(df[kk], y, kk);
      // dK += dS^T Q (lo, then hi)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        product_rs(adk, df[kk].lo, qs, kk);
        product_rs(adk, df[kk].hi, qs, kk);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        fence_regs(adk[p]);
        fence_regs(adv[p]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with it
    if ((n + 1) % kFlush == 0) {  // bound the chains
      flush(adk, dk_sum, tid);
      flush(adv, dv_sum, tid);
    }
  }
  flush(adk, dk_sum, tid);
  flush(adv, dv_sum, tid);
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      adk[p][i] = dk_sum[(32 * p + i) * 128 + tid];
      adv[p][i] = dv_sum[(32 * p + i) * 128 + tid];
    }
  const size_t row = (static_cast<size_t>(b) * hkv + hk) * s + key;
  store_rows<P, D>(adk, dk, row, t, pa.scale);
  store_rows<P, D>(adv, dv, row, t, 1.0f);
}

// ------------------------------------------------------ route 1: (c) dQ --

template <int BLK, int D>
__global__ void __launch_bounds__(BwdQ<BLK, D>::kThreads, 1)
attn_bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int nb, int hq, int hkv,
                         int s, PairArgs pa) {
  using C = BwdQ<BLK, D>;
  constexpr int NS = C::NS, P = C::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sq = swizzle_base(smem_raw);  // P panels of BLK x 64
  unsigned char* sdo = sq + C::kBlockBytes;
  unsigned char* sk = sdo + C::kBlockBytes;  // NS stages of P panels 64 x 64
  unsigned char* sv = sk + NS * C::kTileBytes;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sq + C::kBarOff);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + NS;

  const int nbh = nb * hq;
  const int i = s / BLK - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int bh = static_cast<int>(blockIdx.x) % nbh;
  const int h = bh % hq, b = bh / hq;
  const int hk = h / (hq / hkv);
  const int q0 = i * BLK;
  int u0, u1;
  key_tiles(pa, s, q0, BLK, u0, u1);
  const int nsteps = max(0, u1 - u0);
  init_ring(qfull, full, empty, NS, 4 * C::NC);

  const int wg = threadIdx.x / 128;
  if (wg == C::NC) {
    if constexpr (C::kSplitRegs)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kBwdProducerRegs));
    if (threadIdx.x == 128 * C::NC) {
      const int qrow = (b * hq + h) * s + q0;
      const int kvrow = (b * hkv + hk) * s;
      mbar_expect_tx(qfull, 2 * C::kBlockBytes);
      for (int p = 0; p < P; ++p) {
        tma_load(sq + p * BLK * 128, &tq, qfull, 64 * p, qrow);
        tma_load(sdo + p * BLK * 128, &tdo, qfull, 64 * p, qrow);
      }
      for (int n = 0; n < nsteps; ++n) {
        const int st = n % NS;
        const unsigned ph = (n / NS) & 1;
        const int row = kvrow + 64 * (u0 + n);
        mbar_wait(empty + st, ph ^ 1);
        mbar_expect_tx(full + st, 2 * C::kTileBytes);
        for (int p = 0; p < P; ++p) {
          tma_load(sk + st * C::kTileBytes + p * 64 * 128, &tk, full + st,
                   64 * p, row);
          tma_load(sv + st * C::kTileBytes + p * 64 * 128, &tv, full + st,
                   64 * p, row);
        }
      }
    }
  } else {
    // a consumer warpgroup: query rows [qa, qa + 64) of the block
    if constexpr (C::kSplitRegs)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          kBwdConsumerRegs));
    const int lane = threadIdx.x % 32;
    const int wq = (threadIdx.x % 128) / 32;
    const int g = lane >> 2, t = lane & 3;
    const int qa = q0 + 64 * wg;
    const int query = qa + 16 * wq + g;  // the thread's rows: query, + 8
    const size_t row = (static_cast<size_t>(b) * hq + h) * s + query;
    const float lse_r[2] = {lse[row], lse[row + 8]};
    const float del_r[2] = {delta[row], delta[row + 8]};
    float adq[P][32];
#pragma unroll
    for (int p = 0; p < P; ++p) zero(adq[p]);
    mbar_wait(qfull, 0);
    for (int n = 0; n < nsteps; ++n) {
      const int st = n % NS;
      const unsigned ph = (n / NS) & 1;
      const int ka = 64 * (u0 + n);
      const SubBlock sb = sub_block(pa, qa, 64, ka, 64);
      mbar_wait(full + st, ph);
      if (sb.keep) {
        const unsigned char* ks = sk + st * C::kTileBytes;
        const unsigned char* vs = sv + st * C::kTileBytes;
        // S = Q K^T and dP = dO V^T, rows queries and columns keys, in two
        // groups: p forms while dP's products run
        float x[8][4], y[8][4];
        float(&xf)[32] = reinterpret_cast<float(&)[32]>(x);
        float(&yf)[32] = reinterpret_cast<float(&)[32]>(y);
        zero(xf);
        zero(yf);
        fence_regs(xf);
        fence_regs(yf);
        wgmma_fence();
        product_ss<D>(xf, sq, BLK, 64 * wg, ks);
        wgmma_commit();
        product_ss<D>(yf, sdo, BLK, 64 * wg, vs);
        wgmma_commit();
        wgmma_wait_group<1>();  // S is in
        fence_regs(xf);
        by_kind(pa, sb.cut, [&](auto cap, auto mask) {
#pragma unroll
          for (int nn = 0; nn < 8; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p;
              pair_p<decltype(cap)::value, decltype(mask)::value>(
                  pa, x[nn][e], lse_r[e >> 1], query + 8 * (e >> 1),
                  ka + 8 * nn + 2 * t + (e & 1), p, x[nn][e]);
            }
        });
        wgmma_wait();  // dP is in
        fence_regs(yf);
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[nn][e] = x[nn][e] * (y[nn][e] - del_r[e >> 1]);
        BfA2 df[4];  // dS as hi + lo, 16 keys a step
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_from_acc(df[kk], y, kk);
        // dQ += dS K (lo, then hi)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          product_rs(adq, df[kk].lo, ks, kk);
          product_rs(adq, df[kk].hi, ks, kk);
        }
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int p = 0; p < P; ++p) fence_regs(adq[p]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }
    store_rows<P, D>(adq, dq, row, t, pa.scale);
  }
}

// ------------------------------------------------------- launching --

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int b, hq, hkv, s;
  PairArgs pa;
  cudaStream_t stream;
};

template <typename T>
int launch_delta(const BwdArgs& a, int d) {
  const long long rows = static_cast<long long>(a.b) * a.hq * a.s;
  const long long blocks =
      (rows + kDeltaThreads / kWarp - 1) / (kDeltaThreads / kWarp);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks), kDeltaThreads, 0,
                             a.stream>>>(static_cast<const T*>(a.o),
                                         static_cast<const T*>(a.dout),
                                         a.delta, rows, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BLK, int D>
int launch_sync(const BwdArgs& a) {
  constexpr int W = BLK / 16;
  using L = Layout<T, BLK, D>;
  // k, v and two stages of q and dO (dK/dV) or q, dO and two stages of k
  // and v (dQ); the dK/dV pass also stages two rows of lse and delta and,
  // in bfloat16, keeps the slices' dK sums
  const size_t tiles = sizeof(T) * 6 * static_cast<size_t>(BLK) * D;
  const size_t smem_dkdv = tiles + sizeof(float) * 4 * BLK +
                           (L::kDkShared ? sizeof(float) * L::CW * BLK * D : 0);
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
  const long long kv_blocks = static_cast<long long>(a.s / BLK) * a.hkv * a.b;
  const long long q_blocks = static_cast<long long>(a.s / BLK) * a.hq * a.b;
  if (q_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int r = launch_delta<T>(a, D);
  if (r != 0) return r;
  dkdv<<<static_cast<unsigned>(kv_blocks), W * L::CW * kWarp, smem_dkdv,
         a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.b, a.hq, a.hkv,
      a.s, a.pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<static_cast<unsigned>(q_blocks), W * L::CWQ * kWarp, smem_dq,
        a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.b, a.hq, a.hkv, a.s, a.pa);
  return static_cast<int>(cudaGetLastError());
}

// the launch attributes of a route-1 kernel: with a setmaxnreg split its
// registers must cover the split, and it may take `smem` bytes of shared
// memory
template <typename Kernel>
cudaError_t prepare_wgmma(Kernel kernel, int nc, bool split, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (split &&
      attr.numRegs * (nc + 1) < kBwdProducerRegs + nc * kBwdConsumerRegs)
    return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int BLK, int D>
int launch_wgmma(const BwdArgs& a) {
  using CK = BwdKv<D>;
  using CQ = BwdQ<BLK, D>;
  auto dkdv = attn_bwd_wgmma_dkdv_kernel<D>;
  auto dqk = attn_bwd_wgmma_dq_kernel<BLK, D>;
  cudaError_t err = prepare_wgmma(dkdv, 1, false, CK::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prepare_wgmma(dqk, CQ::NC, CQ::kSplitRegs, CQ::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long qrows = static_cast<long long>(a.b) * a.hq * a.s;
  const long long kvrows = static_cast<long long>(a.b) * a.hkv * a.s;
  if (qrows > INT_MAX || kvrows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // (b) reads 64-row tiles of everything, (c) Q and dO in blocks
  CUtensorMap tq64, tdo64, tk64, tv64, tq_blk, tdo_blk;
  if (!tensor_map(&tq64, a.q, qrows, D, 64) ||
      !tensor_map(&tdo64, a.dout, qrows, D, 64) ||
      !tensor_map(&tk64, a.k, kvrows, D, 64) ||
      !tensor_map(&tv64, a.v, kvrows, D, 64) ||
      !tensor_map(&tq_blk, a.q, qrows, D, BLK) ||
      !tensor_map(&tdo_blk, a.dout, qrows, D, BLK))
    return static_cast<int>(cudaErrorNotSupported);
  const int r = launch_delta<bf16>(a, D);
  if (r != 0) return r;
  dkdv<<<static_cast<unsigned>((a.s / 64) * static_cast<long long>(a.b) *
                               a.hkv),
         CK::kThreads, CK::kSmem, a.stream>>>(
      tq64, tdo64, tk64, tv64, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.b, a.hq, a.hkv, a.s, a.pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<static_cast<unsigned>((a.s / BLK) * static_cast<long long>(a.b) *
                              a.hq),
        CQ::kThreads, CQ::kSmem, a.stream>>>(
      tq_blk, tdo_blk, tk64, tv64, a.lse, a.delta, static_cast<bf16*>(a.dq),
      a.b, a.hq, a.hkv, a.s, a.pa);
  return static_cast<int>(cudaGetLastError());
}

// the route of (T, BLK, D), fixed at compile time: only the configs the
// table routes are instantiated
template <typename T, int BLK, int D>
int launch(const BwdArgs& a) {
  constexpr int route = route_of(std::is_same<T, bf16>::value ? 1 : 0, BLK, D);
  if constexpr (route == 1)
    return launch_wgmma<BLK, D>(a);
  else if constexpr (route == 2)
    return launch_sync<T, BLK, D>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
int dispatch_block(const BwdArgs& a, int blk) {
  switch (blk) {
    case 32:
      return launch<T, 32, D>(a);
    case 64:
      return launch<T, 64, D>(a);
    case 128:
      return launch<T, 128, D>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const BwdArgs& a, int d, int blk) {
  switch (d) {
    case 16:
      return dispatch_block<T, 16>(a, blk);
    case 32:
      return dispatch_block<T, 32>(a, blk);
    case 64:
      return dispatch_block<T, 64>(a, blk);
    case 128:
      return dispatch_block<T, 128>(a, blk);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The route the table gives (dtype, blk, d): 1 wgmma, 2 mma.sync, 0 none
// (the launch refuses it).
int repro_flash_attention_bwd_route(int dtype, int blk, int d) {
  return route_of(dtype, blk, d);
}

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
      s % blk || route_of(dtype, blk, d) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, b, hq, hkv, s,
                  PairArgs{scale, softcap,
                           softcap > 0.0f ? 1.0f / softcap : 0.0f, causal,
                           window},
                  static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? dispatch<float>(a, d, blk) : dispatch<bf16>(a, d, blk);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
