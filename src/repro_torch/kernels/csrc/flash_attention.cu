// Flash attention for Hopper (sm_90a) on the tensor cores, hand-written.
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
// round(p) is p rounded to the value dtype (a no-op for float32), as the
// TPU kernel's p.astype(v.dtype); the denominator sums the unrounded p.
// Masked logits take the finite sentinel -1e30, never -inf.  Softcap keeps
// tanhf's accuracy (no tanh.approx), p keeps expf's.
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
// it); the block visits every kv block, as the TPU kernel does.  Only the
// blocks a mask cuts (the diagonal, the window's edge) evaluate the mask.
//
// What bounds it on the H100 (700 W).  Causal attention at D = 128 does
// 4 D flops a kept (query, key) pair (q k^T and p v) against 16 D bytes of
// q, k, v and o a row, so at long sequences it is bound by operations, of
// two units:
//  * the tensor cores: bfloat16 at 989 TFLOP/s; float32 as three TF32
//    products at 495 TFLOP/s, six times the bfloat16 time;
//  * the special-function unit (MUFU), which issues 16 ex2 or rcp results a
//    clock per SM (3.7-4.2e12 a second at 1.76-1.98 GHz): one ex2 a kept
//    pair for p, and under gemma2's softcap tanhf's ex2 and rcp on top.
//    Without softcap the tensor cores bind (bfloat16, D = 128: 1.9e12
//    pairs a second against MUFU's 3.7e12 or more); with it, MUFU does.
//
// Two routes, chosen by an explicit table (attn_route in
// flash_attention.py, route_of below), neither a fall back for the other;
// a config the table does not route is refused.
//
//  1. wgmma: bfloat16 at bq, bkv in {64, 128} and D in {64, 128} -- every
//     attention call of the models' prefills and train steps.  One thread
//     block owns one (b, h, query block) and runs bq / 64 consumer warpgroups
//     of 64 query rows and one producer warpgroup, of which one thread issues
//     every copy: TMA loads of Q once and of the K and V tiles of each
//     visited kv block into a ring of two stages, each tile stored as
//     64-column panels with the 128-byte swizzle that the wgmma descriptors
//     name, and each stage's K and V on full barriers of their own (mbarrier,
//     complete_tx), released by the consumers through empty barriers.
//     setmaxnreg gives the producer 40 registers and the consumers 232
//     (on an H100 8 % faster at the models' blocks than no split, by
//     tools/attn_forward_times.py).  A consumer computes S = Q K^T with
//     wgmma m64n{bkv}k16, both operands in shared memory, over D / 16
//     steps; scale, softcap, mask and the online max and sum run on the accumulator's
//     registers, each row spread over the four threads of a quad (a row
//     reduction is two shuffles); p is rounded to bfloat16 in registers,
//     where the S accumulator's layout is already the A fragment's, and
//     O += P V runs as wgmma m64n64k16 with A from registers and V read from
//     shared memory through the transpose bit, one product a 64-column panel.
//     O accumulates in the tensor core across the kv blocks (scaled by alpha
//     in registers before each block); its chain of 2 bkv / 16 truncating
//     products a block stays inside the bfloat16 gate, which
//     tests/test_torch_attention_tc.py emulates.  Query blocks run in
//     descending order (the heaviest first) on a one-dimensional grid.
//  2. mma.sync: every other config (bfloat16 with bq or bkv of 16 or 32,
//     every float32 call, bfloat16 at D 16 or 32).  Each warp owns 16 query
//     rows, a block bq / 16 warps.  bfloat16 runs as m16n8k16, float32 as
//     three TF32 products (hi hi + hi lo + lo hi, m16n8k8), with the tools
//     of mma_tools.cuh that the backward uses.  S and P stay in registers:
//     the S accumulator becomes P's A fragment.  K and V arrive by cp.async
//     into a ring of two swizzled stages of KC rows (KC = bkv in bfloat16,
//     min(bkv, 32) in float32; float32 takes one online-softmax step a KC
//     rows, exact since it rounds no p).  Each P V of a stage starts from
//     zero and is added to the output accumulators by FADD (round to
//     nearest), so no tensor-core chain is longer than a stage.
//
// Instantiations: route 1 at (bq, bkv, D) in {64, 128}^3, 8 kernels; route
// 2 at bq, bkv, D in {16, 32, 64, 128}, float32 and bfloat16, less the 8
// bfloat16 configs route 1 takes: 120 kernels.
//
// What is left: ping-pong scheduling of the two consumer warpgroups (one's
// softmax under the other's products), a persistent grid, skipping the
// masked half of the diagonal blocks, D = 80 / 96 instantiated on route 1
// (wgmma's N allows them), and route 1 for float32.
//
// The launcher allocates nothing, never synchronises, launches on the
// stream it is given, and returns cudaGetLastError() (0 on success).

#include <cuda.h>  // CUtensorMap and the driver's enums (no driver link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_tools.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's finite mask sentinel

// ------------------------------------------------------ shared parts --

// the forward's scalars, shared by every pair
struct Logit {
  float scale, softcap;
  int causal, window;
};

// the (batch, query head, kv head, first row) of this thread block's query
// block: query blocks in descending order outermost, so under causal the
// blocks with the most kv blocks start first
struct BlockPos {
  int b, h, hk, q0;
};
__device__ __forceinline__ BlockPos block_pos(int bq, int nb, int hq, int hkv,
                                              int sq) {
  const int nbh = nb * hq;
  const int qblk = sq / bq - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int bh = static_cast<int>(blockIdx.x) % nbh;
  const int h = bh % hq;
  return {bh / hq, h, h / (hq / hkv), qblk * bq};
}

// the kv blocks [lo, hi) holding a kept pair of the query block from row q0
// (attn_kv_range)
__device__ __forceinline__ void kv_blocks(int q0, int bq, int bkv, int skv,
                                          const Logit& la, int& lo, int& hi) {
  const int nkv = skv / bkv;
  lo = 0;
  hi = nkv;
  if (la.causal) hi = min(nkv, (q0 + bq - 1) / bkv + 1);
  if (la.window > 0) {
    if (q0 + bq - 1 >= skv + la.window - 1) {
      lo = 0;  // a row keeps no key: the reference averages all of v
      hi = nkv;
    } else {
      lo = max(0, q0 - la.window + 1) / bkv;
    }
  }
}

// whether rows [r0, r0 + nr) and keys [k0, k0 + nk) hold a masked pair
__device__ __forceinline__ bool cut(const Logit& la, int r0, int nr, int k0,
                                    int nk) {
  return (la.causal && k0 + nk - 1 > r0) ||
         (la.window > 0 && r0 + nr - 1 - k0 >= la.window);
}

// the logit of pair (qp, kp) from its raw product; `masked`: the block may
// hold masked pairs, so test this one
__device__ __forceinline__ float logit(const Logit& la, float s, int qp,
                                       int kp, bool masked) {
  float x = s * la.scale;
  if (la.softcap > 0.0f) x = la.softcap * tanhf(x / la.softcap);
  if (masked) {
    bool keep = true;
    if (la.causal) keep = qp >= kp;
    if (la.window > 0) keep = keep && (qp - kp) < la.window;
    x = keep ? x : kNegInf;
  }
  return x;
}

// The logits of the tiles x[n][e] (the m16n8 accumulator layout: e >> 1
// picks row g or g + 8, columns k0 + 8 n + 2 t + (e & 1)) of rows row and
// row + 8.
template <int N>
__device__ __forceinline__ void logits(float (&x)[N][4], const Logit& la,
                                       int row, int k0, int t, bool masked) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[n][e] = logit(la, x[n][e], row + 8 * (e >> 1),
                      k0 + 8 * n + 2 * t + (e & 1), masked);
}

// One online-softmax step for the thread's two rows (r = 0: row g, r = 1:
// row g + 8) over the tiles x (logits in, unrounded p out); the rest of
// each row lies with the three other threads of the quad.
template <int N>
__device__ __forceinline__ void softmax_step(float (&x)[N][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], x[n][e]);
  float m_new[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m[r], mx[r]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(x[n][e] - m_new[e >> 1]);
      sum[e >> 1] += p;
      x[n][e] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    alpha[r] = expf(m[r] - m_new[r]);
    l[r] = l[r] * alpha[r] + sum[r];
    m[r] = m_new[r];
  }
}

// out and lse of the thread's rows row and row + 8: the accumulator tiles
// acc[n] hold columns 8 n + 2 t, + 1
template <typename T, int N>
__device__ __forceinline__ void write_rows(const float (&acc)[N][4],
                                           const float (&m)[2],
                                           const float (&l)[2], T* out,
                                           float* lse, size_t row, int d,
                                           int t) {
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  T* orow = out + row * d;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int col = 8 * n + 2 * t;
    store2(orow + col, acc[n][0] / den[0], acc[n][1] / den[0]);
    store2(orow + 8 * d + col, acc[n][2] / den[1], acc[n][3] / den[1]);
  }
  if (lse != nullptr && t == 0) {
    lse[row] = m[0] + logf(den[0]);
    lse[row + 8] = m[1] + logf(den[1]);
  }
}

// The route table (attn_route in flash_attention.py): route 1 (wgmma) for
// bfloat16 at bq, bkv in {64, 128} and D in {64, 128}; route 2 (mma.sync)
// for every other instantiated config; 0 for none.
__host__ __device__ constexpr bool is_block(int x) {
  return x == 16 || x == 32 || x == 64 || x == 128;
}
__host__ __device__ constexpr bool wgmma_route(bool bf16, int bq, int bkv,
                                               int d) {
  return bf16 && (bq == 64 || bq == 128) && (bkv == 64 || bkv == 128) &&
         (d == 64 || d == 128);
}
__host__ __device__ constexpr int route_of(int dtype, int bq, int bkv,
                                           int d) {
  return (dtype != 0 && dtype != 1) || !is_block(bq) || !is_block(bkv) ||
                 !is_block(d)
             ? 0
         : wgmma_route(dtype == 1, bq, bkv, d) ? 1
                                               : 2;
}

// ---------------------------------------------------- route 2: mma.sync --

template <typename T, int BQ, int BKV, int D>
struct SyncCfg {
  static constexpr int kThreads = 32 * (BQ / 16);  // a warp a 16 rows
  // kv rows a stage holds and one online-softmax step takes: a whole block
  // in bfloat16 (p is rounded against the block's max, as the reference
  // rounds it), at most 32 in float32 (which rounds no p)
  static constexpr int KC =
      std::is_same<T, float>::value ? (BKV < 32 ? BKV : 32) : BKV;
  // q, and two stages of k and v (attn_smem_bytes)
  static constexpr size_t kSmem = sizeof(T) * D * (BQ + 4 * KC);
};

template <typename T, int BQ, int BKV, int D>
__global__ void __launch_bounds__(SyncCfg<T, BQ, BKV, D>::kThreads)
attn_sync_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int nb, int hq, int hkv, int sq,
                 int skv, Logit la) {
  using M = Mma<T>;
  using C = SyncCfg<T, BQ, BKV, D>;
  constexpr int kThreads = C::kThreads;
  constexpr int KC = C::KC;
  constexpr int NT = D / 8;      // output n-tiles
  constexpr int ST = KC / 8;     // logit n-tiles of a stage
  constexpr int KS = KC / M::K;  // depth steps of p v over a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // BQ x D, swizzled
  T* ks = qs + BQ * D;                     // two stages of KC x D
  T* vs = ks + 2 * KC * D;                 // two stages of KC x D

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const BlockPos bp = block_pos(BQ, nb, hq, hkv, sq);
  const size_t row0 = (static_cast<size_t>(bp.b) * hq + bp.h) * sq +
                      static_cast<size_t>(bp.q0);
  const T* kv_k = k + (static_cast<size_t>(bp.b) * hkv + bp.hk) * skv * D;
  const T* kv_v = v + (static_cast<size_t>(bp.b) * hkv + bp.hk) * skv * D;
  int lo, hi;
  kv_blocks(bp.q0, BQ, BKV, skv, la, lo, hi);
  const int c_lo = lo * (BKV / KC), c_hi = hi * (BKV / KC);  // stages

  auto stage = [&](int c, int buf) {
    load_tile<T, D, kThreads>(ks + buf * KC * D,
                              kv_k + static_cast<size_t>(c) * KC * D, KC,
                              tid);
    load_tile<T, D, kThreads>(vs + buf * KC * D,
                              kv_v + static_cast<size_t>(c) * KC * D, KC,
                              tid);
  };
  load_tile<T, D, kThreads>(qs, q + row0 * D, BQ, tid);
  stage(c_lo, 0);
  cp_async_commit();

  const int qrow = 16 * warp;  // the warp's rows in the block
  const int row = bp.q0 + qrow + g;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int c = c_lo; c < c_hi; ++c) {
    const int buf = (c - c_lo) & 1;
    if (c + 1 < c_hi) {
      stage(c + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage c (and q) are in for every thread
    const T* kb = ks + buf * KC * D;
    const T* vb = vs + buf * KC * D;

    // s = q k^T over the stage's KC keys
    typename M::Tile st[ST] = {};
#pragma unroll 2
    for (int kd = 0; kd < D; kd += M::K) {
      typename M::A qa;
      load_a<D>(qa, qs, qrow, kd, lane);
#pragma unroll
      for (int n2 = 0; n2 < ST; n2 += 2) {
        typename M::B b0, b1;
        load_b<D>(b0, b1, kb, 8 * n2, kd, lane);
        mma(st[n2], qa, b0);
        mma(st[n2 + 1], qa, b1);
      }
    }
    float x[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = st[n].get(e);
    const int k0 = c * KC;
    logits(x, la, row, k0, t, cut(la, bp.q0 + qrow, 16, k0, KC));
    float alpha[2];
    softmax_step(x, m, l, alpha);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // p v: p becomes the A fragments (rounded once to bfloat16, or split
    // into TF32 hi and lo); each pair of output tiles starts from zero and
    // is added to the accumulators in float32
    typename M::A pf[KS];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) a_from_acc(pf[kk], x, kk);
#pragma unroll
    for (int n2 = 0; n2 < NT; n2 += 2) {
      float pv[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        typename M::B b0, b1;
        load_bt<D>(b0, b1, vb, kk * M::K, 8 * n2, lane);
        mma(pv[0], pf[kk], b0);
        mma(pv[1], pf[kk], b1);
      }
      add_tiles(acc, n2, pv);
    }
    __syncthreads();  // every read of this stage is done before its refill
  }
  cp_async_wait<0>();
  write_rows(acc, m, l, out, lse, row0 + qrow + g, D, t);
}

// ------------------------------------------------------- route 1: wgmma --

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Wait for the phase of `parity` to complete.  A wait that lasts seconds
// is a fault (a copy that never lands): trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  const long long start = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// a 2-D TMA load of the box at (c0 columns, c1 rows) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor of a tile of 128-byte rows with the
// 128-byte swizzle (layout type 1): start address, leading and stride byte
// offsets, each in 16-byte units.  Eight rows (1024 bytes) form one swizzle
// atom.  K-major operands (q, k: the product's depth along the row) step
// 1024 bytes from one 8-row group to the next (stride offset); a k16 step
// inside the atom moves the start by 32 bytes.  The MN-major v (the depth
// down the rows) is read in 64-column panels, one atom wide, so only the
// step between 8-row groups of the depth is used: 1024 bytes in both
// offsets.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, unsigned lbo,
                                               unsigned sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= a b, m64n64k16, a and b from shared memory (K-major): d is
// zeroed first when scale_d is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (+)= a b, m64n128k16, a and b from shared memory (K-major): d is
// zeroed first when scale_d is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d += a b, m64n64k16: a a bf16 fragment in registers (the layout of an
// m16n8k16 A fragment, warp w holding rows 16 w ..), b from shared memory
// MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const unsigned (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Registers after setmaxnreg: the producer warpgroup gives up what the
// consumers take.  ptxas sets a kernel that holds setmaxnreg to the most
// registers its launch bounds allow (168 a thread at 384 threads), and
// the split uses all of them: 40 + 2 x 232 = 3 x 168.  setmaxnreg.inc
// waits for registers the block does not hold, so the launcher refuses a
// build whose allocation does not cover the split rather than hang.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int BQ, int BKV, int D>
struct WgCfg {
  static constexpr int NC = BQ / 64;           // consumer warpgroups
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int NS = 2;                 // stages of the K, V ring
  static constexpr int P = D / 64;             // 64-column panels a tile
  static constexpr unsigned kQBytes = BQ * D * 2;
  static constexpr unsigned kKVBytes = BKV * D * 2;
  // q, then K[NS], V[NS], then the barriers: qfull, kfull[NS],
  // vfull[NS], kempty[NS], vempty[NS]; 1024 bytes to align the tiles
  static constexpr size_t kBarOff = kQBytes + 2 * NS * kKVBytes;
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * (1 + 4 * NS);
};

template <int BQ, int BKV, int D>
__global__ void __launch_bounds__(WgCfg<BQ, BKV, D>::kThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  bf16* __restrict__ out, float* __restrict__ lse, int nb,
                  int hq, int hkv, int sq, int skv, Logit la) {
  using C = WgCfg<BQ, BKV, D>;
  constexpr int NS = C::NS;
  constexpr int SN = BKV / 8;  // n-tiles of S
  constexpr int ON = 64 / 8;   // n-tiles of an O panel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sq_ = base;                           // P panels of BQ x 64
  unsigned char* sk = base + C::kQBytes;               // NS tiles
  unsigned char* sv = sk + NS * C::kKVBytes;           // NS tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::kBarOff);
  uint64_t* qfull = bars;
  uint64_t* kfull = bars + 1;
  uint64_t* vfull = kfull + NS;
  uint64_t* kempty = vfull + NS;
  uint64_t* vempty = kempty + NS;

  const BlockPos bp = block_pos(BQ, nb, hq, hkv, sq);
  int lo, hi;
  kv_blocks(bp.q0, BQ, BKV, skv, la, lo, hi);
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
      mbar_init(kempty + s, 4 * C::NC);  // one arrival a consumer warp
      mbar_init(vempty + s, 4 * C::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::NC) {
    // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == 128 * C::NC) {
      const int qrow = (bp.b * hq + bp.h) * sq + bp.q0;
      const int kvrow = (bp.b * hkv + bp.hk) * skv;
      mbar_expect_tx(qfull, C::kQBytes);
      for (int p = 0; p < C::P; ++p)
        tma_load(sq_ + p * BQ * 128, &tq, qfull, 64 * p, qrow);
      for (int j = lo, n = 0; j < hi; ++j, ++n) {
        const int s = n % NS;
        const unsigned ph = (n / NS) & 1;
        mbar_wait(kempty + s, ph ^ 1);  // the first round passes at once
        mbar_expect_tx(kfull + s, C::kKVBytes);
        for (int p = 0; p < C::P; ++p)
          tma_load(sk + s * C::kKVBytes + p * BKV * 128, &tk, kfull + s,
                   64 * p, kvrow + j * BKV);
        mbar_wait(vempty + s, ph ^ 1);
        mbar_expect_tx(vfull + s, C::kKVBytes);
        for (int p = 0; p < C::P; ++p)
          tma_load(sv + s * C::kKVBytes + p * BKV * 128, &tv, vfull + s,
                   64 * p, kvrow + j * BKV);
      }
    }
  } else {
    // a consumer warpgroup: query rows [64 wg, 64 wg + 64) of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int lane = threadIdx.x % 32;
    const int wq = (threadIdx.x % 128) / 32;  // warp in the warpgroup
    const int g = lane >> 2, t = lane & 3;
    const int rq = 64 * wg;
    const int row = bp.q0 + rq + 16 * wq + g;  // and row + 8
    float o[C::P][ON][4];
#pragma unroll
    for (int p = 0; p < C::P; ++p)
#pragma unroll
      for (int n = 0; n < ON; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[p][n][e] = 0.0f;
    float x[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    float(&sflat)[SN * 4] = reinterpret_cast<float(&)[SN * 4]>(x);

    mbar_wait(qfull, 0);
    for (int j = lo, n = 0; j < hi; ++j, ++n) {
      const int s = n % NS;
      const unsigned ph = (n / NS) & 1;
      const unsigned char* ks = sk + s * C::kKVBytes;
      const unsigned char* vs = sv + s * C::kKVBytes;
      // S = Q K^T: D / 16 products, both operands in shared memory
      mbar_wait(kfull + s, ph);
      fence_regs(sflat);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        wgmma_ss(sflat,
                 desc_sw128(sq_ + p * BQ * 128 + rq * 128 + off, 16, 1024),
                 desc_sw128(ks + p * BKV * 128 + off, 16, 1024),
                 kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sflat);
      __syncwarp();
      if (lane == 0) mbar_arrive(kempty + s);  // this warp is done with K

      const int k0 = j * BKV;
      logits(x, la, row, k0, t, cut(la, bp.q0 + rq, 64, k0, BKV));
      float alpha[2];
      softmax_step(x, m, l, alpha);
      BfA pa[BKV / 16];  // p rounded to bfloat16 once, as A fragments
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) a_from_acc(pa[kk], x, kk);
#pragma unroll
      for (int p = 0; p < C::P; ++p) {
#pragma unroll
        for (int nn = 0; nn < ON; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[p][nn][e] *= alpha[e >> 1];
        fence_regs(reinterpret_cast<float(&)[ON * 4]>(o[p]));
      }

      // O += P V: A from registers, V through the transpose bit, one
      // product a 64-column panel and 16 keys
      mbar_wait(vfull + s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int p = 0; p < C::P; ++p)
          wgmma_rs(reinterpret_cast<float(&)[ON * 4]>(o[p]), pa[kk].x,
                   desc_sw128(vs + p * BKV * 128 + kk * 16 * 128, 1024,
                              1024));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int p = 0; p < C::P; ++p)
        fence_regs(reinterpret_cast<float(&)[ON * 4]>(o[p]));
      __syncwarp();
      if (lane == 0) mbar_arrive(vempty + s);  // and with V
    }

    const size_t orow = (static_cast<size_t>(bp.b) * hq + bp.h) * sq +
                        static_cast<size_t>(row);
#pragma unroll
    for (int p = 0; p < C::P; ++p)
      write_rows(o[p], m, l, out + 64 * p, p == 0 ? lse : nullptr, orow, D,
                 t);
  }
}

// ------------------------------------------------------------ launching --

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int b, hq, hkv, sq, skv;
  Logit la;
  cudaStream_t stream;
};

template <typename T, int BQ, int BKV, int D>
int launch_sync(const Args& a) {
  using C = SyncCfg<T, BQ, BKV, D>;
  auto kernel = attn_sync_kernel<T, BQ, BKV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(a.sq / BQ) * a.hq * a.b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.b, a.hq,
      a.hkv, a.sq, a.skv, a.la);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to the
// driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the tensor map of a (rows, d) row-major bfloat16 matrix read in boxes of
// 64 columns (128 bytes, the swizzle's width) by box_rows rows
bool tensor_map(CUtensorMap* map, const void* ptr, long long rows, int d,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BQ, int BKV, int D>
int launch_wgmma(const Args& a) {
  using C = WgCfg<BQ, BKV, D>;
  auto kernel = attn_wgmma_kernel<BQ, BKV, D>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * (C::NC + 1) < kProducerRegs + C::NC * kConsumerRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long qrows = static_cast<long long>(a.b) * a.hq * a.sq;
  const long long kvrows = static_cast<long long>(a.b) * a.hkv * a.skv;
  const long long blocks = static_cast<long long>(a.sq / BQ) * a.hq * a.b;
  if (qrows > INT_MAX || kvrows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, a.q, qrows, D, BQ) ||
      !tensor_map(&tk, a.k, kvrows, D, BKV) ||
      !tensor_map(&tv, a.v, kvrows, D, BKV))
    return static_cast<int>(cudaErrorNotSupported);
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, a.stream>>>(
      tq, tk, tv, static_cast<bf16*>(a.out), a.lse, a.b, a.hq, a.hkv, a.sq,
      a.skv, a.la);
  return static_cast<int>(cudaGetLastError());
}

// the route of (T, BQ, BKV, D), fixed at compile time
template <typename T, int BQ, int BKV, int D>
int launch(const Args& a) {
  if constexpr (wgmma_route(std::is_same<T, bf16>::value, BQ, BKV, D))
    return launch_wgmma<BQ, BKV, D>(a);
  else
    return launch_sync<T, BQ, BKV, D>(a);
}

template <typename T, int D>
int dispatch_blocks(const Args& a, int bq, int bkv) {
#define REPRO_BLOCKS(BQ_, BKV_) \
  if (bq == (BQ_) && bkv == (BKV_)) return launch<T, BQ_, BKV_, D>(a);
  REPRO_BLOCKS(16, 16) REPRO_BLOCKS(16, 32) REPRO_BLOCKS(16, 64)
  REPRO_BLOCKS(16, 128) REPRO_BLOCKS(32, 16) REPRO_BLOCKS(32, 32)
  REPRO_BLOCKS(32, 64) REPRO_BLOCKS(32, 128) REPRO_BLOCKS(64, 16)
  REPRO_BLOCKS(64, 32) REPRO_BLOCKS(64, 64) REPRO_BLOCKS(64, 128)
  REPRO_BLOCKS(128, 16) REPRO_BLOCKS(128, 32) REPRO_BLOCKS(128, 64)
  REPRO_BLOCKS(128, 128)
#undef REPRO_BLOCKS
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const Args& a, int d, int bq, int bkv) {
  switch (d) {
    case 16:
      return dispatch_blocks<T, 16>(a, bq, bkv);
    case 32:
      return dispatch_blocks<T, 32>(a, bq, bkv);
    case 64:
      return dispatch_blocks<T, 64>(a, bq, bkv);
    case 128:
      return dispatch_blocks<T, 128>(a, bq, bkv);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The route the table gives (dtype, bq, bkv, d): 1 wgmma, 2 mma.sync, 0
// none (the launch refuses it).
int repro_flash_attention_route(int dtype, int bq, int bkv, int d) {
  return route_of(dtype, bq, bkv, d);
}

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
      bq <= 0 || bkv <= 0 || sq % bq || skv % bkv ||
      route_of(dtype, bq, bkv, d) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, static_cast<float*>(lse), b, hq, hkv, sq, skv,
               Logit{scale, softcap, causal, window},
               static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? dispatch<float>(a, d, bq, bkv)
                    : dispatch<bf16>(a, d, bq, bkv);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
