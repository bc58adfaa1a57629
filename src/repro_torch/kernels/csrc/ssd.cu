// Mamba-2 SSD chunked scan for Hopper (sm_90a), float32 on the tensor cores
// (3xTF32 mma.sync), hand-written, in Mamba-2's chunk-parallel three-pass
// form.
//
// Replaces: src/repro/kernels/ssd.py::_ssd_kernel, the Pallas TPU kernel
// that runs the state-space-duality scan over a (B, H, L/chunk) grid,
// carrying a float32 (P, N) state in VMEM scratch along the chunk axis.
//
// What it computes, exactly as the TPU kernel does: x (B, L, H, P),
// dt (B, L, H), a_log (H,), b and c (B, L, G, N) with H % G == 0 and the
// group of head h being h / (H / G).  Per head a = -exp(a_log[h]); per
// chunk of Q steps (X, B, C its rows, h the carried state)
//   s = inclusive cumsum(a * dt)                     (Q,)
//   G = (C B^T) * decay * dt^T,  decay_ij = exp(s_i - s_j) for i >= j, else 0
//   y = G X + exp(s) * (C h^T)                       (Q, P)
//   h = exp(s_Q) * h + X^T (B * w),  w = dt * exp(s_Q - s)
// No softplus on dt and no D skip (the kernel's contract, not the model's).
// The decay is exponentiated only where i >= j: above the diagonal
// s_i - s_j > 0 grows with the distance and exp overflows, and a multiply
// by a 0/1 mask would then give inf * 0 = NaN.
//
// Design.  The TPU walks the chunks of a head in order because its grid
// runs in order and carries the state in VMEM.  On Hopper that chain would
// leave one block per (b, h) walking 16 to 128 dependent chunks.  The state
// recurrence is linear, so the chain splits into three passes, and only the
// middle one is sequential:
//
//  1. ssd_chunk_state_kernel, one block per (b, chunk, two heads of one
//     group): each head's cumulative log-decay s by a block-wide scan,
//     written to a float32 scratch (B, H, L) so pass 3 does not scan again,
//     and its own state contribution S_c = (X o w)^T B, a (P, N) tile over
//     depth Q, written to a scratch (B, H, L/Q, P, N).  B is staged once for
//     both heads.
//  2. ssd_state_pass_kernel, one thread per four state elements of a
//     (b, h): walks the chunks in order, writes h_in[c] = h over S_c in
//     place and updates h = exp(s_Q of chunk c) h + S_c.  h starts at the
//     caller's h0 (B, H, P, N) where one is given, else at 0, and the h
//     after the last chunk goes to h_final (B, H, P, N) where one is asked
//     for.  Elementwise, 16-byte loads prefetched one chunk ahead: bound by
//     bytes (it reads and writes the scratch once).
//  3. ssd_chunk_scan_kernel, one block per (b, chunk, R-row query tile,
//     HB heads of one group), R = min(chunk, 64): y = exp(s) o (C h_in^T)
//     plus, over the key slabs on and below the diagonal, (C B^T o decay o
//     dt^T) X.
//
// What bounds it on the H100 (700 W).  At mamba2-2.7b's (1, 4096, 80, 64, 1,
// 128) and chunk 256 the function needs 16.3 GFLOP: per head and chunk G X
// over the kept pairs (2 P a pair), C h_in^T and (X o w)^T B (2 Q P N
// each), and C B^T over the kept pairs (2 N a pair) once a (b, group,
// chunk), not once a head -- C and B belong to the group.  Against 0.17 GB
// read or written once that is bound by operations: 0.099 ms as three TF32
// products at 495 TFLOP/s (this file), 0.243 ms on FFMA at 67 TFLOP/s (the
// design this replaced, which also formed C B^T once a head: 8.4 of each
// head's 21.0 MFLOP a chunk).  Pass 2 and the state scratch's four passes
// over HBM (41.9 MB at chunk 256) are bytes.
//
// What the design does about it.
//  * Every product of passes 1 and 3 runs on the tensor cores as 3xTF32
//    mma.sync m16n8k8 (csrc/mma_tools.cuh): each float32 operand is split
//    a = hi + lo, hi the nearest TF32 and lo = a - hi (of which the tensor
//    core reads the top 19 bits), and hi hi + hi lo + lo hi summed, as in
//    the backward (ssd_bwd.cu).  A product of TF32 parts is exact, and the
//    dropped lo lo term and lo's truncation are below float32's rounding of
//    each operand, so the sums meet the float32 gates (1e-5 normwise
//    against the plain version at mamba2's width, 2e-4 elementwise against
//    the sequential oracle) where one TF32 product (10 mantissa bits) would
//    not (tests/test_torch_ssd_tc.py emulates both).
//  * Tensor-core accumulators truncate, so every chain into an output is
//    short: C h_in^T in chains of at most 64 of depth, each slab's G X (a
//    depth of R <= 64) and each 32-step slab of pass 1 from zero, added to
//    the float32 sums by FADD (round to nearest); the C B^T tile keeps its
//    small hi lo and lo hi terms in an accumulator of their own, so its
//    chain of hi hi products is a third as long.
//  * C B^T once for the heads of a block.  A pass-3 block takes HB
//    consecutive heads of one group: the largest divisor of H / G up to
//    kMaxHeads = 4 (kernels/ssd.py: ssd_scan_heads).  Its eight warps (at
//    R = 64) are four row groups of 16 query rows times two head lanes; per
//    key slab the two warps of a row group form the C B^T rows of their
//    group, each half of the slab's key columns, and swap the halves
//    through shared memory, so every warp holds its 16 x R rows of C B^T in
//    registers in the accumulator's layout.  For each head the warp applies
//    the head's decay and dt to a copy, element by element at the row and
//    column each accumulator element has, converts it into the A fragment
//    of G X (an m16n8 accumulator tile is an m16k8 A fragment in a permuted
//    depth order, which the k-major X operand is read in), and adds the
//    slab's G X to the head's y, kept in registers across the slabs (two
//    heads a warp).  So C B^T costs once a block what it cost once a head.
//  * Pass 1 runs two heads of a group in one block, one a head lane: the B
//    rows of a 32-step slab are staged once for both, and each warp forms
//    its 16 rows of P of its head's S_c over all of N.  The two heads'
//    decays are read and scanned in one pass (each in the order a scan of
//    it alone takes), so the block waits on one chain of loads and
//    barriers before its first slab, not two.
//  * The skip rule.  Query tile t (rows t R .. t R + R - 1 of the chunk)
//    visits only the key slabs 0 .. t: a slab above the diagonal holds no
//    pair i >= j.  In the diagonal slab a warp skips the C B^T n-tiles and
//    the G X depth steps wholly above its 16 rows.  The query tiles launch
//    heaviest first (tile nq - 1 is outermost in the block index), so the
//    one-slab tiles fill the tail of the last wave.  ssd_query_tiles and
//    ssd_key_slabs in kernels/ssd.py say the same.
//  * Staging goes through cp.async (16 bytes a thread; dt, H floats apart,
//    4 bytes) into row-major tiles whose 16-byte chunks are XOR-swizzled by
//    the row (mma_tools.cuh's Swizzled), so the ldmatrix rows and the
//    4-byte k-major reads fall in distinct bank groups.  A pass-3 block
//    keeps its query tile's C rows and, per step, double-buffers either the
//    h_in of a pair of heads (the state term first) or a key slab's B rows
//    with the X rows, s and dt of a pair of heads: the B rows are read only
//    by the pair that forms C B^T.  183,296 bytes at (P, N, R) = (64, 128,
//    64), one block an SM (kernels/ssd.py: ssd_smem_bytes).
//  * mma.sync, not wgmma: wgmma takes TF32 operands only K-major from
//    shared memory, and G X's X rows and pass 1's X and B rows lie N-major
//    as they are read (j rows of P or N values); they would have to be
//    staged transposed.
//
// What is left.  Timed on the H100 (PERF.md; tools/ssd_pass3_probe.py
// times pass 3 without its copies and without its products), pass 3 is
// bound by its products as mma.sync issues them, not by its copies, which
// overlap them: eight warps an SM (252 registers a thread, 183 KB a block)
// with two warps a scheduler.  Four heads a block ran faster than two and
// one (tools/ssd_forward_times.py).  None of these ran faster: a
// four-stage ring of smaller steps (h_in by halves of N, the B rows
// alone), C B^T read from shared memory in a runtime loop over the depth
// steps, the diagonal's depth steps as compile-time counts, the query
// tiles of a chunk side by side, the three TF32 terms issued term by term
// or the small ones into an accumulator of their own.  Pass 1 runs no
// faster than the FFMA pass it replaced: eight warps an SM at 224
// registers, and a block waits on its decay scan before its first slab;
// two blocks an SM (128 registers), sixteen warps a block and both heads
// in each warp ran slower.  The way on is wgmma with the transposed
// staging above.
//
// Instantiations: pass 1 for P in {8, 16, 32, 64} and N in {8, 16, 32, 64,
// 128}; pass 3 for those and R in {16, 32, 64} (register arrays need
// compile-time sizes); pass 2 is one kernel.  The chunk is a runtime
// multiple of R (16, 32 or a multiple of 64).
//
// The launchers allocate nothing (the wrapper allocates both scratches),
// never synchronise, launch on the stream they are given, and return
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <type_traits>

#include "mma_tools.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kPassThreads = 128;  // pass 2
constexpr int kStateSlab = 32;     // pass 1: steps of a slab
constexpr int kLanes = 2;          // head lanes: warps of a row group
constexpr int kMaxHeads = 4;       // pass 3: heads of a block
constexpr int kHeadsPerWarp = kMaxHeads / kLanes;

// ---------------------------------------------------------------- copies --

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

// cp.async of `rows` rows of W floats (row r at src + r stride) into a
// swizzled tile, by the NT threads of the block
template <int W, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          size_t stride, int rows, int tid) {
  using S = Swizzled<float, W>;
  for (int idx = tid; idx < rows * S::kCpr; idx += NT) {
    const int r = idx / S::kCpr, c = idx % S::kCpr;
    cp_async16(dst + r * W + ((c ^ (r & S::kMask)) << 2),
               src + r * stride + 4 * c);
  }
}
// n contiguous floats (n a multiple of 4, src 16-byte aligned)
template <int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n,
                                         int tid) {
  for (int idx = tid; idx < n / 4; idx += NT)
    cp_async16(dst + 4 * idx, src + 4 * idx);
}
// n floats `stride` apart
template <int NT>
__device__ __forceinline__ void load_strided(float* dst, const float* src,
                                             size_t stride, int n, int tid) {
  for (int idx = tid; idx < n; idx += NT)
    cp_async4(dst + idx, src + idx * stride);
}

// ------------------------------------------------------------ fragments --
// (mma_tools.cuh holds the pair loaders; these take one n-tile or a run of
// them, and the scaled k-major A of pass 1.)

// B fragments of the JT n-tiles [n0, n0 + 8 JT) at depth [k0, k0 + 8) of a
// swizzled tile whose rows are n and whose depth runs along the row
template <int D, int JT>
__device__ __forceinline__ void load_b_run(TfB (&b)[JT], const float* tile,
                                           int n0, int k0, int lane) {
  if constexpr (JT == 1) {
    using S = Swizzled<float, D>;
    const int g = lane >> 2, t = lane & 3;
    split_tf32(tile[S::at(n0 + g, k0 + t)], b[0].hi[0], b[0].lo[0]);
    split_tf32(tile[S::at(n0 + g, k0 + t + 4)], b[0].hi[1], b[0].lo[1]);
  } else {
    static_assert(JT % 2 == 0, "one n-tile or pairs");
#pragma unroll
    for (int u = 0; u < JT; u += 2)
      load_b<D>(b[u], b[u + 1], tile, n0 + 8 * u, k0, lane);
  }
}
// The same from a tile whose rows are the depth (k-major), in the permuted
// depth order of load_bt and a_from_acc
template <int D, int JT>
__device__ __forceinline__ void load_bt_run(TfB (&b)[JT], const float* tile,
                                            int k0, int n0, int lane) {
  if constexpr (JT == 1) {
    using S = Swizzled<float, D>;
    const int g = lane >> 2, r = k0 + 2 * (lane & 3);
    split_tf32(tile[S::at(r, n0 + g)], b[0].hi[0], b[0].lo[0]);
    split_tf32(tile[S::at(r + 1, n0 + g)], b[0].hi[1], b[0].lo[1]);
  } else {
    static_assert(JT % 2 == 0, "one n-tile or pairs");
#pragma unroll
    for (int u = 0; u < JT; u += 2)
      load_bt<D>(b[u], b[u + 1], tile, k0, n0 + 8 * u, lane);
  }
}

// A of rows [m0, m0 + 16) from a k-major swizzled tile (rows the depth,
// columns m), in the permuted depth order, depth row k0 + 2t scaled by sc0
// and k0 + 2t + 1 by sc1; rows m >= mmax are zero
template <int D>
__device__ __forceinline__ void load_a_kmajor(TfA& a, const float* tile,
                                              int k0, int m0, int mmax,
                                              float sc0, float sc1, int lane) {
  using S = Swizzled<float, D>;
  const int g = lane >> 2, r = k0 + 2 * (lane & 3);
  const bool low = m0 + g + 8 < mmax;
  split_tf32(sc0 * tile[S::at(r, m0 + g)], a.hi[0], a.lo[0]);
  split_tf32(low ? sc0 * tile[S::at(r, m0 + g + 8)] : 0.0f, a.hi[1],
             a.lo[1]);
  split_tf32(sc1 * tile[S::at(r + 1, m0 + g)], a.hi[2], a.lo[2]);
  split_tf32(low ? sc1 * tile[S::at(r + 1, m0 + g + 8)] : 0.0f, a.hi[3],
             a.lo[3]);
}

// in-place inclusive prefix sums of the `runs` (1 or 2) arrays v[r n ..
// r n + n) by the NT threads of the block, in one pass: each thread sums a
// run of ceil(n / NT) neighbours of each array, the runs are scanned across
// a warp by shuffles and across the warps through `sums` (kLanes NT / kWarp
// floats); each array's sums in the order a scan of it alone takes; ends
// with a barrier
template <int NT>
__device__ void block_inclusive_scan(float* v, int n, int runs,
                                     float* sums) {
  constexpr int kWarps = NT / kWarp;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int per = (n + NT - 1) / NT;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  float run[kLanes], incl[kLanes];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    run[r] = 0.0f;
    if (r < runs)
      for (int t = lo; t < hi; ++t) {
        run[r] += v[r * n + t];
        v[r * n + t] = run[r];
      }
    incl[r] = run[r];
#pragma unroll
    for (int off = 1; off < kWarp; off *= 2) {
      const float up = __shfl_up_sync(0xffffffffu, incl[r], off);
      if (lane >= off) incl[r] += up;
    }
    if (lane == kWarp - 1) sums[r * kWarps + warp] = incl[r];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < kLanes; ++r) {
      float tot = lane < kWarps ? sums[r * kWarps + lane] : 0.0f;
#pragma unroll
      for (int off = 1; off < kWarps; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += up;
      }
      if (lane < kWarps) sums[r * kWarps + lane] = tot;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    if (r >= runs) break;
    const float before =
        incl[r] - run[r] + (warp > 0 ? sums[r * kWarps + warp - 1] : 0.0f);
    for (int t = lo; t < hi; ++t) v[r * n + t] += before;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- pass 1 --
// Shared memory, floats: two slab buffers (the B rows of a 32-step slab,
// then the X rows of each head lane), w of the chunk a head lane, and the
// warps' totals of the scan.
template <int P, int N>
struct StateShape {
  static constexpr int RG = (P + 15) / 16;           // row groups of P
  static constexpr int kThreads = RG * kLanes * kWarp;
  static constexpr int NT = N / 8;                   // n-tiles of N
  static constexpr int kStage = kStateSlab * N + kLanes * kStateSlab * P;
  __host__ __device__ static constexpr size_t floats(int chunk) {
    return 2 * static_cast<size_t>(kStage) + kLanes * chunk +
           kLanes * kThreads / kWarp;
  }
};

template <int P, int N>
__global__ void __launch_bounds__(StateShape<P, N>::kThreads)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ a_log,
                       const float* __restrict__ bm, float* __restrict__ s,
                       float* __restrict__ states, int L, int H, int G,
                       int chunk, int heads) {
  using S = StateShape<P, N>;
  constexpr int NTH = S::kThreads, NT = S::NT;
  constexpr int NP = NT >= 2 ? 2 : 1;
  constexpr int KS = kStateSlab / 8;                 // depth steps a slab
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                     // two slab buffers
  float* wv = ring + 2 * S::kStage;       // w of the chunk, a head lane each
  float* sums = wv + kLanes * chunk;      // the warps' totals of the scan

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int rg = warp % S::RG, hl = warp / S::RG;
  const int gq = lane >> 2, tq = lane & 3;
  const int c = blockIdx.x, h0 = blockIdx.y * heads, b = blockIdx.z;
  const int g = h0 / (H / G), nc = L / chunk;
  const size_t t0 = static_cast<size_t>(b) * L +
                    static_cast<size_t>(c) * chunk;
  const size_t xstride = static_cast<size_t>(H) * P;
  const size_t bstride = static_cast<size_t>(G) * N;
  const float* bg = bm + (t0 * G + g) * N;  // step j at + j G N
  const int rows = chunk < kStateSlab ? chunk : kStateSlab;
  const int nslab = chunk / rows;

  auto stage = [&](int k, int buf) {
    float* st = ring + buf * S::kStage;
    const size_t j0 = static_cast<size_t>(k) * rows;
    load_rows<N, NTH>(st, bg + j0 * bstride, bstride, rows, tid);
    for (int hh = 0; hh < heads; ++hh)
      load_rows<P, NTH>(st + kStateSlab * (N + hh * P),
                        x + ((t0 + j0) * H + h0 + hh) * P, xstride, rows,
                        tid);
  };
  stage(0, 0);
  cp_async_commit();

  // the heads' cumulative log-decays, both at once while slab 0 is in
  // flight: s to the scratch, w = dt exp(s_Q - s) kept for the slabs
  float a[kLanes], s_last[kLanes];
#pragma unroll
  for (int hh = 0; hh < kLanes; ++hh)
    a[hh] = hh < heads ? -expf(a_log[h0 + hh]) : 0.0f;
  for (int t = tid; t < chunk; t += NTH)
#pragma unroll
    for (int hh = 0; hh < kLanes; ++hh)
      if (hh < heads) wv[hh * chunk + t] = a[hh] * dt[(t0 + t) * H + h0 + hh];
  __syncthreads();
  block_inclusive_scan<NTH>(wv, chunk, heads, sums);
#pragma unroll
  for (int hh = 0; hh < kLanes; ++hh) s_last[hh] = wv[hh * chunk + chunk - 1];
  __syncthreads();  // every thread has s_last before w overwrites it
  for (int t = tid; t < chunk; t += NTH)
#pragma unroll
    for (int hh = 0; hh < kLanes; ++hh)
      if (hh < heads) {
        const float st = wv[hh * chunk + t];
        s[(static_cast<size_t>(b) * H + h0 + hh) * L +
          static_cast<size_t>(c) * chunk + t] = st;
        wv[hh * chunk + t] =
            dt[(t0 + t) * H + h0 + hh] * expf(s_last[hh] - st);
      }

  const int m0 = 16 * rg;
  const bool active = hl < heads;
  const float* wl = wv + hl * chunk;
  float acc[NT][4] = {};
  for (int k = 0; k < nslab; ++k) {
    const int buf = k & 1;
    if (k + 1 < nslab) {
      stage(k + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slab k is in for every thread (and w, at k = 0)
    if (active) {
      const float* bs = ring + buf * S::kStage;
      const float* xs = bs + kStateSlab * (N + hl * P);
      const float* wk = wl + k * rows;
      // S_c += (X o w)^T B over the slab: the A fragments of its depth
      // steps, then one chain from zero an n-tile pair, added by FADD
      TfA f[KS];
#pragma unroll
      for (int u = 0; u < KS; ++u)
        if (8 * u < rows) {
          const int r = 8 * u + 2 * tq;
          load_a_kmajor<P>(f[u], xs, 8 * u, m0, P, wk[r], wk[r + 1], lane);
        }
#pragma unroll
      for (int n2 = 0; n2 < NT; n2 += NP) {
        float part[NP][4] = {};
#pragma unroll
        for (int u = 0; u < KS; ++u)
          if (8 * u < rows) {
            TfB bb[NP];
            load_bt_run<N, NP>(bb, bs, 8 * u, 8 * n2, lane);
#pragma unroll
            for (int v = 0; v < NP; ++v) mma(part[v], f[u], bb[v]);
          }
#pragma unroll
        for (int v = 0; v < NP; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n2 + v][e] += part[v][e];
      }
    }
    __syncthreads();  // every read of this buffer is done before its refill
  }
  if (!active) return;
  float* out = states +
               ((static_cast<size_t>(b) * H + h0 + hl) * nc + c) * P * N;
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int col = 8 * u + 2 * tq;
    store2(out + (m0 + gq) * N + col, acc[u][0], acc[u][1]);
    if (m0 + gq + 8 < P)
      store2(out + (m0 + gq + 8) * N + col, acc[u][2], acc[u][3]);
  }
}

// ---------------------------------------------------------------- pass 2 --
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ s,
                      const float* __restrict__ h0,
                      float* __restrict__ h_final, int L, int H, int chunk,
                      int pn4) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= pn4) return;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const int nc = L / chunk;
  float4* st = reinterpret_cast<float4*>(states) + bh * nc * pn4 + e;
  const float* s_last = s + bh * L + chunk - 1;  // chunk c at + c chunk
  float4 hv = h0 ? reinterpret_cast<const float4*>(h0)[bh * pn4 + e]
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 next = st[0];
  float s_next = s_last[0];
  for (int c = 0; c < nc; ++c) {
    const float4 cur = next;
    const float d = expf(s_next);
    if (c + 1 < nc) {
      next = st[static_cast<size_t>(c + 1) * pn4];
      s_next = s_last[static_cast<size_t>(c + 1) * chunk];
    }
    st[static_cast<size_t>(c) * pn4] = hv;
    hv = make_float4(fmaf(d, hv.x, cur.x), fmaf(d, hv.y, cur.y),
                     fmaf(d, hv.z, cur.z), fmaf(d, hv.w, cur.w));
  }
  if (h_final) reinterpret_cast<float4*>(h_final)[bh * pn4 + e] = hv;
}

// ---------------------------------------------------------------- pass 3 --
// Shared memory, floats: the query tile's C rows (R x N); two step buffers,
// each either a pair of heads' h_in (2 x P x N) or a key slab's B rows (R x
// N) with each head lane's X rows (R x P), s and dt (2 R); the swap of the
// C B^T halves (a float4 a lane and n-tile of each warp's half: R x R); s
// of the tile's rows for each head of the block.
template <int P, int N, int R>
struct ScanShape {
  static constexpr int W = R / 16;                  // row groups
  static constexpr int kThreads = kLanes * W * kWarp;
  static constexpr int PT = P / 8;                  // n-tiles of y
  static constexpr int RT = R / 8;                  // key n-tiles of a slab
  static constexpr int RTL = RT / kLanes;           // ... a head lane's half
  static constexpr int kHead = R * P + 2 * R;
  static constexpr int kSlabStep = R * N + kLanes * kHead;
  static constexpr int kStateStep = kLanes * P * N;
  static constexpr int kStage =
      kSlabStep > kStateStep ? kSlabStep : kStateStep;
  static constexpr int kSwap = kLanes * W * RTL * 4 * kWarp;
  static constexpr int kFloats =
      R * N + 2 * kStage + kSwap + kMaxHeads * R;
};

// y = exp(s_i) (C h_in^T) for the warp's 16 rows: chains of at most 64 of
// depth N, each from zero, added by FADD
template <int P, int N>
__device__ __forceinline__ void state_term(float (&yp)[P / 8][4],
                                           const float* ct, const float* hin,
                                           int wr0, int lane,
                                           const float (&es)[2]) {
  constexpr int PT = P / 8, NP = PT >= 2 ? 2 : 1;
  constexpr int KC = N < 64 ? N : 64;
#pragma unroll 1
  for (int k0 = 0; k0 < N; k0 += KC) {
    float part[PT][4] = {};
#pragma unroll 2
    for (int kd = k0; kd < k0 + KC; kd += 8) {
      TfA a;
      load_a<N>(a, ct, wr0, kd, lane);
#pragma unroll
      for (int i = 0; i < PT; i += NP) {
        TfB bb[NP];
        load_b_run<N, NP>(bb, hin, 8 * i, kd, lane);
#pragma unroll
        for (int v = 0; v < NP; ++v) mma(part[i + v], a, bb[v]);
      }
    }
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) yp[i][e] += part[i][e];
  }
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) yp[i][e] *= es[e >> 1];
}

// The warp's rows of C B_k^T: its head lane's half of the key n-tiles over
// depth N (hi hi and the small terms in accumulators of their own), then
// the other lane's half from the partner warp through `swap`.  Has a
// barrier, so the whole block calls it.
template <int N, int R>
__device__ __forceinline__ void form_cb(float (&cb)[R / 8][4],
                                        const float* ct, const float* bk,
                                        float* swap, int warp, int partner,
                                        int hl, int wr0, bool diag,
                                        int lane) {
  constexpr int RTL = R / 16;
  TfTile t[RTL];
#pragma unroll
  for (int u = 0; u < RTL; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[u].c[e] = t[u].corr[e] = 0.0f;
  const int nb = hl * RTL;
#pragma unroll 2
  for (int kd = 0; kd < N; kd += 8) {
    TfA a;
    load_a<N>(a, ct, wr0, kd, lane);
    TfB bb[RTL];
    load_b_run<N, RTL>(bb, bk, 8 * nb, kd, lane);
#pragma unroll
    for (int u = 0; u < RTL; ++u)  // n-tiles wholly above the diagonal: 0
      if (!diag || 8 * (nb + u) <= wr0 + 15) mma(t[u], a, bb[u]);
  }
  float own[RTL][4];
  float4* mine = reinterpret_cast<float4*>(swap) + warp * RTL * kWarp + lane;
#pragma unroll
  for (int u = 0; u < RTL; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) own[u][e] = t[u].get(e);
    mine[u * kWarp] = make_float4(own[u][0], own[u][1], own[u][2], own[u][3]);
  }
  __syncthreads();  // both halves are in
  const float4* theirs =
      reinterpret_cast<const float4*>(swap) + partner * RTL * kWarp + lane;
#pragma unroll
  for (int u = 0; u < RTL; ++u) {
    const float4 v = theirs[u * kWarp];
    const float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cb[u][e] = hl == 0 ? own[u][e] : o[e];
      cb[RTL + u][e] = hl == 0 ? o[e] : own[u][e];
    }
  }
}

// y += G X_k for one head over the slab's depth R (one chain from zero,
// added by FADD), G = C B^T o exp(s_i - s_j) o dt_j made per accumulator
// element, exp taken only where i >= j
template <int P, int R>
__device__ __forceinline__ void slab_term(float (&yp)[P / 8][4],
                                          const float (&cb)[R / 8][4],
                                          const float* xk, const float* sk,
                                          const float* dtk,
                                          const float (&si)[2], bool diag,
                                          int ia, int ib, int wr0, int lane) {
  constexpr int PT = P / 8, NP = PT >= 2 ? 2 : 1;
  const int tq = lane & 3;
  float part[PT][4] = {};
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    if (diag && 8 * kk > wr0 + 15) break;  // wholly above the diagonal
    float gv[1][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? ia : ib;
      const int j = 8 * kk + 2 * tq + (e & 1);
      gv[0][e] = !diag || j <= i
                     ? cb[kk][e] * expf(si[e >> 1] - sk[j]) * dtk[j]
                     : 0.0f;
    }
    TfA a;
    a_from_acc<1>(a, gv, 0);
#pragma unroll
    for (int i = 0; i < PT; i += NP) {
      TfB bb[NP];
      load_bt_run<P, NP>(bb, xk, 8 * kk, 8 * i, lane);
#pragma unroll
      for (int v = 0; v < NP; ++v) mma(part[i + v], a, bb[v]);
    }
  }
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) yp[i][e] += part[i][e];
}

template <int P, int N, int R>
__global__ void __launch_bounds__(ScanShape<P, N, R>::kThreads, 1)
ssd_chunk_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ s,
                      const float* __restrict__ states,
                      float* __restrict__ y, int B, int L, int H, int G,
                      int chunk, int heads) {
  using S = ScanShape<P, N, R>;
  constexpr int NTH = S::kThreads, PT = S::PT;
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                      // R x N: C rows of the query tile
  float* steps = ct + R * N;             // two step buffers
  float* swap = steps + 2 * S::kStage;   // the C B^T halves
  float* sown = swap + S::kSwap;         // s of the tile's rows, a head each

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int rw = warp % S::W, hl = warp / S::W;
  const int partner = rw + (1 - hl) * S::W;
  const int gq = lane >> 2;
  const int wr0 = 16 * rw, ia = wr0 + gq, ib = ia + 8;
  const int nc = L / chunk, nq = chunk / R, hblocks = H / heads;
  const int per_tile = B * nc * hblocks;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / per_tile;
  int rem = static_cast<int>(blockIdx.x) % per_tile;
  const int h0 = (rem % hblocks) * heads;  // neighbours share B and C rows
  rem /= hblocks;
  const int c = rem % nc, b = rem / nc;
  const int g = h0 / (H / G);
  const int r0 = qt * R;
  const size_t t0 = static_cast<size_t>(b) * L +
                    static_cast<size_t>(c) * chunk;
  const size_t xstride = static_cast<size_t>(H) * P;
  const size_t bstride = static_cast<size_t>(G) * N;
  const float* bg = bm + (t0 * G + g) * N;  // step j at + j G N
  const float* cg = cm + (t0 * G + g) * N;
  auto s_of = [&](int h) {
    return s + (static_cast<size_t>(b) * H + h) * L +
           static_cast<size_t>(c) * chunk;
  };
  auto step_buf = [&](int buf) { return steps + buf * S::kStage; };
  // steps: the state term of each pair of heads, then for each key slab
  // k <= qt each pair's G X (the first pair's step forms C B^T)
  const int pairs = (heads + kLanes - 1) / kLanes;
  const int nsteps = pairs * (qt + 2);

  auto stage = [&](int n, float* st) {
    if (n < pairs) {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const int hh = kLanes * n + l;
        if (hh < heads)
          load_rows<N, NTH>(
              st + l * P * N,
              states + ((static_cast<size_t>(b) * H + h0 + hh) * nc + c) *
                           P * N,
              N, P, tid);
      }
      return;
    }
    const int m = n - pairs, k = m / pairs, p = m % pairs;
    const int j0 = k * R;
    if (p == 0) load_rows<N, NTH>(st, bg + j0 * bstride, bstride, R, tid);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const int hh = kLanes * p + l, h = h0 + hh;
      if (hh < heads) {
        float* hs = st + R * N + l * S::kHead;
        load_rows<P, NTH>(hs, x + ((t0 + j0) * H + h) * P, xstride, R, tid);
        load_vec<NTH>(hs + R * P, s_of(h) + j0, R, tid);
        load_strided<NTH>(hs + R * P + R,
                          dt + (t0 + j0) * H + h, H, R, tid);
      }
    }
  };

  load_rows<N, NTH>(ct, cg + r0 * bstride, bstride, R, tid);
  for (int hh = 0; hh < heads; ++hh)
    load_vec<NTH>(sown + hh * R, s_of(h0 + hh) + r0, R, tid);
  stage(0, step_buf(0));
  cp_async_commit();

  float yacc[kHeadsPerWarp][PT][4] = {};
  float cb[S::RT][4];
  for (int n = 0; n < nsteps; ++n) {
    const int buf = n & 1;
    if (n + 1 < nsteps) {
      stage(n + 1, step_buf(buf ^ 1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step n's rows are in for every thread
    const float* st = step_buf(buf);
    if (n < pairs) {
      const int hh = kLanes * n + hl;
      if (hh < heads) {
        const float es[2] = {expf(sown[hh * R + ia]),
                             expf(sown[hh * R + ib])};
#pragma unroll
        for (int p = 0; p < kHeadsPerWarp; ++p)
          if (p == n)
            state_term<P, N>(yacc[p], ct, st + hl * P * N, wr0, lane, es);
      }
    } else {
      const int m = n - pairs, k = m / pairs, p = m % pairs;
      const bool diag = k == qt;
      if (p == 0)
        form_cb<N, R>(cb, ct, st, swap, warp, partner, hl, wr0, diag, lane);
      const int hh = kLanes * p + hl;
      if (hh < heads) {
        const float* xk = st + R * N + hl * S::kHead;
        const float si[2] = {sown[hh * R + ia], sown[hh * R + ib]};
#pragma unroll
        for (int q = 0; q < kHeadsPerWarp; ++q)
          if (q == p)
            slab_term<P, R>(yacc[q], cb, xk, xk + R * P, xk + R * P + R, si,
                            diag, ia, ib, wr0, lane);
      }
    }
    __syncthreads();  // every read of this buffer is done before its refill
  }
  const int tq = lane & 3;
#pragma unroll
  for (int p = 0; p < kHeadsPerWarp; ++p) {
    const int hh = kLanes * p + hl;
    if (hh < heads) {
      float* out = y + ((t0 + r0 + wr0) * H + h0 + hh) * P;
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        store2(out + gq * xstride + 8 * i + 2 * tq, yacc[p][i][0],
               yacc[p][i][1]);
        store2(out + (gq + 8) * xstride + 8 * i + 2 * tq, yacc[p][i][2],
               yacc[p][i][3]);
      }
    }
  }
}

// -------------------------------------------------------------- launchers --
struct Args {
  const float* x;
  const float* dt;
  const float* a_log;
  const float* b;
  const float* c;
  float* s;
  float* states;
  float* y;
  int B, L, H, G, P, N, chunk, heads;
  cudaStream_t stream;
};

template <int V>
using Int = std::integral_constant<int, V>;

// calls f(Int<P>, Int<N>) for an instantiated (P, N)
template <typename F>
int with_pn(int p, int n, F&& f) {
  auto on_n = [&](auto P) -> int {
    switch (n) {
      case 8: return f(P, Int<8>{});
      case 16: return f(P, Int<16>{});
      case 32: return f(P, Int<32>{});
      case 64: return f(P, Int<64>{});
      case 128: return f(P, Int<128>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  switch (p) {
    case 8: return on_n(Int<8>{});
    case 16: return on_n(Int<16>{});
    case 32: return on_n(Int<32>{});
    case 64: return on_n(Int<64>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int P, int N>
int launch_chunk_state(const Args& a) {
  using S = StateShape<P, N>;
  const size_t smem = sizeof(float) * S::floats(a.chunk);
  auto kernel = ssd_chunk_state_kernel<P, N>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.L / a.chunk, a.H / a.heads, a.B);
  kernel<<<grid, S::kThreads, smem, a.stream>>>(
      a.x, a.dt, a.a_log, a.b, a.s, a.states, a.L, a.H, a.G, a.chunk,
      a.heads);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N, int R>
int launch_chunk_scan(const Args& a) {
  using S = ScanShape<P, N, R>;
  const size_t smem = sizeof(float) * S::kFloats;
  auto kernel = ssd_chunk_scan_kernel<P, N, R>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(a.B) * (a.H / a.heads) *
                           (a.L / a.chunk) * (a.chunk / R);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), S::kThreads, smem, a.stream>>>(
      a.x, a.dt, a.b, a.c, a.s, a.states, a.y, a.B, a.L, a.H, a.G, a.chunk,
      a.heads);
  return static_cast<int>(cudaGetLastError());
}

// the shape rules, and `heads` a divisor of H / G no larger than `most`
bool valid(const Args& a, int most) {
  return a.B > 0 && a.L > 0 && a.H > 0 && a.G > 0 && a.H % a.G == 0 &&
         a.B <= 65535 && a.H <= 65535 && a.chunk >= 16 &&
         a.chunk % 16 == 0 && a.L % a.chunk == 0 && a.heads > 0 &&
         a.heads <= most && (a.H / a.G) % a.heads == 0;
}

}  // namespace

extern "C" {

// float32 only.  The caller guarantees contiguous, 16-byte aligned operands
// on the current device, s (B, H, L) and states (B, H, L / chunk, P, N)
// float32, and a chunk that is 16, 32 or a multiple of 64 and divides L.

// pass 1: s and each chunk's own state contribution S_c, `heads` (1 or 2)
// heads of one group a block
int repro_ssd_chunk_state(const void* x, const void* dt, const void* a_log,
                          const void* b, void* s, void* states, int B, int L,
                          int H, int G, int p, int n, int chunk, int heads,
                          void* stream) {
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(a_log), static_cast<const float*>(b),
               nullptr, static_cast<float*>(s), static_cast<float*>(states),
               nullptr, B, L, H, G, p, n, chunk, heads,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a, kLanes)) return static_cast<int>(cudaErrorInvalidValue);
  return with_pn(p, n, [&](auto P, auto N) {
    return launch_chunk_state<decltype(P)::value, decltype(N)::value>(a);
  });
}

// pass 2: states[c] = S_c becomes h_in[c], the state entering chunk c.
// h0 and h_final, (B, H, P, N) float32, 16-byte aligned, may each be null:
// the carry then starts at 0, and the final state is not written.
int repro_ssd_state_pass(void* states, const void* s, const void* h0,
                         void* h_final, int B, int L, int H, int p, int n,
                         int chunk, void* stream) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr,
               const_cast<float*>(static_cast<const float*>(s)),
               static_cast<float*>(states), nullptr, B, L, H, 1, p, n, chunk,
               1, static_cast<cudaStream_t>(stream)};
  if (!valid(a, 1) || p <= 0 || n <= 0 || (p * n) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pn4 = p * n / 4;
  const dim3 grid((pn4 + kPassThreads - 1) / kPassThreads, H, B);
  ssd_state_pass_kernel<<<grid, kPassThreads, 0, a.stream>>>(
      a.states, a.s, static_cast<const float*>(h0),
      static_cast<float*>(h_final), L, H, chunk, pn4);
  return static_cast<int>(cudaGetLastError());
}

// pass 3: y from h_in and the chunk's key slabs, `heads` (1 to 4) heads of
// one group a block
int repro_ssd_chunk_scan(const void* x, const void* dt, const void* b,
                         const void* c, const void* s, const void* states,
                         void* y, int B, int L, int H, int G, int p, int n,
                         int chunk, int heads, void* stream) {
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               nullptr, static_cast<const float*>(b),
               static_cast<const float*>(c),
               const_cast<float*>(static_cast<const float*>(s)),
               const_cast<float*>(static_cast<const float*>(states)),
               static_cast<float*>(y), B, L, H, G, p, n, chunk, heads,
               static_cast<cudaStream_t>(stream)};
  const int rows = chunk < 64 ? chunk : 64;
  if (!valid(a, kMaxHeads) || chunk % rows)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_pn(p, n, [&](auto P, auto N) -> int {
    constexpr int kP = decltype(P)::value, kN = decltype(N)::value;
    switch (rows) {
      case 16: return launch_chunk_scan<kP, kN, 16>(a);
      case 32: return launch_chunk_scan<kP, kN, 32>(a);
      case 64: return launch_chunk_scan<kP, kN, 64>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
