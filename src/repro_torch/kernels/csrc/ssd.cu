// Mamba-2 SSD chunked scan for Hopper (sm_90a), float32 on the tensor cores
// as 3xTF32, hand-written, in Mamba-2's chunk-parallel three-pass form, by
// two routes: wgmma (route 1) and mma.sync (route 2).
//
// Replaces: src/repro/kernels/ssd.py::_ssd_kernel (src/repro/kernels/
// ssd.py:30), the Pallas TPU kernel that runs the state-space-duality scan
// over a (B, H, L/chunk) grid, carrying a float32 (P, N) state in VMEM
// scratch along the chunk axis.
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
//  1. the chunk state: each head's cumulative log-decay s, written to a
//     float32 scratch (B, H, L) so pass 3 does not scan again, and its own
//     state contribution S_c = (X o w)^T B, a (P, N) tile over depth Q,
//     written to a scratch (B, H, L/Q, P, N); two heads of a group a block,
//     B staged once for both (kernels/ssd.py: ssd_state_heads).
//  2. ssd_state_pass_kernel, one thread per four state elements of a
//     (b, h): walks the chunks in order, writes h_in[c] = h over S_c in
//     place and updates h = exp(s_Q of chunk c) h + S_c.  h starts at the
//     caller's h0 (B, H, P, N) where one is given, else at 0, and the h
//     after the last chunk goes to h_final (B, H, P, N) where one is asked
//     for.  Elementwise, 16-byte loads prefetched one chunk ahead: bound by
//     bytes (it reads and writes the scratch once).  The same on both
//     routes.
//  3. the chunk scan, one block per (b, chunk, 64-row query tile or less,
//     up to four heads of a group, kernels/ssd.py: ssd_scan_heads): y =
//     exp(s) o (C h_in^T) plus, over the key slabs on and below the
//     diagonal, (C B^T o decay o dt^T) X.  The skip rule: query tile t
//     visits only the key slabs 0 .. t (ssd_query_tiles, ssd_key_slabs).
//
// What bounds it on the H100 (700 W).  At mamba2-2.7b's (1, 4096, 80, 64, 1,
// 128) and chunk 256 the function needs 16.3 GFLOP: per head and chunk G X
// over the kept pairs (2 P a pair), C h_in^T and (X o w)^T B (2 Q P N
// each), and C B^T over the kept pairs (2 N a pair) once a (b, group,
// chunk) -- C and B belong to the group.  As three TF32 products at 495
// TFLOP/s that is 0.099 ms; against 0.17 GB read or written once it is
// bound by operations (FFMA at 67 TFLOP/s: 0.243 ms).  By pass: the chunk
// scan's products 0.066 ms; the chunk state's 0.033 ms, but it reads x
// (84 MB) and writes the state scratch (42 MB), 0.038 ms of bytes; the
// state pass and the scratch's other passes over HBM are bytes.
//
// Accuracy, on both routes.  Each float32 operand is split a = hi + lo, hi
// the nearest TF32 (ties away) and lo = a - hi (of which the tensor core
// reads the top 19 bits), and hi hi + hi lo + lo hi summed: a product of
// TF32 parts is exact, and the dropped lo lo term and lo's truncation are
// below float32's rounding of each operand, so the sums meet the float32
// gates (1e-5 normwise against the plain version at mamba2's width, 2e-4
// elementwise against the sequential oracle) where one TF32 product (10
// mantissa bits) misses them by about forty times.  Tensor-core
// accumulators truncate, so every chain into an output is short and starts
// from zero, and is added to the float32 sums by FADD (round to nearest).
// tests/test_torch_ssd_tc.py (route 2) and tests/test_torch_ssd_fwd_wgmma.py
// (route 1) emulate both, truncation included.
//
// The routes, by an explicit table (ssd_route in kernels/ssd.py, route_of
// below; the backward's is the same), neither a fall back for the other; a
// config the table does not route is refused.
//
//  1. wgmma: P = 64, N in {128, 16} and a chunk that is a multiple of 64
//     (mamba2-2.7b's and jamba-v0.1-52b's widths: every model forward of
//     more than 32 steps).  The .tf32 forms of wgmma read shared-memory
//     operands only K-major, so the operands whose depth runs along time
//     (pass 1's B, pass 3's X) are transposed.  TMA brings the raw float32
//     rows into a ring of mbarrier stages; the blocks split each value into
//     hi and lo and write K-major tiles of 128-byte rows with the 128-byte
//     swizzle (units of 64 rows by 32 depth steps), transposed where the
//     product needs it, in the kernel: a pre-pass that split X^T once would
//     write and read 168 MB at mamba2's width, three quarters of the whole
//     bound in bytes.  Two warpgroups a block (256 threads, 255 registers a
//     thread: a producer warp beside them would cut the block to 168 and
//     spill), one block an SM; the copies are issued by whichever warp
//     releases a stage last (a count a stage), so no thread waits for a
//     stage to empty.
//   * Pass 1 (ssd_chunk_state_wgmma_kernel): each warpgroup one head; per
//     32-step unit both split B into a B^T tile (three, so one is split
//     while the last one's products run), and each reads its A fragments
//     (X o w)^T from its head's raw X rows into registers.  s is scanned
//     256 steps at a time from a carry, so the staging does not grow with
//     the chunk.
//   * C B^T (ssd_cb_wgmma_kernel): one warpgroup a (b, group, chunk, query
//     tile, key slab on or below it) forms the 64 x 64 tile over depth N
//     (chains of 64) and writes it in its accumulator's own order, into a
//     scratch (kernels/ssd.py: ssd_cb_floats; 2.6 MB at mamba2's width):
//     once for every head of the group, not once a block.
//   * Pass 3 (ssd_chunk_scan_wgmma_kernel): the query tile's C rows split
//     once into shared memory; each warpgroup takes one head of a pair at
//     a time: its state term C_t h_in^T (h_in split, chains of 64 of depth
//     N, both operands in shared memory), then its key slabs: G formed in
//     registers from the C B^T tile as its accumulator holds it -- off the
//     diagonal as C B^T exp(s_i - m) times exp(m - s_j) dt_j, m the slab's
//     last s (both factors at most 1 where dt >= 0), on it exp(s_i - s_j)
//     dt_j where j <= i -- and turned into the register A fragment of G X
//     (an m64nN accumulator is the A fragment in a permuted depth order,
//     depth slot q of a k8 step holding column 2q and slot q + 4 column
//     2q + 1, in which order X^T is split: kperm), X_k split transposed,
//     then G X a chain over the slab's 64 keys.  G of slab k + 1 is formed
//     while slab k's chain runs.  The query tiles of a (b, chunk, heads)
//     are consecutive blocks, heaviest first, so their reads of the same
//     h_in and X rows meet in L2.
//  2. mma.sync: every other instantiated (P, N), and chunks 16 and 32
//     (serving's short admission passes).  m16n8k8 products, each operand
//     split by the warp that reads it: pass 1 (ssd_chunk_state_kernel) two
//     heads a block over 32-step slabs; pass 3 (ssd_chunk_scan_kernel) R =
//     min(chunk, 64) rows, eight warps (four row groups of 16 rows times
//     two head lanes) at R = 64, C B^T formed once a slab for the block's
//     heads, each half of its key columns by one warp of a row group and
//     swapped through shared memory, then applied per head element by
//     element and converted into the A fragment of G X; double-buffered
//     cp.async staging into row-major tiles whose 16-byte chunks are
//     XOR-swizzled by the row.
//
// What is left.  Route 1's chunk scan runs at about 5.5 times its products'
// bound at mamba2's width (tools/ssd_forward_times.py, PERF.md); without
// its products it still takes two thirds of its time, and without its
// copies, splits or G math a few tenths less each (tools/ssd_pass3_probe.py):
// each warpgroup runs its split, its G and its chain for a head and slab one
// after the other, with one other warpgroup an SM to overlap.  The way on:
// more warpgroups an SM (fewer registers a thread: y of a head, G of one
// slab), the state term and the state pass fused, and bf16 operands.
//
// Instantiations: route 1 at (64, 128) and (64, 16); route 2's pass 1 for
// P in {8, 16, 32, 64} and N in {8, 16, 32, 64, 128}, its pass 3 for those
// and R in {16, 32, 64} (register arrays need compile-time sizes), R = 64
// not at route 1's (P, N); pass 2 is one kernel.
//
// The launchers allocate nothing (the wrapper allocates the scratches),
// never synchronise, launch on the stream they are given, and return
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_tools.cuh"
#include "ssd_tools.cuh"
#include "wgmma_tools.cuh"

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

// the wgmma route's two warpgroups (threads 0 .. 255): named barrier 1
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// the barrier of the threads that run a block scan: the whole block, or
// (kConsumers) the wgmma route's consumers
template <bool kConsumers>
__device__ __forceinline__ void scan_sync() {
  if constexpr (kConsumers) {
    consumers_sync();
  } else {
    __syncthreads();
  }
}

// in-place inclusive prefix sums of the `runs` (1 or 2) arrays v[r n ..
// r n + n) by the NT threads of the block, in one pass: each thread sums a
// run of ceil(n / NT) neighbours of each array, the runs are scanned across
// a warp by shuffles and across the warps through `sums` (kLanes NT / kWarp
// floats); each array's sums in the order a scan of it alone takes; ends
// with a barrier (kConsumers: the wgmma route's consumers, NT = 256, who
// sync by a named barrier).
template <int NT, bool kConsumers = false>
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
  scan_sync<kConsumers>();
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
  scan_sync<kConsumers>();
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    if (r >= runs) break;
    const float before =
        incl[r] - run[r] + (warp > 0 ? sums[r * kWarps + warp - 1] : 0.0f);
    for (int t = lo; t < hi; ++t) v[r * n + t] += before;
  }
  scan_sync<kConsumers>();
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

// ------------------------------------------------------- route 1: wgmma --

// (the route table, route_of, and the split tiles' kWgRows, kUnitBytes,
// panel_at and kperm are ssd_tools.cuh's, shared with the backward)
constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kRawBytes = 16384;  // a raw stage of pass 3's ring
constexpr int kScanSeg = 256;     // pass 1: steps a scan takes

// Shared memory of the two kernels at state size N, bytes from a
// 1024-aligned base.
template <int N>
struct WgShape {
  static constexpr int WC = N < 64 ? N : 64;     // raw floats a row of C, B
  static constexpr int KC = N / WC;              // ... raw units of them
  static constexpr int KUN = (N + 31) / 32;      // depth units of N
  static constexpr int KS = N < 32 ? N / 8 : 4;  // k8 steps of a unit of N
  static constexpr int CU = KUN < 2 ? KUN : 2;   // units of a chain
  static constexpr int NRW = N < 64 ? N : 64;    // rows of a B^T unit
  static constexpr int NB = N / NRW;             // ... its units
  static constexpr int NA = NRW / 2;  // accumulator floats of m64nNRWk8
  // pass 1: a ring of NS1 stages, each the raw B rows (32 x N) and two
  // heads' X rows (32 x 64) of a 32-step unit; three B^T split tiles (N
  // rows x 32 steps); the scan's segment (two heads x kScanSeg), w of two
  // units, the scan's warp totals; the barriers
  static constexpr int NS1 = N > 64 ? 3 : 4;
  static constexpr size_t kStage1 = 128 * N + 2 * 8192;
  static constexpr size_t kBt = static_cast<size_t>(NB) * NRW * 256;
  static constexpr size_t kBt1 = NS1 * kStage1;
  static constexpr size_t kSeg1 = kBt1 + 3 * kBt;
  static constexpr size_t kWin1 = kSeg1 + 4 * 2 * kScanSeg;
  static constexpr size_t kSums1 = kWin1 + 4 * 2 * 2 * 32;
  static constexpr size_t kBar1 = kSums1 + 4 * 2 * 8;
  static constexpr size_t kSmem1 = 1024 + kBar1 + 8 * 2 * NS1;
  // C B^T: the raw C_tq and B_tk rows (64 x N each), both split (KUN units
  // each), the barrier
  static constexpr size_t kRawC = 256 * N;
  static constexpr size_t kCpCb = 2 * kRawC;
  static constexpr size_t kBpCb = kCpCb + static_cast<size_t>(KUN) *
                                              kUnitBytes;
  static constexpr size_t kBarCb = kBpCb + static_cast<size_t>(KUN) *
                                               kUnitBytes;
  static constexpr size_t kSmemCb = 1024 + kBarCb + 8;
  // pass 3: the query tile's C rows split (KUN units), two split slots a
  // warpgroup, a ring of NS3 raw stages of kRawBytes, each warpgroup's s,
  // dt and key factors of two slabs, s of the tile's rows, the barriers
  static constexpr int NS3 = N > 64 ? 5 : 8;
  static constexpr size_t kWb = static_cast<size_t>(KUN) * kUnitBytes;
  static constexpr size_t kRing3 = kWb + 4 * kUnitBytes;
  static constexpr size_t kVec = kRing3 + static_cast<size_t>(NS3) * kRawBytes;
  static constexpr size_t kSq = kVec + 4 * 2 * 6 * kWgRows;
  static constexpr size_t kBar3 = kSq + 4 * kMaxHeads * kWgRows;
  static constexpr size_t kSmem3 = 1024 + kBar3 + 8 * 2 * NS3;
};

__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}
// generic-proxy writes of shared memory made visible to the async proxy
// (the wgmma operand reads); before the barrier that hands them over
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void split4(const float (&v)[4], float4& hi,
                                       float4& lo) {
  unsigned h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], h[e], l[e]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                   __uint_as_float(h[2]), __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
}
// the four values at depth [4 c, 4 c + 4) of row r of a split unit of
// `rows` rows
__device__ __forceinline__ void put4(unsigned char* unit, int rows, int r,
                                     int c, const float (&v)[4]) {
  float4 hi, lo;
  split4(v, hi, lo);
  float* f = reinterpret_cast<float*>(unit);
  const int at = panel_at(r, 4 * c);
  *reinterpret_cast<float4*>(f + at) = hi;
  *reinterpret_cast<float4*>(f + rows * 32 + at) = lo;
}

// The splits: each reads a raw tile that a TMA copy left in shared memory
// (rows densely, no swizzle), splits every value a = hi + lo (split_tf32)
// and writes it into K-major split units, by NT threads from tid.
// 64 rows of W floats (W <= 64) into the depth units of those rows (C,
// B, h_in): depth unit k / 32 of row r at + (k / 32) kUnitBytes
template <int W, int NT>
__device__ __forceinline__ void split_rows(unsigned char* units,
                                           const float* raw, int tid) {
  for (int idx = tid; idx < kWgRows * W / 4; idx += NT) {
    const int r = idx / (W / 4), c = idx % (W / 4);
    const float4 v = reinterpret_cast<const float4*>(raw)[idx];
    put4(units + (c / 8) * kUnitBytes, kWgRows, r, c % 8,
         {v.x, v.y, v.z, v.w});
  }
}
// 64 steps of X (64 rows of 64 floats) transposed into two units of 64
// rows p, depth slot q of unit u holding step 32 u + kperm(q): X_k^T, the
// B operand of G X
template <int NT>
__device__ __forceinline__ void split_xt(unsigned char* units,
                                         const float* raw, int tid) {
  for (int idx = tid; idx < 64 * 16; idx += NT) {
    const int p = idx % 64, c = idx / 64;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = raw[kperm(4 * c + e) * 64 + p];
    put4(units + (c / 8) * kUnitBytes, 64, p, c % 8, v);
  }
}
// 32 steps of B (32 rows of N floats) transposed into NB units of NRW rows
// n, depth slot q holding step q: B^T, the B operand of (X o w)^T B
template <int N, int NT>
__device__ __forceinline__ void split_bt(unsigned char* tile,
                                         const float* raw, int tid) {
  constexpr int NRW = WgShape<N>::NRW;
  for (int idx = tid; idx < N * 8; idx += NT) {
    const int n = idx % N, c = idx / N;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = raw[(4 * c + e) * N + n];
    put4(tile + (n / NRW) * (NRW * 256), NRW, n % NRW, c, v);
  }
}

// The products, each a chain from zero (the caller zeroes d): 3xTF32, the
// small terms (lo hi, hi lo) of every k8 step first and the hi hi terms
// last, so that the chain truncates at full size once a step, not three
// times.
// d += A B^T over NU depth units of KS k8 steps: A the 64-row split units
// at a, B those at b (64 rows each)
template <int NU, int KS>
__device__ __forceinline__ void ss_chain(float (&d)[32],
                                         const unsigned char* a,
                                         const unsigned char* b) {
#pragma unroll
  for (int v = 0; v < NU; ++v)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const unsigned char* av = a + v * kUnitBytes + 32 * kk;
      const unsigned char* bv = b + v * kUnitBytes + 32 * kk;
      wgmma_tf32(d, sdesc(av + kWgRows * 128), sdesc(bv), 1);
      wgmma_tf32(d, sdesc(av), sdesc(bv + kWgRows * 128), 1);
    }
#pragma unroll
  for (int v = 0; v < NU; ++v)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_tf32(d, sdesc(a + v * kUnitBytes + 32 * kk),
                 sdesc(b + v * kUnitBytes + 32 * kk), 1);
}
// d += F B over the 4 NU k8 steps of NU units: F the register fragments
// f[0 .. 4 NU), B the split units of `brows` rows at b
template <int NU, int M>
__device__ __forceinline__ void rs_chain(float (&d)[M],
                                         const TfA (&f)[4 * NU],
                                         const unsigned char* b, int brows) {
#pragma unroll
  for (int kk = 0; kk < 4 * NU; ++kk) {
    const unsigned char* bk = b + (kk / 4) * kUnitBytes + 32 * (kk % 4);
    wgmma_tf32(d, f[kk].lo, sdesc(bk), 1);
    wgmma_tf32(d, f[kk].hi, sdesc(bk + brows * 128), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4 * NU; ++kk)
    wgmma_tf32(d, f[kk].hi, sdesc(b + (kk / 4) * kUnitBytes + 32 * (kk % 4)),
               1);
}

// The rings.  Unit u of a kernel's fixed sequence of copies lands in
// stage u % ns, on that stage's full barrier (one arrival, armed with the
// copy's bytes).  Every warp waits for every unit and releases it in
// order, whether it reads it or not, by adding one to the stage's count;
// the warp whose release completes the eighth (the count 8 (u / ns) + 7
// before its add) issues unit u + ns into the stage.  No thread waits for
// a stage to empty, so no warp is set aside to copy, and the 256 threads
// keep the 255 registers a thread that a block of two warpgroups gets (a
// warp more would cut them to 168).
struct Ring {
  uint64_t* full;
  unsigned* count;
  int ns;
  __device__ void wait(unsigned u) const {
    mbar_wait(full + u % ns, (u / ns) & 1);
  }
  // this warp is done with unit u; true for the one lane that must issue
  // unit u + ns
  __device__ bool release(unsigned u, int lane) const {
    __syncwarp();
    bool last = false;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(count + u % ns, 1u) == 8 * (u / ns) + 7;
      if (last) fence_async();  // the reads before the copy's writes
    }
    return last;
  }
};
// arm stage st of a ring for `bytes` of copies
__device__ __forceinline__ void arm(uint64_t* full, int st, unsigned bytes) {
  mbar_expect_tx(full + st, bytes);
}
// a 3-D TMA load of the box at (c0, c1, c2) into shared memory
__device__ __forceinline__ void copy_3d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1,
                                        int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
// a 1-D bulk copy of `bytes` into shared memory
__device__ __forceinline__ void copy_1d(void* dst, const float* src,
                                        unsigned bytes, uint64_t* bar) {
  bulk_load(dst, src, bytes, bar);
}
__device__ __forceinline__ void init_ring(uint64_t* full, unsigned* count,
                                          int ns) {
  for (int st = 0; st < ns; ++st) {
    mbar_init(full + st, 1);
    count[st] = 0;
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ------------------------------------------------ route 1: pass 1 --
// One block per (b, chunk c, `heads` <= 2 heads of a group), warpgroup wg
// on head wg: S_c = (X o w)^T B over the chunk's 32-step units, M = P =
// 64 rows of p, N columns, depth the steps.  TMA brings each unit's raw B
// rows and the heads' X rows into a ring of NS1 stages.  Per unit all 256
// threads split and transpose B into a B^T tile (three of them, so that
// one is split while the last one's products run), and each warpgroup
// reads its A fragments (X o w)^T from its head's raw X rows into
// registers; a unit's product is a chain from zero added by FADD.
template <int P, int N>
__global__ void __launch_bounds__(kWgThreads, 1)
ssd_chunk_state_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap bmap,
                             const float* __restrict__ dt,
                             const float* __restrict__ a_log,
                             float* __restrict__ s,
                             float* __restrict__ states, int L, int H, int G,
                             int chunk, int heads) {
  using S = WgShape<N>;
  constexpr int NS = S::NS1, NB = S::NB, NRW = S::NRW, NA = S::NA;
  static_assert(P == 64, "route 1 takes P = 64");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* bt = ring + S::kBt1;
  float* seg = reinterpret_cast<float*>(ring + S::kSeg1);
  float* win = reinterpret_cast<float*>(ring + S::kWin1);
  float* sums = reinterpret_cast<float*>(ring + S::kSums1);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kBar1);
  unsigned* count = reinterpret_cast<unsigned*>(full + NS);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int c = blockIdx.x, h0 = blockIdx.y * heads, b = blockIdx.z;
  const int g = h0 / (H / G), nd = chunk / 32;
  const int row0 = b * L + c * chunk;
  // unit d: the B rows and the heads' X rows of steps 32 d .. 32 d + 31
  auto issue = [&](int d) {
    const int st = d % NS;
    unsigned char* stage = ring + st * S::kStage1;
    arm(full, st, 128u * N + 8192u * heads);
    copy_3d(stage, &bmap, full + st, 0, g, row0 + 32 * d);
    for (int hh = 0; hh < heads; ++hh)
      copy_3d(stage + 128 * N + 8192 * hh, &xmap, full + st, 0, h0 + hh,
              row0 + 32 * d);
  };
  if (tid == 0) init_ring(full, count, NS);
  __syncthreads();
  if (tid == 0)
    for (int d = 0; d < NS && d < nd; ++d) issue(d);
  const Ring rc{full, count, NS};
  auto release = [&](int d) {
    if (rc.release(d, lane) && d + NS < nd) issue(d + NS);
  };
  const int wg = warp / 4, gq = lane >> 2, tq = lane & 3;
  const int p0 = 16 * (warp % 4) + gq, p1 = p0 + 8;
  const size_t t0 = static_cast<size_t>(b) * L +
                    static_cast<size_t>(c) * chunk;
  float* s_bh[kLanes];
#pragma unroll
  for (int hh = 0; hh < kLanes; ++hh)
    s_bh[hh] = s + (static_cast<size_t>(b) * H + h0 + hh) * L +
               static_cast<size_t>(c) * chunk;

  // the cumulative log-decays s, scanned kScanSeg steps at a time from the
  // carry, to the scratch (what the chunk scan reads); s_Q the last
  float a[kLanes], carry[kLanes] = {0.0f, 0.0f};
#pragma unroll
  for (int hh = 0; hh < kLanes; ++hh)
    a[hh] = hh < heads ? -expf(a_log[h0 + hh]) : 0.0f;
  for (int t1 = 0; t1 < chunk; t1 += kScanSeg) {
    const int n = min(kScanSeg, chunk - t1);
#pragma unroll
    for (int hh = 0; hh < kLanes; ++hh)
      if (hh < heads && tid < n)
        seg[hh * n + tid] = a[hh] * dt[(t0 + t1 + tid) * H + h0 + hh];
    consumers_sync();
    block_inclusive_scan<256, true>(seg, n, heads, sums);
#pragma unroll
    for (int hh = 0; hh < kLanes; ++hh)
      if (hh < heads) {
        if (tid < n) s_bh[hh][t1 + tid] = seg[hh * n + tid] + carry[hh];
        carry[hh] += seg[hh * n + n - 1];
      }
    consumers_sync();  // every thread has its carry before seg refills
  }
  // w = dt exp(s_Q - s) of unit d's steps into win[d & 1], by 64 threads
  auto stage_w = [&](int d) {
    const int hh = tid / 32, j = 32 * d + tid % 32;
    if (tid < 64 && hh < heads)
      win[(d & 1) * 64 + tid] =
          dt[(t0 + j) * H + h0 + hh] * expf(carry[hh] - s_bh[hh][j]);
  };
  const bool active = wg < heads;
  TfA f[4];
  // A = (X o w)^T of unit d: rows p0, p1, depth slots t, t + 4 of each k8
  // step the steps 8 kk + t, 8 kk + t + 4
  auto load_a = [&](int d) {
    const float* xr = reinterpret_cast<const float*>(
        ring + (d % NS) * S::kStage1 + 128 * N + 8192 * wg);
    const float* wk = win + (d & 1) * 64 + 32 * wg;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j0 = 8 * kk + tq, j1 = j0 + 4;
      split_tf32(xr[j0 * 64 + p0] * wk[j0], f[kk].hi[0], f[kk].lo[0]);
      split_tf32(xr[j0 * 64 + p1] * wk[j0], f[kk].hi[1], f[kk].lo[1]);
      split_tf32(xr[j1 * 64 + p0] * wk[j1], f[kk].hi[2], f[kk].lo[2]);
      split_tf32(xr[j1 * 64 + p1] * wk[j1], f[kk].hi[3], f[kk].lo[3]);
    }
  };
  auto raw_b = [&](int d) {
    return reinterpret_cast<const float*>(ring + (d % NS) * S::kStage1);
  };
  stage_w(0);
  rc.wait(0);
  split_bt<N, 256>(bt, raw_b(0), tid);
  fence_async();
  consumers_sync();  // B^T of unit 0 and its w are in
  load_a(0);
  release(0);
  float sum[NB][NA];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NA; ++i) sum[nb][i] = 0.0f;
  for (int d = 0; d < nd; ++d) {
    // (a warpgroup without a head, heads = 1, runs the products on stale
    // shared memory and stores nothing: no branch around them, which
    // would serialise them)
    float part[NB][NA];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) zero_regs(part[nb]);
    wgmma_fence();
    const unsigned char* tile = bt + (d % 3) * S::kBt;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      rs_chain<1>(part[nb], f, tile + nb * NRW * 256, NRW);
    wgmma_commit();
    if (d + 1 < nd) {
      // the B^T tile of d + 1 (last read by unit d - 2's products, which
      // both warpgroups waited for before the barrier of unit d - 1)
      stage_w(d + 1);
      rc.wait(d + 1);
      split_bt<N, 256>(bt + ((d + 1) % 3) * S::kBt, raw_b(d + 1), tid);
      fence_async();
    }
    consumers_sync();
    wgmma_wait();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(part[nb]);
#pragma unroll
      for (int i = 0; i < NA; ++i) sum[nb][i] += part[nb][i];
    }
    if (d + 1 < nd) {
      load_a(d + 1);
      release(d + 1);
    }
  }
  if (!active) return;
  float* out = states + ((static_cast<size_t>(b) * H + h0 + wg) *
                             (L / chunk) + c) * P * N;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NA / 4; ++i) {
      const int col = NRW * nb + 8 * i + 2 * tq;
      store2(out + p0 * N + col, sum[nb][4 * i], sum[nb][4 * i + 1]);
      store2(out + p1 * N + col, sum[nb][4 * i + 2], sum[nb][4 * i + 3]);
    }
}

// ------------------------------------------------ route 1: C B^T --
// One warpgroup per (b, g, chunk c, pair of a query tile tq and a key slab
// tk <= tq, pair tq (tq + 1) / 2 + tk): C_tq B_tk^T over depth N, both
// rows by TMA and split here, chains of 64 of depth added by FADD, written
// once in the accumulator's own order (the 32 floats of thread t of warp
// w at + 4 (32 (8 w + i) + t) for n-tile i), so that pass 3 reads it back
// as its threads hold it, for every head of the group.  C and B belong to
// the group: this forms once what every head's pass 3 needs.
template <int N>
__global__ void __launch_bounds__(128)
ssd_cb_wgmma_kernel(const __grid_constant__ CUtensorMap bmap,
                    const __grid_constant__ CUtensorMap cmap,
                    float* __restrict__ cb, int L, int G, int chunk) {
  using S = WgShape<N>;
  constexpr int KUN = S::KUN, KS = S::KS, CU = S::CU, WC = S::WC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const float* rawc = reinterpret_cast<const float*>(base);
  const float* rawb = reinterpret_cast<const float*>(base + S::kRawC);
  unsigned char* cp = base + S::kCpCb;
  unsigned char* bp = base + S::kBpCb;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + S::kBarCb);
  const int nq = chunk / kWgRows, nc = L / chunk;
  const int pair = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  const int b = bg / G, g = bg % G;
  int tq = 0;
  while ((tq + 1) * (tq + 2) / 2 <= pair) ++tq;
  const int tk = pair - tq * (tq + 1) / 2;
  const int row0 = b * L + c * chunk;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    arm(bar, 0, 2 * S::kRawC);
    for (int kc = 0; kc < S::KC; ++kc) {
      copy_3d(base + kc * 256 * WC, &cmap, bar, WC * kc, g,
              row0 + kWgRows * tq);
      copy_3d(base + S::kRawC + kc * 256 * WC, &bmap, bar, WC * kc, g,
              row0 + kWgRows * tk);
    }
  }
  mbar_wait(bar, 0);
  for (int kc = 0; kc < S::KC; ++kc) {
    split_rows<WC, 128>(cp + 2 * kc * kUnitBytes, rawc + 64 * WC * kc, tid);
    split_rows<WC, 128>(bp + 2 * kc * kUnitBytes, rawb + 64 * WC * kc, tid);
  }
  fence_async();
  __syncthreads();
  float acc[32], part[32];
  zero_regs(acc);
  zero_regs(part);
  wgmma_fence();
  ss_chain<CU, KS>(acc, cp, bp);
  if constexpr (KUN > CU)
    ss_chain<CU, KS>(part, cp + CU * kUnitBytes, bp + CU * kUnitBytes);
  wgmma_commit();
  wgmma_wait();
  fence_regs(acc);
  fence_regs(part);
  if constexpr (KUN > CU) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }
  float4* out = reinterpret_cast<float4*>(
      cb + ((static_cast<size_t>(bg) * nc + c) * (nq * (nq + 1) / 2) + pair) *
               (kWgRows * kWgRows));
  const int warp = tid / kWarp, lane = tid % kWarp;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    out[(8 * warp + i) * kWarp + lane] =
        make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                    acc[4 * i + 3]);
}

// G_ij = (C B^T)_ij exp(s_i - s_j) dt_j at one accumulator element.  Off
// the diagonal slab: cb exp(s_i - m) times exp(m - s_j) dt_j (vw[128 +
// j]), m the slab's last s, both factors at most 1 where dt >= 0 (the
// models' softplus).  On it: exp(s_i - s_j) dt_j, taken only where j <= i
// (above, s_i - s_j grows with the distance and exp overflows).  Two
// functions, called on either side of one branch a slab, so that no
// exponential runs off the diagonal.
__device__ __forceinline__ float g_off(float cbv, int j, float ri,
                                       const float* vw) {
  return cbv * ri * vw[2 * kWgRows + j];
}
__device__ __forceinline__ float g_diag(float cbv, int i, int j, float si,
                                        const float* vw) {
  return j <= i ? cbv * expf(si - vw[j]) * vw[kWgRows + j] : 0.0f;
}

// ------------------------------------------------ route 1: pass 3 --
// One block per (b, chunk c, 64-row query tile qt, `heads` <= 4 heads of a
// group), the query tiles of a (b, c, heads) consecutive, heaviest first.
// Warpgroup wg takes heads wg
// and wg + 2 of the block, y of both in registers.  TMA streams raw stages
// of up to 16 KB through a ring of NS3 in the order the warpgroups take
// them: the tile's C rows (64 x N), each head's h_in (64 x N), and for
// each key slab k <= qt its C B^T tile (the pre-pass's, one bulk copy),
// then each head's X rows (64 steps x 64).
//  * C_t is split once into KUN units by all 256 threads; each
//    warpgroup's state term exp(s_i) C_t h_in^T splits its head's h_in
//    into its own two slots, 64 of depth at a time, and runs a chain over
//    each 64.
//  * Per slab each warpgroup reads the C B^T tile as its accumulator
//    would hold it: the register A fragment of G X, once G = C B^T o
//    exp(s_i - s_j) o dt_j is made element by element at each element's
//    row and column (exp only where i >= j on the diagonal slab).  Per
//    head it transposes and splits X_k into its two slots (X_k^T, depth
//    slots in kperm order) and runs G X as two chains of 32 keys.
// The warpgroups meet only at the start (C_t); each then runs at its own
// pace, held to the other only by the ring's order.
template <int P, int N>
__global__ void __launch_bounds__(kWgThreads, 1)
ssd_chunk_scan_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap cmap,
                            const __grid_constant__ CUtensorMap hmap,
                            const float* __restrict__ cbs,
                            const float* __restrict__ dt,
                            const float* __restrict__ s,
                            float* __restrict__ y, int B, int L, int H,
                            int G, int chunk, int heads) {
  using S = WgShape<N>;
  constexpr int NS = S::NS3, KS = S::KS, CU = S::CU, WC = S::WC;
  constexpr int KC = S::KC;
  static_assert(P == 64, "route 1 takes P = 64");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* cp = align1024(smem_raw);  // C_t split
  unsigned char* ring = cp + S::kRing3;
  float* sq = reinterpret_cast<float*>(cp + S::kSq);
  uint64_t* full = reinterpret_cast<uint64_t*>(cp + S::kBar3);
  unsigned* count = reinterpret_cast<unsigned*>(full + NS);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int nc = L / chunk, nq = chunk / kWgRows, hblocks = H / heads;
  // the query tiles of a (b, c, heads) innermost, heaviest first, so that
  // their reads of the same h_in and X rows follow each other into L2
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) % nq;
  int rem = static_cast<int>(blockIdx.x) / nq;
  const int h0 = (rem % hblocks) * heads;
  rem /= hblocks;
  const int c = rem % nc, b = rem / nc;
  const int g = h0 / (H / G), r0 = qt * kWgRows;
  const int row0 = b * L + c * chunk;
  const float* cb_tiles =
      cbs + ((static_cast<size_t>(b) * G + g) * nc + c) *
                (nq * (nq + 1) / 2) * (kWgRows * kWgRows);
  // the stages in the order the warpgroups take them: the tile's C rows;
  // then for each pair of heads (2 q, 2 q + 1) of the block, their h_in
  // and, for each key slab k <= qt, its C B^T tile and their X rows
  auto pair_heads = [&](int q) { return min(2, heads - 2 * q); };
  auto pass_units = [&](int q) {
    const int hq = pair_heads(q);
    return hq <= 0 ? 0 : hq * KC + (qt + 1) * (1 + hq);
  };
  const int total = KC + pass_units(0) + pass_units(1);
  const unsigned cbytes = 256u * WC;
  auto issue = [&](int v) {
    const int st = v % NS;
    unsigned char* dst = ring + st * kRawBytes;
    if (v < KC) {
      arm(full, st, cbytes);
      copy_3d(dst, &cmap, full + st, WC * v, g, row0 + r0);
      return;
    }
    v -= KC;
    int q = 0;
    if (v >= pass_units(0)) {
      v -= pass_units(0);
      q = 1;
    }
    const int hq = pair_heads(q);
    if (v < hq * KC) {
      arm(full, st, cbytes);
      copy_3d(dst, &hmap, full + st, WC * (v % KC), 0,
              ((b * H + h0 + 2 * q + v / KC) * nc + c) * P);
      return;
    }
    v -= hq * KC;
    const int k = v / (1 + hq), r = v % (1 + hq);
    if (r == 0) {
      arm(full, st, 4u * kWgRows * kWgRows);
      copy_1d(dst, cb_tiles + (qt * (qt + 1) / 2 + k) * (kWgRows * kWgRows),
              4u * kWgRows * kWgRows, full + st);
      return;
    }
    arm(full, st, 4u * 64 * kWgRows);
    copy_3d(dst, &xmap, full + st, 0, h0 + 2 * q + r - 1, row0 + kWgRows * k);
  };
  if (tid == 0) init_ring(full, count, NS);
  __syncthreads();
  if (tid == 0)
    for (int v = 0; v < NS && v < total; ++v) issue(v);

  const int wg = warp / 4, w4 = warp % 4, wt = tid % 128;
  const int gq = lane >> 2, tq = lane & 3;
  const int i0 = 16 * w4 + gq, i1 = i0 + 8;
  unsigned char* wb = cp + S::kWb + wg * 2 * kUnitBytes;  // my two slots
  // two buffers of a slab's s, dt and exp(m - s) dt
  float* vw = reinterpret_cast<float*>(cp + S::kVec) + wg * 6 * kWgRows;
  const size_t t0 = static_cast<size_t>(b) * L +
                    static_cast<size_t>(c) * chunk;
  auto s_of = [&](int h) {
    return s + (static_cast<size_t>(b) * H + h) * L +
           static_cast<size_t>(c) * chunk;
  };
  const Ring rc{full, count, NS};
  int u = 0;
  auto raw = [&]() {
    rc.wait(u);
    return reinterpret_cast<const float*>(ring + (u % NS) * kRawBytes);
  };
  auto done = [&]() {
    if (rc.release(u, lane) && u + NS < total) issue(u + NS);
    ++u;
  };
  auto skip = [&](int stages) {
    for (int v = 0; v < stages; ++v) {
      rc.wait(u);
      done();
    }
  };

  for (int e = tid; e < heads * kWgRows; e += kWgThreads)
    sq[e] = s_of(h0 + e / kWgRows)[r0 + e % kWgRows];
  for (int kc = 0; kc < KC; ++kc) {
    split_rows<WC, kWgThreads>(cp + 2 * kc * kUnitBytes, raw(), tid);
    done();
  }
  fence_async();
  consumers_sync();  // C_t split and s of the rows are in

  float yacc[32], part[32];
  // wait for the chain in flight and add it to y by FADD
  auto settle = [&]() {
    wgmma_wait();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] += part[i];
  };
  const size_t xstride = static_cast<size_t>(H) * P;
  // Each warpgroup takes one head of a pair at a time (wg of (2 q, 2 q +
  // 1)): its state term, then its key slabs, G of slab k + 1 formed while
  // slab k's chain runs.
  for (int q = 0; q < 2; ++q) {
    const int hq = pair_heads(q);
    if (hq <= 0) break;
    if (wg >= hq) {  // no head in this pair: walk the ring
      skip(hq * KC + (qt + 1) * (1 + hq));
      continue;
    }
    const int hh = 2 * q + wg, h = h0 + hh;
    // the state term: y = exp(s_i) C_t h_in^T, a chain a 64 of depth N
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] = 0.0f;
    for (int w = 0; w < hq; ++w) {
      if (w != wg) {
        skip(KC);
        continue;
      }
      for (int kc = 0; kc < KC; ++kc) {
        split_rows<WC, 128>(wb, raw(), wt);
        done();
        fence_async();
        group_sync(wg);
        zero_regs(part);
        wgmma_fence();
        ss_chain<CU, KS>(part, cp + 2 * kc * kUnitBytes, wb);
        wgmma_commit();
        settle();
        group_sync(wg);  // the slots are free
      }
    }
    const float si[2] = {sq[hh * kWgRows + i0], sq[hh * kWgRows + i1]};
    const float es[2] = {expf(si[0]), expf(si[1])};
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] *= es[(i >> 1) & 1];

    // slab k's s_j and dt_j into buffer k & 1 by cp.async, a step a thread
    // of the first 64
    auto fetch = [&](int k) {
      if (k > qt) return;
      float* vb = vw + (k & 1) * 3 * kWgRows;
      if (wt < kWgRows) {
        cp_async4(vb + wt, s_of(h) + kWgRows * k + wt);
        cp_async4(vb + kWgRows + wt, dt + (t0 + kWgRows * k + wt) * H + h);
      }
      cp_async_commit();
    };
    // slab k's exp(m - s_j) dt_j, m its last s (returned), once its
    // vectors are in; the next slab's fetched; then a barrier
    auto stage = [&](int k) {
      float* vb = vw + (k & 1) * 3 * kWgRows;
      cp_async_wait<0>();
      group_sync(wg);  // slab k's vectors are in
      const float m = vb[kWgRows - 1];
      if (wt < kWgRows)
        vb[2 * kWgRows + wt] = expf(m - vb[wt]) * vb[kWgRows + wt];
      fetch(k + 1);
      group_sync(wg);
      return m;
    };
    // G of slab k in registers from its C B^T tile (the ring stage at t)
    auto form_g = [&](TfA(&f)[8], const float4* t, int k, float m) {
      const float* vb = vw + (k & 1) * 3 * kWgRows;
      float cb[4];
      auto take = [&](int kk) {
        const float4 v = t[(8 * w4 + kk) * kWarp + lane];
        cb[0] = v.x;
        cb[1] = v.y;
        cb[2] = v.z;
        cb[3] = v.w;
      };
      if (k == qt) {
        // the diagonal: keys above this warp's 16 rows 0, the rest
        // directly
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          float gk[1][4];
          if (8 * kk < 16 * w4 + 16) {
            take(kk);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              gk[0][e] = g_diag(cb[e], e < 2 ? i0 : i1,
                                8 * kk + 2 * tq + (e & 1), si[e >> 1], vb);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) gk[0][e] = 0.0f;
          }
          a_from_acc<1>(f[kk], gk, 0);
        }
      } else {
        const float ri[2] = {expf(si[0] - m), expf(si[1] - m)};
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          float gk[1][4];
          take(kk);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            gk[0][e] = g_off(cb[e], 8 * kk + 2 * tq + (e & 1), ri[e >> 1],
                             vb);
          a_from_acc<1>(f[kk], gk, 0);
        }
      }
    };
    // slab k with G in fc: X_k^T split, its chain issued, G of slab k + 1
    // into fn under it, then the chain added to y
    auto slab = [&](int k, TfA(&fc)[8], TfA(&fn)[8]) {
      group_sync(wg);  // every warp's chain k - 1 is done: the slots free
      for (int w = 0; w < hq; ++w) {
        if (w != wg) {
          skip(1);
          continue;
        }
        split_xt<128>(wb, raw(), wt);
        done();
      }
      fence_async();
      group_sync(wg);
      zero_regs(part);
      wgmma_fence();
      rs_chain<2>(part, fc, wb, 64);
      wgmma_commit();
      if (k < qt) {
        const float m = stage(k + 1);
        form_g(fn, reinterpret_cast<const float4*>(raw()), k + 1, m);
        done();
      }
      settle();
    };
    TfA fa[8], fb[8];
    fetch(0);
    {
      const float m = stage(0);
      form_g(fa, reinterpret_cast<const float4*>(raw()), 0, m);
      done();
    }
    for (int k = 0; k <= qt; ++k) {
      if (k & 1)
        slab(k, fb, fa);
      else
        slab(k, fa, fb);
    }
    float* out = y + ((t0 + r0) * H + h) * P;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      store2(out + i0 * xstride + 8 * i + 2 * tq, yacc[4 * i],
             yacc[4 * i + 1]);
      store2(out + i1 * xstride + 8 * i + 2 * tq, yacc[4 * i + 2],
             yacc[4 * i + 3]);
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
  float* cb = nullptr;  // route 1's C B^T tiles (pass 3)
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

// the tensor map of a (steps, heads, width) float32 array read in boxes
// of box0 floats of one head by box2 steps, landing densely (no swizzle)
bool time_map(CUtensorMap* map, const float* ptr, int width, int heads,
              long long steps, int box0, int box2) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(steps)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 4,
                                 static_cast<cuuint64_t>(heads) * width * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0), 1,
                             static_cast<cuuint32_t>(box2)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch_chunk_state_wgmma(const Args& a) {
  using S = WgShape<N>;
  const long long steps = static_cast<long long>(a.B) * a.L;
  CUtensorMap xm, bm;
  if (!time_map(&xm, a.x, 64, a.H, steps, 64, 32) ||
      !time_map(&bm, a.b, N, a.G, steps, N, 32))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_chunk_state_wgmma_kernel<64, N>;
  const cudaError_t err = allow_smem(kernel, S::kSmem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.L / a.chunk, a.H / a.heads, a.B);
  kernel<<<grid, kWgThreads, S::kSmem1, a.stream>>>(
      xm, bm, a.dt, a.a_log, a.s, a.states, a.L, a.H, a.G, a.chunk,
      a.heads);
  return static_cast<int>(cudaGetLastError());
}

// the C B^T tiles of a call, floats (ssd_cb_floats): 64 x 64 for each
// query tile and key slab on or below it, a (b, g, chunk)
long long cb_floats(int B, int L, int G, int chunk) {
  const long long nq = chunk / kWgRows;
  return static_cast<long long>(B) * G * (L / chunk) * (nq * (nq + 1) / 2) *
         kWgRows * kWgRows;
}

template <int N>
int launch_chunk_scan_wgmma(const Args& a) {
  using S = WgShape<N>;
  const long long steps = static_cast<long long>(a.B) * a.L;
  const long long rows = static_cast<long long>(a.B) * a.H *
                         (a.L / a.chunk) * 64;
  CUtensorMap xm, bm, cm, hm;
  if (rows > INT_MAX || a.cb == nullptr ||
      !time_map(&xm, a.x, 64, a.H, steps, 64, kWgRows) ||
      !time_map(&bm, a.b, N, a.G, steps, S::WC, kWgRows) ||
      !time_map(&cm, a.c, N, a.G, steps, S::WC, kWgRows) ||
      !time_map(&hm, a.states, N, 1, rows, S::WC, kWgRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nq = a.chunk / kWgRows;
  auto cb_kernel = ssd_cb_wgmma_kernel<N>;
  cudaError_t err = allow_smem(cb_kernel, S::kSmemCb);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 cb_grid(nq * (nq + 1) / 2, a.L / a.chunk, a.B * a.G);
  cb_kernel<<<cb_grid, 128, S::kSmemCb, a.stream>>>(bm, cm, a.cb, a.L, a.G,
                                                    a.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = ssd_chunk_scan_wgmma_kernel<64, N>;
  err = allow_smem(kernel, S::kSmem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(a.B) * (a.H / a.heads) *
                           (a.L / a.chunk) * nq;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kWgThreads, S::kSmem3, a.stream>>>(
      xm, cm, hm, a.cb, a.dt, a.s, a.y, a.B, a.L, a.H, a.G, a.chunk,
      a.heads);
  return static_cast<int>(cudaGetLastError());
}

// the shape rules, and `heads` a divisor of H / G no larger than `most`
bool valid(const Args& a, int most) {
  return a.B > 0 && a.L > 0 && a.H > 0 && a.G > 0 && a.H % a.G == 0 &&
         a.B <= 65535 && a.H <= 65535 && a.chunk >= 16 &&
         a.chunk % 16 == 0 && a.L % a.chunk == 0 && a.heads > 0 &&
         a.heads <= most && (a.H / a.G) % a.heads == 0 &&
         static_cast<long long>(a.B) * a.L < INT_MAX;
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
  const int route = route_of(p, n, chunk);
  if (!valid(a, kLanes) || route == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1)
    return n == 128 ? launch_chunk_state_wgmma<128>(a)
                    : launch_chunk_state_wgmma<16>(a);
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
// one group a block.  On route 1, cb is a scratch of repro_ssd_cb_floats
// floats for the C B^T tiles, which its pre-pass writes first; route 2
// forms C B^T in the block and ignores it.
int repro_ssd_chunk_scan(const void* x, const void* dt, const void* b,
                         const void* c, const void* s, const void* states,
                         void* cb, void* y, int B, int L, int H, int G, int p,
                         int n, int chunk, int heads, void* stream) {
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               nullptr, static_cast<const float*>(b),
               static_cast<const float*>(c),
               const_cast<float*>(static_cast<const float*>(s)),
               const_cast<float*>(static_cast<const float*>(states)),
               static_cast<float*>(y), B, L, H, G, p, n, chunk, heads,
               static_cast<cudaStream_t>(stream), static_cast<float*>(cb)};
  const int rows = chunk < 64 ? chunk : 64;
  const int route = route_of(p, n, chunk);
  if (!valid(a, kMaxHeads) || chunk % rows || route == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1)
    return n == 128 ? launch_chunk_scan_wgmma<128>(a)
                    : launch_chunk_scan_wgmma<16>(a);
  return with_pn(p, n, [&](auto P, auto N) -> int {
    constexpr int kP = decltype(P)::value, kN = decltype(N)::value;
    switch (rows) {
      case 16: return launch_chunk_scan<kP, kN, 16>(a);
      case 32: return launch_chunk_scan<kP, kN, 32>(a);
      case 64:  // route 1 takes R = 64 at its (P, N): not built here
        if constexpr (wgmma_pn(kP, kN))
          return static_cast<int>(cudaErrorInvalidValue);
        else
          return launch_chunk_scan<kP, kN, 64>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

// floats of route 1's C B^T scratch (ssd_cb_floats); 0 on route 2
long long repro_ssd_cb_floats(int B, int L, int G, int p, int n, int chunk) {
  return route_of(p, n, chunk) == 1 ? cb_floats(B, L, G, chunk) : 0;
}

// the route of (p, n, chunk): 1 wgmma, 2 mma.sync, 0 none (ssd_route)
int repro_ssd_route(int p, int n, int chunk) { return route_of(p, n, chunk); }

// the larger of the two staging passes' shared memory on the route of
// (p, n, chunk), bytes (ssd_smem_bytes); 0 where no route takes it
long long repro_ssd_smem_bytes(int p, int n, int chunk) {
  const int route = route_of(p, n, chunk);
  if (route == 1) {
    auto most = [](auto S) {
      using W = decltype(S);
      size_t m = W::kSmem1 > W::kSmem3 ? W::kSmem1 : W::kSmem3;
      return static_cast<long long>(m > W::kSmemCb ? m : W::kSmemCb);
    };
    return n == 128 ? most(WgShape<128>{}) : most(WgShape<16>{});
  }
  if (route == 0) return 0;
  return with_pn(p, n, [&](auto P, auto N) -> int {
    constexpr int kP = decltype(P)::value, kN = decltype(N)::value;
    const int r = chunk < 64 ? chunk : 64;
    const size_t state = sizeof(float) * StateShape<kP, kN>::floats(chunk);
    const size_t scan =
        sizeof(float) * (r == 16   ? ScanShape<kP, kN, 16>::kFloats
                         : r == 32 ? ScanShape<kP, kN, 32>::kFloats
                                   : ScanShape<kP, kN, 64>::kFloats);
    return static_cast<int>(state > scan ? state : scan);
  });
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
