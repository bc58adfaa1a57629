// The gradient of the Mamba-2 SSD chunked scan for Hopper (sm_90a), float32
// on the tensor cores (3xTF32 mma.sync), hand-written, in four passes,
// deterministic (no atomics).
//
// Replaces: nothing of the TPU's.  The reference has no Pallas body for
// the backward: it differentiates src/repro/models/mamba.py::_ssd_chunked
// in XLA.  This is the port's own gradient of the scan that ssd.cu
// (replacing src/repro/kernels/ssd.py::_ssd_kernel) computes, as
// flash_attention_bwd.cu is of the attention kernel.
//
// The forward, per (b, h) and chunk c of Q steps, a = -exp(a_log[h]),
// s = inclusive cumsum(a dt) within the chunk, H_c = h_in[c] the (P, N)
// state entering it, and for i >= j
//   G_ij = (c_i . b_j) exp(s_i - s_j) dt_j
//   y_i  = sum_j G_ij x_j + exp(s_i) H_c c_i
//   H_{c+1} = exp(s_Q) H_c + S_c,  S_c = sum_j w_j x_j b_j^T,
//   w_j = dt_j exp(s_Q - s_j).
// Given dy and dh_final the passes are:
//  (i)   ssd_bwd_dstate_kernel, one block per (b, h, c): the chunk's
//        D_c = sum_i exp(s_i) dy_i c_i^T, a (P, N) tile over depth Q.
//  (ii)  ssd_bwd_state_pass_kernel, one thread per float4 of a (b, h)'s
//        state: the forward's pass 2 run backwards over the chunks, from
//        g = dh_final (or 0): dS_c = g (written over D_c in place),
//        ds_Q(c) += exp(s_Q) <g, H_c>, g = D_c + exp(s_Q) g; the last g is
//        dh0.  The <g, H_c> sums are reduced within the block in a fixed
//        order and written per (chunk, block), not added atomically.
//        Elementwise: bytes.
//  (iii) ssd_bwd_chunk_kernel, one block per (b, chunk c, R-row tile t,
//        HB consecutive heads of one group), R = min(Q, 64).  With
//        dG_ij = dy_i . x_j, M_ij = dG_ij exp(s_i - s_j) dt_j and
//        E_ij = M_ij (c_i . b_j):
//          dx_j  = sum_i G_ij dy_i + w_j dS_c b_j
//          dc_i  = sum_j M_ij b_j + exp(s_i) H_c^T dy_i
//          db_j  = sum_i M_ij c_i + w_j dS_c^T x_j
//          ddt_j = sum_i dG_ij (c_i . b_j) exp(s_i - s_j)
//                  + exp(s_Q - s_j) u_j,   u_j = x_j^T dS_c b_j
//          ds_i += sum_j E_ij,  ds_j -= sum_i E_ij,
//          ds_i += exp(s_i) dy_i . (H_c c_i),  ds_j -= u_j w_j,
//          ds_Q += sum_j u_j w_j.
//        Tile t owns rows t R .. t R + R - 1 twice: as query rows i it
//        walks the key slabs k <= t (dc_i and the row sums of E), and as
//        key columns j the query slabs k >= t (dx_j, db_j, ddt_j and the
//        column sums), so every block visits nq + 1 (slab, tile) pairs a
//        head whatever its place in the chunk, and every output row is
//        written by one block.
//  (iv)  ssd_bwd_finish_kernel, two roles in one launch.  Blocks 0 .. H-1,
//        one per head: add the ds_Q partials of (ii) and (iii) to the
//        chunk's last step in a fixed order, take r = the reverse
//        cumulative sum of ds within each chunk (block scans of 256 steps
//        from the chunk's end, carried), ddt_t = ddt_t + a r_t and
//        da_log[h] = a sum_{b,t} dt_t r_t (a block sum in a fixed order).
//        The other blocks add each group's H / (G HB) db and dc partials
//        of (iii) in partial order.
//
// s and H_c are the forward's own scratches (kernels/ssd.py keeps them
// from the forward for its backward, 41.9 MB a layer at mamba2-2.7b's
// width and chunk 256), so nothing of the forward is recomputed here.
//
// What bounds it on the H100 (700 W).  At mamba2-2.7b's (1, 4096, 80, 64,
// 1, 128) and chunk 256 the gradient needs 64.6 GFLOP (the five pair
// products C B^T, dY X^T, G^T dY, M B and M^T C over the kept pairs, and
// D_c, dY h_in, X dS and B dS^T) against 0.30 GB read or written once:
// bound by operations on every route -- 0.964 ms on FFMA (67 TFLOP/s, the
// design this replaced), 0.391 ms as three TF32 products each at 495
// TFLOP/s (this file).  Two things sit beside the products: the per-pair
// elementwise work (a decay exponential, E's row and column sums), and,
// in the design this replaced, a per-head db / dc scratch of 2 x 168 MB
// (0.200 ms of HBM time, half the new bound).
//
// What the design does about it.
//  * Every product runs on the tensor cores as 3xTF32 mma.sync m16n8k8:
//    each float32 operand is split a = hi + lo, hi the nearest TF32 and lo
//    = a - hi (of which the tensor core reads the top 19 bits), and hi hi +
//    hi lo + lo hi summed, as in flash_attention_bwd.cu: float32's accuracy
//    at three times TF32's cost, no plain TF32 anywhere.  That covers pass
//    (i)'s D_c, the pair products and the state terms dY h_in, X dS and
//    B dS^T.
//  * Transposed tiles in the key role: a warp computes B_t C_k^T and
//    X_t dY_k^T, whose accumulator rows are its own columns j, so G^T and
//    M^T feed dx and db straight from registers as A fragments (an m16n8
//    accumulator tile is an m16k8 A fragment in a permuted depth order:
//    depth slot t is column 2t, slot t + 4 column 2t + 1; the k-major B
//    operand is read in the same order).  In the query role M feeds dc the
//    same way.  Neither M nor G goes through shared memory.
//  * The decay exp(s_i - s_j) is taken only where i >= j, per accumulator
//    element at the row and column it has in the mma layout: above the
//    diagonal s_i - s_j > 0 grows with the distance and exp overflows, and
//    a 0/1 mask would give inf * 0 = NaN.  Column chunks wholly above the
//    diagonal are skipped.
//  * Tensor-core accumulators truncate.  Every sum into an output (D_c,
//    dc, db, dx) starts a chain from zero over at most a slab's depth
//    (64) and adds it to the float32 sums by FADD (round to nearest); the
//    pair tiles keep the small hi lo and lo hi terms in accumulators of
//    their own, so the chain of hi hi products is a third as long
//    (tests/test_torch_ssd_bwd_tc.py emulates both).
//  * A block takes HB consecutive heads of one group: the largest divisor
//    of H / G up to kMaxHeads = 10 (kernels/ssd.py: ssd_bwd_heads).  At
//    mamba2-2.7b that is 10: 512 blocks at chunk 256, 3.9 waves of one
//    block an SM, and a scratch of 8 partials in place of 80 heads, 0.020
//    ms of HBM time in place of 0.200.  Timed on the H100 at mamba2's
//    width (PERF.md), 10 heads a block ran 1 % faster than 8 at chunk 256
//    and 3 % at chunk 64; 4 and 5 ran 1-2 % slower than 8 (they load the
//    tile's own B and C rows more often and write more partials), 16 11 %
//    slower (2.4 waves of blocks).  A power-of-two head count gets 8.  It
//    runs the query role over its heads, then the key role:
//    the heads share the group's B and C rows, so dc (query role) and db
//    (key role) stay in registers across the heads and are written once a
//    block, to the group's partial (h0 mod H / G) / HB, h0 the block's first
//    head; dx is written per head.
//  * Eight warps at R = 64: four row groups of 16 rows, two warps each,
//    one per half of every slab's columns (the depth of the M B, G^T dY and
//    M^T C products); their dc and db sums are added through shared memory
//    at the end of a role and their dx sums at the end of a head (x + y =
//    y + x: the same bits whichever warp adds).  The state terms split
//    their output columns between the two warps.
//  * Staging: the tile's own C rows (query role) or B rows (key role) stay
//    in shared memory; a head's dY or X rows and its s, dt are
//    double-buffered; slabs (B_k and X_k, or C_k and dY_k, or a head's
//    h_in or dS at its first step) are double-buffered too, cp.async 16
//    bytes a thread, slab n + 1 loading while slab n computes.  Tiles are
//    row-major with the 16-byte chunks of row r at chunk c ^ (r & 7), as in
//    the attention kernels, so that ldmatrix rows and the 4-byte k-major
//    loads fall in distinct bank groups.  A head's dx sums stay in shared
//    memory (each thread its own float4s, read and written once a column
//    chunk), which spares the registers that db and dc take.  205,312
//    bytes at (P, N, R) = (64, 128, 64) (kernels/ssd.py:
//    ssd_bwd_smem_bytes), one block an SM.
//  * Row and column sums (E's, ddt's, u w) reduce over a quad by shuffles
//    and over the two warps and the heads through shared memory, each in
//    one fixed order: two calls give the same bits.
//
// What is left.  The chunk pass holds dc or db (64 registers) beside its
// pair tiles at 255 registers a thread, so an SM runs eight warps, and
// with two a scheduler it waits on the mma and shared-memory latency of
// its split operands: on the H100 it reaches about a tenth of the 3xTF32
// bound (PERF.md).  The way on is wgmma with TMA copies and warp
// specialisation (accumulators of a whole warpgroup, operands read from
// shared memory once split, not by every warp); then bf16 operands (a
// bf16 model casts x, B, C and dy to float32 for this kernel), and
// forming each pair's c . b and dy . x once instead of once in each role.
//
// Instantiations: P in {8, 16, 32, 64}, N in {8, 16, 32, 64, 128} and, for
// (iii), R in {16, 32, 64}.
//
// The launcher allocates nothing (the wrapper allocates every scratch),
// never synchronises, launches the four passes in order on the stream it
// is given, and returns the first cudaGetLastError() that is not 0.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;      // pass (iv)
constexpr int kPassThreads = 128;  // pass (ii)
constexpr int kStateSlab = 32;     // pass (i): steps of a slab
constexpr int kMaxHeads = 10;      // pass (iii): heads of a block

// ---------------------------------------------------------------- copies --

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A row-major tile of rows of W floats, the 16-byte chunk c of row r
// stored at chunk c ^ (r & kMask)
template <int W>
struct Sw {
  static constexpr int kCpr = W / 4;  // chunks per row
  static constexpr int kMask = (kCpr < 8 ? kCpr : 8) - 1;
  __device__ static __forceinline__ int at(int r, int col) {
    return r * W + ((((col >> 2) ^ (r & kMask))) << 2) + (col & 3);
  }
};

// cp.async of `rows` rows of W floats (row r at src + r stride) into a
// swizzled tile, by the NT threads of the block
template <int W, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          size_t stride, int rows, int tid) {
  constexpr int kCpr = W / 4;
  for (int idx = tid; idx < rows * kCpr; idx += NT) {
    const int r = idx / kCpr, c = idx % kCpr;
    cp_async16(dst + r * W + ((c ^ (r & Sw<W>::kMask)) << 2),
               src + r * stride + 4 * c);
  }
}
// n contiguous floats (n a multiple of 4)
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

// ---------------------------------------------------------- tensor cores --

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b, m16n8k8, tf32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a = hi + lo: hi the nearest TF32 (10 mantissa bits, ties away; the
// integer add carries into the exponent as rounding should), lo the exact
// rest, of which the mma reads the top 19 bits
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Fragments.  A is 16 x 8 of the thread's rows g, g + 8 (g = lane / 4),
// depth slots t, t + 4 (t = lane % 4); B is 8 x 8, depth slots t, t + 4 at
// column g; the m16n8 accumulator holds rows g, g + 8 at columns 2t, 2t + 1.
struct TfA { unsigned hi[4], lo[4]; };
struct TfB { unsigned hi[2], lo[2]; };

// An m16n8 tile of a pair product: the small hi lo and lo hi terms run in
// an accumulator of their own, so the chain of hi hi products is a third
// as long.
struct TfTile {
  float c[4], corr[4];
  __device__ __forceinline__ float get(int e) const { return c[e] + corr[e]; }
};

// 3xTF32 into one accumulator: the small terms first
__device__ __forceinline__ void mma(float (&c)[4], const TfA& a,
                                    const TfB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}
__device__ __forceinline__ void mma(TfTile& t, const TfA& a, const TfB& b) {
  mma_tf32(t.corr, a.lo, b.hi);
  mma_tf32(t.corr, a.hi, b.lo);
  mma_tf32(t.c, a.hi, b.hi);
}

// A of rows [row0, row0 + 16) and depth [k0, k0 + 8) of a row-major
// swizzled tile, depth in its natural order (slot t is column k0 + t)
template <int W>
__device__ __forceinline__ void load_a(TfA& a, const float* tile, int row0,
                                       int k0, int lane) {
  unsigned raw[4];
  ldmatrix_x4(raw, tile + Sw<W>::at(row0 + (lane & 15), k0 + (lane >> 4) * 4));
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32(__uint_as_float(raw[e]), a.hi[e], a.lo[e]);
}
// the same A in the permuted depth order (slot t is column k0 + 2t, slot
// t + 4 column k0 + 2t + 1), which load_bt matches
template <int W>
__device__ __forceinline__ void load_a_perm(TfA& a, const float* tile,
                                            int row0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2 v0 = *reinterpret_cast<const float2*>(
      tile + Sw<W>::at(row0 + g, k0 + 2 * t));
  const float2 v1 = *reinterpret_cast<const float2*>(
      tile + Sw<W>::at(row0 + g + 8, k0 + 2 * t));
  split_tf32(v0.x, a.hi[0], a.lo[0]);
  split_tf32(v1.x, a.hi[1], a.lo[1]);
  split_tf32(v0.y, a.hi[2], a.lo[2]);
  split_tf32(v1.y, a.hi[3], a.lo[3]);
}
// A from a tile whose rows are the depth and columns m (k-major), in the
// permuted depth order, depth row k0 + 2t scaled by sc0 and k0 + 2t + 1 by
// sc1; rows m >= mmax are zero
template <int W>
__device__ __forceinline__ void load_a_kmajor(TfA& a, const float* tile,
                                              int k0, int m0, int mmax,
                                              float sc0, float sc1, int lane) {
  const int g = lane >> 2, r = k0 + 2 * (lane & 3);
  const bool low = m0 + g + 8 < mmax;
  split_tf32(sc0 * tile[Sw<W>::at(r, m0 + g)], a.hi[0], a.lo[0]);
  split_tf32(low ? sc0 * tile[Sw<W>::at(r, m0 + g + 8)] : 0.0f, a.hi[1],
             a.lo[1]);
  split_tf32(sc1 * tile[Sw<W>::at(r + 1, m0 + g)], a.hi[2], a.lo[2]);
  split_tf32(low ? sc1 * tile[Sw<W>::at(r + 1, m0 + g + 8)] : 0.0f, a.hi[3],
             a.lo[3]);
}

// B fragments of the JT n-tiles [n0, n0 + 8 JT) at depth [k0, k0 + 8) from
// a tile whose rows are n and whose depth runs along the row (natural
// depth order)
template <int W, int JT>
__device__ __forceinline__ void load_b(TfB (&b)[JT], const float* tile,
                                       int n0, int k0, int lane) {
  static_assert(JT == 1 || JT == 2, "one or two n-tiles");
  if constexpr (JT == 2) {
    unsigned r[4];
    ldmatrix_x4(r, tile + Sw<W>::at(n0 + (lane & 7) + ((lane >> 4) << 3),
                                    k0 + ((lane >> 3) & 1) * 4));
    split_tf32(__uint_as_float(r[0]), b[0].hi[0], b[0].lo[0]);
    split_tf32(__uint_as_float(r[1]), b[0].hi[1], b[0].lo[1]);
    split_tf32(__uint_as_float(r[2]), b[1].hi[0], b[1].lo[0]);
    split_tf32(__uint_as_float(r[3]), b[1].hi[1], b[1].lo[1]);
  } else {
    const int g = lane >> 2, t = lane & 3;
    split_tf32(tile[Sw<W>::at(n0 + g, k0 + t)], b[0].hi[0], b[0].lo[0]);
    split_tf32(tile[Sw<W>::at(n0 + g, k0 + t + 4)], b[0].hi[1], b[0].lo[1]);
  }
}
// B fragments of the JT n-tiles [n0, n0 + 8 JT) at depth [k0, k0 + 8) from
// a tile whose rows are the depth (k-major), in the permuted depth order
template <int W, int JT>
__device__ __forceinline__ void load_bt(TfB (&b)[JT], const float* tile,
                                        int k0, int n0, int lane) {
  const int g = lane >> 2, r = k0 + 2 * (lane & 3);
#pragma unroll
  for (int u = 0; u < JT; ++u) {
    split_tf32(tile[Sw<W>::at(r, n0 + 8 * u + g)], b[u].hi[0], b[u].lo[0]);
    split_tf32(tile[Sw<W>::at(r + 1, n0 + 8 * u + g)], b[u].hi[1],
               b[u].lo[1]);
  }
}

// The A fragment whose depth is the columns of one accumulator tile, in
// the permuted order of load_bt
__device__ __forceinline__ void a_from_acc(TfA& a, const float (&c)[4]) {
  split_tf32(c[0], a.hi[0], a.lo[0]);  // row g,     depth slot t
  split_tf32(c[2], a.hi[1], a.lo[1]);  // row g + 8, slot t
  split_tf32(c[1], a.hi[2], a.lo[2]);  // row g,     slot t + 4
  split_tf32(c[3], a.hi[3], a.lo[3]);  // row g + 8, slot t + 4
}

// acc[n] += A f[u] B over the JT depth steps of a column chunk, B the
// k-major rows [k0, k0 + 8 JT) of `tile` and acc's NT n-tiles its
// columns: one chain from zero per pair of n-tiles, added by FADD
template <int W, int NT, int JT>
__device__ __forceinline__ void add_products(float (&acc)[NT][4],
                                             const TfA (&f)[JT],
                                             const float* tile, int k0,
                                             int lane) {
  constexpr int NP = NT >= 2 ? 2 : 1;
#pragma unroll
  for (int n2 = 0; n2 < NT; n2 += NP) {
    float part[NP][4] = {};
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      TfB b[NP];
      load_bt<W, NP>(b, tile, k0 + 8 * u, 8 * n2, lane);
#pragma unroll
      for (int v = 0; v < NP; ++v) mma(part[v], f[u], b[v]);
    }
#pragma unroll
    for (int v = 0; v < NP; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n2 + v][e] += part[v][e];
  }
}

// The same into sums kept in shared memory, a float4 a lane and n-tile
// (acc[n kWarp] is n-tile n's), read and written once a column chunk
template <int W, int NT, int JT>
__device__ __forceinline__ void add_products(float4* acc, const TfA (&f)[JT],
                                             const float* tile, int k0,
                                             int lane) {
  constexpr int NP = NT >= 2 ? 2 : 1;
#pragma unroll
  for (int n2 = 0; n2 < NT; n2 += NP) {
    float part[NP][4] = {};
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      TfB b[NP];
      load_bt<W, NP>(b, tile, k0 + 8 * u, 8 * n2, lane);
#pragma unroll
      for (int v = 0; v < NP; ++v) mma(part[v], f[u], b[v]);
    }
#pragma unroll
    for (int v = 0; v < NP; ++v) {
      float4 x = acc[(n2 + v) * kWarp];
      x.x += part[v][0];
      x.y += part[v][1];
      x.z += part[v][2];
      x.w += part[v][3];
      acc[(n2 + v) * kWarp] = x;
    }
  }
}

// sum over a quad (the four lanes that share an accumulator row), the
// same bits in each lane
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// sum over the block, the same value in every thread (warp sums added in
// warp order); `red` holds NT / 32 floats
template <int NT>
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red is free
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  float tot = 0.0f;
#pragma unroll
  for (int w = 0; w < NT / kWarp; ++w) tot += red[w];
  return tot;
}

// inclusive prefix sum over the block in thread order; *total is the
// block's sum.  `red` holds kThreads / 32 floats
__device__ float block_scan(float v, float* red, float* total) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  float incl = v;
#pragma unroll
  for (int off = 1; off < kWarp; off *= 2) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  __syncthreads();  // red is free
  if (lane == kWarp - 1) red[warp] = incl;
  __syncthreads();
  float before = 0.0f, tot = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / kWarp; ++w) {
    if (w < warp) before += red[w];
    tot += red[w];
  }
  *total = tot;
  return incl + before;
}

// ------------------------------------------------------------- pass (i) --
// One block per (b, h, c): D_c (P x N) = (exp(s) dY)^T C over the chunk's
// steps, slabs of kStateSlab steps double-buffered.  Warp (rg, cw) owns
// rows [16 rg, 16 rg + 16) of P (rows past P are zero) and the cw-th of CW
// slices of N's n-tiles.
template <int P, int N>
struct DstateShape {
  static constexpr int RG = (P + 15) / 16;
  static constexpr int NT = N / 8;
  static constexpr int CW = NT >= 2 ? 2 : 1;
  static constexpr int NTW = NT / CW;
  static constexpr int kThreads = RG * CW * kWarp;
  static constexpr int kStage = kStateSlab * (P + N + 1);  // dY, C, s
  static constexpr int kFloats = 2 * kStage;
};

template <int P, int N>
__global__ void __launch_bounds__(DstateShape<P, N>::kThreads)
ssd_bwd_dstate_kernel(const float* __restrict__ dy,
                      const float* __restrict__ cm,
                      const float* __restrict__ s,
                      float* __restrict__ dstate, int L, int H, int G,
                      int chunk) {
  using S = DstateShape<P, N>;
  constexpr int NTH = S::kThreads, NTW = S::NTW;
  constexpr int NP = NTW >= 2 ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int rg = warp % S::RG, cw = warp / S::RG;
  const int gq = lane >> 2, tq = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G), nc = L / chunk;
  const size_t t0 = static_cast<size_t>(b) * L +
                    static_cast<size_t>(c) * chunk;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* s_chunk = s + bh * L + static_cast<size_t>(c) * chunk;
  const float* yg = dy + (t0 * H + h) * P;
  const float* cg = cm + (t0 * G + g) * N;
  const size_t ystride = static_cast<size_t>(H) * P;
  const size_t cstride = static_cast<size_t>(G) * N;
  const int rows = chunk < kStateSlab ? chunk : kStateSlab;
  const int nslab = chunk / rows;

  auto stage = [&](int k, int buf) {
    float* st = smem + buf * S::kStage;
    load_rows<P, NTH>(st, yg + static_cast<size_t>(k) * rows * ystride,
                      ystride, rows, tid);
    load_rows<N, NTH>(st + kStateSlab * P,
                      cg + static_cast<size_t>(k) * rows * cstride, cstride,
                      rows, tid);
    load_vec<NTH>(st + kStateSlab * (P + N), s_chunk + k * rows, rows, tid);
  };

  const int m0 = 16 * rg, n0 = cw * NTW * 8;
  float acc[NTW][4] = {};
  stage(0, 0);
  cp_async_commit();
  for (int k = 0; k < nslab; ++k) {
    const int buf = k & 1;
    if (k + 1 < nslab) {
      stage(k + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slab k is in for every thread
    const float* ys = smem + buf * S::kStage;
    const float* cs = ys + kStateSlab * P;
    const float* ss = cs + kStateSlab * N;
    // one chain from zero per slab (at most 32 steps), added by FADD
    float part[NTW][4] = {};
    for (int kk = 0; kk < rows; kk += 8) {
      const int r = kk + 2 * tq;
      TfA a;
      load_a_kmajor<P>(a, ys, kk, m0, P, expf(ss[r]), expf(ss[r + 1]),
                       lane);
#pragma unroll
      for (int u = 0; u < NTW; u += NP) {
        TfB bb[NP];
        load_bt<N, NP>(bb, cs, kk, n0 + 8 * u, lane);
#pragma unroll
        for (int v = 0; v < NP; ++v) mma(part[u + v], a, bb[v]);
      }
    }
#pragma unroll
    for (int u = 0; u < NTW; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] += part[u][e];
    __syncthreads();  // every read of this buffer is done before its refill
  }
  float* out = dstate + (bh * nc + c) * P * N;
#pragma unroll
  for (int u = 0; u < NTW; ++u) {
    const int col = n0 + 8 * u + 2 * tq;
    *reinterpret_cast<float2*>(out + (m0 + gq) * N + col) =
        make_float2(acc[u][0], acc[u][1]);
    if (m0 + gq + 8 < P)
      *reinterpret_cast<float2*>(out + (m0 + gq + 8) * N + col) =
          make_float2(acc[u][2], acc[u][3]);
  }
}

// ------------------------------------------------------------ pass (ii) --
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_pass_kernel(float* __restrict__ dstate,
                          const float* __restrict__ states,
                          const float* __restrict__ s,
                          const float* __restrict__ dh_final,
                          float* __restrict__ dh0,
                          float* __restrict__ dsq_pass, int L, int H,
                          int chunk, int pn4) {
  __shared__ float red[kPassThreads / kWarp];
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  const bool active = e < pn4;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const int nc = L / chunk, nblk = gridDim.x;
  float4* ds4 = reinterpret_cast<float4*>(dstate) + bh * nc * pn4 + e;
  const float4* h4 =
      reinterpret_cast<const float4*>(states) + bh * nc * pn4 + e;
  const float* s_last = s + bh * L + chunk - 1;  // chunk c at + c chunk
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 g = active && dh_final
                 ? reinterpret_cast<const float4*>(dh_final)[bh * pn4 + e]
                 : zero;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t off = static_cast<size_t>(c) * pn4;
    const float4 d = active ? ds4[off] : zero;
    const float4 hc = active ? h4[off] : zero;
    const float eq = expf(s_last[static_cast<size_t>(c) * chunk]);
    if (active) ds4[off] = g;
    const float part =
        eq * (g.x * hc.x + g.y * hc.y + g.z * hc.z + g.w * hc.w);
    const float tot = block_sum<kPassThreads>(part, red);
    if (threadIdx.x == 0)
      dsq_pass[(bh * nc + c) * nblk + blockIdx.x] = tot;
    g = make_float4(fmaf(eq, g.x, d.x), fmaf(eq, g.y, d.y),
                    fmaf(eq, g.z, d.z), fmaf(eq, g.w, d.w));
  }
  if (active && dh0) reinterpret_cast<float4*>(dh0)[bh * pn4 + e] = g;
}

// ----------------------------------------------------------- pass (iii) --
// Shared memory, floats: the tile's own rows of C or B (R x N); two head
// buffers (a head's dY or X rows of the tile, R x P, then its s and dt of
// the tile's steps); two slab buffers (SR x N: B_k or C_k, or a head's h_in
// or dS; R x P: X_k or dY_k; s and dt of the slab's steps); each
// warp's dx sums of a head (2 x R x P: a float4 a lane and n-tile of P, in
// shared memory to spare registers); and the row sums: the query
// role's per head and warp (2 x kMaxHeads x R), the key role's E column
// sums, ddt and u w per warp (3 x 2 x R).
template <int P, int N, int R>
struct ChunkShape {
  static constexpr int W = R / 16;                 // row groups
  static constexpr int kThreads = 2 * W * kWarp;   // two warps a row group
  static constexpr int NT = N / 8, PT = P / 8;     // n-tiles of N and P
  static constexpr int NT0 = (NT + 1) / 2;         // ... warp 0's share
  static constexpr int PT0 = (PT + 1) / 2;
  static constexpr int JT = R >= 32 ? 2 : 1;       // n-tiles of a column chunk
  static constexpr int JC = 8 * JT;
  static constexpr int HALF = R / 2;               // a warp's slab columns
  static constexpr int SR = R > P ? R : P;
  static constexpr int kOwn = R * N;
  static constexpr int kHead = R * P + 2 * R;
  static constexpr int kSlab = SR * N + R * P + 2 * R;
  static constexpr int kDx = 2 * R * P;
  static constexpr int kRows = (2 * kMaxHeads + 6) * R;
  static constexpr int kFloats =
      kOwn + 2 * kHead + 2 * kSlab + kDx + kRows;
};

// The exchange of the two column warps' partial sums: put writes the
// n-tiles the warp does not own to slot rw of `red`, take adds the other
// warp's from there to those it owns (warp 0 owns [0, N0)).  The loops run
// over every tile with a predicate, so the sums stay in registers.
template <int NT, int N0>
__device__ __forceinline__ void put_tiles(float* red, int rw, int cw,
                                          int lane,
                                          const float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if ((n < N0) == (cw == 1))
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((rw * NT + n) * 4 + e) * kWarp + lane] = acc[n][e];
}
// take and store: out row (row0 + g) and (row0 + g + 8), `ld` floats apart
template <int NT, int N0>
__device__ __forceinline__ void take_store(const float* red, int rw, int cw,
                                           int lane, const float (&acc)[NT][4],
                                           float* out, size_t ld) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if ((n < N0) == (cw == 0)) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = acc[n][e] + red[((rw * NT + n) * 4 + e) * kWarp + lane];
      *reinterpret_cast<float2*>(out + g * ld + 8 * n + 2 * t) =
          make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(out + (g + 8) * ld + 8 * n + 2 * t) =
          make_float2(v[2], v[3]);
    }
}

// The query role's state term for the n-tiles [LO, LO + CNT) of N:
// dc += exp(s_i) dY_t h_in over depth P (one chain), and the row terms
// exp(s_i) dy_i . (h_in c_i) into dsr
template <int P, int N, int LO, int CNT>
__device__ __forceinline__ void query_state(float (&dc)[N / 8][4],
                                            float (&dsr)[2], const float* yt,
                                            const float* hin, const float* ct,
                                            int wr0, int lane,
                                            const float (&es)[2]) {
  if constexpr (CNT > 0) {
    constexpr int NP = CNT % 2 == 0 ? 2 : 1;
    float pr[CNT][4] = {};
#pragma unroll
    for (int kd = 0; kd < P; kd += 8) {
      TfA a;
      load_a_perm<P>(a, yt, wr0, kd, lane);
#pragma unroll
      for (int i = 0; i < CNT; i += NP) {
        TfB bb[NP];
        load_bt<N, NP>(bb, hin, kd, 8 * (LO + i), lane);
#pragma unroll
        for (int v = 0; v < NP; ++v) mma(pr[i + v], a, bb[v]);
      }
    }
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < CNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = es[e >> 1] * pr[i][e];
        dc[LO + i][e] += v;
        dsr[e >> 1] = fmaf(v, ct[Sw<N>::at(wr0 + g + (e >> 1) * 8,
                                           8 * (LO + i) + 2 * t + (e & 1))],
                           dsr[e >> 1]);
      }
  }
}

// The key role's state terms: db += w_j X_t dS over depth P for the
// n-tiles [LO, LO + CNT) of N (with u_j's partial x_j . dS b_j into u), and
// dx = w_j B_t dS^T over depth N for the n-tiles [PLO, PLO + PCNT) of P
// (chains of at most 64, added by FADD), which starts the head's dx sums
template <int P, int N, int LO, int CNT, int PLO, int PCNT>
__device__ __forceinline__ void key_state(float (&db)[N / 8][4], float4* dx,
                                          float (&u)[2], const float* xt,
                                          const float* dsm, const float* bt,
                                          int wr0, int lane,
                                          const float (&w)[2]) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (CNT > 0) {
    constexpr int NP = CNT % 2 == 0 ? 2 : 1;
    float pr[CNT][4] = {};
#pragma unroll
    for (int kd = 0; kd < P; kd += 8) {
      TfA a;
      load_a_perm<P>(a, xt, wr0, kd, lane);
#pragma unroll
      for (int i = 0; i < CNT; i += NP) {
        TfB bb[NP];
        load_bt<N, NP>(bb, dsm, kd, 8 * (LO + i), lane);
#pragma unroll
        for (int v = 0; v < NP; ++v) mma(pr[i + v], a, bb[v]);
      }
    }
#pragma unroll
    for (int i = 0; i < CNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        u[e >> 1] = fmaf(pr[i][e],
                         bt[Sw<N>::at(wr0 + g + (e >> 1) * 8,
                                      8 * (LO + i) + 2 * t + (e & 1))],
                         u[e >> 1]);
        db[LO + i][e] += w[e >> 1] * pr[i][e];
      }
  }
  if constexpr (PCNT > 0) {
    constexpr int NP = PCNT % 2 == 0 ? 2 : 1;
    constexpr int KC = N < 64 ? N : 64;
    float pr[PCNT][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += KC) {
      float part[PCNT][4] = {};
#pragma unroll
      for (int kd = k0; kd < k0 + KC; kd += 8) {
        TfA a;
        load_a<N>(a, bt, wr0, kd, lane);
#pragma unroll
        for (int i = 0; i < PCNT; i += NP) {
          TfB bb[NP];
          load_b<N, NP>(bb, dsm, 8 * (PLO + i), kd, lane);
#pragma unroll
          for (int v = 0; v < NP; ++v) mma(part[i + v], a, bb[v]);
        }
      }
#pragma unroll
      for (int i = 0; i < PCNT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pr[i][e] += part[i][e];
    }
#pragma unroll
    for (int i = 0; i < PCNT; ++i)
      dx[(PLO + i) * kWarp] = make_float4(w[0] * pr[i][0], w[0] * pr[i][1],
                                          w[1] * pr[i][2], w[1] * pr[i][3]);
  }
}

// The pair tiles of a column chunk: s1 = A1 B1^T over depth K1 (N) and
// s2 = A2 B2^T over depth K2 (P), A the warp's 16 rows of a row-major
// tile, B the chunk's JC rows [n0, n0 + JC) of a slab
template <int K1, int K2, int JT>
__device__ __forceinline__ void pair_tiles(TfTile (&s1)[JT], TfTile (&s2)[JT],
                                           const float* a1, const float* b1,
                                           const float* a2, const float* b2,
                                           int wr0, int n0, int lane) {
#pragma unroll
  for (int u = 0; u < JT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s1[u].c[e] = s1[u].corr[e] = s2[u].c[e] = s2[u].corr[e] = 0.0f;
#pragma unroll 2
  for (int kd = 0; kd < K1; kd += 8) {
    TfA a;
    load_a<K1>(a, a1, wr0, kd, lane);
    TfB bb[JT];
    load_b<K1, JT>(bb, b1, n0, kd, lane);
#pragma unroll
    for (int u = 0; u < JT; ++u) mma(s1[u], a, bb[u]);
  }
#pragma unroll 2
  for (int kd = 0; kd < K2; kd += 8) {
    TfA a;
    load_a<K2>(a, a2, wr0, kd, lane);
    TfB bb[JT];
    load_b<K2, JT>(bb, b2, n0, kd, lane);
#pragma unroll
    for (int u = 0; u < JT; ++u) mma(s2[u], a, bb[u]);
  }
}

template <int P, int N, int R>
__global__ void __launch_bounds__(ChunkShape<P, N, R>::kThreads, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ dy,
                     const float* __restrict__ s,
                     const float* __restrict__ states,
                     const float* __restrict__ dstate,
                     float* __restrict__ dx, float* __restrict__ db_part,
                     float* __restrict__ dc_part, float* __restrict__ ds,
                     float* __restrict__ ddt_part,
                     float* __restrict__ dsq_scan, int L, int H, int G,
                     int chunk, int heads) {
  using S = ChunkShape<P, N, R>;
  constexpr int NTH = S::kThreads, NT = S::NT, PT = S::PT;
  constexpr int JT = S::JT, JC = S::JC, HALF = S::HALF, SR = S::SR;
  extern __shared__ __align__(16) float smem[];
  float* own = smem;                        // C_t, then B_t
  float* headb = own + S::kOwn;             // two head buffers
  float* slabb = headb + 2 * S::kHead;      // two slab buffers
  // dx sums of a head: warp w's n-tile p of P at (w PT + p) kWarp + lane
  float4* dxs = reinterpret_cast<float4*>(slabb + 2 * S::kSlab);
  float* rowq = slabb + 2 * S::kSlab + S::kDx;  // [2][kMaxHeads][R]
  float* rowk = rowq + 2 * kMaxHeads * R;   // [2][R] each
  float* rowt = rowk + 2 * R;
  float* rowu = rowt + 2 * R;
  auto head_rows = [&](int hh) { return headb + (hh & 1) * S::kHead; };
  auto slab_n = [&](int buf) { return slabb + buf * S::kSlab; };

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int rw = warp % S::W, cw = warp / S::W;
  const int gq = lane >> 2, tq = lane & 3;
  const int wr0 = 16 * rw;                  // the warp's rows in the tile
  const int ia = wr0 + gq, ib = ia + 8;     // the thread's two rows
  const int nc = L / chunk, nq = chunk / R;
  const int t = static_cast<int>(blockIdx.x) % nq;
  const int c = static_cast<int>(blockIdx.x) / nq;
  const int h0 = static_cast<int>(blockIdx.y) * heads, b = blockIdx.z;
  const int rep = H / G, g = h0 / rep;
  const int nparts = rep / heads, part = (h0 % rep) / heads;
  const int r0 = t * R;
  const size_t t0 = static_cast<size_t>(b) * L +
                    static_cast<size_t>(c) * chunk;
  const size_t xstride = static_cast<size_t>(H) * P;
  const size_t bstride = static_cast<size_t>(G) * N;
  const float* bg = bm + (t0 * G + g) * N;  // step j at + j G N
  const float* cg = cm + (t0 * G + g) * N;
  auto rows_of = [&](const float* base, int h) {  // step j at + j H P
    return base + (t0 * H + h) * P;
  };
  auto s_of = [&](int h) {
    return s + (static_cast<size_t>(b) * H + h) * L +
           static_cast<size_t>(c) * chunk;
  };
  auto dt_of = [&](int h) { return dt + t0 * H + h; };  // step j at + j H
  auto state_of = [&](const float* base, int h) {
    return base + ((static_cast<size_t>(b) * H + h) * nc + c) * P * N;
  };
  // a (b, h, l) row of the tile's step r
  auto bhl = [&](int h, int r) {
    return (static_cast<size_t>(b) * H + h) * L +
           static_cast<size_t>(c) * chunk + r0 + r;
  };
  // db / dc partial rows of the tile (row r at + r ld)
  const size_t ld_part = static_cast<size_t>(G) * nparts * N;
  const size_t part_off =
      (t0 + r0) * ld_part + (static_cast<size_t>(g) * nparts + part) * N;

  // --------------------------------------------------- as query rows --
  // Per head: a state step (h_in into the slab buffer, the head's dY rows
  // and s into its head buffer), then the key slabs k <= t (B_k, X_k, s,
  // dt).  dc sums over the heads in registers.
  const int qsteps = t + 2;
  auto stage_q = [&](int n, int buf) {
    const int hh = n / qsteps, q = n % qsteps, h = h0 + hh;
    float* sn = slab_n(buf);
    if (q == 0) {
      float* hr = head_rows(hh);
      load_rows<N, NTH>(sn, state_of(states, h), N, P, tid);
      load_rows<P, NTH>(hr, rows_of(dy, h) + r0 * xstride, xstride, R, tid);
      load_vec<NTH>(hr + R * P, s_of(h) + r0, R, tid);
    } else {
      const int j0 = (q - 1) * R;
      load_rows<N, NTH>(sn, bg + j0 * bstride, bstride, R, tid);
      load_rows<P, NTH>(sn + SR * N, rows_of(x, h) + j0 * xstride, xstride,
                        R, tid);
      load_vec<NTH>(sn + SR * N + R * P, s_of(h) + j0, R, tid);
      load_strided<NTH>(sn + SR * N + R * P + R,
                        dt_of(h) + static_cast<size_t>(j0) * H, H, R, tid);
    }
  };

  float dc_acc[NT][4] = {};
  float ds_row[2] = {0.0f, 0.0f};
  load_rows<N, NTH>(own, cg + r0 * bstride, bstride, R, tid);
  const int nsteps_q = heads * qsteps;
  stage_q(0, 0);
  cp_async_commit();
  for (int n = 0; n < nsteps_q; ++n) {
    const int buf = n & 1;
    if (n + 1 < nsteps_q) {
      stage_q(n + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step n's rows are in for every thread
    const int hh = n / qsteps, q = n % qsteps;
    const float* yt = head_rows(hh);
    const float* st = yt + R * P;
    const float* sn = slab_n(buf);
    if (q == 0) {
      const float es[2] = {expf(st[ia]), expf(st[ib])};
      ds_row[0] = ds_row[1] = 0.0f;
      if (cw == 0)
        query_state<P, N, 0, S::NT0>(dc_acc, ds_row, yt, sn, own, wr0, lane,
                                     es);
      else
        query_state<P, N, S::NT0, NT - S::NT0>(dc_acc, ds_row, yt, sn, own,
                                               wr0, lane, es);
    } else {
      const int k = q - 1;
      const float* xk = sn + SR * N;
      const float* sk = xk + R * P;
      const float* dtk = sk + R;
      const float si[2] = {st[ia], st[ib]};
#pragma unroll 1
      for (int j0 = cw * HALF; j0 < (cw + 1) * HALF; j0 += JC) {
        if (k == t && j0 > wr0 + 15) continue;  // wholly above the diagonal
        float m[JT][4];
        {
          TfTile s1[JT], s2[JT];
          pair_tiles<N, P, JT>(s1, s2, own, sn, yt, xk, wr0, j0, lane);
#pragma unroll
          for (int u = 0; u < JT; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? ia : ib;
              const int j = j0 + 8 * u + 2 * tq + (e & 1);
              const float mv =
                  k < t || j <= i
                      ? s2[u].get(e) * expf(si[e >> 1] - sk[j]) * dtk[j]
                      : 0.0f;
              ds_row[e >> 1] = fmaf(mv, s1[u].get(e), ds_row[e >> 1]);
              m[u][e] = mv;
            }
        }
        TfA mf[JT];
#pragma unroll
        for (int u = 0; u < JT; ++u) a_from_acc(mf[u], m[u]);
        add_products<N, NT, JT>(dc_acc, mf, sn, j0, lane);  // dc += M B_k
      }
      if (q == qsteps - 1) {  // the head's last slab: its row sums
        const float va = quad_sum(ds_row[0]), vb = quad_sum(ds_row[1]);
        if (tq == 0) {
          rowq[(cw * kMaxHeads + hh) * R + ia] = va;
          rowq[(cw * kMaxHeads + hh) * R + ib] = vb;
        }
      }
    }
    __syncthreads();  // every read of this buffer is done before its refill
  }
  // dc of the block's heads: the two column warps' sums added, written to
  // the block's partial
  put_tiles<NT, S::NT0>(slab_n(0), rw, cw, lane, dc_acc);
  __syncthreads();
  take_store<NT, S::NT0>(slab_n(0), rw, cw, lane, dc_acc,
                         dc_part + part_off + wr0 * ld_part, ld_part);
  __syncthreads();  // the exchange is read before the key role's loads

  // ----------------------------------------------------- as key columns --
  // Per head: a state step (dS into the slab buffer, the head's X rows,
  // s and dt into its head buffer), then the query slabs k >= t (C_k, dY_k,
  // s).  db sums over the heads in registers; dx is written per head.
  const int ksteps = nq - t + 1;
  auto stage_k = [&](int n, int buf) {
    const int hh = n / ksteps, q = n % ksteps, h = h0 + hh;
    float* sn = slab_n(buf);
    if (q == 0) {
      float* hr = head_rows(hh);
      load_rows<N, NTH>(sn, state_of(dstate, h), N, P, tid);
      load_rows<P, NTH>(hr, rows_of(x, h) + r0 * xstride, xstride, R, tid);
      load_vec<NTH>(hr + R * P, s_of(h) + r0, R, tid);
      load_strided<NTH>(hr + R * P + R,
                        dt_of(h) + static_cast<size_t>(r0) * H, H, R, tid);
    } else {
      const int i0 = (t + q - 1) * R;
      load_rows<N, NTH>(sn, cg + i0 * bstride, bstride, R, tid);
      load_rows<P, NTH>(sn + SR * N, rows_of(dy, h) + i0 * xstride, xstride,
                        R, tid);
      load_vec<NTH>(sn + SR * N + R * P, s_of(h) + i0, R, tid);
    }
  };

  float db_acc[NT][4] = {};
  float4* my_dx = dxs + warp * PT * kWarp + lane;
  float ds_col[2] = {0.0f, 0.0f}, ddt_col[2] = {0.0f, 0.0f};
  load_rows<N, NTH>(own, bg + r0 * bstride, bstride, R, tid);
  const int nsteps_k = heads * ksteps;
  stage_k(0, 0);
  cp_async_commit();
  const float* s_last = s_of(h0) + chunk - 1;  // per head at + hh L
  for (int n = 0; n < nsteps_k; ++n) {
    const int buf = n & 1;
    if (n + 1 < nsteps_k) {
      stage_k(n + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step n's rows are in for every thread
    const int hh = n / ksteps, q = n % ksteps, h = h0 + hh;
    const float* xt = head_rows(hh);
    const float* st = xt + R * P;
    const float* dtt = st + R;
    const float* sn = slab_n(buf);
    const float sj[2] = {st[ia], st[ib]};
    const float dtj[2] = {dtt[ia], dtt[ib]};
    if (q == 0) {
      const float s_q = s_last[static_cast<size_t>(hh) * L];
      const float eq[2] = {expf(s_q - sj[0]), expf(s_q - sj[1])};
      const float w[2] = {dtj[0] * eq[0], dtj[1] * eq[1]};
      float u[2] = {0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < PT; ++p)
        my_dx[p * kWarp] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (cw == 0)
        key_state<P, N, 0, S::NT0, 0, S::PT0>(db_acc, my_dx, u, xt, sn, own,
                                              wr0, lane, w);
      else
        key_state<P, N, S::NT0, NT - S::NT0, S::PT0, PT - S::PT0>(
            db_acc, my_dx, u, xt, sn, own, wr0, lane, w);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        ds_col[a] = -u[a] * w[a];
        ddt_col[a] = eq[a] * u[a];
      }
      const float ua = quad_sum(u[0] * w[0]), ub = quad_sum(u[1] * w[1]);
      if (tq == 0) {
        rowu[cw * R + ia] = ua;
        rowu[cw * R + ib] = ub;
      }
    } else {
      const int k = t + q - 1;
      const float* yk = sn + SR * N;
      const float* sk = yk + R * P;
#pragma unroll 1
      for (int i0 = cw * HALF; i0 < (cw + 1) * HALF; i0 += JC) {
        if (k == t && i0 + JC - 1 < wr0) continue;  // wholly above it
        float gv[JT][4], mv[JT][4];
        {
          TfTile s1[JT], s2[JT];
          pair_tiles<N, P, JT>(s1, s2, own, sn, xt, yk, wr0, i0, lane);
#pragma unroll
          for (int u = 0; u < JT; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = e < 2 ? ia : ib;
              const int i = i0 + 8 * u + 2 * tq + (e & 1);
              const float l =
                  k > t || i >= j ? expf(sk[i] - sj[e >> 1]) : 0.0f;
              const float a1 = s1[u].get(e), a2 = s2[u].get(e);
              const float cbl = a1 * l;
              gv[u][e] = cbl * dtj[e >> 1];
              mv[u][e] = a2 * l * dtj[e >> 1];
              ddt_col[e >> 1] = fmaf(a2, cbl, ddt_col[e >> 1]);
              ds_col[e >> 1] = fmaf(-mv[u][e], a1, ds_col[e >> 1]);
            }
        }
        {
          TfA mf[JT];
#pragma unroll
          for (int u = 0; u < JT; ++u) a_from_acc(mf[u], mv[u]);
          add_products<N, NT, JT>(db_acc, mf, sn, i0, lane);  // db += M^T C_k
        }
        TfA gf[JT];
#pragma unroll
        for (int u = 0; u < JT; ++u) a_from_acc(gf[u], gv[u]);
        add_products<P, PT, JT>(my_dx, gf, yk, i0, lane);  // dx += G^T dY_k
      }
      if (q == ksteps - 1) {
        // the head's last slab: its column sums, dx, ds, ddt and ds_Q
        const float da = quad_sum(ds_col[0]), dbv = quad_sum(ds_col[1]);
        const float ta = quad_sum(ddt_col[0]), tb = quad_sum(ddt_col[1]);
        if (tq == 0) {
          rowk[cw * R + ia] = da;
          rowk[cw * R + ib] = dbv;
          rowt[cw * R + ia] = ta;
          rowt[cw * R + ib] = tb;
        }
        __syncthreads();  // both column warps' dx sums are in
        {
          const float4* other =
              dxs + (rw + (1 - cw) * S::W) * PT * kWarp + lane;
          float* out = dx + ((t0 + r0 + wr0) * H + h) * P;
#pragma unroll
          for (int p = 0; p < PT; ++p)
            if ((p < S::PT0) == (cw == 0)) {
              const float4 a = my_dx[p * kWarp], o = other[p * kWarp];
              *reinterpret_cast<float2*>(out + gq * xstride + 8 * p +
                                         2 * tq) =
                  make_float2(a.x + o.x, a.y + o.y);
              *reinterpret_cast<float2*>(out + (gq + 8) * xstride + 8 * p +
                                         2 * tq) =
                  make_float2(a.z + o.z, a.w + o.w);
            }
        }
        for (int r = tid; r < R; r += NTH) {
          const float* q0 = rowq + hh * R;
          const float* q1 = rowq + (kMaxHeads + hh) * R;
          ds[bhl(h, r)] = (q0[r] + q1[r]) + (rowk[r] + rowk[R + r]);
          ddt_part[bhl(h, r)] = rowt[r] + rowt[R + r];
        }
        if (tid == 0) {
          float tot = 0.0f;
          for (int r = 0; r < R; ++r) tot += rowu[r] + rowu[R + r];
          dsq_scan[((static_cast<size_t>(b) * H + h) * nc + c) * nq + t] =
              tot;
        }
      }
    }
    __syncthreads();  // every read of this buffer is done before its refill
  }
  put_tiles<NT, S::NT0>(slab_n(0), rw, cw, lane, db_acc);
  __syncthreads();
  take_store<NT, S::NT0>(slab_n(0), rw, cw, lane, db_acc,
                         db_part + part_off + wr0 * ld_part, ld_part);
}

// ------------------------------------------------------------ pass (iv) --
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish_kernel(const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const float* __restrict__ ds,
                      const float* __restrict__ ddt_part,
                      const float* __restrict__ dsq_pass,
                      const float* __restrict__ dsq_scan,
                      const float* __restrict__ db_part,
                      const float* __restrict__ dc_part,
                      float* __restrict__ ddt, float* __restrict__ da_log,
                      float* __restrict__ db, float* __restrict__ dc, int B,
                      int L, int H, int G, int N, int chunk, int nblk,
                      int nq, int nparts) {
  __shared__ float red[kThreads / kWarp];
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= H) {
    // db and dc: a group's partials summed in partial order
    const size_t e = static_cast<size_t>(blockIdx.x - H) * kThreads + tid;
    if (e >= static_cast<size_t>(B) * L * G * N) return;
    const int n = static_cast<int>(e % N);
    const size_t rest = e / N;
    const int g = static_cast<int>(rest % G);
    const size_t bl = rest / G;
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < nparts; ++k) {
      const size_t src =
          (bl * G * nparts + static_cast<size_t>(g) * nparts + k) * N + n;
      sb += db_part[src];
      sc += dc_part[src];
    }
    db[e] = sb;
    dc[e] = sc;
    return;
  }
  // one head: r = reverse cumsum of ds within each chunk
  const int h = blockIdx.x;
  const float a = -expf(a_log[h]);
  const int nc = L / chunk;
  float da = 0.0f;
  for (int b = 0; b < B; ++b) {
    const size_t bh = static_cast<size_t>(b) * H + h;
    for (int c = 0; c < nc; ++c) {
      const size_t base = bh * L + static_cast<size_t>(c) * chunk;
      float extra = 0.0f;
      for (int k = 0; k < nblk; ++k)
        extra += dsq_pass[(bh * nc + c) * nblk + k];
      for (int k = 0; k < nq; ++k) extra += dsq_scan[(bh * nc + c) * nq + k];
      float carry = 0.0f;
      for (int end = chunk; end > 0; end -= kThreads) {
        const int pos = end - 1 - tid;  // thread 0 takes the last step
        float v = 0.0f;
        if (pos >= 0) {
          v = ds[base + pos];
          if (pos == chunk - 1) v += extra;
        }
        float total;
        const float incl = block_scan(v, red, &total);
        if (pos >= 0) {
          const float r = carry + incl;
          const size_t at =
              (static_cast<size_t>(b) * L + static_cast<size_t>(c) * chunk +
               pos) * H + h;
          ddt[at] = fmaf(a, r, ddt_part[base + pos]);
          da = fmaf(dt[at], r, da);
        }
        carry += total;
      }
    }
  }
  const float tot = block_sum<kThreads>(da, red);
  if (tid == 0) da_log[h] = a * tot;
}

// -------------------------------------------------------------- launcher --
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

struct Args {
  const float *x, *dt, *a_log, *b, *c, *dy, *s, *states, *dh_final;
  float *dstate, *dsq_pass, *dsq_scan, *ds, *ddt_part, *db_part, *dc_part;
  float *dx, *ddt, *da_log, *db, *dc, *dh0;
  int B, L, H, G, chunk, heads;
  cudaStream_t stream;
};

template <int P, int N, int R>
int launch_chunk(const Args& a) {
  using S = ChunkShape<P, N, R>;
  const size_t smem = sizeof(float) * S::kFloats;
  auto kernel = ssd_bwd_chunk_kernel<P, N, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.L / a.chunk) * (a.chunk / R);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(static_cast<unsigned>(blocks), a.H / a.heads, a.B),
           S::kThreads, smem, a.stream>>>(
      a.x, a.dt, a.b, a.c, a.dy, a.s, a.states, a.dstate, a.dx, a.db_part,
      a.dc_part, a.ds, a.ddt_part, a.dsq_scan, a.L, a.H, a.G, a.chunk,
      a.heads);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int launch_all(const Args& a) {
  using D = DstateShape<P, N>;
  const int nc = a.L / a.chunk;
  const int rows = a.chunk < 64 ? a.chunk : 64;
  const size_t dsmem = sizeof(float) * D::kFloats;
  auto dstate = ssd_bwd_dstate_kernel<P, N>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      dstate, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dsmem)));
  if (err) return err;
  dstate<<<dim3(nc, a.H, a.B), D::kThreads, dsmem, a.stream>>>(
      a.dy, a.c, a.s, a.dstate, a.L, a.H, a.G, a.chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int pn4 = P * N / 4;
  const int nblk = (pn4 + kPassThreads - 1) / kPassThreads;
  ssd_bwd_state_pass_kernel<<<dim3(nblk, a.H, a.B), kPassThreads, 0,
                              a.stream>>>(a.dstate, a.states, a.s,
                                          a.dh_final, a.dh0, a.dsq_pass,
                                          a.L, a.H, a.chunk, pn4);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  switch (rows) {
    case 16: err = launch_chunk<P, N, 16>(a); break;
    case 32: err = launch_chunk<P, N, 32>(a); break;
    case 64: err = launch_chunk<P, N, 64>(a); break;
    default: err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  const long long groups =
      (static_cast<long long>(a.B) * a.L * a.G * N + kThreads - 1) / kThreads;
  if (groups + a.H > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_finish_kernel<<<static_cast<unsigned>(a.H + groups), kThreads, 0,
                          a.stream>>>(
      a.dt, a.a_log, a.ds, a.ddt_part, a.dsq_pass, a.dsq_scan, a.db_part,
      a.dc_part, a.ddt, a.da_log, a.db, a.dc, a.B, a.L, a.H, a.G, N, a.chunk,
      nblk, a.chunk / rows, a.H / a.G / a.heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// float32 only.  The caller guarantees contiguous, 16-byte aligned
// operands on the current device: x and dy (B, L, H, P), dt (B, L, H),
// a_log (H,), b and c (B, L, G, N), the forward's s (B, H, L) and
// chunk-entry states (B, H, L / chunk, P, N), dh_final (B, H, P, N) or
// null; the scratches dstate (B, H, L / chunk, P, N), dsq_pass (B, H,
// L / chunk, ceil(P N / 512)), dsq_scan (B, H, L / chunk, chunk / R), ds
// and ddt_part (B, H, L), db_part and dc_part (B, L, G H / (G heads), N);
// the outputs dx, ddt, da_log, db, dc of their operands' shapes and dh0
// (B, H, P, N).  The chunk is 16, 32 or a multiple of 64 and divides L;
// `heads` (the heads of a chunk-pass block) divides H / G and is at most
// kMaxHeads.
int repro_ssd_bwd(const void* x, const void* dt, const void* a_log,
                  const void* b, const void* c, const void* dy,
                  const void* s, const void* states, const void* dh_final,
                  void* dstate, void* dsq_pass, void* dsq_scan, void* ds,
                  void* ddt_part, void* db_part, void* dc_part, void* dx,
                  void* ddt, void* da_log, void* db, void* dc, void* dh0,
                  int B, int L, int H, int G, int p, int n, int chunk,
                  int heads, void* stream) {
  auto cf = [](const void* v) { return static_cast<const float*>(v); };
  auto mf = [](void* v) { return static_cast<float*>(v); };
  const Args a{cf(x), cf(dt), cf(a_log), cf(b), cf(c), cf(dy), cf(s),
               cf(states), cf(dh_final), mf(dstate), mf(dsq_pass),
               mf(dsq_scan), mf(ds), mf(ddt_part), mf(db_part), mf(dc_part),
               mf(dx), mf(ddt), mf(da_log), mf(db), mf(dc), mf(dh0), B, L,
               H, G, chunk, heads, static_cast<cudaStream_t>(stream)};
  const int rows = chunk < 64 ? chunk : 64;
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G || B > 65535 ||
      H > 65535 || chunk < 16 || chunk % 16 || L % chunk || chunk % rows ||
      heads <= 0 || heads > kMaxHeads || (H / G) % heads)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_pn(p, n, [&](auto P, auto N) {
    return launch_all<decltype(P)::value, decltype(N)::value>(a);
  });
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
