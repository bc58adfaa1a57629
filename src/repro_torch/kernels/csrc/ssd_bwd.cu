// The gradient of the Mamba-2 SSD chunked scan for Hopper (sm_90a), float32
// on the tensor cores as 3xTF32, hand-written, deterministic (no atomics),
// by two routes: wgmma (route 1) and mma.sync (route 2).
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
// Given dy and dh_final the passes are, on both routes:
//  (i)   D_c = sum_i exp(s_i) dy_i c_i^T, a (P, N) tile a (b, h, c) over
//        depth Q.
//  (ii)  ssd_bwd_state_pass_kernel, one thread per float4 of a (b, h)'s
//        state: the forward's pass 2 run backwards over the chunks, from
//        g = dh_final (or 0): dS_c = g (written over D_c in place),
//        ds_Q(c) += exp(s_Q) <g, H_c>, g = D_c + exp(s_Q) g; the last g is
//        dh0.  The <g, H_c> sums are reduced within the block in a fixed
//        order and written per (chunk, block), not added atomically.
//        Elementwise: bytes.
//  (iii) the chunk pass, one block per (b, chunk c, R-row tile t, HB
//        consecutive heads of one group).  With dG_ij = dy_i . x_j, M_ij =
//        dG_ij exp(s_i - s_j) dt_j and E_ij = M_ij (c_i . b_j):
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
//        column sums), so every output row is written by one block.  The
//        heads of a block share the group's B and C, so dc (query role) and
//        db (key role) are summed over them in registers and written once
//        a block, to the group's partial (h0 mod H / G) / HB; dx per head.
//        HB is the largest divisor of H / G up to kMaxHeads = 10
//        (kernels/ssd.py: ssd_bwd_heads): 10 at mamba2-2.7b, 8 at jamba.
//  (iv)  ssd_bwd_finish_kernel, two roles in one launch.  Blocks 0 .. H-1,
//        one per head: add the ds_Q partials of (ii) and (iii) to the
//        chunk's last step in a fixed order, take r = the reverse
//        cumulative sum of ds within each chunk (block scans of 256 steps
//        from the chunk's end, carried), ddt_t = ddt_t + a r_t and
//        da_log[h] = a sum_{b,t} dt_t r_t (a block sum in a fixed order).
//        The other blocks add each group's partials of db and dc in
//        partial order.
// s and H_c are the forward's own scratches (kernels/ssd.py keeps them
// from the forward for its backward), so nothing of the forward is
// recomputed here.
//
// What bounds it on the H100 (700 W).  At mamba2-2.7b's (1, 4096, 80, 64,
// 1, 128) and chunk 256 the gradient needs 53.9 GFLOP (over the kept
// pairs dY X^T, G^T dY, M B and M^T C a head, C B^T once a group; D_c,
// dY h_in, X dS and B dS^T) against 0.30 GB read or written once: bound
// by operations, 0.327 ms as three TF32 products each at 495 TFLOP/s
// (0.805 ms on FFMA).  Beside the products sit the per-pair elementwise
// work (a decay exponential, E's row and column sums) and the operands'
// hi / lo splits.
//
// The routes, by an explicit table (ssd_bwd_route in kernels/ssd.py,
// route_of below), neither a fall back for the other; a config the table
// does not route is refused.  Both split every float32 operand a = hi +
// lo, hi the nearest TF32 and lo = a - hi (of which the tensor core reads
// the top 19 bits), and sum hi hi + hi lo + lo hi: float32's accuracy at
// three times TF32's cost, no plain TF32 anywhere.  Tensor-core
// accumulators truncate, so every sum into an output starts a chain from
// zero over at most a slab's depth (64) and is added to float32 sums by
// FADD (round to nearest), and the pair tiles keep their small hi lo and
// lo hi terms in accumulators of their own (tests/test_torch_ssd_bwd_tc.py
// and tests/test_torch_ssd_bwd_wgmma.py emulate both routes).  The decay
// exp(s_i - s_j) is taken only where i >= j, per accumulator element at
// its row and column: above the diagonal it overflows, and a 0/1 mask
// would give inf * 0 = NaN.  Row and column sums reduce in one fixed order.
//
//  1. wgmma: P = 64, N in {128, 16} and a chunk that is a multiple of 64
//     (mamba2-2.7b's and jamba-v0.1-52b's widths: every backward the
//     models run).  R = 64.
//   * The split once, not by every warp: ssd_bwd_split_kernel writes x,
//     dy, b, c and h_in, and after (ii) dS, as K-major tiles of their hi
//     and lo parts into a scratch (kernels/ssd.py: ssd_bwd_split_floats;
//     0.78 GB at mamba2's width and chunk 256), in the very bytes a
//     shared-memory stage holds: units of up to 64 rows by 32 depth steps,
//     128-byte rows with the 128-byte swizzle the wgmma descriptors name,
//     hi panel then lo panel, so that a stage is one 1-D bulk copy.  The
//     .tf32 forms of wgmma have no transpose bit, so every B operand is
//     K-major: the pair products' B (B_k, X_k, C_k, dY_k) as stored; the
//     ones that run along time (B_k in M B, C_k in M^T C, dY_k in G^T dY)
//     as time-transposed tiles, h_in and dS transposed where their depth
//     is P, and D_c's C^T.
//   * M and G from registers: the m64nN accumulator of a pair tile is the
//     register A fragment of the next product in a permuted depth order
//     (depth slot q of a k8 step holds the accumulator's column 2q, slot
//     q + 4 column 2q + 1), and the time-transposed tiles are staged in
//     that order (kperm), so M, G^T and M^T never pass through shared
//     memory.
//   * C B^T once: ssd_bwd_cb_kernel forms each chunk's 64 x 64 C_tq B_tk^T
//     for tk <= tq once a (b, group), and its transpose; the chunk pass
//     reads it as one ring unit in both roles and for every head, instead
//     of forming it once a head and role (the chunk pass fell from 2.12 to
//     1.51 ms at mamba2's width, PERF.md).
//   * (i) on wgmma: one block a (b, h, c), A = exp(s) dY^T read from dY^T's
//     split tile into registers (re-split after the scale), B = C^T.
//   * (iii): a consumer warpgroup on the tile's 64 rows and a producer
//     warp.  The producer loads the role's own C_t (then B_t) and each
//     head's dY_t (then X_t) into buffers of their own, and streams every
//     other operand unit by unit (16 KB) by bulk copies through a ring on
//     full and empty mbarriers (6 stages at N = 128, 9 at N = 16).  Per
//     slab the consumer runs the pair tile dY_t X_k^T (X_t dY_k^T) with
//     both operands in shared memory, the pair math on its registers with
//     c . b from the C B^T unit, then dc += M B_k (dx += G^T dY_k, db +=
//     M^T C_k) with A from registers.  dc and db stay in registers across
//     the heads, a head's dx in shared memory (each thread its own
//     elements).  220,288 bytes of shared memory at (64, 128) (kernels/
//     ssd.py: ssd_bwd_smem_bytes), one block an SM; 255 registers, no
//     spills (210 at (64, 16)).
//  2. mma.sync: every other instantiated (P, N), and chunks 16 and 32.
//     m16n8k8 products, each operand split by the warp that loads it; R =
//     min(chunk, 64); eight warps at R = 64: four row groups of 16 rows,
//     two warps each, one per half of every slab's columns, whose dc, db
//     and dx sums are added through shared memory; the pair tiles
//     transposed in the key role so that G^T and M^T feed dx and db from
//     registers; slabs double-buffered by cp.async into row-major tiles
//     whose 16-byte chunks are XOR-swizzled by the row.  (i) in slabs of
//     32 steps.
//
// What is left.  Route 1 runs at about 4.6 times its bound at mamba2's
// width (2.34 ms against 0.327 at chunk 256, PERF.md): its chunk pass is
// bound by the L2 traffic of its split operands (hi and lo, and the
// time-transposed copies: about 110-140 KB a (slab, head) step) with one
// consumer warpgroup an SM, and the split pre-pass moves 0.78 GB.  At
// jamba's N = 16 the per-head x and dy dominate and route 1 is slower
// than route 2 was.  The way on: split the operands in the kernel from
// raw tiles (half the bytes), bf16 operands (a bf16 model casts x, B, C
// and dy to float32 for this kernel), two consumer warpgroups, and the
// reverse state pass fused into the chunk pass.
//
// Instantiations: route 2 at P in {8, 16, 32, 64}, N in {8, 16, 32, 64,
// 128} and R in {16, 32, 64} (R = 64 not at route 1's (P, N)); route 1 at
// (64, 128) and (64, 16).
//
// The launcher allocates nothing (the wrapper allocates every scratch),
// never synchronises, launches the passes in order on the stream it is
// given, and returns the first cudaGetLastError() that is not 0.

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
constexpr int kThreads = 256;      // pass (iv)
constexpr int kPassThreads = 128;  // pass (ii)
constexpr int kStateSlab = 32;     // pass (i): steps of a slab
constexpr int kMaxHeads = 10;      // pass (iii): heads of a block

// ---------------------------------------------------------------- copies --

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
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
// (split_tf32, the TfA / TfB fragments, mma, load_a and the TfTile of a
// pair product are mma_tools.cuh's)

// A of rows [row0, row0 + 16) and depth [k0, k0 + 8) of a row-major
// swizzled tile in the permuted depth order (slot t is column k0 + 2t,
// slot t + 4 column k0 + 2t + 1), which load_bt matches
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

// ------------------------------------------------------ route 2: (i) D_c --
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

// ----------------------------------------------------- route 2: (iii) --
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

// ------------------------------------------------------- route 1: wgmma --

// The route table (ssd_bwd_route in kernels/ssd.py) is ssd_tools.cuh's
// route_of.

// Split tiles.  Route 1 reads every float32 operand of a product from a
// K-major tile of its hi and lo parts (split_tf32), which
// ssd_bwd_split_kernel writes once a call into a scratch in the very bytes
// a shared-memory stage holds, so that a stage is one 1-D bulk copy.  A
// tile is rows x depth, the depth padded with zeros to a multiple of 32,
// stored as units of at most 64 rows by 32 depth steps -- one 128-byte row
// a unit row, the 16-byte chunk c of row r at chunk c ^ (r & 7), the
// 128-byte swizzle a wgmma descriptor names -- the unit's hi panel then its
// lo panel, units in order (depth unit, row block).  A tile whose depth is
// time (B^T, C^T, dY^T: the B operands of M B, M^T C and G^T dY) holds step
// 2q of each 8-step group at depth slot q and step 2q + 1 at slot q + 4:
// the order in which an m64n64 accumulator of M or G^T is the register A
// fragment of the next product (a_from_acc).
constexpr int kWgThreads = 160;  // a consumer warpgroup and a producer warp
constexpr int kSplitThreads = 256;

// the float offset of (r, col) in a 64 x 64 C B^T tile: the 16-byte chunk
// col / 4 of row r at chunk (col / 4) ^ (r & 7), so that the eight rows of
// a warp's pair-math reads fall in distinct banks
__host__ __device__ constexpr int cb_at(int r, int col) {
  return r * 64 + (((col >> 2) ^ (r & 7)) << 2) + (col & 3);
}

template <int P, int N>
struct Wg {
  static constexpr int NP = N < 32 ? 32 : N;  // depth N, padded
  static constexpr int KUN = NP / 32;         // depth units of depth N
  static constexpr int KUP = P / 32;          // ... of depth P
  static constexpr int NR = N < 64 ? N : 64;  // rows of a unit of N rows
  static constexpr int RHN = N / NR;          // row blocks of N rows
  static constexpr int NA = NR / 2;  // accumulator floats of an m64nNR product
  // floats of a tile: x and dy (64 steps x P), b and c (64 steps x N),
  // dy^T (P x 64 steps), b^T and c^T (N x 64 steps), h_in^T and dS^T (N x
  // P), dS (P x N)
  static constexpr int kNatP = KUP * kWgRows * 64;
  static constexpr int kNatN = KUN * kWgRows * 64;
  static constexpr int kTimeP = 2 * kWgRows * 64;
  static constexpr int kTimeN = 2 * RHN * NR * 64;
  static constexpr int kStateT = KUP * RHN * NR * 64;
  static constexpr int kStateN = KUN * kWgRows * 64;
  // ring stages of the chunk pass: what shared memory leaves beside the
  // own tiles (N = 128: 6, N = 16: 9)
  static constexpr int NS = N > 64 ? 6 : 9;
  static constexpr int NSD = 4;  // ... of D_c
  // the chunk pass's shared memory, bytes from a 1024-aligned base: the
  // role's own C_t or B_t, the head's dY_t or X_t, the dx sums of a head
  // (each thread its own), the ring, each stage's s and dt of a slab, the
  // query role's row sums per head, u w per row (two heads), the barriers
  static constexpr size_t kOwnH = static_cast<size_t>(KUN) * kUnitBytes;
  static constexpr size_t kDx = kOwnH + static_cast<size_t>(KUP) * kUnitBytes;
  static constexpr size_t kRing = kDx + 4 * kWgRows * P;
  static constexpr size_t kVec = kRing + static_cast<size_t>(NS) * kUnitBytes;
  static constexpr size_t kRowq = kVec + 4 * NS * 128;
  static constexpr size_t kRowu = kRowq + 4 * kMaxHeads * kWgRows;
  static constexpr size_t kBar = kRowu + 4 * 2 * kWgRows;
  static constexpr size_t kSmem = 1024 + kBar + 8 * (2 * NS + 4);
  // D_c: the ring, each stage's s of a slab, the barriers
  static constexpr size_t kDVec = static_cast<size_t>(NSD) * kUnitBytes;
  static constexpr size_t kDBar = kDVec + 4 * NSD * 128;
  static constexpr size_t kDSmem = 1024 + kDBar + 8 * 2 * NSD;
};

// The split scratch of a call (float offsets): x, dy, dy^T a (b, h, slab),
// b, c, b^T, c^T a (b, g, slab), h_in^T, dS^T, dS a (b, h, chunk), dt as
// (B, H, L), and a (b, g, chunk)'s C B^T tiles: for each query tile tq and
// key slab tk <= tq (pair tq (tq + 1) / 2 + tk) the 64 x 64 tile C_tq
// B_tk^T (cb_at) and its transpose, float32
struct SplitLayout {
  size_t xs, ys, yt, bs, cs, bt, ct, hit, dst, dsn, dtt, cb, total;
};
template <int P, int N>
SplitLayout split_layout(int B, int L, int H, int G, int chunk) {
  using W = Wg<P, N>;
  const size_t per_h = static_cast<size_t>(B) * H * (L / kWgRows);
  const size_t per_g = static_cast<size_t>(B) * G * (L / kWgRows);
  const size_t states = static_cast<size_t>(B) * H * (L / chunk);
  SplitLayout o;
  size_t at = 0;
  auto take = [&](size_t n) {
    const size_t r = at;
    at += n;
    return r;
  };
  o.xs = take(per_h * W::kNatP);
  o.ys = take(per_h * W::kNatP);
  o.yt = take(per_h * W::kTimeP);
  o.bs = take(per_g * W::kNatN);
  o.cs = take(per_g * W::kNatN);
  o.bt = take(per_g * W::kTimeN);
  o.ct = take(per_g * W::kTimeN);
  o.hit = take(states * W::kStateT);
  o.dst = take(states * W::kStateT);
  o.dsn = take(states * W::kStateN);
  o.dtt = take(static_cast<size_t>(B) * H * L);
  const size_t nq = chunk / kWgRows;
  o.cb = take(static_cast<size_t>(B) * G * (L / chunk) * (nq * (nq + 1) / 2) *
              2 * kWgRows * kWgRows);
  o.total = at;
  return o;
}

// One kind of split tile: tile (b, a, c) (a a head or group, c a slab or
// chunk) reads element (row r, depth k) at src + b sb + a sa + c sc + r sr
// + k sk and is written to dst + tile (its units' floats)
struct SplitJob {
  const float* src;
  float* dst;
  long long sb, sa, sc, sr, sk;
  int nb, na, nc, depth, unit_rows, units_k, units_r, perm;
};
constexpr int kMaxJobs = 8;
struct SplitJobs {
  SplitJob job[kMaxJobs];
  long long first[kMaxJobs + 1];  // the first block of each job
  int count;
};

// One block a unit: the source's 32 depth steps of up to 64 rows read
// along its contiguous axis into shared memory, then each value split and
// written as the unit's hi and lo panels, 128-byte rows at a time.
__global__ void __launch_bounds__(kSplitThreads)
ssd_bwd_split_kernel(const __grid_constant__ SplitJobs jobs) {
  __shared__ float buf[kWgRows][33];
  const long long blk = blockIdx.x;
  int j = 0;
  while (j + 1 < jobs.count && blk >= jobs.first[j + 1]) ++j;
  const SplitJob& jb = jobs.job[j];
  const int per_tile = jb.units_k * jb.units_r;
  const long long local = blk - jobs.first[j];
  const long long tile = local / per_tile;
  const int unit = static_cast<int>(local % per_tile);
  const int ku = unit / jb.units_r, rh = unit % jb.units_r;
  const long long cc = tile % jb.nc;
  const long long aa = (tile / jb.nc) % jb.na;
  const long long bb = tile / (static_cast<long long>(jb.nc) * jb.na);
  const int ur = jb.unit_rows, n = ur * 32;
  const float* src = jb.src + bb * jb.sb + aa * jb.sa + cc * jb.sc +
                     static_cast<long long>(rh) * ur * jb.sr;
  for (int idx = threadIdx.x; idx < n; idx += kSplitThreads) {
    int r, k;
    if (jb.sk == 1) {
      r = idx >> 5;
      k = idx & 31;
    } else {
      r = idx % ur;
      k = idx / ur;
    }
    const int kl = 32 * ku + k;
    buf[r][k] = kl < jb.depth ? src[r * jb.sr + kl * jb.sk] : 0.0f;
  }
  __syncthreads();
  float* dst = jb.dst + (tile * per_tile + unit) * (64LL * ur);
  for (int idx = threadIdx.x; idx < n; idx += kSplitThreads) {
    const int r = idx >> 5, q = idx & 31;
    unsigned hi, lo;
    split_tf32(buf[r][jb.perm ? kperm(q) : q], hi, lo);
    const int at = panel_at(r, q);
    dst[at] = __uint_as_float(hi);
    dst[ur * 32 + at] = __uint_as_float(lo);
  }
}

// dt as (B, H, L), so that a slab's dt is one bulk copy
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt_kernel(const float* __restrict__ dt, float* __restrict__ dtt,
                  int L, int H, long long total) {
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long l = e % L, bh = e / L;
    dtt[e] = dt[((bh / H) * L + l) * H + bh % H];
  }
}

// hi + lo of (r, k) in a unit of `rows` rows: the float32 value itself
__device__ __forceinline__ float unit_val(const unsigned char* u, int rows,
                                          int r, int k) {
  const float* f = reinterpret_cast<const float*>(u);
  const int at = panel_at(r, k);
  return f[at] + f[rows * 32 + at];
}
// d += A B^T over the four k8 steps of a unit, 3xTF32 into one
// accumulator (lo hi, hi lo, hi hi): A the 64-row unit at a, B the unit of
// brows rows at b
template <int M>
__device__ __forceinline__ void ss_unit(float (&d)[M], const unsigned char* a,
                                        const unsigned char* b, int brows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t ah = sdesc(a + 32 * kk);
    const uint64_t al = sdesc(a + kWgRows * 128 + 32 * kk);
    const uint64_t bh = sdesc(b + 32 * kk);
    const uint64_t bl = sdesc(b + brows * 128 + 32 * kk);
    wgmma_tf32(d, al, bh, 1);
    wgmma_tf32(d, ah, bl, 1);
    wgmma_tf32(d, ah, bh, 1);
  }
}
// the same for a pair tile: the hi hi products into d, the small terms
// into r, so that the chain of hi hi products is a third as long
__device__ __forceinline__ void ss_unit2(float (&d)[32], float (&r)[32],
                                         const unsigned char* a,
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t ah = sdesc(a + 32 * kk);
    const uint64_t al = sdesc(a + kWgRows * 128 + 32 * kk);
    const uint64_t bh = sdesc(b + 32 * kk);
    const uint64_t bl = sdesc(b + kWgRows * 128 + 32 * kk);
    wgmma_tf32(r, al, bh, 1);
    wgmma_tf32(r, ah, bl, 1);
    wgmma_tf32(d, ah, bh, 1);
  }
}
// d += F B over the four k8 steps of a unit: F the register fragments f[0
// .. 3] (a_from_acc's depth order), B the unit of brows rows at b
template <int M>
__device__ __forceinline__ void rs_unit(float (&d)[M], const TfA* f,
                                        const unsigned char* b, int brows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = sdesc(b + 32 * kk);
    const uint64_t bl = sdesc(b + brows * 128 + 32 * kk);
    wgmma_tf32(d, f[kk].lo, bh, 1);
    wgmma_tf32(d, f[kk].hi, bl, 1);
    wgmma_tf32(d, f[kk].hi, bh, 1);
  }
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The consumer's side of a ring of NS stages: unit u is in stage u % NS.
template <int NS>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ unsigned char* at(unsigned u) const {
    return base + (u % NS) * kUnitBytes;
  }
  __device__ void wait(unsigned u) const {
    mbar_wait(full + u % NS, (u / NS) & 1);
  }
  // this warp is done with unit u (its products are in)
  __device__ void release(unsigned u, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + u % NS);
  }
};

// The producer's side: one thread puts unit after unit into the ring by
// bulk copies, waiting for a stage to be released, the stage's vectors
// (a slab's s and dt, 64 floats each, at vec + 128 stage) beside the
// unit's first
template <int NS>
struct Feed {
  unsigned char* base;
  float* vec;
  uint64_t* full;
  uint64_t* empty;
  unsigned u = 0;
  __device__ void put(const float* src, unsigned bytes,
                      const float* v0 = nullptr, const float* v1 = nullptr) {
    const int st = u % NS;
    mbar_wait(empty + st, ((u / NS) & 1) ^ 1);  // the first round passes
    mbar_expect_tx(full + st, bytes + (v0 ? 256u : 0u) + (v1 ? 256u : 0u));
    bulk_load(base + st * kUnitBytes, src, bytes, full + st);
    if (v0) bulk_load(vec + 128 * st, v0, 256, full + st);
    if (v1) bulk_load(vec + 128 * st + 64, v1, 256, full + st);
    ++u;
  }
};

__device__ __forceinline__ void own_load(unsigned char* dst, const float* src,
                                         unsigned bytes, uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  bulk_load(dst, src, bytes, bar);
}

// --------------------------------------------------- route 1: C B^T --
// One warpgroup per (b, g, chunk c, pair of a query tile tq and a key slab
// tk <= tq): C_tq B_tk^T over depth N by wgmma (both split tiles by one
// bulk copy each, hi hi and the small terms in accumulators of their own),
// written once with its transpose.  C and B belong to the group, so the
// chunk pass reads this tile for every head and in both roles instead of
// forming it once a head and role.
template <int P, int N>
__global__ void __launch_bounds__(128)
ssd_bwd_cb_kernel(const float* __restrict__ bs, const float* __restrict__ cs,
                  float* __restrict__ cb, int L, int chunk) {
  using W = Wg<P, N>;
  constexpr int KUN = W::KUN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sc = align1024(smem_raw);
  unsigned char* sb = sc + KUN * kUnitBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sb + KUN * kUnitBytes);
  const int nq = chunk / kWgRows, nslab = L / kWgRows;
  const int pair = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  int tq = 0;
  while ((tq + 1) * (tq + 2) / 2 <= pair) ++tq;
  const int tk = pair - tq * (tq + 1) / 2;
  const size_t slab0 = static_cast<size_t>(bg) * nslab +
                       static_cast<size_t>(c) * nq;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 2 * KUN * kUnitBytes);
    bulk_load(sc, cs + (slab0 + tq) * W::kNatN, KUN * kUnitBytes, bar);
    bulk_load(sb, bs + (slab0 + tk) * W::kNatN, KUN * kUnitBytes, bar);
  }
  mbar_wait(bar, 0);
  float s1[8][4], s1r[8][4];
  auto& f1 = reinterpret_cast<float(&)[32]>(s1);
  auto& f1r = reinterpret_cast<float(&)[32]>(s1r);
  zero_regs(f1);
  zero_regs(f1r);
  wgmma_fence();
#pragma unroll
  for (int ku = 0; ku < KUN; ++ku)
    ss_unit2(f1, f1r, sc + ku * kUnitBytes, sb + ku * kUnitBytes);
  wgmma_commit();
  wgmma_wait();
  fence_regs(f1);
  fence_regs(f1r);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = 16 * warp + (lane >> 2), tq4 = lane & 3;
  float* out = cb + ((static_cast<size_t>(bg) * (L / chunk) + c) *
                         (nq * (nq + 1) / 2) +
                     pair) *
                        (2 * kWgRows * kWgRows);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 8 * (e >> 1), j = 8 * nb + 2 * tq4 + (e & 1);
      const float v = s1[nb][e] + s1r[nb][e];
      out[cb_at(i, j)] = v;
      out[kWgRows * kWgRows + cb_at(j, i)] = v;
    }
}

// ------------------------------------------------------ route 1: (i) D_c --
// One block per (b, h, c): D_c (P x N) = sum over the chunk's 64-step
// slabs of (exp(s) dY)^T C, a chain from zero a slab added by FADD.  The
// producer streams dY^T's two units and C^T's units of a slab, and the
// slab's s; the consumer reads exp(s_i) dy_i for its A fragments from
// dY^T (in C^T's depth order) and runs wgmma with A from registers.
template <int P, int N>
__global__ void __launch_bounds__(kWgThreads)
ssd_bwd_dstate_wgmma_kernel(const float* __restrict__ yt,
                            const float* __restrict__ ct,
                            const float* __restrict__ s,
                            float* __restrict__ dstate, int L, int H, int G,
                            int chunk) {
  using W = Wg<P, N>;
  constexpr int NS = W::NSD, NR = W::NR, RHN = W::RHN, NA = W::NA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* vec = reinterpret_cast<float*>(ring + W::kDVec);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + W::kDBar);
  uint64_t* empty = full + NS;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G), nq = chunk / kWgRows, nslab = L / kWgRows;
  const size_t bh = static_cast<size_t>(b) * H + h;
  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      Feed<NS> feed{ring, vec, full, empty};
      for (int q = 0; q < nq; ++q) {
        const size_t slab = static_cast<size_t>(c) * nq + q;
        const float* ytile = yt + (bh * nslab + slab) * W::kTimeP;
        const float* ctile =
            ct + ((static_cast<size_t>(b) * G + g) * nslab + slab) *
                     W::kTimeN;
        // s at vec + 128 stage (the second vector is unused here)
        feed.put(ytile, kUnitBytes, s + bh * L + slab * kWgRows);
        feed.put(ytile + kWgRows * 64, kUnitBytes);
        for (int i = 0; i < 2 * RHN; ++i)
          feed.put(ctile + i * NR * 64, NR * 256);
      }
    }
    return;
  }
  const Ring<NS> ringc{ring, full, empty};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int p0 = 16 * warp + gq, p1 = p0 + 8;
  float sum[RHN][NA];
#pragma unroll
  for (int rh = 0; rh < RHN; ++rh)
#pragma unroll
    for (int i = 0; i < NA; ++i) sum[rh][i] = 0.0f;
  unsigned u = 0;
  for (int q = 0; q < nq; ++q) {
    ringc.wait(u);
    ringc.wait(u + 1);
    const float* sv = vec + 128 * (u % NS);
    TfA f[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const unsigned char* yu = ringc.at(u + (kk >> 2));
      const int k0 = 8 * (kk & 3) + tq, k1 = k0 + 4;
      const int step = 32 * (kk >> 2) + 8 * (kk & 3) + 2 * tq;
      const float e0 = expf(sv[step]), e1 = expf(sv[step + 1]);
      split_tf32(e0 * unit_val(yu, kWgRows, p0, k0), f[kk].hi[0],
                 f[kk].lo[0]);
      split_tf32(e0 * unit_val(yu, kWgRows, p1, k0), f[kk].hi[1],
                 f[kk].lo[1]);
      split_tf32(e1 * unit_val(yu, kWgRows, p0, k1), f[kk].hi[2],
                 f[kk].lo[2]);
      split_tf32(e1 * unit_val(yu, kWgRows, p1, k1), f[kk].hi[3],
                 f[kk].lo[3]);
    }
    ringc.release(u, lane);
    ringc.release(u + 1, lane);
    const unsigned uc = u + 2;
    for (int i = 0; i < 2 * RHN; ++i) ringc.wait(uc + i);
    float acc[RHN][NA];
#pragma unroll
    for (int rh = 0; rh < RHN; ++rh) zero_regs(acc[rh]);
    wgmma_fence();
#pragma unroll
    for (int ku = 0; ku < 2; ++ku)
#pragma unroll
      for (int rh = 0; rh < RHN; ++rh)
        rs_unit(acc[rh], f + 4 * ku, ringc.at(uc + ku * RHN + rh), NR);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int rh = 0; rh < RHN; ++rh) fence_regs(acc[rh]);
    for (int i = 0; i < 2 * RHN; ++i) ringc.release(uc + i, lane);
    u = uc + 2 * RHN;
#pragma unroll
    for (int rh = 0; rh < RHN; ++rh)
#pragma unroll
      for (int i = 0; i < NA; ++i) sum[rh][i] += acc[rh][i];
  }
  float* out = dstate + (bh * (L / chunk) + c) * P * N;
#pragma unroll
  for (int rh = 0; rh < RHN; ++rh)
#pragma unroll
    for (int nb = 0; nb < NR / 8; ++nb) {
      const int col = 64 * rh + 8 * nb + 2 * tq;
      *reinterpret_cast<float2*>(out + p0 * N + col) =
          make_float2(sum[rh][4 * nb], sum[rh][4 * nb + 1]);
      *reinterpret_cast<float2*>(out + p1 * N + col) =
          make_float2(sum[rh][4 * nb + 2], sum[rh][4 * nb + 3]);
    }
}

// ---------------------------------------------------- route 1: (iii) --
struct WgArgs {
  const float *xs, *ys, *yt, *bs, *cs, *bt, *ct, *hit, *dst, *dsn, *dtt, *cb;
  const float *s, *dt;
  float *dx, *db_part, *dc_part, *ds, *ddt_part, *dsq_scan;
  int L, H, G, chunk, heads;
};

// One block per (b, chunk c, 64-row tile t, `heads` heads of a group): the
// chunk pass of route 2 (pass (iii) above) with one consumer warpgroup on
// the tile's 64 rows and a producer warp.  The producer loads the role's
// own C_t (then B_t) and each head's dY_t (then X_t) into buffers of their
// own, and streams every other operand unit by unit through a ring of NS
// stages (1-D bulk copies of split tiles, full and empty mbarriers).  Per
// key slab (query role) or query slab (key role): the pair tiles by wgmma
// with both operands in shared memory, hi hi and the small terms in
// accumulators of their own; the pair math in registers; then M (or G^T
// and M^T) straight from the accumulators as register A fragments into
// the slab's products, each a chain from zero added to float32 sums by
// FADD (dc and db in registers across the heads, a head's dx in shared
// memory, each thread its own elements).
template <int P, int N>
__global__ void __launch_bounds__(kWgThreads, 1)
ssd_bwd_chunk_wgmma_kernel(const WgArgs a) {
  using W = Wg<P, N>;
  constexpr int NS = W::NS, KUN = W::KUN, KUP = W::KUP;
  constexpr int NR = W::NR, RHN = W::RHN, NA = W::NA;
  static_assert(P == 64, "route 1 takes P = 64");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* own_a = align1024(smem_raw);  // C_t, then B_t
  unsigned char* own_h = own_a + W::kOwnH;     // dY_t, then X_t
  float* dxsum = reinterpret_cast<float*>(own_a + W::kDx);
  unsigned char* ring = own_a + W::kRing;
  float* vec = reinterpret_cast<float*>(own_a + W::kVec);
  float* rowq = reinterpret_cast<float*>(own_a + W::kRowq);
  float* rowu = reinterpret_cast<float*>(own_a + W::kRowu);
  uint64_t* full = reinterpret_cast<uint64_t*>(own_a + W::kBar);
  uint64_t* empty = full + NS;
  uint64_t* own_full = empty + NS;
  uint64_t* own_empty = own_full + 1;
  uint64_t* head_full = own_empty + 1;
  uint64_t* head_empty = head_full + 1;

  const int L = a.L, H = a.H, G = a.G, chunk = a.chunk, heads = a.heads;
  const int nc = L / chunk, nq = chunk / kWgRows, nslab = L / kWgRows;
  const int t = static_cast<int>(blockIdx.x) % nq;
  const int c = static_cast<int>(blockIdx.x) / nq;
  const int h0 = static_cast<int>(blockIdx.y) * heads, b = blockIdx.z;
  const int rep = H / G, g = h0 / rep;
  const int nparts = rep / heads, part = (h0 % rep) / heads;
  const int r0 = t * kWgRows;
  const size_t t0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * chunk;
  const size_t slab0 = static_cast<size_t>(c) * nq;  // the chunk's first slab
  // tiles: per (b, h, slab), per (b, g, slab), per (b, h, chunk)
  auto of_h = [&](const float* base, int h, int k, int floats) {
    return base + ((static_cast<size_t>(b) * H + h) * nslab + slab0 + k) *
                      static_cast<size_t>(floats);
  };
  auto of_g = [&](const float* base, int k, int floats) {
    return base + ((static_cast<size_t>(b) * G + g) * nslab + slab0 + k) *
                      static_cast<size_t>(floats);
  };
  auto of_state = [&](const float* base, int h, int floats) {
    return base + ((static_cast<size_t>(b) * H + h) * nc + c) *
                      static_cast<size_t>(floats);
  };
  auto s_of = [&](int h) {  // the chunk's s of head h
    return a.s + (static_cast<size_t>(b) * H + h) * L +
           static_cast<size_t>(c) * chunk;
  };
  auto dtt_of = [&](int h) {
    return a.dtt + (static_cast<size_t>(b) * H + h) * L +
           static_cast<size_t>(c) * chunk;
  };
  auto cb_of = [&](int tq, int tk) {  // C_tq B_tk^T, then its transpose
    return a.cb + (((static_cast<size_t>(b) * G + g) * nc + c) *
                       (nq * (nq + 1) / 2) +
                   tq * (tq + 1) / 2 + tk) *
                      (2 * kWgRows * kWgRows);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 4);  // one arrival a consumer warp
    }
    mbar_init(own_full, 1);
    mbar_init(own_empty, 4);
    mbar_init(head_full, 1);
    mbar_init(head_empty, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer warp: one thread issues every copy.  A head's first
    // units (its state's) go into the ring before its dY_t or X_t, whose
    // buffer waits for the last head to be done with it: at most KUP RHN
    // <= NS units come before it, so the ring cannot fill with units the
    // consumer can only take after it.
    if (threadIdx.x == 128) {
      Feed<NS> feed{ring, vec, full, empty};
      int nh = 0;  // heads loaded into own_h
      own_load(own_a, of_g(a.cs, t, W::kNatN), KUN * kUnitBytes, own_full);
      for (int hh = 0; hh < heads; ++hh, ++nh) {
        const int h = h0 + hh;
        const float* hit = of_state(a.hit, h, W::kStateT);
        for (int i = 0; i < KUP * RHN; ++i)
          feed.put(hit + i * NR * 64, NR * 256);
        if (nh > 0) mbar_wait(head_empty, (nh - 1) & 1);
        own_load(own_h, of_h(a.ys, h, t, W::kNatP), KUP * kUnitBytes,
                 head_full);
        for (int k = 0; k <= t; ++k) {
          const float* xk = of_h(a.xs, h, k, W::kNatP);
          const float* btk = of_g(a.bt, k, W::kTimeN);
          feed.put(cb_of(t, k), kUnitBytes, s_of(h) + k * kWgRows,
                   dtt_of(h) + k * kWgRows);
          for (int ku = 0; ku < KUP; ++ku)
            feed.put(xk + ku * kWgRows * 64, kUnitBytes);
          for (int i = 0; i < 2 * RHN; ++i)
            feed.put(btk + i * NR * 64, NR * 256);
        }
      }
      for (int hh = 0; hh < heads; ++hh, ++nh) {
        const int h = h0 + hh;
        const float* dst = of_state(a.dst, h, W::kStateT);
        for (int i = 0; i < KUP * RHN; ++i)
          feed.put(dst + i * NR * 64, NR * 256);
        if (hh == 0) {  // C_t is done with: B_t
          mbar_wait(own_empty, 0);
          own_load(own_a, of_g(a.bs, t, W::kNatN), KUN * kUnitBytes,
                   own_full);
        }
        mbar_wait(head_empty, (nh - 1) & 1);
        own_load(own_h, of_h(a.xs, h, t, W::kNatP), KUP * kUnitBytes,
                 head_full);
        const float* dsn = of_state(a.dsn, h, W::kStateN);
        for (int ku = 0; ku < KUN; ++ku)
          feed.put(dsn + ku * kWgRows * 64, kUnitBytes);
        for (int k = t; k < nq; ++k) {
          const float* yk = of_h(a.ys, h, k, W::kNatP);
          const float* ytk = of_h(a.yt, h, k, W::kTimeP);
          const float* ctk = of_g(a.ct, k, W::kTimeN);
          feed.put(cb_of(k, t) + kWgRows * kWgRows, kUnitBytes,
                   s_of(h) + k * kWgRows);
          for (int ku = 0; ku < KUP; ++ku)
            feed.put(yk + ku * kWgRows * 64, kUnitBytes);
          for (int ku = 0; ku < 2; ++ku)
            feed.put(ytk + ku * kWgRows * 64, kUnitBytes);
          for (int i = 0; i < 2 * RHN; ++i)
            feed.put(ctk + i * NR * 64, NR * 256);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: tile rows ia, ib of the thread
  const Ring<NS> rg{ring, full, empty};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ia = 16 * warp + gq, ib = ia + 8;
  const size_t xstride = static_cast<size_t>(H) * P;
  const size_t ld_part = static_cast<size_t>(G) * nparts * N;
  const size_t part_off =
      (t0 + r0) * ld_part + (static_cast<size_t>(g) * nparts + part) * N;
  auto bhl = [&](int h, int r) {  // a (b, h, l) row of the tile's step r
    return (static_cast<size_t>(b) * H + h) * L +
           static_cast<size_t>(c) * chunk + r0 + r;
  };
  unsigned u = 0;  // the ring's next unit
  int nh = 0;      // heads taken from own_h

  // a state product: v = own_h (depth P) times the N-row tile of KUP x RHN
  // units at u (h_in^T or dS^T), one chain from zero
  auto state_product = [&](float (&v)[RHN][NA]) {
    for (int i = 0; i < KUP * RHN; ++i) rg.wait(u + i);
#pragma unroll
    for (int rh = 0; rh < RHN; ++rh) zero_regs(v[rh]);
    wgmma_fence();
#pragma unroll
    for (int ku = 0; ku < KUP; ++ku)
#pragma unroll
      for (int rh = 0; rh < RHN; ++rh)
        ss_unit(v[rh], own_h + ku * kUnitBytes, rg.at(u + ku * RHN + rh), NR);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int rh = 0; rh < RHN; ++rh) fence_regs(v[rh]);
    for (int i = 0; i < KUP * RHN; ++i) rg.release(u + i, lane);
    u += KUP * RHN;
  };
  // a slab's pair tile: its C B^T tile (the unit at u, formed once a
  // group by ssd_bwd_cb_kernel, with the slab's s and dt) and s2 = own_h
  // (depth P) times the KUP units after it (X_k or dY_k), hi hi and the
  // small terms in accumulators of their own
  auto pairs = [&](float (&s2)[32], float (&s2r)[32]) {
    for (int i = 0; i <= KUP; ++i) rg.wait(u + i);
    zero_regs(s2);
    zero_regs(s2r);
    wgmma_fence();
#pragma unroll
    for (int ku = 0; ku < KUP; ++ku)
      ss_unit2(s2, s2r, own_h + ku * kUnitBytes, rg.at(u + 1 + ku));
    wgmma_commit();
    wgmma_wait();
    fence_regs(s2);
    fence_regs(s2r);
  };
  auto release_pairs = [&]() {
    for (int i = 0; i <= KUP; ++i) rg.release(u + i, lane);
    u += KUP + 1;
  };
  // d = F B over a slab's 64 steps: F the fragments f[0 .. 7], B the 2 x
  // nrb units at u (rows nrb x rows), one chain from zero
  auto slab_product = [&](auto& d, const TfA* f, int rows) {
    constexpr int nrb =
        std::extent<std::remove_reference_t<decltype(d)>>::value;
    for (int i = 0; i < 2 * nrb; ++i) rg.wait(u + i);
#pragma unroll
    for (int rb = 0; rb < nrb; ++rb) zero_regs(d[rb]);
    wgmma_fence();
#pragma unroll
    for (int ku = 0; ku < 2; ++ku)
#pragma unroll
      for (int rb = 0; rb < nrb; ++rb)
        rs_unit(d[rb], f + 4 * ku, rg.at(u + ku * nrb + rb), rows);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int rb = 0; rb < nrb; ++rb) fence_regs(d[rb]);
    for (int i = 0; i < 2 * nrb; ++i) rg.release(u + i, lane);
    u += 2 * nrb;
  };

  // --------------------------------------------------- as query rows --
  float dcs[RHN][NA];
#pragma unroll
  for (int rh = 0; rh < RHN; ++rh)
#pragma unroll
    for (int i = 0; i < NA; ++i) dcs[rh][i] = 0.0f;
  mbar_wait(own_full, 0);
  for (int hh = 0; hh < heads; ++hh, ++nh) {
    const float* sh = s_of(h0 + hh);
    const float si[2] = {sh[r0 + ia], sh[r0 + ib]};
    const float es[2] = {expf(si[0]), expf(si[1])};
    float dsr[2] = {0.0f, 0.0f};
    mbar_wait(head_full, nh & 1);
    {  // the state term: dc += exp(s_i) dY_t h_in, ds_i += its row . c_i
      float v[RHN][NA];
      state_product(v);
#pragma unroll
      for (int rh = 0; rh < RHN; ++rh)
#pragma unroll
        for (int e = 0; e < NA; ++e) {
          const int row = (e & 2) ? ib : ia;
          const int n = 64 * rh + 8 * (e >> 2) + 2 * tq + (e & 1);
          const float val = es[(e >> 1) & 1] * v[rh][e];
          dcs[rh][e] += val;
          dsr[(e >> 1) & 1] = fmaf(
              val, unit_val(own_a + (n >> 5) * kUnitBytes, kWgRows, row,
                            n & 31),
              dsr[(e >> 1) & 1]);
        }
    }
    for (int k = 0; k <= t; ++k) {
      float s2[8][4], s2r[8][4];
      pairs(reinterpret_cast<float(&)[32]>(s2),
            reinterpret_cast<float(&)[32]>(s2r));
      const float* cb = reinterpret_cast<const float*>(rg.at(u));
      const float* sv = vec + 128 * (u % NS);  // s_k, dt_k
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib;
          const int j = 8 * nb + 2 * tq + (e & 1);
          const float a1 = cb[cb_at(i, j)];  // c_i . b_j
          const float a2 = s2[nb][e] + s2r[nb][e];
          const float mv =
              k < t || j <= i ? a2 * expf(si[e >> 1] - sv[j]) * sv[64 + j]
                              : 0.0f;
          dsr[e >> 1] = fmaf(mv, a1, dsr[e >> 1]);
          s2[nb][e] = mv;
        }
      release_pairs();
      TfA f[8];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) a_from_acc(f[nb], s2, nb);
      float dca[RHN][NA];
      slab_product(dca, f, NR);  // dc += M B_k
#pragma unroll
      for (int rh = 0; rh < RHN; ++rh)
#pragma unroll
        for (int e = 0; e < NA; ++e) dcs[rh][e] += dca[rh][e];
    }
    const float va = quad_sum(dsr[0]), vb = quad_sum(dsr[1]);
    if (tq == 0) {
      rowq[hh * kWgRows + ia] = va;
      rowq[hh * kWgRows + ib] = vb;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(head_empty);  // dY_t is done with
  }
#pragma unroll
  for (int rh = 0; rh < RHN; ++rh)
#pragma unroll
    for (int nb = 0; nb < NR / 8; ++nb) {
      const int col = 64 * rh + 8 * nb + 2 * tq;
      float* out = a.dc_part + part_off + col;
      *reinterpret_cast<float2*>(out + ia * ld_part) =
          make_float2(dcs[rh][4 * nb], dcs[rh][4 * nb + 1]);
      *reinterpret_cast<float2*>(out + ib * ld_part) =
          make_float2(dcs[rh][4 * nb + 2], dcs[rh][4 * nb + 3]);
    }
  __syncwarp();
  if (lane == 0) mbar_arrive(own_empty);  // C_t is done with

  // ----------------------------------------------------- as key columns --
  float dbs[RHN][NA];
#pragma unroll
  for (int rh = 0; rh < RHN; ++rh)
#pragma unroll
    for (int i = 0; i < NA; ++i) dbs[rh][i] = 0.0f;
  float* my_dx = dxsum + tid;  // element e at my_dx[128 e]
  mbar_wait(own_full, 1);
  for (int hh = 0; hh < heads; ++hh, ++nh) {
    const int h = h0 + hh;
    const float* sh = s_of(h);
    const float sj[2] = {sh[r0 + ia], sh[r0 + ib]};
    const float dtj[2] = {a.dt[(t0 + r0 + ia) * H + h],
                          a.dt[(t0 + r0 + ib) * H + h]};
    const float s_q = sh[chunk - 1];
    const float eq[2] = {expf(s_q - sj[0]), expf(s_q - sj[1])};
    const float w[2] = {dtj[0] * eq[0], dtj[1] * eq[1]};
    float uj[2] = {0.0f, 0.0f};
    mbar_wait(head_full, nh & 1);
    {  // db += w_j X_t dS, u_j = (X_t dS)_j . b_j
      float v[RHN][NA];
      state_product(v);
#pragma unroll
      for (int rh = 0; rh < RHN; ++rh)
#pragma unroll
        for (int e = 0; e < NA; ++e) {
          const int row = (e & 2) ? ib : ia;
          const int n = 64 * rh + 8 * (e >> 2) + 2 * tq + (e & 1);
          uj[(e >> 1) & 1] = fmaf(
              v[rh][e],
              unit_val(own_a + (n >> 5) * kUnitBytes, kWgRows, row, n & 31),
              uj[(e >> 1) & 1]);
          dbs[rh][e] += w[(e >> 1) & 1] * v[rh][e];
        }
    }
    {  // dx = w_j B_t dS^T over depth N, chains of two units added by FADD
      float px[32], link[32];
      for (int i = 0; i < KUN; ++i) rg.wait(u + i);
#pragma unroll
      for (int k0 = 0; k0 < KUN; k0 += 2) {
        zero_regs(link);
        wgmma_fence();
#pragma unroll
        for (int ku = k0; ku < k0 + 2 && ku < KUN; ++ku)
          ss_unit(link, own_a + ku * kUnitBytes, rg.at(u + ku), kWgRows);
        wgmma_commit();
        wgmma_wait();
        fence_regs(link);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          px[e] = k0 == 0 ? link[e] : px[e] + link[e];
      }
      for (int i = 0; i < KUN; ++i) rg.release(u + i, lane);
      u += KUN;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        my_dx[128 * e] = w[(e >> 1) & 1] * px[e];
    }
    float dsc[2], ddc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dsc[r] = -uj[r] * w[r];
      ddc[r] = eq[r] * uj[r];
    }
    {
      const float ua = quad_sum(uj[0] * w[0]), ub = quad_sum(uj[1] * w[1]);
      if (tq == 0) {
        rowu[(nh & 1) * kWgRows + ia] = ua;
        rowu[(nh & 1) * kWgRows + ib] = ub;
      }
    }
    for (int k = t; k < nq; ++k) {
      float s1[8][4], s2[8][4], s2r[8][4];
      pairs(reinterpret_cast<float(&)[32]>(s2),
            reinterpret_cast<float(&)[32]>(s2r));
      const float* cbt = reinterpret_cast<const float*>(rg.at(u));
      const float* sv = vec + 128 * (u % NS);  // s_k
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? ia : ib;
          const int i = 8 * nb + 2 * tq + (e & 1);
          const float l =
              k > t || i >= j ? expf(sv[i] - sj[e >> 1]) : 0.0f;
          const float a1 = cbt[cb_at(j, i)];  // b_j . c_i
          const float a2 = s2[nb][e] + s2r[nb][e];
          const float cbl = a1 * l;
          const float mv = a2 * l * dtj[e >> 1];
          ddc[e >> 1] = fmaf(a2, cbl, ddc[e >> 1]);
          dsc[e >> 1] = fmaf(-mv, a1, dsc[e >> 1]);
          s1[nb][e] = cbl * dtj[e >> 1];  // G^T
          s2[nb][e] = mv;                 // M^T
        }
      release_pairs();
      TfA f[8];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) a_from_acc(f[nb], s1, nb);
      {
        float dxa[1][32];
        slab_product(dxa, f, kWgRows);  // dx += G^T dY_k
#pragma unroll
        for (int e = 0; e < 32; ++e) my_dx[128 * e] += dxa[0][e];
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) a_from_acc(f[nb], s2, nb);
      float dba[RHN][NA];
      slab_product(dba, f, NR);  // db += M^T C_k
#pragma unroll
      for (int rh = 0; rh < RHN; ++rh)
#pragma unroll
        for (int e = 0; e < NA; ++e) dbs[rh][e] += dba[rh][e];
    }
    // the head's rows: ds, ddt's partial, dx, and ds_Q's partial
    const float da = quad_sum(dsc[0]), dbv = quad_sum(dsc[1]);
    const float ta = quad_sum(ddc[0]), tb = quad_sum(ddc[1]);
    if (tq == 0) {
      a.ds[bhl(h, ia)] = rowq[hh * kWgRows + ia] + da;
      a.ds[bhl(h, ib)] = rowq[hh * kWgRows + ib] + dbv;
      a.ddt_part[bhl(h, ia)] = ta;
      a.ddt_part[bhl(h, ib)] = tb;
    }
    float* out = a.dx + ((t0 + r0) * H + h) * P;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = 8 * nb + 2 * tq;
      *reinterpret_cast<float2*>(out + ia * xstride + col) = make_float2(
          my_dx[128 * (4 * nb)], my_dx[128 * (4 * nb + 1)]);
      *reinterpret_cast<float2*>(out + ib * xstride + col) = make_float2(
          my_dx[128 * (4 * nb + 2)], my_dx[128 * (4 * nb + 3)]);
    }
    consumers_sync();  // every row's u w is in
    if (tid == 0) {
      float tot = 0.0f;
      for (int r = 0; r < kWgRows; ++r) tot += rowu[(nh & 1) * kWgRows + r];
      a.dsq_scan[((static_cast<size_t>(b) * H + h) * nc + c) * nq + t] = tot;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(head_empty);  // X_t is done with
  }
#pragma unroll
  for (int rh = 0; rh < RHN; ++rh)
#pragma unroll
    for (int nb = 0; nb < NR / 8; ++nb) {
      const int col = 64 * rh + 8 * nb + 2 * tq;
      float* out = a.db_part + part_off + col;
      *reinterpret_cast<float2*>(out + ia * ld_part) =
          make_float2(dbs[rh][4 * nb], dbs[rh][4 * nb + 1]);
      *reinterpret_cast<float2*>(out + ib * ld_part) =
          make_float2(dbs[rh][4 * nb + 2], dbs[rh][4 * nb + 3]);
    }
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
  float *dx, *ddt, *da_log, *db, *dc, *dh0, *split;
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

// pass (ii); returns its blocks per (b, h) through *nblk
template <int P, int N>
int launch_state_pass(const Args& a, int* nblk) {
  const int pn4 = P * N / 4;
  *nblk = (pn4 + kPassThreads - 1) / kPassThreads;
  ssd_bwd_state_pass_kernel<<<dim3(*nblk, a.H, a.B), kPassThreads, 0,
                              a.stream>>>(a.dstate, a.states, a.s,
                                          a.dh_final, a.dh0, a.dsq_pass,
                                          a.L, a.H, a.chunk, pn4);
  return static_cast<int>(cudaGetLastError());
}

// pass (iv)
template <int N>
int launch_finish(const Args& a, int nblk, int rows) {
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

// route 2: the four passes on mma.sync
template <int P, int N>
int launch_sync(const Args& a) {
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
  int nblk = 0;
  err = launch_state_pass<P, N>(a, &nblk);
  if (err) return err;
  switch (rows) {
    case 16: err = launch_chunk<P, N, 16>(a); break;
    case 32: err = launch_chunk<P, N, 32>(a); break;
    case 64:
      // route 1 takes R = 64 at its (P, N): not instantiated here
      if constexpr (wgmma_pn(P, N))
        err = static_cast<int>(cudaErrorInvalidValue);
      else
        err = launch_chunk<P, N, 64>(a);
      break;
    default: err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return launch_finish<N>(a, nblk, rows);
}

SplitJob split_job(const float* src, float* dst, int nb, int na, int nc,
                   long long sb, long long sa, long long sc, long long sr,
                   long long sk, int rows, int depth, int unit_rows,
                   int perm) {
  SplitJob j;
  j.src = src;
  j.dst = dst;
  j.sb = sb;
  j.sa = sa;
  j.sc = sc;
  j.sr = sr;
  j.sk = sk;
  j.nb = nb;
  j.na = na;
  j.nc = nc;
  j.depth = depth;
  j.unit_rows = unit_rows;
  j.units_k = (depth + 31) / 32;
  j.units_r = rows / unit_rows;
  j.perm = perm;
  return j;
}

int launch_split(SplitJobs& jobs, cudaStream_t stream) {
  long long blocks = 0;
  for (int j = 0; j < jobs.count; ++j) {
    const SplitJob& jb = jobs.job[j];
    jobs.first[j] = blocks;
    blocks += static_cast<long long>(jb.nb) * jb.na * jb.nc * jb.units_k *
              jb.units_r;
  }
  jobs.first[jobs.count] = blocks;
  if (blocks <= 0 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_split_kernel<<<static_cast<unsigned>(blocks), kSplitThreads, 0,
                         stream>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}

// route 1: dt transposed and the split tiles of x, dy, b, c and h_in;
// (i) D_c on wgmma; (ii); the split tiles of dS; (iii) on wgmma; (iv)
template <int P, int N>
int launch_wgmma(const Args& a) {
  using W = Wg<P, N>;
  const int B = a.B, L = a.L, H = a.H, G = a.G, chunk = a.chunk;
  const int nc = L / chunk, nslab = L / kWgRows;
  const SplitLayout lay = split_layout<P, N>(B, L, H, G, chunk);
  float* sp = a.split;
  const long long LHP = static_cast<long long>(L) * H * P;
  const long long LGN = static_cast<long long>(L) * G * N;
  const long long HP = static_cast<long long>(H) * P;
  const long long PN = static_cast<long long>(P) * N;
  const long long GN = static_cast<long long>(G) * N;
  const long long total = static_cast<long long>(B) * H * L;
  ssd_bwd_dt_kernel<<<static_cast<unsigned>(
                          (total + kThreads - 1) / kThreads < 4096
                              ? (total + kThreads - 1) / kThreads
                              : 4096),
                      kThreads, 0, a.stream>>>(a.dt, sp + lay.dtt, L, H,
                                               total);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  SplitJobs first{};
  auto add = [](SplitJobs& js, const SplitJob& j) { js.job[js.count++] = j; };
  // per (b, h, slab): x and dy as 64 steps x P, dy^T as P x 64 steps
  add(first, split_job(a.x, sp + lay.xs, B, H, nslab, LHP, P, 64 * HP, HP,
                       1, kWgRows, P, kWgRows, 0));
  add(first, split_job(a.dy, sp + lay.ys, B, H, nslab, LHP, P, 64 * HP, HP,
                       1, kWgRows, P, kWgRows, 0));
  add(first, split_job(a.dy, sp + lay.yt, B, H, nslab, LHP, P, 64 * HP, 1,
                       HP, P, kWgRows, kWgRows, 1));
  // per (b, g, slab): b and c as 64 steps x N, b^T and c^T as N x 64 steps
  add(first, split_job(a.b, sp + lay.bs, B, G, nslab, LGN, N, 64 * GN, GN,
                       1, kWgRows, N, kWgRows, 0));
  add(first, split_job(a.c, sp + lay.cs, B, G, nslab, LGN, N, 64 * GN, GN,
                       1, kWgRows, N, kWgRows, 0));
  add(first, split_job(a.b, sp + lay.bt, B, G, nslab, LGN, N, 64 * GN, 1,
                       GN, N, kWgRows, W::NR, 1));
  add(first, split_job(a.c, sp + lay.ct, B, G, nslab, LGN, N, 64 * GN, 1,
                       GN, N, kWgRows, W::NR, 1));
  // per (b, h, chunk): h_in^T as N x P
  add(first, split_job(a.states, sp + lay.hit, B, H, nc, H * nc * PN,
                       nc * PN, PN, 1, N, N, P, W::NR, 0));
  err = launch_split(first, a.stream);
  if (err) return err;
  // each chunk's C B^T tiles, once a group
  auto cbk = ssd_bwd_cb_kernel<P, N>;
  const size_t cb_smem = 1024 + 2 * W::KUN * kUnitBytes + 8;
  err = static_cast<int>(cudaFuncSetAttribute(
      cbk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cb_smem)));
  if (err) return err;
  const int nq = chunk / kWgRows;
  cbk<<<dim3(nq * (nq + 1) / 2, nc, B * G), 128, cb_smem, a.stream>>>(
      sp + lay.bs, sp + lay.cs, sp + lay.cb, L, chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  auto dstate = ssd_bwd_dstate_wgmma_kernel<P, N>;
  err = static_cast<int>(cudaFuncSetAttribute(
      dstate, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(W::kDSmem)));
  if (err) return err;
  dstate<<<dim3(nc, H, B), kWgThreads, W::kDSmem, a.stream>>>(
      sp + lay.yt, sp + lay.ct, a.s, a.dstate, L, H, G, chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  int nblk = 0;
  err = launch_state_pass<P, N>(a, &nblk);
  if (err) return err;
  // per (b, h, chunk): dS^T as N x P, dS as P x N
  SplitJobs second{};
  add(second, split_job(a.dstate, sp + lay.dst, B, H, nc, H * nc * PN,
                        nc * PN, PN, 1, N, N, P, W::NR, 0));
  add(second, split_job(a.dstate, sp + lay.dsn, B, H, nc, H * nc * PN,
                        nc * PN, PN, N, 1, P, N, kWgRows, 0));
  err = launch_split(second, a.stream);
  if (err) return err;
  auto chunk_kernel = ssd_bwd_chunk_wgmma_kernel<P, N>;
  err = static_cast<int>(cudaFuncSetAttribute(
      chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(W::kSmem)));
  if (err) return err;
  const WgArgs wa{sp + lay.xs,  sp + lay.ys,  sp + lay.yt,  sp + lay.bs,
                  sp + lay.cs,  sp + lay.bt,  sp + lay.ct,  sp + lay.hit,
                  sp + lay.dst, sp + lay.dsn, sp + lay.dtt, sp + lay.cb,
                  a.s,          a.dt,         a.dx,         a.db_part,
                  a.dc_part,    a.ds,         a.ddt_part,   a.dsq_scan,
                  L,            H,            G,            chunk,
                  a.heads};
  const long long blocks = static_cast<long long>(nc) * nq;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  chunk_kernel<<<dim3(static_cast<unsigned>(blocks), H / a.heads, B),
                 kWgThreads, W::kSmem, a.stream>>>(wa);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_finish<N>(a, nblk, kWgRows);
}

// the route of (P, N, chunk), fixed at compile time for (P, N): route 1
// is instantiated only at the (P, N) the table gives it
template <int P, int N>
int launch_all(const Args& a) {
  if constexpr (wgmma_pn(P, N)) {
    if (route_of(P, N, a.chunk) == 1) return launch_wgmma<P, N>(a);
  }
  return launch_sync<P, N>(a);
}

template <int P, int N>
long long split_floats(int B, int L, int H, int G, int chunk) {
  if constexpr (wgmma_pn(P, N))
    return static_cast<long long>(
        split_layout<P, N>(B, L, H, G, chunk).total);
  else
    return 0;
}

}  // namespace

extern "C" {

// The route the table gives (p, n, chunk): 1 wgmma, 2 mma.sync, 0 none
// (the launch refuses it).
int repro_ssd_bwd_route(int p, int n, int chunk) {
  return route_of(p, n, chunk);
}

// Floats of the split scratch route 1 takes at this shape (0 on route 2).
long long repro_ssd_bwd_split_floats(int B, int L, int H, int G, int p,
                                     int n, int chunk) {
  if (route_of(p, n, chunk) != 1 || B <= 0 || L <= 0 || H <= 0 || G <= 0 ||
      L % chunk)
    return 0;
  return n == 128 ? split_floats<64, 128>(B, L, H, G, chunk)
                  : split_floats<64, 16>(B, L, H, G, chunk);
}

// float32 only.  The caller guarantees contiguous, 16-byte aligned
// operands on the current device: x and dy (B, L, H, P), dt (B, L, H),
// a_log (H,), b and c (B, L, G, N), the forward's s (B, H, L) and
// chunk-entry states (B, H, L / chunk, P, N), dh_final (B, H, P, N) or
// null; the scratches dstate (B, H, L / chunk, P, N), dsq_pass (B, H,
// L / chunk, ceil(P N / 512)), dsq_scan (B, H, L / chunk, chunk / R), ds
// and ddt_part (B, H, L), db_part and dc_part (B, L, G H / (G heads), N),
// and on route 1 `split` (repro_ssd_bwd_split_floats floats; null on route
// 2); the outputs dx, ddt, da_log, db, dc of their operands' shapes and
// dh0 (B, H, P, N).  (p, n, chunk) is a route of the table and the chunk
// divides L; `heads` (the heads of a chunk-pass block) divides H / G and
// is at most kMaxHeads.
int repro_ssd_bwd(const void* x, const void* dt, const void* a_log,
                  const void* b, const void* c, const void* dy,
                  const void* s, const void* states, const void* dh_final,
                  void* dstate, void* dsq_pass, void* dsq_scan, void* ds,
                  void* ddt_part, void* db_part, void* dc_part, void* dx,
                  void* ddt, void* da_log, void* db, void* dc, void* dh0,
                  void* split, int B, int L, int H, int G, int p, int n,
                  int chunk, int heads, void* stream) {
  auto cf = [](const void* v) { return static_cast<const float*>(v); };
  auto mf = [](void* v) { return static_cast<float*>(v); };
  const Args a{cf(x), cf(dt), cf(a_log), cf(b), cf(c), cf(dy), cf(s),
               cf(states), cf(dh_final), mf(dstate), mf(dsq_pass),
               mf(dsq_scan), mf(ds), mf(ddt_part), mf(db_part), mf(dc_part),
               mf(dx), mf(ddt), mf(da_log), mf(db), mf(dc), mf(dh0),
               mf(split), B, L, H, G, chunk, heads,
               static_cast<cudaStream_t>(stream)};
  const int route = route_of(p, n, chunk);
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G || B > 65535 ||
      H > 65535 || route == 0 || L % chunk || heads <= 0 ||
      heads > kMaxHeads || (H / G) % heads || (route == 1 && !split))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_pn(p, n, [&](auto P, auto N) {
    return launch_all<decltype(P)::value, decltype(N)::value>(a);
  });
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
