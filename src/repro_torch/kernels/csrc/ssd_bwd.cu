// The gradient of the Mamba-2 SSD chunked scan for Hopper (sm_90a), FP32
// FFMA, hand-written, in four passes, deterministic (no atomics).
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
//        D_c = sum_i exp(s_i) dy_i c_i^T, a (P, N) tile -- the forward's
//        pass 1 with dy in place of x.  2 Q P N flops: operations.
//  (ii)  ssd_bwd_state_pass_kernel, one thread per float4 of a (b, h)'s
//        state: the forward's pass 2 run backwards over the chunks, from
//        g = dh_final (or 0): dS_c = g (written over D_c in place),
//        ds_Q(c) += exp(s_Q) <g, H_c>, g = D_c + exp(s_Q) g; the last g is
//        dh0.  The <g, H_c> sums are reduced within the block in a fixed
//        order and written per (chunk, block), not added atomically.
//        Elementwise: bytes.
//  (iii) ssd_bwd_chunk_kernel, one block per (b, h, c, R-row tile t),
//        R = min(Q, 64).  With dG_ij = dy_i . x_j, M_ij = dG_ij
//        exp(s_i - s_j) dt_j and E_ij = M_ij (c_i . b_j):
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
//        column sums), so every block visits nq + 1 (slab, tile) pairs
//        whatever its place in the chunk, and every output row is written
//        by one block: no cross-block sum but ds_Q.  The pairs' c.b and
//        dy.x products are formed twice (once in each role), the price of
//        that.  The decay is exponentiated only where i >= j: above the
//        diagonal s_i - s_j > 0 grows with the distance and exp
//        overflows, and a multiply by a 0/1 mask would give inf * 0 = NaN.
//        db and dc are written per head; pass (iv) sums a group's heads.
//        Bound by operations: Q^2 (3 N + 2 P) + 6 Q P N flops a chunk, and
//        the pairs' products again.
//  (iv)  ssd_bwd_finish_kernel, two roles in one launch.  Blocks 0 .. H-1,
//        one per head: add the ds_Q partials of (ii) and (iii) to the
//        chunk's last step in a fixed order, take r = the reverse
//        cumulative sum of ds within each chunk (block scans of 256 steps
//        from the chunk's end, carried), ddt_t = ddt_t + a r_t and
//        da_log[h] = a sum_{b,t} dt_t r_t (a block sum in a fixed order).
//        The other blocks sum db and dc over each group's H / G heads in
//        head order (mamba2-2.7b has one group of 80 heads).
//
// s and H_c are the forward's own scratches (kernels/ssd.py keeps them
// from the forward for its backward, 41.9 MB a layer at mamba2-2.7b's
// width and chunk 256), so nothing of the forward is recomputed here.
//
// Shared memory of pass (iii), floats, each row padded by one float so
// that the strided reads of 16 rows by 16 threads fall in 16 banks: the
// tile's C and B rows (R x (N + 1) each), X and dY rows (R x (P + 1)
// each), then a union of a slab's B or C rows and X or dY rows with the
// M and G tiles (R x (R + 1) each), or h_in and dS of the chunk (P x
// (N + 1) each), or the column sums of 16 row groups; and five R-vectors.
// 183,552 bytes at (P, N, R) = (64, 128, 64): one block an SM, 256
// threads, each owning rows ty + 16 a of a tile (a < R / 16) and columns
// tx + 16 q.  The row sums reduce over the 16 threads of a half-warp by
// shuffles, the column sums over the 16 row groups through shared memory,
// each in one fixed order.
//
// Arithmetic is float32 FFMA (67 TFLOP/s outside the tensor cores, 700 W),
// held to the float32 gates; scalar shared-memory reads.  Simple first:
// 3xTF32 on the tensor cores, fusing (i) into the forward's pass 3 and
// bf16 operands are later work.
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
constexpr int kThreads = 256;      // passes (i), (iii), (iv)
constexpr int kPassThreads = 128;  // pass (ii)
constexpr int kSlab = 16;          // pass (i): rows of a slab
constexpr int kGrid = 16;          // 16 x 16 threads own a tile's outputs

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// sum over the 16 lanes of a half-warp (tid = 16 ty + tx), the same value
// in every lane: the butterfly's result of the half-warp's first lane
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, (threadIdx.x % kWarp) & 16);
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
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dstate_kernel(const float* __restrict__ dy,
                      const float* __restrict__ cm,
                      const float* __restrict__ s,
                      float* __restrict__ dstate, int L, int H, int G,
                      int chunk) {
  constexpr int PA = (P + kGrid - 1) / kGrid, NQ = (N + kGrid - 1) / kGrid;
  __shared__ float ys[kSlab * P];  // exp(s_i) dy_i of a slab
  __shared__ float cs[kSlab * N];
  const int tid = threadIdx.x, tx = tid % kGrid, ty = tid / kGrid;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G), nc = L / chunk;
  const size_t t0 = static_cast<size_t>(b) * L +
                    static_cast<size_t>(c) * chunk;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* s_chunk = s + bh * L + static_cast<size_t>(c) * chunk;

  float acc[PA][NQ];
#pragma unroll
  for (int a = 0; a < PA; ++a)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[a][q] = 0.0f;

  for (int i0 = 0; i0 < chunk; i0 += kSlab) {
    __syncthreads();  // the previous slab is read by all
    for (int idx = tid; idx < kSlab * P; idx += kThreads) {
      const int r = idx / P, p = idx % P;
      ys[idx] = dy[((t0 + i0 + r) * H + h) * P + p] * expf(s_chunk[i0 + r]);
    }
    for (int idx = tid; idx < kSlab * N; idx += kThreads) {
      const int r = idx / N, n = idx % N;
      cs[idx] = cm[((t0 + i0 + r) * G + g) * N + n];
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kSlab; ++r) {
      float yv[PA], cv[NQ];
#pragma unroll
      for (int a = 0; a < PA; ++a) yv[a] = ys[r * P + min(ty + kGrid * a, P - 1)];
#pragma unroll
      for (int q = 0; q < NQ; ++q) cv[q] = cs[r * N + min(tx + kGrid * q, N - 1)];
#pragma unroll
      for (int a = 0; a < PA; ++a)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[a][q] = fmaf(yv[a], cv[q], acc[a][q]);
    }
  }
  float* out = dstate + (bh * nc + c) * P * N;
#pragma unroll
  for (int a = 0; a < PA; ++a) {
    const int p = ty + kGrid * a;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = tx + kGrid * q;
      if (p < P && n < N) out[p * N + n] = acc[a][q];
    }
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
template <int P, int N, int R>
struct ChunkSmem {
  static constexpr int NS = N + 1, PS = P + 1, RS = R + 1;
  static constexpr int kOwn = 2 * R * NS + 2 * R * PS;
  static constexpr int kUnion =
      cmax(cmax(R * NS + R * PS + 2 * R * RS, 2 * P * NS), 2 * kGrid * R);
  static constexpr int kFloats = kOwn + kUnion + 5 * R;
};

template <int P, int N, int R>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ dy,
                     const float* __restrict__ s,
                     const float* __restrict__ states,
                     const float* __restrict__ dstate,
                     float* __restrict__ dx, float* __restrict__ db_h,
                     float* __restrict__ dc_h, float* __restrict__ ds,
                     float* __restrict__ ddt_part,
                     float* __restrict__ dsq_scan, int L, int H, int G,
                     int chunk) {
  using S = ChunkSmem<P, N, R>;
  constexpr int NS = S::NS, PS = S::PS, RS = S::RS;
  constexpr int RA = R / kGrid;                 // tile rows a thread owns
  constexpr int NQ = (N + kGrid - 1) / kGrid;  // N columns a thread owns
  constexpr int PQ = (P + kGrid - 1) / kGrid;  // P columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;           // R x NS: C rows of the tile
  float* bt = ct + R * NS;    // R x NS: B rows of the tile
  float* xt = bt + R * NS;    // R x PS: X rows of the tile
  float* yt = xt + R * PS;    // R x PS: dY rows of the tile
  float* un = yt + R * PS;    // the union:
  float* ak = un;             //   R x NS: B or C rows of slab k
  float* vk = ak + R * NS;    //   R x PS: X or dY rows of slab k
  float* mt = vk + R * PS;    //   R x RS: M of the (slab, tile) pair
  float* gt = mt + R * RS;    //   R x RS: G of the pair
  float* hs = un;             //   or P x NS: h_in of the chunk
  float* dss = un + P * NS;   //   and P x NS: dS of the chunk
  float* red = un;            //   or 2 x 16 x R: column sums
  float* s_t = un + S::kUnion;  // s and dt of the tile's steps
  float* dt_t = s_t + R;
  float* s_k = dt_t + R;      // s and dt of slab k's steps
  float* dt_k = s_k + R;
  float* uw_s = dt_k + R;     // u_j w_j of the tile's steps

  const int tid = threadIdx.x, tx = tid % kGrid, ty = tid / kGrid;
  const int nc = L / chunk, nq = chunk / R;
  const int t = static_cast<int>(blockIdx.x) % nq;
  const int c = static_cast<int>(blockIdx.x) / nq;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int r0 = t * R;
  const size_t t0 = static_cast<size_t>(b) * L +
                    static_cast<size_t>(c) * chunk;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* s_chunk = s + bh * L + static_cast<size_t>(c) * chunk;
  const float s_q = s_chunk[chunk - 1];
  const float* xg = x + (t0 * H + h) * P;   // step j at + j H P
  const float* yg = dy + (t0 * H + h) * P;
  const float* bg = bm + (t0 * G + g) * N;  // step j at + j G N
  const float* cg = cm + (t0 * G + g) * N;
  const size_t xstride = static_cast<size_t>(H) * P;
  const size_t bstride = static_cast<size_t>(G) * N;

  // `rows` rows of W floats, row r read at src + r * stride, into a tile
  // whose rows are `ld` floats apart
  auto load = [&](float* dst, int ld, const float* src, size_t stride,
                  int rows, int w) {
    for (int idx = tid; idx < rows * w; idx += kThreads) {
      const int r = idx / w, col = idx % w;
      dst[r * ld + col] = src[r * stride + col];
    }
  };

  load(ct, NS, cg + r0 * bstride, bstride, R, N);
  load(bt, NS, bg + r0 * bstride, bstride, R, N);
  load(xt, PS, xg + r0 * xstride, xstride, R, P);
  load(yt, PS, yg + r0 * xstride, xstride, R, P);
  const size_t st_off = (bh * nc + c) * P * N;
  load(hs, NS, states + st_off, N, P, N);
  load(dss, NS, dstate + st_off, N, P, N);
  for (int i = tid; i < R; i += kThreads) {
    s_t[i] = s_chunk[r0 + i];
    dt_t[i] = dt[(t0 + r0 + i) * H + h];
  }
  __syncthreads();

  // the state terms of the tile's rows: dc = dY h_in, db = X dS (over P),
  // dx = B dS^T (over N)
  float dc_acc[RA][NQ], db_acc[RA][NQ], dx_acc[RA][PQ];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) dc_acc[a][q] = db_acc[a][q] = 0.0f;
#pragma unroll
    for (int q = 0; q < PQ; ++q) dx_acc[a][q] = 0.0f;
  }
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    float yv[RA], xv[RA], hv[NQ], sv[NQ];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      yv[a] = yt[(ty + kGrid * a) * PS + p];
      xv[a] = xt[(ty + kGrid * a) * PS + p];
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = min(tx + kGrid * q, N - 1);
      hv[q] = hs[p * NS + n];
      sv[q] = dss[p * NS + n];
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        dc_acc[a][q] = fmaf(yv[a], hv[q], dc_acc[a][q]);
        db_acc[a][q] = fmaf(xv[a], sv[q], db_acc[a][q]);
      }
  }
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float bv[RA], sv[PQ];
#pragma unroll
    for (int a = 0; a < RA; ++a) bv[a] = bt[(ty + kGrid * a) * NS + n];
#pragma unroll
    for (int q = 0; q < PQ; ++q)
      sv[q] = dss[min(tx + kGrid * q, P - 1) * NS + n];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int q = 0; q < PQ; ++q) dx_acc[a][q] = fmaf(bv[a], sv[q], dx_acc[a][q]);
  }
  float ds_st[RA], ddt_st[RA], uw[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int i = ty + kGrid * a;
    const float es = expf(s_t[i]);
    const float eqj = expf(s_q - s_t[i]);
    const float w = dt_t[i] * eqj;
    float hsum = 0.0f, usum = 0.0f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = tx + kGrid * q;
      dc_acc[a][q] *= es;
      if (n < N) {
        hsum = fmaf(dc_acc[a][q], ct[i * NS + n], hsum);
        usum = fmaf(db_acc[a][q], bt[i * NS + n], usum);
      }
      db_acc[a][q] *= w;
    }
#pragma unroll
    for (int q = 0; q < PQ; ++q) dx_acc[a][q] *= w;
    hsum = sum16(hsum);
    usum = sum16(usum);
    ds_st[a] = hsum - usum * w;
    ddt_st[a] = eqj * usum;
    uw[a] = usum * w;
  }
  __syncthreads();  // h_in and dS read by all: the union takes slabs now

  // as query rows: key slabs k <= t, dc_i += sum_j M_ij b_j, row sums of E
  float ds_row[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) ds_row[a] = 0.0f;
  for (int k = 0; k <= t; ++k) {
    const int j0 = k * R;
    load(ak, NS, bg + j0 * bstride, bstride, R, N);
    load(vk, PS, xg + j0 * xstride, xstride, R, P);
    for (int i = tid; i < R; i += kThreads) {
      s_k[i] = s_chunk[j0 + i];
      dt_k[i] = dt[(t0 + j0 + i) * H + h];
    }
    __syncthreads();
    float s1[RA][RA], s2[RA][RA];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int e = 0; e < RA; ++e) s1[a][e] = s2[a][e] = 0.0f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[RA], bv[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        cv[a] = ct[(ty + kGrid * a) * NS + n];
        bv[a] = ak[(tx + kGrid * a) * NS + n];
      }
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int e = 0; e < RA; ++e) s1[a][e] = fmaf(cv[a], bv[e], s1[a][e]);
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float yv[RA], xv[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        yv[a] = yt[(ty + kGrid * a) * PS + p];
        xv[a] = vk[(tx + kGrid * a) * PS + p];
      }
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int e = 0; e < RA; ++e) s2[a][e] = fmaf(yv[a], xv[e], s2[a][e]);
    }
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int i = ty + kGrid * a;
#pragma unroll
      for (int e = 0; e < RA; ++e) {
        const int j = tx + kGrid * e;
        const float m = r0 + i >= j0 + j
                            ? s2[a][e] * expf(s_t[i] - s_k[j]) * dt_k[j]
                            : 0.0f;
        ds_row[a] = fmaf(m, s1[a][e], ds_row[a]);
        mt[i * RS + j] = m;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < R; ++j) {
      float mv[RA], bv[NQ];
#pragma unroll
      for (int a = 0; a < RA; ++a) mv[a] = mt[(ty + kGrid * a) * RS + j];
#pragma unroll
      for (int q = 0; q < NQ; ++q) bv[q] = ak[j * NS + min(tx + kGrid * q, N - 1)];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int q = 0; q < NQ; ++q) dc_acc[a][q] = fmaf(mv[a], bv[q], dc_acc[a][q]);
    }
    __syncthreads();  // the slab and M are read by all
  }

  // as key columns: query slabs k >= t, dx_j += sum_i G_ij dy_i, db_j +=
  // sum_i M_ij c_i, ddt_j and the column sums of E
  float ds_col[RA], ddt_col[RA];
#pragma unroll
  for (int e = 0; e < RA; ++e) ds_col[e] = ddt_col[e] = 0.0f;
  for (int k = t; k < nq; ++k) {
    const int i0 = k * R;
    load(ak, NS, cg + i0 * bstride, bstride, R, N);
    load(vk, PS, yg + i0 * xstride, xstride, R, P);
    for (int i = tid; i < R; i += kThreads) s_k[i] = s_chunk[i0 + i];
    __syncthreads();
    float s1[RA][RA], s2[RA][RA];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int e = 0; e < RA; ++e) s1[a][e] = s2[a][e] = 0.0f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[RA], bv[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        cv[a] = ak[(ty + kGrid * a) * NS + n];
        bv[a] = bt[(tx + kGrid * a) * NS + n];
      }
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int e = 0; e < RA; ++e) s1[a][e] = fmaf(cv[a], bv[e], s1[a][e]);
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float yv[RA], xv[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        yv[a] = vk[(ty + kGrid * a) * PS + p];
        xv[a] = xt[(tx + kGrid * a) * PS + p];
      }
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int e = 0; e < RA; ++e) s2[a][e] = fmaf(yv[a], xv[e], s2[a][e]);
    }
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int i = ty + kGrid * a;
#pragma unroll
      for (int e = 0; e < RA; ++e) {
        const int j = tx + kGrid * e;
        const float l = i0 + i >= r0 + j ? expf(s_k[i] - s_t[j]) : 0.0f;
        const float cbl = s1[a][e] * l;
        const float m = s2[a][e] * l * dt_t[j];
        gt[i * RS + j] = cbl * dt_t[j];
        mt[i * RS + j] = m;
        ddt_col[e] = fmaf(s2[a][e], cbl, ddt_col[e]);
        ds_col[e] = fmaf(-m, s1[a][e], ds_col[e]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < R; ++i) {
      float gv[RA], mv[RA], yv[PQ], cv[NQ];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        gv[a] = gt[i * RS + ty + kGrid * a];
        mv[a] = mt[i * RS + ty + kGrid * a];
      }
#pragma unroll
      for (int q = 0; q < PQ; ++q) yv[q] = vk[i * PS + min(tx + kGrid * q, P - 1)];
#pragma unroll
      for (int q = 0; q < NQ; ++q) cv[q] = ak[i * NS + min(tx + kGrid * q, N - 1)];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
#pragma unroll
        for (int q = 0; q < PQ; ++q) dx_acc[a][q] = fmaf(gv[a], yv[q], dx_acc[a][q]);
#pragma unroll
        for (int q = 0; q < NQ; ++q) db_acc[a][q] = fmaf(mv[a], cv[q], db_acc[a][q]);
      }
    }
    __syncthreads();  // the slab, G and M are read by all
  }

  // the column sums over the 16 row groups, in row-group order
#pragma unroll
  for (int e = 0; e < RA; ++e) {
    red[ty * R + tx + kGrid * e] = ds_col[e];
    red[kGrid * R + ty * R + tx + kGrid * e] = ddt_col[e];
  }
  if (tx == 0)
#pragma unroll
    for (int a = 0; a < RA; ++a) uw_s[ty + kGrid * a] = uw[a];
#pragma unroll
  for (int a = 0; a < RA; ++a) ds_row[a] = sum16(ds_row[a]);
  __syncthreads();
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int i = ty + kGrid * a;
      float cs = 0.0f, cd = 0.0f;
      for (int y = 0; y < kGrid; ++y) {
        cs += red[y * R + i];
        cd += red[kGrid * R + y * R + i];
      }
      const size_t l = bh * L + static_cast<size_t>(c) * chunk + r0 + i;
      ds[l] = ds_row[a] + cs + ds_st[a];
      ddt_part[l] = cd + ddt_st[a];
    }
  }
  if (tid == 0) {
    float tot = 0.0f;
    for (int i = 0; i < R; ++i) tot += uw_s[i];
    dsq_scan[(bh * nc + c) * nq + t] = tot;
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const size_t row = (t0 + r0 + ty + kGrid * a) * H + h;
#pragma unroll
    for (int q = 0; q < PQ; ++q) {
      const int p = tx + kGrid * q;
      if (p < P) dx[row * P + p] = dx_acc[a][q];
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = tx + kGrid * q;
      if (n < N) {
        db_h[row * N + n] = db_acc[a][q];
        dc_h[row * N + n] = dc_acc[a][q];
      }
    }
  }
}

// ------------------------------------------------------------ pass (iv) --
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish_kernel(const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const float* __restrict__ ds,
                      const float* __restrict__ ddt_part,
                      const float* __restrict__ dsq_pass,
                      const float* __restrict__ dsq_scan,
                      const float* __restrict__ db_h,
                      const float* __restrict__ dc_h,
                      float* __restrict__ ddt, float* __restrict__ da_log,
                      float* __restrict__ db, float* __restrict__ dc, int B,
                      int L, int H, int G, int N, int chunk, int nblk,
                      int nq) {
  __shared__ float red[kThreads / kWarp];
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= H) {
    // db and dc: a group's heads summed in head order
    const size_t e = static_cast<size_t>(blockIdx.x - H) * kThreads + tid;
    if (e >= static_cast<size_t>(B) * L * G * N) return;
    const int n = static_cast<int>(e % N);
    const size_t rest = e / N;
    const int g = static_cast<int>(rest % G);
    const size_t bl = rest / G;
    const int rep = H / G;
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < rep; ++k) {
      const size_t src = (bl * H + g * rep + k) * N + n;
      sb += db_h[src];
      sc += dc_h[src];
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
  float *dstate, *dsq_pass, *dsq_scan, *ds, *ddt_part, *db_h, *dc_h;
  float *dx, *ddt, *da_log, *db, *dc, *dh0;
  int B, L, H, G, chunk;
  cudaStream_t stream;
};

template <int P, int N, int R>
int launch_chunk(const Args& a) {
  const size_t smem = sizeof(float) * ChunkSmem<P, N, R>::kFloats;
  auto kernel = ssd_bwd_chunk_kernel<P, N, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.L / a.chunk) * (a.chunk / R);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(static_cast<unsigned>(blocks), a.H, a.B), kThreads, smem,
           a.stream>>>(a.x, a.dt, a.b, a.c, a.dy, a.s, a.states, a.dstate,
                       a.dx, a.db_h, a.dc_h, a.ds, a.ddt_part, a.dsq_scan,
                       a.L, a.H, a.G, a.chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int launch_all(const Args& a) {
  const int nc = a.L / a.chunk;
  const int rows = a.chunk < 64 ? a.chunk : 64;
  ssd_bwd_dstate_kernel<P, N><<<dim3(nc, a.H, a.B), kThreads, 0, a.stream>>>(
      a.dy, a.c, a.s, a.dstate, a.L, a.H, a.G, a.chunk);
  int err = static_cast<int>(cudaGetLastError());
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
      a.dt, a.a_log, a.ds, a.ddt_part, a.dsq_pass, a.dsq_scan, a.db_h,
      a.dc_h, a.ddt, a.da_log, a.db, a.dc, a.B, a.L, a.H, a.G, N, a.chunk,
      nblk, a.chunk / rows);
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
// and ddt_part (B, H, L), db_h and dc_h (B, L, H, N); the outputs dx,
// ddt, da_log, db, dc of their operands' shapes and dh0 (B, H, P, N).
// The chunk is 16, 32 or a multiple of 64 and divides L.
int repro_ssd_bwd(const void* x, const void* dt, const void* a_log,
                  const void* b, const void* c, const void* dy,
                  const void* s, const void* states, const void* dh_final,
                  void* dstate, void* dsq_pass, void* dsq_scan, void* ds,
                  void* ddt_part, void* db_h, void* dc_h, void* dx,
                  void* ddt, void* da_log, void* db, void* dc, void* dh0,
                  int B, int L, int H, int G, int p, int n, int chunk,
                  void* stream) {
  auto cf = [](const void* v) { return static_cast<const float*>(v); };
  auto mf = [](void* v) { return static_cast<float*>(v); };
  const Args a{cf(x), cf(dt), cf(a_log), cf(b), cf(c), cf(dy), cf(s),
               cf(states), cf(dh_final), mf(dstate), mf(dsq_pass),
               mf(dsq_scan), mf(ds), mf(ddt_part), mf(db_h), mf(dc_h),
               mf(dx), mf(ddt), mf(da_log), mf(db), mf(dc), mf(dh0), B, L,
               H, G, chunk, static_cast<cudaStream_t>(stream)};
  const int rows = chunk < 64 ? chunk : 64;
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G || B > 65535 ||
      H > 65535 || chunk < 16 || chunk % 16 || L % chunk || chunk % rows)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_pn(p, n, [&](auto P, auto N) {
    return launch_all<decltype(P)::value, decltype(N)::value>(a);
  });
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
