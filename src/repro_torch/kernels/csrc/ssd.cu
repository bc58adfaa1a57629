// Mamba-2 SSD chunked scan for Hopper (sm_90a), FP32 FFMA, hand-written,
// in Mamba-2's chunk-parallel three-pass form.
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
// leave one block per (b, h) -- 80 blocks for mamba2-2.7b at batch 1 on 132
// SMs -- walking 16 to 128 dependent chunks.  The state recurrence is
// linear, so the chain splits into three passes, and only the middle one
// is sequential:
//
//  1. ssd_chunk_state_kernel, one block per (b, h, chunk): the chunk's
//     cumulative log-decay s by a block-wide scan, written to a float32
//     scratch (B, H, L) so pass 3 does not scan again, and the chunk's own
//     state contribution S_c = X^T (B * w), a (P, N) tile, written to a
//     scratch (B, H, L/Q, P, N).  2 Q P N flops a block: bound by
//     operations.  X and B stream through a 3-stage cp.async ring of
//     16-row slabs, one barrier a slab.  128 threads each own 2 x 2 quads
//     (8 x 8 outputs at (P, N) = (64, 128)) and per step read two X
//     float4s (broadcasts) and two B float4s (neighbouring threads,
//     neighbouring addresses) for 64 FFMAs, where 4 x 8 tiles over 256
//     threads need three loads for 32.
//  2. ssd_state_pass_kernel, one thread per four state elements of a
//     (b, h): walks the chunks in order, writes h_in[c] = h over S_c in
//     place and updates h = exp(s_Q of chunk c) h + S_c.  h starts at the
//     caller's h0 (B, H, P, N) where one is given, else at 0, and the h
//     after the last chunk goes to h_final (B, H, P, N) where one is asked
//     for: a model's prefill continues from the one and leaves the other
//     as its decode state.  Elementwise, 16-byte loads prefetched one
//     chunk ahead: bound by bytes (it reads and writes the scratch once).
//  3. ssd_chunk_scan_kernel, one block per (b, h, chunk, R-row query
//     tile), R = min(chunk, 64): y = sum over key slabs of (C B^T o decay
//     o dt^T) X, plus exp(s) o (C h_in[c]^T).  Bound by operations.
//
// The skip rule.  Query tile t (rows t R .. t R + R - 1 of the chunk)
// visits only the key slabs 0 .. t: a slab above the diagonal holds no pair
// i >= j.  Only the diagonal slab has pairs i < j, and only there does the
// mask select; exp is taken of s_i - s_j only where i >= j.  The query
// tiles launch heaviest first (tile nq - 1, with nq slabs, is outermost in
// the block index), so the one-slab tiles fill the tail of the last wave.
// ssd_query_tiles and ssd_key_slabs in kernels/ssd.py say the same, and
// the CPU tests hold them against brute force over the mask.
//
// Shared memory and the staging budget of pass 3.  Each block stages the C
// rows of its query tile once (R x N), then per key slab the B rows (R x N)
// and X rows (R x P), and the decayed G^T tile (R x R).  Two stages of B
// and X would take 144 KB at (P, N, R) = (64, 128, 64), one block an SM.
// Instead the B slab and the X slab take turns as each other's second
// stage: the X slab of slab k is in flight while G of slab k is formed from
// B, and the B slab of slab k + 1 while G X of slab k runs, so every copy
// overlaps a product, with two barriers a slab.  The C h^T term comes
// first: h_in[c] (P x N) is staged in the space the X slab and G^T take
// later, and the first B slab is in flight while C h^T is formed.  So pass
// 3 takes 2 R N + max(R (P + R), P N) floats plus s and dt of the chunk:
// 100,352 bytes at chunk 256, (64, 128), and two blocks fit an SM
// (__launch_bounds__(256, 2): at most 128 registers; larger register tiles
// over fewer threads, or split sums over two halves of the block, spill or
// leave too few warps at that cap and ran slower).  Pass 1 takes 3 * 16
// (P + N) floats plus 2 Q + 4 (38,928 bytes at chunk 256).
//
// Shared-memory reads are 16-byte loads.  In pass 3, 256 threads own 4 x 4
// quads of each output tile (QuadMap).  C B^T and C h^T read C, B and h_in
// along N,
// row-major as they lie in device memory (so every copy is a 16-byte
// cp.async), with the 16-byte chunks of row r at chunk c ^ ((r / 4) & 7):
// the rows 4 q + e that the 8 threads of a load phase read fall in 8
// distinct bank groups.  G^T is stored in the same swizzle, so G X reads a
// float4 of 4 query rows (a broadcast) and a float4 of X per key step.
//
// Instantiations: pass 1 for P in {8, 16, 32, 64} and N in {8, 16, 32, 64,
// 128}; pass 3 for those and R in {16, 32, 64} (register arrays need
// compile-time sizes); pass 2 is one kernel.  The chunk is a runtime
// multiple of R (16, 32 or a multiple of 64).
//
// Work at mamba2-2.7b's (1, 4096, 80, 64, 1, 128): passes 1 and 3 launch
// B H L / Q and B H L / R blocks (1,280 and 5,120 at chunk 256), and the
// state scratch is B H (L / Q) P N floats, 41.9 MB at chunk 256 and 335.5
// MB at chunk 32: pass 1 writes it, pass 2 reads and writes it, pass 3
// reads it, bytes the function itself does not need.  Arithmetic is float32
// FFMA (67 TFLOP/s outside the tensor cores, 700 W): the reference is held
// to float32 tolerances, which TF32 cannot meet.
//
// The launchers allocate nothing (the wrapper allocates both scratches),
// never synchronise, launch on the stream they are given, and return
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <type_traits>

namespace {

constexpr int kStateThreads = 128;  // pass 1
constexpr int kScanThreads = 256;   // pass 3
constexpr int kWarp = 32;
constexpr int kPassThreads = 128;  // pass 2
constexpr int kSlab = 16;          // pass 1: rows of a slab
constexpr int kStages = 3;         // pass 1: slabs in the cp.async ring

// 4 x 4 quads of an M x C output tile over NT threads: thread (ty, tx),
// tid = ty TX + tx, owns row quads ty + TY a (a < GM) and column quads
// tx + TX t (t < GN); threads from kActive on own none
template <int M, int C, int NT>
struct QuadMap {
  static constexpr int QM = M / 4;
  static constexpr int QC = C / 4;
  static constexpr int TX = QC < 16 ? QC : 16;
  static constexpr int TY = QM < NT / TX ? QM : NT / TX;
  static constexpr int GM = QM / TY;
  static constexpr int GN = QC / TX;
  static constexpr int kActive = TX * TY;
};

// offset of 16-byte chunk c of row r in a row-major tile of W floats whose
// chunks are XOR-swizzled by the row's quad
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kMask = (W / 4 < 8 ? W / 4 : 8) - 1;
  return r * W + ((c ^ ((r >> 2) & kMask)) << 2);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ float dot4(float4 u, float4 v, float acc) {
  acc = fmaf(u.x, v.x, acc);
  acc = fmaf(u.y, v.y, acc);
  acc = fmaf(u.z, v.z, acc);
  return fmaf(u.w, v.w, acc);
}
__device__ __forceinline__ void unpack4(float4 v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
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

// cp.async of `rows` rows of W floats, row r read at src + r * stride
// (floats), into a row-major tile, swizzled or as they lie, by NT threads
template <int W, bool kSwizzle, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int rows, size_t stride, int tid) {
  constexpr int kCpr = W / 4;
  for (int idx = tid; idx < rows * kCpr; idx += NT) {
    const int r = idx / kCpr, c = idx % kCpr;
    cp_async16(dst + (kSwizzle ? swz<W>(r, c) : r * W + 4 * c),
               src + r * stride + 4 * c);
  }
}

// in-place inclusive prefix sum of v[0 .. n) by the whole block: each
// thread sums a run of ceil(n / kStateThreads) neighbours, the runs are
// scanned across a warp by shuffles and across the warps through `sums`;
// ends with a barrier
__device__ void block_inclusive_scan(float* v, int n, float* sums) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int per = (n + kStateThreads - 1) / kStateThreads;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  float run = 0.0f;
  for (int t = lo; t < hi; ++t) {
    run += v[t];
    v[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < kWarp; off *= 2) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == kWarp - 1) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kStateThreads / kWarp;
    float tot = lane < kWarps ? sums[lane] : 0.0f;
#pragma unroll
    for (int off = 1; off < kWarps; off *= 2) {
      const float up = __shfl_up_sync(0xffffffffu, tot, off);
      if (lane >= off) tot += up;
    }
    if (lane < kWarps) sums[lane] = tot;
  }
  __syncthreads();
  const float before = incl - run + (warp > 0 ? sums[warp - 1] : 0.0f);
  for (int t = lo; t < hi; ++t) v[t] += before;
  __syncthreads();
}

// ---------------------------------------------------------------- pass 1 --
template <int P, int N>
__host__ __device__ constexpr size_t state_smem_floats(int chunk) {
  return static_cast<size_t>(kStages) * kSlab * (P + N) + 2 * chunk +
         kStateThreads / kWarp;
}

template <int P, int N>
__global__ void __launch_bounds__(kStateThreads, 4)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ a_log,
                       const float* __restrict__ bm, float* __restrict__ s,
                       float* __restrict__ states, int L, int H, int G,
                       int chunk) {
  using Map = QuadMap<P, N, kStateThreads>;
  constexpr int kStage = kSlab * (P + N);  // one X slab, one B slab
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* ss = ring + kStages * kStage;  // s of the chunk
  float* ws = ss + chunk;               // dt, then w
  float* sums = ws + chunk;             // the warps' totals of the scan

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int nc = L / chunk;
  const size_t t0 = static_cast<size_t>(b) * L +
                    static_cast<size_t>(c) * chunk;
  const float* xg = x + (t0 * H + h) * P;  // step j at + j H P
  const float* bg = bm + (t0 * G + g) * N;  // step j at + j G N

  auto load_slab = [&](int stage, int j0) {
    float* xs = ring + stage * kStage;
    load_rows<P, false, kStateThreads>(
        xs, xg + static_cast<size_t>(j0) * H * P, kSlab,
        static_cast<size_t>(H) * P, tid);
    load_rows<N, false, kStateThreads>(
        xs + kSlab * P, bg + static_cast<size_t>(j0) * G * N, kSlab,
        static_cast<size_t>(G) * N, tid);
  };
  const int nslab = chunk / kSlab;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nslab) load_slab(st, st * kSlab);
    cp_async_commit();
  }

  // the cumulative log-decay, while the first slabs are in flight
  const float a = -expf(a_log[h]);
  for (int t = tid; t < chunk; t += kStateThreads) {
    const float d = dt[(t0 + t) * H + h];
    ws[t] = d;
    ss[t] = a * d;
  }
  __syncthreads();
  block_inclusive_scan(ss, chunk, sums);
  const float s_last = ss[chunk - 1];
  float* s_row = s + (static_cast<size_t>(b) * H + h) * L +
                 static_cast<size_t>(c) * chunk;
  for (int t = tid; t < chunk; t += kStateThreads) {
    s_row[t] = ss[t];
    ws[t] *= expf(s_last - ss[t]);  // read after the first slab barrier
  }

  const int tx = tid % Map::TX, ty = tid / Map::TX;
  const bool active = tid < Map::kActive;
  float acc[4 * Map::GM][4 * Map::GN];
#pragma unroll
  for (int i = 0; i < 4 * Map::GM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * Map::GN; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < nslab; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slab k landed
    __syncthreads();  // everyone's landed; slab k - 1 is read by no one
    const int pre = k + kStages - 1;
    if (pre < nslab) load_slab(pre % kStages, pre * kSlab);
    cp_async_commit();  // empty groups keep the wait count uniform
    if (!active) continue;
    const float* xs = ring + (k % kStages) * kStage;
    const float* bs = xs + kSlab * P;
#pragma unroll
    for (int j = 0; j < kSlab; ++j) {
      const float w = ws[k * kSlab + j];
      float xv[4 * Map::GM], bv[4 * Map::GN];
#pragma unroll
      for (int q = 0; q < Map::GM; ++q) {
        unpack4(load4(xs + j * P + 4 * (ty + Map::TY * q)), xv + 4 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[4 * q + e] *= w;
      }
#pragma unroll
      for (int q = 0; q < Map::GN; ++q)
        unpack4(load4(bs + j * N + 4 * (tx + Map::TX * q)), bv + 4 * q);
#pragma unroll
      for (int i = 0; i < 4 * Map::GM; ++i)
#pragma unroll
        for (int t = 0; t < 4 * Map::GN; ++t)
          acc[i][t] = fmaf(xv[i], bv[t], acc[i][t]);
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  float* out = states + ((static_cast<size_t>(b) * H + h) * nc + c) * P * N;
#pragma unroll
  for (int i = 0; i < 4 * Map::GM; ++i) {
    const int p = 4 * (ty + Map::TY * (i / 4)) + i % 4;
#pragma unroll
    for (int q = 0; q < Map::GN; ++q)
      store4(out + p * N + 4 * (tx + Map::TX * q), acc[i][4 * q],
             acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
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
// the slabs' space: a B slab, an X slab and G^T, or a B slab and h_in
template <int P, int N, int R>
__host__ __device__ constexpr int scan_union_floats() {
  return R * (P + R) > P * N ? R * (N + P + R) : R * N + P * N;
}

template <int P, int N, int R>
__host__ __device__ constexpr size_t scan_smem_floats(int chunk) {
  return static_cast<size_t>(R) * N + scan_union_floats<P, N, R>() +
         2 * chunk;
}

template <int P, int N, int R>
__global__ void __launch_bounds__(kScanThreads, 2)
ssd_chunk_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ s,
                      const float* __restrict__ states,
                      float* __restrict__ y, int B, int L, int H, int G,
                      int chunk) {
  constexpr int NT = kScanThreads;
  using MapG = QuadMap<R, R, NT>;
  using MapY = QuadMap<R, P, NT>;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;         // R x N, swizzled: C rows of the query tile
  float* bs = cs + R * N;   // R x N, swizzled: B rows of the key slab
  float* xs = bs + R * N;   // R x P: X rows of the key slab
  float* gt = xs + R * P;   // R x R, swizzled: G^T of the slab
  float* hs = xs;           // P x N, swizzled: h_in, before the X slabs
  float* ss = bs + scan_union_floats<P, N, R>();  // s of steps 0 .. r0 + R
  float* dts = ss + chunk;  // dt of the same steps

  const int tid = threadIdx.x;
  const int nc = L / chunk, nq = chunk / R;
  const int per_tile = B * H * nc;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / per_tile;
  int rem = static_cast<int>(blockIdx.x) % per_tile;
  const int h = rem % H;  // neighbouring blocks share B and C rows in L2
  rem /= H;
  const int c = rem % nc, b = rem / nc;
  const int g = h / (H / G);
  const int r0 = qt * R;
  const size_t t0 = static_cast<size_t>(b) * L +
                    static_cast<size_t>(c) * chunk;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* xg = x + (t0 * H + h) * P;   // step j at + j H P
  const float* bg = bm + (t0 * G + g) * N;  // step j at + j G N
  const float* cg = cm + (t0 * G + g) * N;
  const size_t xstride = static_cast<size_t>(H) * P;
  const size_t bstride = static_cast<size_t>(G) * N;

  load_rows<N, true, NT>(cs, cg + r0 * bstride, R, bstride, tid);
  load_rows<N, true, NT>(hs, states + (bh * nc + c) * P * N, P, N, tid);
  cp_async_commit();
  load_rows<N, true, NT>(bs, bg, R, bstride, tid);
  cp_async_commit();  // B of slab 0, in flight while C h^T is formed
  const float* s_chunk = s + bh * L + static_cast<size_t>(c) * chunk;
  for (int t = tid; t < r0 + R; t += NT) {
    ss[t] = s_chunk[t];
    dts[t] = dt[(t0 + t) * H + h];
  }
  cp_async_wait<1>();  // C and h_in
  __syncthreads();

  // the inter-chunk term first: y = exp(s_i) (C h_in^T)_ip
  const int ytx = tid % MapY::TX, yty = tid / MapY::TX;
  const bool yactive = tid < MapY::kActive;
  float yacc[4 * MapY::GM][4 * MapY::GN];
#pragma unroll
  for (int i = 0; i < 4 * MapY::GM; ++i)
#pragma unroll
    for (int t = 0; t < 4 * MapY::GN; ++t) yacc[i][t] = 0.0f;
  if (yactive) {
#pragma unroll 4
    for (int q = 0; q < N / 4; ++q) {
      float4 cv[4 * MapY::GM], hv[4 * MapY::GN];
#pragma unroll
      for (int i = 0; i < 4 * MapY::GM; ++i)
        cv[i] = load4(cs + swz<N>(4 * (yty + MapY::TY * (i / 4)) + i % 4, q));
#pragma unroll
      for (int t = 0; t < 4 * MapY::GN; ++t)
        hv[t] = load4(hs + swz<N>(4 * (ytx + MapY::TX * (t / 4)) + t % 4, q));
#pragma unroll
      for (int i = 0; i < 4 * MapY::GM; ++i)
#pragma unroll
        for (int t = 0; t < 4 * MapY::GN; ++t)
          yacc[i][t] = dot4(cv[i], hv[t], yacc[i][t]);
    }
#pragma unroll
    for (int i = 0; i < 4 * MapY::GM; ++i) {
      const float es =
          expf(ss[r0 + 4 * (yty + MapY::TY * (i / 4)) + i % 4]);
#pragma unroll
      for (int t = 0; t < 4 * MapY::GN; ++t) yacc[i][t] *= es;
    }
  }

  const int gtx = tid % MapG::TX, gty = tid / MapG::TX;
  const bool gactive = tid < MapG::kActive;
  // key slabs 0 .. qt: none lies above the diagonal
  for (int k = 0; k <= qt; ++k) {
    const int j0 = k * R;
    cp_async_wait<0>();  // B of slab k
    __syncthreads();     // ... landed for all; h_in, or X and G^T of slab
                         // k - 1, read by all
    load_rows<P, false, NT>(xs, xg + j0 * xstride, R, xstride, tid);
    cp_async_commit();   // X of slab k, in flight while G is formed

    if (gactive) {
      float gacc[4 * MapG::GM][4 * MapG::GN];
#pragma unroll
      for (int i = 0; i < 4 * MapG::GM; ++i)
#pragma unroll
        for (int t = 0; t < 4 * MapG::GN; ++t) gacc[i][t] = 0.0f;
#pragma unroll 4
      for (int q = 0; q < N / 4; ++q) {
        float4 cv[4 * MapG::GM], bv[4 * MapG::GN];
#pragma unroll
        for (int i = 0; i < 4 * MapG::GM; ++i)
          cv[i] =
              load4(cs + swz<N>(4 * (gty + MapG::TY * (i / 4)) + i % 4, q));
#pragma unroll
        for (int t = 0; t < 4 * MapG::GN; ++t)
          bv[t] =
              load4(bs + swz<N>(4 * (gtx + MapG::TX * (t / 4)) + t % 4, q));
#pragma unroll
        for (int i = 0; i < 4 * MapG::GM; ++i)
#pragma unroll
          for (int t = 0; t < 4 * MapG::GN; ++t)
            gacc[i][t] = dot4(cv[i], bv[t], gacc[i][t]);
      }
      // decay, mask and dt; exp only where i >= j.  Stored transposed: a
      // float4 holds four query rows of one key column.
#pragma unroll
      for (int t = 0; t < 4 * MapG::GN; ++t) {
        const int j = 4 * (gtx + MapG::TX * (t / 4)) + t % 4;
        const int kj = j0 + j;
        const float sj = ss[kj], dj = dts[kj];
#pragma unroll
        for (int a = 0; a < MapG::GM; ++a) {
          const int iq = gty + MapG::TY * a;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = r0 + 4 * iq + e;
            v[e] = qi >= kj ? gacc[4 * a + e][t] * expf(ss[qi] - sj) * dj
                            : 0.0f;
          }
          store4(gt + swz<R>(j, iq), v[0], v[1], v[2], v[3]);
        }
      }
    }
    cp_async_wait<0>();  // X of slab k
    __syncthreads();     // ... landed for all; G^T written; B slab read
    if (k < qt)
      load_rows<N, true, NT>(bs, bg + (j0 + R) * bstride, R, bstride, tid);
    cp_async_commit();   // B of slab k + 1, in flight while G X runs

    if (yactive) {
#pragma unroll 4
      for (int j = 0; j < R; ++j) {
        float gv[4 * MapY::GM], xv[4 * MapY::GN];
#pragma unroll
        for (int a = 0; a < MapY::GM; ++a)
          unpack4(load4(gt + swz<R>(j, yty + MapY::TY * a)), gv + 4 * a);
#pragma unroll
        for (int q = 0; q < MapY::GN; ++q)
          unpack4(load4(xs + j * P + 4 * (ytx + MapY::TX * q)), xv + 4 * q);
#pragma unroll
        for (int i = 0; i < 4 * MapY::GM; ++i)
#pragma unroll
          for (int t = 0; t < 4 * MapY::GN; ++t)
            yacc[i][t] = fmaf(gv[i], xv[t], yacc[i][t]);
      }
    }
  }
  cp_async_wait<0>();
  if (!yactive) return;
#pragma unroll
  for (int i = 0; i < 4 * MapY::GM; ++i) {
    const size_t row = t0 + r0 + 4 * (yty + MapY::TY * (i / 4)) + i % 4;
#pragma unroll
    for (int q = 0; q < MapY::GN; ++q)
      store4(y + (row * H + h) * P + 4 * (ytx + MapY::TX * q),
             yacc[i][4 * q], yacc[i][4 * q + 1], yacc[i][4 * q + 2],
             yacc[i][4 * q + 3]);
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
  int B, L, H, G, P, N, chunk;
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
  const size_t smem = sizeof(float) * state_smem_floats<P, N>(a.chunk);
  auto kernel = ssd_chunk_state_kernel<P, N>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.L / a.chunk, a.H, a.B);
  kernel<<<grid, kStateThreads, smem, a.stream>>>(
      a.x, a.dt, a.a_log, a.b, a.s, a.states, a.L, a.H, a.G, a.chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N, int R>
int launch_chunk_scan(const Args& a) {
  const size_t smem = sizeof(float) * scan_smem_floats<P, N, R>(a.chunk);
  auto kernel = ssd_chunk_scan_kernel<P, N, R>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(a.B) * a.H *
                           (a.L / a.chunk) * (a.chunk / R);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kScanThreads, smem, a.stream>>>(
      a.x, a.dt, a.b, a.c, a.s, a.states, a.y, a.B, a.L, a.H, a.G, a.chunk);
  return static_cast<int>(cudaGetLastError());
}

bool valid(const Args& a) {
  return a.B > 0 && a.L > 0 && a.H > 0 && a.G > 0 && a.H % a.G == 0 &&
         a.B <= 65535 && a.H <= 65535 && a.chunk >= kSlab &&
         a.chunk % kSlab == 0 && a.L % a.chunk == 0;
}

}  // namespace

extern "C" {

// float32 only.  The caller guarantees contiguous operands on the current
// device, s (B, H, L) and states (B, H, L / chunk, P, N) float32, and a
// chunk that is 16, 32 or a multiple of 64 and divides L.

// pass 1: s and each chunk's own state contribution S_c
int repro_ssd_chunk_state(const void* x, const void* dt, const void* a_log,
                          const void* b, void* s, void* states, int B, int L,
                          int H, int G, int p, int n, int chunk,
                          void* stream) {
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(a_log), static_cast<const float*>(b),
               nullptr, static_cast<float*>(s), static_cast<float*>(states),
               nullptr, B, L, H, G, p, n, chunk,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
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
               static_cast<cudaStream_t>(stream)};
  if (!valid(a) || p <= 0 || n <= 0 || (p * n) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pn4 = p * n / 4;
  const dim3 grid((pn4 + kPassThreads - 1) / kPassThreads, H, B);
  ssd_state_pass_kernel<<<grid, kPassThreads, 0, a.stream>>>(
      a.states, a.s, static_cast<const float*>(h0),
      static_cast<float*>(h_final), L, H, chunk, pn4);
  return static_cast<int>(cudaGetLastError());
}

// pass 3: y from the chunk's key slabs and h_in
int repro_ssd_chunk_scan(const void* x, const void* dt, const void* b,
                         const void* c, const void* s, const void* states,
                         void* y, int B, int L, int H, int G, int p, int n,
                         int chunk, void* stream) {
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               nullptr, static_cast<const float*>(b),
               static_cast<const float*>(c),
               const_cast<float*>(static_cast<const float*>(s)),
               const_cast<float*>(static_cast<const float*>(states)),
               static_cast<float*>(y), B, L, H, G, p, n, chunk,
               static_cast<cudaStream_t>(stream)};
  const int rows = chunk < 64 ? chunk : 64;
  if (!valid(a) || chunk % rows)
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
