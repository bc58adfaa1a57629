// Copy and tensor-core tools shared by the mma.sync routes: the attention
// forward's (flash_attention.cu), the attention backward's
// (flash_attention_bwd.cu) and the SSD backward's (ssd_bwd.cu).  cp.async
// copies into row-major tiles whose
// 16-byte chunks are XOR-swizzled by the row, ldmatrix into mma.sync
// fragments, bfloat16 products as m16n8k16 and float32 products as three
// TF32 m16n8k8 products (hi hi + hi lo + lo hi), the conversion of an
// accumulator into the A fragment of the next product, and the
// round-to-nearest add that keeps tensor-core accumulation chains short.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------- copies --

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
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
template <typename T, int D, int kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows,
                                          int tid) {
  using S = Swizzled<T, D>;
  for (int idx = tid; idx < rows * S::kCpr; idx += kThreads) {
    const int r = idx / S::kCpr, c = idx % S::kCpr;
    cp_async16(dst + r * D + (c ^ (r & S::kMask)) * S::kEpc,
               src + static_cast<size_t>(r) * D + c * S::kEpc);
  }
}

// --------------------------------------------------- tensor cores --

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b, m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
// two floats as a bf16x2 register (first in the low half), rounded once
__device__ __forceinline__ unsigned pack_bf16(float first, float second) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(first, second);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Fragments.  A is 16 x K of the thread's rows g, g + 8 (g = lane / 4); B
// is K x 8; the m16n8 accumulator holds rows g, g + 8 at columns 2t, 2t + 1
// (t = lane % 4).  float32 operands are kept as their TF32 hi and lo parts.
struct BfA { unsigned x[4]; };           // bf16 A
struct BfA2 { unsigned hi[4], lo[4]; };  // bf16 A as hi + lo (dS)
struct BfB { unsigned x[2]; };
struct TfA { unsigned hi[4], lo[4]; };
struct TfB { unsigned hi[2], lo[2]; };

// An m16n8 tile of s or dP.  Tensor-core accumulation truncates, so in
// float32 the small hi lo and lo hi terms run in an accumulator of their
// own and the chain of hi hi products over D is a third as long.
struct BfTile {
  float c[4];
  __device__ __forceinline__ float get(int e) const { return c[e]; }
};
struct TfTile {
  float c[4], corr[4];
  __device__ __forceinline__ float get(int e) const { return c[e] + corr[e]; }
};

template <typename T>
struct Mma;
template <>
struct Mma<bf16> {
  static constexpr int K = 16;  // depth of one product
  using A = BfA;                // operands from shared memory, round(p)
  using ASplit = BfA2;          // dS
  using B = BfB;
  using Tile = BfTile;
};
template <>
struct Mma<float> {
  static constexpr int K = 8;
  using A = TfA;
  using ASplit = TfA;
  using B = TfB;
  using Tile = TfTile;
};

__device__ __forceinline__ void mma(float (&c)[4], const BfA& a,
                                    const BfB& b) {
  mma_bf16(c, a.x, b.x);
}
__device__ __forceinline__ void mma(float (&c)[4], const BfA2& a,
                                    const BfB& b) {
  mma_bf16(c, a.lo, b.x);
  mma_bf16(c, a.hi, b.x);
}
// 3xTF32: the small terms first
__device__ __forceinline__ void mma(float (&c)[4], const TfA& a,
                                    const TfB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}
__device__ __forceinline__ void mma(BfTile& t, const BfA& a, const BfB& b) {
  mma_bf16(t.c, a.x, b.x);
}
__device__ __forceinline__ void mma(TfTile& t, const TfA& a, const TfB& b) {
  mma_tf32(t.corr, a.lo, b.hi);
  mma_tf32(t.corr, a.hi, b.lo);
  mma_tf32(t.c, a.hi, b.hi);
}

template <int N>
__device__ __forceinline__ void split_all(const unsigned (&raw)[N],
                                          unsigned (&hi)[N],
                                          unsigned (&lo)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) split_tf32(__uint_as_float(raw[e]), hi[e], lo[e]);
}

// A fragment of rows [row0, row0 + 16) and columns [k0, k0 + K) of a
// swizzled tile (its rows are the product's M, its columns the depth)
template <int D>
__device__ __forceinline__ void load_a(BfA& a, const bf16* tile, int row0,
                                       int k0, int lane) {
  using S = Swizzled<bf16, D>;
  ldmatrix_x4(a.x, tile + S::at(row0 + (lane & 15), k0 + (lane >> 4) * 8));
}
template <int D>
__device__ __forceinline__ void load_a(TfA& a, const float* tile, int row0,
                                       int k0, int lane) {
  using S = Swizzled<float, D>;
  unsigned raw[4];
  ldmatrix_x4(raw, tile + S::at(row0 + (lane & 15), k0 + (lane >> 4) * 4));
  split_all(raw, a.hi, a.lo);
}

// B fragments of two n-tiles [n0, n0 + 16) at depth [k0, k0 + K) from a
// tile whose rows are n (the depth runs along the row): non-transposed
template <int D>
__device__ __forceinline__ void load_b(BfB& b0, BfB& b1, const bf16* tile,
                                       int n0, int k0, int lane) {
  using S = Swizzled<bf16, D>;
  unsigned r[4];
  ldmatrix_x4(r, tile + S::at(n0 + (lane & 7) + ((lane >> 4) << 3),
                              k0 + ((lane >> 3) & 1) * 8));
  b0.x[0] = r[0];
  b0.x[1] = r[1];
  b1.x[0] = r[2];
  b1.x[1] = r[3];
}
template <int D>
__device__ __forceinline__ void load_b(TfB& b0, TfB& b1, const float* tile,
                                       int n0, int k0, int lane) {
  using S = Swizzled<float, D>;
  unsigned r[4];
  ldmatrix_x4(r, tile + S::at(n0 + (lane & 7) + ((lane >> 4) << 3),
                              k0 + ((lane >> 3) & 1) * 4));
  split_tf32(__uint_as_float(r[0]), b0.hi[0], b0.lo[0]);
  split_tf32(__uint_as_float(r[1]), b0.hi[1], b0.lo[1]);
  split_tf32(__uint_as_float(r[2]), b1.hi[0], b1.lo[0]);
  split_tf32(__uint_as_float(r[3]), b1.hi[1], b1.lo[1]);
}

// B fragments of two n-tiles [n0, n0 + 16) at depth [k0, k0 + K) from a
// tile whose rows are the depth (k-major): ldmatrix.trans for bf16; for
// float32 two loads a fragment in the permuted depth order (slot t is row
// k0 + 2t, slot t + 4 row k0 + 2t + 1), which a_from_acc matches
template <int D>
__device__ __forceinline__ void load_bt(BfB& b0, BfB& b1, const bf16* tile,
                                        int k0, int n0, int lane) {
  using S = Swizzled<bf16, D>;
  unsigned r[4];
  ldmatrix_x4_trans(r, tile + S::at(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    n0 + (lane >> 4) * 8));
  b0.x[0] = r[0];
  b0.x[1] = r[1];
  b1.x[0] = r[2];
  b1.x[1] = r[3];
}
template <int D>
__device__ __forceinline__ void load_bt(TfB& b0, TfB& b1, const float* tile,
                                        int k0, int n0, int lane) {
  using S = Swizzled<float, D>;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = k0 + 2 * t;
  split_tf32(tile[S::at(r0, n0 + g)], b0.hi[0], b0.lo[0]);
  split_tf32(tile[S::at(r0 + 1, n0 + g)], b0.hi[1], b0.lo[1]);
  split_tf32(tile[S::at(r0, n0 + 8 + g)], b1.hi[0], b1.lo[0]);
  split_tf32(tile[S::at(r0 + 1, n0 + 8 + g)], b1.hi[1], b1.lo[1]);
}

// The A fragment of depth step kk from accumulator tiles whose columns are
// the depth: bf16 tiles 2 kk and 2 kk + 1 (rounded once, or hi + lo);
// float32 tile kk in the permuted order of load_bt.
template <int NT>
__device__ __forceinline__ void a_from_acc(BfA& a, const float (&c)[NT][4],
                                           int kk) {
  a.x[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a.x[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a.x[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a.x[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}
// two floats as bf16x2 registers hi (returned) and lo = bf16(x - hi)
__device__ __forceinline__ unsigned split_bf16(float first, float second,
                                               unsigned& lo) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(first, second);
  const float2 back = __bfloat1622float2(hi);
  lo = pack_bf16(first - back.x, second - back.y);
  return *reinterpret_cast<const unsigned*>(&hi);
}
template <int NT>
__device__ __forceinline__ void a_from_acc(BfA2& a, const float (&c)[NT][4],
                                           int kk) {
  a.hi[0] = split_bf16(c[2 * kk][0], c[2 * kk][1], a.lo[0]);
  a.hi[1] = split_bf16(c[2 * kk][2], c[2 * kk][3], a.lo[1]);
  a.hi[2] = split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], a.lo[2]);
  a.hi[3] = split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], a.lo[3]);
}
template <int NT>
__device__ __forceinline__ void a_from_acc(TfA& a, const float (&c)[NT][4],
                                           int kk) {
  split_tf32(c[kk][0], a.hi[0], a.lo[0]);  // row g,     depth slot t
  split_tf32(c[kk][2], a.hi[1], a.lo[1]);  // row g + 8, slot t
  split_tf32(c[kk][1], a.hi[2], a.lo[2]);  // row g,     slot t + 4
  split_tf32(c[kk][3], a.hi[3], a.lo[3]);  // row g + 8, slot t + 4
}

// two neighbouring outputs of one row, cast to T
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Tensor-core accumulators truncate, so a long chain of mma into one
// accumulator drifts (tests/test_torch_attention_bwd_tc.py emulates it).
// A chunk's products into an output tile therefore start from zero and are
// added to the float32 accumulators with FADD (round to nearest).
template <int N>
__device__ __forceinline__ void add_tiles(float (&acc)[N][4], int n0,
                                          const float (&part)[2][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[n0][e] += part[0][e];
    acc[n0 + 1][e] += part[1][e];
  }
}

}  // namespace
