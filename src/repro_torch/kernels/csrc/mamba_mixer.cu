// The Mamba-2 mixer's elementwise glue for Hopper (sm_90a), hand-written:
// the pass that turns the in-projection's output into the SSD kernel's
// operands, the D skip with the gated RMSNorm, and both backwards, which
// write one gradient buffer for the in-projection's output.
//
// Replaces: no Pallas body.  The reference's mamba_forward
// (src/repro/models/mamba.py:95-137) runs under jit, where XLA fuses
// everything between its two products: the split of zxbcdt (:105-109),
// softplus(dt + dt_bias) (:110), the D skip (:126), the round to the model's
// dtype (:127) and the gated RMSNorm (:129-131), and, under grad, their
// backwards.  The port runs eagerly: its plain version (kernels/
// mamba_mixer.py) is some 22 elementwise launches a layer forward and 35
// backward, each writing and reading back a float32 temporary of the
// layer's (tokens, d_inner) width.  These four kernels are that fusion.
//
// What it computes, per token row r of zxbcdt (rows = B S; columns z
// [0, di), x [di, 2 di), b, c (G N each), dt (H); T the model's dtype,
// bfloat16 or float32):
//  * mamba_in_kernel: x, b and c as float32, dt = softplus(dt + dt_bias)
//    (torch's threshold of 20), each into its own contiguous tensor: the
//    SSD kernel's operands.  zxbcdt is read in place through its strides.
//  * mamba_out_kernel: y_pre = y + d_skip[h] x (a product, then a sum: no
//    contracted FMA), y_t = round_T(y_pre), u = y_t silu(z), r =
//    rsqrt(mean(u^2) + 1e-6), out = round_T((u r)(1 + norm_g)); r saved.
//  * mamba_out_bwd_kernel: from d_out, the autograd of that chain with the
//    plain version's rounding points: a = d_out (1 + g), dr = sum(a u),
//    du = a r + 2 u (-0.5 dr r^3) / di, dy = round_T(du silu(z)) as float32
//    (y_pre's gradient after the round trip through T, which the SSD
//    backward takes), dz = round_T(du y_t silu'(z)) into the z columns of
//    the gradient buffer; the column sums of d_out (u r) (norm_g's
//    gradient) and of dy x (d_skip's, summed over each head's P columns).
//  * mamba_in_bwd_kernel: the other columns of the gradient buffer: x
//    round_T(dx + d_skip[h] dy), b and c round_T(db), round_T(dc), dt
//    round_T(ddt sigmoid(dt + dt_bias)) (ddt itself above the threshold);
//    the column sums of the dt gradient (dt_bias's).
// Each sum over tokens is a per-block partial (a block owns a fixed range of
// rows, a thread fixed columns, summed in row order) and a one-launch
// finish that adds the partials in block order: no atomics, and the grid
// depends on the row count alone, so two calls give the same bits.
//
// What bounds it on the H100 (3.35 TB/s): bytes.  At mamba2-2.7b's width
// (di 5120, 4096 tokens, bfloat16) the four move about 0.13, 0.21, 0.34
// and 0.22 GB, some 1-35 flops an element.  The design moves each byte
// once, in 16-byte loads and stores (8 elements of bfloat16, two float4 of
// float32):
//  * mamba_in lays the (row, 8-column chunk) pairs out flat, four loads a
//    thread in flight before its stores;
//  * mamba_out gives a row one block and a chunk one thread (ceil(di / 8)
//    threads, up to 1024: di <= 8192), the thread's chunk held in
//    registers across the row's block-wide sum;
//  * mamba_out_bwd has the same row blocks, each owning a fixed range of
//    rows, and keeps the memory busy across the row's sum: each thread
//    copies its own chunk of the rows ahead (d_out, x, z and y) into its
//    own slots of a ring of 2-4 stages in shared memory (cp.async, so no
//    thread waits on another's copies), row r + stages - 1 in flight while
//    row r is summed and written; the row sum takes one barrier, y_t stays
//    in registers across it and sigmoid(z) in the thread's own slots, the
//    second pass rereads d_out, x and z from the stage, and norm_g's 8
//    column sums and d_skip's sum a thread owns stay in registers until
//    the block's end.  Rows of at most 5120 columns (640 threads) compile
//    with 96 registers a thread, wider ones with 64 and take a chunk in
//    halves.  Where two whole stages do not fit (float32 above di 6400)
//    the ring holds d_out, x and z and y is read from global memory;
//  * mamba_in_bwd lays the x, b and c columns' (row, chunk) pairs out
//    flat, four a thread with every load issued before its stores, a
//    chunk's head found by a multiply (no division); the dt columns are
//    the launch's first blocks, a fixed row group each, 16-byte loads.
// A row whose offsets are not all multiples of 8 elements, or whose head
// dim P is not (the reduced widths of the tests), takes a scalar path of
// the same arithmetic (the backwards' column sums there in shared memory).
//
// The wrapper (kernels/mamba_mixer.py) allocates every output and the
// partials' scratch (as many rows as row_groups gives, by the same rule),
// checks dtypes and shapes, and launches on PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;        // elements a vector step
constexpr int kCap = 1;          // chunks a thread holds (vector path)
constexpr int kCapScalar = 8;    // elements a thread holds (scalar path)
constexpr int kMaxThreads = 1024;  // the out passes' blocks, at most
// mamba_out_bwd's vector kernel for rows of at most 8 x this many columns
// (mamba2-2.7b's 5120) has the registers of a 640-thread block
constexpr int kNarrowThreads = 640;
constexpr int kFinishThreads = 1024;
constexpr int kRowThreads = 256; // the in passes' blocks
constexpr int kDtCap = 4;        // dt columns a thread of mamba_in_bwd owns
constexpr int kInItems = 4;      // chunks a thread of mamba_in loads at once
constexpr int kInBwdItems = 4;   // chunks a thread of mamba_in_bwd loads
// row groups of the backwards' partials: mamba_out_bwd's sums are d_inner
// wide (one group a block, one block an SM: a single wave on 132 SMs),
// mamba_in_bwd's H (the dt columns' blocks)
constexpr int kOutBwdBlocks = 128;
constexpr int kInBwdBlocks = 128;
// mamba_out_bwd's ring: at most this many stages, in the shared memory a
// block may opt in to on sm_90 (227 KB) less its static row-sum buffers
constexpr int kMaxStages = 4;
constexpr int kSmemBlock = 232448;
constexpr int kRedStride = 32;   // a row-sum buffer: a float a warp
constexpr float kEps = 1e-6f;
constexpr float kThreshold = 20.0f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back (the model dtype's rounding)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float2 bf2_to_f2(unsigned int bits) {
  __nv_bfloat162 h;
  *reinterpret_cast<unsigned int*>(&h) = bits;
  return __bfloat1622float2(h);
}

__device__ __forceinline__ unsigned int f2_to_bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned int*>(&h);
}

// eight consecutive elements as float; p 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float (&v)[kChunk]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kChunk]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned int w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = bf2_to_f2(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// eight values stored as T, each rounded to nearest even
__device__ __forceinline__ void store8(float* p, const float (&v)[kChunk]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kChunk]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(f2_to_bf2(v[0], v[1]), f2_to_bf2(v[2], v[3]),
                 f2_to_bf2(v[4], v[5]), f2_to_bf2(v[6], v[7]));
}

// four values stored as T (16-byte aligned float32, 8-byte bfloat16)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(f2_to_bf2(v[0], v[1]), f2_to_bf2(v[2], v[3]));
}

// element i of a per-head or per-channel vector, float32 or bfloat16
__device__ __forceinline__ float vec_at(const void* p, int bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// eight consecutive elements of a per-channel vector (16-byte aligned)
__device__ __forceinline__ void load8_vec(const void* p, int bf16, int i,
                                          float (&v)[kChunk]) {
  if (bf16)
    load8(static_cast<const __nv_bfloat16*>(p) + i, v);
  else
    load8(static_cast<const float*>(p) + i, v);
}

// four consecutive elements as float (16-byte aligned float32, 8-byte
// aligned bfloat16)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = bf2_to_f2(a.x), hi = bf2_to_f2(a.y);
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

// kE (8 or 4) consecutive elements as float, and stored as T: a chunk or
// half of one
template <int kE, typename P>
__device__ __forceinline__ void load_part(const P* p, float (&v)[kE]) {
  if constexpr (kE == kChunk)
    load8(p, v);
  else
    load4(p, v);
}
template <int kE>
__device__ __forceinline__ void load_part_vec(const void* p, int bf16, int i,
                                              float (&v)[kE]) {
  if (bf16)
    load_part<kE>(static_cast<const __nv_bfloat16*>(p) + i, v);
  else
    load_part<kE>(static_cast<const float*>(p) + i, v);
}
template <int kE, typename P>
__device__ __forceinline__ void store_part(P* p, const float (&v)[kE]) {
  if constexpr (kE == kChunk)
    store8(p, v);
  else
    store4(p, v);
}

// torch's softplus (beta 1, threshold 20) and silu, and their backwards
__device__ __forceinline__ float softplus(float v) {
  return v > kThreshold ? v : log1pf(expf(v));
}
__device__ __forceinline__ float softplus_grad(float g, float v) {
  if (v > kThreshold) return g;
  const float z = expf(v);
  return __fdiv_rn(__fmul_rn(g, z), __fadd_rn(z, 1.0f));
}
// sigmoid(z) = 1 / (1 + exp(-z)) by one IEEE reciprocal; silu(z) = z s
__device__ __forceinline__ float sigmoid(float z) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-z)));
}
// silu's backward from s = sigmoid(z): g s (1 + z (1 - s))
__device__ __forceinline__ float silu_grad(float g, float z, float s) {
  return __fmul_rn(__fmul_rn(g, s),
                   __fadd_rn(1.0f, __fmul_rn(z, __fsub_rn(1.0f, s))));
}

// A block's sum in a fixed order (butterfly within each warp, the warps in
// order by thread 0), returned to every thread.  red: 33 floats of shared
// memory, free again when it returns.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
    red[32] = s;
  }
  __syncthreads();
  const float s = red[32];
  __syncthreads();
  return s;
}

// A row's sum in block_sum's order (and bits) with one barrier: each
// warp's butterfly sum into `red` (kRedStride floats, 16-byte aligned),
// then every thread adds the warps' sums in order itself, four at a time.
// The caller alternates `red` between two buffers from row to row, so a
// row's writes never meet the last row's reads.
__device__ __forceinline__ float row_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  const int nw = static_cast<int>(blockDim.x >> 5);
  float s = 0.0f;
  for (int w = 0; w < nw; w += 4) {
    const float4 q = *reinterpret_cast<const float4*>(red + w);
    s += q.x;
    if (w + 1 < nw) s += q.y;
    if (w + 2 < nw) s += q.z;
    if (w + 3 < nw) s += q.w;
  }
  return s;
}

// 16 bytes from global into shared memory, asynchronously (cp.async,
// cached in L2 only); both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* smem, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n (< kMaxStages) of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

// Part h of a thread's chunk of T (kE elements: the chunk, or half of
// it) from its 16-byte slots in shared memory: a bfloat16 chunk is one
// slot, a float32 chunk two, n slots apart.
template <typename T, int kE>
__device__ __forceinline__ void slot_part(const uint4* s, int n, int h,
                                          float (&v)[kE]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int q = 0; q < kE / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(s + (h + q) * n);
      v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  } else {
    unsigned int w[kE / 2];
    if constexpr (kE == kChunk) {
      const uint4 a = *s;
      w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    } else {
      const uint2 a = reinterpret_cast<const uint2*>(s)[h];
      w[0] = a.x, w[1] = a.y;
    }
#pragma unroll
    for (int q = 0; q < kE / 2; ++q) {
      const float2 f = bf2_to_f2(w[q]);
      v[2 * q] = f.x, v[2 * q + 1] = f.y;
    }
  }
}

// The row's base in zxbcdt: rows run over (batch, position).
template <typename T>
__device__ __forceinline__ const T* row_of(const T* zx, long long row,
                                           long long seq, long long sb,
                                           long long ss) {
  return zx + (row / seq) * sb + (row % seq) * ss;
}

// The columns of a row that thread t holds in the row kernels: chunk k's
// first column (past the row when the row has fewer).  Vector path:
// chunk t + k blockDim of 8 columns; scalar path: column t + k blockDim.
template <bool kVec>
__device__ __forceinline__ int held_col(int k) {
  const int j = threadIdx.x + k * static_cast<int>(blockDim.x);
  return kVec ? j * kChunk : j;
}

// ------------------------------------------------------------ mamba_in --

// One 8-column chunk of a row's x, b, c and dt columns (col from x's
// first), converted, written to its operand.
__device__ __forceinline__ void in_chunk(float (&v)[kChunk], long long row,
                                         int col, int di, int gn, int h,
                                         const void* dt_bias, int bias_bf16,
                                         float* x, float* b, float* c,
                                         float* dt) {
  if (col < di) {
    store8(x + row * di + col, v);
  } else if (col < di + gn) {
    store8(b + row * gn + (col - di), v);
  } else if (col < di + 2 * gn) {
    store8(c + row * gn + (col - di - gn), v);
  } else {
    const int k = col - di - 2 * gn;
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      v[e] = softplus(__fadd_rn(v[e], vec_at(dt_bias, bias_bf16, k + e)));
    store8(dt + row * h + k, v);
  }
}

// Vector path: the (row, chunk) pairs of every row laid out flat, kInItems
// of them a thread, all loads issued before the first store.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    mamba_in_vec_kernel(const T* __restrict__ zx, long long seq, long long sb,
                        long long ss, int di, int gn, int h,
                        const void* __restrict__ dt_bias, int bias_bf16,
                        float* __restrict__ x, float* __restrict__ b,
                        float* __restrict__ c, float* __restrict__ dt,
                        long long items, int nch) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kRowThreads * kInItems +
      threadIdx.x;
  float v[kInItems][kChunk];
#pragma unroll
  for (int k = 0; k < kInItems; ++k) {
    const long long it = base + k * kRowThreads;
    if (it < items) {
      const long long row = it / nch;
      const int col = static_cast<int>(it - row * nch) * kChunk;
      load8(row_of(zx, row, seq, sb, ss) + di + col, v[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kInItems; ++k) {
    const long long it = base + k * kRowThreads;
    if (it < items) {
      const long long row = it / nch;
      const int col = static_cast<int>(it - row * nch) * kChunk;
      in_chunk(v[k], row, col, di, gn, h, dt_bias, bias_bf16, x, b, c, dt);
    }
  }
}

// Scalar path: a block a row, a column a thread.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    mamba_in_kernel(const T* __restrict__ zx, long long seq, long long sb,
                    long long ss, int di, int gn, int h,
                    const void* __restrict__ dt_bias, int bias_bf16,
                    float* __restrict__ x, float* __restrict__ b,
                    float* __restrict__ c, float* __restrict__ dt) {
  const long long row = blockIdx.x;
  const T* src = row_of(zx, row, seq, sb, ss) + di;
  const int width = di + 2 * gn + h;  // the columns from x on
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    const float v = to_f(src[col]);
    if (col < di) {
      x[row * di + col] = v;
    } else if (col < di + gn) {
      b[row * gn + col - di] = v;
    } else if (col < di + 2 * gn) {
      c[row * gn + col - di - gn] = v;
    } else {
      const int k = col - di - 2 * gn;
      dt[row * h + k] = softplus(__fadd_rn(v, vec_at(dt_bias, bias_bf16, k)));
    }
  }
}

// ----------------------------------------------------------- mamba_out --

// For kN consecutive columns from `col`: y_t = round_T(y + d x) and
// sg = sigmoid(z) (u = y_t z sg); x and z as float left in xv and zv.
template <typename T, int kN>
__device__ __forceinline__ void gated(const float* y, const T* x, const T* z,
                                      const void* d_skip, int skip_bf16,
                                      int col, int p, float (&yt)[kN],
                                      float (&sg)[kN], float (&xv)[kN],
                                      float (&zv)[kN]) {
  float yv[kN];
  if constexpr (kN == kChunk) {
    load8(y + col, yv);
    load8(x + col, xv);
    load8(z + col, zv);
  } else {
    yv[0] = y[col];
    xv[0] = to_f(x[col]);
    zv[0] = to_f(z[col]);
  }
  // a chunk lies in one head on the vector path (P a multiple of 8)
  const float d = vec_at(d_skip, skip_bf16, col / p);
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    yt[e] = round_to<T>(__fadd_rn(yv[e], __fmul_rn(d, xv[e])));
    sg[e] = sigmoid(zv[e]);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    mamba_out_kernel(const float* __restrict__ y, const T* __restrict__ zx,
                     long long seq, long long sb, long long ss, int di, int p,
                     const void* __restrict__ d_skip, int skip_bf16,
                     const void* __restrict__ norm_g, int g_bf16,
                     T* __restrict__ out, float* __restrict__ r_out) {
  constexpr int kN = kVec ? kChunk : 1;
  constexpr int kSteps = kVec ? kCap : kCapScalar;
  __shared__ float red[33];
  const long long row = blockIdx.x;
  const T* zrow = row_of(zx, row, seq, sb, ss);
  const float* yrow = y + row * di;
  float u[kSteps][kN];
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int col = held_col<kVec>(k);
    if (col >= di) break;
    float yt[kN], sg[kN], xv[kN], zv[kN];
    gated<T, kN>(yrow, zrow + di, zrow, d_skip, skip_bf16, col, p, yt, sg,
                 xv, zv);
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      u[k][e] = __fmul_rn(yt[e], __fmul_rn(zv[e], sg[e]));
      sq = __fadd_rn(sq, __fmul_rn(u[k][e], u[k][e]));
    }
  }
  const float total = block_sum(sq, red);
  const float r =
      rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(di)), kEps));
  if (threadIdx.x == 0) r_out[row] = r;
  T* orow = out + row * di;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int col = held_col<kVec>(k);
    if (col >= di) break;
    float o[kN], g[kN];
    if constexpr (kN == kChunk)
      load8_vec(norm_g, g_bf16, col, g);
    else
      g[0] = vec_at(norm_g, g_bf16, col);
#pragma unroll
    for (int e = 0; e < kN; ++e)
      o[e] = __fmul_rn(__fmul_rn(u[k][e], r), __fadd_rn(1.0f, g[e]));
    if constexpr (kN == kChunk)
      store8(orow + col, o);
    else
      orow[col] = from_f<T>(o[0]);
  }
}

// ------------------------------------------------------- mamba_out_bwd --

// Scalar path: a block owns rows_per_block rows, a thread the columns t +
// k blockDim; each thread's column sums (norm_g's and d_skip's) live in
// dynamic shared memory (2 di floats), each thread touching only its own
// columns.  Per row: pass A loads d_out, y, x and z, keeps y_t, sigmoid(z)
// and d_out in registers and forms the row's dot; pass B reloads x and z
// (cache hits) for the writes.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    mamba_out_bwd_kernel(const T* __restrict__ dout,
                         const float* __restrict__ y,
                         const T* __restrict__ zx, long long seq,
                         long long sb, long long ss,
                         const float* __restrict__ r_in, long long rows,
                         long long rows_per_block, int di, int p, int w,
                         const void* __restrict__ d_skip, int skip_bf16,
                         const void* __restrict__ norm_g, int g_bf16,
                         float* __restrict__ dy, T* __restrict__ grad,
                         float* __restrict__ part_g,
                         float* __restrict__ part_s) {
  extern __shared__ float sums[];
  float* acc_g = sums;
  float* acc_s = sums + di;
  __shared__ float red[33];
#pragma unroll
  for (int k = 0; k < kCapScalar; ++k) {
    const int col = held_col<false>(k);
    if (col >= di) break;
    acc_g[col] = acc_s[col] = 0.0f;
  }
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (long long row = r0; row < r1; ++row) {
    const T* zrow = row_of(zx, row, seq, sb, ss);
    const float* yrow = y + row * di;
    const T* drow = dout + row * di;
    float yt[kCapScalar][1], sg[kCapScalar][1], dof[kCapScalar];
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < kCapScalar; ++k) {
      const int col = held_col<false>(k);
      if (col >= di) break;
      float xv[1], zv[1];
      gated<T, 1>(yrow, zrow + di, zrow, d_skip, skip_bf16, col, p, yt[k],
                  sg[k], xv, zv);
      dof[k] = to_f(drow[col]);
      const float g = vec_at(norm_g, g_bf16, col);
      const float u = __fmul_rn(yt[k][0], __fmul_rn(zv[0], sg[k][0]));
      const float a = __fmul_rn(dof[k], __fadd_rn(1.0f, g));
      dot = __fadd_rn(dot, __fmul_rn(a, u));
    }
    const float dr = block_sum(dot, red);
    const float r = r_in[row];
    // rsqrt's backward, -0.5 dr r^3, then the mean's: over di, to each u
    const float dvar =
        __fmul_rn(__fmul_rn(-0.5f, dr), __fmul_rn(__fmul_rn(r, r), r));
    const float kvar = __fdiv_rn(dvar, static_cast<float>(di));
    float* dyrow = dy + row * di;
    T* grow = grad + row * static_cast<long long>(w);
#pragma unroll
    for (int k = 0; k < kCapScalar; ++k) {
      const int col = held_col<false>(k);
      if (col >= di) break;
      const float xv = to_f(zrow[di + col]), zv = to_f(zrow[col]);
      const float g = vec_at(norm_g, g_bf16, col);
      const float sz = __fmul_rn(zv, sg[k][0]);
      const float u = __fmul_rn(yt[k][0], sz);
      const float a = __fmul_rn(dof[k], __fadd_rn(1.0f, g));
      const float vu = __fmul_rn(kvar, u);
      const float du = __fadd_rn(__fmul_rn(a, r), __fadd_rn(vu, vu));
      const float dyo = round_to<T>(__fmul_rn(du, sz));
      const float dzo = silu_grad(__fmul_rn(du, yt[k][0]), zv, sg[k][0]);
      acc_g[col] = __fadd_rn(acc_g[col], __fmul_rn(dof[k], __fmul_rn(u, r)));
      acc_s[col] = __fadd_rn(acc_s[col], __fmul_rn(dyo, xv));
      dyrow[col] = dyo;
      grow[col] = from_f<T>(dzo);
    }
  }
  float* pg = part_g + static_cast<long long>(blockIdx.x) * di;
  float* ps = part_s + static_cast<long long>(blockIdx.x) * di;
#pragma unroll
  for (int k = 0; k < kCapScalar; ++k) {
    const int col = held_col<false>(k);
    if (col >= di) break;
    pg[col] = acc_g[col];
    ps[col] = acc_s[col];
  }
}

// 16-byte slots of one stage of mamba_out_bwd's ring, for one thread: its
// chunk of d_out, x and z (one slot each in bfloat16, two in float32) and,
// with kStageY, of y (two); slot q of thread t at q * blockDim + t, so a
// warp's copies and reads touch consecutive 16-byte words.
template <typename T, bool kStageY>
__host__ __device__ constexpr int ring_slots() {
  return 3 * (static_cast<int>(sizeof(T)) / 2) + (kStageY ? 2 : 0);
}

// Copy one row's chunk (column col) into a thread's stage at `slot`.
template <typename T, bool kStageY>
__device__ __forceinline__ void stage_row(uint4* slot, int n, const T* drow,
                                          const float* yrow, const T* zrow,
                                          int di, int col) {
  constexpr int kW = static_cast<int>(sizeof(T)) / 2;
  const uint4* d = reinterpret_cast<const uint4*>(drow + col);
  const uint4* x = reinterpret_cast<const uint4*>(zrow + di + col);
  const uint4* z = reinterpret_cast<const uint4*>(zrow + col);
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    cp_async16(slot + i * n, d + i);
    cp_async16(slot + (kW + i) * n, x + i);
    cp_async16(slot + (2 * kW + i) * n, z + i);
  }
  if constexpr (kStageY) {
    const uint4* yv = reinterpret_cast<const uint4*>(yrow + col);
    cp_async16(slot + 3 * kW * n, yv);
    cp_async16(slot + (3 * kW + 1) * n, yv + 1);
  }
}

// Vector path (the models' widths).  A block owns rows_per_block rows and
// thread t the row's chunk of 8 columns from 8 t (ceil(di / 8) threads,
// at most kThreads).  Each thread copies its own chunk of the rows ahead
// into its own slots of a ring of `stages` stages (dynamic shared memory,
// ring_slots 16-byte slots a thread a stage): no barrier guards the ring,
// and row r + stages - 1 is in flight while row r is summed and written.
// Pass A reads the stage, keeps y_t in registers and sigmoid(z) in two
// more slots of the thread's own (after the ring), and forms the row's
// dot; the row sum (block_sum's order: dy and dz as the scalar path's)
// takes one barrier, and a warp that has written its row goes on to the
// next while others finish; pass B reads d_out, x and z from the stage
// again.  Norm_g's 8 column sums a thread owns, and d_skip's over its
// chunk (the chunk lies in one head, whose sum is all the finish takes of
// its columns), stay in registers and are written once, at the block's
// end.  At 1024 threads (64 registers) a thread takes its chunk in halves.
template <typename T, bool kStageY, int kThreads>
__global__ void __launch_bounds__(kThreads)
    mamba_out_bwd_vec_kernel(const T* __restrict__ dout,
                             const float* __restrict__ y,
                             const T* __restrict__ zx, long long seq,
                             long long sb, long long ss,
                             const float* __restrict__ r_in, long long rows,
                             long long rows_per_block, int di, int p, int w,
                             int stages, const void* __restrict__ d_skip,
                             int skip_bf16, const void* __restrict__ norm_g,
                             int g_bf16, float* __restrict__ dy,
                             T* __restrict__ grad, float* __restrict__ part_g,
                             float* __restrict__ part_s) {
  constexpr int kW = static_cast<int>(sizeof(T)) / 2;
  constexpr int kSlots = ring_slots<T, kStageY>();
  constexpr int kParts = kThreads > kNarrowThreads ? 2 : 1;
  constexpr int kE = kChunk / kParts;
  extern __shared__ uint4 ring[];
  __shared__ __align__(16) float red[2][kRedStride];
  const int n = static_cast<int>(blockDim.x);
  const int col = threadIdx.x * kChunk;
  const bool mine = col < di;
  const long long r0 = blockIdx.x * rows_per_block;
  const int nrows = static_cast<int>(
      (r0 + rows_per_block < rows ? r0 + rows_per_block : rows) - r0);
  // a chunk lies in one head (P a multiple of 8)
  const float d = mine ? vec_at(d_skip, skip_bf16, col / p) : 0.0f;
  uint4* const slots = ring + threadIdx.x;
  float4* const sg_slot =
      reinterpret_cast<float4*>(ring + stages * kSlots * n) + threadIdx.x;
  // the row to copy next: its stage and its place in zxbcdt (batch,
  // position); row k + stages - 1 when row k is read
  int put = 0;
  int zb = static_cast<int>(r0 / seq), zs = static_cast<int>(r0 % seq);
  auto issue = [&](int ahead) {
    if (mine && ahead < nrows) {
      const long long row = r0 + ahead;
      stage_row<T, kStageY>(slots + put * kSlots * n, n, dout + row * di,
                            y + row * di, zx + zb * sb + zs * ss, di, col);
    }
    cp_async_commit();
    put = put + 1 == stages ? 0 : put + 1;
    if (++zs == seq) zs = 0, ++zb;
  };
  for (int i = 0; i + 1 < stages; ++i) issue(i);
  float acc_g[kChunk], acc_s = 0.0f;  // norm_g's column sums, d_skip's
#pragma unroll
  for (int e = 0; e < kChunk; ++e) acc_g[e] = 0.0f;
  for (int k = 0; k < nrows; ++k) {
    const long long row = r0 + k;
    issue(k + stages - 1);
    cp_async_wait(stages - 1);
    // row k's stage, k % stages: where the next issue goes
    const uint4* slot = slots + put * kSlots * n;
    const float r = r_in[row];
    float yt[kChunk];
    float dot = 0.0f;
    if (mine) {
#pragma unroll
      for (int h = 0; h < kParts; ++h) {
        float dof[kE], xv[kE], zv[kE], yv[kE], g[kE], sg[kE];
        slot_part<T, kE>(slot, n, h, dof);
        slot_part<T, kE>(slot + kW * n, n, h, xv);
        slot_part<T, kE>(slot + 2 * kW * n, n, h, zv);
        if constexpr (kStageY)
          slot_part<float, kE>(slot + 3 * kW * n, n, h, yv);
        else
          load_part<kE>(y + row * di + col + kE * h, yv);
        load_part_vec<kE>(norm_g, g_bf16, col + kE * h, g);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int c = kE * h + e;
          yt[c] = round_to<T>(__fadd_rn(yv[e], __fmul_rn(d, xv[e])));
          sg[e] = sigmoid(zv[e]);
          const float u = __fmul_rn(yt[c], __fmul_rn(zv[e], sg[e]));
          const float a = __fmul_rn(dof[e], __fadd_rn(1.0f, g[e]));
          dot = __fadd_rn(dot, __fmul_rn(a, u));
        }
#pragma unroll
        for (int q = 0; q < kE / 4; ++q)
          sg_slot[(h + q) * n] = make_float4(sg[4 * q], sg[4 * q + 1],
                                             sg[4 * q + 2], sg[4 * q + 3]);
      }
    }
    const float dr = row_sum(dot, red[k & 1]);
    // rsqrt's backward, -0.5 dr r^3, then the mean's: over di, to each u
    const float dvar =
        __fmul_rn(__fmul_rn(-0.5f, dr), __fmul_rn(__fmul_rn(r, r), r));
    const float kvar = __fdiv_rn(dvar, static_cast<float>(di));
    if (mine) {
#pragma unroll
      for (int h = 0; h < kParts; ++h) {
        float dof[kE], xv[kE], zv[kE], g[kE], sg[kE], dyo[kE], dzo[kE];
        slot_part<T, kE>(slot, n, h, dof);
        slot_part<T, kE>(slot + kW * n, n, h, xv);
        slot_part<T, kE>(slot + 2 * kW * n, n, h, zv);
        slot_part<float, kE>(reinterpret_cast<const uint4*>(sg_slot), n, h,
                             sg);
        load_part_vec<kE>(norm_g, g_bf16, col + kE * h, g);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int c = kE * h + e;
          const float sz = __fmul_rn(zv[e], sg[e]);
          const float u = __fmul_rn(yt[c], sz);
          const float a = __fmul_rn(dof[e], __fadd_rn(1.0f, g[e]));
          const float vu = __fmul_rn(kvar, u);
          const float du = __fadd_rn(__fmul_rn(a, r), __fadd_rn(vu, vu));
          dyo[e] = round_to<T>(__fmul_rn(du, sz));
          dzo[e] = silu_grad(__fmul_rn(du, yt[c]), zv[e], sg[e]);
          acc_g[c] = __fadd_rn(acc_g[c], __fmul_rn(dof[e], __fmul_rn(u, r)));
          acc_s = __fadd_rn(acc_s, __fmul_rn(dyo[e], xv[e]));
        }
        store_part<kE>(dy + row * di + col + kE * h, dyo);
        store_part<kE>(grad + row * static_cast<long long>(w) + col + kE * h,
                       dzo);
      }
    }
  }
  if (mine) {
    // d_skip's partial in the chunk's first column, zeros beside it: the
    // finish's sums over the head's columns add the chunks in order
    const float s8[kChunk] = {acc_s, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    store8(part_g + static_cast<long long>(blockIdx.x) * di + col, acc_g);
    store8(part_s + static_cast<long long>(blockIdx.x) * di + col, s8);
  }
}

// norm_g's gradient (float32, a column each) and d_skip's (a head each:
// its P columns added in order); one block a head, a thread a column, 32
// partials' loads in flight a thread.
__global__ void __launch_bounds__(kFinishThreads)
    mamba_out_bwd_finish_kernel(const float* __restrict__ part_g,
                                const float* __restrict__ part_s, int nb,
                                int di, int p, float* __restrict__ d_norm_g,
                                float* __restrict__ d_skip) {
  __shared__ float col_s[kFinishThreads];
  const int t = threadIdx.x;
  const int col = blockIdx.x * p + t;
  float sg = 0.0f, sc = 0.0f;
  if (t < p) {
#pragma unroll 32
    for (int b = 0; b < nb; ++b) {
      sg = __fadd_rn(sg, part_g[static_cast<long long>(b) * di + col]);
      sc = __fadd_rn(sc, part_s[static_cast<long long>(b) * di + col]);
    }
    d_norm_g[col] = sg;
  }
  col_s[t] = sc;
  __syncthreads();
  if (t == 0) {
    float s = 0.0f;
    for (int i = 0; i < p; ++i) s = __fadd_rn(s, col_s[i]);
    d_skip[blockIdx.x] = s;
  }
}

// -------------------------------------------------------- mamba_in_bwd --

// Scalar path: a block owns rows_per_block rows, a thread the columns t +
// k blockDim of each, and dt columns t + m blockDim (their sums over the
// block's rows: dt_bias's partials).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    mamba_in_bwd_kernel(const float* __restrict__ dx,
                        const float* __restrict__ db,
                        const float* __restrict__ dc,
                        const float* __restrict__ ddt,
                        const float* __restrict__ dy, const T* __restrict__ zx,
                        long long seq, long long sb, long long ss,
                        long long rows, long long rows_per_block, int di,
                        int gn, int h, int p, int w,
                        const void* __restrict__ dt_bias, int bias_bf16,
                        const void* __restrict__ d_skip, int skip_bf16,
                        T* __restrict__ grad, float* __restrict__ part_dt) {
  float acc[kDtCap];
#pragma unroll
  for (int m = 0; m < kDtCap; ++m) acc[m] = 0.0f;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const int width = di + 2 * gn;  // the x, b and c columns
  for (long long row = r0; row < r1; ++row) {
    T* grow = grad + row * static_cast<long long>(w) + di;
    const float* dxr = dx + row * di;
    const float* dyr = dy + row * di;
    const float* dbr = db + row * gn;
    const float* dcr = dc + row * gn;
    for (int col = threadIdx.x; col < width; col += blockDim.x) {
      float v;
      if (col < di)
        v = __fadd_rn(dxr[col],
                      __fmul_rn(vec_at(d_skip, skip_bf16, col / p), dyr[col]));
      else if (col < di + gn)
        v = dbr[col - di];
      else
        v = dcr[col - di - gn];
      grow[col] = from_f<T>(v);
    }
    const T* dtraw = row_of(zx, row, seq, sb, ss) + 2 * di + 2 * gn;
#pragma unroll
    for (int m = 0; m < kDtCap; ++m) {
      const int k = threadIdx.x + m * blockDim.x;
      if (k < h) {
        const float v =
            __fadd_rn(to_f(dtraw[k]), vec_at(dt_bias, bias_bf16, k));
        const float g = softplus_grad(ddt[row * h + k], v);
        grow[width + k] = from_f<T>(g);
        acc[m] = __fadd_rn(acc[m], g);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kDtCap; ++m) {
    const int k = threadIdx.x + m * blockDim.x;
    if (k < h) part_dt[static_cast<long long>(blockIdx.x) * h + k] = acc[m];
  }
}

// The vector path's dt columns: block g owns the rows of group g, thread
// t chunk t % (h / 8) of the rows t / (h / 8), t / (h / 8) + lanes, ...
// (lanes = 256 / (h / 8) rows at once, a chunk's 16-byte loads of raw dt
// and ddt); each lane's sums over its rows, then the lanes' in order:
// dt_bias's partial of the group.
template <typename T>
__device__ __forceinline__ void in_bwd_dt(
    const float* __restrict__ ddt, const T* __restrict__ zx, long long seq,
    long long sb, long long ss, long long rows, long long rows_per_block,
    int off, int h, int w, const void* __restrict__ dt_bias, int bias_bf16,
    T* __restrict__ grad, float* __restrict__ part_dt) {
  __shared__ float sums[kRowThreads * kChunk];
  const int hc = h / kChunk;
  const int lanes = kRowThreads / hc;
  const int c = threadIdx.x % hc, j = threadIdx.x / hc;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  if (j < lanes) {
    float bias[kChunk], acc[kChunk];
    load8_vec(dt_bias, bias_bf16, c * kChunk, bias);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) acc[e] = 0.0f;
    for (long long row = r0 + j; row < r1; row += lanes) {
      float raw[kChunk], g[kChunk];
      load8(row_of(zx, row, seq, sb, ss) + off + c * kChunk, raw);
      load8(ddt + row * h + c * kChunk, g);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        g[e] = softplus_grad(g[e], __fadd_rn(raw[e], bias[e]));
        acc[e] = __fadd_rn(acc[e], g[e]);
      }
      store8(grad + row * static_cast<long long>(w) + off + c * kChunk, g);
    }
#pragma unroll
    for (int e = 0; e < kChunk; ++e) sums[j * h + c * kChunk + e] = acc[e];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < h; k += kRowThreads) {
    float s = 0.0f;
    for (int i = 0; i < lanes; ++i) s = __fadd_rn(s, sums[i * h + k]);
    part_dt[static_cast<long long>(blockIdx.x) * h + k] = s;
  }
}

// Vector path (the models' widths).  The grid's first dt_blocks blocks
// take the dt columns (in_bwd_dt); the rest lay the x, b and c columns'
// (row, 8-column chunk) pairs out flat, nch a row, kInBwdItems a thread
// kRowThreads apart, every load issued before the first store.  A chunk
// of x lies in one head (P a multiple of 8): its head is chunk * magic >>
// 32, magic = ceil(2^32 / (P / 8)), exact for every chunk of a row.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    mamba_in_bwd_vec_kernel(const float* __restrict__ dx,
                            const float* __restrict__ db,
                            const float* __restrict__ dc,
                            const float* __restrict__ ddt,
                            const float* __restrict__ dy,
                            const T* __restrict__ zx, long long seq,
                            long long sb, long long ss, long long rows,
                            long long rows_per_block, int dt_blocks, int di,
                            int gn, int h, int w, int nch,
                            unsigned long long magic,
                            const void* __restrict__ dt_bias, int bias_bf16,
                            const void* __restrict__ d_skip, int skip_bf16,
                            T* __restrict__ grad, float* __restrict__ part_dt) {
  if (static_cast<int>(blockIdx.x) < dt_blocks) {
    in_bwd_dt<T>(ddt, zx, seq, sb, ss, rows, rows_per_block, 2 * di + 2 * gn,
                 h, w, dt_bias, bias_bf16, grad, part_dt);
    return;
  }
  const long long first =
      static_cast<long long>(blockIdx.x - dt_blocks) * kRowThreads *
          kInBwdItems + threadIdx.x;
  long long row = first / nch;
  int c = static_cast<int>(first - row * nch);
  long long rs[kInBwdItems];
  int cs[kInBwdItems];
  float v[kInBwdItems][kChunk], dyv[kInBwdItems][kChunk];
#pragma unroll
  for (int k = 0; k < kInBwdItems; ++k) {
    rs[k] = row, cs[k] = c;
    if (row < rows) {
      const int col = c * kChunk;
      if (col < di) {
        load8(dx + row * di + col, v[k]);
        load8(dy + row * di + col, dyv[k]);
      } else if (col < di + gn) {
        load8(db + row * gn + (col - di), v[k]);
      } else {
        load8(dc + row * gn + (col - di - gn), v[k]);
      }
    }
    for (c += kRowThreads; c >= nch; c -= nch) ++row;
  }
#pragma unroll
  for (int k = 0; k < kInBwdItems; ++k) {
    if (rs[k] >= rows) break;
    const int col = cs[k] * kChunk;
    if (col < di) {
      const int head = static_cast<int>(
          (static_cast<unsigned long long>(cs[k]) * magic) >> 32);
      const float d = vec_at(d_skip, skip_bf16, head);
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        v[k][e] = __fadd_rn(v[k][e], __fmul_rn(d, dyv[k][e]));
    }
    store8(grad + rs[k] * static_cast<long long>(w) + di + col, v[k]);
  }
}

// dt_bias's gradient: each column's partials added in block order, 32
// partials' loads in flight a thread
__global__ void __launch_bounds__(kRowThreads)
    mamba_in_bwd_finish_kernel(const float* __restrict__ part_dt, int nb,
                               int h, float* __restrict__ d_dt_bias) {
  for (int k = threadIdx.x; k < h; k += blockDim.x) {
    float s = 0.0f;
#pragma unroll 32
    for (int b = 0; b < nb; ++b)
      s = __fadd_rn(s, part_dt[static_cast<long long>(b) * h + k]);
    d_dt_bias[k] = s;
  }
}

// ------------------------------------------------------------- launches --

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Threads of a row kernel's block: enough for the row at kCap chunks (or
// kCapScalar elements: as many) a thread, a multiple of 32; 0 when the row
// is too wide.
int row_threads(int di) {
  constexpr int held = kCap * kChunk;
  static_assert(held == kCapScalar, "both paths hold as many columns");
  int t = (di + held - 1) / held;
  t = (t + 31) / 32 * 32;
  if (t < 32) t = 32;
  return t > kMaxThreads ? 0 : t;
}

// A backward's row groups: at most `most`, from the row count alone.
void row_groups(long long rows, int most, long long* per, int* nb) {
  const long long blocks = rows < most ? rows : most;
  *per = (rows + blocks - 1) / blocks;
  *nb = static_cast<int>((rows + *per - 1) / *per);
}

int err() { return static_cast<int>(cudaGetLastError()); }

template <typename T>
int launch_in(const void* zx, long long rows, long long seq, long long sb,
              long long ss, int di, int gn, int h, const void* dt_bias,
              int bias_bf16, void* x, void* b, void* c, void* dt,
              cudaStream_t s) {
  const bool vec = aligned(zx) && sb % kChunk == 0 && ss % kChunk == 0 &&
                   di % kChunk == 0 && gn % kChunk == 0 && h % kChunk == 0 &&
                   aligned(x) && aligned(b) && aligned(c) && aligned(dt);
  const T* z = static_cast<const T*>(zx);
  float *xo = static_cast<float*>(x), *bo = static_cast<float*>(b),
        *co = static_cast<float*>(c), *dto = static_cast<float*>(dt);
  if (vec) {
    const int nch = (di + 2 * gn + h) / kChunk;
    const long long items = rows * nch;
    const long long per_block = static_cast<long long>(kRowThreads) * kInItems;
    mamba_in_vec_kernel<T><<<(items + per_block - 1) / per_block,
                             kRowThreads, 0, s>>>(z, seq, sb, ss, di, gn, h,
                                                  dt_bias, bias_bf16, xo, bo,
                                                  co, dto, items, nch);
  } else {
    mamba_in_kernel<T><<<rows, kRowThreads, 0, s>>>(
        z, seq, sb, ss, di, gn, h, dt_bias, bias_bf16, xo, bo, co, dto);
  }
  return err();
}

template <typename T>
int launch_out(const void* y, const void* zx, long long rows, long long seq,
               long long sb, long long ss, int di, int p, const void* d_skip,
               int skip_bf16, const void* norm_g, int g_bf16, void* out,
               void* r, cudaStream_t s) {
  const bool vec = aligned(zx) && sb % kChunk == 0 && ss % kChunk == 0 &&
                   di % kChunk == 0 && p % kChunk == 0 && aligned(y) &&
                   aligned(out) && aligned(norm_g);
  const int threads = row_threads(di);
  if (threads == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float* yp = static_cast<const float*>(y);
  const T* z = static_cast<const T*>(zx);
  T* o = static_cast<T*>(out);
  float* rp = static_cast<float*>(r);
  if (vec)
    mamba_out_kernel<T, true><<<rows, threads, 0, s>>>(
        yp, z, seq, sb, ss, di, p, d_skip, skip_bf16, norm_g, g_bf16, o, rp);
  else
    mamba_out_kernel<T, false><<<rows, threads, 0, s>>>(
        yp, z, seq, sb, ss, di, p, d_skip, skip_bf16, norm_g, g_bf16, o, rp);
  return err();
}

// mamba_out_bwd's vector-path launch at d_inner di: its threads, the
// ring's stages (0 when no two fit), whether the ring holds y, and its
// dynamic shared memory
struct OutBwdPlan {
  int threads, stages;
  bool stage_y;
  size_t smem;
};

template <typename T>
OutBwdPlan out_bwd_plan(int di) {
  OutBwdPlan plan{row_threads(di), 0, true, 0};
  const size_t slot = 16 * static_cast<size_t>(plan.threads);
  // the row-sum buffers, then each thread's two slots of sigmoid(z)
  const size_t budget = kSmemBlock - sizeof(float) * 2 * kRedStride -
                        2 * slot;
  size_t stage = ring_slots<T, true>() * slot;
  int fit = static_cast<int>(budget / stage);
  if (fit < 2 && sizeof(T) == 4) {  // float32 at the widest rows
    plan.stage_y = false;
    stage = ring_slots<T, false>() * slot;
    fit = static_cast<int>(budget / stage);
  }
  if (plan.threads == 0 || fit < 2) return plan;
  plan.stages = fit < kMaxStages ? fit : kMaxStages;
  plan.smem = plan.stages * stage + 2 * slot;
  return plan;
}

// The vector-path kernel the plan names: launch bounds of kNarrowThreads
// (96 registers a thread) for rows of at most 5120 columns, else 1024 (64
// registers); the ring without y exists for float32 alone
template <typename T>
const void* out_bwd_vec(const OutBwdPlan& plan) {
  const bool narrow = plan.threads <= kNarrowThreads;
  if (plan.stage_y)
    return narrow ? (const void*)
                        mamba_out_bwd_vec_kernel<T, true, kNarrowThreads>
                  : (const void*)mamba_out_bwd_vec_kernel<T, true, kMaxThreads>;
  if constexpr (sizeof(T) == 4)
    if (!narrow)
      return (const void*)mamba_out_bwd_vec_kernel<T, false, kMaxThreads>;
  return nullptr;
}

template <typename T>
int launch_out_bwd(const void* dout, const void* y, const void* zx,
                   long long rows, long long seq, long long sb, long long ss,
                   const void* r, int di, int p, int w, const void* d_skip,
                   int skip_bf16, const void* norm_g, int g_bf16, void* dy,
                   void* grad, void* part_g, void* part_s, void* d_norm_g,
                   void* d_skip_grad, cudaStream_t s) {
  const bool vec = aligned(zx) && sb % kChunk == 0 && ss % kChunk == 0 &&
                   di % kChunk == 0 && p % kChunk == 0 && w % kChunk == 0 &&
                   aligned(dout) && aligned(y) && aligned(dy) &&
                   aligned(grad) && aligned(norm_g) && aligned(part_g) &&
                   aligned(part_s);
  const int threads = row_threads(di);
  if (threads == 0 || p > kFinishThreads)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  long long per;
  int nb;
  row_groups(rows, kOutBwdBlocks, &per, &nb);
  const T* d = static_cast<const T*>(dout);
  const float* yp = static_cast<const float*>(y);
  const T* z = static_cast<const T*>(zx);
  const float* rp = static_cast<const float*>(r);
  float* dyp = static_cast<float*>(dy);
  T* g = static_cast<T*>(grad);
  float *pg = static_cast<float*>(part_g), *ps = static_cast<float*>(part_s);
  if (vec) {
    const OutBwdPlan plan = out_bwd_plan<T>(di);
    const void* kernel = out_bwd_vec<T>(plan);
    if (plan.stages < 2 || !kernel)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(plan.smem));
    int stages = plan.stages;
    void* args[] = {&d,  &yp, &z,  &seq,    &sb,    &ss,     &rp,
                    &rows, &per, &di, &p,     &w,     &stages, &d_skip,
                    &skip_bf16, &norm_g, &g_bf16, &dyp, &g, &pg, &ps};
    cudaLaunchKernel(kernel, dim3(nb), dim3(plan.threads), args, plan.smem,
                     s);
  } else {
    const size_t smem = 2 * sizeof(float) * static_cast<size_t>(di);
    cudaFuncSetAttribute(mamba_out_bwd_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    mamba_out_bwd_kernel<T><<<nb, threads, smem, s>>>(
        d, yp, z, seq, sb, ss, rp, rows, per, di, p, w, d_skip, skip_bf16,
        norm_g, g_bf16, dyp, g, pg, ps);
  }
  int e = err();
  if (e != 0) return e;
  const int ft = (p + 31) / 32 * 32;
  mamba_out_bwd_finish_kernel<<<di / p, ft, 0, s>>>(
      pg, ps, nb, di, p, static_cast<float*>(d_norm_g),
      static_cast<float*>(d_skip_grad));
  return err();
}

template <typename T>
int launch_in_bwd(const void* dx, const void* db, const void* dc,
                  const void* ddt, const void* dy, const void* zx,
                  long long rows, long long seq, long long sb, long long ss,
                  int di, int gn, int h, int p, int w, const void* dt_bias,
                  int bias_bf16, const void* d_skip, int skip_bf16,
                  void* grad, void* part_dt, void* d_dt_bias,
                  cudaStream_t s) {
  if (h > kDtCap * kRowThreads)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = di % kChunk == 0 && gn % kChunk == 0 && h % kChunk == 0 &&
                   w % kChunk == 0 && p % kChunk == 0 && sb % kChunk == 0 &&
                   ss % kChunk == 0 && aligned(zx) && aligned(dx) &&
                   aligned(db) && aligned(dc) && aligned(ddt) && aligned(dy) &&
                   aligned(grad) && aligned(dt_bias);
  long long per;
  int nb;
  row_groups(rows, kInBwdBlocks, &per, &nb);
  const float *a = static_cast<const float*>(dx),
              *bp = static_cast<const float*>(db),
              *cp = static_cast<const float*>(dc),
              *tp = static_cast<const float*>(ddt),
              *yp = static_cast<const float*>(dy);
  const T* z = static_cast<const T*>(zx);
  T* g = static_cast<T*>(grad);
  float* pd = static_cast<float*>(part_dt);
  if (vec) {
    const int nch = (di + 2 * gn) / kChunk;
    const long long per_block =
        static_cast<long long>(kRowThreads) * kInBwdItems;
    const long long xbc = (rows * nch + per_block - 1) / per_block;
    // ceil(2^32 / (P / 8)): a chunk's head by a multiply
    const unsigned long long p8 = p / kChunk;
    const unsigned long long magic = ((1ull << 32) + p8 - 1) / p8;
    const unsigned grid = static_cast<unsigned>(nb + xbc);
    mamba_in_bwd_vec_kernel<T><<<grid, kRowThreads, 0, s>>>(
        a, bp, cp, tp, yp, z, seq, sb, ss, rows, per, nb, di, gn, h, w, nch,
        magic, dt_bias, bias_bf16, d_skip, skip_bf16, g, pd);
  } else {
    mamba_in_bwd_kernel<T><<<nb, kRowThreads, 0, s>>>(
        a, bp, cp, tp, yp, z, seq, sb, ss, rows, per, di, gn, h, p, w,
        dt_bias, bias_bf16, d_skip, skip_bf16, g, pd);
  }
  int e = err();
  if (e != 0) return e;
  mamba_in_bwd_finish_kernel<<<1, kRowThreads, 0, s>>>(
      pd, nb, h, static_cast<float*>(d_dt_bias));
  return err();
}

// Blocks per SM of a backward's vector-path kernel at the launch its
// launcher makes for d_inner di: out = {blocks per SM, threads, dynamic
// shared memory bytes, mamba_out_bwd's stages (0 for mamba_in_bwd)}.
template <typename T>
int occupancy(int which, int di, int* out) {
  const void* kernel = (const void*)mamba_in_bwd_vec_kernel<T>;
  OutBwdPlan plan{kRowThreads, 0, true, 0};
  if (which == 0) {
    plan = out_bwd_plan<T>(di);
    kernel = out_bwd_vec<T>(plan);
    if (plan.stages < 2 || !kernel)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(plan.smem));
  }
  out[1] = plan.threads, out[2] = static_cast<int>(plan.smem);
  out[3] = plan.stages;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, plan.threads, plan.smem));
}

bool bad_code(int code) { return code != 0 && code != 1; }

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  zxbcdt's rows are (batch,
// position) at element strides sb and ss, each row's columns contiguous;
// every other tensor is contiguous.

int repro_mamba_in(const void* zx, int dtype, long long rows, long long seq,
                   long long sb, long long ss, int di, int gn, int h,
                   const void* dt_bias, int bias_dtype, void* x, void* b,
                   void* c, void* dt, void* stream) {
  if (rows <= 0 || seq <= 0 || di <= 0 || gn <= 0 || h <= 0 ||
      bad_code(dtype) || bad_code(bias_dtype) || !zx || !dt_bias || !x ||
      !b || !c || !dt)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_in<float>(zx, rows, seq, sb, ss, di, gn, h,
                                       dt_bias, bias_dtype, x, b, c, dt, s)
                    : launch_in<__nv_bfloat16>(zx, rows, seq, sb, ss, di, gn,
                                               h, dt_bias, bias_dtype, x, b,
                                               c, dt, s);
}

int repro_mamba_out(const void* y, const void* zx, int dtype, long long rows,
                    long long seq, long long sb, long long ss, int di, int p,
                    const void* d_skip, int skip_dtype, const void* norm_g,
                    int g_dtype, void* out, void* r, void* stream) {
  if (rows <= 0 || seq <= 0 || di <= 0 || p <= 0 || di % p ||
      bad_code(dtype) || bad_code(skip_dtype) || bad_code(g_dtype) || !y ||
      !zx || !d_skip || !norm_g || !out || !r)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_out<float>(y, zx, rows, seq, sb, ss, di, p, d_skip,
                                 skip_dtype, norm_g, g_dtype, out, r, s)
             : launch_out<__nv_bfloat16>(y, zx, rows, seq, sb, ss, di, p,
                                         d_skip, skip_dtype, norm_g, g_dtype,
                                         out, r, s);
}

// d_norm_g (di) and d_skip_grad (di / p) are float32; w is the gradient
// buffer's row width (its z columns at [0, di) are written).
int repro_mamba_out_bwd(const void* dout, const void* y, const void* zx,
                        int dtype, long long rows, long long seq, long long sb,
                        long long ss, const void* r, int di, int p, int w,
                        const void* d_skip, int skip_dtype, const void* norm_g,
                        int g_dtype, void* dy, void* grad, void* part_g,
                        void* part_s, void* d_norm_g, void* d_skip_grad,
                        void* stream) {
  if (rows <= 0 || seq <= 0 || di <= 0 || p <= 0 || di % p || w < di ||
      bad_code(dtype) || bad_code(skip_dtype) || bad_code(g_dtype) || !dout ||
      !y || !zx || !r || !d_skip || !norm_g || !dy || !grad || !part_g ||
      !part_s || !d_norm_g || !d_skip_grad)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_out_bwd<float>(dout, y, zx, rows, seq, sb, ss, r, di, p,
                                     w, d_skip, skip_dtype, norm_g, g_dtype,
                                     dy, grad, part_g, part_s, d_norm_g,
                                     d_skip_grad, s)
             : launch_out_bwd<__nv_bfloat16>(
                   dout, y, zx, rows, seq, sb, ss, r, di, p, w, d_skip,
                   skip_dtype, norm_g, g_dtype, dy, grad, part_g, part_s,
                   d_norm_g, d_skip_grad, s);
}

// d_dt_bias (h) is float32; the gradient buffer's x, b, c and dt columns
// ([di, w)) are written.
int repro_mamba_in_bwd(const void* dx, const void* db, const void* dc,
                       const void* ddt, const void* dy, const void* zx,
                       int dtype, long long rows, long long seq, long long sb,
                       long long ss, int di, int gn, int h, int p, int w,
                       const void* dt_bias, int bias_dtype, const void* d_skip,
                       int skip_dtype, void* grad, void* part_dt,
                       void* d_dt_bias, void* stream) {
  if (rows <= 0 || seq <= 0 || di <= 0 || gn <= 0 || h <= 0 || p <= 0 ||
      di % p || w != 2 * di + 2 * gn + h || bad_code(dtype) ||
      bad_code(bias_dtype) || bad_code(skip_dtype) || !dx || !db || !dc ||
      !ddt || !dy || !zx || !dt_bias || !d_skip || !grad || !part_dt ||
      !d_dt_bias)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_in_bwd<float>(dx, db, dc, ddt, dy, zx, rows, seq, sb,
                                    ss, di, gn, h, p, w, dt_bias, bias_dtype,
                                    d_skip, skip_dtype, grad, part_dt,
                                    d_dt_bias, s)
             : launch_in_bwd<__nv_bfloat16>(
                   dx, db, dc, ddt, dy, zx, rows, seq, sb, ss, di, gn, h, p, w,
                   dt_bias, bias_dtype, d_skip, skip_dtype, grad, part_dt,
                   d_dt_bias, s);
}

// Blocks per SM (out[0]), threads (out[1]), dynamic shared memory
// (out[2]) and ring stages (out[3]) of mamba_out_bwd's (which 0) or
// mamba_in_bwd's (which 1) vector-path kernel at d_inner di.
int repro_mamba_bwd_occupancy(int which, int dtype, int di, int* out) {
  if ((which != 0 && which != 1) || bad_code(dtype) || di <= 0 || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 0 ? occupancy<float>(which, di, out)
                    : occupancy<__nv_bfloat16>(which, di, out);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
