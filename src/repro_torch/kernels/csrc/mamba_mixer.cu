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
// float32): mamba_in lays the (row, 8-column chunk) pairs out flat, four
// loads a thread in flight before its stores; mamba_out and mamba_out_bwd
// give a row one block and a chunk one thread (ceil(di / 8) threads, up
// to 1024: di <= 8192), the thread's chunk held in registers across the
// row's block-wide sum; mamba_out_bwd keeps y_t, sigmoid(z) and d_out of
// its chunk in registers and rereads only x and z (cache hits) after the
// sum, and its column sums in shared memory (2 di floats a block).  A row
// whose offsets are not all multiples of 8 elements, or whose head dim P
// is not (the reduced widths of the tests), takes a scalar path of the
// same arithmetic.
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
constexpr int kFinishThreads = 1024;
constexpr int kRowThreads = 256; // the in passes' blocks
constexpr int kDtCap = 4;        // dt columns a thread of mamba_in_bwd owns
constexpr int kInItems = 4;      // chunks a thread of mamba_in loads at once
// row groups of the backwards' partials: mamba_out_bwd's sums are d_inner
// wide, mamba_in_bwd's H
constexpr int kOutBwdBlocks = 256;
constexpr int kInBwdBlocks = 2048;
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

// A block owns rows_per_block rows; each thread's column sums (norm_g's
// and d_skip's) live in dynamic shared memory (2 di floats), each thread
// touching only its own columns.  Per row: pass A loads d_out, y, x and z,
// keeps y_t, sigmoid(z) and d_out in registers and forms the row's dot;
// pass B reloads x and z (cache hits) for the writes.
template <typename T, bool kVec>
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
  constexpr int kN = kVec ? kChunk : 1;
  constexpr int kSteps = kVec ? kCap : kCapScalar;
  extern __shared__ float sums[];
  float* acc_g = sums;
  float* acc_s = sums + di;
  __shared__ float red[33];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int col = held_col<kVec>(k);
    if (col >= di) break;
#pragma unroll
    for (int e = 0; e < kN; ++e) acc_g[col + e] = acc_s[col + e] = 0.0f;
  }
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (long long row = r0; row < r1; ++row) {
    const T* zrow = row_of(zx, row, seq, sb, ss);
    const float* yrow = y + row * di;
    const T* drow = dout + row * di;
    float yt[kSteps][kN], sg[kSteps][kN], dof[kSteps][kN];
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int col = held_col<kVec>(k);
      if (col >= di) break;
      float xv[kN], zv[kN], g[kN];
      gated<T, kN>(yrow, zrow + di, zrow, d_skip, skip_bf16, col, p, yt[k],
                   sg[k], xv, zv);
      if constexpr (kN == kChunk) {
        load8(drow + col, dof[k]);
        load8_vec(norm_g, g_bf16, col, g);
      } else {
        dof[k][0] = to_f(drow[col]);
        g[0] = vec_at(norm_g, g_bf16, col);
      }
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float u = __fmul_rn(yt[k][e], __fmul_rn(zv[e], sg[k][e]));
        const float a = __fmul_rn(dof[k][e], __fadd_rn(1.0f, g[e]));
        dot = __fadd_rn(dot, __fmul_rn(a, u));
      }
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
    for (int k = 0; k < kSteps; ++k) {
      const int col = held_col<kVec>(k);
      if (col >= di) break;
      float xv[kN], zv[kN], g[kN], dyo[kN], dzo[kN];
      if constexpr (kN == kChunk) {
        load8(zrow + di + col, xv);
        load8(zrow + col, zv);
        load8_vec(norm_g, g_bf16, col, g);
      } else {
        xv[0] = to_f(zrow[di + col]);
        zv[0] = to_f(zrow[col]);
        g[0] = vec_at(norm_g, g_bf16, col);
      }
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float sz = __fmul_rn(zv[e], sg[k][e]);
        const float u = __fmul_rn(yt[k][e], sz);
        const float a = __fmul_rn(dof[k][e], __fadd_rn(1.0f, g[e]));
        const float vu = __fmul_rn(kvar, u);
        const float du = __fadd_rn(__fmul_rn(a, r), __fadd_rn(vu, vu));
        dyo[e] = round_to<T>(__fmul_rn(du, sz));
        dzo[e] = silu_grad(__fmul_rn(du, yt[k][e]), zv[e], sg[k][e]);
        acc_g[col + e] = __fadd_rn(acc_g[col + e],
                                   __fmul_rn(dof[k][e], __fmul_rn(u, r)));
        acc_s[col + e] = __fadd_rn(acc_s[col + e], __fmul_rn(dyo[e], xv[e]));
      }
      if constexpr (kN == kChunk) {
        store8(dyrow + col, dyo);
        store8(grow + col, dzo);
      } else {
        dyrow[col] = dyo[0];
        grow[col] = from_f<T>(dzo[0]);
      }
    }
  }
  float* pg = part_g + static_cast<long long>(blockIdx.x) * di;
  float* ps = part_s + static_cast<long long>(blockIdx.x) * di;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int col = held_col<kVec>(k);
    if (col >= di) break;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      pg[col + e] = acc_g[col + e];
      ps[col + e] = acc_s[col + e];
    }
  }
}

// norm_g's gradient (float32, a column each) and d_skip's (a head each:
// its P columns added in order); one block a head, a thread a column.
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

template <typename T, bool kVec>
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
    if (kVec) {
      for (int col = threadIdx.x * kChunk; col < width;
           col += blockDim.x * kChunk) {
        float v[kChunk];
        if (col < di) {
          float dyv[kChunk];
          load8(dxr + col, v);
          load8(dyr + col, dyv);
          const float d = vec_at(d_skip, skip_bf16, col / p);
#pragma unroll
          for (int e = 0; e < kChunk; ++e)
            v[e] = __fadd_rn(v[e], __fmul_rn(d, dyv[e]));
        } else if (col < di + gn) {
          load8(dbr + (col - di), v);
        } else {
          load8(dcr + (col - di - gn), v);
        }
        store8(grow + col, v);
      }
    } else {
      for (int col = threadIdx.x; col < width; col += blockDim.x) {
        float v;
        if (col < di)
          v = __fadd_rn(dxr[col],
                        __fmul_rn(vec_at(d_skip, skip_bf16, col / p),
                                  dyr[col]));
        else if (col < di + gn)
          v = dbr[col - di];
        else
          v = dcr[col - di - gn];
        grow[col] = from_f<T>(v);
      }
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

// dt_bias's gradient: each column's partials added in block order
__global__ void __launch_bounds__(kRowThreads)
    mamba_in_bwd_finish_kernel(const float* __restrict__ part_dt, int nb,
                               int h, float* __restrict__ d_dt_bias) {
  for (int k = threadIdx.x; k < h; k += blockDim.x) {
    float s = 0.0f;
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
                   aligned(grad) && aligned(norm_g);
  const int threads = row_threads(di);
  if (threads == 0 || p > kFinishThreads)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  long long per;
  int nb;
  row_groups(rows, kOutBwdBlocks, &per, &nb);
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(di);
  const T* d = static_cast<const T*>(dout);
  const float* yp = static_cast<const float*>(y);
  const T* z = static_cast<const T*>(zx);
  const float* rp = static_cast<const float*>(r);
  float* dyp = static_cast<float*>(dy);
  T* g = static_cast<T*>(grad);
  float *pg = static_cast<float*>(part_g), *ps = static_cast<float*>(part_s);
  if (vec) {
    cudaFuncSetAttribute(mamba_out_bwd_kernel<T, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    mamba_out_bwd_kernel<T, true><<<nb, threads, smem, s>>>(
        d, yp, z, seq, sb, ss, rp, rows, per, di, p, w, d_skip, skip_bf16,
        norm_g, g_bf16, dyp, g, pg, ps);
  } else {
    cudaFuncSetAttribute(mamba_out_bwd_kernel<T, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    mamba_out_bwd_kernel<T, false><<<nb, threads, smem, s>>>(
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
  const bool vec = di % kChunk == 0 && gn % kChunk == 0 && w % kChunk == 0 &&
                   p % kChunk == 0 && aligned(dx) && aligned(db) &&
                   aligned(dc) && aligned(dy) && aligned(grad);
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
  if (vec)
    mamba_in_bwd_kernel<T, true><<<nb, kRowThreads, 0, s>>>(
        a, bp, cp, tp, yp, z, seq, sb, ss, rows, per, di, gn, h, p, w,
        dt_bias, bias_bf16, d_skip, skip_bf16, g, pd);
  else
    mamba_in_bwd_kernel<T, false><<<nb, kRowThreads, 0, s>>>(
        a, bp, cp, tp, yp, z, seq, sb, ss, rows, per, di, gn, h, p, w,
        dt_bias, bias_bf16, d_skip, skip_bf16, g, pd);
  int e = err();
  if (e != 0) return e;
  mamba_in_bwd_finish_kernel<<<1, kRowThreads, 0, s>>>(
      pd, nb, h, static_cast<float*>(d_dt_bias));
  return err();
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

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
