// The block RMSNorm for Hopper (sm_90a), hand-written: the forward and its
// gradient.
//
// Replaces: no Pallas body.  The reference's rmsnorm
// (src/repro/models/layers.py:11-16) runs under jit, where XLA fuses the
// square, the row mean, rsqrt, the two products and the round to the
// model's dtype into one pass, and their backward into another.  The port
// runs eagerly: its plain version (kernels/rmsnorm.py, rmsnorm_plain) is
// some ten launches forward, each writing and reading back a float32
// temporary of the rows' width, and autograd's chain backward.  Every
// model runs it: before each block's mixer, before each FFN and as the
// final norm, in prefill, decode, serving and training alike.
//
// What it computes, per row of x (rows x d, the last dim contiguous; T the
// model's dtype, bfloat16 or float32; scale (d,) in T):
//  * rmsnorm_fwd_kernel: var = sum(x^2) / d in float32, rstd = rsqrt(var +
//    eps), y = round_T((x rstd)(1 + scale)); rstd saved (float32).  The
//    products, the terms of the sum and the quotient are __f*_rn (nothing
//    contracts into an FMA), in the plain version's order; only the order
//    of the row's sum differs from torch's.
//  * rmsnorm_bwd_kernel: with x_hat = x rstd and g = dy (1 + scale),
//    dx = round_T(rstd (g - x_hat (sum(g x_hat) / d))); and each block's
//    column sums of dy x_hat over a fixed group of rows (float32 partials);
//  * rmsnorm_bwd_finish_kernel: scale's gradient (float32), each column's
//    partials added in block order, a slice of the groups a warp, the
//    slices then added in order.
// No atomics, and the row groups depend on the row count alone, so two
// calls give the same bits.
//
// What bounds it on the H100 (3.35 TB/s): bytes.  At mamba2-2.7b's width
// (4096 x 2560, bfloat16) the forward moves 42 MB (x in, y out: 12.5 us),
// the backward 63 MB (x, dy in, dx out: 18.8 us), some 3 and 8 flops an
// element.  Each is one row's latency chain -- the loads, a row sum, the
// stores -- so the design keeps many rows' bytes in flight:
//  * a row is a team of `warps` warps, each thread holding `chunks` chunks
//    of 8 elements in registers (16-byte loads: one a chunk in bfloat16,
//    two in float32), at most 4 chunks a thread in bfloat16 and 2 in
//    float32, so a team is as narrow as the row allows (2560 columns: 3
//    warps in bfloat16, 5 in float32);
//  * the row's sum is a warp's butterfly and, across the team's warps, one
//    barrier and every thread adding the warps' sums in order;
//  * the forward's teams take rows in turn (8 / warps teams a block, a
//    grid of as many blocks as the card holds at once), each thread's
//    slots of its next row loaded into registers before the current row's
//    sum, so a row's loads are in flight across another's sum;
//  * the backward gives a block a fixed group of rows (at most
//    kBwdBlocks groups: two blocks an SM on the H100's 132), 8 / warps
//    teams taking the group's rows in turn, each thread's next row (x,
//    dy, rstd) in registers before the current row's sum; each thread's
//    column sums stay in registers across the group, the teams' added in
//    team order in shared memory at the block's end.
// A row whose width or offsets are not multiples of 8 elements takes a
// scalar path of the same arithmetic (16 elements a thread, strided).
//
// The wrapper (kernels/rmsnorm.py) allocates every output and the
// partials' scratch (as many rows as row_groups gives), checks dtypes and
// shapes, and launches on PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;           // elements a vector slot
constexpr int kMaxChunksBf16 = 4;   // chunks a thread holds, bfloat16
constexpr int kMaxChunksF32 = 2;    // chunks a thread holds, float32
constexpr int kScalarCap = 16;      // elements a thread holds (scalar path)
// warps a block, when a row takes fewer: the forward's and the backward's
constexpr int kFwdBlockWarps = 8;
constexpr int kBwdBlockWarps = 8;
constexpr int kMaxWidth = 8192;     // the widest row the kernels hold
constexpr int kMaxWarps = 16;       // a block's warps, at most
constexpr int kMaxThreads = 32 * kMaxWarps;
// row groups of the backward's column partials, at most: two blocks an SM
// on the H100's 132 SMs
constexpr int kBwdBlocks = 264;
constexpr int kFinishCols = 32;     // the finish: columns a block
constexpr int kFinishSlices = 32;   // the finish: slices of the groups

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

__device__ __forceinline__ float2 bf2_to_f2(unsigned int bits) {
  __nv_bfloat162 h;
  *reinterpret_cast<unsigned int*>(&h) = bits;
  return __bfloat1622float2(h);
}

__device__ __forceinline__ unsigned int f2_to_bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned int*>(&h);
}

// A slot of a row as loaded, E elements of T: 8 (one 16-byte load in
// bfloat16, two in float32; 16-byte aligned) or 1 (the scalar path).
template <typename T, int E>
struct Slot;

template <>
struct Slot<__nv_bfloat16, kChunk> {
  uint4 a;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    a = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { a = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float (&v)[kChunk]) const {
    const unsigned int w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = bf2_to_f2(w[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Slot<float, kChunk> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __device__ __forceinline__ void get(float (&v)[kChunk]) const {
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
};

template <typename T>
struct Slot<T, 1> {
  T a;
  __device__ __forceinline__ void load(const T* p) { a = *p; }
  __device__ __forceinline__ void zero() { a = from_f<T>(0.0f); }
  __device__ __forceinline__ void get(float (&v)[1]) const { v[0] = to_f(a); }
};

// E values stored as T, each rounded to nearest even
__device__ __forceinline__ void store_slot(float* p, const float (&v)[kChunk]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store_slot(__nv_bfloat16* p,
                                           const float (&v)[kChunk]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(f2_to_bf2(v[0], v[1]), f2_to_bf2(v[2], v[3]),
                 f2_to_bf2(v[4], v[5]), f2_to_bf2(v[6], v[7]));
}
template <typename T>
__device__ __forceinline__ void store_slot(T* p, const float (&v)[1]) {
  *p = from_f<T>(v[0]);
}

// The offset of row r of x, whose rows are (outer, inner) pairs at element
// strides sb and ss, seq inner rows an outer one.
__device__ __forceinline__ long long row_offset(long long r, long long seq,
                                                long long sb, long long ss) {
  const long long b = r / seq;
  return b * sb + (r - b * seq) * ss;
}

// A team's sum of v in a fixed order: each warp's butterfly, then (a team
// of more than one warp) the warps' sums in order, added by every thread
// after one barrier.  red: the team's `warps` floats of shared memory.
// Every thread of the block calls it (the barrier), `warps` the same for
// all.
__device__ __forceinline__ float team_sum(float v, float* red, int warps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (warps == 1) return v;
  const int w = (threadIdx.x >> 5) % warps;
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float s = red[0];
  for (int i = 1; i < warps; ++i) s = __fadd_rn(s, red[i]);
  return s;
}

// ----------------------------------------------------------- forward --

// Rows in turn: block b's teams take the rows (b + i grid) teams + team,
// i = 0, 1, ... (a grid of as many blocks as the card holds at once), each
// thread's C slots (slot c = t + k * team width) of the next row loaded
// into registers before the current row's sum.
template <typename T, int C, int E>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_fwd_kernel(const T* __restrict__ x, long long rows, long long seq,
                       long long sb, long long ss, int d, int warps,
                       const T* __restrict__ scale, float eps,
                       T* __restrict__ y, float* __restrict__ rstd) {
  __shared__ float red[2][kMaxWarps];
  const int width = 32 * warps;
  const int team = threadIdx.x / width, t = threadIdx.x - team * width;
  const int teams = blockDim.x / width;
  const int slots = d / E;
  const long long first = static_cast<long long>(blockIdx.x) * teams;
  const long long stride = static_cast<long long>(gridDim.x) * teams;
  // the same for every team of the block (the grid holds no empty block)
  const int iters = static_cast<int>((rows - first + stride - 1) / stride);

  Slot<T, E> nx[C];
  auto fetch = [&](long long row) {
    const bool live = row < rows;
    const T* xr = x + (live ? row_offset(row, seq, sb, ss) : 0);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = t + k * width;
      if (live && c < slots)
        nx[k].load(xr + static_cast<long long>(c) * E);
      else
        nx[k].zero();
    }
  };

  long long row = first + team;
  fetch(row);
  for (int it = 0; it < iters; ++it, row += stride) {
    Slot<T, E> v[C];
#pragma unroll
    for (int k = 0; k < C; ++k) v[k] = nx[k];
    if (it + 1 < iters) fetch(row + stride);  // in flight across the sum
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      float f[E];
      v[k].get(f);
#pragma unroll
      for (int e = 0; e < E; ++e) sum = __fadd_rn(sum, __fmul_rn(f[e], f[e]));
    }
    sum = team_sum(sum, red[it & 1] + team * warps, warps);
    const float r =
        rsqrtf(__fadd_rn(__fdiv_rn(sum, static_cast<float>(d)), eps));
    if (row < rows) {
      T* yr = y + row * d;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int c = t + k * width;
        if (c < slots) {
          float f[E], s[E], o[E];
          v[k].get(f);
          Slot<T, E> sc;
          sc.load(scale + static_cast<long long>(c) * E);
          sc.get(s);
#pragma unroll
          for (int e = 0; e < E; ++e)
            o[e] = __fmul_rn(__fmul_rn(f[e], r), __fadd_rn(1.0f, s[e]));
          store_slot(yr + static_cast<long long>(c) * E, o);
        }
      }
      if (t == 0) rstd[row] = r;
    }
  }
}

// ---------------------------------------------------------- backward --

// The backward's launch bound: bfloat16 rows take at most 8 warps a block
// (4 chunks a thread up to 8192 columns), float32 rows and the scalar path
// up to 16.
template <typename T, int E>
constexpr int bwd_threads() {
  return sizeof(T) == 2 && E == kChunk ? 32 * kBwdBlockWarps : kMaxThreads;
}

// A block a fixed group of rows [g0, g1), its teams taking rows g0 + team,
// g0 + team + teams, ...; each thread's next row in registers before the
// current row's sum (the vector path); the column sums of dy x_hat in
// registers, the teams' added in team order at the end (in shared memory)
// into the block's partial row.
template <typename T, int C, int E>
__global__ void __launch_bounds__(bwd_threads<T, E>())
    rmsnorm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                       long long rows, long long seq, long long sb,
                       long long ss, const float* __restrict__ rstd, int d,
                       int warps, long long per, const T* __restrict__ scale,
                       T* __restrict__ dx, float* __restrict__ part) {
  extern __shared__ float col_sum[];  // d floats when teams > 1
  __shared__ float red[2][kMaxWarps];
  const int width = 32 * warps;
  const int team = threadIdx.x / width, t = threadIdx.x - team * width;
  const int teams = blockDim.x / width;
  const int slots = d / E;
  const long long g0 = static_cast<long long>(blockIdx.x) * per;
  const long long g1 = g0 + per < rows ? g0 + per : rows;
  const int iters = static_cast<int>((g1 - g0 + teams - 1) / teams);

  float acc[C][E];
#pragma unroll
  for (int k = 0; k < C; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[k][e] = 0.0f;

  Slot<T, E> nx[C], ndy[C];
  float nr = 0.0f;
  auto fetch = [&](long long row) {
    const bool live = row < g1;
    const T* xr = x + (live ? row_offset(row, seq, sb, ss) : 0);
    const T* dr = dy + (live ? row * d : 0);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = t + k * width;
      if (live && c < slots) {
        nx[k].load(xr + static_cast<long long>(c) * E);
        ndy[k].load(dr + static_cast<long long>(c) * E);
      } else {
        nx[k].zero();
        ndy[k].zero();
      }
    }
    nr = live ? __ldg(rstd + row) : 0.0f;
  };

  // the scalar path loads each row as it starts: its 16 slots a thread
  // leave no registers for a second row
  constexpr bool kAhead = E != 1;
  long long row = g0 + team;
  if (kAhead) fetch(row);
  for (int it = 0; it < iters; ++it, row += teams) {
    const bool active = row < g1;
    if (!kAhead) fetch(row);
    Slot<T, E> cx[C], cdy[C];
#pragma unroll
    for (int k = 0; k < C; ++k) cx[k] = nx[k], cdy[k] = ndy[k];
    const float r = nr;
    if (kAhead && it + 1 < iters)
      fetch(row + teams);  // in flight across the sum

    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = t + k * width;
      if (c < slots) {
        float xf[E], gf[E], s[E];
        cx[k].get(xf);
        cdy[k].get(gf);
        Slot<T, E> sc;
        sc.load(scale + static_cast<long long>(c) * E);
        sc.get(s);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xh = __fmul_rn(xf[e], r);
          const float g = __fmul_rn(gf[e], __fadd_rn(1.0f, s[e]));
          sum = __fadd_rn(sum, __fmul_rn(g, xh));
          if (active) acc[k][e] = __fadd_rn(acc[k][e], __fmul_rn(gf[e], xh));
        }
      }
    }
    sum = team_sum(sum, red[it & 1] + team * warps, warps);
    const float mean = __fdiv_rn(sum, static_cast<float>(d));
    if (active) {
      T* dr = dx + row * d;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int c = t + k * width;
        if (c < slots) {
          float xf[E], gf[E], s[E], o[E];
          cx[k].get(xf);
          cdy[k].get(gf);
          Slot<T, E> sc;
          sc.load(scale + static_cast<long long>(c) * E);
          sc.get(s);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float xh = __fmul_rn(xf[e], r);
            const float g = __fmul_rn(gf[e], __fadd_rn(1.0f, s[e]));
            o[e] = __fmul_rn(r, __fsub_rn(g, __fmul_rn(xh, mean)));
          }
          store_slot(dr + static_cast<long long>(c) * E, o);
        }
      }
    }
  }

  // the block's partial row: the teams' column sums in team order
  float* out = part + static_cast<long long>(blockIdx.x) * d;
  for (int tm = 0; tm < teams; ++tm) {
    if (team == tm) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int c = t + k * width;
        if (c < slots) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int col = c * E + e;
            const float v = tm == 0 ? acc[k][e]
                                    : __fadd_rn(col_sum[col], acc[k][e]);
            if (tm == teams - 1)
              out[col] = v;
            else
              col_sum[col] = v;
          }
        }
      }
    }
    if (tm + 1 < teams) __syncthreads();
  }
}

// scale's gradient (float32): column col's partials added in block order
// over kFinishSlices slices of the groups (a warp a slice, 32 columns a
// block), the slices then added in order by the first warp.
__global__ void __launch_bounds__(kFinishCols* kFinishSlices)
    rmsnorm_bwd_finish_kernel(const float* __restrict__ part, int nb, int d,
                              float* __restrict__ dscale) {
  __shared__ float red[kFinishSlices][kFinishCols];
  const int lane = threadIdx.x % kFinishCols;
  const int slice = threadIdx.x / kFinishCols;
  const int col = blockIdx.x * kFinishCols + lane;
  const int per = (nb + kFinishSlices - 1) / kFinishSlices;
  const int b0 = slice * per;
  const int b1 = b0 + per < nb ? b0 + per : nb;
  float s = 0.0f;
  if (col < d) {
#pragma unroll 8
    for (int b = b0; b < b1; ++b)
      s = __fadd_rn(s, part[static_cast<long long>(b) * d + col]);
  }
  red[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && col < d) {
    float tot = red[0][lane];
    for (int q = 1; q < kFinishSlices; ++q) tot = __fadd_rn(tot, red[q][lane]);
    dscale[col] = tot;
  }
}

// ----------------------------------------------------------- launches --

struct Plan {
  int vec;     // the vector path (16-byte slots)
  int chunks;  // slots a thread (a chunk of 8, or an element)
  int warps;   // warps a row
  int teams;   // rows a block at once
};

// The plan of `which` (0 forward, 1 backward) at width d: as few warps a
// row as the slots a thread allow, and as many rows a block as fill
// kFwdBlockWarps (kBwdBlockWarps) warps.
Plan plan_of(int which, int d, bool bf16, bool vec) {
  Plan p;
  p.vec = vec;
  if (vec) {
    const int slots = d / kChunk;
    const int cmax = bf16 ? kMaxChunksBf16 : kMaxChunksF32;
    p.warps = (slots + 32 * cmax - 1) / (32 * cmax);
    p.chunks = (slots + 32 * p.warps - 1) / (32 * p.warps);
  } else {
    p.warps = (d + 32 * kScalarCap - 1) / (32 * kScalarCap);
    p.chunks = kScalarCap;
  }
  const int fill = which == 0 ? kFwdBlockWarps : kBwdBlockWarps;
  p.teams = p.warps >= fill ? 1 : fill / p.warps;
  return p;
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A backward's row groups: at most `most`, from the row count alone.
void row_groups(long long rows, int most, long long* per, int* nb) {
  const long long blocks = rows < most ? rows : most;
  *per = (rows + blocks - 1) / blocks;
  *nb = static_cast<int>((rows + *per - 1) / *per);
}

int err() { return static_cast<int>(cudaGetLastError()); }

// The kernel of `which` (0 forward, 1 backward) for a plan.
template <typename T>
const void* kernel_of(int which, const Plan& p) {
#define REPRO_PICK(C, E)                                            \
  return which == 0 ? (const void*)rmsnorm_fwd_kernel<T, C, E>     \
                    : (const void*)rmsnorm_bwd_kernel<T, C, E>
  if (!p.vec) {
    REPRO_PICK(kScalarCap, 1);
  }
  if constexpr (sizeof(T) == 2) {
    switch (p.chunks) {
      case 1: REPRO_PICK(1, kChunk);
      case 2: REPRO_PICK(2, kChunk);
      case 3: REPRO_PICK(3, kChunk);
      case 4: REPRO_PICK(4, kChunk);
    }
  } else {
    switch (p.chunks) {
      case 1: REPRO_PICK(1, kChunk);
      case 2: REPRO_PICK(2, kChunk);
    }
  }
#undef REPRO_PICK
  return nullptr;
}

// the backward's shared memory: the teams' column sums, added in turn
size_t bwd_smem(const Plan& p, int d) {
  return p.teams > 1 ? sizeof(float) * static_cast<size_t>(d) : 0;
}

// Blocks of `kernel` (at `threads` threads, no dynamic shared memory) the
// current card holds at once: its SMs times the blocks an SM holds, asked
// once a kernel, block size and card.
int resident_blocks(const void* kernel, int threads) {
  struct Entry {
    const void* kernel;
    int dev, threads, blocks;
  };
  static Entry cache[64];
  static int n = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < n; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev &&
        cache[i].threads == threads)
      return cache[i].blocks;
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = per_sm * sms > 0 ? per_sm * sms : 1;
  if (n < 64) cache[n++] = {kernel, dev, threads, blocks};
  return blocks;
}

// the forward's grid: one block a `teams` rows, at most as many blocks as
// the card holds at once
long long fwd_grid(const void* kernel, const Plan& p, long long rows) {
  const long long want = (rows + p.teams - 1) / p.teams;
  const long long most = resident_blocks(kernel, 32 * p.warps * p.teams);
  return want < most ? want : most;
}

bool vec_ok(int d, long long sb, long long ss, const void* x,
            const void* scale, const void* a, const void* b) {
  return d % kChunk == 0 && sb % kChunk == 0 && ss % kChunk == 0 &&
         aligned(x) && aligned(scale) && aligned(a) && aligned(b);
}

template <typename T>
int launch_fwd(const void* x, long long rows, long long seq, long long sb,
               long long ss, int d, const void* scale, float eps, void* y,
               void* rstd, cudaStream_t s) {
  const Plan p = plan_of(0, d, sizeof(T) == 2,
                         vec_ok(d, sb, ss, x, scale, y, y));
  const void* kernel = kernel_of<T>(0, p);
  if (!kernel) return static_cast<int>(cudaErrorInvalidConfiguration);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* yp = static_cast<T*>(y);
  float* rp = static_cast<float*>(rstd);
  int warps = p.warps;
  void* args[] = {&xp, &rows, &seq, &sb, &ss, &d, &warps, &sp, &eps,
                  &yp, &rp};
  cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(fwd_grid(kernel, p,
                                                               rows))),
                   dim3(32 * p.warps * p.teams), args, 0, s);
  return err();
}

template <typename T>
int launch_bwd(const void* dy, const void* x, long long rows, long long seq,
               long long sb, long long ss, const void* rstd, int d,
               const void* scale, void* dx, void* part, void* dscale,
               cudaStream_t s) {
  const Plan p = plan_of(1, d, sizeof(T) == 2,
                         vec_ok(d, sb, ss, x, scale, dy, dx) &&
                             aligned(part));
  const void* kernel = kernel_of<T>(1, p);
  if (!kernel) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long per;
  int nb;
  row_groups(rows, kBwdBlocks, &per, &nb);
  const T* dp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const float* rp = static_cast<const float*>(rstd);
  const T* sp = static_cast<const T*>(scale);
  T* gp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  int warps = p.warps;
  void* args[] = {&dp, &xp, &rows, &seq, &sb, &ss, &rp, &d, &warps, &per,
                  &sp, &gp, &pp};
  cudaLaunchKernel(kernel, dim3(nb), dim3(32 * p.warps * p.teams), args,
                   bwd_smem(p, d), s);
  int e = err();
  if (e != 0) return e;
  rmsnorm_bwd_finish_kernel<<<(d + kFinishCols - 1) / kFinishCols,
                              kFinishCols * kFinishSlices, 0, s>>>(
      pp, nb, d, static_cast<float*>(dscale));
  return err();
}

// What a launch of `which` (0 forward, 1 backward) makes at width d over
// `rows` rows on the vector path (vec 1) or the scalar path: out = {threads
// a block, slots a thread, warps a row, rows a block, blocks, blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), dynamic shared memory}.
template <typename T>
int launch_of(int which, int d, long long rows, int vec, int* out) {
  const Plan p = plan_of(which, d, sizeof(T) == 2, vec != 0);
  const void* kernel = kernel_of<T>(which, p);
  if (!kernel) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int threads = 32 * p.warps * p.teams;
  const size_t smem = which == 0 ? 0 : bwd_smem(p, d);
  long long per;
  int nb;
  row_groups(rows, kBwdBlocks, &per, &nb);
  out[0] = threads, out[1] = p.chunks, out[2] = p.warps, out[3] = p.teams;
  out[4] = which == 0 ? static_cast<int>(fwd_grid(kernel, p, rows)) : nb;
  out[6] = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 5, kernel, threads, smem));
}

bool bad_code(int code) { return code != 0 && code != 1; }

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, for x, scale, y, dy and dx
// alike.  x's rows are (outer, inner) pairs at element strides sb and ss,
// seq inner rows an outer one, each row's d elements contiguous; every
// other tensor is contiguous; rstd and dscale are float32.

int repro_rmsnorm_fwd(const void* x, int dtype, long long rows, long long seq,
                      long long sb, long long ss, int d, const void* scale,
                      float eps, void* y, void* rstd, void* stream) {
  if (rows <= 0 || seq <= 0 || d <= 0 || d > kMaxWidth || bad_code(dtype) ||
      !x || !scale || !y || !rstd)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_fwd<float>(x, rows, seq, sb, ss, d, scale, eps,
                                        y, rstd, s)
                    : launch_fwd<__nv_bfloat16>(x, rows, seq, sb, ss, d,
                                                scale, eps, y, rstd, s);
}

// part: the partials' scratch, row_groups(rows) rows of d floats.
int repro_rmsnorm_bwd(const void* dy, const void* x, int dtype, long long rows,
                      long long seq, long long sb, long long ss,
                      const void* rstd, int d, const void* scale, void* dx,
                      void* part, void* dscale, void* stream) {
  if (rows <= 0 || seq <= 0 || d <= 0 || d > kMaxWidth || bad_code(dtype) ||
      !dy || !x || !rstd || !scale || !dx || !part || !dscale)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_bwd<float>(dy, x, rows, seq, sb, ss, rstd, d, scale, dx,
                                 part, dscale, s)
             : launch_bwd<__nv_bfloat16>(dy, x, rows, seq, sb, ss, rstd, d,
                                         scale, dx, part, dscale, s);
}

// out[7]: see launch_of.
int repro_rmsnorm_launch(int which, int dtype, int d, long long rows, int vec,
                         int* out) {
  if ((which != 0 && which != 1) || bad_code(dtype) || d <= 0 ||
      d > kMaxWidth || rows <= 0 || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 0 ? launch_of<float>(which, d, rows, vec, out)
                    : launch_of<__nv_bfloat16>(which, d, rows, vec, out);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
