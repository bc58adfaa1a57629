// Tiled matmul for Hopper (sm_90a), FP32 FFMA, hand-written.
//
// Replaces: src/repro/kernels/matmul.py::_matmul_kernel, the Pallas TPU
// kernel that computes X @ Y over a (m/bm, n/bn, k/bk) grid with an f32
// accumulator zeroed at k-step 0, one dot(x_tile, y_tile) added per k-step
// and a cast to the input dtype at the last step.
//
// What it computes: out = x @ y for row-major x (m, k) and y (k, n), both
// float32 or both bfloat16, accumulated in float32 and cast to the input
// dtype.  Each output is one float32 accumulator that takes its k products
// in k order by FFMA (no TF32, no split-k, no atomics), so float32 stays
// IEEE and agrees with a float32 reference to 2e-5.
//
// Design.  On the TPU the grid runs in order on one core and the k axis is
// a sequential grid dimension carrying the accumulator in VMEM scratch.  On
// Hopper the blocks run in parallel and in no order, so the k axis is a
// loop inside the block: one thread block per (bm, bn) output tile walks k
// in bk-deep slabs and keeps the accumulator in registers.
//
//  * A ring of kStages slabs in shared memory, filled by cp.async (16-byte
//    copies straight from device memory, no registers, one commit group per
//    slab).  While slab t is computed, slabs t + 1 .. t + kStages - 1 are
//    in flight; one __syncthreads() per slab both publishes the slab that
//    arrived and frees the stage the next copy overwrites.
//  * 256 threads as a 16 x 16 grid.  Thread (ty, tx) owns TM = 4 GM rows,
//    ty * 4 + i + 64 g, and TN = 4 GN columns, tx * 4 + j + 64 h, of the
//    (bm, bn) = (64 GM, 64 GN) tile: two 4 x 4 quads per dimension at the
//    8 x 8 tile.  Its y values for one k step are GN 16-byte loads of
//    neighbouring columns; its x values are TM 16-byte loads that each
//    carry four k steps.  At 8 x 8 that is four 16-byte shared loads per
//    64 FFMAs, against 16 scalar loads in a strided layout.
//  * x stays row-major in shared memory, as it lies in device memory, so
//    every copy stays a 16-byte cp.async.  A transposing store (k-major x)
//    would have to go through registers and be prefetched a slab ahead by
//    hand; reading x along k in float4s needs neither.  A warp reads only
//    two x rows (ty and ty + 1) per load; the 16-byte chunks of a row are
//    XOR-swizzled by bit 2 of the row so those two rows never share a bank.
//    y's reads are 16 neighbouring float4s, free of conflicts as it lies.
//  * bfloat16 operands are copied as they are and converted to float32
//    when a thread loads them from shared memory.
//
// Tiles (what the tile tuner may pick, from this design): (bm, bn) in
// {64, 128, 256}^2 with GM GN <= 4 (at most 64 float32 accumulators a
// thread), bk in {8, 16, 32, 64, 128}, and the ring, kStages * 4 * (bm +
// bn) * bk bytes in float32, within the card's opt-in shared memory per
// block (232,448 bytes on the H100).  GM, GN and bk are template
// parameters: register arrays need compile-time sizes, and a compile-time
// slab depth lets the k loop unroll whole, so every shared-memory offset
// is an immediate and no register holds an address.  60 instantiations.
//
// What bounds it on the H100: for float32 at large tiles the FP32 FFMA
// rate (67 TFLOP/s outside the tensor cores, 700 W); for small tiles the
// memory traffic, since every block re-reads its (bm x k) and (k x bn)
// operand panels.  The register tile answers the first (16 FFMAs per
// 16-byte shared load at 8 x 8), the ring hides the copies
// behind the FFMAs, and the tuner picks large bm, bn for the second.
// bfloat16 on the tensor cores (wgmma), TMA and warp specialisation are
// later designs.
//
// The launcher allocates nothing, never synchronises, launches on the
// stream it is given, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;    // threads per tile row / column
constexpr int kStages = 3;   // slabs in the cp.async ring

// four consecutive elements of shared memory as float32 (16-byte aligned
// for float, 8-byte for bfloat16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
// rounds to nearest even, like torch's cast
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
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

template <typename T, int GM, int GN, int BK>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
              T* __restrict__ out, int m, int n, int k) {
  constexpr int BM = 64 * GM;
  constexpr int BN = 64 * GN;
  constexpr int TM = 4 * GM;
  constexpr int TN = 4 * GN;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int XS = BM * BK;          // one x slab, row-major (stride BK)
  constexpr int YS = BK * BN;          // one y slab, row-major (stride BN)
  constexpr int XCPR = BK / EPC;       // 16-byte chunks per x slab row
  constexpr int YCPR = BN / EPC;       // 16-byte chunks per y slab row
  constexpr int SWZ = XCPR % 2 == 0 ? 1 : 0;  // x chunks: c ^ ((r >> 2) & 1)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  // every x row this thread reads, ty * 4 + i + 64 g, has (r >> 2) & 1 ==
  // ty & 1: one swizzle bit for all of them
  const int sw = SWZ * (ty & 1);
  const size_t row0 = static_cast<size_t>(blockIdx.y) * BM;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * BN;
  const T* xg = x + row0 * static_cast<size_t>(k);
  const T* yg = y + col0;

  auto load_slab = [&](int stage, int k0) {
    T* xs = smem + stage * (XS + YS);
    T* ys = xs + XS;
#pragma unroll
    for (int idx = tid; idx < BM * XCPR; idx += kThreads) {
      const int r = idx / XCPR, c = idx % XCPR;
      const int pc = c ^ (((r >> 2) & 1) * SWZ);
      cp_async16(xs + r * BK + pc * EPC,
                 xg + r * static_cast<size_t>(k) + k0 + c * EPC);
    }
#pragma unroll
    for (int idx = tid; idx < BK * YCPR; idx += kThreads) {
      const int r = idx / YCPR, c = idx % YCPR;
      cp_async16(ys + r * BN + c * EPC,
                 yg + static_cast<size_t>(k0 + r) * n + c * EPC);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int nk = k / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_slab(s, s * BK);
    cp_async_commit();
  }

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slab t landed
    __syncthreads();  // everyone's landed; slab t - 1 is read by no one
    const int pre = t + kStages - 1;
    if (pre < nk) load_slab(pre % kStages, pre * BK);
    cp_async_commit();  // empty groups keep the wait count uniform

    const T* xs = smem + (t % kStages) * (XS + YS) + ty * 4 * BK;
    const T* ys = smem + (t % kStages) * (XS + YS) + XS + tx * 4;
    // BK is a compile-time size: the loop unrolls whole and every shared
    // offset below is an immediate
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
      const T* xa = xs + (((kk / EPC) ^ sw) * EPC) + kk % EPC;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = load4(xa + ((i % 4) + 64 * (i / 4)) * BK);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float b[TN];
#pragma unroll
        for (int h = 0; h < GN; ++h) {
          const float4 v = load4(ys + (kk + e) * BN + 64 * h);
          b[4 * h] = v.x;
          b[4 * h + 1] = v.y;
          b[4 * h + 2] = v.z;
          b[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = e == 0 ? a[i].x : e == 1 ? a[i].y
                         : e == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const size_t r = row0 + ty * 4 + (i % 4) + 64 * (i / 4);
#pragma unroll
    for (int h = 0; h < GN; ++h)
      store4(out + r * n + col0 + tx * 4 + 64 * h, acc[i][4 * h],
             acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

template <typename T, int GM, int GN, int BK>
int launch(const void* x, const void* y, void* out, int m, int n, int k,
           cudaStream_t stream) {
  constexpr int BM = 64 * GM;
  constexpr int BN = 64 * GN;
  const size_t smem = sizeof(T) * kStages * static_cast<size_t>(BM + BN) *
                      BK;
  auto kernel = matmul_kernel<T, GM, GN, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / BN, m / BM);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(y),
                                           static_cast<T*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int GM, int GN>
int dispatch_depth(const void* x, const void* y, void* out, int m, int n,
                   int k, int bk, cudaStream_t s) {
  switch (bk) {
    case 8: return launch<T, GM, GN, 8>(x, y, out, m, n, k, s);
    case 16: return launch<T, GM, GN, 16>(x, y, out, m, n, k, s);
    case 32: return launch<T, GM, GN, 32>(x, y, out, m, n, k, s);
    case 64: return launch<T, GM, GN, 64>(x, y, out, m, n, k, s);
    case 128: return launch<T, GM, GN, 128>(x, y, out, m, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const void* y, void* out, int m, int n, int k,
             int bm, int bn, int bk, cudaStream_t stream) {
#define REPRO_TILE(GM_, GN_)                                         \
  if (bm == 64 * (GM_) && bn == 64 * (GN_))                          \
    return dispatch_depth<T, GM_, GN_>(x, y, out, m, n, k, bk, stream);
  REPRO_TILE(1, 1) REPRO_TILE(1, 2) REPRO_TILE(2, 1) REPRO_TILE(2, 2)
  REPRO_TILE(1, 4) REPRO_TILE(4, 1)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The caller guarantees contiguous
// row-major operands on the current device, 16-byte aligned, and tiles
// that divide the dims.
int repro_matmul(const void* x, const void* y, void* out, int m, int n, int k,
                 int bm, int bn, int bk, int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      m % bm || n % bn || k % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, y, out, m, n, k, bm, bn, bk, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, y, out, m, n, k, bm, bn, bk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
