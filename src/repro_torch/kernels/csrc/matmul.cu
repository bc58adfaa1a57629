// Tiled matmul for Hopper (sm_90a), hand-written, by two routes.
//
// Replaces: src/repro/kernels/matmul.py::_matmul_kernel (:27), the Pallas
// TPU kernel that computes X @ Y over a (m/bm, n/bn, k/bk) grid with an f32
// accumulator zeroed at k-step 0, one dot(x_tile, y_tile) added per k-step
// and a cast to the input dtype at the last step.
//
// What it computes: out = x @ y for row-major x (m, k) and y (k, n), both
// float32 or both bfloat16, accumulated in float32 and cast once to the
// input dtype.  No split-k and no atomics: one block owns an output tile
// and sums its k in one fixed order, so two calls give the same bits.
//
// On the TPU the grid runs in order on one core and the k axis is a
// sequential grid dimension carrying the accumulator in VMEM scratch.  On
// Hopper the blocks run in parallel and in no order, so the k axis is a
// loop inside the block: one thread block per (bm, bn) output tile walks k
// in bk-deep slabs and keeps the accumulator in registers.
//
// Two routes, chosen by an explicit table (matmul_route in matmul.py,
// route_of below), neither a fall back for the other; a tile that neither
// takes is refused.
//
//  1. wgmma, the tensor cores: bfloat16 at bm in {64, 128}, bn in {64, 128,
//     256}, bk = 64, and float32 at bm, bn in {64, 128}, bk = 32 -- slabs of
//     128-byte rows, the width of the 128-byte swizzle.  One producer warp,
//     of which one thread issues every TMA copy into a ring of stages (as
//     many as the card's 232,448 bytes of opt-in shared memory hold, at
//     most 8), each stage on a full and an empty mbarrier; bm / 64 consumer
//     warpgroups of 64 rows each run wgmma with float32 accumulators (no
//     setmaxnreg split: ptxas holds the 288 threads of a block at bm 128
//     to 168 registers each, as it does 384, and the 160 at bm 64 to
//     255).  Blocks walk
//     the output tiles in groups of 8 tile rows, so the y panels that a
//     wave of blocks reads stay in L2.
//     * bfloat16: x is K-major, the A operand as it lies; y (k, n) is
//       N-major, and the 16-bit wgmma reads it through the transpose bit, so
//       TMA loads both tiles straight from the caller's tensors (y in
//       64-column panels).  m64n{bn}k16, one accumulator chain over all of
//       k, cast once at the end.  The chain is long (k / 16 truncating
//       adds); bfloat16's output rounding (2^-9) is far above what it loses.
//     * float32 as three TF32 products, x_hi y_hi + x_hi y_lo + x_lo y_hi
//       (the scheme of ssd.cu and ssd_bwd.cu).  The .tf32 wgmma has no
//       transpose bit, so y must be K-major: a pre-pass (matmul_split_t)
//       writes y^T as TF32 hi and lo halves into a scratch that the wrapper
//       allocates, hi rounded to the nearest TF32, lo = y - hi; a second
//       (matmul_split) writes x's halves beside them, 2 (m + n) k floats in
//       all, and wgmma m64n{bn}k8 reads both operands from shared memory.
//       (x's halves formed in registers from the raw x tile, as register A
//       fragments, would save the second pass and half the scratch, but
//       ran no faster on the H100 at 4096^3, (128, 128, 32), and spilled
//       at the 168 registers a thread gets.)  Accuracy: hi is within
//       2^-11 of x relatively, lo is read truncated to TF32 (2^-21 of x),
//       and lo lo is dropped (2^-22), so a product is off by at most about
//       2.5 2^-21 |x y|, with random signs; a tensor-core accumulator
//       truncates, so each 32-deep slab runs as a chain from zero -- the
//       small terms of its four k8 steps first, then the four hi hi terms,
//       so only four adds truncate at the chain's full size -- and is added
//       to a float32 sum by FADD (round to nearest).  chip_smoke holds it to
//       2e-5 + 2e-5 |plain| elementwise at k <= 256 and 1e-5 max |plain| at
//       k = 4096; tests/test_torch_matmul_tc.py emulates the arithmetic.
//  2. ffma, every other legal tile: the FP32 FFMA kernel (both dtypes; a
//     bfloat16 operand is converted to float32 as it is read from shared
//     memory), float32 IEEE with each output's k products in k order.  A
//     ring of kStages slabs filled by cp.async (16-byte copies, one commit
//     group a slab; one __syncthreads() a slab both publishes the slab that
//     arrived and frees the stage the next copy overwrites).  256 threads
//     as a 16 x 16 grid; thread (ty, tx) owns TM = 4 GM rows, ty * 4 + i +
//     64 g, and TN = 4 GN columns, tx * 4 + j + 64 h, of the (bm, bn) = (64
//     GM, 64 GN) tile, loading its y values for one k step as GN 16-byte
//     loads and its x values as TM 16-byte loads of four k steps each.  x
//     stays row-major in shared memory (every copy a 16-byte cp.async), its
//     16-byte chunks XOR-swizzled by bit 2 of the row so the two rows a
//     warp reads never share a bank.  (bm, bn) in {64, 128, 256}^2 with GM
//     GN <= 4 (at most 64 accumulators a thread), bk in {8, 16, 32, 64,
//     128}, the ring (kStages * 4 * (bm + bn) * bk bytes, in float32)
//     within the opt-in shared memory; GM, GN and bk are template
//     parameters, so the k loop unrolls whole.
//
// Instantiations: route 1, 6 bfloat16 and 4 float32 kernels (and the
// pre-pass); route 2, 51 (60 tiles in two dtypes less the 9 of route 1).
//
// What bounds it on the H100 (700 W), at 4096^3.  The products: bfloat16 on
// wgmma at 989 TFLOP/s, 137.4 GFLOP in 0.139 ms; float32 as three TF32
// products at 495 TFLOP/s, 0.833 ms (FFMA: 2.05 ms at 67 TFLOP/s).  The
// bytes: the operands once and the output, 0.03 / 0.06 ms at 3.35 TB/s; the
// float32 pre-passes read x and y and write their halves, 2 (m + n) k
// floats: each moves 0.2 GB in about 0.07 ms, before the kernel runs.
// What the design does about it: a producer warp keeps the TMA ring full so
// the consumers only issue products; two consumer warpgroups a block let
// one's slab-end FADDs run under the other's products; bfloat16's 128 x 128
// and 128 x 256 tiles do 64 and 85 flops a byte staged.  What binds it as
// built
// (tools/matmul_times.py, copies of this file without the products or
// without the copies, H100, 700 W): the L2 -> SM stream that the ring's
// copies need (about 9.4 TB/s: 0.17 ms of bfloat16's 0.198 at (128, 256, 64)
// and 0.91 of float32's 1.05 at (128, 128, 32) without products) and the
// products (0.18 and 0.93 without copies), overlapped.  What is left:
// clusters with TMA multicast of the panels that neighbouring blocks share
// (half the L2 stream), a persistent grid (one tile's epilogue under the
// next one's loads), ping-pong consumers, the two float32 pre-passes in one
// launch, and an occupancy term in the tile family's model.
//
// The launcher allocates nothing, never synchronises, launches on the
// stream it is given, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_tools.cuh"
#include "wgmma_tools.cuh"

namespace {

// ------------------------------------------------------- the route table --
// (matmul_route in matmul.py): 1 wgmma, 2 ffma, 0 none.  dtype 0 is
// float32, 1 bfloat16.

__host__ __device__ constexpr bool wgmma_tile(int dtype, int bm, int bn,
                                              int bk) {
  return (bm == 64 || bm == 128) &&
         (dtype == 1 ? (bn == 64 || bn == 128 || bn == 256) && bk == 64
                     : dtype == 0 && (bn == 64 || bn == 128) && bk == 32);
}
__host__ __device__ constexpr bool ffma_tile(int bm, int bn, int bk) {
  return bm > 0 && bn > 0 && bm % 64 == 0 && bn % 64 == 0 &&
         (bm / 64 == 1 || bm / 64 == 2 || bm / 64 == 4) &&
         (bn / 64 == 1 || bn / 64 == 2 || bn / 64 == 4) &&
         (bm / 64) * (bn / 64) <= 4 &&
         (bk == 8 || bk == 16 || bk == 32 || bk == 64 || bk == 128);
}
__host__ __device__ constexpr int route_of(int dtype, int bm, int bn,
                                           int bk) {
  return dtype != 0 && dtype != 1   ? 0
         : wgmma_tile(dtype, bm, bn, bk) ? 1
         : ffma_tile(bm, bn, bk)         ? 2
                                         : 0;
}

template <typename T>
constexpr int dtype_code = std::is_same<T, float>::value ? 0 : 1;

// ------------------------------------------------------- route 2: ffma --

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
int launch_ffma(const void* x, const void* y, void* out, int m, int n,
                int k, cudaStream_t stream) {
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


// ------------------------------------------------------ route 1: wgmma --
// (the mbarrier, TMA, descriptor and TF32 m64n64k8 tools are in
// wgmma_tools.cuh)

// d (+)= a b, m64n64k16 bfloat16: a K-major, b N-major (the transpose bit)
__device__ __forceinline__ void wgmma_bf16_tb(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (+)= a b, m64n128k16 bfloat16: a K-major, b N-major (the transpose bit)
__device__ __forceinline__ void wgmma_bf16_tb(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (+)= a b, m64n256k16 bfloat16: a K-major, b N-major (the transpose bit)
__device__ __forceinline__ void wgmma_bf16_tb(float (&d)[128], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "
      "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, "
      "p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (+)= a b, m64n128k8 TF32: a and b K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

constexpr int kMaxStages = 8;
constexpr int kSmemOptin = 232448;  // the H100's opt-in shared memory
constexpr int kGroupRows = 8;       // tile rows a raster group walks

template <typename T, int BM, int BN>
struct WgCfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int BK = kF32 ? 32 : 64;  // 128-byte rows
  static constexpr int NC = BM / 64;          // consumer warpgroups
  // and one producer warp: ptxas holds 288 threads to 168 registers each
  // and 160 to 255
  static constexpr int kThreads = 128 * NC + 32;
  // a stage: x's tile (float32: its hi and lo halves), then y's: y^T hi and
  // lo (float32, K-major) or bn / 64 panels of 64 k rows (bfloat16, N-major)
  static constexpr unsigned kXBytes = 128u * BM * (kF32 ? 2 : 1);
  static constexpr unsigned kYBytes = 128u * BN * (kF32 ? 2 : 1);
  static constexpr unsigned kStage = kXBytes + kYBytes;
  static constexpr int NS =
      (kSmemOptin - 1024) / (kStage + 16) < kMaxStages
          ? (kSmemOptin - 1024) / (kStage + 16)
          : kMaxStages;
  // the stages, then full[NS] and empty[NS]; 1024 bytes to align them
  static constexpr size_t kSmem = 1024 + NS * static_cast<size_t>(kStage + 16);
};

// The output tile of block `bid`: groups of kGroupRows tile rows, walked
// down a group's rows first, then across its columns.
__device__ __forceinline__ void tile_of(int bid, int tiles_m, int tiles_n,
                                        int& tm, int& tn) {
  const int per_group = kGroupRows * tiles_n;
  const int first = (bid / per_group) * kGroupRows;
  const int rows = tiles_m - first < kGroupRows ? tiles_m - first
                                                : kGroupRows;
  const int in = bid % per_group;
  tm = first + in % rows;
  tn = in / rows;
}

// y (k, n) -> its transpose's TF32 halves: hi rows [0, n), lo rows [n, 2n)
// of a (2n, k) row-major scratch, through 32 x 32 tiles of shared memory
__global__ void __launch_bounds__(256)
matmul_split_t_kernel(const float* __restrict__ y, float* __restrict__ yt,
                      int k, int n) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = ty; i < 32; i += 8)
    tile[i][tx] = y[static_cast<size_t>(k0 + i) * n + n0 + tx];
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    unsigned hi, lo;
    split_tf32(tile[tx][i], hi, lo);
    const size_t at = static_cast<size_t>(n0 + i) * k + k0 + tx;
    yt[at] = __uint_as_float(hi);
    yt[at + static_cast<size_t>(n) * k] = __uint_as_float(lo);
  }
}

// x (m, k) -> its TF32 halves: hi rows [0, m), lo rows [m, 2m) of a (2m,
// k) scratch, four floats a thread
__global__ void __launch_bounds__(256)
matmul_split_kernel(const float4* __restrict__ x, float4* __restrict__ xs,
                    size_t count4) {
  for (size_t i = blockIdx.x * static_cast<size_t>(256) + threadIdx.x;
       i < count4; i += static_cast<size_t>(gridDim.x) * 256) {
    const float4 v = x[i];
    unsigned h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    xs[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
    xs[i + count4] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                 __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(WgCfg<T, BM, BN>::kThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap ty,
                    T* __restrict__ out, int m, int n, int k) {
  using C = WgCfg<T, BM, BN>;
  constexpr int NS = C::NS;
  constexpr int NA = BN / 2;  // accumulators a thread: m64n{BN}
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + NS * C::kStage);
  uint64_t* empty = full + NS;

  int tm, tn;
  tile_of(blockIdx.x, m / BM, n / BN, tm, tn);
  const int row0 = tm * BM, col0 = tn * BN;
  const int nk = k / C::BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * C::NC);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::NC) {
    // the producer warp: one thread issues every copy
    if (threadIdx.x == 128 * C::NC) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % NS;
        mbar_wait(empty + s, ((t / NS) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(full + s, C::kStage);
        unsigned char* st = base + s * C::kStage;
        const int k0 = t * C::BK;
        tma_load(st, &tx, full + s, k0, row0);
        if constexpr (C::kF32) {
          tma_load(st + 128 * BM, &tx, full + s, k0, m + row0);
          tma_load(st + C::kXBytes, &ty, full + s, k0, col0);
          tma_load(st + C::kXBytes + 128 * BN, &ty, full + s, k0, n + col0);
        } else {
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load(st + C::kXBytes + p * 64 * 128, &ty, full + s,
                     col0 + 64 * p, k0);
        }
      }
    }
    return;
  }
  // a consumer warpgroup: rows [64 wg, 64 wg + 64) of the tile
  const int lane = threadIdx.x % 32;
  const int wq = (threadIdx.x % 128) / 32;  // warp in the warpgroup
  const int g = lane >> 2, tq = lane & 3;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;

  if constexpr (!C::kF32) {
    // one chain over all of k; slab t - 1's stage is released once slab
    // t's products are issued and t - 1's are done
    for (int t = 0; t < nk; ++t) {
      const int s = t % NS;
      mbar_wait(full + s, (t / NS) & 1);
      // a k16 step: 32 bytes along x's rows, 16 rows (2048 bytes) down
      // y's panels; the descriptors' start field counts 16-byte units
      const uint64_t dx =
          desc_sw128(base + s * C::kStage + wg * 64 * 128, 16, 1024);
      const uint64_t dy =
          desc_sw128(base + s * C::kStage + C::kXBytes, 64 * 128, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16_tb(acc, dx + 2 * kk, dy + 128 * kk,
                      (t | kk) != 0 ? 1 : 0);
      wgmma_commit();
      if (t > 0) {
        wgmma_wait_group<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (t - 1) % NS);
      }
    }
    wgmma_wait();
    fence_regs(acc);
  } else {
    // each 32-deep slab a chain from zero (the small terms of its k8 steps
    // first, then the hi hi terms), added to acc by FADD
    float chain[NA];
    for (int t = 0; t < nk; ++t) {
      const int s = t % NS;
      mbar_wait(full + s, (t / NS) & 1);
      const unsigned char* st = base + s * C::kStage;
      // a k8 step: 32 bytes along the rows (2 in the start field)
      const uint64_t dyh = desc_sw128(st + C::kXBytes, 16, 1024);
      const uint64_t dyl = desc_sw128(st + C::kXBytes + 128 * BN, 16, 1024);
      const uint64_t dxh = desc_sw128(st + wg * 64 * 128, 16, 1024);
      const uint64_t dxl = desc_sw128(st + wg * 64 * 128 + 128 * BM, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32(chain, dxl + 2 * kk, dyh + 2 * kk, kk > 0 ? 1 : 0);
        wgmma_tf32(chain, dxh + 2 * kk, dyl + 2 * kk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tf32(chain, dxh + 2 * kk, dyh + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(chain);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += chain[i];
    }
  }

  // the accumulator's layout: n8 tile j holds rows g and g + 8 of the
  // warp's 16 at columns 8 j + 2 tq, + 1
  const size_t row = static_cast<size_t>(row0) + 64 * wg + 16 * wq + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(out + (row + 8 * h) * n + col0 + 8 * j + 2 * tq,
             acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// ------------------------------------------------------------ launching --

struct Args {
  const void *x, *y;
  void* out;
  float* scratch;
  int m, n, k, bm, bn, bk;
  cudaStream_t stream;
};

// the floats of split scratch the float32 wgmma route needs at (m, n, k):
// y^T's halves, then x's
long long scratch_floats(int dtype, int m, int n, int k, int bm, int bn,
                         int bk) {
  if (route_of(dtype, bm, bn, bk) != 1 || dtype != 0) return 0;
  return 2ll * (n + m) * k;
}

template <typename T, int BM, int BN>
int launch_wgmma(const Args& a) {
  using C = WgCfg<T, BM, BN>;
  auto kernel = matmul_wgmma_kernel<T, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tx, ty;
  if constexpr (C::kF32) {
    float* yt = a.scratch;
    matmul_split_t_kernel<<<dim3(a.n / 32, a.k / 32), 256, 0, a.stream>>>(
        static_cast<const float*>(a.y), yt, a.k, a.n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    float* xs = a.scratch + 2ll * a.n * a.k;
    matmul_split_kernel<<<1056, 256, 0, a.stream>>>(
        static_cast<const float4*>(a.x), reinterpret_cast<float4*>(xs),
        static_cast<size_t>(a.m) * a.k / 4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!tensor_map_f32(&tx, xs, 2ll * a.m, a.k, BM) ||
        !tensor_map_f32(&ty, yt, 2ll * a.n, a.k, BN))
      return static_cast<int>(cudaErrorNotSupported);
  } else {
    if (!tensor_map(&tx, a.x, a.m, a.k, BM) ||
        !tensor_map(&ty, a.y, a.k, a.n, 64))
      return static_cast<int>(cudaErrorNotSupported);
  }
  const int blocks = (a.m / BM) * (a.n / BN);
  kernel<<<blocks, C::kThreads, C::kSmem, a.stream>>>(
      tx, ty, static_cast<T*>(a.out), a.m, a.n, a.k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wgmma(const Args& a) {
#define REPRO_WG(BM_, BN_)                                                \
  if constexpr (wgmma_tile(dtype_code<T>, BM_, BN_,                       \
                           WgCfg<T, BM_, BN_>::BK))                       \
    if (a.bm == (BM_) && a.bn == (BN_)) return launch_wgmma<T, BM_, BN_>(a);
  REPRO_WG(64, 64) REPRO_WG(64, 128) REPRO_WG(64, 256) REPRO_WG(128, 64)
  REPRO_WG(128, 128) REPRO_WG(128, 256)
#undef REPRO_WG
  return static_cast<int>(cudaErrorInvalidValue);
}

// an ffma instantiation, unless the table gives its tile to wgmma (then it
// is not built)
template <typename T, int GM, int GN, int BK>
int launch_ffma_tile(const Args& a) {
  if constexpr (wgmma_tile(dtype_code<T>, 64 * GM, 64 * GN, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  else
    return launch_ffma<T, GM, GN, BK>(a.x, a.y, a.out, a.m, a.n, a.k,
                                      a.stream);
}

template <typename T, int GM, int GN>
int dispatch_depth(const Args& a) {
  switch (a.bk) {
    case 8: return launch_ffma_tile<T, GM, GN, 8>(a);
    case 16: return launch_ffma_tile<T, GM, GN, 16>(a);
    case 32: return launch_ffma_tile<T, GM, GN, 32>(a);
    case 64: return launch_ffma_tile<T, GM, GN, 64>(a);
    case 128: return launch_ffma_tile<T, GM, GN, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_ffma(const Args& a) {
#define REPRO_TILE(GM_, GN_)                 \
  if (a.bm == 64 * (GM_) && a.bn == 64 * (GN_)) \
    return dispatch_depth<T, GM_, GN_>(a);
  REPRO_TILE(1, 1) REPRO_TILE(1, 2) REPRO_TILE(2, 1) REPRO_TILE(2, 2)
  REPRO_TILE(1, 4) REPRO_TILE(4, 1)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const Args& a) {
  switch (route_of(dtype_code<T>, a.bm, a.bn, a.bk)) {
    case 1: return dispatch_wgmma<T>(a);
    case 2: return dispatch_ffma<T>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The route the table gives (dtype, bm, bn, bk): 1 wgmma, 2 ffma, 0 none
// (the launch refuses it).  dtype: 0 = float32, 1 = bfloat16.
int repro_matmul_route(int dtype, int bm, int bn, int bk) {
  return route_of(dtype, bm, bn, bk);
}

// Dynamic shared memory a block of (dtype, bm, bn, bk) asks for (its
// route's ring), 0 for a tile no route takes.
long long repro_matmul_smem_bytes(int dtype, int bm, int bn, int bk) {
  switch (route_of(dtype, bm, bn, bk)) {
    case 1:
#define REPRO_WG(BM_, BN_)                                                 \
  if (bm == (BM_) && bn == (BN_))                                          \
    return dtype == 0 ? static_cast<long long>(WgCfg<float, BM_, BN_>::kSmem) \
                      : static_cast<long long>(                          \
                            WgCfg<__nv_bfloat16, BM_, BN_>::kSmem);
      REPRO_WG(64, 64) REPRO_WG(64, 128) REPRO_WG(64, 256) REPRO_WG(128, 64)
      REPRO_WG(128, 128) REPRO_WG(128, 256)
#undef REPRO_WG
      return 0;
    case 2:
      return (dtype == 0 ? 4ll : 2ll) * kStages * (bm + bn) * bk;
    default:
      return 0;
  }
}

// The floats of scratch a call needs (the float32 wgmma route's split
// operands; 0 otherwise): matmul.py's split_scratch_floats, which sizes the
// wrapper's allocation, is the same formula.
long long repro_matmul_scratch_floats(int dtype, int m, int n, int k, int bm,
                                      int bn, int bk) {
  return scratch_floats(dtype, m, n, k, bm, bn, bk);
}

// The caller guarantees contiguous row-major operands on the current
// device, 16-byte aligned, tiles that divide the dims, and `scratch` of
// repro_matmul_scratch_floats floats (null when that is 0).
int repro_matmul(const void* x, const void* y, void* out, int m, int n, int k,
                 int bm, int bn, int bk, int dtype, void* scratch,
                 void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      m % bm || n % bn || k % bk || route_of(dtype, bm, bn, bk) == 0 ||
      (scratch == nullptr && scratch_floats(dtype, m, n, k, bm, bn, bk)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, y, out, static_cast<float*>(scratch), m, n, k, bm, bn, bk,
               static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? dispatch<float>(a) : dispatch<__nv_bfloat16>(a);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
