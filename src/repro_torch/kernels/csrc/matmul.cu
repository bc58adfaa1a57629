// Tiled matmul for Hopper (sm_90a), FP32 FFMA, hand-written.
//
// Replaces: src/repro/kernels/matmul.py::_matmul_kernel, the Pallas TPU
// kernel that computes X @ Y over a (m/bm, n/bn, k/bk) grid with an f32
// accumulator zeroed at k-step 0, one dot(x_tile, y_tile) added per k-step
// and a cast to the input dtype at the last step.
//
// What it computes: out = x @ y for row-major x (m, k) and y (k, n), both
// float32 or both bfloat16, accumulated in float32 and cast to the input
// dtype.  float32 stays IEEE FFMA (no TF32), so the result agrees with a
// float32 reference to 2e-5.
//
// Design.  On the TPU the grid runs in order on one core and the k axis is
// a sequential grid dimension carrying the accumulator in VMEM scratch.  On
// Hopper the blocks run in parallel and in no order, so the k axis becomes
// a loop inside the block: one thread block per (bm, bn) output tile walks
// k in bk-deep slabs, staging each slab of x and y through shared memory
// (converted to float32 on the way in), and keeps the accumulator in
// registers.  256 threads form a 16 x 16 grid; thread (ty, tx) owns the
// TM x TN outputs at rows ty + 16 i and columns tx + 16 j of the tile
// (bm = 16 TM, bn = 16 TN).  Each slab step a thread reads TM values of x
// and TN values of y from shared memory and issues TM * TN FFMAs, so the
// 8 x 8 register tile (bm = bn = 128) does 4 FFMAs per shared-memory load.
// The x slab is stored k-major with a one-float pad per column (stride
// bm + 1) so its transposing store is free of bank conflicts; the y slab is
// stored as it lies.  TM and TN are template parameters (register arrays
// need compile-time sizes); bk is a runtime argument, so one instantiation
// serves every slab depth.
//
// Candidate tiles (what the tile tuner may pick, from this design):
// bm, bn in {32, 64, 128, 256} with TM * TN <= 64 (at most 64 float32
// accumulators a thread, which keeps 256 threads within the register file
// without spilling), and bk in {8, 16, 32, 64}.  A launch is legal when its
// tiles divide the problem and its staging, 4 * ((bm + 1) * bk + bk * bn)
// bytes, fits the card's opt-in shared memory per block (232,448 bytes on
// the H100).
//
// What bounds it on the H100: for float32 at large tiles the FP32 FFMA
// rate (67 TFLOP/s outside the tensor cores, 700 W); for small tiles the
// memory traffic, since every block re-reads its (bm x k) and (k x bn)
// operand panels and small tiles re-stream them many times.  The design
// answers the first with register tiling (4 FFMAs per shared load at
// 8 x 8) and the second by letting the tuner pick large bm, bn.  bfloat16
// inputs take the same FFMA path after conversion; the tensor cores
// (wgmma), TMA and a multi-stage pipeline are left for a later kernel.
//
// The launcher allocates nothing, never synchronises, launches on the
// stream it is given, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;  // threads per tile row / column

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch's cast
}

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
              T* __restrict__ out, int m, int n, int k, int bk) {
  constexpr int BM = kSide * TM;
  constexpr int BN = kSide * TN;
  constexpr int LDX = BM + 1;  // padded column stride of the x slab
  extern __shared__ float smem[];
  float* xs = smem;             // [bk][LDX]: xs[c * LDX + r] = x[row0 + r][k0 + c]
  float* ys = smem + bk * LDX;  // [bk][BN]:  ys[r * BN + c] = y[k0 + r][col0 + c]

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * BM;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += bk) {
    // stage the slab; consecutive threads read consecutive addresses
    for (int idx = tid; idx < BM * bk; idx += kThreads) {
      const int r = idx / bk, c = idx % bk;
      xs[c * LDX + r] = to_float(x[(row0 + r) * k + k0 + c]);
    }
    for (int idx = tid; idx < bk * BN; idx += kThreads) {
      const int r = idx / BN, c = idx % BN;
      ys[r * BN + c] = to_float(y[static_cast<size_t>(k0 + r) * n + col0 + c]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < bk; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk * LDX + ty + kSide * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[kk * BN + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the slab is overwritten by the next iteration
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      out[(row0 + ty + kSide * i) * n + col0 + tx + kSide * j] =
          from_float<T>(acc[i][j]);
}

template <typename T, int TM, int TN>
int launch(const void* x, const void* y, void* out, int m, int n, int k,
           int bk, cudaStream_t stream) {
  constexpr int BM = kSide * TM;
  constexpr int BN = kSide * TN;
  const size_t smem = sizeof(float) * ((BM + 1) * static_cast<size_t>(bk) +
                                       static_cast<size_t>(bk) * BN);
  auto kernel = matmul_kernel<T, TM, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / BN, m / BM);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(y),
                                           static_cast<T*>(out), m, n, k, bk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* y, void* out, int m, int n, int k,
             int bm, int bn, int bk, cudaStream_t stream) {
#define REPRO_TILE(TM_, TN_)                                         \
  if (bm == kSide * (TM_) && bn == kSide * (TN_))                    \
    return launch<T, TM_, TN_>(x, y, out, m, n, k, bk, stream);
  REPRO_TILE(2, 2) REPRO_TILE(2, 4) REPRO_TILE(2, 8) REPRO_TILE(2, 16)
  REPRO_TILE(4, 2) REPRO_TILE(4, 4) REPRO_TILE(4, 8) REPRO_TILE(4, 16)
  REPRO_TILE(8, 2) REPRO_TILE(8, 4) REPRO_TILE(8, 8)
  REPRO_TILE(16, 2) REPRO_TILE(16, 4)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The caller guarantees contiguous
// row-major operands on the current device and tiles that divide the dims.
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
