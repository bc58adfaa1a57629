// Mamba-2 SSD chunked scan for Hopper (sm_90a), FP32 FFMA, hand-written.
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
// Design.  One thread block per (b, h) walks the chunks in order with the
// (P, N) state in shared memory (held transposed, N x P); blocks run in
// parallel over heads and batches, the loop inside the block takes the
// place of the TPU's sequential chunk axis.  The Q x Q matrix G is never
// held whole: at Q = 256, P = 64, N = 128 staging x, b, c, y and G whole
// would take about 650 KB.  The chunk is cut into R-row query tiles and
// R-column key slabs (R = min(chunk, 64)); for each query tile the C rows
// are staged once, the inter-chunk term C h^T is formed from the state,
// and for each key slab B and X are streamed in, the R x R tile of G is
// formed in registers, decayed, staged, and multiplied into the R x P
// output accumulator.  After the chunk's outputs, one more pass over the
// key slabs forms X^T (B * w) and updates the state.  Every product is a
// register-tiled loop over shared memory: 256 threads as a TY x TX grid
// (TX = min(width, 16)), each owning the rows ty + TY i and columns
// tx + TX j of its output tile.  The cumulative sum is one warp's scan
// (sequential runs per lane, a shuffle scan across lanes).  Operands are
// float32 only (the reference kernel is exercised in float32).
//
// Instantiations: P in {8, 16, 32, 64}, N in {8, 16, 32, 64, 128} and
// R in {16, 32, 64} (template parameters: register arrays need
// compile-time sizes); the chunk is a runtime multiple of R.
//
// Parallelism: B * H blocks, so mamba2-2.7b at B = 1 (H = 80) occupies 80
// of the H100's 132 SMs.  Splitting a head's chunks across blocks (Mamba-2's
// chunk-parallel three-pass form) is a later design.
//
// What bounds it on the H100: per chunk 2 Q^2 N + 2 Q^2 P flops for the
// intra-chunk products and 4 Q P N for the state terms against 4 (2 P + 2 N
// + 1) bytes per step, so at Q = 256 it is bound by operations: the FP32
// FFMA rate (67 TFLOP/s outside the tensor cores, 700 W).  The kernel
// computes the full Q x Q products, as the TPU kernel does, though the
// upper triangle is zero; it re-reads each key slab once per query tile
// (from L2: b and c are shared by the heads of a group).
//
// The launcher allocates nothing, never synchronises, launches on the
// stream it is given, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

// register-tile map of an M x C product output over the 256 threads
template <int M, int C>
struct TileMap {
  static constexpr int TX = C < 16 ? C : 16;
  static constexpr int TY = kThreads / TX;
  static constexpr int RM = (M + TY - 1) / TY;  // rows a thread may own
  static constexpr int RN = C / TX;
};

// padded row stride of the staged G tile: ld % 32 == 16
__host__ __device__ constexpr int g_stride(int r) { return r + 16 - r % 32; }

template <int P, int N, int R>
__host__ __device__ constexpr size_t smem_floats(int chunk) {
  return static_cast<size_t>(N) * P          // state, transposed
         + 2 * static_cast<size_t>(N) * (R + 1)  // C tile, B slab (transposed)
         + static_cast<size_t>(R) * P          // X slab
         + static_cast<size_t>(R) * g_stride(R)  // G tile
         + 2 * static_cast<size_t>(chunk);     // s, dt
}

// in-place inclusive prefix sum of v[0 .. n) by the block's first warp
__device__ void warp_inclusive_scan(float* v, int n) {
  const int lane = threadIdx.x;
  const int per = (n + kWarp - 1) / kWarp;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
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
  const float before = incl - run;
  for (int t = lo; t < hi; ++t) v[t] += before;
}

template <int P, int N, int R>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const float* __restrict__ bm,
           const float* __restrict__ cm, float* __restrict__ y, int L, int H,
           int G, int chunk) {
  constexpr int LDT = R + 1;  // stride of the transposed C tile / B slab
  constexpr int LDG = g_stride(R);
  using MapG = TileMap<R, R>;
  using MapY = TileMap<R, P>;
  using MapH = TileMap<P, N>;
  extern __shared__ float smem[];
  float* hT = smem;            // hT[n * P + p] = h[p][n]
  float* cT = hT + N * P;      // cT[n * LDT + i] = C[r0 + i][n]
  float* bT = cT + N * LDT;    // bT[n * LDT + j] = B[j0 + j][n]
  float* xs = bT + N * LDT;    // xs[j * P + p] = X[j0 + j][p]
  float* gs = xs + R * P;      // gs[i * LDG + j] = G[r0 + i][j0 + j]
  float* ss = gs + R * LDG;    // s[0 .. chunk)
  float* dts = ss + chunk;     // dt[0 .. chunk)

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float a = -expf(a_log[h]);

  for (int idx = tid; idx < N * P; idx += kThreads) hT[idx] = 0.0f;

  // stage rows [j0, j0 + R) of the chunk at c0: B transposed, X as it lies
  auto stage_slab = [&](int c0, int j0) {
    for (int idx = tid; idx < R * N; idx += kThreads) {
      const int j = idx / N, n = idx % N;
      bT[n * LDT + j] =
          bm[((static_cast<size_t>(b) * L + c0 + j0 + j) * G + g) * N + n];
    }
    for (int idx = tid; idx < R * P; idx += kThreads) {
      const int j = idx / P, p = idx % P;
      xs[idx] = x[((static_cast<size_t>(b) * L + c0 + j0 + j) * H + h) * P + p];
    }
  };

  for (int c0 = 0; c0 < L; c0 += chunk) {
    __syncthreads();  // the previous chunk's state update and s reads are done
    for (int t = tid; t < chunk; t += kThreads) {
      const float d = dt[(static_cast<size_t>(b) * L + c0 + t) * H + h];
      dts[t] = d;
      ss[t] = a * d;
    }
    __syncthreads();
    if (tid < kWarp) warp_inclusive_scan(ss, chunk);
    __syncthreads();

    for (int r0 = 0; r0 < chunk; r0 += R) {
      for (int idx = tid; idx < R * N; idx += kThreads) {
        const int i = idx / N, n = idx % N;
        cT[n * LDT + i] =
            cm[((static_cast<size_t>(b) * L + c0 + r0 + i) * G + g) * N + n];
      }
      __syncthreads();

      const int yty = tid / MapY::TX, ytx = tid % MapY::TX;
      float inter[MapY::RM][MapY::RN], yacc[MapY::RM][MapY::RN];
#pragma unroll
      for (int i = 0; i < MapY::RM; ++i)
#pragma unroll
        for (int t = 0; t < MapY::RN; ++t) inter[i][t] = yacc[i][t] = 0.0f;
      if (yty < R) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[MapY::RM], hv[MapY::RN];
#pragma unroll
          for (int i = 0; i < MapY::RM; ++i)
            cv[i] = cT[n * LDT + yty + MapY::TY * i];
#pragma unroll
          for (int t = 0; t < MapY::RN; ++t)
            hv[t] = hT[n * P + ytx + MapY::TX * t];
#pragma unroll
          for (int i = 0; i < MapY::RM; ++i)
#pragma unroll
            for (int t = 0; t < MapY::RN; ++t)
              inter[i][t] = fmaf(cv[i], hv[t], inter[i][t]);
        }
      }

      for (int j0 = 0; j0 < chunk; j0 += R) {
        __syncthreads();  // the previous slab's G and X reads are done
        stage_slab(c0, j0);
        __syncthreads();

        const int gty = tid / MapG::TX, gtx = tid % MapG::TX;
        float gacc[MapG::RM][MapG::RN];
#pragma unroll
        for (int i = 0; i < MapG::RM; ++i)
#pragma unroll
          for (int t = 0; t < MapG::RN; ++t) gacc[i][t] = 0.0f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[MapG::RM], bv[MapG::RN];
#pragma unroll
          for (int i = 0; i < MapG::RM; ++i)
            cv[i] = cT[n * LDT + gty + MapG::TY * i];
#pragma unroll
          for (int t = 0; t < MapG::RN; ++t)
            bv[t] = bT[n * LDT + gtx + MapG::TX * t];
#pragma unroll
          for (int i = 0; i < MapG::RM; ++i)
#pragma unroll
            for (int t = 0; t < MapG::RN; ++t)
              gacc[i][t] = fmaf(cv[i], bv[t], gacc[i][t]);
        }
#pragma unroll
        for (int i = 0; i < MapG::RM; ++i) {
          const int ri = gty + MapG::TY * i;
#pragma unroll
          for (int t = 0; t < MapG::RN; ++t) {
            const int cj = gtx + MapG::TX * t;
            const int qi = r0 + ri, kj = j0 + cj;
            gs[ri * LDG + cj] =
                qi >= kj ? gacc[i][t] * expf(ss[qi] - ss[kj]) * dts[kj] : 0.0f;
          }
        }
        __syncthreads();

        if (yty < R) {
#pragma unroll 4
          for (int j = 0; j < R; ++j) {
            float gv[MapY::RM], xv[MapY::RN];
#pragma unroll
            for (int i = 0; i < MapY::RM; ++i)
              gv[i] = gs[(yty + MapY::TY * i) * LDG + j];
#pragma unroll
            for (int t = 0; t < MapY::RN; ++t)
              xv[t] = xs[j * P + ytx + MapY::TX * t];
#pragma unroll
            for (int i = 0; i < MapY::RM; ++i)
#pragma unroll
              for (int t = 0; t < MapY::RN; ++t)
                yacc[i][t] = fmaf(gv[i], xv[t], yacc[i][t]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < MapY::RM; ++i) {
        const int ri = yty + MapY::TY * i;
        if (ri >= R) continue;
        const float es = expf(ss[r0 + ri]);
#pragma unroll
        for (int t = 0; t < MapY::RN; ++t)
          y[((static_cast<size_t>(b) * L + c0 + r0 + ri) * H + h) * P + ytx +
            MapY::TX * t] = yacc[i][t] + es * inter[i][t];
      }
      __syncthreads();  // every read of this query tile's C is done
    }

    // state update: h = exp(s_Q) h + X^T (B * w), w_j = dt_j exp(s_Q - s_j)
    const float s_last = ss[chunk - 1];
    const int hty = tid / MapH::TX, htx = tid % MapH::TX;
    float hacc[MapH::RM][MapH::RN];
#pragma unroll
    for (int i = 0; i < MapH::RM; ++i)
#pragma unroll
      for (int t = 0; t < MapH::RN; ++t) hacc[i][t] = 0.0f;
    for (int j0 = 0; j0 < chunk; j0 += R) {
      __syncthreads();
      stage_slab(c0, j0);
      __syncthreads();
      if (hty < P) {
#pragma unroll 4
        for (int j = 0; j < R; ++j) {
          const float w = dts[j0 + j] * expf(s_last - ss[j0 + j]);
          float xv[MapH::RM], bv[MapH::RN];
#pragma unroll
          for (int i = 0; i < MapH::RM; ++i)
            xv[i] = xs[j * P + hty + MapH::TY * i];
#pragma unroll
          for (int t = 0; t < MapH::RN; ++t)
            bv[t] = bT[(htx + MapH::TX * t) * LDT + j] * w;
#pragma unroll
          for (int i = 0; i < MapH::RM; ++i)
#pragma unroll
            for (int t = 0; t < MapH::RN; ++t)
              hacc[i][t] = fmaf(xv[i], bv[t], hacc[i][t]);
        }
      }
    }
    // each state element is owned by one thread, and every read of the
    // old state (the inter-chunk terms above) ended at the last barrier
    const float decay_last = expf(s_last);
#pragma unroll
    for (int i = 0; i < MapH::RM; ++i) {
      const int p = hty + MapH::TY * i;
      if (p >= P) continue;
#pragma unroll
      for (int t = 0; t < MapH::RN; ++t) {
        const int n = htx + MapH::TX * t;
        hT[n * P + p] = decay_last * hT[n * P + p] + hacc[i][t];
      }
    }
  }
}

template <int P, int N, int R>
int launch(const float* x, const float* dt, const float* a_log,
           const float* b, const float* c, float* y, int B, int L, int H,
           int G, int chunk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<P, N, R>(chunk);
  auto kernel = ssd_kernel<P, N, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, dt, a_log, b, c, y, L, H, G,
                                           chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int dispatch_rows(const float* x, const float* dt, const float* a_log,
                  const float* b, const float* c, float* y, int B, int L,
                  int H, int G, int chunk, cudaStream_t s) {
  const int rows = chunk < 64 ? chunk : 64;
  if (chunk % rows) return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 16:
      return launch<P, N, 16>(x, dt, a_log, b, c, y, B, L, H, G, chunk, s);
    case 32:
      return launch<P, N, 32>(x, dt, a_log, b, c, y, B, L, H, G, chunk, s);
    case 64:
      return launch<P, N, 64>(x, dt, a_log, b, c, y, B, L, H, G, chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int P>
int dispatch_state(const float* x, const float* dt, const float* a_log,
                   const float* b, const float* c, float* y, int B, int L,
                   int H, int G, int n, int chunk, cudaStream_t s) {
  switch (n) {
    case 8:
      return dispatch_rows<P, 8>(x, dt, a_log, b, c, y, B, L, H, G, chunk, s);
    case 16:
      return dispatch_rows<P, 16>(x, dt, a_log, b, c, y, B, L, H, G, chunk, s);
    case 32:
      return dispatch_rows<P, 32>(x, dt, a_log, b, c, y, B, L, H, G, chunk, s);
    case 64:
      return dispatch_rows<P, 64>(x, dt, a_log, b, c, y, B, L, H, G, chunk, s);
    case 128:
      return dispatch_rows<P, 128>(x, dt, a_log, b, c, y, B, L, H, G, chunk,
                                   s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// float32 only.  The caller guarantees contiguous operands on the current
// device, H % G == 0 and a chunk that divides L.
int repro_ssd(const void* x, const void* dt, const void* a_log,
              const void* b, const void* c, void* y, int B, int L, int H,
              int G, int p, int n, int chunk, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G || chunk <= 0 ||
      L % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a_log);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 8:
      return dispatch_state<8>(xf, dtf, af, bf, cf, yf, B, L, H, G, n, chunk,
                               s);
    case 16:
      return dispatch_state<16>(xf, dtf, af, bf, cf, yf, B, L, H, G, n, chunk,
                                s);
    case 32:
      return dispatch_state<32>(xf, dtf, af, bf, cf, yf, B, L, H, G, n, chunk,
                                s);
    case 64:
      return dispatch_state<64>(xf, dtf, af, bf, cf, yf, B, L, H, G, n, chunk,
                                s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
