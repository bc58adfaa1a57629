// Tools shared by the SSD forward (ssd.cu) and backward (ssd_bwd.cu): their
// route table (the same for both: ssd_route and ssd_bwd_route in
// kernels/ssd.py) and what their wgmma routes' split tiles are made of.

#pragma once

#include <cstdint>

#include "mma_tools.cuh"
#include "wgmma_tools.cuh"

namespace {

// The route table: route 1 (wgmma) at P = 64, N in {128, 16} and a chunk
// that is a multiple of 64 -- the widths of mamba2-2.7b and
// jamba-v0.1-52b, every forward of more than 32 steps and every backward
// the models run; route 2 (mma.sync) for every other instantiated (P, N)
// and for chunks 16 and 32; 0 for none.
__host__ __device__ constexpr bool is_head_dim(int p) {
  return p == 8 || p == 16 || p == 32 || p == 64;
}
__host__ __device__ constexpr bool is_state(int n) {
  return n == 8 || n == 16 || n == 32 || n == 64 || n == 128;
}
__host__ __device__ constexpr bool wgmma_pn(int p, int n) {
  return p == 64 && (n == 128 || n == 16);
}
__host__ __device__ constexpr int route_of(int p, int n, int chunk) {
  return !is_head_dim(p) || !is_state(n) || chunk < 16 || chunk % 16 ||
                 (chunk > 32 && chunk % 64)
             ? 0
         : wgmma_pn(p, n) && chunk % 64 == 0 ? 1
                                             : 2;
}

// Split tiles.  A float32 operand of a route-1 product is read from
// K-major units of its TF32 hi and lo parts (split_tf32): up to 64 rows by
// 32 depth steps, one 128-byte row a unit row with the 16-byte chunk c of
// row r at chunk c ^ (r & 7) -- the 128-byte swizzle a wgmma descriptor
// names -- the unit's hi panel, then its lo panel.
constexpr int kWgRows = 64;                // tile rows, steps of a slab
constexpr int kUnitBytes = kWgRows * 256;  // a 64-row unit, hi and lo

// the step that depth slot q of a time-depth tile holds: step 2q of each
// 8-step group at slot q and 2q + 1 at slot q + 4, the order in which an
// m64nN accumulator is the register A fragment of the next product
// (a_from_acc)
__host__ __device__ constexpr int kperm(int q) {
  return (q & ~7) | ((q & 7) < 4 ? 2 * (q & 7) : 2 * (q & 7) - 7);
}
// the float offset of (row r, depth k) in a panel
__host__ __device__ constexpr int panel_at(int r, int k) {
  return r * 32 + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
}

// the first 1024-byte boundary of dynamic shared memory (a swizzle atom)
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}
// the descriptor of a K-major unit at p
__device__ __forceinline__ uint64_t sdesc(const unsigned char* p) {
  return desc_sw128(p, 16, 1024);
}
template <int M>
__device__ __forceinline__ void zero_regs(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) r[i] = 0.0f;
  fence_regs(r);
}

}  // namespace
