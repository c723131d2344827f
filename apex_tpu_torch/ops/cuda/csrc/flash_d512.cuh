// What the bf16/fp16 flash kernels at head dims 384 and 512 share
// (csrc/flash_d512.cu: the forward and dq; csrc/flash_d512_dkv.cu: dk and
// dv): a block's 64 rows worked on by both consumer warpgroups, D split
// between them; the products over a run of column tiles; the trade of a
// warpgroup's fp32 tile through shared memory under one named barrier.
#pragma once

#include "flash_tiles.cuh"

namespace apex_port {
namespace {

constexpr int kXRows = 64;      // rows a block owns, both consumer
                                // warpgroups on all of them (queries;
                                // keys in dk and dv)
constexpr int kXBar = 5;        // the named barrier of the trade

// the rows of every map's box at D 384 and 512: dq's key tiles and dk's
// query tiles (the other kernels' tiles are whole boxes of it)
template <int D>
constexpr int kXBox = D == 384 ? 32 : 16;

// acc[64 x N] = a's 64 rows times b's N rows transposed over KS k-steps of
// 16 columns from column tile c0 (both K-major, in shared memory)
template <typename E, int N, int KS, int RA, int RB, int D>
__device__ __forceinline__ void cols_product(float (&acc)[N / 2],
                                             const Tile<RA, D>& a,
                                             const Tile<RB, D>& b, int c0) {
  const uint32_t pa = opaque(smem_u32(&a.x[c0][0]));
  const uint32_t pb = smem_u32(&b.x[c0][0]);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    mma_ss<N, E>(acc,
                 sw128_desc(pa + (kk / 4) * Tile<RA, D>::kColBytes +
                                (kk % 4) * 32, 16, kSbo),
                 sw128_desc(pb + (kk / 4) * Tile<RB, D>::kColBytes +
                                (kk % 4) * 32, 16, kSbo),
                 kk > 0);
  }
}

// acc[64 x N] += X[64 x 16 KS] times b's columns [64 c0, 64 c0 + N), b
// MN-major, X from its 16-bit register fragments (as frags_by_tile)
template <typename E, int N, int KS, int RB, int D>
__device__ __forceinline__ void cols_by_tile(float (&acc)[N / 2],
                                             const uint32_t (&f)[KS][4],
                                             const Tile<RB, D>& b, int c0) {
  const uint32_t pb = smem_u32(&b.x[c0][0]);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    mma_rs<N, 1, E>(acc, f[ks],
                    sw128_desc(pb + ks * 16 * 128, Tile<RB, D>::kColBytes,
                               kSbo), 1);
  }
}

// this warpgroup's tile of 64 x BN fp32 (in the accumulator layout) into
// its half of the trade at parity par
template <int BN>
__device__ __forceinline__ void put(float (&x)[2][2][BN / 2][128], int par,
                                    int wg, int tid, const float (&v)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) x[par][wg][i][tid] = v[i];
}

}  // namespace
}  // namespace apex_port
