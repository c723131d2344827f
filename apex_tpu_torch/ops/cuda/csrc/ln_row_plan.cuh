// The launch plan of the one-pass wide LayerNorm backward (ln_bwd_row.cu):
// host code that needs no CUDA header, so a host compiler can build it
// alone. The plan is a function of the shape and the element sizes only,
// so the column sums add in one order on every run.

#pragma once

#include <stdint.h>

#include <algorithm>

#ifdef __CUDACC__
#define LNB_HD __host__ __device__
#else
#define LNB_HD
#endif

namespace apex_port {
namespace {

constexpr int kLnbMaxStages = 4;       // the ring's most stages
constexpr int kLnbHead = 512;          // barriers, row sums, statistics
constexpr int kLnbSmemMax = 232448;    // a block's shared memory (227 KB)
constexpr int kLnbRowMax = 16384;      // layer_norm.cu's kRowMax
constexpr int kLnbSms = 132;           // the H100's SMs: the grid's most

LNB_HD inline long long round16(long long b) { return (b + 15) & ~15LL; }

// the column at which a 2-block cluster splits a row of F (rank 0 takes
// the columns before it): half, rounded up to a multiple of 8
LNB_HD inline int row_split(int F) { return ((F + 1) / 2 + 7) & ~7; }

struct RowPlan {
  int cluster;   // blocks that share a row: 1, or 2 that take its halves
  int stages;    // rows in a block's ring
  int clusters;  // in the grid
  int smem;      // bytes of dynamic shared memory a block
};

// A whole row a block where two stages of it fit beside gamma's row in a
// block's shared memory (the head, gamma's segment, then the stages, each
// two buffers of round16(n * x_size) + 16 bytes: dy's and x's segment, 16
// bytes over for its offset in its 16-byte chunk), else its halves in
// 2-block clusters; as many stages as fit, up to kLnbMaxStages; min(rows,
// kLnbSms / cluster) clusters. w_size is 0 without gamma. 16-bit rows
// always fit whole; stages 0 where nothing fits (no F <= kLnbRowMax).
inline RowPlan row_plan(long long rows, int F, int x_size, int w_size) {
  for (int cluster = 1; cluster <= 2; ++cluster) {
    const long long n = cluster == 1 ? F : row_split(F);
    const long long head = kLnbHead + round16(n * w_size);
    const long long span = round16(n * x_size) + 16;
    const long long stages =
        std::min<long long>(kLnbMaxStages, (kLnbSmemMax - head) / (2 * span));
    if (stages >= 2) {
      return {cluster, static_cast<int>(stages),
              static_cast<int>(std::min<long long>(rows, kLnbSms / cluster)),
              static_cast<int>(head + 2 * span * stages)};
    }
  }
  return {0, 0, 0, 0};
}

// values a shared-memory load and a dx store take: the widest of 16 / size,
// ..., 2, 1 that divides F and every buffer's byte address (`bases`, the
// addresses or-ed together), so a group is aligned in every row
inline int row_vec(int F, int size, uintptr_t bases) {
  for (int v = 16 / size; v > 1; v /= 2) {
    if (F % v == 0 && bases % static_cast<uintptr_t>(v * size) == 0) {
      return v;
    }
  }
  return 1;
}

}  // namespace
}  // namespace apex_port
