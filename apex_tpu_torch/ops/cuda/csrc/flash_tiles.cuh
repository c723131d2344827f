// What the Hopper flash kernels (csrc/flash_fwd.cu: the forward;
// csrc/flash_bwd.cu: dq and dk/dv; csrc/flash_d512.cu: the forward and
// dq at D 384 and 512) share, built on the PTX of
// csrc/hopper.cuh: the block's shape (two consumer warpgroups of 64 rows and
// a producer warpgroup whose one warp issues the copies), operand tiles as
// TMA writes them, the copy ring's barriers, the products on those tiles,
// the turns the consumer warpgroups take, the online softmax of a tile and
// the backward's recompute, and the host's tensor maps.
#pragma once

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace apex_port {
namespace {

using namespace hopper;

constexpr int kRows = 128;        // rows a block owns (queries; keys)
constexpr int kWgRows = 64;       // rows of one consumer warpgroup
constexpr int kBox = 64;          // a TMA box: 64 rows (32 in dq at D =
                                  // 256) of 64 16-bit (the 128-byte
                                  // swizzle's span), one bh
constexpr int kBlockThreads = 384;  // consumer warpgroups 0 and 1, producer 2
// registers a thread after setmaxnreg (256 * 240 + 128 * 24 of the SM's
// 65536); one warp of the producer warpgroup issues the copies
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr int kFullArrivals = 32;   // the producer warp's lanes
constexpr int kEmptyArrivals = 8;   // the consumer warps
constexpr uint32_t kSbo = 1024;     // 8 swizzled rows of 128 bytes
// the named barriers that take turns between the consumer warpgroups (0
// is __syncthreads)
constexpr int kTurnBar = 1;

// the tensor maps of q, k, v and dO (the forward leaves o unset)
struct Maps {
  CUtensorMap q, k, v, o;
};

// R rows of a [*, D] 16-bit operand (bf16 or fp16: the bytes as TMA
// copied them) in shared memory as D / 64 column tiles of R swizzled
// 128-byte rows (hopper.cuh)
template <int R, int D>
struct alignas(1024) Tile {
  static constexpr uint32_t kColBytes = R * kBox * 2;   // one column tile
  static constexpr uint32_t kBytes = kColBytes * (D / kBox);
  uint16_t x[D / kBox][R * kBox];
};

// the dynamic shared memory a block asks for: its layout, room to align
// the base, and at least 116 KB, so that one block holds an SM (the
// consumers' setmaxnreg takes the registers a second block would need)
template <typename S>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(S)) + 1024 > 116 * 1024
             ? static_cast<int>(sizeof(S)) + 1024 : 116 * 1024;
}

template <typename S>
__device__ __forceinline__ S& smem_as(uint8_t* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<S*>(raw + pad);
}

// the ring's full and empty barriers (one pair a stage of S::full) and a
// barrier of one arrival for the block's own rows
template <typename S>
__device__ __forceinline__ void init_barriers(S& sm, uint64_t* once) {
  constexpr int kN = static_cast<int>(std::extent<decltype(S::full)>::value);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      mbar_init(&sm.full[s], kFullArrivals);
      mbar_init(&sm.empty[s], kEmptyArrivals);
    }
    mbar_init(once, 1);
    fence_barrier_init();
  }
  __syncthreads();
}

// rows [row0, row0 + R) of bh into t, by one thread, from a map whose box
// is BR rows: R / BR boxes down, D / 64 across; completes R * D * 2 bytes
// on bar
template <int BR = kBox, int R, int D>
__device__ __forceinline__ void load_rows(Tile<R, D>& t,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row0, int bh) {
  static_assert(R % BR == 0, "a tile is whole boxes");
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
#pragma unroll
    for (int h = 0; h < R / BR; ++h) {
      tma_load_3d(&t.x[c][h * BR * kBox], map, bar, c * kBox, row0 + h * BR,
                  bh);
    }
  }
}

// a consumer warp's release of stage s (s < 0: none), once its lanes are
// done with the stage's shared memory
template <typename S>
__device__ __forceinline__ void release(S& sm, int s) {
  if (s < 0) return;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&sm.empty[s]);
}

// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The consumer warpgroups take turns issuing their first products: wg
// waits for the other's turn to end, issues, and ends its own. The tensor
// cores then run one warpgroup's products while the other works out its
// softmax (or P and dS), instead of both at once. Warpgroup 1 lets 0 go
// first; each turn of one is matched by a wait of the other, and
// warpgroup 0 takes the last turn after both loops, so no barrier is left
// half-arrived.
__device__ __forceinline__ void turn_begin(int wg) {
  bar_sync(kTurnBar + wg, 256);
}
__device__ __forceinline__ void turn_end(int wg) {
  bar_arrive(kTurnBar + (wg ^ 1), 256);
}

// k-steps of the first products' A operand held in registers: all of
// them at D = 64, none at D = 128 (see first_product)
template <int D>
constexpr int kASteps = D == 64 ? D / 16 : 1;

// this warp's register-A fragments of rows [r0, r0 + 64) of t, every
// k-step of 16 columns: chunk c of row r sits at chunk c ^ (r % 8) (the
// TMA swizzle), and this lane's rows are both g mod 8
template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&f)[D / 16][4],
                                           const Tile<kRows, D>& t, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int row = r0 + ((threadIdx.x >> 5) & 3) * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const char* p = reinterpret_cast<const char*>(&t.x[kk / 4][0]) +
                    row * 128 + 4 * t4;
    const int c = 2 * (kk % 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int chunk = (c + (j >> 1)) ^ g;
      f[kk][j] = *reinterpret_cast<const uint32_t*>(p + (j & 1) * 8 * 128 +
                                                    (chunk << 4));
    }
  }
}

// acc[64 x N] = this warpgroup's rows [r0, r0 + 64) of the block's tile a
// (of RA rows) times rows [b0, b0 + N) of b transposed: the product over
// D, both K-major. At D = 64 the rows come from their register fragments
// f (an m64n64k16 product that reads both operands from shared memory
// takes all of its bandwidth); at D = 128 and 256 from a itself, their
// fragments (64 and 128 registers a thread) having no room beside the
// accumulators
template <typename E, int D, int N, int RB, int RA>
__device__ __forceinline__ void first_product(
    float (&acc)[N / 2], const Tile<RA, D>& a, int r0,
    const uint32_t (&f)[kASteps<D>][4], const Tile<RB, D>& b, int b0) {
  const uint32_t pa = opaque(smem_u32(&a.x[0][r0 * kBox]));
  const uint32_t pb = smem_u32(&b.x[0][b0 * kBox]);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = sw128_desc(
        pb + (kk / 4) * Tile<RB, D>::kColBytes + (kk % 4) * 32, 16, kSbo);
    if constexpr (D == 64) {
      mma_rs<N, 0, E>(acc, f[kk], db, kk > 0);
    } else {
      mma_ss<N, E>(acc,
                sw128_desc(pa + (kk / 4) * Tile<RA, D>::kColBytes +
                               (kk % 4) * 32, 16, kSbo),
                db, kk > 0);
    }
  }
}

// acc[64 x D] += X[64 x 16 KS] times rows [b0, b0 + 16 KS) of b, b
// MN-major, X from its 16-bit register fragments: f[ks][j] packs X's
// accumulator elements 8 ks + 2 j and 8 ks + 2 j + 1, k-step ks taking X's
// columns [16 ks, 16 ks + 16) and the 16 rows of b that match them
template <typename E, int D, int KS, int RB>
__device__ __forceinline__ void frags_by_tile(float (&acc)[D / 2],
                                              const uint32_t (&f)[KS][4],
                                              const Tile<RB, D>& b,
                                              int b0) {
  const uint32_t pb = smem_u32(&b.x[0][b0 * kBox]);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    mma_rs<D, 1, E>(acc, f[ks],
                 sw128_desc(pb + ks * 16 * 128, Tile<RB, D>::kColBytes,
                            kSbo), 1);
  }
}

// key tiles of BN keys the queries [r0, r0 + n) must visit: the causal
// mask ends them at the last key their last row sees; rows past Sq see
// nothing
template <int BN = kBox>
__device__ __forceinline__ int key_tiles(const Attn& a, int r0, int n) {
  const int last = min(r0 + n, a.sq) - 1;
  if (last < r0) return 0;
  int t = (a.sk + BN - 1) / BN;
  if (a.causal) {
    const int lim = a.q_start + last - a.k_start;
    if (lim < 0) return 0;
    t = min(t, lim / BN + 1);
  }
  return t;
}

// ---- the softmax and the backward's recompute (the forward's kernels:
// csrc/flash_fwd.cu, csrc/flash_d512.cu; dq and dk/dv: csrc/flash_bwd.cu,
// csrc/flash_d512.cu) --------------------------------------------------

// the kernel's kind: no bias or dropout; a kv_bias and/or dropout; a full
// bias (and maybe the others)
enum Kind : int { kPlainKind = 0, kExtraKind = 1, kBiasKind = 2 };

// the full bias of the block's rows [q0, q0 + ROWS) at keys [k0, k0 +
// BN) into L2, by the producer warp as it loads the tile (a row's BN
// floats touch at most three 128-byte lines)
template <int BN, int ROWS = kRows>
__device__ __forceinline__ void prefetch_bias(const Attn& a, int bh, int q0,
                                              int k0, int lane) {
  const int k1 = min(k0 + BN, a.sk) - 1;
  if (k1 < k0) return;
  for (int r = lane; r < ROWS && q0 + r < a.sq; r += 32) {
    const float* p = a.bias + bh * a.bias_bh + (long long)(q0 + r) * a.sk;
    prefetch_l2(p + k0);
    prefetch_l2(p + min(k0 + 32, k1));
    prefetch_l2(p + k1);
  }
}

// calls f(MASK, BIAS, DROP) as compile-time constants for a tile of a
// kernel of kind KIND: `masked` from the tile's position, DROP from the
// inputs (warp-uniform), BIAS from the kind. At D >= 128 dropout is checked at
// run time in one loop (registers).
template <int D, int KIND, typename F>
__device__ __forceinline__ void fwd_tile_form(bool masked, const Attn& a,
                                              F&& f) {
  using T = std::true_type;
  using N = std::false_type;
  using B = std::integral_constant<bool, KIND == kBiasKind>;
  if constexpr (KIND == kPlainKind) {
    if (masked) f(T{}, N{}, N{});
    else f(N{}, N{}, N{});
  } else if (D >= 128 || a.drop_inv > 0.f) {
    if (masked) f(T{}, B{}, T{});
    else f(N{}, B{}, T{});
  } else {
    if (masked) f(T{}, B{}, N{});
    else f(N{}, B{}, N{});
  }
}

// The online softmax (_fwd_kernel, :196-231) of one staged tile of BN keys
// from k0 for this thread's rows g and g + 8 of its warp's 16 from qw, in
// a tile whose form is known (MASK, BIAS, DROP as fwd_tile_form gives
// them; EXTRA, any bias or dropout: the value guard). sc holds q·k in the
// accumulator layout of hopper.cuh, kvb the tile's kv_bias and bv its full
// bias (load_bias) in log2 units, or, with NB = 1, no registers: the bias
// read a score at a time (bias_at); m holds the rows' running max in log2
// units and l this thread's share of their sums. Sets alpha, the factors
// by which the output's rows shrink, and packs P into its 16-bit E
// fragments (and, given plo, what their rounding left into plo's):
// l takes the undropped p, the fragments the kept p times 1 / (1 - rate).
template <typename E, int BN, bool EXTRA, bool MASK, bool BIAS, bool DROP,
          int NB>
__device__ __forceinline__ void softmax_tile(
    const Attn& a, int bh, int qw, int k0, float (&sc)[BN / 2],
    const float* kvb, const float (&bv)[NB], float (&m)[2], float (&l)[2],
    float (&alpha)[2], uint32_t (&pf)[BN / 16][4],
    uint32_t (*plo)[4] = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float sl2 = a.scale * kLog2e;
  // no mask, bias or dropout, and a positive scale: the raw scores'
  // max scaled once, p = exp2(s · sl2 − m) by one fused multiply-add
  constexpr bool kPlain = !EXTRA && !MASK;
  if constexpr (!kPlain) {
    // scores in log2 units with the biases; kNegInf where masked
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int qi = qw + g + 8 * ((i >> 1) & 1);
      const int kl = (i >> 2) * 8 + 2 * t4 + (i & 1);
      const bool vis = !MASK || visible(a, qi, k0 + kl);
      float v = EXTRA ? fmaf(sc[i], sl2, kvb[kl]) : sc[i] * sl2;
      if constexpr (BIAS && NB > 1) {
        v += vis ? bv[i] : 0.f;
      } else if constexpr (BIAS) {
        v += vis ? bias_at(a, bh, qi, k0 + kl) : 0.f;
      }
      sc[i] = vis ? v : kNegInf;
    }
  }
  // each row's max and sum as four and two partial chains, not one
  float mq[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mq[0][c] = sc[(c & 1) + 8 * (c >> 1)];
    mq[1][c] = sc[2 + (c & 1) + 8 * (c >> 1)];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int c = (i & 1) + 2 * ((i >> 2) & 1);
    mq[(i >> 1) & 1][c] = fmaxf(mq[(i >> 1) & 1][c], sc[i]);
  }
  float mx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(fmaxf(mq[h][0], mq[h][1]), fmaxf(mq[h][2], mq[h][3]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], kPlain ? mx[h] * sl2 : mx[h]);
    alpha[h] = ex2(m[h] - mn);    // 1 while the row has seen nothing
    m[h] = mn;
    l[h] *= alpha[h];
  }
  float lq[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j & 1;          // element 8 ks + 2 j (+ 1)'s row
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * ks + 2 * j + e;
        if constexpr (kPlain) {
          p[e] = ex2(fmaf(sc[i], sl2, -m[h]));
        } else {
          // a row with nothing unmasked yet keeps p = 0
          p[e] = sc[i] > kNegInf * 0.5f ? ex2(sc[i] - m[h]) : 0.f;
        }
        lq[h][e] += p[e];
        if (DROP && a.drop_inv > 0.f) {
          const int kj = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
          p[e] = keep(a, bh, qw + g + 8 * h, kj) ? p[e] * a.drop_inv : 0.f;
        }
      }
      pf[ks][j] = pack2<E>(p[0], p[1]);
      if (plo != nullptr) plo[ks][j] = pack2_rest<E>(p[0], p[1], pf[ks][j]);
    }
  }
  l[0] += lq[0][0] + lq[0][1];
  l[1] += lq[1][0] + lq[1][1];
}

// The recompute of one (query qi, key kj) as _recompute_p_ds (:309-346)
// does it, for a tile whose form is known: MASK, whether the tile crosses
// the causal diagonal or a ragged edge (else every element is visible);
// BIAS and DROP, whether a full bias and dropout may be given (each then
// checked at run time); EXTRA, any of those or a kv_bias (the value
// guard). s is q·k, kvb2 the key's kv_bias in log2 units, lse2 the row's
// lse in log2 units. Returns p dropped and rescaled (dv's factor) and sets
// ds = p (dP' - delta) with the undropped p.
template <bool EXTRA, bool MASK, bool BIAS, bool DROP>
__device__ __forceinline__ float recompute(const Attn& a, int bh, int qi,
                                          int kj, float s, float sl2,
                                          float kvb2, float dp, float lse2,
                                          float dlt, float& ds) {
  float sc = fmaf(s, sl2, kvb2);
  bool live = !MASK || visible(a, qi, kj);
  if (BIAS && live) sc += bias_at(a, bh, qi, kj);
  if (EXTRA) live = live && sc > kNegInf * 0.5f;
  const float p = live ? ex2(sc - lse2) : 0.f;
  float pd = p;
  if (DROP && a.drop_inv > 0.f) {
    const bool kept = keep(a, bh, qi, kj);
    pd = kept ? p * a.drop_inv : 0.f;
    dp = kept ? dp * a.drop_inv : 0.f;
  }
  ds = p * (dp - dlt);
  return pd;
}

// calls f(MASK, BIAS, DROP) as compile-time constants for a tile:
// `masked` from the tile's position, BIAS and DROP from the inputs of an
// EXTRA form (all warp-uniform), so each loop carries only what it needs.
// The EXTRA forms at D >= 128 take one loop for both inputs (BIAS and
// DROP checked at run time): eight loops beside dk and dv's 128 fp32
// registers a thread spill. dq at D = 256, beside its own 128, does the
// same.
template <int D, bool EXTRA, typename F>
__device__ __forceinline__ void with_tile_form(bool masked, const Attn& a,
                                               F&& f) {
  using T = std::true_type;
  using N = std::false_type;
  if (!EXTRA) {
    if (masked) f(T{}, N{}, N{});
    else f(N{}, N{}, N{});
    return;
  }
  if (D >= 128) {
    if (masked) f(T{}, T{}, T{});
    else f(N{}, T{}, T{});
    return;
  }
  const bool bias = a.bias != nullptr, drop = a.drop_inv > 0.f;
  if (masked) {
    if (bias) {
      if (drop) f(T{}, T{}, T{});
      else f(T{}, T{}, N{});
    } else {
      if (drop) f(T{}, N{}, T{});
      else f(T{}, N{}, N{});
    }
  } else {
    if (bias) {
      if (drop) f(N{}, T{}, T{});
      else f(N{}, T{}, N{});
    } else {
      if (drop) f(N{}, N{}, T{});
      else f(N{}, N{}, N{});
    }
  }
}

// ---- host: tensor maps -----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime (null if the
// driver has none)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// one tensor's layout from the wrapper: dims (D, S, BH) innermost first,
// the row and bh strides in bytes, the box (64, box_rows, 1)
constexpr int kLayoutLen = 8;

bool encode(CUtensorMap* map, const void* base, const long long* lay,
            int d, int s, int bh, CUtensorMapDataType type, int box_rows) {
  if (lay[0] != d || lay[1] != s || lay[2] != bh || lay[5] != kBox ||
      lay[6] != box_rows || lay[7] != 1) {
    return false;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(lay[0]),
                              static_cast<cuuint64_t>(lay[1]),
                              static_cast<cuuint64_t>(lay[2])};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(lay[3]),
                                 static_cast<cuuint64_t>(lay[4])};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(lay[5]),
                             static_cast<cuuint32_t>(lay[6]),
                             static_cast<cuuint32_t>(lay[7])};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the maps of q, k and v (and, with dout, dO) of 16-bit elements (fp16
// with f16, else bf16), each in boxes of box_rows rows, and the Attn the
// kernels take; the strides of q, k and v come from their maps
bool prepare(Maps* maps, Attn* a, bool f16, const void* q, const void* k,
             const void* v, const void* dout, const long long* tma,
             const void* kvb, long long kvb_bh, const void* bias,
             long long bias_bh, unsigned seed, unsigned drop_thresh,
             float drop_inv, int bh, int sq, int sk, int d, int q_start,
             int k_start, int causal, float scale, int box_rows = kBox) {
  const long long* lq = tma;
  const long long* lk = tma + kLayoutLen;
  const long long* lv = tma + 2 * kLayoutLen;
  const long long* lo = tma + 3 * kLayoutLen;
  const CUtensorMapDataType t = f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode(&maps->q, q, lq, d, sq, bh, t, box_rows) ||
      !encode(&maps->k, k, lk, d, sk, bh, t, box_rows) ||
      !encode(&maps->v, v, lv, d, sk, bh, t, box_rows) ||
      (dout != nullptr &&
       !encode(&maps->o, dout, lo, d, sq, bh, t, box_rows))) {
    return false;
  }
  *a = make_attn(q, k, v, lq[4] / 2, lq[3] / 2, lk[4] / 2, lk[3] / 2,
                 lv[4] / 2, lv[3] / 2, kvb, kvb_bh, bias, bias_bh, seed,
                 drop_thresh, drop_inv, sq, sk, q_start, k_start, causal,
                 scale);
  return true;
}

}  // namespace
}  // namespace apex_port
