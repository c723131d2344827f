// Flash attention's forward and dq over [BH, S, D] bf16 or fp16 at head
// dims 384 and 512 (D 257-512, padded) for Hopper. The semantics they keep
// from the Pallas kernels are csrc/flash_common.cuh; the Hopper
// instructions they are built from are csrc/hopper.cuh, and the tiles,
// ring, products, softmax and recompute they share with the kernels at D
// <= 256 (csrc/flash_fwd.cu, csrc/flash_bwd.cu) csrc/flash_tiles.cuh.
//
// Replaces the Pallas kernels of
// apex_tpu/contrib/multihead_attn/flash_attention.py: _flash_fwd ->
// _fwd_kernel (:181) and _bwd_pallas -> _bwd_dq_kernel (:349), at the head
// dims the JAX package pads to 384 and 512 lanes, with every input they
// take (the full bias, kv_bias, dropout; dq's per-bh dS).
//
// Bound on this card. At [32, 1024, 320] causal (1.68e7 live (query, key)
// pairs) the forward's products (QK^T, PV) are 4·D·pairs = 21.5 GFLOP and
// dq's three (QK^T, dO V^T, dS K) 32.2 GFLOP: 0.0217 and 0.0326 ms at the
// bf16 tensor cores' 989 TFLOP/s, under the forward's bytes (0.0251 ms);
// run at D 384 they do 1.2x the products.
//
// What holds the D <= 256 design back past 256 (a consumer warpgroup of 64
// query rows holding all of D) is two walls. Registers: O (or dq) over 64
// rows is 64 x D fp32, 192 a thread at D 384 and 256 at 512, past
// setmaxnreg's 240 before S and P. Shared memory: at D 512 the queries of
// 128 rows are 128 KB, and one 64-key stage of K and V 128 KB more, of
// the 227 a block may have. So here:
// 1. A block owns 64 query rows, and both consumer warpgroups work on all
//    of them, D split between them: warpgroup w holds O's (or dq's)
//    columns [w D / 2, (w + 1) D / 2), 96 registers a thread at D 384 and
//    128 at 512, as at D 256. The second product (PV; dS K) is one
//    m64n192k16 or m64n256k16 a k-step, V (or K) MN-major from the
//    warpgroup's first column tile.
// 2. The first products reduce over all of D. In the forward each
//    warpgroup takes QK^T over its half of D (K-major, both operands in
//    shared memory) and the two trade their partial scores through shared
//    memory (64 x 32 fp32, 8 KB a warpgroup a tile, two buffers by the
//    tile's parity under one named barrier): each adds the other's to its
//    own, and fp32 addition commutes, so both hold the same scores, bit
//    for bit. In dq warpgroup 0 takes S = QK^T and warpgroup 1 dP = dO V^T,
//    each over all of D, and they trade P (undropped) and dP' (dropped and
//    rescaled): each product runs once, and both warpgroups then form the
//    same dS = P (dP' - delta) from the same numbers. Both warpgroups so
//    apply the same softmax (or dS) to the same numbers, and every output
//    repeats bit for bit.
// 3. No padded copy: the tensors' maps are as wide as the tensors (any
//    multiple of 8 from 264 to 512), and TMA fills the columns past them
//    up to D with zeros, which add nothing to QK^T (or dO V^T) and give
//    zero columns of O (or dq), which are not written.
// 4. Key tiles small enough for a ring of at least two TMA stages beside
//    the block's own rows and the trade: the forward stages 32 keys (Q 48
//    KB + three stages of 48 at D 384; Q 64 KB + two of 64 at D 512; 224
//    KB with the trade's 32), dq 32 keys at D 384 (Q and dO 96 KB, two
//    stages of 48, the trade 32: 224 KB) and 16 at D 512 (Q and dO 128 KB,
//    two stages of 32, the trade 16: 208 KB). The maps' boxes are as deep
//    as a key tile.
// 5. One producer warp issues the copies, the consumers' releases handing
//    the stages back (empty mbarriers), as at D <= 256. Causal tiles past
//    the block's last row are skipped (both warpgroups own the same rows,
//    so they skip the same tiles). The full bias is read from L2 a score
//    at a time (the producer prefetches the tile's rows), as at D 256.
// P enters PV as two 16-bit fragments, its rounding to E and what that
// left: O then carries P to about 16 bits, as the fp32 P of the Pallas
// kernel (:221-226) and of the plain version, at the cost of a second PV
// product. With P rounded to bf16 alone (the D <= 256 forwards' way) o
// differs from the plain version's by P's rounding, and delta = rowsum(dO
// o) with it; at rows one key dominates, dS = p (dP - delta) is a
// difference of near-equal terms, and phase 30's autograd pass through
// the kernels (chip_smoke.py) found dq there 6-40x past the flash rule
// against the plain chain, where dq given the kernels' own lse and delta
// held at 0.6 of it.
// The trade puts the two warpgroups in step: their softmax (or P and dS)
// runs while the tensor cores wait, which the turns of the D <= 256
// kernels avoid. The other form of the forward, each warpgroup taking
// QK^T over all of D (1.5x the forward's products, no trade), was 2-13%
// slower on the H100 (flash_d512_ab.py, variant full_s).
//
// The element type E (bf16 or fp16) sets the products' input type, the
// tensor maps' and the rounding of P (and dS) into their register
// fragments and of the outputs. The grid is one dim: bh-major, the row
// blocks of each bh inside it, so BH may pass 65535.

#include "flash_tiles.cuh"

namespace apex_port {
namespace {

constexpr int kXRows = 64;      // query rows a block owns (both consumer
                                // warpgroups)
constexpr int kXBar = 5;        // the named barrier of the trade
constexpr int kFwdXKeys = 32;   // keys of the forward's staged tiles

// stages of the forward's ring: three at D 384, two at 512 (see the header)
template <int D>
constexpr int kFwdXStages = D == 384 ? 3 : 2;
// keys of dq's staged tiles, and its stages
template <int D>
constexpr int kDqXKeys = D == 384 ? 32 : 16;
constexpr int kDqXStages = 2;

template <int D>
struct FwdXSmem {
  static constexpr int BN = kFwdXKeys, kS = kFwdXStages<D>;
  Tile<kXRows, D> q;                       // the block's queries
  Tile<BN, D> k[kS], v[kS];                // the ring of key tiles
  float x[2][2][BN / 2][128];              // the traded partial scores:
                                           // [parity][warpgroup][elem][tid]
  float kvb[kS][BN];                       // the tiles' kv_bias, log2 units
  uint64_t full[kS], empty[kS], qbar;
};

template <int D>
struct DqXSmem {
  static constexpr int BN = kDqXKeys<D>, kS = kDqXStages;
  Tile<kXRows, D> q, o;                    // the block's queries, their dO
  Tile<BN, D> k[kS], v[kS];                // the ring of key tiles
  float x[2][2][BN / 2][128];              // P (warpgroup 0) and dP' (1)
  float kvb[kS][BN];                       // the tiles' kv_bias, log2 units
  uint64_t full[kS], empty[kS], qo;
};

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

// ---- the forward -------------------------------------------------------------

// o E [BH, Sq, dw] (dw <= D, the tensors' width: their columns past it
// are zeros up to D) and lse fp32 [BH, Sq], contiguous; blocks of 64 query
// rows, the grid's one dim folding bh with them (bh-major, each bh's
// longest rows first)
template <typename E, int D, int KIND>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_fwd_d512_kernel(const __grid_constant__ Maps maps, Attn a,
                      E* __restrict__ o, float* __restrict__ lse, int dw) {
  constexpr bool EXTRA = KIND != kPlainKind, BIAS = KIND == kBiasKind;
  constexpr int BN = kFwdXKeys, NS = kFwdXStages<D>, H = D / 2;
  extern __shared__ uint8_t smem_raw[];
  FwdXSmem<D>& sm = smem_as<FwdXSmem<D>>(smem_raw);
  const int nb = (a.sq + kXRows - 1) / kXRows;
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * kXRows;   // longest first
  const int wg = threadIdx.x >> 7;
  const int nkt = key_tiles<BN>(a, q0, kXRows);
  init_barriers(sm, &sm.qbar);

  if (wg == 2) {
    // ---- producer: the block's Q once, then the key tiles
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x >= 2 * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.qbar, Tile<kXRows, D>::kBytes);
      load_rows<BN>(sm.q, &maps.q, &sm.qbar, q0, bh);
    }
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % NS;
      if (kt >= NS) mbar_wait(&sm.empty[s], (kt / NS - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 2 * Tile<BN, D>::kBytes);
        load_rows<BN>(sm.k[s], &maps.k, &sm.full[s], kt * BN, bh);
        load_rows<BN>(sm.v[s], &maps.v, &sm.full[s], kt * BN, bh);
      }
      if (EXTRA) {
        if (BIAS) prefetch_bias<BN, kXRows>(a, bh, q0, kt * BN, lane);
        for (int r = lane; r < BN; r += 32) {
          const int kj = kt * BN + r;
          sm.kvb[s][r] = a.kvb != nullptr && kj < a.sk
                             ? a.kvb[bh * a.kvb_bh + kj] * kLog2e : 0.f;
        }
      }
      mbar_arrive(&sm.full[s]);
    }
    return;
  }

  // ---- consumers: both warpgroups on queries [q0, q0 + 64), warpgroup wg
  // holding O's columns [wg H, wg H + H)
  reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2,
            t4 = lane & 3;
  const int qw = q0 + (tid >> 5) * 16;    // this warp's 16 rows
  const int c0 = wg * (H / kBox);         // this warpgroup's column tiles
  float acc[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float none[1] = {0.f};            // the bias is read a score at a time
  mbar_wait(&sm.qbar, 0);
  int held = -1;   // the stage the last PV product reads
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % NS, par = kt & 1;
    mbar_wait(&sm.full[s], (kt / NS) & 1);
    float sc[BN / 2];
    fence_regs(acc);
    wg_fence();
    cols_product<E, BN, D / 32>(sc, sm.q, sm.k[s], c0);   // this half's S
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(acc);
    release(sm, held);
    held = -1;
    // the scores over all of D: this half's plus the other's
    put<BN>(sm.x, par, wg, tid, sc);
    bar_sync(kXBar, 256);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] += sm.x[par][wg ^ 1][i][tid];
    const bool plain = all_visible(a, qw, 16, kt * BN, BN) && a.scale > 0.f;
    float alpha[2];
    uint32_t pf[BN / 16][4], plo[BN / 16][4];
    fwd_tile_form<D, KIND>(!plain, a, [&](auto mask, auto bias,
                                          auto drop) {
      softmax_tile<E, BN, EXTRA, decltype(mask)::value,
                   decltype(bias)::value, decltype(drop)::value>(
          a, bh, qw, kt * BN, sc, sm.kvb[s], none, m, l, alpha, pf, plo);
    });
#pragma unroll
    for (int i = 0; i < H / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    wg_fence();
    // O += P V, P as its rounding to E and what that left
    cols_by_tile<E, H, BN / 16>(acc, pf, sm.v[s], c0);
    cols_by_tile<E, H, BN / 16>(acc, plo, sm.v[s], c0);
    wg_commit();
    held = s;
  }
  wg_wait<0>();
  fence_regs(acc);
  release(sm, held);
  // the rows' sums over their four lanes (the same in both warpgroups); o
  // = acc / l, lse = m ln 2 + ln l (o = 0 and lse = kNegInf for a row that
  // saw nothing), lse by warpgroup 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  E* ob = o + (long long)bh * a.sq * dw + wg * H;
  float* lb = lse + (long long)bh * a.sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + g + 8 * h;
    if (row >= a.sq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 1.f;
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      if (wg * H + nt * 8 >= dw) break;
      *reinterpret_cast<uint32_t*>(ob + (long long)row * dw + nt * 8 +
                                   2 * t4) =
          pack2<E>(acc[4 * nt + 2 * h] * inv, acc[4 * nt + 2 * h + 1] * inv);
    }
    if (wg == 0 && t4 == 0) {
      lb[row] = l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : kNegInf;
    }
  }
}

// ---- dq (and the per-bh dS) --------------------------------------------------

// dq E [BH, Sq, dw] contiguous (dw as the forward's); ds (null, or fp32
// [BH, Sq, Sk] contiguous): dS of every (query, key), unscaled, zeros where
// a tile is skipped; blocks of 64 query rows as the forward's
template <typename E, int D, bool EXTRA>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_dq_d512_kernel(const __grid_constant__ Maps maps, Attn a,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, E* __restrict__ dq,
                     float* __restrict__ ds, int dw) {
  constexpr int BN = kDqXKeys<D>, NS = kDqXStages, H = D / 2;
  extern __shared__ uint8_t smem_raw[];
  DqXSmem<D>& sm = smem_as<DqXSmem<D>>(smem_raw);
  const int nb = (a.sq + kXRows - 1) / kXRows;
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * kXRows;   // longest first
  const int wg = threadIdx.x >> 7;
  const int nkt = key_tiles<BN>(a, q0, kXRows);
  init_barriers(sm, &sm.qo);

  if (wg == 2) {
    // ---- producer: the block's Q and dO once, then the key tiles
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x >= 2 * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.qo, 2 * Tile<kXRows, D>::kBytes);
      load_rows<BN>(sm.q, &maps.q, &sm.qo, q0, bh);
      load_rows<BN>(sm.o, &maps.o, &sm.qo, q0, bh);
    }
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % NS;
      if (kt >= NS) mbar_wait(&sm.empty[s], (kt / NS - 1) & 1);
      if (EXTRA) {
        for (int r = lane; r < BN; r += 32) {
          const int kj = kt * BN + r;
          sm.kvb[s][r] = a.kvb != nullptr && kj < a.sk
                             ? a.kvb[bh * a.kvb_bh + kj] * kLog2e : 0.f;
        }
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * Tile<BN, D>::kBytes);
        load_rows<BN>(sm.k[s], &maps.k, &sm.full[s], kt * BN, bh);
        load_rows<BN>(sm.v[s], &maps.v, &sm.full[s], kt * BN, bh);
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // ---- consumers: both warpgroups on queries [q0, q0 + 64); warpgroup 0
  // makes S and P, warpgroup 1 dP and dP'; each holds dq's columns [wg H,
  // wg H + H)
  reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2,
            t4 = lane & 3;
  const int qw = q0 + (tid >> 5) * 16;    // this warp's 16 rows
  const int c0 = wg * (H / kBox);         // this warpgroup's column tiles
  // lse in log2 units, and delta, of this thread's two rows
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + g + 8 * h;
    const long long i = (long long)bh * a.sq + row;
    lse_r[h] = row < a.sq ? lse[i] * kLog2e : 0.f;
    dlt_r[h] = row < a.sq ? delta[i] : 0.f;
  }
  const float sl2 = a.scale * kLog2e;
  float* dsb = EXTRA && ds != nullptr && wg == 0
                   ? ds + (long long)bh * a.sq * a.sk : nullptr;
  float acc[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
  mbar_wait(&sm.qo, 0);
  int held = -1;   // the stage the last dS K product reads
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % NS, par = kt & 1;
    mbar_wait(&sm.full[s], (kt / NS) & 1);
    float sc[BN / 2];                     // S in warpgroup 0, dP in 1
    fence_regs(acc);
    wg_fence();
    if (wg == 0) {
      cols_product<E, BN, D / 16>(sc, sm.q, sm.k[s], 0);
    } else {
      cols_product<E, BN, D / 16>(sc, sm.o, sm.v[s], 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(acc);
    release(sm, held);
    held = -1;
    if (wg == 0) {
      // P, undropped (the recompute of _recompute_p_ds, :309-346)
      const bool full = all_visible(a, qw, 16, kt * BN, BN);
      with_tile_form<D, EXTRA>(!full, a, [&](auto mask, auto bias,
                                             auto drop) {
        constexpr bool M = decltype(mask)::value, B = decltype(bias)::value;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int h = (i >> 1) & 1;
          if constexpr (!EXTRA && !M) {
            sc[i] = ex2(fmaf(sc[i], sl2, -lse_r[h]));
          } else {
            const int qi = qw + g + 8 * h;
            const int kl = (i >> 2) * 8 + 2 * t4 + (i & 1);
            const int kj = kt * BN + kl;
            float x = fmaf(sc[i], sl2, EXTRA ? sm.kvb[s][kl] : 0.f);
            bool live = !M || visible(a, qi, kj);
            if (B && live) x += bias_at(a, bh, qi, kj);
            if (EXTRA) live = live && x > kNegInf * 0.5f;
            sc[i] = live ? ex2(x - lse_r[h]) : 0.f;
          }
        }
      });
    } else if (EXTRA && a.drop_inv > 0.f) {
      // dP' = dP dropped by the same hash and rescaled
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int qi = qw + g + 8 * ((i >> 1) & 1);
        const int kj = kt * BN + (i >> 2) * 8 + 2 * t4 + (i & 1);
        sc[i] = keep(a, bh, qi, kj) ? sc[i] * a.drop_inv : 0.f;
      }
    }
    put<BN>(sm.x, par, wg, tid, sc);
    bar_sync(kXBar, 256);
    // dS = p (dP' - delta), the same numbers in both warpgroups, times the
    // scale into its 16-bit fragments
    uint32_t f[BN / 16][4];
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float xs[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * ks + 2 * j + e;
          const int h = (i >> 1) & 1;
          const float other = sm.x[par][wg ^ 1][i][tid];
          const float p = wg == 0 ? sc[i] : other;
          const float dp = wg == 0 ? other : sc[i];
          const float d = p * (dp - dlt_r[h]);
          if (EXTRA && dsb != nullptr) {
            const int qi = qw + g + 8 * h;
            const int kj = kt * BN + (i >> 2) * 8 + 2 * t4 + (i & 1);
            if (qi < a.sq && kj < a.sk) dsb[(long long)qi * a.sk + kj] = d;
          }
          xs[e] = d * a.scale;
        }
        f[ks][j] = pack2<E>(xs[0], xs[1]);
      }
    }
    wg_fence();
    cols_by_tile<E, H, BN / 16>(acc, f, sm.k[s], c0);   // dq += dS K
    wg_commit();
    held = s;
  }
  wg_wait<0>();
  fence_regs(acc);
  release(sm, held);
  if (EXTRA && ds != nullptr) {
    // the key tiles the block skips: dS = 0 there, over both warpgroups
    float* zb = ds + (long long)bh * a.sq * a.sk;
    const int k_from = nkt * BN, wide = a.sk - k_from;
    for (int i = wg * 128 + tid; wide > 0 && i < kXRows * wide; i += 256) {
      const int qi = q0 + i / wide;
      if (qi < a.sq) zb[(long long)qi * a.sk + k_from + i % wide] = 0.f;
    }
  }
  E* out = dq + (long long)bh * a.sq * dw + wg * H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + g + 8 * h;
    if (row >= a.sq) continue;
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      if (wg * H + nt * 8 >= dw) break;
      *reinterpret_cast<uint32_t*>(out + (long long)row * dw + nt * 8 +
                                   2 * t4) =
          pack2<E>(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
    }
  }
}

// what the entry points refuse: a width d (the tensors', run at D 384 up
// to 384 and 512 above) outside 257-512 or not a multiple of 8, no rows, a
// grid (blocks of 64 rows, folded with bh) other than the rows' or past
// 2^31 - 1
bool bad_x(int dtype, int bh, int sq, int sk, int d, int blocks) {
  return d < 257 || d > 512 || d % 8 != 0 || bh < 1 || sq < 1 || sk < 1 ||
         blocks != (sq + kXRows - 1) / kXRows ||
         (long long)blocks * bh > 0x7fffffffLL ||
         (dtype != kBF16 && dtype != kF16);
}

}  // namespace
}  // namespace apex_port

// q, k, v [bh, s, d] (d 257-512, a multiple of 8: the kernel runs at D 384
// to d 384 and at 512 above, the columns past d read as zeros) of dtype
// (bf16 or fp16) whose tensor maps the wrapper describes in tma (3 x 8
// long longs, in that order: dims d, s, bh; row and bh strides in bytes,
// multiples of 16; the box 64, 32, 1), every base 16-byte aligned;
// `blocks` the grid's blocks of 64 query rows a bh; kvb, bias, dropout and
// the outputs o [bh, sq, d], lse as apex_flash_fwd (csrc/flash_fwd.cu).
extern "C" int apex_flash_d512_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const long long* tma, int blocks,
                                   const void* kvb, long long kvb_bh,
                                   const void* bias, long long bias_bh,
                                   unsigned seed, unsigned drop_thresh,
                                   float drop_inv, int bh, int sq, int sk,
                                   int d, int q_start, int k_start,
                                   int causal, float scale, void* stream) {
  using namespace apex_port;
  if (bad_x(dtype, bh, sq, sk, d, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps maps{};
  Attn a;
  if (!prepare(&maps, &a, dtype == kF16, q, k, v, nullptr, tma, kvb,
               kvb_bh, bias, bias_bh, seed, drop_thresh, drop_inv, bh, sq,
               sk, d, q_start, k_start, causal, scale, kFwdXKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks * bh);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  cudaError_t err = cudaSuccess;
  const int kind = a.bias != nullptr ? kBiasKind
                   : a.kvb != nullptr || a.drop_inv > 0.f ? kExtraKind
                                                          : kPlainKind;
  with_elem(dtype, [&](auto et) {
    using E = typename decltype(et)::type;
    E* op = static_cast<E*>(o);
    auto run = [&](auto dd, auto kk) {
      constexpr int D = decltype(dd)::value, K = decltype(kk)::value;
      auto kernel = flash_fwd_d512_kernel<E, D, K>;
      const int bytes = smem_bytes<FwdXSmem<D>>();
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return;
      kernel<<<grid, kBlockThreads, bytes, st>>>(maps, a, op, lp, d);
      err = cudaGetLastError();
    };
    using std::integral_constant;
    auto by_kind = [&](auto dd) {
      if (kind == kBiasKind) {
        run(dd, integral_constant<int, kBiasKind>{});
      } else if (kind == kExtraKind) {
        run(dd, integral_constant<int, kExtraKind>{});
      } else {
        run(dd, integral_constant<int, kPlainKind>{});
      }
    };
    if (d <= 384) by_kind(integral_constant<int, 384>{});
    else by_kind(integral_constant<int, 512>{});
  });
  return static_cast<int>(err);
}

// q, k, v, dout [bh, s, d] (d as apex_flash_d512_fwd's) of dtype (bf16 or
// fp16), their maps in tma (4 x 8 long longs, as apex_flash_d512_fwd's,
// the box 64, 32, 1 at D 384 and 64, 16, 1 at 512); lse, delta, kvb,
// bias, dropout, dq [bh, sq, d] and ds as apex_flash_bwd_dq
// (csrc/flash_bwd.cu); `blocks` the grid's blocks of 64 query rows a bh.
extern "C" int apex_flash_d512_dq(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, void* ds, const long long* tma,
                                  int blocks, const void* kvb,
                                  long long kvb_bh, const void* bias,
                                  long long bias_bh, unsigned seed,
                                  unsigned drop_thresh, float drop_inv,
                                  int bh, int sq, int sk, int d, int q_start,
                                  int k_start, int causal, float scale,
                                  void* stream) {
  using namespace apex_port;
  if (bad_x(dtype, bh, sq, sk, d, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps maps;
  Attn a;
  if (!prepare(&maps, &a, dtype == kF16, q, k, v, dout, tma, kvb, kvb_bh,
               bias, bias_bh, seed, drop_thresh, drop_inv, bh, sq, sk, d,
               q_start, k_start, causal, scale,
               d <= 384 ? kDqXKeys<384> : kDqXKeys<512>)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ds != nullptr && a.kvb == nullptr && a.bias == nullptr &&
      !(a.drop_inv > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks * bh);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dsp = static_cast<float*>(ds);
  const bool extra = a.kvb != nullptr || a.bias != nullptr ||
                     a.drop_inv > 0.f;
  cudaError_t err = cudaSuccess;
  with_elem(dtype, [&](auto et) {
    using E = typename decltype(et)::type;
    E* out = static_cast<E*>(dq);
    auto run = [&](auto dd, auto ex) {
      constexpr int D = decltype(dd)::value;
      auto kernel = flash_dq_d512_kernel<E, D, decltype(ex)::value>;
      const int bytes = smem_bytes<DqXSmem<D>>();
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return;
      kernel<<<grid, kBlockThreads, bytes, st>>>(maps, a, lp, dl, out, dsp,
                                                 d);
      err = cudaGetLastError();
    };
    using std::integral_constant;
    auto by_extra = [&](auto dd) {
      if (extra) run(dd, integral_constant<bool, true>{});
      else run(dd, integral_constant<bool, false>{});
    };
    if (d <= 384) by_extra(integral_constant<int, 384>{});
    else by_extra(integral_constant<int, 512>{});
  });
  return static_cast<int>(err);
}
