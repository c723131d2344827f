// Flash attention's dk and dv over [BH, S, D] bf16 or fp16 at head dims
// 384 and 512 (D 257-512, padded) for Hopper. The semantics they keep from
// the Pallas kernel are csrc/flash_common.cuh; the Hopper instructions they
// are built from are csrc/hopper.cuh, the tiles, ring and products they
// share with the other flash kernels csrc/flash_tiles.cuh, and the split
// of D over the two consumer warpgroups with the forward and dq at these
// head dims (csrc/flash_d512.cu) csrc/flash_d512.cuh.
//
// Replaces the Pallas kernel of
// apex_tpu/contrib/multihead_attn/flash_attention.py: _bwd_pallas ->
// _bwd_dkv_kernel (:392), dv += P^T dO and dk += dS^T Q · scale over the
// block's keys with P and dS recomputed in fp32 as _recompute_p_ds
// (:309-346) does, at the head dims the JAX package pads to 384 and 512
// lanes, with every input it takes (the full bias, kv_bias, dropout).
//
// Bound on this card. At [32, 1024, 320] causal (1.68e7 live (query, key)
// pairs) dk/dv's four products (K Q^T, V dO^T, P^T dO, dS^T Q) are
// 8·D·pairs = 43.0 GFLOP: 0.0435 ms at the bf16 tensor cores' 989 TFLOP/s;
// at [16, 1024, 512] 34.4 GFLOP, 0.0348 ms. Run at D 384 a D of 320 does
// 1.2x the products; the design below does five where four would do
// (1.25x).
//
// What holds the D <= 256 design back past 256 (csrc/flash_bwd.cu's split
// form: warpgroup V holding dv, warpgroup K dk, each over all of D for 64
// keys) is two walls. Registers: one accumulator over 64 keys is 64 x D
// fp32, 192 registers a thread at D 384 and 256 at 512, past setmaxnreg's
// 240 before the score tile and the fragments; dk and dv together are 256
// KB at D 512, the SM's whole register file. Shared memory: K and V of 64
// keys at D 512 are 128 KB, and a 64-query stage of Q and dO 128 KB more.
// So here dk/dv is two kernels, launched one after the other by one entry
// point, each the mirror of one of csrc/flash_d512.cu's with the roles of
// queries and keys exchanged:
// 1. A block owns 64 keys, both consumer warpgroups work on all of them,
//    and each holds half of one accumulator's columns, [w D / 2, (w + 1) D
//    / 2): 96 registers a thread at D 384, 128 at 512, as the forward and
//    dq here. The second product (P^T dO; dS^T Q) is one m64n192k16 or
//    m64n256k16 a k-step, dO (or Q) MN-major from the warpgroup's first
//    column tile, P^T (or dS^T) from registers.
// 2. The dv kernel is the forward's scheme: each warpgroup takes S^T = K
//    Q^T over its half of D (K-major, both operands in shared memory) and
//    the two trade their partial scores through shared memory (64 x 32
//    fp32 a warpgroup a tile, two buffers by the tile's parity, one named
//    barrier); fp32 addition commutes, so both hold the same scores bit
//    for bit, form the same P^T from lse (dropped and rescaled) and add
//    P^T dO into their halves of dv. It needs no V. Shared memory: K 48 or
//    64 KB, 32-query stages of Q and dO (three at D 384, two at 512), the
//    trade 32 KB: 209-225 KB.
// 3. The dk kernel is dq's scheme: warpgroup 0 takes S^T = K Q^T and P^T
//    (undropped), warpgroup 1 dP^T = V dO^T (dropped and rescaled), each
//    over all of D; they trade them, both form the same dS^T = P^T (dP'^T
//    - delta) and add dS^T Q · scale into their halves of dk. Shared
//    memory: K and V 96 or 128 KB, two stages of 32 queries at D 384 and
//    16 at 512, the trade: 208-224 KB.
// 4. So dk/dv takes five products where one kernel would take four (S^T
//    twice), reads Q twice and launches twice: the price of accumulators
//    that fit. The transposed form (dv^T and dk^T [D, keys] with M over D,
//    one warpgroup each, 32 keys a block) would need P and dS written to
//    swizzled shared memory as wgmma's B and twice the blocks re-reading
//    Q and dO; it was not built (PERF.md).
// 5. No padded copy: the maps are as wide as the tensors (any multiple of
//    8 from 264 to 512), and TMA fills the columns past them up to D with
//    zeros, which add nothing to the scores or dP and give zero columns of
//    dk and dv, which are not written. Every map's box is kXBox rows (32 at
//    D 384, 16 at 512: dk's query tiles; the dv kernel's 32-query tiles
//    and both kernels' 64 keys are whole boxes of it).
// 6. One producer warp issues the copies and stages each tile's lse (and
//    delta), the consumers' releases handing the stages back, as in the
//    other kernels. Query tiles wholly before the causal edge of the
//    block's first key are skipped; a warp whose 16 keys all see all of a
//    tile with no bias or dropout takes the unmasked recompute. The full
//    bias is read a score at a time from L2. Key rows that no query sees
//    get dk = dv = 0.
// P^T and dS^T enter their products rounded to E once, as the D <= 256
// dk/dv kernels take them. Each block owns its keys and writes dk (or dv)
// once, without atomics, so every output repeats bit for bit. The element
// type E (bf16 or fp16) sets the products' input type, the maps' and the
// rounding of P^T, dS^T and the outputs. The grids are one dim: bh-major,
// each bh's first keys (which see the most queries) first, so BH may pass
// 65535.

#include "flash_d512.cuh"

namespace apex_port {
namespace {

constexpr int kDvXQueries = 32;   // queries of the dv kernel's staged tiles

// stages of the dv kernel's ring: three at D 384, two at 512 (item 2)
template <int D>
constexpr int kDvXStages = D == 384 ? 3 : 2;
// queries of the dk kernel's staged tiles, and its stages (item 3)
template <int D>
constexpr int kDkXQueries = kXBox<D>;
constexpr int kDkXStages = 2;

template <int D>
struct DvXSmem {
  static constexpr int BQ = kDvXQueries, kS = kDvXStages<D>;
  Tile<kXRows, D> k;                       // the block's keys
  Tile<BQ, D> q[kS], o[kS];                // the ring of query tiles, dO
  float x[2][2][BQ / 2][128];              // the traded partial scores
  float lse[kS][BQ];                       // the tiles' lse, log2 units
  uint64_t full[kS], empty[kS], kbar;
};

template <int D>
struct DkXSmem {
  static constexpr int BQ = kDkXQueries<D>, kS = kDkXStages;
  Tile<kXRows, D> k, v;                    // the block's keys, values
  Tile<BQ, D> q[kS], o[kS];                // the ring of query tiles, dO
  float x[2][2][BQ / 2][128];              // P^T (warpgroup 0), dP'^T (1)
  float lse[kS][BQ], dlt[kS][BQ];          // lse in log2 units, delta
  uint64_t full[kS], empty[kS], kbar;
};

// the first query tile of BQ rows that sees key k0 (and so every later
// key): with the causal mask the first whose last row reaches it; the
// tile count when k0 lies past Sk
template <int BQ>
__device__ __forceinline__ int first_q_tile(const Attn& a, int k0) {
  const int nqt = (a.sq + BQ - 1) / BQ;
  if (k0 >= a.sk) return nqt;
  if (!a.causal) return 0;
  const int need = a.k_start + k0 - a.q_start - (BQ - 1);
  return need <= 0 ? 0 : min(nqt, (need + BQ - 1) / BQ);
}

// the producer warp of both kernels: the block's keys (and values) once,
// then each query tile's Q and dO with their lse (and delta) staged by its
// lanes
template <int D, int BQ, int NS, bool DELTA, typename S>
__device__ __forceinline__ void produce(S& sm, const Maps& maps,
                                        const Attn& a, const float* lse,
                                        const float* delta, int bh, int k0,
                                        int qt0, int nqt) {
  constexpr int BR = kXBox<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_expect_tx(&sm.kbar,
                          (DELTA ? 2 : 1) * Tile<kXRows, D>::kBytes);
    load_rows<BR>(sm.k, &maps.k, &sm.kbar, k0, bh);
    if constexpr (DELTA) load_rows<BR>(sm.v, &maps.v, &sm.kbar, k0, bh);
  }
  const float* lb = lse + (long long)bh * a.sq;
  const float* db = DELTA ? delta + (long long)bh * a.sq : nullptr;
  for (int i = 0; qt0 + i < nqt; ++i) {
    const int qt = qt0 + i, s = i % NS;
    if (i >= NS) mbar_wait(&sm.empty[s], (i / NS - 1) & 1);
    for (int r = lane; r < BQ; r += 32) {
      const int row = qt * BQ + r;
      sm.lse[s][r] = row < a.sq ? lb[row] * kLog2e : 0.f;
      if constexpr (DELTA) sm.dlt[s][r] = row < a.sq ? db[row] : 0.f;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.full[s], 2 * Tile<BQ, D>::kBytes);
      load_rows<BR>(sm.q[s], &maps.q, &sm.full[s], qt * BQ, bh);
      load_rows<BR>(sm.o[s], &maps.o, &sm.full[s], qt * BQ, bh);
    } else {
      mbar_arrive(&sm.full[s]);
    }
  }
}

// P^T of this thread's scores of the tile: keys kw + g (+ 8) against the
// tile's queries from q0, their lse (log2 units) at ls; kb_r the keys'
// kv_bias in log2 units. p = 0 where masked or below the value guard.
template <int BQ, bool EXTRA, bool M, bool B>
__device__ __forceinline__ void p_tile(const Attn& a, int bh, int kw, int q0,
                                       const float* ls, const float (&kb_r)[2],
                                       float (&sc)[BQ / 2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < BQ / 2; ++j) {
    const int h = (j >> 1) & 1;
    const int ql = (j >> 2) * 8 + 2 * t4 + (j & 1);
    if constexpr (!EXTRA && !M) {
      sc[j] = ex2(fmaf(sc[j], sl2, -ls[ql]));
    } else {
      const int kj = kw + g + 8 * h, qi = q0 + ql;
      float x = fmaf(sc[j], sl2, kb_r[h]);
      bool live = !M || visible(a, qi, kj);
      if (B && live) x += bias_at(a, bh, qi, kj);
      if (EXTRA) live = live && x > kNegInf * 0.5f;
      sc[j] = live ? ex2(x - ls[ql]) : 0.f;
    }
  }
}

// this warpgroup's half of dk (or dv) E [BH, Sk, dw] (dw the tensors'
// width: columns past it not written)
template <typename E, int H>
__device__ __forceinline__ void store_half(E* out, const Attn& a, int bh,
                                           int kw, int wg, int dw,
                                           const float (&acc)[H / 2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  E* ob = out + (long long)bh * a.sk * dw + wg * H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kw + g + 8 * h;
    if (row >= a.sk) continue;
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      if (wg * H + nt * 8 >= dw) break;
      *reinterpret_cast<uint32_t*>(ob + (long long)row * dw + nt * 8 +
                                   2 * t4) =
          pack2<E>(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
    }
  }
}

// kv_bias of this thread's two keys in log2 units
__device__ __forceinline__ void key_bias(const Attn& a, int bh, int kw,
                                         float (&kb_r)[2]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = kw + g + 8 * h;
    kb_r[h] = a.kvb != nullptr && kj < a.sk
                  ? a.kvb[bh * a.kvb_bh + kj] * kLog2e : 0.f;
  }
}

// ---- dv ------------------------------------------------------------------

// dv E [BH, Sk, dw]; blocks of 64 keys, the grid's one dim folding bh with
// them (bh-major, each bh's first keys first)
template <typename E, int D, bool EXTRA>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_dv_d512_kernel(const __grid_constant__ Maps maps, Attn a,
                     const float* __restrict__ lse, E* __restrict__ dv,
                     int dw) {
  constexpr int BQ = kDvXQueries, NS = kDvXStages<D>, H = D / 2;
  extern __shared__ uint8_t smem_raw[];
  DvXSmem<D>& sm = smem_as<DvXSmem<D>>(smem_raw);
  const int nb = (a.sk + kXRows - 1) / kXRows;
  const int bh = blockIdx.x / nb, k0 = (blockIdx.x % nb) * kXRows;
  const int wg = threadIdx.x >> 7;
  const int nqt = (a.sq + BQ - 1) / BQ;
  const int qt0 = first_q_tile<BQ>(a, k0);
  init_barriers(sm, &sm.kbar);

  if (wg == 2) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x >= 2 * 128 + 32) return;
    produce<D, BQ, NS, false>(sm, maps, a, lse, nullptr, bh, k0, qt0, nqt);
    return;
  }

  // ---- consumers: both warpgroups on keys [k0, k0 + 64), warpgroup wg
  // holding dv's columns [wg H, wg H + H)
  reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2,
            t4 = lane & 3;
  const int kw = k0 + (tid >> 5) * 16;    // this warp's 16 keys
  const int c0 = wg * (H / kBox);         // this warpgroup's column tiles
  float kb_r[2] = {0.f, 0.f};
  if (EXTRA) key_bias(a, bh, kw, kb_r);
  float acc[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
  mbar_wait(&sm.kbar, 0);
  int held = -1;   // the stage the last P^T dO product reads
  for (int i = 0; qt0 + i < nqt; ++i) {
    const int qt = qt0 + i, s = i % NS, par = i & 1;
    mbar_wait(&sm.full[s], (i / NS) & 1);
    float sc[BQ / 2];
    fence_regs(acc);
    wg_fence();
    cols_product<E, BQ, D / 32>(sc, sm.k, sm.q[s], c0);   // this half's S^T
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(acc);
    release(sm, held);
    held = -1;
    // the scores over all of D: this half's plus the other's
    put<BQ>(sm.x, par, wg, tid, sc);
    bar_sync(kXBar, 256);
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) sc[j] += sm.x[par][wg ^ 1][j][tid];
    // P^T (the recompute of _recompute_p_ds, :309-346), dropped and
    // rescaled, into its 16-bit fragments
    const bool full = all_visible(a, qt * BQ, BQ, kw, 16);
    uint32_t f[BQ / 16][4];
    with_tile_form<D, EXTRA>(!full, a, [&](auto mask, auto bias,
                                           auto drop) {
      constexpr bool M = decltype(mask)::value, B = decltype(bias)::value,
                     P = decltype(drop)::value;
      p_tile<BQ, EXTRA, M, B>(a, bh, kw, qt * BQ, sm.lse[s], kb_r, sc);
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * ks + 2 * jj + e;
            pd[e] = sc[j];
            if (P && a.drop_inv > 0.f) {
              const int kj = kw + g + 8 * ((j >> 1) & 1);
              const int qi = qt * BQ + (j >> 2) * 8 + 2 * t4 + (j & 1);
              pd[e] = keep(a, bh, qi, kj) ? pd[e] * a.drop_inv : 0.f;
            }
          }
          f[ks][jj] = pack2<E>(pd[0], pd[1]);
        }
      }
    });
    wg_fence();
    cols_by_tile<E, H, BQ / 16>(acc, f, sm.o[s], c0);   // dv += P^T dO
    wg_commit();
    held = s;
  }
  wg_wait<0>();
  fence_regs(acc);
  release(sm, held);
  store_half<E, H>(dv, a, bh, kw, wg, dw, acc);
}

// ---- dk ------------------------------------------------------------------

// dk E [BH, Sk, dw]; blocks of 64 keys as the dv kernel's. Warpgroup 0
// makes S^T and P^T, warpgroup 1 dP^T and dP'^T; each holds dk's columns
// [wg H, wg H + H)
template <typename E, int D, bool EXTRA>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_dk_d512_kernel(const __grid_constant__ Maps maps, Attn a,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, E* __restrict__ dk,
                     int dw) {
  constexpr int BQ = kDkXQueries<D>, NS = kDkXStages, H = D / 2;
  extern __shared__ uint8_t smem_raw[];
  DkXSmem<D>& sm = smem_as<DkXSmem<D>>(smem_raw);
  const int nb = (a.sk + kXRows - 1) / kXRows;
  const int bh = blockIdx.x / nb, k0 = (blockIdx.x % nb) * kXRows;
  const int wg = threadIdx.x >> 7;
  const int nqt = (a.sq + BQ - 1) / BQ;
  const int qt0 = first_q_tile<BQ>(a, k0);
  init_barriers(sm, &sm.kbar);

  if (wg == 2) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x >= 2 * 128 + 32) return;
    produce<D, BQ, NS, true>(sm, maps, a, lse, delta, bh, k0, qt0, nqt);
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2,
            t4 = lane & 3;
  const int kw = k0 + (tid >> 5) * 16;    // this warp's 16 keys
  const int c0 = wg * (H / kBox);         // this warpgroup's column tiles
  float kb_r[2] = {0.f, 0.f};
  if (EXTRA && wg == 0) key_bias(a, bh, kw, kb_r);
  float acc[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
  mbar_wait(&sm.kbar, 0);
  int held = -1;   // the stage the last dS^T Q product reads
  for (int i = 0; qt0 + i < nqt; ++i) {
    const int qt = qt0 + i, s = i % NS, par = i & 1;
    mbar_wait(&sm.full[s], (i / NS) & 1);
    float sc[BQ / 2];                     // S^T in warpgroup 0, dP^T in 1
    fence_regs(acc);
    wg_fence();
    if (wg == 0) {
      cols_product<E, BQ, D / 16>(sc, sm.k, sm.q[s], 0);
    } else {
      cols_product<E, BQ, D / 16>(sc, sm.v, sm.o[s], 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(acc);
    release(sm, held);
    held = -1;
    if (wg == 0) {
      // P^T, undropped
      const bool full = all_visible(a, qt * BQ, BQ, kw, 16);
      with_tile_form<D, EXTRA>(!full, a, [&](auto mask, auto bias,
                                             auto drop) {
        p_tile<BQ, EXTRA, decltype(mask)::value, decltype(bias)::value>(
            a, bh, kw, qt * BQ, sm.lse[s], kb_r, sc);
      });
    } else if (EXTRA && a.drop_inv > 0.f) {
      // dP'^T = dP^T dropped by the same hash and rescaled
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int kj = kw + g + 8 * ((j >> 1) & 1);
        const int qi = qt * BQ + (j >> 2) * 8 + 2 * t4 + (j & 1);
        sc[j] = keep(a, bh, qi, kj) ? sc[j] * a.drop_inv : 0.f;
      }
    }
    put<BQ>(sm.x, par, wg, tid, sc);
    bar_sync(kXBar, 256);
    // dS^T = p (dP' - delta), the same numbers in both warpgroups, times
    // the scale into its 16-bit fragments
    uint32_t f[BQ / 16][4];
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float xs[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * ks + 2 * jj + e;
          const int ql = (j >> 2) * 8 + 2 * t4 + (j & 1);
          const float other = sm.x[par][wg ^ 1][j][tid];
          const float p = wg == 0 ? sc[j] : other;
          const float dp = wg == 0 ? other : sc[j];
          xs[e] = p * (dp - sm.dlt[s][ql]) * a.scale;
        }
        f[ks][jj] = pack2<E>(xs[0], xs[1]);
      }
    }
    wg_fence();
    cols_by_tile<E, H, BQ / 16>(acc, f, sm.q[s], c0);   // dk += dS^T Q
    wg_commit();
    held = s;
  }
  wg_wait<0>();
  fence_regs(acc);
  release(sm, held);
  store_half<E, H>(dk, a, bh, kw, wg, dw, acc);
}

}  // namespace
}  // namespace apex_port

// q, k, v, dout [bh, s, d] (d 257-512, a multiple of 8: the kernels run at
// D 384 to d 384 and at 512 above, the columns past d read as zeros) of
// dtype (bf16 or fp16) whose tensor maps the wrapper describes in tma (4 x
// 8 long longs, in that order, as apex_flash_d512_dq's: dims d, s, bh; row
// and bh strides in bytes, multiples of 16; the box 64, 32, 1 at D 384 and
// 64, 16, 1 at 512), every base 16-byte aligned; lse, delta, kvb, bias and
// dropout as apex_flash_bwd_dkv (csrc/flash_bwd.cu); `blocks` the grids'
// blocks of 64 keys a bh; dk, dv [bh, sk, d] of the dtype, contiguous.
// Launches the dv kernel, then the dk kernel; returns the first launch
// error.
extern "C" int apex_flash_d512_dkv(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, const long long* tma,
                                   int blocks, const void* kvb,
                                   long long kvb_bh, const void* bias,
                                   long long bias_bh, unsigned seed,
                                   unsigned drop_thresh, float drop_inv,
                                   int bh, int sq, int sk, int d, int q_start,
                                   int k_start, int causal, float scale,
                                   void* stream) {
  using namespace apex_port;
  if (d < 257 || d > 512 || d % 8 != 0 || bh < 1 || sq < 1 || sk < 1 ||
      blocks != (sk + kXRows - 1) / kXRows ||
      (long long)blocks * bh > 0x7fffffffLL ||
      (dtype != kBF16 && dtype != kF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps maps;
  Attn a;
  if (!prepare(&maps, &a, dtype == kF16, q, k, v, dout, tma, kvb, kvb_bh,
               bias, bias_bh, seed, drop_thresh, drop_inv, bh, sq, sk, d,
               q_start, k_start, causal, scale,
               d <= 384 ? kXBox<384> : kXBox<512>)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks * bh);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const bool extra = a.kvb != nullptr || a.bias != nullptr ||
                     a.drop_inv > 0.f;
  cudaError_t err = cudaSuccess;
  with_elem(dtype, [&](auto et) {
    using E = typename decltype(et)::type;
    E* kp = static_cast<E*>(dk);
    E* vp = static_cast<E*>(dv);
    auto run = [&](auto dd, auto ex) {
      constexpr int D = decltype(dd)::value;
      constexpr bool X = decltype(ex)::value;
      auto dv_kernel = flash_dv_d512_kernel<E, D, X>;
      const int dv_bytes = smem_bytes<DvXSmem<D>>();
      err = cudaFuncSetAttribute(
          dv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dv_bytes);
      if (err != cudaSuccess) return;
      dv_kernel<<<grid, kBlockThreads, dv_bytes, st>>>(maps, a, lp, vp, d);
      err = cudaGetLastError();
      if (err != cudaSuccess) return;
      auto dk_kernel = flash_dk_d512_kernel<E, D, X>;
      const int dk_bytes = smem_bytes<DkXSmem<D>>();
      err = cudaFuncSetAttribute(
          dk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dk_bytes);
      if (err != cudaSuccess) return;
      dk_kernel<<<grid, kBlockThreads, dk_bytes, st>>>(maps, a, lp, dl, kp,
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
