// Flash attention's backward over [BH, S, D] bf16 or fp16 (D 64, 128 or
// 256) for Hopper: dq (with the per-bh bias gradient dS when asked) and
// dk/dv, each
// recomputing the probabilities from the forward's lse. The semantics they
// keep from the Pallas kernels are csrc/flash_common.cuh; the Hopper
// instructions they are built from are csrc/hopper.cuh, and the tiles,
// ring, products and turns they share with the forward csrc/flash_tiles.cuh.
//
// Replaces the Pallas kernels of
// apex_tpu/contrib/multihead_attn/flash_attention.py: _bwd_pallas ->
// _bwd_dq_kernel (:349) and _bwd_dkv_kernel (:392), both recomputing P and
// dS as _recompute_p_ds (:309-346) does, with every input they take (the
// full bias, kv_bias, dropout; dq's per-bh dS, dbias_in_dq at :471).
//
// Bound on this card. At lm_bench's shape (BH = 128, S = 4095, D = 64,
// causal: 1.07e9 live (query, key) pairs) dq's three products (QK^T, dO V^T,
// dS K) are 6·D·pairs = 412 GFLOP and dk/dv's four (KQ^T, V dO^T, P^T dO,
// dS^T Q) 8·D·pairs = 550 GFLOP, against ~340 MB and ~400 MB of operands
// and results: ~1200 operations per byte, above the H100's 295, so the
// bf16 tensor cores' 989 TFLOP/s bound them (0.417 and 0.556 ms). Each
// kernel also takes one exp2 a live pair, 1.07e9 on the special-function
// units (16 a clock an SM: ~0.3 ms), a second floor close to dq's first.
// At the wide LM's [384, 2048, 128] the products bound them at 0.626 and
// 0.834 ms. At the ViT's [1536, 197, 64] the bound is bytes (~194 MB for
// dq: 0.058 ms; the products 0.023 ms).
//
// What the design does about the limits of the mma.sync kernels it
// replaces:
// 1. Products on the Ampere instruction: every product here is a
//    warpgroup wgmma.mma_async (m64nNk16, bf16 in, fp32 accumulators), the
//    instruction that reaches the full tensor-core rate on Hopper.
// 2. The staged tile re-read by every warp: the tensor cores read it once
//    per warpgroup from 128-byte-swizzled shared memory. The first
//    products (QK^T, dO V^T; KQ^T, V dO^T) take it K-major; the second (dS
//    K; P^T dO, dS^T Q) take it MN-major (wgmma's transpose bit), the same
//    bytes, and P or dS from registers, rounded to bf16: the scores'
//    accumulator layout is wgmma's register-A fragment. At D = 64 the
//    block's own rows (Q and dO; K and V) also enter the first products
//    from registers, loaded once: an m64n64k16 product with both operands
//    in shared memory reads 4 KB in its 32 clocks, all of the SM's
//    shared-memory bandwidth.
// 3. One tile in flight: the staged tiles arrive by TMA
//    (cp.async.bulk.tensor) through a ring of kStages buffers that a
//    producer warp keeps full, full and empty mbarriers handing them over
//    (a consumer releases a buffer once the products that read it have
//    completed). TMA's zero fill past the tensor's end stands for the
//    ragged tail (S = 4095, 197). Two stages left dq 31% slower at the LM
//    shape than three on the H100; four gained nothing.
// 4. Register caps that split the tiles: a block owns 128 rows (queries
//    for dq, keys for dk/dv) as two consumer warpgroups of 64 sharing each
//    staged 64-row tile, and the producer warpgroup gives them its
//    registers (setmaxnreg: 240 and 24 a thread). At D = 128 dk and dv
//    alone are 128 fp32 registers a thread, and with the transposed scores
//    and dP of all 64 queries beside them ptxas serialised the products,
//    so dk/dv takes a staged tile there in two rounds of 32 queries.
// 5. Everything recomputed twice: the two kernels still recompute QK^T,
//    dO V^T and one exp2 a pair each (7 products where a fused backward
//    needs 5), since a fused one adds dq across key blocks with float
//    atomics, which do not repeat bit for bit. Here each block owns its
//    output rows and every output repeats bit for bit. What the split
//    costs is bounded instead: the recompute of a tile with no mask, bias
//    or dropout is one fused multiply-add, one exp2 on the special-function
//    unit and two more operations an element, its form chosen a tile at a
//    time (with_tile_form), and the two consumer warpgroups take turns
//    issuing their first products (named barriers), so that the tensor
//    cores run one's products while the other works out P and dS.
// dq at D = 256 (dk/dv there: flash_dkv_split_kernel, below). The
// block's Q and dO alone take 128 KB of the 227 a block may have, and a
// 64-key stage of K and V 64 KB more, so the ring stages 32 keys a tile
// (16 + 16 KB: three stages, 224 KB in all; the maps' boxes are 32 rows).
// That also keeps the registers: dq's 64 x 256 accumulator is 128 fp32 a
// thread, and the 32-key tile's S and dP add 16 each where 64 keys would
// add 32 each. dS K is one m64n256k16 product a k-step, K MN-major across
// its four 64-column tiles. At [32, 1024, 256] causal (1.68e7 pairs) the
// three products are 6·D·pairs = 25.8 GFLOP: 0.0261 ms at 989 TFLOP/s; at
// the hd-256 LM's [64, 4096, 256] 0.834 ms.
// Causal work is skipped a warpgroup at a time: a block visits the tiles
// its 128 rows see, and a warpgroup waits out the tiles its own 64 do not.
// With the recompute taken out (a diagnostic build, both first-product
// operands then still in shared memory) the LM shape's dq and dk/dv took
// 0.83 and 1.04 ms on the H100 against 0.96 and 1.22 with it: the
// products and their feeding, not exp2, set the floor these kernels sit
// on.
//
// The element type E (bf16 or fp16) sets the products' input type (wgmma's
// .bf16 or .f16), the tensor maps' and the rounding of P (and dS) into
// their register fragments and of the outputs; the rest is one body, and
// the bf16 forms compute what they did before fp16 was added, bit for bit.
// The grid is one dim: bh-major, the row blocks of each bh inside it, so
// BH may pass 65535.
// The host builds the tensor maps (dims, strides and boxes come from the
// Python wrapper, ops/flash_attn.py tma_layout) with cuTensorMapEncodeTiled,
// fetched through cudaGetDriverEntryPoint so that nothing links libcuda,
// and passes them as __grid_constant__ parameters.

#include "flash_tiles.cuh"

namespace apex_port {
namespace {

constexpr int kStages = 3;        // tiles of the copy ring

// keys of dq's staged tiles, and the rows of its maps' boxes: 64, and 32
// at D = 256 (see the header)
template <int D>
constexpr int kDqKeys = D == 256 ? 32 : kBox;

template <int D>
struct DqSmem {
  static constexpr int BN = kDqKeys<D>;
  Tile<kRows, D> q, o;                    // the block's queries, their dO
  Tile<BN, D> k[kStages], v[kStages];     // the ring of key tiles
  float kvb[kStages][BN];                 // their kv_bias, log2 units
  uint64_t full[kStages], empty[kStages], qo;
};

template <int D>
struct DkvSmem {
  Tile<kRows, D> k, v;                    // the block's keys and values
  Tile<kBox, D> q[kStages], o[kStages];   // the ring of query tiles, dO
  // lse in log2 units; delta, and delta times the scale
  float lse[kStages][kBox], dlt[kStages][kBox], dlts[kStages][kBox];
  uint64_t full[kStages], empty[kStages], kv;
};

// queries of a staged tile dk/dv takes in one round (see its loop)
template <int D>
constexpr int kRound = D == 64 ? kBox : kBox / 2;

// the first 64-query tile that sees key k0 (and so every key after it):
// with the causal mask the first whose last row reaches it; Sq's tile
// count when k0 lies past Sk
__device__ __forceinline__ int first_query_tile(const Attn& a, int k0) {
  const int nqt = (a.sq + kBox - 1) / kBox;
  if (k0 >= a.sk) return nqt;
  if (!a.causal) return 0;
  const int need = a.k_start + k0 - a.q_start - (kBox - 1);
  return need <= 0 ? 0 : min(nqt, (need + kBox - 1) / kBox);
}

// ---- dq (and the per-bh dS) ------------------------------------------------

// ds (null, or fp32 [BH, Sq, Sk] contiguous): dS of every (query, key),
// unscaled, zeros where a tile is skipped (:382-386); the grid's one dim
// folds bh with the row blocks (bh-major, each bh's longest rows first)
template <typename E, int D, bool EXTRA>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_dq_kernel(const __grid_constant__ Maps maps, Attn a,
                const float* __restrict__ lse,
                const float* __restrict__ delta, E* __restrict__ dq,
                float* __restrict__ ds) {
  constexpr int BN = kDqKeys<D>;
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = smem_as<DqSmem<D>>(smem_raw);
  const int nb = (a.sq + kRows - 1) / kRows;
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * kRows;    // longest first
  const int wg = threadIdx.x >> 7;
  const int nkt = key_tiles<BN>(a, q0, kRows);
  init_barriers(sm, &sm.qo);

  if (wg == 2) {
    // ---- producer: the block's Q and dO once, then the key tiles
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x >= 2 * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.qo, 2 * Tile<kRows, D>::kBytes);
      load_rows<BN>(sm.q, &maps.q, &sm.qo, q0, bh);
      load_rows<BN>(sm.o, &maps.o, &sm.qo, q0, bh);
    }
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % kStages;
      if (kt >= kStages) mbar_wait(&sm.empty[s], (kt / kStages - 1) & 1);
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

  // ---- consumers: warpgroup wg owns queries [r0, r0 + 64)
  reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2,
            t4 = lane & 3;
  const int r0 = q0 + wg * kWgRows;
  const int qw = r0 + (tid >> 5) * 16;    // this warp's 16 rows
  // lse in log2 units; delta, and delta times the scale
  float lse_r[2], dlt_r[2], dlts_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + g + 8 * h;
    const long long i = (long long)bh * a.sq + row;
    lse_r[h] = row < a.sq ? lse[i] * kLog2e : 0.f;
    dlt_r[h] = row < a.sq ? delta[i] : 0.f;
    dlts_r[h] = dlt_r[h] * a.scale;
  }
  const float sl2 = a.scale * kLog2e;
  float* dsb = EXTRA && ds != nullptr ? ds + (long long)bh * a.sq * a.sk
                                      : nullptr;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const int nkt_wg = key_tiles<BN>(a, r0, kWgRows);
  mbar_wait(&sm.qo, 0);
  uint32_t qf[kASteps<D>][4], of[kASteps<D>][4];
  if constexpr (D == 64) {
    load_frags(qf, sm.q, wg * kWgRows);
    load_frags(of, sm.o, wg * kWgRows);
  }
  if (wg == 1) turn_end(1);
  int held = -1;   // the stage the last dS K product reads
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&sm.full[s], (kt / kStages) & 1);
    if (kt >= nkt_wg) {               // past this warpgroup's causal edge
      turn_begin(wg);
      turn_end(wg);
      wg_wait<0>();
      fence_regs(acc);
      release(sm, held);
      held = -1;
      release(sm, s);
      continue;
    }
    float sc[BN / 2], dp[BN / 2];
    fence_regs(acc);
    turn_begin(wg);
    wg_fence();
    first_product<E, D, BN>(sc, sm.q, wg * kWgRows, qf, sm.k[s], 0);
    first_product<E, D, BN>(dp, sm.o, wg * kWgRows, of, sm.v[s], 0);
    wg_commit();
    turn_end(wg);
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc);
    release(sm, held);
    held = -1;
    // dS * scale, each pair packed into its 16-bit fragment as it is made
    const bool full = all_visible(a, qw, 16, kt * BN, BN);
    uint32_t f[BN / 16][4];
    with_tile_form<D, EXTRA>(!full, a, [&](auto mask, auto bias, auto drop) {
      constexpr bool M = decltype(mask)::value, B = decltype(bias)::value,
                     P = decltype(drop)::value;
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * ks + 2 * j + e;
            const int h = (i >> 1) & 1;
            if constexpr (!EXTRA && !M) {
              // no mask, bias or dropout: p (dP scale - delta scale)
              x[e] = ex2(fmaf(sc[i], sl2, -lse_r[h])) *
                     fmaf(dp[i], a.scale, -dlts_r[h]);
            } else {
              const int qi = qw + g + 8 * h;
              const int kl = (i >> 2) * 8 + 2 * t4 + (i & 1);
              const int kj = kt * BN + kl;
              float d;
              recompute<EXTRA, M, B, P>(a, bh, qi, kj, sc[i], sl2,
                                        EXTRA ? sm.kvb[s][kl] : 0.f, dp[i],
                                        lse_r[h], dlt_r[h], d);
              if (EXTRA && dsb != nullptr &&
                  (!M || (qi < a.sq && kj < a.sk))) {
                dsb[(long long)qi * a.sk + kj] = d;
              }
              x[e] = d * a.scale;
            }
          }
          f[ks][j] = pack2<E>(x[0], x[1]);
        }
      }
    });
    wg_fence();
    frags_by_tile<E, D, BN / 16>(acc, f, sm.k[s], 0);  // dq += dS K
    wg_commit();
    held = s;
  }
  if (wg == 0) turn_begin(0);
  wg_wait<0>();
  fence_regs(acc);
  release(sm, held);
  if (EXTRA && dsb != nullptr) {
    // the key tiles this warpgroup skips: dS = 0 there
    const int k_from = nkt_wg * BN, wide = a.sk - k_from;
    for (int i = tid; wide > 0 && i < kWgRows * wide; i += 128) {
      const int qi = r0 + i / wide;
      if (qi < a.sq) dsb[(long long)qi * a.sk + k_from + i % wide] = 0.f;
    }
  }
  E* out = dq + (long long)bh * a.sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + g + 8 * h;
    if (row >= a.sq) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(out + (long long)row * D + nt * 8 +
                                   2 * t4) =
          pack2<E>(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
    }
  }
}

// ---- dk, dv ----------------------------------------------------------------

template <typename E, int D, bool EXTRA>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_dkv_kernel(const __grid_constant__ Maps maps, Attn a,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, E* __restrict__ dk,
                 E* __restrict__ dv) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem<D>& sm = smem_as<DkvSmem<D>>(smem_raw);
  const int nb = (a.sk + kRows - 1) / kRows;
  const int bh = blockIdx.x / nb, kb = blockIdx.x % nb;  // longest first
  const int wg = threadIdx.x >> 7;
  const int nqt = (a.sq + kBox - 1) / kBox;
  const int qt0 = first_query_tile(a, kb * kRows);
  init_barriers(sm, &sm.kv);

  if (wg == 2) {
    // ---- producer: the block's K and V once, then the query tiles
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x >= 2 * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.kv, 2 * Tile<kRows, D>::kBytes);
      load_rows(sm.k, &maps.k, &sm.kv, kb * kRows, bh);
      load_rows(sm.v, &maps.v, &sm.kv, kb * kRows, bh);
    }
    const float* lb = lse + (long long)bh * a.sq;
    const float* db = delta + (long long)bh * a.sq;
    for (int i = 0; qt0 + i < nqt; ++i) {
      const int qt = qt0 + i, s = i % kStages;
      if (i >= kStages) mbar_wait(&sm.empty[s], (i / kStages - 1) & 1);
      for (int r = lane; r < kBox; r += 32) {
        const int row = qt * kBox + r;
        sm.lse[s][r] = row < a.sq ? lb[row] * kLog2e : 0.f;
        sm.dlt[s][r] = row < a.sq ? db[row] : 0.f;
        sm.dlts[s][r] = sm.dlt[s][r] * a.scale;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * Tile<kBox, D>::kBytes);
        load_rows(sm.q[s], &maps.q, &sm.full[s], qt * kBox, bh);
        load_rows(sm.o[s], &maps.o, &sm.full[s], qt * kBox, bh);
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys [k0, k0 + 64)
  reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2,
            t4 = lane & 3;
  const int k0 = kb * kRows + wg * kWgRows;
  const int kw = k0 + (tid >> 5) * 16;    // this warp's 16 keys
  // kv_bias of this thread's two keys, in log2 units
  float kb_r[2] = {0.f, 0.f};
  if (EXTRA && a.kvb != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = kw + g + 8 * h;
      kb_r[h] = kj < a.sk ? a.kvb[bh * a.kvb_bh + kj] * kLog2e : 0.f;
    }
  }
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const int qt_wg = first_query_tile(a, k0);
  const float sl2 = a.scale * kLog2e;
  mbar_wait(&sm.kv, 0);
  uint32_t kf[kASteps<D>][4], vf[kASteps<D>][4];
  if constexpr (D == 64) {
    load_frags(kf, sm.k, wg * kWgRows);
    load_frags(vf, sm.v, wg * kWgRows);
  }
  if (wg == 1) turn_end(1);
  int held = -1;   // the stage the last dV and dK products read
  for (int i = 0; qt0 + i < nqt; ++i) {
    const int qt = qt0 + i, s = i % kStages;
    mbar_wait(&sm.full[s], (i / kStages) & 1);
    if (qt < qt_wg) {                 // before this warpgroup's first query
#pragma unroll
      for (int r = 0; r < kBox / kRound<D>; ++r) {
        turn_begin(wg);
        turn_end(wg);
      }
      wg_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      release(sm, held);
      held = -1;
      release(sm, s);
      continue;
    }
    // the tile's queries in rounds of R (at D = 128 two of 32: the
    // transposed scores and dP of all 64 beside dk and dv leave ptxas too
    // few registers to keep the products in flight)
    constexpr int R = kRound<D>, KS = R / 16;
#pragma unroll 1
    for (int r = 0; r < kBox / R; ++r) {
      const int q0 = r * R;
      float st[R / 2], dpt[R / 2];
      fence_regs(dka);
      fence_regs(dva);
      turn_begin(wg);
      wg_fence();
      first_product<E, D, R>(st, sm.k, wg * kWgRows, kf, sm.q[s], q0);
      first_product<E, D, R>(dpt, sm.v, wg * kWgRows, vf, sm.o[s], q0);
      wg_commit();
      turn_end(wg);
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(dka);
      fence_regs(dva);
      if (r == 0) {
        release(sm, held);
        held = -1;
      }
      // P^T and dS^T * scale, each pair packed into its 16-bit fragment as
      // it is made (the scores and dP die as the fragments fill)
      const bool full = all_visible(a, qt * kBox + q0, R, kw, 16);
      uint32_t pf[KS][4], sf[KS][4];
      with_tile_form<D, EXTRA>(!full, a, [&](auto mask, auto bias,
                                             auto drop) {
        constexpr bool M = decltype(mask)::value,
                       B = decltype(bias)::value, P = decltype(drop)::value;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          // the bias is read from global memory a k-step at a time
          // (hoisting all its loads and their addresses runs the D = 128
          // form out of registers)
          if constexpr (B) asm volatile("" ::: "memory");
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float pd[2], dss[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 8 * ks + 2 * jj + e;
              const int ql = q0 + (j >> 2) * 8 + 2 * t4 + (j & 1);
              if constexpr (!EXTRA && !M) {
                // no mask, bias or dropout: p, and p (dP scale - delta
                // scale)
                pd[e] = ex2(fmaf(st[j], sl2, -sm.lse[s][ql]));
                dss[e] = pd[e] * fmaf(dpt[j], a.scale, -sm.dlts[s][ql]);
              } else {
                const int h = (j >> 1) & 1;
                const int kj = kw + g + 8 * h;
                const int qi = qt * kBox + ql;
                float d;
                pd[e] = recompute<EXTRA, M, B, P>(
                    a, bh, qi, kj, st[j], sl2, kb_r[h], dpt[j],
                    sm.lse[s][ql], sm.dlt[s][ql], d);
                dss[e] = d * a.scale;
              }
            }
            pf[ks][jj] = pack2<E>(pd[0], pd[1]);
            sf[ks][jj] = pack2<E>(dss[0], dss[1]);
          }
        }
      });
      wg_fence();
      frags_by_tile<E, D, KS>(dva, pf, sm.o[s], q0);  // dv += P^T dO
      frags_by_tile<E, D, KS>(dka, sf, sm.q[s], q0);  // dk += dS^T Q
      wg_commit();
    }
    held = s;
  }
  if (wg == 0) turn_begin(0);
  wg_wait<0>();
  fence_regs(dka);
  fence_regs(dva);
  release(sm, held);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kw + g + 8 * h;
    if (row >= a.sk) continue;
    const long long off = ((long long)bh * a.sk + row) * D + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dk + off + nt * 8) =
          pack2<E>(dka[4 * nt + 2 * h], dka[4 * nt + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + nt * 8) =
          pack2<E>(dva[4 * nt + 2 * h], dva[4 * nt + 2 * h + 1]);
    }
  }
}

// ---- dk, dv at D = 256 -------------------------------------------------------
//
// At D = 256 a warpgroup's dk over 64 keys is 64 x 256 fp32, 128
// registers a thread, and dv as many: the two no longer fit one
// warpgroup under setmaxnreg's 240, so the block's two consumer
// warpgroups split the accumulators over the same 64 keys (of the forms
// considered, each warpgroup holding one accumulator over all of D: a
// split of D would compute each first product twice or trade partial
// scores, and two passes take five products and two launches). For each
// staged tile of 64 queries:
// - warpgroup V (0): S^T = K Q^T, P^T from it (the recompute of the
//   scores, the masks and biases, lse), P^T's undropped fp32 values into
//   shared memory for K, and dv += P^T dO with P^T dropped and rescaled;
// - warpgroup K (1): dP^T = V dO^T, and, once V's P^T is there, dS^T =
//   P^T (dP'^T - delta) with dP' dropped and rescaled by the same hash
//   (dS takes the undropped fp32 p, as recompute does), then dk += dS^T Q.
// Each does one first and one second product a tile, so the tensor cores
// see even halves; each holds its accumulator (128), one 64 x 64 score
// tile (32) and its 16-bit fragments (16). Only P^T crosses shared memory
// (64 x 64 x 4 bytes, one buffer), under two named barriers: V arrives at
// kPReady once it is written and waits at kPFree (from the second tile
// on, and once after the loop) before it writes the next; K waits at
// kPReady, reads it, arrives at kPFree. Both warpgroups visit the same
// tiles (the block's keys are one warpgroup's), so no tile is skipped by
// one alone. Shared memory: K and V 64 KB, a ring of two stages of Q and
// dO at 64 rows 128 KB, P^T 16 KB, lse and delta 1.5 KB: 210 KB of the
// 227. The full bias is read a score at a time from L2, as in the D-256
// forward (warpgroup V's registers are dv's). At [64, 4096, 256] causal
// (5.4e8 pairs) the four products are 8·D·pairs = 1.10 TFLOP: 1.112 ms at
// 989 TFLOP/s; at [32, 1024, 256] 0.0348 ms.

constexpr int kDkvSplitStages = 2;   // stages of the ring of query tiles
constexpr int kPReady = 3, kPFree = 4;   // named barriers (0: syncthreads)

struct DkvSplitSmem {
  Tile<kWgRows, 256> k, v;                          // the block's keys
  Tile<kBox, 256> q[kDkvSplitStages], o[kDkvSplitStages];
  float p[kWgRows * kBox];   // P^T undropped, [element][thread] of V's
  // lse in log2 units; delta, and delta times the scale
  float lse[kDkvSplitStages][kBox], dlt[kDkvSplitStages][kBox],
      dlts[kDkvSplitStages][kBox];
  uint64_t full[kDkvSplitStages], empty[kDkvSplitStages], kv;
};

// dk, dv E [BH, Sk, 256] contiguous; blocks of 64 keys, the grid's one dim
// folding bh with them (bh-major, each bh's first keys, which see the
// most queries, first)
template <typename E, int D, bool EXTRA>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_dkv_split_kernel(const __grid_constant__ Maps maps, Attn a,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, E* __restrict__ dk,
                       E* __restrict__ dv) {
  static_assert(D == 256, "the split form is written for D = 256");
  constexpr int NS = kDkvSplitStages, R = kBox, KS = R / 16;
  extern __shared__ uint8_t smem_raw[];
  DkvSplitSmem& sm = smem_as<DkvSplitSmem>(smem_raw);
  const int nb = (a.sk + kWgRows - 1) / kWgRows;
  const int bh = blockIdx.x / nb, k0 = (blockIdx.x % nb) * kWgRows;
  const int wg = threadIdx.x >> 7;
  const int nqt = (a.sq + kBox - 1) / kBox;
  const int qt0 = first_query_tile(a, k0);
  init_barriers(sm, &sm.kv);

  if (wg == 2) {
    // ---- producer: the block's K and V once, then the query tiles
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x >= 2 * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.kv, 2 * Tile<kWgRows, D>::kBytes);
      load_rows(sm.k, &maps.k, &sm.kv, k0, bh);
      load_rows(sm.v, &maps.v, &sm.kv, k0, bh);
    }
    const float* lb = lse + (long long)bh * a.sq;
    const float* db = delta + (long long)bh * a.sq;
    for (int i = 0; qt0 + i < nqt; ++i) {
      const int qt = qt0 + i, s = i % NS;
      if (i >= NS) mbar_wait(&sm.empty[s], (i / NS - 1) & 1);
      for (int r = lane; r < kBox; r += 32) {
        const int row = qt * kBox + r;
        sm.lse[s][r] = row < a.sq ? lb[row] * kLog2e : 0.f;
        sm.dlt[s][r] = row < a.sq ? db[row] : 0.f;
        sm.dlts[s][r] = sm.dlt[s][r] * a.scale;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * Tile<kBox, D>::kBytes);
        load_rows(sm.q[s], &maps.q, &sm.full[s], qt * kBox, bh);
        load_rows(sm.o[s], &maps.o, &sm.full[s], qt * kBox, bh);
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // ---- consumers: both warpgroups on keys [k0, k0 + 64); V (0) makes P^T
  // and dv, K (1) dS^T and dk
  reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2,
            t4 = lane & 3;
  const int kw = k0 + (tid >> 5) * 16;    // this warp's 16 keys
  // kv_bias of this thread's two keys, in log2 units (V's scores)
  float kb_r[2] = {0.f, 0.f};
  if (EXTRA && wg == 0 && a.kvb != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = kw + g + 8 * h;
      kb_r[h] = kj < a.sk ? a.kvb[bh * a.kvb_bh + kj] * kLog2e : 0.f;
    }
  }
  float acc[D / 2];                       // dv in V, dk in K
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const bool drop = EXTRA && a.drop_inv > 0.f;
  uint32_t none[kASteps<D>][4];           // no register-A rows at D = 256
  mbar_wait(&sm.kv, 0);
  int held = -1;   // the stage the last second product reads
  for (int i = 0; qt0 + i < nqt; ++i) {
    const int qt = qt0 + i, s = i % NS;
    mbar_wait(&sm.full[s], (i / NS) & 1);
    // V: S^T = K Q^T and then dv += P^T dO; K: dP^T = V dO^T and then
    // dk += dS^T Q
    const Tile<kWgRows, D>& rows = wg == 0 ? sm.k : sm.v;
    const Tile<kBox, D>& first = wg == 0 ? sm.q[s] : sm.o[s];
    const Tile<kBox, D>& second = wg == 0 ? sm.o[s] : sm.q[s];
    float sc[R / 2];                      // S^T in V, dP^T in K
    fence_regs(acc);
    wg_fence();
    first_product<E, D, R>(sc, rows, 0, none, first, 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(acc);
    release(sm, held);
    held = -1;
    // P^T (V) or dS^T * scale (K), each pair packed into its 16-bit
    // fragment as it is made
    uint32_t f[KS][4];
    if (wg == 0) {
      if (i > 0) bar_sync(kPFree, 256);   // K has read the last P^T
      const bool full = all_visible(a, qt * kBox, R, kw, 16);
      with_tile_form<D, EXTRA>(!full, a, [&](auto mask, auto bias,
                                             auto dropf) {
        constexpr bool M = decltype(mask)::value,
                       B = decltype(bias)::value,
                       P = decltype(dropf)::value;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          // the bias read from global memory a k-step at a time
          if constexpr (B) asm volatile("" ::: "memory");
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float pd[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 8 * ks + 2 * jj + e;
              const int ql = (j >> 2) * 8 + 2 * t4 + (j & 1);
              float p;
              if constexpr (!EXTRA && !M) {
                p = ex2(fmaf(sc[j], sl2, -sm.lse[s][ql]));
              } else {
                const int h = (j >> 1) & 1;
                const int kj = kw + g + 8 * h, qi = qt * kBox + ql;
                float x = fmaf(sc[j], sl2, kb_r[h]);
                bool live = !M || visible(a, qi, kj);
                if (B && live) x += bias_at(a, bh, qi, kj);
                if (EXTRA) live = live && x > kNegInf * 0.5f;
                p = live ? ex2(x - sm.lse[s][ql]) : 0.f;
              }
              sm.p[j * 128 + tid] = p;
              pd[e] = p;
              if (P && drop) {
                const int kj = kw + g + 8 * ((j >> 1) & 1);
                pd[e] = keep(a, bh, qt * kBox + ql, kj) ? p * a.drop_inv
                                                        : 0.f;
              }
            }
            f[ks][jj] = pack2<E>(pd[0], pd[1]);
          }
        }
      });
      bar_arrive(kPReady, 256);
    } else {
      bar_sync(kPReady, 256);             // V's P^T of this tile is there
      auto make_ds = [&](auto dropf) {
        constexpr bool P = decltype(dropf)::value;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float x[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 8 * ks + 2 * jj + e;
              const int ql = (j >> 2) * 8 + 2 * t4 + (j & 1);
              float dp = sc[j];
              if constexpr (P) {
                const int kj = kw + g + 8 * ((j >> 1) & 1);
                dp = keep(a, bh, qt * kBox + ql, kj) ? dp * a.drop_inv
                                                     : 0.f;
              }
              // dS scale = p (dP' scale - delta scale)
              x[e] = sm.p[j * 128 + tid] *
                     fmaf(dp, a.scale, -sm.dlts[s][ql]);
            }
            f[ks][jj] = pack2<E>(x[0], x[1]);
          }
        }
      };
      if (drop) make_ds(std::true_type{});
      else make_ds(std::false_type{});
      bar_arrive(kPFree, 256);
    }
    wg_fence();
    frags_by_tile<E, D, KS>(acc, f, second, 0);
    wg_commit();
    held = s;
  }
  // K's last arrival at kPFree, matched
  if (wg == 0 && qt0 < nqt) bar_sync(kPFree, 256);
  wg_wait<0>();
  fence_regs(acc);
  release(sm, held);
  E* out = wg == 0 ? dv : dk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kw + g + 8 * h;
    if (row >= a.sk) continue;
    const long long off = ((long long)bh * a.sk + row) * D + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(out + off + nt * 8) =
          pack2<E>(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
    }
  }
}

// ---- host: launches ----------------------------------------------------------

// dq and dk/dv take (maps, a, lse, delta, one E output, the other
// output); a launch above 48 KB of shared memory must be allowed first
template <typename E, typename O2>
cudaError_t launch(void (*kernel)(Maps, Attn, const float*, const float*,
                                  E*, O2),
                   int bytes, dim3 grid, cudaStream_t st, const Maps& maps,
                   const Attn& a, const float* lse, const float* delta,
                   E* o1, O2 o2) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBlockThreads, bytes, st>>>(maps, a, lse, delta, o1, o2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace apex_port

// Both entry points: q, k, v, dout [bh, s, d] of dtype (bf16 or fp16)
// whose tensor maps the wrapper describes in tma (4 x 8 long longs, in that
// order: dims d, s, bh; row and bh strides in bytes, multiples of 16; the
// box 64, 64, 1), every base 16-byte aligned; lse, delta fp32 [bh, sq]
// contiguous; kvb null or fp32 [1|bh, sk] with bh stride kvb_bh (0 when
// shared), its keys contiguous; bias null or fp32 [1|bh, sq, sk]
// contiguous with bh stride bias_bh (0 when shared); dropout when drop_inv
// = 1 / (1 - rate) > 0, keeping an element whose hash under seed is >=
// drop_thresh; `blocks` the grid's row blocks of 128 a bh (queries for dq,
// keys for dk/dv).

// dq [bh, sq, d] of q's dtype, contiguous; ds null or fp32 [bh, sq, sk]
// contiguous (the per-bh bias gradient; taken only with a bias or kv_bias
// or dropout). d may also be 256, its maps' boxes then 64 x 32 x 1.
extern "C" int apex_flash_bwd_dq(int dtype, const void* q, const void* k,
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
  if (bad(bh, sq, sk, d, blocks, true) ||
      blocks != (sq + kRows - 1) / kRows ||
      (dtype != kBF16 && dtype != kF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps maps;
  Attn a;
  if (!prepare(&maps, &a, dtype == kF16, q, k, v, dout, tma, kvb, kvb_bh,
               bias, bias_bh, seed, drop_thresh, drop_inv, bh, sq, sk, d,
               q_start, k_start, causal, scale,
               d == 256 ? kDqKeys<256> : kBox)) {
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
  cudaError_t err = cudaSuccess;
  with_elem(dtype, [&](auto et) {
    using E = typename decltype(et)::type;
    E* out = static_cast<E*>(dq);
    with_form<true>(d, a, [&](auto dd, auto ex) {
      constexpr int D = decltype(dd)::value;
      err = launch(flash_dq_kernel<E, D, decltype(ex)::value>,
                   smem_bytes<DqSmem<D>>(), grid, st, maps, a, lp, dl, out,
                   dsp);
    });
  });
  return static_cast<int>(err);
}

// dk, dv [bh, sk, d] of k's dtype, contiguous. d may also be 256, whose
// blocks are 64 keys (`blocks` = ceil(sk / 64)).
extern "C" int apex_flash_bwd_dkv(int dtype, const void* q, const void* k,
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
  const int rows = d == 256 ? kWgRows : kRows;
  if (bad(bh, sq, sk, d, blocks, true) ||
      blocks != (sk + rows - 1) / rows ||
      (dtype != kBF16 && dtype != kF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps maps;
  Attn a;
  if (!prepare(&maps, &a, dtype == kF16, q, k, v, dout, tma, kvb, kvb_bh,
               bias, bias_bh, seed, drop_thresh, drop_inv, bh, sq, sk, d,
               q_start, k_start, causal, scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks * bh);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaError_t err = cudaSuccess;
  with_elem(dtype, [&](auto et) {
    using E = typename decltype(et)::type;
    E* kp = static_cast<E*>(dk);
    E* vp = static_cast<E*>(dv);
    with_form<true>(d, a, [&](auto dd, auto ex) {
      constexpr int D = decltype(dd)::value;
      constexpr bool X = decltype(ex)::value;
      if constexpr (D == 256) {
        err = launch(flash_dkv_split_kernel<E, D, X>,
                     smem_bytes<DkvSplitSmem>(), grid, st, maps, a, lp, dl,
                     kp, vp);
      } else {
        err = launch(flash_dkv_kernel<E, D, X>, smem_bytes<DkvSmem<D>>(),
                     grid, st, maps, a, lp, dl, kp, vp);
      }
    });
  });
  return static_cast<int>(err);
}
