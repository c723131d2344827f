// Flash attention's forward over [BH, S, D] bf16 or fp16 (D 64, 128 or
// 256) for Hopper:
// the output and its per-row logsumexp. The semantics it keeps from the
// Pallas kernel are csrc/flash_common.cuh; the Hopper instructions it is
// built from are csrc/hopper.cuh, and the tiles, ring, products and turns
// it shares with the backward (csrc/flash_bwd.cu) csrc/flash_tiles.cuh.
//
// Replaces the Pallas kernel of
// apex_tpu/contrib/multihead_attn/flash_attention.py: _flash_fwd ->
// _fwd_kernel (:181-245), with every input it takes: the full additive
// bias [1|BH, Sq, Sk] fp32, the per-key bias kv_bias [1|BH, Sk] fp32
// (key-padding masks) and dropout on the probabilities.
//
// Bound on this card. At lm_bench's shape (BH = 128, S = 4095, D = 64,
// causal: 1.07e9 live (query, key) pairs) QK^T and PV are 4·D·pairs = 275
// GFLOP against ~4 · 67 MB of q, k, v and o: ~1000 operations per byte,
// above the H100's 295, so the bf16 tensor cores' 989 TFLOP/s bound it
// (0.278 ms); at the wide LM's [384, 2048, 128] 0.417 ms. The forward
// also takes one exp2 a live pair on the special-function units (16 a
// clock an SM: ~0.3 ms at the LM shape), a floor close to the first. At
// the ViT's [1536, 197, 64] the bound is bytes. At D = 256 (lm_bench's
// LM at --dim 2048 --heads 8, Gemma 2B's 8 heads of 256: [64, 4096, 256]
// causal, 5.4e8 pairs) the products are 550 GFLOP: 0.556 ms; at [32, 1024,
// 256] 0.0174 ms.
//
// What the design does about the limits of the mma.sync kernel it
// replaces (FlashAttention-3's forward, Shah et al. 2024, within what the
// backward's redesign found on this card):
// 1. Products on the Ampere instruction: S = QK^T and O += PV are
//    warpgroup wgmma.mma_async products (m64nNk16, bf16 in, fp32
//    accumulators).
// 2. The staged tile re-read by every warp: the tensor cores read K and V
//    once per warpgroup from 128-byte-swizzled shared memory, K K-major
//    and V MN-major (wgmma's transpose bit) as TMA wrote them. At D = 64
//    the warpgroup's queries enter QK^T from registers, loaded once; at
//    D = 128 from shared memory (their 64 registers have no room beside S
//    and O). P never leaves registers: the scores' accumulator layout is
//    wgmma's register-A fragment, so PV takes P rounded to bf16 as it is.
// 3. One tile in flight: Q arrives once by TMA and the key tiles through a
//    ring of kFwdStages buffers that a producer warp keeps full, full and
//    empty mbarriers handing them over. TMA's zero fill past the tensor's
//    end stands for the ragged tail (S = 4095, 197).
// 4. Small blocks: a block owns 128 query rows as two consumer warpgroups
//    of 64 sharing each staged tile of keys, the producer warpgroup giving
//    them its registers (setmaxnreg). A warpgroup's turn (named barriers)
//    covers the issue of QK^T and the wait for S, so that the other's
//    products run while it works out its softmax.
// The softmax works in log2 units. A tile with no mask, bias or dropout
// (all but the causal diagonal and the ragged edges) costs a max, one
// fused multiply-add, one exp2 and one add an element: the row max is
// taken of the raw scores and scaled once, each row's max and sum run as
// several partial chains, and each thread keeps its own share of the row
// sums, added across the row's four lanes once at the end. Other tiles
// take the form they need (fwd_tile_form). Three kinds of kernel per head
// dim (Kind): plain; kv_bias and dropout; a full bias (with or without the
// others). The first two stage 128 keys a tile; the full bias 64, its
// values read into registers before QK^T from L2, where the producer warp
// prefetched the tile's rows as it loaded K and V (without the prefetch
// the per-bh bias form was latency-bound on its 238 MB at the ViT shape;
// 128 keys with those registers spilled). The other designs tried on the
// H100 (PERF.md) were slower: 64-key tiles in the plain form, FA3's intra-warpgroup overlap
// (tile kt's PV issued with kt + 1's QK^T), a deeper ring, a turn that
// ends before the wait for S.
// At D = 256 the same body takes 64-key tiles in every kind: the
// queries' 64 KB and a ring of two stages of 32 + 32 KB fill 192 KB of
// the 227 a block may have (128 keys would leave room for one stage), and
// O's 64 x 256 accumulator is 128 fp32 registers a thread beside S's 32
// and P's 16, under setmaxnreg's 240. PV is one m64n256k16 product a
// k-step, V MN-major across its four 64-column tiles; QK^T reads both
// operands from shared memory, as at D = 128. The full bias is read from
// L2 a score at a time in the softmax instead of into 32 registers ahead
// of QK^T (the registers are O's).
// Causal work is skipped a warpgroup at a time: a block visits the key
// tiles its 128 rows see, and a warpgroup waits out the tiles its own 64
// do not. Each block owns its output rows: o and lse repeat bit for bit.
//
// The element type E (bf16 or fp16) sets the products' input type (wgmma's
// .bf16 or .f16), the tensor maps' and the rounding of P (and dS) into
// their register fragments and of the outputs; the rest is one body, and
// the bf16 forms compute what they did before fp16 was added, bit for bit.
// The grid is one dim: bh-major, the row blocks of each bh inside it, so
// BH may pass 65535.
// The host builds the tensor maps of q, k and v (dims, strides and boxes
// from the Python wrapper, ops/flash_attn.py tma_layout) and passes them as
// __grid_constant__ parameters.

#include "flash_tiles.cuh"

namespace apex_port {
namespace {

// keys of a staged tile: 64 with a full bias, whose scores carry the bias
// read ahead into registers beside them, and at D = 256 (shared memory);
// else 128
template <int D, int KIND>
constexpr int kBlockN = KIND == kBiasKind || D == 256 ? 64 : 128;

// whether the full bias is read into registers ahead of QK^T (load_bias):
// not at D = 256, whose O takes those registers
template <int D>
constexpr bool kBiasAhead = D < 256;

// tiles of the copy ring: as many as 96 KB of K and V hold (three of 128
// keys at D = 64), at least two
template <int D, int BN>
constexpr int kFwdStages = 96 * 1024 / (2 * BN * D * 2) > 2
                               ? 96 * 1024 / (2 * BN * D * 2) : 2;

template <int D, int BN>
struct FwdSmem {
  static constexpr int kS = kFwdStages<D, BN>;
  Tile<kRows, D> q;                          // the block's queries
  Tile<BN, D> k[kS], v[kS];                  // the ring of key tiles
  float kvb[kS][BN];                         // their kv_bias, log2 units
  uint64_t full[kS], empty[kS], qbar;
};

// the full bias of this thread's (query, key) elements of the tile from
// k0, in the accumulator layout, in log2 units (0 past Sq or Sk, and
// without a bias): read before the scores' product, so that its latency
// (an L2 hit: the producer prefetched the tile's rows) hides under that
// product
template <int BN>
__device__ __forceinline__ void load_bias(const Attn& a, int bh, int qw,
                                          int k0, float (&bv)[BN / 2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int qi = qw + g + 8 * ((i >> 1) & 1);
    const int kj = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
    bv[i] = a.bias != nullptr && qi < a.sq && kj < a.sk
                ? a.bias[bh * a.bias_bh + (long long)qi * a.sk + kj] * kLog2e
                : 0.f;
  }
}

// o E [BH, Sq, D] and lse fp32 [BH, Sq], contiguous; the grid's one dim
// folds bh with the row blocks (bh-major, each bh's longest rows first)
template <typename E, int D, int KIND>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_fwd_kernel(const __grid_constant__ Maps maps, Attn a,
                 E* __restrict__ o, float* __restrict__ lse) {
  constexpr bool EXTRA = KIND != kPlainKind, BIAS = KIND == kBiasKind;
  constexpr int BN = kBlockN<D, KIND>, NS = kFwdStages<D, BN>;
  constexpr bool AHEAD = BIAS && kBiasAhead<D>;
  extern __shared__ uint8_t smem_raw[];
  FwdSmem<D, BN>& sm = smem_as<FwdSmem<D, BN>>(smem_raw);
  const int nb = (a.sq + kRows - 1) / kRows;
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * kRows;    // longest first
  const int wg = threadIdx.x >> 7;
  const int nkt = key_tiles<BN>(a, q0, kRows);
  init_barriers(sm, &sm.qbar);

  if (wg == 2) {
    // ---- producer: the block's Q once, then the key tiles
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x >= 2 * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.qbar, Tile<kRows, D>::kBytes);
      load_rows(sm.q, &maps.q, &sm.qbar, q0, bh);
    }
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % NS;
      if (kt >= NS) mbar_wait(&sm.empty[s], (kt / NS - 1) & 1);
      // the copies first: the kv_bias staged beside them waits on its own
      // loads, and every lane arrives once its stores are done
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 2 * Tile<BN, D>::kBytes);
        load_rows(sm.k[s], &maps.k, &sm.full[s], kt * BN, bh);
        load_rows(sm.v[s], &maps.v, &sm.full[s], kt * BN, bh);
      }
      if (EXTRA) {
        if (BIAS) prefetch_bias<BN>(a, bh, q0, kt * BN, lane);
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

  // ---- consumers: warpgroup wg owns queries [r0, r0 + 64)
  reg_alloc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2,
            t4 = lane & 3;
  const int r0 = q0 + wg * kWgRows;
  const int qw = r0 + (tid >> 5) * 16;    // this warp's 16 rows
  const int nkt_wg = key_tiles<BN>(a, r0, kWgRows);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(&sm.qbar, 0);
  uint32_t qf[kASteps<D>][4];
  if constexpr (D == 64) load_frags(qf, sm.q, wg * kWgRows);
  if (wg == 1) turn_end(1);
  int held = -1;   // the stage the last PV product reads
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % NS;
    mbar_wait(&sm.full[s], (kt / NS) & 1);
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
    float sc[BN / 2], bv[AHEAD ? BN / 2 : 1];
    if constexpr (AHEAD) load_bias<BN>(a, bh, qw, kt * BN, bv);
    fence_regs(acc);
    turn_begin(wg);
    wg_fence();
    first_product<E, D, BN>(sc, sm.q, wg * kWgRows, qf, sm.k[s], 0);
    wg_commit();
    wg_wait<0>();
    turn_end(wg);   // after S: the other's products run under this softmax
    fence_regs(sc);
    fence_regs(acc);
    release(sm, held);
    held = -1;
    const bool plain = all_visible(a, qw, 16, kt * BN, BN) && a.scale > 0.f;
    float alpha[2];
    uint32_t pf[BN / 16][4];
    fwd_tile_form<D, KIND>(!plain, a, [&](auto mask, auto bias,
                                          auto drop) {
      softmax_tile<E, BN, EXTRA, decltype(mask)::value,
                   decltype(bias)::value, decltype(drop)::value>(
          a, bh, qw, kt * BN, sc, sm.kvb[s], bv, m, l, alpha, pf);
    });
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    wg_fence();
    frags_by_tile<E, D, BN / 16>(acc, pf, sm.v[s], 0);   // O += P V
    wg_commit();
    held = s;
  }
  if (wg == 0) turn_begin(0);
  wg_wait<0>();
  fence_regs(acc);
  release(sm, held);
  // the rows' sums over their four lanes; o = acc / l, lse = m ln 2 + ln l
  // (o = 0 and lse = kNegInf for a row that saw nothing)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  E* ob = o + (long long)bh * a.sq * D;
  float* lb = lse + (long long)bh * a.sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + g + 8 * h;
    if (row >= a.sq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 1.f;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(ob + (long long)row * D + nt * 8 +
                                   2 * t4) =
          pack2<E>(acc[4 * nt + 2 * h] * inv, acc[4 * nt + 2 * h + 1] * inv);
    }
    if (t4 == 0) lb[row] = l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : kNegInf;
  }
}

}  // namespace
}  // namespace apex_port

// q, k, v [bh, s, d] (d 64, 128 or 256) of dtype (bf16 or fp16) whose
// tensor maps the wrapper describes in tma (3 x 8 long longs, in that
// order: dims d, s, bh; row and bh strides in bytes, multiples of 16; the
// box 64, 64, 1), every base
// 16-byte aligned; `blocks` the grid's blocks of 128 query rows a bh; kvb
// null or fp32 [1|bh, sk] with bh stride kvb_bh (0 when shared), its keys
// contiguous; bias null or fp32 [1|bh, sq, sk] contiguous with bh stride
// bias_bh (0 when shared); dropout when drop_inv = 1 / (1 - rate) > 0,
// keeping an element whose hash under seed is >= drop_thresh. o [bh, sq,
// d] of q's dtype and lse fp32 [bh, sq], contiguous.
extern "C" int apex_flash_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* lse,
                              const long long* tma, int blocks,
                              const void* kvb, long long kvb_bh,
                              const void* bias, long long bias_bh,
                              unsigned seed, unsigned drop_thresh,
                              float drop_inv, int bh, int sq, int sk, int d,
                              int q_start, int k_start, int causal,
                              float scale, void* stream) {
  using namespace apex_port;
  if (bad(bh, sq, sk, d, blocks, true) ||
      blocks != (sq + kRows - 1) / kRows ||
      (dtype != kBF16 && dtype != kF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps maps{};
  Attn a;
  if (!prepare(&maps, &a, dtype == kF16, q, k, v, nullptr, tma, kvb,
               kvb_bh, bias, bias_bh, seed, drop_thresh, drop_inv, bh, sq,
               sk, d, q_start, k_start, causal, scale)) {
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
      auto kernel = flash_fwd_kernel<E, D, K>;
      const int bytes = smem_bytes<FwdSmem<D, kBlockN<D, K>>>();
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return;
      kernel<<<grid, kBlockThreads, bytes, st>>>(maps, a, op, lp);
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
    if (d == 64) by_kind(integral_constant<int, 64>{});
    else if (d == 128) by_kind(integral_constant<int, 128>{});
    else by_kind(integral_constant<int, 256>{});
  });
  return static_cast<int>(err);
}
