// Flash attention's shared-bias gradient over [BH, S, D] at every head dim
// from 1 to 512: dbias = dS summed over bh, for a bias [1, Sq, Sk] shared
// over bh, on the tensor cores in both dtype families: bf16/fp16 on wgmma
// (flash_tc_dbias_kernel) and fp32 with S in 3xTF32 and dP in fp64
// (flash_f32_dbias_kernel). The semantics they keep from the Pallas
// kernels are csrc/flash_common.cuh's; the Hopper instructions are
// csrc/hopper.cuh and csrc/flash_tiles.cuh's, the 3xTF32 products
// csrc/flash_f32.cuh's.
//
// Replaces the Pallas kernel of
// apex_tpu/contrib/multihead_attn/flash_attention.py: _bwd_pallas ->
// _bwd_dbias_kernel (:427), with every input it takes: the bias itself,
// kv_bias [1|BH, Sk] fp32, causal masking by absolute positions, dropout.
//
// Bound on this card. At [32, 1024, 256] causal the recompute's two
// products (S = Q K^T, dP = dO V^T) over the 1.68e7 live (query, key)
// pairs are 4·D·pairs = 17.2 GFLOP: 0.0174 ms in bf16 at 989 TFLOP/s,
// under the bytes (q, k, v, dO read once, the bias read and dbias written:
// 0.0226 ms); in fp32 0.104 ms at 3xTF32's 165 TFLOP/s, operations.
//
// Design. dq, dk and dv keep an accumulator as wide as D; dbias keeps only
// score tiles, S, dP and the running sum of dS, each 64 x 64 whatever D
// is, and both products contract over D, so every operand is K-major:
// 1. A block owns a (query tile, key tile) and a run of bh (the grid's z;
//    the runs fill the card when there are few tiles, S = 197 has 4 x 4).
//    Per bh it streams D through shared memory in chunks (64 columns in
//    bf16/fp16, one 128-byte swizzled row of TMA; 32 in fp32), adding
//    each chunk's products into S and dP, so its registers do not grow
//    with D and no form needs a padded copy or a split of D: TMA (or the
//    zero-filling cp.async) gives zeros past the tensors' width, which add
//    nothing to S or dP.
// 2. After a bh's last chunk the block forms dS = p (dP' - delta) as the
//    backward's recompute does (_recompute_p_ds, :309-346: the scale, the
//    bias, kv_bias, the causal mask, lse and delta, dropout by the
//    coordinate hash with 1 / (1 - rate)) and adds it to the sum held in
//    registers, in bh order; the bias tile, the same for every bh, is read
//    once a block (into registers in bf16/fp16, into shared memory in
//    fp32, where the products leave no registers for it). A second pass
//    (dbias_sum_kernel) adds the runs' partial tiles in run order. No
//    float atomics: repeated runs are bitwise equal. No [BH, Sq, Sk]
//    tensor is made: the only scratch is [runs, Sq, Sk].
// 3. bf16/fp16: one producer warp keeps a ring of (Q, dO, K, V) chunk
//    stages in flight by TMA (kTcDbStages of 32 KB), one consumer
//    warpgroup (kTcDbW of them sharing K and V) issues m64n64k16 products
//    for S and dP from shared memory and releases a stage once the next
//    chunk's products are issued. S, dP, the sum and the bias are 32 fp32
//    registers each; setmaxnreg gives the consumers 232 registers and two
//    blocks an SM, so one block's dS overlaps the other's products.
// 4. fp32: four warps of 16 query rows by 64 keys, two blocks an SM.
//    Each bh takes two passes over D in chunks of 32 columns, Q and K's
//    for S, then dO and V's for dP (18 KB a stage, rows padded to 36
//    floats for conflict-free fragment loads), by 16-byte cp.async into a
//    ring of kF32DbStages; the passes' working registers are not live at
//    once. S is mma.sync.m16n8k8 in 3xTF32 (flash_f32.cu's scheme: each
//    pair of k-steps into a fresh accumulator, added in fp32; rows kept
//    raw and split as read). dP is fp32 FMAs on the CUDA cores, one chain a
//    (query, key) in ascending column order (chunk_dp), so it rounds as
//    the plain version's product does. Where one key takes a row's whole
//    softmax (p = 1: the first causal row, a row all but one key of which
//    is masked) dS = p (dP - delta) is dP - delta, two equal sums of D
//    products whose difference is their rounding, and the plain version's
//    dS there is that rounding: dP in 3xTF32 (~2^-21 of |dP| off) and dP
//    exact in fp64 on the tensor cores (mma.sync.m8n8k4.f64) both missed
//    fp32's rule there by 3.4x at [32, 1024, 256] causal, summed over bh.
// 5. A tile that the causal mask kills entirely writes zeros (the output
//    comes from torch.empty) and loads nothing.

#include "flash_f32.cuh"
#include "flash_tiles.cuh"

namespace apex_port {
namespace {

constexpr int kDbRows = 64;     // query rows of a consumer warpgroup (bf16,
                                // fp16) or of a block (fp32)
constexpr int kDbKeys = 64;     // keys of a block's tile

// ---- what both kernels share -------------------------------------------

// whether any query of [q0, q0 + rows) sees a key of [k0, ...): the causal
// mask kills the tile otherwise
__device__ __forceinline__ bool tile_live(const Attn& a, int q0, int rows,
                                          int k0) {
  const int last = min(q0 + rows, a.sq) - 1;
  return !a.causal || a.q_start + last >= a.k_start + k0;
}

// the bias of (query qi, key kj) in log2 units, 0 past Sq or Sk
__device__ __forceinline__ float bias2(const Attn& a, int qi, int kj) {
  return qi < a.sq && kj < a.sk
             ? a.bias[(long long)qi * a.sk + kj] * kLog2e : 0.f;
}

// this thread's 32 elements of a 16 x 64 tile of the warp's rows from qw
// and the keys from k0 (the accumulator layout of hopper.cuh and of
// mma.sync's m16n8 tiles: element i is row qw + g + 8 ((i >> 1) & 1),
// column 8 (i >> 2) + 2 t4 + (i & 1)): from the bias itself in log2 units
// (tile null) or from a staged tile whose row qw is at tile, kDbBiasLd
// floats a row
constexpr int kDbBiasLd = 64 + 4;

__device__ __forceinline__ void load_elems(float (&e)[32], const Attn& a,
                                           int qw, int k0,
                                           const float* tile = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = g + 8 * ((i >> 1) & 1);
    const int kl = (i >> 2) * 8 + 2 * t4 + (i & 1);
    e[i] = tile != nullptr ? tile[r * kDbBiasLd + kl]
                           : bias2(a, qw + r, k0 + kl);
  }
}

// lse (in log2 units) and delta of this thread's two rows of bh
__device__ __forceinline__ void row_stats(float (&lse2)[2], float (&dlt)[2],
                                          const Attn& a, const float* lse,
                                          const float* delta, int bh,
                                          int qw) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + g + 8 * h;
    const long long i = (long long)bh * a.sq + row;
    lse2[h] = row < a.sq ? lse[i] * kLog2e : 0.f;
    dlt[h] = row < a.sq ? delta[i] : 0.f;
  }
}

// dS = p (dP' - delta) of this thread's 32 (query, key) pairs of bh, added
// to acc (the recompute of _recompute_p_ds, :309-346, with the undropped p
// as the bias gradient takes it): s is q·k and dp dO·v, kvb the tile's
// kv_bias (fp32, as given), bv the bias tile (load_elems), lse2 and dlt the
// rows' (row_stats). MASK: the warp's 16 rows do not all see all 64 keys;
// DROP: dropout is given (both warp-uniform).
template <bool MASK, bool DROP>
__device__ __forceinline__ void add_ds(float (&acc)[32], const float (&s)[32],
                                       const float (&dp)[32], const Attn& a,
                                       int bh, int qw, int k0,
                                       const float* kvb, const float (&bv)[32],
                                       const float (&lse2)[2],
                                       const float (&dlt)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const int qi = qw + g + 8 * h;
    const int kl = (i >> 2) * 8 + 2 * t4 + (i & 1);
    const float sc = fmaf(s[i], sl2, kvb[kl] * kLog2e) + bv[i];
    const bool live = (!MASK || visible(a, qi, k0 + kl)) &&
                      sc > kNegInf * 0.5f;
    const float p = live ? ex2(sc - lse2[h]) : 0.f;
    float d = dp[i];
    if (DROP) d = keep(a, bh, qi, k0 + kl) ? d * a.drop_inv : 0.f;
    acc[i] += p * (d - dlt[h]);
  }
}

// calls f(MASK, DROP) as compile-time constants
template <typename F>
__device__ __forceinline__ void with_ds_form(bool masked, bool drop, F&& f) {
  using T = std::true_type;
  using N = std::false_type;
  if (masked) {
    if (drop) f(T{}, T{});
    else f(T{}, N{});
  } else {
    if (drop) f(N{}, T{});
    else f(N{}, N{});
  }
}

// this thread's 32 sums into the block's tile of out [Sq][Sk] (fp32), the
// edges past Sq and Sk left out
__device__ __forceinline__ void store_tile(float* out, const float (&acc)[32],
                                           const Attn& a, int qw, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int qi = qw + g + 8 * ((i >> 1) & 1);
    const int kj = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
    if (qi < a.sq && kj < a.sk) out[(long long)qi * a.sk + kj] = acc[i];
  }
}

// ---- bf16/fp16 on wgmma ------------------------------------------------

constexpr int kTcDbW = 1;        // consumer warpgroups (64 queries each,
                                 // sharing the block's 64 keys)
constexpr int kTcDbStages = 3;   // the ring's chunk stages
constexpr int kTcDbChunk = 64;   // columns of D a stage holds (128 bytes)
// A block is W consumer warpgroups and a producer warpgroup, one warp of
// which issues the copies; setmaxnreg hands the producer's registers to
// the consumers: with one consumer warpgroup two blocks fill an SM's
// 65536 (2 x 128 x (232 + 24)), with two one block does (128 x (2 x 240 +
// 24) <= 65536)
template <int W> constexpr int kTcDbRegs = W == 1 ? 232 : 240;

template <int W, int NS>
struct TcDbSmem {
  Tile<kDbRows * W, kTcDbChunk> q[NS], o[NS];   // the block's queries, dO
  Tile<kDbKeys, kTcDbChunk> k[NS], v[NS];       // the block's keys
  float kvb[NS][kDbKeys];          // the tile's kv_bias at a bh's last chunk
  uint64_t full[NS], empty[NS];
  static constexpr uint32_t kStageBytes =
      2 * Tile<kDbRows * W, kTcDbChunk>::kBytes +
      2 * Tile<kDbKeys, kTcDbChunk>::kBytes;
};

// block (query tile x of 64 W rows, key tile y, run z) sums dS over bh in
// [z per, min(BH, (z + 1) per)) in bh order into part [z][Sq][Sk] fp32;
// q, k, v and dO by their maps, nc chunks of 64 columns a row
template <typename E, int W, int NS>
__global__ void __launch_bounds__(128 * (W + 1), W == 1 ? 2 : 1)
flash_tc_dbias_kernel(const __grid_constant__ Maps maps, Attn a,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int nbh, int per,
                      int nc, float* __restrict__ part) {
  using S = TcDbSmem<W, NS>;
  extern __shared__ uint8_t smem_raw[];
  S& sm = smem_as<S>(smem_raw);
  const int q0 = blockIdx.x * kDbRows * W, k0 = blockIdx.y * kDbKeys;
  const int bh0 = blockIdx.z * per, bh1 = min(nbh, bh0 + per);
  const bool live = tile_live(a, q0, kDbRows * W, k0);
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&sm.full[s], kFullArrivals);
      mbar_init(&sm.empty[s], 4 * W);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == W) {
    // ---- producer: every bh's chunks of Q, dO, K and V, and at a bh's
    // last chunk the tile's kv_bias
    reg_dealloc<kProducerRegs>();
    if (!live || threadIdx.x >= 128 * W + 32) return;
    const int lane = threadIdx.x & 31;
    int it = 0;
    for (int bh = bh0; bh < bh1; ++bh) {
      for (int c = 0; c < nc; ++c, ++it) {
        const int s = it % NS;
        if (it >= NS) mbar_wait(&sm.empty[s], (it / NS - 1) & 1);
        if (c == nc - 1) {
          for (int r = lane; r < kDbKeys; r += 32) {
            const int kj = k0 + r;
            sm.kvb[s][r] = a.kvb != nullptr && kj < a.sk
                               ? a.kvb[bh * a.kvb_bh + kj] : 0.f;
          }
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[s], S::kStageBytes);
          const int col = c * kTcDbChunk;
#pragma unroll
          for (int h = 0; h < W; ++h) {
            tma_load_3d(&sm.q[s].x[0][h * kDbRows * kBox], &maps.q,
                        &sm.full[s], col, q0 + h * kDbRows, bh);
            tma_load_3d(&sm.o[s].x[0][h * kDbRows * kBox], &maps.o,
                        &sm.full[s], col, q0 + h * kDbRows, bh);
          }
          tma_load_3d(&sm.k[s].x[0][0], &maps.k, &sm.full[s], col, k0, bh);
          tma_load_3d(&sm.v[s].x[0][0], &maps.v, &sm.full[s], col, k0, bh);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg on queries [q0 + 64 wg, q0 + 64 wg + 64),
  // its warp on 16 of them
  reg_alloc<kTcDbRegs<W>>();
  const int tid = threadIdx.x & 127;
  const int qw = q0 + wg * kDbRows + (tid >> 5) * 16;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (live) {
    float bv[32];
    load_elems(bv, a, qw, k0);
    const bool masked = !all_visible(a, qw, 16, k0, kDbKeys);
    const bool drop = a.drop_inv > 0.f;
    int it = 0;
    for (int bh = bh0; bh < bh1; ++bh) {
      float lse2[2], dlt[2];
      row_stats(lse2, dlt, a, lse, delta, bh, qw);
      float s[32], dp[32];
      int held = -1;   // the stage the products in flight read
      for (int c = 0; c < nc; ++c, ++it) {
        const int st = it % NS;
        mbar_wait(&sm.full[st], (it / NS) & 1);
        const uint32_t pq = smem_u32(&sm.q[st].x[0][wg * kDbRows * kBox]);
        const uint32_t po = smem_u32(&sm.o[st].x[0][wg * kDbRows * kBox]);
        const uint32_t pk = smem_u32(&sm.k[st].x[0][0]);
        const uint32_t pv = smem_u32(&sm.v[st].x[0][0]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kTcDbChunk / 16; ++kk) {
          mma_ss_n64<E>(s, sw128_desc(pq + kk * 32, 16, kSbo),
                        sw128_desc(pk + kk * 32, 16, kSbo), c > 0 || kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < kTcDbChunk / 16; ++kk) {
          mma_ss_n64<E>(dp, sw128_desc(po + kk * 32, 16, kSbo),
                        sw128_desc(pv + kk * 32, 16, kSbo), c > 0 || kk > 0);
        }
        wg_commit();
        if (held >= 0) {
          // the last chunk's products are done with their stage
          wg_wait<1>();
          release(sm, held);
        }
        held = st;
      }
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      with_ds_form(masked, drop, [&](auto mask, auto dr) {
        add_ds<decltype(mask)::value, decltype(dr)::value>(
            acc, s, dp, a, bh, qw, k0, sm.kvb[held], bv, lse2, dlt);
      });
      release(sm, held);
    }
  }
  store_tile(part + (long long)blockIdx.z * a.sq * a.sk, acc, a, qw, k0);
}

// ---- fp32: S in 3xTF32, dP by fp32 FMAs ---------------------------------

constexpr int kF32DbWarps = 4;    // warps of 16 query rows a block
constexpr int kF32DbStages = 2;   // the ring's chunk stages
constexpr int kF32DbBlocks = 2;   // blocks an SM (registers capped for it)
constexpr int kF32DbDpUnroll = 1; // dP's column quads unrolled (each one's
                                  // 48 registers of loads held at once)
constexpr int kF32DbChunk = 32;   // columns of D a stage holds
constexpr int kF32DbLd = kF32DbChunk + 4;   // row stride (floats): the
                                             // eight rows an ldmatrix reads
                                             // fall in distinct banks

template <int NS, int WR>
struct F32DbSmem {
  // a stage: one chunk of the block's 16 WR query rows and 64 keys, raw
  // fp32 (split as read): Q and K in a bh's first pass, dO and V in its
  // second
  float x[NS][16 * WR][kF32DbLd], y[NS][kDbKeys][kF32DbLd];
  float kvb[NS][kDbKeys];          // the tile's kv_bias at a bh's last chunk
  float bias[16 * WR][kDbBiasLd];  // the block's bias tile, log2 units:
                                   // read at each bh's dS, where the
                                   // products' registers are free
  float dp[WR][16][kDbBiasLd];     // each warp's dP, from chunk_dp's
                                   // layout to add_ds's
};

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// chunk c of bh's pass ph into stage s: rows of Q (ph 0) or dO (ph 1) from
// q0 and of K (ph 0) or V (ph 1) from k0, columns [32 c, 32 c + 32),
// zeros past the rows or the width dw (a multiple of 4); at the second
// pass's last chunk the tile's kv_bias (zeros without one); all 32 WR
// threads issue, the caller commits
template <int NS, int WR>
__device__ __forceinline__ void stage_chunk(F32DbSmem<NS, WR>& sm, int s,
                                            const Attn& a, const float* dout,
                                            long long do_bh, long long do_s,
                                            int bh, int ph, int c, int q0,
                                            int k0, int dw, bool last) {
  constexpr int CH = kF32DbChunk / 4;      // 16-byte pieces a row
  constexpr int QR = 16 * WR;              // query rows
  const float* xs = ph == 0 ? static_cast<const float*>(a.q) + bh * a.q_bh
                            : dout + bh * do_bh;
  const float* ys = static_cast<const float*>(ph == 0 ? a.k : a.v) +
                    bh * (ph == 0 ? a.k_bh : a.v_bh);
  const long long xr = ph == 0 ? a.q_s : do_s, yr = ph == 0 ? a.k_s : a.v_s;
  const int col0 = c * kF32DbChunk;
  for (int i = threadIdx.x; i < (QR + kDbKeys) * CH; i += 32 * WR) {
    const int r = i / CH, col = col0 + 4 * (i % CH);
    const bool key = r >= QR;              // rows [0, QR) of x, then y's
    const int row = key ? k0 + r - QR : q0 + r;
    const bool in = row < (key ? a.sk : a.sq) && col < dw;
    const float* src = key ? ys + (long long)row * yr : xs + (long long)row * xr;
    cp_async16(key ? &sm.y[s][r - QR][col - col0] : &sm.x[s][r][col - col0],
               in ? src + col : xs, in);
  }
  if (last && threadIdx.x < kDbKeys) {
    const int kj = k0 + threadIdx.x;
    const bool in = a.kvb != nullptr && kj < a.sk;
    cp_async4(&sm.kvb[s][threadIdx.x],
              in ? a.kvb + bh * a.kvb_bh + kj : a.bias, in);
  }
}

// c += A B^T over a stage's 32 columns (four k-steps of 8) in 3xTF32: A
// the warp's 16 rows at ap, B the tile's 64 rows at bp, both raw fp32
// K-major of row stride kF32DbLd, split as read (split_raw); each pair of
// k-steps into a fresh accumulator, added to c in fp32 (flash_f32.cu, item
// 5); B's fragments four n-tiles at a time (fewer live registers)
__device__ __forceinline__ void chunk_product(float (&c)[8][4],
                                              const float* ap,
                                              const float* bp) {
  constexpr int LD = kF32DbLd;
  const int lane = threadIdx.x & 31, m = (lane >> 3) & 3, r = lane & 7;
  float step[8][4];
#pragma unroll
  for (int kk = 0; kk < kF32DbChunk / 8; ++kk) {
    uint32_t ab[4], as[4];
    ldm4(ab, ap + ((m & 1) * 8 + r) * LD + 8 * kk + (m >> 1) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_raw(ab[i], ab[i], as[i]);
#pragma unroll
    for (int n0 = 0; n0 < 8; n0 += 4) {
      uint32_t fb[4][2], fs[4][2];
#pragma unroll
      for (int n = 0; n < 4; n += 2) {
        uint32_t x[4];
        ldm4(x, bp + (8 * (n0 + n + (m >> 1)) + r) * LD + 8 * kk +
                    (m & 1) * 4);
        fb[n][0] = x[0];
        fb[n][1] = x[1];
        fb[n + 1][0] = x[2];
        fb[n + 1][1] = x[3];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          split_raw(fb[n + h][0], fb[n + h][0], fs[n + h][0]);
          split_raw(fb[n + h][1], fb[n + h][1], fs[n + h][1]);
        }
      }
      auto bfrag = [&](int n, uint32_t (&b)[2], uint32_t (&sb)[2]) {
        b[0] = fb[n][0];
        b[1] = fb[n][1];
        sb[0] = fs[n][0];
        sb[1] = fs[n][1];
      };
      float (&part)[4][4] = *reinterpret_cast<float (*)[4][4]>(&step[n0]);
      if (kk % 2 == 0) mma3<true>(part, ab, as, bfrag);
      else mma3<false>(part, ab, as, bfrag);
    }
    if (kk % 2 == 1) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) c[n][i] += step[n][i];
      }
    }
  }
}

// c[i][j] += dO V^T at row 4 (lane >> 3) + i of the warp's 16 from ap and
// key (lane & 7) + 8 j of the tile's 64 from bp, over a stage's 32
// columns: one fp32 fma at a time in ascending column order, from the
// sum's first term, so that each sum rounds as the plain version's fp32
// product (a sequential chain over D) rounds it. Each lane's four rows
// are one broadcast address a quarter-warp, its eight keys eight
// consecutive rows (distinct banks at the row stride of 36 floats)
__device__ __forceinline__ void chunk_dp(float (&c)[4][8], const float* ap,
                                         const float* bp) {
  constexpr int LD = kF32DbLd;
  const int lane = threadIdx.x & 31, rg = lane >> 3, kg = lane & 7;
#pragma unroll kF32DbDpUnroll
  for (int d = 0; d < kF32DbChunk; d += 4) {
    float4 x[4], y[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(ap + (4 * rg + i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y[j] = *reinterpret_cast<const float4*>(bp + (kg + 8 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[i][j] = fmaf(x[i].x, y[j].x, c[i][j]);
        c[i][j] = fmaf(x[i].y, y[j].y, c[i][j]);
        c[i][j] = fmaf(x[i].z, y[j].z, c[i][j]);
        c[i][j] = fmaf(x[i].w, y[j].w, c[i][j]);
      }
    }
  }
}

// block (query tile x of 16 WR rows, key tile y, run z) as the 16-bit
// kernel's, WR warps of 16 query rows; q, k, v, dO fp32 of width dw (a
// multiple of 4) through their strides, nc chunks of 32 columns a row.
// Each bh takes two passes over D, 2 nc chunks of the ring: S from Q and
// K, then dP from dO and V (the stages half as large, and S's and dP's
// working registers not live at once)
template <int NS, int WR>
__global__ void __launch_bounds__(32 * WR, WR <= 4 ? kF32DbBlocks : 1)
flash_f32_dbias_kernel(Attn a, const float* __restrict__ dout,
                       long long do_bh, long long do_s,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, int nbh, int per,
                       int nc, int dw, float* __restrict__ part) {
  constexpr int QR = 16 * WR;
  extern __shared__ __align__(16) float smf[];
  F32DbSmem<NS, WR>& sm = *reinterpret_cast<F32DbSmem<NS, WR>*>(smf);
  const int q0 = blockIdx.x * QR, k0 = blockIdx.y * kDbKeys;
  const int bh0 = blockIdx.z * per, bh1 = min(nbh, bh0 + per);
  const int w = threadIdx.x >> 5, r0 = w * 16;  // this warp's rows
  const int qw = q0 + r0;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (tile_live(a, q0, QR, k0)) {
    for (int i = threadIdx.x; i < QR * kDbKeys; i += 32 * WR) {
      sm.bias[i / kDbKeys][i % kDbKeys] =
          bias2(a, q0 + i / kDbKeys, k0 + i % kDbKeys);
    }
    const bool masked = !all_visible(a, qw, 16, k0, kDbKeys);
    const bool drop = a.drop_inv > 0.f;
    const int per_bh = 2 * nc, total = (bh1 - bh0) * per_bh;
    auto stage = [&](int it) {        // chunk it of the run into its stage
      const int c = it % nc, ph = it / nc % 2;
      stage_chunk(sm, it % NS, a, dout, do_bh, do_s, bh0 + it / per_bh, ph,
                  c, q0, k0, dw, ph == 1 && c == nc - 1);
    };
    // the first NS - 1 chunks in flight, one commit group each
#pragma unroll
    for (int p = 0; p < NS - 1; ++p) {
      if (p < total) stage(p);
      cp_commit();
    }
    float s[8][4], dpc[4][8];
    for (int it = 0; it < total; ++it) {
      const int bh = bh0 + it / per_bh, c = it % nc, ph = it / nc % 2;
      const int st = it % NS;
      if (it + NS - 1 < total) stage(it + NS - 1);   // into the stage the
      cp_commit();                                   // last chunk read
      cp_wait<NS - 1>();              // chunk it has landed
      __syncthreads();
      if (c == 0) {                   // a pass's first chunk
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (ph == 0) s[n][i] = 0.f;
            else dpc[i][n] = 0.f;
          }
        }
      }
      if (ph == 0) {
        chunk_product(s, &sm.x[st][r0][0], &sm.y[st][0][0]);    // Q K^T
      } else {
        chunk_dp(dpc, &sm.x[st][r0][0], &sm.y[st][0][0]);       // dO V^T
      }
      if (ph == 1 && c == nc - 1) {
        float lse2[2], dlt[2], bv[32], dp[32];
        row_stats(lse2, dlt, a, lse, delta, bh, qw);
        load_elems(bv, a, qw, k0, &sm.bias[r0][0]);
        const int lane = threadIdx.x & 31;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sm.dp[w][4 * (lane >> 3) + i][(lane & 7) + 8 * j] = dpc[i][j];
          }
        }
        __syncwarp();
        load_elems(dp, a, qw, k0, &sm.dp[w][0][0]);
        __syncwarp();
        with_ds_form(masked, drop, [&](auto mask, auto dr) {
          add_ds<decltype(mask)::value, decltype(dr)::value>(
              acc, *reinterpret_cast<float (*)[32]>(s), dp, a, bh, qw, k0,
              sm.kvb[st], bv, lse2, dlt);
        });
      }
      __syncthreads();                // before the stage is refilled
    }
  }
  store_tile(part + (long long)blockIdx.z * a.sq * a.sk, acc, a, qw, k0);
}

// what both entry points refuse: no rows, no shared bias, runs outside 1 to
// min(bh, 65535), no scratch for more than one run
bool bad_dbias(int bh, int sq, int sk, const void* bias, long long bias_bh,
               int runs, const void* part) {
  return bh < 1 || sq < 1 || sk < 1 || bias == nullptr || bias_bh != 0 ||
         runs < 1 || runs > bh || runs > 65535 ||
         (runs > 1 && part == nullptr);
}

}  // namespace
}  // namespace apex_port

// q, k, v, dout [bh, s, d] of dtype (bf16 or fp16; d from 8 to 512, a
// multiple of 8: TMA fills the columns past d up to the next 64 with
// zeros) whose tensor maps the wrapper describes in tma (4 x 8 long longs:
// dims d, s, bh; row and bh strides in bytes, multiples of 16; the box
// 64, 64, 1), every base 16-byte aligned; kvb null or fp32 [1|bh, sk] with
// bh stride kvb_bh (0 when shared), its keys contiguous; dropout when
// drop_inv = 1 / (1 - rate) > 0, keeping an element whose hash under seed
// is >= drop_thresh; lse, delta fp32 [bh, sq] contiguous; the bias fp32
// [1, sq, sk] contiguous, shared over bh (bias_bh = 0); dbias fp32 [sq,
// sk] contiguous; bh split into `runs` runs of ceil(bh / runs), and with
// runs > 1 part fp32 [runs, sq, sk] contiguous scratch.
extern "C" int apex_flash_tc_dbias(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dbias, void* part,
                                   const long long* tma, int runs,
                                   const void* kvb, long long kvb_bh,
                                   const void* bias, long long bias_bh,
                                   unsigned seed, unsigned drop_thresh,
                                   float drop_inv, int bh, int sq, int sk,
                                   int d, int q_start, int k_start,
                                   int causal, float scale, void* stream) {
  using namespace apex_port;
  if (bad_dbias(bh, sq, sk, bias, bias_bh, runs, part) || d < 8 ||
      d > 512 || d % 8 != 0 || (dtype != kBF16 && dtype != kF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps maps{};
  Attn a;
  if (!prepare(&maps, &a, dtype == kF16, q, k, v, dout, tma, kvb, kvb_bh,
               bias, bias_bh, seed, drop_thresh, drop_inv, bh, sq, sk, d,
               q_start, k_start, causal, scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int W = kTcDbW, NS = kTcDbStages;
  const int per = (bh + runs - 1) / runs;
  runs = (bh + per - 1) / per;        // no run is left empty
  const dim3 grid((sq + kDbRows * W - 1) / (kDbRows * W),
                  (sk + kDbKeys - 1) / kDbKeys, runs);
  const int nc = (d + kTcDbChunk - 1) / kTcDbChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dbias);
  float* tmp = runs > 1 ? static_cast<float*>(part) : out;
  cudaError_t err = cudaSuccess;
  with_elem(dtype, [&](auto et) {
    using E = typename decltype(et)::type;
    auto kernel = flash_tc_dbias_kernel<E, W, NS>;
    const int bytes = static_cast<int>(sizeof(TcDbSmem<W, NS>)) + 1024;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return;
    kernel<<<grid, 128 * (W + 1), bytes, st>>>(
        maps, a, static_cast<const float*>(lse),
        static_cast<const float*>(delta), bh, per, nc, tmp);
    err = cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  if (runs > 1) dbias_sum(tmp, out, runs, (long long)sq * sk, st);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, dout [bh, s, d] fp32 (d from 4 to 512, a multiple of 4: the
// columns past d read as zeros) with the given strides (elements; the last
// dim contiguous, every stride a multiple of 4, every base 16-byte
// aligned); the rest as apex_flash_tc_dbias's.
extern "C" int apex_flash_f32_dbias(int dtype, const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dbias, void* part, int runs,
                                    long long q_bh, long long q_s,
                                    long long k_bh, long long k_s,
                                    long long v_bh, long long v_s,
                                    long long do_bh, long long do_s,
                                    const void* kvb, long long kvb_bh,
                                    const void* bias, long long bias_bh,
                                    unsigned seed, unsigned drop_thresh,
                                    float drop_inv, int bh, int sq, int sk,
                                    int d, int q_start, int k_start,
                                    int causal, float scale, void* stream) {
  using namespace apex_port;
  if (bad_dbias(bh, sq, sk, bias, bias_bh, runs, part) || d < 4 ||
      d > 512 || d % 4 != 0 || dtype != kF32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  constexpr int NS = kF32DbStages, WR = kF32DbWarps;
  const int per = (bh + runs - 1) / runs;
  runs = (bh + per - 1) / per;
  const dim3 grid((sq + 16 * WR - 1) / (16 * WR),
                  (sk + kDbKeys - 1) / kDbKeys, runs);
  const int nc = (d + kF32DbChunk - 1) / kF32DbChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dbias);
  float* tmp = runs > 1 ? static_cast<float*>(part) : out;
  auto kernel = flash_f32_dbias_kernel<NS, WR>;
  const int bytes = static_cast<int>(sizeof(F32DbSmem<NS, WR>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 32 * WR, bytes, st>>>(
      a, static_cast<const float*>(dout), do_bh, do_s,
      static_cast<const float*>(lse), static_cast<const float*>(delta), bh,
      per, nc, d, tmp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (runs > 1) dbias_sum(tmp, out, runs, (long long)sq * sk, st);
  return static_cast<int>(cudaGetLastError());
}
