// Flash attention over [BH, S, D] fp32 (D 64, 128 or 256) on the tensor
// cores in 3xTF32: the forward (o and the per-row lse, by the online
// softmax), dq (with the per-bh bias gradient dS when asked) and dk/dv, the
// two
// recomputing the probabilities from the forward's lse. The semantics they
// keep from the Pallas kernels are csrc/flash_common.cuh's: causal masking
// by absolute positions, the per-key kv_bias and the full bias, dropout by
// the JAX package's coordinate hash, the finite kNegInf, the value guard.
//
// Replaces, for fp32 inputs at a head dim up to 256 (padded to 64, 128 or
// 256), the Pallas kernels of
// apex_tpu/contrib/multihead_attn/flash_attention.py: _fwd_kernel (:181),
// _bwd_dq_kernel (:349) and _bwd_dkv_kernel (:392), with the recompute of
// _recompute_p_ds (:309-346). Past 256 csrc/flash_f32_d512.cu takes the
// forward, dq and dk/dv; csrc/flash_dbias.cu the shared-bias gradient.
//
// Bound on this card: operations. At lm_bench's shape (BH = 128, S =
// 4095, D = 64, causal: 1.07e9 live pairs) the forward's two products are
// 4·D·pairs = 275 GFLOP, dq's three 6·D·pairs = 412 GFLOP and dk/dv's four
// 8·D·pairs = 550 GFLOP. In 3xTF32 (three TF32 products for each fp32 one,
// at the 495 TFLOP/s of TF32 dense: 165 TFLOP/s) they take 1.667, 2.50 and
// 3.33 ms; at the 67 TFLOP/s of fp32 FMAs outside the tensor cores 4.102,
// 6.152 and 8.203 ms. The bytes (~270, ~340 and ~400 MB) take ~0.1 ms.
//
// Precision: each fp32 operand x is split as big = tf32(x) (cvt.rna: to
// nearest, ties away) and small = tf32(x - big), and each product is
// small·big + big·small + big·big into one fp32 accumulator, the two small
// terms first. The dropped small·small term is ~2^-22 of the product, so
// the outputs keep fp32's rule (2 ulps + 2^-14 of the row's RMS); one TF32
// pass (2^-11) would not, and no form takes it.
//
// What the design does about the simple form's limits (flash_simt.cu:
// every FMA reads shared memory, 8 rows a block, scalar staging that does
// not overlap the products):
// 1. Products on the tensor cores: mma.sync.m16n8k8 with TF32 operands and
//    fp32 accumulators. A block of 8 warps (4 at D 128) owns 128 rows (64),
//    queries for dq and keys for dk/dv, 16 a warp; each staged value feeds
//    a whole m16n8 tile of products. TF32 wgmma takes both operands
//    K-major only, and the second products (dS K; P^T dO, dS^T Q) read
//    their B operand across rows: mma.sync's fragment loads take that from
//    shared memory directly, where wgmma would need a transposing pass.
// 2. P and dS stay in registers as the second products' A operand. The
//    m16n8k8 accumulator holds columns 2t and 2t + 1 in lane (g, t), the
//    TF32 A fragment columns t and t + 4: the k index is permuted instead
//    of shuffled (A's k = t reads column 2t, k = t + 4 column 2t + 1) and
//    the B fragment loads the tile's rows 2t and 2t + 1 to match.
// 3. Staging: the other side's rows (keys and values for dq, queries and
//    their dO for dk/dv; 32 a tile at D 64, 16 for dq and 8 for dk/dv at D
//    128, so that no form spills) arrive by 16-byte cp.async into a second
//    buffer while the products read the first; rows are padded to D + 4
//    floats (4 mod 16), so that the across-rows fragment loads of a warp
//    hit 32 distinct banks, and the K-major ones are ldmatrix's (four 8 x
//    4 fp32 matrices, one instruction where sixteen loads would do).
// 4. Split once: cvt.rna is several instructions on this card, and split
//    as each warp reads a value the splits outnumbered the products, so
//    the kernels issued instructions, not products. Every staged
//    row (the block's own once, each tile as it lands) is split by the
//    whole block into big (in place) and small halves in shared memory,
//    which the warps then read; holding both halves of Q and dO in
//    registers across the loop would not fit. Only P and dS are split in
//    registers.
// 5. The tensor cores add into an accumulator rounding toward zero: a
//    chain of products into one accumulator drifts low by up to an ulp a
//    product. Scores and dP take each pair of k-steps (6 products) into a
//    fresh accumulator and the second products each tile's, added up in
//    fp32 to nearest; one chain over all keys missed fp32's rule at S
//    4095, and one over all of a score's products missed it on dS.
// 6. The forward is dq without dO, dP and dS: S = Q K^T by the pairs of
//    k-steps above, the online softmax on S's registers (a quad of lanes
//    shares a row, so the row max and sum take two shuffles), O scaled by
//    alpha in fp32 before each tile's P V, from a fresh accumulator, is
//    added. Holding no dO, it stages 64 keys a tile at D 64 (32 at D 128).
// 7. At D 256 shared memory sets the block's shape: a staged row split in
//    two is 2 x 260 floats (2080 bytes), so the block's queries take 2080
//    bytes a row and each staged key 6 x 1040 (K and V double-buffered,
//    their small halves once). A warp's O is 16 x 256 fp32, 128 registers
//    a thread. The shape below (f_warps, f_fwd_tile at 256: 4 warps, 8-key
//    tiles, 179 KB) is the one flash_f32_ab.py timed fastest on the H100
//    (PERF.md): 3 warps and 16 keys (195 KB) took 27% longer and spilled,
//    2 warps and 16 keys (162 KB) twice as long and spilled, 5 warps and 8
//    keys (211 KB) 10% longer.
// 8. dq and dk/dv at D 256 meet two walls. Shared memory: the block's two
//    sets of rows split in two take 4 x 1040 bytes a row, so 64 rows and
//    two tiles of 16 need 233 KB of the 227 a block may have (f32_dq_kernel
//    would fit 2 warps). Registers: a warp's dk and dv over 16 keys are
//    256 a thread, past the 255 it may hold. So a pair of warps shares 16
//    rows (f32_dq_pair_kernel, f32_dkv_pair_kernel): dq's warps make S and
//    dP, trade them through shared memory under the pair's named barrier,
//    both form dS and each keeps half of dq's columns (64 registers);
//    dk/dv's make P^T and dv, and dP^T, dS^T and dk, P^T handed over (128
//    registers each). Rows kept raw are split as each warp loads them by
//    integer rounding (split_raw: an add, a mask and a subtract a value,
//    where cvt.rna takes several instructions), which halves their shared
//    memory: 8 warps over 64 rows with raw 16-row tiles take 206-212 KB.
//    p_warps, p_tile, p_own_raw and p_tile_raw set the shape; the one
//    flash_f32_ab.py d256bwd timed fastest on the H100 is committed
//    (PERF.md); p_group keeps dk/dv from spilling.
// Tiles wholly past the causal edge are skipped, by the block and by each
// warp; a warp whose 16 rows see all of a tile with no bias or dropout
// takes the unmasked path. Each block owns its output rows and writes
// them once, without atomics, so every output repeats bit for bit.

#include "flash_f32.cuh"

namespace apex_port {
namespace {

// The block's shape by head dim: 8 warps of 16 rows at D 64, 4 at D 128
// and 256 (the block's rows and the staged tiles, each split into big and
// small halves, fill most of the 227 KB of shared memory either way), and
// the other side's rows a staged tile holds: fewer at D 128, and fewer
// still for dk/dv there, whose dk and dv take 128 registers a thread, so
// that no form spills
template <int D> __host__ __device__ constexpr int f_warps() {
  return D <= 64 ? 8 : 4;
}
template <int D> __host__ __device__ constexpr int f_rows() {
  return 16 * f_warps<D>();
}
template <int D, bool KV> __host__ __device__ constexpr int f_tile() {
  return D <= 64 ? 32 : KV ? 8 : 16;
}
// the forward's staged keys: it holds no dO, so twice dq's (at D 256 what
// shared memory leaves: item 7 above)
template <int D> __host__ __device__ constexpr int f_fwd_tile() {
  return D <= 64 ? 64 : D <= 128 ? 32 : 8;
}
// the row stride of everything staged: D + 4 floats
template <int D> __host__ __device__ constexpr int f_ld() { return D + 4; }

// ---- staging -----------------------------------------------------------

// rows [row0, row0 + n) of a [rows, D] fp32 matrix (row stride rs
// elements, rows 16-byte aligned) into dst [n][D + 4], zeros past `rows`;
// all NT threads of the block issue, the caller commits
template <int D, int NT = 32 * f_warps<D>()>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long rs, int row0, int n,
                                      int rows) {
  constexpr int C = D / 4;                 // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * C; i += NT) {
    const int r = i / C, c = i % C;
    const bool in = row0 + r < rows;
    cp_async16(dst + r * f_ld<D>() + 4 * c,
               in ? src + (long long)(row0 + r) * rs + 4 * c : src, in);
  }
}

// n fp32 values from src[row0..] into dst, zeros past `rows`
template <int D, int NT = 32 * f_warps<D>()>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int row0, int n, int rows) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool in = row0 + i < rows;
    cp_async4(dst + i, in ? src + row0 + i : src, in);
  }
}

// Staged rows [0, n) split once for every warp that reads them: big =
// tf32(x) in place of x, small = tf32(x - big) at the same place of
// `small`; all NT threads, four elements a step
template <int D, int NT = 32 * f_warps<D>()>
__device__ __forceinline__ void split_rows(float* rows, float* small, int n) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < n * C; i += NT) {
    const int at = i / C * f_ld<D>() + 4 * (i % C);
    const float4 x = *reinterpret_cast<const float4*>(rows + at);
    uint4 b, s;
    split(x.x, b.x, s.x);
    split(x.y, b.y, s.y);
    split(x.z, b.z, s.z);
    split(x.w, b.w, s.w);
    *reinterpret_cast<uint4*>(rows + at) = b;
    *reinterpret_cast<uint4*>(small + at) = s;
  }
}

// ---- the forward -------------------------------------------------------

// o [BH, Sq, D] and lse [BH, Sq] fp32 contiguous; the grid folds bh with
// the row blocks (bh-major, each bh's longest rows first). Lane (g, t)
// holds rows g and g + 8 of its warp's 16: their running max m (log2
// units) and sum l, and their O columns 8n + 2t, 8n + 2t + 1.
template <int D, bool EXTRA>
__global__ void __launch_bounds__(32 * f_warps<D>())
f32_fwd_kernel(Attn a, float* __restrict__ o, float* __restrict__ lse) {
  constexpr int LD = f_ld<D>(), R = f_rows<D>(), BK = f_fwd_tile<D>();
  constexpr int NK = BK / 8, ND = D / 8;
  extern __shared__ float smf[];
  float* qs = smf;                         // [R][LD] the block's queries
  float* qsm = qs + R * LD;                // [R][LD] the queries' small
  float* kt = qsm + R * LD;                // [2][BK][LD] keys
  float* vt = kt + 2 * BK * LD;            // [2][BK][LD] values
  float* ksm = vt + 2 * BK * LD;           // [BK][LD] the keys' small
  float* vsm = ksm + BK * LD;              // [BK][LD] the values' small
  const int nb = (a.sq + R - 1) / R;
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * R;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * w;              // the warp's first row
  const float* k = static_cast<const float*>(a.k) + bh * a.k_bh;
  const float* v = static_cast<const float*>(a.v) + bh * a.v_bh;
  // key tiles the block's rows see
  int nt = (a.sk + BK - 1) / BK;
  const int last = min(q0 + R, a.sq) - 1;
  if (a.causal) {
    const int lim = a.q_start + last - a.k_start;
    nt = lim < 0 ? 0 : min(nt, lim / BK + 1);
  }
  stage<D>(qs, static_cast<const float*>(a.q) + bh * a.q_bh, a.q_s, q0, R,
           a.sq);
  if (nt > 0) {
    stage<D>(kt, k, a.k_s, 0, BK, a.sk);
    stage<D>(vt, v, a.v_s, 0, BK, a.sk);
  }
  cp_commit();
  const float sl2 = a.scale * kLog2e;
  // the last row the warp holds: a causal tile wholly past it is skipped,
  // as is everything by a warp whose rows all lie past Sq
  const int wlast = a.q_start + min(r0 + 15, a.sq - 1) - a.k_start;
  const bool wrows = r0 < a.sq;
  cp_wait_all();
  __syncthreads();
  split_rows<D>(qs, qsm, R);
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    cp_wait_all();
    __syncthreads();                       // tile it landed, it - 1 read
    if (it + 1 < nt) {                     // the next tile, into the other
      const int nx = (it + 1) * BK;
      stage<D>(kt + (buf ^ 1) * BK * LD, k, a.k_s, nx, BK, a.sk);
      stage<D>(vt + (buf ^ 1) * BK * LD, v, a.v_s, nx, BK, a.sk);
    }
    cp_commit();
    float* kb = kt + buf * BK * LD;
    float* vb = vt + buf * BK * LD;
    split_rows<D>(kb, ksm, BK);
    split_rows<D>(vb, vsm, BK);
    __syncthreads();
    const int k0 = it * BK;
    if (!wrows || (a.causal && wlast < k0)) continue;   // sees none of it
    const int wo = 16 * w * LD;
    float s[NK][4];
    product_t<ND, NK, LD>(s, qs + wo, qsm + wo, kb, ksm);          // Q K^T
    const bool open = !EXTRA && all_visible(a, r0, 16, k0, BK);
    // scores in log2 units (kNegInf where masked), the rows' new max
    float mx[2] = {m[0], m[1]};
    if (open) {                            // the warp's branch: uniform
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] *= sl2;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] = score2(a, bh, r0 + g + 8 * (i >> 1),
                           k0 + 8 * n + 2 * t + (i & 1), s[n][i]);
          mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
        }
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      alpha[h] = ex2(m[h] - mx[h]);        // 1 while the row saw nothing
      m[h] = mx[h];
    }
    // p, summed undropped into l (lse stays dropout-free), then dropped
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sc = s[n][i];
        float p = open || sc > kNegInf * 0.5f ? ex2(sc - m[i >> 1]) : 0.f;
        rs[i >> 1] += p;
        if (EXTRA && a.drop_inv > 0.f) {
          p = keep(a, bh, r0 + g + 8 * (i >> 1),
                   k0 + 8 * n + 2 * t + (i & 1)) ? p * a.drop_inv : 0.f;
        }
        s[n][i] = p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(rs[h]);
    // O scaled in fp32, then the tile's P V added from a fresh accumulator
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];
    }
    product_n<NK, ND, LD>(acc, s, vb, vsm, g, t);                  // O += P V
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + g + 8 * h;
    if (qi >= a.sq) continue;
    const long long row = (long long)bh * a.sq + qi;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 1.f;
    float* out = o + row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    }
    if (t == 0) lse[row] = l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : kNegInf;
  }
}

// ---- dq (and the per-bh dS) ------------------------------------------

// dq [BH, Sq, D] fp32 contiguous; ds null or fp32 [BH, Sq, Sk]
// contiguous: dS of every (query, key), unscaled, zeros where a tile is
// skipped. The grid folds bh with the row blocks (bh-major, each bh's
// longest rows first).
template <int D, bool EXTRA>
__global__ void __launch_bounds__(32 * f_warps<D>())
f32_dq_kernel(Attn a, const float* __restrict__ dout, long long do_bh,
              long long do_s, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq,
              float* __restrict__ ds) {
  constexpr int LD = f_ld<D>(), R = f_rows<D>(), BK = f_tile<D, false>();
  constexpr int NK = BK / 8, ND = D / 8;
  extern __shared__ float smf[];
  float* qs = smf;                         // [R][LD] the block's queries
  float* os = qs + R * LD;                 // [R][LD] their dO
  float* qsm = os + R * LD;                // [R][LD] the queries' small
  float* osm = qsm + R * LD;               // [R][LD] dO's small
  float* kt = osm + R * LD;                // [2][BK][LD] keys
  float* vt = kt + 2 * BK * LD;            // [2][BK][LD] values
  float* ksm = vt + 2 * BK * LD;           // [BK][LD] the keys' small
  float* vsm = ksm + BK * LD;              // [BK][LD] the values' small
  const int nb = (a.sq + R - 1) / R;
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * R;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * w;              // the warp's first row
  const float* k = static_cast<const float*>(a.k) + bh * a.k_bh;
  const float* v = static_cast<const float*>(a.v) + bh * a.v_bh;
  // key tiles the block's rows see
  int nt = (a.sk + BK - 1) / BK;
  const int last = min(q0 + R, a.sq) - 1;
  if (a.causal) {
    const int lim = a.q_start + last - a.k_start;
    nt = lim < 0 ? 0 : min(nt, lim / BK + 1);
  }
  stage<D>(qs, static_cast<const float*>(a.q) + bh * a.q_bh, a.q_s, q0, R,
           a.sq);
  stage<D>(os, dout + bh * do_bh, do_s, q0, R, a.sq);
  if (nt > 0) {
    stage<D>(kt, k, a.k_s, 0, BK, a.sk);
    stage<D>(vt, v, a.v_s, 0, BK, a.sk);
  }
  cp_commit();
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + g + 8 * h;
    const long long row = (long long)bh * a.sq + qi;
    lse2[h] = qi < a.sq ? lse[row] * kLog2e : 0.f;
    dlt[h] = qi < a.sq ? delta[row] : 0.f;
  }
  const float sl2 = a.scale * kLog2e;
  // the last row the warp holds: a causal tile wholly past it is skipped
  const int wlast = a.q_start + min(r0 + 15, a.sq - 1) - a.k_start;
  cp_wait_all();
  __syncthreads();
  split_rows<D>(qs, qsm, R);
  split_rows<D>(os, osm, R);
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    cp_wait_all();
    __syncthreads();                       // tile it landed, it - 1 read
    if (it + 1 < nt) {                     // the next tile, into the other
      const int nx = (it + 1) * BK;
      stage<D>(kt + (buf ^ 1) * BK * LD, k, a.k_s, nx, BK, a.sk);
      stage<D>(vt + (buf ^ 1) * BK * LD, v, a.v_s, nx, BK, a.sk);
    }
    cp_commit();
    float* kb = kt + buf * BK * LD;
    float* vb = vt + buf * BK * LD;
    split_rows<D>(kb, ksm, BK);
    split_rows<D>(vb, vsm, BK);
    __syncthreads();
    const int k0 = it * BK;
    float s[NK][4], dp[NK][4];
    if (a.causal && wlast < k0) {          // the warp sees none of it
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
      }
    } else {
      const int wo = 16 * w * LD;
      product_t<ND, NK, LD>(s, qs + wo, qsm + wo, kb, ksm);        // Q K^T
      product_t<ND, NK, LD>(dp, os + wo, osm + wo, vb, vsm);       // dO V^T
      if (!EXTRA && all_visible(a, r0, 16, k0, BK)) {
#pragma unroll
        for (int n = 0; n < NK; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = exp2f(s[n][i] * sl2 - lse2[i >> 1]);
            s[n][i] = p * (dp[n][i] - dlt[i >> 1]);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NK; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float dsv;
            p_and_ds(a, bh, r0 + g + 8 * (i >> 1),
                     k0 + 8 * n + 2 * t + (i & 1), s[n][i], dp[n][i],
                     lse2[i >> 1], dlt[i >> 1], dsv);
            s[n][i] = dsv;
          }
        }
      }
      product_n<NK, ND, LD>(acc, s, kb, ksm, g, t);          // dq += dS K
    }
    if (ds != nullptr) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = r0 + g + 8 * (i >> 1);
          const int kj = k0 + 8 * n + 2 * t + (i & 1);
          if (qi < a.sq && kj < a.sk)
            ds[((long long)bh * a.sq + qi) * a.sk + kj] = s[n][i];
        }
      }
    }
  }
  if (ds != nullptr) {
    for (int h = 0; h < 16 && r0 + h < a.sq; ++h) {
      float* row = ds + ((long long)bh * a.sq + r0 + h) * a.sk;
      for (int kj = nt * BK + lane; kj < a.sk; kj += 32) row[kj] = 0.f;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + g + 8 * h;
    if (qi >= a.sq) continue;
    float* out = dq + ((long long)bh * a.sq + qi) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * h] * a.scale, acc[n][2 * h + 1] * a.scale);
    }
  }
}

// ---- dk, dv ----------------------------------------------------------

// dk, dv [BH, Sk, D] fp32 contiguous; the grid folds bh with the blocks
// of keys (the first keys, which see the most queries, first)
template <int D, bool EXTRA>
__global__ void __launch_bounds__(32 * f_warps<D>())
f32_dkv_kernel(Attn a, const float* __restrict__ dout, long long do_bh,
               long long do_s, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv) {
  constexpr int LD = f_ld<D>(), R = f_rows<D>(), BQ = f_tile<D, true>();
  constexpr int NQ = BQ / 8, ND = D / 8;
  extern __shared__ float smf[];
  float* ks = smf;                         // [R][LD] the block's keys
  float* vs = ks + R * LD;                 // [R][LD] their values
  float* ksm = vs + R * LD;                // [R][LD] the keys' small
  float* vsm = ksm + R * LD;               // [R][LD] the values' small
  float* qt = vsm + R * LD;                // [2][BQ][LD] queries
  float* ot = qt + 2 * BQ * LD;            // [2][BQ][LD] their dO
  float* qsm = ot + 2 * BQ * LD;           // [BQ][LD] the queries' small
  float* osm = qsm + BQ * LD;              // [BQ][LD] dO's small
  float* ls = osm + BQ * LD;               // [2][BQ] their lse
  float* dl = ls + 2 * BQ;                 // [2][BQ] their delta
  const int nb = (a.sk + R - 1) / R;
  const int bh = blockIdx.x / nb;
  const int k0 = (blockIdx.x % nb) * R;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = k0 + 16 * w;              // the warp's first key
  const float* q = static_cast<const float*>(a.q) + bh * a.q_bh;
  const float* dob = dout + bh * do_bh;
  const float* lsb = lse + (long long)bh * a.sq;
  const float* dlb = delta + (long long)bh * a.sq;
  // the query tiles that see the block's keys (with the causal mask)
  const int nqt = (a.sq + BQ - 1) / BQ;
  int qt0 = 0;
  if (a.causal) {
    const int need = a.k_start + k0 - a.q_start;
    qt0 = need <= 0 ? 0 : min(nqt, need / BQ);
  }
  stage<D>(ks, static_cast<const float*>(a.k) + bh * a.k_bh, a.k_s, k0, R,
           a.sk);
  stage<D>(vs, static_cast<const float*>(a.v) + bh * a.v_bh, a.v_s, k0, R,
           a.sk);
  if (qt0 < nqt) {
    stage<D>(qt + (qt0 & 1) * BQ * LD, q, a.q_s, qt0 * BQ, BQ, a.sq);
    stage<D>(ot + (qt0 & 1) * BQ * LD, dob, do_s, qt0 * BQ, BQ, a.sq);
    stage_vec<D>(ls + (qt0 & 1) * BQ, lsb, qt0 * BQ, BQ, a.sq);
    stage_vec<D>(dl + (qt0 & 1) * BQ, dlb, qt0 * BQ, BQ, a.sq);
  }
  cp_commit();
  const float sl2 = a.scale * kLog2e;
  // the warp's first key: a causal tile wholly before it is skipped
  const int wfirst = a.k_start + c0 - a.q_start;
  cp_wait_all();
  __syncthreads();
  split_rows<D>(ks, ksm, R);
  split_rows<D>(vs, vsm, R);
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;
  }
  for (int it = qt0; it < nqt; ++it) {
    const int buf = it & 1;
    cp_wait_all();
    __syncthreads();                       // tile it landed, it - 1 read
    if (it + 1 < nqt) {
      const int nx = (it + 1) * BQ;
      stage<D>(qt + (buf ^ 1) * BQ * LD, q, a.q_s, nx, BQ, a.sq);
      stage<D>(ot + (buf ^ 1) * BQ * LD, dob, do_s, nx, BQ, a.sq);
      stage_vec<D>(ls + (buf ^ 1) * BQ, lsb, nx, BQ, a.sq);
      stage_vec<D>(dl + (buf ^ 1) * BQ, dlb, nx, BQ, a.sq);
    }
    cp_commit();
    float* qb = qt + buf * BQ * LD;
    float* ob = ot + buf * BQ * LD;
    const float* lb = ls + buf * BQ;
    const float* db = dl + buf * BQ;
    split_rows<D>(qb, qsm, BQ);
    split_rows<D>(ob, osm, BQ);
    __syncthreads();
    const int qb0 = it * BQ;
    if (!(a.causal && qb0 + BQ - 1 < wfirst)) {   // the warp sees some
      const int wo = 16 * w * LD;
      float s[NQ][4], dp[NQ][4];
      product_t<ND, NQ, LD>(s, ks + wo, ksm + wo, qb, qsm);        // K Q^T
      product_t<ND, NQ, LD>(dp, vs + wo, vsm + wo, ob, osm);       // V dO^T
      if (!EXTRA && all_visible(a, qb0, BQ, c0, 16)) {
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 8 * n + 2 * t + (i & 1);
            const float p = exp2f(s[n][i] * sl2 - lb[c] * kLog2e);
            s[n][i] = p;
            dp[n][i] = p * (dp[n][i] - db[c]);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 8 * n + 2 * t + (i & 1);
            float dsv;
            s[n][i] = p_and_ds(a, bh, qb0 + c, c0 + g + 8 * (i >> 1),
                               s[n][i], dp[n][i], lb[c] * kLog2e, db[c],
                               dsv);
            dp[n][i] = dsv;
          }
        }
      }
      product_n<NQ, ND, LD>(dva, s, ob, osm, g, t);          // dv += P^T dO
      product_n<NQ, ND, LD>(dka, dp, qb, qsm, g, t);         // dk += dS^T Q
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = c0 + g + 8 * h;
    if (kj >= a.sk) continue;
    const long long row = ((long long)bh * a.sk + kj) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dk + row + 8 * n) =
          make_float2(dka[n][2 * h] * a.scale, dka[n][2 * h + 1] * a.scale);
      *reinterpret_cast<float2*>(dv + row + 8 * n) =
          make_float2(dva[n][2 * h], dva[n][2 * h + 1]);
    }
  }
}

// ---- dq and dk/dv at D 256: pairs of warps -----------------------------

// The blocks at D 256 (item 8 above), each knob for dq (KV false) and
// dk/dv (KV true): the warps, in pairs that each own 16 rows (queries,
// keys); the other side's rows a staged tile holds; whether the block's
// own rows are kept raw and split as each warp reads them (else split once
// into big and small halves); whether the staged tiles are (else split
// once as each lands). flash_f32_ab.py d256bwd times the shapes that fit.
template <bool KV> __host__ __device__ constexpr int p_warps() {
  return KV ? 8 : 8;
}
template <bool KV> __host__ __device__ constexpr int p_tile() {
  return KV ? 16 : 16;
}
template <bool KV> __host__ __device__ constexpr bool p_own_raw() {
  return KV ? true : true;
}
template <bool KV> __host__ __device__ constexpr bool p_tile_raw() {
  return KV ? true : true;
}
template <bool KV> __host__ __device__ constexpr int p_rows() {
  return 8 * p_warps<KV>();
}
// the n-tiles a pass of the second product takes: dk/dv's 128-register
// accumulator leaves room for two (four spilled at 255 registers)
template <bool KV> __host__ __device__ constexpr int p_group() {
  return KV ? 2 : 4;
}
// the first products' k-steps a fresh accumulator (product_t's KP); one
// made dq slower and no closer to the plain version (PERF.md)
template <bool KV> __host__ __device__ constexpr int p_chain() {
  return KV ? 2 : 2;
}
// dq at D 256, as f32_dq_kernel (its arguments and outputs) but by pairs
// of warps over 16 queries: warp 0 of a pair makes S = Q K^T and P
// (undropped: dS's weight), warp 1 dP = dO V^T (dropped and rescaled);
// each hands its tile to the other through shared memory under the pair's
// barrier, both form dS = P (dP - delta), and each adds dS K into its half
// of dq's columns (64 registers a thread).
template <bool EXTRA>
__global__ void __launch_bounds__(32 * p_warps<false>(), 1)
f32_dq_pair_kernel(Attn a, const float* __restrict__ dout, long long do_bh,
                   long long do_s, const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   float* __restrict__ ds) {
  constexpr int D = 256, LD = f_ld<D>(), ND = D / 8;
  constexpr int R = p_rows<false>(), BK = p_tile<false>(), NK = BK / 8;
  constexpr int NT = 32 * p_warps<false>(), LDX = p_ldx<BK>();
  constexpr bool OR = p_own_raw<false>(), TR = p_tile_raw<false>();
  extern __shared__ float smf[];
  float* qs = smf;                         // [R][LD] the block's queries
  float* os = qs + R * LD;                 // [R][LD] their dO
  float* qsm = os + R * LD;                // [R][LD] small halves, where
  float* osm = qsm + (OR ? 0 : R * LD);    //   split once
  float* kt = osm + (OR ? 0 : R * LD);     // [2][BK][LD] keys
  float* vt = kt + 2 * BK * LD;            // [2][BK][LD] values
  float* ksm = vt + 2 * BK * LD;           // [BK][LD] small halves, where
  float* vsm = ksm + (TR ? 0 : BK * LD);   //   split once
  float* ex = vsm + (TR ? 0 : BK * LD);    // [R / 16][2][16][LDX] tiles
  const int nb = (a.sq + R - 1) / R;
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * R;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pr = w >> 1, role = w & 1;     // 0: S and P; 1: dP
  const int r0 = q0 + 16 * pr;             // the pair's first row
  const float* k = static_cast<const float*>(a.k) + bh * a.k_bh;
  const float* v = static_cast<const float*>(a.v) + bh * a.v_bh;
  // key tiles the block's rows see
  int nt = (a.sk + BK - 1) / BK;
  const int last = min(q0 + R, a.sq) - 1;
  if (a.causal) {
    const int lim = a.q_start + last - a.k_start;
    nt = lim < 0 ? 0 : min(nt, lim / BK + 1);
  }
  stage<D, NT>(qs, static_cast<const float*>(a.q) + bh * a.q_bh, a.q_s, q0,
               R, a.sq);
  stage<D, NT>(os, dout + bh * do_bh, do_s, q0, R, a.sq);
  if (nt > 0) {
    stage<D, NT>(kt, k, a.k_s, 0, BK, a.sk);
    stage<D, NT>(vt, v, a.v_s, 0, BK, a.sk);
  }
  cp_commit();
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + g + 8 * h;
    const long long row = (long long)bh * a.sq + qi;
    lse2[h] = qi < a.sq ? lse[row] * kLog2e : 0.f;
    dlt[h] = qi < a.sq ? delta[row] : 0.f;
  }
  const float sl2 = a.scale * kLog2e;
  // the pair's last row: a causal tile wholly past it is skipped, as is
  // everything by a pair whose rows all lie past Sq
  const int wlast = a.q_start + min(r0 + 15, a.sq - 1) - a.k_start;
  const bool rows_in = r0 < a.sq;
  cp_wait_all();
  __syncthreads();
  if constexpr (!OR) {
    split_rows<D, NT>(qs, qsm, R);
    split_rows<D, NT>(os, osm, R);
  }
  // the warp's operand of the first products: Q (role 0) or dO (role 1)
  const int wo = 16 * pr * LD;
  const float* own = (role ? os : qs) + wo;
  const float* own_sm = (role ? osm : qsm) + wo;
  float* mine = ex + (2 * pr + role) * 16 * LDX;
  const float* theirs = ex + (2 * pr + (role ^ 1)) * 16 * LDX;
  float acc[ND / 2][4];                    // dq's columns 128 role + 8n + 2t
#pragma unroll
  for (int n = 0; n < ND / 2; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    cp_wait_all();
    __syncthreads();                       // tile it landed, it - 1 read
    if (it + 1 < nt) {                     // the next tile, into the other
      const int nx = (it + 1) * BK;
      stage<D, NT>(kt + (buf ^ 1) * BK * LD, k, a.k_s, nx, BK, a.sk);
      stage<D, NT>(vt + (buf ^ 1) * BK * LD, v, a.v_s, nx, BK, a.sk);
    }
    cp_commit();
    float* kb = kt + buf * BK * LD;
    float* vb = vt + buf * BK * LD;
    if constexpr (!TR) {
      split_rows<D, NT>(kb, ksm, BK);
      split_rows<D, NT>(vb, vsm, BK);
      __syncthreads();
    }
    const int k0 = it * BK;
    float x[NK][4];
    const bool sees = rows_in && !(a.causal && wlast < k0);
    if (sees) {                            // the pair's branch: uniform
      product_t<ND, NK, LD, OR, TR, p_chain<false>()>(
          x, own, own_sm, role ? vb : kb, role ? vsm : ksm);  // QK^T, dOV^T
      if (role == 0) {                     // P, undropped
        if (!EXTRA && all_visible(a, r0, 16, k0, BK)) {
#pragma unroll
          for (int n = 0; n < NK; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              x[n][i] = ex2(x[n][i] * sl2 - lse2[i >> 1]);
          }
        } else {
#pragma unroll
          for (int n = 0; n < NK; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float sc = score2(a, bh, r0 + g + 8 * (i >> 1),
                                      k0 + 8 * n + 2 * t + (i & 1), x[n][i]);
              x[n][i] = sc > kNegInf * 0.5f ? ex2(sc - lse2[i >> 1]) : 0.f;
            }
          }
        }
      } else if (EXTRA && a.drop_inv > 0.f) {   // dP where kept, rescaled
#pragma unroll
        for (int n = 0; n < NK; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[n][i] = keep(a, bh, r0 + g + 8 * (i >> 1),
                           k0 + 8 * n + 2 * t + (i & 1)) ? x[n][i] * a.drop_inv
                                                         : 0.f;
          }
        }
      }
      tile_out<NK, LDX>(mine, x, g, t);
      pair_sync(pr);
      float y[NK][4];
      tile_in<NK, LDX>(y, theirs, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = role ? y[n][i] : x[n][i];
          const float dp = role ? x[n][i] : y[n][i];
          x[n][i] = p * (dp - dlt[i >> 1]);             // dS
        }
      }
      product_n<NK, ND / 2, LD, TR, p_group<false>()>(
          acc, x, kb + 128 * role, ksm + 128 * role, g, t);   // dq += dS K
    }
    if (ds != nullptr && role == 0) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = r0 + g + 8 * (i >> 1);
          const int kj = k0 + 8 * n + 2 * t + (i & 1);
          if (qi < a.sq && kj < a.sk)
            ds[((long long)bh * a.sq + qi) * a.sk + kj] =
                sees ? x[n][i] : 0.f;
        }
      }
    }
  }
  if (ds != nullptr && role == 0) {
    for (int h = 0; h < 16 && r0 + h < a.sq; ++h) {
      float* row = ds + ((long long)bh * a.sq + r0 + h) * a.sk;
      for (int kj = nt * BK + lane; kj < a.sk; kj += 32) row[kj] = 0.f;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + g + 8 * h;
    if (qi >= a.sq) continue;
    float* out = dq + ((long long)bh * a.sq + qi) * D + 128 * role + 2 * t;
#pragma unroll
    for (int n = 0; n < ND / 2; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * h] * a.scale, acc[n][2 * h + 1] * a.scale);
    }
  }
}

// dk, dv at D 256, as f32_dkv_kernel but by pairs of warps over 16 keys:
// warp 0 of a pair makes S^T = K Q^T and P^T, hands P^T (undropped) to
// warp 1 through shared memory (the pair's barrier: warp 0 arrives, warp 1
// waits) and adds P^T dO (dropped and rescaled) into dv; warp 1 makes
// dP^T = V dO^T, dS^T = P^T (dP^T - delta) and adds dS^T Q into dk. Each
// holds one accumulator, 128 registers a thread.
template <bool EXTRA>
__global__ void __launch_bounds__(32 * p_warps<true>(), 1)
f32_dkv_pair_kernel(Attn a, const float* __restrict__ dout, long long do_bh,
                    long long do_s, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv) {
  constexpr int D = 256, LD = f_ld<D>(), ND = D / 8;
  constexpr int R = p_rows<true>(), BQ = p_tile<true>(), NQ = BQ / 8;
  constexpr int NT = 32 * p_warps<true>(), LDX = p_ldx<BQ>();
  constexpr bool OR = p_own_raw<true>(), TR = p_tile_raw<true>();
  extern __shared__ float smf[];
  float* ks = smf;                         // [R][LD] the block's keys
  float* vs = ks + R * LD;                 // [R][LD] their values
  float* ksm = vs + R * LD;                // [R][LD] small halves, where
  float* vsm = ksm + (OR ? 0 : R * LD);    //   split once
  float* qt = vsm + (OR ? 0 : R * LD);     // [2][BQ][LD] queries
  float* ot = qt + 2 * BQ * LD;            // [2][BQ][LD] their dO
  float* qsm = ot + 2 * BQ * LD;           // [BQ][LD] small halves, where
  float* osm = qsm + (TR ? 0 : BQ * LD);   //   split once
  float* ls = osm + (TR ? 0 : BQ * LD);    // [2][BQ] their lse
  float* dl = ls + 2 * BQ;                 // [2][BQ] their delta
  float* ex = dl + 2 * BQ;                 // [R / 16][16][LDX] P^T
  const int nb = (a.sk + R - 1) / R;
  const int bh = blockIdx.x / nb;
  const int k0 = (blockIdx.x % nb) * R;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pr = w >> 1, role = w & 1;     // 0: S^T, P^T, dv; 1: dP^T, dk
  const int c0 = k0 + 16 * pr;             // the pair's first key
  const float* q = static_cast<const float*>(a.q) + bh * a.q_bh;
  const float* dob = dout + bh * do_bh;
  const float* lsb = lse + (long long)bh * a.sq;
  const float* dlb = delta + (long long)bh * a.sq;
  // the query tiles that see the block's keys (with the causal mask)
  const int nqt = (a.sq + BQ - 1) / BQ;
  int qt0 = 0;
  if (a.causal) {
    const int need = a.k_start + k0 - a.q_start;
    qt0 = need <= 0 ? 0 : min(nqt, need / BQ);
  }
  stage<D, NT>(ks, static_cast<const float*>(a.k) + bh * a.k_bh, a.k_s, k0,
               R, a.sk);
  stage<D, NT>(vs, static_cast<const float*>(a.v) + bh * a.v_bh, a.v_s, k0,
               R, a.sk);
  if (qt0 < nqt) {
    stage<D, NT>(qt + (qt0 & 1) * BQ * LD, q, a.q_s, qt0 * BQ, BQ, a.sq);
    stage<D, NT>(ot + (qt0 & 1) * BQ * LD, dob, do_s, qt0 * BQ, BQ, a.sq);
    stage_vec<D, NT>(ls + (qt0 & 1) * BQ, lsb, qt0 * BQ, BQ, a.sq);
    stage_vec<D, NT>(dl + (qt0 & 1) * BQ, dlb, qt0 * BQ, BQ, a.sq);
  }
  cp_commit();
  // the pair's first key: a causal tile wholly before it is skipped, as is
  // everything by a pair whose keys all lie past Sk
  const int wfirst = a.k_start + c0 - a.q_start;
  const bool keys_in = c0 < a.sk;
  cp_wait_all();
  __syncthreads();
  if constexpr (!OR) {
    split_rows<D, NT>(ks, ksm, R);
    split_rows<D, NT>(vs, vsm, R);
  }
  // the warp's operand of the first product: K (role 0) or V (role 1)
  const int wo = 16 * pr * LD;
  const float* own = (role ? vs : ks) + wo;
  const float* own_sm = (role ? vsm : ksm) + wo;
  float* px = ex + pr * 16 * LDX;
  float acc[ND][4];                        // dv (role 0) or dk (role 1)
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  for (int it = qt0; it < nqt; ++it) {
    const int buf = it & 1;
    cp_wait_all();
    __syncthreads();                       // tile it landed, it - 1 read
    if (it + 1 < nqt) {
      const int nx = (it + 1) * BQ;
      stage<D, NT>(qt + (buf ^ 1) * BQ * LD, q, a.q_s, nx, BQ, a.sq);
      stage<D, NT>(ot + (buf ^ 1) * BQ * LD, dob, do_s, nx, BQ, a.sq);
      stage_vec<D, NT>(ls + (buf ^ 1) * BQ, lsb, nx, BQ, a.sq);
      stage_vec<D, NT>(dl + (buf ^ 1) * BQ, dlb, nx, BQ, a.sq);
    }
    cp_commit();
    float* qb = qt + buf * BQ * LD;
    float* ob = ot + buf * BQ * LD;
    const float* lb = ls + buf * BQ;
    const float* db = dl + buf * BQ;
    if constexpr (!TR) {
      split_rows<D, NT>(qb, qsm, BQ);
      split_rows<D, NT>(ob, osm, BQ);
      __syncthreads();
    }
    const int qb0 = it * BQ;
    if (!keys_in || (a.causal && qb0 + BQ - 1 < wfirst)) continue;
    float x[NQ][4];
    product_t<ND, NQ, LD, OR, TR, p_chain<true>()>(
        x, own, own_sm, role ? ob : qb, role ? osm : qsm);  // KQ^T, VdO^T
    if (role == 0) {                       // P^T, undropped, to the pair
      // the unmasked path taken inside the loop: as a branch around it
      // (dq's form), or with no unmasked path, the plain form spilled 4-52
      // bytes at 255 registers (flash_f32_ab.py d256ops)
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * n + 2 * t + (i & 1);
          if (!EXTRA && all_visible(a, qb0, BQ, c0, 16)) {
            x[n][i] = ex2(x[n][i] * a.scale * kLog2e - lb[c] * kLog2e);
            continue;
          }
          const float sc = score2(a, bh, qb0 + c, c0 + g + 8 * (i >> 1),
                                  x[n][i]);
          x[n][i] = sc > kNegInf * 0.5f ? ex2(sc - lb[c] * kLog2e) : 0.f;
        }
      }
      tile_out<NQ, LDX>(px, x, g, t);
      pair_arrive(pr);
    }
    if (EXTRA && a.drop_inv > 0.f) {       // P^T, dP^T where kept, rescaled
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[n][i] = keep(a, bh, qb0 + 8 * n + 2 * t + (i & 1),
                         c0 + g + 8 * (i >> 1)) ? x[n][i] * a.drop_inv : 0.f;
        }
      }
    }
    if (role == 1) {                       // dS^T, P^T read pair by pair
      pair_sync(pr);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(db + 8 * n +
                                                           2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 p2 = *reinterpret_cast<const float2*>(
              px + (g + 8 * h) * LDX + 8 * n + 2 * t);
          x[n][2 * h] = p2.x * (x[n][2 * h] - d2.x);
          x[n][2 * h + 1] = p2.y * (x[n][2 * h + 1] - d2.y);
        }
      }
    }
    product_n<NQ, ND, LD, TR, p_group<true>()>(
        acc, x, role ? qb : ob, role ? qsm : osm, g,
        t);                                // dv += P^T dO, dk += dS^T Q
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = c0 + g + 8 * h;
    if (kj >= a.sk) continue;
    float* out = (role ? dk : dv) + ((long long)bh * a.sk + kj) * D + 2 * t;
    const float sc = role ? a.scale : 1.f;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * h] * sc, acc[n][2 * h + 1] * sc);
    }
  }
}

// ---- host ------------------------------------------------------------

// a block's rows, and its shared memory: the block's rows (the forward's
// one set, the backward's two) and the two double-buffered tiles, each
// split into big (in place) and small halves; for dk/dv also the tiles'
// lse and delta
int f32_rows(int d) {
  return d <= 64 ? f_rows<64>() : d <= 128 ? f_rows<128>() : f_rows<256>();
}
int smem_f32_fwd(int d) {
  const int tile = d <= 64 ? f_fwd_tile<64>()
                   : d <= 128 ? f_fwd_tile<128>() : f_fwd_tile<256>();
  return 4 * (d + 4) * (2 * f32_rows(d) + 6 * tile);
}
int smem_f32_dq(int d) {
  const int tile = d <= 64 ? f_tile<64, false>() : f_tile<128, false>();
  return 4 * (d + 4) * (4 * f32_rows(d) + 6 * tile);
}
int smem_f32_dkv(int d) {
  const int tile = d <= 64 ? f_tile<64, true>() : f_tile<128, true>();
  return 4 * (d + 4) * (4 * f32_rows(d) + 6 * tile) + 4 * 4 * tile;
}
// at D 256 (the pair kernels): the block's own rows (raw, or big and
// small), the double-buffered tiles (raw, or beside one set of small
// halves), the pairs' exchanged tiles (dq's both warps', dk/dv's P^T) and
// dk/dv's lse and delta
template <bool KV>
int smem_f32_pair() {
  constexpr int T = p_tile<KV>(), R = p_rows<KV>();
  constexpr int rows = R * (p_own_raw<KV>() ? 2 : 4) +
                       T * (p_tile_raw<KV>() ? 4 : 6);
  return 4 * ((256 + 4) * rows + R * (KV ? 1 : 2) * p_ldx<T>() +
              (KV ? 4 * T : 0));
}
// a block's rows (queries for dq, keys for dk/dv) and threads
int f32_bwd_rows(int d, bool kv) {
  return d != 256 ? f32_rows(d) : kv ? p_rows<true>() : p_rows<false>();
}
int f32_bwd_threads(int d, bool kv) {
  return d != 256 ? 2 * f32_rows(d)        // 32 a warp of 16 rows
         : 32 * (kv ? p_warps<true>() : p_warps<false>());
}

}  // namespace
}  // namespace apex_port

// Every entry point takes the simple form's arguments
// (csrc/flash_simt.cu): q, k, v, dout [bh, s, d] fp32 (dtype code 0), d 64,
// 128 or 256, read through their strides (elements; the last dim
// contiguous, rows 16-byte aligned); lse, delta fp32 [bh, sq] contiguous; kvb null or
// fp32 [1|bh, sk] with bh stride kvb_bh (0 when shared); bias null or fp32
// [1|bh, sq, sk] contiguous with bh stride bias_bh (0 when shared);
// dropout when drop_inv = 1 / (1 - rate) > 0, keeping an element whose
// hash under seed is >= drop_thresh. Outputs fp32 contiguous. Each returns
// cudaGetLastError() after its launch.

// o [bh, sq, d] and lse [bh, sq].
extern "C" int apex_flash_f32_fwd(int dtype, const void* q, const void* k,
                                  const void* v, void* o, void* lse,
                                  long long q_bh, long long q_s,
                                  long long k_bh, long long k_s,
                                  long long v_bh, long long v_s,
                                  const void* kvb, long long kvb_bh,
                                  const void* bias, long long bias_bh,
                                  unsigned seed, unsigned drop_thresh,
                                  float drop_inv, int bh, int sq, int sk,
                                  int d, int q_start, int k_start,
                                  int causal, float scale, void* stream) {
  using namespace apex_port;
  const int blocks = (sq + f32_rows(d) - 1) / f32_rows(d);
  if (dtype != kF32 || o == nullptr || lse == nullptr ||
      bad(bh, sq, sk, d, blocks, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  with_form<true>(d, a, [&](auto dc, auto extra) {
    err = f32_launch(
        f32_fwd_kernel<decltype(dc)::value, decltype(extra)::value>,
        smem_f32_fwd(d), blocks, bh, 2 * f32_rows(d), st, a,
        static_cast<float*>(o),
        static_cast<float*>(lse));
  });
  return static_cast<int>(err);
}

// dq [bh, sq, d]; ds null or fp32 [bh, sq, sk] (the per-bh bias gradient).
extern "C" int apex_flash_f32_dq(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dq, void* ds, long long q_bh,
                                 long long q_s, long long k_bh,
                                 long long k_s, long long v_bh,
                                 long long v_s, long long do_bh,
                                 long long do_s, const void* kvb,
                                 long long kvb_bh, const void* bias,
                                 long long bias_bh, unsigned seed,
                                 unsigned drop_thresh, float drop_inv,
                                 int bh, int sq, int sk, int d, int q_start,
                                 int k_start, int causal, float scale,
                                 void* stream) {
  using namespace apex_port;
  const int rows = f32_bwd_rows(d, false);
  const int blocks = (sq + rows - 1) / rows;
  if (dtype != kF32 || dq == nullptr || bad(bh, sq, sk, d, blocks, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = f32_bwd_threads(d, false);
  cudaError_t err = cudaErrorInvalidValue;
  auto launch = [&](auto kernel, int bytes) {
    err = f32_launch(kernel, bytes, blocks, bh, threads, st, a,
                     static_cast<const float*>(dout), do_bh, do_s,
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta), static_cast<float*>(dq),
                     static_cast<float*>(ds));
  };
  if (d == 256) {
    with_extra(a, [&](auto extra) {
      launch(f32_dq_pair_kernel<decltype(extra)::value>,
             smem_f32_pair<false>());
    });
  } else {
    with_form(d, a, [&](auto dc, auto extra) {
      launch(f32_dq_kernel<decltype(dc)::value, decltype(extra)::value>,
             smem_f32_dq(d));
    });
  }
  return static_cast<int>(err);
}

// dk, dv [bh, sk, d].
extern "C" int apex_flash_f32_dkv(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, long long q_bh,
                                  long long q_s, long long k_bh,
                                  long long k_s, long long v_bh,
                                  long long v_s, long long do_bh,
                                  long long do_s, const void* kvb,
                                  long long kvb_bh, const void* bias,
                                  long long bias_bh, unsigned seed,
                                  unsigned drop_thresh, float drop_inv,
                                  int bh, int sq, int sk, int d, int q_start,
                                  int k_start, int causal, float scale,
                                  void* stream) {
  using namespace apex_port;
  const int rows = f32_bwd_rows(d, true);
  const int blocks = (sk + rows - 1) / rows;
  if (dtype != kF32 || bad(bh, sq, sk, d, blocks, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = f32_bwd_threads(d, true);
  cudaError_t err = cudaErrorInvalidValue;
  auto launch = [&](auto kernel, int bytes) {
    err = f32_launch(kernel, bytes, blocks, bh, threads, st, a,
                     static_cast<const float*>(dout), do_bh, do_s,
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta), static_cast<float*>(dk),
                     static_cast<float*>(dv));
  };
  if (d == 256) {
    with_extra(a, [&](auto extra) {
      launch(f32_dkv_pair_kernel<decltype(extra)::value>,
             smem_f32_pair<true>());
    });
  } else {
    with_form(d, a, [&](auto dc, auto extra) {
      launch(f32_dkv_kernel<decltype(dc)::value, decltype(extra)::value>,
             smem_f32_dkv(d));
    });
  }
  return static_cast<int>(err);
}
