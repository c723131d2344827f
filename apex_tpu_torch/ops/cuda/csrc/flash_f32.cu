// Flash attention over [BH, S, D] fp32 (D 64 or 128; the forward also 256)
// on the tensor cores in 3xTF32: the forward (o and the per-row lse, by the
// online softmax),
// dq (with the per-bh bias gradient dS when asked) and dk/dv, the two
// recomputing the probabilities from the forward's lse. The semantics they
// keep from the Pallas kernels are csrc/flash_common.cuh's: causal masking
// by absolute positions, the per-key kv_bias and the full bias, dropout by
// the JAX package's coordinate hash, the finite kNegInf, the value guard.
//
// Replaces, for fp32 inputs at a head dim up to 128 (padded to 64 or 128),
// the Pallas kernels of apex_tpu/contrib/multihead_attn/flash_attention.py:
// _fwd_kernel (:181), _bwd_dq_kernel (:349) and _bwd_dkv_kernel (:392),
// with the recompute of _recompute_p_ds (:309-346); _fwd_kernel also at a
// head dim of 129 to 256 (padded to 256). The simple form
// (csrc/flash_simt.cu) keeps the rest past 128 and the fp32 shared-bias
// gradient.
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
// Tiles wholly past the causal edge are skipped, by the block and by each
// warp; a warp whose 16 rows see all of a tile with no bias or dropout
// takes the unmasked path. Each block owns its output rows and writes
// them once, without atomics, so every output repeats bit for bit.

#include "flash_common.cuh"

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

// ---- 3xTF32 ------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a b on one m16n8k8 tile: TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a b on one m16n8k8 tile, the accumulator starting at 0
__device__ __forceinline__ void mma_tf32_new(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// c[n] += A B_n (with NEW, c[n] = A B_n) for the n-tiles n < N of one
// k-step in 3xTF32: A split into (ab, as); bfrag(n, bb, bs) gives B_n's
// two values, split. Eight n-tiles at a time: each pass over them issues
// independent products between the three that share an accumulator.
template <bool NEW, int N, typename F>
__device__ __forceinline__ void mma3(float (&c)[N][4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], F&& bfrag) {
  constexpr int G = N < 8 ? N : 8;
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += G) {
    uint32_t bb[G][2], bs[G][2];
#pragma unroll
    for (int n = 0; n < G; ++n) bfrag(n0 + n, bb[n], bs[n]);
#pragma unroll
    for (int n = 0; n < G; ++n) {
      if (NEW) mma_tf32_new(c[n0 + n], as, bb[n]);
      else mma_tf32(c[n0 + n], as, bb[n]);
    }
#pragma unroll
    for (int n = 0; n < G; ++n) mma_tf32(c[n0 + n], ab, bs[n]);
#pragma unroll
    for (int n = 0; n < G; ++n) mma_tf32(c[n0 + n], ab, bb[n]);
  }
}

// Four 8 x 4 fp32 matrices from shared memory, as ldmatrix moves four 8 x
// 8 16-bit ones: lane l gives the address of row l % 8 of matrix l / 8 (16
// bytes) and receives, of each matrix, the element (l / 4, l % 4). That is
// an m16n8k8 TF32 fragment of a K-major operand: A's a0-a3 from rows 0-7
// and 8-15 at columns k and k + 4, or B's b0, b1 of two n-tiles.
__device__ __forceinline__ void ldm4(uint32_t (&x)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// two of them (lanes 0-15 give the addresses): B's b0, b1 of one n-tile
__device__ __forceinline__ void ldm2(uint32_t (&x)[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(x[0]), "=r"(x[1])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// c [16 x 8N] = A B^T over a depth of 8K, both K-major in shared memory
// with row stride LD and split into big and small halves (ab, as: the
// warp's 16 rows; bb, bs: the tile's 8N rows), their fragments loaded by
// ldm4: four for A's halves and four for B's of two n-tiles, where one
// load a value would take sixteen. The tensor cores add into an
// accumulator rounding toward zero, one rounding a product: a chain of 3K
// into c would leave scores and dP 3K ulps low, which a peaked row's dS
// shows past fp32's rule. So each pair of k-steps goes into a fresh
// accumulator (6 products), added to c in fp32 (to nearest).
template <int K, int N, int LD>
__device__ __forceinline__ void product_t(float (&c)[N][4], const float* ab,
                                          const float* as, const float* bb,
                                          const float* bs) {
  const int m = (threadIdx.x >> 3) & 3, r = threadIdx.x & 7;
  float step[N][4];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int aat = ((m & 1) * 8 + r) * LD + 8 * kk + (m >> 1) * 4;
    uint32_t a_b[4], a_s[4];
    ldm4(a_b, ab + aat);
    ldm4(a_s, as + aat);
    uint32_t fb[N][2], fs[N][2];
    if constexpr (N == 1) {
      const int bat = r * LD + 8 * kk + (m & 1) * 4;
      ldm2(fb[0], bb + bat);
      ldm2(fs[0], bs + bat);
    }
#pragma unroll
    for (int n = 0; n + 1 < N; n += 2) {
      const int bat = (8 * (n + (m >> 1)) + r) * LD + 8 * kk + (m & 1) * 4;
      uint32_t x[4];
      ldm4(x, bb + bat);
      fb[n][0] = x[0];
      fb[n][1] = x[1];
      fb[n + 1][0] = x[2];
      fb[n + 1][1] = x[3];
      ldm4(x, bs + bat);
      fs[n][0] = x[0];
      fs[n][1] = x[1];
      fs[n + 1][0] = x[2];
      fs[n + 1][1] = x[3];
    }
    auto bfrag = [&](int n, uint32_t (&b)[2], uint32_t (&s)[2]) {
      b[0] = fb[n][0];
      b[1] = fb[n][1];
      s[0] = fs[n][0];
      s[1] = fs[n][1];
    };
    if (kk < 2) {                          // the first pair: into c
      if (kk == 0) mma3<true>(c, a_b, a_s, bfrag);
      else mma3<false>(c, a_b, a_s, bfrag);
    } else if (kk % 2 == 0) {
      mma3<true>(step, a_b, a_s, bfrag);
    } else {
      mma3<false>(step, a_b, a_s, bfrag);
#pragma unroll
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) c[n][i] += step[n][i];
      }
    }
  }
}

// acc [16 x 8N] += P B over a depth of 8K: P [16 x 8K] in the accumulator
// layout of product_t (lane (g, t) holds columns 2t, 2t + 1 of rows g and
// g + 8 in each of its K tiles), split here; B [8K][8N] split (bb, bs) in
// shared memory with row stride LD, read across rows. The k index is
// permuted: A's k = t is P's column 2t and k = t + 4 its column 2t + 1, so
// B's k = t is the tile's row 2t and k = t + 4 its row 2t + 1. The tensor
// cores add into an accumulator rounding toward zero, so over thousands of
// keys the bias would pass fp32's rule: the tile's products go into a
// fresh accumulator (3K additions), added to acc in fp32 (to nearest).
template <int K, int N, int LD>
__device__ __forceinline__ void product_n(float (&acc)[N][4],
                                          const float (&p)[K][4],
                                          const float* bb, const float* bs,
                                          int g, int t) {
  constexpr int G = N < 8 ? N : N == 8 ? 8 : 4;
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += G) {
    float tile[G][4];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint32_t ab[4], as[4];
      split(p[j][0], ab[0], as[0]);        // (g, 2t)
      split(p[j][2], ab[1], as[1]);        // (g + 8, 2t)
      split(p[j][1], ab[2], as[2]);        // (g, 2t + 1)
      split(p[j][3], ab[3], as[3]);        // (g + 8, 2t + 1)
      const int at = (8 * j + 2 * t) * LD + 8 * n0 + g;
      auto bfrag = [&](int n, uint32_t (&b)[2], uint32_t (&s)[2]) {
        b[0] = __float_as_uint(bb[at + 8 * n]);
        b[1] = __float_as_uint(bb[at + LD + 8 * n]);
        s[0] = __float_as_uint(bs[at + 8 * n]);
        s[1] = __float_as_uint(bs[at + LD + 8 * n]);
      };
      if (j == 0) mma3<true>(tile, ab, as, bfrag);
      else mma3<false>(tile, ab, as, bfrag);
    }
#pragma unroll
    for (int n = 0; n < G; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n0 + n][i] += tile[n][i];
    }
  }
}

// ---- staging -----------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// rows [row0, row0 + n) of a [rows, D] fp32 matrix (row stride rs
// elements, rows 16-byte aligned) into dst [n][D + 4], zeros past `rows`;
// all threads issue, the caller commits
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long rs, int row0, int n,
                                      int rows) {
  constexpr int C = D / 4;                 // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * C; i += 32 * f_warps<D>()) {
    const int r = i / C, c = i % C;
    const bool in = row0 + r < rows;
    cp_async16(dst + r * f_ld<D>() + 4 * c,
               in ? src + (long long)(row0 + r) * rs + 4 * c : src, in);
  }
}

// n fp32 values from src[row0..] into dst, zeros past `rows`
template <int D>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int row0, int n, int rows) {
  for (int i = threadIdx.x; i < n; i += 32 * f_warps<D>()) {
    const bool in = row0 + i < rows;
    cp_async4(dst + i, in ? src + row0 + i : src, in);
  }
}

// Staged rows [0, n) split once for every warp that reads them: big =
// tf32(x) in place of x, small = tf32(x - big) at the same place of
// `small`; all threads, four elements a step
template <int D>
__device__ __forceinline__ void split_rows(float* rows, float* small, int n) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < n * C; i += 32 * f_warps<D>()) {
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

// 2^x by one special-function instruction, results below 2^-126 flushed
// to zero. exp2f keeps those subnormal, at more instructions; here such a
// p or alpha lies far below an ulp of l >= 1, and the forward took 10%
// less time with this (PERF.md)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the max and the sum over the quad of lanes (4g to 4g + 3) that holds
// one row of an accumulator tile
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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

template <typename K, typename... Args>
cudaError_t f32_launch(K kernel, int bytes, int blocks, int bh, int d,
                       cudaStream_t st, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int threads = 2 * f32_rows(d);     // 32 a warp of 16 rows
  kernel<<<static_cast<unsigned>(blocks * bh), threads, bytes, st>>>(
      args...);
  return cudaGetLastError();
}

}  // namespace
}  // namespace apex_port

// Every entry point takes the simple form's arguments
// (csrc/flash_simt.cu): q, k, v, dout [bh, s, d] fp32 (dtype code 0), d 64
// or 128 (the forward also 256), read through their strides (elements; the last dim contiguous,
// rows 16-byte aligned); lse, delta fp32 [bh, sq] contiguous; kvb null or
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
        smem_f32_fwd(d), blocks, bh, d, st, a, static_cast<float*>(o),
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
  const int blocks = (sq + f32_rows(d) - 1) / f32_rows(d);
  if (dtype != kF32 || dq == nullptr || bad(bh, sq, sk, d, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  with_form(d, a, [&](auto dc, auto extra) {
    err = f32_launch(f32_dq_kernel<decltype(dc)::value, decltype(extra)::value>,
                     smem_f32_dq(d), blocks, bh, d, st, a,
                     static_cast<const float*>(dout), do_bh, do_s,
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta), static_cast<float*>(dq),
                     static_cast<float*>(ds));
  });
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
  const int blocks = (sk + f32_rows(d) - 1) / f32_rows(d);
  if (dtype != kF32 || bad(bh, sq, sk, d, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  with_form(d, a, [&](auto dc, auto extra) {
    err = f32_launch(
        f32_dkv_kernel<decltype(dc)::value, decltype(extra)::value>,
        smem_f32_dkv(d), blocks, bh, d, st, a,
        static_cast<const float*>(dout),
        do_bh, do_s, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dk),
        static_cast<float*>(dv));
  });
  return static_cast<int>(err);
}
