// Flash attention's forward, dq and dk/dv over [BH, S, D] fp32 at head
// dims 257-512 (run at 384 or 512) on the tensor cores in 3xTF32. The semantics
// they keep from the Pallas kernels are csrc/flash_common.cuh's: causal
// masking by absolute positions, the per-key kv_bias and the full bias,
// dropout by the JAX package's coordinate hash, the finite kNegInf, the
// value guard. The products, splits, staging copies and pair exchanges
// are csrc/flash_f32.cuh's, shared with the kernels at D <= 256
// (csrc/flash_f32.cu), and so is the precision scheme: each operand split
// into big = tf32(x) and small = tf32(x - big), each product small·big +
// big·small + big·big, every pair of k-steps and every tile's second
// product from a fresh accumulator added in fp32 (flash_f32.cu items 4-5).
//
// Replaces, for fp32 inputs at a head dim of 257 to 512, the Pallas
// kernels of apex_tpu/contrib/multihead_attn/flash_attention.py:
// _flash_fwd -> _fwd_kernel (:181) and _bwd_pallas -> _bwd_dq_kernel
// (:349) and _bwd_dkv_kernel (:392), at the head dims the JAX package pads
// to 384 and 512 lanes, with every input they take (the full bias,
// kv_bias, dropout; dq's per-bh dS).
//
// Bound on this card: operations. At [32, 1024, 320] causal (1.68e7 live
// (query, key) pairs) the forward's two products are 4·D·pairs = 21.5
// GFLOP, dq's three 32.2 GFLOP and dk/dv's four 43.0 GFLOP: in 3xTF32
// (three TF32 products for each fp32 one, at the 495 TFLOP/s of TF32
// dense: 165 TFLOP/s) 0.130, 0.195 and 0.261 ms, at the 67 TFLOP/s of
// fp32 FMAs 0.321, 0.481 and 0.642 ms; run at D 384 they do 1.2x the
// products. The bytes (~176, ~220 and ~264 MB) take ~0.06-0.08 ms.
//
// What holds the D <= 256 design back past 256 is two walls. Registers: a
// warp's O (or dq) over 16 rows is 16 x D fp32, 192 registers a thread at
// D 384 and 256 at 512, past the 255 a thread may hold before S, P and
// the fragments. Shared memory: a staged row split in two is 2 x (D + 4)
// floats, 3104 bytes at D 384 and 4128 at 512, so the D-256 forward's 64
// split query rows alone would take 199 KB at D 384 of the 227 KB a block
// may have. So here, as the D-256 dq (flash_f32.cu item 8) crossed with
// the bf16 split over D (csrc/flash_d512.cu):
// 1. A pair of warps shares 16 query rows, each warp holding half of O's
//    (or dq's) columns, [h D / 2, (h + 1) D / 2): 96 registers a thread at
//    D 384, 128 at 512.
// 2. The forward's warps each take Q K^T over their half of D and trade
//    the 16 x tile partial scores through shared memory under the pair's
//    named barrier; each adds the other's to its own, and fp32 addition
//    commutes, so both hold the same scores bit for bit, apply the same
//    online softmax and take P V over their own half of V's columns.
//    Taking Q K^T over all of D in each warp (1.5x the products, no trade)
//    lost by 2-13% in bf16 (flash_d512_ab.py, full_s), and in 3xTF32 the
//    products cost more.
// 3. dq's warp 0 makes S = Q K^T and P (undropped), warp 1 dP = dO V^T
//    (dropped and rescaled), each over all of D; they trade them, both
//    form dS = P (dP' - delta), and each adds dS K into its half of dq's
//    columns: the D-256 pair kernel's scheme (f32_dq_pair_kernel).
//    Where one key takes most of a row's softmax (p > kDomP: the first
//    causal row, a row all but one key of which is masked, a peaked row)
//    dS = p (dP - delta) cancels, and the plain version's dS there is
//    mostly its own fp32 product's rounding (its dq up to 1.21x of the
//    rule from an fp64 one at BH 128: flash_f32_dq_check.py rule), and
//    3xTF32's dP, closer to the exact one, missed the rule there (1.04x
//    at D 320, BH 128, causal: test_f32_dq_holds_the_fp32_rule_at_bh_128
//    in tests/test_torch_cuda.py). So dq
//    takes dP of those (query, key) again as that product forms it, one
//    fp32 fma at a time over the real columns in ascending order
//    (dp_chain, as csrc/flash_dbias.cu's chunk_dp), in both warps alike.
// 4. Rows kept raw in shared memory and split as each warp loads them
//    (split_raw), which halves them: the block's rows and the double-
//    buffered key and value tiles fit at the shapes below.
// 5. No padded copy: the real columns [0, dw) of each row arrive by
//    16-byte cp.async (dw, the tensors' width, a multiple of 4), and the
//    columns [dw, D) of every staged row are zeroed once at the start and
//    never written again. They add nothing to Q K^T or dO V^T, give zero
//    columns of O (or dq, dk, dv), which are not written.
// 6. dk/dv holds two accumulators over its keys, twice the forward's
//    register wall: a pair of warps over 16 keys would hold 192 or 256
//    registers a thread each. So a quad of warps shares 16 keys, each
//    holding half of one accumulator's columns (96 registers at D 384, 128
//    at 512): warps 0 and 1 dv's halves, warps 2 and 3 dk's. Warps 0 and 1
//    take S^T = K Q^T over their halves of D, warps 2 and 3 dP^T = V dO^T
//    over theirs, and the four partial tiles are traded under the quad's
//    named barrier. Every warp then adds S^T's two halves in one order and
//    forms P^T from them by the same instructions, so all four hold the
//    same P^T bit for bit with no second hand-over; warps 2 and 3 add
//    dP^T's halves and form dS^T = P^T (dP'^T - delta). Warps 0 and 1 add
//    P^T dO (dropped and rescaled) into dv, warps 2 and 3 dS^T Q into dk
//    (scaled at the end). The four products each run once, on raw rows
//    split as read; the block's keys and values and the double-buffered
//    query and dO tiles are the shared memory.
// The block's shape (pairs or quads, rows a staged tile) is xf_* for the
// forward, xq_* for dq and xk_* for dk/dv, set by the times of
// flash_f32_ab.py d512 and d512dkv on the H100 (PERF.md). Tiles wholly past the causal edge are skipped, by the block
// and by each pair; a pair whose 16 rows see all of a tile with no bias or
// dropout takes the unmasked path. Each block owns its output rows and
// writes them once, without atomics, so every output repeats bit for bit.
// The grid is one dim, bh-major, each bh's longest rows first, so BH may
// pass 65535.

#include <initializer_list>

#include "flash_f32.cuh"

namespace apex_port {
namespace {

// The blocks by head dim (384 or 512): the pairs of warps (each owning 16
// query rows), the keys a staged tile holds, and whether the tiles are
// kept raw and split as each warp reads them (else split once as each
// lands, into big in place and small halves), for the forward (xf_) and
// dq (xq_); flash_f32_ab.py d512 rewrites these lines per variant
template <int D> __host__ __device__ constexpr int xf_pairs() {
  return D == 384 ? 4 : 4;
}
template <int D> __host__ __device__ constexpr int xf_tile() {
  return D == 384 ? 16 : 8;
}
template <int D> __host__ __device__ constexpr bool xf_raw() {
  return D == 384 ? true : true;
}
template <int D> __host__ __device__ constexpr int xq_pairs() {
  return D == 384 ? 3 : 2;
}
template <int D> __host__ __device__ constexpr int xq_tile() {
  return D == 384 ? 8 : 8;
}
template <int D> __host__ __device__ constexpr bool xq_raw() {
  return D == 384 ? true : true;
}

// dk/dv's blocks by head dim: the quads of warps (each owning 16 keys), the
// queries a staged tile holds, and the n-tiles a pass of its second
// product takes (product_n's G0); flash_f32_ab.py d512dkv rewrites these
// lines per variant, and these timed fastest on the H100 (PERF.md)
template <int D> __host__ __device__ constexpr int xk_quads() {
  return D == 384 ? 2 : 2;
}
template <int D> __host__ __device__ constexpr int xk_tile() {
  return D == 384 ? 16 : 8;
}
template <int D> __host__ __device__ constexpr int xk_group() {
  return D == 384 ? 2 : 2;
}

// shared memory: the block's raw rows (the forward's Q; dq's Q and dO),
// the key and value tiles, double-buffered (and one set of their small
// halves where split once), and the pairs' exchanged tiles (both warps'
// of each pair)
template <int D> __host__ __device__ constexpr int smem_x_fwd() {
  return 4 * ((D + 4) * (16 * xf_pairs<D>() +
                         (xf_raw<D>() ? 4 : 6) * xf_tile<D>()) +
              2 * 16 * xf_pairs<D>() * p_ldx<xf_tile<D>()>());
}
template <int D> __host__ __device__ constexpr int smem_x_dq() {
  return 4 * ((D + 4) * (32 * xq_pairs<D>() +
                         (xq_raw<D>() ? 4 : 6) * xq_tile<D>()) +
              2 * 16 * xq_pairs<D>() * p_ldx<xq_tile<D>()>());
}
// dk/dv's: the block's keys and values raw, the double-buffered query and
// dO tiles, their lse and delta, and the quads' four exchanged tiles
template <int D> __host__ __device__ constexpr int smem_x_dkv() {
  return 4 * ((D + 4) * (32 * xk_quads<D>() + 4 * xk_tile<D>()) +
              4 * xk_tile<D>() + 64 * xk_quads<D>() * p_ldx<xk_tile<D>()>());
}
static_assert(smem_x_fwd<384>() <= 232448 && smem_x_fwd<512>() <= 232448 &&
                  smem_x_dq<384>() <= 232448 && smem_x_dq<512>() <= 232448 &&
                  smem_x_dkv<384>() <= 232448 && smem_x_dkv<512>() <= 232448,
              "a block may have 227 KB of shared memory");

// rows [row0, row0 + n) of a [rows, dw] fp32 matrix (row stride rs
// elements, rows 16-byte aligned, dw a multiple of 4) into dst [n][D + 4]:
// the real columns, zeros past `rows`; warp w of NW takes rows w, w + NW,
// ..., its lanes the 16-byte chunks; the caller commits
template <int D, int NW>
__device__ __forceinline__ void stage_x(float* dst, const float* src,
                                        long long rs, int row0, int n,
                                        int rows, int dw) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = w; r < n; r += NW) {
    const bool in = row0 + r < rows;
    const float* s = src + (in ? (long long)(row0 + r) * rs : 0);
    for (int c = 4 * lane; c < dw; c += 128) {
      cp_async16(dst + r * (D + 4) + c, in ? s + c : src, in);
    }
  }
}

// the columns [dw, D) of rows [0, n) of dst [n][D + 4] set to zero
template <int D, int NW>
__device__ __forceinline__ void zero_pad(float* dst, int n, int dw) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = w; r < n; r += NW) {
    for (int c = dw + lane; c < D; c += 32) dst[r * (D + 4) + c] = 0.f;
  }
}

// n fp32 values from src[row0..] into dst by cp.async, zeros past `rows`;
// all NT threads, the caller commits
template <int NT>
__device__ __forceinline__ void stage_row_vec(float* dst, const float* src,
                                              int row0, int n, int rows) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool in = row0 + i < rows;
    cp_async4(dst + i, in ? src + row0 + i : src, in);
  }
}

// the named barrier of quad qd (0 is __syncthreads'), its 128 threads
__device__ __forceinline__ void quad_sync(int qd) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + qd) : "memory");
}

// staged rows [0, n) of rows [n][D + 4] split once for every warp that
// reads them: big = tf32(x) in place of x, small = tf32(x - big) at the
// same place of `small`; all NW warps, four elements a step
template <int D, int NW>
__device__ __forceinline__ void split_x(float* rows, float* small, int n) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < n * C; i += 32 * NW) {
    const int at = i / C * (D + 4) + 4 * (i % C);
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

// o [BH, Sq, dw] and lse [BH, Sq] fp32 contiguous. Lane (g, t) of warp h
// of pair pr holds rows g and g + 8 of the pair's 16: their running max m
// (log2 units) and sum l, the same in both warps, and their O columns h D
// / 2 + 8n + 2t, + 1.
template <int D, bool EXTRA>
__global__ void __launch_bounds__(64 * xf_pairs<D>(), 1)
f32x_fwd_kernel(Attn a, int dw, float* __restrict__ o,
                float* __restrict__ lse) {
  constexpr int LD = D + 4, H = D / 2, NH = H / 8;
  constexpr int PAIRS = xf_pairs<D>(), R = 16 * PAIRS, NW = 2 * PAIRS;
  constexpr int BK = xf_tile<D>(), NK = BK / 8, LDX = p_ldx<BK>();
  constexpr bool TR = xf_raw<D>();
  extern __shared__ float smf[];
  float* qs = smf;                         // [R][LD] the block's queries
  float* kt = qs + R * LD;                 // [2][BK][LD] keys
  float* vt = kt + 2 * BK * LD;            // [2][BK][LD] values
  float* ksm = vt + 2 * BK * LD;           // [BK][LD] small halves, where
  float* vsm = ksm + (TR ? 0 : BK * LD);   //   split once
  float* ex = vsm + (TR ? 0 : BK * LD);    // [PAIRS][2][16][LDX] scores
  const int nb = (a.sq + R - 1) / R;
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * R;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pr = w >> 1, half = w & 1;     // half: O's columns [half H, +H)
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
  if (dw < D) {                            // the columns no copy writes
    zero_pad<D, NW>(qs, R + (TR ? 4 : 6) * BK, dw);
  }
  stage_x<D, NW>(qs, static_cast<const float*>(a.q) + bh * a.q_bh, a.q_s, q0,
                 R, a.sq, dw);
  if (nt > 0) {
    stage_x<D, NW>(kt, k, a.k_s, 0, BK, a.sk, dw);
    stage_x<D, NW>(vt, v, a.v_s, 0, BK, a.sk, dw);
  }
  cp_commit();
  const float sl2 = a.scale * kLog2e;
  // the pair's last row: a causal tile wholly past it is skipped, as is
  // everything by a pair whose rows all lie past Sq
  const int wlast = a.q_start + min(r0 + 15, a.sq - 1) - a.k_start;
  const bool rows_in = r0 < a.sq;
  const float* own = qs + 16 * pr * LD + H * half;
  float* mine = ex + (2 * pr + half) * 16 * LDX;
  const float* theirs = ex + (2 * pr + (half ^ 1)) * 16 * LDX;
  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n) {
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
      stage_x<D, NW>(kt + (buf ^ 1) * BK * LD, k, a.k_s, nx, BK, a.sk, dw);
      stage_x<D, NW>(vt + (buf ^ 1) * BK * LD, v, a.v_s, nx, BK, a.sk, dw);
    }
    cp_commit();
    float* kb = kt + buf * BK * LD;
    float* vb = vt + buf * BK * LD;
    if constexpr (!TR) {
      split_x<D, NW>(kb, ksm, BK);
      split_x<D, NW>(vb, vsm, BK);
      __syncthreads();
    }
    const int k0 = it * BK;
    if (!rows_in || (a.causal && wlast < k0)) continue;   // pair-uniform
    float s[NK][4];
    product_t<NH, NK, LD, true, TR>(s, own, nullptr, kb + H * half,
                                    ksm + H * half);       // half of QK^T
    tile_out<NK, LDX>(mine, s, g, t);
    pair_sync(pr);
    {
      float y[NK][4];
      tile_in<NK, LDX>(y, theirs, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] += y[n][i];
      }
    }
    const bool open = !EXTRA && all_visible(a, r0, 16, k0, BK);
    // scores in log2 units (kNegInf where masked), the rows' new max
    float mx[2] = {m[0], m[1]};
    if (open) {                            // the pair's branch: uniform
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
    for (int n = 0; n < NH; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];
    }
    product_n<NK, NH, LD, TR>(acc, s, vb + H * half, vsm + H * half, g,
                              t);                          // O += P V
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + g + 8 * h;
    if (qi >= a.sq) continue;
    const long long row = (long long)bh * a.sq + qi;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 1.f;
    const int c0 = H * half + 2 * t;
    float* out = o + row * dw + c0;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      if (c0 + 8 * n < dw) {
        *reinterpret_cast<float2*>(out + 8 * n) =
            make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
      }
    }
    if (half == 0 && t == 0) {
      lse[row] = l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : kNegInf;
    }
  }
}

// the share of a row's softmax above which dq takes a (query, key)'s dP
// again by dp_chain (item 3)
constexpr float kDomP = 0.25f;

// dO·V of one (query, key) over the real columns [0, dw) of raw rows, one
// fp32 fma at a time in ascending column order from the sum's first term:
// the rounding of the plain version's fp32 product
__device__ __forceinline__ float dp_chain(const float* orow, const float* vrow,
                                          int dw) {
  float c = 0.f;
  for (int d = 0; d < dw; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(orow + d);
    const float4 y = *reinterpret_cast<const float4*>(vrow + d);
    c = fmaf(x.x, y.x, c);
    c = fmaf(x.y, y.y, c);
    c = fmaf(x.z, y.z, c);
    c = fmaf(x.w, y.w, c);
  }
  return c;
}

// dq [BH, Sq, dw] fp32 contiguous; ds null or fp32 [BH, Sq, Sk]
// contiguous: dS of every (query, key), unscaled, zeros where a tile is
// skipped. Warp 0 of a pair makes S = Q K^T and P (undropped: dS's
// weight), warp 1 dP = dO V^T (dropped and rescaled); each hands its tile
// to the other under the pair's barrier, both form dS = P (dP - delta),
// and warp h adds dS K into dq's columns [h D / 2, (h + 1) D / 2).
template <int D, bool EXTRA>
__global__ void __launch_bounds__(64 * xq_pairs<D>(), 1)
f32x_dq_kernel(Attn a, int dw, const float* __restrict__ dout,
               long long do_bh, long long do_s, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq,
               float* __restrict__ ds) {
  constexpr int LD = D + 4, H = D / 2, ND = D / 8, NH = ND / 2;
  constexpr int PAIRS = xq_pairs<D>(), R = 16 * PAIRS, NW = 2 * PAIRS;
  constexpr int BK = xq_tile<D>(), NK = BK / 8, LDX = p_ldx<BK>();
  constexpr bool TR = xq_raw<D>();
  extern __shared__ float smf[];
  float* qs = smf;                         // [R][LD] the block's queries
  float* os = qs + R * LD;                 // [R][LD] their dO
  float* kt = os + R * LD;                 // [2][BK][LD] keys
  float* vt = kt + 2 * BK * LD;            // [2][BK][LD] values
  float* ksm = vt + 2 * BK * LD;           // [BK][LD] small halves, where
  float* vsm = ksm + (TR ? 0 : BK * LD);   //   split once
  float* ex = vsm + (TR ? 0 : BK * LD);    // [PAIRS][2][16][LDX] P, dP'
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
  if (dw < D) {                            // the columns no copy writes
    zero_pad<D, NW>(qs, 2 * R + (TR ? 4 : 6) * BK, dw);
  }
  stage_x<D, NW>(qs, static_cast<const float*>(a.q) + bh * a.q_bh, a.q_s, q0,
                 R, a.sq, dw);
  stage_x<D, NW>(os, dout + bh * do_bh, do_s, q0, R, a.sq, dw);
  if (nt > 0) {
    stage_x<D, NW>(kt, k, a.k_s, 0, BK, a.sk, dw);
    stage_x<D, NW>(vt, v, a.v_s, 0, BK, a.sk, dw);
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
  // the warp's operand of the first products: Q (role 0) or dO (role 1)
  const float* own = (role ? os : qs) + 16 * pr * LD;
  float* mine = ex + (2 * pr + role) * 16 * LDX;
  const float* theirs = ex + (2 * pr + (role ^ 1)) * 16 * LDX;
  float acc[NH][4];                        // dq's columns H role + 8n + 2t
#pragma unroll
  for (int n = 0; n < NH; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    cp_wait_all();
    __syncthreads();                       // tile it landed, it - 1 read
    if (it + 1 < nt) {                     // the next tile, into the other
      const int nx = (it + 1) * BK;
      stage_x<D, NW>(kt + (buf ^ 1) * BK * LD, k, a.k_s, nx, BK, a.sk, dw);
      stage_x<D, NW>(vt + (buf ^ 1) * BK * LD, v, a.v_s, nx, BK, a.sk, dw);
    }
    cp_commit();
    float* kb = kt + buf * BK * LD;
    float* vb = vt + buf * BK * LD;
    if constexpr (!TR) {
      split_x<D, NW>(kb, ksm, BK);
      split_x<D, NW>(vb, vsm, BK);
      __syncthreads();
    }
    const int k0 = it * BK;
    float x[NK][4];
    const bool sees = rows_in && !(a.causal && wlast < k0);
    if (sees) {                            // the pair's branch: uniform
      product_t<ND, NK, LD, true, TR>(x, own, nullptr, role ? vb : kb,
                                      role ? vsm : ksm);   // QK^T, dOV^T
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
          float dp = role ? x[n][i] : y[n][i];
          if (p > kDomP) {                 // dS cancels: the plain rounding
            const int qr = g + 8 * (i >> 1), kr = 8 * n + 2 * t + (i & 1);
            static_assert(TR, "dp_chain reads raw rows");
            dp = dp_chain(os + (16 * pr + qr) * LD, vb + kr * LD, dw);
            if (EXTRA && a.drop_inv > 0.f)
              dp = keep(a, bh, r0 + qr, k0 + kr) ? dp * a.drop_inv : 0.f;
          }
          x[n][i] = p * (dp - dlt[i >> 1]);             // dS
        }
      }
      product_n<NK, NH, LD, TR>(acc, x, kb + H * role, ksm + H * role, g,
                                t);                        // dq += dS K
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
    const int c0 = H * role + 2 * t;
    float* out = dq + ((long long)bh * a.sq + qi) * dw + c0;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      if (c0 + 8 * n < dw) {
        *reinterpret_cast<float2*>(out + 8 * n) = make_float2(
            acc[n][2 * h] * a.scale, acc[n][2 * h + 1] * a.scale);
      }
    }
  }
}

// dk, dv [BH, Sk, dw] fp32 contiguous (item 6). Lane (g, t) of warp r of
// quad qd holds keys g and g + 8 of the quad's 16 and the columns H (r & 1)
// + 8n + 2t, + 1 of dv (r < 2) or dk (r >= 2).
template <int D, bool EXTRA>
__global__ void __launch_bounds__(128 * xk_quads<D>(), 1)
f32x_dkv_kernel(Attn a, int dw, const float* __restrict__ dout,
                long long do_bh, long long do_s, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv) {
  constexpr int LD = D + 4, H = D / 2, NH = H / 8;
  constexpr int QUADS = xk_quads<D>(), R = 16 * QUADS, NW = 4 * QUADS;
  constexpr int BQ = xk_tile<D>(), NQ = BQ / 8, LDX = p_ldx<BQ>();
  extern __shared__ float smf[];
  float* ks = smf;                         // [R][LD] the block's keys
  float* vs = ks + R * LD;                 // [R][LD] their values
  float* qt = vs + R * LD;                 // [2][BQ][LD] queries
  float* ot = qt + 2 * BQ * LD;            // [2][BQ][LD] their dO
  float* ls = ot + 2 * BQ * LD;            // [2][BQ] their lse
  float* dl = ls + 2 * BQ;                 // [2][BQ] their delta
  float* ex = dl + 2 * BQ;                 // [QUADS][4][16][LDX] tiles
  const int nb = (a.sk + R - 1) / R;
  const int bh = blockIdx.x / nb;
  const int k0 = (blockIdx.x % nb) * R;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qd = w >> 2, role = w & 3, half = role & 1;
  const bool kside = role >= 2;            // dP^T and dk, else S^T and dv
  const int c0 = k0 + 16 * qd;             // the quad's first key
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
  if (dw < D) {                            // the columns no copy writes
    zero_pad<D, NW>(ks, 2 * R + 4 * BQ, dw);
  }
  stage_x<D, NW>(ks, static_cast<const float*>(a.k) + bh * a.k_bh, a.k_s,
                 k0, R, a.sk, dw);
  stage_x<D, NW>(vs, static_cast<const float*>(a.v) + bh * a.v_bh, a.v_s,
                 k0, R, a.sk, dw);
  if (qt0 < nqt) {
    const int b0 = qt0 & 1;
    stage_x<D, NW>(qt + b0 * BQ * LD, q, a.q_s, qt0 * BQ, BQ, a.sq, dw);
    stage_x<D, NW>(ot + b0 * BQ * LD, dob, do_s, qt0 * BQ, BQ, a.sq, dw);
    stage_row_vec<32 * NW>(ls + b0 * BQ, lsb, qt0 * BQ, BQ, a.sq);
    stage_row_vec<32 * NW>(dl + b0 * BQ, dlb, qt0 * BQ, BQ, a.sq);
  }
  cp_commit();
  const float sl2 = a.scale * kLog2e;
  // the quad's first key: a causal tile wholly before it is skipped, as is
  // everything by a quad whose keys all lie past Sk
  const int wfirst = a.k_start + c0 - a.q_start;
  const bool keys_in = c0 < a.sk;
  // the warp's operand of the first product over its half of D: K (S^T)
  // or V (dP^T); its exchanged tile, and the quad's four
  const float* own = (kside ? vs : ks) + 16 * qd * LD + H * half;
  float* mine = ex + (4 * qd + role) * 16 * LDX;
  const float* xq = ex + 4 * qd * 16 * LDX;
  float acc[NH][4];                        // dv (role 0, 1), dk (2, 3)
#pragma unroll
  for (int n = 0; n < NH; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  for (int it = qt0; it < nqt; ++it) {
    const int buf = it & 1;
    cp_wait_all();
    __syncthreads();                       // tile it landed, it - 1 read
    if (it + 1 < nqt) {                    // the next tile, into the other
      const int nx = (it + 1) * BQ;
      stage_x<D, NW>(qt + (buf ^ 1) * BQ * LD, q, a.q_s, nx, BQ, a.sq, dw);
      stage_x<D, NW>(ot + (buf ^ 1) * BQ * LD, dob, do_s, nx, BQ, a.sq, dw);
      stage_row_vec<32 * NW>(ls + (buf ^ 1) * BQ, lsb, nx, BQ, a.sq);
      stage_row_vec<32 * NW>(dl + (buf ^ 1) * BQ, dlb, nx, BQ, a.sq);
    }
    cp_commit();
    const float* qb = qt + buf * BQ * LD;
    const float* ob = ot + buf * BQ * LD;
    const float* lb = ls + buf * BQ;
    const float* db = dl + buf * BQ;
    const int qb0 = it * BQ;
    if (!keys_in || (a.causal && qb0 + BQ - 1 < wfirst)) continue;   // quad
    float x[NQ][4];
    product_t<NH, NQ, LD, true, true>(x, own, nullptr,
                                      (kside ? ob : qb) + H * half,
                                      nullptr);     // half of KQ^T, VdO^T
    tile_out<NQ, LDX>(mine, x, g, t);
    quad_sync(qd);
    // S^T over all of D (warp 0's half plus warp 1's) and P^T from it, by
    // every warp of the quad alike
    float p[NQ][4];
    tile_in<NQ, LDX>(p, xq, g, t);
    tile_in<NQ, LDX>(x, xq + 16 * LDX, g, t);
    const bool open = !EXTRA && all_visible(a, qb0, BQ, c0, 16);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * n + 2 * t + (i & 1);
        const float s = p[n][i] + x[n][i];
        const float lse2 = lb[c] * kLog2e;
        if (open) {                        // the quad's branch: uniform
          p[n][i] = ex2(fmaf(s, sl2, -lse2));
        } else {
          const float sc = score2(a, bh, qb0 + c, c0 + g + 8 * (i >> 1), s);
          p[n][i] = sc > kNegInf * 0.5f ? ex2(sc - lse2) : 0.f;
        }
      }
    }
    if (!kside) {
      if (EXTRA && a.drop_inv > 0.f) {     // P^T where kept, rescaled
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            p[n][i] = keep(a, bh, qb0 + 8 * n + 2 * t + (i & 1),
                           c0 + g + 8 * (i >> 1)) ? p[n][i] * a.drop_inv
                                                  : 0.f;
          }
        }
      }
      product_n<NQ, NH, LD, true, xk_group<D>()>(
          acc, p, ob + H * half, nullptr, g, t);   // dv += P^T dO
    } else {
      // dP^T over all of D (warp 2's half plus warp 3's), dropped and
      // rescaled; dS^T = P^T (dP'^T - delta)
      float y[NQ][4];
      tile_in<NQ, LDX>(x, xq + 2 * 16 * LDX, g, t);
      tile_in<NQ, LDX>(y, xq + 3 * 16 * LDX, g, t);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * n + 2 * t + (i & 1);
          float dp = x[n][i] + y[n][i];
          if (EXTRA && a.drop_inv > 0.f) {
            dp = keep(a, bh, qb0 + c, c0 + g + 8 * (i >> 1))
                     ? dp * a.drop_inv : 0.f;
          }
          p[n][i] = p[n][i] * (dp - db[c]);
        }
      }
      product_n<NQ, NH, LD, true, xk_group<D>()>(
          acc, p, qb + H * half, nullptr, g, t);   // dk += dS^T Q
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = c0 + g + 8 * h;
    if (kj >= a.sk) continue;
    const int cc = H * half + 2 * t;
    float* out = (kside ? dk : dv) + ((long long)bh * a.sk + kj) * dw + cc;
    const float sc = kside ? a.scale : 1.f;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      if (cc + 8 * n < dw) {
        *reinterpret_cast<float2*>(out + 8 * n) =
            make_float2(acc[n][2 * h] * sc, acc[n][2 * h + 1] * sc);
      }
    }
  }
}

// what these kernels refuse: no rows; a width outside 257-512 or not a
// multiple of 4 (16 bytes); a row or bh stride not one; blocks * bh past
// 2^31 - 1
bool bad_x32(int bh, int sq, int sk, int d, int blocks,
             std::initializer_list<long long> strides) {
  bool odd = false;
  for (long long s : strides) odd = odd || s % 4 != 0;
  return bh < 1 || sq < 1 || sk < 1 || d <= 256 || d > 512 || d % 4 != 0 ||
         odd || blocks < 1 || (long long)blocks * bh > 0x7fffffffLL;
}

// calls f(D) with D (384 or 512, the head dim the kernels run a width d
// at) a compile-time constant
template <typename F>
void with_width(int d, F&& f) {
  if (d <= 384) f(std::integral_constant<int, 384>{});
  else f(std::integral_constant<int, 512>{});
}

}  // namespace
}  // namespace apex_port

// All three take the fp32 kernels' arguments at D <= 256
// (csrc/flash_f32.cu):
// q, k, v, dout [bh, s, d] fp32 (dtype code 0), d 260-512 and a multiple
// of 4, read through their strides (elements, multiples of 4; the last dim
// contiguous, the bases 16-byte aligned); lse, delta fp32 [bh, sq]
// contiguous; kvb null or fp32 [1|bh, sk] with bh stride kvb_bh (0 when
// shared); bias null or fp32 [1|bh, sq, sk] contiguous with bh stride
// bias_bh (0 when shared); dropout when drop_inv = 1 / (1 - rate) > 0,
// keeping an element whose hash under seed is >= drop_thresh. Outputs fp32
// contiguous, d wide. Each returns cudaGetLastError() after its launch.

// o [bh, sq, d] and lse [bh, sq].
extern "C" int apex_flash_f32_d512_fwd(int dtype, const void* q,
                                       const void* k, const void* v, void* o,
                                       void* lse, long long q_bh,
                                       long long q_s, long long k_bh,
                                       long long k_s, long long v_bh,
                                       long long v_s, const void* kvb,
                                       long long kvb_bh, const void* bias,
                                       long long bias_bh, unsigned seed,
                                       unsigned drop_thresh, float drop_inv,
                                       int bh, int sq, int sk, int d,
                                       int q_start, int k_start, int causal,
                                       float scale, void* stream) {
  using namespace apex_port;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype != kF32 || o == nullptr || lse == nullptr) {
    return static_cast<int>(err);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_width(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    const int rows = 16 * xf_pairs<D>();
    const int blocks = (sq + rows - 1) / rows;
    if (bad_x32(bh, sq, sk, d, blocks, {q_bh, q_s, k_bh, k_s, v_bh, v_s})) {
      return;
    }
    with_extra(a, [&](auto extra) {
      err = f32_launch(f32x_fwd_kernel<D, decltype(extra)::value>,
                       smem_x_fwd<D>(), blocks, bh, 64 * xf_pairs<D>(), st,
                       a, d, static_cast<float*>(o), static_cast<float*>(lse));
    });
  });
  return static_cast<int>(err);
}

// dq [bh, sq, d]; ds null or fp32 [bh, sq, sk] (the per-bh bias gradient).
extern "C" int apex_flash_f32_d512_dq(int dtype, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq, void* ds,
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
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype != kF32 || dq == nullptr) return static_cast<int>(err);
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_width(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    const int rows = 16 * xq_pairs<D>();
    const int blocks = (sq + rows - 1) / rows;
    if (bad_x32(bh, sq, sk, d, blocks,
                {q_bh, q_s, k_bh, k_s, v_bh, v_s, do_bh, do_s})) {
      return;
    }
    with_extra(a, [&](auto extra) {
      err = f32_launch(f32x_dq_kernel<D, decltype(extra)::value>,
                       smem_x_dq<D>(), blocks, bh, 64 * xq_pairs<D>(), st, a,
                       d, static_cast<const float*>(dout), do_bh, do_s,
                       static_cast<const float*>(lse),
                       static_cast<const float*>(delta),
                       static_cast<float*>(dq), static_cast<float*>(ds));
    });
  });
  return static_cast<int>(err);
}

// dk, dv [bh, sk, d].
extern "C" int apex_flash_f32_d512_dkv(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
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
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype != kF32 || dk == nullptr || dv == nullptr) {
    return static_cast<int>(err);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_width(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    const int rows = 16 * xk_quads<D>();
    const int blocks = (sk + rows - 1) / rows;
    if (bad_x32(bh, sq, sk, d, blocks,
                {q_bh, q_s, k_bh, k_s, v_bh, v_s, do_bh, do_s})) {
      return;
    }
    with_extra(a, [&](auto extra) {
      err = f32_launch(f32x_dkv_kernel<D, decltype(extra)::value>,
                       smem_x_dkv<D>(), blocks, bh, 128 * xk_quads<D>(), st,
                       a, d, static_cast<const float*>(dout), do_bh, do_s,
                       static_cast<const float*>(lse),
                       static_cast<const float*>(delta),
                       static_cast<float*>(dk), static_cast<float*>(dv));
    });
  });
  return static_cast<int>(err);
}
