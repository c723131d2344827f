// Flash attention's shared-bias gradient over [BH, S, D] bf16 or fp16 (D
// 64 or 128): dbias = dS summed over bh, for a bias [1, Sq, Sk] shared over
// bh. (fp32, and other head dims, take the dS of csrc/flash_simt.cu's dq
// summed by dbias_sum_kernel.)
// The forward is csrc/flash_fwd.cu, dq and dk/dv csrc/flash_bwd.cu; the
// semantics all of them keep from the Pallas kernels are
// csrc/flash_common.cuh.
//
// Replaces the Pallas kernel of
// apex_tpu/contrib/multihead_attn/flash_attention.py: _bwd_pallas ->
// _bwd_dbias_kernel (:427), with every input it takes: the bias itself,
// kv_bias [1|BH, Sk] fp32 and dropout.
//
// Bound on this card: bytes at the ViT's [1536, 197, 64] (q, k, v, dO and
// the bias read once, dbias written: ~0.047 ms), the recompute's two
// products per (query, key) and bh below it. The Pallas kernel walks bh
// innermost with the sum in VMEM; here a block owns one 64 x 64 (query,
// key) tile and a contiguous run of bh (the grid's z), recomputing P and
// dP per bh as dq does and summing dS in registers in bh order; a second
// pass adds the runs' partial tiles in run order. No float atomics:
// repeated runs are bitwise equal. The runs fill the card when there are
// few tiles (S = 197 has 4 x 4 of them). The recompute's products QK^T
// and dO V^T are mma.sync.m16n8k16 products of the 16-bit inputs (bf16 or
// fp16, E) with fp32 accumulators:
// a block of four warps owns 64 query rows (16 a warp) and stages the 64
// keys' K and V in shared memory (rows padded by 8 elements, so the eight
// 16-byte rows an ldmatrix reads fall in distinct banks); its kv_bias is
// staged beside them, and the bias is read per element, guarded past Sq
// and Sk. Built for kDbBlocks resident blocks an SM at D = 64 (its
// operands and dS sums held in registers).

#include "flash_common.cuh"

namespace apex_port {
namespace {

constexpr int kTile = 64;       // rows a block owns; rows of a staged tile
constexpr int kThreads = 128;   // four warps of 16 rows
// blocks an SM must hold at D = 64 (a cap of 170 registers a thread);
// the D = 128 form takes what it needs
constexpr int kDbBlocks = 3;

// the 16-bit inputs as they are stored: this kernel only moves their bits
// until the products read them as E
using u16 = uint16_t;

// two consecutive elements (4-byte aligned)
__device__ __forceinline__ uint32_t ld_pair(const u16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8x8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[i] is lane
// (g, t4)'s pair of matrix i: row g, columns 2*t4 and 2*t4 + 1
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const u16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16x16, row major) * b (16x8, col major); E (bf16 or fp16) in,
// fp32 out
template <typename E>
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<E, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// A fragments of the warp's 16 rows [row, row + 16) of a [nrows, D] matrix
// with row stride rs (zero past nrows), one set of four registers per
// 16-wide step of D: lane (g, t4) holds rows g and g + 8, columns 2*t4 and
// 2*t4 + 8 (the PTX fragment layout of m16n8k16)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4],
                                       const u16* base, long long rs,
                                       int row, int nrows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bool in0 = row + g < nrows, in1 = row + g + 8 < nrows;
  const u16* p0 = base + (long long)(row + g) * rs + 2 * t4;
  const u16* p1 = p0 + 8 * rs;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = in0 ? ld_pair(p0 + kk * 16) : 0u;
    f[kk][1] = in1 ? ld_pair(p1 + kk * 16) : 0u;
    f[kk][2] = in0 ? ld_pair(p0 + kk * 16 + 8) : 0u;
    f[kk][3] = in1 ? ld_pair(p1 + kk * 16 + 8) : 0u;
  }
}

// rows [row0, row0 + kTile) of a [nrows, D] matrix -> sm [kTile][D + 8],
// 16 bytes a load, zero past nrows
template <int D>
__device__ __forceinline__ void load_tile(u16* sm, const u16* base,
                                          long long rs, int row0,
                                          int nrows) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * rs
                                            + c);
    }
    *reinterpret_cast<uint4*>(sm + r * LD + c) = val;
  }
}

// s[nt] = A (the warp's 16 rows) x B^T over D, for the NT * 8 rows of the
// staged tile sm taken 8 at a time as the columns of s: the products
// Q K^T and dO V^T. One ldmatrix gives the B fragments of 32 columns of D
// (two k-steps of the product)
template <typename E, int D, int NT = 8>
__device__ __forceinline__ void rows_times_tile(float (&s)[NT][4],
                                                const uint32_t (&a)[D / 16][4],
                                                const u16* sm) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < D / 32; ++k2) {
      uint32_t b[4];
      ldsm_x4(b, sm + (nt * 8 + r) * LD + k2 * 32 + mi * 8);
      mma16816<E>(s[nt], a[2 * k2], b[0], b[1]);
      mma16816<E>(s[nt], a[2 * k2 + 1], b[2], b[3]);
    }
  }
}

// kv_bias of keys [k0, k0 + kTile) in log2 units -> sm [kTile] (0 past sk
// and without a kv_bias)
__device__ __forceinline__ void load_bias_tile(float* sm, const Attn& a,
                                               int bh, int k0) {
  if (threadIdx.x < kTile) {
    const int kj = k0 + threadIdx.x;
    sm[threadIdx.x] = a.kvb != nullptr && kj < a.sk
                          ? a.kvb[bh * a.kvb_bh + kj] * kLog2e : 0.f;
  }
}

// key tiles the query tile qb must visit: the causal mask ends them at the
// last key its last row sees
__device__ __forceinline__ int live_k_tiles(const Attn& a, int qb) {
  int n = (a.sk + kTile - 1) / kTile;
  if (a.causal) {
    const int lim = a.q_start + qb * kTile + kTile - 1 - a.k_start;
    if (lim < 0) return 0;
    n = min(n, lim / kTile + 1);
  }
  return n;
}

// The backward's per-element recompute (_recompute_p_ds, :309-346) of
// (query qi, key kj) in bh: s is q·k, dp is dO·v, kvb2 the key's kv_bias
// in log2 units, lse2 the row's lse in log2 units. Returns p, dropped and
// rescaled as the forward applied it (dv's factor), and sets ds = p ·
// (dP' - delta) with the undropped p (the bias gradient; dq and dk take it
// times the scale).
__device__ __forceinline__ float p_ds(const Attn& a, int bh, int qi, int kj,
                                      bool vis, float s, float kvb2, float dp,
                                      float lse2, float dlt, float& ds) {
  float sc = s * (a.scale * kLog2e) + kvb2;
  if (vis) sc += bias_at(a, bh, qi, kj);
  const bool live = vis && sc > kNegInf * 0.5f;
  const float p = live ? exp2f(sc - lse2) : 0.f;
  float pd = p;
  if (a.drop_inv > 0.f) {
    const bool kept = keep(a, bh, qi, kj);
    pd = kept ? p * a.drop_inv : 0.f;
    dp = kept ? dp * a.drop_inv : 0.f;
  }
  ds = p * (dp - dlt);
  return pd;
}

// ---- backward: the gradient of a bias shared over bh -----------------------

// block (query tile x, key tile y, run z) sums dS over bh in [z * per,
// min(BH, (z + 1) * per)) in bh order into part [z][Sq][Sk] fp32
template <typename E, int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? kDbBlocks : 1)
flash_dbias_kernel(Attn a, const u16* __restrict__ dout, long long do_bh,
                   long long do_s, const float* __restrict__ lse,
                   const float* __restrict__ delta, int nbh, int per,
                   float* __restrict__ part) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) u16 sK[kTile * LD];
  __shared__ __align__(16) u16 sV[kTile * LD];
  const u16* q = static_cast<const u16*>(a.q);
  const u16* k = static_cast<const u16*>(a.k);
  const u16* v = static_cast<const u16*>(a.v);
  __shared__ float sB[kTile];
  const int qb = blockIdx.x, kt = blockIdx.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int qw = qb * kTile + (threadIdx.x >> 5) * 16;
  float* out = part + (long long)blockIdx.z * a.sq * a.sk;
  float acc[2][4][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[half][nt][e] = 0.f;
    }
  }
  // the whole tile lies above the causal diagonal: its sums stay 0
  const bool live = kt < live_k_tiles(a, qb);
  const int bh0 = blockIdx.z * per, bh1 = min(nbh, bh0 + per);
  for (int bh = live ? bh0 : bh1; bh < bh1; ++bh) {
    uint32_t qf[D / 16][4], df[D / 16][4];
    load_a<D>(qf, q + bh * a.q_bh, a.q_s, qw, a.sq);
    load_a<D>(df, dout + bh * do_bh, do_s, qw, a.sq);
    float lse_r[2], dlt_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qw + g + 8 * h;
      const long long i = (long long)bh * a.sq + row;
      lse_r[h] = row < a.sq ? lse[i] * kLog2e : 0.f;
      dlt_r[h] = row < a.sq ? delta[i] : 0.f;
    }
    __syncthreads();
    load_tile<D>(sK, k + bh * a.k_bh, a.k_s, kt * kTile, a.sk);
    load_tile<D>(sV, v + bh * a.v_bh, a.v_s, kt * kTile, a.sk);
    load_bias_tile(sB, a, bh, kt * kTile);
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k0 = half * 32;
      float s[4][4], dp[4][4];
      rows_times_tile<E, D, 4>(s, qf, sK + k0 * LD);    // Q K^T
      rows_times_tile<E, D, 4>(dp, df, sV + k0 * LD);   // dO V^T
      const bool full = all_visible(a, qw, 16, kt * kTile + k0, 32);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int qi = qw + g + 8 * h;
          const int kl = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int kj = kt * kTile + kl;
          float d;
          p_ds(a, bh, qi, kj, full || visible(a, qi, kj), s[nt][e],
                     sB[kl], dp[nt][e], lse_r[h], dlt_r[h], d);
          acc[half][nt][e] += d;
        }
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qw + g + 8 * (e >> 1);
        const int kj = kt * kTile + half * 32 + nt * 8 + 2 * t4 + (e & 1);
        if (qi < a.sq && kj < a.sk) {
          out[(long long)qi * a.sk + kj] = acc[half][nt][e];
        }
      }
    }
  }
}

}  // namespace
}  // namespace apex_port

// q, k, v [bh, s, d] of dtype (bf16 or fp16) and dout with the given
// strides (elements; the last dim contiguous, every stride a multiple of
// 8, every base 16-byte aligned); kvb null or fp32 [1|bh, sk] with bh
// stride kvb_bh (0 when shared), its keys contiguous; dropout when
// drop_inv = 1 / (1 - rate) > 0, keeping an element whose hash under seed
// is >= drop_thresh; lse, delta fp32 [bh, sq] contiguous; the bias fp32
// [1, sq, sk] contiguous, shared over bh (bias_bh = 0); dbias fp32 [sq,
// sk] contiguous; bh split into `runs` runs of ceil(bh / runs), and with
// runs > 1 part fp32 [runs, sq, sk] contiguous scratch.
extern "C" int apex_flash_bwd_dbias(int dtype, const void* q, const void* k,
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
  if (bad(bh, sq, sk, d, 1) || bias == nullptr || bias_bh != 0 ||
      runs < 1 || runs > bh || runs > 65535 ||
      (runs > 1 && part == nullptr) || (dtype != kBF16 && dtype != kF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const int per = (bh + runs - 1) / runs;
  runs = (bh + per - 1) / per;        // no run is left empty
  const dim3 grid((sq + kTile - 1) / kTile, (sk + kTile - 1) / kTile, runs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const u16* dp = static_cast<const u16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* out = static_cast<float*>(dbias);
  float* tmp = runs > 1 ? static_cast<float*>(part) : out;
  with_elem(dtype, [&](auto et) {
    using E = typename decltype(et)::type;
    if (d == 64) {
      flash_dbias_kernel<E, 64><<<grid, kThreads, 0, st>>>(
          a, dp, do_bh, do_s, lp, dl, bh, per, tmp);
    } else {
      flash_dbias_kernel<E, 128><<<grid, kThreads, 0, st>>>(
          a, dp, do_bh, do_s, lp, dl, bh, per, tmp);
    }
  });
  if (runs > 1) dbias_sum(tmp, out, runs, (long long)sq * sk, st);
  return static_cast<int>(cudaGetLastError());
}
