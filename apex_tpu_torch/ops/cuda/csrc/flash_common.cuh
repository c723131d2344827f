// The semantics the flash kernels share (csrc/flash_fwd.cu: the forward;
// csrc/flash_bwd.cu: dq and dk/dv; csrc/flash_dbias.cu: the shared-bias
// gradient), kept from the Pallas kernels of
// apex_tpu/contrib/multihead_attn/flash_attention.py:
//
// - fp32 scores, softmax statistics and accumulators, exponentials as
//   exp2 of scores pre-multiplied by scale * log2(e);
// - masking by absolute positions (query row i sits at q_start + i, key j
//   at k_start + j, and with `causal` a query sees the keys at or before
//   it) and by the true lengths, so a ragged tail (S = 4095, 197) is
//   masked in the kernel and nothing is padded; tiles that are wholly
//   masked are skipped (_block_live, :170);
// - the finite -inf stand-in kNegInf: a row with nothing unmasked gives
//   o = 0 and lse = kNegInf, and the backward's value guard (:333-334)
//   gives it p = 0 (exp2(s - lse) would otherwise be exp2(0) = 1 there);
// - the biases (the EXTRA forms) added to every score before the
//   exponential, s * scale + bias + kvb as at :206-212 and :324-330, in
//   log2 units: the per-key kv_bias [1|BH, Sk] (key-padding masks) and
//   the full bias [1|BH, Sq, Sk], read per element (a bias shared over bh
//   stays in L2) and transposed where a kernel's rows are keys. Biases are
//   data, so they never make a tile skippable; a score a bias masks
//   (-1e30) lies below kNegInf / 2, which the value guard turns into p = 0;
// - dropout (drop_inv > 0) by the JAX package's stateless coordinate hash
//   (dropout_bits, :107-126): element (bh, q_start + i, k_start + j) is
//   kept when its 32-bit hash under the seed is >= drop_thresh
//   (_drop_threshold, :129-130), bh = b·H + h. The forward sums the
//   undropped p into l and accumulates the kept p · drop_inv into the
//   output (:223-231), so lse stays dropout-free; the backward recomputes
//   the same mask and applies it to p for dv and to dP, and dS = p · (dP'
//   - delta) with the undropped p (_recompute_p_ds, :309-346). delta =
//   rowsum(dO * O) - dlse comes from the caller, as the JAX wrapper
//   computes it outside Pallas (:474-479).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace apex_port {
namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Attn {
  const void* q;                               // of the kernel's element
  const void* k;                               // type
  const void* v;
  const float* kvb;                            // [1|BH, Sk] or null
  const float* bias;                           // [1|BH, Sq, Sk] or null
  long long q_bh, q_s, k_bh, k_s, v_bh, v_s;   // strides, elements
  long long kvb_bh, bias_bh;                   // 0 when shared over bh
  int sq, sk, q_start, k_start, causal;
  float scale;
  uint32_t seed, drop_thresh;                  // dropout's hash and bar
  float drop_inv;                              // 1 / (1 - rate); 0: none
};

// two fp32 values rounded to the 16-bit E (bf16 or fp16) as one register,
// lo in the low half: a product's register fragment, or two outputs
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<E, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// what pack2's rounding of (lo, hi) to `big` left, rounded to E alike:
// big + the result holds each value to about twice E's bits (the D-384/512
// forward's P, csrc/flash_d512.cu)
template <typename E>
__device__ __forceinline__ uint32_t pack2_rest(float lo, float hi,
                                               uint32_t big) {
  if constexpr (std::is_same<E, __half>::value) {
    const float2 r = __half22float2(*reinterpret_cast<const __half2*>(&big));
    return pack2<E>(lo - r.x, hi - r.y);
  } else {
    const float2 r =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&big));
    return pack2<E>(lo - r.x, hi - r.y);
  }
}

// 2^x by one special-function instruction, results below 2^-126 flushed
// to zero (the Hopper kernels', csrc/flash_tiles.cuh, and the fp32 ones',
// csrc/flash_f32.cuh). exp2f keeps those subnormal, at more instructions;
// here such a p or alpha lies far below an ulp of l >= 1 (in the
// backward, of dS's other terms), and the fp32 forward took 10% less time
// with this, its pair kernels 1-2.5% (PERF.md)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the full bias of (query qi, key kj), both local and in range, in log2
// units; 0 without one
__device__ __forceinline__ float bias_at(const Attn& a, int bh, int qi,
                                         int kj) {
  return a.bias != nullptr
             ? a.bias[bh * a.bias_bh + (long long)qi * a.sk + kj] * kLog2e
             : 0.f;
}

// the JAX package's dropout_bits (flash_attention.py:107-126) in uint32
// arithmetic: keep (bh, query qi, key kj) when its hash >= drop_thresh
__device__ __forceinline__ bool keep(const Attn& a, int bh, int qi, int kj) {
  uint32_t x = static_cast<uint32_t>(a.q_start + qi) * 0x9E3779B1u +
               static_cast<uint32_t>(a.k_start + kj) * 0x85EBCA77u +
               static_cast<uint32_t>(bh) * 0xC2B2AE3Du +
               a.seed * 0x27D4EB2Fu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= a.drop_thresh;
}

// whether query row qi (local) may see key kj (local)
__device__ __forceinline__ bool visible(const Attn& a, int qi, int kj) {
  return qi < a.sq && kj < a.sk &&
         (!a.causal || a.q_start + qi >= a.k_start + kj);
}

// whether every query of [q0, q0 + nq) sees every key of [k0, k0 + nk):
// such tiles (all but the diagonal and the ragged edges) skip the
// per-element mask
__device__ __forceinline__ bool all_visible(const Attn& a, int q0, int nq,
                                            int k0, int nk) {
  return q0 + nq <= a.sq && k0 + nk <= a.sk &&
         (!a.causal || a.q_start + q0 >= a.k_start + k0 + nk - 1);
}

// the score of (qi, kj) in log2 units with the biases, kNegInf where
// masked (as _fwd_kernel, :196-212); the scalar path of the simple form
// (csrc/flash_simt.cu) and of the fp32 backward (csrc/flash_f32.cu)
__device__ __forceinline__ float score2(const Attn& a, int bh, int qi, int kj,
                                        float s) {
  const bool vis = visible(a, qi, kj);
  float sc = s * (a.scale * kLog2e);
  if (a.kvb != nullptr && kj < a.sk) sc += a.kvb[bh * a.kvb_bh + kj] * kLog2e;
  if (vis) sc += bias_at(a, bh, qi, kj);
  return vis ? sc : kNegInf;
}

// The backward's recompute (_recompute_p_ds, :309-346) of (qi, kj): s is
// q·k, dp dO·v, lse2 the row's lse in log2 units. Returns p dropped and
// rescaled (dv's weight) and sets ds = p (dP' - delta) with the undropped
// p.
__device__ __forceinline__ float p_and_ds(const Attn& a, int bh, int qi,
                                          int kj, float s, float dp,
                                          float lse2, float dlt, float& ds) {
  const float sc = score2(a, bh, qi, kj, s);
  const float p = sc > kNegInf * 0.5f ? exp2f(sc - lse2) : 0.f;
  float pd = p;
  if (a.drop_inv > 0.f) {
    const bool kept = keep(a, bh, qi, kj);
    pd = kept ? p * a.drop_inv : 0.f;
    dp = kept ? dp * a.drop_inv : 0.f;
  }
  ds = p * (dp - dlt);
  return pd;
}

Attn make_attn(const void* q, const void* k, const void* v, long long q_bh,
               long long q_s, long long k_bh, long long k_s, long long v_bh,
               long long v_s, const void* kvb, long long kvb_bh,
               const void* bias, long long bias_bh, unsigned seed,
               unsigned drop_thresh, float drop_inv, int sq, int sk,
               int q_start, int k_start, int causal, float scale) {
  Attn a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kvb = static_cast<const float*>(kvb);
  a.bias = static_cast<const float*>(bias);
  a.kvb_bh = kvb_bh;
  a.bias_bh = bias_bh;
  a.q_bh = q_bh;
  a.q_s = q_s;
  a.k_bh = k_bh;
  a.k_s = k_s;
  a.v_bh = v_bh;
  a.v_s = v_s;
  a.sq = sq;
  a.sk = sk;
  a.q_start = q_start;
  a.k_start = k_start;
  a.causal = causal;
  a.scale = scale;
  a.seed = seed;
  a.drop_thresh = drop_thresh;
  a.drop_inv = drop_inv;
  return a;
}

// what the 16-bit kernels refuse: blocks (a grid's blocks along the rows,
// folded with bh into its one dim) * bh past 2^31 - 1, no rows, D other
// than 64 or 128 (or 256, for the kernels written for it: d256)
bool bad(int bh, int sq, int sk, int d, int blocks, bool d256 = false) {
  return bh < 1 || sq < 1 || sk < 1 ||
         (d != 64 && d != 128 && !(d256 && d == 256)) || blocks < 1 ||
         (long long)blocks * bh > 0x7fffffffLL;
}

// calls f(Tag<E>) for the 16-bit element types of the tensor-core kernels
// (bf16, fp16); false for any other dtype code
template <typename F>
bool with_elem(int dtype, F&& f) {
  if (dtype == kBF16) f(Tag<bf16>{});
  else if (dtype == kF16) f(Tag<__half>{});
  else return false;
  return true;
}

// calls f(D, EXTRA) with both as compile-time constants: the head dim (64
// or 128, or 256 where D256) and whether any bias or dropout is given
template <bool D256 = false, typename F>
void with_form(int d, const Attn& a, F&& f) {
  using std::integral_constant;
  const bool extra = a.kvb != nullptr || a.bias != nullptr ||
                     a.drop_inv > 0.f;
  auto at = [&](auto dd) {
    if (extra) f(dd, integral_constant<bool, true>{});
    else f(dd, integral_constant<bool, false>{});
  };
  if constexpr (D256) {
    if (d == 256) {
      at(integral_constant<int, 256>{});
      return;
    }
  }
  if (d == 64) at(integral_constant<int, 64>{});
  else at(integral_constant<int, 128>{});
}

// out[i] = sum over the runs r = 0, 1, ... of part[r][i], in run order:
// the shared-bias gradient's second pass (csrc/flash_dbias.cu's runs of
// bh, csrc/flash_simt.cu's per-bh dS)
__global__ void dbias_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int runs,
                                 long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < runs; ++r) acc += part[r * n + i];
    out[i] = acc;
  }
}

inline void dbias_sum(const float* part, float* out, int runs, long long n,
                      cudaStream_t st) {
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  dbias_sum_kernel<<<blocks, 256, 0, st>>>(part, out, runs, n);
}

}  // namespace
}  // namespace apex_port
