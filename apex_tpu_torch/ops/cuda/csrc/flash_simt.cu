// Flash attention over [BH, S, D] by fp32 FMAs on the CUDA cores: the
// forward, dq (with the per-bh bias gradient dS) and dk/dv, and the
// shared-bias gradient (dq's dS summed over bh), in fp32, bf16 or fp16 at
// a head dim up to 512. No path takes them: every dtype and head dim has a
// tensor-core form (csrc/flash_fwd.cu, csrc/flash_bwd.cu,
// csrc/flash_d512.cu, csrc/flash_d512_dkv.cu, csrc/flash_f32.cu,
// csrc/flash_f32_d512.cu and, for the shared-bias gradient,
// csrc/flash_dbias.cu); they stay as the yardstick those are timed
// against. The semantics they keep from the Pallas kernels are
// csrc/flash_common.cuh's: causal masking by absolute positions, the
// per-key kv_bias and the full bias, dropout by the JAX package's
// coordinate hash, the finite kNegInf, the value guard.
//
// Counterpart of the Pallas kernels of
// apex_tpu/contrib/multihead_attn/flash_attention.py: _fwd_kernel
// (:181-245), _bwd_dq_kernel (:349) and _bwd_dkv_kernel (:392); with the
// per-bh dS summed over bh (dbias_sum_kernel) also _bwd_dbias_kernel
// (:427).
//
// Bound on this card: operations. At [128, 4095, 64] causal (1.07e9 live
// pairs) the forward's two products are 4·D·pairs = 275 GFLOP, 4.1 ms at
// the 67 TFLOP/s of fp32 outside the tensor cores; the bytes (q, k, v, o
// in fp32: 537 MB) take 0.16 ms.
//
// Design: the simple form first. A block of kSRows warps owns kSRows rows
// (queries for the forward and dq, keys for dk/dv), a warp a row, its lanes
// across D (lane l holds dims l, l + 32, ..., NJ = ceil(D / 32) of them).
// The other side's rows arrive kSCols (32) at a time, staged in shared
// memory as fp32 (rows padded to an odd stride, so that the 32 lanes, a
// row each, read distinct banks): lane l scores the row's pair with staged
// row l (D FMAs, the own row read as a broadcast), the warp takes the
// online softmax (forward: max, exp2, sum by butterflies) or the
// recompute of P and dS (backward) over its 32 pairs, and each lane adds
// the 32 pairs' products into its D / 32 accumulators, each pair's weight
// broadcast by a shuffle. Tiles wholly past the causal edge are skipped;
// each block owns its output rows, so every output repeats bit for bit.
// Making it fast (register tiles of several rows a warp, so that a staged
// value feeds more than one FMA) is later work.

#include <type_traits>

#include "flash_common.cuh"

namespace apex_port {
namespace {

constexpr int kSRows = 8;                  // rows a block owns, a warp each
constexpr int kSThreads = 32 * kSRows;
constexpr int kSCols = 32;                 // staged rows: one a lane

// the odd row stride of a staged tile of D-wide rows
__device__ __forceinline__ int tile_ld(int d) { return d | 1; }

// rows [row0, row0 + n) of a [rows, D] matrix (row stride rs, the last dim
// contiguous) as fp32 into dst [n][ld], zero past `rows`; all threads
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           long long rs, int row0, int n,
                                           int rows, int d) {
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] =
        row0 + r < rows ? to_f(src[(long long)(row0 + r) * rs + c]) : 0.f;
  }
}

// the dot product of a broadcast row a[0..d) with staged row b[0..d)
__device__ __forceinline__ float dot_rows(const float* a, const float* b,
                                          int d) {
  float s = 0.f;
  for (int i = 0; i < d; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// staged tiles of kSCols keys the queries [q0, q0 + n) must visit
__device__ __forceinline__ int simt_key_tiles(const Attn& a, int q0, int n) {
  const int last = min(q0 + n, a.sq) - 1;
  if (last < q0) return 0;
  int t = (a.sk + kSCols - 1) / kSCols;
  if (a.causal) {
    const int lim = a.q_start + last - a.k_start;
    if (lim < 0) return 0;
    t = min(t, lim / kSCols + 1);
  }
  return t;
}

// acc[j] += x_kk * tile[kk][lane + 32 j] over the 32 staged rows kk, x_kk
// lane kk's x
template <int NJ>
__device__ __forceinline__ void add_rows(float (&acc)[NJ], float x,
                                         const float* tile, int ld, int d) {
  const int lane = threadIdx.x & 31;
  for (int kk = 0; kk < kSCols; ++kk) {
    const float w = __shfl_sync(0xffffffffu, x, kk);
    const float* row = tile + kk * ld;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (lane + 32 * j < d) acc[j] = fmaf(w, row[lane + 32 * j], acc[j]);
    }
  }
}

// acc's dims of one output row, rounded to T
template <typename T, int NJ>
__device__ __forceinline__ void store_row(T* out, const float (&acc)[NJ],
                                          float mul, int d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (lane + 32 * j < d) out[lane + 32 * j] = from_f<T>(acc[j] * mul);
  }
}

// ---- forward ---------------------------------------------------------------

// o [BH, Sq, D] of T and lse fp32 [BH, Sq], contiguous; the grid's one dim
// folds bh with the row blocks (bh-major, each bh's longest rows first)
template <typename T, int NJ>
__global__ void __launch_bounds__(kSThreads)
simt_fwd_kernel(Attn a, int d, T* __restrict__ o, float* __restrict__ lse) {
  extern __shared__ float smf[];
  const int ld = tile_ld(d);
  float* kt = smf;                       // [kSCols][ld] keys
  float* vt = kt + kSCols * ld;          // [kSCols][ld] values
  float* qs = vt + kSCols * ld;          // [kSRows][d] the block's queries
  const int nb = (a.sq + kSRows - 1) / kSRows;
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * kSRows;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = q0 + w;
  const T* k = static_cast<const T*>(a.k) + bh * a.k_bh;
  const T* v = static_cast<const T*>(a.v) + bh * a.v_bh;
  stage_rows(qs, d, static_cast<const T*>(a.q) + bh * a.q_bh, a.q_s, q0,
             kSRows, a.sq, d);
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;
  const int nt = simt_key_tiles(a, q0, kSRows);
  for (int t = 0; t < nt; ++t) {
    __syncthreads();                     // the last tile's reads are done
    stage_rows(kt, ld, k, a.k_s, t * kSCols, kSCols, a.sk, d);
    stage_rows(vt, ld, v, a.v_s, t * kSCols, kSCols, a.sk, d);
    __syncthreads();
    const int kj = t * kSCols + lane;
    const float sc = score2(a, bh, qi, kj, dot_rows(qs + w * d,
                                                    kt + lane * ld, d));
    const float mn = fmaxf(m, warp_max(sc));
    const float alpha = exp2f(m - mn);   // 1 while the row saw nothing
    float p = sc > kNegInf * 0.5f ? exp2f(sc - mn) : 0.f;
    l = l * alpha + warp_sum(p);         // lse stays dropout-free
    if (a.drop_inv > 0.f) p = keep(a, bh, qi, kj) ? p * a.drop_inv : 0.f;
    m = mn;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= alpha;
    add_rows(acc, p, vt, ld, d);         // O += P V
  }
  if (qi >= a.sq) return;
  const long long row = (long long)bh * a.sq + qi;
  store_row(o + row * d, acc, l > 0.f ? 1.f / l : 1.f, d);
  if (lane == 0) lse[row] = l > 0.f ? m * kLn2 + logf(l) : kNegInf;
}

// ---- dq (and the per-bh dS) ------------------------------------------

// dq [BH, Sq, D] of T contiguous, or null (dS alone); ds null or fp32 [BH,
// Sq, Sk] contiguous: dS of every (query, key), unscaled, zeros where a
// tile is skipped
template <typename T, int NJ>
__global__ void __launch_bounds__(kSThreads)
simt_dq_kernel(Attn a, int d, const T* __restrict__ dout, long long do_bh,
               long long do_s, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq,
               float* __restrict__ ds) {
  extern __shared__ float smf[];
  const int ld = tile_ld(d);
  float* kt = smf;                       // [kSCols][ld] keys
  float* vt = kt + kSCols * ld;          // [kSCols][ld] values
  float* qs = vt + kSCols * ld;          // [kSRows][d] queries
  float* os = qs + kSRows * d;           // [kSRows][d] their dO
  const int nb = (a.sq + kSRows - 1) / kSRows;
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * kSRows;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = q0 + w;
  const T* k = static_cast<const T*>(a.k) + bh * a.k_bh;
  const T* v = static_cast<const T*>(a.v) + bh * a.v_bh;
  stage_rows(qs, d, static_cast<const T*>(a.q) + bh * a.q_bh, a.q_s, q0,
             kSRows, a.sq, d);
  stage_rows(os, d, dout + bh * do_bh, do_s, q0, kSRows, a.sq, d);
  const long long row = (long long)bh * a.sq + qi;
  const float lse2 = qi < a.sq ? lse[row] * kLog2e : 0.f;
  const float dlt = qi < a.sq ? delta[row] : 0.f;
  float* dsr = ds != nullptr && qi < a.sq ? ds + row * a.sk : nullptr;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  const int nt = simt_key_tiles(a, q0, kSRows);
  for (int t = 0; t < nt; ++t) {
    __syncthreads();
    stage_rows(kt, ld, k, a.k_s, t * kSCols, kSCols, a.sk, d);
    stage_rows(vt, ld, v, a.v_s, t * kSCols, kSCols, a.sk, d);
    __syncthreads();
    const int kj = t * kSCols + lane;
    float dsv;
    p_and_ds(a, bh, qi, kj, dot_rows(qs + w * d, kt + lane * ld, d),
             dot_rows(os + w * d, vt + lane * ld, d), lse2, dlt, dsv);
    if (dsr != nullptr && kj < a.sk) dsr[kj] = dsv;
    add_rows(acc, dsv * a.scale, kt, ld, d);   // dq += dS K
  }
  if (qi >= a.sq) return;
  if (dsr != nullptr) {
    for (int kj = nt * kSCols + lane; kj < a.sk; kj += 32) dsr[kj] = 0.f;
  }
  if (dq != nullptr) store_row(dq + row * d, acc, 1.f, d);
}

// ---- dk, dv ----------------------------------------------------------

// dk, dv [BH, Sk, D] of T contiguous; the grid folds bh with the blocks of
// keys (the first keys, which see the most queries, first)
template <typename T, int NJ>
__global__ void __launch_bounds__(kSThreads)
simt_dkv_kernel(Attn a, int d, const T* __restrict__ dout, long long do_bh,
                long long do_s, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv) {
  extern __shared__ float smf[];
  const int ld = tile_ld(d);
  float* qt = smf;                       // [kSCols][ld] queries
  float* ot = qt + kSCols * ld;          // [kSCols][ld] their dO
  float* ks = ot + kSCols * ld;          // [kSRows][d] the block's keys
  float* vs = ks + kSRows * d;           // [kSRows][d] their values
  float* ls = vs + kSRows * d;           // [kSCols] lse, log2 units
  float* dl = ls + kSCols;               // [kSCols] delta
  const int nb = (a.sk + kSRows - 1) / kSRows;
  const int bh = blockIdx.x / nb;
  const int k0 = (blockIdx.x % nb) * kSRows;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kj = k0 + w;
  const T* q = static_cast<const T*>(a.q) + bh * a.q_bh;
  const T* dob = dout + bh * do_bh;
  stage_rows(ks, d, static_cast<const T*>(a.k) + bh * a.k_bh, a.k_s, k0,
             kSRows, a.sk, d);
  stage_rows(vs, d, static_cast<const T*>(a.v) + bh * a.v_bh, a.v_s, k0,
             kSRows, a.sk, d);
  float dka[NJ], dva[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dka[j] = dva[j] = 0.f;
  // the first query tile that sees key k0 (with the causal mask)
  const int nqt = (a.sq + kSCols - 1) / kSCols;
  int qt0 = 0;
  if (a.causal) {
    const int need = a.k_start + k0 - a.q_start;
    qt0 = need <= 0 ? 0 : min(nqt, need / kSCols);
  }
  for (int t = qt0; t < nqt; ++t) {
    __syncthreads();
    stage_rows(qt, ld, q, a.q_s, t * kSCols, kSCols, a.sq, d);
    stage_rows(ot, ld, dob, do_s, t * kSCols, kSCols, a.sq, d);
    if (threadIdx.x < kSCols) {
      const int r = t * kSCols + threadIdx.x;
      const long long i = (long long)bh * a.sq + r;
      ls[threadIdx.x] = r < a.sq ? lse[i] * kLog2e : 0.f;
      dl[threadIdx.x] = r < a.sq ? delta[i] : 0.f;
    }
    __syncthreads();
    const int qi = t * kSCols + lane;
    float dsv;
    const float pd = p_and_ds(a, bh, qi, kj,
                              dot_rows(ks + w * d, qt + lane * ld, d),
                              dot_rows(vs + w * d, ot + lane * ld, d),
                              ls[lane], dl[lane], dsv);
    add_rows(dva, pd, ot, ld, d);               // dv += P^T dO
    add_rows(dka, dsv * a.scale, qt, ld, d);    // dk += dS^T Q
  }
  if (kj >= a.sk) return;
  const long long row = (long long)bh * a.sk + kj;
  store_row(dk + row * d, dka, 1.f, d);
  store_row(dv + row * d, dva, 1.f, d);
}

// ---- host ------------------------------------------------------------

// calls f(Tag<T>, NJ) for a storage dtype code and D <= 512; false for
// anything else
template <typename F>
bool with_simt(int dtype, int d, F&& f) {
  if (d < 1 || d > 512) return false;
  return with_storage(dtype, [&](auto tag) {
    using std::integral_constant;
    if (d <= 32) f(tag, integral_constant<int, 1>{});
    else if (d <= 64) f(tag, integral_constant<int, 2>{});
    else if (d <= 128) f(tag, integral_constant<int, 4>{});
    else if (d <= 256) f(tag, integral_constant<int, 8>{});
    else f(tag, integral_constant<int, 16>{});
  });
}

// a launch of one of the kernels above: its dynamic shared memory allowed
// first, the grid kSRows rows a block a bh
template <typename K, typename... Args>
cudaError_t simt_launch(K kernel, int bytes, long long rows, int bh,
                        cudaStream_t st, Args... args) {
  const long long blocks = (rows + kSRows - 1) / kSRows * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kSThreads, bytes, st>>>(args...);
  return cudaGetLastError();
}

// shared memory of the forward and dq (two staged tiles and the block's
// rows: one or two of them) and of dk/dv (two tiles, two of the block's
// rows, the tile's lse and delta)
int smem_fwd(int d) { return 4 * (2 * kSCols * (d | 1) + kSRows * d); }
int smem_dq(int d) { return 4 * (2 * kSCols * (d | 1) + 2 * kSRows * d); }
int smem_dkv(int d) { return smem_dq(d) + 4 * 2 * kSCols; }

}  // namespace
}  // namespace apex_port

// Every entry point: q, k, v, dout [bh, s, d] of dtype (fp32, bf16 or
// fp16), d <= 512, read through their strides (elements; the last dim
// contiguous); lse, delta fp32 [bh, sq] contiguous; kvb null or fp32
// [1|bh, sk] with bh stride kvb_bh (0 when shared), its keys contiguous;
// bias null or fp32 [1|bh, sq, sk] contiguous with bh stride bias_bh (0
// when shared); dropout when drop_inv = 1 / (1 - rate) > 0, keeping an
// element whose hash under seed is >= drop_thresh. Outputs contiguous, of
// q's dtype. Each returns cudaGetLastError() after its launches.

// o [bh, sq, d] and lse fp32 [bh, sq].
extern "C" int apex_flash_simt_fwd(int dtype, const void* q, const void* k,
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
  if (bh < 1 || sq < 1 || sk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  with_simt(dtype, d, [&](auto tag, auto nj) {
    using T = typename decltype(tag)::type;
    err = simt_launch(simt_fwd_kernel<T, decltype(nj)::value>, smem_fwd(d),
                      sq, bh, st, a, d, static_cast<T*>(o),
                      static_cast<float*>(lse));
  });
  return static_cast<int>(err);
}

// dq [bh, sq, d]; ds null or fp32 [bh, sq, sk] (the per-bh bias gradient).
extern "C" int apex_flash_simt_dq(int dtype, const void* q, const void* k,
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
  if (bh < 1 || sq < 1 || sk < 1 || dq == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  with_simt(dtype, d, [&](auto tag, auto nj) {
    using T = typename decltype(tag)::type;
    err = simt_launch(simt_dq_kernel<T, decltype(nj)::value>, smem_dq(d), sq,
                      bh, st, a, d, static_cast<const T*>(dout), do_bh, do_s,
                      static_cast<const float*>(lse),
                      static_cast<const float*>(delta), static_cast<T*>(dq),
                      static_cast<float*>(ds));
  });
  return static_cast<int>(err);
}

// dk, dv [bh, sk, d].
extern "C" int apex_flash_simt_dkv(int dtype, const void* q, const void* k,
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
                                   int bh, int sq, int sk, int d,
                                   int q_start, int k_start, int causal,
                                   float scale, void* stream) {
  using namespace apex_port;
  if (bh < 1 || sq < 1 || sk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  with_simt(dtype, d, [&](auto tag, auto nj) {
    using T = typename decltype(tag)::type;
    err = simt_launch(simt_dkv_kernel<T, decltype(nj)::value>, smem_dkv(d),
                      sk, bh, st, a, d, static_cast<const T*>(dout), do_bh,
                      do_s, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), static_cast<T*>(dk),
                      static_cast<T*>(dv));
  });
  return static_cast<int>(err);
}

// The gradient of a bias fp32 [1, sq, sk] shared over bh (bias_bh = 0):
// the dq kernel's dS into ds fp32 [bh, sq, sk] scratch (no dq), then summed
// over bh in bh order into dbias fp32 [sq, sk]. Two launches.
extern "C" int apex_flash_simt_dbias(int dtype, const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dbias, void* ds, long long q_bh,
                                     long long q_s, long long k_bh,
                                     long long k_s, long long v_bh,
                                     long long v_s, long long do_bh,
                                     long long do_s, const void* kvb,
                                     long long kvb_bh, const void* bias,
                                     long long bias_bh, unsigned seed,
                                     unsigned drop_thresh, float drop_inv,
                                     int bh, int sq, int sk, int d,
                                     int q_start, int k_start, int causal,
                                     float scale, void* stream) {
  using namespace apex_port;
  if (bh < 1 || sq < 1 || sk < 1 || bias == nullptr || bias_bh != 0 ||
      ds == nullptr || dbias == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Attn a = make_attn(q, k, v, q_bh, q_s, k_bh, k_s, v_bh, v_s, kvb,
                           kvb_bh, bias, bias_bh, seed, drop_thresh,
                           drop_inv, sq, sk, q_start, k_start, causal, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  float* dsp = static_cast<float*>(ds);
  with_simt(dtype, d, [&](auto tag, auto nj) {
    using T = typename decltype(tag)::type;
    err = simt_launch(simt_dq_kernel<T, decltype(nj)::value>, smem_dq(d), sq,
                      bh, st, a, d, static_cast<const T*>(dout), do_bh, do_s,
                      static_cast<const float*>(lse),
                      static_cast<const float*>(delta),
                      static_cast<T*>(nullptr), dsp);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  dbias_sum(dsp, static_cast<float*>(dbias), bh, (long long)sq * sk, st);
  return static_cast<int>(cudaGetLastError());
}
