// Softmax cross-entropy over the rows of logits [N, V] (fp32 or bf16,
// read through their row stride; labels int32 or int64 [N]): the forward
// gives each row's label-smoothed loss and its logsumexp, the backward the
// logits' gradient recomputed from that logsumexp.
//
// Replaces the Pallas kernels of apex_tpu/ops/pallas/xentropy.py:
// xent_fwd -> _fwd_kernel (:55) and xent_bwd -> _bwd_kernel (:131).
//   loss_i = lse_i - (1 - eps) * x_i[y_i] - eps * sum_j(x_ij) / V
//   dx_ij  = g_i * (exp(x_ij - lse_i) - (1 - eps) * [j == y_i] - eps / V)
// A label outside [0, V) matches no column (the Pallas kernels' compare
// with the column index), so its row's x_y is 0. With eps = 0 the forward
// takes no row sum, as _fwd_kernel does. Pad rows are the caller's: the
// backward's g is already zero there.
//
// Bound on this card: bytes. The forward reads the logits once (an
// online max and sum of exponentials, so no second pass), the backward
// reads them once and writes dx once, with ~10 operations an element. At
// the Transformer-base translation step's shape, fp32 [16512, 37000]
// (2.444 GB): forward 2.444 GB read, 0.730 ms; backward 4.888 GB, 1.459 ms
// at 3.35 TB/s. What the design does about it: one block owns a row and
// streams it in 16-byte vector loads (four fp32 or eight bf16 values,
// when the row start, the row stride and V allow it, else one element a
// load), each thread keeping its own running max, scaled sum of
// exponentials and (eps > 0) plain sum in registers; the block merges its
// threads' partials in a fixed order (a warp butterfly, then warp 0 over
// the warps), so results repeat bit for bit. The TPU kernel's sequential
// vocab-tile grid and lane-replicated scratch have no counterpart: a
// block's loop over its row takes the place of the vocab grid axis.
//
// Rounding: the loss and dx follow the Pallas kernels' (and the plain
// versions') order of operations with the _rn intrinsics, which the
// compiler never contracts into FMAs; the kernels differ from the plain
// versions only in the order of the row's sums and max.

#include <type_traits>

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kMaxThreads = 256;

// values a 16-byte load holds
template <typename T> constexpr int vec16() { return 16 / sizeof(T); }

// VEC consecutive values as fp32: one 16-byte load when VEC is the full
// vector, else one element
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    o[0] = to_f(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    load4(p, o);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      o[2 * i] = __low2float(h);
      o[2 * i + 1] = __high2float(h);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    store4(p, v);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ long long label_of(const void* labels, int lab64,
                                              int row) {
  return lab64 ? static_cast<const long long*>(labels)[row]
               : static_cast<const int*>(labels)[row];
}

// (m, s) <- the running max and scaled sum of exponentials of both sets;
// kNegInf with s = 0 is the empty set
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
xent_fwd_kernel(const T* __restrict__ x, long long rs,
                const void* __restrict__ labels, int lab64, int v,
                float smoothing, float one_minus,
                float* __restrict__ loss, float* __restrict__ lse) {
  __shared__ float sm_m[kMaxThreads / 32], sm_s[kMaxThreads / 32],
      sm_x[kMaxThreads / 32];
  const int row = blockIdx.x;
  const T* xr = x + static_cast<long long>(row) * rs;
  const bool smooth = smoothing > 0.f;
  float m = kNegInf, s = 0.f, sum = 0.f;
  const int nvec = v / VEC;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float e[VEC];
    load_vec<T, VEC>(xr + static_cast<long long>(i) * VEC, e);
    float vm = e[0];
#pragma unroll
    for (int j = 1; j < VEC; ++j) vm = fmaxf(vm, e[j]);
    const float mn = fmaxf(m, vm);
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      t += expf(e[j] - mn);
      if (smooth) sum += e[j];
    }
    s = s * expf(m - mn) + t;
    m = mn;
  }
  // the block's partials in a fixed order: a butterfly in each warp (both
  // partners merge the same two operands), then warp 0 over the warps
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
          __shfl_xor_sync(0xffffffffu, s, o));
  }
  if (smooth) sum = warp_sum(sum);
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sm_m[warp] = m;
    sm_s[warp] = s;
    sm_x[warp] = sum;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  m = sm_m[0];
  s = sm_s[0];
  sum = sm_x[0];
  for (int w = 1; w < nw; ++w) {
    merge(m, s, sm_m[w], sm_s[w]);
    sum += sm_x[w];
  }
  const long long y = label_of(labels, lab64, row);
  const float xy = (y >= 0 && y < v) ? to_f(xr[y]) : 0.f;
  const float l = __fadd_rn(m, logf(s));
  float out = __fsub_rn(l, __fmul_rn(one_minus, xy));
  if (smooth) {
    out = __fsub_rn(out, __fdiv_rn(__fmul_rn(smoothing, sum),
                                   static_cast<float>(v)));
  }
  loss[row] = out;
  lse[row] = l;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
xent_bwd_kernel(const T* __restrict__ x, long long rs,
                const void* __restrict__ labels, int lab64,
                const float* __restrict__ lse, const float* __restrict__ g,
                int v, float one_minus, float eps_v, int smooth,
                T* __restrict__ dx) {
  const int row = blockIdx.x;
  const T* xr = x + static_cast<long long>(row) * rs;
  T* dr = dx + static_cast<long long>(row) * v;
  const float l = lse[row], gr = g[row];
  const long long y = label_of(labels, lab64, row);
  const int nvec = v / VEC;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float e[VEC];
    const long long col = static_cast<long long>(i) * VEC;
    load_vec<T, VEC>(xr + col, e);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float d = expf(__fsub_rn(e[j], l));
      if (col + j == y) d = __fsub_rn(d, one_minus);
      if (smooth) d = __fsub_rn(d, eps_v);
      e[j] = __fmul_rn(gr, d);
    }
    store_vec<T, VEC>(dr + col, e);
  }
}

// threads a row: enough to give most of them work at small V
int row_threads(int nvec) {
  int t = 32;
  while (t < kMaxThreads && t * 8 < nvec) t *= 2;
  return t;
}

template <typename F>
bool with_type(int dtype, F&& f) {
  switch (dtype) {
    case kF32: f(static_cast<float*>(nullptr)); return true;
    case kBF16: f(static_cast<__nv_bfloat16*>(nullptr)); return true;
    default: return false;
  }
}

}  // namespace
}  // namespace apex_port

// x [n, v] (fp32 or bf16) with row stride rs (elements; columns
// contiguous); labels [n] int32 (lab64 = 0) or int64; vec = 1 when the
// row start, rs and v all allow 16-byte loads. loss, lse fp32 [n].
extern "C" int apex_xent_fwd(int dtype, const void* x, long long rs,
                             const void* labels, int lab64, int n, int v,
                             int vec, float smoothing, float one_minus,
                             void* loss, void* lse, void* stream) {
  using namespace apex_port;
  if (n < 1 || v < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(loss);
  float* ep = static_cast<float*>(lse);
  const bool ok = with_type(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* xp = static_cast<const T*>(x);
    if (vec) {
      constexpr int V = vec16<T>();
      xent_fwd_kernel<T, V><<<n, row_threads(v / V), 0, st>>>(
          xp, rs, labels, lab64, v, smoothing, one_minus, lp, ep);
    } else {
      xent_fwd_kernel<T, 1><<<n, row_threads(v), 0, st>>>(
          xp, rs, labels, lab64, v, smoothing, one_minus, lp, ep);
    }
  });
  return static_cast<int>(ok ? cudaGetLastError() : cudaErrorInvalidValue);
}

// x, labels, vec as apex_xent_fwd; lse, g fp32 [n] contiguous; eps_v =
// eps / V, smooth = eps > 0; dx [n, v] contiguous, x's dtype.
extern "C" int apex_xent_bwd(int dtype, const void* x, long long rs,
                             const void* labels, int lab64, const void* lse,
                             const void* g, int n, int v, int vec,
                             float one_minus, float eps_v, int smooth,
                             void* dx, void* stream) {
  using namespace apex_port;
  if (n < 1 || v < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  const bool ok = with_type(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* xp = static_cast<const T*>(x);
    T* dp = static_cast<T*>(dx);
    if (vec) {
      constexpr int V = vec16<T>();
      xent_bwd_kernel<T, V><<<n, row_threads(v / V), 0, st>>>(
          xp, rs, labels, lab64, lp, gp, v, one_minus, eps_v, smooth, dp);
    } else {
      xent_bwd_kernel<T, 1><<<n, row_threads(v), 0, st>>>(
          xp, rs, labels, lab64, lp, gp, v, one_minus, eps_v, smooth, dp);
    }
  });
  return static_cast<int>(ok ? cudaGetLastError() : cudaErrorInvalidValue);
}
