// LayerNorm forward over the last dim: per-row mean and invvar (fp32) and
// the affine output y in x's dtype.
//
// Replaces the Pallas kernel apex_tpu/ops/pallas/layer_norm.py
// _ln_fwd_single -> _fwd_kernel (F <= 8192, one pass). Written in CUDA C++
// rather than Triton so the port has one build (nvcc) for all its kernels.
//
// Bound on this card: bytes. A row is read once and written once with
// ~8 flops per element, so the least time is
//   (rows * F * sizeof(x) + rows * F * sizeof(y)) / 3.35 TB/s
// (gamma, beta and the 8 bytes of row statistics are small beside it).
// What the design does about it: the row, gamma and beta are loaded from
// device memory once, together, into registers (F <= 1024: one warp per
// row, 32 values a lane; 1024 < F <= 8192: one 256-thread block per row,
// 32 values a thread; four values per load and store when F % 4 == 0),
// every statistic is computed from the registers, and y is written once. At the serving shapes (8 or 256 rows of 1024)
// the row count is far too small to reach the bound; the time is one
// memory round trip plus the launch.
// The arithmetic follows _fwd_kernel (layer_norm.py:56-66) in fp32:
// mean, then the mean of squared deviations, then rsqrt(var + eps), then
// (x - mean) * inv * gamma + beta.

#include <type_traits>

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kItems = 32;   // row values held per thread

// sum over the threads of one row: a warp butterfly, then (several warps
// per row) a pass through shared memory
template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if (WPR == 1) return v;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                 // red[] may still be read from before
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WPR; ++w) t += red[w];
  return t;
}

// two consecutive elements as fp32, one load (callers keep the address
// 2-element aligned); and stored so, rounding as from_f
__device__ __forceinline__ void load2(const float* p, float* o) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* o) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  o[0] = __low2float(v);
  o[1] = __high2float(v);
}
__device__ __forceinline__ void load2(const __half* p, float* o) {
  const __half2 v = *reinterpret_cast<const __half2*>(p);
  o[0] = __low2float(v);
  o[1] = __high2float(v);
}
__device__ __forceinline__ void store2(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}
__device__ __forceinline__ void store2(__half* p, const float* v) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v[0], v[1]);
}

// VEC consecutive values of a row as fp32 (one vector load when VEC is 4
// or 2); ``fill`` where the columns lie past the row
template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* p, bool in, float fill,
                                         float* o) {
  if (VEC == 4 && in) {
    float t4[4];
    load4(p, t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = t4[e];
  } else if (VEC == 2 && in) {
    load2(p, o);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = in ? to_f(p[e]) : fill;
  }
}

// VEC fp32 values stored as T (one vector store when VEC is 4 or 2)
template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (VEC == 4) {
    const float t4[4] = {v[0], v[1], v[2], v[3]};
    store4(p, t4);
  } else if constexpr (VEC == 2) {
    store2(p, v);
  } else {
    p[0] = from_f<T>(v[0]);
  }
}

// WPR warps per row; with WPR == 1 a block holds 4 rows (one per warp),
// with WPR > 1 a block holds one row. Thread t holds the VEC-wide column
// groups t, t + 32*WPR, ... (VEC is 4 when F % 4 == 0 and every pointer is
// 4-element aligned, so a group is all inside the row or all past it)
template <typename T, typename W, int WPR, int VEC>
__global__ void __launch_bounds__(128 * (WPR == 1) + 32 * WPR * (WPR > 1))
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
              const W* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ inv_out,
              int rows, int F, float eps) {
  constexpr int kRowThreads = 32 * WPR;
  constexpr int kGroups = kItems / VEC;
  __shared__ float red[WPR];
  const int row = WPR == 1 ? blockIdx.x * 4 + (threadIdx.x >> 5)
                           : blockIdx.x;
  if (row >= rows) return;         // whole warp (WPR 1) or whole block
  const int t = WPR == 1 ? (threadIdx.x & 31) : threadIdx.x;
  const T* xr = x + (size_t)row * F;
  const bool affine = gamma != nullptr;

  // x, gamma and beta are all loaded up front, so the row costs one
  // memory round trip, not one before and one after the reductions
  float v[kItems], g[kItems], b[kItems];
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int c = (i * kRowThreads + t) * VEC;
    const bool in = c < F;
    load_vec<VEC>(xr + c, in, 0.f, v + i * VEC);
    load_vec<VEC>(affine ? gamma + c : nullptr, in && affine, 1.f,
                  g + i * VEC);
    load_vec<VEC>(affine ? beta + c : nullptr, in && affine, 0.f,
                  b + i * VEC);
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) sum += v[i];
  const float mean = row_sum<WPR>(sum, red) / F;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int c = (i / VEC * kRowThreads + t) * VEC;
    const float d = v[i] - mean;
    sq += c < F ? d * d : 0.f;
  }
  const float var = row_sum<WPR>(sq, red) / F;
  const float inv = rsqrtf(var + eps);
  T* yr = y + (size_t)row * F;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int c = (i * kRowThreads + t) * VEC;
    if (c < F) {
      float o[4];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = (v[i * VEC + e] - mean) * inv;
        o[e] = affine ? xh * g[i * VEC + e] + b[i * VEC + e] : xh;
      }
      if (VEC == 4) {
        store4(yr + c, o);
      } else {
        yr[c] = from_f<T>(o[0]);
      }
    }
  }
  if (t == 0) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }
}

template <typename T, typename W, int VEC>
void launch_vec(const T* x, const W* g, const W* b, T* y, float* mean,
                float* inv, int rows, int F, float eps, cudaStream_t st) {
  if (F <= 32 * kItems) {
    ln_fwd_kernel<T, W, 1, VEC><<<(rows + 3) / 4, 128, 0, st>>>(
        x, g, b, y, mean, inv, rows, F, eps);
  } else {
    ln_fwd_kernel<T, W, 8, VEC><<<rows, 256, 0, st>>>(
        x, g, b, y, mean, inv, rows, F, eps);
  }
}

template <typename P>
bool aligned4(const P* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(P)) == 0;
}

template <typename T, typename W>
void launch(const void* x, const void* g, const void* b, void* y,
            float* mean, float* inv, int rows, int F, float eps,
            cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const W* gp = static_cast<const W*>(g);
  const W* bp = static_cast<const W*>(b);
  T* yp = static_cast<T*>(y);
  if (F % 4 == 0 && aligned4(xp) && aligned4(yp) && aligned4(gp) &&
      aligned4(bp)) {
    launch_vec<T, W, 4>(xp, gp, bp, yp, mean, inv, rows, F, eps, st);
  } else {
    launch_vec<T, W, 1>(xp, gp, bp, yp, mean, inv, rows, F, eps, st);
  }
}

template <typename T>
int launch_x(int w_dtype, const void* x, const void* g, const void* b,
             void* y, float* mean, float* inv, int rows, int F, float eps,
             cudaStream_t st) {
  if (w_dtype == kF32) {
    launch<T, float>(x, g, b, y, mean, inv, rows, F, eps, st);
  } else if (w_dtype == kBF16) {
    launch<T, __nv_bfloat16>(x, g, b, y, mean, inv, rows, F, eps, st);
  } else if (w_dtype == kF16) {
    launch<T, __half>(x, g, b, y, mean, inv, rows, F, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace
}  // namespace apex_port

// x, y [rows, F] (F <= 8192); gamma/beta [F] or both null; mean/invvar
// fp32 [rows]. Returns cudaGetLastError() after the launch.
extern "C" int apex_layer_norm_fwd(int x_dtype, int w_dtype, const void* x,
                                   const void* gamma, const void* beta,
                                   void* y, void* mean, void* invvar,
                                   int rows, int F, float eps,
                                   void* stream) {
  using namespace apex_port;
  if (F < 1 || F > 8 * 32 * kItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* iv = static_cast<float*>(invvar);
  int rc;
  switch (x_dtype) {
    case kF32:
      rc = launch_x<float>(w_dtype, x, gamma, beta, y, m, iv, rows, F, eps,
                           st);
      break;
    case kBF16:
      rc = launch_x<__nv_bfloat16>(w_dtype, x, gamma, beta, y, m, iv, rows,
                                   F, eps, st);
      break;
    case kF16:
      rc = launch_x<__half>(w_dtype, x, gamma, beta, y, m, iv, rows, F,
                            eps, st);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// ---- backward --------------------------------------------------------------
//
// Replaces the Pallas kernel apex_tpu/ops/pallas/layer_norm.py
// _ln_bwd_single -> _bwd_kernel (F <= 8192): per row
//   xhat = (x - mean) * invvar,  dxhat = dy * gamma (dy without gamma),
//   dx = invvar * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
// and the column sums gamma_grad = sum(dy * xhat), beta_grad = sum(dy).
//
// Bound on this card: bytes. dy and x are read once and dx written once
// with ~12 flops per element; at the LM's [32760, 1024] bf16 that is
// 3 x 67 MB, 0.060 ms at 3.35 TB/s. What the design does about it: a row
// is loaded once into registers (the forward's layout: one warp per row up
// to F = 1024, one 256-thread block per row above, 4-wide vector loads
// where F % 4 == 0 and the buffers are 4-element aligned, else the VEC-1
// form, one value a load),
// both row sums come from the registers and dx is written once. Each block
// walks a fixed chunk of rows, so a thread keeps its columns' gamma and
// its running column sums in registers across the chunk; the block writes
// one partial row of each column sum, and finalize_kernel (common.cuh)
// adds the chunks in a fixed order. The TPU kernel carries the sums across
// its sequential grid; here there are no float atomics, so the gradients
// repeat bit for bit between runs.

namespace apex_port {
namespace {

// the VEC-wide column groups of thread t: c = (i * kRowThreads + t) * VEC
// (VEC is 4 when F % 4 == 0 and every buffer is 4-element aligned, else 1)
template <typename T, typename W, int WPR, bool AFFINE, int VEC>
__device__ __forceinline__ void ln_bwd_row(
    const T* __restrict__ dyr, const T* __restrict__ xr,
    const float (&g)[kItems], float mean, float inv, T* __restrict__ dxr,
    int F, int t, float* red, float (&gw)[kItems], float (&gb)[kItems]) {
  constexpr int kRowThreads = 32 * WPR;
  constexpr int kGroups = kItems / VEC;
  float d[kItems], xh[kItems];
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int c = (i * kRowThreads + t) * VEC;
    const bool in = c < F;
    load_vec<VEC>(dyr + c, in, 0.f, d + i * VEC);
    load_vec<VEC>(xr + c, in, 0.f, xh + i * VEC);
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    xh[i] = (xh[i] - mean) * inv;      // past F: dy is 0, so nothing counts
    const float dxh = AFFINE ? d[i] * g[i] : d[i];
    s1 += dxh;
    s2 += dxh * xh[i];
    if (AFFINE) {
      gw[i] += d[i] * xh[i];
      gb[i] += d[i];
    }
  }
  const float m1 = row_sum<WPR>(s1, red) / F;
  const float m2 = row_sum<WPR>(s2, red) / F;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int c = (i * kRowThreads + t) * VEC;
    if (c < F) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int j = i * VEC + e;
        const float dxh = AFFINE ? d[j] * g[j] : d[j];
        o[e] = inv * (dxh - m1 - xh[j] * m2);
      }
      store_vec<VEC>(dxr + c, o);
    }
  }
}

// one warp's column sums -> sh[warp][F] (WPR == 1: F <= 1024)
template <int VEC>
__device__ __forceinline__ void stage_cols(const float (&a)[kItems], float* sh,
                                           int F) {
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kItems / VEC; ++i) {
    const int c = (i * 32 + t) * VEC;
    if (c < F) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sh[warp * F + c + e] = a[i * VEC + e];
    }
  }
}

// WPR == 1: a block of 4 warps, a warp per row; WPR == 8: a block of 256
// threads on one row at a time. Block b walks rows [b * rpc, (b+1) * rpc)
// and writes its column sums to ws[0][b][:] and ws[1][b][:].
template <typename T, typename W, int WPR, bool AFFINE, int VEC>
__global__ void __launch_bounds__(WPR == 1 ? 128 : 32 * WPR)
ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
              const W* __restrict__ gamma, const float* __restrict__ mean,
              const float* __restrict__ inv, T* __restrict__ dx,
              float* __restrict__ ws, int rows, int F, int rpc, int nchunk) {
  constexpr int kRowThreads = 32 * WPR;
  __shared__ float red[WPR];
  const int warp = threadIdx.x >> 5;
  const int t = WPR == 1 ? (threadIdx.x & 31) : threadIdx.x;
  float g[kItems], gw[kItems], gb[kItems];
#pragma unroll
  for (int i = 0; i < kItems / VEC; ++i) {
    const int c = (i * kRowThreads + t) * VEC;
    load_vec<VEC>(AFFINE ? gamma + c : nullptr, AFFINE && c < F, 1.f,
                  g + i * VEC);
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) gw[i] = gb[i] = 0.f;
  const int r0 = blockIdx.x * rpc;
  const int r1 = r0 + rpc < rows ? r0 + rpc : rows;
  for (int r = r0 + (WPR == 1 ? warp : 0); r < r1; r += (WPR == 1 ? 4 : 1)) {
    ln_bwd_row<T, W, WPR, AFFINE, VEC>(dy + (size_t)r * F,
                                       x + (size_t)r * F, g, mean[r],
                                       inv[r], dx + (size_t)r * F, F, t,
                                       red, gw, gb);
  }
  if (!AFFINE) return;
  float* w0 = ws + (size_t)blockIdx.x * F;
  float* w1 = ws + ((size_t)nchunk + blockIdx.x) * F;
  if (WPR == 1) {
    // the four warps' sums, added in warp order
    __shared__ float sh[4 * 32 * kItems];
    stage_cols<VEC>(gw, sh, F);
    __syncthreads();
    for (int c = threadIdx.x; c < F; c += 128) {
      w0[c] = ((sh[c] + sh[F + c]) + sh[2 * F + c]) + sh[3 * F + c];
    }
    __syncthreads();
    stage_cols<VEC>(gb, sh, F);
    __syncthreads();
    for (int c = threadIdx.x; c < F; c += 128) {
      w1[c] = ((sh[c] + sh[F + c]) + sh[2 * F + c]) + sh[3 * F + c];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems / VEC; ++i) {
      const int c = (i * kRowThreads + t) * VEC;
      if (c < F) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          w0[c + e] = gw[i * VEC + e];
          w1[c + e] = gb[i * VEC + e];
        }
      }
    }
  }
}

template <typename T, typename W, bool AFFINE>
void launch_bwd(const void* dy, const void* x, const void* gamma,
                const float* mean, const float* inv, void* dx, float* ws,
                float* gw, float* gb, int rows, int F, int rpc, int nchunk,
                cudaStream_t st) {
  const T* d = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const W* g = static_cast<const W*>(gamma);
  T* o = static_cast<T*>(dx);
  auto run = [&](auto vec) {
    constexpr int V = decltype(vec)::value;
    if (F <= 32 * kItems) {
      ln_bwd_kernel<T, W, 1, AFFINE, V><<<nchunk, 128, 0, st>>>(
          d, xp, g, mean, inv, o, ws, rows, F, rpc, nchunk);
    } else {
      ln_bwd_kernel<T, W, 8, AFFINE, V><<<nchunk, 256, 0, st>>>(
          d, xp, g, mean, inv, o, ws, rows, F, rpc, nchunk);
    }
  };
  if (F % 4 == 0 && aligned4(d) && aligned4(xp) && aligned4(g) &&
      aligned4(o)) {
    run(std::integral_constant<int, 4>{});
  } else {
    run(std::integral_constant<int, 1>{});
  }
  if (AFFINE) {
    finalize_kernel<<<(F + 31) / 32, dim3(32, 32), 0, st>>>(ws, nchunk, F,
                                                            gw, gb);
  }
}

template <typename T>
int launch_bwd_x(int w_dtype, const void* dy, const void* x,
                 const void* gamma, const float* mean, const float* inv,
                 void* dx, float* ws, float* gw, float* gb, int rows, int F,
                 int rpc, int nchunk, cudaStream_t st) {
  if (gamma == nullptr) {
    launch_bwd<T, float, false>(dy, x, gamma, mean, inv, dx, ws, gw, gb, rows,
                                F, rpc, nchunk, st);
  } else if (w_dtype == kF32) {
    launch_bwd<T, float, true>(dy, x, gamma, mean, inv, dx, ws, gw, gb, rows,
                               F, rpc, nchunk, st);
  } else if (w_dtype == kBF16) {
    launch_bwd<T, __nv_bfloat16, true>(dy, x, gamma, mean, inv, dx, ws, gw,
                                       gb, rows, F, rpc, nchunk, st);
  } else if (w_dtype == kF16) {
    launch_bwd<T, __half, true>(dy, x, gamma, mean, inv, dx, ws, gw, gb,
                                rows, F, rpc, nchunk, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace
}  // namespace apex_port

// dy, x, dx [rows, F] in one dtype, F <= 8192 (four columns a load where F
// % 4 == 0 and every buffer is 4-element aligned, else one); gamma [F] or
// null (non-affine: ws, gw, gb unused); mean, invvar fp32 [rows]; ws fp32
// [2, nchunk, F] scratch; gw, gb fp32 [F]. Block b of nchunk takes rows
// [b * rpc, (b+1) * rpc).
extern "C" int apex_layer_norm_bwd(int x_dtype, int w_dtype, const void* dy,
                                   const void* x, const void* gamma,
                                   const void* mean, const void* invvar,
                                   void* dx, void* ws, void* gw, void* gb,
                                   int rows, int F, int rpc, int nchunk,
                                   void* stream) {
  using namespace apex_port;
  if (F < 1 || F > 8 * 32 * kItems || rows < 1 || rpc < 1 ||
      nchunk < 1 || (long long)rpc * nchunk < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(invvar);
  float* w = static_cast<float*>(ws);
  float* o0 = static_cast<float*>(gw);
  float* o1 = static_cast<float*>(gb);
  int rc;
  switch (x_dtype) {
    case kF32:
      rc = launch_bwd_x<float>(w_dtype, dy, x, gamma, m, iv, dx, w, o0, o1,
                               rows, F, rpc, nchunk, st);
      break;
    case kBF16:
      rc = launch_bwd_x<__nv_bfloat16>(w_dtype, dy, x, gamma, m, iv, dx, w,
                                       o0, o1, rows, F, rpc, nchunk, st);
      break;
    case kF16:
      rc = launch_bwd_x<__half>(w_dtype, dy, x, gamma, m, iv, dx, w, o0, o1,
                                rows, F, rpc, nchunk, st);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// ---- wide rows (F > 8192) --------------------------------------------------
//
// Replaces the Pallas kernels of the two-stage wide path of
// apex_tpu/ops/pallas/layer_norm.py: _ln_fwd_wide -> _wide_moments_kernel
// (:201) and _wide_apply_kernel (:227); _ln_bwd_wide ->
// _wide_bwd_reduce_kernel (:288), _wide_gwgb_kernel (:310) and
// _wide_dx_kernel (:331). Four kernels here do the work of those five:
//   ln_wide_row_kernel      F <= kRowMax: a block holds the row in its
//                           registers; mean, variance and y (rows 5-6)
//   ln_wide_stats_kernel    per (row, chunk): s = sum(x - shift) and
//                           q = sum((x - shift - s/n)^2)            (row 5)
//   ln_wide_apply_kernel    merge a row's chunks, y = (x-mean)*inv*g+b (row 6)
//   ln_wide_bwd_reduce_kernel  F > kRowMax, per (row, chunk): sum(dy*g),
//                           sum(dy*g*xhat); per (row block, column):
//                           sum(dy*xhat), sum(dy)                (rows 7-8)
//   ln_wide_bwd_dx_kernel   merge a row's chunks, dx                 (row 9)
// and finalize_kernel (common.cuh) adds the row blocks' column sums. The
// backward of rows up to kRowMax is one pass of its own,
// csrc/ln_bwd_row.cu (ln_wide_bwd_row_kernel), which reads dy and x once.
//
// Bound on this card: bytes. The forward reads x and writes y, the backward
// reads dy and x and writes dx, with ~10 flops per element: at the LM's
// [8192, 12288] bf16, 403 MB (0.120 ms at 3.35 TB/s) and 604 MB (0.180
// ms). A row runs from 12288 up to hundreds of thousands of values (a
// LayerNorm over a [C, H, W] map). Up to kRowMax (16384) one block of up to
// 512 threads holds a row in its registers, 32 values a thread, and the
// forward reads x once and writes y once (ln_wide_row_kernel): the row's
// values and their shift are all the registers a thread keeps, gamma and
// beta being read where y is written (every block reads the same ones, from
// L1), so that three blocks of 384 threads share an SM. Past that the row
// is cut into chunks of kWideCols columns and each chunk is its own
// block's work: the forward reads x twice (statistics, then y) and the
// backward dy and x twice (sums, then dx), 1.5 and 1.67 times the bound's
// bytes (the backward only there: to kRowMax it is csrc/ln_bwd_row.cu's).
// What the design does about the rest: a warp takes one (row, chunk) at a
// time, each lane 32 values by eight 4-wide vector loads (or,
// where F % 4 != 0 or a buffer is not 4-element aligned, the VEC-1 form's
// 32 scalar loads; the backward takes sixteen 2-wide loads, the VEC-2
// form, where F is even and every buffer 2-element aligned), all
// issued before the first is used; gamma and beta of the block's chunk are
// loaded once into registers; the backward's column sums stay in registers
// across the block's rows. Statistics: each chunk's sum of squares is
// centred on its own mean (from registers), after a per-row shift (the
// row's first value) that keeps the sums small when |mean| >> std; the
// chunks merge as var * F = sum(q_j + n_j * (s_j / n_j - s / F)^2), a sum
// of non-negative terms that cannot cancel. Every sum runs in a fixed
// order (lanes, then a butterfly; chunks strided over lanes, then a
// butterfly; warps in order; row blocks in order), with no float atomics,
// so both passes repeat bit for bit. Indices are 64-bit: rows * F passes
// 2^31 at these widths.

namespace apex_port {
namespace {

constexpr int kWideCols = 32 * kItems;   // columns of a chunk: 32 lanes x 32
constexpr int kWideWarps = 8;            // warps of a block (256 threads)

inline int wide_chunks(long long F) {
  return static_cast<int>((F + kWideCols - 1) / kWideCols);
}

// the columns of chunk j of a row of F (the last chunk may be short)
__device__ __forceinline__ int chunk_cols(long long F, int j) {
  const long long left = F - (long long)j * kWideCols;
  return left < kWideCols ? static_cast<int>(left) : kWideCols;
}

// lane's column of group i inside a chunk: c = (i * 32 + lane) * VEC (VEC
// 4 when F % 4 == 0 and every buffer is 4-element aligned, else 1; the
// backward's 2 where F is even and every buffer 2-element aligned). The
// chunk's base is a multiple of 1024 and, for VEC 2, a row's of 2, so the
// columns a lane holds are the same in every row: the backward's column
// sums stay in registers across rows. (A 4-wide body peeled per row where
// F % 4 == 2 would move them from row to row.)
template <int VEC>
__device__ __forceinline__ int wide_col(int i, int lane) {
  return (i * 32 + lane) * VEC;
}

// a chunk's kItems columns of a [F] vector into a lane's registers
template <int VEC, typename W>
__device__ __forceinline__ void load_chunk_vec(const W* p, long long c0,
                                               int n, int lane, float fill,
                                               float (&o)[kItems]) {
#pragma unroll
  for (int i = 0; i < kItems / VEC; ++i) {
    const int c = wide_col<VEC>(i, lane);
    load_vec<VEC>(p != nullptr ? p + c0 + c : nullptr, p != nullptr && c < n,
                  fill, o + i * VEC);
  }
}

// a row's per-chunk partials a_j = part[(row * nchunk + j) * 2 + k],
// summed in a fixed order (lane-strided, then a butterfly): every lane and
// every block of the row gets the same bits
__device__ __forceinline__ float merge_chunks(const float* pr, int nchunk,
                                              int k, int lane) {
  float s = 0.f;
  for (int j = lane; j < nchunk; j += 32) s += pr[2 * j + k];
  return warp_sum(s);
}

constexpr int kRowWarpsMax = 16;                    // 512 threads
constexpr long long kRowMax = 32LL * kRowWarpsMax * kItems;   // 16384

// the sum of v over the block's threads (every thread gets it): lanes,
// then warps in order
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();                 // red[] may still be read from before
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

// the registers a thread holds VEC row values in, as loaded
template <typename T, int VEC>
struct RowRaw {
  using type = T;
};
template <typename T>
struct RowRaw<T, 4> {
  using type = typename Raw4<T>::type;
};

// block b takes row b, thread t the VEC-wide column groups t, t +
// blockDim, ... (blockDim.x = 32 * ceil(F / 1024)): the statistics as the
// chunked form computes them (a shift by the row's first value, then the
// centred sum of squares), here from registers over the whole row. A
// thread holds its 32 values as loaded (16 registers of bf16 at VEC 4), so
// that with 16-bit rows at most 64 registers a thread let three blocks of
// 384 threads share an SM (fp32 rows take what their 32 values need).
// (The VEC-1 form's 32 scalars take a register each: one block an SM.)
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(32 * kRowWarpsMax,
                                  sizeof(T) == 4 || VEC == 1 ? 1 : 2)
ln_wide_row_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
                   const W* __restrict__ beta, T* __restrict__ y,
                   float* __restrict__ mean_out,
                   float* __restrict__ inv_out, long long F, float eps) {
  using R = typename RowRaw<T, VEC>::type;
  constexpr int kGroups = kItems / VEC;
  __shared__ float red[kRowWarpsMax];
  const long long row = blockIdx.x;
  const int t = threadIdx.x, nt = blockDim.x;
  const T* xr = x + row * F;
  const float shift = to_f(xr[0]);
  R raw[kGroups];
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int c = (i * nt + t) * VEC;
    raw[i] = c < F ? *reinterpret_cast<const R*>(xr + c) : R{};
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    float v[VEC];
    unpack(raw[i], v, xr);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s += (i * nt + t) * VEC < F ? v[e] - shift : 0.f;
    }
  }
  const float Ff = static_cast<float>(F);
  const float dmean = block_sum(s, red) / Ff;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    float v[VEC];
    unpack(raw[i], v, xr);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = (v[e] - shift) - dmean;
      q += (i * nt + t) * VEC < F ? d * d : 0.f;
    }
  }
  const float inv = rsqrtf(block_sum(q, red) / Ff + eps);
  T* yr = y + row * F;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int c = (i * nt + t) * VEC;
    if (c < F) {
      float v[VEC], g[VEC], b[VEC], o[VEC];
      unpack(raw[i], v, xr);
      load_vec<VEC>(gamma + c, gamma != nullptr, 1.f, g);
      load_vec<VEC>(beta + c, beta != nullptr, 0.f, b);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        // (x - shift) - dmean: exact to the shift's precision even where
        // the mean is large beside the spread
        const float xh = ((v[e] - shift) - dmean) * inv;
        o[e] = gamma != nullptr ? xh * g[e] + b[e] : xh;
      }
      store_vec<VEC>(yr + c, o);
    }
  }
  if (t == 0) {
    mean_out[row] = shift + dmean;
    inv_out[row] = inv;
  }
}

// grid (nchunk, row groups); warp w of block (j, b) takes chunk j of rows
// b * 8 + w, then + 8 * gridDim.y, ...
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kWideWarps)
ln_wide_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                     long long rows, long long F) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x, nchunk = gridDim.x;
  const long long c0 = (long long)j * kWideCols;
  const int n = chunk_cols(F, j);
  for (long long row = (long long)blockIdx.y * kWideWarps + warp; row < rows;
       row += (long long)gridDim.y * kWideWarps) {
    const T* xr = x + row * F;
    const float shift = to_f(xr[0]);
    float d[kItems];
#pragma unroll
    for (int i = 0; i < kItems / VEC; ++i) {
      const int c = wide_col<VEC>(i, lane);
      load_vec<VEC>(xr + c0 + c, c < n, shift, d + i * VEC);
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      d[i] -= shift;                  // past the row: 0
      s += d[i];
    }
    s = warp_sum(s);
    const float m = s / static_cast<float>(n);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const float e = d[i] - m;
      q += wide_col<VEC>(i / VEC, lane) + i % VEC < n ? e * e : 0.f;
    }
    q = warp_sum(q);
    if (lane == 0) {
      float* pr = part + (row * nchunk + j) * 2;
      pr[0] = s;
      pr[1] = q;
    }
  }
}

template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(32 * kWideWarps)
ln_wide_apply_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
                     const W* __restrict__ beta,
                     const float* __restrict__ part, T* __restrict__ y,
                     float* __restrict__ mean_out,
                     float* __restrict__ inv_out, long long rows,
                     long long F, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x, nchunk = gridDim.x;
  const long long c0 = (long long)j * kWideCols;
  const int n = chunk_cols(F, j);
  const bool affine = gamma != nullptr;
  const float Ff = static_cast<float>(F);
  float g[kItems], b[kItems];
  load_chunk_vec<VEC>(gamma, c0, n, lane, 1.f, g);
  load_chunk_vec<VEC>(beta, c0, n, lane, 0.f, b);
  for (long long row = (long long)blockIdx.y * kWideWarps + warp; row < rows;
       row += (long long)gridDim.y * kWideWarps) {
    const T* xr = x + row * F;
    const float* pr = part + row * nchunk * 2;
    const float shift = to_f(xr[0]);
    const float dmean = merge_chunks(pr, nchunk, 0, lane) / Ff;
    float q = 0.f;
    for (int k = lane; k < nchunk; k += 32) {
      const float nk = static_cast<float>(chunk_cols(F, k));
      const float dk = pr[2 * k] / nk - dmean;
      q += pr[2 * k + 1] + nk * dk * dk;
    }
    const float inv = rsqrtf(warp_sum(q) / Ff + eps);
    float v[kItems];
#pragma unroll
    for (int i = 0; i < kItems / VEC; ++i) {
      const int c = wide_col<VEC>(i, lane);
      load_vec<VEC>(xr + c0 + c, c < n, 0.f, v + i * VEC);
    }
    T* yr = y + row * F + c0;
#pragma unroll
    for (int i = 0; i < kItems / VEC; ++i) {
      const int c = wide_col<VEC>(i, lane);
      if (c < n) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int k = i * VEC + e;
          // (x - shift) - dmean: exact to the shift's precision even
          // where the mean is large beside the spread
          const float xh = ((v[k] - shift) - dmean) * inv;
          o[e] = affine ? xh * g[k] + b[k] : xh;
        }
        store_vec<VEC>(yr + c, o);
      }
    }
    if (j == 0 && lane == 0) {
      mean_out[row] = shift + dmean;
      inv_out[row] = inv;
    }
  }
}

// the block's eight warps' column sums of one chunk, added in warp order,
// -> out[0..n)
template <int VEC>
__device__ __forceinline__ void store_block_cols(
    const float (&a)[kItems], float (*sh)[kWideCols], float* out, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    sh[warp][wide_col<VEC>(i / VEC, lane) + i % VEC] = a[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += 32 * kWideWarps) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWideWarps; ++w) t += sh[w][c];
    out[c] = t;
  }
  __syncthreads();                 // sh is staged again next
}

// grid (nchunk, nrb); block (j, b) takes chunk j of rows [b * rpc,
// (b+1) * rpc), warp w the rows r0 + w, r0 + w + 8, ...; writes each row's
// chunk sums to rpart[row][j][0..1] and, AFFINE, the block's column sums
// to ws[0][b][cols of j], ws[1][b][cols of j]
template <typename T, typename W, bool AFFINE, int VEC>
__global__ void __launch_bounds__(32 * kWideWarps)
ln_wide_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                          const W* __restrict__ gamma,
                          const float* __restrict__ mean,
                          const float* __restrict__ inv,
                          float* __restrict__ rpart, float* __restrict__ ws,
                          long long rows, long long F, long long rpc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x, nchunk = gridDim.x;
  const long long c0 = (long long)j * kWideCols;
  const int n = chunk_cols(F, j);
  float g[kItems], gw[kItems], gb[kItems];
  load_chunk_vec<VEC>(AFFINE ? gamma : nullptr, c0, n, lane, 1.f, g);
#pragma unroll
  for (int i = 0; i < kItems; ++i) gw[i] = gb[i] = 0.f;
  const long long r0 = (long long)blockIdx.y * rpc;
  const long long r1 = r0 + rpc < rows ? r0 + rpc : rows;
  for (long long row = r0 + warp; row < r1; row += kWideWarps) {
    const float mu = mean[row], iv = inv[row];
    const T* dr = dy + row * F + c0;
    const T* xr = x + row * F + c0;
    float d[kItems], xh[kItems];
#pragma unroll
    for (int i = 0; i < kItems / VEC; ++i) {
      const int c = wide_col<VEC>(i, lane);
      load_vec<VEC>(dr + c, c < n, 0.f, d + i * VEC);   // past the row: dy 0
      load_vec<VEC>(xr + c, c < n, mu, xh + i * VEC);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      xh[i] = (xh[i] - mu) * iv;
      const float dxh = AFFINE ? d[i] * g[i] : d[i];
      s1 += dxh;
      s2 += dxh * xh[i];
      if (AFFINE) {
        gw[i] += d[i] * xh[i];
        gb[i] += d[i];
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      float* pr = rpart + (row * nchunk + j) * 2;
      pr[0] = s1;
      pr[1] = s2;
    }
  }
  if (!AFFINE) return;
  __shared__ float sh[kWideWarps][kWideCols];
  store_block_cols<VEC>(gw, sh, ws + (long long)blockIdx.y * F + c0, n);
  store_block_cols<VEC>(gb, sh,
                   ws + ((long long)gridDim.y + blockIdx.y) * F + c0, n);
}

// grid (nchunk, row groups) as the forward's; dx = inv * (dy * g - m1 -
// xhat * m2) with m1, m2 the row's merged sums over F
template <typename T, typename W, bool AFFINE, int VEC>
__global__ void __launch_bounds__(32 * kWideWarps)
ln_wide_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                      const W* __restrict__ gamma,
                      const float* __restrict__ mean,
                      const float* __restrict__ inv,
                      const float* __restrict__ rpart, T* __restrict__ dx,
                      long long rows, long long F) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x, nchunk = gridDim.x;
  const long long c0 = (long long)j * kWideCols;
  const int n = chunk_cols(F, j);
  const float Ff = static_cast<float>(F);
  float g[kItems];
  load_chunk_vec<VEC>(AFFINE ? gamma : nullptr, c0, n, lane, 1.f, g);
  for (long long row = (long long)blockIdx.y * kWideWarps + warp; row < rows;
       row += (long long)gridDim.y * kWideWarps) {
    const float* pr = rpart + row * nchunk * 2;
    const float m1 = merge_chunks(pr, nchunk, 0, lane) / Ff;
    const float m2 = merge_chunks(pr, nchunk, 1, lane) / Ff;
    const float mu = mean[row], iv = inv[row];
    const T* dr = dy + row * F + c0;
    const T* xr = x + row * F + c0;
    float d[kItems], v[kItems];
#pragma unroll
    for (int i = 0; i < kItems / VEC; ++i) {
      const int c = wide_col<VEC>(i, lane);
      load_vec<VEC>(dr + c, c < n, 0.f, d + i * VEC);
      load_vec<VEC>(xr + c, c < n, mu, v + i * VEC);
    }
    T* out = dx + row * F + c0;
#pragma unroll
    for (int i = 0; i < kItems / VEC; ++i) {
      const int c = wide_col<VEC>(i, lane);
      if (c < n) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int k = i * VEC + e;
          const float xh = (v[k] - mu) * iv;
          const float dxh = AFFINE ? d[k] * g[k] : d[k];
          o[e] = iv * (dxh - m1 - xh * m2);
        }
        store_vec<VEC>(out + c, o);
      }
    }
  }
}

// row groups of eight for the forward's and dx's grid (a block strides
// over the rest)
inline unsigned wide_row_groups(long long rows) {
  const long long g = (rows + kWideWarps - 1) / kWideWarps;
  return static_cast<unsigned>(g < 65535 ? g : 65535);
}

inline bool bad_wide_shape(long long rows, long long F) {
  return rows < 1 || F < 1 || wide_chunks(F) > 0x7fffffffLL / 2;
}

// calls f(std::integral_constant<int, VEC>): 4 when F % 4 == 0 and every
// buffer given is 4-element aligned (a null one counts as aligned), else 1
template <typename Fn, typename... Ps>
void with_vec(long long F, Fn&& f, const Ps*... ps) {
  if (F % 4 == 0 && (aligned4(ps) && ...)) {
    f(std::integral_constant<int, 4>{});
  } else {
    f(std::integral_constant<int, 1>{});
  }
}

template <typename P>
bool aligned2(const P* p) {
  return reinterpret_cast<uintptr_t>(p) % (2 * sizeof(P)) == 0;
}

// the wide backward's with_vec: 4, then 2 where F is even and every buffer
// given is 2-element aligned, then 1
template <typename Fn, typename... Ps>
void with_vec_bwd(long long F, Fn&& f, const Ps*... ps) {
  if (F % 4 == 0 && (aligned4(ps) && ...)) {
    f(std::integral_constant<int, 4>{});
  } else if (F % 2 == 0 && (aligned2(ps) && ...)) {
    f(std::integral_constant<int, 2>{});
  } else {
    f(std::integral_constant<int, 1>{});
  }
}

}  // namespace
}  // namespace apex_port

// x, y [rows, F] (four columns a load where F % 4 == 0 and every buffer
// is 4-element aligned, else one); gamma/beta [F] or both null;
// mean/invvar fp32 [rows]; part fp32 [rows, ceil(F / 1024), 2] scratch. F
// <= kRowMax takes one launch, a block a row, and leaves part unused; wider
// rows two launches, the row in chunks. Returns cudaGetLastError().
extern "C" int apex_layer_norm_fwd_wide(int x_dtype, int w_dtype,
                                        const void* x, const void* gamma,
                                        const void* beta, void* y,
                                        void* mean, void* invvar, void* part,
                                        long long rows, long long F,
                                        float eps, void* stream) {
  using namespace apex_port;
  if (bad_wide_shape(rows, F) || part == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool one_pass = F <= kRowMax && rows <= 0x7fffffffLL;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(wide_chunks(F), wide_row_groups(rows));
  float* pt = static_cast<float*>(part);
  const bool ok = with_x_w(x_dtype, w_dtype, gamma != nullptr,
                           [&](auto xt, auto wt, auto) {
    using T = typename decltype(xt)::type;
    using W = typename decltype(wt)::type;
    const T* xp = static_cast<const T*>(x);
    const W* gp = static_cast<const W*>(gamma);
    const W* bp = static_cast<const W*>(beta);
    T* yp = static_cast<T*>(y);
    float* mp = static_cast<float*>(mean);
    float* ip = static_cast<float*>(invvar);
    with_vec(F, [&](auto vec) {
      constexpr int V = decltype(vec)::value;
      if (one_pass) {
        ln_wide_row_kernel<T, W, V>
            <<<static_cast<unsigned>(rows), 32 * wide_chunks(F), 0, st>>>(
                xp, gp, bp, yp, mp, ip, F, eps);
        return;
      }
      ln_wide_stats_kernel<T, V><<<grid, 32 * kWideWarps, 0, st>>>(
          xp, pt, rows, F);
      ln_wide_apply_kernel<T, W, V><<<grid, 32 * kWideWarps, 0, st>>>(
          xp, gp, bp, pt, yp, mp, ip, rows, F, eps);
    }, xp, gp, bp, static_cast<const T*>(yp));
  });
  return static_cast<int>(ok ? cudaGetLastError() : cudaErrorInvalidValue);
}

// dy, x, dx [rows, F > kRowMax] in one dtype (narrower rows are
// apex_layer_norm_bwd_row's, and refused here; four columns a load where F
// % 4 == 0 and every buffer is 4-element aligned, else two where F is even
// and every buffer is 2-element aligned, else one); gamma [F] or null
// (non-affine: ws, gw, gb unused); mean, invvar fp32 [rows]; rpart fp32
// [rows, ceil(F / 1024), 2] and ws fp32 [2, nrb, F] scratch; gw, gb fp32
// [F]. Row block b of nrb takes rows [b * rpc, (b+1) * rpc). Three
// launches (two without gamma).
extern "C" int apex_layer_norm_bwd_wide(int x_dtype, int w_dtype,
                                        const void* dy, const void* x,
                                        const void* gamma, const void* mean,
                                        const void* invvar, void* dx,
                                        void* rpart, void* ws, void* gw,
                                        void* gb, long long rows,
                                        long long F, long long rpc, int nrb,
                                        void* stream) {
  using namespace apex_port;
  if (bad_wide_shape(rows, F) || F <= kRowMax || F > 0x7fffffffLL ||
      rpc < 1 || nrb < 1 || nrb > 65535 || rpc * nrb < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunk = wide_chunks(F);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(invvar);
  float* rp = static_cast<float*>(rpart);
  float* w = static_cast<float*>(ws);
  const bool ok = with_x_w(x_dtype, w_dtype, gamma != nullptr,
                           [&](auto xt, auto wt, auto affine) {
    using T = typename decltype(xt)::type;
    using W = typename decltype(wt)::type;
    constexpr bool A = decltype(affine)::value;
    const T* d = static_cast<const T*>(dy);
    const T* xp = static_cast<const T*>(x);
    const W* g = static_cast<const W*>(gamma);
    T* o = static_cast<T*>(dx);
    with_vec_bwd(F, [&](auto vec) {
      constexpr int V = decltype(vec)::value;
      ln_wide_bwd_reduce_kernel<T, W, A, V>
          <<<dim3(nchunk, nrb), 32 * kWideWarps, 0, st>>>(
              d, xp, g, m, iv, rp, w, rows, F, rpc);
      if constexpr (A) {
        finalize_kernel<<<static_cast<unsigned>((F + 31) / 32),
                          dim3(32, 32), 0, st>>>(
            w, nrb, static_cast<int>(F), static_cast<float*>(gw),
            static_cast<float*>(gb));
      }
      ln_wide_bwd_dx_kernel<T, W, A, V>
          <<<dim3(nchunk, wide_row_groups(rows)), 32 * kWideWarps, 0, st>>>(
              d, xp, g, m, iv, rp, o, rows, F);
    }, d, xp, g, static_cast<const T*>(o));
  });
  return static_cast<int>(ok ? cudaGetLastError() : cudaErrorInvalidValue);
}
