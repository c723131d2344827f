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

// VEC consecutive values of a row as fp32 (one vector load when VEC is 4);
// ``fill`` where the columns lie past the row
template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* p, bool in, float fill,
                                         float* o) {
  if (VEC == 4 && in) {
    float t4[4];
    load4(p, t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = t4[e];
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = in ? to_f(p[e]) : fill;
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
