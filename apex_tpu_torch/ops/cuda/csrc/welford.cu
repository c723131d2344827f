// Per-channel BatchNorm kernels over channels-last rows x [R, C]: the batch
// moments of the forward and the two passes of the backward.
//
// bn_moments replaces the Pallas kernel apex_tpu/ops/pallas/welford.py
// bn_moments -> _moments_kernel (:60); bn_bwd_reduce replaces
// bn_backward_fused_reduce -> _bwd_fused_reduce_kernel (:94); bn_bwd_dx
// replaces bn_backward_dx -> _bwd_dx_kernel (:152); bn_bwd_reduce_xhat,
// the reduce body reading a materialized xhat, replaces bn_backward_reduce
// -> _bwd_reduce_kernel (:216).
//
// Bound on this card: bytes, for all four. Per element they do a handful
// of fp32 operations (2 for the moments, 3 to 6 for the reduces, 8 for
// dx) and move 2 to 10 bytes (bf16), below the ~20 operations per byte
// where the H100's fp32 units, not its 3.35 TB/s, would set the time. At
// RN50's batch-256 stem BN (R = 3,211,264, C = 64, bf16):
//   moments  x in                          2 B/elem  411 MB  0.123 ms
//   reduce   dy, x, out in                 6 B/elem  1.23 GB 0.368 ms
//   reduce from xhat: dy, xhat in          4 B/elem  822 MB  0.245 ms
//   dx       dy, x, out in; dx, dz out    10 B/elem  2.06 GB 0.613 ms
// What the design does about it: every element is read once, four
// consecutive channels per thread with one 8-byte (bf16) or 16-byte (fp32)
// vector load (VEC = 4, when C % 4 == 0 and every buffer is 4-element
// aligned; otherwise the scalar form, VEC = 1: one channel a thread, as the
// LayerNorm forward's VEC-1 form); a block of 256 threads is a tile of up
// to 32 * VEC channels by 256/32 (or more, for narrow C) rows, walking a
// fixed chunk of rows, so
// each thread keeps its channels' mean, invvar and sums in registers and
// the per-channel vectors are loaded once per thread, not per element; the
// grid fills the card with about eight blocks per SM. The TPU kernels
// accumulate into one output block across their sequential grid; here the
// blocks run in any order, so each writes its chunk's partial sums to a
// workspace and a second small kernel adds the chunks in a fixed order:
// no float atomics, so the sums, and with them the step, repeat bit for
// bit.
//
// Rounding: dx and dz use the _rn intrinsics (never contracted into FMAs)
// in the order of the plain PyTorch versions (apex_tpu_torch/ops/welford.py),
// so they equal theirs bit for bit; the sums add in another order.

#include <type_traits>

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kThreads = 256;

struct Tile {
  int tx, ty, tiles;   // threads across channel vectors, across rows; tiles
};

// VEC channels a thread: the vectors of C, 32 of them (or all, when fewer)
// across a block's threads. The grid's row chunks come from ops/welford.py
// _chunks, which counts tiles from C alone (a base that is not 4-element
// aligned takes the scalar form on the vector form's chunk count)
inline Tile tile_for(int c, int vec) {
  const int vecs = c / vec;
  Tile t;
  t.tx = vecs < 32 ? vecs : 32;
  t.ty = kThreads / t.tx;
  t.tiles = (vecs + t.tx - 1) / t.tx;
  return t;
}

// VEC consecutive channels as fp32: one vector load when VEC is 4
template <int VEC, typename T>
__device__ __forceinline__ void load_v(const T* p, float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    load4(p, o);
  } else {
    o[0] = to_f(*p);
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void store_v(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    store4(p, v);
  } else {
    *p = from_f<T>(v[0]);
  }
}

// relu mask of the fused-relu BN: the primal output is 0 where it clipped
template <int VEC, typename T>
__device__ __forceinline__ void mask_dy(const T* __restrict__ out,
                                        long long off, float (&d)[VEC]) {
  float o[VEC];
  load_v<VEC>(out + off, o);
#pragma unroll
  for (int e = 0; e < VEC; ++e) d[e] = o[e] > 0.f ? d[e] : 0.f;
}

// the block's per-channel partial sums a, b -> ws[0][chunk][col..],
// ws[1][chunk][col..], adding the row threads in a fixed order
template <int VEC>
__device__ __forceinline__ void store_partials(const float (&a)[VEC],
                                               const float (&b)[VEC],
                                               float* __restrict__ ws,
                                               int nchunk, int c, int col) {
  __shared__ float sh[2][kThreads * 4];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sh[0][tid * VEC + e] = a[e];
    sh[1][tid * VEC + e] = b[e];
  }
  __syncthreads();
  if (threadIdx.y != 0 || col >= c) return;
  float sa[VEC], sb[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sa[e] = sb[e] = 0.f;
  for (int y = 0; y < (int)blockDim.y; ++y) {
    const int i = (y * blockDim.x + threadIdx.x) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sa[e] += sh[0][i + e];
      sb[e] += sh[1][i + e];
    }
  }
  const long long base = (long long)blockIdx.y * c + col;
  store_v<VEC>(ws + base, sa);
  store_v<VEC>(ws + (long long)nchunk * c + base, sb);
}

// ---- moments -----------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, long long rows, int c,
               long long rpc, int nchunk, float* __restrict__ ws) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.f;
  if (col < c) {
    const long long r0 = (long long)blockIdx.y * rpc;
    const long long r1 = r0 + rpc < rows ? r0 + rpc : rows;
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      float v[VEC];
      load_v<VEC>(x + r * c + col, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s[e] += v[e];
        q[e] += v[e] * v[e];
      }
    }
  }
  store_partials<VEC>(s, q, ws, nchunk, c, col);
}

// ---- backward: sum(dy), sum(dy * xhat) --------------------------------------
// XHAT: x is the materialized xhat (of its own dtype X), and mean, invvar
// and out are unused: bn_backward_reduce (welford.py:216-251)

template <typename T, typename X, bool MASK, bool XHAT, int VEC>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const T* __restrict__ dy, const X* __restrict__ x,
                  const T* __restrict__ out, const float* __restrict__ mean,
                  const float* __restrict__ invvar, long long rows, int c,
                  long long rpc, int nchunk, float* __restrict__ ws) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  float sd[VEC], sx[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sd[e] = sx[e] = 0.f;
  if (col < c) {
    float mu[VEC], iv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      mu[e] = 0.f;
      iv[e] = 1.f;
    }
    if constexpr (!XHAT) {
      load_v<VEC>(mean + col, mu);
      load_v<VEC>(invvar + col, iv);
    }
    const long long r0 = (long long)blockIdx.y * rpc;
    const long long r1 = r0 + rpc < rows ? r0 + rpc : rows;
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const long long off = r * c + col;
      float d[VEC], v[VEC];
      load_v<VEC>(dy + off, d);
      load_v<VEC>(x + off, v);
      if constexpr (MASK) mask_dy<VEC>(out, off, d);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = XHAT ? v[e] : (v[e] - mu[e]) * iv[e];
        sd[e] += d[e];
        sx[e] += d[e] * xh;
      }
    }
  }
  store_partials<VEC>(sd, sx, ws, nchunk, c, col);
}

// ---- backward: dx (and dz) ----------------------------------------------------
// pc = [mean, invvar, winv, mean_dy, mean_dy_xhat], each fp32 [c]

template <typename T, bool MASK, bool DZ, int VEC>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
              const T* __restrict__ out, const float* __restrict__ pc,
              T* __restrict__ dx, T* __restrict__ dz, long long rows, int c,
              long long rpc) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (col >= c) return;
  float mu[VEC], iv[VEC], wi[VEC], md[VEC], mx[VEC];
  load_v<VEC>(pc + col, mu);
  load_v<VEC>(pc + c + col, iv);
  load_v<VEC>(pc + 2 * c + col, wi);
  load_v<VEC>(pc + 3 * c + col, md);
  load_v<VEC>(pc + 4 * c + col, mx);
  const long long r0 = (long long)blockIdx.y * rpc;
  const long long r1 = r0 + rpc < rows ? r0 + rpc : rows;
#pragma unroll 4
  for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const long long off = r * c + col;
    float d[VEC], v[VEC], o[VEC];
    load_v<VEC>(dy + off, d);
    load_v<VEC>(x + off, v);
    if constexpr (MASK) mask_dy<VEC>(out, off, d);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float xh = __fmul_rn(__fsub_rn(v[e], mu[e]), iv[e]);
      o[e] = __fmul_rn(wi[e], __fsub_rn(__fsub_rn(d[e], md[e]),
                                        __fmul_rn(xh, mx[e])));
    }
    store_v<VEC>(dx + off, o);
    if constexpr (DZ) store_v<VEC>(dz + off, d);
  }
}

// ---- launchers ----------------------------------------------------------------

inline long long rows_per_chunk(long long rows, int nchunk) {
  return (rows + nchunk - 1) / nchunk;
}

// four channels a thread (one vector load) where C % 4 == 0 and every
// buffer (null: absent) is 4-element aligned, else one; the LayerNorm
// kernels pick their form the same way
template <typename... P>
int vec_for(int c, const P*... p) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) % (4 * sizeof(P)) == 0) && ...);
  return c % 4 == 0 && aligned ? 4 : 1;
}

// calls f(std::integral_constant<int, VEC>) for vec 4 or 1
template <typename F>
void with_vec(int vec, F&& f) {
  if (vec == 4) f(std::integral_constant<int, 4>{});
  else f(std::integral_constant<int, 1>{});
}

template <typename T>
void launch_moments(const void* x, long long rows, int c, int nchunk,
                    float* ws, float* o0, float* o1, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const int vec = vec_for(c, xp);
  const Tile t = tile_for(c, vec);
  with_vec(vec, [&](auto v) {
    moments_kernel<T, decltype(v)::value>
        <<<dim3(t.tiles, nchunk), dim3(t.tx, t.ty), 0, st>>>(
            xp, rows, c, rows_per_chunk(rows, nchunk), nchunk, ws);
  });
  finalize_kernel<<<(c + 31) / 32, dim3(32, 32), 0, st>>>(ws, nchunk, c, o0,
                                                          o1);
}

template <typename T>
void launch_bwd_reduce(const void* dy, const void* x, const void* out,
                       const float* mean, const float* invvar, long long rows,
                       int c, int nchunk, float* ws, float* o0, float* o1,
                       cudaStream_t st) {
  const T* d = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const T* op = static_cast<const T*>(out);
  const int vec = vec_for(c, d, xp, op);
  const Tile t = tile_for(c, vec);
  const dim3 grid(t.tiles, nchunk), block(t.tx, t.ty);
  const long long rpc = rows_per_chunk(rows, nchunk);
  with_vec(vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    if (out != nullptr) {
      bwd_reduce_kernel<T, T, true, false, V><<<grid, block, 0, st>>>(
          d, xp, op, mean, invvar, rows, c, rpc, nchunk, ws);
    } else {
      bwd_reduce_kernel<T, T, false, false, V><<<grid, block, 0, st>>>(
          d, xp, op, mean, invvar, rows, c, rpc, nchunk, ws);
    }
  });
  finalize_kernel<<<(c + 31) / 32, dim3(32, 32), 0, st>>>(ws, nchunk, c, o0,
                                                          o1);
}

template <typename T, typename X>
void launch_bwd_reduce_xhat(const void* dy, const void* xhat, long long rows,
                            int c, int nchunk, float* ws, float* o0,
                            float* o1, cudaStream_t st) {
  const T* d = static_cast<const T*>(dy);
  const X* xh = static_cast<const X*>(xhat);
  const int vec = vec_for(c, d, xh);
  const Tile t = tile_for(c, vec);
  with_vec(vec, [&](auto v) {
    bwd_reduce_kernel<T, X, false, true, decltype(v)::value>
        <<<dim3(t.tiles, nchunk), dim3(t.tx, t.ty), 0, st>>>(
            d, xh, nullptr, nullptr, nullptr, rows, c,
            rows_per_chunk(rows, nchunk), nchunk, ws);
  });
  finalize_kernel<<<(c + 31) / 32, dim3(32, 32), 0, st>>>(ws, nchunk, c, o0,
                                                          o1);
}

template <typename T>
void launch_bwd_dx(const void* dy, const void* x, const void* out,
                   const float* pc, void* dx, void* dz, long long rows, int c,
                   int nchunk, cudaStream_t st) {
  const T* d = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const T* op = static_cast<const T*>(out);
  T* dxp = static_cast<T*>(dx);
  T* dzp = static_cast<T*>(dz);
  const int vec = vec_for(c, d, xp, op, dxp, dzp);
  const Tile t = tile_for(c, vec);
  const dim3 grid(t.tiles, nchunk), block(t.tx, t.ty);
  const long long rpc = rows_per_chunk(rows, nchunk);
  const bool mask = out != nullptr, emit = dz != nullptr;
  with_vec(vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    if (mask && emit) {
      bwd_dx_kernel<T, true, true, V><<<grid, block, 0, st>>>(
          d, xp, op, pc, dxp, dzp, rows, c, rpc);
    } else if (mask) {
      bwd_dx_kernel<T, true, false, V><<<grid, block, 0, st>>>(
          d, xp, op, pc, dxp, dzp, rows, c, rpc);
    } else if (emit) {
      bwd_dx_kernel<T, false, true, V><<<grid, block, 0, st>>>(
          d, xp, op, pc, dxp, dzp, rows, c, rpc);
    } else {
      bwd_dx_kernel<T, false, false, V><<<grid, block, 0, st>>>(
          d, xp, op, pc, dxp, dzp, rows, c, rpc);
    }
  });
}

inline bool bad_shape(long long rows, int c, int nchunk) {
  return rows < 1 || c < 1 || nchunk < 1 || nchunk > 65535;
}

}  // namespace
}  // namespace apex_port

// Every entry point takes any c >= 1 and picks its form (vec_for): four
// channels a thread where c % 4 == 0 and every [rows, c] buffer is
// 4-element aligned, else one.

// x [rows, c] (fp32, bf16 or fp16); ws fp32 [2, nchunk, c] scratch; sum,
// sumsq fp32 [c]. Returns cudaGetLastError().
extern "C" int apex_bn_moments(int dtype, const void* x, long long rows,
                               int c, int nchunk, void* ws, void* sum,
                               void* sumsq, void* stream) {
  using namespace apex_port;
  if (bad_shape(rows, c, nchunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  float* o0 = static_cast<float*>(sum);
  float* o1 = static_cast<float*>(sumsq);
  switch (dtype) {
    case kF32:
      launch_moments<float>(x, rows, c, nchunk, w, o0, o1, st);
      break;
    case kBF16:
      launch_moments<__nv_bfloat16>(x, rows, c, nchunk, w, o0, o1, st);
      break;
    case kF16:
      launch_moments<__half>(x, rows, c, nchunk, w, o0, o1, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dy, x, out [rows, c] in one dtype (out may be null: no relu mask); mean,
// invvar fp32 [c]; ws as above; sum_dy, sum_dy_xhat fp32 [c].
extern "C" int apex_bn_bwd_reduce(int dtype, const void* dy, const void* x,
                                  const void* out, const void* mean,
                                  const void* invvar, long long rows, int c,
                                  int nchunk, void* ws, void* sum_dy,
                                  void* sum_dy_xhat, void* stream) {
  using namespace apex_port;
  if (bad_shape(rows, c, nchunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(invvar);
  float* w = static_cast<float*>(ws);
  float* o0 = static_cast<float*>(sum_dy);
  float* o1 = static_cast<float*>(sum_dy_xhat);
  switch (dtype) {
    case kF32:
      launch_bwd_reduce<float>(dy, x, out, mu, iv, rows, c, nchunk, w, o0,
                               o1, st);
      break;
    case kBF16:
      launch_bwd_reduce<__nv_bfloat16>(dy, x, out, mu, iv, rows, c, nchunk,
                                       w, o0, o1, st);
      break;
    case kF16:
      launch_bwd_reduce<__half>(dy, x, out, mu, iv, rows, c, nchunk, w, o0,
                                o1, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dy, xhat [rows, c], each fp32, bf16 or fp16 (they may differ); ws as
// above; sum_dy, sum_dy_xhat fp32 [c].
extern "C" int apex_bn_bwd_reduce_xhat(int dy_dtype, int xhat_dtype,
                                       const void* dy, const void* xhat,
                                       long long rows, int c, int nchunk,
                                       void* ws, void* sum_dy,
                                       void* sum_dy_xhat, void* stream) {
  using namespace apex_port;
  if (bad_shape(rows, c, nchunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  with_storage(dy_dtype, [&](auto dt) {
    ok = with_storage(xhat_dtype, [&](auto xt) {
      launch_bwd_reduce_xhat<typename decltype(dt)::type,
                             typename decltype(xt)::type>(
          dy, xhat, rows, c, nchunk, static_cast<float*>(ws),
          static_cast<float*>(sum_dy), static_cast<float*>(sum_dy_xhat), st);
    });
  });
  return static_cast<int>(ok ? cudaGetLastError() : cudaErrorInvalidValue);
}

// dy, x, out [rows, c] in one dtype (out may be null); pc fp32 [5, c] =
// mean, invvar, invvar * weight, mean_dy, mean_dy_xhat; dx, dz [rows, c] in
// x's dtype (dz may be null: not emitted).
extern "C" int apex_bn_bwd_dx(int dtype, const void* dy, const void* x,
                              const void* out, const void* pc, void* dx,
                              void* dz, long long rows, int c, int nchunk,
                              void* stream) {
  using namespace apex_port;
  if (bad_shape(rows, c, nchunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pc);
  switch (dtype) {
    case kF32:
      launch_bwd_dx<float>(dy, x, out, p, dx, dz, rows, c, nchunk, st);
      break;
    case kBF16:
      launch_bwd_dx<__nv_bfloat16>(dy, x, out, p, dx, dz, rows, c, nchunk,
                                    st);
      break;
    case kF16:
      launch_bwd_dx<__half>(dy, x, out, p, dx, dz, rows, c, nchunk, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
