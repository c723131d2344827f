// Shared helpers of the port's hand kernels: dtype codes (the Python
// loader's table, apex_tpu_torch/ops/cuda/__init__.py) and the dispatch
// over them, fp32 conversion of the storage types, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace apex_port {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// the flash kernel's finite -inf stand-in (exp() of it is exactly 0.0 in
// fp32): masked lanes compute the same values as the plain versions
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, like .to()
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// four consecutive elements as fp32, one vector load (callers keep the
// address 4-element aligned)
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  o[0] = __low2float(a); o[1] = __high2float(a);
  o[2] = __low2float(b); o[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const __half* p, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __half2 a = *reinterpret_cast<const __half2*>(&raw.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&raw.y);
  o[0] = __low2float(a); o[1] = __high2float(a);
  o[2] = __low2float(b); o[3] = __high2float(b);
}

// four consecutive elements as loaded, one vector load: two 32-bit words
// of 16-bit T, or four floats; unpack turns them (or one element as
// loaded) into fp32 where used
template <typename T>
struct Raw4 {
  using type = uint2;
};
template <>
struct Raw4<float> {
  using type = float4;
};

template <typename T>
__device__ __forceinline__ typename Raw4<T>::type raw4(const T* p) {
  return *reinterpret_cast<const typename Raw4<T>::type*>(p);
}

template <typename T>
__device__ __forceinline__ void unpack(const T& r, float (&o)[1], const T*) {
  o[0] = to_f(r);
}
__device__ __forceinline__ void unpack(const float4& r, float (&o)[4],
                                       const float*) {
  o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
}
__device__ __forceinline__ void unpack(const uint2& r, float (&o)[4],
                                       const __nv_bfloat16*) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
  o[0] = __low2float(a); o[1] = __high2float(a);
  o[2] = __low2float(b); o[3] = __high2float(b);
}
__device__ __forceinline__ void unpack(const uint2& r, float (&o)[4],
                                       const __half*) {
  const __half2 a = *reinterpret_cast<const __half2*>(&r.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&r.y);
  o[0] = __low2float(a); o[1] = __high2float(a);
  o[2] = __low2float(b); o[3] = __high2float(b);
}

// four consecutive fp32 values stored as T, one vector store (callers keep
// the address 4-element aligned); rounding as from_f
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(__half* p, const float (&v)[4]) {
  const __half2 a = __floats2half2_rn(v[0], v[1]);
  const __half2 b = __floats2half2_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// A storage dtype code as a type tag: with_storage calls f(Tag<T>{}) for
// the code's T and returns false for a code the kernels do not take.
template <typename T> struct Tag { using type = T; };

template <typename F>
bool with_storage(int dtype, F&& f) {
  switch (dtype) {
    case kF32: f(Tag<float>{}); return true;
    case kBF16: f(Tag<__nv_bfloat16>{}); return true;
    case kF16: f(Tag<__half>{}); return true;
    default: return false;
  }
}

// with_storage over (x, weight) dtypes: f(x tag, weight tag, affine as a
// std::bool_constant); a null weight takes W = float
template <typename Fn>
bool with_x_w(int x_dtype, int w_dtype, bool affine, Fn&& f) {
  bool ok = false;
  with_storage(x_dtype, [&](auto xt) {
    if (affine) {
      ok = with_storage(w_dtype, [&](auto wt) {
        f(xt, wt, std::true_type{});
      });
    } else {
      f(xt, Tag<float>{}, std::false_type{});
      ok = true;
    }
  });
  return ok;
}

// butterfly reductions: every lane ends with the same value (each level
// adds the same two operands in both partner lanes)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

namespace {

// The second pass of the column sums that the BN and LayerNorm backward
// kernels take without float atomics: ws [2][nchunk][c] holds each chunk of
// rows' partial sums; o0[c], o1[c] get each column's chunks added in a
// fixed order, split over 32 row threads whose results are then added in
// order. Launch with grid (c + 31) / 32 and block (32, 32); as a
// programmatic dependent launch it waits for the kernel before it (a
// no-op otherwise).
__global__ void __launch_bounds__(1024)
finalize_kernel(const float* __restrict__ ws, int nchunk, int c,
                float* __restrict__ o0, float* __restrict__ o1) {
  __shared__ float sh[2][32][33];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int col = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (col < c) {
    const float* w1 = ws + (long long)nchunk * c;
    for (int j = threadIdx.y; j < nchunk; j += 32) {
      a += ws[(long long)j * c + col];
      b += w1[(long long)j * c + col];
    }
  }
  sh[0][threadIdx.y][threadIdx.x] = a;
  sh[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y != 0 || col >= c) return;
  a = 0.f;
  b = 0.f;
  for (int y = 0; y < 32; ++y) {
    a += sh[0][y][threadIdx.x];
    b += sh[1][y][threadIdx.x];
  }
  o0[col] = a;
  o1[col] = b;
}

}  // namespace

}  // namespace apex_port
