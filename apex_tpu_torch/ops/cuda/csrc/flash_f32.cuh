// The pieces of the fp32 flash kernels in 3xTF32 that csrc/flash_f32.cu
// (head dims 64-256) and csrc/flash_f32_d512.cu (384 and 512) share: the
// split of fp32 operands into TF32 halves, mma.sync.m16n8k8 products in
// 3xTF32 with fresh accumulators, their fragment loads, the 16-byte
// staging copies, the softmax's quad reductions, the pairs' named
// barriers and exchanged tiles, and the launch. flash_f32.cu's opening
// note gives the reasons for each.
#pragma once

#include "flash_common.cuh"

namespace apex_port {
namespace {

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

// A staged fp32 value x split as a warp reads it (rows kept raw:
// flash_f32.cu, item 8): big = tf32(x) by integer rounding, to nearest
// with ties away as cvt.rna, one add and one mask, and small = x - big
// with its low 13 bits left in place, which the tensor cores do not read
// (TF32 takes the top 19 bits): small truncated, off by under 2^-10 of
// itself, 2^-21 of x. A non-finite x gives a NaN small (inf - inf, or NaN
// - anything), so it reaches every product as cvt.rna's split does.
__device__ __forceinline__ void split_raw(uint32_t x, uint32_t& big,
                                          uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
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
// accumulator (6 products), added to c in fp32 (to nearest); with KP 1
// each k-step does, so no small product lands on a big one's truncated sum
// (KP k-steps a fresh accumulator). With ARAW (BRAW) A's (B's) rows are
// raw fp32 at ab (bb), split as loaded (split_raw; as, bs unread).
template <int K, int N, int LD, bool ARAW = false, bool BRAW = false,
          int KP = 2>
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
    if constexpr (ARAW) {
#pragma unroll
      for (int i = 0; i < 4; ++i) split_raw(a_b[i], a_b[i], a_s[i]);
    } else {
      ldm4(a_s, as + aat);
    }
    uint32_t fb[N][2], fs[N][2];
    if constexpr (N == 1) {
      const int bat = r * LD + 8 * kk + (m & 1) * 4;
      ldm2(fb[0], bb + bat);
      if constexpr (BRAW) {
        split_raw(fb[0][0], fb[0][0], fs[0][0]);
        split_raw(fb[0][1], fb[0][1], fs[0][1]);
      } else {
        ldm2(fs[0], bs + bat);
      }
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
      if constexpr (BRAW) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          split_raw(fb[n + h][0], fb[n + h][0], fs[n + h][0]);
          split_raw(fb[n + h][1], fb[n + h][1], fs[n + h][1]);
        }
      } else {
        ldm4(x, bs + bat);
        fs[n][0] = x[0];
        fs[n][1] = x[1];
        fs[n + 1][0] = x[2];
        fs[n + 1][1] = x[3];
      }
    }
    auto bfrag = [&](int n, uint32_t (&b)[2], uint32_t (&s)[2]) {
      b[0] = fb[n][0];
      b[1] = fb[n][1];
      s[0] = fs[n][0];
      s[1] = fs[n][1];
    };
    if (kk < KP) {                         // the first KP: into c
      if (kk == 0) mma3<true>(c, a_b, a_s, bfrag);
      else mma3<false>(c, a_b, a_s, bfrag);
    } else if (kk % KP == 0) {
      mma3<true>(step, a_b, a_s, bfrag);
    } else {
      mma3<false>(step, a_b, a_s, bfrag);
    }
    if (kk >= KP && kk % KP == KP - 1) {
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
// With BRAW, B is raw fp32 at bb, split as loaded (split_raw; bs unread).
// G0, where given, is the n-tiles a pass takes (fewer live registers).
template <int K, int N, int LD, bool BRAW = false, int G0 = 0>
__device__ __forceinline__ void product_n(float (&acc)[N][4],
                                          const float (&p)[K][4],
                                          const float* bb, const float* bs,
                                          int g, int t) {
  constexpr int G = G0 ? G0 : N < 8 ? N : N == 8 ? 8 : 4;
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
        if constexpr (BRAW) {
          split_raw(__float_as_uint(bb[at + 8 * n]), b[0], s[0]);
          split_raw(__float_as_uint(bb[at + LD + 8 * n]), b[1], s[1]);
        } else {
          b[0] = __float_as_uint(bb[at + 8 * n]);
          b[1] = __float_as_uint(bb[at + LD + 8 * n]);
          s[0] = __float_as_uint(bs[at + 8 * n]);
          s[1] = __float_as_uint(bs[at + LD + 8 * n]);
        }
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

// 2^x by one special-function instruction, results below 2^-126 flushed
// to zero. exp2f keeps those subnormal, at more instructions; here such a
// p or alpha lies far below an ulp of l >= 1 (in the backward's pair
// kernels, of dS's other terms), and the forward took 10% less time with
// this, the pair kernels 1-2.5% (PERF.md)
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

// the row stride of a pair's exchanged tile [16][T]: float2 stores of a
// half-warp (rows g < 4, columns 2t) on 16 distinct bank pairs
template <int T> __host__ __device__ constexpr int p_ldx() {
  return T == 8 ? 8 : T + 8;
}

// the named barrier of pair pr (0 is __syncthreads'), its 64 threads
__device__ __forceinline__ void pair_sync(int pr) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(1 + pr) : "memory");
}
__device__ __forceinline__ void pair_arrive(int pr) {
  asm volatile("bar.arrive %0, 64;\n" :: "r"(1 + pr) : "memory");
}

// a warp's [16 x 8N] accumulator tile to a pair's exchange buffer, and
// back, each lane its own (g, 2t) and (g + 8, 2t) pairs
template <int N, int LDX>
__device__ __forceinline__ void tile_out(float* x, const float (&c)[N][4],
                                         int g, int t) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(x + (g + 8 * h) * LDX + 8 * n + 2 * t) =
          make_float2(c[n][2 * h], c[n][2 * h + 1]);
    }
  }
}
template <int N, int LDX>
__device__ __forceinline__ void tile_in(float (&c)[N][4], const float* x,
                                        int g, int t) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 y = *reinterpret_cast<const float2*>(
          x + (g + 8 * h) * LDX + 8 * n + 2 * t);
      c[n][2 * h] = y.x;
      c[n][2 * h + 1] = y.y;
    }
  }
}

template <typename K, typename... Args>
cudaError_t f32_launch(K kernel, int bytes, int blocks, int bh, int threads,
                       cudaStream_t st, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks * bh), threads, bytes, st>>>(
      args...);
  return cudaGetLastError();
}

// calls f(EXTRA) with EXTRA a compile-time constant: whether any bias or
// dropout is given
template <typename F>
void with_extra(const Attn& a, F&& f) {
  if (a.kvb != nullptr || a.bias != nullptr || a.drop_inv > 0.f) {
    f(std::integral_constant<bool, true>{});
  } else {
    f(std::integral_constant<bool, false>{});
  }
}

}  // namespace
}  // namespace apex_port
