// LayerNorm backward over rows of up to 16384 values in one pass: dy and x
// are read from device memory once, dx is written once, and the gamma and
// beta gradients (the column sums of dy * xhat and dy) come out of the same
// pass.
//
// Replaces, with csrc/layer_norm.cu's chunked kernels past 16384, the
// Pallas kernels of apex_tpu/ops/pallas/layer_norm.py _ln_bwd_wide (:345):
// _wide_bwd_reduce_kernel (:288, each row's sums of dy*g and dy*g*xhat),
// _wide_gwgb_kernel (:310, the column sums of dy*xhat and dy) and
// _wide_dx_kernel (:331, dx = inv * (dy*g - m1 - xhat*m2)): the same
// function, as one kernel and finalize_kernel (common.cuh), which adds the
// blocks' partial column sums.
//
// Bound on this card: bytes. dy and x are read once and dx written once,
// about 20 instructions an element: at the wide LM's [8192, 12288] bf16
// 604 MB, 0.180 ms at 3.35 TB/s. The chunked form read dy and x twice (10
// bytes an element where the bound has 6).
//
// Design.
// 1. A persistent grid whose size is a function of the shape only
//    (ln_row_plan.cuh's row_plan: min(rows, 132 / cluster) clusters, 132
//    the H100's SMs, not read from the card). Cluster c walks the rows
//    [c * rows / n, (c + 1) * rows / n) in order, so the column sums add
//    in the same order, and repeat bit for bit, on every run.
// 2. One producer warp keeps a ring of `stages` row stages in flight, each
//    two buffers (dy's and x's segment of a row). Lane 0 copies the
//    16-byte-aligned span inside each segment with cp.async.bulk (TMA) onto
//    the stage's mbarrier; the lanes copy with plain loads the few values
//    at the segment's two ends that start or end inside a 16-byte chunk
//    (a row of odd F starts on any 2-byte boundary, a view anywhere), and
//    lane 0 the row's mean and invvar; each lane fences its plain writes
//    against the async proxy before it arrives (a later row's bulk copy
//    may write the same bytes). Copies keep the segment's offset inside
//    its 16-byte chunk: value j of a segment at address a sits at
//    buffer byte (a & 15) + j * sizeof(T), for every alignment. Plain loads
//    never leave the tensor, and the bulk copies never leave the segment.
// 3. kLnbWarps consumer warps: thread t takes the VEC-wide column groups t,
//    t + NT, ... of the segment (VEC the widest of 8, 4, 2, 1 16-bit values
//    or 4, 2, 1 fp32 values that divides F and every buffer's element
//    offset, so a group is aligned in shared memory and in dx in every
//    row). Per row:
//    a. s1 = sum(dy*g) and s2 = sum(dy*g*xhat) from shared memory, g from
//       a copy of gamma's segment in shared memory (loaded once a block),
//       and the column sums of dy*xhat and dy added in registers, where
//       they stay across the block's rows;
//    b. s1 and s2 over the block: lanes (a butterfly), then the warps in
//       order through shared memory, under one named barrier a row (two
//       slots by the row's parity, so the next row's writes wait for none);
//    c. dx = inv * (dy*g - s1/F - xhat*s2/F) from shared memory again,
//       written once by vector stores from registers; each warp then
//       releases the stage on its "empty" mbarrier.
// 4. Shared memory sets the stages (row_plan; kLnbHead bytes of barriers
//    and row sums, gamma's segment, then the stages, each two buffers of
//    round16(n * sizeof(T)) + 16 bytes, within 227 KB): bf16 at F 12288
//    four stages of 48 KB beside gamma's 24 KB (216 KB); at 16384 three of
//    64 KB beside 32 KB (224 KB). An fp32 row past about 11,600 values
//    (with an fp32 gamma) leaves no room for two stages: a 2-block cluster
//    takes it, each block one half of every row (split at a multiple of 8
//    columns). The halves' s1 and s2 are traded through distributed shared
//    memory (st.shared::cluster, then an arrival on the other block's
//    mbarrier; two slots by the row's parity) and added as own + peer,
//    the same bits in both blocks. fp32 at F 16384: three stages of 64 KB
//    beside 32 KB of gamma.
// 5. Each block writes one partial row of each column sum (its cluster's
//    row of ws, its columns); finalize_kernel adds the clusters' partials
//    in a fixed order. No float atomics. The partials are 2 * clusters * F
//    fp32, 13 MB at the LM's shape beside its 604 MB.
// Registers: the column sums take 2 * VEC * ceil(segment / (NT * VEC))
// fp32 registers a thread (80 at F 16384 with 16-byte loads). A block of
// 16 warps (15 consumers and the producer) puts four on each of the SM's
// schedulers, whose 16384 registers then give a thread up to 128; a 17th
// warp would put five on one and cap every thread at 96 (ln_bwd_wide_ab.py
// variants' w16: no faster at 16-byte loads).

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "ln_row_plan.cuh"

namespace apex_port {
namespace {

constexpr int kLnbWarps = 15;          // consumer warps (480 threads)
constexpr int kLnbThreads = 32 * (kLnbWarps + 1);
static_assert(128 + 16 * kLnbWarps + 16 + 8 * kLnbMaxStages <= kLnbHead,
              "the head's barriers, row sums and statistics");

// a 32-bit word of two 16-bit values as fp32 (the lower address first),
// and two fp32 values rounded into one
__device__ __forceinline__ void unpack2(unsigned w, float* o,
                                        const __nv_bfloat16*) {
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack2(unsigned w, float* o, const __half*) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
  o[0] = f.x;
  o[1] = f.y;
}
__device__ __forceinline__ unsigned pack2(float a, float b,
                                          const __nv_bfloat16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ unsigned pack2(float a, float b, const __half*) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// VEC consecutive values as fp32, by accesses of up to 16 bytes, each
// aligned to its size
template <int VEC, typename T>
__device__ __forceinline__ void ld_vec(const T* p, float (&o)[VEC]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VEC == 1) {
      o[0] = p[0];
    } else if constexpr (VEC == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      o[0] = v.x;
      o[1] = v.y;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + k);
        o[k] = v.x;
        o[k + 1] = v.y;
        o[k + 2] = v.z;
        o[k + 3] = v.w;
      }
    }
  } else if constexpr (VEC == 1) {
    o[0] = to_f(p[0]);
  } else {
    unsigned w[VEC / 2];
    if constexpr (VEC == 2) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else if constexpr (VEC == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) unpack2(w[q], o + 2 * q, p);
  }
}

// VEC fp32 values stored as T (rounding as from_f), one access
template <int VEC, typename T>
__device__ __forceinline__ void st_vec(T* p, const float (&v)[VEC]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VEC == 1) {
      p[0] = v[0];
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else if constexpr (VEC == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    unsigned w[VEC / 2];
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) w[q] = pack2(v[2 * q], v[2 * q + 1], p);
    if constexpr (VEC == 2) {
      *reinterpret_cast<unsigned*>(p) = w[0];
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Grid: CL * clusters blocks of kLnbThreads, clusters of CL; dynamic shared
// memory row_plan's. Block rank k of cluster c takes the
// columns [c0, c0 + n) of rows [c * rows / clusters, (c + 1) * rows /
// clusters) and, AFFINE, writes its column sums to ws[0][c][c0..),
// ws[1][c][c0..).
template <typename T, typename W, bool AFFINE, int VEC, int CL>
__global__ void __launch_bounds__(kLnbThreads, 1)
ln_wide_bwd_row_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                       const W* __restrict__ gamma,
                       const float* __restrict__ mean,
                       const float* __restrict__ inv, T* __restrict__ dx,
                       float* __restrict__ ws, long long rows, int F,
                       int stages, int clusters) {
  constexpr int NT = 32 * kLnbWarps;
  constexpr int kSegMax = CL == 1 ? kLnbRowMax : kLnbRowMax / 2;
  constexpr int kGroups = (kSegMax + NT * VEC - 1) / (NT * VEC);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kLnbMaxStages;
  uint64_t* xbar = empty + kLnbMaxStages;                 // [2]
  float* red = reinterpret_cast<float*>(smem + 128);      // [2][warps][2]
  float2* xch = reinterpret_cast<float2*>(smem + 128 + 16 * kLnbWarps);
  float2* stat = xch + 2;                                 // [stages]
  int rank = 0;
  if constexpr (CL > 1) rank = static_cast<int>(hopper::cluster_rank());
  const int split = CL == 1 ? F : row_split(F);
  const int c0 = rank == 0 ? 0 : split;
  const int n = rank == 0 ? split : F - split;
  W* gsh = reinterpret_cast<W*>(smem + kLnbHead);
  const int span = static_cast<int>(round16((long long)split * sizeof(T)))
                   + 16;
  unsigned char* ring =
      smem + kLnbHead +
      (AFFINE ? round16((long long)split * sizeof(W)) : 0);
  const long long cl = blockIdx.x / CL;
  const long long r0 = cl * rows / clusters;
  const long long r1 = (cl + 1) * rows / clusters;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], kLnbWarps);
    }
    hopper::mbar_init(&xbar[0], 1);
    hopper::mbar_init(&xbar[1], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the other block's barriers are live before any arrival on them
  if constexpr (CL > 1) hopper::cluster_sync();
  // finalize_kernel may launch now: it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (warp == kLnbWarps) {
    // the producer: rows into the ring
    int s = 0;
    uint32_t ph = 0;
    for (long long r = r0; r < r1; ++r) {
      hopper::mbar_wait(&empty[s], ph ^ 1);
      unsigned char* st = ring + (long long)s * 2 * span;
      const T* src[2] = {dy + r * F + c0, x + r * F + c0};
      uintptr_t lo[2], hi[2];
      uint32_t bytes = 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(src[q]);
        const uintptr_t e = a + static_cast<uintptr_t>(n) * sizeof(T);
        lo[q] = (a + 15) & ~uintptr_t(15);
        hi[q] = e & ~uintptr_t(15);
        if (hi[q] <= lo[q]) hi[q] = lo[q] = e;   // no aligned span
        bytes += static_cast<uint32_t>(hi[q] - lo[q]);
      }
      if (lane == 0 && bytes != 0) {
        hopper::mbar_expect_tx(&full[s], bytes);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uintptr_t a = reinterpret_cast<uintptr_t>(src[q]);
          if (hi[q] > lo[q]) {
            hopper::bulk_load(st + q * span + (a & 15) + (lo[q] - a),
                              reinterpret_cast<const void*>(lo[q]),
                              static_cast<uint32_t>(hi[q] - lo[q]),
                              &full[s]);
          }
        }
      }
      // the values outside the aligned spans (all of a segment that has
      // none), and the row's statistics
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(src[q]);
        T* dst = reinterpret_cast<T*>(st + q * span + (a & 15));
        const int hn = hi[q] > lo[q]
                           ? static_cast<int>((lo[q] - a) / sizeof(T)) : n;
        const int tn = hi[q] > lo[q]
                           ? static_cast<int>((a + n * sizeof(T) - hi[q]) /
                                              sizeof(T))
                           : 0;
        for (int i = lane; i < hn + tn; i += 32) {
          const int j = i < hn ? i : n - tn + (i - hn);
          dst[j] = src[q][j];
        }
      }
      if (lane == 0) stat[s] = make_float2(mean[r], inv[r]);
      hopper::fence_proxy_async_smem();
      hopper::mbar_arrive(&full[s]);
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
  } else {
    // the consumers: gamma's segment into shared memory while the first
    // rows arrive (16 bytes a load where it is 16-byte aligned)
    const int t = threadIdx.x;
    if constexpr (AFFINE) {
      const W* gs = gamma + c0;
      int j0 = 0;
      if ((reinterpret_cast<uintptr_t>(gs) & 15) == 0) {
        const int nv = static_cast<int>(n * sizeof(W) / 16);
        for (int q = t; q < nv; q += NT) {
          reinterpret_cast<uint4*>(gsh)[q] =
              reinterpret_cast<const uint4*>(gs)[q];
        }
        j0 = static_cast<int>(nv * 16 / sizeof(W));
      }
      for (int j = j0 + t; j < n; j += NT) gsh[j] = gs[j];
      hopper::bar_sync(1, NT);
    }
    const float Ff = static_cast<float>(F);
    float gw[kGroups * VEC], gb[kGroups * VEC];
#pragma unroll
    for (int i = 0; i < kGroups * VEC; ++i) gw[i] = gb[i] = 0.f;
    int s = 0, slot = 0;
    uint32_t ph = 0, xph = 0;
    for (long long r = r0; r < r1; ++r) {
      hopper::mbar_wait(&full[s], ph);
      const unsigned char* st = ring + (long long)s * 2 * span;
      const T* dr = reinterpret_cast<const T*>(
          st + (reinterpret_cast<uintptr_t>(dy + r * F + c0) & 15));
      const T* xr = reinterpret_cast<const T*>(
          st + span + (reinterpret_cast<uintptr_t>(x + r * F + c0) & 15));
      const float2 ms = stat[s];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int j = (i * NT + t) * VEC;
        if (j < n) {
          float d[VEC], v[VEC], g[VEC];
          ld_vec<VEC>(dr + j, d);
          ld_vec<VEC>(xr + j, v);
          if constexpr (AFFINE) ld_vec<VEC>(gsh + j, g);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xh = (v[e] - ms.x) * ms.y;
            const float dxh = AFFINE ? d[e] * g[e] : d[e];
            s1 += dxh;
            s2 += dxh * xh;
            if constexpr (AFFINE) {
              gw[i * VEC + e] += d[e] * xh;
              gb[i * VEC + e] += d[e];
            }
          }
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      float* rb = red + slot * 2 * kLnbWarps;
      if (lane == 0) {
        rb[2 * warp] = s1;
        rb[2 * warp + 1] = s2;
      }
      hopper::bar_sync(1, NT);
      s1 = s2 = 0.f;
#pragma unroll
      for (int w = 0; w < kLnbWarps; ++w) {
        s1 += rb[2 * w];
        s2 += rb[2 * w + 1];
      }
      if constexpr (CL > 1) {
        // the other half's sums: ours into its slot, its into ours
        if (t == 0) {
          const uint32_t peer = static_cast<uint32_t>(rank ^ 1);
          hopper::st_peer_f2(hopper::peer_addr(&xch[slot], peer), s1, s2);
          hopper::mbar_arrive_peer(hopper::peer_addr(&xbar[slot], peer));
        }
        hopper::mbar_wait_cluster(&xbar[slot], xph);
        const float2 p = xch[slot];
        s1 += p.x;
        s2 += p.y;
      }
      const float m1 = s1 / Ff, m2 = s2 / Ff;
      T* out = dx + r * F + c0;
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int j = (i * NT + t) * VEC;
        if (j < n) {
          float d[VEC], v[VEC], g[VEC], o[VEC];
          ld_vec<VEC>(dr + j, d);
          ld_vec<VEC>(xr + j, v);
          if constexpr (AFFINE) ld_vec<VEC>(gsh + j, g);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xh = (v[e] - ms.x) * ms.y;
            const float dxh = AFFINE ? d[e] * g[e] : d[e];
            o[e] = ms.y * (dxh - m1 - xh * m2);
          }
          st_vec<VEC>(out + j, o);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
      slot ^= 1;
      if (slot == 0) xph ^= 1;
    }
    if constexpr (AFFINE) {
      // VEC >= 4 divides F and c0: 16-byte stores into ws's rows
      float* w0 = ws + cl * F + c0;
      float* w1 = ws + ((long long)clusters + cl) * F + c0;
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int j = (i * NT + t) * VEC;
        if (j < n) {
          if constexpr (VEC >= 4) {
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float* a = gw + i * VEC + e;
              const float* b = gb + i * VEC + e;
              *reinterpret_cast<float4*>(w0 + j + e) =
                  make_float4(a[0], a[1], a[2], a[3]);
              *reinterpret_cast<float4*>(w1 + j + e) =
                  make_float4(b[0], b[1], b[2], b[3]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              w0[j + e] = gw[i * VEC + e];
              w1[j + e] = gb[i * VEC + e];
            }
          }
        }
      }
    }
  }
  // no block leaves while the other may still write to its shared memory
  if constexpr (CL > 1) hopper::cluster_sync();
}

template <typename T, typename W, bool A, int V, int CL>
cudaError_t launch_row(const T* dy, const T* x, const W* g, const float* m,
                       const float* iv, T* dx, float* ws, long long rows,
                       int F, int stages, int clusters, int smem,
                       cudaStream_t st) {
  auto kernel = ln_wide_bwd_row_kernel<T, W, A, V, CL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(CL * clusters));
  cfg.blockDim = dim3(kLnbThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, dy, x, g, m, iv, dx, ws, rows, F,
                            stages, clusters);
}

// calls f(std::integral_constant<int, VEC>), VEC row_vec's for the buffers
template <typename T, typename Fn>
void with_vec_row(int F, Fn&& f, const T* a, const T* b, const T* c) {
  const int v = row_vec(F, sizeof(T), reinterpret_cast<uintptr_t>(a) |
                                          reinterpret_cast<uintptr_t>(b) |
                                          reinterpret_cast<uintptr_t>(c));
  if constexpr (sizeof(T) == 2) {
    if (v == 8) {
      f(std::integral_constant<int, 8>{});
      return;
    }
  }
  if (v == 4) {
    f(std::integral_constant<int, 4>{});
  } else if (v == 2) {
    f(std::integral_constant<int, 2>{});
  } else {
    f(std::integral_constant<int, 1>{});
  }
}

}  // namespace
}  // namespace apex_port

// The launch of a call (ln_row_plan.cuh) as five ints: row_plan's
// cluster, stages, clusters and bytes of shared memory a block, and
// row_vec's load width on 16-byte-aligned buffers. Returns
// cudaErrorInvalidValue where F is not in 1..16384 or rows < 1.
extern "C" int apex_layer_norm_bwd_row_plan(long long rows, int F,
                                            int x_size, int w_size,
                                            int* plan) {
  using namespace apex_port;
  if (rows < 1 || F < 1 || F > kLnbRowMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RowPlan p = row_plan(rows, F, x_size, w_size);
  plan[0] = p.cluster;
  plan[1] = p.stages;
  plan[2] = p.clusters;
  plan[3] = p.smem;
  plan[4] = row_vec(F, x_size, 0);
  return p.stages >= 2 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// dy, x, dx [rows, F] in one dtype, F <= 16384, any base; gamma [F] or
// null (then ws, gw, gb are unused); mean, invvar fp32 [rows]; ws fp32 [2,
// min(rows, 132), F] scratch, of which the plan's clusters take [2,
// clusters, F]; gw, gb fp32 [F]. Two launches (one without gamma).
// Returns cudaGetLastError().
extern "C" int apex_layer_norm_bwd_row(int x_dtype, int w_dtype,
                                       const void* dy, const void* x,
                                       const void* gamma, const void* mean,
                                       const void* invvar, void* dx,
                                       void* ws, void* gw, void* gb,
                                       long long rows, int F, void* stream) {
  using namespace apex_port;
  if (rows < 1 || F < 1 || F > kLnbRowMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const bool ok = with_x_w(x_dtype, w_dtype, gamma != nullptr,
                           [&](auto xt, auto wt, auto affine) {
    using T = typename decltype(xt)::type;
    using W = typename decltype(wt)::type;
    constexpr bool A = decltype(affine)::value;
    const RowPlan plan = row_plan(rows, F, sizeof(T), A ? sizeof(W) : 0);
    // 16-bit rows always fit whole (kernels of 2-block clusters are built
    // for fp32 rows only)
    if (plan.stages < 2 || (plan.cluster == 2 && sizeof(T) != 4)) {
      err = cudaErrorInvalidValue;
      return;
    }
    const T* d = static_cast<const T*>(dy);
    const T* xp = static_cast<const T*>(x);
    const W* g = static_cast<const W*>(gamma);
    T* o = static_cast<T*>(dx);
    const float* m = static_cast<const float*>(mean);
    const float* iv = static_cast<const float*>(invvar);
    float* w = static_cast<float*>(ws);
    with_vec_row<T>(F, [&](auto vec) {
      constexpr int V = decltype(vec)::value;
      if (plan.cluster == 1) {
        err = launch_row<T, W, A, V, 1>(d, xp, g, m, iv, o, w, rows, F,
                                        plan.stages, plan.clusters,
                                        plan.smem, st);
      } else if constexpr (sizeof(T) == 4) {
        err = launch_row<T, W, A, V, 2>(d, xp, g, m, iv, o, w, rows, F,
                                        plan.stages, plan.clusters,
                                        plan.smem, st);
      }
    }, d, xp, static_cast<const T*>(o));
    if (err == cudaSuccess && A) {
      // a programmatic dependent launch: its blocks take the SMs as the
      // row kernel's leave, and wait for its partials (griddepcontrol)
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(static_cast<unsigned>((F + 31) / 32));
      cfg.blockDim = dim3(32, 32);
      cfg.stream = st;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[0].val.programmaticStreamSerializationAllowed = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, finalize_kernel,
                               static_cast<const float*>(w), plan.clusters, F,
                               static_cast<float*>(gw),
                               static_cast<float*>(gb));
    }
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
