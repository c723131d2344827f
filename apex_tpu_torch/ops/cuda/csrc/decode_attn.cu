// Single-query slot attention, dense and paged KV arenas: the serve decode
// step's attention core.
//
// Replaces the Pallas kernels of apex_tpu/ops/pallas/decode_attn.py:
//   decode_attention       -> _decode_kernel        (dense [S, H, L, hd])
//   paged_decode_attention -> _paged_decode_kernel  (pool [P+1, H, page, hd]
//                                                    + page table [S, P])
// One kernel body serves both; the template flag only changes how a key
// position becomes an address. Both therefore sum in the same order, so a
// paged decode is bitwise equal to a dense decode over the same bytes.
//
// Bound on this card: bytes. Each (slot, head) reads len * hd keys and as
// many values once and does ~4 flops per element read, far below the ~20
// flop/byte fp32 ridge, so the least time is
//   sum_s 2 * len_s * H * hd * sizeof(T) / 3.35 TB/s.
// What the design does about it: it reads only the first len_s positions
// of a slot (the loop stops at the length; masked positions would add
// exactly 0.0), reads each key and value once, keeps scores, the running
// max/sum and the fp32 PV accumulator in registers, never materialises the
// [S, H, L] scores or a gathered [S, H, L, hd] view of the page pool, and
// keeps many rows in flight: the 8 warps of a block walk the keys at once.
// Known limit: one block per (slot, head) gives S*H blocks (64 at the
// serve shape) for 132 SMs; a split over the key axis across blocks
// (flash-decoding) is the next step for speed.
//
// Layout: one block of 8 warps per (slot, head), head_dim 128; lane l
// holds dims 4l..4l+3 of q, of each key/value row (one vector load) and
// of its accumulator. Warp w takes the key groups w, w+8, w+16, ... of 8
// consecutive positions each; per group it
//   1. loads the 8 key and 8 value rows (all in flight together),
//   2. scores them (lane products, warp butterfly sums, * scale);
//      positions past the length score kNegInf,
//   3. runs the online-softmax update of decode_attn.py:150-161 (running
//      max m, sum l, rescale alpha) with the where() masking of :63-71,
//      all fp32, and adds p_j * v_j into its accumulator.
// On the paged arena a group reads its physical page from the block's
// page-table row once (page % 8 == 0, so a group never straddles pages).
// The block then merges the 8 warps' (m, l, acc) states and thread d
// writes out[d] = acc / (l > 0 ? l : 1) in q's dtype (length 0 gives 0).
// The order of every sum depends only on the positions, never on where a
// row lives, so the dense and paged arenas give the same bits.

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kHeadDim = 128;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;                 // keys a warp takes at once
constexpr int kRound = kWarps * kGroup;   // keys per round of a block

template <typename T, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   const int* __restrict__ page_table, T* __restrict__ out,
                   int H, int L, int page, int max_pages, float scale) {
  const int sh = blockIdx.x;                  // slot * H + head
  const int s = sh / H;
  const int h = sh - s * H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cap = PAGED ? max_pages * page : L;
  int n = __ldg(lengths + s);
  n = n < 0 ? 0 : (n > cap ? cap : n);

  float qv[4];
  load4(q + (size_t)sh * kHeadDim + lane * 4, qv);

  float m = kNegInf;       // this warp's running max, sum, accumulator
  float l = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int base = warp * kGroup; base < n; base += kRound) {
    // the group's first row; a group never straddles a page (the wrapper
    // requires page % kGroup == 0), so one table lookup serves all 8
    size_t row0;
    if (PAGED) {
      const int lp = base / page;
      const int phys = __ldg(page_table + (size_t)s * max_pages + lp);
      row0 = ((size_t)phys * H + h) * page + (base - lp * page);
    } else {
      row0 = (size_t)sh * L + base;
    }
    float kr[kGroup][4], vr[kGroup][4];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (base + j < n) {
        load4(k + (row0 + j) * kHeadDim + lane * 4, kr[j]);
        load4(v + (row0 + j) * kHeadDim + lane * 4, vr[j]);
      } else {
#pragma unroll
        for (int d = 0; d < 4; ++d) kr[j][d] = vr[j][d] = 0.f;
      }
    }
    float sc[kGroup];
    float gmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float dot = kr[j][0] * qv[0] + kr[j][1] * qv[1] +
                        kr[j][2] * qv[2] + kr[j][3] * qv[3];
      const float sj = warp_sum(dot) * scale;   // the whole warp shuffles
      sc[j] = base + j < n ? sj : kNegInf;
      gmax = fmaxf(gmax, sc[j]);
    }
    const float m_new = fmaxf(m, gmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float p = sc[j] > kNegInf * 0.5f ? expf(sc[j] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int d = 0; d < 4; ++d) acc[d] += p * vr[j][d];
    }
    l = l * alpha + psum;
    m = m_new;
  }

  // merge the warps' softmax states (a warp that saw no key holds
  // m = kNegInf, l = 0, acc = 0 and weighs exactly 0, or 1 if all did)
  __shared__ float m_sh[kWarps];
  __shared__ float l_sh[kWarps];
  __shared__ float acc_sh[kWarps][kHeadDim];
  if (lane == 0) {
    m_sh[warp] = m;
    l_sh[warp] = l;
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) acc_sh[warp][lane * 4 + d] = acc[d];
  __syncthreads();
  if (threadIdx.x < kHeadDim) {
    const int d = threadIdx.x;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_sh[w]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_sh[w] - mx);
      lt += l_sh[w] * f;
      o += acc_sh[w][d] * f;
    }
    out[(size_t)sh * kHeadDim + d] = from_f<T>(o / (lt > 0.f ? lt : 1.f));
  }
}

template <typename T>
void launch(bool paged, const void* q, const void* k, const void* v,
            const int* lengths, const int* pt, void* out, int S, int H,
            int L, int page, int max_pages, float scale, cudaStream_t st) {
  const dim3 grid(S * H), block(kThreads);
  if (paged) {
    decode_attn_kernel<T, true><<<grid, block, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), lengths, pt, static_cast<T*>(out), H, L,
        page, max_pages, scale);
  } else {
    decode_attn_kernel<T, false><<<grid, block, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), lengths, pt, static_cast<T*>(out), H, L,
        page, max_pages, scale);
  }
}

}  // namespace
}  // namespace apex_port

// q [S, H, 128]; dense: k/v [S, H, L, 128]; paged: k/v [P+1, H, page, 128]
// and page_table i32 [S, max_pages]; lengths i32 [S]; out [S, H, 128].
// Returns cudaGetLastError() after the launch.
extern "C" int apex_decode_attention(int dtype, const void* q,
                                     const void* k, const void* v,
                                     const void* lengths,
                                     const void* page_table, void* out,
                                     int S, int H, int L, int page,
                                     int max_pages, int paged, float scale,
                                     void* stream) {
  using namespace apex_port;
  if (paged && (page < kGroup || page % kGroup != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  const int* pt = static_cast<const int*>(page_table);
  switch (dtype) {
    case kF32:
      launch<float>(paged, q, k, v, lens, pt, out, S, H, L, page,
                    max_pages, scale, st);
      break;
    case kBF16:
      launch<__nv_bfloat16>(paged, q, k, v, lens, pt, out, S, H, L, page,
                            max_pages, scale, st);
      break;
    case kF16:
      launch<__half>(paged, q, k, v, lens, pt, out, S, H, L, page,
                     max_pages, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
