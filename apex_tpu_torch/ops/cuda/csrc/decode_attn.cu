// Single-query slot attention, dense and paged KV arenas: the serve decode
// step's attention core, with its keys split across blocks (flash-decoding).
//
// Replaces the Pallas kernels of apex_tpu/ops/pallas/decode_attn.py:
//   decode_attention       -> _decode_kernel        (dense [S, H, L, hd])
//   paged_decode_attention -> _paged_decode_kernel  (pool [P+1, H, page, hd]
//                                                    + page table [S, P])
// for head_dim 64 and 128, in fp32, bf16 and fp16.
//
// Bound on this card: bytes. Each (slot, head) reads len * hd keys and as
// many values once and does ~4 flops per element read, far below the ~20
// flop/byte fp32 ridge, so the least time is
//   sum_s 2 * len_s * H * hd * sizeof(T) / 3.35 TB/s.
// At the serve shape (8 slots x 8 heads of 128, lengths up to 1024, bf16)
// that is 14.7 MB, 4.4 us: the card's 132 SMs must all stream at once.
//
// Design. One block of 4 warps per (slot * H + head, chunk of kChunk = 64
// key positions): a row of length n takes ceil(n / 64) blocks (grid.y
// covers the arena's capacity; a block whose chunk starts at or past n
// returns before it loads any key or value), so a slot of 1024 keys spreads
// over 16 SMs instead of streaming its 512 KB through one. The serve
// shape's ~470 live blocks must all be resident at once, so the 16-bit
// forms hold their keys and values as loaded (two 32-bit words a row).
// Inside a block, warp w takes the 16 positions 16w..16w+15 of the chunk
// (4 warps of 16 keys timed faster on the H100 than 8 of 8, 8 of 16 and
// 16 of 8), every load issued before the first is used, and q, the length
// and (paged) the page-table entries are loaded together before them: at
// hd 128 a key row is one warp (lane l holds dims 4l..4l+3, one 8-byte
// load in bf16); at hd 64 a key row is a half-warp and the two halves
// take two keys at once, so a lane still
// makes one 8-byte load per row (the choice between that and a lane
// holding 2 dims of a full-warp row: the same bytes, but half the loads
// in flight, and the 4-dim lane keeps one code path for both head dims).
// Each warp (hd 64: each half) scores its keys (lane products, a butterfly
// over the row's lanes, * scale; positions past the length score kNegInf
// and are never loaded), and keeps the softmax state of
// decode_attn.py:150-161: the max m, the sum l of exp(s - m) and the fp32
// accumulator sum p_j v_j, with the where() masking of :63-71. The block
// merges its 4 (hd 64: 8) states in a fixed order through shared memory.
// A row that fits one chunk (n <= 64) writes o = acc / l (o = 0 for n = 0)
// at once; a longer row writes its chunk's (m, l, acc[hd]) to a workspace,
// and decode_merge_kernel, one block per row, merges the row's chunks in
// chunk order (up to 16 chunks loading all their partials at once) and
// writes o in q's dtype. The merge is a programmatic
// dependent launch: its blocks start while the chunk kernel runs, read
// their lengths, and wait (griddepcontrol.wait) for the chunk kernel's
// writes, so the second launch's latency hides under the first kernel.
// There are no float atomics, and the chunk boundaries (multiples of 64
// positions) depend only on the positions, never on where a row lives: on
// the paged arena a lane follows the page table for each of its keys (any
// page size), so a paged decode sums in the same order as a dense one and
// the two agree bit for bit, and two runs repeat bit for bit.
//
// Q rows per slot (speculative scoring, apex_tpu/contrib/multihead_attn/
// decode_attention.py:88-136's query axis): q [S, Q, H, hd] and lengths
// [S, Q], Q <= kMaxRows, each row masked to its own length. The JAX
// package flattens the rows into the slot axis, K/V broadcast per row
// (dense) or the page table repeated (paged): that is the TPU grid's
// layout. Here a block of (slot * H + head, chunk) loads its K/V chunk
// ONCE, up to the longest row's length, and scores every row of the slot
// that reaches into the chunk; the rows share the slot's page-table row.
// The bound is then the K/V bytes of the longest row, not of every row.
// The slot's q rows are staged in shared memory as floats, and the block
// walks its rows in a loop whose body is the 1-query kernel's: the 1-query
// form (Q = 1) is that body run once, the MULTI form runs it for each row
// with the keys and values kept in registers, as loaded, between the rows.
// Each row so
// runs the arithmetic of a 1-query call at its length (a key past the
// row's length scores kNegInf and adds a value of 0, as an unloaded key
// does there), its chunk partials are written where a 1-query call of
// S * Q rows would write them, and the merge adds them as it adds that
// call's: a row's output is bit-equal to the 1-query call's at that row's
// length (tests/test_torch_decode_rows_cuda.py holds every Q to 8), and
// chunks past a row's length never enter its merge.

#include <type_traits>

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kChunk = 64;                 // key positions a block takes
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = kChunk / kWarps;  // positions a warp takes
// chunks whose partials the merge loads all at once (a row of up to 1024
// positions); a longer row's are walked in a loop
constexpr int kPrefetch = 16;
// the query rows one slot may bring (speculative scoring: k + 1 rows)
constexpr int kMaxRows = 8;

// the (m, l, acc[HD]) partial of one (row, chunk) in the workspace
template <int HD>
constexpr int kPart = HD + 2;

// an empty asm that the compiler must take to rewrite the raw words: the
// multi-row form calls it on its keys and values at each row, so their
// fp32 unpacking cannot be hoisted out of the row loop (at head dim 128 in
// 16-bit that held 128 registers more, 206 a thread, two blocks an SM)
__device__ __forceinline__ void keep_raw(uint2& r) {
  asm volatile("" : "+r"(r.x), "+r"(r.y));
}
__device__ __forceinline__ void keep_raw(float4& r) {
  asm volatile("" : "+f"(r.x), "+f"(r.y), "+f"(r.z), "+f"(r.w));
}

// the keys and values held as loaded (at head dim 128 in 16-bit, 32
// registers); four blocks an SM at most 128 registers a thread. MULTI: nq
// query rows a slot, q and out [S, nq, H, HD], lengths [S, nq], part's rows
// (slot * nq + row) * H + head; the keys and values stay live, as loaded,
// across the rows: four blocks an SM in 16-bit, three in fp32 (whose raw
// keys and values take twice the registers; held to four it ran 1.3x
// slower, decode_rows_ab.py variants). The 1-query form (MULTI false,
// nq 1) runs the same body once, its q straight into registers.
template <typename T, int HD, bool PAGED, bool MULTI>
__global__ void __launch_bounds__(kThreads,
                                  MULTI && sizeof(T) == 4 ? 3 : 4)
decode_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    const int* __restrict__ page_table, T* __restrict__ out,
                    float* __restrict__ part, int H, int L, int page,
                    int max_pages, int nq_arg, float scale) {
  constexpr int kRowLanes = HD / 4;            // lanes of one key row
  constexpr int kSubs = 32 / kRowLanes;        // rows a warp takes at once
  constexpr int kLaneKeys = kWarpKeys / kSubs;  // keys a lane loads
  constexpr int kStates = kWarps * kSubs;
  constexpr int kRows = MULTI ? kMaxRows : 1;  // query rows the block holds
  const int nq = MULTI ? nq_arg : 1;
  // the merge kernel may start while this grid runs (it waits for this
  // grid's writes before it reads them)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int sh = blockIdx.x;                   // slot * H + head
  const int chunk = blockIdx.y;
  const int s = sh / H;
  const int h = sh - s * H;
  const int cap = PAGED ? max_pages * page : L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / kRowLanes;            // which of the warp's rows
  const int dl = lane % kRowLanes;             // dims 4 dl .. 4 dl + 3
  const int c0 = chunk * kChunk;
  const int* len_s = lengths + (size_t)s * nq;
  float qv1[4];                                // the 1-query form's q
  if (!MULTI) load4(q + (size_t)sh * HD + dl * 4, qv1);
  // the lengths and (paged) this lane's pages are loaded together; the
  // keys and values only once the chunk is known to hold some
  size_t row0[kLaneKeys];
#pragma unroll
  for (int i = 0; i < kLaneKeys; ++i) {
    const int pos = c0 + warp * kWarpKeys + sub + kSubs * i;
    if (PAGED) {
      const int lp = (pos < cap ? pos : 0) / page;
      const int phys = __ldg(page_table + (size_t)s * max_pages + lp);
      row0[i] = ((size_t)phys * H + h) * page + (pos - lp * page);
    } else {
      row0[i] = (size_t)sh * L + pos;
    }
  }
  int nmax = 0;                                // the slot's longest row
  for (int r = 0; r < nq; ++r) {
    const int n = __ldg(len_s + r);
    nmax = max(nmax, n < 0 ? 0 : (n > cap ? cap : n));
  }
  if (c0 >= nmax && chunk > 0) return;         // past every row: no K, V

  // this lane's keys: positions c0 + 16 warp + sub + kSubs i, read once
  // for all the slot's rows
  using R = typename Raw4<T>::type;
  R kraw[kLaneKeys], vraw[kLaneKeys];
#pragma unroll
  for (int i = 0; i < kLaneKeys; ++i) {
    const int pos = c0 + warp * kWarpKeys + sub + kSubs * i;
    if (pos < nmax) {
      kraw[i] = raw4(k + row0[i] * HD + dl * 4);
      vraw[i] = raw4(v + row0[i] * HD + dl * 4);
    } else {
      kraw[i] = vraw[i] = R{};
    }
  }
  // the slot's q rows as floats
  __shared__ __align__(16) float q_sh[kRows][HD];
  if (MULTI) {
    for (int i = threadIdx.x; i < nq * (HD / 4); i += kThreads) {
      const int r = i / (HD / 4);
      const int c = (i - r * (HD / 4)) * 4;
      float qv[4];
      load4(q + (((size_t)s * nq + r) * H + h) * HD + c, qv);
#pragma unroll
      for (int d = 0; d < 4; ++d) q_sh[r][c + d] = qv[d];
    }
    __syncthreads();
  }

  // each row's per-warp state: the row's own length masks its scores (a
  // state that saw no key holds m = kNegInf, l = 0, acc = 0 and weighs
  // exactly 0, or 1 if all did)
  __shared__ float m_sh[kRows][kStates];
  __shared__ float l_sh[kRows][kStates];
  __shared__ float acc_sh[kRows][kStates][HD];
  const int st = warp * kSubs + sub;
  for (int r = 0; r < nq; ++r) {
    int n = __ldg(len_s + r);
    n = n < 0 ? 0 : (n > cap ? cap : n);
    if (c0 >= n && chunk > 0) continue;        // the row ends before
    if (MULTI) {
#pragma unroll
      for (int i = 0; i < kLaneKeys; ++i) {
        keep_raw(kraw[i]);
        keep_raw(vraw[i]);
      }
    }
    float qv[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) qv[d] = MULTI ? q_sh[r][dl * 4 + d] : qv1[d];
    float sc[kLaneKeys];
    float m = kNegInf;
#pragma unroll
    for (int i = 0; i < kLaneKeys; ++i) {
      float kr[4];
      unpack(kraw[i], kr, k);
      float dot = kr[0] * qv[0] + kr[1] * qv[1] + kr[2] * qv[2] +
                  kr[3] * qv[3];
      // the row's lanes only: offsets below kRowLanes stay inside it
#pragma unroll
      for (int off = kRowLanes / 2; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      const int pos = c0 + warp * kWarpKeys + sub + kSubs * i;
      sc[i] = pos < n ? dot * scale : kNegInf;
      m = fmaxf(m, sc[i]);
    }
    float l = 0.f;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kLaneKeys; ++i) {
      const int pos = c0 + warp * kWarpKeys + sub + kSubs * i;
      const float p = sc[i] > kNegInf * 0.5f ? expf(sc[i] - m) : 0.f;
      float vr[4];
      unpack(vraw[i], vr, v);
      l += p;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        // the 1-query form never loads a key past its length (it holds 0)
        acc[d] += p * ((!MULTI || pos < n) ? vr[d] : 0.f);
      }
    }
    if (dl == 0) {
      m_sh[r][st] = m;
      l_sh[r][st] = l;
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) acc_sh[r][st][dl * 4 + d] = acc[d];
  }
  __syncthreads();

  // each live row's states merged in a fixed order; at head dim 64 the
  // block's two halves take alternate rows
  const int d = threadIdx.x % HD;
  for (int r = threadIdx.x / HD; r < nq; r += kThreads / HD) {
    int n = __ldg(len_s + r);
    n = n < 0 ? 0 : (n > cap ? cap : n);
    if (c0 >= n && chunk > 0) continue;
    const size_t row = ((size_t)s * nq + r) * H + h;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kStates; ++w) mx = fmaxf(mx, m_sh[r][w]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kStates; ++w) {
      const float f = expf(m_sh[r][w] - mx);
      lt += l_sh[r][w] * f;
      o += acc_sh[r][w][d] * f;
    }
    if (n <= kChunk) {        // one chunk: the row's output at once
      out[row * HD + d] = from_f<T>(o / (lt > 0.f ? lt : 1.f));
      continue;
    }
    float* pr = part + (row * gridDim.y + chunk) * kPart<HD>;
    pr[2 + d] = o;
    if (d == 0) {
      pr[0] = mx;
      pr[1] = lt;
    }
  }
}

// one block of HD threads per row (slot * H + head) of more than one
// chunk: the chunks' partials merged in chunk order, the max first (exact
// in any order), then the sums in chunk order. Up to kPrefetch chunks
// every thread loads all of them at once (one round trip); a longer row's
// max is taken strided over the threads and its sums in a loop.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_merge_kernel(const float* __restrict__ part,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int cap, int nchunk) {
  __shared__ float red[HD / 32];
  const int sh = blockIdx.x;
  int n = __ldg(lengths + sh / H);
  n = n < 0 ? 0 : (n > cap ? cap : n);
  if (n <= kChunk) return;           // written by its one chunk
  // launched as the chunk kernel's dependent: its partials are complete
  // and visible past this (a no-op for a launch of its own)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int live = (n + kChunk - 1) / kChunk;
  const float* pr = part + (size_t)sh * nchunk * kPart<HD>;
  const int d = threadIdx.x;
  float mx = kNegInf, lt = 0.f, o = 0.f;
  if (live <= kPrefetch) {
    float mr[kPrefetch], lr[kPrefetch], ar[kPrefetch];
#pragma unroll
    for (int c = 0; c < kPrefetch; ++c) {
      const float* pc = pr + c * kPart<HD>;
      mr[c] = c < live ? pc[0] : kNegInf;
      lr[c] = c < live ? pc[1] : 0.f;
      ar[c] = c < live ? pc[2 + d] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kPrefetch; ++c) mx = fmaxf(mx, mr[c]);
#pragma unroll
    for (int c = 0; c < kPrefetch; ++c) {
      if (c < live) {
        const float f = expf(mr[c] - mx);
        lt += lr[c] * f;
        o += ar[c] * f;
      }
    }
    out[(size_t)sh * HD + d] = from_f<T>(o / (lt > 0.f ? lt : 1.f));
    return;
  }
  for (int c = d; c < live; c += HD) mx = fmaxf(mx, pr[c * kPart<HD>]);
  mx = warp_max(mx);
  if ((d & 31) == 0) red[d >> 5] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < HD / 32; ++w) mx = fmaxf(mx, red[w]);
#pragma unroll 8
  for (int c = 0; c < live; ++c) {
    const float* pc = pr + c * kPart<HD>;
    const float f = expf(pc[0] - mx);
    lt += pc[1] * f;
    o += pc[2 + d] * f;
  }
  out[(size_t)sh * HD + d] = from_f<T>(o / (lt > 0.f ? lt : 1.f));
}

// calls f(Tag<T>, HD) for a storage dtype code and a head dim of 64 or
// 128; false for any other
template <typename F>
bool with_dtype_hd(int dtype, int hd, F&& f) {
  if (hd != 64 && hd != 128) return false;
  return with_storage(dtype, [&](auto tag) {
    if (hd == 64) f(tag, std::integral_constant<int, 64>{});
    else f(tag, std::integral_constant<int, 128>{});
  });
}

}  // namespace
}  // namespace apex_port

// q [S, nq, H, hd] (hd 64 or 128, 1 <= nq <= 8); dense: k/v [S, H, L,
// hd]; paged: k/v [P+1, H, page, hd] and page_table i32 [S, max_pages];
// lengths i32 [S, nq]; out [S, nq, H, hd]; part fp32 [S * nq * H, nchunk,
// hd + 2] scratch, nchunk = ceil(capacity / 64) with capacity L (dense) or
// max_pages * page (paged). Every tensor contiguous, q/k/v/out 16-byte
// aligned. Rows longer than one chunk are finished by apex_decode_merge
// over S * nq rows. Returns cudaGetLastError().
extern "C" int apex_decode_attention(int dtype, const void* q,
                                     const void* k, const void* v,
                                     const void* lengths,
                                     const void* page_table, void* out,
                                     void* part, int S, int H, int hd,
                                     int L, int page, int max_pages,
                                     int paged, int nchunk, int nq,
                                     float scale, void* stream) {
  using namespace apex_port;
  const long long cap = paged ? (long long)max_pages * page : L;
  if (S < 1 || H < 1 || cap < 1 || cap > 0x7fffffffLL ||
      (paged && (page < 1 || page_table == nullptr)) ||
      nchunk != (cap + kChunk - 1) / kChunk || nchunk > 65535 ||
      (nchunk > 1 && part == nullptr) || nq < 1 || nq > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(S * H, nchunk), block(kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  const int* pt = static_cast<const int*>(page_table);
  float* pr = static_cast<float*>(part);
  const bool ok = with_dtype_hd(dtype, hd, [&](auto tag, auto hdc) {
    using T = typename decltype(tag)::type;
    constexpr int HD = decltype(hdc)::value;
    const T* qp = static_cast<const T*>(q);
    const T* kp = static_cast<const T*>(k);
    const T* vp = static_cast<const T*>(v);
    T* op = static_cast<T*>(out);
    // one body, two forms: MULTI keeps the keys and values across the
    // rows; the 1-query form is its single pass
    auto launch = [&](auto paged_c, auto multi_c) {
      decode_chunk_kernel<T, HD, decltype(paged_c)::value,
                          decltype(multi_c)::value>
          <<<grid, block, 0, st>>>(qp, kp, vp, lens, pt, op, pr, H, L,
                                   page, max_pages, nq, scale);
    };
    using Yes = std::true_type;
    using No = std::false_type;
    if (paged) {
      if (nq > 1) launch(Yes{}, Yes{}); else launch(Yes{}, No{});
    } else {
      if (nq > 1) launch(No{}, Yes{}); else launch(No{}, No{});
    }
  });
  return static_cast<int>(ok ? cudaGetLastError() : cudaErrorInvalidValue);
}

// The second launch of a decode whose capacity passes one chunk: part as
// apex_decode_attention wrote it; out [S, H, hd] gets the rows longer than
// one chunk (the others it leaves). Returns cudaGetLastError().
extern "C" int apex_decode_merge(int dtype, const void* part,
                                 const void* lengths, void* out, int S,
                                 int H, int hd, int cap, int nchunk,
                                 void* stream) {
  using namespace apex_port;
  if (S < 1 || H < 1 || cap < 1 ||
      nchunk != (cap + kChunk - 1) / kChunk || part == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const bool ok = with_dtype_hd(dtype, hd, [&](auto tag, auto hdc) {
    using T = typename decltype(tag)::type;
    constexpr int HD = decltype(hdc)::value;
    // a programmatic dependent launch: its blocks start while the chunk
    // kernel before it on the stream runs, and wait for its writes
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S * H);
    cfg.blockDim = dim3(HD);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, decode_merge_kernel<T, HD>,
                             static_cast<const float*>(part),
                             static_cast<const int*>(lengths),
                             static_cast<T*>(out), H, cap, nchunk);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
