// Multi-tensor kernels over the flat parameter store, seen as (rows, 128):
// the loss scaler's unscale with its overflow flag, the two phases of
// FusedLAMB, and FusedAdam's update. All math is fp32; the storage dtype
// (fp32 or bf16) is kept on write.
//
// scale replaces the Pallas kernel apex_tpu/ops/pallas/multi_tensor.py
// scale -> _scale_kernel (:96). lamb_phase1 / lamb_phase2 replace
// lamb_step -> _lamb_phase1_kernel (:452) / _lamb_phase2_kernel (:480).
// adam replaces adam_step -> _adam_kernel (:270).
//
// Bound on this card: bytes, for all four. Each reads its inputs once and
// writes its outputs once with a handful of flops per element (~20 for
// phase 1 and Adam), far below the 295 operations per byte where the H100
// turns compute-bound. At RN50's flat size T = 25,558,016 (fp32):
//   scale   8 B·T (x in, out)                      204.5 MB, 0.061 ms
//   phase1 28 B·T (g, p, m, v in; u, m, v out)    ~717 MB, 0.214 ms
//   phase2 12 B·T (p, u in; p out)                ~307 MB, 0.092 ms
// and Adam at the LM's T = 138.5 M: 28 B·T (g, p, m, v in; p, m, v out),
// ~3.88 GB, 1.16 ms, at 3.35 TB/s. What the design does about it: every
// element is touched by one thread once, with 16-byte (fp32) or 8-byte
// (bf16) vector loads and stores; the per-row sums of p² and u² that the per-tensor norms need
// are taken from registers by a warp reduction in phase 1 (one warp per
// 128-element row), so the norms cost no extra sweep; phase 2 reads the
// row's trust ratio through the row's segment id, so no per-row ratio
// array is written.
//
// Adam is one grid-stride pass of 4-wide vectors over the whole buffer.
//
// Scalars the step computes on the device (the unscale factor, the bias
// corrections, the clip factor) are read from a small fp32 device array,
// as the Pallas kernels read them from SMEM: the host never waits for
// them.
//
// The overflow flag: the Pallas kernel carries it across its sequential
// grid; here blocks run in any order, so each thread that saw a
// non-finite input ORs 1 into a zeroed int32 flag. That is exact and
// independent of order. It reads the input, so an unscale that saturates
// still reports the overflow.
//
// Rounding: the update arithmetic uses the _rn intrinsics, which the
// compiler never contracts into FMAs, in the order of the plain PyTorch
// versions (apex_tpu_torch/ops/multi_tensor.py), so u, m, v and p equal
// theirs bit for bit; only the per-row sums add in another order.

#include "common.cuh"

namespace apex_port {
namespace {

constexpr int kLanes = 128;          // row width of the flat store
constexpr int kRowsPerBlock = 8;     // one warp per row
constexpr int kRowThreads = 32 * kRowsPerBlock;
constexpr int kScaleThreads = 256;
constexpr long long kScaleMaxBlocks = 132 * 16;

// false for +-inf and NaN (every comparison with NaN is false)
__device__ __forceinline__ bool is_finite(float v) {
  return fabsf(v) <= 3.402823466e+38f;
}

// ---- scale -----------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kScaleThreads)
scale_kernel(const T* __restrict__ x, T* __restrict__ out,
             const float* __restrict__ s, int* __restrict__ flag,
             long long n) {
  const float sf = *s;
  bool bad = false;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = n / VEC;
  for (long long i = first; i < nvec; i += stride) {
    float v[4], o[4];
    if constexpr (VEC == 4) {
      load4(x + 4 * i, v);
    } else {
      v[0] = to_f(x[i]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      bad |= !is_finite(v[e]);
      o[e] = __fmul_rn(v[e], sf);
    }
    if constexpr (VEC == 4) {
      store4(out + 4 * i, o);
    } else {
      out[i] = from_f<T>(o[0]);
    }
  }
  // the ragged tail past the last full vector (at most 3 elements)
  for (long long i = nvec * VEC + first; i < n; i += stride) {
    const float v = to_f(x[i]);
    bad |= !is_finite(v);
    out[i] = from_f<T>(__fmul_rn(v, sf));
  }
  if (bad) atomicOr(flag, 1);
}

template <typename T>
bool aligned_vec(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

template <typename T>
void launch_scale(const void* x, void* out, const float* s, int* flag,
                  long long n, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (aligned_vec<T>(x) && aligned_vec<T>(out)) {
    long long blocks = (n / 4 + kScaleThreads - 1) / kScaleThreads;
    blocks = blocks < 1 ? 1 : (blocks > kScaleMaxBlocks ? kScaleMaxBlocks
                                                        : blocks);
    scale_kernel<T, 4><<<(unsigned)blocks, kScaleThreads, 0, st>>>(
        xp, op, s, flag, n);
  } else {
    long long blocks = (n + kScaleThreads - 1) / kScaleThreads;
    blocks = blocks > kScaleMaxBlocks ? kScaleMaxBlocks : blocks;
    scale_kernel<T, 1><<<(unsigned)blocks, kScaleThreads, 0, st>>>(
        xp, op, s, flag, n);
  }
}

// ---- LAMB phase 1 ----------------------------------------------------------
// sc = [b1, b2, eps, wd, beta3, 1-b2, bc1, bc2, clip]; mode 0 folds weight
// decay into the gradient (L2), mode 1 adds it to the update (decoupled).

template <typename G, typename P>
__global__ void __launch_bounds__(kRowThreads)
lamb_phase1_kernel(const G* __restrict__ g, const P* __restrict__ p,
                   const P* __restrict__ m, const P* __restrict__ v,
                   float* __restrict__ u, P* __restrict__ m_out,
                   P* __restrict__ v_out, float* __restrict__ prow,
                   float* __restrict__ urow, const float* __restrict__ sc,
                   long long rows, int mode) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;            // the whole warp
  const int lane = threadIdx.x & 31;
  const float b1 = sc[0], b2 = sc[1], eps = sc[2], wd = sc[3];
  const float beta3 = sc[4], omb2 = sc[5], bc1 = sc[6], bc2 = sc[7];
  const float clip = sc[8];
  const long long off = row * kLanes + lane * 4;
  float gv[4], pv[4], mv[4], vv[4];
  load4(g + off, gv);
  load4(p + off, pv);
  load4(m + off, mv);
  load4(v + off, vv);
  float uo[4], mo[4], vo[4];
  float ps = 0.f, us = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float pf = pv[e];
    float gf = __fdiv_rn(gv[e], clip);
    if (mode == 0) gf = __fadd_rn(gf, __fmul_rn(wd, pf));
    const float mf = __fadd_rn(__fmul_rn(b1, mv[e]), __fmul_rn(beta3, gf));
    const float vf =
        __fadd_rn(__fmul_rn(b2, vv[e]), __fmul_rn(__fmul_rn(omb2, gf), gf));
    float up = __fdiv_rn(__fdiv_rn(mf, bc1),
                         __fadd_rn(__fsqrt_rn(__fdiv_rn(vf, bc2)), eps));
    if (mode == 1) up = __fadd_rn(up, __fmul_rn(wd, pf));
    uo[e] = up;
    mo[e] = mf;
    vo[e] = vf;
    ps += pf * pf;
    us += up * up;
  }
  store4(u + off, uo);
  store4(m_out + off, mo);
  store4(v_out + off, vo);
  ps = warp_sum(ps);
  us = warp_sum(us);
  if (lane == 0) {
    prow[row] = ps;
    urow[row] = us;
  }
}

template <typename G, typename P>
void launch_phase1(const void* g, const void* p, const void* m,
                   const void* v, void* u, void* m_out, void* v_out,
                   void* prow, void* urow, const void* sc, long long rows,
                   int mode, cudaStream_t st) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  lamb_phase1_kernel<G, P><<<(unsigned)blocks, kRowThreads, 0, st>>>(
      static_cast<const G*>(g), static_cast<const P*>(p),
      static_cast<const P*>(m), static_cast<const P*>(v),
      static_cast<float*>(u), static_cast<P*>(m_out),
      static_cast<P*>(v_out), static_cast<float*>(prow),
      static_cast<float*>(urow), static_cast<const float*>(sc), rows, mode);
}

// ---- LAMB phase 2 ----------------------------------------------------------

template <typename P>
__global__ void __launch_bounds__(kRowThreads)
lamb_phase2_kernel(const P* __restrict__ p, const float* __restrict__ u,
                   const float* __restrict__ ratio,
                   const int* __restrict__ row_seg, P* __restrict__ out,
                   long long rows) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float r = ratio[row_seg[row]];
  const long long off = row * kLanes + (threadIdx.x & 31) * 4;
  float pv[4], uv[4], o[4];
  load4(p + off, pv);
  load4(u + off, uv);
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = __fsub_rn(pv[e], __fmul_rn(r, uv[e]));
  store4(out + off, o);
}

// ---- Adam ------------------------------------------------------------------
// sc = [lr, b1, b2, eps, bc1, bc2, wd, 1-b1, 1-b2]; mode 0 folds weight
// decay into the gradient (L2), mode 1 adds it to the update (AdamW).

template <typename G, typename P>
__global__ void __launch_bounds__(kScaleThreads)
adam_kernel(const G* __restrict__ g, const P* __restrict__ p,
            const P* __restrict__ m, const P* __restrict__ v,
            P* __restrict__ p_out, P* __restrict__ m_out,
            P* __restrict__ v_out, const float* __restrict__ sc,
            long long n, int mode) {
  const float lr = sc[0], b1 = sc[1], b2 = sc[2], eps = sc[3];
  const float bc1 = sc[4], bc2 = sc[5], wd = sc[6], omb1 = sc[7];
  const float omb2 = sc[8];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       4 * i < n; i += stride) {
    const long long off = 4 * i;
    float gv[4], pv[4], mv[4], vv[4];
    load4(g + off, gv);
    load4(p + off, pv);
    load4(m + off, mv);
    load4(v + off, vv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float gf = gv[e];
      const float pf = pv[e];
      if (mode == 0) gf = __fadd_rn(gf, __fmul_rn(wd, pf));
      const float mf = __fadd_rn(__fmul_rn(b1, mv[e]), __fmul_rn(omb1, gf));
      const float vf =
          __fadd_rn(__fmul_rn(b2, vv[e]), __fmul_rn(__fmul_rn(omb2, gf), gf));
      float up = __fdiv_rn(__fdiv_rn(mf, bc1),
                           __fadd_rn(__fsqrt_rn(__fdiv_rn(vf, bc2)), eps));
      if (mode == 1) up = __fadd_rn(up, __fmul_rn(wd, pf));
      pv[e] = __fsub_rn(pf, __fmul_rn(lr, up));
      mv[e] = mf;
      vv[e] = vf;
    }
    store4(p_out + off, pv);
    store4(m_out + off, mv);
    store4(v_out + off, vv);
  }
}

template <typename G, typename P>
void launch_adam(const void* g, const void* p, const void* m, const void* v,
                 void* p_out, void* m_out, void* v_out, const void* sc,
                 long long n, int mode, cudaStream_t st) {
  long long blocks = (n / 4 + kScaleThreads - 1) / kScaleThreads;
  blocks = blocks > kScaleMaxBlocks ? kScaleMaxBlocks : blocks;
  adam_kernel<G, P><<<(unsigned)blocks, kScaleThreads, 0, st>>>(
      static_cast<const G*>(g), static_cast<const P*>(p),
      static_cast<const P*>(m), static_cast<const P*>(v),
      static_cast<P*>(p_out), static_cast<P*>(m_out), static_cast<P*>(v_out),
      static_cast<const float*>(sc), n, mode);
}

}  // namespace
}  // namespace apex_port

// x, out [n] (fp32 or bf16); s one fp32 on the device; flag one zeroed
// int32, set to 1 when any x is not finite. Returns cudaGetLastError().
extern "C" int apex_scale(int dtype, const void* x, void* out,
                          const void* s, void* flag, long long n,
                          void* stream) {
  using namespace apex_port;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  int* fp = static_cast<int*>(flag);
  switch (dtype) {
    case kF32: launch_scale<float>(x, out, sp, fp, n, st); break;
    case kBF16: launch_scale<__nv_bfloat16>(x, out, sp, fp, n, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g [rows*128] (fp32 or bf16); p, m, v [rows*128] in one dtype (fp32 or
// bf16), each 4-element aligned; u fp32 and m_out, v_out (p's dtype) of the
// same length; prow, urow fp32 [rows]; sc fp32 [9] on the device.
extern "C" int apex_lamb_phase1(int g_dtype, int p_dtype, const void* g,
                                const void* p, const void* m, const void* v,
                                void* u, void* m_out, void* v_out,
                                void* prow, void* urow, const void* sc,
                                long long rows, int mode, void* stream) {
  using namespace apex_port;
  if (rows < 1 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_dtype == kF32 && p_dtype == kF32) {
    launch_phase1<float, float>(g, p, m, v, u, m_out, v_out, prow, urow, sc,
                                rows, mode, st);
  } else if (g_dtype == kBF16 && p_dtype == kF32) {
    launch_phase1<__nv_bfloat16, float>(g, p, m, v, u, m_out, v_out, prow,
                                        urow, sc, rows, mode, st);
  } else if (g_dtype == kF32 && p_dtype == kBF16) {
    launch_phase1<float, __nv_bfloat16>(g, p, m, v, u, m_out, v_out, prow,
                                        urow, sc, rows, mode, st);
  } else if (g_dtype == kBF16 && p_dtype == kBF16) {
    launch_phase1<__nv_bfloat16, __nv_bfloat16>(g, p, m, v, u, m_out, v_out,
                                                prow, urow, sc, rows, mode,
                                                st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// p, out [rows*128] (fp32 or bf16); u fp32 [rows*128]; ratio fp32
// [segments]; row_seg int32 [rows].
extern "C" int apex_lamb_phase2(int p_dtype, const void* p, const void* u,
                                const void* ratio, const void* row_seg,
                                void* out, long long rows, void* stream) {
  using namespace apex_port;
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const float* up = static_cast<const float*>(u);
  const float* rp = static_cast<const float*>(ratio);
  const int* sp = static_cast<const int*>(row_seg);
  switch (p_dtype) {
    case kF32:
      lamb_phase2_kernel<float><<<(unsigned)blocks, kRowThreads, 0, st>>>(
          static_cast<const float*>(p), up, rp, sp, static_cast<float*>(out),
          rows);
      break;
    case kBF16:
      lamb_phase2_kernel<__nv_bfloat16>
          <<<(unsigned)blocks, kRowThreads, 0, st>>>(
              static_cast<const __nv_bfloat16*>(p), up, rp, sp,
              static_cast<__nv_bfloat16*>(out), rows);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g [n] (fp32 or bf16); p, m, v [n] in one dtype (fp32 or bf16) and
// p_out, m_out, v_out like them, every buffer 4-element aligned, n a
// multiple of 4; sc fp32 [9] on the device.
extern "C" int apex_adam(int g_dtype, int p_dtype, const void* g,
                         const void* p, const void* m, const void* v,
                         void* p_out, void* m_out, void* v_out,
                         const void* sc, long long n, int mode,
                         void* stream) {
  using namespace apex_port;
  if (n < 4 || n % 4 != 0 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_dtype == kF32 && p_dtype == kF32) {
    launch_adam<float, float>(g, p, m, v, p_out, m_out, v_out, sc, n, mode,
                              st);
  } else if (g_dtype == kBF16 && p_dtype == kF32) {
    launch_adam<__nv_bfloat16, float>(g, p, m, v, p_out, m_out, v_out, sc, n,
                                      mode, st);
  } else if (g_dtype == kF32 && p_dtype == kBF16) {
    launch_adam<float, __nv_bfloat16>(g, p, m, v, p_out, m_out, v_out, sc, n,
                                      mode, st);
  } else if (g_dtype == kBF16 && p_dtype == kBF16) {
    launch_adam<__nv_bfloat16, __nv_bfloat16>(g, p, m, v, p_out, m_out, v_out,
                                              sc, n, mode, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
