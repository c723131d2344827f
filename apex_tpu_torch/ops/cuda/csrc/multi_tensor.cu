// Multi-tensor kernels over the flat parameter store, seen as (rows, 128):
// the loss scaler's unscale with its overflow flag, the two phases of
// FusedLAMB, FusedAdam's update, the per-row stage of the per-tensor norms
// (sum of squares, max |x|), FusedSGD's update, NovoGrad's elementwise
// update, gradient accumulation's a·x + b·y with its overflow flag, the
// global L2 norm and FusedAdagrad's update. All math is fp32; the storage
// dtype (fp32 or bf16) is kept on write.
//
// scale replaces the Pallas kernel apex_tpu/ops/pallas/multi_tensor.py
// scale -> _scale_kernel (:96). lamb_phase1 / lamb_phase2 replace
// lamb_step -> _lamb_phase1_kernel (:452) / _lamb_phase2_kernel (:480).
// adam replaces adam_step -> _adam_kernel (:270). rowsumsq / rowmaxabs
// replace rowsumsq -> _rowsumsq_kernel (:197) and rowmaxabs ->
// _rowmaxabs_kernel (:219). sgd replaces sgd_step -> _sgd_kernel (:354).
// novograd replaces novograd_step -> _novograd_kernel (:393). axpby
// replaces axpby -> _axpby_kernel (:127), l2norm replaces l2norm ->
// _sumsq_kernel (:169), adagrad replaces adagrad_step -> _adagrad_kernel
// (:322).
//
// Bound on this card: bytes, for all of them. Each reads its inputs once
// and writes its outputs once with a handful of flops per element (~20 for
// phase 1 and Adam), far below the 295 operations per byte where the H100
// turns compute-bound. At RN50's flat size T = 25,558,016 (fp32, R =
// 199,672 rows):
//   scale     8 B·T (x in, out)                      204.5 MB, 0.061 ms
//   phase1   28 B·T (g, p, m, v in; u, m, v out)    ~717 MB, 0.214 ms
//   phase2   12 B·T (p, u in; p out)                ~307 MB, 0.092 ms
//   rowsumsq  4 B·T + 4 B·R (x in; one sum a row)   ~103 MB, 0.031 ms
//   rowmaxabs 4 B·T + 4 B·R                          ~103 MB, 0.031 ms
//   sgd      20 B·T (g, p, m in; p, m out)          ~511 MB, 0.153 ms
//   novograd 20 B·T + 4 B·R (g, p, m in; p, m out; a row's segment id)
//                                                    ~512 MB, 0.153 ms
// and Adam at the LM's T = 138.5 M: 28 B·T (g, p, m, v in; p, m, v out),
// ~3.88 GB, 1.16 ms, at 3.35 TB/s; at that T, fp32:
//   axpby    12 B·T (x, y in; out)                  ~1.66 GB, 0.496 ms
//   l2norm    4 B·T (x in; one fp32 out)            ~0.55 GB, 0.165 ms
//   adagrad  20 B·T (g, p, h in; p, h out)          ~2.77 GB, 0.827 ms
// What the design does about it: every
// element is touched by one thread once, with 16-byte (fp32) or 8-byte
// (bf16) vector loads and stores; the per-row sums of p² and u² that the per-tensor norms need
// are taken from registers by a warp reduction in phase 1 (one warp per
// 128-element row), so the norms cost no extra sweep; phase 2 reads the
// row's trust ratio through the row's segment id, so no per-row ratio
// array is written. rowsumsq and rowmaxabs take one row a warp the same
// way and write one fp32 a row; the per-tensor sum or max over a
// segment's rows is a small fixed-order pass outside (segment_reduce over
// R values). novograd reads its row's denominator through the row's
// segment id, as phase 2 reads the ratio, so the (rows, 1) denominator
// the Pallas kernel takes is never written.
//
// Adam, SGD and Adagrad are one grid-stride pass of 4-wide vectors over the
// whole buffer. SGD's options (momentum, nesterov, weight decay before or
// after the momentum, weight decay at all) are bits of a flag word, uniform
// over the launch. Adagrad adds wd·p in both modes even at wd 0, as the
// JAX formula does. axpby is scale's pass over two inputs (any length, the
// ragged tail by scalar loads); its flag reads x, y or both, as the caller
// asks. l2norm runs in two stages with no float atomics: a fixed grid of
// blocks, each summing x² over its grid-stride share and reducing it in a
// fixed order to one partial, then one block that adds the partials in a
// fixed order and takes the square root, so two runs are bit-equal.
//
// Scalars the step computes on the device (the unscale factor, the bias
// corrections, the clip factor, SGD's first_run) are read from a small
// fp32 device array, as the Pallas kernels read them from SMEM: the host
// never waits for them.
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
// theirs bit for bit; only the per-row sums add in another order. A row's
// max |x| is exact (NaN wins, as in torch.amax), so rowmaxabs equals its
// plain version bit for bit.

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

// ---- per-row norms -----------------------------------------------------------

// max that lets a NaN through from either side, as torch.amax does
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
rowsumsq_kernel(const T* __restrict__ x, float* __restrict__ out,
                long long rows) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float v[4];
  load4(x + row * kLanes + lane * 4, v);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) s += v[e] * v[e];
  s = warp_sum(s);
  if (lane == 0) out[row] = s;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
rowmaxabs_kernel(const T* __restrict__ x, float* __restrict__ out,
                 long long rows) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float v[4];
  load4(x + row * kLanes + lane * 4, v);
  float mx = fabsf(v[0]);
#pragma unroll
  for (int e = 1; e < 4; ++e) mx = max_nan(mx, fabsf(v[e]));
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, k));
  if (lane == 0) out[row] = mx;
}

// ---- SGD ---------------------------------------------------------------------
// sc = [wd, lr, momentum, 1-dampening, scale, first_run]; flags as below.

constexpr int kSgdMomentum = 1, kSgdNesterov = 2, kSgdWdAfter = 4,
              kSgdWd = 8;

template <typename G, typename P>
__global__ void __launch_bounds__(kScaleThreads)
sgd_kernel(const G* __restrict__ g, const P* __restrict__ p,
           const P* __restrict__ m, P* __restrict__ p_out,
           P* __restrict__ m_out, const float* __restrict__ sc, long long n,
           int flags) {
  const float wd = sc[0], lr = sc[1], mom = sc[2], omd = sc[3];
  const float scl = sc[4];
  const bool first = sc[5] > 0.f;
  const bool use_mom = flags & kSgdMomentum, nest = flags & kSgdNesterov;
  const bool wd_before = (flags & kSgdWd) && !(flags & kSgdWdAfter);
  const bool wd_after = (flags & kSgdWd) && (flags & kSgdWdAfter);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       4 * i < n; i += stride) {
    const long long off = 4 * i;
    float gv[4], pv[4], mv[4];
    load4(g + off, gv);
    load4(p + off, pv);
    load4(m + off, mv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float gf = __fmul_rn(gv[e], scl);
      const float pf = pv[e];
      if (wd_before) gf = __fadd_rn(gf, __fmul_rn(wd, pf));
      if (use_mom) {
        const float mf =
            first ? gf : __fadd_rn(__fmul_rn(mv[e], mom), __fmul_rn(omd, gf));
        gf = nest ? __fadd_rn(gf, __fmul_rn(mom, mf)) : mf;
        mv[e] = mf;
      }
      if (wd_after) gf = __fadd_rn(gf, __fmul_rn(wd, pf));
      pv[e] = __fsub_rn(pf, __fmul_rn(lr, gf));
    }
    store4(p_out + off, pv);
    store4(m_out + off, mv);
  }
}

// ---- NovoGrad ------------------------------------------------------------------
// sc = [lr, b1, wd, beta3, bc1]; mode 0 divides the grad by the denominator
// and adds weight decay inside the moment, mode 1 outside it.

template <typename G, typename P>
__global__ void __launch_bounds__(kRowThreads)
novograd_kernel(const G* __restrict__ g, const P* __restrict__ p,
                const P* __restrict__ m, const float* __restrict__ denom,
                const int* __restrict__ row_seg, P* __restrict__ p_out,
                P* __restrict__ m_out, const float* __restrict__ sc,
                long long rows, int mode) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float lr = sc[0], b1 = sc[1], wd = sc[2], beta3 = sc[3];
  const float bc1 = sc[4];
  const float d = denom[row_seg[row]];
  const long long off = row * kLanes + (threadIdx.x & 31) * 4;
  float gv[4], pv[4], mv[4];
  load4(g + off, gv);
  load4(p + off, pv);
  load4(m + off, mv);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float pf = pv[e];
    float mf;
    if (mode == 0) {
      const float gf = __fadd_rn(__fdiv_rn(gv[e], d), __fmul_rn(wd, pf));
      mf = __fadd_rn(__fmul_rn(b1, mv[e]), __fmul_rn(beta3, gf));
      pv[e] = __fsub_rn(pf, __fmul_rn(lr, __fdiv_rn(mf, bc1)));
    } else {
      mf = __fadd_rn(__fmul_rn(b1, mv[e]), __fmul_rn(beta3, gv[e]));
      const float u =
          __fadd_rn(__fdiv_rn(__fdiv_rn(mf, bc1), d), __fmul_rn(wd, pf));
      pv[e] = __fsub_rn(pf, __fmul_rn(lr, u));
    }
    mv[e] = mf;
  }
  store4(p_out + off, pv);
  store4(m_out + off, mv);
}

// ---- axpby -------------------------------------------------------------------
// out = a·x + b·y in x's dtype; sc = [a, b]; check 0 flags a non-finite x,
// 1 a non-finite y, anything else either.

template <typename X, typename Y, int VEC>
__global__ void __launch_bounds__(kScaleThreads)
axpby_kernel(const X* __restrict__ x, const Y* __restrict__ y,
             X* __restrict__ out, const float* __restrict__ sc,
             int* __restrict__ flag, long long n, int check) {
  const float a = sc[0], b = sc[1];
  const bool cx = check != 1, cy = check != 0;
  bool bad = false;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = n / VEC;
  for (long long i = first; i < nvec; i += stride) {
    float xv[4], yv[4], o[4];
    if constexpr (VEC == 4) {
      load4(x + 4 * i, xv);
      load4(y + 4 * i, yv);
    } else {
      xv[0] = to_f(x[i]);
      yv[0] = to_f(y[i]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      bad |= (cx && !is_finite(xv[e])) || (cy && !is_finite(yv[e]));
      o[e] = __fadd_rn(__fmul_rn(a, xv[e]), __fmul_rn(b, yv[e]));
    }
    if constexpr (VEC == 4) {
      store4(out + 4 * i, o);
    } else {
      out[i] = from_f<X>(o[0]);
    }
  }
  // the ragged tail past the last full vector (at most 3 elements)
  for (long long i = nvec * VEC + first; i < n; i += stride) {
    const float xf = to_f(x[i]), yf = to_f(y[i]);
    bad |= (cx && !is_finite(xf)) || (cy && !is_finite(yf));
    out[i] = from_f<X>(__fadd_rn(__fmul_rn(a, xf), __fmul_rn(b, yf)));
  }
  if (bad) atomicOr(flag, 1);
}

template <typename X, typename Y>
void launch_axpby(const void* x, const void* y, void* out, const float* sc,
                  int* flag, long long n, int check, cudaStream_t st) {
  const X* xp = static_cast<const X*>(x);
  const Y* yp = static_cast<const Y*>(y);
  X* op = static_cast<X*>(out);
  const bool vec = aligned_vec<X>(x) && aligned_vec<Y>(y) &&
                   aligned_vec<X>(out);
  long long blocks = ((vec ? n / 4 : n) + kScaleThreads - 1) / kScaleThreads;
  blocks = blocks < 1 ? 1 : (blocks > kScaleMaxBlocks ? kScaleMaxBlocks
                                                      : blocks);
  if (vec) {
    axpby_kernel<X, Y, 4><<<(unsigned)blocks, kScaleThreads, 0, st>>>(
        xp, yp, op, sc, flag, n, check);
  } else {
    axpby_kernel<X, Y, 1><<<(unsigned)blocks, kScaleThreads, 0, st>>>(
        xp, yp, op, sc, flag, n, check);
  }
}

// ---- global L2 norm ------------------------------------------------------------
// Stage 1: each block sums x² over its grid-stride share, then reduces its
// threads in a fixed order (warp butterflies, then the warps' sums by one
// warp) to partial[block]. Stage 2: one block adds the partials in a fixed
// order and writes sqrt of the total. The grid depends on n only.

constexpr int kNormThreads = 256;

// the block's sum, in thread 0 (every thread must call it)
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float sh[kNormThreads / 32];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < kNormThreads / 32 ? sh[threadIdx.x] : 0.f;
  if (threadIdx.x < 32) v = warp_sum(v);
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kNormThreads)
sumsq_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                     long long n) {
  float s = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = n / VEC;
  for (long long i = first; i < nvec; i += stride) {
    float v[4];
    if constexpr (VEC == 4) {
      load4(x + 4 * i, v);
    } else {
      v[0] = to_f(x[i]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += v[e] * v[e];
  }
  for (long long i = nvec * VEC + first; i < n; i += stride) {
    const float v = to_f(x[i]);
    s += v * v;
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kNormThreads)
sumsq_finish_kernel(const float* __restrict__ partial, int blocks,
                    float* __restrict__ out) {
  float s = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kNormThreads) s += partial[i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[0] = __fsqrt_rn(s);
}

template <typename T>
void launch_l2norm(const void* x, float* partial, float* out, long long n,
                   int max_blocks, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const bool vec = aligned_vec<T>(x);
  long long blocks = ((vec ? n / 4 : n) + kNormThreads - 1) / kNormThreads;
  blocks = blocks < 1 ? 1 : (blocks > max_blocks ? max_blocks : blocks);
  if (vec) {
    sumsq_partial_kernel<T, 4><<<(unsigned)blocks, kNormThreads, 0, st>>>(
        xp, partial, n);
  } else {
    sumsq_partial_kernel<T, 1><<<(unsigned)blocks, kNormThreads, 0, st>>>(
        xp, partial, n);
  }
  sumsq_finish_kernel<<<1, kNormThreads, 0, st>>>(partial, (int)blocks, out);
}

// ---- Adagrad -------------------------------------------------------------------
// sc = [lr, eps, wd]; mode 0 folds weight decay into the gradient (L2),
// mode 1 adds it to the update (decoupled).

template <typename G, typename P>
__global__ void __launch_bounds__(kScaleThreads)
adagrad_kernel(const G* __restrict__ g, const P* __restrict__ p,
               const P* __restrict__ h, P* __restrict__ p_out,
               P* __restrict__ h_out, const float* __restrict__ sc,
               long long n, int mode) {
  const float lr = sc[0], eps = sc[1], wd = sc[2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       4 * i < n; i += stride) {
    const long long off = 4 * i;
    float gv[4], pv[4], hv[4];
    load4(g + off, gv);
    load4(p + off, pv);
    load4(h + off, hv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float gf = gv[e];
      const float pf = pv[e];
      if (mode == 0) gf = __fadd_rn(gf, __fmul_rn(wd, pf));
      const float hf = __fadd_rn(hv[e], __fmul_rn(gf, gf));
      float u = __fdiv_rn(gf, __fadd_rn(__fsqrt_rn(hf), eps));
      if (mode == 1) u = __fadd_rn(u, __fmul_rn(wd, pf));
      pv[e] = __fsub_rn(pf, __fmul_rn(lr, u));
      hv[e] = hf;
    }
    store4(p_out + off, pv);
    store4(h_out + off, hv);
  }
}

// A storage dtype as a type tag (common.cuh): with_type calls
// f(Tag<T>{}) for the dtype's T, with_gp_types f(Tag<G>{}, Tag<P>{}) for
// the (grad, param) pair; each returns false for a dtype the kernels do
// not take (fp16 here).

template <typename F>
bool with_type(int dtype, F&& f) {
  switch (dtype) {
    case kF32: f(Tag<float>{}); return true;
    case kBF16: f(Tag<__nv_bfloat16>{}); return true;
    default: return false;
  }
}

template <typename F>
bool with_gp_types(int g_dtype, int p_dtype, F&& f) {
  bool ok = false;
  with_type(g_dtype, [&](auto gt) {
    ok = with_type(p_dtype, [&](auto pt) { f(gt, pt); });
  });
  return ok;
}

// an entry point's return: cudaErrorInvalidValue for a dtype it does not
// take, else the launch's cudaGetLastError()
int launched(bool ok) {
  return static_cast<int>(ok ? cudaGetLastError() : cudaErrorInvalidValue);
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
  return launched(with_type(dtype, [&](auto t) {
    launch_scale<typename decltype(t)::type>(
        x, out, static_cast<const float*>(s), static_cast<int*>(flag), n,
        st);
  }));
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
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return launched(with_gp_types(g_dtype, p_dtype, [&](auto gt, auto pt) {
    using G = typename decltype(gt)::type;
    using P = typename decltype(pt)::type;
    lamb_phase1_kernel<G, P><<<(unsigned)blocks, kRowThreads, 0, st>>>(
        static_cast<const G*>(g), static_cast<const P*>(p),
        static_cast<const P*>(m), static_cast<const P*>(v),
        static_cast<float*>(u), static_cast<P*>(m_out),
        static_cast<P*>(v_out), static_cast<float*>(prow),
        static_cast<float*>(urow), static_cast<const float*>(sc), rows,
        mode);
  }));
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
  return launched(with_type(p_dtype, [&](auto pt) {
    using P = typename decltype(pt)::type;
    lamb_phase2_kernel<P><<<(unsigned)blocks, kRowThreads, 0, st>>>(
        static_cast<const P*>(p), static_cast<const float*>(u),
        static_cast<const float*>(ratio), static_cast<const int*>(row_seg),
        static_cast<P*>(out), rows);
  }));
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
  long long blocks = (n / 4 + kScaleThreads - 1) / kScaleThreads;
  blocks = blocks > kScaleMaxBlocks ? kScaleMaxBlocks : blocks;
  return launched(with_gp_types(g_dtype, p_dtype, [&](auto gt, auto pt) {
    using G = typename decltype(gt)::type;
    using P = typename decltype(pt)::type;
    adam_kernel<G, P><<<(unsigned)blocks, kScaleThreads, 0, st>>>(
        static_cast<const G*>(g), static_cast<const P*>(p),
        static_cast<const P*>(m), static_cast<const P*>(v),
        static_cast<P*>(p_out), static_cast<P*>(m_out),
        static_cast<P*>(v_out), static_cast<const float*>(sc), n, mode);
  }));
}

// x [rows*128] (fp32 or bf16, 4-element aligned); out fp32 [rows]: each
// row's sum of squares.
extern "C" int apex_rowsumsq(int dtype, const void* x, void* out,
                             long long rows, void* stream) {
  using namespace apex_port;
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return launched(with_type(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    rowsumsq_kernel<T><<<(unsigned)blocks, kRowThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<float*>(out), rows);
  }));
}

// x [rows*128] (fp32 or bf16, 4-element aligned); out fp32 [rows]: each
// row's max |x|.
extern "C" int apex_rowmaxabs(int dtype, const void* x, void* out,
                              long long rows, void* stream) {
  using namespace apex_port;
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return launched(with_type(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    rowmaxabs_kernel<T><<<(unsigned)blocks, kRowThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<float*>(out), rows);
  }));
}

// g [n] (fp32 or bf16); p, m [n] in one dtype (fp32 or bf16) and p_out,
// m_out like them, every buffer 4-element aligned, n a multiple of 4; sc
// fp32 [6] on the device; flags: 1 momentum, 2 nesterov, 4 weight decay
// after the momentum, 8 weight decay.
extern "C" int apex_sgd(int g_dtype, int p_dtype, const void* g,
                        const void* p, const void* m, void* p_out,
                        void* m_out, const void* sc, long long n, int flags,
                        void* stream) {
  using namespace apex_port;
  if (n < 4 || n % 4 != 0 || (flags & ~15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (n / 4 + kScaleThreads - 1) / kScaleThreads;
  blocks = blocks > kScaleMaxBlocks ? kScaleMaxBlocks : blocks;
  return launched(with_gp_types(g_dtype, p_dtype, [&](auto gt, auto pt) {
    using G = typename decltype(gt)::type;
    using P = typename decltype(pt)::type;
    sgd_kernel<G, P><<<(unsigned)blocks, kScaleThreads, 0, st>>>(
        static_cast<const G*>(g), static_cast<const P*>(p),
        static_cast<const P*>(m), static_cast<P*>(p_out),
        static_cast<P*>(m_out), static_cast<const float*>(sc), n, flags);
  }));
}

// g [rows*128] (fp32 or bf16); p, m [rows*128] in one dtype (fp32 or
// bf16) and p_out, m_out like them, each 4-element aligned; denom fp32
// [segments]; row_seg int32 [rows]; sc fp32 [5] on the device.
extern "C" int apex_novograd(int g_dtype, int p_dtype, const void* g,
                             const void* p, const void* m, const void* denom,
                             const void* row_seg, void* p_out, void* m_out,
                             const void* sc, long long rows, int mode,
                             void* stream) {
  using namespace apex_port;
  if (rows < 1 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return launched(with_gp_types(g_dtype, p_dtype, [&](auto gt, auto pt) {
    using G = typename decltype(gt)::type;
    using P = typename decltype(pt)::type;
    novograd_kernel<G, P><<<(unsigned)blocks, kRowThreads, 0, st>>>(
        static_cast<const G*>(g), static_cast<const P*>(p),
        static_cast<const P*>(m), static_cast<const float*>(denom),
        static_cast<const int*>(row_seg), static_cast<P*>(p_out),
        static_cast<P*>(m_out), static_cast<const float*>(sc), rows, mode);
  }));
}

// x, out [n] in one dtype and y [n] (each fp32 or bf16); sc fp32 [2] = [a,
// b] on the device; flag one zeroed int32, set to 1 when a checked input is
// not finite (check 0: x, 1: y, else both).
extern "C" int apex_axpby(int x_dtype, int y_dtype, const void* x,
                          const void* y, void* out, const void* sc,
                          void* flag, long long n, int check, void* stream) {
  using namespace apex_port;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launched(with_gp_types(x_dtype, y_dtype, [&](auto xt, auto yt) {
    launch_axpby<typename decltype(xt)::type, typename decltype(yt)::type>(
        x, y, out, static_cast<const float*>(sc), static_cast<int*>(flag), n,
        check, st);
  }));
}

// x [n] (fp32 or bf16); partial fp32 [max_blocks] scratch; out one fp32:
// sqrt(sum x²).
extern "C" int apex_l2norm(int dtype, const void* x, void* partial,
                           void* out, long long n, int max_blocks,
                           void* stream) {
  using namespace apex_port;
  if (n < 1 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launched(with_type(dtype, [&](auto t) {
    launch_l2norm<typename decltype(t)::type>(
        x, static_cast<float*>(partial), static_cast<float*>(out), n,
        max_blocks, st);
  }));
}

// g [n] (fp32 or bf16); p, h [n] in one dtype (fp32 or bf16) and p_out,
// h_out like them, every buffer 4-element aligned, n a multiple of 4; sc
// fp32 [3] = [lr, eps, wd] on the device.
extern "C" int apex_adagrad(int g_dtype, int p_dtype, const void* g,
                            const void* p, const void* h, void* p_out,
                            void* h_out, const void* sc, long long n,
                            int mode, void* stream) {
  using namespace apex_port;
  if (n < 4 || n % 4 != 0 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (n / 4 + kScaleThreads - 1) / kScaleThreads;
  blocks = blocks > kScaleMaxBlocks ? kScaleMaxBlocks : blocks;
  return launched(with_gp_types(g_dtype, p_dtype, [&](auto gt, auto pt) {
    using G = typename decltype(gt)::type;
    using P = typename decltype(pt)::type;
    adagrad_kernel<G, P><<<(unsigned)blocks, kScaleThreads, 0, st>>>(
        static_cast<const G*>(g), static_cast<const P*>(p),
        static_cast<const P*>(h), static_cast<P*>(p_out),
        static_cast<P*>(h_out), static_cast<const float*>(sc), n, mode);
  }));
}
