// Hopper (sm_90a) building blocks of the flash kernels, in inline PTX:
// shared-memory addresses, mbarriers, TMA tile loads and L2 prefetches, the
// warpgroup products (wgmma) on 128-byte-swizzled tiles, and the register
// split between producer and consumer warpgroups (setmaxnreg); and of the
// wide LayerNorm backward (csrc/ln_bwd_row.cu): bulk TMA copies and a
// cluster's shared memory (ranks, peer addresses and barriers).
//
// The operand layout every product here reads: a tile of R rows of 64
// 16-bit elements, bf16 or fp16 (128 bytes a row), as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r sits at chunk c
// ^ (r % 8), the tile's base 1024-byte aligned. A head dim of 128 is two
// such tiles (columns 0-63 and 64-127), one after the other, 256 four and
// 512 eight.
// The same bytes serve as a K-major operand (the contraction runs along
// the 64 columns: the descriptor's start steps 32 bytes a k-step of 16, and
// 8-row groups lie SBO = 1024 bytes apart) and as an MN-major one (the
// contraction runs down the rows: a k-step of 16 rows is 2048 bytes, 8-row
// groups SBO = 1024 apart, and each further 64-column tile of a 128- or
// 256-wide operand lies LBO bytes on).
#pragma once

#include <cuda.h>   // CUtensorMap (a type only: nothing links libcuda)
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace apex_port {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x, opaque to the compiler: what is derived from it (an operand's
// descriptors) is rebuilt where it is used instead of held in registers
// across a loop
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// an arrival that also expects `bytes` more of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// expects `bytes` more of asynchronous copies in the current phase,
// without an arrival
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// ---- named barriers -----------------------------------------------------

// waits until `threads` threads (this one among them) reached barrier id
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// counts this thread at barrier id without waiting
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- TMA ----------------------------------------------------------------

// the box of `map` at (c0, c1, c2), innermost first, into dst; completes
// its bytes on bar. Rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the 128-byte line holding p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// `bytes` contiguous bytes from global src into dst (the bulk form of TMA,
// no tensor map): both 16-byte aligned, bytes a multiple of 16; completes
// its bytes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// orders this thread's plain writes to shared memory before later accesses
// of the same bytes by the async proxy (a bulk copy's writes)
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- clusters -------------------------------------------------------------

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the shared::cluster address of `p` (this block's shared memory) in the
// block of rank `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// two floats into another block's shared memory
__device__ __forceinline__ void st_peer_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(a), "f"(b) : "memory");
}

// an arrival on another block's mbarrier that releases this thread's
// writes to the cluster
__device__ __forceinline__ void mbar_arrive_peer(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(addr) : "memory");
}

// mbar_wait that acquires what another block of the cluster released
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// every thread of every block of the cluster (release, then acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n"
               ::: "memory");
}

// ---- registers ----------------------------------------------------------

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// ---- wgmma --------------------------------------------------------------

// the shared-memory descriptor of a 128-byte-swizzled operand starting at
// shared address `addr`, with its leading and stride byte offsets
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// orders this thread's register writes before the next products read them
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// pins an accumulator in program order: its reads stay after the wait
// before this, and its writes before the products after it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], 16-bit E in (bf16 or fp16: the
// instruction's type follows E), fp32 accumulators (d's element i of warp
// w, lane (g, t4) is row 16w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) +
// 2 t4 + (i & 1)); scale_d = 0 overwrites d. "ss": A and B K-major in
// shared memory; "rs": A from registers (the fragment a[0..3] of lane (g,
// t4): rows g, g + 8 by columns 2 t4, 2 t4 + 1, then the same 8 columns
// on), B K-major (TB = 0) or MN-major (TB = 1).
template <typename E>
constexpr bool kIsF16 = std::is_same<E, __half>::value;

#define APEX_ACC8(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7])
#define APEX_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define APEX_ACC16(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define APEX_ACC32(d)                                                      \
  APEX_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
      "+f"(d[30]), "+f"(d[31])
#define APEX_ACC64(d)                                                      \
  APEX_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),    \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),    \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),    \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),    \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),    \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define APEX_R16                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define APEX_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                       \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                                 \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                               \
  " %24, %25, %26, %27, %28, %29, %30, %31}"
#define APEX_R64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                       \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                                 \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                               \
  " %24, %25, %26, %27, %28, %29, %30, %31,"                               \
  " %32, %33, %34, %35, %36, %37, %38, %39,"                               \
  " %40, %41, %42, %43, %44, %45, %46, %47,"                               \
  " %48, %49, %50, %51, %52, %53, %54, %55,"                               \
  " %56, %57, %58, %59, %60, %61, %62, %63}"

#define APEX_ACC96(d)                                                      \
  APEX_ACC64(d),                                                           \
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]),     \
      "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),     \
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),     \
      "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),     \
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]),     \
      "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]),     \
      "+f"(d[94]), "+f"(d[95])
#define APEX_R96                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                       \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                                 \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                               \
  " %24, %25, %26, %27, %28, %29, %30, %31,"                               \
  " %32, %33, %34, %35, %36, %37, %38, %39,"                               \
  " %40, %41, %42, %43, %44, %45, %46, %47,"                               \
  " %48, %49, %50, %51, %52, %53, %54, %55,"                               \
  " %56, %57, %58, %59, %60, %61, %62, %63,"                               \
  " %64, %65, %66, %67, %68, %69, %70, %71,"                               \
  " %72, %73, %74, %75, %76, %77, %78, %79,"                               \
  " %80, %81, %82, %83, %84, %85, %86, %87,"                               \
  " %88, %89, %90, %91, %92, %93, %94, %95}"

#define APEX_ACC128(d)                                                     \
  APEX_ACC64(d),                                                           \
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]),     \
      "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),     \
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),     \
      "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),     \
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]),     \
      "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]),     \
      "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]),     \
      "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), \
      "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
      "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), \
      "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define APEX_R128                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                       \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                                 \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                               \
  " %24, %25, %26, %27, %28, %29, %30, %31,"                               \
  " %32, %33, %34, %35, %36, %37, %38, %39,"                               \
  " %40, %41, %42, %43, %44, %45, %46, %47,"                               \
  " %48, %49, %50, %51, %52, %53, %54, %55,"                               \
  " %56, %57, %58, %59, %60, %61, %62, %63,"                               \
  " %64, %65, %66, %67, %68, %69, %70, %71,"                               \
  " %72, %73, %74, %75, %76, %77, %78, %79,"                               \
  " %80, %81, %82, %83, %84, %85, %86, %87,"                               \
  " %88, %89, %90, %91, %92, %93, %94, %95,"                               \
  " %96, %97, %98, %99, %100, %101, %102, %103,"                           \
  " %104, %105, %106, %107, %108, %109, %110, %111,"                       \
  " %112, %113, %114, %115, %116, %117, %118, %119,"                       \
  " %120, %121, %122, %123, %124, %125, %126, %127}"

template <typename E>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (kIsF16<E>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " APEX_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : APEX_ACC32(d) : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " APEX_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : APEX_ACC32(d) : "l"(da), "l"(db), "r"(scale_d));
  }
}

// the m64n16k16 form: dq's 16-key tiles at D = 512 (csrc/flash_d512.cu)
template <typename E>
__device__ __forceinline__ void mma_ss_n16(float (&d)[8], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (kIsF16<E>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 " APEX_R8
        ", %8, %9, p, 1, 1, 0, 0;\n}\n"
        : APEX_ACC8(d) : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " APEX_R8
        ", %8, %9, p, 1, 1, 0, 0;\n}\n"
        : APEX_ACC8(d) : "l"(da), "l"(db), "r"(scale_d));
  }
}

template <typename E>
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (kIsF16<E>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " APEX_R16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : APEX_ACC16(d) : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " APEX_R16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : APEX_ACC16(d) : "l"(da), "l"(db), "r"(scale_d));
  }
}

template <typename E>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (kIsF16<E>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " APEX_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : APEX_ACC64(d) : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " APEX_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : APEX_ACC64(d) : "l"(da), "l"(db), "r"(scale_d));
  }
}

template <int TB, typename E>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  if constexpr (kIsF16<E>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " APEX_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : APEX_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " APEX_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : APEX_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
}

template <int TB, typename E>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  if constexpr (kIsF16<E>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " APEX_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : APEX_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " APEX_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : APEX_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
}

// the m64n192k16 form: half of a 384-wide accumulator (the D = 384
// kernels' O and dq, split over two warpgroups), 96 registers a thread
template <int TB, typename E>
__device__ __forceinline__ void mma_rs_n192(float (&d)[96],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (kIsF16<E>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.f16.f16 " APEX_R96
        ", {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : APEX_ACC96(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " APEX_R96
        ", {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : APEX_ACC96(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
}

// the m64n256k16 form: a 256-wide accumulator (the D = 256 kernels' O and
// dq), 128 registers a thread
template <int TB, typename E>
__device__ __forceinline__ void mma_rs_n256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (kIsF16<E>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 " APEX_R128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : APEX_ACC128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " APEX_R128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : APEX_ACC128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
}

#undef APEX_ACC8
#undef APEX_ACC16
#undef APEX_ACC32
#undef APEX_ACC64
#undef APEX_ACC96
#undef APEX_ACC128
#undef APEX_R8
#undef APEX_R16
#undef APEX_R32
#undef APEX_R64
#undef APEX_R96
#undef APEX_R128

template <int N, typename E>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (N == 16) mma_ss_n16<E>(d, da, db, scale_d);
  else if constexpr (N == 32) mma_ss_n32<E>(d, da, db, scale_d);
  else if constexpr (N == 64) mma_ss_n64<E>(d, da, db, scale_d);
  else mma_ss_n128<E>(d, da, db, scale_d);
}

template <int N, int TB, typename E>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  if constexpr (N == 64) mma_rs_n64<TB, E>(d, a, db, scale_d);
  else if constexpr (N == 128) mma_rs_n128<TB, E>(d, a, db, scale_d);
  else if constexpr (N == 192) mma_rs_n192<TB, E>(d, a, db, scale_d);
  else mma_rs_n256<TB, E>(d, a, db, scale_d);
}

}  // namespace hopper
}  // namespace apex_port
