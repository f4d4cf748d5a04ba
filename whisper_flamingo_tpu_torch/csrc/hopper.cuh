// Hopper (sm_90a) primitives for the port's tensor-core kernels, in inline
// PTX: TMA tile loads into shared memory under mbarriers, wgmma products in
// the SS and RS forms with the 128-byte-swizzle shared-memory descriptor,
// the async-proxy fence and setmaxnreg; and, on the host, the encoding of
// the tensor maps that the TMA loads read (through the runtime's driver
// entry point, so a library built on this header links no libcuda).
//
// Conventions the kernels rely on (csrc/flash64_fwd.cu, csrc/flash64_bwd.cu):
//   - Every tile is rows of 64 bf16 (128 bytes) written by TMA with
//     CU_TENSOR_MAP_SWIZZLE_128B into shared memory aligned to 1024 bytes:
//     row r at byte r * 128, its 16-byte chunk c at chunk c ^ (r % 8).
//   - K-major operand (the contraction runs along the 128-byte row, as Q
//     and K in S = Q K^T): descriptor at the tile, SBO 1024 (8 rows), and
//     the k-th 16-wide slice starts 32 bytes further (the swizzle is a
//     function of the address, so the advance stays inside the atom).
//   - MN-major B (the contraction runs across rows, as V in O = P V):
//     transpose bit set, SBO 1024 (8 rows of the contraction), and the k-th
//     16-row slice starts 2048 bytes further. N is 64, one 128-byte span,
//     so LBO (the stride between 64-wide spans) is never taken; it is set
//     to 1024 as well.
//   - The fp32 accumulator of m64nNk16 is, per warp w of the warpgroup,
//     mma.sync's m16n8 C layout repeated over N / 8 column tiles: with
//     g = lane / 4 and q = lane % 4, d[4j + 2r + c] is row 16w + g + 8r,
//     column 8j + 2q + c. The RS form's A registers are m16n8k16's A
//     fragment of rows 16w..16w+15: a0 (g, 2q..), a1 (g + 8, 2q..),
//     a2 (g, 2q + 8..), a3 (g + 8, 2q + 8..), two bf16 each.
// tests/test_torch_cuda.py holds each form against torch.matmul through
// csrc/wgmma_check.cu.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// Shared memory, barriers, fences
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); a
// __syncthreads() after it makes them visible to the block.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier is
// in phase 0, so a wait on parity 1 passes at once (a producer's first wait
// on an empty ring slot).
// HOPPER_HANG_TRAP is for development only: built with
// -DHOPPER_HANG_TRAP=<polls>, a wait that has not completed after that many
// polls traps ("illegal instruction", which ends the process's CUDA
// context), so a barrier that never completes shows as a fault and not as
// a kernel that spins forever. The shipped build leaves it off.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
#ifdef HOPPER_HANG_TRAP
  unsigned long long polls = 0;
#endif
  do {
#ifdef HOPPER_HANG_TRAP
    if (++polls == (unsigned long long)(HOPPER_HANG_TRAP)) __trap();
#endif
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma operand reads, TMA) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers 1..15 (0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Register rebalancing between warpgroups; every warp of the warpgroup
// executes it, on a path that does not reconverge with the other roles.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The base of a kernel's dynamic shared memory rounded up to 1024 bytes,
// the alignment of the 128-byte swizzle's 8-row atoms.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// Softmax arithmetic
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (exp(x) is ex2(x * log2 e)).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to bf16 in one 32-bit register (lo in the low
// half): an A-fragment register of the RS wgmma.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 4-D tensor map into shared memory; completion (the box's
// bytes, out-of-bounds elements zero-filled) is counted on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (each >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// A K-major operand (rows of 64 along the contraction); the k-th 16-wide
// slice is desc + 2 * k (32 bytes).
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) {
  return desc_sw128(tile, 16, 1024);
}

// An MN-major B of 64 columns (rows along the contraction); the k-th
// 16-row slice is desc + 128 * k (2048 bytes).
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile) {
  return desc_sw128(tile, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties registers that an in-flight wgmma reads or writes to this point of
// the program, so the compiler neither reads an accumulator before the
// wait that completes it nor reuses an A register while it is being read.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D(64xN, fp32) (+)= A(64x16, bf16) B(16xN, bf16), issued by the whole
// warpgroup. ss: A and B from shared memory by descriptor; rs: A from
// registers. TRANS_B 0: B is stored [n][k] (K-major); 1: [k][n] (MN-major).
// scale_d 0 overwrites D, 1 accumulates into it.

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor-map encode failure is returned as this plus the CUresult, apart
// from the cudaError_t codes the launches return.
constexpr int kEncodeError = 10000;

static inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over rows of 64 bf16: dims (64, t, n_head, batch) with element
// strides (1, st, sh, sb), boxes of `box_rows` rows, 128-byte swizzle. Rows
// at or past t read as zeros. Returns 0 or kEncodeError + the CUresult.
static inline int encode_rows64(CUtensorMap* map, const void* base, int t, int n_head,
                                int batch, int64_t st, int64_t sh, int64_t sb, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {64, (cuuint64_t)t, (cuuint64_t)n_head, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

}  // namespace hopper
