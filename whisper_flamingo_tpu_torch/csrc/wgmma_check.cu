// One wgmma product of each form that the flash64 kernels use, for the
// card-only tests (tests/test_torch_cuda.py hold it against torch.matmul):
// a single warpgroup loads A (64 x 64) and B by TMA in the 128-byte swizzle,
// as the kernels do, issues `ksteps` k16 products and writes the fp32
// accumulator out through the layout csrc/hopper.cuh states. It checks the
// descriptors (K-major and MN-major), the k-slice advances, the RS form's
// A-fragment layout and the accumulator layout; and the m64n8 RS form of
// the forward variants' row-sum product, its B copied by the threads into
// the unswizzled core-matrix layout that desc_plain describes; and the
// decode-MLP kernel's SS widths (csrc/decode_mlp.cu) at N = 8, 32, 64 and
// 128 against a K-major swizzled B, with A by TMA or converted from int8
// into the swizzled layout as that kernel converts its weights; and the two
// forms of the matmul-pair kernel (csrc/mma_pair.cu): SS with K = d up to
// 256 (A K-major over d / 64 tiles, B MN-major over d rows) and RS at N = 64,
// 128 and 256 (B MN-major over N / 64 tiles, LBO apart). Besides, a kernel
// that leaves stale barriers in shared memory for the decode-MLP tests. It
// is on no system path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// form 0: SS, B K-major; 1: RS, B K-major; 2: RS, B MN-major; 3: SS, B
// MN-major; 4: RS, n 8, B K-major without swizzle. a is (64, 64) [m][k]; b
// is (n, 64) [n][k] for K-major and (64, 64) [k][n] for MN-major; d is
// (64, n) fp32.
__global__ void __launch_bounds__(128) wgmma_check_kernel(const __grid_constant__ CUtensorMap amap,
                                                          const __grid_constant__ CUtensorMap bmap,
                                                          const bf16* __restrict__ a,
                                                          const bf16* __restrict__ b,
                                                          float* __restrict__ d, int n, int form,
                                                          int ksteps, int b_bytes) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* as = reinterpret_cast<bf16*>(base);
  bf16* bs = reinterpret_cast<bf16*>(base + 64 * 64 * 2);
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (form == 4) {
    // element (n, k) at k-slice k / 16 (256 bytes each), core matrix
    // (k % 16) / 8 (LBO 128 bytes), row n (16 bytes), column k % 8
    for (int i = threadIdx.x; i < 8 * 64; i += 128) {
      const int nn = i / 64, k = i % 64;
      bs[(k / 16) * 128 + ((k % 16) / 8) * 64 + nn * 8 + k % 8] = b[i];
    }
    fence_proxy_async();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 64 * 64 * 2 + b_bytes);
    tma_load_4d(as, &amap, &bar, 0, 0, 0, 0);
    if (b_bytes) tma_load_4d(bs, &bmap, &bar, 0, 0, 0, 0);
  }
  mbar_wait(&bar, 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = warp * 16 + g;
  uint32_t af[4][4];  // A fragments straight from global memory
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * tq;
    af[kk][0] = *reinterpret_cast<const uint32_t*>(a + r0 * 64 + c);
    af[kk][1] = *reinterpret_cast<const uint32_t*>(a + (r0 + 8) * 64 + c);
    af[kk][2] = *reinterpret_cast<const uint32_t*>(a + r0 * 64 + c + 8);
    af[kk][3] = *reinterpret_cast<const uint32_t*>(a + (r0 + 8) * 64 + c + 8);
  }
  float acc64[32], acc128[64], acc8[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc64[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc128[i] = 0.f;

  const uint64_t ad = desc_k_major(as), bk = desc_k_major(bs), bm = desc_mn_major(bs);
  const uint64_t bp = desc_plain(bs, 128, 256);
  fence_regs(acc8);
  fence_regs(acc64);
  fence_regs(acc128);
  fence_regs(af);
  wgmma_fence();
  for (int kk = 0; kk < ksteps; ++kk) {
    if (form == 0 && n == 128) {
      wgmma_ss_n128<0>(acc128, ad + 2 * kk, bk + 2 * kk, 1);
    } else if (form == 0) {
      wgmma_ss_n64<0>(acc64, ad + 2 * kk, bk + 2 * kk, 1);
    } else if (form == 1) {
      wgmma_rs_n64<0>(acc64, af[kk], bk + 2 * kk, 1);
    } else if (form == 2) {
      wgmma_rs_n64<1>(acc64, af[kk], bm + 128 * kk, 1);
    } else if (form == 4) {
      wgmma_rs_n8(acc8, af[kk], bp + 16 * kk, 1);
    } else {
      wgmma_ss_n64<1>(acc64, ad + 2 * kk, bm + 128 * kk, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc8);
  fence_regs(acc64);
  fence_regs(acc128);
  fence_regs(af);

#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * tq + c;
        if (col >= n) continue;
        const float x = n == 128 ? acc128[4 * j + 2 * r + c]
                        : n == 8  ? acc8[2 * r + c]
                                  : acc64[(4 * j + 2 * r + c) % 32];
        d[(r0 + 8 * r) * n + col] = x;
      }
}


// The decode-MLP widths: D (64 x N) = A (64 x 16 ksteps) B^T, B (N, 64)
// [n][k] by TMA in the 128-byte swizzle, SS. mode 0: A bf16 by TMA; 1: A
// int8 (64, 64) [m][k], converted by the threads into the swizzled bf16
// layout with hopper::int8x4_to_bf16x4, as the decode-MLP kernel does.
template <int N>
__global__ void __launch_bounds__(128) wgmma_width_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
    const int8_t* __restrict__ a8, float* __restrict__ d, int mode, int ksteps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* as = base;
  uint8_t* bs = base + 64 * 64 * 2;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, (mode == 0 ? 64 * 64 * 2 : 0) + N * 64 * 2);
    if (mode == 0) tma_load_4d(as, &amap, &bar, 0, 0, 0, 0);
    tma_load_4d(bs, &bmap, &bar, 0, 0, 0, 0);
  }
  if (mode == 1) {  // 16 int8 of row m a thread-chunk: two swizzled 16-byte chunks
    for (int i = threadIdx.x; i < 64 * 4; i += 128) {
      const int m = i / 4, c4 = i % 4;
      const uint4 v = *reinterpret_cast<const uint4*>(a8 + m * 64 + c4 * 16);
      uint32_t o[8];
      int8x4_to_bf16x4(v.x, o[0], o[1]);
      int8x4_to_bf16x4(v.y, o[2], o[3]);
      int8x4_to_bf16x4(v.z, o[4], o[5]);
      int8x4_to_bf16x4(v.w, o[6], o[7]);
      uint8_t* row = as + m * 128;
      *reinterpret_cast<uint4*>(row + (((2 * c4) ^ (m & 7)) * 16)) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(row + (((2 * c4 + 1) ^ (m & 7)) * 16)) = make_uint4(o[4], o[5], o[6], o[7]);
    }
    fence_proxy_async();
  }
  __syncthreads();
  mbar_wait(&bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, r0 = warp * 16 + g;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint64_t ad = desc_k_major(as), bd = desc_k_major(bs);
  fence_regs(acc);
  wgmma_fence();
  for (int kk = 0; kk < ksteps; ++kk) wgmma_ss<N>(acc, ad + 2 * kk, bd + 2 * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) d[(r0 + 8 * r) * N + 8 * j + 2 * tq + c] = acc[4 * j + 2 * r + c];
}

template <int N>
int launch_width(const CUtensorMap& am, const CUtensorMap& bm, const void* a8, float* d, int mode,
                 int ksteps, cudaStream_t s) {
  const int smem = 1024 + 64 * 64 * 2 + N * 64 * 2;
  cudaFuncSetAttribute(wgmma_width_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wgmma_width_kernel<N><<<1, 128, smem, s>>>(am, bm, static_cast<const int8_t*>(a8), d, mode,
                                             ksteps);
  return static_cast<int>(cudaGetLastError());
}


// The matmul-pair kernel's SS form: D (64 x 64) = A (64 x K) B (K x 64), A
// [m][k] by TMA as K / 64 K-major tiles, B [k][n] by TMA as one MN-major
// tile of K rows, as the kernel holds o and a u chunk.
template <int K>
__global__ void __launch_bounds__(128) pair_ss_check_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
    float* __restrict__ d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = align1024(smem_raw);
  uint8_t* bs = as + K * 128;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(&bar, 2 * K * 128);
    for (int e = 0; e < K / 64; ++e) tma_load_2d(as + e * 8192, &amap, &bar, e * 64, 0);
    tma_load_2d(bs, &bmap, &bar, 0, 0);
  }
  __syncthreads();
  mbar_wait(&bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, r0 = warp * 16 + g;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_ss_n64<1>(acc, desc_k_major(as + (kk / 4) * 8192) + 2 * (kk % 4),
                    desc_sw128(bs, 1024, 1024) + 128 * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) d[(r0 + 8 * r) * 64 + 8 * j + 2 * tq + c] = acc[4 * j + 2 * r + c];
}

// The matmul-pair kernel's RS form: D (64 x N) = A (64 x 64, fragments from
// global memory) B (64 x N), B [k][n] by TMA as N / 64 MN-major tiles of 64
// rows, LBO 8192 apart, as the kernel holds a v chunk.
template <int N>
__global__ void __launch_bounds__(128) pair_rs_check_kernel(
    const __grid_constant__ CUtensorMap bmap, const bf16* __restrict__ a, float* __restrict__ d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* bs = align1024(smem_raw);
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(&bar, N * 128);
    for (int e = 0; e < N / 64; ++e) tma_load_2d(bs + e * 8192, &bmap, &bar, e * 64, 0);
  }
  __syncthreads();
  mbar_wait(&bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, r0 = warp * 16 + g;
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * tq;
    af[kk][0] = *reinterpret_cast<const uint32_t*>(a + r0 * 64 + c);
    af[kk][1] = *reinterpret_cast<const uint32_t*>(a + (r0 + 8) * 64 + c);
    af[kk][2] = *reinterpret_cast<const uint32_t*>(a + r0 * 64 + c + 8);
    af[kk][3] = *reinterpret_cast<const uint32_t*>(a + (r0 + 8) * 64 + c + 8);
  }
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  fence_regs(af);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<N, 1>(acc, af[kk], desc_sw128(bs, 8192, 1024) + 128 * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(af);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) d[(r0 + 8 * r) * N + 8 * j + 2 * tq + c] = acc[4 * j + 2 * r + c];
}

template <typename Kernel, typename... Args>
int launch_pair_check(Kernel kernel, int smem, cudaStream_t s, Args... args) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<1, 128, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, d contiguous on the card (see the kernel); n 64 or 128 (128 only
// with form 0, MN-major forms only at 64), 8 with form 4 only; ksteps
// 1..4. Returns the launch's
// cudaGetLastError(), cudaErrorInvalidValue for arguments it does not take,
// or hopper::kEncodeError + the CUresult.
extern "C" int wf_wgmma_check(const void* a, const void* b, float* d, int n, int form,
                              int ksteps, void* stream) {
  const bool mn_major = form == 2 || form == 3;
  if ((n != 8 && n != 64 && n != 128) || form < 0 || form > 4 || ksteps < 1 || ksteps > 4 ||
      (n == 128 && form != 0) || ((n == 8) != (form == 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int b_rows = mn_major ? 64 : n;
  CUtensorMap am, bm;
  int err = encode_rows64(&am, a, 64, 1, 1, 64, 64 * 64, 64 * 64, 64);
  if (!err) err = encode_rows64(&bm, b, b_rows, 1, 1, 64, 64 * b_rows, 64 * b_rows, b_rows);
  if (err) return err;
  const int smem = 1024 + 64 * 64 * 2 + 128 * 64 * 2;
  cudaFuncSetAttribute(wgmma_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wgmma_check_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<const bf16*>(a), static_cast<const bf16*>(b), d, n, form, ksteps,
      form == 4 ? 0 : b_rows * 64 * 2);
  return static_cast<int>(cudaGetLastError());
}

// a (64, 64) bf16 (mode 0), a8 (64, 64) int8 (mode 1), b (n, 64) bf16, d
// (64, n) fp32, all contiguous on the card; n 8, 32, 64 or 128; mode 0 or
// 1; ksteps 1..4. Returns the launch's cudaGetLastError(),
// cudaErrorInvalidValue for arguments it does not take, or
// hopper::kEncodeError + the CUresult.
extern "C" int wf_wgmma_width_check(const void* a, const void* a8, const void* b, float* d, int n,
                                    int mode, int ksteps, void* stream) {
  if (mode < 0 || mode > 1 || ksteps < 1 || ksteps > 4) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap am, bm;
  int err = encode_rows64(&am, a, 64, 1, 1, 64, 64 * 64, 64 * 64, 64);
  if (!err) err = encode_rows64(&bm, b, n, 1, 1, 64, 64 * n, 64 * n, n);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return launch_width<8>(am, bm, a8, d, mode, ksteps, s);
    case 32: return launch_width<32>(am, bm, a8, d, mode, ksteps, s);
    case 64: return launch_width<64>(am, bm, a8, d, mode, ksteps, s);
    case 128: return launch_width<128>(am, bm, a8, d, mode, ksteps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The matmul-pair kernel's forms, d (64, 64) or (64, width) fp32 on the card.
// form 0 (SS): a (64, width) and b (width, 64) bf16, width 64, 128 or 256.
// form 1 (RS): a (64, 64) and b (64, width) bf16, width 64, 128 or 256.
// Returns the launch's cudaGetLastError(), cudaErrorInvalidValue for
// arguments it does not take, or hopper::kEncodeError + the CUresult.
extern "C" int wf_wgmma_pair_check(const void* a, const void* b, float* d, int form, int width,
                                   void* stream) {
  if ((form != 0 && form != 1) || (width != 64 && width != 128 && width != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap am, bm;
  if (form == 0) {
    int err = encode_2d(&am, a, 2, 64, width, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err) err = encode_2d(&bm, b, 2, width, 64, width, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
    const int smem = 1024 + 2 * width * 128;
    switch (width) {
      case 64: return launch_pair_check(pair_ss_check_kernel<64>, smem, s, am, bm, d);
      case 128: return launch_pair_check(pair_ss_check_kernel<128>, smem, s, am, bm, d);
      default: return launch_pair_check(pair_ss_check_kernel<256>, smem, s, am, bm, d);
    }
  }
  const int err = encode_2d(&bm, b, 2, 64, width, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const int smem = 1024 + width * 128;
  const bf16* ap = static_cast<const bf16*>(a);
  switch (width) {
    case 64: return launch_pair_check(pair_rs_check_kernel<64>, smem, s, bm, ap, d);
    case 128: return launch_pair_check(pair_rs_check_kernel<128>, smem, s, bm, ap, d);
    default: return launch_pair_check(pair_rs_check_kernel<256>, smem, s, bm, ap, d);
  }
}

// Leaves barriers whose phase 0 has completed in the static shared memory of
// every SM (32 blocks an SM), where the next kernel's barriers sit: a thread
// of that kernel that polled its barrier before the barrier was initialised
// would pass at once.
__global__ void stale_barriers_kernel() {
  __shared__ uint64_t bars[64];
  const uint32_t a = smem_u32(&bars[threadIdx.x]);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a) : "memory");
  mbar_arrive(&bars[threadIdx.x]);
}

extern "C" int wf_stale_barriers(void* stream) {
  stale_barriers_kernel<<<132 * 32, 64, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
