// One wgmma product of each form that the flash64 kernels use, for the
// card-only tests (tests/test_torch_cuda.py hold it against torch.matmul):
// a single warpgroup loads A (64 x 64) and B by TMA in the 128-byte swizzle,
// as the kernels do, issues `ksteps` k16 products and writes the fp32
// accumulator out through the layout csrc/hopper.cuh states. It checks the
// descriptors (K-major and MN-major), the k-slice advances, the RS form's
// A-fragment layout and the accumulator layout; it is on no system path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// form 0: SS, B K-major; 1: RS, B K-major; 2: RS, B MN-major; 3: SS, B
// MN-major. a is (64, 64) [m][k]; b is (n, 64) [n][k] for K-major and
// (64, 64) [k][n] for MN-major; d is (64, n) fp32.
__global__ void __launch_bounds__(128) wgmma_check_kernel(const __grid_constant__ CUtensorMap amap,
                                                          const __grid_constant__ CUtensorMap bmap,
                                                          const bf16* __restrict__ a,
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
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 64 * 64 * 2 + b_bytes);
    tma_load_4d(as, &amap, &bar, 0, 0, 0, 0);
    tma_load_4d(bs, &bmap, &bar, 0, 0, 0, 0);
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
  float acc64[32], acc128[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc64[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc128[i] = 0.f;

  const uint64_t ad = desc_k_major(as), bk = desc_k_major(bs), bm = desc_mn_major(bs);
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
    } else {
      wgmma_ss_n64<1>(acc64, ad + 2 * kk, bm + 128 * kk, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
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
        const float x = n == 128 ? acc128[4 * j + 2 * r + c] : acc64[(4 * j + 2 * r + c) % 32];
        d[(r0 + 8 * r) * n + col] = x;
      }
}

}  // namespace

// a, b, d contiguous on the card (see the kernel); n 64 or 128 (128 only
// with form 0, MN-major forms only at 64); ksteps 1..4. Returns the launch's
// cudaGetLastError(), cudaErrorInvalidValue for arguments it does not take,
// or hopper::kEncodeError + the CUresult.
extern "C" int wf_wgmma_check(const void* a, const void* b, float* d, int n, int form,
                              int ksteps, void* stream) {
  const bool mn_major = form == 2 || form == 3;
  if ((n != 64 && n != 128) || form < 0 || form > 3 || ksteps < 1 || ksteps > 4 ||
      (n == 128 && form != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int b_rows = mn_major ? 64 : n;
  CUtensorMap am, bm;
  int err = encode_rows64(&am, a, 64, 1, 1, 64, 64 * 64, 64 * 64, 64);
  if (!err) err = encode_rows64(&bm, b, b_rows, 1, 1, 64, 64 * b_rows, 64 * b_rows, b_rows);
  if (err) return err;
  const int smem = 1024 + 64 * 64 * 2 + 128 * 64 * 2;
  cudaFuncSetAttribute(wgmma_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wgmma_check_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<const bf16*>(a), d, n, form, ksteps, b_rows * 64 * 2);
  return static_cast<int>(cudaGetLastError());
}
