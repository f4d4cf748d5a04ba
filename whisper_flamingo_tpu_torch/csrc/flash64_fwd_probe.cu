// Two forward variants of the non-causal d_head-64 attention (the Whisper
// encoder's self-attention over its 1500 frames), for timing against the
// shipped forward (csrc/flash64_fwd.cu).
//
// Replaces the Pallas kernel of tools/flash64_fwd_probe.py:102 (`_call`,
// :84) in two of its three bodies:
//   - augv (`fwd_augv`, :57): the softmax row sum is not a separate sum of
//     the probabilities; it comes out of a product of P with a ones column
//     (the probe appends it to V). o and l are then sums of the same
//     rounded probabilities.
//   - csbound (`fwd_csbound_augv`, :69): the row max is replaced by the
//     Cauchy-Schwarz bound |q_i|_2 * kmax (kmax = max_j |k_j|_2 per
//     (batch, head), computed by the caller as the probe computes it
//     outside its kernel), and the row sum comes from the ones product as
//     in augv.
// The probe's third body, `fwd_shipped` (:48), is csrc/flash64_fwd.cu's
// bf16 kernel without lse. Same contract as there: q and k arrive scaled,
// the scores are fp32, the probabilities are rounded to bf16 before the V
// product, the product sums in fp32, and the output is bf16 o / l.
//
// Design for Hopper. Both variants run the shipped kernel's frame
// (csrc/flash64_fwd_frame.cuh: the TMA ring, the two consumer warpgroups
// in ping-pong on wgmma, the epilogue) with their own softmax policy, so
// that a timing against the shipped kernel measures the softmax alone:
//   - augv keeps the running max and the rescale; its row sum is a second
//     RS product, wgmma m64n8k16 on the same P fragments against an
//     all-ones 16 x 8 B in shared memory, issued with P V. Every register
//     of that accumulator holds its row's l, rescaled by alpha with o; no
//     per-thread row-sum adds and no quad sum at the end.
//   - csbound computes each row's bound once, from Q in shared memory
//     (a quad sum over the swizzled row), and per tile takes
//     e = 2^(s log2 e - bound log2 e): no max, no alpha, no rescale. Its
//     row sum is augv's product. A row whose scores all lie more than ~87
//     below its bound underflows to l = 0 and its output is 0/0: the JAX
//     math gives the same non-finite row, and this kernel matches it
//     rather than guarding it.
// What bounds it: 4*T*T*64 operations per (batch, head) against 4*T*64
// elements of traffic, so arithmetic (the ones product adds 1/8 to P V's
// tensor-core work), and at d_head 64 the exponentials as much as the
// tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash64_fwd_frame.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The row sum of the ones product: every register of the m64n8
// accumulator holds its row's l (l_acc[2r] for row g + 8r).
__device__ __forceinline__ float product_row_sum(const float (&l_acc)[4], int r) {
  return l_acc[2 * r];
}

// augv: the running max and the rescale of o and l; l from the product.
struct AugvSoftmax {
  static constexpr bool kRowSumProduct = true;
  float m[2] = {-INFINITY, -INFINITY};

  __device__ __forceinline__ void begin(const bf16*, int, int, int) {}

  __device__ __forceinline__ void tile(float (&s)[64], uint32_t (&p)[8][4], float (&o_acc)[32],
                                       float (&l_acc)[4], int live, int tq) {
    fwd_frame::mask_tile(s, live, tq);
    float alpha[2];
    fwd_frame::running_max(s, m, alpha);
    fwd_frame::exp_tile(s, p, m);
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] *= alpha[(i / 2) % 2];
#pragma unroll
    for (int i = 0; i < 4; ++i) l_acc[i] *= alpha[i / 2];
  }

  __device__ __forceinline__ float row_sum(const float (&l_acc)[4], int r) {
    return product_row_sum(l_acc, r);
  }

  __device__ __forceinline__ float shift2(int r) const { return m[r]; }
};

// csbound: a fixed shift per row, |q_i|_2 * kmax in log2 units.
struct CsboundSoftmax {
  static constexpr bool kRowSumProduct = true;
  float kmax;
  float bound[2];

  // The warpgroup's Q tile is 64 rows of 128 bytes in the 128-byte swizzle
  // (16-byte chunk c of row r at chunk c ^ (r % 8)); lane (g, tq) reads
  // chunks tq and tq + 4 of its rows 16 warp + g and + 8, and the quad sums.
  __device__ __forceinline__ void begin(const bf16* q_tile, int warp, int g, int tq) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const uint4* qr = reinterpret_cast<const uint4*>(q_tile + row * fwd_frame::D);
      float ss = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 x = qr[(tq + 4 * half) ^ (row % 8)];
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(x2[i]);
          ss = fmaf(f.x, f.x, fmaf(f.y, f.y, ss));
        }
      }
      bound[r] = sqrtf(fwd_frame::quad_sum(ss)) * kmax * hopper::kLog2e;
    }
  }

  __device__ __forceinline__ void tile(float (&s)[64], uint32_t (&p)[8][4], float (&)[32],
                                       float (&)[4], int live, int tq) {
    fwd_frame::mask_tile(s, live, tq);  // masked columns: e = 2^-inf = 0
    fwd_frame::exp_tile(s, p, bound);
  }

  __device__ __forceinline__ float row_sum(const float (&l_acc)[4], int r) {
    return product_row_sum(l_acc, r);
  }

  __device__ __forceinline__ float shift2(int r) const { return bound[r]; }
};

__global__ void __launch_bounds__(fwd_frame::FWD_THREADS, 1) flash64_fwd_augv_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int t, int64_t ost) {
  AugvSoftmax sx;
  fwd_frame::run(qmap, kmap, vmap, o, nullptr, 1, t, (int64_t)t * ost, 0, ost, sx);
}

__global__ void __launch_bounds__(fwd_frame::FWD_THREADS, 1) flash64_fwd_csbound_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ kmax,
    bf16* __restrict__ o, int t, int64_t ost) {
  CsboundSoftmax sx;
  sx.kmax = kmax[blockIdx.y];
  fwd_frame::run(qmap, kmap, vmap, o, nullptr, 1, t, (int64_t)t * ost, 0, ost, sx);
}

}  // namespace

// variant: 0 = augv, 1 = csbound (kmax required: (heads,) fp32). q/k/v/o
// are contiguous bf16 (heads, t, 64). Returns the launch's
// cudaGetLastError() (0 when the kernel was accepted), cudaErrorInvalidValue
// for arguments it does not take, or hopper::kEncodeError + the CUresult
// when a tensor map cannot be encoded.
extern "C" int wf_flash64_fwd_probe(const void* q, const void* k, const void* v,
                                    const float* kmax, void* o, int heads, int t, int variant,
                                    void* stream) {
  if (variant != 0 && (variant != 1 || kmax == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int FQ = fwd_frame::FQ, FK = fwd_frame::FK, SMEM = fwd_frame::FWD_SMEM;
  const int64_t rows = (int64_t)t * fwd_frame::D;
  CUtensorMap qm, km, vm;  // (64, t, 1, heads): one "head" per batch entry
  int err = hopper::encode_rows64(&qm, q, t, 1, heads, fwd_frame::D, rows, rows, FQ);
  if (!err) err = hopper::encode_rows64(&km, k, t, 1, heads, fwd_frame::D, rows, rows, FK);
  if (!err) err = hopper::encode_rows64(&vm, v, t, 1, heads, fwd_frame::D, rows, rows, FK);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((t + FQ - 1) / FQ, heads);
  bf16* ob = static_cast<bf16*>(o);
  if (variant == 0) {
    cudaFuncSetAttribute(flash64_fwd_augv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM);
    flash64_fwd_augv_kernel<<<grid, fwd_frame::FWD_THREADS, SMEM, s>>>(qm, km, vm, ob, t,
                                                                       fwd_frame::D);
  } else {
    cudaFuncSetAttribute(flash64_fwd_csbound_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    flash64_fwd_csbound_kernel<<<grid, fwd_frame::FWD_THREADS, SMEM, s>>>(qm, km, vm, kmax, ob,
                                                                          t, fwd_frame::D);
  }
  return static_cast<int>(cudaGetLastError());
}
