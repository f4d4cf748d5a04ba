// Non-causal attention forward at d_head 64: the Whisper encoder's
// self-attention over its 1500 audio frames.
//
// Replaces the Pallas kernel whisper_flamingo_tpu/ops/flash64.py:75
// `_fwd_kernel` (reached through `_flash64_forward`, :149). Same contract:
// q and k arrive pre-scaled by d_head^-0.25, there is no mask beyond the
// real length, the softmax is fp32, the probabilities are rounded to the
// input dtype before the V product, the V sum is fp32, and the output has
// the input dtype.
//
// With a non-null `lse` the kernel also writes the fp32 row logsumexp
// m + log(l) (the residual of `_fwd_kernel`'s `lse_ref`, :92-93) into a
// (B*H, T) array for the backward kernels (csrc/flash64_bwd.cu); l is the
// fp32 row sum of the unrounded probabilities (the TPU kernel's ones-column
// sum was a TPU workaround). A null `lse` is inference: nothing more is
// written, as the JAX primal `_flash64` (:141-146) skips the residual.
//
// Design for Hopper. The TPU kernel kept all of K and V resident in VMEM
// (T padded to 1536: 384 KB in bf16), which does not fit the 227 KB of
// shared memory a block may use. Here K/V stream through shared memory
// with an online softmax (running max and sum, fp32 accumulator), so
// nothing is padded: key columns at or past T are masked in the kernel and
// query rows past T are not written.
//
// What bounds it: the work is 4*T*T*64 flops per (batch, head) against
// 4*T*64 elements of traffic, so it is bound by arithmetic, and at d_head
// 64 the exponentials are as scarce as the tensor cores: one ex2 per 256
// product flops, about what the SMs' special-function units issue at the
// bf16 peak.
//   - bf16 (the frame of csrc/flash64_fwd_frame.cuh, on csrc/hopper.cuh,
//     with the online softmax as its policy): a block takes 128 query rows with three
//     warpgroups. The producer warpgroup (registers cut to 24 with
//     setmaxnreg) has one thread issue TMA loads: Q once, then K and V in
//     128-key tiles into a 4-stage shared-memory ring under mbarriers
//     (full: the bytes arrived; empty: both consumers are done). Each of
//     the two consumer warpgroups (registers raised to 240) owns 64 rows:
//     S = Q K^T is wgmma m64n128k16 from shared memory (Q, K K-major in
//     the 128-byte swizzle), the online softmax runs in registers (ex2
//     with log2 e folded into one FMA, a per-thread partial row sum reduced
//     across the quad once at the end), P turns from accumulator into bf16
//     A fragments in registers, and O += P V is wgmma m64n64k16 with A
//     from registers and V read from its TMA tile as an MN-major B (no
//     transposed copy). The exponentials overlap the products by
//     ping-pong: named barriers let one warpgroup issue its products while
//     the other runs its softmax. (The other schedule tried, each
//     warpgroup running the softmax of tile j under its own P V of tile
//     j - 1, measured slower on the H100; PERF.md.)
//   - fp32: the contract forbids TF32, so the products are fp32 FMA
//     against the card's 67 TFLOP/s rate: one thread owns one query row
//     (q and the accumulator in registers), and the block's threads read
//     each K/V element of the tile at the same time (a broadcast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash64_fwd_frame.cuh"

namespace {

constexpr int D = 64;    // head width
constexpr int BQ = 64;   // query rows per block, one per thread
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int SUB = 16;  // keys per online-softmax update

// ---------------------------------------------------------------------------
// fp32 with FMA
// ---------------------------------------------------------------------------

// q/k/v/o are addressed as base + b*sb + h*sh + t*st + c (c < 64), so both
// a contiguous (B, H, T, 64) tensor and the head-split view of a (B, T, D)
// projection are taken without a copy.
__global__ void __launch_bounds__(BQ) flash64_fwd_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int n_head, int t, int64_t sb,
    int64_t sh, int64_t st, int64_t osb, int64_t osh, int64_t ost) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int b = blockIdx.y / n_head, h = blockIdx.y % n_head;
  const int64_t base = b * sb + h * sh;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool live = row < t;

  float qr[D], acc[D];
  const float* qrow = q + base + (int64_t)row * st;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = live ? qrow[c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < t; k0 += BK) {
    const int nk = min(BK, t - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < BK * D; i += BQ) {
      const int r = i / D, c = i % D;
      const bool ok = r < nk;
      const int64_t at = base + (int64_t)(k0 + r) * st + c;
      ks[r][c] = ok ? k[at] : 0.f;
      vs[r][c] = ok ? v[at] : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += SUB) {
      float s[SUB];
      float mt = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks[j0 + jj]);
        float a = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 kv = kr[c4];
          a = fmaf(qr[4 * c4 + 0], kv.x, a);
          a = fmaf(qr[4 * c4 + 1], kv.y, a);
          a = fmaf(qr[4 * c4 + 2], kv.z, a);
          a = fmaf(qr[4 * c4 + 3], kv.w, a);
        }
        s[jj] = (j0 + jj < nk) ? a : -INFINITY;  // ragged edge: masked
        mt = fmaxf(mt, s[jj]);
      }
      // mt is finite: key j0 < nk is always real
      const float alpha = expf(m - mt);  // 0 on the first update
      l *= alpha;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = expf(s[jj] - mt);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs[j0 + jj]);
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 vv = vr[c4];
          acc[4 * c4 + 0] = fmaf(p, vv.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(p, vv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(p, vv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(p, vv.w, acc[4 * c4 + 3]);
        }
      }
      m = mt;
    }
  }

  if (live) {
    float* orow = o + b * osb + h * osh + (int64_t)row * ost;
#pragma unroll
    for (int c = 0; c < D; ++c) orow[c] = acc[c] / l;
    if (lse != nullptr) lse[(int64_t)blockIdx.y * t + row] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma, fed by TMA: the frame of csrc/flash64_fwd_frame.cuh with
// the online softmax
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Running max and sum for the thread's two rows: per tile the max in log2
// units, ex2 with log2 e folded into one FMA, a per-thread partial row sum
// reduced across the quad once at the end, and the rescale of the
// accumulator by alpha = exp(m_old - m_new).
struct OnlineSoftmax {
  static constexpr bool kRowSumProduct = false;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  __device__ __forceinline__ void begin(const bf16*, int, int, int) {}

  __device__ __forceinline__ void tile(float (&s)[64], uint32_t (&p)[8][4], float (&o_acc)[32],
                                       float (&)[4], int live, int tq) {
    fwd_frame::mask_tile(s, live, tq);
    float alpha[2];
    fwd_frame::running_max(s, m, alpha);
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = hopper::ex2(fmaf(s[4 * n + i], hopper::kLog2e, -m[i / 2]));
      lsum[0] += e[0] + e[1];
      lsum[1] += e[2] + e[3];
      p[n / 2][(n % 2) * 2 + 0] = hopper::pack_bf16(e[0], e[1]);
      p[n / 2][(n % 2) * 2 + 1] = hopper::pack_bf16(e[2], e[3]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] *= alpha[(i / 2) % 2];
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + lsum[r];
  }

  __device__ __forceinline__ float row_sum(const float (&)[4], int r) {
    return fwd_frame::quad_sum(l[r]);
  }

  __device__ __forceinline__ float shift2(int r) const { return m[r]; }
};

__global__ void __launch_bounds__(fwd_frame::FWD_THREADS, 1) flash64_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, float* __restrict__ lse,
    int n_head, int t, int64_t osb, int64_t osh, int64_t ost) {
  OnlineSoftmax sx;
  fwd_frame::run(qmap, kmap, vmap, o, lse, n_head, t, osb, osh, ost, sx);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `lse` is a
// contiguous fp32 (batch*n_head, t) array or null. Returns the launch's
// cudaGetLastError() (0 when the kernel was accepted), or for bf16
// hopper::kEncodeError + the CUresult when a tensor map cannot be encoded.
extern "C" int wf_flash64_fwd(const void* q, const void* k, const void* v, void* o,
                              float* lse, int batch, int n_head, int t, int64_t sb, int64_t sh,
                              int64_t st, int64_t osb, int64_t osh, int64_t ost,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((t + BQ - 1) / BQ, batch * n_head);
    flash64_fwd_fma_kernel<<<grid, BQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, n_head, t, sb, sh, st,
        osb, osh, ost);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int FQ = fwd_frame::FQ, FK = fwd_frame::FK, SMEM = fwd_frame::FWD_SMEM;
  CUtensorMap qm, km, vm;
  int err = hopper::encode_rows64(&qm, q, t, n_head, batch, st, sh, sb, FQ);
  if (!err) err = hopper::encode_rows64(&km, k, t, n_head, batch, st, sh, sb, FK);
  if (!err) err = hopper::encode_rows64(&vm, v, t, n_head, batch, st, sh, sb, FK);
  if (err) return err;
  cudaFuncSetAttribute(flash64_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM);
  const dim3 grid((t + FQ - 1) / FQ, batch * n_head);
  flash64_fwd_wgmma_kernel<<<grid, fwd_frame::FWD_THREADS, SMEM, s>>>(
      qm, km, vm, static_cast<bf16*>(o), lse, n_head, t, osb, osh, ost);
  return static_cast<int>(cudaGetLastError());
}
