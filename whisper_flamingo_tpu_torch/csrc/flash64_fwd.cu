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
//   - bf16 (csrc/hopper.cuh): a block takes 128 query rows with three
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

#include "hopper.cuh"

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
// bf16 on wgmma, fed by TMA
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int FQ = 128;           // query rows per block: two consumer warpgroups of 64
constexpr int FK = 128;           // keys per ring tile
constexpr int FSTAGES = 4;        // ring depth
constexpr int FWD_THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr float kLn2 = 0.6931471805599453f;

struct __align__(1024) FwdSmem {
  bf16 q[FQ * D];           // warpgroup w's 64 rows at w * 64 * D
  bf16 k[FSTAGES][FK * D];  // [key][dim], 128-byte swizzle
  bf16 v[FSTAGES][FK * D];
  uint64_t q_full;
  uint64_t full[FSTAGES];
  uint64_t empty[FSTAGES];
};
constexpr int FWD_SMEM = (int)sizeof(FwdSmem) + 1024;  // + slack to align the base

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One tile of the online softmax on this thread's two rows (r = 0: row g,
// r = 1: row g + 8) of a 64 x 128 score tile in the accumulator layout
// (s[4n + 2r + c] is column 8n + 2tq + c). Columns at or past `live` are
// masked. m is the running max in log2 units; alpha is exp(m_old - m_new)
// for the old sums, lsum this tile's partial row sums, p the rounded
// probabilities as the A fragments of the next P V (k-step n / 2).
__device__ __forceinline__ void softmax_tile(float (&s)[64], uint32_t (&p)[8][4], float (&m)[2],
                                             float (&alpha)[2], float (&lsum)[2], int live,
                                             int tq) {
  if (live < FK) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (8 * n + 2 * tq + c >= live) s[4 * n + c] = s[4 * n + 2 + c] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // column 0 of a tile is always a real key, so the new max is finite
    const float mn = fmaxf(m[r], quad_max(mx[r]) * kLog2e);
    alpha[r] = ex2(m[r] - mn);  // 0 on the first tile
    m[r] = mn;
    lsum[r] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = ex2(fmaf(s[4 * n + i], kLog2e, -m[i / 2]));
    lsum[0] += e[0] + e[1];
    lsum[1] += e[2] + e[3];
    p[n / 2][(n % 2) * 2 + 0] = pack_bf16(e[0], e[1]);
    p[n / 2][(n % 2) * 2 + 1] = pack_bf16(e[2], e[3]);
  }
}

// grid (ceil(T / 128), B * H); q/k/v through the tensor maps (rows of
// (b, h) at coordinates {0, row, h, b}), o addressed as
// base + b*osb + h*osh + row*ost + c.
__global__ void __launch_bounds__(FWD_THREADS, 1) flash64_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, float* __restrict__ lse,
    int n_head, int t, int64_t osb, int64_t osh, int64_t ost) {
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(align1024(smem_raw));
  const int b = blockIdx.y / n_head, h = blockIdx.y % n_head;
  const int q0 = blockIdx.x * FQ;
  const int n_tiles = (t + FK - 1) / FK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < FSTAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(&sm.q_full, FQ * D * 2);
      tma_load_4d(sm.q, &qmap, &sm.q_full, 0, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int cs = j % FSTAGES;
        mbar_wait(&sm.empty[cs], ((j / FSTAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[cs], 2 * FK * D * 2);
        tma_load_4d(sm.k[cs], &kmap, &sm.full[cs], 0, j * FK, h, b);
        tma_load_4d(sm.v[cs], &vmap, &sm.full[cs], 0, j * FK, h, b);
      }
    }
  } else {  // consumers
    setmaxnreg_inc<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, tq = lane % 4;
    const uint64_t qd = desc_k_major(sm.q + wg * 64 * D);
    float o_acc[32], s[64];
    uint32_t p[8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0u;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(&sm.q_full, 0);
    if (wg == 1) named_bar_arrive(1, 256);  // warpgroup 0 issues first
    // Step j issues S of tile j (j < n_tiles) and P V of tile j - 1 (j > 0).
    for (int j = 0; j <= n_tiles; ++j) {
      const bool has_s = j < n_tiles, has_pv = j > 0;
      const int cs = j % FSTAGES, ps = (j + FSTAGES - 1) % FSTAGES;
      if (has_s) mbar_wait(&sm.full[cs], (j / FSTAGES) & 1);
      named_bar_sync(1 + wg, 256);  // this warpgroup's turn on the tensor cores
      fence_regs(o_acc);
      fence_regs(s);
      fence_regs(p);
      wgmma_fence();
      if (has_s) {
        const uint64_t kd = desc_k_major(sm.k[cs]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128<0>(s, qd + 2 * kk, kd + 2 * kk, kk > 0);
        wgmma_commit();
      }
      if (has_pv) {
        const uint64_t vd = desc_mn_major(sm.v[ps]);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wgmma_rs_n64<1>(o_acc, p[kk], vd + 128 * kk, 1);
        wgmma_commit();
      }
      named_bar_arrive(1 + (wg ^ 1), 256);  // the other warpgroup's turn
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(p);
      if (has_pv && lane == 0) mbar_arrive(&sm.empty[ps]);
      if (has_s) {
        fence_regs(s);
        float alpha[2], lsum[2];
        uint32_t pn[8][4];
        softmax_tile(s, pn, m, alpha, lsum, t - j * FK, tq);
#pragma unroll
        for (int i = 0; i < 32; ++i) o_acc[i] *= alpha[(i / 2) % 2];
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + lsum[r];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[i][e] = pn[i][e];
      }
    }
    if (wg == 0) named_bar_sync(1, 256);  // warpgroup 1's last arrival

    const int row0 = q0 + wg * 64 + warp * 16 + g;
    const float lq[2] = {quad_sum(l[0]), quad_sum(l[1])};  // the whole warp shuffles
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= t) continue;
      const float lr = lq[r];
      bf16* orow = o + b * osb + h * osh + (int64_t)row * ost + 2 * tq;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(o_acc[4 * n + 2 * r] / lr, o_acc[4 * n + 2 * r + 1] / lr);
      if (lse != nullptr && tq == 0) lse[(int64_t)blockIdx.y * t + row] = m[r] * kLn2 + logf(lr);
    }
  }
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
  CUtensorMap qm, km, vm;
  int err = encode_rows64(&qm, q, t, n_head, batch, st, sh, sb, FQ);
  if (!err) err = encode_rows64(&km, k, t, n_head, batch, st, sh, sb, FK);
  if (!err) err = encode_rows64(&vm, v, t, n_head, batch, st, sh, sb, FK);
  if (err) return err;
  cudaFuncSetAttribute(flash64_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       FWD_SMEM);
  const dim3 grid((t + FQ - 1) / FQ, batch * n_head);
  flash64_fwd_wgmma_kernel<<<grid, FWD_THREADS, FWD_SMEM, s>>>(
      qm, km, vm, static_cast<bf16*>(o), lse, n_head, t, osb, osh, ost);
  return static_cast<int>(cudaGetLastError());
}
