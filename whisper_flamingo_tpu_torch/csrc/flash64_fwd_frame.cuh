// The frame of the bf16 non-causal d_head-64 attention forward on Hopper:
// a producer warpgroup with its TMA ring, two consumer warpgroups in
// ping-pong on wgmma, and the epilogue. The consumer's per-tile softmax
// step is a compile-time policy, so the shipped forward
// (csrc/flash64_fwd.cu) and the probe's variants (csrc/flash64_fwd_probe.cu)
// run the same frame and differ only in their softmax: a timing of one
// against another measures the softmax alone.
//
// The frame (one block = 128 query rows, 384 threads):
//   - warpgroup 2 (registers cut to 24 by setmaxnreg) has one thread issue
//     TMA loads: Q once, then K and V in 128-key tiles into a 4-stage
//     shared-memory ring under mbarriers (full: the bytes arrived; empty:
//     both consumers are done);
//   - warpgroups 0 and 1 (registers raised to 240) own 64 rows each: S = Q
//     K^T is wgmma m64n128k16 from shared memory (Q, K K-major in the
//     128-byte swizzle), the policy turns S into the bf16 A fragments P in
//     registers, and O += P V is wgmma m64n64k16 with A from registers and
//     V read from its TMA tile as an MN-major B. Named barriers pass the
//     tensor cores between the two warpgroups once per step, so one
//     issues its products while the other runs its softmax;
//   - with Softmax::kRowSumProduct the row sum also comes off the tensor
//     cores: l += P 1 is wgmma m64n8k16 on the same A fragments against an
//     all-ones 16 x 8 tile in shared memory (no swizzle), in the same
//     commit group as P V. Every register of the m64n8 accumulator then
//     holds its row's l, and nothing is shuffled.
//
// A policy holds a thread's state for its two rows (r = 0: row g, r = 1:
// row g + 8 of its warp's 16) and provides
//   static constexpr bool kRowSumProduct;
//   begin(q_tile, warp, g, tq)  once Q is in shared memory (the
//                               warpgroup's 64 x 64 tile, 128-byte swizzle);
//   tile(s, p, o_acc, l_acc, live, tq)
//                               scores of one 64 x 128 tile (accumulator
//                               layout, columns at or past `live` masked)
//                               -> the rounded probabilities p, and any
//                               rescale of o_acc (and l_acc);
//   row_sum(l_acc, r)           the row's l, called by the whole warp;
//   shift2(r)                   the row's exponent shift in log2 units
//                               (the lse is shift2 * ln 2 + log l).

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace fwd_frame {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int D = 64;             // head width
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
  // the all-ones B of the row-sum product: 16 keys x 8 columns, two 8 x 8
  // core matrices of 128 bytes (no swizzle); written only by the policies
  // that use it, inside the struct's alignment padding
  __align__(128) bf16 ones[16 * 8];
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

// Columns at or past `live` of a 64 x 128 score tile (s[4n + 2r + c] is
// column 8n + 2tq + c) set to -inf.
__device__ __forceinline__ void mask_tile(float (&s)[64], int live, int tq) {
  if (live < FK) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (8 * n + 2 * tq + c >= live) s[4 * n + c] = s[4 * n + 2 + c] = -INFINITY;
  }
}

// The running max in log2 units over one more tile: m is updated and
// alpha = exp(m_old - m_new) returned for the old sums (0 on the first tile).
__device__ __forceinline__ void running_max(const float (&s)[64], float (&m)[2],
                                            float (&alpha)[2]) {
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
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
}

// e = 2^(s log2 e - shift) for every score, rounded to bf16 pairs as the A
// fragments of the next P V (k-step n / 2).
__device__ __forceinline__ void exp_tile(const float (&s)[64], uint32_t (&p)[8][4],
                                         const float (&shift)[2]) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = ex2(fmaf(s[4 * n + i], kLog2e, -shift[i / 2]));
    p[n / 2][(n % 2) * 2 + 0] = pack_bf16(e[0], e[1]);
    p[n / 2][(n % 2) * 2 + 1] = pack_bf16(e[2], e[3]);
  }
}

// The frame, from a kernel's body. grid (ceil(T / 128), B * H); q/k/v
// through the tensor maps (rows of (b, h) at coordinates {0, row, h, b}),
// o addressed as base + b*osb + h*osh + row*ost + c; `lse` a contiguous
// fp32 (B*H, T) array or null. `sx` is the policy of this thread.
template <class Softmax>
__device__ __forceinline__ void run(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                    const CUtensorMap& vmap, bf16* __restrict__ o,
                                    float* __restrict__ lse, int n_head, int t, int64_t osb,
                                    int64_t osh, int64_t ost, Softmax& sx) {
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
  if constexpr (Softmax::kRowSumProduct) {
    if (threadIdx.x < 64) {  // bf16 1.0 in all 256 bytes, for the async proxy
      reinterpret_cast<uint32_t*>(sm.ones)[threadIdx.x] = 0x3F803F80u;
      fence_proxy_async();
    }
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
    // the ones tile: LBO 128 (the second 8-key core matrix), SBO unused at N 8
    const uint64_t ones_d = desc_plain(sm.ones, 128, 256);
    float o_acc[32], s[64], l_acc[4];
    uint32_t p[8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) l_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0u;

    mbar_wait(&sm.q_full, 0);
    sx.begin(sm.q + wg * 64 * D, warp, g, tq);
    if (wg == 1) named_bar_arrive(1, 256);  // warpgroup 0 issues first
    // Step j issues S of tile j (j < n_tiles) and P V of tile j - 1 (j > 0).
    for (int j = 0; j <= n_tiles; ++j) {
      const bool has_s = j < n_tiles, has_pv = j > 0;
      const int cs = j % FSTAGES, ps = (j + FSTAGES - 1) % FSTAGES;
      if (has_s) mbar_wait(&sm.full[cs], (j / FSTAGES) & 1);
      named_bar_sync(1 + wg, 256);  // this warpgroup's turn on the tensor cores
      fence_regs(o_acc);
      if constexpr (Softmax::kRowSumProduct) fence_regs(l_acc);
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
        if constexpr (Softmax::kRowSumProduct) {
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) wgmma_rs_n8(l_acc, p[kk], ones_d, 1);
        }
        wgmma_commit();
      }
      named_bar_arrive(1 + (wg ^ 1), 256);  // the other warpgroup's turn
      wgmma_wait<0>();
      fence_regs(o_acc);
      if constexpr (Softmax::kRowSumProduct) fence_regs(l_acc);
      fence_regs(p);
      if (has_pv && lane == 0) mbar_arrive(&sm.empty[ps]);
      if (has_s) {
        fence_regs(s);
        uint32_t pn[8][4];
        sx.tile(s, pn, o_acc, l_acc, t - j * FK, tq);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[i][e] = pn[i][e];
      }
    }
    if (wg == 0) named_bar_sync(1, 256);  // warpgroup 1's last arrival

    const int row0 = q0 + wg * 64 + warp * 16 + g;
    const float lq[2] = {sx.row_sum(l_acc, 0), sx.row_sum(l_acc, 1)};  // the whole warp
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
      if (lse != nullptr && tq == 0)
        lse[(int64_t)blockIdx.y * t + row] = sx.shift2(r) * kLn2 + logf(lr);
    }
  }
}

}  // namespace fwd_frame
