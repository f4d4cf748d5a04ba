// Backward of the non-causal d_head-64 attention: the Whisper encoder's
// self-attention over its 1500 audio frames, when the encoder trains.
//
// Replaces the Pallas kernel whisper_flamingo_tpu/ops/flash64.py:100
// `_bwd_kernel` (reached through `_flash64_bwd_rule`, :194, with the XLA
// pass for D at :202). Same function and roundings:
//   dO is cast to the input dtype; D = sum_d dO*O in fp32 over the stored
//   output; P = exp(S - lse) in fp32 from the forward's fp32 row
//   logsumexp; dP = dO V^T and dS = P (dP - D) in fp32; dS and P are
//   rounded to the input dtype before the three products; dQ = dS K,
//   dK = dS^T Q and dV = P^T dO sum in fp32 and are cast to the input dtype.
//
// Design for Hopper. The TPU kernel kept all of K and V resident in VMEM
// (T padded to 1536: 384 KB in bf16, more than the 227 KB of shared memory
// a block may use) and carried the dK/dV accumulator across a sequential
// grid of 512-row q tiles. On the card blocks run in no order, so the work
// splits into three launches, none with atomics (every output element is
// summed by one thread in a fixed order, so two runs give the same bits):
//   1. a row pass computes D (B*H*T dot products of 64);
//   2. the dK/dV kernel: one block per (b*h, key tile); it loops over the
//      q tiles, recomputes S^T and dP^T for its keys and keeps dK and dV
//      in fp32 registers;
//   3. the dQ kernel: one block per (b*h, query tile); it loops over the
//      key tiles, recomputes S and dP and keeps dQ in fp32 registers.
// S and dP are computed twice (once in each kernel): 7 products of
// 2*T*T*64 in all, against the 5 the backward needs.
// Nothing is padded: query rows and key columns at or past T are masked in
// the kernels (P = dS = 0 there) and not written.
//
// What bounds it: 5 products of 2*T*T*64 operations per (batch, head)
// against ~10*T*64 elements of traffic, so it is bound by arithmetic.
//   - bf16 (csrc/hopper.cuh): each kernel's block owns 128 rows (keys in
//     dK/dV, queries in dQ) with three warpgroups. The producer warpgroup
//     (24 registers, setmaxnreg) has one thread issue TMA loads: the
//     block's own 128 rows once, then the other side in 64-row tiles into
//     a 4-stage shared-memory ring under mbarriers (dK/dV: Q and dO, with
//     the lse and D values of those queries copied in by the producer
//     warp's lanes; dQ: K and V). Each consumer
//     warpgroup (240 registers) owns 64 rows and runs every product on
//     wgmma m64n64k16: in dK/dV, S^T = K Q^T and dP^T = V dO^T from shared
//     memory (all K-major), then P^T = exp(S^T - lse) and
//     dS^T = P^T (dP^T - D) in registers, rounded to bf16 as A fragments,
//     and dV += P^T dO, dK += dS^T Q with A from registers and dO, Q read
//     from their TMA tiles as MN-major B; in dQ, S = Q K^T and dP = dO V^T
//     from shared memory, dS in registers, dQ += dS K with K as an
//     MN-major B. The two consumer warpgroups of a block share every
//     streamed tile, and one's exponentials run while the other's products
//     do.
//   - fp32: the contract forbids TF32, so the products are fp32 FMA against
//     the card's 67 TFLOP/s rate: two threads share a row (32 dims each,
//     the dot products joined by one shuffle), the other operand's rows
//     are read from shared memory as a broadcast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;     // head width
constexpr int TILE = 64;  // rows per block and per shared-memory tile
constexpr int HALF = 32;  // dims per thread in the fp32 kernels
constexpr int THREADS = 128;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO * O), fp32
// ---------------------------------------------------------------------------

// 16 threads per row, 4 dims each; rows are (b*h, i) in order.
template <typename T>
__global__ void __launch_bounds__(256) rowdot_kernel(
    const T* __restrict__ o, const T* __restrict__ g, float* __restrict__ drow, int n_head,
    int t, int64_t rows, int64_t osb, int64_t osh, int64_t ost, int64_t gsb, int64_t gsh,
    int64_t gst) {
  const int64_t row = (int64_t)blockIdx.x * 16 + threadIdx.x / 16;
  const int c0 = (threadIdx.x % 16) * 4;
  float acc = 0.f;
  if (row < rows) {
    const int64_t bh = row / t, i = row % t;
    const int b = (int)(bh / n_head), h = (int)(bh % n_head);
    const T* orow = o + b * osb + h * osh + i * ost + c0;
    const T* grow = g + b * gsb + h * gsh + i * gst + c0;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc = fmaf(to_f(grow[c]), to_f(orow[c]), acc);
  }
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && threadIdx.x % 16 == 0) drow[row] = acc;
}

// ---------------------------------------------------------------------------
// fp32 with FMA
// ---------------------------------------------------------------------------

// q/k/v are addressed as base + b*sb + h*sh + t*st + c (c < 64), and so are
// o, dO and the gradients with their own strides; lse and D are contiguous
// (B*H, T). Thread (row r, half hf) of a block holds dims hf*32.. of row r.

__global__ void __launch_bounds__(THREADS) dkdv_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ drow,
    float* __restrict__ dk, float* __restrict__ dv, int n_head, int t, int64_t sb, int64_t sh,
    int64_t st, int64_t gsb, int64_t gsh, int64_t gst, int64_t xsb, int64_t xsh, int64_t xst) {
  __shared__ __align__(16) float qs[TILE][D];
  __shared__ __align__(16) float gs[TILE][D];
  __shared__ float ls[TILE], ds_[TILE];

  const int b = blockIdx.y / n_head, h = blockIdx.y % n_head;
  const int64_t base = b * sb + h * sh, gbase = b * gsb + h * gsh;
  const float* lrow = lse + (int64_t)blockIdx.y * t;
  const float* drw = drow + (int64_t)blockIdx.y * t;
  const int key = blockIdx.x * TILE + threadIdx.x / 2, hf = (threadIdx.x % 2) * HALF;
  const bool live = key < t;

  float kr[HALF], vr[HALF], dka[HALF], dva[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    const int64_t at = base + (int64_t)key * st + hf + c;
    kr[c] = live ? k[at] : 0.f;
    vr[c] = live ? v[at] : 0.f;
    dka[c] = dva[c] = 0.f;
  }

  for (int q0 = 0; q0 < t; q0 += TILE) {
    const int nq = min(TILE, t - q0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = r < nq;
      qs[r][c] = ok ? q[base + (int64_t)(q0 + r) * st + c] : 0.f;
      gs[r][c] = ok ? g[gbase + (int64_t)(q0 + r) * gst + c] : 0.f;
    }
    if (threadIdx.x < TILE) {
      const bool ok = threadIdx.x < nq;
      ls[threadIdx.x] = ok ? lrow[q0 + threadIdx.x] : 0.f;
      ds_[threadIdx.x] = ok ? drw[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    for (int i = 0; i < nq; ++i) {
      const float4* qr = reinterpret_cast<const float4*>(&qs[i][hf]);
      const float4* gr = reinterpret_cast<const float4*>(&gs[i][hf]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < HALF / 4; ++c4) {
        const float4 qv = qr[c4], gv = gr[c4];
        s = fmaf(kr[4 * c4 + 0], qv.x, s);
        s = fmaf(kr[4 * c4 + 1], qv.y, s);
        s = fmaf(kr[4 * c4 + 2], qv.z, s);
        s = fmaf(kr[4 * c4 + 3], qv.w, s);
        dp = fmaf(vr[4 * c4 + 0], gv.x, dp);
        dp = fmaf(vr[4 * c4 + 1], gv.y, dp);
        dp = fmaf(vr[4 * c4 + 2], gv.z, dp);
        dp = fmaf(vr[4 * c4 + 3], gv.w, dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = expf(s - ls[i]);
      const float ds = p * (dp - ds_[i]);
#pragma unroll
      for (int c4 = 0; c4 < HALF / 4; ++c4) {
        const float4 qv = qr[c4], gv = gr[c4];
        dva[4 * c4 + 0] = fmaf(p, gv.x, dva[4 * c4 + 0]);
        dva[4 * c4 + 1] = fmaf(p, gv.y, dva[4 * c4 + 1]);
        dva[4 * c4 + 2] = fmaf(p, gv.z, dva[4 * c4 + 2]);
        dva[4 * c4 + 3] = fmaf(p, gv.w, dva[4 * c4 + 3]);
        dka[4 * c4 + 0] = fmaf(ds, qv.x, dka[4 * c4 + 0]);
        dka[4 * c4 + 1] = fmaf(ds, qv.y, dka[4 * c4 + 1]);
        dka[4 * c4 + 2] = fmaf(ds, qv.z, dka[4 * c4 + 2]);
        dka[4 * c4 + 3] = fmaf(ds, qv.w, dka[4 * c4 + 3]);
      }
    }
  }

  if (live) {
    const int64_t at = b * xsb + h * xsh + (int64_t)key * xst + hf;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      dk[at + c] = dka[c];
      dv[at + c] = dva[c];
    }
  }
}

__global__ void __launch_bounds__(THREADS) dq_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ drow,
    float* __restrict__ dq, int n_head, int t, int64_t sb, int64_t sh, int64_t st, int64_t gsb,
    int64_t gsh, int64_t gst, int64_t xsb, int64_t xsh, int64_t xst) {
  __shared__ __align__(16) float ks[TILE][D];
  __shared__ __align__(16) float vs[TILE][D];

  const int b = blockIdx.y / n_head, h = blockIdx.y % n_head;
  const int64_t base = b * sb + h * sh, gbase = b * gsb + h * gsh;
  const int row = blockIdx.x * TILE + threadIdx.x / 2, hf = (threadIdx.x % 2) * HALF;
  const bool live = row < t;
  const float lrow = live ? lse[(int64_t)blockIdx.y * t + row] : 0.f;
  const float drw = live ? drow[(int64_t)blockIdx.y * t + row] : 0.f;

  float qr[HALF], gr[HALF], acc[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    qr[c] = live ? q[base + (int64_t)row * st + hf + c] : 0.f;
    gr[c] = live ? g[gbase + (int64_t)row * gst + hf + c] : 0.f;
    acc[c] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += TILE) {
    const int nk = min(TILE, t - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = r < nk;
      const int64_t at = base + (int64_t)(k0 + r) * st + c;
      ks[r][c] = ok ? k[at] : 0.f;
      vs[r][c] = ok ? v[at] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][hf]);
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][hf]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < HALF / 4; ++c4) {
        const float4 kv = kr[c4], vv = vr[c4];
        s = fmaf(qr[4 * c4 + 0], kv.x, s);
        s = fmaf(qr[4 * c4 + 1], kv.y, s);
        s = fmaf(qr[4 * c4 + 2], kv.z, s);
        s = fmaf(qr[4 * c4 + 3], kv.w, s);
        dp = fmaf(gr[4 * c4 + 0], vv.x, dp);
        dp = fmaf(gr[4 * c4 + 1], vv.y, dp);
        dp = fmaf(gr[4 * c4 + 2], vv.z, dp);
        dp = fmaf(gr[4 * c4 + 3], vv.w, dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float ds = expf(s - lrow) * (dp - drw);
#pragma unroll
      for (int c4 = 0; c4 < HALF / 4; ++c4) {
        const float4 kv = kr[c4];
        acc[4 * c4 + 0] = fmaf(ds, kv.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(ds, kv.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(ds, kv.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(ds, kv.w, acc[4 * c4 + 3]);
      }
    }
  }

  if (live) {
    float* out = dq + b * xsb + h * xsh + (int64_t)row * xst + hf;
#pragma unroll
    for (int c = 0; c < HALF; ++c) out[c] = acc[c];
  }
}


// ---------------------------------------------------------------------------
// bf16 on wgmma, fed by TMA
// ---------------------------------------------------------------------------

using namespace hopper;

constexpr int ROWS = 128;         // rows a block owns: two consumer warpgroups of 64
constexpr int BT = 64;            // rows per streamed tile (and per TMA box)
constexpr int STAGES = 4;         // ring depth
constexpr int WG_THREADS = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2

// The dK/dV kernel's shared memory: the block's keys, and a ring of query
// tiles with their lse and D values.
struct __align__(1024) DkdvSmem {
  bf16 k[ROWS * D];  // [key][dim], 128-byte swizzle; warpgroup w's at w * 64 * D
  bf16 v[ROWS * D];
  bf16 q[STAGES][BT * D];  // [query][dim]
  bf16 g[STAGES][BT * D];  // dO
  float lse[STAGES][BT];
  float dd[STAGES][BT];
  uint64_t own_full;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// The dQ kernel's: the block's queries and their dO, and a ring of key tiles.
struct __align__(1024) DqSmem {
  bf16 q[ROWS * D];
  bf16 g[ROWS * D];
  bf16 k[STAGES][BT * D];
  bf16 v[STAGES][BT * D];
  uint64_t own_full;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// Barrier set-up shared by both kernels (thread 0, then the whole block).
// A full slot takes `full_count` arrivals besides its TMA bytes.
__device__ __forceinline__ void init_ring(uint64_t* own_full, uint64_t* full, uint64_t* empty,
                                          int full_count) {
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// The block's own 128 rows of two tensors: a 64-row box of each per
// half, where that half holds a row below t (a box wholly past t is not
// issued: its warpgroup's rows are never written).
__device__ __forceinline__ void load_own(bf16* a, const CUtensorMap* amap, bf16* b,
                                         const CUtensorMap* bmap, uint64_t* bar, int r0, int t,
                                         int h, int bi) {
  const int halves = r0 + BT < t ? 2 : 1;
  mbar_arrive_expect_tx(bar, halves * 2 * BT * D * 2);
  for (int i = 0; i < halves; ++i) {
    tma_load_4d(a + i * BT * D, amap, bar, 0, r0 + i * BT, h, bi);
    tma_load_4d(b + i * BT * D, bmap, bar, 0, r0 + i * BT, h, bi);
  }
}

// acc (64 rows x 64 dims of this warpgroup, accumulator layout) rounded to
// bf16 into rows row0, row0 + 8 of this thread; rows at or past t skipped.
__device__ __forceinline__ void store_rows(bf16* base, int64_t st, const float (&acc)[32],
                                           int row0, int t, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= t) continue;
    bf16* out = base + (int64_t)row * st + 2 * tq;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * n) =
          pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

// grid (ceil(T / 128), B * H). q/k/v/dO through the tensor maps (rows of
// (b, h) at {0, row, h, b}, 64-row boxes); lse and D, contiguous
// (B*H, T), copied into the ring by the producer warp's lanes (a TMA box
// of them would start at any 4-byte offset, and TMA reads 16-byte aligned
// boxes); dK, dV addressed as base + b*xsb + h*xsh + row*xst + c.
__global__ void __launch_bounds__(WG_THREADS, 1) dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const float* __restrict__ lse, const float* __restrict__ drow, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int n_head, int t, int64_t xsb, int64_t xsh, int64_t xst) {
  extern __shared__ uint8_t smem_raw[];
  DkdvSmem& sm = *reinterpret_cast<DkdvSmem*>(align1024(smem_raw));
  const int b = blockIdx.y / n_head, h = blockIdx.y % n_head;
  const int k0 = blockIdx.x * ROWS;
  const int n_tiles = (t + BT - 1) / BT;
  const int wg = threadIdx.x / 128;
  init_ring(&sm.own_full, sm.full, sm.empty, 1 + 32);  // + the producer warp's lanes

  if (wg == 2) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) load_own(sm.k, &kmap, sm.v, &vmap, &sm.own_full, k0, t, h, b);
      const float* lrow = lse + (int64_t)blockIdx.y * t;
      const float* drw = drow + (int64_t)blockIdx.y * t;
      for (int j = 0; j < n_tiles; ++j) {
        const int cs = j % STAGES;
        mbar_wait(&sm.empty[cs], ((j / STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[cs], 2 * BT * D * 2);
          tma_load_4d(sm.q[cs], &qmap, &sm.full[cs], 0, j * BT, h, b);
          tma_load_4d(sm.g[cs], &gmap, &sm.full[cs], 0, j * BT, h, b);
        }
#pragma unroll
        for (int i = lane; i < BT; i += 32) {  // columns past t: zeros, masked anyway
          const int row = j * BT + i;
          sm.lse[cs][i] = row < t ? lrow[row] : 0.f;
          sm.dd[cs][i] = row < t ? drw[row] : 0.f;
        }
        mbar_arrive(&sm.full[cs]);  // releases this lane's stores to the consumers
      }
    }
  } else {  // consumers: warpgroup wg owns keys k0 + 64 wg ..
    setmaxnreg_inc<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int tq = lane % 4;
    const uint64_t kd = desc_k_major(sm.k + wg * 64 * D);
    const uint64_t vd = desc_k_major(sm.v + wg * 64 * D);
    float dk_acc[32], dv_acc[32], st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = st[i] = dpt[i] = 0.f;
    uint32_t pa[4][4], dsa[4][4];  // P^T, dS^T as A fragments, per 16 queries

    mbar_wait(&sm.own_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int cs = j % STAGES;
      mbar_wait(&sm.full[cs], (j / STAGES) & 1);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      const uint64_t qd = desc_k_major(sm.q[cs]), gd = desc_k_major(sm.g[cs]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64<0>(st, kd + 2 * kk, qd + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64<0>(dpt, vd + 2 * kk, gd + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const int live = t - j * BT;  // query columns at or past it are masked
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * n + 2 * tq + c;
          const float lse2 = sm.lse[cs][col] * kLog2e, dval = sm.dd[cs][col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * n + 2 * r + c;
            p[2 * r + c] = col < live ? ex2(fmaf(st[i], kLog2e, -lse2)) : 0.f;
            ds[2 * r + c] = p[2 * r + c] * (dpt[i] - dval);
          }
        }
        pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsa[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(dsa);
      wgmma_fence();
      const uint64_t gm = desc_mn_major(sm.g[cs]), qm = desc_mn_major(sm.q[cs]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64<1>(dv_acc, pa[kk], gm + 128 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64<1>(dk_acc, dsa[kk], qm + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(&sm.empty[cs]);
    }

    const int row0 = k0 + wg * 64 + warp * 16 + lane / 4;
    store_rows(dk + b * xsb + h * xsh, xst, dk_acc, row0, t, tq);
    store_rows(dv + b * xsb + h * xsh, xst, dv_acc, row0, t, tq);
  }
}

// grid (ceil(T / 128), B * H); as the dK/dV kernel, with lse and D read
// per row from the flat arrays and dQ addressed as base + b*xsb + h*xsh +
// row*xst + c.
__global__ void __launch_bounds__(WG_THREADS, 1) dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const float* __restrict__ lse, const float* __restrict__ drow, bf16* __restrict__ dq,
    int n_head, int t, int64_t xsb, int64_t xsh, int64_t xst) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(align1024(smem_raw));
  const int b = blockIdx.y / n_head, h = blockIdx.y % n_head;
  const int q0 = blockIdx.x * ROWS;
  const int n_tiles = (t + BT - 1) / BT;
  const int wg = threadIdx.x / 128;
  init_ring(&sm.own_full, sm.full, sm.empty, 1);

  if (wg == 2) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      load_own(sm.q, &qmap, sm.g, &gmap, &sm.own_full, q0, t, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int cs = j % STAGES;
        mbar_wait(&sm.empty[cs], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[cs], 2 * BT * D * 2);
        tma_load_4d(sm.k[cs], &kmap, &sm.full[cs], 0, j * BT, h, b);
        tma_load_4d(sm.v[cs], &vmap, &sm.full[cs], 0, j * BT, h, b);
      }
    }
  } else {  // consumers: warpgroup wg owns queries q0 + 64 wg ..
    setmaxnreg_inc<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int tq = lane % 4;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
    float lse2[2], dval[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row0 + 8 * r < t;
      const int64_t at = (int64_t)blockIdx.y * t + row0 + 8 * r;
      lse2[r] = ok ? lse[at] * kLog2e : 0.f;
      dval[r] = ok ? drow[at] : 0.f;
    }
    const uint64_t qd = desc_k_major(sm.q + wg * 64 * D);
    const uint64_t gd = desc_k_major(sm.g + wg * 64 * D);
    float dq_acc[32], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = s[i] = dp[i] = 0.f;
    uint32_t dsa[4][4];  // dS as A fragments, per 16 keys

    mbar_wait(&sm.own_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int cs = j % STAGES;
      mbar_wait(&sm.full[cs], (j / STAGES) & 1);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      const uint64_t kd = desc_k_major(sm.k[cs]), vd = desc_k_major(sm.v[cs]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64<0>(s, qd + 2 * kk, kd + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64<0>(dp, gd + 2 * kk, vd + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const int live = t - j * BT;  // key columns at or past it are masked
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float ds[4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = 8 * n + 2 * tq + c < live;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * n + 2 * r + c;
            const float p = ok ? ex2(fmaf(s[i], kLog2e, -lse2[r])) : 0.f;
            ds[2 * r + c] = p * (dp[i] - dval[r]);
          }
        }
        dsa[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsa[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      fence_regs(dq_acc);
      fence_regs(dsa);
      wgmma_fence();
      const uint64_t km = desc_mn_major(sm.k[cs]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64<1>(dq_acc, dsa[kk], km + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(&sm.empty[cs]);
    }

    store_rows(dq + b * xsb + h * xsh, xst, dq_acc, row0, t, tq);
  }
}

template <typename T>
int launch_rowdot(const void* o, const void* g, float* drow, int batch, int n_head, int t,
                  int64_t osb, int64_t osh, int64_t ost, int64_t gsb, int64_t gsh, int64_t gst,
                  cudaStream_t s) {
  const int64_t rows = (int64_t)batch * n_head * t;
  rowdot_kernel<T><<<(unsigned)((rows + 15) / 16), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(g), drow, n_head, t, rows, osb, osh,
      ost, gsb, gsh, gst);
  return static_cast<int>(cudaGetLastError());
}


int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* drow, void* dq, void* dk, void* dv,
                     int batch, int n_head, int t, int64_t sb, int64_t sh, int64_t st,
                     int64_t gsb, int64_t gsh, int64_t gst, int64_t xsb, int64_t xsh,
                     int64_t xst, cudaStream_t s) {
  CUtensorMap qm, km, vm, gm;
  int err = encode_rows64(&qm, q, t, n_head, batch, st, sh, sb, BT);
  if (!err) err = encode_rows64(&km, k, t, n_head, batch, st, sh, sb, BT);
  if (!err) err = encode_rows64(&vm, v, t, n_head, batch, st, sh, sb, BT);
  if (!err) err = encode_rows64(&gm, dout, t, n_head, batch, gst, gsh, gsb, BT);
  if (err) return err;
  const dim3 grid((t + ROWS - 1) / ROWS, batch * n_head);
  const int dkdv_smem = (int)sizeof(DkdvSmem) + 1024, dq_smem = (int)sizeof(DqSmem) + 1024;
  cudaFuncSetAttribute(dkdv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
  cudaFuncSetAttribute(dq_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  dkdv_wgmma_kernel<<<grid, WG_THREADS, dkdv_smem, s>>>(
      qm, km, vm, gm, lse, drow, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_head, t, xsb,
      xsh, xst);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  dq_wgmma_kernel<<<grid, WG_THREADS, dq_smem, s>>>(qm, km, vm, gm, lse, drow,
                                                    static_cast<bf16*>(dq), n_head, t, xsb, xsh,
                                                    xst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v share the strides (sb, sh, st),
// o has (osb, osh, ost), dO (gsb, gsh, gst) and the three gradients
// (xsb, xsh, xst), all in elements with a unit last stride; lse (the
// forward's) and drow (scratch for D) are contiguous fp32 (batch*n_head, t).
// Launches the D pass, the dK/dV kernel and the dQ kernel in order on
// `stream`; returns the first nonzero cudaGetLastError() (0 when all three
// launches were accepted), or for bf16 hopper::kEncodeError + the CUresult
// when a tensor map cannot be encoded.
extern "C" int wf_flash64_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const float* lse, float* drow, void* dq,
                              void* dk, void* dv, int batch, int n_head, int t, int64_t sb,
                              int64_t sh, int64_t st, int64_t osb, int64_t osh, int64_t ost,
                              int64_t gsb, int64_t gsh, int64_t gst, int64_t xsb, int64_t xsh,
                              int64_t xst, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((t + TILE - 1) / TILE, batch * n_head);
  int err;
  if (dtype == 0) {
    err = launch_rowdot<float>(o, dout, drow, batch, n_head, t, osb, osh, ost, gsb, gsh, gst, s);
    if (err) return err;
    dkdv_fma_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, drow,
        static_cast<float*>(dk), static_cast<float*>(dv), n_head, t, sb, sh, st, gsb, gsh, gst,
        xsb, xsh, xst);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    dq_fma_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, drow,
        static_cast<float*>(dq), n_head, t, sb, sh, st, gsb, gsh, gst, xsb, xsh, xst);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  err = launch_rowdot<bf16>(o, dout, drow, batch, n_head, t, osb, osh, ost, gsb, gsh, gst, s);
  if (err) return err;
  return launch_bwd_wgmma(q, k, v, dout, lse, drow, dq, dk, dv, batch, n_head, t, sb, sh, st,
                          gsb, gsh, gst, xsb, xsh, xst, s);
}
