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
//   2. the dK/dV kernel: one block per (b*h, 64-key tile); it loops over
//      the q tiles, recomputes S^T and dP^T for its keys and keeps dK and
//      dV in fp32 registers;
//   3. the dQ kernel: one block per (b*h, 64-query tile); it loops over the
//      key tiles, recomputes S and dP and keeps dQ in fp32 registers.
// S and dP are computed twice (once in each kernel): 7 products of
// 2*T*T*64 in all, against the 5 the backward needs.
// Nothing is padded: query rows and key columns at or past T are masked in
// the kernels (P = dS = 0 there) and not written.
//
// What bounds it: 5 products of 2*T*T*64 operations per (batch, head)
// against ~10*T*64 elements of traffic, so it is bound by arithmetic.
//   - bf16: every product runs on the tensor cores with mma.sync.m16n8k16
//     (bf16 in, fp32 accumulate). Each warp owns 16 rows (keys in the dK/dV
//     kernel, queries in the dQ kernel) and keeps its operands' A fragments
//     and its accumulators in registers; the other operands are 64-row
//     shared-memory tiles (rows padded to 72 elements: conflict-free),
//     copied in with cp.async two stages deep, so the next tile arrives
//     while this one is multiplied. Where a product contracts over the
//     tile's rows (dV = P^T dO, dK = dS^T Q, dQ = dS K), ldmatrix.trans
//     reads the row-major tile as the B operand: no transposed copy.
//     S^T/P^T and dS^T turn from accumulator into A fragments in
//     registers, as the forward does with P. No wgmma or TMA yet.
//   - fp32: the contract forbids TF32, so the products are fp32 FMA against
//     the card's 67 TFLOP/s rate: two threads share a row (32 dims each,
//     the dot products joined by one shuffle), the other operand's rows
//     are read from shared memory as a broadcast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;     // head width
constexpr int TILE = 64;  // rows per block and per shared-memory tile
constexpr int HALF = 32;  // dims per thread in the fp32 kernels
constexpr int PAD = 72;   // padded row length of the bf16 shared tiles
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
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col). Fragment
// layout (g = lane / 4, q = lane % 4): a0 (g, 2q..2q+1), a1 (g+8, 2q..),
// a2 (g, 2q+8..), a3 (g+8, 2q+8..); b0 (k 2q..2q+1, n g), b1 (k 2q+8.., n g);
// d0,d1 (g, 2q..2q+1), d2,d3 (g+8, 2q..2q+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// B fragments of two adjacent 8-column slices of a row-major [k][n] shared
// tile, where the product contracts over the tile's rows: one
// ldmatrix.x4.trans. Lane l gives the address of row (l & 15) of the
// 16-row chunk at column (l >> 4) * 8 of the 16-column pair; r0, r1 are
// (b0, b1) of the first slice, r2, r3 of the second.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without registers; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most one group (the newest prefetch) is still in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The A fragments of 16 rows (r0 = first row of this thread, r0 + 8 the
// second) x 64 dims of a row-major tensor; zeros for rows past T.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4], const bf16* base, int64_t st,
                                            int r0, bool live0, bool live1, int tq) {
  const bf16* p0 = base + (int64_t)r0 * st;
  const bf16* p1 = p0 + 8 * st;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * tq;
    a[kk][0] = live0 ? ld_pair(p0 + c) : 0u;
    a[kk][1] = live1 ? ld_pair(p1 + c) : 0u;
    a[kk][2] = live0 ? ld_pair(p0 + c + 8) : 0u;
    a[kk][3] = live1 ? ld_pair(p1 + c + 8) : 0u;
  }
}

// Start copying rows r_begin.. (n of them real) of a row-major tensor into
// a 64-row shared tile; rows past n are zero-filled. A warp copies four
// whole 128-byte rows.
__device__ __forceinline__ void issue_tile(bf16 (*dst)[PAD], const bf16* base, int64_t st,
                                           int r_begin, int n) {
#pragma unroll
  for (int i = threadIdx.x; i < TILE * (D / 8); i += THREADS) {
    const int r = i / 8, c8 = (i % 8) * 8;
    const bool ok = r < n;
    cp_async16(&dst[r][c8], base + (int64_t)(r_begin + (ok ? r : 0)) * st + c8, ok);
  }
}

// acc[8][4] (16 rows x 64 dims, fp32) rounded to bf16 into rows r0, r0 + 8.
__device__ __forceinline__ void store_rows(bf16* base, int64_t st, const float (&acc)[8][4],
                                           int r0, bool live0, bool live1, int tq) {
  bf16* o0 = base + (int64_t)r0 * st + 2 * tq;
  bf16* o1 = o0 + 8 * st;
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    if (live0) *reinterpret_cast<uint32_t*>(o0 + dn * 8) = pack_bf16(acc[dn][0], acc[dn][1]);
    if (live1) *reinterpret_cast<uint32_t*>(o1 + dn * 8) = pack_bf16(acc[dn][2], acc[dn][3]);
  }
}

// acc[8][4] (16 rows x 64 dims) += A (16 rows x 64 contraction, as 4 A
// fragments) x B, B the 64 x 64 row-major shared tile [contraction][dim].
__device__ __forceinline__ void mma_rows_by_tile(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                                 const bf16 (*tile)[PAD], int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, &tile[kk * 16 + (lane & 15)][dp * 16 + (lane >> 4) * 8]);
      mma_bf16(acc[2 * dp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// One block per (b*h, 64 keys); warp w owns keys k0 + 16w.. . For each
// 64-query tile (the next one copying in meanwhile): S^T = K Q^T and
// dP^T = V dO^T (keys x queries), then P^T = exp(S^T - lse),
// dS^T = P^T (dP^T - D), and dV += P^T dO, dK += dS^T Q, with P^T and dS^T
// rounded to bf16 as A fragments.
__global__ void __launch_bounds__(THREADS) dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ drow,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int n_head, int t, int64_t sb, int64_t sh,
    int64_t st, int64_t gsb, int64_t gsh, int64_t gst, int64_t xsb, int64_t xsh, int64_t xst) {
  __shared__ __align__(16) bf16 qs[2][TILE][PAD];  // Q tiles, [query][dim], two stages
  __shared__ __align__(16) bf16 gs[2][TILE][PAD];  // dO tiles, [query][dim]
  __shared__ float ls[2][TILE], dd[2][TILE];

  const int b = blockIdx.y / n_head, h = blockIdx.y % n_head;
  const bf16* qb = q + b * sb + h * sh;
  const bf16* gb = g + b * gsb + h * gsh;
  const float* lrow = lse + (int64_t)blockIdx.y * t;
  const float* drw = drow + (int64_t)blockIdx.y * t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / 4, tq = lane % 4;
  const int r0 = blockIdx.x * TILE + warp * 16 + gi;  // this thread's keys: r0, r0 + 8
  const bool live0 = r0 < t, live1 = r0 + 8 < t;

  // stage the first tile, then take K and V rows as A fragments
  auto stage = [&](int s, int q0) {
    const int nq = min(TILE, t - q0);
    issue_tile(qs[s], qb, st, q0, nq);
    issue_tile(gs[s], gb, gst, q0, nq);
    if (threadIdx.x < TILE) {
      const bool ok = threadIdx.x < nq;
      ls[s][threadIdx.x] = ok ? lrow[q0 + threadIdx.x] : 0.f;
      dd[s][threadIdx.x] = ok ? drw[q0 + threadIdx.x] : 0.f;
    }
  };
  stage(0, 0);
  cp_async_commit();
  uint32_t ka[4][4], va[4][4];
  load_a_rows(ka, k + b * sb + h * sh, st, r0, live0, live1, tq);
  load_a_rows(va, v + b * sb + h * sh, st, r0, live0, live1, tq);
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.f;

  for (int it = 0, q0 = 0; q0 < t; ++it, q0 += TILE) {
    const int cur = it & 1, nq = min(TILE, t - q0);
    if (q0 + TILE < t) stage(cur ^ 1, q0 + TILE);  // stage cur ^ 1 was last read before
    cp_async_commit();                             // the previous iteration's barrier
    cp_async_wait_prev();
    __syncthreads();

    uint32_t pa[4][4], dsa[4][4];  // P^T, dS^T in bf16 as A fragments, per 16 queries
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* qr = &qs[cur][nt * 8 + gi][2 * tq];
      const bf16* gr = &gs[cur][nt * 8 + gi][2 * tq];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_bf16(s, ka[kk], ld_pair(qr + kk * 16), ld_pair(qr + kk * 16 + 8));
        mma_bf16(dp, va[kk], ld_pair(gr + kk * 16), ld_pair(gr + kk * 16 + 8));
      }
      const int c = nt * 8 + 2 * tq;  // this thread's query columns: c, c + 1
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c + (e & 1);
        p[e] = col < nq ? expf(s[e] - ls[cur][col]) : 0.f;  // ragged edge: masked
        ds[e] = p[e] * (dp[e] - dd[cur][col]);
      }
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_rows_by_tile(dva, pa, gs[cur], lane);
    mma_rows_by_tile(dka, dsa, qs[cur], lane);
    __syncthreads();  // stage cur is refilled next iteration
  }

  store_rows(dk + b * xsb + h * xsh, xst, dka, r0, live0, live1, tq);
  store_rows(dv + b * xsb + h * xsh, xst, dva, r0, live0, live1, tq);
}

// One block per (b*h, 64 queries); warp w owns queries q0 + 16w.. . For
// each 64-key tile (the next one copying in meanwhile): S = Q K^T and
// dP = dO V^T, P = exp(S - lse), dS = P (dP - D) rounded to bf16,
// dQ += dS K.
__global__ void __launch_bounds__(THREADS) dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ drow,
    bf16* __restrict__ dq, int n_head, int t, int64_t sb, int64_t sh, int64_t st, int64_t gsb,
    int64_t gsh, int64_t gst, int64_t xsb, int64_t xsh, int64_t xst) {
  __shared__ __align__(16) bf16 ks[2][TILE][PAD];  // K tiles, [key][dim], two stages
  __shared__ __align__(16) bf16 vs[2][TILE][PAD];  // V tiles, [key][dim]

  const int b = blockIdx.y / n_head, h = blockIdx.y % n_head;
  const bf16* kb = k + b * sb + h * sh;
  const bf16* vb = v + b * sb + h * sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / 4, tq = lane % 4;
  const int r0 = blockIdx.x * TILE + warp * 16 + gi;  // this thread's queries: r0, r0 + 8
  const bool live0 = r0 < t, live1 = r0 + 8 < t;

  auto stage = [&](int s, int k0) {
    const int nk = min(TILE, t - k0);
    issue_tile(ks[s], kb, st, k0, nk);
    issue_tile(vs[s], vb, st, k0, nk);
  };
  stage(0, 0);
  cp_async_commit();
  const float* lrow = lse + (int64_t)blockIdx.y * t;
  const float* drw = drow + (int64_t)blockIdx.y * t;
  const float l0 = live0 ? lrow[r0] : 0.f, l1 = live1 ? lrow[r0 + 8] : 0.f;
  const float d0 = live0 ? drw[r0] : 0.f, d1 = live1 ? drw[r0 + 8] : 0.f;
  uint32_t qa[4][4], ga[4][4];
  load_a_rows(qa, q + b * sb + h * sh, st, r0, live0, live1, tq);
  load_a_rows(ga, g + b * gsb + h * gsh, gst, r0, live0, live1, tq);
  float acc[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int it = 0, k0 = 0; k0 < t; ++it, k0 += TILE) {
    const int cur = it & 1, nk = min(TILE, t - k0);
    if (k0 + TILE < t) stage(cur ^ 1, k0 + TILE);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    uint32_t dsa[4][4];  // dS in bf16 as A fragments, per 16 keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kr = &ks[cur][nt * 8 + gi][2 * tq];
      const bf16* vr = &vs[cur][nt * 8 + gi][2 * tq];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_bf16(s, qa[kk], ld_pair(kr + kk * 16), ld_pair(kr + kk * 16 + 8));
        mma_bf16(dp, ga[kk], ld_pair(vr + kk * 16), ld_pair(vr + kk * 16 + 8));
      }
      const int c = nt * 8 + 2 * tq;  // this thread's key columns: c, c + 1
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool top = e < 2;
        const float p = (c + (e & 1)) < nk ? expf(s[e] - (top ? l0 : l1)) : 0.f;
        ds[e] = p * (dp[e] - (top ? d0 : d1));
      }
      dsa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_rows_by_tile(acc, dsa, ks[cur], lane);
    __syncthreads();
  }

  store_rows(dq + b * xsb + h * xsh, xst, acc, r0, live0, live1, tq);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v share the strides (sb, sh, st),
// o has (osb, osh, ost), dO (gsb, gsh, gst) and the three gradients
// (xsb, xsh, xst), all in elements with a unit last stride; lse (the
// forward's) and drow (scratch for D) are contiguous fp32 (batch*n_head, t).
// Launches the D pass, the dK/dV kernel and the dQ kernel in order on
// `stream`; returns the first nonzero cudaGetLastError() (0 when all three
// launches were accepted).
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
  } else if (dtype == 1) {
    err = launch_rowdot<bf16>(o, dout, drow, batch, n_head, t, osb, osh, ost, gsb, gsh, gst, s);
    if (err) return err;
    dkdv_mma_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, drow, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), n_head, t, sb, sh, st, gsb, gsh, gst, xsb, xsh, xst);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    dq_mma_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, drow, static_cast<bf16*>(dq), n_head, t, sb, sh,
        st, gsb, gsh, gst, xsb, xsh, xst);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
