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
// fp32 row sum of the probabilities (the TPU kernel's ones-column sum was a
// TPU workaround). A null `lse` is inference: nothing more is written, as
// the JAX primal `_flash64` (:141-146) skips the residual.
//
// Design for Hopper. The TPU kernel kept all of K and V resident in VMEM
// (T padded to 1536: 384 KB in bf16), which does not fit the 227 KB of
// shared memory a block may use. Here K/V stream through shared memory in
// 64-row tiles with an online softmax (running max and sum, fp32
// accumulator), so nothing is padded: key columns at or past T are masked
// in the kernel and query rows past T are not written.
//
// What bounds it: the work is 4*T*T*64 flops per (batch, head) against
// 4*T*64 elements of traffic, so it is bound by arithmetic.
//   - bf16: the two products run on the tensor cores with
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate); each warp owns 16
//     query rows, keeps S, P and the output accumulator in registers in
//     the mma fragment layout, and reads K and a transposed V tile from
//     shared memory (rows padded to 72 elements: conflict-free fragment
//     reads). No wgmma, TMA or double buffering yet.
//   - fp32: the contract forbids TF32, so the products are fp32 FMA
//     against the card's 67 TFLOP/s rate: one thread owns one query row
//     (q and the accumulator in registers), and the block's threads read
//     each K/V element of the tile at the same time (a broadcast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MQ = 64;    // query rows per block: 4 warps x 16
constexpr int MK = 64;    // keys per shared-memory tile
constexpr int PAD = 72;   // padded row length of the shared tiles (elements)
constexpr int MMA_THREADS = 128;

using bf16 = __nv_bfloat16;

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
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Same addressing as the FMA kernel; rows must be 16-byte aligned (the
// wrapper checks the pointers and strides).
__global__ void __launch_bounds__(MMA_THREADS) flash64_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int n_head, int t, int64_t sb,
    int64_t sh, int64_t st, int64_t osb, int64_t osh, int64_t ost) {
  __shared__ __align__(16) bf16 ks[MK][PAD];  // K tile, [key][dim]
  __shared__ __align__(16) bf16 vt[D][PAD];   // V tile transposed, [dim][key]

  const int b = blockIdx.y / n_head, h = blockIdx.y % n_head;
  const int64_t base = b * sb + h * sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = blockIdx.x * MQ + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const bool live0 = r0 < t, live1 = r0 + 8 < t;

  uint32_t qa[4][4];  // Q as A fragments, one per 16-wide slice of d
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * tq;
    const bf16* q0 = q + base + (int64_t)r0 * st;
    const bf16* q1 = q0 + 8 * st;
    qa[kk][0] = live0 ? ld_pair(q0 + c) : 0u;
    qa[kk][1] = live1 ? ld_pair(q1 + c) : 0u;
    qa[kk][2] = live0 ? ld_pair(q0 + c + 8) : 0u;
    qa[kk][3] = live1 ? ld_pair(q1 + c + 8) : 0u;
  }

  float acc[8][4];  // output, 8 slices of 8 dims
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < t; k0 += MK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < MK * (D / 8); i += MMA_THREADS) {
      {  // K: 16-byte chunks, row-major
        const int r = i / 8, c8 = (i % 8) * 8;
        uint4 kv = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < t) kv = *reinterpret_cast<const uint4*>(k + base + (int64_t)(k0 + r) * st + c8);
        *reinterpret_cast<uint4*>(&ks[r][c8]) = kv;
      }
      {  // V: a warp covers 32 keys of one 8-dim chunk, so the transposed
         // stores land in distinct banks
        const int r = i % MK, c8 = (i / MK) * 8;
        uint4 vv = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < t) vv = *reinterpret_cast<const uint4*>(v + base + (int64_t)(k0 + r) * st + c8);
        const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int j = 0; j < 8; ++j) vt[c8 + j][r] = ve[j];
      }
    }
    __syncthreads();

    float s[8][4];  // S = Q K^T for 8 slices of 8 keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = &ks[nt * 8 + g][2 * tq];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_bf16(s[nt], qa[kk], ld_pair(kr + kk * 16), ld_pair(kr + kk * 16 + 8));
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = k0 + nt * 8 + 2 * tq;
      if (col >= t) s[nt][0] = s[nt][2] = -INFINITY;  // ragged edge: masked
      if (col + 1 >= t) s[nt][1] = s[nt][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = quad_max(mx0);  // key k0 is real, so both are finite
    mx1 = quad_max(mx1);
    const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);  // 0 on the first tile
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      acc[dn][0] *= a0;
      acc[dn][1] *= a0;
      acc[dn][2] *= a1;
      acc[dn][3] *= a1;
    }

    uint32_t pa[4][4];  // P in bf16 as A fragments, one per 16 keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(s[nt][0] - mx0), p1 = expf(s[nt][1] - mx0);
      const float p2 = expf(s[nt][2] - mx1), p3 = expf(s[nt][3] - mx1);
      l0 += p0 + p1;  // the row sum is of the fp32 probabilities
      l1 += p2 + p3;
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      const bf16* vr = &vt[dn * 8 + g][2 * tq];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_bf16(acc[dn], pa[kk], ld_pair(vr + kk * 16), ld_pair(vr + kk * 16 + 8));
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  bf16* o0 = o + b * osb + h * osh + (int64_t)r0 * ost + 2 * tq;
  bf16* o1 = o0 + 8 * ost;
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    if (live0) *reinterpret_cast<uint32_t*>(o0 + dn * 8) = pack_bf16(acc[dn][0] / l0, acc[dn][1] / l0);
    if (live1) *reinterpret_cast<uint32_t*>(o1 + dn * 8) = pack_bf16(acc[dn][2] / l1, acc[dn][3] / l1);
  }
  if (lse != nullptr && tq == 0) {  // m and l are the same across the quad
    float* lrow = lse + (int64_t)blockIdx.y * t;
    if (live0) lrow[r0] = m0 + logf(l0);
    if (live1) lrow[r0 + 8] = m1 + logf(l1);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `lse` is a
// contiguous fp32 (batch*n_head, t) array or null. Returns the launch's
// cudaGetLastError() (0 when the kernel was accepted).
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
  } else if (dtype == 1) {
    const dim3 grid((t + MQ - 1) / MQ, batch * n_head);
    flash64_fwd_mma_kernel<<<grid, MMA_THREADS, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, n_head, t, sb, sh, st, osb, osh, ost);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
