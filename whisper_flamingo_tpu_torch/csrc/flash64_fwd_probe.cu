// Two forward variants of the non-causal d_head-64 attention (the Whisper
// encoder's self-attention over its 1500 frames), for timing against the
// shipped forward (csrc/flash64_fwd.cu).
//
// Replaces the Pallas kernel of tools/flash64_fwd_probe.py:102 (`_call`,
// :84) in two of its three bodies:
//   - augv (`fwd_augv`, :57): the softmax row sum is not a separate sum of
//     the probabilities; it comes out of the P·V product through a ones
//     column appended to V. o and l are then sums of the same rounded
//     probabilities.
//   - csbound (`fwd_csbound_augv`, :69): the row max is replaced by the
//     Cauchy-Schwarz bound |q_i|_2 * kmax (kmax = max_j |k_j|_2 per
//     (batch, head), computed by the caller as the probe computes it
//     outside its kernel), and the row sum comes from the ones column as in
//     augv.
// The probe's third body, `fwd_shipped` (:48), is csrc/flash64_fwd.cu's
// bf16 kernel without lse. Same contract as there: q and k arrive scaled,
// the scores are fp32, the probabilities are rounded to bf16 before the V
// product, the product sums in fp32, and the output is bf16 o / l.
//
// Design for Hopper. The tiling is the shipped kernel's, so that a timing
// against it measures the softmax alone: a block owns 64 query rows (4
// warps x 16 rows, mma.sync.m16n8k16 in bf16 with fp32 accumulators in
// registers), K and a transposed V stream through shared memory in 64-key
// tiles (rows padded to 72 elements), and the ragged edge is masked in the
// kernel (the TPU's padding of T to 1536 and its whole-row resident K/V,
// 384 KB, do not carry over).
//   - augv: the ones column is a ninth 8-column tile of the P·V product
//     whose B fragment is a register constant (1 in column 0, 0 in the
//     other seven), so accumulator column 64 is l. The online softmax
//     keeps a running max; when it grows, one multiply per accumulator
//     element rescales o and l together. No separate row sum.
//   - csbound: bound_i is computed once per row from the q fragments in
//     registers; e = exp(s - bound_i) needs no running max, so there is no
//     max reduction and the accumulator is never rescaled. A row whose
//     scores all lie more than ~87 below its bound underflows to l = 0 and
//     its output is 0/0: the JAX math gives the same non-finite row, and
//     this kernel matches it rather than guarding it.
// What bounds it: 4*T*T*64 operations per (batch, head) against 4*T*64
// elements of traffic, so arithmetic (augv adds 1/8 to the P·V product).
// No wgmma, TMA or double buffering yet, as in the shipped kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;    // head width
constexpr int MQ = 64;   // query rows per block: 4 warps x 16
constexpr int MK = 64;   // keys per shared-memory tile
constexpr int PAD = 72;  // padded row length of the shared tiles (elements)
constexpr int THREADS = 128;

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

// Sum of squares of the two bf16 values packed in x.
__device__ __forceinline__ float sq_pair(uint32_t x) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return f.x * f.x + f.y * f.y;
}

// q/k/v/o are contiguous (heads, t, 64); kmax is (heads,) fp32 (csbound
// only). One block per (64 query rows, head).
template <bool CSBOUND>
__global__ void __launch_bounds__(THREADS) fwd_probe_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ kmax, bf16* __restrict__ o, int t) {
  __shared__ __align__(16) bf16 ks[MK][PAD];  // K tile, [key][dim]
  __shared__ __align__(16) bf16 vt[D][PAD];   // V tile transposed, [dim][key]

  const int64_t base = (int64_t)blockIdx.y * t * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = blockIdx.x * MQ + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const bool live0 = r0 < t, live1 = r0 + 8 < t;

  uint32_t qa[4][4];  // Q as A fragments, one per 16-wide slice of d
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * tq;
    const bf16* q0 = q + base + (int64_t)r0 * D;
    const bf16* q1 = q0 + 8 * D;
    qa[kk][0] = live0 ? ld_pair(q0 + c) : 0u;
    qa[kk][1] = live1 ? ld_pair(q1 + c) : 0u;
    qa[kk][2] = live0 ? ld_pair(q0 + c + 8) : 0u;
    qa[kk][3] = live1 ? ld_pair(q1 + c + 8) : 0u;
  }

  // csbound: the row's shift is its bound, fixed for the whole row;
  // augv: the running max
  float m0 = -INFINITY, m1 = -INFINITY;
  if (CSBOUND) {
    float ss0 = 0.f, ss1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ss0 += sq_pair(qa[kk][0]) + sq_pair(qa[kk][2]);
      ss1 += sq_pair(qa[kk][1]) + sq_pair(qa[kk][3]);
    }
    const float km = kmax[blockIdx.y];
    m0 = sqrtf(quad_sum(ss0)) * km;
    m1 = sqrtf(quad_sum(ss1)) * km;
  }

  // the ones column's B fragment: 1 at n = 0 (accumulator column 64)
  const uint32_t ones = g == 0 ? pack_bf16(1.f, 1.f) : 0u;

  float acc[9][4];  // 8 slices of 8 output dims, then [l, 0, ...]
#pragma unroll
  for (int dn = 0; dn < 9; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int k0 = 0; k0 < t; k0 += MK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < MK * (D / 8); i += THREADS) {
      {  // K: 16-byte chunks, row-major
        const int r = i / 8, c8 = (i % 8) * 8;
        uint4 kv = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < t) kv = *reinterpret_cast<const uint4*>(k + base + (int64_t)(k0 + r) * D + c8);
        *reinterpret_cast<uint4*>(&ks[r][c8]) = kv;
      }
      {  // V: a warp covers 32 keys of one 8-dim chunk, so the transposed
         // stores land in distinct banks
        const int r = i % MK, c8 = (i / MK) * 8;
        uint4 vv = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < t) vv = *reinterpret_cast<const uint4*>(v + base + (int64_t)(k0 + r) * D + c8);
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
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = k0 + nt * 8 + 2 * tq;
      if (col >= t) s[nt][0] = s[nt][2] = -INFINITY;  // ragged edge: masked
      if (col + 1 >= t) s[nt][1] = s[nt][3] = -INFINITY;
    }

    if (!CSBOUND) {
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = quad_max(mx0);  // key k0 is real, so both are finite
      mx1 = quad_max(mx1);
      const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);  // 0 on the first tile
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int dn = 0; dn < 9; ++dn) {  // o and l together
        acc[dn][0] *= a0;
        acc[dn][1] *= a0;
        acc[dn][2] *= a1;
        acc[dn][3] *= a1;
      }
    }

    uint32_t pa[4][4];  // P in bf16 as A fragments, one per 16 keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(expf(s[nt][0] - m0), expf(s[nt][1] - m0));
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(expf(s[nt][2] - m1), expf(s[nt][3] - m1));
    }
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      const bf16* vr = &vt[dn * 8 + g][2 * tq];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_bf16(acc[dn], pa[kk], ld_pair(vr + kk * 16), ld_pair(vr + kk * 16 + 8));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_bf16(acc[8], pa[kk], ones, ones);
  }

  // column 64 (n = 0 of the ninth tile) sits with the quad's first thread
  const int lead = lane & ~3;
  const float l0 = __shfl_sync(0xffffffffu, acc[8][0], lead);
  const float l1 = __shfl_sync(0xffffffffu, acc[8][2], lead);
  bf16* o0 = o + base + (int64_t)r0 * D + 2 * tq;
  bf16* o1 = o0 + 8 * D;
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    if (live0) *reinterpret_cast<uint32_t*>(o0 + dn * 8) = pack_bf16(acc[dn][0] / l0, acc[dn][1] / l0);
    if (live1) *reinterpret_cast<uint32_t*>(o1 + dn * 8) = pack_bf16(acc[dn][2] / l1, acc[dn][3] / l1);
  }
}

}  // namespace

// variant: 0 = augv, 1 = csbound (kmax required). q/k/v/o are contiguous
// bf16 (heads, t, 64). Returns the launch's cudaGetLastError() (0 when the
// kernel was accepted).
extern "C" int wf_flash64_fwd_probe(const void* q, const void* k, const void* v,
                                    const float* kmax, void* o, int heads, int t, int variant,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((t + MQ - 1) / MQ, heads);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  if (variant == 0) {
    fwd_probe_kernel<false><<<grid, THREADS, 0, s>>>(qb, kb, vb, nullptr, ob, t);
  } else if (variant == 1 && kmax != nullptr) {
    fwd_probe_kernel<true><<<grid, THREADS, 0, s>>>(qb, kb, vb, kmax, ob, t);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
