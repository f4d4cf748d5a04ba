// The decoder MLP of one incremental decode step: fc1, the exact GELU and
// fc2 over a few rows, with plain or int8 weights.
//
// Replaces the Pallas kernel whisper_flamingo_tpu/ops/decode_mlp.py:70
// `_kernel` (through `_call` :92 and `fused_mlp` :117), plain and int8
// variants. The numerics are the JAX kernel's:
//   - h = x . W1 with an fp32 accumulator (products of the x-dtype values);
//   - int8 weights only: h *= s1 (fp32), before the bias and the GELU;
//   - h += b1 (as fp32); a = gelu(h) with the exact erf, rounded to x's
//     dtype;
//   - o = a . W2 summed in fp32; int8 only: o *= s2 (fp32);
//   - the output is o cast to x's dtype, plus b2 in x's dtype.
// The Abramowitz-Stegun erf of the TPU kernel (a Pallas-TPU workaround,
// within 1.5e-7 of erf) is not carried: this is erff.
//
// Layouts: x (rows, d) and the output (rows, d) row-major in x's dtype;
// W1 is fc1.weight (f, d) and W2 is fc2.weight (d, f), the nn.Linear
// layouts, in x's dtype or int8 with the fp32 per-output-channel scales
// s1 (f) and s2 (d); b1 (f) and b2 (d) in x's dtype; `act` is an (rows, f)
// scratch buffer in x's dtype for a.
//
// What bounds it: at the decode shapes (rows 8 to 120, d 768, f 3072 at
// `small`) the weights are 9.44 MB in bf16 (4.72 MB int8) and x, a and the
// output a few hundred KB, while the two products are 4*rows*d*f flops,
// 1.13 GFLOP at 120 rows (about 1.1 us of bf16 tensor-core time against
// 2.8 us to read the weights at 3.35 TB/s): it is bound by the weight
// bytes at every decode row count.
//
// Design for Hopper. The TPU kernel walked the ffn axis in order on one
// core and kept one output block resident across the walk. Blocks on the
// card run in parallel and in no order, and fc2 must sum over the whole
// ffn axis, so the work is two passes, each launched over enough blocks to
// stream its weights at once:
//   1. fc1: one block per (32 ffn units, 16-row tile of x). It copies its
//      (32, d) slice of W1 into shared memory with cp.async (all of it in
//      flight at once: the weight read is the whole cost), each warp takes
//      8 units over all of d, and the epilogue writes a in x's dtype to
//      `act` (rows * f values: 737 KB in bf16 at 120 rows, against 9.44 MB
//      of weights).
//   2. fc2: one block per (8 output columns, 16-row tile). It copies its
//      (8, f) slice of W2 into shared memory the same way; the 4 warps take
//      interleaved 16-wide steps of the ffn axis, their partial sums meet in
//      shared memory and are added in a fixed order; the epilogue applies
//      s2, the cast and b2.
//   The row tiles of one slice re-read it from L2, not HBM. (A first
//   version walked every row tile in one block per slice: 96 blocks at any
//   row count; PERF.md has both versions' times.)
// So each output element's sum over the ffn axis is taken inside one
// block in one fixed order: no atomics, no fp32 scratch of partial
// outputs, and two launches on the same inputs give the same bits.
//   - bf16 x: both products run on mma.sync.m16n8k16 (bf16 in, fp32
//     accumulate). The 16-row tile of x (or act) is copied into shared
//     memory in 512-wide chunks of the contraction, double-buffered, the
//     next chunk in flight while this one multiplies (x and act are
//     L2-resident, and every block reads them); the B fragments come from
//     the shared weight tile, and each warp keeps two accumulators (two
//     independent mma chains, added at the end). int8 weights are copied as
//     int8 (half the bytes) and converted to bf16 in registers when the
//     fragment is built: an int8 value is exact in bf16, so this is the
//     product of the bf16 activations with the dequantized-before-scale
//     weights, not an int8 x int8 product.
//   - fp32 x (the checks' type): no TF32, so the products are fp32 FMA, one warp per output value with the lanes over the
//     contraction and a butterfly sum (fixed order).
// Rows past `rows` (8 and 120 are not multiples of 16) are masked: their
// staged A rows are zero and they are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr int TF = 32;   // fc1: ffn units per block (4 warps x 8)
constexpr int TD = 8;    // fc2: output columns per block
constexpr int PAD = 16;  // bytes added to each shared-memory row (conflict-free fragment reads)
constexpr int KC = 512;  // contraction chunk of the staged A rows (elements)
constexpr int A_PITCH = KC * 2 + PAD;  // bytes per staged A row
constexpr int STAGES = 2;              // staged A tiles: one in flight, one in use
constexpr float kAlpha = 0.70710678118654752440f;  // 1/sqrt(2)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// exact GELU in fp32, as F.gelu computes it
__device__ __forceinline__ float gelu(float h) { return h * 0.5f * (1.f + erff(h * kAlpha)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// ---------------------------------------------------------------------------
// bf16 x on the tensor cores
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
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two consecutive weights (k, k+1) of a shared-memory row as a bf16 pair.
__device__ __forceinline__ uint32_t b_pair(const bf16* row, int k) { return ld_pair(row + k); }
__device__ __forceinline__ uint32_t b_pair(const int8_t* row, int k) {
  const char2 v = *reinterpret_cast<const char2*>(row + k);
  return pack_bf16(static_cast<float>(v.x), static_cast<float>(v.y));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + n) of a row-major (n_rows, len) weight into shared
// memory rows of `pitch` bytes with cp.async; rows past n_rows are zero.
// len * sizeof(WT) is a multiple of 16 (the wrapper checks). Does not wait.
template <typename WT>
__device__ __forceinline__ void stage_rows(unsigned char* sm, int pitch, const WT* w, int r0,
                                           int n, int n_rows, int len) {
  const int chunks = len * static_cast<int>(sizeof(WT)) / 16;
  for (int i = threadIdx.x; i < n * chunks; i += NT) {
    const int r = i / chunks, c = i % chunks;
    unsigned char* dst = sm + r * pitch + c * 16;
    if (r0 + r < n_rows) {
      cp_async16(dst, reinterpret_cast<const unsigned char*>(w + (int64_t)(r0 + r) * len) + c * 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Copy rows [r0, r0 + 16) x columns [k0, k0 + kc) of a row-major bf16
// (rows, ld) matrix into shared-memory rows of `pitch` bytes with
// cp.async; rows past `rows` are zero (the masked rows of the m16 tile).
// Does not wait.
__device__ __forceinline__ void stage_a(unsigned char* sa, int pitch, const bf16* a, int r0,
                                        int rows, int ld, int k0, int kc) {
  const int chunks = kc * 2 / 16;
  for (int i = threadIdx.x; i < 16 * chunks; i += NT) {
    const int r = i / chunks, c = i % chunks;
    unsigned char* dst = sa + r * pitch + c * 16;
    if (r0 + r < rows) {
      cp_async16(dst, reinterpret_cast<const unsigned char*>(a + (int64_t)(r0 + r) * ld + k0) + c * 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// One m16n8k16 step: A rows g and g+8 of the staged tile at column k, B
// column n = g of the weight tile at contraction index kw.
template <typename WT>
__device__ __forceinline__ void mma_step(float (&acc)[4], const bf16* ra, const bf16* rb,
                                         const WT* wrow, int k, int kw, int q) {
  const uint32_t a[4] = {ld_pair(ra + k + 2 * q), ld_pair(rb + k + 2 * q),
                         ld_pair(ra + k + 2 * q + 8), ld_pair(rb + k + 2 * q + 8)};
  mma_bf16(acc, a, b_pair(wrow, kw + 2 * q), b_pair(wrow, kw + 2 * q + 8));
}

// Contraction chunk c of the block's 16-row A tile (rows r0 .. r0 + 15)
// into buffer c % STAGES, as one cp.async group; past the last chunk the
// group is empty, so every thread always has STAGES - 1 groups in flight
// behind the current one.
__device__ __forceinline__ void issue_a(unsigned char* sa, const bf16* a, int rows, int k, int r0,
                                        int c, int n_chunks) {
  if (c < n_chunks) {
    const int k0 = c * KC;
    stage_a(sa + (c % STAGES) * 16 * A_PITCH, A_PITCH, a, r0, rows, k, k0, min(KC, k - k0));
  }
  cp_async_commit();
}

// Both passes run one block per (weight slice, 16-row tile): blockIdx.x
// picks the slice, blockIdx.y the row tile, so 120 rows launch 8 times the
// blocks of 8 rows (the tiles' re-reads of a weight slice hit L2: the
// weights are 9.44 MB at most). A block walks the contraction in 512-wide
// chunks with the A tiles STAGES deep: the copies of the next STAGES - 1
// chunks are in flight while chunk c multiplies.
template <typename WT>
__global__ void __launch_bounds__(NT) fc1_mma_kernel(
    const bf16* __restrict__ x, const WT* __restrict__ w1, const bf16* __restrict__ b1,
    const float* __restrict__ s1, bf16* __restrict__ act, int rows, int d, int f) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int pitch = d * static_cast<int>(sizeof(WT)) + PAD;
  unsigned char* sa = sm + TF * pitch;  // STAGES staged x buffers
  const int f0 = blockIdx.x * TF, r0 = blockIdx.y * 16;
  const int n_chunks = (d + KC - 1) / KC;
  stage_rows(sm, pitch, w1, f0, TF, f, d);
  for (int c = 0; c < STAGES - 1; ++c)  // the first group holds the weight tile too
    issue_a(sa, x, rows, d, r0, c, n_chunks);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const WT* wrow = reinterpret_cast<const WT*>(sm + (warp * 8 + g) * pitch);  // B column n = g
  const int col = f0 + warp * 8 + 2 * q;  // this thread's outputs: col, col + 1
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc2[4] = {0.f, 0.f, 0.f, 0.f};  // two mma chains
  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = c * KC, kc = min(KC, d - k0);
    issue_a(sa, x, rows, d, r0, c + STAGES - 1, n_chunks);
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const unsigned char* buf = sa + (c % STAGES) * 16 * A_PITCH;
    const bf16* ra = reinterpret_cast<const bf16*>(buf + g * A_PITCH);
    const bf16* rb = reinterpret_cast<const bf16*>(buf + (g + 8) * A_PITCH);
    int k = 0;
    for (; k + 32 <= kc; k += 32) {
      mma_step(acc, ra, rb, wrow, k, k0 + k, q);
      mma_step(acc2, ra, rb, wrow, k + 16, k0 + k + 16, q);
    }
    if (k < kc) mma_step(acc, ra, rb, wrow, k, k0 + k, q);
    __syncthreads();  // buffer c % STAGES is free for chunk c + STAGES
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + g + (j < 2 ? 0 : 8), cc = col + (j & 1);
    if (r < rows && cc < f) {
      float h = acc[j] + acc2[j];
      if (s1 != nullptr) h *= s1[cc];
      h += to_f(b1[cc]);
      act[(int64_t)r * f + cc] = from_f<bf16>(gelu(h));
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(NT) fc2_mma_kernel(
    const bf16* __restrict__ act, const WT* __restrict__ w2, const bf16* __restrict__ b2,
    const float* __restrict__ s2, bf16* __restrict__ out, int rows, int d, int f) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ float part[NW][16][TD];
  const int pitch = f * static_cast<int>(sizeof(WT)) + PAD;
  unsigned char* sa = sm + TD * pitch;  // STAGES staged act buffers
  const int d0 = blockIdx.x * TD, r0 = blockIdx.y * 16;
  const int n_chunks = (f + KC - 1) / KC;
  stage_rows(sm, pitch, w2, d0, TD, d, f);
  for (int c = 0; c < STAGES - 1; ++c)  // the first group holds the weight tile too
    issue_a(sa, act, rows, f, r0, c, n_chunks);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const WT* wrow = reinterpret_cast<const WT*>(sm + g * pitch);  // B column n = g
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc2[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = c * KC, kc = min(KC, f - k0);
    issue_a(sa, act, rows, f, r0, c + STAGES - 1, n_chunks);
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const unsigned char* buf = sa + (c % STAGES) * 16 * A_PITCH;
    const bf16* ra = reinterpret_cast<const bf16*>(buf + g * A_PITCH);
    const bf16* rb = reinterpret_cast<const bf16*>(buf + (g + 8) * A_PITCH);
    // the warps take interleaved 16-wide steps, alternating two
    // accumulators: a fixed order per warp
    const int n_steps = kc / 16;
    int st = warp;
    for (; st + NW < n_steps; st += 2 * NW) {
      mma_step(acc, ra, rb, wrow, st * 16, k0 + st * 16, q);
      mma_step(acc2, ra, rb, wrow, (st + NW) * 16, k0 + (st + NW) * 16, q);
    }
    if (st < n_steps) mma_step(acc, ra, rb, wrow, st * 16, k0 + st * 16, q);
    __syncthreads();  // buffer c % STAGES is free for chunk c + STAGES
  }
  part[warp][g][2 * q] = acc[0] + acc2[0];
  part[warp][g][2 * q + 1] = acc[1] + acc2[1];
  part[warp][g + 8][2 * q] = acc[2] + acc2[2];
  part[warp][g + 8][2 * q + 1] = acc[3] + acc2[3];
  __syncthreads();
  // one output per thread: 16 rows x 8 columns, the warps' partial sums
  // added in a fixed order
  const int rr = threadIdx.x / TD, cc = threadIdx.x % TD;
  const int r = r0 + rr, col = d0 + cc;
  if (r < rows && col < d) {
    float o = part[0][rr][cc];
#pragma unroll
    for (int w = 1; w < NW; ++w) o += part[w][rr][cc];
    if (s2 != nullptr) o *= s2[col];
    const float ox = to_f(from_f<bf16>(o));
    out[(int64_t)r * d + col] = from_f<bf16>(ox + to_f(b2[col]));
  }
}

// ---------------------------------------------------------------------------
// fp32 x with FMA
// ---------------------------------------------------------------------------

// One warp per ffn unit (4 per block), every row.
template <typename WT>
__global__ void __launch_bounds__(NT) fc1_fma_kernel(
    const float* __restrict__ x, const WT* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ s1, float* __restrict__ act, int rows, int d, int f) {
  const int c = blockIdx.x * NW + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (c >= f) return;
  const WT* wr = w1 + (int64_t)c * d;
  for (int r = 0; r < rows; ++r) {
    const float* xr = x + (int64_t)r * d;
    float h = 0.f;
    for (int k = lane; k < d; k += 32) h = fmaf(xr[k], to_f(wr[k]), h);
    h = warp_sum(h);
    if (lane == 0) {
      if (s1 != nullptr) h *= s1[c];
      act[(int64_t)r * f + c] = gelu(h + b1[c]);
    }
  }
}

// One warp per output column (4 per block), every row.
template <typename WT>
__global__ void __launch_bounds__(NT) fc2_fma_kernel(
    const float* __restrict__ act, const WT* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ s2, float* __restrict__ out, int rows, int d, int f) {
  const int c = blockIdx.x * NW + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (c >= d) return;
  const WT* wr = w2 + (int64_t)c * f;
  for (int r = 0; r < rows; ++r) {
    const float* ar = act + (int64_t)r * f;
    float o = 0.f;
    for (int k = lane; k < f; k += 32) o = fmaf(ar[k], to_f(wr[k]), o);
    o = warp_sum(o);
    if (lane == 0) {
      if (s2 != nullptr) o *= s2[c];
      out[(int64_t)r * d + c] = o + b2[c];
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)));
}

template <typename WT>
int launch_mma(const void* x, const void* w1, const void* b1, const float* s1, const void* w2,
               const void* b2, const float* s2, void* act, void* out, int rows, int d, int f,
               cudaStream_t s) {
  const size_t sm1 = static_cast<size_t>(TF) * (d * sizeof(WT) + PAD) + STAGES * 16 * A_PITCH;
  const size_t sm2 = static_cast<size_t>(TD) * (f * sizeof(WT) + PAD) + STAGES * 16 * A_PITCH;
  int err = set_smem(fc1_mma_kernel<WT>, sm1);
  if (err == 0) err = set_smem(fc2_mma_kernel<WT>, sm2);
  if (err != 0) return err;
  const int tiles = (rows + 15) / 16;
  fc1_mma_kernel<WT><<<dim3((f + TF - 1) / TF, tiles), NT, sm1, s>>>(
      static_cast<const bf16*>(x), static_cast<const WT*>(w1), static_cast<const bf16*>(b1), s1,
      static_cast<bf16*>(act), rows, d, f);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  fc2_mma_kernel<WT><<<dim3((d + TD - 1) / TD, tiles), NT, sm2, s>>>(
      static_cast<const bf16*>(act), static_cast<const WT*>(w2), static_cast<const bf16*>(b2), s2,
      static_cast<bf16*>(out), rows, d, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT>
int launch_fma(const void* x, const void* w1, const void* b1, const float* s1, const void* w2,
               const void* b2, const float* s2, void* act, void* out, int rows, int d, int f,
               cudaStream_t s) {
  fc1_fma_kernel<WT><<<(f + NW - 1) / NW, NT, 0, s>>>(
      static_cast<const float*>(x), static_cast<const WT*>(w1), static_cast<const float*>(b1), s1,
      static_cast<float*>(act), rows, d, f);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  fc2_fma_kernel<WT><<<(d + NW - 1) / NW, NT, 0, s>>>(
      static_cast<const float*>(act), static_cast<const WT*>(w2), static_cast<const float*>(b2),
      s2, static_cast<float*>(out), rows, d, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of x, act, out, b1, b2 and plain weights): 0 = float32, 1 =
// bfloat16. w_int8: 1 when w1/w2 are int8 with the fp32 scales s1 (f) and
// s2 (d), 0 when they are in x's dtype (s1 and s2 null). d and f are
// multiples of 16; every pointer is 16-byte aligned (the wrapper checks).
// Launches the two passes on `stream`; returns the first launch error
// (cudaGetLastError(), 0 when both were accepted).
extern "C" int wf_decode_mlp(const void* x, const void* w1, const void* b1, const float* s1,
                             const void* w2, const void* b2, const float* s2, void* act,
                             void* out, int rows, int d, int f, int dtype, int w_int8,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (dtype == 1) {
    return w_int8 ? launch_mma<int8_t>(x, w1, b1, s1, w2, b2, s2, act, out, rows, d, f, s)
                  : launch_mma<bf16>(x, w1, b1, s1, w2, b2, s2, act, out, rows, d, f, s);
  }
  if (dtype == 0) {
    return w_int8 ? launch_fma<int8_t>(x, w1, b1, s1, w2, b2, s2, act, out, rows, d, f, s)
                  : launch_fma<float>(x, w1, b1, s1, w2, b2, s2, act, out, rows, d, f, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
