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
// buffer in x's dtype for a. The wrapper prepares each weight set once
// (wf_decode_mlp_prepare: pointers, widths, tensor maps) and launches with
// the handle (wf_decode_mlp).
//
// What bounds it on this card: the weight bytes. At the decode shapes
// (rows 8 to 120, d 768, f 3072 at `small`) the weights are 9.44 MB in
// bf16 (4.72 MB int8), x, a and the output a few hundred KB, and the two
// products 4 rows d f flops (1.13 GFLOP at 120 rows: 1.1 us of bf16
// tensor-core time against 1.4 us to read the int8 weights at 3.35 TB/s).
// So every weight byte is read once, by every SM at once, and what follows
// the read is kept short.
//
// Design for Hopper (bf16 x; the two passes fc1 + GELU and fc2):
//   - The weight is the M side of `wgmma` (64 output features per CTA, one
//     warpgroup), the rows the N side (N = 8, 32 or 128, the rows rounded
//     up). One CTA reads its weight slice once for all rows; above 128 rows
//     it walks row tiles with the slice held in shared memory.
//   - The contraction is split over a thread-block cluster (CL CTAs: 4 over
//     fc1's d, 8 over fc2's f at `small`, chosen by the wrapper's plan), so
//     fc1 runs 48 x 4 CTAs and fc2 12 x 8 on 132 SMs. Each CTA's weight
//     slice (64, K / CL) comes by TMA, all of it in flight under one
//     mbarrier, through a tensor map the wrapper encodes once per weight
//     tensor; the activation tile (N, K / CL) by cp.async into the 128-byte
//     swizzle.
//   - int8 weights: Hopper has no bf16 x s8 `wgmma`. The slice lands as
//     int8 and the CTA converts it once into the bf16 swizzled layout
//     (exact: an fp32 add on the byte placed in 2^23's mantissa, no
//     conversion unit), so both weight types take the SS form. (The RS
//     form with the weight converted into registers per fragment, tried
//     first, kept the products of a CTA in series: PERF.md.)
//   - The fp32 partial sums meet through distributed shared memory: CTA r
//     of the cluster owns rows [r 64 / CL, (r+1) 64 / CL) of the slice;
//     every CTA stores its partial sums of those rows into CTA r's shared
//     memory, in the slot of its own rank, with st.async, which counts the
//     bytes on CTA r's mbarrier; CTA r waits on it, adds the slots in rank
//     order and runs the epilogue for its rows. Every output is thus summed
//     in one fixed order: no atomics, no fp32 scratch in device memory, two
//     launches give the same bits. At N = 128 the partial sums take the
//     activation tile's place once every CTA's products are done (a cluster
//     barrier), so that two fc1 CTAs share an SM.
//   - fc2 launches early, by programmatic dependent launch: fc1's CTAs
//     trigger it as they start, fc2's CTAs land their W2 slices while fc1
//     runs, then wait (griddepcontrol.wait) for fc1's `act`. An earlier
//     version of this kernel failed so at N = 128 with "unspecified launch
//     failure"; that code was not kept and its cause is unknown. The
//     failure does not reproduce in the reduced case
//     (tests/test_torch_cuda.py, stale barriers left in shared memory before
//     every call), so the early launch is on again (PERF.md row 6). A
//     separate fault found on the way, threads polling the barriers before
//     thread 0 initialised them, is mended below.
// fp32 x (the checks' type): no TF32, so the products are fp32 FMA, one warp
// per output value with the lanes over the contraction and a butterfly sum
// (fixed order), two plain launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int NT = 128;  // threads per block (the FMA kernels; one warpgroup for wgmma)
constexpr int NW = NT / 32;
constexpr int MT = 64;   // weight rows (output features) per CTA: the wgmma M
constexpr int KB = 64;   // contraction block: one 128-byte swizzled row of bf16
constexpr int SMEM_MAX = 231424;  // dynamic shared memory: 227 KB less 1 KB for the static
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
// bf16 x on wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// Shared-memory bytes of one pass's CTA (ops/decode_mlp.py `_pass_smem`
// computes the same): 1024 to align the base, the bf16 weight slice
// (swizzled), the activation tile, which once the products are done holds
// the cluster's partial sums of this CTA's rows ([CL][64 / CL][N + 2] fp32;
// their own region when the tile is smaller), and, for int8 weights, the
// int8 slice as TMA lands it.
__host__ __device__ constexpr int red_bytes(int nt) { return MT * (nt + 2) * 4; }
__host__ __device__ constexpr bool aliased(int kbs, int nt) {
  return nt >= 128 && kbs * nt * KB * 2 >= red_bytes(nt);
}
__host__ __device__ constexpr int b_bytes(bool alias, int kbs, int nt) {
  return alias ? kbs * nt * KB * 2 : kbs * nt * KB * 2 + red_bytes(nt);
}
__host__ __device__ constexpr int pass_smem(bool int8, int kbs, int nt) {
  return 1024 + kbs * MT * KB * 2 + b_bytes(aliased(kbs, nt), kbs, nt) + (int8 ? kbs * MT * KB : 0);
}

// One pass: out[n][m] = epilogue(sum_k a_in[n][k] w[m][k]) for the CTA's 64
// rows m of w (read through `wmap`), over all rows n. FC2 picks fc2's
// epilogue, else fc1's. The cluster (CL CTAs) splits k: CTA r takes
// k-blocks [r kbs, (r+1) kbs). Rows m of the slice are owned 64 / CL per
// CTA: every CTA writes its partial sums of CTA r's rows into CTA r's
// shared memory (slot = its own rank) with st.async, which counts the bytes
// on CTA r's barrier; CTA r adds the slots in rank order.
template <bool INT8, int N, bool FC2>
__global__ void __launch_bounds__(NT) mlp_pass_kernel(
    const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ a_in,
    const bf16* __restrict__ bias, const float* __restrict__ scale, bf16* __restrict__ out,
    int rows, int M, int K, int kbs) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t w_bar;    // the weight slice has landed
  __shared__ uint64_t red_bar;  // the cluster's partial sums of this CTA's rows have landed
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows_per = MT / cl, pitch = N + 2;
  const bool ALIAS = aliased(kbs, N);
  uint8_t* wsm = hopper::align1024(smem_raw);                    // [kbs][64][128 B], swizzled
  uint8_t* bsm = wsm + kbs * MT * KB * 2;                        // [kbs][N][128 B], swizzled
  // [cl][rows_per][pitch]: over the activation tile at N = 128 (so that two
  // fc1 CTAs share an SM), else beside it
  float* red = reinterpret_cast<float*>(ALIAS ? bsm : bsm + kbs * N * KB * 2);
  uint8_t* w8 = bsm + b_bytes(ALIAS, kbs, N);  // int8: [kbs][64][64 B]
  const int tid = threadIdx.x;
  const int m0 = (blockIdx.x / cl) * MT;
  const int k0 = rank * kbs * KB;

  // the weight slice (64, kbs * 64) from row m0, column k0, by TMA, all of
  // it in flight at once; zeros past M and K
  if (tid == 0) {
    hopper::mbar_init(&w_bar, 1);
    hopper::mbar_init(&red_bar, 1);
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(&w_bar, kbs * MT * KB * (INT8 ? 1 : 2));
    for (int kb = 0; kb < kbs; ++kb)
      hopper::tma_load_2d(INT8 ? w8 + kb * MT * KB : wsm + kb * MT * 128, &wmap, &w_bar,
                          k0 + kb * KB, m0);
  }
  // the barriers are initialised before any other thread polls them: a
  // thread that polled first would read the barrier a CTA before it left at
  // this address, whose phase 0 may have completed
  __syncthreads();
  // fc2 may start now; launched early, it reads fc1's `act` only once fc1
  // has finished
  if constexpr (FC2) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  } else {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  }
  // this thread's epilogue rows: m = m0 + rank * rows_per + tid % rows_per
  // for every element it finishes (NT is a multiple of rows_per)
  const int my_m = m0 + rank * rows_per + tid % rows_per;
  float my_scale = 1.f, my_bias = 0.f;
  if (my_m < M) {  // loaded now (volatile: not sunk to their use at the end)
    if (scale != nullptr) asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(my_scale) : "l"(scale + my_m));
    unsigned short b;
    asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(b) : "l"(bias + my_m));
    my_bias = __bfloat162float(__ushort_as_bfloat16(b));
  }
  // the activation tile: rows n0 .. n0 + N - 1, the same columns, swizzled
  auto load_b = [&](int n0) {
    const int chunks = kbs * 8;
    for (int i = tid; i < N * chunks; i += NT) {
      const int n = i / chunks, kb = (i % chunks) / 8, c = i % 8, k = k0 + kb * KB + c * 8;
      const bool in = n0 + n < rows && k < K;
      cp_async16(bsm + kb * N * 128 + n * 128 + ((c ^ (n & 7)) * 16),
                 in ? a_in + (int64_t)(n0 + n) * K + k : a_in, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the weight slice once it has landed; int8 -> bf16 (exact) into the
  // swizzled layout the bf16 weights have
  auto convert_w = [&]() {
    hopper::mbar_wait(&w_bar, 0);
    if constexpr (INT8) {
      for (int i0 = tid; i0 < kbs * MT * 4; i0 += 2 * NT) {  // kbs * 256 chunks: 2 NT divides them
        uint4 v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + h * NT, kb = i / (MT * 4), m = (i / 4) % MT, c4 = i % 4;
          v[h] = *reinterpret_cast<const uint4*>(w8 + kb * MT * KB + m * KB + c4 * 16);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + h * NT, kb = i / (MT * 4), m = (i / 4) % MT, c4 = i % 4;
          uint32_t o[8];
          hopper::int8x4_to_bf16x4(v[h].x, o[0], o[1]);
          hopper::int8x4_to_bf16x4(v[h].y, o[2], o[3]);
          hopper::int8x4_to_bf16x4(v[h].z, o[4], o[5]);
          hopper::int8x4_to_bf16x4(v[h].w, o[6], o[7]);
          uint8_t* row = wsm + kb * MT * 128 + m * 128;
          *reinterpret_cast<uint4*>(row + (((2 * c4) ^ (m & 7)) * 16)) = make_uint4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<uint4*>(row + (((2 * c4 + 1) ^ (m & 7)) * 16)) = make_uint4(o[4], o[5], o[6], o[7]);
        }
      }
    }
  };
  if (!ALIAS) hopper::cluster_arrive();  // this CTA's barriers are set
  load_b(0);
  convert_w();

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int tiles = (rows + N - 1) / N;
  const uint32_t bar_local = hopper::smem_u32(&red_bar), red_local = hopper::smem_u32(red);
  for (int t = 0; t < tiles; ++t) {
    const int n0 = t * N;
    if (t > 0) load_b(n0);  // the previous tile's products are done (cluster sync)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    hopper::fence_proxy_async();  // generic-proxy writes are read by wgmma (async proxy)
    __syncthreads();

    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    for (int st = 0; st < kbs * 4; ++st) {
      const int kb = st / 4, kk = st % 4;
      hopper::wgmma_ss<N>(acc, hopper::desc_k_major(wsm + kb * MT * 128) + 2 * kk,
                          hopper::desc_k_major(bsm + kb * N * 128) + 2 * kk, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // every CTA's barriers are set (and, aliased, its products read its
    // activation tile no more: the partial sums land there)
    if (ALIAS) {
      hopper::cluster_arrive();
      hopper::cluster_wait();
    } else if (t == 0) {
      hopper::cluster_wait();
    }
    // this CTA's partial sums to their rows' owners: row m goes to CTA
    // m / rows_per, slot `rank`, [m % rows_per][n]
    if (tid == 0) hopper::mbar_arrive_expect_tx(&red_bar, MT * N * 4);  // every slot, this tile
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = 16 * warp + g + 8 * r, owner = m / rows_per;
      const uint32_t dst =
          hopper::mapa(red_local, owner) + ((rank * rows_per + m % rows_per) * pitch) * 4;
      const uint32_t bar = hopper::mapa(bar_local, owner);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        hopper::st_async_v2(dst + (8 * j + 2 * q) * 4, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1],
                            bar);
    }
    hopper::mbar_wait_cluster(&red_bar, t & 1);
    // rows rank * rows_per .. + rows_per - 1 of the slice: the slots added in
    // rank order, then the epilogue; four elements a thread at a time, so
    // that their loads and their GELUs overlap
    for (int e0 = tid; e0 < rows_per * N; e0 += 4 * NT) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = min(e0 + u * NT, rows_per * N - 1), ml = e % rows_per, n = e / rows_per;
        float part[8];
#pragma unroll
        for (int p = 0; p < 8; ++p) part[p] = p < cl ? red[(p * rows_per + ml) * pitch + n] : 0.f;
        v[u] = part[0];
#pragma unroll
        for (int p = 1; p < 8; ++p)
          if (p < cl) v[u] += part[p];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NT, row = n0 + e / rows_per;
        if (e < rows_per * N && row < rows && my_m < M) {
          const float h = v[u] * my_scale;
          if constexpr (FC2) {
            const float ox = to_f(from_f<bf16>(h));
            out[(int64_t)row * M + my_m] = from_f<bf16>(ox + my_bias);
          } else {
            out[(int64_t)row * M + my_m] = from_f<bf16>(gelu(h + my_bias));
          }
        }
      }
    }
    // before the next tile, every CTA has read its slots (peers rewrite
    // them) and every product of this tile is done (bsm is rewritten)
    if (t + 1 < tiles) cluster.sync();
  }
}

template <bool INT8, int N, bool FC2>
int launch_pass(const CUtensorMap& wmap, const bf16* a_in, const bf16* bias, const float* scale,
                bf16* out, int rows, int M, int K, int cl, cudaStream_t s) {
  auto kernel = mlp_pass_kernel<INT8, N, FC2>;
  const int kbs = ((K + KB - 1) / KB + cl - 1) / cl;
  const int smem = pass_smem(INT8, kbs, N);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed = 48 * 1024;  // the instantiation's dynamic shared memory limit so far
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((M + MT - 1) / MT) * cl);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = FC2 ? 2 : 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, wmap, a_in, bias, scale, out, rows, M, K, kbs));
}

// A weight set as the wrapper prepares it once: the pointers, the widths,
// the types and, for bf16 x, the weights' tensor maps (boxes of 64 rows x
// 64 columns: bf16 in the 128-byte swizzle, int8 plain).
struct MlpSet {
  CUtensorMap map1, map2;
  const void *w1, *b1, *w2, *b2;
  const float *s1, *s2;
  int d, f, dtype, w_int8;
};

template <bool INT8, int N>
int launch_wgmma(const MlpSet& m, const void* x, void* act, void* out, int rows, int cl1, int cl2,
                 cudaStream_t s) {
  int err = launch_pass<INT8, N, false>(m.map1, static_cast<const bf16*>(x),
                                        static_cast<const bf16*>(m.b1), m.s1,
                                        static_cast<bf16*>(act), rows, m.f, m.d, cl1, s);
  if (err != 0) return err;
  return launch_pass<INT8, N, true>(m.map2, static_cast<const bf16*>(act),
                                    static_cast<const bf16*>(m.b2), m.s2, static_cast<bf16*>(out),
                                    rows, m.d, m.f, cl2, s);
}

template <bool INT8>
int launch_bf16(const MlpSet& m, const void* x, void* act, void* out, int rows, int nt, int cl1,
                int cl2, cudaStream_t s) {
  switch (nt) {
    case 8: return launch_wgmma<INT8, 8>(m, x, act, out, rows, cl1, cl2, s);
    case 32: return launch_wgmma<INT8, 32>(m, x, act, out, rows, cl1, cl2, s);
    case 128: return launch_wgmma<INT8, 128>(m, x, act, out, rows, cl1, cl2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
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

// Prepares a weight set once (the wrapper keeps it while the weights live):
// dtype (of x, act, out, b1, b2 and plain weights) 0 = float32, 1 =
// bfloat16; w_int8 1 when w1 (f, d) and w2 (d, f) are int8 with the fp32
// scales s1 (f) and s2 (d), 0 when they are in x's dtype (s1, s2 null). d
// and f are multiples of 16 and every pointer 16-byte aligned (the wrapper
// checks). For bf16 it encodes the weights' tensor maps. Returns the set,
// or null with *err set (cudaErrorInvalidValue, or hopper::kEncodeError +
// the CUresult).
extern "C" void* wf_decode_mlp_prepare(const void* w1, const void* b1, const float* s1,
                                       const void* w2, const void* b2, const float* s2, int d,
                                       int f, int dtype, int w_int8, int* err) {
  *err = 0;
  if ((dtype != 0 && dtype != 1) || d % 16 || f % 16) {
    *err = static_cast<int>(cudaErrorInvalidValue);
    return nullptr;
  }
  MlpSet* m = new MlpSet();
  *m = MlpSet{{}, {}, w1, b1, w2, b2, s1, s2, d, f, dtype, w_int8};
  if (dtype == 1) {
    const int eb = w_int8 ? 1 : 2;
    const CUtensorMapSwizzle sw = w_int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
    *err = hopper::encode_2d(&m->map1, w1, eb, f, d, MT, KB, sw);
    if (*err == 0) *err = hopper::encode_2d(&m->map2, w2, eb, d, f, MT, KB, sw);
    if (*err != 0) {
      delete m;
      return nullptr;
    }
  }
  return m;
}

extern "C" void wf_decode_mlp_free(void* set) { delete static_cast<MlpSet*>(set); }

// x (rows, d), act (rows, f) and out (rows, d) in the set's dtype, 16-byte
// aligned, on the card. bf16 only: nt (8, 32 or 128) is the row tile, cl1
// and cl2 (1, 2, 4 or 8) the cluster sizes of fc1 and fc2
// (ops/decode_mlp.py `plan`). Launches the two passes on `stream`; returns
// the first launch error (0 when both were accepted).
extern "C" int wf_decode_mlp(const void* set, const void* x, void* act, void* out, int rows,
                             int nt, int cl1, int cl2, void* stream) {
  const MlpSet& m = *static_cast<const MlpSet*>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (m.dtype == 1) {
    auto ok = [](int c) { return c == 1 || c == 2 || c == 4 || c == 8; };
    if (!ok(cl1) || !ok(cl2)) return static_cast<int>(cudaErrorInvalidValue);
    return m.w_int8 ? launch_bf16<true>(m, x, act, out, rows, nt, cl1, cl2, s)
                    : launch_bf16<false>(m, x, act, out, rows, nt, cl1, cl2, s);
  }
  return m.w_int8 ? launch_fma<int8_t>(x, m.w1, m.b1, m.s1, m.w2, m.b2, m.s2, act, out, rows,
                                       m.d, m.f, s)
                  : launch_fma<float>(x, m.w1, m.b1, m.s1, m.w2, m.b2, m.s2, act, out, rows,
                                      m.d, m.f, s);
}
