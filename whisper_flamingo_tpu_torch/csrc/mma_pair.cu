// The attention matmul pair looped on the tensor cores: the rate probe of
// flash attention's inner loop at head width d.
//
// Replaces the Pallas kernel of tools/packed_probe2.py:53 (`make_kernel`,
// :39; body `kernel`, :42). The function, `iters` times over w (R, n):
//     o = bf16(0.01 * (w @ v))      v (n, d), fp32 sum over n
//     w = bf16(0.01 * (o @ u))      u (d, n), fp32 sum over d
// and the last w is the output. The probe's R is 512 (its q tile); here R
// is any multiple of 64, since the rows are independent.
//
// What bounds it: 4 R n d operations per iteration against (R n + 2 n d)
// elements read once, so the tensor cores, if u and v stay on chip. The
// TPU kept w, u and v resident in VMEM; at d 64, u and v are 192 KB each,
// which fits no SM but fits a cluster's shared memory. So:
//   - A cluster of C CTAs (ops/mma_pair.py `plan`: C 4, 8 or 16) splits the
//     n columns: CTA c owns columns [c n / C, (c + 1) n / C) for G = 1, 2
//     or 4 64-row blocks of w (one warpgroup each, wgmma M = 64). By
//     TMA, once per launch, it lands u[:, cols] and v[cols, :] in shared
//     memory (128-byte swizzle, in 64-column chunks; a last chunk of 32
//     columns is zero-padded to 64), where they stay for every iteration.
//   - Per iteration and chunk j of its columns: S = o @ u_j (wgmma SS, A = o
//     in shared memory, K = d), w_j = bf16(0.01 S) into A fragments, then
//     o_partial += w_j @ v_j (wgmma RS, N = d, B over d / 64 tiles), which
//     reaches the tensor cores just before S_{j+1}. The input w enters pass
//     0 as A fragments straight from global memory; in the last pass w_j
//     goes to `out` instead. Nothing else touches global memory.
//   - o_partial (64 x d, fp32) is reduced across the cluster through
//     distributed shared memory in a fixed order. Units of 8 columns of d
//     are owned round-robin (unit k by rank k % C). Each CTA pushes its
//     partial sums of every unit into the owner's shared memory, in the slot
//     of its own rank, with st.async counted on the owner's mbarrier; the
//     owner adds the slots in rank order, rounds bf16(0.01 sum) and pushes
//     that piece of o into the o tile of every CTA (st.async, counted on
//     each one's o barrier). A CTA waits for its whole o, then starts the
//     next iteration's products. The same bits on every launch; no cluster
//     barrier inside the loop, so two warpgroups of a CTA (two row blocks)
//     run their exchanges independently and one's products fill the other's
//     waits.
//   - Buffer reuse needs no barrier: a peer rewrites a slot or an o tile only
//     after the exchange that read it has completed (its next partial sums
//     need the o that the owner sent after reading the slots, and the owners'
//     next o needs every CTA's partial sums, sent after its products).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int WG = 128;    // threads of a warpgroup
constexpr int MB = 64;     // rows of w per warpgroup: the wgmma M
constexpr int CW = 64;     // columns of n per chunk: one 128-byte swizzled row
constexpr int UNIT = 8;    // columns of d per unit of the reduction: 16 bytes of o
constexpr int SMEM_MAX = 231424;  // dynamic shared memory: 227 KB less 1 KB for the static

// Shared memory of a CTA (ops/mma_pair.py `smem_bytes` computes the same): 1
// KB to align, the u and v slices ([chunks][d][128 B] each), and per
// warpgroup its o tile ([d / 64][64][128 B]) and the slots of its owned
// units ([C][units][64][8] fp32).
__host__ __device__ constexpr int chunks(int nc) { return (nc + CW - 1) / CW; }
__host__ __device__ constexpr int units_max(int d, int c) { return (d / UNIT + c - 1) / c; }
__host__ __device__ constexpr int smem_bytes(int d, int c, int g, int nc) {
  return 1024 + 2 * chunks(nc) * d * 128 + g * d * 128 + g * c * units_max(d, c) * MB * UNIT * 4;
}

// One cluster of C CTAs per G row blocks of 64; CTA `rank` owns columns
// [rank nc, (rank + 1) nc) of n; warpgroup g takes row block
// (cluster index) G + g.
template <int D, int C, int G>
__global__ void __launch_bounds__(G * WG, 1) pair_kernel(
    const __grid_constant__ CUtensorMap umap, const __grid_constant__ CUtensorMap vmap,
    const bf16* __restrict__ w, bf16* __restrict__ out, int rows, int n, int iters) {
  constexpr int KD = D / 16;  // k16 steps over d
  constexpr int UM = units_max(D, C);
  constexpr int SLOT = UM * MB * UNIT;  // floats of one sender's slot
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t load_bar, red_bar[G], o_bar[G];

  const int nc = n / C, nch = chunks(nc);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int wg = threadIdx.x / WG, t = threadIdx.x % WG;
  const int block = (blockIdx.x / C) * G + wg;
  const bool active = block * MB < rows;
  const int col0 = rank * nc;
  uint8_t* us = hopper::align1024(smem_raw);     // [nch][D][128 B]: u[:, chunk]
  uint8_t* vs = us + nch * D * 128;              // [nch][D / 64][64][128 B]: v[chunk, :]
  uint8_t* os = vs + nch * D * 128 + wg * D * 128;  // this warpgroup's o
  float* red = reinterpret_cast<float*>(vs + nch * D * 128 + G * D * 128) + wg * C * SLOT;
  const int my_units = rank < D / UNIT ? (D / UNIT - rank + C - 1) / C : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&load_bar, 1);
    for (int g = 0; g < G; ++g) {
      hopper::mbar_init(&red_bar[g], 1);
      hopper::mbar_init(&o_bar[g], 1);
    }
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(&load_bar, 2 * nch * D * 128);
    for (int ch = 0; ch < nch; ++ch) {
      hopper::tma_load_2d(us + ch * D * 128, &umap, &load_bar, col0 + ch * CW, 0);
      for (int e = 0; e < D / 64; ++e)
        hopper::tma_load_2d(vs + (ch * (D / 64) + e) * 8192, &vmap, &load_bar, e * 64,
                            col0 + ch * CW);
    }
  }
  __syncthreads();
  hopper::cluster_arrive();  // this CTA's barriers are set

  // a last chunk of 32 columns: columns 32..63 of its u tile and rows 32..63
  // of its v tiles (a neighbour's, or past n) become zeros, so that the
  // chunk's 64-wide products add nothing for them
  hopper::mbar_wait(&load_bar, 0);
  const int nv_last = nc - (nch - 1) * CW;
  if (nv_last < CW) {
    uint8_t* ul = us + (nch - 1) * D * 128;
    uint8_t* vl = vs + (nch - 1) * D * 128;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < D * 4; i += G * WG) {
      const int r = i / 4, c = 4 + i % 4;
      *reinterpret_cast<uint4*>(ul + r * 128 + ((c ^ (r & 7)) * 16)) = zero;
    }
    for (int i = threadIdx.x; i < (D / 64) * 32 * 8; i += G * WG)
      *reinterpret_cast<uint4*>(vl + (i / 256) * 8192 + (32 + (i / 8) % 32) * 128 + (i % 8) * 16) =
          zero;
    hopper::fence_proxy_async();  // generic writes, read by wgmma
  }
  __syncthreads();
  hopper::cluster_wait();  // every CTA's barriers are set before the first st.async

  if (active) {
    const int warp = t / 32, lane = t % 32, g8 = lane / 4, q = lane % 4;
    const int64_t r0 = static_cast<int64_t>(block) * MB + 16 * warp + g8;  // rows r0, r0 + 8
    const uint32_t red_local = hopper::smem_u32(red), o_local = hopper::smem_u32(os);
    const uint32_t red_bar_local = hopper::smem_u32(&red_bar[wg]);
    const uint32_t o_bar_local = hopper::smem_u32(&o_bar[wg]);
    float acc[D / 2];  // o_partial: rows r0 (+ 8), columns 8j + 2q (+ 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;  // overwritten by each pass's first product
    auto udesc = [&](int ch) { return hopper::desc_sw128(us + ch * D * 128, 1024, 1024); };
    auto vdesc = [&](int ch) { return hopper::desc_sw128(vs + ch * D * 128, 8192, 1024); };
    // S_j = o @ u_j: the SS product over K = d, issued and committed
    auto issue_s = [&](int ch, float (&s)[32]) {
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        hopper::wgmma_ss_n64<1>(s, hopper::desc_k_major(os + (kk / 4) * 8192) + 2 * (kk % 4),
                                udesc(ch) + 128 * kk, kk > 0);
      hopper::wgmma_commit();
    };
    // w_j = bf16(0.01 S_j) as the RS product's A fragments
    auto round_s = [&](float (&s)[32], uint32_t (&a)[4][4]) {
      hopper::fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a[j / 2][(j % 2) * 2 + 0] = hopper::pack_bf16(s[4 * j] * 0.01f, s[4 * j + 1] * 0.01f);
        a[j / 2][(j % 2) * 2 + 1] = hopper::pack_bf16(s[4 * j + 2] * 0.01f, s[4 * j + 3] * 0.01f);
      }
    };
    // o_partial (+)= w_j @ v_j, issued and committed
    auto issue_o = [&](int ch, uint32_t (&a)[4][4]) {
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs<D, 1>(acc, a[kk], vdesc(ch) + 128 * kk, ch > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::fence_regs(a);
    };
    // w_j to `out` (the last pass), the slice's valid columns only
    auto store_w = [&](int ch, const uint32_t (&a)[4][4]) {
      const int nv = min(CW, nc - ch * CW);
      bf16* p0 = out + r0 * n + col0 + ch * CW + 2 * q;
      bf16* p1 = p0 + 8 * static_cast<int64_t>(n);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j * 8 < nv) {
          *reinterpret_cast<uint32_t*>(p0 + j * 8) = a[j / 2][(j % 2) * 2 + 0];
          *reinterpret_cast<uint32_t*>(p1 + j * 8) = a[j / 2][(j % 2) * 2 + 1];
        }
      }
    };
    // One pass over the chunks. S_j waits for every earlier product, but
    // w_j @ v_j and S_{j+1} reach the tensor cores back to back.
    auto pass = [&](bool last) {
      for (int ch = 0; ch < nch; ++ch) {
        float s[32];
        uint32_t a[4][4];
        issue_s(ch, s);
        hopper::wgmma_wait<0>();  // also the previous chunk's RS product
        round_s(s, a);
        if (last) store_w(ch, a);
        else issue_o(ch, a);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    };

    // pass 0: o_partial = w[rows, my columns] @ v[my columns, :], w's A
    // fragments from global memory (zero past the slice's last valid column)
    for (int ch = 0; ch < nch; ++ch) {
      const int nv = min(CW, nc - ch * CW);
      const bf16* w0 = w + r0 * n + col0 + ch * CW + 2 * q;
      const bf16* w1 = w0 + 8 * static_cast<int64_t>(n);
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bool in = kk * 16 < nv;
        a[kk][0] = in ? *reinterpret_cast<const uint32_t*>(w0 + kk * 16) : 0u;
        a[kk][1] = in ? *reinterpret_cast<const uint32_t*>(w1 + kk * 16) : 0u;
        a[kk][2] = in ? *reinterpret_cast<const uint32_t*>(w0 + kk * 16 + 8) : 0u;
        a[kk][3] = in ? *reinterpret_cast<const uint32_t*>(w1 + kk * 16 + 8) : 0u;
      }
      issue_o(ch, a);
      hopper::wgmma_wait<0>();  // a is loaded anew for the next chunk
    }
    hopper::fence_regs(acc);

    for (int k = 0; k < iters; ++k) {
      // exchange k: o_partial -> o(k + 1) in every CTA's o tile
      if (t == 0) {
        if (my_units) hopper::mbar_arrive_expect_tx(&red_bar[wg], C * my_units * MB * UNIT * 4);
        hopper::mbar_arrive_expect_tx(&o_bar[wg], D * MB * 2);
      }
      // unit j (columns 8j..8j+7) to rank j % C, its unit j / C, slot `rank`
#pragma unroll
      for (int j = 0; j < D / UNIT; ++j) {
        const uint32_t bar = hopper::mapa(red_bar_local, j % C);
        const uint32_t dst = hopper::mapa(
            red_local + (((rank * UM + j / C) * MB + 16 * warp + g8) * UNIT + 2 * q) * 4, j % C);
        hopper::st_async_v2(dst, acc[4 * j], acc[4 * j + 1], bar);
        hopper::st_async_v2(dst + 8 * UNIT * 4, acc[4 * j + 2], acc[4 * j + 3], bar);
      }
      if (my_units) {
        hopper::mbar_wait_cluster(&red_bar[wg], k & 1);
        for (int i = t; i < my_units * 2 * MB; i += WG) {
          const int lu = i / (2 * MB), row = (i / 2) % MB, half = i % 2;
          const float* src = red + (lu * MB + row) * UNIT + half * 4;
          float4 s = *reinterpret_cast<const float4*>(src);
#pragma unroll
          for (int p = 1; p < C; ++p) {  // rank order
            const float4 x = *reinterpret_cast<const float4*>(src + p * SLOT);
            s.x += x.x;
            s.y += x.y;
            s.z += x.z;
            s.w += x.w;
          }
          const uint32_t lo = hopper::pack_bf16(s.x * 0.01f, s.y * 0.01f);
          const uint32_t hi = hopper::pack_bf16(s.z * 0.01f, s.w * 0.01f);
          const int unit = rank + C * lu, e = unit / 8, c = unit % 8;
          const uint32_t dst = o_local + e * 8192 + row * 128 + ((c ^ (row & 7)) * 16) + half * 8;
#pragma unroll
          for (int p = 0; p < C; ++p)
            hopper::st_async_v2_b32(hopper::mapa(dst, p), lo, hi, hopper::mapa(o_bar_local, p));
        }
      }
      hopper::mbar_wait_cluster(&o_bar[wg], k & 1);
      hopper::fence_proxy_async();  // o came by st.async; wgmma reads it
      hopper::named_bar_sync(1 + wg, WG);

      pass(k + 1 == iters);  // pass k + 1; the last one writes w to `out`
    }
  }
  // no CTA leaves while a peer may still write into its shared memory
  hopper::cluster_arrive();
  hopper::cluster_wait();
}

template <int D, int C, int G>
int launch(const CUtensorMap* um, const CUtensorMap* vm, const bf16* w, bf16* out, int rows,
           int n, int iters, cudaStream_t s, int* max_clusters) {
  auto kernel = pair_kernel<D, C, G>;
  const int smem = smem_bytes(D, C, G, n / C);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed = 0;  // the instantiation's dynamic shared memory limit so far
  if (smem > allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && C > 8)  // clusters above 8 CTAs are not portable
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((rows + MB * G - 1) / (MB * G)) * C);
  cfg.blockDim = dim3(G * WG);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg));
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, *um, *vm, w, out, rows, n, iters));
}

// The launches of ops/mma_pair.py `LAUNCHES`, and no others: (d, cluster,
// rows per CTA).
int dispatch(int d, int cluster, int rows_per_cta, const CUtensorMap* um, const CUtensorMap* vm,
             const bf16* w, bf16* out, int rows, int n, int iters, cudaStream_t s,
             int* max_clusters) {
  if (rows <= 0 || rows % MB || n <= 0 || iters < 1 || cluster <= 0 || n % cluster ||
      (n / cluster) % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto is = [&](int dd, int c, int m) {
    return d == dd && cluster == c && rows_per_cta == m;
  };
  if (is(64, 4, 256)) return launch<64, 4, 4>(um, vm, w, out, rows, n, iters, s, max_clusters);
  if (is(64, 8, 64)) return launch<64, 8, 1>(um, vm, w, out, rows, n, iters, s, max_clusters);
  if (is(128, 8, 128)) return launch<128, 8, 2>(um, vm, w, out, rows, n, iters, s, max_clusters);
  if (is(128, 8, 64)) return launch<128, 8, 1>(um, vm, w, out, rows, n, iters, s, max_clusters);
  if (is(128, 16, 128))
    return launch<128, 16, 2>(um, vm, w, out, rows, n, iters, s, max_clusters);
  if (is(256, 16, 64)) return launch<256, 16, 1>(um, vm, w, out, rows, n, iters, s, max_clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// w (rows, n), v (n, d), u (d, n), out (rows, n): contiguous bf16, 16-byte
// aligned. The plan (ops/mma_pair.py `plan`): `cluster` CTAs split n, so
// n / cluster is a multiple of 32, and a CTA takes `rows_per_cta` rows: one
// of the launches `dispatch` lists; rows a multiple of 64, iters >= 1.
// Returns the launch's error (0 when the kernel was accepted),
// cudaErrorInvalidValue for what it does not take, or hopper::kEncodeError +
// the CUresult.
extern "C" int wf_mma_pair(const void* w, const void* v, const void* u, void* out, int rows,
                           int n, int d, int iters, int cluster, int rows_per_cta, void* stream) {
  CUtensorMap um, vm;
  if (d != 64 && d != 128 && d != 256) return static_cast<int>(cudaErrorInvalidValue);
  int err = hopper::encode_2d(&um, u, 2, d, n, d, CW, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) err = hopper::encode_2d(&vm, v, 2, n, d, CW, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  return dispatch(d, cluster, rows_per_cta, &um, &vm, static_cast<const bf16*>(w),
                  static_cast<bf16*>(out), rows, n, iters, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// How many clusters of the plan's launch can be resident on the card at
// once (cudaOccupancyMaxActiveClusters) into *count; returns 0 or the
// error, as wf_mma_pair.
extern "C" int wf_mma_pair_max_clusters(int rows, int n, int d, int cluster, int rows_per_cta,
                                        int* count) {
  *count = 0;
  return dispatch(d, cluster, rows_per_cta, nullptr, nullptr, nullptr, nullptr, rows, n, 1,
                  nullptr, count);
}
