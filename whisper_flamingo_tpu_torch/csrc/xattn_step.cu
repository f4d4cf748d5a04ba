// The decode loop's cached cross-attention: the rows of a (slab row, head)
// against a static, head-split, pre-scaled K/V slab (the audio features'
// slabs and the gated conditioning streams' slabs of `init_cache`).
//
// It replaces no TPU kernel: the JAX package leaves this attention to XLA,
// and the port ran it as plain PyTorch (ops/attention.py `_attend`), whose
// fp32 logits took a SIMT fp32 GEMM over K slabs kept in fp32 and seven
// more launches (the q upcast, the mask add, the softmax, the weights'
// cast, the V product, the head merge). It was added because that chain
// took about a third of the device time of a beam step of the AV model.
// The contract is `_attend`'s for `xa_qkv_attention`:
//   - q is split into heads and scaled by d_head^-0.25 in the compute
//     dtype (rounded to it);
//   - the logits are fp32: QK^T of compute-dtype operands accumulated in
//     fp32 (a product of two bf16 or fp16 values is exact in fp32, so only
//     the order of summation differs from the upcast product); the
//     additive key mask is added to them;
//   - the softmax is fp32 over all the keys; the weights are normalised,
//     rounded to the compute dtype, then multiplied by V with fp32
//     accumulation; the output is head-merged (B, M, D) in the compute
//     dtype.
//
// What bounds it: each K and V element is read once and takes two
// multiply-adds a query row, and the rows of a slab are few (15 beams of a
// beam step, one request in serving, a prompt in a prefill), so the kernel
// is bound by bytes: at the AV beam step (8 slab rows x 20 heads x 1,500
// keys x 64, bf16) 61.4 MB a layer, 18.3 us at 3.35 TB/s.
//
// Design for Hopper:
//   - beam groups: one cluster per (slab row, head, 16 query rows) loads q
//     once and streams the slab's K and V once for all the rows that share
//     it (G beams x t tokens: the 15 of a beam step in one block), so the
//     slab is read once a step and not once a beam; more rows (a prefill)
//     take more blocks, which read the slab again from L2;
//   - the keys are split over the CTAs of a thread-block cluster (1 to 8,
//     chosen by the wrapper from the grid it would otherwise have), each
//     CTA taking whole 64-key tiles; a CTA streams its K tiles, then its V
//     tiles, through one ring of 8 KB stages by 16-byte cp.async (the V
//     tiles enter the ring while the last K tiles are consumed);
//   - QK^T and PV run on tensor cores, mma.sync m16n8k16 with ldmatrix
//     from the 128-byte-swizzled tiles; warp w takes keys 16w..16w+15 of
//     every tile in both products, so each thread keeps its own fp32
//     logits (in shared memory, any number of keys) and a running max and
//     sum of exp of its rows; these merge over the warps, then once over
//     the cluster through distributed shared memory, every CTA in rank
//     order, so all agree; each thread then turns its logits into the
//     normalised weights, rounded to the compute dtype, as PV's A
//     fragments: each exp is taken once for the sum and once for the
//     weight, by the thread that holds the logit;
//   - the warps' partial outputs are summed in order, then pushed into the
//     CTA that owns their columns and summed there in rank order: no float
//     atomics, reruns are bit-equal;
//   - key tiles that the mask holds wholly at -inf are not loaded (their
//     weights are exactly 0): a gated slab held at its 448-key capacity
//     is read only as far as the batch's longest stream;
//   - nothing depends on a host value that changes between steps, so the
//     launch is captured in the decode step's CUDA graphs.

#include "hopper.cuh"

#include <cuda_fp16.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int DH = 64;                     // d_head (every released Whisper size)
constexpr int TK = 64;                     // keys a tile
constexpr int NT = 128;                    // threads
constexpr int NW = NT / 32;                // warps
constexpr int STAGES = 2;                  // the K/V ring (deeper: fewer blocks an SM)
constexpr int TILE_BYTES = TK * DH * 2;    // one tile of K or V, 8 KB
constexpr int SMEM_MAX = 232448;           // a block's dynamic shared memory on an H100

struct Args {
  const void* q;      // (B, M, D) unscaled, compute dtype
  const void* k;      // (B, H, Tk, 64) pre-scaled, compute dtype
  const void* v;      // (B, H, Tk, 64)
  const float* mask;  // additive key mask, row b at b * mask_b, or null
  void* out;          // (B, M, D)
  long long mask_b;
  int m;              // query rows a slab row
  int tk;             // keys
  int heads;
  int tpc;            // key tiles a CTA
  float scale;        // d_head^-0.25
};

// The shared memory of one CTA, in bytes from the (128-aligned) base, for
// `tpc` key tiles: the ring (after the PV product, the warps' partial
// outputs), q, the CTA's mask values, the fp32 logits (a row pitch of
// kc + 8 floats: a half-warp's fragment writes fall in distinct banks), the
// partial outputs the cluster pushes (16 x 64 floats), each warp's row
// statistics, the CTA's and the cluster's, and the live tiles.
struct Layout {
  int ring, q, mask, logit, part, wstat, stat, live, total, pitch;
  __host__ __device__ explicit Layout(int tpc) {
    const int kc = tpc * TK;
    pitch = kc + 8;
    ring = 0;
    q = ring + STAGES * TILE_BYTES;
    mask = q + 16 * DH * 2;
    logit = mask + kc * 4;
    part = logit + 16 * pitch * 4;
    wstat = part + 16 * DH * 4;
    stat = wstat + NW * 16 * 2 * 4;
    live = stat + 4 * 16 * 4;
    total = live + (tpc + 1) * 4;
  }
};
static_assert(STAGES * TILE_BYTES >= NW * 16 * DH * 4, "the ring holds the warps' partials");

template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&p);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Ty<__half> {
  static __device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 p = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&p);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  // 16 bytes, or 16 zero bytes (source size 0) past the keys
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}
__device__ __forceinline__ void st_cluster_v2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_size() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  hopper::cluster_arrive();
  hopper::cluster_wait();
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// The running max and sum of exp of a row, merged with another's.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  s = (m == -INFINITY ? 0.f : s * expf(m - mx)) + (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mx));
  m = mx;
}

// Grid (cluster, heads, slab rows x 16-row query blocks), cluster
// (cluster, 1, 1). Warp w takes keys 16w..16w+15 of every tile, in both
// products: its logits stay its own from QK^T to PV.
template <typename T>
__global__ void __launch_bounds__(NT) xattn_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int rank = cluster_rank(), csize = cluster_size();
  const int h = blockIdx.y;
  const int mblocks = (a.m + 15) / 16;
  const int b = blockIdx.z / mblocks, m0 = (blockIdx.z % mblocks) * 16;
  const int rows = min(16, a.m - m0);
  const int d = a.heads * DH;
  const int kc = a.tpc * TK, key0 = rank * kc;
  const int my_tiles = max(0, min(a.tpc, (a.tk + TK - 1) / TK - rank * a.tpc));

  const Layout L(a.tpc);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t ring = base + L.ring;
  float* mask_s = reinterpret_cast<float*>(smem + L.mask);
  float* logit = reinterpret_cast<float*>(smem + L.logit);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* wstat = reinterpret_cast<float*>(smem + L.wstat);  // [warp][row][max, sum]
  float* lmax = reinterpret_cast<float*>(smem + L.stat);
  float* lsum = lmax + 16;
  float* gmax = lsum + 16;
  float* gsum = gmax + 16;
  int* live = reinterpret_cast<int*>(smem + L.live);
  const int pitch = L.pitch;

  const size_t slab = (static_cast<size_t>(b) * a.heads + h) * a.tk;  // in 128-byte rows
  const uint8_t* kg = static_cast<const uint8_t*>(a.k) + slab * 128;
  const uint8_t* vg = static_cast<const uint8_t*>(a.v) + slab * 128;

  // The mask of this CTA's keys (-inf past the last key); with a mask, the
  // tiles with a key it lets through (without one, every tile: the first
  // loads go out before anything is read).
  const bool masked = a.mask != nullptr;
  for (int j = tid; j < kc; j += NT) {
    const int key = key0 + j;
    mask_s[j] = key >= a.tk ? -INFINITY : (masked ? a.mask[b * a.mask_b + key] : 0.f);
  }
  int nl = my_tiles;
  if (masked) {
    __syncthreads();
    if (warp == 0) {
      int n = 0;
      for (int t = 0; t < my_tiles; ++t) {
        const bool open = mask_s[t * TK + lane] != -INFINITY ||
                          mask_s[t * TK + 32 + lane] != -INFINITY;
        if (__any_sync(0xffffffffu, open)) {
          if (lane == 0) live[n] = t;
          ++n;
        }
      }
      if (lane == 0) live[a.tpc] = n;
    }
    __syncthreads();
    nl = live[a.tpc];
  }

  // Load s of the CTA's 2 * nl: K of live tile s, then V of live tile s - nl.
  auto issue = [&](int s) {
    if (s < 2 * nl) {
      const bool is_k = s < nl;
      const int n = is_k ? s : s - nl;
      const int first = key0 + (masked ? live[n] : n) * TK;
      const uint8_t* src = is_k ? kg : vg;
      const uint32_t dst = ring + (s % STAGES) * TILE_BYTES;
      for (int i = tid; i < TK * 8; i += NT) {
        const int r = i >> 3, c = i & 7;
        const bool in = first + r < a.tk;
        cp_async16(dst + swz(r, c), src + static_cast<size_t>(in ? first + r : 0) * 128 + c * 16,
                   in);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // q: the block's rows of head h scaled and rounded to T, zero past the rows.
  for (int i = tid; i < 16 * 8; i += NT) {
    const int r = i >> 3, c = i & 7;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          static_cast<const T*>(a.q) + (static_cast<size_t>(b) * a.m + m0 + r) * d + h * DH +
          c * 8);
      const T* e = reinterpret_cast<const T*>(&raw);
      w.x = Ty<T>::pack(Ty<T>::to_f(e[0]) * a.scale, Ty<T>::to_f(e[1]) * a.scale);
      w.y = Ty<T>::pack(Ty<T>::to_f(e[2]) * a.scale, Ty<T>::to_f(e[3]) * a.scale);
      w.z = Ty<T>::pack(Ty<T>::to_f(e[4]) * a.scale, Ty<T>::to_f(e[5]) * a.scale);
      w.w = Ty<T>::pack(Ty<T>::to_f(e[6]) * a.scale, Ty<T>::to_f(e[7]) * a.scale);
    }
    *reinterpret_cast<uint4*>(smem + L.q + swz(r, c)) = w;
  }
  __syncthreads();

  uint32_t qa[4][4];  // q's A fragments, 16 rows x 64
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(qa[ks], base + L.q + swz(lane & 15, 2 * ks + (lane >> 4)));

  // QK^T: the logits of the warp's 16 keys of each tile to shared memory,
  // and a running max and sum of exp of its rows g (h = 0) and g + 8.
  float rm[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f};
  int s = 0;
  for (; s < nl; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(s + STAGES - 1);
    const uint32_t st = ring + (s % STAGES) * TILE_BYTES;
    float x[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t kb[4];
      const int key = 16 * warp + ((lane >> 4) << 3) + (lane & 7);
      ldmatrix_x4(kb, st + swz(key, 2 * ks + ((lane >> 3) & 1)));
      Ty<T>::mma(x[0], qa[ks], kb[0], kb[1]);
      Ty<T>::mma(x[1], qa[ks], kb[2], kb[3]);
    }
    const int col = (masked ? live[s] : s) * TK + 16 * warp + 2 * qd;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float2 mk = *reinterpret_cast<const float2*>(mask_s + col + 8 * nt);
      x[nt][0] += mk.x;
      x[nt][1] += mk.y;
      x[nt][2] += mk.x;
      x[nt][3] += mk.y;
      *reinterpret_cast<float2*>(logit + g * pitch + col + 8 * nt) = make_float2(x[nt][0], x[nt][1]);
      *reinterpret_cast<float2*>(logit + (g + 8) * pitch + col + 8 * nt) =
          make_float2(x[nt][2], x[nt][3]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* v0 = x[0] + 2 * hf;
      const float* v1 = x[1] + 2 * hf;
      const float nm = fmaxf(rm[hf], fmaxf(fmaxf(v0[0], v0[1]), fmaxf(v1[0], v1[1])));
      if (nm != -INFINITY) {
        rs[hf] = rs[hf] * expf(rm[hf] - nm) + ((expf(v0[0] - nm) + expf(v0[1] - nm)) +
                                               (expf(v1[0] - nm) + expf(v1[1] - nm)));
        rm[hf] = nm;
      }
    }
  }

  // The softmax's statistics: merged over a row's four lanes, then over the
  // warps in order, then over the cluster's CTAs in rank order (every CTA
  // merges them alike, so all agree).
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    for (int o = 1; o <= 2; o <<= 1)
      merge(rm[hf], rs[hf], __shfl_xor_sync(0xffffffffu, rm[hf], o),
            __shfl_xor_sync(0xffffffffu, rs[hf], o));
  if (qd == 0) {
    wstat[(warp * 16 + g) * 2] = rm[0];
    wstat[(warp * 16 + g) * 2 + 1] = rs[0];
    wstat[(warp * 16 + g + 8) * 2] = rm[1];
    wstat[(warp * 16 + g + 8) * 2 + 1] = rs[1];
  }
  __syncthreads();
  if (tid < 16) {
    float m = -INFINITY, sm = 0.f;
    for (int w = 0; w < NW; ++w) merge(m, sm, wstat[(w * 16 + tid) * 2], wstat[(w * 16 + tid) * 2 + 1]);
    lmax[tid] = m;
    lsum[tid] = sm;
  }
  cluster_sync();
  if (tid < 16) {
    float m = -INFINITY, sm = 0.f;
    for (int p = 0; p < csize; ++p)
      merge(m, sm, ld_cluster_f32(hopper::mapa(hopper::smem_u32(lmax + tid), p)),
            ld_cluster_f32(hopper::mapa(hopper::smem_u32(lsum + tid), p)));
    gmax[tid] = m;
    gsum[tid] = sm;
  }

  // PV over the warp's keys: the weights from its own logits, normalised,
  // rounded to T, as the A fragments; all 64 columns.
  float o[8][4] = {};
  for (; s < 2 * nl; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // (the first pass also publishes gmax and gsum)
    issue(s + STAGES - 1);
    const uint32_t st = ring + (s % STAGES) * TILE_BYTES;
    const int col = (masked ? live[s - nl] : s - nl) * TK + 16 * warp + 2 * qd;
    const float m0r = gmax[g], m1r = gmax[g + 8], s0r = gsum[g], s1r = gsum[g + 8];
    const float2 x00 = *reinterpret_cast<const float2*>(logit + g * pitch + col);
    const float2 x01 = *reinterpret_cast<const float2*>(logit + g * pitch + col + 8);
    const float2 x10 = *reinterpret_cast<const float2*>(logit + (g + 8) * pitch + col);
    const float2 x11 = *reinterpret_cast<const float2*>(logit + (g + 8) * pitch + col + 8);
    const uint32_t pa[4] = {Ty<T>::pack(expf(x00.x - m0r) / s0r, expf(x00.y - m0r) / s0r),
                            Ty<T>::pack(expf(x10.x - m1r) / s1r, expf(x10.y - m1r) / s1r),
                            Ty<T>::pack(expf(x01.x - m0r) / s0r, expf(x01.y - m0r) / s0r),
                            Ty<T>::pack(expf(x11.x - m1r) / s1r, expf(x11.y - m1r) / s1r)};
    const int key = 16 * warp + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, st + swz(key, 2 * j + (lane >> 4)));
      Ty<T>::mma(o[2 * j], pa, vb[0], vb[1]);
      Ty<T>::mma(o[2 * j + 1], pa, vb[2], vb[3]);
    }
  }

  // The warps' partial outputs summed in order through the (now idle)
  // ring, then pushed into their owner: CTA p of the cluster owns the
  // 64 / csize columns from p * 64 / csize and keeps CTA q's partial in its
  // slot q; it sums the slots in rank order.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + L.ring);  // [warp][row][64]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = 8 * nt + 2 * qd;
    *reinterpret_cast<float2*>(red + (warp * 16 + g) * DH + c) = make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(red + (warp * 16 + g + 8) * DH + c) =
        make_float2(o[nt][2], o[nt][3]);
  }
  __syncthreads();
  const int cw = DH / csize;
  {
    const int row = tid >> 3, c0 = (tid & 7) * 8;  // 8 columns a thread
    if (row < rows) {
      float sum[8] = {};
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < 8; ++i) sum[i] += red[(w * 16 + row) * DH + c0 + i];
      const int owner = c0 / cw;
      const uint32_t slot = hopper::mapa(
          hopper::smem_u32(part + (rank * 16 + row) * cw + (c0 - owner * cw)), owner);
#pragma unroll
      for (int i = 0; i < 8; i += 2) st_cluster_v2(slot + 4 * i, sum[i], sum[i + 1]);
    }
  }
  cluster_sync();
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < rows * cw / 2; i += NT) {
    const int row = i / (cw / 2), c = 2 * (i % (cw / 2));
    float x = 0.f, y = 0.f;
    for (int p = 0; p < csize; ++p) {
      const float2 pp = *reinterpret_cast<const float2*>(part + (p * 16 + row) * cw + c);
      x += pp.x;
      y += pp.y;
    }
    *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(b) * a.m + m0 + row) * d + h * DH +
                                 rank * cw + c) = Ty<T>::pack(x, y);
  }
}

// Raises the kernel's dynamic shared-memory limit to SMEM_MAX on the
// current device, once a device (the attribute is the device's, and the
// call is not a stream operation, so a launch under graph capture may make
// it).
template <typename T>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(xattn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T>
int launch(const Args& a, int slabs, int cluster, cudaStream_t s) {
  auto kernel = xattn_kernel<T>;
  const int smem = Layout(a.tpc).total;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t allowed = allow_smem<T>();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, a.heads, slabs * ((a.m + 15) / 16));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int blocks_per_sm(int tpc, int* blocks) {
  *blocks = 0;
  const int smem = Layout(tpc).total;
  if (smem > SMEM_MAX) return 0;
  cudaError_t err = allow_smem<T>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, xattn_kernel<T>, NT, smem);
  return static_cast<int>(err);
}

}  // namespace

// Blocks of `tpc` key tiles a CTA that one SM of the current device holds
// at once, from the runtime's occupancy calculator on the launch's real
// registers, threads and dynamic shared memory; 0 where one block's shared
// memory is more than a block may have. dtype as for wf_xattn_step.
// Returns the CUDA error (0 on success).
extern "C" int wf_xattn_step_blocks_per_sm(int tpc, int dtype, int* blocks) {
  if (dtype == 1) return blocks_per_sm<__nv_bfloat16>(tpc, blocks);
  if (dtype == 2) return blocks_per_sm<__half>(tpc, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 1 = bfloat16, 2 = float16. q (slabs, m, heads * 64), k and v
// (slabs, heads, tk, 64), out like q; mask null or an fp32 key mask with
// row b at b * mask_b. cluster: CTAs splitting the keys (1, 2, 4 or 8),
// each `tpc` 64-key tiles. Returns the launch's error (0 when the kernel
// was accepted).
extern "C" int wf_xattn_step(const void* q, const void* k, const void* v, const float* mask,
                             long long mask_b, void* out, int slabs, int m, int tk, int heads,
                             int cluster, int tpc, float scale, int dtype, void* stream) {
  const Args a{q, k, v, mask, out, mask_b, m, tk, heads, tpc, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster < 1 || cluster > 8 || DH % cluster) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return launch<__nv_bfloat16>(a, slabs, cluster, s);
  if (dtype == 2) return launch<__half>(a, slabs, cluster, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
