// One incremental self-attention step of the decode loop, with the cache
// write done in place.
//
// Replaces the Pallas kernels whisper_flamingo_tpu/ops/decode_attn.py:153
// `_kernel` (one grid step per batch row, per-row offsets) and :211
// `_kernel_multi` (m rows sharing one scalar offset): both are this
// kernel, read with a per-row offset stride of 1 or 0. The numerics are
// the JAX kernels':
//   - the new k is scaled by d_head^-0.25 in the source dtype, then cast
//     to the cache dtype, and its K/V row is written at `offset`;
//   - q is scaled in fp32;
//   - the logits are exact fp32 products summed per head, over the cache
//     positions <= offset only;
//   - the softmax is fp32, the weights are rounded to the compute dtype,
//     and the V sum is fp32; the output is head-merged (B, 1, D).
//
// What bounds it: it reads each cached K/V element of the prefix once and
// does two flops per element, so it is bound by bytes; at the decode
// shapes (8 to 120 rows, a prefix under 448 positions) the prefix is a
// few MB, and at 8 rows a launch is bound by its latency: the chain of
// dependent DRAM round trips inside it, not the bytes.
//
// Design for Hopper: one DRAM round trip. One block per (head, row), so
// each block writes only its own d_head-wide slice of its row's new K/V.
// The prefix (positions <= offset) is cut into chunks of K or V rows:
// chunk 0 of K and of V each have a slot of their own, the later chunks
// (K's, then V's) stream through a small ring, all by 16-byte cp.async,
// the block's threads covering whole rows (one 16-byte piece each,
// neighbouring threads on neighbouring bytes). Everything that fits is
// issued at the start, so a short prefix costs one round trip, and a
// longer one keeps the ring's chunks in flight while the block computes.
// What does not depend on the offset (q, the new row) is read before it.
// The offset comes by value for the lockstep decode loop, or from a device
// int32 tensor (per-row offsets): a step needs no host sync either way.
// The new row is not read back: it is written to the cache and kept in
// shared memory from the new values.
//   - logits: the lanes of a row each dot their piece with q's piece (q
//     in registers) and sum across the row's lanes by shuffles;
//   - max and sum: every warp reduces all the logits (at most t_max, from
//     shared memory) by itself, so no combine is needed; the weights are
//     normalised and rounded to the compute dtype before the V sum, as
//     the contract asks, which is why the V sum waits for the whole
//     softmax and V stays in shared memory meanwhile;
//   - V sum: each thread sums its piece over its rows in fp32; the row
//     groups of a warp combine by shuffles and the warps once through
//     shared memory.
//
// Beam search (the INDIRECT instantiation): a beam's history is spread
// over the physical rows that wrote it, and an int32 table rows (B, t_max)
// names, for each position p < offset of row b, the row that holds it
// (FasterTransformer's cache indirection). The decode loop reorders only
// that table after each beam selection, never the cache. The block stages
// its table row (positions < offset) in shared memory once the offset is
// known, then loads position p from row rows[b, p]; the new K/V row is
// written into its own row b at the offset, as without a table. The loads
// are the same bytes in the same order, so the output is the direct
// kernel's on a cache gathered by the table, bit for bit. The direct
// instantiation reads no table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SMEM_DEFAULT = 48 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

// 16 bytes of T at p (16-byte aligned, global or shared) as fp32.
template <typename T> __device__ __forceinline__ void load16(const T* p, float* f);
template <> __device__ __forceinline__ void load16<float>(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
template <> __device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The work split for element type T at head width DH over NT threads: a
// 16-byte piece holds E elements, a cache row L pieces (one lane each, L
// divides 32), and a pass of the block covers G rows; a chunk of CHUNK
// bytes holds P positions, PASSES passes.
template <typename T, int DH, int NT, int CHUNK>
struct Split {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int L = DH / E;
  static constexpr int G = NT / L;
  static constexpr int P = CHUNK / (DH * (int)sizeof(T));
  static constexpr int PASSES = P / G;
  static_assert(L <= 32 && 32 % L == 0 && PASSES >= 1 && P % G == 0, "unsupported head width");
};

// The two modes, chosen by the host from the grid's size:
//   - latency (few blocks, at most two per SM): 512 threads, so that the
//     block's own arithmetic is spread over 16 warps (one pass of the
//     rows per chunk), 8 KB chunks and a ring of 3; when the offsets are
//     on the device, chunk 0 (positions 0..P-1, whatever the offset) is
//     issued before the offset is read, so a prefix of up to P positions
//     costs one round trip;
//   - throughput (many blocks): 128 threads, 4 KB chunks, a ring of 2,
//     about 19 KB of shared memory a block so that 11 blocks (and their
//     loads) share each SM.
// A scalar offset passed by value (the lockstep decode loop's) is known at
// the start: every load is issued at once, with no byte past the offset.
template <bool LATENCY>
struct Mode {
  static constexpr int NT = LATENCY ? 512 : 128;  // threads per block
  static constexpr int NW = NT / 32;
  static constexpr int CHUNK = LATENCY ? 8192 : 4096;
  static constexpr int STAGES = LATENCY ? 3 : 2;
  static constexpr int MIN_BLOCKS = LATENCY ? 1 : 11;
};

template <bool LATENCY>
constexpr int smem_bytes(int t_max, int dh, int item, bool indirect) {
  return (2 + Mode<LATENCY>::STAGES) * Mode<LATENCY>::CHUNK + 2 * dh * item +
         4 * (Mode<LATENCY>::NW * dh + t_max) + (indirect ? 4 * t_max : 0);
}

// q/kn/vn/out: (B, 1, D); kc/vc: (B, t_max, D) contiguous, rows 16-byte
// aligned (the wrapper checks). DH is the head width (32, 64 or 128).
// INDIRECT: rows (B, t_max) int32, read at positions < offset only.
template <typename T, int DH, bool LATENCY, bool INDIRECT>
__global__ void __launch_bounds__(Mode<LATENCY>::NT, Mode<LATENCY>::MIN_BLOCKS)
    decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kn, const T* __restrict__ vn,
    T* __restrict__ kc, T* __restrict__ vc, const int* __restrict__ offsets,
    int off_stride, int off_scalar, T* __restrict__ out, int t_max, int d, float scale,
    const int* __restrict__ rows_of) {
  constexpr int NT = Mode<LATENCY>::NT, NW = Mode<LATENCY>::NW;
  constexpr int CHUNK = Mode<LATENCY>::CHUNK, STAGES = Mode<LATENCY>::STAGES;
  using S = Split<T, DH, NT, CHUNK>;
  constexpr int E = S::E, L = S::L, G = S::G, P = S::P, PASSES = S::PASSES;
  constexpr int CE = CHUNK / (int)sizeof(T);  // elements per chunk
  extern __shared__ __align__(16) uint8_t smem[];
  T* head_k = reinterpret_cast<T*>(smem);  // chunk 0 of K, then of V
  T* head_v = head_k + CE;
  T* ring = head_v + CE;                   // chunks 1.. of K, then of V
  T* new_k = ring + STAGES * CE;           // the new row's (DH)
  T* new_v = new_k + DH;
  float* part = reinterpret_cast<float*>(new_v + DH);  // (NW, DH) V sums
  float* logit = part + NW * DH;                       // (t_max) logits, then weights
  int* tab = reinterpret_cast<int*>(logit + t_max);    // INDIRECT: (t_max) physical rows

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int li = tid % L;  // this thread's piece of a row
  const int gi = tid / L;  // its row within a pass
  const int64_t tok = (int64_t)b * d + (int64_t)h * DH;
  const int64_t slab = (int64_t)b * t_max * d + (int64_t)h * DH;
  const int64_t piece = li * E;

  // Rows [0, rows) of chunk c of a cache into dst by 16-byte cp.async,
  // the new row `skip` left out; INDIRECT: position p from row tab[p].
  auto stage = [&](T* dst, const T* cache, int c, int rows, int skip) {
    for (int r = gi; r < rows; r += G)
      if (c * P + r != skip) {
        const int p = c * P + r;
        if constexpr (INDIRECT)
          cp_async16(dst + r * DH + piece,
                     cache + ((int64_t)tab[p] * t_max + p) * d + (int64_t)h * DH + piece);
        else
          cp_async16(dst + r * DH + piece, cache + slab + (int64_t)p * d + piece);
      }
  };

  // What does not depend on the offset is read first: q's piece (scaled
  // in fp32), the new K (scaled in the source dtype, cast to the cache's)
  // or V piece, and in latency mode with device offsets chunk 0 of K and V
  // (not through a table: its entries past the offset are not defined).
  const bool speculate = LATENCY && !INDIRECT && offsets != nullptr;
  float qf[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qf[e] = to_f(q[tok + piece + e]) * scale;
  alignas(16) T fresh[E];
  if (tid < 2 * L) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      fresh[e] = tid < L ? from_f<T>(to_f(kn[tok + piece + e]) * scale) : vn[tok + piece + e];
  }
  if (speculate) {  // the row at the offset is read too, and never used
    stage(head_k, kc, 0, min(P, t_max), -1);
    stage(head_v, vc, 0, min(P, t_max), -1);
    cp_async_commit();
  }
  const int off = offsets != nullptr ? offsets[b * off_stride] : off_scalar;
  if (off < 0 || off >= t_max) {  // no write; the row reads NaN downstream
    cp_async_wait<0>();
    for (int c = tid; c < DH; c += NT) out[tok + c] = from_f<T>(NAN);
    return;
  }
  const int n = off + 1;           // positions 0..off
  const int nc = (n + P - 1) / P;  // chunks of K (and as many of V)
  const int nt = 2 * (nc - 1);     // ring tiles: chunks 1.. of K, then of V
  if (tid < 2 * L) {  // the new row, to the cache and beside the chunks
    T* cache = tid < L ? kc : vc;
    *reinterpret_cast<uint4*>(cache + slab + (int64_t)off * d + piece) =
        *reinterpret_cast<const uint4*>(fresh);
    *reinterpret_cast<uint4*>((tid < L ? new_k : new_v) + piece) =
        *reinterpret_cast<const uint4*>(fresh);
  }
  if constexpr (INDIRECT) {  // the table row, before any load goes through it
    for (int j = tid; j < off; j += NT) tab[j] = rows_of[(int64_t)b * t_max + j];
    __syncthreads();
  }
  if (!speculate) {
    stage(head_k, kc, 0, min(P, n), off);
    stage(head_v, vc, 0, min(P, n), off);
    cp_async_commit();
  }
  // Ring tile i into its slot, then a commit (an empty group past the last
  // tile, so that a wait for tile i always has STAGES - 1 younger groups).
  auto issue = [&](int i) {
    if (i < nt) {
      const bool is_v = i >= nc - 1;
      const int c = (is_v ? i - (nc - 1) : i) + 1;
      stage(ring + (i % STAGES) * CE, is_v ? vc : kc, c, min(P, n - c * P), off);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES; ++i) issue(i);

  // logits of chunk c from its staged rows: the chunk's PASSES passes of
  // G rows each, their loads and products first, then their shuffles
  // across each row's lanes side by side (every lane takes part)
  auto logits = [&](const T* rows_k, int c) {
    const int rows = min(P, n - c * P);
    float a[PASSES];
#pragma unroll
    for (int k = 0; k < PASSES; ++k) {
      const int r = k * G + gi;
      a[k] = 0.f;
      if (r < rows) {
        float kf[E];
        load16((c * P + r == off ? new_k : rows_k + r * DH) + piece, kf);
#pragma unroll
        for (int e = 0; e < E; ++e) a[k] = fmaf(kf[e], qf[e], a[k]);
      }
    }
#pragma unroll
    for (int s = 1; s < L; s <<= 1)
#pragma unroll
      for (int k = 0; k < PASSES; ++k) a[k] += __shfl_xor_sync(0xffffffffu, a[k], s);
    if (li == 0) {
#pragma unroll
      for (int k = 0; k < PASSES; ++k)
        if (k * G + gi < rows) logit[c * P + k * G + gi] = a[k];
    }
  };
  float acc[E];  // this thread's piece of the V sum
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  auto v_sum = [&](const T* rows_v, int c) {
    const int rows = min(P, n - c * P);
#pragma unroll
    for (int k = 0; k < PASSES; ++k) {
      const int r = k * G + gi;
      if (r < rows) {
        const float w = logit[c * P + r];
        float vf[E];
        load16((c * P + r == off ? new_v : rows_v + r * DH) + piece, vf);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(w, vf[e], acc[e]);
      }
    }
  };

  cp_async_wait<STAGES>();  // chunk 0
  __syncthreads();
  logits(head_k, 0);
  for (int i = 0; i < nc - 1; ++i) {
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    logits(ring + (i % STAGES) * CE, i + 1);
    if (i + STAGES < nt) __syncthreads();  // the slot is refilled
    issue(i + STAGES);
  }
  __syncthreads();  // every logit is in

  // softmax: each warp reduces every logit (position `off` is there, so
  // the max is finite); then the weights, rounded to the compute dtype,
  // replace the logits
  float mx = -INFINITY;
  for (int j = lane; j < n; j += 32) mx = fmaxf(mx, logit[j]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < n; j += 32) sum += expf(logit[j] - mx);
  sum = warp_sum(sum);
  __syncthreads();
  for (int j = tid; j < n; j += NT) logit[j] = to_f(from_f<T>(expf(logit[j] - mx) / sum));
  __syncthreads();

  // weighted V sum: thread (gi, li) sums piece li of rows gi, gi + G, ...
  v_sum(head_v, 0);
  for (int i = nc - 1; i < nt; ++i) {
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    v_sum(ring + (i % STAGES) * CE, i - (nc - 1) + 1);
    if (i + STAGES < nt) __syncthreads();
    issue(i + STAGES);
  }
#pragma unroll
  for (int s = L; s < 32; s <<= 1)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], s);
  if (lane < L) {
#pragma unroll
    for (int e = 0; e < E; ++e) part[warp * DH + piece + e] = acc[e];
  }
  __syncthreads();
  for (int c = tid; c < DH; c += NT) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) tot += part[w * DH + c];
    out[tok + c] = from_f<T>(tot);
  }
}

// The launch arguments shared by every instantiation.
struct Args {
  const void *q, *kn, *vn;
  void *kc, *vc;
  const int* offsets;
  int off_stride, off_scalar;
  void* out;
  int batch, t_max, d;
  float scale;
  const int* rows;
};

template <typename T, int DH, bool LATENCY, bool INDIRECT>
int launch_dh(const Args& a, cudaStream_t s) {
  const int smem = smem_bytes<LATENCY>(a.t_max, DH, (int)sizeof(T), INDIRECT);
  auto kernel = decode_attn_kernel<T, DH, LATENCY, INDIRECT>;
  if (smem > SMEM_DEFAULT)  // long caches only (t_max above ~600)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<dim3(a.d / DH, a.batch), Mode<LATENCY>::NT, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kn), static_cast<const T*>(a.vn),
      static_cast<T*>(a.kc), static_cast<T*>(a.vc), a.offsets, a.off_stride, a.off_scalar,
      static_cast<T*>(a.out), a.t_max, a.d, a.scale, a.rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool LATENCY, bool INDIRECT>
int launch(const Args& a, int n_head, cudaStream_t s) {
  switch (a.d / n_head) {
    case 32:
      return launch_dh<T, 32, LATENCY, INDIRECT>(a, s);
    case 64:
      return launch_dh<T, 64, LATENCY, INDIRECT>(a, s);
    case 128:
      return launch_dh<T, 128, LATENCY, INDIRECT>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool INDIRECT>
int launch_dtype(const Args& a, int n_head, int dtype, int latency, cudaStream_t s) {
  if (dtype == 0)
    return latency ? launch<float, true, INDIRECT>(a, n_head, s)
                   : launch<float, false, INDIRECT>(a, n_head, s);
  if (dtype == 1)
    return latency ? launch<__nv_bfloat16, true, INDIRECT>(a, n_head, s)
                   : launch<__nv_bfloat16, false, INDIRECT>(a, n_head, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dynamic shared memory of one launch, in bytes: chunk 0 of K and V, the
// ring, the new row, the V sum's per-warp partials, the logits and, with a
// row table, its row. The wrapper computes the same in Python
// (ops/decode_attn.py smem_bytes); the card tests hold the two equal.
extern "C" int wf_decode_attn_smem_bytes(int t_max, int dh, int item, int latency, int indirect) {
  return latency ? smem_bytes<true>(t_max, dh, item, indirect)
                 : smem_bytes<false>(t_max, dh, item, indirect);
}

// dtype: 0 = float32, 1 = bfloat16. `offsets` is a device int32 array read
// at b * off_stride (off_stride 0: one offset for every row), or null: then
// every row's offset is `off_scalar`. d_head = d / n_head must be 32, 64
// or 128. latency: 1 for the latency mode (a grid of at most two blocks
// per SM), 0 for the throughput mode. `rows`: null, or the beam search's
// device int32 (B, t_max) row table; entry (b, p) for p < b's offset names
// a row whose position p is written and is not written by this launch.
// Returns the launch's cudaGetLastError() (0 when the kernel was accepted).
extern "C" int wf_decode_attn_step(const void* q, const void* kn, const void* vn, void* kc,
                                   void* vc, const void* offsets, int off_stride,
                                   int off_scalar, void* out, int batch, int t_max, int d,
                                   int n_head, float scale, int dtype, int latency,
                                   const void* rows, void* stream) {
  const Args a{q,   kn,    vn,    kc, vc, static_cast<const int*>(offsets), off_stride, off_scalar,
               out, batch, t_max, d,  scale, static_cast<const int*>(rows)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.rows != nullptr ? launch_dtype<true>(a, n_head, dtype, latency, s)
                           : launch_dtype<false>(a, n_head, dtype, latency, s);
}
