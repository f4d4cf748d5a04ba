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
// Design for Hopper. One block per (head, row): each block writes only its
// own d_head-wide slice of its row's new K/V, so no two blocks touch the
// same bytes, and the block takes the new row's values from shared memory
// instead of reading back what it wrote. It reads only the positions
// <= offset (the TPU kernel streamed the whole T_max slab). The offsets
// come from a device int32 tensor, so a step needs no host sync.
//
// What bounds it: it reads each cached K/V element of the prefix once and
// does two flops per element, so it is bound by bytes; at the decode
// shapes (8 to 120 rows, a prefix under 448 positions) the prefix is a
// few MB and a launch is dominated by its latency, which is why the whole
// chain (write, logits, softmax, V sum) is one launch, and why the loops
// keep many loads in flight: the logits take one thread per position,
// reading its K row in 16-byte pieces, and the V sum has each warp read
// whole rows (2 lanes a thread) over an unrolled loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;

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

// Every thread returns the block-wide result; `red` is free again on return.
__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) r += red[i];
  __syncthreads();
  return r;
}

// 16 bytes of T from p (16-byte aligned) as fp32, and 2 elements of T.
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
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// q/kn/vn/out: (B, 1, D); kc/vc: (B, t_max, D) contiguous, rows 16-byte
// aligned (the wrapper checks). DH is the head width (32, 64 or 128).
template <typename T, int DH>
__global__ void __launch_bounds__(NT) decode_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ kn, const T* __restrict__ vn,
    T* __restrict__ kc, T* __restrict__ vc, const int* __restrict__ offsets,
    int off_stride, T* __restrict__ out, int t_max, int d, float scale) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int TPR = DH / 2;        // V sum: threads per cache row, 2 lanes each
  constexpr int G = NT / TPR;        // V sum: position groups
  extern __shared__ float sm[];
  float* w = sm;            // (t_max) logits, then weights
  float* qs = w + t_max;    // (DH) q * scale, fp32
  float* kns = qs + DH;     // (DH) new K row (scaled, cache dtype), as fp32
  float* vns = kns + DH;    // (DH) new V row
  float* part = vns + DH;   // (G * DH) partial V sums
  __shared__ float red[NW];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int off = offsets[b * off_stride];
  const int64_t tok = (int64_t)b * d + (int64_t)h * DH;
  const int64_t slab = (int64_t)b * t_max * d + (int64_t)h * DH;

  if (off < 0 || off >= t_max) {  // no write; the row reads NaN downstream
    for (int c = tid; c < DH; c += NT) out[tok + c] = from_f<T>(NAN);
    return;
  }

  for (int c = tid; c < DH; c += NT) {
    qs[c] = to_f(q[tok + c]) * scale;
    const T kv = from_f<T>(to_f(kn[tok + c]) * scale);
    const T vv = vn[tok + c];
    kns[c] = to_f(kv);
    vns[c] = to_f(vv);
    kc[slab + (int64_t)off * d + c] = kv;
    vc[slab + (int64_t)off * d + c] = vv;
  }
  __syncthreads();

  // logits: one thread per cache position, its K row in 16-byte loads
  for (int j = tid; j <= off; j += NT) {
    float a = 0.f;
    if (j == off) {
#pragma unroll
      for (int c = 0; c < DH; ++c) a += kns[c] * qs[c];
    } else {
      const T* kr = kc + slab + (int64_t)j * d;
      float f[DH];
#pragma unroll
      for (int c0 = 0; c0 < DH; c0 += E) load16(kr + c0, f + c0);
#pragma unroll
      for (int c = 0; c < DH; ++c) a += f[c] * qs[c];
    }
    w[j] = a;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int j = tid; j <= off; j += NT) mx = fmaxf(mx, w[j]);
  mx = block_max(mx, red);  // position `off` is always there: mx is finite
  float sum = 0.f;
  for (int j = tid; j <= off; j += NT) {
    const float e = expf(w[j] - mx);
    w[j] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int j = tid; j <= off; j += NT) w[j] = to_f(from_f<T>(w[j] / sum));
  __syncthreads();

  // weighted V sum: TPR threads cover one row (2 lanes each, coalesced);
  // the G groups split the positions; the new row comes from shared memory
  const int g = tid / TPR, c = (tid % TPR) * 2;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int j = g; j < off; j += G) {
    const float2 v = load2(vc + slab + (int64_t)j * d + c);
    a0 += w[j] * v.x;
    a1 += w[j] * v.y;
  }
  if (g == off % G) {
    a0 += w[off] * vns[c];
    a1 += w[off] * vns[c + 1];
  }
  part[g * DH + c] = a0;
  part[g * DH + c + 1] = a1;
  __syncthreads();
  if (tid < DH) {
    float tot = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) tot += part[gg * DH + tid];
    out[tok + tid] = from_f<T>(tot);
  }
}

template <typename T>
int launch(const void* q, const void* kn, const void* vn, void* kc, void* vc, const int* off,
           int off_stride, void* out, int batch, int t_max, int d, int n_head, float scale,
           size_t smem, cudaStream_t s) {
  const dim3 grid(n_head, batch);
  const T* q_ = static_cast<const T*>(q);
  const T* kn_ = static_cast<const T*>(kn);
  const T* vn_ = static_cast<const T*>(vn);
  T* kc_ = static_cast<T*>(kc);
  T* vc_ = static_cast<T*>(vc);
  T* out_ = static_cast<T*>(out);
  switch (d / n_head) {
    case 32:
      decode_attn_kernel<T, 32><<<grid, NT, smem, s>>>(q_, kn_, vn_, kc_, vc_, off, off_stride,
                                                       out_, t_max, d, scale);
      break;
    case 64:
      decode_attn_kernel<T, 64><<<grid, NT, smem, s>>>(q_, kn_, vn_, kc_, vc_, off, off_stride,
                                                       out_, t_max, d, scale);
      break;
    case 128:
      decode_attn_kernel<T, 128><<<grid, NT, smem, s>>>(q_, kn_, vn_, kc_, vc_, off, off_stride,
                                                        out_, t_max, d, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory the kernel needs, in bytes: logits, q, the new
// K/V row, and the V sum's partials (2 * NT floats for every head width).
extern "C" int wf_decode_attn_smem_bytes(int t_max, int dh) {
  return static_cast<int>((t_max + 3 * dh + 2 * NT) * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16. `offsets` is a device int32 array read
// at b * off_stride (off_stride 0: one scalar offset for every row).
// d_head = d / n_head must be 32, 64 or 128. Returns the launch's
// cudaGetLastError() (0 when the kernel was accepted).
extern "C" int wf_decode_attn_step(const void* q, const void* kn, const void* vn, void* kc,
                                   void* vc, const void* offsets, int off_stride, void* out,
                                   int batch, int t_max, int d, int n_head, float scale,
                                   int dtype, void* stream) {
  const size_t smem = static_cast<size_t>(wf_decode_attn_smem_bytes(t_max, d / n_head));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (dtype == 0)
    return launch<float>(q, kn, vn, kc, vc, off, off_stride, out, batch, t_max, d, n_head,
                         scale, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kn, vn, kc, vc, off, off_stride, out, batch, t_max, d,
                                 n_head, scale, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
