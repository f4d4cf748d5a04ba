// The attention matmul pair looped on the tensor cores: the rate probe of
// flash attention's inner loop at head width d.
//
// Replaces the Pallas kernel of tools/packed_probe2.py:53 (`make_kernel`,
// :39; body `kernel`, :42). The function, `iters` times over w (R, n):
//     o = bf16(0.01 * (w @ v))      v (n, d), fp32 sum over n
//     w = bf16(0.01 * (o @ u))      u (d, n), fp32 sum over d
// and the last w is the output. The probe's R is 512 (its q tile); here R
// is any multiple of the 128-row block, since the rows are independent.
//
// Design for Hopper. The TPU kept w, v and u resident in VMEM; at d 64, v
// and u are 192 KB each and w is 1.5 MB, which fit no SM. The loop is
// flash attention's inner loop without the softmax: a block owns 128 rows
// (8 warps x 16), each warp keeps its rows of o (16 x d) as bf16 A
// fragments in registers (in shared memory at d 256, where registers run
// short), and v and u stream through shared memory in 64-column tiles of
// n (cp.async, two stages; they stay in L2 across blocks and iterations).
// For each tile j, w_j = bf16(0.01 * (o @ u[:, j])) is formed in
// registers (mma.sync.m16n8k16, bf16 in, fp32 accumulate) and at once
// w_j @ v[j, :] is added into the fp32 accumulator of the next o, so w is
// never stored between iterations; it is written once, from the last
// iteration. The rounding points are the probe's. B operands come from the
// row-major tiles through ldmatrix.trans (rows padded by 8 elements:
// conflict-free).
// What bounds it: 4*R*n*d operations per iteration against (R*n + 2*n*d)
// elements read once, so arithmetic; per block and iteration, u and v
// (4*n*d bytes) come again from L2 for 4*128*n*d operations: 128
// operations per L2 byte. No wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;  // rows per block
constexpr int NT = 64;            // columns of n per shared-memory tile
constexpr int UP = NT + 8;        // padded row length of the u tile [d][NT]

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
// tile: lane l gives the address of row (l & 15) of the 16-row chunk at
// column (l >> 4) * 8 of the 16-column pair; r0, r1 are (b0, b1) of the
// first slice, r2, r3 of the second.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The A fragment of a row-major 16 x 16 shared block: lane l gives the
// address of row (l & 15) at column (l >> 4) * 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most one group (the newest prefetch) is still in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int DH>
struct Smem {
  static constexpr int VP = DH + 8;                 // padded row length of the v tile [NT][d]
  static constexpr int U = DH * UP;                 // elements of one u tile
  static constexpr int V = NT * VP;                 // elements of one v tile
  static constexpr bool O_SHARED = DH > 128;        // o in shared memory, not registers
  static constexpr int O = O_SHARED ? ROWS * VP : 0;
  static constexpr int BYTES = (2 * (U + V) + O) * 2;
};

// acc (16 rows x DH, fp32) += A (16 rows x 64 of n, 4 A fragments) x the
// v tile [NT][DH].
template <int DH>
__device__ __forceinline__ void add_times_v(float (&acc)[DH / 8][4], const uint32_t (&a)[4][4],
                                            const bf16* vt, int lane) {
  constexpr int VP = Smem<DH>::VP;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, vt + (kk * 16 + (lane & 15)) * VP + dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// One block per 128 rows of w; warp w owns rows 16w.. of the block. The
// steps walk the n tiles (iters + 1) times: pass 0 forms the first o from
// the input w, passes 1..iters form w_j from o and either add w_j @ v_j
// into the next o or, in the last pass, store w_j.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1) pair_kernel(
    const bf16* __restrict__ w, const bf16* __restrict__ v, const bf16* __restrict__ u,
    bf16* __restrict__ out, int n, int iters) {
  using S = Smem<DH>;
  constexpr int KD = DH / 16;  // 16-deep slices of d
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* us = smem;               // [2][DH][UP]
  bf16* vs = smem + 2 * S::U;    // [2][NT][VP]
  bf16* os = vs + 2 * S::V;      // [ROWS][VP] when O_SHARED

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int64_t r0 = (int64_t)blockIdx.x * ROWS + warp * 16 + g;  // rows r0, r0 + 8
  const int n_tiles = n / NT;
  const int steps = (iters + 1) * n_tiles;

  // step s reads tile s % n_tiles of u (passes 1..iters) and of v (passes
  // 0..iters-1)
  auto stage = [&](int buf, int s) {
    const int j0 = (s % n_tiles) * NT, pass = s / n_tiles;
    if (pass > 0) {
      bf16* dst = us + buf * S::U;
      for (int i = threadIdx.x; i < DH * (NT / 8); i += THREADS) {
        const int r = i / (NT / 8), c8 = (i % (NT / 8)) * 8;
        cp_async16(dst + r * UP + c8, u + (int64_t)r * n + j0 + c8);
      }
    }
    if (pass < iters) {
      bf16* dst = vs + buf * S::V;
      for (int i = threadIdx.x; i < NT * (DH / 8); i += THREADS) {
        const int r = i / (DH / 8), c8 = (i % (DH / 8)) * 8;
        cp_async16(dst + r * S::VP + c8, v + (int64_t)(j0 + r) * DH + c8);
      }
    }
  };

  float acc[DH / 8][4];  // the next o, fp32
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  uint32_t oa[S::O_SHARED ? 1 : KD][4];  // o as A fragments (registers)
  bf16* orow = os + (warp * 16) * S::VP;  // this warp's rows of o (shared)

  stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1, j = s % n_tiles, pass = s / n_tiles;
    if (s + 1 < steps) stage(cur ^ 1, s + 1);  // buffer cur ^ 1 was last read before
    cp_async_commit();                          // the previous step's barrier
    cp_async_wait_prev();
    __syncthreads();
    const bf16* vt = vs + cur * S::V;
    const bf16* ut = us + cur * S::U;

    uint32_t wa[4][4];  // w_j (16 rows x 64) as A fragments
    if (pass == 0) {    // the input w, from global memory
      const bf16* w0 = w + r0 * n + j * NT + 2 * tq;
      const bf16* w1 = w0 + 8 * (int64_t)n;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wa[kk][0] = ld_pair(w0 + kk * 16);
        wa[kk][1] = ld_pair(w1 + kk * 16);
        wa[kk][2] = ld_pair(w0 + kk * 16 + 8);
        wa[kk][3] = ld_pair(w1 + kk * 16 + 8);
      }
    } else {  // w_j = bf16(0.01 * (o @ u_j))
      float sc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        if constexpr (S::O_SHARED) {
          ldsm_x4(a, orow + (lane & 15) * S::VP + kk * 16 + (lane >> 4) * 8);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = oa[kk][e];
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, ut + (kk * 16 + (lane & 15)) * UP + np * 16 + (lane >> 4) * 8);
          mma_bf16(sc[2 * np], a, b[0], b[1]);
          mma_bf16(sc[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        wa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(sc[nt][0] * 0.01f, sc[nt][1] * 0.01f);
        wa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(sc[nt][2] * 0.01f, sc[nt][3] * 0.01f);
      }
    }

    if (pass == iters) {  // the last pass: w_j is the output
      bf16* p0 = out + r0 * n + j * NT + 2 * tq;
      bf16* p1 = p0 + 8 * (int64_t)n;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<uint32_t*>(p0 + nt * 8) = wa[nt / 2][(nt % 2) * 2 + 0];
        *reinterpret_cast<uint32_t*>(p1 + nt * 8) = wa[nt / 2][(nt % 2) * 2 + 1];
      }
    } else {
      add_times_v<DH>(acc, wa, vt, lane);
      if (j == n_tiles - 1) {  // o = bf16(0.01 * acc) for the next pass
#pragma unroll
        for (int dn = 0; dn < DH / 8; ++dn) {
          const uint32_t top = pack_bf16(acc[dn][0] * 0.01f, acc[dn][1] * 0.01f);
          const uint32_t bot = pack_bf16(acc[dn][2] * 0.01f, acc[dn][3] * 0.01f);
          if constexpr (S::O_SHARED) {
            *reinterpret_cast<uint32_t*>(orow + g * S::VP + dn * 8 + 2 * tq) = top;
            *reinterpret_cast<uint32_t*>(orow + (g + 8) * S::VP + dn * 8 + 2 * tq) = bot;
          } else {
            oa[dn / 2][(dn % 2) * 2 + 0] = top;
            oa[dn / 2][(dn % 2) * 2 + 1] = bot;
          }
          acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
        }
        if constexpr (S::O_SHARED) __syncwarp();  // the warp reads its rows next
      }
    }
    __syncthreads();  // buffer cur is refilled next step
  }
}

template <int DH>
int launch(const void* w, const void* v, const void* u, void* out, int rows, int n, int iters,
           cudaStream_t s) {
  const int bytes = Smem<DH>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(pair_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_kernel<DH><<<rows / ROWS, THREADS, bytes, s>>>(
      static_cast<const bf16*>(w), static_cast<const bf16*>(v), static_cast<const bf16*>(u),
      static_cast<bf16*>(out), n, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w (rows, n), v (n, d), u (d, n), out (rows, n): contiguous bf16. rows a
// multiple of 128, n of 64, d in {64, 128, 256}, iters >= 1. Returns the
// launch's cudaGetLastError() (0 when the kernel was accepted).
extern "C" int wf_mma_pair(const void* w, const void* v, const void* u, void* out, int rows,
                           int n, int d, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows % ROWS || n <= 0 || n % NT || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64: return launch<64>(w, v, u, out, rows, n, iters, s);
    case 128: return launch<128>(w, v, u, out, rows, n, iters, s);
    case 256: return launch<256>(w, v, u, out, rows, n, iters, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
