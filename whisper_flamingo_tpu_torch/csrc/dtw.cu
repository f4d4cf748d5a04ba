// The DTW wavefront of word-timestamp alignment: fills the (N+1, M+1) trace
// matrix of the DP over an (N, M) fp32 cost matrix.
//
// Replaces the Pallas kernel whisper_flamingo_tpu/ops/dtw_pallas.py:48 (the
// kernel of `_dtw_pallas_program` :36) together with the host scatter of
// `dtw_trace_pallas` (:126): this kernel writes the trace straight into its
// row-major place. The numerics are the reference DP's
// (whisper_flamingo_tpu/ops/dtw.py `dtw_np`):
//   - cost[0, 0] = 0, every other boundary cell is +inf;
//   - c0 = cost[i-1, j-1], c1 = cost[i-1, j], c2 = cost[i, j-1];
//   - t = 0 if c0 < c1 and c0 < c2, else 1 if c1 < c0 and c1 < c2, else 2,
//     and the propagated cost follows the same cascade, not min(): on the
//     tie c0 == c1 < c2 it carries c2;
//   - cost[i, j] = x[i-1, j-1] + c, one fp32 add (bit-equal to the plain
//     version);
//   - cells off the DP (row 0, column 0) hold -1.
//
// What bounds it on this card: the chain. Cell (i, j) needs (i-1, j), so
// the N + M anti-diagonals are a chain of dependent steps, and one matrix
// is one SM's work. Its bytes (4 N M read, (N+1)(M+1) written) take under
// a microsecond of the card's memory time; a step's arithmetic (three
// compares, two selects, one add) a few dozen cycles. A design is as fast
// as what it puts on that chain.
//
// Design. One thread per row i (N <= 1023 rows, ceil(N / 32) warps), the
// row's cost of the previous column in a register. The lanes of a warp walk
// the columns skewed by one: at step s lane l works column j = s - l and
// takes cost[i - 1, j] from lane l - 1 with one __shfl_up_sync (lane l - 1
// computed it at step s - 1). So a dependent step is one shuffle and one
// cell, with no barrier and no shared memory between dependent cells.
// Warps chain through a shared ring: lane 31 of warp w - 1 writes its costs
// there and publishes its progress every 16 columns; warp w reads 16
// columns at once, a block behind, so its wait is off the chain (per-warp
// progress flags, release / acquire through __threadfence_block(); the
// producer also waits when the ring is full). Off the chain:
//   - x: a lane reads the 16 values of x its row needs in the next block of
//     16 steps into registers at the start of this block, one block
//     ahead; no step waits on memory unless a load has not landed in 16
//     steps;
//   - the trace: a step puts its byte into a register (one bfi); after each
//     block of 16 steps the lane stores the aligned 16-byte span of its row
//     that the block completed, cut from the last two blocks' bytes (one
//     st.global.v4); a row's first and last spans, shared with the rows
//     beside it, are stored byte by byte. The steps themselves branch on
//     nothing.
// The other banding, one warp whose lanes own ceil(N / 32) rows each, was
// timed and dropped: B dependent cells a step made it slower at every shape
// (PERF.md).
//
// wf_dtw_chain_floor times the chain alone: one warp runs the dependent
// step (the shuffle, the cascade and the add) `iters` times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;   // steps per block: x values per load batch, bytes per trace span
constexpr int RING = 64;   // columns of the inter-warp ring
constexpr unsigned FULL = 0xffffffffu;

// One DP cell: the reference's cascade and one fp32 add.
__device__ __forceinline__ float cell(float xv, float c0, float c1, float c2, int& t) {
  float c;
  if (c0 < c1 && c0 < c2) {
    t = 0;
    c = c0;
  } else if (c1 < c0 && c1 < c2) {
    t = 1;
    c = c1;
  } else {
    t = 2;
    c = c2;
  }
  return __fadd_rn(xv, c);
}

// Byte `b` (0..3) of a 32-bit word set to the low byte of v (a constant b
// after unrolling: one bfi).
__device__ __forceinline__ uint32_t put_byte(uint32_t word, int b, int v) {
  const int sh = 8 * b;
  return (word & ~(0xffu << sh)) | ((static_cast<uint32_t>(v) & 0xffu) << sh);
}

// Word `idx` (0..7) of an 8-word window, by selects (no local memory).
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[8], int idx) {
  uint32_t v = w[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) v = idx == k ? w[k] : v;
  return v;
}

// Stores the aligned 16-byte span that begins at byte k0 of the window
// (prv: the row's bytes of columns j0 - 16 .. j0 - 1, cur: j0 .. j0 + 15),
// whose first column is c_lo = j0 - 16 + k0, at `dst` (16-byte aligned):
// one vector store when all 16 columns lie in [0, m], else byte by byte
// the columns that do (a row's first and last spans).
__device__ __forceinline__ void store_span(int8_t* dst, const uint32_t (&prv)[4],
                                           const uint32_t (&cur)[4], int k0, int c_lo, int m) {
  const uint32_t win[8] = {prv[0], prv[1], prv[2], prv[3], cur[0], cur[1], cur[2], cur[3]};
  const int a = k0 / 4, r = 8 * (k0 % 4);
  uint32_t sw[4];
  uint32_t lo = pick(win, a);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t hi = pick(win, a + q + 1);
    sw[q] = __funnelshift_r(lo, hi, r);
    lo = hi;
  }
  if (c_lo >= 0 && c_lo + 15 <= m) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(sw[0], sw[1], sw[2], sw[3]);
  } else if (c_lo + 15 >= 0 && c_lo <= m) {
    for (int k = max(0, -c_lo); k < 16 && c_lo + k <= m; ++k)
      dst[k] = static_cast<int8_t>(sw[k / 4] >> (8 * (k % 4)));
  }
}

__global__ void __launch_bounds__(1024) dtw_wave_kernel(const float* __restrict__ x,
                                                        int8_t* __restrict__ trace, int n, int m) {
  __shared__ float ring[32][RING];  // [warp][column]: cost of warp - 1's last row
  __shared__ int prod[32], cons[32];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = nt / 32;
  const float inf = INFINITY;
  const int i = 1 + tid;  // this thread's row
  const bool row = i <= n;
  const long long row0 = static_cast<long long>(i) * (m + 1);  // trace offset of (i, 0)
  const float* xr = x + static_cast<size_t>(row ? i - 1 : 0) * m;
  const bool feeds = lane == 31 && warp + 1 < n_warps;  // writes the ring of warp + 1
  volatile int* vprod = prod;
  volatile int* vcons = cons;

  for (int j = tid; j <= m; j += nt) trace[j] = -1;  // row 0
  if (lane == 0) {
    prod[warp] = 0;
    cons[warp] = 0;
  }
  __syncthreads();

  // x[i - 1, s0 + u - lane - 1] for the steps s0 + u of the block at s0
  float xcur[TILE], xnext[TILE];
  auto load = [&](float (&v)[TILE], int s0) {
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      const int xc = s0 + u - lane - 1;
      v[u] = (row && xc >= 0 && xc < m) ? __ldg(xr + xc) : 0.0f;
    }
  };
  load(xnext, 0);

  float prev = inf;      // cost[i, j - 1]
  float bottom = inf;    // cost[i, j] of the last step, for lane + 1
  float top_prev = inf;  // cost[i - 1, j - 1]
  // The trace bytes of the columns j0 .. j0 + 15 of this block (j0 =
  // s0 - lane; byte u at step s0 + u) and of the block before. The row's
  // aligned 16-byte spans begin k0 bytes into that 32-byte window: the
  // same k0 in every block.
  uint32_t cur[4] = {0u, 0u, 0u, 0u}, prv[4];
  const int k0 = static_cast<int>((16 - ((row0 - lane) & 15)) & 15);
  const int last = m + 31;

  for (int s0 = 0; s0 <= last; s0 += TILE) {
#pragma unroll
    for (int u = 0; u < TILE; ++u) xcur[u] = xnext[u];
    load(xnext, s0 + TILE);  // in flight during this block
    if (warp > 0) {  // columns s0 .. s0 + 15 of warp - 1's last row are in the ring
      while (vprod[warp] < min(s0 + TILE, m + 1)) {
      }
      __threadfence_block();
    }
    if (warp + 1 < n_warps) {  // lane 31 writes columns s0 - 31 .. s0 - 16 to the ring
      while (vcons[warp + 1] < s0 - 31 + TILE - RING) {
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) prv[k] = cur[k];
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      const int j = s0 + u - lane;
      float top = __shfl_up_sync(FULL, bottom, 1);
      if (lane == 0) top = warp > 0 ? ring[warp][(s0 + u) % RING] : (j == 0 ? 0.0f : inf);
      int t;
      float c = cell(xcur[u], top_prev, top, prev, t);
      if (j == 0) {  // column 0: off the DP
        t = -1;
        c = inf;
      }
      const bool active = j >= 0 && j <= m;
      prev = active ? c : prev;
      bottom = active ? c : bottom;
      top_prev = top;
      cur[u / 4] = put_byte(cur[u / 4], u % 4, t);
      if (feeds && active) ring[warp + 1][j % RING] = c;
    }
    if (feeds) {
      __threadfence_block();
      vprod[warp + 1] = max(0, min(s0 + TILE - 31, m + 1));
    }
    if (warp > 0 && lane == 0) {  // lane 0 has read the block's columns from the ring
      __threadfence_block();
      vcons[warp] = min(s0 + TILE, m + 1);
    }
    const int j0 = s0 - lane;
    if (row) store_span(trace + row0 + j0 - 16 + k0, prv, cur, k0, j0 - 16 + k0, m);
  }
  // the spans that end past the last block
#pragma unroll
  for (int e = 1; e <= 2; ++e) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      prv[k] = cur[k];
      cur[k] = 0u;
    }
    const int j0 = (last / TILE) * TILE + e * TILE - lane;
    if (row) store_span(trace + row0 + j0 - 16 + k0, prv, cur, k0, j0 - 16 + k0, m);
  }
}

__global__ void dtw_chain_floor_kernel(float* __restrict__ out, int iters) {
  const int lane = threadIdx.x;
  float bottom = 0.0f, top_prev = 0.0f, prev = 0.5f * lane;
  int tsum = 0;
  for (int it = 0; it < iters; ++it) {
    const float top = __shfl_up_sync(FULL, bottom, 1);
    int t;
    const float c = cell(0.0f, top_prev, top, prev, t);
    tsum += t;
    prev = c;
    bottom = c;
    top_prev = top;
  }
  out[lane] = bottom + static_cast<float>(tsum);
}

}  // namespace

// x: device fp32 (n, m), row-major and contiguous; trace: device int8
// (n + 1, m + 1), row-major. Returns the launch's cudaGetLastError() (0 when
// the kernel was accepted), cudaErrorInvalidValue for what it does not take.
extern "C" int wf_dtw_trace(const void* x, void* trace, int n, int m, void* stream) {
  if (n < 1 || m < 1 || n + 1 > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (n + 31) / 32 * 32;
  dtw_wave_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(trace), n, m);
  return static_cast<int>(cudaGetLastError());
}

// One warp, `iters` dependent steps of the wavefront (shuffle, cascade,
// add); out: 32 floats on the device.
extern "C" int wf_dtw_chain_floor(void* out, int iters, void* stream) {
  dtw_chain_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
