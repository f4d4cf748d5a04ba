// The DTW anti-diagonal wavefront of word-timestamp alignment: fills the
// (N+1, M+1) trace matrix of the DP over an (N, M) fp32 cost matrix.
//
// Replaces the Pallas kernel whisper_flamingo_tpu/ops/dtw_pallas.py:48 (the
// kernel of `_dtw_pallas_program`) together with the host scatter of
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
// Design for Hopper. One block per matrix, one thread per row i in [0, N]
// (N + 1 <= 1024). The loop walks the diagonals d = 1 .. N+M; at each step
// thread i handles the cell (i, d - i) when it lies inside the matrix. The
// last two diagonals live in shared memory in a 3-slot ring indexed by i,
// so that a step reads the two slots the previous steps wrote and writes
// the third: one __syncthreads() per diagonal is enough (the slot written
// at step d+1 was last read at step d, before the barrier). The Pallas
// kernel's skewed (N+M, n_pad) input, its 128-lane padding and its
// 8-diagonal grid tiles are TPU layout and are left out.
//
// What bounds it: the chain of N+M dependent diagonals, each a barrier
// apart, not bytes (it reads 4*N*M bytes and writes (N+1)*(M+1), under a
// microsecond of the card's memory time at these shapes). It runs on one
// SM, which is the nature of this DP for one matrix. Thread i's reads walk
// along row i-1 of x, so they stride by M across threads and do not
// coalesce; each thread loads the next diagonal's value into a register
// before the barrier, so the load's latency overlaps the current step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void dtw_trace_kernel(const float* __restrict__ x, int8_t* __restrict__ trace,
                                 int n, int m) {
  extern __shared__ float ring[];  // 3 slots of n + 1 costs
  const int i = threadIdx.x;
  const int w = m + 1;  // row stride of the trace
  const float inf = INFINITY;

  // row 0 and column 0 are off the DP
  for (int j = i; j <= m; j += blockDim.x) trace[j] = -1;
  for (int r = i; r <= n; r += blockDim.x) trace[static_cast<size_t>(r) * w] = -1;

  // slot 0 holds diagonal 0 (cost[0, 0] = 0), slot 2 the diagonal -1
  if (i <= n) {
    ring[i] = (i == 0) ? 0.0f : inf;
    ring[2 * (n + 1) + i] = inf;
  }
  __syncthreads();

  // the threads past row n (the block is rounded up to whole warps) stay
  // in the loop, idle, so that every thread reaches every barrier
  const bool row = i >= 1 && i <= n;
  // x[i-1, d-i-1] of diagonal d, when the cell lies inside the matrix
  auto load = [&](int d) -> float {
    const int j = d - i;
    return (row && j >= 1 && j <= m) ? x[static_cast<size_t>(i - 1) * m + (j - 1)] : 0.0f;
  };

  float x_next = load(1);
  int s_cur = 1, s_p1 = 0, s_p2 = 2;  // slots of diagonals d, d-1, d-2
  for (int d = 1; d <= n + m; ++d) {
    const float xv = x_next;
    if (d < n + m) x_next = load(d + 1);
    const float* p1 = ring + s_p1 * (n + 1);
    const float* p2 = ring + s_p2 * (n + 1);
    const int j = d - i;
    const bool valid = row && j >= 1 && j <= m;
    float cost = inf;
    if (valid) {
      const float c0 = p2[i - 1];
      const float c1 = p1[i - 1];
      const float c2 = p1[i];
      int t;
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
      cost = __fadd_rn(xv, c);
      trace[static_cast<size_t>(i) * w + j] = static_cast<int8_t>(t);
    }
    if (i <= n) ring[s_cur * (n + 1) + i] = cost;
    __syncthreads();
    const int s_free = s_p2;
    s_p2 = s_p1;
    s_p1 = s_cur;
    s_cur = s_free;
  }
}

// Threads a launch for n text tokens takes: n + 1 rounded up to whole
// warps; 0 when n + 1 > 1024, the most a block holds.
int dtw_threads(int n) { return n + 1 > 1024 ? 0 : (n + 1 + 31) / 32 * 32; }

}  // namespace

// x: device fp32 (n, m), row-major and contiguous; trace: device int8
// (n + 1, m + 1), row-major. Returns the launch's cudaGetLastError() (0 when
// the kernel was accepted).
extern "C" int wf_dtw_trace(const void* x, void* trace, int n, int m, void* stream) {
  const int threads = dtw_threads(n);
  if (threads == 0 || n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * static_cast<size_t>(n + 1) * sizeof(float);
  dtw_trace_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(trace), n, m);
  return static_cast<int>(cudaGetLastError());
}
