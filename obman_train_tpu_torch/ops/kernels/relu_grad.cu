// The backward epilogue of a folded ReLU convolution, for Hopper (sm_90a):
// the sum of a tensor's two incoming gradients, the ReLU's mask and the
// bias gradient, in one pass.
//
// Replaces no TPU kernel: the JAX package leaves the backward of its
// convolutions to XLA, which fuses these elementwise passes by itself. It
// was added because without it the folded encoder's backward on the card
// (models/resnet_fold.py: FoldedStem, FoldedBlockOp) runs them as three
// ATen passes over every activation gradient: the residual's add,
// `threshold_backward`, and the bias sum inside `convolution_backward`,
// each reading the gradient again.
//
// Inputs (float32, a (rows, C) matrix each, C innermost: an NCHW tensor
// in channels-last memory, rows = N * H * W):
//   a      one gradient of the ReLU's output
//   b      the other one, or null where the output has one user
//   y      the ReLU's saved output
// Outputs:
//   g      where(y <= 0, 0, a + b): bit for bit `threshold_backward(a + b,
//          y, 0)` (an fp32 add is commutative). g may be a's own storage:
//          each element is read and then written by the same thread, so
//          the caller saves an allocation by passing a as g.
//   db     (C,) float32, db[c] = sum over the rows of g[:, c].
//
// What bounds it on an H100: bytes. Per element it reads 8 or 12 bytes and
// writes 4, and does one add, one compare and one add into a sum. The
// design:
//
// - 16-byte loads along C. A block owns a strip of up to kStrip float4
//   columns (128 channels) and loops over the rows of its row group, kR
//   rows a thread at once (all loads of the kR rows issued before the
//   first store), keeping its four channels' partial sums in registers.
//   Neighbouring threads read neighbouring addresses: a warp reads 512
//   contiguous bytes of one row, or whole rows where C < 128.
// - The grid is (strips, row groups); the host's plan (relu_grad.py,
//   _launch_plan) picks the row groups so that the grid fills the SMs
//   once at the residency the launch bounds promise (kMinBlocks blocks of
//   kThreads a SM), whatever (rows, C) is: ResNet's C runs from 64 to
//   2048 and its rows from ~16 k to ~4 M at B=256.
// - The bias sums are exact functions of the plan: each thread sums its
//   rows in order, a block sums its threads' sums in shared memory in a
//   fixed order into its row group's entry of a scratch (groups, C)
//   buffer, and a second kernel sums the row groups of each channel in a
//   fixed order. No float atomics: db is the same from run to run.
//
// Built with -fmad=false like the other kernels: there is no product here,
// so it changes nothing, and g's add and compare round as ATen's do.
//
// The constants were chosen by timing builds of this file with other values
// on an H100 (PERF.md, Findings): kR = 4 rows a thread with 2 blocks a SM
// (no spill) was within 1 % of kR = 8 and ahead of kR = 1-2 at 8 blocks a
// SM by 5-10 %. The host's plan mirrors kThreads, kMinBlocks and kStrip
// (THREADS, MIN_BLOCKS, STRIP of relu_grad.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;   // resident blocks a SM the launch bounds ask for
constexpr int kStrip = 32;      // float4 columns a block owns at most
constexpr int kR = 4;           // rows a thread loads before it stores
constexpr int kSumRows = 8;     // row-group lanes of the second pass

__device__ __forceinline__ float4 masked(float4 v, float4 y) {
  v.x = y.x <= 0.f ? 0.f : v.x;
  v.y = y.y <= 0.f ? 0.f : v.y;
  v.z = y.z <= 0.f ? 0.f : v.z;
  v.w = y.w <= 0.f ? 0.f : v.w;
  return v;
}

__device__ __forceinline__ float4 added(float4 v, float4 w) {
  v.x = v.x + w.x;
  v.y = v.y + w.y;
  v.z = v.z + w.z;
  v.w = v.w + w.w;
  return v;
}

// grid (strips, groups), block kThreads = cw columns x (kThreads / cw) row
// lanes; a, g may alias (no __restrict__ on them).
template <bool kTwo>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
relu_bias_grad_rows(const float4* a, const float4* __restrict__ b,
                    const float4* __restrict__ y, float4* g, float4* __restrict__ partial,
                    long long rows, int c4, int cw, long long group_rows) {
  __shared__ float4 sums[kThreads];
  const int lanes = kThreads / cw;
  const int tx = threadIdx.x % cw;
  const int ty = threadIdx.x / cw;
  const int col = blockIdx.x * cw + tx;
  const long long r0 = (long long)blockIdx.y * group_rows;
  const long long r1 = r0 + group_rows < rows ? r0 + group_rows : rows;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ty < lanes && col < c4) {
    long long r = r0 + ty;
    for (; r + (long long)(kR - 1) * lanes < r1; r += (long long)kR * lanes) {
      float4 va[kR], vy[kR];
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        const long long i = (r + (long long)u * lanes) * c4 + col;
        va[u] = a[i];
        if (kTwo) va[u] = added(va[u], b[i]);
        vy[u] = y[i];
      }
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        const float4 v = masked(va[u], vy[u]);
        g[(r + (long long)u * lanes) * c4 + col] = v;
        s = added(s, v);
      }
    }
    for (; r < r1; r += lanes) {
      const long long i = r * c4 + col;
      float4 v = a[i];
      if (kTwo) v = added(v, b[i]);
      v = masked(v, y[i]);
      g[i] = v;
      s = added(s, v);
    }
  }
  sums[threadIdx.x] = s;
  __syncthreads();
  if (ty == 0 && col < c4) {
    float4 t = sums[tx];
    for (int j = 1; j < lanes; ++j) t = added(t, sums[j * cw + tx]);
    partial[(long long)blockIdx.y * c4 + col] = t;
  }
}

// grid ceil(C / 32), block 32 channels x kSumRows lanes over the groups.
__global__ void __launch_bounds__(32 * kSumRows)
relu_bias_grad_sum(const float* __restrict__ partial, int groups, int C,
                   float* __restrict__ db) {
  __shared__ float sums[kSumRows][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float t = 0.f;
  if (c < C) {
    for (int j = threadIdx.y; j < groups; j += kSumRows) t += partial[(long long)j * C + c];
  }
  sums[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int j = 1; j < kSumRows; ++j) t += sums[j][threadIdx.x];
    db[c] = t;
  }
}

}  // namespace

// g and db of (a [+ b], y) as the header says. partial: (groups, C)
// float32 scratch; groups * group_rows >= rows; C a multiple of 4; every
// pointer 16-byte aligned. b may be null; g may equal a.
extern "C" int relu_bias_grad(const void* a, const void* b, const void* y, void* g,
                              void* partial, void* db, long long rows, int C, int groups,
                              long long group_rows, void* stream) {
  if (C <= 0 || C % 4 != 0 || groups <= 0 || groups > 65535 || group_rows <= 0 ||
      (long long)groups * group_rows < rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int c4 = C / 4;
  const int cw = c4 < kStrip ? c4 : kStrip;
  const dim3 grid((c4 + cw - 1) / cw, groups);
  if (b != nullptr) {
    relu_bias_grad_rows<true><<<grid, kThreads, 0, s>>>(
        (const float4*)a, (const float4*)b, (const float4*)y, (float4*)g, (float4*)partial,
        rows, c4, cw, group_rows);
  } else {
    relu_bias_grad_rows<false><<<grid, kThreads, 0, s>>>(
        (const float4*)a, nullptr, (const float4*)y, (float4*)g, (float4*)partial, rows, c4,
        cw, group_rows);
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  relu_bias_grad_sum<<<(C + 31) / 32, dim3(32, kSumRows), 0, s>>>(
      (const float*)partial, groups, C, (float*)db);
  return (int)cudaGetLastError();
}
