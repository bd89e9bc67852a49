// Nearest-neighbour squared distances, one direction, for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of
// obman_train_tpu/ops/pallas/chamfer_kernel.py:
//   K2 _chamfer_kernel        (:82-96)   fused layout, min only
//   K3 _chamfer_kernel_argmin (:98-131)  fused layout, min + argmin
//   K4 _dir_kernel            (:141-153) split layout, min only
//   K5 _dir_kernel_argmin     (:155-180) split layout, min + argmin
// The TPU's fused/split choice was a matter of VMEM capacity (how much of
// the search set one tile holds, chamfer_kernel.py:9-20, 51-61). Here the
// search set streams through shared memory in chunks, so one kernel,
// nn_dir<WITH_ARGMIN>, serves every size; the bidirectional entry
// (K2/K3's function) launches it twice, x->y and y->x (see nnsqdist.py).
//
// For each query point q of each batch element it computes
//   min_j  (dx*dx + dy*dy) + dz*dz,   (dx, dy, dz) = q - s_j,
// over the search set s, with direct differences in the order of the Pallas
// kernel's _dists (chamfer_kernel.py:64-74): exact and >= 0, unlike the
// rx + ry - 2xy plane. With WITH_ARGMIN it also writes the first index that
// reaches the min (jnp.argmin / torch.argmin semantics): the sweep visits
// j in increasing order and replaces the running min only on a strict <,
// as the Pallas kernels accumulate across tiles.
//
// Inputs (float32, contiguous): query (B, N, 3), search (B, M, 3).
// Outputs: min (B, N) float32; argmin (B, N) int64 (feeds torch.gather).
//
// What bounds it on an H100: operations. At the training shapes (B=256,
// N~M~600-778) one sweep does ~1.2e8 pairs of 9 fp32 operations (10 with
// the argmin select) and reads ~4 MB, so the fp32 (non-tensor) rate bounds
// it, not the memory. Design: grid (ceil(N/128), B), one query point per
// thread held in registers; the batch element's search set is staged
// through shared memory in chunks of kChunk points as float4 (x, y, z, 0),
// so each pair costs one broadcast 16-byte shared load; min and argmin
// live in registers. The tail of a chunk is bounds-checked: no padding
// sentinel is needed (the TPU's 1e9 sentinel and its coordinate-major
// (B, 3, NP) layout existed for the 128-lane axis). Threads past N still
// help stage the chunk.
//
// Exactness: the plain PyTorch version (nnsqdist.py, nn_dir_plain) rounds
// every operation on its own, so this file is compiled with -fmad=false (no
// a*b+c contraction into FMA) and never with fast math; the two agree bit
// for bit, values and argmins.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;  // 16 KB of float4 per chunk

template <bool WITH_ARGMIN>
__global__ void __launch_bounds__(kThreads)
nn_dir_kernel(const float* __restrict__ query, const float* __restrict__ search,
              int N, int M, float* __restrict__ out_min,
              long long* __restrict__ out_arg) {
  __shared__ float4 s_pts[kChunk];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < N;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = query + ((size_t)b * N + i) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float* s_b = search + (size_t)b * M * 3;
  float* s_flat = reinterpret_cast<float*>(s_pts);

  float best = CUDART_INF_F;
  int best_j = 0;
  for (int start = 0; start < M; start += kChunk) {
    const int n = min(kChunk, M - start);
    __syncthreads();  // the previous chunk is no longer read
    // coalesced reads of the (n, 3) slice, scattered into (n, 4) float4 rows
    const float* src = s_b + (size_t)start * 3;
    for (int t = threadIdx.x; t < n * 3; t += kThreads) {
      const int p = t / 3;
      s_flat[4 * p + (t - 3 * p)] = src[t];
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int k = 0; k < n; ++k) {
        const float4 s = s_pts[k];
        const float dx = qx - s.x;
        const float dy = qy - s.y;
        const float dz = qz - s.z;
        const float d = (dx * dx + dy * dy) + dz * dz;
        if (WITH_ARGMIN) {
          if (d < best) {
            best = d;
            best_j = start + k;
          }
        } else {
          best = d < best ? d : best;
        }
      }
    }
  }
  if (active) {
    const size_t o = (size_t)b * N + i;
    out_min[o] = best;
    if (WITH_ARGMIN) out_arg[o] = (long long)best_j;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// out_arg may be null when with_argmin is 0.
extern "C" int nn_dir(const void* query, const void* search, int B, int N,
                      int M, int with_argmin, void* out_min, void* out_arg,
                      void* stream) {
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (with_argmin) {
    nn_dir_kernel<true><<<grid, kThreads, 0, s>>>(
        (const float*)query, (const float*)search, N, M, (float*)out_min,
        (long long*)out_arg);
  } else {
    nn_dir_kernel<false><<<grid, kThreads, 0, s>>>(
        (const float*)query, (const float*)search, N, M, (float*)out_min,
        nullptr);
  }
  return (int)cudaGetLastError();
}
