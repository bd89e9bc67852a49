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
// reaches the min (jnp.argmin / torch.argmin semantics).
//
// Inputs (float32, contiguous): query (B, N, 3), search (B, M, 3).
// Outputs: min (B, N) float32; argmin (B, N) int64 (feeds torch.gather).
//
// What bounds it on an H100: instruction issue. Each pair costs 9 float32
// instructions (3 sub, 3 mul, 2 add, 1 min; -fmad=false, see below), and a
// sub-partition issues one warp instruction a clock, so every other
// instruction of the inner loop (shared load, index bookkeeping, loop
// control) is time the 9-per-pair bound does not count. The design:
//
// - Several queries per thread. A block holds kTile = 32 * kR queries; lane
//   l of every warp holds queries q0 + l + 32 r, r < kR, in registers. One
//   broadcast 16-byte shared load of a search point (float4 x, y, z, -)
//   serves kR pairs, and the kR running minima are independent dependency
//   chains. The last query tile of a batch element runs with r = the
//   number of 32-query rows it still has (a block-uniform template
//   dispatch), so a ragged N wastes at most 31 query slots.
// - Warps split the search set inside a block. The kWarps warps of a block
//   share its queries and take contiguous, balanced parts of each staged
//   chunk, so a block has kWarps times as many warps at work as it has
//   32-query rows. Their partial results meet in shared memory.
// - Blocks split the search set when the grid is small. The grid is
//   (query tiles, S slices, B); the host's plan (nnsqdist.py,
//   _launch_plan) picks S > 1 only when the query tiles alone would leave
//   the 132 SMs short of blocks (one large cloud); at the training shapes
//   (B = 256) S is 1. Slice s covers [s * slice_len, min(M, (s+1) *
//   slice_len)) and writes a partial min and its first argmin to scratch
//   (S, B, N) that the wrapper allocates; nn_merge_slices then visits the
//   slices in index order. Both launches run on the caller's stream.
// - Staging: each chunk of kChunk points goes global -> shared by cp.async
//   (three 4-byte copies per point, one point per thread, coalesced, no
//   integer division), double-buffered, so the copy of chunk c+1 overlaps
//   the sweep of chunk c.
//
// Exact merges. Each lane visits its part of the search set in increasing
// index order and replaces a running min only on a strict <, so it keeps
// the first index reaching its min. Across warps (whose parts interleave
// chunk by chunk) the merge takes the lexicographic min of (d, j); across
// slices (in index order) a strict <. Either keeps the first occurrence, and
// a min of floats is exact in any order: values equal the plain version bit
// for bit, argmins exactly.
//
// No tensor cores. The exact direct-difference form has no product to put
// on them; the rx + ry - 2xy form would, but it rounds differently and can
// go below 0, which the Pallas kernel rejected for the same reason
// (chamfer_kernel.py:67-70), and it is the port's dense-plane route, many
// times slower at the training shapes (PERF.md).
//
// Exactness: the plain PyTorch version (nnsqdist.py, nn_dir_plain) rounds
// every operation on its own, so this file is compiled with -fmad=false (no
// a*b+c contraction into FMA) and never with fast math.
//
// The tile constants were chosen by timing on an H100 (PERF.md). The
// host's plan (nnsqdist.py, _launch_plan) assumes kR = 4; it only sizes S,
// so a mismatch would cost time, never correctness.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kR = 4;          // queries per thread
constexpr int kWarps = 4;      // warps per block, splitting the search set
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32 * kR;
constexpr int kChunk = 1024;   // search points per staged chunk (16 KB of float4)
constexpr int kMergeThreads = 256;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies n points (x, y, z) from src into the float4 rows of buf.
__device__ __forceinline__ void stage(float4* buf, const float* src, int n) {
  for (int p = threadIdx.x; p < n; p += kThreads) {
    float* d = reinterpret_cast<float*>(buf + p);
    const float* g = src + 3 * p;
    cp_async4(d, g);
    cp_async4(d + 1, g + 1);
    cp_async4(d + 2, g + 2);
  }
}

// The staged chunks, and after the sweep, in the same bytes, the warps'
// partial results.
union Shared {
  float4 pts[2][kChunk];
  struct {
    float min[kWarps * kR * 32];
    int arg[kWarps * kR * 32];
  } part;
};
static_assert(sizeof(float) * 2 * kWarps * kR * 32 <= sizeof(float4) * 2 * kChunk,
              "the partial results must fit in the staging buffers");

// One block: R rows of 32 queries against the slice [j0, j1) of the search
// set, written to dst at ((s * B + b) * N + i).
template <int R, bool WITH_ARGMIN>
__device__ __forceinline__ void sweep(
    Shared& sh, const float* __restrict__ query, const float* __restrict__ search,
    int B, int N, int M, int slice_len, float* __restrict__ dst_min,
    long long* __restrict__ dst_arg64, int* __restrict__ dst_arg32) {
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* q_b = query + (size_t)b * N * 3;
  const float* s_b = search + (size_t)b * M * 3;
  const int j0 = s * slice_len;
  const int j1 = min(M, j0 + slice_len);

  float qx[R], qy[R], qz[R], best[R];
  int best_j[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(q0 + lane + 32 * r, N - 1);  // past N: computed, not written
    qx[r] = q_b[3 * i];
    qy[r] = q_b[3 * i + 1];
    qz[r] = q_b[3 * i + 2];
    best[r] = CUDART_INF_F;
    best_j[r] = j0;
  }

  const int chunks = (j1 - j0 + kChunk - 1) / kChunk;
  stage(sh.pts[0], s_b + (size_t)j0 * 3, min(kChunk, j1 - j0));
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int start = j0 + c * kChunk;
    const int n = min(kChunk, j1 - start);
    if (c + 1 < chunks) {  // its buffer was last read before the previous barrier
      stage(sh.pts[(c + 1) & 1], s_b + (size_t)(start + kChunk) * 3,
            min(kChunk, j1 - start - kChunk));
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // chunk c has landed
    __syncthreads();
    const float4* pts = sh.pts[c & 1];
    const int per = (n + kWarps - 1) / kWarps;
    const int lo = min(n, warp * per);
    const int hi = min(n, lo + per);
#pragma unroll 8
    for (int k = lo; k < hi; ++k) {
      const float4 p = pts[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = qx[r] - p.x;
        const float dy = qy[r] - p.y;
        const float dz = qz[r] - p.z;
        const float d = (dx * dx + dy * dy) + dz * dz;
        if (WITH_ARGMIN) {
          if (d < best[r]) {
            best[r] = d;
            best_j[r] = start + k;
          }
        } else {
          best[r] = fminf(best[r], d);  // one FMNMX; best never holds a NaN
        }
      }
    }
    __syncthreads();  // chunk c's buffer is free for chunk c+2 (or the merge)
  }

  // the warps' partial results, merged per query in shared memory
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sh.part.min[(warp * R + r) * 32 + lane] = best[r];
    if (WITH_ARGMIN) sh.part.arg[(warp * R + r) * 32 + lane] = best_j[r];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 32 * R; t += kThreads) {
    float v = sh.part.min[t];
    int j = WITH_ARGMIN ? sh.part.arg[t] : 0;
    for (int w = 1; w < kWarps; ++w) {
      const float u = sh.part.min[w * R * 32 + t];
      if (WITH_ARGMIN) {
        const int ju = sh.part.arg[w * R * 32 + t];
        if (u < v || (u == v && ju < j)) {
          v = u;
          j = ju;
        }
      } else {
        v = fminf(v, u);
      }
    }
    const int i = q0 + t;  // t = lane + 32 r
    if (i < N) {
      const size_t o = ((size_t)s * B + b) * N + i;
      dst_min[o] = v;
      if (WITH_ARGMIN) {
        if (dst_arg64 != nullptr) {
          dst_arg64[o] = (long long)j;
        } else {
          dst_arg32[o] = j;
        }
      }
    }
  }
}

// Runs sweep<r> for the r rows of 32 queries this block still has, r <= R.
template <int R, bool WITH_ARGMIN>
__device__ __forceinline__ void dispatch(int rows, Shared& sh, const float* query,
                                         const float* search, int B, int N, int M,
                                         int slice_len, float* dst_min,
                                         long long* dst_arg64, int* dst_arg32) {
  if constexpr (R > 1) {
    if (rows < R) {
      dispatch<R - 1, WITH_ARGMIN>(rows, sh, query, search, B, N, M, slice_len,
                                   dst_min, dst_arg64, dst_arg32);
      return;
    }
  }
  sweep<R, WITH_ARGMIN>(sh, query, search, B, N, M, slice_len, dst_min,
                        dst_arg64, dst_arg32);
}

template <bool WITH_ARGMIN>
__global__ void __launch_bounds__(kThreads)
nn_dir_kernel(const float* __restrict__ query, const float* __restrict__ search,
              int B, int N, int M, int slice_len, float* __restrict__ dst_min,
              long long* __restrict__ dst_arg64, int* __restrict__ dst_arg32) {
  __shared__ Shared sh;
  const int rows = min(kR, (N - (int)blockIdx.x * kTile + 31) / 32);
  dispatch<kR, WITH_ARGMIN>(rows, sh, query, search, B, N, M, slice_len, dst_min,
                            dst_arg64, dst_arg32);
}

// Slices in index order, strict <: the first slice reaching the min wins,
// and within it the first index (partials are (S, BN)).
template <bool WITH_ARGMIN>
__global__ void __launch_bounds__(kMergeThreads)
nn_merge_slices(const float* __restrict__ part_min, const int* __restrict__ part_arg,
                int S, int BN, float* __restrict__ out_min,
                long long* __restrict__ out_arg) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= BN) return;
  float best = part_min[i];
  int best_j = WITH_ARGMIN ? part_arg[i] : 0;
  for (int s = 1; s < S; ++s) {
    const float v = part_min[(size_t)s * BN + i];
    if (v < best) {
      best = v;
      if (WITH_ARGMIN) best_j = part_arg[(size_t)s * BN + i];
    }
  }
  out_min[i] = best;
  if (WITH_ARGMIN) out_arg[i] = (long long)best_j;
}

template <bool WITH_ARGMIN>
int launch(const float* query, const float* search, int B, int N, int M,
           int slices, int slice_len, float* part_min, int* part_arg,
           float* out_min, long long* out_arg, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, slices, B);
  if (slices == 1) {
    nn_dir_kernel<WITH_ARGMIN><<<grid, kThreads, 0, stream>>>(
        query, search, B, N, M, slice_len, out_min, out_arg, nullptr);
    return (int)cudaGetLastError();
  }
  nn_dir_kernel<WITH_ARGMIN><<<grid, kThreads, 0, stream>>>(
      query, search, B, N, M, slice_len, part_min, nullptr, part_arg);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int BN = B * N;
  nn_merge_slices<WITH_ARGMIN><<<(BN + kMergeThreads - 1) / kMergeThreads,
                                  kMergeThreads, 0, stream>>>(
      part_min, part_arg, slices, BN, out_min, out_arg);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the first non-zero cudaGetLastError()
// (0 on success). With slices > 1, part_min (slices, B, N) float32 and
// part_arg (slices, B, N) int32 are the scratch of the slice merge; else
// they may be null. out_arg and part_arg may be null when with_argmin is 0.
extern "C" int nn_dir(const void* query, const void* search, int B, int N,
                      int M, int with_argmin, int slices, int slice_len,
                      void* part_min, void* part_arg, void* out_min,
                      void* out_arg, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (slices < 1 || (long long)slices * slice_len < M) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (with_argmin) {
    return launch<true>((const float*)query, (const float*)search, B, N, M, slices,
                        slice_len, (float*)part_min, (int*)part_arg,
                        (float*)out_min, (long long*)out_arg, s);
  }
  return launch<false>((const float*)query, (const float*)search, B, N, M, slices,
                       slice_len, (float*)part_min, nullptr, (float*)out_min,
                       nullptr, s);
}
