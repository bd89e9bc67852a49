// Ray-parity hit counts for the point-in-mesh test, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel obman_train_tpu/ops/pallas/raytri_kernel.py
// (_raytri_kernel, :29-73; wrapper pallas_mesh_contains_points, :76-132).
// For each query point of each batch element it counts the triangles that
// the fixed ray d crosses (Moller-Trumbore, hit iff 0<u<1, v>0, u+v<1,
// t>=tol and |det|>=tol). The caller turns counts into exterior = even.
//
// Inputs (all float32, contiguous):
//   points (B, P, 3)
//   table  (B, T, 16): per triangle, four float4 rows
//          (v0x, v0y, v0z, invdet), (e1x, e1y, e1z, ok),
//          (e2x, e2y, e2z, 0),      (pvx, pvy, pvz, 0)
//          precomputed in PyTorch exactly as the Pallas wrapper does in XLA
//          (raytri_kernel.py:86-94).
// Output: counts (B, P) int32.
//
// What bounds it on an H100: instruction issue. Each (point, triangle) test
// costs 36 float32 instructions (31 sub, mul and add, 5 compares; built with
// -fmad=false, see below), and a sub-partition issues one warp instruction a
// clock, so every other instruction of the inner loop (shared loads, the
// count, loop control) is time the 36-per-test bound does not count. At the
// contact config (B=256, P=778, T=1280) that is 2.55e8 tests against ~21 MB
// of inputs: operations, not memory, bound it. The design:
//
// - Several points per thread. A block holds kTile = 32 * kR points; lane l
//   of every warp holds points p0 + l + 32 r, r < kR, in registers. One
//   broadcast read of a triangle's 64 bytes (four 16-byte shared loads)
//   serves kR tests, and the kR counts are independent dependency chains.
//   The last point tile of a batch element runs with r = the number of
//   32-point rows it still has (a block-uniform template dispatch), so a
//   ragged P wastes at most 31 point slots.
// - Warps split the triangles inside a block. The kWarps warps of a block
//   share its points and take contiguous, balanced parts of each staged
//   chunk; their integer partial counts meet in shared memory.
// - Blocks split the triangles when the grid is small. The grid is
//   (point tiles, S slices, B); the host's plan (raytri.py, _launch_plan)
//   picks S > 1 only when the point tiles alone leave the SMs short of
//   blocks. At P = 778, T = 1280 (a contact forward) that is every batch
//   of 67 or fewer but 17-18, 34-37 and 51-56, so the single-sample
//   callers (the image demo, max_penetration_depth) split as well; so
//   does the object voxel grid (1 x 4096); B = 256 and the hand grid
//   (1 x 32768) keep S = 1. Slice s covers [s * slice_len, min(T, (s+1) *
//   slice_len)). With S > 1 the launcher zeroes the counts on the stream
//   and the slices add their partial counts with atomicAdd.
// - Few instructions beside the 36. The per-triangle flag ok (|det| >= tol)
//   is the same for every lane of a warp, since all lanes read the same
//   triangle: it is compared once per triangle and seeds each test's chain
//   of predicated compares. The count is one predicated add (inline PTX;
//   nvcc's code for cnt += hit is an add and a predicated move). With the
//   shared loads (4 a triangle over kR tests) and the loop control (over
//   kUnroll triangles), the inner loop issues 38.5 instructions a test.
//   There is no data-dependent early exit: every test does all its 36
//   instructions, so the work does not depend on the inputs.
// - Staging: each chunk of kChunk triangles goes global -> shared by
//   cp.async (16-byte copies, coalesced), double-buffered in dynamic shared
//   memory, so the copy of chunk c+1 overlaps the sweep of chunk c.
//
// Exact sums. A count is an integer: the warps' and the slices' partial
// counts add up to the same total in any order.
//
// No tensor cores: the test has no product to put on them.
//
// Exactness: the counts must equal the plain PyTorch version's
// (raytri.py, raytri_count_plain) bit for bit, so this file is compiled
// with -fmad=false (no a*b+c contraction into FMA) and never with fast
// math, and every expression keeps the Pallas kernel's order
// (raytri_kernel.py:40-67), evaluated left to right.
//
// The constants were chosen by timing builds of this file with other
// values on an H100 (PERF.md, Findings): 8 warps beat 4, chunks of 384-512
// beat 128-256 and 768, 4 points a thread beat 2 and 8, and the predicated
// add gained ~2 % of the bound over nvcc's code for cnt += hit. The host's
// plan mirrors kR, kWarps and kChunk (ROWS, WARPS, CHUNK of raytri.py); it
// only sizes S, so a mismatch would cost time, never correctness.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 4;       // points per thread
constexpr int kWarps = 8;   // warps per block, splitting the triangles
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32 * kR;
constexpr int kChunk = 384;  // triangles per staged chunk (64 B each)
constexpr int kUnroll = 4;   // triangles per inner-loop iteration

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// cnt += hit, as one predicated add: nvcc's own code for the C form is an
// add and a predicated move, two instructions a test.
__device__ __forceinline__ void count_if(int& cnt, bool hit) {
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(cnt)
      : "r"((int)hit));
}

// Copies the n triangles (four float4 rows each) at src into buf.
__device__ __forceinline__ void stage(float4* buf, const float4* src, int n) {
  for (int i = threadIdx.x; i < 4 * n; i += kThreads) cp_async16(buf + i, src + i);
}

// The staged chunks, and after the sweep, in the same bytes, the warps'
// partial counts: 48 KB of dynamic shared memory, the most a block may
// take without an opt-in.
union Shared {
  float4 tri[2][4 * kChunk];
  int part[kWarps * kR * 32];
};
static_assert(sizeof(int) * kWarps * kR * 32 <= sizeof(float4) * 2 * 4 * kChunk,
              "the partial counts must fit in the staging buffers");
static_assert(sizeof(Shared) <= 48 * 1024, "more would need cudaFuncSetAttribute");

// One block: R rows of 32 points against the slice [j0, j1) of the
// triangles; the counts stored (or, with accumulate, added) at (b, p).
template <int R>
__device__ __forceinline__ void sweep(
    Shared& sh, const float* __restrict__ points, const float4* __restrict__ table,
    int P, int T, int slice_len, float d0, float d1, float d2, float tol,
    int* __restrict__ counts, bool accumulate) {
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* p_b = points + (size_t)b * P * 3;
  const float4* t_b = table + (size_t)b * T * 4;
  const int j0 = s * slice_len;
  const int j1 = min(T, j0 + slice_len);

  float px[R], py[R], pz[R];
  int cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(p0 + lane + 32 * r, P - 1);  // past P: computed, not written
    px[r] = p_b[3 * i];
    py[r] = p_b[3 * i + 1];
    pz[r] = p_b[3 * i + 2];
    cnt[r] = 0;
  }

  const int chunks = (j1 - j0 + kChunk - 1) / kChunk;
  stage(sh.tri[0], t_b + (size_t)j0 * 4, min(kChunk, j1 - j0));
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int start = j0 + c * kChunk;
    const int n = min(kChunk, j1 - start);
    if (c + 1 < chunks) {  // its buffer was last read before the previous barrier
      stage(sh.tri[(c + 1) & 1], t_b + (size_t)(start + kChunk) * 4,
            min(kChunk, j1 - start - kChunk));
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // chunk c has landed
    __syncthreads();
    const float4* tri = sh.tri[c & 1];
    const int per = (n + kWarps - 1) / kWarps;
    const int lo = min(n, warp * per);
    const int hi = min(n, lo + per);
#pragma unroll kUnroll
    for (int k = lo; k < hi; ++k) {
      const float4 a = tri[4 * k + 0];   // v0, invdet
      const float4 e1 = tri[4 * k + 1];  // e1, ok
      const float4 e2 = tri[4 * k + 2];
      const float4 pv = tri[4 * k + 3];
      const float invdet = a.w;
      const bool ok = e1.w > 0.f;  // once per triangle, for every lane
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float tx = px[r] - a.x;
        const float ty = py[r] - a.y;
        const float tz = pz[r] - a.z;
        const float u = (tx * pv.x + ty * pv.y + tz * pv.z) * invdet;
        const float qx = ty * e1.z - tz * e1.y;
        const float qy = tz * e1.x - tx * e1.z;
        const float qz = tx * e1.y - ty * e1.x;
        const float v = (d0 * qx + d1 * qy + d2 * qz) * invdet;
        const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * invdet;
        const bool hit = ok & (u > 0.f) & (u < 1.f) & (v > 0.f) & ((u + v) < 1.f) &
                         (t >= tol);
        count_if(cnt[r], hit);
      }
    }
    __syncthreads();  // chunk c's buffer is free for chunk c+2 (or the sums)
  }

  // the warps' partial counts, summed per point in shared memory
#pragma unroll
  for (int r = 0; r < R; ++r) sh.part[(warp * R + r) * 32 + lane] = cnt[r];
  __syncthreads();
  for (int t = threadIdx.x; t < 32 * R; t += kThreads) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += sh.part[w * R * 32 + t];
    const int i = p0 + t;  // t = lane + 32 r
    if (i < P) {
      int* dst = counts + (size_t)b * P + i;
      if (accumulate) {
        atomicAdd(dst, sum);
      } else {
        *dst = sum;
      }
    }
  }
}

// Runs sweep<r> for the r rows of 32 points this block still has, r <= R.
template <int R>
__device__ __forceinline__ void dispatch(int rows, Shared& sh, const float* points,
                                         const float4* table, int P, int T,
                                         int slice_len, float d0, float d1, float d2,
                                         float tol, int* counts, bool accumulate) {
  if constexpr (R > 1) {
    if (rows < R) {
      dispatch<R - 1>(rows, sh, points, table, P, T, slice_len, d0, d1, d2, tol,
                      counts, accumulate);
      return;
    }
  }
  sweep<R>(sh, points, table, P, T, slice_len, d0, d1, d2, tol, counts, accumulate);
}

__global__ void __launch_bounds__(kThreads)
raytri_count_kernel(const float* __restrict__ points, const float4* __restrict__ table,
                    int P, int T, int slice_len, float d0, float d1, float d2,
                    float tol, int* __restrict__ counts, bool accumulate) {
  extern __shared__ float4 smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  const int rows = min(kR, (P - (int)blockIdx.x * kTile + 31) / 32);
  dispatch<kR>(rows, sh, points, table, P, T, slice_len, d0, d1, d2, tol, counts,
               accumulate);
}

}  // namespace

// Launches on `stream` and returns the first non-zero CUDA error (0 on
// success). The triangles are cut into `slices` slices of `slice_len`
// (the last one ragged); with slices > 1 the counts are zeroed on the
// stream first and the slices add into them.
extern "C" int raytri_count(const void* points, const void* table, int B, int P,
                            int T, float d0, float d1, float d2, float tol,
                            int slices, int slice_len, void* counts, void* stream) {
  if (B == 0 || P == 0) return 0;
  if (slices < 1 || (long long)slices * slice_len < T) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (slices > 1) {
    const int err = (int)cudaMemsetAsync(counts, 0, (size_t)B * P * sizeof(int), s);
    if (err != 0) return err;
  }
  const dim3 grid((P + kTile - 1) / kTile, slices, B);
  raytri_count_kernel<<<grid, kThreads, sizeof(Shared), s>>>(
      (const float*)points, (const float4*)table, P, T, slice_len, d0, d1, d2, tol,
      (int*)counts, slices > 1);
  return (int)cudaGetLastError();
}
