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
// What bounds it on an H100: operations. At the contact config (B=256,
// P=778, T=1280) it does 2.55e8 point-triangle tests of ~36 fp32 operations
// each and reads ~21 MB, so the fp32 (non-tensor) rate bounds it, not the
// memory. Design: grid (ceil(P/128), B), one thread per query point. The
// batch element's triangle table is staged through shared memory in chunks
// of kChunk triangles (32 KB, under the 48 KB static limit); every thread
// of a warp reads the same triangle at once, so the float4 reads broadcast
// without bank conflicts. Threads past P still help stage the table.
//
// Exactness: the counts must equal the plain PyTorch version's bit for bit,
// so this file is compiled with -fmad=false (no a*b+c contraction into FMA)
// and never with fast math, and every expression keeps the Pallas kernel's
// order (raytri_kernel.py:40-67), evaluated left to right.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;

__global__ void __launch_bounds__(kThreads)
raytri_count_kernel(const float* __restrict__ points,
                    const float4* __restrict__ table,
                    int P, int T, float d0, float d1, float d2, float tol,
                    int* __restrict__ counts) {
  __shared__ float4 s_tri[kChunk * 4];

  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool active = p < P;

  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    const float* pt = points + ((size_t)b * P + p) * 3;
    px = pt[0];
    py = pt[1];
    pz = pt[2];
  }
  const float4* tri_b = table + (size_t)b * T * 4;

  int count = 0;
  for (int start = 0; start < T; start += kChunk) {
    const int n = min(kChunk, T - start);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < n * 4; i += kThreads) {
      s_tri[i] = tri_b[(size_t)start * 4 + i];
    }
    __syncthreads();
    if (active) {
      for (int k = 0; k < n; ++k) {
        const float4 a = s_tri[4 * k + 0];  // v0, invdet
        const float4 e1 = s_tri[4 * k + 1];  // e1, ok
        const float4 e2 = s_tri[4 * k + 2];
        const float4 pv = s_tri[4 * k + 3];
        const float invdet = a.w;
        const float tx = px - a.x;
        const float ty = py - a.y;
        const float tz = pz - a.z;
        const float u = (tx * pv.x + ty * pv.y + tz * pv.z) * invdet;
        const float qx = ty * e1.z - tz * e1.y;
        const float qy = tz * e1.x - tx * e1.z;
        const float qz = tx * e1.y - ty * e1.x;
        const float v = (d0 * qx + d1 * qy + d2 * qz) * invdet;
        const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * invdet;
        const bool hit = (u > 0.f) & (u < 1.f) & (v > 0.f) & ((u + v) < 1.f) &
                         (t >= tol) & (e1.w > 0.f);
        count += hit ? 1 : 0;
      }
    }
  }
  if (active) counts[(size_t)b * P + p] = count;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int raytri_count(const void* points, const void* table, int B,
                            int P, int T, float d0, float d1, float d2,
                            float tol, void* counts, void* stream) {
  if (B == 0 || P == 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  raytri_count_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)points, (const float4*)table, P, T, d0, d1, d2, tol,
      (int*)counts);
  return (int)cudaGetLastError();
}
