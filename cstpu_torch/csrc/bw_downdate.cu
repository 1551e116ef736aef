// Batched backward elimination (FBR, LACE), stage 2 of a deletion step: the
// rank-one Schur downdate of every row's private Gram inverse.
//
// Replaces the (m, m) update of cstpu/ops/fused_backward.py::_bw_kernel
// (:139): G_b -= gcol_b (g_b ginvs_b)', with g_b = G_b[p, :] and gcol_b =
// G_b[:, p] as bw_select.cu staged them from the matrix before this launch,
// so no block reads an entry another block writes. No identity pad at slot
// p (:134-138): the downdate zeroes row and column p up to rounding and the
// alive mask keeps the residue out of every decision. A row that did not
// step in this launch's select (its run latch was closed) is skipped; a
// rejected step has ginvs = 0 and leaves a finite matrix as it is. Each
// product and the difference are rounded on their own, as the plain
// version's tensor operations are.
//
// What bounds it on an H100: bytes. Every entry of (B, m, m) f32 is read and
// written once per step, 2 B m^2 4 bytes (64 MB at B = 8, m = 1024, where
// the 32 MB state fits the 50 MB L2; 512 MB at B = 64, from device memory).
// Design: one block per 8 matrix rows of one instance, float4 loads and
// stores along a row, g and gcol read through the cache.
#include "common.cuh"

namespace cstpu {

constexpr int kDownThreads = 256;
constexpr int kDownRows = 8;

__global__ void __launch_bounds__(kDownThreads)
bw_downdate_kernel(float* __restrict__ G, const float* __restrict__ g,
                   const float* __restrict__ gcol,
                   const float* __restrict__ sc, int m) {
  const int b = blockIdx.y;
  if (sc[2 * b + 1] < 0.5f) return;
  const float ginvs = sc[2 * b];
  const int m4 = m / 4;
  float4* G4 = reinterpret_cast<float4*>(G + (size_t)b * m * m);
  const float4* g4 = reinterpret_cast<const float4*>(g + (size_t)b * m);
  const float* gc = gcol + (size_t)b * m;
  const int i0 = blockIdx.x * kDownRows;
  const int rows = min(kDownRows, m - i0);
  for (int e = threadIdx.x; e < rows * m4; e += blockDim.x) {
    const int i = i0 + e / m4, j4 = e % m4;
    const float ci = gc[i];
    const float4 gv = g4[j4];
    float4 x = G4[(size_t)i * m4 + j4];
    x.x = __fsub_rn(x.x, __fmul_rn(ci, __fmul_rn(gv.x, ginvs)));
    x.y = __fsub_rn(x.y, __fmul_rn(ci, __fmul_rn(gv.y, ginvs)));
    x.z = __fsub_rn(x.z, __fmul_rn(ci, __fmul_rn(gv.z, ginvs)));
    x.w = __fsub_rn(x.w, __fmul_rn(ci, __fmul_rn(gv.w, ginvs)));
    G4[(size_t)i * m4 + j4] = x;
  }
}

}  // namespace cstpu

// The downdate of one deletion step for all B rows. G (B, m, m) f32 updated
// in place; g, gcol (B, m) f32 and sc (B, 2) f32 from cstpu_bw_select. m is
// a multiple of 4. All contiguous. Returns the launch's cudaError_t.
extern "C" int cstpu_bw_downdate(float* G, const float* g, const float* gcol,
                                 const float* sc, int B, int m, void* stream) {
  using namespace cstpu;
  if (m % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kDownRows - 1) / kDownRows, B);
  bw_downdate_kernel<<<grid, kDownThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(G, g, gcol, sc, m);
  return static_cast<int>(cudaGetLastError());
}
