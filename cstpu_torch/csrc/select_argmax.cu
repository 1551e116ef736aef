// Batched OMP, stage 1: select. For every measurement row b and every tile
// of kTile atoms, the largest |<r_b, a_j>| and its lowest index.
//
// Replaces the select stage of cstpu/ops/fused_solve.py::_solve_kernel
// (:157-163) and the per-tile select of ::_stream_kernel (:370-385). Each
// call is one OMP step; the step loop runs on the host
// (cstpu_torch/ops/fused_solve.py).
//
// Math: scores = |round_cdt(r) . A_cdt|, products and sums in f32. r is
// rounded to the correlation dtype before the product, as the TPU kernel
// casts it (:158). A product of two bf16 values is exact in f32, so only
// the order of the sum differs from the TPU kernel. With cdt = f32 this is
// true f32 (FMA on CUDA cores, no TF32).
//
// What bounds it on an H100 (sizes computed from the shapes): per step it
// reads the cdt dictionary (16 MB in bf16 at n=1024, m=8192; it stays in
// the 50 MB L2 across steps) and does B*n*m multiply-adds (0.54 G at
// B=64). At about 64 FLOP per dictionary byte it would be bandwidth-bound
// on tensor cores; on CUDA cores, as here, the multiply-adds bound it.
//
// Design: one thread per atom column, kTile atoms per block, RB rows per
// block. Threads of a warp read neighbouring atoms of one dictionary row,
// so loads of A coalesce; the block's rows of r sit in shared memory,
// rounded to cdt, and every thread reads them as broadcast float4s. The
// epilogue reduces the block's kTile x RB scores to one (max, argmax) per
// row, so the (B, m) score matrix never reaches device memory; it writes
// partials (B, T), T = ceil(m / kTile), which the append kernel reduces.
// Any n and m: the ragged atom edge is masked (score -inf, index INT_MAX).
// Later work: mma/wgmma tiles and TMA loads in place of the FMA loop.
#include "common.cuh"

namespace cstpu {

constexpr int kRows = 16;   // measurement rows per block (RB)
constexpr int kChunk = 64;  // entries of r staged in shared memory at once

template <typename T>
__global__ void __launch_bounds__(kTile)
select_argmax_kernel(const float* __restrict__ r, const T* __restrict__ A,
                     float* __restrict__ pval, int* __restrict__ pidx, int B,
                     int n, int m, int ntiles) {
  __shared__ __align__(16) float rs[kChunk][kRows];
  __shared__ float wv[kRows][kTile / 32];
  __shared__ int wi[kRows][kTile / 32];

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int j = tile * kTile + threadIdx.x;
  const bool live = j < m;

  float acc[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = 0.f;

  for (int p0 = 0; p0 < n; p0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kRows; e += kTile) {
      const int q = e / kChunk, pp = e % kChunk;
      const int row = row0 + q, p = p0 + pp;
      rs[pp][q] = (row < B && p < n) ? round_cdt<T>(r[(size_t)row * n + p])
                                     : 0.f;
    }
    __syncthreads();
    const int pend = min(kChunk, n - p0);
    if (live) {
      const T* a_ptr = A + (size_t)p0 * m + j;
#pragma unroll 4
      for (int pp = 0; pp < pend; ++pp) {
        const float a = to_f32(a_ptr[(size_t)pp * m]);
        const float4* rq = reinterpret_cast<const float4*>(rs[pp]);
#pragma unroll
        for (int q4 = 0; q4 < kRows / 4; ++q4) {
          const float4 rv = rq[q4];
          acc[4 * q4 + 0] = fmaf(a, rv.x, acc[4 * q4 + 0]);
          acc[4 * q4 + 1] = fmaf(a, rv.y, acc[4 * q4 + 1]);
          acc[4 * q4 + 2] = fmaf(a, rv.z, acc[4 * q4 + 2]);
          acc[4 * q4 + 3] = fmaf(a, rv.w, acc[4 * q4 + 3]);
        }
      }
    }
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    float v = live ? fabsf(acc[q]) : -INFINITY;
    int i = live ? j : INT_MAX;
    warp_argmax(v, i);
    if (lane == 0) {
      wv[q][warp] = v;
      wi[q][warp] = i;
    }
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int q = threadIdx.x, row = row0 + q;
    float v = wv[q][0];
    int i = wi[q][0];
    for (int w = 1; w < kTile / 32; ++w) argmax_combine(v, i, wv[q][w], wi[q][w]);
    if (row < B) {
      pval[(size_t)row * ntiles + tile] = v;
      pidx[(size_t)row * ntiles + tile] = i;
    }
  }
}

}  // namespace cstpu

// r (B, n) f32, A (n, m) in cdt (bf16 if cdt_bf16 else f32), all
// contiguous; writes pval (B, ntiles) f32 and pidx (B, ntiles) i32 with
// ntiles = ceil(m / kTile). Returns the launch's cudaError_t.
extern "C" int cstpu_select_argmax(const float* r, const void* A,
                                   int cdt_bf16, float* pval, int* pidx,
                                   int B, int n, int m, void* stream) {
  using namespace cstpu;
  const int ntiles = (m + kTile - 1) / kTile;
  const dim3 grid(ntiles, (B + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    select_argmax_kernel<__nv_bfloat16><<<grid, kTile, 0, s>>>(
        r, static_cast<const __nv_bfloat16*>(A), pval, pidx, B, n, m, ntiles);
  } else {
    select_argmax_kernel<float><<<grid, kTile, 0, s>>>(
        r, static_cast<const float*>(A), pval, pidx, B, n, m, ntiles);
  }
  return static_cast<int>(cudaGetLastError());
}
