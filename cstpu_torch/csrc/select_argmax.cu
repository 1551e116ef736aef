// Batched OMP, MP and OMPR, stage 1: select. For every measurement row b
// and every tile of kTile atoms, the largest |<r_b, a_j>| and its lowest
// index; on request (MP) also the signed <r_b, a_j> of that winner; with an
// active-atom mask (OMPR) the score where(active, -inf, |eta <r_b, a_j>|).
//
// Replaces the select stage of cstpu/ops/fused_solve.py::_solve_kernel
// (:157-163) and the per-tile select of ::_stream_kernel (:370-385); with
// the signed output, the select of ::_mp_kernel (:890-898), whose step adds
// the winner's signed score v; with the mask, the passive-atom select of
// cstpu/ops/fused_twostage.py::_ompr_kernel (:998-1000), where a masked
// atom keeps its index, so an all-masked row gives (-inf, lowest index) as
// the TPU kernel's argmax does. Each call is one step; the step loop runs
// on the host (cstpu_torch/ops/fused_solve.py, fused_twostage.py).
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
// The signed variant carries the winner's signed score through the same
// reduction (argmax_combine with a payload), so the winners, and OMP's
// outputs, are the same with and without it. The masked variant is its
// own instantiation, so OMP's and MP's code is unchanged by it.
// Later work: mma/wgmma tiles and TMA loads in place of the FMA loop.
#include <cstdint>

#include "common.cuh"

namespace cstpu {

template <typename T, bool kSigned, bool kMasked>
__global__ void __launch_bounds__(kTile)
select_argmax_kernel(const float* __restrict__ r, const T* __restrict__ A,
                     float* __restrict__ pval, int* __restrict__ pidx,
                     float* __restrict__ psig,
                     const uint8_t* __restrict__ amask, float eta, int B,
                     int n, int m, int ntiles) {
  __shared__ __align__(16) float rs[kChunk][kRows];
  __shared__ float wv[kRows][kTile / 32];
  __shared__ int wi[kRows][kTile / 32];
  __shared__ float ws[kSigned ? kRows : 1][kTile / 32];

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int j = tile * kTile + threadIdx.x;
  const bool live = j < m;

  float acc[kRows];
  score_tile<T>(acc, rs, r, A, row0, j, live, B, n, m);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    float v = live ? fabsf(acc[q]) : -INFINITY;
    int i = live ? j : INT_MAX;
    if constexpr (kMasked) {
      if (live) {
        const int row = row0 + q;
        v = (row < B && amask[(size_t)row * m + j]) ? -INFINITY : fabsf(eta * acc[q]);
      }
    }
    if constexpr (kSigned) {
      float sg = acc[q];
      warp_argmax(v, i, sg);
      if (lane == 0) ws[q][warp] = sg;
    } else {
      warp_argmax(v, i);
    }
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
    if constexpr (kSigned) {
      float sg = ws[q][0];
      for (int w = 1; w < kTile / 32; ++w)
        argmax_combine(v, i, sg, wv[q][w], wi[q][w], ws[q][w]);
      if (row < B) psig[(size_t)row * ntiles + tile] = sg;
    } else {
      for (int w = 1; w < kTile / 32; ++w) argmax_combine(v, i, wv[q][w], wi[q][w]);
    }
    if (row < B) {
      pval[(size_t)row * ntiles + tile] = v;
      pidx[(size_t)row * ntiles + tile] = i;
    }
  }
}

template <typename T>
void launch_select(const float* r, const void* A, float* pval, int* pidx,
                   float* psig, const uint8_t* amask, float eta, int B, int n,
                   int m, cudaStream_t s) {
  const int ntiles = (m + kTile - 1) / kTile;
  const dim3 grid(ntiles, (B + kRows - 1) / kRows);
  const T* a = static_cast<const T*>(A);
  if (psig) {
    select_argmax_kernel<T, true, false><<<grid, kTile, 0, s>>>(
        r, a, pval, pidx, psig, nullptr, 1.f, B, n, m, ntiles);
  } else if (amask) {
    select_argmax_kernel<T, false, true><<<grid, kTile, 0, s>>>(
        r, a, pval, pidx, nullptr, amask, eta, B, n, m, ntiles);
  } else {
    select_argmax_kernel<T, false, false><<<grid, kTile, 0, s>>>(
        r, a, pval, pidx, nullptr, nullptr, 1.f, B, n, m, ntiles);
  }
}

}  // namespace cstpu

// r (B, n) f32, A (n, m) in cdt (bf16 if cdt_bf16 else f32), all
// contiguous; writes pval (B, ntiles) f32 and pidx (B, ntiles) i32 with
// ntiles = ceil(m / kTile), and, when psig is not null, the winners'
// signed scores psig (B, ntiles) f32. When amask (B, m) u8 is not null
// (and psig is), atoms with amask != 0 score -inf and the others
// |eta * score|. Returns the launch's cudaError_t.
extern "C" int cstpu_select_argmax(const float* r, const void* A,
                                   int cdt_bf16, float* pval, int* pidx,
                                   float* psig, const uint8_t* amask,
                                   float eta, int B, int n, int m,
                                   void* stream) {
  using namespace cstpu;
  if (psig && amask) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    launch_select<__nv_bfloat16>(r, A, pval, pidx, psig, amask, eta, B, n, m,
                                 s);
  } else {
    launch_select<float>(r, A, pval, pidx, psig, amask, eta, B, n, m, s);
  }
  return static_cast<int>(cudaGetLastError());
}
