// Batched GOMP and SP, and the top-k init of OMPR and SRR, stage 1: select.
// For every measurement row b and every tile of kTile atoms, the l largest
// |<r_b, a_j>|, ordered by value descending and then by index ascending.
//
// Replaces the score GEMM and the top-l picks of cstpu/ops/fused_solve.py::
// _gomp_kernel (:788-793, :749-755): there the l appends of an iteration
// take, one after the other, the lowest-index maximum of one score vector
// and mask it out, which is the top-l in that order. A NaN anywhere in the
// row makes every pick INT_MAX there (`scores == smax` fails everywhere, and
// nothing is masked); here a tile holding a NaN writes l (NaN, INT_MAX)
// partials, and the append kernel gives such a row l INT_MAX picks. The same
// partials feed SP's round (cstpu/ops/fused_twostage.py::_sp_kernel) and the
// top-k init of ::_ompr_kernel and ::_srr_kernel (engine_init.cu).
//
// Math as select_argmax.cu: scores = |round_cdt(r) . A_cdt|, products and
// sums in f32. Partials (B, T, l), T = ceil(m / kTile); the ragged atom
// edge, and a tile with fewer than l atoms, give (-inf, INT_MAX) pads, which
// lose to every score.
//
// What bounds it on an H100: B n m multiply-adds per call (at suite config
// 2a, B=64, n=1024, m=8192: 1.07 GFLOP) against one read of the dictionary
// (16 MB in bf16, 32 MB in f32), plus a top-l epilogue. On the tensor cores
// the bytes bound it; in true f32 on the CUDA cores the multiply-adds do
// (0.016 ms at 67 TFLOP/s, the dictionary 0.010 ms at 3.35 TB/s). Two
// hand-written variants; the Python wrapper picks one by the top-1 selects'
// predicate on dtype, alignment and pitch and passes it as `use_mma`:
//
//   tensor cores (bf16 correlation): mma_topl.cuh, the top-1 selects' wgmma
//     loop (mma_select.cuh) with an epilogue that sorts each row's 128
//     scores of the tile across a warp; its cost does not grow with l.
//   CUDA cores (f32 correlation, and what the tensor-core loop does not
//     take): simt_select.cuh's staged, register-tiled loop, one product, as
//     select_argmax.cu's |s| mode runs it and under the same launch plan
//     (`simt::warps`: at 2a 128 blocks of 8 warps). Its sums are the top-1
//     select's bit for bit. The epilogue stays in registers
//     (simt::topl_epilogue, shared with stream_select.cu's top-l sweep): a
//     thread's 4 x 4 tile of sums is (row 4 w + i, atoms 4 lane .. 4 lane
//     + 3), the layout that common.cuh::warp_sort128_desc sorts (lane t
//     holds entries 4 t .. 4 t + 3 of a row), so each warp keys its four
//     rows' |s| (common.cuh::topl_key; past m the pad key 0), sorts them
//     two rows at a time and writes the first l of each. Its cost is flat
//     in l; an epilogue of l rounds of a warp argmax over scores staged in
//     shared memory cost about as much as the multiply-adds at l = 32.
#include "common.cuh"
#include "mma_topl.cuh"
#include "simt_select.cuh"

namespace cstpu {

// The CUDA-core variant: simt_select.cuh's loop over r, then its top-l
// epilogue (simt::topl_epilogue: each warp's rows sorted in registers and
// their first l written, value descending, then index ascending; a tile
// holding a NaN writes l (NaN, INT_MAX); pads write (-inf, INT_MAX)).
template <typename T>
__global__ void __launch_bounds__(32 * simt::kMaxWarps)
select_topl_simt_kernel(const __grid_constant__ simt::Maps maps,
                        const float* __restrict__ r, const T* __restrict__ A,
                        float* __restrict__ pval, int* __restrict__ pidx,
                        int B, int n, int m, int ntiles, int l) {
  using simt::kAT;
  using simt::kRT;
  extern __shared__ unsigned char smem[];
  const int tile = blockIdx.x, j0 = tile * kTile;
  const int row0 = blockIdx.y * kRT * (blockDim.x >> 5);
  const int jl = j0 + kAT * (threadIdx.x & 31);    // the thread's first atom
  const int rw = row0 + kRT * (threadIdx.x >> 5);  // the warp's first row

  float acc[1][kRT][kAT];
  simt::sweep<T, 1>(
      acc, smem, maps, A, (size_t)m, simt::Products{r, nullptr, 0, 0}, j0,
      row0, B, n, m, [&](int, int, float (&s)[1][kRT][kAT]) {
        simt::topl_epilogue(s[0], jl, rw, B, m, tile, ntiles, l, pval, pidx);
      });
}

}  // namespace cstpu

// r (B, n) f32, A (n, m) in cdt (bf16 if cdt_bf16 else f32), all
// contiguous, 1 <= l <= kTopLMax; writes pval (B, ntiles, l) f32 and pidx
// (B, ntiles, l) i32, ntiles = ceil(m / kTile). With use_mma the
// tensor-core variant runs, with rb (B, roundup(n, 8)) bf16 as its scratch
// for the rounded r; it takes bf16 only, A aligned to 16 bytes and m a
// multiple of 8, and the call returns cudaErrorInvalidValue otherwise.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for l out of
// range).
extern "C" int cstpu_select_topl(const float* r, const void* A, int cdt_bf16,
                                 float* pval, int* pidx, int B, int n, int m,
                                 int l, int use_mma, void* rb, void* stream) {
  using namespace cstpu;
  if (l < 1 || l > kTopLMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (!cdt_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(mma::launch_topl(
        r, n, 1, static_cast<__nv_bfloat16*>(rb), A, m, pval, pidx, B, n, m,
        l, s));
  }
  const int ntiles = (m + kTile - 1) / kTile;
  const simt::Products prod{r, nullptr, 0, 0};
  const cudaError_t err =
      cdt_bf16
          ? simt::launch<__nv_bfloat16, 1>(
                select_topl_simt_kernel<__nv_bfloat16>, A, prod, B, n, m,
                ntiles, s, r, static_cast<const __nv_bfloat16*>(A), pval,
                pidx, B, n, m, ntiles, l)
          : simt::launch<float, 1>(select_topl_simt_kernel<float>, A, prod,
                                   B, n, m, ntiles, s, r,
                                   static_cast<const float*>(A), pval, pidx,
                                   B, n, m, ntiles, l);
  return static_cast<int>(err);
}
