// Batched forward regression (FR) and SRR, stage 1: the pending rescaling
// terms and the OLS select, in one sweep over the dictionary.
//
// Replaces the two dictionary GEMMs of cstpu/ops/fused_solve.py::_fr_kernel:
// the q GEMM and its select (:571-580) and the z GEMM of the order-
// recursive rescaling update (:613-618). The TPU kernel reads A twice per
// step; here step t's launch first applies step t-1's update with the
// (aperp, dinv) that fr_append.cu left, then selects, so A is read once.
// For SRR it replaces the z GEMMs of cstpu/ops/fused_twostage.py::_Engine
// (append :183-189 and delete_ep :199-204) and the select of
// forward_score (:113-124): appends, and the deletions that never read
// resc, leave P pending signed rank-one terms (u_p, w_p), and this launch
// applies all of them in order before it scores:
//   z_p   = round_cdt(u_p) . a_j,  resc_j += (wsign * w_p) * z_p * z_p
//           (p = 0..P-1; FR passes P = 1, u = aperp, w = dinv, wsign = -1,
//           which is resc_j -= dinv * z * z bit for bit)
//   q     = round_cdt(r) . a_j
//   d2_j  = resc_j > rtol * cn2_j ? q*q / resc_j : -inf
//   d2_j  = 0 for active atoms (amask), which takes precedence (:576-577),
//           so a written-back resc that drifts below zero for an active
//           atom never flips its score
// and writes per-tile (max d2, lowest argmax) partials (B, T) with the
// argmax_combine rule (a NaN d2 gives (NaN, INT_MAX)). cn2 is the squared
// column norm of the f32 dictionary (:640). The score and the updates are
// rounded one operation at a time as the TPU kernels write them
// (__fmul_rn, __fadd_rn, __fdiv_rn), not fused into FMAs.
//
// What bounds it on an H100: reading the cdt dictionary (16 MB in bf16 at
// n=1024, m=8192, resident in the L2 across steps) and resc (B, m) f32 both
// ways (2 MB each at B=64), against 2 (1 + P) B n m operations: for FR at
// B=64 that is 2.1 G, 130 per dictionary byte, under the tensor cores' 295,
// so the bytes bound it; SRR's first call (17 products) comes near the
// operations' bound.
//
// Two hand-written variants; the Python wrapper picks one by the top-1
// selects' predicate (fused_solve.mma_select_takes) and passes `use_mma`:
//
//   tensor cores (bf16 correlation): mma_rescaled.cuh, whose note holds the
//     design: every product of a step (the P terms, then q) from one read of
//     a dictionary tile, the rows of all products stacked and interleaved
//     as wgmma's N operand so that one thread holds every product of its
//     (row, atom) entries; a step with more than three terms takes further
//     passes over the same tile from the L2. The operand is stacked by the
//     top-1 selects' `round_rows` launch (select_argmax.cu).
//   CUDA cores (f32 correlation, and what the tensor-core loop does not
//     take): simt_select.cuh's staged, register-tiled loop over the P + 1
//     products [u_0 .. u_{P-1}, r], two from each read of a dictionary tile
//     (FR's step: z and q in one pass; SRR's first call, 17 products, in
//     nine passes over the tile); resc stays in registers across the passes
//     and takes the terms in order. The multiply-adds bound this one (true
//     f32, FMA, no TF32); every sum is the earlier loop's bit for bit.
#include <cstdint>

#include "common.cuh"
#include "mma_rescaled.cuh"
#include "simt_select.cuh"

namespace cstpu {

// The CUDA-core variant: simt_select.cuh's loop over the P + 1 products
// [u_0 .. u_{P-1}, r], two to a pass, so that the last pass ends with q.
// After a pass each thread applies its terms to its 4 x 4 tile of resc in
// term order (resc read after the first pass), and after the last one
// scores and takes each row's (max, lowest argmax) over the warp.
template <typename T>
__global__ void __launch_bounds__(32 * simt::kMaxWarps)
fr_select_simt_kernel(const __grid_constant__ simt::Maps maps,
                      const float* __restrict__ r,
                      const float* __restrict__ U,
                      const float* __restrict__ W, int P, float wsign,
                      const T* __restrict__ A, const float* __restrict__ cn2,
                      const uint8_t* __restrict__ amask,
                      float* __restrict__ resc, float* __restrict__ pval,
                      int* __restrict__ pidx, int B, int n, int m,
                      int ntiles, float rtol) {
  using simt::kAT;
  using simt::kRT;
  extern __shared__ unsigned char smem[];
  const int tile = blockIdx.x, j0 = tile * kTile;
  const int row0 = blockIdx.y * kRT * (blockDim.x >> 5);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jl = j0 + kAT * lane;  // the thread's first atom
  const int rw = row0 + kRT * warp;  // the warp's first row

  float rj[kRT][kAT];
  float acc[2][kRT][kAT];
  simt::sweep<T, 2>(
      acc, smem, maps, A, (size_t)m, simt::Products{r, U, (size_t)B * n, P},
      j0, row0, B, n, m, [&](int pass, int np, float (&s)[2][kRT][kAT]) {
        if (pass == 0) {
#pragma unroll
          for (int i = 0; i < kRT; ++i) {
#pragma unroll
            for (int c = 0; c < kAT; ++c) {
              rj[i][c] = (rw + i < B && jl + c < m)
                             ? resc[(size_t)(rw + i) * m + jl + c]
                             : 0.f;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int p = 2 * pass + q;
          if (q >= np) break;
          if (p < P) {
            // a pending term, in order
#pragma unroll
            for (int i = 0; i < kRT; ++i) {
              if (rw + i >= B) continue;
              const float w = wsign * W[(size_t)p * B + rw + i];
#pragma unroll
              for (int c = 0; c < kAT; ++c) {
                if (jl + c < m) {
                  rj[i][c] = __fadd_rn(
                      rj[i][c], __fmul_rn(__fmul_rn(w, s[q][i][c]), s[q][i][c]));
                }
              }
            }
          } else {
            // q, the last product: the OLS score and the tile's argmax
#pragma unroll
            for (int i = 0; i < kRT; ++i) {
              const int row = rw + i;
              float v = -INFINITY;
              int idx = INT_MAX;
#pragma unroll
              for (int c = 0; c < kAT; ++c) {
                const int j = jl + c;
                if (j < m && row < B) {
                  const size_t e = (size_t)row * m + j;
                  if (P > 0) resc[e] = rj[i][c];
                  const float qa = s[q][i][c];
                  float d = rj[i][c] > __fmul_rn(rtol, cn2[j])
                                ? __fdiv_rn(__fmul_rn(qa, qa), rj[i][c])
                                : -INFINITY;
                  if (amask[e]) d = 0.f;
                  argmax_combine(v, idx, d, j);
                }
              }
              warp_argmax(v, idx);
              if (lane == 0 && row < B) {
                pval[(size_t)row * ntiles + tile] = v;
                pidx[(size_t)row * ntiles + tile] = idx;
              }
            }
          }
        }
      });
}

}  // namespace cstpu

// The tensor-core rescaled selects' plan (mma_rescaled.cuh::rescaled_plan)
// for B rows, nterms rescaling products before the residuals' and ntiles
// tiles: writes (G, Pn, rows) to out; `rows` is what the stacked operand's
// scratch must hold. The wrappers size their scratch by it.
extern "C" int cstpu_rescaled_plan(int B, int nterms, int ntiles, int* out) {
  if (B < 1 || nterms < 0 || ntiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cstpu::mma::RescaledPlan p =
      cstpu::mma::rescaled_plan(B, nterms, ntiles);
  out[0] = p.G;
  out[1] = p.Pn;
  out[2] = static_cast<int>(p.rows);
  return 0;
}

// One FR or SRR select for all B rows. r (B, n) f32, the pending terms U
// (P, B, n) f32 and W (P, B) f32 (P >= 0; weight wsign * W), A (n, m) in
// cdt, cn2 (m,) f32, amask (B, m) u8 (1 = active), resc (B, m) f32 updated
// in place; writes pval (B, ntiles) f32, pidx (B, ntiles) i32, ntiles =
// ceil(m / kTile). All contiguous. With use_mma the tensor-core loop runs,
// with sb (sb_rows, roundup(n, 8)) bf16 as the stacked operand's scratch
// (sb_rows at least cstpu_rescaled_plan's rows); it takes bf16 only, A
// aligned to 16 bytes and m a multiple of 8, and returns
// cudaErrorInvalidValue otherwise. Returns the first launch error.
extern "C" int cstpu_fr_select(const float* r, const float* U, const float* W,
                               int P, float wsign, const void* A,
                               int cdt_bf16, const float* cn2,
                               const uint8_t* amask, float* resc, float* pval,
                               int* pidx, int B, int n, int m, float rtol,
                               int use_mma, void* sb, long long sb_rows,
                               void* stream) {
  using namespace cstpu;
  if (P < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (m + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (!cdt_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(mma::launch_rescaled<false>(
        r, U, (size_t)B * n, P, nullptr, W, wsign, A, m, cn2, amask, nullptr,
        resc, pval, pidx, B, n, m, ntiles, rtol,
        static_cast<__nv_bfloat16*>(sb), sb_rows, s));
  }
  const simt::Products prod{r, U, (size_t)B * n, P};
  cudaError_t err;
  if (cdt_bf16) {
    err = simt::launch<__nv_bfloat16, 2>(
        fr_select_simt_kernel<__nv_bfloat16>, A, prod, B, n, m, ntiles, s, r,
        U, W, P, wsign, static_cast<const __nv_bfloat16*>(A), cn2, amask,
        resc, pval, pidx, B, n, m, ntiles, rtol);
  } else {
    err = simt::launch<float, 2>(
        fr_select_simt_kernel<float>, A, prod, B, n, m, ntiles, s, r, U, W,
        P, wsign, static_cast<const float*>(A), cn2, amask, resc, pval, pidx,
        B, n, m, ntiles, rtol);
  }
  return static_cast<int>(err);
}
