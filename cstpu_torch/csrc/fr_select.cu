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
//     take): common.cuh::score_tile's loop, the first pass with two
//     accumulators per (row, atom) (q and z_0, r and u_0 staged side by side
//     in shared memory), then one pass per further term; resc stays in
//     registers across the passes. The multiply-adds bound this one (true
//     f32, FMA, no TF32).
#include <cstdint>

#include "common.cuh"
#include "mma_rescaled.cuh"

namespace cstpu {

template <typename T>
__global__ void __launch_bounds__(kTile)
fr_select_kernel(const float* __restrict__ r, const float* __restrict__ U,
                 const float* __restrict__ W, int P, float wsign,
                 const T* __restrict__ A, const float* __restrict__ cn2,
                 const uint8_t* __restrict__ amask, float* __restrict__ resc,
                 float* __restrict__ pval, int* __restrict__ pidx, int B,
                 int n, int m, int ntiles, float rtol) {
  __shared__ __align__(16) float rs[kChunk][kRows];
  __shared__ __align__(16) float zs[kChunk][kRows];
  __shared__ float wv[kRows][kTile / 32];
  __shared__ int wi[kRows][kTile / 32];

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int j = tile * kTile + threadIdx.x;
  const bool live = j < m;

  float qa[kRows], za[kRows], rj[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) qa[q] = za[q] = 0.f;

  // pass 0: q and z_0 together
  for (int p0 = 0; p0 < n; p0 += kChunk) {
    stage_rows<T>(rs, r, row0, p0, B, n);
    if (P > 0) stage_rows<T>(zs, U, row0, p0, B, n);
    __syncthreads();
    const int pend = min(kChunk, n - p0);
    if (live) {
      const T* a_ptr = A + (size_t)p0 * m + j;
#pragma unroll 2
      for (int pp = 0; pp < pend; ++pp) {
        const float a = to_f32(a_ptr[(size_t)pp * m]);
        const float4* rq = reinterpret_cast<const float4*>(rs[pp]);
        const float4* zq = reinterpret_cast<const float4*>(zs[pp]);
#pragma unroll
        for (int q4 = 0; q4 < kRows / 4; ++q4) {
          const float4 rv = rq[q4], zv = zq[q4];
          qa[4 * q4 + 0] = fmaf(a, rv.x, qa[4 * q4 + 0]);
          qa[4 * q4 + 1] = fmaf(a, rv.y, qa[4 * q4 + 1]);
          qa[4 * q4 + 2] = fmaf(a, rv.z, qa[4 * q4 + 2]);
          qa[4 * q4 + 3] = fmaf(a, rv.w, qa[4 * q4 + 3]);
          za[4 * q4 + 0] = fmaf(a, zv.x, za[4 * q4 + 0]);
          za[4 * q4 + 1] = fmaf(a, zv.y, za[4 * q4 + 1]);
          za[4 * q4 + 2] = fmaf(a, zv.z, za[4 * q4 + 2]);
          za[4 * q4 + 3] = fmaf(a, zv.w, za[4 * q4 + 3]);
        }
      }
    }
    __syncthreads();
  }

  // resc read after pass 0, to keep the main loop's registers free
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int row = row0 + q;
    rj[q] = (live && row < B) ? resc[(size_t)row * m + j] : 0.f;
  }
  // the pending terms in order; term p >= 1 takes a pass of its own
  for (int p = 0; p < P; ++p) {
    if (p > 0) {
      score_tile<T>(za, zs, U + (size_t)p * B * n, A, row0, j, live, B, n, m);
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int row = row0 + q;
      if (live && row < B) {
        const float w = wsign * W[(size_t)p * B + row];
        rj[q] = __fadd_rn(rj[q], __fmul_rn(__fmul_rn(w, za[q]), za[q]));
      }
    }
  }

  const float rmin = live ? __fmul_rn(rtol, cn2[j]) : 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int row = row0 + q;
    float v = -INFINITY;
    int i = INT_MAX;
    if (live && row < B) {
      const size_t e = (size_t)row * m + j;
      if (P > 0) resc[e] = rj[q];
      v = rj[q] > rmin ? __fdiv_rn(__fmul_rn(qa[q], qa[q]), rj[q]) : -INFINITY;
      if (amask[e]) v = 0.f;
      i = j;
    }
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
  const dim3 grid(ntiles, (B + kRows - 1) / kRows);
  if (cdt_bf16) {
    fr_select_kernel<__nv_bfloat16><<<grid, kTile, 0, s>>>(
        r, U, W, P, wsign, static_cast<const __nv_bfloat16*>(A), cn2, amask,
        resc, pval, pidx, B, n, m, ntiles, rtol);
  } else {
    fr_select_kernel<float><<<grid, kTile, 0, s>>>(
        r, U, W, P, wsign, static_cast<const float*>(A), cn2, amask, resc,
        pval, pidx, B, n, m, ntiles, rtol);
  }
  return static_cast<int>(cudaGetLastError());
}
