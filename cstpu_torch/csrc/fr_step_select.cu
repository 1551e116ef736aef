// One forward-regression step over a dictionary shard: the previous
// append's rescaling downdate, a deferred deletion's update, and this step's
// OLS select, in one sweep. The per-step kernel of the column-sharded FR,
// SRR, RMP and FoBa solvers.
//
// Replaces cstpu/ops/stream_select.py::_fr_step_kernel. The TPU kernel walks
// the shard tile by tile on one core and carries a running (max, argmax)
// pair from tile to tile; here the blocks run in parallel, so the step is
// two launches: this sweep, which updates resc in place and writes partials
// per row and per kTile atoms, and stream_select.cu's top-1 finishing stage,
// which folds them under the TPU kernel's rule (running pair from (-inf, 0),
// strict `>` across tiles of `bpt` sweep blocks, a tile that holds a NaN
// score skipped whole).
//
// Math, per row b and atom j of the shard (R, W, V rounded to the
// correlation dtype, products and sums in f32, each atom's sum in one fixed
// order from p = 0, per variant, so an atom scores the same in any shard):
//   q  = round_cdt(r_b) . a_j,  z = round_cdt(w_b) . a_j,
//   zv = round_cdt(v_b) . a_j                              (only with V)
//   resc = 0 where j == restore[b]; resc -= z z; resc += zv zv;
//   resc = -1 where j == mark[b]
//   d2 = resc > deg * cn2_j ? q q / resc : -inf
// each operation rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn; no FMA
// contraction), as the TPU kernel writes them. An active atom is resc = -1,
// forever below the threshold, so there is no mask array. A NaN in resc
// fails the threshold test and scores -inf (its tile is not skipped); a NaN
// in q with a valid resc scores NaN (its tile is skipped).
//
// One thread owns one (row, atom) entry of resc through all passes, so the
// in-place update needs no atomics.
//
// What bounds it on an H100: the sweep reads the cdt shard once (256 MB in
// bf16 at n=1024, m=131072: 0.08 ms at 3.35 TB/s) and reads and writes resc
// (B, m) f32; it does 2 (2 or 3) B n m operations, at B=8 16-24 per shard
// byte, far under the tensor cores' 295, so the bytes bound it.
//
// Two hand-written variants; the Python wrapper picks one by the top-1
// selects' predicate (fused_solve.mma_select_takes) and passes `use_mma`:
//
//   tensor cores (bf16 correlation): mma_rescaled.cuh, the loop fr_select.cu
//     runs too. q, z and zv come from ONE read of the shard: the rounded R,
//     W and V are stacked, interleaved in groups of 8 rows, as wgmma's N
//     operand (N = 16 without V, 32 with it, the fourth product slot zero),
//     so one thread holds all three products of its (row, atom) entries and
//     updates resc and scores them in registers. The shard's pitch is the
//     tensor map's: a column slice is read in place.
//   CUDA cores (f32 correlation, and a base or pitch the bulk loads cannot
//     address): fr_select.cu's loop (q and z share the first pass over the
//     shard, two accumulators per (row, atom); V takes a pass of its own,
//     which re-reads the block's columns; resc stays in registers across the
//     passes) with stream_select.cu's strided reads of a column slice, kRows
//     = 16 rows per block whatever B is. The multiply-adds bound it (true
//     f32, FMA, no TF32).
#include <cstdint>

#include "common.cuh"
#include "mma_rescaled.cuh"

namespace cstpu {

template <typename T, bool kUseV>
__global__ void __launch_bounds__(kTile)
fr_step_sweep_kernel(const float* __restrict__ r, const float* __restrict__ w,
                     const float* __restrict__ v, const T* __restrict__ A,
                     size_t lda, const int* __restrict__ il,
                     const float* __restrict__ cn2, float* __restrict__ resc,
                     float* __restrict__ pval, int* __restrict__ pidx, int B,
                     int n, int m, int nblocks, float deg) {
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

  // pass 0: q and z together
  for (int p0 = 0; p0 < n; p0 += kChunk) {
    stage_rows<T>(rs, r, row0, p0, B, n);
    stage_rows<T>(zs, w, row0, p0, B, n);
    __syncthreads();
    const int pend = min(kChunk, n - p0);
    if (live) {
      const T* a_ptr = A + (size_t)p0 * lda + j;
#pragma unroll 2
      for (int pp = 0; pp < pend; ++pp) {
        const float a = to_f32(a_ptr[(size_t)pp * lda]);
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

  // resc read after pass 0, to keep the main loop's registers free: the
  // restore on a zero base, then the append's downdate
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int row = row0 + q;
    float x = 0.f;
    if (live && row < B) {
      x = resc[(size_t)row * m + j];
      if (j == il[2 * row + 1]) x = 0.f;
      x = __fadd_rn(x, -__fmul_rn(za[q], za[q]));
    }
    rj[q] = x;
  }
  if constexpr (kUseV) {  // the deletion's update, a pass of its own
    score_tile<T>(za, zs, v, A, row0, j, live, B, n, lda, (size_t)n,
                  (size_t)1);
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      rj[q] = __fadd_rn(rj[q], __fmul_rn(za[q], za[q]));
    }
  }

  const float rmin = live ? __fmul_rn(deg, cn2[j]) : 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int row = row0 + q;
    float val = -INFINITY;
    int i = INT_MAX;
    if (live && row < B) {
      float x = rj[q];
      if (j == il[2 * row]) x = -1.f;
      resc[(size_t)row * m + j] = x;
      val = x > rmin ? __fdiv_rn(__fmul_rn(qa[q], qa[q]), x) : -INFINITY;
      i = j;
    }
    warp_argmax(val, i);
    if (lane == 0) {
      wv[q][warp] = val;
      wi[q][warp] = i;
    }
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int q = threadIdx.x, row = row0 + q;
    float val = wv[q][0];
    int i = wi[q][0];
    for (int k = 1; k < kTile / 32; ++k) argmax_combine(val, i, wv[q][k], wi[q][k]);
    if (row < B) {
      pval[(size_t)row * nblocks + tile] = val;
      pidx[(size_t)row * nblocks + tile] = i;
    }
  }
}

template <typename T>
void launch_fr_step(const float* r, const float* w, const float* v,
                    const void* A, size_t lda, const int* il, const float* cn2,
                    float* resc, float* pval, int* pidx, int B, int n, int m,
                    float deg, cudaStream_t s) {
  const int nblocks = m / kTile;
  const dim3 grid(nblocks, (B + kRows - 1) / kRows);
  const T* a = static_cast<const T*>(A);
  if (v) {
    fr_step_sweep_kernel<T, true><<<grid, kTile, 0, s>>>(
        r, w, v, a, lda, il, cn2, resc, pval, pidx, B, n, m, nblocks, deg);
  } else {
    fr_step_sweep_kernel<T, false><<<grid, kTile, 0, s>>>(
        r, w, nullptr, a, lda, il, cn2, resc, pval, pidx, B, n, m, nblocks,
        deg);
  }
}

}  // namespace cstpu

// One FR step select of one shard. r, w and (nullable) v are contiguous
// (B, n) f32; A (n, m) in cdt (bf16 if cdt_bf16 else f32) has unit column
// stride and rows lda entries apart; il (B, 2) i32 holds [mark, restore]
// local atom indices, -1 for none; cn2 (m,) f32; resc (B, m) f32 is updated
// in place. m is a multiple of kTile and bpt sweep blocks make one tile of
// the NaN rule. Scratch pval (B, m / kTile) f32 and pidx i32; writes val
// (B,) f32 and idx (B,) i32. With use_mma the sweep is the tensor-core one,
// with sb (sb_rows, roundup(n, 8)) bf16 as the stacked operand's scratch
// (sb_rows at least cstpu_rescaled_plan's rows, fr_select.cu); it takes bf16
// only, A aligned to 16 bytes and lda a multiple of 8, and the call returns
// cudaErrorInvalidValue otherwise. Returns the first launch error.
extern "C" int cstpu_fr_step_select(const float* r, const float* w,
                                    const float* v, const void* A,
                                    long long lda, int cdt_bf16, const int* il,
                                    const float* cn2, float* resc, float* pval,
                                    int* pidx, float* val, int* idx, int B,
                                    int n, int m, int bpt, float deg,
                                    int use_mma, void* sb, long long sb_rows,
                                    void* stream) {
  using namespace cstpu;
  if (!stream_tiling_ok(m, bpt) || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_mma) {
    if (!cdt_bf16) return static_cast<int>(cudaErrorInvalidValue);
    err = mma::launch_rescaled<true>(
        r, w, (size_t)B * n, 1, v, nullptr, 0.f, A, lda, cn2, nullptr, il,
        resc, pval, pidx, B, n, m, m / kTile, deg,
        static_cast<__nv_bfloat16*>(sb), sb_rows, s);
  } else {
    if (cdt_bf16) {
      launch_fr_step<__nv_bfloat16>(r, w, v, A, lda, il, cn2, resc, pval,
                                    pidx, B, n, m, deg, s);
    } else {
      launch_fr_step<float>(r, w, v, A, lda, il, cn2, resc, pval, pidx, B, n,
                            m, deg, s);
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_stream_finish(pval, pidx, B, m / kTile, bpt, 0, val, idx, s));
}
