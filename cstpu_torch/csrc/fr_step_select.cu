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
// bf16, 537 MB in f32 at n=1024, m=131072: 0.08 / 0.16 ms at 3.35 TB/s) and
// reads and writes resc (B, m) f32 (8.4 MB at B=8); it does 2 (2 or 3) B n m
// operations, at B=8 4-6 per f32 shard byte: far under the tensor cores'
// 295, and under the CUDA cores' 20 (67 TFLOP/s over 3.35 TB/s), so the
// bytes bound it in either dtype (the f32 FMAs alone take 0.064 ms, 0.096
// with V).
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
//   CUDA cores (f32 correlation, and a base or pitch the tensor-core loop
//     does not take): simt_select.cuh's staged, register-tiled loop with
//     the products [w, v, r] in ONE pass (kNP = 3 with V, 2 without), so
//     the shard is read once; each thread holds z, zv and q of its 4 rows x
//     4 atoms, updates that 4 x 4 tile of resc in registers (one float4 a
//     row in and out, in place: each (row, atom) has one owner, no atomics)
//     and scores it; the warp's shuffles take each row's (max, lowest
//     argmax) over the tile. The shard's rows are lda entries apart: TMA
//     where the base is 16-byte aligned and lda % 4 == 0 (a column view of
//     the cdt dictionary, parallel/sharded.py), else cp.async. The paths'
//     B = 8 gives 2 warps a block: for W <= 2 the sweep takes the loop's
//     plans for few rows, picked by the grid (simt::launch_by_grid, shared
//     with stream_select.cu's top-1 sweep: 32 entries in 3 stages, 2 for
//     bf16, past two blocks an SM, 64 in 2 below; 0.37 ms at m = 131072
//     under the Wide plan against 0.21 under these, PERF.md §6). Wider
//     batches take the Wide plan. Every sum is one fmaf chain from +0 in p
//     order, as before the redesign, so resc, the partials and the picks
//     are unchanged bit for bit.
#include <cstdint>

#include "common.cuh"
#include "mma_rescaled.cuh"
#include "simt_select.cuh"

namespace cstpu {

// The CUDA-core sweep: the products [w, (v,) r] in one pass under plan P;
// then each thread applies the step to its 4 x 4 tile of resc and scores
// it, in the order and rounding of the note above, and each warp writes its
// rows' (max d2, lowest argmax) of the tile.
template <typename T, bool kUseV, typename P>
__global__ void __launch_bounds__(32 * P::kWarps)
fr_step_simt_kernel(const __grid_constant__ simt::Maps maps,
                    const float* __restrict__ r, const float* __restrict__ w,
                    const float* __restrict__ v, const T* __restrict__ A,
                    size_t lda, const int* __restrict__ il,
                    const float* __restrict__ cn2, float* __restrict__ resc,
                    float* __restrict__ pval, int* __restrict__ pidx, int B,
                    int n, int m, int ntiles, float deg) {
  using simt::kAT;
  using simt::kRT;
  constexpr int kNP = kUseV ? 3 : 2;  // z, (zv,) q
  extern __shared__ unsigned char smem[];
  const int tile = blockIdx.x, j0 = tile * kTile;
  const int row0 = blockIdx.y * kRT * (blockDim.x >> 5);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jl = j0 + kAT * lane;    // the thread's first atom (m % kTile == 0)
  const int rw = row0 + kRT * warp;  // the warp's first row
  const bool vec = (reinterpret_cast<uintptr_t>(resc) & 15) == 0;

  float acc[kNP][kRT][kAT];
  simt::sweep<T, kNP, P>(
      acc, smem, maps, A, lda,
      simt::Products{r, w, 0, 1, kUseV ? v : nullptr}, j0, row0, B, n, m,
      [&](int, int, float (&s)[kNP][kRT][kAT]) {
        float rmin[kAT];
#pragma unroll
        for (int c = 0; c < kAT; ++c) rmin[c] = __fmul_rn(deg, cn2[jl + c]);
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const int row = rw + i;
          if (row >= B) break;  // the warp's rows: uniform in the warp
          const int mark = il[2 * row], restore = il[2 * row + 1];
          float* rp = resc + (size_t)row * m + jl;
          float x[kAT];
          if (vec) {
            const float4 t = *reinterpret_cast<const float4*>(rp);
            x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
          } else {
#pragma unroll
            for (int c = 0; c < kAT; ++c) x[c] = rp[c];
          }
          float best = -INFINITY;
          int idx = INT_MAX;
#pragma unroll
          for (int c = 0; c < kAT; ++c) {
            const int j = jl + c;
            const float z = s[0][i][c], q = s[kNP - 1][i][c];
            float xv = j == restore ? 0.f : x[c];
            xv = __fadd_rn(xv, -__fmul_rn(z, z));
            if constexpr (kUseV) {
              xv = __fadd_rn(xv, __fmul_rn(s[1][i][c], s[1][i][c]));
            }
            if (j == mark) xv = -1.f;
            x[c] = xv;
            const float d = xv > rmin[c] ? __fdiv_rn(__fmul_rn(q, q), xv)
                                         : -INFINITY;
            argmax_combine(best, idx, d, j);
          }
          if (vec) {
            *reinterpret_cast<float4*>(rp) = make_float4(x[0], x[1], x[2], x[3]);
          } else {
#pragma unroll
            for (int c = 0; c < kAT; ++c) rp[c] = x[c];
          }
          warp_argmax(best, idx);
          if (lane == 0) {
            pval[(size_t)row * ntiles + tile] = best;
            pidx[(size_t)row * ntiles + tile] = idx;
          }
        }
      });
}

// The sweep's launch under the plan the grid picks (simt::launch_by_grid).
template <typename T, bool kUseV>
cudaError_t launch_step_sweep(const float* r, const float* w, const float* v,
                              const void* A, long long lda, const int* il,
                              const float* cn2, float* resc, float* pval,
                              int* pidx, int B, int n, int m, float deg,
                              cudaStream_t s) {
  const int ntiles = m / kTile;
  return simt::launch_by_grid<T, kUseV ? 3 : 2>(
      [](auto plan) { return fr_step_simt_kernel<T, kUseV, decltype(plan)>; },
      A, lda, simt::Products{r, w, 0, 1, kUseV ? v : nullptr}, B, n, m,
      ntiles, s, r, w, v, static_cast<const T*>(A), (size_t)lda, il, cn2,
      resc, pval, pidx, B, n, m, ntiles, deg);
}

template <typename T>
cudaError_t launch_fr_step(const float* r, const float* w, const float* v,
                           const void* A, long long lda, const int* il,
                           const float* cn2, float* resc, float* pval,
                           int* pidx, int B, int n, int m, float deg,
                           cudaStream_t s) {
  return v ? launch_step_sweep<T, true>(r, w, v, A, lda, il, cn2, resc,
                                        pval, pidx, B, n, m, deg, s)
           : launch_step_sweep<T, false>(r, w, v, A, lda, il, cn2, resc,
                                         pval, pidx, B, n, m, deg, s);
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
    err = cdt_bf16 ? launch_fr_step<__nv_bfloat16>(r, w, v, A, lda, il, cn2,
                                                   resc, pval, pidx, B, n, m,
                                                   deg, s)
                   : launch_fr_step<float>(r, w, v, A, lda, il, cn2, resc,
                                           pval, pidx, B, n, m, deg, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_stream_finish(pval, pidx, B, m / kTile, bpt, 0, val, idx, s));
}
