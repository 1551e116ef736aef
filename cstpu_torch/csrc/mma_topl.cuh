// The top-l epilogue of the tensor-core loop, shared by select_topl.cu
// (batched GOMP and SP, and the top-k init of OMPR and SRR) and the top-l
// sweep of stream_select.cu (the column-sharded solvers, K7), for the bf16
// correlation dtype. The block runs mma_select.cuh::score_tile_mma with one
// pass, exactly as top1_mma_kernel does, so an atom scores the same bits here
// as in the top-1 selects, in any tile, shard or batch; then, per row of the
// block, it writes the tile's l best (value descending, index ascending).
//
// Replaces, on the card, the score GEMM and the top-l picks of cstpu/ops/
// fused_solve.py::_gomp_kernel (:788-793), fused_twostage.py::_sp_kernel and
// the top-k init of ::_ompr_kernel and ::_srr_kernel, and the per-tile
// candidates of cstpu/ops/stream_select.py::_select_topl_kernel.
//
// What bounds it: the loop is the top-1 select's (the bytes of the bf16
// dictionary, mma_select.cuh's note). The epilogue must not cost l rounds of
// a warp argmax, as the CUDA-core epilogue once did (at l = 32 that
// epilogue took about 60% of the CUDA-core kernel). Design:
//   * the consumers stage the accumulator fragments as |s| in f32, ss[NB]
//     [kTile + 4] (the pad of 4 puts the 32 lanes of a fragment store on 32
//     banks), in the ring: the last wgmma has retired and every stage has
//     been consumed, so after a block barrier the ring is free, and the
//     block needs no shared memory beyond the loop's (an extra buffer would
//     cost a block per SM at NB = 64);
//   * every warp of the block, the producer's too, takes rows two at a
//     time: a lane holds four scores of each row as 64-bit keys
//     (common.cuh::topl_key: the score's bits high, ~index low), pads past
//     m keyed 0, and common.cuh::warp_sort128_desc orders the row's 128
//     keys across the warp: 28 compare-exchange steps, 15 of them across
//     lanes, whatever l (1 to 128), so the cost is flat in l. The two rows
//     interleave for ILP;
//   * the first l keys are written as (value, index): a tile holding a NaN
//     writes l (NaN, INT_MAX), a pad (-inf, INT_MAX), as the CUDA-core
//     epilogue (simt_select.cuh::topl_epilogue) does. Rows >= B and atoms
//     >= m are never written.
// The first entry of a tile is the top-1 select's partial bit for bit: the
// largest key is the largest score with its lowest index.
#pragma once

#include <cstdint>

#include "mma_select.cuh"

namespace cstpu {
namespace mma {

constexpr int kSsRow = kTile + 4;  // floats of a staged score row

// One block of a top-l select: for rows row0 .. row0 + NB - 1 and the tile
// at atom j0 = blockIdx.x * kTile, the l best of |round_bf16(r) . A| into
// pval/pidx (B, ntiles, l), 1 <= l <= kTile.
template <int NB>
__global__ void __launch_bounds__(kThreads)
topl_mma_kernel(const __grid_constant__ CUtensorMap mapA,
                const __grid_constant__ CUtensorMap mapR,
                float* __restrict__ pval, int* __restrict__ pidx, int B,
                int n, int m, int ntiles, int l) {
  extern __shared__ unsigned char smem[];
  static_assert(NB * kSsRow * sizeof(float) <= kStages * stage_bytes<NB>(),
                "the staged scores fit the ring");

  const int tile = blockIdx.x;
  const int j0 = tile * kTile, row0 = blockIdx.y * NB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float acc[2][NB / 2];
  score_tile_mma<NB>(acc, smem, &mapA, &mapR, j0, row0, 0, 1, n,
                     [](int) {});
  __syncthreads();  // every stage consumed, the last wgmma retired

  // the scores overlay the ring from the base of shared memory; its
  // barriers sit past the last stage
  float* ss = reinterpret_cast<float*>(smem);
  if (threadIdx.x < kConsumers) {
    // fragment layout as in fragment_argmax
#pragma unroll
    for (int c = 0; c < NB / 8; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int up = 0; up < 2; ++up) {
          const int a = kHalf * h + 16 * warp + (lane >> 2) + 8 * up;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 8 * c + 2 * (lane & 3) + e;
            const float s = acc[h][4 * c + 2 * up + e];
            ss[q * kSsRow + a] = j0 + a < m ? fabsf(s) : -INFINITY;
          }
        }
      }
    }
  }
  __syncthreads();

  const int rows = min(NB, B - row0);
  for (int q0 = kSortRows * warp; q0 < rows;
       q0 += kSortRows * (kThreads / 32)) {
    TopKey x[kSortRows][4];
    bool nan[kSortRows];
#pragma unroll
    for (int r = 0; r < kSortRows; ++r) {
      const int q = min(q0 + r, rows - 1);  // an odd last row sorts twice
      const float4 v4 =
          *reinterpret_cast<const float4*>(ss + q * kSsRow + 4 * lane);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      bool any = false;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x[r][c] = v[c] == -INFINITY ? 0ull : topl_key(v[c], j0 + 4 * lane + c);
        any |= isnan(v[c]);
      }
      nan[r] = __any_sync(0xffffffffu, any);
    }
    warp_sort128_desc<kSortRows>(x);
#pragma unroll
    for (int r = 0; r < kSortRows; ++r) {
      if (q0 + r >= rows) break;
      const size_t base = ((size_t)(row0 + q0 + r) * ntiles + tile) * l;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = 4 * lane + c;
        if (p < l) {
          const TopKey key = x[r][c];
          float v = key ? __uint_as_float(static_cast<uint32_t>(key >> 32))
                        : -INFINITY;
          int i = key ? static_cast<int>(~static_cast<uint32_t>(key))
                      : INT_MAX;
          if (nan[r]) {
            v = __int_as_float(0x7fc00000);
            i = INT_MAX;
          }
          pval[base + p] = v;
          pidx[base + p] = i;
        }
      }
    }
  }
}

template <int NB>
cudaError_t launch_topl_blocks(const CUtensorMap& mapA,
                               const CUtensorMap& mapR, float* pval,
                               int* pidx, int B, int n, int m, int l,
                               cudaStream_t s) {
  auto kern = topl_mma_kernel<NB>;
  constexpr int kSmem = static_cast<int>(smem_bytes<NB>());
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int ntiles = (m + kTile - 1) / kTile;
  const dim3 grid(ntiles, (B + NB - 1) / NB);
  kern<<<grid, kThreads, kSmem, s>>>(mapA, mapR, pval, pidx, B, n, m, ntiles,
                                     l);
  return cudaGetLastError();
}

// The whole top-l select on stream s: rounds r (entry (b, p) at r[b ldr +
// p ldp]) into rb (B, roundup(n, 8)) bf16, then sweeps A (n, m) bf16, rows
// lda apart, and writes the partials (B, ceil(m / kTile), l). The row split
// is the top-1 selects' (rows_per_block). A split of its own that keeps two
// blocks on every SM (16 rows a block at B=64, m=8192), so that one block's
// sort overlaps the other's loads, took 0.0194-0.0199 ms there against
// 0.0206 on an H100 (700 W): too little for a second rule.
// cudaErrorInvalidValue for what the loop does not take and for l outside
// 1..kTile.
inline cudaError_t launch_topl(const float* r, size_t ldr, size_t ldp,
                               __nv_bfloat16* rb, const void* A,
                               long long lda, float* pval, int* pidx, int B,
                               int n, int m, int l, cudaStream_t s) {
  if (rb == nullptr || !takes(A, lda, B, n, m) || l < 1 || l > kTile) {
    return cudaErrorInvalidValue;
  }
  const int n8 = (n + 7) / 8 * 8;
  cudaError_t err = round_rows(r, nullptr, 0, 0, nullptr, ldr, ldp, rb, B, n,
                               n8, 1, (B + 7) / 8, B, s);
  if (err != cudaSuccess) return err;
  const int nb = rows_per_block(B, (m + kTile - 1) / kTile);
  CUtensorMap mapA, mapR;
  err = tensor_map(&mapA, A, m, n, lda, kChunk);
  if (err != cudaSuccess) return err;
  err = tensor_map(&mapR, rb, n8, B, n8, nb);
  if (err != cudaSuccess) return err;
  switch (nb) {
    case 8:
      return launch_topl_blocks<8>(mapA, mapR, pval, pidx, B, n, m, l, s);
    case 16:
      return launch_topl_blocks<16>(mapA, mapR, pval, pidx, B, n, m, l, s);
    case 32:
      return launch_topl_blocks<32>(mapA, mapR, pval, pidx, B, n, m, l, s);
    default:
      return launch_topl_blocks<64>(mapA, mapR, pval, pidx, B, n, m, l, s);
  }
}

}  // namespace mma
}  // namespace cstpu
