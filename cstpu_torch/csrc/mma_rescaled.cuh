// The tensor-core loop of the rescaled OLS selects, shared by fr_select.cu
// (batched FR, SRR, RMP and FoBa: K3, K14, K15, K16) and fr_step_select.cu
// (the column-sharded FR step, K8), for the bf16 correlation dtype. Both
// compute, per measurement row b and atom j, several products of cdt-rounded
// rows with the same dictionary column, fold all but the last into the
// rescaling resc (B, m) in place and score the last, the residual's:
//
//   z_t = round_bf16(u_t[b]) . a_j          t = 0 .. nterms-1, in order
//   resc += (w_t z_t) z_t                   fr_select: w_t = wsign W[t, b];
//                                           K8: w_0 = -1 (the append's
//                                           downdate), w_1 = +1 (V)
//   q = round_bf16(r[b]) . a_j
//   d2 = resc > thr * cn2_j ? q q / resc : -inf
//
// with K8's restore (resc = 0 before the terms) and mark (resc = -1 after
// them), and fr_select's active atoms scoring 0, which takes precedence. Each
// operation is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn), as the
// CUDA-core kernels and the TPU kernels write them. The per-tile (max d2,
// lowest argmax) partials follow argmax_combine's total order.
//
// What bounds it on an H100: the bf16 dictionary read once (16 MB at n=1024,
// m=8192; 256 MB for K8's shard at m_local=131072) and resc read and written
// (B m f32 each way), against 2 (1 + nterms) B n m operations: at B = 8 and
// two or three products 16-24 per dictionary byte, far under the tensor
// cores' 295, so the bytes bound it, except for SRR's first call (17
// products at B = 64), where the operations come near.
//
// Design: mma_select.cuh's loop, score_tile_mma (the TMA-fed ring of two
// 64-atom halves read MN-major, a producer warp, four consumer warps issuing
// wgmma), with wgmma's N operand no longer one block of rows but the rows of
// every product, stacked and interleaved in groups of 8: for row group g and
// product slot s, the 8 rows of the product take column group c = g Pn + s.
// In wgmma's accumulator layout thread (w, l) holds acc[h][4 c + e] for row
// 2 (l % 4) + e % 2 of column group c, so every thread holds all the products
// of the SAME (row, atom) entries: the epilogue needs no shuffle and no
// shared memory to bring a row's products together, and one thread owns each
// resc entry for the whole launch (no atomics). The top-1 selects' rounding
// launch (`round_rows`) writes that interleaved bf16 operand from the f32
// rows, rounding to nearest even. A pass takes Pn = 2 or 4 product slots; the
// products beyond go
// through further passes of the ring over the SAME tile (its bytes then come
// from the L2), in order, the residual's last, so resc is the only state
// carried from pass to pass and q is scored as it comes. The producer runs
// ahead across the passes, so one pass's epilogue overlaps the next one's
// loads. Rows per block: 8 G with G in {1, 2, 4}, N = 8 G Pn <= 64.
//
// What the arithmetic guarantees: every product is the loop's sum of n exact
// bf16 x bf16 products from p = 0 in k-steps of 16, the instruction sequence
// of the top-1 selects; so equal columns give equal products whatever their
// tile, shard offset, batch or product slot, and the sharded solvers keep
// equal supports across shard counts. Bits equal to the CUDA-core kernels'
// are not guaranteed: the sums differ in their last bits.
#pragma once

#include "mma_select.cuh"

namespace cstpu {
namespace mma {

// One block of a rescaled select: G row groups of 8 (row chunk blockIdx.y)
// against the tile blockIdx.x, the stacked operand in npass passes of Pn
// product slots. resc (B, m) f32 updated in place (K8 always, fr_select when
// it has terms); the tile's per-row (max d2, lowest argmax) into pval/pidx at
// [row, tile], rows ldpart apart. kStep: K8 (il (B, 2) [mark, restore], no
// amask, weights -1 and +1); else fr_select (W (nterms, B), wsign, amask
// (B, m) u8).
template <int G, int Pn, bool kStep>
__global__ void __launch_bounds__(kThreads)
rescaled_mma_kernel(const __grid_constant__ CUtensorMap mapA,
                    const __grid_constant__ CUtensorMap mapS,
                    const float* __restrict__ W, float wsign, int nterms,
                    int npass, const float* __restrict__ cn2,
                    const uint8_t* __restrict__ amask,
                    const int* __restrict__ il, float* __restrict__ resc,
                    float* __restrict__ pval, int* __restrict__ pidx, int B,
                    int n, int m, int ldpart, float thr) {
  constexpr int NB = 8 * G * Pn;  // wgmma's N: every product's rows
  constexpr int NR = 8 * G;       // measurement rows of the block
  extern __shared__ unsigned char smem[];
  __shared__ float wv[kConsumers / 32][NR];
  __shared__ int wi[kConsumers / 32][NR];

  const int tile = blockIdx.x;
  const int j0 = tile * kTile, row0 = blockIdx.y * NR;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  // the thread's entries [h][4 g + e]: atom j0 + 64 h + 16 w + l / 4 +
  // 8 (e / 2), row row0 + 8 g + 2 (l % 4) + e % 2
  const auto atom = [&](int h, int e) {
    return j0 + kHalf * h + 16 * w + (l >> 2) + 8 * (e >> 1);
  };
  const auto row_of = [&](int g, int e) {
    return row0 + 8 * g + 2 * (l & 3) + (e & 1);
  };

  // resc, read before the loop so that the loads overlap it (K8's restore
  // on a zero base); the scores at the end
  float x[2][4 * G];
  if (threadIdx.x < kConsumers) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = atom(h, e), row = row_of(g, e);
          float v = 0.f;
          if (j < m && row < B) {
            v = resc[(size_t)row * m + j];
            if constexpr (kStep) {
              if (j == il[2 * row + 1]) v = 0.f;
            }
          }
          x[h][4 * g + e] = v;
        }
      }
    }
  }

  float acc[2][NB / 2];
  const auto epi = [&](int pass) {
#pragma unroll
    for (int s = 0; s < Pn; ++s) {
      const int p = pass * Pn + s;
      if (p < nterms) {  // a rescaling term, in order
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row_of(g, e);
            if (row >= B) continue;
            float wt;
            if constexpr (kStep) {
              wt = p == 0 ? -1.f : 1.f;
            } else {
              wt = __fmul_rn(wsign, W[(size_t)p * B + row]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float z = acc[h][4 * (g * Pn + s) + e];
              x[h][4 * g + e] = __fadd_rn(x[h][4 * g + e],
                                          __fmul_rn(__fmul_rn(wt, z), z));
            }
          }
        }
      } else if (p == nterms) {  // the residual's product: score it
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = atom(h, e), row = row_of(g, e);
              float d = -INFINITY;
              if (j < m && row < B) {
                const size_t at = (size_t)row * m + j;
                float xv = x[h][4 * g + e];
                if constexpr (kStep) {
                  if (j == il[2 * row]) xv = -1.f;
                }
                if (kStep || nterms > 0) resc[at] = xv;
                const float q = acc[h][4 * (g * Pn + s) + e];
                d = xv > __fmul_rn(thr, cn2[j])
                        ? __fdiv_rn(__fmul_rn(q, q), xv)
                        : -INFINITY;
                if constexpr (!kStep) {
                  if (amask[at]) d = 0.f;
                }
              }
              x[h][4 * g + e] = d;
            }
          }
        }
      }
    }
  };
  score_tile_mma<NB>(acc, smem, &mapA, &mapS, j0, blockIdx.y * NB,
                     gridDim.y * NB, npass, n, epi);

  if (threadIdx.x < kConsumers) {
    fragment_argmax<NR, false>(
        x, j0, m, [](int, int, float d) { return d; }, wv, wi, nullptr);
  }
  __syncthreads();
  if (threadIdx.x < NR) {
    const int q = threadIdx.x, row = row0 + q;
    float v = wv[0][q];
    int i = wi[0][q];
    for (int k = 1; k < kConsumers / 32; ++k) {
      argmax_combine(v, i, wv[k][q], wi[k][q]);
    }
    if (row < B) {
      pval[(size_t)row * ldpart + tile] = v;
      pidx[(size_t)row * ldpart + tile] = i;
    }
  }
}

// ------------------------------------------------------------- host ----

// The launch plan of a rescaled select for B rows, `nterms` rescaling
// products before the residuals' and `ntiles` tiles. A block takes G row
// groups of 8 and Pn product slots, wgmma's N = 8 G Pn <= 64: Pn = 2 for up
// to two products, else 4, the products beyond Pn in further passes over the
// same tile (npass in all). G fits the batch, then is halved while twice the
// blocks would still fit the card's kSMs, as rows_per_block does for the
// top-1 selects. nchunks row chunks of 8 G; `rows` is the stacked operand's
// row count, npass nchunks 8 G Pn.
struct RescaledPlan {
  int G, Pn, npass, nchunks;
  long long rows;
};

inline RescaledPlan rescaled_plan(int B, int nterms, int ntiles) {
  RescaledPlan p;
  p.Pn = nterms <= 1 ? 2 : 4;
  const int groups = (B + 7) / 8;
  p.G = 1;
  while (p.G < 8 / p.Pn && p.G < groups) p.G *= 2;
  while (p.G > 1 &&
         (long long)ntiles * ((groups + p.G - 1) / p.G) * 2 <= kSMs) {
    p.G /= 2;
  }
  p.npass = (nterms + p.Pn) / p.Pn;
  p.nchunks = (groups + p.G - 1) / p.G;
  p.rows = (long long)p.npass * p.nchunks * 8 * p.G * p.Pn;
  return p;
}

template <int G, int Pn, bool kStep>
cudaError_t launch_rescaled_blocks(const CUtensorMap& mapA,
                                   const CUtensorMap& mapS, const float* W,
                                   float wsign, int nterms, int npass,
                                   int nchunks, const float* cn2,
                                   const uint8_t* amask, const int* il,
                                   float* resc, float* pval, int* pidx, int B,
                                   int n, int m, int ldpart, float thr,
                                   cudaStream_t s) {
  auto kern = rescaled_mma_kernel<G, Pn, kStep>;
  constexpr int kSmem = static_cast<int>(smem_bytes<8 * G * Pn>());
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kTile - 1) / kTile, nchunks);
  kern<<<grid, kThreads, kSmem, s>>>(mapA, mapS, W, wsign, nterms, npass,
                                     cn2, amask, il, resc, pval, pidx, B, n,
                                     m, ldpart, thr);
  return cudaGetLastError();
}

// The whole rescaled select on stream s: stacks the products (nu terms of u,
// ustride apart, V when not null, then r; each a contiguous (B, n) f32
// matrix) into sb, sb_rows x roundup(n, 8) bf16, then sweeps A (n, m) bf16,
// rows lda apart, under rescaled_plan, and writes the per-tile partials, rows
// ldpart apart. cudaErrorInvalidValue for what the loop does not take or an
// sb that does not hold the plan's rows.
template <bool kStep>
cudaError_t launch_rescaled(const float* r, const float* u, size_t ustride,
                            int nu, const float* v, const float* W,
                            float wsign, const void* A, long long lda,
                            const float* cn2, const uint8_t* amask,
                            const int* il, float* resc, float* pval,
                            int* pidx, int B, int n, int m, int ldpart,
                            float thr, __nv_bfloat16* sb, long long sb_rows,
                            cudaStream_t s) {
  if (sb == nullptr || nu < 0 || !takes(A, lda, B, n, m)) {
    return cudaErrorInvalidValue;
  }
  const int nterms = nu + (v ? 1 : 0);
  const RescaledPlan pl = rescaled_plan(B, nterms, (m + kTile - 1) / kTile);
  if (sb_rows < pl.rows) return cudaErrorInvalidValue;
  const int n8 = (n + 7) / 8 * 8;
  cudaError_t err = round_rows(r, u, ustride, nu, v, n, 1, sb, B, n, n8,
                               pl.Pn, pl.nchunks * pl.G, pl.rows, s);
  if (err != cudaSuccess) return err;
  CUtensorMap mapA, mapS;
  err = tensor_map(&mapA, A, m, n, lda, kChunk);
  if (err != cudaSuccess) return err;
  err = tensor_map(&mapS, sb, n8, pl.rows, n8, 8 * pl.G * pl.Pn);
  if (err != cudaSuccess) return err;
#define CSTPU_RESCALED(G_, P_)                                             \
  if (pl.G == G_ && pl.Pn == P_) {                                         \
    return launch_rescaled_blocks<G_, P_, kStep>(                          \
        mapA, mapS, W, wsign, nterms, pl.npass, pl.nchunks, cn2, amask, il, \
        resc, pval, pidx, B, n, m, ldpart, thr, s);                        \
  }
  CSTPU_RESCALED(1, 2)
  CSTPU_RESCALED(2, 2)
  CSTPU_RESCALED(4, 2)
  CSTPU_RESCALED(1, 4)
  CSTPU_RESCALED(2, 4)
#undef CSTPU_RESCALED
  return cudaErrorInvalidValue;
}

}  // namespace mma
}  // namespace cstpu
