// The per-step streaming selects of the column-sharded solvers: one sweep of
// a dictionary shard against a batch of residuals that returns, per row, the
// finished (value, index) of the best atom (or of the best l atoms).
//
// Replaces cstpu/ops/stream_select.py::_select_kernel (top-1),
// ::_select_topl_kernel (running top-l), ::_select_masked_kernel (top-1 of
// |RA| + M with an additive f32 mask), and cstpu/ops/pallas_kernels.py::
// _corr_argmax_kernel (top-1 with R given as (n, B)). The TPU kernels walk
// the shard tile by tile on one core and carry a running pair (or l slots)
// from tile to tile; here the blocks run in parallel, so each select is two
// launches: a sweep that writes partials per row and per kTile atoms, and a
// finishing stage that folds them under the TPU kernel's rule.
//
// Math: scores = |round_cdt(R) . A_cdt| (+ M in f32), products and sums in
// f32 (no TF32). The top-1 sweeps have two hand-written variants, chosen
// by the Python wrapper's predicate and passed as `use_mma`: for bf16
// correlation the tensor-core loop of mma_select.cuh, the one
// select_argmax.cu runs, and otherwise the CUDA-core loop
// common.cuh::score_tile (each atom's sum in the order p = 0 .. n-1), which
// the top-l sweep keeps as well. In either loop an atom scores the same
// whatever the shard it lies in, so merged selections do not depend on the
// shard count.
//
// The rules of the finishing stages. The TPU kernels' tile is `bpt` sweep
// blocks wide (the wrapper computes it from `_stream_tile` or `_pick_tile`);
// it decides nothing about the launch, only which atoms share a NaN's fate:
//   top-1 (K6, K9): the running pair starts at (-inf, 0); a tile is folded
//     in only if its maximum is strictly larger, so the lowest index wins
//     ties, and a tile that holds a NaN score is skipped whole.
//   top-1, NaN visible (K10): the same fold up to the first tile that
//     holds a NaN; from there the value is NaN and the index stays.
//   top-l (K7): l slots start at (-inf, 0); each tile offers its own top l
//     (value descending, index ascending), each inserted over the lowest
//     slot that holds the running minimum, only if strictly larger; a tile
//     that holds a NaN is skipped. The slots come back in that order,
//     unsorted, as the TPU kernel leaves them. l <= kTile: a lane of the
//     finishing warp holds up to four slots.
//
// What bounds it on an H100: a sweep reads the cdt shard once (256 MB in
// bf16 at n=1024, m=131072: 0.08 ms at 3.35 TB/s) and does 2 B n m
// operations; at B=8 that is 8 FLOP per byte, so the bytes bound it. The
// tensor-core sweep fits its row count to B (N = 8 there) and streams the
// shard through a TMA-fed ring; the CUDA-core sweep computes kRows = 16
// rows whatever B is, so at B=8 half its multiply-adds are spent on
// padding and it runs over its byte bound. The partials are
// (B, m / kTile) pairs, 64 KB at that size; the finishing stage is one
// block (top-1) or one warp (top-l) per row.
#include <cstdint>

#include "common.cuh"
#include "mma_select.cuh"

namespace cstpu {

constexpr int kFinishThreads = 256;

// Sweep, top-1: per row and per block of kTile atoms the largest score and
// its lowest index; a NaN score makes the block's partial (NaN, INT_MAX).
template <typename T, bool kMasked>
__global__ void __launch_bounds__(kTile)
stream_sweep_kernel(const float* __restrict__ r, size_t ldr, size_t ldp,
                    const T* __restrict__ A, size_t lda,
                    const float* __restrict__ M, float* __restrict__ pval,
                    int* __restrict__ pidx, int B, int n, int m, int nblocks) {
  __shared__ __align__(16) float rs[kChunk][kRows];
  __shared__ float wv[kRows][kTile / 32];
  __shared__ int wi[kRows][kTile / 32];

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int j = tile * kTile + threadIdx.x;
  const bool live = j < m;

  float acc[kRows];
  score_tile<T>(acc, rs, r, A, row0, j, live, B, n, lda, ldr, ldp);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    float v = live ? fabsf(acc[q]) : -INFINITY;
    int i = live ? j : INT_MAX;
    if constexpr (kMasked) {
      const int row = row0 + q;
      if (live && row < B) v += M[(size_t)row * m + j];
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
      pval[(size_t)row * nblocks + tile] = v;
      pidx[(size_t)row * nblocks + tile] = i;
    }
  }
}

// Finish, top-1: one block per row folds the row's nblocks partials, bpt to
// a tile, into (val, idx) under the rules at the top of the file. The fold
// takes the larger value and, on equal values, the lower index, from
// (-inf, 0), over the tiles that hold no NaN: what the strict `>` walk over
// ascending tiles gives, in any order of reduction.
__global__ void __launch_bounds__(kFinishThreads)
stream_finish_kernel(const float* __restrict__ pval,
                     const int* __restrict__ pidx, int nblocks, int bpt,
                     int nan_visible, float* __restrict__ val,
                     int* __restrict__ idx) {
  __shared__ float sv[kFinishThreads / 32];
  __shared__ int si[kFinishThreads / 32];
  __shared__ int sfirst;

  const int row = blockIdx.x;
  const float* pv = pval + (size_t)row * nblocks;
  const int* pi = pidx + (size_t)row * nblocks;
  const int ntile = nblocks / bpt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) sfirst = ntile;
  __syncthreads();
  if (nan_visible) {  // the first tile that holds a NaN ends the fold
    int first = ntile;
    for (int e = threadIdx.x; e < nblocks; e += kFinishThreads) {
      if (isnan(pv[e])) first = min(first, e / bpt);
    }
    if (first < ntile) atomicMin(&sfirst, first);
    __syncthreads();
  }
  const int limit = sfirst;

  float bv = -INFINITY;
  int bi = 0;
  for (int t = warp; t < limit; t += kFinishThreads / 32) {
    float v = -INFINITY;
    int i = INT_MAX;
    for (int c = lane; c < bpt; c += 32) {
      argmax_combine(v, i, pv[(size_t)t * bpt + c], pi[(size_t)t * bpt + c]);
    }
    warp_argmax(v, i);
    v = __shfl_sync(0xffffffffu, v, 0);
    i = __shfl_sync(0xffffffffu, i, 0);
    if (!isnan(v) && (v > bv || (v == bv && i < bi))) {
      bv = v;
      bi = i;
    }
  }
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kFinishThreads / 32; ++w) {
      if (sv[w] > bv || (sv[w] == bv && si[w] < bi)) {
        bv = sv[w];
        bi = si[w];
      }
    }
    val[row] = limit < ntile ? __int_as_float(0x7fc00000) : bv;
    idx[row] = bi;
  }
}

// Sweep, top-l: per row and per block of kTile atoms the l largest scores
// (common.cuh::topl_partials), the main loop as above.
template <typename T>
__global__ void __launch_bounds__(kTile)
stream_topl_sweep_kernel(const float* __restrict__ r,
                         const T* __restrict__ A, size_t lda,
                         float* __restrict__ pval, int* __restrict__ pidx,
                         int B, int n, int m, int nblocks, int l) {
  __shared__ __align__(16) float rs[kChunk][kRows];
  __shared__ float ss[kRows][kTile];

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int j = tile * kTile + threadIdx.x;
  const bool live = j < m;

  float acc[kRows];
  score_tile<T>(acc, rs, r, A, row0, j, live, B, n, lda, (size_t)n,
                (size_t)1);

#pragma unroll
  for (int q = 0; q < kRows; ++q) ss[q][threadIdx.x] = live ? fabsf(acc[q]) : -INFINITY;
  __syncthreads();

  topl_partials(ss, tile, row0, B, m, nblocks, l, pval, pidx);
}

// Finish, top-l: one warp per row, lane s holds slots s, s + 32, ... (kPer
// of them, so l <= 32 kPer). Tile by tile, in order, the tile's candidates
// are drawn best first from its bpt sorted block lists (pos[c] = entries of
// list c already drawn) and inserted over the lowest slot that holds the
// running minimum while they are strictly larger; the first that is not
// ends the tile, since the candidates fall and the minimum rises.
template <int kPer>
__global__ void __launch_bounds__(32)
stream_topl_finish_kernel(const float* __restrict__ pval,
                          const int* __restrict__ pidx, int nblocks, int bpt,
                          int l, float* __restrict__ val,
                          int* __restrict__ idx) {
  extern __shared__ unsigned char pos[];  // bpt

  const int row = blockIdx.x, lane = threadIdx.x;
  const float* pv = pval + (size_t)row * nblocks * l;
  const int* pi = pidx + (size_t)row * nblocks * l;
  const int ntile = nblocks / bpt;

  // slots past l hold +inf, so they are never the running minimum's slot
  float sv[kPer];
  int si[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    sv[c] = lane + 32 * c < l ? -INFINITY : INFINITY;
    si[c] = 0;
  }
  for (int t = 0; t < ntile; ++t) {
    const int b0 = t * bpt;
    bool nan = false;  // a block that holds a NaN wrote NaN to all l entries
    for (int c = lane; c < bpt; c += 32) {
      nan |= isnan(pv[(size_t)(b0 + c) * l]);
      pos[c] = 0;
    }
    __syncwarp();
    if (__any_sync(0xffffffffu, nan)) continue;
    for (int round = 0; round < l; ++round) {
      float v = -INFINITY;
      int i = INT_MAX;
      for (int c = lane; c < bpt; c += 32) {
        const int p = pos[c];
        if (p < l) {
          const size_t e = (size_t)(b0 + c) * l + p;
          argmax_combine(v, i, pv[e], pi[e]);
        }
      }
      warp_argmax(v, i);
      v = __shfl_sync(0xffffffffu, v, 0);
      i = __shfl_sync(0xffffffffu, i, 0);
      float rmin = sv[0];
#pragma unroll
      for (int c = 1; c < kPer; ++c) rmin = fminf(rmin, sv[c]);
      for (int off = 16; off > 0; off >>= 1) {
        rmin = fminf(rmin, __shfl_xor_sync(0xffffffffu, rmin, off));
      }
      if (!(v > rmin)) break;
      bool placed = false;  // the same in every lane
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const unsigned eq = __ballot_sync(0xffffffffu, sv[c] == rmin);
        if (!placed && eq) {
          if (lane == __ffs(eq) - 1) {
            sv[c] = v;
            si[c] = i;
          }
          placed = true;
        }
      }
      if (lane == 0) pos[i / kTile - b0] += 1;
      __syncwarp();
    }
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int slot = lane + 32 * c;
    if (slot < l) {
      val[(size_t)row * l + slot] = sv[c];
      idx[(size_t)row * l + slot] = si[c];
    }
  }
}

// Most slots of the streamed top-l: a sweep block's width, four per lane of
// the finishing warp.
constexpr int kStreamTopLMax = kTile;

bool stream_tiling_ok(int m, int bpt) {
  return m > 0 && m % kTile == 0 && bpt >= 1 && (m / kTile) % bpt == 0;
}

cudaError_t launch_stream_finish(const float* pval, const int* pidx, int B,
                                 int nblocks, int bpt, int nan_visible,
                                 float* val, int* idx, cudaStream_t s) {
  stream_finish_kernel<<<B, kFinishThreads, 0, s>>>(pval, pidx, nblocks, bpt,
                                                    nan_visible, val, idx);
  return cudaGetLastError();
}

template <typename T>
void launch_sweep(const float* r, size_t ldr, size_t ldp, const void* A,
                  size_t lda, const float* M, float* pval, int* pidx, int B,
                  int n, int m, cudaStream_t s) {
  const int nblocks = m / kTile;
  const dim3 grid(nblocks, (B + kRows - 1) / kRows);
  const T* a = static_cast<const T*>(A);
  if (M) {
    stream_sweep_kernel<T, true><<<grid, kTile, 0, s>>>(
        r, ldr, ldp, a, lda, M, pval, pidx, B, n, m, nblocks);
  } else {
    stream_sweep_kernel<T, false><<<grid, kTile, 0, s>>>(
        r, ldr, ldp, a, lda, nullptr, pval, pidx, B, n, m, nblocks);
  }
}

}  // namespace cstpu

// Top-1 select of one shard. Entry (b, p) of the f32 residuals lies at
// r[b * ldr + p * ldp]; A (n, m) in cdt (bf16 if cdt_bf16 else f32) has unit
// column stride and rows lda entries apart; M, when not null, is a
// contiguous (B, m) f32 mask added to the scores. m is a multiple of kTile
// and bpt sweep blocks make one tile of the NaN rule. Scratch pval (B,
// m / kTile) f32 and pidx i32; writes val (B,) f32 and idx (B,) i32. With
// nan_visible a NaN score makes val NaN (K10's rule), else its tile is
// skipped (K6's and K9's). With use_mma the sweep is the tensor-core one,
// with rb (B, roundup(n, 8)) bf16 as its scratch for the rounded r; it
// takes bf16 only, A aligned to 16 bytes and lda a multiple of 8, and the
// call returns cudaErrorInvalidValue otherwise. Returns the first launch
// error.
extern "C" int cstpu_stream_select(const float* r, long long ldr,
                                   long long ldp, const void* A,
                                   long long lda, int cdt_bf16,
                                   const float* M, float* pval, int* pidx,
                                   float* val, int* idx, int B, int n, int m,
                                   int bpt, int nan_visible, int use_mma,
                                   void* rb, void* stream) {
  using namespace cstpu;
  if (!stream_tiling_ok(m, bpt) || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_mma) {
    if (!cdt_bf16) return static_cast<int>(cudaErrorInvalidValue);
    __nv_bfloat16* rbf = static_cast<__nv_bfloat16*>(rb);
    if (M) {
      err = mma::launch_top1<mma::kAddMask>(r, ldr, ldp, rbf, A, lda, pval,
                                            pidx, nullptr, nullptr, M, 1.f, B,
                                            n, m, m / kTile, s);
    } else {
      err = mma::launch_top1<mma::kAbs>(r, ldr, ldp, rbf, A, lda, pval, pidx,
                                        nullptr, nullptr, nullptr, 1.f, B, n,
                                        m, m / kTile, s);
    }
  } else {
    if (cdt_bf16) {
      launch_sweep<__nv_bfloat16>(r, ldr, ldp, A, lda, M, pval, pidx, B, n, m, s);
    } else {
      launch_sweep<float>(r, ldr, ldp, A, lda, M, pval, pidx, B, n, m, s);
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_stream_finish(pval, pidx, B, m / kTile, bpt,
                                              nan_visible, val, idx, s));
}

// Top-l select of one shard: r (B, n) f32 contiguous, A as above, 1 <= l <=
// kStreamTopLMax. Scratch pval, pidx (B, m / kTile, l); writes val (B, l) f32 and
// idx (B, l) i32, slots in the running set's own order, (-inf, 0) where
// never filled. Returns the first launch error.
extern "C" int cstpu_stream_topl(const float* r, const void* A, long long lda,
                                 int cdt_bf16, float* pval, int* pidx,
                                 float* val, int* idx, int B, int n, int m,
                                 int l, int bpt, void* stream) {
  using namespace cstpu;
  if (!stream_tiling_ok(m, bpt) || B < 1 || l < 1 || l > kStreamTopLMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nblocks = m / kTile;
  const dim3 grid(nblocks, (B + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    stream_topl_sweep_kernel<__nv_bfloat16><<<grid, kTile, 0, s>>>(
        r, static_cast<const __nv_bfloat16*>(A), lda, pval, pidx, B, n, m,
        nblocks, l);
  } else {
    stream_topl_sweep_kernel<float><<<grid, kTile, 0, s>>>(
        r, static_cast<const float*>(A), lda, pval, pidx, B, n, m, nblocks, l);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l <= 32) {
    stream_topl_finish_kernel<1><<<B, 32, bpt, s>>>(pval, pidx, nblocks, bpt, l,
                                                    val, idx);
  } else if (l <= 64) {
    stream_topl_finish_kernel<2><<<B, 32, bpt, s>>>(pval, pidx, nblocks, bpt, l,
                                                    val, idx);
  } else {
    stream_topl_finish_kernel<4><<<B, 32, bpt, s>>>(pval, pidx, nblocks, bpt, l,
                                                    val, idx);
  }
  return static_cast<int>(cudaGetLastError());
}
