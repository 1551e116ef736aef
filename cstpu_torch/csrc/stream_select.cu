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
// f32 (no TF32). Every sweep has two hand-written variants, chosen by the
// Python wrapper's predicate and passed as `use_mma`: for bf16 correlation
// the tensor-core loop of mma_select.cuh, the one select_argmax.cu runs
// (with mma_topl.cuh's epilogue for the top-l sweep, the one select_topl.cu
// runs); otherwise (f32 correlation, and the bf16 catch-all)
// simt_select.cuh's staged, register-tiled CUDA-core loop, each atom's sum
// one fmaf chain in the order p = 0 .. n-1, with the epilogue of the
// CUDA-core select it mirrors:
//   top-1 (K6, K9, K10; `stream_top1_simt_kernel`): select_argmax.cu's,
//     each thread's 4 rows x 4 atoms scored and reduced in registers, then
//     across the warp;
//   top-l (K7; `stream_topl_simt_kernel`): select_topl.cu's
//     (simt::topl_epilogue), each warp's rows sorted in registers.
// So every partial equals the CUDA-core select's on the shard's contiguous
// copy bit for bit. In either variant an atom scores the same whatever the
// shard it lies in, so merged selections do not depend on the shard count.
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
//     unsorted, as the TPU kernel leaves them. Any l >= 1: a sweep block
//     offers its min(l, kTile) best, so past kTile slots its list is the
//     whole block, sorted, and the finish takes the wide route below.
//
// What bounds it on an H100: a sweep reads the cdt shard once (256 MB in
// bf16 at n=1024, m=131072: 0.08 ms at 3.35 TB/s) and does 2 B n m
// operations; at B=8 that is 8 FLOP per byte, so the bytes bound it (in
// f32 too: 537 MB, 0.16 ms, against 0.03 ms of f32 FMAs). The tensor-core
// sweeps fit their row count to B (N = 8 there) and stream the shard
// through a TMA-fed ring; so do the CUDA-core sweeps (4 rows a warp, 2
// warps a block at B=8, the few-row plans of simt_select.cuh picked by the
// grid, TMA for the shard where its base and pitch allow). The top-l
// sweep's sort is a whole tile's whatever l, so its epilogue costs the same
// from l = 1 to kTile. The top-1 partials are
// (B, m / kTile) pairs, 64 KB at that size, and its finishing stage is one
// block per row. The top-l partials are l times as many; its finishing
// stage (cstpu_stream_topl_finish, one for both sweeps) is two launches,
// so that no thread walks the lists one dependent read after another: one
// block per (tile, row) merges the tile's sorted block lists into the
// tile's top l, then one block per row folds the tiles' lists in order,
// all slots of a tile at once.
//
// Past l = kTile (the wide route: SP, OMPR and SRR at k > 128, GOMP at
// l > 128) the same two launches hold more: the merge keeps lists of up
// to the power of two >= l, and the fold keeps its slots sorted by (value,
// slot) in a block-wide array, so that a tile costs one pass over its
// candidates and one bitonic merge of the slots (log2 l barrier steps),
// not l compares per slot. Both keep their keys in shared memory up to
// kWideSmem a block, and past it in the caller's scratch
// (cstpu_stream_topl_work says how much).
#include <cstdint>

#include "common.cuh"
#include "mma_select.cuh"
#include "mma_topl.cuh"
#include "simt_select.cuh"

namespace cstpu {

constexpr int kFinishThreads = 256;
// The top-l finish: threads of a merge block, 64-bit keys a merge buffer
// holds (two buffers, 32 KB), candidates the fold stages at once (32 KB).
constexpr int kMergeThreads = 256;
constexpr int kMergeKeys = 2048;
constexpr int kFoldKeys = 4096;
// The wide route: most dynamic shared memory a block takes before its keys
// move to the caller's scratch; threads of a merge block (one block a tile
// and row, too few to fill the card at 256: each thread's binary searches
// are a chain of dependent shared loads, and more warps hide them) and
// most threads of a fold block.
constexpr size_t kWideSmem = 160 * 1024;
constexpr int kWideMergeThreads = 1024;
constexpr int kWideFoldThreads = 1024;

// Sweep, top-1, on the CUDA cores: per row and per block of kTile atoms the
// largest score and its lowest index; a NaN score makes the block's partial
// (NaN, INT_MAX). simt_select.cuh's loop with one product, r read through
// its strides (entry (b, p) at b ldr + p ldp; with kColR, ldp != 1, stored
// as columns), under plan P; then the
// epilogue of select_argmax.cu's select_simt_kernel: each thread scores its
// 4 rows x 4 atoms (|s|, with kMasked plus M[row, j] in f32, as the TPU
// kernel adds it), reduces each row's four with argmax_combine, and the
// warp's shuffles take the row's (max, lowest argmax) over the tile.
// argmax_combine is a total order with an absorbing NaN, so the order of
// the reduction does not change a partial. m is a multiple of kTile: every
// atom of a block is live.
template <typename T, bool kMasked, bool kColR, typename P>
__global__ void __launch_bounds__(32 * P::kWarps)
stream_top1_simt_kernel(const __grid_constant__ simt::Maps maps,
                        const float* __restrict__ r, long long ldr,
                        long long ldp, const T* __restrict__ A, size_t lda,
                        const float* __restrict__ M,
                        float* __restrict__ pval, int* __restrict__ pidx,
                        int B, int n, int m, int ntiles) {
  using simt::kAT;
  using simt::kRT;
  extern __shared__ unsigned char smem[];
  const int tile = blockIdx.x, j0 = tile * kTile;
  const int row0 = blockIdx.y * kRT * (blockDim.x >> 5);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jl = j0 + kAT * lane;    // the thread's first atom
  const int rw = row0 + kRT * warp;  // the warp's first row
  const bool vec = (reinterpret_cast<uintptr_t>(M) & 15) == 0;

  float acc[1][kRT][kAT];
  simt::sweep<T, 1, P, kColR>(
      acc, smem, maps, A, lda,
      simt::Products{r, nullptr, 0, 0, nullptr, ldr, ldp}, j0, row0, B, n,
      m, [&](int, int, float (&s)[1][kRT][kAT]) {
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const int row = rw + i;
          if (row >= B) break;  // the warp's rows: uniform in the warp
          float add[kAT] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (kMasked) {
            const float* mp = M + (size_t)row * m + jl;
            if (vec) {
              const float4 t = *reinterpret_cast<const float4*>(mp);
              add[0] = t.x, add[1] = t.y, add[2] = t.z, add[3] = t.w;
            } else {
#pragma unroll
              for (int c = 0; c < kAT; ++c) add[c] = mp[c];
            }
          }
          float v = -INFINITY;
          int idx = INT_MAX;
#pragma unroll
          for (int c = 0; c < kAT; ++c) {
            float x = fabsf(s[0][i][c]);
            if constexpr (kMasked) x = __fadd_rn(x, add[c]);
            argmax_combine(v, idx, x, jl + c);
          }
          warp_argmax(v, idx);
          if (lane == 0) {
            pval[(size_t)row * ntiles + tile] = v;
            pidx[(size_t)row * ntiles + tile] = idx;
          }
        }
      });
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

// Sweep, top-l, on the CUDA cores: per row and per block of kTile atoms the
// l best scores, value descending then index ascending, a block holding a
// NaN all l (NaN, INT_MAX). simt_select.cuh's loop with one product, r a
// contiguous (B, n), under plan P; then the epilogue of select_topl.cu's
// CUDA-core variant (simt::topl_epilogue: each warp's rows sorted in
// registers, the first l written). m is a multiple of kTile: every atom of
// a block is live, so no pads.
template <typename T, typename P>
__global__ void __launch_bounds__(32 * P::kWarps)
stream_topl_simt_kernel(const __grid_constant__ simt::Maps maps,
                        const float* __restrict__ r, const T* __restrict__ A,
                        size_t lda, float* __restrict__ pval,
                        int* __restrict__ pidx, int B, int n, int m,
                        int ntiles, int l) {
  using simt::kAT;
  using simt::kRT;
  extern __shared__ unsigned char smem[];
  const int tile = blockIdx.x, j0 = tile * kTile;
  const int row0 = blockIdx.y * kRT * (blockDim.x >> 5);
  const int jl = j0 + kAT * (threadIdx.x & 31);    // the thread's first atom
  const int rw = row0 + kRT * (threadIdx.x >> 5);  // the warp's first row

  float acc[1][kRT][kAT];
  simt::sweep<T, 1, P>(
      acc, smem, maps, A, lda,
      simt::Products{r, nullptr, 0, 0, nullptr, n, 1}, j0, row0, B, n, m,
      [&](int, int, float (&s)[1][kRT][kAT]) {
        simt::topl_epilogue(s[0], jl, rw, B, m, tile, ntiles, l, pval, pidx);
      });
}

// Finish, top-l, stage 1: one block per (tile, row) merges the tile's bpt
// sorted block lists into the tile's own top l, in place over the first
// block's list (rows of pval/pidx (B, nblocks, l)); a tile that holds a NaN
// writes (NaN, INT_MAX) over all l entries of that list instead. The lists are loaded
// once, coalesced, as 64-bit keys (value bits high, ~index low; a list
// padded to L = the power of two >= l with keys 0), kMergeKeys at a time,
// and merged pairwise in shared memory: an entry's place in the merge of two
// lists is its own place plus, by binary search, the number of the other
// list's keys before it. Every level halves the lists and keeps the first L
// of each merge, so a group costs about 2 G L log2(L) shared-memory reads
// over the block, and the first group's result carries into the next as its
// list 0 when the tile has more lists than a group holds.
__global__ void __launch_bounds__(kMergeThreads)
stream_topl_merge_kernel(float* __restrict__ pval, int* __restrict__ pidx,
                         int nblocks, int bpt, int l) {
  __shared__ unsigned long long buf[2][kMergeKeys];
  const int t = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  int L = 1;
  while (L < l) L <<= 1;
  const int G = kMergeKeys / L;  // lists a group holds, >= 16
  float* pv = pval + ((size_t)row * nblocks + (size_t)t * bpt) * l;
  int* pi = pidx + ((size_t)row * nblocks + (size_t)t * bpt) * l;

  // a block that holds a NaN wrote NaN to all l entries: the loads see it
  bool nan = false;
  int src = 0;
  for (int first = 0; first < bpt;) {
    const int keep = first > 0;  // list 0 holds the result so far
    const int take = min(bpt - first, G - keep);
    int nl = 1;
    while (nl < take + keep) nl <<= 1;
    for (int e = keep * L + tid; e < nl * L; e += kMergeThreads) {
      const int c = e / L - keep, p = e % L;
      unsigned long long key = 0;
      if (c < take && p < l) {
        const size_t at = (size_t)(first + c) * l + p;
        const float v = pv[at];
        nan |= isnan(v);
        key = v == -INFINITY ? 0ull : topl_key(v, pi[at]);
      }
      buf[src][e] = key;
    }
    __syncthreads();
    for (; nl > 1; nl >>= 1) {
      const unsigned long long* in = buf[src];
      unsigned long long* out = buf[src ^ 1];
      for (int e = tid; e < nl * L; e += kMergeThreads) {
        const int list = e / L, i = e % L;
        const unsigned long long key = in[e];
        const unsigned long long* other = in + (list ^ 1) * L;
        // keys of the other list before this one: larger, or equal and
        // from the left list (an exact tie of pads keeps list order)
        int cnt = 0;
        for (int step = L; step > 0; step >>= 1) {
          const int k = cnt + step;
          if (k <= L) {
            const unsigned long long o = other[k - 1];
            if (o > key || (o == key && (list & 1))) cnt = k;
          }
        }
        if (i + cnt < L) out[(list >> 1) * L + i + cnt] = key;
      }
      __syncthreads();
      src ^= 1;
    }
    if (src != 0) {  // the result goes to list 0 of buffer 0
      for (int p = tid; p < L; p += kMergeThreads) buf[0][p] = buf[1][p];
      src = 0;
      __syncthreads();
    }
    first += take;
  }
  nan = __syncthreads_or(nan);
  for (int p = tid; p < l; p += kMergeThreads) {
    const unsigned long long key = buf[0][p];
    pv[p] = nan ? __int_as_float(0x7fc00000)
                : key ? __uint_as_float(static_cast<uint32_t>(key >> 32))
                      : -INFINITY;
    pi[p] = nan || !key ? INT_MAX : static_cast<int>(~static_cast<uint32_t>(key));
  }
}

// The order of a float as an unsigned integer (-inf lowest; no NaN here).
__device__ __forceinline__ uint32_t float_order(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

// Finish, top-l, stage 2: one block per row, thread s holds slot s (blockDim
// >= l). The rule at the top of the file, per tile in order, in parallel:
// the tile's candidates c_0 > c_1 > ... (its merged list) go over the slots
// in the order of their values ascending, lowest slot first among equals,
// c_i over the i-th while c_i > its value. That is what inserting them one
// by one over the lowest slot that holds the running minimum gives: the
// candidates fall and the minima rise, so an inserted candidate is never
// the minimum another one would replace, and the first candidate that fails
// ends the tile. Each thread finds its slot's place by counting the slots
// before it (l compares of keys in shared memory, no dependent load); a
// tile's candidates are staged with the others, kFoldKeys at a time.
__global__ void __launch_bounds__(kTile)
stream_topl_fold_kernel(const float* __restrict__ pval,
                        const int* __restrict__ pidx, int nblocks, int bpt,
                        int l, float* __restrict__ val,
                        int* __restrict__ idx) {
  __shared__ unsigned long long cand[kFoldKeys];
  __shared__ unsigned long long okey[kTile];
  const int row = blockIdx.x, s = threadIdx.x;
  const int ntile = nblocks / bpt;
  const int chunk = kFoldKeys / l;

  float v = -INFINITY;
  int ix = 0;
  for (int t0 = 0; t0 < ntile; t0 += chunk) {
    const int nt = min(chunk, ntile - t0);
    for (int e = s; e < nt * l; e += blockDim.x) {
      const int tt = e / l, p = e % l;
      const size_t at = ((size_t)row * nblocks + (size_t)(t0 + tt) * bpt) * l + p;
      const float cv = pval[at];  // a skipped (NaN) tile is keyed 0
      cand[e] = (isnan(cv) || cv == -INFINITY) ? 0ull
                                               : topl_key(cv, pidx[at]);
    }
    for (int tt = 0; tt < nt; ++tt) {
      if (s < l) okey[s] = (static_cast<unsigned long long>(float_order(v)) << 32) | s;
      __syncthreads();
      if (s < l) {
        const unsigned long long mine = okey[s];
        int rank = 0;
        for (int o = 0; o < l; ++o) rank += okey[o] < mine;
        const unsigned long long key = cand[tt * l + rank];
        const float cv = __uint_as_float(static_cast<uint32_t>(key >> 32));
        if (key != 0 && cv > v) {
          v = cv;
          ix = static_cast<int>(~static_cast<uint32_t>(key));
        }
      }
      __syncthreads();
    }
  }
  if (s < l) {
    val[(size_t)row * l + s] = v;
    idx[(size_t)row * l + s] = ix;
  }
}

// The inverse of float_order.
__device__ __forceinline__ float order_float(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The wide route's sizes for B rows, nblocks sweep blocks, l > kTile slots
// and bpt blocks a tile.
struct WidePlan {
  int lo;             // candidates a tile offers: min(l, bpt kTile)
  int Lm;             // longest list the merge keeps: pow2 >= lo
  int nl;             // lists of the merge tree: pow2 >= bpt
  int Lf;             // the fold's slot array: pow2 >= l
  size_t merge_smem;  // bytes of a merge block's two buffers
  size_t fold_smem;   // bytes of a fold block's keys and atom indices
  bool merge_global;  // past kWideSmem: in the scratch
  bool fold_global;
  size_t merge_work;  // scratch bytes of the merge, then of the fold
  size_t fold_stride;
  size_t work;
};

inline WidePlan wide_plan(int B, int nblocks, int l, int bpt) {
  WidePlan p{};
  p.lo = l < bpt * kTile ? l : bpt * kTile;
  p.Lm = pow2_at_least(p.lo);
  p.nl = pow2_at_least(bpt);
  p.Lf = pow2_at_least(l);
  p.merge_smem = 2 * static_cast<size_t>(p.nl) * kTile * sizeof(uint64_t);
  p.fold_smem = static_cast<size_t>(p.Lf) * sizeof(uint64_t) +
                static_cast<size_t>(l) * sizeof(int);
  p.merge_global = bpt > 1 && p.merge_smem > kWideSmem;
  p.fold_global = p.fold_smem > kWideSmem;
  p.merge_work = p.merge_global
                     ? static_cast<size_t>(nblocks / bpt) * B * p.merge_smem
                     : 0;
  p.fold_stride = (p.fold_smem + 15) / 16 * 16;
  p.work = p.merge_work + (p.fold_global ? B * p.fold_stride : 0);
  return p;
}

// Finish, top-l past kTile slots, stage 1: one block per (tile, row) merges
// the tile's bpt block lists (each its whole block, kTile keys, sorted;
// padded with empty lists to nl) pairwise, as stream_topl_merge_kernel
// does, each level's lists twice as long up to Lm, and writes the first lo
// keys in place over the tile's region (NaN and INT_MAX over all lo where
// the tile holds a NaN). The two buffers lie in shared memory, or at
// `work` (this block's 2 nl kTile keys) where they do not fit.
__global__ void __launch_bounds__(kWideMergeThreads)
stream_topl_merge_wide_kernel(float* __restrict__ pval, int* __restrict__ pidx,
                              int nblocks, int bpt, int lo, int Lm, int nl0,
                              unsigned long long* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int t = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const int keys = nl0 * kTile;
  unsigned long long* b0 =
      work ? work + ((size_t)row * gridDim.x + t) * 2 * keys
           : reinterpret_cast<unsigned long long*>(wide_smem);
  unsigned long long* buf[2] = {b0, b0 + keys};
  const size_t at = ((size_t)row * nblocks + (size_t)t * bpt) * kTile;
  float* pv = pval + at;
  int* pi = pidx + at;

  bool nan = false;
  for (int e = tid; e < keys; e += kWideMergeThreads) {
    unsigned long long key = 0;
    if (e < bpt * kTile) {
      const float v = pv[e];
      nan |= isnan(v);
      key = v == -INFINITY ? 0ull : topl_key(v, pi[e]);
    }
    b0[e] = key;
  }
  __syncthreads();
  int src = 0, len = kTile;
  for (int nl = nl0; nl > 1; nl >>= 1) {
    const int out_len = min(2 * len, Lm);
    const unsigned long long* in = buf[src];
    unsigned long long* out = buf[src ^ 1];
    for (int e = tid; e < nl * len; e += kWideMergeThreads) {
      const int list = e / len, i = e % len;
      const unsigned long long key = in[e];
      const unsigned long long* other = in + (size_t)(list ^ 1) * len;
      // keys of the other list before this one, as in the merge above
      int cnt = 0;
      for (int step = len; step > 0; step >>= 1) {
        const int k = cnt + step;
        if (k <= len) {
          const unsigned long long o = other[k - 1];
          if (o > key || (o == key && (list & 1))) cnt = k;
        }
      }
      if (i + cnt < out_len) out[(size_t)(list >> 1) * out_len + i + cnt] = key;
    }
    __syncthreads();
    src ^= 1;
    len = out_len;
  }
  nan = __syncthreads_or(nan);
  const unsigned long long* res = buf[src];
  for (int p = tid; p < lo; p += kWideMergeThreads) {
    const unsigned long long key = res[p];
    pv[p] = nan ? __int_as_float(0x7fc00000)
                : key ? __uint_as_float(static_cast<uint32_t>(key >> 32))
                      : -INFINITY;
    pi[p] = nan || !key ? INT_MAX : static_cast<int>(~static_cast<uint32_t>(key));
  }
}

// Sorts the block's L keys at K ascending (L a power of two): the bitonic
// network from merge width k0 up; with k0 = L only its last merge, which
// sorts a sequence that falls and then rises.
__device__ void sort_slots(unsigned long long* K, int L, int k0) {
  for (int k = k0; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < L / 2; p += blockDim.x) {
        const int a = (p & ~(j - 1)) * 2 + (p & (j - 1)), b = a + j;
        const unsigned long long x = K[a], y = K[b];
        if ((x > y) == ((a & k) == 0)) {
          K[a] = y;
          K[b] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Finish, top-l past kTile slots, stage 2: one block per row. The slots are
// kept as keys (float_order(value) << 32 | slot) in ascending order, the
// rule's order (value ascending, lowest slot first among equals), padded
// to Lf with ~0, beside each slot's atom index. Per tile, by the argument
// of stream_topl_fold_kernel: candidate i (of the tile's lo, value
// descending) goes over the slot at place i while it is strictly larger
// (a NaN or -inf candidate never is); then the places written hold a
// falling run and the rest still rise, so the last merge of the bitonic
// network restores the order, or the whole network where two written
// candidates tie in value (their slots may then fall out of order). The
// keys lie in shared memory, or at `work` (`stride` bytes a row) where
// they do not fit.
__global__ void __launch_bounds__(kWideFoldThreads)
stream_topl_fold_wide_kernel(const float* __restrict__ pval,
                             const int* __restrict__ pidx, int nblocks,
                             int bpt, int lo, int l, int Lf,
                             unsigned char* __restrict__ work, size_t stride,
                             float* __restrict__ val, int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int row = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  unsigned char* base = work ? work + (size_t)row * stride : wide_smem;
  unsigned long long* K = reinterpret_cast<unsigned long long*>(base);
  int* sidx = reinterpret_cast<int*>(K + Lf);
  const unsigned long long empty =
      static_cast<unsigned long long>(float_order(-INFINITY)) << 32;
  for (int i = tid; i < Lf; i += nt) {
    K[i] = i < l ? empty | static_cast<uint32_t>(i) : ~0ull;
    if (i < l) sidx[i] = 0;
  }
  __syncthreads();
  const int ntile = nblocks / bpt;
  for (int t = 0; t < ntile; ++t) {
    const size_t at = ((size_t)row * nblocks + (size_t)t * bpt) * kTile;
    int took = 0, tie = 0;
    for (int i = tid; i < lo; i += nt) {
      const float c = pval[at + i];
      const unsigned long long key = K[i];
      if (c > order_float(static_cast<uint32_t>(key >> 32))) {
        const uint32_t s = static_cast<uint32_t>(key);
        K[i] = (static_cast<unsigned long long>(float_order(c)) << 32) | s;
        sidx[s] = pidx[at + i];
        took = 1;
        tie |= i + 1 < lo && pval[at + i + 1] == c;
      }
    }
    took = __syncthreads_or(took);
    tie = __syncthreads_or(tie);
    if (took) sort_slots(K, Lf, tie ? 2 : Lf);
  }
  for (int i = tid; i < l; i += nt) {
    const unsigned long long key = K[i];
    const uint32_t s = static_cast<uint32_t>(key);
    val[(size_t)row * l + s] = order_float(static_cast<uint32_t>(key >> 32));
    idx[(size_t)row * l + s] = sidx[s];
  }
}

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

// The CUDA-core top-1 sweep's launch under the plan the grid picks
// (simt::launch_by_grid: a few-row plan at B <= 8, else the Wide plan).
template <typename T, bool kMasked, bool kColR>
cudaError_t launch_top1_sweep(const float* r, long long ldr, long long ldp,
                              const void* A, long long lda, const float* M,
                              float* pval, int* pidx, int B, int n, int m,
                              cudaStream_t s) {
  const int ntiles = m / kTile;
  return simt::launch_by_grid<T, 1, kColR>(
      [](auto plan) {
        return stream_top1_simt_kernel<T, kMasked, kColR, decltype(plan)>;
      },
      A, lda, simt::Products{r, nullptr, 0, 0, nullptr, ldr, ldp}, B, n, m,
      ntiles, s, r, ldr, ldp, static_cast<const T*>(A), (size_t)lda, M, pval,
      pidx, B, n, m, ntiles);
}

// K6 (rows of r), K9 (rows of r, a mask), K10 (r (n, B): stored as columns;
// its B = 1 and an (n, B) view of a (B, n) matrix have ldp = 1, rows).
template <typename T>
cudaError_t launch_sweep(const float* r, long long ldr, long long ldp,
                         const void* A, long long lda, const float* M,
                         float* pval, int* pidx, int B, int n, int m,
                         cudaStream_t s) {
  if (M) {
    return launch_top1_sweep<T, true, false>(r, ldr, ldp, A, lda, M, pval,
                                             pidx, B, n, m, s);
  }
  return ldp != 1 ? launch_top1_sweep<T, false, true>(
                        r, ldr, ldp, A, lda, M, pval, pidx, B, n, m, s)
                  : launch_top1_sweep<T, false, false>(
                        r, ldr, ldp, A, lda, M, pval, pidx, B, n, m, s);
}

// K7's CUDA-core sweep (r a contiguous (B, n)) under the plan the grid
// picks, as the top-1 sweep's.
template <typename T>
cudaError_t launch_topl_sweep(const float* r, const void* A, long long lda,
                              float* pval, int* pidx, int B, int n, int m,
                              int l, cudaStream_t s) {
  const int ntiles = m / kTile;
  return simt::launch_by_grid<T, 1>(
      [](auto plan) { return stream_topl_simt_kernel<T, decltype(plan)>; },
      A, lda, simt::Products{r, nullptr, 0, 0, nullptr, n, 1}, B, n, m,
      ntiles, s, r, static_cast<const T*>(A), (size_t)lda, pval, pidx, B, n,
      m, ntiles, l);
}

// The wide finish (l > kTile) on stream s: the merge where a tile has more
// than one block, then the fold; `work` as cstpu_stream_topl_work sizes it.
cudaError_t launch_topl_finish_wide(float* pval, int* pidx, float* val,
                                    int* idx, int B, int nblocks, int l,
                                    int bpt, unsigned char* work,
                                    cudaStream_t s) {
  const WidePlan p = wide_plan(B, nblocks, l, bpt);
  if (p.work && work == nullptr) return cudaErrorInvalidValue;
  cudaError_t err;
  if (bpt > 1) {
    const int smem = p.merge_global ? 0 : static_cast<int>(p.merge_smem);
    err = cudaFuncSetAttribute(stream_topl_merge_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    stream_topl_merge_wide_kernel<<<dim3(nblocks / bpt, B),
                                    kWideMergeThreads, smem, s>>>(
        pval, pidx, nblocks, bpt, p.lo, p.Lm, p.nl,
        p.merge_global ? reinterpret_cast<unsigned long long*>(work) : nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int smem = p.fold_global ? 0 : static_cast<int>(p.fold_smem);
  err = cudaFuncSetAttribute(stream_topl_fold_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int half = p.Lf / 2;  // a pair of the sort a thread, 128 to 1024
  const int threads = half < kTile ? kTile
                      : half > kWideFoldThreads ? kWideFoldThreads : half;
  stream_topl_fold_wide_kernel<<<B, threads, smem, s>>>(
      pval, pidx, nblocks, bpt, p.lo, l, p.Lf,
      p.fold_global ? work + p.merge_work : nullptr, p.fold_stride, val, idx);
  return cudaGetLastError();
}

}  // namespace cstpu

// Top-1 select of one shard. Entry (b, p) of the f32 residuals lies at
// r[b * ldr + p * ldp]; A (n, m) in cdt (bf16 if cdt_bf16 else f32) has unit
// column stride and rows lda entries apart; M, when not null, is a
// contiguous (B, m) f32 mask added to the scores (the CUDA-core sweep takes
// it with ldp = 1 only, and returns cudaErrorInvalidValue otherwise). m is
// a multiple of kTile and bpt sweep blocks make one tile of the NaN rule.
// Scratch pval (B, m / kTile) f32 and pidx i32; writes val (B,) f32 and idx
// (B,) i32. With nan_visible a NaN score makes val NaN (K10's rule), else
// its tile is skipped (K6's and K9's). With use_mma the sweep is the
// tensor-core one, with rb (B, roundup(n, 8)) bf16 as its scratch for the
// rounded r; it takes bf16 only, A aligned to 16 bytes and lda a multiple
// of 8, and the call returns cudaErrorInvalidValue otherwise. Returns the
// first launch error.
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
    err = cdt_bf16 ? launch_sweep<__nv_bfloat16>(r, ldr, ldp, A, lda, M, pval,
                                                 pidx, B, n, m, s)
                   : launch_sweep<float>(r, ldr, ldp, A, lda, M, pval, pidx,
                                         B, n, m, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_stream_finish(pval, pidx, B, m / kTile, bpt,
                                              nan_visible, val, idx, s));
}

// Top-l sweep of one shard: r (B, n) f32 contiguous, A as above, 1 <= l <=
// kTile (a block's list: the wrapper asks for min(l, kTile) whatever the
// select's l), m a multiple of kTile. Writes the partials pval, pidx
// (B, m / kTile, l): per row and per kTile atoms the l best, value
// descending then index ascending, a block holding a NaN all (NaN, INT_MAX).
// With use_mma the sweep is the tensor-core one, with rb (B, roundup(n, 8))
// bf16 as its scratch for the rounded r; it takes bf16 only, A aligned to
// 16 bytes and lda a multiple of 8, and the call returns
// cudaErrorInvalidValue otherwise. Returns the first launch error.
extern "C" int cstpu_stream_topl(const float* r, const void* A, long long lda,
                                 int cdt_bf16, float* pval, int* pidx, int B,
                                 int n, int m, int l, int use_mma, void* rb,
                                 void* stream) {
  using namespace cstpu;
  if (!stream_tiling_ok(m, 1) || B < 1 || l < 1 || l > kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (!cdt_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(mma::launch_topl(
        r, n, 1, static_cast<__nv_bfloat16*>(rb), A, lda, pval, pidx, B, n,
        m, l, s));
  }
  return static_cast<int>(
      cdt_bf16 ? launch_topl_sweep<__nv_bfloat16>(r, A, lda, pval, pidx, B,
                                                  n, m, l, s)
               : launch_topl_sweep<float>(r, A, lda, pval, pidx, B, n, m, l,
                                          s));
}

// The scratch the top-l finish needs past kTile slots: out[0] bytes (0
// where its keys fit shared memory, and for l <= kTile).
extern "C" int cstpu_stream_topl_work(int B, int m, int l, int bpt,
                                      long long* out) {
  using namespace cstpu;
  if (!stream_tiling_ok(m, bpt) || B < 1 || l < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = l > kTile ? static_cast<long long>(wide_plan(B, m / kTile, l, bpt).work)
                     : 0;
  return 0;
}

// The top-l finish of either sweep: folds the partials pval, pidx (B, m /
// kTile, min(l, kTile)), bpt blocks to a tile of the NaN rule, into val
// (B, l) f32 and idx (B, l) i32, slots in the running set's own order,
// (-inf, 0) where never filled. The partials are scratch: the merge
// overwrites the head of every tile's region with the tile's own list.
// Past kTile slots `work` is the scratch of cstpu_stream_topl_work's size
// (null where that is 0). Returns the first launch error.
extern "C" int cstpu_stream_topl_finish(float* pval, int* pidx, float* val,
                                        int* idx, int B, int m, int l,
                                        int bpt, void* work, void* stream) {
  using namespace cstpu;
  if (!stream_tiling_ok(m, bpt) || B < 1 || l < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nblocks = m / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l > kTile) {
    return static_cast<int>(launch_topl_finish_wide(
        pval, pidx, val, idx, B, nblocks, l, bpt,
        static_cast<unsigned char*>(work), s));
  }
  if (bpt > 1) {  // one block per tile: its list is the tile's already
    stream_topl_merge_kernel<<<dim3(nblocks / bpt, B), kMergeThreads, 0, s>>>(
        pval, pidx, nblocks, bpt, l);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stream_topl_fold_kernel<<<B, (l + 31) / 32 * 32, 0, s>>>(pval, pidx, nblocks,
                                                          bpt, l, val, idx);
  return static_cast<int>(cudaGetLastError());
}
