// Batched subspace pursuit (SP), stage 2: one expand-refit-prune round per
// row.
//
// Replaces sp_round and the outer-loop latch of cstpu/ops/fused_twostage.py::
// _sp_kernel (:767-845, :860-870; the init round :848-855). The row's
// top-k of |round_cdt(r) . A| comes from select_topl.cu. A cluster of two
// blocks per row; a row that is done returns at once. Slots 0..k-1 hold the
// kept block (its inverse Gram Ginv11 in `Ginv`), slots k..2k-1 the
// acquired one.
//   acquire  the picks in order (value descending, index ascending, the TPU
//            kernel's cursor, :374-414): a pick that is already kept is
//            consumed but skipped; cols[k+j], Atb[k+j], idx[k+j]
//   blocks   G12 = C1 C2', G22 = C2 C2', W = Ginv11 G12, S = G22 - G12' W
//   pre-gate a new atom with S_jj <= rtol * G22_jj leaves (:795-799)
//   union    x2 solves S x2 = a2 - W'a1 by masked CG with the 8-eps lift,
//            until ||r_cg||^2 <= (8 eps)^2 ||r_cg0||^2 or k steps (:477-535;
//            the TPU kernel's exit is batch-wide, this one the row's own);
//            x1 = Ginv11 a1 - W x2
//   prune    the k largest |coef| occupied slots, lowest slot on ties
//   stable   the kept set is the pre-round one: the row keeps its state and
//            only drops its acquisitions (:836-843)
//   else     stable compaction of the kept slots to 0..cnt-1, the kept
//            block's Gram and its exact bordered inversion with the per-atom
//            pivot test d > rtol * ||a||^2 (:416-463), a rejected atom's
//            index and column cleared (:661-669), coef = Ginv11 a1, r
//   latch    res = ||r||^2; done |= res <= delta2 || prev <= res || stable;
//            prev = res (the init round only sets prev)
// The TPU kernel's speed routes are not taken: no Newton-Schulz inverse, no
// incremental upkeep, no one-hot permutation GEMMs or f32 index lanes (so
// no m < 2^24 cap); they decide as the exact rebuild does.
//
// What bounds it on an H100: latency. A row is about 2 k^2 n multiply-adds
// (the upper half of the 2k x 2k Gram: 2.1 M at k = 32, n = 1024) and k
// strided column gathers (a 32-byte sector an entry), around chains of k
// steps (the merge, the CG, the inversion); a block per row would fill 64
// of the 132 SMs at B = 64. Design:
//   cluster  two blocks per row (a thread-block cluster): each gathers,
//            multiplies, moves and sums over its half of n; the Gram's
//            and Atb's halves and the two shares of ||r||^2 are added in
//            rank order through distributed shared memory, so both blocks
//            hold the same bits and run the k-step chains alike; rank 0
//            alone writes the row's Ginv, coef, idx, Atb, done and prev
//   merge    common.cuh::merge_topl_row: warp sorts of 64-bit keys and a
//            tree of merges, three block barriers, not k block-wide argmax
//            passes
//   acquire  every thread gathers its entries p of all k picked columns
//            (k independent loads in flight, not one warp walking a column)
//            and sums a_j . b for each pick; a reduce-scatter across the
//            warp (31 exchanges) and one pass over the warps give Atb
//   Gram     the Gram of all 2k slot columns, once, as one register-tiled
//            true-f32 product on CUDA cores (no TF32: the round is a true
//            f32 solve): each thread owns a 4 x 4 block of the 64 x 64
//            result, and the (2k x n) panel streams through shared memory
//            in chunks of 32 entries, four stages of cp.async in flight.
//            Only the upper half is computed (136 of 256 threads). G12,
//            G22 and, after the compaction, the kept block's Gram (the src
//            x src sub-block: the kept columns are the same columns) are
//            read from it; a sum runs over p in order, so the matrix is
//            symmetric bit for bit
//   inverse  the bordered inversion in warp 0, a lane per row of the
//            inverse being built (held in registers), g and u of a round
//            passed through shared memory as broadcast float4s, __syncwarp
//            only: no block barrier inside its k rounds; the CG runs in warp 0
//            too, and the prune is one bitonic sort of the 2k keys there
//   rebuild  the inversion reads the Gram alone, so it comes first; then
//            one pass moves the kept columns (batches of 16 slots, every
//            load of a batch in flight before its stores: a move reads slot
//            src[d] >= d, never one a previous batch wrote) and sums the
//            residual from the values it moves
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace cstpu {

constexpr int kSpThreads = 256;
constexpr int kSpCluster = 2;           // blocks a row: each takes half of n
constexpr float kEps8 = 8.0f * 1.1920929e-07f;
constexpr int kSpSlots = 2 * kTopLMax;  // the Gram's side: 2k <= 64
constexpr int kSpChunk = 32;            // entries of n in a panel stage
constexpr int kSpPitch = kSpChunk + 4;  // floats of a panel row (one slot)
constexpr int kSpStage = kSpSlots * kSpPitch;
constexpr int kSpStages = 4;            // panel stages in flight
constexpr int kGramPitch = kSpSlots + 1;
constexpr int kSpTiles = 16 * 17 / 2;   // 4 x 4 blocks of the Gram's upper half
constexpr int kMoveSlots = 16;          // slots a compaction batch moves
constexpr int kMoveRows = 4;            // entries of n a thread moves a slot

static_assert(kSpTiles <= kSpThreads, "a thread owns one 4 x 4 block");

// Dynamic shared memory of sp_round: the panel stages, the Gram (kSpSlots
// x kGramPitch), Ginv11, S, W (k x (k+1) each: a row pitch of k + 1 puts
// the lanes of a column read on distinct banks), 11k floats of vectors and
// 7k ints.
__host__ __device__ constexpr size_t sp_smem_bytes(int k) {
  return (size_t)(kSpStages * kSpStage + kSpSlots * kGramPitch +
                  3 * k * (k + 1) + 11 * k) *
             sizeof(float) +
         (size_t)7 * k * sizeof(int);
}

// Wait until at most kSpStages - 1 committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kSpStages - 1) : "memory");
}

// Start copying entries p0 .. p0+kSpChunk-1 of the K2 slot columns (each n
// long in device memory) into a panel stage, entry (s, p) at
// pan[s * kSpPitch + p - p0]; entries past n are zeros. 16-byte pieces
// when n is a multiple of 4 (8 lanes a slot: 128 contiguous bytes both
// sides), else 4-byte ones.
__device__ __forceinline__ void stage_panel(float* pan,
                                            const float* __restrict__ colsb,
                                            int K2, int n, int p0) {
  if ((n & 3) == 0) {
    constexpr int pieces = kSpChunk / 4;
    for (int e = threadIdx.x; e < K2 * pieces; e += kSpThreads) {
      const int s = e / pieces, q = 4 * (e % pieces);
      float* dst = pan + s * kSpPitch + q;
      if (p0 + q < n) {
        cp_async16(dst, colsb + (size_t)s * n + p0 + q);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < K2 * kSpChunk; e += kSpThreads) {
      const int s = e / kSpChunk, q = e % kSpChunk;
      float* dst = pan + s * kSpPitch + q;
      if (p0 + q < n) {
        cp_async4(dst, colsb + (size_t)s * n + p0 + q);
      } else {
        *dst = 0.f;
      }
    }
  }
}

// gram[a * kGramPitch + c] = cols[a] . cols[c] over the entries of chunks
// ch0 .. ch1-1 of n, for the K2 slot columns of a row, every sum over p in
// order, so the matrix is symmetric bit for bit. Thread t < kSpTiles owns the 4 x 4 block of slots
// {ta + 16x} x {tc + 16y} for the t-th pair ta <= tc (row by row), and
// writes it and its transpose; per 4 entries of n it reads 8 float4s of
// the panel (lanes of consecutive tc on distinct banks) for 64 FMAs. Every
// thread calls it; it ends with a barrier.
__device__ __forceinline__ void slot_gram(float* panel, float* gram,
                                          const float* __restrict__ colsb,
                                          int K2, int n, int ch0, int ch1) {
  const int tid = threadIdx.x;
  int ta = 0, t = tid;
  while (ta < 16 && t >= 16 - ta) t -= 16 - ta++;
  const int tc = ta + t;
  const bool act = tid < kSpTiles && ta < K2 && tc < K2;
  float acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
  }
  const int nch = ch1 - ch0;
#pragma unroll
  for (int c = 0; c < kSpStages - 1; ++c) {
    if (c < nch) {
      stage_panel(panel + c * kSpStage, colsb, K2, n, (ch0 + c) * kSpChunk);
    }
    cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    const int ahead = ch + kSpStages - 1;
    if (ahead < nch) {
      stage_panel(panel + (ahead % kSpStages) * kSpStage, colsb, K2, n,
                  (ch0 + ahead) * kSpChunk);
    }
    cp_async_commit();     // empty groups past the last chunk
    cp_async_wait_stages();  // chunk ch has landed
    __syncthreads();
    if (act) {
      const float* pan = panel + (ch % kSpStages) * kSpStage;
#pragma unroll 2
      for (int p = 0; p < kSpChunk; p += 4) {
        float4 u[4], v[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          u[x] = *reinterpret_cast<const float4*>(pan + (ta + 16 * x) * kSpPitch + p);
          v[x] = *reinterpret_cast<const float4*>(pan + (tc + 16 * x) * kSpPitch + p);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            acc[x][y] = fmaf(u[x].x, v[y].x, acc[x][y]);
            acc[x][y] = fmaf(u[x].y, v[y].y, acc[x][y]);
            acc[x][y] = fmaf(u[x].z, v[y].z, acc[x][y]);
            acc[x][y] = fmaf(u[x].w, v[y].w, acc[x][y]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for chunk ch + kSpStages
  }
  if (act) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int a = ta + 16 * x, c = tc + 16 * y;
        if (a < K2 && c < K2) {
          gram[a * kGramPitch + c] = acc[x][y];
          gram[c * kGramPitch + a] = acc[x][y];
        }
      }
    }
  }
  __syncthreads();
}

// The stable compaction of a row's columns fused with its residual, on
// entries p_lo .. p_hi-1 of n: cols[d] = cols[src[d]] for d < cnt (a
// rejected slot's times 0), zeros
// for cnt <= d < K2 (src ascending, src[d] >= d), and r = b - sum_{d<cnt}
// cols[d] cf[d], each sum over d in order (the empty slots add nothing).
// A batch of kMoveSlots slots loads all its sources before it stores: a
// position is read in the batch of the slot that moves from it and written
// in the batch of its own slot, never an earlier one. Returns this
// thread's share of ||r||^2.
__device__ __forceinline__ float compact_residual(
    float* __restrict__ colsb, const int* src, const int* rej,
    const float* cf, int cnt, int K2, float* __restrict__ rb,
    const float* __restrict__ bb, int n, int p_lo, int p_hi) {
  float rr = 0.f;
  for (int p0 = p_lo; p0 < p_hi; p0 += kSpThreads * kMoveRows) {
    float acc[kMoveRows];
#pragma unroll
    for (int i = 0; i < kMoveRows; ++i) acc[i] = 0.f;
    for (int d0 = 0; d0 < K2; d0 += kMoveSlots) {
      float v[kMoveSlots][kMoveRows];
#pragma unroll
      for (int q = 0; q < kMoveSlots; ++q) {
        const int d = d0 + q;
        const int s = d < cnt ? src[d] : -1;
#pragma unroll
        for (int i = 0; i < kMoveRows; ++i) {
          const int p = p0 + threadIdx.x + i * kSpThreads;
          v[q][i] = (s >= 0 && p < p_hi) ? colsb[(size_t)s * n + p] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kMoveSlots; ++q) {
        const int d = d0 + q;
        if (d >= K2) continue;
        const bool kept = d < cnt;
        if (kept) {
#pragma unroll
          for (int i = 0; i < kMoveRows; ++i) acc[i] += v[q][i] * cf[d];
        }
        const bool clear = kept && rej[d];
        if (kept && src[d] == d && !clear) continue;
#pragma unroll
        for (int i = 0; i < kMoveRows; ++i) {
          const int p = p0 + threadIdx.x + i * kSpThreads;
          if (p < p_hi) colsb[(size_t)d * n + p] = clear ? v[q][i] * 0.f : v[q][i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMoveRows; ++i) {
      const int p = p0 + threadIdx.x + i * kSpThreads;
      if (p < p_hi) {
        const float rp = bb[p] - acc[i];
        rb[p] = rp;
        rr += rp * rp;
      }
    }
  }
  return rr;
}

template <typename T>
__global__ void __launch_bounds__(kSpThreads)
sp_round_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                int ntiles, const T* __restrict__ A,
                const float* __restrict__ Bs, float* __restrict__ cols,
                float* __restrict__ Ginv, float* __restrict__ coef,
                int* __restrict__ idx, float* __restrict__ Atb,
                float* __restrict__ r, float* __restrict__ done,
                float* __restrict__ prev, int n, int m, int k, float rtol,
                float delta2, int init) {
  extern __shared__ __align__(16) float smem[];
  constexpr int nw = kSpThreads / 32;
  __shared__ float red_v[nw];
  __shared__ float red_at[nw][32];
  __shared__ TopKey mkeys[kSpThreads];
  __shared__ int picks[kTopLMax];
  __shared__ float vals[kTopLMax];
  __shared__ float okf_s[kTopLMax];
  __shared__ int ic_s[kTopLMax];
  __shared__ float s_lift;
  __shared__ int s_stable, s_cnt;
  // this block's share of Atb's new entries and of ||r||^2, read by the
  // cluster
  __shared__ float atb_part[kTopLMax];
  __shared__ float rr_part;
  // the inversion's g and u of a round, read back as broadcast float4s
  __shared__ __align__(16) float inv_g[kTopLMax];
  __shared__ __align__(16) float inv_u[kTopLMax];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kSpCluster, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // both blocks read the latch before the first cluster barrier; rank 0
  // writes it after the second
  if (done[b] > 0.5f) return;
  // this block's share of n: chunks ch0 .. ch1-1 of the Gram's panel, the
  // entries p_lo .. p_hi-1
  const int nch = (n + kSpChunk - 1) / kSpChunk, half = (nch + 1) / 2;
  const int ch0 = rank ? half : 0, ch1 = rank ? nch : half;
  const int p_lo = min(n, ch0 * kSpChunk), p_hi = min(n, ch1 * kSpChunk);
  const int K2 = 2 * k, kk = k * k, kp = k + 1;  // kp: the blocks' pitch
  float* panel = smem;                           // kSpStages stages
  float* gram = panel;  // the row's Gram, over the panel once it is formed
  float* gpart = panel + kSpStages * kSpStage;   // this block's share of it
  float* Gi = gpart + kSpSlots * kGramPitch;
  float* S = Gi + k * kp;  // S, then the kept block's inverse
  float* W = S + k * kp;
  float* atb = W + k * kp;
  float* cf = atb + K2;
  float* uc = cf + K2;
  float* ata = uc + K2;
  float* alive = ata + k;
  float* a1 = alive + k;
  float* pv = a1 + k;
  float* x2 = pv + k;
  int* ix = reinterpret_cast<int*>(x2 + k);
  int* src = ix + K2;
  int* keep = src + K2;
  int* rej = keep + K2;

  const float* bb = Bs + (size_t)b * n;
  float* colsb = cols + (size_t)b * K2 * n;
  float* rb = r + (size_t)b * n;
  float* Gb = Ginv + (size_t)b * kk;
  int* idxb = idx + (size_t)b * K2;
  float* atbb = Atb + (size_t)b * K2;

  for (int e = tid; e < kk; e += blockDim.x) Gi[e / k * kp + e % k] = Gb[e];
  for (int e = tid; e < K2; e += blockDim.x) {
    ix[e] = idxb[e];
    atb[e] = atbb[e];
  }
  merge_topl_row(pval + (size_t)b * ntiles * k, pidx + (size_t)b * ntiles * k,
                 ntiles * k, k, picks, vals, mkeys);

  // --- acquire: the picks' gates, then every thread gathers its entries ---
  if (tid < k) {
    const int i = picks[tid];
    bool dup = false;
    for (int e = 0; e < k; ++e) dup |= ix[e] == i;
    const bool ok = vals[tid] > -INFINITY && !dup;
    okf_s[tid] = ok ? 1.f : 0.f;
    ic_s[tid] = min(i, m - 1);
    ix[k + tid] = ok ? i : m;
  }
  __syncthreads();
  float at[kTopLMax];
#pragma unroll
  for (int j = 0; j < kTopLMax; ++j) at[j] = 0.f;
  // two entries of n a pass: 2k independent loads in flight, the sums
  // still over p in order
  for (int p0 = p_lo + tid; p0 < p_hi; p0 += 2 * kSpThreads) {
    const int p1 = p0 + kSpThreads;
    const bool two = p1 < p_hi;
    const T* A0 = A + (size_t)p0 * m;
    const T* A1 = A + (size_t)(two ? p1 : p0) * m;
    float av0[kTopLMax], av1[kTopLMax];
#pragma unroll
    for (int j = 0; j < kTopLMax; ++j) {
      const int ic = j < k ? ic_s[j] : 0;
      av0[j] = j < k ? to_f32(A0[ic]) : 0.f;
      av1[j] = j < k ? to_f32(A1[ic]) : 0.f;
    }
    const float b0 = bb[p0], b1 = two ? bb[p1] : 0.f;
#pragma unroll
    for (int j = 0; j < kTopLMax; ++j) {
      if (j < k) {
        colsb[(size_t)(k + j) * n + p0] = av0[j] * okf_s[j];
        at[j] += av0[j] * b0;
        if (two) {
          colsb[(size_t)(k + j) * n + p1] = av1[j] * okf_s[j];
          at[j] += av1[j] * b1;
        }
      }
    }
  }
  // the warp's sum of each pick, pick j on lane j: a reduce-scatter (after
  // the exchange at o, slot q holds pick q + the lane's bits >= o)
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int o = 16 >> step;
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      if (q < o) {
        const float send = up ? at[q] : at[q + o];
        const float mine = up ? at[q + o] : at[q];
        at[q] = mine + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
  }
  red_at[warp][lane] = at[0];
  __syncthreads();  // also: the gathered columns are visible to the block
  if (tid < k) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red_at[w][tid];
    atb_part[tid] = s;
  }

  // --- the Gram of the 2k slot columns, each block over its share of n,
  // the two shares added in rank order through distributed shared memory
  // (so both blocks hold the same bits); Atb's new entries likewise. G12
  // and G22 are blocks of the Gram ------------------------------------------
  slot_gram(panel, gpart, colsb, K2, n, ch0, ch1);
  cluster.sync();
  {
    const float* g0 = cluster.map_shared_rank(gpart, 0);
    const float* g1 = cluster.map_shared_rank(gpart, 1);
    for (int e = tid; e < K2 * kGramPitch; e += kSpThreads) {
      if (e % kGramPitch < K2) gram[e] = g0[e] + g1[e];
    }
    if (tid < k) {
      atb[k + tid] = (*cluster.map_shared_rank(&atb_part[tid], 0) +
                      *cluster.map_shared_rank(&atb_part[tid], 1)) *
                     okf_s[tid];
    }
  }
  __syncthreads();
  // W = Ginv11 G12, then S = G22 - G12' W: four entries a thread at once
  // (independent chains), each sum over t in order
  for (int e0 = tid; e0 < kk; e0 += 4 * kSpThreads) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int ra[4], rc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = min(e0 + i * kSpThreads, kk - 1);
      ra[i] = e / k * kp;
      rc[i] = k + e % k;
    }
    for (int t = 0; t < k; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += Gi[ra[i] + t] * gram[t * kGramPitch + rc[i]];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + i * kSpThreads, a = e / k, c = e % k;
      if (e < kk) {
        W[a * kp + c] = acc[i];
        if (a == c) ata[a] = gram[(k + a) * kGramPitch + k + a];
      }
    }
  }
  __syncthreads();
  for (int e0 = tid; e0 < kk; e0 += 4 * kSpThreads) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int ra[4], rc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = min(e0 + i * kSpThreads, kk - 1);
      ra[i] = k + e / k;
      rc[i] = e % k;
    }
    for (int t = 0; t < k; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += gram[t * kGramPitch + ra[i]] * W[t * kp + rc[i]];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + i * kSpThreads, a = e / k, c = e % k;
      if (e < kk) S[a * kp + c] = gram[(k + a) * kGramPitch + k + c] - acc[i];
    }
  }
  __syncthreads();

  // --- pre-gate on the Schur pivot of each new atom ------------------------
  for (int c = tid; c < k; c += blockDim.x) {
    const bool occ = ix[k + c] < m;
    const bool al = occ && S[c * kp + c] > rtol * ata[c];
    alive[c] = al ? 1.f : 0.f;
    if (occ && !al) ix[k + c] = m;
  }
  for (int a = tid; a < k; a += blockDim.x) a1[a] = (ix[a] < m ? 1.f : 0.f) * atb[a];
  if (tid == 0) {
    float mx = -INFINITY;
    for (int c = 0; c < k; ++c) mx = max_keep_nan(mx, S[c * kp + c]);
    s_lift = kEps8 * mx;
  }
  __syncthreads();

  // --- union coefficients: masked CG on S in warp 0, a lane per slot -------
  if (warp == 0) {
    const int c = lane;
    const bool in = c < k;
    float v = 0.f;
    if (in) {
      float wt = 0.f;
      for (int a = 0; a < k; ++a) wt += W[a * kp + c] * a1[a];
      const float a2 = (ix[k + c] < m ? 1.f : 0.f) * atb[k + c];
      v = alive[c] * (a2 - wt);
    }
    const float lift = s_lift;
    float x = 0.f, rv = v, p = v;
    float rs = warp_allsum(v * v);
    const float thr = (kEps8 * kEps8) * rs;
    for (int j = 0; j < k && rs - thr > 0.f; ++j) {
      if (in) pv[c] = p;
      __syncwarp();
      float sp = 0.f;
      if (in) {
        float q[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, then their sum
        int e = 0;
        for (; e + 4 <= k; e += 4) {
#pragma unroll
          for (int i = 0; i < 4; ++i) q[i] += S[c * kp + e + i] * pv[e + i];
        }
        for (; e < k; ++e) q[0] += S[c * kp + e] * pv[e];
        sp = alive[c] * ((q[0] + q[1]) + (q[2] + q[3]) + lift * p);
      }
      const float al = rs / max_keep_nan(warp_allsum(p * sp), 1e-30f);
      x = x + al * p;
      rv = rv - al * sp;
      const float rsn = warp_allsum(rv * rv);
      const float beta = rsn / max_keep_nan(rs, 1e-30f);
      p = rv + beta * p;
      rs = rsn;
      __syncwarp();
    }
    if (in) x2[c] = alive[c] * x;
  }
  __syncthreads();
  for (int a = tid; a < k; a += blockDim.x) {
    float gi = 0.f, wx = 0.f;
    for (int c = 0; c < k; ++c) {
      gi += Gi[a * kp + c] * a1[c];
      wx += W[a * kp + c] * x2[c];
    }
    uc[a] = gi - wx;
    uc[k + a] = x2[a];
  }
  __syncthreads();

  // --- prune: the k largest |coef| of the occupied slots, lowest slot on
  // ties, by one bitonic sort of the 2k keys in warp 0 (slot e = lane +
  // 32 r in x[r]); a NaN among them keeps nothing (the k argmax passes of
  // the TPU kernel stop at a NaN maximum) ------------------------------------
  if (warp == 0) {
    TopKey x[2];
    bool nan = false;
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int e = lane + 32 * r2;
      const float c = (e < K2 && ix[e] < m) ? fabsf(uc[e]) : -INFINITY;
      nan |= isnan(c);
      x[r2] = merge_key(isnan(c) ? -INFINITY : c, e);
      if (e < K2) keep[e] = 0;
    }
    nan = __any_sync(0xffffffffu, nan);
#pragma unroll
    for (int kb = 2; kb <= 64; kb <<= 1) {
#pragma unroll
      for (int j = kb >> 1; j > 0; j >>= 1) {
        if (j == 32) {  // kb = 64: entries e and e + 32 of one lane
          const TopKey hi = x[0] > x[1] ? x[0] : x[1];
          x[1] = x[0] > x[1] ? x[1] : x[0];
          x[0] = hi;
        } else {
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            x[r2] = bitonic_step(x[r2], j, ((lane + 32 * r2) & kb) == 0);
          }
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      float v;
      int e;
      merge_unkey(x[r2], v, e);
      if (!nan && lane + 32 * r2 < k && v > -INFINITY) keep[e] = 1;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int st = 1, cnt = 0;
    for (int e = 0; e < K2; ++e) {
      st &= keep[e] == (e < k ? (int)(ix[e] < m) : 0);
      if (keep[e]) src[cnt++] = e;
    }
    s_stable = st;
    s_cnt = cnt;
  }
  __syncthreads();
  const bool stable = s_stable;

  float share = 0.f;
  if (stable) {
    for (int e = k + tid; e < K2; e += blockDim.x) ix[e] = m;
    for (int p = p_lo + tid; p < p_hi; p += blockDim.x) share += rb[p] * rb[p];
    __syncthreads();
  } else {
    // --- the kept block's Gram is gram[src][src] (cnt <= k kept slots,
    // compacted to 0..cnt-1); its bordered inversion in warp 0, lane a
    // holding row a of the inverse being built (the identity outside the
    // atoms taken in so far). It reads the Gram alone, so the columns move
    // later, in one pass with the residual. Warp 1 compacts idx and Atb.
    const int cnt = s_cnt;
    if (warp == 0) {
      const int a = lane;
      const int sa = a < cnt ? src[a] : -1;
      float w[kTopLMax];
#pragma unroll
      for (int c = 0; c < kTopLMax; ++c) w[c] = c == a ? 1.f : 0.f;
      const float gaa = sa >= 0 ? gram[sa * kGramPitch + sa] : 0.f;
      const float flo = a < cnt ? rtol * gaa : INFINITY;
      float inm = 0.f;
      int rej_a = 0;
      for (int j = 0; j < k; ++j) {
        const int sj = j < cnt ? src[j] : -1;
        const float gk = (sa >= 0 && sj >= 0) ? gram[sa * kGramPitch + sj] : 0.f;
        const float g = gk * inm;
        inv_g[a] = g;
        __syncwarp();
        float u4[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, then their sum
#pragma unroll
        for (int c = 0; c < kTopLMax; c += 4) {
          const float4 gv = *reinterpret_cast<const float4*>(inv_g + c);
          u4[0] += w[c] * gv.x;
          u4[1] += w[c + 1] * gv.y;
          u4[2] += w[c + 2] * gv.z;
          u4[3] += w[c + 3] * gv.w;
        }
        const float u = (u4[0] + u4[1]) + (u4[2] + u4[3]);
        const float gu = warp_allsum(g * u);
        const float d = __shfl_sync(0xffffffffu, gk, j) - gu;  // Gk_jj - g.u
        const bool ok = d > __shfl_sync(0xffffffffu, flo, j);
        const float okf = ok ? 1.f : 0.f;
        const float dinv = okf / (d > 0.f ? d : 1.f);
        if (a == j) rej_a = !ok;
        const float wa = u - (a == j ? okf : 0.f);
        inv_u[a] = u;
        __syncwarp();
#pragma unroll
        for (int c = 0; c < kTopLMax; c += 4) {
          const float4 uv = *reinterpret_cast<const float4*>(inv_u + c);
          const float uc4[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wc = uc4[i] - (c + i == j ? okf : 0.f);
            w[c + i] = w[c + i] + dinv * wa * wc - ((a == j && c + i == j) ? okf : 0.f);
          }
        }
        if (a == j) inm += okf;
      }
      if (a < k) {
        rej[a] = rej_a;
#pragma unroll
        for (int c = 0; c < kTopLMax; ++c) {
          if (c < k) S[a * kp + c] = w[c];
        }
      }
    } else if (tid == 32) {
      for (int d = 0; d < K2; ++d) {
        ix[d] = d < cnt ? ix[src[d]] : m;
        atb[d] = d < cnt ? atb[src[d]] : 0.f;
      }
    }
    __syncthreads();

    // --- rejected kept atoms leave (index; the column in the pass below);
    // coef = Ginv11 a1 (a rejected slot's row of the inverse is e_j and its
    // a1 entry 0: its coefficient is 0) -------------------------------------
    for (int j = tid; j < k; j += blockDim.x) {
      if (rej[j] && ix[j] < m) ix[j] = m;
    }
    for (int e = tid; e < k * kp; e += blockDim.x) Gi[e] = S[e];
    __syncthreads();
    for (int a = tid; a < k; a += blockDim.x) a1[a] = (ix[a] < m ? 1.f : 0.f) * atb[a];
    __syncthreads();
    for (int a = tid; a < k; a += blockDim.x) {
      float acc = 0.f;
      for (int c = 0; c < k; ++c) acc += Gi[a * kp + c] * a1[c];
      cf[a] = acc;
      cf[k + a] = 0.f;
    }
    __syncthreads();
    share = compact_residual(colsb, src, rej, cf, cnt, K2, rb, bb, n, p_lo,
                             p_hi);
    if (rank == 0) {
      for (int e = tid; e < kk; e += blockDim.x) Gb[e] = Gi[e / k * kp + e % k];
      for (int e = tid; e < K2; e += blockDim.x) coef[(size_t)b * K2 + e] = cf[e];
    }
  }
  if (rank == 0) {
    for (int e = tid; e < K2; e += blockDim.x) {
      idxb[e] = ix[e];
      atbb[e] = atb[e];
    }
  }
  // ||r||^2: the two shares added in rank order; the split barrier keeps
  // each block alive until the other has read its share
  const float mine = block_sum(share, red_v);
  if (tid == 0) rr_part = mine;
  cluster.sync();
  if (tid == 0) {
    const float rr = *cluster.map_shared_rank(&rr_part, 0) +
                     *cluster.map_shared_rank(&rr_part, 1);
    if (rank == 0) {
      if (!init && (rr <= delta2 || prev[b] <= rr || stable)) done[b] = 1.f;
      prev[b] = rr;
    }
  }
  cluster_arrive_release();
  cluster_wait_acquire();
}

template <typename T>
int launch_sp_round(const float* pval, const int* pidx, int ntiles,
                    const void* A, const float* Bs, float* cols, float* Ginv,
                    float* coef, int* idx, float* Atb, float* r, float* done,
                    float* prev, int B, int n, int m, int k, float rtol,
                    float delta2, int init, cudaStream_t st) {
  const size_t smem = sp_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      sp_round_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kSpCluster);
  cfg.blockDim = dim3(kSpThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSpCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sp_round_kernel<T>, pval, pidx, ntiles,
                           static_cast<const T*>(A), Bs, cols, Ginv, coef,
                           idx, Atb, r, done, prev, n, m, k, rtol, delta2,
                           init);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace cstpu

// One SP round for all B rows. pval/pidx (B, ntiles, k) from
// cstpu_select_topl; A (n, m) in cdt; Bs (B, n) f32; state cols (B,2k,n),
// Ginv (B,k,k), coef, Atb (B,2k) f32, idx (B,2k) i32, r (B,n) f32, done,
// prev (B,) f32 updated in place; init = 1 for the first round (sets prev,
// latches nothing). All contiguous, 1 <= k <= kTopLMax. Returns the
// launch's cudaError_t.
extern "C" int cstpu_sp_round(const float* pval, const int* pidx, int ntiles,
                              const void* A, int cdt_bf16, const float* Bs,
                              float* cols, float* Ginv, float* coef, int* idx,
                              float* Atb, float* r, float* done, float* prev,
                              int B, int n, int m, int k, float rtol,
                              float delta2, int init, void* stream) {
  using namespace cstpu;
  if (k < 1 || k > kTopLMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    return launch_sp_round<__nv_bfloat16>(pval, pidx, ntiles, A, Bs, cols,
                                          Ginv, coef, idx, Atb, r, done, prev,
                                          B, n, m, k, rtol, delta2, init, st);
  }
  return launch_sp_round<float>(pval, pidx, ntiles, A, Bs, cols, Ginv, coef,
                                idx, Atb, r, done, prev, B, n, m, k, rtol,
                                delta2, init, st);
}
