// GOMP's iteration (gomp_append.cu) and OMPR's replacement (ompr_swap.cu) as
// a thread-block cluster per row over staged slot columns.
//
// The math is that of cstpu's bordered append (cstpu/ops/fused_solve.py::
// _gomp_kernel :757-784, GOMP's cnt appends, one after the other; plain
// twin cstpu_torch/ops/fused_solve.py::_bordered_append_ref) and of
// cstpu/ops/fused_twostage.py::_Engine's append, delete_ep and
// refit_residual (:138-223, OMPR's swap); what differs is where it runs
// and the order of its sums. The cluster, the staging and the launch are
// append_cluster.cuh's, the exchange, the matrix-vector product and the
// live slots engine_cluster.cuh's.
//
// What bounds these launches on an H100: latency. One row's work is a few
// hundred KB (its slot columns, cnt or one dictionary columns gathered at a
// 32-byte sector an entry, strided by m) and O(k n) flops; one block per row
// left half the card idle at B = 64, and GOMP ran its cnt dependent appends
// each with its own gather and k + 2 products of length n, OMPR read its
// slot columns from device memory three times a launch. Design:
//   cluster  C blocks per row (gomp_plan, ompr_plan: C from the shapes
//            alone, cluster_size's rule); block `rank` owns entries p0 ..
//            p0+L-1 of n;
//   stage    the row's select partials are loaded first (the picks head the
//            critical path), then cp.async copies of Ginv (pitch
//            ginv_pitch), coef, idx, the block's slice of b (OMPR: Atb and
//            r) and one bulk copy (the copy engine's) per slot column slice
//            on an mbarrier: GOMP's old slots, once the slot count is in,
//            landing while the picks are merged; all K of OMPR's at once.
//            The block then gathers its slices of the picked columns, all
//            loads in flight together. Where the columns do not fit beside
//            the state, the streamed instantiation reads them (and b) from
//            device memory, and GOMP gathers its picks a chunk of W entries
//            at a time;
//   exchange one a launch (GOMP: one a round of R picks where a launch's
//            partials do not fit): GOMP's cross terms cols[q] . a_j of the
//            old slots, the picks' Gram (its diagonal the ata) and the betas;
//            OMPR's g = cols[q] . acol and gr = cols[q] . r over the occupied
//            slots, acol . r, ata and beta. Products of 4 operands by 4
//            (OMPR 2), a warp a tile, lanes along the slice, reduced across
//            the warp by halving; every block adds the C partials in rank
//            order, so every block holds the same bits and runs the K-sized
//            work alike: warp 0 forms each append (lane l owning slots l, l +
//            32, ...: its rows of u = Ginv g, the gate as a warp reduction;
//            OMPR's gradient step and min-|gcoef| deletion, lowest slot on
//            ties, NaN kept visible, and the deleted slot's column of Ginv),
//            then every warp applies it to its rows of Ginv (OMPR: the
//            append and the Schur downdate in one pass) and the refit;
//   write    every block writes its slice of the new columns, of the cleared
//            column (OMPR) and of r = b - cols' coef, summed over the live
//            slots in slot order (GOMP: slots < kcnt; OMPR: idx < m after the
//            deletion). A free slot's column is zero and its coefficient
//            finite on a finite state, so the sums equal the all-slot ones
//            term for term; a NaN row has NaN in every coefficient, and an
//            empty live set adds 0 coef[0], so both give NaN. Every block
//            writes a share of Ginv's rows and sends its share of ||r||^2 to
//            rank 0 on the second mbarrier; rank 0 writes the row's K-sized
//            state and flags.
// No block reads another's shared memory; a block writes into another's
// only after that block has arrived on the cluster barrier that its sends
// wait on, so a block may leave before the rest. Every block reads the
// row's state before it sends and writes it only after it has received,
// which is after every other block has sent.
#pragma once

#include "engine_cluster.cuh"

namespace cstpu {

// ------------------------------------------------------ tiles of products --

// The N values of every lane summed over the warp, N a power of two up to
// 16: at each of log2(N) halvings (H values kept, partner at lane ^ O) a
// lane keeps half its values and adds its partner's copies of them, then
// the last 5 - log2(N) levels add the one left. Lane l ends with the sum of
// value (l >> (5 - log2 N)) & (N - 1), in a fixed order (N - 1 + 5 -
// log2 N shuffles, not 5 N).
template <int N, int H = N / 2, int O = 16>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[N]) {
  if constexpr (H >= 1) {
    const bool upper = (threadIdx.x & O) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = upper ? v[j] : v[j + H];
      const float keep = upper ? v[j + H] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return warp_reduce_scatter<N, H / 2, O / 2>(v);
  } else {
    float x = v[0];
#pragma unroll
    for (int o = O; o >= 1; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  }
}

// out[r nc + c] = (add ? out[r nc + c] : 0) + sum_{i < len} X_r[i] Y_c[i]
// for rows r < nr and columns c < nc. Tiles of 4 rows by kTc columns (4 or
// 2), a warp a tile, its lanes along i (consecutive entries: no bank
// conflict at any pitch, coalesced from device memory). With kShared,
// xrow(r) and ycol(c) are offsets into the dynamic shared memory (so that
// the loads are shared-memory loads), else pointers; a tile past the last
// row or column repeats it and drops the result. Sums in a fixed order, so
// every block of a cluster adds its own entries alike. No barrier.
template <int kTc, bool kShared, typename XRow, typename YCol>
__device__ __forceinline__ void warp_tile_products(XRow xrow, YCol ycol,
                                                   int nr, int nc, int len,
                                                   float* out, bool add) {
  constexpr int nw = kAppendThreads / 32;
  constexpr int kN = 4 * kTc;
  constexpr int kShift = kTc == 4 ? 1 : 2;  // 5 - log2(kN)
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rt = (nr + 3) >> 2, ct = (nc + kTc - 1) / kTc;
  for (int t = warp; t < rt * ct; t += nw) {
    const int I = t / ct, J = t - I * ct;
    decltype(xrow(0)) xp[4];
    decltype(ycol(0)) yp[kTc];
#pragma unroll
    for (int q = 0; q < 4; ++q) xp[q] = xrow(min(4 * I + q, nr - 1));
#pragma unroll
    for (int q = 0; q < kTc; ++q) yp[q] = ycol(min(kTc * J + q, nc - 1));
    float acc[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[e] = 0.f;
    for (int i = lane; i < len; i += 32) {
      float x[4], y[kTc];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kShared) x[q] = smem[xp[q] + i];
        else x[q] = xp[q][i];
      }
#pragma unroll
      for (int q = 0; q < kTc; ++q) {
        if constexpr (kShared) y[q] = smem[yp[q] + i];
        else y[q] = yp[q][i];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < kTc; ++c) acc[a * kTc + c] += x[a] * y[c];
      }
    }
    const float s = warp_reduce_scatter<kN>(acc);
    const int e = (lane >> kShift) & (kN - 1);
    const int r_ = 4 * I + e / kTc, c_ = kTc * J + e % kTc;
    if ((lane & ((1 << kShift) - 1)) == 0 && r_ < nr && c_ < nc) {
      float* o = out + r_ * nc + c_;
      *o = add ? *o + s : s;
    }
  }
}

// The C blocks' partials (block r's at part[r pp + e]), added in rank
// order into sum[e] for e < count. No barrier.
__device__ __forceinline__ void cluster_sum(const float* part, int pp, int C,
                                            int count, float* sum) {
  for (int e = threadIdx.x; e < count; e += kAppendThreads) {
    float s = part[e];
    for (int r_ = 1; r_ < C; ++r_) s += part[r_ * pp + e];
    sum[e] = s;
  }
}

// This block's share of ||r||^2 to rank 0, which adds the C shares in rank
// order (rrs: one float a block, in rank 0's shared memory; rfull the
// second mbarrier of cluster_setup). Rank 0's thread 0 gets the sum; every
// other block's threads return 0 and may leave. Every thread calls it.
__device__ __forceinline__ float cluster_rnorm2(float rr, float* red_v,
                                                float* rrs, uint64_t* rfull,
                                                int C, int rank) {
  rr = block_sum(rr, red_v);
  if (rank != 0) {
    if (threadIdx.x == 0) {
      cg::cluster_group cluster = cg::this_cluster();
      *cluster.map_shared_rank(&rrs[rank], 0) = rr;
      mbar_arrive_remote(smem_u32(rfull), 0);
    }
    return 0.f;
  }
  if (threadIdx.x == 0 && C > 1) {
    mbar_wait_cluster(smem_u32(rfull), 0);
    for (int r_ = 1; r_ < C; ++r_) rr += rrs[r_];
  }
  return rr;
}

// Ginv (K x K, pitch GP in shared memory) to device memory (pitch K), each
// block of the cluster a share of its rows. No barrier.
__device__ __forceinline__ void store_ginv_share(const float* Gs, int GP,
                                                 float* Gb, int K, int C,
                                                 int rank) {
  const int rows = (K + C - 1) / C;
  const int r1 = min(K, (rank + 1) * rows);
  for (int r_ = min(K, rank * rows) + (threadIdx.x >> 5); r_ < r1;
       r_ += kAppendThreads / 32) {
    for (int c = threadIdx.x & 31; c < K; c += 32) Gb[r_ * K + c] = Gs[r_ * GP + c];
  }
}

// The row pitch of Ginv in shared memory: odd, so that lane r reading row r
// at one column meets no other lane's bank.
__host__ __device__ constexpr int ginv_pitch(int K) { return K | 1; }

// Slots a lane owns in the K-sized work that every warp runs alike: lane,
// lane + 32, ..., up to kAppendThreads / 2 = 128 >= KMAX.
constexpr int kLaneSlots = 4;

// x[t] of a lane's kLaneSlots registers, t uniform across the warp (a
// select chain: a dynamic index would put the array in local memory).
__device__ __forceinline__ float lane_slot(const float (&x)[kLaneSlots], int t) {
  return t == 0 ? x[0] : t == 1 ? x[1] : t == 2 ? x[2] : x[3];
}

// Entry (r, c) of Ginv after the gated bordered append: G + dinv wa wc,
// less okf on the slot's diagonal. One expression wherever the entry is
// formed, so that the deletion's column of it and the update agree.
__device__ __forceinline__ float appended(float G, float dinv, float wa,
                                          float wc, float okf, bool diag) {
  return fmaf(dinv * wa, wc, G) - (diag ? okf : 0.f);
}

// Start a bulk copy (the copy engine's, one instruction) of `bytes`, a
// multiple of 16, from device memory at src to this block's shared memory
// at dst, both 16-byte aligned; it completes on the mbarrier `bar`, whose
// transaction count it pays.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Stage `rows` slices of len floats (src rows spitch apart, dst rows
// dpitch apart) on the mbarrier `bar` (set up for one arrival): one bulk
// copy a row, issued by the lanes of warp 0 once lane 0 has arrived
// expecting their bytes, where every piece is 16-byte whole (`vec`: len,
// both pitches and both bases multiples of 4 floats); else append_stage's
// cp.async copies in the open group, and thread 0 arrives expecting none.
// A wait on `bar` then covers the rows. Every thread calls it.
__device__ __forceinline__ void stage_slices_bulk(float* dst, int dpitch,
                                                  const float* src,
                                                  size_t spitch, int rows,
                                                  int len, bool vec,
                                                  uint64_t* bar) {
  if (vec && len > 0) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(smem_u32(bar), static_cast<uint32_t>(rows * len) * 4u);
      }
      __syncwarp();
      for (int q = threadIdx.x; q < rows; q += 32) {
        bulk_load(dst + q * dpitch, src + q * spitch, len * 4u, bar);
      }
    }
  } else {
    append_stage(dst, dpitch, src, spitch, rows, len, vec);
    if (threadIdx.x == 0) mbar_arrive(smem_u32(bar));
  }
}

// ----------------------------------------------------------- gomp_append ----

// Most entries of a pick's slice a streamed launch gathers at once.
constexpr int kGompChunk = 1024;

// A round's partials of one block: the old slots (up to k), the picks up to
// the round's last and b, by the round's R picks.
__host__ __device__ constexpr size_t gomp_parts(int k, int cnt, int R) {
  return pad4((size_t)(k + cnt + 1) * R);
}

// gomp_append's dynamic shared memory: (staged) the slices of the k slot
// columns (pitch S) and of b; the picks' slices (or chunks) of W entries;
// Ginv (k rows of ginv_pitch(k)); the C blocks' partials and their sums;
// g, w, coef (k each), an append's scalars (4); idx and the partials' row
// of each slot (k each).
__host__ __device__ constexpr size_t gomp_cluster_smem(int S, int W, int k,
                                                       int cnt, int R, int C,
                                                       bool staged) {
  return ((staged ? (size_t)(k + 1) * S : 0) + (size_t)cnt * W +
          pad4((size_t)k * ginv_pitch(k)) +
          (size_t)(C + 1) * gomp_parts(k, cnt, R) + 5 * (size_t)k + 4) *
         sizeof(float);
}

struct GompPlan {
  AppendPlan p;  // C, slice, staged, dynamic shared memory
  int R;         // picks a round (cnt: one exchange a launch)
  int W;         // entries of a pick gathered at once (the slice: all)
};

// The plan for B rows, n, k slots and cnt picks: cluster_size with the
// least a block needs (streamed, one pick a round); staged where the staged
// variant fits with one round; else streamed, W = min(slice, kGompChunk)
// and R the most picks whose partials fit. `ok` is false when nothing fits.
inline GompPlan gomp_plan(int B, int n, int k, int cnt, bool* ok) {
  const auto bytes = [k, cnt](int S, int R, int C, bool staged) {
    const int W = staged ? S : (S < kGompChunk ? S : kGompChunk);
    return gomp_cluster_smem(S, W, k, cnt, R, C, staged) + kInitStaticSmem;
  };
  const int C = cluster_size(B, n, [&](int c) {
    return bytes(cluster_slice(n, c), 1, c, false) <= kAppendSmemBudget;
  });
  const int S = cluster_slice(n, C);
  *ok = bytes(S, 1, C, false) <= kAppendSmemBudget;
  const bool staged = bytes(S, cnt, C, true) <= kAppendSmemBudget;
  int R = cnt;
  while (!staged && R > 1 && bytes(S, R, C, false) > kAppendSmemBudget) --R;
  const int W = staged ? S : (S < kGompChunk ? S : kGompChunk);
  return GompPlan{AppendPlan{C, S, staged ? 1 : 0,
                             bytes(S, R, C, staged) - kInitStaticSmem},
                  R, W};
}

// What one gomp_append launch reads and writes; the pointers are the whole
// batch's.
struct GompArgs {
  const float* pval;
  const int* pidx;
  const void* A;
  const float* Bs;
  float* cols;
  float* Ginv;
  float* coef;
  int* idx;
  float* r;
  int* kcnt;
  float* done;
  float rtol, eps2;
  int ntiles, cnt, n, m, k, cap, slice, R, W;
};

// One GOMP iteration of one row (cnt picks into the slots from kcnt on, in
// insertion order; slots < kcnt occupied, the rest zero), run by every
// thread of every block of the row's cluster (gomp_append.cu).
template <typename T, bool kStaged>
__device__ __forceinline__ void gomp_cluster_row(const GompArgs& a) {
  constexpr int nw = kAppendThreads / 32;
  constexpr int kG = 8;   // gather loads a thread in flight
  constexpr int kE = 2;   // entries a thread writes at once
  constexpr int kRu = 4;  // rows of Ginv a warp updates at once
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[nw];
  __shared__ TopKey mkeys[kAppendThreads];
  __shared__ int picks[kTopLMax];
  __shared__ float vals[kTopLMax];
  __shared__ float rrs[kAppendClusterMax];  // rank 0: the blocks' ||r||^2
  __shared__ uint64_t full, rfull, stage;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = a.n, m = a.m, k = a.k, S = a.slice, cnt = a.cnt;
  const int R = a.R, W = a.W, GP = ginv_pitch(k);
  const int p0 = min(n, rank * S), L = min(n, p0 + S) - p0;
  const int PP = static_cast<int>(gomp_parts(k, cnt, R));
  const bool resident = W >= S;  // the picks' slices stay in gs
  const int nt = (k + 31) >> 5;   // a lane's slots in the K-sized work

  // offsets into smem: slot q's slice at cs + q S and b's at bs (staged),
  // pick j's slice or chunk at gs + j W
  const int cs = 0, bs = kStaged ? k * S : 0, gs = bs + (kStaged ? S : 0);
  float* Gs = smem + gs + cnt * W;  // Ginv, pitch GP
  float* part = Gs + pad4((size_t)k * GP);  // block r's partials at part[r * PP]
  float* sm = part + C * PP;               // their sums
  float* g = sm + PP;
  float* wv = g + k;     // an append's w = u - e_slot
  float* cf = wv + k;
  float* ap = cf + k;    // an append's dinv, okf, step and ok
  int* ix = reinterpret_cast<int*>(ap + 4);
  int* grow = ix + k;  // slot q's row of the partials: q, or kold + its pick

  const float* bb = a.Bs + (size_t)b * n;
  float* colsb = a.cols + (size_t)b * k * n;
  float* Gb = a.Ginv + (size_t)b * k * k;
  float* rb = a.r + (size_t)b * n;
  const T* A = static_cast<const T*>(a.A);

  cluster_setup(&full, &rfull, C);
  if (tid == 0) {
    mbar_init(smem_u32(&stage), 1);
    mbar_fence_init();
  }
  const int kold = a.kcnt[b];
  const bool latched = a.done[b] > 0.5f;
  append_stage(Gs, GP, Gb, (size_t)k, k, k, false);
  append_stage(cf, 0, a.coef + (size_t)b * k, 0, 1, k, false);
  append_stage(reinterpret_cast<float*>(ix), 0,
               reinterpret_cast<const float*>(a.idx + (size_t)b * k), 0, 1, k,
               false);
  const bool vec = (n & 3) == 0;  // then a row's slices are 16-byte pieces
  if (kStaged) append_stage(smem + bs, 0, bb + p0, 0, 1, L, vec && aligned16(bb));
  // the old slot columns' slices, which land during the merge
  stage_slices_bulk(smem + cs, S, colsb + p0, (size_t)n, kStaged ? kold : 0,
                    L, vec && aligned16(colsb), &stage);
  cp_async_commit();
  // the row's top-cnt picks, alike in every block (NaN rule: all INT_MAX)
  merge_topl_row(a.pval + (size_t)b * a.ntiles * cnt,
                 a.pidx + (size_t)b * a.ntiles * cnt, a.ntiles * cnt, cnt,
                 picks, vals, mkeys);
  for (int q = tid; q < kold; q += kAppendThreads) grow[q] = q;

  // entries c0 .. c0+len-1 of this block's slice of every pick's column, kG
  // loads a thread in flight, at min(pick, m-1)
  const auto gather = [&](int c0, int len) {
    const int tot = cnt * len;
    for (int e0 = tid; e0 < tot; e0 += kG * kAppendThreads) {
      float x[kG];
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const int e = e0 + j * kAppendThreads;
        x[j] = 0.f;
        if (e < tot) {
          const int jj = e / len, i = e - jj * len;
          x[j] = to_f32(A[(size_t)(p0 + c0 + i) * m + min(picks[jj], m - 1)]);
        }
      }
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const int e = e0 + j * kAppendThreads;
        if (e < tot) {
          const int jj = e / len;
          smem[gs + jj * W + (e - jj * len)] = x[j];
        }
      }
    }
  };
  if (resident) gather(0, L);
  cp_async_wait_all();
  mbar_wait_cluster(smem_u32(&stage), 0);
  __syncthreads();

  int kc = kold;  // the slot count, alike in every thread
  for (int j0 = 0, round = 0; j0 < cnt; j0 += R, ++round) {
    const int j1 = min(cnt, j0 + R), Rr = j1 - j0;
    // --- this block's partials of the round: rows the old slots, the picks
    // up to j1 and b, columns the round's picks ---------------------------
    const int rows = kold + j1 + 1;
    float* mine = part + rank * PP;
    if (resident) {
      if constexpr (kStaged) {
        warp_tile_products<4, true>(
            [&](int r_) -> int {
              return r_ < kold ? cs + r_ * S : (r_ < kold + j1 ? gs + (r_ - kold) * W : bs);
            },
            [&](int c_) -> int { return gs + (j0 + c_) * W; }, rows, Rr, L,
            mine, false);
      }
    }
    if (!kStaged || !resident) {
      for (int c0 = 0; c0 < L || c0 == 0; c0 += W) {
        const int len = min(W, L - c0);
        if (!resident) {
          __syncthreads();  // the last chunk's products have read gs
          gather(c0, len);
          __syncthreads();
        }
        warp_tile_products<4, false>(
            [&](int r_) -> const float* {
              if (r_ < kold) return colsb + (size_t)r_ * n + p0 + c0;
              if (r_ < kold + j1) return smem + gs + (r_ - kold) * W;
              return bb + p0 + c0;
            },
            [&](int c_) -> const float* { return smem + gs + (j0 + c_) * W; },
            rows, Rr, len, mine, c0 > 0);
        if (len <= 0) break;
      }
    }
    __syncthreads();
    cluster_exchange(mine, rows * Rr, &full, C, rank, round & 1);
    cluster_sum(part, PP, C, rows * Rr, sm);
    __syncthreads();
    // the next round's sends may come once every block has read these
    if (C > 1 && j1 < cnt) cluster_arrive_release();

    // --- the round's gated appends, in pick order, on the K-sized state.
    // Warp 0 forms each one (lane l owning slots l, l + 32, ...: its rows of
    // u = Ginv g, the gate as a warp reduction); then every warp updates its
    // rows of Ginv -----------------------------------------------------------
    for (int c = 0; c < Rr; ++c) {
      const int j = j0 + c, sel = picks[j], slot = kc;
      if (warp == 0) {
        // g_q: the cross term of an old slot, the Gram entry of a pick this
        // launch put in, 0 on a free slot
        float gq[kLaneSlots], u[kLaneSlots];
        float gc = 0.f;
        bool dup = false;
#pragma unroll
        for (int t = 0; t < kLaneSlots; ++t) {
          const int q = lane + 32 * t;
          gq[t] = 0.f;
          u[t] = 0.f;
          if (t < nt && q < k) {
            gq[t] = q < kc ? sm[grow[q] * Rr + c] : 0.f;
            g[q] = gq[t];
            gc += gq[t] * cf[q];
            dup |= ix[q] == sel;
          }
        }
        __syncwarp();
#pragma unroll 4
        for (int q = 0; q < kc; ++q) {
          const float x = g[q];
#pragma unroll
          for (int t = 0; t < kLaneSlots; ++t) {
            if (t < nt) u[t] += Gs[min(lane + 32 * t, k - 1) * GP + q] * x;
          }
        }
        float gu = 0.f;
#pragma unroll
        for (int t = 0; t < kLaneSlots; ++t) gu += gq[t] * u[t];
        gu = warp_allsum(gu);
        gc = warp_allsum(gc);
        dup = __any_sync(0xffffffffu, dup);
        const float ata = sm[(kold + j) * Rr + c];
        const float beta = sm[(kold + j1) * Rr + c];
        const float d = ata - gu;
        const bool ok = slot < a.cap && !latched && !dup && (d > a.rtol * ata);
        const float okf = ok ? 1.f : 0.f;
        const float dinv = okf / (d > 0.f ? d : 1.f);
#pragma unroll
        for (int t = 0; t < kLaneSlots; ++t) {
          const int q = lane + 32 * t;
          if (t < nt && q < k) wv[q] = u[t] - (q == slot ? 1.f : 0.f);
        }
        if (lane == 0) {
          ap[0] = dinv;
          ap[1] = okf;
          ap[2] = dinv * (beta - gc);
          ap[3] = ok ? 1.f : 0.f;
          if (ok) {
            ix[slot] = sel;
            grow[slot] = kold + j;
          }
        }
      }
      __syncthreads();
      const float dinv = ap[0], okf = ap[1], step = ap[2];
      // lane c its column, warp w the rows w, w + 8, ..., kRu at once
      for (int c_ = lane; c_ < k; c_ += 32) {
        const float wc = wv[c_];
        for (int r0 = warp; r0 < k; r0 += kRu * nw) {
          float x[kRu], wa[kRu];
#pragma unroll
          for (int jj = 0; jj < kRu; ++jj) {
            const int r_ = min(r0 + jj * nw, k - 1);
            x[jj] = Gs[r_ * GP + c_];
            wa[jj] = wv[r_];
          }
#pragma unroll
          for (int jj = 0; jj < kRu; ++jj) {
            const int r_ = r0 + jj * nw;
            if (r_ < k) {
              Gs[r_ * GP + c_] = appended(x[jj], dinv, wa[jj], wc, okf,
                                          r_ == slot && c_ == slot);
            }
          }
        }
      }
      if (tid < k) cf[tid] -= step * wv[tid];
      kc += ap[3] > 0.5f ? 1 : 0;
      __syncthreads();
    }
  }

  // --- this block's slice of the new columns and of r = b - cols' coef
  // over slots < kc, in slot order, kE entries a thread at once ------------
  const auto pickval = [&](int j, int i) -> float {
    return resident ? smem[gs + j * W + i]
                    : to_f32(A[(size_t)(p0 + i) * m + min(picks[j], m - 1)]);
  };
  float rr = 0.f;
  for (int i0 = tid; i0 < L; i0 += kE * kAppendThreads) {
    int ie[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      ie[e] = i0 + e * kAppendThreads;
      ie[e] = ie[e] < L ? ie[e] : i0;  // past the edge: a repeat, not kept
    }
    // the new columns: into their slots (and their staged places)
    for (int s = kold; s < kc; ++s) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float x = pickval(grow[s] - kold, ie[e]);
        colsb[(size_t)s * n + p0 + ie[e]] = x;
        if (kStaged) smem[cs + s * S + ie[e]] = x;
      }
    }
    float acc[kE] = {};
#pragma unroll 4
    for (int s = 0; s < kc; ++s) {
      const float w = cf[s];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        acc[e] += (kStaged ? smem[cs + s * S + ie[e]]
                           : colsb[(size_t)s * n + p0 + ie[e]]) * w;
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (e > 0 && ie[e] == i0) continue;
      // slot 0's zero column when no slot is filled: a NaN row stays NaN
      const float ri = (kStaged ? smem[bs + ie[e]] : bb[p0 + ie[e]])
                       - (kc == 0 ? acc[e] + 0.f * cf[0] : acc[e]);
      rb[p0 + ie[e]] = ri;
      rr += ri * ri;
    }
  }
  store_ginv_share(Gs, GP, Gb, k, C, rank);
  if (rank == 0 && tid < k) {
    a.coef[(size_t)b * k + tid] = cf[tid];
    a.idx[(size_t)b * k + tid] = ix[tid];
  }
  rr = cluster_rnorm2(rr, red_v, rrs, &rfull, C, rank);
  if (rank == 0 && tid == 0) {
    a.kcnt[b] = kc;
    if (rr < a.eps2 || kc >= n) a.done[b] = 1.f;
  }
}

// ------------------------------------------------------------- ompr_swap ----

// A block's partials: g and gr of each occupied slot, then acol's (ata,
// acol . r) and b's (beta, b . r).
__host__ __device__ constexpr int swap_parts(int K) { return 2 * (K + 2); }

// ompr_swap's dynamic shared memory: (staged) the slices of the K slot
// columns (pitch S); the slices of the gathered column, b and r; Ginv (K
// rows of ginv_pitch(K)); g, gr, coef, Atb, the append's w and the
// deletion's q (K each); the C blocks' partials and their sums; idx and the
// occupied (then live) slots in slot order; the scalars of the swap (8).
__host__ __device__ constexpr size_t swap_cluster_smem(int S, int K, int C,
                                                       bool staged) {
  return ((staged ? (size_t)K * S : 0) + 3 * (size_t)S +
          pad4((size_t)K * ginv_pitch(K)) + 6 * (size_t)K +
          (size_t)(C + 1) * pad4(swap_parts(K)) + 2 * (size_t)K + 8) *
         sizeof(float);
}

// The plan for B rows, n and K slots: cluster_size with the streamed
// variant as the least a block needs; staged where it fits.
inline AppendPlan ompr_plan(int B, int n, int K, bool* ok) {
  const int C = cluster_size(B, n, [&](int c) {
    return swap_cluster_smem(cluster_slice(n, c), K, c, false) <= kAppendSmemBudget;
  });
  const int S = cluster_slice(n, C);
  *ok = swap_cluster_smem(S, K, C, false) <= kAppendSmemBudget;
  const bool staged = swap_cluster_smem(S, K, C, true) <= kAppendSmemBudget;
  return AppendPlan{C, S, staged ? 1 : 0, swap_cluster_smem(S, K, C, staged)};
}

// What one ompr_swap launch reads and writes; the pointers are the whole
// batch's.
struct SwapArgs {
  const float* pval;
  const int* pidx;
  const void* A;
  const float* Bs;
  float* cols;
  float* Ginv;
  float* coef;
  int* idx;
  float* Atb;
  float* r;
  uint8_t* amask;
  float* done;
  float* prev;
  float rtol, eta, delta2;
  int ntiles, n, m, K, slice;
};

// One OMPR replacement of one row, run by every thread of every block of
// the row's cluster (ompr_swap.cu). A done row leaves at once in every
// block alike, before any arrive, and its state stays as it was.
template <typename T, bool kStaged>
__device__ __forceinline__ void swap_cluster_row(const SwapArgs& a) {
  constexpr int nw = kAppendThreads / 32;
  constexpr int kIlp = 4;
  constexpr int kE = 2;   // entries a thread writes at once
  constexpr int kRu = 4;  // rows of Ginv a warp updates at once
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[nw];
  __shared__ int red_i[nw];
  __shared__ float rrs[kAppendClusterMax];
  __shared__ uint64_t full, rfull, stage;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = a.n, m = a.m, K = a.K, S = a.slice, GP = ginv_pitch(K);
  const int p0 = min(n, rank * S), L = min(n, p0 + S) - p0;
  const int PP = static_cast<int>(pad4(swap_parts(K)));
  const int nt = (K + 31) >> 5;  // a lane's slots in the K-sized work

  // offsets into smem: slot q's slice at cs + q S (staged), the slices of
  // the gathered column, b and r (before the append)
  const int cs = 0, ac = kStaged ? K * S : 0, bs = ac + S, rs = bs + S;
  float* Gs = smem + rs + S;  // Ginv, pitch GP
  float* g = Gs + pad4((size_t)K * GP);
  float* gr = g + K;
  float* cf = gr + K;  // coef before the append, then the refit's
  float* atb = cf + K;
  float* wv = atb + K;  // the append's w = u - e_slot
  float* qv = wv + K;   // the deletion's q
  float* part = qv + K;  // block r's partials at part[r * PP]
  float* sm = part + C * PP;
  int* ix = reinterpret_cast<int*>(sm + PP);
  int* lst = ix + K;  // the occupied slots in slot order, then the live ones
  float* sw = reinterpret_cast<float*>(lst + K);  // dinv, okf, inv
  int* si = lst + K + 4;                           // ok, hasf, p, the atom gone

  const float* bb = a.Bs + (size_t)b * n;
  float* colsb = a.cols + (size_t)b * K * n;
  float* Gb = a.Ginv + (size_t)b * K * K;
  float* rb = a.r + (size_t)b * n;
  const T* A = static_cast<const T*>(a.A);
  // slot q's entry i of this block: staged, or in device memory
  const auto colv = [&](int q_, int i) -> float {
    if constexpr (kStaged) return smem[cs + q_ * S + i];
    else return colsb[(size_t)q_ * n + p0 + i];
  };

  // --- the loads the critical path waits on, all in flight together: the
  // select partials (the pick heads the path), idx and done ---------------
  const float* pvb = a.pval + (size_t)b * a.ntiles;
  const int* pib = a.pidx + (size_t)b * a.ntiles;
  float pv[kIlp];
  int pi[kIlp];
#pragma unroll
  for (int j = 0; j < kIlp; ++j) {
    const int e = tid + j * kAppendThreads;
    pv[j] = e < a.ntiles ? pvb[e] : -INFINITY;
    pi[j] = e < a.ntiles ? pib[e] : INT_MAX;
  }
  const int ix_r = tid < K ? a.idx[(size_t)b * K + tid] : 0;
  if (a.done[b] > 0.5f) return;
  cluster_setup(&full, &rfull, C);
  if (tid == 0) {
    mbar_init(smem_u32(&stage), 1);
    mbar_fence_init();
  }
  // --- the staging, all of it at once: Ginv, coef, Atb, the slices of b, r
  // and every slot column (a free slot's column is zero and is read nowhere
  // below); it lands while the pick is reduced and the column gathered ----
  append_stage(Gs, GP, Gb, (size_t)K, K, K, false);
  append_stage(cf, 0, a.coef + (size_t)b * K, 0, 1, K, false);
  append_stage(atb, 0, a.Atb + (size_t)b * K, 0, 1, K, false);
  const bool vec = (n & 3) == 0;  // then a row's slices are 16-byte pieces
  append_stage(smem + bs, 0, bb + p0, 0, 1, L, vec && aligned16(bb));
  append_stage(smem + rs, 0, rb + p0, 0, 1, L, vec && aligned16(rb));
  stage_slices_bulk(smem + cs, S, colsb + p0, (size_t)n, kStaged ? K : 0,
                    L, vec && aligned16(colsb), &stage);
  cp_async_commit();
  if (tid < K) {
    ix[tid] = ix_r;
    g[tid] = 0.f;
    gr[tid] = 0.f;
  }

  // --- the row's (max, lowest argmax) with argmax_combine's rule ----------
  float vmax = -INFINITY;
  int sel = INT_MAX;
#pragma unroll
  for (int j = 0; j < kIlp; ++j) argmax_combine(vmax, sel, pv[j], pi[j]);
  for (int e0 = tid + kIlp * kAppendThreads; e0 < a.ntiles;
       e0 += kIlp * kAppendThreads) {
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const int e = e0 + j * kAppendThreads;
      pv[j] = e < a.ntiles ? pvb[e] : -INFINITY;
      pi[j] = e < a.ntiles ? pib[e] : INT_MAX;
    }
#pragma unroll
    for (int j = 0; j < kIlp; ++j) argmax_combine(vmax, sel, pv[j], pi[j]);
  }
  warp_argmax(vmax, sel);
  if (lane == 0) {
    red_v[warp] = vmax;
    red_i[warp] = sel;
  }
  __syncthreads();
  vmax = red_v[0];
  sel = red_i[0];
  for (int w = 1; w < nw; ++w) argmax_combine(vmax, sel, red_v[w], red_i[w]);
  const bool change = vmax > 0.f;

  // --- this block's slice of A[:, min(sel, m-1)], kIlp loads at once ------
  const int ic = min(sel, m - 1);
  for (int i0 = tid; i0 < L; i0 += kIlp * kAppendThreads) {
    float x[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const int i = i0 + j * kAppendThreads;
      x[j] = i < L ? to_f32(A[(size_t)(p0 + i) * m + ic]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      if (i0 + j * kAppendThreads < L) smem[ac + i0 + j * kAppendThreads] = x[j];
    }
  }
  // the occupied slots (warp 0 lists them), their count, the first free
  // slot and the duplicate test, in every warp alike
  int nat = 0, slot = K;
  bool dup = false;
  for (int c0 = 0; c0 < K; c0 += 32) {
    const int c = c0 + lane;
    const bool occ = c < K && ix[c] < m;
    const unsigned bo = __ballot_sync(0xffffffffu, occ);
    if (warp == 0 && occ) lst[nat + __popc(bo & ((1u << lane) - 1u))] = c;
    nat += __popc(bo);
    const unsigned fr = __ballot_sync(0xffffffffu, c < K && !occ);
    if (slot == K && fr) slot = c0 + __ffs(fr) - 1;
    dup |= c < K && ix[c] == sel;
  }
  dup = __any_sync(0xffffffffu, dup);
  cp_async_wait_all();
  mbar_wait_cluster(smem_u32(&stage), 0);
  __syncthreads();

  // --- this block's partials: rows the occupied slots, acol and b, columns
  // acol and r (before the append) ------------------------------------------
  const int np = swap_parts(nat);
  float* mine = part + rank * PP;
  if constexpr (kStaged) {
    warp_tile_products<2, true>(
        [&](int r_) -> int {
          return r_ < nat ? cs + lst[r_] * S : (r_ == nat ? ac : bs);
        },
        [&](int c_) -> int { return c_ == 0 ? ac : rs; }, nat + 2, 2, L, mine,
        false);
  } else {
    warp_tile_products<2, false>(
        [&](int r_) -> const float* {
          return r_ < nat ? colsb + (size_t)lst[r_] * n + p0
                          : smem + (r_ == nat ? ac : bs);
        },
        [&](int c_) -> const float* { return smem + (c_ == 0 ? ac : rs); },
        nat + 2, 2, L, mine, false);
  }
  __syncthreads();
  cluster_exchange(mine, np, &full, C, rank);
  // the rank-order sums: g and gr into their slots, the rest in sm
  for (int e = tid; e < np; e += kAppendThreads) {
    float s = part[e];
    for (int r_ = 1; r_ < C; ++r_) s += part[r_ * PP + e];
    if (e < 2 * nat) (e & 1 ? gr : g)[lst[e >> 1]] = s;
    else sm[e] = s;
  }
  __syncthreads();

  // --- the K-sized work. Warp 0 forms it, lane l owning slots l, l + 32,
  // ...: its rows of u = Ginv g, the append's gate, the gradient step's
  // least |gcoef| over the slots occupied after the append (lowest slot on
  // ties, a NaN minimum kept: no deletion), and q = the deleted slot's
  // column of Ginv after the append; then every warp updates its rows of
  // Ginv --------------------------------------------------------------------
  const float beta = sm[2 * nat + 2];
  if (warp == 0) {
    float u[kLaneSlots], w[kLaneSlots], q[kLaneSlots], sc[kLaneSlots];
#pragma unroll
    for (int t = 0; t < kLaneSlots; ++t) u[t] = q[t] = 0.f;
#pragma unroll 4
    for (int c = 0; c < K; ++c) {
      const float x = g[c];
#pragma unroll
      for (int t = 0; t < kLaneSlots; ++t) {
        if (t < nt) u[t] += Gs[min(lane + 32 * t, K - 1) * GP + c] * x;
      }
    }
    const float ata = sm[2 * nat], ar = sm[2 * nat + 1];
    float gu = 0.f;
#pragma unroll
    for (int t = 0; t < kLaneSlots; ++t) {
      const int r_ = lane + 32 * t;
      if (t < nt && r_ < K) gu += g[r_] * u[t];
    }
    gu = warp_allsum(gu);
    const float d = ata - gu;
    const bool ok = change && slot < K && !dup && (d > a.rtol * ata);
    const float okf = ok ? 1.f : 0.f;
    const float dinv = okf / (d > 0.f ? d : 1.f);
    // |gcoef| of slot c: |coef_pre + eta cols[c] . r_pre|, the new slot's
    // coef_pre 0; inf where the slot is free or nothing went in
    float dmin = INFINITY;
#pragma unroll
    for (int t = 0; t < kLaneSlots; ++t) {
      const int c = lane + 32 * t;
      w[t] = u[t] - (c == slot ? 1.f : 0.f);
      sc[t] = INFINITY;
      if (t < nt && c < K && ok) {
        const bool occ = ix[c] < m;
        if (occ || c == slot) {
          sc[t] = fabsf(cf[c] * (occ ? 1.f : 0.f) + a.eta * (occ ? gr[c] : ar));
        }
      }
      dmin = min_keep_nan(dmin, sc[t]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      dmin = min_keep_nan(dmin, __shfl_xor_sync(0xffffffffu, dmin, off));
    }
    int p = K;
#pragma unroll
    for (int t = 0; t < kLaneSlots; ++t) {
      const unsigned bal = __ballot_sync(0xffffffffu, t < nt && sc[t] == dmin);
      if (p == K && bal) p = 32 * t + __ffs(bal) - 1;
    }
    const bool hasf = ok && dmin < INFINITY;
    float inv = 0.f;
    if (hasf) {
      const float wp = __shfl_sync(0xffffffffu, lane_slot(w, p >> 5), p & 31);
#pragma unroll
      for (int t = 0; t < kLaneSlots; ++t) {
        const int r_ = min(lane + 32 * t, K - 1);
        q[t] = appended(Gs[r_ * GP + p], dinv, w[t], wp, okf, r_ == slot && p == slot);
      }
      const float qpp = __shfl_sync(0xffffffffu, lane_slot(q, p >> 5), p & 31);
      inv = 1.f / (qpp > 0.f ? qpp : 1.f);
    }
#pragma unroll
    for (int t = 0; t < kLaneSlots; ++t) {
      const int c = lane + 32 * t;
      if (t < nt && c < K) {
        wv[c] = w[t];
        qv[c] = q[t];
      }
    }
    if (lane == 0) {
      sw[0] = dinv;
      sw[1] = okf;
      sw[2] = inv;
      si[0] = ok;
      si[1] = hasf;
      si[2] = p;
      si[3] = hasf ? (p == slot ? sel : ix[p]) : m;  // the atom that leaves
    }
  }
  __syncthreads();
  const bool ok = si[0], hasf = si[1];
  const int p = si[2], gone = si[3];
  const float dinv = sw[0], okf = sw[1], inv = sw[2];

  // --- Ginv: the append, then the deletion's downdate Ginv -= q q' / q_p
  // with the identity pad put back (each warp its rows); Atb; idx. When the
  // atom deleted is the one appended, the append and the downdate of its
  // slot cancel: Ginv and Atb stay exactly as they were (the plain version
  // rounds the two steps), so a settled row's refit, r and res repeat the
  // last swap's bits and its latch (prev <= res) holds -----------------------
  const bool own = hasf && p == slot;
  // lane c its column, warp w the rows w, w + 8, ..., kRu at once
  for (int c = lane; c < K && !own; c += 32) {
    const float wc = wv[c], qc = qv[c];
    for (int r0 = warp; r0 < K; r0 += kRu * nw) {
      float x[kRu], wa[kRu], qa[kRu];
#pragma unroll
      for (int jj = 0; jj < kRu; ++jj) {
        const int r_ = min(r0 + jj * nw, K - 1);
        x[jj] = Gs[r_ * GP + c];
        wa[jj] = wv[r_];
        qa[jj] = qv[r_];
      }
#pragma unroll
      for (int jj = 0; jj < kRu; ++jj) {
        const int r_ = r0 + jj * nw;
        if (r_ < K) {
          float y = appended(x[jj], dinv, wa[jj], wc, okf, r_ == slot && c == slot);
          if (hasf) y = y - inv * qa[jj] * qc + ((r_ == p && c == p) ? 1.f : 0.f);
          Gs[r_ * GP + c] = y;
        }
      }
    }
  }
  if (tid < K && !own) {
    float x = atb[tid] + beta * ((ok && tid == slot) ? 1.f : 0.f);
    if (hasf && tid == p) x *= 0.f;
    atb[tid] = x;
  }
  if (tid == 0) {
    if (ok) ix[slot] = sel;
    if (hasf) ix[p] = m;
  }
  __syncthreads();
  cluster_matvec(Gs, atb, cf, GP, K, K);  // coef = Ginv Atb
  const int nl = live_slots(ix, K, m, K, lst);
  __syncthreads();

  // --- this block's slice of the new column, the cleared one and r = b -
  // cols' coef over the live slots in slot order, kE entries a thread at
  // once ------------------------------------------------------------------
  float rr = 0.f;
  for (int i0 = tid; i0 < L; i0 += kE * kAppendThreads) {
    int ie[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      ie[e] = i0 + e * kAppendThreads;
      ie[e] = ie[e] < L ? ie[e] : i0;  // past the edge: a repeat, not kept
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = ie[e];
      if (ok) {  // the new column (cleared at once when it is the one deleted)
        const float x = smem[ac + i] * (hasf && p == slot ? 0.f : 1.f);
        colsb[(size_t)slot * n + p0 + i] = x;
        if (kStaged) smem[cs + slot * S + i] = x;
      }
      if (hasf && p != slot) colsb[(size_t)p * n + p0 + i] = colv(p, i) * 0.f;
    }
    float acc[kE] = {};
#pragma unroll 4
    for (int e2 = 0; e2 < nl; ++e2) {
      const int q_ = lst[e2];
      const float wq = cf[q_];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        acc[e] += (!kStaged && ok && q_ == slot ? smem[ac + ie[e]] : colv(q_, ie[e])) * wq;
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (e > 0 && ie[e] == i0) continue;
      // slot 0's zero column when no slot is live: a NaN row stays NaN
      const float ri = smem[bs + ie[e]] - (nl == 0 ? acc[e] + 0.f * cf[0] : acc[e]);
      rb[p0 + ie[e]] = ri;
      rr += ri * ri;
    }
  }
  store_ginv_share(Gs, GP, Gb, K, C, rank);
  if (rank == 0) {
    if (tid < K) {
      a.coef[(size_t)b * K + tid] = cf[tid];
      a.idx[(size_t)b * K + tid] = ix[tid];
      a.Atb[(size_t)b * K + tid] = atb[tid];
    }
    if (tid == 0) {
      uint8_t* am = a.amask + (size_t)b * m;
      if (ok && sel < m) am[sel] = 1;
      if (gone < m) am[gone] = 0;
    }
  }
  rr = cluster_rnorm2(rr, red_v, rrs, &rfull, C, rank);
  if (rank == 0 && tid == 0) {
    const float pv0 = a.prev[b];
    const float res = ok ? rr : pv0;
    if (!change || res <= a.delta2 || pv0 <= res) a.done[b] = 1.f;
    a.prev[b] = res;
  }
}

}  // namespace cstpu
