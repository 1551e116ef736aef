// The slot engine's launches as a thread-block cluster per row over staged
// slot columns: the appends (rmp_append.cu, srr_append.cu, engine_init.cu)
// and the backward deletions (engine_delete.cu, engine_backward.cu).
//
// The math is that of cstpu/ops/fused_twostage.py::_Engine (append
// :138-190, backward_min :126-136, delete_ep :192-216, refit_residual
// :218-223) and of its plain twins in cstpu_torch/ops/fused_twostage.py;
// what differs is where it runs, and for the init the order of its sums.
// The cluster, the cp.async staging and the launch are append_cluster.cuh's,
// which the insertion-order appends of omp_append.cu and fr_append.cu run
// on.
//
// What bounds these launches on an H100: latency. One row's work is a few
// hundred KB at most (its K slot columns, one or cnt dictionary columns
// gathered at a 32-byte sector an entry, strided by m) and O(K n) flops;
// one block per row left most of the card idle (B = 8 rows on 132 SMs),
// read the slot columns from device memory three times a launch, walked
// the gate in one thread and, in the init, ran cnt dependent appends each
// with its own gather and K + 2 products of length n. Design:
//   cluster  C blocks per row (engine_plan: C from B, n, K and cnt alone,
//            so that B C fills the 132 SMs); block `rank` owns entries p0 ..
//            p0+L-1 of n (slices of `slice` entries, a multiple of 4, the
//            last one ragged or empty);
//   stage    at entry every block issues its loads of the row's select
//            partials (the pick heads the critical path), then cp.async
//            copies of Ginv and of its slices of b, r and (staged) the
//            occupied slot columns, which land while the pick is reduced
//            and the column gathered (the init: its slices of all cnt
//            picked columns at once). Where the columns do not fit beside
//            the state, the plan takes the streamed instantiation, which
//            reads them from device memory where it uses them;
//   exchange each block's partials (rmp_append: g over the occupied slots,
//            ata, beta, ||r||^2; engine_init: the Gram of the cnt picks and
//            their betas) go into the other blocks' shared memory with an
//            mbarrier arrive (cluster_exchange), once a launch; every block
//            adds the C partials in rank order, so every block holds the
//            same bits and runs the K-sized work alike, with no further
//            exchange: the gate as a warp reduction, the Ginv update, the
//            refit, FoBa's deletions, the init's appends (sweeps of the
//            picks' Gram, two a barrier);
//   write    every block writes its slice of the n-sized results from the
//            staged columns, summed over the live slots in slot order: the
//            new column, the pending terms (aperp, FoBa's restore terms
//            v = cols' q), r = b - cols' coef. A free slot's column is zero
//            and its weight finite on a finite state, so the live sums equal
//            the all-slot ones term for term; a NaN row has NaN in every
//            coefficient, and the live set always holds one slot (the
//            append's, or slot 0), so both give NaN. Every block writes a
//            share of Ginv's rows; rank 0 the row's K-sized state and flags.
// No block reads another's shared memory; a block writes into another's
// only before that block's wait on the barrier it arrives on, so a block
// may leave before the rest. Every block reads the row's state before it
// sends and writes it only after it has received, which is after every
// other block has sent. The deletion kernels have no exchange of partials
// (engine_delete sends only its share of ||r||^2, one way, to rank 0): a
// cluster barrier, arrived at once a block has read the row's state and
// waited on before its first write of it, gives them that order.
#pragma once

#include "append_cluster.cuh"

namespace cstpu {

// The products of one launch, a block's partials: rmp_append's g (K), ata,
// beta, ||r||^2; engine_init's lower Gram triangle and cnt betas.
__host__ __device__ constexpr int rmp_parts(int K) { return K + 3; }
__host__ __device__ constexpr int init_parts(int cnt) {
  return cnt * (cnt + 1) / 2 + cnt;
}

__host__ __device__ constexpr size_t pad4(size_t x) { return (x + 3) & ~(size_t)3; }

// rmp_append's shared memory: the staged slot slices (K, staged only),
// Ginv (K K), the slices of the gathered column, b and r, g, u, coef, Atb,
// q, the cluster's partials, idx and the live slots.
__host__ __device__ constexpr size_t rmp_cluster_smem(int slice, int K,
                                                      bool staged) {
  return ((staged ? (size_t)K * slice : 0) + pad4((size_t)K * K) +
          3 * (size_t)slice + 5 * (size_t)K +
          (size_t)kAppendClusterMax * pad4(rmp_parts(K)) + 2 * (size_t)K) *
         sizeof(float);
}

// engine_init's: the slice of b, the gathered slices of the cnt picks
// and a zero row (staged only, a pitch of slice + 1), three kInitLead x
// kInitPitch matrices (Ginv's leading block, the two buffers of the swept
// Gram), the Gram (cnt cnt) and the betas, each append's u (cnt rows of
// kInitPitch), coef, Atb (K), dinv (cnt), the Gram tiles' partials (16 a
// thread), the cluster's partials, idx and the pick of each slot (K), each
// append's slot and gate (cnt).
constexpr int kInitLead = 32;   // the most slots the init fills (kTopLMax)
constexpr int kInitPitch = 33;  // odd: a column's entries lie in 32 banks
__host__ __device__ constexpr size_t init_cluster_smem(int slice, int K,
                                                       int cnt, bool staged) {
  return ((size_t)slice + (staged ? (size_t)(cnt + 1) * (slice + 1) : 0) +
          3 * (size_t)kInitLead * kInitPitch + (size_t)cnt * cnt +
          (size_t)cnt * kInitPitch + 2 * (size_t)cnt + 2 * (size_t)K +
          16 * (size_t)kAppendThreads +
          (size_t)kAppendClusterMax * pad4(init_parts(cnt)) + 2 * (size_t)K +
          2 * (size_t)cnt) *
         sizeof(float);
}

// engine_init's and gomp_append's static shared memory (the merge's keys,
// the picks) takes this much of the budget besides.
constexpr size_t kInitStaticSmem = 4096;

// The plan of rmp_append (cnt = 0) or engine_init (cnt picks) for B rows,
// n and K slots: cluster_size with the streamed variant as the least a
// block needs; staged where it fits. `ok` is false when no cluster size up
// to kAppendClusterMax fits.
inline AppendPlan engine_plan(int B, int n, int K, int cnt, bool* ok) {
  const auto bytes = [K, cnt](int S, bool staged) {
    return cnt > 0 ? init_cluster_smem(S, K, cnt, staged) + kInitStaticSmem
                   : rmp_cluster_smem(S, K, staged);
  };
  const int C = cluster_size(B, n, [&](int c) {
    return bytes(cluster_slice(n, c), false) <= kAppendSmemBudget;
  });
  const int S = cluster_slice(n, C);
  *ok = bytes(S, false) <= kAppendSmemBudget;
  const bool staged = bytes(S, true) <= kAppendSmemBudget;
  return AppendPlan{C, S, staged ? 1 : 0,
                    bytes(S, staged) - (cnt > 0 ? kInitStaticSmem : 0)};
}

// The cluster's mbarriers, set up at entry by thread 0 of every block:
// `full` takes the other C - 1 blocks' partials (32 arrivals each), the
// second (engine_init's rank 0) their shares of ||r||^2 (one each). Every
// thread then arrives on the cluster barrier that tells the blocks their
// barriers are set up; cluster_exchange waits on it.
__device__ __forceinline__ void cluster_setup(uint64_t* full, uint64_t* second,
                                              int C) {
  if (C > 1) {
    if (threadIdx.x == 0) {
      mbar_init(smem_u32(full), (C - 1) * 32);
      if (second) mbar_init(smem_u32(second), C - 1);
      mbar_fence_init();
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
}

// Send this block's `count` partials at `mine` (the same offset in every
// block's shared memory) to the other blocks: warp w to block rank + 1 + w
// (mod C), each lane its entries, then an arrive on that block's `full`
// that releases them; then wait on this block's `full` for theirs. Every
// thread of every block calls it once an exchange, after an arrive on the
// cluster barrier (cluster_setup's for the first; for exchange e > 0 one
// made once the block has read exchange e - 1's partials) and a barrier
// that follows the writes to `mine`; exchange e waits on phase e of
// `full`, parity e & 1.
__device__ __forceinline__ void cluster_exchange(float* mine, int count,
                                                 uint64_t* full, int C,
                                                 int rank, int parity = 0) {
  if (C == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp < C - 1) {
    const int d = (rank + 1 + warp) % C;
    float* dst = cluster.map_shared_rank(mine, d);
    for (int q = lane; q < count; q += 32) dst[q] = mine[q];
    mbar_arrive_remote(smem_u32(full), d);
  }
  mbar_wait_cluster(smem_u32(full), static_cast<uint32_t>(parity));
}

// out[a] = sum_c M[a K + c] x[c] over c < ncols, for rows a < nrows, kIlp
// rows a warp at once (M, x, out in shared memory). No barrier.
__device__ __forceinline__ void cluster_matvec(const float* M, const float* x,
                                               float* out, int K, int nrows,
                                               int ncols) {
  constexpr int kIlp = 4, nw = kAppendThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp; r0 < nrows; r0 += kIlp * nw) {
    float acc[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) acc[j] = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float xc = x[c];
#pragma unroll
      for (int j = 0; j < kIlp; ++j) {
        acc[j] += M[min(r0 + j * nw, nrows - 1) * K + c] * xc;
      }
    }
#pragma unroll
    for (int j = 0; j < kIlp; ++j) acc[j] = warp_sum(acc[j]);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kIlp; ++j) {
        if (r0 + j * nw < nrows) out[r0 + j * nw] = acc[j];
      }
    }
  }
}

// The live slots in slot order, into lst (the count is returned): those
// with idx < m, and `extra` (K: none). Warp 0 writes lst; every thread
// gets the count. The caller puts a barrier between this and reads of lst.
__device__ __forceinline__ int live_slots(const int* ix, int K, int m,
                                          int extra, int* lst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nl = 0;
  for (int c0 = 0; c0 < K; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < K && (ix[c] < m || c == extra);
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (warp == 0 && live) lst[nl + __popc(bal & ((1u << lane) - 1u))] = c;
    nl += __popc(bal);
  }
  return nl;
}

// Start cp.async copies of this block's slices (entries p0 .. p0+L-1) of
// the row's occupied slot columns (idx < m; a free slot's column is zero
// and nothing reads it before it is written) into cs[q * S]: warp w the
// slots w, w + 8, ..., its lanes along the slice, 16-byte pieces with v16.
__device__ __forceinline__ void stage_occupied(float* cs, const float* colsb,
                                               const int* ix, int K, int m,
                                               int n, int p0, int L, int S,
                                               bool v16) {
  constexpr int nw = kAppendThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q_ = warp; q_ < K; q_ += nw) {
    if (ix[q_] >= m) continue;
    const float* src = colsb + (size_t)q_ * n + p0;
    if (v16) {
      for (int i = 4 * lane; i < L; i += 128) cp_async16(cs + q_ * S + i, src + i);
    } else {
      for (int i = lane; i < L; i += 32) cp_async4(cs + q_ * S + i, src + i);
    }
  }
}

// ------------------------------------------------------------ deletions ----

// The next deletion's score, in every warp alike (backward_min): the least
// coef^2 / max(Ginv_pp, 1e-30) over the occupied slots (dmin: NaN if a
// score is NaN, inf if no slot is occupied), its slot p (the lowest on
// ties; K when there is none, a NaN minimum included) and, with kNat, the
// number of occupied slots nat (else 0). Slot c's Ginv_pp is G[c ld + c]
// (Ginv itself: ld = K; its diagonal alone: ld = 0).
template <bool kNat>
__device__ __forceinline__ void deletion_score(const float* cf,
                                               const float* G, int ld,
                                               const int* ix, int K, int m,
                                               float& dmin, int& p,
                                               int& nat) {
  const int lane = threadIdx.x & 31;
  dmin = INFINITY;
  for (int c = lane; c < K; c += 32) {
    const float x = cf[c];
    const float d2 = ix[c] < m ? x * x / max_keep_nan(G[c * ld + c], 1e-30f) : INFINITY;
    dmin = min_keep_nan(dmin, d2);
  }
  for (int off = 16; off > 0; off >>= 1) {
    dmin = min_keep_nan(dmin, __shfl_xor_sync(0xffffffffu, dmin, off));
  }
  p = K;
  nat = 0;
  for (int c0 = 0; c0 < K; c0 += 32) {
    const int c = c0 + lane;
    bool hit = false;
    if (c < K) {
      const float x = cf[c];
      const float d2 = ix[c] < m ? x * x / max_keep_nan(G[c * ld + c], 1e-30f) : INFINITY;
      hit = d2 == dmin;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (p == K && bal) p = c0 + __ffs(bal) - 1;
    if (kNat) nat += __popc(__ballot_sync(0xffffffffu, c < K && ix[c] < m));
  }
}

// One row's state in a block's shared memory for its deletions: Ginv
// (K K), coef, Atb, q (the deleted slot's column of Ginv) and idx (K), the
// live-slot list (K), the slot columns (staged: this block's slices at
// cs[s * S]; else the row's, (K, n), in device memory).
struct DelRow {
  float* Gs;
  float* cf;
  float* atb;
  float* q;
  int* ix;
  int* lst;
  float* cs;
  float* colsb;
  int B, b, n, m, K, S, p0, L, rank;
};

// The backward deletions of one row, run alike by every thread of every
// block of the row's cluster (FoBa's in rmp_append, SRR's in engine_delete,
// RMP's in engine_backward), their results into the batch's pending terms
// a.pend_u (P, B, n), weights a.pend_w (P, B) and a.amask (B, m) (a: the
// launch's RmpArgs or DelArgs, read where used): at most jmax times, while accept(dmin, nat)
// holds for the next score (deletion_score, nat counted with kNat; a NaN
// dmin must reject), delete
// slot p (delete_ep): q = Ginv e_p, the restore term v = cols' q over the
// occupied slots in slot order (this block's slice) and 1/q_pp into pending
// slot 1 + j (rank 0 the weight, and amask[idx[p]] = 0), the Schur downdate
// Ginv -= q q' / q_pp with the identity pad put back, column p (this
// block's slice), idx[p] and Atb[p] cleared, coef = Ginv Atb. No exchange:
// every block holds the same K-sized state and takes the same steps.
// Starts with a barrier; idx, Atb, Ginv and the columns are settled on
// return, coef only after a barrier. Returns the number of deletions.
template <bool kStaged, bool kNat, typename Args, typename Accept>
__device__ __forceinline__ int cluster_deletions(const DelRow& d,
                                                 const Args& a, int jmax,
                                                 Accept accept) {
  constexpr int nw = kAppendThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = d.K, m = d.m, S = d.S;
  // slot q's entries of this block: staged, or in device memory
  const auto col = [&](int q_) -> float* {
    return kStaged ? d.cs + q_ * S : d.colsb + (size_t)q_ * d.n + d.p0;
  };
  int nd = 0;
  for (int j = 0; j < jmax; ++j) {
    __syncthreads();  // coef, idx, Atb, Ginv and the columns settled
    float dmin;
    int p, nat;
    deletion_score<kNat>(d.cf, d.Gs, K, d.ix, K, m, dmin, p, nat);
    if (!accept(dmin, nat)) break;
    // q = Ginv e_p; v = cols' q over the occupied slots (p included),
    // taken before the column is cleared
    if (tid < K) d.q[tid] = d.Gs[tid * K + p];
    const int nl = live_slots(d.ix, K, m, K, d.lst);
    __syncthreads();
    const float qpp = d.q[p];
    const float inv = 1.f / (qpp > 0.f ? qpp : 1.f);
    float* vout = a.pend_u + ((size_t)(1 + nd) * d.B + d.b) * d.n;
    for (int i = tid; i < d.L; i += kAppendThreads) {
      float accv = 0.f;
      for (int e = 0; e < nl; ++e) accv += col(d.lst[e])[i] * d.q[d.lst[e]];
      vout[d.p0 + i] = accv;
    }
    if (d.rank == 0 && tid == 0) {
      a.pend_w[(size_t)(1 + nd) * d.B + d.b] = inv;
      if (d.ix[p] < m) a.amask[(size_t)d.b * m + d.ix[p]] = 0;
    }
    for (int r_ = warp; r_ < K; r_ += nw) {
      const float qa = d.q[r_];
      for (int c = lane; c < K; c += 32) {
        float* x = d.Gs + r_ * K + c;
        *x = *x - inv * qa * d.q[c] + ((r_ == p && c == p) ? 1.f : 0.f);
      }
    }
    __syncthreads();  // the v pass above read column p
    for (int i = tid; i < d.L; i += kAppendThreads) {
      float* x = col(p) + i;
      *x *= 0.f;
      if (kStaged) d.colsb[(size_t)p * d.n + d.p0 + i] = *x;
    }
    if (tid == 0) {
      d.ix[p] = m;
      d.atb[p] *= 0.f;
    }
    __syncthreads();
    cluster_matvec(d.Gs, d.atb, d.cf, K, K, K);  // the refit of coef
    ++nd;
  }
  return nd;
}

// ------------------------------------------------------------ rmp_append ----

// What one rmp_append launch reads and writes; the pointers are the whole
// batch's.
struct RmpArgs {
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
  const float* done;
  float* pend_u;
  float* pend_w;
  float* fgate;
  float* acc;
  float* capped;
  float* ndel;
  const float* floor2;
  float rtol, delta2;
  int ntiles, B, n, m, K, slice, foba;
};

// One RMP forward step (FoBa: and its deletions) of one row, run by every
// thread of every block of the row's cluster (rmp_append.cu). With kSrr, one
// SRR forward step (srr_append.cu): the gate reads no floor and no gain
// threshold (rr > 0 && vmax > 0), and the step writes no capped, acc or
// ndel and deletes nothing; a.floor2, a.acc, a.capped, a.ndel may be null
// and a.foba is not read. The RMP and FoBa instantiations are unchanged.
template <typename T, bool kStaged, bool kSrr = false>
__device__ __forceinline__ void rmp_cluster_row(const RmpArgs& a) {
  constexpr int nw = kAppendThreads / 32;
  constexpr int kIlp = 4;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[nw];
  __shared__ int red_i[nw];
  __shared__ float sc[3];  // ata, beta, ||r||^2 of the row
  __shared__ uint64_t full;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = a.n, m = a.m, K = a.K, S = a.slice, B = a.B;
  const int p0 = min(n, rank * S), L = min(n, p0 + S) - p0;
  const int KP = static_cast<int>(pad4(rmp_parts(K)));

  float* cs = smem;  // slot q at cs[q * S], staged only
  float* Gs = cs + (kStaged ? K * S : 0);
  float* acol = Gs + pad4((size_t)K * K);  // 16-byte aligned, as are bs, rs
  float* bs = acol + S;
  float* rs = bs + S;
  float* g = rs + S;
  float* u = g + K;
  float* cf = u + K;
  float* atb = cf + K;
  float* q = atb + K;
  float* part = q + K;  // block r's partials at part[r * KP]
  int* ix = reinterpret_cast<int*>(part + kAppendClusterMax * KP);
  int* lst = ix + K;    // slots in slot order: occupied, or live

  const float* bb = a.Bs + (size_t)b * n;
  float* colsb = a.cols + (size_t)b * K * n;
  float* Gb = a.Ginv + (size_t)b * K * K;
  float* rb = a.r + (size_t)b * n;
  float* ub = a.pend_u + (size_t)b * n;  // pending slot 0
  const T* A = static_cast<const T*>(a.A);
  // slot q's entries of this block: staged, or in device memory
  const auto col = [&](int q_) -> float* {
    return kStaged ? cs + q_ * S : colsb + (size_t)q_ * n + p0;
  };

  cluster_setup(&full, nullptr, C);

  // --- the loads the critical path waits on, all in flight together: the
  // select partials (the pick heads the path), done, fgate and idx --------
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
  const float floor2 = kSrr ? 0.f : a.floor2[b];
  const bool foba = !kSrr && a.foba;
  const bool closed = a.done[b] > 0.5f || a.fgate[b] < 0.5f;

  // --- the staging: Ginv, coef, Atb, the slices of b and r and (kStaged)
  // of the occupied slot columns (a free slot's column is zero, and nothing
  // below reads it before it is written); it lands while the pick is
  // reduced and the column gathered ----------------------------------------
  append_stage(Gs, 0, Gb, 0, 1, K * K, ((K * K) & 3) == 0 && aligned16(Gb));
  append_stage(cf, 0, a.coef + (size_t)b * K, 0, 1, K, false);
  append_stage(atb, 0, a.Atb + (size_t)b * K, 0, 1, K, false);
  const bool vec = (n & 3) == 0;  // then a row's slices are 16-byte pieces
  append_stage(bs, 0, bb + p0, 0, 1, L, vec && aligned16(bb));
  append_stage(rs, 0, rb + p0, 0, 1, L, vec && aligned16(rb));
  cp_async_commit();

  // --- a row that is done, or whose forward gate is closed, changes
  // nothing and leaves zero pending terms (every block of the row alike) --
  if (closed) {
    for (int i = tid; i < L; i += kAppendThreads) ub[p0 + i] = 0.f;
    if (rank == 0) {
      const int last = foba ? K : 0;
      for (int e = tid; e <= last; e += kAppendThreads) a.pend_w[(size_t)e * B + b] = 0.f;
      if (foba && tid == 0) a.ndel[b] = 0.f;
    }
    cp_async_wait_all();
    if (C > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    return;
  }
  if (tid < K) ix[tid] = ix_r;
  __syncthreads();
  if (kStaged) {
    stage_occupied(cs, colsb, ix, K, m, n, p0, L, S, vec && aligned16(colsb));
  }
  cp_async_commit();

  // --- the row's (max, lowest argmax) with argmax_combine's rule, which no
  // order of combining changes ---------------------------------------------
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
  // the occupied slots (warp 0 lists them), their count, the first free
  // slot and the duplicate test, in every warp alike, before a slot changes
  int nat = 0, slot = K;
  for (int c0 = 0; c0 < K; c0 += 32) {
    const int c = c0 + lane;
    const bool occ = c < K && ix[c] < m;
    const unsigned bo = __ballot_sync(0xffffffffu, occ);
    if (warp == 0 && occ) lst[nat + __popc(bo & ((1u << lane) - 1u))] = c;
    nat += __popc(bo);
    const unsigned fr = __ballot_sync(0xffffffffu, c < K && !occ);
    if (slot == K && fr) slot = c0 + __ffs(fr) - 1;
  }
  __syncthreads();
  vmax = red_v[0];
  sel = red_i[0];
  for (int w = 1; w < nw; ++w) argmax_combine(vmax, sel, red_v[w], red_i[w]);
  bool dup = false;
  for (int c = lane; c < K; c += 32) dup |= ix[c] == sel;
  dup = __any_sync(0xffffffffu, dup);

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
      if (i0 + j * kAppendThreads < L) acol[i0 + j * kAppendThreads] = x[j];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // --- this block's partials: g_q = cols[q] . acol over the occupied slots
  // (0 for a free slot, whose column is zero), ata, beta and ||r||^2 (r
  // before the step), kIlp products a warp at once --------------------------
  const int nprod = nat + 3;
  float* mine = part + rank * KP;
  for (int q0 = warp; q0 < nprod; q0 += kIlp * nw) {
    const float* x[kIlp];
    const float* y[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const int pp = min(q0 + j * nw, nprod - 1);  // past the end: a repeat
      x[j] = pp < nat ? col(lst[pp]) : (pp == nat + 2 ? rs : acol);
      y[j] = pp <= nat ? acol : (pp == nat + 1 ? bs : rs);
    }
    float acc[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) acc[j] = 0.f;
    for (int i = lane; i < L; i += 32) {
#pragma unroll
      for (int j = 0; j < kIlp; ++j) acc[j] += x[j][i] * y[j][i];
    }
#pragma unroll
    for (int j = 0; j < kIlp; ++j) acc[j] = warp_sum(acc[j]);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kIlp; ++j) {
        const int pp = q0 + j * nw;
        if (pp < nprod) mine[pp < nat ? lst[pp] : K + pp - nat] = acc[j];
      }
    }
  }
  __syncthreads();
  cluster_exchange(mine, rmp_parts(K), &full, C, rank);

  // --- the row's sums, in rank order, alike in every block ----------------
  if (tid < rmp_parts(K)) {
    float s = part[tid];
    for (int r_ = 1; r_ < C; ++r_) s += part[r_ * KP + tid];
    if (tid < K) g[tid] = ix[tid] < m ? s : 0.f;
    else sc[tid - K] = s;
  }
  __syncthreads();
  cluster_matvec(Gs, g, u, K, K, K);  // u = Ginv g
  __syncthreads();

  // --- the gate, in every warp alike --------------------------------------
  const float ata = sc[0], beta = sc[1], rr = sc[2];
  const bool wanted = rr > floor2 && vmax > (kSrr ? 0.f : a.delta2) && nat < min(n, m);
  const bool is_full = nat >= K;
  float gu = 0.f;
  for (int c = lane; c < K; c += 32) gu += g[c] * u[c];
  gu = warp_allsum(gu);
  const float d = ata - gu;
  const bool ok = wanted && !is_full && !dup && (d > a.rtol * ata);
  const float okf = ok ? 1.f : 0.f;
  const float dinv = okf / (d > 0.f ? d : 1.f);

  // --- Ginv, Atb, idx and the new column -----------------------------------
  for (int r_ = warp; r_ < K; r_ += nw) {
    const float wa = u[r_] - (r_ == slot ? 1.f : 0.f);
    for (int c = lane; c < K; c += 32) {
      const float wc = u[c] - (c == slot ? 1.f : 0.f);
      float* x = Gs + r_ * K + c;
      *x = *x + dinv * wa * wc - ((r_ == slot && c == slot) ? okf : 0.f);
    }
  }
  if (tid < K) atb[tid] += beta * ((ok && tid == slot) ? 1.f : 0.f);
  if (tid == 0 && ok) ix[slot] = sel;
  if (slot < K) {
    for (int i = tid; i < L; i += kAppendThreads) {
      const float v = acol[i] * okf;
      colsb[(size_t)slot * n + p0 + i] = v;
      if (kStaged) cs[slot * S + i] = v;
    }
  }
  __syncthreads();
  // the live slots: the occupied ones and the append's (its column is acol
  // or zero, its u 0 up to rounding)
  int nl = live_slots(ix, K, m, slot, lst);
  cluster_matvec(Gs, atb, cf, K, K, K);  // coef = Ginv Atb
  __syncthreads();

  // --- pending slot 0: aperp = acol - cols' u, and r = b - cols' coef,
  // both over the live slots (FoBa writes r again if it deletes) ----------
  for (int i = tid; i < L; i += kAppendThreads) {
    float accp = 0.f, accr = 0.f;
    for (int e = 0; e < nl; ++e) {
      const int q_ = lst[e];
      const float c = col(q_)[i];
      accp += c * u[q_];
      accr += c * cf[q_];
    }
    ub[p0 + i] = acol[i] - accp;
    rb[p0 + i] = bs[i] - accr;
  }
  if (rank == 0 && tid == 0) {
    a.pend_w[b] = -dinv;
    if (!kSrr && wanted && is_full) a.capped[b] = 1.f;
    if (ok) {
      if (!kSrr) a.acc[b] = 1.f;
      if (sel < m) a.amask[(size_t)b * m + sel] = 1;
    } else {
      a.fgate[b] = 0.f;
    }
  }

  // --- FoBa: the deletions while the increase stays below max(dmax, 0) / 4
  // (cluster_deletions), K-sized in every block alike; each block writes
  // its slice of the restore terms, and of r after the last deletion ------
  if (foba) {
    int nd = 0;
    if (ok) {
      const float thr = max_keep_nan(vmax, 0.f) * 0.25f;
      const DelRow d = {Gs, cf, atb, q, ix, lst, cs, colsb,
                        B,  b,  n,   m, K,  S,   p0, L,     rank};
      nd = cluster_deletions<kStaged, false>(
          d, a, K + 1, [thr](float dmin, int) { return dmin < thr; });
      if (rank == 0) {
        for (int e = 1 + nd + tid; e <= K; e += kAppendThreads) a.pend_w[(size_t)e * B + b] = 0.f;
      }
      if (nd > 0) {
        // r over the live slots after the last deletion: the occupied ones
        // and the append's
        nl = live_slots(ix, K, m, slot, lst);
        __syncthreads();
        for (int i = tid; i < L; i += kAppendThreads) {
          float accr = 0.f;
          for (int e = 0; e < nl; ++e) accr += col(lst[e])[i] * cf[lst[e]];
          rb[p0 + i] = bs[i] - accr;
        }
      }
    } else if (rank == 0) {
      for (int e = 1 + tid; e <= K; e += kAppendThreads) a.pend_w[(size_t)e * B + b] = 0.f;
    }
    if (rank == 0 && tid == 0) a.ndel[b] = (float)nd;
  }

  // --- Ginv (each block a share of its rows); rank 0: coef, idx, Atb ------
  {
    const int rows = (K + C - 1) / C;
    const int r1 = min(K, (rank + 1) * rows);
    for (int r_ = min(K, rank * rows) + warp; r_ < r1; r_ += nw) {
      for (int c = lane; c < K; c += 32) Gb[r_ * K + c] = Gs[r_ * K + c];
    }
  }
  if (rank == 0 && tid < K) {
    a.coef[(size_t)b * K + tid] = cf[tid];
    a.idx[(size_t)b * K + tid] = ix[tid];
    a.Atb[(size_t)b * K + tid] = atb[tid];
  }
}

// ----------------------------------------------------------- engine_init ----

// What one engine_init launch reads and writes; the pointers are the whole
// batch's (pend_u, pend_w and fgate null for OMPR).
struct InitArgs {
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
  float* pend_u;
  float* pend_w;
  float* fgate;
  float rtol;
  int ntiles, cnt, B, n, m, K, slice;
};

// Row j1 of entry e of a lower triangle stored row by row (j2 <= j1).
__device__ __forceinline__ int tri_row(int e) {
  int j = static_cast<int>((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
  while (j * (j + 1) / 2 > e) --j;
  while ((j + 1) * (j + 2) / 2 <= e) ++j;
  return j;
}

// The init of one row on the empty state (Ginv = I, idx = m, cols, coef,
// Atb 0, r = b), run by every thread of every block of the row's cluster
// (engine_init.cu): the picks merged in every block alike, their columns
// gathered at once, their Gram and betas exchanged once, the cnt gated
// appends on the state in shared memory, then the n-sized writes.
template <typename T, bool kStaged>
__device__ __forceinline__ void init_cluster_row(const InitArgs& a) {
  constexpr int nw = kAppendThreads / 32;
  constexpr int kG = 8;   // gather loads a thread in flight (streamed)
  constexpr int kE = 2;   // entries a thread writes at once
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[nw];
  __shared__ TopKey mkeys[kAppendThreads];
  __shared__ int picks[kTopLMax];
  __shared__ float vals[kTopLMax];
  __shared__ float rrs[kAppendClusterMax];  // rank 0: the blocks' ||r||^2
  __shared__ unsigned dupm[kInitLead];  // the earlier picks of pick j's atom
  __shared__ uint64_t full, rfull;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = a.n, m = a.m, K = a.K, S = a.slice, B = a.B, cnt = a.cnt;
  const int p0 = min(n, rank * S), L = min(n, p0 + S) - p0;
  const int PP = static_cast<int>(pad4(init_parts(cnt)));
  const int T2 = cnt * (cnt + 1) / 2;  // the Gram's lower triangle
  const int KL = min(K, kInitLead);    // the slots the chain can fill
  const int SP = S + 1;                // the pitch of the staged picks

  float* bs = smem;  // this block's slice of b, 16-byte aligned
  float* gs = bs + S;  // pick j's entries at gs[j * SP], staged only; a
                       // zero row at gs[cnt * SP]
  float* Lm = gs + (kStaged ? (cnt + 1) * SP : 0);  // Ginv's leading block
  float* M0 = Lm + kInitLead * kInitPitch;  // the swept Gram, two buffers
  float* M1 = M0 + kInitLead * kInitPitch;
  float* gram = M1 + kInitLead * kInitPitch;  // cnt x cnt, both triangles
  float* beta = gram + cnt * cnt;              // cnt
  float* U = beta + cnt;                       // append j's u at U[j * pitch]
  float* cf = U + cnt * kInitPitch;            // K
  float* atb = cf + K;                         // K
  float* dv = atb + K;                         // append j's dinv
  float* red = dv + cnt;                       // the tiles' partials
  float* part = red + kAppendThreads * 16;     // block r's at part[r * PP]
  int* ix = reinterpret_cast<int*>(part + kAppendClusterMax * PP);
  int* jof = ix + K;    // the pick in slot s
  int* sj = jof + K;    // the slot append j went to (the first free one)
  int* okj = sj + cnt;  // whether append j was accepted

  const float* bb = a.Bs + (size_t)b * n;
  float* colsb = a.cols + (size_t)b * K * n;
  float* rb = a.r + (size_t)b * n;
  const T* A = static_cast<const T*>(a.A);
  // pick j's entries of this block: staged, or (streamed) in slot j of the
  // row's columns, which serve as scratch until the slots are written
  const auto pick = [&](int j) -> const float* {
    return kStaged ? gs + j * SP : colsb + (size_t)j * n + p0;
  };
  // entry i of pick j (staged: indexed from the shared array itself)
  const auto pk = [&](int j, int i) -> float {
    if constexpr (kStaged) return smem[S + j * SP + i];
    else return colsb[(size_t)j * n + p0 + i];
  };

  cluster_setup(&full, &rfull, C);
  const bool vec = (n & 3) == 0;
  append_stage(bs, 0, bb + p0, 0, 1, L, vec && aligned16(bb));
  cp_async_commit();
  if (kStaged) {
    for (int i = tid; i < SP; i += kAppendThreads) gs[cnt * SP + i] = 0.f;
  }
  if (tid < K) {
    ix[tid] = m;
    jof[tid] = 0;
  }
  merge_topl_row(a.pval + (size_t)b * a.ntiles * cnt,
                 a.pidx + (size_t)b * a.ntiles * cnt, a.ntiles * cnt, cnt,
                 picks, vals, mkeys);

  // --- this block's slice of every pick's column (the INT_MAX rule of
  // common.cuh: gathered at min(sel, m-1)), all in flight together. Staged
  // from a dictionary whose rows start at 4-byte boundaries: 4-byte
  // cp.async copies (for bf16 the aligned pair that holds the entry,
  // unpacked after they land); else kG loads a thread at once --------------
  const bool pairs =
      kStaged && (reinterpret_cast<uintptr_t>(A) & 3) == 0 &&
      (std::is_same_v<T, float> || (m & 1) == 0);
  if (pairs) {
    for (int jj = 0; jj < cnt; ++jj) {
      const int ic = min(picks[jj], m - 1);
      const int c4 = std::is_same_v<T, float> ? ic : (ic & ~1);
      for (int i = tid; i < L; i += kAppendThreads) {
        cp_async4(gs + jj * SP + i,
                  reinterpret_cast<const float*>(A + (size_t)(p0 + i) * m + c4));
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if constexpr (!std::is_same_v<T, float>) {
      for (int jj = 0; jj < cnt; ++jj) {
        const bool hi = min(picks[jj], m - 1) & 1;
        for (int i = tid; i < L; i += kAppendThreads) {
          const uint32_t w = __float_as_uint(gs[jj * SP + i]);
          gs[jj * SP + i] = __uint_as_float((hi ? w >> 16 : w & 0xffffu) << 16);
        }
      }
    }
  } else {
    const int tot = cnt * L;
    for (int e0 = tid; e0 < tot; e0 += kG * kAppendThreads) {
      float x[kG];
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const int e = e0 + j * kAppendThreads;
        x[j] = 0.f;
        if (e < tot) {
          const int jj = e / L, i = e - jj * L;
          x[j] = to_f32(A[(size_t)(p0 + i) * m + min(picks[jj], m - 1)]);
        }
      }
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const int e = e0 + j * kAppendThreads;
        if (e < tot) {
          const int jj = e / L;
          const_cast<float*>(pick(jj))[e - jj * L] = x[j];
        }
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();

  // --- this block's partials: the picks' Gram (lower triangle, its
  // diagonal the ata) and their betas, in tiles of 4 x 4 (picks past cnt
  // read as zero; b is the tile column of the betas), each thread one tile
  // over one of P parts of the slice; the parts added in order -------------
  const int nt = (cnt + 3) >> 2;
  const int NT = nt * (nt + 1) / 2 + nt;
  const int P = max(1, kAppendThreads / NT);
  {
    const int t = tid % NT, p = tid / NT;
    if (p < P) {
      const bool isb = t >= nt * (nt + 1) / 2;
      const int I = isb ? t - nt * (nt + 1) / 2 : tri_row(t);
      const int J = isb ? 0 : t - I * (I + 1) / 2;
      const int i0 = L * p / P, i1 = L * (p + 1) / P;
      float acc[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[q] = 0.f;
      if constexpr (kStaged) {
        // offsets into the shared array: b at 0, the zero row for the pads
        int xo[4], yo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xo[q] = S + min(4 * I + q, cnt) * SP;
          yo[q] = isb ? (q == 0 ? 0 : S + cnt * SP) : S + min(4 * J + q, cnt) * SP;
        }
        for (int i = i0; i < i1; ++i) {
          float x[4], y[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            x[q] = smem[xo[q] + i];
            y[q] = smem[yo[q] + i];
          }
#pragma unroll
          for (int q = 0; q < 16; ++q) acc[q] += x[q >> 2] * y[q & 3];
        }
      } else {
        const float* xr[4];
        const float* yr[4];
        bool xv[4], yv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xv[q] = 4 * I + q < cnt;
          xr[q] = pick(min(4 * I + q, cnt - 1));
          yv[q] = isb ? q == 0 : 4 * J + q < cnt;
          yr[q] = isb ? bs : pick(min(4 * J + q, cnt - 1));
        }
        for (int i = i0; i < i1; ++i) {
          float x[4], y[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            x[q] = xv[q] ? xr[q][i] : 0.f;
            y[q] = yv[q] ? yr[q][i] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 16; ++q) acc[q] += x[q >> 2] * y[q & 3];
        }
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) red[(p * NT + t) * 16 + q] = acc[q];
    }
  }
  __syncthreads();
  float* mine = part + rank * PP;
  for (int q = tid; q < NT * 16; q += kAppendThreads) {
    const int t = q >> 4;
    const bool isb = t >= nt * (nt + 1) / 2;
    const int I = isb ? t - nt * (nt + 1) / 2 : tri_row(t);
    const int J = isb ? 0 : t - I * (I + 1) / 2;
    const int j1 = 4 * I + ((q >> 2) & 3), j2 = 4 * J + (q & 3);
    if (j1 >= cnt || (isb ? (q & 3) != 0 : (j2 >= cnt || j2 > j1))) continue;
    float s = red[t * 16 + (q & 15)];
    for (int p = 1; p < P; ++p) s += red[(p * NT + t) * 16 + (q & 15)];
    mine[isb ? T2 + j1 : j1 * (j1 + 1) / 2 + j2] = s;
  }
  __syncthreads();
  const int np = init_parts(cnt);
  cluster_exchange(mine, np, &full, C, rank);
  for (int e = tid; e < np; e += kAppendThreads) {
    float s = part[e];
    for (int r_ = 1; r_ < C; ++r_) s += part[r_ * PP + e];
    if (e < T2) {
      const int j1 = tri_row(e), j2 = e - j1 * (j1 + 1) / 2;
      gram[j1 * cnt + j2] = s;
      gram[j2 * cnt + j1] = s;
    } else {
      beta[e - T2] = s;
    }
  }
  __syncthreads();

  // --- the cnt gated appends. Slots fill in order from the empty state, so
  // append j goes into slot nacc <= j < 32, and its gate reads the Schur
  // complement d_j = ata_j - g_j' Ginv g_j of pick j against the picks
  // accepted before it. All of it comes from sweeps of the picks' Gram M
  // (cnt x cnt), a sweep on each accepted pick in append order: after the
  // sweeps on the accepted set Q, M[Q][Q] = -G_QQ^-1, M[Q][j] = G_QQ^-1
  // G_Qj = u_j and M[j][j] = d_j for a pick j not in Q. Every block runs
  // them alike, each sweep a rank-one update of M by all threads, one
  // barrier a step (M is double-buffered) --------------------------------------
  // M at smem[mo], the next one at smem[mo ^ flip]: offsets into the
  // shared array itself
  const int m0 = static_cast<int>(M0 - smem);
  const int flip = m0 ^ static_cast<int>(M1 - smem);
  int mo = m0;
  for (int r_ = warp; r_ < kInitLead; r_ += nw) {
    smem[m0 + r_ * kInitPitch + lane] =
        (r_ < cnt && lane < cnt) ? gram[r_ * cnt + lane] : 0.f;
  }
  if (tid < cnt) {  // the earlier picks of the same atom
    unsigned dm = 0;
    for (int q2 = 0; q2 < tid; ++q2) dm |= (picks[q2] == picks[tid] ? 1u : 0u) << q2;
    dupm[tid] = dm;
  }
  __syncthreads();
  unsigned accm = 0;  // the accepted picks
  int nacc = 0;
  // two appends a barrier: the gates of picks j and j1 = j + 1 read M's
  // 2 x 2 block (pick j1's after the sweep on j), and each element takes
  // both sweeps in turn, with the same arithmetic as one sweep at a time
  for (int j = 0; j < cnt; j += 2) {
    const int j1 = j + 1;
    const bool has1 = j1 < cnt;
    const float dj = smem[mo + j * kInitPitch + j];
    const float bq = has1 ? smem[mo + j * kInitPitch + j1] : 0.f;
    const float c2 = has1 ? smem[mo + j1 * kInitPitch + j1] : 0.f;
    const bool ok = vals[j] > -INFINITY && !(dupm[j] & accm) &&
                    (dj > a.rtol * gram[j * cnt + j]);
    const float rd = ok ? 1.f / dj : 0.f;
    const unsigned accm0 = accm | (ok ? 1u << j : 0u);
    const int nacc0 = nacc + ok;
    // M[j1][j1] after the sweep on j
    const float d1 = ok ? c2 - bq * bq * rd : c2;
    const bool ok1 = has1 && vals[j1] > -INFINITY && !(dupm[j1] & accm0) &&
                     (d1 > a.rtol * gram[j1 * cnt + j1]);
    const float rd1 = ok1 ? 1.f / d1 : 0.f;
    // u_j on the slots before append j, 0 at its own; u_j1 likewise, after
    // the sweep on j
    if (a.pend_u && tid <= nacc) {
      U[j * kInitPitch + tid] = tid < nacc ? smem[mo + jof[tid] * kInitPitch + j] : 0.f;
    }
    if (a.pend_u && has1 && tid <= nacc0) {
      float x = 0.f;
      if (tid < nacc) {
        const int q2 = jof[tid];
        x = smem[mo + q2 * kInitPitch + j1];
        if (ok) x = x - smem[mo + q2 * kInitPitch + j] * bq * rd;
      } else if (tid < nacc0) {
        x = bq * rd;  // pick j's row, after its own sweep
      }
      U[j1 * kInitPitch + tid] = x;
    }
    if (tid == 0) {
      dv[j] = ok ? 1.f / dj : 0.f;
      sj[j] = nacc;
      okj[j] = ok;
      if (ok) {
        jof[nacc] = j;
        ix[nacc] = picks[j];
      }
      if (has1) {
        dv[j1] = ok1 ? 1.f / d1 : 0.f;
        sj[j1] = nacc0;
        okj[j1] = ok1;
        if (ok1) {
          jof[nacc0] = j1;
          ix[nacc0] = picks[j1];
        }
      }
    }
    if (ok || ok1) {
      const int mn = mo ^ flip;
      // row (and column) j and j1 at this thread's column
      const float jc = smem[mo + j * kInitPitch + lane];
      const float j1c = has1 ? smem[mo + j1 * kInitPitch + lane] : 0.f;
      // the sweep on j of (j1, lane) and of (j1, j1)
      float j1c_ = j1c;
      if (ok) j1c_ = lane == j ? bq * rd : (lane == j1 ? d1 : j1c - bq * jc * rd);
#pragma unroll
      for (int it = 0; it < kInitLead / nw; ++it) {
        const int r_ = warp + it * nw;
        const float x0 = smem[mo + r_ * kInitPitch + lane];
        const float rj = smem[mo + r_ * kInitPitch + j];
        const float rj1 = has1 ? smem[mo + r_ * kInitPitch + j1] : 0.f;
        float x = x0, xr1 = rj1;  // (r, lane) and (r, j1)
        if (ok) {
          if (r_ == j) x = lane == j ? -rd : jc * rd;
          else if (lane == j) x = rj * rd;
          else x = x0 - rj * jc * rd;
          if (r_ == j) xr1 = bq * rd;
          else xr1 = rj1 - rj * bq * rd;
        }
        if (ok1) {
          if (r_ == j1) x = lane == j1 ? -rd1 : j1c_ * rd1;
          else if (lane == j1) x = xr1 * rd1;
          else x = x - xr1 * j1c_ * rd1;
        }
        smem[mn + r_ * kInitPitch + lane] = x;
      }
      mo = mn;
    }
    accm = accm0 | (ok1 ? 1u << j1 : 0u);
    nacc = nacc0 + ok1;
    __syncthreads();
  }
  // Ginv's leading block: -M on the accepted slots, the identity beyond
  for (int r_ = warp; r_ < kInitLead; r_ += nw) {
    Lm[r_ * kInitPitch + lane] =
        (r_ < nacc && lane < nacc)
            ? -smem[mo + jof[r_] * kInitPitch + jof[lane]]
            : (r_ == lane ? 1.f : 0.f);
  }
  // Atb += beta_j e_slot * ok_j, in the order of the appends (a NaN beta
  // makes every entry NaN, as the engine's does)
  if (tid < K) {
    float x = 0.f;
    for (int j = 0; j < cnt; ++j) x += beta[j] * ((okj[j] && sj[j] == tid) ? 1.f : 0.f);
    atb[tid] = x;
  }
  __syncthreads();
  // coef = Ginv Atb: the leading block's rows, the identity's beyond
  for (int r0 = warp; r0 < K; r0 += nw) {
    float acc = 0.f;
    if (r0 < KL) {
      for (int c = lane; c < KL; c += 32) acc += Lm[r0 * kInitPitch + c] * atb[c];
      acc = warp_sum(acc);
    } else {
      acc = atb[r0];
    }
    if (lane == 0) cf[r0] = acc;
  }
  __syncthreads();

  // --- this block's slice of r = b - cols' coef, of the pending terms
  // aperp_j = acol_j - cols' u_j (over the slots live at append j, slot j's
  // own included) and of the columns, slot s the pick jof[s]; each thread
  // its kE entries, read before it writes the slots (streamed: in slot
  // order, each slot s from jof[s] >= s, so no pick is overwritten before
  // it is read) -----------------------------------------------------------
  float rr = 0.f;
  for (int i0 = tid; i0 < L; i0 += kE * kAppendThreads) {
    int ie[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      ie[e] = i0 + e * kAppendThreads;
      ie[e] = ie[e] < L ? ie[e] : -1;
    }
    float acc[kE] = {};
#pragma unroll 4
    for (int s = 0; s < nacc; ++s) {
      const int js = jof[s];
      const float c = cf[s];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        if (ie[e] >= 0) acc[e] += pk(js, ie[e]) * c;
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (ie[e] < 0) continue;
      // slot 0's zero column when nothing was accepted: a NaN row stays NaN
      const float ri = bs[ie[e]] - (nacc == 0 ? acc[e] + 0.f * cf[0] : acc[e]);
      rb[p0 + ie[e]] = ri;
      rr += ri * ri;
    }
    if (a.pend_u) {
      for (int j = 0; j < cnt; ++j) {
        const float* uj = U + j * kInitPitch;
        const int sl = sj[j];
        float accp[kE] = {};
#pragma unroll 4
        for (int s = 0; s < sl; ++s) {
          const int js = jof[s];
          const float w = uj[s];
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            if (ie[e] >= 0) accp[e] += pk(js, ie[e]) * w;
          }
        }
        const float w = (okj[j] ? 1.f : 0.f) * uj[sl];
        float* out = a.pend_u + ((size_t)j * B + b) * n + p0;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (ie[e] < 0) continue;
          const float aj = pk(j, ie[e]);
          out[ie[e]] = aj - (accp[e] + aj * w);
        }
      }
    }
#pragma unroll 4
    for (int s = 0; s < K; ++s) {
      const int js = s < nacc ? jof[s] : -1;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        if (ie[e] >= 0) colsb[(size_t)s * n + p0 + ie[e]] = js >= 0 ? pk(js, ie[e]) : 0.f;
      }
    }
  }

  // --- the state: Ginv (each block a share of its rows); rank 0 the rest,
  // and prev = ||r||^2 from the blocks' shares, added in rank order --------
  {
    const int rows = (K + C - 1) / C;
    const int e1 = min(K, (rank + 1) * rows) * K;
    float* Gb = a.Ginv + (size_t)b * K * K;
    for (int e = min(K, rank * rows) * K + tid; e < e1; e += kAppendThreads) {
      const int r_ = e / K, c = e - r_ * K;
      Gb[e] = (r_ < KL && c < KL) ? Lm[r_ * kInitPitch + c] : (r_ == c ? 1.f : 0.f);
    }
  }
  rr = block_sum(rr, red_v);
  if (rank != 0) {
    if (tid == 0) {
      *cluster.map_shared_rank(&rrs[rank], 0) = rr;
      mbar_arrive_remote(smem_u32(&rfull), 0);
    }
    return;
  }
  if (tid < K) {
    a.coef[(size_t)b * K + tid] = cf[tid];
    a.idx[(size_t)b * K + tid] = ix[tid];
    a.Atb[(size_t)b * K + tid] = atb[tid];
  }
  if (tid < cnt) {
    if (okj[tid] && picks[tid] < m) a.amask[(size_t)b * m + picks[tid]] = 1;
    if (a.pend_w) a.pend_w[(size_t)tid * B + b] = -dv[tid];
  }
  if (tid == 0) {
    if (C > 1) mbar_wait_cluster(smem_u32(&rfull), 0);
    float s = rr;
    for (int r_ = 1; r_ < C; ++r_) s += rrs[r_];
    a.prev[b] = s;
    a.done[b] = 0.f;
    if (a.fgate) a.fgate[b] = 1.f;
  }
}

// ------------------------------------------ engine_delete, engine_backward ----

// What one engine_delete or engine_backward launch reads and writes; the
// pointers are the whole batch's (engine_delete: prev, k and l; its acc
// and ndel null. engine_backward: acc, ndel and kfinal; its prev null).
struct DelArgs {
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
  float* pend_u;
  float* pend_w;
  float* fgate;
  float* acc;
  float* ndel;
  float delta2;
  int B, n, m, K, kmin, l, slice;  // kmin: SRR's k, RMP's kfinal
};

// Their shared memory: the staged slot slices (K, staged only), Ginv (K K),
// the slice of b, coef, Atb, q, Ginv's diagonal (K), idx and the live slots
// (K). Less than rmp_cluster_smem on the same plan.
__host__ __device__ constexpr size_t del_cluster_smem(int slice, int K,
                                                      bool staged) {
  return ((staged ? (size_t)K * slice : 0) + pad4((size_t)K * K) +
          (size_t)slice + 6 * (size_t)K) *
         sizeof(float);
}

// A block's view of the deletion kernels' shared memory, carved as
// del_cluster_smem lays it out.
struct DelSmem {
  float* cs;
  float* Gs;
  float* bs;
  float* cf;
  float* atb;
  float* q;
  float* dg;
  int* ix;
  int* lst;
};

template <bool kStaged>
__device__ __forceinline__ DelSmem carve_del_smem(float* smem, int S, int K) {
  DelSmem s;
  s.cs = smem;  // slot q at cs[q * S], staged only
  s.Gs = s.cs + (kStaged ? K * S : 0);
  s.bs = s.Gs + pad4((size_t)K * K);  // 16-byte aligned
  s.cf = s.bs + S;
  s.atb = s.cf + K;
  s.q = s.atb + K;
  s.dg = s.q + K;
  s.ix = reinterpret_cast<int*>(s.dg + K);
  s.lst = s.ix + K;
  return s;
}

// This block's slice of r = b - cols' coef over the occupied slots in slot
// order, slot 0 standing in when none is (its column is zero, so a NaN row
// stays NaN, as the all-slot sum of the plain version leaves it). Every
// thread calls it after a barrier that follows the last write of coef and
// idx; it starts with live_slots and a barrier. Returns this thread's share
// of ||r||^2 over the slice.
template <bool kStaged>
__device__ __forceinline__ float del_residual(const DelSmem& s,
                                              const float* colsb,
                                              float* rb, int n, int m,
                                              int K, int S, int p0, int L) {
  int nl = live_slots(s.ix, K, m, K, s.lst);
  if (nl == 0) {
    if (threadIdx.x == 0) s.lst[0] = 0;
    nl = 1;
  }
  __syncthreads();
  float rr = 0.f;
  for (int i = threadIdx.x; i < L; i += kAppendThreads) {
    float accr = 0.f;
    for (int e = 0; e < nl; ++e) {
      const int q_ = s.lst[e];
      const float c = kStaged ? s.cs[q_ * S + i] : colsb[(size_t)q_ * n + p0 + i];
      accr += c * s.cf[q_];
    }
    const float ri = s.bs[i] - accr;
    rb[p0 + i] = ri;
    rr += ri * ri;
  }
  return rr;
}

// Ginv (each block a share of its rows); rank 0 coef, idx and Atb. After
// the cluster barrier's wait (C > 1), so that every block of the row has
// read the state.
__device__ __forceinline__ void del_store_state(const DelSmem& s, float* Gb,
                                                float* coefb, int* idxb,
                                                float* atbb, int K, int C,
                                                int rank) {
  constexpr int nw = kAppendThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = (K + C - 1) / C;
  const int r1 = min(K, (rank + 1) * rows);
  for (int r_ = min(K, rank * rows) + warp; r_ < r1; r_ += nw) {
    for (int c = lane; c < K; c += 32) Gb[r_ * K + c] = s.Gs[r_ * K + c];
  }
  if (rank == 0 && threadIdx.x < K) {
    coefb[threadIdx.x] = s.cf[threadIdx.x];
    idxb[threadIdx.x] = s.ix[threadIdx.x];
    atbb[threadIdx.x] = s.atb[threadIdx.x];
  }
}

// SRR's backward stage of one row (engine_delete.cu), run by every thread
// of every block of the row's cluster: the whole state staged at entry
// (Ginv, coef, Atb, idx, this block's slices of b and of all K slot
// columns, a free one being zero), then up to l deletions while nactive > k
// and dmin < inf (cluster_deletions), a zero term in each pending slot
// 1 + j that no deletion filled, coef = Ginv Atb where none was made, r,
// and the latch: ||r||^2 from the blocks' shares, sent once to rank 0 and
// added there in rank order; done |= ||r||^2 <= delta2 || prev <= ||r||^2,
// prev = ||r||^2, fgate = !done. A done row zeroes its pending slots 1..l.
template <bool kStaged>
__device__ __forceinline__ void srr_delete_row(const DelArgs& a) {
  constexpr int nw = kAppendThreads / 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[nw];
  __shared__ float rrs[kAppendClusterMax];  // rank 0: the blocks' ||r||^2
  __shared__ uint64_t rfull;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C, tid = threadIdx.x;
  const int n = a.n, m = a.m, K = a.K, S = a.slice, B = a.B, l = a.l;
  const int p0 = min(n, rank * S), L = min(n, p0 + S) - p0;
  const DelSmem s = carve_del_smem<kStaged>(smem, S, K);
  const float* bb = a.Bs + (size_t)b * n;
  float* colsb = a.cols + (size_t)b * K * n;
  float* Gb = a.Ginv + (size_t)b * K * K;

  if (a.done[b] > 0.5f) {
    for (int j = 1; j <= l; ++j) {
      float* vb = a.pend_u + ((size_t)j * B + b) * n + p0;
      for (int i = tid; i < L; i += kAppendThreads) vb[i] = 0.f;
    }
    if (rank == 0) {
      for (int j = 1 + tid; j <= l; j += kAppendThreads) a.pend_w[(size_t)j * B + b] = 0.f;
    }
    return;
  }
  if (C > 1 && rank == 0 && tid == 0) {
    mbar_init(smem_u32(&rfull), C - 1);
    mbar_fence_init();
  }
  // --- the whole state at once: idx by loads, the rest by cp.async -------
  const int ix_r = tid < K ? a.idx[(size_t)b * K + tid] : 0;
  const bool vec = (n & 3) == 0;  // then a row's slices are 16-byte pieces
  append_stage(s.Gs, 0, Gb, 0, 1, K * K, ((K * K) & 3) == 0 && aligned16(Gb));
  append_stage(s.cf, 0, a.coef + (size_t)b * K, 0, 1, K, false);
  append_stage(s.atb, 0, a.Atb + (size_t)b * K, 0, 1, K, false);
  append_stage(s.bs, 0, bb + p0, 0, 1, L, vec && aligned16(bb));
  if (kStaged) {
    append_stage(s.cs, S, colsb + p0, (size_t)n, K, L, vec && aligned16(colsb));
  }
  cp_async_commit();
  if (tid < K) s.ix[tid] = ix_r;
  cp_async_wait_all();
  __syncthreads();
  if (C > 1) cluster_arrive_release();  // this block has read the state

  const DelRow d = {s.Gs, s.cf, s.atb, s.q, s.ix, s.lst, s.cs, colsb,
                    B,    b,    n,     m,   K,    S,     p0,   L,     rank};
  const int k = a.kmin;
  const int nd = cluster_deletions<kStaged, true>(
      d, a, l, [k](float dmin, int nat) { return nat > k && dmin < INFINITY; });
  // a gated-off deletion's term is zero (every later one is gated off too:
  // nactive and the scores do not change)
  for (int j = 1 + nd; j <= l; ++j) {
    float* vb = a.pend_u + ((size_t)j * B + b) * n + p0;
    for (int i = tid; i < L; i += kAppendThreads) vb[i] = 0.f;
    if (rank == 0 && tid == 0) a.pend_w[(size_t)j * B + b] = 0.f;
  }
  if (nd == 0) {  // the refit; the warps may still be reading the scores
    __syncthreads();
    cluster_matvec(s.Gs, s.atb, s.cf, K, K, K);
    __syncthreads();
  }
  float rr = del_residual<kStaged>(s, colsb, a.r + (size_t)b * n, n, m, K, S,
                                   p0, L);
  rr = block_sum(rr, red_v);

  if (C > 1) cluster_wait_acquire();  // every block has read the state
  del_store_state(s, Gb, a.coef + (size_t)b * K, a.idx + (size_t)b * K,
                  a.Atb + (size_t)b * K, K, C, rank);
  if (rank != 0) {
    if (tid == 0) {
      *cluster.map_shared_rank(&rrs[rank], 0) = rr;
      mbar_arrive_remote(smem_u32(&rfull), 0);
    }
    return;
  }
  if (tid == 0) {
    if (C > 1) mbar_wait_cluster(smem_u32(&rfull), 0);
    float res = rr;
    for (int r_ = 1; r_ < C; ++r_) res += rrs[r_];
    const float pv = a.prev[b];
    const bool latch = res <= a.delta2 || pv <= res;
    if (latch) a.done[b] = 1.f;
    a.prev[b] = res;
    a.fgate[b] = latch ? 0.f : 1.f;
  }
}

// RMP's backward stage of one row and the pass's latch (engine_backward.cu),
// run by every thread of every block of the row's cluster. The rule: with
// kfinal >= 0, nactive > kfinal && dmin < inf; else dmin < delta2. The
// first decision reads coef, idx and Ginv's diagonal alone (3K floats): a
// row whose rule rejects at once writes only its latches and zero weights,
// and neither r nor the state. A row that deletes waits for the rest of
// the state and its slices of b and of the occupied slot columns, deletes
// while the rule accepts (at most K + 1 times, cluster_deletions), zeroes
// the weights of pending slots 1 + nd .. K and writes r and the state.
// Then progressed = acc || nd > 0; done |= !progressed; fgate = progressed;
// acc = 0; ndel = nd. A done row zeroes its weights 1..K and ndel.
template <bool kStaged>
__device__ __forceinline__ void rmp_backward_row(const DelArgs& a) {
  extern __shared__ __align__(16) float smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C, tid = threadIdx.x;
  const int n = a.n, m = a.m, K = a.K, S = a.slice, B = a.B;
  const int p0 = min(n, rank * S), L = min(n, p0 + S) - p0;
  const DelSmem s = carve_del_smem<kStaged>(smem, S, K);
  const float* bb = a.Bs + (size_t)b * n;
  float* colsb = a.cols + (size_t)b * K * n;
  float* Gb = a.Ginv + (size_t)b * K * K;

  if (a.done[b] > 0.5f) {
    if (rank == 0) {
      for (int e = 1 + tid; e <= K; e += kAppendThreads) a.pend_w[(size_t)e * B + b] = 0.f;
      if (tid == 0) a.ndel[b] = 0.f;
    }
    return;
  }
  // --- the first decision's loads, then the rest of the state's copies,
  // which land while it is made ---------------------------------------------
  float cf_r = 0.f, dg_r = 0.f;
  int ix_r = 0;
  if (tid < K) {
    cf_r = a.coef[(size_t)b * K + tid];
    ix_r = a.idx[(size_t)b * K + tid];
    dg_r = Gb[(size_t)tid * (K + 1)];
  }
  const bool vec = (n & 3) == 0;
  append_stage(s.Gs, 0, Gb, 0, 1, K * K, ((K * K) & 3) == 0 && aligned16(Gb));
  append_stage(s.atb, 0, a.Atb + (size_t)b * K, 0, 1, K, false);
  append_stage(s.bs, 0, bb + p0, 0, 1, L, vec && aligned16(bb));
  cp_async_commit();
  if (tid < K) {
    s.cf[tid] = cf_r;
    s.ix[tid] = ix_r;
    s.dg[tid] = dg_r;
  }
  __syncthreads();
  const float thr = a.delta2;
  const int kfinal = a.kmin;
  const auto accept = [thr, kfinal](float dmin, int nat) {
    return kfinal >= 0 ? (nat > kfinal && dmin < INFINITY) : (dmin < thr);
  };
  // rank 0: the weights of the pending slots past the nd deletions, and
  // the pass's latch
  const auto finish = [&](int nd) {
    if (rank != 0) return;
    for (int e = 1 + nd + tid; e <= K; e += kAppendThreads) a.pend_w[(size_t)e * B + b] = 0.f;
    if (tid == 0) {
      const bool progressed = a.acc[b] > 0.5f || nd > 0;
      if (!progressed) a.done[b] = 1.f;
      a.fgate[b] = progressed ? 1.f : 0.f;
      a.acc[b] = 0.f;
      a.ndel[b] = (float)nd;
    }
  };
  float dmin;
  int p, nat;
  deletion_score<true>(s.cf, s.dg, 0, s.ix, K, m, dmin, p, nat);
  if (!accept(dmin, nat)) {
    finish(0);
    cp_async_wait_all();
    return;
  }
  // --- a row that deletes: its slices of the occupied slot columns -------
  if (kStaged) {
    stage_occupied(s.cs, colsb, s.ix, K, m, n, p0, L, S, vec && aligned16(colsb));
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();
  if (C > 1) cluster_arrive_release();  // this block has read the state

  const DelRow d = {s.Gs, s.cf, s.atb, s.q, s.ix, s.lst, s.cs, colsb,
                    B,    b,    n,     m,   K,    S,     p0,   L,     rank};
  const int nd = cluster_deletions<kStaged, true>(d, a, K + 1, accept);
  del_residual<kStaged>(s, colsb, a.r + (size_t)b * n, n, m, K, S, p0, L);

  if (C > 1) cluster_wait_acquire();  // every block has read the state
  del_store_state(s, Gb, a.coef + (size_t)b * K, a.idx + (size_t)b * K,
                  a.Atb + (size_t)b * K, K, C, rank);
  finish(nd);
}

}  // namespace cstpu
