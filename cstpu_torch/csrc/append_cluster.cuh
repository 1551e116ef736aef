// The insertion-order append of OMP and FR (omp_append.cu, fr_append.cu) as
// a thread-block cluster per row over staged slot columns.
//
// One launch is one step t: the row's select partials give the pick sel,
// slot t takes it (the slot equals the step, slots > t are still zero),
// and the gated bordered append of cstpu/ops/fused_solve.py (:165-201,
// :587-611; plain twin cstpu_torch/ops/fused_solve.py::
// _bordered_append_ref) runs with the cross terms over slots < t, then
// the residual (and FR's aperp); what differs is where it runs.
//
// What bounds it on an H100: latency. A step moves a few hundred KB at
// B = 64 (the row's t live slot columns, one dictionary column gathered at
// a 32-byte sector an entry, strided by m) and does O(t n) flops; a block
// per row left half the card idle at B = 64 (64 of 132 SMs) and most of it
// at B = 8, read the slot columns from device memory two or three times a
// step, and walked the gate in one thread. Design:
//   cluster  C blocks per row (AppendPlan: C from B, n and k alone, so
//            that B C fills the 132 SMs); block `rank` owns entries p0 ..
//            p0+L-1 of n (slices of `slice` entries, a multiple of 4, the
//            last one ragged or empty);
//   stage    at entry every block loads the row's select partials (the
//            pick heads the critical path), then starts 16-byte cp.async
//            copies (4-byte ones when n or Ginv's row is not a multiple of 4
//            floats) of Ginv, of its slices of b and (FR) r and, in the
//            staged instantiation, of its slices of the live slot columns
//            (slots < t) into shared memory, so that no global load is left
//            on the path after the gather (at 5b the select's sweep of the
//            dictionary has pushed b out of the L2). They land while the
//            block reduces the pick and gathers its slice of A[:, min(sel,
//            m-1)] (the INT_MAX rule of common.cuh unchanged), four loads a
//            thread at once. Where (k-1) slices do not fit beside Ginv, the
//            plan takes the streamed instantiation, which reads the slot
//            columns from device memory where it uses them;
//   partials each block's share of g (slots < t), ata, beta (and FR's
//            ||r||^2 from r before the step), four products a warp at once;
//   combine  each block sends its partials to the other C-1 blocks' shared
//            memory (distributed shared memory), each lane its entries and
//            then an arrive that releases them on the receiver's mbarrier,
//            and waits on its own for theirs: one-way latency, no cluster
//            barrier on the path (the one that tells the blocks their
//            barriers are set up is arrived at on entry and waited on before
//            the sends). Every block adds the C partials in rank order, so
//            every block holds the same bits and computes u = Ginv g, the
//            gate (a warp reduction in every warp, no block barrier), dinv
//            and the coefficient step alike;
//   write    every block writes a share of Ginv's rows and its slice of
//            cols[t], of r = b - sum_{s<=t} cols[s] coef[s] and (FR) of
//            aperp = acol - sum_{s<=t} cols[s] u[s], the sums over the live
//            slots only, in slot order. On a finite state a dead slot's
//            term is 0 * 0 (its column is zero, and its coef and u stay 0),
//            so the sums are today's term for term; a NaN row has NaN in
//            every coefficient (or every u) from its first NaN step, slot 0
//            included, so both give NaN throughout. Rank 0 alone writes
//            coef and idx (FR: dinv, done, amask; OMP's last step: the rank
//            sort).
// No block reads another's shared memory, and a block leaves only once all
// the others' partials have landed in its own, so a block may leave before
// the rest. Every block reads Ginv, coef, idx (and FR's done and its slice
// of r) before it sends, and writes them only after it has received, which
// is after every other block has sent.
#pragma once

#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cstpu {

namespace cg = cooperative_groups;

constexpr int kAppendThreads = 256;
constexpr int kAppendClusterMax = 8;  // the portable cluster size
constexpr int kAppendMinSlice = 64;   // fewest entries of n a block owns
// dynamic shared memory a block may take: sm_90's 227 KB, less room for
// the kernels' static shared memory
constexpr size_t kAppendSmemBudget = 232448 - 256;

// A step's launch: C blocks per row, entries of n per block (a multiple of
// 4), whether the slot columns are staged, and the dynamic shared memory.
struct AppendPlan {
  int C;
  int slice;
  int staged;
  size_t smem;
};

// Shared memory of one block: the staged slot slices (k - 1 of them,
// staged only), Ginv (k k, padded to 16 bytes), the slices of the gathered
// column, b and r, g, u, the coefficients before and after the step, the
// cluster's partials (k + 4 a block), idx.
__host__ __device__ constexpr size_t append_cluster_smem(int slice, int k,
                                                         bool staged) {
  return ((staged ? (size_t)(k - 1) * slice : 0) +
          (((size_t)k * k + 3) & ~(size_t)3) + 3 * (size_t)slice +
          4 * (size_t)k +
          (size_t)kAppendClusterMax * (k + 4) + k) *
         sizeof(float);
}

// Entries of n a block of a C-block cluster owns: a multiple of 4, the
// last block the rest (ragged or empty).
__host__ __device__ constexpr int cluster_slice(int n, int C) {
  return ((n + C - 1) / C + 3) & ~3;
}

// The cluster size of the plans for B rows of length n: C = min(8, 132 /
// B, ceil(n / 64)), so that B C fills the 132 SMs, at least 1, raised while
// fits(C) is false (the least a block needs does not fit); at most
// kAppendClusterMax.
template <typename Fits>
inline int cluster_size(int B, int n, Fits fits) {
  const int by_sms = kSMs / (B > 0 ? B : 1);
  const int by_n = (n + kAppendMinSlice - 1) / kAppendMinSlice;
  int C = by_sms < kAppendClusterMax ? by_sms : kAppendClusterMax;
  C = C < by_n ? C : by_n;
  C = C > 1 ? C : 1;
  while (C < kAppendClusterMax && !fits(C)) ++C;
  return C;
}

// The plan, from (B, n, k) alone; defined in omp_append.cu. `ok` is false
// when no cluster size up to kAppendClusterMax fits the streamed variant.
AppendPlan append_plan(int B, int n, int k, bool* ok);

// What one step reads and writes; the pointers are the whole batch's.
struct AppendArgs {
  const float* pval;
  const int* pidx;
  const void* A;
  const float* Bs;
  float* cols;
  float* Ginv;
  float* coef;
  int* idx;
  float* r;
  int* out_idx;    // OMP: the sorted support at t = k - 1
  float* out_coef;
  float* aperp;    // FR
  float* dinv;
  uint8_t* amask;
  float* done;
  float max_eps2, min_d2, rtol;
  int ntiles, n, m, k, t, slice;
};

// Start copying `rows` rows of `len` floats, src rows `spitch` apart, into
// dst rows `dpitch` apart; 16-byte pieces when `vec` (len, both pitches
// and both bases multiples of 4 floats), else 4-byte ones.
__device__ __forceinline__ void append_stage(float* dst, int dpitch,
                                             const float* src, size_t spitch,
                                             int rows, int len, bool vec) {
  if (vec) {
    const int per = len >> 2;
    for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
      const int q = e / per, i = (e - q * per) << 2;
      cp_async16(dst + q * dpitch + i, src + q * spitch + i);
    }
  } else {
    for (int e = threadIdx.x; e < rows * len; e += blockDim.x) {
      const int q = e / len, i = e - q * len;
      cp_async4(dst + q * dpitch + i, src + q * spitch + i);
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One step t of one row, run by every thread of every block of the row's
// cluster. kFr adds FR's stopping rules, latch, aperp and dinv; without it
// the last step writes the sorted support.
template <typename T, bool kStaged, bool kFr>
__device__ __forceinline__ void append_cluster_row(const AppendArgs& a) {
  constexpr int nw = kAppendThreads / 32;
  constexpr int kIlp = 4;  // independent loads, products or rows at once
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[nw];
  __shared__ int red_i[nw];
  __shared__ float sc[3];  // ata, beta, ||r||^2 of the row
  __shared__ uint64_t full;  // the other blocks' partials have landed

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = a.n, m = a.m, k = a.k, t = a.t, S = a.slice;
  const int p0 = min(n, rank * S), L = min(n, p0 + S) - p0;
  const int KP = k + 4;  // a block's partials: g (k), ata, beta, ||r||^2
  const int nx = kFr ? 3 : 2;

  float* cs = smem;  // slot s < t at cs[s * S], staged only
  float* Gs = cs + (kStaged ? (k - 1) * S : 0);
  float* acol = Gs + ((k * k + 3) & ~3);  // 16-byte aligned, as are bs, rs
  float* bs = acol + S;  // this block's slice of b
  float* rs = bs + S;    // ... and (FR) of r before the step
  float* g = rs + S;
  float* u = g + k;
  float* cn = u + k;  // the coefficients after the step
  float* cf = cn + k;  // ... and before it
  float* part = cf + k;  // block r's partials at part[r * KP]
  int* ix = reinterpret_cast<int*>(part + kAppendClusterMax * KP);

  const float* bb = a.Bs + (size_t)b * n;
  float* colsb = a.cols + (size_t)b * k * n;
  float* Gb = a.Ginv + (size_t)b * k * k;
  float* rb = a.r + (size_t)b * n;
  const T* A = static_cast<const T*>(a.A);

  // the barrier the other blocks arrive on with their partials; they
  // learn that it is set up at the cluster barrier before they send
  if (C > 1) {
    if (tid == 0) {
      mbar_init(smem_u32(&full), (C - 1) * 32);
      mbar_fence_init();
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  // --- the select partials first (the pick heads the critical path), then
  // the staging of Ginv, the slices of b, r (FR) and (kStaged) the live slot
  // columns, all in flight together; they land while the pick is reduced
  // and the column gathered
  float vmax = -INFINITY;
  int sel = INT_MAX;
  {
    const float* pvb = a.pval + (size_t)b * a.ntiles;
    const int* pib = a.pidx + (size_t)b * a.ntiles;
    for (int e0 = tid; e0 < a.ntiles; e0 += kIlp * kAppendThreads) {
      float pv[kIlp];
      int pi[kIlp];
#pragma unroll
      for (int j = 0; j < kIlp; ++j) {
        const int e = e0 + j * kAppendThreads;
        pv[j] = e < a.ntiles ? pvb[e] : -INFINITY;
        pi[j] = e < a.ntiles ? pib[e] : INT_MAX;
      }
#pragma unroll
      for (int j = 0; j < kIlp; ++j) argmax_combine(vmax, sel, pv[j], pi[j]);
    }
  }
  append_stage(Gs, 0, Gb, 0, 1, k * k, ((k * k) & 3) == 0 && aligned16(Gb));
  const bool vec = (n & 3) == 0;  // then a row's slices are 16-byte pieces
  append_stage(bs, 0, bb + p0, 0, 1, L, vec && aligned16(bb));
  if (kFr) append_stage(rs, 0, rb + p0, 0, 1, L, vec && aligned16(rb));
  if (kStaged) {
    append_stage(cs, S, colsb + p0, (size_t)n, t, L, vec && aligned16(colsb));
  }
  cp_async_commit();
  const float cf_r = tid < k ? a.coef[(size_t)b * k + tid] : 0.f;
  const int ix_r = tid < k ? a.idx[(size_t)b * k + tid] : 0;
  const bool latched = kFr && a.done[b] > 0.5f;
  // the row's (max, lowest argmax) with argmax_combine's rule, which no
  // order of combining changes
  warp_argmax(vmax, sel);
  if (lane == 0) {
    red_v[warp] = vmax;
    red_i[warp] = sel;
  }
  if (tid < k) {
    cf[tid] = cf_r;
    ix[tid] = ix_r;
  }
  __syncthreads();
  vmax = red_v[0];
  sel = red_i[0];
  for (int w = 1; w < nw; ++w) argmax_combine(vmax, sel, red_v[w], red_i[w]);

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

  // --- this block's partials: g_s = cols[s] . acol (s < t), ata, beta and
  // (FR) ||r||^2 (r before the step), kIlp products a warp at once --------
  const int nprod = t + nx;
  float* mine = part + rank * KP;
  for (int q0 = warp; q0 < nprod; q0 += kIlp * nw) {
    const float* x[kIlp];
    const float* y[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const int q = min(q0 + j * nw, nprod - 1);  // past the end: a repeat
      x[j] = q < t ? (kStaged ? cs + q * S : colsb + (size_t)q * n + p0)
                   : (q == t + 2 ? rs : acol);
      y[j] = q <= t ? acol : (q == t + 1 ? bs : rs);
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
        const int q = q0 + j * nw;
        if (q < nprod) mine[q < t ? q : k + (q - t)] = acc[j];
      }
    }
  }
  __syncthreads();

  // --- send them to the other blocks: warp w to block rank + 1 + w (mod C),
  // each lane its entries, then an arrive on that block's barrier that
  // releases them; then wait for the other blocks' --------------------------
  if (C > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (warp < C - 1) {
      const int d = (rank + 1 + warp) % C;
      float* dst = cluster.map_shared_rank(mine, d);
      for (int q = lane; q < t; q += 32) dst[q] = mine[q];
      if (lane < nx) dst[k + lane] = mine[k + lane];
      mbar_arrive_remote(smem_u32(&full), d);
    }
    mbar_wait_cluster(smem_u32(&full), 0);
  }

  // --- the row's sums, in rank order, alike in every block ----------------
  {
    // thread q < t sums g_q, threads k, k+1 (and k+2) ata, beta (and rr);
    // g is 0 beyond the live slots
    const bool live = tid < t || (tid >= k && tid < k + nx);
    float s = 0.f;
    if (live) {
      s = part[tid];
      for (int r_ = 1; r_ < C; ++r_) s += part[r_ * KP + tid];
    }
    if (tid < k) g[tid] = s;
    else if (live) sc[tid - k] = s;
  }
  __syncthreads();

  // u = Ginv g, kIlp rows a warp at once
  for (int r0 = warp; r0 < k; r0 += kIlp * nw) {
    float acc[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) acc[j] = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float gc_ = g[c];
#pragma unroll
      for (int j = 0; j < kIlp; ++j) {
        acc[j] += Gs[min(r0 + j * nw, k - 1) * k + c] * gc_;
      }
    }
#pragma unroll
    for (int j = 0; j < kIlp; ++j) acc[j] = warp_sum(acc[j]);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kIlp; ++j) {
        if (r0 + j * nw < k) u[r0 + j * nw] = acc[j];
      }
    }
  }
  __syncthreads();

  // --- the gate, in every warp alike --------------------------------------
  float gu = 0.f, gc = 0.f;
  bool dup = false;
  for (int c = lane; c < k; c += 32) {
    gu += g[c] * u[c];
    gc += g[c] * cf[c];
    dup |= ix[c] == sel;
  }
  gu = warp_allsum(gu);
  gc = warp_allsum(gc);
  dup = __any_sync(0xffffffffu, dup);
  const float ata = sc[0], beta = sc[1];
  const bool pre = kFr ? (sc[2] > a.max_eps2 && vmax > a.min_d2 && !latched)
                       : true;
  const float d = ata - gu;
  const bool ok = pre && !dup && (d > a.rtol * ata);
  const float okf = ok ? 1.f : 0.f;
  const float dinv = okf / (d > 0.f ? d : 1.f);
  const float step = dinv * (beta - gc);

  // --- Ginv (each block a share of its rows), the coefficients, the new
  // column ----------------------------------------------------------------
  {
    const int rows = (k + C - 1) / C;
    const int e1 = min(k, (rank + 1) * rows) * k;
    for (int e = min(k, rank * rows) * k + tid; e < e1; e += kAppendThreads) {
      const int r_ = e / k, c = e - r_ * k;
      const float wa = u[r_] - (r_ == t ? 1.f : 0.f);
      const float wc = u[c] - (c == t ? 1.f : 0.f);
      Gb[e] = Gs[e] + dinv * wa * wc - ((r_ == t && c == t) ? okf : 0.f);
    }
  }
  if (tid < k) cn[tid] = cf[tid] - step * (u[tid] - (tid == t ? 1.f : 0.f));
  for (int i = tid; i < L; i += kAppendThreads) {
    colsb[(size_t)t * n + p0 + i] = acol[i] * okf;
  }
  __syncthreads();

  // --- r (and aperp) on this block's slice, over the live slots ----------
  float* ab = kFr ? a.aperp + (size_t)b * n : nullptr;
  for (int i = tid; i < L; i += kAppendThreads) {
    float acc = 0.f, accp = 0.f;
    for (int s = 0; s < t; ++s) {
      const float c = kStaged ? cs[s * S + i] : colsb[(size_t)s * n + p0 + i];
      acc += c * cn[s];
      if (kFr) accp += c * u[s];
    }
    const float c = acol[i] * okf;
    acc += c * cn[t];
    rb[p0 + i] = bs[i] - acc;
    if (kFr) {
      accp += c * u[t];
      ab[p0 + i] = acol[i] - accp;
    }
  }

  // --- rank 0: the row's state --------------------------------------------
  if (rank == 0) {
    if (tid < k) {
      a.coef[(size_t)b * k + tid] = cn[tid];
      if (tid == t && ok) {
        a.idx[(size_t)b * k + tid] = sel;
        ix[tid] = sel;
      }
    }
    if (kFr) {
      if (tid == 0) {
        a.dinv[b] = dinv;
        if (!ok) a.done[b] = 1.f;
        else if (sel < m) a.amask[(size_t)b * m + sel] = 1;
      }
    } else if (t == k - 1) {
      // the support sorted by atom index, pads (idx m) last, ties by slot
      __syncthreads();
      if (tid < k) {
        const int key = ix[tid];
        int pos = 0;
        for (int c = 0; c < k; ++c) {
          const int kc = ix[c];
          pos += (kc < key) || (kc == key && c < tid);
        }
        a.out_idx[(size_t)b * k + pos] = key;
        a.out_coef[(size_t)b * k + pos] = cn[tid];
      }
    }
  }
}

// Launch kernel (one of the two instantiations of `p`) for B rows as
// clusters of p.C blocks, with its one argument `args` (AppendArgs here,
// engine_cluster.cuh's for the slot engine). Returns the launch's
// cudaError_t, a refused cluster launch included.
template <typename K, typename Args>
cudaError_t launch_append_cluster(K* kernel, const AppendPlan& p, int B,
                                  const Args& args, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err == cudaSuccess) err = prefer_l1(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.C);
  cfg.blockDim = dim3(kAppendThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace cstpu
