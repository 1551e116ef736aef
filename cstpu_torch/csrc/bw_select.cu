// Batched backward elimination (FBR, LACE), stage 1 of a deletion step:
// the selection, the accept test and the per-row vector updates.
//
// Replaces, with bw_downdate.cu, the body of
// cstpu/ops/fused_backward.py::_bw_kernel (:79-146). The TPU kernel keeps
// one instance's (m, m) Gram inverse in VMEM and runs all deletions in one
// program; a block's shared memory cannot hold it (4 MB at m = 1024), so
// the private inverses G (B, m, m) stay in device memory and a deletion
// step is two launches. This one decides and stages; bw_downdate.cu then
// sweeps the matrix. The downdate G -= gcol (g ginvs) reads row p and
// column p of the matrix it overwrites, so both are staged here, from the
// matrix as it was, into g and gcol (B, m): the stream orders the two
// launches, no block of the downdate reads what another writes. Per row
// that is still running:
//   d2_j  = alive_j ? coef_j^2 / diag_j : inf
//   sel   = d2 (FBR) or alive_j ? |coef_j| : inf (LACE)
//   p     = lowest argmin of sel; a NaN minimum selects nothing (p = INT_MAX)
//   valid = p < m;  d2p = valid ? d2_p : 0
//   fail  = !(d2p + nr2 >= 0) || !valid     (a negated >=, so NaN latches)
//   acc   = valid && !fail && max(nr2 + d2p, 0) < max_eps2 && d2p < max_delta2
//   ginvs = acc / (G_pp != 0 ? G_pp : 1)    (0 when rejected: a no-op step)
//   g = G[min(p, m-1), :],  gcol = G[:, min(p, m-1)]   (row and column read
//       separately, as the TPU kernel reads them; only the init is
//       symmetrised)
//   coef = (coef - g (coef_p ginvs)) (1 - acc e_p)
//   diag = (diag - g g ginvs) (1 - acc e_p) + acc e_p
//   alive = alive (1 - acc e_p);  nr2 = acc ? max(nr2 + d2p, 0) : nr2
//   failed |= fail;  run = acc
// G_pp = diag_p (diag is kept equal to it), coef_p and d2_p are read at p
// (the TPU kernel's one-hot sums give the same values on a finite state).
// Every product and sum is rounded on its own (__fmul_rn, __fsub_rn,
// __fadd_rn, __fdiv_rn), as the plain version's separate tensor operations
// round them, so that the two decide alike. True f32 throughout.
//
// What bounds it on an H100: latency. The bytes are a few of O(m) a row
// (the strided column read of G moves a 32-byte sector an element); the
// work is a dependent chain: an argmin over m atoms, one decision, then
// the row and column reads at p; a block per row would leave 124 of the
// 132 SMs idle at B = 8 and run each phase at one block's rate. Design: a
// thread-block cluster of C = min(8, ceil(m / 128)) blocks
// per row (8 is the portable cluster size), each block a contiguous slice
// of ceil(m / C) atoms with 128 threads (one atom a thread at m = 1024):
//   phase 1  up to m = 1024 (a slice of at most 128 atoms) each thread
//            loads its atom's coef, diag and alive into registers once, in
//            the same round of loads as the latch and nr2, for both
//            phases; beyond, a thread walks its atoms and phase 2 reads
//            them again. Each warp reduces to its (-sel max, index) with
//            the NaN-absorbing rule, the winner's coef, diag and alive
//            carried with it, so no block reads another's slice while that
//            block rewrites it;
//   cluster barrier 1; every warp of every block reads the 4C warp
//            partials of the row through distributed shared memory (a lane
//            each) and combines them by a butterfly (the rule is
//            order-independent, so all get the same p), and every thread
//            makes the accept decision; rank 0's thread 0 alone writes
//            nr2, run, failed and sc. No block barrier anywhere;
//   phase 2  each block stages its slice of row p and column p and updates
//            its slice of coef, diag and alive from the registers; the
//            second cluster barrier is split (a warp arrives once it has
//            read the partials, the block waits before it exits), so no
//            block leaves while another may still read its partials.
// The latch run[b] and nr2[b] are read by every thread before it arrives
// at barrier 1, and rank 0 writes them only after barrier 1, so every
// block sees the values the launch started with. A stopped row returns
// from all C blocks before any barrier.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace cstpu {

constexpr int kBwThreads = 128;  // threads of a block: one atom each at m = 1024
constexpr int kBwClusterMax = 8; // the portable cluster size

// Blocks of a row's cluster: the plan, from m alone.
inline int bw_cluster_size(int m) {
  const int c = (m + kBwThreads - 1) / kBwThreads;
  return c < kBwClusterMax ? c : kBwClusterMax;
}

// A candidate of the lowest argmin of sel, as the argmax of v = -sel, with
// the atom's state carried along.
struct BwPart {
  float v;
  int i;
  float c, d, a;
};

// argmax_combine's rule (NaN absorbing, lowest index on ties) on BwParts.
__device__ __forceinline__ void bw_combine(BwPart& x, const BwPart& y) {
  if (isnan(x.v) || isnan(y.v)) {
    x.v = __int_as_float(0x7fc00000);
    x.i = INT_MAX;
  } else if (y.v > x.v || (y.v == x.v && y.i < x.i)) {
    x = y;
  }
}

// bw_combine over the 32 lanes of a warp, as a butterfly: the rule is
// commutative and associative, so every lane ends with the same result.
__device__ __forceinline__ void bw_warp_combine(BwPart& x) {
  for (int off = 16; off > 0; off >>= 1) {
    BwPart y;
    y.v = __shfl_xor_sync(0xffffffffu, x.v, off);
    y.i = __shfl_xor_sync(0xffffffffu, x.i, off);
    y.c = __shfl_xor_sync(0xffffffffu, x.c, off);
    y.d = __shfl_xor_sync(0xffffffffu, x.d, off);
    y.a = __shfl_xor_sync(0xffffffffu, x.a, off);
    bw_combine(x, y);
  }
}

// kHeld: a slice of at most kBwThreads atoms, each thread's held in
// registers across both phases; else each thread walks its atoms (stride
// kBwThreads) and reads them again in phase 2.
template <bool kHeld>
__global__ void __launch_bounds__(kBwThreads)
bw_select_kernel(const float* __restrict__ G, float* __restrict__ coef,
                 float* __restrict__ diag, float* __restrict__ alive,
                 float* __restrict__ nr2, float* __restrict__ run,
                 float* __restrict__ failed, float* __restrict__ g,
                 float* __restrict__ gcol, float* __restrict__ sc, int m,
                 float max_eps2, float max_delta2, int select_abs) {
  // the slice's partials, one a warp, read by the whole cluster
  __shared__ BwPart part[kBwThreads / 32];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int slice = (m + C - 1) / C;
  const int j0 = rank * slice, j1 = min(m, j0 + slice);
  const float* Gb = G + (size_t)b * m * m;
  float* cb = coef + (size_t)b * m;
  float* db = diag + (size_t)b * m;
  float* ab = alive + (size_t)b * m;

  // the latch, ||r||^2 and (kHeld) the thread's atom in one round of loads
  const float runb = run[b], old = nr2[b];
  float ch = 0.f, dh = 0.f, ah = 0.f;
  if (kHeld && j0 + tid < j1) {
    ch = cb[j0 + tid];
    dh = db[j0 + tid];
    ah = ab[j0 + tid];
  }
  if (runb < 0.5f) {
    if (rank == 0 && tid == 0) sc[2 * b + 1] = 0.f;
    return;
  }

  // --- phase 1: the slice's lowest argmin of sel --------------------------
  BwPart best{-INFINITY, INT_MAX, 0.f, 0.f, 0.f};
  for (int j = j0 + tid; j < j1; j += kBwThreads) {  // once when kHeld
    const float c = kHeld ? ch : cb[j], d = kHeld ? dh : db[j];
    const float a = kHeld ? ah : ab[j];
    float sel = INFINITY;
    if (a > 0.f) sel = select_abs ? fabsf(c) : __fdiv_rn(__fmul_rn(c, c), d);
    bw_combine(best, BwPart{-sel, j, c, d, a});
  }
  bw_warp_combine(best);
  if (lane == 0) part[warp] = best;
  cluster.sync();

  // --- the row's argmin and the decision, in every warp: lane l reads
  // partial l % 4 of rank l / 4 through distributed shared memory, a
  // butterfly combines them (the rule is order-independent, so every warp
  // of every block gets the same p), and every thread decides alike ------
  BwPart tot{-INFINITY, INT_MAX, 0.f, 0.f, 0.f};
  constexpr int wpb = kBwThreads / 32;
  if (lane < wpb * C) tot = *cluster.map_shared_rank(&part[lane % wpb], lane / wpb);
  bw_warp_combine(tot);
  cluster_arrive_release();  // this warp's reads of the partials are done
  const int p = tot.i;
  const bool valid = p < m;
  float d2p = 0.f, gpp = 0.f, coefp = 0.f;
  if (valid) {
    coefp = tot.c;
    gpp = tot.d;
    d2p = tot.a > 0.f ? __fdiv_rn(__fmul_rn(coefp, coefp), gpp) : INFINITY;
  }
  const float sum = __fadd_rn(d2p, old);
  const bool fail = !(sum >= 0.f) || !valid;
  const float newnr2 = max_keep_nan(sum, 0.f);
  const bool acc = valid && !fail && newnr2 < max_eps2 && d2p < max_delta2;
  const float accf = acc ? 1.f : 0.f;
  const float ginvs = __fdiv_rn(accf, gpp != 0.f ? gpp : 1.f);
  const float cgp = __fmul_rn(coefp, ginvs);
  if (rank == 0 && tid == 0) {
    if (fail) failed[b] = 1.f;
    if (acc) nr2[b] = newnr2;
    run[b] = accf;
    sc[2 * b] = ginvs;
    sc[2 * b + 1] = 1.f;
  }

  // --- phase 2: stage row p and column p, update the slice ----------------
  const int pc = min(p, m - 1);
  float* gb = g + (size_t)b * m;
  float* gcb = gcol + (size_t)b * m;
  for (int j = j0 + tid; j < j1; j += kBwThreads) {  // once when kHeld
    const float c = kHeld ? ch : cb[j], d = kHeld ? dh : db[j];
    const float a = kHeld ? ah : ab[j];
    const float gj = Gb[(size_t)pc * m + j];
    gb[j] = gj;
    gcb[j] = Gb[(size_t)j * m + pc];
    const float hit = j == p ? accf : 0.f;  // acc e_p
    const float keep = __fsub_rn(1.f, hit);
    cb[j] = __fmul_rn(__fsub_rn(c, __fmul_rn(gj, cgp)), keep);
    db[j] = __fadd_rn(
        __fmul_rn(__fsub_rn(d, __fmul_rn(__fmul_rn(gj, gj), ginvs)), keep),
        hit);
    ab[j] = __fmul_rn(a, keep);
  }
  cluster_wait_acquire();  // no block leaves while its partial may be read
}

template <bool kHeld>
cudaError_t launch_bw_select(const float* G, float* coef, float* diag,
                             float* alive, float* nr2, float* run,
                             float* failed, float* g, float* gcol, float* sc,
                             int B, int m, int C, float max_eps2,
                             float max_delta2, int select_abs,
                             cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kBwThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, bw_select_kernel<kHeld>, G, coef, diag, alive, nr2, run, failed, g,
      gcol, sc, m, max_eps2, max_delta2, select_abs);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace cstpu

// The selection of one deletion step for all B rows. G (B, m, m) f32 read;
// coef, diag, alive (B, m) f32 and nr2, run, failed (B,) f32 updated in
// place; g, gcol (B, m) f32 and sc (B, 2) f32 = (ginvs, stepped) written for
// cstpu_bw_downdate. select_abs != 0 is LACE's rule. All contiguous,
// m >= 1. One cluster of min(8, ceil(m / 128)) blocks per row.
// Returns the launch's cudaError_t (a refused cluster launch included).
extern "C" int cstpu_bw_select(const float* G, float* coef, float* diag,
                               float* alive, float* nr2, float* run,
                               float* failed, float* g, float* gcol, float* sc,
                               int B, int m, float max_eps2, float max_delta2,
                               int select_abs, void* stream) {
  using namespace cstpu;
  if (B < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int C = bw_cluster_size(m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (m + C - 1) / C <= kBwThreads
          ? launch_bw_select<true>(G, coef, diag, alive, nr2, run, failed, g,
                                   gcol, sc, B, m, C, max_eps2, max_delta2,
                                   select_abs, st)
          : launch_bw_select<false>(G, coef, diag, alive, nr2, run, failed, g,
                                    gcol, sc, B, m, C, max_eps2, max_delta2,
                                    select_abs, st);
  return static_cast<int>(err);
}
