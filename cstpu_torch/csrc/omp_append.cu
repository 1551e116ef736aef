// Batched OMP, stages 2 and 3: append the selected atom, refit, update the
// residual, and at the last step emit the support sorted by atom index.
//
// Replaces the append and epilogue of cstpu/ops/fused_solve.py::
// _solve_kernel (:165-234) and the sweep-end append of ::_stream_kernel
// (:387-421). One launch is one OMP step t; slot t is written (no
// deletions), so the slot equals the step.
//
// Per row b, with state in device memory (cols (B,k,n), Ginv (B,k,k),
// coef (B,k), idx (B,k), r (B,n)):
//   i     = argmax over the select kernel's (B, T) partials, lowest index on
//           ties, INT_MAX when the row's maximum is NaN (common.cuh)
//   the gated bordered append of i into slot t (the math of :165-201,
//   plain twin cstpu_torch/ops/fused_solve.py::_bordered_append_ref:
//   cdt-rounded column, dup/degeneracy gate, Ginv, coef, idx, cols), then
//   r = b - cols'coef
//   at t = k-1: rank sort of (idx, coef), pads (idx m) last, ties by slot
// All of it in f32, with _degeneracy_rtol(n) in f32 whatever the cdt.
//
// What bounds it on an H100, and the design: append_cluster.cuh (a
// thread-block cluster per row, the live slot columns staged once in
// shared memory, the partials added across the cluster through distributed
// shared memory). The column is gathered from A directly, strided by m; the
// TPU kernel's aligned 8-row gather from a transposed copy (:99-124,
// :244-245) is a TPU workaround not carried over. This file also holds the
// launch plan that fr_append.cu shares.
#include "append_cluster.cuh"

namespace cstpu {

AppendPlan append_plan(int B, int n, int k, bool* ok) {
  // a block of one row must hold at least the streamed variant's state
  const int C = cluster_size(B, n, [&](int c) {
    return append_cluster_smem(cluster_slice(n, c), k, false) <= kAppendSmemBudget;
  });
  const int S = cluster_slice(n, C);
  *ok = append_cluster_smem(S, k, false) <= kAppendSmemBudget;
  const bool staged = append_cluster_smem(S, k, true) <= kAppendSmemBudget;
  return AppendPlan{C, S, staged ? 1 : 0, append_cluster_smem(S, k, staged)};
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kAppendThreads, 1)
omp_append_kernel(const AppendArgs a) {
  append_cluster_row<T, kStaged, false>(a);
}

}  // namespace cstpu

// The launch plan of omp_append and fr_append for B rows, n, k:
// out = {C, slice, staged, dynamic shared memory bytes}. Returns
// cudaErrorInvalidValue when no plan fits.
extern "C" int cstpu_append_plan(int B, int n, int k, int* out) {
  using namespace cstpu;
  bool ok = false;
  const AppendPlan p = append_plan(B, n, k, &ok);
  out[0] = p.C;
  out[1] = p.slice;
  out[2] = p.staged;
  out[3] = static_cast<int>(p.smem);
  return static_cast<int>(ok ? cudaSuccess : cudaErrorInvalidValue);
}

// One OMP step t for all B rows. pval/pidx (B, ntiles) from
// cstpu_select_argmax; A (n, m) in cdt; Bs (B, n) f32; state cols (B,k,n),
// Ginv (B,k,k), coef (B,k) f32 and idx (B,k) i32 updated in place, r (B,n)
// f32 overwritten; at t = k-1 out_idx/out_coef (B,k) get the sorted
// support. All contiguous. One cluster of the plan's C blocks per row.
// Returns the launch's cudaError_t (a refused cluster launch included).
extern "C" int cstpu_omp_append(const float* pval, const int* pidx,
                                int ntiles, const void* A, int cdt_bf16,
                                const float* Bs, float* cols, float* Ginv,
                                float* coef, int* idx, float* r, int* out_idx,
                                float* out_coef, int B, int n, int m, int k,
                                int t, float rtol, void* stream) {
  using namespace cstpu;
  bool ok = false;
  const AppendPlan p = append_plan(B, n, k, &ok);
  // k + 3 threads add up the partials
  if (!ok || B < 1 || n < 1 || t < 0 || t >= k || k > kAppendThreads - 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AppendArgs args = {};
  args.pval = pval;
  args.pidx = pidx;
  args.A = A;
  args.Bs = Bs;
  args.cols = cols;
  args.Ginv = Ginv;
  args.coef = coef;
  args.idx = idx;
  args.r = r;
  args.out_idx = out_idx;
  args.out_coef = out_coef;
  args.rtol = rtol;
  args.ntiles = ntiles;
  args.n = n;
  args.m = m;
  args.k = k;
  args.t = t;
  args.slice = p.slice;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cdt_bf16) {
    err = p.staged
              ? launch_append_cluster(omp_append_kernel<__nv_bfloat16, true>,
                                      p, B, args, st)
              : launch_append_cluster(omp_append_kernel<__nv_bfloat16, false>,
                                      p, B, args, st);
  } else {
    err = p.staged
              ? launch_append_cluster(omp_append_kernel<float, true>, p, B,
                                      args, st)
              : launch_append_cluster(omp_append_kernel<float, false>, p, B,
                                      args, st);
  }
  return static_cast<int>(err);
}
