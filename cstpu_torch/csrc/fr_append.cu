// Batched forward regression (FR), stage 2: the stopping rules, the gated
// append, the orthogonal column for the next rescaling downdate, the
// residual and the stop latch.
//
// Replaces :578-622 of cstpu/ops/fused_solve.py::_fr_kernel. One launch is
// one FR step t; slot t is written (no deletions). Per row b:
//   (dmax, i) = the fr_select partials (B, T) reduced with argmax_combine
//   accept    = ||r||^2 > max_eps2 && dmax > min_d2   (r before the step;
//               a NaN row has dmax NaN, so it never accepts)
//   the gated bordered append of i into slot t with pre = accept && !done
//   (the math of :587-611, plain twin cstpu_torch/ops/fused_solve.py::
//   _bordered_append_ref: dup, d > rtol*ata, Ginv, coef, idx, cols)
//   aperp = acol - sum_s cols[s] u[s], after slot t is written (:614), and
//   dinv go to the next fr_select, which downdates resc with them
//   amask[b, i] = 1 if ok;  r = b - cols'coef;  done = ok ? done : 1
// max_eps2 = max_residual^2 and min_d2 = min_decrease^2 are run-time
// arguments, as the TPU kernel reads them from an operand (:553-554). The
// slots come back in insertion order; the host sorts them by atom index.
//
// What bounds it on an H100, and the design: omp_append.cu's, the same
// insertion-order append (append_cluster.cuh, on omp_append.cu's plan):
// a thread-block cluster per row over the staged live slot columns, which
// serve g, the residual and aperp from one copy; ||r||^2 is a fourth
// partial beside g, ata and beta.
#include "append_cluster.cuh"

namespace cstpu {

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kAppendThreads, 1)
fr_append_kernel(const AppendArgs a) {
  append_cluster_row<T, kStaged, true>(a);
}

}  // namespace cstpu

// One FR step t for all B rows. pval/pidx (B, ntiles) from
// cstpu_fr_select; A (n, m) in cdt; Bs (B, n) f32; state cols (B,k,n),
// Ginv (B,k,k), coef (B,k) f32, idx (B,k) i32, amask (B,m) u8 and done
// (B,) f32 updated in place; r, aperp (B,n) and dinv (B,) f32 overwritten.
// All contiguous. One cluster of the plan's C blocks per row. Returns the
// launch's cudaError_t (a refused cluster launch included).
extern "C" int cstpu_fr_append(const float* pval, const int* pidx, int ntiles,
                               const void* A, int cdt_bf16, const float* Bs,
                               float* cols, float* Ginv, float* coef, int* idx,
                               float* r, float* aperp, float* dinv,
                               uint8_t* amask, float* done, int B, int n,
                               int m, int k, int t, float rtol, float max_eps2,
                               float min_d2, void* stream) {
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
  args.aperp = aperp;
  args.dinv = dinv;
  args.amask = amask;
  args.done = done;
  args.max_eps2 = max_eps2;
  args.min_d2 = min_d2;
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
              ? launch_append_cluster(fr_append_kernel<__nv_bfloat16, true>,
                                      p, B, args, st)
              : launch_append_cluster(fr_append_kernel<__nv_bfloat16, false>,
                                      p, B, args, st);
  } else {
    err = p.staged
              ? launch_append_cluster(fr_append_kernel<float, true>, p, B,
                                      args, st)
              : launch_append_cluster(fr_append_kernel<float, false>, p, B,
                                      args, st);
  }
  return static_cast<int>(err);
}
