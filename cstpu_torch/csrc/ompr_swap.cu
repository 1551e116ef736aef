// Batched OMPR, stage 2: one replacement iteration per row.
//
// Replaces the body of cstpu/ops/fused_twostage.py::_ompr_kernel
// (:997-1032) after its passive select, which select_argmax.cu's masked
// variant computes. A row that is done changes nothing (the TPU kernel's
// gated iteration changes nothing there either). Per row:
//   (best, i) = the select partials (B, T) reduced; change = best > 0
//   coef_pre  = coef on the occupied slots (the solution before the append)
//   the gated append of i into the first free slot (_Engine.append)
//   gcoef     = ok ? (coef_pre + eta * cols . r) * occupied : coef, with r
//               still the residual from before the append (:1007-1016)
//   delete the slot of min |gcoef| (lowest slot on ties, only if ok)
//   coef = Ginv Atb, r = b - cols' coef
//   res = ok ? ||r||^2 : prev; done |= !change || res <= delta2 || prev <= res
//   prev = res
//
// What bounds it on an H100, and the design: gomp_ompr_cluster.cuh. Each
// block of a row's cluster gathers its slice of the picked column and
// forms, from the slot columns staged once in shared memory, its share of
// the 2K + 3 products the iteration needs (g and the gradient over the
// occupied slots, the new column's gradient, ata, beta); the cluster adds
// them once, and every block runs the K-sized work alike: the append, the
// gradient step, the deletion and the refit. The new column, the cleared
// one and r are written once, from the staged columns. Where the atom
// deleted is the one just appended, the append and the downdate of its
// slot cancel and Ginv and Atb stay exactly as they were (the plain version
// rounds them): once a row's support settles, its refit and ||r||^2 repeat
// the last swap's bits, and prev <= res latches it.
#include "gomp_ompr_cluster.cuh"

namespace cstpu {

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kAppendThreads, 1)
ompr_swap_kernel(const SwapArgs a) {
  swap_cluster_row<T, kStaged>(a);
}

}  // namespace cstpu

// The launch plan of ompr_swap for B rows, n and K slots: out = {C, slice,
// staged, dynamic shared memory bytes}. Returns cudaErrorInvalidValue when
// no plan fits.
extern "C" int cstpu_ompr_plan(int B, int n, int K, int* out) {
  using namespace cstpu;
  bool ok = false;
  const AppendPlan p = ompr_plan(B, n, K, &ok);
  out[0] = p.C;
  out[1] = p.slice;
  out[2] = p.staged;
  out[3] = static_cast<int>(p.smem);
  return static_cast<int>(ok ? cudaSuccess : cudaErrorInvalidValue);
}

// One OMPR iteration for all B rows. pval/pidx (B, ntiles) from the masked
// cstpu_select_argmax; A (n, m) in cdt; Bs (B, n) f32; state cols
// (B,K,n), Ginv (B,K,K), coef, Atb (B,K) f32, idx (B,K) i32, r (B,n) f32,
// amask (B,m) u8, done, prev (B,) f32 updated in place. All contiguous.
// One cluster of the plan's C blocks per row (cstpu_ompr_plan). Returns the
// launch's cudaError_t (a refused cluster launch included).
extern "C" int cstpu_ompr_swap(const float* pval, const int* pidx, int ntiles,
                               const void* A, int cdt_bf16, const float* Bs,
                               float* cols, float* Ginv, float* coef, int* idx,
                               float* Atb, float* r, uint8_t* amask,
                               float* done, float* prev, int B, int n, int m,
                               int K, float rtol, float eta, float delta2,
                               void* stream) {
  using namespace cstpu;
  bool ok = false;
  const AppendPlan p = ompr_plan(B, n, K, &ok);
  if (!ok || B < 1 || n < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const SwapArgs args = {pval, pidx, A,    Bs,   cols,  Ginv,   coef,
                         idx,  Atb,  r,    amask, done, prev,   rtol,
                         eta,  delta2, ntiles, n,  m,   K,      p.slice};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cdt_bf16) {
    err = p.staged
              ? launch_append_cluster(ompr_swap_kernel<__nv_bfloat16, true>,
                                      p, B, args, st)
              : launch_append_cluster(ompr_swap_kernel<__nv_bfloat16, false>,
                                      p, B, args, st);
  } else {
    err = p.staged
              ? launch_append_cluster(ompr_swap_kernel<float, true>, p, B,
                                      args, st)
              : launch_append_cluster(ompr_swap_kernel<float, false>, p, B,
                                      args, st);
  }
  return static_cast<int>(err);
}
