// Batched GOMP, stage 2: one iteration's gated appends, the residual and
// the epsilon latch.
//
// Replaces the appends and the iteration tail of cstpu/ops/fused_solve.py::
// _gomp_kernel (:749-798). One launch is one iteration of `cnt` picks (l,
// or k % l for the remainder iteration, whose latch the host discards).
// Per row b, with state in device memory (cols (B,k,n), Ginv (B,k,k),
// coef (B,k), idx (B,k), r (B,n), kcnt (B,), done (B,)):
//   picks = the row's top-cnt of the select_topl partials (B, T, cnt) by
//           value descending, then index ascending; a NaN among them makes
//           every pick INT_MAX (the TPU kernel's smax/== rule, :752-755)
//   for each pick in that order, into slot kcnt:
//     pre = kcnt < cap && !done; the gated bordered append of common.cuh
//     (dup, d > rtol*ata, Ginv, coef, idx, cols); kcnt += ok
//     (a rejected pick still uses up its place in the top-cnt, as :755)
//   r = b - cols'coef; done = (||r||^2 < eps2 || kcnt >= n) ? 1 : done
// The slots come back in insertion order; the host sorts them by atom
// index (cstpu sorts in XLA after its kernel too, :63-95).
//
// What bounds it on an H100, and the design: gomp_ompr_cluster.cuh. All
// cnt picks are known once the partials are merged (every block of a
// row's cluster merges them alike), so nothing of length n stays in the
// chain of appends: each block gathers its slice of every picked column at
// once and forms their products with the old slot columns, with each other
// and with b (4 x 4 tiles); the cluster adds those partials once (once a
// round of R picks where they do not fit); the cnt appends then run on
// Ginv and coef in shared memory, g of pick j being its cross terms with
// the old slots and its Gram entries with the picks accepted before it.
// The columns, r and the latch are written once at the end. The products
// are added in another order than the appends one by one: the state
// agrees with the plain version's to rounding.
#include "gomp_ompr_cluster.cuh"

namespace cstpu {

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kAppendThreads, 1)
gomp_append_kernel(const GompArgs a) {
  gomp_cluster_row<T, kStaged>(a);
}

}  // namespace cstpu

// The launch plan of gomp_append for B rows, n, k slots and cnt picks:
// out = {C, slice, staged, dynamic shared memory bytes, picks a round,
// entries of a pick gathered at once}. Returns cudaErrorInvalidValue when
// no plan fits.
extern "C" int cstpu_gomp_plan(int B, int n, int k, int cnt, int* out) {
  using namespace cstpu;
  bool ok = false;
  const GompPlan g = gomp_plan(B, n, k, cnt, &ok);
  out[0] = g.p.C;
  out[1] = g.p.slice;
  out[2] = g.p.staged;
  out[3] = static_cast<int>(g.p.smem);
  out[4] = g.R;
  out[5] = g.W;
  return static_cast<int>(ok ? cudaSuccess : cudaErrorInvalidValue);
}

// One GOMP iteration of cnt picks for all B rows. pval/pidx (B, ntiles,
// cnt) from cstpu_select_topl; A (n, m) in cdt; Bs (B, n) f32; state cols
// (B,k,n), Ginv (B,k,k), coef (B,k) f32, idx (B,k) i32, kcnt (B,) i32 and
// done (B,) f32 updated in place, r (B,n) f32 overwritten. All contiguous,
// 1 <= cnt <= kTopLMax. One cluster of the plan's C blocks per row
// (cstpu_gomp_plan). Returns the launch's cudaError_t (a refused cluster
// launch included).
extern "C" int cstpu_gomp_append(const float* pval, const int* pidx,
                                 int ntiles, int cnt, const void* A,
                                 int cdt_bf16, const float* Bs, float* cols,
                                 float* Ginv, float* coef, int* idx, float* r,
                                 int* kcnt, float* done, int B, int n, int m,
                                 int k, int cap, float rtol, float eps2,
                                 void* stream) {
  using namespace cstpu;
  if (cnt < 1 || cnt > kTopLMax || k < 1 || B < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool ok = false;
  const GompPlan g = gomp_plan(B, n, k, cnt, &ok);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const GompArgs args = {pval, pidx, A,    Bs,     cols,   Ginv,  coef,
                         idx,  r,    kcnt, done,   rtol,   eps2,  ntiles,
                         cnt,  n,    m,    k,      cap,    g.p.slice, g.R,
                         g.W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cdt_bf16) {
    err = g.p.staged
              ? launch_append_cluster(gomp_append_kernel<__nv_bfloat16, true>,
                                      g.p, B, args, st)
              : launch_append_cluster(gomp_append_kernel<__nv_bfloat16, false>,
                                      g.p, B, args, st);
  } else {
    err = g.p.staged
              ? launch_append_cluster(gomp_append_kernel<float, true>, g.p, B,
                                      args, st)
              : launch_append_cluster(gomp_append_kernel<float, false>, g.p,
                                      B, args, st);
  }
  return static_cast<int>(err);
}
