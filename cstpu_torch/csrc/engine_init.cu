// Batched OMPR and SRR, the init: the oblivious acquisition of the slot
// engine, its refit and the first residual norm.
//
// Replaces cstpu/ops/fused_twostage.py::_Engine.oblivious_init (:225-238)
// and the start of _outer_while (:246) in _ompr_kernel and _srr_kernel.
// The TPU kernel takes the row's top-k of |round_cdt(b) . A| one by one (the
// lowest-index maximum, then masked out) and appends each, gated by a
// finite score, into the first free slot. Here select_topl.cu has written
// per-tile top-k partials, and per row:
//   picks = the row's top-cnt of the partials, value descending, index
//           ascending (common.cuh::merge_topl_row, warp sorts and a tree
//           of merges; a NaN row makes none)
//   cnt gated appends in that order (_Engine.append, :138-190:
//           duplicate, capacity and d > rtol * ata gates; Atb, amask)
//   SRR: each append's rescaling term (aperp, -dinv) into pending slot j,
//           for the first fr_select to apply
//   coef = Ginv Atb, r = b - cols' coef; prev = ||r||^2, done = 0 (fgate = 1)
// on the empty state the host made (r = b, cols 0, Ginv = I, idx = m),
// which the kernel does not read.
//
// What bounds it on an H100, and the design: engine_cluster.cuh. The picks
// are known at entry, so nothing of length n stays in the chain of appends:
// each block of a row's cluster gathers its slice of all cnt picked columns
// at once, forms their Gram and their products with b (4 x 4 tiles), and
// the cluster adds those partials once. Slots fill in order from the empty
// state, so append j's gate reads the Schur complement of pick j against
// the picks accepted before it, and its u the regression of pick j on
// them: both are entries of the Gram swept on the accepted picks (M[Q][Q]
// = -Ginv, M[Q][j] = u_j, M[j][j] = d_j), every block sweeping alike, two
// appends a barrier. The columns, r, prev and the pending terms are
// written once at the end. The Gram and the sweeps add the products in
// another order than the appends one by one: the state agrees with the
// plain version's to rounding.
#include "engine_cluster.cuh"

namespace cstpu {

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kAppendThreads, 1)
engine_init_kernel(const InitArgs a) {
  init_cluster_row<T, kStaged>(a);
}

}  // namespace cstpu

// The init of OMPR or SRR for all B rows. pval/pidx (B, ntiles, cnt) from
// cstpu_select_topl on the measurements; A (n, m) in cdt; Bs (B, n) f32;
// the empty state cols (B,K,n), Ginv (B,K,K), coef, Atb (B,K) f32, idx
// (B,K) i32, r (B,n) f32, amask (B,m) u8, done, prev (B,) f32 written;
// SRR also pend_u (P,B,n), pend_w (P,B) with P >= cnt and fgate (B,), all
// null for OMPR. All contiguous, 1 <= cnt <= min(kTopLMax, K). One cluster
// of the plan's C blocks per row (cstpu_engine_plan with cnt). Returns the
// launch's cudaError_t (a refused cluster launch included).
extern "C" int cstpu_engine_init(const float* pval, const int* pidx, int ntiles,
                                 int cnt, const void* A, int cdt_bf16,
                                 const float* Bs, float* cols, float* Ginv,
                                 float* coef, int* idx, float* Atb, float* r,
                                 uint8_t* amask, float* done, float* prev,
                                 float* pend_u, float* pend_w, float* fgate,
                                 int B, int n, int m, int K, float rtol,
                                 void* stream) {
  using namespace cstpu;
  if (cnt < 1 || cnt > kTopLMax || cnt > K) return static_cast<int>(cudaErrorInvalidValue);
  bool ok = false;
  const AppendPlan p = engine_plan(B, n, K, cnt, &ok);
  if (!ok || B < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const InitArgs args = {pval, pidx, A,    Bs,     cols,   Ginv, coef,  idx,
                         Atb,  r,    amask, done,  prev,   pend_u, pend_w,
                         fgate, rtol, ntiles, cnt, B, n, m, K, p.slice};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cdt_bf16) {
    err = p.staged
              ? launch_append_cluster(engine_init_kernel<__nv_bfloat16, true>,
                                      p, B, args, st)
              : launch_append_cluster(engine_init_kernel<__nv_bfloat16, false>,
                                      p, B, args, st);
  } else {
    err = p.staged
              ? launch_append_cluster(engine_init_kernel<float, true>, p, B,
                                      args, st)
              : launch_append_cluster(engine_init_kernel<float, false>, p, B,
                                      args, st);
  }
  return static_cast<int>(err);
}
