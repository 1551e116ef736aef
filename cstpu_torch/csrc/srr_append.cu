// Batched SRR, stage 2: one forward step per row.
//
// Replaces forward_step of cstpu/ops/fused_twostage.py::_srr_kernel
// (:1135-1144, run l times per iteration by :1156-1160) after its OLS
// select, which fr_select.cu computes from the pending terms. A row that is
// done, or whose forward gate closed earlier in the iteration, changes
// nothing and leaves a zero pending term (slot 0). Per row:
//   (dmax, i) = the select partials (B, T) reduced with argmax_combine
//   gate      = ||r||^2 > 0 && dmax > 0 && nactive < min(n, m)
//   the gated append of i into the first free slot (_Engine.append,
//               :138-190: not a duplicate, d > rtol ata)
//   pending slot 0 = (aperp, -dinv): the rescaling downdate of this append,
//               for the next fr_select (the TPU kernel's z GEMM, :183-189)
//   coef = Ginv Atb, r = b - cols' coef;  fgate *= ok;  amask[i] on ok
//
// That is RMP's forward step (rmp_append.cu) with the floor and the gain
// threshold at 0 and without its capped and acc latches, so it runs on
// engine_cluster.cuh::rmp_cluster_row in its SRR mode (kSrr): a
// thread-block cluster of C blocks per row (engine_plan(B, n, K, 0), the
// plan rmp_append takes), each block a slice of n; the occupied slot
// columns staged once in shared memory; one exchange of the partials g,
// ata, beta and ||r||^2 through distributed shared memory; the gate, the
// Ginv update and the refit alike in every block; the live-slot sums for
// aperp and r; rank 0's flags.
//
// What bounds it on an H100: latency, as rmp_append.cu: one strided
// column gather, the slot columns read once, K-sized work.
#include "engine_cluster.cuh"

namespace cstpu {

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kAppendThreads, 1)
srr_append_kernel(const RmpArgs a) {
  rmp_cluster_row<T, kStaged, true>(a);
}

}  // namespace cstpu

// One SRR forward step for all B rows. pval/pidx (B, ntiles) from
// cstpu_fr_select; A (n, m) in cdt; Bs (B, n) f32; state cols (B,K,n), Ginv
// (B,K,K), coef, Atb (B,K) f32, idx (B,K) i32, r (B,n) f32, amask (B,m) u8,
// fgate (B,) f32 updated in place, done (B,) read; pending slot 0 of pend_u
// (P,B,n) and pend_w (P,B) written. All contiguous. One cluster of the
// plan's C blocks per row (cstpu_engine_plan with cnt = 0). Returns the
// launch's cudaError_t (a refused cluster launch included).
extern "C" int cstpu_srr_append(const float* pval, const int* pidx, int ntiles,
                                const void* A, int cdt_bf16, const float* Bs,
                                float* cols, float* Ginv, float* coef, int* idx,
                                float* Atb, float* r, uint8_t* amask,
                                float* done, float* pend_u, float* pend_w,
                                float* fgate, int B, int n, int m, int K,
                                float rtol, void* stream) {
  using namespace cstpu;
  bool ok = false;
  const AppendPlan p = engine_plan(B, n, K, 0, &ok);
  // K + 3 threads add up the partials
  if (!ok || B < 1 || n < 1 || K < 1 || rmp_parts(K) > kAppendThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RmpArgs args = {pval,    pidx,    A,       Bs,      cols,  Ginv,
                        coef,    idx,     Atb,     r,       amask, done,
                        pend_u,  pend_w,  fgate,   nullptr, nullptr,
                        nullptr, nullptr, rtol,    0.f,     ntiles,
                        B,       n,       m,       K,       p.slice, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cdt_bf16) {
    err = p.staged
              ? launch_append_cluster(srr_append_kernel<__nv_bfloat16, true>,
                                      p, B, args, st)
              : launch_append_cluster(srr_append_kernel<__nv_bfloat16, false>,
                                      p, B, args, st);
  } else {
    err = p.staged
              ? launch_append_cluster(srr_append_kernel<float, true>, p, B,
                                      args, st)
              : launch_append_cluster(srr_append_kernel<float, false>, p, B,
                                      args, st);
  }
  return static_cast<int>(err);
}
