// Batched RMP and FoBa: one forward step per row, and for FoBa the backward
// deletions that follow it.
//
// Replaces forward_step of cstpu/ops/fused_twostage.py::_rmp_kernel
// (:1287-1299, run to rejection by the forward stage :1314-1336) and the
// body of _foba_kernel (:1447-1476), after their OLS select, which
// fr_select.cu computes from the pending terms. A row that is done, or
// whose forward gate is closed, changes nothing and leaves zero pending
// weights. Per row:
//   (dmax, i) = the select partials (B, T) reduced with argmax_combine
//   wanted    = ||r||^2 > floor2 && dmax > delta2 && nactive < min(n, m)
//               (floor2 = 64 n eps^2 ||b||^2, the exhaustion floor)
//   full      = nactive >= K;  capped |= wanted && full: the only rejection
//               the slot cap causes, decided before the append's own tests
//   the append of i into the first free slot, gated by wanted && !full
//   (_Engine.append, :138-190; plain twin _engine_append_ref)
//   pending slot 0 = (aperp, -dinv), the rescaling downdate of this append
//   coef = Ginv Atb, r = b - cols' coef;  fgate *= ok;  acc |= ok
// and with `foba`, after an accepted append, the deletions while the
// increase stays below max(dmax, 0) / 4 (engine_cluster.cuh::
// cluster_deletions, plain twin _backward_loop_ref), their restore terms
// in pending slots 1.., their count in ndel; r is written once, after
// the last deletion (the refits between them change only coef, which the
// next deletion's scores read).
//
// What bounds it on an H100, and the design: engine_cluster.cuh (a
// thread-block cluster per row, the K slot columns staged once in shared
// memory, the partials g, ata, beta and ||r||^2 added across the cluster
// through distributed shared memory once a launch; the gate, the Ginv
// update, the refits and every deletion's scores and downdate run in every
// block alike, so the deletions need no exchange). This file also holds the
// launch plan that engine_init.cu shares.
#include "engine_cluster.cuh"

namespace cstpu {

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kAppendThreads, 1)
rmp_append_kernel(const RmpArgs a) {
  rmp_cluster_row<T, kStaged>(a);
}

}  // namespace cstpu

// The launch plan of rmp_append (cnt = 0) and engine_init (cnt picks) for B
// rows, n and K slots: out = {C, slice, staged, dynamic shared memory
// bytes}. Returns cudaErrorInvalidValue when no plan fits.
extern "C" int cstpu_engine_plan(int B, int n, int K, int cnt, int* out) {
  using namespace cstpu;
  bool ok = false;
  const AppendPlan p = engine_plan(B, n, K, cnt, &ok);
  out[0] = p.C;
  out[1] = p.slice;
  out[2] = p.staged;
  out[3] = static_cast<int>(p.smem);
  return static_cast<int>(ok ? cudaSuccess : cudaErrorInvalidValue);
}

// One RMP forward step (foba = 0) or one FoBa iteration (foba = 1) for all B
// rows. pval/pidx (B, ntiles) from cstpu_fr_select; A (n, m) in cdt; Bs
// (B, n) f32; state cols (B,K,n), Ginv (B,K,K), coef, Atb (B,K) f32, idx
// (B,K) i32, r (B,n) f32, amask (B,m) u8, fgate, acc, capped, ndel (B,) f32
// updated in place, done and floor2 (B,) f32 read; pending slot 0 (foba:
// slots 0..K) of pend_u (P,B,n) and pend_w (P,B) written, P >= K + 1. All
// contiguous. One cluster of the plan's C blocks per row. Returns the
// launch's cudaError_t (a refused cluster launch included).
extern "C" int cstpu_rmp_append(const float* pval, const int* pidx, int ntiles,
                                const void* A, int cdt_bf16, const float* Bs,
                                float* cols, float* Ginv, float* coef, int* idx,
                                float* Atb, float* r, uint8_t* amask,
                                const float* done, float* pend_u,
                                float* pend_w, float* fgate, float* acc,
                                float* capped, float* ndel,
                                const float* floor2, int B, int n, int m,
                                int K, float rtol, float delta2, int foba,
                                void* stream) {
  using namespace cstpu;
  bool ok = false;
  const AppendPlan p = engine_plan(B, n, K, 0, &ok);
  // K + 3 threads add up the partials
  if (!ok || B < 1 || n < 1 || K < 1 || rmp_parts(K) > kAppendThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RmpArgs args = {pval,   pidx,  A,      Bs,    cols,  Ginv,   coef,
                        idx,    Atb,   r,      amask, done,  pend_u, pend_w,
                        fgate,  acc,   capped, ndel,  floor2, rtol,  delta2,
                        ntiles, B,     n,      m,     K,     p.slice, foba};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cdt_bf16) {
    err = p.staged
              ? launch_append_cluster(rmp_append_kernel<__nv_bfloat16, true>,
                                      p, B, args, st)
              : launch_append_cluster(rmp_append_kernel<__nv_bfloat16, false>,
                                      p, B, args, st);
  } else {
    err = p.staged
              ? launch_append_cluster(rmp_append_kernel<float, true>, p, B,
                                      args, st)
              : launch_append_cluster(rmp_append_kernel<float, false>, p, B,
                                      args, st);
  }
  return static_cast<int>(err);
}
