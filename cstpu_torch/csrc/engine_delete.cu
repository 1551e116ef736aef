// Batched SRR, stage 3: the backward deletions of one iteration and the
// latch.
//
// Replaces the backward loop and the iteration tail of
// cstpu/ops/fused_twostage.py::_srr_kernel (:1146-1151, :1162-1171) with
// _Engine.backward_min (:126-136), delete_ep (:192-216) and refit_residual
// (:218-223). A row that is done changes nothing and leaves zero pending
// terms. Per row, l times:
//   over  = nactive > k
//   (p, dmin) = argmin over occupied slots of coef^2 / max(Ginv_pp, 1e-30),
//           lowest slot on ties, a NaN minimum rejecting
//   the delete of slot p where over && dmin < inf (Schur downdate,
//           identity pad, idx/Atb/column/amask cleared), its restore term
//           (v = cols' Ginv e_p, 1/q_p) into pending slot 1 + j: a deletion
//           never reads the rescaling, so the next fr_select applies it; a
//           gated-off deletion writes a zero term
//   coef = Ginv Atb, r = b - cols' coef
// then res = ||r||^2; done |= res <= delta2 || prev <= res; prev = res;
// fgate = !done, the forward gate of the next iteration.
//
// What bounds it on an H100: latency. A row's work is its K slot columns
// read once (70 KB at suite config 3b: K = 17, n = 1024), l dependent K x K
// downdates and two length-n sums over the live slots. One 256-thread block
// per row left half the card idle at B = 64 and most of it at B = 8, read
// the slot columns from device memory twice a deletion, and chose each slot
// in one thread behind seven block barriers. Design: the slot engine's
// cluster (engine_cluster.cuh::srr_delete_row on engine_plan(B, n, K, 0),
// the plan srr_append and rmp_append take, so block (b, rank) reads the
// slice that block (b, rank) of the preceding append wrote): every block
// stages Ginv, coef, Atb, idx and its slices of b and of all K slot columns
// at entry; the deletions (cluster_deletions, shared with FoBa and RMP) run
// alike in every block, the score a warp reduction, with no exchange; each
// block writes its slice of the restore terms and of r, and sends its share
// of ||r||^2 to rank 0, which adds the C shares in rank order and writes the
// latch. A cluster barrier, arrived at once the state is read and waited on
// before it is written, keeps every block's reads ahead of the writes.
#include "engine_cluster.cuh"

namespace cstpu {

template <bool kStaged>
__global__ void __launch_bounds__(kAppendThreads, 1)
engine_delete_kernel(const DelArgs a) {
  srr_delete_row<kStaged>(a);
}

}  // namespace cstpu

// SRR's backward stage for all B rows: l deletions back to k atoms. Bs
// (B, n) f32; state cols (B,K,n), Ginv (B,K,K), coef, Atb (B,K) f32, idx
// (B,K) i32, r (B,n) f32, amask (B,m) u8, done, prev, fgate (B,) f32
// updated in place; pending slots 1..l of pend_u (P,B,n) and pend_w (P,B)
// written, P > l. All contiguous. One cluster of the plan's C blocks per
// row (cstpu_engine_plan with cnt = 0). Returns the launch's cudaError_t
// (a refused cluster launch included).
extern "C" int cstpu_engine_delete(const float* Bs, float* cols, float* Ginv,
                                   float* coef, int* idx, float* Atb, float* r,
                                   uint8_t* amask, float* done, float* prev,
                                   float* pend_u, float* pend_w, float* fgate,
                                   int B, int n, int m, int K, int k, int l,
                                   float delta2, void* stream) {
  using namespace cstpu;
  bool ok = false;
  AppendPlan p = engine_plan(B, n, K, 0, &ok);
  // K threads load idx
  if (!ok || l < 1 || B < 1 || n < 1 || K < 1 || K > kAppendThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.smem = del_cluster_smem(p.slice, K, p.staged);
  const DelArgs args = {Bs,     cols,   Ginv,  coef,    idx,     Atb,
                        r,      amask,  done,  prev,    pend_u,  pend_w,
                        fgate,  nullptr, nullptr, delta2, B,     n,
                        m,      K,      k,     l,       p.slice};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      p.staged ? launch_append_cluster(engine_delete_kernel<true>, p, B, args, st)
               : launch_append_cluster(engine_delete_kernel<false>, p, B, args, st);
  return static_cast<int>(err);
}
