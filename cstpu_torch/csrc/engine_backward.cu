// Batched RMP: the backward stage of one outer pass, and the pass's latch.
//
// Replaces the backward stage and the outer-loop tail of
// cstpu/ops/fused_twostage.py::_rmp_kernel (backward_step :1301-1312, its
// stage loop :1314-1336, the latch :1338-1344) with _Engine.backward_min
// (:126-136), delete_ep (:192-216) and refit_residual (:218-223). A deletion
// never reads the dictionary or the rescaling, so the whole stage is one
// launch: per row, while the rule accepts (delta variant: increase <
// delta2; k variant: down to kfinal atoms; a NaN minimum rejects), at most
// K + 1 times, delete the slot of least coef^2 / max(Ginv_pp, 1e-30) (the
// lowest on ties) and refit, each deletion j leaving its restore term in
// pending slot 1 + j for the next fr_select, the weights of slots
// 1 + count .. K zeroed. Then, per row,
//   progressed = acc (a forward step of this pass was accepted) || count > 0
//   done |= !progressed;  fgate = progressed (the next pass's forward gate);
//   acc = 0;  ndel = count
// A done row changes nothing but zeroes its pending weights 1..K and ndel.
//
// What bounds it on an H100: latency. A stage that deletes nothing (every
// row of suite config 3d) needs a row's coef, idx and Ginv's diagonal (3K
// floats) and writes its latches; one that deletes reads the row's K slot
// columns once and runs up to K dependent K x K downdates with two
// length-n sums each. One block per row (8 blocks at B = 8) loaded the
// whole state, decided in one thread and stored it back unchanged. Design:
// the slot engine's cluster (engine_cluster.cuh::rmp_backward_row on
// engine_plan(B, n, K, 0), the plan of rmp_append): every block decides
// the first deletion from coef, idx and Ginv's diagonal alone, and a row
// that rejects at once writes only its latches and zero weights; a row
// that deletes waits for the copies of Ginv, Atb and its slices of b and of
// the occupied slot columns (issued before the decision), runs the
// deletions alike in every block (cluster_deletions, shared with FoBa and
// SRR) and writes its slices of the restore terms and of r. A cluster
// barrier, arrived at once the state is read and waited on before it is
// written, keeps every block's reads ahead of the writes.
#include "engine_cluster.cuh"

namespace cstpu {

template <bool kStaged>
__global__ void __launch_bounds__(kAppendThreads, 1)
engine_backward_kernel(const DelArgs a) {
  rmp_backward_row<kStaged>(a);
}

}  // namespace cstpu

// RMP's backward stage for all B rows. Bs (B, n) f32; state cols (B,K,n),
// Ginv (B,K,K), coef, Atb (B,K) f32, idx (B,K) i32, r (B,n) f32, amask
// (B,m) u8, done, fgate, acc, ndel (B,) f32 updated in place; pending
// slots 1..K of pend_u (P,B,n) and pend_w (P,B) written, P >= K + 1.
// kfinal >= 0 selects the k variant's rule. All contiguous. One cluster of
// the plan's C blocks per row (cstpu_engine_plan with cnt = 0). Returns
// the launch's cudaError_t (a refused cluster launch included).
extern "C" int cstpu_engine_backward(const float* Bs, float* cols, float* Ginv,
                                     float* coef, int* idx, float* Atb,
                                     float* r, uint8_t* amask, float* done,
                                     float* pend_u, float* pend_w,
                                     float* fgate, float* acc, float* ndel,
                                     int B, int n, int m, int K, float delta2,
                                     int kfinal, void* stream) {
  using namespace cstpu;
  bool ok = false;
  AppendPlan p = engine_plan(B, n, K, 0, &ok);
  // K threads load coef, idx and Ginv's diagonal
  if (!ok || B < 1 || n < 1 || K < 1 || K > kAppendThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.smem = del_cluster_smem(p.slice, K, p.staged);
  const DelArgs args = {Bs,     cols,  Ginv,   coef,   idx,     Atb,
                        r,      amask, done,   nullptr, pend_u, pend_w,
                        fgate,  acc,   ndel,   delta2, B,       n,
                        m,      K,     kfinal, 0,      p.slice};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      p.staged
          ? launch_append_cluster(engine_backward_kernel<true>, p, B, args, st)
          : launch_append_cluster(engine_backward_kernel<false>, p, B, args, st);
  return static_cast<int>(err);
}
