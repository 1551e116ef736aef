// Batched RMP: the backward stage of one outer pass, and the pass's latch.
//
// Replaces the backward stage and the outer-loop tail of
// cstpu/ops/fused_twostage.py::_rmp_kernel (backward_step :1301-1312, its
// stage loop :1314-1336, the latch :1338-1344). A deletion never reads the
// dictionary or the rescaling, so the whole stage is one launch, one block
// per row: engine.cuh::engine_backward_loop deletes while the row's rule
// accepts (delta variant: increase < delta2; k variant: down to kfinal
// atoms), each deletion leaving its restore term in pending slots 1.. for
// the next fr_select. Then, per row,
//   progressed = acc (a forward step of this pass was accepted) || count > 0
//   done |= !progressed;  fgate = !done (the next pass's forward gate);
//   acc = 0;  ndel = count
// A done row changes nothing but zeroes its pending weights 1..K.
//
// What bounds it on an H100: latency: up to K dependent K x K downdates,
// each with two length-n passes (v and the residual), one block per row.
#include "engine.cuh"

namespace cstpu {

__global__ void __launch_bounds__(kEngThreads)
engine_backward_kernel(const float* __restrict__ Bs, float* __restrict__ cols,
                       float* __restrict__ Ginv, float* __restrict__ coef,
                       int* __restrict__ idx, float* __restrict__ Atb,
                       float* __restrict__ r, uint8_t* __restrict__ amask,
                       float* __restrict__ done, float* __restrict__ pend_u,
                       float* __restrict__ pend_w, float* __restrict__ fgate,
                       float* __restrict__ acc, float* __restrict__ ndel,
                       int B, int n, int m, int K, float delta2, int kfinal) {
  extern __shared__ float smem[];
  __shared__ float sc[4];
  __shared__ int s_ok, s_p, s_acc;
  const EngineSmem s = carve_engine_smem(smem, n, K, sc, &s_ok);

  const int b = blockIdx.x, tid = threadIdx.x;
  if (done[b] > 0.5f) {
    for (int e = 1 + tid; e <= K; e += blockDim.x) pend_w[(size_t)e * B + b] = 0.f;
    if (tid == 0) ndel[b] = 0.f;
    return;
  }
  load_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                    idx + (size_t)b * K, Atb + (size_t)b * K, K);
  const int nd = engine_backward_loop(
      s, Bs + (size_t)b * n, cols + (size_t)b * K * n, r + (size_t)b * n,
      amask + (size_t)b * m, pend_u, pend_w, B, b, n, m, K, delta2, kfinal,
      &s_p, &s_acc);
  store_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                     idx + (size_t)b * K, Atb + (size_t)b * K, K);
  if (tid == 0) {
    const bool progressed = acc[b] > 0.5f || nd > 0;
    if (!progressed) done[b] = 1.f;
    fgate[b] = progressed ? 1.f : 0.f;
    acc[b] = 0.f;
    ndel[b] = (float)nd;
  }
}

}  // namespace cstpu

// RMP's backward stage for all B rows. Bs (B, n) f32; state cols (B,K,n),
// Ginv (B,K,K), coef, Atb (B,K) f32, idx (B,K) i32, r (B,n) f32, amask
// (B,m) u8, done, fgate, acc, ndel (B,) f32 updated in place; pending
// slots 1..K of pend_u (P,B,n) and pend_w (P,B) written, P >= K + 1.
// kfinal >= 0 selects the k variant's rule. All contiguous. Returns the
// launch's cudaError_t.
extern "C" int cstpu_engine_backward(const float* Bs, float* cols, float* Ginv,
                                     float* coef, int* idx, float* Atb,
                                     float* r, uint8_t* amask, float* done,
                                     float* pend_u, float* pend_w,
                                     float* fgate, float* acc, float* ndel,
                                     int B, int n, int m, int K, float delta2,
                                     int kfinal, void* stream) {
  using namespace cstpu;
  const size_t smem = engine_smem_bytes(n, K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(engine_backward_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  engine_backward_kernel<<<B, kEngThreads, smem, st>>>(
      Bs, cols, Ginv, coef, idx, Atb, r, amask, done, pend_u, pend_w, fgate,
      acc, ndel, B, n, m, K, delta2, kfinal);
  return static_cast<int>(cudaGetLastError());
}
