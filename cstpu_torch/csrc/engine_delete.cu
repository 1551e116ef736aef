// Batched SRR, stage 3: the backward deletions of one iteration and the
// latch.
//
// Replaces the backward loop and the iteration tail of
// cstpu/ops/fused_twostage.py::_srr_kernel (:1146-1151, :1162-1171) with
// _Engine.backward_min (:126-136) and delete_ep (:192-216). One block per
// row; a row that is done changes nothing and leaves zero pending terms.
// Per row, l times:
//   over  = nactive > k
//   (p, dmin) = argmin over occupied slots of coef^2 / max(Ginv_pp, 1e-30),
//           lowest slot on ties
//   the delete of slot p where over && dmin < inf (Schur downdate,
//           identity pad, idx/Atb/column/amask cleared), its restore term
//           (v = cols' Ginv e_p, 1/q_p) into pending slot 1 + j: a deletion
//           never reads the rescaling, so the next fr_select applies it
//   coef = Ginv Atb, r = b - cols' coef
// then res = ||r||^2; done |= res <= delta2 || prev <= res; prev = res;
// fgate = !done, the forward gate of the next iteration.
//
// What bounds it on an H100: latency: l dependent K x K downdates, each
// with two length-n passes (v and the residual), one block per row.
#include "engine.cuh"

namespace cstpu {

__global__ void __launch_bounds__(kEngThreads)
engine_delete_kernel(const float* __restrict__ Bs, float* __restrict__ cols,
                     float* __restrict__ Ginv, float* __restrict__ coef,
                     int* __restrict__ idx, float* __restrict__ Atb,
                     float* __restrict__ r, uint8_t* __restrict__ amask,
                     float* __restrict__ done, float* __restrict__ prev,
                     float* __restrict__ pend_u, float* __restrict__ pend_w,
                     float* __restrict__ fgate, int B, int n, int m, int K,
                     int k, int l, float delta2) {
  extern __shared__ float smem[];
  __shared__ float red_v[kEngThreads / 32];
  __shared__ float sc[4];
  __shared__ int s_ok, s_p, s_hasf;
  const EngineSmem s = carve_engine_smem(smem, n, K, sc, &s_ok);

  const int b = blockIdx.x, tid = threadIdx.x;
  if (done[b] > 0.5f) {
    for (int j = 0; j < l; ++j) {
      float* vb = pend_u + ((size_t)(1 + j) * B + b) * n;
      for (int p = tid; p < n; p += blockDim.x) vb[p] = 0.f;
      if (tid == 0) pend_w[(size_t)(1 + j) * B + b] = 0.f;
    }
    return;
  }
  const float* bb = Bs + (size_t)b * n;
  float* colsb = cols + (size_t)b * K * n;
  float* rb = r + (size_t)b * n;
  uint8_t* amaskb = amask + (size_t)b * m;

  load_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                    idx + (size_t)b * K, Atb + (size_t)b * K, K);
  float share = 0.f;
  for (int j = 0; j < l; ++j) {
    if (tid == 0) {
      float dmin = INFINITY;
      for (int e = 0; e < K; ++e) {
        const float c = s.a.cf[e];
        const float d2 = s.a.ix[e] < m ? c * c / max_keep_nan(s.a.Gs[e * K + e], 1e-30f) : INFINITY;
        s.v0[e] = d2;
        dmin = min_keep_nan(dmin, d2);
      }
      int p = K;
      for (int e = K - 1; e >= 0; --e) p = s.v0[e] == dmin ? e : p;
      s_p = p;
      s_hasf = engine_nactive(s, K, m) > k && dmin < INFINITY;
    }
    __syncthreads();
    engine_delete(s, colsb, amaskb, n, m, K, s_p, s_hasf,
                  pend_u + ((size_t)(1 + j) * B + b) * n,
                  pend_w + (size_t)(1 + j) * B + b);
    share = engine_refit(s, bb, colsb, rb, n, K);
    __syncthreads();  // the next round's scores read the refit coef
  }
  const float rr = block_sum(share, red_v);
  store_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                     idx + (size_t)b * K, Atb + (size_t)b * K, K);
  if (tid == 0) {
    const float pv = prev[b];
    const bool latch = rr <= delta2 || pv <= rr;
    if (latch) done[b] = 1.f;
    prev[b] = rr;
    fgate[b] = latch ? 0.f : 1.f;
  }
}

}  // namespace cstpu

// SRR's backward stage for all B rows: l deletions back to k atoms. Bs
// (B, n) f32; state cols (B,K,n), Ginv (B,K,K), coef, Atb (B,K) f32, idx
// (B,K) i32, r (B,n) f32, amask (B,m) u8, done, prev, fgate (B,) f32
// updated in place; pending slots 1..l of pend_u (P,B,n) and pend_w (P,B)
// written, P > l. All contiguous. Returns the launch's cudaError_t.
extern "C" int cstpu_engine_delete(const float* Bs, float* cols, float* Ginv,
                                   float* coef, int* idx, float* Atb, float* r,
                                   uint8_t* amask, float* done, float* prev,
                                   float* pend_u, float* pend_w, float* fgate,
                                   int B, int n, int m, int K, int k, int l,
                                   float delta2, void* stream) {
  using namespace cstpu;
  if (l < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = engine_smem_bytes(n, K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(engine_delete_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  engine_delete_kernel<<<B, kEngThreads, smem, st>>>(
      Bs, cols, Ginv, coef, idx, Atb, r, amask, done, prev, pend_u, pend_w,
      fgate, B, n, m, K, k, l, delta2);
  return static_cast<int>(cudaGetLastError());
}
