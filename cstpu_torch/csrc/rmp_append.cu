// Batched RMP and FoBa: one forward step per row, and for FoBa the backward
// deletions that follow it.
//
// Replaces forward_step of cstpu/ops/fused_twostage.py::_rmp_kernel
// (:1287-1299, run to rejection by the forward stage :1314-1336) and the
// body of _foba_kernel (:1447-1476), after their OLS select, which
// fr_select.cu computes from the pending terms. One block per row; a row
// that is done, or whose forward gate is closed, changes nothing and leaves
// zero pending weights. Per row:
//   (dmax, i) = the select partials (B, T) reduced with argmax_combine
//   wanted    = ||r||^2 > floor2 && dmax > delta2 && nactive < min(n, m)
//               (floor2 = 64 n eps^2 ||b||^2, the exhaustion floor)
//   full      = nactive >= K;  capped |= wanted && full: the only rejection
//               the slot cap causes, decided before the append's own tests
//   the append of i into the first free slot, gated by wanted && !full
//   pending slot 0 = (aperp, -dinv), the rescaling downdate of this append
//   coef = Ginv Atb, r = b - cols' coef;  fgate *= ok;  acc |= ok
// and with `foba`, after an accepted append, the deletions while the
// increase stays below max(dmax, 0) / 4 (engine.cuh::engine_backward_loop),
// their restore terms in pending slots 1.., their count in ndel.
//
// What bounds it on an H100: latency, as srr_append.cu: one append, three
// length-n passes, and per deletion a K x K downdate and two more passes.
#include "engine.cuh"

namespace cstpu {

template <typename T>
__global__ void __launch_bounds__(kEngThreads)
rmp_append_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                  int ntiles, const T* __restrict__ A,
                  const float* __restrict__ Bs, float* __restrict__ cols,
                  float* __restrict__ Ginv, float* __restrict__ coef,
                  int* __restrict__ idx, float* __restrict__ Atb,
                  float* __restrict__ r, uint8_t* __restrict__ amask,
                  const float* __restrict__ done, float* __restrict__ pend_u,
                  float* __restrict__ pend_w, float* __restrict__ fgate,
                  float* __restrict__ acc, float* __restrict__ capped,
                  float* __restrict__ ndel, const float* __restrict__ floor2,
                  int B, int n, int m, int K, float rtol, float delta2,
                  int foba) {
  extern __shared__ float smem[];
  __shared__ float red_v[kEngThreads / 32];
  __shared__ int red_i[kEngThreads / 32];
  __shared__ float sc[4];
  __shared__ int s_ok, s_p, s_acc;
  const EngineSmem s = carve_engine_smem(smem, n, K, sc, &s_ok);

  const int b = blockIdx.x, tid = threadIdx.x;
  float* ub = pend_u + (size_t)b * n;
  if (done[b] > 0.5f || fgate[b] < 0.5f) {
    for (int p = tid; p < n; p += blockDim.x) ub[p] = 0.f;
    const int last = foba ? K : 0;
    for (int e = tid; e <= last; e += blockDim.x) pend_w[(size_t)e * B + b] = 0.f;
    if (foba && tid == 0) ndel[b] = 0.f;
    return;
  }
  const float* bb = Bs + (size_t)b * n;
  float* colsb = cols + (size_t)b * K * n;
  float* rb = r + (size_t)b * n;
  uint8_t* amaskb = amask + (size_t)b * m;

  load_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                    idx + (size_t)b * K, Atb + (size_t)b * K, K);
  float dmax;
  int sel;
  reduce_partials_row(pval + (size_t)b * ntiles, pidx + (size_t)b * ntiles,
                      ntiles, red_v, red_i, dmax, sel);
  float rr = 0.f;
  for (int p = tid; p < n; p += blockDim.x) rr += rb[p] * rb[p];
  rr = block_sum(rr, red_v);
  const int nat = engine_nactive(s, K, m);
  const bool wanted = rr > floor2[b] && dmax > delta2 && nat < min(n, m);
  const bool full = nat >= K;
  if (tid == 0 && wanted && full) capped[b] = 1.f;
  const bool ok = engine_append(s, A, bb, colsb, amaskb, n, m, K, sel,
                                wanted && !full, rtol);
  engine_aperp(s, colsb, ub, n, K);
  if (tid == 0) pend_w[b] = -s.a.sc[2];
  engine_refit(s, bb, colsb, rb, n, K);
  __syncthreads();
  if (foba) {
    int nd = 0;
    if (ok) {
      const float thr = max_keep_nan(dmax, 0.f) * 0.25f;
      nd = engine_backward_loop(s, bb, colsb, rb, amaskb, pend_u, pend_w, B, b,
                                n, m, K, thr, -1, &s_p, &s_acc);
    } else {
      for (int e = 1 + tid; e <= K; e += blockDim.x) pend_w[(size_t)e * B + b] = 0.f;
    }
    if (tid == 0) ndel[b] = (float)nd;
  }
  store_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                     idx + (size_t)b * K, Atb + (size_t)b * K, K);
  if (tid == 0) {
    if (ok) acc[b] = 1.f;
    else fgate[b] = 0.f;
  }
}

template <typename T>
int launch_rmp_append(const float* pval, const int* pidx, int ntiles,
                      const void* A, const float* Bs, float* cols, float* Ginv,
                      float* coef, int* idx, float* Atb, float* r,
                      uint8_t* amask, const float* done, float* pend_u,
                      float* pend_w, float* fgate, float* acc, float* capped,
                      float* ndel, const float* floor2, int B, int n, int m,
                      int K, float rtol, float delta2, int foba,
                      cudaStream_t st) {
  const size_t smem = engine_smem_bytes(n, K);
  cudaFuncSetAttribute(rmp_append_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  rmp_append_kernel<T><<<B, kEngThreads, smem, st>>>(
      pval, pidx, ntiles, static_cast<const T*>(A), Bs, cols, Ginv, coef, idx,
      Atb, r, amask, done, pend_u, pend_w, fgate, acc, capped, ndel, floor2, B,
      n, m, K, rtol, delta2, foba);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cstpu

// One RMP forward step (foba = 0) or one FoBa iteration (foba = 1) for all B
// rows. pval/pidx (B, ntiles) from cstpu_fr_select; A (n, m) in cdt; Bs
// (B, n) f32; state cols (B,K,n), Ginv (B,K,K), coef, Atb (B,K) f32, idx
// (B,K) i32, r (B,n) f32, amask (B,m) u8, fgate, acc, capped, ndel (B,) f32
// updated in place, done and floor2 (B,) f32 read; pending slot 0 (foba:
// slots 0..K) of pend_u (P,B,n) and pend_w (P,B) written, P >= K + 1. All
// contiguous. Returns the launch's cudaError_t.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    return launch_rmp_append<__nv_bfloat16>(
        pval, pidx, ntiles, A, Bs, cols, Ginv, coef, idx, Atb, r, amask, done,
        pend_u, pend_w, fgate, acc, capped, ndel, floor2, B, n, m, K, rtol,
        delta2, foba, st);
  }
  return launch_rmp_append<float>(pval, pidx, ntiles, A, Bs, cols, Ginv, coef,
                                  idx, Atb, r, amask, done, pend_u, pend_w,
                                  fgate, acc, capped, ndel, floor2, B, n, m, K,
                                  rtol, delta2, foba, st);
}
