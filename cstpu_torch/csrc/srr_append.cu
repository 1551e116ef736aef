// Batched SRR, stage 2: one forward step per row.
//
// Replaces forward_step of cstpu/ops/fused_twostage.py::_srr_kernel
// (:1135-1144, run l times per iteration by :1156-1160) after its OLS
// select, which fr_select.cu computes from the pending terms. One block
// per row; a row that is done, or whose forward gate closed earlier in the
// iteration, changes nothing and leaves a zero pending term. Per row:
//   (dmax, i) = the select partials (B, T) reduced with argmax_combine
//   gate      = ||r||^2 > 0 && dmax > 0 && nactive < min(n, m)
//   the gated append of i into the first free slot (engine.cuh)
//   pending slot 0 = (aperp, -dinv): the rescaling downdate of this append,
//               for the next fr_select (the TPU kernel's z GEMM, :183-189)
//   coef = Ginv Atb, r = b - cols' coef;  fgate *= ok
//
// What bounds it on an H100: latency, as fr_append.cu: one append and three
// length-n passes per row.
#include "engine.cuh"

namespace cstpu {

template <typename T>
__global__ void __launch_bounds__(kEngThreads)
srr_append_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                  int ntiles, const T* __restrict__ A,
                  const float* __restrict__ Bs, float* __restrict__ cols,
                  float* __restrict__ Ginv, float* __restrict__ coef,
                  int* __restrict__ idx, float* __restrict__ Atb,
                  float* __restrict__ r, uint8_t* __restrict__ amask,
                  float* __restrict__ done, float* __restrict__ pend_u,
                  float* __restrict__ pend_w, float* __restrict__ fgate,
                  int n, int m, int K, float rtol) {
  extern __shared__ float smem[];
  __shared__ float red_v[kEngThreads / 32];
  __shared__ int red_i[kEngThreads / 32];
  __shared__ float sc[4];
  __shared__ int s_ok;
  const EngineSmem s = carve_engine_smem(smem, n, K, sc, &s_ok);

  const int b = blockIdx.x, tid = threadIdx.x;
  float* ub = pend_u + (size_t)b * n;
  if (done[b] > 0.5f || fgate[b] < 0.5f) {
    for (int p = tid; p < n; p += blockDim.x) ub[p] = 0.f;
    if (tid == 0) pend_w[b] = 0.f;
    return;
  }
  const float* bb = Bs + (size_t)b * n;
  float* colsb = cols + (size_t)b * K * n;
  float* rb = r + (size_t)b * n;

  load_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                    idx + (size_t)b * K, Atb + (size_t)b * K, K);
  float dmax;
  int sel;
  reduce_partials_row(pval + (size_t)b * ntiles, pidx + (size_t)b * ntiles,
                      ntiles, red_v, red_i, dmax, sel);
  float rr = 0.f;
  for (int p = tid; p < n; p += blockDim.x) rr += rb[p] * rb[p];
  rr = block_sum(rr, red_v);
  const bool gate = rr > 0.f && dmax > 0.f && engine_nactive(s, K, m) < min(n, m);
  const bool ok = engine_append(s, A, bb, colsb, amask + (size_t)b * m, n, m, K,
                                sel, gate, rtol);
  engine_aperp(s, colsb, ub, n, K);
  if (tid == 0) pend_w[b] = -s.a.sc[2];
  engine_refit(s, bb, colsb, rb, n, K);
  store_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                     idx + (size_t)b * K, Atb + (size_t)b * K, K);
  if (tid == 0 && !ok) fgate[b] = 0.f;
}

template <typename T>
int launch_srr_append(const float* pval, const int* pidx, int ntiles,
                      const void* A, const float* Bs, float* cols, float* Ginv,
                      float* coef, int* idx, float* Atb, float* r,
                      uint8_t* amask, float* done, float* pend_u, float* pend_w,
                      float* fgate, int B, int n, int m, int K, float rtol,
                      cudaStream_t st) {
  const size_t smem = engine_smem_bytes(n, K);
  cudaFuncSetAttribute(srr_append_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  srr_append_kernel<T><<<B, kEngThreads, smem, st>>>(
      pval, pidx, ntiles, static_cast<const T*>(A), Bs, cols, Ginv, coef, idx,
      Atb, r, amask, done, pend_u, pend_w, fgate, n, m, K, rtol);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cstpu

// One SRR forward step for all B rows. pval/pidx (B, ntiles) from
// cstpu_fr_select; A (n, m) in cdt; Bs (B, n) f32; state cols (B,K,n), Ginv
// (B,K,K), coef, Atb (B,K) f32, idx (B,K) i32, r (B,n) f32, amask (B,m) u8,
// fgate (B,) f32 updated in place, done (B,) read; pending slot 0 of pend_u
// (P,B,n) and pend_w (P,B) written. All contiguous. Returns the launch's
// cudaError_t.
extern "C" int cstpu_srr_append(const float* pval, const int* pidx, int ntiles,
                                const void* A, int cdt_bf16, const float* Bs,
                                float* cols, float* Ginv, float* coef, int* idx,
                                float* Atb, float* r, uint8_t* amask,
                                float* done, float* pend_u, float* pend_w,
                                float* fgate, int B, int n, int m, int K,
                                float rtol, void* stream) {
  using namespace cstpu;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    return launch_srr_append<__nv_bfloat16>(pval, pidx, ntiles, A, Bs, cols,
                                            Ginv, coef, idx, Atb, r, amask,
                                            done, pend_u, pend_w, fgate, B, n,
                                            m, K, rtol, st);
  }
  return launch_srr_append<float>(pval, pidx, ntiles, A, Bs, cols, Ginv, coef,
                                  idx, Atb, r, amask, done, pend_u, pend_w,
                                  fgate, B, n, m, K, rtol, st);
}
