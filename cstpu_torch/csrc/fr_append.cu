// Batched forward regression (FR), stage 2: the stopping rules, the gated
// append, the orthogonal column for the next rescaling downdate, the
// residual and the stop latch.
//
// Replaces :578-622 of cstpu/ops/fused_solve.py::_fr_kernel. One launch is
// one FR step t; slot t is written (no deletions). Per row b:
//   (dmax, i) = the fr_select partials (B, T) reduced with argmax_combine
//   accept    = ||r||^2 > max_eps2 && dmax > min_d2   (r before the step;
//               a NaN row has dmax NaN, so it never accepts)
//   the gated bordered append of i into slot t with pre = accept && !done
//   (common.cuh: dup, d > rtol*ata, Ginv, coef, idx, cols)
//   aperp = acol - sum_s cols[s] u[s], after slot t is written (:614), and
//   dinv go to the next fr_select, which downdates resc with them
//   amask[b, i] = 1 if ok;  r = b - cols'coef;  done = ok ? done : 1
// max_eps2 = max_residual^2 and min_d2 = min_decrease^2 are run-time
// arguments, as the TPU kernel reads them from an operand (:553-554). The
// slots come back in insertion order; the host sorts them by atom index.
//
// What bounds it on an H100: latency, as omp_append.cu (one append and
// three length-n passes per row per step). Design: omp_append.cu's, one
// block per row; aperp is written straight to device memory, so the
// shared-memory budget is omp_append's (n + k*k + 4k words).
#include <cstdint>

#include "common.cuh"

namespace cstpu {

constexpr int kFrThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kFrThreads)
fr_append_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                 int ntiles, const T* __restrict__ A,
                 const float* __restrict__ Bs, float* __restrict__ cols,
                 float* __restrict__ Ginv, float* __restrict__ coef,
                 int* __restrict__ idx, float* __restrict__ r,
                 float* __restrict__ aperp, float* __restrict__ dinv,
                 uint8_t* __restrict__ amask, float* __restrict__ done, int n,
                 int m, int k, int t, float rtol, float max_eps2,
                 float min_d2) {
  extern __shared__ float smem[];
  __shared__ float red_v[kFrThreads / 32];
  __shared__ int red_i[kFrThreads / 32];
  __shared__ float sc[4];
  __shared__ int s_ok;
  const AppendSmem s = carve_append_smem(smem, n, k, sc, &s_ok);

  const int b = blockIdx.x, tid = threadIdx.x;
  const float* bb = Bs + (size_t)b * n;
  float* rb = r + (size_t)b * n;
  float* colsb = cols + (size_t)b * k * n;
  float* Gb = Ginv + (size_t)b * k * k;
  float* coefb = coef + (size_t)b * k;
  int* idxb = idx + (size_t)b * k;

  load_append_state(s, Gb, coefb, idxb, k);
  float dmax;
  int sel;
  reduce_partials_row(pval + (size_t)b * ntiles, pidx + (size_t)b * ntiles,
                      ntiles, red_v, red_i, dmax, sel);
  float rr = 0.f;
  for (int p = tid; p < n; p += blockDim.x) rr += rb[p] * rb[p];
  rr = block_sum(rr, red_v);

  const bool accept = (rr > max_eps2) && (dmax > min_d2);
  const bool latched = done[b] > 0.5f;
  const bool ok = bordered_append(s, A, bb, colsb, n, m, k, sel, t, t,
                                  accept && !latched, rtol);

  // a_perp with slot t written, as the TPU kernel orders it
  float* ab = aperp + (size_t)b * n;
  for (int p = tid; p < n; p += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < k; ++q) acc += colsb[(size_t)q * n + p] * s.u[q];
    ab[p] = s.acol[p] - acc;
  }
  store_append_state(s, Gb, coefb, idxb, k);
  residual_row(rb, bb, colsb, s.cf, n, k);
  if (tid == 0) {
    dinv[b] = s.sc[2];
    if (!ok) done[b] = 1.f;
    else if (sel < m) amask[(size_t)b * m + sel] = 1;
  }
}

}  // namespace cstpu

// One FR step t for all B rows. pval/pidx (B, ntiles) from
// cstpu_fr_select; A (n, m) in cdt; Bs (B, n) f32; state cols (B,k,n),
// Ginv (B,k,k), coef (B,k) f32, idx (B,k) i32, amask (B,m) u8 and done
// (B,) f32 updated in place; r, aperp (B,n) and dinv (B,) f32 overwritten.
// All contiguous. Returns the launch's cudaError_t.
extern "C" int cstpu_fr_append(const float* pval, const int* pidx, int ntiles,
                               const void* A, int cdt_bf16, const float* Bs,
                               float* cols, float* Ginv, float* coef, int* idx,
                               float* r, float* aperp, float* dinv,
                               uint8_t* amask, float* done, int B, int n,
                               int m, int k, int t, float rtol, float max_eps2,
                               float min_d2, void* stream) {
  using namespace cstpu;
  const size_t smem = append_smem_bytes(n, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    cudaFuncSetAttribute(fr_append_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    fr_append_kernel<__nv_bfloat16><<<B, kFrThreads, smem, st>>>(
        pval, pidx, ntiles, static_cast<const __nv_bfloat16*>(A), Bs, cols,
        Ginv, coef, idx, r, aperp, dinv, amask, done, n, m, k, t, rtol,
        max_eps2, min_d2);
  } else {
    cudaFuncSetAttribute(fr_append_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    fr_append_kernel<float><<<B, kFrThreads, smem, st>>>(
        pval, pidx, ntiles, static_cast<const float*>(A), Bs, cols, Ginv,
        coef, idx, r, aperp, dinv, amask, done, n, m, k, t, rtol, max_eps2,
        min_d2);
  }
  return static_cast<int>(cudaGetLastError());
}
