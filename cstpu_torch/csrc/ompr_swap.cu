// Batched OMPR, stage 2: one replacement iteration per row.
//
// Replaces the body of cstpu/ops/fused_twostage.py::_ompr_kernel
// (:997-1032) after its passive select, which select_argmax.cu's masked
// variant computes. One block per row; a row that is done returns at once
// (the TPU kernel's gated iteration changes nothing there either). Per row:
//   (best, i) = the select partials (B, T) reduced; change = best > 0
//   coef_pre  = coef on the occupied slots (the solution before the append)
//   the gated append of i into the first free slot (engine.cuh)
//   gcoef     = ok ? (coef_pre + eta * cols . r) * occupied : coef, with r
//               still the residual from before the append (:1007-1016)
//   delete the slot of min |gcoef| (lowest slot on ties, only if ok)
//   coef = Ginv Atb, r = b - cols' coef
//   res = ok ? ||r||^2 : prev; done |= !change || res <= delta2 || prev <= res
//   prev = res
//
// What bounds it on an H100: latency: one append (a strided column gather
// and K + 2 dot products of length n), K dot products for the gradient, a
// K x K downdate and the refit, one block per row.
#include "engine.cuh"

namespace cstpu {

template <typename T>
__global__ void __launch_bounds__(kEngThreads)
ompr_swap_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                 int ntiles, const T* __restrict__ A,
                 const float* __restrict__ Bs, float* __restrict__ cols,
                 float* __restrict__ Ginv, float* __restrict__ coef,
                 int* __restrict__ idx, float* __restrict__ Atb,
                 float* __restrict__ r, uint8_t* __restrict__ amask,
                 float* __restrict__ done, float* __restrict__ prev, int n,
                 int m, int K, float rtol, float eta, float delta2) {
  extern __shared__ float smem[];
  __shared__ float red_v[kEngThreads / 32];
  __shared__ int red_i[kEngThreads / 32];
  __shared__ float sc[4];
  __shared__ int s_ok, s_p, s_hasf;
  const EngineSmem s = carve_engine_smem(smem, n, K, sc, &s_ok);

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (done[b] > 0.5f) return;
  const float* bb = Bs + (size_t)b * n;
  float* colsb = cols + (size_t)b * K * n;
  float* rb = r + (size_t)b * n;
  uint8_t* amaskb = amask + (size_t)b * m;

  load_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                    idx + (size_t)b * K, Atb + (size_t)b * K, K);
  float best;
  int sel;
  reduce_partials_row(pval + (size_t)b * ntiles, pidx + (size_t)b * ntiles,
                      ntiles, red_v, red_i, best, sel);
  const bool change = best > 0.f;
  for (int e = tid; e < K; e += blockDim.x) {
    s.v0[e] = s.a.cf[e] * (s.a.ix[e] < m ? 1.f : 0.f);
  }
  __syncthreads();
  const bool ok = engine_append(s, A, bb, colsb, amaskb, n, m, K, sel, change, rtol);

  // gradient of every slot against the pre-append residual
  for (int q = warp; q < K; q += kEngThreads / 32) {
    const float* cs = colsb + (size_t)q * n;
    float acc = 0.f;
    for (int p = lane; p < n; p += 32) acc += cs[p] * rb[p];
    acc = warp_sum(acc);
    if (lane == 0) s.v1[q] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    float dmin = INFINITY;
    for (int e = 0; e < K; ++e) {
      const bool act = s.a.ix[e] < m;
      const float g = ok ? (s.v0[e] + eta * s.v1[e]) * (act ? 1.f : 0.f) : s.a.cf[e];
      const float d2 = (act && ok) ? fabsf(g) : INFINITY;
      s.v1[e] = d2;
      dmin = min_keep_nan(dmin, d2);
    }
    int p = K;
    for (int e = K - 1; e >= 0; --e) p = s.v1[e] == dmin ? e : p;
    s_p = p;
    s_hasf = ok && dmin < INFINITY;
  }
  __syncthreads();
  engine_delete(s, colsb, amaskb, n, m, K, s_p, s_hasf, nullptr, nullptr);
  const float rr = block_sum(engine_refit(s, bb, colsb, rb, n, K), red_v);
  store_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                     idx + (size_t)b * K, Atb + (size_t)b * K, K);
  if (tid == 0) {
    const float pv = prev[b];
    const float res = ok ? rr : pv;
    if (!change || res <= delta2 || pv <= res) done[b] = 1.f;
    prev[b] = res;
  }
}

template <typename T>
int launch_ompr_swap(const float* pval, const int* pidx, int ntiles,
                     const void* A, const float* Bs, float* cols, float* Ginv,
                     float* coef, int* idx, float* Atb, float* r,
                     uint8_t* amask, float* done, float* prev, int B, int n,
                     int m, int K, float rtol, float eta, float delta2,
                     cudaStream_t st) {
  const size_t smem = engine_smem_bytes(n, K);
  cudaFuncSetAttribute(ompr_swap_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ompr_swap_kernel<T><<<B, kEngThreads, smem, st>>>(
      pval, pidx, ntiles, static_cast<const T*>(A), Bs, cols, Ginv, coef, idx,
      Atb, r, amask, done, prev, n, m, K, rtol, eta, delta2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cstpu

// One OMPR iteration for all B rows. pval/pidx (B, ntiles) from the masked
// cstpu_select_argmax; A (n, m) in cdt; Bs (B, n) f32; state cols
// (B,K,n), Ginv (B,K,K), coef, Atb (B,K) f32, idx (B,K) i32, r (B,n) f32,
// amask (B,m) u8, done, prev (B,) f32 updated in place. All contiguous.
// Returns the launch's cudaError_t.
extern "C" int cstpu_ompr_swap(const float* pval, const int* pidx, int ntiles,
                               const void* A, int cdt_bf16, const float* Bs,
                               float* cols, float* Ginv, float* coef, int* idx,
                               float* Atb, float* r, uint8_t* amask,
                               float* done, float* prev, int B, int n, int m,
                               int K, float rtol, float eta, float delta2,
                               void* stream) {
  using namespace cstpu;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    return launch_ompr_swap<__nv_bfloat16>(pval, pidx, ntiles, A, Bs, cols,
                                           Ginv, coef, idx, Atb, r, amask,
                                           done, prev, B, n, m, K, rtol, eta,
                                           delta2, st);
  }
  return launch_ompr_swap<float>(pval, pidx, ntiles, A, Bs, cols, Ginv, coef,
                                 idx, Atb, r, amask, done, prev, B, n, m, K,
                                 rtol, eta, delta2, st);
}
