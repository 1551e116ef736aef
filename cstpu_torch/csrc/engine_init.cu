// Batched OMPR and SRR, the init: the oblivious acquisition of the slot
// engine, its refit and the first residual norm.
//
// Replaces cstpu/ops/fused_twostage.py::_Engine.oblivious_init (:225-238)
// and the start of _outer_while (:246) in _ompr_kernel and _srr_kernel.
// The TPU kernel takes the row's top-k of |round_cdt(b) . A| one by one (the
// lowest-index maximum, then masked out) and appends each, gated by a
// finite score, into the first free slot. Here select_topl.cu has written
// per-tile top-k partials, and one block per row:
//   picks = the row's top-cnt of the partials, value descending, index
//           ascending (common.cuh::merge_topl_row, warp sorts and a tree
//           of merges; a NaN row makes none)
//   cnt gated appends in that order (engine.cuh::engine_append: duplicate,
//           capacity and d > rtol * ata gates; Atb, amask)
//   SRR: each append's rescaling term (aperp, -dinv) into pending slot j,
//           for the first fr_select to apply
//   coef = Ginv Atb, r = b - cols' coef; prev = ||r||^2, done = 0 (fgate = 1)
// on the empty state the host made (r = b, cols 0, Ginv = I, idx = m).
//
// What bounds it on an H100: latency: cnt dependent appends per row, each a
// strided column gather and K + 2 dot products of length n (K = k+1 for
// OMPR, k+l for SRR), one block per row. It runs once per solve.
#include "engine.cuh"

namespace cstpu {

// One block per row, so minBlocks = 1, as gomp_append.cu: the append
// loops get the registers to keep their loads in flight.
template <typename T>
__global__ void __launch_bounds__(kEngThreads, 1)
engine_init_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                   int ntiles, int cnt, const T* __restrict__ A,
                   const float* __restrict__ Bs, float* __restrict__ cols,
                   float* __restrict__ Ginv, float* __restrict__ coef,
                   int* __restrict__ idx, float* __restrict__ Atb,
                   float* __restrict__ r, uint8_t* __restrict__ amask,
                   float* __restrict__ done, float* __restrict__ prev,
                   float* __restrict__ pend_u, float* __restrict__ pend_w,
                   float* __restrict__ fgate, int B, int n, int m, int K,
                   float rtol) {
  extern __shared__ float smem[];
  __shared__ float red_v[kEngThreads / 32];
  __shared__ TopKey mkeys[kEngThreads];
  __shared__ float sc[4];
  __shared__ int s_ok;
  __shared__ int picks[kTopLMax];
  __shared__ float vals[kTopLMax];
  const EngineSmem s = carve_engine_smem(smem, n, K, sc, &s_ok);

  const int b = blockIdx.x, tid = threadIdx.x;
  const float* bb = Bs + (size_t)b * n;
  float* colsb = cols + (size_t)b * K * n;
  uint8_t* amaskb = amask + (size_t)b * m;

  load_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                    idx + (size_t)b * K, Atb + (size_t)b * K, K);
  merge_topl_row(pval + (size_t)b * ntiles * cnt, pidx + (size_t)b * ntiles * cnt,
                 ntiles * cnt, cnt, picks, vals, mkeys);
  for (int j = 0; j < cnt; ++j) {
    engine_append(s, A, bb, colsb, amaskb, n, m, K, picks[j], vals[j] > -INFINITY, rtol);
    if (pend_u) {
      engine_aperp(s, colsb, pend_u + ((size_t)j * B + b) * n, n, K);
      if (tid == 0) pend_w[(size_t)j * B + b] = -s.a.sc[2];
      __syncthreads();  // the next append overwrites acol and u
    }
  }
  const float rr = block_sum(engine_refit(s, bb, colsb, r + (size_t)b * n, n, K), red_v);
  store_engine_state(s, Ginv + (size_t)b * K * K, coef + (size_t)b * K,
                     idx + (size_t)b * K, Atb + (size_t)b * K, K);
  if (tid == 0) {
    prev[b] = rr;
    done[b] = 0.f;
    if (fgate) fgate[b] = 1.f;
  }
}

template <typename T>
int launch_engine_init(const float* pval, const int* pidx, int ntiles, int cnt,
                       const void* A, const float* Bs, float* cols, float* Ginv,
                       float* coef, int* idx, float* Atb, float* r,
                       uint8_t* amask, float* done, float* prev, float* pend_u,
                       float* pend_w, float* fgate, int B, int n, int m, int K,
                       float rtol, cudaStream_t st) {
  const size_t smem = engine_smem_bytes(n, K);
  cudaFuncSetAttribute(engine_init_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  prefer_l1(engine_init_kernel<T>);
  engine_init_kernel<T><<<B, kEngThreads, smem, st>>>(
      pval, pidx, ntiles, cnt, static_cast<const T*>(A), Bs, cols, Ginv, coef,
      idx, Atb, r, amask, done, prev, pend_u, pend_w, fgate, B, n, m, K, rtol);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cstpu

// The init of OMPR or SRR for all B rows. pval/pidx (B, ntiles, cnt) from
// cstpu_select_topl on the measurements; A (n, m) in cdt; Bs (B, n) f32;
// the empty state cols (B,K,n), Ginv (B,K,K), coef, Atb (B,K) f32, idx
// (B,K) i32, r (B,n) f32, amask (B,m) u8, done, prev (B,) f32 updated in
// place; SRR also pend_u (P,B,n), pend_w (P,B) with P >= cnt and fgate
// (B,), all null for OMPR. All contiguous, 1 <= cnt <= min(kTopLMax, K).
// Returns the launch's cudaError_t.
extern "C" int cstpu_engine_init(const float* pval, const int* pidx, int ntiles,
                                 int cnt, const void* A, int cdt_bf16,
                                 const float* Bs, float* cols, float* Ginv,
                                 float* coef, int* idx, float* Atb, float* r,
                                 uint8_t* amask, float* done, float* prev,
                                 float* pend_u, float* pend_w, float* fgate,
                                 int B, int n, int m, int K, float rtol,
                                 void* stream) {
  using namespace cstpu;
  if (cnt < 1 || cnt > kTopLMax || cnt > K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    return launch_engine_init<__nv_bfloat16>(
        pval, pidx, ntiles, cnt, A, Bs, cols, Ginv, coef, idx, Atb, r, amask,
        done, prev, pend_u, pend_w, fgate, B, n, m, K, rtol, st);
  }
  return launch_engine_init<float>(
      pval, pidx, ntiles, cnt, A, Bs, cols, Ginv, coef, idx, Atb, r, amask,
      done, prev, pend_u, pend_w, fgate, B, n, m, K, rtol, st);
}
