// Batched GOMP, stage 2: one iteration's gated appends, the residual and
// the epsilon latch.
//
// Replaces the appends and the iteration tail of cstpu/ops/fused_solve.py::
// _gomp_kernel (:749-798). One launch is one iteration of `cnt` picks (l,
// or k % l for the remainder iteration, whose latch the host discards).
// Per row b, with state in device memory (cols (B,k,n), Ginv (B,k,k),
// coef (B,k), idx (B,k), r (B,n), kcnt (B,), done (B,)):
//   picks = the row's top-cnt of the select_topl partials (B, T, cnt) by
//           value descending, then index ascending; a NaN among them makes
//           every pick INT_MAX (the TPU kernel's smax/== rule, :752-755)
//   for each pick in that order, into slot kcnt:
//     pre = kcnt < cap && !done; the gated bordered append of common.cuh
//     (dup, d > rtol*ata, Ginv, coef, idx, cols); kcnt += ok
//     (a rejected pick still uses up its place in the top-cnt, as :755)
//   r = b - cols'coef; done = (||r||^2 < eps2 || kcnt >= n) ? 1 : done
// The slots come back in insertion order; the host sorts them by atom
// index (cstpu sorts in XLA after its kernel too, :63-95).
//
// What bounds it on an H100: latency, as omp_append.cu: cnt dependent
// appends per launch, each a few dot products of length n per row. Design:
// one block per row, Ginv/coef/idx in shared memory across the cnt appends
// (written back once); the merge of the T*cnt partials is common.cuh::
// merge_topl_row: each warp sorts its share as 64-bit keys into a top 32,
// and the warps' lists meet in a tree of merges (three block barriers).
#include "common.cuh"

namespace cstpu {

constexpr int kGompThreads = 256;

// One block per row, so minBlocks = 1: ptxas then gives the append loops
// the registers to keep their loads in flight (left to aim at more blocks
// an SM, it built this kernel with 32 registers, and the loops of
// common.cuh::bordered_append and residual_row had 4 loads in flight).
template <typename T>
__global__ void __launch_bounds__(kGompThreads, 1)
gomp_append_kernel(const float* __restrict__ pval,
                   const int* __restrict__ pidx, int ntiles, int cnt,
                   const T* __restrict__ A, const float* __restrict__ Bs,
                   float* __restrict__ cols, float* __restrict__ Ginv,
                   float* __restrict__ coef, int* __restrict__ idx,
                   float* __restrict__ r, int* __restrict__ kcnt,
                   float* __restrict__ done, int n, int m, int k, int cap,
                   float rtol, float eps2) {
  extern __shared__ float smem[];
  __shared__ float red_v[kGompThreads / 32];
  __shared__ TopKey mkeys[kGompThreads];
  __shared__ float sc[4];
  __shared__ int s_ok, s_kcnt;
  __shared__ int picks[kTopLMax];
  __shared__ float vals[kTopLMax];
  const AppendSmem s = carve_append_smem(smem, n, k, sc, &s_ok);

  const int b = blockIdx.x, tid = threadIdx.x;
  const float* bb = Bs + (size_t)b * n;
  float* colsb = cols + (size_t)b * k * n;
  float* Gb = Ginv + (size_t)b * k * k;
  float* coefb = coef + (size_t)b * k;
  int* idxb = idx + (size_t)b * k;
  const float* pvb = pval + (size_t)b * ntiles * cnt;
  const int* pib = pidx + (size_t)b * ntiles * cnt;
  const int ncand = ntiles * cnt;

  load_append_state(s, Gb, coefb, idxb, k);
  if (tid == 0) s_kcnt = kcnt[b];

  // --- merge the partials into the row's top-cnt ---------------------------
  merge_topl_row(pvb, pib, ncand, cnt, picks, vals, mkeys);

  // --- the gated appends, in pick order ------------------------------------
  const bool latched = done[b] > 0.5f;
  for (int p = 0; p < cnt; ++p) {
    const int slot = s_kcnt;
    const bool ok = bordered_append(s, A, bb, colsb, n, m, k, picks[p], slot,
                                    slot, slot < cap && !latched, rtol);
    if (tid == 0 && ok) s_kcnt = slot + 1;
    __syncthreads();
  }

  store_append_state(s, Gb, coefb, idxb, k);
  const float rr = block_sum(residual_row(r + (size_t)b * n, bb, colsb, s.cf, n, k), red_v);
  if (tid == 0) {
    kcnt[b] = s_kcnt;
    if (rr < eps2 || s_kcnt >= n) done[b] = 1.f;
  }
}

}  // namespace cstpu

// One GOMP iteration of cnt picks for all B rows. pval/pidx (B, ntiles,
// cnt) from cstpu_select_topl; A (n, m) in cdt; Bs (B, n) f32; state cols
// (B,k,n), Ginv (B,k,k), coef (B,k) f32, idx (B,k) i32, kcnt (B,) i32 and
// done (B,) f32 updated in place, r (B,n) f32 overwritten. All contiguous,
// 1 <= cnt <= kTopLMax. Returns the launch's cudaError_t.
extern "C" int cstpu_gomp_append(const float* pval, const int* pidx,
                                 int ntiles, int cnt, const void* A,
                                 int cdt_bf16, const float* Bs, float* cols,
                                 float* Ginv, float* coef, int* idx, float* r,
                                 int* kcnt, float* done, int B, int n, int m,
                                 int k, int cap, float rtol, float eps2,
                                 void* stream) {
  using namespace cstpu;
  if (cnt < 1 || cnt > kTopLMax) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = append_smem_bytes(n, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    cudaFuncSetAttribute(gomp_append_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    prefer_l1(gomp_append_kernel<__nv_bfloat16>);
    gomp_append_kernel<__nv_bfloat16><<<B, kGompThreads, smem, st>>>(
        pval, pidx, ntiles, cnt, static_cast<const __nv_bfloat16*>(A), Bs,
        cols, Ginv, coef, idx, r, kcnt, done, n, m, k, cap, rtol, eps2);
  } else {
    cudaFuncSetAttribute(gomp_append_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    prefer_l1(gomp_append_kernel<float>);
    gomp_append_kernel<float><<<B, kGompThreads, smem, st>>>(
        pval, pidx, ntiles, cnt, static_cast<const float*>(A), Bs, cols,
        Ginv, coef, idx, r, kcnt, done, n, m, k, cap, rtol, eps2);
  }
  return static_cast<int>(cudaGetLastError());
}
