// Batched OMP, stages 2 and 3: append the selected atom, refit, update the
// residual, and at the last step emit the support sorted by atom index.
//
// Replaces the append and epilogue of cstpu/ops/fused_solve.py::
// _solve_kernel (:165-234) and the sweep-end append of ::_stream_kernel
// (:387-421). One launch is one OMP step t; slot t is written (no
// deletions), so the slot equals the step.
//
// Per row b, with state in device memory (cols (B,k,n), Ginv (B,k,k),
// coef (B,k), idx (B,k), r (B,n)):
//   i     = argmax over the select kernel's (B, T) partials, lowest index on
//           ties, INT_MAX when the row's maximum is NaN (common.cuh)
//   the gated bordered append of i into slot t (common.cuh::
//   bordered_append: cdt-rounded column, dup/degeneracy gate, Ginv, coef,
//   idx, cols), then r = b - cols'coef
//   at t = k-1: rank sort of (idx, coef), pads (idx m) last, ties by slot
// All of it in f32, with _degeneracy_rtol(n) in f32 whatever the cdt.
//
// What bounds it on an H100: per step it reads k*n + 2n floats of state and
// one strided dictionary column per row, a few hundred KB at B=64, n=1024,
// k=32: latency, not bandwidth or arithmetic, bounds it. Design: one block
// per row; a warp per dot product; the small k x k Ginv, g, u, coef and idx
// staged in shared memory (KMAX = 128 slots: 64 KB of Ginv), the gathered
// column too. The column is gathered from A directly, strided by m (n
// loads per row per step); the TPU kernel's aligned 8-row gather from a
// transposed copy (:99-124, :244-245) is a TPU workaround not carried over.
#include "common.cuh"

namespace cstpu {

constexpr int kAppendThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kAppendThreads)
omp_append_kernel(const float* __restrict__ pval,
                  const int* __restrict__ pidx, int ntiles,
                  const T* __restrict__ A, const float* __restrict__ Bs,
                  float* __restrict__ cols, float* __restrict__ Ginv,
                  float* __restrict__ coef, int* __restrict__ idx,
                  float* __restrict__ r, int* __restrict__ out_idx,
                  float* __restrict__ out_coef, int n, int m, int k, int t,
                  float rtol) {
  extern __shared__ float smem[];
  __shared__ float red_v[kAppendThreads / 32];
  __shared__ int red_i[kAppendThreads / 32];
  __shared__ float sc[4];
  __shared__ int s_ok;
  const AppendSmem s = carve_append_smem(smem, n, k, sc, &s_ok);

  const int b = blockIdx.x, tid = threadIdx.x;
  const float* bb = Bs + (size_t)b * n;
  float* colsb = cols + (size_t)b * k * n;
  float* Gb = Ginv + (size_t)b * k * k;
  float* coefb = coef + (size_t)b * k;
  int* idxb = idx + (size_t)b * k;

  load_append_state(s, Gb, coefb, idxb, k);
  float v;
  int sel;
  reduce_partials_row(pval + (size_t)b * ntiles, pidx + (size_t)b * ntiles,
                      ntiles, red_v, red_i, v, sel);

  bordered_append(s, A, bb, colsb, n, m, k, sel, t, t, true, rtol);
  store_append_state(s, Gb, coefb, idxb, k);
  residual_row(r + (size_t)b * n, bb, colsb, s.cf, n, k);

  // --- last step: emit (idx, coef) sorted by atom index -------------------
  if (t == k - 1 && tid < k) {
    const int key = s.ix[tid];
    int rank = 0;
    for (int c = 0; c < k; ++c) {
      const int kc = s.ix[c];
      rank += (kc < key) || (kc == key && c < tid);
    }
    out_idx[(size_t)b * k + rank] = key;
    out_coef[(size_t)b * k + rank] = s.cf[tid];
  }
}

}  // namespace cstpu

// One OMP step t for all B rows. pval/pidx (B, ntiles) from
// cstpu_select_argmax; A (n, m) in cdt; Bs (B, n) f32; state cols (B,k,n),
// Ginv (B,k,k), coef (B,k) f32 and idx (B,k) i32 updated in place, r (B,n)
// f32 overwritten; at t = k-1 out_idx/out_coef (B,k) get the sorted
// support. All contiguous. Returns the launch's cudaError_t.
extern "C" int cstpu_omp_append(const float* pval, const int* pidx,
                                int ntiles, const void* A, int cdt_bf16,
                                const float* Bs, float* cols, float* Ginv,
                                float* coef, int* idx, float* r, int* out_idx,
                                float* out_coef, int B, int n, int m, int k,
                                int t, float rtol, void* stream) {
  using namespace cstpu;
  const size_t smem = append_smem_bytes(n, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    cudaFuncSetAttribute(omp_append_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    omp_append_kernel<__nv_bfloat16><<<B, kAppendThreads, smem, st>>>(
        pval, pidx, ntiles, static_cast<const __nv_bfloat16*>(A), Bs, cols,
        Ginv, coef, idx, r, out_idx, out_coef, n, m, k, t, rtol);
  } else {
    cudaFuncSetAttribute(omp_append_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    omp_append_kernel<float><<<B, kAppendThreads, smem, st>>>(
        pval, pidx, ntiles, static_cast<const float*>(A), Bs, cols, Ginv,
        coef, idx, r, out_idx, out_coef, n, m, k, t, rtol);
  }
  return static_cast<int>(cudaGetLastError());
}
