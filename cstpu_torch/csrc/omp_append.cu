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
//   acol  = A[:, min(i, m-1)] of the cdt-rounded dictionary, upcast to f32:
//           both TPU kernels solve the cdt-rounded problem exactly (:30-35)
//   ata, beta, g, u = Ginv g, d = ata - g.u, ok = !dup && d > rtol*ata
//   bordered Ginv update with w = u - e_t and the okf gating (:189-193),
//   coef -= s w, idx[t] = i if ok, cols[t] = acol * okf, r = b - cols'coef
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
  float* acol = smem;      // n
  float* Gs = acol + n;    // k * k
  float* g = Gs + k * k;   // k
  float* u = g + k;        // k
  float* cf = u + k;       // k
  int* ix = reinterpret_cast<int*>(cf + k);  // k
  __shared__ float red_v[kAppendThreads / 32];
  __shared__ int red_i[kAppendThreads / 32];
  __shared__ float sc[4];  // ata, beta, dinv, s
  __shared__ int s_sel, s_ok;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const float* pvb = pval + (size_t)b * ntiles;
  const int* pib = pidx + (size_t)b * ntiles;
  const float* bb = Bs + (size_t)b * n;
  float* colsb = cols + (size_t)b * k * n;
  float* Gb = Ginv + (size_t)b * k * k;
  float* coefb = coef + (size_t)b * k;
  int* idxb = idx + (size_t)b * k;
  float* rb = r + (size_t)b * n;

  // --- reduce the select partials; stage the small state ----------------
  float v = -INFINITY;
  int i = INT_MAX;
  for (int e = tid; e < ntiles; e += blockDim.x) argmax_combine(v, i, pvb[e], pib[e]);
  warp_argmax(v, i);
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  for (int e = tid; e < k * k; e += blockDim.x) Gs[e] = Gb[e];
  for (int e = tid; e < k; e += blockDim.x) {
    cf[e] = coefb[e];
    ix[e] = idxb[e];
  }
  __syncthreads();
  if (tid == 0) {
    v = red_v[0];
    i = red_i[0];
    for (int w = 1; w < nwarps; ++w) argmax_combine(v, i, red_v[w], red_i[w]);
    s_sel = i;
  }
  __syncthreads();
  const int sel = s_sel;
  const int ic = min(sel, m - 1);  // a NaN row selects INT_MAX

  // --- gather the cdt-rounded column -------------------------------------
  for (int p = tid; p < n; p += blockDim.x) acol[p] = to_f32(A[(size_t)p * m + ic]);
  __syncthreads();

  // --- g = cols . acol (slots >= t are still zero), ata, beta ------------
  for (int s = warp; s < k + 2; s += nwarps) {
    float acc = 0.f;
    if (s < t) {
      const float* cs = colsb + (size_t)s * n;
      for (int p = lane; p < n; p += 32) acc += cs[p] * acol[p];
    } else if (s == k) {
      for (int p = lane; p < n; p += 32) acc += acol[p] * acol[p];
    } else if (s == k + 1) {
      for (int p = lane; p < n; p += 32) acc += acol[p] * bb[p];
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      if (s < k) g[s] = acc;
      else sc[s - k] = acc;
    }
  }
  __syncthreads();

  if (tid < k) {
    float acc = 0.f;
    for (int c = 0; c < k; ++c) acc += Gs[tid * k + c] * g[c];
    u[tid] = acc;
  }
  __syncthreads();

  // --- gate and step scalars ----------------------------------------------
  if (tid == 0) {
    float gu = 0.f, gc = 0.f;
    bool dup = false;
    for (int c = 0; c < k; ++c) {
      gu += g[c] * u[c];
      gc += g[c] * cf[c];
      dup |= (ix[c] == sel);
    }
    const float ata = sc[0], beta = sc[1];
    const float d = ata - gu;
    const bool ok = !dup && (d > rtol * ata);
    const float okf = ok ? 1.f : 0.f;
    const float dinv = okf / (d > 0.f ? d : 1.f);
    sc[2] = dinv;
    sc[3] = dinv * (beta - gc);
    s_ok = ok;
  }
  __syncthreads();
  const float dinv = sc[2], step = sc[3];
  const bool ok = s_ok;
  const float okf = ok ? 1.f : 0.f;

  // --- bordered block-inverse update, coefficients, support, column -------
  for (int e = tid; e < k * k; e += blockDim.x) {
    const int a = e / k, c = e % k;
    const float wa = u[a] - (a == t ? 1.f : 0.f);
    const float wc = u[c] - (c == t ? 1.f : 0.f);
    Gb[e] = Gs[e] + dinv * wa * wc - ((a == t && c == t) ? okf : 0.f);
  }
  if (tid < k) {
    const float w = u[tid] - (tid == t ? 1.f : 0.f);
    cf[tid] -= step * w;
    coefb[tid] = cf[tid];
    if (tid == t && ok) ix[tid] = sel;
    idxb[tid] = ix[tid];
  }
  for (int p = tid; p < n; p += blockDim.x) colsb[(size_t)t * n + p] = acol[p] * okf;
  __syncthreads();

  // --- residual r = b - sum_s cols[s] coef[s] ------------------------------
  for (int p = tid; p < n; p += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < k; ++s) acc += colsb[(size_t)s * n + p] * cf[s];
    rb[p] = bb[p] - acc;
  }

  // --- last step: emit (idx, coef) sorted by atom index -------------------
  if (t == k - 1 && tid < k) {
    const int key = ix[tid];
    int rank = 0;
    for (int c = 0; c < k; ++c) {
      const int kc = ix[c];
      rank += (kc < key) || (kc == key && c < tid);
    }
    out_idx[(size_t)b * k + rank] = key;
    out_coef[(size_t)b * k + rank] = cf[tid];
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
  const size_t smem = (size_t)(n + k * k + 3 * k) * sizeof(float) + k * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    cudaFuncSetAttribute(omp_append_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    omp_append_kernel<__nv_bfloat16><<<B, kAppendThreads, smem, s>>>(
        pval, pidx, ntiles, static_cast<const __nv_bfloat16*>(A), Bs, cols,
        Ginv, coef, idx, r, out_idx, out_coef, n, m, k, t, rtol);
  } else {
    cudaFuncSetAttribute(omp_append_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    omp_append_kernel<float><<<B, kAppendThreads, smem, s>>>(
        pval, pidx, ntiles, static_cast<const float*>(A), Bs, cols, Ginv,
        coef, idx, r, out_idx, out_coef, n, m, k, t, rtol);
  }
  return static_cast<int>(cudaGetLastError());
}
