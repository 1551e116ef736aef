// Batched matching pursuit, stage 2: the coefficient and residual update.
//
// Replaces the update of cstpu/ops/fused_solve.py::_mp_kernel (:893-903).
// One launch is one MP step for all rows; the select is select_argmax.cu
// with its signed output. Per row b:
//   (|v|, i, v) = the select's (B, T) partials reduced with argmax_combine:
//                 lowest index on ties, INT_MAX when the row's max is NaN
//   x[b, i] += v;  r[b, :] -= v * A[:, i]   (A cdt-rounded, upcast to f32)
// v is the select's own f32 score <round_cdt(r), a_i>, as the TPU kernel
// takes it from its score matrix (:898). A NaN row picks INT_MAX; the TPU
// kernel's one-hot is then all false and its step adds zero, so here the
// step is skipped. Products and differences are rounded one at a time
// (__fmul_rn, __fsub_rn), as the TPU kernel and the plain version compute
// them, not fused into an FMA.
//
// What bounds it on an H100: per step it reads T partials and one strided
// dictionary column per row and writes n + 1 floats: a few KB per row,
// latency-bound. Design: one block per row; the partials reduced by warp
// shuffles; the column gathered strided by m straight into the update.
#include "common.cuh"

namespace cstpu {

constexpr int kMpThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMpThreads)
mp_update_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                 const float* __restrict__ psig, int ntiles,
                 const T* __restrict__ A, float* __restrict__ x,
                 float* __restrict__ r, int n, int m) {
  __shared__ float red_v[kMpThreads / 32], red_s[kMpThreads / 32];
  __shared__ int red_i[kMpThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* pvb = pval + (size_t)b * ntiles;
  const int* pib = pidx + (size_t)b * ntiles;
  const float* psb = psig + (size_t)b * ntiles;

  float v = -INFINITY, sg = 0.f;
  int i = INT_MAX;
  for (int e = tid; e < ntiles; e += blockDim.x) argmax_combine(v, i, sg, pvb[e], pib[e], psb[e]);
  warp_argmax(v, i, sg);
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
    red_s[warp] = sg;
  }
  __syncthreads();
  v = red_v[0];
  i = red_i[0];
  sg = red_s[0];
  for (int w = 1; w < kMpThreads / 32; ++w) argmax_combine(v, i, sg, red_v[w], red_i[w], red_s[w]);
  if (i >= m) return;  // NaN row: K5's all-false one-hot, a no-op step

  if (tid == 0) x[(size_t)b * m + i] += sg;
  float* rb = r + (size_t)b * n;
  for (int p = tid; p < n; p += blockDim.x) {
    rb[p] = __fsub_rn(rb[p], __fmul_rn(sg, to_f32(A[(size_t)p * m + i])));
  }
}

}  // namespace cstpu

// One MP step for all B rows. pval/pidx/psig (B, ntiles) from
// cstpu_select_argmax with its signed output; A (n, m) in cdt; x (B, m)
// and r (B, n) f32 updated in place. All contiguous. Returns the launch's
// cudaError_t.
extern "C" int cstpu_mp_update(const float* pval, const int* pidx,
                               const float* psig, int ntiles, const void* A,
                               int cdt_bf16, float* x, float* r, int B, int n,
                               int m, void* stream) {
  using namespace cstpu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    mp_update_kernel<__nv_bfloat16><<<B, kMpThreads, 0, s>>>(
        pval, pidx, psig, ntiles, static_cast<const __nv_bfloat16*>(A), x, r,
        n, m);
  } else {
    mp_update_kernel<float><<<B, kMpThreads, 0, s>>>(
        pval, pidx, psig, ntiles, static_cast<const float*>(A), x, r, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}
