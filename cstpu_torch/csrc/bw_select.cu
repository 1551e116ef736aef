// Batched backward elimination (FBR, LACE), stage 1 of a deletion step:
// the selection, the accept test and the per-row vector updates.
//
// Replaces, with bw_downdate.cu, the body of
// cstpu/ops/fused_backward.py::_bw_kernel (:79-146). The TPU kernel keeps
// one instance's (m, m) Gram inverse in VMEM and runs all deletions in one
// program; a block's shared memory cannot hold it (4 MB at m = 1024), so
// the private inverses G (B, m, m) stay in device memory and a deletion
// step is two launches. This one, one block per row, decides and stages;
// bw_downdate.cu then sweeps the matrix. The downdate G -= gcol (g ginvs)
// reads row p and column p of the matrix it overwrites, so both are staged
// here, from the matrix as it was, into g and gcol (B, m): the stream
// orders the two launches, no block of the downdate reads what another
// writes. Per row that is still running:
//   d2_j  = alive_j ? coef_j^2 / diag_j : inf
//   sel   = d2 (FBR) or alive_j ? |coef_j| : inf (LACE)
//   p     = lowest argmin of sel; a NaN minimum selects nothing (p = INT_MAX)
//   valid = p < m;  d2p = valid ? d2_p : 0
//   fail  = !(d2p + nr2 >= 0) || !valid     (a negated >=, so NaN latches)
//   acc   = valid && !fail && max(nr2 + d2p, 0) < max_eps2 && d2p < max_delta2
//   ginvs = acc / (G_pp != 0 ? G_pp : 1)    (0 when rejected: a no-op step)
//   g = G[min(p, m-1), :],  gcol = G[:, min(p, m-1)]   (row and column read
//       separately, as the TPU kernel reads them; only the init is
//       symmetrised)
//   coef = (coef - g (coef_p ginvs)) (1 - acc e_p)
//   diag = (diag - g g ginvs) (1 - acc e_p) + acc e_p
//   alive = alive (1 - acc e_p);  nr2 = acc ? max(nr2 + d2p, 0) : nr2
//   failed |= fail;  run = acc
// G_pp, coef_p and d2_p are read at p (the TPU kernel's one-hot sums give
// the same values on a finite state). Every product and sum is rounded on
// its own (__fmul_rn, __fsub_rn, __fadd_rn, __fdiv_rn), as the plain
// version's separate tensor operations round them, so that the two decide
// alike. True f32 throughout.
//
// What bounds it on an H100: latency: three length-m passes and one strided
// column read per row, a block per row.
#include "common.cuh"

namespace cstpu {

constexpr int kBwThreads = 256;

__global__ void __launch_bounds__(kBwThreads)
bw_select_kernel(const float* __restrict__ G, float* __restrict__ coef,
                 float* __restrict__ diag, float* __restrict__ alive,
                 float* __restrict__ nr2, float* __restrict__ run,
                 float* __restrict__ failed, float* __restrict__ g,
                 float* __restrict__ gcol, float* __restrict__ sc, int m,
                 float max_eps2, float max_delta2, int select_abs) {
  __shared__ float red_v[kBwThreads / 32];
  __shared__ int red_i[kBwThreads / 32];
  __shared__ float s_f[3];  // coef_p * ginvs, ginvs, acc
  __shared__ int s_p;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (run[b] < 0.5f) {
    if (tid == 0) sc[2 * b + 1] = 0.f;
    return;
  }
  const float* Gb = G + (size_t)b * m * m;
  float* cb = coef + (size_t)b * m;
  float* db = diag + (size_t)b * m;
  float* ab = alive + (size_t)b * m;

  // lowest argmin of sel, as the argmax of -sel (NaN absorbing)
  float v = -INFINITY;
  int i = INT_MAX;
  for (int j = tid; j < m; j += blockDim.x) {
    const float c = cb[j];
    const bool live = ab[j] > 0.f;
    float sel = INFINITY;
    if (live) sel = select_abs ? fabsf(c) : __fdiv_rn(__fmul_rn(c, c), db[j]);
    argmax_combine(v, i, -sel, j);
  }
  warp_argmax(v, i);
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kBwThreads / 32; ++w) argmax_combine(v, i, red_v[w], red_i[w]);
    const int p = i;
    const bool valid = p < m;
    float d2p = 0.f, gpp = 0.f, coefp = 0.f;
    if (valid) {
      coefp = cb[p];
      gpp = db[p];
      d2p = ab[p] > 0.f ? __fdiv_rn(__fmul_rn(coefp, coefp), gpp) : INFINITY;
    }
    const float old = nr2[b];
    const float sum = __fadd_rn(d2p, old);
    const bool fail = !(sum >= 0.f) || !valid;
    const float newnr2 = max_keep_nan(sum, 0.f);
    const bool acc = valid && !fail && newnr2 < max_eps2 && d2p < max_delta2;
    const float accf = acc ? 1.f : 0.f;
    const float ginvs = __fdiv_rn(accf, gpp != 0.f ? gpp : 1.f);
    if (fail) failed[b] = 1.f;
    if (acc) nr2[b] = newnr2;
    run[b] = accf;
    sc[2 * b] = ginvs;
    sc[2 * b + 1] = 1.f;
    s_f[0] = __fmul_rn(coefp, ginvs);
    s_f[1] = ginvs;
    s_f[2] = accf;
    s_p = p;
  }
  __syncthreads();
  const int p = s_p, pc = min(p, m - 1);
  const float cg = s_f[0], ginvs = s_f[1], accf = s_f[2];
  float* gb = g + (size_t)b * m;
  float* gcb = gcol + (size_t)b * m;
  for (int j = tid; j < m; j += blockDim.x) {
    const float gj = Gb[(size_t)pc * m + j];
    gb[j] = gj;
    gcb[j] = Gb[(size_t)j * m + pc];
    const float hit = j == p ? accf : 0.f;  // acc e_p
    const float keep = __fsub_rn(1.f, hit);
    cb[j] = __fmul_rn(__fsub_rn(cb[j], __fmul_rn(gj, cg)), keep);
    db[j] = __fadd_rn(
        __fmul_rn(__fsub_rn(db[j], __fmul_rn(__fmul_rn(gj, gj), ginvs)), keep),
        hit);
    ab[j] = __fmul_rn(ab[j], keep);
  }
}

}  // namespace cstpu

// The selection of one deletion step for all B rows. G (B, m, m) f32 read;
// coef, diag, alive (B, m) f32 and nr2, run, failed (B,) f32 updated in
// place; g, gcol (B, m) f32 and sc (B, 2) f32 = (ginvs, stepped) written for
// cstpu_bw_downdate. select_abs != 0 is LACE's rule. All contiguous.
// Returns the launch's cudaError_t.
extern "C" int cstpu_bw_select(const float* G, float* coef, float* diag,
                               float* alive, float* nr2, float* run,
                               float* failed, float* g, float* gcol, float* sc,
                               int B, int m, float max_eps2, float max_delta2,
                               int select_abs, void* stream) {
  using namespace cstpu;
  bw_select_kernel<<<B, kBwThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      G, coef, diag, alive, nr2, run, failed, g, gcol, sc, m, max_eps2,
      max_delta2, select_abs);
  return static_cast<int>(cudaGetLastError());
}
