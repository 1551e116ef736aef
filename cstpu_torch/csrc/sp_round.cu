// Batched subspace pursuit (SP), stage 2: one expand-refit-prune round per
// row.
//
// Replaces sp_round and the outer-loop latch of cstpu/ops/fused_twostage.py::
// _sp_kernel (:767-845, :860-870; the init round :848-855). The row's
// top-k of |round_cdt(r) . A| comes from select_topl.cu. One block per row;
// a row that is done returns at once. Slots 0..k-1 hold the kept block
// (its inverse Gram Ginv11 in `Ginv`), slots k..2k-1 the acquired one.
//   acquire  the picks in order (value descending, index ascending, the TPU
//            kernel's cursor, :374-414): a pick that is already kept is
//            consumed but skipped; cols[k+j], Atb[k+j], idx[k+j]
//   blocks   G12 = C1 C2', G22 = C2 C2', W = Ginv11 G12, S = G22 - G12' W
//   pre-gate a new atom with S_jj <= rtol * G22_jj leaves (:795-799)
//   union    x2 solves S x2 = a2 - W'a1 by masked CG with the 8-eps lift,
//            until ||r_cg||^2 <= (8 eps)^2 ||r_cg0||^2 or k steps (:477-535;
//            the TPU kernel's exit is batch-wide, this one the row's own);
//            x1 = Ginv11 a1 - W x2
//   prune    the k largest |coef| occupied slots, lowest slot on ties
//   stable   the kept set is the pre-round one: the row keeps its state and
//            only drops its acquisitions (:836-843)
//   else     stable compaction of the kept slots to 0..cnt-1, the kept
//            block's Gram and its exact bordered inversion with the per-atom
//            pivot test d > rtol * ||a||^2 (:416-463), a rejected atom's
//            index and column cleared (:661-669), coef = Ginv11 a1, r
//   latch    res = ||r||^2; done |= res <= delta2 || prev <= res || stable;
//            prev = res (the init round only sets prev)
// The TPU kernel's speed routes are not taken: no Newton-Schulz inverse, no
// incremental upkeep, no one-hot permutation GEMMs or f32 index lanes (so
// no m < 2^24 cap); they decide as the exact rebuild does.
//
// What bounds it on an H100: latency, one block per row: 2k^2 + k^2/2 dot
// products of length n (the blocks and the kept Gram, 2.6 M multiply-adds
// at k=32, n=1024), k strided column gathers, and k sequential rounds each
// of the CG and of the bordered inversion on k x k tiles in shared memory.
// The CG runs in one warp, a lane per coefficient (k <= 32).
#include "common.cuh"

namespace cstpu {

constexpr int kSpThreads = 256;
constexpr float kEps8 = 8.0f * 1.1920929e-07f;

// Dynamic shared memory of sp_round: Ginv11, G12, S, W (k x k each), 15k
// floats of vectors and 7k ints.
__host__ __device__ constexpr size_t sp_smem_bytes(int k) {
  return (size_t)(4 * k * k + 15 * k) * sizeof(float) + (size_t)7 * k * sizeof(int);
}

// Dot product of two length-n rows by one warp; lane 0 gets the sum.
__device__ __forceinline__ float warp_dot(const float* __restrict__ x,
                                          const float* __restrict__ y, int n) {
  float acc = 0.f;
  for (int p = threadIdx.x & 31; p < n; p += 32) acc += x[p] * y[p];
  return warp_sum(acc);
}

template <typename T>
__global__ void __launch_bounds__(kSpThreads)
sp_round_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                int ntiles, const T* __restrict__ A,
                const float* __restrict__ Bs, float* __restrict__ cols,
                float* __restrict__ Ginv, float* __restrict__ coef,
                int* __restrict__ idx, float* __restrict__ Atb,
                float* __restrict__ r, float* __restrict__ done,
                float* __restrict__ prev, int n, int m, int k, float rtol,
                float delta2, int init) {
  extern __shared__ float smem[];
  __shared__ float red_v[kSpThreads / 32];
  __shared__ int red_i[kSpThreads / 32];
  __shared__ int picks[kTopLMax];
  __shared__ float vals[kTopLMax];
  __shared__ float s_lift, s_dinv;
  __shared__ int s_stable, s_cnt, s_ok;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int nw = kSpThreads / 32;
  if (done[b] > 0.5f) return;
  const int K2 = 2 * k, kk = k * k;
  float* Gi = smem;
  float* G12 = Gi + kk;   // G12, then the kept block's Gram
  float* S = G12 + kk;    // G22, then S
  float* W = S + kk;      // W, then the inverse being built
  float* atb = W + kk;
  float* cf = atb + K2;
  float* uc = cf + K2;
  float* ata = uc + K2;
  float* alive = ata + k;
  float* a1 = alive + k;
  float* pv = a1 + k;
  float* x2 = pv + k;
  float* g = x2 + k;
  float* u = g + k;
  float* inmask = u + k;
  float* flo = inmask + k;
  int* ix = reinterpret_cast<int*>(flo + k);
  int* src = ix + K2;
  int* keep = src + K2;
  int* rej = keep + K2;

  const float* bb = Bs + (size_t)b * n;
  float* colsb = cols + (size_t)b * K2 * n;
  float* rb = r + (size_t)b * n;
  float* Gb = Ginv + (size_t)b * kk;
  int* idxb = idx + (size_t)b * K2;
  float* atbb = Atb + (size_t)b * K2;

  for (int e = tid; e < kk; e += blockDim.x) Gi[e] = Gb[e];
  for (int e = tid; e < K2; e += blockDim.x) {
    ix[e] = idxb[e];
    atb[e] = atbb[e];
  }
  merge_topl_row(pval + (size_t)b * ntiles * k, pidx + (size_t)b * ntiles * k,
                 ntiles * k, k, picks, vals, red_v, red_i);

  // --- acquire: a warp per pick -------------------------------------------
  for (int j = warp; j < k; j += nw) {
    const int i = picks[j];
    bool dup = false;
    for (int e = 0; e < k; ++e) dup |= ix[e] == i;
    const bool ok = vals[j] > -INFINITY && !dup;
    const float okf = ok ? 1.f : 0.f;
    const int ic = min(i, m - 1);
    float* cj = colsb + (size_t)(k + j) * n;
    float acc = 0.f;
    for (int p = lane; p < n; p += 32) {
      const float a = to_f32(A[(size_t)p * m + ic]);
      cj[p] = a * okf;
      acc += a * bb[p];
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      atb[k + j] = acc * okf;
      ix[k + j] = ok ? i : m;
    }
  }
  __syncthreads();

  // --- blocks: G12 (kept x new), G22 (new x new, symmetric) ---------------
  for (int e = warp; e < 2 * kk; e += nw) {
    const int a = (e % kk) / k, c = e % k;
    const bool g22 = e >= kk;
    if (g22 && a > c) continue;
    const float acc = warp_dot(colsb + (size_t)(g22 ? k + a : a) * n,
                               colsb + (size_t)(k + c) * n, n);
    if (lane == 0) {
      if (g22) {
        S[a * k + c] = acc;
        S[c * k + a] = acc;
      } else {
        G12[a * k + c] = acc;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kk; e += blockDim.x) {
    const int a = e / k, c = e % k;
    float acc = 0.f;
    for (int t = 0; t < k; ++t) acc += Gi[a * k + t] * G12[t * k + c];
    W[e] = acc;
    if (a == c) ata[a] = S[e];
  }
  __syncthreads();
  for (int e = tid; e < kk; e += blockDim.x) {
    const int a = e / k, c = e % k;
    float acc = 0.f;
    for (int t = 0; t < k; ++t) acc += G12[t * k + a] * W[t * k + c];
    S[e] = S[e] - acc;
  }
  __syncthreads();

  // --- pre-gate on the Schur pivot of each new atom ------------------------
  for (int c = tid; c < k; c += blockDim.x) {
    const bool occ = ix[k + c] < m;
    const bool al = occ && S[c * k + c] > rtol * ata[c];
    alive[c] = al ? 1.f : 0.f;
    if (occ && !al) ix[k + c] = m;
  }
  for (int a = tid; a < k; a += blockDim.x) a1[a] = (ix[a] < m ? 1.f : 0.f) * atb[a];
  if (tid == 0) {
    float mx = -INFINITY;
    for (int c = 0; c < k; ++c) mx = max_keep_nan(mx, S[c * k + c]);
    s_lift = kEps8 * mx;
  }
  __syncthreads();

  // --- union coefficients: masked CG on S in warp 0, a lane per slot -------
  if (warp == 0) {
    const int c = lane;
    const bool in = c < k;
    float v = 0.f;
    if (in) {
      float wt = 0.f;
      for (int a = 0; a < k; ++a) wt += W[a * k + c] * a1[a];
      const float a2 = (ix[k + c] < m ? 1.f : 0.f) * atb[k + c];
      v = alive[c] * (a2 - wt);
    }
    const float lift = s_lift;
    float x = 0.f, rv = v, p = v;
    float rs = warp_allsum(v * v);
    const float thr = (kEps8 * kEps8) * rs;
    for (int j = 0; j < k && rs - thr > 0.f; ++j) {
      if (in) pv[c] = p;
      __syncwarp();
      float sp = 0.f;
      if (in) {
        float acc = 0.f;
        for (int e = 0; e < k; ++e) acc += S[c * k + e] * pv[e];
        sp = alive[c] * (acc + lift * p);
      }
      const float al = rs / max_keep_nan(warp_allsum(p * sp), 1e-30f);
      x = x + al * p;
      rv = rv - al * sp;
      const float rsn = warp_allsum(rv * rv);
      const float beta = rsn / max_keep_nan(rs, 1e-30f);
      p = rv + beta * p;
      rs = rsn;
      __syncwarp();
    }
    if (in) x2[c] = alive[c] * x;
  }
  __syncthreads();
  for (int a = tid; a < k; a += blockDim.x) {
    float gi = 0.f, wx = 0.f;
    for (int c = 0; c < k; ++c) {
      gi += Gi[a * k + c] * a1[c];
      wx += W[a * k + c] * x2[c];
    }
    uc[a] = gi - wx;
    uc[k + a] = x2[a];
  }
  __syncthreads();

  // --- prune to the k largest |coef| in warp 0, two slots a lane ----------
  if (warp == 0) {
    const int s0 = lane, s1 = lane + 32;
    float c0 = (s0 < K2 && ix[s0] < m) ? fabsf(uc[s0]) : -INFINITY;
    float c1 = (s1 < K2 && ix[s1] < m) ? fabsf(uc[s1]) : -INFINITY;
    int k0 = 0, k1 = 0;
    for (int t = 0; t < k; ++t) {
      float v = c0;
      int i = s0 < K2 ? s0 : INT_MAX;
      argmax_combine(v, i, c1, s1 < K2 ? s1 : INT_MAX);
      warp_argmax(v, i);
      v = __shfl_sync(0xffffffffu, v, 0);
      i = __shfl_sync(0xffffffffu, i, 0);
      if (!(v > -INFINITY)) break;  // a NaN maximum, or nothing left
      if (i == s0) {
        k0 = 1;
        c0 = -INFINITY;
      }
      if (i == s1) {
        k1 = 1;
        c1 = -INFINITY;
      }
    }
    if (s0 < K2) keep[s0] = k0;
    if (s1 < K2) keep[s1] = k1;
  }
  __syncthreads();
  if (tid == 0) {
    int st = 1, cnt = 0;
    for (int e = 0; e < K2; ++e) {
      st &= keep[e] == (e < k ? (int)(ix[e] < m) : 0);
      if (keep[e]) src[cnt++] = e;
    }
    s_stable = st;
    s_cnt = cnt;
  }
  __syncthreads();
  const bool stable = s_stable;

  float share = 0.f;
  if (stable) {
    for (int e = k + tid; e < K2; e += blockDim.x) ix[e] = m;
    for (int p = tid; p < n; p += blockDim.x) share += rb[p] * rb[p];
    __syncthreads();
  } else {
    // --- stable compaction of the kept slots (src ascending, src[d] >= d,
    // so each position moves in place, d ascending) -------------------------
    const int cnt = s_cnt;
    if (tid == 0) {
      for (int d = 0; d < K2; ++d) {
        ix[d] = d < cnt ? ix[src[d]] : m;
        atb[d] = d < cnt ? atb[src[d]] : 0.f;
      }
    }
    for (int p = tid; p < n; p += blockDim.x) {
      for (int d = 0; d < K2; ++d) {
        colsb[(size_t)d * n + p] = d < cnt ? colsb[(size_t)src[d] * n + p] : 0.f;
      }
    }
    __syncthreads();

    // --- the kept block's Gram (symmetric) and its bordered inversion -----
    for (int e = warp; e < kk; e += nw) {
      const int a = e / k, c = e % k;
      if (a > c) continue;
      const float acc = warp_dot(colsb + (size_t)a * n, colsb + (size_t)c * n, n);
      if (lane == 0) {
        G12[a * k + c] = acc;
        G12[c * k + a] = acc;
      }
    }
    for (int e = tid; e < kk; e += blockDim.x) W[e] = (e / k == e % k) ? 1.f : 0.f;
    __syncthreads();
    for (int j = tid; j < k; j += blockDim.x) {
      flo[j] = ix[j] < m ? rtol * G12[j * k + j] : INFINITY;
      inmask[j] = 0.f;
    }
    __syncthreads();
    for (int j = 0; j < k; ++j) {
      for (int c = tid; c < k; c += blockDim.x) g[c] = G12[c * k + j] * inmask[c];
      __syncthreads();
      for (int a = tid; a < k; a += blockDim.x) {
        float acc = 0.f;
        for (int c = 0; c < k; ++c) acc += W[a * k + c] * g[c];
        u[a] = acc;
      }
      __syncthreads();
      if (tid == 0) {
        float gu = 0.f;
        for (int c = 0; c < k; ++c) gu += g[c] * u[c];
        const float d = G12[j * k + j] - gu;
        const bool ok = d > flo[j];
        s_dinv = (ok ? 1.f : 0.f) / (d > 0.f ? d : 1.f);
        s_ok = ok;
        rej[j] = !ok;
      }
      __syncthreads();
      const float dinv = s_dinv, okf = s_ok ? 1.f : 0.f;
      for (int e = tid; e < kk; e += blockDim.x) {
        const int a = e / k, c = e % k;
        const float wa = u[a] - (a == j ? okf : 0.f);
        const float wc = u[c] - (c == j ? okf : 0.f);
        W[e] = W[e] + dinv * wa * wc - ((a == j && c == j) ? okf : 0.f);
      }
      if (tid == 0) inmask[j] += okf;
      __syncthreads();
    }

    // --- rejected kept atoms leave (index and column); refit -------------
    for (int j = tid; j < k; j += blockDim.x) {
      if (rej[j] && ix[j] < m) ix[j] = m;
    }
    __syncthreads();
    for (int e = tid; e < k * n; e += blockDim.x) {
      if (ix[e / n] >= m) colsb[e] *= 0.f;
    }
    for (int e = tid; e < kk; e += blockDim.x) Gi[e] = W[e];
    for (int a = tid; a < k; a += blockDim.x) a1[a] = (ix[a] < m ? 1.f : 0.f) * atb[a];
    __syncthreads();
    for (int a = tid; a < k; a += blockDim.x) {
      float acc = 0.f;
      for (int c = 0; c < k; ++c) acc += Gi[a * k + c] * a1[c];
      cf[a] = acc;
      cf[k + a] = 0.f;
    }
    __syncthreads();
    share = residual_row(rb, bb, colsb, cf, n, K2);
    for (int e = tid; e < kk; e += blockDim.x) Gb[e] = Gi[e];
    for (int e = tid; e < K2; e += blockDim.x) coef[(size_t)b * K2 + e] = cf[e];
  }
  for (int e = tid; e < K2; e += blockDim.x) {
    idxb[e] = ix[e];
    atbb[e] = atb[e];
  }
  const float rr = block_sum(share, red_v);
  if (tid == 0) {
    if (!init && (rr <= delta2 || prev[b] <= rr || stable)) done[b] = 1.f;
    prev[b] = rr;
  }
}

template <typename T>
int launch_sp_round(const float* pval, const int* pidx, int ntiles,
                    const void* A, const float* Bs, float* cols, float* Ginv,
                    float* coef, int* idx, float* Atb, float* r, float* done,
                    float* prev, int B, int n, int m, int k, float rtol,
                    float delta2, int init, cudaStream_t st) {
  const size_t smem = sp_smem_bytes(k);
  cudaFuncSetAttribute(sp_round_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sp_round_kernel<T><<<B, kSpThreads, smem, st>>>(
      pval, pidx, ntiles, static_cast<const T*>(A), Bs, cols, Ginv, coef, idx,
      Atb, r, done, prev, n, m, k, rtol, delta2, init);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cstpu

// One SP round for all B rows. pval/pidx (B, ntiles, k) from
// cstpu_select_topl; A (n, m) in cdt; Bs (B, n) f32; state cols (B,2k,n),
// Ginv (B,k,k), coef, Atb (B,2k) f32, idx (B,2k) i32, r (B,n) f32, done,
// prev (B,) f32 updated in place; init = 1 for the first round (sets prev,
// latches nothing). All contiguous, 1 <= k <= kTopLMax. Returns the
// launch's cudaError_t.
extern "C" int cstpu_sp_round(const float* pval, const int* pidx, int ntiles,
                              const void* A, int cdt_bf16, const float* Bs,
                              float* cols, float* Ginv, float* coef, int* idx,
                              float* Atb, float* r, float* done, float* prev,
                              int B, int n, int m, int k, float rtol,
                              float delta2, int init, void* stream) {
  using namespace cstpu;
  if (k < 1 || k > kTopLMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    return launch_sp_round<__nv_bfloat16>(pval, pidx, ntiles, A, Bs, cols,
                                          Ginv, coef, idx, Atb, r, done, prev,
                                          B, n, m, k, rtol, delta2, init, st);
  }
  return launch_sp_round<float>(pval, pidx, ntiles, A, Bs, cols, Ginv, coef,
                                idx, Atb, r, done, prev, B, n, m, k, rtol,
                                delta2, init, st);
}
