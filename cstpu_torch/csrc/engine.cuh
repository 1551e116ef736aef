// The slot engine of the two-stage kernels, one block per row: device
// counterparts of cstpu/ops/fused_twostage.py::_Engine (:42-238) that
// ompr_swap.cu, srr_append.cu, engine_delete.cu and engine_backward.cu
// share (engine_init.cu and rmp_append.cu run the same math as a
// thread-block cluster per row, engine_cluster.cuh).
//
// A row's state: cols (K, n) and r (n) in device memory; Ginv (K, K), coef,
// idx and Atb (K) staged in shared memory for the launch. An append goes to
// the row's first free slot (idx >= m), so after deletions the occupied
// slots need not be contiguous: the bordered append's cross terms g run
// over all K slots (a free slot's column is zero, so it adds nothing). A
// deletion is the Schur downdate Ginv -= q q' / q_p with q = Ginv e_p,
// which zeroes row and column p up to rounding; the identity pad at p is
// put back, and idx, Atb and the column at p are cleared.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace cstpu {

constexpr int kEngThreads = 256;

struct EngineSmem {
  AppendSmem a;  // acol, Ginv (Gs), g, u, coef (cf), idx (ix), sc, flag
  float* atb;    // K: a_s . b
  float* v0;     // K: scratch
  float* v1;     // K: scratch
  float* q;      // K: the deleted slot's column of Ginv
};

// Dynamic shared memory that carves an EngineSmem.
__host__ __device__ constexpr size_t engine_smem_bytes(int n, int K) {
  return append_smem_bytes(n, K) + 4 * (size_t)K * sizeof(float);
}

__device__ __forceinline__ EngineSmem carve_engine_smem(float* smem, int n,
                                                        int K, float* sc,
                                                        int* flag) {
  EngineSmem s;
  s.a = carve_append_smem(smem, n, K, sc, flag);
  float* rest = reinterpret_cast<float*>(s.a.ix + K);
  s.atb = rest;
  s.v0 = rest + K;
  s.v1 = rest + 2 * K;
  s.q = rest + 3 * K;
  return s;
}

// Row b's Ginv, coef, idx and Atb into shared memory, and back.
__device__ __forceinline__ void load_engine_state(const EngineSmem& s,
                                                  const float* Gb,
                                                  const float* coefb,
                                                  const int* idxb,
                                                  const float* atbb, int K) {
  load_append_state(s.a, Gb, coefb, idxb, K);
  for (int e = threadIdx.x; e < K; e += blockDim.x) s.atb[e] = atbb[e];
  __syncthreads();
}

__device__ __forceinline__ void store_engine_state(const EngineSmem& s,
                                                   float* Gb, float* coefb,
                                                   int* idxb, float* atbb,
                                                   int K) {
  store_append_state(s.a, Gb, coefb, idxb, K);
  for (int e = threadIdx.x; e < K; e += blockDim.x) atbb[e] = s.atb[e];
}

// Number of occupied slots (idx < m); every thread gets it.
__device__ __forceinline__ int engine_nactive(const EngineSmem& s, int K,
                                              int m) {
  int c = 0;
  for (int e = 0; e < K; ++e) c += s.a.ix[e] < m;
  return c;
}

// _Engine.append (:138-190): atom sel into the first free slot, gated by
// `gate`, the duplicate test, capacity and d > rtol * ata (common.cuh::
// bordered_append with g over all K slots); Atb += beta * e_slot * ok (for
// every slot, as the TPU kernel adds it), amask[sel] = 1 when accepted.
// Every thread calls it; it ends with a barrier. s.a.acol, s.a.u and
// s.a.sc[2] (dinv) keep the column, u and 1/d for the caller.
template <typename T>
__device__ bool engine_append(const EngineSmem& s, const T* __restrict__ A,
                              const float* __restrict__ bb,
                              float* __restrict__ colsb,
                              uint8_t* __restrict__ amaskb, int n, int m,
                              int K, int sel, bool gate, float rtol) {
  int slot = K;
  for (int e = K - 1; e >= 0; --e) slot = s.a.ix[e] >= m ? e : slot;
  const bool ok = bordered_append(s.a, A, bb, colsb, n, m, K, sel, slot, K,
                                  gate && slot < K, rtol);
  const float beta = s.a.sc[1];
  for (int e = threadIdx.x; e < K; e += blockDim.x) {
    s.atb[e] += beta * ((ok && e == slot) ? 1.f : 0.f);
  }
  if (threadIdx.x == 0 && ok && sel < m) amaskb[sel] = 1;
  __syncthreads();
  return ok;
}

// aperp = acol - cols' u after an append (the rescaling direction of
// _Engine.append, :186-187), into the n floats at out.
__device__ __forceinline__ void engine_aperp(const EngineSmem& s,
                                             const float* __restrict__ colsb,
                                             float* __restrict__ out, int n,
                                             int K) {
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < K; ++q) acc += colsb[(size_t)q * n + p] * s.a.u[q];
    out[p] = s.a.acol[p] - acc;
  }
}

// _Engine.delete_ep (:192-216) at slot p, gated by hasf (p == K: none).
// When vout is not null it receives the restore term of the rescaling,
// v = cols' q (n floats) and *wout = 1/q_p, taken before the column is
// cleared; a gated-off delete writes a zero term. amask[idx[p]] = 0.
// Every thread calls it; it ends with a barrier.
__device__ inline void engine_delete(const EngineSmem& s, float* __restrict__ colsb,
                              uint8_t* __restrict__ amaskb, int n, int m,
                              int K, int p, bool hasf, float* vout,
                              float* wout) {
  const int tid = threadIdx.x;
  if (!hasf || p >= K) {
    if (vout) {
      for (int e = tid; e < n; e += blockDim.x) vout[e] = 0.f;
      if (tid == 0) *wout = 0.f;
    }
    __syncthreads();
    return;
  }
  for (int e = tid; e < K; e += blockDim.x) s.q[e] = s.a.Gs[e * K + p];
  __syncthreads();
  const float qpp = s.q[p];
  const float inv = 1.f / (qpp > 0.f ? qpp : 1.f);
  if (vout) {
    for (int e = tid; e < n; e += blockDim.x) {
      float acc = 0.f;
      for (int c = 0; c < K; ++c) acc += colsb[(size_t)c * n + e] * s.q[c];
      vout[e] = acc;
    }
    if (tid == 0) *wout = inv;
  }
  if (tid == 0 && s.a.ix[p] < m) amaskb[s.a.ix[p]] = 0;
  for (int e = tid; e < K * K; e += blockDim.x) {
    const int a = e / K, c = e % K;
    s.a.Gs[e] = s.a.Gs[e] - inv * s.q[a] * s.q[c] + ((a == p && c == p) ? 1.f : 0.f);
  }
  __syncthreads();  // the v pass above reads column p
  for (int e = tid; e < n; e += blockDim.x) colsb[(size_t)p * n + e] *= 0.f;
  if (tid == 0) {
    s.a.ix[p] = m;
    s.atb[p] *= 0.f;
  }
  __syncthreads();
}

// _Engine.refit_residual (:218-223): coef = Ginv Atb, r = b - cols' coef.
// Returns this thread's share of ||r||^2. Every thread calls it.
__device__ __forceinline__ float engine_refit(const EngineSmem& s,
                                              const float* __restrict__ bb,
                                              const float* __restrict__ colsb,
                                              float* __restrict__ rb, int n,
                                              int K) {
  for (int a = threadIdx.x; a < K; a += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < K; ++c) acc += s.a.Gs[a * K + c] * s.atb[c];
    s.a.cf[a] = acc;
  }
  __syncthreads();
  return residual_row(rb, bb, colsb, s.a.cf, n, K);
}

// A row's backward stage, the per-row form of the stage loops of
// _rmp_kernel (:1301-1336) and _foba_kernel (:1461-1475): while the rule
// accepts, delete the slot of least coef^2 / max(Ginv_pp, 1e-30) (lowest
// slot on ties, backward_min :126-136) and refit. The rule is
//   kfinal >= 0:  nactive > kfinal && dmin < inf    (RMP's k variant)
//   kfinal <  0:  dmin < thr       (RMP's delta variant, FoBa's gain / 4)
// and a NaN dmin rejects. The TPU loops are batch-wide with a per-row gate
// that, once closed, makes every later step a no-op on the row, so the
// per-row loop leaves the same state. Deletion j leaves its restore term
// (v, 1/q_p) in pending slot 1 + j of pend_u (P, B, n) and pend_w (P, B);
// the weights of slots 1 + count .. K are zeroed, so a later select that
// applies more slots than this row filled adds nothing. At most K
// deletions (P >= K + 1). s_p and s_acc are shared ints. Every thread
// calls it; returns the number of deletions.
__device__ inline int engine_backward_loop(
    const EngineSmem& s, const float* __restrict__ bb,
    float* __restrict__ colsb, float* __restrict__ rb,
    uint8_t* __restrict__ amaskb, float* __restrict__ pend_u,
    float* __restrict__ pend_w, int B, int b, int n, int m, int K, float thr,
    int kfinal, int* s_p, int* s_acc) {
  const int tid = threadIdx.x;
  int nd = 0;
  for (int j = 0; j < K + 1; ++j) {
    if (tid == 0) {
      float dmin = INFINITY;
      for (int e = 0; e < K; ++e) {
        const float c = s.a.cf[e];
        const float d2 = s.a.ix[e] < m ? c * c / max_keep_nan(s.a.Gs[e * K + e], 1e-30f) : INFINITY;
        s.v0[e] = d2;
        dmin = min_keep_nan(dmin, d2);
      }
      int p = K;
      for (int e = K - 1; e >= 0; --e) p = s.v0[e] == dmin ? e : p;
      *s_p = p;
      *s_acc = kfinal >= 0 ? (engine_nactive(s, K, m) > kfinal && dmin < INFINITY)
                           : (dmin < thr);
    }
    __syncthreads();
    if (!*s_acc) break;
    engine_delete(s, colsb, amaskb, n, m, K, *s_p, true,
                  pend_u + ((size_t)(1 + nd) * B + b) * n,
                  pend_w + (size_t)(1 + nd) * B + b);
    engine_refit(s, bb, colsb, rb, n, K);
    __syncthreads();  // the next round's scores read the refit coef
    ++nd;
  }
  for (int e = 1 + nd + tid; e <= K; e += blockDim.x) pend_w[(size_t)e * B + b] = 0.f;
  return nd;
}

}  // namespace cstpu
