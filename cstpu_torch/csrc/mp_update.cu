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
// them, not fused into an FMA: r is bit for bit the plain version's.
//
// What bounds it on an H100: per step it reads T partials and one strided
// dictionary column per row and writes n + 1 floats: a few KB per row, a
// 32-byte sector per entry of the column. Launch and dependent-load latency
// set its time, not bytes. Design:
//   grid     B x C blocks of kMpThreads, no cluster (mp_plan: C from B and n
//            alone, so that B C covers the 132 SMs); block `rank` of row b
//            owns entries p0 .. p0+L-1 of n (slices of `slice` entries, a
//            multiple of 4, the last one ragged or empty), at most kMpVec
//            pieces of 4 entries a thread, held in registers;
//   loads    at entry each thread issues the loads of its pieces of r (16-byte
//            loads where n % 4 == 0 and r is 16-byte aligned), which the pick
//            does not decide, then every warp loads the row's T partials,
//            kMpIlp a lane in flight, and reduces them on its own with
//            argmax_combine and xor shuffles. The rule is a total order, so
//            every warp of every block reaches the same (v, i): no shared
//            memory, no barrier, no exchange between the blocks. Each thread
//            then gathers its entries of column i (strided by m, all in
//            flight) and writes its entries of r; thread 0 of the rank-0
//            block adds v to x[b, i].
// A programmatic dependent launch behind the signed select (the select
// letting this grid start after its main loop, this grid waiting for it
// before the partials) was measured and taken out: MP's step is host-bound,
// so the select has finished before this launch is issued, and the mp
// solve's device busy time did not drop (PERF.md, section 6).
#include "common.cuh"

namespace cstpu {

constexpr int kMpThreads = 128;
constexpr int kMpVec = 4;                         // pieces of 4 a thread
constexpr int kMpMaxSlice = 4 * kMpVec * kMpThreads;  // 2048 entries
constexpr int kMpMinSlice = 4 * 32;               // a piece for each lane
constexpr int kMpIlp = 4;                         // partials a lane at once

struct MpPlan {
  int C;      // blocks a row
  int slice;  // entries of n a block owns (the last block: the rest)
};

// The plan for B rows of length n: C = ceil(kSMs / B), so that B C covers
// the SMs, at most ceil(n / kMpMinSlice), at least 1, and raised until a
// slice fits the threads' registers.
inline MpPlan mp_plan(int B, int n) {
  const int by_sms = (kSMs + B - 1) / B;
  const int by_n = (n + kMpMinSlice - 1) / kMpMinSlice;
  const int need = (n + kMpMaxSlice - 1) / kMpMaxSlice;
  int C = by_sms < by_n ? by_sms : by_n;
  C = C > need ? C : need;
  C = C > 1 ? C : 1;
  return MpPlan{C, ((n + C - 1) / C + 3) & ~3};
}

template <typename T>
__global__ void __launch_bounds__(kMpThreads, 1)
mp_update_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                 const float* __restrict__ psig, int ntiles,
                 const T* __restrict__ A, float* __restrict__ x,
                 float* __restrict__ r, int n, int m, int C, int S) {
  const int b = blockIdx.x / C, rank = blockIdx.x - b * C;
  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = min(n, rank * S), L = min(n, p0 + S) - p0;
  float* rb = r + (size_t)b * n + p0;
  // then every piece is 16 bytes at a 16-byte boundary (S and p0 are
  // multiples of 4)
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(r) & 15) == 0;

  // --- this thread's pieces of r: entries 4 (tid + j kMpThreads) + 0..3 ---
  float rv[kMpVec][4];
#pragma unroll
  for (int j = 0; j < kMpVec; ++j) {
    const int e = 4 * (tid + j * kMpThreads);
    if (vec) {
      const float4 q = e < L ? *reinterpret_cast<const float4*>(rb + e)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      rv[j][0] = q.x;
      rv[j][1] = q.y;
      rv[j][2] = q.z;
      rv[j][3] = q.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) rv[j][c] = e + c < L ? rb[e + c] : 0.f;
    }
  }

  // --- the row's pick from the select's partials, in every warp ----------
  const float* pvb = pval + (size_t)b * ntiles;
  const int* pib = pidx + (size_t)b * ntiles;
  const float* psb = psig + (size_t)b * ntiles;
  float v = -INFINITY, sg = 0.f;
  int i = INT_MAX;
  for (int e0 = lane; e0 < ntiles; e0 += 32 * kMpIlp) {
    float pv[kMpIlp], ps[kMpIlp];
    int pi[kMpIlp];
#pragma unroll
    for (int j = 0; j < kMpIlp; ++j) {
      const int e = e0 + 32 * j;
      pv[j] = e < ntiles ? pvb[e] : -INFINITY;
      pi[j] = e < ntiles ? pib[e] : INT_MAX;
      ps[j] = e < ntiles ? psb[e] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMpIlp; ++j) argmax_combine(v, i, sg, pv[j], pi[j], ps[j]);
  }
  warp_argmax_all(v, i, sg);
  if (i >= m) return;  // NaN row: K5's all-false one-hot, a no-op step

  // --- column i's entries of this thread, all in flight, then r -----------
  float a[kMpVec][4];
#pragma unroll
  for (int j = 0; j < kMpVec; ++j) {
    const int e = 4 * (tid + j * kMpThreads);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      a[j][c] = e + c < L ? to_f32(A[(size_t)(p0 + e + c) * m + i]) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kMpVec; ++j) {
    const int e = 4 * (tid + j * kMpThreads);
    if (e >= L) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) rv[j][c] = __fsub_rn(rv[j][c], __fmul_rn(sg, a[j][c]));
    if (vec) {
      *reinterpret_cast<float4*>(rb + e) = make_float4(rv[j][0], rv[j][1], rv[j][2], rv[j][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (e + c < L) rb[e + c] = rv[j][c];
      }
    }
  }
  if (rank == 0 && tid == 0) x[(size_t)b * m + i] += sg;
}

}  // namespace cstpu

// The launch plan of mp_update for B rows of length n: out = {C, slice,
// threads a block}. Returns cudaErrorInvalidValue for B < 1 or n < 1.
extern "C" int cstpu_mp_plan(int B, int n, int* out) {
  using namespace cstpu;
  if (B < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const MpPlan p = mp_plan(B, n);
  out[0] = p.C;
  out[1] = p.slice;
  out[2] = kMpThreads;
  return static_cast<int>(cudaSuccess);
}

// One MP step for all B rows. pval/pidx/psig (B, ntiles) from
// cstpu_select_argmax with its signed output; A (n, m) in cdt; x (B, m)
// and r (B, n) f32 updated in place. All contiguous. B C blocks of the
// plan. Returns the launch's cudaError_t.
extern "C" int cstpu_mp_update(const float* pval, const int* pidx,
                               const float* psig, int ntiles, const void* A,
                               int cdt_bf16, float* x, float* r, int B, int n,
                               int m, void* stream) {
  using namespace cstpu;
  if (B < 1 || n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const MpPlan p = mp_plan(B, n);
  const dim3 grid(static_cast<unsigned>(B) * p.C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    mp_update_kernel<__nv_bfloat16><<<grid, kMpThreads, 0, s>>>(
        pval, pidx, psig, ntiles, static_cast<const __nv_bfloat16*>(A), x, r,
        n, m, p.C, p.slice);
  } else {
    mp_update_kernel<float><<<grid, kMpThreads, 0, s>>>(
        pval, pidx, psig, ntiles, static_cast<const float*>(A), x, r, n, m,
        p.C, p.slice);
  }
  return static_cast<int>(cudaGetLastError());
}
