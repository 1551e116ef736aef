// Shared device helpers of the batched kernels: the select tile width, cdt
// rounding, the argmax rule of cstpu/ops/fused_solve.py::_solve_kernel
// (:157-163), warp and block sums, the cp.async, mbarrier and
// cluster-barrier PTX, the top-l sort key and the warp's sort of a tile's
// 128 keys, and the merge of select_topl partials (a warp-sorted top 32
// and a tree of merges).
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cstpu {

// Atoms per select block, and per partial (value, index) it writes.
constexpr int kTile = 128;
// Most picks per GOMP iteration (the l of select_topl, LMAX).
constexpr int kTopLMax = 32;
// SMs of the card the launch plans fill (an H100 SXM).
constexpr int kSMs = 132;

// The top-1 finishing stage of the streaming selects, defined in
// stream_select.cu and shared with fr_step_select.cu. `stream_tiling_ok`: m a
// multiple of kTile, and the tile of the NaN rule (bpt sweep blocks) a whole
// number of blocks that divides the shard. `launch_stream_finish` folds a
// sweep's partials pval/pidx (B, nblocks) into val/idx (B,): the running
// pair from (-inf, 0), strict `>` across tiles, a tile that holds a NaN
// skipped whole, or with nan_visible ending the fold with a NaN value.
bool stream_tiling_ok(int m, int bpt);
cudaError_t launch_stream_finish(const float* pval, const int* pidx, int B,
                                 int nblocks, int bpt, int nan_visible,
                                 float* val, int* idx, cudaStream_t s);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the correlation dtype T (round to nearest even), back in f32.
template <typename T>
__device__ __forceinline__ float round_cdt(float x) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// Max of (value, index) pairs: the larger value wins, ties go to the lower
// index, and a NaN anywhere makes the result (NaN, INT_MAX). That is
// _solve_kernel's rule: a NaN maximum fails every `scores == smax` test, so
// the masked index min returns INT_MAX. The rule is a total order with an
// absorbing element, so any reduction tree gives the same answer.
__device__ __forceinline__ void argmax_combine(float& v, int& i, float v2,
                                               int i2) {
  if (isnan(v) || isnan(v2)) {
    v = __int_as_float(0x7fc00000);
    i = INT_MAX;
  } else if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// argmax_combine that carries a payload s along with the winner.
__device__ __forceinline__ void argmax_combine(float& v, int& i, float& s,
                                               float v2, int i2, float s2) {
  if (isnan(v) || isnan(v2)) {
    v = s = __int_as_float(0x7fc00000);
    i = INT_MAX;
  } else if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
    s = s2;
  }
}

// argmax_combine over the 32 lanes of a warp; lane 0 holds the result.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_down_sync(0xffffffffu, v, off);
    int i2 = __shfl_down_sync(0xffffffffu, i, off);
    argmax_combine(v, i, v2, i2);
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i, float& s) {
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_down_sync(0xffffffffu, v, off);
    int i2 = __shfl_down_sync(0xffffffffu, i, off);
    float s2 = __shfl_down_sync(0xffffffffu, s, off);
    argmax_combine(v, i, s, v2, i2, s2);
  }
}

// warp_argmax with its payload, the result in every lane: a butterfly of
// xor shuffles. argmax_combine is a total order, so every lane of every
// warp that combines the same pairs reaches the same bits.
__device__ __forceinline__ void warp_argmax_all(float& v, int& i, float& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    argmax_combine(v, i, s, v2, i2, s2);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

// Sum of x over the block; every thread gets it. `red` holds one float per
// warp. Starts and ends with a barrier, so `red` can be reused at once.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float acc = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) acc += red[w];
  __syncthreads();
  return acc;
}

// Ask CUDA for the largest L1 a kernel's shared memory leaves. A
// one-block-per-row append kernel re-reads its row's slot columns (k x n
// f32: 128 KB at k = 32, n = 1024) on every append; the carveout CUDA
// picks by default can follow how many blocks the kernel's registers would
// let an SM hold, and leave those columns a smaller L1, while these
// launches put one block on an SM (on an H100, engine_init at suite config
// 2c took 1.03 ms a launch without it and 0.67 with it, on its earlier
// merge). Returns the call's cudaError_t.
template <typename F>
inline cudaError_t prefer_l1(F* kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxL1));
}

// Sum of x over the 32 lanes of a warp; every lane gets it.
__device__ __forceinline__ float warp_allsum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The two halves of a thread-block cluster barrier: arrive releases this
// thread's earlier memory operations (distributed shared memory reads
// included) to the cluster, wait acquires the other blocks'. Every thread
// of every block of the cluster executes both, in this order.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------- cp.async and mbarrier PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Start copying 16 bytes (both addresses 16-byte aligned; past L1) or 4
// bytes from device to shared memory, in the thread's open cp.async group.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every cp.async of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// An mbarrier at shared address `bar`, for `count` arrivals.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the barriers this thread set up visible to the cluster (and to TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 4 bytes from device to shared memory, or 4 zero bytes when !valid (the
// source is not read then).
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Arrive on `bar` once every cp.async this thread has issued has landed;
// the arrival is counted in the barrier's initial count (noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed; a wait
// that never ends (a fault in the counts) traps after some 2^26 tries
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, tries = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++tries == (1u << 26)) __trap();
  } while (!done);
}

// One box of a 2-D tensor map into shared memory; c0 is the coordinate along
// the contiguous dimension. Completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Arrive on the barrier at this block's shared address `bar` in block
// `rank` of the cluster, releasing this thread's earlier writes (to that
// block's shared memory included) at cluster scope.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

// mbar_wait that acquires at cluster scope what remote arrivals released.
// A wait that never ends (a fault in the count) traps after some 2^26 tries
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done = 0, tries = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++tries == (1u << 26)) __trap();
  } while (!done);
}

// max(x, y) and min(x, y) that keep a NaN of either, as jnp.maximum,
// jnp.max and jnp.min do (fmaxf and fminf drop it).
__device__ __forceinline__ float max_keep_nan(float x, float y) {
  return (isnan(x) || isnan(y)) ? x + y : fmaxf(x, y);
}
__device__ __forceinline__ float min_keep_nan(float x, float y) {
  return (isnan(x) || isnan(y)) ? x + y : fminf(x, y);
}

// The sort key of a merge candidate (v, j): a larger key is a larger value,
// then a lower index. mma_topl.cuh's encoding (value bits high, ~index low)
// with the value's bits mapped to an unsigned order for either sign, since
// a partial may hold -inf (a pad, or an atom a mask excluded); -0 is keyed
// as +0, so the two tie as they compare. NaN is never keyed (the caller's
// rule runs first).
using TopKey = unsigned long long;

__device__ __forceinline__ TopKey merge_key(float v, int j) {
  unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<TopKey>(u) << 32) | static_cast<unsigned>(~static_cast<unsigned>(j));
}

__device__ __forceinline__ void merge_unkey(TopKey key, float& v, int& j) {
  unsigned u = static_cast<unsigned>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  v = __uint_as_float(u);
  j = static_cast<int>(~static_cast<unsigned>(key));
}

// The sort key of a top-l score v (|s| >= 0, +inf or NaN: its bits order
// as unsigned integers) of atom j: a larger key is a larger score, then a
// lower index. Key 0 is no atom's: it marks a pad. The sorting epilogues
// of the tensor-core top-l loop (mma_topl.cuh) and of the CUDA-core one
// (select_topl.cu) key their scores so.
__device__ __forceinline__ TopKey topl_key(float v, int j) {
  return (static_cast<TopKey>(__float_as_uint(v)) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(j));
}

// Rows a warp sorts at once in the top-l epilogues (two interleave for ILP).
constexpr int kSortRows = 2;

// Sorts R rows of 128 keys, descending, across the warp: lane t holds
// entries 4 t .. 4 t + 3 of each row in x[r][0..3]. A bitonic network:
// stage k merges runs of k, step j compares entries j apart; steps with j
// >= 4 pair lanes j / 4 apart, the others pair entries within a lane. 28
// compare-exchange steps, 15 of them across lanes, whatever l.
template <int R>
__device__ __forceinline__ void warp_sort128_desc(TopKey (&x)[R][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= kTile; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 4) {
        const int lj = j >> 2;
        const bool upper = (lane & lj) != 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool desc = ((lane * 4 + c) & k) == 0;
          const bool keep_max = desc != upper;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const TopKey y = __shfl_xor_sync(0xffffffffu, x[r][c], lj);
            x[r][c] = (x[r][c] > y) == keep_max ? x[r][c] : y;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c & j) continue;
          const bool desc = ((lane * 4 + c) & k) == 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const TopKey a = x[r][c], b = x[r][c | j];
            const bool keep = (a > b) == desc;  // a stays first
            x[r][c] = keep ? a : b;
            x[r][c | j] = keep ? b : a;
          }
        }
      }
    }
  }
}

// The key of (-inf, INT_MAX): what an exhausted merge returns.
constexpr TopKey kKeyNone = 0x007fffff80000000ull;

// One step of a bitonic network across the warp, one key a lane: the lane
// whose bit `j` is clear keeps the larger of the pair when `desc`.
__device__ __forceinline__ TopKey bitonic_step(TopKey x, int j, bool desc) {
  const TopKey y = __shfl_xor_sync(0xffffffffu, x, j);
  const bool lower = ((threadIdx.x & 31) & j) == 0;
  return (lower == desc) == (x > y) ? x : y;
}

// The 32 keys of a warp, one a lane, sorted descending across the lanes.
__device__ __forceinline__ TopKey warp_sort32_desc(TopKey x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) x = bitonic_step(x, j, (lane & k) == 0);
  }
  return x;
}

// The 32 largest of two descending lists a and b (lane t holds entry t of
// each), descending: max(a_t, b_{31-t}) is bitonic and holds them, five
// steps sort it.
__device__ __forceinline__ TopKey warp_merge32_desc(TopKey a, TopKey b) {
  const TopKey rb = __shfl_sync(0xffffffffu, b, 31 - (threadIdx.x & 31));
  TopKey x = a > rb ? a : rb;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) x = bitonic_step(x, j, true);
  return x;
}

// A row's top-cnt of its select_topl partials (ncand = ntiles * cnt
// entries, cnt <= 32) by value descending, then index ascending, into
// picks[cnt] and vals[cnt] (shared memory). Each warp keeps a sorted top 32
// of its share of the candidates as merge_key keys, one a lane: 32 new
// keys at a time are sorted by a bitonic network and merged in (a batch
// with no key above the warp's 32nd is skipped); the warps' lists then
// meet in a tree of merges through skeys (blockDim.x entries of shared
// memory), log2(warps) block barriers. The keys are distinct (an atom lies
// in one tile) but for the (-inf, INT_MAX) pads, so the first cnt keys are
// what cnt passes of "the best candidate after the previous pick" take,
// (-inf, idx) entries in index order and pads last. A NaN among the
// partials gives (-inf, INT_MAX) throughout (the TPU kernels' smax/== rule:
// no pick is made). Every thread calls it; it ends with a barrier. It is
// compiled out of line (it runs once a launch), so that its sorting
// networks take no part in how ptxas builds its callers' append loops.
static __device__ __noinline__ void merge_topl_row(const float* pvb,
                                               const int* pib, int ncand,
                                               int cnt, int* picks,
                                               float* vals, TopKey* skeys) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int share = (ncand + nwarps - 1) / nwarps;
  const int e0 = warp * share, e1 = min(ncand, e0 + share);
  bool nan = false;
  TopKey top = kKeyNone;
  float v = 0.f;  // this lane's candidate of the batch, loaded a batch ahead
  int id = 0;
  if (e0 + lane < e1) {
    v = pvb[e0 + lane];
    id = pib[e0 + lane];
  }
  for (int e = e0; e < e1; e += 32) {
    float vn = 0.f;
    int idn = 0;
    if (e + 32 + lane < e1) {
      vn = pvb[e + 32 + lane];
      idn = pib[e + 32 + lane];
    }
    TopKey x = kKeyNone;
    if (e + lane < e1) {
      nan |= isnan(v);
      if (!isnan(v)) x = merge_key(v, id);
    }
    v = vn;
    id = idn;
    const TopKey floor = __shfl_sync(0xffffffffu, top, 31);
    if (!__any_sync(0xffffffffu, x > floor)) continue;
    top = warp_merge32_desc(top, warp_sort32_desc(x));
  }
  skeys[tid] = top;
  nan = __syncthreads_or(nan);
  // level s: the warps w = 0 mod 2s read the lists of w + s = s mod 2s and
  // write their own, so one barrier a level orders it
  for (int s = 1; s < nwarps; s <<= 1) {
    if (warp % (2 * s) == 0 && warp + s < nwarps) {
      top = warp_merge32_desc(top, skeys[(warp + s) * 32 + lane]);
      skeys[tid] = top;
    }
    __syncthreads();
  }
  if (tid < cnt) {
    float v = -INFINITY;
    int i = INT_MAX;
    if (!nan) merge_unkey(skeys[tid], v, i);
    picks[tid] = i;
    vals[tid] = v;
  }
  __syncthreads();
}

}  // namespace cstpu
