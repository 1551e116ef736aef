// The tensor-core main loop of the top-1 selects, shared by
// select_argmax.cu (batched OMP, MP, OMPR) and the top-1 sweep of
// stream_select.cu (the column-sharded solvers), for the bf16 correlation
// dtype. It computes what simt_select.cuh's loop computes on CUDA cores,
// scores = round_bf16(R) . A_bf16 with f32 sums, the product the TPU kernels
// take inside their bodies (cstpu/ops/fused_solve.py:157-163, :370-385;
// cstpu/ops/stream_select.py:88). f32 correlation stays on the CUDA cores in
// true f32 (simt_select.cuh, under the batched selects and the streaming
// sweeps alike).
//
// What bounds a top-1 select on an H100: it reads the bf16 dictionary once
// (2 n m bytes) and does 2 B n m operations, 8 to 64 per byte at B = 8 to
// 64, far under the 295 at which the tensor cores would bind. So the bytes
// bound it, and the loop's job is to keep them moving.
//
// Design. The block computes the transposed tile S' = A_tile' . R': the
// kTile = 128 atoms of a tile are the M of two wgmma.m64nNk16 (64 atoms
// each), the measurement rows are N, fitted to the batch in {8, 16, 32, 64}
// (a larger batch takes more row chunks of 64, blockIdx.y). A (n, m) has its
// atoms contiguous, so its tile is the MN-major operand, read from shared
// memory through the descriptor's transpose bit; R, rounded to bf16 by
// `round_rows` (round to nearest even, as round_cdt) into a (B, n8)
// scratch matrix, is the K-major operand. One producer warp fills a ring of
// kStages stages, each kChunk = 64 entries of n deep, by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, completion on an mbarrier); four
// consumer warps issue the wgmmas, one group in flight, and hand the stage
// back through a second mbarrier. Edges cost nothing: past n, past the
// shard's m and past the batch the TMA fills zeros (a zero of A meets a zero
// of R there, never an Inf), and the epilogue drops atoms >= m and rows >= B.
// The dictionary's row pitch is the tensor map's, so a column slice of a
// wider dictionary is read in place. Blocks are not persistent: a block's
// ring is 68 to 98 KB, so two or three blocks share an SM and one's epilogue
// overlaps the others' loads.
//
// What the arithmetic guarantees. Each score is the sum of n exact
// bf16 x bf16 products, taken 16 at a time by the tensor core in its own
// order and added to an f32 accumulator, k-step after k-step from p = 0: the
// same instruction sequence for every atom, whatever its tile, its shard's
// offset, the batch size or the kernel that calls the loop. So equal columns
// give equal scores, scores do not depend on shard, tile or B, and the
// lowest index wins a tie (argmax_combine). What is NOT guaranteed: bits
// equal to simt_select.cuh's or the plain twin's; the sums differ in their last
// bits, so near-ties may resolve differently between the variants.
//
// What the loop does not take (the wrapper's predicate sends those to
// the CUDA-core loops): f32 correlation, a dictionary base that is not 16-byte
// aligned, a row pitch that is not a multiple of 8 entries.
#pragma once

#include <cstdint>

#include <cuda.h>

#include "common.cuh"

namespace cstpu {
namespace mma {

constexpr int kHalf = 64;        // atoms per wgmma (its M); two per tile
constexpr int kChunk = 64;       // entries of n a stage
constexpr int kStages = 4;       // ring depth
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;
constexpr int kMaxRows = 64;     // most measurement rows per block (wgmma N)
constexpr uint32_t kRowBytes = 128;                 // 64 bf16: a swizzle row
constexpr uint32_t kHalfBytes = kChunk * kRowBytes;  // one half tile's stage

static_assert(kTile == 2 * kHalf, "a tile is two wgmma halves");
static_assert(kChunk == 64, "a stage is one 128-byte row of R per row");

template <int NB>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return 2 * kHalfBytes + NB * kRowBytes;
}

// Dynamic shared memory of a block: the ring, its 2 kStages barriers, and
// slack to align the ring to the swizzle's 1024 bytes.
template <int NB>
__host__ __device__ constexpr size_t smem_bytes() {
  return kStages * stage_bytes<NB>() + 2 * kStages * 8 + 1024;
}

// What the epilogue makes of a product s = <r_b, a_j>.
enum Mode {
  kAbs,      // |s|
  kSigned,   // |s|, with s carried along as the winner's payload
  kMasked,   // where(amask[b, j], -inf, |eta s|), amask (B, m) u8
  kAddMask,  // |s| + M[b, j], M (B, m) f32
};

// ---------------------------------------------------------------- PTX ----

// Shared-memory matrix descriptor of a 128-byte-swizzled operand whose
// groups of eight 128-byte rows lie `group_bytes` apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr,
                                              uint32_t group_bytes) {
  const uint64_t g = group_bytes >> 4;
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (g << 16) | (g << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 atoms x NB rows, f32) += a (MN-major, 64 atoms x 16) . b (K-major,
// 16 x NB rows), bf16 operands from shared memory. The five trailing
// operands: accumulate into d, no negation of a or b, a transposed
// (MN-major), b not.
template <int NB>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

// ---------------------------------------------------------- main loop ----

// acc[h][.] = round_bf16(R[row0 .. row0+NB-1]) . A[:, j0 + 64 h .. + 63] for
// the two halves h of the tile at atom j0, summed over all n in k-steps of
// 16 from p = 0. mapA is the dictionary's tensor map (boxes of 64 atoms x
// kChunk rows), mapR the rounded rows' (boxes of kChunk entries x NB rows).
// Every thread of the kThreads-wide block calls it once: warp 4 produces,
// warps 0-3 consume, with acc in wgmma's fragment layout (see
// fragment_argmax); the producer's acc is not meaningful. `smem` is the
// block's dynamic shared memory, smem_bytes<NB>() of it. With npass > 1 the
// loop runs again over the SAME tile for rows row0 + k row_step (pass k):
// the consumers call epi(k) with each pass's acc complete, and the producer
// streams every pass through one ring, so pass k + 1's loads overlap pass
// k's epilogue (the rescaled selects, mma_rescaled.cuh). The top-1 selects
// take one pass and no epilogue.
template <int NB, typename Epi>
__device__ __forceinline__ void score_tile_mma(
    float (&acc)[2][NB / 2], unsigned char* smem, const CUtensorMap* mapA,
    const CUtensorMap* mapR, int j0, int row0, int row_step, int npass,
    int n, Epi&& epi) {
  constexpr uint32_t kStage = stage_bytes<NB>();
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t full = ring + kStages * kStage;  // kStages barriers
  const uint32_t empty = full + kStages * 8;      // kStages more
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = (n + kChunk - 1) / kChunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    mbar_fence_init();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    if (lane == 0) {
      for (int it = 0; it < npass * nk; ++it) {
        const int s = it % kStages, kc = it % nk, pass = it / nk;
        if (it >= kStages) mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
        const uint32_t st = ring + s * kStage, bar = full + 8 * s;
        mbar_expect_tx(bar, kStage);
        tma_load_2d(st, mapA, bar, j0, kc * kChunk);
        tma_load_2d(st + kHalfBytes, mapA, bar, j0 + kHalf, kc * kChunk);
        tma_load_2d(st + 2 * kHalfBytes, mapR, bar, kc * kChunk,
                    row0 + pass * row_step);
      }
    }
  } else {
    for (int pass = 0; pass < npass; ++pass) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < NB / 2; ++e) acc[h][e] = 0.f;
      }
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      for (int kc = 0; kc < nk; ++kc) {
        const int it = pass * nk + kc, s = it % kStages;
        mbar_wait(full + 8 * s, (it / kStages) & 1);
        const uint32_t st = ring + s * kStage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          // 16 entries of n on: 16 rows of a half tile, 32 bytes of R's rows
          const uint64_t db = smem_desc(st + 2 * kHalfBytes + kk * 32, 1024);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint64_t da =
                smem_desc(st + h * kHalfBytes + kk * 16 * kRowBytes, 1024);
            Wgmma<NB>::run(acc[h], da, db);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group is done: hand it back
        if (kc > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
      }
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      // the pass's last stage goes back too, for the next pass's loads
      if (lane == 0) mbar_arrive(empty + 8 * ((pass * nk + nk - 1) % kStages));
      epi(pass);
    }
  }
}

// The block's per-row top-1 from the consumers' fragments. In wgmma's
// accumulator layout thread t of the warpgroup (warp w, lane l) holds, for
// half h, column group c and e in 0..3, acc[h][4 c + e]: atom
// j0 + 64 h + 16 w + l / 4 + 8 (e / 2), row 8 c + 2 (l % 4) + e % 2. So a
// thread owns NB / 4 rows with four atoms each; the eight lanes that share
// l % 4 finish a warp's 32 atoms by shuffles, and wv/wi/ws[w][row] take the
// warp's result. `score(q, j, s)` maps the product s of row q (local) and
// atom j (< m) to the value that competes; with kSig the product rides
// along. Consumers only; follow with a block barrier and `finish_rows`.
template <int NB, bool kSig, typename Score>
__device__ __forceinline__ void fragment_argmax(
    const float (&acc)[2][NB / 2], int j0, int m, Score score,
    float (*wv)[NB], int (*wi)[NB], float (*ws)[NB]) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < NB / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 8 * c + 2 * (l & 3) + e;
      float v = -INFINITY, sg = 0.f;
      int i = INT_MAX;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int up = 0; up < 2; ++up) {
          const int j = j0 + kHalf * h + 16 * w + (l >> 2) + 8 * up;
          const float s = acc[h][4 * c + 2 * up + e];
          if (j < m) {
            if constexpr (kSig) {
              argmax_combine(v, i, sg, score(q, j, s), j, s);
            } else {
              argmax_combine(v, i, score(q, j, s), j);
            }
          }
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
        if constexpr (kSig) {
          const float s2 = __shfl_xor_sync(0xffffffffu, sg, off);
          argmax_combine(v, i, sg, v2, i2, s2);
        } else {
          argmax_combine(v, i, v2, i2);
        }
      }
      if ((l >> 2) == 0) {
        wv[w][q] = v;
        wi[w][q] = i;
        if constexpr (kSig) ws[w][q] = sg;
      }
    }
  }
}

// One block of a top-1 select: the tile's per-row (max, lowest argmax) of
// the scores under `kMode`, into pval/pidx (and psig) at [row, tile], rows
// `ldpart` apart. amask, M and eta as the modes need them; mask rows are m
// entries apart.
template <int NB, int kMode>
__global__ void __launch_bounds__(kThreads)
top1_mma_kernel(const __grid_constant__ CUtensorMap mapA,
                const __grid_constant__ CUtensorMap mapR,
                float* __restrict__ pval, int* __restrict__ pidx,
                float* __restrict__ psig, const uint8_t* __restrict__ amask,
                const float* __restrict__ M, float eta, int B, int n, int m,
                int ldpart) {
  extern __shared__ unsigned char smem[];
  constexpr bool kSig = kMode == kSigned;
  __shared__ float wv[kConsumers / 32][NB];
  __shared__ int wi[kConsumers / 32][NB];
  __shared__ float ws[kSig ? kConsumers / 32 : 1][NB];

  const int tile = blockIdx.x;
  const int j0 = tile * kTile, row0 = blockIdx.y * NB;

  float acc[2][NB / 2];
  score_tile_mma<NB>(acc, smem, &mapA, &mapR, j0, row0, 0, 1, n,
                     [](int) {});

  if (threadIdx.x < kConsumers) {
    auto score = [&](int q, int j, float s) -> float {
      const int row = row0 + q;
      if constexpr (kMode == kMasked) {
        return (row < B && amask[(size_t)row * m + j]) ? -INFINITY
                                                       : fabsf(eta * s);
      } else if constexpr (kMode == kAddMask) {
        return row < B ? fabsf(s) + M[(size_t)row * m + j] : fabsf(s);
      } else {
        return fabsf(s);
      }
    };
    fragment_argmax<NB, kSig>(acc, j0, m, score, wv, wi, ws);
  }
  __syncthreads();
  if (threadIdx.x < NB) {
    const int q = threadIdx.x, row = row0 + q;
    float v = wv[0][q];
    int i = wi[0][q];
    if constexpr (kSig) {
      float sg = ws[0][q];
      for (int w = 1; w < kConsumers / 32; ++w) {
        argmax_combine(v, i, sg, wv[w][q], wi[w][q], ws[w][q]);
      }
      if (row < B) psig[(size_t)row * ldpart + tile] = sg;
    } else {
      for (int w = 1; w < kConsumers / 32; ++w) {
        argmax_combine(v, i, wv[w][q], wi[w][q]);
      }
    }
    if (row < B) {
      pval[(size_t)row * ldpart + tile] = v;
      pidx[(size_t)row * ldpart + tile] = i;
    }
  }
}

// ------------------------------------------------------------- host ----
// Defined in select_argmax.cu, used by the top-1 selects and by the rescaled
// ones (mma_rescaled.cuh).

// The K-major operand of the loop, rb (rows, n8) bf16 with n8 = roundup(n,
// 8), from the products' rows rounded to nearest even (one small launch on
// stream s). The products are u + p ustride for p < nu, then v (when not
// null), then r; entry (b, c) of each lies at [b ldr + c ldp]. Row
// ((k ngp + g) Pn + s) 8 + i of rb holds row 8 g + i of product k Pn + s:
// the products stacked in groups of 8 rows, Pn to a pass, for ngp row groups;
// zeros past n, past B and past the products. The top-1 selects pass r alone
// with Pn = 1, ngp = ceil(B / 8) and rows = B, so that rb[b, c] = r[b, c].
cudaError_t round_rows(const float* r, const float* u, size_t ustride,
                       int nu, const float* v, size_t ldr, size_t ldp,
                       __nv_bfloat16* rb, int B, int n, int n8, int Pn,
                       int ngp, long long rows, cudaStream_t s);

// Rows of a block for a batch of B and a grid of `ntiles` tiles: the
// smallest width of {8, 16, 32, 64} that holds min(B, 64), halved (not
// under 16) while twice the blocks would still fit the card's SMs: a narrow
// dictionary gives few tiles, and two blocks that share a tile re-read it
// from the L2.
int rows_per_block(int B, int ntiles);

// True when the loop takes this dictionary: base aligned to 16 bytes, row
// pitch a multiple of 8 entries and at least m, and B, n, m >= 1.
bool takes(const void* A, long long lda, int B, int n, int m);

// The tensor map of a (rows, cols) bf16 matrix with rows `pitch` entries
// apart, in boxes of 64 columns x box_rows rows under the 128-byte swizzle,
// zeros past the edges. Encoded once per (base, shape, pitch, box) and
// kept; cudaErrorInvalidValue if the encoder refuses it.
cudaError_t tensor_map(CUtensorMap* out, const void* base, uint64_t cols,
                       uint64_t rows, uint64_t pitch, uint32_t box_rows);

template <int NB, int kMode>
cudaError_t launch_blocks(const CUtensorMap& mapA, const CUtensorMap& mapR,
                          float* pval, int* pidx, float* psig,
                          const uint8_t* amask, const float* M, float eta,
                          int B, int n, int m, int ldpart, cudaStream_t s) {
  auto kern = top1_mma_kernel<NB, kMode>;
  constexpr int kSmem = static_cast<int>(smem_bytes<NB>());
  // over 48 KB of dynamic shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kTile - 1) / kTile, (B + NB - 1) / NB);
  kern<<<grid, kThreads, kSmem, s>>>(mapA, mapR, pval, pidx, psig, amask, M,
                                     eta, B, n, m, ldpart);
  return cudaGetLastError();
}

// The whole select on stream s under kMode: rounds r (entry (b, p) at
// r[b ldr + p ldp]) into rb (B, roundup(n, 8)) bf16, then sweeps A (n, m)
// bf16, rows lda apart, and writes the per-tile partials, rows ldpart
// apart. cudaErrorInvalidValue for what the loop does not take.
template <int kMode>
cudaError_t launch_top1(const float* r, size_t ldr, size_t ldp,
                        __nv_bfloat16* rb, const void* A, long long lda,
                        float* pval, int* pidx, float* psig,
                        const uint8_t* amask, const float* M, float eta,
                        int B, int n, int m, int ldpart, cudaStream_t s) {
  if (rb == nullptr || !takes(A, lda, B, n, m)) return cudaErrorInvalidValue;
  const int n8 = (n + 7) / 8 * 8;
  cudaError_t err = round_rows(r, nullptr, 0, 0, nullptr, ldr, ldp, rb, B, n,
                               n8, 1, (B + 7) / 8, B, s);
  if (err != cudaSuccess) return err;
  const int nb = rows_per_block(B, (m + kTile - 1) / kTile);
  CUtensorMap mapA, mapR;
  err = tensor_map(&mapA, A, m, n, lda, kChunk);
  if (err != cudaSuccess) return err;
  err = tensor_map(&mapR, rb, n8, B, n8, nb);
  if (err != cudaSuccess) return err;
  switch (nb) {
    case 8:
      return launch_blocks<8, kMode>(mapA, mapR, pval, pidx, psig, amask, M,
                                     eta, B, n, m, ldpart, s);
    case 16:
      return launch_blocks<16, kMode>(mapA, mapR, pval, pidx, psig, amask, M,
                                      eta, B, n, m, ldpart, s);
    case 32:
      return launch_blocks<32, kMode>(mapA, mapR, pval, pidx, psig, amask, M,
                                      eta, B, n, m, ldpart, s);
    default:
      return launch_blocks<64, kMode>(mapA, mapR, pval, pidx, psig, amask, M,
                                      eta, B, n, m, ldpart, s);
  }
}

}  // namespace mma
}  // namespace cstpu
