// The CUDA-core main loop of the true-f32 selects, shared by the CUDA-core
// variants of select_argmax.cu (batched OMP, MP, OMPR: K1, K5, K13's masked
// select), fr_select.cu (FR, SRR, RMP, FoBa: K3, K14-K16), select_topl.cu
// (GOMP, SP, the OMPR/SRR init: K4, K12-K14), fr_step_select.cu (the
// sharded FR family's step over a shard: K8) and stream_select.cu's
// sweeps (the sharded solvers' top-1 select, the masked one of sharded
// OMPR and correlate_argmax: K6, K9, K10; their top-l select: K7). It
// computes products of rows of r (and of the rescaled selects' pending
// terms u_p) with the dictionary's atoms: each (row, atom) sum is one fmaf
// chain over p = 0 .. n-1 from +0, the row entry rounded to the
// correlation dtype (round_cdt) and the atom's entry in f32, so every
// kernel on it scores an atom with the same bits, whatever its tile, shard
// or batch. The sums stay in f32 on the CUDA cores: no TF32, no split over
// n, no reassociation (cstpu's precision="f32",
// cstpu/ops/fused_solve.py:30-35).
//
// What bounds it on an H100: 2 B n m f32 operations per product (1.07 G for
// the bench's select, B = 64, n = 1024, m = 8192: 0.016 ms at 67 TFLOP/s)
// against one read of the dictionary (32 MB in f32: 0.010 ms at 3.35
// TB/s). So the FMA pipes bound it, and the loop's job is to keep them
// issuing: the loop it replaced read one dictionary entry per thread from
// device memory per step of p and one broadcast float4 of r per four FMAs,
// with one thread per atom and 16 rows a block (about 9.5% of the bound).
//
// Design.
//   Block: W warps (W in {1, 2, 4, 8}, `warps`) over 4 W measurement rows
//     and kTile = 128 atoms. Warp w holds rows 4 w .. 4 w + 3 of the block
//     and all 128 atoms, lane l atoms 4 l .. 4 l + 3: a thread keeps a 4 x 4
//     register tile of (row, atom) sums per product. The warp covers the
//     whole tile of its rows, so the argmax over the tile is a warp's
//     shuffle tree and needs no shared memory or block barrier. At B = 64,
//     m = 8192 that is 8 warps an SM, two a scheduler: one warp's issue of
//     FMAs behind its shared loads bounded the 8-row tile (one warp a
//     scheduler), which was slower on the H100 despite its 8 FMAs a load.
//   Inner step: four entries of n at a time, from shared memory: one
//     float4 of the dictionary per entry (the warp reads 512 contiguous
//     bytes, no bank conflict) and one broadcast float4 of four entries per
//     row: 8 16-byte loads feed 64 FMAs (the loop it replaced: 4 FMAs a
//     load).
//   Staging: a ring of stages (two of 128 entries of n for an f32
//     dictionary, three of 64 for bf16, under the `Wide` plan), filled
//     asynchronously with completion on one mbarrier a stage:
//     - the dictionary's chunk (entries x 128 atoms) by TMA where base and
//       pitch allow (f32, base 16-byte aligned, the row pitch lda a
//       multiple of 4 entries; zeros past n and m from the tensor map),
//       else by 4-byte cp.async with zero fill (f32 at any base and
//       pitch); a bf16 dictionary (the catch-all of the tensor-core
//       predicate: any base, any pitch) lands as the 4-byte words that
//       cover each row's 128 entries and is widened to f32, four atoms a
//       thread at a time (a float4 out), into one of two ping-pong tiles
//       before the chunk's products. Rows of the dictionary
//       are lda entries apart, so a column slice of a wider dictionary (a
//       shard, parallel/sharded.py) is read in place; the selects of whole
//       dictionaries pass lda = m;
//     - each product's rows (4 W rows x the chunk, [row][entry]) by TMA
//       where their pitch is a multiple of 4 and the bases are aligned,
//       else by 4-byte cp.async with zero fill; rows stored as columns
//       (K10's R (n, B), `kColR`) land as they lie, [entry][row], by TMA
//       where B's pitch is a multiple of 4, else by cp.async along the
//       rows, and the inner step reads a float4 of the warp's four rows
//       an entry and transposes it in registers; rounded to bf16 in place
//       for a bf16 dictionary (then fenced for the async proxy, which may
//       refill the stage).
//     One thread issues every TMA box of a stage and arrives with the
//     transaction bytes; where cp.async stages a part, every thread also
//     arrives through cp.async.mbarrier.arrive.noinc. (4-byte cp.async of
//     the rows cost ~1.1K SM cycles a chunk in every warp on the H100, as
//     much as half the multiply-adds: TMA takes it off the warps.) One block barrier a chunk both publishes the
//     widening and rounding and hands the chunk consumed before back to
//     the producers, who then fill it with the chunk kStages - 1 ahead.
//     (On the H100 deeper chunks were faster at every shape tried, 128 in
//     two over 64 in three or four and 32 in four: a chunk's barrier, wait
//     and refill are paid by the whole block. A block holds 160 KB (f32,
//     one product) to 192 KB (f32, two); bf16's two widened tiles leave
//     room for 64-entry chunks (139-163 KB): one block an SM.)
//   Edges: zeros past n, past m and past B. A padded entry adds fmaf(0, 0,
//     s) = s to a sum, exactly: a sum that starts at +0 never becomes -0
//     under round to nearest, so the chain's bits do not change.
//   Products: a pass reads each dictionary chunk once for up to kNP
//     products (kNP = 2 for the rescaled selects: z_p and z_p+1, or the
//     last term and q; 3 for K8's step with V: z, zv and q); a launch with
//     more products takes more passes over the same tile, streamed through
//     the same ring (the second and later reads come from the L2). After a
//     pass the caller's epilogue gets the products' sums in registers.
// Launch plan (`warps`): the rows of a block as select_argmax.cu's
// rows_per_block picks them for the tensor-core loop: the smallest of 4,
// 8, 16, 32 that holds min(B, 32), halved while twice the blocks would
// still fit the card's SMs. At B = 64 and m = 8192 that is 128 blocks of 32
// rows on 132 SMs; the second row chunk reads the dictionary from the L2.
// A `Plan` fixes a stage's entries, the ring's stages and the most warps a
// block holds (which sizes a stage's rows): `Wide` (128 x 2 for f32, 64 x 3
// for bf16, rows for 8 warps) fills the SM with one block; the plans for
// few rows (`Few`, `FewSmall`: the sweeps over a shard, K8 and the top-1
// and top-l sweeps, at B <= 8, 1-2 warps a block; `launch_by_grid` picks
// one by the grid) take shallower chunks, so that several blocks share an SM.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace cstpu {
namespace simt {

// Entries of n a stage and stages of the ring, by dictionary dtype: 128 in
// two for f32; the bf16 catch-all's widened tiles leave room for 64 in
// three.
template <typename T>
constexpr int kChunkOf = std::is_same_v<T, float> ? 128 : 64;
template <typename T>
constexpr int kStagesOf = std::is_same_v<T, float> ? 2 : 3;
constexpr int kRT = 4;       // rows a warp (and a thread)
constexpr int kAT = 4;       // atoms a thread
constexpr int kMaxWarps = 8;
constexpr int kWordPitch = 68;  // words of a bf16 chunk row (65 used)

static_assert(kTile == 32 * kAT, "a warp covers the tile");

// A launch plan: entries of n a stage, stages of the ring, and the most
// warps a block holds (a stage holds that many warps' rows of each product).
template <int kChunk_, int kStages_, int kWarps_>
struct Plan {
  static constexpr int kChunk = kChunk_, kStages = kStages_, kWarps = kWarps_;
  static_assert(kChunk % 8 == 0, "the inner loop takes two groups of four");
  static_assert(kWarps >= 1 && kWarps <= kMaxWarps, "warps of a block");
};

// The plan of a block of up to kMaxWarps warps, one block an SM.
template <typename T>
using Wide = Plan<kChunkOf<T>, kStagesOf<T>, kMaxWarps>;

// Warps of a block for a batch of B rows and a grid of ntiles tiles.
__host__ __device__ inline int warps(int B, int ntiles) {
  int w = 1;
  while (w < kMaxWarps && kRT * w < B) w *= 2;
  while (w > 1 &&
         (long long)ntiles * ((B + kRT * w - 1) / (kRT * w)) * 2 <= kSMs) {
    w /= 2;
  }
  return w;
}

template <typename T, typename P>
__host__ __device__ constexpr uint32_t a_stage_bytes() {
  return std::is_same_v<T, float> ? P::kChunk * kTile * 4
                                  : P::kChunk * kWordPitch * 4;
}

// One stage: the dictionary's chunk, then kNP products' rows (up to
// P::kWarps warps' worth, so that the layout does not depend on W).
template <typename T, int kNP, typename P>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return a_stage_bytes<T, P>() + kNP * P::kWarps * kRT * P::kChunk * 4;
}

// Dynamic shared memory of a block: the ring, bf16's two widened tiles,
// the kStages barriers and slack to align the ring to 128 bytes.
template <typename T, int kNP, typename P = Wide<T>>
__host__ __device__ constexpr size_t smem_bytes() {
  return P::kStages * stage_bytes<T, kNP, P>() +
         (std::is_same_v<T, float> ? 0 : 2 * P::kChunk * kTile * 4) +
         P::kStages * 8 + 128;
}

// Entry c (0..3, a constant after unrolling) of v.
__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The products of a launch, in order: product p < P is the (B, n) matrix
// at U + p ustride, then V (B, n) where V is not null, then r (B, n); rows
// n entries apart, unit entry stride. Where ldr >= 0, r's entry (b, p) lies
// at b ldr + p ldp instead: ldp = 1 keeps the rows (a row pitch of ldr),
// ldp != 1 stores them as columns (K10's R (n, B): ldr = 1, ldp = B; r is
// then the launch's one product).
struct Products {
  const float* r;
  const float* U;
  size_t ustride;
  int P;
  const float* V = nullptr;
  long long ldr = -1, ldp = 1;
  __host__ __device__ __forceinline__ int count() const {
    return P + (V != nullptr) + 1;
  }
  __host__ __device__ __forceinline__ size_t row_pitch(int n) const {
    return ldr < 0 ? (size_t)n : (size_t)ldr;
  }
  __device__ __forceinline__ const float* operator[](int p) const {
    return p < P ? U + (size_t)p * ustride : (V != nullptr && p == P ? V : r);
  }
};

// The launch's tensor maps (f32): the dictionary's (boxes of kTile atoms x
// a chunk's entries) when tma_a, and the products' rows (boxes of a chunk's
// entries x the block's rows: r's, V's, and U's as one (P B, n) matrix)
// when tma_r. What a map does not cover is staged by cp.async.
struct Maps {
  CUtensorMap a, r, u, v;
  int tma_a, tma_r;
};

// acc[q][i][c] = round_cdt<T>(product q's row row0 + 4 warp + i) . A[:, j0 +
// 4 lane + c] for each pass's up to kNP products, every sum one fmaf chain
// over p = 0 .. n-1. The products (prod.count() of them) are taken kNP to
// a pass in order; after pass `pass` (products kNP pass .. + np - 1) the
// loop calls epi(pass, np, acc). A (n, m) has rows lda entries apart;
// `maps` says what TMA stages (an f32 dictionary only). With kColR the one
// product r is stored as columns (ldp != 1, K10's R (n, B)) and lands as
// [entry][row], as it lies; else each product's rows land as [row][entry].
// Every thread of the 32 W-wide block (W <= P::kWarps) calls it once;
// `smem` is the block's dynamic shared memory, smem_bytes<T, kNP, P>() of
// it.
template <typename T, int kNP, typename P = Wide<T>, bool kColR = false,
          typename Epi>
__device__ __forceinline__ void sweep(float (&acc)[kNP][kRT][kAT],
                                      unsigned char* smem, const Maps& maps,
                                      const T* __restrict__ A, size_t lda,
                                      const Products& prod, int j0, int row0,
                                      int B, int n, int m, Epi&& epi) {
  static_assert(!kColR || kNP == 1, "rows stored as columns: r alone");
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr int kChunk = P::kChunk, kStages = P::kStages;
  constexpr int kRowCap = P::kWarps * kRT;  // rows a stage holds a product
  constexpr uint32_t kStage = stage_bytes<T, kNP, P>();
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int TR = kRT * (nthreads >> 5);  // rows of the block
  const uint32_t base = (smem_u32(smem) + 127u) & ~127u;
  unsigned char* ring = smem + (base - smem_u32(smem));
  unsigned char* wide = ring + kStages * kStage;  // bf16's widened tiles
  const uint32_t full = base + kStages * kStage +
                        (kBf16 ? 2 * kChunk * kTile * 4 : 0);
  const int nk = (n + kChunk - 1) / kChunk;
  const int nprod = prod.count();
  const int npass = (nprod + kNP - 1) / kNP;
  const int G = npass * nk;
  const bool tma_a = !kBf16 && maps.tma_a, tma_r = maps.tma_r;
  const bool tma = tma_a || tma_r, cp = !tma_a || !tma_r;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, (cp ? nthreads : 0) + (tma ? 1 : 0));
    }
    mbar_fence_init();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // chunk g = pass nk + kc into stage g % kStages
  auto issue = [&](int g) {
    const int s = g % kStages, pass = g / nk, p0 = (g % nk) * kChunk;
    const int np = min(kNP, nprod - kNP * pass);
    unsigned char* st = ring + s * kStage;
    float* rs = reinterpret_cast<float*>(st + a_stage_bytes<T, P>());
    const uint32_t bar = full + 8 * s;
    if (tma && tid == 0) {
      mbar_expect_tx(bar, (tma_a ? a_stage_bytes<float, P>() : 0) +
                              (tma_r ? np * TR * kChunk * 4 : 0));
      if (tma_a) tma_load_2d(base + s * kStage, &maps.a, bar, j0, p0);
      if (tma_r) {
        for (int q = 0; q < np; ++q) {
          const int p = kNP * pass + q;
          // rows of U past its product's B are the next product's (or
          // zeros): they land in rows >= B, whose sums nobody reads
          const CUtensorMap* map =
              p < prod.P ? &maps.u
                         : (prod.V != nullptr && p == prod.P ? &maps.v
                                                             : &maps.r);
          if constexpr (kColR) {  // the box: the block's rows x a chunk
            tma_load_2d(smem_u32(rs), &maps.r, bar, row0, p0);
          } else {
            tma_load_2d(smem_u32(rs + q * kRowCap * kChunk), map, bar, p0,
                        (p < prod.P ? p * B : 0) + row0);
          }
        }
      }
    }
    if (!tma_a) {
      if constexpr (!kBf16) {
        float* as = reinterpret_cast<float*>(st);
        for (int e = tid; e < kChunk * kTile; e += nthreads) {
          const int k = e / kTile, c = e % kTile;
          const bool ok = p0 + k < n && j0 + c < m;
          cp_async4_zfill(as + e,
                          ok ? A + (size_t)(p0 + k) * lda + j0 + c : A, ok);
        }
      } else {
        // the 4-byte words that cover entries j0 .. j0 + 127 of each row
        uint32_t* aw = reinterpret_cast<uint32_t*>(st);
        const uintptr_t a = reinterpret_cast<uintptr_t>(A);
        for (int e = tid; e < kChunk * 65; e += nthreads) {
          const int k = e / 65, q = e % 65;
          const int p = p0 + k;
          const uintptr_t row = a + 2 * ((uintptr_t)p * lda + j0);
          const int shift = (int)((row >> 1) & 1);
          // the word's first entry inside the tile (its low half, or its
          // high half for the first word of a row that starts mid-word);
          // the word is read when that entry is live
          const int lo = max(2 * q - shift, 0);
          const bool ok = p < n && lo < kTile && j0 + lo < m;
          cp_async4_zfill(
              aw + k * kWordPitch + q,
              ok ? reinterpret_cast<const void*>((row & ~uintptr_t(3)) + 4 * q)
                 : static_cast<const void*>(A),
              ok);
        }
      }
    }
    if (!tma_r) {
      const size_t pitch = prod.row_pitch(n), ldp = (size_t)prod.ldp;
      for (int q = 0; q < np; ++q) {
        const float* src = prod[kNP * pass + q];
        float* dst = rs + q * kRowCap * kChunk;
        for (int e = tid; e < TR * kChunk; e += nthreads) {
          // consecutive threads along a row ([row][entry]) or, for rows
          // stored as columns, along an entry's rows ([entry][row])
          const int i = kColR ? e % TR : e / kChunk;
          const int k = kColR ? e / TR : e % kChunk;
          const bool ok = row0 + i < B && p0 + k < n;
          cp_async4_zfill(
              dst + e,
              ok ? src + (size_t)(row0 + i) * pitch + (size_t)(p0 + k) * ldp
                 : src,
              ok);
        }
      }
    }
    if (cp) cp_async_arrive(bar);
  };

  for (int g = 0; g < kStages - 1 && g < G; ++g) issue(g);

  for (int g = 0; g < G; ++g) {
    const int s = g % kStages, pass = g / nk, kc = g % nk;
    const int np = min(kNP, nprod - kNP * pass);
    unsigned char* st = ring + s * kStage;
    float* rs = reinterpret_cast<float*>(st + a_stage_bytes<T, P>());
    if (kc == 0) {
#pragma unroll
      for (int q = 0; q < kNP; ++q) {
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
#pragma unroll
          for (int c = 0; c < kAT; ++c) acc[q][i][c] = 0.f;
        }
      }
    }
    mbar_wait_bounded(full + 8 * s, (g / kStages) & 1);
    const float* as;
    if constexpr (kBf16) {
      // widen the chunk into tile g & 1, four atoms of a row an item (one
      // float4 out), and round the rows to bf16. A row's entries start at
      // its first staged word, or at that word's high half (`shift`), so
      // the four lie in words c/2, c/2 + 1 (and c/2 + 2 when shifted)
      float* x = reinterpret_cast<float*>(wide) + (g & 1) * kChunk * kTile;
      const uint32_t* aw = reinterpret_cast<const uint32_t*>(st);
      const uintptr_t a = reinterpret_cast<uintptr_t>(A);
      const int p0 = kc * kChunk;
      constexpr int kQuads = kTile / 4;
      for (int e = tid; e < kChunk * kQuads; e += nthreads) {
        const int k = e / kQuads, c = 4 * (e % kQuads);
        const uint32_t* wr = aw + k * kWordPitch + c / 2;
        const bool shift =
            ((a + 2 * ((uintptr_t)(p0 + k) * lda + j0)) >> 1) & 1;
        const uint2 u = *reinterpret_cast<const uint2*>(wr);
        const uint32_t lo = shift ? __funnelshift_r(u.x, u.y, 16) : u.x;
        const uint32_t hi = shift ? __funnelshift_r(u.y, wr[2], 16) : u.y;
        const bool row = p0 + k < n;
        float4 v;
        v.x = row && j0 + c < m ? __uint_as_float(lo << 16) : 0.f;
        v.y = row && j0 + c + 1 < m ? __uint_as_float(lo & 0xffff0000u) : 0.f;
        v.z = row && j0 + c + 2 < m ? __uint_as_float(hi << 16) : 0.f;
        v.w = row && j0 + c + 3 < m ? __uint_as_float(hi & 0xffff0000u) : 0.f;
        *reinterpret_cast<float4*>(x + k * kTile + c) = v;
      }
      for (int q = 0; q < np; ++q) {
        float* dst = rs + q * kRowCap * kChunk;
        for (int e = tid; e < TR * kChunk; e += nthreads) {
          dst[e] = round_cdt<T>(dst[e]);
        }
      }
      // the rows were rounded in place by generic stores, and the stage's
      // next fill may come by TMA (the async proxy): every writer orders
      // its stores before it, and the block barrier below before the issue
      if (tma_r) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      as = x;
    } else {
      as = reinterpret_cast<const float*>(st);
    }
    __syncthreads();
    if (g + kStages - 1 < G) issue(g + kStages - 1);

    const float* a_lane = as + kAT * lane;
    const float* r_warp = rs + kRT * warp * (kColR ? 1 : kChunk);
    // four entries of n: the dictionary's float4 of the lane's atoms for
    // each, and a float4 of the four entries of each row of each product
    // (for rows stored as columns, a float4 of the warp's four rows at each
    // entry, transposed in registers)
    auto load = [&](int k, float4(&av)[4], auto& rv) {
      constexpr int NPC = sizeof(rv) / sizeof(rv[0]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        av[kk] = *reinterpret_cast<const float4*>(a_lane + (k + kk) * kTile);
      }
      if constexpr (kColR) {
        float4 t[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          t[kk] = *reinterpret_cast<const float4*>(r_warp + (k + kk) * TR);
        }
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          rv[0][i] = make_float4(part(t[0], i), part(t[1], i), part(t[2], i),
                                 part(t[3], i));
        }
      } else {
#pragma unroll
        for (int q = 0; q < NPC; ++q) {
#pragma unroll
          for (int i = 0; i < kRT; ++i) {
            rv[q][i] = *reinterpret_cast<const float4*>(
                r_warp + q * kRowCap * kChunk + i * kChunk + k);
          }
        }
      }
    };
    // the entries in order, each a step of every sum: 32 NPC independent
    // chains between two steps of one
    auto fmas = [&](const float4(&av)[4], const auto& rv) {
      constexpr int NPC = sizeof(rv) / sizeof(rv[0]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < NPC; ++q) {
#pragma unroll
          for (int i = 0; i < kRT; ++i) {
            const float rk = part(rv[q][i], kk);
#pragma unroll
            for (int c = 0; c < kAT; ++c) {
              acc[q][i][c] = fmaf(rk, part(av[kk], c), acc[q][i][c]);
            }
          }
        }
      }
    };
    auto mac = [&](auto npc) {
      constexpr int NPC = decltype(npc)::value;
      float4 av0[4], rv0[NPC][kRT];
      load(0, av0, rv0);
      if constexpr (NPC == 1) {
        // registers allow one group in flight while the other multiplies
        float4 av1[4], rv1[NPC][kRT];
#pragma unroll
        for (int k = 0; k < kChunk; k += 8) {
          load(k + 4, av1, rv1);
          fmas(av0, rv0);
          if (k + 8 < kChunk) load(k + 8, av0, rv0);
          fmas(av1, rv1);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kChunk; k += 4) {
          if (k > 0) load(k, av0, rv0);
          fmas(av0, rv0);
        }
      }
    };
    if (kNP == 1 || np == 1) {
      mac(std::integral_constant<int, 1>{});
    } else {
      mac(std::integral_constant<int, kNP>{});
    }
    if (kc == nk - 1) epi(pass, np, acc);
  }
}

// The top-l epilogue of the CUDA-core top-l selects (select_topl.cu's K4,
// stream_select.cu's K7 sweep), called from sweep's epilogue with one
// product's sums s: thread (warp, lane) holds rows rw .. rw + 3 by atoms
// jl .. jl + 3 (jl = j0 + 4 lane), the layout warp_sort128_desc sorts. Each
// warp keys its rows' |s| (topl_key; atoms >= m the pad key 0), sorts them
// kSortRows rows at a time in registers and writes the first l (<= kTile)
// of each row to pval/pidx (B, ntiles, l) at `tile`: value descending, then
// index ascending; pads (-inf, INT_MAX); a tile holding a NaN all l (NaN,
// INT_MAX). The sort is the whole tile's, so its cost does not grow with l.
__device__ __forceinline__ void topl_epilogue(const float (&s)[kRT][kAT],
                                              int jl, int rw, int B, int m,
                                              int tile, int ntiles, int l,
                                              float* __restrict__ pval,
                                              int* __restrict__ pidx) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < kRT; h += kSortRows) {
    if (rw + h >= B) break;  // the warp's rows: uniform in the warp
    TopKey x[kSortRows][4];
    bool nan[kSortRows];
#pragma unroll
    for (int q = 0; q < kSortRows; ++q) {
      bool any = false;
#pragma unroll
      for (int c = 0; c < kAT; ++c) {
        const float v = fabsf(s[h + q][c]);
        const bool live = jl + c < m;
        x[q][c] = live ? topl_key(v, jl + c) : 0ull;
        any |= live && isnan(v);
      }
      nan[q] = __any_sync(0xffffffffu, any);
    }
    warp_sort128_desc<kSortRows>(x);
#pragma unroll
    for (int q = 0; q < kSortRows; ++q) {
      const int row = rw + h + q;
      if (row >= B) break;
      const size_t base = ((size_t)row * ntiles + tile) * l;
#pragma unroll
      for (int c = 0; c < kAT; ++c) {
        const int p = kAT * lane + c;
        if (p < l) {
          const TopKey key = x[q][c];
          float v = key ? __uint_as_float(static_cast<uint32_t>(key >> 32))
                        : -INFINITY;
          int i = key ? static_cast<int>(~static_cast<uint32_t>(key)) : INT_MAX;
          if (nan[q]) {
            v = __int_as_float(0x7fc00000);
            i = INT_MAX;
          }
          pval[base + p] = v;
          pidx[base + p] = i;
        }
      }
    }
  }
}

// The tensor map of an f32 (rows, cols) matrix at base, rows `pitch`
// entries apart, in boxes of box_cols x box_rows, no swizzle, zeros past
// the edges. Encoded once per (base, shape, pitch, box) and kept
// (select_argmax.cu); cudaErrorInvalidValue if the encoder refuses it.
cudaError_t tensor_map_f32(CUtensorMap* out, const float* base, int cols,
                           int rows, long long pitch, int box_cols,
                           int box_rows);

// TMA's terms for an f32 matrix: base aligned to 16 bytes, rows a multiple
// of 16 bytes apart.
inline bool tma_takes(const void* base, long long pitch) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && pitch % 4 == 0;
}

// The maps of a launch with W warps a block: the dictionary's (rows lda
// entries apart) where it is f32 and TMA takes it; the rows' where TMA
// takes r, U and V (r's rows `row_pitch` entries apart, U's and V's n, the
// pitches at least n and multiples of 4, bases aligned), or, with col_r, r
// stored as columns (entry p a row of B values, ldp entries apart, ldp a
// multiple of 4: boxes of the block's rows x a chunk).
inline cudaError_t make_maps(Maps& mp, const void* A, long long lda,
                             bool a_f32, const Products& prod, int B, int n,
                             int m, int w, int chunk, bool col_r) {
  const long long pitch = static_cast<long long>(prod.row_pitch(n));
  mp.tma_a = a_f32 && tma_takes(A, lda);
  mp.tma_r = col_r ? prod.ldr == 1 && prod.ldp >= B &&
                         tma_takes(prod.r, prod.ldp)
                   : pitch >= n && tma_takes(prod.r, pitch) &&
                         (prod.P == 0 || tma_takes(prod.U, n)) &&
                         (prod.V == nullptr || tma_takes(prod.V, n));
  cudaError_t err = cudaSuccess;
  if (mp.tma_a) {
    err = tensor_map_f32(&mp.a, static_cast<const float*>(A), m, n, lda,
                         kTile, chunk);
    if (err != cudaSuccess) return err;
  }
  if (mp.tma_r && col_r) {
    err = tensor_map_f32(&mp.r, prod.r, B, n, prod.ldp, kRT * w, chunk);
  } else if (mp.tma_r) {
    err = tensor_map_f32(&mp.r, prod.r, n, B, pitch, chunk, kRT * w);
    if (err == cudaSuccess && prod.P > 0) {
      err = tensor_map_f32(&mp.u, prod.U, n, prod.P * B, n, chunk, kRT * w);
    }
    if (err == cudaSuccess && prod.V != nullptr) {
      err = tensor_map_f32(&mp.v, prod.V, n, B, n, chunk, kRT * w);
    }
  }
  return err;
}

// Launch kern(maps, args...) over the (ntiles, row chunks) grid of blocks
// of w warps (w <= P::kWarps; by default the loop's plan, `warps`), with
// its tensor maps for A's rows lda entries apart and the products' layout
// (kColR: r alone, stored as columns; else rows of unit entry stride);
// opts into the dynamic shared memory first. Returns the first error.
template <typename T, int kNP, typename P = Wide<T>, bool kColR = false,
          typename Kern, typename... Args>
cudaError_t launch_plan(Kern kern, const void* A, long long lda,
                        const Products& prod, int B, int n, int m,
                        int ntiles, int w, cudaStream_t s, Args... args) {
  constexpr int kSmem = static_cast<int>(smem_bytes<T, kNP, P>());
  if (w < 1 || w > P::kWarps) return cudaErrorInvalidValue;
  if (kColR ? prod.P != 0 || prod.V != nullptr : prod.ldp != 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  Maps maps{};
  err = make_maps(maps, A, lda, std::is_same_v<T, float>, prod, B, n, m, w,
                  P::kChunk, kColR);
  if (err != cudaSuccess) return err;
  const dim3 grid(ntiles, (B + kRT * w - 1) / (kRT * w));
  kern<<<grid, 32 * w, kSmem, s>>>(maps, args...);
  return cudaGetLastError();
}

// The plans of a block of up to 2 warps (B <= 8 rows a block), shared by
// the sweeps over a shard (fr_step_select.cu's K8, stream_select.cu's
// top-1 and top-l): under the Wide plan (a 139-229 KB block, one an SM) 2
// warps an SM can neither stream the dictionary nor issue the FMAs (nor,
// for the bf16 catch-all, stage and widen its words), so a stage holds 2
// warps' rows and the ring is picked by the grid: a grid of more than two
// blocks an SM (m = 131072: 1024 blocks) takes `Few` (32 entries in 3
// stages for f32, in 2 for the bf16 catch-all, whose widened tiles take
// room: 51-68 KB a block, 3-4 blocks an SM, more warps for the later
// waves), a smaller one (32768, one of four shards: 256 blocks, all
// resident) `FewSmall` (64 in 2, fewer barriers a block). 16 x 4, 32 x 4
// and the Wide plan's 128 x 2 were slower at both widths for K8, 32 x 4,
// 64 x 3 and 16 x 6 for the top-1 sweep, 32 x 2 in f32 and 32 x 3 in bf16
// at 131072 (PERF.md §6, `tools/ab_paths.py --fr-step-plans`). Defining
// CSTPU_FEW_CHUNK and CSTPU_FEW_STAGES gives both grids that one plan (the
// probe builds each so).
#if defined(CSTPU_FEW_CHUNK) && defined(CSTPU_FEW_STAGES)
template <typename T>
using Few = Plan<CSTPU_FEW_CHUNK, CSTPU_FEW_STAGES, 2>;
using FewSmall = Few<float>;
#else
template <typename T>
using Few = Plan<32, std::is_same_v<T, float> ? 3 : 2, 2>;
using FewSmall = Plan<64, 2, 2>;
#endif

// launch_plan for a dictionary whose rows are lda entries apart, under the
// plan the grid picks: at W <= 2 (`warps`) Few or FewSmall as above, else
// the Wide plan. kern_of(P{}) is the kernel's instantiation for plan P.
template <typename T, int kNP, bool kColR = false, typename KernOf,
          typename... Args>
cudaError_t launch_by_grid(KernOf kern_of, const void* A, long long lda,
                           const Products& prod, int B, int n, int m,
                           int ntiles, cudaStream_t s, Args... args) {
  const int w = warps(B, ntiles);
  const long long blocks = (long long)ntiles * ((B + kRT * w - 1) / (kRT * w));
  if (w <= Few<T>::kWarps && blocks > 2 * kSMs) {
    return launch_plan<T, kNP, Few<T>, kColR>(kern_of(Few<T>{}), A, lda, prod,
                                              B, n, m, ntiles, w, s, args...);
  }
  if (w <= FewSmall::kWarps) {
    return launch_plan<T, kNP, FewSmall, kColR>(kern_of(FewSmall{}), A, lda,
                                                prod, B, n, m, ntiles, w, s,
                                                args...);
  }
  return launch_plan<T, kNP, Wide<T>, kColR>(kern_of(Wide<T>{}), A, lda,
                                             prod, B, n, m, ntiles, w, s,
                                             args...);
}

// launch_plan under the Wide plan and the loop's rows (`warps`) for a
// dictionary whose rows are m entries apart.
template <typename T, int kNP, typename Kern, typename... Args>
cudaError_t launch(Kern kern, const void* A, const Products& prod, int B,
                   int n, int m, int ntiles, cudaStream_t s, Args... args) {
  return launch_plan<T, kNP>(kern, A, m, prod, B, n, m, ntiles,
                             warps(B, ntiles), s, args...);
}

}  // namespace simt
}  // namespace cstpu
