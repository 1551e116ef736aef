// Batched OMP, MP and OMPR, stage 1: select. For every measurement row b
// and every tile of kTile atoms, the largest |<r_b, a_j>| and its lowest
// index; on request (MP) also the signed <r_b, a_j> of that winner; with an
// active-atom mask (OMPR) the score where(active, -inf, |eta <r_b, a_j>|).
//
// Replaces the select stage of cstpu/ops/fused_solve.py::_solve_kernel
// (:157-163) and the per-tile select of ::_stream_kernel (:370-385); with
// the signed output, the select of ::_mp_kernel (:890-898), whose step adds
// the winner's signed score v; with the mask, the passive-atom select of
// cstpu/ops/fused_twostage.py::_ompr_kernel (:998-1000), where a masked
// atom keeps its index, so an all-masked row gives (-inf, lowest index) as
// the TPU kernel's argmax does. Each call is one step; the step loop runs
// on the host (cstpu_torch/ops/fused_solve.py, fused_twostage.py).
//
// Math: scores = |round_cdt(r) . A_cdt|, products and sums in f32. r is
// rounded to the correlation dtype before the product, as the TPU kernel
// casts it (:158). A product of two bf16 values is exact in f32, so only
// the order of the sum differs from the TPU kernel. With cdt = f32 this is
// true f32 (FMA on CUDA cores, no TF32).
//
// What bounds it on an H100 (sizes computed from the shapes): per step it
// reads the cdt dictionary (16 MB in bf16 at n=1024, m=8192; it stays in
// the 50 MB L2 across steps) and does B*n*m multiply-adds (0.54 G at
// B=64). At about 64 FLOP per dictionary byte the bytes bound it on the
// tensor cores; on CUDA cores the multiply-adds do.
//
// Two hand-written variants; the Python wrapper picks one by a predicate on
// dtype, alignment and pitch and passes it as `use_mma`:
//
//   tensor cores (bf16 correlation): mma_select.cuh, whose note holds the
//     design: wgmma on 64-atom halves of the tile with the rows of r as N, a
//     TMA-fed ring of shared-memory stages, the argmax taken across the
//     accumulator fragments. The dictionary is read once per select for
//     B <= 64 (the bench's B = 64 is split in two row chunks of 32 so that
//     128 blocks share the card; the second read comes from the L2).
//   CUDA cores (f32 correlation, and what the tensor-core loop does not
//     take): simt_select.cuh, whose note holds the design: the dictionary
//     staged in a ring of shared-memory chunks (TMA for an aligned f32
//     dictionary, cp.async otherwise) and a 4-row x 4-atom register tile
//     of sums a thread, each warp over 4 rows and the whole tile, so its
//     epilogue is a warp's shuffles. Each sum is one fmaf chain over p = 0
//     .. n-1 from +0, as in every kernel on that loop. The multiply-adds
//     bound this one.
//
// Either epilogue reduces the block's kTile x rows scores to one (max,
// argmax) per row, so the (B, m) score matrix never reaches device memory;
// it writes partials (B, T), T = ceil(m / kTile), which the append kernel
// reduces. Any n and m: the ragged atom edge is masked (score -inf, index
// INT_MAX). The signed variant carries the winner's signed score through
// the same reduction (argmax_combine with a payload), so the winners, and
// OMP's outputs, are the same with and without it. The masked variant is
// its own instantiation, so OMP's and MP's code is unchanged by it.
//
// This file also defines the host side that both tensor-core selects share
// (mma_select.cuh declares it): the rounding of r, the tensor maps and
// their cache, the row split and the shape predicate.
#include <cstdint>
#include <cstring>
#include <mutex>

#include <dlfcn.h>

#include "common.cuh"
#include "mma_select.cuh"
#include "simt_select.cuh"

namespace cstpu {

// The CUDA-core variant: simt_select.cuh's loop, one product (r), and the
// tile's per-row (max, lowest argmax) under kMode (mma::kAbs, kSigned,
// kMasked) from each warp's registers.
template <typename T, int kMode>
__global__ void __launch_bounds__(32 * simt::kMaxWarps)
select_simt_kernel(const __grid_constant__ simt::Maps maps,
                   const float* __restrict__ r, const T* __restrict__ A,
                   float* __restrict__ pval, int* __restrict__ pidx,
                   float* __restrict__ psig,
                   const uint8_t* __restrict__ amask, float eta, int B, int n,
                   int m, int ntiles) {
  using simt::kAT;
  using simt::kRT;
  extern __shared__ unsigned char smem[];
  constexpr bool kSig = kMode == mma::kSigned;
  const int tile = blockIdx.x, j0 = tile * kTile;
  const int row0 = blockIdx.y * kRT * (blockDim.x >> 5);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float acc[1][kRT][kAT];
  simt::sweep<T, 1>(
      acc, smem, maps, A, (size_t)m, simt::Products{r, nullptr, 0, 0}, j0,
      row0, B, n, m, [&](int, int, float (&s)[1][kRT][kAT]) {
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const int row = row0 + kRT * warp + i;
          float v = -INFINITY, sg = 0.f;
          int idx = INT_MAX;
#pragma unroll
          for (int c = 0; c < kAT; ++c) {
            const int j = j0 + kAT * lane + c;
            if (j < m) {
              const float x = s[0][i][c];
              float val = fabsf(x);
              if constexpr (kMode == mma::kMasked) {
                val = (row < B && amask[(size_t)row * m + j])
                          ? -INFINITY
                          : fabsf(eta * x);
              }
              if constexpr (kSig) {
                argmax_combine(v, idx, sg, val, j, x);
              } else {
                argmax_combine(v, idx, val, j);
              }
            }
          }
          if constexpr (kSig) {
            warp_argmax(v, idx, sg);
          } else {
            warp_argmax(v, idx);
          }
          if (lane == 0 && row < B) {
            pval[(size_t)row * ntiles + tile] = v;
            pidx[(size_t)row * ntiles + tile] = idx;
            if constexpr (kSig) psig[(size_t)row * ntiles + tile] = sg;
          }
        }
      });
}

template <typename T, int kMode>
cudaError_t launch_select_mode(const float* r, const void* A, float* pval,
                               int* pidx, float* psig, const uint8_t* amask,
                               float eta, int B, int n, int m,
                               cudaStream_t s) {
  const int ntiles = (m + kTile - 1) / kTile;
  return simt::launch<T, 1>(select_simt_kernel<T, kMode>, A,
                            simt::Products{r, nullptr, 0, 0}, B, n, m, ntiles,
                            s, r, static_cast<const T*>(A), pval, pidx, psig,
                            amask, eta, B, n, m, ntiles);
}

template <typename T>
cudaError_t launch_select(const float* r, const void* A, float* pval,
                          int* pidx, float* psig, const uint8_t* amask,
                          float eta, int B, int n, int m, cudaStream_t s) {
  if (psig) {
    return launch_select_mode<T, mma::kSigned>(r, A, pval, pidx, psig, nullptr,
                                          1.f, B, n, m, s);
  }
  if (amask) {
    return launch_select_mode<T, mma::kMasked>(r, A, pval, pidx, nullptr, amask,
                                          eta, B, n, m, s);
  }
  return launch_select_mode<T, mma::kAbs>(r, A, pval, pidx, nullptr, nullptr, 1.f,
                                     B, n, m, s);
}

namespace mma {

// Rows of rb along y, entries of a row along x: each thread decodes its row
// (product, measurement row) once.
__global__ void round_rows_kernel(const float* __restrict__ r,
                                  const float* __restrict__ u, size_t ustride,
                                  int nu, const float* __restrict__ v,
                                  size_t ldr, size_t ldp,
                                  __nv_bfloat16* __restrict__ rb, int B, int n,
                                  int n8, int Pn, int ngp, int rows) {
  const int nprod = nu + (v ? 1 : 0) + 1;
  for (int srow = blockIdx.y; srow < rows; srow += gridDim.y) {
    const int t = srow / 8, s = t % Pn, g = (t / Pn) % ngp;
    const int p = t / Pn / ngp * Pn + s, b = 8 * g + srow % 8;
    const bool live = p < nprod && b < B;
    const float* src = p < nu ? u + (size_t)p * ustride
                              : (v != nullptr && p == nu ? v : r);
    src += live ? (size_t)b * ldr : 0;
    __nv_bfloat16* dst = rb + (size_t)srow * n8;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < n8;
         c += gridDim.x * blockDim.x) {
      dst[c] = __float2bfloat16_rn(live && c < n ? src[(size_t)c * ldp] : 0.f);
    }
  }
}

cudaError_t round_rows(const float* r, const float* u, size_t ustride,
                       int nu, const float* v, size_t ldr, size_t ldp,
                       __nv_bfloat16* rb, int B, int n, int n8, int Pn,
                       int ngp, long long rows, cudaStream_t s) {
  const int bx = (n8 + 255) / 256;
  const dim3 grid(bx < 16 ? bx : 16,
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  round_rows_kernel<<<grid, 256, 0, s>>>(r, u, ustride, nu, v, ldr, ldp, rb,
                                         B, n, n8, Pn, ngp,
                                         static_cast<int>(rows));
  return cudaGetLastError();
}

int rows_per_block(int B, int ntiles) {
  int nb = 8;
  while (nb < kMaxRows && nb < B) nb *= 2;
  while (nb > 16 && (long long)ntiles * ((B + nb - 1) / nb) * 2 <= kSMs) {
    nb /= 2;
  }
  return nb;
}

bool takes(const void* A, long long lda, int B, int n, int m) {
  return B >= 1 && n >= 1 && m >= 1 && lda >= m && lda % 8 == 0 &&
         reinterpret_cast<uintptr_t>(A) % 16 == 0;
}

namespace {

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from libcuda, which the CUDA runtime has
// already loaded, so the build links nothing but the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// f32: the CUDA-core loop's plain f32 map (simt::tensor_map_f32); else the
// tensor-core loops' swizzled bf16 map.
struct MapKey {
  const void* base;
  uint64_t cols, rows, pitch;
  uint64_t box_cols, box_rows;
  uint64_t f32;
};

struct MapSlot {
  bool used = false;
  MapKey key{};
  CUtensorMap map{};
};

constexpr int kMapSlots = 64;
std::mutex map_mutex;
MapSlot map_cache[kMapSlots];

cudaError_t cached_map(CUtensorMap* out, const MapKey& key) {
  const uint64_t h =
      (reinterpret_cast<uintptr_t>(key.base) >> 8) * 0x9E3779B97F4A7C15ull +
      key.cols * 31 + key.rows * 131 + key.pitch * 8191 + key.box_rows +
      key.box_cols * 127 + key.f32 * 524287;
  std::lock_guard<std::mutex> lock(map_mutex);
  MapSlot& slot = map_cache[(h >> 32) % kMapSlots];
  if (!slot.used || std::memcmp(&slot.key, &key, sizeof(key)) != 0) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorInvalidValue;
    const size_t elem_bytes = key.f32 ? sizeof(float) : sizeof(__nv_bfloat16);
    const cuuint64_t dims[2] = {key.cols, key.rows};
    const cuuint64_t strides[1] = {key.pitch * elem_bytes};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(key.box_cols),
                               static_cast<cuuint32_t>(key.box_rows)};
    const cuuint32_t elem[2] = {1, 1};
    slot.used = false;
    const CUresult res = encode(
        &slot.map,
        key.f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        2, const_cast<void*>(key.base), dims, strides, box, elem,
        CU_TENSOR_MAP_INTERLEAVE_NONE,
        key.f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
    slot.key = key;
    slot.used = true;
  }
  *out = slot.map;
  return cudaSuccess;
}

}  // namespace

cudaError_t tensor_map(CUtensorMap* out, const void* base, uint64_t cols,
                       uint64_t rows, uint64_t pitch, uint32_t box_rows) {
  return cached_map(out, MapKey{base, cols, rows, pitch, kHalf, box_rows, 0});
}

}  // namespace mma

namespace simt {

cudaError_t tensor_map_f32(CUtensorMap* out, const float* base, int cols,
                           int rows, long long pitch, int box_cols,
                           int box_rows) {
  return mma::cached_map(
      out, mma::MapKey{base, static_cast<uint64_t>(cols),
                       static_cast<uint64_t>(rows),
                       static_cast<uint64_t>(pitch),
                       static_cast<uint64_t>(box_cols),
                       static_cast<uint64_t>(box_rows), 1});
}

}  // namespace simt

}  // namespace cstpu

// r (B, n) f32, A (n, m) in cdt (bf16 if cdt_bf16 else f32), all
// contiguous; writes pval (B, ntiles) f32 and pidx (B, ntiles) i32 with
// ntiles = ceil(m / kTile), and, when psig is not null, the winners'
// signed scores psig (B, ntiles) f32. When amask (B, m) u8 is not null
// (and psig is), atoms with amask != 0 score -inf and the others
// |eta * score|. With use_mma the tensor-core loop runs, with rb
// (B, roundup(n, 8)) bf16 as its scratch for the rounded r; it takes bf16
// only, A aligned to 16 bytes and m a multiple of 8, and the call returns
// cudaErrorInvalidValue otherwise. Returns the launch's cudaError_t.
extern "C" int cstpu_select_argmax(const float* r, const void* A,
                                   int cdt_bf16, float* pval, int* pidx,
                                   float* psig, const uint8_t* amask,
                                   float eta, int B, int n, int m,
                                   int use_mma, void* rb, void* stream) {
  using namespace cstpu;
  if (psig && amask) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (!cdt_bf16) return static_cast<int>(cudaErrorInvalidValue);
    const int ntiles = (m + kTile - 1) / kTile;
    __nv_bfloat16* rbf = static_cast<__nv_bfloat16*>(rb);
    cudaError_t err;
    if (psig) {
      err = mma::launch_top1<mma::kSigned>(r, n, 1, rbf, A, m, pval, pidx,
                                           psig, nullptr, nullptr, 1.f, B, n,
                                           m, ntiles, s);
    } else if (amask) {
      err = mma::launch_top1<mma::kMasked>(r, n, 1, rbf, A, m, pval, pidx,
                                           nullptr, amask, nullptr, eta, B, n,
                                           m, ntiles, s);
    } else {
      err = mma::launch_top1<mma::kAbs>(r, n, 1, rbf, A, m, pval, pidx,
                                        nullptr, nullptr, nullptr, 1.f, B, n,
                                        m, ntiles, s);
    }
    return static_cast<int>(err);
  }
  const cudaError_t err =
      cdt_bf16 ? launch_select<__nv_bfloat16>(r, A, pval, pidx, psig, amask,
                                              eta, B, n, m, s)
               : launch_select<float>(r, A, pval, pidx, psig, amask, eta, B,
                                      n, m, s);
  return static_cast<int>(err);
}
