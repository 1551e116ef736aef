"""Where the time of gomp_append and ompr_swap goes, phase by phase, in SM
cycles, on the paths of suite configs 2a (gomp_batch) and 2c (ompr_batch).

    python3 tools/stamp_phases.py

Copies cstpu_torch and chip_smoke.py into build/stamp/ (which .gitignore
lists), inserts clock64() stamps at the phase boundaries of
csrc/gomp_ompr_cluster.cuh's two row functions (each one adds the cycles
since the previous stamp to its phase in shared memory, thread 0 of each
block; the block adds them to device memory once, at its end), builds that
copy and runs one solve of each path on chip_smoke.py's problems (seed 0).
Prints, per phase, the mean over blocks of the cycles per launch that the
block ran (a done row's blocks leave before the first stamp), its share
of the stamped total, and the card's SM clock beside it. A stamp costs a
shared-memory update; the copy's times are for the split, not for the
kernels' speed (tools/ab_paths.py and chip_smoke.py time those). The anchors are
lines of the source; the tool stops if one is missing.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "build" / "stamp"
BLOCKS = 8 * 132   # the most blocks a launch stamps
PHASES = 16

# (kernel, phase name, the source text the stamp goes in front of)
ANCHORS = [
    ("gomp", "merge", "  // entries c0 .. c0+len-1 of this block's slice"),
    ("gomp", "gather", "  cp_async_wait_all();\n  mbar_wait_cluster(smem_u32(&stage), 0);\n"
                       "  __syncthreads();\n\n  int kc = kold;"),
    ("gomp", "land", "  int kc = kold;  // the slot count"),
    ("gomp", "products", "    cluster_exchange(mine, rows * Rr,"),
    ("gomp", "exchange", "    cluster_sum(part, PP, C, rows * Rr, sm);"),
    ("gomp", "sum", "    // --- the round's gated appends"),
    ("gomp", "appends", "  // --- this block's slice of the new columns"),
    ("gomp", "write", "  rr = cluster_rnorm2(rr, red_v, rrs, &rfull, C, rank);\n"
                      "  if (rank == 0 && tid == 0) {\n    a.kcnt[b] = kc;"),
    ("gomp", "rnorm2, flags", "#STAMP_GOMP_END"),
    ("ompr", "stage issue", "  // --- the row's (max, lowest argmax) with argmax_combine's"),
    ("ompr", "pick", "  // --- this block's slice of A[:, min(sel, m-1)]"),
    ("ompr", "gather, lists", "  cp_async_wait_all();\n  mbar_wait_cluster(smem_u32(&stage), 0);\n"
                              "  __syncthreads();\n\n  // --- this block's partials: rows the"),
    ("ompr", "land", "  // --- this block's partials: rows the occupied slots"),
    ("ompr", "products", "  cluster_exchange(mine, np, &full, C, rank);"),
    ("ompr", "exchange", "  // the rank-order sums: g and gr into their slots"),
    ("ompr", "sum", "  // --- the K-sized work. Warp 0 forms it"),
    ("ompr", "u, gate, scores", "  __syncthreads();\n  const bool ok = si[0], hasf = si[1];"),
    ("ompr", "append, delete", "  cluster_matvec(Gs, atb, cf, GP, K, K);  // coef = Ginv Atb"),
    ("ompr", "refit", "  // --- this block's slice of the new column, the cleared"),
    ("ompr", "write", "  rr = cluster_rnorm2(rr, red_v, rrs, &rfull, C, rank);\n"
                      "  if (rank == 0 && tid == 0) {\n    const float pv0"),
    ("ompr", "rnorm2, flags", "#STAMP_OMPR_END"),
]
SETUP = ("  cluster_setup(&full, &rfull, C);\n  if (tid == 0) {\n"
         "    mbar_init(smem_u32(&stage), 1);\n    mbar_fence_init();\n  }\n")
STARTS = {"gomp": SETUP + "  const int kold",
          "ompr": SETUP + "  // --- the staging, all"}
ENDS = {"gomp": "    if (rr < a.eps2 || kc >= n) a.done[b] = 1.f;\n  }\n",
        "ompr": "    a.prev[b] = res;\n  }\n"}
HEADER = f"""
#define CSTPU_STAMP_BLOCKS {BLOCKS}
#define CSTPU_STAMP_PHASES {PHASES}
static __device__ unsigned long long cstpu_stamps[CSTPU_STAMP_BLOCKS][CSTPU_STAMP_PHASES];
#define CSTPU_STAMP0 __shared__ long long stamp_acc_[CSTPU_STAMP_PHASES]; \\
    if (threadIdx.x == 0) {{ for (int i_ = 0; i_ < CSTPU_STAMP_PHASES; ++i_) stamp_acc_[i_] = 0; }} \\
    long long stamp_t_ = clock64();
#define CSTPU_STAMP(i) if (threadIdx.x == 0) {{ \\
    const long long t_ = clock64(); stamp_acc_[i] += t_ - stamp_t_; stamp_t_ = t_; }}
#define CSTPU_STAMP_FLUSH if (threadIdx.x == 0 && blockIdx.x < CSTPU_STAMP_BLOCKS) {{ \\
    for (int i_ = 0; i_ < CSTPU_STAMP_PHASES - 1; ++i_) cstpu_stamps[blockIdx.x][i_] += stamp_acc_[i_]; \\
    cstpu_stamps[blockIdx.x][CSTPU_STAMP_PHASES - 1] += 1; }}
#define CSTPU_STAMP_READER(name) extern "C" int cstpu_stamp_read_##name(void* host, int zero) {{ \\
    cudaError_t e = cudaMemcpyFromSymbol(host, cstpu::cstpu_stamps, sizeof(cstpu::cstpu_stamps)); \\
    if (zero && e == cudaSuccess) {{ static unsigned long long z[CSTPU_STAMP_BLOCKS][CSTPU_STAMP_PHASES]; \\
      e = cudaMemcpyToSymbol(cstpu::cstpu_stamps, z, sizeof(z)); }} \\
    return static_cast<int>(e); }}
"""


def patch():
    """The stamped copy of the package; returns the phase names by kernel."""
    shutil.rmtree(COPY, ignore_errors=True)
    COPY.mkdir(parents=True)
    shutil.copytree(ROOT / "cstpu_torch", COPY / "cstpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", COPY / "chip_smoke.py")
    hdr = COPY / "cstpu_torch" / "csrc" / "gomp_ompr_cluster.cuh"
    src = hdr.read_text()
    src = src.replace("namespace cstpu {\n", "namespace cstpu {\n" + HEADER, 1)
    for kern, text in STARTS.items():
        assert src.count(text) == 1, text
        src = src.replace(text, "  CSTPU_STAMP0\n" + text)
        assert src.count(ENDS[kern]) == 1, ENDS[kern]
        src = src.replace(ENDS[kern], ENDS[kern] + f"#STAMP_{kern.upper()}_END\n")
    names = {"gomp": [], "ompr": []}
    for kern, name, text in ANCHORS:
        assert src.count(text) == 1, text
        stamp = f"  CSTPU_STAMP({len(names[kern])});\n"
        if text.startswith("#"):  # the last phase: then the block's flush
            stamp += "  CSTPU_STAMP_FLUSH\n"
        src = src.replace(text, stamp if text.startswith("#") else stamp + text)
        names[kern].append(name)
    hdr.write_text(src)
    for kern, cu in (("gomp", "gomp_append.cu"), ("ompr", "ompr_swap.cu")):
        path = COPY / "cstpu_torch" / "csrc" / cu
        path.write_text(path.read_text() + f"\nCSTPU_STAMP_READER({kern})\n")
    return names


def main():
    names = patch()
    sys.path.insert(0, str(COPY))
    os.chdir(COPY)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("stamp_phases: needs an NVIDIA GPU")
    import chip_smoke as cs
    import cstpu_torch
    from cstpu_torch.ops import _build
    from cstpu_torch.ops import fused_solve as fs

    assert _build.PKG == COPY / "cstpu_torch", _build.PKG
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    lib = _build.load()
    print(f"[stamp] {cs.gpu_line()}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    _, B, n, m, k = cs.MP_CELL
    A, _, _ = cs.planted(gen, B, n, m, k)
    Bg, _ = cs.planted_ones(gen, A, B, cs.GOMP_CELL[4])
    buf = (ctypes.c_ulonglong * (BLOCKS * PHASES))()
    paths = {"gomp": ("2a gomp_append", "gomp_append",
                      lambda: cstpu_torch.gomp_batch(A, Bg, cs.GOMP_CELL[5],
                                                     cs.GOMP_CELL[4])),
             "ompr": ("2c ompr_swap", "ompr_swap",
                      lambda: cstpu_torch.ompr_batch(A, Bg, cs.OMPR_CELL[1],
                                                     **cs.OMPR_CELL[2]))}
    for kern, (label, key, solve) in paths.items():
        read = getattr(lib, f"cstpu_stamp_read_{kern}")
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        solve()
        torch.cuda.synchronize()
        _build.check(read(ctypes.addressof(buf), 1), "stamp read")
        before = fs.LAUNCHES[key]
        solve()
        torch.cuda.synchronize()
        launches = fs.LAUNCHES[key] - before
        _build.check(read(ctypes.addressof(buf), 0), "stamp read")
        rows = torch.tensor(list(buf), dtype=torch.float64).view(BLOCKS, PHASES)
        runs = rows[:, PHASES - 1]   # the launches a block ran (not done)
        rows = rows[runs > 0, :len(names[kern])] / runs[runs > 0, None]
        mean = rows.mean(0)
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        total = float(mean.sum())
        print(f"[stamp] {label}: {launches} launches, {rows.shape[0]} blocks "
              f"stamped, {total:.0f} cycles a launch in all (SM clock "
              f"{clock}): " + ", ".join(
                  f"{nm} {float(c):.0f} ({float(c) / total:.0%})"
                  for nm, c in zip(names[kern], mean)), flush=True)


if __name__ == "__main__":
    main()
