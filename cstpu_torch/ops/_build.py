"""Build and load the CUDA kernels of cstpu_torch.

`nvcc` compiles every `cstpu_torch/csrc/*.cu` for sm_90a, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, `cstpu_torch/build/libcstpu_kernels.so`,
at first use and again whenever a source is newer than the library. The
library is loaded with ctypes; nothing here includes PyTorch's headers, so
a build takes seconds. Only the sources in the package go into the build.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
LIB = BUILD / "libcstpu_kernels.so"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# the tensor-core selects fetch libcuda's tensor-map encoder with dlopen
LINK_LIBS = ["-ldl"]
# where nvcc is looked for after $CUDA_HOME/bin and $PATH
NVCC_CANDIDATES = ["/usr/local/cuda/bin/nvcc"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# the slot engine's state: cols, Ginv, coef, idx, Atb, r, amask, done, prev
_ENG = [_P] * 9
_SIGNATURES = {
    # r, A, cdt_bf16, pval, pidx, psig (nullable), amask (nullable), eta,
    # B, n, m, use_mma, rb (nullable), stream
    "cstpu_select_argmax": [_P, _P, _I, _P, _P, _P, _P, _F, _I, _I, _I, _I,
                            _P, _P],
    # pval, pidx, ntiles, A, cdt_bf16, Bs, cols, Ginv, coef, idx, r,
    # out_idx, out_coef, B, n, m, k, t, rtol, stream
    "cstpu_omp_append": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                         _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # B, n, k, out (4 ints: C, slice, staged, smem bytes)
    "cstpu_append_plan": [_I, _I, _I, _P],
    # pval, pidx, psig, ntiles, A, cdt_bf16, x, r, B, n, m, stream
    "cstpu_mp_update": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _P],
    # B, n, out (3 ints: C, slice, threads a block)
    "cstpu_mp_plan": [_I, _I, _P],
    # r, A, cdt_bf16, pval, pidx, B, n, m, l, use_mma, rb (nullable), stream
    "cstpu_select_topl": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # pval, pidx, ntiles, cnt, A, cdt_bf16, Bs, cols, Ginv, coef, idx, r,
    # kcnt, done, B, n, m, k, cap, rtol, eps2, stream
    "cstpu_gomp_append": [_P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                          _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    # B, n, k, cnt, out (6 ints: C, slice, staged, smem bytes, picks a
    # round, entries of a pick gathered at once)
    "cstpu_gomp_plan": [_I, _I, _I, _I, _P],
    # r, U, W, P, wsign, A, cdt_bf16, cn2, amask, resc, pval, pidx, B, n,
    # m, rtol, use_mma, sb (nullable), sb_rows, stream
    "cstpu_fr_select": [_P, _P, _P, _I, _F, _P, _I, _P, _P, _P, _P, _P, _I,
                        _I, _I, _F, _I, _P, _L, _P],
    # B, nterms, ntiles, out (3 ints: G, Pn, rows)
    "cstpu_rescaled_plan": [_I, _I, _I, _P],
    # pval, pidx, ntiles, A, cdt_bf16, Bs, cols, Ginv, coef, idx, r, aperp,
    # dinv, amask, done, B, n, m, k, t, rtol, max_eps2, min_d2, stream
    "cstpu_fr_append": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    # pval, pidx, ntiles, cnt, A, cdt_bf16, Bs, engine state, pend_u,
    # pend_w, fgate (nullable), B, n, m, K, rtol, stream
    "cstpu_engine_init": [_P, _P, _I, _I, _P, _I, _P, *_ENG, _P, _P, _P,
                          _I, _I, _I, _I, _F, _P],
    # pval, pidx, ntiles, A, cdt_bf16, Bs, engine state, B, n, m, K, rtol,
    # eta, delta2, stream
    "cstpu_ompr_swap": [_P, _P, _I, _P, _I, _P, *_ENG, _I, _I, _I, _I, _F,
                        _F, _F, _P],
    # B, n, K, out (4 ints: C, slice, staged, smem bytes)
    "cstpu_ompr_plan": [_I, _I, _I, _P],
    # pval, pidx, ntiles, A, cdt_bf16, Bs, engine state but prev, pend_u,
    # pend_w, fgate, B, n, m, K, rtol, stream
    "cstpu_srr_append": [_P, _P, _I, _P, _I, _P, *_ENG[:8], _P, _P, _P, _I,
                         _I, _I, _I, _F, _P],
    # Bs, engine state, pend_u, pend_w, fgate, B, n, m, K, k, l, delta2,
    # stream
    "cstpu_engine_delete": [_P, *_ENG, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _P],
    # pval, pidx, ntiles, A, cdt_bf16, Bs, cols, Ginv, coef, idx, Atb, r,
    # done, prev, B, n, m, k, rtol, delta2, init, stream
    "cstpu_sp_round": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _I, _I, _I, _I, _F, _F, _I, _P],
    # pval, pidx, ntiles, A, cdt_bf16, Bs, engine state but prev, pend_u,
    # pend_w, fgate, acc, capped, ndel, floor2, B, n, m, K, rtol, delta2,
    # foba, stream
    "cstpu_rmp_append": [_P, _P, _I, _P, _I, _P, *_ENG[:8], _P, _P, _P, _P,
                         _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    # B, n, K, cnt, out (4 ints: C, slice, staged, smem bytes)
    "cstpu_engine_plan": [_I, _I, _I, _I, _P],
    # Bs, engine state but prev, pend_u, pend_w, fgate, acc, ndel, B, n, m,
    # K, delta2, kfinal, stream
    "cstpu_engine_backward": [_P, *_ENG[:8], _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _F, _I, _P],
    # G, coef, diag, alive, nr2, run, failed, g, gcol, sc, B, m, max_eps2,
    # max_delta2, select_abs, stream
    "cstpu_bw_select": [_P] * 10 + [_I, _I, _F, _F, _I, _P],
    # G, g, gcol, sc, B, m, stream
    "cstpu_bw_downdate": [_P, _P, _P, _P, _I, _I, _P],
    # r, ldr, ldp, A, lda, cdt_bf16, M (nullable), pval, pidx, val, idx, B,
    # n, m, bpt, nan_visible, use_mma, rb (nullable), stream
    "cstpu_stream_select": [_P, _L, _L, _P, _L, _I, _P, _P, _P, _P, _P, _I,
                            _I, _I, _I, _I, _I, _P, _P],
    # r, A, lda, cdt_bf16, pval, pidx, B, n, m, l, use_mma, rb (nullable),
    # stream
    "cstpu_stream_topl": [_P, _P, _L, _I, _P, _P, _I, _I, _I, _I, _I, _P,
                          _P],
    # pval, pidx, val, idx, B, m, l, bpt, work (nullable), stream
    "cstpu_stream_topl_finish": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # B, m, l, bpt, out (1 long long: the finish's scratch bytes)
    "cstpu_stream_topl_work": [_I, _I, _I, _I, _P],
    # r, w, v (nullable), A, lda, cdt_bf16, il, cn2, resc, pval, pidx, val,
    # idx, B, n, m, bpt, deg, use_mma, sb (nullable), sb_rows, stream
    "cstpu_fr_step_select": [_P, _P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _P,
                             _P, _I, _I, _I, _I, _F, _I, _P, _L, _P],
}

_lib = None


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then NVCC_CANDIDATES."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    found = [str(Path(home) / "bin" / "nvcc")] if home else []
    found += [shutil.which("nvcc") or ""] + NVCC_CANDIDATES
    for path in found:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "cstpu_torch: nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        f"{NVCC_CANDIDATES}); the CUDA kernels are built from "
        f"{CSRC} with the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def stale() -> bool:
    """True when the library is missing or older than any source."""
    if not LIB.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return LIB.stat().st_mtime < newest


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; their joined output, or raise with the
    output of every one that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("cstpu_torch: nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> tuple[float, str]:
    """Compile the library now; returns (seconds, compiler output)."""
    nvcc = find_nvcc()
    BUILD.mkdir(exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [BUILD / f".{src.stem}.{tag}.o" for src in sources()]
    tmp = BUILD / f".{LIB.name}.{tag}"
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(sources(), objs)])
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                          *map(str, objs), *LINK_LIBS]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, LIB)  # atomic: a concurrent loader sees old or new
    return time.perf_counter() - t0, log


def load() -> ctypes.CDLL:
    """The kernel library, built first if stale; loaded once per process."""
    global _lib
    if _lib is None:
        if stale():
            build()
        lib = ctypes.CDLL(str(LIB))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"cstpu_torch: {name} failed with cudaError {err}")
