"""Build and load the CUDA kernels of cstpu_torch.

`nvcc` compiles every `cstpu_torch/csrc/*.cu` for sm_90a into one shared
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

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# where nvcc is looked for after $CUDA_HOME/bin and $PATH
NVCC_CANDIDATES = ["/usr/local/cuda/bin/nvcc"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # r, A, cdt_bf16, pval, pidx, B, n, m, stream
    "cstpu_select_argmax": [_P, _P, _I, _P, _P, _I, _I, _I, _P],
    # pval, pidx, ntiles, A, cdt_bf16, Bs, cols, Ginv, coef, idx, r,
    # out_idx, out_coef, B, n, m, k, t, rtol, stream
    "cstpu_omp_append": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                         _P, _P, _I, _I, _I, _I, _I, _F, _P],
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


def build() -> tuple[float, str]:
    """Compile the library now; returns (seconds, compiler output)."""
    nvcc = find_nvcc()
    BUILD.mkdir(exist_ok=True)
    tmp = BUILD / f".{LIB.name}.{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = done.stdout + done.stderr
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cstpu_torch: nvcc failed ({done.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, LIB)  # atomic: a concurrent loader sees old or new
    return seconds, log


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
