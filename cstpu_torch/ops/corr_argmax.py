"""Fused |A' r| + argmax (PyTorch counterpart of cstpu.ops.pallas_kernels).

`correlate_argmax(A, r)` correlates the dictionary A (n, m; f32 or bf16)
with one residual r (n,) or a batch R (n, B), residuals as columns, takes
|.| and returns the best atom per residual as (idx, val), without the
(B, m) score matrix ever reaching device memory. The residual is rounded to
the dictionary's dtype before the product; products and sums are f32.

cstpu's kernel walks A in tiles of `_pick_tile(m)` atoms (the largest
multiple of 128 up to 512 that divides m) and keeps a running (max, lowest
argmax): the lowest index wins ties, within a tile and across tiles. Unlike
the streaming selects, a NaN score is made visible: from the first tile
that holds one the value is NaN, and the index stays what it was before
that tile, so it is NOT meaningful; callers treat a NaN value as a failed
selection.

On CUDA tensors this launches csrc/stream_select.cu (the sweep reads R with
its own strides, so an (n, B) tensor is not transposed into a copy; the
finishing stage applies the rule above) and counts one under
`fused_solve.LAUNCHES["corr_argmax_mma"]` when the sweep is the tensor-core
variant (a bf16 dictionary that `fused_solve.mma_select_takes`), else under
`LAUNCHES["corr_argmax"]`. On CPU tensors, and only there, it
runs the plain twin `correlate_argmax_ref`. Of cstpu's limits the port
keeps m's 128-multiple tile, which defines the NaN rule; the TPU's VMEM
budget on n * tile is dropped (`supported` answers without it).
"""

from __future__ import annotations

import torch

from cstpu_torch.ops.fused_solve import _CDTS, LAUNCHES, TILE, _on_cpu
from cstpu_torch.ops.stream_select import (
    _abs_scores, _fold_top1, _launch_top1)
from cstpu_torch.ops.util import as_inputs

LAUNCHES.update(corr_argmax=0, corr_argmax_mma=0)


def _pick_tile(m: int, target: int = 512) -> int:
    """Largest 128-multiple divisor of m up to `target` (0 if none)."""
    best = 0
    for tm in range(128, target + 1, 128):
        if m % tm == 0:
            best = tm
    return best


def supported(A, r) -> bool:
    """True if shapes and dtypes are compatible with the kernel: m has a
    128-multiple tile, A is f32 or bf16, r is floating point."""
    if A.ndim != 2 or _pick_tile(A.shape[1]) == 0:
        return False
    return A.dtype in _CDTS and r.dtype.is_floating_point


def _as_columns(A, r):
    """(R (n, B), single) with the shape and dtype checks of both forms."""
    single = r.ndim == 1
    R = r[:, None] if single else r
    if A.ndim != 2 or R.ndim != 2 or R.shape[0] != A.shape[0]:
        raise ValueError(f"correlate_argmax: need A (n, m) and r (n,) or "
                         f"(n, B), got {tuple(A.shape)} and {tuple(r.shape)}")
    if not supported(A, r):
        raise ValueError(
            f"correlate_argmax: unsupported ({tuple(A.shape)}, {A.dtype}, "
            f"{r.dtype}): m needs a 128-multiple divisor tile, A f32 or "
            "bf16, r floating point")
    return R, single


def correlate_argmax_ref(A, r):
    """Plain twin of `correlate_argmax`: the running pair over tiles of
    `_pick_tile(m)` atoms, NaN visible."""
    R, single = _as_columns(A, r)
    val, idx = _fold_top1(_abs_scores(A, R.T), _pick_tile(A.shape[1]),
                          nan_visible=True)
    return (idx[0], val[0]) if single else (idx, val)


def correlate_argmax(A, r, mma=None):
    """Fused |A' r| + argmax. `r` is (n,) or (n, B). Returns (idx, val) as
    0-d tensors for a single residual or (B,) i32 and f32 tensors for a
    batch. m must have a 128-multiple divisor tile (see `supported`).
    `mma` = True or False forces a kernel variant."""
    A, r = as_inputs(A, r)
    if _on_cpu(A, r):
        return correlate_argmax_ref(A, r)
    R, single = _as_columns(A, r)
    if A.device != R.device:
        raise ValueError(f"correlate_argmax: A on {A.device}, r on "
                         f"{R.device}")
    if A.stride(1) != 1 or A.stride(0) < A.shape[1]:
        raise ValueError("correlate_argmax: A must have unit column stride, "
                         f"got strides {A.stride()}")
    R = R.float()
    val, idx = _launch_top1(A, R, R.stride(1), R.stride(0), R.shape[1], None,
                            _pick_tile(A.shape[1]) // TILE, True,
                            "corr_argmax", mma)
    return (idx[0], val[0]) if single else (idx, val)
