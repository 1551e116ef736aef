"""Hand problems and solutions between numpy, cstpu and cstpu_torch.

This system has no weights: what carries across is the dictionary, the
measurements and the returned solution. Everything passes through numpy,
so this module imports neither framework's other package.
"""

from __future__ import annotations

import numpy as np
import torch

from cstpu_torch.utils.sparse import SparseSolution


def to_torch(array, device=None, dtype=None) -> torch.Tensor:
    """A tensor holding a copy of `array` (numpy, a cstpu array or any
    array-like), on `device` with `dtype` when given."""
    return torch.as_tensor(np.array(array), device=device, dtype=dtype)


def solution_from_cstpu(sol, device=None) -> SparseSolution:
    """cstpu SparseSolution (single or batched) -> cstpu_torch's."""
    return SparseSolution(
        idx=to_torch(sol.idx, device, torch.int32),
        val=to_torch(sol.val, device),
        mask=to_torch(sol.mask, device, torch.bool),
        m=int(sol.m),
    )


def solution_to_numpy(sol) -> dict:
    """Either package's SparseSolution -> {"idx", "val", "mask", "m"} with
    host numpy arrays."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return {"idx": host(sol.idx), "val": host(sol.val),
            "mask": host(sol.mask), "m": int(sol.m)}
