"""Per-step streaming correlate+select (PyTorch counterpart of
cstpu.ops.stream_select), the building block of the column-sharded solvers.

One sweep of a dictionary shard A (n, m; already in its correlation dtype)
against a batch of residuals R (B, n) returns, per row, the finished
selection over the shard:

  correlate_select_stream         val[b] = max_j |<a_j, r_b>|, idx[b] its
                                  lowest argmax
  correlate_select_topl_stream    the l largest |<a_j, r_b>| of the row
  correlate_select_masked_stream  the first with |R A| + M, M (B, m) f32,
                                  0 on eligible atoms and -inf on the others
  fr_step_select                  one forward-regression step: the pending
                                  rescaling terms go into resc (B, m) in
                                  place, then the top-1 of the OLS score
                                  (R A)^2 / resc

The winning column is fetched afterwards by the caller, from the
full-precision shard.

cstpu's kernels walk the shard tile by tile, `_stream_tile(m, n, itemsize,
8 MB)` atoms at a time, and carry a running pair or l running slots from
tile to tile. Their rule, which the port keeps with `_stream_tile` as its
definition (the tile decides which atoms share a NaN's fate, nothing about
the launch):

  * the running pair starts at (-inf, 0) and a tile replaces it only if its
    maximum is strictly larger, so the lowest index wins ties within a tile
    and across tiles;
  * a tile that holds a NaN score is skipped whole (its maximum is NaN and
    `NaN > x` is false): a NaN row of R gives (-inf, 0);
  * top-l: l slots start at (-inf, 0); every tile offers its own top l,
    best first (lowest index on ties), each written over the lowest slot
    that holds the running minimum if it is strictly larger. The slots come
    back in that order, NOT sorted; mask on val > -inf. Inserting them one
    by one is the same as writing the tile's i-th best over the i-th slot
    in (value ascending, slot ascending) order while it is strictly larger
    (the candidates fall, the slots' values rise), which is how the plain
    twin and the kernel fold a tile at once.

On CUDA tensors each function launches csrc/stream_select.cu, or
csrc/fr_step_select.cu for `fr_step_select` (a sweep that writes partials
per row and per 128 atoms, then a finishing stage that folds them under the
rule above) and counts one in `fused_solve.LAUNCHES`; the top-l select
counts its sweep and its finish (`stream_topl_finish`, two launches of its
own) apart. Every sweep has a tensor-core variant for a bf16 shard
(csrc/mma_select.cuh, mma_topl.cuh, mma_rescaled.cuh; counted under
"select_stream_mma", "select_topl_stream_mma", "select_masked_stream_mma"
and "fr_step_select_mma") and a CUDA-core variant for f32 correlation and
for what the first does not take (`fused_solve.mma_select_takes`): every
sweep on csrc/simt_select.cuh's staged, register-tiled loop (profile names
`stream_top1_simt`, `stream_topl_simt` and `fr_step_simt`). On CPU
tensors, and only there, it runs its plain twin (`*_ref`), which reproduces
the rule tile by tile in torch operations. Products and sums are f32
whatever the dtype of R; the scores of the two differ by the order of the
sums (~1e-6 relative).

What stays of cstpu's shape limits: m must be a multiple of 128 with a
tile inside the 8 MB budget (`_stream_tile` > 0), because the tile defines
the NaN rule. The top-l select takes any l >= 1, as cstpu's does: a sweep
block offers its min(l, 128) best, and past 128 slots the finish takes its
wide route (csrc/stream_select.cu). The TPU's `B % 8 == 0` and
`n % 8 == 0` are not needed: `supported_select` keeps them only so that it
answers as cstpu's gate does.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from cstpu_torch.ops import _build
from cstpu_torch.ops.fused_solve import (
    _CDTS, INT_MAX, LAUNCHES, TILE, _f32, _on_cpu, _pick_mma,
    _rescaled_plan, _rounded_scratch, _stream, _topl_ref)

# the sweeps count their tensor-core variant under "<name>_mma" and their
# CUDA-core variant under "<name>" (fused_solve.mma_select_takes); the top-l
# finish, one for both, under "stream_topl_finish"
LAUNCHES.update(select_stream=0, select_stream_mma=0, select_topl_stream=0,
                select_topl_stream_mma=0, stream_topl_finish=0,
                select_masked_stream=0, select_masked_stream_mma=0,
                fr_step_select=0, fr_step_select_mma=0)

STREAM_TILE_BYTES = 8 * 1024 * 1024


def _stream_tile(m: int, n: int, itemsize: int, target_bytes: int) -> int:
    """Largest multiple of 128 that divides m with tm * n * itemsize within
    target_bytes; 0 if there is none."""
    best = 0
    tm = 128
    while tm * n * itemsize <= target_bytes and tm <= m:
        if m % tm == 0:
            best = tm
        tm += 128
    return best


def supported_select(A, B: int, corr_dtype=torch.bfloat16) -> bool:
    """cstpu's gate: n and B multiples of 8, m a multiple of 128, and a
    streamable tile at the width of `corr_dtype` (the dtype the dictionary
    is streamed in). The port's kernels need only the last two."""
    n, m = A.shape
    if n % 8 or B % 8 or m % 128:
        return False
    itemsize = torch.empty((), dtype=corr_dtype).element_size()
    return _stream_tile(m, n, itemsize, STREAM_TILE_BYTES) > 0


def _tile_of(A, name: str) -> int:
    n, m = A.shape
    tm = _stream_tile(m, n, A.element_size(), STREAM_TILE_BYTES)
    if tm == 0:
        raise ValueError(
            f"{name}: no streamable tile for a ({n}, {m}) {A.dtype} "
            f"dictionary: m must be a multiple of 128 with 128 * n * "
            f"itemsize within {STREAM_TILE_BYTES} bytes")
    return tm


def _abs_scores(A, R):
    """|round_cdt(R) . A| in f32, (B, m)."""
    return torch.abs(torch.matmul(R.float().to(A.dtype).float(), A.float()))


def _tile_top1(scores, tm: int):
    """Per tile of tm atoms (max, lowest argmax), (B, T) each; a NaN in a
    tile makes its maximum NaN (and its argmax INT_MAX)."""
    B, m = scores.shape
    s = scores.view(B, m // tm, tm)
    tmax = torch.amax(s, dim=2)
    col = torch.arange(m, device=scores.device).view(1, m // tm, tm)
    tidx = torch.amin(torch.where(s == tmax[..., None], col, INT_MAX), dim=2)
    return tmax, tidx


def _fold_top1(scores, tm: int, nan_visible: bool = False):
    """The running pair over the tiles, in one pass: from (-inf, 0), the
    largest tile maximum and, among equal ones, the earliest tile's lowest
    index; tiles whose maximum is NaN take no part. With `nan_visible`
    (cstpu.ops.pallas_kernels' rule) the fold ends at the first such tile
    and the value is NaN from there on."""
    tmax, tidx = _tile_top1(scores, tm)
    nan = torch.isnan(tmax)
    live = ~nan
    if nan_visible:
        live = torch.cumsum(nan, dim=1) == 0
    v = torch.where(live, tmax, -torch.inf)
    best = torch.amax(v, dim=1)
    idx = torch.amin(torch.where(live & (v == best[:, None]), tidx, INT_MAX),
                     dim=1)
    idx = torch.where(best > -torch.inf, idx, 0).to(torch.int32)
    if nan_visible:
        best = torch.where(nan.any(dim=1), torch.nan, best)
    return best, idx


def _require_f32_mask(M, B: int, m: int, dev, name: str,
                      what: str = "M") -> None:
    if (M.dtype != torch.float32 or tuple(M.shape) != (B, m)
            or M.device != dev or not M.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous ({B}, {m}) "
                         f"float32 tensor on {dev}, got {tuple(M.shape)} "
                         f"{M.dtype} {M.device}")


def _check_shard(A, R, name: str):
    """Shapes and layout the kernels take: A (n, m) bf16 or f32 with unit
    column stride (a column slice of a wider dictionary is read in place),
    R (B, n) on the same device. Returns (B, n, m)."""
    if A.ndim != 2 or R.ndim != 2 or R.shape[1] != A.shape[0]:
        raise ValueError(f"{name}: need A (n, m) and R (B, n), got "
                         f"{tuple(A.shape)} and {tuple(R.shape)}")
    if A.dtype not in _CDTS:
        raise ValueError(f"{name}: the dictionary must be torch.bfloat16 or "
                         f"torch.float32 (pre-cast to the correlation "
                         f"dtype), got {A.dtype}")
    if A.device != R.device:
        raise ValueError(f"{name}: A on {A.device}, R on {R.device}")
    if A.is_cuda and (A.stride(1) != 1 or A.stride(0) < A.shape[1]):
        raise ValueError(f"{name}: A must have unit column stride, got "
                         f"strides {A.stride()}")
    return R.shape[0], A.shape[0], A.shape[1]


def _launch_top1(A, R, ldr: int, ldp: int, B: int, M, bpt: int,
                 nan_visible: bool, count: str, mma=None, partials=False):
    """Sweep and finish one top-1 select on the card; R's entry (b, p) lies
    at R.data_ptr() + 4 (b ldr + p ldp). The sweep is the tensor-core
    variant where `mma_select_takes` says so, counted under `count` +
    "_mma", else the CUDA-core one, counted under `count`; `mma` = True or
    False forces one. With `partials` also the sweep's (pval, pidx)
    (B, m / 128): each block's (max, lowest argmax)."""
    n, m = A.shape
    dev = A.device
    pval = torch.empty((B, m // TILE), dtype=torch.float32, device=dev)
    pidx = torch.empty((B, m // TILE), dtype=torch.int32, device=dev)
    val = torch.empty((B,), dtype=torch.float32, device=dev)
    idx = torch.empty((B,), dtype=torch.int32, device=dev)
    use_mma = _pick_mma(mma, A)
    rb = _rounded_scratch(B, n, dev) if use_mma else None
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.cstpu_stream_select(
            R.data_ptr(), ldr, ldp, A.data_ptr(), A.stride(0),
            int(A.dtype == torch.bfloat16),
            None if M is None else M.data_ptr(), pval.data_ptr(),
            pidx.data_ptr(), val.data_ptr(), idx.data_ptr(), B, n, m, bpt,
            int(nan_visible), int(use_mma),
            None if rb is None else rb.data_ptr(), _stream())
    _build.check(err, "cstpu_stream_select")
    LAUNCHES[count + "_mma" if use_mma else count] += 1
    return (val, idx, pval, pidx) if partials else (val, idx)


def correlate_select_stream_ref(A, R):
    """Plain twin of `correlate_select_stream`."""
    _check_shard(A, R, "correlate_select_stream")
    return _fold_top1(_abs_scores(A, R),
                      _tile_of(A, "correlate_select_stream"))


def correlate_select_stream(A, R, mma=None):
    """One selection sweep of A (n, m; pre-cast to the correlation dtype)
    against residuals R (B, n). Returns (val (B,) f32, idx (B,) i32).
    `mma` forces a kernel variant (see `_launch_top1`)."""
    if _on_cpu(A, R):
        return correlate_select_stream_ref(A, R)
    B, n, m = _check_shard(A, R, "correlate_select_stream")
    tm = _tile_of(A, "correlate_select_stream")
    R = R.float().contiguous()
    return _launch_top1(A, R, n, 1, B, None, tm // TILE, False,
                        "select_stream", mma)


def correlate_select_masked_stream_ref(A, R, M):
    """Plain twin of `correlate_select_masked_stream`."""
    B, n, m = _check_shard(A, R, "correlate_select_masked_stream")
    _require_f32_mask(M, B, m, A.device, "correlate_select_masked_stream")
    return _fold_top1(_abs_scores(A, R) + M,
                      _tile_of(A, "correlate_select_masked_stream"))


def correlate_select_masked_stream(A, R, M, mma=None):
    """Masked top-1 selection sweep: scores |R A| + M, M (B, m) f32 with 0
    on eligible atoms and -inf on excluded ones, added in f32. Returns
    (val (B,) f32, idx (B,) i32); a row with every atom excluded gives
    (-inf, 0). `mma` forces a kernel variant (see `_launch_top1`)."""
    if _on_cpu(A, R, M):
        return correlate_select_masked_stream_ref(A, R, M)
    B, n, m = _check_shard(A, R, "correlate_select_masked_stream")
    _require_f32_mask(M, B, m, A.device, "correlate_select_masked_stream")
    tm = _tile_of(A, "correlate_select_masked_stream")
    R = R.float().contiguous()
    return _launch_top1(A, R, n, 1, B, M, tm // TILE, False,
                        "select_masked_stream", mma)


def _fold_topl(cv, ci, skip, l: int):
    """The running l slots over the tiles' own candidate lists cv, ci
    (B, T, c; value descending, index ascending), tile by tile, for all
    rows at once; tiles where skip (B, T) is set take no part. A tile at
    once (the rule at the top of this module): its i-th candidate over the
    i-th slot in (value, slot) order while strictly larger."""
    B, T, c = cv.shape
    dev = cv.device
    val = torch.full((B, l), -torch.inf, dtype=torch.float32, device=dev)
    idx = torch.zeros((B, l), dtype=torch.int32, device=dev)
    k = min(l, c)
    for t in range(T):
        order = torch.sort(val, dim=1, stable=True).indices[:, :k]
        cand = cv[:, t, :k]
        take = (cand > val.gather(1, order)) & ~skip[:, t:t + 1]
        val = val.scatter(1, order, torch.where(take, cand,
                                                val.gather(1, order)))
        idx = idx.scatter(1, order, torch.where(
            take, ci[:, t, :k].to(torch.int32), idx.gather(1, order)))
    return val, idx


def correlate_select_topl_stream_ref(A, R, l: int):
    """Plain twin of `correlate_select_topl_stream`: the running l slots,
    tile by tile and candidate by candidate, for all rows at once."""
    B, n, m = _check_shard(A, R, "correlate_select_topl_stream")
    l = int(l)
    if l < 1:
        raise ValueError(f"correlate_select_topl_stream: l={l} < 1")
    tm = _tile_of(A, "correlate_select_topl_stream")
    s = _abs_scores(A, R).view(B, m // tm, tm)
    # a tile's own top l: value descending, lowest index first among equals
    cv, order = torch.sort(s, dim=2, descending=True, stable=True)
    ci = (order[..., :l]
          + tm * torch.arange(m // tm, device=A.device).view(1, -1, 1))
    return _fold_topl(cv[..., :l], ci, torch.isnan(s).any(dim=2), l)


def stream_topl_finish_ref(pval, pidx, bpt: int, l: int):
    """Plain twin of `stream_topl_finish`: each tile's own top l from its
    bpt block lists (value descending, index ascending; a tile holding a
    NaN skipped), then the running l slots over the tiles. Leaves the
    partials as they were."""
    B, nblocks, lc = pval.shape
    T = nblocks // bpt
    v = pval.reshape(B, T, bpt * lc)
    i = pidx.reshape(B, T, bpt * lc)
    o = torch.argsort(i, dim=2, stable=True)      # index ascending, then
    v, i = v.gather(2, o), i.gather(2, o)
    o = torch.sort(v, dim=2, descending=True, stable=True).indices
    cv, ci = v.gather(2, o)[..., :l], i.gather(2, o)[..., :l]
    return _fold_topl(cv, ci, torch.isnan(v).any(dim=2), l)


@lru_cache(maxsize=None)
def _finish_work(B: int, m: int, l: int, bpt: int) -> int:
    """Bytes of scratch the top-l finish takes past 128 slots, as
    csrc/stream_select.cu::wide_plan decides it: 0 where its keys fit
    shared memory."""
    out = (ctypes.c_longlong * 1)()
    _build.check(_build.load().cstpu_stream_topl_work(B, m, l, bpt, out),
                 "cstpu_stream_topl_work")
    return int(out[0])


def stream_topl_finish(pval, pidx, bpt: int, l: int):
    """The finishing stage of the streamed top-l: the sweep's partials pval
    (B, nblocks, min(l, 128)) f32 and pidx i32, bpt blocks to a tile of the
    NaN rule, folded into (val (B, l) f32, idx (B, l) i32) under the rule at
    the top of this module. On CUDA tensors this launches
    csrc/stream_select.cu's finish (counted under "stream_topl_finish"),
    which overwrites the partials; the same for either sweep, and past 128
    slots its wide route with the scratch `_finish_work` asks for."""
    if _on_cpu(pval, pidx):
        return stream_topl_finish_ref(pval, pidx, bpt, l)
    B, nblocks = pval.shape[:2]
    l = int(l)
    lc = min(l, TILE)
    dev = pval.device
    if (l < 1 or tuple(pval.shape) != (B, nblocks, lc)
            or pval.dtype != torch.float32
            or pidx.dtype != torch.int32 or pidx.shape != pval.shape
            or pidx.device != dev or not pval.is_contiguous()
            or not pidx.is_contiguous()):
        raise ValueError(f"stream_topl_finish: need l >= 1 and contiguous "
                         f"(B, nblocks, {lc}) f32 and i32 partials on one "
                         f"device, got l={l}, {tuple(pval.shape)} "
                         f"{pval.dtype}, {tuple(pidx.shape)} {pidx.dtype}")
    val = torch.empty((B, l), dtype=torch.float32, device=dev)
    idx = torch.empty((B, l), dtype=torch.int32, device=dev)
    nwork = _finish_work(B, nblocks * TILE, l, int(bpt)) if l > TILE else 0
    work = (torch.empty((nwork,), dtype=torch.uint8, device=dev)
            if nwork else None)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.cstpu_stream_topl_finish(
            pval.data_ptr(), pidx.data_ptr(), val.data_ptr(), idx.data_ptr(),
            B, nblocks * TILE, l, int(bpt),
            None if work is None else work.data_ptr(), _stream())
    _build.check(err, "cstpu_stream_topl_finish")
    LAUNCHES["stream_topl_finish"] += 1
    return val, idx


def stream_topl_sweep(A, R, l: int, mma=None):
    """The sweep of the streamed top-l on the card: the partials (pval
    (B, m / 128, lc) f32, pidx i32), per row and per 128 atoms the lc =
    min(l, 128) best (past 128 slots the whole block), value descending then
    index ascending, a block holding a NaN all (NaN, INT_MAX). The
    tensor-core variant (csrc/mma_topl.cuh) where `mma_select_takes` says
    so, counted under "select_topl_stream_mma", else the CUDA-core one
    ("select_topl_stream"); `mma` = True or False forces one. On CPU
    tensors its plain twin, `fused_solve._topl_ref`."""
    name = "correlate_select_topl_stream"
    B, n, m = _check_shard(A, R, name)
    l = int(l)
    if l < 1 or m % TILE:
        raise ValueError(f"{name}: need l >= 1 and m a multiple of {TILE}, "
                         f"got l={l}, m={m}")
    lc = min(l, TILE)
    if _on_cpu(A, R):
        return _topl_ref(R.float(), A, A.dtype, lc)
    R = R.float().contiguous()
    dev = A.device
    pval = torch.empty((B, m // TILE, lc), dtype=torch.float32, device=dev)
    pidx = torch.empty((B, m // TILE, lc), dtype=torch.int32, device=dev)
    use_mma = _pick_mma(mma, A)
    rb = _rounded_scratch(B, n, dev) if use_mma else None
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.cstpu_stream_topl(
            R.data_ptr(), A.data_ptr(), A.stride(0),
            int(A.dtype == torch.bfloat16), pval.data_ptr(), pidx.data_ptr(),
            B, n, m, lc, int(use_mma), None if rb is None else rb.data_ptr(),
            _stream())
    _build.check(err, "cstpu_stream_topl")
    LAUNCHES["select_topl_stream_mma" if use_mma
             else "select_topl_stream"] += 1
    return pval, pidx


def correlate_select_topl_stream(A, R, l: int, mma=None):
    """Top-l selection sweep of A (n, m; pre-cast to the correlation dtype)
    against residuals R (B, n), any l >= 1. Returns (val
    (B, l) f32, idx (B, l) i32), NOT sorted by value: the slots are in the
    running set's own order, as cstpu leaves them; mask on val > -inf. On
    the card: `stream_topl_sweep` (`mma` forces its variant), then
    `stream_topl_finish`."""
    if _on_cpu(A, R):
        return correlate_select_topl_stream_ref(A, R, l)
    _check_shard(A, R, "correlate_select_topl_stream")
    tm = _tile_of(A, "correlate_select_topl_stream")
    pval, pidx = stream_topl_sweep(A, R, l, mma)
    return stream_topl_finish(pval, pidx, tm // TILE, int(l))


def _check_fr_step(A, R, W, V, il, cn2, resc):
    """Shapes of `fr_step_select`; resc is updated in place, so it must be
    the caller's own contiguous f32 buffer. Returns (B, n, m, cn2 (m,))."""
    name = "fr_step_select"
    B, n, m = _check_shard(A, R, name)
    dev = A.device
    for x, what in ((W, "W"), (V, "V")):
        if x is not None and (tuple(x.shape) != (B, n) or x.device != dev):
            raise ValueError(f"{name}: {what} must be ({B}, {n}) on {dev}, "
                             f"got {tuple(x.shape)} on {x.device}")
    if tuple(il.shape) != (B, 2) or il.device != dev:
        raise ValueError(f"{name}: il must be ({B}, 2) [mark, restore] on "
                         f"{dev}, got {tuple(il.shape)} on {il.device}")
    cn2 = cn2.reshape(-1)
    if (cn2.dtype != torch.float32 or cn2.shape[0] != m or cn2.device != dev):
        raise ValueError(f"{name}: cn2 must hold {m} float32 squared column "
                         f"norms on {dev}, got {tuple(cn2.shape)} {cn2.dtype}")
    _require_f32_mask(resc, B, m, dev, name, "resc")
    return B, n, m, cn2


def fr_step_select_ref(A, R, W, il, cn2, resc, deg: float, V=None):
    """Plain twin of `fr_step_select`: the same update of resc, in place
    and one rounded operation at a time, and the same fold."""
    B, n, m, cn2 = _check_fr_step(A, R, W, V, il, cn2, resc)
    tm = _tile_of(A, "fr_step_select")
    Af = A.float()

    def dots(X):
        return torch.matmul(X.float().to(A.dtype).float(), Af)

    q, z = dots(R), dots(W)
    col = torch.arange(m, device=A.device)[None, :]
    x = torch.where(col == il[:, 1:2], 0.0, resc)
    x = x - z * z
    if V is not None:
        zv = dots(V)
        x = x + zv * zv
    x = torch.where(col == il[:, 0:1], -1.0, x)
    resc.copy_(x)
    rmin = _f32(deg) * cn2[None, :]
    d2 = torch.where(x > rmin, q * q / x, -torch.inf)
    return (*_fold_top1(d2, tm), resc)


def fr_step_select(A, R, W, il, cn2, resc, deg: float, V=None, mma=None):
    """One forward-regression selection sweep with the pending rescaling
    terms folded in.

    A (n, m; pre-cast to the correlation dtype), R residuals (B, n), W the
    previous append's scaled orthogonal direction (B, n; zeros on step 0 or
    after a rejection), il (B, 2) i32 [mark, restore] LOCAL atom indices per
    row (-1 for none: `mark` excludes the atom the previous step appended,
    `restore` brings a deleted atom back on a zero base), cn2 (m,) f32
    squared column norms of the full-precision shard, resc (B, m) f32 the
    current rescaling, `deg` the degeneracy threshold, V the scaled freed
    direction of a deferred deletion (B, n) or None. R, W and V are rounded
    to the correlation dtype. Per atom: resc = 0 at `restore`, resc -= z z,
    resc += zv zv, resc = -1 at `mark`, then d2 = q q / resc where resc >
    deg * cn2, else -inf.

    resc is UPDATED IN PLACE (cstpu donates its buffer). Returns (d2max (B,)
    f32, idx (B,) i32, resc): the top-1 of d2 under the rule at the top of
    this module; a row with every atom degenerate gives (-inf, 0). The
    sweep is the tensor-core variant, one read of the shard for q, z and zv,
    where `mma_select_takes` says so (counted under "fr_step_select_mma"),
    else the CUDA-core one ("fr_step_select"); `mma` = True or False forces
    one."""
    if _on_cpu(A, R, W, V, il, cn2, resc):
        return fr_step_select_ref(A, R, W, il, cn2, resc, deg, V)
    B, n, m, cn2 = _check_fr_step(A, R, W, V, il, cn2, resc)
    tm = _tile_of(A, "fr_step_select")
    dev = A.device
    R, W = R.float().contiguous(), W.float().contiguous()
    V = None if V is None else V.float().contiguous()
    il = il.to(torch.int32).contiguous()
    cn2 = cn2.contiguous()
    pval = torch.empty((B, m // TILE), dtype=torch.float32, device=dev)
    pidx = torch.empty((B, m // TILE), dtype=torch.int32, device=dev)
    val = torch.empty((B,), dtype=torch.float32, device=dev)
    idx = torch.empty((B,), dtype=torch.int32, device=dev)
    use_mma = _pick_mma(mma, A)
    rows = (_rescaled_plan(B, 1 if V is None else 2, m // TILE)[2]
            if use_mma else 0)
    sb = _rounded_scratch(rows, n, dev) if use_mma else None
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.cstpu_fr_step_select(
            R.data_ptr(), W.data_ptr(), None if V is None else V.data_ptr(),
            A.data_ptr(), A.stride(0), int(A.dtype == torch.bfloat16),
            il.data_ptr(), cn2.data_ptr(), resc.data_ptr(), pval.data_ptr(),
            pidx.data_ptr(), val.data_ptr(), idx.data_ptr(), B, n, m,
            tm // TILE, float(deg), int(use_mma),
            None if sb is None else sb.data_ptr(), rows, _stream())
    _build.check(err, "cstpu_fr_step_select")
    LAUNCHES["fr_step_select_mma" if use_mma else "fr_step_select"] += 1
    return val, idx, resc
